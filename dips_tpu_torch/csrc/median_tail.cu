// Kernel 4: the median tail-protocol step (COLORIZE / GRAYSCALE / no maps).
//
// Replaces the Pallas kernel _make_kernel in dips_tpu/ops/pallas_fused.py,
// with its helpers _filtered_plane, _emit_median_frame(gate_state=False)
// and _halo_specs (called through _batch_step_impl: batch_step and
// batch_step_stacked).
//
// The input is the T raw tail frames followed by the B new ones, raw
// (T+B, 3, S*Hp, Wp).  No ring is carried between launches: each launch
// rebuilds it from the tail.  Per pixel: the T tail frames' spatially
// filtered planes (the exact median, the separable approximation or the
// quirk pick with its store-back, as in median_ring.cu) fill ring slots
// 0..T-1 (global frame g writes slot g mod T); PER_FRAME's
// first reference is their temporal median.  Then for each new frame f:
// spatial median -> slot f mod T (every frame, valid or not) -> temporal
// median -> diff against the baseline (OVERALL, captured on every flagged
// frame) or the previous median (PER_FRAME, advanced on every frame) ->
// statistic partials, heatmap (+ |diff| * valid), emphasis and maps, as in
// median_common.cuh.  Capture and advance are not gated on valid: the
// protocol rebuilds the ring every launch, and the engines never flag an
// invalid frame.  Only the baseline (OVERALL) and the heatmap go back.
//
// Streams: as in median_ring.cu -- grid z is the stream, halos stop at the
// stream's own rows, the roi mask tests the stream-local row; flags / valid
// are (S, B) int32 on the device.  Row slabs too (the dyn_rows and
// slab_bands forms of _make_kernel): the bands hold the T tail frames'
// neighbour rows ahead of the new frames', indexed by the same frame.
//
// Design: the ring-carry kernel's tile and frame loop (median_ring.cu),
// with a warm-up loop over the T tail frames in front that only fills the
// ring.  The ring lives in registers (T <= DIPS_MAX_T); baseline and heatmap
// are read once and written once per launch.
//
// Bound: per launch it reads (T+B)*3*Hp*Wp bytes and writes B*C*Hp*Wp, and
// runs T+B spatial medians where the ring kernel runs B, so at T=4, B=16 it
// does 1.25x the ring kernel's selection work on 1.25x its input bytes; the
// integer pipes bound it at w >= 3, as they bound the ring kernel.

#include "median_common.cuh"

namespace {

using namespace dips_median;

template <int W, int M, bool kBands>
__global__ void __launch_bounds__(kTx * kTy) median_tail_kernel(MedianArgs a) {
  constexpr int P = W / 2;
  __shared__ int strip[kTy + 2 * P][kTx + 2 * P];
  __shared__ int cm[kCmRows<M>][kTx + 2 * P];
  __shared__ float red[kWarps][4];

  const Pixel p = locate(a);
  const int* flags = a.flags + (long long)p.si * a.B;
  const int* valid = a.valid + (long long)p.si * a.B;

  // the ring, filled by the T tail frames (slots >= T are never read)
  float ring[DIPS_MAX_T];
#pragma unroll
  for (int k = 0; k < DIPS_MAX_T; ++k) ring[k] = 0.f;
  for (int g = 0; g < a.T; ++g) {
    const float phi = filtered<W, M, kBands>(strip, cm, a, p, g);
#pragma unroll
    for (int k = 0; k < DIPS_MAX_T; ++k)
      if (k == g) ring[k] = phi;
    __syncthreads();  // the strip is restaged for the next frame
  }
  float prev = a.overall ? 0.f : tmed(ring, a.T);
  float base = a.base[p.pix];
  float heat = a.heat[p.pix];

  for (int f = 0; f < a.B; ++f) {
    const float phi = filtered<W, M, kBands>(strip, cm, a, p, a.T + f);
    const int slot = f % a.T;  // global frame T+f
#pragma unroll
    for (int k = 0; k < DIPS_MAX_T; ++k)
      if (k == slot) ring[k] = phi;
    const float cur = tmed(ring, a.T);

    bool capture = false;
    float diff_i;
    if (a.overall) {
      capture = flags[f] != 0;
      if (capture) base = cur;
      diff_i = base - cur;
    } else {
      diff_i = prev - cur;
      prev = cur;
    }
    emit(a, p, red, f, cur, diff_i, capture, valid[f], heat);
  }

  if (a.overall) a.base[p.pix] = base;
  a.heat[p.pix] = heat;
}

struct TailKernel {
  template <int W, int M, bool kBands>
  static void go(dim3 grid, dim3 block, cudaStream_t s, const MedianArgs& a) {
    median_tail_kernel<W, M, kBands><<<grid, block, 0, s>>>(a);
  }
};

}  // namespace

// raw is (T+B, 3, S*Hp, Wp); Hp is one section's height (a stream's padded
// height, or a row slab's); the slab bands btop / bbot are (T+B, 3, S*8,
// Wp), frame for frame with raw, or both null; parts is float
// (B, S, n_tiles, 4).
extern "C" int dips_median_tail(
    const void* raw, const void* btop, const void* bbot, void* base, void* heat, void* out, void* parts,
    const void* flags, const void* valid, int S, int B, int Hp, int Wp,
    int T, int W, int mode, int overall, int out_mode, int chroma,
    int filter, float k, float sens, float lo_clip, float hi_clip,
    float scale, float thr, int y0, int x0, int y1, int x1, void* stream) {
  if (!valid_launch(S, B, Hp, Wp, T, mode, out_mode, chroma) ||
      (btop == nullptr) != (bbot == nullptr) || (btop != nullptr && W == 1))
    return (int)cudaErrorInvalidValue;
  MedianArgs a{(const uint8_t*)raw, (const uint8_t*)btop,
               (const uint8_t*)bbot, nullptr, nullptr, (float*)base,
               (float*)heat, (uint8_t*)out, (float*)parts,
               (const int*)flags, (const int*)valid, nullptr, nullptr, B, Hp,
               Wp, T, overall, out_mode, chroma, filter, k, sens, lo_clip,
               hi_clip, scale, thr, y0, x0, y1, x1};
  const dim3 block(kTx, kTy), grid(Wp / kTx, Hp / kTy, S);
  cudaStream_t s = (cudaStream_t)stream;
  return launch<TailKernel>(W, mode, grid, block, s, a);
}

