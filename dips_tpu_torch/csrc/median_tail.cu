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
// Design: the ring-carry kernel's tile and frame loop (median_ring.cu,
// median_common.cuh), over all T+B frames: the first T only fill the ring,
// which lives in shared memory (T <= DIPS_MAX_T); baseline and heatmap are
// read once and written once per launch.
//
// Bound: per launch it reads (T+B)*3*Hp*Wp bytes and writes B*C*Hp*Wp, and
// runs T+B spatial medians where the ring kernel runs B, so at T=4, B=16 it
// does 1.25x the ring kernel's selection work on 1.25x its input bytes; it
// carries no ring in and out, so at w=3 the integer pipes bound it, not
// the bytes.

#include "median_common.cuh"

// Built once per window: -DDIPS_WINDOW=W compiles that window's instances.

namespace {

using namespace dips_median;

template <int W, int M, bool kBands>
__global__ void __launch_bounds__(kThreads)
    median_tail_kernel(const MedianArgs a, const __grid_constant__ Maps m) {
  const Tile<W, M, kBands> t(a);
  const int* flags = a.flags + (long long)t.si * a.B;
  const int* valid = a.valid + (long long)t.si * a.B;

  float prev[kPx] = {0.f, 0.f, 0.f, 0.f}, base[kPx], heat[kPx];
  ld4(a.base + t.pix, base);
  ld4(a.heat + t.pix, heat);

  t.run(a, m, a.T + a.B, [&](int g, const float (&phi)[kPx]) {
    const int f = g - a.T;
    t.put(f < 0 ? g : f % a.T, phi);  // tail frame g, or global frame T+f
    if (f < -1 || (f == -1 && a.overall)) return;
    float cur[kPx], diff[kPx];
    ring_median(t, a.T, cur);
    if (f == -1) {  // the last tail frame: PER_FRAME's first reference
#pragma unroll
      for (int k = 0; k < kPx; ++k) prev[k] = cur[k];
      return;
    }
    const bool capture = a.overall && flags[f] != 0;
#pragma unroll
    for (int k = 0; k < kPx; ++k) {
      if (a.overall) {
        if (capture) base[k] = cur[k];
        diff[k] = base[k] - cur[k];
      } else {
        diff[k] = prev[k] - cur[k];
        prev[k] = cur[k];
      }
    }
    emit(a, t, f, cur, diff, capture, valid[f], heat);
  });

  if (a.overall) st4(a.base + t.pix, base);
  st4(a.heat + t.pix, heat);
}

struct TailKernel {
  template <int W, int M, bool kBands>
  static auto kernel() { return &median_tail_kernel<W, M, kBands>; }
};

}  // namespace

namespace dips_median {
template <int W, int M>
int instance(Tail, cudaStream_t s, const MedianArgs& a) {
  return launch_bands<TailKernel, W, M>(s, a);
}
template int instance<DIPS_WINDOW, kExact>(Tail, cudaStream_t,
                                           const MedianArgs&);
template int instance<DIPS_WINDOW, kApprox>(Tail, cudaStream_t,
                                            const MedianArgs&);
template int instance<DIPS_WINDOW, kQuirk>(Tail, cudaStream_t,
                                           const MedianArgs&);
}  // namespace dips_median

#if DIPS_WINDOW == 1  // the window-1 unit also holds the entry points

using namespace dips_median;

// raw is (T+B, 3, S*Hp, Wp); Hp is one section's height (a stream's padded
// height, or a row slab's); the slab bands btop / bbot are (T+B, 3, S*8,
// Wp), frame for frame with raw, or both null; parts is float
// (B, S, dips_median_parts(Hp, Wp), 4).
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
               (const int*)flags, (const int*)valid, nullptr, nullptr, S,
               T + B, B, Hp, Wp, T, overall, out_mode, chroma, filter, k,
               sens, lo_clip, hi_clip, scale, thr, y0, x0, y1, x1};
  return launch<Tail>(W, mode, (cudaStream_t)stream, a);
}

#endif  // DIPS_WINDOW == 1
