// Kernel 2: the median ring-carry step (COLORIZE / GRAYSCALE / no maps).
//
// Replaces the Pallas kernel _make_ring_kernel in
// dips_tpu/ops/pallas_fused.py, with its helpers _intensity_i,
// _filtered_plane, _halo_specs and _emit_median_frame (called through
// batch_step_ring and batch_step_ring_stacked).
//
// Per pixel and frame: intensity on the integer scale [0, 510] (cmax+cmin,
// or 2*channel) -> spatial filter with zero taps outside [0,Hp) x [0,Wp):
// the exact w x w median, the separable approximation (approx_median) or
// the reference's off-center rank pick followed by the even-integer
// store-back (quirk_compat), a compile-time mode -> write into the carried
// ring at slot (off+f) mod T when
// the frame is valid (`seed` fills every slot, and prev in PER_FRAME, with
// frame 0) -> exact temporal median (index T/2) -> diff against the
// baseline (OVERALL, captured on a flagged valid frame) or the previous
// median (PER_FRAME, advanced on valid frames) -> times f32(1/510) ->
// masked statistic partials and heatmap -> emphasis -> COLORIZE/GRAYSCALE
// u8 maps; capture frames render the new baseline gray.
//
// Row slabs (the dyn_rows and slab_bands forms of _make_ring_kernel, for
// parallel/grid2d.py): a section may be a horizontal slab of a stream
// instead of a whole one.  Hp is then the slab's height, [y0, y1) its own
// row window of the statistics mask (launch arguments, as the TPU kernel
// prefetches them), and with bands the stencil's taps above and below the
// slab read the neighbouring slabs' rows from two thin band inputs
// (median_common.cuh) instead of zeros.
//
// Streams: S streams are stacked along the rows (JAX's row-stacked layout:
// raw (B, 3, S*Hp, Wp), ring (T, S*Hp, Wp), planes (S*Hp, Wp)).  The grid's
// z dimension is the stream; flags / valid are (S, B), the ring offsets and
// seeds (S,), all int32 on the device.  Every row test is stream-local: the
// halo stops at the stream's own rows [0, Hp) -- rows si*Hp .. (si+1)*Hp
// of the stack -- so a tap never reads the neighbouring stream, and the roi
// mask tests the row within the stream.
//
// Design: a 32x8 block owns one pixel tile (x along the width, so a warp
// reads and writes 32 consecutive bytes per plane) and loops over the
// batch's frames in order.  The carried state -- the T ring values,
// baseline or prev, and the heatmap -- is read from HBM once, kept in
// registers for the whole batch, and written once.  Each frame the block
// stages its tile plus a p-pixel halo of intensity in shared memory, with
// explicit zeros outside the padded plane, and each thread runs the
// selection networks generated from ops/networks.py (median_networks.cuh).
// Statistic partials leave per (frame, tile), reduced in a fixed order with
// warp shuffles and shared memory (no atomics); the sum over tiles runs
// outside, in plain torch.  The staging, spatial median and per-frame
// emit live in median_common.cuh, shared with the tail kernel
// (median_tail.cu).
//
// Bound: per frame it reads 3*Hp*Wp bytes (plus the halo re-reads) and
// writes C*Hp*Wp bytes, and does a few hundred integer min/max per pixel at
// w=7 (about 30 at w=3) plus the emphasis transcendental, so w=3 is near
// the memory bound and w=7 is bound by the integer pipes.  The separable
// mode needs 8 / 24 / 44 min/max per pixel at w = 3 / 5 / 7 (column
// medians for the tile's halo columns too, through one more barrier), the
// quirk mode 0 / 83 / 389.
//
// Arithmetic mirrors the float32 reference op for op (multiplies where it
// multiplies, expf/logf, rintf = round half to even); build with
// -fmad=false and without fast math.

#include "median_common.cuh"

namespace {

using namespace dips_median;

template <int W, int M, bool kBands>
__global__ void __launch_bounds__(kTx * kTy) median_ring_kernel(MedianArgs a) {
  constexpr int P = W / 2;
  __shared__ int strip[kTy + 2 * P][kTx + 2 * P];
  __shared__ int cm[kCmRows<M>][kTx + 2 * P];
  __shared__ float red[kWarps][4];

  const Pixel p = locate(a);
  const int* flags = a.flags + (long long)p.si * a.B;
  const int* valid = a.valid + (long long)p.si * a.B;
  const int off = a.offs[p.si];
  const int seed_s = a.seeds[p.si];

  // carried state into registers (ring slots >= T are never read)
  float ring[DIPS_MAX_T];
#pragma unroll
  for (int k = 0; k < DIPS_MAX_T; ++k)
    ring[k] = k < a.T ? a.ring[k * p.plane + p.pix] : 0.f;
  float prev = a.overall ? 0.f : a.prev[p.pix];
  float base = a.base[p.pix];
  float heat = a.heat[p.pix];

  for (int f = 0; f < a.B; ++f) {
    // the previous frame's readers of the strip are done: they passed that
    // frame's reduction barrier
    const float phi = filtered<W, M, kBands>(strip, cm, a, p, f);

    const int v = valid[f];
    const int slot = (off + f) % a.T;
    const bool seed = f == 0 && seed_s != 0;
#pragma unroll
    for (int k = 0; k < DIPS_MAX_T; ++k)
      if ((v != 0 && k == slot) || seed) ring[k] = phi;
    if (seed && !a.overall) prev = phi;
    const float cur = tmed(ring, a.T);

    bool capture = false;
    float diff_i;
    if (a.overall) {
      capture = flags[f] != 0 && v != 0;
      if (capture) base = cur;
      diff_i = base - cur;
    } else {
      diff_i = prev - cur;
      if (v != 0) prev = cur;
    }
    emit(a, p, red, f, cur, diff_i, capture, v, heat);
  }

#pragma unroll
  for (int k = 0; k < DIPS_MAX_T; ++k)
    if (k < a.T) a.ring[k * p.plane + p.pix] = ring[k];
  if (a.overall) a.base[p.pix] = base;
  else a.prev[p.pix] = prev;
  a.heat[p.pix] = heat;
}

struct RingKernel {
  template <int W, int M, bool kBands>
  static void go(dim3 grid, dim3 block, cudaStream_t s, const MedianArgs& a) {
    median_ring_kernel<W, M, kBands><<<grid, block, 0, s>>>(a);
  }
};

}  // namespace

// Hp is one section's height (a stream's padded height, or a row slab's);
// [y0, y1) x [x0, x1) is the statistics / heatmap window in section-local
// rows; btop / bbot are the slab bands (B, 3, S*8, Wp), or both null; parts
// is float (B, S, n_tiles, 4); the caller keeps every offset in [0, T).
extern "C" int dips_median_ring(
    const void* raw, const void* btop, const void* bbot, void* ring, void* prev, void* base, void* heat,
    void* out, void* parts, const void* flags, const void* valid,
    const void* offs, const void* seeds, int S, int B, int Hp, int Wp, int T,
    int W, int mode, int overall, int out_mode, int chroma, int filter,
    float k, float sens, float lo_clip, float hi_clip, float scale, float thr,
    int y0, int x0, int y1, int x1, void* stream) {
  if (!valid_launch(S, B, Hp, Wp, T, mode, out_mode, chroma) ||
      (btop == nullptr) != (bbot == nullptr) || (btop != nullptr && W == 1))
    return (int)cudaErrorInvalidValue;
  MedianArgs a{(const uint8_t*)raw, (const uint8_t*)btop,
               (const uint8_t*)bbot, (float*)ring, (float*)prev,
               (float*)base, (float*)heat, (uint8_t*)out, (float*)parts,
               (const int*)flags, (const int*)valid, (const int*)offs,
               (const int*)seeds, B, Hp, Wp, T, overall, out_mode, chroma,
               filter, k, sens, lo_clip, hi_clip, scale, thr, y0, x0, y1, x1};
  const dim3 block(kTx, kTy), grid(Wp / kTx, Hp / kTy, S);
  cudaStream_t s = (cudaStream_t)stream;
  return launch<RingKernel>(W, mode, grid, block, s, a);
}

