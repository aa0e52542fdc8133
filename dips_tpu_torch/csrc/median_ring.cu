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
// Design: a block owns an 8 x 128 tile (median_common.cuh) and loops over
// the batch's frames in order with three frames staged ahead by TMA.  The
// carried state is read from HBM once and written once: baseline or prev
// and the heatmap in registers, the T ring slots in shared memory.  Each
// frame the block turns its staged frame into intensities, sorts each
// column once for the whole tile, and each thread merges the sorted
// columns of its 4 pixels (the selection networks generated from
// ops/networks.py, median_networks.cuh).  Statistic partials leave per
// (frame, tile, warp), reduced in a fixed order (no atomics); the sum over
// the partials runs outside, in plain torch.
//
// Bound: per frame it reads 3*Hp*Wp bytes (the halo re-reads hit L2) and
// writes C*Hp*Wp bytes, plus the carried state once per batch; per pixel
// the exact median's column sort and merge plan are 6 + 16 min/max at w=3
// and 32 + 320 at w=7, so w=3 is near the memory bound and w=7 is bound by
// the integer pipes.  The separable mode needs 4 + 4 / 14 + 14 / 26 + 26
// (w = 3 / 5 / 7), the quirk mode 0 / 83 / 389.
//
// Arithmetic mirrors the float32 reference op for op (multiplies where it
// multiplies, expf/logf, rintf = round half to even); build with
// -fmad=false and without fast math.

#include "median_common.cuh"

// Built once per window: -DDIPS_WINDOW=W compiles that window's instances.

namespace {

using namespace dips_median;

template <int W, int M, bool kBands>
__global__ void __launch_bounds__(kThreads)
    median_ring_kernel(const MedianArgs a, const __grid_constant__ Maps m) {
  const Tile<W, M, kBands> t(a);
  const int* flags = a.flags + (long long)t.si * a.B;
  const int* valid = a.valid + (long long)t.si * a.B;
  const int off = a.offs[t.si];
  const int seed_s = a.seeds[t.si];

  // carried state: the ring into shared memory, the rest into registers
  for (int k = 0; k < a.T; ++k) {
    float s[kPx];
    ld4(a.ring + k * t.plane + t.pix, s);
    t.put(k, s);
  }
  float prev[kPx] = {0.f, 0.f, 0.f, 0.f}, base[kPx], heat[kPx];
  if (!a.overall) ld4(a.prev + t.pix, prev);
  ld4(a.base + t.pix, base);
  ld4(a.heat + t.pix, heat);

  t.run(a, m, a.B, [&](int f, const float (&phi)[kPx]) {
    const int v = valid[f];
    const bool seed = f == 0 && seed_s != 0;
    if (seed) {
      for (int k = 0; k < a.T; ++k) t.put(k, phi);
    } else if (v != 0) {
      t.put((off + f) % a.T, phi);
    }
    float cur[kPx], diff[kPx];
    ring_median(t, a.T, cur);
    bool capture = false;
#pragma unroll
    for (int k = 0; k < kPx; ++k) {
      if (seed && !a.overall) prev[k] = phi[k];
      if (a.overall) {
        capture = flags[f] != 0 && v != 0;
        if (capture) base[k] = cur[k];
        diff[k] = base[k] - cur[k];
      } else {
        diff[k] = prev[k] - cur[k];
        if (v != 0) prev[k] = cur[k];
      }
    }
    emit(a, t, f, cur, diff, capture, v, heat);
  });

  for (int k = 0; k < a.T; ++k) {
    float s[kPx];
    t.get(k, s);
    st4(a.ring + k * t.plane + t.pix, s);
  }
  if (a.overall) st4(a.base + t.pix, base);
  else st4(a.prev + t.pix, prev);
  st4(a.heat + t.pix, heat);
}

struct RingKernel {
  template <int W, int M, bool kBands>
  static auto kernel() { return &median_ring_kernel<W, M, kBands>; }
};

}  // namespace

namespace dips_median {
template <int W, int M>
int instance(Ring, cudaStream_t s, const MedianArgs& a) {
  return launch_bands<RingKernel, W, M>(s, a);
}
template int instance<DIPS_WINDOW, kExact>(Ring, cudaStream_t,
                                           const MedianArgs&);
template int instance<DIPS_WINDOW, kApprox>(Ring, cudaStream_t,
                                            const MedianArgs&);
template int instance<DIPS_WINDOW, kQuirk>(Ring, cudaStream_t,
                                           const MedianArgs&);
}  // namespace dips_median

#if DIPS_WINDOW == 1  // the window-1 unit also holds the entry points

using namespace dips_median;

// Hp is one section's height (a stream's padded height, or a row slab's);
// [y0, y1) x [x0, x1) is the statistics / heatmap window in section-local
// rows; btop / bbot are the slab bands (B, 3, S*8, Wp), or both null; parts
// is float (B, S, dips_median_parts(Hp, Wp), 4); the caller keeps every
// offset in [0, T).
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
               (const int*)seeds, S, B, B, Hp, Wp, T, overall, out_mode,
               chroma, filter, k, sens, lo_clip, hi_clip, scale, thr, y0, x0,
               y1, x1};
  return launch<Ring>(W, mode, (cudaStream_t)stream, a);
}

// Statistic partials per (frame, section) of both median kernels: one per
// warp of each 8 x 128 tile; 0 when the section is not whole tiles.
extern "C" int dips_median_parts(int Hp, int Wp) {
  if (Hp < kRows || Hp % kRows != 0 || Wp < kCols || Wp % kCols != 0)
    return 0;
  return (Hp / kRows) * (Wp / kCols) * kWarps;
}

#endif  // DIPS_WINDOW == 1
