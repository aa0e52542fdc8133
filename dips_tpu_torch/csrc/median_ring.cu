// Kernel 2: the median ring-carry step (COLORIZE / GRAYSCALE / no maps).
//
// Replaces the Pallas kernel _make_ring_kernel in
// dips_tpu/ops/pallas_fused.py, with its helpers _intensity_i,
// _filtered_plane, _halo_specs and _emit_median_frame (called through
// batch_step_ring and batch_step_ring_stacked).
//
// Per pixel and frame: intensity on the integer scale [0, 510] (cmax+cmin,
// or 2*channel) -> exact w x w spatial median with zero taps outside
// [0,Hp) x [0,Wp) -> write into the carried ring at slot (off+f) mod T when
// the frame is valid (`seed` fills every slot, and prev in PER_FRAME, with
// frame 0) -> exact temporal median (index T/2) -> diff against the
// baseline (OVERALL, captured on a flagged valid frame) or the previous
// median (PER_FRAME, advanced on valid frames) -> times f32(1/510) ->
// masked statistic partials and heatmap -> emphasis -> COLORIZE/GRAYSCALE
// u8 maps; capture frames render the new baseline gray.
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
// outside, in plain torch.
//
// Bound: per frame it reads 3*Hp*Wp bytes (plus the halo re-reads) and
// writes C*Hp*Wp bytes, and does a few hundred integer min/max per pixel at
// w=7 (about 30 at w=3) plus the emphasis transcendental, so w=3 is near
// the memory bound and w=7 is bound by the integer pipes.
//
// Arithmetic mirrors the float32 reference op for op (multiplies where it
// multiplies, expf/logf, rintf = round half to even); build with
// -fmad=false and without fast math.

#include <cstdint>
#include <cuda_runtime.h>

#include "median_networks.cuh"

namespace {

constexpr int kTx = 32, kTy = 8;
constexpr int kWarps = kTx * kTy / 32;

struct MedianArgs {
  const uint8_t* raw;
  float* ring;
  float* prev;
  float* base;
  float* heat;
  uint8_t* out;
  float* parts;
  const int* flags;
  const int* valid;
  const int* offs;
  const int* seeds;
  int B, Hp, Wp, T, overall, out_mode, chroma, filter;
  float k, sens, lo_clip, hi_clip, scale, thr;
  int y0, x0, y1, x1;
};

__device__ __forceinline__ int intensity(const uint8_t* raw, long long plane,
                                         long long pix, int chroma) {
  if (chroma != 0) return 2 * (int)raw[(chroma - 1) * plane + pix];
  const int r = raw[pix], g = raw[plane + pix], b = raw[2 * plane + pix];
  return max(max(r, g), b) + min(min(r, g), b);
}

__device__ __forceinline__ uint8_t q8(float x) {
  return (uint8_t)(int)rintf(fminf(fmaxf(x, 0.f), 1.f) * 255.f);
}

__device__ __forceinline__ float emphasize(float raw, const MedianArgs& a) {
  float d = raw * 0.5f;
  if (a.filter == 0) {          // sigmoid
    d = 1.f / (1.f + expf(-a.k * d)) - 0.5f;
  } else if (a.filter == 1) {   // inverse sigmoid
    const float dc = fminf(fmaxf(d, a.lo_clip), a.hi_clip);
    d = -logf(1.f / (dc + 0.5f) - 1.f) / a.k;
  }
  return d * a.sens;
}

template <int W>
__device__ __forceinline__ int window_median(const int* s, int ld) {
  if constexpr (W == 1) return s[0];
  else if constexpr (W == 3) return wmed3(s, ld);
  else if constexpr (W == 5) return wmed5(s, ld);
  else return wmed7(s, ld);
}

template <int W>
__global__ void __launch_bounds__(kTx * kTy) median_ring_kernel(MedianArgs a) {
  constexpr int P = W / 2;
  constexpr int SW = kTx + 2 * P, SH = kTy + 2 * P;
  __shared__ int strip[SH][SW];
  __shared__ float red[kWarps][4];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTx + tx;
  const int lane = tid & 31, warp = tid >> 5;
  const int bx = blockIdx.x * kTx, by = blockIdx.y * kTy;
  const int x = bx + tx, y = by + ty;  // the grid covers the plane exactly
  const int si = blockIdx.z, S = gridDim.z;
  const long long sec = (long long)a.Hp * a.Wp;  // one stream's plane
  const long long plane = sec * S;               // a stacked plane
  const long long pix = si * sec + (long long)y * a.Wp + x;
  const int* flags = a.flags + (long long)si * a.B;
  const int* valid = a.valid + (long long)si * a.B;
  const int off = a.offs[si];
  const int seed_s = a.seeds[si];
  const int ntiles = gridDim.x * gridDim.y;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int C = a.out_mode == 1 ? 3 : (a.out_mode == 2 ? 1 : 0);
  const float mask =
      (y >= a.y0 && y < a.y1 && x >= a.x0 && x < a.x1) ? 1.f : 0.f;

  // carried state into registers (ring slots >= T are never read)
  float ring[DIPS_MAX_T];
#pragma unroll
  for (int k = 0; k < DIPS_MAX_T; ++k)
    ring[k] = k < a.T ? a.ring[k * plane + pix] : 0.f;
  float prev = a.overall ? 0.f : a.prev[pix];
  float base = a.base[pix];
  float heat = a.heat[pix];

  for (int f = 0; f < a.B; ++f) {
    // stage intensity of the tile plus halo; the previous frame's readers
    // are done (they passed that frame's reduction barrier).  gy is the
    // stream-local row: taps outside this stream's rows read zero
    const uint8_t* fr = a.raw + (long long)f * 3 * plane + si * sec;
    for (int i = tid; i < SH * SW; i += kTx * kTy) {
      const int r = i / SW, c = i % SW;
      const int gy = by + r - P, gx = bx + c - P;
      int v = 0;
      if (gy >= 0 && gy < a.Hp && gx >= 0 && gx < a.Wp)
        v = intensity(fr, plane, (long long)gy * a.Wp + gx, a.chroma);
      strip[r][c] = v;
    }
    __syncthreads();
    const float phi = (float)window_median<W>(&strip[ty][tx], SW);

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
    const float raw = diff_i * a.scale;
    const float dm = raw * mask;
    const float am = fabsf(dm);
    heat = heat + am * (float)v;

    if (C > 0) {
      uint8_t o0, o1 = 0, o2 = 0;
      if (capture) {
        o0 = o1 = o2 = q8(cur * a.scale);
      } else {
        const float d = emphasize(raw, a);
        if (C == 3) {
          const float sa = fabsf(d);
          const uint8_t hi = q8(0.5f + sa * 0.5f);
          const uint8_t lo = q8(0.5f - sa * 0.5f);
          const bool neg = d < 0.f;
          o0 = neg ? hi : lo;
          o1 = neg ? lo : hi;
          o2 = lo;
        } else {
          o0 = q8(0.5f - d);
        }
      }
      uint8_t* dst = a.out + (long long)f * C * plane + pix;
      dst[0] = o0;
      if (C == 3) {
        dst[plane] = o1;
        dst[2 * plane] = o2;
      }
    }

    // fixed-order block reduction: sum dm, sum |dm|, max |dm|, count
    float s0 = dm, s1 = am, s2 = am, s3 = am >= a.thr ? 1.f : 0.f;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      s0 += __shfl_down_sync(0xffffffffu, s0, s);
      s1 += __shfl_down_sync(0xffffffffu, s1, s);
      s2 = fmaxf(s2, __shfl_down_sync(0xffffffffu, s2, s));
      s3 += __shfl_down_sync(0xffffffffu, s3, s);
    }
    if (lane == 0) {
      red[warp][0] = s0; red[warp][1] = s1;
      red[warp][2] = s2; red[warp][3] = s3;
    }
    __syncthreads();
    if (tid == 0) {
      float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f;
      for (int i = 0; i < kWarps; ++i) {
        t0 += red[i][0]; t1 += red[i][1];
        t2 = fmaxf(t2, red[i][2]); t3 += red[i][3];
      }
      float* p = a.parts + (((long long)f * S + si) * ntiles + tile) * 4;
      p[0] = t0; p[1] = t1; p[2] = t2; p[3] = t3;
    }
    // red[] and strip[] are rewritten next frame only after its staging
    // barrier, which thread 0 reaches after reading red[] here
  }

#pragma unroll
  for (int k = 0; k < DIPS_MAX_T; ++k)
    if (k < a.T) a.ring[k * plane + pix] = ring[k];
  if (a.overall) a.base[pix] = base;
  else a.prev[pix] = prev;
  a.heat[pix] = heat;
}

}  // namespace

// Hp is one stream's padded height; parts is float (B, S, n_tiles, 4); the
// caller keeps every offset in [0, T).
extern "C" int dips_median_ring(
    const void* raw, void* ring, void* prev, void* base, void* heat,
    void* out, void* parts, const void* flags, const void* valid,
    const void* offs, const void* seeds, int S, int B, int Hp, int Wp, int T,
    int W, int overall, int out_mode, int chroma, int filter, float k,
    float sens, float lo_clip, float hi_clip, float scale, float thr, int y0,
    int x0, int y1, int x1, void* stream) {
  if (S < 1 || S > 65535 || B < 1 || Hp % kTy != 0 || Wp % kTx != 0 ||
      T < 1 || T > DIPS_MAX_T || out_mode < 0 || out_mode > 2 || chroma < 0 ||
      chroma > 3)
    return (int)cudaErrorInvalidValue;
  MedianArgs a{(const uint8_t*)raw, (float*)ring, (float*)prev,
               (float*)base, (float*)heat, (uint8_t*)out, (float*)parts,
               (const int*)flags, (const int*)valid, (const int*)offs,
               (const int*)seeds, B, Hp, Wp, T, overall, out_mode, chroma,
               filter, k, sens, lo_clip, hi_clip, scale, thr, y0, x0, y1, x1};
  const dim3 block(kTx, kTy), grid(Wp / kTx, Hp / kTy, S);
  cudaStream_t s = (cudaStream_t)stream;
  switch (W) {
    case 1: median_ring_kernel<1><<<grid, block, 0, s>>>(a); break;
    case 3: median_ring_kernel<3><<<grid, block, 0, s>>>(a); break;
    case 5: median_ring_kernel<5><<<grid, block, 0, s>>>(a); break;
    case 7: median_ring_kernel<7><<<grid, block, 0, s>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
