// Device helpers shared by the two median kernels (median_ring.cu and
// median_tail.cu): the argument block, intensity, the spatial filter of one
// staged frame (exact median, separable approximation or the reference's
// quirk, a compile-time mode), and the per-frame emit (statistic partials, heatmap,
// emphasis, COLORIZE / GRAYSCALE maps) -- the counterparts of _intensity_i,
// _filtered_plane and _emit_median_frame in dips_tpu/ops/pallas_fused.py.
//
// Both kernels use the same tile: a 32x8 block owns one pixel tile of one
// stream (grid z), x along the width so a warp reads and writes 32
// consecutive bytes per plane.  Arithmetic mirrors the float32 reference op
// for op (multiplies where it multiplies, expf/logf, rintf = round half to
// even); build with -fmad=false and without fast math.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "median_networks.cuh"

namespace dips_median {

constexpr int kTx = 32, kTy = 8;
constexpr int kWarps = kTx * kTy / 32;
constexpr int kBand = 8;  // rows of a slab band (>= the widest halo, 3)

// One launch's arguments.  The tail kernel leaves ring, prev, offs and
// seeds null; raw then holds the T tail frames ahead of the B new ones.
// Hp is one stacked section's height: a stream's padded height, or, for a
// row slab (parallel/grid2d.py), the slab's; [y0, y1) is then the slab's
// own row window.  btop / bbot are the slab bands, (frames, 3, S*kBand, Wp)
// u8 with the frames of raw: section si's rows above its first row are
// rows si*kBand .. of btop, the rows below its last row those of bbot.
// Both null: taps outside the section read zero.
struct MedianArgs {
  const uint8_t* raw;
  const uint8_t* btop;
  const uint8_t* bbot;
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

// Where one thread of the block sits: its pixel, stream and tile.
struct Pixel {
  int tx, ty, tid, lane, warp, bx, by, x, y, si, S, ntiles, tile;
  long long sec, plane, pix;
};

__device__ __forceinline__ Pixel locate(const MedianArgs& a) {
  Pixel p;
  p.tx = threadIdx.x;
  p.ty = threadIdx.y;
  p.tid = p.ty * kTx + p.tx;
  p.lane = p.tid & 31;
  p.warp = p.tid >> 5;
  p.bx = blockIdx.x * kTx;
  p.by = blockIdx.y * kTy;
  p.x = p.bx + p.tx;  // the grid covers the plane exactly
  p.y = p.by + p.ty;
  p.si = blockIdx.z;
  p.S = gridDim.z;
  p.sec = (long long)a.Hp * a.Wp;  // one stream's plane
  p.plane = p.sec * p.S;           // a stacked plane
  p.pix = p.si * p.sec + (long long)p.y * a.Wp + p.x;
  p.ntiles = gridDim.x * gridDim.y;
  p.tile = blockIdx.y * gridDim.x + blockIdx.x;
  return p;
}

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

// Spatial filter modes (DiPsProperties): the exact w x w median, the
// separable approximation (approx_median) and the reference's off-center
// rank pick with its u8 store-back (quirk_compat).
constexpr int kExact = 0, kApprox = 1, kQuirk = 2;

template <int W>
__device__ __forceinline__ int window_median(const int* s, int ld) {
  if constexpr (W == 1) return s[0];
  else if constexpr (W == 3) return wmed3(s, ld);
  else if constexpr (W == 5) return wmed5(s, ld);
  else return wmed7(s, ld);
}

// the median of W taps s[0], s[step], ... (networks.median_network(W))
template <int W>
__device__ __forceinline__ int line_median(const int* s, int step) {
  if constexpr (W == 3) return smed3(s, step);
  else if constexpr (W == 5) return smed5(s, step);
  else return smed7(s, step);
}

// networks.quirk_window_select over the (W-1) x (W-1) taps at s
template <int W>
__device__ __forceinline__ int quirk_select(const int* s, int ld) {
  if constexpr (W == 3) return qsel3(s, ld);
  else if constexpr (W == 5) return qsel5(s, ld);
  else return qsel7(s, ld);
}

// Rows of the column-median scratch: only the separable mode uses it.
template <int M>
constexpr int kCmRows = M == kApprox ? kTy : 1;

// Stage frame f's intensity for the tile plus a W/2-pixel halo in `strip`,
// then return this thread's filtered value in mode M:
// * kExact: the exact W x W median of the taps at offsets [-P, P];
// * kApprox (networks.separable_median): each column's median over rows
//   [-P, P] for the tile's columns and their P-column halo, written to `cm`,
//   a barrier, then the median across the thread's W column medians;
// * kQuirk (networks.quirk_window_select): the rank pick over the taps at
//   offsets [-P, P) in both axes, then the u8 store-back 2 * rint(phi / 2)
//   (also at W = 1, where there is no window).
// Taps outside the section's own rows [0, Hp) or the columns [0, Wp) read
// zero, so a halo never reaches the neighbouring section, and an
// out-of-range column's median is 0, as the TPU's wrapped zero lanes give.
// With slab bands (kBands; the counterpart of _filtered_plane's
// bandtop_ref / bandbot_ref) a tap in the P rows above the section reads
// the last P rows of the section's own top band, a tap in the P rows below
// it the first P rows of its bottom band; columns outside [0, Wp) stay
// zero.  kBands is a compile-time flag: tested at run time (a null band
// pointer), the branch cost the zero-fill instances registers and up to a
// quarter of their speed, so they compile without it, as before.
// The caller must have passed a barrier since the strip's and cm's
// previous readers read them.
template <int W, int M, bool kBands, int CR>
__device__ __forceinline__ float filtered(
    int (&strip)[kTy + 2 * (W / 2)][kTx + 2 * (W / 2)],
    int (&cm)[CR][kTx + 2 * (W / 2)], const MedianArgs& a, const Pixel& p,
    int f) {
  constexpr int P = W / 2;
  constexpr int SW = kTx + 2 * P, SH = kTy + 2 * P;
  const uint8_t* fr = a.raw + (long long)f * 3 * p.plane + p.si * p.sec;
  for (int i = p.tid; i < SH * SW; i += kTx * kTy) {
    const int r = i / SW, c = i % SW;
    const int gy = p.by + r - P, gx = p.bx + c - P;
    int v = 0;
    if (gy >= 0 && gy < a.Hp && gx >= 0 && gx < a.Wp) {
      v = intensity(fr, p.plane, (long long)gy * a.Wp + gx, a.chroma);
    } else if constexpr (kBands) {
      if (gx >= 0 && gx < a.Wp) {
        // band row kBand + gy of the top band, gy - Hp of the bottom one
        const long long bplane = (long long)p.S * kBand * a.Wp;
        const uint8_t* band = (gy < 0 ? a.btop : a.bbot) +
                              (long long)f * 3 * bplane +
                              (long long)p.si * kBand * a.Wp;
        const int br = gy < 0 ? kBand + gy : gy - a.Hp;
        v = intensity(band, bplane, (long long)br * a.Wp + gx, a.chroma);
      }
    }
    strip[r][c] = v;
  }
  __syncthreads();
  if constexpr (M == kQuirk) {
    float phi;
    if constexpr (W == 1) phi = (float)strip[p.ty][p.tx];
    else phi = (float)quirk_select<W>(&strip[p.ty][p.tx], SW);
    return 2.f * rintf(phi * 0.5f);
  } else if constexpr (M == kApprox && W > 1) {
    for (int i = p.tid; i < kTy * SW; i += kTx * kTy) {
      const int r = i / SW, c = i % SW;
      cm[r][c] = line_median<W>(&strip[r][c], SW);
    }
    __syncthreads();
    return (float)line_median<W>(&cm[p.ty][p.tx], 1);
  } else {
    return (float)window_median<W>(&strip[p.ty][p.tx], SW);
  }
}

// Emit output frame f from its temporal median `cur` and integer diff
// `diff_i`: masked statistic partials, the heatmap (+ |diff| * valid), and
// the maps (a capture frame renders the new baseline gray).  Ends with the
// block's fixed-order reduction; thread 0 writes the tile's partials.
// red[] and the strip are rewritten next frame only after its staging
// barrier, which thread 0 reaches after reading red[] here.
__device__ __forceinline__ void emit(const MedianArgs& a, const Pixel& p,
                                     float (&red)[kWarps][4], int f,
                                     float cur, float diff_i, bool capture,
                                     int v, float& heat) {
  const int C = a.out_mode == 1 ? 3 : (a.out_mode == 2 ? 1 : 0);
  const float mask = (p.y >= a.y0 && p.y < a.y1 && p.x >= a.x0 &&
                      p.x < a.x1) ? 1.f : 0.f;
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
    uint8_t* dst = a.out + (long long)f * C * p.plane + p.pix;
    dst[0] = o0;
    if (C == 3) {
      dst[p.plane] = o1;
      dst[2 * p.plane] = o2;
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
  if (p.lane == 0) {
    red[p.warp][0] = s0; red[p.warp][1] = s1;
    red[p.warp][2] = s2; red[p.warp][3] = s3;
  }
  __syncthreads();
  if (p.tid == 0) {
    float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f;
    for (int i = 0; i < kWarps; ++i) {
      t0 += red[i][0]; t1 += red[i][1];
      t2 = fmaxf(t2, red[i][2]); t3 += red[i][3];
    }
    float* part =
        a.parts + (((long long)f * p.S + p.si) * p.ntiles + p.tile) * 4;
    part[0] = t0; part[1] = t1; part[2] = t2; part[3] = t3;
  }
}

// Launch K::go<W, M, kBands> for the runtime window W, spatial mode M and
// the band form (a.btop non-null; window 1 has no taps to feed and no band
// instance).  Every instance is compiled; mode and band form are template
// parameters, not branches in the kernel.  Reports the launch's error code.
template <class K, int W, bool kBands>
__host__ inline int launch_mode(int mode, dim3 grid, dim3 block,
                                cudaStream_t s, const MedianArgs& a) {
  switch (mode) {
    case kExact: K::template go<W, kExact, kBands>(grid, block, s, a); break;
    case kApprox:
      K::template go<W, kApprox, kBands>(grid, block, s, a);
      break;
    case kQuirk: K::template go<W, kQuirk, kBands>(grid, block, s, a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <class K, int W>
__host__ inline int launch_bands(int mode, dim3 grid, dim3 block,
                                 cudaStream_t s, const MedianArgs& a) {
  if (a.btop == nullptr)
    return launch_mode<K, W, false>(mode, grid, block, s, a);
  if constexpr (W > 1)
    return launch_mode<K, W, true>(mode, grid, block, s, a);
  return (int)cudaErrorInvalidValue;
}

template <class K>
__host__ inline int launch(int W, int mode, dim3 grid, dim3 block,
                           cudaStream_t s, const MedianArgs& a) {
  switch (W) {
    case 1: return launch_bands<K, 1>(mode, grid, block, s, a);
    case 3: return launch_bands<K, 3>(mode, grid, block, s, a);
    case 5: return launch_bands<K, 5>(mode, grid, block, s, a);
    case 7: return launch_bands<K, 7>(mode, grid, block, s, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The argument checks shared by both entry points.
__host__ inline bool valid_launch(int S, int B, int Hp, int Wp, int T,
                                  int mode, int out_mode, int chroma) {
  return S >= 1 && S <= 65535 && B >= 1 && Hp % kTy == 0 && Wp % kTx == 0 &&
         T >= 1 && T <= DIPS_MAX_T && mode >= kExact && mode <= kQuirk &&
         out_mode >= 0 && out_mode <= 2 && chroma >= 0 && chroma <= 3;
}

}  // namespace dips_median
