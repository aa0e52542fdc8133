// Device helpers shared by the two median kernels (median_ring.cu and
// median_tail.cu): the argument block, the TMA staging of a block's frames,
// intensity, the spatial filter of one staged frame (exact median,
// separable approximation or the reference's quirk, a compile-time mode),
// and the per-frame emit (statistic partials, heatmap, emphasis, COLORIZE /
// GRAYSCALE maps) -- the counterparts of _intensity_i, _filtered_plane and
// _emit_median_frame in dips_tpu/ops/pallas_fused.py.
//
// The tile: a block of 8 warps owns 8 rows x 128 columns of one stream
// (grid z), warp r row r, lane l the 4 adjacent pixels at columns 4l..4l+3,
// so each thread moves its maps as one u32 per plane and its state as one
// float4.  The block steps through its frames in order:
//
// * staging: one thread keeps kStages frames in flight -- each stage is
//   filled by TMA (cp.async.bulk.tensor, 4-D maps over the u8 frames) and
//   signals an mbarrier -- so frame f+1 and f+2 land while frame f computes.
//   A stage holds the tile's 8 rows and its P-row halos above and below,
//   each 160 columns wide (16 columns either side: a TMA box's inner
//   extent is a multiple of 16 bytes, and so must its first column be --
//   a box that starts 8 bytes off a 16-byte boundary faults with an
//   illegal instruction, out of bounds or not).  The hardware's
//   out-of-bounds fill reads zero left of column 0, right of Wp-1 and
//   above and below the section's own rows (Hp is a dimension of the map,
//   so a halo never reaches the neighbouring section); in the band
//   instances a halo at the section's top or bottom edge is loaded from
//   the band tensors instead;
// * intensity: the staged u8 planes, a u32 of 4 columns per plane, become
//   the strip of integer intensities (tile rows -P .. 7+P, columns
//   -4 .. 131);
// * column pass (exact and approx, W > 1): each strip column's W vertical
//   taps are sorted once per tile row (networks.column_median_plan's column
//   sort) or reduced to their median (the separable mode) into shared
//   memory, shared by the W pixels whose windows hold that column;
// * spatial filter: each pixel runs only the merge plan over its W sorted
//   columns (the quirk pick reads the strip directly);
// * emit: the statistic partials are reduced over the thread's 4 pixels,
//   then the warp, and leave as one partial per (frame, stream, tile,
//   warp): no block barrier and no serial tail on the frame's path.
//
// Strip and column buffers store column c (tile-local c - 4) at
// (c & 3) * kSQ + (c >> 2): the 32 lanes of a warp then read 32 adjacent
// 16-bit words for any tap of their 4 adjacent pixels (no bank conflict).
// The temporal ring lives in shared memory, slot k of the thread's pixel
// j at float (k * 4 + j) * kThreads + tid, read and written by that thread
// only (adjacent threads, adjacent words).
//
// Arithmetic mirrors the float32 reference op for op (multiplies where it
// multiplies, expf/logf, rintf = round half to even); build with
// -fmad=false and without fast math.

#pragma once

#include <cstdint>
#include <cstring>
#include <cuda.h>  // CUtensorMap and its enums; no libcuda link (see encoder)
#include <cuda_runtime.h>

#include "median_networks.cuh"

namespace dips_median {

constexpr int kRows = 8;                // tile rows, one warp each
constexpr int kPx = 4;                  // adjacent pixels per thread
constexpr int kCols = 32 * kPx;         // tile columns
constexpr int kThreads = 32 * kRows;
constexpr int kWarps = kRows;
constexpr int kBand = 8;                // rows of a slab band (>= P)
constexpr int kStages = 3;              // frames staged ahead
constexpr int kLead = 16;               // staged columns left of the tile
constexpr int kBoxW = kCols + 2 * kLead;  // a TMA box row: 160 bytes
constexpr int kSC = kCols + 8;          // strip columns: tile-local -4..131
constexpr int kSQ = kSC / 4;

// One launch's arguments.  The tail kernel leaves ring, prev, offs and
// seeds null; raw then holds the T tail frames ahead of the B new ones.
// Hp is one stacked section's height: a stream's padded height, or, for a
// row slab (parallel/grid2d.py), the slab's; [y0, y1) is then the slab's
// own row window.  btop / bbot are the slab bands, (F, 3, S*kBand, Wp) u8
// with the F frames of raw: section si's rows above its first row are rows
// si*kBand .. of btop, the rows below its last row those of bbot.  Both
// null: taps outside the section read zero.
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
  int S, F, B, Hp, Wp, T, overall, out_mode, chroma, filter;
  float k, sens, lo_clip, hi_clip, scale, thr;
  int y0, x0, y1, x1;
};

// The TMA maps of one launch: the tile's 8 rows and the P-row halos of raw;
// the band instances' halo rows of btop / bbot (zero-filled otherwise).
struct Maps {
  CUtensorMap mid, halo, top, bot;
};

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

// sort v[0..W) ascending (the column sort of networks.column_median_plan)
template <int W>
__device__ __forceinline__ void column_sort(int* v) {
  if constexpr (W == 3) csort3(v);
  else if constexpr (W == 5) csort5(v);
  else csort7(v);
}

// the merge plan over W sorted columns: s(dx, j) is rank j of column dx
template <int W, class Tap>
__device__ __forceinline__ int window_merge(Tap s) {
  if constexpr (W == 3) return wmerge3(s);
  else if constexpr (W == 5) return wmerge5(s);
  else return wmerge7(s);
}

// the median of the W taps s(0) .. s(W-1) (networks.median_network(W))
template <int W, class Tap>
__device__ __forceinline__ int line_median(Tap s) {
  if constexpr (W == 3) return smed3(s);
  else if constexpr (W == 5) return smed5(s);
  else return smed7(s);
}

// networks.quirk_window_select over the (W-1) x (W-1) taps s(dx, dy)
template <int W, class Tap>
__device__ __forceinline__ int quirk_select(Tap s) {
  if constexpr (W == 3) return qsel3(s);
  else if constexpr (W == 5) return qsel5(s);
  else return qsel7(s);
}

// --- mbarriers and TMA (PTX) -----------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// box of `map` at (x, y, section, plane) -> shared dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y, int s,
                                         int plane) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_u32(dst)), "l"((uint64_t)map), "r"(smem_u32(bar)),
         "r"(x), "r"(y), "r"(s), "r"(plane)
      : "memory");
}

// --- the block's tile ------------------------------------------------------

// One stage: the halo above, the tile's 8 rows, the halo below, each a TMA
// box (3 planes x rows x kBoxW bytes) at a 128-byte aligned offset.
template <int P>
struct Stage {
  static constexpr int kHalo = 3 * P * kBoxW;
  static constexpr int kHaloPad = (kHalo + 127) / 128 * 128;
  static constexpr int kMidBytes = 3 * kRows * kBoxW;  // 30 x 128
  static constexpr int kTop = 0;
  static constexpr int kMid = kHaloPad;
  static constexpr int kBot = kHaloPad + kMidBytes;
  static constexpr int kBytes = kBot + kHaloPad;
  static constexpr int kTx = kMidBytes + 2 * kHalo;  // bytes a fill delivers
};

extern __shared__ __align__(16) uint8_t dips_smem[];

// A block's view of its tile: where it sits, its shared memory, and the
// frame loop.  Instances: window W, spatial mode M, band form kBands.
template <int W, int M, bool kBands>
struct Tile {
  static constexpr int P = W / 2;
  using St = Stage<P>;
  static constexpr int kStripRows = kRows + 2 * P;
  static constexpr bool kSort = M == kExact && W > 1;
  static constexpr bool kColMed = M == kApprox && W > 1;
  static constexpr bool kColumns = kSort || kColMed;
  // without a column pass the spatial filter reads the strip itself: two
  // strips, so the next frame's intensities never overwrite a read one
  static constexpr int kStrips = kColumns ? 1 : 2;
  static constexpr int kColRows = kSort ? kRows * W : (kColMed ? kRows : 0);
  static constexpr int kBarOff = kStages * St::kBytes;
  static constexpr int kStripOff = kBarOff + 8 * kStages;
  static constexpr int kColOff = kStripOff + 2 * kStrips * kStripRows * kSC;
  static constexpr int kRingOff =
      (kColOff + 2 * kColRows * kSC + 15) / 16 * 16;

  // dynamic shared memory of a launch with `slots` ring slots (128 bytes of
  // slack: the base is aligned up for TMA)
  static size_t smem_bytes(int slots) {
    return 128 + kRingOff + (size_t)slots * kPx * kThreads * sizeof(float);
  }

  uint8_t* base;
  uint64_t* bar;
  uint16_t* strip;
  uint16_t* cols;
  float* ring;
  int tid, warp, lane, bx, by, si, S, tile, ntiles;
  long long plane, pix;  // a stacked plane; this thread's first pixel

  __device__ __forceinline__ explicit Tile(const MedianArgs& a) {
    const uint32_t s0 = smem_u32(dips_smem);
    base = dips_smem + ((128u - (s0 & 127u)) & 127u);
    bar = reinterpret_cast<uint64_t*>(base + kBarOff);
    strip = reinterpret_cast<uint16_t*>(base + kStripOff);
    cols = reinterpret_cast<uint16_t*>(base + kColOff);
    ring = reinterpret_cast<float*>(base + kRingOff);
    tid = threadIdx.x;
    warp = tid >> 5;
    lane = tid & 31;
    bx = blockIdx.x * kCols;
    by = blockIdx.y * kRows;
    si = blockIdx.z;
    S = gridDim.z;
    ntiles = gridDim.x * gridDim.y;
    tile = blockIdx.y * gridDim.x + blockIdx.x;
    const long long sec = (long long)a.Hp * a.Wp;
    plane = sec * S;
    pix = si * sec + (long long)(by + warp) * a.Wp + bx + 4 * lane;
  }

  // ring slot k of the thread's pixel j
  __device__ __forceinline__ float& slot(int k, int j) const {
    return ring[(k * kPx + j) * kThreads + tid];
  }
  __device__ __forceinline__ void put(int k, const float (&v)[kPx]) const {
#pragma unroll
    for (int j = 0; j < kPx; ++j) slot(k, j) = v[j];
  }
  __device__ __forceinline__ void get(int k, float (&v)[kPx]) const {
#pragma unroll
    for (int j = 0; j < kPx; ++j) v[j] = slot(k, j);
  }

  // Fill stage g % kStages with frame g (one thread).
  __device__ __forceinline__ void issue(const MedianArgs& a, const Maps& m,
                                        int g) const {
    const int st = g % kStages;
    uint8_t* dst = base + st * St::kBytes;
    uint64_t* b = bar + st;
    mbar_expect_tx(b, St::kTx);
    const int x = bx - kLead, z = 3 * g;
    tma_load(dst + St::kMid, &m.mid, b, x, by, si, z);
    if constexpr (P > 0) {
      const bool top = kBands && by == 0;
      const bool bot = kBands && by + kRows == a.Hp;
      tma_load(dst + St::kTop, top ? &m.top : &m.halo, b, x,
               top ? kBand - P : by - P, si, z);
      tma_load(dst + St::kBot, bot ? &m.bot : &m.halo, b, x,
               bot ? 0 : by + kRows, si, z);
    }
  }

  // Staged u8 planes -> strip of intensities on the integer scale [0, 510]
  // (cmax + cmin, or 2 * channel): a u32 of 4 columns per plane.
  __device__ __forceinline__ void intensity(const uint8_t* stg, uint16_t* sp,
                                            int chroma) const {
    for (int i = tid; i < kStripRows * kSQ; i += kThreads) {
      const int rr = i / kSQ, g = i - rr * kSQ;
      const uint8_t* row;
      int ps;  // bytes between the planes of this row's box
      if (rr < P) {
        row = stg + St::kTop + rr * kBoxW;
        ps = P * kBoxW;
      } else if (rr < P + kRows) {
        row = stg + St::kMid + (rr - P) * kBoxW;
        ps = kRows * kBoxW;
      } else {
        row = stg + St::kBot + (rr - P - kRows) * kBoxW;
        ps = P * kBoxW;
      }
      row += kLead - 4 + 4 * g;  // tile-local columns 4g - 4 .. 4g - 1
      uint16_t* d = sp + rr * kSC + g;
      if (chroma == 0) {
        const uint32_t r = *reinterpret_cast<const uint32_t*>(row);
        const uint32_t gr = *reinterpret_cast<const uint32_t*>(row + ps);
        const uint32_t b = *reinterpret_cast<const uint32_t*>(row + 2 * ps);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r8 = (r >> (8 * k)) & 255, g8 = (gr >> (8 * k)) & 255,
                    b8 = (b >> (8 * k)) & 255;
          d[k * kSQ] = (uint16_t)(max(max(r8, g8), b8) + min(min(r8, g8), b8));
        }
      } else {
        const uint32_t u =
            *reinterpret_cast<const uint32_t*>(row + (chroma - 1) * ps);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          d[k * kSQ] = (uint16_t)(2 * ((u >> (8 * k)) & 255));
      }
    }
  }

  // The column pass: for each tile row r and strip column, the W taps of
  // rows r-P .. r+P sorted (exact) or reduced to their median (approx),
  // once per tile.
  __device__ __forceinline__ void columns(const uint16_t* sp) const {
    for (int i = tid; i < kRows * kSC; i += kThreads) {
      const int r = i / kSC, q = i - r * kSC;
      const uint16_t* col = sp + r * kSC + q;
      if constexpr (kSort) {
        int v[W];
#pragma unroll
        for (int j = 0; j < W; ++j) v[j] = col[j * kSC];
        column_sort<W>(v);
#pragma unroll
        for (int j = 0; j < W; ++j)
          cols[(r * W + j) * kSC + q] = (uint16_t)v[j];
      } else {
        cols[r * kSC + q] = (uint16_t)line_median<W>(
            [&](int j) { return (int)col[j * kSC]; });
      }
    }
  }

  // This thread's 4 filtered values (the spatial filter in mode M, taps
  // outside the staged section zero or the bands'):
  // * kExact: the exact W x W median of the taps at offsets [-P, P];
  // * kApprox (networks.separable_median): the median across the W column
  //   medians at offsets [-P, P];
  // * kQuirk (networks.quirk_window_select): the rank pick over the taps at
  //   offsets [-P, P) in both axes, then the u8 store-back 2 * rint(phi / 2)
  //   (also at W = 1, where there is no window).
  __device__ __forceinline__ void spatial(const uint16_t* sp,
                                          float (&phi)[kPx]) const {
#pragma unroll
    for (int k = 0; k < kPx; ++k) {
      // the strip / column buffer index of offset d from pixel k
      const auto at = [&](int d) {
        const int e = k + d + 4;
        return (e & 3) * kSQ + lane + (e >> 2);
      };
      if constexpr (M == kQuirk) {
        float v;
        if constexpr (W == 1) {
          v = (float)sp[warp * kSC + at(0)];
        } else {
          v = (float)quirk_select<W>([&](int dx, int dy) {
            return (int)sp[(warp + dy) * kSC + at(dx - P)];
          });
        }
        phi[k] = 2.f * rintf(v * 0.5f);
      } else if constexpr (kColMed) {
        phi[k] = (float)line_median<W>(
            [&](int dx) { return (int)cols[warp * kSC + at(dx - P)]; });
      } else if constexpr (kSort) {
        phi[k] = (float)window_merge<W>([&](int dx, int j) {
          return (int)cols[(warp * W + j) * kSC + at(dx - P)];
        });
      } else {
        phi[k] = (float)sp[warp * kSC + at(0)];
      }
    }
  }

  // Stage, filter and hand to body(g, phi) each of the F frames in order.
  template <class Body>
  __device__ __forceinline__ void run(const MedianArgs& a, const Maps& m,
                                      int F, Body body) const {
    if (tid == 0) {
      for (int i = 0; i < kStages; ++i) mbar_init(bar + i, 1);
      mbar_fence_init();
    }
    __syncthreads();
    if (tid == 0)
      for (int g = 0; g < kStages && g < F; ++g) issue(a, m, g);
    for (int g = 0; g < F; ++g) {
      const int st = g % kStages;
      mbar_wait(bar + st, (uint32_t)(g / kStages) & 1u);
      uint16_t* sp = strip + (g % kStrips) * kStripRows * kSC;
      intensity(base + st * St::kBytes, sp, a.chroma);
      // the strip is whole, and stage st has been read: refill it
      __syncthreads();
      if (tid == 0 && g + kStages < F) issue(a, m, g + kStages);
      if constexpr (kColumns) {
        columns(sp);
        __syncthreads();
      }
      float phi[kPx];
      spatial(sp, phi);
      body(g, phi);
    }
  }
};

// the thread's 4 pixels of a float plane, as one float4
__device__ __forceinline__ void ld4(const float* p, float (&v)[kPx]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void st4(float* p, const float (&v)[kPx]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// The temporal median of each of the thread's 4 pixels over ring slots
// [0, T).  The pixel loop stays rolled: the 16 generated networks hold 604
// min/max, and a copy per pixel made them most of the compiled code (and
// of the build's time); call it from one site per kernel.
template <class Tl>
__device__ __forceinline__ void ring_median(const Tl& t, int T,
                                            float (&cur)[kPx]) {
#pragma unroll 1
  for (int j = 0; j < kPx; ++j) {
    const float m = tmed([&](int k) { return t.slot(k, j); }, T);
#pragma unroll
    for (int i = 0; i < kPx; ++i)
      if (i == j) cur[i] = m;
  }
}

// Emit output frame f of the thread's 4 pixels from their temporal medians
// `cur` and integer diffs `diff`: masked statistic partials, the heatmap
// (+ |diff| * valid), and the maps (a capture frame renders the new
// baseline gray), each plane as one u32.  The partials are summed over the
// 4 pixels in order, then over the warp with shuffles; lane 0 writes the
// warp's partial (no block barrier).
template <class Tl>
__device__ __forceinline__ void emit(const MedianArgs& a, const Tl& t, int f,
                                     const float (&cur)[kPx],
                                     const float (&diff)[kPx], bool capture,
                                     int v, float (&heat)[kPx]) {
  const int C = a.out_mode == 1 ? 3 : (a.out_mode == 2 ? 1 : 0);
  const int y = t.by + t.warp, x0 = t.bx + 4 * t.lane;
  const bool row_in = y >= a.y0 && y < a.y1;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  uint32_t o0 = 0, o1 = 0, o2 = 0;
#pragma unroll
  for (int k = 0; k < kPx; ++k) {
    const int x = x0 + k;
    const float mask = (row_in && x >= a.x0 && x < a.x1) ? 1.f : 0.f;
    const float raw = diff[k] * a.scale;
    const float dm = raw * mask;
    const float am = fabsf(dm);
    heat[k] = heat[k] + am * (float)v;
    s0 += dm;
    s1 += am;
    s2 = fmaxf(s2, am);
    s3 += am >= a.thr ? 1.f : 0.f;
    if (C > 0) {
      uint32_t b0, b1 = 0, b2 = 0;
      if (capture) {
        b0 = b1 = b2 = q8(cur[k] * a.scale);
      } else {
        const float d = emphasize(raw, a);
        if (C == 3) {
          const float sa = fabsf(d);
          const uint32_t hi = q8(0.5f + sa * 0.5f);
          const uint32_t lo = q8(0.5f - sa * 0.5f);
          const bool neg = d < 0.f;
          b0 = neg ? hi : lo;
          b1 = neg ? lo : hi;
          b2 = lo;
        } else {
          b0 = q8(0.5f - d);
        }
      }
      o0 |= b0 << (8 * k);
      o1 |= b1 << (8 * k);
      o2 |= b2 << (8 * k);
    }
  }
  if (C > 0) {
    uint8_t* dst = a.out + (long long)f * C * t.plane + t.pix;
    *reinterpret_cast<uint32_t*>(dst) = o0;
    if (C == 3) {
      *reinterpret_cast<uint32_t*>(dst + t.plane) = o1;
      *reinterpret_cast<uint32_t*>(dst + 2 * t.plane) = o2;
    }
  }
  // fixed-order warp reduction: sum dm, sum |dm|, max |dm|, count
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    s0 += __shfl_down_sync(0xffffffffu, s0, s);
    s1 += __shfl_down_sync(0xffffffffu, s1, s);
    s2 = fmaxf(s2, __shfl_down_sync(0xffffffffu, s2, s));
    s3 += __shfl_down_sync(0xffffffffu, s3, s);
  }
  if (t.lane == 0) {
    float* part = a.parts +
        ((((long long)f * t.S + t.si) * t.ntiles + t.tile) * kWarps + t.warp) *
            4;
    *reinterpret_cast<float4*>(part) = make_float4(s0, s1, s2, s3);
  }
}

// --- host side: tensor maps and the launch ---------------------------------

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

__host__ inline int encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return (int)e;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return (int)cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return 0;
}

// A 4-D u8 map over (planes, S, rows, Wp) (innermost last) with a box of
// kBoxW columns x box_rows rows x 1 section x 3 planes; out-of-bounds
// elements read zero.  TMA's rules: the base 16-byte aligned, Wp a multiple
// of 16 (every stride is), the box's inner extent and its first column
// (bx - kLead) multiples of 16 bytes, the shared destination 128-byte
// aligned.
__host__ inline int encode_u8(EncodeTiled enc, CUtensorMap* map,
                              const void* ptr, int wp, int rows, int s,
                              int planes, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)wp, (cuuint64_t)rows,
                              (cuuint64_t)s, (cuuint64_t)planes};
  const cuuint64_t strides[3] = {(cuuint64_t)wp, (cuuint64_t)rows * wp,
                                 (cuuint64_t)s * rows * wp};
  const cuuint32_t box[4] = {(cuuint32_t)kBoxW, (cuuint32_t)box_rows, 1u, 3u};
  const cuuint32_t estride[4] = {1u, 1u, 1u, 1u};
  return (int)enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
                  const_cast<void*>(ptr), dims, strides, box, estride,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int P, bool kBands>
__host__ inline int make_maps(const MedianArgs& a, Maps* m) {
  std::memset(m, 0, sizeof(Maps));
  EncodeTiled enc;
  int rc = encoder(&enc);
  if (rc == 0)
    rc = encode_u8(enc, &m->mid, a.raw, a.Wp, a.Hp, a.S, 3 * a.F, kRows);
  if constexpr (P > 0) {
    if (rc == 0)
      rc = encode_u8(enc, &m->halo, a.raw, a.Wp, a.Hp, a.S, 3 * a.F, P);
    if constexpr (kBands) {
      if (rc == 0)
        rc = encode_u8(enc, &m->top, a.btop, a.Wp, kBand, a.S, 3 * a.F, P);
      if (rc == 0)
        rc = encode_u8(enc, &m->bot, a.bbot, a.Wp, kBand, a.S, 3 * a.F, P);
    }
  }
  return rc;
}

// Encode the maps and launch K's instance <W, M, kBands> over the tiles of
// every section.  Reports an encode or launch error code.
template <class K, int W, int M, bool kBands>
__host__ inline int go(cudaStream_t s, const MedianArgs& a) {
  Maps m;
  const int rc = make_maps<W / 2, kBands>(a, &m);
  if (rc != 0) return rc;
  const auto kernel = K::template kernel<W, M, kBands>();
  const size_t bytes = Tile<W, M, kBands>::smem_bytes(a.T);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.Wp / kCols, a.Hp / kRows, a.S);
  kernel<<<grid, kThreads, bytes, s>>>(a, m);
  return (int)cudaGetLastError();
}

// Launch instance <W, M> in the band form (a.btop non-null; window 1 has
// no taps to feed and no band instance).  Every instance is compiled;
// mode and band form are template parameters, not branches in the kernel.
template <class K, int W, int M>
__host__ inline int launch_bands(cudaStream_t s, const MedianArgs& a) {
  if (a.btop == nullptr) return go<K, W, M, false>(s, a);
  if constexpr (W > 1) return go<K, W, M, true>(s, a);
  return (int)cudaErrorInvalidValue;
}

// The instances of each window live in a compile unit of their own, so
// that they compile in parallel: the build compiles median_ring.cu and
// median_tail.cu once per window (-DDIPS_WINDOW=W); each unit defines
// instance<W, M>(Ring or Tail, ...) for its window and every mode, and the
// window-1 unit the entry points.
struct Ring {};
struct Tail {};
template <int W, int M>
int instance(Ring, cudaStream_t s, const MedianArgs& a);
template <int W, int M>
int instance(Tail, cudaStream_t s, const MedianArgs& a);

template <class Kind, int W>
__host__ inline int launch_window(int mode, cudaStream_t s,
                                  const MedianArgs& a) {
  switch (mode) {
    case kExact: return instance<W, kExact>(Kind{}, s, a);
    case kApprox: return instance<W, kApprox>(Kind{}, s, a);
    case kQuirk: return instance<W, kQuirk>(Kind{}, s, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launch the instance for the runtime window W (1, 3, 5 or 7) and mode.
template <class Kind>
__host__ inline int launch(int W, int mode, cudaStream_t s,
                           const MedianArgs& a) {
  switch (W) {
    case 1: return launch_window<Kind, 1>(mode, s, a);
    case 3: return launch_window<Kind, 3>(mode, s, a);
    case 5: return launch_window<Kind, 5>(mode, s, a);
    case 7: return launch_window<Kind, 7>(mode, s, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The argument checks shared by both entry points: sections of whole
// 8 x 128 tiles.
__host__ inline bool valid_launch(int S, int B, int Hp, int Wp, int T,
                                  int mode, int out_mode, int chroma) {
  return S >= 1 && S <= 65535 && B >= 1 && Hp >= kRows && Hp % kRows == 0 &&
         Wp >= kCols && Wp % kCols == 0 && T >= 1 && T <= DIPS_MAX_T &&
         mode >= kExact && mode <= kQuirk && out_mode >= 0 && out_mode <= 2 &&
         chroma >= 0 && chroma <= 3;
}

}  // namespace dips_median
