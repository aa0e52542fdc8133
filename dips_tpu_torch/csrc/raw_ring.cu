// Kernels 1 and 3: the raw step (ABSDIFF, THRESHOLD, STATS_ONLY), in its
// ring-carry and its tail-protocol form.
//
// Replaces the Pallas kernel _make_raw_kernel in
// dips_tpu/ops/pallas_fused.py: ring=True (called through absdiff_step_ring
// and absdiff_step_ring_stacked) as raw_step_kernel<false>, ring=False
// (called through absdiff_step and absdiff_step_stacked) as
// raw_step_kernel<true>.
//
// Per pixel and frame, in int32: d = ref - cur per channel.  ABSDIFF writes
// |d| as u8 (byte-equal to cv2.absdiff), THRESHOLD writes 255 where the
// largest channel |d| >= thr, STATS_ONLY writes no map.  OVERALL: ref is the
// u8 baseline, re-captured on a flagged frame.  PER_FRAME: ref is the
// previous frame.  Per frame it also writes per-tile statistic partials
// (signed sum, abs sum, max, changed count; roi-masked) and adds
// sum|d| * (1/765) * valid to the heatmap.
//
// The two protocols differ only where they meet carried state, fixed at
// compile time (no runtime branch in the frame loop):
// * ring: raw is (B, 3, S*Hp, Wp).  PER_FRAME's ref is the carried prev,
//   advanced on valid frames only, and `seed` makes frame 0 diff against
//   itself; capture needs a valid frame too.  prev (PER_FRAME) or the
//   baseline (OVERALL) goes back.
// * tail: raw is (T+B, 3, S*Hp, Wp), the T tail frames first.  The frame
//   loop reads only the B new frames; PER_FRAME's first ref is tail frame
//   T-1.  Capture and advance are not gated on valid.  Only the baseline
//   (OVERALL) goes back; there is no prev.
//
// Streams: S streams are stacked along the rows (JAX's row-stacked layout:
// raw (F, 3, S*Hp, Wp), state (3 | 1, S*Hp, Wp)).  The grid's y dimension
// is the stream, so a statistics tile never straddles two streams and the
// stream index comes from the grid; flags / valid are (S, B) and seed is
// (S,), all int32 on the device.  The roi mask tests the stream-local row.
//
// Row slabs (the dyn_rows form of _make_raw_kernel, for
// parallel/grid2d.py and rowsharded.py): a section may be a horizontal
// slab of a stream.  There is no stencil, so the only difference is the
// mask: Hp is the slab's height and [y0, y1) the roi's rows inside the slab
// (empty when the slab misses the roi), launch arguments like the columns.
//
// Design: one thread owns kBytes consecutive bytes of one row (16 by
// default: uint4 loads and stores, a warp touches 512 contiguous bytes per
// plane) and loops over the batch's frames in order, so the carried state
// (ref and the heatmap) is read from HBM once, kept in registers for the
// whole batch, and written once.  A block of kThreads threads (256 by
// default) is one statistics tile; per-tile sums stay in int32 (a tile's
// abs sum is at most kThreads * kBytes * 765) and are reduced in a fixed
// order with warp shuffles and shared memory (no atomics).  The final
// reduction over tiles runs outside, in plain torch, in int64, so the
// statistics do not depend on the block geometry, a build parameter
// (ops/_build.py passes -D flags for one other than the defaults;
// ops/tuning.py stores measured ones).
//
// Bound: device memory.  Per frame and stream it reads 3*Hp*Wp bytes and
// writes C*Hp*Wp bytes (C = 3, 1 or 0); at 1080p (Hp=1080, Wp=2048) ABSDIFF
// moves 6.6 MB in and 6.6 MB out per frame and does a few integer ops per
// byte.  Stacking S streams multiplies the bytes and the blocks by S and
// changes nothing per byte; the tail form reads one more frame (tail frame
// T-1) per stream in PER_FRAME and none in OVERALL.

#include <cstdint>
#include <cuda_runtime.h>

#ifndef DIPS_RAW_THREADS
#define DIPS_RAW_THREADS 256
#endif
#ifndef DIPS_RAW_BYTES
#define DIPS_RAW_BYTES 16
#endif

namespace {

constexpr int kThreads = DIPS_RAW_THREADS;  // a block: one statistics tile
constexpr int kBytes = DIPS_RAW_BYTES;  // bytes of one row owned by a thread
constexpr int kWords = kBytes / 4;
constexpr int kWarps = kThreads / 32;

static_assert(kThreads % 32 == 0 && kThreads >= 32 && kThreads <= 1024,
              "a block is whole warps, at most 1024 threads");
static_assert(kBytes % 16 == 0 && kBytes <= 32,
              "a thread moves whole uint4s; the roi mask has 32 bits");

__device__ __forceinline__ void load_row(const uint8_t* p,
                                         uint32_t (&w)[kWords]) {
#pragma unroll
  for (int i = 0; i < kWords; i += 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p + 4 * i);
    w[i] = v.x; w[i + 1] = v.y; w[i + 2] = v.z; w[i + 3] = v.w;
  }
}

__device__ __forceinline__ void store_row(uint8_t* p,
                                          const uint32_t (&w)[kWords]) {
#pragma unroll
  for (int i = 0; i < kWords; i += 4)
    *reinterpret_cast<uint4*>(p + 4 * i) =
        make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]);
}

__device__ __forceinline__ int byte_at(const uint32_t (&w)[kWords], int k) {
  return (w[k >> 2] >> ((k & 3) * 8)) & 0xff;
}

// kTail: the tail protocol (raw holds T tail frames first; prev and seeds
// are unused); else the ring-carry protocol.
template <bool kTail>
__global__ void __launch_bounds__(kThreads) raw_step_kernel(
    const uint8_t* __restrict__ raw, uint8_t* __restrict__ prev,
    uint8_t* __restrict__ base, float* __restrict__ heat,
    uint8_t* __restrict__ out, int* __restrict__ parts,
    const int* __restrict__ flags, const int* __restrict__ valid,
    const int* __restrict__ seeds, int B, int T, int Hp, int Wp,
    int overall, int out_mode, int thr, int y0, int x0, int y1, int x1,
    float heat_scale) {
  __shared__ int red[2][kWarps][4];
  const int si = blockIdx.y, S = gridDim.y;
  const long long sec = (long long)Hp * Wp;     // one stream's plane
  const long long plane = sec * S;              // a stacked channel plane
  const long long chunks = sec / kBytes;
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = g < chunks;
  const long long loc = live ? g * kBytes : 0;  // offset in the stream
  const long long off = si * sec + loc;         // offset in the stack
  const int row = (int)(loc / Wp);              // stream-local row
  const int col0 = (int)(loc % Wp);
  const int ntiles = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* fl = flags + (long long)si * B;
  const int* va = valid + (long long)si * B;
  const int seed = kTail ? 0 : seeds[si];
  // the B frames the loop diffs: after the T tail frames in tail mode
  const uint8_t* frames = kTail ? raw + (long long)T * 3 * plane : raw;

  // roi (or whole-plane) mask, one bit per owned byte
  uint32_t mask = 0;
  if (live && row >= y0 && row < y1) {
#pragma unroll
    for (int k = 0; k < kBytes; ++k)
      if (col0 + k >= x0 && col0 + k < x1) mask |= 1u << k;
  }

  // carried state: ref (3 channels x kBytes bytes) and the heatmap
  uint32_t ref[3][kWords] = {};
  float h[kBytes];
#pragma unroll
  for (int k = 0; k < kBytes; ++k) h[k] = 0.f;
  if (live) {
    // PER_FRAME's first ref: the carried prev, or the tail's last frame
    const uint8_t* src =
        overall ? base : (kTail ? raw + (long long)(T - 1) * 3 * plane : prev);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) load_row(src + ch * plane + off, ref[ch]);
#pragma unroll
    for (int k = 0; k < kBytes; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(heat + off + k);
      h[k] = v.x; h[k + 1] = v.y; h[k + 2] = v.z; h[k + 3] = v.w;
    }
  }
  const int C = out_mode == 1 ? 3 : (out_mode == 2 ? 1 : 0);

  for (int f = 0; f < B; ++f) {
    const int v = va[f];
    const float vf = (float)v;
    uint32_t cur[3][kWords] = {};
    if (live) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        load_row(frames + ((long long)f * 3 + ch) * plane + off, cur[ch]);
    }
    if (!kTail && !overall && seed && f == 0) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
#pragma unroll
        for (int i = 0; i < kWords; ++i) ref[ch][i] = cur[ch][i];
    }
    // baseline capture; the ring form skips invalid frames
    if (overall && fl[f] != 0 && (kTail || v != 0)) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
#pragma unroll
        for (int i = 0; i < kWords; ++i) ref[ch][i] = cur[ch][i];
    }

    int s_sg = 0, s_ad = 0, s_mx = 0, s_cnt = 0;
    uint32_t o[3][kWords] = {};
#pragma unroll
    for (int k = 0; k < kBytes; ++k) {
      const int d0 = byte_at(ref[0], k) - byte_at(cur[0], k);
      const int d1 = byte_at(ref[1], k) - byte_at(cur[1], k);
      const int d2 = byte_at(ref[2], k) - byte_at(cur[2], k);
      const int a0 = abs(d0), a1 = abs(d1), a2 = abs(d2);
      const int dmax = max(max(a0, a1), a2);
      const bool in = (mask >> k) & 1u;
      const int asum = in ? a0 + a1 + a2 : 0;
      if (in) {
        s_sg += d0 + d1 + d2;
        s_ad += asum;
        s_mx = max(s_mx, dmax);
        s_cnt += dmax >= thr;
      }
      h[k] = h[k] + ((float)asum * heat_scale) * vf;
      const int sh = (k & 3) * 8;
      if (out_mode == 1) {
        o[0][k >> 2] |= (uint32_t)a0 << sh;
        o[1][k >> 2] |= (uint32_t)a1 << sh;
        o[2][k >> 2] |= (uint32_t)a2 << sh;
      } else if (out_mode == 2) {
        o[0][k >> 2] |= (dmax >= thr ? 255u : 0u) << sh;
      }
    }
    if (!overall && (kTail || v != 0)) {  // advance ref
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
#pragma unroll
        for (int i = 0; i < kWords; ++i) ref[ch][i] = cur[ch][i];
    }
    if (live) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        if (ch < C)
          store_row(out + ((long long)f * C + ch) * plane + off, o[ch]);
    }

    // fixed-order block reduction of the four partials
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      s_sg += __shfl_down_sync(0xffffffffu, s_sg, s);
      s_ad += __shfl_down_sync(0xffffffffu, s_ad, s);
      s_mx = max(s_mx, __shfl_down_sync(0xffffffffu, s_mx, s));
      s_cnt += __shfl_down_sync(0xffffffffu, s_cnt, s);
    }
    int(&r)[kWarps][4] = red[f & 1];
    if (lane == 0) {
      r[warp][0] = s_sg; r[warp][1] = s_ad;
      r[warp][2] = s_mx; r[warp][3] = s_cnt;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int t0 = 0, t1 = 0, t2 = 0, t3 = 0;
      for (int i = 0; i < kWarps; ++i) {
        t0 += r[i][0]; t1 += r[i][1]; t2 = max(t2, r[i][2]); t3 += r[i][3];
      }
      int* p = parts + (((long long)f * S + si) * ntiles + blockIdx.x) * 4;
      p[0] = t0; p[1] = t1; p[2] = t2; p[3] = t3;
    }
    // red[] is double-buffered by frame parity: the next frame writes the
    // other half, and this half is rewritten only after the next frame's
    // barrier, which thread 0 reaches after reading it.
  }

  if (!live) return;
  // carried state out: ref is the baseline (OVERALL) or, in the ring form,
  // the last valid frame (PER_FRAME); the other one passes through
  // untouched
  if (overall || !kTail) {
    uint8_t* dst = overall ? base : prev;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) store_row(dst + ch * plane + off, ref[ch]);
  }
#pragma unroll
  for (int k = 0; k < kBytes; k += 4)
    *reinterpret_cast<float4*>(heat + off + k) =
        make_float4(h[k], h[k + 1], h[k + 2], h[k + 3]);
}

__host__ bool valid_launch(int S, int B, int Hp, int Wp, int out_mode) {
  return S >= 1 && S <= 65535 && B >= 1 && Hp >= 1 && Wp % kBytes == 0 &&
         out_mode >= 0 && out_mode <= 2;
}

__host__ dim3 raw_grid(int S, int Hp, int Wp) {
  const long long chunks = (long long)Hp * Wp / kBytes;
  return dim3((unsigned)((chunks + kThreads - 1) / kThreads), (unsigned)S);
}

}  // namespace

// Hp is one stream's padded height; parts is int32 (B, S, n_tiles, 4).
extern "C" int dips_raw_ring(
    const void* raw, void* prev, void* base, void* heat, void* out,
    void* parts, const void* flags, const void* valid, const void* seeds,
    int S, int B, int Hp, int Wp, int overall, int out_mode, int thr, int y0,
    int x0, int y1, int x1, float heat_scale, void* stream) {
  if (!valid_launch(S, B, Hp, Wp, out_mode))
    return (int)cudaErrorInvalidValue;
  raw_step_kernel<false>
      <<<raw_grid(S, Hp, Wp), kThreads, 0, (cudaStream_t)stream>>>(
          (const uint8_t*)raw, (uint8_t*)prev, (uint8_t*)base, (float*)heat,
          (uint8_t*)out, (int*)parts, (const int*)flags, (const int*)valid,
          (const int*)seeds, B, 0, Hp, Wp, overall, out_mode, thr, y0, x0,
          y1, x1, heat_scale);
  return (int)cudaGetLastError();
}

// raw is (T+B, 3, S*Hp, Wp), the T tail frames first; otherwise as
// dips_raw_ring, without prev and seeds.
extern "C" int dips_raw_tail(
    const void* raw, void* base, void* heat, void* out, void* parts,
    const void* flags, const void* valid, int S, int B, int T, int Hp,
    int Wp, int overall, int out_mode, int thr, int y0, int x0, int y1,
    int x1, float heat_scale, void* stream) {
  if (!valid_launch(S, B, Hp, Wp, out_mode) || T < 1)
    return (int)cudaErrorInvalidValue;
  raw_step_kernel<true>
      <<<raw_grid(S, Hp, Wp), kThreads, 0, (cudaStream_t)stream>>>(
          (const uint8_t*)raw, nullptr, (uint8_t*)base, (float*)heat,
          (uint8_t*)out, (int*)parts, (const int*)flags, (const int*)valid,
          nullptr, B, T, Hp, Wp, overall, out_mode, thr, y0, x0, y1, x1,
          heat_scale);
  return (int)cudaGetLastError();
}

// Statistics tiles per stream (parts is (B, S, dips_raw_tiles(Hp, Wp), 4)).
extern "C" int dips_raw_tiles(int Hp, int Wp) {
  return (int)raw_grid(1, Hp, Wp).x;
}

// cudaGetErrorString for the wrappers' messages; weak, as the median
// units' (median_common.cuh), so that a library holds exactly one.
extern "C" __attribute__((weak)) const char* dips_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
