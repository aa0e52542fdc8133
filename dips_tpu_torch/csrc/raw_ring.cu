// Kernels 1 and 3: the raw step (ABSDIFF, THRESHOLD, STATS_ONLY), in its
// ring-carry and its tail-protocol form, and the reduction of its
// statistic partials.
//
// Replaces the Pallas kernel _make_raw_kernel (dips_tpu/ops/pallas_fused.py
// :1071) and the stats reduction that follows it in the same jitted call
// (_reduce_stats, :1398): ring=True (called through absdiff_step_ring and
// absdiff_step_ring_stacked) as raw_step_kernel<false, C>, ring=False
// (called through absdiff_step and absdiff_step_stacked) as
// raw_step_kernel<true, C>, C the map's channels (an instance per out
// mode, so that each holds in registers only its own map); both followed
// by raw_step_stats_kernel in the same C entry point.
//
// Per pixel and frame: d = ref - cur per channel.  ABSDIFF writes |d| as
// u8 (byte-equal to cv2.absdiff), THRESHOLD writes 255 where the largest
// channel |d| >= thr, STATS_ONLY writes no map.  OVERALL: ref is the u8
// baseline, re-captured on a flagged frame.  PER_FRAME: ref is the previous
// frame.  Per frame it also reduces the roi-masked statistics (signed sum,
// abs sum, max, changed count) and adds sum|d| * (1/765) * valid to the
// heatmap.
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
// is the stream, so a block and its partials never straddle two streams;
// flags / valid are (S, B) and seed is (S,), int32 on the device.  The roi
// mask tests the stream-local row.  Row slabs (the dyn_rows form, for
// parallel/grid2d.py and rowsharded.py): Hp is the slab's height and
// [y0, y1) the roi's rows inside the slab (empty when the slab misses the
// roi), launch arguments like the columns.
//
// Bound: device memory.  Per pixel and frame it must read 3 bytes and
// write C (3, 1 or 0); per pixel and batch it reads and writes the u8 ref
// (3 + 3) and the f32 heatmap (4 + 4).  At B = 16 that is 6.875 bytes a
// pixel-frame in ABSDIFF, 4.875 in THRESHOLD and 3.875 in STATS_ONLY: at
// 1080p (Hp 1080, Wp 2048) and 3.35 TB/s, 0.00454 / 0.00322 / 0.00256 ms
// a frame (chip_smoke.bound()).  The tail form reads tail frame T-1 in
// place of the ref in PER_FRAME and writes no ref back.
//
// Design for Hopper (what it does about the first design's three faults:
// a grid sized to the image with every block running every frame, three
// 16-byte loads a thread in flight behind a block barrier each frame, and
// the stats reduction as six more launches outside):
//
// * The grid is the card, not the image.  The host asks dips_raw_resident
//   for the blocks the card holds at once (SMs x what the occupancy
//   calculator allows, at most kPerSM; one an SM at the default block) and
//   launches that many blocks in all, shared among the S streams (grid y);
//   a stream's Hp*Wp/kBytes chunks (kBytes bytes of one row each) are cut
//   into nb contiguous shares that differ by at most one chunk (piece()),
//   so one wave covers the batch with even work.
//   A block walks its share in `ntiles` tiles of at most kThreads chunks
//   (the same count in every block, the tiles again even), thread i
//   owning chunk i of the tile.  The tile's carried state (ref, heatmap)
//   stays in registers across the batch's frames: read once, written
//   once.
// * Frames are staged ahead by TMA.  The block's work is the sequence of
//   (tile, frame) items; each item is the tile's chunk of the three
//   planes, three 1-D bulk copies (cp.async.bulk, no tensor map: each
//   plane's chunk range is contiguous, and every offset is a multiple of
//   kBytes, so the 16-byte alignment TMA needs holds) into one of kStages
//   shared-memory stages, completing on that stage's `full` mbarrier.
//   One thread of a producer warp, beside the kThreads consumer threads,
//   issues them: it refills a stage as soon as every consumer warp has
//   released it (`empty` mbarrier, one arrive a warp), so up to kStages
//   items are in flight and no consumer's work delays a copy.  A consumer
//   warp orders its reads of a stage before that release with
//   fence.proxy.async: the reads go through the generic proxy and the
//   refill through the async proxy, and without the fence a warp now and
//   then read the stage's next frame.
// * No block barrier per frame.  A warp reads its bytes from the stage,
//   releases it, computes, and writes its maps with streaming stores; its
//   statistics go out as one int32 partial per (frame, stream, block,
//   tile, warp), reduced with the warp's redux instructions.  A partial
//   covers 32 * kBytes pixels (512 by default, 1024 at most); an abs sum
//   is at most pixels x 765, so an int32 partial stays in range up to
//   2.8 M pixels, far above that.
// * The tile reduction runs inside the step: raw_step_stats_kernel, in the
//   same entry point on the same stream, reduces each (frame, stream)'s
//   partials in int64 (exact, so in no particular order), converts each
//   sum to float32 once and scales it by the same float32 factors as
//   cuda_fused.reduce_raw_stats, into the (S, B, 4) stats.  No atomics, no
//   counter shared between launches (server sessions launch from several
//   threads at once).
//
// The arithmetic works on 4 pixels at a time, one u32 a channel: per-byte
// |d| (VABSDIFF4) split into 16-bit lanes, their max across channels by a
// 3-way DPX max, the threshold test as bit 8 of dmax + 256 - thr, the
// heatmap's per-pixel sum|d| as one 3-way add made float by the exact 2^23
// bit trick, the signed sum as the masked byte sums (dp4a) of ref and cur,
// the ref's kept until ref changes.  The heatmap update keeps its order,
// h + ((sum|d| * heat_scale) * valid), and the build -fmad=false: it
// equals the plain twin's bit for bit.  With the arithmetic taken out the
// staging alone runs near the bytes bound on an H100: the arithmetic's
// instructions, not the copies, are what the kernel waits on.
//
// The block geometry is a build parameter (ops/_build.py passes -D flags
// for one other than the defaults; ops/tuning.py stores measured ones):
// kThreads threads a block (the tile's chunks), kBytes bytes a chunk.
// kStages is a constant of the geometry, not a tuning axis.

#include <atomic>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#ifndef DIPS_RAW_THREADS
#define DIPS_RAW_THREADS 256
#endif
#ifndef DIPS_RAW_BYTES
#define DIPS_RAW_BYTES 16
#endif

namespace {

constexpr int kThreads = DIPS_RAW_THREADS;  // a block: one tile's chunks
constexpr int kBytes = DIPS_RAW_BYTES;      // bytes of one row a chunk
constexpr int kWords = kBytes / 4;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = kThreads * kBytes;  // one plane of a tile
constexpr int kStageBytes = 3 * kTileBytes;
// stages: kMaxStages where they fit in 96 KB (two blocks an SM), else as
// many as fit, at least 2
constexpr int kStageBudget = 96 * 1024;
constexpr int kMaxStages = 4;
constexpr int kStages = kStageBudget / kStageBytes >= kMaxStages
                            ? kMaxStages
                        : kStageBudget / kStageBytes >= 2
                            ? kStageBudget / kStageBytes
                            : 2;
constexpr int kBarBytes = 128;  // the mbarriers, ahead of the stages
constexpr int kSmemBytes = kBarBytes + kStages * kStageBytes;
// blocks an SM the grid counts on: what the occupancy calculator allows,
// at most kPerSM (more would only shorten the shares)
constexpr int kPerSM = 4;
// the block: kThreads consumer threads and one producer warp
constexpr int kBlockThreads = kThreads + 32;
// threads of the stats reduction
constexpr int kRedThreads = 1024;

static_assert(kThreads % 32 == 0 && kThreads >= 32 && kThreads <= 992,
              "whole warps, and the producer's warp besides: at most 992");
static_assert(kBytes == 16 || kBytes == 32,
              "a thread moves whole uint4s of one row");
static_assert(2 * kStages * 8 <= kBarBytes, "mbarriers fit their slot");
static_assert(kSmemBytes <= 227 * 1024, "stages fit an H100's block");

// One launch's arguments.  The tail kernel leaves prev and seeds null; raw
// then holds the T tail frames ahead of the B new ones.
struct RawArgs {
  const uint8_t* raw;
  uint8_t* prev;
  uint8_t* base;
  float* heat;
  uint8_t* out;
  int4* parts;
  const int* flags;
  const int* valid;
  const int* seeds;
  int B, T, Hp, Wp, nb, overall, out_mode, thr, y0, x0, y1, x1;
  float heat_scale;
};

// --- mbarriers, bulk copies, streaming stores (PTX) ------------------------

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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
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

// `bytes` contiguous bytes of global memory -> shared dst, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// a map's 16 bytes, evict-first: the card never reads them back
__device__ __forceinline__ void store_stream(uint8_t* p, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "r"(a), "r"(b), "r"(c), "r"(d) : "memory");
}

__device__ __forceinline__ void load_words(const uint8_t* p,
                                           uint32_t (&w)[kWords]) {
#pragma unroll
  for (int i = 0; i < kWords; i += 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p + 4 * i);
    w[i] = v.x; w[i + 1] = v.y; w[i + 2] = v.z; w[i + 3] = v.w;
  }
}

__device__ __forceinline__ void store_words(uint8_t* p,
                                            const uint32_t (&w)[kWords]) {
#pragma unroll
  for (int i = 0; i < kWords; i += 4)
    *reinterpret_cast<uint4*>(p + 4 * i) =
        make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]);
}

__device__ __forceinline__ void stream_words(uint8_t* p,
                                             const uint32_t (&w)[kWords]) {
#pragma unroll
  for (int i = 0; i < kWords; i += 4)
    store_stream(p + 4 * i, w[i], w[i + 1], w[i + 2], w[i + 3]);
}

// 16-bit lane `sel` (0x7610 low, 0x7632 high) of x as a float, exactly:
// the lane's bits under the exponent of 2^23, less 2^23
__device__ __forceinline__ float lane_float(uint32_t x, uint32_t sel) {
  return __int_as_float(__byte_perm(x, 0x4B000000u, sel)) - 8388608.0f;
}

// --- the split of a stream among blocks, and of a share into tiles ---------
//
// A stream's n chunks among nb blocks: block b owns n / nb chunks, one more
// when b < n % nb, from b * (n / nb) + min(b, n % nb); a share of m chunks
// into the ntiles tiles the same way.  ops/_build.RawBlock.split mirrors it.

// Tiles a block walks: as many as the largest share needs (the same in
// every block, so that each (block, tile, warp) has its partial).
__host__ __device__ __forceinline__ int tiles_per_block(int chunks, int nb) {
  const int share = chunks / nb + (chunks % nb != 0);
  return (share + kThreads - 1) / kThreads;
}

// The k-th of `parts` near-equal pieces of [0, n): its first index and size.
__device__ __forceinline__ int piece(int n, int parts, int k, int* size) {
  const int q = n / parts, r = n % parts;
  *size = q + (k < r);
  return k * q + min(k, r);
}

constexpr uint32_t kOnes = 0x01010101u;  // dp4a weights: a byte sum
constexpr uint32_t kEven = 0x00ff00ffu;  // bytes 0 and 2 as 16-bit lanes

// The chunk's byte sum over the pixels in the roi, channels together.
// kMasked: some pixel of the chunk lies outside it (mw: 0xff a pixel in).
template <bool kMasked>
__device__ __forceinline__ uint32_t byte_sum(const uint32_t (&x)[3][kWords],
                                             const uint32_t (&mw)[kWords]) {
  uint32_t s = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      s = __dp4a(kMasked ? x[c][w] & mw[w] : x[c][w], kOnes, s);
  return s;
}

// One item's statistics of the chunk, before the warp reduces them: the
// abs sum and the max in two 16-bit lanes each, the count.
struct Sums {
  uint32_t ad = 0, mx = 0, cnt = 0;
};

// |ref - cur| per byte into a (the ABSDIFF map), the THRESHOLD map's bits
// into hit (0x01 a byte), the roi-masked sums into s, and the heatmap.
// Per 4 pixels a u32: the three channels' |d| (VABSDIFF4) split into
// 16-bit lanes, their max by one 3-way DPX max, the threshold test as bit 8
// of dmax + 256 - thr, the heatmap's per-pixel sum|d| as a 3-way add.
template <bool kMasked>
__device__ __forceinline__ void diff_chunk(
    const uint32_t (&ref)[3][kWords], const uint32_t (&cur)[3][kWords],
    const uint32_t (&mw)[kWords], uint32_t thr_k, float heat_scale,
    int v, float (&h)[kBytes], uint32_t (&a)[3][kWords],
    uint32_t (&hit)[kWords], Sums& s) {
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    uint32_t e[3], o[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a[c][w] = __vabsdiffu4(ref[c][w], cur[c][w]);
      e[c] = a[c][w] & kEven;
      o[c] = (a[c][w] >> 8) & kEven;
    }
    const uint32_t de = __vimax3_u16x2(e[0], e[1], e[2]);
    const uint32_t dod = __vimax3_u16x2(o[0], o[1], o[2]);
    hit[w] = (((de + thr_k) >> 8) & 0x00010001u) |
             ((dod + thr_k) & 0x01000100u);
    uint32_t lo, hi;  // per-pixel masked sum|d| (<= 765), 16-bit lanes
    if (kMasked) {
      const uint32_t me = mw[w] & kEven, mo = (mw[w] >> 8) & kEven;
      s.mx = __vimax3_u16x2(s.mx, de & me, dod & mo);
      s.cnt += __popc(hit[w] & mw[w]);
      lo = (e[0] & me) + (e[1] & me) + (e[2] & me);
      hi = (o[0] & mo) + (o[1] & mo) + (o[2] & mo);
    } else {
      s.mx = __vimax3_u16x2(s.mx, de, dod);
      s.cnt += __popc(hit[w]);
      lo = e[0] + e[1] + e[2];
      hi = o[0] + o[1] + o[2];
    }
    s.ad += lo + hi;  // at most 2 * kWords * 765 a lane
    // pixels 4w .. 4w+3: lo's low lane, hi's low, lo's high, hi's high
    const float q[4] = {lane_float(lo, 0x7610), lane_float(hi, 0x7610),
                        lane_float(lo, 0x7632), lane_float(hi, 0x7632)};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float add = q[k] * heat_scale;
      if (v != 1) add = add * (float)v;  // times 1 is exact: skipped
      h[4 * w + k] = h[4 * w + k] + add;
    }
  }
}

// kTail: the tail protocol (raw holds T tail frames first; prev and seeds
// are unused); else the ring-carry protocol.  kC: the map's channels, 3
// (ABSDIFF), 1 (THRESHOLD) or 0 (no map), so that an instance holds in
// registers only the map it writes.
template <bool kTail, int kC>
__global__ void __launch_bounds__(kBlockThreads)
    raw_step_kernel(const RawArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  uint8_t* stages = smem + kBarBytes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.x, si = blockIdx.y, S = gridDim.y;
  const int B = a.B, Wp = a.Wp, nb = a.nb;
  const int sec = a.Hp * Wp;                   // one stream's plane
  const long long plane = (long long)sec * S;  // a stacked channel plane
  const int chunks = sec / kBytes;
  const int ntiles = tiles_per_block(chunks, nb);
  int share;                                    // this block's chunks
  const int lo = piece(chunks, nb, blk, &share);
  // the B frames the loop diffs (after the T tail frames in tail mode),
  // from this stream's first byte
  const uint8_t* frames =
      (kTail ? a.raw + (long long)a.T * 3 * plane : a.raw) +
      (long long)si * sec;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kWarps) {
    // the producer: item i = (tile i / B, frame i % B) into stage
    // i % kStages, once every warp has released the stage's previous item
    if (lane == 0) {
      int st = 0;
      uint32_t phase = 0;
      for (int t = 0, i = 0; t < ntiles; ++t) {
        int n;
        const int c0 = lo + piece(share, ntiles, t, &n);
        const uint32_t bytes = (uint32_t)n * kBytes;
        const uint8_t* src = frames + (long long)c0 * kBytes;
        for (int f = 0; f < B; ++f, ++i) {
          if (i >= kStages) mbar_wait(empty + st, phase ^ 1u);
          uint8_t* dst = stages + st * kStageBytes;
          mbar_expect_tx(full + st, 3 * bytes);
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            bulk_load(dst + ch * kTileBytes,
                      src + ((long long)f * 3 + ch) * plane, bytes,
                      full + st);
          if (++st == kStages) {
            st = 0;
            phase ^= 1u;
          }
        }
      }
    }
    return;
  }

  const int* fl = a.flags + (long long)si * B;
  const int* va = a.valid + (long long)si * B;
  const int seed = kTail ? 0 : a.seeds[si];
  const uint32_t thr_k = (uint32_t)(256 - a.thr) * 0x00010001u;
  // partial (f, si, blk, t, warp) of (B, S, nb * ntiles * kWarps)
  int4* parts = a.parts +
                ((long long)si * nb + blk) * ntiles * kWarps + warp;
  const long long fstride = (long long)S * nb * ntiles * kWarps;

  // PER_FRAME's first ref: the carried prev, or the tail's last frame
  const uint8_t* ref_src =
      a.overall ? a.base
                : (kTail ? a.raw + (long long)(a.T - 1) * 3 * plane : a.prev);

  int st = 0;
  uint32_t phase = 0;
  for (int t = 0; t < ntiles; ++t) {
    int n;
    const int c0 = lo + piece(share, ntiles, t, &n);
    const bool live = tid < n;
    const int loc = live ? (c0 + tid) * kBytes : 0;  // in the stream
    const long long off = (long long)si * sec + loc;  // in the stack
    const int row = loc / Wp, col0 = loc % Wp;

    // roi (or whole-plane) mask: 0xff per owned byte inside it
    uint32_t mw[kWords];
    bool whole = live;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      mw[w] = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int col = col0 + 4 * w + k;
        const bool in = live && row >= a.y0 && row < a.y1 && col >= a.x0 &&
                        col < a.x1;
        mw[w] |= in ? 0xffu << (8 * k) : 0u;
        whole = whole && in;
      }
    }

    // carried state: ref (3 channels x kBytes bytes, and its masked byte
    // sum) and the heatmap
    uint32_t ref[3][kWords] = {};
    float h[kBytes];
#pragma unroll
    for (int k = 0; k < kBytes; ++k) h[k] = 0.f;
    if (live) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        load_words(ref_src + ch * plane + off, ref[ch]);
#pragma unroll
      for (int k = 0; k < kBytes; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(a.heat + off + k);
        h[k] = v.x; h[k + 1] = v.y; h[k + 2] = v.z; h[k + 3] = v.w;
      }
    }
    uint32_t s_ref = whole ? byte_sum<false>(ref, mw) : byte_sum<true>(ref, mw);

    for (int f = 0; f < B; ++f) {
      mbar_wait(full + st, phase);
      uint32_t cur[3][kWords] = {};
      if (live) {
        const uint8_t* sp = stages + st * kStageBytes + tid * kBytes;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          load_words(sp + ch * kTileBytes, cur[ch]);
      }
      // the stage's bytes are read through the generic proxy and will be
      // rewritten by TMA through the async proxy: order the two before the
      // release (without the fence a warp now and then read the stage's
      // next frame, four items ahead)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);
      if (++st == kStages) {
        st = 0;
        phase ^= 1u;
      }
      const int v = va[f];
      // PER_FRAME's seeded frame 0 diffs against itself; OVERALL captures
      // the baseline (the ring form on valid frames only); PER_FRAME
      // advances after the diff (the ring form on valid frames only)
      const bool capture = (!kTail && !a.overall && seed && f == 0) ||
                           (a.overall && fl[f] != 0 && (kTail || v != 0));
      const bool advance = !a.overall && (kTail || v != 0);
      uint32_t ad[3][kWords], hit[kWords];
      Sums s;
      int sg;
      auto item = [&](auto masked) {
        constexpr bool kM = decltype(masked)::value;
        const uint32_t s_cur = byte_sum<kM>(cur, mw);
        if (capture) {
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
#pragma unroll
            for (int w = 0; w < kWords; ++w) ref[ch][w] = cur[ch][w];
          s_ref = s_cur;
        }
        diff_chunk<kM>(ref, cur, mw, thr_k, a.heat_scale, v, h, ad, hit, s);
        sg = (int)(s_ref - s_cur);
        if (advance) {
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
#pragma unroll
            for (int w = 0; w < kWords; ++w) ref[ch][w] = cur[ch][w];
          s_ref = s_cur;
        }
      };
      if (whole)
        item(std::false_type{});
      else
        item(std::true_type{});
      if (live && kC > 0) {
        uint8_t* dst = a.out + (long long)f * kC * plane + off;
        if (kC == 3) {
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) stream_words(dst + ch * plane, ad[ch]);
        } else {
#pragma unroll
          for (int w = 0; w < kWords; ++w) hit[w] *= 0xffu;
          stream_words(dst, hit);
        }
      }

      // the warp's partial: signed sum, abs sum, max, changed count
      const int wsg = __reduce_add_sync(0xffffffffu, sg);
      const int wad =
          __reduce_add_sync(0xffffffffu, (int)((s.ad & 0xffffu) + (s.ad >> 16)));
      const unsigned wmx =
          __reduce_max_sync(0xffffffffu, max(s.mx & 0xffffu, s.mx >> 16));
      const int wcnt = __reduce_add_sync(0xffffffffu, (int)s.cnt);
      if (lane == 0)
        parts[f * fstride + (long long)t * kWarps] =
            make_int4(wsg, wad, (int)wmx, wcnt);
    }

    if (!live) continue;
    // carried state out: ref is the baseline (OVERALL) or, in the ring
    // form, the last valid frame (PER_FRAME); the other one passes through
    // untouched
    if (a.overall || !kTail) {
      uint8_t* dst = a.overall ? a.base : a.prev;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) store_words(dst + ch * plane + off, ref[ch]);
    }
#pragma unroll
    for (int k = 0; k < kBytes; k += 4)
      *reinterpret_cast<float4*>(a.heat + off + k) =
          make_float4(h[k], h[k + 1], h[k + 2], h[k + 3]);
  }
}

// stats[si][f] from the P partials of (f, si): sums in int64, one float32
// conversion each, scaled as cuda_fused.reduce_raw_stats scales them.
__global__ void __launch_bounds__(kRedThreads) raw_step_stats_kernel(
    const int4* __restrict__ parts, int P, int S, int B,
    float* __restrict__ stats, float sum_scale, float max_scale) {
  __shared__ long long red[kRedThreads / 32][4];
  const int fs = blockIdx.x, f = fs / S, si = fs % S;
  const int4* p = parts + (long long)fs * P;
  long long sg = 0, sa = 0, sc = 0, mx = 0;
#pragma unroll 8
  for (int i = threadIdx.x; i < P; i += kRedThreads) {
    const int4 v = p[i];
    sg += v.x; sa += v.y; mx = max(mx, (long long)v.z); sc += v.w;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sg += __shfl_down_sync(0xffffffffu, sg, o);
    sa += __shfl_down_sync(0xffffffffu, sa, o);
    mx = max(mx, __shfl_down_sync(0xffffffffu, mx, o));
    sc += __shfl_down_sync(0xffffffffu, sc, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[warp][0] = sg; red[warp][1] = sa; red[warp][2] = mx; red[warp][3] = sc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kRedThreads / 32; ++i) {
      sg += red[i][0]; sa += red[i][1]; mx = max(mx, red[i][2]);
      sc += red[i][3];
    }
    float4 r;
    r.x = (float)sg * sum_scale;
    r.y = (float)sa * sum_scale;
    r.z = (float)mx * max_scale;
    r.w = (float)sc;
    *reinterpret_cast<float4*>(stats + ((long long)si * B + f) * 4) = r;
  }
}

// a stream's chunks; 0 when its plane is not below 2^31 bytes
__host__ int stream_chunks(int Hp, int Wp) {
  const long long sec = (long long)Hp * Wp;
  return sec < 0x80000000LL ? (int)(sec / kBytes) : 0;
}

__host__ bool valid_launch(int S, int B, int Hp, int Wp, int nb,
                           int out_mode, int thr) {
  return S >= 1 && S <= 65535 && B >= 1 && Hp >= 1 && Wp >= kBytes &&
         Wp % kBytes == 0 && stream_chunks(Hp, Wp) > 0 && nb >= 1 &&
         nb <= stream_chunks(Hp, Wp) &&
         (long long)tiles_per_block(stream_chunks(Hp, Wp), nb) * B <
             0x80000000LL &&
         (long long)B * S <= 0x7fffffffLL && out_mode >= 0 &&
         out_mode <= 2 && thr >= 1 && thr <= 255;
}

// The instance of a protocol and an out mode (0 no map, 1 ABSDIFF, 2
// THRESHOLD).
template <bool kTail>
__host__ void (*instance(int out_mode))(RawArgs) {
  return out_mode == 1 ? raw_step_kernel<kTail, 3>
         : out_mode == 2 ? raw_step_kernel<kTail, 1>
                         : raw_step_kernel<kTail, 0>;
}

// Once per device: every instance may use kSmemBytes of shared memory.
__host__ int prepare() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit && (done.load() & bit)) return 0;
  for (int mode = 0; mode < 3 && e == cudaSuccess; ++mode) {
    e = cudaFuncSetAttribute((const void*)instance<false>(mode),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute((const void*)instance<true>(mode),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  }
  if (e != cudaSuccess) return (int)e;
  done.fetch_or(bit);
  return 0;
}

template <bool kTail>
__host__ int launch(const RawArgs& a, int S, float* stats, float sum_scale,
                    float max_scale, cudaStream_t stream) {
  int rc = prepare();
  if (rc != 0) return rc;
  RawArgs args = a;
  void* params[] = {&args};
  cudaError_t e = cudaLaunchKernel(
      (const void*)instance<kTail>(a.out_mode),
      dim3((unsigned)a.nb, (unsigned)S), dim3(kBlockThreads), params,
      kSmemBytes, stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int P = a.nb * tiles_per_block(stream_chunks(a.Hp, a.Wp), a.nb) *
                kWarps;
  raw_step_stats_kernel<<<(unsigned)(a.B * S), kRedThreads, 0, stream>>>(
      a.parts, P, S, a.B, stats, sum_scale, max_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Hp is one stream's padded height (or a slab's); nb the blocks a stream
// (dips_raw_resident shared among the S streams, 1 <= nb <= Hp*Wp/kBytes);
// parts is int32 scratch (B, S, dips_raw_parts(Hp, Wp, nb), 4), stats
// float32 (S, B, 4).
extern "C" int dips_raw_ring(
    const void* raw, void* prev, void* base, void* heat, void* out,
    void* parts, void* stats, const void* flags, const void* valid,
    const void* seeds, int S, int B, int Hp, int Wp, int nb, int overall,
    int out_mode, int thr, int y0, int x0, int y1, int x1, float heat_scale,
    float sum_scale, float max_scale, void* stream) {
  if (!valid_launch(S, B, Hp, Wp, nb, out_mode, thr))
    return (int)cudaErrorInvalidValue;
  const RawArgs a{(const uint8_t*)raw, (uint8_t*)prev, (uint8_t*)base,
                  (float*)heat, (uint8_t*)out, (int4*)parts,
                  (const int*)flags, (const int*)valid, (const int*)seeds,
                  B, 0, Hp, Wp, nb, overall, out_mode, thr, y0, x0, y1, x1,
                  heat_scale};
  return launch<false>(a, S, (float*)stats, sum_scale, max_scale,
                       (cudaStream_t)stream);
}

// raw is (T+B, 3, S*Hp, Wp), the T tail frames first; otherwise as
// dips_raw_ring, without prev and seeds.
extern "C" int dips_raw_tail(
    const void* raw, void* base, void* heat, void* out, void* parts,
    void* stats, const void* flags, const void* valid, int S, int B, int T,
    int Hp, int Wp, int nb, int overall, int out_mode, int thr, int y0,
    int x0, int y1, int x1, float heat_scale, float sum_scale,
    float max_scale, void* stream) {
  if (!valid_launch(S, B, Hp, Wp, nb, out_mode, thr) || T < 1)
    return (int)cudaErrorInvalidValue;
  const RawArgs a{(const uint8_t*)raw, nullptr, (uint8_t*)base,
                  (float*)heat, (uint8_t*)out, (int4*)parts,
                  (const int*)flags, (const int*)valid, nullptr,
                  B, T, Hp, Wp, nb, overall, out_mode, thr, y0, x0, y1, x1,
                  heat_scale};
  return launch<true>(a, S, (float*)stats, sum_scale, max_scale,
                      (cudaStream_t)stream);
}

// Blocks the current card holds at once in out mode `out_mode` (its SMs x
// min(kPerSM, what the occupancy calculator allows for either protocol's
// instance)); a CUDA error as its negative code.
extern "C" int dips_raw_resident(int out_mode) {
  if (out_mode < 0 || out_mode > 2) return -(int)cudaErrorInvalidValue;
  int rc = prepare();
  if (rc != 0) return -rc;
  int dev = 0, sms = 0, occ0 = 0, occ1 = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ0, (const void*)instance<false>(out_mode), kBlockThreads,
        kSmemBytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ1, (const void*)instance<true>(out_mode), kBlockThreads,
        kSmemBytes);
  if (e != cudaSuccess) return -(int)e;
  const int per = occ0 < occ1 ? occ0 : occ1;
  return sms * (per < kPerSM ? (per < 1 ? 1 : per) : kPerSM);
}

// Statistic partials per (frame, stream) of a launch with nb blocks a
// stream (ops/_build.RawBlock.parts mirrors it).
extern "C" int dips_raw_parts(int Hp, int Wp, int nb) {
  if (Hp < 1 || Wp < kBytes || Wp % kBytes || nb < 1 ||
      nb > stream_chunks(Hp, Wp))  // 0 chunks: nb > 0 fails too
    return 0;
  return nb * tiles_per_block(stream_chunks(Hp, Wp), nb) * kWarps;
}

// Dynamic shared memory of a block (ops/_build.RawBlock.smem_bytes mirrors
// it).
extern "C" int dips_raw_smem() { return kSmemBytes; }

// cudaGetErrorString for the wrappers' messages; weak, as the median
// units' (median_common.cuh), so that a library holds exactly one.
extern "C" __attribute__((weak)) const char* dips_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
