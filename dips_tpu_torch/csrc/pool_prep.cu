// The layout prep of a downscaled engine: the k x k box mean of uint8 hwc
// frames, written as padded planar rows of the engine's raw buffer.
//
// Replaces no Pallas kernel: on the TPU the JAX package's layout prep
// (dips_tpu/ops/reference.py make_layout_prep, downscale=k) is plain jnp
// that XLA fuses into one pass.  The port's plain version
// (dips_tpu_torch/ops/reference.py make_layout_prep) runs as five
// PyTorch kernels with four full-size intermediates (an int32 sum, its
// float32 cast, the rounded float32, the uint8 cast) before its
// permute-copy; this kernel is that chain in one pass, for
// DiPsEngine / MultiStreamEngine(downscale=k) on the card.
//
// Per output pixel (y, x) and channel c of frame n:
//   s = the exact integer sum of the k x k input pixels
//       (y*k + r, x*k + j), r, j < k, of channel c;
//   v = rint(s * float32(1/k^2))   (one IEEE multiply, half to even);
// written as uint8 into plane c of the output (plane 2 - c under the
// hwc_bgr layout's swap), true region only: the padding of the planar
// rows is never written.  Bit-equal to reference.pool_frame_host and to
// the plain prep: the sum is exact, __fmul_rn is the float32 product
// without contraction, rintf rounds half to even.
//
// Input: (N, H*k, W*k, 3) uint8, contiguous, N = S streams x F frames.
// Output: frame (si, f) at out + si*o_stream + f*o_frame, plane c at
// + c*o_chan, row y at + y*o_row, columns contiguous: the single engine's
// (n, 3, Hp, Wp) rows, or the fleet's (F, 3, S*Hp, Wp) input seen as
// (S, F, 3, Hp, Wp), both without a copy.
//
// Bound: device memory.  Per output pixel it reads 3*k^2 bytes and writes
// 3 (4K at k = 2, B = 16: 398.1 MB in, 99.5 MB out, 0.149 ms at 3.35
// TB/s); the operations (k^2 - 1 adds, a multiply and a rounding a
// channel) are far below the INT32 rate.
//
// Design: a block owns one output row of one frame across kTile (or
// fewer, for large k) output columns.  Its k input rows are contiguous
// runs of tile*k*3 bytes each; the block copies them into shared memory
// with 16-byte loads (byte loads where the geometry leaves a run
// unaligned), several in flight a thread, then each thread sums its
// output pixels' k x k taps from shared memory and writes one byte to
// each plane, so that a warp's stores to a plane are 32 adjacent bytes.
// The grid is (column tiles, H, N): 4 x 1080 x 16 blocks of 256 threads
// at 4K, k = 2.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// output columns a block at small k (2 a thread)
constexpr int kTile = 2 * kThreads;
// static shared memory a block may take without an opt-in
constexpr int kSmemBytes = 48 * 1024;
// 16-byte loads a thread keeps in flight
constexpr int kUnroll = 4;

__host__ __device__ constexpr int pitch_of(int tile, int k) {
  return (tile * k * 3 + 15) & ~15;
}

__global__ void __launch_bounds__(kThreads)
pool_prep_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                 int frames, int h, int w, int k, int tile,
                 long long o_stream, long long o_frame, long long o_chan,
                 long long o_row, int swap, float inv) {
  extern __shared__ __align__(16) uint8_t rows[];
  const int x0 = blockIdx.x * tile;
  const int y = blockIdx.y;
  const int n = blockIdx.z;
  const int cols = min(tile, w - x0);
  const int len = cols * k * 3;           // bytes of one input run
  const int pitch = pitch_of(tile, k);
  const long long in_row = (long long)w * k * 3;
  const uint8_t* src = in + (long long)n * h * k * in_row
                       + (long long)y * k * in_row + (long long)x0 * k * 3;

  // the k runs into shared memory: 16-byte words where every run starts
  // on a 16-byte boundary, then the bytes the words leave
  const bool vec = ((reinterpret_cast<uintptr_t>(src) | in_row) & 15) == 0;
  const int nv = vec ? len >> 4 : 0;     // words a run
  const int words = nv * k;
  for (int base = threadIdx.x; base < words; base += kUnroll * kThreads) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      if (i < words) {
        const int r = i / nv, q = i - r * nv;
        v[u] = __ldcs(reinterpret_cast<const uint4*>(src + r * in_row) + q);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      if (i < words) {
        const int r = i / nv, q = i - r * nv;
        reinterpret_cast<uint4*>(rows + r * pitch)[q] = v[u];
      }
    }
  }
  const int rest = len - (nv << 4);       // bytes a run past the words
  for (int i = threadIdx.x; i < rest * k; i += kThreads) {
    const int r = i / rest, q = (nv << 4) + (i - r * rest);
    rows[r * pitch + q] = src[r * in_row + q];
  }
  __syncthreads();

  const int si = n / frames, f = n - si * frames;
  uint8_t* o = out + si * o_stream + f * o_frame + y * o_row + x0;
  uint8_t* plane0 = o + (swap ? 2 : 0) * o_chan;
  uint8_t* plane1 = o + o_chan;
  uint8_t* plane2 = o + (swap ? 0 : 2) * o_chan;
  for (int j = threadIdx.x; j < cols; j += kThreads) {
    int s0 = 0, s1 = 0, s2 = 0;
    for (int r = 0; r < k; ++r) {
      const uint8_t* p = rows + r * pitch + j * k * 3;
      for (int t = 0; t < 3 * k; t += 3) {
        s0 += p[t];
        s1 += p[t + 1];
        s2 += p[t + 2];
      }
    }
    plane0[j] = (uint8_t)(int)rintf(__fmul_rn(__int2float_rn(s0), inv));
    plane1[j] = (uint8_t)(int)rintf(__fmul_rn(__int2float_rn(s1), inv));
    plane2[j] = (uint8_t)(int)rintf(__fmul_rn(__int2float_rn(s2), inv));
  }
}

}  // namespace

// One launch over S x F frames of (H*k, W*k, 3) into the planar rows
// described by the output strides (bytes); inv is float32(1/k^2) as the
// host rounds it.  Returns the launch's CUDA error code (0: launched).
extern "C" int dips_pool_prep(const void* in, void* out, int streams,
                              int frames, int h, int w, int k,
                              long long o_stream, long long o_frame,
                              long long o_chan, long long o_row, int swap,
                              float inv, void* stream) {
  if (streams < 1 || frames < 1 || h < 1 || w < 1 || k < 2 ||
      h > 65535 || (long long)streams * frames > 65535)
    return (int)cudaErrorInvalidValue;
  int tile = kTile;
  while (tile > 32 && k * pitch_of(tile, k) > kSmemBytes) tile /= 2;
  const int smem = k * pitch_of(tile, k);
  if (smem > kSmemBytes) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + tile - 1) / tile, h, streams * frames);
  pool_prep_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), frames,
      h, w, k, tile, o_stream, o_frame, o_chan, o_row, swap, inv);
  return (int)cudaGetLastError();
}

// cudaGetErrorString for the wrappers' messages; weak, as the other
// units', so that a library holds exactly one.
extern "C" __attribute__((weak)) const char* dips_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
