// framepump: native host runtime for dips_tpu.
//
// The reference's host engine is native (Rust) end to end; here the JAX/XLA
// device path is driven by a thin Python layer, and the per-frame hot host
// work lives in this C++ module:
//
//   * fp_planarize  — fused BGR(A)->RGB swap + HWC->planar transpose + tile
//     padding in ONE pass (replaces cv2.cvtColor + np.moveaxis + pad copy,
//     three passes over the frame).
//   * fp_interleave — fused planar->HWC + RGB->BGR for the encode path.
//   * fp_ring_*     — a bounded single-producer single-consumer frame ring
//     with preallocated slots (the native analogue of the reference's
//     VecDeque frame ring + GStreamer streaming-thread handoff,
//     dips/src/gpu/mod.rs:53, frame_extractor.rs:206-276): the decode
//     thread stages planarized frames without per-frame allocation.
//     Its copies run outside its lock; a large pop copies on the pool.
//   * fp_copy_pieces — a gather copy of (destination, source, bytes)
//     pieces cut into chunks, on a persistent pool of host threads: the
//     engines stage a batch's frames and tail with one call.
//
// Build: make -C dips_tpu/native   (g++ -O3 -shared -fPIC)
// Python binding: ctypes (dips_tpu/native/__init__.py), numpy fallback when
// the .so is absent.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <new>
#include <system_error>
#include <thread>
#include <vector>

#include <unistd.h>

#if defined(__x86_64__) || defined(__i386__)
#define FP_X86 1
#include <immintrin.h>
#endif

// SIMD tier for the layout kernels: 0 scalar, 1 SSSE3 (pshufb, 16 px/iter),
// 2 AVX-512 VBMI (vpermb/vpermt2b, 64 px/iter).  DIPS_TPU_SIMD=
// scalar|ssse3|avx512 caps the tier (read per call: tests flip it at
// runtime; the getenv is noise next to a frame's worth of work).
extern "C" int fp_simd_level() {
#ifdef FP_X86
    int cap = 2;
    const char* env = std::getenv("DIPS_TPU_SIMD");
    if (env && *env) {
        if (std::strcmp(env, "ssse3") == 0) cap = 1;
        else if (std::strcmp(env, "avx512") == 0) cap = 2;
        else cap = 0;  // "scalar" and any unrecognized value pin the
                       // safest tier: an operator typo must not silently
                       // leave the maximum tier running
    }
    int have = 0;
    if (__builtin_cpu_supports("ssse3")) have = 1;
    if (__builtin_cpu_supports("avx512bw") &&
        __builtin_cpu_supports("avx512vbmi")) have = 2;
    return have < cap ? have : cap;
#else
    return 0;
#endif
}

#ifdef FP_X86

// --- SSSE3 row kernels -----------------------------------------------------
//
// The layout transforms are pure byte gathers with stride 3/4, which the
// scalar loops pay for one byte at a time; pshufb does a 16-byte gather per
// instruction.  Each kernel handles 16 pixels per iteration and leaves the
// (w % 16) tail to the scalar path.  Channel-swap (BGR<->RGB) is handled by
// the callers swapping plane POINTERS, so the shuffle masks are fixed.

// 48 interleaved bytes (16 px, stride 3) -> one 16-byte vector per channel.
// Channel c of pixel p lives at byte 3p+c; per 16-byte source vector that
// is the lattice {x : (16k + x) % 3 == c} used in the masks below.
__attribute__((target("ssse3")))
static void fp_deint3_row(const uint8_t* row, int64_t w,
                          uint8_t* p0, uint8_t* p1, uint8_t* p2) {
    const __m128i m00 = _mm_setr_epi8(0, 3, 6, 9, 12, 15, -1, -1, -1, -1,
                                      -1, -1, -1, -1, -1, -1);
    const __m128i m01 = _mm_setr_epi8(-1, -1, -1, -1, -1, -1, 2, 5, 8, 11,
                                      14, -1, -1, -1, -1, -1);
    const __m128i m02 = _mm_setr_epi8(-1, -1, -1, -1, -1, -1, -1, -1, -1,
                                      -1, -1, 1, 4, 7, 10, 13);
    const __m128i m10 = _mm_setr_epi8(1, 4, 7, 10, 13, -1, -1, -1, -1, -1,
                                      -1, -1, -1, -1, -1, -1);
    const __m128i m11 = _mm_setr_epi8(-1, -1, -1, -1, -1, 0, 3, 6, 9, 12,
                                      15, -1, -1, -1, -1, -1);
    const __m128i m12 = _mm_setr_epi8(-1, -1, -1, -1, -1, -1, -1, -1, -1,
                                      -1, -1, 2, 5, 8, 11, 14);
    const __m128i m20 = _mm_setr_epi8(2, 5, 8, 11, 14, -1, -1, -1, -1, -1,
                                      -1, -1, -1, -1, -1, -1);
    const __m128i m21 = _mm_setr_epi8(-1, -1, -1, -1, -1, 1, 4, 7, 10, 13,
                                      -1, -1, -1, -1, -1, -1);
    const __m128i m22 = _mm_setr_epi8(-1, -1, -1, -1, -1, -1, -1, -1, -1,
                                      -1, 0, 3, 6, 9, 12, 15);
    int64_t x = 0;
    for (; x + 16 <= w; x += 16) {
        const uint8_t* s = row + 3 * x;
        const __m128i v0 = _mm_loadu_si128((const __m128i*)(s));
        const __m128i v1 = _mm_loadu_si128((const __m128i*)(s + 16));
        const __m128i v2 = _mm_loadu_si128((const __m128i*)(s + 32));
        _mm_storeu_si128(
            (__m128i*)(p0 + x),
            _mm_or_si128(_mm_or_si128(_mm_shuffle_epi8(v0, m00),
                                      _mm_shuffle_epi8(v1, m01)),
                         _mm_shuffle_epi8(v2, m02)));
        _mm_storeu_si128(
            (__m128i*)(p1 + x),
            _mm_or_si128(_mm_or_si128(_mm_shuffle_epi8(v0, m10),
                                      _mm_shuffle_epi8(v1, m11)),
                         _mm_shuffle_epi8(v2, m12)));
        _mm_storeu_si128(
            (__m128i*)(p2 + x),
            _mm_or_si128(_mm_or_si128(_mm_shuffle_epi8(v0, m20),
                                      _mm_shuffle_epi8(v1, m21)),
                         _mm_shuffle_epi8(v2, m22)));
    }
    for (; x < w; ++x) {
        const uint8_t* px = row + 3 * x;
        p0[x] = px[0];
        p1[x] = px[1];
        p2[x] = px[2];
    }
}

// 64 interleaved bytes (16 px, stride 4) -> one 16-byte vector per channel
// (alpha dropped).  Vector k holds pixels 4k..4k+3; channel c sits at
// bytes c, c+4, c+8, c+12 and lands at output bytes 4k..4k+3.
__attribute__((target("ssse3")))
static void fp_deint4_row(const uint8_t* row, int64_t w,
                          uint8_t* p0, uint8_t* p1, uint8_t* p2) {
    // one-time mask table (same pattern as the AVX-512 kernels): this
    // runs once per ROW, so per-call construction would rebuild 12 masks
    // ~1080 times per 1080p frame
    struct Tbl { alignas(16) int8_t e[3][4][16]; };
    static const Tbl T = [] {
        Tbl t{};
        for (int c = 0; c < 3; ++c)
            for (int k = 0; k < 4; ++k)
                for (int j = 0; j < 16; ++j)
                    t.e[c][k][j] = (j >= 4 * k && j < 4 * k + 4)
                                       ? (int8_t)(c + 4 * (j - 4 * k)) : -1;
        return t;
    }();
    __m128i m[3][4];
    for (int c = 0; c < 3; ++c)
        for (int k = 0; k < 4; ++k)
            m[c][k] = _mm_load_si128((const __m128i*)T.e[c][k]);
    int64_t x = 0;
    for (; x + 16 <= w; x += 16) {
        const uint8_t* s = row + 4 * x;
        __m128i v[4];
        for (int k = 0; k < 4; ++k) {
            v[k] = _mm_loadu_si128((const __m128i*)(s + 16 * k));
        }
        uint8_t* outs[3] = {p0 + x, p1 + x, p2 + x};
        for (int c = 0; c < 3; ++c) {
            __m128i acc = _mm_shuffle_epi8(v[0], m[c][0]);
            for (int k = 1; k < 4; ++k) {
                acc = _mm_or_si128(acc, _mm_shuffle_epi8(v[k], m[c][k]));
            }
            _mm_storeu_si128((__m128i*)outs[c], acc);
        }
    }
    for (; x < w; ++x) {
        const uint8_t* px = row + 4 * x;
        p0[x] = px[0];
        p1[x] = px[1];
        p2[x] = px[2];
    }
}

// Three 16-byte channel vectors -> 48 interleaved bytes (16 px, stride 3):
// the exact inverse lattice of fp_deint3_row.
__attribute__((target("ssse3")))
static void fp_int3_row(const uint8_t* p0, const uint8_t* p1,
                        const uint8_t* p2, int64_t w, uint8_t* row) {
    // one-time mask table — this kernel sits on the per-frame ENCODE
    // path (collect() interleaves every output frame), so per-call
    // construction rebuilt 9 masks per row
    struct Tbl { alignas(16) int8_t e[3][3][16]; };
    static const Tbl T = [] {
        Tbl t{};
        for (int o = 0; o < 3; ++o)
            for (int c = 0; c < 3; ++c)
                for (int j = 0; j < 16; ++j) {
                    const int k = 16 * o + j;  // global interleaved byte
                    t.e[o][c][j] = (k % 3 == c) ? (int8_t)(k / 3) : -1;
                }
        return t;
    }();
    __m128i m[3][3];  // [output vector][source channel]
    for (int o = 0; o < 3; ++o)
        for (int c = 0; c < 3; ++c)
            m[o][c] = _mm_load_si128((const __m128i*)T.e[o][c]);
    int64_t x = 0;
    for (; x + 16 <= w; x += 16) {
        const __m128i r = _mm_loadu_si128((const __m128i*)(p0 + x));
        const __m128i g = _mm_loadu_si128((const __m128i*)(p1 + x));
        const __m128i b = _mm_loadu_si128((const __m128i*)(p2 + x));
        for (int o = 0; o < 3; ++o) {
            const __m128i out = _mm_or_si128(
                _mm_or_si128(_mm_shuffle_epi8(r, m[o][0]),
                             _mm_shuffle_epi8(g, m[o][1])),
                _mm_shuffle_epi8(b, m[o][2]));
            _mm_storeu_si128((__m128i*)(row + 3 * x + 16 * o), out);
        }
    }
    for (; x < w; ++x) {
        row[3 * x] = p0[x];
        row[3 * x + 1] = p1[x];
        row[3 * x + 2] = p2[x];
    }
}

// --- AVX-512 VBMI row kernels ----------------------------------------------
//
// vpermb/vpermt2b are full 64-byte arbitrary shuffles (no 16-byte lanes), so
// each channel of a 64-pixel block is TWO permutes instead of SSSE3's
// 3 shuffles + 2 ors per 16 pixels.  Byte-granular masked loads/stores make
// the (w % 64) remainder the SAME code path - no scalar tail.

// 192 interleaved bytes (64 px, stride 3) -> one 64-byte vector per channel.
// Channel c of pixel p is source byte g = 3p+c, spanning vectors v0..v2:
// vpermt2b covers the v0:v1 window (low 7 bits of g), and lanes whose source
// sits in v2 (g >= 128) are patched with one merge-masked vpermb.
__attribute__((target("avx512f,avx512bw,avx512vbmi")))
static void fp_deint3_row_avx512(const uint8_t* row, int64_t w,
                                 uint8_t* p0, uint8_t* p1, uint8_t* p2) {
    struct Tbl { int8_t lo[3][64]; int8_t hi[3][64]; uint64_t patch[3]; };
    static const Tbl T = [] {
        Tbl t{};
        for (int c = 0; c < 3; ++c) {
            uint64_t m = 0;
            for (int p = 0; p < 64; ++p) {
                const int g = 3 * p + c;
                t.lo[c][p] = (int8_t)g;          // vpermt2b reads low 7 bits
                t.hi[c][p] = (int8_t)(g - 128);  // index into v2
                if (g >= 128) m |= 1ull << p;
            }
            t.patch[c] = m;
        }
        return t;
    }();
    const __m512i lo0 = _mm512_loadu_si512(T.lo[0]);
    const __m512i lo1 = _mm512_loadu_si512(T.lo[1]);
    const __m512i lo2 = _mm512_loadu_si512(T.lo[2]);
    const __m512i hi0 = _mm512_loadu_si512(T.hi[0]);
    const __m512i hi1 = _mm512_loadu_si512(T.hi[1]);
    const __m512i hi2 = _mm512_loadu_si512(T.hi[2]);
    for (int64_t x = 0; x < w; x += 64) {
        const int64_t rem = w - x;
        const uint8_t* s = row + 3 * x;
        __m512i v0, v1, v2;
        __mmask64 kout;
        if (rem >= 64) {
            v0 = _mm512_loadu_si512(s);
            v1 = _mm512_loadu_si512(s + 64);
            v2 = _mm512_loadu_si512(s + 128);
            kout = ~0ull;
        } else {
            const int64_t nb = 3 * rem;  // 3..189 source bytes
            v0 = _mm512_maskz_loadu_epi8(
                nb >= 64 ? ~0ull : ((1ull << nb) - 1), s);
            v1 = nb > 64 ? _mm512_maskz_loadu_epi8(
                nb >= 128 ? ~0ull : ((1ull << (nb - 64)) - 1), s + 64)
                         : _mm512_setzero_si512();
            v2 = nb > 128 ? _mm512_maskz_loadu_epi8(
                (1ull << (nb - 128)) - 1, s + 128)
                          : _mm512_setzero_si512();
            kout = (1ull << rem) - 1;
        }
        __m512i t0 = _mm512_permutex2var_epi8(v0, lo0, v1);
        t0 = _mm512_mask_permutexvar_epi8(t0, T.patch[0], hi0, v2);
        _mm512_mask_storeu_epi8(p0 + x, kout, t0);
        __m512i t1 = _mm512_permutex2var_epi8(v0, lo1, v1);
        t1 = _mm512_mask_permutexvar_epi8(t1, T.patch[1], hi1, v2);
        _mm512_mask_storeu_epi8(p1 + x, kout, t1);
        __m512i t2 = _mm512_permutex2var_epi8(v0, lo2, v1);
        t2 = _mm512_mask_permutexvar_epi8(t2, T.patch[2], hi2, v2);
        _mm512_mask_storeu_epi8(p2 + x, kout, t2);
    }
}

// 256 interleaved bytes (64 px, stride 4, alpha dropped) -> one 64-byte
// vector per channel.  g = 4p+c: pixels 0..31 live in v0:v1 and 32..63 in
// v2:v3 at the SAME low-7-bit offsets (g mod 128 = 4(p-32)+c), so one index
// vector drives both vpermt2b halves; a fixed-mask blend picks per pixel.
__attribute__((target("avx512f,avx512bw,avx512vbmi")))
static void fp_deint4_row_avx512(const uint8_t* row, int64_t w,
                                 uint8_t* p0, uint8_t* p1, uint8_t* p2) {
    struct Tbl { int8_t idx[3][64]; };
    static const Tbl T = [] {
        Tbl t{};
        for (int c = 0; c < 3; ++c) {
            for (int p = 0; p < 64; ++p) {
                t.idx[c][p] = (int8_t)(4 * p + c);
            }
        }
        return t;
    }();
    const __m512i i0 = _mm512_loadu_si512(T.idx[0]);
    const __m512i i1 = _mm512_loadu_si512(T.idx[1]);
    const __m512i i2 = _mm512_loadu_si512(T.idx[2]);
    const __mmask64 khi = 0xFFFFFFFF00000000ull;  // pixels 32..63
    for (int64_t x = 0; x < w; x += 64) {
        const int64_t rem = w - x;
        const uint8_t* s = row + 4 * x;
        __m512i v[4];
        __mmask64 kout;
        if (rem >= 64) {
            for (int k = 0; k < 4; ++k) {
                v[k] = _mm512_loadu_si512(s + 64 * k);
            }
            kout = ~0ull;
        } else {
            int64_t nb = 4 * rem;  // 4..252 source bytes
            for (int k = 0; k < 4; ++k, nb -= 64) {
                v[k] = nb <= 0 ? _mm512_setzero_si512()
                     : _mm512_maskz_loadu_epi8(
                           nb >= 64 ? ~0ull : ((1ull << nb) - 1),
                           s + 64 * k);
            }
            kout = (1ull << rem) - 1;
        }
        uint8_t* outs[3] = {p0 + x, p1 + x, p2 + x};
        const __m512i idxs[3] = {i0, i1, i2};
        for (int c = 0; c < 3; ++c) {
            const __m512i a = _mm512_permutex2var_epi8(v[0], idxs[c], v[1]);
            const __m512i b = _mm512_permutex2var_epi8(v[2], idxs[c], v[3]);
            _mm512_mask_storeu_epi8(outs[c], kout,
                                    _mm512_mask_blend_epi8(khi, a, b));
        }
    }
}

// Three 64-byte channel vectors -> 192 interleaved bytes (64 px, stride 3):
// output vector o byte j is global byte k = 64o+j = pixel k/3, channel k%3.
// vpermt2b interleaves channels 0 and 1; channel-2 bytes are patched with
// one merge-masked vpermb.
__attribute__((target("avx512f,avx512bw,avx512vbmi")))
static void fp_int3_row_avx512(const uint8_t* p0, const uint8_t* p1,
                               const uint8_t* p2, int64_t w, uint8_t* row) {
    struct Tbl { int8_t rg[3][64]; int8_t b[3][64]; uint64_t patch[3]; };
    static const Tbl T = [] {
        Tbl t{};
        for (int o = 0; o < 3; ++o) {
            uint64_t m = 0;
            for (int j = 0; j < 64; ++j) {
                const int k = 64 * o + j;
                const int c = k % 3, q = k / 3;
                t.rg[o][j] = (int8_t)(c == 0 ? q : c == 1 ? 64 + q : 0);
                t.b[o][j] = (int8_t)q;
                if (c == 2) m |= 1ull << j;
            }
            t.patch[o] = m;
        }
        return t;
    }();
    const __m512i rg0 = _mm512_loadu_si512(T.rg[0]);
    const __m512i rg1 = _mm512_loadu_si512(T.rg[1]);
    const __m512i rg2 = _mm512_loadu_si512(T.rg[2]);
    const __m512i b0 = _mm512_loadu_si512(T.b[0]);
    const __m512i b1 = _mm512_loadu_si512(T.b[1]);
    const __m512i b2 = _mm512_loadu_si512(T.b[2]);
    for (int64_t x = 0; x < w; x += 64) {
        const int64_t rem = w - x;
        __m512i r, g, b;
        __mmask64 k0, k1, k2;  // byte masks for the three output stores
        if (rem >= 64) {
            r = _mm512_loadu_si512(p0 + x);
            g = _mm512_loadu_si512(p1 + x);
            b = _mm512_loadu_si512(p2 + x);
            k0 = k1 = k2 = ~0ull;
        } else {
            const __mmask64 kin = (1ull << rem) - 1;
            r = _mm512_maskz_loadu_epi8(kin, p0 + x);
            g = _mm512_maskz_loadu_epi8(kin, p1 + x);
            b = _mm512_maskz_loadu_epi8(kin, p2 + x);
            const int64_t nb = 3 * rem;  // 3..189 output bytes
            k0 = nb >= 64 ? ~0ull : ((1ull << nb) - 1);
            k1 = nb <= 64 ? 0 : (nb >= 128 ? ~0ull : ((1ull << (nb - 64)) - 1));
            k2 = nb <= 128 ? 0 : ((1ull << (nb - 128)) - 1);
        }
        uint8_t* d = row + 3 * x;
        __m512i t0 = _mm512_permutex2var_epi8(r, rg0, g);
        t0 = _mm512_mask_permutexvar_epi8(t0, T.patch[0], b0, b);
        _mm512_mask_storeu_epi8(d, k0, t0);
        __m512i t1 = _mm512_permutex2var_epi8(r, rg1, g);
        t1 = _mm512_mask_permutexvar_epi8(t1, T.patch[1], b1, b);
        _mm512_mask_storeu_epi8(d + 64, k1, t1);
        __m512i t2 = _mm512_permutex2var_epi8(r, rg2, g);
        t2 = _mm512_mask_permutexvar_epi8(t2, T.patch[2], b2, b);
        _mm512_mask_storeu_epi8(d + 128, k2, t2);
    }
}
#endif  // FP_X86

extern "C" {

// HWC uint8 (h, w, c_in) -> planar uint8 (3, hp, wp), zero-padded.
// swap_rb: treat input as BGR(A) and emit RGB planes (cv2 decode path).
// c_in: 3 or 4 (RGBA dumps have a stride of 4).
void fp_planarize(const uint8_t* src, int64_t h, int64_t w, int64_t c_in,
                  int64_t row_stride, uint8_t* dst, int64_t hp, int64_t wp,
                  int swap_rb) {
    const int64_t plane = hp * wp;
    // zero ONLY the padding (right dead zone per row + bottom rows): a
    // whole-destination memset rewrote ~6 MB/frame at 1080p to clear
    // ~46 KB of actual pad in the decode hot path
    if (wp > w || hp > h) {
        for (int64_t ch = 0; ch < 3; ++ch) {
            uint8_t* pl = dst + ch * plane;
            if (wp > w) {
                for (int64_t y = 0; y < h; ++y) {
                    std::memset(pl + y * wp + w, 0, wp - w);
                }
            }
            if (hp > h) {
                std::memset(pl + h * wp, 0, (hp - h) * wp);
            }
        }
    }
    const int r_off = swap_rb ? 2 : 0;
    const int b_off = swap_rb ? 0 : 2;
#ifdef FP_X86
    const int lvl = fp_simd_level();
    if (lvl >= 1 && (c_in == 3 || c_in == 4)) {
        // the kernels gather source channels 0/1/2 in order; channel swap
        // is a destination-plane swap
        for (int64_t y = 0; y < h; ++y) {
            const uint8_t* row = src + y * row_stride;
            uint8_t* p0 = dst + (swap_rb ? 2 * plane : 0) + y * wp;
            uint8_t* p1 = dst + plane + y * wp;
            uint8_t* p2 = dst + (swap_rb ? 0 : 2 * plane) + y * wp;
            if (lvl >= 2) {
                c_in == 3 ? fp_deint3_row_avx512(row, w, p0, p1, p2)
                          : fp_deint4_row_avx512(row, w, p0, p1, p2);
            } else {
                c_in == 3 ? fp_deint3_row(row, w, p0, p1, p2)
                          : fp_deint4_row(row, w, p0, p1, p2);
            }
        }
        return;
    }
#endif
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t* row = src + y * row_stride;
        uint8_t* pr = dst + y * wp;
        uint8_t* pg = dst + plane + y * wp;
        uint8_t* pb = dst + 2 * plane + y * wp;
        for (int64_t x = 0; x < w; ++x) {
            const uint8_t* px = row + x * c_in;
            pr[x] = px[r_off];
            pg[x] = px[1];
            pb[x] = px[b_off];
        }
    }
}

// planar uint8 (c, hp, wp) -> HWC uint8 (h, w, 3), cropping padding.
// swap_rb: emit BGR (for cv2 encode). c == 1 broadcasts gray to 3 channels.
void fp_interleave(const uint8_t* src, int64_t c, int64_t hp, int64_t wp,
                   int64_t h, int64_t w, uint8_t* dst, int swap_rb) {
    const int64_t plane = hp * wp;
    const uint8_t* sr = src;
    const uint8_t* sg = (c >= 2) ? src + plane : src;
    const uint8_t* sb = (c >= 3) ? src + 2 * plane : src;
    const int o0 = swap_rb ? 2 : 0;
    const int o2 = swap_rb ? 0 : 2;
#ifdef FP_X86
    const int lvl = fp_simd_level();
    if (lvl >= 1) {
        // the kernel emits (ch0, ch1, ch2) per pixel; channel swap is a
        // source-plane swap (gray broadcast: all three sources coincide)
        const uint8_t* s0 = swap_rb ? sb : sr;
        const uint8_t* s2 = swap_rb ? sr : sb;
        for (int64_t y = 0; y < h; ++y) {
            if (lvl >= 2) {
                fp_int3_row_avx512(s0 + y * wp, sg + y * wp, s2 + y * wp,
                                   w, dst + y * w * 3);
            } else {
                fp_int3_row(s0 + y * wp, sg + y * wp, s2 + y * wp, w,
                            dst + y * w * 3);
            }
        }
        return;
    }
#endif
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t* r = sr + y * wp;
        const uint8_t* g = sg + y * wp;
        const uint8_t* b = sb + y * wp;
        uint8_t* row = dst + y * w * 3;
        for (int64_t x = 0; x < w; ++x) {
            row[x * 3 + o0] = r[x];
            row[x * 3 + 1] = g[x];
            row[x * 3 + o2] = b[x];
        }
    }
}

// ---------------------------------------------------------------------------
// SPSC bounded frame ring with preallocated fixed-size slots.
// ---------------------------------------------------------------------------
//
// The mutex guards the cursors, never a copy: a push takes the tail slot,
// copies into it unlocked and then publishes it (tail++); a pop takes the
// head slot, copies out of it unlocked and then releases it (head++).  So
// the producer's copy and the consumer's run at the same time, and a slot
// is neither read before it is published nor overwritten before it is
// released.  A push in flight when the ring closes still publishes its
// frame, and no pop reports the end before it has.

int fp_copy_pieces(uint8_t* const* dst, const uint8_t* const* src,
                   const int64_t* nbytes, int64_t n, int64_t chunk,
                   int threads);

struct FpRing {
    uint8_t* buf = nullptr;
    int64_t slot_bytes = 0;
    int64_t slots = 0;
    std::atomic<int64_t> head{0};  // next slot to pop
    std::atomic<int64_t> tail{0};  // next slot to push
    std::atomic<bool> closed{false};
    bool writing = false;          // under mu: a push copies into its slot
    std::mutex mu;
    std::condition_variable cv_push, cv_pop;
};

void* fp_ring_create(int64_t slots, int64_t slot_bytes) {
    auto* r = new (std::nothrow) FpRing();
    if (!r) return nullptr;
    r->buf = new (std::nothrow) uint8_t[slots * slot_bytes];
    if (!r->buf) { delete r; return nullptr; }
    r->slots = slots;
    r->slot_bytes = slot_bytes;
    return r;
}

void fp_ring_destroy(void* ring) {
    auto* r = static_cast<FpRing*>(ring);
    delete[] r->buf;
    delete r;
}

// Blocking push; returns 0 on success, -1 if the ring was closed.
int fp_ring_push(void* ring, const uint8_t* data, int64_t n) {
    auto* r = static_cast<FpRing*>(ring);
    std::unique_lock<std::mutex> lk(r->mu);
    r->cv_push.wait(lk, [&] {
        return r->closed.load() ||
               (r->tail.load() - r->head.load()) < r->slots;
    });
    if (r->closed.load()) return -1;
    const int64_t slot = r->tail.load() % r->slots;
    const int64_t m = n < r->slot_bytes ? n : r->slot_bytes;
    r->writing = true;
    lk.unlock();
    std::memcpy(r->buf + slot * r->slot_bytes, data, m);
    lk.lock();
    r->writing = false;
    r->tail.fetch_add(1);
    r->cv_pop.notify_one();
    return 0;
}

// Blocking pop with timeout, copied on `threads` copiers of the pool
// (fp_copy_pieces, `chunk`-byte chunks) when threads > 1, else on the
// calling thread; returns 0 on success, -1 closed+empty, -2 timeout.
int fp_ring_pop_pooled(void* ring, uint8_t* out, int64_t n,
                       int64_t timeout_ms, int64_t chunk, int threads) {
    auto* r = static_cast<FpRing*>(ring);
    std::unique_lock<std::mutex> lk(r->mu);
    const bool ok = r->cv_pop.wait_for(
        lk, std::chrono::milliseconds(timeout_ms), [&] {
            return r->tail.load() > r->head.load() ||
                   (r->closed.load() && !r->writing);
        });
    if (!ok) return -2;
    if (r->tail.load() == r->head.load()) return -1;  // closed and drained
    const int64_t slot = r->head.load() % r->slots;
    const int64_t m = n < r->slot_bytes ? n : r->slot_bytes;
    lk.unlock();
    const uint8_t* src = r->buf + slot * r->slot_bytes;
    if (threads > 1)
        fp_copy_pieces(&out, &src, &m, 1, chunk, threads);
    else
        std::memcpy(out, src, m);
    lk.lock();
    r->head.fetch_add(1);
    r->cv_push.notify_one();
    return 0;
}

// Close the ring: producers stop, consumers drain then get -1.
void fp_ring_close(void* ring) {
    auto* r = static_cast<FpRing*>(ring);
    std::lock_guard<std::mutex> lk(r->mu);
    r->closed.store(true);
    r->cv_push.notify_all();
    r->cv_pop.notify_all();
}

int64_t fp_ring_size(void* ring) {
    auto* r = static_cast<FpRing*>(ring);
    return r->tail.load() - r->head.load();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Gather copy on a persistent pool of host threads.
// ---------------------------------------------------------------------------
//
// fp_copy_pieces copies n (dst, src, bytes) pieces, each cut into chunks of
// at most `chunk` bytes, on the caller's thread and the pool's workers:
// each thread claims the next chunk from one atomic counter.  The pool is
// built at the first call, with threads - 1 workers parked on a condition
// variable between calls, and never torn down.  The caller always copies
// too, so a job finishes even before a worker wakes.  A pool belongs to the
// process that built it: a child after fork() inherits none of its threads
// (and perhaps a locked mutex), so it builds its own and leaves the
// parent's untouched.

namespace {

struct CopyJob {
    uint8_t* const* dst;
    const uint8_t* const* src;
    const int64_t* nbytes;
    int64_t n;
    int64_t chunk;
    std::vector<int64_t> first;  // first[i]: piece i's first chunk; first[n]: all
    std::atomic<int64_t> next{0};
};

void copy_chunks(CopyJob* job) {
    const int64_t total = job->first[job->n];
    int64_t piece = 0;
    for (;;) {
        const int64_t c = job->next.fetch_add(1);
        if (c >= total) return;
        // a thread's chunks come in increasing order: the piece only advances
        while (job->first[piece + 1] <= c) ++piece;
        const int64_t off = (c - job->first[piece]) * job->chunk;
        const int64_t len = std::min(job->chunk, job->nbytes[piece] - off);
        std::memcpy(job->dst[piece] + off, job->src[piece] + off, len);
    }
}

struct CopyPool {
    pid_t pid = 0;
    std::atomic<int> threads{1};  // copiers, the caller included
    std::mutex submit;            // one job at a time
    std::mutex mu;
    std::condition_variable cv_work, cv_done;
    CopyJob* job = nullptr;       // under mu
    uint64_t gen = 0;             // under mu: bumped for each job
    int active = 0;               // under mu: workers inside the job
};

void copy_worker(CopyPool* p) {
    uint64_t seen = 0;
    std::unique_lock<std::mutex> lk(p->mu);
    for (;;) {
        p->cv_work.wait(lk, [&] { return p->gen != seen; });
        seen = p->gen;
        CopyJob* job = p->job;
        if (!job) continue;  // woke after the caller had finished it
        ++p->active;
        lk.unlock();
        copy_chunks(job);
        lk.lock();
        if (--p->active == 0) p->cv_done.notify_all();
    }
}

std::atomic<CopyPool*> g_copy_pool{nullptr};

CopyPool* copy_pool(int threads) {
    const pid_t pid = getpid();
    CopyPool* p = g_copy_pool.load();
    if (p && p->pid == pid) return p;
    auto* fresh = new CopyPool();
    fresh->pid = pid;
    // a forked child's old pool is left as it is (its threads are gone)
    if (!g_copy_pool.compare_exchange_strong(p, fresh)) {
        delete fresh;  // another thread built this process's pool first
        return p;
    }
    for (int i = 1; i < threads; ++i) {
        try {
            std::thread(copy_worker, fresh).detach();
        } catch (const std::system_error&) {
            break;  // fewer workers: the caller copies what they do not
        }
        fresh->threads.fetch_add(1);
    }
    return fresh;
}

}  // namespace

// Copy every piece; returns the copiers the pool has (the caller
// included), 0 when n <= 0.  Pieces must not overlap.
extern "C" int fp_copy_pieces(uint8_t* const* dst,
                              const uint8_t* const* src,
                              const int64_t* nbytes, int64_t n,
                              int64_t chunk, int threads) {
    if (n <= 0) return 0;
    if (chunk < 1) chunk = 1;
    CopyJob job;
    job.dst = dst;
    job.src = src;
    job.nbytes = nbytes;
    job.n = n;
    job.chunk = chunk;
    job.first.resize(n + 1);
    job.first[0] = 0;
    for (int64_t i = 0; i < n; ++i)
        job.first[i + 1] = job.first[i] + (nbytes[i] + chunk - 1) / chunk;
    CopyPool* p = copy_pool(threads);
    std::lock_guard<std::mutex> one(p->submit);
    {
        std::lock_guard<std::mutex> lk(p->mu);
        p->job = &job;
        ++p->gen;
    }
    p->cv_work.notify_all();
    copy_chunks(&job);
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_done.wait(lk, [&] { return p->active == 0; });
    p->job = nullptr;
    return p->threads.load();
}
