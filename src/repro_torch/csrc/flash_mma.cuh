// Helpers shared by the flash attention kernels (flash_attention_fwd.cu and
// flash_attention_bwd.cu), whose fragments, mma and staging the SSD
// intra-chunk kernel (ssd_intra.cu) also takes: the TF32 operand bits and
// their 3xTF32 split, mma.sync.m16n8k8 with its fragments in the permuted
// orders both flash kernels use, cp.async staging of model-layout rows into
// shared rows of stride 4 mod 8 words, the masks, and the shared row layout.
// Each kernel's Params (any struct with the fields the templates read) is its
// own.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kStrip = 16;     // rows of a strip: the m16 of mma.m16n8k8
constexpr int kMaxWidth = 10;  // chunks of 8 columns a warp's accumulators cover (D <= 80)
constexpr int kOverrun = 64;   // elements read past the last staged row, at most 56
constexpr int kMaxD = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The 32-bit patterns an mma TF32 operand register holds: an f32 (bf16 widened
// exactly by 16 zero bits).  One value, or two adjacent ones in one load.
__device__ __forceinline__ uint32_t bits(const float* p) { return __float_as_uint(*p); }
__device__ __forceinline__ uint32_t bits(const __nv_bfloat16* p) {
  return (uint32_t)(*reinterpret_cast<const unsigned short*>(p)) << 16;
}
__device__ __forceinline__ void bits2(const float* p, uint32_t& lo, uint32_t& hi) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  lo = __float_as_uint(x.x);
  hi = __float_as_uint(x.y);
}
__device__ __forceinline__ void bits2(const __nv_bfloat16* p, uint32_t& lo, uint32_t& hi) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  lo = w << 16;
  hi = w & 0xffff0000u;
}

// ---------------------------------------------------------------------------
// 3xTF32 on mma.sync.m16n8k8 (mma3, which weighs the split terms, is each
// kernel's own)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32 (round to nearest, ties away, as the tests emulate)
__device__ __forceinline__ void split(uint32_t x, uint32_t& big, uint32_t& small) {
  big = to_tf32(__uint_as_float(x));
  small = to_tf32(__uint_as_float(x) - __uint_as_float(big));
}

// c += a.b on a 16x8 tile, k = 8.  Fragments (g = lane / 4, t = lane % 4):
// a[0] (g, t), a[1] (g + 8, t), a[2] (g, t + 4), a[3] (g + 8, t + 4);
// b[0] (k = t, n = g), b[1] (k = t + 4, n = g);
// c[0] (g, 2t), c[1] (g, 2t + 1), c[2] (g + 8, 2t), c[3] (g + 8, 2t + 1).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An operand fragment of N registers and, where it is split, its remainder.
template <int N>
struct Frag {
  uint32_t big[N];
  uint32_t small[N];
};

template <bool kSplit, int N>
__device__ __forceinline__ void prepare(Frag<N>& f) {
  if (kSplit) {
#pragma unroll
    for (int i = 0; i < N; ++i) split(f.big[i], f.big[i], f.small[i]);
  }
}

// Fragments of S = X.Y^T in the permuted d order (k = t -> column 2t, k = t + 4
// -> column 2t + 1): A from X rows r, r + 8, B from Y row `row`, both at
// columns c, c + 1 with c = 8 * chunk + 2t.
template <typename T>
__device__ __forceinline__ Frag<4> load_a(const T* s, int kse, int r, int c) {
  Frag<4> f;
  bits2(s + r * kse + c, f.big[0], f.big[2]);
  bits2(s + (r + 8) * kse + c, f.big[1], f.big[3]);
  return f;
}

template <typename T>
__device__ __forceinline__ Frag<2> load_bt(const T* s, int kse, int row, int c) {
  Frag<2> f;
  bits2(s + row * kse + c, f.big[0], f.big[1]);
  return f;
}

// B fragment of O += A.Y in the permuted k order: Y rows `row` = 8n + 2t and
// row + 1, column col.
template <typename T>
__device__ __forceinline__ Frag<2> load_bn(const T* s, int kse, int row, int col) {
  Frag<2> f;
  f.big[0] = bits(s + row * kse + col);
  f.big[1] = bits(s + (row + 1) * kse + col);
  return f;
}

// The A fragment of an accumulator tile (c0..c3 of the accumulator layout;
// f32, so always split), in the permuted k order.
__device__ __forceinline__ Frag<4> acc_as_a(float c0, float c1, float c2, float c3) {
  Frag<4> f;
  f.big[0] = __float_as_uint(c0);
  f.big[1] = __float_as_uint(c2);
  f.big[2] = __float_as_uint(c1);
  f.big[3] = __float_as_uint(c3);
  prepare<true>(f);
  return f;
}

// ---------------------------------------------------------------------------
// Asynchronous staging
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Stage rows [r0, r0 + n) of a (rows, D) matrix of the model layout into
// shared rows of stride kse elements: columns past D (up to dp) and rows past
// `limit` are zeros.  Copies of `vec` bytes; the zero fill is the copies' own.
template <typename T, typename P>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int64_t row_stride,
                                           int r0, int n, int limit, const P& p) {
  constexpr int kElem = (int)sizeof(T);
  if (p.vec == 2) {   // bf16 rows on odd element strides: plain loads
    for (int e = threadIdx.x; e < n * p.dp; e += blockDim.x) {
      const int r = e / p.dp, c = e - r * p.dp;
      const int gr = r0 + r;
      if (gr < limit && c < p.D) dst[r * p.kse + c] = src[(int64_t)gr * row_stride + c];
      else store_from_f32(dst + r * p.kse + c, 0.f);
    }
    return;
  }
  const int ce = p.vec / kElem;           // elements per copy
  const int per_row = p.dp / ce;
  for (int e = threadIdx.x; e < n * per_row; e += blockDim.x) {
    const int r = e / per_row;
    const int c = (e - r * per_row) * ce;
    const int gr = r0 + r;
    const int len = gr < limit ? min(max(p.D - c, 0), ce) : 0;
    const T* s = src + (len ? (int64_t)gr * row_stride + c : 0);
    if (p.vec == 16) cp_async16(dst + r * p.kse + c, s, len * kElem);
    else cp_async4(dst + r * p.kse + c, s, len * kElem);
  }
}

template <typename P>
__device__ __forceinline__ bool visible(const P& p, int qpos, int kpos) {
  bool ok = qpos < p.Tq && kpos < p.Tk;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window) ok = ok && kpos > qpos - p.window;
  return ok;
}

// Whether every pair of queries [qa, qb] and keys [ka, kb] is visible.
template <typename P>
__device__ __forceinline__ bool all_visible(const P& p, int qa, int qb, int ka, int kb) {
  return visible(p, qb, kb) && visible(p, qa, kb) && visible(p, qb, ka);
}

// Whether the warps of a strip share D: heads wider than one warp's
// accumulators hold.
inline bool is_wide(int D) { return (D + 7) / 8 > kMaxWidth; }

// Shared row stride in elements of D: padded to a multiple of 8 elements and
// to 4 mod 8 four-byte words.
inline int row_stride(int D, int elem) {
  const int words = (D + 7) / 8 * 8 * elem / 4;   // a multiple of 4
  return (words % 8 == 4 ? words : words + 4) * 4 / elem;
}

// Whether every row of x starts on a multiple of `bytes` (st: its batch, seq
// and head strides in elements).
inline bool aligned(const void* x, const int64_t* st, int elem, int bytes) {
  if (reinterpret_cast<uintptr_t>(x) % bytes) return false;
  for (int i = 0; i < 3; ++i)
    if ((st[i] * elem) % bytes) return false;
  return true;
}

}  // namespace
