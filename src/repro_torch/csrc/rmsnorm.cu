// Fused RMSNorm for Hopper (sm_90a), CUDA C++ with a plain C ABI.
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py:rmsnorm (body
// _rmsnorm_kernel).  Contract, identical to that kernel's:
//   x (rows, D) float32 or bfloat16, read through its row stride (the last
//   dim contiguous); w (D,) float32 or bfloat16, contiguous;
//   y (rows, D) contiguous, in x's dtype;
//   y = (x * rsqrt(mean(x^2) + eps)) * w, statistics and products in f32.
//
// What bounds it on an H100.  Each element is read once and written once
// (4 operations per element: square, add, two multiplies), i.e. under one
// operation per byte, against the card's ~20 for float32 outside the tensor
// cores (67 TFLOP/s over 3.35 TB/s).  So it is bound by bytes: rows * D *
// (in + out bytes) + D * w bytes at 3.35 TB/s, 25.0 us at (4096, 2560) f32.
//
// What the design does about it.
//   * The card is filled whatever the row tile: a tile of block_rows rows
//     (the tuned parameter, as the TPU kernel's row tile was) is spread over
//     ceil(block_rows / kWarps) blocks of kWarps warps, one warp per row, so
//     4096 rows give 1024 small blocks, several per SM, whatever block_rows
//     is.  The last row tile is masked, so any block_rows works at any row
//     count (the TPU kernel needed block_rows to divide rows).  Rows are
//     independent: blocks run in any order.
//   * A row is read once: where it fits (16-byte vectors, at most kMaxVecs
//     per lane: D <= 3072 in f32, 6144 in bf16), a lane holds its share of
//     the row in registers between the sum of squares and the scale, and
//     issues all its loads before the first use, so each warp keeps a whole
//     row's bytes in flight.  The row sum is a register sum plus five warp
//     shuffles; no shared memory.
//   * Wider rows, or rows that are not 16-byte aligned, take two passes over
//     the row (sum of squares, then scale), the second meant to hit L1 or L2,
//     with 16-byte accesses where the alignment allows and scalar ones
//     otherwise.
//   * Anything it cannot take (rows, D or block_rows below 1, a dtype code it
//     does not know) is refused with cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// 4 warps (rows) per block: (4096, 2560) gives 1024 blocks over 132 SMs
// (scripts/torch_rmsnorm_warps.py compares other counts on the card)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxVecs = 24;   // 16-byte vectors a lane holds: 96 registers
constexpr int kUnroll = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// kVec elements of T in one access: 16 bytes for x and y.
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// The row this warp owns, or -1: block i covers rows [kWarps * (i % splits),
// + kWarps) of row tile i / splits.
__device__ __forceinline__ long long warp_row(long long rows, int block_rows, int splits) {
  const long long tile = blockIdx.x / splits;
  const int sub = blockIdx.x % splits;
  const int in_tile = sub * kWarps + (int)(threadIdx.x >> 5);
  const long long r = tile * block_rows + in_tile;
  return (in_tile < block_rows && r < rows) ? r : -1;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One read per element: the lane's NV vectors of the row stay in registers.
template <typename T, typename TW, int NV>
__global__ void __launch_bounds__(kThreads)
rmsnorm_held_kernel(const T* __restrict__ x, const TW* __restrict__ w, T* __restrict__ y,
                    long long rows, int D, long long x_stride, int block_rows, int splits,
                    float eps) {
  constexpr int kVec = 16 / sizeof(T);   // 4 f32 or 8 bf16
  using XPack = Pack<T, kVec>;
  using WPack = Pack<TW, kVec>;
  const long long r = warp_row(rows, block_rows, splits);
  if (r < 0) return;
  const int lane = threadIdx.x & 31;
  const int n = D / kVec;
  const XPack* xp = reinterpret_cast<const XPack*>(x + r * x_stride);
  XPack v[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < n) v[i] = xp[c];
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i < n) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float f = to_f32(v[i].v[e]);
        ss += f * f;
      }
    }
  }
  const float inv = rsqrtf(warp_sum(ss) * (1.0f / (float)D) + eps);
  const WPack* wp = reinterpret_cast<const WPack*>(w);
  XPack* yp = reinterpret_cast<XPack*>(y + r * (long long)D);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < n) {
      const WPack q = wp[c];
      XPack o;
#pragma unroll
      for (int e = 0; e < kVec; ++e) o.v[e] = from_f32<T>(to_f32(v[i].v[e]) * inv * to_f32(q.v[e]));
      yp[c] = o;
    }
  }
}

// Two passes over the row: wide rows (16-byte vectors when kVector), or
// scalar accesses where the alignment allows no vectors.
template <typename T, typename TW, bool kVector>
__global__ void __launch_bounds__(kThreads)
rmsnorm_two_pass_kernel(const T* __restrict__ x, const TW* __restrict__ w, T* __restrict__ y,
                        long long rows, int D, long long x_stride, int block_rows,
                        int splits, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  using XPack = Pack<T, kVec>;
  using WPack = Pack<TW, kVec>;
  const long long r = warp_row(rows, block_rows, splits);
  if (r < 0) return;
  const int lane = threadIdx.x & 31;
  const T* xr = x + r * x_stride;
  T* yr = y + r * (long long)D;
  float ss = 0.f;
  if (kVector) {
    const int n = D / kVec;
    const XPack* xp = reinterpret_cast<const XPack*>(xr);
#pragma unroll kUnroll
    for (int c = lane; c < n; c += 32) {
      const XPack p = xp[c];
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float v = to_f32(p.v[i]);
        ss += v * v;
      }
    }
  } else {
#pragma unroll kUnroll
    for (int i = lane; i < D; i += 32) {
      const float v = to_f32(xr[i]);
      ss += v * v;
    }
  }
  const float inv = rsqrtf(warp_sum(ss) * (1.0f / (float)D) + eps);
  if (kVector) {
    const int n = D / kVec;
    const XPack* xp = reinterpret_cast<const XPack*>(xr);
    const WPack* wp = reinterpret_cast<const WPack*>(w);
    XPack* yp = reinterpret_cast<XPack*>(yr);
#pragma unroll kUnroll
    for (int c = lane; c < n; c += 32) {
      const XPack p = xp[c];
      const WPack q = wp[c];
      XPack o;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        o.v[i] = from_f32<T>(to_f32(p.v[i]) * inv * to_f32(q.v[i]));
      }
      yp[c] = o;
    }
  } else {
#pragma unroll kUnroll
    for (int i = lane; i < D; i += 32) {
      yr[i] = from_f32<T>(to_f32(xr[i]) * inv * to_f32(w[i]));
    }
  }
}

template <typename T, typename TW>
cudaError_t launch(const void* x, const void* w, void* y, long long rows,
                   int D, long long x_stride, int block_rows, float eps,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vector =
      D % kVec == 0 && x_stride % kVec == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(w) % (sizeof(TW) * kVec) == 0;
  const int splits = (block_rows + kWarps - 1) / kWarps;
  const long long grid = (rows + block_rows - 1) / block_rows * splits;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const TW* wt = static_cast<const TW*>(w);
  T* yt = static_cast<T*>(y);
  const unsigned blocks = (unsigned)grid;
  const int per_lane = (D / kVec + 31) / 32;   // vectors a lane holds
#define HELD(NV)                                                              \
  rmsnorm_held_kernel<T, TW, NV><<<blocks, kThreads, 0, stream>>>(           \
      xt, wt, yt, rows, D, x_stride, block_rows, splits, eps)
  if (vector && per_lane <= 4) HELD(4);
  else if (vector && per_lane <= 8) HELD(8);
  else if (vector && per_lane <= 16) HELD(16);
  else if (vector && per_lane <= 20) HELD(20);
  else if (vector && per_lane <= kMaxVecs) HELD(kMaxVecs);
  else if (vector)
    rmsnorm_two_pass_kernel<T, TW, true><<<blocks, kThreads, 0, stream>>>(
        xt, wt, yt, rows, D, x_stride, block_rows, splits, eps);
  else
    rmsnorm_two_pass_kernel<T, TW, false><<<blocks, kThreads, 0, stream>>>(
        xt, wt, yt, rows, D, x_stride, block_rows, splits, eps);
#undef HELD
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_w(int w_dtype, const void* x, const void* w, void* y,
                       long long rows, int D, long long x_stride,
                       int block_rows, float eps, cudaStream_t stream) {
  if (w_dtype == 0)
    return launch<T, float>(x, w, y, rows, D, x_stride, block_rows, eps, stream);
  return launch<T, __nv_bfloat16>(x, w, y, rows, D, x_stride, block_rows, eps,
                                  stream);
}

}  // namespace

extern "C" {

// Dtype codes: 0 = float32, 1 = bfloat16.  x_stride is x's row stride in
// elements.  Returns a cudaError_t (0 on success); nothing is synchronised.
int rmsnorm(const void* x, const void* w, void* y, int x_dtype, int w_dtype,
            long long rows, int D, long long x_stride, int block_rows,
            float eps, void* stream) {
  if (rows < 1 || D < 1 || block_rows < 1 || x_stride < D ||
      (x_dtype != 0 && x_dtype != 1) || (w_dtype != 0 && w_dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return (int)dispatch_w<float>(w_dtype, x, w, y, rows, D, x_stride,
                                  block_rows, eps, st);
  return (int)dispatch_w<__nv_bfloat16>(w_dtype, x, w, y, rows, D, x_stride,
                                        block_rows, eps, st);
}

const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
