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
//   * One warp owns one row at a time; a block of kWarps warps walks its
//     block_rows rows (the tuned parameter, as the TPU kernel's row tile
//     was), so the row sum is a register sum plus five warp shuffles and
//     needs no shared memory.  Rows are independent: blocks run in any order.
//   * The last row tile is masked, so any block_rows works at any row count
//     (the TPU kernel needed block_rows to divide rows).
//   * 16-byte vector loads and stores where the row start, the row stride,
//     D and the pointers allow them (4 f32 or 8 bf16 per access, neighbouring
//     lanes on neighbouring addresses), scalar accesses otherwise.  Loops are
//     unrolled so a lane keeps several loads in flight.
//   * The row is read twice (sum of squares, then scale), the second time
//     right after the first, so that read is meant to hit L1 or L2 (a row is
//     a few tens of KB) and device memory to see one read and one write per
//     element.
//   * Anything it cannot take (rows, D or block_rows below 1, a dtype code it
//     does not know) is refused with cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// 16 warps per block: at the default block_rows of 128 a (4096, 2560) input
// gives 32 blocks, and 8 warps each kept too few loads in flight per SM
// (scripts/torch_rmsnorm_warps.py compares 8, 16 and 32 on the card)
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
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

template <typename T, typename TW, bool kVector>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const TW* __restrict__ w,
               T* __restrict__ y, long long rows, int D, long long x_stride,
               int block_rows, float eps) {
  constexpr int kVec = 16 / sizeof(T);   // 4 f32 or 8 bf16
  using XPack = Pack<T, kVec>;
  using WPack = Pack<TW, kVec>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row0 = (long long)blockIdx.x * block_rows;
  const long long row_end = min(row0 + (long long)block_rows, rows);
  const float inv_d = 1.0f / (float)D;

  for (long long r = row0 + warp; r < row_end; r += kWarps) {
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
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    const float inv = rsqrtf(ss * inv_d + eps);

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
  const long long grid = (rows + block_rows - 1) / block_rows;
  const T* xt = static_cast<const T*>(x);
  const TW* wt = static_cast<const TW*>(w);
  T* yt = static_cast<T*>(y);
  if (vector) {
    rmsnorm_kernel<T, TW, true><<<(unsigned)grid, kThreads, 0, stream>>>(
        xt, wt, yt, rows, D, x_stride, block_rows, eps);
  } else {
    rmsnorm_kernel<T, TW, false><<<(unsigned)grid, kThreads, 0, stream>>>(
        xt, wt, yt, rows, D, x_stride, block_rows, eps);
  }
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
      (x_dtype != 0 && x_dtype != 1) || (w_dtype != 0 && w_dtype != 1) ||
      (rows + block_rows - 1) / block_rows > 0x7fffffffLL) {
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
