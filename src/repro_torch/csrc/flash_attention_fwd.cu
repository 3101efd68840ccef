// Flash attention forward for Hopper (sm_90a), CUDA C++ with a plain C ABI.
//
// Replaces the TPU kernel repro/kernels/ops.py:_pallas_fwd, whose body is
// repro/kernels/flash_attention.py:_fwd_kernel (and flash_attention_fwd,
// which launches the same body).  Contract, identical to that kernel's:
//   q (B, Tq, H, D), k/v (B, Tk, KV, D), read in the model layout through
//   strides (the last dim contiguous), f32 or bf16;
//   out (B, Tq, H, D) in the input dtype, lse (B, H, Tq) f32;
//   scores scaled by the host-given scale (D**-0.5 of the real D);
//   masks: causal k <= q, window k > q - window, real lengths Tq / Tk
//   (ragged tails are masked here, nothing is padded in memory);
//   GQA: query head h reads kv head h / (H / KV), no repeat in memory;
//   a row with every key masked gets out = 0 and lse = -inf.
//
// What bounds it on an H100.  At the shapes the serving path gives it
// (gpt-2b prefill: T = 512, D = 80, causal) the work is 4*D operations per
// visible (query, key) pair against 4*D*elem bytes per row of q/k/v/out,
// i.e. ~T/(2*elem) operations per byte: 64 in float32, above the card's
// 20 (67 TFLOP/s outside the tensor cores over 3.35 TB/s), so float32 is
// bound by operations; 128 in bf16, below the tensor cores' 295, so bf16
// would be bound by bytes.  This first kernel runs on the CUDA cores in
// float32 (no tensor cores, no TF32, no wgmma/TMA: a later change), so its
// ceiling is the f32 FMA rate and, below that, the shared-memory traffic
// that feeds the FMAs.
//
// What the design does about it.
//   * One block per (b, h, tile of block_q query rows); a loop over K/V
//     tiles of block_k keys staged once in shared memory (as f32) and read
//     by every query row of the block, so each K/V byte leaves device
//     memory / L2 once per query tile.  Tiles wholly outside the causal or
//     window band are never loaded.
//   * A warp owns kRows query rows.  For Q.K^T, lane j owns key j of a
//     32-key sub-tile and computes its dot products with all kRows rows,
//     reading K as float4 (row stride padded so the quarter-warp phases of
//     a 16-byte load hit distinct banks) and Q as float4 broadcasts: one K
//     load feeds 4*kRows FMAs.  Online-softmax max/sum per row are warp
//     reductions held in registers.  For P.V, lanes split D (d = lane +
//     32*i, i < NPER), so any D <= 256 works, and p_j is broadcast with a
//     shuffle.  Accumulation is f32 throughout.
//   * Shared memory above 48 KB (e.g. D = 256) is dynamic shared memory,
//     raised with cudaFuncSetAttribute before the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRows = 4;        // query rows per warp
constexpr int kMaxWarps = 16;   // block_q <= 64: 512 threads x <= 128 registers
constexpr int kMaxD = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int B, Tq, Tk, H, KV, D;
  int64_t q_sb, q_st, q_sh;
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  float scale;
  int causal, window;
  int block_q, block_k;
  int dp;   // D rounded up to a multiple of 4 (Q and K rows, zero padded)
  int ks;   // K row stride in floats: dp or dp + 4, so that ks % 8 == 4
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename T, int NPER>
__global__ void __launch_bounds__(kWarp * kMaxWarps) flash_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                           // [block_q][dp]
  float* ks = qs + p.block_q * p.dp;          // [block_k][ks]
  float* vs = ks + p.block_k * p.ks;          // [block_k][D]

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = h / (p.H / p.KV);
  const int q0 = blockIdx.x * p.block_q;
  const int D = p.D;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // Stage the query tile (rows past Tq and columns past D are zeros), and
  // zero the K pad columns once: tile loads below never write them.
  for (int e = tid; e < p.block_q * p.dp; e += nthreads) {
    const int r = e / p.dp, c = e % p.dp;
    const int qi = q0 + r;
    qs[e] = (qi < p.Tq && c < D) ? load_f32(qg + qi * p.q_st + c) : 0.f;
  }
  for (int e = tid; e < p.block_k * (p.ks - D); e += nthreads) {
    const int w = p.ks - D;
    ks[(e / w) * p.ks + D + (e % w)] = 0.f;
  }

  // Key range this query tile can see.
  const int q_last = min(q0 + p.block_q, p.Tq) - 1;
  int kv_hi = p.causal ? min(p.Tk, q_last + 1) : p.Tk;
  int kv_lo = p.window ? max(0, q0 - p.window + 1) : 0;
  kv_lo = (kv_lo / p.block_k) * p.block_k;

  float m[kRows], l[kRows], acc[kRows][NPER];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NPER; ++i) acc[r][i] = 0.f;
  }
  const int row0 = warp * kRows;  // first row of this warp within the tile

  for (int t0 = kv_lo; t0 < kv_hi; t0 += p.block_k) {
    __syncthreads();  // previous tile fully consumed (and Q staged)
    const int n_keys = min(p.block_k, p.Tk - t0);
    for (int e = tid; e < p.block_k * D; e += nthreads) {
      const int r = e / D, c = e % D;
      float kx = 0.f, vx = 0.f;
      if (r < n_keys) {
        kx = load_f32(kg + (int64_t)(t0 + r) * p.k_st + c);
        vx = load_f32(vg + (int64_t)(t0 + r) * p.v_st + c);
      }
      ks[r * p.ks + c] = kx;
      vs[r * D + c] = vx;
    }
    __syncthreads();

    const int n_sub = (min(p.block_k, kv_hi - t0) + kWarp - 1) / kWarp;
    for (int sub = 0; sub < n_sub; ++sub) {
      // ---- S = Q K^T for this warp's rows against keys sub*32 + lane ----
      const int kr = sub * kWarp + lane;
      const float4* krow = reinterpret_cast<const float4*>(ks + kr * p.ks);
      float s[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = 0.f;
#pragma unroll 4
      for (int c = 0; c < p.dp / 4; ++c) {
        const float4 kk = krow[c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 qq = reinterpret_cast<const float4*>(qs + (row0 + r) * p.dp)[c];
          s[r] = fmaf(qq.x, kk.x, s[r]);
          s[r] = fmaf(qq.y, kk.y, s[r]);
          s[r] = fmaf(qq.z, kk.z, s[r]);
          s[r] = fmaf(qq.w, kk.w, s[r]);
        }
      }

      // ---- masks and the online-softmax update ----
      const int kpos = t0 + kr;
      float pr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int qpos = q0 + row0 + r;
        bool ok = qpos < p.Tq && kpos < p.Tk;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window) ok = ok && kpos > qpos - p.window;
        const float sv = ok ? s[r] * p.scale : -INFINITY;
        const float m_new = fmaxf(m[r], warp_max(sv));
        const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;
        const float pv = expf(sv - m_safe);
        const float alpha = (m[r] == -INFINITY) ? 0.f : expf(m[r] - m_safe);
        l[r] = alpha * l[r] + warp_sum(pv);
        m[r] = m_new;
#pragma unroll
        for (int i = 0; i < NPER; ++i) acc[r][i] *= alpha;
        pr[r] = pv;
      }

      // ---- O += P V: lanes split D ----
      for (int jj = 0; jj < kWarp; ++jj) {
        const float* vrow = vs + (sub * kWarp + jj) * D;
        float vv[NPER];
#pragma unroll
        for (int i = 0; i < NPER; ++i) {
          const int d = lane + i * kWarp;
          vv[i] = d < D ? vrow[d] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float pj = __shfl_sync(kFull, pr[r], jj);
#pragma unroll
          for (int i = 0; i < NPER; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
        }
      }
    }
  }

  // ---- finalize: out = acc / l, lse = m + log(l); empty rows -> 0, -inf ----
  T* og = static_cast<T*>(p.out);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + row0 + r;
    if (qpos >= p.Tq) continue;
    const bool empty = l[r] == 0.f;
    const float l_safe = empty ? 1.f : l[r];
    T* orow = og + (((int64_t)b * p.Tq + qpos) * p.H + h) * D;
#pragma unroll
    for (int i = 0; i < NPER; ++i) {
      const int d = lane + i * kWarp;
      if (d < D) store_from_f32(orow + d, acc[r][i] / l_safe);
    }
    if (lane == 0) {
      p.lse[((int64_t)b * p.H + h) * p.Tq + qpos] =
          empty ? -INFINITY : m[r] + logf(l_safe);
    }
  }
}

template <typename T, int NPER>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)p.block_q * p.dp + (size_t)p.block_k * p.ks +
                       (size_t)p.block_k * p.D);
  auto kernel = flash_fwd_kernel<T, NPER>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + p.block_q - 1) / p.block_q, p.H, p.B);
  const dim3 block((p.block_q / kRows) * kWarp);
  kernel<<<grid, block, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, cudaStream_t stream) {
  switch ((p.D + kWarp - 1) / kWarp) {
    case 1: return launch<T, 1>(p, stream);
    case 2: return launch<T, 2>(p, stream);
    case 3: return launch<T, 3>(p, stream);
    case 4: return launch<T, 4>(p, stream);
    case 5: return launch<T, 5>(p, stream);
    case 6: return launch<T, 6>(p, stream);
    case 7: return launch<T, 7>(p, stream);
    case 8: return launch<T, 8>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  Returns a
// cudaError_t (0 on success); nothing is synchronised.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                        void* lse, int dtype, int B, int Tq, int Tk, int H,
                        int KV, int D, long long q_sb, long long q_st,
                        long long q_sh, long long k_sb, long long k_st,
                        long long k_sh, long long v_sb, long long v_st,
                        long long v_sh, float scale, int causal, int window,
                        int block_q, int block_k, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || KV < 1 || H % KV != 0 || D < 1 ||
      D > kMaxD || block_q < kRows || block_q % kRows != 0 ||
      block_q / kRows > kMaxWarps || block_k < kWarp || block_k % kWarp != 0 ||
      B > 65535 || H > 65535 || window < 0) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.q = q; p.k = k; p.v = v; p.out = out; p.lse = static_cast<float*>(lse);
  p.B = B; p.Tq = Tq; p.Tk = Tk; p.H = H; p.KV = KV; p.D = D;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  p.scale = scale; p.causal = causal; p.window = window;
  p.block_q = block_q; p.block_k = block_k;
  p.dp = (D + 3) / 4 * 4;
  p.ks = (p.dp % 8 == 4) ? p.dp : p.dp + 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(p, st);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(p, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
