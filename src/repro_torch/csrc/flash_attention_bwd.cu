// Flash attention backward for Hopper (sm_90a), CUDA C++ with a plain C ABI:
// two kernels, launched in this order on one stream.
//
//   flash_attention_bwd_dq   replaces repro/kernels/flash_attention.py:_dq_kernel
//                            (pallas_call at flash_attention.py:236);
//   flash_attention_bwd_dkv  replaces repro/kernels/flash_attention.py:_dkv_kernel
//                            (pallas_call at flash_attention.py:258).
//
// Contract, that of the TPU kernels with the GQA sum of kernels/ops.py:_flash_bwd:
//   q, out, dout (B, Tq, H, D); k, v (B, Tk, KV, D), read in the model layout
//   through strides (the last dim contiguous), f32 or bf16; lse (B, H, Tq) f32
//   from the forward;
//   delta = rowsum(dout * out) in f32 (written by the dq kernel to a (B, H, Tq)
//   f32 buffer, read by the dkv kernel);
//   P = exp(scale * q.k - lse) on unmasked pairs, 0 on masked ones and on rows
//   whose lse is -inf; dS = P * (dout.v - delta) * scale;
//   dq = dS.K (B, Tq, H, D), dk = dS^T.Q and dv = P^T.dout (B, Tk, KV, D), each
//   summed over the H / KV query heads of its kv head, contiguous, in the
//   input dtype; accumulation and exponentials in f32, without fast math;
//   masks: causal k <= q, window k > q - window, and the real lengths Tq / Tk
//   (nothing is padded in memory, so nothing padded can leak in).
//
// What bounds it on an H100.  Per visible (query, key) pair the dq kernel does
// 3 products of length D (S, dP, dQ) and the dkv kernel 4 (S, dP, dV, dK), so
// at the gpt-2b training shape (T = 1024, D = 80, causal) they do ~T*3*D/2 and
// ~T*4*D/2 operations per (b, h) against ~8*T*D*elem bytes: ~30 and ~40
// operations per byte in f32, above the card's 20 (67 TFLOP/s outside the
// tensor cores over 3.35 TB/s), so f32 is bound by operations; in bf16 the
// tensor cores' 295 would make both bound by bytes.  Like the forward, these
// first kernels run on the CUDA cores in f32 (no TF32, no wgmma/TMA: later
// work), so their ceiling is the f32 FMA rate and, below it, the shared-memory
// traffic that feeds the FMAs.
//
// What the design does about it.  Both kernels are the forward's layout with
// the roles of the two sides swapped:
//   * dq: one block per (b, h, block_rows query rows); a loop over K/V tiles of
//     block_tile keys staged in shared memory (f32).  A warp owns kRows query
//     rows; for S and dP lane j owns key j of a 32-key sub-tile and reads its
//     K and V rows as float4 (row stride padded so the quarter-warp phases of a
//     16-byte load hit distinct banks) against Q and dO rows read as float4
//     broadcasts: one K or V load feeds 4*kRows FMAs.  For dQ += dS.K lanes
//     split D (d = lane + 32*i, i < NPER) and dS_j is broadcast by a shuffle.
//     delta is a warp reduction per row, before the loop.
//   * dkv: one block per (b, kv head, block_rows keys); a loop over the query
//     heads of the group and over Q/dO tiles of block_tile rows (with their lse
//     and delta) staged in shared memory.  A warp owns kRows keys; lane j owns
//     query j of a 32-row sub-tile for S and dP; for dV += P^T.dO and
//     dK += dS^T.Q lanes split D and P_j, dS_j are broadcast.  The group sum
//     happens in the f32 accumulators, so no expanded-head buffer exists.
//   * Tiles wholly outside the causal or window band are never loaded; NPER =
//     ceil(D / 32) is a template argument, so any D <= 256 keeps its
//     accumulators in registers.  Shared memory above 48 KB is dynamic, raised
//     with cudaFuncSetAttribute before the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRows = 4;       // rows (queries for dq, keys for dkv) per warp
constexpr int kMaxWarps = 8;   // block_rows <= 32: 256 threads, <= 255 registers
constexpr int kMaxD = 256;
constexpr int kStrides = 15;   // (batch, seq, head) strides of q, k, v, out, dout
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, Tq, Tk, H, KV, D;
  int64_t q_sb, q_st, q_sh;
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_st, o_sh;
  int64_t g_sb, g_st, g_sh;   // dout
  float scale;
  int causal, window;
  int block_rows;   // rows owned by the warps of one block (kRows per warp)
  int block_tile;   // rows of the other side staged per loop step (x32)
  int dp;           // D rounded up to a multiple of 4 (rows zero padded)
  int ks;           // shared row stride in floats: dp or dp + 4, ks % 8 == 4
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float dot4(float acc, const float4 a, const float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ const float4* row4(const float* base, int r, int ks) {
  return reinterpret_cast<const float4*>(base + r * ks);
}

// Stage rows [r0, r0 + n) of a (rows, D) matrix of the model layout into
// shared memory as f32 rows of stride ks: rows past `limit` and columns past D
// (up to dp) are zeros.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int64_t row_stride,
                                           int r0, int n, int limit, int D, int dp,
                                           int ks) {
  for (int e = threadIdx.x; e < n * dp; e += blockDim.x) {
    const int r = e / dp, c = e % dp;
    const int gr = r0 + r;
    dst[r * ks + c] = (gr < limit && c < D) ? load_f32(src + gr * row_stride + c) : 0.f;
  }
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  bool ok = qpos < p.Tq && kpos < p.Tk;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window) ok = ok && kpos > qpos - p.window;
  return ok;
}

// ---------------------------------------------------------------------------
// dq: grid (ceil(Tq / block_rows), H, B)
// ---------------------------------------------------------------------------

template <typename T, int NPER>
__global__ void __launch_bounds__(kWarp * kMaxWarps) flash_bwd_dq_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // [block_rows][ks]
  float* gs = qs + p.block_rows * p.ks;      // [block_rows][ks]  dout
  float* kt = gs + p.block_rows * p.ks;      // [block_tile][ks]
  float* vt = kt + p.block_tile * p.ks;      // [block_tile][ks]

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = h / (p.H / p.KV);
  const int q0 = blockIdx.x * p.block_rows;
  const int D = p.D;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const T* og = static_cast<const T*>(p.out) + b * p.o_sb + h * p.o_sh;
  const T* gg = static_cast<const T*>(p.dout) + b * p.g_sb + h * p.g_sh;

  stage_rows(qs, qg, p.q_st, q0, p.block_rows, p.Tq, D, p.dp, p.ks);
  stage_rows(gs, gg, p.g_st, q0, p.block_rows, p.Tq, D, p.dp, p.ks);
  __syncthreads();

  // Per row of this warp: lse (a -inf row keeps P = 0) and delta.
  const int row0 = warp * kRows;
  float lse[kRows], delta[kRows];
  bool live[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + row0 + r;
    float part = 0.f;
    if (qpos < p.Tq) {
      for (int d = lane; d < D; d += kWarp) {
        part = fmaf(gs[(row0 + r) * p.ks + d], load_f32(og + qpos * p.o_st + d), part);
      }
    }
    delta[r] = warp_sum(part);
    const int64_t li = ((int64_t)b * p.H + h) * p.Tq + qpos;
    lse[r] = qpos < p.Tq ? p.lse[li] : -INFINITY;
    live[r] = lse[r] != -INFINITY;
    if (qpos < p.Tq && lane == 0) p.delta[li] = delta[r];
  }

  // Key range this query tile can see.
  const int q_last = min(q0 + p.block_rows, p.Tq) - 1;
  const int kv_hi = p.causal ? min(p.Tk, q_last + 1) : p.Tk;
  int kv_lo = p.window ? max(0, q0 - p.window + 1) : 0;
  kv_lo = (kv_lo / p.block_tile) * p.block_tile;

  float acc[kRows][NPER];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < NPER; ++i) acc[r][i] = 0.f;

  for (int t0 = kv_lo; t0 < kv_hi; t0 += p.block_tile) {
    __syncthreads();  // previous tile fully consumed
    stage_rows(kt, kg, p.k_st, t0, p.block_tile, p.Tk, D, p.dp, p.ks);
    stage_rows(vt, vg, p.v_st, t0, p.block_tile, p.Tk, D, p.dp, p.ks);
    __syncthreads();

    const int n_sub = (min(p.block_tile, kv_hi - t0) + kWarp - 1) / kWarp;
    for (int sub = 0; sub < n_sub; ++sub) {
      // ---- S = Q K^T and dP = dO V^T against key sub*32 + lane ----
      const int kr = sub * kWarp + lane;
      const float4* krow = row4(kt, kr, p.ks);
      const float4* vrow = row4(vt, kr, p.ks);
      float s[kRows], dpv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = dpv[r] = 0.f;
#pragma unroll 4
      for (int c = 0; c < p.dp / 4; ++c) {
        const float4 kk = krow[c];
        const float4 vv = vrow[c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          s[r] = dot4(s[r], row4(qs, row0 + r, p.ks)[c], kk);
          dpv[r] = dot4(dpv[r], row4(gs, row0 + r, p.ks)[c], vv);
        }
      }
      // ---- P and dS ----
      const int kpos = t0 + kr;
      float ds[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const bool ok = live[r] && visible(p, q0 + row0 + r, kpos);
        const float pv = ok ? expf(s[r] * p.scale - lse[r]) : 0.f;
        ds[r] = pv * (dpv[r] - delta[r]) * p.scale;
      }
      // ---- dQ += dS K: lanes split D ----
      for (int jj = 0; jj < kWarp; ++jj) {
        const float* kj = kt + (sub * kWarp + jj) * p.ks;
        float kk[NPER];
#pragma unroll
        for (int i = 0; i < NPER; ++i) {
          const int d = lane + i * kWarp;
          kk[i] = d < D ? kj[d] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float dsj = __shfl_sync(kFull, ds[r], jj);
#pragma unroll
          for (int i = 0; i < NPER; ++i) acc[r][i] = fmaf(dsj, kk[i], acc[r][i]);
        }
      }
    }
  }

  T* dqg = static_cast<T*>(p.dq);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + row0 + r;
    if (qpos >= p.Tq) continue;
    T* row = dqg + (((int64_t)b * p.Tq + qpos) * p.H + h) * D;
#pragma unroll
    for (int i = 0; i < NPER; ++i) {
      const int d = lane + i * kWarp;
      if (d < D) store_from_f32(row + d, acc[r][i]);
    }
  }
}

// ---------------------------------------------------------------------------
// dk, dv: grid (ceil(Tk / block_rows), KV, B)
// ---------------------------------------------------------------------------

template <typename T, int NPER>
__global__ void __launch_bounds__(kWarp * kMaxWarps) flash_bwd_dkv_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                          // [block_rows][ks]
  float* vt = kt + p.block_rows * p.ks;      // [block_rows][ks]
  float* qs = vt + p.block_rows * p.ks;      // [block_tile][ks]
  float* gs = qs + p.block_tile * p.ks;      // [block_tile][ks]  dout
  float* ls = gs + p.block_tile * p.ks;      // [block_tile]      lse
  float* dl = ls + p.block_tile;             // [block_tile]      delta

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int b = blockIdx.z;
  const int hk = blockIdx.y;
  const int rep = p.H / p.KV;
  const int k0 = blockIdx.x * p.block_rows;
  const int D = p.D;

  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  stage_rows(kt, kg, p.k_st, k0, p.block_rows, p.Tk, D, p.dp, p.ks);
  stage_rows(vt, vg, p.v_st, k0, p.block_rows, p.Tk, D, p.dp, p.ks);

  // Query range these keys are visible to.
  const int k_last = min(k0 + p.block_rows, p.Tk) - 1;
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi = p.window ? min(p.Tq, k_last + p.window) : p.Tq;

  const int row0 = warp * kRows;
  float adk[kRows][NPER], adv[kRows][NPER];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < NPER; ++i) adk[r][i] = adv[r][i] = 0.f;

  for (int h = hk * rep; h < (hk + 1) * rep; ++h) {
    const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* gg = static_cast<const T*>(p.dout) + b * p.g_sb + h * p.g_sh;
    const int64_t lrow = ((int64_t)b * p.H + h) * p.Tq;
    for (int t0 = q_lo; t0 < q_hi; t0 += p.block_tile) {
      __syncthreads();  // previous tile fully consumed (and K/V staged)
      stage_rows(qs, qg, p.q_st, t0, p.block_tile, p.Tq, D, p.dp, p.ks);
      stage_rows(gs, gg, p.g_st, t0, p.block_tile, p.Tq, D, p.dp, p.ks);
      for (int e = threadIdx.x; e < p.block_tile; e += blockDim.x) {
        const int qpos = t0 + e;
        ls[e] = qpos < p.Tq ? p.lse[lrow + qpos] : -INFINITY;
        dl[e] = qpos < p.Tq ? p.delta[lrow + qpos] : 0.f;
      }
      __syncthreads();

      const int n_sub = (min(p.block_tile, q_hi - t0) + kWarp - 1) / kWarp;
      for (int sub = 0; sub < n_sub; ++sub) {
        // ---- S^T = K Q^T and dP^T = V dO^T against query sub*32 + lane ----
        const int qr = sub * kWarp + lane;
        const float4* qrow = row4(qs, qr, p.ks);
        const float4* grow = row4(gs, qr, p.ks);
        float s[kRows], dpv[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) s[r] = dpv[r] = 0.f;
#pragma unroll 4
        for (int c = 0; c < p.dp / 4; ++c) {
          const float4 qq = qrow[c];
          const float4 gq = grow[c];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            s[r] = dot4(s[r], qq, row4(kt, row0 + r, p.ks)[c]);
            dpv[r] = dot4(dpv[r], gq, row4(vt, row0 + r, p.ks)[c]);
          }
        }
        // ---- P and dS for (query qr, this warp's keys) ----
        const int qpos = t0 + qr;
        const float lq = ls[qr];
        const float dq = dl[qr];
        float pr[kRows], ds[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const bool ok = lq != -INFINITY && visible(p, qpos, k0 + row0 + r);
          pr[r] = ok ? expf(s[r] * p.scale - lq) : 0.f;
          ds[r] = pr[r] * (dpv[r] - dq) * p.scale;
        }
        // ---- dV += P^T dO and dK += dS^T Q: lanes split D ----
        for (int jj = 0; jj < kWarp; ++jj) {
          const float* qj = qs + (sub * kWarp + jj) * p.ks;
          const float* gj = gs + (sub * kWarp + jj) * p.ks;
          float qv[NPER], gv[NPER];
#pragma unroll
          for (int i = 0; i < NPER; ++i) {
            const int d = lane + i * kWarp;
            qv[i] = d < D ? qj[d] : 0.f;
            gv[i] = d < D ? gj[d] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float pj = __shfl_sync(kFull, pr[r], jj);
            const float dsj = __shfl_sync(kFull, ds[r], jj);
#pragma unroll
            for (int i = 0; i < NPER; ++i) {
              adv[r][i] = fmaf(pj, gv[i], adv[r][i]);
              adk[r][i] = fmaf(dsj, qv[i], adk[r][i]);
            }
          }
        }
      }
    }
  }

  T* dkg = static_cast<T*>(p.dk);
  T* dvg = static_cast<T*>(p.dv);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int kpos = k0 + row0 + r;
    if (kpos >= p.Tk) continue;
    const int64_t off = (((int64_t)b * p.Tk + kpos) * p.KV + hk) * D;
#pragma unroll
    for (int i = 0; i < NPER; ++i) {
      const int d = lane + i * kWarp;
      if (d < D) {
        store_from_f32(dkg + off + d, adk[r][i]);
        store_from_f32(dvg + off + d, adv[r][i]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

enum Which { kDq = 0, kDkv = 1 };

template <typename T, int NPER>
cudaError_t launch(Which which, const Params& p, cudaStream_t stream) {
  const size_t rows = 2 * ((size_t)p.block_rows + p.block_tile);
  size_t smem = sizeof(float) * rows * p.ks;
  if (which == kDkv) smem += sizeof(float) * 2 * p.block_tile;
  auto kernel = which == kDq ? flash_bwd_dq_kernel<T, NPER> : flash_bwd_dkv_kernel<T, NPER>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int len = which == kDq ? p.Tq : p.Tk;
  const dim3 grid((len + p.block_rows - 1) / p.block_rows, which == kDq ? p.H : p.KV, p.B);
  const dim3 block((p.block_rows / kRows) * kWarp);
  kernel<<<grid, block, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(Which which, const Params& p, cudaStream_t stream) {
  switch ((p.D + kWarp - 1) / kWarp) {
    case 1: return launch<T, 1>(which, p, stream);
    case 2: return launch<T, 2>(which, p, stream);
    case 3: return launch<T, 3>(which, p, stream);
    case 4: return launch<T, 4>(which, p, stream);
    case 5: return launch<T, 5>(which, p, stream);
    case 6: return launch<T, 6>(which, p, stream);
    case 7: return launch<T, 7>(which, p, stream);
    case 8: return launch<T, 8>(which, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(Which which, const void* q, const void* k, const void* v, const void* out,
        const void* dout, const void* lse, void* delta, void* dq, void* dk, void* dv,
        int dtype, int B, int Tq, int Tk, int H, int KV, int D,
        const long long* strides, float scale, int causal, int window,
        int block_rows, int block_tile, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || KV < 1 || H % KV != 0 || D < 1 ||
      D > kMaxD || block_rows < kRows || block_rows % kRows != 0 ||
      block_rows / kRows > kMaxWarps || block_tile < kWarp ||
      block_tile % kWarp != 0 || B > 65535 || H > 65535 || window < 0) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.q = q; p.k = k; p.v = v; p.out = out; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.B = B; p.Tq = Tq; p.Tk = Tk; p.H = H; p.KV = KV; p.D = D;
  int64_t* s[kStrides] = {&p.q_sb, &p.q_st, &p.q_sh, &p.k_sb, &p.k_st, &p.k_sh,
                          &p.v_sb, &p.v_st, &p.v_sh, &p.o_sb, &p.o_st, &p.o_sh,
                          &p.g_sb, &p.g_st, &p.g_sh};
  for (int i = 0; i < kStrides; ++i) *s[i] = strides[i];
  p.scale = scale; p.causal = causal; p.window = window;
  p.block_rows = block_rows; p.block_tile = block_tile;
  p.dp = (D + 3) / 4 * 4;
  p.ks = (p.dp % 8 == 4) ? p.dp : p.dp + 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(which, p, st);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(which, p, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  `strides` holds 15 element strides:
// (batch, seq, head) of q, k, v, out and dout.  Both entry points take the
// same arguments; the dq kernel writes delta and dq, the dkv kernel reads
// delta and writes dk and dv, so launch dq first.  Each returns a
// cudaError_t (0 on success); nothing is synchronised.
#define BWD_ARGS                                                              \
  const void *q, const void *k, const void *v, const void *out,               \
      const void *dout, const void *lse, void *delta, void *dq, void *dk,     \
      void *dv, int dtype, int B, int Tq, int Tk, int H, int KV, int D,       \
      const long long *strides, float scale, int causal, int window,          \
      int block_rows, int block_tile, void *stream
#define BWD_PASS                                                              \
  q, k, v, out, dout, lse, delta, dq, dk, dv, dtype, B, Tq, Tk, H, KV, D,     \
      strides, scale, causal, window, block_rows, block_tile, stream

int flash_attention_bwd_dq(BWD_ARGS) { return run(kDq, BWD_PASS); }

int flash_attention_bwd_dkv(BWD_ARGS) { return run(kDkv, BWD_PASS); }

const char* flash_attention_bwd_dq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

const char* flash_attention_bwd_dkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
