// Mamba-2 SSD intra-chunk term for Hopper (sm_90a), CUDA C++ with a plain C ABI.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:ssd_intra (body
// _ssd_intra_kernel).  Contract, identical to that kernel's, all float32:
//   x (B, nc, Q, H, P), dt and cum (B, nc, Q, H), Bm and Cm (B, nc, Q, N),
//   read in the model layout through strides (the last dim of x, Bm and Cm
//   contiguous); y (B, nc, Q, H, P) contiguous;
//   y[q, :] = sum_{j <= q} (C_q . B_j) * exp(cum_q - cum_j) * dt_j * x_j
//   per (batch, chunk, head).
// Unlike the TPU kernel, exp is taken only of cum_q - cum_j with j <= q.
// Above the diagonal that difference is a positive sum of dt's: at mamba2's
// chunk of 256 it reaches ~200 and exp overflows to inf, and no entry is
// ever multiplied by a 0/1 mask, so no inf * 0 = NaN can form.
//
// What bounds it on an H100.  Per (b, c) the necessary work is C B^T once
// (2N operations per pair j <= q) and M x per head (2P per pair and head):
// Q(Q+1)/2 * (2N + 2PH) operations against 4 bytes * (2QHP + 2QH + 2QN) of
// input and output, i.e. ~Q/4 operations per byte at mamba2's sizes (N 128,
// P 64, H 80): 64 at Q = 256, above the card's 20 for float32 outside the
// tensor cores (67 TFLOP/s over 3.35 TB/s).  So it is bound by operations.
// This first kernel runs on the CUDA cores in float32 (no TF32, no
// wgmma/TMA: later work), so its ceiling is the f32 FMA rate.
//
// What the design does about it.
//   * The TPU kernel recomputes the Q x Q product C B^T for every head
//     (grid (B, nc, H)), although Bm and Cm have no head axis: at mamba2's
//     sizes that is 2.9x the necessary work.  Here a block owns a tile of
//     kBQ query rows and a group of heads of one (b, c): it computes its
//     rows of C B^T once, for every key up to its last row, keeps them in
//     shared memory, and reuses them for each head of the group.  Head
//     groups are only as many as it takes to give the card ~2 blocks per SM
//     (the chunk count is small at prefill), so C B^T is recomputed a few
//     times per (b, c), not H times.
//   * A 256 x 256 f32 tile (256 KB) does not fit in a block's 227 KB, so the
//     chunk is cut into tiles of 64 rows and 64 keys; key tiles above the
//     diagonal are never touched, and on the diagonal tile each warp stops
//     at its own last row.
//   * Per head and key tile, M = CB * exp(cum_q - cum_j) * dt_j is built
//     once in shared memory (one exp per pair and head), then every thread
//     accumulates a 4 x 4 (x2 for P > 64) register tile of y = M x, reading
//     M as float4 broadcasts and x as float4 rows.  Sums are f32 throughout.
//   * Any 1 <= Q <= 256, 1 <= P <= 128, 1 <= N <= 128: ragged tiles are
//     zero-filled in shared memory and masked on store.  Anything else is
//     refused (cudaErrorInvalidValue), never computed wrongly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads, each a 4 x 4 output tile
constexpr int kBQ = 64;         // query rows per block
constexpr int kBJ = 64;         // keys per tile
constexpr int kNC = 32;         // state columns staged per step of C B^T
constexpr int kPad = 4;         // row pad of staged C/B: spreads banks, keeps float4 alignment
constexpr int kMaxQ = 256;
constexpr int kMaxP = 128;
constexpr int kMaxN = 128;

struct Params {
  const float* x;
  const float* dt;
  const float* cum;
  const float* bm;
  const float* cm;
  float* y;
  int B, nc, Q, H, P, N;
  int64_t x_sb, x_sc, x_sq, x_sh;
  int64_t dt_sb, dt_sc, dt_sq, dt_sh;
  int64_t cum_sb, cum_sc, cum_sq, cum_sh;
  int64_t b_sb, b_sc, b_sq;
  int64_t c_sb, c_sc, c_sq;
  int n_qt;   // query tiles per chunk
  int hpb;    // heads per block
  int n_hg;   // head groups
};

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 a,
                                       const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(av[r], bv[s], acc[r][s]);
  }
}

// PI: P <= 64 * PI (x rows are staged zero-padded to 64 * PI floats).
template <int PI>
__global__ void __launch_bounds__(kThreads, 2) ssd_intra_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kXS = 64 * PI;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;       // rows ty*4.., columns tx*4..
  // the last query tiles see the most keys: hand them out first
  const int qt = p.n_qt - 1 - (int)blockIdx.x / p.n_hg;
  const int hg = (int)blockIdx.x % p.n_hg;
  const int c = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBQ;
  const int nq = min(kBQ, p.Q - q0);
  const int j_end = q0 + nq;                    // keys j < j_end are visible
  const int n_jt = (j_end + kBJ - 1) / kBJ;
  const int h0 = hg * p.hpb;
  const int h1 = min(p.H, h0 + p.hpb);

  // cbt[j * kBQ + q] = C_{q0+q} . B_j for j < n_jt * kBJ
  float* cbt = smem;
  float* work = smem + (size_t)p.n_qt * kBJ * kBQ;

  // ---- phase 1: this tile's rows of C B^T, once for every head of the block
  {
    float* ct = work;                          // [kNC][kBQ + kPad]
    float* bt = work + kNC * (kBQ + kPad);     // [kNC][kBJ + kPad]
    const float* cg = p.cm + b * p.c_sb + c * p.c_sc;
    const float* bg = p.bm + b * p.b_sb + c * p.b_sc;
    for (int jt = 0; jt < n_jt; ++jt) {
      const int j0 = jt * kBJ;
      float acc[4][4] = {};
      for (int n0 = 0; n0 < p.N; n0 += kNC) {
        __syncthreads();                       // previous slice consumed
        for (int e = tid; e < kNC * kBQ; e += kThreads) {
          const int r = e / kNC, n = e % kNC, nn = n0 + n;
          const bool n_ok = nn < p.N;
          ct[n * (kBQ + kPad) + r] =
              (n_ok && r < nq) ? cg[(int64_t)(q0 + r) * p.c_sq + nn] : 0.f;
          bt[n * (kBJ + kPad) + r] =
              (n_ok && j0 + r < j_end) ? bg[(int64_t)(j0 + r) * p.b_sq + nn] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int n = 0; n < kNC; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(ct + n * (kBQ + kPad) + ty * 4);
          const float4 bv = *reinterpret_cast<const float4*>(bt + n * (kBJ + kPad) + tx * 4);
          fma4x4(acc, cv, bv);
        }
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        *reinterpret_cast<float4*>(cbt + (size_t)(j0 + tx * 4 + s) * kBQ + ty * 4) =
            make_float4(acc[0][s], acc[1][s], acc[2][s], acc[3][s]);
      }
    }
  }

  // ---- phase 2: per head, y = M x over the visible key tiles
  float* mt = work;                            // [kBJ][kBQ]: mt[j * kBQ + q] = M[q][j]
  float* xs = mt + kBJ * kBQ;                  // [kBJ][kXS]
  float* cum_j = xs + kBJ * kXS;               // [kBJ]
  float* dt_j = cum_j + kBJ;                   // [kBJ]
  const int mq = tid % kBQ;                    // the query row whose M entries this thread builds
  const int mj = tid / kBQ;                    // its first key row (then every kThreads / kBQ)
  const int warp_last_row = (tid / 32) * 8 + 7;  // a warp's rows: ty in {2w, 2w + 1}
  const float* xb = p.x + b * p.x_sb + c * p.x_sc;
  const float* dtb = p.dt + b * p.dt_sb + c * p.dt_sc;
  const float* cumb = p.cum + b * p.cum_sb + c * p.cum_sc;

  for (int h = h0; h < h1; ++h) {
    const float* xg = xb + h * p.x_sh;
    const float* dtg = dtb + h * p.dt_sh;
    const float* cg = cumb + h * p.cum_sh;
    const float cum_q = mq < nq ? cg[(int64_t)(q0 + mq) * p.cum_sq] : 0.f;
    float acc[4][4 * PI] = {};

    for (int jt = 0; jt < n_jt; ++jt) {
      const int j0 = jt * kBJ;
      const int nj = min(kBJ, j_end - j0);
      __syncthreads();                         // mt / xs consumed (and C B^T written)
      for (int e = tid; e < kBJ * kXS; e += kThreads) {
        const int r = e / kXS, col = e % kXS;
        xs[e] = (r < nj && col < p.P) ? xg[(int64_t)(j0 + r) * p.x_sq + col] : 0.f;
      }
      if (tid < kBJ) {
        cum_j[tid] = tid < nj ? cg[(int64_t)(j0 + tid) * p.cum_sq] : 0.f;
        dt_j[tid] = tid < nj ? dtg[(int64_t)(j0 + tid) * p.dt_sq] : 0.f;
      }
      __syncthreads();
      for (int r = mj; r < kBJ; r += kThreads / kBQ) {
        float m = 0.f;
        if (r < nj && mq < nq && j0 + r <= q0 + mq) {
          m = cbt[(size_t)(j0 + r) * kBQ + mq] * expf(cum_q - cum_j[r]) * dt_j[r];
        }
        mt[r * kBQ + mq] = m;
      }
      __syncthreads();
      // keys past the warp's last row contribute zeros: stop there
      const int k_hi = min(nj, q0 + warp_last_row + 1 - j0);
      for (int k = 0; k < k_hi; ++k) {
        const float4 mv = *reinterpret_cast<const float4*>(mt + k * kBQ + ty * 4);
        const float mr[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
        for (int i = 0; i < PI; ++i) {
          const float4 xv = *reinterpret_cast<const float4*>(xs + k * kXS + i * 64 + tx * 4);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[r][i * 4 + 0] = fmaf(mr[r], xv.x, acc[r][i * 4 + 0]);
            acc[r][i * 4 + 1] = fmaf(mr[r], xv.y, acc[r][i * 4 + 1]);
            acc[r][i * 4 + 2] = fmaf(mr[r], xv.z, acc[r][i * 4 + 2]);
            acc[r][i * 4 + 3] = fmaf(mr[r], xv.w, acc[r][i * 4 + 3]);
          }
        }
      }
    }

    float* yg = p.y + ((((int64_t)b * p.nc + c) * p.Q + q0) * p.H + h) * p.P;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int q = ty * 4 + r;
      if (q >= nq) continue;
#pragma unroll
      for (int i = 0; i < PI; ++i) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int col = i * 64 + tx * 4 + s;
          if (col < p.P) yg[(int64_t)q * p.H * p.P + col] = acc[r][i * 4 + s];
        }
      }
    }
  }
}

template <int PI>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int kXS = 64 * PI;
  const size_t phase1 = (size_t)kNC * (kBQ + kPad) + (size_t)kNC * (kBJ + kPad);
  const size_t phase2 = (size_t)kBJ * kBQ + (size_t)kBJ * kXS + 2 * kBJ;
  const size_t smem = sizeof(float) * ((size_t)p.n_qt * kBJ * kBQ +
                                       (phase1 > phase2 ? phase1 : phase2));
  auto kernel = ssd_intra_kernel<PI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.n_qt * p.n_hg, p.nc, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Strides are in elements, 18 of them: x (b, c, q, h), dt (b, c, q, h),
// cum (b, c, q, h), Bm (b, c, q), Cm (b, c, q).  Returns a cudaError_t (0 on
// success); nothing is synchronised.
int ssd_intra(const void* x, const void* dt, const void* cum, const void* bm,
              const void* cm, void* y, int B, int nc, int Q, int H, int P,
              int N, const long long* strides, void* stream) {
  if (B < 1 || nc < 1 || Q < 1 || H < 1 || P < 1 || N < 1 || Q > kMaxQ ||
      P > kMaxP || N > kMaxN || B > 65535 || nc > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.x = static_cast<const float*>(x);
  p.dt = static_cast<const float*>(dt);
  p.cum = static_cast<const float*>(cum);
  p.bm = static_cast<const float*>(bm);
  p.cm = static_cast<const float*>(cm);
  p.y = static_cast<float*>(y);
  p.B = B; p.nc = nc; p.Q = Q; p.H = H; p.P = P; p.N = N;
  p.x_sb = strides[0]; p.x_sc = strides[1]; p.x_sq = strides[2]; p.x_sh = strides[3];
  p.dt_sb = strides[4]; p.dt_sc = strides[5]; p.dt_sq = strides[6]; p.dt_sh = strides[7];
  p.cum_sb = strides[8]; p.cum_sc = strides[9]; p.cum_sq = strides[10]; p.cum_sh = strides[11];
  p.b_sb = strides[12]; p.b_sc = strides[13]; p.b_sq = strides[14];
  p.c_sb = strides[15]; p.c_sc = strides[16]; p.c_sq = strides[17];
  p.n_qt = (Q + kBQ - 1) / kBQ;

  // Enough head groups for ~2 blocks per SM, no more: each group recomputes
  // its rows of C B^T.
  int dev = 0, sms = 132;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long base = (long long)B * nc * p.n_qt;
  long long groups = (2LL * sms + base - 1) / base;
  if (groups < 1) groups = 1;
  if (groups > H) groups = H;
  p.hpb = (int)((H + groups - 1) / groups);
  p.n_hg = (H + p.hpb - 1) / p.hpb;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(P <= 64 ? launch<1>(p, st) : launch<2>(p, st));
}

const char* ssd_intra_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
