// Flash attention forward for Hopper (sm_90a), CUDA C++ with a plain C ABI.
//
// Replaces the TPU kernel repro/kernels/ops.py:_pallas_fwd, whose body is
// repro/kernels/flash_attention.py:_fwd_kernel (and flash_attention_fwd,
// which launches the same body).  Contract, identical to that kernel's:
//   q (B, Tq, H, D), k/v (B, Tk, KV, D), read in the model layout through
//   strides (the last dim contiguous), f32 or bf16, every product in f32;
//   out (B, Tq, H, D) in the input dtype, lse (B, H, Tq) f32;
//   scores scaled by the host-given scale (D**-0.5 of the real D);
//   masks: causal k <= q, window k > q - window, real lengths Tq / Tk
//   (ragged tails are masked here, nothing is padded in memory);
//   GQA: query head h reads kv head h / (H / KV), no repeat in memory;
//   a row with every key masked gets out = 0 and lse = -inf.
//
// What bounds it on an H100.  Per visible (query, key) pair the kernel does
// two products of length D (S = Q.K^T and O += P.V): at the gpt-2b shapes
// (T = 512 or 1024, D = 80, causal, f32) ~T/8 operations per byte, so it is
// bound by operations.  On the CUDA cores that ceiling is 67 TFLOP/s.  The
// tensor cores' TF32 mode keeps 10 mantissa bits, too few for the f32
// tolerance (2e-5), but three TF32 products per f32 product (3xTF32: x =
// big + small with big = tf32(x), small = tf32(x - big); a.b ~ small.big +
// big.small + big.big) keep f32 accuracy at a third of the 495 TFLOP/s TF32
// rate: a 165 TFLOP/s ceiling.  bf16 values are exact in TF32, so with bf16
// inputs S takes one product and P.V two (only P is split).
//
// What the design does about it (the pattern of flash_attention_bwd.cu's dq
// kernel; the two share flash_mma.cuh's helpers).  Every product is
// mma.sync.m16n8k8 (TF32 in, f32 accumulators); a warp owns a 16-row query
// strip (the m16 of the mma), a block up to 4 strips (block_q <= 64).
//   * One block per (head, batch, block_q query rows), the longest causal
//     rows launched first.  Q is staged once; K and V arrive in tiles of
//     block_k keys by cp.async into two buffers (tile t + 1 in flight while
//     tile t is computed).  16-byte copies where every row starts 16-byte
//     aligned, else 4-byte copies, else (bf16 rows on odd element strides)
//     plain loads; the tail of a row past D is zeros up to a multiple of 8.
//     The shared row stride is 4 mod 8 words.  Tiles wholly outside the
//     causal or window band are never loaded; a strip skips the 32-key steps
//     it cannot see.
//   * D <= 80: per step of 32 keys a warp computes S (16 x 32) into mma
//     accumulators, summing over d in a permuted order so that each Q or K
//     fragment is one 8-byte load.  Q's fragment is split when it is loaded
//     (holding Q's split fragments in registers for the whole loop measured
//     slower on an H100 and spilled at D = 80), in a loop over d unrolled
//     by 4 (by 1, 2, or fully, measured slower:
//     scripts/torch_flash_fwd_variants.py).  The masks apply per element,
//     only on steps that straddle an edge.  The online softmax stays in the
//     accumulator layout: a row's max is a reduction among the 4 lanes that
//     own it (2 shuffles); each lane keeps a partial row sum, reduced once at
//     the end.  P goes straight from the accumulators into O += P.V as A
//     fragments in the permuted k order (key 2t is k = t, key 2t + 1 is
//     k = t + 4), V's B fragment read from rows 2t, 2t + 1 to match.
//   * Each step's P.V is summed from zero in the mma and added to the
//     running f32 O after its alpha rescale (O = alpha O + part): the tensor
//     cores truncate the addends they align, so a sum carried inside the mma
//     across many steps drifts with its length.
//   * Wider heads (zamba2's 112, 128, gemma's 256): the 4 warps of a strip
//     share D.  Each computes one n8 tile of S over all of D (Q split at
//     load from shared memory), the strip's row max is exchanged through
//     shared memory, and P passes through a 16 x 40 f32 buffer, after which
//     each warp sums a quarter of D's columns of O over the 32 keys; 2 strips
//     (256 threads, block_q <= 32) per block, so that a thread may hold 255
//     registers.

#include <type_traits>

#include "flash_mma.cuh"

namespace {

// Compile-time switches for scripts/torch_flash_fwd_variants.py, which times
// the kernel with one part taken out or changed (the output is then wrong
// where a part is taken out).  The defaults are the kernel as it runs.
#ifndef FLASH_FWD_SCORES          // 0: no S products
#define FLASH_FWD_SCORES 1
#endif
#ifndef FLASH_FWD_PV              // 0: no P.V products
#define FLASH_FWD_PV 1
#endif
#ifndef FLASH_FWD_COMPENSATION    // 0: every 3xTF32 product as big.big alone
#define FLASH_FWD_COMPENSATION 1
#endif
#ifndef FLASH_FWD_D_UNROLL        // chunks of d per iteration of S's loop
#define FLASH_FWD_D_UNROLL 4
#endif

constexpr int kMaxStrips = 4;  // strips per block: block_q <= 64
constexpr int kMaxWideStrips = 2;  // strips per block when wide: 256 threads, block_q <= 32
constexpr int kMinBlocks = 2;  // blocks per SM the registers are sized for (D <= 80)
constexpr int kStep = 32;      // keys per online-softmax step
constexpr int kNT = kStep / 8; // n8 tiles of S per step; warps per strip when wide
constexpr int kPs = kStep + 8; // row stride (floats) of a wide strip's P buffer
constexpr int kDUnroll = FLASH_FWD_D_UNROLL;

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
  int dp;           // D rounded up to a multiple of 8 (rows zero padded)
  int dc;           // dp / 8: k chunks of S
  int kse;          // shared row stride in elements (4 mod 8 in 4-byte words)
  int vec;          // copy width of the staged rows: 16, 4 or 2 bytes
};

// c += a.b with a (b) split when kSA (kSB): small.big and big.small first,
// then big.big, all into the f32 accumulators.
template <bool kSA, bool kSB>
__device__ __forceinline__ void mma3(float (&c)[4], const Frag<4>& a, const Frag<2>& b) {
  if (kSA && FLASH_FWD_COMPENSATION) mma(c, a.small, b.big);
  if (kSB && FLASH_FWD_COMPENSATION) mma(c, a.big, b.small);
  mma(c, a.big, b.big);
}

// Whether no pair of queries [qa, qb] and keys [ka, kb] is visible.
__device__ __forceinline__ bool none_visible(const Params& p, int qa, int qb, int ka, int kb) {
  return qa >= p.Tq || ka >= p.Tk || (p.causal && ka > qb) ||
         (p.window && kb <= qa - p.window);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// ---------------------------------------------------------------------------
// The kernel: grid (H, B, ceil(Tq / block_q))
// ---------------------------------------------------------------------------

template <typename T, int NA, bool kWide>
__global__ void __launch_bounds__(kWide ? kWarp * kNT * kMaxWideStrips : kWarp * kMaxStrips,
                                  kWide ? 1 : kMinBlocks)
flash_fwd_kernel(const Params p) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kNTw = kWide ? 1 : kNT;         // n8 tiles of S a warp computes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);       // [block_q][kse]
  T* kt = qs + p.block_q * p.kse;               // [2][block_k][kse]
  T* vt = kt + 2 * p.block_k * p.kse;           // [2][block_k][kse]
  float* pb = reinterpret_cast<float*>(vt + 2 * p.block_k * p.kse + kOverrun);
  // wide: [strips][kStrip][kPs] P, then [strips][kNT][kStrip] row maxima and
  // [strips][kNT][kStrip] row sums

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int g = lane / 4, t = lane % 4;
  const int strip = kWide ? warp / kNT : warp;  // the warp's 16 rows of the block
  const int part = kWide ? warp % kNT : 0;      // wide: its n8 tile of S, its share of D
  const int c0 = part * NA;                     // first chunk of 8 columns it owns
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / (p.H / p.KV);
  const int q0 = (gridDim.z - 1 - blockIdx.z) * p.block_q;   // the longest causal rows first
  const int r0 = strip * kStrip;
  const int qa = q0 + r0, qb = q0 + r0 + kStrip - 1;         // the strip's rows
  const int D = p.D;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // Key range this query tile can see.
  const int q_last = min(q0 + p.block_q, p.Tq) - 1;
  const int kv_hi = p.causal ? min(p.Tk, q_last + 1) : p.Tk;
  int kv_lo = p.window ? max(0, q0 - p.window + 1) : 0;
  kv_lo = (kv_lo / p.block_k) * p.block_k;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + p.block_k - 1) / p.block_k : 0;

  stage_rows(qs, qg, p.q_st, q0, p.block_q, p.Tq, p);
  if (n_tiles > 0) {
    stage_rows(kt, kg, p.k_st, kv_lo, p.block_k, p.Tk, p);
    stage_rows(vt, vg, p.v_st, kv_lo, p.block_k, p.Tk, p);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  float acc[NA][4];
#pragma unroll
  for (int j = 0; j < NA; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // rows g, g + 8: the running max
  float l[2] = {0.f, 0.f};               // this lane's share of the row sums
  float* strip_p = pb + strip * kStrip * kPs;
  float* strip_max = pb + kMaxWideStrips * kStrip * kPs + strip * kNT * kStrip;
  float* strip_sum = strip_max + kMaxWideStrips * kNT * kStrip;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    const int t0 = kv_lo + it * p.block_k;
    if (it + 1 < n_tiles) {   // the next tile flies while this one is computed
      stage_rows(kt + (buf ^ 1) * p.block_k * p.kse, kg, p.k_st, t0 + p.block_k,
                 p.block_k, p.Tk, p);
      stage_rows(vt + (buf ^ 1) * p.block_k * p.kse, vg, p.v_st, t0 + p.block_k,
                 p.block_k, p.Tk, p);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* kb = kt + buf * p.block_k * p.kse;
    const T* vb = vt + buf * p.block_k * p.kse;
    const int n_steps = (min(p.block_k, kv_hi - t0) + kStep - 1) / kStep;

    for (int st = 0; st < n_steps; ++st) {
      const int k0 = t0 + st * kStep;            // first key of the step
      // a strip that sees none of these keys skips them (wide: the block's
      // warps meet at barriers below, so every strip takes every step)
      if (!kWide && none_visible(p, qa, qb, k0, k0 + kStep - 1)) continue;
      const T* ks = kb + st * kStep * p.kse;
      const T* vs = vb + st * kStep * p.kse;

      // ---- S = Q K^T: 16 rows x this warp's keys, Q's fragment split at load ----
      float s[kNTw][4];
#pragma unroll
      for (int n = 0; n < kNTw; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll kDUnroll
      for (int kc = 0; kc < (FLASH_FWD_SCORES ? p.dc : 0); ++kc) {
        const int c = kc * 8 + 2 * t;
        Frag<4> a = load_a(qs, p.kse, r0 + g, c);
        prepare<kF32>(a);
#pragma unroll
        for (int n = 0; n < kNTw; ++n) {
          Frag<2> f = load_bt(ks, p.kse, (part + n) * 8 + g, c);
          prepare<kF32>(f);
          mma3<kF32, kF32>(s[n], a, f);
        }
      }

      // ---- masks, the row max and P, in place of S ----
      const bool whole = all_visible(p, qa, qb, k0, k0 + kStep - 1);
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < kNTw; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2;
          const bool ok = whole || visible(p, qa + g + 8 * i,
                                           k0 + (part + n) * 8 + 2 * t + e % 2);
          s[n][e] = ok ? s[n][e] * p.scale : -INFINITY;
          mt[i] = fmaxf(mt[i], s[n][e]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) mt[i] = quad_max(mt[i]);
      if constexpr (kWide) {   // the strip's row max over its 4 warps' keys
        if (t == 0) {
          strip_max[part * kStrip + g] = mt[0];
          strip_max[part * kStrip + g + 8] = mt[1];
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int w = 0; w < kNT; ++w) mt[i] = fmaxf(mt[i], strip_max[w * kStrip + g + 8 * i]);
      }
      float alpha[2], m_safe[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], mt[i]);
        m_safe[i] = m_new == -INFINITY ? 0.f : m_new;
        alpha[i] = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe[i]);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < kNTw; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2;
          s[n][e] = expf(s[n][e] - m_safe[i]);   // masked: exp(-inf) = 0
          l[i] += s[n][e];
        }
      }

      // ---- O = alpha O + P V over the columns this warp owns ----
      Frag<4> pa[kNT];
      if constexpr (kWide) {
        *reinterpret_cast<float2*>(strip_p + g * kPs + part * 8 + 2 * t) =
            make_float2(s[0][0], s[0][1]);
        *reinterpret_cast<float2*>(strip_p + (g + 8) * kPs + part * 8 + 2 * t) =
            make_float2(s[0][2], s[0][3]);
        __syncthreads();
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const float2 lo = *reinterpret_cast<const float2*>(strip_p + g * kPs + n * 8 + 2 * t);
          const float2 hi =
              *reinterpret_cast<const float2*>(strip_p + (g + 8) * kPs + n * 8 + 2 * t);
          pa[n] = acc_as_a(lo.x, lo.y, hi.x, hi.y);
        }
      } else {
#pragma unroll
        for (int n = 0; n < kNT; ++n) pa[n] = acc_as_a(s[n][0], s[n][1], s[n][2], s[n][3]);
      }
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        float part_sum[4] = {0.f, 0.f, 0.f, 0.f};
        const int col = (c0 + j) * 8 + g;
#pragma unroll
        for (int n = 0; n < (FLASH_FWD_PV ? kNT : 0); ++n) {
          Frag<2> f = load_bn(vs, p.kse, n * 8 + 2 * t, col);
          prepare<kF32>(f);
          mma3<true, kF32>(part_sum, pa[n], f);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = fmaf(acc[j][e], alpha[e / 2], part_sum[e]);
      }
    }
    __syncthreads();   // this buffer is refilled at the next tile
  }

  // ---- finalize: out = O / l, lse = m + log(l); empty rows -> 0, -inf ----
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = quad_sum(l[i]);
  if constexpr (kWide) {   // the strip's row sums over its 4 warps' keys
    if (t == 0) {
      strip_sum[part * kStrip + g] = l[0];
      strip_sum[part * kStrip + g + 8] = l[1];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = 0.f;
#pragma unroll
      for (int w = 0; w < kNT; ++w) l[i] += strip_sum[w * kStrip + g + 8 * i];
    }
  }
  T* og = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = qa + g + 8 * i;
    if (qpos >= p.Tq) continue;
    const bool empty = l[i] == 0.f;
    const float l_safe = empty ? 1.f : l[i];   // an empty row's O is 0
    T* row = og + (((int64_t)b * p.Tq + qpos) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < NA; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = (c0 + j) * 8 + 2 * t + e;
        if (d < D) store_from_f32(row + d, acc[j][2 * i + e] / l_safe);
      }
    }
    if (t == 0 && part == 0) {
      p.lse[((int64_t)b * p.H + h) * p.Tq + qpos] = empty ? -INFINITY : m[i] + logf(l_safe);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Dynamic shared memory of a block: block_q rows of Q, two buffers of block_k
// rows of K and of V, room for reads past the last row's D, and for wide heads
// each of the (at most 2) strips' P buffer, row maxima and row sums.
// kernels/flash_attention.py:fwd_shared_bytes sizes the tiles by the same
// formula; chip_smoke.py and the card tests hold the two equal through
// flash_attention_fwd_shared_bytes.
size_t shared_bytes(int D, int elem, int block_q, int block_k) {
  size_t n = (size_t)elem * ((size_t)row_stride(D, elem) * (block_q + 4 * block_k) + kOverrun);
  if (is_wide(D)) n += sizeof(float) * kMaxWideStrips * kStrip * (kPs + 2 * kNT);
  return n;
}

template <typename T, int NA, bool kWide>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = shared_bytes(p.D, (int)sizeof(T), p.block_q, p.block_k);
  auto kernel = flash_fwd_kernel<T, NA, kWide>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B, (p.Tq + p.block_q - 1) / p.block_q);
  const dim3 block((p.block_q / kStrip) * (kWide ? kNT : 1) * kWarp);
  kernel<<<grid, block, smem, stream>>>(p);
  return cudaGetLastError();
}

// Accumulator widths compiled, in chunks of 8 columns per warp: the smallest
// that covers the warp's share of D.
template <typename T>
cudaError_t dispatch_width(const Params& p, cudaStream_t stream) {
  if (!is_wide(p.D)) {
    if (p.dc <= 2) return launch<T, 2, false>(p, stream);
    if (p.dc <= 4) return launch<T, 4, false>(p, stream);
    if (p.dc <= 8) return launch<T, 8, false>(p, stream);
    return launch<T, kMaxWidth, false>(p, stream);
  }
  const int need = (p.dc + kNT - 1) / kNT;
  if (need <= 4) return launch<T, 4, true>(p, stream);
  if (need <= 6) return launch<T, 6, true>(p, stream);
  if (need <= 8) return launch<T, 8, true>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  block_q is a
// multiple of 16 up to 64 (32 for D > 80), block_k a positive multiple of 32.  Returns a
// cudaError_t (0 on success); nothing is synchronised.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                        void* lse, int dtype, int B, int Tq, int Tk, int H,
                        int KV, int D, long long q_sb, long long q_st,
                        long long q_sh, long long k_sb, long long k_st,
                        long long k_sh, long long v_sb, long long v_st,
                        long long v_sh, float scale, int causal, int window,
                        int block_q, int block_k, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || KV < 1 || H % KV != 0 || D < 1 ||
      D > kMaxD || block_q < kStrip || block_q % kStrip != 0 ||
      block_q / kStrip > (is_wide(D) ? kMaxWideStrips : kMaxStrips) ||
      block_k < kStep || block_k % kStep != 0 ||
      B > 65535 || (Tq + block_q - 1) / block_q > 65535 || window < 0 ||
      (dtype != 0 && dtype != 1)) {
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
  p.dp = (D + 7) / 8 * 8;
  p.dc = p.dp / 8;
  const int elem = dtype == 0 ? 4 : 2;
  p.kse = row_stride(D, elem);
  const void* staged[3] = {q, k, v};
  const int64_t* st[3] = {&p.q_sb, &p.k_sb, &p.v_sb};
  p.vec = 16;
  for (int i = 0; i < 3; ++i) {
    if (!aligned(staged[i], st[i], elem, 16)) p.vec = p.vec < 4 ? p.vec : 4;
    if (!aligned(staged[i], st[i], elem, 4)) p.vec = 2;
  }
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_width<float>(p, stm);
  return (int)dispatch_width<__nv_bfloat16>(p, stm);
}

// Dynamic shared memory in bytes of one block at these tiles.
long long flash_attention_fwd_shared_bytes(int dtype, int D, int block_q, int block_k) {
  return (long long)shared_bytes(D, dtype == 0 ? 4 : 2, block_q, block_k);
}

const char* flash_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
