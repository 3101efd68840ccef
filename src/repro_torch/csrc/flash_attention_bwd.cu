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
// 3 products of length D (S, dP, dQ) and the dkv kernel 4 (S, dP, dV, dK): at
// the gpt-2b training shape (T = 1024, D = 80, causal, f32) ~30 and ~40
// operations per byte, so both are bound by operations.  On the CUDA cores the
// ceiling is 67 TFLOP/s.  The tensor cores' TF32 mode keeps 10 mantissa bits,
// too few for the f32 gradient tolerance (atol 5e-5, rtol 1e-3), but three
// TF32 products per f32 product (3xTF32: x = big + small with big = tf32(x),
// small = tf32(x - big); a.b ~ small.big + big.small + big.big, the small.small
// term dropped) keep f32 accuracy at a third of the 495 TFLOP/s TF32 rate: a
// 165 TFLOP/s ceiling.  bf16 values are exact in TF32 (8 mantissa bits of 10),
// so with bf16 inputs S and dP take one product and dQ, dK, dV two (only P or
// dS is split).
//
// What the design does about it.  Every product is mma.sync.m16n8k8 (TF32
// in, f32 accumulators); a warp owns a 16-row strip (the m16 of the mma).
//   * dq: one block per (b, h, block_rows query rows: block_rows / 16 warps);
//     Q and dO are staged once; a loop over K/V tiles of kTile = 32 keys.  S
//     and dP land in mma accumulators (32 keys per warp), P and dS are
//     computed in that layout with the masks per element (skipped on tiles
//     the masks leave whole), and dQ += dS.K takes dS straight from the
//     accumulators: an accumulator holds columns 2t, 2t+1 of its row, the A
//     operand wants columns t, t+4, so the sum over k runs in the permuted
//     order (k = t -> key 2t, k = t + 4 -> key 2t + 1) and K's fragment is
//     read from rows 2t, 2t + 1 to match.  Nothing goes through shared
//     memory.  S and dP sum over d in the same permuted order, so each
//     fragment is two adjacent values, one 8-byte load.  delta is a warp
//     reduction per row, before the loop.
//   * dkv: one block per (b, kv head, block_rows keys); K and V staged once; a
//     loop over the group's query heads and Q/dO tiles of kTile rows with
//     their lse and delta.  S^T and dP^T land in accumulators, P^T and dS^T
//     feed dV += P^T.dO and dK += dS^T.Q from registers as above.  The group
//     sum happens in the f32 accumulators: no atomics, so every launch gives
//     the same bits.
//   * The streamed tiles (K/V in dq; Q/dO, lse, delta in dkv) are loaded with
//     cp.async into two buffers: tile t + 1 is in flight while tile t is
//     computed.  16-byte copies where every row starts 16-byte aligned, else
//     4-byte copies (a D not a multiple of 4, or odd strides), else (bf16 rows
//     on odd element strides) plain loads; the tail of a row past D is filled
//     with zeros up to a multiple of 8.  Tiles stay f32 in shared memory and
//     an operand is split when its fragment is loaded: splitting each landed
//     tile once into a second (small) copy measured slower on an H100 (a third
//     buffer, one more barrier per step), and a split copy of the stationary
//     side would leave room for one block per SM only.  P and dS are split
//     once, in registers.  The row stride in 4-byte words is 4 mod 8, so the
//     scalar fragment pattern (rows 2t, columns g) hits 32 distinct banks and
//     the paired one (rows g, columns 2t, 2t + 1) at most two ways.
//   * Each tile's contribution to dQ, dK, dV is summed from zero and added to
//     the running f32 sum outside the mma: the tensor cores truncate the
//     addends they align, so a sum carried inside the mma across hundreds of
//     tiles drifts with its length.
//   * A warp's accumulators cover NA chunks of 8 columns of D (NA a template
//     argument), up to 10 (D <= 80).  Wider heads (gemma's 256, zamba2's 112)
//     take the wide kernels: the 4 warps of a strip share it, each computing
//     one n8 tile of S and dP over all of D and passing its P / dS through a
//     small shared buffer, then summing a quarter of D's columns of the
//     output over the whole tile.  S and dP are computed once per pair at
//     any D.  Tiles wholly outside the causal or window band are never
//     loaded.  The longest causal rows are launched first.

#include <type_traits>

#include "flash_mma.cuh"

namespace {

// Compile-time switches for scripts/torch_flash_bwd_variants.py, which times
// the kernels with one part taken out or one shape changed (the gradients are
// then wrong).  The defaults are the kernels as they run.
#ifndef FLASH_BWD_MAX_WARPS
#define FLASH_BWD_MAX_WARPS 4
#endif
#ifndef FLASH_BWD_TILE
#define FLASH_BWD_TILE 32
#endif
#ifndef FLASH_BWD_SCORES          // 0: no S and dP products
#define FLASH_BWD_SCORES 1
#endif
#ifndef FLASH_BWD_OUT_PRODUCTS    // 0: no dQ, dK, dV products
#define FLASH_BWD_OUT_PRODUCTS 1
#endif
#ifndef FLASH_BWD_COMPENSATION    // 0: every 3xTF32 product as big.big alone
#define FLASH_BWD_COMPENSATION 1
#endif

constexpr int kMaxWarps = FLASH_BWD_MAX_WARPS;  // strips (a warp each) per block: 64 rows
constexpr int kMinBlocks = 2;  // blocks per SM the tiles are sized for (bwd_blocks)
constexpr int kTile = FLASH_BWD_TILE;           // rows of the streamed side per step
constexpr int kNT = kTile / 8; // n8 tiles of S per strip; warps per strip when wide
constexpr int kMaxWideStrips = 2;  // strips per block when wide: 256 threads
constexpr int kPs = kTile + 8; // row stride (floats) of a wide strip's P / dS buffer
constexpr int kStrides = 15;   // (batch, seq, head) strides of q, k, v, out, dout

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
  int block_rows;   // rows owned by the warps of one block (16 per warp)
  int dp;           // D rounded up to a multiple of 8 (rows zero padded)
  int dc;           // dp / 8: k chunks of S and dP
  int kse;          // shared row stride in elements (4 mod 8 in 4-byte words)
  int vec;          // copy width of the staged rows: 16, 4 or 2 bytes
  int elem;         // bytes per element: 4 (f32) or 2 (bf16)
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// c += a.b with a (b) split when kSA (kSB): small.big and big.small first,
// then big.big, all into the f32 accumulators.
template <bool kSA, bool kSB>
__device__ __forceinline__ void mma3(float (&c)[4], const Frag<4>& a, const Frag<2>& b) {
  if (kSA && FLASH_BWD_COMPENSATION) mma(c, a.small, b.big);
  if (kSB && FLASH_BWD_COMPENSATION) mma(c, a.big, b.small);
  mma(c, a.big, b.big);
}

// acc += A.Y over one tile: A the kTile columns of P or dS in fragments (the
// permuted k order), Y the tile's kTile shared rows (split at load when
// kSplitY), for the NA chunks of 8 output columns from chunk c0 that this
// warp owns.  Each chunk's tile sum starts from zero and is added to acc in f32.
// Chunks past D read whatever follows the row in shared memory (their sums
// are never stored; the allocation has room for the last row's overrun), so
// no branch or clamp separates the NA products of a step.
template <bool kSplitY, int NA, typename T>
__device__ __forceinline__ void accumulate_tile(float (&acc)[NA][4], const Frag<4> (&a)[kNT],
                                                const T* y, const Params& p, int c0, int g,
                                                int t) {
  if (!FLASH_BWD_OUT_PRODUCTS) return;
  float part[NA][4];
#pragma unroll
  for (int j = 0; j < NA; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      const int col = (c0 + j) * 8 + g;
      Frag<2> f = load_bn(y, p.kse, n * 8 + 2 * t, col);
      prepare<kSplitY>(f);
      mma3<true, kSplitY>(part[j], a[n], f);
    }
  }
#pragma unroll
  for (int j = 0; j < NA; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
}

// S = X1.Y1^T and dP = X2.Y2^T for NT n8 tiles from tile n0, over all chunks
// of d, in one loop: X stationary and Y a streamed tile, both split at load
// when kSplit.
template <int NT, bool kSplit, typename T>
__device__ __forceinline__ void scores(float (&s)[NT][4], float (&dp)[NT][4],
                                       const T* x1, const T* y1, const T* x2, const T* y2,
                                       const Params& p, int r, int n0, int g, int t) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
  for (int kc = 0; kc < (FLASH_BWD_SCORES ? p.dc : 0); ++kc) {
    const int c = kc * 8 + 2 * t;
    Frag<4> xa = load_a(x1, p.kse, r, c);
    Frag<4> xb = load_a(x2, p.kse, r, c);
    prepare<kSplit>(xa);
    prepare<kSplit>(xb);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      Frag<2> ya = load_bt(y1, p.kse, (n0 + n) * 8 + g, c);
      Frag<2> yb = load_bt(y2, p.kse, (n0 + n) * 8 + g, c);
      prepare<kSplit>(ya);
      prepare<kSplit>(yb);
      mma3<kSplit, kSplit>(s[n], xa, ya);
      mma3<kSplit, kSplit>(dp[n], xb, yb);
    }
  }
}

// Wide heads: each warp of a strip computes one n8 tile of P or dS and passes
// it to the others through the strip's [kStrip][kPs] f32 buffer.
__device__ __forceinline__ void stash(float* buf, const float (&c)[4], int n, int g, int t) {
  *reinterpret_cast<float2*>(buf + g * kPs + n * 8 + 2 * t) = make_float2(c[0], c[1]);
  *reinterpret_cast<float2*>(buf + (g + 8) * kPs + n * 8 + 2 * t) = make_float2(c[2], c[3]);
}

// The A fragments of the kNT n8 tiles of P or dS: from the warp's own
// accumulators, or when kWide from the strip's buffer (filled by stash, then
// a barrier).
template <bool kWide, int NT>
__device__ __forceinline__ void a_frags(Frag<4> (&a)[kNT], const float (&c)[NT][4],
                                        const float* buf, int g, int t) {
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    if constexpr (kWide) {
      const float2 lo = *reinterpret_cast<const float2*>(buf + g * kPs + n * 8 + 2 * t);
      const float2 hi = *reinterpret_cast<const float2*>(buf + (g + 8) * kPs + n * 8 + 2 * t);
      a[n] = acc_as_a(lo.x, lo.y, hi.x, hi.y);
    } else {
      a[n] = acc_as_a(c[n][0], c[n][1], c[n][2], c[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// dq: grid (ceil(Tq / block_rows), H, B)
// ---------------------------------------------------------------------------

template <typename T, int NA, bool kWide>
__global__ void __launch_bounds__(kWide ? kWarp * kNT * kMaxWideStrips : kWarp * kMaxWarps,
                                  kWide ? 1 : kMinBlocks)
flash_bwd_dq_kernel(const Params p) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kNTw = kWide ? 1 : kNT;         // n8 tiles of S a warp computes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);       // [block_rows][kse]
  T* gs = qs + p.block_rows * p.kse;            // [block_rows][kse]  dout
  T* kt = gs + p.block_rows * p.kse;            // [2][kTile][kse]
  T* vt = kt + 2 * kTile * p.kse;               // [2][kTile][kse]
  float* dsb = reinterpret_cast<float*>(vt + 2 * kTile * p.kse);  // wide: [strips][kStrip][kPs]

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int g = lane / 4, t = lane % 4;
  const int strip = kWide ? warp / kNT : warp;  // the warp's 16 rows of the block
  const int part = kWide ? warp % kNT : 0;      // wide: its n8 tile of S, its share of D
  const int c0 = part * NA;                     // first chunk of 8 columns it owns
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = h / (p.H / p.KV);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * p.block_rows;  // the longest causal rows first
  const int D = p.D;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const T* og = static_cast<const T*>(p.out) + b * p.o_sb + h * p.o_sh;
  const T* gg = static_cast<const T*>(p.dout) + b * p.g_sb + h * p.g_sh;

  // Key range this query tile can see.
  const int q_last = min(q0 + p.block_rows, p.Tq) - 1;
  const int kv_hi = p.causal ? min(p.Tk, q_last + 1) : p.Tk;
  int kv_lo = p.window ? max(0, q0 - p.window + 1) : 0;
  kv_lo = (kv_lo / kTile) * kTile;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + kTile - 1) / kTile : 0;

  stage_rows(qs, qg, p.q_st, q0, p.block_rows, p.Tq, p);
  stage_rows(gs, gg, p.g_st, q0, p.block_rows, p.Tq, p);
  if (n_tiles > 0) {
    stage_rows(kt, kg, p.k_st, kv_lo, kTile, p.Tk, p);
    stage_rows(vt, vg, p.v_st, kv_lo, kTile, p.Tk, p);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // lse and delta of this lane's rows g and g + 8 (a -inf row keeps P = 0).
  const int r0 = strip * kStrip;
  float dlt[2] = {0.f, 0.f}, lse[2];
  for (int r = 0; r < kStrip; ++r) {
    const int qpos = q0 + r0 + r;
    float part_sum = 0.f;
    if (qpos < p.Tq) {
      for (int d = lane; d < D; d += kWarp) {
        part_sum = fmaf(load_f32(gs + (r0 + r) * p.kse + d),
                        load_f32(og + qpos * p.o_st + d), part_sum);
      }
    }
    const float sum = warp_sum(part_sum);
    const int64_t li = ((int64_t)b * p.H + h) * p.Tq + qpos;
    if (qpos < p.Tq && lane == 0 && part == 0) p.delta[li] = sum;
    if (r == g) dlt[0] = sum;
    if (r == g + 8) dlt[1] = sum;
  }
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = q0 + r0 + g + 8 * i;
    lse[i] = qpos < p.Tq ? p.lse[((int64_t)b * p.H + h) * p.Tq + qpos] : -INFINITY;
    live[i] = lse[i] != -INFINITY;
  }

  float acc[NA][4];
#pragma unroll
  for (int j = 0; j < NA; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float* strip_ds = dsb + strip * kStrip * kPs;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    const int t0 = kv_lo + it * kTile;
    if (it + 1 < n_tiles) {   // the next tile flies while this one is computed
      stage_rows(kt + (buf ^ 1) * kTile * p.kse, kg, p.k_st, t0 + kTile, kTile, p.Tk, p);
      stage_rows(vt + (buf ^ 1) * kTile * p.kse, vg, p.v_st, t0 + kTile, kTile, p.Tk, p);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* kb = kt + buf * kTile * p.kse;
    const T* vb = vt + buf * kTile * p.kse;

    // ---- S = Q K^T and dP = dO V^T: 16 rows x this warp's keys ----
    float s[kNTw][4], dpv[kNTw][4];
    scores<kNTw, kF32>(s, dpv, qs, kb, gs, vb, p, r0 + g, part, g, t);

    // ---- P and dS, in place of S ----
    const bool whole = all_visible(p, q0 + r0, q0 + r0 + kStrip - 1, t0, t0 + kTile - 1);
#pragma unroll
    for (int n = 0; n < kNTw; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        const bool ok = live[i] && (whole || visible(p, q0 + r0 + g + 8 * i,
                                                     t0 + (part + n) * 8 + 2 * t + e % 2));
        const float pv = ok ? expf(s[n][e] * p.scale - lse[i]) : 0.f;
        s[n][e] = pv * (dpv[n][e] - dlt[i]) * p.scale;
      }
    }
    // ---- dQ += dS K over the columns this warp owns ----
    if constexpr (kWide) {
      stash(strip_ds, s[0], part, g, t);
      __syncthreads();
    }
    Frag<4> da[kNT];
    a_frags<kWide>(da, s, strip_ds, g, t);
    accumulate_tile<kF32>(acc, da, kb, p, c0, g, t);
    __syncthreads();   // this buffer is refilled at the next step
  }

  T* dqg = static_cast<T*>(p.dq);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int qpos = q0 + r0 + g + 8 * (e / 2);
    if (qpos >= p.Tq) continue;
    T* row = dqg + (((int64_t)b * p.Tq + qpos) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      const int d = (c0 + j) * 8 + 2 * t + e % 2;
      if (d < D) store_from_f32(row + d, acc[j][e]);
    }
  }
}

// ---------------------------------------------------------------------------
// dk, dv: grid (ceil(Tk / block_rows), KV, B)
// ---------------------------------------------------------------------------

template <typename T, int NA, bool kWide>
__global__ void __launch_bounds__(kWide ? kWarp * kNT * kMaxWideStrips : kWarp * kMaxWarps,
                                  kWide ? 1 : kMinBlocks)
flash_bwd_dkv_kernel(const Params p) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kNTw = kWide ? 1 : kNT;         // n8 tiles of S^T a warp computes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kt = reinterpret_cast<T*>(smem_raw);       // [block_rows][kse]
  T* vt = kt + p.block_rows * p.kse;            // [block_rows][kse]
  T* qs = vt + p.block_rows * p.kse;            // [2][kTile][kse]
  T* gs = qs + 2 * kTile * p.kse;               // [2][kTile][kse]  dout
  float* ls = reinterpret_cast<float*>(gs + 2 * kTile * p.kse);   // [2][kTile] lse
  float* dl = ls + 2 * kTile;                                     // [2][kTile] delta
  float* pb = dl + 2 * kTile;          // wide: [strips][2][kStrip][kPs] P^T, dS^T

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int g = lane / 4, t = lane % 4;
  const int strip = kWide ? warp / kNT : warp;  // the warp's 16 keys of the block
  const int part = kWide ? warp % kNT : 0;      // wide: its n8 tile of S^T, its share of D
  const int c0 = part * NA;                     // first chunk of 8 columns it owns
  const int b = blockIdx.z;
  const int hk = blockIdx.y;
  const int rep = p.H / p.KV;
  const int k0 = blockIdx.x * p.block_rows;     // causal: the longest first
  const int D = p.D;

  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // Query range these keys are visible to; one step per (query head, tile).
  const int k_last = min(k0 + p.block_rows, p.Tk) - 1;
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi = p.window ? min(p.Tq, k_last + p.window) : p.Tq;
  const int per_head = q_hi > q_lo ? (q_hi - q_lo + kTile - 1) / kTile : 0;
  const int n_steps = rep * per_head;

  // Stage the Q/dO tile (with its lse and delta) of step `it` into buffer `buf`.
  auto stage_step = [&](int it, int buf) {
    const int h = hk * rep + it / per_head;
    const int t0 = q_lo + (it % per_head) * kTile;
    const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* gg = static_cast<const T*>(p.dout) + b * p.g_sb + h * p.g_sh;
    stage_rows(qs + buf * kTile * p.kse, qg, p.q_st, t0, kTile, p.Tq, p);
    stage_rows(gs + buf * kTile * p.kse, gg, p.g_st, t0, kTile, p.Tq, p);
    const int64_t lrow = ((int64_t)b * p.H + h) * p.Tq;
    for (int e = threadIdx.x; e < 2 * kTile; e += blockDim.x) {
      const int r = e % kTile;
      const bool in = t0 + r < p.Tq;
      const float* src = (e < kTile ? p.lse : p.delta) + (in ? lrow + t0 + r : 0);
      cp_async4((e < kTile ? ls : dl) + buf * kTile + r, src, in ? 4 : 0);
    }
  };

  stage_rows(kt, kg, p.k_st, k0, p.block_rows, p.Tk, p);
  stage_rows(vt, vg, p.v_st, k0, p.block_rows, p.Tk, p);
  if (n_steps > 0) stage_step(0, 0);
  cp_commit();

  const int r0 = strip * kStrip;
  float adk[NA][4], adv[NA][4];
#pragma unroll
  for (int j = 0; j < NA; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[j][e] = adv[j][e] = 0.f;
  float* strip_p = pb + strip * 2 * kStrip * kPs;
  float* strip_ds = strip_p + kStrip * kPs;

  for (int it = 0; it < n_steps; ++it) {
    const int buf = it & 1;
    const int t0 = q_lo + (it % per_head) * kTile;
    if (it + 1 < n_steps) {   // the next tile flies while this one is computed
      stage_step(it + 1, buf ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* qb = qs + buf * kTile * p.kse;
    const T* gb = gs + buf * kTile * p.kse;
    const float* lb = ls + buf * kTile;
    const float* db = dl + buf * kTile;

    // ---- S^T = K Q^T and dP^T = V dO^T: 16 keys x this warp's queries ----
    float s[kNTw][4], dpv[kNTw][4];
    scores<kNTw, kF32>(s, dpv, kt, qb, vt, gb, p, r0 + g, part, g, t);

    // ---- P^T and dS^T, in place of S^T and dP^T ----
    const bool whole = all_visible(p, t0, t0 + kTile - 1, k0 + r0, k0 + r0 + kStrip - 1);
#pragma unroll
    for (int n = 0; n < kNTw; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = (part + n) * 8 + 2 * t + e % 2;
        const float lq = lb[col];
        const bool ok = lq != -INFINITY &&
                        (whole || visible(p, t0 + col, k0 + r0 + g + 8 * (e / 2)));
        const float pv = ok ? expf(s[n][e] * p.scale - lq) : 0.f;
        s[n][e] = pv;
        dpv[n][e] = pv * (dpv[n][e] - db[col]) * p.scale;
      }
    }
    // ---- dV += P^T dO, then dK += dS^T Q, over the columns this warp owns ----
    if constexpr (kWide) {
      stash(strip_p, s[0], part, g, t);
      stash(strip_ds, dpv[0], part, g, t);
      __syncthreads();
    }
    Frag<4> fa[kNT];
    a_frags<kWide>(fa, s, strip_p, g, t);
    accumulate_tile<kF32>(adv, fa, gb, p, c0, g, t);
    a_frags<kWide>(fa, dpv, strip_ds, g, t);
    accumulate_tile<kF32>(adk, fa, qb, p, c0, g, t);
    __syncthreads();   // this buffer is refilled at the next step
  }
  if (n_steps == 0) cp_wait<0>();   // nothing in flight at exit

  T* dkg = static_cast<T*>(p.dk);
  T* dvg = static_cast<T*>(p.dv);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int kpos = k0 + r0 + g + 8 * (e / 2);
    if (kpos >= p.Tk) continue;
    const int64_t off = (((int64_t)b * p.Tk + kpos) * p.KV + hk) * D;
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      const int d = (c0 + j) * 8 + 2 * t + e % 2;
      if (d < D) {
        store_from_f32(dkg + off + d, adk[j][e]);
        store_from_f32(dvg + off + d, adv[j][e]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

enum Which { kDq = 0, kDkv = 1 };

// Dynamic shared memory of a kernel: two stationary tensors of block_rows,
// two double-buffered streamed ones of kTile rows, for dkv the lse and delta
// buffers, for wide heads each strip's P / dS buffers (dkv: both), and room
// for reads past the last row's D.
// kernels/flash_attention.py:bwd_shared_bytes sizes the blocks by the same
// formula; chip_smoke.py and the card tests hold the two equal through
// flash_attention_bwd_shared_bytes.
size_t shared_bytes(Which which, int D, int elem, int block_rows) {
  size_t n = (size_t)elem * (row_stride(D, elem) * (2 * block_rows + 4 * kTile) + kOverrun);
  if (which == kDkv) n += sizeof(float) * 4 * kTile;
  if (is_wide(D)) n += sizeof(float) * block_rows * kPs * (which == kDkv ? 2 : 1);
  return n;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, Which which, bool wide, const Params& p,
                   cudaStream_t stream) {
  const size_t smem = shared_bytes(which, p.D, p.elem, p.block_rows);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int len = which == kDq ? p.Tq : p.Tk;
  const dim3 grid((len + p.block_rows - 1) / p.block_rows, which == kDq ? p.H : p.KV, p.B);
  const dim3 block((p.block_rows / kStrip) * (wide ? kNT : 1) * kWarp);
  kernel<<<grid, block, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int NA, bool kWide>
cudaError_t launch_width(Which which, const Params& p, cudaStream_t stream) {
  if (which == kDq) return launch(flash_bwd_dq_kernel<T, NA, kWide>, which, kWide, p, stream);
  return launch(flash_bwd_dkv_kernel<T, NA, kWide>, which, kWide, p, stream);
}

// Accumulator widths compiled, in chunks of 8 columns per warp: the smallest
// that covers the warp's share of D.
template <typename T>
cudaError_t dispatch_width(Which which, const Params& p, cudaStream_t stream) {
  if (!is_wide(p.D)) {
    if (p.dc <= 2) return launch_width<T, 2, false>(which, p, stream);
    if (p.dc <= 4) return launch_width<T, 4, false>(which, p, stream);
    if (p.dc <= 8) return launch_width<T, 8, false>(which, p, stream);
    return launch_width<T, kMaxWidth, false>(which, p, stream);
  }
  const int need = (p.dc + kNT - 1) / kNT;
  if (need <= 4) return launch_width<T, 4, true>(which, p, stream);
  if (need <= 6) return launch_width<T, 6, true>(which, p, stream);
  if (need <= 8) return launch_width<T, 8, true>(which, p, stream);
  return cudaErrorInvalidValue;
}

int run(Which which, const void* q, const void* k, const void* v, const void* out,
        const void* dout, const void* lse, void* delta, void* dq, void* dk, void* dv,
        int dtype, int B, int Tq, int Tk, int H, int KV, int D,
        const long long* strides, float scale, int causal, int window,
        int block_rows, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || KV < 1 || H % KV != 0 || D < 1 ||
      D > kMaxD || block_rows < kStrip || block_rows % kStrip != 0 ||
      block_rows / kStrip > (is_wide(D) ? kMaxWideStrips : kMaxWarps) || B > 65535 ||
      H > 65535 || window < 0 || (dtype != 0 && dtype != 1)) {
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
  p.block_rows = block_rows;
  p.dp = (D + 7) / 8 * 8;
  p.dc = p.dp / 8;
  const int elem = p.elem = dtype == 0 ? 4 : 2;
  p.kse = row_stride(D, elem);
  // q, k, v and dout are staged (out is read in place)
  const void* staged[4] = {q, k, v, dout};
  const int64_t* st[4] = {&p.q_sb, &p.k_sb, &p.v_sb, &p.g_sb};
  p.vec = 16;
  for (int i = 0; i < 4; ++i) {
    if (!aligned(staged[i], st[i], elem, 16)) p.vec = p.vec < 4 ? p.vec : 4;
    if (!aligned(staged[i], st[i], elem, 4)) p.vec = 2;
  }
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_width<float>(which, p, stm);
  return (int)dispatch_width<__nv_bfloat16>(which, p, stm);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  `strides` holds 15 element strides:
// (batch, seq, head) of q, k, v, out and dout.  Both entry points take the
// same arguments; the dq kernel writes delta and dq, the dkv kernel reads
// delta and writes dk and dv, so launch dq first.  block_rows is a multiple
// of 16 up to 64.  Each returns a cudaError_t (0 on success); nothing is
// synchronised.
#define BWD_ARGS                                                              \
  const void *q, const void *k, const void *v, const void *out,               \
      const void *dout, const void *lse, void *delta, void *dq, void *dk,     \
      void *dv, int dtype, int B, int Tq, int Tk, int H, int KV, int D,       \
      const long long *strides, float scale, int causal, int window,          \
      int block_rows, void *stream
#define BWD_PASS                                                              \
  q, k, v, out, dout, lse, delta, dq, dk, dv, dtype, B, Tq, Tk, H, KV, D,     \
      strides, scale, causal, window, block_rows, stream

int flash_attention_bwd_dq(BWD_ARGS) { return run(kDq, BWD_PASS); }

int flash_attention_bwd_dkv(BWD_ARGS) { return run(kDkv, BWD_PASS); }

// Dynamic shared memory in bytes of one block of the dq (dkv = 0) or the dk/dv
// kernel (dkv = 1).
long long flash_attention_bwd_shared_bytes(int dkv, int dtype, int D, int block_rows) {
  return (long long)shared_bytes(dkv ? kDkv : kDq, D, dtype == 0 ? 4 : 2, block_rows);
}

const char* flash_attention_bwd_dq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

const char* flash_attention_bwd_dkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
