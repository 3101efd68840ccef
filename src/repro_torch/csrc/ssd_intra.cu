// Mamba-2 SSD intra-chunk term for Hopper (sm_90a), CUDA C++ with a plain C ABI.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:ssd_intra (body
// _ssd_intra_kernel).  Contract, identical to that kernel's, all float32:
//   x (B, nc, Q, H, P), dt and cum (B, nc, Q, H), Bm and Cm (B, nc, Q, N),
//   read in the model layout through strides (the last dim of x, Bm and Cm
//   contiguous); y (B, nc, Q, H, P) contiguous;
//   y[q, :] = sum_{j <= q} (C_q . B_j) * exp(cum_q - cum_j) * dt_j * x_j
//   per (batch, chunk, head).
// Unlike the TPU kernel, exp is taken only of cum_q - cum_j with j <= q: the
// exponent is set to -inf above the diagonal before exp.  There that
// difference is a positive sum of dt's: at mamba2's chunk of 256 it reaches
// ~200 and exp overflows to inf, and inf * 0 = NaN would follow.
//
// What bounds it on an H100.  Per (b, c) the necessary work is C B^T once
// (2N operations per pair j <= q) and M x per head (2P per pair and head):
// Q(Q+1)/2 * (2N + 2PH) operations against 4 bytes * Q (2HP + 2H + 2N) of
// input and output, i.e. ~Q/8 operations per byte at mamba2's sizes (N 128,
// P 64, H 80): 32 at Q = 256.  On the CUDA cores (67 TFLOP/s, ridge ~20
// operations per byte) that is bound by operations.  On the tensor cores in
// TF32 with three products per f32 product (3xTF32, 495 / 3 = 165 TFLOP/s,
// ridge ~49) it is bound by bytes: x read and y written once, 0.104 ms at
// the training shape (8, 4, 256, 80, 64, 128) at 3.35 TB/s, against 0.067 ms
// of 3xTF32 operations.
//
// What the design does about it (the pattern of flash_attention_fwd.cu; the
// two share flash_mma.cuh's fragments and staging).  The effects quoted are
// times at the training shape on an H100 from scripts/torch_ssd_variants.py
// and scripts/torch_ssd_trees.py, run on this source as it evolved.
//   * Both products run on the tensor cores as mma.sync.m16n8k8 TF32 with f32
//     accumulators, each f32 product as 3xTF32 (x = big + small, small.big +
//     big.small + big.big), which keeps f32 accuracy.  Each product is summed
//     from zero over 32 keys (M x) or 32 state columns (C B^T) and added to
//     the running f32 sum: a sum carried inside the mma over many steps
//     drifts, as it did in the flash kernels.  big is rounded to TF32 by
//     integer operations and small is left to the mma, which reads a TF32
//     operand's top 19 bits: cvt.rna compiled to a compare and a predicated
//     add per value, serialised through one predicate register (~5 % of the
//     kernel when it split every operand).  The products are not what bounds
//     it: built with one TF32 product per product it is no faster.
//   * A block owns a whole chunk of one (b, c) for a group of heads: 16 warps,
//     one 16-row strip of queries each (the m16 of the mma).  Every tile of x
//     is read from device memory once per head and used by every strip that
//     sees it.  A first design gave a block 64 query rows (4 warps, 2 blocks
//     per SM, as the CUDA-core kernel did): each x tile was read again by
//     every query tile at or below it, 2.5x at Q = 256, and its copies alone,
//     without a product, took a third of its ~1.1 ms.  Head groups are
//     chosen against the SMs: one block per SM (512 threads at up to 128
//     registers), as many groups as fill whole waves (4 groups of 20 heads at
//     the training shape, 8 of 10 at prefill: 128 blocks).
//   * C B^T once per block (phase 1), kept in shared memory for every head of
//     the group, each strip's rows only up to its last key (16 (s + 1) keys,
//     a row stride of 8 mod 32 floats: its 8-byte fragment loads are
//     conflict-free): the TPU kernel recomputes the Q x Q product per head
//     (grid (B, nc, H)), 2.9x the necessary work at mamba2's sizes.  It runs
//     in row groups of 64 (C staged once per group) over B tiles of 32 keys,
//     one (strip, 8 keys) tile per warp; C held in registers instead spilled.
//   * M is built in registers, directly in the A-fragment layout of the M x
//     product, in the permuted k order of flash_mma.cuh (key 2t is k = t,
//     key 2t + 1 is k = t + 4): per fragment element CB from shared memory
//     (one 8-byte load per row pair), exp(masked cum_q - cum_j) and dt_j (one
//     16-byte load of (cum, dt) for the lane's two keys), then split.  M never
//     goes through shared memory.
//   * x arrives by cp.async in tiles of 32 keys x 64 columns (two passes for
//     P > 64) through a ring of 4 buffers, each key's cum and dt beside it:
//     the next tiles, the next head's first ones included, load while the
//     current one is multiplied.  16-byte copies where every row of x (of C,
//     of B) starts 16-byte aligned, else 4-byte copies; the zero fill past
//     Q, P and N is the copies' own.  Each landed tile is split once into
//     (big, small) pairs for every strip, two rows per 16-byte slot, so that
//     a B fragment of M x is one conflict-free 16-byte load; tile i + 1 is
//     split while tile i is multiplied (two split buffers, one barrier per
//     tile instead of two).  The tile loop
//     advances counters, not divisions: the block's 512 threads all run it,
//     and dividing cost ~15 % of the kernel.
//   * A strip skips the 8-key steps above its last row in both phases.  Its
//     work grows with its index (2s + 2 steps of 8 keys per head), so the
//     block waits on the top strips at every tile; pairing strips s and
//     15 - s on one warp (each warp half the columns) evened the work and
//     measured slower.
//   * y is written with streaming stores (it is not read again here).
//   * Any 1 <= Q <= 256, 1 <= P <= 128, 1 <= N <= 128: ragged tiles are
//     zero-filled and masked on store.  Anything else is refused
//     (cudaErrorInvalidValue), never computed wrongly.

#include <initializer_list>

#include "flash_mma.cuh"

namespace {

// Compile-time switches for scripts/torch_ssd_variants.py, which times the
// kernel with one part taken out or changed (the output is then wrong where a
// part is taken out).  The defaults are the kernel as it runs.
#ifndef SSD_CB                    // 0: no C B^T products
#define SSD_CB 1
#endif
#ifndef SSD_MX                    // 0: no M x products (and no M)
#define SSD_MX 1
#endif
#ifndef SSD_COMPENSATION          // 0: every 3xTF32 product as big.big alone
#define SSD_COMPENSATION 1
#endif

constexpr int kWarps = 16;            // one 16-row strip each: Q <= 256
constexpr int kThreads = kWarps * kWarp;
constexpr int kBJ = 32;               // keys per tile
constexpr int kCols = 64;             // columns of x per pass: 8 n8 tiles
constexpr int kNT = kCols / 8;
constexpr int kXs = kCols + 4;        // shared row stride of x: 4 mod 8 words
constexpr int kStages = 4;            // buffers of the x ring
constexpr int kStage = kBJ * kXs + 2 * kBJ;   // floats of one: x, then (cum, dt) per key
constexpr int kSplitStride = 4 * kCols + 8;   // the split tile: a row pair, 8 mod 32 floats
constexpr int kSplit = kBJ / 2 * kSplitStride;   // floats of one of its two buffers
constexpr int kGroupRows = 64;        // phase 1: rows of C staged at once (4 strips)
constexpr int kSlice = 4;             // k chunks of 8 state columns per C B^T partial sum
constexpr int kMaxQ = kWarps * kStrip;
constexpr int kMaxP = 2 * kCols;
constexpr int kMaxN = 128;
constexpr int kCbCost = 2;            // C B^T of a block against one head's M x, for grouping

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
  int hpb;    // heads per block
  int nch;    // k chunks of N (C B^T)
  int cb_floats;   // floats of the C B^T region
  int x_vec;  // copy width of x rows: 16 or 4 bytes
};

// A (rows, D) matrix staged by flash_mma.cuh's stage_rows: copy width, the
// columns staged (zeros past D) and the shared row stride.
struct Rows {
  int vec;   // 16 or 4 bytes
  int dp;
  int D;
  int kse;
};

// Strip s of C B^T: 16 rows of 16 (s + 1) keys, at a row stride of 8 mod 32
// floats, strips one after another.
__host__ __device__ constexpr int cb_stride(int s) { return 32 * (s / 2) + 40; }
__host__ __device__ constexpr int cb_offset(int s) {
  return kStrip * (32 * (s / 2) * (s / 2) + 48 * (s / 2) + (s % 2) * cb_stride(s));
}

inline int stride8mod32(int n) { return n + ((8 - n % 32) + 32) % 32; }
inline int b_stride(int N) { return stride8mod32((N + 7) / 8 * 8); }

// Dynamic shared memory of a block: the strips' C B^T, then a region that
// holds 64 rows of C and two tiles of B in phase 1, and the x ring and the
// two split tiles in phase 2.
// kernels/ssd_scan.py:ssd_shared_bytes is the same formula; chip_smoke.py and
// the card tests hold the two equal through ssd_intra_shared_bytes.
size_t shared_bytes(int Q, int N) {
  const int strips = (Q + kStrip - 1) / kStrip;
  const size_t phase1 = (size_t)(kGroupRows + 2 * kBJ) * b_stride(N);
  const size_t phase2 = (size_t)kStages * kStage + 2 * kSplit;
  return sizeof(float) * ((size_t)cb_offset(strips) + (phase1 > phase2 ? phase1 : phase2));
}

// x = big + small for 3xTF32: big = x rounded to TF32 (to nearest, ties away
// from zero, as cvt.rna; inf and NaN kept), small = x - big left unrounded.
__device__ __forceinline__ void split_fast(uint32_t x, uint32_t& big, uint32_t& small) {
  const uint32_t finite = min(0x7f800000u - (x & 0x7f800000u), 0x1000u);   // 0 on inf, NaN
  big = (x + finite) & 0xffffe000u;
  small = __float_as_uint(__uint_as_float(x) - __uint_as_float(big));
}

template <int N>
__device__ __forceinline__ void prepare_fast(Frag<N>& f) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_fast(f.big[i], f.big[i], f.small[i]);
}

// c[n0 + n] += a.f[n] for NB n8 tiles, both operands split (3xTF32): the
// small.big products of all NB tiles, then their big.small, then big.big, so
// that NB - 1 independent mma separate two into the same accumulator.
template <int NB, int NC>
__device__ __forceinline__ void mma3_tiles(float (&c)[NC][4], int n0, const Frag<4>& a,
                                           const Frag<2> (&f)[NB]) {
  if (SSD_COMPENSATION) {
#pragma unroll
    for (int n = 0; n < NB; ++n) mma(c[n0 + n], a.small, f[n].big);
#pragma unroll
    for (int n = 0; n < NB; ++n) mma(c[n0 + n], a.big, f[n].small);
  }
#pragma unroll
  for (int n = 0; n < NB; ++n) mma(c[n0 + n], a.big, f[n].big);
}

// ---------------------------------------------------------------------------
// The kernel: grid (head groups, nc, B)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1) ssd_intra_kernel(const Params p, const Rows cr,
                                                                const Rows br) {
  extern __shared__ __align__(16) float smem[];
  float* cbs = smem;                               // the strips' C B^T
  float* work = smem + p.cb_floats;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int g = lane / 4, t = lane % 4;
  const int hg = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int h0 = hg * p.hpb;
  const int h1 = min(p.H, h0 + p.hpb);
  const int strips = (p.Q + kStrip - 1) / kStrip;
  const int n_jt = (p.Q + kBJ - 1) / kBJ;
  // the last row of strip s; -1 past Q
  auto last_row = [&](int s) { return s < strips ? min(kStrip * s + kStrip, p.Q) - 1 : -1; };

  // ---- phase 1: C B^T, once for every head of the group ----
  {
    const float* cg = p.cm + b * p.c_sb + c * p.c_sc;
    const float* bg = p.bm + b * p.b_sb + c * p.b_sc;
    float* cs = work;                              // [kGroupRows][br.kse]
    float* bt = work + kGroupRows * br.kse;        // [2][kBJ][br.kse]
    for (int r0 = 0; r0 < p.Q; r0 += kGroupRows) {
      const int s = r0 / kStrip + warp / 4;        // this warp's strip, and 8 keys of each tile
      const int nb = warp % 4;
      const int last = last_row(s);
      const int n_tiles = (min(r0 + kGroupRows, p.Q) + kBJ - 1) / kBJ;
      stage_rows(cs, cg, p.c_sq, r0, kGroupRows, p.Q, cr);
      stage_rows(bt, bg, p.b_sq, 0, kBJ, p.Q, br);
      cp_commit();
      for (int jt = 0; jt < n_tiles; ++jt) {
        if (jt + 1 < n_tiles) {
          stage_rows(bt + ((jt + 1) & 1) * kBJ * br.kse, bg, p.b_sq, (jt + 1) * kBJ, kBJ, p.Q, br);
          cp_commit();
          cp_wait<1>();
        } else {
          cp_wait<0>();
        }
        __syncthreads();
        const float* bs = bt + (jt & 1) * kBJ * br.kse;
        const int k0 = jt * kBJ + nb * 8;          // the warp's 8 keys
        if (SSD_CB && k0 <= last) {
          float acc[1][4] = {};
          for (int s0 = 0; s0 < p.nch; s0 += kSlice) {
            float part[1][4] = {};
#pragma unroll
            for (int kc = s0; kc < s0 + kSlice; ++kc) {
              if (kc < p.nch) {
                Frag<4> a = load_a(cs, br.kse, (s - r0 / kStrip) * kStrip + g, kc * 8 + 2 * t);
                prepare_fast(a);
                Frag<2> f[1] = {load_bt(bs, br.kse, nb * 8 + g, kc * 8 + 2 * t)};
                prepare_fast(f[0]);
                mma3_tiles(part, 0, a, f);
              }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[0][e] += part[0][e];
          }
          float* row = cbs + cb_offset(s) + g * cb_stride(s) + k0 + 2 * t;
          *reinterpret_cast<float2*>(row) = make_float2(acc[0][0], acc[0][1]);
          *reinterpret_cast<float2*>(row + 8 * cb_stride(s)) = make_float2(acc[0][2], acc[0][3]);
        }
        __syncthreads();                           // this buffer (and C) is refilled next
      }
    }
  }

  // ---- phase 2: per head, y = M x over the key tiles, 64 columns at a time ----
  const int s = warp;                              // the warp's strip
  const int last = last_row(s);
  const int qa = kStrip * s + g, qb = qa + 8;      // the lane's two rows
  const float* cb_strip = cbs + cb_offset(s) + g * cb_stride(s);
  const int cb8 = 8 * cb_stride(s);
  const float* xb = p.x + b * p.x_sb + c * p.x_sc;
  const float* dtb = p.dt + b * p.dt_sb + c * p.dt_sc;
  const float* cumb = p.cum + b * p.cum_sb + c * p.cum_sc;
  const int n_ph = (p.P + kCols - 1) / kCols;
  const int n_tiles = (h1 - h0) * n_ph * n_jt;     // (head, pass, key tile) in order
  // The next tile to copy (head, pass, key tile), advanced one tile per call:
  // counters, not divisions, which every thread of the block would run.
  int nh = h0, nph = 0, njt = 0, next = 0;
  const int tid = threadIdx.x;
  auto fetch_next = [&]() {                        // the next tile into its ring buffer
    if (next < n_tiles) {
      float* xs = work + (next % kStages) * kStage;
      float* cd = xs + kBJ * kXs;                  // [kBJ][2]: (cum_j, dt_j)
      const float* src = xb + nh * p.x_sh + nph * kCols;
      const int cols = min(kCols, p.P - nph * kCols);
      if (p.x_vec == 16) {                         // 32 rows x 16 copies: one per thread
        const int r = tid / (kCols / 4), col = tid % (kCols / 4) * 4, j = njt * kBJ + r;
        const int len = j < p.Q ? min(max(cols - col, 0), 4) : 0;
        cp_async16(xs + r * kXs + col, src + (len ? (int64_t)j * p.x_sq + col : 0), 4 * len);
      } else {
#pragma unroll
        for (int k = 0; k < kBJ * kCols / kThreads; ++k) {
          const int e = tid + k * kThreads, r = e / kCols, col = e % kCols, j = njt * kBJ + r;
          const int len = j < p.Q && col < cols ? 1 : 0;
          cp_async4(xs + r * kXs + col, src + (len ? (int64_t)j * p.x_sq + col : 0), 4 * len);
        }
      }
      if (tid < 2 * kBJ) {
        const int j = njt * kBJ + tid % kBJ;
        const bool ok = j < p.Q;
        const float* from = tid < kBJ ? cumb + nh * p.cum_sh + (ok ? (int64_t)j * p.cum_sq : 0)
                                      : dtb + nh * p.dt_sh + (ok ? (int64_t)j * p.dt_sq : 0);
        cp_async4(cd + 2 * (tid % kBJ) + tid / kBJ, from, ok ? 4 : 0);
      }
      if (++njt == n_jt) {
        njt = 0;
        if (++nph == n_ph) {
          nph = 0;
          ++nh;
        }
      }
    }
    ++next;
    cp_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fetch_next();

  // Two buffers of [kBJ / 2][kSplitStride]: rows 2r, 2r + 1 of a tile of x
  // split, per column (big 2r, small 2r, big 2r + 1, small 2r + 1), so that
  // a B fragment is one load.  Tile i + 1 is split while tile i is
  // multiplied: one barrier per tile.
  float* xsplit0 = work + kStages * kStage;
  auto split_tile = [&](int i) {   // once for every strip: 2 columns of a row pair per thread
    const float* xs = work + (i % kStages) * kStage;
    float* xsplit = xsplit0 + (i % 2) * kSplit;
    const int r = threadIdx.x / (kCols / 2), c2 = threadIdx.x % (kCols / 2) * 2;
    const float2 v0 = *reinterpret_cast<const float2*>(xs + 2 * r * kXs + c2);
    const float2 v1 = *reinterpret_cast<const float2*>(xs + (2 * r + 1) * kXs + c2);
    uint32_t bg[4], sm[4];
    split_fast(__float_as_uint(v0.x), bg[0], sm[0]);
    split_fast(__float_as_uint(v1.x), bg[1], sm[1]);
    split_fast(__float_as_uint(v0.y), bg[2], sm[2]);
    split_fast(__float_as_uint(v1.y), bg[3], sm[3]);
    uint4* dst = reinterpret_cast<uint4*>(xsplit + r * kSplitStride + 4 * c2);
    dst[0] = make_uint4(bg[0], sm[0], bg[1], sm[1]);
    dst[1] = make_uint4(bg[2], sm[2], bg[3], sm[3]);
  };
  cp_wait<kStages - 2>();                          // tile 0 has landed
  __syncthreads();
  split_tile(0);
  float acc[kNT][4] = {};
  float cqa = 0.f, cqb = 0.f;                      // cum of the lane's rows, this head
  int h = h0, ph = 0, jt = 0;                      // the tile computed
  for (int i = 0; i < n_tiles; ++i) {
    const int j0 = jt * kBJ;
    if (jt == 0 && ph == 0) {
      const float* cg = cumb + h * p.cum_sh;
      cqa = qa < p.Q ? __ldg(cg + (int64_t)qa * p.cum_sq) : 0.f;
      cqb = qb < p.Q ? __ldg(cg + (int64_t)qb * p.cum_sq) : 0.f;
    }
    const float* cd = work + (i % kStages) * kStage + kBJ * kXs;
    const float* xsplit = xsplit0 + (i % 2) * kSplit;
    cp_wait<kStages - 3>();                        // tile i + 1 has landed (this thread's copies)
    __syncthreads();                               // everyone's; tile i split; tile i - 1 consumed
    fetch_next();                                  // tile i + kStages - 1, into tile i - 1's buffer
    if (i + 1 < n_tiles) split_tile(i + 1);        // into tile i - 1's split buffer
    // 8-key steps of this tile the strip sees
    const int nvis = SSD_MX && last >= j0 ? min(kBJ / 8, (last - j0) / 8 + 1) : 0;
    float part[kNT][4] = {};
    for (int kc = 0; kc < nvis; ++kc) {
      // the lane's keys: jl (k = t) and jl + 1 (k = t + 4)
      const int jl = kc * 8 + 2 * t;
      const int j = j0 + jl;
      const float4 cdt = *reinterpret_cast<const float4*>(cd + 2 * jl);
      const float2 cb0 = *reinterpret_cast<const float2*>(cb_strip + j);
      const float2 cb1 = *reinterpret_cast<const float2*>(cb_strip + cb8 + j);
      // the exponent is masked before exp: exp(-inf) = 0 above the diagonal
      const float e00 = __expf(j <= qa ? cqa - cdt.x : -INFINITY);
      const float e01 = __expf(j + 1 <= qa ? cqa - cdt.z : -INFINITY);
      const float e10 = __expf(j <= qb ? cqb - cdt.x : -INFINITY);
      const float e11 = __expf(j + 1 <= qb ? cqb - cdt.z : -INFINITY);
      // M's A fragment in the permuted k order: (qa, j), (qb, j), (qa, j + 1), (qb, j + 1)
      Frag<4> a;
      a.big[0] = __float_as_uint(cb0.x * e00 * cdt.y);
      a.big[1] = __float_as_uint(cb1.x * e10 * cdt.y);
      a.big[2] = __float_as_uint(cb0.y * e01 * cdt.w);
      a.big[3] = __float_as_uint(cb1.y * e11 * cdt.w);
      prepare_fast(a);
#pragma unroll
      for (int n0 = 0; n0 < kNT; n0 += 4) {        // x's fragments 4 n8 tiles at a time
        Frag<2> f[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {   // rows 2t, 2t + 1 of the step, column (n0 + n) * 8 + g
          const uint4 v = *reinterpret_cast<const uint4*>(
              xsplit + (kc * 4 + t) * kSplitStride + 4 * ((n0 + n) * 8 + g));
          f[n].big[0] = v.x;
          f[n].small[0] = v.y;
          f[n].big[1] = v.z;
          f[n].small[1] = v.w;
        }
        mma3_tiles(part, n0, a, f);
      }
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];

    if (jt == n_jt - 1) {                          // the pass's last tile: store y
      float* yg = p.y + (((int64_t)b * p.nc + c) * p.Q * p.H + h) * p.P + ph * kCols;
      const int64_t row_stride_y = (int64_t)p.H * p.P;
      const int cols = min(kCols, p.P - ph * kCols);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const int col = n * 8 + 2 * t;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int q = hi ? qb : qa;
          if (q >= p.Q || col >= cols) continue;
          float* dst = yg + q * row_stride_y + col;
          if (col + 1 < cols && p.P % 2 == 0) {   // streaming stores: y is not read here
            __stcs(reinterpret_cast<float2*>(dst), make_float2(acc[n][2 * hi], acc[n][2 * hi + 1]));
          } else {
            __stcs(dst, acc[n][2 * hi]);
            if (col + 1 < cols) __stcs(dst + 1, acc[n][2 * hi + 1]);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      }
    }
    if (++jt == n_jt) {
      jt = 0;
      if (++ph == n_ph) {
        ph = 0;
        ++h;
      }
    }
  }
  cp_wait<0>();
}

// Whether every row of a (b, c, q[, h]) strided matrix starts on a multiple of
// 16 bytes.
inline bool aligned16(const float* base, std::initializer_list<int64_t> strides) {
  if (reinterpret_cast<uintptr_t>(base) % 16) return false;
  for (int64_t s : strides)
    if (s % 4) return false;
  return true;
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
  p.nch = (N + 7) / 8;
  p.cb_floats = cb_offset((Q + kStrip - 1) / kStrip);
  p.x_vec = aligned16(p.x, {p.x_sb, p.x_sc, p.x_sq, p.x_sh}) ? 16 : 4;
  const Rows cr{aligned16(p.cm, {p.c_sb, p.c_sc, p.c_sq}) ? 16 : 4, p.nch * 8, N, b_stride(N)};
  const Rows br{aligned16(p.bm, {p.b_sb, p.b_sc, p.b_sq}) ? 16 : 4, p.nch * 8, N, b_stride(N)};

  // Head groups: one block per SM; the count that fills whole waves best,
  // each group computing C B^T once.
  int dev = 0, sms = 132;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long base = (long long)B * nc;
  long long best = -1;
  for (int groups = 1; groups <= H; ++groups) {
    const int hpb = (H + groups - 1) / groups;
    if ((H + hpb - 1) / hpb != groups) continue;   // the same split as fewer groups
    const long long waves = (base * groups + sms - 1) / sms;
    const long long cost = waves * (hpb + kCbCost);
    if (best < 0 || cost < best) {
      best = cost;
      p.hpb = hpb;
    }
  }
  const int n_hg = (H + p.hpb - 1) / p.hpb;

  const size_t smem = shared_bytes(Q, N);
  err = cudaFuncSetAttribute(ssd_intra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_intra_kernel<<<dim3(n_hg, nc, B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p, cr, br);
  return (int)cudaGetLastError();
}

// Dynamic shared memory in bytes of one block at chunk Q and state N.
long long ssd_intra_shared_bytes(int Q, int N) { return (long long)shared_bytes(Q, N); }

const char* ssd_intra_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
