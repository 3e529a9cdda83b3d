// Backward of the causal / sliding-window flash attention with
// grouped-query heads, bf16 storage, on Hopper's tensor cores (wgmma):
// dQ, dK and dV of the fp32 function that flash_attention_wgmma.cu
// computes, stored in bf16. fp32 storage stays on the 3xTF32 mma.sync
// kernels of flash_attention_bwd.cu, whose C entry point picks one of the
// two by dtype.
//
// Replaces: the gradient of src/repro/kernels/flash_attention.py::
// flash_attention. The TPU kernel has no backward of its own: the
// reference trains through plain dot_attention, which XLA differentiates
// (src/repro/models/layers/attention.py:84-100).
//
// Semantics are those of repro_torch.kernels.ref.attention_bwd_ref, the
// fp32 gradient of the fp32 attention of the upcast inputs: q, o, dO
// (BH, Sq, D); k, v (BH / G, Sk, D); query row bh reads kv row bh / G;
// query row i sits at position p = i + q_offset (a shard of the query
// sequence under context parallelism; 0 otherwise), key j at j; they
// pair when j < Sk, j <= p (causal) and j > p - window (window > 0);
// s_ij = q_i . k_j / sqrt(D). The offset moves only the positions the
// masks and the tile ranges compare, so pass A gives a row the full
// call's dQ bits where the offset is a multiple of its 128-row tile. With
// LSE_i the forward's log-sum-exp of row i (natural-log units, written by
// qf_flash_attention; -inf for a row with no allowed key) and
// P_ij = exp(s_ij - LSE_i) for the allowed pairs, 0 else:
//   D_i = sum_c dO_ic O_ic,  dS_ij = P_ij (dO_i . v_j - D_i),
//   dQ_i = sum_j dS_ij k_j / sqrt(D),  dK_j = sum_i dS_ij q_i / sqrt(D),
//   dV_j = sum_i P_ij dO_i,
// the sums over i running over the G query heads of kv head j's group as
// well. A row with no allowed key has no gradient. P is formed as
// exp2(fma(s_ij, 1/sqrt(D), -LSE_i) log2(e)): one rounding of the
// exponent, as the plain version's exp(s_ij / sqrt(D) - LSE_i) has. At
// the logits of the reference's init (LSE near 2000) rounding s_ij
// log2(e) / sqrt(D) and LSE_i log2(e) apart, as the forward's online
// softmax does, puts an error near 1e-4 on every P.
//
// What bounds it on an H100: operations. The five products (QK^T,
// dO V^T, dS K, dS^T Q, P^T dO) are 10 D FLOP per allowed pair, at 989
// TFLOP/s on the bf16 tensor cores.
//
// Why the tensor cores keep the fp32 function (as in the forward):
// - S = Q K^T and dP = dO V^T: products of two bf16 values are exact in
//   fp32, so bf16 wgmmas with fp32 accumulators give the fp32 dots of the
//   upcast inputs; only the order of the sums differs.
// - dV = P^T dO, dQ = dS K, dK = dS^T Q: P and dS are fp32 and are the A
//   operand. Each is split as x = hi + lo, hi = bf16(x), lo = bf16(x -
//   hi), and the product runs as two bf16 wgmmas into one fp32
//   accumulator: 16 significand bits of P and dS (relative error about
//   2^-17). Rounding P or dS to bf16 alone, as SDPA and cuDNN do, would
//   change the function. With the splits the tensor cores do 10 m64
//   product units a pair of 64-row tiles, against the bound's 5.
//
// Design: two passes and an ordered sum, no atomics, so the same inputs
// give the same bits.
//  A. dQ: one block of three warpgroups per (128 query rows, query head),
//     the forward's shape. Warpgroups 0 and 1 each own 64 rows: D_i from
//     O and dO (to a workspace for pass B), then for each key tile of 64
//     their masks allow, dP = dO V^T and S = Q K^T (m64n64k16 chains, Q
//     and dO resident in shared memory), P and dS in registers, and
//     dQ += dS_hi K + dS_lo K (m64nDk16 with dS in registers; dQ is 128
//     fp32 registers a thread at D = 256, so setmaxnreg moves registers
//     from the producer, 240 / 24). Warpgroup 2's one thread loads Q and
//     dO once and K and V tiles with TMA, each into one buffer with its
//     own pair of mbarriers: V of the next tile is loaded while the
//     current one's S, dS and dQ run. One K tile is read K-major for
//     Q K^T and MN-major for dS K, from the 128-byte swizzle TMA writes.
//     Query blocks run last-first (the most key tiles first).
//  B. dK, dV: one block per (64 keys, kv head, split of the group's G
//     query heads). K and V stay in shared memory; warpgroup 2 streams
//     64-row Q and dO tiles of the split's heads through a ring (2 stages
//     at D = 256, 3 below). Warpgroup 0 owns dV: S^T = K Q^T, P^T from
//     the LSE, dV += P^T_hi dO + P^T_lo dO. Warpgroup 1 owns dK: dP^T =
//     V dO^T, then P^T from warpgroup 0 through a double buffer in
//     shared memory (named barriers: both hold the same accumulator
//     layout, so thread t hands its 32 values to thread t), dS^T =
//     P^T (dP^T - D_i), dK += dS^T_hi Q + dS^T_lo Q. dK and dV of 64 keys
//     are 256 registers a thread, more than one warpgroup holds; split
//     so, the two warpgroups do the same tensor-core work. Each block
//     writes fp32 partial sums over its heads. The split fills the card:
//     at the RecurrentGemma-2B train shape (one kv head, 4096 keys) 64
//     key blocks alone would leave half the SMs idle. Key blocks run
//     first-first (under causal, the most query tiles first).
//  C. an elementwise pass sums the splits' partials in split order and
//     stores dK (scaled) and dV in bf16.
// Shared memory at D = 256: A, Q and dO 128 KB + K and V 64 KB; B, K and
// V 64 KB + the ring 128 KB + the exchange 32 KB = 230,400 of the
// 232,448 bytes a block may have.
// Ragged ends (S not a multiple of the tile, Sq != Sk) are never padded
// in device memory: the tensor maps fill rows past the end of a head
// with zeros and the masks drop them. Tiles outside the diagonal and the
// window are never loaded; only tiles that cut the diagonal, the
// window's edge, Sq or Sk are masked element by element.
#include "hopper.cuh"

namespace {

using namespace qf::hopper;

constexpr int kT = 64;              // rows of a warpgroup's tile, keys a tile
constexpr int kAQ = 128;            // A: query rows a block (two warpgroups)
constexpr int kThreads = 384;       // consumers 0-255, producer 256-383
constexpr float kLog2e = 1.4426950408889634f;
// named barriers of pass B's P^T exchange, one pair a buffer
constexpr int kXFull = 1, kXEmpty = 3;

template <int D>
struct DqShape {
  static constexpr int kPanels = D / kPanel;
  static constexpr int kRowsBytes = kAQ * D * 2;        // [panel][128][64]
  static constexpr int kTileBytes = kT * D * 2;         // [panel][64][64]
  static constexpr int kSmem = 1024 + 2 * kRowsBytes + 2 * kTileBytes;
};

template <int D>
struct DkvShape {
  static constexpr int kPanels = D / kPanel;
  static constexpr int kStages = D == 256 ? 2 : 3;
  static constexpr int kTileBytes = kT * D * 2;         // [panel][64][64]
  static constexpr int kXBytes = kT * kT * 4;           // fp32 P^T
  static constexpr int kSmem =
      1024 + 2 * kTileBytes + 2 * kStages * kTileBytes + 2 * kXBytes;
};

__device__ __forceinline__ bool allowed(int row, int col, int sk, int causal,
                                        int window) {
  return col < sk && (!causal || col <= row) &&
         (window <= 0 || col > row - window);
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  // the 128-byte swizzle repeats every 1024 bytes of shared address
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// sum_c a_c b_c over 8 bf16 pairs, fp32, in order
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b,
                                      float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    acc = fmaf(u.x, w.x, acc);
    acc = fmaf(u.y, w.y, acc);
  }
  return acc;
}

// ---------------------------------------------------------------- pass A
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __nv_bfloat16* __restrict__ o,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         __nv_bfloat16* __restrict__ dq,
                         float* __restrict__ dd_ws, int group, int sq,
                         int sk, int causal, int window, int q_off) {
  using Sh = DqShape<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t rows_bar, k_full, k_empty, v_full,
      v_empty;
  uint8_t* q_s = align_1024(smem_raw);               // [panel][128][64]
  uint8_t* do_s = q_s + Sh::kRowsBytes;
  uint8_t* k_s = do_s + Sh::kRowsBytes;              // [panel][64][64]
  uint8_t* v_s = k_s + Sh::kTileBytes;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kAQ; // most key tiles first
  int t_lo, t_hi;
  key_tiles(q0 + q_off, min(q0 + kAQ, sq) - 1 + q_off, sk, causal, window,
            t_lo, t_hi);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&rows_bar, 1);
    mbar_init(&k_full, 1);
    mbar_init(&v_full, 1);
    mbar_init(&k_empty, 256);
    mbar_init(&v_empty, 256);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: Q and dO once, then a V and a K buffer, TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(&rows_bar, 2 * Sh::kRowsBytes);
#pragma unroll
      for (int p = 0; p < Sh::kPanels; ++p) {
        tma_load(q_s + p * kAQ * 128, &tm_q, p * kPanel, q0, bh, &rows_bar);
        tma_load(do_s + p * kAQ * 128, &tm_do, p * kPanel, q0, bh,
                 &rows_bar);
      }
      const int kvh = bh / group;
      for (int t = t_lo, i = 0; t <= t_hi; ++t, ++i) {
        mbar_wait(&v_empty, (i & 1) ^ 1);
        mbar_expect_tx(&v_full, Sh::kTileBytes);
#pragma unroll
        for (int p = 0; p < Sh::kPanels; ++p)
          tma_load(v_s + p * kT * 128, &tm_v, p * kPanel, t * kT, kvh,
                   &v_full);
        mbar_wait(&k_empty, (i & 1) ^ 1);
        mbar_expect_tx(&k_full, Sh::kTileBytes);
#pragma unroll
        for (int p = 0; p < Sh::kPanels; ++p)
          tma_load(k_s + p * kT * 128, &tm_k, p * kPanel, t * kT, kvh,
                   &k_full);
      }
    }
    return;
  }

  // ---- consumers: 64 query rows a warpgroup
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int r_lo = q0 + wg * 64;
  const int row0 = r_lo + warp * 16 + lane / 4;      // rows row0, row0 + 8
  const int col0 = 2 * (lane % 4);                   // of each 8-column chunk
  const int p_lo = r_lo + q_off;                     // positions of the rows
  int w_lo = 1, w_hi = 0;                            // this warpgroup's tiles
  if (r_lo < sq)
    key_tiles(p_lo, min(r_lo + 63, sq - 1) + q_off, sk, causal, window, w_lo,
              w_hi);

  // D_i of the thread's two rows (a quarter of each row a lane, summed
  // over the four lanes of the row in order) and their LSE
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  float dd[2], lse_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    float part = 0.f;
    lse_r[h] = 0.f;
    if (row < sq) {
      const size_t off = (static_cast<size_t>(bh) * sq + row) * D +
                         (lane % 4) * (D / 4);
      const uint4* orow = reinterpret_cast<const uint4*>(o + off);
      const uint4* drow = reinterpret_cast<const uint4*>(dout + off);
#pragma unroll
      for (int c = 0; c < D / 32; ++c) part = dot8(orow[c], drow[c], part);
      lse_r[h] = lse[static_cast<size_t>(bh) * sq + row];
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    dd[h] = part;
    if (row < sq && lane % 4 == 0)
      dd_ws[static_cast<size_t>(bh) * sq + row] = part;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint64_t d_q = smem_desc(q_s + wg * 64 * 128, 16, 1024);
  const uint64_t d_do = smem_desc(do_s + wg * 64 * 128, 16, 1024);
  const uint64_t d_k = smem_desc(k_s, 16, 1024);
  const uint64_t d_v = smem_desc(v_s, 16, 1024);
  mbar_wait(&rows_bar, 0);

  for (int t = t_lo, i = 0; t <= t_hi; ++t, ++i) {
    const bool mine = t >= w_lo && t <= w_hi;
    float sc[32], dp[32];
    // dP = dO V^T, then S = Q K^T, as soon as each tile is in
    mbar_wait(&v_full, i & 1);
    if (mine) {
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
      wgmma_fence();
      wgmma_chain_n64<D>(dp, d_do, kAQ, d_v, kT);
      wgmma_commit();
    }
    mbar_wait(&k_full, i & 1);
    if (mine) {
      wgmma_fence();
      wgmma_chain_n64<D>(sc, d_q, kAQ, d_k, kT);
      wgmma_commit();
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_regs(dp);
    }
    mbar_arrive(&v_empty);
    if (mine) {
      wgmma_wait_all();
      fence_regs(sc);
      // P from the LSE (masked pairs 0), then dS = P (dP - D_i) in dp
      const int k0 = t * kT;
      const bool whole = k0 + kT <= sk &&
                         (!causal || k0 + kT - 1 <= p_lo) &&
                         (window <= 0 || k0 > p_lo + 63 - window);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * h + e;
            const bool ok =
                whole || allowed(row0 + 8 * h + q_off, k0 + 8 * j + col0 + e,
                                 sk, causal, window);
            const float p =
                ok ? exp2f(fmaf(sc[idx], scale, -lse_r[h]) * kLog2e) : 0.f;
            dp[idx] = p * (dp[idx] - dd[h]);
          }
      // dQ += dS_hi K + dS_lo K, K read MN-major
      wgmma_split_nd<D>(acc, dp, k_s);
    }
    mbar_arrive(&k_empty);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= sq) continue;
    __nv_bfloat16* qrow = dq + (static_cast<size_t>(bh) * sq + row) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * c + col0) =
          __floats2bfloat162_rn(scale * acc[4 * c + 2 * h],
                                scale * acc[4 * c + 2 * h + 1]);
  }
}

// ---------------------------------------------------------------- pass B
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ dd_ws,
                           float* __restrict__ part, int group, int splits,
                           int sq, int sk, int causal, int window,
                           int q_off) {
  using Sh = DkvShape<D>;
  constexpr int kStages = Sh::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_bar;
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  uint8_t* k_s = align_1024(smem_raw);               // [panel][64][64]
  uint8_t* v_s = k_s + Sh::kTileBytes;
  uint8_t* q_s = v_s + Sh::kTileBytes;               // [stage][panel][64][64]
  uint8_t* do_s = q_s + kStages * Sh::kTileBytes;
  float4* x_s = reinterpret_cast<float4*>(do_s + kStages * Sh::kTileBytes);

  const int bk = gridDim.x / splits;
  const int kvh = blockIdx.x / splits, sp = blockIdx.x % splits;
  const int k0 = blockIdx.y * kT;                    // most query tiles first
  const int g_lo = sp * group / splits, g_hi = (sp + 1) * group / splits;
  // query tiles [tq_lo, tq_hi] holding a row some key of the block pairs
  // with (rows, not positions: row i is at position i + q_off)
  const int key_hi = min(k0 + kT, sk) - 1;
  const int i_lo = causal ? max(0, k0 - q_off) : 0;
  const int i_hi =
      window > 0 ? min(sq - 1, key_hi + window - 1 - q_off) : sq - 1;
  const int tq_lo = i_lo / kT;
  const int nt = i_hi >= i_lo ? i_hi / kT - tq_lo + 1 : 0;
  const int n = (g_hi - g_lo) * nt;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&kv_bar, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: K and V once, then the Q / dO ring, TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(&kv_bar, 2 * Sh::kTileBytes);
#pragma unroll
      for (int p = 0; p < Sh::kPanels; ++p) {
        tma_load(k_s + p * kT * 128, &tm_k, p * kPanel, k0, kvh, &kv_bar);
        tma_load(v_s + p * kT * 128, &tm_v, p * kPanel, k0, kvh, &kv_bar);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        const int bh = kvh * group + g_lo + i / nt;
        const int i0 = (tq_lo + i % nt) * kT;
        mbar_wait(&empty_bar[s], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full_bar[s], 2 * Sh::kTileBytes);
        uint8_t* qt = q_s + s * Sh::kTileBytes;
        uint8_t* dt = do_s + s * Sh::kTileBytes;
#pragma unroll
        for (int p = 0; p < Sh::kPanels; ++p) {
          tma_load(qt + p * kT * 128, &tm_q, p * kPanel, i0, bh,
                   &full_bar[s]);
          tma_load(dt + p * kT * 128, &tm_do, p * kPanel, i0, bh,
                   &full_bar[s]);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup 0 owns dV (forms P^T), 1 owns dK (dS^T)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int rk = warp * 16 + lane / 4;               // keys rk, rk + 8
  const int col0 = 2 * (lane % 4);                   // of each 8-column chunk
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const uint64_t d_a = smem_desc(wg == 0 ? k_s : v_s, 16, 1024);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(&kv_bar, 0);

  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    const int bh = kvh * group + g_lo + i / nt;
    const int i0 = (tq_lo + i % nt) * kT;
    const uint8_t* qt = q_s + s * Sh::kTileBytes;
    const uint8_t* dt = do_s + s * Sh::kTileBytes;
    mbar_wait(&full_bar[s], (i / kStages) & 1);

    // warpgroup 0: S^T = K Q^T; warpgroup 1: dP^T = V dO^T (keys x rows)
    float st[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) st[j] = 0.f;
    wgmma_fence();
    wgmma_chain_n64<D>(st, d_a, kT, smem_desc(wg == 0 ? qt : dt, 16, 1024),
                       kT);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);

    // this thread's query rows: i0 + 8 j + col0 + e
    const size_t rbase = static_cast<size_t>(bh) * sq;
    float4* xo = x_s + (i & 1) * 8 * 128;
    if (wg == 0) {
      const int p0 = i0 + q_off;                     // the tile's first position
      const bool whole = i0 + kT <= sq && k0 + kT <= sk &&
                         (!causal || k0 + kT - 1 <= p0) &&
                         (window <= 0 || k0 > p0 + kT - 1 - window);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = i0 + 8 * j + col0 + e;
          const float l = row < sq ? lse[rbase + row] : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int idx = 4 * j + 2 * h + e;
            const bool ok =
                whole || (row < sq && allowed(row + q_off, k0 + rk + 8 * h, sk,
                                              causal, window));
            st[idx] = ok ? exp2f(fmaf(st[idx], scale, -l) * kLog2e) : 0.f;
          }
        }
      // hand P^T to warpgroup 1 (thread t holds the same elements there)
      if (i >= 2) named_sync(kXEmpty + (i & 1), 256);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        xo[c * 128 + tid] =
            make_float4(st[4 * c], st[4 * c + 1], st[4 * c + 2], st[4 * c + 3]);
      named_arrive(kXFull + (i & 1), 256);
      // dV += P^T_hi dO + P^T_lo dO, dO read MN-major
      wgmma_split_nd<D>(acc, st, dt);
    } else {
      float dd[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = i0 + 8 * j + col0 + e;
          dd[j][e] = row < sq ? dd_ws[rbase + row] : 0.f;
        }
      named_sync(kXFull + (i & 1), 256);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 p = xo[c * 128 + tid];
        st[4 * c] = p.x * (st[4 * c] - dd[c][0]);
        st[4 * c + 1] = p.y * (st[4 * c + 1] - dd[c][1]);
        st[4 * c + 2] = p.z * (st[4 * c + 2] - dd[c][0]);
        st[4 * c + 3] = p.w * (st[4 * c + 3] - dd[c][1]);
      }
      if (i + 2 < n) named_arrive(kXEmpty + (i & 1), 256);
      // dK += dS^T_hi Q + dS^T_lo Q, Q read MN-major
      wgmma_split_nd<D>(acc, st, qt);
    }
    mbar_arrive(&empty_bar[s]);
  }

  // fp32 partials: part[sp][wg][kvh][key][D] (wg 0: dV, 1: dK unscaled)
  float* out = part + ((static_cast<size_t>(sp) * 2 + wg) * bk + kvh) *
                          static_cast<size_t>(sk) * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + rk + 8 * h;
    if (key >= sk) continue;
    float* krow = out + static_cast<size_t>(key) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<float2*>(krow + 8 * c + col0) =
          make_float2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
  }
}

// ---------------------------------------------------------------- pass C
// dv = sum_s part[s][0], dk = scale sum_s part[s][1], s in order; n is
// bk * sk * D, a multiple of 4
__global__ void attn_bwd_reduce_kernel(const float* __restrict__ part,
                                       __nv_bfloat16* __restrict__ dk,
                                       __nv_bfloat16* __restrict__ dv,
                                       int splits, size_t n, float scale) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x * 4;
  for (size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x) * 4;
       i < n; i += stride) {
    float4 a = *reinterpret_cast<const float4*>(part + i);
    float4 b = *reinterpret_cast<const float4*>(part + n + i);
    for (int s = 1; s < splits; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(part + 2 * s * n + i);
      const float4 y =
          *reinterpret_cast<const float4*>(part + (2 * s + 1) * n + i);
      a = make_float4(a.x + x.x, a.y + x.y, a.z + x.z, a.w + x.w);
      b = make_float4(b.x + y.x, b.y + y.y, b.z + y.z, b.w + y.w);
    }
    __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(dv + i);
    __nv_bfloat162* k2 = reinterpret_cast<__nv_bfloat162*>(dk + i);
    v2[0] = __floats2bfloat162_rn(a.x, a.y);
    v2[1] = __floats2bfloat162_rn(a.z, a.w);
    k2[0] = __floats2bfloat162_rn(scale * b.x, scale * b.y);
    k2[1] = __floats2bfloat162_rn(scale * b.z, scale * b.w);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dq, void* dk, void* dv,
           void* dd, void* part, int bh, int bk, int sq, int sk, int causal,
           int window, int q_off, int splits, cudaStream_t st) {
  CUtensorMap mq128, mdo128, mk, mv, mq, mdo;
  if (!make_map(&mq128, q, bh, sq, D, kAQ) ||
      !make_map(&mdo128, dout, bh, sq, D, kAQ) ||
      !make_map(&mk, k, bk, sk, D, kT) || !make_map(&mv, v, bk, sk, D, kT) ||
      !make_map(&mq, q, bh, sq, D, kT) || !make_map(&mdo, dout, bh, sq, D, kT))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int sa = DqShape<D>::kSmem, sb = DkvShape<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, sa);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attn_bwd_dkdv_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, sb);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int group = bh / bk;
  attn_bwd_dq_wgmma_kernel<D><<<dim3(bh, (sq + kAQ - 1) / kAQ), kThreads, sa,
                                st>>>(
      mq128, mdo128, mk, mv, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<__nv_bfloat16*>(dq),
      static_cast<float*>(dd), group, sq, sk, causal, window, q_off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv_wgmma_kernel<D><<<dim3(splits * bk, (sk + kT - 1) / kT),
                                  kThreads, sb, st>>>(
      mk, mv, mq, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<float*>(part), group,
      splits, sq, sk, causal, window, q_off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(bk) * sk * D;
  const size_t want = (n / 4 + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  attn_bwd_reduce_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), splits, n,
      1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace qf {

// bf16 q, o, dout, dq (bh, sq, dh); k, v, dk, dv (bk, sk, dh), bh a
// multiple of bk; lse fp32 (bh, sq), the forward's; dd an fp32 workspace
// of (bh, sq); part an fp32 workspace of (splits, 2, bk, sk, dh), splits
// in [1, bh / bk]; query row i at position i + q_off. The C entry point
// qf_flash_attention_bwd (flash_attention_bwd.cu) checks the counts.
int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* dq, void* dk, void* dv, void* dd,
                             void* part, int bh, int bk, int sq, int sk,
                             int dh, int causal, int window, int q_off,
                             int splits, void* stream) {
  const void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16)    // TMA's and uint4 alignment
      return static_cast<int>(cudaErrorInvalidValue);
  if (splits < 1 || splits > bh / bk || lse == nullptr || dd == nullptr ||
      part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64:
      return launch<64>(q, k, v, o, dout, lse, dq, dk, dv, dd, part, bh, bk,
                        sq, sk, causal, window, q_off, splits, st);
    case 128:
      return launch<128>(q, k, v, o, dout, lse, dq, dk, dv, dd, part, bh, bk,
                         sq, sk, causal, window, q_off, splits, st);
    case 256:
      return launch<256>(q, k, v, o, dout, lse, dq, dk, dv, dd, part, bh, bk,
                         sq, sk, causal, window, q_off, splits, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace qf
