// Causal / sliding-window flash attention with grouped-query heads, bf16
// storage, on Hopper's tensor cores (wgmma), fp32 function.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel), the Pallas TPU kernel that upcasts q, k and v to fp32
// and takes both dots with fp32 accumulation, streaming 128-key blocks
// along its sequential grid axis with the running max, sum and output
// rows in VMEM scratch. fp32 storage runs on the tensor cores in 3xTF32
// mma.sync instead (flash_attention.cu), which also holds the C entry
// point that picks one of the two by dtype.
//
// Semantics are those of repro.kernels.ref.attention_ref: q (BH, Sq, D),
// k/v (BH / G, Sk, D) with query head bh reading kv head bh / G; query
// row i sits at position p = i + q_offset (q_offset >= 0: a shard of the
// query sequence under context parallelism, whose rows start there), key
// j at position j; they pair when j < Sk, j <= p (causal) and
// j > p - window (window > 0); scores scaled by 1/sqrt(D) after the dot;
// online softmax in fp32; a row with no allowed key writes 0; D is 64,
// 128 or 256; out in bf16. On request each row's log-sum-exp of its
// scaled allowed scores, LSE_i = log sum_j exp(s_ij / sqrt(D)), goes to
// an fp32 (BH, Sq) output for the backward (flash_attention_bwd_wgmma.cu).
// Its unit is the natural log for the whole chain (both forward kernels,
// both backwards, ref.attention_ref and ref.attention_bwd_ref): the
// kernel keeps the running max m in log2 units and writes
// (m + log2 l) ln 2; a row with no allowed key gets -inf.
//
// What bounds it on an H100: operations. At the RecurrentGemma-2B
// prefill shape (B*H = 40, S = 4096, D = 256, window 2048) the allowed
// pairs need 258 GFLOP against 185 MB of q, k, v and out: 0.26 ms on the
// bf16 tensor cores (989 TFLOP/s), against 3.9 ms at best on the fp32
// CUDA cores (67 TFLOP/s).
//
// Why the tensor cores keep the fp32 function:
// - S = Q K^T: a product of two bf16 values is exact in fp32, so a bf16
//   wgmma with an fp32 accumulator gives the fp32 dot of the upcast
//   inputs; only the order of the sums differs.
// - O += P V: P is fp32 and does not fit a bf16 operand. It is split as
//   P = P_hi + P_lo with P_hi = bf16(P) and P_lo = bf16(P - P_hi), and
//   P V = P_hi V + P_lo V runs as two bf16 wgmmas into the fp32 O. That
//   keeps 16 significand bits of P (relative error about 2^-17, against
//   2^-24 for the fp32 dot and 2^-8 for the bf16 output rounding).
//   Rounding P to bf16 alone, as SDPA does, would change the function.
//   The split costs 1.5x the tensor-core work of the function.
//
// Design: one block of three warpgroups per (128 query rows, head).
// - Warpgroups 0 and 1 consume: each owns 64 query rows, keeps S (64 x
//   64) and O (64 x D) in fp32 registers for the whole walk over key
//   tiles of 64 (O is 128 registers a thread at D = 256, so setmaxnreg
//   moves registers from the producer: 240 a consumer thread, 24 a
//   producer thread). The mask, the running max and sum, the rescale of
//   O and the split stay in registers. S = Q K^T is a chain of
//   m64n64k16 wgmmas with Q and K read from shared memory; P_hi V and
//   P_lo V are m64nDk16 wgmmas with P in registers (the accumulator's
//   layout is the A operand's) and V from shared memory.
// - Warpgroup 2 produces: one thread loads Q (128 x D, once) and keeps
//   the K/V ring (2 stages of 64 x D bf16 K and V tiles at D = 256, 3
//   below) filled with TMA, on mbarriers. Every tile is 64-column panels
//   of 128-byte rows in the 128-byte swizzle that TMA writes and that
//   wgmma's descriptors read: K-major for Q and K, MN-major for V.
//   Shared memory at D = 256: Q 64 KB + ring 128 KB.
// - Ragged ends (S not a multiple of the tile, Sq != Sk) are never
//   padded in device memory: the 3-D tensor maps (D, S, head) fill rows
//   past the end of each head with zeros, and the mask drops them.
// - The query offset moves only the positions the mask and the tile
//   skip compare: a row at position p meets the key tiles, in the order
//   and split, that it meets in a call from position 0 whose query tile
//   holds p at the same place, so an offset that is a multiple of 128
//   gives the full call's rows bit for bit.
// - Key tiles wholly above the diagonal or outside the window of every
//   row of the block are never loaded; a warpgroup skips the tiles none
//   of its rows needs, and only tiles that cut the diagonal, the
//   window's edge or Sk are masked element by element. Query blocks run
//   last-first (the ones with the most key tiles start first) and the
//   heads that share a kv head run side by side, so K/V tiles hit L2.
#include "hopper.cuh"

namespace {

using namespace qf::hopper;

constexpr int kBQ = 128;            // query rows per block (two warpgroups)
constexpr int kBK = 64;             // keys per tile
constexpr int kThreads = 384;       // consumers 0-255, producer 256-383
constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Shape {
  static constexpr int kPanels = D / kPanel;
  static constexpr int kStages = D == 256 ? 2 : 3;
  static constexpr int kQBytes = kBQ * D * 2;           // [panel][128][64]
  static constexpr int kTileBytes = kBK * D * 2;        // [panel][64][64]
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kTileBytes;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   int group, int sq, int sk, int causal, int window,
                   int q_off) {
  using Sh = Shape<D>;
  constexpr int kStages = Sh::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  __shared__ __align__(8) uint64_t q_bar;
  // the 128-byte swizzle repeats every 1024 bytes of shared address
  uint8_t* q_s = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = q_s + Sh::kQBytes;                  // [stage][panel][64][64]
  uint8_t* v_s = k_s + kStages * Sh::kTileBytes;

  const int bh = blockIdx.x;                         // heads of a kv head adjacent
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ; // most key tiles first
  int t_lo, t_hi;
  key_tiles(q0 + q_off, min(q0 + kBQ, sq) - 1 + q_off, sk, causal, window,
            t_lo, t_hi);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 256);
    }
    mbar_init(&q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: Q once, then the K/V ring, one thread issuing TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(&q_bar, Sh::kQBytes);
#pragma unroll
      for (int p = 0; p < Sh::kPanels; ++p)
        tma_load(q_s + p * kBQ * 128, &tm_q, p * kPanel, q0, bh, &q_bar);
      const int kvh = bh / group;
      for (int t = t_lo, i = 0; t <= t_hi; ++t, ++i) {
        const int s = i % kStages;
        mbar_wait(&empty_bar[s], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full_bar[s], 2 * Sh::kTileBytes);
        uint8_t* kt = k_s + s * Sh::kTileBytes;
        uint8_t* vt = v_s + s * Sh::kTileBytes;
#pragma unroll
        for (int p = 0; p < Sh::kPanels; ++p) {
          tma_load(kt + p * kBK * 128, &tm_k, p * kPanel, t * kBK, kvh,
                   &full_bar[s]);
          tma_load(vt + p * kBK * 128, &tm_v, p * kPanel, t * kBK, kvh,
                   &full_bar[s]);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int r_lo = q0 + wg * 64;
    const int row0 = r_lo + warp * 16 + lane / 4;    // rows row0, row0 + 8
    const int p_lo = r_lo + q_off;                   // positions of the rows
    const int col0 = 2 * (lane % 4);                 // of each 8-column chunk
    const float sl2 = kLog2e / sqrtf(static_cast<float>(D));
    int w_lo = 1, w_hi = 0;                          // this warpgroup's tiles
    if (r_lo < sq)
      key_tiles(p_lo, min(r_lo + 63, sq - 1) + q_off, sk, causal, window,
                w_lo, w_hi);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    const uint64_t dq = smem_desc(q_s + wg * 64 * 128, 16, 1024);
    mbar_wait(&q_bar, 0);

    for (int t = t_lo, i = 0; t <= t_hi; ++t, ++i) {
      const int s = i % kStages;
      mbar_wait(&full_bar[s], (i / kStages) & 1);
      if (t >= w_lo && t <= w_hi) {
        const int k0 = t * kBK;
        const uint8_t* kt = k_s + s * Sh::kTileBytes;
        const uint8_t* vt = v_s + s * Sh::kTileBytes;

        // S = Q K^T, fp32 accumulation of exact bf16 products
        float sc[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) sc[j] = 0.f;
        wgmma_fence();
        wgmma_chain_n64<D>(sc, dq, kBQ, smem_desc(kt, 16, 1024), kBK);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // mask (only tiles that cut the diagonal, the window or Sk), then
        // the online softmax in the log2 domain
        const bool whole = k0 + kBK <= sk &&
                           (!causal || k0 + kBK - 1 <= p_lo) &&
                           (window <= 0 || k0 > p_lo + 63 - window);
        uint32_t ok = 0xffffffffu;
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int idx = 4 * j + 2 * h + e;
              float x = sc[idx] * sl2;
              if (!whole) {
                const int col = k0 + 8 * j + col0 + e;
                const int pos = row0 + 8 * h + q_off;
                if (!(col < sk && (!causal || col <= pos) &&
                      (window <= 0 || col > pos - window))) {
                  ok &= ~(1u << idx);
                  x = kNegInf;
                }
              }
              sc[idx] = x;
              mx[h] = fmaxf(mx[h], x);
            }
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(m[h], mx[h]);
          alpha[h] = exp2f(m[h] - m_new);
          m[h] = m_new;
          l[h] *= alpha[h];
        }
#pragma unroll
        for (int idx = 0; idx < 32; ++idx) {
          const int h = (idx / 2) % 2;
          const float p = (ok >> idx) & 1u ? exp2f(sc[idx] - m[h]) : 0.f;
          sc[idx] = p;
          l[h] += p;
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];

        // O += P_hi V + P_lo V, V read MN-major
        wgmma_split_nd<D>(o, sc, vt);
      }
      mbar_arrive(&empty_bar[s]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int row = row0 + 8 * h;
      if (row >= sq) continue;
      // the row's log-sum-exp in natural-log units (-inf: no allowed key)
      if (lse != nullptr && lane % 4 == 0)
        lse[static_cast<size_t>(bh) * sq + row] =
            l[h] > 0.f ? (m[h] + log2f(l[h])) * kLn2 : qf::neg_inf();
      const float denom = fmaxf(l[h], 1e-30f);
      __nv_bfloat16* orow = out + (static_cast<size_t>(bh) * sq + row) * D;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c + col0) =
            __floats2bfloat162_rn(o[4 * c + 2 * h] / denom,
                                  o[4 * c + 2 * h + 1] / denom);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int bh, int bk, int sq, int sk, int causal, int window,
           int q_off, void* stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, bh, sq, D, kBQ) || !make_map(&mk, k, bk, sk, D, kBK) ||
      !make_map(&mv, v, bk, sk, D, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Shape<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (sq + kBQ - 1) / kBQ);
  flash_wgmma_kernel<D><<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
      bh / bk, sq, sk, causal, window, q_off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace qf {

// bf16 q (bh, sq, dh), k/v (bk, sk, dh), bh a multiple of bk; lse fp32
// (bh, sq) or null; query row i at position i + q_off; the C entry point
// qf_flash_attention (flash_attention.cu) checks the counts.
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, void* lse, int bh, int bk, int sq, int sk,
                         int dh, int causal, int window, int q_off,
                         void* stream) {
  const void* ptrs[4] = {q, k, v, out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16)    // TMA's alignment
      return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 64:
      return launch<64>(q, k, v, out, lse, bh, bk, sq, sk, causal, window,
                       q_off, stream);
    case 128:
      return launch<128>(q, k, v, out, lse, bh, bk, sq, sk, causal, window,
                        q_off, stream);
    case 256:
      return launch<256>(q, k, v, out, lse, bh, bk, sq, sk, causal, window,
                        q_off, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace qf
