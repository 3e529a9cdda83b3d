// Backward of the causal / sliding-window flash attention with
// grouped-query heads, fp32 storage: dQ, dK and dV of the function the
// fp32 forward kernel computes (flash_attention.cu), the fp32 function,
// with its five products on Hopper's tensor cores in 3xTF32 (tf32.cuh).
// bf16 storage runs on wgmma instead (flash_attention_bwd_wgmma.cu); the
// C entry point below picks the kernels by dtype.
//
// Replaces: the gradient of src/repro/kernels/flash_attention.py::
// flash_attention. The TPU kernel has no backward of its own: the
// reference trains through plain dot_attention, which XLA differentiates
// (src/repro/models/layers/attention.py:84-100, dq/dk/dv cast back to the
// inputs' dtype by _grad_dtype_fence). The port trains through its
// forward kernel, so this is that kernel's gradient.
//
// Semantics are those of repro_torch.kernels.ref.attention_bwd_ref:
// q, o, dO (BH, Sq, D); k, v (BH / G, Sk, D); query row bh reads kv row
// bh / G; query i and key j (positions from 0) pair when j < Sk,
// j <= i (causal) and j > i - window (window > 0); scores scaled by
// 1/sqrt(D). With LSE_i the forward's log-sum-exp of row i (natural-log
// units) and P_ij = exp(s_ij - LSE_i) for the allowed pairs (0 else),
//   D_i  = sum_c dO_ic O_ic
//   dS_ij = P_ij (dO_i . v_j - D_i)
//   dQ_i = scale sum_j dS_ij k_j,  dK_j = scale sum_i dS_ij q_i,
//   dV_j = sum_i P_ij dO_i,
// the sums over i running over the G query heads of kv head j's group as
// well. A row with no allowed key (its forward output 0) has no
// gradient. P is formed as exp(fma(s_ij, 1/sqrt(D), -LSE_i)): one
// rounding of the exponent.
//
// What bounds it on an H100: operations. The five products (QK^T, dO V^T,
// dS K, dS^T Q, P^T dO) are 10 D FLOP an allowed pair; both passes
// recompute QK^T and dO V^T, 14 D in all (7 products a pair). Each runs
// on the tensor cores in 3xTF32 (mma.sync m16n8k8 .tf32): operands split
// as x = hi + lo, the products lo hi, hi lo and hi hi, 495 / 3 = 165
// TFLOP/s against 67 on the fp32 CUDA cores. P and dS are split too: they
// are operands, and TF32 alone misses the fp32 tolerance. As in the
// forward, no chain of mmas into one accumulator is longer than 4
// k-steps (the tensor cores truncate each mma's sum): the score products
// sum D in chains of 32 columns added in fp32, and each tile's
// contribution to dQ, dK or dV is one chain added to its running sum in
// fp32 (attention_tf32.cuh). tests/test_torch_seq_kernels.py replays this
// arithmetic in the kernels' tile order on the CPU. mma.sync rather than
// wgmma for the reasons of the forward's note: every tile stays in its
// row layout, the score accumulators become the A operand of the next
// product with the k-step's columns permuted, and the operands are split
// in registers as they are loaded.
//
// Design: two passes and an ordered sum, no atomics, so the same inputs
// give the same bits.
//  A. dQ: one 256-thread block per (64 query rows, query head). Q and dO
//     stay in shared memory; each key tile of 32 is copied into a K and a
//     V buffer (cp.async). Warp w owns rows 16 (w % 4).. + 15 and the
//     keys 16 (w / 4).. + 15 of every tile: dP = dO V^T and S = Q K^T
//     (16 x 16), P and dS in registers, dQ += dS K (16 x D in registers:
//     D / 2 floats a thread). The two warps of a row group add their dQ
//     halves in a fixed order at the end, through shared memory. D_i
//     (from O and dO) goes to a workspace for pass B. Copies overlap the
//     products: V of the next tile is copied once every warp has formed
//     dP, under S, dS and dQ; K of the next tile once dQ is done, under
//     the next tile's dP. Query blocks run last-first.
//  B. dK, dV: one 256-thread block per (64 keys, kv head, split of the
//     group's G query heads); K and V stay in shared memory, 32-row Q and
//     dO tiles of the split's heads are copied in turn. Warp w < 4 owns
//     dV of keys 16w..16w+15: S^T = K Q^T, P^T from the LSE, then
//     dV += P^T dO. Warp w + 4 owns dK of the same keys: dP^T = V dO^T,
//     P^T from warp w through shared memory (a named barrier a pair;
//     both hold the same accumulator layout, so lane l hands its 16
//     values to lane l), dS^T = P^T (dP^T - D_i), dK += dS^T Q. dK and dV
//     of 16 keys are D / 2 floats a thread each; split so, the two warps
//     do the same tensor-core work. Each block writes fp32 partial sums
//     over its heads (bwd_splits in kernels/flash_attention.py picks the
//     splits: two waves of 64-key blocks over the card's SMs, at most G).
//     Key blocks run first-first (under causal, the most query tiles
//     first).
//  C. an elementwise pass sums the splits' partials in split order and
//     stores dK (scaled) and dV.
// Shared memory at D = 256, row pitch D + 4 floats: A, Q and dO 130 KB +
// K and V 65 KB + LSE and D_i = 200,192 bytes; B, K and V 130 KB + Q and
// dO 65 KB + the P^T exchange 8 KB + LSE and D_i = 208,128; one block an
// SM. Key tiles above the diagonal or below the window are skipped in A,
// query tiles likewise in B; masked entries inside a tile get probability
// 0. Rows past Sq and keys past Sk are zero-filled in shared memory and
// masked, never read from device memory.
//
// Against the plain version: at the reference init's logits the plain
// fp32 gradients are themselves up to 1.4e-4 of their scale off the same
// function computed in fp64 (phase 11's inputs), and the CUDA-core
// kernels this one replaces, summing by sequential fmas over D, stayed
// within 1e-4 of them by repeating their rounding; this one does not,
// and is nearer the fp64 gradients (1.0e-4 at most; the forward's note;
// chip_smoke.py's phase 11 measures both).
#include <utility>

#include "attention_tf32.cuh"
#include "hopper.cuh"

namespace {

using namespace qf::attn32;

constexpr int kThreads = 256;    // 8 warps
constexpr int kAQ = 64;          // A: query rows a block
constexpr int kAK = 32;          // A: keys a tile
constexpr int kBK = 64;          // B: keys a block (bwd_splits counts these)
constexpr int kBQ = 32;          // B: query rows a tile

template <int D>
__host__ __device__ constexpr int pitch() {
  return D + 4;
}

template <int D>
constexpr size_t smem_a() {
  return sizeof(float) * (2 * static_cast<size_t>(kAQ + kAK) * pitch<D>() +
                          2 * kAQ);
}

template <int D>
constexpr size_t smem_b() {
  return sizeof(float) * (2 * static_cast<size_t>(kBK + kBQ) * pitch<D>() +
                          4 * 16 * kBQ + 2 * kBQ);
}

// ---------------------------------------------------------------- pass A
template <int D, bool kNaN>
__device__ __forceinline__ void attn_bwd_dq_body(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ o,
    const float* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ dq, float* __restrict__ dd_ws, int group, int sq,
    int sk, int causal, int window) {
  constexpr int kP = pitch<D>();
  constexpr int kN = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [kAQ][kP]  Q
  float* dos = qs + kAQ * kP;       // [kAQ][kP]  dO
  float* ks = dos + kAQ * kP;       // [kAK][kP]  K tile
  float* vs = ks + kAK * kP;        // [kAK][kP]  V tile
  float* lse_s = vs + kAK * kP;     // [kAQ]
  float* dd_s = lse_s + kAQ;        // [kAQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp & 3, kh = warp >> 2;   // row group, key half
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kAQ;
  const size_t qoff = static_cast<size_t>(bh) * sq * D;
  const float* kb = k + static_cast<size_t>(bh / group) * sk * D;
  const float* vb = v + static_cast<size_t>(bh / group) * sk * D;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const float one[2] = {1.f, 1.f};          // acc_pairs: acc += A B

  const int q_hi = min(q0 + kAQ, sq) - 1;
  const int k_hi = causal ? min(sk - 1, q_hi) : sk - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / kAK;
  const int t_hi = k_hi >= k_lo ? k_hi / kAK : t_lo - 1;

  // groups in flight: {Q, dO, V(t_lo)}, {K(t_lo)}
  stage_rows<D, kThreads>(qs, kP, q + qoff, q0, kAQ, sq);
  stage_rows<D, kThreads>(dos, kP, dout + qoff, q0, kAQ, sq);
  if (t_lo <= t_hi) stage_rows<D, kThreads>(vs, kP, vb, t_lo * kAK, kAK, sk);
  cp_async_commit();
  if (t_lo <= t_hi) stage_rows<D, kThreads>(ks, kP, kb, t_lo * kAK, kAK, sk);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // the forward's LSE and D_i = sum_c dO_ic O_ic of each row (warp w:
  // rows 8w..8w+7); D_i to the workspace
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * warp + i, row = q0 + r;
    float part = 0.f;
    if (row < sq) {
      const float* orow = o + qoff + static_cast<size_t>(row) * D;
      for (int c = lane; c < D; c += 32)
        part = fmaf(dos[r * kP + c], orow[c], part);
    }
    part = qf::warp_sum(part);   // lane 0's
    if (lane == 0) {
      dd_s[r] = part;
      lse_s[r] = row < sq ? lse[static_cast<size_t>(bh) * sq + row] : 0.f;
      if (row < sq) dd_ws[static_cast<size_t>(bh) * sq + row] = part;
    }
  }
  __syncthreads();
  const int ra = 16 * rw;              // the warp's rows in the block
  const float lse_r[2] = {lse_s[ra + g], lse_s[ra + g + 8]};
  const float dd_r[2] = {dd_s[ra + g], dd_s[ra + g + 8]};
  const int row0 = q0 + ra + g;        // rows row0 and row0 + 8
  const float* qw = qs + ra * kP;
  const float* dow = dos + ra * kP;

  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int tile = t_lo; tile <= t_hi; ++tile) {
    const int k0 = tile * kAK;
    const int kw = 16 * kh;            // the warp's keys in the tile
    cp_async_wait<1>();   // V(tile) is in; K(tile) may be in flight
    __syncthreads();
    // dP = dO V^T: the warp's rows x its 16 keys (2 n-tiles)
    float dp[2][4], s[2][4];
    dot_rows<D, 2, kNaN>(dp, dow, vs + kw * kP, kP, g, t);
    __syncthreads();      // every warp is done with V(tile)
    if (tile < t_hi) stage_rows<D, kThreads>(vs, kP, vb, k0 + kAK, kAK, sk);
    cp_async_commit();
    cp_async_wait<1>();   // K(tile) is in; V(tile + 1) may be in flight
    __syncthreads();
    // S = Q K^T
    dot_rows<D, 2, kNaN>(s, qw, ks + kw * kP, kP, g, t);
    // P and dS (in s) of rows row0 + 8h, keys k0 + kw + 8j + 2t + e
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = row0 + 8 * h;
          const bool ok = row < sq && allowed(row, k0 + kw + 8 * j + 2 * t + e,
                                              sk, causal, window);
          const float p = ok ? expf(fmaf(s[j][2 * h + e], scale, -lse_r[h]))
                             : 0.f;
          s[j][2 * h + e] = p * (dp[j][2 * h + e] - dd_r[h]);
        }
    // dQ += dS K over the warp's 16 keys (2 k-steps)
    const Frag fa[2] = {a_acc<kNaN>(s[0]), a_acc<kNaN>(s[1])};
    acc_pairs<D, 2, kNaN>(acc, fa, one, ks + kw * kP, kP, g, t);
    __syncthreads();      // every warp is done with K(tile)
    if (tile < t_hi) stage_rows<D, kThreads>(ks, kP, kb, k0 + kAK, kAK, sk);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();        // Q's buffer takes the second key half's dQ

  float* xs = qs;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* xr = xs + (ra + g + 8 * h) * kP + 2 * t;
    if (kh == 1) {
#pragma unroll
      for (int n = 0; n < kN; ++n)
        *reinterpret_cast<float2*>(xr + 8 * n) =
            make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
  __syncthreads();
  if (kh == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= sq) continue;
      const float* xr = xs + (ra + g + 8 * h) * kP + 2 * t;
      float* out = dq + qoff + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float2 b = *reinterpret_cast<const float2*>(xr + 8 * n);
        *reinterpret_cast<float2*>(out + 8 * n) =
            make_float2((acc[n][2 * h] + b.x) * scale,
                        (acc[n][2 * h + 1] + b.y) * scale);
      }
    }
  }
}

// Both splits are launched, each built alone (the four-instruction one
// keeps its registers and its time); the one *nan_flag (scan_nans) does
// not pick returns at once. Likewise pass B.
template <int D, bool kNaN>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ o,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ dq,
                   float* __restrict__ dd_ws,
                   const int* __restrict__ nan_flag, int group, int sq,
                   int sk, int causal, int window) {
  if ((*nan_flag != 0) != kNaN) return;
  attn_bwd_dq_body<D, kNaN>(q, k, v, o, dout, lse, dq, dd_ws, group, sq, sk,
                            causal, window);
}

// ---------------------------------------------------------------- pass B
template <int D, bool kNaN>
__device__ __forceinline__ void attn_bwd_dkdv_body(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dd_ws,
    float* __restrict__ part, int group, int splits, int sq, int sk,
    int causal, int window) {
  constexpr int kP = pitch<D>();
  constexpr int kN = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                 // [kBK][kP]  K
  float* vs = ks + kBK * kP;        // [kBK][kP]  V
  float* qs = vs + kBK * kP;        // [kBQ][kP]  Q tile
  float* dos = qs + kBQ * kP;       // [kBQ][kP]  dO tile
  float* xs = dos + kBQ * kP;       // [4][16][kBQ] P^T, warp w to w + 4
  float* lse_s = xs + 4 * 16 * kBQ; // [kBQ]
  float* dd_s = lse_s + kBQ;        // [kBQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = warp & 3, role = warp >> 2;   // key group; 0 dV, 1 dK
  const int bk = gridDim.x / splits;
  const int kvh = blockIdx.x / splits, sp = blockIdx.x % splits;
  const int k0 = blockIdx.y * kBK;
  const size_t kvoff = static_cast<size_t>(kvh) * sk * D;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const int g_lo = sp * group / splits, g_hi = (sp + 1) * group / splits;
  const float one[2] = {1.f, 1.f};          // acc_pairs: acc += A B

  stage_rows<D, kThreads>(ks, kP, k + kvoff, k0, kBK, sk);
  stage_rows<D, kThreads>(vs, kP, v + kvoff, k0, kBK, sk);
  cp_async_commit();

  // query rows that some key of this block may pair with
  const int key_hi = min(k0 + kBK, sk) - 1;
  const int i_lo = causal ? k0 : 0;
  const int i_hi = window > 0 ? min(sq - 1, key_hi + window - 1) : sq - 1;
  const int t_lo = i_lo / kBQ;
  const int t_hi = i_hi >= i_lo ? i_hi / kBQ : t_lo - 1;

  // the warp's A operand rows: K for S^T, V for dP^T
  const float* aw = (role == 0 ? ks : vs) + 16 * kw * kP;
  const float* bw = role == 0 ? qs : dos;   // B of the first product
  const float* cw = role == 0 ? dos : qs;   // B of the second
  float* xw = xs + kw * 16 * kBQ;
  const int key0 = k0 + 16 * kw + g;        // keys key0 and key0 + 8
  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int hq = g_lo; hq < g_hi; ++hq) {
    const int bh = kvh * group + hq;
    const size_t qoff = static_cast<size_t>(bh) * sq * D;
    for (int tile = t_lo; tile <= t_hi; ++tile) {
      const int i0 = tile * kBQ;
      __syncthreads();    // the previous tile's readers are done
      stage_rows<D, kThreads>(qs, kP, q + qoff, i0, kBQ, sq);
      stage_rows<D, kThreads>(dos, kP, dout + qoff, i0, kBQ, sq);
      cp_async_commit();
      if (tid < kBQ) {
        const bool in = i0 + tid < sq;
        const size_t r = static_cast<size_t>(bh) * sq + i0 + tid;
        lse_s[tid] = in ? lse[r] : 0.f;
        dd_s[tid] = in ? dd_ws[r] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      // S^T = K Q^T (dV warps) or dP^T = V dO^T (dK warps): the warp's 16
      // keys x the tile's 32 query rows (4 n-tiles); element (key0 + 8h,
      // query i0 + 8j + 2t + e) at x[j][2h + e]
      float x[4][4];
      dot_rows<D, 4, kNaN>(x, aw, bw, kP, g, t);
      if (role == 0) {
        // P^T, handed to the dK warp of the same keys
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int qi = 8 * j + 2 * t + (c & 1), row = i0 + qi;
            const bool ok = row < sq && allowed(row, key0 + 8 * (c >> 1), sk,
                                                causal, window);
            x[j][c] = ok ? expf(fmaf(x[j][c], scale, -lse_s[qi])) : 0.f;
            xw[(4 * j + c) * 32 + lane] = x[j][c];
          }
        qf::hopper::named_arrive(1 + kw, 64);
      } else {
        qf::hopper::named_sync(1 + kw, 64);
        // dS^T = P^T (dP^T - D_i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            x[j][c] = xw[(4 * j + c) * 32 + lane] *
                      (x[j][c] - dd_s[8 * j + 2 * t + (c & 1)]);
      }
      // dV += P^T dO, or dK += dS^T Q, over the tile's 32 rows (4 k-steps)
      Frag fa[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) fa[j] = a_acc<kNaN>(x[j]);
      acc_pairs<D, 4, kNaN>(acc, fa, one, cw, kP, g, t);
    }
  }
  cp_async_wait<0>();

  // fp32 partials: part[sp][role][kvh][key][D] (role 0: dV, 1: dK unscaled)
  float* out = part + ((static_cast<size_t>(sp) * 2 + role) * bk + kvh) *
                          static_cast<size_t>(sk) * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= sk) continue;
    float* r = out + static_cast<size_t>(key) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kN; ++n)
      *reinterpret_cast<float2*>(r + 8 * n) =
          make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

template <int D, bool kNaN>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dd_ws,
                     float* __restrict__ part,
                     const int* __restrict__ nan_flag, int group, int splits,
                     int sq, int sk, int causal, int window) {
  if ((*nan_flag != 0) != kNaN) return;
  attn_bwd_dkdv_body<D, kNaN>(q, k, v, dout, lse, dd_ws, part, group,
                              splits, sq, sk, causal, window);
}

// ---------------------------------------------------------------- pass C
// dv = sum_s part[s][0], dk = scale sum_s part[s][1], s in order; n is
// bk * sk * D, a multiple of 4
__global__ void attn_bwd_sum_kernel(const float* __restrict__ part,
                                    float* __restrict__ dk,
                                    float* __restrict__ dv, int splits,
                                    size_t n, float scale) {
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
    *reinterpret_cast<float4*>(dv + i) = a;
    *reinterpret_cast<float4*>(dk + i) =
        make_float4(scale * b.x, scale * b.y, scale * b.z, scale * b.w);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, const float* lse, float* dq, float* dk,
           float* dv, float* dd, float* part, int* nan_flag, int bh, int bk,
           int sq, int sk, int causal, int window, int splits,
           cudaStream_t st) {
  const int group = bh / bk;
  const size_t sa = smem_a<D>(), sb = smem_b<D>();
  const std::pair<const void*, size_t> attrs[4] = {
      {reinterpret_cast<const void*>(attn_bwd_dq_kernel<D, false>), sa},
      {reinterpret_cast<const void*>(attn_bwd_dq_kernel<D, true>), sa},
      {reinterpret_cast<const void*>(attn_bwd_dkdv_kernel<D, false>), sb},
      {reinterpret_cast<const void*>(attn_bwd_dkdv_kernel<D, true>), sb}};
  cudaError_t err = cudaSuccess;
  for (const auto& [fn, bytes] : attrs) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t nq = static_cast<size_t>(bh) * sq * D;
  const size_t nk = static_cast<size_t>(bk) * sk * D;
  const float* inputs[6] = {q, k, v, o, dout, lse};
  const size_t sizes[6] = {nq, nk, nk, nq, nq, static_cast<size_t>(bh) * sq};
  err = scan_nans(inputs, sizes, 6, nan_flag, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_a((sq + kAQ - 1) / kAQ, bh);
  attn_bwd_dq_kernel<D, false><<<grid_a, kThreads, sa, st>>>(
      q, k, v, o, dout, lse, dq, dd, nan_flag, group, sq, sk, causal,
      window);
  attn_bwd_dq_kernel<D, true><<<grid_a, kThreads, sa, st>>>(
      q, k, v, o, dout, lse, dq, dd, nan_flag, group, sq, sk, causal,
      window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_b(splits * bk, (sk + kBK - 1) / kBK);
  attn_bwd_dkdv_kernel<D, false><<<grid_b, kThreads, sb, st>>>(
      q, k, v, dout, lse, dd, part, nan_flag, group, splits, sq, sk, causal,
      window);
  attn_bwd_dkdv_kernel<D, true><<<grid_b, kThreads, sb, st>>>(
      q, k, v, dout, lse, dd, part, nan_flag, group, splits, sq, sk, causal,
      window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(bk) * sk * D;
  const size_t want = (n / 4 + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  attn_bwd_sum_kernel<<<blocks, 256, 0, st>>>(
      part, dk, dv, splits, n, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

int launch_dh(const float* q, const float* k, const float* v, const float* o,
              const float* dout, const float* lse, float* dq, float* dk,
              float* dv, float* dd, float* part, int* nan_flag, int bh,
              int bk, int sq, int sk, int dh, int causal, int window,
              int splits, cudaStream_t st) {
  const void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16)    // cp.async's and float4's
      return static_cast<int>(cudaErrorInvalidValue);
  if (splits < 1 || splits > bh / bk || lse == nullptr || dd == nullptr ||
      part == nullptr || nan_flag == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 64:
      return launch<64>(q, k, v, o, dout, lse, dq, dk, dv, dd, part,
                        nan_flag, bh, bk, sq, sk, causal, window, splits,
                        st);
    case 128:
      return launch<128>(q, k, v, o, dout, lse, dq, dk, dv, dd, part,
                         nan_flag, bh, bk, sq, sk, causal, window, splits,
                         st);
    case 256:
      return launch<256>(q, k, v, o, dout, lse, dq, dk, dv, dd, part,
                         nan_flag, bh, bk, sq, sk, causal, window, splits,
                         st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o, dout, dq (bh, sq, dh); k, v, dk, dv (bk, sk, dh) with bh a
// multiple of bk; lse fp32 (bh, sq), the forward's (qf_flash_attention);
// dd an fp32 workspace of (bh, sq); part an fp32 workspace of (splits, 2,
// bk, sk, dh), splits in [1, bh / bk] dividing the G = bh / bk query heads
// of a kv head among the dK/dV pass's blocks; nan_flag one int of device
// memory (fp32: whether an input holds a NaN; the bf16 kernels ignore
// it); dh 64, 128 or 256; dtype a
// qf::DType (the same for every tensor but lse and the workspaces); every
// tensor but lse and dd 16-byte aligned.
extern "C" int qf_flash_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* dq, void* dk, void* dv, void* dd,
                                      void* part, void* nan_flag, int bh,
                                      int bk, int sq, int sk, int dh,
                                      int causal, int window, int splits,
                                      int dtype, void* stream) {
  if (bh <= 0 || bk <= 0 || bh % bk || bh > 65535 || sq <= 0 || sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case qf::kFloat32:
      return launch_dh(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(o),
          static_cast<const float*>(dout), static_cast<const float*>(lse),
          static_cast<float*>(dq), static_cast<float*>(dk),
          static_cast<float*>(dv), static_cast<float*>(dd),
          static_cast<float*>(part), static_cast<int*>(nan_flag), bh, bk, sq,
          sk, dh, causal, window, splits, static_cast<cudaStream_t>(stream));
    case qf::kBFloat16:
      return qf::flash_attention_bwd_bf16(q, k, v, o, dout, lse, dq, dk, dv,
                                          dd, part, bh, bk, sq, sk, dh,
                                          causal, window, splits, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
