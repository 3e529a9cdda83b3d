// Backward of the causal / sliding-window flash attention with
// grouped-query heads, fp32 storage: dQ, dK and dV of the function the
// fp32 forward kernel computes (flash_attention.cu), every product and
// sum in fp32 on the CUDA cores. bf16 storage runs on the tensor cores
// instead (flash_attention_bwd_wgmma.cu); the C entry point below picks
// the kernels by dtype.
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
// gradient.
//
// What bounds it on an H100: operations. The five products (QK^T, dO V^T,
// dS K, dS^T Q, P^T dO) are 10 D FLOP per allowed pair on the fp32 CUDA
// cores (67 TFLOP/s): fp32 inputs have no tensor-core path that keeps
// the fp32 products. Both kernels recompute QK^T and dO V^T (8 products
// a pair instead of 5).
//
// Design: two kernels, launched one after the other by the C entry point.
//  A. one 256-thread block per (64 query rows, query head) walks the key
//     tiles of 32 that its rows' masks allow once: with the forward's LSE
//     and D_i from O and dO, it recomputes P and dS and accumulates dQ in
//     registers (4 rows x D/16 columns a thread). It writes dQ, and each
//     row's D_i to a workspace. Q^T and dO^T stay in shared memory; each
//     key tile is
//     staged in row layout with an odd pitch (D + 1 floats), so the 16
//     lanes of a half-warp reading 16 keys at one column hit 16 banks.
//  B. one 256-thread block per (32 keys, kv head) owns dK and dV of its
//     keys (2 keys x D/16 columns a thread, each in registers): it loops
//     over the G query heads of the group and over the query tiles of 32
//     that its keys' masks allow, recomputes S^T and dP^T from K^T and
//     V^T (resident) and the staged Q and dO tile, forms P and dS from
//     the LSE and the workspace's D_i, and accumulates P^T dO and dS^T Q.
//     GQA's sum over the group happens inside the block.
// No atomics and no order between blocks: the same inputs give the same
// bits. Shared memory at D = 256, fp32 tiles: A 213,760 bytes
// (Q^T 68 KB, dO^T 68 KB, K 32 KB, V 32 KB, dS^T 8.5 KB), B 148,992
// (K^T 36 KB, V^T 36 KB, Q 32 KB, dO 32 KB, P and dS 9 KB); one block an
// SM for A, one for B. Key tiles above the diagonal or below the window
// are skipped in A, query tiles likewise in B; masked entries inside a
// tile get probability 0. Rows past Sq and keys past Sk are masked, not
// padded in device memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;    // 16 x 16
constexpr int kAQ = 64;          // A: query rows a block
constexpr int kAK = 32;          // A: keys a tile
constexpr int kBK = 32;          // B: keys a block
constexpr int kBQ = 32;          // B: query rows a tile
constexpr int kAQP = kAQ + 4;    // pitch of Q^T, dO^T and dS^T rows (floats)
constexpr int kBKP = kBK + 4;    // pitch of K^T, V^T, P and dS rows (floats)

template <int D>
constexpr size_t smem_a() {
  return sizeof(float) * (2 * static_cast<size_t>(D) * kAQP +
                          2 * static_cast<size_t>(kAK) * (D + 1) +
                          static_cast<size_t>(kAK) * kAQP);
}

template <int D>
constexpr size_t smem_b() {
  return sizeof(float) * (2 * static_cast<size_t>(D) * kBKP +
                          2 * static_cast<size_t>(kBQ) * (D + 1) +
                          2 * static_cast<size_t>(kBQ) * kBKP + 2 * kBQ);
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ bool allowed(int row, int col, int sk, int causal,
                                        int window) {
  return col < sk && (!causal || col <= row) &&
         (window <= 0 || col > row - window);
}

// rows [r0, r0 + n) of a (rows, D) tensor into shared memory, row layout
// with pitch D + 1; rows at or past `rows` are zero
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int r0, int n, int rows) {
  for (int idx = threadIdx.x; idx < n * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    dst[r * (D + 1) + d] =
        r0 + r < rows ? src[static_cast<size_t>(r0 + r) * D + d] : 0.f;
  }
}

// the same rows transposed: dst[d * pitch + r]
template <int D>
__device__ __forceinline__ void stage_cols(float* dst, const float* src,
                                           int r0, int n, int rows,
                                           int pitch) {
  for (int idx = threadIdx.x; idx < n * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    dst[d * pitch + r] =
        r0 + r < rows ? src[static_cast<size_t>(r0 + r) * D + d] : 0.f;
  }
}

// ---------------------------------------------------------------- kernel A
// Thread (ty, tx) owns query rows 4ty + i (i < 4); in a score tile, keys
// tx + 16j (j < 2); in dQ, columns tx + 16m (m < D/16).
template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ o,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ dq,
                   float* __restrict__ dd_ws, int group, int sq, int sk,
                   int causal, int window) {
  constexpr int kNM = D / 16;
  constexpr int kKP = D + 1;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                 // [D][kAQP]   Q^T
  float* dot = qt + D * kAQP;       // [D][kAQP]   dO^T
  float* ks = dot + D * kAQP;       // [kAK][kKP]  K
  float* vs = ks + kAK * kKP;       // [kAK][kKP]  V
  float* dst = vs + kAK * kKP;      // [kAK][kAQP] dS^T

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kAQ;
  const size_t qoff = static_cast<size_t>(bh) * sq * D;
  const float* kb = k + static_cast<size_t>(bh / group) * sk * D;
  const float* vb = v + static_cast<size_t>(bh / group) * sk * D;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));

  stage_cols<D>(qt, q + qoff, q0, kAQ, sq, kAQP);
  stage_cols<D>(dot, dout + qoff, q0, kAQ, sq, kAQP);
  __syncthreads();  // dO^T is read below even where no key tile is allowed

  const int q_hi = min(q0 + kAQ, sq) - 1;
  const int k_hi = causal ? min(sk - 1, q_hi) : sk - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / kAK;
  const int t_hi = k_hi >= k_lo ? k_hi / kAK : t_lo - 1;

  // scores of rows 4ty+i against keys tx+16j of the staged tile, scaled
  // and masked (ok), from Q^T and K
  auto scores = [&](int k0, float (&s)[4][2], bool (&ok)[4][2]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a =
          *reinterpret_cast<const float4*>(qt + d * kAQP + 4 * ty);
      const float b0 = ks[tx * kKP + d], b1 = ks[(tx + 16) * kKP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] = fmaf(comp(a, i), b0, s[i][0]);
        s[i][1] = fmaf(comp(a, i), b1, s[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        ok[i][j] = q0 + 4 * ty + i < sq &&
                   allowed(q0 + 4 * ty + i, k0 + tx + 16 * j, sk, causal,
                           window);
        s[i][j] *= scale;
      }
  };

  // the forward's LSE and D_i = sum_c dO_ic O_ic of each row; D_i to the
  // workspace
  float lse_i[4], dd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    lse_i[i] = row < sq ? lse[static_cast<size_t>(bh) * sq + row] : 0.f;
    float part = 0.f;
    if (row < sq) {
      const float* orow = o + qoff + static_cast<size_t>(row) * D;
      for (int c = tx; c < D; c += 16)
        part = fmaf(dot[c * kAQP + 4 * ty + i], orow[c], part);
    }
    dd[i] = half_warp_sum(part);
    if (tx == 0 && row < sq) dd_ws[static_cast<size_t>(bh) * sq + row] = dd[i];
  }

  // P, dS, and dQ += dS K
  float acc[4][kNM];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < kNM; ++m) acc[i][m] = 0.f;

  for (int tile = t_lo; tile <= t_hi; ++tile) {
    const int k0 = tile * kAK;
    __syncthreads();
    stage_rows<D>(ks, kb, k0, kAK, sk);
    stage_rows<D>(vs, vb, k0, kAK, sk);
    __syncthreads();
    float s[4][2];
    bool ok[4][2];
    scores(k0, s, ok);
    float dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a =
          *reinterpret_cast<const float4*>(dot + d * kAQP + 4 * ty);
      const float b0 = vs[tx * kKP + d], b1 = vs[(tx + 16) * kKP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dp[i][0] = fmaf(comp(a, i), b0, dp[i][0]);
        dp[i][1] = fmaf(comp(a, i), b1, dp[i][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ok[i][j] ? expf(s[i][j] - lse_i[i]) : 0.f;
        ds[i] = p * (dp[i][j] - dd[i]);
      }
      *reinterpret_cast<float4*>(dst + (tx + 16 * j) * kAQP + 4 * ty) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < kAK; ++c) {
      const float4 a =
          *reinterpret_cast<const float4*>(dst + c * kAQP + 4 * ty);
#pragma unroll
      for (int m = 0; m < kNM; ++m) {
        const float b = ks[c * kKP + tx + 16 * m];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][m] = fmaf(comp(a, i), b, acc[i][m]);
      }
    }
  }

  float* dqb = dq + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= sq) continue;
#pragma unroll
    for (int m = 0; m < kNM; ++m)
      dqb[static_cast<size_t>(row) * D + tx + 16 * m] = scale * acc[i][m];
  }
}

// ---------------------------------------------------------------- kernel B
// Thread (ty, tx) owns keys 2ty + a (a < 2); in a score tile, query rows
// tx + 16j (j < 2); in dK and dV, columns tx + 16m (m < D/16).
template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dd_ws, float* __restrict__ dk,
                     float* __restrict__ dv, int group, int sq, int sk,
                     int causal, int window) {
  constexpr int kNM = D / 16;
  constexpr int kQP = D + 1;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                 // [D][kBKP]   K^T
  float* vt = kt + D * kBKP;        // [D][kBKP]   V^T
  float* qs = vt + D * kBKP;        // [kBQ][kQP]  Q
  float* dos = qs + kBQ * kQP;      // [kBQ][kQP]  dO
  float* ps = dos + kBQ * kQP;      // [kBQ][kBKP] P
  float* dss = ps + kBQ * kBKP;     // [kBQ][kBKP] dS
  float* lse_s = dss + kBQ * kBKP;  // [kBQ]
  float* dd_s = lse_s + kBQ;        // [kBQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bk = blockIdx.y;
  const int k0 = blockIdx.x * kBK;
  const size_t kvoff = static_cast<size_t>(bk) * sk * D;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));

  stage_cols<D>(kt, k + kvoff, k0, kBK, sk, kBKP);
  stage_cols<D>(vt, v + kvoff, k0, kBK, sk, kBKP);

  // query rows that some key of this block may pair with
  const int key_hi = min(k0 + kBK, sk) - 1;
  const int i_lo = causal ? k0 : 0;
  const int i_hi = window > 0 ? min(sq - 1, key_hi + window - 1) : sq - 1;
  const int t_lo = i_lo / kBQ;
  const int t_hi = i_hi >= i_lo ? i_hi / kBQ : t_lo - 1;

  float acc_k[2][kNM], acc_v[2][kNM];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int m = 0; m < kNM; ++m) acc_k[a][m] = acc_v[a][m] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int bh = bk * group + g;
    const size_t qoff = static_cast<size_t>(bh) * sq * D;
    for (int tile = t_lo; tile <= t_hi; ++tile) {
      const int i0 = tile * kBQ;
      __syncthreads();  // the previous tile's readers are done (K, V in)
      stage_rows<D>(qs, q + qoff, i0, kBQ, sq);
      stage_rows<D>(dos, dout + qoff, i0, kBQ, sq);
      if (tid < kBQ) {
        const bool in = i0 + tid < sq;
        const size_t r = static_cast<size_t>(bh) * sq + i0 + tid;
        lse_s[tid] = in ? lse[r] : 0.f;
        dd_s[tid] = in ? dd_ws[r] : 0.f;
      }
      __syncthreads();

      float s[2][2], dp[2][2];
#pragma unroll
      for (int a = 0; a < 2; ++a) s[a][0] = s[a][1] = dp[a][0] = dp[a][1] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float2 kk =
            *reinterpret_cast<const float2*>(kt + d * kBKP + 2 * ty);
        const float2 vv =
            *reinterpret_cast<const float2*>(vt + d * kBKP + 2 * ty);
        const float q0v = qs[tx * kQP + d], q1v = qs[(tx + 16) * kQP + d];
        const float o0v = dos[tx * kQP + d], o1v = dos[(tx + 16) * kQP + d];
        s[0][0] = fmaf(kk.x, q0v, s[0][0]);
        s[0][1] = fmaf(kk.x, q1v, s[0][1]);
        s[1][0] = fmaf(kk.y, q0v, s[1][0]);
        s[1][1] = fmaf(kk.y, q1v, s[1][1]);
        dp[0][0] = fmaf(vv.x, o0v, dp[0][0]);
        dp[0][1] = fmaf(vv.x, o1v, dp[0][1]);
        dp[1][0] = fmaf(vv.y, o0v, dp[1][0]);
        dp[1][1] = fmaf(vv.y, o1v, dp[1][1]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qi = tx + 16 * j;
        const int row = i0 + qi;
        float p[2], ds[2];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const bool ok =
              row < sq && allowed(row, k0 + 2 * ty + a, sk, causal, window);
          p[a] = ok ? expf(s[a][j] * scale - lse_s[qi]) : 0.f;
          ds[a] = p[a] * (dp[a][j] - dd_s[qi]);
        }
        *reinterpret_cast<float2*>(ps + qi * kBKP + 2 * ty) =
            make_float2(p[0], p[1]);
        *reinterpret_cast<float2*>(dss + qi * kBKP + 2 * ty) =
            make_float2(ds[0], ds[1]);
      }
      __syncthreads();

#pragma unroll 2
      for (int qi = 0; qi < kBQ; ++qi) {
        const float2 pk =
            *reinterpret_cast<const float2*>(ps + qi * kBKP + 2 * ty);
        const float2 dk2 =
            *reinterpret_cast<const float2*>(dss + qi * kBKP + 2 * ty);
#pragma unroll
        for (int m = 0; m < kNM; ++m) {
          const float ov = dos[qi * kQP + tx + 16 * m];
          const float qv = qs[qi * kQP + tx + 16 * m];
          acc_v[0][m] = fmaf(pk.x, ov, acc_v[0][m]);
          acc_v[1][m] = fmaf(pk.y, ov, acc_v[1][m]);
          acc_k[0][m] = fmaf(dk2.x, qv, acc_k[0][m]);
          acc_k[1][m] = fmaf(dk2.y, qv, acc_k[1][m]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int key = k0 + 2 * ty + a;
    if (key >= sk) continue;
    const size_t r = kvoff + static_cast<size_t>(key) * D;
#pragma unroll
    for (int m = 0; m < kNM; ++m) {
      dk[r + tx + 16 * m] = scale * acc_k[a][m];
      dv[r + tx + 16 * m] = acc_v[a][m];
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, const float* lse, float* dq, float* dk,
           float* dv, float* dd, int bh, int bk, int sq, int sk, int causal,
           int window, cudaStream_t st) {
  const int group = bh / bk;
  const size_t sa = smem_a<D>(), sb = smem_b<D>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sa));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sb));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq_kernel<D><<<dim3((sq + kAQ - 1) / kAQ, bh), kThreads, sa, st>>>(
      q, k, v, o, dout, lse, dq, dd, group, sq, sk, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv_kernel<D><<<dim3((sk + kBK - 1) / kBK, bk), kThreads, sb,
                            st>>>(q, k, v, dout, lse, dd, dk, dv, group, sq,
                                  sk, causal, window);
  return static_cast<int>(cudaGetLastError());
}

int launch_dh(const float* q, const float* k, const float* v, const float* o,
              const float* dout, const float* lse, float* dq, float* dk,
              float* dv, float* dd, int bh, int bk, int sq, int sk, int dh,
              int causal, int window, cudaStream_t st) {
  switch (dh) {
    case 64:
      return launch<64>(q, k, v, o, dout, lse, dq, dk, dv, dd, bh, bk, sq, sk,
                        causal, window, st);
    case 128:
      return launch<128>(q, k, v, o, dout, lse, dq, dk, dv, dd, bh, bk, sq,
                         sk, causal, window, st);
    case 256:
      return launch<256>(q, k, v, o, dout, lse, dq, dk, dv, dd, bh, bk, sq,
                         sk, causal, window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o, dout, dq (bh, sq, dh); k, v, dk, dv (bk, sk, dh) with bh a
// multiple of bk; lse fp32 (bh, sq), the forward's (qf_flash_attention);
// dd an fp32 workspace of (bh, sq); dh 64, 128 or 256; dtype a qf::DType
// (the same for every tensor but lse and the workspaces). bf16 also
// takes part, an fp32 workspace of (splits, 2, bk, sk, dh), splits
// dividing the G = bh / bk query heads of a kv head among blocks
// (flash_attention_bwd_wgmma.cu); fp32 ignores both.
extern "C" int qf_flash_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* dq, void* dk, void* dv, void* dd,
                                      void* part, int bh, int bk, int sq,
                                      int sk, int dh, int causal, int window,
                                      int splits, int dtype, void* stream) {
  if (bh <= 0 || bk <= 0 || bh % bk || bh > 65535 || sq <= 0 || sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case qf::kFloat32:
      return launch_dh(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(o),
          static_cast<const float*>(dout), static_cast<const float*>(lse),
          static_cast<float*>(dq), static_cast<float*>(dk),
          static_cast<float*>(dv), static_cast<float*>(dd), bh, bk, sq, sk,
          dh, causal, window, static_cast<cudaStream_t>(stream));
    case qf::kBFloat16:
      return qf::flash_attention_bwd_bf16(q, k, v, o, dout, lse, dq, dk, dv,
                                          dd, part, bh, bk, sq, sk, dh,
                                          causal, window, splits, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
