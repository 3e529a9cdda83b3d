// Causal / sliding-window flash attention with grouped-query heads:
// online softmax, every product and sum in fp32, fp32 storage. bf16
// storage runs on the tensor cores instead (flash_attention_wgmma.cu);
// the C entry point below picks the kernel by dtype.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel), the Pallas TPU kernel that streams 128-key blocks
// along its sequential grid axis with the running max, sum and output
// rows in VMEM scratch. The TPU kernel takes k/v already repeated to
// every query head (repro/kernels/ops.py); here a query head reads kv
// head bh / G directly, so the copies are never made.
//
// Semantics are those of repro.kernels.ref.attention_ref: q (BH, Sq, D),
// k/v (BH / G, Sk, D); query i and key j (positions from 0) pair when
// j < Sk, j <= i (causal) and j > i - window (window > 0); scores scaled
// by 1/sqrt(D). A row with no allowed key writes 0 (the TPU kernel's
// max(l, 1e-30) guard); such rows only arise when Sq > Sk + window - 1.
// On request each row's log-sum-exp m + log l of its scaled allowed
// scores goes to an fp32 (BH, Sq) output for the backward, in natural-log
// units (-inf for a row with no allowed key), as the bf16 kernel writes it.
//
// What bounds it on an H100: operations, on the fp32 CUDA cores (67
// TFLOP/s): fp32 inputs have no tensor-core path that keeps the fp32
// products (TF32 keeps 10 bits).
//
// Design: one 256-thread block per (64 query rows, head). The q tile
// stays in shared memory for the whole walk over key tiles of 64; each
// k/v tile is staged once into shared memory, transposed for K. Shared
// memory at D = 256 is Q^T 68 KB + K^T 68 KB + V 65 KB + P^T 17 KB =
// 223,232 bytes of the 232,448 a block may have (one block per SM).
// Thread (ty, tx) of a 16 x 16 grid owns query rows 4ty..4ty+3: it
// computes their scores against keys 4tx..4tx+3 of the tile from float4
// reads of the transposed tiles, and accumulates their output at
// columns 4tx + 64j (j < D/64) in registers (64 floats at D = 256). Row
// max and row sum are half-warp shuffles, since the 16 threads of a row
// sit in one half of a warp. Key tiles wholly above the diagonal, or
// wholly at or below i - window for every row of the block, are skipped;
// masked entries inside a tile get probability 0. Query rows past Sq
// and keys past Sk are masked, not padded in device memory.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kQP = kBQ + 4;     // pitch of Q^T and P^T rows (floats)
constexpr int kKP = kBK + 4;     // pitch of K^T rows (floats)
constexpr float kNegInf = -1.0e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(D) * kQP + static_cast<size_t>(D) * kKP +
          static_cast<size_t>(kBK) * (D + 4) + static_cast<size_t>(kBK) * kQP);
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out,
             float* __restrict__ lse, int group, int sq, int sk, int causal,
             int window) {
  constexpr int kNJ = D / 64;    // float4 column groups per thread
  constexpr int kVP = D + 4;     // pitch of V rows (floats)
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;              // [D][kQP]  Q^T
  float* kt = qt + D * kQP;      // [D][kKP]  K^T
  float* vs = kt + D * kKP;      // [kBK][kVP] V
  float* pt = vs + kBK * kVP;    // [kBK][kQP] P^T

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const float* qb = q + static_cast<size_t>(bh) * sq * D;
  const float* kb = k + static_cast<size_t>(bh / group) * sk * D;
  const float* vb = v + static_cast<size_t>(bh / group) * sk * D;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    qt[d * kQP + r] =
        q0 + r < sq ? qb[static_cast<size_t>(q0 + r) * D + d] : 0.f;
  }

  float acc[4][4 * kNJ];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kNJ; ++c) acc[i][c] = 0.f;
  }

  // key tiles that hold an allowed key for some real row of this block
  const int q_hi = min(q0 + kBQ, sq) - 1;
  const int k_hi = causal ? min(sk - 1, q_hi) : sk - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / kBK;
  const int t_hi = k_hi >= k_lo ? k_hi / kBK : t_lo - 1;

  for (int tile = t_lo; tile <= t_hi; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();  // the previous tile's readers are done (and Q is in)
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int c = idx / D, d = idx - c * D;
      const bool in = k0 + c < sk;
      const size_t off = static_cast<size_t>(k0 + c) * D + d;
      kt[d * kKP + c] = in ? kb[off] : 0.f;
      vs[c * kVP + d] = in ? vb[off] : 0.f;
    }
    __syncthreads();

    // scores of rows 4ty+i against keys 4tx+j of the tile
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kQP + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(kt + d * kKP + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ai = comp(a, i);
        s[i][0] = fmaf(ai, b.x, s[i][0]);
        s[i][1] = fmaf(ai, b.y, s[i][1]);
        s[i][2] = fmaf(ai, b.z, s[i][2]);
        s[i][3] = fmaf(ai, b.w, s[i][3]);
      }
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 4 * tx + j;
        ok[j] = col < sk && (!causal || col <= row) &&
                (window <= 0 || col > row - window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], half_warp_max(mx));
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += s[i][j];
      }
      l_i[i] = l_i[i] * alpha + half_warp_sum(rs);
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kNJ; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (4 * tx + j) * kQP + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc[rows 4ty+i][cols 4tx + 64n + e] += P[row][c] V[c][col]
#pragma unroll 2
    for (int c = 0; c < kBK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(pt + c * kQP + 4 * ty);
#pragma unroll
      for (int n = 0; n < kNJ; ++n) {
        const float4 w =
            *reinterpret_cast<const float4*>(vs + c * kVP + 64 * n + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pi = comp(p, i);
          acc[i][4 * n + 0] = fmaf(pi, w.x, acc[i][4 * n + 0]);
          acc[i][4 * n + 1] = fmaf(pi, w.y, acc[i][4 * n + 1]);
          acc[i][4 * n + 2] = fmaf(pi, w.z, acc[i][4 * n + 2]);
          acc[i][4 * n + 3] = fmaf(pi, w.w, acc[i][4 * n + 3]);
        }
      }
    }
  }

  float* ob = out + static_cast<size_t>(bh) * sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= sq) continue;
    // the row's log-sum-exp (-inf: no allowed key)
    if (lse != nullptr && tx == 0)
      lse[static_cast<size_t>(bh) * sq + row] =
          l_i[i] > 0.f ? m_i[i] + logf(l_i[i]) : qf::neg_inf();
    const float denom = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < kNJ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ob[static_cast<size_t>(row) * D + 64 * n + 4 * tx + e] =
            acc[i][4 * n + e] / denom;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int bh, int group, int sq, int sk, int causal, int window,
           void* stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  flash_kernel<D><<<grid, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), group, sq, sk, causal, window);
  return static_cast<int>(cudaGetLastError());
}

int launch_dh(const void* q, const void* k, const void* v, void* out,
              void* lse, int bh, int group, int sq, int sk, int dh,
              int causal, int window, void* stream) {
  switch (dh) {
    case 64:
      return launch<64>(q, k, v, out, lse, bh, group, sq, sk, causal, window,
                        stream);
    case 128:
      return launch<128>(q, k, v, out, lse, bh, group, sq, sk, causal, window,
                         stream);
    case 256:
      return launch<256>(q, k, v, out, lse, bh, group, sq, sk, causal, window,
                         stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (bh, sq, dh); k, v (bk, sk, dh) with bh a multiple of bk; dh 64, 128
// or 256; dtype a qf::DType. lse, fp32 (bh, sq) or null, receives each
// row's log-sum-exp of its scaled allowed scores, in natural-log units
// for both dtypes (-inf for a row with no allowed key): the backward
// (qf_flash_attention_bwd) reads it.
extern "C" int qf_flash_attention(const void* q, const void* k,
                                  const void* v, void* out, void* lse,
                                  int bh, int bk, int sq, int sk, int dh,
                                  int causal, int window, int dtype,
                                  void* stream) {
  if (bh <= 0 || bk <= 0 || bh % bk || bh > 65535 || sq <= 0 || sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = bh / bk;
  switch (dtype) {
    case qf::kFloat32:
      return launch_dh(q, k, v, out, lse, bh, group, sq, sk, dh, causal,
                       window, stream);
    case qf::kBFloat16:
      return qf::flash_attention_bf16(q, k, v, out, lse, bh, bk, sq, sk, dh,
                                      causal, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
