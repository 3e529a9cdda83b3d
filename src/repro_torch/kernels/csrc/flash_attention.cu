// Causal / sliding-window flash attention with grouped-query heads:
// online softmax, fp32 storage, the fp32 function, with its two products
// on Hopper's tensor cores in 3xTF32 (tf32.cuh). bf16 storage runs on
// wgmma instead (flash_attention_wgmma.cu); the C entry point below picks
// the kernel by dtype.
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
// What bounds it on an H100: operations. S = Q K^T and O += P V are
// 4 D FLOP an allowed pair. fp32 operands keep the fp32 function on the
// tensor cores in 3xTF32: each operand split as x = hi + lo (TF32 hi,
// TF32 rounding of the rest, ~2^-22 of x), each product run as lo hi,
// hi lo, then hi hi (lo lo, ~2^-22 of the product, is dropped), three
// TF32 mma.sync a product: 495 / 3 = 165 TFLOP/s, against 67 on the
// fp32 CUDA cores. P is split too: it is an operand, and P rounded to
// TF32 alone misses the fp32 tolerance by far. The tensor cores truncate
// each mma's sum toward zero, so no chain of mmas into one accumulator
// is longer than 4 k-steps (12 mmas): S sums D in chains of 32 columns,
// each added to S in fp32 on the CUDA cores, and a tile's P V is one
// chain joined to O by O = fma(O, alpha, P V) (attention_tf32.cuh). One
// chain over a 2048-key row put the output 1.2e-5 of its scale off the
// plain version on an H100; cut, 2.9e-6. tests/test_torch_seq_kernels.py
// replays this arithmetic (splits, chains, truncated sums) in the
// kernel's tile order on the CPU.
//
// Instruction: mma.sync m16n8k8 .tf32 for both products. tf32 wgmma takes
// its B operand K-major from shared memory only, which fits Q K^T but
// not P V (V is N-major there, and 32-bit wgmma has no transposed mode),
// and its operands would have to sit split in shared memory, twice the
// tiles; mma.sync takes hand-loaded fragments, split in registers as they
// are loaded (split_finite: four instructions a value where cvt.rna's
// inf and NaN check makes seven; split's seven, to keep a NaN, in a call
// whose inputs hold one). Every tile stays in its row layout
// (attention_tf32.cuh): K^T is read in place for Q K^T, P goes from the S
// accumulator straight into the A operand of P V with the key order of
// each k-step permuted, and V's rows are read in the same order. Nothing
// is transposed.
//
// Design: one 256-thread block per (128 query rows, query head); warp w
// owns rows 16w..16w+15 (S 16 x 32 keys, O 16 x D in registers: D / 2
// floats a thread). Key tiles of 32 hold K and V in one buffer each, row
// pitch D + 4 floats; Q stays for the whole walk. Loads overlap the
// products: K of the next tile is copied (cp.async) as soon as every
// warp has formed S from this one, V of the next tile as soon as P V is
// done, so each copy runs under half a tile of products (the two buffers
// act as a double buffer whose halves are released in turn). Shared
// memory at D = 256: Q 130 KB + K 33 KB + V 33 KB = 199,680 bytes of the
// 232,448 a block may have (D = 128: 101,376; D = 64: 52,224). Row max
// and sum are quad shuffles (a row's 32 keys sit in the four lanes of a
// quad). Key tiles wholly above the diagonal, or wholly at or below
// i - window for every row of the block, are skipped; masked entries
// inside a tile get probability 0. Query rows past Sq and keys past Sk
// are zero-filled in shared memory and masked, never read from device
// memory. Query blocks run last-first (the most key tiles first).
//
// Against the plain version: at the reference init's logits (scaled
// scores in the thousands) an fp32 score carries ~|s| 2^-24 from its
// sums' rounding in any order, and each weight that relative error; the
// plain version (cuBLAS) is then itself more than 1e-5 of the output's
// scale off the fp64 function (1.0e-4 at the RecurrentGemma-2B prefill).
// The CUDA-core kernel this one replaces summed each score by sequential
// fmas over D and stayed within 1e-5 of the plain version there, so it
// repeated the plain version's rounding; this one does not, and is nearer
// the fp64 function than the plain version (6.5e-5; chip_smoke.py's
// phase 5 measures both).
#include "attention_tf32.cuh"

namespace {

using namespace qf::attn32;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;   // query rows a block
constexpr int kBK = 32;            // keys a tile
constexpr float kNegInf = -1.0e30f;

template <int D>
__host__ __device__ constexpr int pitch() {
  return D + 4;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * static_cast<size_t>(kBQ + 2 * kBK) * pitch<D>();
}

template <int D, bool kNaN>
__device__ __forceinline__ void flash_body(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int group, int sq, int sk, int causal,
    int window) {
  constexpr int kP = pitch<D>();
  constexpr int kN = D / 8;        // n-tiles of O
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                // [kBQ][kP]
  float* ks = qs + kBQ * kP;       // [kBK][kP]
  float* vs = ks + kBK * kP;       // [kBK][kP]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const float* kb = k + static_cast<size_t>(bh / group) * sk * D;
  const float* vb = v + static_cast<size_t>(bh / group) * sk * D;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));

  // key tiles that hold an allowed key for some real row of this block
  const int q_hi = min(q0 + kBQ, sq) - 1;
  const int k_hi = causal ? min(sk - 1, q_hi) : sk - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / kBK;
  const int t_hi = k_hi >= k_lo ? k_hi / kBK : t_lo - 1;

  // groups in flight: {Q, K(t_lo)}, {V(t_lo)}
  if (t_lo <= t_hi) {
    stage_rows<D, kThreads>(qs, kP, q + static_cast<size_t>(bh) * sq * D,
                            q0, kBQ, sq);
    stage_rows<D, kThreads>(ks, kP, kb, t_lo * kBK, kBK, sk);
  }
  cp_async_commit();
  if (t_lo <= t_hi) stage_rows<D, kThreads>(vs, kP, vb, t_lo * kBK, kBK, sk);
  cp_async_commit();

  float o[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};
  const int row0 = q0 + 16 * warp + g;      // rows row0 and row0 + 8
  const float* qw = qs + 16 * warp * kP;

  for (int tile = t_lo; tile <= t_hi; ++tile) {
    const int k0 = tile * kBK;
    cp_async_wait<1>();   // Q and K(tile) are in; V(tile) may be in flight
    __syncthreads();

    // S = Q K^T: rows of the warp x the tile's 32 keys (4 n-tiles)
    float s[4][4];
    dot_rows<D, 4, kNaN>(s, qw, ks, kP, g, t);
    __syncthreads();      // every warp is done with K(tile)
    if (tile < t_hi) stage_rows<D, kThreads>(ks, kP, kb, k0 + kBK, kBK, sk);
    cp_async_commit();

    // mask, then the online-softmax update of rows row0 (s[j][0..1]) and
    // row0 + 8 (s[j][2..3]); keys k0 + 8j + 2t + e
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      bool ok[4][2];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          ok[j][e] = allowed(row, k0 + 8 * j + 2 * t + e, sk, causal, window);
          float& x = s[j][2 * h + e];
          x = ok[j][e] ? __fmul_rn(x, scale) : kNegInf;
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m_i[h], quad_max(mx));
      alpha[h] = expf(m_i[h] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * h + e];
          x = ok[j][e] ? expf(x - m_new) : 0.f;
          rs += x;
        }
      l_i[h] = l_i[h] * alpha[h] + quad_sum(rs);
      m_i[h] = m_new;
    }
    // P as the A operand of P V, k-steps of 8 keys
    Frag pa[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) pa[j] = a_acc<kNaN>(s[j]);

    cp_async_wait<1>();   // V(tile) is in; K(tile + 1) may be in flight
    __syncthreads();
    // O = alpha O + P V
    acc_pairs<D, 4, kNaN>(o, pa, alpha, vs, kP, g, t);
    __syncthreads();      // every warp is done with V(tile)
    if (tile < t_hi) stage_rows<D, kThreads>(vs, kP, vb, k0 + kBK, kBK, sk);
    cp_async_commit();
  }
  cp_async_wait<0>();

  float* ob = out + static_cast<size_t>(bh) * sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= sq) continue;
    // the row's log-sum-exp (-inf: no allowed key)
    if (lse != nullptr && t == 0)
      lse[static_cast<size_t>(bh) * sq + row] =
          l_i[h] > 0.f ? m_i[h] + logf(l_i[h]) : qf::neg_inf();
    const float denom = fmaxf(l_i[h], 1e-30f);
    float* orow = ob + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kN; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(o[n][2 * h] / denom, o[n][2 * h + 1] / denom);
  }
}

// Both splits are launched, each built alone (the four-instruction one
// keeps its registers and its time); the one *nan_flag (scan_nans) does
// not pick returns at once.
template <int D, bool kNaN>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out,
             float* __restrict__ lse, const int* __restrict__ nan_flag,
             int group, int sq, int sk, int causal, int window) {
  if ((*nan_flag != 0) != kNaN) return;
  flash_body<D, kNaN>(q, k, v, out, lse, group, sq, sk, causal, window);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           void* nan_flag, int bh, int group, int sq, int sk, int causal,
           int window, void* stream) {
  const size_t smem = smem_bytes<D>();
  const void* kernels[2] = {
      reinterpret_cast<const void*>(flash_kernel<D, false>),
      reinterpret_cast<const void*>(flash_kernel<D, true>)};
  for (const void* fn : kernels) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* inputs[3] = {static_cast<const float*>(q),
                            static_cast<const float*>(k),
                            static_cast<const float*>(v)};
  const size_t sizes[3] = {static_cast<size_t>(bh) * sq * D,
                           static_cast<size_t>(bh / group) * sk * D,
                           static_cast<size_t>(bh / group) * sk * D};
  cudaError_t err = scan_nans(inputs, sizes, 3,
                              static_cast<int*>(nan_flag), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  flash_kernel<D, false><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), static_cast<const int*>(nan_flag), group,
      sq, sk, causal, window);
  flash_kernel<D, true><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), static_cast<const int*>(nan_flag), group,
      sq, sk, causal, window);
  return static_cast<int>(cudaGetLastError());
}

int launch_dh(const void* q, const void* k, const void* v, void* out,
              void* lse, void* nan_flag, int bh, int group, int sq, int sk,
              int dh, int causal, int window, void* stream) {
  const void* ptrs[4] = {q, k, v, out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16)    // cp.async's alignment
      return static_cast<int>(cudaErrorInvalidValue);
  if (nan_flag == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 64:
      return launch<64>(q, k, v, out, lse, nan_flag, bh, group, sq, sk,
                        causal, window, stream);
    case 128:
      return launch<128>(q, k, v, out, lse, nan_flag, bh, group, sq, sk,
                         causal, window, stream);
    case 256:
      return launch<256>(q, k, v, out, lse, nan_flag, bh, group, sq, sk,
                         causal, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (bh, sq, dh); k, v (bk, sk, dh) with bh a multiple of bk, each and
// out 16-byte aligned; dh 64, 128 or 256; dtype a qf::DType. lse, fp32
// (bh, sq) or null, receives each row's log-sum-exp of its scaled
// allowed scores, in natural-log units for both dtypes (-inf for a row
// with no allowed key): the backward (qf_flash_attention_bwd) reads it.
// nan_flag, one int of device memory for fp32 (the bf16 kernels ignore
// it), receives whether q, k or v holds a NaN.
extern "C" int qf_flash_attention(const void* q, const void* k,
                                  const void* v, void* out, void* lse,
                                  void* nan_flag, int bh, int bk, int sq,
                                  int sk, int dh, int causal, int window,
                                  int dtype, void* stream) {
  if (bh <= 0 || bk <= 0 || bh % bk || bh > 65535 || sq <= 0 || sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = bh / bk;
  switch (dtype) {
    case qf::kFloat32:
      return launch_dh(q, k, v, out, lse, nan_flag, bh, group, sq, sk, dh,
                       causal, window, stream);
    case qf::kBFloat16:
      return qf::flash_attention_bf16(q, k, v, out, lse, bh, bk, sq, sk, dh,
                                      causal, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
