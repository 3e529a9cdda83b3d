// Pieces shared by the fp32-storage attention kernels on the tensor cores
// (flash_attention.cu, flash_attention_bwd.cu): cp.async copies of rows
// into shared memory, the mask, quad reductions, and the mma.sync operand
// fragments of fp32 tiles split into TF32 hi + lo (tf32.cuh's
// split_finite: P and dS, masked entries set to 0, are finite; a NaN in
// the inputs reads as 0 there).
//
// Fragments (m16n8k8, g = lane / 4, t = lane % 4). Every tile sits in
// shared memory in its row layout, rows `pitch` floats apart, pitch = 4
// mod 32: the four loads below then hit 32 different banks across a warp.
//  * A from rows: A[r][k] = X[r][k] (Q, dO, K or V rows times a tile's
//    columns): X[g][t], X[g+8][t], X[g][t+4], X[g+8][t+4].
//  * B from rows: B[k][n] = X[n][k], the transposed tile read in place
//    (K for Q K^T, Q for K Q^T): X[g][t], X[g][t+4].
//  * A from an accumulator: the m16n8 accumulator of a product C (C[g][2t],
//    C[g][2t+1], C[g+8][2t], C[g+8][2t+1]) is the A operand of a product
//    over C's columns when the 8 columns of a k-step are taken in the order
//    0, 2, 4, 6, 1, 3, 5, 7: k-index t is column 2t, t + 4 is 2t + 1. No
//    shuffle and no trip through shared memory (P V, dS K, P^T dO, dS^T Q).
//  * B from rows in that order: B[k][n] = X[k][n] for the k-step's rows
//    2t and 2t + 1: X[2t][g], X[2t+1][g] (V, K, dO or Q as the right
//    operand of the products above).
#pragma once

#include <cstdint>

#include "common.cuh"
#include "tf32.cuh"

namespace qf::attn32 {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + n) of a (rows, D) fp32 tensor into shared memory rows
// `pitch` floats apart, by cp.async in 16-byte pieces; rows at or past
// `rows` are filled with zeros (no device memory past the end is read)
template <int D, int NT>
__device__ __forceinline__ void stage_rows(float* dst, int pitch,
                                           const float* src, int r0, int n,
                                           int rows) {
  constexpr int kC = D / 4;
  for (int i = threadIdx.x; i < n * kC; i += NT) {
    const int r = i / kC, c = i - r * kC;
    const bool in = r0 + r < rows;
    cp_async16(dst + r * pitch + 4 * c,
               src + static_cast<size_t>(in ? r0 + r : 0) * D + 4 * c,
               in ? 16 : 0);
  }
}

__device__ __forceinline__ bool allowed(int row, int col, int sk, int causal,
                                        int window) {
  return col < sk && (!causal || col <= row) &&
         (window <= 0 || col > row - window);
}

// over the four lanes of a quad (one row of an accumulator)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

struct Frag {
  unsigned hi[4], lo[4];
};

__device__ __forceinline__ Frag frag(float x0, float x1, float x2, float x3) {
  const Split s0 = split_finite(x0), s1 = split_finite(x1),
              s2 = split_finite(x2), s3 = split_finite(x3);
  return {{s0.hi, s1.hi, s2.hi, s3.hi}, {s0.lo, s1.lo, s2.lo, s3.lo}};
}

// A (16 x 8) from rows: x at row 0, column k0 of the tile
__device__ __forceinline__ Frag a_rows(const float* x, int pitch, int g,
                                       int t) {
  return frag(x[g * pitch + t], x[(g + 8) * pitch + t], x[g * pitch + t + 4],
              x[(g + 8) * pitch + t + 4]);
}

// A from an m16n8 accumulator (its columns in the k-step order above)
__device__ __forceinline__ Frag a_acc(const float (&c)[4]) {
  return frag(c[0], c[2], c[1], c[3]);
}

// acc += A B^T-tile: B from rows, x at row n0, column k0
__device__ __forceinline__ void mma_rows(float (&acc)[4], const Frag& a,
                                         const float* x, int pitch, int g,
                                         int t) {
  mma_3xtf32<false>(acc, a.hi, a.lo, split_finite(x[g * pitch + t]),
                    split_finite(x[g * pitch + t + 4]));
}

// acc += A B: B from rows 2t, 2t + 1 of the k-step, x at row k0,
// column n0
__device__ __forceinline__ void mma_pairs(float (&acc)[4], const Frag& a,
                                          const float* x, int pitch, int g,
                                          int t) {
  mma_3xtf32<false>(acc, a.hi, a.lo, split_finite(x[2 * t * pitch + g]),
                    split_finite(x[(2 * t + 1) * pitch + g]));
}

// Chains. The tensor cores truncate each mma's sum toward zero, so a
// chain of n mmas into one accumulator drifts by ~n/2 ulps of it (a
// 2048-key row of P V in one chain: 768 mmas, 1.2e-5 of the output's
// scale off the plain version on an H100, past the fp32 tolerance).
// Every chain here is cut at 4 k-steps (12 mmas): it starts from zero and
// is added to the running fp32 sum on the CUDA cores, which round to
// nearest.
constexpr int kChain = 4;                // k-steps a chain

// s (16 x 8 NJ) = A B^T over D, A from rows (a at row 0, column 0), B
// from rows (b at row 0, column 0): chains of kChain k-steps, summed in
// order
template <int D, int NJ>
__device__ __forceinline__ void dot_rows(float (&s)[NJ][4], const float* a,
                                         const float* b, int pitch, int g,
                                         int t) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 2
  for (int c = 0; c < D / (8 * kChain); ++c) {
    float part[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.f;
#pragma unroll
    for (int kk = 8 * kChain * c; kk < 8 * kChain * (c + 1); kk += 8) {
      const Frag fa = a_rows(a + kk, pitch, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mma_rows(part[j], fa, b + 8 * j * pitch + kk, pitch, g, t);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] += part[j][i];
  }
}

// acc (16 x D) = alpha acc + A B, A the NK (<= kChain) k-steps of fragments
// a, B from rows in pairs (b at row 0, column 0); alpha[h] scales rows
// g + 8h. One chain a 64-column slice, joined by one fma a value.
template <int D, int NK>
__device__ __forceinline__ void acc_pairs(float (&acc)[D / 8][4],
                                          const Frag (&a)[NK],
                                          const float (&alpha)[2],
                                          const float* b, int pitch, int g,
                                          int t) {
  static_assert(NK <= kChain, "one chain a slice");
  constexpr int kW = D / 8 < 8 ? D / 8 : 8;   // n-tiles a slice
#pragma unroll
  for (int n0 = 0; n0 < D / 8; n0 += kW) {
    float fresh[kW][4];
#pragma unroll
    for (int n = 0; n < kW; ++n)
      fresh[n][0] = fresh[n][1] = fresh[n][2] = fresh[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int n = 0; n < kW; ++n)
        mma_pairs(fresh[n], a[kk], b + 8 * kk * pitch + 8 * (n0 + n), pitch,
                  g, t);
#pragma unroll
    for (int n = 0; n < kW; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[n0 + n][i] = fmaf(acc[n0 + n][i], alpha[i >> 1], fresh[n][i]);
  }
}

}  // namespace qf::attn32
