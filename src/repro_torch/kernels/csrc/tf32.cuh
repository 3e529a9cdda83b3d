// 3xTF32 on Hopper's tensor cores, shared by the fp32 kernels that run
// their products there (gla_chunked.cu, flash_attention.cu,
// flash_attention_bwd.cu): each fp32 operand split into a TF32 hi part and
// the TF32 rounding of what is left, and a product of two such operands
// run as the three mma.sync products lo hi, hi lo and hi hi into one fp32
// accumulator. hi + lo holds an operand to ~2^-22 of itself and the
// dropped lo lo term is ~2^-22 of the product, so the products keep the
// fp32 function at 1/3 of the TF32 rate (495 / 3 = 165 TFLOP/s dense on
// an H100), ~2.5x the fp32 CUDA cores' 67.
#pragma once

namespace qf {

// x as a TF32 hi part (round to nearest, ties away) and the TF32 rounding
// of what is left: hi + lo holds x to ~2^-22 of itself (3xTF32)
struct Split {
  unsigned hi, lo;
};
__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ Split split(float x) {
  const unsigned hi = to_tf32(x);
  return {hi, to_tf32(x - __uint_as_float(hi))};
}

// split(x) for a finite x, the same bits in four integer and fp32
// instructions where cvt.rna's check for inf and NaN makes it seven: the
// round to nearest (ties away) is an add of half the dropped range to the
// magnitude, then a mask (for lo the tensor cores drop the low 13 bits
// themselves, and the compiler leaves its mask out). Not for inf or NaN:
// the NaN the card's arithmetic makes (0x7fffffff) carries into the sign
// bit and reads as -0, so a NaN operand drops out of the product. The
// fp32 attention kernels take this form (their splits are a large share
// of their time), so a NaN in q, k, v or dO does not reach their outputs;
// GLA keeps split, under which a NaN operand stays NaN as in its plain
// version, so that moving its helpers here changed none of its results.
__device__ __forceinline__ unsigned to_tf32_finite(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ Split split_finite(float x) {
  const unsigned hi = to_tf32_finite(x);
  return {hi, to_tf32_finite(x - __uint_as_float(hi))};
}

// acc (16 x 8, fp32) += A (16 x 8) B (8 x 8) on the tensor cores, TF32
// operands in mma.sync's fragment layouts: with g = lane / 4, t = lane % 4,
// a = {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]}, b0 = B[t][g],
// b1 = B[t+4][g]; acc = {C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]}
__device__ __forceinline__ void mma_tf32(float (&acc)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A B in 3xTF32: the two cross terms, then hi x hi (alo = 0 when A
// is exact in TF32: bf16 values)
template <bool kAExact>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[4],
                                           const unsigned (&ahi)[4],
                                           const unsigned (&alo)[4], Split b0,
                                           Split b1) {
  if constexpr (!kAExact) mma_tf32(acc, alo, b0.hi, b1.hi);
  mma_tf32(acc, ahi, b0.lo, b1.lo);
  mma_tf32(acc, ahi, b0.hi, b1.hi);
}

}  // namespace qf
