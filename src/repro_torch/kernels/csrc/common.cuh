// Shared helpers for the QuantumFed Hopper kernels.
//
// Precision contract (the same as the TPU kernels they replace): the
// quantum kernels take and give complex128 (interleaved double2, as
// torch.view_as_real lays them out); the sequence kernels take and give
// fp32 or bf16. Every product and sum is fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace qf {

__device__ __forceinline__ float2 ld32(const double2* p) {
  const double2 v = *p;
  return make_float2(static_cast<float>(v.x), static_cast<float>(v.y));
}

__device__ __forceinline__ double2 to64(float2 v) {
  return make_double2(static_cast<double>(v.x), static_cast<double>(v.y));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Storage type <-> fp32 for the sequence kernels (bf16 rounds to
// nearest even, as torch's .to(torch.bfloat16) does).
template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

// dtype codes of the sequence kernels' C entry points
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// bf16 attention on the tensor cores (flash_attention_wgmma.cu) and its
// backward (flash_attention_bwd_wgmma.cu)
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, void* lse, int bh, int bk, int sq, int sk,
                         int dh, int causal, int window, int q_off,
                         void* stream);
int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* dq, void* dk, void* dv, void* dd,
                             void* part, int bh, int bk, int sq, int sk,
                             int dh, int causal, int window, int q_off,
                             int splits, void* stream);

}  // namespace qf
