// Shared helpers for the QuantumFed Hopper kernels.
//
// Precision contract (the same as the TPU kernels they replace): inputs
// and outputs are complex128 (interleaved double2, as
// torch.view_as_real lays them out); every product and sum is fp32.
#pragma once

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

}  // namespace qf
