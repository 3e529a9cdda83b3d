// Batched complex GEMM C[b] = A[b] @ B[b] on complex128 storage, fp32 math.
//
// Replaces: src/repro/kernels/zgemm.py::zgemm (_zgemm_kernel), the Pallas
// TPU kernel that splits each complex product into four real MXU dots.
//
// What bounds it on an H100: at the QuantumFed shapes (d = 8..64 square
// matrices, batch 2..40) the work per launch is a few KFLOP to a few
// MFLOP, far below both the fp32 rate and HBM bandwidth; the launch
// itself (a few microseconds) dominates. Eq. 6's update chain issues
// these products one after another, so the port's round is launch-bound
// here, not byte- or flop-bound.
//
// Design: one 16x16 output tile per block, one output element per
// thread, A and B staged through shared memory in 16-wide K slices that
// are converted to fp32 on load. Ragged edges are masked (zero-filled
// tiles) instead of padding the operands in device memory as the TPU
// kernel does. The batch rides on gridDim.z with a grid-stride loop.
#include "common.cuh"

namespace {

constexpr int kTile = 16;

__global__ void zgemm_kernel(const double2* __restrict__ a,
                             const double2* __restrict__ b,
                             double2* __restrict__ c, int batch, int m,
                             int n, int k) {
  __shared__ float2 as[kTile][kTile + 1];
  __shared__ float2 bs[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row = blockIdx.y * kTile + ty;
  const int col = blockIdx.x * kTile + tx;
  const float2 zero = make_float2(0.f, 0.f);
  for (int bb = blockIdx.z; bb < batch; bb += gridDim.z) {
    const double2* ab = a + static_cast<size_t>(bb) * m * k;
    const double2* bp = b + static_cast<size_t>(bb) * k * n;
    float cr = 0.f, ci = 0.f;
    for (int k0 = 0; k0 < k; k0 += kTile) {
      const int ka = k0 + tx, kb = k0 + ty;
      as[ty][tx] = (row < m && ka < k) ? qf::ld32(ab + static_cast<size_t>(row) * k + ka) : zero;
      bs[ty][tx] = (kb < k && col < n) ? qf::ld32(bp + static_cast<size_t>(kb) * n + col) : zero;
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTile; ++kk) {
        const float2 x = as[ty][kk], y = bs[kk][tx];
        cr = fmaf(x.x, y.x, fmaf(-x.y, y.y, cr));
        ci = fmaf(x.x, y.y, fmaf(x.y, y.x, ci));
      }
      __syncthreads();
    }
    if (row < m && col < n)
      c[static_cast<size_t>(bb) * m * n + static_cast<size_t>(row) * n + col] =
          qf::to64(make_float2(cr, ci));
  }
}

}  // namespace

extern "C" const char* qf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int qf_zgemm(const void* a, const void* b, void* c, int batch,
                        int m, int n, int k, void* stream) {
  const dim3 block(kTile, kTile);
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile,
                  batch < 65535 ? batch : 65535);
  zgemm_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(a), static_cast<const double2*>(b),
      static_cast<double2*>(c), batch, m, n, k);
  return static_cast<int>(cudaGetLastError());
}
