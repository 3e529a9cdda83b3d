// Batched complex GEMM C[b] = A[b] @ B[b] on complex128 storage, fp32 math.
//
// Replaces: src/repro/kernels/zgemm.py::zgemm (_zgemm_kernel), the Pallas
// TPU kernel that splits each complex product into four real MXU dots.
//
// What bounds it on an H100: at the QuantumFed shapes (d = 8..64 square
// matrices, batch 2..40) the work per launch is a few KFLOP to a few
// MFLOP, far below both the fp32 rate and HBM bandwidth; the launch
// itself (a few microseconds) dominates. Eq. 6's update chain issues
// these products one after another, so the port's round is bound by the
// host's launch path here (kernels/zgemm.py keeps it short), not by bytes
// or operations.
//
// Design: one 32x32 output tile per block of 256 threads, a 2x2 register
// tile of outputs per thread (rows ty, ty + 16; columns tx, tx + 16), so
// each shared-memory read feeds two products. A and B are staged through
// shared memory in 16-deep K slices, one 16-byte complex128 load per
// element with neighbouring threads on neighbouring addresses, converted
// to fp32 on load. Ragged edges are masked (zero-filled tiles) instead of
// padding the operands in device memory as the TPU kernel does. The batch
// rides on gridDim.z with a grid-stride loop.
#include "common.cuh"

namespace {

constexpr int kTile = 32;                 // output tile edge
constexpr int kSlice = 16;                // K staged per step
constexpr int kSide = 16;                 // threads per tile edge
constexpr int kThreads = kSide * kSide;

__global__ void __launch_bounds__(kThreads)
zgemm_kernel(const double2* __restrict__ a, const double2* __restrict__ b,
             double2* __restrict__ c, int batch, int m, int n, int k) {
  __shared__ float2 as[kTile][kSlice + 1];   // A rows x K slice
  __shared__ float2 bs[kSlice][kTile];       // K slice x B columns
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kSide + tx;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  const float2 zero = make_float2(0.f, 0.f);
  for (int bb = blockIdx.z; bb < batch; bb += gridDim.z) {
    const double2* ab = a + static_cast<size_t>(bb) * m * k;
    const double2* bp = b + static_cast<size_t>(bb) * k * n;
    float2 acc[2][2] = {{zero, zero}, {zero, zero}};
    for (int k0 = 0; k0 < k; k0 += kSlice) {
#pragma unroll
      for (int u = 0; u < kTile * kSlice / kThreads; ++u) {
        const int i = tid + u * kThreads;
        const int ra = i / kSlice, ca = i % kSlice;      // A: 32 x 16
        const int rb = i / kTile, cb = i % kTile;        // B: 16 x 32
        const int gr = row0 + ra, gk = k0 + ca;
        as[ra][ca] = (gr < m && gk < k)
            ? qf::ld32(ab + static_cast<size_t>(gr) * k + gk) : zero;
        const int hk = k0 + rb, gc = col0 + cb;
        bs[rb][cb] = (hk < k && gc < n)
            ? qf::ld32(bp + static_cast<size_t>(hk) * n + gc) : zero;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kSlice; ++kk) {
        const float2 x0 = as[ty][kk], x1 = as[ty + kSide][kk];
        const float2 y0 = bs[kk][tx], y1 = bs[kk][tx + kSide];
        const float2 xs[2] = {x0, x1}, ys[2] = {y0, y1};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            acc[i][j].x = fmaf(xs[i].x, ys[j].x, fmaf(-xs[i].y, ys[j].y, acc[i][j].x));
            acc[i][j].y = fmaf(xs[i].x, ys[j].y, fmaf(xs[i].y, ys[j].x, acc[i][j].y));
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = row0 + ty + i * kSide, col = col0 + tx + j * kSide;
        if (r < m && col < n)
          c[static_cast<size_t>(bb) * m * n + static_cast<size_t>(r) * n + col] =
              qf::to64(acc[i][j]);
      }
  }
}

}  // namespace

extern "C" const char* qf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int qf_zgemm(const void* a, const void* b, void* c, int batch,
                        int m, int n, int k, void* stream) {
  const dim3 block(kSide, kSide);
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile,
                  batch < 65535 ? batch : 65535);
  zgemm_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(a), static_cast<const double2*>(b),
      static_cast<double2*>(c), batch, m, n, k);
  return static_cast<int>(cudaGetLastError());
}
