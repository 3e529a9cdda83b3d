// Per-pair pure-state fidelity Re<phi|rho|phi> and Frobenius MSE
// ||rho - |phi><phi|||_F^2 on complex128 storage, fp32 math.
//
// Replaces: src/repro/kernels/fidelity.py::fidelity_batch
// (_fidelity_kernel) and ::mse_batch (_mse_kernel), the Pallas TPU
// kernels that evaluate blocks of 8 pairs with MXU matvecs.
//
// What bounds it on an H100: reading rho, d*d complex128 per pair, once.
// Each element takes a handful of flops, so the kernel sits far below
// the fp32 roofline ridge; at the evaluation sizes (32 pairs, d = 4..16)
// the launch dominates.
//
// Design: one warp per pair, eight pairs per 256-thread block (the
// TPU's block of 8). Lanes stride over the d*d elements of rho so that
// neighbouring lanes read neighbouring addresses; the projector of the
// MSE is formed in registers and never stored; a shuffle reduction
// closes each pair. Pairs past N are masked rather than padded.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

template <bool kMse>
__global__ void state_kernel(const double2* __restrict__ phi,
                             const double2* __restrict__ rho,
                             double* __restrict__ out, int n, int d) {
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (pair >= n) return;
  const double2* p = phi + static_cast<size_t>(pair) * d;
  const double2* r = rho + static_cast<size_t>(pair) * d * d;
  float acc = 0.f;
  for (int idx = lane; idx < d * d; idx += 32) {
    const int row = idx / d, col = idx - row * d;
    const float2 rr = qf::ld32(r + idx);
    const float2 pa = qf::ld32(p + row), pb = qf::ld32(p + col);
    if (kMse) {
      // |phi><phi|[row, col] = pa * conj(pb)
      const float dr = rr.x - fmaf(pa.x, pb.x, pa.y * pb.y);
      const float di = rr.y - fmaf(pa.y, pb.x, -pa.x * pb.y);
      acc = fmaf(dr, dr, fmaf(di, di, acc));
    } else {
      // Re[conj(pa) * rho[row, col] * pb]
      const float yr = fmaf(rr.x, pb.x, -rr.y * pb.y);
      const float yi = fmaf(rr.x, pb.y, rr.y * pb.x);
      acc = fmaf(pa.x, yr, fmaf(pa.y, yi, acc));
    }
  }
  acc = qf::warp_sum(acc);
  if (lane == 0) out[pair] = static_cast<double>(acc);
}

template <bool kMse>
int launch(const void* phi, const void* rho, void* out, int n, int d,
           void* stream) {
  const int blocks = (n + kWarps - 1) / kWarps;
  state_kernel<kMse><<<blocks, 32 * kWarps, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(phi), static_cast<const double2*>(rho),
      static_cast<double*>(out), n, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qf_fidelity(const void* phi, const void* rho, void* out,
                           int n, int d, void* stream) {
  return launch<false>(phi, rho, out, n, d, stream);
}

extern "C" int qf_mse(const void* phi, const void* rho, void* out, int n,
                      int d, void* stream) {
  return launch<true>(phi, rho, out, n, d, stream);
}
