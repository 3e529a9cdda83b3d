// RG-LRU diagonal linear recurrence h_t = a_t * h_{t-1} + b_t, h_0 = 0,
// over the sequence axis of (B, S, D); fp32 carry, fp32 or bf16 storage,
// output in a's dtype.
//
// Replaces: src/repro/kernels/rglru_scan.py::rglru_scan (_rglru_kernel),
// the Pallas TPU kernel that walks sequence chunks with the running state
// in VMEM, one grid step per batch row.
//
// What bounds it on an H100: bytes. Each element of a, b and h crosses
// device memory once (3 x 4 B at fp32) for one multiply-add, far below
// the ridge; at the RecurrentGemma-2B prefill shape (4, 4096, 2560) fp32
// that is 503 MB, 0.150 ms at 3.35 TB/s.
//
// Design: one thread per (b, d) channel carries h in a register down the
// whole sequence, so no state is ever written back or exchanged. Warps
// cover consecutive d, so each step's loads and stores are coalesced
// across the channel axis. The only dependent chain is the FMA on h:
// the loads of the next kUnroll steps do not depend on it and are issued
// together into registers before the chain consumes them, which keeps
// several requests in flight per thread. B * D threads (10,240 at the
// prefill shape) are few for 132 SMs; splitting the sequence into chunks
// with a carry pass is the next step for speed, not taken here.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const T* __restrict__ a, const T* __restrict__ b,
             T* __restrict__ out, int s, int d) {
  const int di = blockIdx.x * kThreads + threadIdx.x;
  if (di >= d) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * s * d + di;
  float h = 0.f;
  for (int t0 = 0; t0 < s; t0 += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t off = base + static_cast<size_t>(t0 + u) * d;
      const bool in = t0 + u < s;
      av[u] = in ? qf::to_f32(a[off]) : 0.f;
      bv[u] = in ? qf::to_f32(b[off]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < s) {
        h = av[u] * h + bv[u];
        out[base + static_cast<size_t>(t0 + u) * d] = qf::from_f32<T>(h);
      }
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* out, int bsz, int s, int d,
           void* stream) {
  const dim3 grid((d + kThreads - 1) / kThreads, bsz);
  rglru_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(out), s, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qf_rglru_scan(const void* a, const void* b, void* out,
                             int bsz, int s, int d, int dtype,
                             void* stream) {
  if (bsz <= 0 || s <= 0 || d <= 0 || bsz > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case qf::kFloat32:
      return launch<float>(a, b, out, bsz, s, d, stream);
    case qf::kBFloat16:
      return launch<__nv_bfloat16>(a, b, out, bsz, s, d, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
