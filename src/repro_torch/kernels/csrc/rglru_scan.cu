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
// that is 503 MB, 0.150 ms at 3.35 TB/s. To come near that rate the card
// needs a few MB of loads in flight; one thread per channel walking the
// whole sequence (10,240 threads at that shape) kept only ~1.3 MB.
//
// Design: a 128-thread block per (b, 32-channel tile), so each token's
// row of the tile is one coalesced 128-byte access (64 in bf16). The
// block walks S in segments of kSeg = 4 x 16 tokens; warp w takes the
// sub-chunk of 16 tokens w*16 .. w*16+15 of a segment, a lane one channel.
// Per segment:
//   1. each lane runs its 16 steps from h = 0 and forms the sub-chunk's
//      decay product P = a_15 * ... * a_0, and publishes (P, h_end) in
//      shared memory (double-buffered by segment parity: one barrier a
//      segment);
//   2. after the barrier every lane folds the published pairs of the
//      warps before its own onto the segment's carry in, in order
//      (carry = P_j carry + h_j), and reruns its 16 steps from that carry,
//      storing each h;
//   3. every lane folds all four pairs the same way: the next segment's
//      carry, the same bits in every thread.
// The loads of segment n+1 are issued into registers before segment n is
// computed, so each thread keeps 32 loads in flight while it works
// (~5 MB over the card at the prefill shape). a and b are read once and h
// written once; the only extra work is the second pass of FMAs. No
// atomics and no order between blocks: the same inputs give the same bits.
// The rounding differs from the sequential recurrence only in the carry
// into each sub-chunk (the fold), which is O(1 ulp) of the state.
#include "common.cuh"

namespace {

constexpr int kLanes = 32;                 // channels a block
constexpr int kWarps = 4;
constexpr int kThreads = kLanes * kWarps;
constexpr int kSub = 16;                   // tokens a warp takes a segment
constexpr int kSeg = kSub * kWarps;        // tokens a segment

template <typename T>
__device__ __forceinline__ void load_segment(const T* __restrict__ a,
                                             const T* __restrict__ b,
                                             size_t base, int t0, int s,
                                             int d, bool live, float* av,
                                             float* bv) {
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    const bool in = live && t0 + j < s;
    const size_t off = base + static_cast<size_t>(t0 + j) * d;
    av[j] = in ? qf::to_f32(a[off]) : 1.f;   // past the end: h unchanged
    bv[j] = in ? qf::to_f32(b[off]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const T* __restrict__ a, const T* __restrict__ b,
             T* __restrict__ out, int s, int d) {
  __shared__ float2 part[2][kWarps][kLanes];   // (P, h_end) a sub-chunk
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int di = blockIdx.x * kLanes + lane;
  const bool live = di < d;
  const size_t base = static_cast<size_t>(blockIdx.y) * s * d + di;

  float av[kSub], bv[kSub], an[kSub], bn[kSub];
  load_segment(a, b, base, warp * kSub, s, d, live, av, bv);
  float carry = 0.f;
  int parity = 0;
  for (int s0 = 0; s0 < s; s0 += kSeg, parity ^= 1) {
    const int t0 = s0 + warp * kSub;
    if (s0 + kSeg < s)
      load_segment(a, b, base, t0 + kSeg, s, d, live, an, bn);

    // 1. the sub-chunk from h = 0, and its decay product
    float p = 1.f, h = 0.f;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      h = fmaf(av[j], h, bv[j]);
      p *= av[j];
    }
    part[parity][warp][lane] = make_float2(p, h);
    __syncthreads();

    // 2. the carry into this sub-chunk, then the sub-chunk again from it
    float c = carry;
#pragma unroll
    for (int w = 0; w < kWarps - 1; ++w) {
      if (w < warp) {
        const float2 q = part[parity][w][lane];
        c = fmaf(q.x, c, q.y);
      }
    }
    h = c;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      h = fmaf(av[j], h, bv[j]);
      if (live && t0 + j < s)
        out[base + static_cast<size_t>(t0 + j) * d] = qf::from_f32<T>(h);
    }

    // 3. the next segment's carry: all four sub-chunks folded in order
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float2 q = part[parity][w][lane];
      carry = fmaf(q.x, carry, q.y);
    }
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      av[j] = an[j];
      bv[j] = bn[j];
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* out, int bsz, int s, int d,
           void* stream) {
  const dim3 grid((d + kLanes - 1) / kLanes, bsz);
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
