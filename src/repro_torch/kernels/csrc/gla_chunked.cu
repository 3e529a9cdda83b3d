// RWKV6 wkv as chunked gated linear attention: per (batch, head), a walk
// over sequence chunks with the (dh x dh) state carried on chip. Every
// product and sum is fp32; r, k, v are fp32 or bf16, w fp32 or bf16 (the
// model hands it over in fp32: in bf16 a decay of 1 - 6e-6 rounds to 1),
// u fp32. Writes out in r's dtype and the final state (B, H, dh, dh) in
// fp32, the two values of the reference's models/layers/rwkv.py::
// gla_chunked_ref.
//
// Replaces: src/repro/kernels/gla_chunked.py:73 (gla_chunked, the Pallas
// TPU kernel _gla_kernel), one sequential grid step per (batch, head)
// with the state in VMEM scratch. That kernel drops the state at the end;
// the model's decode cache needs it, so this one writes it.
//
// Per chunk of L tokens, with lp the inclusive cumulative log-decay
// (log max(w, 1e-20), summed left to right) and lp_prev = lp - log w:
//   out[t] = sum_{i<t} (sum_c r_tc k_ic e^{lp_prev,tc - lp_ic}) v_i
//          + (sum_c r_tc k_tc u_c) v_t + (r_t * e^{lp_prev,t}) S
//   S     <- e^{lp_last} * S + sum_i (k_i * e^{lp_last - lp_i}) v_i^T
// Every exponent is <= 0: the decay between two tokens is formed
// pairwise, never as (r e^{lp}) (k e^{-lp}), because -lp reaches ~870
// inside one chunk of the RWKV6 block and e^{870} overflows fp32.
//
// What bounds it on an H100: operations. At the RWKV6-7B prefill shape
// (B=4, S=4096, H=64, dh=64, chunk 16, r/k/v/out bf16, w fp32) the work
// is ~338 kFLOP per (b, h, chunk), two 16x64x64 products (the inter
// term and the state update) most of it, 22.2 GFLOP a launch: 0.331 ms
// at the 67 TFLOP/s fp32 rate, against 0.242 ms for the 810 MB it moves
// (chip_smoke.py's gla_flops and seq_bound_ms count both). The design
// keeps the fp32 arithmetic of the contract on the CUDA cores and moves
// each input byte once; it does nothing yet about the operations' rate.
//
// Design: one 256-thread block per (b, h) walks the S / L chunks in
// order (256 blocks for 132 SMs, two resident per SM). The state never
// leaves the block: thread (g, e) of a 4 x 64 grid holds rows
// 16g..16g+15 of column e in registers, and the state goes to device
// memory once, at the end. Per chunk, four barrier-separated phases:
//   1. load: warps 0-1 read the w column of one channel each and form
//      lp and lp_prev as they go; warps 2-7 stage r, k and v (fp32 in
//      shared memory). The model's (B, S, H, dh) layout is read in
//      place through its strides, so no transposed copies are made.
//   2. the decayed q and k tiles (elementwise exps), and the scores:
//      one warp per (t, i <= t) pair, lanes over channels, a butterfly
//      sum; the strictly lower pairs get the pairwise decay (L(L-1)/2
//      pairs, the masked half is never formed), the diagonal the bonus.
//   3. each thread's partial inter term over its 16 state rows (from
//      float4 broadcasts of the decayed q), then its state update.
//   4. out = scores @ v + the four partial inter terms.
// dh < 64 is zero-padded in shared memory; chunks longer than 64 are
// cut by the wrapper into sub-chunks that divide them (the same function:
// it is chunk-size invariant). Next for speed: split the value columns
// over blocks (grid (b, h, e-tile)) for more blocks in flight, prefetch
// the next chunk during phases 2-4, and the tensor cores for the two
// 16x64x64 products.
#include "common.cuh"

namespace {

constexpr int kD = 64;                  // head_dim bound (smaller: padded)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kThreads / kD;  // state row groups
constexpr int kRows = kD / kGroups;     // state rows per thread
constexpr int kMaxChunk = 64;
constexpr float kWFloor = 1e-20f;

__host__ __device__ constexpr size_t smem_floats(int chunk) {
  // r, k, v, lp, lp_prev, decayed q, decayed k, 4 partial inter tiles,
  // then e^{lp_last}, lp_last, u, and the (L, L) scores
  return static_cast<size_t>(11) * chunk * kD + 3 * kD +
         static_cast<size_t>(chunk) * chunk;
}

__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
gla_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const TW* __restrict__ w,
           const float* __restrict__ u, T* __restrict__ out,
           float* __restrict__ state, int s, int h, int d, int chunk) {
  extern __shared__ float4 smem4[];
  float* const rs = reinterpret_cast<float*>(smem4);
  const int tile = chunk * kD;
  float* const ks = rs + tile;
  float* const vs = ks + tile;
  float* const lps = vs + tile;
  float* const lpp = lps + tile;
  float* const qd = lpp + tile;
  float* const kd = qd + tile;
  float* const part = kd + tile;          // kGroups tiles
  float* const dl = part + kGroups * tile;
  float* const lpl = dl + kD;
  float* const us = lpl + kD;
  float* const as = us + kD;              // (chunk, chunk)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh % h;
  const int col = tid % kD;   // channel (phase 1) / value column (phase 3)
  const int grp = tid / kD;   // load role (phase 1) / state row group
  const bool live = col < d;
  const size_t step = static_cast<size_t>(h) * d;   // one token further
  const size_t head0 = (static_cast<size_t>(bi) * s * h + hi) * d;

  if (tid < kD) us[tid] = tid < d ? u[hi * d + tid] : 0.f;
  float st[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) st[j] = 0.f;

  for (int t0 = 0; t0 < s; t0 += chunk) {
    const size_t cbase = head0 + static_cast<size_t>(t0) * step;

    // ---- 1. load; lp and lp_prev per channel, summed left to right
    if (grp == 0) {
      float acc = 0.f;
#pragma unroll 4
      for (int t = 0; t < chunk; ++t) {
        const float lw =
            live ? logf(fmaxf(qf::to_f32(w[cbase + t * step + col]), kWFloor))
                 : 0.f;
        acc += lw;
        lps[t * kD + col] = acc;
        lpp[t * kD + col] = acc - lw;
      }
      lpl[col] = acc;
      dl[col] = expf(acc);
    } else {
      const T* src = grp == 1 ? r : grp == 2 ? k : v;
      float* dst = grp == 1 ? rs : grp == 2 ? ks : vs;
#pragma unroll 4
      for (int t = 0; t < chunk; ++t)
        dst[t * kD + col] = live ? qf::to_f32(src[cbase + t * step + col]) : 0.f;
    }
    __syncthreads();

    // ---- 2. decayed q and k; scores of the pairs i <= t
    for (int idx = tid; idx < tile; idx += kThreads) {
      qd[idx] = rs[idx] * expf(lpp[idx]);
      kd[idx] = ks[idx] * expf(lpl[idx % kD] - lps[idx]);
    }
    {
      const int warp = tid / 32, lane = tid % 32;
      const int pairs = chunk * (chunk + 1) / 2;
      for (int p = warp; p < pairs; p += kWarps) {
        int t = static_cast<int>((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
        while (t * (t + 1) / 2 > p) --t;
        while ((t + 1) * (t + 2) / 2 <= p) ++t;
        const int i = p - t * (t + 1) / 2;
        float acc = 0.f;
        if (i < t) {
#pragma unroll
          for (int c = lane; c < kD; c += 32)
            acc += rs[t * kD + c] * ks[i * kD + c] *
                   expf(lpp[t * kD + c] - lps[i * kD + c]);
        } else {
#pragma unroll
          for (int c = lane; c < kD; c += 32)
            acc += rs[t * kD + c] * ks[t * kD + c] * us[c];
        }
        acc = warp_allsum(acc);
        if (lane == 0) as[t * chunk + i] = acc;
      }
    }
    __syncthreads();

    // ---- 3. partial inter term from the state before this chunk, then
    //         the state update, on this thread's rows c0..c0+15, column col
    {
      const int c0 = grp * kRows;
      for (int t = 0; t < chunk; ++t) {
        const float4* q4 = reinterpret_cast<const float4*>(qd + t * kD + c0);
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < kRows / 4; ++j) {
          const float4 q = q4[j];
          acc += q.x * st[4 * j] + q.y * st[4 * j + 1] + q.z * st[4 * j + 2] +
                 q.w * st[4 * j + 3];
        }
        part[(grp * chunk + t) * kD + col] = acc;
      }
      float kv[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) kv[j] = 0.f;
      for (int i = 0; i < chunk; ++i) {
        const float vv = vs[i * kD + col];
        const float4* k4 = reinterpret_cast<const float4*>(kd + i * kD + c0);
#pragma unroll
        for (int j = 0; j < kRows / 4; ++j) {
          const float4 kk = k4[j];
          kv[4 * j] += kk.x * vv;
          kv[4 * j + 1] += kk.y * vv;
          kv[4 * j + 2] += kk.z * vv;
          kv[4 * j + 3] += kk.w * vv;
        }
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) st[j] = dl[c0 + j] * st[j] + kv[j];
    }
    __syncthreads();

    // ---- 4. out = (intra + bonus) + inter
    for (int idx = tid; idx < tile; idx += kThreads) {
      const int t = idx / kD, e = idx % kD;
      float acc = 0.f;
      for (int i = 0; i < t; ++i) acc += as[t * chunk + i] * vs[i * kD + e];
      acc += as[t * chunk + t] * vs[t * kD + e];
      float inter = 0.f;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) inter += part[(g * chunk + t) * kD + e];
      if (e < d) out[cbase + t * step + e] = qf::from_f32<T>(acc + inter);
    }
    __syncthreads();
  }

  if (live) {
    float* dst = state + static_cast<size_t>(bh) * d * d;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int c = grp * kRows + j;
      if (c < d) dst[c * d + col] = st[j];
    }
  }
}

template <typename T, typename TW>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* out, void* state, int bsz, int s, int h,
           int d, int chunk, void* stream) {
  const size_t smem = smem_floats(chunk) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      gla_kernel<T, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gla_kernel<T, TW><<<bsz * h, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TW*>(w),
      static_cast<const float*>(u), static_cast<T*>(out),
      static_cast<float*>(state), s, h, d, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_w(const void* r, const void* k, const void* v, const void* w,
             const void* u, void* out, void* state, int bsz, int s, int h,
             int d, int chunk, int w_dtype, void* stream) {
  switch (w_dtype) {
    case qf::kFloat32:
      return launch<T, float>(r, k, v, w, u, out, state, bsz, s, h, d, chunk,
                              stream);
    case qf::kBFloat16:
      return launch<T, __nv_bfloat16>(r, k, v, w, u, out, state, bsz, s, h, d,
                                      chunk, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// r, k, v, out (B, S, H, d) in `dtype`; w (B, S, H, d) in `w_dtype`;
// u (H, d) fp32; state (B, H, d, d) fp32. chunk divides S, 1 <= chunk
// <= 64, 1 <= d <= 64.
extern "C" int qf_gla_chunked(const void* r, const void* k, const void* v,
                              const void* w, const void* u, void* out,
                              void* state, int bsz, int s, int h, int d,
                              int chunk, int dtype, int w_dtype,
                              void* stream) {
  if (bsz <= 0 || s <= 0 || h <= 0 || d <= 0 || d > kD || chunk <= 0 ||
      chunk > kMaxChunk || s % chunk != 0 ||
      static_cast<long long>(bsz) * h > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case qf::kFloat32:
      return launch_w<float>(r, k, v, w, u, out, state, bsz, s, h, d, chunk,
                             w_dtype, stream);
    case qf::kBFloat16:
      return launch_w<__nv_bfloat16>(r, k, v, w, u, out, state, bsz, s, h, d,
                                     chunk, w_dtype, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
