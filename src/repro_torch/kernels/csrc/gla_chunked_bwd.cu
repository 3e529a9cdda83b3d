// The gradient of RWKV6's wkv (gla_chunked.cu's function): given r, k, v,
// w (B, S, H, d), u (H, d), the cotangent dout of out and optionally the
// cotangent dstate of the final state, it writes dr, dk, dv (r's dtype),
// dw (w's dtype) and du (H, d) fp32, summed over B and S.
//
// Replaces no TPU kernel: the Pallas GLA kernel (src/repro/kernels/
// gla_chunked.py:73) has no backward, and the reference trains RWKV6
// through XLA's autodiff of its plain chunked form
// (src/repro/models/layers/rwkv.py:80 gla_chunked_ref). Without this the
// port cannot train RWKV6 on the card.
//
// The function, per (b, h), with S_t the state after token t (S_0 = 0),
// w clamped to 1e-20 as the forward clamps it, and dS_t the cotangent of
// S_t carried in reverse from dstate:
//   dr_t = (S_{t-1} + diag(u) k_t v_t^T) do_t
//   dk_t = (dS_t + diag(u) r_t do_t^T) v_t
//   dv_t = (dS_t + diag(u) r_t do_t^T)^T k_t
//   dw_t = sum_e dS_t[c, e] S_{t-1}[c, e]   (0 where w_t < 1e-20)
//   du  += r_t k_t (v_t . do_t)
//   dS_{t-1} = diag(w_t) dS_t + r_t do_t^T
// It is the step form of the backward, not the chunked one: it takes no
// exponential (so nothing can overflow), and it forms dw from the states
// directly, never as d(log w) / w. The chunked form's autodiff takes
// d(log w) as a difference of sums that cancel to nothing at a strong
// decay (its dw is 0 where the function's is O(1)), and is ~2e-5 off the
// fp64 function at the decay clip's ends; this form holds it to ~2e-7
// (tests/test_torch_gla_grad.py).
//
// What bounds it on an H100: bytes. At the RWKV6-7B train step's shape (B=1,
// S=4096, H=64, d=64, r/k/v/dout/dr/dk/dv bf16, w/dw fp32) it must move
// 369 MB, 0.110 ms at 3.35 TB/s; the least work (the chunked form, its
// products in 3xTF32) is below that (chip_smoke.py's gla_bwd_flops).
//
// Design: simple and right first.
//   * The decay acts on the rows c of the state, so rows are independent
//     both ways. A block takes (b, h, 32 rows): its dr, dk, dw (sums over
//     the columns e) are whole in the block, and only dv (a sum over the
//     rows) is split, into one fp32 partial a row tile that a second
//     kernel sums in order. B = 1, H = 64, d = 64 gives 128 blocks on the
//     card's 132 SMs. Thread (row c, column group q) of 32 x 8 holds 8
//     entries of S and of dS in registers.
//   * Phase A: a forward sweep writes the state before every stage of 16
//     tokens to a workspace. Phase B walks the stages in reverse: the
//     stage's states again from its start (kept in shared memory for the
//     reverse), then the tokens in reverse with dS carried in registers.
//     Per token the sums over a thread's 8 columns, then over the row's 8
//     lanes by shuffles (dr, dk, dw) and over a warp's 4 rows (dv's
//     partials, then over the block's 8 warps in order after the stage).
//   * Bit for bit repeatable: every sum has a fixed order, no atomics; du
//     is summed over B in order by the second kernel.
//   * dh < 64 masks its rows and columns (zeros in, nothing out).
#include "common.cuh"

#include <cstdint>

namespace {

constexpr int kD = 64;                     // head_dim bound
constexpr int kRowsTile = 32;              // state rows a block
constexpr int kGroups = 8;                 // column groups (threads a row)
constexpr int kCols = kD / kGroups;        // columns a thread
constexpr int kThreads = kRowsTile * kGroups;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 16;                     // tokens a stage
constexpr float kWFloor = 1e-20f;

// shared memory of a block (floats): the stage's states S_{t-1} as
// [t][kCols / 4][thread] float4s; r, k, raw w of the block's rows
// [t][kRowsTile]; v and dout rows [t][kD]; dv's warp partials
// [t][warp][kD]; dr, dk, dw of the stage [t][kRowsTile]; v . dout and
// the bonus's partial sum_c u r k over the block's rows [t]; u
struct Smem {
  float4* st;
  float *rs, *ks, *ws, *vs, *ds, *dvp, *gr, *gk, *gw, *vd, *bon, *us;
  __device__ explicit Smem(float* base) {
    st = reinterpret_cast<float4*>(base);
    rs = base + kT * kCols * kThreads;
    ks = rs + kT * kRowsTile;
    ws = ks + kT * kRowsTile;
    vs = ws + kT * kRowsTile;
    ds = vs + kT * kD;
    dvp = ds + kT * kD;
    gr = dvp + kT * kWarps * kD;
    gk = gr + kT * kRowsTile;
    gw = gk + kT * kRowsTile;
    vd = gw + kT * kRowsTile;
    bon = vd + kT;
    us = bon + kT;
  }
};

constexpr size_t kSmemFloats = kT * kCols * kThreads + 6 * kT * kRowsTile +
                               2 * kT * kD + kT * kWarps * kD + 2 * kT +
                               kRowsTile;

__device__ __forceinline__ float clamp_w(float w) {
  return w < kWFloor ? kWFloor : w;        // NaN stays NaN, as clamp_min
}

template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads, 1)
gla_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const TW* __restrict__ w,
               const float* __restrict__ u, const T* __restrict__ dout,
               const float* __restrict__ dstate, T* __restrict__ dr,
               T* __restrict__ dk, TW* __restrict__ dw,
               float* __restrict__ states, float* __restrict__ dv_part,
               float* __restrict__ du_part, int bsz, int s, int h, int d) {
  extern __shared__ float4 smem4[];
  const Smem sm(reinterpret_cast<float*>(smem4));
  const int tid = threadIdx.x;
  const int q = tid & (kGroups - 1), cl = tid / kGroups;
  const int lane = tid & 31, warp = tid >> 5;
  const int ntiles = (d + kRowsTile - 1) / kRowsTile;
  const int tile = blockIdx.x % ntiles, bh = blockIdx.x / ntiles;
  const int bi = bh / h, hi = bh % h;
  const int c0 = tile * kRowsTile, c = c0 + cl;
  const size_t step = static_cast<size_t>(h) * d;     // one token further
  const size_t head0 = (static_cast<size_t>(bi) * s * h + hi) * d;
  const int nst = (s + kT - 1) / kT;
  float* const blk_states =
      states + static_cast<size_t>(blockIdx.x) * nst * kCols * kThreads;

  if (tid < kRowsTile) sm.us[tid] = c0 + tid < d ? u[hi * d + c0 + tid] : 0.f;

  // rows of the block (r, k, raw w) and full rows (v, dout) of the n
  // tokens from t0 into shared memory, fp32, zeros past d
  auto load_rows = [&](const T* x, float* dst, int t0, int n) {
    for (int i = tid; i < kT * kRowsTile; i += kThreads) {
      const int t = i / kRowsTile, cc = c0 + i % kRowsTile;
      dst[i] = t < n && cc < d
                   ? qf::to_f32(x[head0 + static_cast<size_t>(t0 + t) * step + cc])
                   : 0.f;
    }
  };
  auto load_w = [&](int t0, int n) {
    for (int i = tid; i < kT * kRowsTile; i += kThreads) {
      const int t = i / kRowsTile, cc = c0 + i % kRowsTile;
      sm.ws[i] = t < n && cc < d
                     ? qf::to_f32(w[head0 + static_cast<size_t>(t0 + t) * step + cc])
                     : 0.f;
    }
  };
  auto load_full = [&](const T* x, float* dst, int t0, int n) {
    for (int i = tid; i < kT * kD; i += kThreads) {
      const int t = i / kD, e = i % kD;
      dst[i] = t < n && e < d
                   ? qf::to_f32(x[head0 + static_cast<size_t>(t0 + t) * step + e])
                   : 0.f;
    }
  };
  // v of token t, this thread's 8 columns
  auto cols = [&](const float* rows, int t, float (&x)[kCols]) {
    const float4* p = reinterpret_cast<const float4*>(rows + t * kD) + 2 * q;
    const float4 a = p[0], b = p[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  };

  // ---- phase A: the state before every stage, into the workspace
  float st[kCols] = {};
  for (int j = 0; j < nst; ++j) {
    float4* dst = reinterpret_cast<float4*>(
        blk_states + static_cast<size_t>(j) * kCols * kThreads);
    dst[tid] = make_float4(st[0], st[1], st[2], st[3]);
    dst[kThreads + tid] = make_float4(st[4], st[5], st[6], st[7]);
    if (j == nst - 1) break;
    const int t0 = j * kT;
    load_rows(k, sm.ks, t0, kT);
    load_w(t0, kT);
    load_full(v, sm.vs, t0, kT);
    __syncthreads();
    for (int t = 0; t < kT; ++t) {
      const float kc = sm.ks[t * kRowsTile + cl];
      const float wc = clamp_w(sm.ws[t * kRowsTile + cl]);
      float vv[kCols];
      cols(sm.vs, t, vv);
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) st[jj] = fmaf(wc, st[jj], kc * vv[jj]);
    }
    __syncthreads();
  }

  // ---- phase B: the stages in reverse, dS carried in registers
  float dS[kCols];
#pragma unroll
  for (int jj = 0; jj < kCols; ++jj) {
    const int e = kCols * q + jj;
    dS[jj] = dstate != nullptr && c < d && e < d
                 ? dstate[(static_cast<size_t>(bh) * d + c) * d + e]
                 : 0.f;
  }
  float du_acc = 0.f;
  const int hi8 = (lane >> 4) & 1, lo8 = (lane >> 3) & 1;   // row bits
  for (int j = nst - 1; j >= 0; --j) {
    const int t0 = j * kT, n = s - t0 < kT ? s - t0 : kT;
    {
      const float4* src = reinterpret_cast<const float4*>(
          blk_states + static_cast<size_t>(j) * kCols * kThreads);
      const float4 a = src[tid], b = src[kThreads + tid];
      st[0] = a.x; st[1] = a.y; st[2] = a.z; st[3] = a.w;
      st[4] = b.x; st[5] = b.y; st[6] = b.z; st[7] = b.w;
    }
    load_rows(r, sm.rs, t0, n);
    load_rows(k, sm.ks, t0, n);
    load_w(t0, n);
    load_full(v, sm.vs, t0, n);
    load_full(dout, sm.ds, t0, n);
    __syncthreads();
    // v . dout over all columns, and sum_c u r k over the block's rows,
    // a warp a token (fixed butterfly order)
    for (int t = warp; t < kT; t += kWarps) {
      float a = sm.vs[t * kD + lane] * sm.ds[t * kD + lane] +
                sm.vs[t * kD + 32 + lane] * sm.ds[t * kD + 32 + lane];
      float b = sm.us[lane] * sm.rs[t * kRowsTile + lane] *
                sm.ks[t * kRowsTile + lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        b += __shfl_xor_sync(0xffffffffu, b, off);
      }
      if (lane == 0) {
        sm.vd[t] = a;
        sm.bon[t] = b;
      }
    }
    // the stage's states S_{t-1}, from its start
    for (int t = 0; t < n; ++t) {
      sm.st[(t * 2) * kThreads + tid] = make_float4(st[0], st[1], st[2], st[3]);
      sm.st[(t * 2 + 1) * kThreads + tid] = make_float4(st[4], st[5], st[6], st[7]);
      const float kc = sm.ks[t * kRowsTile + cl];
      const float wc = clamp_w(sm.ws[t * kRowsTile + cl]);
      float vv[kCols];
      cols(sm.vs, t, vv);
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) st[jj] = fmaf(wc, st[jj], kc * vv[jj]);
    }
    __syncthreads();
    // the tokens in reverse
    for (int t = n - 1; t >= 0; --t) {
      const float rc = sm.rs[t * kRowsTile + cl];
      const float kc = sm.ks[t * kRowsTile + cl];
      const float wraw = sm.ws[t * kRowsTile + cl];
      const float wc = clamp_w(wraw);
      float vv[kCols], dd[kCols], sp[kCols];
      cols(sm.vs, t, vv);
      cols(sm.ds, t, dd);
      {
        const float4 a = sm.st[(t * 2) * kThreads + tid];
        const float4 b = sm.st[(t * 2 + 1) * kThreads + tid];
        sp[0] = a.x; sp[1] = a.y; sp[2] = a.z; sp[3] = a.w;
        sp[4] = b.x; sp[5] = b.y; sp[6] = b.z; sp[7] = b.w;
      }
      float pr = 0.f, pk = 0.f, pw = 0.f, pv[kCols];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        pr = fmaf(sp[jj], dd[jj], pr);
        pk = fmaf(dS[jj], vv[jj], pk);
        pw = fmaf(dS[jj], sp[jj], pw);
        pv[jj] = dS[jj] * kc;
        dS[jj] = fmaf(wc, dS[jj], rc * dd[jj]);
      }
      // the row's 8 lanes
#pragma unroll
      for (int off = 1; off < kGroups; off <<= 1) {
        pr += __shfl_xor_sync(0xffffffffu, pr, off);
        pk += __shfl_xor_sync(0xffffffffu, pk, off);
        pw += __shfl_xor_sync(0xffffffffu, pw, off);
      }
      // dv's partial over the warp's 4 rows: each lane keeps half of its
      // columns and takes the other row's half (xor 16), then a quarter
      // (xor 8); lane (hi8, lo8, q) ends with columns 8q + 4 hi8 + 2 lo8
      // and one further
      float a4[4], a2[2];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float keep = hi8 ? pv[m + 4] : pv[m];
        const float send = hi8 ? pv[m] : pv[m + 4];
        a4[m] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float keep = lo8 ? a4[m + 2] : a4[m];
        const float send = lo8 ? a4[m] : a4[m + 2];
        a2[m] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
      }
      {
        const int e = kCols * q + 4 * hi8 + 2 * lo8;
        float* dst = sm.dvp + (t * kWarps + warp) * kD + e;
        dst[0] = a2[0];
        dst[1] = a2[1];
      }
      if (q == 0) {
        const float vdt = sm.vd[t], uc = sm.us[cl];
        sm.gr[t * kRowsTile + cl] = pr + uc * kc * vdt;
        sm.gk[t * kRowsTile + cl] = pk + uc * rc * vdt;
        sm.gw[t * kRowsTile + cl] = wraw >= kWFloor ? pw : 0.f;
        du_acc = fmaf(rc * kc, vdt, du_acc);
      }
    }
    __syncthreads();
    // the stage's outputs: dr, dk, dw of the block's rows; dv's partial of
    // the block's rows, its warps summed in order, with the bonus
    for (int i = tid; i < n * kRowsTile; i += kThreads) {
      const int t = i / kRowsTile, cc = c0 + i % kRowsTile;
      if (cc < d) {
        const size_t o = head0 + static_cast<size_t>(t0 + t) * step + cc;
        dr[o] = qf::from_f32<T>(sm.gr[i]);
        dk[o] = qf::from_f32<T>(sm.gk[i]);
        dw[o] = qf::from_f32<TW>(sm.gw[i]);
      }
    }
    for (int i = tid; i < n * kD; i += kThreads) {
      const int t = i / kD, e = i % kD;
      if (e < d) {
        float acc = 0.f;
#pragma unroll
        for (int ww = 0; ww < kWarps; ++ww) acc += sm.dvp[(t * kWarps + ww) * kD + e];
        acc = fmaf(sm.bon[t], sm.ds[i], acc);
        const size_t o = head0 + static_cast<size_t>(t0 + t) * step + e;
        dv_part[static_cast<size_t>(tile) * bsz * s * step + o] = acc;
      }
    }
    __syncthreads();
  }
  if (q == 0 && c < d) du_part[static_cast<size_t>(bh) * d + c] = du_acc;
}

// dv = the row tiles' partials summed in order, in r's dtype; du[h, c] =
// the batch's partials summed in order
template <typename T>
__global__ void gla_bwd_finish(const float* __restrict__ dv_part,
                               const float* __restrict__ du_part,
                               T* __restrict__ dv, float* __restrict__ du,
                               size_t n_dv, int ntiles, int bsz, int hd) {
  const size_t total = n_dv + hd;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    if (i < n_dv) {
      for (int tl = 0; tl < ntiles; ++tl) acc += dv_part[tl * n_dv + i];
      dv[i] = qf::from_f32<T>(acc);
    } else {
      const size_t j = i - n_dv;
      for (int b = 0; b < bsz; ++b) acc += du_part[b * static_cast<size_t>(hd) + j];
      du[j] = acc;
    }
  }
}

template <typename T, typename TW>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* dout, const void* dstate, void* dr,
           void* dk, void* dv, void* dw, void* du, void* states,
           void* dv_part, void* du_part, int bsz, int s, int h, int d,
           void* stream) {
  const size_t smem = kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gla_bwd_kernel<T, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ntiles = (d + kRowsTile - 1) / kRowsTile;
  const auto cs = static_cast<cudaStream_t>(stream);
  const long long blocks = static_cast<long long>(bsz) * h * ntiles;
  gla_bwd_kernel<T, TW><<<static_cast<unsigned>(blocks), kThreads, smem, cs>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TW*>(w),
      static_cast<const float*>(u), static_cast<const T*>(dout),
      static_cast<const float*>(dstate), static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<TW*>(dw), static_cast<float*>(states),
      static_cast<float*>(dv_part), static_cast<float*>(du_part), bsz, s, h,
      d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n_dv = static_cast<size_t>(bsz) * s * h * d;
  const size_t total = n_dv + static_cast<size_t>(h) * d;
  const unsigned grid = static_cast<unsigned>(
      (total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  gla_bwd_finish<T><<<grid, 256, 0, cs>>>(
      static_cast<const float*>(dv_part), static_cast<const float*>(du_part),
      static_cast<T*>(dv), static_cast<float*>(du), n_dv, ntiles, bsz, h * d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of the three fp32 workspaces the wrapper allocates: the states
// before each stage, dv's partial a row tile, du's partial a (b, h).
extern "C" long long qf_gla_chunked_bwd_workspace(int bsz, int s, int h,
                                                  int d, int part) {
  const long long ntiles = (d + kRowsTile - 1) / kRowsTile;
  const long long nst = (s + kT - 1) / kT;
  if (part == 0) return static_cast<long long>(bsz) * h * ntiles * nst * kCols * kThreads;
  if (part == 1) return ntiles * bsz * s * h * d;
  return static_cast<long long>(bsz) * h * d;
}

// r, k, v, dout, dr, dk, dv (B, S, H, d) in `dtype`; w, dw (B, S, H, d) in
// `w_dtype`; u, du (H, d) fp32; dstate (B, H, d, d) fp32 or null (zero);
// the workspaces as qf_gla_chunked_bwd_workspace sizes them. 1 <= d <= 64.
extern "C" int qf_gla_chunked_bwd(const void* r, const void* k, const void* v,
                                  const void* w, const void* u,
                                  const void* dout, const void* dstate,
                                  void* dr, void* dk, void* dv, void* dw,
                                  void* du, void* states, void* dv_part,
                                  void* du_part, int bsz, int s, int h, int d,
                                  int dtype, int w_dtype, void* stream) {
  if (bsz <= 0 || s <= 0 || h <= 0 || d <= 0 || d > kD ||
      static_cast<long long>(bsz) * h * 2 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool f32 = dtype == qf::kFloat32, wf32 = w_dtype == qf::kFloat32;
  if ((!f32 && dtype != qf::kBFloat16) || (!wf32 && w_dtype != qf::kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (f32)
    return wf32 ? launch<float, float>(r, k, v, w, u, dout, dstate, dr, dk, dv,
                                       dw, du, states, dv_part, du_part, bsz,
                                       s, h, d, stream)
                : launch<float, __nv_bfloat16>(r, k, v, w, u, dout, dstate, dr,
                                               dk, dv, dw, du, states, dv_part,
                                               du_part, bsz, s, h, d, stream);
  return wf32 ? launch<__nv_bfloat16, float>(r, k, v, w, u, dout, dstate, dr,
                                             dk, dv, dw, du, states, dv_part,
                                             du_part, bsz, s, h, d, stream)
              : launch<__nv_bfloat16, __nv_bfloat16>(
                    r, k, v, w, u, dout, dstate, dr, dk, dv, dw, du, states,
                    dv_part, du_part, bsz, s, h, d, stream);
}
