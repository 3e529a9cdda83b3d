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
// What bounds it on an H100: bytes. At the RWKV6-7B prefill shape (B=4,
// S=4096, H=64, dh=64, chunk 16, r/k/v/out bf16, w fp32) it moves 810 MB,
// 0.242 ms at 3.35 TB/s. The least work (the function does not depend on
// the chunk: ~20.0 GFLOP at chunks of 6, three quarters of it products)
// takes 0.141 ms with the products in 3xTF32 on the tensor cores and the
// rest at the 67 TFLOP/s fp32 rate (chip_smoke.py's gla_flops and
// gla_least_ms).
//
// Design. The chunks of one (b, h) form a serial chain; the earlier
// design (one 256-thread block per (b, h), four barriers a chunk, every
// load issued after the previous chunk's last barrier, one warp and a
// butterfly sum per score) spent ~17.7 us a chunk mostly waiting. This
// one shortens each link of the chain, keeps the copies off it, and
// puts the products of a stage of one chunk on the tensor cores:
//   * A 256-thread block per (b, h) for chunks up to 16 (all 64 value
//     columns: thread (g, e) of 4 x 64 holds state rows 16g..16g+15 of
//     column e in registers, two blocks an SM at 128 registers a thread);
//     for longer chunks a 128-thread block per (b, h, 32 value columns),
//     whose tiles fit in shared memory. The decay acts on the key rows of
//     the state, so value columns are independent; splitting them at
//     chunk 16 (two blocks per (b, h), each forming the shared scores
//     again) measured slower on an H100. Chunks of 17-64 are not cut into
//     sub-chunks of 16: that moves the rounding against the plain version
//     at the caller's chunk past 1e-5 of the scale (chunk 64 at the decay
//     clip's ends, measured on an H100), so they keep their own path.
//   * Stages: a stage is G = 16 / L whole chunks for L <= 16 (one chunk
//     of 16; 16 chunks of 1, so the chunk-1 path of a prompt that 16 does
//     not divide pays two barriers per 16 tokens, not per token), or one
//     chunk of L > 16 taken in sub-blocks of 16 tokens.
//   * Copies: the next stage's rows of r, k, w and v go from device memory
//     to a second raw (storage-type) buffer in shared memory by cp.async
//     in 16-byte pieces while this stage computes (element by element
//     where a row is not a multiple of 16 bytes), waited for just before
//     the stage's second barrier. No register holds them in flight.
//   * Two barriers a stage. Phase 1 (no barrier before it): four lanes a
//     channel take the logs of 4 tokens each, swap them by shuffles and
//     each sums all 16 left to right (the same bits in all four); then the
//     lanes (r side, k side) x (tokens 0-7, 8-15) write r, lp_prev and the
//     decayed q, or k, lp, the decayed k and at chunk ends e^{lp_last}.
//     Phase 2: the scores, two lanes a strictly lower pair (32 channels
//     each, one shuffle) and one lane a diagonal pair (the bonus): 240 +
//     16 units, one a thread at L = 16; rows padded to 68 floats so the
//     pairs' rows fall in distinct banks. In the same phase each thread's
//     partial inter term from the state before each chunk, then its state
//     rows' update. Phase 3: out = scores @ v (ascending, up to the
//     diagonal) + the four partial inter terms. v is double-buffered so
//     that phase 1 of the next stage overwrites nothing phase 3 reads.
//   * Tensor cores for a stage of one chunk of 9 to 16 (the model's 16):
//     the three products (inter term q_dec S, update k_dec^T v, scores v)
//     as mma.sync m16n8k8 TF32 with fp32 accumulation, each operand that
//     is not exact in TF32 split into hi + lo and the lo x lo term dropped
//     (3xTF32: ~2^-22 of each product, fp32 accuracy; bf16 v is exact).
//     Warp (et, ch) of 4 x 2 keeps the state's transpose for 16 value
//     columns and 32 key channels in its accumulators (16 registers a
//     lane): its inter term over those channels for both 8-token halves,
//     its state update, then (after the second barrier, the other half's
//     inter term read from shared memory, the two added in channel order)
//     scores @ v and out for one 8-token half. The pairwise scores stay
//     on the CUDA cores. Shorter chunks (several a stage: the products
//     are slivers of one chunk each) keep the CUDA-core products.
// dh < 64 is zero-padded in shared memory; chunks longer than 64 are cut
// by the wrapper into sub-chunks that divide them (the same function: it
// is chunk-size invariant). Every exponential is expf, every log logf.
#include "common.cuh"
#include "tf32.cuh"

#include <cstdint>

namespace {

using qf::mma_3xtf32;
using qf::split;
using qf::Split;

constexpr int kD = 64;                  // head_dim bound (smaller: padded)
constexpr int kP = kD + 4;              // row pitch of the fp32 channel tiles
constexpr int kGroups = 4;              // state row groups of a block
constexpr int kRows = kD / kGroups;     // state rows a thread
constexpr int kSubT = 16;               // tokens a sub-block (one copy)
constexpr int kMaxChunk = 64;
constexpr int kMaxStageChunks = kSubT;  // chunks of 1 in a stage of 16
constexpr float kWFloor = 1e-20f;

// value columns a block: all of them for chunks up to 16 (the scores are
// formed once per (b, h)); half for longer chunks, whose tiles would not
// fit in shared memory at 64
template <int LMAX>
__host__ __device__ constexpr int tile_cols() {
  return LMAX == kSubT ? 64 : 32;
}

// the raw (storage-type) copy of one sub-block: r and k rows of 64
// channels, w rows, v rows of the block's columns; each row padded by 16
// bytes so that rows fall in distinct banks, and 16-byte aligned for
// cp.async
template <typename T, typename TW, int TE>
struct Raw {
  static constexpr int kXPitch = kD * sizeof(T) + 16;     // bytes
  static constexpr int kWPitch = kD * sizeof(TW) + 16;
  static constexpr int kVPitch = TE * sizeof(T) + 16;
  static constexpr int kBytes = kSubT * (2 * kXPitch + kWPitch + kVPitch);
};

// shared memory of a block: two raw sub-blocks, then fp32 tiles (floats):
// r, k, lp_prev, lp, decayed q and k (pitch kP); v twice and the four
// partial inter terms (TE wide); the scores; e^{lp_last} per chunk of a
// stage; u
template <typename T, typename TW, int TE, int LMAX>
__host__ __device__ constexpr size_t smem_bytes() {
  return 2 * Raw<T, TW, TE>::kBytes +
         sizeof(float) * (static_cast<size_t>(6) * LMAX * kP +
                          static_cast<size_t>(6) * LMAX * TE +
                          static_cast<size_t>(LMAX) * LMAX +
                          kMaxStageChunks * kD + kD);
}

template <typename T, typename TW, int TE, int LMAX>
struct Tiles {
  unsigned char* raw;
  float *rs, *ks, *lq, *lk, *qd, *kd, *vs, *part, *as, *dl, *us;
  __device__ explicit Tiles(unsigned char* base) {
    const int tile = LMAX * kP;
    raw = base;
    rs = reinterpret_cast<float*>(base + 2 * Raw<T, TW, TE>::kBytes);
    ks = rs + tile;
    lq = ks + tile;
    lk = lq + tile;
    qd = lk + tile;
    kd = qd + tile;
    vs = kd + tile;                     // [2][LMAX][TE]
    part = vs + 2 * LMAX * TE;          // [kGroups][LMAX][TE]
    as = part + kGroups * LMAX * TE;    // [LMAX][LMAX]
    dl = as + LMAX * LMAX;              // [kMaxStageChunks][kD]
    us = dl + kMaxStageChunks * kD;
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows [0, rows) of `row_elems` elements from device memory (row i at
// src + i * step) into shared memory rows `pitch` bytes apart: cp.async
// in 16-byte pieces when `async` (every row 16-byte aligned and a
// multiple of 16 bytes), else element by element
template <int NT, typename E>
__device__ __forceinline__ void copy_rows(unsigned char* dst, int pitch,
                                          const E* src, size_t step,
                                          int rows, int row_elems,
                                          bool async, int tid) {
  if (async) {
    const int pieces = row_elems * static_cast<int>(sizeof(E)) / 16;
    for (int i = tid; i < rows * pieces; i += NT) {
      const int t = i / pieces, p = i - t * pieces;
      cp_async16(dst + t * pitch + 16 * p,
                 reinterpret_cast<const unsigned char*>(src + t * step) +
                     16 * p);
    }
  } else {
    for (int i = tid; i < rows * row_elems; i += NT) {
      const int t = i / row_elems, c = i - t * row_elems;
      reinterpret_cast<E*>(dst + t * pitch)[c] = src[t * step + c];
    }
  }
}

// the largest t with t (t + 1) / 2 <= p: the row of pair p when a
// chunk's pairs are numbered row by row
__device__ __forceinline__ int tri_row(int p) {
  int t = static_cast<int>((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
  while (t * (t + 1) / 2 > p) --t;
  while ((t + 1) * (t + 2) / 2 <= p) ++t;
  return t;
}

// 512 / threads blocks an SM: at most 128 registers a thread
template <typename T, typename TW, int LMAX, bool kTC>
__global__ void __launch_bounds__(kGroups * tile_cols<LMAX>(),
                                  512 / (kGroups * tile_cols<LMAX>()))
gla_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const TW* __restrict__ w,
           const float* __restrict__ u, T* __restrict__ out,
           float* __restrict__ state, int s, int h, int d, int chunk,
           bool async) {
  constexpr int TE = tile_cols<LMAX>();
  constexpr int NT = kGroups * TE;
  static_assert(!kTC || LMAX == kSubT, "tensor cores: stages of one chunk");
  constexpr bool kVExact = sizeof(T) == 2;   // bf16 v is exact in TF32
  using R = Raw<T, TW, TE>;
  extern __shared__ float4 smem4[];
  const Tiles<T, TW, TE, LMAX> sm(reinterpret_cast<unsigned char*>(smem4));

  const int tid = threadIdx.x;
  const int ntiles = (d + TE - 1) / TE;
  const int bh = blockIdx.x / ntiles;
  const int col0 = (blockIdx.x % ntiles) * TE;
  const int bi = bh / h, hi = bh % h;
  const int e = tid % TE, g = tid / TE;      // value column, row group
  const int eg = col0 + e;
  const bool e_live = eg < d;
  const int ncols = d - col0 < TE ? d - col0 : TE;
  const size_t step = static_cast<size_t>(h) * d;   // one token further
  const size_t head0 = (static_cast<size_t>(bi) * s * h + hi) * d;
  const int L = chunk;
  const int G = L <= kSubT ? kSubT / L : 1;  // chunks a stage
  const int nchunks = s / L;
  // chunk starts and ends among a stage's first kSubT rows (L <= kSubT)
  unsigned starts = 0, ends = 0;
  for (int m = 0; m < kSubT; ++m) {
    if (m % L == 0) starts |= 1u << m;
    if ((m + 1) % L == 0) ends |= 1u << m;
  }

  for (int i = tid; i < kD; i += NT) sm.us[i] = i < d ? u[hi * d + i] : 0.f;
  float st[kRows];                           // CUDA cores: rows of column e
#pragma unroll
  for (int j = 0; j < kRows; ++j) st[j] = 0.f;
  // tensor cores: warp (et, ch) holds the state's transpose S^T for value
  // columns e0..e0+15 and key channels cb..cb+31 in the accumulator
  // layout of four 16 x 8 tiles (n-tile j: channels cb + 8j..)
  const int lane = tid & 31, warp = tid >> 5;
  const int ch = warp >> 2, lr = lane >> 2, lc = lane & 3;
  const int e0 = 16 * (warp & 3), cb = 32 * ch;
  float sx[4][4] = {};
  // phase 1: four lanes a channel, kRounds channels a lane
  constexpr int kRounds = 4 * kD / NT;
  float run[kRounds] = {};                   // cumulative log-decay

  // tokens [t_begin, t_begin + n) into raw buffer `rb`
  auto copy_in = [&](int t_begin, int n, int rb) {
    unsigned char* base = sm.raw + rb * R::kBytes;
    const size_t row0 = head0 + static_cast<size_t>(t_begin) * step;
    copy_rows<NT>(base, R::kXPitch, r + row0, step, n, d, async, tid);
    copy_rows<NT>(base + kSubT * R::kXPitch, R::kXPitch, k + row0, step, n,
                  d, async, tid);
    copy_rows<NT>(base + 2 * kSubT * R::kXPitch, R::kWPitch, w + row0, step,
                  n, d, async, tid);
    copy_rows<NT>(base + kSubT * (2 * R::kXPitch + R::kWPitch), R::kVPitch,
                  v + row0 + col0, step, n, ncols, async, tid);
  };

  // phase 1 for the n tokens of raw buffer rb, which start at stage row
  // lb. Four lanes share a channel: each takes the logs of 4 tokens, the
  // four swap them by shuffles and each forms the cumulative sums over
  // all 16 (left to right, the same bits in all four); then lanes (r
  // side, k side) x (first, second 8 tokens) write r, lp_prev and the
  // decayed q, or k, lp and the decayed k, of 8 tokens each
  auto stage = [&](int lb, int n, int rb, int buf) {
    const unsigned char* base = sm.raw + rb * R::kBytes;
    const int quad = tid & 3, side = quad & 1, half = quad >> 1;
#pragma unroll
    for (int it = 0; it < kRounds; ++it) {
      const int c = (tid >> 2) + it * (NT / 4);
      const bool live = c < d;
      const TW* wr = reinterpret_cast<const TW*>(
          base + 2 * kSubT * R::kXPitch) + c;
      float lw4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = 4 * quad + j;
        lw4[j] = live && m < n
                     ? logf(fmaxf(qf::to_f32(wr[m * R::kWPitch / sizeof(TW)]),
                                  kWFloor))
                     : 0.f;
      }
      float lw[kSubT], lp[kSubT];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          lw[4 * q + j] = __shfl_sync(0xffffffffu, lw4[j], (tid & 31 & ~3) | q);
#pragma unroll
      for (int m = 0; m < kSubT; ++m) {
        const bool start = LMAX == kSubT ? (starts >> m) & 1u : lb + m == 0;
        if (m < n) run[it] = (start ? 0.f : run[it]) + lw[m];
        lp[m] = run[it];
      }
      // each token's chunk-end lp (whole chunks only: LMAX == kSubT)
      float last[kSubT];
      last[kSubT - 1] = lp[kSubT - 1];
#pragma unroll
      for (int m = kSubT - 2; m >= 0; --m)
        last[m] = (ends >> m) & 1u ? lp[m] : last[m + 1];
      const T* xr = reinterpret_cast<const T*>(
          base + (side ? kSubT * R::kXPitch : 0)) + c;
      float* dx = side ? sm.ks : sm.rs;
      float* dlp = side ? sm.lk : sm.lq;
      float* dex = side ? sm.kd : sm.qd;
#pragma unroll
      for (int j = 0; j < kSubT / 2; ++j) {
        const int m = (kSubT / 2) * half + j;
        const float lpm = half ? lp[kSubT / 2 + j] : lp[j];
        const float lwm = half ? lw[kSubT / 2 + j] : lw[j];
        const float lastm = half ? last[kSubT / 2 + j] : last[j];
        if (m < n) {
          const float x = live ? qf::to_f32(xr[m * R::kXPitch / sizeof(T)]) : 0.f;
          const int o = (lb + m) * kP + c;
          dx[o] = x;
          dlp[o] = side ? lpm : lpm - lwm;       // lp, or lp_prev
          if (side == 0 || LMAX == kSubT)        // decayed q, or k
            dex[o] = x * expf(side ? lastm - lpm : lpm - lwm);
          if (side && LMAX == kSubT && ((ends >> m) & 1u))
            sm.dl[__popc(ends & ((1u << m) - 1u)) * kD + c] = expf(lpm);
        }
      }
      if (LMAX != kSubT && lb + n == L) {
        // the last sub-block of a chunk longer than kSubT: its decay and
        // decayed k, from this channel's writes (the other k-side lane's
        // too: the same warp, so visible after a warp barrier)
        __syncwarp();
        if (side) {
          if (half == 0) sm.dl[c] = expf(run[it]);
          for (int i = half; i < L; i += 2)
            sm.kd[i * kP + c] =
                sm.ks[i * kP + c] * expf(run[it] - sm.lk[i * kP + c]);
        }
      }
    }
    const T* vr = reinterpret_cast<const T*>(
        base + kSubT * (2 * R::kXPitch + R::kWPitch)) + e;
#pragma unroll
    for (int m = 0; m < kSubT / kGroups; ++m) {
      const int tl = g + kGroups * m;
      if (tl < n)
        sm.vs[(buf * LMAX + lb + tl) * TE + e] =
            e_live ? qf::to_f32(vr[tl * R::kVPitch / sizeof(T)]) : 0.f;
    }
  };

  {
    const int n0 = (G < nchunks ? G : nchunks) * L;
    copy_in(0, n0 < kSubT ? n0 : kSubT, 0);
    cp_async_wait_all();
    __syncthreads();
  }
  int buf = 0;
  for (int c0 = 0; c0 < nchunks; c0 += G, buf ^= 1) {
    const int gl = nchunks - c0 < G ? nchunks - c0 : G;   // chunks here
    const int t0 = c0 * L, nt = gl * L;                    // tokens here

    // ---- 1. turn this stage's raw rows into the fp32 tiles; start the
    //         copy of the next stage's rows
    if constexpr (LMAX == kSubT) {
      stage(0, nt, buf, buf);
      if (c0 + G < nchunks) {
        const int left = nchunks - c0 - G;
        copy_in(t0 + nt, (left < G ? left : G) * L, buf ^ 1);
      }
    } else {
      // a chunk longer than kSubT: its sub-blocks one by one, the first
      // already in raw buffer 0
      for (int sb = 0; sb < nt; sb += kSubT) {
        const int n = nt - sb < kSubT ? nt - sb : kSubT;
        if (sb > 0) {
          __syncthreads();
          copy_in(t0 + sb, n, 0);
          cp_async_wait_all();
          __syncthreads();
        }
        stage(sb, n, 0, buf);
      }
    }
    __syncthreads();

    // ---- 2a. scores: each strictly lower pair (t, i) of a chunk by two
    //          lanes, 32 channels each, with one shuffle; then the
    //          diagonal (the bonus u), one lane each over all channels.
    //          At L = 16 that is 240 + 16 units: one per thread.
    {
      const int nstrict = gl * (L * (L - 1) / 2);
      const int units = 2 * nstrict + gl * L;
      for (int base = 0; base < units; base += NT) {
        const int p = base + tid;
        const bool strict = p < 2 * nstrict;
        int rt, ri, c4, nc4;
        if (strict) {
          const int job = p >> 1, per = L * (L - 1) / 2;
          const int q = job / per, pp = job - q * per;
          const int t1 = tri_row(pp);                  // t - 1
          rt = q * L + t1 + 1;
          ri = q * L + pp - t1 * (t1 + 1) / 2;
          c4 = (p & 1) * (kD / 8);
          nc4 = kD / 8;
        } else {
          const int dd = p < units ? p - 2 * nstrict : 0;
          rt = ri = dd;
          c4 = 0;
          nc4 = kD / 4;
        }
        const float4* r4 = reinterpret_cast<const float4*>(sm.rs + rt * kP) + c4;
        const float4* k4 = reinterpret_cast<const float4*>(sm.ks + ri * kP) + c4;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        if (strict) {
          const float4* q4 =
              reinterpret_cast<const float4*>(sm.lq + rt * kP) + c4;
          const float4* l4 =
              reinterpret_cast<const float4*>(sm.lk + ri * kP) + c4;
#pragma unroll
          for (int cc = 0; cc < kD / 8; ++cc) {
            const float4 rr = r4[cc], kk = k4[cc], lq = q4[cc], lk = l4[cc];
            a[0] += rr.x * kk.x * expf(lq.x - lk.x);
            a[1] += rr.y * kk.y * expf(lq.y - lk.y);
            a[2] += rr.z * kk.z * expf(lq.z - lk.z);
            a[3] += rr.w * kk.w * expf(lq.w - lk.w);
          }
        } else {
          const float4* u4 = reinterpret_cast<const float4*>(sm.us);
#pragma unroll 4
          for (int cc = 0; cc < nc4; ++cc) {
            const float4 rr = r4[cc], kk = k4[cc], uu = u4[cc];
            a[0] += rr.x * kk.x * uu.x;
            a[1] += rr.y * kk.y * uu.y;
            a[2] += rr.z * kk.z * uu.z;
            a[3] += rr.w * kk.w * uu.w;
          }
        }
        const float sum = (a[0] + a[1]) + (a[2] + a[3]);
        const float other = __shfl_xor_sync(0xffffffffu, sum, 1);
        if (strict) {
          if ((p & 1) == 0) sm.as[rt * LMAX + ri - (rt / L) * L] = sum + other;
        } else if (p < units) {
          sm.as[rt * LMAX + ri - (rt / L) * L] = sum;
        }
      }
    }

    // the tensor cores' v^T fragments and partial inter terms (n-tile nu:
    // tokens 8nu..8nu+7), kept for phase 3
    unsigned vhi[2][4], vlo[2][4];
    float inter[2][4];
    if constexpr (kTC) {
      // ---- 2b. the products on the tensor cores in 3xTF32. v^T of the
      //          stage as A fragments (rows e, columns i: tokens past the
      //          stage read as 0); then per chunk the inter term of the
      //          chunk's tokens, out^T += S^T (q_dec)^T over this warp's 32
      //          channels, from the state before the chunk (its 16 x 32 tile
      //          as the A operand: the fragment slots of channels 2c, 2c + 1
      //          go to k-slots c, c + 4, and q_dec is read in that order),
      //          and the update S^T = e^{lp_last} S^T + v^T k_dec
      {
        const float* vb = sm.vs + buf * LMAX * TE;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int i = 8 * kk + lc + 4 * (x >> 1), ee = e0 + lr + 8 * (x & 1);
            const Split sp = split(i < nt ? vb[i * kD + ee] : 0.f);
            vhi[kk][x] = sp.hi;
            vlo[kk][x] = kVExact ? 0u : sp.lo;
          }
      }
#pragma unroll
      for (int nu = 0; nu < 2; ++nu)
#pragma unroll
        for (int x = 0; x < 4; ++x) inter[nu][x] = 0.f;
      for (int q = 0; q < gl; ++q) {
        const int tq = q * L, lo8 = tq >> 3, hi8 = (tq + L - 1) >> 3;
        unsigned shi[4][4], slo[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            // k-slot order: (row lr, c), (row lr + 8, c), (lr, c + 4), ...
            const Split sp = split(sx[j][(x & 1) * 2 + (x >> 1)]);
            shi[j][x] = sp.hi;
            slo[j][x] = sp.lo;
          }
#pragma unroll
        for (int nu = 0; nu < 2; ++nu) {
          if (nu < lo8 || nu > hi8) continue;
          float ra[4] = {}, rb[4] = {};
          const float* qrow = sm.qd + (8 * nu + lr) * kP + cb + 2 * lc;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 qq = *reinterpret_cast<const float2*>(qrow + 8 * j);
            mma_3xtf32<false>(j & 1 ? rb : ra, shi[j], slo[j], split(qq.x),
                              split(qq.y));
          }
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int t = 8 * nu + 2 * lc + (x & 1);
            if (t >= tq && t < tq + L) inter[nu][x] = ra[x] + rb[x];
          }
        }
        const float* dlq = sm.dl + q * kD + cb + 2 * lc;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 dd = *reinterpret_cast<const float2*>(dlq + 8 * j);
          sx[j][0] *= dd.x;
          sx[j][1] *= dd.y;
          sx[j][2] *= dd.x;
          sx[j][3] *= dd.y;
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          if (kk < lo8 || kk > hi8) continue;
          const int i0 = 8 * kk + lc, i1 = i0 + 4;
          const bool in0 = i0 >= tq && i0 < tq + L, in1 = i1 >= tq && i1 < tq + L;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = cb + 8 * j + lr;
            mma_3xtf32<kVExact>(sx[j], vhi[kk], vlo[kk],
                                split(in0 ? sm.kd[i0 * kP + c] : 0.f),
                                split(in1 ? sm.kd[i1 * kP + c] : 0.f));
          }
        }
      }
      // the other channel half's warp takes n-tile 1 - ch: hand it this
      // half's partial inter term (selected, not indexed by ch: the
      // array stays in registers)
      float hand[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) hand[x] = ch ? inter[0][x] : inter[1][x];
      reinterpret_cast<float4*>(sm.part)[((warp & 3) * 2 + (ch ^ 1)) * 32 + lane] =
          make_float4(hand[0], hand[1], hand[2], hand[3]);
    } else {
      // ---- 2b. per chunk: this thread's partial inter term from the state
      //          before the chunk (rows c0r..c0r+15, column e), then the
      //          update of those state entries; four tokens at a time
      {
        const int c0r = g * kRows;
        for (int q = 0; q < gl; ++q) {
          const int tq = q * L;
          for (int tb = tq; tb < tq + L; tb += 4) {
#pragma unroll
            for (int uo = 0; uo < 4; ++uo) {
              const int t = tb + uo;
              if (t < tq + L) {
                const float4* q4 =
                    reinterpret_cast<const float4*>(sm.qd + t * kP + c0r);
                float a[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  const float4 qq = q4[j];
                  a[j] = qq.x * st[4 * j] + qq.y * st[4 * j + 1] +
                         qq.z * st[4 * j + 2] + qq.w * st[4 * j + 3];
                }
                sm.part[(g * LMAX + t) * TE + e] = (a[0] + a[1]) + (a[2] + a[3]);
              }
            }
          }
          float kv[kRows];
#pragma unroll
          for (int j = 0; j < kRows; ++j) kv[j] = 0.f;
          for (int ib = tq; ib < tq + L; ib += 4) {
#pragma unroll
            for (int uo = 0; uo < 4; ++uo) {
              const int i = ib + uo;
              if (i < tq + L) {
                const float vv = sm.vs[(buf * LMAX + i) * TE + e];
                const float4* k4 =
                    reinterpret_cast<const float4*>(sm.kd + i * kP + c0r);
#pragma unroll
                for (int j = 0; j < kRows / 4; ++j) {
                  const float4 kk = k4[j];
                  kv[4 * j] += kk.x * vv;
                  kv[4 * j + 1] += kk.y * vv;
                  kv[4 * j + 2] += kk.z * vv;
                  kv[4 * j + 3] += kk.w * vv;
                }
              }
            }
          }
          const float* dlq = sm.dl + q * kD + c0r;
#pragma unroll
          for (int j = 0; j < kRows; ++j) st[j] = dlq[j] * st[j] + kv[j];
        }
      }
    }
    cp_async_wait_all();   // the next stage's rows: visible after the barrier
    __syncthreads();

    if constexpr (kTC) {
      // ---- 3. out^T = inter + (scores . v)^T for tokens 8ch..8ch+7 and
      //         columns e0..e0+15: the two channel halves' inter terms in
      //         a fixed order, then the scores of each token's chunk up to
      //         the diagonal (the rest read as 0) against v, on the tensor
      //         cores in 3xTF32
      {
        const float4 other =
            reinterpret_cast<const float4*>(sm.part)[((warp & 3) * 2 + ch) * 32 + lane];
        const float oth[4] = {other.x, other.y, other.z, other.w};
        float acc[4];
#pragma unroll
        for (int x = 0; x < 4; ++x)
          acc[x] = ch ? oth[x] + inter[1][x] : inter[0][x] + oth[x];
        const int t = 8 * ch + lr, i0 = (t / L) * L;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          if (kk > ch) continue;              // i > t everywhere
          const int ia = 8 * kk + lc, ib = ia + 4;
          const float sa = ia >= i0 && ia <= t ? sm.as[t * kSubT + ia - i0] : 0.f;
          const float sb = ib >= i0 && ib <= t ? sm.as[t * kSubT + ib - i0] : 0.f;
          mma_3xtf32<kVExact>(acc, vhi[kk], vlo[kk], split(sa), split(sb));
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int tt = 8 * ch + 2 * lc + (x & 1), ee = e0 + lr + 8 * (x >> 1);
          if (tt < nt && ee < d)
            out[head0 + static_cast<size_t>(t0 + tt) * step + ee] =
                qf::from_f32<T>(acc[x]);
        }
      }
    } else {
      // ---- 3. out = (intra + bonus) + inter, tokens g, g + 4, ...: the
      //         scores of each token's chunk up to the diagonal against v,
      //         in ascending order
      {
        const float* vb = sm.vs + buf * LMAX * TE + e;
        for (int tb = 0; tb < nt; tb += kSubT) {
          float acc[kSubT / kGroups];
#pragma unroll
          for (int mm = 0; mm < kSubT / kGroups; ++mm) acc[mm] = 0.f;
          const int ilo = LMAX == kSubT ? 0 : (tb / L) * L;
          for (int ib = ilo; ib < tb + kSubT && ib < nt; ib += kSubT) {
#pragma unroll
            for (int ii = 0; ii < kSubT; ++ii) {
              const int i = ib + ii;
              const float vi = vb[i * TE];
#pragma unroll
              for (int mm = 0; mm < kSubT / kGroups; ++mm) {
                const int t = tb + g + kGroups * mm;
                const int i0 = (t / L) * L;
                if (i >= i0 && i <= t) acc[mm] += sm.as[t * LMAX + i - i0] * vi;
              }
            }
          }
#pragma unroll
          for (int mm = 0; mm < kSubT / kGroups; ++mm) {
            const int t = tb + g + kGroups * mm;
            if (t < nt) {
              float inter = 0.f;
#pragma unroll
              for (int gg = 0; gg < kGroups; ++gg)
                inter += sm.part[(gg * LMAX + t) * TE + e];
              if (e_live)
                out[head0 + static_cast<size_t>(t0 + t) * step + eg] =
                    qf::from_f32<T>(acc[mm] + inter);
            }
          }
        }
      }
    }
    if constexpr (LMAX != kSubT) {
      // the next chunk's first sub-block, into raw buffer 0 (phase 1 of
      // this chunk is done with it: the barrier above)
      if (c0 + 1 < nchunks) {
        copy_in(t0 + nt, nt < kSubT ? nt : kSubT, 0);
        cp_async_wait_all();
      }
      __syncthreads();
    }
  }

  float* dst = state + static_cast<size_t>(bh) * d * d;
  if constexpr (kTC) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int c = cb + 8 * j + 2 * lc + (x & 1), ee = e0 + lr + 8 * (x >> 1);
        if (c < d && ee < d) dst[c * d + ee] = sx[j][x];
      }
  } else if (e_live) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int cr = g * kRows + j;
      if (cr < d) dst[cr * d + eg] = st[j];
    }
  }
}

template <typename T, typename TW, int LMAX, bool kTC>
int launch_l(const void* r, const void* k, const void* v, const void* w,
             const void* u, void* out, void* state, int bsz, int s, int h,
             int d, int chunk, void* stream) {
  constexpr int TE = tile_cols<LMAX>();
  const size_t smem = smem_bytes<T, TW, TE, LMAX>();
  const cudaError_t err = cudaFuncSetAttribute(
      gla_kernel<T, TW, LMAX, kTC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // cp.async in 16-byte pieces needs every row 16-byte aligned
  const auto addr = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p);
  };
  const bool async = (addr(r) | addr(k) | addr(v) | addr(w)) % 16 == 0 &&
                     (d * sizeof(T)) % 16 == 0 && (d * sizeof(TW)) % 16 == 0;
  const long long blocks =
      static_cast<long long>(bsz) * h * ((d + TE - 1) / TE);
  gla_kernel<T, TW, LMAX, kTC><<<static_cast<unsigned>(blocks), kGroups * TE,
                                 smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TW*>(w),
      static_cast<const float*>(u), static_cast<T*>(out),
      static_cast<float*>(state), s, h, d, chunk, async);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TW>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* out, void* state, int bsz, int s, int h,
           int d, int chunk, void* stream) {
  // a stage of several chunks (L <= 8): the products on the CUDA cores;
  // one chunk of 9 to 16: on the tensor cores; longer: sub-blocks
  if (chunk <= kSubT / 2)
    return launch_l<T, TW, kSubT, false>(r, k, v, w, u, out, state, bsz, s,
                                         h, d, chunk, stream);
  if (chunk <= kSubT)
    return launch_l<T, TW, kSubT, true>(r, k, v, w, u, out, state, bsz, s, h,
                                        d, chunk, stream);
  return launch_l<T, TW, kMaxChunk, false>(r, k, v, w, u, out, state, bsz, s,
                                           h, d, chunk, stream);
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
      static_cast<long long>(bsz) * h * 2 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool f32 = dtype == qf::kFloat32, wf32 = w_dtype == qf::kFloat32;
  if ((!f32 && dtype != qf::kBFloat16) ||
      (!wf32 && w_dtype != qf::kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (f32)
    return wf32 ? launch<float, float>(r, k, v, w, u, out, state, bsz, s, h,
                                       d, chunk, stream)
                : launch<float, __nv_bfloat16>(r, k, v, w, u, out, state, bsz,
                                               s, h, d, chunk, stream);
  return wf32 ? launch<__nv_bfloat16, float>(r, k, v, w, u, out, state, bsz,
                                             s, h, d, chunk, stream)
              : launch<__nv_bfloat16, __nv_bfloat16>(r, k, v, w, u, out, state,
                                                     bsz, s, h, d, chunk,
                                                     stream);
}
