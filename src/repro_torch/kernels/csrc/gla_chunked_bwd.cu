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
// products in 3xTF32) is below that (chip_smoke.py's gla_bwd_flops). The
// step form itself does ~12 fp32 instructions an entry of the state a
// token: 12.9 G at that shape, ~0.38 ms at the fp32 rate.
//
// Design. Both recurrences act on each entry (c, e) of the state alone,
//   S_t[c, e] = w_t[c] S_{t-1}[c, e] + k_t[c] v_t[e]
//   dS_{t-1}[c, e] = w_t[c] dS_t[c, e] + r_t[c] do_t[e],
// and only the gradients' sums couple entries. So the walk over the
// sequence is cut at checkpoints every kStage = 16 tokens (a stage), and
// then every stage runs at once (stages of 32 tokens halve the
// checkpoints' bytes and measured the same on an H100, 64 slower:
// PERF.md):
//   1. gla_bwd_scan: a block per (b, h, chain, 32 rows) walks one chain,
//      S forward from 0 or dS backward from dstate, parallel over the
//      2,048 entries of its rows (16 a thread), and writes the value at
//      every stage boundary: S before each stage, dS after its last
//      token. No sums: two fp32 instructions an entry a token. The rows
//      come in by TMA, 64 tokens a box, two boxes ahead of the walk, and
//      are converted to fp32 once. The scans use the stage pass's fma
//      (fmaf(w, x, a * b)), so a checkpoint is the value the serial walk
//      reaches there, bit for bit.
//   2. gla_bwd_stage: a thread block cluster of ceil(d / 16) blocks per
//      (b, h, stage), a block per 16 rows of the state; thread (row, 4
//      columns) of 16 x 16. From its two checkpoints a block recomputes
//      the stage's 16 states (4 entries a thread, in registers), then
//      walks them in reverse with dS in registers. A token past the
//      stage's end is an identity step (w 1, r k v dout 0), so the walks
//      run unguarded. dr, dk and dw (sums over the
//      columns) are summed over a thread's 4 columns, then over the row's
//      16 lanes by a butterfly that scatters: levels xor 8 and 4 on each
//      group of 4 tokens as it is made, xor 2 and 1 once a stage,
//      leaving one token's three sums a lane (45 shuffles a stage). dv (a sum over the rows) pairs a warp's two rows by one
//      shuffle a token and sums the block's 8 warps pairwise; st.async
//      pushes each quarter row of 16 columns, with the bonus's partial
//      over the block's rows, into the shared memory of the cluster
//      block that owns it, completing on that block's mbarrier; the
//      owner sums the blocks' partials pairwise in rank order and adds
//      the bonus term once (added to each block's partial, its extra
//      roundings put dv of chip_smoke.py phase 12b's fp32 round past the
//      1e-6 gate against the fp64 function). No cluster-wide barrier a
//      stage, nothing through device memory. The clusters are
//      persistent (as many as fit on the card), each taking stages in
//      turn; the next stage's rows of r, k, w, v, dout and u come in by
//      TMA (issued by six warps, a box each) while this one runs.
//   3. gla_bwd_du: du = the stages' partials summed over b and stages in
//      a fixed order.
//   * Bit for bit repeatable: every sum has a fixed order, no atomics.
//   * dh < 64 masks its rows and columns (zeros in, nothing out). The
//     copy is chosen from the operands alone (qf_gla_chunked_bwd_tma):
//     16-byte aligned pointers and rows go by TMA, and a tensor map that
//     fails to encode is an error, never a slower copy; other rows are
//     copied element by element.
#include "hopper.cuh"

#include <cooperative_groups.h>

#include <cstdint>

namespace cg = cooperative_groups;
using qf::hopper::mbar_expect_tx;
using qf::hopper::mbar_init;
using qf::hopper::mbar_wait;
using qf::hopper::smem_addr;
using qf::hopper::tma_load;

namespace {

constexpr int kD = 64;             // head_dim bound: the state is kD x kD
constexpr int kThreads = 256;      // a stage block
constexpr int kScanThreads = 128;  // a scan block
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;          // state rows of a stage block
constexpr int kStage = 16;         // tokens a stage; a thread's states
constexpr int kScanRows = 32;      // state rows of a scan block
constexpr int kChunk = 64;         // tokens a scan block copies at once
constexpr int kRing = 3;           // a scan block's copies in flight
constexpr int kRuns = 16;          // du: runs of (b, stage) summed apart
constexpr float kWFloor = 1e-20f;
constexpr unsigned kFull = 0xffffffffu;
// a stage's butterfly leaves a lane one token of 16, and its (token, 4
// columns) pass takes a thread a token; a scan chunk holds whole stages
static_assert(kStage == 16 && kThreads == 16 * kStage, "stage layout");
static_assert(kChunk % kStage == 0, "scan chunk");

__device__ __forceinline__ float clamp_w(float w) {
  return w < kWFloor ? kWFloor : w;        // NaN stays NaN, as clamp_min
}

// `bytes` (a multiple of 16) from device memory into shared memory,
// completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// n rows of `elems` elements (row t at src + t * step) into shared memory
// rows `pitch` elements apart, element by element: the copy for rows that
// are not 16-byte multiples, which the tensor maps cannot take
template <int NT, typename E>
__device__ __forceinline__ void copy_rows(E* dst, const E* src, size_t step,
                                          int n, int elems, int pitch,
                                          int tid) {
#pragma unroll 1
  for (int i = tid; i < n * elems; i += NT) {
    const int t = i / elems, e = i - t * elems;
    dst[t * pitch + e] = src[t * step + e];
  }
}

// 8 consecutive elements (16-byte aligned) in fp32
__device__ __forceinline__ void load8(const float* src, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src,
                                      float (&x)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(src);
  const unsigned words[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(words[i] << 16);
    x[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store8(float* dst, const float (&x)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

// the (B S, H, d) rows of one operand as a 3-D tensor map (column, head,
// token) of boxes `cols` columns x 1 head x `tokens` tokens, no swizzle;
// reads past d or past the last token fill with zeros
inline bool rows_map(CUtensorMap* map, const void* ptr, bool bf16,
                     long long tokens, int h, int d, int cols, int box_t) {
  const qf::hopper::EncodeTiled encode = qf::hopper::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t es = bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(tokens)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * es,
                                 static_cast<cuuint64_t>(h) * d * es};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols), 1,
                             static_cast<cuuint32_t>(box_t)};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map,
                bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                3, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the scan's maps: a (k for chain 0, r for chain 1) and w, kScanRows
// columns, x (v, dout) kD columns, kChunk tokens a box
struct ScanMaps {
  CUtensorMap a[2], w, x[2];
};

// the stage pass's maps: r, k, w kRows columns, v, dout kD, a stage a box
struct StageMaps {
  CUtensorMap r, k, w, v, d;
};

// ---- 1. the per-entry scans to the checkpoints

// shared memory of a scan block: kRing raw buffers {a, w} [kChunk]
// [kScanRows] and x [kChunk][kD] in the storage types, then one of each
// in fp32 (w clamped), then the raw buffers' mbarriers
template <typename T, typename TW>
struct ScanSmem {
  static constexpr size_t raw_w = kChunk * kScanRows * sizeof(T);
  static constexpr size_t raw_x = raw_w + kChunk * kScanRows * sizeof(TW);
  static constexpr size_t raw = align128(raw_x + kChunk * kD * sizeof(T));
  static constexpr size_t fa = kRing * raw;
  static constexpr size_t fw = fa + kChunk * kScanRows * 4;
  static constexpr size_t fx = fw + kChunk * kScanRows * 4;
  static constexpr size_t bars = fx + kChunk * kD * 4;
  static constexpr size_t bytes = bars + kRing * 8;
  static constexpr int tx = static_cast<int>(raw_x + kChunk * kD * sizeof(T));
};

// Block (b, h, chain, 32-row half): chain 0 walks S forward over the
// tokens before the last stage (a = k, x = v) and writes S before every
// stage to ck_f; chain 1 walks dS backward from dstate over the tokens
// after the first stage (a = r, x = dout) and writes dS after every
// stage's last token to ck_b. Checkpoints are [b, h][stage][kD][kD].
// Thread (p, q) of 8 x 16 holds rows 4p..4p + 3 and columns 4q..4q + 3.
template <typename T, typename TW>
__global__ void __launch_bounds__(kScanThreads)
gla_bwd_scan(const __grid_constant__ ScanMaps maps, const T* __restrict__ r,
             const T* __restrict__ k, const T* __restrict__ v,
             const TW* __restrict__ w, const T* __restrict__ dout,
             const float* __restrict__ dstate, float* __restrict__ ck_f,
             float* __restrict__ ck_b, int s, int h, int d, bool tma) {
  using L = ScanSmem<T, TW>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nhalf = (d + kScanRows - 1) / kScanRows;
  const int half = blockIdx.x % nhalf;
  const int chain = (blockIdx.x / nhalf) & 1;
  const int bh = blockIdx.x / (2 * nhalf), bi = bh / h, hi = bh % h;
  const int tid = threadIdx.x, p = tid >> 4, q = tid & 15;
  const int c0 = half * kScanRows;
  const int nrow = d - c0 < kScanRows ? d - c0 : kScanRows;
  const int nst = (s + kStage - 1) / kStage;
  const T* const a = chain ? r : k;
  const T* const x = chain ? dout : v;
  float* const ck = chain ? ck_b : ck_f;
  const size_t step = static_cast<size_t>(h) * d;
  const size_t head = static_cast<size_t>(bi) * s * step +
                      static_cast<size_t>(hi) * d;
  const float* fa = reinterpret_cast<const float*>(smem + L::fa);
  const float* fw = reinterpret_cast<const float*>(smem + L::fw);
  const float* fx = reinterpret_cast<const float*>(smem + L::fx);

  float st_[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + 4 * p + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = 4 * q + j;
      st_[i][j] = chain && dstate != nullptr && c < d && e < d
                      ? dstate[(static_cast<size_t>(bh) * d + c) * d + e]
                      : 0.f;
    }
  }
  auto store = [&](int stage) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4* dst = reinterpret_cast<float4*>(
          ck + (static_cast<size_t>(bh) * nst + stage) * kD * kD +
          (c0 + 4 * p + i) * kD + 4 * q);
      *dst = make_float4(st_[i][0], st_[i][1], st_[i][2], st_[i][3]);
    }
  };
  // chain 0 walks the tokens [0, (nst - 1) kStage) forward, chain 1 the
  // tokens [kStage, s) backward, in chunks of kChunk tokens (chunk c copies
  // [c kChunk, c kChunk + kChunk) and walks the part of it in range), the
  // copies kRing - 1 chunks ahead
  const int lo = chain ? kStage : 0, hi_t = chain ? s : (nst - 1) * kStage;
  const int c_lo = lo / kChunk, c_hi = (hi_t - 1) / kChunk;
  const int n_chunks = hi_t > lo ? c_hi - c_lo + 1 : 0;
  auto chunk_of = [&](int i) { return chain ? c_hi - i : c_lo + i; };
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem + L::bars);
  auto issue = [&](int i) {
    if (i >= n_chunks) return;
    const int t0 = chunk_of(i) * kChunk;
    unsigned char* rb = smem + (i % kRing) * L::raw;
    if (tma) {       // boxes past s or d fill with zeros
      if (tid == 0) {
        uint64_t* bar = bars + i % kRing;
        const int row = bi * s + t0;
        mbar_expect_tx(bar, L::tx);
        tma_load(rb, &maps.a[chain], c0, hi, row, bar);
        tma_load(rb + L::raw_w, &maps.w, c0, hi, row, bar);
        tma_load(rb + L::raw_x, &maps.x[chain], 0, hi, row, bar);
      }
    } else {
      const int n = s - t0 < kChunk ? s - t0 : kChunk;
      const size_t o = head + static_cast<size_t>(t0) * step;
      copy_rows<kScanThreads>(reinterpret_cast<T*>(rb), a + o + c0, step, n,
                              nrow, kScanRows, tid);
      copy_rows<kScanThreads>(reinterpret_cast<TW*>(rb + L::raw_w),
                              w + o + c0, step, n, nrow, kScanRows, tid);
      copy_rows<kScanThreads>(reinterpret_cast<T*>(rb + L::raw_x), x + o,
                              step, n, d, kD, tid);
    }
  };
  auto walk = [&](int t) {
    const float4 wv = reinterpret_cast<const float4*>(fw + t * kScanRows)[p];
    const float4 av = reinterpret_cast<const float4*>(fa + t * kScanRows)[p];
    const float4 xv = reinterpret_cast<const float4*>(fx + t * kD)[q];
    const float ws[4] = {wv.x, wv.y, wv.z, wv.w};
    const float as[4] = {av.x, av.y, av.z, av.w};
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        st_[i][j] = fmaf(ws[i], st_[i][j], as[i] * xs[j]);
  };

  if (tma && tid == 0) {
    for (int i = 0; i < kRing; ++i) mbar_init(bars + i, 1);
    fence_barrier_init();
  }
  __syncthreads();
  store(chain ? nst - 1 : 0);
  for (int i = 0; i < kRing - 1; ++i) issue(i);
  for (int i = 0; i < n_chunks; ++i) {
    issue(i + kRing - 1);    // into the buffer chunk i - 1 was read from
    if (tma) mbar_wait(bars + i % kRing, (i / kRing) & 1);
    __syncthreads();
    const int t0 = chunk_of(i) * kChunk;
    const int n = s - t0 < kChunk ? s - t0 : kChunk;
    {
      const unsigned char* rb = smem + (i % kRing) * L::raw;
      const T* ra = reinterpret_cast<const T*>(rb);
      const TW* rw = reinterpret_cast<const TW*>(rb + L::raw_w);
      const T* rx = reinterpret_cast<const T*>(rb + L::raw_x);
      float* wa = reinterpret_cast<float*>(smem + L::fa);
      float* ww = reinterpret_cast<float*>(smem + L::fw);
      float* wx = reinterpret_cast<float*>(smem + L::fx);
      if (n == kChunk && nrow == kScanRows && d == kD) {
        float xv[8];
        for (int idx = 8 * tid; idx < kChunk * kScanRows;
             idx += 8 * kScanThreads) {
          load8(ra + idx, xv);
          store8(wa + idx, xv);
          load8(rw + idx, xv);
#pragma unroll
          for (int j = 0; j < 8; ++j) xv[j] = clamp_w(xv[j]);
          store8(ww + idx, xv);
        }
        for (int idx = 8 * tid; idx < kChunk * kD; idx += 8 * kScanThreads) {
          load8(rx + idx, xv);
          store8(wx + idx, xv);
        }
      } else {
#pragma unroll 1
        for (int idx = tid; idx < kChunk * kScanRows; idx += kScanThreads) {
          const int t = idx / kScanRows, cr = idx % kScanRows;
          const bool ok = t < n && cr < nrow;
          wa[idx] = ok ? qf::to_f32(ra[idx]) : 0.f;
          ww[idx] = clamp_w(ok ? qf::to_f32(rw[idx]) : 0.f);
        }
#pragma unroll 1
        for (int idx = tid; idx < kChunk * kD; idx += kScanThreads) {
          const bool ok = idx / kD < n && idx % kD < d;
          wx[idx] = ok ? qf::to_f32(rx[idx]) : 0.f;
        }
      }
    }
    __syncthreads();
    // the chunk's tokens in range (whole stages: kChunk is a multiple of
    // kStage), a stage at a time, each ending on a checkpoint
    const int ta = t0 > lo ? t0 : lo;
    const int tb = t0 + n < hi_t ? t0 + n : hi_t;
    if (chain == 0) {
      for (int ts = ta; ts < tb; ts += kStage) {
#pragma unroll
        for (int t = 0; t < kStage; ++t) walk(ts - t0 + t);
        store(ts / kStage + 1);
      }
    } else {
      for (int ts = (tb - 1) / kStage * kStage; ts >= ta; ts -= kStage) {
        if (ts + kStage <= tb) {
#pragma unroll
          for (int t = kStage - 1; t >= 0; --t) walk(ts - t0 + t);
        } else {
          for (int t = tb - 1 - ts; t >= 0; --t) walk(ts - t0 + t);
        }
        store(ts / kStage - 1);
      }
    }
  }
}

// ---- 2. every stage at once

// shared memory of a stage block (bytes): two raw buffers {r, k, w of the
// block's rows, v, dout} [kStage][..] in the storage types and u of the
// rows [kRows] fp32; fp32 rows (r, k, clamped w, raw w; raw w becomes dw
// once the row's sums are made) [kStage][kRows] float4, v and dout
// [kStage][kD]; dv's warp partials [kStage][kWarps][kD]; the dv partials
// the cluster's blocks push to this block, [2][block][unit][16] (a unit
// is a quarter row of 16 columns of one token; two sets, so that one
// stage's can arrive while the last is summed), and beside them the
// bonus's partials [2][block][unit]; dr, dk [2][kStage][kRows]; v . dout
// [kStage]; u [kRows]; du's partial a warp [kWarps][kRows]; the raw
// buffers' and the received partials' mbarriers
template <typename T, typename TW>
struct StageSmem {
  static constexpr size_t raw_k = kStage * kRows * sizeof(T);
  static constexpr size_t raw_w = 2 * raw_k;
  static constexpr size_t raw_v = raw_w + kStage * kRows * sizeof(TW);
  static constexpr size_t raw_d = raw_v + kStage * kD * sizeof(T);
  static constexpr size_t raw_u = raw_d + kStage * kD * sizeof(T);
  static constexpr size_t raw = align128(raw_u + kRows * 4);
  static constexpr size_t rowf = 2 * raw;
  static constexpr size_t colv = rowf + kStage * kRows * 16;
  static constexpr size_t cold = colv + kStage * kD * 4;
  static constexpr size_t dvp = cold + kStage * kD * 4;
  // nq x ceil(4 kStage / nq), nq <= 4
  static constexpr int units = 2 * (4 * kStage + 2);
  static constexpr size_t rcv = dvp + kStage * kWarps * kD * 4;
  static constexpr size_t rcv_bon = rcv + units * 16 * 4;
  static constexpr size_t g = rcv_bon + units * 4;
  static constexpr size_t vd = g + 2 * kStage * kRows * 4;
  static constexpr size_t us = vd + kStage * 4;
  static constexpr size_t dup = us + kRows * 4;
  static constexpr size_t bars = (dup + kWarps * kRows * 4 + 7) / 8 * 8;
  static constexpr size_t bytes = bars + 4 * 8;
};

// the shared::cluster address of `p` in block `rank` of the cluster
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(smem_addr(p)), "r"(rank));
  return out;
}

// a store into another block's shared memory that completes on its
// mbarrier
__device__ __forceinline__ void push4(uint32_t dst, float4 x, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w), "r"(bar) : "memory");
}

__device__ __forceinline__ void push1(uint32_t dst, float x, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(dst), "r"(__float_as_uint(x)), "r"(bar) : "memory");
}

// x[0] + .. + x[n - 1] for n <= 4, pairwise: (x0 + x1) + (x2 + x3)
__device__ __forceinline__ float pair_sum(const float (&x)[4], int n) {
  if (n == 1) return x[0];
  if (n == 2) return x[0] + x[1];
  if (n == 3) return (x[0] + x[1]) + x[2];
  return (x[0] + x[1]) + (x[2] + x[3]);
}

// an mbarrier phase completed by other blocks' pushes
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// The sums of a row's 16 lanes (xor 8, 4, 2, 1), three quantities of 16
// tokens, as a butterfly that scatters: at each level a lane keeps the
// half of its values whose index bit matches its own lane bit and sends
// the other half to its partner. Levels xor 8 and 4 run on each group of
// four tokens as soon as it is made (x[quantity][token & 3] -> one token's
// three sums over 4 lanes, in acc[group]); levels xor 2 and 1 on the four
// groups at the end. Lane q ends with token lane_token(q).
__device__ __forceinline__ void scatter4(const float (&x)[3][4], int q,
                                         float (&acc)[3]) {
  const bool s8 = q & 8, s4 = q & 4;
#pragma unroll
  for (int n = 0; n < 3; ++n) {
    float y[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      y[i] = (s8 ? x[n][i + 2] : x[n][i]) +
             __shfl_xor_sync(kFull, s8 ? x[n][i] : x[n][i + 2], 8);
    acc[n] = (s4 ? y[1] : y[0]) + __shfl_xor_sync(kFull, s4 ? y[0] : y[1], 4);
  }
}

__device__ __forceinline__ void scatter_groups(const float (&acc)[4][3],
                                               int q, float (&out)[3]) {
  const bool s2 = q & 2, s1 = q & 1;
#pragma unroll
  for (int n = 0; n < 3; ++n) {
    float z[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      z[i] = (s2 ? acc[i + 2][n] : acc[i][n]) +
             __shfl_xor_sync(kFull, s2 ? acc[i][n] : acc[i + 2][n], 2);
    out[n] = (s1 ? z[1] : z[0]) + __shfl_xor_sync(kFull, s1 ? z[0] : z[1], 1);
  }
}

// the token whose sums lane q holds after scatter4 and scatter_groups
__device__ __forceinline__ int lane_token(int q) {
  return 8 * ((q >> 1) & 1) + 4 * (q & 1) + 2 * ((q >> 3) & 1) +
         ((q >> 2) & 1);
}

// Cluster (b, h, stage) of ceil(d / 16) blocks, block `rank` holding
// state rows 16 rank.. of it; thread (cl, q) of 16 x 16 holds row cl and
// columns 4q..4q + 3. The clusters are persistent: cluster i takes items
// (b, h, stage) i, i + clusters, ..
template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads, 2)
gla_bwd_stage(const __grid_constant__ StageMaps maps, const T* __restrict__ r,
              const T* __restrict__ k, const T* __restrict__ v,
              const TW* __restrict__ w, const float* __restrict__ u,
              const T* __restrict__ dout, const float* __restrict__ ck_f,
              const float* __restrict__ ck_b, T* __restrict__ dr,
              T* __restrict__ dk, T* __restrict__ dv, TW* __restrict__ dw,
              float* __restrict__ du_part, int s, int h, int d, int items,
              bool tma) {
  using L = StageSmem<T, TW>;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nq = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int ncl = gridDim.x / nq;
  const int tid = threadIdx.x, cl = tid >> 4, q = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const int c0 = rank * kRows, c = c0 + cl;
  const int nrow = d - c0 < kRows ? d - c0 : kRows;
  const int nst = (s + kStage - 1) / kStage;
  const size_t step = static_cast<size_t>(h) * d;

  float4* const rowf = reinterpret_cast<float4*>(smem + L::rowf);
  float* const colv = reinterpret_cast<float*>(smem + L::colv);
  float* const cold = reinterpret_cast<float*>(smem + L::cold);
  float* const dvp = reinterpret_cast<float*>(smem + L::dvp);
  float* const rcv = reinterpret_cast<float*>(smem + L::rcv);
  float* const rcv_bon = reinterpret_cast<float*>(smem + L::rcv_bon);
  float* const gr = reinterpret_cast<float*>(smem + L::g);
  float* const gk = gr + kStage * kRows;
  float* const vd = reinterpret_cast<float*>(smem + L::vd);
  float* const us = reinterpret_cast<float*>(smem + L::us);
  float* const dup = reinterpret_cast<float*>(smem + L::dup);
  const float4* const colv4 = reinterpret_cast<const float4*>(colv);
  const float4* const cold4 = reinterpret_cast<const float4*>(cold);

  // an item's batch, head and stage, stepped by the cluster count
  // without dividing
  struct Cursor {
    int bi, hi, j;
  };
  const int step_j = ncl % nst, step_bh = ncl / nst;
  auto advance = [&](Cursor x) {
    x.j += step_j;
    int inc = step_bh;
    if (x.j >= nst) {
      x.j -= nst;
      ++inc;
    }
    x.hi += inc;
    while (x.hi >= h) {
      x.hi -= h;
      ++x.bi;
    }
    return x;
  };
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem + L::bars);
  // an item's rows into raw buffer `buf`: one thread's TMA boxes (past s
  // or d they fill with zeros) completing on the buffer's mbarrier, or
  // element by element
  auto issue = [&](Cursor x, int buf) {
    const int bi = x.bi, hi = x.hi, t0 = x.j * kStage;
    unsigned char* rb = smem + buf * L::raw;
    if (tma) {     // lane 0 of warps 0-5 a copy each; warp 0 arrives
      if (lane == 0 && warp < 6) {
        uint64_t* bar = bars + buf;
        const int row = bi * s + t0;
        constexpr int kTx = static_cast<int>(L::raw_u);
        switch (warp) {
          case 0:
            mbar_expect_tx(bar, kTx + nrow * 4);
            tma_load(rb, &maps.r, c0, hi, row, bar);
            break;
          case 1:
            tma_load(rb + L::raw_k, &maps.k, c0, hi, row, bar);
            break;
          case 2:
            tma_load(rb + L::raw_w, &maps.w, c0, hi, row, bar);
            break;
          case 3:
            tma_load(rb + L::raw_v, &maps.v, 0, hi, row, bar);
            break;
          case 4:
            tma_load(rb + L::raw_d, &maps.d, 0, hi, row, bar);
            break;
          default:
            bulk_load(rb + L::raw_u, u + hi * d + c0, nrow * 4, bar);
        }
      }
    } else {
      const int n = s - t0 < kStage ? s - t0 : kStage;
      const size_t base = (static_cast<size_t>(bi) * s + t0) * step +
                          static_cast<size_t>(hi) * d;
      T* const rb_t = reinterpret_cast<T*>(rb);
      copy_rows<kThreads>(rb_t, r + base + c0, step, n, nrow, kRows, tid);
      copy_rows<kThreads>(reinterpret_cast<T*>(rb + L::raw_k), k + base + c0,
                          step, n, nrow, kRows, tid);
      copy_rows<kThreads>(reinterpret_cast<TW*>(rb + L::raw_w),
                          w + base + c0, step, n, nrow, kRows, tid);
      copy_rows<kThreads>(reinterpret_cast<T*>(rb + L::raw_v), v + base, step,
                          n, d, kD, tid);
      copy_rows<kThreads>(reinterpret_cast<T*>(rb + L::raw_d), dout + base,
                          step, n, d, kD, tid);
      copy_rows<kThreads>(reinterpret_cast<float*>(rb + L::raw_u),
                          u + hi * d + c0, 0, 1, nrow, kRows, tid);
    }
  };
  auto checkpoints = [&](int item, float4& f, float4& b) {
    const size_t o = static_cast<size_t>(item) * kD * kD +
                     static_cast<size_t>(c) * kD + 4 * q;
    f = __ldg(reinterpret_cast<const float4*>(ck_f + o));
    b = __ldg(reinterpret_cast<const float4*>(ck_b + o));
  };

  // dv's partial of a (token, quarter row) unit U goes to block U % nq,
  // slot U / nq there; rbar[2] counts the bytes a stage's pushes bring
  uint64_t* const rbar = bars + 2;
  const int ru = (4 * kStage + nq - 1) / nq;
  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
    mbar_init(rbar, 1);
    mbar_init(rbar + 1, 1);
    fence_barrier_init();
  }
  cluster.sync();     // every block's mbarriers before the first push
  int item = blockIdx.x / nq;
  Cursor cur{item / nst / h, item / nst % h, item % nst};
  if (item < items) issue(cur, 0);
  for (int i = 0; item < items; ++i, item += ncl) {
    const int pb = i & 1;
    const Cursor next = advance(cur);
    if (item + ncl < items) issue(next, pb ^ 1);
    if (tma) mbar_wait(bars + pb, (i >> 1) & 1);
    __syncthreads();
    // the checkpoints: waited for only where the walks start
    float4 cf, cb;
    checkpoints(item, cf, cb);
    const int t0 = cur.j * kStage, n = s - t0 < kStage ? s - t0 : kStage;
    // this block's units of the stage (at least one: 4 n >= nq), each
    // pushed by every block of the cluster
    const int own = (4 * n - rank + nq - 1) / nq;
    if (tid == 0) mbar_expect_tx(rbar + pb, nq * own * (16 * 4 + 4));
    const size_t base = (static_cast<size_t>(cur.bi) * s + t0) * step +
                        static_cast<size_t>(cur.hi) * d;

    // the stage's rows and columns in fp32, w clamped; zeros past d, and
    // past n tokens that leave S and dS as they are (w 1, r k v dout 0),
    // so that the walks below take all kStage tokens unguarded
    {
      const unsigned char* rb = smem + pb * L::raw;
      const T* rr = reinterpret_cast<const T*>(rb);
      const T* rk = reinterpret_cast<const T*>(rb + L::raw_k);
      const TW* rw = reinterpret_cast<const TW*>(rb + L::raw_w);
      const T* rv = reinterpret_cast<const T*>(rb + L::raw_v);
      const T* rd = reinterpret_cast<const T*>(rb + L::raw_d);
      for (int idx = tid; idx < kStage * kRows; idx += kThreads) {
        const bool in = idx / kRows < n, ok = in && idx % kRows < nrow;
        const float xr = ok ? qf::to_f32(rr[idx]) : 0.f;
        const float xk = ok ? qf::to_f32(rk[idx]) : 0.f;
        const float xw = ok ? qf::to_f32(rw[idx]) : 0.f;
        rowf[idx] = make_float4(xr, xk, in ? clamp_w(xw) : 1.f, xw);
      }
      if (d == kD) {
        float xv[8];
        for (int idx = 8 * tid; idx < kStage * kD; idx += 8 * kThreads) {
          if (idx / kD < n) {
            load8(rv + idx, xv);
            store8(colv + idx, xv);
            load8(rd + idx, xv);
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) xv[j] = 0.f;
            store8(colv + idx, xv);
          }
          store8(cold + idx, xv);
        }
      } else {
#pragma unroll 1
        for (int idx = tid; idx < kStage * kD; idx += kThreads) {
          const bool ok = idx / kD < n && idx % kD < d;
          colv[idx] = ok ? qf::to_f32(rv[idx]) : 0.f;
          cold[idx] = ok ? qf::to_f32(rd[idx]) : 0.f;
        }
      }
      if (tid < kRows)
        us[tid] = tid < nrow
                      ? reinterpret_cast<const float*>(rb + L::raw_u)[tid]
                      : 0.f;
    }
    __syncthreads();

    // the stage's states S_{t-1}, from its checkpoint, each written once
    float hist[kStage][4];
    hist[0][0] = cf.x; hist[0][1] = cf.y; hist[0][2] = cf.z;
    hist[0][3] = cf.w;
#pragma unroll
    for (int t = 0; t + 1 < kStage; ++t) {
      const float4 rw = rowf[t * kRows + cl];
      const float4 vv = colv4[t * (kD / 4) + q];
      hist[t + 1][0] = fmaf(rw.z, hist[t][0], rw.y * vv.x);
      hist[t + 1][1] = fmaf(rw.z, hist[t][1], rw.y * vv.y);
      hist[t + 1][2] = fmaf(rw.z, hist[t][2], rw.y * vv.z);
      hist[t + 1][3] = fmaf(rw.z, hist[t][3], rw.y * vv.w);
    }
    // the tokens in reverse: per-thread partials of dr, dk, dw a token,
    // reduced over the row's lanes a group of four tokens at a time; dv's
    // partial over the warp's two rows
    float dS[4] = {cb.x, cb.y, cb.z, cb.w};
    float part[3][4], acc[4][3];
    const bool hi16 = lane >= 16;
#pragma unroll
    for (int t = kStage - 1; t >= 0; --t) {
      const float4 rw = rowf[t * kRows + cl];
      const float4 vq = colv4[t * (kD / 4) + q];
      const float4 dq = cold4[t * (kD / 4) + q];
      const float vv[4] = {vq.x, vq.y, vq.z, vq.w};
      const float dd[4] = {dq.x, dq.y, dq.z, dq.w};
      float a = 0.f, b = 0.f, g = 0.f, pv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a = fmaf(hist[t][j], dd[j], a);
        b = fmaf(dS[j], vv[j], b);
        g = fmaf(dS[j], hist[t][j], g);
        pv[j] = dS[j] * rw.y;
        dS[j] = fmaf(rw.z, dS[j], rw.x * dd[j]);
      }
      part[0][t & 3] = a;
      part[1][t & 3] = b;
      part[2][t & 3] = g;
      // lanes 0-15 end with columns 4q, 4q + 1 of both rows, 16-31 with
      // 4q + 2, 4q + 3
      const float x0 = (hi16 ? pv[2] : pv[0]) +
                       __shfl_xor_sync(kFull, hi16 ? pv[0] : pv[2], 16);
      const float x1 = (hi16 ? pv[3] : pv[1]) +
                       __shfl_xor_sync(kFull, hi16 ? pv[1] : pv[3], 16);
      reinterpret_cast<float2*>(dvp + (t * kWarps + warp) * kD + 4 * q)[hi16] =
          make_float2(x0, x1);
      if ((t & 3) == 0) scatter4(part, q, acc[t >> 2]);
    }
    // the row's sums, one token a lane
    {
      float sum[3];
      scatter_groups(acc, q, sum);
      const int tq = lane_token(q);
      if (tq < n) {
        gr[tq * kRows + cl] = sum[0];
        gk[tq * kRows + cl] = sum[1];
        float4* const row = rowf + tq * kRows + cl;   // raw w -> dw
        row->w = row->w >= kWFloor ? sum[2] : 0.f;
      }
    }
    __syncthreads();
    // thread (t, e4) of 16 x 16: v . dout and the bonus's partial sum_c u
    // r k over the block's rows (row e4), the token's 16 lanes by
    // butterfly; du's terms r k (v . dout) of row e4, the warp's two
    // tokens summed; dv's partial over the block's rows at token t,
    // columns 4 e4.., its warps summed pairwise, and the bonus's partial,
    // pushed to the unit's block
    float du_acc;
    {
      const int t = tid >> 4, e4 = tid & 15;
      const float4 vq = colv4[t * (kD / 4) + e4];
      const float4 dq = cold4[t * (kD / 4) + e4];
      const float4 rw = rowf[t * kRows + e4];
      float x = fmaf(vq.w, dq.w, fmaf(vq.z, dq.z, fmaf(vq.y, dq.y,
                                                      vq.x * dq.x)));
      float bon = us[e4] * rw.x * rw.y;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        x += __shfl_xor_sync(kFull, x, off);
        bon += __shfl_xor_sync(kFull, bon, off);
      }
      du_acc = rw.x * rw.y * x;
      du_acc += __shfl_xor_sync(kFull, du_acc, 16);
      if (t < n) {
        if (e4 == 0) vd[t] = x;
        const float4* src = reinterpret_cast<const float4*>(dvp);
        float4 y[kWarps];
#pragma unroll
        for (int ww = 0; ww < kWarps; ++ww)
          y[ww] = src[(t * kWarps + ww) * (kD / 4) + e4];
#pragma unroll
        for (int span = 1; span < kWarps; span *= 2)
#pragma unroll
          for (int ww = 0; ww < kWarps; ww += 2 * span) {
            y[ww].x += y[ww + span].x; y[ww].y += y[ww + span].y;
            y[ww].z += y[ww + span].z; y[ww].w += y[ww + span].w;
          }
        const int unit = 4 * t + e4 / 4, owner = unit % nq;
        const int slot = (pb * nq + rank) * ru + unit / nq;
        const uint32_t bar = peer_addr(rbar + pb, owner);
        push4(peer_addr(rcv + slot * 16 + 4 * (e4 % 4), owner), y[0], bar);
        if (e4 % 4 == 0) push1(peer_addr(rcv_bon + slot, owner), bon, bar);
      }
    }
    if (lane < kRows) dup[warp * kRows + lane] = du_acc;
    __syncthreads();

    // dr, dk, dw of the block's rows; du's partial over the stage's tokens
    for (int idx = tid; idx < n * kRows; idx += kThreads) {
      const int t = idx / kRows, cc = idx % kRows;
      if (cc < nrow) {
        const size_t o = base + static_cast<size_t>(t) * step + c0 + cc;
        const float4 rw = rowf[idx];
        const float uv = us[cc] * vd[t];
        dr[o] = qf::from_f32<T>(fmaf(uv, rw.y, gr[idx]));
        dk[o] = qf::from_f32<T>(fmaf(uv, rw.x, gk[idx]));
        dw[o] = qf::from_f32<TW>(rw.w);
      }
    }
    if (tid < nrow) {
      float acc = dup[tid];
#pragma unroll
      for (int ww = 1; ww < kWarps; ++ww) acc += dup[ww * kRows + tid];
      du_part[static_cast<size_t>(item) * kD + c0 + tid] = acc;
    }

    // dv of this block's units: the cluster's partials and the bonus's
    // summed pairwise in rank order, then the bonus term
    mbar_wait_cluster(rbar + pb, (i >> 1) & 1);
    for (int idx = tid; idx < own * 16; idx += kThreads) {
      const int slot = idx / 16, f = idx % 16, unit = slot * nq + rank;
      const int t = unit / 4, e = 16 * (unit % 4) + f;
      float x[4], b[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int at = (pb * nq + (p < nq ? p : 0)) * ru + slot;
        x[p] = p < nq ? rcv[at * 16 + f] : 0.f;
        b[p] = p < nq ? rcv_bon[at] : 0.f;
      }
      const float acc = pair_sum(x, nq), bon = pair_sum(b, nq);
      const float out = fmaf(bon, cold[t * kD + e], acc);
      if (e < d)
        dv[base + static_cast<size_t>(t) * step + e] = qf::from_f32<T>(out);
    }
    cur = next;
  }
  cluster.sync();     // no block leaves while another may push to it
}

// ---- 3. du[h, c]: kRuns runs of consecutive (b, stage) partials, each
// summed in order, then the runs in order
__global__ void gla_bwd_du(const float* __restrict__ du_part,
                           float* __restrict__ du, int bsz, int h, int d,
                           int nst) {
  __shared__ float runs[kRuns][kD];
  const int hh = blockIdx.x, g = threadIdx.x / kD, c = threadIdx.x % kD;
  const int total = bsz * nst, len = (total + kRuns - 1) / kRuns;
  const int end = (g + 1) * len < total ? (g + 1) * len : total;
  float acc = 0.f;
  if (c < d) {
    for (int i = g * len; i < end; ++i) {
      const int b = i / nst, j = i % nst;
      acc += du_part[((static_cast<size_t>(b) * h + hh) * nst + j) * kD + c];
    }
  }
  runs[g][c] = acc;
  __syncthreads();
  if (g == 0 && c < d) {
    float sum = 0.f;
#pragma unroll
    for (int gg = 0; gg < kRuns; ++gg) sum += runs[gg][c];
    du[hh * d + c] = sum;
  }
}

// the operands' rows go by TMA (16-byte aligned pointers and rows, u's
// too for its bulk copy), else element by element
bool takes_tma(const void* r, const void* k, const void* v, const void* w,
               const void* u, const void* dout, int d, size_t t_size,
               size_t w_size) {
  const auto addr = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p);
  };
  return (addr(r) | addr(k) | addr(v) | addr(w) | addr(dout) | addr(u)) %
                 16 == 0 &&
         (d * t_size) % 16 == 0 && (d * w_size) % 16 == 0 && d % 4 == 0;
}

template <typename T, typename TW>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* dout, const void* dstate, void* dr,
           void* dk, void* dv, void* dw, void* du, void* ck_f, void* ck_b,
           void* du_part, int bsz, int s, int h, int d, void* stream) {
  const auto cs = static_cast<cudaStream_t>(stream);
  const bool bf = sizeof(T) == 2, wbf = sizeof(TW) == 2;
  const long long tokens = static_cast<long long>(bsz) * s;
  ScanMaps sm{};
  StageMaps tm{};
  const bool tma = takes_tma(r, k, v, w, u, dout, d, sizeof(T), sizeof(TW));
  if (tma &&
      !(rows_map(&sm.a[0], k, bf, tokens, h, d, kScanRows, kChunk) &&
        rows_map(&sm.a[1], r, bf, tokens, h, d, kScanRows, kChunk) &&
        rows_map(&sm.w, w, wbf, tokens, h, d, kScanRows, kChunk) &&
        rows_map(&sm.x[0], v, bf, tokens, h, d, kD, kChunk) &&
        rows_map(&sm.x[1], dout, bf, tokens, h, d, kD, kChunk) &&
        rows_map(&tm.r, r, bf, tokens, h, d, kRows, kStage) &&
        rows_map(&tm.k, k, bf, tokens, h, d, kRows, kStage) &&
        rows_map(&tm.w, w, wbf, tokens, h, d, kRows, kStage) &&
        rows_map(&tm.v, v, bf, tokens, h, d, kD, kStage) &&
        rows_map(&tm.d, dout, bf, tokens, h, d, kD, kStage)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nst = (s + kStage - 1) / kStage;

  const int nhalf = (d + kScanRows - 1) / kScanRows;
  const size_t scan_smem = ScanSmem<T, TW>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      gla_bwd_scan<T, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(scan_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gla_bwd_scan<T, TW><<<static_cast<unsigned>(bsz * h * 2 * nhalf),
                        kScanThreads, scan_smem, cs>>>(
      sm, static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TW*>(w),
      static_cast<const T*>(dout), static_cast<const float*>(dstate),
      static_cast<float*>(ck_f), static_cast<float*>(ck_b), s, h, d, tma);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = StageSmem<T, TW>::bytes;
  err = cudaFuncSetAttribute(gla_bwd_stage<T, TW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nq = (d + kRows - 1) / kRows;
  const long long items = static_cast<long long>(bsz) * h * nst;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nq;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nq);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = cs;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, gla_bwd_stage<T, TW>, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (clusters > items) clusters = static_cast<int>(items);
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * nq));
  err = cudaLaunchKernelEx(
      &cfg, gla_bwd_stage<T, TW>, tm, static_cast<const T*>(r),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const TW*>(w), static_cast<const float*>(u),
      static_cast<const T*>(dout), static_cast<const float*>(ck_f),
      static_cast<const float*>(ck_b), static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<TW*>(dw),
      static_cast<float*>(du_part), s, h, d, static_cast<int>(items), tma);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  gla_bwd_du<<<static_cast<unsigned>(h), kRuns * kD, 0, cs>>>(
      static_cast<const float*>(du_part), static_cast<float*>(du), bsz, h, d,
      nst);
  return static_cast<int>(cudaGetLastError());
}

size_t dtype_size(int dtype) { return dtype == qf::kFloat32 ? 4 : 2; }

}  // namespace

// Floats of the three fp32 workspaces the wrapper allocates: the state
// before each stage and dS after each stage's last token ([b, h][stage]
// [64][64] each; parts 0 and 1), du's partial a (b, h, stage) (part 2).
extern "C" long long qf_gla_chunked_bwd_workspace(int bsz, int s, int h,
                                                  int part) {
  const long long per =
      static_cast<long long>(bsz) * h * ((s + kStage - 1) / kStage);
  return part < 2 ? per * kD * kD : per * kD;
}

// 1 if qf_gla_chunked_bwd copies these operands' rows by TMA, 0 if
// element by element: the choice depends on nothing else
extern "C" int qf_gla_chunked_bwd_tma(const void* r, const void* k,
                                      const void* v, const void* w,
                                      const void* u, const void* dout, int d,
                                      int dtype, int w_dtype) {
  return takes_tma(r, k, v, w, u, dout, d, dtype_size(dtype),
                   dtype_size(w_dtype))
             ? 1
             : 0;
}

// r, k, v, dout, dr, dk, dv (B, S, H, d) in `dtype`; w, dw (B, S, H, d) in
// `w_dtype`; u, du (H, d) fp32; dstate (B, H, d, d) fp32 or null (zero);
// the workspaces as qf_gla_chunked_bwd_workspace sizes them. 1 <= d <= 64.
extern "C" int qf_gla_chunked_bwd(const void* r, const void* k, const void* v,
                                  const void* w, const void* u,
                                  const void* dout, const void* dstate,
                                  void* dr, void* dk, void* dv, void* dw,
                                  void* du, void* ck_f, void* ck_b,
                                  void* du_part, int bsz, int s, int h, int d,
                                  int dtype, int w_dtype, void* stream) {
  if (bsz <= 0 || s <= 0 || h <= 0 || d <= 0 || d > kD ||
      static_cast<long long>(bsz) * h * 2 * ((d + kScanRows - 1) / kScanRows) >
          0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool f32 = dtype == qf::kFloat32, wf32 = w_dtype == qf::kFloat32;
  if ((!f32 && dtype != qf::kBFloat16) || (!wf32 && w_dtype != qf::kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (f32)
    return wf32 ? launch<float, float>(r, k, v, w, u, dout, dstate, dr, dk,
                                       dv, dw, du, ck_f, ck_b, du_part, bsz,
                                       s, h, d, stream)
                : launch<float, __nv_bfloat16>(r, k, v, w, u, dout, dstate,
                                               dr, dk, dv, dw, du, ck_f, ck_b,
                                               du_part, bsz, s, h, d, stream);
  return wf32 ? launch<__nv_bfloat16, float>(r, k, v, w, u, dout, dstate, dr,
                                             dk, dv, dw, du, ck_f, ck_b,
                                             du_part, bsz, s, h, d, stream)
              : launch<__nv_bfloat16, __nv_bfloat16>(
                    r, k, v, w, u, dout, dstate, dr, dk, dv, dw, du, ck_f,
                    ck_b, du_part, bsz, s, h, d, stream);
}
