// Causal / sliding-window flash attention with grouped-query heads, bf16
// storage, on Hopper's tensor cores (wgmma), fp32 function.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel), the Pallas TPU kernel that upcasts q, k and v to fp32
// and takes both dots with fp32 accumulation, streaming 128-key blocks
// along its sequential grid axis with the running max, sum and output
// rows in VMEM scratch. fp32 storage stays on the CUDA-core kernel in
// flash_attention.cu, which also holds the C entry point that picks one
// of the two by dtype.
//
// Semantics are those of repro.kernels.ref.attention_ref: q (BH, Sq, D),
// k/v (BH / G, Sk, D) with query head bh reading kv head bh / G; query i
// and key j (positions from 0) pair when j < Sk, j <= i (causal) and
// j > i - window (window > 0); scores scaled by 1/sqrt(D) after the dot;
// online softmax in fp32; a row with no allowed key writes 0; D is 64,
// 128 or 256; out in bf16.
//
// What bounds it on an H100: operations. At the RecurrentGemma-2B
// prefill shape (B*H = 40, S = 4096, D = 256, window 2048) the allowed
// pairs need 258 GFLOP against 185 MB of q, k, v and out: 0.26 ms on the
// bf16 tensor cores (989 TFLOP/s), against 3.9 ms at best on the fp32
// CUDA cores (67 TFLOP/s).
//
// Why the tensor cores keep the fp32 function:
// - S = Q K^T: a product of two bf16 values is exact in fp32, so a bf16
//   wgmma with an fp32 accumulator gives the fp32 dot of the upcast
//   inputs; only the order of the sums differs.
// - O += P V: P is fp32 and does not fit a bf16 operand. It is split as
//   P = P_hi + P_lo with P_hi = bf16(P) and P_lo = bf16(P - P_hi), and
//   P V = P_hi V + P_lo V runs as two bf16 wgmmas into the fp32 O. That
//   keeps 16 significand bits of P (relative error about 2^-17, against
//   2^-24 for the fp32 dot and 2^-8 for the bf16 output rounding).
//   Rounding P to bf16 alone, as SDPA does, would change the function.
//   The split costs 1.5x the tensor-core work of the function.
//
// Design: one block of three warpgroups per (128 query rows, head).
// - Warpgroups 0 and 1 consume: each owns 64 query rows, keeps S (64 x
//   64) and O (64 x D) in fp32 registers for the whole walk over key
//   tiles of 64 (O is 128 registers a thread at D = 256, so setmaxnreg
//   moves registers from the producer: 240 a consumer thread, 24 a
//   producer thread). The mask, the running max and sum, the rescale of
//   O and the split stay in registers. S = Q K^T is a chain of
//   m64n64k16 wgmmas with Q and K read from shared memory; P_hi V and
//   P_lo V are m64nDk16 wgmmas with P in registers (the accumulator's
//   layout is the A operand's) and V from shared memory.
// - Warpgroup 2 produces: one thread loads Q (128 x D, once) and keeps
//   the K/V ring (2 stages of 64 x D bf16 K and V tiles at D = 256, 3
//   below) filled with TMA, on mbarriers. Every tile is 64-column panels
//   of 128-byte rows in the 128-byte swizzle that TMA writes and that
//   wgmma's descriptors read: K-major for Q and K, MN-major for V.
//   Shared memory at D = 256: Q 64 KB + ring 128 KB.
// - Ragged ends (S not a multiple of the tile, Sq != Sk) are never
//   padded in device memory: the 3-D tensor maps (D, S, head) fill rows
//   past the end of each head with zeros, and the mask drops them.
// - Key tiles wholly above the diagonal or outside the window of every
//   row of the block are never loaded; a warpgroup skips the tiles none
//   of its rows needs, and only tiles that cut the diagonal, the
//   window's edge or Sk are masked element by element. Query blocks run
//   last-first (the ones with the most key tiles start first) and the
//   heads that share a kv head run side by side, so K/V tiles hit L2.
#include <cuda.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 128;            // query rows per block (two warpgroups)
constexpr int kBK = 64;             // keys per tile
constexpr int kThreads = 384;       // consumers 0-255, producer 256-383
constexpr int kPanel = 64;          // bf16 columns in a 128-byte row
constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Shape {
  static constexpr int kPanels = D / kPanel;
  static constexpr int kStages = D == 256 ? 2 : 3;
  static constexpr int kQBytes = kBQ * D * 2;           // [panel][128][64]
  static constexpr int kTileBytes = kBK * D * 2;        // [panel][64][64]
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kTileBytes;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// One box of a 3-D tensor map (column, row, head) into shared memory,
// completing on ``bar``.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int col, int row, int head,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col),
      "r"(row), "r"(head) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all in 16-byte units).
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo_bytes,
                                              int sbo_bytes) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// S (64 x 64, fp32) (+)= A (64 x 16) B^T, A and B bf16 K-major in shared
// memory (128-byte swizzle); scale_d 0 starts the sum.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x 64, fp32) += A (64 x 16, bf16 in registers) B, B bf16
// MN-major in shared memory (128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 128, fp32) += A (64 x 16, bf16 in registers) B, B bf16
// MN-major in shared memory (128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 256, fp32) += A (64 x 16, bf16 in registers) B, B bf16
// MN-major in shared memory (128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64) {
    wgmma_rs_n64(o, a, db);
  } else if constexpr (D == 128) {
    wgmma_rs_n128(o, a, db);
  } else {
    wgmma_rs_n256(o, a, db);
  }
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Key tiles [lo, hi] holding an allowed key for some row in [r0, r1].
__device__ __forceinline__ void tile_range(int r0, int r1, int sk, int causal,
                                           int window, int& lo, int& hi) {
  const int k_hi = causal ? min(sk - 1, r1) : sk - 1;
  const int k_lo = window > 0 ? max(0, r0 - window + 1) : 0;
  lo = k_lo / kBK;
  hi = k_hi >= k_lo ? k_hi / kBK : lo - 1;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ out, int group, int sq, int sk,
                   int causal, int window) {
  using Sh = Shape<D>;
  constexpr int kStages = Sh::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  __shared__ __align__(8) uint64_t q_bar;
  // the 128-byte swizzle repeats every 1024 bytes of shared address
  uint8_t* q_s = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = q_s + Sh::kQBytes;                  // [stage][panel][64][64]
  uint8_t* v_s = k_s + kStages * Sh::kTileBytes;

  const int bh = blockIdx.x;                         // heads of a kv head adjacent
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ; // most key tiles first
  int t_lo, t_hi;
  tile_range(q0, min(q0 + kBQ, sq) - 1, sk, causal, window, t_lo, t_hi);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 256);
    }
    mbar_init(&q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: Q once, then the K/V ring, one thread issuing TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(&q_bar, Sh::kQBytes);
#pragma unroll
      for (int p = 0; p < Sh::kPanels; ++p)
        tma_load(q_s + p * kBQ * 128, &tm_q, p * kPanel, q0, bh, &q_bar);
      const int kvh = bh / group;
      for (int t = t_lo, i = 0; t <= t_hi; ++t, ++i) {
        const int s = i % kStages;
        mbar_wait(&empty_bar[s], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full_bar[s], 2 * Sh::kTileBytes);
        uint8_t* kt = k_s + s * Sh::kTileBytes;
        uint8_t* vt = v_s + s * Sh::kTileBytes;
#pragma unroll
        for (int p = 0; p < Sh::kPanels; ++p) {
          tma_load(kt + p * kBK * 128, &tm_k, p * kPanel, t * kBK, kvh,
                   &full_bar[s]);
          tma_load(vt + p * kBK * 128, &tm_v, p * kPanel, t * kBK, kvh,
                   &full_bar[s]);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int r_lo = q0 + wg * 64;
    const int row0 = r_lo + warp * 16 + lane / 4;    // rows row0, row0 + 8
    const int col0 = 2 * (lane % 4);                 // of each 8-column chunk
    const float sl2 = kLog2e / sqrtf(static_cast<float>(D));
    int w_lo = 1, w_hi = 0;                          // this warpgroup's tiles
    if (r_lo < sq)
      tile_range(r_lo, min(r_lo + 63, sq - 1), sk, causal, window, w_lo, w_hi);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    const uint64_t dq = smem_desc(q_s + wg * 64 * 128, 16, 1024);
    mbar_wait(&q_bar, 0);

    for (int t = t_lo, i = 0; t <= t_hi; ++t, ++i) {
      const int s = i % kStages;
      mbar_wait(&full_bar[s], (i / kStages) & 1);
      if (t >= w_lo && t <= w_hi) {
        const int k0 = t * kBK;
        const uint8_t* kt = k_s + s * Sh::kTileBytes;
        const uint8_t* vt = v_s + s * Sh::kTileBytes;

        // S = Q K^T, fp32 accumulation of exact bf16 products
        float sc[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) sc[j] = 0.f;
        const uint64_t dk = smem_desc(kt, 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int panel = kk / 4, step = (kk % 4) * 32;
          wgmma_ss_n64(sc, dq + ((panel * kBQ * 128 + step) >> 4),
                       dk + ((panel * kBK * 128 + step) >> 4), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // mask (only tiles that cut the diagonal, the window or Sk), then
        // the online softmax in the log2 domain
        const bool whole = k0 + kBK <= sk &&
                           (!causal || k0 + kBK - 1 <= r_lo) &&
                           (window <= 0 || k0 > r_lo + 63 - window);
        uint32_t ok = 0xffffffffu;
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int idx = 4 * j + 2 * h + e;
              float x = sc[idx] * sl2;
              if (!whole) {
                const int col = k0 + 8 * j + col0 + e, row = row0 + 8 * h;
                if (!(col < sk && (!causal || col <= row) &&
                      (window <= 0 || col > row - window))) {
                  ok &= ~(1u << idx);
                  x = kNegInf;
                }
              }
              sc[idx] = x;
              mx[h] = fmaxf(mx[h], x);
            }
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(m[h], mx[h]);
          alpha[h] = exp2f(m[h] - m_new);
          m[h] = m_new;
          l[h] *= alpha[h];
        }
#pragma unroll
        for (int idx = 0; idx < 32; ++idx) {
          const int h = (idx / 2) % 2;
          const float p = (ok >> idx) & 1u ? exp2f(sc[idx] - m[h]) : 0.f;
          sc[idx] = p;
          l[h] += p;
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];

        // P = P_hi + P_lo, both bf16, in the A-operand layout: register r
        // of k-step t4 holds chunk 2 t4 + r / 2, row half r % 2
        uint32_t hi[4][4], lo[4][4];
#pragma unroll
        for (int t4 = 0; t4 < 4; ++t4)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int idx = 4 * (2 * t4 + r / 2) + 2 * (r % 2);
            const __nv_bfloat162 b = __floats2bfloat162_rn(sc[idx], sc[idx + 1]);
            hi[t4][r] = bf16x2_bits(b);
            lo[t4][r] = bf16x2_bits(__floats2bfloat162_rn(
                sc[idx] - __low2float(b), sc[idx + 1] - __high2float(b)));
          }

        // O += P_hi V + P_lo V; V MN-major: panels 64 keys x 128 bytes apart
        const uint64_t dv = smem_desc(vt, kBK * 128, 1024);
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int t4 = 0; t4 < 4; ++t4) {
          const uint64_t dvt = dv + ((t4 * 16 * 128) >> 4);
          wgmma_pv<D>(o, hi[t4], dvt);
          wgmma_pv<D>(o, lo[t4], dvt);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
      }
      mbar_arrive(&empty_bar[s]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int row = row0 + 8 * h;
      if (row >= sq) continue;
      const float denom = fmaxf(l[h], 1e-30f);
      __nv_bfloat16* orow = out + (static_cast<size_t>(bh) * sq + row) * D;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c + col0) =
            __floats2bfloat162_rn(o[4 * c + 2 * h] / denom,
                                  o[4 * c + 2 * h + 1] / denom);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no
// link against the driver
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (heads, s, d) bf16 as a 3-D map of 64-column x ``rows`` boxes in the
// 128-byte swizzle; reads past s in a head fill with zeros
bool make_map(CUtensorMap* map, const void* ptr, int heads, int s, int d,
              int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(s) * d * 2};
  const cuuint32_t box[3] = {kPanel, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int bk, int sq, int sk, int causal, int window, void* stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, bh, sq, D, kBQ) || !make_map(&mk, k, bk, sk, D, kBK) ||
      !make_map(&mv, v, bk, sk, D, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Shape<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (sq + kBQ - 1) / kBQ);
  flash_wgmma_kernel<D><<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), bh / bk, sq, sk, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace qf {

// bf16 q (bh, sq, dh), k/v (bk, sk, dh), bh a multiple of bk; the C entry
// point qf_flash_attention (flash_attention.cu) checks the counts.
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int bh, int bk, int sq, int sk, int dh,
                         int causal, int window, void* stream) {
  const void* ptrs[4] = {q, k, v, out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16)    // TMA's alignment
      return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 64:
      return launch<64>(q, k, v, out, bh, bk, sq, sk, causal, window, stream);
    case 128:
      return launch<128>(q, k, v, out, bh, bk, sq, sk, causal, window, stream);
    case 256:
      return launch<256>(q, k, v, out, bh, bk, sq, sk, causal, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace qf
