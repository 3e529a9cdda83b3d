// Fused ensemble commutator trace (the Prop.-1 trace of QuanFedNode):
//
//   T[j] = sum_n tr_rest(A_{j,n} B_{j,n}),  A = sum_e a_e a_e^H,
//                                           B = sum_f b_f b_f^H,
//
// on keep-major ensembles a: (J, N, Ea, K), b: (J, N, Eb, K) with
// K = dk * dr (row index k = alpha * dr + r); T: (J, dk, dk). Complex128
// storage, fp32 math.
//
// Replaces: src/repro/kernels/zgemm.py::ensemble_commutator_trace
// (_ect_kernel), the Pallas TPU kernel that keeps one whole (E, K)
// operand pair of a (j, n) cell in VMEM and accumulates over n on the
// sequential minor grid axis.
//
// What bounds it on an H100: reading the larger ensemble. At widths
// (4,5,4), layer 1, a is (512, 512) complex128 per (j, n): 4 MB, against
// ~0.5 MFLOP of useful work per pass, so the kernel is bound by bytes.
// One operand does not fit in a block's 227 KB of shared memory.
//
// Design: one block per j (node x perceptron folded into J by the
// caller), looping over n inside the block, so the sum over n is
// deterministic and needs no atomics. Per (j, n) three staged passes:
//   1. G = conj(a) b^T, (Ea, Eb): one warp per entry, lanes striding K so
//      both rows are read coalesced from device memory; G lives in
//      shared memory.
//   2. per K tile of `ta` keep rows (tile width ta * dr):
//      W = G^T a restricted to the tile, (Eb, ta * dr), in shared memory;
//      neighbouring threads read neighbouring k, so the loads coalesce.
//   3. the folded trace of that tile, T[alpha, beta] += sum_{f, r}
//      W[f, (alpha, r)] conj(b[f, (beta, r)]), accumulated in shared
//      memory; each (alpha, beta) entry of a tile has one owner thread.
//      b is staged into shared memory `fc` rows at a time (coalesced),
//      each keep row padded to dr + 1 so neighbouring beta fall in
//      different banks.
// The tile height `ta` and the b chunk `fc` are picked here to bound shared
// memory; a shape that still does not fit makes cudaFuncSetAttribute fail,
// and that error is returned to the caller.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kBChunkBytes = 32 * 1024;
constexpr size_t kWTileBytes = 64 * 1024;

__host__ __device__ inline int b_stride(int dk, int dr) { return dk * (dr + 1); }

__host__ __device__ inline int b_chunk(int eb, int dk, int dr) {
  const int fc = static_cast<int>(kBChunkBytes / (sizeof(float2) * b_stride(dk, dr)));
  return fc < 1 ? 1 : (fc > eb ? eb : fc);
}

// Keep rows per K tile: as many as let the (eb, ta * dr) slice of W fit
// in kWTileBytes.
inline int trace_tile(int eb, int dk, int dr) {
  const int ta = static_cast<int>(kWTileBytes / (sizeof(float2) * eb * dr));
  return ta < 1 ? 1 : (ta > dk ? dk : ta);
}

inline size_t smem_bytes(int ea, int eb, int dk, int dr, int ta) {
  return sizeof(float2) * (static_cast<size_t>(ea) * eb +
                           static_cast<size_t>(eb) * ta * dr +
                           static_cast<size_t>(dk) * dk +
                           static_cast<size_t>(b_chunk(eb, dk, dr)) * b_stride(dk, dr));
}

__global__ void __launch_bounds__(kThreads)
ect_kernel(const double2* __restrict__ a, const double2* __restrict__ b,
           double2* __restrict__ t_out, int n_ex, int ea, int eb, int dk,
           int dr, int ta) {
  extern __shared__ float2 smem[];
  const int k_len = dk * dr;
  const int tk = ta * dr;
  const int bst = b_stride(dk, dr);
  const int fc = b_chunk(eb, dk, dr);
  float2* g = smem;            // (ea, eb)
  float2* w = g + ea * eb;     // (eb, tk)
  float2* t = w + eb * tk;     // (dk, dk)
  float2* bs = t + dk * dk;    // (fc, dk, dr + 1)
  const int j = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < dk * dk; i += kThreads) t[i] = make_float2(0.f, 0.f);

  for (int nn = 0; nn < n_ex; ++nn) {
    const double2* ap = a + (static_cast<size_t>(j) * n_ex + nn) * ea * k_len;
    const double2* bp = b + (static_cast<size_t>(j) * n_ex + nn) * eb * k_len;
    __syncthreads();  // g is rewritten below; the previous n is done with it
    // 1. cross Gram G[e, f] = <a_e | b_f>
    for (int p = warp; p < ea * eb; p += kWarps) {
      const int e = p / eb, f = p - e * eb;
      const double2* ar = ap + static_cast<size_t>(e) * k_len;
      const double2* br = bp + static_cast<size_t>(f) * k_len;
      float gr = 0.f, gi = 0.f;
#pragma unroll 4
      for (int k = lane; k < k_len; k += 32) {
        const float2 x = qf::ld32(ar + k), y = qf::ld32(br + k);
        gr = fmaf(x.x, y.x, fmaf(x.y, y.y, gr));
        gi = fmaf(x.x, y.y, fmaf(-x.y, y.x, gi));
      }
      gr = qf::warp_sum(gr);
      gi = qf::warp_sum(gi);
      if (lane == 0) g[p] = make_float2(gr, gi);
    }
    __syncthreads();
    for (int a0 = 0; a0 < dk; a0 += ta) {
      const int na = min(ta, dk - a0);
      const int kw = na * dr;
      const int k0 = a0 * dr;
      // 2. W[f, kk] = sum_e G[e, f] a[e, k0 + kk]
      for (int p = tid; p < eb * kw; p += kThreads) {
        const int f = p / kw, kk = p - f * kw;
        float wr = 0.f, wi = 0.f;
        for (int e = 0; e < ea; ++e) {
          const float2 gg = g[e * eb + f];
          const float2 x = qf::ld32(ap + static_cast<size_t>(e) * k_len + k0 + kk);
          wr = fmaf(gg.x, x.x, fmaf(-gg.y, x.y, wr));
          wi = fmaf(gg.x, x.y, fmaf(gg.y, x.x, wi));
        }
        w[f * tk + kk] = make_float2(wr, wi);
      }
      // 3. T[a0 + al, beta] += sum_{f, r} W[f, (al, r)] conj(b[f, (beta, r)])
      for (int f0 = 0; f0 < eb; f0 += fc) {
        const int nf = min(fc, eb - f0);
        __syncthreads();  // w is complete; the previous chunk of bs is done
        for (int i = tid; i < nf * k_len; i += kThreads) {
          const int fl = i / k_len, k = i - fl * k_len;
          const int beta = k / dr, r = k - beta * dr;
          bs[fl * bst + beta * (dr + 1) + r] =
              qf::ld32(bp + static_cast<size_t>(f0 + fl) * k_len + k);
        }
        __syncthreads();
        for (int p = tid; p < na * dk; p += kThreads) {
          const int al = p / dk, beta = p - al * dk;
          float sr = 0.f, si = 0.f;
          for (int fl = 0; fl < nf; ++fl) {
            const float2* wr = w + (f0 + fl) * tk + al * dr;
            const float2* br = bs + fl * bst + beta * (dr + 1);
            for (int r = 0; r < dr; ++r) {
              const float2 x = wr[r], y = br[r];
              sr = fmaf(x.x, y.x, fmaf(x.y, y.y, sr));
              si = fmaf(x.y, y.x, fmaf(-x.x, y.y, si));
            }
          }
          float2& acc = t[(a0 + al) * dk + beta];
          acc.x += sr;
          acc.y += si;
        }
      }
      __syncthreads();  // w and bs are rewritten by the next tile
    }
  }
  __syncthreads();
  double2* tj = t_out + static_cast<size_t>(j) * dk * dk;
  for (int i = tid; i < dk * dk; i += kThreads) tj[i] = qf::to64(t[i]);
}

}  // namespace

extern "C" int qf_ect(const void* a, const void* b, void* t, int j, int n,
                      int ea, int eb, int dk, int dr, void* stream) {
  const int ta = trace_tile(eb, dk, dr);
  const size_t smem = smem_bytes(ea, eb, dk, dr, ta);
  cudaError_t err = cudaFuncSetAttribute(
      ect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ect_kernel<<<j, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(a), static_cast<const double2*>(b),
      static_cast<double2*>(t), n, ea, eb, dk, dr, ta);
  return static_cast<int>(cudaGetLastError());
}
