// Fused ensemble commutator trace (the Prop.-1 trace of QuanFedNode):
//
//   T[j] = sum_n tr_rest(A_{j,n} B_{j,n}),  A = sum_e a_e a_e^H,
//                                           B = sum_f b_f b_f^H,
//
// on keep-major ensembles a: (J, N, Ea, K), b: (J, N, Eb, K) with
// K = dk * dr (row index k = alpha * dr + r); T: (J, dk, dk). Complex128
// storage, fp32 math. Per (j, n), with G = conj(a) b^T (Ea, Eb) and
// W = G^T a (Eb, K):  T[alpha, beta] += sum_{f, r} W[f, (alpha, r)]
// conj(b[f, (beta, r)]).
//
// Replaces: src/repro/kernels/zgemm.py::ensemble_commutator_trace
// (_ect_kernel), the Pallas TPU kernel that keeps one whole (E, K)
// operand pair of a (j, n) cell in VMEM and accumulates over n on the
// sequential minor grid axis.
//
// What bounds it on an H100 depends on the shape. At widths (4,5,4) the
// layer-2 trace (a: 50 x 4 x (512, 512), b one row) reads 839 MB of a
// against ~0.5 MFLOP per (j, n): bytes. The layer-1 trace (a 32 rows, b
// 16 rows, dk 64) does ~1.3 GFLOP on 63 MB: operations, on the CUDA
// cores (fp32 math).
//
// Design, for those two shapes and everything between:
//   * W is a sum over e, and the folded trace is linear in W, so the rows
//     of a split across blocks without changing the function: each block
//     takes one (j, n), one range of a's rows and one chunk of b's rows,
//     and writes its partial trace. A second kernel sums the partials of
//     each j in a fixed order: no atomics, the output is bit-identical
//     from run to run. The plan (make_plan) splits the rows of a where a
//     is tall against dk (the fold each block repeats is then cheap), and
//     b's rows where the (j, n) grid alone would leave SMs idle (a is then
//     read once per chunk of b): at least two blocks per SM. The rows of
//     a split into the fewest ranges whose blocks fill the last wave (the
//     blocks the card holds at once, by the occupancy calculator) to 90%:
//     at S2, 2 blocks an SM, 5 ranges fill 95% of the 4th wave where 4
//     ranges leave the 4th nearly empty.
//   * a is read from device memory once: each tile of `te` rows is staged
//     in shared memory (16-byte loads, converted to fp32), and both the
//     tile's Gram G = conj(a_tile) b^T and its share of W += G^T a_tile are
//     formed from the staged rows. b's chunk and W stay in shared memory
//     for the whole block.
//   * Where a and b of one j are at most 128 KB (widths (2,3,2)), the
//     call is the host's, not the card's: the plan then gives each block
//     one j and all of its n in turn, and the block sums its n folds in
//     shared memory in the same order as the second kernel would and
//     writes T itself. One launch, no workspace, the same bits.
//   * Register tiles: the Gram runs one warp per (kGE x FR) tile of (e, f)
//     with the lanes striding K (conflict-free) and a butterfly sum; the W
//     step gives each lane FR rows of f at two columns; the fold gives each
//     thread kTA x kTB outputs, the alpha rows across the lanes. W is kept
//     with each keep row padded to dr + 1, so those lanes fall in
//     different banks; b's rows are read as broadcasts.
#include <mutex>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGE = 2;               // a rows per warp tile of the Gram
constexpr int kTA = 2, kTB = 8;      // fold outputs per thread (alpha x beta)
constexpr int kLoadBatch = 8;        // 16-byte loads in flight per thread
constexpr size_t kTileBytes = 32 * 1024;    // fp32 a rows staged per tile
constexpr int kMaxTileRows = 32;
constexpr int kMinFc = 4;            // b rows a chunk keeps, at least
constexpr int kMaxDevices = 64;
constexpr size_t kSerialBytes = 128 * 1024;  // a + b of one j, at most,
                                             // where one launch does it all
constexpr double kMinWaveFill = 0.9;  // share of the last wave of blocks
                                      // the row split aims to fill

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// b rows per register tile: 8 at the wide cell's layer-1 trace, 1 else
inline int fr_of(int fc) { return fc >= 8 ? 8 : 1; }

// fp32 (float2) elements of shared memory: b's chunk (fcp rows, zero past
// fc), W (fc padded rows), the a tile (tep rows), the tile's Gram and,
// where a block sums its own n, T (dk x dk).
inline size_t smem_bytes(int te, int fc, int k_len, int kp, int t_len) {
  const int fcp = round_up(fc, fr_of(fc)), tep = round_up(te, kGE);
  return sizeof(float2) * (static_cast<size_t>(fcp) * k_len +
                           static_cast<size_t>(fc) * kp +
                           static_cast<size_t>(tep) * k_len +
                           static_cast<size_t>(tep) * fcp + t_len);
}

struct Plan {
  int te;      // a rows per staged tile
  int fc;      // b rows per block (one chunk of f)
  int nfz;     // chunks of f (grid z)
  int split;   // row ranges of a per (j, n) (grid y)
  int rows;    // a rows per range, a multiple of te
  bool serial; // one block per j over all n, writing T: no second kernel
  size_t smem;
};

__device__ __forceinline__ float2 cmul(float2 x, float2 y, float2 acc) {
  acc.x = fmaf(x.x, y.x, fmaf(-x.y, y.y, acc.x));
  acc.y = fmaf(x.x, y.y, fmaf(x.y, y.x, acc.y));
  return acc;
}

__device__ __forceinline__ float2 cmul_conj_x(float2 x, float2 y, float2 acc) {
  acc.x = fmaf(x.x, y.x, fmaf(x.y, y.y, acc.x));     // conj(x) * y
  acc.y = fmaf(x.x, y.y, fmaf(-x.y, y.x, acc.y));
  return acc;
}

__device__ __forceinline__ float2 cmul_conj_y(float2 x, float2 y, float2 acc) {
  acc.x = fmaf(x.x, y.x, fmaf(x.y, y.y, acc.x));     // x * conj(y)
  acc.y = fmaf(x.y, y.x, fmaf(-x.x, y.y, acc.y));
  return acc;
}

__device__ __forceinline__ float allsum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows [0, count) of src (row length k_len, complex128) -> dst (fp32),
// then rows [count, padded) zero. kStream marks a, read once (streaming
// loads that do not stay in L1).
template <bool kStream>
__device__ __forceinline__ void stage_rows(float2* dst, const double2* src,
                                           int count, int padded, int k_len) {
  const int total = count * k_len;
  for (int base = 0; base < total; base += kThreads * kLoadBatch) {
    double2 v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      if (i < total) v[u] = kStream ? __ldcs(src + i) : __ldg(src + i);
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      if (i < total)
        dst[i] = make_float2(static_cast<float>(v[u].x), static_cast<float>(v[u].y));
    }
  }
  for (int i = total + threadIdx.x; i < padded * k_len; i += kThreads)
    dst[i] = make_float2(0.f, 0.f);
}

// One block: cells (j, n) = blockIdx.x * n_cells + c for c < n_cells, a
// rows [s * rows, ...) with s = blockIdx.y, b rows [z * fc, ...) with
// z = blockIdx.z. With n_cells = 1 it writes its partial trace,
// beta-major, to part[(blockIdx.x * split + s) * nfz + z]; with t_out
// set (the serial plan: n_cells = N, one j a block) it sums its cells'
// traces in order, as ect_reduce_kernel would, and writes T[j] itself.
template <int FR>
__global__ void __launch_bounds__(kThreads)
ect_partial_kernel(const double2* __restrict__ a, const double2* __restrict__ b,
                   float2* __restrict__ part, double2* __restrict__ t_out,
                   int n_cells, int ea, int eb, int dk, int dr, int te, int fc,
                   int rows) {
  extern __shared__ float2 smem[];
  const int k_len = dk * dr, kp = dk * (dr + 1);
  const int fcp = round_up(fc, FR), tep = round_up(te, kGE);
  float2* bs = smem;                  // (fcp, k_len)
  float2* ws = bs + fcp * k_len;      // (fc, kp): W, keep rows padded
  float2* as = ws + fc * kp;          // (tep, k_len)
  float2* gs = as + tep * k_len;      // (tep, fcp)
  float2* ts = gs + tep * fcp;        // (dk, dk) beta-major, serial plan only
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int f0 = blockIdx.z * fc;
  const int nf = min(fc, eb - f0);
  const int e_begin = blockIdx.y * rows;
  const int e_end = min(ea, e_begin + rows);
  const int n_ft = fcp / FR;
  const int kgroups = (k_len + 63) / 64;
  const int nab = (dk + kTA - 1) / kTA, nbb = (dk + kTB - 1) / kTB;
  if (t_out)
    for (int i = tid; i < dk * dk; i += kThreads) ts[i] = make_float2(0.f, 0.f);

  for (int c = 0; c < n_cells; ++c) {
    const size_t cell = static_cast<size_t>(blockIdx.x) * n_cells + c;
    const double2* ap = a + cell * ea * k_len;
    const double2* bp = b + (cell * eb + f0) * k_len;
    __syncthreads();   // the previous cell's fold is done with bs and ws
    stage_rows<false>(bs, bp, nf, fcp, k_len);
    for (int i = tid; i < nf * kp; i += kThreads) ws[i] = make_float2(0.f, 0.f);

    for (int e0 = e_begin; e0 < e_end; e0 += te) {
      const int ne = min(te, e_end - e0);
      const int nep = round_up(ne, kGE);
      __syncthreads();   // the previous tile's readers of as and gs are done
      stage_rows<true>(as, ap + static_cast<size_t>(e0) * k_len, ne, nep, k_len);
      __syncthreads();
      // Gram of the tile: G[e, f] = <a_e | b_f>, one warp per kGE x FR block
      for (int t = warp; t < (nep / kGE) * n_ft; t += kWarps) {
        const int et = t / n_ft, ft = t - et * n_ft;
        const float2* ar = as + et * kGE * k_len;
        const float2* br = bs + ft * FR * k_len;
        float2 acc[kGE][FR];
#pragma unroll
        for (int i = 0; i < kGE; ++i)
#pragma unroll
          for (int q = 0; q < FR; ++q) acc[i][q] = make_float2(0.f, 0.f);
        for (int k = lane; k < k_len; k += 32) {
          float2 x[kGE];
#pragma unroll
          for (int i = 0; i < kGE; ++i) x[i] = ar[i * k_len + k];
#pragma unroll
          for (int q = 0; q < FR; ++q) {
            const float2 y = br[q * k_len + k];
#pragma unroll
            for (int i = 0; i < kGE; ++i) acc[i][q] = cmul_conj_x(x[i], y, acc[i][q]);
          }
        }
#pragma unroll
        for (int i = 0; i < kGE; ++i)
#pragma unroll
          for (int q = 0; q < FR; ++q) {
            const float gr = allsum(acc[i][q].x), gi = allsum(acc[i][q].y);
            if (lane == i * FR + q)
              gs[(et * kGE + i) * fcp + ft * FR + q] = make_float2(gr, gi);
          }
      }
      __syncthreads();
      // W[f, k] += sum_e G[e, f] a[e, k]: a lane owns FR rows at columns
      // k1 = 64 g + lane and k1 + 32; each (f, k) has one owner
      for (int t = warp; t < n_ft * kgroups; t += kWarps) {
        const int ft = t / kgroups, g = t - ft * kgroups;
        const int k1 = g * 64 + lane, k2 = k1 + 32;
        const bool v1 = k1 < k_len, v2 = k2 < k_len;
        float2 acc1[FR], acc2[FR];
#pragma unroll
        for (int q = 0; q < FR; ++q) acc1[q] = acc2[q] = make_float2(0.f, 0.f);
        for (int e = 0; e < ne; ++e) {
          const float2 x1 = v1 ? as[e * k_len + k1] : make_float2(0.f, 0.f);
          const float2 x2 = v2 ? as[e * k_len + k2] : make_float2(0.f, 0.f);
          const float2* gr = gs + e * fcp + ft * FR;
#pragma unroll
          for (int q = 0; q < FR; ++q) {
            const float2 gg = gr[q];
            acc1[q] = cmul(gg, x1, acc1[q]);
            acc2[q] = cmul(gg, x2, acc2[q]);
          }
        }
        const int p1 = k1 + k1 / dr, p2 = k2 + k2 / dr;
#pragma unroll
        for (int q = 0; q < FR; ++q) {
          const int f = ft * FR + q;
          if (f < nf) {
            if (v1) { float2& w = ws[f * kp + p1]; w.x += acc1[q].x; w.y += acc1[q].y; }
            if (v2) { float2& w = ws[f * kp + p2]; w.x += acc2[q].x; w.y += acc2[q].y; }
          }
        }
      }
    }
    __syncthreads();
    // fold: T[al, be] = sum_{f, r} W[f, (al, r)] conj(b[f, (be, r)]); a
    // thread owns al = ab + nab i, be = bb + nbb j', in every cell
    float2* out = t_out ? ts
                        : part + ((static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y) *
                                      gridDim.z + blockIdx.z) * dk * dk;
    for (int t = tid; t < nab * nbb; t += kThreads) {
      const int ab = t % nab, bb = t / nab;
      int wo[kTA], bo[kTB];
#pragma unroll
      for (int i = 0; i < kTA; ++i) wo[i] = min(ab + nab * i, dk - 1) * (dr + 1);
#pragma unroll
      for (int q = 0; q < kTB; ++q) bo[q] = min(bb + nbb * q, dk - 1) * dr;
      float2 acc[kTA][kTB];
#pragma unroll
      for (int i = 0; i < kTA; ++i)
#pragma unroll
        for (int q = 0; q < kTB; ++q) acc[i][q] = make_float2(0.f, 0.f);
      for (int f = 0; f < nf; ++f) {
        const float2* wr = ws + f * kp;
        const float2* br = bs + f * k_len;
        for (int r = 0; r < dr; ++r) {
          float2 x[kTA];
#pragma unroll
          for (int i = 0; i < kTA; ++i) x[i] = wr[wo[i] + r];
#pragma unroll
          for (int q = 0; q < kTB; ++q) {
            const float2 y = br[bo[q] + r];
#pragma unroll
            for (int i = 0; i < kTA; ++i) acc[i][q] = cmul_conj_y(x[i], y, acc[i][q]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kTA; ++i)
#pragma unroll
        for (int q = 0; q < kTB; ++q) {
          const int al = ab + nab * i, be = bb + nbb * q;
          if (al < dk && be < dk) {
            if (t_out) {
              float2& o = out[be * dk + al];
              o.x += acc[i][q].x;
              o.y += acc[i][q].y;
            } else {
              out[be * dk + al] = acc[i][q];
            }
          }
        }
    }
  }
  if (t_out) {
    __syncthreads();
    double2* tj = t_out + static_cast<size_t>(blockIdx.x) * dk * dk;
    for (int i = tid; i < dk * dk; i += kThreads) {
      const int be = i / dk, al = i - be * dk;
      tj[al * dk + be] = make_double2(ts[i].x, ts[i].y);
    }
  }
}

// T[j, al, be] = sum over the j's partials, in order.
__global__ void __launch_bounds__(kThreads)
ect_reduce_kernel(const float2* __restrict__ part, double2* __restrict__ t_out,
                  int parts, int dk) {
  const int i = blockIdx.x * kThreads + threadIdx.x;    // be * dk + al
  if (i >= dk * dk) return;
  const size_t j = blockIdx.y;
  const float2* p = part + j * parts * dk * dk + i;
  float sr = 0.f, si = 0.f;
  for (int q = 0; q < parts; ++q) {
    const float2 v = p[static_cast<size_t>(q) * dk * dk];
    sr += v.x;
    si += v.y;
  }
  const int be = i / dk, al = i - be * dk;
  t_out[j * dk * dk + al * dk + be] = make_double2(sr, si);
}

// Read once per device: the SM count and the opt-in shared memory; once
// per device and instantiation of ect_partial_kernel (slot 0: FR = 1,
// slot 1: FR = 8): that opt-in given to it.
struct DeviceInfo {
  bool known;
  int sms, optin;
  bool opted_in[2];
};
std::mutex g_dev_mutex;
DeviceInfo g_dev[kMaxDevices];

const void* partial_kernel(int fr) {
  return fr == 8 ? reinterpret_cast<const void*>(ect_partial_kernel<8>)
                 : reinterpret_cast<const void*>(ect_partial_kernel<1>);
}

// Device dev must be current. fr = 0 asks for the device's numbers only.
cudaError_t device_info(int dev, int fr, DeviceInfo* out) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_dev_mutex);
  DeviceInfo& d = g_dev[dev];
  cudaError_t err = cudaSuccess;
  if (!d.known) {
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&d.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    d.known = true;
  }
  if (fr && !d.opted_in[fr == 8]) {
    err = cudaFuncSetAttribute(partial_kernel(fr),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, d.optin);
    if (err != cudaSuccess) return err;
    d.opted_in[fr == 8] = true;
  }
  *out = d;
  return cudaSuccess;
}

// Device dev must be current.
cudaError_t make_plan(int j, int n, int ea, int eb, int dk, int dr, int dev,
                      Plan* p) {
  DeviceInfo info;
  cudaError_t err = device_info(dev, 0, &info);
  if (err != cudaSuccess) return err;
  const int k_len = dk * dr, kp = dk * (dr + 1);
  const long long jn = static_cast<long long>(j) * n;
  int te = static_cast<int>(kTileBytes / (sizeof(float2) * k_len));
  te = te < 1 ? 1 : (te > kMaxTileRows ? kMaxTileRows : te);
  te = te > ea ? ea : te;
  int fc = eb;
  // spread small grids over b's rows (no repeated arithmetic, a re-read)
  while (jn * ((eb + fc - 1) / fc) < 2LL * info.sms && fc >= 2 * kMinFc)
    fc = (fc + 1) / 2;
  while (smem_bytes(te, fc, k_len, kp, 0) > static_cast<size_t>(info.optin)) {
    if (te > 1) te = (te + 1) / 2;
    else if (fc > 1) fc = (fc + 1) / 2;
    else return cudaErrorInvalidValue;   // one row of a and of b too long
  }
  const int nfz = (eb + fc - 1) / fc;
  const int tiles = (ea + te - 1) / te;
  err = device_info(dev, fr_of(fc), &info);
  if (err != cudaSuccess) return err;
  const size_t nbytes = sizeof(double2) * static_cast<size_t>(n) * (ea + eb) * k_len;
  const size_t serial_smem = smem_bytes(te, fc, k_len, kp, dk * dk);
  if (nbytes <= kSerialBytes && nfz == 1 &&
      serial_smem <= static_cast<size_t>(info.optin)) {
    *p = Plan{te, fc, 1, 1, tiles * te, true, serial_smem};
    return cudaSuccess;
  }
  const size_t smem = smem_bytes(te, fc, k_len, kp, 0);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, partial_kernel(fr_of(fc)),
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // Split the rows of a into the fewest ranges whose blocks fill the
  // last wave on the card to kMinWaveFill (or fill it best), each range
  // at least 2 dk rows long, so that the fold a block repeats stays
  // small against the rows it reads.
  const long long slots = static_cast<long long>(info.sms) * per_sm;
  int smax = ea / (2 * dk);
  smax = smax < 1 ? 1 : (smax > tiles ? tiles : smax);
  int split = 1;
  double best = -1.0;
  for (int s = 1; s <= smax; ++s) {
    const int per = (tiles + s - 1) / s;
    const int sg = (tiles + per - 1) / per;       // ranges of whole tiles
    const long long blocks = jn * nfz * sg;
    const double fill = static_cast<double>(blocks) /
                        (static_cast<double>((blocks + slots - 1) / slots) * slots);
    if (fill > best + 1e-9) {
      best = fill;
      split = sg;
    }
    if (fill >= kMinWaveFill) break;
  }
  if (split > 65535 || nfz > 65535) return cudaErrorInvalidValue;
  const int tiles_per = (tiles + split - 1) / split;
  *p = Plan{te, fc, nfz, split, tiles_per * te, false, smem};
  return cudaSuccess;
}

template <int FR>
void launch_partial(const Plan& p, int j, int n, const double2* a,
                    const double2* b, float2* part, double2* t, int ea, int eb,
                    int dk, int dr, cudaStream_t stream) {
  if (p.serial)
    ect_partial_kernel<FR><<<dim3(j), kThreads, p.smem, stream>>>(
        a, b, nullptr, t, n, ea, eb, dk, dr, p.te, p.fc, p.rows);
  else
    ect_partial_kernel<FR><<<dim3(j * n, p.split, p.nfz), kThreads, p.smem, stream>>>(
        a, b, part, nullptr, 1, ea, eb, dk, dr, p.te, p.fc, p.rows);
}

// Makes dev the current device for its lifetime, and restores the one
// before; err holds what setting it returned.
struct OnDevice {
  int prev = -1;
  cudaError_t err;
  explicit OnDevice(int dev) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != dev) err = cudaSetDevice(dev);
    else prev = -1;
  }
  ~OnDevice() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace

// Partial traces per j the plan writes (the workspace the caller
// allocates is (J, parts, dk, dk) complex64; 0 where one launch writes T
// and there is no workspace), or minus a cudaError_t.
extern "C" int qf_ect_parts(int j, int n, int ea, int eb, int dk, int dr,
                            int dev) {
  OnDevice on(dev);
  if (on.err != cudaSuccess) return -static_cast<int>(on.err);
  Plan p;
  const cudaError_t err = make_plan(j, n, ea, eb, dk, dr, dev, &p);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return p.serial ? 0 : n * p.split * p.nfz;
}

// Launches on stream, on device dev, which must be current.
extern "C" int qf_ect(const void* a, const void* b, void* work, void* t, int j,
                      int n, int ea, int eb, int dk, int dr, int parts, int dev,
                      void* stream) {
  Plan p;
  cudaError_t err = make_plan(j, n, ea, eb, dk, dr, dev, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (parts != (p.serial ? 0 : n * p.split * p.nfz))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* a2 = static_cast<const double2*>(a);
  const auto* b2 = static_cast<const double2*>(b);
  auto* part = static_cast<float2*>(work);
  auto* t2 = static_cast<double2*>(t);
  const auto st = static_cast<cudaStream_t>(stream);
  if (fr_of(p.fc) == 8)
    launch_partial<8>(p, j, n, a2, b2, part, t2, ea, eb, dk, dr, st);
  else
    launch_partial<1>(p, j, n, a2, b2, part, t2, ea, eb, dk, dr, st);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.serial) return static_cast<int>(err);
  ect_reduce_kernel<<<dim3((dk * dk + kThreads - 1) / kThreads, j), kThreads, 0, st>>>(
      part, t2, parts, dk);
  return static_cast<int>(cudaGetLastError());
}
