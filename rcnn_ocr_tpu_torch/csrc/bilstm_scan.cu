// Bidirectional LSTM recurrence from precomputed input projections.
//
//   xs   [T, 2, B, 4H] fp32  (direction 1 pre-flipped in time)
//   w_hh [2, H, 4H]    fp32 or bf16
//   ys   [T, 2, B, H]  fp32
//   per step and direction: gates = xs[t] + h @ w_hh[dir], gate order
//   (i, f, g, o); c = f*c + i*g; h = o*tanh(c); h and c start at zero.
//
// Replaces the Pallas TPU kernel rcnn_ocr_tpu/ops/lstm_pallas.py:
// _bilstm_pallas (body _lstm_kernel).  Plain twin:
// rcnn_ocr_tpu_torch/ops/bilstm_scan.py:scan_reference.
//
// Bound on the H100: operations at large batch (2 dirs x T x 2*B*H*4H fp32
// FLOP on CUDA cores: the kernel keeps fp32 arithmetic, because tensor
// cores would round h to bf16 or TF32), bytes at small batch (xs in, ys
// out, w_hh once).
//
// Two routes, chosen by shape alone in bilstm_scan_forward (plan_resident):
//
// * Resident (the main path: H=256, both w_hh dtypes).  w_hh[dir] stays in
//   shared memory for all T steps.  One thread-block cluster of N CTAs
//   (N = 8, the portable maximum, or 16 where 8 slices do not fit) per
//   (direction, batch tile of R rows).  CTA q of a cluster owns the H/N
//   hidden units u in [q*H/N, (q+1)*H/N): it loads the four gate columns
//   u, H+u, 2H+u, 3H+u of w_hh[dir] once, as [H][H/N][4] in w_hh's dtype,
//   so the cell update of its units needs no exchange.  Each step a thread
//   holds 4 rows x 4 gates of one unit in registers (16 fp32 FMAs per
//   float4 of h and 4-gate weight vector read from shared memory), updates
//   c in registers, writes its h into every peer CTA's double-buffered
//   h(t) [R][H] through distributed shared memory, and the cluster meets at
//   one barrier per step.  The route is taken when some N in {8, 16}
//   divides H and the weight slice plus 2 x R x H fp32 of h fit in 227 KB
//   for some R >= 8 (H=256: 64 KiB bf16 or 128 KiB fp32 of weights; H=512
//   bf16: 128 KiB with N=16).  R, a multiple of 8 up to 64 (and 384
//   threads), is the one with the fewest waves x threads per SM, from the
//   card's own count of clusters it runs at once (cudaOccupancyMaxActive-
//   Clusters): the H100 runs 15 clusters of 8 one-CTA-per-SM CTAs, so bs 256
//   takes R=40 (14 clusters, one wave) rather than R=32 (16, two waves).
//   The products take most of each step; their loop issues 128 FFMA per 9
//   shared-memory loads, yet runs at about half an FFMA per clock per
//   scheduler, the rate csrc/bench/ffma_rate.cu measures for this
//   outer-product form (acc[r][g] += h[r] * w[g]) with every operand in
//   registers.
// * Streaming (every other shape, e.g. H=512 fp32: 4 MiB per direction).
//   Grid (2 directions) x ceil(B/4) batch tiles, block of H threads;
//   thread j owns hidden unit j of 4 rows and re-reads w_hh[dir] from
//   L2 every step.  h of the tile sits in shared memory, c in registers.
//
// Plain C interface, loaded with ctypes: no PyTorch headers.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// ---------------------------------------------------------------- streaming

constexpr int kRows = 4;

template <typename WT>
__global__ void bilstm_stream_kernel(const float* __restrict__ xs,
                                     const WT* __restrict__ w_hh,
                                     float* __restrict__ ys, int T, int B, int H) {
  extern __shared__ float h_s[];  // [kRows, H]
  const int dir = blockIdx.x;
  const int b0 = blockIdx.y * kRows;
  const int j = threadIdx.x;
  const int G = 4 * H;
  const WT* w = w_hh + static_cast<size_t>(dir) * H * G;

  float c[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    c[r] = 0.f;
    h_s[r * H + j] = 0.f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const size_t row0 = (static_cast<size_t>(t) * 2 + dir) * B;  // row of (t, dir, b=0)
    float acc[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = b0 + r;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        acc[r][g] = (b < B) ? xs[(row0 + b) * G + g * H + j] : 0.f;
      }
    }
    for (int k = 0; k < H; ++k) {
      const WT* wk = w + static_cast<size_t>(k) * G + j;
      const float w0 = to_f32(wk[0]), w1 = to_f32(wk[H]);
      const float w2 = to_f32(wk[2 * H]), w3 = to_f32(wk[3 * H]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float hk = h_s[r * H + k];
        acc[r][0] = fmaf(hk, w0, acc[r][0]);
        acc[r][1] = fmaf(hk, w1, acc[r][1]);
        acc[r][2] = fmaf(hk, w2, acc[r][2]);
        acc[r][3] = fmaf(hk, w3, acc[r][3]);
      }
    }
    __syncthreads();  // every thread has read h(t-1) before it is replaced
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float ig = sigmoid(acc[r][0]);
      const float fg = sigmoid(acc[r][1]);
      const float gg = tanhf(acc[r][2]);
      const float og = sigmoid(acc[r][3]);
      c[r] = fg * c[r] + ig * gg;
      const float h = og * tanhf(c[r]);
      h_s[r * H + j] = h;
      const int b = b0 + r;
      if (b < B) ys[(row0 + b) * H + j] = h;
    }
    __syncthreads();  // h(t) complete before step t+1 reads it
  }
}

template <typename WT>
int launch_stream(const float* xs, const void* w_hh, float* ys, int T, int B, int H,
                  cudaStream_t stream) {
  if (H > 1024 || (B + kRows - 1) / kRows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(2, (B + kRows - 1) / kRows);
  const size_t smem = sizeof(float) * kRows * H;
  bilstm_stream_kernel<WT><<<grid, H, smem, stream>>>(
      xs, static_cast<const WT*>(w_hh), ys, T, B, H);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------------- resident

constexpr int kRowsPerThread = 4;   // rows of one unit a thread carries
constexpr int kMaxThreads = 384;
constexpr int kMaxRows = 64;
constexpr size_t kSmemLimit = 232448;  // 227 KB a block may use on the H100

struct Plan {
  int cluster;  // CTAs per cluster; 0 = streaming route
  int rows;     // batch rows per cluster (R)
  size_t smem;  // dynamic shared memory per CTA
  int slots;    // clusters of this shape the card runs at once
};

template <typename WT>
size_t resident_smem(int H, int n, int r) {
  return sizeof(float) * 2 * static_cast<size_t>(r) * H +
         sizeof(WT) * static_cast<size_t>(H) * 4 * (H / n);
}

template <typename WT>
__global__ void __launch_bounds__(kMaxThreads)
bilstm_resident_kernel(const float* __restrict__ xs, const WT* __restrict__ w_hh,
                       float* __restrict__ ys, int T, int B, int H, int N, int R);

template <typename WT>
cudaLaunchConfig_t resident_config(int cluster, int rows, size_t smem, int B, int H,
                                   cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * ((B + rows - 1) / rows), 2, 1);
  cfg.blockDim = dim3((H / cluster) * rows / kRowsPerThread, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

struct Fit {
  int slots;          // clusters the card runs at once
  int blocks_per_sm;  // CTAs that share one SM
};

// How clusters of (N CTAs, R rows) fit on the card (cudaOccupancyMaxActiveClusters
// and ...BlocksPerMultiprocessor, asked once per shape and remembered); sets
// the kernel's attributes first.  A shape that cannot run gets 0 slots.
template <typename WT>
Fit cluster_fit(int H, int n, int r) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, Fit> known;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(H, n, r);
  const auto it = known.find(key);
  if (it != known.end()) return it->second;
  Fit fit{0, 0};
  const size_t smem = resident_smem<WT>(H, n, r);
  const int threads = (H / n) * r / kRowsPerThread;
  cudaError_t e = cudaFuncSetAttribute(bilstm_resident_kernel<WT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(kSmemLimit));
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(bilstm_resident_kernel<WT>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = resident_config<WT>(n, r, smem, r, H, nullptr, attr);
  if (e != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&fit.slots, bilstm_resident_kernel<WT>, &cfg) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit.blocks_per_sm,
                                                    bilstm_resident_kernel<WT>, threads,
                                                    smem) != cudaSuccess ||
      fit.blocks_per_sm == 0) {
    cudaGetLastError();  // clear the error of a shape that cannot run
    fit = Fit{0, 0};
  }
  known[key] = fit;
  return fit;
}

// The route rule of the header.  The shape decides the route; among the
// batch tiles R that fit, the one whose waves x threads per SM (at least
// 256: fewer threads leave the SM waiting on latency) is least.
template <typename WT>
Plan plan_resident(int B, int H) {
  const int sizes[2] = {8, 16};
  for (int n : sizes) {
    if (H % n != 0) continue;
    const int units = H / n;
    Plan best{0, 0, 0, 0};
    long best_cost = 0;
    for (int r = 8; r <= kMaxRows; r += 8) {
      const int threads = units * r / kRowsPerThread;
      if (resident_smem<WT>(H, n, r) > kSmemLimit || threads > kMaxThreads) break;
      const Fit fit = cluster_fit<WT>(H, n, r);
      if (fit.slots == 0) continue;
      const long clusters = 2L * ((B + r - 1) / r);
      const long per_sm = static_cast<long>(threads) * fit.blocks_per_sm;
      const long cost = ((clusters + fit.slots - 1) / fit.slots) * (per_sm < 256 ? 256 : per_sm);
      if (best.cluster == 0 || cost < best_cost) {
        best = Plan{n, r, resident_smem<WT>(H, n, r), fit.slots};
        best_cost = cost;
      }
    }
    if (best.cluster != 0) return best;
  }
  return Plan{0, 0, 0, 0};
}

// four gate weights of (k, unit), widened to fp32 (bf16 -> fp32 is exact)
__device__ __forceinline__ float4 load_w4(const float* w_s, int idx) {
  return reinterpret_cast<const float4*>(w_s)[idx];
}
__device__ __forceinline__ float4 load_w4(const __nv_bfloat16* w_s, int idx) {
  const uint2 raw = reinterpret_cast<const uint2*>(w_s)[idx];
  return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
}

template <typename WT>
__global__ void __launch_bounds__(kMaxThreads)
bilstm_resident_kernel(const float* __restrict__ xs, const WT* __restrict__ w_hh,
                       float* __restrict__ ys, int T, int B, int H, int N, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* h_s = reinterpret_cast<float*>(smem_raw);   // [2][R][H]: h(t-1), h(t)
  WT* w_s = reinterpret_cast<WT*>(h_s + 2 * R * H);  // [H][U][4]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / N;
  const int dir = blockIdx.y;
  const int U = H / N;
  const int G = 4 * H;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  // this CTA's weight slice, once per launch
  const WT* w = w_hh + static_cast<size_t>(dir) * H * G + rank * U;
  for (int i = tid; i < H * 4 * U; i += nt) {
    const int k = i / (4 * U);
    const int rem = i - k * 4 * U;
    const int g = rem / U;
    const int u = rem - g * U;
    w_s[(k * U + u) * 4 + g] = w[static_cast<size_t>(k) * G + g * H + u];
  }
  for (int i = tid; i < R * H; i += nt) h_s[i] = 0.f;  // h(-1) = 0

  const int u = tid % U;
  const int r0 = (tid / U) * kRowsPerThread;
  const int ug = rank * U + u;      // hidden unit of this thread
  const int b0 = tile * R + r0;     // first batch row of this thread

  float xin[kRowsPerThread][4];
  float xnext[kRowsPerThread][4];
  auto load_x = [&](int t, float (&dst)[kRowsPerThread][4]) {
    const size_t row0 = (static_cast<size_t>(t) * 2 + dir) * B;
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int b = b0 + r;
#pragma unroll
      for (int g = 0; g < 4; ++g) dst[r][g] = (b < B) ? xs[(row0 + b) * G + g * H + ug] : 0.f;
    }
  };
  load_x(0, xin);
  float c[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) c[r] = 0.f;

  // weights and h(-1) in place, and every CTA of the cluster running
  // before any peer writes into this one
  cluster.sync();

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    float acc[kRowsPerThread][4];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[r][g] = xin[r][g];
    }
    if (t + 1 < T) load_x(t + 1, xnext);  // in flight during the products

    const float* hb = h_s + (cur * R + r0) * H;
#pragma unroll 2
    for (int k = 0; k < H; k += 4) {
      float4 hv[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        hv[r] = *reinterpret_cast<const float4*>(hb + r * H + k);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 wv = load_w4(w_s, (k + kk) * U + u);
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const float hk = kk == 0 ? hv[r].x : kk == 1 ? hv[r].y : kk == 2 ? hv[r].z : hv[r].w;
          acc[r][0] = fmaf(hk, wv.x, acc[r][0]);
          acc[r][1] = fmaf(hk, wv.y, acc[r][1]);
          acc[r][2] = fmaf(hk, wv.z, acc[r][2]);
          acc[r][3] = fmaf(hk, wv.w, acc[r][3]);
        }
      }
    }

    float h[kRowsPerThread];
    const size_t row0 = (static_cast<size_t>(t) * 2 + dir) * B;
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const float ig = sigmoid(acc[r][0]);
      const float fg = sigmoid(acc[r][1]);
      const float gg = tanhf(acc[r][2]);
      const float og = sigmoid(acc[r][3]);
      c[r] = fg * c[r] + ig * gg;
      h[r] = og * tanhf(c[r]);
      if (b0 + r < B) ys[(row0 + b0 + r) * H + ug] = h[r];
    }
    if (t + 1 < T) {
      // h(t) into the other buffer of every CTA of the cluster (self too);
      // nobody reads that buffer until the barrier below, and everybody has
      // finished reading it (as h(t-2)) before the previous barrier
      float* dst = h_s + ((cur ^ 1) * R + r0) * H + ug;
      for (int q = 0; q < N; ++q) {
        float* peer = cluster.map_shared_rank(dst, q);
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) peer[r * H] = h[r];
      }
      cluster.sync();
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
        for (int g = 0; g < 4; ++g) xin[r][g] = xnext[r][g];
      }
    }
  }
}

template <typename WT>
int launch_resident(const float* xs, const void* w_hh, float* ys, int T, int B, int H,
                    const Plan& p, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = resident_config<WT>(p.cluster, p.rows, p.smem, B, H, stream, attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, bilstm_resident_kernel<WT>, xs,
                                           static_cast<const WT*>(w_hh), ys, T, B, H, p.cluster,
                                           p.rows);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename WT>
int launch(const float* xs, const void* w_hh, float* ys, int T, int B, int H,
           cudaStream_t stream) {
  const Plan p = plan_resident<WT>(B, H);
  if (p.cluster == 0) return launch_stream<WT>(xs, w_hh, ys, T, B, H, stream);
  return launch_resident<WT>(xs, w_hh, ys, T, B, H, p, stream);
}

template <typename WT>
int describe(int B, int H, int* out) {
  const Plan p = plan_resident<WT>(B, H);
  out[0] = p.cluster;
  out[1] = p.rows;
  out[2] = static_cast<int>(p.smem);
  out[3] = p.slots;
  return 0;
}

}  // namespace

// w_dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int bilstm_scan_forward(const float* xs, const void* w_hh, float* ys,
                                   int T, int B, int H, int w_dtype, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dtype == 0) return launch<float>(xs, w_hh, ys, T, B, H, s);
  if (w_dtype == 1) return launch<__nv_bfloat16>(xs, w_hh, ys, T, B, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The route bilstm_scan_forward takes for (B, H, w_dtype): out[0] = CTAs per
// cluster (0 = streaming), out[1] = batch rows per cluster, out[2] = dynamic
// shared memory per CTA, out[3] = clusters the card runs at once (resident
// route only).  Returns a cudaError_t.
extern "C" int bilstm_scan_plan(int B, int H, int w_dtype, int* out) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (w_dtype == 0) return describe<float>(B, H, out);
  if (w_dtype == 1) return describe<__nv_bfloat16>(B, H, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
