// Fused squeeze-excite forward: out = x * sigmoid(relu(mean_hw(x) @ w1) @ w2).
//
// Replaces the Pallas TPU kernel rcnn_ocr_tpu/ops/se_pallas.py:_se_forward
// (body _se_kernel).  Plain twin: rcnn_ocr_tpu_torch/ops/se_scale.py:
// se_scale_reference.
//
// Bound on the H100: bytes.  Each call must read x once and write x * gate
// once; the two matrix-vector products (C -> C/16 -> C) are a few thousand
// operations per sample, nothing beside the [B, H, W, C] activation.
//
// Two routes, chosen by shape alone in se_scale_forward (plan_cluster):
//
// * Cluster (the main path's slabs and most others).  x is read from device
//   memory once.  A thread-block cluster of N CTAs splits each sample by
//   channels: CTA q holds the run of K = C/N channels [q*K, (q+1)*K) of
//   every pixel, so its channel sums, its gates and its writes need nobody
//   else; only the hidden layer (C/16 values per sample) crosses the
//   cluster.  N is the largest of 8, 4, 2, 1 whose runs are whole 16-byte
//   vectors (else whole channels); the samples go in groups of M, which
//   fill about 32 KiB of x per CTA (1 <= M <= 16, fewer where shared
//   memory runs out).  At the main path's slabs: [8,32,256] N=8, M=2
//   (bf16) / 1 (fp32); [4,16,512] N=8, M=4 (bf16) / 2 (fp32).  The grid is
//   persistent: as many clusters as the card runs at once
//   (cudaOccupancyMaxActiveClusters), each walking over the groups.  A CTA
//   keeps its run's rows of w1 and columns of w2 in shared memory for the
//   whole launch, and for each group
//   1. has the group's runs in shared memory, copied with 16-byte cp.async
//      while the previous group was being processed (two buffers; plain
//      copies where x, out or a run is not 16-byte aligned);
//   2. sums its channels over all pixels in fp32 (16-byte vectors of
//      channels, pixels split over threads and added in a fixed order);
//   3. multiplies the means into its rows of w1 and writes this share of
//      the hidden layer into every CTA of the cluster through distributed
//      shared memory (two buffers, by group parity); after one cluster
//      barrier every CTA adds the N shares in rank order and applies relu,
//      so all agree; then computes its channels' gates from its columns of
//      w2, in fp32, rounded to x's dtype (the reference multiplies in x's
//      dtype);
//   4. writes x * gate from shared memory with 16-byte stores.
//   One cluster barrier per group, and one at the start (its arrive is
//   relaxed and comes before the first loads).  Splitting by pixels
//   instead needs three exchanges (channel sums, hidden layer, gates) and
//   measured slower.
// * Streaming (a channel run of more than 48 KiB per sample): one block per
//   sample reads x twice from device memory (channel sums, then x * gate)
//   and runs the whole MLP.
//
// Plain C interface, loaded with ctypes: no PyTorch headers.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxS = 64;
constexpr int kMaxCluster = 8;
constexpr int kMaxSamples = 16;
constexpr size_t kTargetPart = 32 * 1024;  // bytes of x a CTA aims to hold
constexpr size_t kMaxPart = 48 * 1024;     // bytes of one sample's run a CTA may hold
constexpr size_t kSmemLimit = 232448;      // 227 KB a block may use on the H100

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// C -> S -> C excite step on mean [C] (shared), into gate [C] (shared),
// rounded to T.  scratch holds kThreads floats.  Ends with __syncthreads().
template <typename T>
__device__ void se_mlp(const float* mean, const float* __restrict__ w1,
                       const float* __restrict__ w2, float* hid, float* scratch, float* gate,
                       int C, int S) {
  const int tid = threadIdx.x;
  const int groups = blockDim.x / S;
  // hid[j] = relu(sum_c mean[c] * w1[c, j]): thread (g, j) takes c = g, g+groups, ...
  // so a warp reads consecutive addresses of w1 [C, S]
  if (tid < groups * S) {
    const int g = tid / S, j = tid - g * S;
    float acc = 0.f;
    for (int c = g; c < C; c += groups) acc = fmaf(mean[c], w1[c * S + j], acc);
    scratch[tid] = acc;
  }
  __syncthreads();
  if (tid < S) {
    float acc = 0.f;
    for (int g = 0; g < groups; ++g) acc += scratch[g * S + tid];
    hid[tid] = fmaxf(acc, 0.f);
  }
  __syncthreads();
  // gate[c] = sigmoid(sum_j hid[j] * w2[j, c]), lanes over c
  for (int c = tid; c < C; c += blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < S; ++j) acc = fmaf(hid[j], w2[j * C + c], acc);
    gate[c] = to_f32(from_f32<T>(1.f / (1.f + expf(-acc))));
  }
  __syncthreads();
}

// 16 bytes of x times their channels' gates (c is a multiple of 16/sizeof(T))
__device__ __forceinline__ uint4 scale16(uint4 v, const float* g) {
  float4* f = reinterpret_cast<float4*>(&v);
  const float4 gv = *reinterpret_cast<const float4*>(g);
  f->x *= gv.x;
  f->y *= gv.y;
  f->z *= gv.z;
  f->w *= gv.w;
  return v;
}
__device__ __forceinline__ uint4 scale16_bf16(uint4 v, const float* g) {
  // the 8 gates as two 16-byte loads: lanes read consecutive 32-byte runs
  const float4 g0 = *reinterpret_cast<const float4*>(g);
  const float4 g1 = *reinterpret_cast<const float4*>(g + 4);
  const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lo = __uint_as_float(w[i] << 16) * gv[2 * i];
    const float hi = __uint_as_float(w[i] & 0xffff0000u) * gv[2 * i + 1];
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return v;
}
// acc[i] += the i-th element of 16 bytes of x, in fp32
__device__ __forceinline__ void add16(float* acc, uint4 v, float) {
  const float4 f = *reinterpret_cast<const float4*>(&v);
  acc[0] += f.x;
  acc[1] += f.y;
  acc[2] += f.z;
  acc[3] += f.w;
}
__device__ __forceinline__ void add16(float* acc, uint4 v, __nv_bfloat16) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] += __uint_as_float(w[i] << 16);
    acc[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T> __device__ __forceinline__ uint4 scale_vec(uint4 v, const float* g);
template <> __device__ __forceinline__ uint4 scale_vec<float>(uint4 v, const float* g) {
  return scale16(v, g);
}
template <> __device__ __forceinline__ uint4 scale_vec<__nv_bfloat16>(uint4 v, const float* g) {
  return scale16_bf16(v, g);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// split cluster barrier: arrive (relaxed: only "this CTA runs"), arrive
// (release), wait (acquire)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ------------------------------------------------------------------ cluster

struct Plan {
  int cluster;  // CTAs per cluster (N); 0 = streaming route
  int samples;  // samples per group (M)
  int split;    // interleaved partial sums per (sample, channel run)
  size_t smem;  // dynamic shared memory per CTA
};

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Shared memory of one CTA (channel run K = C/N), in the order the kernel lays it out.
struct Layout {
  size_t x, w1, w2, part, mean, hidp, hid, gate, total;  // byte offsets
  __host__ __device__ Layout(size_t esize, int hw, int N, int M, int C, int S, int split) {
    const size_t K = C / N;
    x = 0;                                                 // [2][M][hw][K] elements
    w1 = align16(2 * esize * M * hw * K);                  // [K][S] rows of this run
    w2 = w1 + align16(sizeof(float) * K * S);              // [S][K] columns of this run
    part = w2 + align16(sizeof(float) * S * K);            // [split][M][K]
    mean = part + align16(sizeof(float) * split * M * K);  // [M][K]
    hidp = mean + align16(sizeof(float) * M * K);          // [2][N][M][S]
    hid = hidp + sizeof(float) * 2 * N * M * S;            // [M][S]
    gate = align16(hid + sizeof(float) * M * S);           // [M][K]
    total = gate + sizeof(float) * M * K;
  }
};

// The route rule of the header, from the shape alone.
template <typename T>
Plan plan_cluster(int batch, int hw, int C, int S) {
  constexpr int kV = 16 / sizeof(T);
  // the largest N whose channel runs are whole 16-byte vectors (else whole channels)
  int n = kMaxCluster;
  while (n > 1 && C % (n * ((C % kV) == 0 ? kV : 1)) != 0) n /= 2;
  const int K = C / n;
  const int vecs = (K % kV) == 0 ? K / kV : K;  // sum lanes per sample
  const size_t part = sizeof(T) * static_cast<size_t>(hw) * K;
  if (part > kMaxPart) return Plan{0, 0, 0, 0};
  int m = static_cast<int>(kTargetPart / part);
  m = m < 1 ? 1 : m > kMaxSamples ? kMaxSamples : m;
  if (m > batch) m = batch;
  for (; m >= 1; --m) {
    int split = kThreads / (m * vecs);
    split = split < 1 ? 1 : split > hw ? hw : split;
    const size_t smem = Layout(sizeof(T), hw, n, m, C, S, split).total;
    if (smem <= kSmemLimit) return Plan{n, m, split, smem};
  }
  return Plan{0, 0, 0, 0};
}

// Channels [c0, c0 + K) of every pixel of group g's samples into dst
// [M][hw][K]: 16-byte cp.async (committed by the caller), or plain copies.
template <typename T>
__device__ __forceinline__ void load_group(T* dst, const T* __restrict__ x, int g, int batch,
                                           int hw, int C, int M, int K, int c0, int vec) {
  const int ms = min(M, batch - g * M);
  if (vec) {
    constexpr int kV = 16 / sizeof(T);
    const int kv = K / kV;
    const int n = ms * hw * kv;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int row = i / kv, v = i - row * kv;  // row = m * hw + p
      cp_async16(dst + static_cast<size_t>(i) * kV,
                 x + (static_cast<size_t>(g) * M * hw + row) * C + c0 + v * kV);
    }
  } else {
    const int n = ms * hw * K;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int row = i / K, k = i - row * K;
      dst[i] = x[(static_cast<size_t>(g) * M * hw + row) * C + c0 + k];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
se_cluster_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ w2, T* __restrict__ out, int batch,
                  int hw, int C, int S, int N, int M, int split, int vec) {
  constexpr int kV = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_clusters = gridDim.x / N;
  const int groups = (batch + M - 1) / M;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int K = C / N;       // channels of this CTA: [c0, c0 + K)
  const int c0 = rank * K;
  const int kv = K / kV;     // 16-byte vectors per pixel of the run (vec)

  const Layout L(sizeof(T), hw, N, M, C, S, split);
  T* xbuf = reinterpret_cast<T*>(smem_raw + L.x);
  float* w1s = reinterpret_cast<float*>(smem_raw + L.w1);
  float* w2s = reinterpret_cast<float*>(smem_raw + L.w2);
  float* part = reinterpret_cast<float*>(smem_raw + L.part);
  float* mean = reinterpret_cast<float*>(smem_raw + L.mean);
  float* hid = reinterpret_cast<float*>(smem_raw + L.hid);
  float* gate = reinterpret_cast<float*>(smem_raw + L.gate);

  cluster_arrive_relaxed();  // this CTA runs: peers may write into it after the wait below

  // the first group's x in flight while this run's weight rows and columns load
  int g = blockIdx.x / N;
  if (g < groups) load_group(xbuf, x, g, batch, hw, C, M, K, c0, vec);
  cp_async_commit();
  for (int i = tid; i < K * S; i += nt) w1s[i] = w1[c0 * S + i];
  for (int i = tid; i < S * K; i += nt) {
    const int j = i / K;
    w2s[i] = w2[j * C + c0 + (i - j * K)];
  }
  cluster_wait();

  const float inv_hw = 1.f / static_cast<float>(hw);
  for (int it = 0; g < groups; ++it, g += n_clusters) {
    T* xs = xbuf + (it & 1) * M * hw * K;
    float* hidp = reinterpret_cast<float*>(smem_raw + L.hidp) + (it & 1) * N * M * S;
    const int ms = min(M, batch - g * M);
    // 1. the next group's x into the other buffer, then wait for this one's
    __syncthreads();  // every thread is done with the other buffer (group it-1)
    const int g_next = g + n_clusters;
    if (g_next < groups) {
      load_group(xbuf + ((it + 1) & 1) * M * hw * K, x, g_next, batch, hw, C, M, K, c0, vec);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    // 2. channel means of the run: slot (s, m, v) sums every split-th pixel
    //    from s of one 16-byte vector of channels (vec) or one channel
    if (vec) {
      for (int k = tid; k < split * M * kv; k += nt) {
        const int s = k / (M * kv), mv = k - s * M * kv;
        const int m = mv / kv, v = mv - m * kv;
        float acc[kV];
#pragma unroll
        for (int i = 0; i < kV; ++i) acc[i] = 0.f;
        if (m < ms) {
          const uint4* xm = reinterpret_cast<const uint4*>(xs + m * hw * K) + v;
          for (int p = s; p < hw; p += split) add16(acc, xm[p * kv], T());
        }
        float* dst = part + (s * M + m) * K + v * kV;
#pragma unroll
        for (int i = 0; i < kV; ++i) dst[i] = acc[i];
      }
    } else {
      for (int k = tid; k < split * M * K; k += nt) {
        const int s = k / (M * K), mk = k - s * M * K;
        const int m = mk / K, c = mk - m * K;
        float acc = 0.f;
        if (m < ms) {
          for (int p = s; p < hw; p += split) acc += to_f32(xs[(m * hw + p) * K + c]);
        }
        part[k] = acc;
      }
    }
    __syncthreads();
    for (int i = tid; i < M * K; i += nt) {
      float acc = 0.f;
      for (int s = 0; s < split; ++s) acc += part[s * M * K + i];
      mean[i] = acc * inv_hw;
    }
    __syncthreads();

    // 3. this run's share of the hidden layer, to every CTA of the cluster;
    //    after the barrier each adds the N shares in rank order, so all agree
    for (int i = tid; i < M * S; i += nt) {
      const int m = i / S, j = i - m * S;
      float acc = 0.f;
      for (int k = 0; k < K; ++k) acc = fmaf(mean[m * K + k], w1s[k * S + j], acc);
      for (int q = 0; q < N; ++q) cluster.map_shared_rank(hidp, q)[(rank * M + m) * S + j] = acc;
    }
    cluster_arrive();
    cluster_wait();
    for (int i = tid; i < M * S; i += nt) {
      float acc = 0.f;
      for (int q = 0; q < N; ++q) acc += hidp[q * M * S + i];
      hid[i] = fmaxf(acc, 0.f);
    }
    __syncthreads();
    for (int i = tid; i < M * K; i += nt) {
      const int m = i / K, k = i - m * K;
      float acc = 0.f;
      for (int j = 0; j < S; ++j) acc = fmaf(hid[m * S + j], w2s[j * K + k], acc);
      gate[i] = to_f32(from_f32<T>(1.f / (1.f + expf(-acc))));
    }
    __syncthreads();

    // 4. x * gate from shared memory into the run's channels of every pixel
    T* og = out + static_cast<size_t>(g) * M * hw * C + c0;
    if (vec) {
      const int n = ms * hw * kv;
      for (int i = tid; i < n; i += nt) {
        const int row = i / kv, v = i - row * kv;  // row = m * hw + p
        const int m = row / hw;
        reinterpret_cast<uint4*>(og + static_cast<size_t>(row) * C)[v] =
            scale_vec<T>(reinterpret_cast<const uint4*>(xs)[i], gate + m * K + v * kV);
      }
    } else {
      const int n = ms * hw * K;
      for (int i = tid; i < n; i += nt) {
        const int row = i / K, k = i - row * K;
        og[static_cast<size_t>(row) * C + k] = from_f32<T>(to_f32(xs[i]) * gate[(row / hw) * K + k]);
      }
    }
  }
}

template <typename T>
cudaLaunchConfig_t cluster_config(const Plan& p, int clusters, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster * clusters, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of this plan the card runs at once (cudaOccupancyMaxActiveClusters,
// asked once per plan and remembered); sets the kernel's attributes first.
template <typename T>
int cluster_slots(const Plan& p) {
  static std::mutex mu;
  static std::map<std::pair<int, size_t>, int> known;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(p.cluster, p.smem);
  const auto it = known.find(key);
  if (it != known.end()) return it->second;
  int slots = 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config<T>(p, 1, nullptr, attr);
  if (cudaFuncSetAttribute(se_cluster_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmemLimit)) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&slots, se_cluster_kernel<T>, &cfg) != cudaSuccess) {
    slots = -static_cast<int>(cudaGetLastError());
  }
  if (slots != 0) known[key] = slots;
  return slots;
}

template <typename T>
int launch_cluster(const void* x, const float* w1, const float* w2, void* out, int batch,
                   int hw, int C, int S, const Plan& p, cudaStream_t stream) {
  const int slots = cluster_slots<T>(p);
  if (slots <= 0) return slots < 0 ? -slots : static_cast<int>(cudaErrorInvalidConfiguration);
  const int groups = (batch + p.samples - 1) / p.samples;
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                  ((C / p.cluster) * sizeof(T)) % 16 == 0;
  cudaLaunchAttribute attr[1];
  const int clusters = groups < slots ? groups : slots;
  const cudaLaunchConfig_t cfg = cluster_config<T>(p, clusters, stream, attr);
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, se_cluster_kernel<T>, static_cast<const T*>(x), w1, w2,
                         static_cast<T*>(out), batch, hw, C, S, p.cluster, p.samples, p.split,
                         vec);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- streaming

template <typename T>
__global__ void __launch_bounds__(kThreads)
se_stream_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ w2, T* __restrict__ out,
                 int hw, int C, int S, int split) {
  extern __shared__ float smem[];
  float* part = smem;              // [split * C] partial channel sums
  float* mean = part + split * C;  // [C]
  float* gate = mean + C;          // [C]
  float* hid = gate + C;           // [kMaxS]
  float* scratch = hid + kMaxS;    // [kThreads]

  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * hw * C;
  const T* xb = x + base;
  T* ob = out + base;

  // slot k covers channel k % C and every split-th pixel starting at k / C
  for (int k = tid; k < split * C; k += blockDim.x) {
    const int s = k / C, c = k - s * C;
    float acc = 0.f;
    for (int p = s; p < hw; p += split) acc += to_f32(xb[static_cast<size_t>(p) * C + c]);
    part[k] = acc;
  }
  __syncthreads();
  const float inv_hw = 1.f / static_cast<float>(hw);
  for (int c = tid; c < C; c += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < split; ++s) acc += part[s * C + c];
    mean[c] = acc * inv_hw;
  }
  __syncthreads();
  se_mlp<T>(mean, w1, w2, hid, scratch, gate, C, S);
  const size_t n = static_cast<size_t>(hw) * C;
  const int step = blockDim.x % C;
  int c = tid % C;
  for (size_t k = tid; k < n; k += blockDim.x) {
    ob[k] = from_f32<T>(to_f32(xb[k]) * gate[c]);
    c += step;
    if (c >= C) c -= C;
  }
}

template <typename T>
int launch_stream(const void* x, const float* w1, const float* w2, void* out, int batch,
                  int hw, int C, int S, cudaStream_t stream) {
  int split = kThreads / C;
  split = split < 1 ? 1 : split > hw ? hw : split;
  const size_t smem = sizeof(float) * (static_cast<size_t>(split) * C + 2 * C + kMaxS + kThreads);
  se_stream_kernel<T><<<batch, kThreads, smem, stream>>>(
      static_cast<const T*>(x), w1, w2, static_cast<T*>(out), hw, C, S, split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const float* w1, const float* w2, void* out, int batch, int hw,
           int C, int S, cudaStream_t stream) {
  const Plan p = plan_cluster<T>(batch, hw, C, S);
  if (p.cluster == 0) return launch_stream<T>(x, w1, w2, out, batch, hw, C, S, stream);
  return launch_cluster<T>(x, w1, w2, out, batch, hw, C, S, p, stream);
}

template <typename T>
int describe(int batch, int hw, int C, int S, int* out) {
  const Plan p = plan_cluster<T>(batch, hw, C, S);
  out[0] = p.cluster;
  out[1] = p.samples;
  out[2] = p.cluster ? cluster_slots<T>(p) : 0;
  out[3] = static_cast<int>(p.smem);
  return out[2] < 0 ? -out[2] : 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int se_scale_forward(const void* x, const float* w1, const float* w2,
                                void* out, int batch, int hw, int C, int S,
                                int dtype, void* stream) {
  if (batch <= 0 || hw <= 0 || C <= 0 || C > 1024 || S <= 0 || S > kMaxS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w1, w2, out, batch, hw, C, S, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w1, w2, out, batch, hw, C, S, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The route se_scale_forward takes for (batch, hw, C, S, dtype): out[0] =
// CTAs per cluster (0 = streaming), out[1] = samples per group, out[2] =
// clusters the card runs at once (the persistent grid), out[3] = dynamic
// shared memory per CTA.
// Returns a cudaError_t.
extern "C" int se_scale_plan(int batch, int hw, int C, int S, int dtype, int* out) {
  if (batch <= 0 || hw <= 0 || C <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return describe<float>(batch, hw, C, S, out);
  if (dtype == 1) return describe<__nv_bfloat16>(batch, hw, C, S, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
