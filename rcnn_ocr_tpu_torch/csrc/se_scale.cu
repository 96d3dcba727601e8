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
// Design: one block per sample.  x is NHWC and channel-contiguous, so
// neighbouring threads read neighbouring channels (coalesced).  The block
//   1. sums x over H*W per channel in fp32 (split into `split` interleaved
//      partial sums when C is narrower than the block), into shared memory;
//   2. runs the C -> C/16 -> C MLP in fp32 out of shared memory
//      (C <= 1024 and C/16 <= 64 floats, a few KB);
//   3. writes x * gate in x's dtype (gate rounded to x's dtype first, as the
//      reference multiplies in x's dtype).
// x is read twice (step 1 and step 3).  At the main path's slabs
// (8x32x256 and 4x16x512 per sample) the second read mostly hits L2.
//
// Plain C interface, loaded with ctypes: no PyTorch headers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
se_scale_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ w2, T* __restrict__ out,
                int hw, int C, int S, int split) {
  extern __shared__ float smem[];
  float* part = smem;                  // [split * C] partial channel sums
  float* mean = part + split * C;      // [C]
  float* hid = mean + C;               // [S]
  float* gate = hid + S;               // [C]

  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * hw * C;
  const T* xb = x + base;
  T* ob = out + base;

  // 1. per-channel sums over H*W; slot k covers channel k % C and every
  //    split-th pixel starting at k / C
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

  // 2a. hid = relu(mean @ w1): one warp per hidden unit, lanes over C
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  for (int j = warp; j < S; j += n_warps) {
    float acc = 0.f;
    for (int c = lane; c < C; c += 32) acc = fmaf(mean[c], w1[c * S + j], acc);
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) hid[j] = fmaxf(acc, 0.f);
  }
  __syncthreads();

  // 2b. gate = sigmoid(hid @ w2), rounded to x's dtype
  for (int c = tid; c < C; c += blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < S; ++j) acc = fmaf(hid[j], w2[j * C + c], acc);
    gate[c] = to_f32(from_f32<T>(1.f / (1.f + expf(-acc))));
  }
  __syncthreads();

  // 3. out = x * gate
  const int n = hw * C;
  for (int k = tid; k < n; k += blockDim.x) {
    ob[k] = from_f32<T>(to_f32(xb[k]) * gate[k % C]);
  }
}

template <typename T>
int launch(const void* x, const float* w1, const float* w2, void* out,
           int batch, int hw, int C, int S, cudaStream_t stream) {
  int split = kThreads / C;
  if (split < 1) split = 1;
  if (split > hw) split = hw;
  const size_t smem = sizeof(float) * (static_cast<size_t>(split) * C + 2 * C + S);
  se_scale_kernel<T><<<batch, kThreads, smem, stream>>>(
      static_cast<const T*>(x), w1, w2, static_cast<T*>(out), hw, C, S, split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int se_scale_forward(const void* x, const float* w1, const float* w2,
                                void* out, int batch, int hw, int C, int S,
                                int dtype, void* stream) {
  if (batch <= 0 || hw <= 0 || C <= 0 || C > 1024 || S <= 0 || S > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w1, w2, out, batch, hw, C, S, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w1, w2, out, batch, hw, C, S, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
