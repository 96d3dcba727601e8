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
// FLOP, on CUDA cores since the kernel computes in fp32), bytes at small
// batch (xs in, ys out, w_hh once).  What actually limits this simple design
// is re-reading w_hh[dir] (1 MiB fp32 at H=256) from L2 on every step.
//
// Design: the TPU's sequential time axis of the grid becomes a loop inside
// the block.  Grid = (2 directions) x ceil(B / kRows) batch tiles; batch
// rows and directions are independent, so no block ever waits on another.
// A block of H threads owns kRows batch rows for all T steps.  Thread j owns
// hidden unit j of each of its rows: it accumulates the four gate columns
// j, H+j, 2H+j, 3H+j for kRows rows (16 fp32 accumulators), so the cell
// update needs no exchange between threads and each w_hh value read serves
// kRows rows.  h of the tile sits in shared memory (read as a broadcast),
// c sits in registers; two __syncthreads() separate the steps.
//
// Plain C interface, loaded with ctypes: no PyTorch headers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kRows = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

template <typename WT>
__global__ void bilstm_scan_kernel(const float* __restrict__ xs,
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
int launch(const float* xs, const void* w_hh, float* ys, int T, int B, int H,
           cudaStream_t stream) {
  const dim3 grid(2, (B + kRows - 1) / kRows);
  const size_t smem = sizeof(float) * kRows * H;
  bilstm_scan_kernel<WT><<<grid, H, smem, stream>>>(
      xs, static_cast<const WT*>(w_hh), ys, T, B, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w_dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int bilstm_scan_forward(const float* xs, const void* w_hh, float* ys,
                                   int T, int B, int H, int w_dtype, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H > 1024 || (B + kRows - 1) / kRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dtype == 0) return launch<float>(xs, w_hh, ys, T, B, H, s);
  if (w_dtype == 1) return launch<__nv_bfloat16>(xs, w_hh, ys, T, B, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
