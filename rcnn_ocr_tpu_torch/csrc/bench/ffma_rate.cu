// FFMA issue rate of two code shapes on the card (not a kernel of the port).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//       -o build/ffma_rate rcnn_ocr_tpu_torch/csrc/bench/ffma_rate.cu && build/ffma_rate
//
// "outer" is the product loop of csrc/bilstm_scan.cu's resident kernel with
// every operand in registers: acc[r][g] = fma(h[r], w[g], acc[r][g]) over
// 4 rows x 4 gates, h and w changing every step.  "const" is 16 independent
// chains a = fma(a, b, c) with b and c fixed.  Prints, for 132 blocks of
// 256-1024 threads, TFLOP/s and warp-FFMAs per clock per scheduler
// (clock64 of block 0); 1.0 is the SM's peak.  The gap between the two is
// what the product loop can gain without changing its arithmetic.

#include <cstdio>

#include <cuda_runtime.h>

namespace {

constexpr int kSteps = 8;  // unrolled steps per loop trip

__global__ void ffma_outer(float* out, long long* cycles, int iters) {
  float acc[4][4], h[4], w[4];
  for (int r = 0; r < 4; ++r) {
    h[r] = threadIdx.x * 1e-3f + r;
    w[r] = 1e-3f * r;
    for (int g = 0; g < 4; ++g) acc[r][g] = 0.f;
  }
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = fmaf(h[r], w[g], acc[r][g]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        h[r] += 1e-7f;
        w[r] -= 1e-7f;
      }
    }
  }
  const long long t1 = clock64();
  float s = 0.f;
  for (int r = 0; r < 4; ++r) {
    for (int g = 0; g < 4; ++g) s += acc[r][g];
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cycles = t1 - t0;
}

__global__ void ffma_const(float* out, long long* cycles, int iters) {
  float a[16];
  for (int j = 0; j < 16; ++j) a[j] = threadIdx.x + j;
  const float b = 0.999f, c = 1e-3f;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
#pragma unroll
      for (int j = 0; j < 16; ++j) a[j] = fmaf(a[j], b, c);
    }
  }
  const long long t1 = clock64();
  float s = 0.f;
  for (int j = 0; j < 16; ++j) s += a[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cycles = t1 - t0;
}

}  // namespace

int main() {
  const int blocks = 132, iters = 4096;
  float* out = nullptr;
  long long* cycles = nullptr;
  if (cudaMalloc(&out, sizeof(float) * blocks * 1024) != cudaSuccess ||
      cudaMalloc(&cycles, sizeof(long long)) != cudaSuccess) {
    std::printf("cudaMalloc failed\n");
    return 1;
  }
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int threads : {256, 512, 1024}) {
    for (int which = 0; which < 2; ++which) {
      auto kernel = which ? ffma_const : ffma_outer;
      kernel<<<blocks, threads>>>(out, cycles, iters);  // warm-up
      cudaEventRecord(e0);
      kernel<<<blocks, threads>>>(out, cycles, iters);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) {
        std::printf("launch failed: %s\n", cudaGetErrorString(err));
        return 1;
      }
      float ms = 0.f;
      long long c = 0;
      cudaEventElapsedTime(&ms, e0, e1);
      cudaMemcpy(&c, cycles, sizeof(c), cudaMemcpyDeviceToHost);
      const double ffma_per_thread = 16.0 * kSteps * iters;
      const double warps_per_scheduler = threads / 32 / 4.0;
      std::printf("%s, %d threads x %d blocks: %.2f TFLOP/s, %.3f warp-FFMA per clock per "
                  "scheduler\n",
                  which ? "const" : "outer", threads, blocks,
                  2 * ffma_per_thread * threads * blocks / ms / 1e9,
                  ffma_per_thread * warps_per_scheduler / c);
    }
  }
  cudaFree(out);
  cudaFree(cycles);
  return 0;
}
