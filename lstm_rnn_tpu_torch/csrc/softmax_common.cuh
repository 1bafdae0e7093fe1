// What the two classification tails share (softmax_ce.cu: logits in the
// kernel, K3; softmax_ce_wide.cu: logits from a product outside, K4): the
// reference's constants and safeExp, and the fixed-order reduction of the
// per-block loss and count partials.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kCeExpLimit = 88.722839f;
constexpr float kRealMin = 1.1754944e-38f;
constexpr float kRealMax = 3.4028235e38f;
constexpr float kLogZero = -1e30f;

__device__ __forceinline__ float safe_exp(float x) {
  if (x <= kLogZero) return 0.0f;
  if (x >= kCeExpLimit) return kRealMax;
  return expf(x);
}

// loss[0] = sum of part_loss, cnt[0] = sum of part_cnt, in a fixed order
__global__ void ce_reduce_kernel(const float* __restrict__ part_loss,
                                 const int* __restrict__ part_cnt, int n,
                                 float* __restrict__ loss,
                                 int* __restrict__ cnt) {
  __shared__ float sl[256];
  __shared__ int sc[256];
  float l = 0.0f;
  int c = 0;
  for (int i = threadIdx.x; i < n; i += 256) {
    l += part_loss[i];
    c += part_cnt[i];
  }
  sl[threadIdx.x] = l;
  sc[threadIdx.x] = c;
  __syncthreads();
  for (int s = 128; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      sl[threadIdx.x] += sl[threadIdx.x + s];
      sc[threadIdx.x] += sc[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    loss[0] = sl[0];
    cnt[0] = sc[0];
  }
}

cudaError_t launch_ce_reduce(const float* part_loss, const int* part_cnt,
                             int n, float* loss, int* cnt,
                             cudaStream_t stream) {
  ce_reduce_kernel<<<1, 256, 0, stream>>>(part_loss, part_cnt, n, loss, cnt);
  return cudaGetLastError();
}

}  // namespace
