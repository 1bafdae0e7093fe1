// Plain classification tail (CURRENNT softmax -> multiclass cross-entropy
// -> accuracy count) from materialized logits, for NVIDIA Hopper (sm_90a).
//
// Replaces lstm_rnn_tpu/ops/softmax_ce.py::_fwd_kernel and ::_bwd_kernel
// (behind softmax_ce_fused): the tail that --remat_blocks training runs,
// where the logits a = h . W + bias_mult * b are one f32 product outside,
// as in the JAX package. Forward (K5f), per row of a [N, S] f32 with
// target class tc (-1 = dummy frame):
//
//   off  = (min(a) + max(max(a), REAL_MIN)) / 2,  e = safeExp(a - off)
//   p    = e / sum(e)
//   loss = sum over rows with tc >= 0 of -log(max(p[tc], REAL_MIN))
//   cnt  = number of rows with tc >= 0 whose first argmax of p is tc
//
// and p [N, S] in the storage dtype (f32, or bf16 in bfloat16 mode) when
// the caller trains (want_p); the argmax is taken over the f32 p, before
// it is rounded for the store. Backward (K5b), from the STORED p, with g
// the loss cotangent, p_t = p[tc], inv = -1/max(p_t, REAL_MIN), s = p_t *
// inv:
//
//   dz = p (onehot(tc) inv - s) valid g     (f32, the logits' dtype)
//
// The logits' product and its gradient stay outside, as in the JAX package.
//
// Design and what bounds it on this card. Both kernels give one row to a
// group of threads: one warp for S <= 1024 (eight rows per 256-thread
// block), the whole block above (the LVCSR recipe's 10,112 states). K5f
// makes three passes over its row (min/max, exp sum, then p, its store and
// its first argmax) with softmax_common.cuh's group reductions, the ones
// K4f uses; the first pass reads the row from device memory, the next two
// mostly from L1/L2. Loss and count are per-row partials added in a fixed
// order (no float atomics). K5f must read a once and write p once, K5b
// read p once and write dz once: bytes bound both (N = 25,000, S = 183 in
// f32 is 36.6 MB each way; S = 10,112 is 2.02 GB). K5b reads its row's
// p_t once and broadcasts it to the group; no reduction is left.
//
// Launch rules: the entry points launch on the caller's stream, allocate
// nothing, never synchronise, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

#include "gemm.cuh"
#include "softmax_common.cuh"

namespace {

constexpr int kPlainThreads = 256;
// above this many classes a row takes the whole block, else one warp
constexpr int kWarpRowMaxS = 1024;

// the row this thread's group owns, and the thread's index in the group
template <int kWarps>
__device__ __forceinline__ int group_row(int& tid) {
  constexpr int kGroup = kWarps * 32;
  tid = threadIdx.x % kGroup;
  return blockIdx.x * (kPlainThreads / kGroup) + threadIdx.x / kGroup;
}

template <typename P, int kWarps>
__global__ void __launch_bounds__(kPlainThreads)
    plain_fwd_kernel(const float* __restrict__ a, const int* __restrict__ tc,
                     P* __restrict__ p_out, float* __restrict__ part_loss,
                     int* __restrict__ part_cnt, int N, int S) {
  constexpr int kGroup = kWarps * 32;
  __shared__ float s_a[kWarps], s_b[kWarps];
  __shared__ int s_i[kWarps];
  int tid;
  const int row = group_row<kWarps>(tid);
  // a whole group leaves together (kWarps > 1: one row per block, and the
  // grid has exactly N blocks)
  if (row >= N) return;
  const float* ar = a + static_cast<size_t>(row) * S;

  float mn = CUDART_INF_F, mx = -CUDART_INF_F;
  for (int s = tid; s < S; s += kGroup) {
    const float v = ar[s];
    mn = fminf(mn, v);
    mx = fmaxf(mx, v);
  }
  group_min_max<kWarps>(mn, mx, s_a, s_b);
  // the reference's max search starts at FLT_MIN (SoftmaxLayer.cu:60)
  const float off = 0.5f * (mn + fmaxf(mx, kRealMin));

  float sum = 0.0f;
  for (int s = tid; s < S; s += kGroup) sum += safe_exp(ar[s] - off);
  sum = group_sum<kWarps>(sum, s_a);

  // p, its store and its first argmax (over the f32 p: two different e can
  // round to the same p, and a bf16 store would tie more)
  P* pr = p_out == nullptr ? nullptr : p_out + static_cast<size_t>(row) * S;
  float best = -CUDART_INF_F;
  int arg = S;
  for (int s = tid; s < S; s += kGroup) {
    const float p = safe_exp(ar[s] - off) / sum;
    if (pr != nullptr) pr[s] = f32_to<P>(p);
    if (p > best) {
      best = p;
      arg = s;
    }
  }
  arg = group_argmax<kWarps>(best, arg, s_a, s_i);

  if (tid == 0) {
    const int t = tc[row];
    // the same expression as the p above: the same value
    const float pt = (t >= 0 && t < S) ? safe_exp(ar[t] - off) / sum : 0.0f;
    part_loss[row] = t >= 0 ? -logf(fmaxf(pt, kRealMin)) : 0.0f;
    part_cnt[row] = (t >= 0 && arg == t) ? 1 : 0;
  }
}

// dz [N, S] f32 from the stored p [N, S] (storage dtype); g is the loss
// cotangent (one f32 on the device)
template <typename P, int kWarps>
__global__ void __launch_bounds__(kPlainThreads)
    plain_bwd_kernel(const P* __restrict__ p, const int* __restrict__ tc,
                     const float* __restrict__ g, float* __restrict__ dz,
                     int N, int S) {
  constexpr int kGroup = kWarps * 32;
  int tid;
  const int row = group_row<kWarps>(tid);
  if (row >= N) return;
  const size_t base = static_cast<size_t>(row) * S;
  const int t = tc[row];
  const float pt = (t >= 0 && t < S) ? as_f32(p[base + t]) : 0.0f;
  const float inv = -1.0f / fmaxf(pt, kRealMin);
  const float srow = pt * inv;
  const float valid = t >= 0 ? 1.0f : 0.0f;
  const float gv = g[0];
  for (int s = tid; s < S; s += kGroup) {
    const float oh = s == t ? 1.0f : 0.0f;
    float v = as_f32(p[base + s]) * (oh * inv - srow);
    v = v * valid;
    dz[base + s] = v * gv;
  }
}

// blocks for N rows: one per row for block-wide groups, else eight rows
// per block
inline int plain_blocks(int N, int S) {
  const int rows = S > kWarpRowMaxS ? 1 : kPlainThreads / 32;
  return (N + rows - 1) / rows;
}

template <typename P>
cudaError_t plain_fwd(const float* a, const int* tc, void* p, float* part_loss,
                      int* part_cnt, float* loss, int* cnt, int N, int S,
                      cudaStream_t stream) {
  const int grid = plain_blocks(N, S);
  if (S > kWarpRowMaxS)
    plain_fwd_kernel<P, kPlainThreads / 32><<<grid, kPlainThreads, 0,
                                              stream>>>(
        a, tc, static_cast<P*>(p), part_loss, part_cnt, N, S);
  else
    plain_fwd_kernel<P, 1><<<grid, kPlainThreads, 0, stream>>>(
        a, tc, static_cast<P*>(p), part_loss, part_cnt, N, S);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_ce_reduce(part_loss, part_cnt, N, loss, cnt, stream);
}

template <typename P>
cudaError_t plain_bwd(const void* p, const int* tc, const float* g, float* dz,
                      int N, int S, cudaStream_t stream) {
  const int grid = plain_blocks(N, S);
  if (S > kWarpRowMaxS)
    plain_bwd_kernel<P, kPlainThreads / 32><<<grid, kPlainThreads, 0,
                                              stream>>>(
        static_cast<const P*>(p), tc, g, dz, N, S);
  else
    plain_bwd_kernel<P, 1><<<grid, kPlainThreads, 0, stream>>>(
        static_cast<const P*>(p), tc, g, dz, N, S);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward (K5f). a [N, S] f32; tc [N] int32. Outputs: p [N, S] in f32
// (bf16 = 0) or bf16 (bf16 = 1), or null (no store); loss [1] f32, cnt [1]
// int32. Scratch: part_loss [N] f32, part_cnt [N] int32.
int softmax_ce_plain_fwd(const float* a, const int* tc, void* p,
                         float* part_loss, int* part_cnt, float* loss,
                         int* cnt, int N, int S, int bf16, int device,
                         cudaStream_t stream) {
  if (N < 1 || S < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bf16)
    return plain_fwd<__nv_bfloat16>(a, tc, p, part_loss, part_cnt, loss, cnt,
                                    N, S, stream);
  return plain_fwd<float>(a, tc, p, part_loss, part_cnt, loss, cnt, N, S,
                          stream);
}

// Backward (K5b). p [N, S] as the forward stored it (bf16 = 1: bf16, else
// f32); tc [N] int32; g [1] f32 (the loss cotangent). Output: dz [N, S]
// f32.
int softmax_ce_plain_bwd(const void* p, const int* tc, const float* g,
                         float* dz, int N, int S, int bf16, int device,
                         cudaStream_t stream) {
  if (N < 1 || S < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bf16) return plain_bwd<__nv_bfloat16>(p, tc, g, dz, N, S, stream);
  return plain_bwd<float>(p, tc, g, dz, N, S, stream);
}

}  // extern "C"
