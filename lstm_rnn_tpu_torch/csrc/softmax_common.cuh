// What the classification tails share (softmax_ce.cu: logits in the
// kernel, K3; softmax_ce_wide.cu: logits from a product outside, K4;
// softmax_ce_plain.cu: the plain tail from materialized logits, K5): the
// reference's constants and safeExp, the vector load of a row and its
// width rule, the row reductions of a thread group that owns one row (K4f,
// K5f), and the fixed-order reduction of the per-row or per-block loss and
// count partials.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

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

// E consecutive elements of T as they lie in memory: one load of E *
// sizeof(T) bytes (aligned to it), converted to f32 on use
template <typename T, int E>
struct RowVec {
  static constexpr int kBytes = E * static_cast<int>(sizeof(T));
  unsigned u[kBytes >= 4 ? kBytes / 4 : 1];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kBytes == 16) {
      const uint4 q = *reinterpret_cast<const uint4*>(p);
      u[0] = q.x;
      u[1] = q.y;
      u[2] = q.z;
      u[3] = q.w;
    } else if constexpr (kBytes == 8) {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      u[0] = q.x;
      u[1] = q.y;
    } else if constexpr (kBytes == 4) {
      u[0] = *reinterpret_cast<const unsigned*>(p);
    } else {  // one bf16, in the high half: exact in f32
      u[0] = static_cast<unsigned>(*reinterpret_cast<const unsigned short*>(p))
             << 16;
    }
  }
  __device__ __forceinline__ void to_f32(float (&v)[E]) const {
    if constexpr (sizeof(T) == 4 || kBytes == 2) {
#pragma unroll
      for (int i = 0; i < E; ++i) v[i] = __uint_as_float(u[i]);
    } else {  // two bf16 a word, the first in the low half
#pragma unroll
      for (int i = 0; i < kBytes / 4; ++i) {
        v[2 * i] = __uint_as_float(u[i] << 16);
        v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
      }
    }
  }
};

// The widest vector (in elements of elem bytes, up to 16 bytes) that every
// row of a [rows, row_bytes / elem] array at base allows: the lowest set
// bit of (base | row bytes | 16), as make_view decides (K4f's loads; K5f's
// loads of the logits and stores of p)
inline int row_vec_elems(const void* base, size_t row_bytes, size_t elem) {
  const unsigned long long bits = reinterpret_cast<unsigned long long>(base) |
                                  static_cast<unsigned long long>(row_bytes) |
                                  16ull;
  return static_cast<int>((bits & (~bits + 1)) / elem);
}

// Reductions over the kWarps warps that own one row: one warp (kWarps ==
// 1: shuffles only, no shared memory, no barrier) or the whole block
// (kWarps = blockDim.x / 32: the warps' results meet in the kWarps-entry
// shared scratch). Every thread of the group gets the result, reduced in
// the same order in every group.

// min and max
template <int kWarps>
__device__ __forceinline__ void group_min_max(float& mn, float& mx,
                                              float* s_a, float* s_b) {
  for (int o = 16; o > 0; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  if constexpr (kWarps > 1) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) {
      s_a[warp] = mn;
      s_b[warp] = mx;
    }
    __syncthreads();
    mn = s_a[0];
    mx = s_b[0];
    for (int w = 1; w < kWarps; ++w) {
      mn = fminf(mn, s_a[w]);
      mx = fmaxf(mx, s_b[w]);
    }
    __syncthreads();  // the scratch is reused by the next reduction
  }
}

// sum
template <int kWarps>
__device__ __forceinline__ float group_sum(float v, float* s_a) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if constexpr (kWarps > 1) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) s_a[warp] = v;
    __syncthreads();
    v = s_a[0];
    for (int w = 1; w < kWarps; ++w) v += s_a[w];
    __syncthreads();
  }
  return v;
}

// first argmax: the largest value, ties to the lowest index
template <int kWarps>
__device__ __forceinline__ int group_argmax(float best, int arg, float* s_a,
                                            int* s_i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oa = __shfl_xor_sync(0xffffffffu, arg, o);
    if (ob > best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
  if constexpr (kWarps > 1) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) {
      s_a[warp] = best;
      s_i[warp] = arg;
    }
    __syncthreads();
    best = s_a[0];
    arg = s_i[0];
    for (int w = 1; w < kWarps; ++w)
      if (s_a[w] > best || (s_a[w] == best && s_i[w] < arg)) {
        best = s_a[w];
        arg = s_i[w];
      }
    __syncthreads();
  }
  return arg;
}

// the sum of v and the first argmax of best (the largest value, ties to
// the lowest index) in one reduction; the sum in group_sum's order
template <int kWarps>
__device__ __forceinline__ float group_sum_argmax(float v, float& best,
                                                  int& arg, float* s_a,
                                                  float* s_b, int* s_i) {
  for (int o = 16; o > 0; o >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, o);
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oa = __shfl_xor_sync(0xffffffffu, arg, o);
    if (ob > best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
  if constexpr (kWarps > 1) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) {
      s_a[warp] = v;
      s_b[warp] = best;
      s_i[warp] = arg;
    }
    __syncthreads();
    v = s_a[0];
    best = s_b[0];
    arg = s_i[0];
    for (int w = 1; w < kWarps; ++w) {
      v += s_a[w];
      if (s_b[w] > best || (s_b[w] == best && s_i[w] < arg)) {
        best = s_b[w];
        arg = s_i[w];
      }
    }
    __syncthreads();
  }
  return v;
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
