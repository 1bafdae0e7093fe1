// A tiled shared-memory GEMM with transpose flags, and a deterministic
// reduction of partial sums, for the training kernels (lstm_bwd.cu,
// softmax_ce.cu). The TPU kernels compute these matrix products in their
// own bodies (dW_in = x^T . da, dW_rec = h_prev^T . da, dx = da . W_in^T,
// logits = h . W, dh = dz . W^T, dW = h^T . dz); here they run in this
// hand-written kernel, on the FP32 pipes (bf16 operands are exact in f32).
//
// An operand is a View: element (r, c) of a row-major matrix with leading
// dimension `ld`, rows shifted by `shift` (the scan-previous h of dW_rec),
// zero outside [0, rows) x [0, cols). A(m, k) = a(m, k), or a(k, m) when
// transposed; B(k, n) = b(k, n), or b(n, k) when transposed. Each tile is
// loaded along the operand's contiguous axis, so neighbouring threads read
// neighbouring addresses.
//
// Split-K (long reductions over T*B rows) writes one partial product per
// split; sum_partials adds them in a fixed order: the result does not
// depend on scheduling, and no float atomics are used.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kGemmTileM = 64;
constexpr int kGemmTileN = 64;
constexpr int kGemmTileK = 16;
constexpr int kGemmThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T f32_to(float v);
template <>
__device__ __forceinline__ float f32_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 f32_to<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T's precision, returned as f32
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return as_f32(f32_to<T>(v));
}

template <typename T>
struct View {
  const T* p;
  long long ld;
  int rows, cols, shift;
  __device__ __forceinline__ float operator()(int r, int c) const {
    const int rr = r + shift;
    if (rr < 0 || rr >= rows || c >= cols) return 0.0f;
    return as_f32(p[static_cast<size_t>(rr) * ld + c]);
  }
};

template <typename T>
__host__ __device__ View<T> make_view(const void* p, long long ld, int rows,
                                      int cols, int shift = 0) {
  return View<T>{static_cast<const T*>(p), ld, rows, cols, shift};
}

using TileA = float[kGemmTileK][kGemmTileM + 4];  // k-major
using TileB = float[kGemmTileK][kGemmTileN + 4];

// acc += A[m0:m0+64, k_begin:k_end] . B[k_begin:k_end, n0:n0+64] for this
// thread's 4 x 4 outputs (rows tm.., columns tn.. of the tile). Every
// thread of the block must call it (it synchronises).
template <bool kTA, bool kTB, typename TA, typename TB>
__device__ __forceinline__ void tile_mma(const View<TA>& a,
                                         const View<TB>& b, int m0, int n0,
                                         int k_begin, int k_end,
                                         float (&acc)[4][4], TileA& as,
                                         TileB& bs) {
  const int tid = threadIdx.x;
  const int tm = (tid / 16) * 4;
  const int tn = (tid % 16) * 4;
  for (int k0 = k_begin; k0 < k_end; k0 += kGemmTileK) {
    for (int i = tid; i < kGemmTileM * kGemmTileK; i += kGemmThreads) {
      int mm, kk;
      if (kTA) {
        kk = i / kGemmTileM;
        mm = i % kGemmTileM;
      } else {
        mm = i / kGemmTileK;
        kk = i % kGemmTileK;
      }
      const int k = k0 + kk;
      as[kk][mm] = k < k_end ? (kTA ? a(k, m0 + mm) : a(m0 + mm, k)) : 0.0f;
    }
    for (int i = tid; i < kGemmTileK * kGemmTileN; i += kGemmThreads) {
      int nn, kk;
      if (kTB) {
        nn = i / kGemmTileK;
        kk = i % kGemmTileK;
      } else {
        kk = i / kGemmTileN;
        nn = i % kGemmTileN;
      }
      const int k = k0 + kk;
      bs[kk][nn] = k < k_end ? (kTB ? b(n0 + nn, k) : b(k, n0 + nn)) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGemmTileK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][tm]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][tn]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Operands of one launch: up to two (A, B) pairs, one per direction.
template <typename TA, typename TB>
struct GemmArgs {
  View<TA> a[2];
  View<TB> b[2];
  int M, N, K;
  // grid.z = outputs * nsplit: output d = z / nsplit takes pair d and the
  // K range of split z % nsplit. ngroups > 1 (one output, nsplit = 1): the
  // result is sum over g of round_to<R>(A_g . B_g), each pair's product
  // rounded first (dx of a BLSTM layer: one plane per direction).
  int nsplit;
  int ngroups;
};

template <typename TA, bool kTA, typename TB, bool kTB, typename R,
          class Epi>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_kernel(GemmArgs<TA, TB> g, Epi epi) {
  __shared__ __align__(16) TileA as;
  __shared__ __align__(16) TileB bs;
  const int z = blockIdx.z;
  const int d = z / g.nsplit;
  const int split = z % g.nsplit;
  const int kchunk = (g.K + g.nsplit - 1) / g.nsplit;
  const int k_begin = split * kchunk;
  const int k_end = min(g.K, k_begin + kchunk);
  const int m0 = blockIdx.x * kGemmTileM;
  const int n0 = blockIdx.y * kGemmTileN;
  float total[4][4] = {};
  for (int gi = 0; gi < g.ngroups; ++gi) {
    const int v = g.ngroups > 1 ? gi : d;
    float acc[4][4] = {};
    tile_mma<kTA, kTB>(g.a[v], g.b[v], m0, n0, k_begin, k_end, acc, as, bs);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) total[i][j] += round_to<R>(acc[i][j]);
  }
  const int tm = (threadIdx.x / 16) * 4;
  const int tn = (threadIdx.x % 16) * 4;
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tm + i;
    if (m >= g.M) continue;
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn + j;
      if (n < g.N) epi(d, split, m, n, total[i][j]);
    }
  }
}

// out[m, n] (row-major, ld N) in the output type
template <typename Out>
struct EpiStore {
  Out* out;
  int N;
  __device__ __forceinline__ void operator()(int, int, int m, int n,
                                             float v) const {
    out[static_cast<size_t>(m) * N + n] = f32_to<Out>(v);
  }
};

// part[split * split_stride + d * d_stride + m * N + n] = v (f32)
struct EpiPartial {
  float* part;
  long long split_stride, d_stride;
  int N;
  __device__ __forceinline__ void operator()(int d, int split, int m, int n,
                                             float v) const {
    part[split * split_stride + d * d_stride + static_cast<long long>(m) * N +
         n] = v;
  }
};

template <typename TA, bool kTA, typename TB, bool kTB, typename R,
          class Epi>
cudaError_t launch_gemm(const GemmArgs<TA, TB>& g, int outputs, Epi epi,
                        cudaStream_t stream) {
  const dim3 grid((g.M + kGemmTileM - 1) / kGemmTileM,
                  (g.N + kGemmTileN - 1) / kGemmTileN, outputs * g.nsplit);
  gemm_kernel<TA, kTA, TB, kTB, R, Epi>
      <<<grid, kGemmThreads, 0, stream>>>(g, epi);
  return cudaGetLastError();
}

// K splits for a reduction of length K: about one split per 1024 rows,
// at most 32 (the partial buffer holds nsplit copies of the output)
inline int gemm_splits(int K) {
  int s = K / 1024;
  return s < 1 ? 1 : (s > 32 ? 32 : s);
}

// out[i] = (sum over s < ns of part[s * L + i]) * (i % row >= scale_from ?
// scale : 1), the sum taken in order s = 0, 1, ...
__global__ void sum_partials(const float* __restrict__ part, int ns,
                             long long L, float* __restrict__ out,
                             long long row, long long scale_from,
                             float scale) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < L; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < ns; ++k) s += part[k * L + i];
    out[i] = (i % row) >= scale_from ? s * scale : s;
  }
}

cudaError_t launch_sum_partials(const float* part, int ns, long long L,
                                float* out, long long row,
                                long long scale_from, float scale,
                                cudaStream_t stream) {
  long long blocks = (L + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  sum_partials<<<static_cast<int>(blocks), 256, 0, stream>>>(
      part, ns, L, out, row, scale_from, scale);
  return cudaGetLastError();
}

}  // namespace
