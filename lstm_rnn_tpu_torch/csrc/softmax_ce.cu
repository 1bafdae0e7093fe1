// Fused classification tail (identity feedforward -> CURRENNT softmax ->
// multiclass cross-entropy -> accuracy count), for NVIDIA Hopper (sm_90a).
//
// Replaces lstm_rnn_tpu/ops/softmax_ce.py::_fwd_proj_kernel and
// ::_bwd_proj_kernel (behind softmax_ce_proj_fused). Forward, per row of
// h [N, P] with target class tc (-1 = dummy frame):
//
//   a    = h . W + bias_mult * b                          (S logits)
//   off  = (min(a) + max(max(a), REAL_MIN)) / 2,  e = safeExp(a - off)
//   p    = e / sum(e)
//   loss = sum over rows with tc >= 0 of -log(max(p[tc], REAL_MIN))
//   cnt  = number of rows with tc >= 0 whose first argmax of p is tc
//
// and p [N, S] in the storage dtype when the caller trains (want_p).
// Backward, with g the loss cotangent, p_t = p[tc], inv = -1/max(p_t,
// REAL_MIN), s = p_t * inv:
//
//   dz = p (onehot(tc) inv - s) valid g,   dzc = dz in the storage dtype
//   dh = dzc . W^T,  dW = h^T . dzc,  db = bias_mult * sum over rows of dz
//
// float32 mode: true f32. bfloat16 mode (as the JAX kernel): h and W in
// bf16, f32 accumulation, p stored in bf16, dz rounded to bf16 before the
// two products (db sums the unrounded dz), dh stored in bf16. Widths are
// exact (no 128-lane padding of S or P).
//
// Design and what bounds it on this card. The forward is one kernel per
// block of 64 rows: the [64, S] logits tile is computed by tile_mma, a
// tiled product on the FP32 pipes, into shared memory, then one warp per
// row takes min, max, the exp sum and the argmax with shuffles; the
// logits never reach device
// memory, as in the TPU kernel. Loss and count are per-block partials,
// added in a fixed order by a one-block reduction: no float atomics, the
// same sum on every run. At N = 25,000, P = 250, S = 183 the product
// (2.3 GFLOP) bounds it; the kernel runs it on the FP32 pipes, not the
// tensor cores. The backward writes dzc once to device memory (18 MB in
// f32; the TPU kernel keeps it in VMEM) with per-block db partials, then
// runs dh and split-K dW through gemm.cuh's GEMM (wgmma in bf16), and sums
// the partials in order.
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

// K3f's [64, S] logits tile: a tiled shared-memory product on the FP32 pipes
// (the engine's first GEMM, kept here for K3f until its own redesign)
constexpr int kGemmTileM = 64;
constexpr int kGemmTileN = 64;
constexpr int kGemmTileK = 16;
constexpr int kGemmThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

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

constexpr int kCeRows = 64;  // rows per block (the GEMM tile's M)
constexpr int kCeWarps = kGemmThreads / 32;

// the padded logits width held in shared memory per row (ops/softmax_ce.py
// proj_tail_fits reproduces the block's size, kCeRows * ce_width(S) * 4)
__host__ __device__ inline int ce_width(int S) {
  return (S + kGemmTileN - 1) / kGemmTileN * kGemmTileN;
}

template <typename In, typename POut>
__global__ void __launch_bounds__(kGemmThreads)
    ce_fwd_kernel(const In* __restrict__ h, const In* __restrict__ w,
                  const float* __restrict__ b, const int* __restrict__ tc,
                  POut* __restrict__ p_out, float* __restrict__ part_loss,
                  int* __restrict__ part_cnt, int N, int P, int S,
                  float bias_mult) {
  extern __shared__ __align__(16) float lg[];  // [kCeRows][ce_width(S)]
  __shared__ __align__(16) TileA as;
  __shared__ __align__(16) TileB bs;
  __shared__ float warp_loss[kCeWarps];
  __shared__ int warp_cnt[kCeWarps];
  const int SW = ce_width(S);
  const int m0 = blockIdx.x * kCeRows;
  const View<In> hv = make_view<In>(h, P, N, P);
  const View<In> wv = make_view<In>(w, S, P, S);
  const int tm = (threadIdx.x / 16) * 4;
  const int tn = (threadIdx.x % 16) * 4;
  for (int n0 = 0; n0 < S; n0 += kGemmTileN) {
    float acc[4][4] = {};
    tile_mma<false, false>(hv, wv, m0, n0, 0, P, acc, as, bs);
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tn + j;
        // the bias product is rounded on its own, as the reference adds
        // bias_mult * b to the finished product
        lg[(tm + i) * SW + n] =
            n < S ? acc[i][j] + __fmul_rn(bias_mult, b[n]) : 0.0f;
      }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float wloss = 0.0f;
  int wcnt = 0;
  for (int r = warp; r < kCeRows; r += kCeWarps) {
    const int gm = m0 + r;
    if (gm >= N) break;
    float* a = lg + r * SW;
    float mn = CUDART_INF_F, mx = -CUDART_INF_F;
    for (int s = lane; s < S; s += 32) {
      mn = fminf(mn, a[s]);
      mx = fmaxf(mx, a[s]);
    }
    for (int o = 16; o > 0; o >>= 1) {
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    // the reference's max search starts at FLT_MIN (SoftmaxLayer.cu:60)
    const float off = 0.5f * (mn + fmaxf(mx, kRealMin));
    float sum = 0.0f;
    for (int s = lane; s < S; s += 32) {
      const float e = safe_exp(a[s] - off);
      a[s] = e;
      sum += e;
    }
    __syncwarp();  // every lane reads a[tc] below
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    // p and its first argmax (ties to the lowest index)
    float best = -CUDART_INF_F;
    int arg = S;
    for (int s = lane; s < S; s += 32) {
      const float p = a[s] / sum;
      if (p_out != nullptr)
        p_out[static_cast<size_t>(gm) * S + s] = f32_to<POut>(p);
      if (p > best) {
        best = p;
        arg = s;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oa = __shfl_xor_sync(0xffffffffu, arg, o);
      if (ob > best || (ob == best && oa < arg)) {
        best = ob;
        arg = oa;
      }
    }
    const int t = tc[gm];
    if (t >= 0) {
      const float pt = t < S ? a[t] / sum : 0.0f;
      wloss += -logf(fmaxf(pt, kRealMin));
      wcnt += arg == t ? 1 : 0;
    }
  }
  if (lane == 0) {
    warp_loss[warp] = wloss;
    warp_cnt[warp] = wcnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float l = 0.0f;
    int c = 0;
    for (int w2 = 0; w2 < kCeWarps; ++w2) {
      l += warp_loss[w2];
      c += warp_cnt[w2];
    }
    part_loss[blockIdx.x] = l;
    part_cnt[blockIdx.x] = c;
  }
}

// dzc [N, S] (storage dtype) and per-block db partials [nblk, S] from the
// stored p; g is the loss cotangent (one f32 on the device)
template <typename PT>
__global__ void __launch_bounds__(kGemmThreads)
    ce_dz_kernel(const PT* __restrict__ p, const int* __restrict__ tc,
                 const float* __restrict__ g, PT* __restrict__ dz,
                 float* __restrict__ db_part, int N, int S) {
  __shared__ float inv_s[kCeRows], sv_s[kCeRows], valid_s[kCeRows];
  __shared__ int tc_s[kCeRows];
  const int m0 = blockIdx.x * kCeRows;
  const int nr = min(kCeRows, N - m0);
  if (threadIdx.x < nr) {
    const int gm = m0 + threadIdx.x;
    const int t = tc[gm];
    const float pt =
        (t >= 0 && t < S) ? as_f32(p[static_cast<size_t>(gm) * S + t]) : 0.0f;
    const float inv = -1.0f / fmaxf(pt, kRealMin);
    inv_s[threadIdx.x] = inv;
    sv_s[threadIdx.x] = pt * inv;
    valid_s[threadIdx.x] = t >= 0 ? 1.0f : 0.0f;
    tc_s[threadIdx.x] = t;
  }
  __syncthreads();
  const float gv = g[0];
  for (int col = threadIdx.x; col < S; col += kGemmThreads) {
    float dbs = 0.0f;
    for (int r = 0; r < nr; ++r) {
      const size_t i = static_cast<size_t>(m0 + r) * S + col;
      const float oh = col == tc_s[r] ? 1.0f : 0.0f;
      float v = as_f32(p[i]) * (oh * inv_s[r] - sv_s[r]);
      v = v * valid_s[r];
      v = v * gv;
      dz[i] = f32_to<PT>(v);
      dbs += v;
    }
    db_part[static_cast<size_t>(blockIdx.x) * S + col] = dbs;
  }
}

template <typename T>
cudaError_t ce_fwd(const void* h, const void* w, const float* b,
                   const int* tc, void* p_out, float* part_loss,
                   int* part_cnt, float* loss, int* cnt, int N, int P, int S,
                   float bias_mult, cudaStream_t stream) {
  const int nblk = (N + kCeRows - 1) / kCeRows;
  const size_t smem = static_cast<size_t>(kCeRows) * ce_width(S) * 4;
  auto kernel = ce_fwd_kernel<T, T>;
  // opt in whatever the size: the static tiles count against 48 KB too
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<nblk, kGemmThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), b, tc,
      static_cast<T*>(p_out), part_loss, part_cnt, N, P, S, bias_mult);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_ce_reduce(part_loss, part_cnt, nblk, loss, cnt, stream);
}

template <typename T>
cudaError_t ce_bwd(const void* p, const void* h, const void* w,
                   const int* tc, const float* g, void* dz, float* db_part,
                   float* w_part, void* dh, float* dw, float* db, int N,
                   int P, int S, float bias_mult, cudaStream_t stream) {
  const int nblk = (N + kCeRows - 1) / kCeRows;
  ce_dz_kernel<T><<<nblk, kGemmThreads, 0, stream>>>(
      static_cast<const T*>(p), tc, g, static_cast<T*>(dz), db_part, N, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  {  // dh = dzc . W^T
    GemmArgs<T> ga{};
    ga.a[0] = make_view<T>(dz, S, N, S);
    ga.b[0] = make_view<T>(w, S, P, S);
    ga.M = N;
    ga.N = P;
    ga.K = S;
    ga.nsplit = 1;
    ga.ngroups = 1;
    err = launch_gemm<GemmTailDh, T, false, true, float>(
        ga, 1, EpiStore<T>{static_cast<T*>(dh), P}, stream);
    if (err != cudaSuccess) return err;
  }
  const int ns = gemm_splits(N);
  {  // dW = h^T . dzc, split over the rows
    GemmArgs<T> ga{};
    ga.a[0] = make_view<T>(h, P, N, P);
    ga.b[0] = make_view<T>(dz, S, N, S);
    ga.M = P;
    ga.N = S;
    ga.K = N;
    ga.nsplit = ns;
    ga.ngroups = 1;
    const long long L = static_cast<long long>(P) * S;
    err = launch_gemm<GemmTailDw, T, true, false, float>(
        ga, 1, EpiPartial{w_part, L, 0, S}, stream);
    if (err != cudaSuccess) return err;
    err = launch_sum_partials(w_part, ns, L, dw, L, L, 1.0f, stream);
    if (err != cudaSuccess) return err;
  }
  return launch_sum_partials(db_part, nblk, S, db, S, 0, bias_mult, stream);
}

}  // namespace

extern "C" {

// Forward. h [N, P] and w [P, S] both f32 (bf16 = 0) or both bf16; b [S]
// f32; tc [N] int32; p_out [N, S] (as h) or null (want_p = 0). Scratch:
// part_loss [nblk] f32, part_cnt [nblk] int32, nblk = ceil(N / 64).
// Outputs: loss [1] f32, cnt [1] int32.
int softmax_ce_fwd(const void* h, const void* w, const float* b,
                   const int* tc, void* p_out, float* part_loss,
                   int* part_cnt, float* loss, int* cnt, int N, int P, int S,
                   float bias_mult, int bf16, int device,
                   cudaStream_t stream) {
  if (N < 1 || P < 1 || S < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bf16)
    return ce_fwd<__nv_bfloat16>(h, w, b, tc, p_out, part_loss, part_cnt,
                                 loss, cnt, N, P, S, bias_mult, stream);
  return ce_fwd<float>(h, w, b, tc, p_out, part_loss, part_cnt, loss, cnt, N,
                       P, S, bias_mult, stream);
}

// Backward. p [N, S], h [N, P], w [P, S] in the storage dtype (bf16 = 1:
// bf16, else f32); tc [N] int32; g [1] f32 (the loss cotangent). Scratch:
// dz [N, S] (as p), db_part [nblk, S] f32, w_part [nsplit, P*S] f32 with
// nsplit = softmax_ce_splits(N). Outputs: dh [N, P] (as p), dw [P, S] f32,
// db [S] f32 (times bias_mult).
int softmax_ce_bwd(const void* p, const void* h, const void* w,
                   const int* tc, const float* g, void* dz, float* db_part,
                   float* w_part, void* dh, float* dw, float* db, int N,
                   int P, int S, float bias_mult, int bf16, int device,
                   cudaStream_t stream) {
  if (N < 1 || P < 1 || S < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bf16)
    return ce_bwd<__nv_bfloat16>(p, h, w, tc, g, dz, db_part, w_part, dh, dw,
                                 db, N, P, S, bias_mult, stream);
  return ce_bwd<float>(p, h, w, tc, g, dz, db_part, w_part, dh, dw, db, N, P,
                       S, bias_mult, stream);
}

int softmax_ce_splits(int N) { return gemm_splits(N); }

}  // extern "C"
