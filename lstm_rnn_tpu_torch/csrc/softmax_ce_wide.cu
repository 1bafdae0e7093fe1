// Wide classification tail (LVCSR-scale softmax, ~10k HMM states) from
// logits computed outside, for NVIDIA Hopper (sm_90a).
//
// Replaces lstm_rnn_tpu/ops/softmax_ce.py::_fwd_wide_kernel and
// ::_bwd_wide_kernel (behind softmax_ce_wide_fused). The logits
// a = h . W + bias_mult * b are one product outside (in the storage
// dtype, rounded once), as in the JAX package; the stats below come from
// the rounded a, so the backward's recomputed p is the forward's p.
// Forward, per row of a [N, S] with target class tc (-1 = dummy frame):
//
//   off  = (min(a) + max(max(a), REAL_MIN)) / 2,  e = safeExp(a - off)
//   ssum = sum(e),  p = e / ssum,  pt = p[tc] (0 for a dummy row)
//   loss = sum over rows with tc >= 0 of -log(max(pt, REAL_MIN))
//   cnt  = number of rows with tc >= 0 whose first argmax of p is tc
//
// and off, ssum, pt [N] f32 when the caller trains (want_stats). Backward,
// with g the loss cotangent, inv = -1/max(pt, REAL_MIN), s = pt * inv:
//
//   dz = p (onehot(tc) inv - s) valid g   (p recomputed from a and stats)
//   dzc = dz in the storage dtype,  dW = h^T . dzc,  db = bias_mult sum dz
//
// (dh = dzc . W^T is one product outside, as in the JAX package.)
//
// Design and what bounds it on this card. K4f is one block per row: three
// passes over the row (min/max, exp sum, then p and its first argmax),
// block-wide reductions through shuffles (softmax_common.cuh's group_*,
// which K5f shares); the first pass reads the row
// from device memory, the next two mostly from L2. Loss and count are
// per-row partials added in a fixed order (no float atomics). It must read
// the logits once: 1.0 GB in f32 at N = 25,000, S = 10,112, so bytes bound
// it. K4b is a grid of (256 columns x 64 rows) tiles: each thread walks
// one column down the tile's rows, recomputes p, writes dzc and keeps its
// column's db partial; the per-tile db partials [row tiles, S] are summed
// in order. dW = h^T . dzc then runs in gemm.cuh's GEMM, split over the
// rows, with the fixed-order sum of the partials: 2 N P S operations, on
// the FP32 pipes in f32 (they bound K4b), on the tensor cores in bf16. The TPU kernel
// keeps dz in VMEM and accumulates dW per column block; here dzc is
// written once (the dh product outside needs it anyway).
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

constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideRows = 64;  // rows per K4b tile (one db partial each)

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    wide_fwd_kernel(const T* __restrict__ a, const int* __restrict__ tc,
                    float* __restrict__ off_out, float* __restrict__ sum_out,
                    float* __restrict__ pt_out, float* __restrict__ part_loss,
                    int* __restrict__ part_cnt, int S) {
  __shared__ float s_a[kWideWarps], s_b[kWideWarps];
  __shared__ int s_i[kWideWarps];
  const int row = blockIdx.x;
  const T* ar = a + static_cast<size_t>(row) * S;

  float mn = CUDART_INF_F, mx = -CUDART_INF_F;
  for (int s = threadIdx.x; s < S; s += kWideThreads) {
    const float v = as_f32(ar[s]);
    mn = fminf(mn, v);
    mx = fmaxf(mx, v);
  }
  group_min_max<kWideWarps>(mn, mx, s_a, s_b);
  // the reference's max search starts at FLT_MIN (SoftmaxLayer.cu:60)
  const float off = 0.5f * (mn + fmaxf(mx, kRealMin));

  float sum = 0.0f;
  for (int s = threadIdx.x; s < S; s += kWideThreads)
    sum += safe_exp(as_f32(ar[s]) - off);
  sum = group_sum<kWideWarps>(sum, s_a);

  // p and its first argmax: two different e can round to the same p
  float best = -CUDART_INF_F;
  int arg = S;
  for (int s = threadIdx.x; s < S; s += kWideThreads) {
    const float p = safe_exp(as_f32(ar[s]) - off) / sum;
    if (p > best) {
      best = p;
      arg = s;
    }
  }
  arg = group_argmax<kWideWarps>(best, arg, s_a, s_i);

  if (threadIdx.x == 0) {
    const int t = tc[row];
    const float pt =
        (t >= 0 && t < S) ? safe_exp(as_f32(ar[t]) - off) / sum : 0.0f;
    if (off_out != nullptr) {
      off_out[row] = off;
      sum_out[row] = sum;
      pt_out[row] = pt;
    }
    part_loss[row] = t >= 0 ? -logf(fmaxf(pt, kRealMin)) : 0.0f;
    part_cnt[row] = (t >= 0 && arg == t) ? 1 : 0;
  }
}

// dzc [N, S] (storage dtype) and per-tile db partials [row tiles, S] from
// the logits and the forward's stats; g is the loss cotangent (one f32 on
// the device)
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    wide_dz_kernel(const T* __restrict__ a, const int* __restrict__ tc,
                   const float* __restrict__ off, const float* __restrict__ ssum,
                   const float* __restrict__ pt, const float* __restrict__ g,
                   T* __restrict__ dz, float* __restrict__ db_part, int N,
                   int S) {
  __shared__ float off_s[kWideRows], sum_s[kWideRows], inv_s[kWideRows],
      srow_s[kWideRows], valid_s[kWideRows];
  __shared__ int tc_s[kWideRows];
  const int m0 = blockIdx.y * kWideRows;
  const int nr = min(kWideRows, N - m0);
  if (threadIdx.x < nr) {
    const int gm = m0 + threadIdx.x;
    const float inv = -1.0f / fmaxf(pt[gm], kRealMin);
    off_s[threadIdx.x] = off[gm];
    sum_s[threadIdx.x] = ssum[gm];
    inv_s[threadIdx.x] = inv;
    srow_s[threadIdx.x] = pt[gm] * inv;
    tc_s[threadIdx.x] = tc[gm];
    valid_s[threadIdx.x] = tc[gm] >= 0 ? 1.0f : 0.0f;
  }
  __syncthreads();
  const int col = blockIdx.x * kWideThreads + threadIdx.x;
  if (col >= S) return;
  const float gv = g[0];
  float dbs = 0.0f;
  for (int r = 0; r < nr; ++r) {
    const size_t i = static_cast<size_t>(m0 + r) * S + col;
    const float p = safe_exp(as_f32(a[i]) - off_s[r]) / sum_s[r];
    const float oh = col == tc_s[r] ? 1.0f : 0.0f;
    float v = p * (oh * inv_s[r] - srow_s[r]);
    v = v * valid_s[r];
    v = v * gv;
    dz[i] = f32_to<T>(v);
    dbs += v;
  }
  db_part[static_cast<size_t>(blockIdx.y) * S + col] = dbs;
}

template <typename T>
cudaError_t wide_fwd(const void* a, const int* tc, float* off, float* ssum,
                     float* pt, float* part_loss, int* part_cnt, float* loss,
                     int* cnt, int N, int S, cudaStream_t stream) {
  wide_fwd_kernel<T><<<N, kWideThreads, 0, stream>>>(
      static_cast<const T*>(a), tc, off, ssum, pt, part_loss, part_cnt, S);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_ce_reduce(part_loss, part_cnt, N, loss, cnt, stream);
}

template <typename T>
cudaError_t wide_bwd(const void* a, const void* h, const int* tc,
                     const float* off, const float* ssum, const float* pt,
                     const float* g, void* dz, float* db_part, float* w_part,
                     float* dw, float* db, int N, int P, int S,
                     float bias_mult, cudaStream_t stream) {
  const int ntiles = (N + kWideRows - 1) / kWideRows;
  const dim3 grid((S + kWideThreads - 1) / kWideThreads, ntiles);
  wide_dz_kernel<T><<<grid, kWideThreads, 0, stream>>>(
      static_cast<const T*>(a), tc, off, ssum, pt, g, static_cast<T*>(dz),
      db_part, N, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int ns = gemm_splits(N);
  GemmArgs<T> ga{};  // dW = h^T . dzc, split over the rows
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
  return launch_sum_partials(db_part, ntiles, S, db, S, 0, bias_mult, stream);
}

}  // namespace

extern "C" {

// Forward (K4f). a [N, S] f32 (bf16 = 0) or bf16 (bf16 = 1); tc [N]
// int32. Outputs: off, ssum, pt [N] f32 (all three null: no stats), loss
// [1] f32, cnt [1] int32. Scratch: part_loss [N] f32, part_cnt [N] int32.
int softmax_ce_wide_fwd(const void* a, const int* tc, float* off,
                        float* ssum, float* pt, float* part_loss,
                        int* part_cnt, float* loss, int* cnt, int N, int S,
                        int bf16, int device, cudaStream_t stream) {
  if (N < 1 || S < 1) return cudaErrorInvalidValue;
  if ((off == nullptr) != (ssum == nullptr) ||
      (off == nullptr) != (pt == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bf16)
    return wide_fwd<__nv_bfloat16>(a, tc, off, ssum, pt, part_loss, part_cnt,
                                   loss, cnt, N, S, stream);
  return wide_fwd<float>(a, tc, off, ssum, pt, part_loss, part_cnt, loss, cnt,
                         N, S, stream);
}

// Backward (K4b). a [N, S] and h [N, P] in the storage dtype (bf16 = 1:
// bf16, else f32); tc [N] int32; off, ssum, pt [N] f32 from the forward;
// g [1] f32 (the loss cotangent). Outputs: dz [N, S] (as a), dw [P, S]
// f32, db [S] f32 (times bias_mult). Scratch: db_part [row tiles, S] f32
// (softmax_ce_wide_row_tiles(N)), w_part [nsplit, P*S] f32 with nsplit =
// softmax_ce_splits(N).
int softmax_ce_wide_bwd(const void* a, const void* h, const int* tc,
                        const float* off, const float* ssum, const float* pt,
                        const float* g, void* dz, float* db_part,
                        float* w_part, float* dw, float* db, int N, int P,
                        int S, float bias_mult, int bf16, int device,
                        cudaStream_t stream) {
  if (N < 1 || P < 1 || S < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bf16)
    return wide_bwd<__nv_bfloat16>(a, h, tc, off, ssum, pt, g, dz, db_part,
                                   w_part, dw, db, N, P, S, bias_mult,
                                   stream);
  return wide_bwd<float>(a, h, tc, off, ssum, pt, g, dz, db_part, w_part, dw,
                         db, N, P, S, bias_mult, stream);
}

int softmax_ce_wide_row_tiles(int N) {
  return (N + kWideRows - 1) / kWideRows;
}

}  // extern "C"
