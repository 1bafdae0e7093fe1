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
// Design and what bounds it on this card. K4f must read the logits once:
// 1.0 GB in f32 (0.5 GB in bf16) at N = 25,000, S = 10,112, so bytes bound
// it. A block of 256 threads per row reads the row once, with the widest
// vector load that the base and the row pitch allow (16 bytes at S =
// 10,112; decided per launch, as make_view decides), and keeps it in
// registers as loaded (up to kWideHold = 40 values a thread: rows of up to
// 10,240 classes; bf16 two to a register).
// From there min/max; then safe_exp once per element, with the exp sum
// and the first argmax of e in the same pass; block-wide reductions
// through shuffles (softmax_common.cuh's group_*, which K5f shares). The
// first argmax of p = e / sum is that of e unless an earlier e within
// 2^-20 of the largest rounds to the same p: only then, rarely, p is taken
// by division (a division per element would bound the kernel by
// instructions). A wider row takes the multi-pass body in the same kernel:
// three passes over the row (min/max, exp sum, p and its argmax), the
// second and third mostly from L2. Loss and count are per-row partials
// added in a fixed order (no float atomics). K4b is a grid of (256 columns
// x 64 rows) tiles: each thread walks one column down the tile's rows,
// recomputes p, writes dzc and keeps its column's db partial; the per-tile
// db partials [row tiles, S] are summed in order. dW = h^T . dzc then runs
// in gemm.cuh's GEMM, split over the rows, with the fixed-order sum of the
// partials: 2 N P S operations, on the FP32 pipes in f32 (they bound K4b),
// on the tensor cores in bf16. The TPU kernel keeps dz in VMEM and
// accumulates dW per column block; here dzc is written once (the dh
// product outside needs it anyway).
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

constexpr int kWideThreads = 256;  // K4b
constexpr int kWideRows = 64;      // rows per K4b tile (one db partial each)
// K4f: a row per block of 256 threads, each holding up to kWideHold of its
// logits in registers as loaded: a row of up to 10,240 classes is read
// from device memory once
constexpr int kWideFwdThreads = 256;
constexpr int kWideHold = 40;

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

// The row's stats and partials from the block's reductions
__device__ __forceinline__ void wide_put_row(int row, int t, float off,
                                             float sum, float pt, int arg,
                                             float* off_out, float* sum_out,
                                             float* pt_out, float* part_loss,
                                             int* part_cnt) {
  if (off_out != nullptr) {
    off_out[row] = off;
    sum_out[row] = sum;
    pt_out[row] = pt;
  }
  part_loss[row] = t >= 0 ? -logf(fmaxf(pt, kRealMin)) : 0.0f;
  part_cnt[row] = (t >= 0 && arg == t) ? 1 : 0;
}

// e = safe_exp(a - off) of each held element, once: the thread's exp sum
// and first argmax of e. kInside: every a - off lies inside safe_exp's
// limits, where safe_exp is expf.
template <bool kInside, typename T, int E, int kV>
__device__ __forceinline__ void wide_exp_pass(const RowVec<T, E> (&h)[kV],
                                              int V, float off, float& sum,
                                              float& emax, int& earg) {
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int vi = threadIdx.x + i * kWideFwdThreads;
    if (vi < V) {
      float v[E];
      h[i].to_f32(v);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float x = kInside ? expf(v[e] - off) : safe_exp(v[e] - off);
        sum += x;
        const bool gt = x > emax;
        emax = gt ? x : emax;
        earg = gt ? vi * E + e : earg;
      }
    }
  }
}

// One block per row; E elements a load (E divides S); kHeld: the row in
// registers as loaded (S <= kWideFwdThreads * kWideHold), else three
// passes over it. The rare paths (an earlier e that may tie the largest p,
// p_t) read the row again from device memory, so that the kernel stays
// small.
template <typename T, int E, bool kHeld>
__global__ void __launch_bounds__(kWideFwdThreads)
    wide_fwd_kernel(const T* __restrict__ a, const int* __restrict__ tc,
                    float* __restrict__ off_out, float* __restrict__ sum_out,
                    float* __restrict__ pt_out, float* __restrict__ part_loss,
                    int* __restrict__ part_cnt, int S) {
  constexpr int kWarps = kWideFwdThreads / 32;
  __shared__ float s_a[kWarps], s_b[kWarps];
  __shared__ int s_i[kWarps];
  const int V = S / E;  // loads in a row
  const int row = blockIdx.x;
  const T* ar = a + static_cast<size_t>(row) * S;
  float mn = CUDART_INF_F, mx = -CUDART_INF_F, off, sum = 0.0f;
  // p's first argmax: two different e can round to the same p
  float best = -CUDART_INF_F;
  int arg = S;
  RowVec<T, E> q;
  float v[E];
  bool divide = true;  // take p's argmax by division, from memory
  if constexpr (kHeld) {
    constexpr int kV = kWideHold / E;
    RowVec<T, E> h[kV] = {};
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int vi = threadIdx.x + i * kWideFwdThreads;
      if (vi < V) h[i].load(ar + vi * E);
    }
#pragma unroll
    for (int i = 0; i < kV; ++i)
      if (threadIdx.x + i * kWideFwdThreads < V) {
        h[i].to_f32(v);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          mn = fminf(mn, v[e]);
          mx = fmaxf(mx, v[e]);
        }
      }
    group_min_max<kWarps>(mn, mx, s_a, s_b);
    // the reference's max search starts at FLT_MIN (SoftmaxLayer.cu:60)
    off = 0.5f * (mn + fmaxf(mx, kRealMin));
    // e = safe_exp(a - off), once per element: its sum and its first
    // argmax. p = e / sum rounds every e the same way, so the first argmax
    // of p is that of e unless an earlier e within 2^-20 of the largest
    // rounds to the same p (checked below).
    float emax = -CUDART_INF_F;
    int earg = S;
    // every a - off lies in [mn - off, mx - off]: inside safe_exp's limits
    // there, safe_exp is expf
    if (mn - off > kLogZero && mx - off < kCeExpLimit)
      wide_exp_pass<true>(h, V, off, sum, emax, earg);
    else
      wide_exp_pass<false>(h, V, off, sum, emax, earg);
    const float own = emax;  // this thread's largest e
    sum = group_sum_argmax<kWarps>(sum, emax, earg, s_a, s_b, s_i);
    arg = earg;
    // An earlier e at or above thr could round to the same p: then (and
    // only then, with a sum that is not finite too) take p's argmax by
    // division; every other e has a smaller p. Only a thread whose own
    // largest e reaches thr can hold one.
    const float thr = emax * (1.0f - 0x1p-20f);
    bool near = !(thr / sum < emax / sum);
    if (own >= thr) {
#pragma unroll 1
      for (int vi = threadIdx.x; vi < V && vi * E < earg;
           vi += kWideFwdThreads) {
        q.load(ar + vi * E);
        q.to_f32(v);
        for (int e = 0; e < E; ++e)
          near |= safe_exp(v[e] - off) >= thr && vi * E + e < earg;
      }
    }
    divide = __syncthreads_or(near);
  } else {
    for (int vi = threadIdx.x; vi < V; vi += kWideFwdThreads) {
      q.load(ar + vi * E);
      q.to_f32(v);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        mn = fminf(mn, v[e]);
        mx = fmaxf(mx, v[e]);
      }
    }
    group_min_max<kWarps>(mn, mx, s_a, s_b);
    off = 0.5f * (mn + fmaxf(mx, kRealMin));
    for (int vi = threadIdx.x; vi < V; vi += kWideFwdThreads) {
      q.load(ar + vi * E);
      q.to_f32(v);
#pragma unroll
      for (int e = 0; e < E; ++e) sum += safe_exp(v[e] - off);
    }
    sum = group_sum<kWarps>(sum, s_a);
  }
  if (divide) {  // p and its first argmax, from memory
#pragma unroll 1
    for (int vi = threadIdx.x; vi < V; vi += kWideFwdThreads) {
      q.load(ar + vi * E);
      q.to_f32(v);
      for (int e = 0; e < E; ++e) {
        const float p = safe_exp(v[e] - off) / sum;
        if (p > best) {
          best = p;
          arg = vi * E + e;
        }
      }
    }
    arg = group_argmax<kWarps>(best, arg, s_a, s_i);
  }
  if (threadIdx.x == 0) {
    const int t = tc[row];
    // the same expression as every e / sum above: the same value
    const float pt =
        (t >= 0 && t < S) ? safe_exp(as_f32(ar[t]) - off) / sum : 0.0f;
    wide_put_row(row, t, off, sum, pt, arg, off_out, sum_out, pt_out,
                 part_loss, part_cnt);
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

template <typename T, int E>
cudaError_t wide_fwd_e(const T* a, const int* tc, float* off, float* ssum,
                       float* pt, float* part_loss, int* part_cnt, int N,
                       int S, cudaStream_t stream) {
  if (S <= kWideFwdThreads * kWideHold)
    wide_fwd_kernel<T, E, true><<<N, kWideFwdThreads, 0, stream>>>(
        a, tc, off, ssum, pt, part_loss, part_cnt, S);
  else
    wide_fwd_kernel<T, E, false><<<N, kWideFwdThreads, 0, stream>>>(
        a, tc, off, ssum, pt, part_loss, part_cnt, S);
  return cudaGetLastError();
}

template <typename T>
cudaError_t wide_fwd(const void* a, const int* tc, float* off, float* ssum,
                     float* pt, float* part_loss, int* part_cnt, float* loss,
                     int* cnt, int N, int S, cudaStream_t stream) {
  const T* at = static_cast<const T*>(a);
  // the widest load every row allows: the lowest set bit of (base | row
  // bytes | 16), as make_view decides
  const unsigned long long bits = reinterpret_cast<unsigned long long>(a) |
                                  static_cast<unsigned long long>(S) *
                                      sizeof(T) |
                                  16ull;
  cudaError_t err;
  switch (static_cast<int>((bits & (~bits + 1)) / sizeof(T))) {
    case 8:
      if constexpr (sizeof(T) == 2) {
        err = wide_fwd_e<T, 8>(at, tc, off, ssum, pt, part_loss, part_cnt, N,
                               S, stream);
        break;
      }
      return cudaErrorInvalidValue;
    case 4:
      err = wide_fwd_e<T, 4>(at, tc, off, ssum, pt, part_loss, part_cnt, N, S,
                             stream);
      break;
    case 2:
      err = wide_fwd_e<T, 2>(at, tc, off, ssum, pt, part_loss, part_cnt, N, S,
                             stream);
      break;
    default:
      err = wide_fwd_e<T, 1>(at, tc, off, ssum, pt, part_loss, part_cnt, N, S,
                             stream);
  }
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
