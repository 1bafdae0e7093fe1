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
// Design and what bounds it on this card. K5f must read a once and write
// p once: at N = 25,000 and S = 10,112 that is 1.01 GB of f32 logits in
// and 1.01 GB (f32) or 0.51 GB (bf16) of p out, 18.3 MB in and 18.3 or
// 9.2 MB out at S = 183; bytes bound it (0.604 / 0.453 ms at 3.35 TB/s at
// S = 10,112). A group of threads owns a row: one warp for S <= 1,024
// (eight rows a 256-thread block, up to 8 values a lane for S <= 256, 32
// above), the whole block above, up to 40 values a thread (rows of up to
// 10,240 classes). The group reads its row from device memory once, with
// the widest vector that the base and row pitch of a, and of p, allow
// (softmax_common.cuh's RowVec and row_vec_elems, shared with K4f: 16
// bytes at S = 10,112, chosen per launch), and keeps it in registers.
// From there: min/max; e = safeExp(a - off) once per element, in place of
// its logit (expf alone where the row's whole range lies inside safeExp's
// cuts, else a select around expf: no branch per element), and its sum;
// p = e / sum with no division, e RN(1 / sum) and one FMA correction (the
// correctly rounded quotient wherever p is normal: softmax_ce.cu's
// ce_div), in place of e, and its first argmax with selects; then p is
// stored once, with stores of the load's width marked streaming
// (st.global.cs: the 1 GB of p need not stay in L2 until K5b reads it).
// Rows wider than 10,240 take three passes over the row in the same kernel
// (min/max, the exp sum, then p), the second and third mostly from L2, with
// the same arithmetic. The reductions are softmax_common.cuh's group_*
// (the whole block: through shared memory, the same order in every row).
// Loss and count are per-row partials added in a fixed order (no float
// atomics): a second launch gives the same bits. K5b reads p once and
// writes dz once (bytes bound it too); it reads its row's p_t once and
// broadcasts it to the group; no reduction is left.
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
// K5f holds its row in registers: a warp a row, up to kWarpHoldNarrow
// values a lane (S <= 32 * kWarpHoldNarrow: few registers, many warps an
// SM) or kWarpHold (S <= kWarpRowMaxS); the block a row, up to kBlockHold
// a thread (S <= kPlainThreads * kBlockHold); wider rows take three passes
constexpr int kWarpHoldNarrow = 8;
constexpr int kWarpHold = 32;
constexpr int kBlockHold = 40;

// the row this thread's group owns, and the thread's index in the group
template <int kWarps>
__device__ __forceinline__ int group_row(int& tid) {
  constexpr int kGroup = kWarps * 32;
  tid = threadIdx.x % kGroup;
  return blockIdx.x * (kPlainThreads / kGroup) + threadIdx.x / kGroup;
}

// safeExp(x) with no branch. kInside: the caller has checked that x lies
// inside its cuts, where it is expf. Outside, expf is 0 at the lower cut
// already, and the upper one is a select (a NaN stays NaN, as in
// safe_exp).
template <bool kInside>
__device__ __forceinline__ float plain_exp(float x) {
  if constexpr (kInside) return expf(x);
  return x >= kCeExpLimit ? kRealMax : expf(x);
}

// A row's constants for p = e / sum with no division: rs = RN(1 / sum). A
// row whose exp sum is infinite (every p is 0, as the division gives)
// takes sum = 1 and rs = 0.
struct PlainRow {
  float sum, rs;
};

__device__ __forceinline__ PlainRow plain_row(float sum) {
  const bool finite = sum < CUDART_INF_F;
  PlainRow r;
  r.sum = finite ? sum : 1.0f;
  r.rs = finite ? __frcp_rn(r.sum) : 0.0f;
  return r;
}

// p = e / sum as softmax_ce.cu's ce_div takes it: q = e * RN(1 / sum),
// then one FMA correction from the exact remainder
__device__ __forceinline__ float plain_p(float e, const PlainRow& r) {
  const float q = e * r.rs;
  return fmaf(fmaf(-q, r.sum, e), r.rs, q);
}

// E values of p stored at dst as P, one streaming store (st.global.cs) of
// E * sizeof(P) bytes
template <typename P, int E>
__device__ __forceinline__ void store_p(P* dst, const float (&v)[E]) {
  if constexpr (sizeof(P) == 4) {
    if constexpr (E == 4)
      __stcs(reinterpret_cast<float4*>(dst),
             make_float4(v[0], v[1], v[2], v[3]));
    else if constexpr (E == 2)
      __stcs(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
    else
      __stcs(reinterpret_cast<float*>(dst), v[0]);
  } else {  // bf16, rounded to nearest: two a word, the first in the low half
    unsigned short b[E];
#pragma unroll
    for (int i = 0; i < E; ++i)
      b[i] = __bfloat16_as_ushort(__float2bfloat16_rn(v[i]));
    if constexpr (E == 4)
      __stcs(reinterpret_cast<uint2*>(dst),
             make_uint2(b[0] | static_cast<unsigned>(b[1]) << 16,
                        b[2] | static_cast<unsigned>(b[3]) << 16));
    else if constexpr (E == 2)
      __stcs(reinterpret_cast<unsigned*>(dst),
             b[0] | static_cast<unsigned>(b[1]) << 16);
    else
      __stcs(reinterpret_cast<unsigned short*>(dst), b[0]);
  }
}

// e = safeExp(x - off) of each held element, in place, and the thread's
// sum of them
template <bool kInside, int E, int kV, int kGroup>
__device__ __forceinline__ float plain_exp_held(float (&x)[kV][E], int tid,
                                                int V, float off) {
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < kV; ++i)
    if (tid + i * kGroup < V) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        x[i][e] = plain_exp<kInside>(x[i][e] - off);
        sum += x[i][e];
      }
    }
  return sum;
}

// One row per group of kWarps warps; E elements a vector (E divides S, and
// the base and row pitch of a and of p are aligned to E elements); kHold >
// 0: the row in registers, kHold values a thread (S <= kWarps * 32 *
// kHold), else three passes over it. At least two blocks an SM (at most
// 128 registers a thread): without it ptxas holds the warp body's row in
// 80 registers and spills.
template <typename P, int kWarps, int E, int kHold>
__global__ void __launch_bounds__(kPlainThreads, 2)
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
  const int V = S / E;  // vectors in a row
  const float* ar = a + static_cast<size_t>(row) * S;
  P* pr = p_out == nullptr ? nullptr : p_out + static_cast<size_t>(row) * S;
  float mn = CUDART_INF_F, mx = -CUDART_INF_F, off, sum;
  // p's first argmax, over the f32 p (two different e can round to the
  // same p, and a bf16 store would tie more): ties to the lowest index, a
  // thread's elements in ascending order
  float best = -CUDART_INF_F;
  int arg = S;
  PlainRow r;
  if constexpr (kHold > 0) {
    constexpr int kV = kHold / E;
    float x[kV][E];
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int vi = tid + i * kGroup;
      if (vi < V) {
        RowVec<float, E> q;
        q.load(ar + vi * E);
        q.to_f32(x[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kV; ++i)
      if (tid + i * kGroup < V) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          mn = fminf(mn, x[i][e]);
          mx = fmaxf(mx, x[i][e]);
        }
      }
    group_min_max<kWarps>(mn, mx, s_a, s_b);
    // the reference's max search starts at FLT_MIN (SoftmaxLayer.cu:60)
    off = 0.5f * (mn + fmaxf(mx, kRealMin));
    // every a - off lies in [mn - off, mx - off]
    sum = mn - off > kLogZero && mx - off < kCeExpLimit
              ? plain_exp_held<true, E, kV, kGroup>(x, tid, V, off)
              : plain_exp_held<false, E, kV, kGroup>(x, tid, V, off);
    r = plain_row(group_sum<kWarps>(sum, s_a));
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int vi = tid + i * kGroup;
      if (vi < V) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float p = plain_p(x[i][e], r);
          const bool gt = p > best;
          best = gt ? p : best;
          arg = gt ? vi * E + e : arg;
          x[i][e] = p;
        }
      }
    }
    if (pr != nullptr) {
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const int vi = tid + i * kGroup;
        if (vi < V) store_p<P, E>(pr + vi * E, x[i]);
      }
    }
  } else {
    RowVec<float, E> q;
    float v[E];
    for (int vi = tid; vi < V; vi += kGroup) {
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
    sum = 0.0f;
    for (int vi = tid; vi < V; vi += kGroup) {
      q.load(ar + vi * E);
      q.to_f32(v);
#pragma unroll
      for (int e = 0; e < E; ++e) sum += plain_exp<false>(v[e] - off);
    }
    r = plain_row(group_sum<kWarps>(sum, s_a));
    for (int vi = tid; vi < V; vi += kGroup) {
      q.load(ar + vi * E);
      q.to_f32(v);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        v[e] = plain_p(plain_exp<false>(v[e] - off), r);
        const bool gt = v[e] > best;
        best = gt ? v[e] : best;
        arg = gt ? vi * E + e : arg;
      }
      if (pr != nullptr) store_p<P, E>(pr + vi * E, v);
    }
  }
  arg = group_argmax<kWarps>(best, arg, s_a, s_i);

  if (tid == 0) {
    const int t = tc[row];
    // the same expression as every p above (plain_exp's outside form is
    // expf inside the cuts): the same value
    const float pt = (t >= 0 && t < S) ? plain_p(plain_exp<false>(ar[t] - off),
                                                 r)
                                       : 0.0f;
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

template <typename P, int E>
cudaError_t plain_fwd_e(const float* a, const int* tc, P* p, float* part_loss,
                        int* part_cnt, int N, int S, cudaStream_t stream) {
  constexpr int kWarps = kPlainThreads / 32;
  const int grid = plain_blocks(N, S);
  if (S <= 32 * kWarpHoldNarrow)
    plain_fwd_kernel<P, 1, E, kWarpHoldNarrow>
        <<<grid, kPlainThreads, 0, stream>>>(a, tc, p, part_loss, part_cnt,
                                             N, S);
  else if (S <= kWarpRowMaxS)
    plain_fwd_kernel<P, 1, E, kWarpHold><<<grid, kPlainThreads, 0, stream>>>(
        a, tc, p, part_loss, part_cnt, N, S);
  else if (S <= kPlainThreads * kBlockHold)
    plain_fwd_kernel<P, kWarps, E, kBlockHold>
        <<<grid, kPlainThreads, 0, stream>>>(a, tc, p, part_loss, part_cnt,
                                             N, S);
  else
    plain_fwd_kernel<P, kWarps, E, 0><<<grid, kPlainThreads, 0, stream>>>(
        a, tc, p, part_loss, part_cnt, N, S);
  return cudaGetLastError();
}

template <typename P>
cudaError_t plain_fwd(const float* a, const int* tc, void* p, float* part_loss,
                      int* part_cnt, float* loss, int* cnt, int N, int S,
                      cudaStream_t stream) {
  P* pp = static_cast<P*>(p);
  // the widest vector that every row of a (up to 16 bytes) and of p allows
  int E = row_vec_elems(a, static_cast<size_t>(S) * 4, 4);
  if (p != nullptr) {
    const int ep = row_vec_elems(p, static_cast<size_t>(S) * sizeof(P),
                                 sizeof(P));
    E = ep < E ? ep : E;
  }
  cudaError_t err;
  if (E >= 4)
    err = plain_fwd_e<P, 4>(a, tc, pp, part_loss, part_cnt, N, S, stream);
  else if (E == 2)
    err = plain_fwd_e<P, 2>(a, tc, pp, part_loss, part_cnt, N, S, stream);
  else
    err = plain_fwd_e<P, 1>(a, tc, pp, part_loss, part_cnt, N, S, stream);
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
