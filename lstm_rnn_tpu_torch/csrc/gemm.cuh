// The matrix-product engine of the LSTM and tail kernels, for NVIDIA
// Hopper (sm_90a): one GEMM with transpose flags, a row shift, two operand
// pairs per launch, split-K into per-split partials and a deterministic
// reduction of them. The TPU kernels compute these products in their own
// bodies (lstm_rnn_tpu/ops/lstm_cell.py: the projection x . W_in + b at
// :227; dW_in = x^T . da, dW_rec = h_prev^T . da and dx = da . W_in^T at
// :449, :475 and :491; ops/softmax_ce.py: dh = dz . W^T and dW = h^T .
// dz in _bwd_proj_kernel); here every one of them, for K0, K1, K2, K3b,
// K6f, K6b-f and K6b-b, runs in gemm_kernel, and so do K4's two products
// outside its kernels in bf16 mode (the logits and dh). (K3f computes its
// logits inside its own kernel, softmax_ce.cu's ce_fwd_kernel, and K4b its
// dW inside its own, softmax_ce_wide.cu's wide_bwd_wgmma_kernel, from this
// file's parts: View, load_seg, the swizzle and wgmma descriptors, the
// cp.async copies.)
//
// An operand is a View: element (r, c) of a row-major matrix with leading
// dimension `ld`, rows shifted by `shift` (the scan-previous h of dW_rec),
// zero outside [0, rows) x [0, cols). A(m, k) = a(m, k), or a(k, m) when
// transposed; B(k, n) = b(k, n), or b(n, k) when transposed. A launch
// computes, for output d (grid.z = outputs * nsplit), split s of the K
// range, pair d's A . B through the epilogue; with ngroups > 1 (one
// output, one split) the sum over g of round_to<R>(A_g . B_g), each
// pair's product rounded before it is added (dx of a BLSTM layer: one
// plane per direction, rounded to the storage dtype).
//
// Design and what bounds it on this card. The products are large (dW at
// M = 117-250, N = 500 or 10,112 over K = 25,000 rows; dx, dh and the
// projection at M = 4,096-40,000), so operations bound them: 67 TFLOP/s
// on the FP32 pipes for f32 parity mode (true f32: the tensor cores have
// no f32 mode, and TF32 would change the numbers), 989 TFLOP/s on the
// tensor cores for bf16 operands. Two bodies, one kernel:
//
// * bf16 (gemm_wgmma): a 128 x 128 block tile, two warpgroups each
//   computing 64 x 128 with wgmma.mma_async m64n128k16 (f32 accumulators
//   in registers, both operands in shared memory), BK = 64 per stage in a
//   ring of three stages. Operands whose contiguous axis is K are stored
//   K-major, the others (x^T, h^T, da and dz of the dW products, W_in of
//   the projection) MN-major, read through wgmma's transpose bits: no
//   copy is transposed. Both layouts use the 128-byte swizzle, so the stores
//   and wgmma's reads are free of bank conflicts. The main path's
//   operands rarely allow TMA or cp.async (bf16 rows of 117, 125, 183 and
//   250 elements are 2- or 4-byte aligned), so every thread stages 16-byte
//   segments through registers with the widest load that the operand's
//   base and ld allow (decided on the host, View::vec), zero-filled at
//   the edges: the loads of stage k+2 are in flight while the tensor
//   cores run stage k, and the stores land while stage k+1 waits in the
//   ring.
// * f32 (gemm_simt): a register-blocked SIMT GEMM, 128 x 128 block tile,
//   256 threads with 8 x 8 outputs each (a warp covers 64 x 32 as 8 x 4
//   threads, each thread two 4-row and two 4-column strips): four 16-byte
//   shared loads feed 64 FMAs. BK = 16 in a ring of three k-major stages
//   (dynamic shared memory, 50.7 KB: two blocks share an SM at 128
//   registers without spills), padded so that the transposing writes are
//   free of bank conflicts, filled by cp.async element by element (4
//   bytes: any f32 row allows it, and the copy zero-fills the edges), so
//   two stages of loads are in flight while one computes and no register
//   holds them.
//
// * f32 as three bf16 passes (gemm3x_kernel, --f32_matmul 3x): the
//   operands stay f32 in device memory and take the bf16 body's path with
//   twice its registers and stages: each 16-byte bf16 segment is read as
//   two 16-byte f32 halves, split in registers into hi = RN_bf16(v) and lo
//   = RN_bf16(v - hi) (the JAX package's _kdot, lstm_rnn_tpu/ops/
//   lstm_cell.py:82-100), and stored as A_hi, B_hi, A_lo, B_lo (64 KB a
//   stage, three stages: one block an SM); each k16 step issues three
//   wgmma, hi . hi, hi . lo and lo . hi, into the same f32 accumulators
//   (lo . lo lies below f32 rounding). About 2^-16 of each product's
//   magnitude is lost against true f32 (2^-24): the mode's error contract.
//   Three bf16 passes at 989 TFLOP/s bound a product about 5x below one
//   f32 pass at 67; the operands' f32 bytes are read once.
//
// Split-K writes one partial product per split (splits start on a
// stage boundary); sum_partials adds them in a fixed order, so the result
// does not depend on scheduling, and no float atomics are used. The first
// template argument of gemm_kernel (and gemm3x_kernel) names the product
// (GemmProj, GemmDwIn, ...), so that a profile tells the uses apart.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

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

// The engine's uses, named in the kernel's first template argument.
struct GemmProj {};    // x . W_in[d] + bias_mult * b[d] (K0, K1, K6f, K6b-f)
struct GemmDwIn {};    // x^T . da[d] (K2, K6b-b)
struct GemmDwRec {};   // h_prev^T . da[d] (K2, K6b-b)
struct GemmDx {};      // sum_d round(da[d] . W_in[d]^T) (K2, K6b-b)
struct GemmTailDh {};  // dz . W^T (the 3x TIMIT tail, after K5b)
struct GemmTailDw {};  // h^T . dz (the 3x TIMIT tail, after K5b)
// K4's two products outside its kernels, in bf16 mode and in 3x mode (in
// f32 mode they run in cuBLAS): the logits h . W + bias_mult * b in the
// storage dtype (K4f's input; in 3x mode also the TIMIT tail's, before
// K5f) and dh = dzc . W^T in h's dtype (K4b's)
struct GemmTailLogits {};
struct GemmWideDh {};

template <typename T>
struct View {
  const T* p;
  long long ld;
  int rows, cols, shift;
  int vec;  // bytes of the widest load p and ld allow: 2 (bf16), 4, 8, 16
  __device__ __forceinline__ float operator()(int r, int c) const {
    const int rr = r + shift;
    if (rr < 0 || rr >= rows || c >= cols) return 0.0f;
    return as_f32(p[static_cast<size_t>(rr) * ld + c]);
  }
};

template <typename T>
__host__ __device__ View<T> make_view(const void* p, long long ld, int rows,
                                      int cols, int shift = 0) {
  // the lowest set bit of (address | row bytes | 16)
  const unsigned long long bits = reinterpret_cast<unsigned long long>(p) |
                                  static_cast<unsigned long long>(ld) *
                                      sizeof(T) |
                                  16ull;
  return View<T>{static_cast<const T*>(p), ld, rows, cols, shift,
                 static_cast<int>(bits & (~bits + 1))};
}

// 16 bytes of row r of v from column c (c a multiple of 16 / sizeof(T)):
// zero where !ok, outside [0, rows) and at columns >= cend
template <typename T>
__device__ __forceinline__ uint4 load_seg(const View<T>& v, int r, int c,
                                          int cend, bool ok) {
  constexpr int E = 16 / sizeof(T);
  using Bits = typename std::conditional<sizeof(T) == 2, unsigned short,
                                         unsigned int>::type;
  union {
    uint4 q;
    uint2 h[2];
    unsigned int w[4];
    Bits e[E];
  } s;
  s.q = make_uint4(0u, 0u, 0u, 0u);
  const int rr = r + v.shift;
  if (!ok || rr < 0 || rr >= v.rows || c >= cend) return s.q;
  const T* p = v.p + static_cast<size_t>(rr) * v.ld + c;
  if (c + E <= cend && v.vec >= 4) {
    if (v.vec == 16) return *reinterpret_cast<const uint4*>(p);
    if (v.vec == 8) {
      const uint2* q = reinterpret_cast<const uint2*>(p);
      s.h[0] = q[0];
      s.h[1] = q[1];
      return s.q;
    }
    const unsigned int* q = reinterpret_cast<const unsigned int*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) s.w[i] = q[i];
    return s.q;
  }
  const Bits* q = reinterpret_cast<const Bits*>(p);
#pragma unroll
  for (int i = 0; i < E; ++i)
    if (c + i < cend) s.e[i] = q[i];
  return s.q;
}

// Operands of one launch: up to two (A, B) pairs, one per direction.
template <typename T>
struct GemmArgs {
  View<T> a[2];
  View<T> b[2];
  int M, N, K;
  // grid.z = outputs * nsplit: output d = z / nsplit takes pair d and the
  // K range of split z % nsplit. ngroups > 1 (one output, nsplit = 1): the
  // result is sum over g of round_to<R>(A_g . B_g), each pair's product
  // rounded first (dx of a BLSTM layer: one plane per direction).
  int nsplit;
  int ngroups;
};

constexpr int kEngineBM = 128;  // block tile, both bodies
constexpr int kEngineBN = 128;
constexpr int kEngineThreads = 256;
constexpr int kSimtBK = 16;
constexpr int kSimtStages = 3;
constexpr int kSimtPad = 4;  // k-major rows of 132 floats
constexpr int kWgBK = 64;    // 128 bytes of bf16: one swizzle row
constexpr int kWgStages = 3;
constexpr int kWgTileBytes = kEngineBM * kWgBK * 2;  // one operand's stage
constexpr int kWgSmem = kWgStages * 2 * kWgTileBytes + 1024;
// 3x: A_hi, B_hi, A_lo, B_lo a stage (197,632 bytes in all)
constexpr int kWg3Smem = kWgStages * 4 * kWgTileBytes + 1024;
constexpr int kSimtSmem =
    kSimtStages * 2 * kSimtBK * (kEngineBM + kSimtPad) * 4;

// Epilogues: epi.put<W>(d, split, m, n, v, add) takes output d's elements
// (m, n .. n + W - 1) of split `split` in one store, and returns false,
// storing nothing, where that store would be misaligned (the caller then
// puts them one by one); add is true for every group after the first
// (ngroups > 1), which the output adds to the value already there.

// v into W consecutive floats at dst (plus what is there when add)
template <int W>
__device__ __forceinline__ bool put_f32(float* dst, const float (&v)[W],
                                        bool add) {
  if (reinterpret_cast<unsigned long long>(dst) % (4 * W)) return false;
  float t[W];
#pragma unroll
  for (int i = 0; i < W; ++i) t[i] = add ? dst[i] + v[i] : v[i];
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(t[0], t[1], t[2], t[3]);
  else if constexpr (W == 2)
    *reinterpret_cast<float2*>(dst) = make_float2(t[0], t[1]);
  else
    *dst = t[0];
  return true;
}

// v rounded into W consecutive bf16 at dst (W = 1, or an even W where dst
// is aligned to the W values)
template <int W>
__device__ __forceinline__ bool put_bf16(__nv_bfloat16* dst,
                                         const float (&v)[W]) {
  if constexpr (W == 1) {
    *dst = __float2bfloat16_rn(v[0]);
  } else {
    if (reinterpret_cast<unsigned long long>(dst) % (2 * W)) return false;
#pragma unroll
    for (int i = 0; i < W; i += 2)
      *reinterpret_cast<__nv_bfloat162*>(dst + i) =
          __floats2bfloat162_rn(v[i], v[i + 1]);
  }
  return true;
}

// out[m, n] (row-major, ld N) in the output type
template <typename Out>
struct EpiStore {
  Out* out;
  int N;
  template <int W>
  __device__ __forceinline__ bool put(int, int, int m, int n,
                                      const float (&v)[W], bool add) const {
    Out* o = out + static_cast<size_t>(m) * N + n;
    if constexpr (std::is_same<Out, float>::value) {
      return put_f32<W>(o, v, add);
    } else {
      if constexpr (W == 1) {
        *o = f32_to<Out>(add ? as_f32(*o) + v[0] : v[0]);
        return true;
      } else {
        return !add && put_bf16<W>(o, v);
      }
    }
  }
};

// part[split * split_stride + d * d_stride + m * N + n] = v (f32)
struct EpiPartial {
  float* part;
  long long split_stride, d_stride;
  int N;
  template <int W>
  __device__ __forceinline__ bool put(int d, int split, int m, int n,
                                      const float (&v)[W], bool) const {
    return put_f32<W>(part + split * split_stride + d * d_stride +
                          static_cast<long long>(m) * N + n,
                      v, false);
  }
};

// out[d, m, n] = v + bias_mult * bias[d, n] (bias f32), the bias product
// rounded on its own, as the reference adds bias_mult * bias to the
// finished matmul; the sum stored in Out (f32, or rounded once to bf16)
template <typename Out>
struct EpiBias {
  Out* out;
  const float* bias;
  float bias_mult;
  long long d_stride;
  int N;
  template <int W>
  __device__ __forceinline__ bool put(int d, int, int m, int n,
                                      const float (&v)[W], bool) const {
    float t[W];
#pragma unroll
    for (int i = 0; i < W; ++i)
      t[i] = v[i] + __fmul_rn(bias_mult, bias[d * N + n + i]);
    Out* o = out + d * d_stride + static_cast<long long>(m) * N + n;
    if constexpr (std::is_same<Out, float>::value)
      return put_f32<W>(o, t, false);
    else
      return put_bf16<W>(o, t);
  }
};

// output elements (m, n .. n + W - 1), those below N, through the
// epilogue: one store where it is aligned, else one by one
template <int W, class Epi>
__device__ __forceinline__ void epi_put(const Epi& epi, int d, int split,
                                        int m, int n, int N,
                                        const float (&v)[W], bool add) {
  if (n + W <= N && epi.template put<W>(d, split, m, n, v, add)) return;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float one[1] = {v[i]};
    if (n + i < N) epi.template put<1>(d, split, m, n + i, one, add);
  }
}

// ------------------------------------------------------------ f32: SIMT
struct SimtStage {
  float a[kSimtBK][kEngineBM + kSimtPad];  // A(m, k) at a[k][m]
  float b[kSimtBK][kEngineBN + kSimtPad];  // B(k, n) at b[k][n]
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One stage's 4 elements of v for this thread, by cp.async (4 bytes each,
// zero-filled where invalid): along a row (r, c .. c + 3), valid columns
// below cend, into dst[0], dst[stride], ...; the row is valid when ok and
// r + shift lies in [0, rows).
__device__ __forceinline__ void simt_copy4(const View<float>& v, int r, int c,
                                           int cend, bool ok, float* dst,
                                           int stride) {
  const int rr = r + v.shift;
  ok = ok && rr >= 0 && rr < v.rows;
  const float* row = ok ? v.p + static_cast<size_t>(rr) * v.ld : v.p;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool in = ok && c + e < cend;
    const unsigned d =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + e * stride));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(in ? row + c + e : v.p), "r"(in ? 4 : 0)
                 : "memory");
  }
}

// Start stage k0's copies: thread t moves 4 elements of A and 4 of B. Along
// K (A untransposed, B transposed): row t / 2, k from 4 (t % 2), stored
// down the k-major tile; across (the other two): k-row t / 32, m or n
// from 4 (t % 32), stored along it.
template <bool kTA, bool kTB>
__device__ __forceinline__ void simt_fetch(const View<float>& a,
                                           const View<float>& b, int m0,
                                           int n0, int k0, int k_end,
                                           SimtStage& st) {
  const int t = threadIdx.x;
#pragma unroll
  for (int h = 0; h < kSimtBK; h += 8) {  // 8 k of A and of B per pass
    const int ka = h + (t % 2) * 4, kr = h + t / 32, c4 = (t % 32) * 4;
    if (!kTA)
      simt_copy4(a, m0 + t / 2, k0 + ka, min(a.cols, k_end), true,
                 &st.a[ka][t / 2], kEngineBM + kSimtPad);
    else
      simt_copy4(a, k0 + kr, m0 + c4, a.cols, k0 + kr < k_end,
                 &st.a[kr][c4], 1);
    if (kTB)
      simt_copy4(b, n0 + t / 2, k0 + ka, min(b.cols, k_end), true,
                 &st.b[ka][t / 2], kEngineBN + kSimtPad);
    else
      simt_copy4(b, k0 + kr, n0 + c4, b.cols, k0 + kr < k_end,
                 &st.b[kr][c4], 1);
  }
}

// acc[i][j] = A(m0 + simt_row(i), k range) . B(k range, n0 + simt_col(j))
__device__ __forceinline__ int simt_row(int i) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp / 4) * 64 + (i / 4) * 32 + (lane / 4) * 4 + i % 4;
}
__device__ __forceinline__ int simt_col(int j) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp % 4) * 32 + (j / 4) * 16 + (lane % 4) * 4 + j % 4;
}

// A ring of kSimtStages stages: the copies of the next ones are in flight
// while one computes
template <bool kTA, bool kTB>
__device__ __forceinline__ void simt_mainloop(const View<float>& a,
                                              const View<float>& b, int m0,
                                              int n0, int k_begin, int k_end,
                                              float (&acc)[8][8],
                                              SimtStage* st) {
  const int nk = (k_end - k_begin + kSimtBK - 1) / kSimtBK;
  if (nk <= 0) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ar = (warp / 4) * 64 + (lane / 4) * 4;
  const int bc = (warp % 4) * 32 + (lane % 4) * 4;
#pragma unroll
  for (int s = 0; s < kSimtStages - 1; ++s) {
    if (s < nk)
      simt_fetch<kTA, kTB>(a, b, m0, n0, k_begin + s * kSimtBK, k_end, st[s]);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    // stage kt has landed for every thread, and every thread is done with
    // stage kt - 1, which the copies below refill
    cp_async_wait<kSimtStages - 2>();
    __syncthreads();
    const int next = kt + kSimtStages - 1;
    if (next < nk)
      simt_fetch<kTA, kTB>(a, b, m0, n0, k_begin + next * kSimtBK, k_end,
                           st[next % kSimtStages]);
    cp_async_commit();
    const SimtStage& cur = st[kt % kSimtStages];
#pragma unroll
    for (int kk = 0; kk < kSimtBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&cur.a[kk][ar]);
      const float4 a1 = *reinterpret_cast<const float4*>(&cur.a[kk][ar + 32]);
      const float4 b0 = *reinterpret_cast<const float4*>(&cur.b[kk][bc]);
      const float4 b1 = *reinterpret_cast<const float4*>(&cur.b[kk][bc + 16]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the next group
}

template <bool kTA, bool kTB, typename R, class Epi>
__device__ __forceinline__ void gemm_simt(const GemmArgs<float>& g,
                                          const Epi& epi) {
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  SimtStage* st = reinterpret_cast<SimtStage*>(gemm_smem);
  const int z = blockIdx.z;
  const int d = z / g.nsplit;
  const int split = z % g.nsplit;
  const int m0 = blockIdx.x * kEngineBM;
  const int n0 = blockIdx.y * kEngineBN;
  const int kchunk =
      ((g.K + g.nsplit - 1) / g.nsplit + kWgBK - 1) / kWgBK * kWgBK;
  const int k_begin = split * kchunk;
  const int k_end = min(g.K, k_begin + kchunk);
  for (int gi = 0; gi < g.ngroups; ++gi) {
    const int v = g.ngroups > 1 ? gi : d;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    simt_mainloop<kTA, kTB>(g.a[v], g.b[v], m0, n0, k_begin, k_end, acc, st);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + simt_row(i);
      if (m >= g.M) continue;
#pragma unroll
      for (int j = 0; j < 8; j += 4) {  // four adjacent columns
        const float v[4] = {round_to<R>(acc[i][j]), round_to<R>(acc[i][j + 1]),
                            round_to<R>(acc[i][j + 2]),
                            round_to<R>(acc[i][j + 3])};
        epi_put<4>(epi, d, split, m, n0 + simt_col(j), g.N, v, gi > 0);
      }
    }
  }
}

// ------------------------------------------------------- bf16: wgmma
// A stage holds A [128 x 64] then B [64 x 128], 16 KB each, in wgmma's
// 128-byte-swizzled layouts: K-major, row r (m or n) at r * 128 bytes with
// its eight 16-byte k chunks; MN-major, per 64-wide m/n atom (8 KB each)
// k-row k at k * 128 bytes with its eight 16-byte m/n chunks. The swizzle
// moves chunk j of 128-byte row i to chunk j ^ (i % 8) inside each
// 1024-byte group, which the hardware undoes from the address bits.
__device__ __forceinline__ unsigned swz(unsigned off) {
  return off ^ ((off >> 3) & 0x70u);
}

// wgmma's shared-memory descriptor. MN-major: lbo the stride of the 64-wide
// m/n atoms, sbo that of the 8-row k groups; K-major: sbo the stride of
// the 8-row m/n groups (lbo unused by the 128-byte swizzle: 16)
__device__ __forceinline__ unsigned long long wg_desc(unsigned saddr,
                                                      unsigned lbo,
                                                      unsigned sbo) {
  return static_cast<unsigned long long>((saddr & 0x3FFFFu) >> 4) |
         static_cast<unsigned long long>((lbo & 0x3FFFFu) >> 4) << 16 |
         static_cast<unsigned long long>((sbo & 0x3FFFFu) >> 4) << 32 |
         1ull << 62;  // 128-byte swizzle
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving accumulator registers across an
// asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A . B for one 64 x 128 x 16 step; kTA / kTB: the operand is
// MN-major (wgmma's transpose bit)
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 unsigned long long da,
                                                 unsigned long long db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
}

// One stage's operands in registers: four 16-byte segments of A and four
// of B per thread (segment s = t + 256 i of the stage's 1,024). K-major:
// row s / 8, k chunk s % 8; MN-major: k-row s / 16, m/n chunk s % 16.
template <bool kTA, bool kTB>
__device__ __forceinline__ void wg_load(const View<__nv_bfloat16>& a,
                                        const View<__nv_bfloat16>& b, int m0,
                                        int n0, int k0, int k_end,
                                        uint4 (&ra)[4], uint4 (&rb)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = threadIdx.x + kEngineThreads * i;
    if (!kTA)
      ra[i] = load_seg(a, m0 + s / 8, k0 + (s % 8) * 8, min(a.cols, k_end),
                       true);
    else
      ra[i] = load_seg(a, k0 + s / 16, m0 + (s % 16) * 8, a.cols,
                       k0 + s / 16 < k_end);
    if (kTB)
      rb[i] = load_seg(b, n0 + s / 8, k0 + (s % 8) * 8, min(b.cols, k_end),
                       true);
    else
      rb[i] = load_seg(b, k0 + s / 16, n0 + (s % 16) * 8, b.cols,
                       k0 + s / 16 < k_end);
  }
}

// byte offset in its tile of segment s, MN-major or K-major (swizzled)
__device__ __forceinline__ unsigned wg_seg_off(unsigned s, bool mn_major) {
  const unsigned kmaj = (s / 8) * 128 + (s % 8) * 16;
  const unsigned mnmaj = (s % 16) / 8 * 8192 + (s / 16) * 128 + (s % 8) * 16;
  return swz(mn_major ? mnmaj : kmaj);
}

template <bool kTA, bool kTB>
__device__ __forceinline__ void wg_store(unsigned char* stage,
                                         const uint4 (&ra)[4],
                                         const uint4 (&rb)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned s = threadIdx.x + kEngineThreads * i;
    *reinterpret_cast<uint4*>(stage + wg_seg_off(s, kTA)) = ra[i];
    *reinterpret_cast<uint4*>(stage + kWgTileBytes + wg_seg_off(s, !kTB)) =
        rb[i];
  }
}

// 3x: wg_load's segments of f32 operands, each as two 16-byte halves
// (ra[2 i], ra[2 i + 1]: eight k, or m/n, values from the segment's start)
template <bool kTA, bool kTB>
__device__ __forceinline__ void wg3_load(const View<float>& a,
                                         const View<float>& b, int m0,
                                         int n0, int k0, int k_end,
                                         uint4 (&ra)[8], uint4 (&rb)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = threadIdx.x + kEngineThreads * i;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!kTA)
        ra[2 * i + h] = load_seg(a, m0 + s / 8, k0 + (s % 8) * 8 + 4 * h,
                                 min(a.cols, k_end), true);
      else
        ra[2 * i + h] = load_seg(a, k0 + s / 16, m0 + (s % 16) * 8 + 4 * h,
                                 a.cols, k0 + s / 16 < k_end);
      if (kTB)
        rb[2 * i + h] = load_seg(b, n0 + s / 8, k0 + (s % 8) * 8 + 4 * h,
                                 min(b.cols, k_end), true);
      else
        rb[2 * i + h] = load_seg(b, k0 + s / 16, n0 + (s % 16) * 8 + 4 * h,
                                 b.cols, k0 + s / 16 < k_end);
    }
  }
}

// the eight f32 values of (f0, f1) split into bf16 hi = RN(v) and lo =
// RN(v - hi), each packed into 16 bytes (the first value in the low half
// of the first word); v - hi is exact in f32, and zeros split to zeros
__device__ __forceinline__ void split_bf16x8(const uint4& f0, const uint4& f1,
                                             uint4& hi, uint4& lo) {
  const float v[8] = {__uint_as_float(f0.x), __uint_as_float(f0.y),
                      __uint_as_float(f0.z), __uint_as_float(f0.w),
                      __uint_as_float(f1.x), __uint_as_float(f1.y),
                      __uint_as_float(f1.z), __uint_as_float(f1.w)};
  unsigned h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 hh = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    const float2 back = __bfloat1622float2(hh);
    const __nv_bfloat162 ll =
        __floats2bfloat162_rn(v[2 * i] - back.x, v[2 * i + 1] - back.y);
    h[i] = *reinterpret_cast<const unsigned*>(&hh);
    l[i] = *reinterpret_cast<const unsigned*>(&ll);
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// 3x: split each segment and store its hi half into A_hi / B_hi (the
// stage's first two tiles) and its lo half into A_lo / B_lo (the next two)
template <bool kTA, bool kTB>
__device__ __forceinline__ void wg3_store(unsigned char* stage,
                                          const uint4 (&ra)[8],
                                          const uint4 (&rb)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned s = threadIdx.x + kEngineThreads * i;
    uint4 hi, lo;
    split_bf16x8(ra[2 * i], ra[2 * i + 1], hi, lo);
    *reinterpret_cast<uint4*>(stage + wg_seg_off(s, kTA)) = hi;
    *reinterpret_cast<uint4*>(stage + 2 * kWgTileBytes +
                              wg_seg_off(s, kTA)) = lo;
    split_bf16x8(rb[2 * i], rb[2 * i + 1], hi, lo);
    *reinterpret_cast<uint4*>(stage + kWgTileBytes + wg_seg_off(s, !kTB)) =
        hi;
    *reinterpret_cast<uint4*>(stage + 3 * kWgTileBytes +
                              wg_seg_off(s, !kTB)) = lo;
  }
}

// T = __nv_bfloat16: the bf16 body; T = float: the 3x body (the operands
// split into hi and lo as they are stored, three wgmma a k16 step). The
// tensor cores add each step's products into the accumulators without
// f32's round to nearest, and the error grows with K: three passes into
// one set of accumulators read 7.8e-5 of the largest entry from the
// twin's f32 sums at K = 10,112 (K4's dh) on an H100, 2.3e-6 to 3.1e-6
// over the splits of 781 rows of the dW products. So the 3x body sums a
// stage's 64 k in `part` and adds it to acc in f32 after the stage (then
// 5.2e-6 to 1.4e-5 at K4's dh, at most 6.2e-7 at every main-path shape;
// the wait for each stage's products cost 3-4%: dW_rec 0.129 -> 0.134
// ms, dx 0.243 -> 0.251 ms).
template <bool kTA, bool kTB, typename T>
__device__ __forceinline__ void wg_mainloop(const View<T>& a,
                                            const View<T>& b, int m0, int n0,
                                            int k_begin, int k_end,
                                            float (&acc)[64],
                                            unsigned char* smem) {
  constexpr bool k3x = std::is_same<T, float>::value;
  constexpr int kStage = (k3x ? 4 : 2) * kWgTileBytes;
  constexpr int kRegs = k3x ? 8 : 4;
  const int nk = (k_end - k_begin + kWgBK - 1) / kWgBK;
  if (nk <= 0) return;
  const int wg = threadIdx.x / 128;
  const unsigned sbase =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  uint4 ra[kRegs], rb[kRegs];
  float part[k3x ? 64 : 1];
  if constexpr (k3x) {
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = 0.0f;
  }
  for (int s = 0; s < 2 && s < nk; ++s) {
    if constexpr (k3x) {
      wg3_load<kTA, kTB>(a, b, m0, n0, k_begin + s * kWgBK, k_end, ra, rb);
      wg3_store<kTA, kTB>(smem + s * kStage, ra, rb);
    } else {
      wg_load<kTA, kTB>(a, b, m0, n0, k_begin + s * kWgBK, k_end, ra, rb);
      wg_store<kTA, kTB>(smem + s * kStage, ra, rb);
    }
  }
  fence_async_smem();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const bool more = kt + 2 < nk;
    if (more) {
      if constexpr (k3x)
        wg3_load<kTA, kTB>(a, b, m0, n0, k_begin + (kt + 2) * kWgBK, k_end,
                           ra, rb);
      else
        wg_load<kTA, kTB>(a, b, m0, n0, k_begin + (kt + 2) * kWgBK, k_end,
                          ra, rb);
    }
    // this warpgroup's 64 rows of A (one m atom, or rows 64 wg ..) and all
    // of B; a k16 step is 32 bytes along a K-major row, 16 k-rows (2,048
    // bytes) of an MN-major atom
    const unsigned sa = sbase + (kt % kWgStages) * kStage + wg * 8192;
    const unsigned sb = sbase + (kt % kWgStages) * kStage + kWgTileBytes;
    if constexpr (k3x)
      fence_acc(part);
    else
      fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int j = 0; j < kWgBK / 16; ++j) {
      const unsigned oa = j * (kTA ? 2048 : 32), ob = j * (kTB ? 32 : 2048);
      const unsigned long long da = wg_desc(sa + oa, kTA ? 8192 : 16, 1024);
      const unsigned long long db = wg_desc(sb + ob, kTB ? 16 : 8192, 1024);
      if constexpr (k3x) {  // hi . hi, hi . lo, then lo . hi
        constexpr unsigned kLo = 2 * kWgTileBytes;
        wgmma_m64n128k16<kTA ? 1 : 0, kTB ? 0 : 1>(part, da, db);
        wgmma_m64n128k16<kTA ? 1 : 0, kTB ? 0 : 1>(
            part, da, wg_desc(sb + kLo + ob, kTB ? 16 : 8192, 1024));
        wgmma_m64n128k16<kTA ? 1 : 0, kTB ? 0 : 1>(
            part, wg_desc(sa + kLo + oa, kTA ? 8192 : 16, 1024), db);
      } else {
        wgmma_m64n128k16<kTA ? 1 : 0, kTB ? 0 : 1>(acc, da, db);
      }
    }
    wg_commit();
    if constexpr (k3x) {
      // the stage's sum, into acc in f32
      wg_wait<0>();
      fence_acc(part);
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        acc[i] += part[i];
        part[i] = 0.0f;
      }
    } else {
      wg_wait<1>();
      fence_acc(acc);
    }
    // every warpgroup is done with stage kt - 1, which the stores below
    // refill, and the stores of the iteration before (stage kt + 1) are
    // visible to the next wgmma
    __syncthreads();
    if (more) {
      if constexpr (k3x)
        wg3_store<kTA, kTB>(smem + ((kt + 2) % kWgStages) * kStage, ra, rb);
      else
        wg_store<kTA, kTB>(smem + ((kt + 2) % kWgStages) * kStage, ra, rb);
      fence_async_smem();
    }
  }
  wg_wait<0>();
  fence_acc(acc);
}

template <bool kTA, bool kTB, typename R, typename T, class Epi>
__device__ __forceinline__ void gemm_wgmma(const GemmArgs<T>& g,
                                           const Epi& epi) {
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  // the swizzle repeats every 1024 bytes: align the ring to it
  const unsigned s0 =
      static_cast<unsigned>(__cvta_generic_to_shared(gemm_smem));
  unsigned char* smem = gemm_smem + ((1024u - (s0 & 1023u)) & 1023u);
  const int z = blockIdx.z;
  const int d = z / g.nsplit;
  const int split = z % g.nsplit;
  const int m0 = blockIdx.x * kEngineBM;
  const int n0 = blockIdx.y * kEngineBN;
  const int kchunk =
      ((g.K + g.nsplit - 1) / g.nsplit + kWgBK - 1) / kWgBK * kWgBK;
  const int k_begin = split * kchunk;
  const int k_end = min(g.K, k_begin + kchunk);
  // accumulator fragment of m64nNk16: warp w of the warpgroup holds rows
  // 16 w .. 16 w + 15; register 4 j + q is row lane / 4 + 8 (q / 2),
  // column 8 j + 2 (lane % 4) + q % 2
  const int lane = threadIdx.x % 32;
  const int row0 =
      m0 + (threadIdx.x / 128) * 64 + ((threadIdx.x / 32) % 4) * 16 + lane / 4;
  const int col0 = n0 + (lane % 4) * 2;
  for (int gi = 0; gi < g.ngroups; ++gi) {
    const int v = g.ngroups > 1 ? gi : d;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    if (gi > 0) __syncthreads();  // the last group's wgmma read the ring
    wg_mainloop<kTA, kTB, T>(g.a[v], g.b[v], m0, n0, k_begin, k_end, acc,
                             smem);
    // two adjacent columns in one store, but for the split-K partials:
    // there the wider store's address arithmetic spills, and costs more
    // than it saves
    constexpr int kW = std::is_same<Epi, EpiPartial>::value ? 1 : 2;
#pragma unroll
    for (int i = 0; i < 64; i += kW) {
      const int m = row0 + 8 * ((i % 4) / 2);
      float v[kW];
#pragma unroll
      for (int w = 0; w < kW; ++w) v[w] = round_to<R>(acc[i + w]);
      if (m < g.M)
        epi_put<kW>(epi, d, split, m, col0 + 8 * (i / 4) + i % 2, g.N, v,
                    gi > 0);
    }
  }
}

// Use names the product (for a profile); T is float (the SIMT body) or
// __nv_bfloat16 (wgmma); R is the type each group's product is rounded to.
// Two blocks share an SM: each one's loads and epilogue hide behind the
// other's products.
template <class Use, typename T, bool kTA, bool kTB, typename R, class Epi>
__global__ void __launch_bounds__(kEngineThreads, 2)
    gemm_kernel(GemmArgs<T> g, Epi epi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    gemm_wgmma<kTA, kTB, R>(g, epi);
  else
    gemm_simt<kTA, kTB, R>(g, epi);
}

// f32 operands as three bf16 passes (--f32_matmul 3x): the wgmma body on
// f32 Views, one block an SM (its ring takes 197,632 bytes), so that up
// to 255 registers a thread hold the f32 halves in flight beside the
// accumulators
template <class Use, bool kTA, bool kTB, typename R, class Epi>
__global__ void __launch_bounds__(kEngineThreads, 1)
    gemm3x_kernel(GemmArgs<float> g, Epi epi) {
  gemm_wgmma<kTA, kTB, R>(g, epi);
}

template <typename T, class Epi>
cudaError_t launch_engine(void (*kernel)(GemmArgs<T>, Epi), int smem,
                          const GemmArgs<T>& g, int outputs, const Epi& epi,
                          cudaStream_t stream) {
  const dim3 grid((g.M + kEngineBM - 1) / kEngineBM,
                  (g.N + kEngineBN - 1) / kEngineBN, outputs * g.nsplit);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kEngineThreads, smem, stream>>>(g, epi);
  return cudaGetLastError();
}

// x3 (f32 operands only): the 3x instance in place of the SIMT body
template <class Use, typename T, bool kTA, bool kTB, typename R, class Epi>
cudaError_t launch_gemm(const GemmArgs<T>& g, int outputs, Epi epi,
                        cudaStream_t stream, bool x3 = false) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_engine<T, Epi>(gemm_kernel<Use, T, kTA, kTB, R, Epi>,
                                 kWgSmem, g, outputs, epi, stream);
  } else {
    if (x3)
      return launch_engine<T, Epi>(gemm3x_kernel<Use, kTA, kTB, R, Epi>,
                                   kWg3Smem, g, outputs, epi, stream);
    return launch_engine<T, Epi>(gemm_kernel<Use, T, kTA, kTB, R, Epi>,
                                 kSimtSmem, g, outputs, epi, stream);
  }
}

// K splits for a reduction of length K: about one split per 192 rows, at
// most 32 (the partial buffer holds nsplit copies of the output), so that
// a dW of a few output tiles still fills the card
inline int gemm_splits(int K) {
  int s = K / 192;
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
