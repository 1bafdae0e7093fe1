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
// (dh = dzc . W^T is one product outside, as in the JAX package; in bf16
// mode it runs in gemm.cuh's engine, as does the logits product, both on
// the tensor cores with f32 sums: softmax_ce_wide_logits and
// softmax_ce_wide_dh below; under --f32_matmul 3x both run in the
// engine's 3x instance, f32 as three bf16 passes.)
//
// Design and what bounds it on this card. K4f must read the logits once:
// 1.0 GB in f32 (0.5 GB in bf16) at N = 25,000, S = 10,112, so bytes bound
// it. A block of 256 threads per row reads the row once, with the widest
// vector load that the base and the row pitch allow (16 bytes at S =
// 10,112; decided per launch by softmax_common.cuh's row_vec_elems), and
// keeps it in registers as loaded (RowVec, up to kWideHold = 40 values a
// thread: rows of up to 10,240 classes; bf16 two to a register).
// From there min/max; then safe_exp once per element, with the exp sum
// and the first argmax of e in the same pass; block-wide reductions
// through shuffles (softmax_common.cuh's group_*). K5f shares RowVec,
// the width rule and the reductions. The
// first argmax of p = e / sum is that of e unless an earlier e within
// 2^-20 of the largest rounds to the same p: only then, rarely, p is taken
// by division (a division per element would bound the kernel by
// instructions). A wider row takes the multi-pass body in the same kernel:
// three passes over the row (min/max, exp sum, p and its argmax), the
// second and third mostly from L2. Loss and count are per-row partials
// added in a fixed order (no float atomics).
//
// K4b is one kernel after the TPU kernel's structure: p recomputed, dz
// written once, dW accumulated per column block. A block owns kBwdCols =
// 128 columns of S, one pass of kBwdPass = 256 rows of dW (P up to 256;
// wider P takes more passes, a grid dimension, each recomputing dz and
// only the first storing dz and db) and a split of the rows (a grid
// dimension: enough blocks for every SM, one block an SM). It walks its
// rows in tiles through a ring of kBwdStages shared-memory stages filled
// by cp.async two tiles ahead: the tile's logits, h's rows (packed first
// into a zero-padded [row tiles, passes * 256] copy, so every copy is an
// aligned 16 bytes) and the rows' constants (bwd_prep_kernel computes
// them with the packing, once a row: the kernel divides nowhere). Each
// tile's dz is computed in place over its logits, stored to device
// memory as dzc and summed into the thread's db columns (unrounded), then
// dW += h_tile^T . dzc_tile from shared memory into registers (logits
// whose rows are not 16-byte aligned, odd S in bf16 for one, are copied
// through registers instead, at the same point of the ring):
// * bf16 (wide_bwd_wgmma_kernel): 64-row tiles, four warpgroups each
//   holding a 64 x 128 block of dW in registers, wgmma m64n128k16 on the
//   tile with both operands MN-major in the 128-byte swizzle (the engine's
//   transpose bits), the next tile's dz computed while the tensor cores
//   run this one's. The logits in (0.5 GB) and dzc out (0.5 GB) bound it:
//   0.31 ms at 3.35 TB/s; h is re-read per column block from L2, 32 KB a
//   tile beside its 16 KB of logits.
// * f32 (wide_bwd_simt_kernel): 32-row tiles, 256 threads each holding a
//   16 x 8 block of dW (the engine's register-blocked SIMT body, twice the
//   outputs a thread: six 16-byte shared loads feed 128 FMAs), true f32.
//   2 N P S operations on the FP32 pipes bound it: 1.89 ms at 67 TFLOP/s.
// * 3x (wide_bwd_3x_kernel, --f32_matmul 3x in f32 mode; the TPU
//   kernel's _kdot(h, dzc, use3) at softmax_ce.py:602): the bf16 kernel's
//   tiles and warpgroups on f32 operands. bwd_prep_kernel packs h as two
//   bf16 planes, hi = RN(h) and lo = RN(h - hi), once (the split is not
//   repeated for each of the 79 column blocks); the logits arrive in f32
//   and dz is formed from them in f32 as in the f32 kernel, stored in f32
//   for dh and summed into db unrounded, then split in registers into
//   dz_hi and dz_lo, written over the tile's logits (32 KB of f32 make
//   room for both bf16 halves; one barrier lets every thread read its
//   logits first); dW += h_hi dz_hi + h_hi dz_lo + h_lo dz_hi, three
//   wgmma a k16 step. A stage holds 98 KB (logits, h's two planes, the
//   constants), so the ring has two stages. Bound: the f32 logits in and
//   dz out (2 GB at the LVCSR tail, 0.60 ms at 3.35 TB/s) against 3 x 2 N
//   P S bf16 operations (0.38 ms at 989 TFLOP/s).
// The row splits leave f32 partials of dW and db, summed in a fixed order
// (sum_partials; no float atomics: a second launch gives the same bits).

// Launch rules: the entry points launch on the caller's stream, allocate
// nothing, never synchronise, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

#include "gemm.cuh"
#include "softmax_common.cuh"

namespace {

// K4f: a row per block of 256 threads, each holding up to kWideHold of its
// logits in registers as loaded: a row of up to 10,240 classes is read
// from device memory once
constexpr int kWideFwdThreads = 256;
constexpr int kWideHold = 40;

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

// ------------------------------------------------------------------- K4b
// Its tiles (ops/softmax_ce.py mirrors them, and a CPU test reads them
// here): a block owns kBwdCols columns of S and one pass of kBwdPass rows
// of dW, and walks its rows in tiles of Bwd<T>::kRows through a ring of
// kBwdStages stages.
constexpr int kBwdCols = 128;
constexpr int kBwdPass = 256;
constexpr int kBwdStages = 3;
constexpr int kBwdMaxPasses = 4;  // P <= 1,024
constexpr int kBwdRowsBf16 = 64;  // a tile is one wgmma K of 64
constexpr int kBwdRowsF32 = 32;
constexpr int kBwdThreadsBf16 = 512;  // four warpgroups
constexpr int kBwdThreadsF32 = 256;
constexpr int kRowFloats = 8;  // a row's constants: two 16-byte chunks
constexpr int kRowBytes = kRowFloats * 4;

template <typename T>
struct Bwd {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kEs = static_cast<int>(sizeof(T));
  static constexpr int kRows = kBf16 ? kBwdRowsBf16 : kBwdRowsF32;
  static constexpr int kThreads = kBf16 ? kBwdThreadsBf16 : kBwdThreadsF32;
  static constexpr int kE = 16 / kEs;               // elements a chunk
  static constexpr int kChunksRow = kBwdCols / kE;  // chunks a tile row
  static constexpr int kRowStep = kThreads / kChunksRow;
  static constexpr int kChunks = kRows / kRowStep;  // a thread's, a tile
  // a stage: the logits (then dz) [kRows, kBwdCols], h [kRows, kBwdPass],
  // and the rows' constants (kRowFloats each: bwd_prep_kernel)
  static constexpr int kZBytes = kRows * kBwdCols * kEs;
  static constexpr int kHBytes = kRows * kBwdPass * kEs;
  static constexpr int kStageBytes = kZBytes + kHBytes + kRows * kRowBytes;
  // plus 1 KB to align the ring to the swizzle's 1,024 bytes
  static constexpr int kSmem = kBwdStages * kStageBytes + 1024;
};

// The 3x instance's tiles: the bf16 kernel's 64-row tiles and 512 threads
// on f32 logits (a thread's dz chunks are four f32 columns), h as two bf16
// planes, and a ring of two stages of kStageBytes (100,352 bytes)
constexpr int kBwdRows3x = 64;
constexpr int kBwd3xStages = 2;
struct Bwd3x {
  static constexpr int kRows = kBwdRows3x;
  static constexpr int kThreads = kBwdThreadsBf16;
  static constexpr int kE = 4;
  static constexpr int kChunksRow = kBwdCols / kE;
  static constexpr int kRowStep = kThreads / kChunksRow;
  static constexpr int kChunks = kRows / kRowStep;
  // the f32 logits [kRows, kBwdCols], then dz_hi and dz_lo over them
  static constexpr int kZBytes = kRows * kBwdCols * 4;
  static constexpr int kZHalf = kRows * kBwdCols * 2;
  static constexpr int kHPlane = kRows * kBwdPass * 2;  // h_hi, then h_lo
  static constexpr int kHBytes = 2 * kHPlane;
  static constexpr int kStageBytes = kZBytes + kHBytes + kRows * kRowBytes;
  static constexpr int kSmem = kBwd3xStages * kStageBytes + 1024;
};

template <typename T>
struct BwdArgs {
  const T* a;  // the logits [N, S]
  View<T> av;  // the same, for copies through registers
  const T* hp;  // h packed: [row tiles * kRows, hp_ld], zero-padded
  const __nv_bfloat16* hx;  // 3x: h packed as its hi plane, then its lo
  const float* rowc;  // the rows' constants [row tiles * kRows, kRowFloats]
  T* dz;
  float* db_part;  // [nsplit, S]
  float* wout;     // dW's partials [nsplit, P, S], or dW (one split)
  int N, P, S, hp_ld, ntiles, tps;  // tps: row tiles a split
};

// 16 (or 4) bytes from src to shared dst by cp.async; zeros where !ok
template <int kBytes>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src,
                                               bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
}

// Byte offsets in a stage of 16-byte chunk j of row r of the logits (dz)
// tile, and of chunk c of row r of the h tile: in bf16 wgmma's MN-major
// layouts (64-wide atoms of 8 KB, each row's chunks in the 128-byte
// swizzle), in f32 plain rows
template <typename T>
__device__ __forceinline__ unsigned bwd_z_off(int r, int j) {
  if constexpr (Bwd<T>::kBf16)
    return swz((j / 8) * 8192 + r * 128 + (j % 8) * 16);
  else
    return r * (kBwdCols * 4) + j * 16;
}
template <typename T>
__device__ __forceinline__ unsigned bwd_h_off(int r, int c) {
  if constexpr (Bwd<T>::kBf16)
    return Bwd<T>::kZBytes + swz((c / 8) * 8192 + r * 128 + (c % 8) * 16);
  else
    return Bwd<T>::kZBytes + r * (kBwdPass * 4) + c * 16;
}

// The constants of the warp's kChunks * (32 / kChunksRow) = 4 rows (the
// rows its threads' dz chunks lie in) into stage st, two 16-byte halves
// each, by its lanes 0 .. 7: every row's consumers and copier share a warp
template <class G>
__device__ __forceinline__ void bwd_fill_consts(const float* rowc,
                                                unsigned char* st, int row0) {
  constexpr int kPer = 32 / G::kChunksRow;  // r0 values a warp holds
  static_assert(G::kChunks * kPer * 2 == 8, "eight halves a warp");
  const int lane = threadIdx.x % 32;
  if (lane < 8) {
    const int sel = lane / 2;
    const int r = (threadIdx.x / 32) * kPer + sel % kPer +
                  (sel / kPer) * G::kRowStep;
    cp_async_zfill<16>(
        st + G::kZBytes + G::kHBytes + r * kRowBytes + (lane % 2) * 16,
        rowc + static_cast<size_t>(row0 + r) * kRowFloats + (lane % 2) * 4,
        true);
  }
}

// Start the copies of row tile `tile` into stage st: the logits of the
// block's columns (cp.async where kAligned, else through registers), h's
// columns of this pass and its rows' constants
template <typename T, bool kAligned>
__device__ __forceinline__ void bwd_fill(const BwdArgs<T>& g,
                                         unsigned char* st, int tile, int n0,
                                         int pass) {
  using G = Bwd<T>;
  const int row0 = tile * G::kRows;
#pragma unroll
  for (int i = 0; i < G::kRows * G::kChunksRow / G::kThreads; ++i) {
    const int c = threadIdx.x + i * G::kThreads;
    const int r = c / G::kChunksRow, j = c % G::kChunksRow;
    const int row = row0 + r, col = n0 + j * G::kE;
    unsigned char* dst = st + bwd_z_off<T>(r, j);
    if constexpr (kAligned) {
      const bool ok = row < g.N && col < g.S;
      cp_async_zfill<16>(
          dst, ok ? g.a + static_cast<size_t>(row) * g.S + col : g.a, ok);
    } else {
      *reinterpret_cast<uint4*>(dst) = load_seg(g.av, row, col, g.S, true);
    }
  }
  constexpr int kHChunksRow = kBwdPass / G::kE;
#pragma unroll
  for (int i = 0; i < G::kRows * kHChunksRow / G::kThreads; ++i) {
    const int c = threadIdx.x + i * G::kThreads;
    const int r = c / kHChunksRow, k = c % kHChunksRow;
    cp_async_zfill<16>(st + bwd_h_off<T>(r, k),
                       g.hp + static_cast<size_t>(row0 + r) * g.hp_ld +
                           pass * kBwdPass + k * G::kE,
                       true);
  }
  bwd_fill_consts<G>(g.rowc, st, row0);
}

// 3x: the copies of row tile `tile` into stage st: the f32 logits of the
// block's columns in plain rows (as the f32 kernel's), h's hi and lo
// planes of this pass in the bf16 kernel's MN-major layout, and the rows'
// constants
template <bool kAligned>
__device__ __forceinline__ void bwd_fill3x(const BwdArgs<float>& g,
                                           unsigned char* st, int tile,
                                           int n0, int pass) {
  using G = Bwd3x;
  const int row0 = tile * G::kRows;
#pragma unroll
  for (int i = 0; i < G::kRows * G::kChunksRow / G::kThreads; ++i) {
    const int c = threadIdx.x + i * G::kThreads;
    const int r = c / G::kChunksRow, j = c % G::kChunksRow;
    const int row = row0 + r, col = n0 + j * G::kE;
    unsigned char* dst = st + r * (kBwdCols * 4) + j * 16;
    if constexpr (kAligned) {
      const bool ok = row < g.N && col < g.S;
      cp_async_zfill<16>(
          dst, ok ? g.a + static_cast<size_t>(row) * g.S + col : g.a, ok);
    } else {
      *reinterpret_cast<uint4*>(dst) = load_seg(g.av, row, col, g.S, true);
    }
  }
  constexpr int kHChunksRow = kBwdPass / 8;  // bf16 chunks a row
  constexpr int kPlaneChunks = G::kRows * kHChunksRow;
  const size_t plane = static_cast<size_t>(g.ntiles) * G::kRows * g.hp_ld;
#pragma unroll
  for (int i = 0; i < 2 * kPlaneChunks / G::kThreads; ++i) {
    const int c = threadIdx.x + i * G::kThreads;
    const int lo = c / kPlaneChunks, cc = c % kPlaneChunks;
    const int r = cc / kHChunksRow, k = cc % kHChunksRow;
    cp_async_zfill<16>(
        st + G::kZBytes + lo * G::kHPlane +
            swz((k / 8) * 8192 + r * 128 + (k % 8) * 16),
        g.hx + lo * plane + static_cast<size_t>(row0 + r) * g.hp_ld +
            pass * kBwdPass + k * 8,
        true);
  }
  bwd_fill_consts<G>(g.rowc, st, row0);
}

// dz of the thread's kChunks chunks of the tile in stage st (chunk j of
// tile rows r0 + k kRowStep; matrix rows row0 + those), in place over
// their logits, rounded to T; stored to device memory and added
// unrounded into db when `store` (the first pass). The twin's p (onehot
// inv - s) valid g: p times k g, where k is the row's inv - s at the
// target column and -s elsewhere (+0 on a dummy row, pt = 0); the twin
// rounds p k before it multiplies by g, the same value where g = 1 (the
// trainer's cotangent) and one rounding apart elsewhere. p = e / ssum as
// softmax_ce.cu's ce_div takes it, e * RN(1 / ssum) and one FMA
// correction (the quotient correctly rounded), of e = safe_exp(a - off) =
// min(expf(a - off), REAL_MAX) (safeExp's lower cut lies where expf is 0
// already; a branch per element would keep the elements from
// interleaving). bwd_prep_kernel makes both exact without a branch here:
// a row whose ssum is infinite, whose p is 0, gets off = +inf, ssum = 1;
// a row past N all-zero constants (p = 0, dz = 0). Columns past S get a
// finite dz that reaches only dW's and db's columns past S, never stored.
// All chunks are read first and written last, so that their arithmetic
// interleaves.
template <typename T, bool kAligned>
__device__ __forceinline__ void bwd_dz(const BwdArgs<T>& g, unsigned char* st,
                                       int j, int r0, int row0, int col0,
                                       bool store, float (&db)[Bwd<T>::kE]) {
  using G = Bwd<T>;
  constexpr int E = G::kE, C = G::kChunks;
  const float4* rc =
      reinterpret_cast<const float4*>(st + G::kZBytes + G::kHBytes);
  uint4 raw[C];
  float4 c0[C], c1[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int r = r0 + k * G::kRowStep;
    raw[k] = *reinterpret_cast<const uint4*>(st + bwd_z_off<T>(r, j));
    c0[k] = rc[2 * r];  // off, ssum, 1 / ssum, -s g
    c1[k] = rc[2 * r + 1];  // (inv - s) g, the target, 0, 0
  }
  uint4 out[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const unsigned w_in[4] = {raw[k].x, raw[k].y, raw[k].z, raw[k].w};
    const int et = __float_as_int(c1[k].y) - col0;  // the target's element
    float d[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float v;
      if constexpr (G::kBf16)  // two a word, the first in the low half
        v = __uint_as_float(e % 2 ? w_in[e / 2] & 0xffff0000u
                                  : w_in[e / 2] << 16);
      else
        v = __uint_as_float(w_in[e]);
      const float ex = fminf(expf(v - c0[k].x), kRealMax);
      const float q = ex * c0[k].z;
      const float p = fmaf(fmaf(-q, c0[k].y, ex), c0[k].z, q);
      d[e] = p * (e == et ? c1[k].x : c0[k].w);
      if (store) db[e] += d[e];
    }
    unsigned w[4];
    if constexpr (G::kBf16) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 b2 =
            __floats2bfloat162_rn(d[2 * i], d[2 * i + 1]);
        w[i] = *reinterpret_cast<const unsigned*>(&b2);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(d[i]);
    }
    out[k] = make_uint4(w[0], w[1], w[2], w[3]);
  }
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int r = r0 + k * G::kRowStep, row = row0 + r;
    *reinterpret_cast<uint4*>(st + bwd_z_off<T>(r, j)) = out[k];
    if (store && row < g.N && col0 < g.S) {
      T* dst = g.dz + static_cast<size_t>(row) * g.S + col0;
      if constexpr (kAligned) {
        *reinterpret_cast<uint4*>(dst) = out[k];
      } else {
        const unsigned w[4] = {out[k].x, out[k].y, out[k].z, out[k].w};
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (col0 + e >= g.S) break;
          if constexpr (G::kBf16)
            dst[e] = __ushort_as_bfloat16(
                static_cast<unsigned short>(w[e / 2] >> (16 * (e % 2))));
          else
            dst[e] = __uint_as_float(w[e]);
        }
      }
    }
  }
}

// 3x: dz of the thread's kChunks chunks of four f32 columns, as bwd_dz
// computes it in f32 (added into db when `store`, and stored to device
// memory in f32), then split into bf16 hi = RN(dz) and lo = RN(dz - hi)
// and written over the tile's logits as dz_hi [kRows, kBwdCols] and dz_lo
// after it, in the bf16 kernel's MN-major layout. The split layout puts a
// chunk where other threads' logits lie: every thread reads its logits
// before any writes (one barrier), and, as bwd_dz, reads all its chunks
// first and writes them last. (A form that computed and stored each
// chunk before reading the next crashed ptxas of CUDA 12.9.)
template <bool kAligned>
__device__ __forceinline__ void bwd_dz3x(const BwdArgs<float>& g,
                                         unsigned char* st, int j, int r0,
                                         int row0, int col0, bool store,
                                         float (&db)[Bwd3x::kE]) {
  using G = Bwd3x;
  constexpr int C = G::kChunks;
  const float4* rc =
      reinterpret_cast<const float4*>(st + G::kZBytes + G::kHBytes);
  float4 raw[C], c0[C], c1[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int r = r0 + k * G::kRowStep;
    raw[k] = *reinterpret_cast<const float4*>(st + r * (kBwdCols * 4) +
                                              j * 16);
    c0[k] = rc[2 * r];
    c1[k] = rc[2 * r + 1];
  }
  uint2 hi[C], lo[C];
  float4 out[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int et = __float_as_int(c1[k].y) - col0;  // the target's element
    const float v[4] = {raw[k].x, raw[k].y, raw[k].z, raw[k].w};
    float d[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // bwd_dz's arithmetic
      const float ex = fminf(expf(v[e] - c0[k].x), kRealMax);
      const float q = ex * c0[k].z;
      const float p = fmaf(fmaf(-q, c0[k].y, ex), c0[k].z, q);
      d[e] = p * (e == et ? c1[k].x : c0[k].w);
      if (store) db[e] += d[e];
    }
    out[k] = make_float4(d[0], d[1], d[2], d[3]);
    unsigned h[2], l[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat162 hh = __floats2bfloat162_rn(d[2 * i], d[2 * i + 1]);
      const float2 back = __bfloat1622float2(hh);
      const __nv_bfloat162 ll =
          __floats2bfloat162_rn(d[2 * i] - back.x, d[2 * i + 1] - back.y);
      h[i] = *reinterpret_cast<const unsigned*>(&hh);
      l[i] = *reinterpret_cast<const unsigned*>(&ll);
    }
    hi[k] = make_uint2(h[0], h[1]);
    lo[k] = make_uint2(l[0], l[1]);
  }
  __syncthreads();  // every thread has read its logits
  const int jb = j / 2;  // the 16-byte bf16 chunk, and its half
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int r = r0 + k * G::kRowStep, row = row0 + r;
    const unsigned off =
        swz((jb / 8) * 8192 + r * 128 + (jb % 8) * 16) + (j % 2) * 8;
    *reinterpret_cast<uint2*>(st + off) = hi[k];
    *reinterpret_cast<uint2*>(st + G::kZHalf + off) = lo[k];
    if (store && row < g.N && col0 < g.S) {
      float* dst = g.dz + static_cast<size_t>(row) * g.S + col0;
      if constexpr (kAligned) {
        *reinterpret_cast<float4*>(dst) = out[k];
      } else {
        const float o[4] = {out[k].x, out[k].y, out[k].z, out[k].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col0 + e < g.S) dst[e] = o[e];
      }
    }
  }
}

// v into dst[0 .. W - 1], those of them below `room`
template <int W>
__device__ __forceinline__ void bwd_put(float* dst, const float (&v)[W],
                                        int room) {
  if (room >= W && put_f32<W>(dst, v, false)) return;
#pragma unroll
  for (int e = 0; e < W; ++e)
    if (e < room) dst[e] = v[e];
}

// The block's db partial: the threads' column sums, added over the row
// groups in order, into db_part[split] (ring: the free stages)
template <typename T, class G = Bwd<T>>
__device__ __forceinline__ void bwd_db(const BwdArgs<T>& g,
                                       unsigned char* ring, int j, int r0,
                                       int n0, int split,
                                       const float (&db)[G::kE]) {
  float* red = reinterpret_cast<float*>(ring);  // [kRowStep, kBwdCols]
  __syncthreads();  // every thread is done with the ring
#pragma unroll
  for (int e = 0; e < G::kE; ++e)
    red[r0 * kBwdCols + j * G::kE + e] = db[e];
  __syncthreads();
  if (threadIdx.x < kBwdCols && n0 + threadIdx.x < g.S) {
    float s = 0.0f;
    for (int q = 0; q < G::kRowStep; ++q)
      s += red[q * kBwdCols + threadIdx.x];
    g.db_part[static_cast<size_t>(split) * g.S + n0 + threadIdx.x] = s;
  }
}

// bf16: grid (column blocks, splits, passes) of 512 threads. Warpgroup wg
// holds dW rows pass * 256 + 64 wg .. + 63 of the block's 128 columns
// (wgmma's accumulator fragment); thread t computes dz of chunk t % 16 of
// tile rows t / 16 and t / 16 + 32.
template <bool kAligned>
__global__ void __launch_bounds__(kBwdThreadsBf16, 1)
    wide_bwd_wgmma_kernel(BwdArgs<__nv_bfloat16> g) {
  using T = __nv_bfloat16;
  using G = Bwd<T>;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  // the swizzle repeats every 1024 bytes: align the ring to it
  const unsigned s0 =
      static_cast<unsigned>(__cvta_generic_to_shared(bwd_smem));
  const unsigned pad = (1024u - (s0 & 1023u)) & 1023u;
  unsigned char* ring = bwd_smem + pad;
  const int n0 = blockIdx.x * kBwdCols, split = blockIdx.y;
  const int pass = blockIdx.z;
  const int t0 = split * g.tps;
  const int nt = min(g.ntiles, t0 + g.tps) - t0;
  const bool store = pass == 0;
  const int wg = threadIdx.x / 128;
  const bool mma = pass * kBwdPass + wg * 64 < g.P;
  const int j = threadIdx.x % G::kChunksRow, r0 = threadIdx.x / G::kChunksRow;
  float acc[64], db[G::kE];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int e = 0; e < G::kE; ++e) db[e] = 0.0f;
  for (int s = 0; s < kBwdStages - 1; ++s) {
    if (s < nt)
      bwd_fill<T, kAligned>(g, ring + s * G::kStageBytes, t0 + s, n0, pass);
    cp_async_commit();
  }
  for (int i = 0; i < nt; ++i) {
    unsigned char* st = ring + (i % kBwdStages) * G::kStageBytes;
    // tile i's copies: the thread's own logits chunks, and its rows'
    // constants, which its warp copied
    cp_async_wait<kBwdStages - 2>();
    __syncwarp();
    bwd_dz<T, kAligned>(g, st, j, r0, (t0 + i) * G::kRows, n0 + j * G::kE,
                        store, db);
    fence_async_smem();  // dz and h, for wgmma's reads
    wg_wait<0>();        // tile i - 1's product, this warpgroup's
    fence_acc(acc);
    // dz of tile i is whole, and every warpgroup is done with tile i - 1,
    // whose stage the copies below refill
    __syncthreads();
    if (i + kBwdStages - 1 < nt)
      bwd_fill<T, kAligned>(
          g, ring + ((i + kBwdStages - 1) % kBwdStages) * G::kStageBytes,
          t0 + i + kBwdStages - 1, n0, pass);
    cp_async_commit();
    if (mma) {
      // a k16 step is 16 rows (2,048 bytes) of each MN-major tile
      const unsigned sz =
          static_cast<unsigned>(__cvta_generic_to_shared(st));
      const unsigned sh = sz + G::kZBytes + wg * 8192;
      fence_acc(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < G::kRows / 16; ++kk)
        wgmma_m64n128k16<1, 1>(acc, wg_desc(sh + kk * 2048, 8192, 1024),
                               wg_desc(sz + kk * 2048, 8192, 1024));
      wg_commit();
    }
  }
  wg_wait<0>();
  fence_acc(acc);
  if (mma) {
    // register 4 q + e: row lane / 4 + 8 (e / 2) of the warp's 16, column
    // 8 q + 2 (lane % 4) + e % 2
    float* out = g.wout + static_cast<size_t>(split) * g.P * g.S;
    const int lane = threadIdx.x % 32;
    const int m0 =
        pass * kBwdPass + wg * 64 + ((threadIdx.x / 32) % 4) * 16 + lane / 4;
    const int c0 = n0 + (lane % 4) * 2;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int m = m0 + 8 * ((i % 4) / 2), n = c0 + 8 * (i / 4);
      const float v[2] = {acc[i], acc[i + 1]};
      if (m < g.P) bwd_put<2>(out + static_cast<size_t>(m) * g.S + n, v,
                              g.S - n);
    }
  }
  if (store) bwd_db<T>(g, ring, j, r0, n0, split, db);
}

// f32: grid (column blocks, splits, passes) of 256 threads. Warp w holds dW
// rows pass * 256 + 64 (w / 2) .. + 63 and the block's columns 64 (w % 2)
// .. + 63; a thread 16 x 8 of them, rows ar + 16 s + i and columns
// bc + 32 s + i (the engine's strips, twice the rows); thread t computes
// dz of chunk t % 32 of tile rows t / 32 + 8 k.
template <bool kAligned>
__global__ void __launch_bounds__(kBwdThreadsF32, 1)
    wide_bwd_simt_kernel(BwdArgs<float> g) {
  using G = Bwd<float>;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  unsigned char* ring = bwd_smem;
  const int n0 = blockIdx.x * kBwdCols, split = blockIdx.y;
  const int pass = blockIdx.z;
  const int t0 = split * g.tps;
  const int nt = min(g.ntiles, t0 + g.tps) - t0;
  const bool store = pass == 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ar = (warp / 2) * 64 + (lane / 8) * 4;
  const int bc = (warp % 2) * 64 + (lane % 8) * 4;
  const bool mma = pass * kBwdPass + (warp / 2) * 64 < g.P;
  const int j = threadIdx.x % G::kChunksRow, r0 = threadIdx.x / G::kChunksRow;
  float acc[16][8], db[G::kE];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
#pragma unroll
  for (int e = 0; e < G::kE; ++e) db[e] = 0.0f;
  for (int s = 0; s < kBwdStages - 1; ++s) {
    if (s < nt)
      bwd_fill<float, kAligned>(g, ring + s * G::kStageBytes, t0 + s, n0,
                                pass);
    cp_async_commit();
  }
  for (int i = 0; i < nt; ++i) {
    unsigned char* st = ring + (i % kBwdStages) * G::kStageBytes;
    cp_async_wait<kBwdStages - 2>();  // as in the bf16 kernel
    __syncwarp();
    bwd_dz<float, kAligned>(g, st, j, r0, (t0 + i) * G::kRows,
                            n0 + j * G::kE, store, db);
    // dz of tile i is whole, and every warp is done with tile i - 1,
    // whose stage the copies below refill
    __syncthreads();
    if (i + kBwdStages - 1 < nt)
      bwd_fill<float, kAligned>(
          g, ring + ((i + kBwdStages - 1) % kBwdStages) * G::kStageBytes,
          t0 + i + kBwdStages - 1, n0, pass);
    cp_async_commit();
    if (mma) {
      const float* hs = reinterpret_cast<const float*>(st + G::kZBytes);
      const float* zs = reinterpret_cast<const float*>(st);
#pragma unroll 8
      for (int kk = 0; kk < G::kRows; ++kk) {
        float av[16], bv[8];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const float4 x = *reinterpret_cast<const float4*>(
              hs + kk * kBwdPass + ar + 16 * s);
          av[4 * s] = x.x;
          av[4 * s + 1] = x.y;
          av[4 * s + 2] = x.z;
          av[4 * s + 3] = x.w;
        }
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const float4 y = *reinterpret_cast<const float4*>(
              zs + kk * kBwdCols + bc + 32 * s);
          bv[4 * s] = y.x;
          bv[4 * s + 1] = y.y;
          bv[4 * s + 2] = y.z;
          bv[4 * s + 3] = y.w;
        }
#pragma unroll
        for (int a = 0; a < 16; ++a)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
      }
    }
  }
  if (mma) {
    float* out = g.wout + static_cast<size_t>(split) * g.P * g.S;
#pragma unroll
    for (int a = 0; a < 16; ++a) {
      const int m = pass * kBwdPass + ar + 16 * (a / 4) + a % 4;
      if (m >= g.P) continue;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int n = n0 + bc + 32 * s;
        const float v[4] = {acc[a][4 * s], acc[a][4 * s + 1],
                            acc[a][4 * s + 2], acc[a][4 * s + 3]};
        bwd_put<4>(out + static_cast<size_t>(m) * g.S + n, v, g.S - n);
      }
    }
  }
  if (store) bwd_db<float>(g, ring, j, r0, n0, split, db);
}

// 3x: the bf16 kernel's grid, warpgroups and epilogue on f32 operands:
// thread t computes dz of f32 chunk t % 32 of tile rows t / 32 + 16 k;
// each k16 step of a tile issues h_hi . dz_hi, h_hi . dz_lo and h_lo .
// dz_hi into the same accumulators.
template <bool kAligned>
__global__ void __launch_bounds__(kBwdThreadsBf16, 1)
    wide_bwd_3x_kernel(BwdArgs<float> g) {
  using G = Bwd3x;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  const unsigned s0 =
      static_cast<unsigned>(__cvta_generic_to_shared(bwd_smem));
  const unsigned pad = (1024u - (s0 & 1023u)) & 1023u;
  unsigned char* ring = bwd_smem + pad;
  const int n0 = blockIdx.x * kBwdCols, split = blockIdx.y;
  const int pass = blockIdx.z;
  const int t0 = split * g.tps;
  const int nt = min(g.ntiles, t0 + g.tps) - t0;
  const bool store = pass == 0;
  const int wg = threadIdx.x / 128;
  const bool mma = pass * kBwdPass + wg * 64 < g.P;
  const int j = threadIdx.x % G::kChunksRow, r0 = threadIdx.x / G::kChunksRow;
  float acc[64], db[G::kE];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int e = 0; e < G::kE; ++e) db[e] = 0.0f;
  for (int s = 0; s < kBwd3xStages - 1; ++s) {
    if (s < nt)
      bwd_fill3x<kAligned>(g, ring + s * G::kStageBytes, t0 + s, n0, pass);
    cp_async_commit();
  }
  for (int i = 0; i < nt; ++i) {
    unsigned char* st = ring + (i % kBwd3xStages) * G::kStageBytes;
    cp_async_wait<kBwd3xStages - 2>();  // as in the bf16 kernel
    __syncwarp();
    bwd_dz3x<kAligned>(g, st, j, r0, (t0 + i) * G::kRows, n0 + j * G::kE,
                       store, db);
    fence_async_smem();  // dz and h, for wgmma's reads
    wg_wait<0>();        // tile i - 1's product, this warpgroup's
    fence_acc(acc);
    // dz of tile i is whole, and every warpgroup is done with tile i - 1,
    // whose stage the copies below refill
    __syncthreads();
    if (i + kBwd3xStages - 1 < nt)
      bwd_fill3x<kAligned>(
          g, ring + ((i + kBwd3xStages - 1) % kBwd3xStages) * G::kStageBytes,
          t0 + i + kBwd3xStages - 1, n0, pass);
    cp_async_commit();
    if (mma) {
      const unsigned sz =
          static_cast<unsigned>(__cvta_generic_to_shared(st));
      const unsigned sh = sz + G::kZBytes + wg * 8192;
      fence_acc(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < G::kRows / 16; ++kk) {
        const unsigned long long hh = wg_desc(sh + kk * 2048, 8192, 1024);
        const unsigned long long zh = wg_desc(sz + kk * 2048, 8192, 1024);
        wgmma_m64n128k16<1, 1>(acc, hh, zh);
        wgmma_m64n128k16<1, 1>(
            acc, hh, wg_desc(sz + G::kZHalf + kk * 2048, 8192, 1024));
        wgmma_m64n128k16<1, 1>(
            acc, wg_desc(sh + G::kHPlane + kk * 2048, 8192, 1024), zh);
      }
      wg_commit();
    }
  }
  wg_wait<0>();
  fence_acc(acc);
  if (mma) {  // the bf16 kernel's epilogue
    float* out = g.wout + static_cast<size_t>(split) * g.P * g.S;
    const int lane = threadIdx.x % 32;
    const int m0 =
        pass * kBwdPass + wg * 64 + ((threadIdx.x / 32) % 4) * 16 + lane / 4;
    const int c0 = n0 + (lane % 4) * 2;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int m = m0 + 8 * ((i % 4) / 2), n = c0 + 8 * (i / 4);
      const float v[2] = {acc[i], acc[i + 1]};
      if (m < g.P) bwd_put<2>(out + static_cast<size_t>(m) * g.S + n, v,
                              g.S - n);
    }
  }
  if (store) bwd_db<float, Bwd3x>(g, ring, j, r0, n0, split, db);
}

// K4b's operands laid out for its copies, over `rows` rows (the row
// tiles'): hp[r, c] = h[r, c] for r < N, c < P, else 0 (h in the [rows,
// ld] copy the kernel reads in aligned 16-byte chunks), and rowc[r] = the
// row's constants {off, ssum, 1 / ssum, -s g, (inv - s) g, target, 0, 0}
// with inv = -1 / max(pt, REAL_MIN), s = pt inv, g the loss cotangent (all
// zero past N; off = +inf, ssum = 1 where ssum is infinite), so that the
// kernel divides nowhere. k3x (f32 h): the copy is two bf16 planes,
// hi = RN(h) in hp[0, rows * ld) and lo = RN(h - hi) after it.
template <typename T, bool k3x>
__global__ void bwd_prep_kernel(const T* __restrict__ h, int N, int P,
                                void* __restrict__ hp_out, int rows, int ld,
                                const float* __restrict__ off,
                                const float* __restrict__ ssum,
                                const float* __restrict__ pt,
                                const int* __restrict__ tc,
                                const float* __restrict__ g,
                                float* __restrict__ rowc) {
  using S = typename std::conditional<k3x, __nv_bfloat16, T>::type;
  constexpr int E = 16 / static_cast<int>(sizeof(S));  // a 16-byte chunk
  S* hp = static_cast<S*>(hp_out);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = blockIdx.x * static_cast<long long>(blockDim.x) +
                          threadIdx.x;
  const long long chunks = static_cast<long long>(rows) * (ld / E);
  for (long long i = first; i < chunks; i += stride) {
    const long long r = i / (ld / E);
    const int c0 = static_cast<int>(i % (ld / E)) * E;
    union {
      uint4 q;
      S e[E];
    } v, lo;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool in = r < N && c0 + e < P;
      if constexpr (k3x) {
        const float x = in ? as_f32(h[r * P + c0 + e]) : 0.0f;
        v.e[e] = __float2bfloat16_rn(x);
        lo.e[e] = __float2bfloat16_rn(x - __bfloat162float(v.e[e]));
      } else {
        v.e[e] = in ? h[r * P + c0 + e] : f32_to<T>(0.0f);
      }
    }
    *reinterpret_cast<uint4*>(hp + r * ld + c0) = v.q;
    if constexpr (k3x)
      *reinterpret_cast<uint4*>(hp + static_cast<long long>(rows) * ld +
                                r * ld + c0) = lo.q;
  }
  for (long long r = first; r < rows; r += stride) {
    float v[kRowFloats] = {};
    if (r < N) {
      const float inv = -1.0f / fmaxf(pt[r], kRealMin);
      const float srow = pt[r] * inv;
      const bool finite = ssum[r] < CUDART_INF_F;  // else every p is 0
      const float sum = finite ? ssum[r] : 1.0f;
      const float rs = __frcp_rn(sum);
      v[0] = finite ? off[r] : CUDART_INF_F;
      v[1] = sum;
      v[2] = rs;
      v[3] = -srow * g[0];
      v[4] = (inv - srow) * g[0];
      v[5] = __int_as_float(tc[r]);
    }
#pragma unroll
    for (int k = 0; k < kRowFloats; ++k) rowc[r * kRowFloats + k] = v[k];
  }
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
  cudaError_t err;
  switch (row_vec_elems(a, static_cast<size_t>(S) * sizeof(T), sizeof(T))) {
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

template <typename T, bool kAligned>
cudaError_t launch_wide_bwd(const BwdArgs<T>& g, dim3 grid,
                            cudaStream_t stream) {
  using G = Bwd<T>;
  void (*kernel)(BwdArgs<T>);
  if constexpr (G::kBf16)
    kernel = wide_bwd_wgmma_kernel<kAligned>;
  else
    kernel = wide_bwd_simt_kernel<kAligned>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, G::kThreads, G::kSmem, stream>>>(g);
  return cudaGetLastError();
}

template <bool kAligned>
cudaError_t launch_wide_bwd3x(const BwdArgs<float>& g, dim3 grid,
                              cudaStream_t stream) {
  auto kernel = wide_bwd_3x_kernel<kAligned>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Bwd3x::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, Bwd3x::kThreads, Bwd3x::kSmem, stream>>>(g);
  return cudaGetLastError();
}

// x3 (T = float only): the 3x instance, on h packed as bf16 hi and lo
template <typename T>
cudaError_t wide_bwd(const void* a, const void* h, const int* tc,
                     const float* off, const float* ssum, const float* pt,
                     const float* g, void* dz, void* hp, float* rowc,
                     float* db_part, float* w_part, float* dw, float* db,
                     int N, int P, int S, int nsplit, float bias_mult,
                     bool x3, cudaStream_t stream) {
  using G = Bwd<T>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  if (x3 && !kF32) return cudaErrorInvalidValue;
  const int kRows = x3 ? Bwd3x::kRows : G::kRows;
  const int kPackE = x3 ? 8 : G::kE;  // elements of a packed 16-byte chunk
  const int passes = (P + kBwdPass - 1) / kBwdPass;
  const int ntiles = (N + kRows - 1) / kRows;
  if (passes > kBwdMaxPasses || nsplit < 1 || nsplit > ntiles)
    return cudaErrorInvalidValue;
  const int tps = (ntiles + nsplit - 1) / nsplit;
  if ((ntiles + tps - 1) / tps != nsplit)  // a split without rows
    return cudaErrorInvalidValue;
  BwdArgs<T> args;
  args.a = static_cast<const T*>(a);
  args.av = make_view<T>(a, S, N, S);
  args.hp = x3 ? nullptr : static_cast<const T*>(hp);
  args.hx = x3 ? static_cast<const __nv_bfloat16*>(hp) : nullptr;
  args.rowc = rowc;
  args.dz = static_cast<T*>(dz);
  args.db_part = db_part;
  args.wout = nsplit > 1 ? w_part : dw;
  args.N = N;
  args.P = P;
  args.S = S;
  args.hp_ld = passes * kBwdPass;
  args.ntiles = ntiles;
  args.tps = tps;
  const int rows = ntiles * kRows;
  long long blocks =
      (static_cast<long long>(rows) * (args.hp_ld / kPackE) + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  auto prep = bwd_prep_kernel<T, false>;
  if constexpr (kF32)
    if (x3) prep = bwd_prep_kernel<T, true>;
  prep<<<static_cast<int>(blocks), 256, 0, stream>>>(
      static_cast<const T*>(h), N, P, hp, rows, args.hp_ld, off, ssum, pt, tc,
      g, rowc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // every chunk of the logits and of dz 16-byte aligned: cp.async
  const bool aligned =
      ((reinterpret_cast<unsigned long long>(a) |
        reinterpret_cast<unsigned long long>(dz) |
        static_cast<unsigned long long>(S) * sizeof(T)) & 15ull) == 0;
  const dim3 grid((S + kBwdCols - 1) / kBwdCols, nsplit, passes);
  if constexpr (kF32) {
    if (x3)
      err = aligned ? launch_wide_bwd3x<true>(args, grid, stream)
                    : launch_wide_bwd3x<false>(args, grid, stream);
    else
      err = aligned ? launch_wide_bwd<T, true>(args, grid, stream)
                    : launch_wide_bwd<T, false>(args, grid, stream);
  } else {
    err = aligned ? launch_wide_bwd<T, true>(args, grid, stream)
                  : launch_wide_bwd<T, false>(args, grid, stream);
  }
  if (err != cudaSuccess) return err;
  const long long L = static_cast<long long>(P) * S;
  if (nsplit > 1) {
    err = launch_sum_partials(w_part, nsplit, L, dw, L, L, 1.0f, stream);
    if (err != cudaSuccess) return err;
  }
  return launch_sum_partials(db_part, nsplit, S, db, S, 0, bias_mult, stream);
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

// Backward (K4b), one fused kernel. a [N, S] and h [N, P] in the storage
// dtype (bf16 = 1: bf16, else f32); tc [N] int32; off, ssum, pt [N] f32
// from the forward; g [1] f32 (the loss cotangent). Outputs: dz [N, S] (as
// a), dw [P, S] f32, db [S] f32 (times bias_mult). nsplit: the row splits,
// 1 .. row tiles with none empty (ops/softmax_ce.py wide_bwd_plan). Scratch:
// hp [row tiles * rows, passes * 256] as a (rows 64 in bf16, 32 in f32;
// passes = ceil(P / 256) <= 4), rowc [row tiles * rows, 8] f32, db_part
// [nsplit, S] f32, w_part [nsplit, P * S] f32 (unused when nsplit is 1).
// x3 = 1 (f32 only, --f32_matmul 3x): the 3x instance, dW on the tensor
// cores as three bf16 passes; its rows are 64 a tile and hp is two bf16
// planes [2, row tiles * 64, passes * 256].
int softmax_ce_wide_bwd(const void* a, const void* h, const int* tc,
                        const float* off, const float* ssum, const float* pt,
                        const float* g, void* dz, void* hp, float* rowc,
                        float* db_part, float* w_part, float* dw, float* db,
                        int N, int P, int S, int nsplit, float bias_mult,
                        int bf16, int x3, int device, cudaStream_t stream) {
  if (N < 1 || P < 1 || S < 1 || (x3 && bf16)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bf16)
    return wide_bwd<__nv_bfloat16>(a, h, tc, off, ssum, pt, g, dz, hp, rowc,
                                   db_part, w_part, dw, db, N, P, S, nsplit,
                                   bias_mult, false, stream);
  return wide_bwd<float>(a, h, tc, off, ssum, pt, g, dz, hp, rowc, db_part,
                         w_part, dw, db, N, P, S, nsplit, bias_mult, x3 != 0,
                         stream);
}

// The logits product in bf16 mode: a [N, S] bf16 = round(h . W + bias_mult
// * b) for h [N, P] and W [P, S] bf16, b [S] f32: gemm.cuh's engine on the
// tensor cores, f32 sums, the bias product rounded on its own. x3 = 1
// (--f32_matmul 3x): h, W and a f32, in the engine's 3x instance.
int softmax_ce_wide_logits(const void* h, const void* w, const float* b,
                           void* a, int N, int P, int S, float bias_mult,
                           int x3, int device, cudaStream_t stream) {
  if (N < 1 || P < 1 || S < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (x3) {
    GemmArgs<float> ga{};
    ga.a[0] = make_view<float>(h, P, N, P);
    ga.b[0] = make_view<float>(w, S, P, S);
    ga.M = N;
    ga.N = S;
    ga.K = P;
    ga.nsplit = 1;
    ga.ngroups = 1;
    return launch_gemm<GemmTailLogits, float, false, false, float>(
        ga, 1, EpiBias<float>{static_cast<float*>(a), b, bias_mult, 0, S},
        stream, true);
  }
  using T = __nv_bfloat16;
  GemmArgs<T> ga{};
  ga.a[0] = make_view<T>(h, P, N, P);
  ga.b[0] = make_view<T>(w, S, P, S);
  ga.M = N;
  ga.N = S;
  ga.K = P;
  ga.nsplit = 1;
  ga.ngroups = 1;
  return launch_gemm<GemmTailLogits, T, false, false, float>(
      ga, 1, EpiBias<T>{static_cast<T*>(a), b, bias_mult, 0, S}, stream);
}

// The dh product in bf16 mode: dh [N, P] = dzc . W^T for dzc [N, S] and
// W [P, S] bf16, f32 sums stored in f32 (out_f32 = 1) or rounded to bf16.
// x3 = 1 (--f32_matmul 3x): dz, W and dh f32, in the engine's 3x instance.
int softmax_ce_wide_dh(const void* dz, const void* w, void* dh, int N, int P,
                       int S, int out_f32, int x3, int device,
                       cudaStream_t stream) {
  if (N < 1 || P < 1 || S < 1 || (x3 && !out_f32))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (x3) {
    GemmArgs<float> ga{};
    ga.a[0] = make_view<float>(dz, S, N, S);
    ga.b[0] = make_view<float>(w, S, P, S);
    ga.M = N;
    ga.N = P;
    ga.K = S;
    ga.nsplit = 1;
    ga.ngroups = 1;
    return launch_gemm<GemmWideDh, float, false, true, float>(
        ga, 1, EpiStore<float>{static_cast<float*>(dh), P}, stream, true);
  }
  using T = __nv_bfloat16;
  GemmArgs<T> ga{};
  ga.a[0] = make_view<T>(dz, S, N, S);
  ga.b[0] = make_view<T>(w, S, P, S);
  ga.M = N;
  ga.N = P;
  ga.K = S;
  ga.nsplit = 1;
  ga.ngroups = 1;
  if (out_f32)
    return launch_gemm<GemmWideDh, T, false, true, float>(
        ga, 1, EpiStore<float>{static_cast<float*>(dh), P}, stream);
  return launch_gemm<GemmWideDh, T, false, true, float>(
      ga, 1, EpiStore<T>{static_cast<T*>(dh), P}, stream);
}

}  // extern "C"
