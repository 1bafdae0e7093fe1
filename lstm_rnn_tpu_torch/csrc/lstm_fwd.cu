// Forward of one (B)LSTM layer, for NVIDIA Hopper (sm_90a).
//
// Replaces lstm_rnn_tpu/ops/lstm_cell.py::_fwd_kernel in four of its
// variants (carry=True with a step mask, and carry=True with residuals, are
// items 3 and 4 below): save=False, the TPU kernel behind
// lstm_scan_fused's primal, which every frame of the forward-pass
// (posterior dump) mode and of a validation pass goes through; and
// save=True (`_fused_fwd`), the training forward, which also writes the
// residuals the BPTT kernel (lstm_bwd.cu) reads: the cell state c
// [D, T, B, H] f32 and the post-activation gates [ni, ig, fg, og]
// [D, T, B, 4H] in the storage dtype, both zero at padding. The TPU
// kernel's per-chunk boundary rows (cb, hb) exist because Mosaic streams
// chunks through VMEM; the backward here reads c[t +- 1] and h[t +- 1]
// from the full arrays and needs neither.
// It computes, for each direction d (d = 0 walks time ascending, d = 1
// descending) and each row b with `lengths[b]` valid frames:
//
//   a  = x[t, b] . W_in[d] + bias_mult * bias[d]              (4H gates)
//   g  = a + h_prev . W_rec[d]
//   ni = tanh(g_ni)
//   ig = sigma(g_ig + c_prev * p_ig),  fg = sigma(g_fg + c_prev * p_fg)
//   c  = ni * ig + fg * c_prev
//   og = sigma(g_og + c * p_og)                          (NEW-c peephole)
//   h  = tanh(c) * og;   h = c = 0 where t >= lengths[b]
//
// and writes h into column d*H of the [T, B, D*H] output ([fw | bw]).
// float32 mode: true f32 FMAs, CURRENNT logistic (hard saturation at
// +-88.722839) and tanh = 2*logistic(2x) - 1. bfloat16 mode: bf16 x, W_in,
// W_rec and fed-back h, f32 state and accumulation, plain sigma/tanh, h
// stored in bf16.
//
// Design and what bounds it on this card. Two launches per layer (all
// variants; the recurrence is item 2, 3 or 4):
//
// 1. The input projection, [T*B, P] x [P, 4H] per direction plus the bias,
//    into an f32 scratch buffer, in gemm.cuh's GEMM (GemmProj: wgmma in
//    bf16, the register-blocked SIMT body in f32; the bias product in the
//    epilogue, rounded on its own). The TPU kernel computes this product
//    in its own body, chunk by chunk, so the [D, T, B, 4H] tensor never
//    reaches HBM; here it makes one round trip through device memory
//    (160 MB at T=800, B=50, H=125 in f32). Fusing it back into the
//    recurrence is later work.
// 2. rec_kernel, the recurrence: grid (D, ceil(B / 4)), a time loop
//    inside each block. It is latency-bound, not throughput-bound: T steps
//    depend on each other, each step is a [4, H] x [H, 4H] product that
//    fills a few hundred threads, and only D * ceil(B / 4) SMs work.
//    Each step reads all of W_rec[d]. When W_rec fits in shared memory
//    beside the block's state (bf16 at H = 125: 125 KB), the block stages
//    it there once; otherwise (f32 at H = 125: 250 KB, more than an SM
//    holds) it is re-read from global memory every step and stays in the
//    50 MB L2. What bounds a step is latency: the loads of W in flight,
//    the FMA chains, and the step's a[t]. So each thread takes four
//    adjacent gate columns with one 16-byte (f32) or 8-byte (bf16) load of
//    W per k; k is split over up to 8 thread groups whose partial sums the
//    cell phase adds, which shortens the chains and multiplies the loads
//    in flight; and a[t+1] is copied into shared memory (cp.async) while
//    step t computes. h for the block's rows lives in shared memory,
//    k-major so that every thread reads the same h words (a broadcast); c
//    lives in shared memory. Each block stops at the longest row of its
//    block: later steps are padding for all its rows and are written as
//    zeros. Splitting W_rec over a thread-block cluster (so f32 stays on
//    chip too) and using the tensor cores are later work.
//
// 3. The carry variant (lstm_fwd_rec_carry) replaces the same TPU kernel
//    with carry=True, save=False and an optional step mask (K6 forward +
//    K7: `lstm_scan_fused_carry`, streaming serving's primitive). It is
//    rec_carry_kernel, rec_kernel's body with kCarry: the state starts
//    from (h0, c0) [D, B, H] f32 instead of zeros (h0 rounded to the
//    storage dtype, as the product reads the fed-back h); validity comes from a [B, T] step mask (any
//    pattern: a sequence may end and the next begin inside a chunk) or,
//    without one, from lengths; the final state (hf, cf) [D, B, H] f32 is
//    the masked state of an ascending direction at step carry_t - 1 and of
//    a descending one at t = 0, with hf unrounded, as the TPU kernel emits
//    it. A direction is descending when d + dir_offset != 0 (dir_offset = 1
//    runs a D = 1 layer's single direction backward in time). Every block
//    runs every step of the chunk: the longest-row shortcut would start a
//    row that is invalid at its first steps too late, skip the zeroing of
//    a descending carry at T - 1 and leave h0 as the final state of a
//    block that never reached carry_t - 1. Chunks are short, so this costs
//    little. At the streaming width (H = 250, D = 1) W_rec is 1.0 MB in
//    f32 and 500 KB in bf16: it does not fit a block's shared memory, so
//    the carry variant reads it from L2 every step, and only ceil(B / 4)
//    SMs work.
// 4. The carry variant with residuals (lstm_fwd_rec_carry_save) replaces
//    the same TPU kernel with carry=True and save=True (K6b forward,
//    `_fused_carry_fwd`: the forward that sequence parallelism's training
//    differentiates, one time block of one direction per call). It is
//    rec_carry_save_kernel, the same body with kSave and kCarry: (h0, c0)
//    in, (hf, cf) out as in item 3, validity from lengths only (a prefix per
//    row, as the TPU kernel's backward requires), and the residuals c and
//    gates of item 2 written at every step, zero at invalid ones. Every
//    step runs, for the reasons of item 3. It is a fourth entry point of
//    its own, so that the other instances compile as before.
//
// Launch rules: every entry point launches on the caller's stream,
// allocates nothing, never synchronises, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "gemm.cuh"

namespace {

constexpr float kExpLimit = 88.722839f;

__device__ __forceinline__ float logistic_exact(float x) {
  if (x >= kExpLimit) return 1.0f;
  if (x <= -kExpLimit) return 0.0f;
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float tanh2_exact(float x) {
  return 2.0f * logistic_exact(2.0f * x) - 1.0f;
}

__device__ __forceinline__ float sigmoid_plain(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// ------------------------------------------------------------ recurrence
constexpr int kRecThreads = 512;
constexpr int kMaxKSplit = 8;
// Batch rows per block. Measured at T=800, B=50, H=125, D=2 on an H100
// (700 W): 4 rows beat 8 in f32 (4.3 vs 6.5 ms) and in bf16 (2.9 vs 4.9 ms).
constexpr int kRows = 4;

__host__ __device__ inline size_t align4(size_t n) {
  return (n + 3) & ~static_cast<size_t>(3);
}

// Shared-memory layout of rec_kernel, offsets in floats (each part 16-byte
// aligned). The h . W_rec product of a step is split over `ksplit` groups
// of threads, each summing a slice of k; the cell phase adds the slices.
struct RecLayout {
  int ksplit;
  size_t a;     // [2][rows][4H] a[t] of this step and (prefetched) the next
  size_t part;  // [ksplit][rows][4H] partial products
  size_t h;     // [H][rows] h as the recurrent operand (k-major)
  size_t c;     // [rows][H] cell state
  size_t peep;  // [3][H] peepholes
  size_t w;     // [H][4H] W_rec[d], when staged in shared memory
};

__host__ __device__ inline RecLayout rec_layout(int rows, int H) {
  RecLayout L;
  const size_t G = 4 * static_cast<size_t>(H);
  const int by_threads = kRecThreads / H;
  L.ksplit = by_threads < 1 ? 1 : by_threads;
  if (L.ksplit > kMaxKSplit) L.ksplit = kMaxKSplit;
  if (L.ksplit > H) L.ksplit = H;
  L.a = 0;
  L.part = L.a + align4(2 * rows * G);
  L.h = L.part + align4(L.ksplit * rows * G);
  L.c = L.h + align4(static_cast<size_t>(H) * rows);
  L.peep = L.c + align4(static_cast<size_t>(rows) * H);
  L.w = L.peep + align4(3 * static_cast<size_t>(H));
  return L;
}

// four adjacent W_rec entries as floats (16-byte f32 or 8-byte bf16 load)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// The carry variant's operands (unused without kCarry).
struct CarryArgs {
  const float* h0;            // [D, B, H] initial state
  const float* c0;
  const unsigned char* mask;  // [B, T] step validity; null: t < lengths[b]
  float* hf;                  // [D, B, H] final state
  float* cf;
  int carry_t;                // ascending directions capture at carry_t - 1
  int dir_offset;             // direction d walks descending if d + it > 0
};

// The recurrence, shared by rec_kernel and rec_carry_kernel.
// a [D, T, B, 4H] f32, w_rec [D, H, 4H], peep [D, 3, H], out [T, B, D*H].
// kWShared: W_rec[d] is staged in shared memory (RecLayout::w).
// kSave: also write the residuals c_out [D, T, B, H] and g_out
// [D, T, B, 4H] (zero at padding).
// kCarry: start from ca.h0/ca.c0, mask per step, write ca.hf/ca.cf, and
// run every step (see the note at the top); with kSave too, the K6b
// forward. Each carry variant is an entry point of its own
// (rec_carry_kernel, rec_carry_save_kernel) so that the other instances
// compile as they did without it: one kernel taking CarryArgs gave them
// more registers and spills, and slowed their f32 recurrences on an H100
// (scripts/torch_ab_recurrence.py compares two checkouts).
template <typename W, typename Out, bool kPlainActs, bool kWShared,
          bool kSave, bool kCarry>
__device__ __forceinline__ void rec_body(
    const float* __restrict__ a, const W* __restrict__ w_rec,
    const float* __restrict__ peep, const int* __restrict__ lengths,
    Out* __restrict__ out, float* __restrict__ c_out,
    Out* __restrict__ g_out, int T, int B, int H, const CarryArgs& ca) {
  static_assert(kRows % 4 == 0, "h is read as float4 groups of rows");
  extern __shared__ __align__(16) float smem[];
  const RecLayout L = rec_layout(kRows, H);
  const int G = 4 * H;
  const int KS = L.ksplit;
  const int KC = (H + KS - 1) / KS;  // k per split
  float* as = smem + L.a;
  float* part = smem + L.part;
  float* hs = smem + L.h;
  float* cs = smem + L.c;
  float* ps = smem + L.peep;
  W* ws = reinterpret_cast<W*>(smem + L.w);
  __shared__ int len_s[kRows];
  __shared__ int tmax_s;
  __shared__ int step_valid_s[kRows];  // this step's rows (kCarry + mask)

  const int d = blockIdx.x;
  const int D = gridDim.x;
  const int b0 = blockIdx.y * kRows;
  const int nb = min(kRows, B - b0);
  const int tid = threadIdx.x;
  const size_t DH = static_cast<size_t>(D) * H;
  const bool desc = d + (kCarry ? ca.dir_offset : 0) != 0;
  const bool use_mask = kCarry && ca.mask != nullptr;

  if constexpr (kCarry) {
    for (int i = tid; i < H * kRows; i += kRecThreads) {
      const int r = i / H, j = i - r * H;
      float h = 0.0f, c = 0.0f;
      if (r < nb) {
        const size_t src = (static_cast<size_t>(d) * B + b0 + r) * H + j;
        // the product reads the fed-back h as stored (rounded in bf16)
        h = as_f32(f32_to<Out>(ca.h0[src]));
        c = ca.c0[src];
      }
      hs[j * kRows + r] = h;
      cs[r * H + j] = c;
    }
  } else {
    for (int i = tid; i < H * kRows; i += kRecThreads) {
      hs[i] = 0.0f;
      cs[i] = 0.0f;
    }
  }
  for (int i = tid; i < 3 * H; i += kRecThreads) ps[i] = peep[d * 3 * H + i];
  const W* wd = w_rec + static_cast<size_t>(d) * H * G;
  if (kWShared) {
    for (int i = tid; i < H * G; i += kRecThreads) ws[i] = wd[i];
    wd = ws;
  }
  if (tid < kRows)
    len_s[tid] = tid < nb ? min(max(lengths[b0 + tid], 0), T) : 0;
  __syncthreads();
  if (tid == 0) {
    int m = 0;
    for (int r = 0; r < kRows; ++r) m = max(m, len_s[r]);
    tmax_s = m;
  }
  __syncthreads();
  const int tmax = kCarry ? T : tmax_s;
  // the step whose state is the final one (kCarry)
  const int s_cap = desc ? T - 1 : ca.carry_t - 1;

  // a[d, t] for the block's rows is nb * G contiguous floats; it is copied
  // into shared memory one step ahead, so its latency hides behind the
  // product of the step before
  auto prefetch_a = [&](int s, int buf) {
    const int t = desc ? tmax - 1 - s : s;
    const float* src = a + ((static_cast<size_t>(d) * T + t) * B + b0) * G;
    float* dst = as + buf * kRows * G;
    for (int i = tid; i < nb * H; i += kRecThreads)  // nb * G / 4 copies
      __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
    __pipeline_commit();
  };
  if (tmax > 0) prefetch_a(0, 0);

  for (int s = 0; s < tmax; ++s) {
    const int t = desc ? tmax - 1 - s : s;
    const int buf = s & 1;
    if (s + 1 < tmax) prefetch_a(s + 1, buf ^ 1);
    // read by the cell phase, after the barrier below; the last step's
    // readers finished before the barrier that ended it
    if (use_mask && tid < kRows)
      step_valid_s[tid] =
          tid < nb ? ca.mask[static_cast<size_t>(b0 + tid) * T + t] != 0 : 0;
    // partial products h . W_rec[d]: one (k slice, 4 adjacent gate
    // columns) item per thread, kRows rows each
    for (int item = tid; item < KS * H; item += kRecThreads) {
      const int kq = item / H, q = item - kq * H;
      const int k0 = kq * KC, k1 = min(H, k0 + KC);
      float acc[kRows][4] = {};
      const W* wq = wd + 4 * q;
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        const float4 w4 = load4(wq + static_cast<size_t>(k) * G);
#pragma unroll
        for (int rq = 0; rq < kRows / 4; ++rq) {
          const float4 h4 =
              *reinterpret_cast<const float4*>(hs + k * kRows + 4 * rq);
          const float hr[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[4 * rq + i][0] = fmaf(hr[i], w4.x, acc[4 * rq + i][0]);
            acc[4 * rq + i][1] = fmaf(hr[i], w4.y, acc[4 * rq + i][1]);
            acc[4 * rq + i][2] = fmaf(hr[i], w4.z, acc[4 * rq + i][2]);
            acc[4 * rq + i][3] = fmaf(hr[i], w4.w, acc[4 * rq + i][3]);
          }
        }
      }
      float* pq = part + static_cast<size_t>(kq) * kRows * G + 4 * q;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        *reinterpret_cast<float4*>(pq + r * G) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    // this step's a has landed; the next step's copy may still be in flight
    if (s + 1 < tmax)
      __pipeline_wait_prior(1);
    else
      __pipeline_wait_prior(0);
    __syncthreads();
    // the cell, one (row, cell) pair per thread; g = a + the partial sums
    const float* at = as + buf * kRows * G;
    for (int p = tid; p < nb * H; p += kRecThreads) {
      const int r = p / H, j = p - r * H;
      float gv[4];
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) {
        const int n = r * G + gi * H + j;
        float v = at[n];
        for (int kq = 0; kq < KS; ++kq)
          v += part[static_cast<size_t>(kq) * kRows * G + n];
        gv[gi] = v;
      }
      const float c_prev = cs[r * H + j];
      float ni, ig, fg, og, c_new, h_new;
      if (kPlainActs) {
        ni = tanhf(gv[0]);
        ig = sigmoid_plain(gv[1] + c_prev * ps[j]);
        fg = sigmoid_plain(gv[2] + c_prev * ps[H + j]);
        c_new = ni * ig + fg * c_prev;
        og = sigmoid_plain(gv[3] + c_new * ps[2 * H + j]);
        h_new = tanhf(c_new) * og;
      } else {
        ni = tanh2_exact(gv[0]);
        ig = logistic_exact(gv[1] + c_prev * ps[j]);
        fg = logistic_exact(gv[2] + c_prev * ps[H + j]);
        c_new = ni * ig + fg * c_prev;
        og = logistic_exact(gv[3] + c_new * ps[2 * H + j]);
        h_new = tanh2_exact(c_new) * og;
      }
      const bool valid = use_mask ? step_valid_s[r] != 0 : t < len_s[r];
      const Out hv = f32_to<Out>(valid ? h_new : 0.0f);
      cs[r * H + j] = valid ? c_new : 0.0f;
      hs[j * kRows + r] = as_f32(hv);
      out[(static_cast<size_t>(t) * B + b0 + r) * DH +
          static_cast<size_t>(d) * H + j] = hv;
      if (kCarry && s == s_cap) {
        const size_t dst = (static_cast<size_t>(d) * B + b0 + r) * H + j;
        ca.hf[dst] = valid ? h_new : 0.0f;  // unrounded, as the TPU kernel
        ca.cf[dst] = valid ? c_new : 0.0f;
      }
      if (kSave) {
        const size_t row = (static_cast<size_t>(d) * T + t) * B + b0 + r;
        c_out[row * H + j] = valid ? c_new : 0.0f;
        Out* gr = g_out + row * G + j;
        gr[0] = f32_to<Out>(valid ? ni : 0.0f);
        gr[H] = f32_to<Out>(valid ? ig : 0.0f);
        gr[2 * H] = f32_to<Out>(valid ? fg : 0.0f);
        gr[3 * H] = f32_to<Out>(valid ? og : 0.0f);
      }
    }
    __syncthreads();
  }
  // steps past the block's longest row are padding for all its rows
  const size_t per_t = static_cast<size_t>(nb) * H;
  const size_t n_pad = static_cast<size_t>(T - tmax) * per_t;
  for (size_t i = tid; i < n_pad; i += kRecThreads) {
    const size_t t = tmax + i / per_t;
    const int rem = static_cast<int>(i % per_t);
    const int r = rem / H, j = rem - r * H;
    out[(t * B + b0 + r) * DH + static_cast<size_t>(d) * H + j] =
        f32_to<Out>(0.0f);
    if (kSave) {
      const size_t row = (static_cast<size_t>(d) * T + t) * B + b0 + r;
      c_out[row * H + j] = 0.0f;
      for (int gi = 0; gi < 4; ++gi)
        g_out[row * G + gi * H + j] = f32_to<Out>(0.0f);
    }
  }
}

template <typename W, typename Out, bool kPlainActs, bool kWShared,
          bool kSave>
__global__ void __launch_bounds__(kRecThreads)
    rec_kernel(const float* __restrict__ a, const W* __restrict__ w_rec,
               const float* __restrict__ peep,
               const int* __restrict__ lengths, Out* __restrict__ out,
               float* __restrict__ c_out, Out* __restrict__ g_out, int T,
               int B, int H) {
  rec_body<W, Out, kPlainActs, kWShared, kSave, false>(
      a, w_rec, peep, lengths, out, c_out, g_out, T, B, H, CarryArgs{});
}

template <typename W, typename Out, bool kPlainActs, bool kWShared>
__global__ void __launch_bounds__(kRecThreads)
    rec_carry_kernel(const float* __restrict__ a,
                     const W* __restrict__ w_rec,
                     const float* __restrict__ peep,
                     const int* __restrict__ lengths, Out* __restrict__ out,
                     int T, int B, int H, CarryArgs ca) {
  rec_body<W, Out, kPlainActs, kWShared, false, true>(
      a, w_rec, peep, lengths, out, nullptr, nullptr, T, B, H, ca);
}

template <typename W, typename Out, bool kPlainActs, bool kWShared>
__global__ void __launch_bounds__(kRecThreads)
    rec_carry_save_kernel(const float* __restrict__ a,
                          const W* __restrict__ w_rec,
                          const float* __restrict__ peep,
                          const int* __restrict__ lengths,
                          Out* __restrict__ out, float* __restrict__ c_out,
                          Out* __restrict__ g_out, int T, int B, int H,
                          CarryArgs ca) {
  rec_body<W, Out, kPlainActs, kWShared, true, true>(
      a, w_rec, peep, lengths, out, c_out, g_out, T, B, H, ca);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename W, typename Out, bool kPlainActs, bool kWShared,
          bool kSave, bool kCarry>
cudaError_t launch_rec(const float* a, const void* w_rec, const float* peep,
                       const int* lengths, void* out, float* c_out,
                       void* g_out, int T, int B, int H, int D,
                       const CarryArgs& ca, size_t smem,
                       cudaStream_t stream) {
  const dim3 grid(D, (B + kRows - 1) / kRows);
  cudaError_t err;
  if constexpr (kCarry && kSave) {
    auto kernel = rec_carry_save_kernel<W, Out, kPlainActs, kWShared>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<grid, kRecThreads, smem, stream>>>(
        a, static_cast<const W*>(w_rec), peep, lengths,
        static_cast<Out*>(out), c_out, static_cast<Out*>(g_out), T, B, H,
        ca);
  } else if constexpr (kCarry) {
    auto kernel = rec_carry_kernel<W, Out, kPlainActs, kWShared>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<grid, kRecThreads, smem, stream>>>(
        a, static_cast<const W*>(w_rec), peep, lengths,
        static_cast<Out*>(out), T, B, H, ca);
  } else {
    auto kernel = rec_kernel<W, Out, kPlainActs, kWShared, kSave>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<grid, kRecThreads, smem, stream>>>(
        a, static_cast<const W*>(w_rec), peep, lengths,
        static_cast<Out*>(out), c_out, static_cast<Out*>(g_out), T, B, H);
  }
  return cudaGetLastError();
}

// Stages W_rec in shared memory when it fits beside the state; a state
// that does not fit (H above ~500 in f32) is refused.
template <typename W, typename Out, bool kPlainActs, bool kSave,
          bool kCarry>
cudaError_t launch_rec_w(const float* a, const void* w_rec, const float* peep,
                         const int* lengths, void* out, float* c_out,
                         void* g_out, int T, int B, int H, int D,
                         const CarryArgs& ca, int device,
                         cudaStream_t stream) {
  int smem_max = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const RecLayout L = rec_layout(kRows, H);
  const size_t state = L.w * sizeof(float);
  const size_t with_w = state + static_cast<size_t>(H) * 4 * H * sizeof(W);
  if (with_w <= static_cast<size_t>(smem_max))
    return launch_rec<W, Out, kPlainActs, true, kSave, kCarry>(
        a, w_rec, peep, lengths, out, c_out, g_out, T, B, H, D, ca, with_w,
        stream);
  if (state > static_cast<size_t>(smem_max)) return cudaErrorInvalidValue;
  return launch_rec<W, Out, kPlainActs, false, kSave, kCarry>(
      a, w_rec, peep, lengths, out, c_out, g_out, T, B, H, D, ca, state,
      stream);
}

template <bool kSave, bool kCarry>
cudaError_t launch_rec_dtype(const float* a, const void* w_rec,
                             const float* peep, const int* lengths, void* out,
                             float* c_out, void* g_out, int T, int B, int H,
                             int D, const CarryArgs& ca, int bf16, int device,
                             cudaStream_t stream) {
  if (bf16)
    return launch_rec_w<__nv_bfloat16, __nv_bfloat16, true, kSave, kCarry>(
        a, w_rec, peep, lengths, out, c_out, g_out, T, B, H, D, ca, device,
        stream);
  return launch_rec_w<float, float, false, kSave, kCarry>(
      a, w_rec, peep, lengths, out, c_out, g_out, T, B, H, D, ca, device,
      stream);
}

// a[d] = x . w[d] + bias_mult * bias[d] for each direction d, in gemm.cuh's
// GEMM (output d takes pair d; x is shared), the bias in the epilogue
template <typename T>
cudaError_t launch_proj(const void* x, const void* w, const float* bias,
                        float* a, int M, int K, int N, int D, float bias_mult,
                        cudaStream_t stream) {
  GemmArgs<T> g{};
  for (int d = 0; d < D; ++d) {
    g.a[d] = make_view<T>(x, K, M, K);
    g.b[d] = make_view<T>(static_cast<const T*>(w) +
                              static_cast<size_t>(d) * K * N,
                          N, K, N);
  }
  g.M = M;
  g.N = N;
  g.K = K;
  g.nsplit = 1;
  g.ngroups = 1;
  return launch_gemm<GemmProj, T, false, false, float>(
      g, D, EpiBias{a, bias, bias_mult, static_cast<long long>(M) * N, N},
      stream);
}

// The carry entry points' shape rules (as the wrapper's _check_carry):
// dir_offset 0, or 1 with D = 1; carry_t in [1, T]; a descending
// direction needs carry_t = T.
bool carry_ok(int T, int B, int H, int D, int carry_t, int dir_offset) {
  if (T < 1 || B < 1 || H < 1 || D < 1 || D > 2) return false;
  if (dir_offset < 0 || dir_offset > 1 || (D == 2 && dir_offset != 0))
    return false;
  if (carry_t < 1 || carry_t > T) return false;
  return !((D == 2 || dir_offset == 1) && carry_t != T);
}

}  // namespace

extern "C" {

// Input projection. x [M, K] and w [D, K, N] are both f32 (bf16 = 0) or
// both bf16 (bf16 = 1); bias [D, N] f32; a [D, M, N] f32.
int lstm_fwd_proj(const void* x, const void* w, const float* bias, float* a,
                  int M, int K, int N, int D, float bias_mult, int bf16,
                  int device, cudaStream_t stream) {
  if (M < 1 || K < 1 || N < 1 || D < 1 || D > 2)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bf16)
    return launch_proj<__nv_bfloat16>(x, w, bias, a, M, K, N, D, bias_mult,
                                      stream);
  return launch_proj<float>(x, w, bias, a, M, K, N, D, bias_mult, stream);
}

// Recurrence. a [D, T, B, 4H] f32; w_rec [D, H, 4H] f32 or bf16; peep
// [D, 3, H] f32; lengths [B] int32; out [T, B, D*H] f32 or bf16 (as w_rec).
// c_out [D, T, B, H] f32 and g_out [D, T, B, 4H] (as out) are the training
// residuals: both null (save=False) or both given (save=True).
int lstm_fwd_rec(const float* a, const void* w_rec, const float* peep,
                 const int* lengths, void* out, float* c_out, void* g_out,
                 int T, int B, int H, int D, int bf16, int device,
                 cudaStream_t stream) {
  if (T < 1 || B < 1 || H < 1 || D < 1 || D > 2) return cudaErrorInvalidValue;
  if ((c_out == nullptr) != (g_out == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const CarryArgs none = {};
  if (c_out != nullptr)
    return launch_rec_dtype<true, false>(a, w_rec, peep, lengths, out, c_out,
                                         g_out, T, B, H, D, none, bf16,
                                         device, stream);
  return launch_rec_dtype<false, false>(a, w_rec, peep, lengths, out, nullptr,
                                        nullptr, T, B, H, D, none, bf16,
                                        device, stream);
}

// Recurrence from an initial state (K6 forward + K7). As lstm_fwd_rec
// without residuals, plus h0, c0 [D, B, H] f32 in; hf, cf [D, B, H] f32
// out; mask [B, T] uint8 (nonzero = valid) or null (lengths then give a
// valid prefix per row). carry_t in [1, T]; dir_offset 0, or 1 with D = 1;
// a descending direction needs carry_t = T.
int lstm_fwd_rec_carry(const float* a, const void* w_rec, const float* peep,
                       const int* lengths, const unsigned char* mask,
                       const float* h0, const float* c0, void* out, float* hf,
                       float* cf, int T, int B, int H, int D, int carry_t,
                       int dir_offset, int bf16, int device,
                       cudaStream_t stream) {
  if (!carry_ok(T, B, H, D, carry_t, dir_offset)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const CarryArgs ca = {h0, c0, mask, hf, cf, carry_t, dir_offset};
  return launch_rec_dtype<false, true>(a, w_rec, peep, lengths, out, nullptr,
                                       nullptr, T, B, H, D, ca, bf16, device,
                                       stream);
}

// Recurrence from an initial state with the training residuals (K6b
// forward). As lstm_fwd_rec_carry with mask = null (validity from lengths
// only), plus c_out [D, T, B, H] f32 and g_out [D, T, B, 4H] (as out),
// both written at every step and zero at invalid ones.
int lstm_fwd_rec_carry_save(const float* a, const void* w_rec,
                            const float* peep, const int* lengths,
                            const float* h0, const float* c0, void* out,
                            float* c_out, void* g_out, float* hf, float* cf,
                            int T, int B, int H, int D, int carry_t,
                            int dir_offset, int bf16, int device,
                            cudaStream_t stream) {
  if (!carry_ok(T, B, H, D, carry_t, dir_offset)) return cudaErrorInvalidValue;
  if (c_out == nullptr || g_out == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const CarryArgs ca = {h0, c0, nullptr, hf, cf, carry_t, dir_offset};
  return launch_rec_dtype<true, true>(a, w_rec, peep, lengths, out, c_out,
                                      g_out, T, B, H, D, ca, bf16, device,
                                      stream);
}

const char* lstm_err_str(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
