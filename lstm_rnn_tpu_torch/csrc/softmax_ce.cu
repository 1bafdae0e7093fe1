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
// Design and what bounds it on this card. The forward works in tiles of 64
// rows, and the logits never reach device memory, as in the TPU kernel. It
// must read h and W and write p: at N = 25,000, P = 250, S = 183 that is
// 22 MB in bf16 (0.007 ms at 3.35 TB/s, which bounds it) and the product's
// 2.3 GFLOP in f32 (0.034 ms on the FP32 pipes, which bound it).
//
// * bf16: a tile's [64, S] logits are ceil(S / 64) wgmma m64n64k16
//   accumulators (f32, in registers) of one warpgroup: h's rows K-major, W
//   [P, S] MN-major (wgmma's transpose bit), both 128-byte swizzled. For
//   S <= 256 the softmax runs on the accumulators: a row's columns lie in
//   one quad of lanes, so min, max, the exp sum, the first argmax and p_t
//   each take two shuffles; p leaves through shared memory in coalesced
//   rows. Where W and the warpgroups' h tiles fit (the main path), one
//   persistent block per SM of three warpgroups builds W's image once
//   (rows of 183 bf16 are 2-byte aligned: from aligned words, shifted) and
//   each warpgroup copies its tiles' h rows by 4-byte cp.async (rows of
//   250 bf16 are 4-byte aligned; no TMA); else one block per tile stages
//   both operands through registers with gemm.cuh's loader (the widest
//   load each base and row pitch allow) into a two-stage ring.
// * f32 (true f32, no tensor cores): a register-blocked SIMT product, 8 x
//   2 ceil(S / 64) outputs a thread (eight warps across the 64 rows x S
//   columns), K in stages of 16 filled by 4-byte cp.async (any f32 row
//   allows it) into a two-stage ring, k-major and padded, so that one
//   stage's copies land while the other computes; for S <= 256 each row of
//   h is read once per block, and three blocks share an SM. The tile goes
//   into a [64, S] f32 logits block in shared memory (over the ring, free
//   by then), and a warp per row takes min, max, the exp sum and the first
//   argmax with shuffles.
// * S > 256 (both): the product in passes of 128 columns, each written into
//   the shared logits block, then the f32 path's softmax. The block then
//   holds 64 x ceil8(S) floats beside the ring (ce_smem_bytes): S <= 704 on
//   an H100's 227 KB (ops/softmax_ce.py proj_tail_fits reads these
//   constants); wider nets take the wide tail (softmax_ce_wide.cu).
//
// p = e / sum is correctly rounded without a division per element
// (ce_div). Loss and count are per-row values added in row order into a
// per-tile partial, and the partials in a fixed order by a one-block
// reduction: no float atomics, the same sum on every run.
//
// The backward (K3b) keeps dz out of device memory, as the TPU kernel keeps
// it in VMEM: it must read p, h and W and write dh, dW and db, 34 MB in
// bf16 at N = 25,000, P = 250, S = 183 (0.010 ms at 3.35 TB/s, which bounds
// it), and its two products are 4.6 GFLOP (0.068 ms on the FP32 pipes,
// which bound f32). Four launches:
// * pb_prep_kernel: each row's constants once (p_t read from p at the
//   target, inv, -s and inv - s: no kernel after divides), and W packed,
//   zero-padded to [256k, 64k] (bf16) or transposed to [32k, 256k] (f32),
//   so that every copy of it is an aligned 16 bytes.
// * dh = dzc . W^T. Rows of p are rarely 16-byte aligned (183 bf16 are
//   366 bytes), but its 16-byte chunks are: a row's columns are copied
//   as the aligned chunks that hold them by cp.async (pb_fill_seg) and
//   read from their shift (pb_shift). dz is formed from p and the row
//   constants in the twin's operation order (pb_dz8), rounded to the
//   storage dtype into shared memory, and multiplied there: wgmma
//   m64n128k16 on dz and W's packed rows, both K-major (bf16), or on the
//   FP32 pipes (f32). Up to 192 classes (the main path) pb_dh_res_kernel:
//   one persistent block an SM holds its columns of W in shared memory
//   and walks 64-row tiles, the next tile's p landing while this tile's
//   product runs, dh staged through shared memory and stored in whole
//   rows. Above, pb_dh_kernel: a block a 64-row tile, W's chunks of S
//   from L2.
// * pb_dw_kernel: dW = h^T . dzc and db, a block per 128 rows (of P) x 192
//   columns (of S) of dW over a split of the rows (enough splits to give
//   every SM one block), walking its rows in tiles through a three-stage
//   cp.async ring (h's rows, p's segments, the rows' constants). dz is
//   formed again, db summed from it unrounded, and dW accumulated in
//   registers: three wgmma m64n64k16 chunks a warpgroup, h and dz both
//   MN-major, a tile's dz formed while the tensor cores run the last
//   one's (bf16); 8 x 12 outputs a thread, the next tile's dz formed
//   between this one's FMAs (f32). The partial tile is staged through
//   shared memory and stored in whole rows.
// * sum_partials: the splits' dW and db partials, one buffer, in a fixed
//   order (no float atomics: a second launch gives the same bits).
//
// Launch rules: the entry points launch on the caller's stream, allocate
// nothing, never synchronise, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <type_traits>

#include "gemm.cuh"
#include "softmax_common.cuh"

namespace {

constexpr int kCeRows = 64;       // rows per block: one warpgroup's wgmma M
constexpr int kCeChunk = 64;      // columns per accumulator chunk
constexpr int kCeMaxChunks = 4;   // S <= 256: the product in one pass
constexpr int kCeWideChunks = 2;  // S > 256: passes of 128 columns
// a bf16 stage's A tile (64 rows x 64 k), or one 64-column chunk of B
constexpr int kCeTile = kCeRows * kWgBK * 2;
// the forward's static shared memory: a loss and a hit per row, for up to
// three warpgroups
constexpr int kCeStaticBytes = 6 * kCeRows * 4;

template <typename T>
constexpr bool is_bf16 = std::is_same<T, __nv_bfloat16>::value;

// the forward's bodies: the product streamed through a stage ring (any P),
// in 128-column passes into the shared logits block (S > 256), or with W
// resident in a persistent block (bf16, S <= 256, W and the warpgroups'
// tiles of h fit)
enum CeMode { kCeStream, kCeWide, kCeResident };

// the forward's threads: one warpgroup (bf16), ce_wgs (bf16 with W
// resident), eight warps (f32)
template <typename T, int kNch, int kMode>
__host__ __device__ constexpr int ce_threads() {
  return is_bf16<T> ? (kMode == kCeResident ? (kNch <= 3 ? 384 : 256) : 128)
                    : 256;
}

// blocks an SM should hold: the resident path one (its shared memory),
// the f32 body three up to S = 192 (at N = 25,000 its 391 tiles then run
// in one wave on 132 SMs), else two
template <typename T, int kNch, int kMode>
__host__ __device__ constexpr int ce_min_blocks() {
  return kMode == kCeResident ? 1 : (!is_bf16<T> && kNch <= 3 ? 3 : 2);
}

// the shared logits block's row pitch (floats)
__host__ __device__ constexpr int ce_lg_width(int S) { return (S + 7) / 8 * 8; }

// the two-stage ring of A's 64 rows and B's nch 64-column chunks: bf16 in
// 128-byte-swizzled tiles of 64 k (plus 1 KB to align the swizzle), f32 in
// kSimtBK k-rows padded by kSimtPad
__host__ __device__ constexpr int ce_ring_bytes(bool bf16, int nch) {
  return bf16 ? 2 * (1 + nch) * kCeTile + 1024
              : 2 * kSimtBK * (kCeRows + kSimtPad + nch * kCeChunk + kSimtPad) *
                    4;
}

// the forward's dynamic shared memory at S classes (the static
// kCeStaticBytes come on top): S <= 256 the ring (bf16: the logits stay in
// registers) or the logits block over it (f32); above, the ring of the
// 128-column passes and the logits block beside it
__host__ __device__ constexpr int ce_smem_bytes(int S, bool bf16) {
  const int logits = kCeRows * ce_lg_width(S) * 4;
  if (S > kCeMaxChunks * kCeChunk)
    return ce_ring_bytes(bf16, kCeWideChunks) + logits;
  const int ring = ce_ring_bytes(bf16, (S + kCeChunk - 1) / kCeChunk);
  return bf16 || ring > logits ? ring : logits;
}

// ------------------------------------------------------------ bf16: wgmma
// d += A . B for one 64 x 64 x 16 step, f32 accumulators; kTA / kTB: the
// operand is MN-major (wgmma's transpose bit). K3f: A K-major, B MN-major;
// K3b's dW: both MN-major.
template <int kTA = 0, int kTB = 1>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                unsigned long long da,
                                                unsigned long long db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
}

// keep the compiler from moving the accumulators across an asynchronous
// wgmma
template <int kNch>
__device__ __forceinline__ void fence_chunks(float (&d)[kNch][32]) {
#pragma unroll
  for (int c = 0; c < kNch; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[c][i])::"memory");
}

// One stage's operands in registers: four 16-byte segments of A (segment
// s = t + 128 i of 512: row s / 8, k chunk s % 8) and 4 kNch of B (of
// 512 kNch: k-row s / (8 kNch), n chunk s % (8 kNch)), zero beyond the
// edges.
template <int kNch>
__device__ __forceinline__ void ce_wg_load(const View<__nv_bfloat16>& h,
                                           const View<__nv_bfloat16>& w,
                                           int m0, int n0, int k0,
                                           uint4 (&ra)[4],
                                           uint4 (&rb)[4 * kNch]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = threadIdx.x + 128 * i;
    ra[i] = load_seg(h, m0 + s / 8, k0 + (s % 8) * 8, h.cols, true);
  }
#pragma unroll
  for (int i = 0; i < 4 * kNch; ++i) {
    const int s = threadIdx.x + 128 * i;
    rb[i] = load_seg(w, k0 + s / (8 * kNch), n0 + (s % (8 * kNch)) * 8,
                     w.cols, true);
  }
}

// ... into a stage: A [64 rows x 64 k] K-major (row r at r * 128 bytes),
// then B's chunks, each [64 k x 64 n] MN-major (k-row k at k * 128 bytes),
// all with the 128-byte swizzle
template <int kNch>
__device__ __forceinline__ void ce_wg_store(unsigned char* stage,
                                            const uint4 (&ra)[4],
                                            const uint4 (&rb)[4 * kNch]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned s = threadIdx.x + 128 * i;
    *reinterpret_cast<uint4*>(stage + swz((s / 8) * 128 + (s % 8) * 16)) =
        ra[i];
  }
#pragma unroll
  for (int i = 0; i < 4 * kNch; ++i) {
    const unsigned s = threadIdx.x + 128 * i;
    const unsigned ch = s % (8 * kNch);
    const unsigned off = (ch / 8) * kCeTile + (s / (8 * kNch)) * 128 +
                         (ch % 8) * 16;
    *reinterpret_cast<uint4*>(stage + kCeTile + swz(off)) = rb[i];
  }
}

// acc[c] = h[m0 .. m0 + 63, :] . W[:, n0 + 64 c .. + 63] (zero beyond the
// edges), over a two-stage ring at smem (1024-byte aligned): the loads of
// stage k + 1 are in flight while the tensor cores run stage k, and land in
// the buffer stage k - 1 freed. Every thread of the block calls it.
template <int kNch>
__device__ __forceinline__ void ce_wg_product(const View<__nv_bfloat16>& h,
                                              const View<__nv_bfloat16>& w,
                                              int m0, int n0,
                                              float (&acc)[kNch][32],
                                              unsigned char* smem) {
  constexpr int kStage = (1 + kNch) * kCeTile;
  const int nk = (h.cols + kWgBK - 1) / kWgBK;
  const unsigned sbase =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
#pragma unroll
  for (int c = 0; c < kNch; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;
  uint4 ra[4], rb[4 * kNch];
  ce_wg_load<kNch>(h, w, m0, n0, 0, ra, rb);
  ce_wg_store<kNch>(smem, ra, rb);
  fence_async_smem();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const bool more = kt + 1 < nk;
    if (more) ce_wg_load<kNch>(h, w, m0, n0, (kt + 1) * kWgBK, ra, rb);
    const unsigned st = sbase + (kt % 2) * kStage;
    fence_chunks(acc);
    wg_fence();
    // a k16 step is 32 bytes along A's K-major rows, 16 k-rows (2,048
    // bytes) of a B chunk
#pragma unroll
    for (int j = 0; j < kWgBK / 16; ++j)
#pragma unroll
      for (int c = 0; c < kNch; ++c)
        wgmma_m64n64k16(acc[c], wg_desc(st + j * 32, 16, 1024),
                        wg_desc(st + (1 + c) * kCeTile + j * 2048, kCeTile,
                                1024));
    wg_commit();
    wg_wait<1>();  // stage kt - 1's products are done: its buffer is free
    fence_chunks(acc);
    if (more) {
      ce_wg_store<kNch>(smem + ((kt + 1) % 2) * kStage, ra, rb);
      fence_async_smem();
    }
    __syncthreads();
  }
  wg_wait<0>();
  fence_chunks(acc);
}

// p = e / s, for 0 <= e <= s: with s's correctly rounded reciprocal inv =
// RN(1 / s), one FMA correction of e * inv from the exact remainder gives
// the correctly rounded quotient wherever it is a normal number (below
// 2^-126 within a unit of a subnormal's last place), with no branch; an
// infinite s (e is finite: safe_exp clamps) gives 0, as the division does
__device__ __forceinline__ float ce_div(float e, float s, float inv) {
  const float q = e * inv;
  return s < CUDART_INF_F ? fmaf(fmaf(-q, s, e), inv, q) : 0.0f;
}

// the calling warpgroup's barrier (ids 1, 2, 3; 0 is __syncthreads)
__device__ __forceinline__ void wg_bar() {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + threadIdx.x / 128)
               : "memory");
}

// ce_softmax_regs's p pass: p = e / sum, its store, the thread's first
// argmax and p_t; each thread walks its columns upwards
template <int kNch>
__device__ __forceinline__ void ce_p_pass(
    const float (&acc)[kNch][32], const float (&sum)[2],
    const float (&inv)[2], const int (&t)[2],
    __nv_bfloat16* __restrict__ p_out, __nv_bfloat16* pstage, int ps,
    int m0, int N, int S, float (&best)[2], int (&arg)[2], float (&pt)[2]) {
  const int lane = threadIdx.x % 32;
  const int rloc = (threadIdx.x / 32 % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
#pragma unroll
  for (int c = 0; c < kNch; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = c * kCeChunk + 8 * j + cq;
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = acc[c][4 * j + 2 * hf + e];
          p[e] = ce_div(v, sum[hf], inv[hf]);
          const bool gt = n + e < S && p[e] > best[hf];
          best[hf] = gt ? p[e] : best[hf];
          arg[hf] = gt ? n + e : arg[hf];
          pt[hf] = n + e == t[hf] ? p[e] : pt[hf];
        }
        const int r = rloc + 8 * hf;
        if (pstage != nullptr) {
          if (n < S)
            *reinterpret_cast<__nv_bfloat162*>(pstage + r * ps + n) =
                __floats2bfloat162_rn(p[0], p[1]);
        } else if (p_out != nullptr && m0 + r < N && n < S) {
          __nv_bfloat16* o = p_out + static_cast<size_t>(m0 + r) * S + n;
          if (n + 1 < S && reinterpret_cast<unsigned long long>(o) % 4 == 0) {
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(p[0], p[1]);
          } else {
            o[0] = __float2bfloat16_rn(p[0]);
            if (n + 1 < S) o[1] = __float2bfloat16_rn(p[1]);
          }
        }
      }
}

// The softmax on a warpgroup's accumulators (S <= 64 kNch). Warp w of the
// warpgroup holds rows 16 w + lane / 4 and that + 8 (half hf); register
// 4 j + 2 hf + e of chunk c is column 64 c + 8 j + 2 (lane % 4) + e, so a
// row's columns lie in one quad of lanes: min, max, the exp sum, the
// first argmax of p and p_t each take two shuffles. bias: bias_mult *
// b[n] (rounded on its own) in shared memory; t: the rows' targets. p goes
// to pstage ([64][ps] bf16 in shared memory, when given) or straight to
// p_out; each row's loss and hit to row_loss / row_hit.
template <int kNch>
__device__ __forceinline__ void ce_softmax_regs(
    float (&acc)[kNch][32], const float* bias, const int (&t)[2],
    __nv_bfloat16* __restrict__ p_out, __nv_bfloat16* pstage, int ps,
    int m0, int N, int S, float* row_loss, int* row_hit) {
  const int lane = threadIdx.x % 32;
  const int rloc = (threadIdx.x / 32 % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  float mn[2] = {CUDART_INF_F, CUDART_INF_F};
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int c = 0; c < kNch; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = c * kCeChunk + 8 * j + cq + e;
        const float bb = n < S ? bias[n] : 0.0f;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float& v = acc[c][4 * j + 2 * hf + e];
          v += bb;
          mn[hf] = n < S ? fminf(mn[hf], v) : mn[hf];
          mx[hf] = n < S ? fmaxf(mx[hf], v) : mx[hf];
        }
      }
  float off[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    for (int o = 1; o < 4; o <<= 1) {
      mn[hf] = fminf(mn[hf], __shfl_xor_sync(0xffffffffu, mn[hf], o));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], o));
    }
    // the reference's max search starts at FLT_MIN (SoftmaxLayer.cu:60)
    off[hf] = 0.5f * (mn[hf] + fmaxf(mx[hf], kRealMin));
  }
#pragma unroll
  for (int c = 0; c < kNch; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float& v = acc[c][4 * j + 2 * hf + e];
          v = safe_exp(v - off[hf]);
          sum[hf] += c * kCeChunk + 8 * j + cq + e < S ? v : 0.0f;
        }
  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    for (int o = 1; o < 4; o <<= 1)
      sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], o);
    inv[hf] = __frcp_rn(sum[hf]);
  }
  // p (e / sum, correctly rounded), its first argmax (over the f32 p: two
  // different e can round to the same p) and p_t
  int arg[2] = {S, S};
  float best[2] = {-CUDART_INF_F, -CUDART_INF_F}, pt[2] = {0.0f, 0.0f};
  ce_p_pass(acc, sum, inv, t, p_out, pstage, ps, m0, N, S, best, arg, pt);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    for (int o = 1; o < 4; o <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[hf], o);
      const int oa = __shfl_xor_sync(0xffffffffu, arg[hf], o);
      if (ob > best[hf] || (ob == best[hf] && oa < arg[hf])) {
        best[hf] = ob;
        arg[hf] = oa;
      }
      // one lane of the quad holds p_t, the others 0
      pt[hf] = fmaxf(pt[hf], __shfl_xor_sync(0xffffffffu, pt[hf], o));
    }
    if (lane % 4 == 0) {
      const bool valid = t[hf] >= 0;
      row_loss[rloc + 8 * hf] =
          valid ? -logf(fmaxf(t[hf] < S ? pt[hf] : 0.0f, kRealMin)) : 0.0f;
      row_hit[rloc + 8 * hf] = valid && arg[hf] == t[hf] ? 1 : 0;
    }
  }
}

// The warpgroup's rows of p from pstage ([64][ps] bf16) to p_out, each
// warp 16 rows, each row in 4-byte stores along it (the first and last
// element alone where the row is not 4-byte aligned)
__device__ __forceinline__ void ce_store_p(const __nv_bfloat16* pstage,
                                           int ps,
                                           __nv_bfloat16* __restrict__ p_out,
                                           int m0, int N, int S) {
  const int lane = threadIdx.x % 32;
  const unsigned short* src = reinterpret_cast<const unsigned short*>(pstage);
  for (int r = (threadIdx.x / 32 % 4) * 16; r < (threadIdx.x / 32 % 4 + 1) * 16;
       ++r) {
    if (m0 + r >= N) break;
    unsigned short* dst = reinterpret_cast<unsigned short*>(
        p_out + static_cast<size_t>(m0 + r) * S);
    const unsigned short* row = src + r * ps;
    const int s0 = reinterpret_cast<unsigned long long>(dst) % 4 ? 1 : 0;
    const int words = (S - s0) / 2;
    for (int w = lane; w < words; w += 32)
      *reinterpret_cast<unsigned*>(dst + s0 + 2 * w) =
          row[s0 + 2 * w] | static_cast<unsigned>(row[s0 + 2 * w + 1]) << 16;
    if (lane == 0 && s0) dst[0] = row[0];
    if (lane == 0 && s0 + 2 * words < S) dst[S - 1] = row[S - 1];
  }
}

// the block's bias products, bias[n] = bias_mult * b[n] for n < S
__device__ __forceinline__ void ce_bias_smem(const float* __restrict__ b,
                                             float bias_mult, int S,
                                             float* bias) {
  for (int n = threadIdx.x; n < S; n += blockDim.x)
    bias[n] = __fmul_rn(bias_mult, b[n]);
}

// the rows' targets (-1 beyond N) of the calling thread's two rows
__device__ __forceinline__ void ce_targets(const int* __restrict__ tc, int m0,
                                           int N, int (&t)[2]) {
  const int r = (threadIdx.x / 32 % 4) * 16 + (threadIdx.x % 32) / 4;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    t[hf] = m0 + r + 8 * hf < N ? tc[m0 + r + 8 * hf] : -1;
}

// a tile's rows, in order, into its partials
__device__ __forceinline__ void ce_put_tile(const float* row_loss,
                                            const int* row_hit, int tile,
                                            float* part_loss, int* part_cnt) {
  float l = 0.0f;
  int c = 0;
  for (int r = 0; r < kCeRows; ++r) {
    l += row_loss[r];
    c += row_hit[r];
  }
  part_loss[tile] = l;
  part_cnt[tile] = c;
}

// ------------------------------------------ bf16, W resident: S <= 256
// One persistent block per SM (the main path: P = 250, S = 183) of
// ce_wgs warpgroups. The block builds W's image once, [nkc k-chunks][kNch
// n atoms] of 8 KB in the MN-major swizzled layout (k-row k at (k % 64) *
// 128 bytes): rows of 183 bf16 are 2-byte aligned, so each 16-byte
// segment comes from the aligned 4-byte words around it, shifted into
// place. Each warpgroup walks its own 64-row tiles with its own A tile
// [nkc] of 8 KB (K-major, swizzled), its h rows copied by 4-byte cp.async
// (h's base and row pitch 4-byte aligned) straight into the swizzled
// layout, zero-filled beyond N and P; the first tile's copy runs under
// the build. After the products the A tile holds the tile's p (bf16),
// which leaves in coalesced rows.
template <int kNch>
__host__ __device__ constexpr int ce_wgs() {
  return kNch <= 3 ? 3 : 2;
}

// the resident path's dynamic shared memory: W's image, the warpgroups' A
// tiles, the bias products (up to 256 floats), 1 KB to align the swizzle
__host__ __device__ constexpr int ce_resident_bytes(int P, int nch) {
  return (P + kWgBK - 1) / kWgBK * (nch + (nch <= 3 ? 3 : 2)) * kCeTile +
         1024 + 1024;
}

__device__ __forceinline__ void cp_async4(unsigned char* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Start the copy of tile m0's h rows into buf ([nkc] K-major 8 KB tiles);
// the calling warpgroup's threads
__device__ __forceinline__ void ce_fetch_a(const __nv_bfloat16* h, int N,
                                           int P, int nkc, int m0,
                                           unsigned char* buf) {
  const int words = nkc * kWgBK / 2;  // 4-byte words in a padded row
  for (int i = threadIdx.x % 128; i < kCeRows * words; i += 128) {
    const int r = i / words, k = 2 * (i % words);
    const bool ok = m0 + r < N && k < P;
    cp_async4(buf + (k / kWgBK) * kCeTile +
                  swz(r * 128 + ((k % kWgBK) / 8) * 16) + (k % 8) * 2,
              ok ? h + static_cast<size_t>(m0 + r) * P + k : h, ok);
  }
}

// Build W's image: segment s (k-row s / (8 kNch), columns 8 (s % (8
// kNch)) ..+ 7) from the five aligned words around it, eight segments a
// thread in flight, every load unconditional (its address clamped into W;
// the one or two words W only half covers, at its ends, are redone by
// halves); k-rows P .. 64 nkc - 1 and columns S .. zero. Every thread of
// the block calls it.
template <int kNch>
__device__ __forceinline__ void ce_build_w(const __nv_bfloat16* w, int P,
                                           int S, int nkc,
                                           unsigned char* img) {
  constexpr int kBatch = 8;
  const unsigned long long lo = reinterpret_cast<unsigned long long>(w);
  const unsigned long long hi = lo + 2ull * P * S;
  // the whole words inside [lo, hi)
  const unsigned long long lo4 = (lo + 3) & ~3ull, hi4 = hi & ~3ull;
  const int nseg = nkc * kWgBK * 8 * kNch;
  for (int s0 = threadIdx.x; s0 < nseg; s0 += kBatch * blockDim.x) {
    unsigned u[kBatch][5];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int s = min(s0 + q * static_cast<int>(blockDim.x), nseg - 1);
      const int k = min(s / (8 * kNch), P - 1), n0 = 8 * (s % (8 * kNch));
      const unsigned long long w0 =
          (lo + 2ull * (static_cast<unsigned long long>(k) * S + n0)) & ~3ull;
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        const unsigned long long wa = w0 + 4 * j;
        u[q][j] = hi4 > lo4 ? *reinterpret_cast<const unsigned*>(
                                  min(max(wa, lo4), hi4 - 4))
                            : 0u;
      }
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int s = s0 + q * blockDim.x;
      if (s >= nseg) break;
      const int k = s / (8 * kNch), ch = s % (8 * kNch), n0 = 8 * ch;
      const unsigned long long b0 =
          lo + 2ull * (static_cast<unsigned long long>(k) * S + n0);
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        const unsigned long long wa = (b0 & ~3ull) + 4 * j;
        if (wa < lo4 || wa + 4 > hi4) {  // at W's ends: by halves
          u[q][j] = 0u;
          if (wa >= lo && wa < hi)
            u[q][j] |= *reinterpret_cast<const unsigned short*>(wa);
          if (wa + 2 >= lo && wa + 2 < hi)
            u[q][j] |= static_cast<unsigned>(
                           *reinterpret_cast<const unsigned short*>(wa + 2))
                       << 16;
        }
      }
      unsigned o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = b0 & 2ull ? __funnelshift_r(u[q][j], u[q][j + 1], 16)
                         : u[q][j];
#pragma unroll
      for (int e = 0; e < 8; ++e)  // columns beyond S and rows beyond P
        if (k >= P || n0 + e >= S)
          o[e / 2] &= e % 2 ? 0x0000ffffu : 0xffff0000u;
      *reinterpret_cast<uint4*>(
          img + ((k / kWgBK) * kNch + ch / 8) * kCeTile +
          swz((k % kWgBK) * 128 + (ch % 8) * 16)) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// The resident path's body: warpgroup g of block x takes the tiles
// m0 = 64 (ce_wgs x + g + i ce_wgs gridDim.x)
template <int kNch>
__device__ __forceinline__ void ce_resident(
    const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ b, const int* __restrict__ tc,
    __nv_bfloat16* __restrict__ p_out, float* __restrict__ part_loss,
    int* __restrict__ part_cnt, int N, int P, int S, float bias_mult,
    unsigned char* smem, float* row_loss, int* row_hit) {
  constexpr int kWgs = ce_wgs<kNch>();
  const int nkc = (P + kWgBK - 1) / kWgBK;
  const int wg = threadIdx.x / 128;
  unsigned char* img = smem;
  unsigned char* abuf = smem + (nkc * kNch + wg * nkc) * kCeTile;
  float* bias = reinterpret_cast<float*>(smem + nkc * (kNch + kWgs) * kCeTile);
  row_loss += wg * kCeRows;
  row_hit += wg * kCeRows;
  const int ntiles = (N + kCeRows - 1) / kCeRows;
  const int step = kWgs * gridDim.x;
  int tile = kWgs * blockIdx.x + wg;
  if (tile < ntiles) ce_fetch_a(h, N, P, nkc, tile * kCeRows, abuf);
  cp_async_commit();
  ce_build_w<kNch>(w, P, S, nkc, img);
  ce_bias_smem(b, bias_mult, S, bias);
  __syncthreads();
  const unsigned simg = static_cast<unsigned>(__cvta_generic_to_shared(img));
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(abuf));
  // p leaves through the A tile where it fits ([64][ps] bf16)
  const int ps = (S + 1) / 2 * 2;
  __nv_bfloat16* pstage =
      p_out != nullptr && kCeRows * ps * 2 <= nkc * kCeTile
          ? reinterpret_cast<__nv_bfloat16*>(abuf)
          : nullptr;
  for (; tile < ntiles; tile += step) {
    int t[2];
    ce_targets(tc, tile * kCeRows, N, t);
    cp_async_wait<0>();  // this tile's rows have landed
    fence_async_smem();
    wg_bar();
    float acc[kNch][32];
#pragma unroll
    for (int c = 0; c < kNch; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;
    fence_chunks(acc);
    wg_fence();
    for (int kc = 0; kc < nkc; ++kc) {
#pragma unroll
      for (int j = 0; j < kWgBK / 16; ++j)
#pragma unroll
        for (int c = 0; c < kNch; ++c)
          wgmma_m64n64k16(
              acc[c], wg_desc(sa + kc * kCeTile + j * 32, 16, 1024),
              wg_desc(simg + (kc * kNch + c) * kCeTile + j * 2048, kCeTile,
                      1024));
    }
    wg_commit();
    wg_wait<0>();
    fence_chunks(acc);
    wg_bar();  // the warpgroup's products have read its A tile
    ce_softmax_regs<kNch>(acc, bias, t, p_out, pstage, ps, tile * kCeRows, N,
                          S, row_loss, row_hit);
    wg_bar();
    if (pstage != nullptr) {
      ce_store_p(pstage, ps, p_out, tile * kCeRows, N, S);
      wg_bar();  // the A tile is free
    }
    if (tile + step < ntiles)
      ce_fetch_a(h, N, P, nkc, (tile + step) * kCeRows, abuf);
    cp_async_commit();
    if (threadIdx.x % 128 == 0)
      ce_put_tile(row_loss, row_hit, tile, part_loss, part_cnt);
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------------- f32: SIMT
template <int kNch>
struct CeSimtStage {
  float a[kSimtBK][kCeRows + kSimtPad];          // h(m, k) at a[k][m]
  float b[kSimtBK][kNch * kCeChunk + kSimtPad];  // W(k, n) at b[k][n]
};

// Start one stage's copies (4 elements each, 4-byte cp.async, zero-filled
// beyond the edges): A along k into the k-major tile, B along n
template <int kNch>
__device__ __forceinline__ void ce_simt_fetch(const View<float>& h,
                                              const View<float>& w, int m0,
                                              int n0, int k0,
                                              CeSimtStage<kNch>& st) {
  constexpr int kT = 256;
  constexpr int kQ = kSimtBK / 4;           // 4-element groups per A row
  constexpr int kNq = kNch * kCeChunk / 4;  // 4-element groups per B row
  for (int i = threadIdx.x; i < kCeRows * kQ; i += kT) {
    const int kq = (i % kQ) * 4;
    simt_copy4(h, m0 + i / kQ, k0 + kq, h.cols, true, &st.a[kq][i / kQ],
               kCeRows + kSimtPad);
  }
  for (int i = threadIdx.x; i < kSimtBK * kNq; i += kT)
    simt_copy4(w, k0 + i / kNq, n0 + (i % kNq) * 4, w.cols, true,
               &st.b[i / kNq][(i % kNq) * 4], 1);
}

// 8 x 2 kNch outputs a thread: a warp takes 64 rows x 8 kNch columns (8 x
// 4 lanes, each two 4-row strips and 2 kNch adjacent columns), the eight
// warps 64 kNch columns. acc[i][j] = h[m0 + ce_simt_row(i), :] .
// W[:, n0 + ce_simt_col<kNch>(j)]
__device__ __forceinline__ int ce_simt_row(int i) {
  return (i / 4) * 32 + ((threadIdx.x % 32) / 4) * 4 + i % 4;
}
template <int kNch>
__device__ __forceinline__ int ce_simt_col(int j) {
  return (threadIdx.x / 32) * 8 * kNch + (threadIdx.x % 4) * 2 * kNch + j;
}

// ... over a two-stage ring: the copies of stage k + 1 land while stage k
// computes. Every thread of the block calls it; it ends with the ring free.
template <int kNch>
__device__ __forceinline__ void ce_simt_product(const View<float>& h,
                                                const View<float>& w,
                                                int m0, int n0,
                                                float (&acc)[8][2 * kNch],
                                                CeSimtStage<kNch>* st) {
  const int nk = (h.cols + kSimtBK - 1) / kSimtBK;
  const int ar = ((threadIdx.x % 32) / 4) * 4;
  const int bc = ce_simt_col<kNch>(0);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 2 * kNch; ++j) acc[i][j] = 0.0f;
  ce_simt_fetch<kNch>(h, w, m0, n0, 0, st[0]);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    // stage kt has landed for every thread, and every thread is done with
    // stage kt - 1, which the copies below refill
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < nk)
      ce_simt_fetch<kNch>(h, w, m0, n0, (kt + 1) * kSimtBK, st[(kt + 1) % 2]);
    cp_async_commit();
    const CeSimtStage<kNch>& cur = st[kt % 2];
#pragma unroll
    for (int kk = 0; kk < kSimtBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&cur.a[kk][ar]);
      const float4 a1 = *reinterpret_cast<const float4*>(&cur.a[kk][ar + 32]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[2 * kNch];
#pragma unroll
      for (int j = 0; j < kNch; ++j) {
        const float2 bj =
            *reinterpret_cast<const float2*>(&cur.b[kk][bc + 2 * j]);
        bv[2 * j] = bj.x;
        bv[2 * j + 1] = bj.y;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 2 * kNch; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// ------------------------------------------------ the shared logits block
// lg[r][n] = v + bias_mult * b[n] for n < S (0 up to the pitch LW), the
// bias product rounded on its own
__device__ __forceinline__ float ce_logit(float v, const float* b,
                                          float bias_mult, int n, int S) {
  return n < S ? v + __fmul_rn(bias_mult, b[n]) : 0.0f;
}

// The softmax from the logits block, one warp per row: min, max, the exp
// sum (e kept in the block), p with its store and first argmax, p_t; each
// row's loss and hit into row_loss / row_hit.
template <typename POut>
__device__ __forceinline__ void ce_softmax_smem(
    float* lg, int LW, int S, int m0, int N, const int* __restrict__ tc,
    POut* __restrict__ p_out, float* row_loss, int* row_hit) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int r = warp; r < kCeRows; r += nwarps) {
    const int gm = m0 + r;
    float loss = 0.0f;
    int hit = 0;
    if (gm < N) {
      float* a = lg + r * LW;
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
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      // p (e / sum, correctly rounded), kept in the block, and its first
      // argmax (ties to the lowest index)
      const float inv = __frcp_rn(sum);
      for (int s = lane; s < S; s += 32) a[s] = ce_div(a[s], sum, inv);
      float best = -CUDART_INF_F;
      int arg = S;
      for (int s = lane; s < S; s += 32) {
        const float p = a[s];
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
      __syncwarp();  // every lane reads a[tc] below
      const int t = tc[gm];
      if (t >= 0) {
        const float pt = t < S ? a[t] : 0.0f;
        loss = -logf(fmaxf(pt, kRealMin));
        hit = arg == t ? 1 : 0;
      }
    }
    if (lane == 0) {
      row_loss[r] = loss;
      row_hit[r] = hit;
    }
  }
}

// ---------------------------------------------------------------- K3f
// One block per 64 rows (kCeResident: per SM, walking the tiles). kNch:
// 64-column chunks of the product per pass.
template <typename T, int kNch, int kMode>
__global__ void __launch_bounds__(ce_threads<T, kNch, kMode>(),
                                  ce_min_blocks<T, kNch, kMode>())
    ce_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
                  const float* __restrict__ b, const int* __restrict__ tc,
                  T* __restrict__ p_out, float* __restrict__ part_loss,
                  int* __restrict__ part_cnt, int N, int P, int S,
                  float bias_mult) {
  extern __shared__ __align__(16) unsigned char ce_smem[];
  __shared__ float row_loss[3 * kCeRows];
  __shared__ int row_hit[3 * kCeRows];
  const int m0 = blockIdx.x * kCeRows;
  const View<T> hv = make_view<T>(h, P, N, P);
  const View<T> wv = make_view<T>(w, S, P, S);
  const int LW = ce_lg_width(S);
  constexpr int kPass = kNch * kCeChunk;
  if constexpr (is_bf16<T>) {
    // the swizzle repeats every 1024 bytes: align the ring to it
    const unsigned s0 =
        static_cast<unsigned>(__cvta_generic_to_shared(ce_smem));
    unsigned char* ring = ce_smem + ((1024u - (s0 & 1023u)) & 1023u);
    if constexpr (kMode == kCeResident) {
      ce_resident<kNch>(h, w, b, tc, p_out, part_loss, part_cnt, N, P, S,
                        bias_mult, ring, row_loss, row_hit);
      return;  // the tiles' partials are written
    } else if constexpr (kMode == kCeStream) {
      int t[2];
      ce_targets(tc, m0, N, t);
      float acc[kNch][32];
      ce_wg_product<kNch>(hv, wv, m0, 0, acc, ring);
      __syncthreads();  // every warp's products are done: the ring is free
      // the bias products, then p's rows, in the ring
      float* bias = reinterpret_cast<float*>(ring);
      ce_bias_smem(b, bias_mult, S, bias);
      __syncthreads();
      const int ps = (S + 1) / 2 * 2;
      __nv_bfloat16* pstage =
          p_out != nullptr ? reinterpret_cast<__nv_bfloat16*>(ring + 1024)
                           : nullptr;
      ce_softmax_regs<kNch>(acc, bias, t, p_out, pstage, ps, m0, N, S,
                            row_loss, row_hit);
      __syncthreads();
      if (pstage != nullptr) ce_store_p(pstage, ps, p_out, m0, N, S);
    } else {
      float* lg = reinterpret_cast<float*>(ring + 2 * (1 + kNch) * kCeTile);
      const int lane = threadIdx.x % 32;
      const int r = (threadIdx.x / 32) * 16 + lane / 4;
      for (int n0 = 0; n0 < S; n0 += kPass) {
        float acc[kNch][32];
        __syncthreads();  // the last pass's products have left the ring
        ce_wg_product<kNch>(hv, wv, m0, n0, acc, ring);
#pragma unroll
        for (int c = 0; c < kNch; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = n0 + c * kCeChunk + 8 * j + 2 * (lane % 4);
            if (n < LW)
#pragma unroll
              for (int hf = 0; hf < 2; ++hf)
                *reinterpret_cast<float2*>(lg + (r + 8 * hf) * LW + n) =
                    make_float2(
                        ce_logit(acc[c][4 * j + 2 * hf], b, bias_mult, n, S),
                        ce_logit(acc[c][4 * j + 2 * hf + 1], b, bias_mult,
                                 n + 1, S));
          }
      }
      __syncthreads();
      ce_softmax_smem<T>(lg, LW, S, m0, N, tc, p_out, row_loss, row_hit);
    }
  } else {
    auto* st = reinterpret_cast<CeSimtStage<kNch>*>(ce_smem);
    // one pass: the logits block over the ring, free once the product is
    // done; passes: beside it
    float* lg = reinterpret_cast<float*>(
        ce_smem + (kMode == kCeWide ? ce_ring_bytes(false, kNch) : 0));
    for (int n0 = 0; n0 < S; n0 += kPass) {
      float acc[8][2 * kNch];
      ce_simt_product<kNch>(hv, wv, m0, n0, acc, st);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 2 * kNch; j += 2) {
          const int n = n0 + ce_simt_col<kNch>(j);
          if (n < LW)
            *reinterpret_cast<float2*>(lg + ce_simt_row(i) * LW + n) =
                make_float2(ce_logit(acc[i][j], b, bias_mult, n, S),
                            ce_logit(acc[i][j + 1], b, bias_mult, n + 1, S));
        }
      if (kMode != kCeWide) break;
    }
    __syncthreads();
    ce_softmax_smem<T>(lg, LW, S, m0, N, tc, p_out, row_loss, row_hit);
  }
  __syncthreads();
  if (threadIdx.x == 0)
    ce_put_tile(row_loss, row_hit, blockIdx.x, part_loss, part_cnt);
}

// ------------------------------------------------------------------- K3b
// Its tiles (ops/softmax_ce.py proj_bwd_plan mirrors them, and a CPU test
// reads them here). dh: a block owns kPbRows rows and kPbDhCols columns
// (of P) of dh and walks S in chunks of kPbDhKBf16 / kPbDhKF32 columns.
// dW: a block owns kPbDwRows rows (of P: a pass) and kPbDwCols columns (of
// S) of dW, and walks its split of the rows in tiles of kPbDwTileBf16 /
// kPbDwTileF32 rows through a ring of kPbDwStages stages.
constexpr int kPbThreads = 256;
constexpr int kPbRows = 64;
constexpr int kPbDhCols = 256;
constexpr int kPbDhKBf16 = 64;  // one 128-byte swizzle row of bf16
constexpr int kPbDhKF32 = 32;
constexpr int kPbDwRows = 128;  // two warpgroups' 64 (bf16)
constexpr int kPbDwCols = 192;  // three 64-column chunks
constexpr int kPbDwTileBf16 = 64;  // one wgmma K of 64
constexpr int kPbDwTileF32 = 32;
constexpr int kPbDwStages = 3;
// the dW kernel's threads that form dz: 24 chunks of 8 columns x 8 rows
constexpr int kPbDzThreads = 192;

// dh's stage: W's chunk (kPbDhCols packed rows), the chunk's p segments of
// the tile's rows, dz's chunk; each a multiple of 1 KB, so that the
// swizzled tiles stay aligned
template <typename T>
struct PbDh {
  static constexpr int kEs = static_cast<int>(sizeof(T));
  static constexpr int kK = is_bf16<T> ? kPbDhKBf16 : kPbDhKF32;
  // the 16-byte chunks that kK columns of a row span, wherever they begin
  static constexpr int kSegs = kK * kEs / 16 + 1;
  static constexpr int kWBytes = kPbDhCols * kK * kEs;
  static constexpr int kSegBytes = kPbRows * kSegs * 16;
  static constexpr int kZBytes = kPbRows * kK * kEs;
  static constexpr int kStage = kWBytes + kSegBytes + kZBytes;
  static constexpr int kSmem = 2 * kStage + 1024;
};

// dW's stage: h's tile (the pass's kPbDwRows columns of h), the tile's p
// segments of the block's columns, the rows' constants; then two dz tiles
// (the next is formed while the tensor cores or the FMAs read this one)
template <typename T>
struct PbDw {
  static constexpr int kEs = static_cast<int>(sizeof(T));
  static constexpr int kRows = is_bf16<T> ? kPbDwTileBf16 : kPbDwTileF32;
  static constexpr int kSegs = kPbDwCols * kEs / 16 + 1;
  static constexpr int kHBytes = kRows * kPbDwRows * kEs;
  static constexpr int kSegBytes = kRows * kSegs * 16;
  static constexpr int kStage =
      (kHBytes + kSegBytes + kRows * 16 + 1023) / 1024 * 1024;
  static constexpr int kZBytes = kRows * kPbDwCols * kEs;
  static constexpr int kSmem = kPbDwStages * kStage + 2 * kZBytes + 1024;
};

// 16 bytes at src into shared dst by cp.async, the first n of them (the
// rest zero-filled)
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src,
                                             int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

// The p segment of matrix row `row` from column c0: it begins in the
// 16-byte chunk that holds element (row, c0), pb_shift elements before it.
// Rows of p are rarely 16-byte aligned (183 bf16 are 366 bytes), but the
// chunks of p are, so every copy is an aligned 16 bytes.
template <typename T>
__device__ __forceinline__ int pb_shift(int row, int S, int c0) {
  return static_cast<int>((static_cast<long long>(row) * S + c0) %
                          (16 / static_cast<int>(sizeof(T))));
}

// Start the copies of the p segments of kR rows from row0, columns from
// c0, segs chunks a row, into dst (row r at r segs 16 bytes); bytes past
// the end of p, and rows past N, are zero-filled
template <typename T, int kR>
__device__ __forceinline__ void pb_fill_seg(const T* p, int N, int S,
                                            int row0, int c0, int segs,
                                            unsigned char* dst) {
  const long long total = static_cast<long long>(N) * S * sizeof(T);
  for (int i = threadIdx.x; i < kR * segs; i += kPbThreads) {
    const int r = i / segs, q = i % segs;
    const int row = row0 + r;
    const long long a =
        ((static_cast<long long>(row) * S + c0) * sizeof(T) & ~15ll) + 16 * q;
    const long long left = row < N ? total - a : 0;
    const int n = left <= 0 ? 0 : (left >= 16 ? 16 : static_cast<int>(left));
    cp_async16_n(dst + i * 16, reinterpret_cast<const char*>(p) + (n ? a : 0),
                 n);
  }
}

// dz of columns c .. c + 7 of one row, from the row's p segment (seg; its
// column c0 at element sh) and constants rc = {-s, inv - s, target, 0}:
// the twin's p (onehot inv - s) valid g as (p k) g, k = inv - s at the
// target column and -s elsewhere. These are the twin's bits for any g: its
// valid is 1 on a real row, and a dummy row (pt = 0) has k = +0 at every
// column, as the twin's (onehot inv - s) is. 0 at columns >= S and on rows
// past N (zero constants and p).
template <typename T>
__device__ __forceinline__ void pb_dz8(const unsigned char* seg, int sh,
                                       int c0, int c, int S, float4 rc,
                                       float g, float (&d)[8]) {
  const T* v = reinterpret_cast<const T*>(seg) + sh + (c - c0);
  const int et = __float_as_int(rc.z) - c;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float pv = c + e < S ? as_f32(v[e]) : 0.0f;
    d[e] = __fmul_rn(__fmul_rn(pv, e == et ? rc.y : rc.x), g);
  }
}

__device__ __forceinline__ uint4 pack_bf16x8(const float (&d)[8]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b2 = __floats2bfloat162_rn(d[2 * i], d[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&b2);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The rows' constants rowc[r] = {-s, inv - s, target, 0}, inv = -1 /
// max(pt, REAL_MIN), s = pt inv, pt = p[r, target] (0 on a dummy row),
// once a row, so that no kernel after divides; and W packed, zero-padded:
// bf16 wp[n, k] = W[n, k] ([pp, sp], dh's K-major B operand), f32
// wp[k, n] = W[n, k] ([sp, pp], dh's SIMT rows)
template <typename T>
__global__ void pb_prep_kernel(const T* __restrict__ p,
                               const int* __restrict__ tc,
                               const T* __restrict__ w, int N, int P, int S,
                               float4* __restrict__ rowc, T* __restrict__ wp,
                               int pp, int sp) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  for (long long r = first; r < N; r += stride) {
    const int t = tc[r];
    const float pt = (t >= 0 && t < S) ? as_f32(p[r * S + t]) : 0.0f;
    const float inv = -1.0f / fmaxf(pt, kRealMin);
    const float s = pt * inv;
    rowc[r] = make_float4(-s, inv - s, __int_as_float(t), 0.0f);
  }
  const long long nw = static_cast<long long>(pp) * sp;
  for (long long i = first; i < nw; i += stride) {
    long long n, k;
    if constexpr (is_bf16<T>) {
      n = i / sp;
      k = i % sp;
    } else {
      k = i / pp;
      n = i % pp;
    }
    wp[i] = (n < P && k < S) ? w[n * S + k] : f32_to<T>(0.0f);
  }
}

// dh = dzc . W^T for kPbRows rows and kPbDhCols columns. Per chunk of S:
// the chunk's p segments and W's packed chunk copied by cp.async two
// chunks ahead, dz formed from p into shared memory (rounded to T), the
// product on it. bf16: two warpgroups, each 64 x 128 of dh by wgmma
// m64n128k16, dz and W both K-major; f32: 8 x 8 outputs a thread (a warp
// 32 rows x 64 columns, two 4-row and two 4-column strips a thread).
template <typename T>
__global__ void __launch_bounds__(kPbThreads, 2)
    pb_dh_kernel(const T* __restrict__ p, const float4* __restrict__ rowc,
                 const T* __restrict__ wp, const float* __restrict__ g,
                 T* __restrict__ dh, int N, int P, int S, int pp, int sp) {
  using G = PbDh<T>;
  constexpr int kK = G::kK;
  extern __shared__ __align__(16) unsigned char pb_smem[];
  __shared__ float4 rc_s[kPbRows];
  const unsigned s0 =
      static_cast<unsigned>(__cvta_generic_to_shared(pb_smem));
  unsigned char* ring = pb_smem + ((1024u - (s0 & 1023u)) & 1023u);
  const int m0 = blockIdx.x * kPbRows, n0 = blockIdx.y * kPbDhCols;
  const int nk = (S + kK - 1) / kK;
  if (threadIdx.x < kPbRows) {
    const int row = m0 + threadIdx.x;
    rc_s[threadIdx.x] =
        row < N ? rowc[row] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const float gv = g[0];
  auto fill = [&](int kc) {
    unsigned char* st = ring + (kc % 2) * G::kStage;
    for (int i = threadIdx.x; i < G::kWBytes / 16; i += kPbThreads) {
      if constexpr (is_bf16<T>) {  // row n, 16-byte k chunk q, K-major
        const int n = i / 8, q = i % 8;
        cp_async16_n(st + swz(n * 128 + q * 16),
                     wp + static_cast<size_t>(n0 + n) * sp + kc * kK + q * 8,
                     16);
      } else {  // k-row k of the packed W^T, 16-byte n chunk q
        const int k = i / (kPbDhCols / 4), q = i % (kPbDhCols / 4);
        cp_async16_n(st + k * (kPbDhCols * 4) + q * 16,
                     wp + static_cast<size_t>(kc * kK + k) * pp + n0 + q * 4,
                     16);
      }
    }
    pb_fill_seg<T, kPbRows>(p, N, S, m0, kc * kK, G::kSegs,
                            st + G::kWBytes);
  };
  fill(0);
  cp_async_commit();
  if (nk > 1) fill(1);
  cp_async_commit();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = threadIdx.x / 128;
  const bool mma = n0 + wg * 128 < P;  // bf16: the warpgroup's columns
  const int ar = (warp / 4) * 32 + (lane / 8) * 4;  // f32: the strips
  const int bc = (warp % 4) * 64 + (lane % 8) * 4;
  float acc[64], accf[8][8];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) accf[i][j] = 0.0f;
  for (int kc = 0; kc < nk; ++kc) {
    unsigned char* st = ring + (kc % 2) * G::kStage;
    unsigned char* zs = st + G::kWBytes + G::kSegBytes;
    const int c0 = kc * kK;
    cp_async_wait<1>();
    __syncthreads();  // chunk kc has landed for every thread; rc_s is set
    if constexpr (is_bf16<T>) {
      // dz [64 rows, 64 k] K-major: row r's 16-byte k chunk j
      for (int u = threadIdx.x; u < kPbRows * 8; u += kPbThreads) {
        const int r = u / 8, j = u % 8;
        float d[8];
        pb_dz8<T>(st + G::kWBytes + r * G::kSegs * 16,
                  pb_shift<T>(m0 + r, S, c0), c0, c0 + 8 * j, S, rc_s[r], gv,
                  d);
        *reinterpret_cast<uint4*>(zs + swz(r * 128 + j * 16)) =
            pack_bf16x8(d);
      }
      fence_async_smem();  // dz, for wgmma's reads
    } else {
      // dz [32 k, 64 rows]: thread t's row t % 64, columns 8 (t / 64) ..
      const int r = threadIdx.x % kPbRows, j = threadIdx.x / kPbRows;
      float d[8];
      pb_dz8<T>(st + G::kWBytes + r * G::kSegs * 16,
                pb_shift<T>(m0 + r, S, c0), c0, c0 + 8 * j, S, rc_s[r], gv,
                d);
      float* z = reinterpret_cast<float*>(zs);
#pragma unroll
      for (int e = 0; e < 8; ++e) z[(8 * j + e) * kPbRows + r] = d[e];
    }
    __syncthreads();  // dz of chunk kc is whole
    if constexpr (is_bf16<T>) {
      if (mma) {
        const unsigned sw =
            static_cast<unsigned>(__cvta_generic_to_shared(st)) + wg * 16384;
        const unsigned sz =
            static_cast<unsigned>(__cvta_generic_to_shared(zs));
        fence_acc(acc);
        wg_fence();
#pragma unroll
        for (int j = 0; j < kK / 16; ++j)
          wgmma_m64n128k16<0, 0>(acc, wg_desc(sz + j * 32, 16, 1024),
                                 wg_desc(sw + j * 32, 16, 1024));
        wg_commit();
        wg_wait<0>();
        fence_acc(acc);
      }
    } else {
      const float* z = reinterpret_cast<const float*>(zs);
      const float* w = reinterpret_cast<const float*>(st);
#pragma unroll 8
      for (int kk = 0; kk < kK; ++kk) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(z + kk * kPbRows + ar);
        const float4 a1 =
            *reinterpret_cast<const float4*>(z + kk * kPbRows + ar + 16);
        const float4 b0 =
            *reinterpret_cast<const float4*>(w + kk * kPbDhCols + bc);
        const float4 b1 =
            *reinterpret_cast<const float4*>(w + kk * kPbDhCols + bc + 32);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            accf[i][j] = fmaf(av[i], bv[j], accf[i][j]);
      }
    }
    __syncthreads();  // every thread is done with chunk kc's stage
    if (kc + 2 < nk) fill(kc + 2);
    cp_async_commit();
  }
  EpiStore<T> epi{dh, P};
  if constexpr (is_bf16<T>) {
    if (mma) {
      // register 4 j + q: row lane / 4 + 8 (q / 2) of the warp's 16,
      // column 8 j + 2 (lane % 4) + q % 2
      const int mr = m0 + (warp % 4) * 16 + lane / 4;
      const int nc = n0 + wg * 128 + (lane % 4) * 2;
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int m = mr + 8 * ((i % 4) / 2);
        const float v[2] = {acc[i], acc[i + 1]};
        if (m < N) epi_put<2>(epi, 0, 0, m, nc + 8 * (i / 4), P, v, false);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + ar + (i / 4) * 16 + i % 4;
      if (m >= N) continue;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float v[4] = {accf[i][4 * s], accf[i][4 * s + 1],
                            accf[i][4 * s + 2], accf[i][4 * s + 3]};
        epi_put<4>(epi, 0, 0, m, n0 + bc + 32 * s, P, v, false);
      }
    }
  }
}

// The resident dh body, taken where W's block of columns fits beside a
// tile (S <= kPbResMax: the main path's 183 classes):
// one persistent block an SM keeps kPbResColsBf16 / kPbResColsF32 columns
// (of P) of the packed W in shared memory and walks the row tiles b,
// b + gridDim.x, ... . A tile: its p segments over all of S and its rows'
// constants by cp.async (the next tile's land while this one's product
// and stores run), dz formed into shared memory, the product (bf16: two
// warpgroups, each 64 x 128 by wgmma m64n128k16 over S's 64-column atoms;
// f32: 8 x 4 outputs a thread), and dh staged through shared memory and
// stored row by row, a warp's stores consecutive elements (the
// accumulators of a warp scatter over 8 or 16 rows).
constexpr int kPbResColsBf16 = 256;
constexpr int kPbResColsF32 = 128;
constexpr int kPbResMax = 192;

template <typename T>
struct PbRes {
  static constexpr int kEs = static_cast<int>(sizeof(T));
  static constexpr int kCols = is_bf16<T> ? kPbResColsBf16 : kPbResColsF32;
  // dh's staging pitch (elements): rows 16 bytes apart in the banks
  static constexpr int kOutLd = kCols + 16 / kEs;
  // p segment buffers: bf16 two (the copies run two tiles ahead), f32 one
  // (its W block and dz leave no room for a second)
  static constexpr int kSegBufs = is_bf16<T> ? 2 : 1;
  // shared memory at sp columns (S rounded up as the packed W): W's block,
  // the p segments, dz (then dh's staging), the rows' constants
  __host__ __device__ static constexpr int w_bytes(int sp) {
    return kCols * sp * kEs;
  }
  __host__ __device__ static constexpr int segs(int sp) {
    return sp * kEs / 16 + 1;
  }
  __host__ __device__ static constexpr int seg_bytes(int sp) {
    return kPbRows * segs(sp) * 16;
  }
  __host__ __device__ static constexpr int z_bytes(int sp) {
    return kPbRows * (sp > kOutLd ? sp : kOutLd) * kEs;
  }
  __host__ __device__ static constexpr int smem(int sp) {
    return w_bytes(sp) + kSegBufs * (seg_bytes(sp) + kPbRows * 16) +
           z_bytes(sp) + 1024;
  }
};

template <typename T>
__global__ void __launch_bounds__(kPbThreads, 1)
    pb_dh_res_kernel(const T* __restrict__ p, const float4* __restrict__ rowc,
                     const T* __restrict__ wp, const float* __restrict__ g,
                     T* __restrict__ dh, int N, int P, int S, int pp,
                     int sp) {
  using G = PbRes<T>;
  extern __shared__ __align__(16) unsigned char pb_smem[];
  const unsigned s0 =
      static_cast<unsigned>(__cvta_generic_to_shared(pb_smem));
  unsigned char* wres = pb_smem + ((1024u - (s0 & 1023u)) & 1023u);
  unsigned char* zs = wres + G::w_bytes(sp);
  // buffer b: its p segments, then its rows' constants
  unsigned char* bufs = zs + G::z_bytes(sp);
  const int buf_bytes = G::seg_bytes(sp) + kPbRows * 16;
  const int segs = G::segs(sp);
  const int n0 = blockIdx.y * G::kCols;
  const int ntiles = (N + kPbRows - 1) / kPbRows;
  const float gv = g[0];
  // W's block: bf16 K-major atoms of 64 columns of S ([kCols rows x 128
  // bytes] each), f32 [sp, kCols]
  for (int i = threadIdx.x; i < G::kCols * sp * G::kEs / 16;
       i += kPbThreads) {
    if constexpr (is_bf16<T>) {
      const int n = i / (sp / 8), k8 = i % (sp / 8);
      cp_async16_n(wres + (k8 / 8) * (G::kCols * 128) +
                       swz(n * 128 + (k8 % 8) * 16),
                   wp + static_cast<size_t>(n0 + n) * sp + 8 * k8, 16);
    } else {
      const int k = i / (G::kCols / 4), q = i % (G::kCols / 4);
      cp_async16_n(wres + k * (G::kCols * 4) + q * 16,
                   wp + static_cast<size_t>(k) * pp + n0 + 4 * q, 16);
    }
  }
  // the block's j-th tile's p segments and constants into buffer j %
  // kSegBufs
  auto fill = [&](int j) {
    const int tile = blockIdx.x + j * gridDim.x;
    if (tile >= ntiles) return;
    const int m0 = tile * kPbRows;
    unsigned char* b = bufs + (j % G::kSegBufs) * buf_bytes;
    pb_fill_seg<T, kPbRows>(p, N, S, m0, 0, segs, b);
    float4* rc = reinterpret_cast<float4*>(b + G::seg_bytes(sp));
    for (int r = threadIdx.x; r < kPbRows; r += kPbThreads)
      cp_async16_n(rc + r, m0 + r < N ? rowc + m0 + r : rowc,
                   m0 + r < N ? 16 : 0);
  };
  for (int j = 0; j < G::kSegBufs; ++j) {
    fill(j);
    cp_async_commit();
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = threadIdx.x / 128;
  const bool mma = n0 + wg * 128 < P;  // bf16: the warpgroup's columns
  const int ar = (warp / 2) * 16 + (lane / 16) * 8;  // f32: 8 rows
  const int bc = (warp % 2) * 64 + (lane % 16) * 4;  // and 4 columns
  const int cw = min(G::kCols, P - n0);
  for (int j = 0, tile = blockIdx.x; tile < ntiles;
       ++j, tile += gridDim.x) {
    const int m0 = tile * kPbRows;
    const unsigned char* seg = bufs + (j % G::kSegBufs) * buf_bytes;
    const float4* rc_s =
        reinterpret_cast<const float4*>(seg + G::seg_bytes(sp));
    cp_async_wait<G::kSegBufs - 1>();
    // the tile (and W) have landed, and every thread is done with the
    // last tile's staging
    __syncthreads();
    if constexpr (is_bf16<T>) {
      // dz K-major in 64-column atoms: row r's 16-byte k chunk j
      for (int u = threadIdx.x; u < kPbRows * (sp / 8); u += kPbThreads) {
        const int r = u / (sp / 8), j = u % (sp / 8);
        float d[8];
        pb_dz8<T>(seg + r * segs * 16, pb_shift<T>(m0 + r, S, 0), 0, 8 * j,
                  S, rc_s[r], gv, d);
        *reinterpret_cast<uint4*>(zs + (j / 8) * 8192 +
                                  swz(r * 128 + (j % 8) * 16)) =
            pack_bf16x8(d);
      }
      fence_async_smem();
    } else {
      // dz [sp, 64]: thread t's row t % 64, column chunks t / 64 + 4 i
      const int r = threadIdx.x % kPbRows;
      for (int j = threadIdx.x / kPbRows; j < sp / 8; j += 4) {
        float d[8];
        pb_dz8<T>(seg + r * segs * 16, pb_shift<T>(m0 + r, S, 0), 0, 8 * j,
                  S, rc_s[r], gv, d);
        float* z = reinterpret_cast<float*>(zs);
#pragma unroll
        for (int e = 0; e < 8; ++e) z[(8 * j + e) * kPbRows + r] = d[e];
      }
    }
    __syncthreads();  // dz is whole; this buffer is free
    fill(j + G::kSegBufs);
    cp_async_commit();
    float acc[64], accf[8][4];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) accf[i][j] = 0.0f;
    if constexpr (is_bf16<T>) {
      if (mma) {
        const unsigned sw =
            static_cast<unsigned>(__cvta_generic_to_shared(wres)) +
            wg * 16384;
        const unsigned sz =
            static_cast<unsigned>(__cvta_generic_to_shared(zs));
        fence_acc(acc);
        wg_fence();
        for (int a = 0; a < sp / 64; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wgmma_m64n128k16<0, 0>(
                acc, wg_desc(sz + a * 8192 + j * 32, 16, 1024),
                wg_desc(sw + a * (G::kCols * 128) + j * 32, 16, 1024));
        wg_commit();
        wg_wait<0>();
        fence_acc(acc);
      }
    } else {
      const float* z = reinterpret_cast<const float*>(zs);
      const float* w = reinterpret_cast<const float*>(wres);
#pragma unroll 8
      for (int k = 0; k < sp; ++k) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(z + k * kPbRows + ar);
        const float4 a1 =
            *reinterpret_cast<const float4*>(z + k * kPbRows + ar + 4);
        const float4 b0 =
            *reinterpret_cast<const float4*>(w + k * G::kCols + bc);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[4] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            accf[i][j] = fmaf(av[i], bv[j], accf[i][j]);
      }
    }
    __syncthreads();  // every thread is done with dz: stage dh over it
    T* out = reinterpret_cast<T*>(zs);  // [kPbRows, kOutLd]
    if constexpr (is_bf16<T>) {
      if (mma) {
        // register 4 j + q: row lane / 4 + 8 (q / 2) of the warp's 16,
        // column 8 j + 2 (lane % 4) + q % 2
        const int mr = (warp % 4) * 16 + lane / 4;
#pragma unroll
        for (int i = 0; i < 64; i += 2)
          *reinterpret_cast<__nv_bfloat162*>(
              out + (mr + 8 * ((i % 4) / 2)) * G::kOutLd + wg * 128 +
              8 * (i / 4) + 2 * (lane % 4)) =
              __floats2bfloat162_rn(acc[i], acc[i + 1]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float4*>(out + (ar + i) * G::kOutLd + bc) =
            make_float4(accf[i][0], accf[i][1], accf[i][2], accf[i][3]);
    }
    __syncthreads();
    const int rows = min(kPbRows, N - m0);
    if (cw == P) {
      // the tile's rows are one contiguous stretch of dh, aligned to 16
      // bytes (64 rows of P elements): stored 16 bytes at a time
      constexpr int E = 16 / G::kEs;
      const int n = rows * P;
      T* base = dh + static_cast<long long>(m0) * P;
      for (int f = threadIdx.x * E; f < n; f += kPbThreads * E) {
        union {
          uint4 q;
          T e[E];
        } v;
        int r = f / P, c = f % P;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          v.e[e] = out[r * G::kOutLd + c];
          if (++c == P) {
            c = 0;
            ++r;
          }
        }
        if (f + E <= n) {
          *reinterpret_cast<uint4*>(base + f) = v.q;
        } else {
          for (int e = 0; f + e < n; ++e) base[f + e] = v.e[e];
        }
      }
    } else {  // rows of the block's columns
      for (int r = warp; r < rows; r += kPbThreads / 32)
        for (int c = lane; c < cw; c += 32)
          dh[static_cast<long long>(m0 + r) * P + n0 + c] =
              out[r * G::kOutLd + c];
    }
  }
}

// dW's partial over one split of the rows: dW[mp0 .., n0 ..] += h^T . dzc
// tile by tile, with dz formed from p on the chip, and (the first pass)
// db's partial from the unrounded dz. bf16: two warpgroups, each 64 rows of
// dW by kNch wgmma m64n64k16 chunks, h and dz both MN-major; f32: 8 x 12
// outputs a thread (a warp 32 rows x 96 columns). Writes
// part[split, m S + n] (dW) and part[split, P S + n] (db); dz_out, where
// not null, receives dz (f32, unrounded) from the first pass.
// kHWords: h's rows allow 4-byte copies (f32, or an even P in bf16), else
// they are copied element by element through registers.
template <typename T, int kNch, bool kHWords>
__global__ void __launch_bounds__(kPbThreads, 1)
    pb_dw_kernel(const T* __restrict__ p, const T* __restrict__ h,
                 const float4* __restrict__ rowc, const float* __restrict__ g,
                 float* __restrict__ part, float* __restrict__ dz_out, int N,
                 int P, int S, int ntiles, int tps) {
  using G = PbDw<T>;
  constexpr int kR = G::kRows;
  extern __shared__ __align__(16) unsigned char pb_smem[];
  const unsigned s0 =
      static_cast<unsigned>(__cvta_generic_to_shared(pb_smem));
  unsigned char* ring = pb_smem + ((1024u - (s0 & 1023u)) & 1023u);
  unsigned char* zbuf = ring + kPbDwStages * G::kStage;
  const int n0 = blockIdx.x * kPbDwCols, split = blockIdx.y;
  const int mp0 = blockIdx.z * kPbDwRows;
  const bool first = blockIdx.z == 0;
  const int t0 = split * tps;
  const int nt = min(ntiles, t0 + tps) - t0;
  const long long L = static_cast<long long>(P) * S + S;
  const float gv = g[0];
  auto fill = [&](int i) {  // row tile t0 + i into stage i % kPbDwStages
    unsigned char* st = ring + (i % kPbDwStages) * G::kStage;
    const int row0 = (t0 + i) * kR;
    // h's columns mp0 .. of the tile's rows: bf16 MN-major (64-wide m
    // atoms, k-row r at r 128 bytes), f32 [k][m]
    if constexpr (kHWords) {
      constexpr int kWords = kPbDwRows * G::kEs / 4;
      for (int q = threadIdx.x; q < kR * kWords; q += kPbThreads) {
        const int r = q / kWords, c = (q % kWords) * 4 / G::kEs;
        const int row = row0 + r, col = mp0 + c;
        const bool ok = row < N && col < P;
        unsigned off;
        if constexpr (is_bf16<T>)
          off = (c / 64) * 8192 + swz(r * 128 + (c % 64) * 2);
        else
          off = (r * kPbDwRows + c) * 4;
        cp_async4(st + off, ok ? h + static_cast<size_t>(row) * P + col : h,
                  ok);
      }
    } else {
      for (int q = threadIdx.x; q < kR * kPbDwRows; q += kPbThreads) {
        const int r = q / kPbDwRows, c = q % kPbDwRows;
        const int row = row0 + r, col = mp0 + c;
        *reinterpret_cast<T*>(st + (c / 64) * 8192 +
                              swz(r * 128 + (c % 64) * 2)) =
            (row < N && col < P) ? h[static_cast<size_t>(row) * P + col]
                                 : f32_to<T>(0.0f);
      }
    }
    pb_fill_seg<T, kR>(p, N, S, row0, n0, G::kSegs, st + G::kHBytes);
    for (int r = threadIdx.x; r < kR; r += kPbThreads) {
      const int row = row0 + r;
      cp_async16_n(st + G::kHBytes + G::kSegBytes + r * 16,
                   row < N ? rowc + row : rowc, row < N ? 16 : 0);
    }
  };
  if (nt > 0) fill(0);
  cp_async_commit();
  if (nt > 1) fill(1);
  cp_async_commit();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = threadIdx.x / 128;
  const bool mma = mp0 + wg * 64 < P;  // bf16: the warpgroup's rows
  const int ar = (warp / 2) * 32 + (lane / 8) * 4;  // f32: the strips
  const int bc = (warp % 2) * 96 + (lane % 8) * 4;
  const bool fma_rows = mp0 + (warp / 2) * 32 < P;
  // dz: thread t < kPbDzThreads forms column chunk t % 24 of rows t / 24
  // + 8 i, and sums db over them
  const int zj = threadIdx.x % 24, zg = threadIdx.x / 24;
  float acc[kNch][32], accf[8][12], db[8];
#pragma unroll
  for (int c = 0; c < kNch; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 12; ++j) accf[i][j] = 0.0f;
#pragma unroll
  for (int e = 0; e < 8; ++e) db[e] = 0.0f;
  // dz of row group rr of tile i (stage st) into zs: thread t <
  // kPbDzThreads forms column chunk zj of tile row zg + 8 rr, and the first
  // pass adds it into db
  auto form = [&](int i, const unsigned char* st, unsigned char* zs,
                  int rr) {
    const int r = zg + 8 * rr, row = (t0 + i) * kR + r;
    const int c = n0 + 8 * zj;
    const float4 rc = *reinterpret_cast<const float4*>(
        st + G::kHBytes + G::kSegBytes + r * 16);
    float d[8];
    pb_dz8<T>(st + G::kHBytes + r * G::kSegs * 16, pb_shift<T>(row, S, n0),
              n0, c, S, rc, gv, d);
    if (first) {
#pragma unroll
      for (int e = 0; e < 8; ++e) db[e] += d[e];
      if (dz_out != nullptr && row < N)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (c + e < S) dz_out[static_cast<size_t>(row) * S + c + e] = d[e];
    }
    if constexpr (is_bf16<T>) {
      *reinterpret_cast<uint4*>(zs + (zj / 8) * 8192 +
                                swz(r * 128 + (zj % 8) * 16)) =
          pack_bf16x8(d);
    } else {
      float4* z = reinterpret_cast<float4*>(zs) + (r * kPbDwCols + 8 * zj) / 4;
      z[0] = make_float4(d[0], d[1], d[2], d[3]);
      z[1] = make_float4(d[4], d[5], d[6], d[7]);
    }
  };
  if constexpr (is_bf16<T>) {
    for (int i = 0; i < nt; ++i) {
      unsigned char* st = ring + (i % kPbDwStages) * G::kStage;
      unsigned char* zs = zbuf + (i % 2) * G::kZBytes;
      cp_async_wait<kPbDwStages - 2>();
      __syncthreads();  // tile i has landed for every thread
      if (threadIdx.x < kPbDzThreads)
#pragma unroll
        for (int rr = 0; rr < kR / 8; ++rr) form(i, st, zs, rr);
      fence_async_smem();  // dz, and this thread's copies of tile i
      wg_wait<0>();        // tile i - 1's product, this warpgroup's
      fence_chunks<kNch>(acc);
      // dz of tile i is whole, and both warpgroups are done with tile
      // i - 1, whose stage the copies below refill
      __syncthreads();
      if (i + kPbDwStages - 1 < nt) fill(i + kPbDwStages - 1);
      cp_async_commit();
      if (mma) {
        // a k16 step is 16 rows (2,048 bytes) of each MN-major tile
        const unsigned sh =
            static_cast<unsigned>(__cvta_generic_to_shared(st)) + wg * 8192;
        const unsigned sz =
            static_cast<unsigned>(__cvta_generic_to_shared(zs));
        fence_chunks<kNch>(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kR / 16; ++kk)
#pragma unroll
          for (int c = 0; c < kNch; ++c)
            if (n0 + 64 * c < S)
              wgmma_m64n64k16<1, 1>(acc[c],
                                    wg_desc(sh + kk * 2048, 8192, 1024),
                                    wg_desc(sz + c * 8192 + kk * 2048, 8192,
                                            1024));
        wg_commit();
      }
    }
  } else {
    // f32: dz of tile i + 1 is formed between the FMAs of tile i (two dz
    // buffers), so that its arithmetic fills their idle issue slots and
    // one barrier a tile is left
    if (nt > 0) {
      cp_async_wait<kPbDwStages - 2>();
      __syncthreads();  // tile 0 has landed
      if (threadIdx.x < kPbDzThreads)
#pragma unroll
        for (int rr = 0; rr < kR / 8; ++rr) form(0, ring, zbuf, rr);
    }
    for (int i = 0; i < nt; ++i) {
      const unsigned char* st = ring + (i % kPbDwStages) * G::kStage;
      const float* hs = reinterpret_cast<const float*>(st);
      const float* z =
          reinterpret_cast<const float*>(zbuf + (i % 2) * G::kZBytes);
      unsigned char* st1 = ring + ((i + 1) % kPbDwStages) * G::kStage;
      unsigned char* zs1 = zbuf + ((i + 1) % 2) * G::kZBytes;
      cp_async_wait<0>();  // tile i + 1's copies
      // dz of tile i is whole, tile i + 1 has landed, and every thread is
      // done with tile i - 1: its stage (refilled below) and dz buffer
      // (tile i + 1's)
      __syncthreads();
      if (i + kPbDwStages - 1 < nt) fill(i + kPbDwStages - 1);
      cp_async_commit();
      const bool next = i + 1 < nt && threadIdx.x < kPbDzThreads;
#pragma unroll 1
      for (int q = 0; q < kR / 8; ++q) {
        if (fma_rows) {
#pragma unroll
          for (int kk = 8 * q; kk < 8 * q + 8; ++kk) {
            const float4 a0 =
                *reinterpret_cast<const float4*>(hs + kk * kPbDwRows + ar);
            const float4 a1 = *reinterpret_cast<const float4*>(
                hs + kk * kPbDwRows + ar + 16);
            float bv[12];
#pragma unroll
            for (int s = 0; s < 3; ++s) {
              const float4 b = *reinterpret_cast<const float4*>(
                  z + kk * kPbDwCols + bc + 32 * s);
              bv[4 * s] = b.x;
              bv[4 * s + 1] = b.y;
              bv[4 * s + 2] = b.z;
              bv[4 * s + 3] = b.w;
            }
            const float av[8] = {a0.x, a0.y, a0.z, a0.w,
                                 a1.x, a1.y, a1.z, a1.w};
#pragma unroll
            for (int a = 0; a < 8; ++a)
#pragma unroll
              for (int b = 0; b < 12; ++b)
                accf[a][b] = fmaf(av[a], bv[b], accf[a][b]);
          }
        }
        if (next) form(i + 1, st1, zs1, q);
      }
    }
  }
  static_assert(kPbDwRows * (kPbDwCols + 4) * 4 <= kPbDwStages * G::kStage,
                "dW's staging tile fits the ring");
  // dW's partial tile through shared memory (the ring, free by now), then
  // stored row by row, a warp's stores 32 consecutive floats: rows of S
  // floats are rarely 16-byte aligned, and the accumulators of a warp
  // scatter over 8 or 16 rows
  constexpr int kLd = kPbDwCols + 4;
  float* tile = reinterpret_cast<float*>(ring);  // [kPbDwRows, kLd]
  if constexpr (is_bf16<T>) {
    wg_wait<0>();
    fence_chunks<kNch>(acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring
  if constexpr (is_bf16<T>) {
    if (mma) {
      // register 4 j + q of a chunk: row lane / 4 + 8 (q / 2) of the
      // warp's 16, column 8 j + 2 (lane % 4) + q % 2
      const int mr = wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
      for (int c = 0; c < kNch; ++c)
#pragma unroll
        for (int i = 0; i < 32; i += 2)
          *reinterpret_cast<float2*>(
              tile + (mr + 8 * ((i % 4) / 2)) * kLd + 64 * c + 8 * (i / 4) +
              2 * (lane % 4)) = make_float2(acc[c][i], acc[c][i + 1]);
    }
  } else if (fma_rows) {
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int s = 0; s < 3; ++s)
        *reinterpret_cast<float4*>(tile + (ar + (a / 4) * 16 + a % 4) * kLd +
                                   bc + 32 * s) =
            make_float4(accf[a][4 * s], accf[a][4 * s + 1],
                        accf[a][4 * s + 2], accf[a][4 * s + 3]);
  }
  __syncthreads();
  float* out = part + split * L;
  const int rows = min(kPbDwRows, P - mp0), cols = min(kPbDwCols, S - n0);
  for (int r = warp; r < rows; r += kPbThreads / 32)
    for (int c = lane; c < cols; c += 32)
      out[static_cast<long long>(mp0 + r) * S + n0 + c] = tile[r * kLd + c];
  if (first) {  // db's partial: the row groups' column sums, in order
    __syncthreads();  // every thread is done with the tile
    float* red = reinterpret_cast<float*>(ring);  // [8, kPbDwCols]
    if (threadIdx.x < kPbDzThreads)
#pragma unroll
      for (int e = 0; e < 8; ++e) red[zg * kPbDwCols + 8 * zj + e] = db[e];
    __syncthreads();
    if (threadIdx.x < kPbDwCols && n0 + threadIdx.x < S) {
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < 8; ++q) s += red[q * kPbDwCols + threadIdx.x];
      part[split * L + static_cast<long long>(P) * S + n0 + threadIdx.x] = s;
    }
  }
}

template <typename T, int kNch, int kMode>
cudaError_t ce_fwd_launch(const void* h, const void* w, const float* b,
                          const int* tc, void* p_out, float* part_loss,
                          int* part_cnt, int nblk, int N, int P, int S,
                          float bias_mult, cudaStream_t stream) {
  auto kernel = ce_fwd_kernel<T, kNch, kMode>;
  const int smem = kMode == kCeResident ? ce_resident_bytes(P, kNch)
                                        : ce_smem_bytes(S, is_bf16<T>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int grid = nblk;
  if (kMode == kCeResident) {  // as many blocks as fit the card at once
    int dev = 0, sms = 0, per = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, kernel, ce_threads<T, kNch, kMode>(), smem);
    if (err != cudaSuccess) return err;
    const int wgs = ce_wgs<kNch>();  // tiles at once
    grid = min((nblk + wgs - 1) / wgs, sms * (per > 0 ? per : 1));
  }
  kernel<<<grid, ce_threads<T, kNch, kMode>(), smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), b, tc,
      static_cast<T*>(p_out), part_loss, part_cnt, N, P, S, bias_mult);
  return cudaGetLastError();
}

// the bf16 body for S <= 256 classes: W resident where h's rows allow
// 4-byte copies and W with two tiles of h fits the block's shared memory
template <typename T, int kNch>
cudaError_t ce_fwd_chunks(const void* h, const void* w, const float* b,
                          const int* tc, void* p_out, float* part_loss,
                          int* part_cnt, int nblk, int N, int P, int S,
                          float bias_mult, cudaStream_t stream) {
  if constexpr (is_bf16<T>) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    if ((reinterpret_cast<unsigned long long>(h) | 2ull * P) % 4 == 0 &&
        ce_resident_bytes(P, kNch) + kCeStaticBytes <= optin)
      return ce_fwd_launch<T, kNch, kCeResident>(h, w, b, tc, p_out,
                                                 part_loss, part_cnt, nblk,
                                                 N, P, S, bias_mult, stream);
  }
  return ce_fwd_launch<T, kNch, kCeStream>(h, w, b, tc, p_out, part_loss,
                                           part_cnt, nblk, N, P, S,
                                           bias_mult, stream);
}

template <typename T>
cudaError_t ce_fwd(const void* h, const void* w, const float* b,
                   const int* tc, void* p_out, float* part_loss,
                   int* part_cnt, float* loss, int* cnt, int N, int P, int S,
                   float bias_mult, cudaStream_t stream) {
  const int nblk = (N + kCeRows - 1) / kCeRows;
  cudaError_t err;
  switch (S > kCeMaxChunks * kCeChunk ? 0 : (S + kCeChunk - 1) / kCeChunk) {
    case 0:
      err = ce_fwd_launch<T, kCeWideChunks, kCeWide>(
          h, w, b, tc, p_out, part_loss, part_cnt, nblk, N, P, S, bias_mult,
          stream);
      break;
    case 1:
      err = ce_fwd_chunks<T, 1>(h, w, b, tc, p_out, part_loss, part_cnt,
                                nblk, N, P, S, bias_mult, stream);
      break;
    case 2:
      err = ce_fwd_chunks<T, 2>(h, w, b, tc, p_out, part_loss, part_cnt,
                                nblk, N, P, S, bias_mult, stream);
      break;
    case 3:
      err = ce_fwd_chunks<T, 3>(h, w, b, tc, p_out, part_loss, part_cnt,
                                nblk, N, P, S, bias_mult, stream);
      break;
    default:
      err = ce_fwd_chunks<T, 4>(h, w, b, tc, p_out, part_loss, part_cnt,
                                nblk, N, P, S, bias_mult, stream);
  }
  if (err != cudaSuccess) return err;
  return launch_ce_reduce(part_loss, part_cnt, nblk, loss, cnt, stream);
}

template <typename T, int kNch, bool kHWords>
cudaError_t pb_dw_launch(dim3 grid, const void* p, const void* h,
                         const float4* rowc, const float* g, float* part,
                         float* dz_out, int N, int P, int S, int ntiles,
                         int tps, cudaStream_t stream) {
  auto kernel = pb_dw_kernel<T, kNch, kHWords>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PbDw<T>::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kPbThreads, PbDw<T>::kSmem, stream>>>(
      static_cast<const T*>(p), static_cast<const T*>(h), rowc, g, part,
      dz_out, N, P, S, ntiles, tps);
  return cudaGetLastError();
}

// the bf16 body's 64-column chunks: ceil(S / 64) up to three (the f32 body
// has one instance)
template <typename T, bool kHWords>
cudaError_t pb_dw_chunks(dim3 grid, const void* p, const void* h,
                         const float4* rowc, const float* g, float* part,
                         float* dz_out, int N, int P, int S, int ntiles,
                         int tps, cudaStream_t stream) {
  if constexpr (is_bf16<T>) {
    if (S <= 64)
      return pb_dw_launch<T, 1, kHWords>(grid, p, h, rowc, g, part, dz_out,
                                         N, P, S, ntiles, tps, stream);
    if (S <= 128)
      return pb_dw_launch<T, 2, kHWords>(grid, p, h, rowc, g, part, dz_out,
                                         N, P, S, ntiles, tps, stream);
  }
  return pb_dw_launch<T, 3, kHWords>(grid, p, h, rowc, g, part, dz_out, N, P,
                                     S, ntiles, tps, stream);
}

// dh: the resident body where W's block of columns fits (S <= 192), one
// persistent block an SM; else the streamed one, a block a tile
template <typename T>
cudaError_t pb_dh(const void* p, const float4* rc, const void* wp,
                  const float* g, void* dh, int N, int P, int S, int pp,
                  int sp, cudaStream_t stream) {
  using R = PbRes<T>;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int ntiles = (N + kPbRows - 1) / kPbRows;
  if (S <= kPbResMax && R::smem(sp) <= optin) {
    const int pcs = (P + R::kCols - 1) / R::kCols;
    int per = sms / pcs;
    per = per < 1 ? 1 : (per > ntiles ? ntiles : per);
    err = cudaFuncSetAttribute(pb_dh_res_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               R::smem(sp));
    if (err != cudaSuccess) return err;
    pb_dh_res_kernel<T><<<dim3(per, pcs), kPbThreads, R::smem(sp), stream>>>(
        static_cast<const T*>(p), rc, static_cast<const T*>(wp), g,
        static_cast<T*>(dh), N, P, S, pp, sp);
    return cudaGetLastError();
  }
  using D = PbDh<T>;
  err = cudaFuncSetAttribute(pb_dh_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             D::kSmem);
  if (err != cudaSuccess) return err;
  pb_dh_kernel<T><<<dim3(ntiles, pp / kPbDhCols), kPbThreads, D::kSmem,
                    stream>>>(static_cast<const T*>(p), rc,
                              static_cast<const T*>(wp), g,
                              static_cast<T*>(dh), N, P, S, pp, sp);
  return cudaGetLastError();
}

// K3b: four launches (prep; dh; dW and db partials; their sum)
template <typename T>
cudaError_t ce_bwd(const void* p, const void* h, const void* w,
                   const int* tc, const float* g, float* rowc, void* wp,
                   float* part, void* dh, float* out, float* dz_out, int N,
                   int P, int S, int nsplit, float bias_mult,
                   cudaStream_t stream) {
  using D = PbDh<T>;
  using W = PbDw<T>;
  const int pp = (P + kPbDhCols - 1) / kPbDhCols * kPbDhCols;
  const int sp = (S + D::kK - 1) / D::kK * D::kK;
  const int ntiles = (N + W::kRows - 1) / W::kRows;
  if (nsplit < 1 || nsplit > ntiles) return cudaErrorInvalidValue;
  const int tps = (ntiles + nsplit - 1) / nsplit;
  if ((ntiles + tps - 1) / tps != nsplit)  // a split without rows
    return cudaErrorInvalidValue;
  // p's chunks by 16-byte copies, h's rows by 4-byte ones
  if (reinterpret_cast<unsigned long long>(p) % 16 ||
      reinterpret_cast<unsigned long long>(h) % 4)
    return cudaErrorMisalignedAddress;
  const long long work = static_cast<long long>(pp) * sp > N
                             ? static_cast<long long>(pp) * sp
                             : N;
  const long long blocks = (work + 255) / 256;
  pb_prep_kernel<T><<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256,
                      0, stream>>>(
      static_cast<const T*>(p), tc, static_cast<const T*>(w), N, P, S,
      reinterpret_cast<float4*>(rowc), static_cast<T*>(wp), pp, sp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float4* rc = reinterpret_cast<const float4*>(rowc);
  err = pb_dh<T>(p, rc, wp, g, dh, N, P, S, pp, sp, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kPbDwCols - 1) / kPbDwCols, nsplit,
                  (P + kPbDwRows - 1) / kPbDwRows);
  if constexpr (is_bf16<T>)
    err = P % 2 == 0 ? pb_dw_chunks<T, true>(grid, p, h, rc, g, part, dz_out,
                                             N, P, S, ntiles, tps, stream)
                     : pb_dw_chunks<T, false>(grid, p, h, rc, g, part, dz_out,
                                              N, P, S, ntiles, tps, stream);
  else
    err = pb_dw_chunks<T, true>(grid, p, h, rc, g, part, dz_out, N, P, S,
                                ntiles, tps, stream);
  if (err != cudaSuccess) return err;
  const long long L = static_cast<long long>(P) * S + S;
  return launch_sum_partials(part, nsplit, L, out, L,
                             static_cast<long long>(P) * S, bias_mult,
                             stream);
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

// Backward (K3b). p [N, S] (16-byte aligned), h [N, P] (4-byte aligned)
// and w [P, S] in the storage dtype (bf16 = 1: bf16, else f32); tc [N]
// int32; g [1] f32 (the loss cotangent). Outputs: dh [N, P] (as p); out
// [P * S + S] f32, dW [P, S] then db [S] (times bias_mult). nsplit: the
// dW kernel's row splits, 1 .. row tiles with none empty (ops/softmax_ce.py
// proj_bwd_plan). Scratch: rowc [N, 4] f32, wp [pp * sp] (as p; pp = P
// rounded up to 256, sp = S rounded up to 64 in bf16, 32 in f32), part
// [nsplit, P * S + S] f32. dz_out: null, or [N, S] f32 to receive dz
// before its rounding (a test's view of what never leaves the chip).
int softmax_ce_bwd(const void* p, const void* h, const void* w,
                   const int* tc, const float* g, float* rowc, void* wp,
                   float* part, void* dh, float* out, float* dz_out, int N,
                   int P, int S, int nsplit, float bias_mult, int bf16,
                   int device, cudaStream_t stream) {
  if (N < 1 || P < 1 || S < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bf16)
    return ce_bwd<__nv_bfloat16>(p, h, w, tc, g, rowc, wp, part, dh, out,
                                 dz_out, N, P, S, nsplit, bias_mult, stream);
  return ce_bwd<float>(p, h, w, tc, g, rowc, wp, part, dh, out, dz_out, N, P,
                       S, nsplit, bias_mult, stream);
}

}  // extern "C"
