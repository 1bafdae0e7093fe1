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
//    recurrence is later work. Under --f32_matmul 3x (f32, x3 = 1) it
//    runs in the engine's 3x instance (gemm3x_kernel: three bf16 passes
//    on the tensor cores, the TPU kernel's _kdot(use3) at :227); the
//    recurrence's h . W_rec stays exact FP32 (the TPU kernel splits it
//    too, :242): a latency-bound step gains nothing from three passes,
//    and exact f32 lies inside the 3x mode's error.
// 2. rec_kernel, the recurrence, on thread-block clusters
//    (recurrence.cuh): grid (n, ceil(B / 8), D), one cluster of n CTAs
//    per direction and group of 8 rows, a time loop inside each CTA. It
//    is latency-bound: T steps depend on each other, and a step is a
//    [8, H] x [H, 4H] product per cluster. CTA i owns the cells J_i and
//    keeps their 4|J_i| gate columns of W_rec[d] in shared memory for the
//    whole loop (f32 at H = 125 and n = 8: 35 KB a CTA; the old design
//    re-read all 250 KB from L2 every step). A step: each group of 8
//    lanes sums one cell's four gate columns over its k slice for the 8
//    rows (h from the step's parity buffer, 16-byte reads free of bank
//    conflicts), a reduce-scatter of shuffles leaves lane r with row r's
//    four gate sums, lane r adds a[t] (prefetched a step ahead into
//    registers) and runs the cell of (row r, its cell) with c in a
//    register, then the group's h (8 rows, rounded to the storage dtype)
//    goes into the other parity buffer of every CTA of the cluster as
//    16-byte DSMEM stores, and the CTAs meet at one cluster barrier, the
//    step's global stores (h, the residuals) issued between its arrive
//    and its wait. f32 runs true f32 FMAs on the SIMT pipes. bf16 runs the
//    product on the tensor cores: each warp's 16 gate columns (its 4 cells
//    x 4 gates) x 8 rows as mma.sync m16n8k16 (bf16 in, f32 accumulate),
//    W's A fragments staged once in shared memory in fragment order, h
//    read as bf16 pairs (exact: h is stored rounded), and 8 shuffles take
//    each lane its (row, cell)'s four gates. (bf16 whose slice does not
//    fit reads W from L2 in the f32 body.) Each cluster
//    stops at the longest row of its group (every CTA reads the same
//    lengths, so all agree on it): later steps are padding for all its
//    rows and are written as zeros.
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
//    f32: a cluster of 16 holds it, 66 KB a CTA.
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
#include <cuda_runtime.h>

#include <cstddef>

#include "gemm.cuh"
#include "recurrence.cuh"

namespace {

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

// The recurrence, shared by rec_kernel, rec_carry_kernel and
// rec_carry_save_kernel: one CTA of a cluster (see item 2 and
// recurrence.cuh). a [D, T, B, 4H] f32, w_rec [D, H, 4H], peep [D, 3, H],
// out [T, B, D*H].
// kWShared: the CTA's gate columns of W_rec[d] are staged in shared
// memory; otherwise each step reads them from L2 (a slice that does not
// fit: f32 at H = 512).
// kSave: also write the residuals c_out [D, T, B, H] and g_out
// [D, T, B, 4H] (zero at padding).
// kCarry: start from ca.h0/ca.c0, mask per step, write ca.hf/ca.cf, and
// run every step (see item 3); with kSave too, the K6b forward. Each
// variant is an entry point of its own (rec_carry_kernel,
// rec_carry_save_kernel), so that the others compile without the carry's
// operands; every variant runs the same product in the same order, so
// the carry kernels from zero state give K0's and K1's bits.
template <typename W, typename Out, bool kPlainActs, bool kWShared,
          bool kSave, bool kCarry>
__device__ __forceinline__ void rec_body(
    const float* __restrict__ a, const W* __restrict__ w_rec,
    const float* __restrict__ peep, const int* __restrict__ lengths,
    Out* __restrict__ out, float* __restrict__ c_out,
    Out* __restrict__ g_out, int T, int B, int H, const CarryArgs& ca) {
  extern __shared__ __align__(16) float smem[];
  // bf16 with W_rec's slice on chip runs the product on the tensor cores
  constexpr bool kMma = std::is_same<W, __nv_bfloat16>::value && kWShared;
  const RecPlan P = rec_plan(H, sizeof(W), false);
  const int G = 4 * H;
  const int rank = blockIdx.x;  // the CTA's rank in its cluster (n x 1 x 1)
  const int b0 = blockIdx.y * kRecRows;
  const int d = blockIdx.z;
  const int D = gridDim.z;
  const int nb = min(kRecRows, B - b0);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const size_t DH = static_cast<size_t>(D) * H;
  const bool desc = d + (kCarry ? ca.dir_offset : 0) != 0;
  const bool use_mask = kCarry && ca.mask != nullptr;
  int j0, nj;
  rec_slice(H, P.n, rank, j0, nj);
  // lane roles: a group of kLanesPerCell lanes per cell, lane ks of the
  // group owning row ks in the cell phase (in the SIMT product it sums
  // k = ks, ks + 8, ... of the group's cell; the tensor-core product is
  // the warp's)
  const int lane = tid & 31;
  const int ks = lane & (kLanesPerCell - 1);
  const int jl = (tid >> 5) * kCellsPerWarp + (lane >> 3);
  const int j = j0 + jl;
  const int r = ks;
  const bool active = jl < nj && r < nb;  // owns a real (row, cell)

  float* hbuf = smem;  // [2][P.op] h of the step's parity, k-major
  W* ws = reinterpret_cast<W*>(smem + 2 * P.op);  // [cpad][P.ws][4]
  for (size_t i = tid; i < 2 * P.op; i += nthreads) hbuf[i] = 0.0f;
  const W* wd = w_rec + static_cast<size_t>(d) * H * G;
  const int cpad = round_up(P.cmax, kCellsPerWarp);
  const int KT = P.kp / 16;  // k steps of the tensor-core product
  uint4* wf = reinterpret_cast<uint4*>(ws);  // [cpad / 4][KT][32] (kMma)
  if constexpr (kMma) {
    // the warp's A fragments of mma m16n8k16, lane by lane: A[m][k] =
    // W_rec[k][gate m / 4 of its cell m % 4], zero past H and for the
    // padding cells
    auto wv = [&](int w, int m, int k) {
      const int cell = w * kCellsPerWarp + (m & 3);
      return cell < nj && k < H
                 ? wd[static_cast<size_t>(k) * G + (m >> 2) * H + j0 + cell]
                 : f32_to<W>(0.0f);
    };
    auto pair = [&](int w, int m, int k) {
      const __nv_bfloat162 v = __halves2bfloat162(wv(w, m, k),
                                                  wv(w, m, k + 1));
      return *reinterpret_cast<const unsigned*>(&v);
    };
    for (int i = tid; i < cpad / kCellsPerWarp * KT * 32; i += nthreads) {
      const int ln = i & 31, kt = (i >> 5) % KT, w = (i >> 5) / KT;
      const int m = ln >> 2, k = kt * 16 + 2 * (ln & 3);
      wf[i] = make_uint4(pair(w, m, k), pair(w, m + 8, k),
                         pair(w, m, k + 8), pair(w, m + 8, k + 8));
    }
  } else if (kWShared) {
    // the slice's 4 gate columns per cell, k-major per cell; zero past H
    // and for the rows of the padding cells
    for (int i = tid; i < cpad * P.ws; i += nthreads) {
      const int k = i / cpad, c = i - k * cpad;
      W* dst = ws + (static_cast<size_t>(c) * P.ws + k) * 4;
#pragma unroll
      for (int gi = 0; gi < 4; ++gi)
        dst[gi] = c < nj && k < H
                      ? wd[static_cast<size_t>(k) * G + gi * H + j0 + c]
                      : f32_to<W>(0.0f);
    }
  }
  __syncthreads();
  if constexpr (kCarry) {
    // every CTA holds the whole h: h0 of all cells, rounded to the storage
    // dtype as the product reads the fed-back h
    for (int i = tid; i < H * nb; i += nthreads) {
      const int k = i / nb, rr = i - k * nb;
      hbuf[op_off(k) + rr] = as_f32(f32_to<Out>(
          ca.h0[(static_cast<size_t>(d) * B + b0 + rr) * H + k]));
    }
  }
  int tmax_rows = 0, len_r = 0;
  for (int rr = 0; rr < nb; ++rr) {
    const int len = min(max(lengths[b0 + rr], 0), T);
    tmax_rows = max(tmax_rows, len);
    if (rr == r) len_r = len;
  }
  const int tmax = kCarry ? T : tmax_rows;
  // the step whose state is the final one (kCarry)
  const int s_cap = desc ? T - 1 : ca.carry_t - 1;
  float p_ig = 0.0f, p_fg = 0.0f, p_og = 0.0f, c = 0.0f;
  if (jl < nj) {
    const float* pd = peep + static_cast<size_t>(d) * 3 * H + j;
    p_ig = pd[0];
    p_fg = pd[H];
    p_og = pd[2 * H];
    if (kCarry && r < nb)
      c = ca.c0[(static_cast<size_t>(d) * B + b0 + r) * H + j];
  }
  // every CTA has started and holds its state before any peer writes it
  cluster_sync();

  // a[t] of (row r, cell j), four gates, and the step's mask: loaded a
  // step ahead into registers
  float an[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  bool mn = false;
  auto load_step = [&](int s) {
    const int t = desc ? tmax - 1 - s : s;
    const float* src =
        a + ((static_cast<size_t>(d) * T + t) * B + b0 + r) * G + j;
#pragma unroll
    for (int gi = 0; gi < 4; ++gi) an[gi] = src[gi * H];
    if (use_mask) mn = ca.mask[static_cast<size_t>(b0 + r) * T + t] != 0;
  };
  if (active && tmax > 0) load_step(0);
  const int KI = P.kp / kLanesPerCell;
  const W* wl = ws + static_cast<size_t>(jl) * P.ws * 4;
  // this group's h (8 rows of cell j) in every peer: lane ks stores rows
  // 4 (ks / 4) .. + 3 to the peers ks % 4, ks % 4 + 4, ...
  const unsigned h_dst =
      smem_u32(hbuf + op_off(j) + 4 * (ks >> 2));

  for (int s = 0; s < tmax; ++s) {
    const int t = desc ? tmax - 1 - s : s;
    const float* hs = hbuf + (s & 1) * P.op;
    const float a0 = an[0], a1 = an[1], a2 = an[2], a3 = an[3];
    const bool m_now = mn;
    if (active && s + 1 < tmax) load_step(s + 1);
    float gs[4];  // the product's four gate sums of (row r, cell j)
    if constexpr (kMma) {
      // the warp's 16 gate columns (4 cells x 4 gates, gate-major) x 8
      // rows on the tensor cores, two accumulator chains; B is h in bf16
      // (exact: h is stored rounded), read from the f32 buffer
      const uint4* wfl = wf + static_cast<size_t>(tid >> 5) * KT * 32 + lane;
      const float* hb = hs + op_off(2 * (lane & 3)) + (lane >> 2);
      float d0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float d1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int kt = 0; kt < KT; kt += 2) {
        const float* hk = hb + kt * 4 * kQuadFloats;
        mma_bf16(d0, wfl[kt * 32], pack_bf16(hk[0], hk[kRecRows]),
                 pack_bf16(hk[2 * kQuadFloats],
                           hk[2 * kQuadFloats + kRecRows]));
        if (kt + 1 < KT) {
          const float* hk1 = hk + 4 * kQuadFloats;
          mma_bf16(d1, wfl[(kt + 1) * 32], pack_bf16(hk1[0], hk1[kRecRows]),
                   pack_bf16(hk1[2 * kQuadFloats],
                             hk1[2 * kQuadFloats + kRecRows]));
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) d0[i] += d1[i];
      // lane L holds gates L / 16 and L / 16 + 2 of cell (L / 4) % 4 for
      // rows 2 (L % 4) and + 1: gather row r's four gates of cell
      // lane / 8 into this lane
      const int s0 = (lane >> 3) * 4 + (r >> 1), s1 = s0 + 16;
      const bool odd = (r & 1) != 0;
      const float e0 = __shfl_sync(kFull, d0[0], s0);
      const float o0 = __shfl_sync(kFull, d0[1], s0);
      const float e2 = __shfl_sync(kFull, d0[2], s0);
      const float o2 = __shfl_sync(kFull, d0[3], s0);
      const float e1 = __shfl_sync(kFull, d0[0], s1);
      const float o1 = __shfl_sync(kFull, d0[1], s1);
      const float e3 = __shfl_sync(kFull, d0[2], s1);
      const float o3 = __shfl_sync(kFull, d0[3], s1);
      gs[0] = odd ? o0 : e0;
      gs[1] = odd ? o1 : e1;
      gs[2] = odd ? o2 : e2;
      gs[3] = odd ? o3 : e3;
    } else {
      // h . W_rec over k = ks, ks + 8, ...: four gates of cell j, 8 rows
      float acc[kRecRows * 4];
#pragma unroll
      for (int i = 0; i < kRecRows * 4; ++i) acc[i] = 0.0f;
#pragma unroll 4
      for (int i = 0; i < KI; ++i) {
        const int k = ks + kLanesPerCell * i;
        float4 w4;
        if (kWShared) {
          w4 = load4(wl + static_cast<size_t>(k) * 4);
        } else {
          const bool ok = jl < nj && k < H;
          const W* wk = wd + static_cast<size_t>(k) * G + j;
          w4 = ok ? make_float4(as_f32(wk[0]), as_f32(wk[H]),
                                as_f32(wk[2 * H]), as_f32(wk[3 * H]))
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        const float4 hlo = *reinterpret_cast<const float4*>(hs + op_off(k));
        const float4 hhi =
            *reinterpret_cast<const float4*>(hs + op_off(k) + 4);
        const float hr[kRecRows] = {hlo.x, hlo.y, hlo.z, hlo.w,
                                    hhi.x, hhi.y, hhi.z, hhi.w};
#pragma unroll
        for (int rr = 0; rr < kRecRows; ++rr) {
          acc[rr * 4 + 0] = fmaf(hr[rr], w4.x, acc[rr * 4 + 0]);
          acc[rr * 4 + 1] = fmaf(hr[rr], w4.y, acc[rr * 4 + 1]);
          acc[rr * 4 + 2] = fmaf(hr[rr], w4.z, acc[rr * 4 + 2]);
          acc[rr * 4 + 3] = fmaf(hr[rr], w4.w, acc[rr * 4 + 3]);
        }
      }
      // reduce-scatter over the group: lane ks keeps row ks's four gates
      fold_half<16>(acc, 4, (ks & 4) != 0);
      fold_half<8>(acc, 2, (ks & 2) != 0);
      fold_half<4>(acc, 1, (ks & 1) != 0);
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) gs[gi] = acc[gi];
    }
    const float g0 = a0 + gs[0], g1 = a1 + gs[1], g2 = a2 + gs[2],
                g3 = a3 + gs[3];
    const float c_prev = c;
    float ni, ig, fg, og, c_new, h_new;
    if (kPlainActs) {
      ni = tanhf(g0);
      ig = sigmoid_plain(g1 + c_prev * p_ig);
      fg = sigmoid_plain(g2 + c_prev * p_fg);
      c_new = ni * ig + fg * c_prev;
      og = sigmoid_plain(g3 + c_new * p_og);  // the NEW-c peephole
      h_new = tanhf(c_new) * og;
    } else {
      ni = tanh2_exact(g0);
      ig = logistic_exact(g1 + c_prev * p_ig);
      fg = logistic_exact(g2 + c_prev * p_fg);
      c_new = ni * ig + fg * c_prev;
      og = logistic_exact(g3 + c_new * p_og);
      h_new = tanh2_exact(c_new) * og;
    }
    const bool valid = active && (use_mask ? m_now : t < len_r);
    const Out hv = f32_to<Out>(valid ? h_new : 0.0f);
    c = valid ? c_new : 0.0f;
    // the group's 8 rows of h as two float4s, then into every peer's
    // buffer of the next parity (rows past nb are zero)
    const float hf32 = as_f32(hv);
    const int src0 = (lane & ~(kLanesPerCell - 1)) | (ks & 4);
    const float4 q = make_float4(__shfl_sync(kFull, hf32, src0),
                                 __shfl_sync(kFull, hf32, src0 + 1),
                                 __shfl_sync(kFull, hf32, src0 + 2),
                                 __shfl_sync(kFull, hf32, src0 + 3));
    if (jl < nj) {
      const unsigned dst =
          h_dst + static_cast<unsigned>(((s + 1) & 1) * P.op * sizeof(float));
      for (int p = ks & 3; p < P.n; p += 4) st_peer(peer_addr(dst, p), q);
    }
    cluster_arrive();
    if (active) {
      out[(static_cast<size_t>(t) * B + b0 + r) * DH +
          static_cast<size_t>(d) * H + j] = hv;
      if (kCarry && s == s_cap) {
        const size_t dst = (static_cast<size_t>(d) * B + b0 + r) * H + j;
        ca.hf[dst] = valid ? h_new : 0.0f;  // unrounded, as the TPU kernel
        ca.cf[dst] = c;
      }
      if (kSave) {
        const size_t row = (static_cast<size_t>(d) * T + t) * B + b0 + r;
        c_out[row * H + j] = c;
        Out* gr = g_out + row * G + j;
        gr[0] = f32_to<Out>(valid ? ni : 0.0f);
        gr[H] = f32_to<Out>(valid ? ig : 0.0f);
        gr[2 * H] = f32_to<Out>(valid ? fg : 0.0f);
        gr[3 * H] = f32_to<Out>(valid ? og : 0.0f);
      }
    }
    // the peers' h of this step has landed; every CTA is past its reads
    // of this step's buffer. After the last step no peer touches this
    // CTA's shared memory again, so it may exit.
    cluster_wait();
  }
  // steps past the cluster's longest row are padding for all its rows
  if (active) {
    for (int t = tmax; t < T; ++t) {
      out[(static_cast<size_t>(t) * B + b0 + r) * DH +
          static_cast<size_t>(d) * H + j] = f32_to<Out>(0.0f);
      if (kSave) {
        const size_t row = (static_cast<size_t>(d) * T + t) * B + b0 + r;
        c_out[row * H + j] = 0.0f;
        for (int gi = 0; gi < 4; ++gi)
          g_out[row * G + gi * H + j] = f32_to<Out>(0.0f);
      }
    }
  }
}

template <typename W, typename Out, bool kPlainActs, bool kWShared,
          bool kSave>
__global__ void __launch_bounds__(kRecMaxThreads)
    rec_kernel(const float* __restrict__ a, const W* __restrict__ w_rec,
               const float* __restrict__ peep,
               const int* __restrict__ lengths, Out* __restrict__ out,
               float* __restrict__ c_out, Out* __restrict__ g_out, int T,
               int B, int H) {
  rec_body<W, Out, kPlainActs, kWShared, kSave, false>(
      a, w_rec, peep, lengths, out, c_out, g_out, T, B, H, CarryArgs{});
}

template <typename W, typename Out, bool kPlainActs, bool kWShared>
__global__ void __launch_bounds__(kRecMaxThreads)
    rec_carry_kernel(const float* __restrict__ a,
                     const W* __restrict__ w_rec,
                     const float* __restrict__ peep,
                     const int* __restrict__ lengths, Out* __restrict__ out,
                     int T, int B, int H, CarryArgs ca) {
  rec_body<W, Out, kPlainActs, kWShared, false, true>(
      a, w_rec, peep, lengths, out, nullptr, nullptr, T, B, H, ca);
}

template <typename W, typename Out, bool kPlainActs, bool kWShared>
__global__ void __launch_bounds__(kRecMaxThreads)
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

// One variant on its route: grid (n, ceil(B / 8), D). query: the plan's
// clusters the card holds at once into *active, no launch.
template <typename W, typename Out, bool kPlainActs, bool kWShared,
          bool kSave, bool kCarry>
cudaError_t launch_rec(const RecPlan& p, size_t smem, const float* a,
                       const void* w_rec, const float* peep,
                       const int* lengths, void* out, float* c_out,
                       void* g_out, int T, int B, int H, int D,
                       const CarryArgs& ca, int* active, bool query,
                       cudaStream_t stream) {
  const dim3 grid(p.n, (B + kRecRows - 1) / kRecRows, D);
  const W* w = static_cast<const W*>(w_rec);
  Out* o = static_cast<Out*>(out);
  Out* g = static_cast<Out*>(g_out);
  if constexpr (kCarry && kSave)
    return launch_cluster(
        rec_carry_save_kernel<W, Out, kPlainActs, kWShared>, p, smem, grid,
        stream, active, query, a, w, peep, lengths, o, c_out, g, T, B, H,
        ca);
  else if constexpr (kCarry)
    return launch_cluster(rec_carry_kernel<W, Out, kPlainActs, kWShared>, p,
                          smem, grid, stream, active, query, a, w, peep,
                          lengths, o, T, B, H, ca);
  else
    return launch_cluster(
        rec_kernel<W, Out, kPlainActs, kWShared, kSave>, p, smem, grid,
        stream, active, query, a, w, peep, lengths, o, c_out, g, T, B, H);
}

// The plan's route (rec_route): W_rec's slice in shared memory when it
// fits beside the parity buffers, else from L2.
template <typename W, typename Out, bool kPlainActs, bool kSave,
          bool kCarry>
cudaError_t launch_rec_w(const float* a, const void* w_rec, const float* peep,
                         const int* lengths, void* out, float* c_out,
                         void* g_out, int T, int B, int H, int D,
                         const CarryArgs& ca, int device, int* active,
                         bool query, cudaStream_t stream) {
  const RecPlan p = rec_plan(H, sizeof(W), false);
  size_t smem = 0;
  bool on_chip = false;
  const cudaError_t err = rec_route(p, device, &smem, &on_chip);
  if (err != cudaSuccess) return err;
  if (on_chip)
    return launch_rec<W, Out, kPlainActs, true, kSave, kCarry>(
        p, smem, a, w_rec, peep, lengths, out, c_out, g_out, T, B, H, D, ca,
        active, query, stream);
  return launch_rec<W, Out, kPlainActs, false, kSave, kCarry>(
      p, smem, a, w_rec, peep, lengths, out, c_out, g_out, T, B, H, D, ca,
      active, query, stream);
}

template <bool kSave, bool kCarry>
cudaError_t launch_rec_dtype(const float* a, const void* w_rec,
                             const float* peep, const int* lengths, void* out,
                             float* c_out, void* g_out, int T, int B, int H,
                             int D, const CarryArgs& ca, int bf16, int device,
                             cudaStream_t stream, int* active = nullptr,
                             bool query = false) {
  if (bf16)
    return launch_rec_w<__nv_bfloat16, __nv_bfloat16, true, kSave, kCarry>(
        a, w_rec, peep, lengths, out, c_out, g_out, T, B, H, D, ca, device,
        active, query, stream);
  return launch_rec_w<float, float, false, kSave, kCarry>(
      a, w_rec, peep, lengths, out, c_out, g_out, T, B, H, D, ca, device,
      active, query, stream);
}

// The activations as the recurrences compute them, for a card test that
// holds __frcp_rn against the IEEE division bit for bit: out [4, n] =
// sigmoid_plain(x), 1 / (1 + expf(-x)), logistic_exact(x) and the same
// saturation with the division.
__global__ void act_probe_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = x[i];
  out[i] = sigmoid_plain(v);
  out[n + i] = 1.0f / (1.0f + expf(-v));
  out[2 * n + i] = logistic_exact(v);
  out[3 * n + i] = v >= kExpLimit    ? 1.0f
                   : v <= -kExpLimit ? 0.0f
                                     : 1.0f / (1.0f + expf(-v));
}

// a[d] = x . w[d] + bias_mult * bias[d] for each direction d, in gemm.cuh's
// GEMM (output d takes pair d; x is shared), the bias in the epilogue
template <typename T>
cudaError_t launch_proj(const void* x, const void* w, const float* bias,
                        float* a, int M, int K, int N, int D, float bias_mult,
                        bool x3, cudaStream_t stream) {
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
      g, D, EpiBias<float>{a, bias, bias_mult, static_cast<long long>(M) * N, N},
      stream, x3);
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
// both bf16 (bf16 = 1); bias [D, N] f32; a [D, M, N] f32. x3 = 1 (f32
// only, --f32_matmul 3x): the engine's 3x instance.
int lstm_fwd_proj(const void* x, const void* w, const float* bias, float* a,
                  int M, int K, int N, int D, float bias_mult, int bf16,
                  int x3, int device, cudaStream_t stream) {
  if (M < 1 || K < 1 || N < 1 || D < 1 || D > 2 || (x3 && bf16))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bf16)
    return launch_proj<__nv_bfloat16>(x, w, bias, a, M, K, N, D, bias_mult,
                                      false, stream);
  return launch_proj<float>(x, w, bias, a, M, K, N, D, bias_mult, x3 != 0,
                            stream);
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

// The cluster plan of the forward recurrence at width H (bf16 = 1: bf16
// W_rec), as rec_kernel takes it: info[0] = n, [1] = threads a CTA, [2] =
// dynamic shared memory a CTA (bytes), [3] = 1 if W_rec's slice stays in
// shared memory (0: read from L2), [4] = the clusters the card holds at
// once. Returns the error a launch would (cudaErrorInvalidValue for a
// state that does not fit, cudaErrorInvalidConfiguration for a cluster
// the card cannot hold).
int lstm_fwd_rec_plan(int H, int bf16, int device, int* info) {
  if (H < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const RecPlan p = rec_plan(H, bf16 ? 2 : 4, false);
  size_t smem = 0;
  bool on_chip = false;
  err = rec_route(p, device, &smem, &on_chip);
  if (err != cudaSuccess) return err;
  info[0] = p.n;
  info[1] = p.threads;
  info[2] = static_cast<int>(smem);
  info[3] = on_chip ? 1 : 0;
  return launch_rec_dtype<false, false>(
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, H,
      1, CarryArgs{}, bf16, device, nullptr, &info[4], true);
}

// out [4, n] f32: the activations of x [n] f32 (act_probe_kernel).
int lstm_act_probe(const float* x, float* out, int n, int device,
                   cudaStream_t stream) {
  if (n < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  act_probe_kernel<<<(n + 255) / 256, 256, 0, stream>>>(x, out, n);
  return cudaGetLastError();
}

const char* lstm_err_str(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
