// Backward (BPTT) of one (B)LSTM layer, for NVIDIA Hopper (sm_90a).
//
// Replaces lstm_rnn_tpu/ops/lstm_cell.py::_bwd_kernel in both its variants:
// without carry (the TPU kernel behind lstm_scan_fused's VJP,
// `_fused_bwd`), and with carry=True (K6b backward, `_fused_carry_bwd`,
// the VJP of lstm_scan_fused_carry that sequence parallelism's training
// runs; item 5 below). Each is the reference
// BPTT (ComputeBlockErrorsFn, LstmLayer.cu:190-287) over the gates and cell
// states that the save variant of lstm_fwd.cu wrote, with no gate
// recompute, then the weight gradients (ComputeWeightUpdateFn,
// LstmLayer.cu:289-512) and the preceding layer's error
// (LstmLayer.cu:990-1009). For direction d, BPTT walks its scan in reverse
// (d = 0: t = T-1 .. 0, scan-previous neighbour t-1; d = 1: t = 0 .. T-1,
// neighbour t+1); per step, with da_next the deltas of the step before in
// BPTT order (zero at the start):
//
//   e        = dh[t] + da_next . W_rec^T
//   og_delta = og (1 - og) tanh(c) e                        (unclipped)
//   cs_err   = og (1 - tanh(c)^2) e + p_og og_delta + fg_next cs_err_next
//              + p_ig da_next[ig] + p_fg da_next[fg]
//   ni_d = ig (1 - ni^2) cs_err,  ig_d = ig (1 - ig) ni cs_err,
//   fg_d = fg (1 - fg) c_prev cs_err  (zero at the sequence edge)
//   da   = [ni_d, ig_d, fg_d, og_delta], each clipped to +-1 when `clip`,
//          times the step's validity; cs_err_next = cs_err * m,
//          fg_next = fg * m
//
// and then dW_in[d] = x^T . da[d], dW_rec[d] = h_prev^T . da[d],
// dpeep[d] = [sum c_prev da_ig, sum c_prev da_fg, sum c da_og],
// dbias[d] = bias_mult * sum da[d], dx = sum_d da[d] . W_in[d]^T. c_prev and
// h_prev are zero at the edge (the forward wrote zeros at padding, so a
// padded neighbour reads zero too). float32 mode: true f32, the CURRENNT
// logistic and tanh = 2 logistic(2x) - 1. bfloat16 mode (rounding where the
// JAX kernel rounds): da_next is cast to bf16 before the recurrent product,
// da is stored in bf16 before the weight-gradient products and the
// dpeep/dbias sums, each direction's dx plane is rounded to bf16 before the
// two are summed in f32; tanh is the plain one.
//
// Design and what bounds it on this card. Four launches (five with a
// carry):
//
// 1. bptt_kernel, the recurrence, on thread-block clusters
//    (recurrence.cuh), as lstm_fwd.cu's rec_kernel: grid (n, ceil(B / 8),
//    D), one cluster of n CTAs per direction and group of 8 rows, a time
//    loop inside each CTA. Latency-bound: the steps depend on each other
//    and each is a [8, 4H] x [4H, H] product per cluster. CTA i owns the
//    cells J_i and keeps their rows of W_rec[d] (columns J_i of the
//    transposed copy [D, 4H, Hp] the wrapper passes) in shared memory for
//    the whole loop (f32 at H = 125 and n = 8: 32 KB a CTA; the old design
//    re-read all 250 KB from L2 every step). A step: each warp sums e's
//    product for its four cells and 8 rows over the rounded deltas of the
//    step before (from the step's parity buffer): its 32 lanes split k,
//    each delta read serving four cells, and a reduce-scatter of shuffles
//    leaves lane L with row L % 8 of cell L / 8. Both modes run true f32
//    FMAs on the SIMT pipes, W's rows held in f32 (bf16 W widens exactly).
//    On the tensor cores (mma.sync m16n8k16, the four cells as A's rows)
//    the bf16 BPTT step took 4.31 us against 2.78 on the SIMT pipes at
//    H = 125 on an H100: 32 dependent k steps and the operand's packing
//    outweigh the FMAs saved. Lane r of each group of 8 then runs the
//    cell-error step of (row r, its cell) with cs_err_next, fg_next and
//    its own unrounded ig/fg deltas in registers (its dh, gates, c and c_prev
//    loaded a step ahead), writes da [D, T, B, 4H] in the storage dtype
//    and adds its dpeep/dbias terms in registers; then the group's 4 x 8
//    deltas, rounded to the compute dtype, go into the other parity buffer
//    of every CTA of the cluster as 16-byte DSMEM stores, and the CTAs
//    meet at one cluster barrier. Each cluster stops at the longest row of
//    its group and writes zero deltas after it; at the end each cell's
//    dpeep/dbias terms are summed over its 8 rows (shuffles, a fixed
//    order) into one partial per group ([ceil(B/8), D, 7H]).
// 2. dW_in and dW_rec: gemm.cuh's GEMM (wgmma in bf16, a register-blocked
//    SIMT body in f32) over the T*B rows, split-K into per-split partials,
//    summed in order by sum_partials (the TPU kernel accumulates them
//    chunk by chunk in VMEM; here da makes one round trip through device
//    memory).
// 3. dx = sum_d da[d] . W_in[d]^T, the same GEMM, both directions in one
//    launch (skipped for the first hidden layer, need_dx = 0).
// 4. sum_partials for dpeep/dbias (times bias_mult for dbias).
// --f32_matmul 3x (x3): the products of 2 and 3 run in the engine's 3x
//    instance (f32 as three bf16 passes on the tensor cores, the JAX
//    kernel's _kdot(use3) at :449, :475, :491); the BPTT's step product
//    (da . W_rec^T, and dh0) and edge_grad_kernel stay exact FP32 on the
//    SIMT pipes: a latency-bound step gains nothing from three passes, and
//    exact f32 lies inside the 3x mode's error.
// 5. The carry variant (lstm_bwd_carry): bptt_carry_kernel, bptt_kernel's
//    body with kCarry. The forward started from (h0, c0) and emitted its
//    state at step carry_t - 1 (ascending) or t = 0 (descending; a
//    direction descends when d + dir_offset > 0) as (hf, cf). So: c_prev
//    at the scan edge is c0 and the edge's fg delta is not zeroed; dhf
//    joins e and dcf joins cs_err at the capture step; after the last BPTT
//    step, one more product pass over that step's exchanged deltas gives
//    dh0 = round(da) . W_rec^T, and dc0 = fg_next cs_err_next + p_ig
//    da[ig] + p_fg da[fg] comes from each lane's registers. Every step
//    runs: the longest-row shortcut would leave a descending direction's
//    dh0/dc0 to an unmasked state, where the
//    invalid steps after a row's end are what zero them. dW_rec's h_prev
//    view shifts by the scan direction (dir_offset included) and reads zero
//    before the edge row; edge_grad_kernel then adds the rank-B term
//    h0^T . da[edge] (h0 in the storage dtype, as the TPU kernel rounds it).
//
// Launch rules: the entry point launches on the caller's stream, allocates
// nothing (the wrapper passes every buffer), never synchronises, and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "gemm.cuh"
#include "recurrence.cuh"

namespace {

// The carry variant's operands (unused without kCarry).
struct BpttCarry {
  const float* c0;   // [D, B, H] the forward's initial cell state
  const float* dhf;  // [D, B, H] cotangents of the forward's final state
  const float* dcf;
  float* dh0;        // [D, B, H] gradients of the initial state
  float* dc0;
  int carry_t;       // an ascending direction's final state is at carry_t-1
  int dir_offset;    // direction d walks descending if d + it > 0
};

// One (row, cell) item's inputs at step t: dh, the four gates, c[t],
// c_prev.
struct CellIn {
  float dh, g[4], c, cp;
};

// The BPTT, shared by bptt_kernel and bptt_carry_kernel: one CTA of a
// cluster (see item 1 and recurrence.cuh).
// S: storage dtype (dh, gates, da); W: compute dtype of W_rec^T.
// kPlain: plain tanh (bf16 mode); kWShared: the CTA's rows of W_rec are
// staged in shared memory (otherwise read from L2 every step).
// kCarry: the K6b backward (see item 5): c_prev at the scan edge is ca.c0
// (its fg delta is not zeroed), dhf and dcf join at the capture step,
// every step runs, and dh0/dc0 are written after the last. Each variant
// is an entry point of its own, so that bptt_kernel compiles without the
// carry's operands (lstm_fwd.cu's rec_body does the same).
template <typename S, typename W, bool kPlain, bool kWShared, bool kCarry>
__device__ __forceinline__ void bptt_body(
    const S* __restrict__ dh, const S* __restrict__ gates,
    const float* __restrict__ c, const W* __restrict__ w_rec_t,
    const float* __restrict__ peep, const int* __restrict__ lengths,
    S* __restrict__ da_out, float* __restrict__ pb_part, int T, int B, int H,
    int clip, const BpttCarry& ca) {
  extern __shared__ __align__(16) float smem[];
  const RecPlan P = rec_plan(H, sizeof(W), true);
  const int G = 4 * H;
  const int HP = (H + 3) & ~3;  // the row stride of w_rec_t
  const int rank = blockIdx.x;
  const int blk = blockIdx.y;
  const int b0 = blk * kRecRows;
  const int d = blockIdx.z;
  const int D = gridDim.z;
  const int nb = min(kRecRows, B - b0);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const size_t DH = static_cast<size_t>(D) * H;
  // the direction's scan ascends time (BPTT then walks it descending);
  // without kCarry this is d == 0
  const int dd = d + (kCarry ? ca.dir_offset : 0);
  int j0, nj;
  rec_slice(H, P.n, rank, j0, nj);
  const int lane = tid & 31;
  const int ks = lane & (kLanesPerCell - 1);
  const int jl = (tid >> 5) * kCellsPerWarp + (lane >> 3);
  const int j = j0 + jl;
  const int r = ks;
  const bool active = jl < nj && r < nb;

  float* dbuf = smem;  // [2][P.op] da_next rounded to W, k-major over 4H
  // [cpad][P.ws] the CTA's rows of W_rec, in f32 in both modes (bf16 W
  // widens exactly; the product's reads then need no unpacking)
  float* ws = smem + 2 * P.op;
  for (size_t i = tid; i < 2 * P.op; i += nthreads) dbuf[i] = 0.0f;
  const W* wd = w_rec_t + static_cast<size_t>(d) * G * HP;
  if (kWShared) {
    // row j of W_rec = column j of W_rec^T, k contiguous; zero past 4H and
    // for the rows of the padding cells
    const int cpad = round_up(P.cmax, kCellsPerWarp);
    for (int i = tid; i < cpad * P.ws; i += nthreads) {
      const int k = i / cpad, cc = i - k * cpad;
      ws[static_cast<size_t>(cc) * P.ws + k] =
          cc < nj && k < G ? as_f32(wd[static_cast<size_t>(k) * HP + j0 + cc])
                           : 0.0f;
    }
  }
  int tmax_rows = 0, len_r = 0;
  for (int rr = 0; rr < nb; ++rr) {
    const int len = min(max(lengths[b0 + rr], 0), T);
    tmax_rows = max(tmax_rows, len);
    if (rr == r) len_r = len;
  }
  const int tmax = kCarry ? T : tmax_rows;
  // the step whose state the forward emitted as (hf, cf) (kCarry)
  const int t_cap = kCarry && dd == 0 ? ca.carry_t - 1 : 0;
  float p_ig = 0.0f, p_fg = 0.0f, p_og = 0.0f;
  if (jl < nj) {
    const float* pd = peep + static_cast<size_t>(d) * 3 * H + j;
    p_ig = pd[0];
    p_fg = pd[H];
    p_og = pd[2 * H];
  }
  // every CTA has started and zeroed its buffers before any peer writes
  cluster_sync();

  auto load_in = [&](int t) {
    CellIn in;
    const size_t row = (static_cast<size_t>(d) * T + t) * B + b0 + r;
    in.dh = as_f32(dh[(static_cast<size_t>(t) * B + b0 + r) * DH +
                      static_cast<size_t>(d) * H + j]);
#pragma unroll
    for (int gi = 0; gi < 4; ++gi)
      in.g[gi] = as_f32(gates[row * G + gi * H + j]);
    in.c = c[row * H + j];
    const bool edge = dd == 0 ? t <= 0 : t >= T - 1;
    const int tn = dd == 0 ? t - 1 : t + 1;
    const size_t state = (static_cast<size_t>(d) * B + b0 + r) * H + j;
    in.cp = edge ? (kCarry ? ca.c0[state] : 0.0f)
                 : c[((static_cast<size_t>(d) * T + tn) * B + b0 + r) * H +
                     j];
    return in;
  };

  // The product's lanes differ from the cell phase's: the warp's 32
  // lanes split k over its four cells (lane L sums the k quads L, L + 32,
  // ...), so each delta read from shared memory serves four cells, and
  // the reduce-scatter over the warp leaves lane L with row L % 8 of cell
  // L / 8, the cell phase's (row, cell).
  const int KQ = P.kp / (4 * 32);  // k quads a lane sums
  const int jw = (tid >> 5) * kCellsPerWarp;  // the warp's first cell
  // e's product at the parity of pass s: sum over k of da_next[row][k] *
  // W_rec[j][k] for the warp's four cells and eight rows
  auto product = [&](int s) {
    const float* dsrc = dbuf + (s & 1) * P.op;
    float e[kCellsPerWarp * kRecRows];  // [cell][row]
#pragma unroll
    for (int i = 0; i < kCellsPerWarp * kRecRows; ++i) e[i] = 0.0f;
#pragma unroll 2
    for (int i = 0; i < KQ; ++i) {
      const int q = lane + 32 * i;  // quad of k
      float wk[kCellsPerWarp][4];
#pragma unroll
      for (int cw = 0; cw < kCellsPerWarp; ++cw) {
        float4 w4;
        if (kWShared) {
          w4 = load4(ws + static_cast<size_t>(jw + cw) * P.ws + 4 * q);
        } else {
          float wv[4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int k = 4 * q + kk;
            wv[kk] = jw + cw < nj && k < G
                         ? as_f32(wd[static_cast<size_t>(k) * HP + j0 + jw +
                                     cw])
                         : 0.0f;
          }
          w4 = make_float4(wv[0], wv[1], wv[2], wv[3]);
        }
        wk[cw][0] = w4.x;
        wk[cw][1] = w4.y;
        wk[cw][2] = w4.z;
        wk[cw][3] = w4.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* dk = dsrc + q * kQuadFloats + kk * kRecRows;
        const float4 lo = *reinterpret_cast<const float4*>(dk);
        const float4 hi = *reinterpret_cast<const float4*>(dk + 4);
        const float dr8[kRecRows] = {lo.x, lo.y, lo.z, lo.w,
                                     hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int cw = 0; cw < kCellsPerWarp; ++cw)
#pragma unroll
          for (int rr = 0; rr < kRecRows; ++rr)
            e[cw * kRecRows + rr] =
                fmaf(dr8[rr], wk[cw][kk], e[cw * kRecRows + rr]);
      }
    }
    fold_half<16>(e, 16, (lane & 16) != 0);
    fold_half<8>(e, 8, (lane & 8) != 0);
    fold_half<4>(e, 4, (lane & 4) != 0);
    fold_half<2>(e, 2, (lane & 2) != 0);
    fold_half<1>(e, 1, (lane & 1) != 0);
    return e[0];
  };

  // the cell's recurrent state: cs_err_next, fg_next, and this step's
  // unrounded ig/fg deltas (the next step's peephole terms)
  float cse = 0.0f, fgn = 0.0f, da_ig = 0.0f, da_fg = 0.0f;
  // dpeep (ig, fg, og) and dbias (4 gates) terms of (row r, cell j)
  float acc7[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  CellIn nxt = {};
  if (active && tmax > 0) nxt = load_in(dd == 0 ? tmax - 1 : 0);
  // this group's deltas in every peer: lane ks stores rows 4 (ks / 4) ..
  // + 3 of gate ks % 4
  const int gsel = ks & 3;
  const unsigned d_dst =
      smem_u32(dbuf + op_off(gsel * H + j) + 4 * (ks >> 2));
  const int src0 = (lane & ~(kLanesPerCell - 1)) | (ks & 4);

  for (int s = 0; s < tmax; ++s) {
    const int t = dd == 0 ? tmax - 1 - s : s;
    const CellIn in = nxt;
    if (active && s + 1 < tmax) nxt = load_in(dd == 0 ? t - 1 : t + 1);
    float e = in.dh + product(s);
    float dcf = 0.0f;
    if (kCarry && active && t == t_cap) {
      // the final (h, c) are this step's through an identity: their
      // cotangents join e and the cell-state error here
      const size_t src = (static_cast<size_t>(d) * B + b0 + r) * H + j;
      e += ca.dhf[src];
      dcf = ca.dcf[src];
    }
    const float ni = in.g[0], ig = in.g[1], fg = in.g[2], og = in.g[3];
    const float tanh_c = kPlain ? tanhf(in.c) : tanh2_exact(in.c);
    const float og_delta = og * (1.0f - og) * tanh_c * e;
    // the UNCLIPPED og delta feeds the cell-state error; the clipped
    // ig/fg deltas of the step before feed it through the peepholes
    float cs_err = og * (1.0f - tanh_c * tanh_c) * e + p_og * og_delta +
                   fgn * cse + p_ig * da_ig + p_fg * da_fg;
    if (kCarry) cs_err += dcf;
    // with a carry the scan edge has a previous cell state, c0
    const bool edge = !kCarry && (dd == 0 ? t <= 0 : t >= T - 1);
    float dv[4];
    dv[0] = ig * (1.0f - ni * ni) * cs_err;
    dv[1] = ig * (1.0f - ig) * ni * cs_err;
    dv[2] = edge ? 0.0f : fg * (1.0f - fg) * in.cp * cs_err;
    dv[3] = og_delta;
    const float m = active && t < len_r ? 1.0f : 0.0f;
    float dr[4];  // rounded to the compute dtype: the next product's
#pragma unroll
    for (int gi = 0; gi < 4; ++gi) {
      float v = dv[gi];
      if (clip) v = fminf(fmaxf(v, -1.0f), 1.0f);
      v *= m;
      dr[gi] = round_to<W>(v);
      dv[gi] = v;
    }
    da_ig = dv[1];
    da_fg = dv[2];
    cse = cs_err * m;
    fgn = fg * m;
    // the group's deltas, gate gsel and rows 4 (ks / 4) .. + 3 in lane ks,
    // into every peer's buffer of the next parity (rows past nb are zero)
    float qv[4];
#pragma unroll
    for (int mm = 0; mm < 4; ++mm) {
      const float x0 = __shfl_sync(kFull, dr[0], src0 + mm);
      const float x1 = __shfl_sync(kFull, dr[1], src0 + mm);
      const float x2 = __shfl_sync(kFull, dr[2], src0 + mm);
      const float x3 = __shfl_sync(kFull, dr[3], src0 + mm);
      qv[mm] = gsel == 0 ? x0 : gsel == 1 ? x1 : gsel == 2 ? x2 : x3;
    }
    if (jl < nj) {
      const unsigned dst =
          d_dst + static_cast<unsigned>(((s + 1) & 1) * P.op * sizeof(float));
      const float4 q4 = make_float4(qv[0], qv[1], qv[2], qv[3]);
      for (int p = 0; p < P.n; ++p) st_peer(peer_addr(dst, p), q4);
    }
    cluster_arrive();
    if (active) {
      const size_t row = (static_cast<size_t>(d) * T + t) * B + b0 + r;
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) {
        const S st = f32_to<S>(dv[gi]);
        da_out[row * G + gi * H + j] = st;
        acc7[3 + gi] += as_f32(st);  // dbias, from the stored da
        dv[gi] = as_f32(st);
      }
      acc7[0] += in.cp * dv[1];  // dpeep ig: c_prev
      acc7[1] += in.cp * dv[2];  // dpeep fg: c_prev
      acc7[2] += in.c * dv[3];   // dpeep og: c
    }
    // the peers' deltas of this step have landed; after the last step no
    // peer touches this CTA's shared memory again
    cluster_wait();
  }
  if constexpr (kCarry) {
    // after the last step the recurrence's remaining terms are the
    // initial state's gradients: dh0 = round(da) . W_rec^T over the last
    // step's exchanged deltas, and dc0 = the cell-state terms of the
    // virtual step before the scan
    const float v = product(tmax);
    if (active) {
      const size_t dst = (static_cast<size_t>(d) * B + b0 + r) * H + j;
      ca.dh0[dst] = v;
      ca.dc0[dst] = fgn * cse + p_ig * da_ig + p_fg * da_fg;
    }
  }
  // steps past the cluster's longest row: zero deltas for all its rows
  if (active) {
    for (int t = tmax; t < T; ++t) {
      const size_t row = (static_cast<size_t>(d) * T + t) * B + b0 + r;
#pragma unroll
      for (int gi = 0; gi < 4; ++gi)
        da_out[row * G + gi * H + j] = f32_to<S>(0.0f);
    }
  }
  // this group's dpeep/dbias partial: each cell's 8 rows summed in a fixed
  // order (a butterfly of shuffles; rows past nb add zero)
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    float v = acc7[i];
    v += __shfl_xor_sync(kFull, v, 4);
    v += __shfl_xor_sync(kFull, v, 2);
    v += __shfl_xor_sync(kFull, v, 1);
    acc7[i] = v;
  }
  if (jl < nj && ks == 0) {
    float* pb = pb_part + (static_cast<size_t>(blk) * D + d) * 7 * H;
    for (int i = 0; i < 3; ++i) pb[i * H + j] = acc7[i];
    for (int gi = 0; gi < 4; ++gi) pb[3 * H + gi * H + j] = acc7[3 + gi];
  }
}

template <typename S, typename W, bool kPlain, bool kWShared>
__global__ void __launch_bounds__(kRecMaxThreads)
    bptt_kernel(const S* __restrict__ dh, const S* __restrict__ gates,
                const float* __restrict__ c, const W* __restrict__ w_rec_t,
                const float* __restrict__ peep,
                const int* __restrict__ lengths, S* __restrict__ da_out,
                float* __restrict__ pb_part, int T, int B, int H, int clip) {
  bptt_body<S, W, kPlain, kWShared, false>(dh, gates, c, w_rec_t, peep,
                                           lengths, da_out, pb_part, T, B, H,
                                           clip, BpttCarry{});
}

template <typename S, typename W, bool kPlain, bool kWShared>
__global__ void __launch_bounds__(kRecMaxThreads)
    bptt_carry_kernel(const S* __restrict__ dh, const S* __restrict__ gates,
                      const float* __restrict__ c,
                      const W* __restrict__ w_rec_t,
                      const float* __restrict__ peep,
                      const int* __restrict__ lengths, S* __restrict__ da_out,
                      float* __restrict__ pb_part, int T, int B, int H,
                      int clip, BpttCarry ca) {
  bptt_body<S, W, kPlain, kWShared, true>(dh, gates, c, w_rec_t, peep,
                                          lengths, da_out, pb_part, T, B, H,
                                          clip, ca);
}

// One variant on its route: grid (n, ceil(B / 8), D). query: the plan's
// clusters the card holds at once into *active, no launch.
template <typename S, typename W, bool kPlain, bool kWShared, bool kCarry>
cudaError_t launch_bptt(const RecPlan& p, size_t smem, const void* dh,
                        const void* gates, const float* c,
                        const void* w_rec_t, const float* peep,
                        const int* lengths, void* da, float* pb_part, int T,
                        int B, int H, int D, int clip, const BpttCarry& ca,
                        int* active, bool query, cudaStream_t stream) {
  const dim3 grid(p.n, (B + kRecRows - 1) / kRecRows, D);
  const S* dh_s = static_cast<const S*>(dh);
  const S* g_s = static_cast<const S*>(gates);
  const W* w_s = static_cast<const W*>(w_rec_t);
  S* da_s = static_cast<S*>(da);
  if constexpr (kCarry)
    return launch_cluster(bptt_carry_kernel<S, W, kPlain, kWShared>, p, smem,
                          grid, stream, active, query, dh_s, g_s, c, w_s,
                          peep, lengths, da_s, pb_part, T, B, H, clip, ca);
  else
    return launch_cluster(bptt_kernel<S, W, kPlain, kWShared>, p, smem, grid,
                          stream, active, query, dh_s, g_s, c, w_s, peep,
                          lengths, da_s, pb_part, T, B, H, clip);
}

// The plan's route (rec_route), as lstm_fwd.cu's launch_rec_w.
template <typename S, typename W, bool kPlain, bool kCarry>
cudaError_t launch_bptt_w(const void* dh, const void* gates, const float* c,
                          const void* w_rec_t, const float* peep,
                          const int* lengths, void* da, float* pb_part, int T,
                          int B, int H, int D, int clip, const BpttCarry& ca,
                          int device, cudaStream_t stream,
                          int* active = nullptr, bool query = false) {
  const RecPlan p = rec_plan(H, sizeof(W), true);
  size_t smem = 0;
  bool on_chip = false;
  const cudaError_t err = rec_route(p, device, &smem, &on_chip);
  if (err != cudaSuccess) return err;
  if (on_chip)
    return launch_bptt<S, W, kPlain, true, kCarry>(
        p, smem, dh, gates, c, w_rec_t, peep, lengths, da, pb_part, T, B, H,
        D, clip, ca, active, query, stream);
  return launch_bptt<S, W, kPlain, false, kCarry>(
      p, smem, dh, gates, c, w_rec_t, peep, lengths, da, pb_part, T, B, H, D,
      clip, ca, active, query, stream);
}

// The weight gradients and dx from da. S: the dtype of x, W_in, h and da
// (the compute and storage dtypes are one in each mode). Direction dd's
// scan ascends time when dd + dir_offset == 0.
template <typename S>
cudaError_t launch_grads(const void* x, const void* h, const void* da,
                         const void* w_in, float* dx, float* w_part,
                         float* w_out, int T, int B, int P, int H, int D,
                         int dir_offset, int need_dx, bool x3,
                         cudaStream_t stream) {
  const int G = 4 * H;
  const int M = T * B;
  const int ns = gemm_splits(M);
  const long long L_in = static_cast<long long>(D) * P * G;
  const long long L_all = L_in + static_cast<long long>(D) * H * G;
  cudaError_t err;
  {  // dW_in[d] = x^T . da[d]
    GemmArgs<S> g{};
    for (int dd = 0; dd < D; ++dd) {
      g.a[dd] = make_view<S>(x, P, M, P);
      g.b[dd] = make_view<S>(static_cast<const S*>(da) +
                                 static_cast<size_t>(dd) * M * G,
                             G, M, G);
    }
    g.M = P;
    g.N = G;
    g.K = M;
    g.nsplit = ns;
    g.ngroups = 1;
    err = launch_gemm<GemmDwIn, S, true, false, float>(
        g, D, EpiPartial{w_part, L_all, static_cast<long long>(P) * G, G},
        stream, x3);
    if (err != cudaSuccess) return err;
  }
  {  // dW_rec[d] = h_prev^T . da[d]; h_prev is h one step back in scan order
    GemmArgs<S> g{};
    for (int dd = 0; dd < D; ++dd) {
      g.a[dd] = make_view<S>(static_cast<const S*>(h) + dd * H,
                             static_cast<long long>(D) * H, M, H,
                             dd + dir_offset == 0 ? -B : B);
      g.b[dd] = make_view<S>(static_cast<const S*>(da) +
                                 static_cast<size_t>(dd) * M * G,
                             G, M, G);
    }
    g.M = H;
    g.N = G;
    g.K = M;
    g.nsplit = ns;
    g.ngroups = 1;
    err = launch_gemm<GemmDwRec, S, true, false, float>(
        g, D,
        EpiPartial{w_part + L_in, L_all, static_cast<long long>(H) * G, G},
        stream, x3);
    if (err != cudaSuccess) return err;
  }
  err = launch_sum_partials(w_part, ns, L_all, w_out, L_all, L_all, 1.0f,
                            stream);
  if (err != cudaSuccess) return err;
  if (need_dx) {  // dx = sum_d round(da[d] . W_in[d]^T)
    GemmArgs<S> g{};
    for (int dd = 0; dd < D; ++dd) {
      g.a[dd] = make_view<S>(static_cast<const S*>(da) +
                                 static_cast<size_t>(dd) * M * G,
                             G, M, G);
      g.b[dd] = make_view<S>(static_cast<const S*>(w_in) +
                                 static_cast<size_t>(dd) * P * G,
                             G, P, G);
    }
    g.M = M;
    g.N = P;
    g.K = G;
    g.nsplit = 1;
    g.ngroups = D;
    err = launch_gemm<GemmDx, S, false, true, S>(
        g, 1, EpiStore<float>{dx, P}, stream, x3);
  }
  return err;
}

// dW_rec[d] += h0[d]^T . da[d, t_edge]: the scan-previous h of the scan's
// first step is the initial state h0 (in the storage dtype), where
// launch_grads' shifted h view reads zero. One thread per (k, n), the B
// rows summed in order.
template <typename S>
__global__ void edge_grad_kernel(const S* __restrict__ h0,
                                 const S* __restrict__ da,
                                 float* __restrict__ dw_rec, int T, int B,
                                 int H, int dir_offset) {
  const int d = blockIdx.y;
  const int G = 4 * H;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * G) return;
  const int k = i / G, n = i - k * G;
  const int t = d + dir_offset == 0 ? 0 : T - 1;
  const S* hd = h0 + static_cast<size_t>(d) * B * H;
  const S* dd = da + (static_cast<size_t>(d) * T + t) * B * G;
  float sum = 0.0f;
  for (int b = 0; b < B; ++b)
    sum = fmaf(as_f32(hd[static_cast<size_t>(b) * H + k]),
               as_f32(dd[static_cast<size_t>(b) * G + n]), sum);
  dw_rec[(static_cast<size_t>(d) * H + k) * G + n] += sum;
}

// The whole backward: the BPTT (carry variant when kCarry), the weight
// gradients, dx, the carry's dW_rec edge term, and dpeep/dbias.
template <typename S, bool kPlain, bool kCarry>
cudaError_t run_bwd(const void* x, const void* dh, const void* gates,
                    const float* c, const void* h, const void* w_in,
                    const void* w_rec_t, const float* peep,
                    const int* lengths, const void* h0, const BpttCarry& ca,
                    void* da, float* pb_part, float* w_part, float* w_out,
                    float* pb_out, float* dx, int T, int B, int P, int H,
                    int D, float bias_mult, int clip, int need_dx,
                    bool x3, int device, cudaStream_t stream) {
  cudaError_t err = launch_bptt_w<S, S, kPlain, kCarry>(
      dh, gates, c, w_rec_t, peep, lengths, da, pb_part, T, B, H, D, clip, ca,
      device, stream);
  if (err != cudaSuccess) return err;
  err = launch_grads<S>(x, h, da, w_in, dx, w_part, w_out, T, B, P, H, D,
                        kCarry ? ca.dir_offset : 0, need_dx, x3, stream);
  if (err != cudaSuccess) return err;
  if constexpr (kCarry) {
    const int n = 4 * H * H;
    edge_grad_kernel<S><<<dim3((n + 255) / 256, D), 256, 0, stream>>>(
        static_cast<const S*>(h0), static_cast<const S*>(da),
        w_out + static_cast<size_t>(D) * P * 4 * H, T, B, H, ca.dir_offset);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int nblk = (B + kRecRows - 1) / kRecRows;
  return launch_sum_partials(pb_part, nblk, static_cast<long long>(D) * 7 * H,
                             pb_out, 7LL * H, 3LL * H, bias_mult, stream);
}

}  // namespace

extern "C" {

// BPTT of one layer. Shapes (T, B, P, H, D as in lstm_fwd.cu; G = 4H,
// Hp = H rounded up to 4): x [T, B, P] and w_in [D, P, G] in the compute
// dtype; dh and h [T, B, D*H], gates [D, T, B, G] in the storage dtype
// (bf16 = 1: all four bf16, else f32); c [D, T, B, H] f32; w_rec_t
// [D, G, Hp] (W_rec transposed, zero-padded columns) in the compute dtype;
// peep [D, 3, H] f32; lengths [B] int32. Scratch: da [D, T, B, G] storage
// dtype, pb_part [ceil(B/8), D, 7H] f32, w_part [nsplit, L] f32 with
// L = D*P*G + D*H*G and nsplit = lstm_bwd_splits(T*B). Outputs: w_out [L]
// f32 = dW_in [D, P, G] then dW_rec [D, H, G]; pb_out [D, 7H] f32 = dpeep
// [D, 3, H] then dbias [D, G] (times bias_mult); dx [T, B, P] f32 when
// need_dx (the sum of the directions' planes, each rounded to the storage
// dtype first). x3 = 1 (f32 only, --f32_matmul 3x): the weight gradients
// and dx in the engine's 3x instance.
int lstm_bwd(const void* x, const void* dh, const void* gates, const float* c,
             const void* h, const void* w_in, const void* w_rec_t,
             const float* peep, const int* lengths, void* da, float* pb_part,
             float* w_part, float* w_out, float* pb_out, float* dx, int T,
             int B, int P, int H, int D, float bias_mult, int clip,
             int need_dx, int bf16, int x3, int device,
             cudaStream_t stream) {
  if (T < 1 || B < 1 || P < 1 || H < 1 || D < 1 || D > 2 || (x3 && bf16))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const BpttCarry none = {};
  if (bf16)
    return run_bwd<__nv_bfloat16, true, false>(
        x, dh, gates, c, h, w_in, w_rec_t, peep, lengths, nullptr, none, da,
        pb_part, w_part, w_out, pb_out, dx, T, B, P, H, D, bias_mult, clip,
        need_dx, false, device, stream);
  return run_bwd<float, false, false>(
      x, dh, gates, c, h, w_in, w_rec_t, peep, lengths, nullptr, none, da,
      pb_part, w_part, w_out, pb_out, dx, T, B, P, H, D, bias_mult, clip,
      need_dx, x3 != 0, device, stream);
}

// BPTT of one layer from an initial state (K6b backward). As lstm_bwd,
// over lstm_fwd_rec_carry_save's residuals, plus: h0 [D, B, H] in the
// storage dtype (the scan-previous h of the edge row of dW_rec), c0 [D, B,
// H] f32 (its c_prev), dhf and dcf [D, B, H] f32 (the cotangents of the
// forward's final state, joining at step carry_t - 1 of an ascending
// direction and t = 0 of a descending one); out dh0 and dc0 [D, B, H] f32.
// carry_t and dir_offset as in lstm_fwd_rec_carry_save.
int lstm_bwd_carry(const void* x, const void* dh, const void* gates,
                   const float* c, const void* h, const void* w_in,
                   const void* w_rec_t, const float* peep,
                   const int* lengths, const void* h0, const float* c0,
                   const float* dhf, const float* dcf, void* da,
                   float* pb_part, float* w_part, float* w_out, float* pb_out,
                   float* dx, float* dh0, float* dc0, int T, int B, int P,
                   int H, int D, int carry_t, int dir_offset, float bias_mult,
                   int clip, int need_dx, int bf16, int x3, int device,
                   cudaStream_t stream) {
  if (T < 1 || B < 1 || P < 1 || H < 1 || D < 1 || D > 2)
    return cudaErrorInvalidValue;
  if (dir_offset < 0 || dir_offset > 1 || (D == 2 && dir_offset != 0))
    return cudaErrorInvalidValue;
  if (carry_t < 1 || carry_t > T) return cudaErrorInvalidValue;
  if ((D == 2 || dir_offset == 1) && carry_t != T)
    return cudaErrorInvalidValue;
  if (x3 && bf16) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const BpttCarry ca = {c0, dhf, dcf, dh0, dc0, carry_t, dir_offset};
  if (bf16)
    return run_bwd<__nv_bfloat16, true, true>(
        x, dh, gates, c, h, w_in, w_rec_t, peep, lengths, h0, ca, da, pb_part,
        w_part, w_out, pb_out, dx, T, B, P, H, D, bias_mult, clip, need_dx,
        false, device, stream);
  return run_bwd<float, false, true>(
      x, dh, gates, c, h, w_in, w_rec_t, peep, lengths, h0, ca, da, pb_part,
      w_part, w_out, pb_out, dx, T, B, P, H, D, bias_mult, clip, need_dx,
      x3 != 0, device, stream);
}

// The cluster plan of the BPTT recurrence at width H, as bptt_kernel
// takes it: info as lstm_fwd_rec_plan's.
int lstm_bwd_plan(int H, int bf16, int device, int* info) {
  if (H < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const RecPlan p = rec_plan(H, bf16 ? 2 : 4, true);
  size_t smem = 0;
  bool on_chip = false;
  err = rec_route(p, device, &smem, &on_chip);
  if (err != cudaSuccess) return err;
  info[0] = p.n;
  info[1] = p.threads;
  info[2] = static_cast<int>(smem);
  info[3] = on_chip ? 1 : 0;
  const BpttCarry none = {};
  if (bf16)
    return launch_bptt_w<__nv_bfloat16, __nv_bfloat16, true, false>(
        nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
        nullptr, 1, 1, H, 1, 0, none, device, nullptr, &info[4], true);
  return launch_bptt_w<float, float, false, false>(
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      1, 1, H, 1, 0, none, device, nullptr, &info[4], true);
}

// K splits of the weight-gradient reduction over M = T*B rows (the
// partial buffer w_part holds this many copies).
int lstm_bwd_splits(int M) { return gemm_splits(M); }

}  // extern "C"
