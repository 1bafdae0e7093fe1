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
// 1. bptt_kernel, the recurrence: grid (D, ceil(B / 4)), a time loop inside
//    each block, as lstm_fwd.cu's rec_kernel. Latency-bound: the steps
//    depend on each other and each is a [4, 4H] x [4H, H] product. The
//    product runs against W_rec^T, which the wrapper passes as a transposed
//    copy [D, 4H, Hp] (Hp = H rounded up to 4, zero columns), so each
//    thread reads 4 adjacent output columns with one 16-byte (f32) or
//    8-byte (bf16) load per k, k split over up to 16 thread groups. The
//    copy is staged in shared memory when it fits beside the state (bf16 at
//    H = 125: 125 KB); f32 (250 KB) is re-read from L2 every step. A
//    step's loads of dh, the four gates, c and c_prev are issued before the
//    product, so they land while it runs. The step writes da [D, T, B, 4H]
//    in the storage dtype and adds its dpeep/dbias terms into per-block
//    partial sums (one row of [ceil(B/4), D, 7H] per block). Each block
//    stops at the longest row of its block and writes zero deltas after it.
// 2. dW_in and dW_rec: gemm.cuh's GEMM (wgmma in bf16, a register-blocked
//    SIMT body in f32) over the T*B rows, split-K into per-split partials,
//    summed in order by sum_partials (the TPU kernel accumulates them
//    chunk by chunk in VMEM; here da makes one round trip through device
//    memory).
// 3. dx = sum_d da[d] . W_in[d]^T, the same GEMM, both directions in one
//    launch (skipped for the first hidden layer, need_dx = 0).
// 4. sum_partials for dpeep/dbias (times bias_mult for dbias).
// 5. The carry variant (lstm_bwd_carry): bptt_carry_kernel, bptt_kernel's
//    body with kCarry. The forward started from (h0, c0) and emitted its
//    state at step carry_t - 1 (ascending) or t = 0 (descending; a
//    direction descends when d + dir_offset > 0) as (hf, cf). So: c_prev
//    at the scan edge is c0 and the edge's fg delta is not zeroed; dhf
//    joins e and dcf joins cs_err at the capture step; after the last BPTT
//    step, one more product gives dh0 = round(da) . W_rec^T, and dc0 =
//    fg_next cs_err_next + p_ig da[ig] + p_fg da[fg], all from shared
//    memory. Every step runs: the longest-row shortcut would leave a
//    descending direction's dh0/dc0 to an unmasked state, where the
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

namespace {

constexpr float kBwdExpLimit = 88.722839f;

__device__ __forceinline__ float bwd_logistic(float x) {
  if (x >= kBwdExpLimit) return 1.0f;
  if (x <= -kBwdExpLimit) return 0.0f;
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float bwd_tanh2(float x) {
  return 2.0f * bwd_logistic(2.0f * x) - 1.0f;
}

constexpr int kBpttThreads = 512;
constexpr int kBpttRows = 4;
constexpr int kBpttMaxKSplit = 16;
constexpr int kPre = 2;  // cell items per thread whose loads are issued early

__host__ __device__ inline size_t bptt_align4(size_t n) {
  return (n + 3) & ~static_cast<size_t>(3);
}

// Shared-memory layout of bptt_kernel, offsets in floats.
struct BpttLayout {
  int ksplit, hp;
  size_t da;    // [rows][4H] da_next (f32, unrounded)
  size_t das;   // [4H][rows] da_next rounded to the compute dtype (k-major)
  size_t part;  // [ksplit][rows][hp] partial sums of da_next . W_rec^T
  size_t cse;   // [rows][H] cs_err_next
  size_t fgn;   // [rows][H] fg_next
  size_t peep;  // [3][H]
  size_t acc;   // [rows][7H] dpeep (3H) and dbias (4H) sums of each row
  size_t w;     // [4H][hp] W_rec^T, when staged in shared memory
};

__host__ __device__ inline BpttLayout bptt_layout(int H) {
  BpttLayout L;
  const size_t G = 4 * static_cast<size_t>(H);
  L.hp = (H + 3) & ~3;
  const int quads = L.hp / 4;
  int ks = kBpttThreads / quads;
  if (ks < 1) ks = 1;
  if (ks > kBpttMaxKSplit) ks = kBpttMaxKSplit;
  if (ks > static_cast<int>(G)) ks = static_cast<int>(G);
  L.ksplit = ks;
  const size_t R = kBpttRows;
  L.da = 0;
  L.das = L.da + bptt_align4(R * G);
  L.part = L.das + bptt_align4(G * R);
  L.cse = L.part + bptt_align4(static_cast<size_t>(ks) * R * L.hp);
  L.fgn = L.cse + bptt_align4(R * H);
  L.peep = L.fgn + bptt_align4(R * H);
  L.acc = L.peep + bptt_align4(3 * static_cast<size_t>(H));
  L.w = L.acc + bptt_align4(R * 7 * static_cast<size_t>(H));
  return L;
}

__device__ __forceinline__ float4 bwd_load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 bwd_load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// One cell item's inputs at step t: dh, the four gates, c[t], c_prev.
struct CellIn {
  float dh, g[4], c, cp;
};

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

// The BPTT, shared by bptt_kernel and bptt_carry_kernel.
// S: storage dtype (dh, gates, da); W: compute dtype of W_rec^T.
// kPlain: plain tanh (bf16 mode); kWShared: W_rec^T staged in shared memory.
// kCarry: the K6b backward (see the note at the top): c_prev at the scan
// edge is ca.c0 (its fg delta is not zeroed), dhf and dcf join at the
// capture step, every step runs, and dh0/dc0 are written after the last.
// Each variant is an entry point of its own, so that bptt_kernel compiles
// as it did without the carry (lstm_fwd.cu's rec_body does the same).
template <typename S, typename W, bool kPlain, bool kWShared, bool kCarry>
__device__ __forceinline__ void bptt_body(
    const S* __restrict__ dh, const S* __restrict__ gates,
    const float* __restrict__ c, const W* __restrict__ w_rec_t,
    const float* __restrict__ peep, const int* __restrict__ lengths,
    S* __restrict__ da_out, float* __restrict__ pb_part, int T, int B, int H,
    int clip, const BpttCarry& ca) {
  extern __shared__ __align__(16) float smem[];
  const BpttLayout L = bptt_layout(H);
  const int G = 4 * H;
  const int HP = L.hp;
  const int KS = L.ksplit;
  const int KC = (G + KS - 1) / KS;  // k (gate columns) per split
  const int QH = HP / 4;             // column quads of the product
  float* da_s = smem + L.da;
  float* das = smem + L.das;
  float* part = smem + L.part;
  float* cse = smem + L.cse;
  float* fgn = smem + L.fgn;
  float* ps = smem + L.peep;
  float* acc = smem + L.acc;
  W* ws = reinterpret_cast<W*>(smem + L.w);
  __shared__ int len_s[kBpttRows];
  __shared__ int tmax_s;

  const int d = blockIdx.x;
  const int D = gridDim.x;
  const int blk = blockIdx.y;
  const int b0 = blk * kBpttRows;
  const int nb = min(kBpttRows, B - b0);
  const int tid = threadIdx.x;
  const size_t DH = static_cast<size_t>(D) * H;
  // the direction's scan ascends time (BPTT then walks it descending);
  // without kCarry this is d == 0
  const int dd = d + (kCarry ? ca.dir_offset : 0);

  for (size_t i = tid; i < L.w; i += kBpttThreads) smem[i] = 0.0f;
  const W* wd = w_rec_t + static_cast<size_t>(d) * G * HP;
  if (kWShared) {
    for (int i = tid; i < G * HP; i += kBpttThreads) ws[i] = wd[i];
    wd = ws;
  }
  if (tid < kBpttRows)
    len_s[tid] = tid < nb ? min(max(lengths[b0 + tid], 0), T) : 0;
  __syncthreads();
  for (int i = tid; i < 3 * H; i += kBpttThreads) ps[i] = peep[d * 3 * H + i];
  if (tid == 0) {
    int m = 0;
    for (int r = 0; r < kBpttRows; ++r) m = max(m, len_s[r]);
    tmax_s = m;
  }
  __syncthreads();
  const int tmax = kCarry ? T : tmax_s;
  const int n_items = nb * H;
  // the step whose state the forward emitted as (hf, cf) (kCarry)
  const int t_cap = kCarry && dd == 0 ? ca.carry_t - 1 : 0;

  auto load_in = [&](int p, int t) {
    CellIn in;
    const int r = p / H, j = p - r * H;
    const size_t row = (static_cast<size_t>(d) * T + t) * B + b0 + r;
    in.dh = as_f32(dh[(static_cast<size_t>(t) * B + b0 + r) * DH +
                      static_cast<size_t>(d) * H + j]);
#pragma unroll
    for (int gi = 0; gi < 4; ++gi) in.g[gi] = as_f32(gates[row * G + gi * H + j]);
    in.c = c[row * H + j];
    const bool edge = dd == 0 ? t <= 0 : t >= T - 1;
    const int tn = dd == 0 ? t - 1 : t + 1;
    const size_t state = (static_cast<size_t>(d) * B + b0 + r) * H + j;
    in.cp = edge ? (kCarry ? ca.c0[state] : 0.0f)
                 : c[((static_cast<size_t>(d) * T + tn) * B + b0 + r) * H + j];
    return in;
  };

  // one cell item: the deltas of (row r, cell j) at step t
  auto cell = [&](int p, int t, const CellIn& in) {
    const int r = p / H, j = p - r * H;
    float e = in.dh;
    for (int kq = 0; kq < KS; ++kq)
      e += part[(static_cast<size_t>(kq) * kBpttRows + r) * HP + j];
    float dcf = 0.0f;
    if (kCarry && t == t_cap) {
      // the final (h, c) are this step's through an identity: their
      // cotangents join e and the cell-state error here
      const size_t src = (static_cast<size_t>(d) * B + b0 + r) * H + j;
      e += ca.dhf[src];
      dcf = ca.dcf[src];
    }
    const float ni = in.g[0], ig = in.g[1], fg = in.g[2], og = in.g[3];
    const float tanh_c = kPlain ? tanhf(in.c) : bwd_tanh2(in.c);
    const float og_delta = og * (1.0f - og) * tanh_c * e;
    float* dar = da_s + r * G;
    float cs_err = og * (1.0f - tanh_c * tanh_c) * e +
                   ps[2 * H + j] * og_delta +
                   fgn[r * H + j] * cse[r * H + j] +
                   ps[j] * dar[H + j] + ps[H + j] * dar[2 * H + j];
    if (kCarry) cs_err += dcf;
    // with a carry the scan edge has a previous cell state, c0
    const bool edge = !kCarry && (dd == 0 ? t <= 0 : t >= T - 1);
    float dv[4];
    dv[0] = ig * (1.0f - ni * ni) * cs_err;
    dv[1] = ig * (1.0f - ig) * ni * cs_err;
    dv[2] = edge ? 0.0f : fg * (1.0f - fg) * in.cp * cs_err;
    dv[3] = og_delta;
    const float m = t < len_s[r] ? 1.0f : 0.0f;
    const size_t row = (static_cast<size_t>(d) * T + t) * B + b0 + r;
    float* ac = acc + r * 7 * H;
#pragma unroll
    for (int gi = 0; gi < 4; ++gi) {
      float v = dv[gi];
      if (clip) v = fminf(fmaxf(v, -1.0f), 1.0f);
      v *= m;
      dar[gi * H + j] = v;
      das[(gi * H + j) * kBpttRows + r] = round_to<W>(v);
      const S st = f32_to<S>(v);
      da_out[row * G + gi * H + j] = st;
      ac[3 * H + gi * H + j] += as_f32(st);  // dbias, from the stored da
      dv[gi] = as_f32(st);
    }
    ac[j] += in.cp * dv[1];          // dpeep ig: c_prev
    ac[H + j] += in.cp * dv[2];      // dpeep fg: c_prev
    ac[2 * H + j] += in.c * dv[3];   // dpeep og: c
    cse[r * H + j] = cs_err * m;
    fgn[r * H + j] = fg * m;
  };

  // kCarry: one pass more after the last step, whose product is dh0
  const int n_pass = tmax + (kCarry ? 1 : 0);
  for (int s = 0; s < n_pass; ++s) {
    const int t = dd == 0 ? tmax - 1 - s : s;
    const bool after = kCarry && s == tmax;
    // issue this step's cell loads now; they land while the product runs
    CellIn pre[kPre];
#pragma unroll
    for (int it = 0; it < kPre; ++it) {
      const int p = tid + it * kBpttThreads;
      if (p < n_items && !after) pre[it] = load_in(p, t);
    }
    // partial products da_next . W_rec^T: one (k slice, 4 adjacent output
    // columns) item per thread, all rows of the block
    for (int item = tid; item < KS * QH; item += kBpttThreads) {
      const int kq = item / QH, q = item - kq * QH;
      const int k0 = kq * KC, k1 = min(G, k0 + KC);
      float a4[kBpttRows][4] = {};
      const W* wq = wd + 4 * q;
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        const float4 w4 = bwd_load4(wq + static_cast<size_t>(k) * HP);
        const float4 h4 = *reinterpret_cast<const float4*>(das + k * kBpttRows);
        const float hr[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int i = 0; i < kBpttRows; ++i) {
          a4[i][0] = fmaf(hr[i], w4.x, a4[i][0]);
          a4[i][1] = fmaf(hr[i], w4.y, a4[i][1]);
          a4[i][2] = fmaf(hr[i], w4.z, a4[i][2]);
          a4[i][3] = fmaf(hr[i], w4.w, a4[i][3]);
        }
      }
      float* pq = part + static_cast<size_t>(kq) * kBpttRows * HP + 4 * q;
#pragma unroll
      for (int r = 0; r < kBpttRows; ++r)
        *reinterpret_cast<float4*>(pq + r * HP) =
            make_float4(a4[r][0], a4[r][1], a4[r][2], a4[r][3]);
    }
    __syncthreads();
    if (after) {
      // after the last step the recurrence's remaining terms are the
      // initial state's gradients: dh0 = round(da) . W_rec^T, the product
      // just taken, and dc0 = the cell-state terms of the virtual step
      // before the scan
      for (int p = tid; p < n_items; p += kBpttThreads) {
        const int r = p / H, j = p - r * H;
        float v = 0.0f;
        for (int kq = 0; kq < KS; ++kq)
          v += part[(static_cast<size_t>(kq) * kBpttRows + r) * HP + j];
        const float* dar = da_s + r * G;
        const size_t dst = (static_cast<size_t>(d) * B + b0 + r) * H + j;
        ca.dh0[dst] = v;
        ca.dc0[dst] = fgn[r * H + j] * cse[r * H + j] + ps[j] * dar[H + j] +
                      ps[H + j] * dar[2 * H + j];
      }
      break;
    }
#pragma unroll
    for (int it = 0; it < kPre; ++it) {
      const int p = tid + it * kBpttThreads;
      if (p < n_items) cell(p, t, pre[it]);
    }
    for (int p = tid + kPre * kBpttThreads; p < n_items; p += kBpttThreads)
      cell(p, t, load_in(p, t));
    __syncthreads();
  }
  // steps past the block's longest row: zero deltas for all its rows
  const size_t per_t = static_cast<size_t>(nb) * G;
  const size_t n_pad = static_cast<size_t>(T - tmax) * per_t;
  for (size_t i = tid; i < n_pad; i += kBpttThreads) {
    const size_t t = tmax + i / per_t;
    const size_t rem = i % per_t;
    da_out[((static_cast<size_t>(d) * T + t) * B + b0) * G + rem] =
        f32_to<S>(0.0f);
  }
  // this block's dpeep/dbias partial: rows summed in order
  for (int col = tid; col < 7 * H; col += kBpttThreads) {
    float sum = 0.0f;
    for (int r = 0; r < nb; ++r) sum += acc[r * 7 * H + col];
    pb_part[(static_cast<size_t>(blk) * D + d) * 7 * H + col] = sum;
  }
}

template <typename S, typename W, bool kPlain, bool kWShared>
__global__ void __launch_bounds__(kBpttThreads)
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
__global__ void __launch_bounds__(kBpttThreads)
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

template <typename Kernel, typename... Args>
cudaError_t launch_bptt_kernel(Kernel kernel, size_t smem, dim3 grid,
                               cudaStream_t stream, Args... args) {
  // opt in whatever the size: the static part counts against 48 KB too
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kBpttThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename S, typename W, bool kPlain, bool kWShared, bool kCarry>
cudaError_t launch_bptt(const void* dh, const void* gates, const float* c,
                        const void* w_rec_t, const float* peep,
                        const int* lengths, void* da, float* pb_part, int T,
                        int B, int H, int D, int clip, const BpttCarry& ca,
                        size_t smem, cudaStream_t stream) {
  const dim3 grid(D, (B + kBpttRows - 1) / kBpttRows);
  const S* dh_s = static_cast<const S*>(dh);
  const S* g_s = static_cast<const S*>(gates);
  const W* w_s = static_cast<const W*>(w_rec_t);
  S* da_s = static_cast<S*>(da);
  if constexpr (kCarry)
    return launch_bptt_kernel(bptt_carry_kernel<S, W, kPlain, kWShared>,
                              smem, grid, stream, dh_s, g_s, c, w_s, peep,
                              lengths, da_s, pb_part, T, B, H, clip, ca);
  else
    return launch_bptt_kernel(bptt_kernel<S, W, kPlain, kWShared>, smem,
                              grid, stream, dh_s, g_s, c, w_s, peep, lengths,
                              da_s, pb_part, T, B, H, clip);
}

template <typename S, typename W, bool kPlain, bool kCarry>
cudaError_t launch_bptt_w(const void* dh, const void* gates, const float* c,
                          const void* w_rec_t, const float* peep,
                          const int* lengths, void* da, float* pb_part, int T,
                          int B, int H, int D, int clip, const BpttCarry& ca,
                          int device, cudaStream_t stream) {
  int smem_max = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const BpttLayout L = bptt_layout(H);
  const size_t state = L.w * sizeof(float);
  const size_t with_w =
      state + static_cast<size_t>(4) * H * L.hp * sizeof(W);
  if (with_w <= static_cast<size_t>(smem_max))
    return launch_bptt<S, W, kPlain, true, kCarry>(
        dh, gates, c, w_rec_t, peep, lengths, da, pb_part, T, B, H, D, clip,
        ca, with_w, stream);
  if (state > static_cast<size_t>(smem_max)) return cudaErrorInvalidValue;
  return launch_bptt<S, W, kPlain, false, kCarry>(
      dh, gates, c, w_rec_t, peep, lengths, da, pb_part, T, B, H, D, clip, ca,
      state, stream);
}

// The weight gradients and dx from da. S: the dtype of x, W_in, h and da
// (the compute and storage dtypes are one in each mode). Direction dd's
// scan ascends time when dd + dir_offset == 0.
template <typename S>
cudaError_t launch_grads(const void* x, const void* h, const void* da,
                         const void* w_in, float* dx, float* w_part,
                         float* w_out, int T, int B, int P, int H, int D,
                         int dir_offset, int need_dx, cudaStream_t stream) {
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
        stream);
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
        stream);
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
        g, 1, EpiStore<float>{dx, P}, stream);
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
                    int device, cudaStream_t stream) {
  cudaError_t err = launch_bptt_w<S, S, kPlain, kCarry>(
      dh, gates, c, w_rec_t, peep, lengths, da, pb_part, T, B, H, D, clip, ca,
      device, stream);
  if (err != cudaSuccess) return err;
  err = launch_grads<S>(x, h, da, w_in, dx, w_part, w_out, T, B, P, H, D,
                        kCarry ? ca.dir_offset : 0, need_dx, stream);
  if (err != cudaSuccess) return err;
  if constexpr (kCarry) {
    const int n = 4 * H * H;
    edge_grad_kernel<S><<<dim3((n + 255) / 256, D), 256, 0, stream>>>(
        static_cast<const S*>(h0), static_cast<const S*>(da),
        w_out + static_cast<size_t>(D) * P * 4 * H, T, B, H, ca.dir_offset);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int nblk = (B + kBpttRows - 1) / kBpttRows;
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
// dtype, pb_part [ceil(B/4), D, 7H] f32, w_part [nsplit, L] f32 with
// L = D*P*G + D*H*G and nsplit = lstm_bwd_splits(T*B). Outputs: w_out [L]
// f32 = dW_in [D, P, G] then dW_rec [D, H, G]; pb_out [D, 7H] f32 = dpeep
// [D, 3, H] then dbias [D, G] (times bias_mult); dx [T, B, P] f32 when
// need_dx (the sum of the directions' planes, each rounded to the storage
// dtype first).
int lstm_bwd(const void* x, const void* dh, const void* gates, const float* c,
             const void* h, const void* w_in, const void* w_rec_t,
             const float* peep, const int* lengths, void* da, float* pb_part,
             float* w_part, float* w_out, float* pb_out, float* dx, int T,
             int B, int P, int H, int D, float bias_mult, int clip,
             int need_dx, int bf16, int device, cudaStream_t stream) {
  if (T < 1 || B < 1 || P < 1 || H < 1 || D < 1 || D > 2)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const BpttCarry none = {};
  if (bf16)
    return run_bwd<__nv_bfloat16, true, false>(
        x, dh, gates, c, h, w_in, w_rec_t, peep, lengths, nullptr, none, da,
        pb_part, w_part, w_out, pb_out, dx, T, B, P, H, D, bias_mult, clip,
        need_dx, device, stream);
  return run_bwd<float, false, false>(
      x, dh, gates, c, h, w_in, w_rec_t, peep, lengths, nullptr, none, da,
      pb_part, w_part, w_out, pb_out, dx, T, B, P, H, D, bias_mult, clip,
      need_dx, device, stream);
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
                   int clip, int need_dx, int bf16, int device,
                   cudaStream_t stream) {
  if (T < 1 || B < 1 || P < 1 || H < 1 || D < 1 || D > 2)
    return cudaErrorInvalidValue;
  if (dir_offset < 0 || dir_offset > 1 || (D == 2 && dir_offset != 0))
    return cudaErrorInvalidValue;
  if (carry_t < 1 || carry_t > T) return cudaErrorInvalidValue;
  if ((D == 2 || dir_offset == 1) && carry_t != T)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const BpttCarry ca = {c0, dhf, dcf, dh0, dc0, carry_t, dir_offset};
  if (bf16)
    return run_bwd<__nv_bfloat16, true, true>(
        x, dh, gates, c, h, w_in, w_rec_t, peep, lengths, h0, ca, da, pb_part,
        w_part, w_out, pb_out, dx, T, B, P, H, D, bias_mult, clip, need_dx,
        device, stream);
  return run_bwd<float, false, true>(
      x, dh, gates, c, h, w_in, w_rec_t, peep, lengths, h0, ca, da, pb_part,
      w_part, w_out, pb_out, dx, T, B, P, H, D, bias_mult, clip, need_dx,
      device, stream);
}

// K splits of the weight-gradient reduction over M = T*B rows (the
// partial buffer w_part holds this many copies).
int lstm_bwd_splits(int M) { return gemm_splits(M); }

}  // extern "C"
