// The tensor-parallel LSTM layer, for NVIDIA Hopper (sm_90a): K8f
// (tp_rec_kernel, the forward, with a save variant for training) and K8b
// (tp_bptt_kernel, the BPTT).
//
// Replaces no pallas_call. The JAX package's tensor-parallel layer
// (lstm_rnn_tpu/parallel/tensor.py `lstm_forward_tp`) is one lax.scan of
// the CURRENNT cell inside shard_map, with an all_gather of h a step
// (:86-113) and, through autodiff, a reduce_scatter of the recurrent
// error a step in the backward. These two kernels are the port's
// counterpart of that one compiled program: without them each time step
// was a few thousand host operations (parallel/tensor.py's plain loop,
// now the kernels' twin).
//
// The mesh. Shard i of n owns the w = H / n cells [i w, (i + 1) w) of
// each direction: their gate columns of W_rec [D, H, 4, w], their
// peepholes and their cell state. A GPU of the mesh holds one or more
// shards (a mesh may name a GPU several times) and runs ONE launch a layer
// that covers every shard it holds and both directions: the launches on
// one GPU never wait for each other, and a GPU's blocks all run at once
// (the grid is refused where the card cannot hold it: `tp_plan`).
//
// The tiles. A block is one tile: (local shard, direction d, a group of
// kTpRows rows, kTpCells cells of the shard), 256 threads, thread (r, l)
// the tile's row r and cell l. The tiles of one (direction, row group)
// over the whole mesh are that group's writers; each step every tile
// waits for all writers of its group, so the mesh moves in lock step per
// (direction, row group) and the groups run independently.
//
// K8f, per step s of direction d's scan (d = 1 walks time backwards):
//   wait until every writer of the group has published step s - 1;
//   h_prev rows [kTpRows, H] from this GPU's replica of the output into
//   shared memory (L2 reads: peers wrote them);
//   gates = acts[s] + h_prev . W_rec[:, shard's columns] (true f32 FMA,
//   k ascending; W from L2 through the read-only path);
//   the CURRENNT cell (recurrence.cuh's logistic_exact / tanh2_exact, the
//   peepholes; og from the new cell state), then h and c times the step's
//   validity, as lstm_forward_tp applies the masks;
//   h into the output [T, B, D*H] (natural time) of EVERY GPU of the mesh
//   (peer stores over NVLink): the all_gather; then the tile's flag on
//   every GPU. The save variant also writes c and the masked gates.
// After the last step each tile waits for its group's last step, so that
// when a GPU's launch ends its replica is complete.
//
// K8b, per step s of the BPTT (s = T-1 .. 0 of the scan), a tile:
//   e = dy[s] + the sum over the group's writers (fixed order) of their
//   partial errors for its cells, sent in the step before;
//   the cell-error step of csrc/lstm_bwd.cu (its header formulas): the
//   UNCLIPPED og delta into the cell-state error, the +-1 clip on the four
//   deltas, times the validity; da[s] out;
//   its partial of step s - 1 over all H: da_tile . W_rec_tile^T
//   ([kTpRows, 4 kTpCells] x [4 kTpCells, H], from a transposed copy of
//   the shard's W_rec so that the reads are contiguous in H), each column
//   sent to the GPU that owns its cell, into a buffer of the step's
//   parity: the reduce_scatter; then the tile's flag on every GPU.
// dW_rec = sum_s h_prev^T da, the peephole sums, and the input
// projection's gradients are plain products after the loop
// (ops/lstm_tp.py).
//
// The flags survive a CUDA graph's replays, whose kernel arguments are
// frozen at capture: each GPU keeps, per mesh, a sequence number in
// device memory (state[0]) that the last block of every K8 launch
// advances; every GPU runs the same launches of the mesh in the same
// order, so the numbers agree. A tile publishes step it of a launch as
// the stamp (seq << 32) | (it + 1) into its slot, and a waiter accepts
// any stamp at least that large: a slot only ever grows, and a larger
// stamp means its writer has passed that step (and its data is visible:
// the tile's stores, a block barrier, one fence at the mesh's scope, then
// the flag; the waiter polls with relaxed loads, fences once and reads
// the data with L2 loads). No flag is ever reset, so no reset races a
// fast peer's early signal.
//
// Every wait is bounded (the mesh's bound_ns, from %globaltimer). Past
// it the tile records {1, layer, gpu, step} in the mesh's host-mapped
// error record, poisons the GPU's state (every other block of the GPU
// then stops too) and the launch ends; the wrapper raises it, naming the
// layer and the GPU, at its next check.
//
// What bounds it. A step is a [8, H] x [H, 4 kTpCells] product a tile
// (K8b: [8, 4 kTpCells] x [4 kTpCells, H]) and one exchange:
// latency-bound at the mesh's widths (the step's dependency chain is a
// product, the cell, a store, a fence and a flag). The tile's share of
// W_rec (4 kTpCells columns, H rows: 64 KB at H = 125) stays in shared
// memory for the whole loop where it fits (H up to ~400, `tp_plan`);
// wider layers read it from L2 every step (a 1,024-cell layer's is 512
// KB). The flags are polled with relaxed loads and fenced once, at GPU
// scope on one GPU and at system scope across GPUs. float32 only: the TP
// layers take no compute dtype in either package.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <mutex>

#include "recurrence.cuh"

namespace {

constexpr int kTpRows = 8;
constexpr int kTpCells = 32;
constexpr int kTpThreads = kTpRows * kTpCells;
// shards one GPU holds, GPUs of a mesh, shards of a mesh
constexpr int kTpMaxLocal = 16;
constexpr int kTpMaxGpus = 8;
constexpr int kTpMaxShards = 64;

// What every launch of one mesh shares, as this GPU sees it.
struct TpMesh {
  unsigned long long* flags[kTpMaxGpus];  // each GPU's flag slots
  unsigned long long* state;  // this GPU's {seq, blocks done, poisoned}
  int* err;                   // this GPU's host-mapped error record [4]
  long long bound_ns;         // the longest wait
  int n_flags;                // slots of each flag array
  int gpus, gpu;              // GPUs of the mesh, this one's index
  int layer;                  // the launch's layer id (error record)
};

struct TpFwdArgs {
  TpMesh mesh;
  const float* acts[kTpMaxLocal];  // [T, D, B, 4, w], scan order
  const float* wrec[kTpMaxLocal];  // [D, H, 4, w]
  const float* peep[kTpMaxLocal];  // [D, 3, w]
  float* c_save[kTpMaxLocal];      // [T, D, B, w] or null
  float* g_save[kTpMaxLocal];      // [T, D, B, 4, w] or null
  int shard[kTpMaxLocal];          // the local shards' mesh indices
  const float* mask;               // [T, D, B] scan order
  float* y[kTpMaxGpus];            // every GPU's output [T, B, D*H]
  int T, B, H, D, w, n;
  int w_smem;                      // the tile's W_rec columns on chip
};

struct TpBwdArgs {
  TpMesh mesh;
  const float* gates[kTpMaxLocal];  // [T, D, B, 4, w] (K8f's save)
  const float* c[kTpMaxLocal];      // [T, D, B, w]
  const float* wrec_t[kTpMaxLocal];  // [D, 4, w, H]
  const float* peep[kTpMaxLocal];    // [D, 3, w]
  const float* dy[kTpMaxLocal];      // [T, D, B, w] scan order
  float* da[kTpMaxLocal];            // [T, D, B, 4, w] out
  int shard[kTpMaxLocal];
  signed char owner[kTpMaxShards];   // each shard's GPU index
  const float* mask;                 // [T, D, B]
  float* part[kTpMaxGpus];           // every GPU's [2, nw, D, B, H]
  int T, B, H, D, w, n, clip;
  int w_smem;                        // the tile's W_rec^T rows on chip
};

// A flag's value as a relaxed load at system scope (it may come from a
// peer GPU); the waiter's fence after it makes the acquire.
__device__ __forceinline__ unsigned long long ld_flag(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_flag(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("st.relaxed.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// The fence of a release or an acquire: at GPU scope when the mesh is one
// GPU, at system scope across GPUs (peer stores over NVLink).
__device__ __forceinline__ void mesh_fence(int gpus) {
  if (gpus > 1)
    __threadfence_system();
  else
    __threadfence();
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The tile of block b: local shard ls, direction d, row group rg, cell
// tile ct.
struct Tile {
  int ls, d, rg, ct, nct, nrg;
};

__device__ __forceinline__ Tile tile_of(int b, int w, int B, int D) {
  Tile t;
  t.nct = (w + kTpCells - 1) / kTpCells;
  t.nrg = (B + kTpRows - 1) / kTpRows;
  t.ct = b % t.nct;
  b /= t.nct;
  t.rg = b % t.nrg;
  b /= t.nrg;
  t.d = b % D;
  t.ls = b / D;
  return t;
}

// The block barrier, after the warp's lanes have met. __syncthreads is
// an aligned barrier: no lane may reach it while another lane of its
// warp is elsewhere. So every lane of a tile computes (a lane past the
// last row or cell on a clamped one) and only the stores are masked: with
// the product and the cell under a branch, the tiles of a partial row
// group read h before their peers wrote it on an H100. __syncwarp
// reconverges a warp after its masked stores.
__device__ __forceinline__ void block_sync() {
  __syncwarp();
  __syncthreads();
}

// Block-wide: wait until the nw flags from `slots` hold at least `want`.
// Warp 0 polls with relaxed loads, whole (lane j reads slots j, j + 32,
// ...) and converged (__all_sync), then fences once (an acquire: no L1
// invalidation on every poll); the block barrier hands the data on. Returns
// false (every thread) where a wait passed the bound or the GPU's state
// is poisoned; the first to time out records the error.
__device__ bool wait_slots(const TpMesh& m, int slots, int nw,
                           unsigned long long want, int step,
                           int* s_abort) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const unsigned long long* f = m.flags[m.gpu] + slots;
    const volatile unsigned long long* poisoned = m.state + 2;
    const long long t0 = global_ns();
    for (int spins = 1;; ++spins) {
      bool ready = true;
      for (int j = lane; j < nw; j += 32)
        ready &= ld_flag(f + j) >= want;
      if (__all_sync(kFull, ready)) {
        mesh_fence(m.gpus);  // the acquire: the flags, then the data
        break;
      }
      if ((spins & 31) == 0) {
        const bool stop = __any_sync(kFull, *poisoned != 0ull);
        const bool late =
            __shfl_sync(kFull, static_cast<int>(global_ns() - t0 > m.bound_ns),
                        0) != 0;
        if (stop || late) {
          if (lane == 0) {
            if (!stop && atomicCAS(m.state + 2, 0ull, 1ull) == 0ull) {
              volatile int* e = m.err;
              e[1] = m.layer;
              e[2] = m.gpu;
              e[3] = step;
              __threadfence_system();
              e[0] = 1;
              __threadfence_system();
            }
            *s_abort = 1;
          }
          break;
        }
      }
      __nanosleep(20);
    }
  }
  block_sync();
  return *s_abort == 0;
}

// Publish step `it` of this tile: after the block barrier one thread
// fences (cumulative: every thread's stores before the barrier, peer
// stores among them, are visible at the mesh's scope) and writes the
// stamp into the tile's slot on every GPU.
__device__ __forceinline__ void publish(const TpMesh& m, int slot,
                                        unsigned long long stamp) {
  block_sync();
  if (threadIdx.x == 0) {
    mesh_fence(m.gpus);
    for (int g = 0; g < m.gpus; ++g) st_flag(m.flags[g] + slot, stamp);
  }
}

// The launch's end: the last block of the grid advances the sequence
// number that the next launch of the mesh on this GPU stamps with.
__device__ __forceinline__ void finish(const TpMesh& m,
                                       unsigned long long seq) {
  block_sync();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned long long done = atomicAdd(m.state + 1, 1ull);
    if (done == gridDim.x - 1) {
      m.state[1] = 0ull;
      __threadfence();
      *reinterpret_cast<volatile unsigned long long*>(m.state) = seq + 1;
    }
  }
}

template <bool kSave>
__global__ void __launch_bounds__(kTpThreads)
    tp_rec_kernel(const TpFwdArgs a) {
  // [kTpRows][H]: this step's h_prev rows; then, with w_smem, the
  // tile's W_rec columns [H][4][kTpCells] for the whole loop
  extern __shared__ float hs[];
  float* ws = hs + kTpRows * a.H;
  __shared__ int s_abort;
  __shared__ unsigned long long s_seq;
  const int tid = threadIdx.x, r = tid / kTpCells, l = tid % kTpCells;
  const Tile t = tile_of(blockIdx.x, a.w, a.B, a.D);
  const int shard = a.shard[t.ls], d = t.d;
  const int row = t.rg * kTpRows + r, cell = t.ct * kTpCells + l;
  const bool on = row < a.B && cell < a.w;
  // every lane computes (a padding lane on the last row or cell), and
  // only the stores are masked: no branch around a block barrier
  const int rowc = min(row, a.B - 1), cellc = min(cell, a.w - 1);
  const int hcol = d * a.H + shard * a.w + cellc;  // the output column
  const int nw = a.n * t.nct;
  const int slots = (d * t.nrg + t.rg) * nw;
  const int mine = slots + shard * t.nct + t.ct;
  const int DH = a.D * a.H;
  if (tid == 0) {
    s_abort = 0;
    s_seq = *reinterpret_cast<const volatile unsigned long long*>(a.mesh.state);
  }
  block_sync();
  const unsigned long long base = s_seq << 32;
  const float* acts = a.acts[t.ls];
  const float* W = a.wrec[t.ls] + static_cast<size_t>(d) * a.H * 4 * a.w;
  const float* y_own = a.y[a.mesh.gpu];
  const float* p = a.peep[t.ls] + d * 3 * a.w;
  const float p_ig = p[cellc], p_fg = p[a.w + cellc], p_og = p[2 * a.w + cellc];
  if (a.w_smem) {
    for (int i = tid; i < a.H * 4 * kTpCells; i += kTpThreads) {
      const int q = (i / kTpCells) % 4, k = i / (4 * kTpCells);
      const int col = min(t.ct * kTpCells + i % kTpCells, a.w - 1);
      ws[i] = W[static_cast<size_t>(k) * 4 * a.w + q * a.w + col];
    }
    block_sync();
  }
  float c = 0.f;
  for (int s = 0; s < a.T; ++s) {
    float g[4] = {0.f, 0.f, 0.f, 0.f};
    if (s > 0) {
      if (!wait_slots(a.mesh, slots, nw, base | static_cast<unsigned>(s), s,
                      &s_abort))
        break;
      const int tp = d == 0 ? s - 1 : a.T - s;  // h_prev's time
      for (int i = tid; i < kTpRows * a.H; i += kTpThreads) {
        const int rr = i / a.H, k = i - rr * a.H, b = t.rg * kTpRows + rr;
        hs[i] = b < a.B ? __ldcg(y_own + (static_cast<size_t>(tp) * a.B + b) *
                                             DH + d * a.H + k)
                        : 0.f;
      }
      block_sync();
      const float* hr = hs + r * a.H;
      if (a.w_smem) {
        const float* wl = ws + l;
        for (int k = 0; k < a.H; ++k, wl += 4 * kTpCells) {
          const float hk = hr[k];
          g[0] = fmaf(hk, wl[0], g[0]);
          g[1] = fmaf(hk, wl[kTpCells], g[1]);
          g[2] = fmaf(hk, wl[2 * kTpCells], g[2]);
          g[3] = fmaf(hk, wl[3 * kTpCells], g[3]);
        }
      } else {
        const float* wk = W + cellc;
        for (int k = 0; k < a.H; ++k, wk += 4 * a.w) {
          const float hk = hr[k];
          g[0] = fmaf(hk, __ldg(wk), g[0]);
          g[1] = fmaf(hk, __ldg(wk + a.w), g[1]);
          g[2] = fmaf(hk, __ldg(wk + 2 * a.w), g[2]);
          g[3] = fmaf(hk, __ldg(wk + 3 * a.w), g[3]);
        }
      }
    }
    const size_t at = (static_cast<size_t>(s) * a.D + d) * a.B + rowc;
    const float* ap = acts + at * 4 * a.w + cellc;
    const float ni = tanh2_exact(ap[0] + g[0]);
    const float ig = logistic_exact(ap[a.w] + g[1] + c * p_ig);
    const float fg = logistic_exact(ap[2 * a.w] + g[2] + c * p_fg);
    const float cn = ni * ig + fg * c;
    const float og = logistic_exact(ap[3 * a.w] + g[3] + cn * p_og);
    const float h = tanh2_exact(cn) * og;
    const float m = a.mask[at];
    c = cn * m;
    const float hm = h * m;
    if (kSave && on) {
      a.c_save[t.ls][at * a.w + cellc] = c;
      float* gs = a.g_save[t.ls] + at * 4 * a.w + cellc;
      gs[0] = ni * m;
      gs[a.w] = ig * m;
      gs[2 * a.w] = fg * m;
      gs[3 * a.w] = og * m;
    }
    const int tt = d == 0 ? s : a.T - 1 - s;
    const size_t o = (static_cast<size_t>(tt) * a.B + rowc) * DH + hcol;
    for (int gi = 0; gi < a.mesh.gpus; ++gi)
      if (on) a.y[gi][o] = hm;
    publish(a.mesh, mine, base | static_cast<unsigned>(s + 1));
  }
  // the group's last step, so that this GPU's replica is whole at the end
  if (s_abort == 0)
    wait_slots(a.mesh, slots, nw, base | static_cast<unsigned>(a.T), a.T,
               &s_abort);
  finish(a.mesh, s_seq);
}

__global__ void __launch_bounds__(kTpThreads)
    tp_bptt_kernel(const TpBwdArgs a) {
  __shared__ float sda[kTpRows][4][kTpCells];  // the tile's deltas
  // with w_smem, the tile's rows of W_rec^T [4][kTpCells][H] (zero past
  // the shard's last cell) for the whole loop
  extern __shared__ float wts[];
  __shared__ int s_abort;
  __shared__ unsigned long long s_seq;
  const int tid = threadIdx.x, r = tid / kTpCells, l = tid % kTpCells;
  const Tile t = tile_of(blockIdx.x, a.w, a.B, a.D);
  const int shard = a.shard[t.ls], d = t.d;
  const int row = t.rg * kTpRows + r, cell = t.ct * kTpCells + l;
  const bool on = row < a.B && cell < a.w;
  // every lane computes (a padding lane on the last row or cell), and
  // only the stores are masked: no branch around a block barrier
  const int rowc = min(row, a.B - 1), cellc = min(cell, a.w - 1);
  const int hcol = shard * a.w + cellc;  // the cell's column in H
  const int nw = a.n * t.nct;
  const int me = shard * t.nct + t.ct;
  const int slots = (d * t.nrg + t.rg) * nw;
  const int ncell = min(kTpCells, a.w - t.ct * kTpCells);
  const size_t plane = static_cast<size_t>(a.D) * a.B * a.H;  // a writer's
  if (tid == 0) {
    s_abort = 0;
    s_seq = *reinterpret_cast<const volatile unsigned long long*>(a.mesh.state);
  }
  block_sync();
  const unsigned long long base = s_seq << 32;
  const float* gates = a.gates[t.ls];
  const float* cst = a.c[t.ls];
  const float* WT = a.wrec_t[t.ls] + static_cast<size_t>(d) * 4 * a.w * a.H;
  const float* p = a.peep[t.ls] + d * 3 * a.w;
  const float p_ig = p[cellc], p_fg = p[a.w + cellc], p_og = p[2 * a.w + cellc];
  if (a.w_smem) {
    for (int i = tid; i < 4 * kTpCells * a.H; i += kTpThreads) {
      const int k = i % a.H, j = (i / a.H) % kTpCells, q = i / (a.H * kTpCells);
      wts[i] = j < ncell ? WT[(static_cast<size_t>(q) * a.w + t.ct * kTpCells +
                               j) * a.H + k]
                         : 0.f;
    }
    block_sync();
  }
  // the step before in BPTT order: its clipped deltas, cell-state error
  // and forget gate, all times its validity
  float dn[4] = {0.f, 0.f, 0.f, 0.f}, cse = 0.f, fgn = 0.f;
  for (int it = 0; it < a.T; ++it) {
    const int s = a.T - 1 - it;
    const size_t at = (static_cast<size_t>(s) * a.D + d) * a.B + rowc;
    float e = a.dy[t.ls][at * a.w + cellc];
    if (it > 0) {
      if (!wait_slots(a.mesh, slots, nw, base | static_cast<unsigned>(it),
                      it, &s_abort))
        break;
      const float* pp = a.part[a.mesh.gpu] +
                        static_cast<size_t>((it - 1) & 1) * nw * plane +
                        (static_cast<size_t>(d) * a.B + rowc) * a.H + hcol;
      for (int j = 0; j < nw; ++j) e += __ldcg(pp + j * plane);
    }
    float da[4];
    const float* gp = gates + at * 4 * a.w + cellc;
    const float ni = gp[0], ig = gp[a.w], fg = gp[2 * a.w], og = gp[3 * a.w];
    const float cc = cst[at * a.w + cellc];
    const float c_prev =
        s > 0 ? cst[(at - static_cast<size_t>(a.D) * a.B) * a.w + cellc] : 0.f;
    const float m = a.mask[at];
    const float tanh_c = tanh2_exact(cc);
    const float og_delta = og * (1.0f - og) * tanh_c * e;
    const float cs_err = og * (1.0f - tanh_c * tanh_c) * e + p_og * og_delta +
                         fgn * cse + p_ig * dn[1] + p_fg * dn[2];
    da[0] = ig * (1.0f - ni * ni) * cs_err;
    da[1] = ig * (1.0f - ig) * ni * cs_err;
    da[2] = fg * (1.0f - fg) * c_prev * cs_err;
    da[3] = og_delta;
    float* out = a.da[t.ls] + at * 4 * a.w + cellc;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (a.clip) da[q] = fminf(fmaxf(da[q], -1.0f), 1.0f);
      da[q] *= m;
      dn[q] = da[q];
      if (on) out[q * a.w] = da[q];
      sda[r][q][l] = on ? da[q] : 0.f;
    }
    cse = cs_err * m;
    fgn = fg * m;
    block_sync();
    if (s == 0) break;  // no step before the first
    // the partial error of step s - 1 over all H, each column to its owner
    float* mine = nullptr;
    for (int k = tid; k < a.H; k += kTpThreads) {
      float acc[kTpRows];
#pragma unroll
      for (int q = 0; q < kTpRows; ++q) acc[q] = 0.f;
      const float* wk = WT + static_cast<size_t>(t.ct) * kTpCells * a.H + k;
      for (int q = 0; q < 4; ++q) {
        const float* wq = wk + static_cast<size_t>(q) * a.w * a.H;
        const float* wsq = wts + q * kTpCells * a.H + k;
        for (int j = 0; j < ncell; ++j) {
          const float wv = a.w_smem ? wsq[j * a.H]
                                    : __ldg(wq + static_cast<size_t>(j) * a.H);
#pragma unroll
          for (int rr = 0; rr < kTpRows; ++rr)
            acc[rr] = fmaf(sda[rr][q][j], wv, acc[rr]);
        }
      }
      mine = a.part[a.owner[k / a.w]] + static_cast<size_t>(it & 1) * nw *
                                            plane +
             static_cast<size_t>(me) * plane +
             (static_cast<size_t>(d) * a.B + t.rg * kTpRows) * a.H + k;
#pragma unroll
      for (int rr = 0; rr < kTpRows; ++rr)
        if (t.rg * kTpRows + rr < a.B) mine[static_cast<size_t>(rr) * a.H] =
            acc[rr];
    }
    publish(a.mesh, slots + me, base | static_cast<unsigned>(it + 1));
  }
  finish(a.mesh, s_seq);
}

// A K8 launch's plan at width H on `device`: the dynamic shared memory a
// block takes (K8f: the h_prev rows, plus the tile's W_rec columns where
// they fit; K8b: the tile's W_rec^T rows where they fit), whether W is on
// chip, and the blocks of that kernel the card holds at once. Asked once
// per (kernel, device, H): the launch path makes no query that a stream
// capture could refuse after the first launch. The dynamic shared memory
// above 48 KB needs the attribute, set once per device to the card's
// opt-in limit less the kernel's static shared memory.
struct TpPlan {
  size_t smem;
  int w_smem, blocks;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel k, int smem_max, int* dyn_max) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return err;
  *dyn_max = smem_max - static_cast<int>(fa.sharedSizeBytes);
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *dyn_max);
}

cudaError_t tp_plan(bool bwd, int H, int device, TpPlan* plan) {
  struct Seen {
    bool bwd;
    int device, H;
    TpPlan plan;
  };
  static std::mutex mu;
  static Seen seen[64];
  static int n_seen = 0;
  static int dyn[64][2] = {};  // the dynamic limit (K8f, K8b), 0 unset
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].bwd == bwd && seen[i].device == device && seen[i].H == H) {
      *plan = seen[i].plan;
      return cudaSuccess;
    }
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (dyn[device][0] == 0) {
    int smem_max = 0, lim = 0;
    err = cudaDeviceGetAttribute(
        &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    for (auto k : {tp_rec_kernel<true>, tp_rec_kernel<false>}) {
      err = allow_smem(k, smem_max, &lim);
      if (err != cudaSuccess) return err;
      if (dyn[device][0] == 0 || lim < dyn[device][0]) dyn[device][0] = lim;
    }
    err = allow_smem(tp_bptt_kernel, smem_max, &dyn[device][1]);
    if (err != cudaSuccess) return err;
  }
  const size_t w_bytes = sizeof(float) * 4 * kTpCells * H;
  const size_t base = bwd ? 0 : sizeof(float) * kTpRows * H;
  TpPlan p;
  p.w_smem = base + w_bytes <= static_cast<size_t>(dyn[device][bwd ? 1 : 0]);
  p.smem = base + (p.w_smem ? w_bytes : 0);
  if (bwd)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tp_bptt_kernel, kTpThreads, p.smem);
  else  // the save variant: the larger of the two
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tp_rec_kernel<true>, kTpThreads, p.smem);
  if (err != cudaSuccess) return err;
  p.blocks = per_sm * sms;
  *plan = p;
  if (n_seen < 64) seen[n_seen++] = {bwd, device, H, p};
  return cudaSuccess;
}

int tiles(int nloc, int D, int B, int w) {
  return nloc * D * ((B + kTpRows - 1) / kTpRows) *
         ((w + kTpCells - 1) / kTpCells);
}

// Checks the mesh's shape; the flag slots the launch needs.
bool mesh_ok(const TpMesh& m, int nloc, int T, int B, int H, int D, int w,
             int n) {
  if (T < 1 || B < 1 || H < 1 || D < 1 || D > 2 || w < 1 || n < 1) return false;
  if (nloc < 1 || nloc > kTpMaxLocal || n > kTpMaxShards || w * n != H)
    return false;
  if (m.gpus < 1 || m.gpus > kTpMaxGpus || m.gpu < 0 || m.gpu >= m.gpus)
    return false;
  const int nw = n * ((w + kTpCells - 1) / kTpCells);
  if (nw > kTpThreads) return false;
  const long long need =
      static_cast<long long>(D) * ((B + kTpRows - 1) / kTpRows) * nw;
  return need <= m.n_flags && T < (1 << 30);
}

}  // namespace

extern "C" {

// Peer access from GPU a to GPU b (a no-op where it is already on);
// cudaErrorPeerAccessUnsupported where the pair has none. The caller's
// current device is restored.
int lstm_tp_peer(int a, int b) {
  int ok = 0, prev = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&ok, a, b);
  if (err != cudaSuccess) return err;
  if (!ok) return cudaErrorPeerAccessUnsupported;
  err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(a);
  if (err != cudaSuccess) return err;
  err = cudaDeviceEnablePeerAccess(b, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    err = cudaSuccess;
  }
  const cudaError_t back = cudaSetDevice(prev);
  return err != cudaSuccess ? err : back;
}

// Host memory the kernels write and the host reads without a copy (the
// error records), zeroed; null on failure.
void* lstm_tp_host_alloc(size_t bytes) {
  void* p = nullptr;
  if (cudaHostAlloc(&p, bytes, cudaHostAllocMapped | cudaHostAllocPortable) !=
      cudaSuccess)
    return nullptr;
  memset(p, 0, bytes);
  return p;
}

// K8f on this GPU. Arrays of length nloc: the local shards' mesh indices,
// acts, wrec, peep and (save: both non-null) c_save, g_save; of length
// gpus: every GPU's output y and flag array. state, err: this GPU's.
int lstm_tp_fwd(int nloc, const int* shard, const float* const* acts,
                const float* const* wrec, const float* const* peep,
                float* const* c_save, float* const* g_save, const float* mask,
                float* const* y, unsigned long long* const* flags,
                unsigned long long* state, int* err_rec, int n_flags,
                int gpus, int gpu, int layer, double bound_s, int T, int B,
                int H, int D, int w, int n, int save, int device,
                cudaStream_t stream) {
  TpFwdArgs a = {};
  a.mesh.state = state;
  a.mesh.err = err_rec;
  a.mesh.bound_ns = static_cast<long long>(bound_s * 1e9);
  a.mesh.n_flags = n_flags;
  a.mesh.gpus = gpus;
  a.mesh.gpu = gpu;
  a.mesh.layer = layer;
  if (!mesh_ok(a.mesh, nloc, T, B, H, D, w, n)) return cudaErrorInvalidValue;
  for (int g = 0; g < gpus; ++g) {
    a.mesh.flags[g] = flags[g];
    a.y[g] = y[g];
  }
  for (int i = 0; i < nloc; ++i) {
    a.shard[i] = shard[i];
    a.acts[i] = acts[i];
    a.wrec[i] = wrec[i];
    a.peep[i] = peep[i];
    a.c_save[i] = save ? c_save[i] : nullptr;
    a.g_save[i] = save ? g_save[i] : nullptr;
    if (shard[i] < 0 || shard[i] >= n) return cudaErrorInvalidValue;
  }
  a.mask = mask;
  a.T = T;
  a.B = B;
  a.H = H;
  a.D = D;
  a.w = w;
  a.n = n;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  TpPlan plan;
  err = tp_plan(false, H, device, &plan);
  if (err != cudaSuccess) return err;
  const int blocks = tiles(nloc, D, B, w);
  if (blocks > plan.blocks) return cudaErrorCooperativeLaunchTooLarge;
  a.w_smem = plan.w_smem;
  if (save)
    tp_rec_kernel<true><<<blocks, kTpThreads, plan.smem, stream>>>(a);
  else
    tp_rec_kernel<false><<<blocks, kTpThreads, plan.smem, stream>>>(a);
  return cudaGetLastError();
}

// K8b on this GPU. Arrays of length nloc: the local shards' mesh indices,
// gates, c (K8f's save), wrec_t [D, 4, w, H], peep, dy, da; owner: each
// of the n shards' GPU index; of length gpus: every GPU's partial buffer
// [2, n ceil(w / 32), D, B, H] and flag array.
int lstm_tp_bwd(int nloc, const int* shard, const int* owner,
                const float* const* gates, const float* const* c,
                const float* const* wrec_t, const float* const* peep,
                const float* const* dy, float* const* da, const float* mask,
                float* const* part, unsigned long long* const* flags,
                unsigned long long* state, int* err_rec, int n_flags,
                int gpus, int gpu, int layer, double bound_s, int T, int B,
                int H, int D, int w, int n, int clip, int device,
                cudaStream_t stream) {
  TpBwdArgs a = {};
  a.mesh.state = state;
  a.mesh.err = err_rec;
  a.mesh.bound_ns = static_cast<long long>(bound_s * 1e9);
  a.mesh.n_flags = n_flags;
  a.mesh.gpus = gpus;
  a.mesh.gpu = gpu;
  a.mesh.layer = layer;
  if (!mesh_ok(a.mesh, nloc, T, B, H, D, w, n)) return cudaErrorInvalidValue;
  for (int g = 0; g < gpus; ++g) {
    a.mesh.flags[g] = flags[g];
    a.part[g] = part[g];
  }
  for (int i = 0; i < n; ++i) {
    if (owner[i] < 0 || owner[i] >= gpus) return cudaErrorInvalidValue;
    a.owner[i] = static_cast<signed char>(owner[i]);
  }
  for (int i = 0; i < nloc; ++i) {
    if (shard[i] < 0 || shard[i] >= n) return cudaErrorInvalidValue;
    a.shard[i] = shard[i];
    a.gates[i] = gates[i];
    a.c[i] = c[i];
    a.wrec_t[i] = wrec_t[i];
    a.peep[i] = peep[i];
    a.dy[i] = dy[i];
    a.da[i] = da[i];
  }
  a.mask = mask;
  a.T = T;
  a.B = B;
  a.H = H;
  a.D = D;
  a.w = w;
  a.n = n;
  a.clip = clip;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  TpPlan plan;
  err = tp_plan(true, H, device, &plan);
  if (err != cudaSuccess) return err;
  const int blocks = tiles(nloc, D, B, w);
  if (blocks > plan.blocks) return cudaErrorCooperativeLaunchTooLarge;
  a.w_smem = plan.w_smem;
  tp_bptt_kernel<<<blocks, kTpThreads, plan.smem, stream>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
