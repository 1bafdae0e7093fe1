// The parts that the LSTM recurrences of lstm_fwd.cu (rec_body) and
// lstm_bwd.cu (bptt_body) share, for NVIDIA Hopper (sm_90a): the cluster
// plan, the layout of the operand each step exchanges, the thread-block
// cluster primitives (DSMEM stores, the split cluster barrier), the
// cluster launch, and the CURRENNT activations.
//
// The plan. One recurrence (one direction, one group of kRecRows rows)
// runs on a cluster of n CTAs. CTA i owns a slice of the H cells, as even
// as can be (H = 125 at n = 8: five slices of 16, three of 15), and keeps
// the part of W_rec that those cells need in its shared memory for the
// whole time loop: the forward the 4|J_i| gate columns of W_rec[d], the
// BPTT the |J_i| rows of W_rec[d] (columns of W_rec^T). n aims at
// kCellsPerCta cells a CTA, four warps: a lane's share of a step's product
// is then one cell's k slice, and fewer cells per CTA would leave warp
// schedulers idle. A slice that does not fit beside the operand buffers
// is read from L2 with the same body (f32 at H = 512). ops/lstm_cell.py
// `recurrence_plan` mirrors rec_plan; a CPU test reads the constants
// below from this file.
//
// Inside a CTA, lane r of each group of kLanesPerCell lanes runs the cell
// update (forward) or the cell-error step (BPTT) of (row r, the group's
// cell), with the state in its registers. The step's product before it
// splits k over lanes and ends in a reduce-scatter of warp shuffles that
// leaves each lane with its (row, cell)'s sums: no round trip through
// shared memory and no block barrier. The forward splits k over the
// group (a lane sums one cell's four gate columns for the 8 rows); the
// BPTT, whose product has one output column per cell, over the warp (a
// lane sums the warp's four cells), so that each operand value read from
// shared memory serves four columns in both.
//
// Each step the CTAs exchange their slice of the next step's operand (h
// forward, the rounded deltas backward) by stores into every peer's
// shared memory (st.shared::cluster), into the buffer of the step's
// parity, and meet at one cluster barrier (arrive.release / wait.acquire,
// with the step's global stores in between). The parity buffers keep a
// peer's reads of step s - 1 apart from the writes of step s: a CTA
// writes step s only after every CTA has arrived at the end of step s - 1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <mutex>
#include <type_traits>

#include "gemm.cuh"

namespace {

// Rows of one cluster's group; row r of the cell phase is lane r of a
// group, so the two counts are one.
constexpr int kRecRows = 8;
constexpr int kLanesPerCell = 8;
constexpr int kCellsPerWarp = 32 / kLanesPerCell;
// Cells a CTA aims at (four warps), the largest cluster (16 needs the
// non-portable cluster size), and the most threads a CTA may have.
constexpr int kCellsPerCta = 16;
constexpr int kMaxCluster = 16;
constexpr int kRecMaxThreads = 512;
// Floats of one k quad of the operand buffer: four k of kRecRows rows,
// then 4 floats of padding, so that the 16-byte reads of the product are
// free of bank conflicts (op_off).
constexpr int kQuadFloats = 36;

static_assert(kRecRows == kLanesPerCell, "row r of the cell phase is lane r");

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

struct RecPlan {
  int n;       // CTAs of the cluster
  int cmax;    // cells of the largest slice
  int threads; // kLanesPerCell lanes per cell, cells rounded to a warp's
  int kp;      // k range of the product, zero-padded
  int ws;      // k entries of one cell's row of the W slice
  size_t op;   // floats of one operand buffer (one parity)
  size_t w;    // bytes of the W slice
};

// bwd: the BPTT (K = 4H gate columns, W_rec rows); else the forward
// (K = H, W_rec gate columns). wbytes: sizeof the compute dtype (the
// forward's W slice is held in it).
__host__ __device__ inline RecPlan rec_plan(int H, int wbytes, bool bwd) {
  RecPlan p;
  int n = (H + kCellsPerCta - 1) / kCellsPerCta;
  p.n = n < 1 ? 1 : (n > kMaxCluster ? kMaxCluster : n);
  p.cmax = (H + p.n - 1) / p.n;
  const int cpad = round_up(p.cmax, kCellsPerWarp);
  p.threads = cpad * kLanesPerCell;
  if (bwd) {
    // a lane of a warp reads the k quads lane, lane + 32, ... of its
    // warp's four cells' rows, held in f32 in both modes
    p.kp = round_up(4 * H, 4 * 32);
    p.ws = p.kp;
    p.w = static_cast<size_t>(cpad) * p.ws * sizeof(float);
  } else {
    // a lane reads k = ks, ks + 8, ...: the four gates of one k at once
    // (bf16: k steps of 16 on the tensor cores)
    p.kp = round_up(H, 2 * kLanesPerCell);
    p.ws = round_up(H, 16) + 8;
    p.w = static_cast<size_t>(cpad) * p.ws * 4 * wbytes;
  }
  p.op = static_cast<size_t>(p.kp / 4) * kQuadFloats;
  return p;
}

// bytes of the two parity buffers (the state every route keeps on chip)
__host__ __device__ inline size_t rec_state_bytes(const RecPlan& p) {
  return 2 * p.op * sizeof(float);
}

// The plan's route on `device`: *smem receives the dynamic shared memory
// a CTA takes and *on_chip whether W_rec's slice is in it (else each step
// reads it from L2). A state that does not fit, or more threads than a
// CTA takes, is refused.
inline cudaError_t rec_route(const RecPlan& p, int device, size_t* smem,
                             bool* on_chip) {
  int smem_max = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t state = rec_state_bytes(p);
  const size_t cap = static_cast<size_t>(smem_max);
  if (p.threads > kRecMaxThreads || state > cap) return cudaErrorInvalidValue;
  *on_chip = state + p.w <= cap;
  *smem = *on_chip ? state + p.w : state;
  return cudaSuccess;
}

// The cells [start, start + count) of CTA `rank`.
__host__ __device__ inline void rec_slice(int H, int n, int rank, int& start,
                                          int& count) {
  const int base = H / n, extra = H % n;
  count = base + (rank < extra ? 1 : 0);
  start = rank * base + (rank < extra ? rank : extra);
}

// offset (floats) of operand k's kRecRows rows in a parity buffer
__device__ __forceinline__ int op_off(int k) {
  return (k >> 2) * kQuadFloats + (k & 3) * kRecRows;
}

// ------------------------------------------------- cluster primitives
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the address of the same shared-memory word in CTA `rank` of the cluster
__device__ __forceinline__ unsigned peer_addr(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_peer(unsigned addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The launch: grid (n, groups, D), a cluster of n along x. A cluster size
// above 8 needs the non-portable attribute; a shape that no cluster of the
// card can hold is refused (cudaOccupancyMaxActiveClusters), and nothing
// falls back. The attributes are set once per kernel and device (the
// dynamic shared memory to the card's opt-in limit, so that no launch
// lowers what another needs) and the check runs once per kernel, device
// and configuration: the host's time per launch is on the critical path
// of the carry kernels' many short launches. `active` (if given) receives
// the clusters the card holds at once; with `query` set, nothing is
// launched.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), const RecPlan& p,
                           size_t smem, dim3 grid, cudaStream_t stream,
                           int* active, bool query, Args... args) {
  struct Checked {
    const void* kernel;
    int device, n, threads;
    size_t smem;
    int clusters;
  };
  static std::mutex mu;
  static Checked seen[64];
  static int n_seen = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.n, 1, 1);
  cfg.blockDim = dim3(p.threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const void* key = reinterpret_cast<const void*>(kernel);
  int clusters = -1;
  {
    std::lock_guard<std::mutex> lock(mu);
    bool attrs_set = false;
    for (int i = 0; i < n_seen; ++i) {
      const Checked& c = seen[i];
      if (c.kernel != key || c.device != device) continue;
      attrs_set = true;
      if (c.n == p.n && c.threads == p.threads && c.smem == smem)
        clusters = c.clusters;
    }
    if (!attrs_set) {
      int smem_max = 0;
      err = cudaDeviceGetAttribute(
          &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
      if (err != cudaSuccess) return err;
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
      if (err != cudaSuccess) return err;
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
    }
    if (clusters < 0) {
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (err != cudaSuccess) return err;
      if (n_seen < 64)
        seen[n_seen++] = {key, device, p.n, p.threads, smem, clusters};
    }
  }
  if (active != nullptr) *active = clusters;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  if (query) return cudaSuccess;
  cfg.gridDim = grid;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ------------------------------------------------------- activations
constexpr float kExpLimit = 88.722839f;

// 1 / (1 + e^-x): __frcp_rn is the correctly rounded reciprocal, so it
// gives the bits of the IEEE division without its call
__device__ __forceinline__ float sigmoid_plain(float x) {
  return __frcp_rn(1.0f + expf(-x));
}

// CURRENNT's logistic: hard saturation at +-kExpLimit
__device__ __forceinline__ float logistic_exact(float x) {
  if (x >= kExpLimit) return 1.0f;
  if (x <= -kExpLimit) return 0.0f;
  return __frcp_rn(1.0f + expf(-x));
}

__device__ __forceinline__ float tanh2_exact(float x) {
  return 2.0f * logistic_exact(2.0f * x) - 1.0f;
}

// four adjacent entries as floats (16-byte f32 or 8-byte bf16 load)
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

constexpr unsigned kFull = 0xffffffffu;

// two f32 values of bf16 precision as a bf16x2 word (lo in the low half)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// d += A . B on the tensor cores: mma m16n8k16, bf16 operands, f32
// accumulators (A: 16 x 16 row-major in the lane's four words, B: 16 x 8
// in two)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// One reduce-scatter step of a group: the lanes whose `bit` is set keep
// the upper half of the values, the others the lower; each sends the half
// it gives up to its partner and adds the half it receives.
template <int kHalf>
__device__ __forceinline__ void fold_half(float* v, int bit, bool upper) {
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? v[i] : v[i + kHalf];
    const float keep = upper ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, bit);
  }
}

}  // namespace
