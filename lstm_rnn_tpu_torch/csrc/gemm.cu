// The matrix-product engine (gemm.cuh) on its own: one C entry point that
// launches the instance the main path launches for a product, on operands
// the caller lays out, so that a test can hold every product against its
// plain twin (ops/gemm.py) at any shape; with x3, the 3x instance
// (gemm3x_kernel) on f32 operands. The 3x TIMIT tail launches tail_dh and
// tail_dW through it.
//
// Launch rules: the entry point launches on the caller's stream, allocates
// nothing, never synchronises, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm.cuh"

namespace {

// the uses, in ops/gemm.py's USES order
enum UseId { kProj, kDwIn, kDwRec, kDx, kTailDh, kTailDw };

template <typename T>
cudaError_t run(int use, const void* const (&as)[2],
                const void* const (&bs)[2], long long lda, int a_rows,
                int a_cols, const int (&shifts)[2], long long ldb, int b_rows,
                int b_cols, int M, int N, int K, int outputs, int nsplit,
                int ngroups, const float* bias, float bias_mult, float* part,
                void* out, bool x3, cudaStream_t stream) {
  GemmArgs<T> g{};
  for (int p = 0; p < 2; ++p) {
    g.a[p] = make_view<T>(as[p], lda, a_rows, a_cols, shifts[p]);
    g.b[p] = make_view<T>(bs[p], ldb, b_rows, b_cols);
  }
  g.M = M;
  g.N = N;
  g.K = K;
  g.nsplit = nsplit;
  g.ngroups = ngroups;
  const long long MN = static_cast<long long>(g.M) * g.N;
  const long long L = outputs * MN;
  cudaError_t err;
  switch (use) {
    case kProj:
      return launch_gemm<GemmProj, T, false, false, float>(
          g, outputs,
          EpiBias<float>{static_cast<float*>(out), bias, bias_mult, MN, g.N},
          stream, x3);
    case kDwIn:
      err = launch_gemm<GemmDwIn, T, true, false, float>(
          g, outputs, EpiPartial{part, L, MN, g.N}, stream, x3);
      break;
    case kDwRec:
      err = launch_gemm<GemmDwRec, T, true, false, float>(
          g, outputs, EpiPartial{part, L, MN, g.N}, stream, x3);
      break;
    case kTailDw:
      err = launch_gemm<GemmTailDw, T, true, false, float>(
          g, outputs, EpiPartial{part, L, MN, g.N}, stream, x3);
      break;
    case kDx:
      return launch_gemm<GemmDx, T, false, true, T>(
          g, 1, EpiStore<float>{static_cast<float*>(out), g.N}, stream, x3);
    case kTailDh:
      return launch_gemm<GemmTailDh, T, false, true, float>(
          g, 1, EpiStore<T>{static_cast<T*>(out), g.N}, stream, x3);
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return launch_sum_partials(part, g.nsplit, L, static_cast<float*>(out), L,
                             L, 1.0f, stream);
}

}  // namespace

extern "C" {

// One launch of the engine for `use` (0 proj, 1 dW_in, 2 dW_rec, 3 dx,
// 4 tail_dh, 5 tail_dW: the transposes, rounding and epilogue of that
// product on the main path). Pair p's operands are the Views (a_p, lda,
// a_rows, a_cols, a_shift_p) and (b_p, ldb, b_rows, b_cols, 0), both f32
// (bf16 = 0) or both bf16; x3 = 1 (f32 only) launches the 3x instance,
// f32 as three bf16 passes on the tensor cores. proj: out [outputs, M, N] f32, bias
// [outputs, N] f32; dW_in, dW_rec, tail_dW: part [nsplit, outputs, M, N]
// f32 scratch, out [outputs, M, N] f32, the partials summed in order;
// dx: out [M, N] f32, the sum of the ngroups pairs' products, each rounded
// to the operand dtype; tail_dh: out [M, N] in the operand dtype.
int gemm_run(int use, const void* a0, const void* a1, long long lda,
             int a_rows, int a_cols, int a_shift0, int a_shift1,
             const void* b0, const void* b1, long long ldb, int b_rows,
             int b_cols, int M, int N, int K, int outputs, int nsplit,
             int ngroups, const float* bias, float bias_mult, float* part,
             void* out, int bf16, int x3, int device, cudaStream_t stream) {
  if (M < 1 || N < 1 || K < 1 || outputs < 1 || outputs > 2 || nsplit < 1 ||
      ngroups < 1 || ngroups > 2)
    return cudaErrorInvalidValue;
  if ((ngroups > 1) != (use == kDx) || (ngroups > 1 && outputs != 1) ||
      (nsplit > 1 && use != kDwIn && use != kDwRec && use != kTailDw) ||
      (x3 && bf16))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const void* as[2] = {a0, a1 != nullptr ? a1 : a0};
  const void* bs[2] = {b0, b1 != nullptr ? b1 : b0};
  const int shifts[2] = {a_shift0, a_shift1};
  if (bf16)
    return run<__nv_bfloat16>(use, as, bs, lda, a_rows, a_cols, shifts, ldb,
                              b_rows, b_cols, M, N, K, outputs, nsplit,
                              ngroups, bias, bias_mult, part, out, false,
                              stream);
  return run<float>(use, as, bs, lda, a_rows, a_cols, shifts, ldb, b_rows,
                    b_cols, M, N, K, outputs, nsplit, ngroups, bias,
                    bias_mult, part, out, x3 != 0, stream);
}

}  // extern "C"
