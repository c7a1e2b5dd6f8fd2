// y = x @ w with an f32 accumulator, cast to x's dtype (f32 or bf16).
//
// Replaces: src/repro/kernels/dense_matmul.py::dense_matmul (_mm_kernel),
// the Pallas weight-stationary 'gemms' analogue.
//
// Bound on the H100: at decode (m = n_slots, a few rows) the weight stream
// (n * p elements read once) dominates, so the kernel is memory-bound; at
// prefill (m in the hundreds) the f32 FMAs on CUDA cores bound it.
// Design: two forms, chosen per call by the launch plan of
// kernels/gemm_plan.py. m <= 16 runs the cluster split-K GEMV of
// gemv_cluster.cuh (vector weight loads in flight on >= 132 CTAs, partials
// summed through distributed shared memory); larger m runs the pipelined
// 8 x 8-micro-tile SGEMM of gemm_pipe.cuh (3-stage cp.async ring). The
// weight source is gemm_src.cuh's Plain<T>.
#include "gemm_pipe.cuh"
#include "gemv_cluster.cuh"

namespace {

template <typename T>
int run(const void* x, const void* w, void* y, int m, int n, int p, int form, int bm, int bn,
        int split, int k_per_split, int smem, void* stream) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const auto src = gk::plain_source<T>(w, p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = form == 0
      ? gk::launch_gemv<T>(xp, m, n, n, yp, p, src, bm, bn, split, k_per_split, smem, st)
      : gk::launch_pipe<T>(xp, m, n, n, yp, p, src, bm, bn, split, k_per_split, smem, st);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

}  // namespace

// form, bm, bn, split, k_per_split, smem: the launch plan (gemm_plan.py)
extern "C" int dense_matmul_launch(const void* x, const void* w, void* y, int m, int n, int p,
                                   int is_bf16, int form, int bm, int bn, int split,
                                   int k_per_split, int smem, void* stream) {
  return is_bf16
      ? run<__nv_bfloat16>(x, w, y, m, n, p, form, bm, bn, split, k_per_split, smem, stream)
      : run<float>(x, w, y, m, n, p, form, bm, bn, split, k_per_split, smem, stream);
}
