// quant_matmul_w8a8 — int8 x int8 -> int32, dequantized by row scale x
// column scale at flush (acc_f32 * xs[row] * s[col], in that order).
// Replaces: src/repro/kernels/quant_matmul.py::quant_matmul_w8a8
// (_w8a8_kernel), together with the per-row activation quantization that
// the JAX wrapper runs in front of it: the codes and row scales are made on
// the card inside the launch, byte for byte those of
// quantize_activations_int8. Bound and design: gemm_int8.cuh (an int8
// cluster split-K GEMV at decode, one launch; a row-quantize kernel and an
// int8 tensor-core tile at prefill, two).
#include "gemm_int8.cuh"

namespace {

// form 0: the int8 GEMV on x itself; form 1: codes into xq (m, ldq) and
// scales into xs (m,), then the tensor-core tile
template <typename T>
int run_w8a8(const void* x, const void* w, const void* s, void* y, void* xq, void* xs, int m,
             int n, int p, int ldq, int form, int bm, int bn, int split, int k_per_split,
             int smem, void* stream) {
  const T* xp = static_cast<const T*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(s);
  T* yp = static_cast<T*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      form == 0 ? gk::launch_w8a8_gemv<T>(xp, m, n, wp, sp, yp, p, bm, bn, split, k_per_split,
                                          smem, st)
      : form == 1 ? gk::launch_w8a8_tile<T>(xp, m, n, wp, sp, yp, p, static_cast<int8_t*>(xq),
                                            static_cast<float*>(xs), ldq, bm, bn, split,
                                            k_per_split, smem, st)
                  : cudaErrorInvalidValue;
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

}  // namespace

// x in f32 or bf16, quantized per row inside the launch; xq / xs scratch of
// the prefill form (unused at decode); plan from gemm_plan.py::w8a8_plan
extern "C" int quant_matmul_w8a8_launch(const void* x, const void* w, const void* s, void* y,
                                        void* xq, void* xs, int m, int n, int p, int ldq,
                                        int is_bf16, int form, int bm, int bn, int split,
                                        int k_per_split, int smem, void* stream) {
  return is_bf16 ? run_w8a8<__nv_bfloat16>(x, w, s, y, xq, xs, m, n, p, ldq, form, bm, bn,
                                           split, k_per_split, smem, stream)
                 : run_w8a8<float>(x, w, s, y, xq, xs, m, n, p, ldq, form, bm, bn, split,
                                   k_per_split, smem, stream);
}
