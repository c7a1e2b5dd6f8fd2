// y = x @ w with an f32 accumulator, cast to x's dtype (f32 or bf16).
//
// Replaces: src/repro/kernels/dense_matmul.py::dense_matmul (_mm_kernel),
// the Pallas weight-stationary 'gemms' analogue.
//
// Bound on the H100: at decode (m = n_slots, a few rows) the weight stream
// (n * p elements read once) dominates, so the kernel is memory-bound; at
// prefill (m in the hundreds) the f32 FMAs on CUDA cores bound it.
// Design: the shared tiled mainloop (gemm_tile.cuh) with a 16-row tile for
// skinny m, which spreads the weight stream over p / 32 CTAs; no tensor
// cores, TMA or pipelining yet (later work).
#include "gemm_tile.cuh"

namespace {

template <typename T>
struct DenseSrc {
  const T* w;
  int n, p, tn;
  int col0, ncols, nseg;
  __host__ __device__ int n_tiles() const { return (p + tn - 1) / tn; }
  __device__ void setup(int bx) {
    col0 = bx * tn;
    ncols = min(tn, p - col0);
    nseg = 1;
  }
  __device__ int seg_x0(int) const { return 0; }
  __device__ int seg_len() const { return n; }
  __device__ float load(int, int r, int c) const { return rt::to_f32(w[(size_t)r * p + col0 + c]); }
  __device__ float scale(int) const { return 1.f; }
};

template <typename T>
int run(const void* x, const void* w, void* y, int m, int n, int p, void* stream) {
  DenseSrc<T> src{};
  src.w = static_cast<const T*>(w);
  src.n = n;
  src.p = p;
  return rt::launch_gemm<T>(x, m, n, y, p, src, stream);
}

}  // namespace

extern "C" int dense_matmul_launch(const void* x, const void* w, void* y, int m, int n, int p,
                                   int is_bf16, void* stream) {
  return is_bf16 ? run<__nv_bfloat16>(x, w, y, m, n, p, stream)
                 : run<float>(x, w, y, m, n, p, stream);
}
