// Balanced block-sparse GEMM (the paper's 'gemmt' multiply-adder tree):
// output block j = sum_t x[:, idx[j,t]*bk : +bk] @ blocks[j,t]; pruned
// k-blocks are never read.
//
// Replaces: src/repro/kernels/bsr_matmul.py::bsr_matmul (_bsr_kernel). On
// the TPU the (n_pb, nnz) index table is a scalar-prefetch operand that
// steers the x BlockSpec; here each CTA reads its own row of the int32
// table from device memory and walks only the listed k-blocks.
//
// Bound on the H100: at decode the listed weight blocks ((1 - sparsity) of
// the dense bytes) dominate, so it is memory-bound and its floor scales
// with the kept fraction; at prefill the f32 FMAs of the kept share bound
// it. Design: dense_matmul's two forms over gemm_src.cuh's Blocks<T>
// source, whose column tile lies inside one block column and whose logical
// k is the concatenation of that column's listed blocks (x read through
// idx[j, t] * bk + kk). At decode (m <= 16) the cluster split-K GEMV of
// gemv_cluster.cuh splits the listed rows over the CTAs of a cluster (a
// split may cut inside a block) and streams 16-byte f32 / 8-byte bf16
// quads; at prefill the 3-stage cp.async tile of gemm_pipe.cuh takes one
// 16-deep stage inside one listed block. Shapes those forms do not take (no
// GEMV column tile divides bn, or at prefill bk % 16 != 0 or no 64/128
// tile divides bn) keep the tiled mainloop of gemm_tile.cuh (BsrSrc
// below); kernels/gemm_plan.py::bsr_plan picks the form by shape.
//
// bsr_matmul_experts_launch runs the same product for every expert of an
// MoE layer in one launch (the JAX package vmaps bsr_matmul over its
// experts, which adds a grid axis to the Pallas call): the experts share
// the index table (the plan depends on the shape only), expert z's blocks
// are the z-th (n_pb, nnz, bk, bn) stack, its x the z-th (m, n) rows and
// its y the z-th (m, n_pb * bn) rows, and z is the grid's third axis in
// every form.
#include "gemm_pipe.cuh"
#include "gemm_tile.cuh"
#include "gemv_cluster.cuh"

namespace {

template <typename T>
struct BsrSrc {
  static constexpr bool BATCH = true;
  const T* blocks;
  const int* idx;
  int n_pb, nnz, bk, bn, tn;
  int col0, ncols, nseg, j, c0;
  __host__ __device__ int n_tiles() const { return n_pb * ((bn + tn - 1) / tn); }
  __device__ void batch(int z) { blocks += (size_t)z * n_pb * nnz * bk * bn; }
  __device__ void setup(int bx) {
    const int tpb = (bn + tn - 1) / tn;
    j = bx / tpb;
    c0 = (bx % tpb) * tn;
    col0 = j * bn + c0;
    ncols = min(tn, bn - c0);
    nseg = nnz;
  }
  __device__ int seg_x0(int s) const { return idx[j * nnz + s] * bk; }
  __device__ int seg_len() const { return bk; }
  __device__ float load(int s, int r, int c) const {
    return rt::to_f32(blocks[(((size_t)j * nnz + s) * bk + r) * bn + c0 + c]);
  }
  __device__ float scale(int) const { return 1.f; }
};

template <typename T>
int run(const void* x, const void* blocks, const int* idx, void* y, int batch, int m, int n,
        int n_pb, int nnz, int bk, int bn, int form, int bm, int tbn, int split, int k_per_split,
        int smem, void* stream) {
  const long long xb = (long long)m * n, yb = (long long)m * n_pb * bn;
  if (form == 2) {
    BsrSrc<T> src{};
    src.blocks = static_cast<const T*>(blocks);
    src.idx = idx;
    src.n_pb = n_pb;
    src.nnz = nnz;
    src.bk = bk;
    src.bn = bn;
    return rt::launch_gemm<T>(x, m, n, y, n_pb * bn, src, stream, batch, xb, yb);
  }
  if (bn % tbn) return static_cast<int>(cudaErrorInvalidValue);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const auto src = gk::blocks_source<T>(blocks, idx, n_pb, nnz, bk, bn);
  const int p = n_pb * bn, kn = nnz * bk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = form == 0
      ? gk::launch_gemv<T>(xp, m, kn, n, yp, p, src, bm, tbn, split, k_per_split, smem, st, batch,
                           xb, yb)
      : gk::launch_pipe<T>(xp, m, kn, n, yp, p, src, bm, tbn, split, k_per_split, smem, st, batch,
                           xb, yb);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

}  // namespace

// form 0 / 1: the GEMV / pipelined tile over Blocks<T> (plan: bm, tbn the
// column tile, split, k_per_split over the logical k = nnz * bk, smem);
// form 2: the gemm_tile.cuh mainloop
extern "C" int bsr_matmul_launch(const void* x, const void* blocks, const void* idx, void* y,
                                 int m, int n, int n_pb, int nnz, int bk, int bn, int is_bf16,
                                 int form, int bm, int tbn, int split, int k_per_split, int smem,
                                 void* stream) {
  const int* ip = static_cast<const int*>(idx);
  return is_bf16 ? run<__nv_bfloat16>(x, blocks, ip, y, 1, m, n, n_pb, nnz, bk, bn, form, bm,
                                      tbn, split, k_per_split, smem, stream)
                 : run<float>(x, blocks, ip, y, 1, m, n, n_pb, nnz, bk, bn, form, bm, tbn, split,
                              k_per_split, smem, stream);
}

// the same over a stack of `experts` products sharing idx: x (experts, m,
// n), blocks (experts, n_pb, nnz, bk, bn), y (experts, m, n_pb * bn); the
// plan is bsr_plan's with batch = experts
extern "C" int bsr_matmul_experts_launch(const void* x, const void* blocks, const void* idx,
                                         void* y, int experts, int m, int n, int n_pb, int nnz,
                                         int bk, int bn, int is_bf16, int form, int bm, int tbn,
                                         int split, int k_per_split, int smem, void* stream) {
  if (experts < 1 || experts > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int* ip = static_cast<const int*>(idx);
  return is_bf16 ? run<__nv_bfloat16>(x, blocks, ip, y, experts, m, n, n_pb, nnz, bk, bn, form,
                                      bm, tbn, split, k_per_split, smem, stream)
                 : run<float>(x, blocks, ip, y, experts, m, n, n_pb, nnz, bk, bn, form, bm, tbn,
                              split, k_per_split, smem, stream);
}
