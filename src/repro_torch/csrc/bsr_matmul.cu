// Balanced block-sparse GEMM (the paper's 'gemmt' multiply-adder tree):
// output block j = sum_t x[:, idx[j,t]*bk : +bk] @ blocks[j,t]; pruned
// k-blocks are never read.
//
// Replaces: src/repro/kernels/bsr_matmul.py::bsr_matmul (_bsr_kernel). On
// the TPU the (n_pb, nnz) index table is a scalar-prefetch operand that
// steers the x BlockSpec; here each CTA reads its own row of the int32
// table from device memory and walks only the listed k-blocks.
//
// Bound on the H100: at decode the gathered weight blocks ((1 - sparsity)
// of the dense bytes) dominate, so it is memory-bound and its floor scales
// with the kept fraction; at prefill the f32 FMAs bound it. Design: the
// shared tiled mainloop with one segment per kept k-block, column tiles
// that never straddle two output blocks, and masking for any bk, bn.
#include "gemm_tile.cuh"

namespace {

template <typename T>
struct BsrSrc {
  const T* blocks;
  const int* idx;
  int n_pb, nnz, bk, bn, tn;
  int col0, ncols, nseg, j, c0;
  __host__ __device__ int n_tiles() const { return n_pb * ((bn + tn - 1) / tn); }
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
int run(const void* x, const void* blocks, const int* idx, void* y, int m, int n, int n_pb,
        int nnz, int bk, int bn, void* stream) {
  BsrSrc<T> src{};
  src.blocks = static_cast<const T*>(blocks);
  src.idx = idx;
  src.n_pb = n_pb;
  src.nnz = nnz;
  src.bk = bk;
  src.bn = bn;
  return rt::launch_gemm<T>(x, m, n, y, n_pb * bn, src, stream);
}

}  // namespace

extern "C" int bsr_matmul_launch(const void* x, const void* blocks, const void* idx, void* y,
                                 int m, int n, int n_pb, int nnz, int bk, int bn, int is_bf16,
                                 void* stream) {
  const int* ip = static_cast<const int*>(idx);
  return is_bf16 ? run<__nv_bfloat16>(x, blocks, ip, y, m, n, n_pb, nnz, bk, bn, stream)
                 : run<float>(x, blocks, ip, y, m, n, n_pb, nnz, bk, bn, stream);
}
