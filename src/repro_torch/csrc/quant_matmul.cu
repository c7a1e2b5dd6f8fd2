// Two quantized GEMMs of the paper's precision axis (the third,
// quant_matmul_w8a8, is quant_matmul_w8a8.cu):
//
// quant_matmul — weight-only w8/w4/w2/w1 x float activations.
// Replaces: src/repro/kernels/quant_matmul.py::quant_matmul (_wq_kernel).
// Codes are packed along k with _unpack_tile's bit layout (value i of a
// byte at bit offset i*bits, two's complement, and a sign bit {0 -> -1,
// 1 -> +1} for 1-bit); the sum is taken in f32 and the per-output-channel
// scale applied once, in f32, after the whole contraction. Output in x's
// dtype. Bound on the H100: at decode the packed code bytes (bits / 8 bytes
// per weight) dominate, so it is memory-bound with a floor bits/32 of the
// f32 dense kernel's; at prefill the f32 FMAs bound it. Design: the same
// two forms as dense_matmul.cu over gemm_src.cuh's Codes<BITS> source, BITS
// a template constant dispatched once on the host. At decode
// (gemv_cluster.cuh) a thread reads one 32-bit word of codes (4 columns x
// vpb k values) and unpacks it with compile-time shifts, no byte read
// twice; at prefill (gemm_pipe.cuh) the code bytes of a stage are copied
// with cp.async and unpacked once into the f32 shared-memory tile, so the
// unpack is amortised over the CTA's rows. No float weight ever exists in
// device memory.
//
// bsr_quant_matmul — block-sparse x quantized (the sparsity x precision
// point): walks only the listed k-blocks.
// Replaces: src/repro/kernels/quant_matmul.py::bsr_quant_matmul
// (_bsr_wq_kernel). Same code layout and f32 flush. Bound on the H100: the
// packed code bytes of the listed blocks at decode, the f32 FMAs of the
// kept (1 - sparsity) share at prefill. Design: quant_matmul's two forms
// over gemm_src.cuh's QBlocks<BITS> source, whose column tile lies inside
// one block column and whose logical k is the concatenation of that
// column's listed blocks (x read through idx[j, t] * bk + kk): at decode
// the cluster split-K GEMV splits the listed packed rows over the CTAs of a
// cluster (a split may cut inside a block); at prefill the 3-stage cp.async
// tile takes one 16-deep stage inside one listed block, code bytes landing
// raw and unpacked once a stage. Shapes those forms do not take (a block
// narrower than the GEMV's 16-column tile, or at prefill bk % 16 != 0 or a
// block narrower than the 64-column tile) keep the tiled mainloop of
// gemm_tile.cuh (QBsrSrc below), each element unpacked while it is staged;
// kernels/gemm_plan.py::bsr_plan picks the form by shape.
#include "gemm_pipe.cuh"
#include "gemm_tile.cuh"
#include "gemv_cluster.cuh"

namespace {

__device__ __forceinline__ float unpack_code(int8_t b, int r, int bits, int vpb) {
  if (bits == 8) return static_cast<float>(b);
  const unsigned u = static_cast<uint8_t>(b);
  const int f = (u >> ((r % vpb) * bits)) & ((1u << bits) - 1u);
  if (bits == 1) return f ? 1.f : -1.f;
  const int sign = 1 << (bits - 1);
  return static_cast<float>((f ^ sign) - sign);
}

struct QBsrSrc {
  const int8_t* q;
  const float* scales;
  const int* idx;
  int n_pb, nnz, bk, bn, bits, vpb, tn;
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
    return unpack_code(q[(((size_t)j * nnz + s) * (bk / vpb) + r / vpb) * bn + c0 + c], r, bits,
                       vpb);
  }
  __device__ float scale(int c) const { return scales[j * bn + c0 + c]; }
};

template <typename T, int BITS>
int run_qt(const void* x, const void* q, const void* scales, void* y, int m, int n, int p,
           int form, int bm, int bn, int split, int k_per_split, int smem, void* stream) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const auto src = gk::codes_source<BITS>(q, scales, p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = form == 0
      ? gk::launch_gemv<T>(xp, m, n, n, yp, p, src, bm, bn, split, k_per_split, smem, st)
      : gk::launch_pipe<T>(xp, m, n, n, yp, p, src, bm, bn, split, k_per_split, smem, st);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

template <typename T>
int run_qt_bits(const void* x, const void* q, const void* scales, void* y, int m, int n, int p,
                int bits, int form, int bm, int bn, int split, int k_per_split, int smem,
                void* stream) {
  switch (bits) {
    case 8: return run_qt<T, 8>(x, q, scales, y, m, n, p, form, bm, bn, split, k_per_split, smem, stream);
    case 4: return run_qt<T, 4>(x, q, scales, y, m, n, p, form, bm, bn, split, k_per_split, smem, stream);
    case 2: return run_qt<T, 2>(x, q, scales, y, m, n, p, form, bm, bn, split, k_per_split, smem, stream);
    case 1: return run_qt<T, 1>(x, q, scales, y, m, n, p, form, bm, bn, split, k_per_split, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int BITS>
int run_bsr(const void* x, const void* q, const void* scales, const void* idx, void* y, int m,
            int n, int n_pb, int nnz, int bk, int bn, int form, int bm, int tbn, int split,
            int k_per_split, int smem, void* stream) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const auto src = gk::qblocks_source<BITS>(q, scales, idx, n_pb, nnz, bk, bn);
  const int p = n_pb * bn, kn = nnz * bk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = form == 0
      ? gk::launch_gemv<T>(xp, m, kn, n, yp, p, src, bm, tbn, split, k_per_split, smem, st)
      : gk::launch_pipe<T>(xp, m, kn, n, yp, p, src, bm, tbn, split, k_per_split, smem, st);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

template <typename T>
int run_bsr_bits(const void* x, const void* q, const void* scales, const void* idx, void* y,
                 int m, int n, int n_pb, int nnz, int bk, int bn, int bits, int form, int bm,
                 int tbn, int split, int k_per_split, int smem, void* stream) {
#define RUN_BSR(B)                                                                        \
  run_bsr<T, B>(x, q, scales, idx, y, m, n, n_pb, nnz, bk, bn, form, bm, tbn, split,      \
                k_per_split, smem, stream)
  switch (bits) {
    case 8: return RUN_BSR(8);
    case 4: return RUN_BSR(4);
    case 2: return RUN_BSR(2);
    case 1: return RUN_BSR(1);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RUN_BSR
}

}  // namespace

// form, bm, bn, split, k_per_split, smem: the launch plan (gemm_plan.py)
extern "C" int quant_matmul_launch(const void* x, const void* q, const void* scales, void* y,
                                   int m, int n, int p, int bits, int is_bf16, int form, int bm,
                                   int bn, int split, int k_per_split, int smem, void* stream) {
  return is_bf16 ? run_qt_bits<__nv_bfloat16>(x, q, scales, y, m, n, p, bits, form, bm, bn, split,
                                              k_per_split, smem, stream)
                 : run_qt_bits<float>(x, q, scales, y, m, n, p, bits, form, bm, bn, split,
                                      k_per_split, smem, stream);
}

// form 0 / 1: the GEMV / pipelined tile over QBlocks<BITS> (plan: bm, tbn
// the column tile, split, k_per_split over the logical k = nnz * bk, smem);
// form 2: the gemm_tile.cuh mainloop
extern "C" int bsr_quant_matmul_launch(const void* x, const void* qblocks, const void* scales,
                                       const void* idx, void* y, int m, int n, int n_pb, int nnz,
                                       int bk, int bn, int bits, int is_bf16, int form, int bm,
                                       int tbn, int split, int k_per_split, int smem,
                                       void* stream) {
  if (form != 2) {
    if (bn % tbn) return static_cast<int>(cudaErrorInvalidValue);
    return is_bf16 ? run_bsr_bits<__nv_bfloat16>(x, qblocks, scales, idx, y, m, n, n_pb, nnz, bk,
                                                 bn, bits, form, bm, tbn, split, k_per_split,
                                                 smem, stream)
                   : run_bsr_bits<float>(x, qblocks, scales, idx, y, m, n, n_pb, nnz, bk, bn,
                                         bits, form, bm, tbn, split, k_per_split, smem, stream);
  }
  QBsrSrc src{};
  src.q = static_cast<const int8_t*>(qblocks);
  src.scales = static_cast<const float*>(scales);
  src.idx = static_cast<const int*>(idx);
  src.n_pb = n_pb;
  src.nnz = nnz;
  src.bk = bk;
  src.bn = bn;
  src.bits = bits;
  src.vpb = 8 / bits;
  const int p = n_pb * bn;
  return is_bf16 ? rt::launch_gemm<__nv_bfloat16>(x, m, n, y, p, src, stream)
                 : rt::launch_gemm<float>(x, m, n, y, p, src, stream);
}
