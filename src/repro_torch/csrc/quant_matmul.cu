// Block-sparse x quantized GEMM (the paper's sparsity x precision point):
// walks only the listed k-blocks, unpacks w8/w4/w2/w1 codes in-kernel,
// accumulates in f32 and applies the per-output-channel scale once, in
// f32, at flush. Output in x's dtype.
//
// Replaces: src/repro/kernels/quant_matmul.py::bsr_quant_matmul
// (_bsr_wq_kernel, with _unpack_tile's bit layout: codes packed along k,
// value i of a byte at bit offset i*bits, two's complement, and a sign bit
// {0 -> -1, 1 -> +1} for 1-bit).
//
// Bound on the H100: at decode the packed code bytes ((1 - sparsity) *
// bits / 8 bytes per weight) dominate, so it is memory-bound with a floor
// far below the dense kernel's; at prefill the f32 FMAs bound it. Design:
// the shared tiled mainloop; each weight element is unpacked from its byte
// while the tile is staged into shared memory, so no float weight ever
// exists in device memory.
#include "gemm_tile.cuh"

namespace {

template <typename T>
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
    const int8_t b = q[(((size_t)j * nnz + s) * (bk / vpb) + r / vpb) * bn + c0 + c];
    if (bits == 8) return static_cast<float>(b);
    const unsigned u = static_cast<uint8_t>(b);
    const int f = (u >> ((r % vpb) * bits)) & ((1u << bits) - 1u);
    if (bits == 1) return f ? 1.f : -1.f;
    const int sign = 1 << (bits - 1);
    return static_cast<float>((f ^ sign) - sign);
  }
  __device__ float scale(int c) const { return scales[j * bn + c0 + c]; }
};

template <typename T>
int run(const void* x, const void* q, const float* scales, const int* idx, void* y, int m, int n,
        int n_pb, int nnz, int bk, int bn, int bits, void* stream) {
  QBsrSrc<T> src{};
  src.q = static_cast<const int8_t*>(q);
  src.scales = scales;
  src.idx = idx;
  src.n_pb = n_pb;
  src.nnz = nnz;
  src.bk = bk;
  src.bn = bn;
  src.bits = bits;
  src.vpb = 8 / bits;
  return rt::launch_gemm<T>(x, m, n, y, n_pb * bn, src, stream);
}

}  // namespace

extern "C" int bsr_quant_matmul_launch(const void* x, const void* qblocks, const void* scales,
                                       const void* idx, void* y, int m, int n, int n_pb, int nnz,
                                       int bk, int bn, int bits, int is_bf16, void* stream) {
  const float* sp = static_cast<const float*>(scales);
  const int* ip = static_cast<const int*>(idx);
  return is_bf16
             ? run<__nv_bfloat16>(x, qblocks, sp, ip, y, m, n, n_pb, nnz, bk, bn, bits, stream)
             : run<float>(x, qblocks, sp, ip, y, m, n, n_pb, nnz, bk, bn, bits, stream);
}
