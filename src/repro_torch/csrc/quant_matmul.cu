// The quantized GEMMs of the paper's precision axis, three kernels:
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
// (_bsr_wq_kernel). Same code layout and f32 flush; the shared tiled
// mainloop of gemm_tile.cuh, each weight element unpacked from its byte
// while the tile is staged into shared memory. Bound on the H100: the
// packed code bytes at decode, the f32 FMAs at prefill.
//
// quant_matmul_w8a8 — int8 x int8 -> int32, dequantized by row scale x
// column scale at flush (acc_f32 * xs[row] * s[col], in that order).
// Replaces: src/repro/kernels/quant_matmul.py::quant_matmul_w8a8
// (_w8a8_kernel). As there, activations are quantized per row outside the
// kernel. Bound on the H100: at decode the int8 weight stream (n * p
// bytes); at prefill the int8 MACs, for which 1979 TOP/s needs tensor
// cores — this kernel uses __dp4a on CUDA cores (4 MACs an instruction):
// both tiles are staged into shared memory as 4-k-packed int32 words, so
// each inner step is one dp4a per accumulator. mma.sync / wgmma s8 is
// later work.
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

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
w8a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
            const int8_t* __restrict__ w, const float* __restrict__ s, T* __restrict__ y, int m,
            int n, int p) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int RS = BM / TM;
  constexpr int CS = BN / TN;
  constexpr int KQ = BK / 4;           // packed int32 words per k-tile
  __shared__ int xa[KQ][BM + 1];
  __shared__ int wb[KQ][BN];

  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tr = tid / CS;
  const int tc = tid % CS;

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < n; k0 += BK) {
    for (int i = tid; i < BM * KQ; i += NT) {
      const int r = i / KQ, kq = i % KQ;
      const int row = row0 + r, k = k0 + 4 * kq;
      unsigned word = 0;
      if (row < m)
        for (int t = 0; t < 4; ++t)
          if (k + t < n)
            word |= static_cast<unsigned>(static_cast<uint8_t>(xq[(size_t)row * n + k + t]))
                    << (8 * t);
      xa[kq][r] = static_cast<int>(word);
    }
    for (int i = tid; i < KQ * BN; i += NT) {
      const int kq = i / BN, c = i % BN;
      const int col = col0 + c, k = k0 + 4 * kq;
      unsigned word = 0;
      if (col < p)
        for (int t = 0; t < 4; ++t)
          if (k + t < n)
            word |= static_cast<unsigned>(static_cast<uint8_t>(w[(size_t)(k + t) * p + col]))
                    << (8 * t);
      wb[kq][c] = static_cast<int>(word);
    }
    __syncthreads();
#pragma unroll
    for (int kq = 0; kq < KQ; ++kq) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xa[kq][tr + i * RS];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = wb[kq][tc + j * CS];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + tr + i * RS;
    if (row >= m) continue;
    const float rs = xs[row];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tc + j * CS;
      if (col < p)
        y[(size_t)row * p + col] = rt::from_f32<T>(static_cast<float>(acc[i][j]) * rs * s[col]);
    }
  }
}

// Same tile choice as launch_gemm: 16 rows x 32 columns at decode, 64 x 64
// for prefill rows.
template <typename T>
int run_w8a8(const void* xq, const float* xs, const void* w, const float* s, void* y, int m,
             int n, int p, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(xq);
  const int8_t* wp = static_cast<const int8_t*>(w);
  T* yp = static_cast<T*>(y);
  if (m <= 16) {
    dim3 grid((m + 15) / 16, (p + 31) / 32);
    w8a8_kernel<T, 16, 32, 64, 2, 1><<<grid, 256, 0, st>>>(xp, xs, wp, s, yp, m, n, p);
  } else {
    dim3 grid((m + 63) / 64, (p + 63) / 64);
    w8a8_kernel<T, 64, 64, 64, 4, 4><<<grid, 256, 0, st>>>(xp, xs, wp, s, yp, m, n, p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BITS>
int run_qt(const void* x, const void* q, const void* scales, void* y, int m, int n, int p,
           int form, int bm, int bn, int split, int k_per_split, int smem, void* stream) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const auto src = gk::codes_source<BITS>(q, scales, p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = form == 0
      ? gk::launch_gemv<T>(xp, m, n, yp, p, src, bm, bn, split, k_per_split, smem, st)
      : gk::launch_pipe<T>(xp, m, n, yp, p, src, bm, bn, split, k_per_split, smem, st);
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

extern "C" int bsr_quant_matmul_launch(const void* x, const void* qblocks, const void* scales,
                                       const void* idx, void* y, int m, int n, int n_pb, int nnz,
                                       int bk, int bn, int bits, int is_bf16, void* stream) {
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

extern "C" int quant_matmul_w8a8_launch(const void* xq, const void* xs, const void* w,
                                        const void* s, void* y, int m, int n, int p, int is_bf16,
                                        void* stream) {
  const float* xsp = static_cast<const float*>(xs);
  const float* sp = static_cast<const float*>(s);
  return is_bf16 ? run_w8a8<__nv_bfloat16>(xq, xsp, w, sp, y, m, n, p, stream)
                 : run_w8a8<float>(xq, xsp, w, sp, y, m, n, p, stream);
}
