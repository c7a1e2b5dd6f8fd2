// The shared-memory-tiled GEMM mainloop that the two block-sparse kernels
// (bsr_matmul.cu, quant_matmul.cu) keep for the block shapes their GEMV and
// pipelined forms do not take (kernels/gemm_plan.py::bsr_plan).
//
// One CTA computes a BM x BN output tile in f32 registers. The contraction
// runs over "segments": contiguous k-ranges of x paired with a weight
// source, one segment per listed k-block (the Pallas kernels' index
// table, read here by the CTA itself instead of scalar prefetch). The
// weight source decides how a weight element is fetched (a gathered float
// block or a bit-packed code unpacked on the fly) and which per-column
// scale the f32 accumulator is multiplied by at flush.
//
// Ragged edges are masked, not padded: rows past m, k past the segment and
// columns past the tile's valid width load as zero and are never stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Src contract (tn = tile width in columns, set by the launcher):
//   int  n_tiles() const                 host: number of column tiles
//   void setup(int bx)                   device: fills col0, ncols, nseg
//   int  seg_x0(int s) const             first x column of segment s
//   int  seg_len() const                 k rows per segment
//   float load(int s, int r, int c)      weight (segment s, row r, tile col c)
//   float scale(int c)                   per-column factor applied at flush
template <typename T, int BM, int BN, int BK, int TM, int TN, class Src>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gemm_tile_kernel(const T* __restrict__ x, int m, int n, T* __restrict__ y, int p, Src src) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int RS = BM / TM;  // row stride between a thread's rows
  constexpr int CS = BN / TN;  // column stride between a thread's columns
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN];

  src.setup(blockIdx.y);
  const int row0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int tr = tid / CS;
  const int tc = tid % CS;
  const int len = src.seg_len();

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < src.nseg; ++s) {
    const int x0 = src.seg_x0(s);
    for (int k0 = 0; k0 < len; k0 += BK) {
      for (int i = tid; i < BM * BK; i += NT) {
        const int r = i / BK, kk = i % BK;
        const int row = row0 + r, k = k0 + kk;
        xs[kk][r] = (row < m && k < len) ? to_f32(x[(size_t)row * n + x0 + k]) : 0.f;
      }
      for (int i = tid; i < BK * BN; i += NT) {
        const int kk = i / BN, c = i % BN;
        const int k = k0 + kk;
        ws[kk][c] = (k < len && c < src.ncols) ? src.load(s, k, c) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[kk][tr + i * RS];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = ws[kk][tc + j * CS];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + tr + i * RS;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tc + j * CS;
      if (c < src.ncols)
        y[(size_t)row * p + src.col0 + c] = from_f32<T>(acc[i][j] * src.scale(c));
    }
  }
}

// Decode runs at m = n_slots (a handful of rows): a 16-row tile with narrow
// 32-column tiles puts more CTAs on the weight stream. Prefill rows take the
// 64 x 64 register-blocked tile.
template <typename T, class Src>
int launch_gemm(const void* x, int m, int n, void* y, int p, Src src, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (m <= 16) {
    src.tn = 32;
    dim3 grid((m + 15) / 16, src.n_tiles());
    gemm_tile_kernel<T, 16, 32, 32, 2, 1, Src><<<grid, 256, 0, st>>>(xp, m, n, yp, p, src);
  } else {
    src.tn = 64;
    dim3 grid((m + 63) / 64, src.n_tiles());
    gemm_tile_kernel<T, 64, 64, 16, 4, 4, Src><<<grid, 256, 0, st>>>(xp, m, n, yp, p, src);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rt
