// Prefill form of the dense, weight-only and block-sparse x quantized GEMMs
// (m > 16 rows): a pipelined SGEMM tile on CUDA cores.
//
// Bound on the H100: the f32 FMAs (67 TFLOP/s outside the tensor cores) at
// m in the hundreds. The serving path is f32 and its parity tolerance
// (1e-4 + 1e-4|y|) rules out single-pass TF32, so this stays on CUDA cores
// on purpose. Design:
//   - a BM x BN CTA tile (128 x 128 or 128 x 64, picked by the launch
//     plan against wave quantisation; 64 x 128 or 64 x 64 for a batched
//     launch of at most 64 rows a product), BM * BN / 64 threads, each an
//     8 x 8 micro-tile read as float4 pairs from shared memory: x staged
//     k-major, w row-major; 16 FMAs per float4 read;
//   - a 3-stage cp.async ring of BK = 16 k-tiles, so the next tiles land
//     while the current one is multiplied. f32 operands land in the f32
//     tile as they are (x as 4-byte copies into its transposed slot, w as
//     16-byte quads); bf16 operands and packed codes land raw and are
//     widened or unpacked once per stage into the f32 tile (BITS is a
//     template constant), so the unpack is amortised over the CTA's rows;
//   - an under-filled grid splits k over the CTAs of a cluster; the partial
//     tiles are summed through distributed shared memory in rank order
//     (one launch, no workspace, no atomics, bitwise repeatable);
//   - ragged m, n and p are masked by zero-fill copies, never padded;
//   - a block-sparse source's column tile lies inside one block column and
//     each 16-deep stage inside one listed block (bk % 16 == 0, the plan's
//     rule), so a stage's x columns are one contiguous run from xcol(k0);
//   - a batched launch (an MoE layer's experts, a source with BATCH) adds
//     the batch as the grid's z axis, as the GEMV does.
#pragma once

#include <cooperative_groups.h>

#include "gemm_src.cuh"

namespace gk {

namespace cg = cooperative_groups;

constexpr int PIPE_BK = 16;
constexpr int PIPE_STAGES = 3;

template <typename T, class W, int BM, int BN>
struct PipeShape {
  static constexpr int NT = BM * BN / 64;
  static constexpr int XS = BM + 4;                 // f32 x stage row stride
  static constexpr int X_F32 = PIPE_BK * XS;        // floats per stage
  static constexpr int W_F32 = PIPE_BK * BN;
  static constexpr int X_RAW = sizeof(T) == 4 ? 0 : BM * PIPE_BK * 2;   // bytes
  static constexpr int W_RAW = W::DIRECT ? 0 : PIPE_BK / W::VPB * BN * (int)sizeof(typename W::Quad) / 4;
  static constexpr int RINGS = PIPE_STAGES * ((X_F32 + W_F32) * 4 + X_RAW + W_RAW);
  static constexpr int smem(int split) {
    return split > 1 && BM * BN * 4 > RINGS ? BM * BN * 4 : RINGS;
  }
};

// at most 128 registers a thread: two 256-thread CTAs (or four 128-thread
// ones) share an SM, so one CTA's barrier stalls are
// covered by the other's FMAs
template <typename T, class W, int BM, int BN>
__global__ void __launch_bounds__(BM * BN / 64, 32768 / (BM * BN))
gemm_pipe_kernel(const T* __restrict__ x, int m, int n, int ldx, T* __restrict__ y, int p, W w,
                 int k_per_split, bool xvec, long long xb, long long yb) {
  using S = PipeShape<T, W, BM, BN>;
  constexpr int NT = S::NT, BK = PIPE_BK, ST = PIPE_STAGES, VPB = W::VPB;
  constexpr int WQ = BK / VPB * (BN / 4);  // weight quads per stage
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* ws = xs + ST * S::X_F32;
  unsigned char* x_raw = reinterpret_cast<unsigned char*>(ws + ST * S::W_F32);
  unsigned char* w_raw = x_raw + ST * S::X_RAW;

  if constexpr (W::BATCH) {   // z-th product of a batched launch
    x += blockIdx.z * xb;
    y += blockIdx.z * yb;
    w = w.batch(blockIdx.z);
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nsplit = static_cast<int>(cluster.num_blocks());
  const int tiles_m = (m + BM - 1) / BM;
  const int row0 = (blockIdx.y % tiles_m) * BM;
  const int col0 = (blockIdx.y / tiles_m) * BN;
  const W wsrc = w.tile(col0);
  const auto* wcol = wsrc.ptr(0, col0);   // the tile's first column, row 0
  const int wstride = wsrc.stride();
  const int tid = threadIdx.x;
  // warp tiles of 32 rows x 64 columns; a lane's 8 x 8 micro-tile is rows
  // wr + lr * 4 + {0..3, 16..19} by columns wc + lc * 4 + {0..3, 32..35}, so
  // each of its four float4 reads per k is one shared-memory wavefront
  const int warp = tid / 32, lane = tid % 32;
  const int wr = (warp / (BN / 64)) * 32, wc = (warp % (BN / 64)) * 64;
  const int ty = wr / 4 + lane / 8, tx = wc / 4 + lane % 8;
  const int ktiles = (n + BK - 1) / BK;
  const int kt0 = rank * (k_per_split / BK);
  const int nk = max(0, min(ktiles, kt0 + k_per_split / BK) - kt0);

  // issue the copies of k-tile kt into ring slot s
  auto issue = [&](int kt, int s) {
    const int k0 = kt * BK;
    const int xk0 = wsrc.xcol(k0);
    if constexpr (sizeof(T) == 4) {
      float* dst = xs + s * S::X_F32;
      for (int e = tid; e < BM * BK; e += NT) {
        const int r = e / BK, kk = e % BK;
        const bool ok = row0 + r < m && k0 + kk < n;
        cp_async<4>(dst + kk * S::XS + r, ok ? x + (size_t)(row0 + r) * ldx + xk0 + kk : x,
                    ok ? 4 : 0);
      }
    } else {
      T* dst = reinterpret_cast<T*>(x_raw + s * S::X_RAW);
#pragma unroll 2
      for (int e = tid; e < BM * BK / 2; e += NT) {
        const int r = e / (BK / 2), kk = 2 * (e % (BK / 2));
        const T* src = x + (size_t)(row0 + r) * ldx + xk0 + kk;
        if (xvec) {
          const bool ok = row0 + r < m && k0 + kk < n;
          cp_async<4>(dst + r * BK + kk, ok ? src : x, ok ? 4 : 0);
        } else {
#pragma unroll
          for (int t = 0; t < 2; ++t)
            dst[r * BK + kk + t] = row0 + r < m && k0 + kk + t < n ? src[t] : T{};
        }
      }
    }
    using Q = typename W::Quad;
    Q* dst = W::DIRECT ? reinterpret_cast<Q*>(ws + s * S::W_F32)
                       : reinterpret_cast<Q*>(w_raw + s * S::W_RAW);
    const int r0 = k0 / VPB, rows = n / VPB;
    for (int e = tid; e < WQ; e += NT) {
      const int rr = e / (BN / 4), c4 = e % (BN / 4);
      const int col = col0 + 4 * c4;
      const auto* src = wcol + (size_t)(r0 + rr) * wstride + 4 * c4;
      if (w.vec) {
        // a masked copy reads nothing; x stands in as its address
        const bool ok = r0 + rr < rows && col < p;
        cp_async<sizeof(Q)>(dst + e, ok ? static_cast<const void*>(src) : x, ok ? sizeof(Q) : 0);
      } else {
        dst[e] = r0 + rr < rows ? wsrc.load_at(src, col) : wsrc.zero();
      }
    }
  };

  // widen bf16 x / unpack or widen the weight of slot s into the f32 tile
  auto convert = [&](int s) {
    if constexpr (sizeof(T) != 4) {
      const T* src = reinterpret_cast<const T*>(x_raw + s * S::X_RAW);
      float* dst = xs + s * S::X_F32;
#pragma unroll 2
      for (int e = tid; e < BM * BK; e += NT) {
        const int r = e / BK, kk = e % BK;
        dst[kk * S::XS + r] = f32(src[r * BK + kk]);
      }
    }
    if constexpr (!W::DIRECT) {
      const typename W::Quad* src = reinterpret_cast<const typename W::Quad*>(w_raw + s * S::W_RAW);
      float* dst = ws + s * S::W_F32;
      // a gathering source keeps its index walk live: one quad at a time
      // stays under the register cap
#pragma unroll (W::GATHER ? 1 : 2)
      for (int e = tid; e < WQ; e += NT) {
        const int rr = e / (BN / 4), c4 = e % (BN / 4);
        const typename W::Quad qv = src[e];
        static_for<VPB>([&](auto v) {
          float f[4];
          w.template unpack<decltype(v)::value>(qv, f);
          *reinterpret_cast<float4*>(dst + (rr * VPB + decltype(v)::value) * BN + 4 * c4) =
              make_float4(f[0], f[1], f[2], f[3]);
        });
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nk) issue(kt0 + s, s);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    const int s = t % ST;
    if constexpr (sizeof(T) != 4 || !W::DIRECT) {
      convert(s);
      __syncthreads();
    }
    if (t + ST - 1 < nk) issue(kt0 + t + ST - 1, (t + ST - 1) % ST);
    cp_async_commit();
    const float* xt = xs + s * S::X_F32;
    const float* wt = ws + s * S::W_F32;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(xt + kk * S::XS + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(xt + kk * S::XS + ty * 4 + 16);
      const float4 b0 = *reinterpret_cast<const float4*>(wt + kk * BN + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(wt + kk * BN + tx * 4 + 32);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  auto row_of = [&](int i) { return ty * 4 + (i < 4 ? i : i + 12); };
  auto col_of = [&](int j) { return tx * 4 + (j < 4 ? j : j + 28); };
  if (nsplit == 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + col_of(j);
      if (col >= p) continue;
      const float sc = w.scale(col);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = row0 + row_of(i);
        if (row < m) y[(size_t)row * p + col] = cast_out<T>(acc[i][j] * sc);
      }
    }
    return;
  }

  // split k: park the partial tile over the rings, then each CTA sums
  // 1/nsplit of the tile over the cluster in rank order
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    *reinterpret_cast<float4*>(part + row_of(i) * BN + col_of(0)) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(part + row_of(i) * BN + col_of(4)) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  cluster.sync();
  constexpr int OUTS = BM * BN;
  const int per = (OUTS + nsplit - 1) / nsplit;
  const int e1 = min(OUTS, (rank + 1) * per);
  for (int e = rank * per + tid; e < e1; e += NT) {
    const int row = row0 + e / BN, col = col0 + e % BN;
    if (row >= m || col >= p) continue;
    float s = 0.f;
    for (int src = 0; src < nsplit; ++src) s += cluster.map_shared_rank(part, src)[e];
    y[(size_t)row * p + col] = cast_out<T>(s * w.scale(col));
  }
  cluster.sync();
}

template <typename T, class W, int BM, int BN>
cudaError_t launch_pipe_tile(const T* x, int m, int n, int ldx, T* y, int p, const W& w,
                             int split, int k_per_split, int smem, cudaStream_t st, int batch,
                             long long xb, long long yb) {
  using S = PipeShape<T, W, BM, BN>;
  if (smem != S::smem(split)) return cudaErrorInvalidValue;
  auto kern = gemm_pipe_kernel<T, W, BM, BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::smem(2));
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, ((m + BM - 1) / BM) * ((p + BN - 1) / BN), batch);
  cfg.blockDim = dim3(S::NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = split;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = 1;
  cfg.attrs = la;
  cfg.numAttrs = 1;
  const bool xvec = n % 2 == 0 && ldx % 2 == 0 && xb % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 4 == 0;
  return cudaLaunchKernelEx(&cfg, kern, x, m, n, ldx, y, p, w, k_per_split, xvec, xb, yb);
}

// Launch the plan chosen by kernels/gemm_plan.py (bm x bn tile, k split over
// `split` CTAs of a cluster); anything else is cudaErrorInvalidValue. n
// counts logical k; ldx is x's row stride (n but for a block-sparse source).
// batch products in one launch, as launch_gemv.
template <typename T, class W>
cudaError_t launch_pipe(const T* x, int m, int n, int ldx, T* y, int p, const W& w, int bm,
                        int bn, int split, int k_per_split, int smem, cudaStream_t st,
                        int batch = 1, long long xb = 0, long long yb = 0) {
  if (split < 1 || split > 8 || k_per_split <= 0 || k_per_split % PIPE_BK ||
      w.kgrain() % PIPE_BK || batch < 1 || batch > 65535 ||
      (long long)k_per_split * split < n || ((m + bm - 1) / bm) * ((p + bn - 1) / bn) > 65535)
    return cudaErrorInvalidValue;
  if (bm == 128 && bn == 128)
    return launch_pipe_tile<T, W, 128, 128>(x, m, n, ldx, y, p, w, split, k_per_split, smem, st,
                                            batch, xb, yb);
  if (bm == 128 && bn == 64)
    return launch_pipe_tile<T, W, 128, 64>(x, m, n, ldx, y, p, w, split, k_per_split, smem, st,
                                           batch, xb, yb);
  if constexpr (W::BATCH) {
    if (bm == 64 && bn == 128)
      return launch_pipe_tile<T, W, 64, 128>(x, m, n, ldx, y, p, w, split, k_per_split, smem,
                                             st, batch, xb, yb);
    if (bm == 64 && bn == 64)
      return launch_pipe_tile<T, W, 64, 64>(x, m, n, ldx, y, p, w, split, k_per_split, smem, st,
                                            batch, xb, yb);
  }
  return cudaErrorInvalidValue;
}

}  // namespace gk
