// Decode form of the dense, weight-only and block-sparse x quantized GEMMs
// (m <= 16 rows): a cluster split-K GEMV.
//
// Bound on the H100: the weight stream. At m = 8 a 2560 x 6912 f32 weight
// is 70.8 MB against 0.57 GFLOP, so time is bytes over 3.35 TB/s, and the
// card needs several MB in flight to reach that rate. Design:
//   - the grid is (split, column tiles); the `split` CTAs of one column tile
//     form a thread-block cluster and each streams one k-range of the
//     weight, so even a 288-column weight puts >= 132 CTAs on the card;
//   - 256 threads own 4-column quads: bn / 4 quads across, 1024 / bn
//     k-lanes down; each thread keeps U quads in flight (16-byte f32,
//     8-byte bf16 or one 32-bit word of codes, through ld.global.nc), and
//     unpacks codes with compile-time shifts (BITS is a template constant);
//   - the CTA's slice of x's m rows is staged once in shared memory (k
//     major, so one float4 read gives 4 rows) and broadcast from there; a
//     block-sparse source maps each logical k to its x column on the way
//     (n counts logical k, ldx is x's row stride), so the split of the
//     concatenated listed blocks may cut inside a block;
//   - the k-lanes' partials meet in a fixed-order tree in shared memory,
//     then the cluster's partials through distributed shared memory
//     (cluster.map_shared_rank) in rank order; each CTA reduces, scales
//     and stores 1/split of the tile. One launch, no workspace, no atomics:
//     the result is bitwise the same from run to run;
//   - a batched launch (an MoE layer's experts, a source with BATCH) adds
//     the batch as the grid's z axis: CTA z reads x and writes y xb / yb
//     elements in, and takes the source's z-th weight (W::batch).
#pragma once

#include <cooperative_groups.h>

#include "gemm_src.cuh"

namespace gk {

namespace cg = cooperative_groups;

constexpr int GEMV_THREADS = 256;
constexpr int GEMV_UNION = 8192;      // floats: x staging, then the k-lane tree
constexpr int GEMV_PART_COLS = 128;   // widest column tile

template <int MT, class W>
struct GemvShape {
  static constexpr int XS = MT + 4;                     // staged x row stride
  static constexpr int XK = GEMV_UNION / XS / 8 * 8;    // k values per chunk
  // quads in flight per thread: 128 bytes (32 registers) of weight; at 16
  // rows, whose 64 accumulators share the 128 registers, 64 bytes of f32 or
  // bf16 and 16 bytes of codes (their unpack needs registers of its own); a
  // gathering source at 4 rows, whose index walk needs registers too, 64
  static constexpr int U =
      (MT < 16 ? (W::GATHER && MT == 4 ? 64 : 128) : W::BITS ? 16 : 64) /
      (int)sizeof(typename W::Quad);
};

// acc[i][j] += x[i][k] * w[k][c + j] for the VPB k values of one quad
template <int MT, int XS, class W>
__device__ __forceinline__ void gemv_fma(float (&acc)[MT][4], const W& w,
                                         const typename W::Quad& wq, const float* xk) {
  static_for<W::VPB>([&](auto v) {
    float f[4];
    w.template unpack<decltype(v)::value>(wq, f);
    const float* xv = xk + decltype(v)::value * XS;
#pragma unroll
    for (int i4 = 0; i4 < MT; i4 += 4) {
      const float4 a = *reinterpret_cast<const float4*>(xv + i4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i4 + ii][j] = fmaf(av[ii], f[j], acc[i4 + ii][j]);
    }
  });
}

template <typename T, class W, int MT>
__global__ void __launch_bounds__(GEMV_THREADS, 2)
gemv_cluster_kernel(const T* __restrict__ x, int m, int n, int ldx, T* __restrict__ y, int p,
                    W w, int bn, int k_per_split, bool xvec, long long xb, long long yb) {
  using S = GemvShape<MT, W>;
  constexpr int VPB = W::VPB;
  constexpr int U = S::U;
  constexpr int XR = S::XK / VPB;  // packed rows per staged chunk
  __shared__ __align__(16) float buf[GEMV_UNION];
  __shared__ __align__(16) float part[MT * GEMV_PART_COLS];

  if constexpr (W::BATCH) {   // z-th product of a batched launch
    x += blockIdx.z * xb;
    y += blockIdx.z * yb;
    w = w.batch(blockIdx.z);
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nsplit = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int nq = bn / 4;
  const int lanes = GEMV_THREADS / nq;
  const int q = tid % nq, kl = tid / nq;
  const int col0 = blockIdx.y * bn;
  const int c = col0 + 4 * q;
  const W wsrc = w.tile(col0);
  const auto* wc = wsrc.ptr(0, c);   // this thread's quad column, row 0
  const int wstride = wsrc.stride();
  const int rows = n / VPB;
  const int r_lo = rank * (k_per_split / VPB);
  const int r_hi = min(rows, r_lo + k_per_split / VPB);

  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // each chunk: the first round of weight loads goes out before x is
  // staged, so the two latencies overlap
  typename W::Quad wq[U];
  for (int cr = r_lo; cr < r_hi; cr += XR) {
    const int ce = min(r_hi, cr + XR);
    const int k0 = cr * VPB, kn = (ce - cr) * VPB;
    auto fetch = [&](int r) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int rr = r + u * lanes;
        wq[u] = rr < ce ? wsrc.load_at(wc + (size_t)rr * wstride, c) : wsrc.zero();
      }
    };
    fetch(cr + kl);
    __syncthreads();
    // x rows i < m, k0 .. k0 + kn, widened to f32; rows m .. MT read zero.
    // Loads go out XB at a time before their stores (a load-store pair per
    // trip would serialise the latencies); 4 k values a load where rows and
    // the chunk are 4-aligned
    constexpr int XB = MT >= 8 ? 4 : 8;   // under the 128-register cap
    const int kq = xvec && k0 % 4 == 0 ? kn / 4 : 0;
    for (int e0 = tid; e0 < MT * kq; e0 += XB * GEMV_THREADS) {
      float v[XB][4];
#pragma unroll
      for (int b = 0; b < XB; ++b) {
        const int e = e0 + b * GEMV_THREADS, i = e / kq, k = k0 + 4 * (e % kq);
        if (e < MT * kq && i < m) {
          load4(x + (size_t)i * ldx + wsrc.xcol(k), v[b]);
        } else {
          v[b][0] = v[b][1] = v[b][2] = v[b][3] = 0.f;
        }
      }
#pragma unroll
      for (int b = 0; b < XB; ++b) {
        const int e = e0 + b * GEMV_THREADS, i = e / kq, kk = 4 * (e % kq);
        if (e < MT * kq)
#pragma unroll
          for (int t = 0; t < 4; ++t) buf[(kk + t) * S::XS + i] = v[b][t];
      }
    }
    const int kt = kn - 4 * kq;  // k values left to single loads
    for (int e0 = tid; e0 < MT * kt; e0 += XB * GEMV_THREADS) {
      float v[XB];
#pragma unroll
      for (int b = 0; b < XB; ++b) {
        const int e = e0 + b * GEMV_THREADS, i = e / kt, k = 4 * kq + e % kt;
        v[b] = e < MT * kt && i < m ? f32(x[(size_t)i * ldx + wsrc.xcol(k0 + k)]) : 0.f;
      }
#pragma unroll
      for (int b = 0; b < XB; ++b) {
        const int e = e0 + b * GEMV_THREADS;
        if (e < MT * kt) buf[(4 * kq + e % kt) * S::XS + e / kt] = v[b];
      }
    }
    __syncthreads();
    for (int r = cr + kl; r < ce; r += lanes * U) {
      if (r != cr + kl) fetch(r);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int rr = r + u * lanes;
        if (rr < ce) gemv_fma<MT, S::XS>(acc, w, wq[u], buf + (rr - cr) * VPB * S::XS);
      }
    }
  }

  // k-lane tree in shared memory, fixed order: lanes [h, 2h) add into [0, h)
  for (int half = lanes / 2; half >= 1; half >>= 1) {
    __syncthreads();
    if (kl >= half && kl < 2 * half) {
      float* dst = buf + (kl - half) * MT * bn + 4 * q;
#pragma unroll
      for (int i = 0; i < MT; ++i)
        *reinterpret_cast<float4*>(dst + i * bn) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();
    if (kl < half) {
      const float* src = buf + kl * MT * bn + 4 * q;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(src + i * bn);
        acc[i][0] += v.x; acc[i][1] += v.y; acc[i][2] += v.z; acc[i][3] += v.w;
      }
    }
  }
  if (kl == 0) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
      *reinterpret_cast<float4*>(part + i * GEMV_PART_COLS + 4 * q) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }

  // the cluster's partials through DSMEM, rank 0 first; each CTA finishes
  // 1/nsplit of the live m x bn outputs
  cluster.sync();
  const int outs = m * bn;
  const int per = (outs + nsplit - 1) / nsplit;
  const int e1 = min(outs, (rank + 1) * per);
  for (int e = rank * per + tid; e < e1; e += GEMV_THREADS) {
    const int i = e / bn, cc = e % bn;
    if (col0 + cc >= p) continue;
    float v[8];
#pragma unroll
    for (int src = 0; src < 8; ++src)
      v[src] = src < nsplit ? cluster.map_shared_rank(part, src)[i * GEMV_PART_COLS + cc] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int src = 0; src < 8; ++src) s += v[src];  // rank order
    y[(size_t)i * p + col0 + cc] = cast_out<T>(s * w.scale(col0 + cc));
  }
  cluster.sync();  // no CTA leaves while another still reads its partial
}

constexpr int gemv_smem_bytes(int mt) { return (GEMV_UNION + mt * GEMV_PART_COLS) * 4; }

template <typename T, class W, int MT>
cudaError_t launch_gemv_mt(const T* x, int m, int n, int ldx, T* y, int p, const W& w, int bn,
                           int split, int k_per_split, cudaStream_t st, int batch, long long xb,
                           long long yb) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (p + bn - 1) / bn, batch);
  cfg.blockDim = dim3(GEMV_THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // x rows may be read 4 k values at a time (16 bytes of f32, 8 of bf16)
  const bool xvec = ldx % 4 == 0 && w.kgrain() % 4 == 0 && xb % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
  return cudaLaunchKernelEx(&cfg, gemv_cluster_kernel<T, W, MT>, x, m, n, ldx, y, p, w, bn,
                            k_per_split, xvec, xb, yb);
}

// Launch the plan chosen by kernels/gemm_plan.py (bm = row template); a plan
// this header does not instantiate, or whose shared memory differs from the
// kernel's, is refused with cudaErrorInvalidValue. n counts logical k; ldx
// is x's row stride (n but for a block-sparse source). batch products in
// one launch: the z-th reads x + z * xb, writes y + z * yb and takes w's
// z-th weight.
template <typename T, class W>
cudaError_t launch_gemv(const T* x, int m, int n, int ldx, T* y, int p, const W& w, int mt,
                        int bn, int split, int k_per_split, int smem, cudaStream_t st,
                        int batch = 1, long long xb = 0, long long yb = 0) {
  const bool ok = (bn == 16 || bn == 32 || bn == 64 || bn == 128) && split >= 1 && split <= 8 &&
                  k_per_split > 0 && k_per_split % W::VPB == 0 &&
                  (long long)k_per_split * split >= n && m <= mt && smem == gemv_smem_bytes(mt) &&
                  batch >= 1 && batch <= 65535;
  if (!ok) return cudaErrorInvalidValue;
  switch (mt) {
    case 4:
      return launch_gemv_mt<T, W, 4>(x, m, n, ldx, y, p, w, bn, split, k_per_split, st, batch, xb,
                                     yb);
    case 8:
      return launch_gemv_mt<T, W, 8>(x, m, n, ldx, y, p, w, bn, split, k_per_split, st, batch, xb,
                                     yb);
    case 16:
      return launch_gemv_mt<T, W, 16>(x, m, n, ldx, y, p, w, bn, split, k_per_split, st, batch,
                                      xb, yb);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace gk
