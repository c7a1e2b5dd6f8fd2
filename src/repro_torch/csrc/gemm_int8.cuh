// quant_matmul_w8a8's two forms: per-row int8 activation codes made inside
// the launch, an exact int32 sum of int8 x int8 products, and the dequant
// float(acc) * xs[row] * s[col] at flush.
//
// Bound on the H100: at decode the int8 weight stream (n * p bytes); at
// prefill the int8 MACs, which need the tensor cores (1979 TOP/s) to leave
// the weight stream in charge. Design:
//   - decode (m <= 16), w8a8_gemv_kernel: gemv_cluster.cuh's cluster
//     split-K GEMV over int8. The CTAs of one cluster together cover k;
//     each first takes the |x| maximum of the m rows over its own k-range,
//     the maxima meet through distributed shared memory after one
//     cluster.sync, and every CTA then derives the row scales and
//     quantizes its range into 4-k int8 words while it stages it. A thread
//     streams 32-bit words of weight (4 columns x 1 k) through
//     ld.global.nc, 4 rows of them at a time, turns each 4 x 4 byte block
//     with __byte_perm into 4 words of one column's 4 k, and accumulates
//     with __dp4a into int32. k-lane and cluster partials are int32, so the
//     order of the sum does not matter. One launch.
//   - prefill, act_quant_kernel then w8a8_mma_kernel: one CTA per row
//     writes that row's codes (row stride padded to 16 bytes, pad zero) and
//     f32 scale; the tile GEMM runs mma.sync m16n8k32 s8 (8 warps of 64 x 32
//     outputs in a 128 x 128 tile) with a 3-stage cp.async ring of 64-k
//     stages. The MMA takes B k-major; the weight is (n, p) row-major, so
//     each stage lands raw and is turned once, 4 x 4 bytes a thread, into a
//     k-major copy (4-k words per column) that the fragments read as words.
//     An under-filled grid splits k over a cluster; its int32 partial
//     tiles meet in distributed shared memory. Two launches.
// The codes are those of core/quantize.py::quantize_activations_int8, the
// form jax.jit of the JAX package's function computes: the scale is one
// FMA of amax(|x|), the f32 reciprocal of 127 and 1e-12, rounded once to
// x's dtype; then x / scale (a true division) in x's dtype, round half to
// even, clamp to +-127. Every step is an _rn intrinsic, so no other FMA
// contraction joins two of them.
#pragma once

#include <cooperative_groups.h>

#include "gemm_src.cuh"
#include "gemv_cluster.cuh"

namespace gk {

namespace cg = cooperative_groups;

// the value of a float in x's dtype (bf16: round to nearest even)
template <typename T> __device__ __forceinline__ float in_dtype(float v);
template <> __device__ __forceinline__ float in_dtype<float>(float v) { return v; }
template <> __device__ __forceinline__ float in_dtype<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// row scale from the row's |x| maximum (a value of x's dtype)
template <typename T>
__device__ __forceinline__ float act_scale(float amax) {
  return in_dtype<T>(__fmaf_rn(amax, __fdiv_rn(1.f, 127.f), static_cast<float>(1e-12)));
}

// the code of one x value as an unsigned byte
template <typename T>
__device__ __forceinline__ uint32_t act_code(float v, float scale) {
  float q = rintf(in_dtype<T>(__fdiv_rn(v, scale)));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(q))));
}

__device__ __forceinline__ float dequant(int acc, float rs, float cs) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), rs), cs);
}

// a 4 x 4 byte block, a[r] = 4 columns of row r, into b[c] = 4 rows of
// column c (byte i of a word is its i-th k or column)
__device__ __forceinline__ void transpose4x4(uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                             uint32_t (&b)[4]) {
  const uint32_t t0 = __byte_perm(a0, a1, 0x5140), t1 = __byte_perm(a0, a1, 0x7362);
  const uint32_t t2 = __byte_perm(a2, a3, 0x5140), t3 = __byte_perm(a2, a3, 0x7362);
  b[0] = __byte_perm(t0, t2, 0x5410);
  b[1] = __byte_perm(t0, t2, 0x7632);
  b[2] = __byte_perm(t1, t3, 0x5410);
  b[3] = __byte_perm(t1, t3, 0x7632);
}

// ---------------------------------------------------------------- decode

template <int MT>
struct W8a8GemvShape {
  static constexpr int XK = GEMV_UNION * 4 / MT;   // k values of a staged chunk
  static constexpr int U = MT < 16 ? 8 : 4;        // 4-row weight groups in flight
};

template <typename T, int MT>
__global__ void __launch_bounds__(GEMV_THREADS, 2)
w8a8_gemv_kernel(const T* __restrict__ x, int m, int n, const int8_t* __restrict__ w,
                 const float* __restrict__ s, T* __restrict__ y, int p, int bn, int k_per_split,
                 bool xvec, bool wvec) {
  using S = W8a8GemvShape<MT>;
  constexpr int U = S::U;
  __shared__ __align__(16) int buf[GEMV_UNION];   // x words [k / 4][MT], then the k-lane tree
  __shared__ __align__(16) int part[MT * GEMV_PART_COLS];
  __shared__ unsigned rmax[MT];
  __shared__ float rscale[MT];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nsplit = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int nq = bn / 4;
  const int lanes = GEMV_THREADS / nq;
  const int q = tid % nq, kl = tid / nq;
  const int col0 = blockIdx.y * bn;
  const int c = col0 + 4 * q;
  const Codes<8> src{w, s, p, wvec};
  const int8_t* wc = w + c;     // this thread's 4 columns, row 0
  const int k_lo = rank * k_per_split;
  const int k_hi = min(n, k_lo + k_per_split);

  int acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  // groups g, g + lanes, ... of 4 weight rows each, below group ge
  uint32_t wq[U][4];
  auto fetch = [&](int g, int ge) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int gg = g + u * lanes;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 4 * gg + r;
        wq[u][r] = gg < ge && row < k_hi ? src.load_at(wc + (size_t)row * p, c) : 0u;
      }
    }
  };
  constexpr int xk = S::XK;
  fetch(k_lo / 4 + kl, (min(k_hi, k_lo + xk) + 3) / 4);

  // |x| maximum of each row over this CTA's k-range: GEMV_THREADS / MT
  // threads a row
  if (tid < MT) rmax[tid] = 0u;
  __syncthreads();
  {
    constexpr int TPR = GEMV_THREADS / MT;
    constexpr int WR = TPR < 32 ? TPR : 32;
    const int i = tid / TPR, j = tid % TPR;
    float v = 0.f;
    if (i < m) {
      const T* xr = x + (size_t)i * n;
      if (xvec) {
        for (int k = k_lo + 4 * j; k < k_hi; k += 4 * TPR) {
          float f[4];
          load4(xr + k, f);
          v = fmaxf(v, fmaxf(fmaxf(fabsf(f[0]), fabsf(f[1])), fmaxf(fabsf(f[2]), fabsf(f[3]))));
        }
      } else {
        for (int k = k_lo + j; k < k_hi; k += TPR) v = fmaxf(v, fabsf(f32(xr[k])));
      }
    }
#pragma unroll
    for (int o = WR / 2; o >= 1; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (j % WR == 0) atomicMax(&rmax[i], __float_as_uint(v));
  }
  // the cluster's maxima (non-negative floats order as their bits)
  cluster.sync();
  if (tid < MT) {
    unsigned a = 0u;
    for (int r = 0; r < nsplit; ++r) a = max(a, cluster.map_shared_rank(rmax, r)[tid]);
    rscale[tid] = act_scale<T>(__uint_as_float(a));
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += xk) {
    const int ke = min(k_hi, k0 + xk);
    const int g0 = k0 / 4, ge = (ke + 3) / 4;
    if (k0 != k_lo) fetch(g0 + kl, ge);
    __syncthreads();
    // this chunk's codes as 4-k words, rows m .. MT zero
    for (int e = tid; e < (ge - g0) * MT; e += GEMV_THREADS) {
      const int i = e % MT, k = k0 + 4 * (e / MT);
      uint32_t word = 0u;
      if (i < m) {
        const float sc = rscale[i];
        const T* xr = x + (size_t)i * n + k;
        float f[4];
        if (xvec) {
          load4(xr, f);
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t) f[t] = k + t < ke ? f32(xr[t]) : 0.f;
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) word |= (k + t < ke ? act_code<T>(f[t], sc) : 0u) << (8 * t);
      }
      buf[e] = static_cast<int>(word);
    }
    __syncthreads();
    for (int g = g0 + kl; g < ge; g += lanes * U) {
      if (g != g0 + kl) fetch(g, ge);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int gg = g + u * lanes;
        if (gg >= ge) continue;
        uint32_t b[4];
        transpose4x4(wq[u][0], wq[u][1], wq[u][2], wq[u][3], b);
        const int* xw = buf + (gg - g0) * MT;
#pragma unroll
        for (int i4 = 0; i4 < MT; i4 += 4) {
          const int4 xv = *reinterpret_cast<const int4*>(xw + i4);
          const int xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i4 + ii][j] = __dp4a(xa[ii], static_cast<int>(b[j]), acc[i4 + ii][j]);
        }
      }
    }
  }

  // k-lane tree in shared memory: lanes [h, 2h) add into [0, h)
  for (int half = lanes / 2; half >= 1; half >>= 1) {
    __syncthreads();
    if (kl >= half && kl < 2 * half) {
      int* dst = buf + (kl - half) * MT * bn + 4 * q;
#pragma unroll
      for (int i = 0; i < MT; ++i)
        *reinterpret_cast<int4*>(dst + i * bn) = make_int4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();
    if (kl < half) {
      const int* srcp = buf + kl * MT * bn + 4 * q;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int4 v = *reinterpret_cast<const int4*>(srcp + i * bn);
        acc[i][0] += v.x; acc[i][1] += v.y; acc[i][2] += v.z; acc[i][3] += v.w;
      }
    }
  }
  if (kl == 0) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
      *reinterpret_cast<int4*>(part + i * GEMV_PART_COLS + 4 * q) =
          make_int4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }

  // the cluster's int32 partials; each CTA finishes 1/nsplit of the tile
  cluster.sync();
  const int outs = m * bn;
  const int per = (outs + nsplit - 1) / nsplit;
  const int e1 = min(outs, (rank + 1) * per);
  for (int e = rank * per + tid; e < e1; e += GEMV_THREADS) {
    const int i = e / bn, cc = e % bn;
    if (col0 + cc >= p) continue;
    int a = 0;
    for (int r = 0; r < nsplit; ++r) a += cluster.map_shared_rank(part, r)[i * GEMV_PART_COLS + cc];
    y[(size_t)i * p + col0 + cc] = cast_out<T>(dequant(a, rscale[i], s[col0 + cc]));
  }
  cluster.sync();  // no CTA leaves while another still reads its shared memory
}

constexpr int w8a8_gemv_smem_bytes(int mt) {
  return (GEMV_UNION + mt * GEMV_PART_COLS + 2 * mt) * 4;
}

template <typename T, int MT>
cudaError_t launch_w8a8_gemv_mt(const T* x, int m, int n, const int8_t* w, const float* s, T* y,
                                int p, int bn, int split, int k_per_split, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (p + bn - 1) / bn, 1);
  cfg.blockDim = dim3(GEMV_THREADS, 1, 1);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool xvec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
  const bool wvec = p % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  return cudaLaunchKernelEx(&cfg, w8a8_gemv_kernel<T, MT>, x, m, n, w, s, y, p, bn, k_per_split,
                            xvec, wvec);
}

// Launch the plan of kernels/gemm_plan.py::w8a8_plan (decode form); any
// other plan is cudaErrorInvalidValue.
template <typename T>
cudaError_t launch_w8a8_gemv(const T* x, int m, int n, const int8_t* w, const float* s, T* y,
                             int p, int mt, int bn, int split, int k_per_split, int smem,
                             cudaStream_t st) {
  const bool ok = (bn == 16 || bn == 32 || bn == 64 || bn == 128) && split >= 1 && split <= 8 &&
                  k_per_split > 0 && k_per_split % 4 == 0 &&
                  (long long)k_per_split * split >= n && m <= mt &&
                  smem == w8a8_gemv_smem_bytes(mt);
  if (!ok) return cudaErrorInvalidValue;
  switch (mt) {
    case 4: return launch_w8a8_gemv_mt<T, 4>(x, m, n, w, s, y, p, bn, split, k_per_split, st);
    case 8: return launch_w8a8_gemv_mt<T, 8>(x, m, n, w, s, y, p, bn, split, k_per_split, st);
    case 16: return launch_w8a8_gemv_mt<T, 16>(x, m, n, w, s, y, p, bn, split, k_per_split, st);
    default: return cudaErrorInvalidValue;
  }
}

// --------------------------------------------------------------- prefill

constexpr int W8A8_BM = 128, W8A8_BN = 128, W8A8_BK = 64, W8A8_STAGES = 3, W8A8_THREADS = 256;
constexpr int W8A8_XSTR = W8A8_BK + 16;    // bytes a staged x row (pad: no bank conflict)
constexpr int W8A8_WTS = W8A8_BN + 8;      // words a k-word row of the k-major weight

constexpr int w8a8_tile_smem_bytes(int split) {
  const int rings = W8A8_STAGES * (W8A8_BM * W8A8_XSTR + W8A8_BK * W8A8_BN) +
                    W8A8_BK / 4 * W8A8_WTS * 4;
  const int part = W8A8_BM * W8A8_BN * 4;
  return split > 1 && part > rings ? part : rings;
}

// one CTA per row: the row's scale and its codes, 4 to a word, the row
// padded with zero codes to ldq (a multiple of 16)
template <typename T>
__global__ void __launch_bounds__(256)
act_quant_kernel(const T* __restrict__ x, int n, bool xvec, int8_t* __restrict__ xq, int ldq,
                 float* __restrict__ xs) {
  __shared__ float red[8];
  __shared__ float sc;
  const int row = blockIdx.x, tid = threadIdx.x;
  const T* xr = x + (size_t)row * n;
  float v = 0.f;
  if (xvec) {
    for (int k = 4 * tid; k < n; k += 4 * 256) {
      float f[4];
      load4(xr + k, f);
      v = fmaxf(v, fmaxf(fmaxf(fabsf(f[0]), fabsf(f[1])), fmaxf(fabsf(f[2]), fabsf(f[3]))));
    }
  } else {
    for (int k = tid; k < n; k += 256) v = fmaxf(v, fabsf(f32(xr[k])));
  }
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (tid % 32 == 0) red[tid / 32] = v;
  __syncthreads();
  if (tid == 0) {
    float a = red[0];
#pragma unroll
    for (int i = 1; i < 8; ++i) a = fmaxf(a, red[i]);
    sc = act_scale<T>(a);
    xs[row] = sc;
  }
  __syncthreads();
  const float s = sc;
  uint32_t* out = reinterpret_cast<uint32_t*>(xq + (size_t)row * ldq);
  for (int kw = tid; kw < ldq / 4; kw += 256) {
    const int k = 4 * kw;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (xvec && k < n) {
      load4(xr + k, f);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) f[t] = k + t < n ? f32(xr[k + t]) : 0.f;
    }
    uint32_t word = 0u;
#pragma unroll
    for (int t = 0; t < 4; ++t) word |= (k + t < n ? act_code<T>(f[t], s) : 0u) << (8 * t);
    out[kw] = word;
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__global__ void __launch_bounds__(W8A8_THREADS, 2)
w8a8_mma_kernel(const int8_t* __restrict__ xq, int ldq, const float* __restrict__ xs,
                const int8_t* __restrict__ w, const float* __restrict__ s, T* __restrict__ y,
                int m, int n, int p, int k_per_split, bool wvec) {
  constexpr int BM = W8A8_BM, BN = W8A8_BN, BK = W8A8_BK, ST = W8A8_STAGES, NT = W8A8_THREADS;
  constexpr int XSTR = W8A8_XSTR, XW = XSTR / 4, WTS = W8A8_WTS;
  constexpr int X_STAGE = BM * XSTR, W_STAGE = BK * BN;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* x_ring = smem;
  unsigned char* w_ring = smem + ST * X_STAGE;
  uint32_t* wt = reinterpret_cast<uint32_t*>(w_ring + ST * W_STAGE);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nsplit = static_cast<int>(cluster.num_blocks());
  const int tiles_m = (m + BM - 1) / BM;
  const int row0 = (blockIdx.y % tiles_m) * BM;
  const int col0 = (blockIdx.y / tiles_m) * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int ktiles = (n + BK - 1) / BK;
  const int kt0 = rank * (k_per_split / BK);
  const int nk = max(0, min(ktiles, kt0 + k_per_split / BK) - kt0);

  // copies of k-tile kt into ring slot `slot`: x codes and raw weight rows
  auto issue = [&](int kt, int slot) {
    const int k0 = kt * BK;
    unsigned char* xd = x_ring + slot * X_STAGE;
    for (int e = tid; e < BM * BK / 16; e += NT) {
      const int r = e / (BK / 16), c16 = e % (BK / 16) * 16;
      const bool ok = row0 + r < m && k0 + c16 < ldq;
      cp_async<16>(xd + r * XSTR + c16, ok ? xq + (size_t)(row0 + r) * ldq + k0 + c16 : xq,
                   ok ? 16 : 0);
    }
    unsigned char* wd = w_ring + slot * W_STAGE;
    for (int e = tid; e < BK * BN / 16; e += NT) {
      const int rr = e / (BN / 16), c16 = e % (BN / 16) * 16;
      const int k = k0 + rr, col = col0 + c16;
      if (wvec) {
        const bool ok = k < n && col < p;
        cp_async<16>(wd + rr * BN + c16, ok ? w + (size_t)k * p + col : w, ok ? 16 : 0);
      } else {
        for (int b = 0; b < 16; ++b)
          wd[rr * BN + c16 + b] = k < n && col + b < p ? w[(size_t)k * p + col + b] : 0;
      }
    }
  };

  // the raw weight stage into the k-major copy: word [kb][col] = k 4kb ..
  // 4kb + 3 of column col; a warp reads one row of words, writes 512 bytes
  auto transpose = [&](int slot) {
    const uint32_t* wr = reinterpret_cast<const uint32_t*>(w_ring + slot * W_STAGE);
    for (int e = tid; e < BK / 4 * (BN / 4); e += NT) {
      const int kb = e / (BN / 4), cw = e % (BN / 4);
      uint32_t b[4];
      transpose4x4(wr[(4 * kb) * (BN / 4) + cw], wr[(4 * kb + 1) * (BN / 4) + cw],
                   wr[(4 * kb + 2) * (BN / 4) + cw], wr[(4 * kb + 3) * (BN / 4) + cw], b);
      *reinterpret_cast<uint4*>(wt + kb * WTS + 4 * cw) = make_uint4(b[0], b[1], b[2], b[3]);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int st = 0; st < ST - 1; ++st) {
    if (st < nk) issue(kt0 + st, st);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    const int slot = it % ST;
    transpose(slot);
    if (it + ST - 1 < nk) issue(kt0 + it + ST - 1, (it + ST - 1) % ST);
    cp_async_commit();
    __syncthreads();
    const uint32_t* xw = reinterpret_cast<const uint32_t*>(x_ring + slot * X_STAGE);
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int base = (wm + mi * 16 + g) * XW + ks * 8 + t;
        a[mi][0] = xw[base];
        a[mi][1] = xw[base + 8 * XW];
        a[mi][2] = xw[base + 4];
        a[mi][3] = xw[base + 8 * XW + 4];
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int cn = wn + ni * 8 + g;
        b[ni][0] = wt[(ks * 8 + t) * WTS + cn];
        b[ni][1] = wt[(ks * 8 + 4 + t) * WTS + cn];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
  }
  cp_async_wait<0>();

  if (nsplit == 1) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wm + mi * 16 + g + 8 * h;
        if (row >= m) continue;
        const float rs = xs[row];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = col0 + wn + ni * 8 + 2 * t + e;
            if (col < p)
              y[(size_t)row * p + col] = cast_out<T>(dequant(acc[mi][ni][2 * h + e], rs, s[col]));
          }
      }
    return;
  }

  // split k: park the int32 partial tile over the rings, then each CTA sums
  // 1/nsplit of the tile over the cluster
  __syncthreads();
  int* part = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        *reinterpret_cast<int2*>(part + (wm + mi * 16 + g + 8 * h) * BN + wn + ni * 8 + 2 * t) =
            make_int2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
  cluster.sync();
  constexpr int OUTS = BM * BN;
  const int per = (OUTS + nsplit - 1) / nsplit;
  const int e1 = min(OUTS, (rank + 1) * per);
  for (int e = rank * per + tid; e < e1; e += NT) {
    const int row = row0 + e / BN, col = col0 + e % BN;
    if (row >= m || col >= p) continue;
    int a = 0;
    for (int r = 0; r < nsplit; ++r) a += cluster.map_shared_rank(part, r)[e];
    y[(size_t)row * p + col] = cast_out<T>(dequant(a, xs[row], s[col]));
  }
  cluster.sync();
}

// Launch the plan of kernels/gemm_plan.py::w8a8_plan (prefill form): the
// row-quantize kernel into xq (m, ldq) / xs (m,), then the tile GEMM; any
// other plan is cudaErrorInvalidValue.
template <typename T>
cudaError_t launch_w8a8_tile(const T* x, int m, int n, const int8_t* w, const float* s, T* y,
                             int p, int8_t* xq, float* xs, int ldq, int bm, int bn, int split,
                             int k_per_split, int smem, cudaStream_t st) {
  const long long tiles = (long long)((m + W8A8_BM - 1) / W8A8_BM) * ((p + W8A8_BN - 1) / W8A8_BN);
  const bool ok = bm == W8A8_BM && bn == W8A8_BN && split >= 1 && split <= 8 &&
                  k_per_split > 0 && k_per_split % W8A8_BK == 0 &&
                  (long long)k_per_split * split >= n && ldq >= n && ldq % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(xq) % 16 == 0 && tiles <= 65535 &&
                  smem == w8a8_tile_smem_bytes(split);
  if (!ok) return cudaErrorInvalidValue;
  const bool xvec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
  act_quant_kernel<T><<<m, 256, 0, st>>>(x, n, xvec, xq, ldq, xs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto kern = w8a8_mma_kernel<T>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, w8a8_tile_smem_bytes(2));
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, static_cast<unsigned>(tiles), 1);
  cfg.blockDim = dim3(W8A8_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = split;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = 1;
  cfg.attrs = la;
  cfg.numAttrs = 1;
  const bool wvec = p % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  return cudaLaunchKernelEx(&cfg, kern, static_cast<const int8_t*>(xq), ldq,
                            static_cast<const float*>(xs), w, s, y, m, n, p, k_per_split, wvec);
}

}  // namespace gk
