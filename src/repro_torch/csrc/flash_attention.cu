// fa_tc_kernel — prefill flash attention with causal, sliding-window,
// soft-cap and q_offset; GQA maps flattened q head bh to kv head bh / g.
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (_fa_kernel). The TPU kernel walks KV blocks as the sequential grid axis
// with m/l/acc in VMEM scratch; here one CTA of 4 warps owns a 64-row q
// tile of one head and loops over the KV tiles itself.
// Bound on the H100: at hundreds of tokens the 4 * d flops per live (query,
// key) pair, so the design puts both products on tensor cores:
//   - each warp owns 16 query rows; QK^T and PV are mma.sync tiles, m16n8k8
//     TF32 for f32 inputs and m16n8k16 bf16 (f32 accumulation) for bf16.
//     f32 keeps f32 accuracy through 3xTF32 (mma_tf32.cuh);
//   - the S tile, the row max m, the row sum l (per-thread partials, summed
//     over the quad at the end) and the O accumulator stay in registers;
//     row maxima meet through quad shuffles. S's accumulator layout is
//     reused as PV's A fragment without moving data: in TF32 the 8 keys of
//     an n-tile are taken in the order (2t, 2t + 1) -> k slots (t, t + 4),
//     and V's B fragment reads rows 2t and 2t + 1 to match; in bf16 two
//     n-tiles pack into one k16 fragment, and V's comes by ldmatrix.trans;
//   - Q is copied once, K/V tiles through a 2-stage cp.async ring (the next
//     tile lands while this one computes); head dims are padded with zeros
//     in shared memory to the instantiation's DP (16, 32, 64, 80, 96, 128,
//     192 or 256), and the KV tile BKV per (DP, dtype) is the largest of 64,
//     32, 16 whose shared memory lets two CTAs share an SM, else the largest
//     that fits one (kernels/flash_attention.py::fa_plan, checked here);
//   - KV tiles dead by structure for the whole CTA are never loaded, and a
//     warp skips the math of a tile that is in the future (causal) or
//     behind the window for all of its rows once each row has a live key
//     elsewhere — exact, since such a tile adds exp(-1e30 - m) = 0 or is
//     wiped by alpha = 0. Masked scores are -1e30 as in the TPU kernel (a
//     tile wholly masked for a row before its first live key adds p = 1
//     terms that alpha = exp(-1e30 - m) = 0 wipes at the first live tile);
//     keys past skv contribute exactly 0; a row with l == 0 is divided by 1;
//     in bf16 the unnormalised p is rounded to bf16 before PV, as the TPU
//     kernel does. Causal q tiles start heaviest first.
//
// The page-table decode kernel is paged_attention.cu.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "gemm_src.cuh"
#include "gemm_tile.cuh"
#include "mma_tf32.cuh"

namespace {

// ---- prefill: tensor-core flash attention (fa_tc_kernel) ----

namespace fa {

constexpr int WARPS = 4;
constexpr int BQ = 16 * WARPS;        // q rows of a CTA, 16 a warp
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;             // K/V cp.async ring
constexpr int MAX_SMEM = 232448;      // one CTA's dynamic shared memory limit
constexpr int TWO_CTA_SMEM = 115712;  // two CTAs an SM (228 KB, 1 KB reserved each)
constexpr float NEG = -1e30f;         // a masked score

// shared memory row stride in elements: 16 bytes of pad keeps the fragment
// loads free of bank conflicts and every row 16-byte aligned
__host__ __device__ constexpr int ld_of(int dp, int elem) { return dp + 16 / elem; }
__host__ __device__ constexpr int smem_of(int dp, int bkv, int elem) {
  return (BQ + 2 * STAGES * bkv) * ld_of(dp, elem) * elem;
}
// the plan's rule (kernels/flash_attention.py::fa_plan)
__host__ __device__ constexpr int bkv_of(int dp, int elem) {
  for (int b = 64; b >= 16; b /= 2)
    if (smem_of(dp, b, elem) <= TWO_CTA_SMEM) return b;
  for (int b = 64; b >= 16; b /= 2)
    if (smem_of(dp, b, elem) <= MAX_SMEM) return b;
  return 0;
}

using tc::mma_3xtf32;
using tc::split;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// B fragments of two adjacent 8-column n-tiles of a row-major k16 x 16
// bf16 tile (rows = k), transposed on the way by ldmatrix
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// rows [0, rows) of a row-major (., d) global tile into shared memory of
// row stride LD; rows at or past `live` read zero. gran: elements of one
// copy (16 bytes, 4 bytes, or 0 for plain loads where neither aligns)
template <typename T, int LD>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int rows, int live, int d,
                                          int gran) {
  if (gran == 16 / (int)sizeof(T)) {
    const int per = d / gran;
    for (int e = threadIdx.x; e < rows * per; e += THREADS) {
      const int r = e / per, c = (e % per) * gran;
      const bool ok = r < live;
      gk::cp_async<16>(dst + r * LD + c, ok ? src + (size_t)r * d + c : src, ok ? 16 : 0);
    }
  } else if (gran == 4 / (int)sizeof(T)) {
    const int per = d / gran;
    for (int e = threadIdx.x; e < rows * per; e += THREADS) {
      const int r = e / per, c = (e % per) * gran;
      const bool ok = r < live;
      gk::cp_async<4>(dst + r * LD + c, ok ? src + (size_t)r * d + c : src, ok ? 4 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * d; e += THREADS) {
      const int r = e / d, c = e % d;
      dst[r * LD + c] = r < live ? src[(size_t)r * d + c] : T{};
    }
  }
}

// minBlocksPerSM 1: without it ptxas spills a few bytes at two
// instantiations to reach 128 registers (an occupancy the shared memory
// does not allow anyway)
template <typename T, int DP, int BKV>
__global__ void __launch_bounds__(THREADS, 1)
fa_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int sq, int skv, int d, int g, float scale, int causal,
             int window, float softcap, int q_offset, int gran) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int LD = ld_of(DP, sizeof(T));
  constexpr int NS = BKV / 8;   // S n-tiles (8 keys each)
  constexpr int ND = DP / 8;    // O n-tiles (8 head columns each)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);   // BQ x LD
  T* ks = qs + BQ * LD;                     // STAGES x BKV x LD
  T* vs = ks + STAGES * BKV * LD;           // STAGES x BKV x LD

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest causal tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const T* qb = q + ((size_t)bh * sq + q0) * d;
  const T* kb = k + (size_t)(bh / g) * skv * d;
  const T* vb = v + (size_t)(bh / g) * skv * d;
  T* ob = o + (size_t)bh * sq * d;

  // head columns d .. DP are zero in every tile (no copy writes them)
  if (d < DP) {
    constexpr int ROWS = BQ + 2 * STAGES * BKV;
    for (int e = threadIdx.x; e < ROWS * (DP - d); e += THREADS)
      qs[(e / (DP - d)) * LD + d + e % (DP - d)] = T{};
  }

  const int nq = min(BQ, sq - q0);
  const int qfirst = q_offset + q0;
  const int qlast = qfirst + nq - 1;
  const int kv_hi = causal ? min(skv, qlast + 1) : skv;
  int kv_lo = window > 0 ? max(0, qfirst - window + 1) : 0;
  kv_lo = (kv_lo / BKV) * BKV;
  const int ntiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BKV - 1) / BKV : 0;
  // this warp's rows (wrows <= 0: none live)
  const int wrows = min(16, sq - q0 - warp * 16);
  const int wfirst = qfirst + warp * 16;
  const int wlast = wfirst + wrows - 1;

  auto issue = [&](int it) {
    const int k0 = kv_lo + it * BKV;
    const int live = min(BKV, skv - k0);
    const int s = it % STAGES;
    copy_rows<T, LD>(ks + s * BKV * LD, kb + (size_t)k0 * d, BKV, live, d, gran);
    copy_rows<T, LD>(vs + s * BKV * LD, vb + (size_t)k0 * d, BKV, live, d, gran);
  };
  copy_rows<T, LD>(qs, qb, BQ, nq, d, gran);
  if (ntiles > 0) issue(0);
  gk::cp_async_commit();

  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};   // rows gq, gq + 8
  const T* qw = qs + (warp * 16 + gq) * LD;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) issue(it + 1);
    gk::cp_async_commit();
    gk::cp_async_wait<1>();
    __syncthreads();
    const int k0 = kv_lo + it * BKV;
    const T* kt = ks + (it % STAGES) * BKV * LD;
    const T* vt = vs + (it % STAGES) * BKV * LD;
    // a tile in the future (causal) or behind the window for every row of
    // the warp adds nothing once each row has its own key wlast < skv live
    // in another tile
    bool live = wrows > 0;
    if (causal && k0 > wlast && wlast < skv) live = false;
    if (window > 0 && k0 + BKV <= wfirst - window + 1 && wlast < skv) live = false;
    if (live) {
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;

      // S = Q K^T
      if constexpr (BF16) {
#pragma unroll 2
        for (int kk = 0; kk < DP; kk += 16) {
          const T* qa = qw + kk + 2 * tq;
          const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(qa),
                                 *reinterpret_cast<const uint32_t*>(qa + 8 * LD),
                                 *reinterpret_cast<const uint32_t*>(qa + 8),
                                 *reinterpret_cast<const uint32_t*>(qa + 8 * LD + 8)};
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            const T* kp = kt + (j * 8 + gq) * LD + kk + 2 * tq;
            const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(kp),
                                   *reinterpret_cast<const uint32_t*>(kp + 8)};
            mma_bf16(s[j], a, b);
          }
        }
      } else {
#pragma unroll 2
        for (int kk = 0; kk < DP; kk += 8) {
          const float* qa = reinterpret_cast<const float*>(qw) + kk + tq;
          uint32_t ab[4], as[4];
          split(qa[0], ab[0], as[0]);
          split(qa[8 * LD], ab[1], as[1]);
          split(qa[4], ab[2], as[2]);
          split(qa[8 * LD + 4], ab[3], as[3]);
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            const float* kp = reinterpret_cast<const float*>(kt) + (j * 8 + gq) * LD + kk + tq;
            uint32_t bb[2], bs[2];
            split(kp[0], bb[0], bs[0]);
            split(kp[4], bb[1], bs[1]);
            mma_3xtf32(s[j], ab, as, bb, bs);
          }
        }
      }

      // scale, soft cap, masks; the row maxima of this tile
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + j * 8 + 2 * tq + (e & 1);
          const int qp = wfirst + gq + (e >> 1) * 8;
          float x;
          if (kp >= skv) {
            x = -INFINITY;      // past the sequence: contributes exactly 0
          } else {
            x = s[j][e] * scale;
            if (softcap > 0.f) x = softcap * tanhf(x / softcap);
            bool ok = true;
            if (causal) ok = kp <= qp;
            if (window > 0) ok = ok && kp > qp - window;
            if (!ok) x = NEG;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_cur = fmaxf(m_r[h], mx[h]);
        alpha[h] = expf(m_r[h] - m_cur);
        m_r[h] = m_cur;
      }
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[j][e];
          const float pe = x == -INFINITY ? 0.f : expf(x - m_r[e >> 1]);
          sum[e >> 1] += pe;
          s[j][e] = pe;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_r[h] = l_r[h] * alpha[h] + sum[h];
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        acc[i][0] *= alpha[0];
        acc[i][1] *= alpha[0];
        acc[i][2] *= alpha[1];
        acc[i][3] *= alpha[1];
      }

      // O += P V
      if constexpr (BF16) {
#pragma unroll
        for (int j = 0; j < NS / 2; ++j) {
          const uint32_t a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                 pack_bf16(s[2 * j][2], s[2 * j][3]),
                                 pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                 pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
          // lanes 0-7 / 8-15 address keys 0-7 / 8-15 of column tile i,
          // lanes 16-31 the same keys of tile i + 1
          const T* vrow = vt + (j * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
          for (int i = 0; i < ND; i += 2) {
            uint32_t r[4];
            ldmatrix_x4_trans(r, vrow + i * 8);
            const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
            mma_bf16(acc[i], a, b0);
            mma_bf16(acc[i + 1], a, b1);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          // key 2t of the n-tile in k slot t, key 2t + 1 in slot t + 4
          uint32_t ab[4], as[4];
          split(s[j][0], ab[0], as[0]);
          split(s[j][2], ab[1], as[1]);
          split(s[j][1], ab[2], as[2]);
          split(s[j][3], ab[3], as[3]);
          const float* vp = reinterpret_cast<const float*>(vt) + (j * 8 + 2 * tq) * LD + gq;
#pragma unroll
          for (int i = 0; i < ND; ++i) {
            uint32_t bb[2], bs[2];
            split(vp[i * 8], bb[0], bs[0]);
            split(vp[i * 8 + LD], bb[1], bs[1]);
            mma_3xtf32(acc[i], ab, as, bb, bs);
          }
        }
      }
    }
    __syncthreads();   // this stage is free for the copy issued next trip
  }
  gk::cp_async_wait<0>();

  float lsum[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    lsum[h] = l == 0.f ? 1.f : l;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + gq + h * 8;
    if (row >= sq) continue;
    T* orow = ob + (size_t)row * d;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int c = i * 8 + 2 * tq;
      if (c < d) orow[c] = rt::from_f32<T>(acc[i][2 * h] / lsum[h]);
      if (c + 1 < d) orow[c + 1] = rt::from_f32<T>(acc[i][2 * h + 1] / lsum[h]);
    }
  }
}

template <typename T, int DP>
int run(const void* q, const void* k, const void* v, void* o, int bh, int bh_kv, int sq, int skv,
        int d, float scale, int causal, int window, float softcap, int q_offset, int bkv,
        int smem, void* stream) {
  constexpr int BKV = bkv_of(DP, sizeof(T));
  constexpr int SMEM = smem_of(DP, BKV, sizeof(T));
  static_assert(BKV > 0 && SMEM <= MAX_SMEM, "no KV tile fits");
  if (bkv != BKV || smem != SMEM || d > DP) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = fa_tc_kernel<T, DP, BKV>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  auto aligned = [](const void* p, int a) { return reinterpret_cast<uintptr_t>(p) % a == 0; };
  const int bytes = d * static_cast<int>(sizeof(T));
  const int gran = bytes % 16 == 0 && aligned(q, 16) && aligned(k, 16) && aligned(v, 16)
                       ? 16 / static_cast<int>(sizeof(T))
                   : bytes % 4 == 0 && aligned(q, 4) && aligned(k, 4) && aligned(v, 4)
                       ? 4 / static_cast<int>(sizeof(T))
                       : 0;
  dim3 grid((sq + BQ - 1) / BQ, bh);
  kern<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, skv, d, bh / bh_kv, scale, causal, window, softcap, q_offset, gran);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh, int bh_kv, int sq,
             int skv, int d, float scale, int causal, int window, float softcap, int q_offset,
             int dp, int bkv, int smem, void* stream) {
#define FA_RUN(DP)                                                                          \
  run<T, DP>(q, k, v, o, bh, bh_kv, sq, skv, d, scale, causal, window, softcap, q_offset, bkv, \
             smem, stream)
  switch (dp) {
    case 16: return FA_RUN(16);
    case 32: return FA_RUN(32);
    case 64: return FA_RUN(64);
    case 80: return FA_RUN(80);
    case 96: return FA_RUN(96);
    case 128: return FA_RUN(128);
    case 192: return FA_RUN(192);
    case 256: return FA_RUN(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FA_RUN
}

}  // namespace fa

}  // namespace

// dp, bkv, smem: the launch plan (kernels/flash_attention.py::fa_plan)
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int bh,
                                      int bh_kv, int sq, int skv, int d, float scale, int causal,
                                      int window, float softcap, int q_offset, int is_bf16,
                                      int dp, int bkv, int smem, void* stream) {
  if (d < 1 || d > 256) return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16 ? fa::dispatch<__nv_bfloat16>(q, k, v, o, bh, bh_kv, sq, skv, d, scale, causal,
                                               window, softcap, q_offset, dp, bkv, smem, stream)
                 : fa::dispatch<float>(q, k, v, o, bh, bh_kv, sq, skv, d, scale, causal, window,
                                       softcap, q_offset, dp, bkv, smem, stream);
}
