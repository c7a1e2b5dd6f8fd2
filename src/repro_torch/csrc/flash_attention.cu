// Online-softmax attention, two kernels sharing one tile step:
//
// fa_kernel — prefill flash attention with causal, sliding-window, soft-cap
// and q_offset; GQA maps flattened q head bh to kv head bh / g.
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (_fa_kernel). The TPU kernel walks KV blocks as the sequential grid axis
// with m/l/acc in VMEM scratch; here one CTA owns a 32-row q tile of one
// head and loops over the KV tiles itself, keeping m and l in shared
// memory and the output accumulator in registers (thread = one row x
// d/8 columns; the accumulator is sized by a template bound, 128 or 256,
// so head_dim up to 256 runs).
//
// paged_kernel — page-table-native decode attention.
// Replaces: src/repro/kernels/flash_attention.py::paged_flash_attention
// (_paged_kernel). The TPU kernel's K/V index maps read table[b, ip] by
// scalar prefetch; here a CTA owns (slot b, kv head, up to 32 of its
// g * sq query rows), reads its slot's clock last[b] and walks only the
// live pages [ip_lo, ip_hi) — pages past last[b] (allocation headroom,
// sink rows) or wholly behind the window are never loaded — loading each
// K/V row through table[b, pos / page]. Query row i of slot b sits at
// position last[b] - (sq - 1) + i and sees kv positions <= its own (and
// inside the window); masked scores inside a live page are -1e30 as in
// the TPU kernel, rows with l == 0 are divided by 1.
//
// Kept semantics (both): KV tiles dead by structure are skipped; masked
// scores are -1e30; kv rows past the sequence (or past the live pages)
// contribute exactly 0. Ragged q and kv tails are masked here (the TPU
// kernels pad q to a sublane).
//
// Bound on the H100: prefill at hundreds of tokens is bound by the score
// and PV FMAs on CUDA cores (not yet on tensor cores). Decode attention
// reads each live K/V page once per (slot, kv head) and does 4 * d flops
// per (query row, key): it is memory-bound, and at decode batch sizes
// latency-bound by its serial walk over the pages (no split over pages
// yet; later work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "gemm_tile.cuh"

namespace {

constexpr int BQ = 32;
constexpr int BKV = 64;
constexpr int NT = 256;
constexpr float NEG = -1e30f;

size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)(BQ + 2 * BKV) * (d + 1) + BQ * (BKV + 1) + 3 * BQ);
}

// One KV tile: ss holds BQ x BKV scores (NEG where masked, -INF where the
// row contributes exactly 0). Updates the running max m and sum l per row,
// rescales the accumulator and adds P @ V. TV is v's dtype: for bf16 the
// unnormalised p is rounded to it before PV, as the TPU kernels do.
template <typename TV, int DMAX>
__device__ __forceinline__ void softmax_pv(float* ss, float* m_s, float* l_s, float* a_s,
                                           const float* vs, int dp, int d,
                                           float (&acc)[DMAX / 8]) {
  const int tid = threadIdx.x;
  // warp w owns rows 4w .. 4w+3, a lane owns 2 columns
  const int warp = tid / 32, lane = tid % 32;
  for (int rr = 0; rr < BQ / (NT / 32); ++rr) {
    const int r = warp * (BQ / (NT / 32)) + rr;
    float* row = ss + r * (BKV + 1);
    const float s0 = row[lane], s1 = row[lane + 32];
    float mx = fmaxf(s0, s1);
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_prev = m_s[r];
    const float m_cur = fmaxf(m_prev, mx);
    const float p0 = (s0 == -INFINITY) ? 0.f : expf(s0 - m_cur);
    const float p1 = (s1 == -INFINITY) ? 0.f : expf(s1 - m_cur);
    float sum = p0 + p1;
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if constexpr (std::is_same<TV, __nv_bfloat16>::value) {
      row[lane] = __bfloat162float(__float2bfloat16(p0));
      row[lane + 32] = __bfloat162float(__float2bfloat16(p1));
    } else {
      row[lane] = p0;
      row[lane + 32] = p1;
    }
    __syncwarp();
    if (lane == 0) {
      const float alpha = expf(m_prev - m_cur);
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = m_cur;
      a_s[r] = alpha;
    }
  }
  __syncthreads();

  const int ar = tid / 8, ac = tid % 8;
  const float alpha = a_s[ar];
  const float* prow = ss + ar * (BKV + 1);
#pragma unroll
  for (int i = 0; i < DMAX / 8; ++i) {
    const int c = ac + 8 * i;
    if (c < d) {
      float t = acc[i] * alpha;
      for (int j = 0; j < BKV; ++j) t = fmaf(prow[j], vs[j * dp + c], t);
      acc[i] = t;
    }
  }
  __syncthreads();
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int sq, int skv, int d, int g, float scale, int causal, int window,
          float softcap, int q_offset) {
  extern __shared__ float sm[];
  const int dp = d + 1;
  float* qs = sm;                       // BQ x dp
  float* ks = qs + BQ * dp;             // BKV x dp
  float* vs = ks + BKV * dp;            // BKV x dp
  float* ss = vs + BKV * dp;            // BQ x (BKV + 1)
  float* m_s = ss + BQ * (BKV + 1);     // BQ
  float* l_s = m_s + BQ;                // BQ
  float* a_s = l_s + BQ;                // BQ

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const T* qb = q + (size_t)bh * sq * d;
  const T* kb = k + (size_t)(bh / g) * skv * d;
  const T* vb = v + (size_t)(bh / g) * skv * d;
  T* ob = o + (size_t)bh * sq * d;

  for (int i = tid; i < BQ * d; i += NT) {
    const int r = i / d, c = i % d;
    qs[r * dp + c] = (q0 + r < sq) ? rt::to_f32(qb[(size_t)(q0 + r) * d + c]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }

  const int ar = tid / 8;       // accumulator row owned by this thread
  const int ac = tid % 8;       // first accumulator column (stride 8)
  float acc[DMAX / 8];
#pragma unroll
  for (int i = 0; i < DMAX / 8; ++i) acc[i] = 0.f;

  const int nq = min(BQ, sq - q0);
  const int qfirst = q_offset + q0;
  const int qlast = qfirst + nq - 1;
  const int kv_hi = causal ? min(skv, qlast + 1) : skv;
  int kv_lo = window > 0 ? max(0, qfirst - window + 1) : 0;
  kv_lo = (kv_lo / BKV) * BKV;
  __syncthreads();

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BKV) {
    for (int i = tid; i < BKV * d; i += NT) {
      const int r = i / d, c = i % d;
      const bool in = k0 + r < skv;
      ks[r * dp + c] = in ? rt::to_f32(kb[(size_t)(k0 + r) * d + c]) : 0.f;
      vs[r * dp + c] = in ? rt::to_f32(vb[(size_t)(k0 + r) * d + c]) : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < BQ * BKV; i += NT) {
      const int r = i / BKV, j = i % BKV;
      const int kp = k0 + j;
      float s;
      if (kp >= skv) {
        s = -INFINITY;          // past the sequence: contributes exactly 0
      } else {
        float dot = 0.f;
        for (int c = 0; c < d; ++c) dot = fmaf(qs[r * dp + c], ks[j * dp + c], dot);
        s = dot * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        const int qp = qfirst + r;
        bool ok = true;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        if (!ok) s = NEG;
      }
      ss[r * (BKV + 1) + j] = s;
    }
    __syncthreads();
    softmax_pv<T, DMAX>(ss, m_s, l_s, a_s, vs, dp, d, acc);
  }

  if (q0 + ar < sq) {
    float l = l_s[ar];
    if (l == 0.f) l = 1.f;
#pragma unroll
    for (int i = 0; i < DMAX / 8; ++i) {
      const int c = ac + 8 * i;
      if (c < d) ob[(size_t)(q0 + ar) * d + c] = rt::from_f32<T>(acc[i] / l);
    }
  }
}

template <typename TQ, typename TKV, int DMAX>
__global__ void __launch_bounds__(NT)
paged_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp, const TKV* __restrict__ vp,
             const int* __restrict__ table, const int* __restrict__ last, TQ* __restrict__ o,
             int h, int h_kv, int sq, int page, int pp, int d, float scale, int window,
             float softcap) {
  extern __shared__ float sm[];
  const int dp = d + 1;
  float* qs = sm;
  float* ks = qs + BQ * dp;
  float* vs = ks + BKV * dp;
  float* ss = vs + BKV * dp;
  float* m_s = ss + BQ * (BKV + 1);
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int b = blockIdx.z, hk = blockIdx.y;
  const int g = h / h_kv;
  const int r0 = blockIdx.x * BQ;             // first of this CTA's g*sq rows
  const int nr = min(BQ, g * sq - r0);
  const int tid = threadIdx.x;
  const int last_b = last[b];
  const int* trow = table + (size_t)b * pp;

  // row r <-> (q head hk * g + (r0 + r) / sq, query (r0 + r) % sq)
  for (int i = tid; i < BQ * d; i += NT) {
    const int r = i / d, c = i % d;
    float val = 0.f;
    if (r < nr) {
      const int gr = r0 + r;
      const size_t at = (((size_t)b * h + hk * g + gr / sq) * sq + gr % sq) * d + c;
      val = rt::to_f32(q[at]);
    }
    qs[r * dp + c] = val;
  }
  if (tid < BQ) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  const int ar = tid / 8, ac = tid % 8;
  float acc[DMAX / 8];
#pragma unroll
  for (int i = 0; i < DMAX / 8; ++i) acc[i] = 0.f;

  // live pages: ip * page <= last_b, and (window) ip * page + page - 1 >
  // last_b - (sq - 1) - window
  const int ip_hi = last_b >= 0 ? min(pp, last_b / page + 1) : 0;
  int ip_lo = 0;
  if (window > 0) {
    const int x = last_b - (sq - 1) - window - page + 1;
    ip_lo = x < 0 ? 0 : x / page + 1;
  }
  const int pos_hi = ip_hi * page;
  __syncthreads();

  for (int k0 = ip_lo * page; k0 < pos_hi; k0 += BKV) {
    for (int i = tid; i < BKV * d; i += NT) {
      const int j = i / d, c = i % d;
      const int pos = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (pos < pos_hi) {
        const size_t at = (((size_t)trow[pos / page] * h_kv + hk) * page + pos % page) * d + c;
        kv = rt::to_f32(kp[at]);
        vv = rt::to_f32(vp[at]);
      }
      ks[j * dp + c] = kv;
      vs[j * dp + c] = vv;
    }
    __syncthreads();

    for (int i = tid; i < BQ * BKV; i += NT) {
      const int r = i / BKV, j = i % BKV;
      const int pos = k0 + j;
      float s;
      if (r >= nr || pos >= pos_hi) {
        s = -INFINITY;
      } else {
        float dot = 0.f;
        for (int c = 0; c < d; ++c) dot = fmaf(qs[r * dp + c], ks[j * dp + c], dot);
        s = dot * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        const int qp = last_b - (sq - 1) + (r0 + r) % sq;
        bool ok = pos <= qp;
        if (window > 0) ok = ok && pos > qp - window;
        if (!ok) s = NEG;
      }
      ss[r * (BKV + 1) + j] = s;
    }
    __syncthreads();
    softmax_pv<TKV, DMAX>(ss, m_s, l_s, a_s, vs, dp, d, acc);
  }

  if (ar < nr) {
    float l = l_s[ar];
    if (l == 0.f) l = 1.f;
    const int gr = r0 + ar;
    TQ* orow = o + (((size_t)b * h + hk * g + gr / sq) * sq + gr % sq) * d;
#pragma unroll
    for (int i = 0; i < DMAX / 8; ++i) {
      const int c = ac + 8 * i;
      if (c < d) orow[c] = rt::from_f32<TQ>(acc[i] / l);
    }
  }
}

template <typename T, int DMAX>
int run_fa(const void* q, const void* k, const void* v, void* o, int bh, int bh_kv, int sq,
           int skv, int d, float scale, int causal, int window, float softcap, int q_offset,
           void* stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(fa_kernel<T, DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + BQ - 1) / BQ, bh);
  fa_kernel<T, DMAX><<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, skv, d, bh / bh_kv, scale, causal, window, softcap, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_fa(const void* q, const void* k, const void* v, void* o, int bh, int bh_kv, int sq,
                int skv, int d, float scale, int causal, int window, float softcap, int q_offset,
                void* stream) {
  return d <= 128 ? run_fa<T, 128>(q, k, v, o, bh, bh_kv, sq, skv, d, scale, causal, window,
                                   softcap, q_offset, stream)
                  : run_fa<T, 256>(q, k, v, o, bh, bh_kv, sq, skv, d, scale, causal, window,
                                   softcap, q_offset, stream);
}

template <typename TQ, typename TKV, int DMAX>
int run_paged(const void* q, const void* kp, const void* vp, const int* table, const int* last,
              void* o, int b, int h, int h_kv, int sq, int page, int pp, int d, float scale,
              int window, float softcap, void* stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(paged_kernel<TQ, TKV, DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = (h / h_kv) * sq;
  dim3 grid((rows + BQ - 1) / BQ, h_kv, b);
  paged_kernel<TQ, TKV, DMAX><<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp), static_cast<const TKV*>(vp), table,
      last, static_cast<TQ*>(o), h, h_kv, sq, page, pp, d, scale, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int dispatch_paged(const void* q, const void* kp, const void* vp, const int* table,
                   const int* last, void* o, int b, int h, int h_kv, int sq, int page, int pp,
                   int d, float scale, int window, float softcap, void* stream) {
  return d <= 128 ? run_paged<TQ, TKV, 128>(q, kp, vp, table, last, o, b, h, h_kv, sq, page, pp,
                                            d, scale, window, softcap, stream)
                  : run_paged<TQ, TKV, 256>(q, kp, vp, table, last, o, b, h, h_kv, sq, page, pp,
                                            d, scale, window, softcap, stream);
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int bh,
                                      int bh_kv, int sq, int skv, int d, float scale, int causal,
                                      int window, float softcap, int q_offset, int is_bf16,
                                      void* stream) {
  if (d < 1 || d > 256) return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16 ? dispatch_fa<__nv_bfloat16>(q, k, v, o, bh, bh_kv, sq, skv, d, scale, causal,
                                              window, softcap, q_offset, stream)
                 : dispatch_fa<float>(q, k, v, o, bh, bh_kv, sq, skv, d, scale, causal, window,
                                      softcap, q_offset, stream);
}

extern "C" int paged_attention_launch(const void* q, const void* kp, const void* vp,
                                      const void* table, const void* last, void* o, int b, int h,
                                      int h_kv, int sq, int page, int pp, int d, float scale,
                                      int window, float softcap, int q_bf16, int kv_bf16,
                                      void* stream) {
  if (d < 1 || d > 256) return static_cast<int>(cudaErrorInvalidValue);
  const int* tp = static_cast<const int*>(table);
  const int* lp = static_cast<const int*>(last);
  if (q_bf16 && kv_bf16)
    return dispatch_paged<__nv_bfloat16, __nv_bfloat16>(q, kp, vp, tp, lp, o, b, h, h_kv, sq,
                                                         page, pp, d, scale, window, softcap,
                                                         stream);
  if (q_bf16)
    return dispatch_paged<__nv_bfloat16, float>(q, kp, vp, tp, lp, o, b, h, h_kv, sq, page, pp,
                                                d, scale, window, softcap, stream);
  if (kv_bf16)
    return dispatch_paged<float, __nv_bfloat16>(q, kp, vp, tp, lp, o, b, h, h_kv, sq, page, pp,
                                                d, scale, window, softcap, stream);
  return dispatch_paged<float, float>(q, kp, vp, tp, lp, o, b, h, h_kv, sq, page, pp, d, scale,
                                      window, softcap, stream);
}
