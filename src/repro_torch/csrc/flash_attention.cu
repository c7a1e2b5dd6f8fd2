// Online-softmax (flash) attention with causal, sliding-window, soft-cap
// and q_offset; GQA maps flattened q head bh to kv head bh / g.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (_fa_kernel). The TPU kernel walks KV blocks as the sequential grid axis
// with m/l/acc in VMEM scratch; here one CTA owns a 32-row q tile of one
// head and loops over the KV tiles itself, keeping m and l in shared
// memory and the output accumulator in registers (thread = one row x
// d/8 columns, so d <= 128).
//
// Kept semantics: KV tiles that are dead by structure (wholly above the
// causal diagonal or wholly behind the window) are never loaded - the loop
// runs only over [kv_lo, kv_hi) computed from the tile's first and last
// query position; masked scores are -1e30 as in the reference; rows with
// l == 0 are divided by 1. Ragged q and kv tails are masked here (the TPU
// kernel required sq % bq == 0); kv positions past skv contribute exactly 0.
//
// Bound on the H100: at prefill lengths (hundreds of tokens, d = 80) the
// score and PV FMAs on CUDA cores bound it; the shared-memory dot products
// are simple and not yet on tensor cores (later work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "gemm_tile.cuh"

namespace {

constexpr int BQ = 32;
constexpr int BKV = 64;
constexpr int NT = 256;
constexpr int DMAX = 128;
constexpr float NEG = -1e30f;

template <typename T>
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

    // online softmax: warp w owns rows 4w .. 4w+3, a lane owns 2 columns
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
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        // the reference multiplies p cast to v's dtype
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

template <typename T>
int run(const void* q, const void* k, const void* v, void* o, int bh, int bh_kv, int sq,
        int skv, int d, float scale, int causal, int window, float softcap, int q_offset,
        void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + 2 * BKV) * (d + 1) + BQ * (BKV + 1) + 3 * BQ);
  cudaError_t err = cudaFuncSetAttribute(fa_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + BQ - 1) / BQ, bh);
  fa_kernel<T><<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, skv, d, bh / bh_kv, scale, causal, window, softcap, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int bh,
                                      int bh_kv, int sq, int skv, int d, float scale, int causal,
                                      int window, float softcap, int q_offset, int is_bf16,
                                      void* stream) {
  if (d < 1 || d > DMAX) return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16 ? run<__nv_bfloat16>(q, k, v, o, bh, bh_kv, sq, skv, d, scale, causal, window,
                                      softcap, q_offset, stream)
                 : run<float>(q, k, v, o, bh, bh_kv, sq, skv, d, scale, causal, window, softcap,
                              q_offset, stream);
}
