// Mamba-1 selective scan: h_t = exp(dt_t * a) * h_{t-1} + (dt_t * u_t) * b_t,
// y_t = c_t . h_t, over a whole prompt, with an f32 state; returns y (u's
// dtype) and the final state h (f32).
//
// Replaces: src/repro/kernels/ssm_scan.py::ssm_scan (_ssm_kernel), the Pallas
// kernel that keeps the (d_inner, d_state) state in VMEM while chunks of the
// sequence stream through.
//
// Bound on the H100: memory. u, dt and y are B * S * d_inner elements each
// and are touched once; b, c and a are small. The work is one exp and ~6
// flops per (position, channel, state) element, which the f32 CUDA-core
// rate covers several times over. The recurrence is serial in S, so the
// parallelism is (batch x d_inner x d_state).
// Design: each (batch, channel) is a group of G lanes (G = d_state rounded
// up to 8, 16 or 32), one state element per lane, held in a register for
// the whole sequence: the state never touches device memory until the one
// final write. A CTA of 256 threads owns 256 / G channels and stages u, dt,
// b and c for 64 positions at a time through shared memory (coalesced along
// d_inner), runs the recurrence, reduces y over the lane group with
// __shfl_xor_sync and writes the y tile back coalesced. The exp is the
// accurate expf, so f32 results stay within 1e-4 of the sequential plain
// version. Any S >= 1; ragged d_inner and the last chunk are masked. No
// tensor cores, pipelining or chunked (parallel) scan yet (later work).
#include "gemm_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;  // positions staged per pass

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ u, const T* __restrict__ dt, const T* __restrict__ b,
                const T* __restrict__ c, const float* __restrict__ a, T* __restrict__ y,
                float* __restrict__ h_out, int s, int di, int st) {
  constexpr int CPB = kThreads / G;  // channels per CTA
  __shared__ float s_u[kChunk][CPB];
  __shared__ float s_dt[kChunk][CPB];
  __shared__ float s_y[kChunk][CPB];
  __shared__ float s_b[kChunk][G];
  __shared__ float s_c[kChunk][G];

  const int tid = threadIdx.x;
  const int j = tid / G;  // channel within the CTA
  const int n = tid % G;  // state element held by this lane
  const int c0 = blockIdx.x * CPB;
  const int ch = c0 + j;
  const bool live = ch < di && n < st;
  // dead lanes (n >= st or ch >= di) see a = 0 and b = 0: their h stays 0
  const float a_n = live ? a[(size_t)ch * st + n] : 0.f;
  const size_t row0 = (size_t)blockIdx.y * s;
  float h = 0.f;

  for (int t0 = 0; t0 < s; t0 += kChunk) {
    const int nt = min(kChunk, s - t0);
    for (int i = tid; i < kChunk * CPB; i += kThreads) {
      const int t = i / CPB, cc = i % CPB;
      const bool ok = t < nt && c0 + cc < di;
      const size_t off = (row0 + t0 + t) * di + c0 + cc;
      s_u[t][cc] = ok ? rt::to_f32(u[off]) : 0.f;
      s_dt[t][cc] = ok ? rt::to_f32(dt[off]) : 0.f;
    }
    for (int i = tid; i < kChunk * G; i += kThreads) {
      const int t = i / G, k = i % G;
      const bool ok = t < nt && k < st;
      const size_t off = (row0 + t0 + t) * st + k;
      s_b[t][k] = ok ? rt::to_f32(b[off]) : 0.f;
      s_c[t][k] = ok ? rt::to_f32(c[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < nt; ++t) {
      const float d = s_dt[t][j];
      h = expf(d * a_n) * h + (d * s_u[t][j]) * s_b[t][n];
      float p = s_c[t][n] * h;
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (n == 0) s_y[t][j] = p;
    }
    __syncthreads();
    // the next pass's staging and barrier come before s_y is written again
    for (int i = tid; i < nt * CPB; i += kThreads) {
      const int t = i / CPB, cc = i % CPB;
      if (c0 + cc < di) y[(row0 + t0 + t) * di + c0 + cc] = rt::from_f32<T>(s_y[t][cc]);
    }
  }
  if (live) h_out[((size_t)blockIdx.y * di + ch) * st + n] = h;
}

template <typename T, int G>
int run(const void* u, const void* dt, const void* b, const void* c, const void* a, void* y,
        void* h, int batch, int s, int di, int st, void* stream) {
  constexpr int CPB = kThreads / G;
  dim3 grid((di + CPB - 1) / CPB, batch);
  ssm_scan_kernel<T, G><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(a), static_cast<T*>(y),
      static_cast<float*>(h), s, di, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_g(const void* u, const void* dt, const void* b, const void* c, const void* a, void* y,
          void* h, int batch, int s, int di, int st, void* stream) {
  if (st <= 8) return run<T, 8>(u, dt, b, c, a, y, h, batch, s, di, st, stream);
  if (st <= 16) return run<T, 16>(u, dt, b, c, a, y, h, batch, s, di, st, stream);
  return run<T, 32>(u, dt, b, c, a, y, h, batch, s, di, st, stream);
}

}  // namespace

// u, dt: (batch, s, di); b, c: (batch, s, st), all f32 or all bf16; a: (di, st)
// f32; y: (batch, s, di) in u's dtype; h: (batch, di, st) f32. 1 <= st <= 32.
extern "C" int ssm_scan_launch(const void* u, const void* dt, const void* b, const void* c,
                               const void* a, void* y, void* h, int batch, int s, int di,
                               int st, int is_bf16, void* stream) {
  if (st < 1 || st > 32 || s < 1 || di < 1 || batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16 ? run_g<__nv_bfloat16>(u, dt, b, c, a, y, h, batch, s, di, st, stream)
                 : run_g<float>(u, dt, b, c, a, y, h, batch, s, di, st, stream);
}
