// Mamba-1 selective scan: h_t = exp(dt_t * a) * h_{t-1} + (dt_t * u_t) * b_t,
// y_t = c_t . h_t, over a whole prompt, with an f32 state; returns y (u's
// dtype) and the final state h (f32).
//
// Replaces: src/repro/kernels/ssm_scan.py::ssm_scan (_ssm_kernel), the Pallas
// kernel that keeps the (d_inner, d_state) state in VMEM while chunks of the
// sequence stream through.
//
// Bound on the H100: u, dt and y are B * S * d_inner elements each and are
// touched once (the byte bound: ~15 us at one falcon-mamba layer's 512-token
// prefill), and every (position, channel, state) element takes one
// exponential, which the SFU retires at 16 a cycle per SM (67 M of them,
// ~18 us on 132 SMs at 1.755 GHz). So the design spends one exponential
// per element and keeps the rest of the step short:
//   - a warp holds 4 state elements (and a[ch, 4k .. 4k + 3]) of 32
//     consecutive channels in registers; G = 1, 2, 4 or 8 warps (the fewest
//     that hold d_state <= 32) share a channel. dt * u is formed once per
//     lane and step; exp(dt * a) is ex2.approx of dt * (a * log2 e), the
//     a * log2 e made once (within ~2e-6 of expf);
//   - a CTA of 4 warps (8 at G = 8) owns 32 * 4 / G channels; u and dt
//     (coalesced along d_inner) and b and c (shared by every channel of the
//     batch row; a warp reads its 4 states' b and c as one float4 whose
//     address is the same in every lane) are staged in shared memory 16
//     (G = 1) or 32 positions at a time: the next positions' loads go out
//     into registers before this block's recurrence runs, so they overlap
//     it;
//   - the recurrence holds no shuffle and no store to global memory, either
//     of which keeps the compiler from moving the next steps' loads and
//     exponentials ahead: 8 steps go at a time, their shared loads,
//     exponentials and input terms first (none depends on h), then the 8
//     dependent updates; each warp's part of y_t (4 FMAs a lane) lands in
//     shared memory after them, and y_t = c_t . h_t is summed over the G
//     warps in state order and stored coalesced after the block;
//   - the grid is (channel blocks, batch) and every CTA scans the whole
//     sequence: falcon-mamba's 8192 channels at 4 warps a channel give
//     1,024 warps, near two a scheduler. (A split of the sequence over the
//     CTAs of a cluster, whose chunks carry the state through a second pass
//     of exponentials, measured slower at every falcon-mamba length.)
// Any S >= 1; ragged d_inner and the last block are masked; dead lanes see
// a = 0 and b = 0, so their h stays 0.
#include "gemm_tile.cuh"

namespace {

constexpr int kStates = 4;     // state elements a lane holds
constexpr float kLog2e = 1.4426950408889634f;

// The CTA shape and its shared memory (dynamic: kernels/ssm_scan.py::
// scan_plan). Warp w holds states 4k .. 4k + 3, k = w % G, of 32 channels.
template <int G>
struct ScanSmem {
  static constexpr int THREADS = 32 * (G > 4 ? G : 4);
  static constexpr int CPB = THREADS / G;   // channels of a CTA
  static constexpr int K = G == 1 ? 16 : 32;   // positions staged at a time
  static constexpr int SW = kStates * G;    // b / c row: d_state padded
  float u[K][CPB];
  float dt[K][CPB];
  __align__(16) float b[K][SW];
  __align__(16) float c[K][SW];
  float yp[K][G][CPB];             // each warp's part of y_t, summed after the block
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// grid (channel blocks, batch). One CTA an SM is all the launch bound asks:
// without it ptxas holds G = 2 to 168 registers and spills.
template <typename T, int G>
__global__ void __launch_bounds__(ScanSmem<G>::THREADS, 1)
ssm_scan_kernel(const T* __restrict__ u, const T* __restrict__ dt, const T* __restrict__ b,
                const T* __restrict__ c, const float* __restrict__ a, T* __restrict__ y,
                float* __restrict__ h_out, int s, int di, int st) {
  using S = ScanSmem<G>;
  constexpr int NT = S::THREADS, CPB = S::CPB, K = S::K, SW = S::SW;
  constexpr int UPT = K * CPB / NT;                  // u, dt elements a thread stages
  constexpr int BPT = (K * SW + NT - 1) / NT;        // b, c elements
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32;
  const int k = warp % G, j = (warp / G) * 32 + tid % 32;
  const int c0 = blockIdx.x * CPB, ch = c0 + j;
  const size_t row0 = (size_t)blockIdx.y * s;
  const T zero = rt::from_f32<T>(0.f);
  float a2[kStates], h[kStates];
#pragma unroll
  for (int n = 0; n < kStates; ++n) {
    const int sn = kStates * k + n;
    a2[n] = ch < di && sn < st ? a[(size_t)ch * st + sn] * kLog2e : 0.f;
    h[n] = 0.f;
  }
  // raw elements in registers: widened when stored, so the loads stay in
  // flight through the recurrence
  T ru[UPT], rd[UPT], rb[BPT], rc[BPT];
  auto load = [&](int t0) {
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      const int e = tid + i * NT, t = e / CPB, cc = e % CPB;
      const bool ok = t0 + t < s && c0 + cc < di;
      const size_t off = (row0 + t0 + t) * di + c0 + cc;
      ru[i] = ok ? u[off] : zero;
      rd[i] = ok ? dt[off] : zero;
    }
#pragma unroll
    for (int i = 0; i < BPT; ++i) {
      const int e = tid + i * NT, t = e / SW, kk = e % SW;
      const bool ok = e < K * SW && t0 + t < s && kk < st;
      const size_t off = (row0 + t0 + t) * st + kk;
      rb[i] = ok ? b[off] : zero;
      rc[i] = ok ? c[off] : zero;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      const int e = tid + i * NT, t = e / CPB, cc = e % CPB;
      sm.u[t][cc] = rt::to_f32(ru[i]);
      sm.dt[t][cc] = rt::to_f32(rd[i]);
    }
#pragma unroll
    for (int i = 0; i < BPT; ++i) {
      const int e = tid + i * NT, t = e / SW, kk = e % SW;
      if (e < K * SW) {
        sm.b[t][kk] = rt::to_f32(rb[i]);
        sm.c[t][kk] = rt::to_f32(rc[i]);
      }
    }
  };

  load(0);
  for (int t0 = 0; t0 < s; t0 += K) {
    __syncthreads();   // the previous block's reads are done
    store();
    __syncthreads();
    if (t0 + K < s) load(t0 + K);
    // steps in groups of 8; positions past s were staged as dt = u = 0,
    // which leaves h as it is
    const int nt = min(K, s - t0);
    for (int tg = 0; tg < nt; tg += 8) {
      // the group's exponentials, input terms and c first: none depends on
      // h, so they go out back to back; then the 8 dependent updates
      float e[8][kStates], xb[8][kStates], cn[8][kStates];
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const int t = tg + v;
        const float d = sm.dt[t][j];
        const float x = d * sm.u[t][j];
        // k is the same across the warp: one broadcast per row
        const float4 bv = *reinterpret_cast<const float4*>(&sm.b[t][kStates * k]);
        const float4 cv = *reinterpret_cast<const float4*>(&sm.c[t][kStates * k]);
        const float bn[kStates] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int n = 0; n < kStates; ++n) {
          e[v][n] = ex2(d * a2[n]);
          xb[v][n] = x * bn[n];
        }
        cn[v][0] = cv.x, cn[v][1] = cv.y, cn[v][2] = cv.z, cn[v][3] = cv.w;
      }
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        float p = 0.f;
#pragma unroll
        for (int n = 0; n < kStates; ++n) {
          h[n] = fmaf(e[v][n], h[n], xb[v][n]);
          p = fmaf(cn[v][n], h[n], p);
        }
        sm.yp[tg + v][k][j] = p;
      }
    }
    // y_t of a channel: its G warps' parts, summed in state order
    __syncthreads();
    for (int e = tid; e < nt * CPB; e += NT) {
      const int t = e / CPB, cc = e % CPB;
      float yv = 0.f;
#pragma unroll
      for (int kk = 0; kk < G; ++kk) yv += sm.yp[t][kk][cc];
      if (c0 + cc < di) y[(row0 + t0 + t) * di + c0 + cc] = rt::from_f32<T>(yv);
    }
  }
  if (ch < di) {
#pragma unroll
    for (int n = 0; n < kStates; ++n) {
      const int sn = kStates * k + n;
      if (sn < st) h_out[((size_t)blockIdx.y * di + ch) * st + sn] = h[n];
    }
  }
}

template <typename T, int G>
int run(const void* u, const void* dt, const void* b, const void* c, const void* a, void* y,
        void* h, int batch, int s, int di, int st, int smem, void* stream) {
  using S = ScanSmem<G>;
  constexpr int SMEM = sizeof(S);
  const int blocks = (di + S::CPB - 1) / S::CPB;
  if (smem != SMEM || blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssm_scan_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  ssm_scan_kernel<T, G><<<dim3(blocks, batch), S::THREADS, SMEM,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(a), static_cast<T*>(y),
      static_cast<float*>(h), s, di, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_g(const void* u, const void* dt, const void* b, const void* c, const void* a, void* y,
          void* h, int batch, int s, int di, int st, int groups, int smem, void* stream) {
  // a channel's groups of 4 states: the fewest powers of two that hold st
  const int want = st <= 4 ? 1 : st <= 8 ? 2 : st <= 16 ? 4 : 8;
  if (groups != want) return static_cast<int>(cudaErrorInvalidValue);
  switch (groups) {
    case 1: return run<T, 1>(u, dt, b, c, a, y, h, batch, s, di, st, smem, stream);
    case 2: return run<T, 2>(u, dt, b, c, a, y, h, batch, s, di, st, smem, stream);
    case 4: return run<T, 4>(u, dt, b, c, a, y, h, batch, s, di, st, smem, stream);
    default: return run<T, 8>(u, dt, b, c, a, y, h, batch, s, di, st, smem, stream);
  }
}

}  // namespace

// u, dt: (batch, s, di); b, c: (batch, s, st), all f32 or all bf16; a: (di, st)
// f32; y: (batch, s, di) in u's dtype; h: (batch, di, st) f32. 1 <= st <= 32.
// groups, smem: the launch plan (kernels/ssm_scan.py::scan_plan), checked
// against the instantiations here.
extern "C" int ssm_scan_launch(const void* u, const void* dt, const void* b, const void* c,
                               const void* a, void* y, void* h, int batch, int s, int di,
                               int st, int is_bf16, int groups, int smem, void* stream) {
  if (st < 1 || st > 32 || s < 1 || di < 1 || batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16 ? run_g<__nv_bfloat16>(u, dt, b, c, a, y, h, batch, s, di, st, groups, smem,
                                        stream)
                 : run_g<float>(u, dt, b, c, a, y, h, batch, s, di, st, groups, smem, stream);
}
