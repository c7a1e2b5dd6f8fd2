// Ineffectual-work ledger probe: from one (rows, d) activation that feeds a
// GEMM of fan-out n_out, one ledger row (serve/ledger.py's columns: elements,
// exact zeros, |x| <= threshold, channel groups, k-blocks, dead k-blocks,
// dense and effective FLOPs and bytes, then the histogram of near-zero
// channels per group of `group`), added into the layer's row of the
// device-resident (n_layers, width) f32 ledger, in one launch.
//
// Replaces no TPU kernel. The JAX package's probe is plain array code
// (src/repro/serve/ledger.py, LedgerProbe.measure) that XLA fuses into the
// jitted decode step. Its plain PyTorch version is about a dozen launches a
// tap, ~4 taps a layer and micro-step, so the ledger's cost would be mostly
// launches; this kernel is one.
//
// Bound on the H100: bytes. The activation is read once (8 x 6912 f32 at
// h2o-danube's widest decode tap, 221 KB: ~0.07 us at 3.35 TB/s), so a tap
// costs what a small launch costs. The design keeps it one launch:
//   - a grid-stride pass over the elements (zeros, near-zeros), one over the
//     groups of `group` channels (histogram bins in shared memory) and one
//     over the k-blocks (all near-zero: dead); the second and third read
//     what the first brought into L1 / L2;
//   - counts are unsigned integers: a warp sums its lanes with shuffles,
//     a CTA in shared memory, the CTAs into a zeroed scratch in device
//     memory with integer atomics, exact in any order;
//   - the last CTA to finish (a ticket in the scratch) forms the f32
//     columns once from the integer counts, with the reference's f32
//     arithmetic rounded as it rounds (no FMA contraction), adds them into
//     the ledger row in order, and zeroes the scratch for the next launch.
//     The row is then the same bits in every run, whatever the CTAs' order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFixed = 10;     // fixed columns before the histogram

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// scratch (and shared memory): [0] zeros, [1] near-zeros, [2] dead
// k-blocks, [3 .. 3 + group] histogram bins; the scratch's [4 + group] is
// the CTAs' ticket
template <typename T>
__global__ void __launch_bounds__(kThreads) ledger_probe_kernel(
    const T* __restrict__ x, long long rows, int d, int n_out, float thr,
    int group, int k_block, float* __restrict__ out,
    unsigned int* __restrict__ scratch) {
  extern __shared__ unsigned int sh[];
  __shared__ bool last;
  const int nc = 4 + group;
  for (int i = threadIdx.x; i < nc; i += blockDim.x) sh[i] = 0u;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  unsigned int zeros = 0, near = 0, dead = 0;
  const long long n = rows * d;
  for (long long i = tid; i < n; i += stride) {
    const float v = load(x + i);
    zeros += v == 0.0f;
    near += fabsf(v) <= thr;
  }
  const int dg = d / group;
  const long long ng = rows * dg;
  for (long long u = tid; u < ng; u += stride) {
    const long long r = u / dg;
    const T* p = x + r * d + (u - r * dg) * group;
    int c = 0;
    for (int t = 0; t < group; ++t) c += fabsf(load(p + t)) <= thr;
    atomicAdd(&sh[3 + c], 1u);
  }
  const int dk = d / k_block;
  const long long nk = rows * dk;
  for (long long u = tid; u < nk; u += stride) {
    const long long r = u / dk;
    const T* p = x + r * d + (u - r * dk) * k_block;
    bool all = true;
    for (int t = 0; t < k_block && all; ++t) all = fabsf(load(p + t)) <= thr;
    dead += all;
  }
  for (int off = 16; off; off >>= 1) {
    zeros += __shfl_down_sync(0xffffffffu, zeros, off);
    near += __shfl_down_sync(0xffffffffu, near, off);
    dead += __shfl_down_sync(0xffffffffu, dead, off);
  }
  if ((threadIdx.x & 31) == 0) {
    if (zeros) atomicAdd(&sh[0], zeros);
    if (near) atomicAdd(&sh[1], near);
    if (dead) atomicAdd(&sh[2], dead);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nc; i += blockDim.x)
    if (sh[i]) atomicAdd(&scratch[i], sh[i]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&scratch[nc], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // every other CTA's counts are in: take them and leave the scratch zeroed
  for (int i = threadIdx.x; i < nc; i += blockDim.x) sh[i] = atomicExch(&scratch[i], 0u);
  __syncthreads();
  for (int i = threadIdx.x; i <= group; i += blockDim.x)
    out[kFixed + i] = __fadd_rn(out[kFixed + i], static_cast<float>(sh[3 + i]));
  if (threadIdx.x != 0) return;
  atomicExch(&scratch[nc], 0u);
  // the reference's f32 arithmetic: live = 1 - dead / max(n_kb, 1); the
  // effective columns scale the dense FLOPs and the weight bytes by it
  const float n_kb = static_cast<float>(nk);
  const float deadf = static_cast<float>(sh[2]);
  const float live = dk ? __fsub_rn(1.0f, __fdiv_rn(deadf, fmaxf(n_kb, 1.0f))) : 1.0f;
  const float flops = static_cast<float>(2LL * rows * d * n_out);
  const long long act = 4LL * (rows * d + rows * n_out);
  const long long wgt = 4LL * d * n_out;
  const float col[kFixed] = {
      static_cast<float>(n), static_cast<float>(sh[0]), static_cast<float>(sh[1]),
      static_cast<float>(ng), n_kb, deadf, flops, __fmul_rn(flops, live),
      static_cast<float>(act + wgt),
      __fadd_rn(static_cast<float>(act), __fmul_rn(static_cast<float>(wgt), live))};
  for (int c = 0; c < kFixed; ++c) out[c] = __fadd_rn(out[c], col[c]);
}

template <typename T>
int run(const void* x, long long rows, int d, int n_out, float thr, int group,
        int k_block, void* out, void* scratch, int blocks, cudaStream_t stream) {
  const size_t smem = sizeof(unsigned int) * (4 + group);
  ledger_probe_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), rows, d, n_out, thr, group, k_block,
      static_cast<float*>(out), static_cast<unsigned int*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ledger_probe_launch(const void* x, int is_bf16, long long rows, int d,
                                   int n_out, float threshold, int group, int k_block,
                                   void* out, void* scratch, int blocks, void* stream) {
  if (rows < 1 || d < 1 || n_out < 1 || group < 1 || group > 4096 || k_block < 1 ||
      blocks < 1 || blocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run<__nv_bfloat16>(x, rows, d, n_out, threshold, group, k_block, out,
                                      scratch, blocks, s)
                 : run<float>(x, rows, d, n_out, threshold, group, k_block, out, scratch,
                              blocks, s);
}
