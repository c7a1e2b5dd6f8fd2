// Weight sources of the dense, weight-only and block-sparse x quantized
// GEMMs (gemv_cluster.cuh for decode rows, gemm_pipe.cuh for prefill rows),
// and the copy helpers both share.
//
// A source owns the weight operand's layout, row-major (n / VPB, p) with p
// contiguous, and how one packed row turns into f32 weights:
//   Plain<T>      a float weight (f32 or bf16), VPB = 1;
//   Codes<BITS>   int8 bytes of bit-packed codes along k (_unpack_tile's
//                 layout: value i of a byte at bit offset i * BITS, two's
//                 complement, a sign bit {0 -> -1, 1 -> +1} for 1 bit),
//                 VPB = 8 / BITS, and a per-column f32 scale applied once
//                 after the whole contraction;
//   QBlocks<BITS> the listed blocks of a block-sparse x quantized weight,
//                 codes (n_pb, nnz, bk / VPB, bn) as Codes packs them. A
//                 column tile lies inside one block column j; its logical
//                 k range is the concatenation of j's nnz listed blocks, so
//                 its packed rows are contiguous (row r of block (j, t) is
//                 logical row t * bk / VPB + r) and logical k maps to x's
//                 column idx[j, k / bk] * bk + k % bk;
//   Blocks<T>     the listed float blocks (n_pb, nnz, bk, bn) of a
//                 block-sparse weight: Plain<T>'s quads and unpack over
//                 QBlocks' block-column view, VPB = 1, scale 1.
// A kernel takes the CTA's view of a source with tile(col0) once; xcol(k)
// is the x column of logical k (the identity but for the block sources),
// and kgrain() the run of logical k that maps to contiguous x columns. A
// source with BATCH (Blocks<T> only) also serves a batched launch, whose
// z-th product takes batch(z): the z-th stack of blocks, bstride elements
// in. The kernels compile the batch offsets only for such a source, so
// the other sources' code and registers stay as they were.
// The unit of a decode load is a quad: 4 adjacent columns of one packed
// row (16 bytes of f32, 8 of bf16, one 32-bit word of codes), unpacked with
// compile-time shifts. No float weight is ever written to device memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace gk {

// f(std::integral_constant<int, 0>{}) ... f(<N - 1>): a loop whose index is
// a compile-time constant (the code's value slot within a byte)
template <class F, int... I>
__device__ __forceinline__ void static_for_impl(F& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
template <int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_impl(f, std::make_integer_sequence<int, N>{});
}

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T cast_out(float v);
template <> __device__ __forceinline__ float cast_out<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 cast_out<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// streaming 16/8/4-byte loads through the read-only path, not kept in L1
__device__ __forceinline__ float4 ldg_nc(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0,%1,%2,%3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}
__device__ __forceinline__ uint2 ldg_nc(const uint2* p) {
  uint2 v;
  asm("ld.global.nc.L1::no_allocate.v2.u32 {%0,%1}, [%2];"
               : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}
__device__ __forceinline__ uint32_t ldg_nc(const uint32_t* p) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// cp.async with zero fill: `bytes` of `src` land at `dst`, the rest of the
// SIZE-byte granule reads as zero (bytes = 0 for a masked granule).
template <int SIZE>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (SIZE == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(d), "l"(src), "n"(SIZE),
                 "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bf16x4_to_f32(uint2 v, float* f) {
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}

// 4 consecutive x values (16-byte aligned f32, 8-byte aligned bf16) as f32
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  bf16x4_to_f32(*reinterpret_cast<const uint2*>(p), f);
}

template <typename T>
struct Plain {
  static constexpr int VPB = 1;
  static constexpr int BITS = 0;
  // an f32 quad lands in the f32 tile as it is; bf16 is widened on the way
  static constexpr bool DIRECT = sizeof(T) == 4;
  static constexpr bool GATHER = false;   // x columns = logical k
  using Quad = typename std::conditional<sizeof(T) == 4, float4, uint2>::type;
  const T* w;
  int p;
  bool vec;  // quads may be read as one aligned vector (p % 4 == 0, w aligned)

  static constexpr bool BATCH = false;
  __device__ __forceinline__ Plain tile(int) const { return *this; }
  __device__ __forceinline__ int xcol(int k) const { return k; }
  __host__ __device__ int kgrain() const { return 1 << 30; }
  __device__ __forceinline__ Quad zero() const { return Quad{}; }
  __device__ __forceinline__ const T* ptr(int r, int c) const { return w + (size_t)r * p + c; }
  __device__ __forceinline__ int stride() const { return p; }  // between packed rows
  // packed row r, columns c .. c + 3 (masked past p), from src = ptr(r, c),
  // which a kernel steps along by stride()
  __device__ __forceinline__ Quad load_at(const T* src, int c) const {
    if (vec && c + 4 <= p) return ldg_nc(reinterpret_cast<const Quad*>(src));
    T v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = c + j < p ? src[j] : T{};
    Quad q;
    memcpy(&q, v, sizeof(q));
    return q;
  }
  template <int V>
  __device__ __forceinline__ void unpack(const Quad& q, float* f) const {
    if constexpr (sizeof(T) == 4) {
      f[0] = q.x; f[1] = q.y; f[2] = q.z; f[3] = q.w;
    } else {
      bf16x4_to_f32(q, f);
    }
  }
  __device__ __forceinline__ float scale(int) const { return 1.f; }
};

template <int BITS_>
struct Codes {
  static constexpr int BITS = BITS_;
  static constexpr int VPB = 8 / BITS_;
  static constexpr bool DIRECT = false;
  static constexpr bool GATHER = false;
  using Quad = uint32_t;
  const int8_t* q;
  const float* scales;
  int p;
  bool vec;  // p % 4 == 0 and q 4-byte aligned

  static constexpr bool BATCH = false;
  __device__ __forceinline__ Codes tile(int) const { return *this; }
  __device__ __forceinline__ int xcol(int k) const { return k; }
  __host__ __device__ int kgrain() const { return 1 << 30; }
  __device__ __forceinline__ Quad zero() const { return 0u; }
  __device__ __forceinline__ const int8_t* ptr(int r, int c) const { return q + (size_t)r * p + c; }
  __device__ __forceinline__ int stride() const { return p; }
  __device__ __forceinline__ Quad load_at(const int8_t* src, int c) const {
    if (vec && c + 4 <= p) return ldg_nc(reinterpret_cast<const uint32_t*>(src));
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < p) word |= static_cast<uint32_t>(static_cast<uint8_t>(src[j])) << (8 * j);
    return word;
  }
  // value V (k = r * VPB + V) of each of the word's 4 bytes: shift the
  // field's top bit to bit 31, then an arithmetic shift sign-extends it;
  // 1 bit maps the field f to 2f - 1
  template <int V>
  __device__ __forceinline__ void unpack(uint32_t word, float* f) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = 8 * j + V * BITS;
      if constexpr (BITS == 1) {
        f[j] = static_cast<float>(static_cast<int>((word >> o) & 1u) * 2 - 1);
      } else {
        f[j] = static_cast<float>(static_cast<int32_t>(word << (32 - o - BITS)) >> (32 - BITS));
      }
    }
  }
  __device__ __forceinline__ float scale(int c) const { return scales[c]; }
};

template <int BITS_>
struct QBlocks : Codes<BITS_> {
  using Codes<BITS_>::VPB;
  static constexpr bool GATHER = true;    // x columns through the index table
  const int* idx;     // (n_pb, nnz) listed k-blocks of each block column
  int nnz, bk, bn;    // bk, bn: one block's k and column extents
  // the CTA's block column, set by tile(): its packed rows, index row and
  // first column
  const int8_t* qj;
  const int* idxj;
  int c0;

  __device__ __forceinline__ QBlocks tile(int col0) const {
    QBlocks s = *this;
    const int j = col0 / bn;
    s.c0 = j * bn;
    s.qj = this->q + (size_t)j * nnz * (bk / VPB) * bn;
    s.idxj = idx + (size_t)j * nnz;
    return s;
  }
  __device__ __forceinline__ int xcol(int k) const { return idxj[k / bk] * bk + k % bk; }
  __host__ __device__ int kgrain() const { return bk; }
  __device__ __forceinline__ const int8_t* ptr(int r, int c) const {
    return qj + (size_t)r * bn + (c - c0);
  }
  __device__ __forceinline__ int stride() const { return bn; }
};

template <typename T>
struct Blocks : Plain<T> {
  static constexpr bool GATHER = true;    // x columns through the index table
  static constexpr bool BATCH = true;     // a stack of experts' blocks
  const int* idx;     // (n_pb, nnz) listed k-blocks of each block column
  int nnz, bk, bn;
  size_t bstride;     // elements between the stacks of a batched launch
  // the CTA's block column, set by tile()
  const T* wj;
  const int* idxj;
  int c0;

  __device__ __forceinline__ Blocks batch(int z) const {
    Blocks s = *this;
    s.w += (size_t)z * bstride;
    return s;
  }
  __device__ __forceinline__ Blocks tile(int col0) const {
    Blocks s = *this;
    const int j = col0 / bn;
    s.c0 = j * bn;
    s.wj = this->w + (size_t)j * nnz * bk * bn;
    s.idxj = idx + (size_t)j * nnz;
    return s;
  }
  __device__ __forceinline__ int xcol(int k) const { return idxj[k / bk] * bk + k % bk; }
  __host__ __device__ int kgrain() const { return bk; }
  __device__ __forceinline__ const T* ptr(int r, int c) const {
    return wj + (size_t)r * bn + (c - c0);
  }
  __device__ __forceinline__ int stride() const { return bn; }
};

// the sources' vec flags: a quad is one aligned vector
template <typename T>
inline Plain<T> plain_source(const void* w, int p) {
  Plain<T> s{static_cast<const T*>(w), p, false};
  s.vec = p % 4 == 0 && reinterpret_cast<uintptr_t>(w) % sizeof(typename Plain<T>::Quad) == 0;
  return s;
}
template <int BITS>
inline Codes<BITS> codes_source(const void* q, const void* scales, int p) {
  Codes<BITS> s{static_cast<const int8_t*>(q), static_cast<const float*>(scales), p, false};
  s.vec = p % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0;
  return s;
}

// bn % 4 == 0 and the codes 4-byte aligned; the p of Codes is the full
// width n_pb * bn (the column bound; rows are bn bytes apart within a block)
template <int BITS>
inline QBlocks<BITS> qblocks_source(const void* q, const void* scales, const void* idx, int n_pb,
                                    int nnz, int bk, int bn) {
  QBlocks<BITS> s{};
  s.q = static_cast<const int8_t*>(q);
  s.scales = static_cast<const float*>(scales);
  s.p = n_pb * bn;
  s.vec = bn % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0;
  s.idx = static_cast<const int*>(idx);
  s.nnz = nnz;
  s.bk = bk;
  s.bn = bn;
  return s;
}

// bn % 4 == 0 and the blocks aligned to one quad; p is the full width; a
// batched launch's z-th stack starts z * n_pb * nnz * bk * bn elements in
template <typename T>
inline Blocks<T> blocks_source(const void* blocks, const void* idx, int n_pb, int nnz, int bk,
                               int bn) {
  Blocks<T> s{};
  s.w = static_cast<const T*>(blocks);
  s.p = n_pb * bn;
  s.vec = bn % 4 == 0 &&
          reinterpret_cast<uintptr_t>(blocks) % sizeof(typename Plain<T>::Quad) == 0;
  s.idx = static_cast<const int*>(idx);
  s.nnz = nnz;
  s.bk = bk;
  s.bn = bn;
  s.bstride = (size_t)n_pb * nnz * bk * bn;
  return s;
}

}  // namespace gk
