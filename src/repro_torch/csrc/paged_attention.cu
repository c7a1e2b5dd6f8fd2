// paged_kernel — page-table-native decode attention.
// Replaces: src/repro/kernels/flash_attention.py::paged_flash_attention
// (_paged_kernel). The TPU kernel walks one slot's pages as its sequential
// grid axis, the page ids arriving by scalar prefetch. Query row i of slot b
// sits at position last[b] - (sq - 1) + i and sees kv positions <= its own
// (and inside the window); masked scores inside a live page are -1e30 as in
// the TPU kernel, keys past the live pages contribute exactly 0, and a row
// with l == 0 is divided by 1.
// Bound on the H100: bytes. Decode reads every live K/V page once per
// (slot, kv head) and does 4 * d flops per (query row, key), so the card's
// bandwidth is the bound (an h2o-danube layer: ~13 MB, ~4 us), and at decode
// batch sizes only enough loads in flight reach it. Design:
//   - a cluster of `split` CTAs (1-8, kernels/flash_attention.py::paged_plan,
//     fixed on the host from the table width, never from `last`) owns one
//     (slot, kv head, 16-row query tile); each CTA reads last[b] and takes a
//     contiguous share of the live pages, so a slot's walk runs on up to 8
//     SMs at once and no host sync is needed;
//   - inside a CTA each of the 4 warps walks its own 16-key tiles (tiles w,
//     w + 4, ...) through a private 1- or 2-stage cp.async ring: one row of a
//     page is one contiguous run of d elements, copied 16 bytes at a time
//     (4, or plain loads, where d or the pointers do not align) into rows
//     padded to DP + 16 bytes, so the next tile lands while this one
//     computes and a warp never waits on another;
//   - the 16 query rows (g * sq live ones: 4 on h2o-danube, 12 on nemotron)
//     are one m16 tile: QK^T and PV are mma.sync m16n8k8 TF32 products, in
//     3xTF32 (mma_tf32.cuh) where an operand is f32, with one product where
//     both are exact in TF32 (bf16 K against Q; bf16-rounded p against bf16
//     V), with S, m, l and O in registers as in fa_tc_kernel;
//   - the warps' (m, l, O) partials merge in warp order in shared memory,
//     then the cluster's through distributed shared memory in rank order
//     after cluster.sync(); each CTA writes 1/split of the tile. One launch,
//     no workspace, no atomics: bitwise repeatable. Partials start at m =
//     -1e30, l = 0, so an empty share (a short `last`, an idle slot on the
//     sink page) merges as exp(-1e30 - M) * 0 and never as NaN.
// In bf16 the unnormalised p is rounded to v's dtype before PV, as the TPU
// kernel does; q and the pages may differ in dtype (q is widened to f32 in
// shared memory, the output written in q's dtype).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "gemm_src.cuh"
#include "gemm_tile.cuh"
#include "mma_tf32.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16;          // query rows of a CTA: one m16 tile for every warp
constexpr int BK = 16;          // keys of a tile: two n8 tiles of S, two k8 steps of PV
constexpr int MAX_SPLIT = 8;    // CTAs of a cluster (the portable limit)
constexpr int MAX_STAGES = 2;   // tiles in flight per warp
constexpr int MAX_SMEM = 232448;
constexpr float NEG = -1e30f;

// Shared memory, in bytes (kernels/flash_attention.py::paged_smem_bytes):
//   Q      BQ rows of DP + 4 floats;
//   ring   WARPS x stages x {K, V} x BK rows of DP + 16 / elem elements;
//          after the walk the same bytes hold the warps' O (BQ rows of
//          DP + 4 floats each), m and l (BQ floats each);
//   part   the CTA's merged O (BQ x DP floats), m and l (BQ each), read by
//          the cluster.
__host__ __device__ constexpr int ldq_of(int dp) { return dp + 4; }
__host__ __device__ constexpr int ld_of(int dp, int elem) { return dp + 16 / elem; }
__host__ __device__ constexpr int ring_bytes(int dp, int elem, int stages) {
  return WARPS * stages * 2 * BK * ld_of(dp, elem) * elem;
}
__host__ __device__ constexpr int merge_bytes(int dp) { return WARPS * BQ * (ldq_of(dp) + 2) * 4; }
__host__ __device__ constexpr int mid_bytes(int dp, int elem, int stages) {
  return ring_bytes(dp, elem, stages) > merge_bytes(dp) ? ring_bytes(dp, elem, stages)
                                                        : merge_bytes(dp);
}
__host__ __device__ constexpr int smem_of(int dp, int elem, int stages) {
  return BQ * ldq_of(dp) * 4 + mid_bytes(dp, elem, stages) + BQ * (dp + 2) * 4;
}

// grid (split, row tiles x h_kv, b), cluster (split, 1, 1). gran: elements
// of one K/V copy (16 bytes, 4 bytes, or 0 for plain loads)
// minBlocksPerSM 1: without it ptxas caps some instantiations below what
// they need and spills (the shared memory allows few CTAs an SM anyway)
template <typename TKV, int DP>
__global__ void __launch_bounds__(THREADS, 1)
paged_kernel(const void* __restrict__ qv, const TKV* __restrict__ kp, const TKV* __restrict__ vp,
             const int* __restrict__ table, const int* __restrict__ last, void* __restrict__ ov,
             int h, int h_kv, int sq, int page, int pp, int d, float scale, int window,
             float softcap, int q_bf16, int stages, int gran) {
  constexpr bool KX = std::is_same<TKV, __nv_bfloat16>::value;  // K and V exact in TF32
  constexpr int LDQ = ldq_of(DP);
  constexpr int LD = ld_of(DP, sizeof(TKV));
  constexpr int ND = DP / 8;   // O n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  TKV* ring = reinterpret_cast<TKV*>(smem_raw + BQ * LDQ * 4);
  float* wo = reinterpret_cast<float*>(ring);   // after the walk
  float* wm = wo + WARPS * BQ * LDQ;
  float* wl = wm + WARPS * BQ;
  float* part_o =
      reinterpret_cast<float*>(smem_raw + BQ * LDQ * 4 + mid_bytes(DP, sizeof(TKV), stages));
  float* part_m = part_o + BQ * DP;
  float* part_l = part_m + BQ;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int split = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.z, hk = blockIdx.y % h_kv;
  const int g = h / h_kv;
  const int r0 = (blockIdx.y / h_kv) * BQ;   // first of this CTA's g * sq rows
  const int nr = min(BQ, g * sq - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int last_b = last[b];
  const int* trow = table + (size_t)b * pp;

  // live pages: ip * page <= last_b, and (window) ip * page + page - 1 >
  // last_b - (sq - 1) - window; this CTA's share of them, in rank order
  const int ip_hi = last_b >= 0 ? min(pp, last_b / page + 1) : 0;
  int ip_lo = 0;
  if (window > 0) {
    const int x = last_b - (sq - 1) - window - page + 1;
    ip_lo = x < 0 ? 0 : x / page + 1;
  }
  const int n_live = max(0, ip_hi - ip_lo);
  const int pos_beg = (ip_lo + rank * n_live / split) * page;
  const int pos_end = (ip_lo + (rank + 1) * n_live / split) * page;
  const int n_tiles = (pos_end - pos_beg + BK - 1) / BK;
  const int mine = warp < n_tiles ? (n_tiles - 1 - warp) / WARPS + 1 : 0;
  const int qbase = last_b - (sq - 1);
  int qp[2];   // positions of this thread's rows gq and gq + 8
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) qp[hh] = qbase + (r0 + gq + 8 * hh) % sq;

  // this warp's i-th tile (the CTA's tile warp + i * WARPS) into its ring
  TKV* ring_w = ring + warp * stages * 2 * BK * LD;
  const int step = gran > 0 ? gran : 1;
  const int per = d / step;   // copies per row
  auto fetch_tile = [&](int i) {
    const int pos0 = pos_beg + (warp + i * WARPS) * BK;
    TKV* ks = ring_w + (i % stages) * 2 * BK * LD;
    TKV* vs = ks + BK * LD;
    // lane r < BK: element offset of tile row r in the page store, -1 past the share
    long long off = -1;
    if (lane < BK && pos0 + lane < pos_end) {
      const int pos = pos0 + lane;
      off = (((long long)trow[pos / page] * h_kv + hk) * page + pos % page) * d;
    }
    for (int e0 = 0; e0 < BK * per; e0 += 32) {
      const int e = e0 + lane;
      const int r = min(e / per, BK - 1);
      const long long base = __shfl_sync(0xffffffffu, off, r);
      if (e >= BK * per) continue;
      const int c = (e - r * per) * step;
      const bool ok = base >= 0;
      TKV* kd = ks + r * LD + c;
      TKV* vd = vs + r * LD + c;
      if (gran == 16 / (int)sizeof(TKV)) {
        gk::cp_async<16>(kd, ok ? kp + base + c : kp, ok ? 16 : 0);
        gk::cp_async<16>(vd, ok ? vp + base + c : vp, ok ? 16 : 0);
      } else if (gran == 4 / (int)sizeof(TKV)) {
        gk::cp_async<4>(kd, ok ? kp + base + c : kp, ok ? 4 : 0);
        gk::cp_async<4>(vd, ok ? vp + base + c : vp, ok ? 4 : 0);
      } else {
        *kd = ok ? kp[base + c] : TKV{};
        *vd = ok ? vp[base + c] : TKV{};
      }
    }
  };

  // the first tiles go out before Q is staged, so the two latencies overlap
  for (int i = 0; i < stages; ++i) {
    if (i < mine) fetch_tile(i);
    gk::cp_async_commit();   // possibly empty: one group per stage
  }

  // row r <-> (q head hk * g + (r0 + r) / sq, query (r0 + r) % sq); Q as
  // f32, zero past nr rows and d columns; every load goes out before the
  // first store
  {
    constexpr int QPT = BQ * DP / THREADS;
    float qv_r[QPT];
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      const int i = tid + u * THREADS, r = i / DP, c = i % DP;
      qv_r[u] = 0.f;
      if (r < nr && c < d) {
        const int gr = r0 + r;
        const size_t at = (((size_t)b * h + hk * g + gr / sq) * sq + gr % sq) * d + c;
        qv_r[u] = q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(qv)[at])
                         : static_cast<const float*>(qv)[at];
      }
    }
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      const int i = tid + u * THREADS;
      qs[(i / DP) * LDQ + i % DP] = qv_r[u];
    }
  }
  // head columns d .. DP of every ring row are zero (no copy writes them)
  if (d < DP) {
    const int rows = WARPS * stages * 2 * BK;
    for (int e = tid; e < rows * (DP - d); e += THREADS)
      ring[(e / (DP - d)) * LD + d + e % (DP - d)] = TKV{};
  }
  __syncthreads();

  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};   // rows gq, gq + 8

  for (int i = 0; i < mine; ++i) {
    if (stages == 2) {
      gk::cp_async_wait<1>();
    } else {
      gk::cp_async_wait<0>();
    }
    __syncwarp();
    const int k0 = pos_beg + (warp + i * WARPS) * BK;
    const TKV* kt = ring_w + (i % stages) * 2 * BK * LD;
    const TKV* vt = kt + BK * LD;

    // S = Q K^T (16 rows x 16 keys)
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < DP; kk += 8) {
      const float* qa = qs + gq * LDQ + kk + tq;
      uint32_t ab[4], as[4];
      tc::split(qa[0], ab[0], as[0]);
      tc::split(qa[8 * LDQ], ab[1], as[1]);
      tc::split(qa[4], ab[2], as[2]);
      tc::split(qa[8 * LDQ + 4], ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const TKV* kr = kt + (j * 8 + gq) * LD + kk + tq;
        uint32_t bb[2], bs[2];
        tc::split(rt::to_f32(kr[0]), bb[0], bs[0]);
        tc::split(rt::to_f32(kr[4]), bb[1], bs[1]);
        tc::mma_tf32(s[j], as, bb);
        if constexpr (!KX) tc::mma_tf32(s[j], ab, bs);
        tc::mma_tf32(s[j], ab, bb);
      }
    }

    // scale, soft cap, masks; this tile's row maxima
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * tq + (e & 1);
        float x;
        if (key >= pos_end) {
          x = -INFINITY;   // past the share: contributes exactly 0
        } else {
          x = s[j][e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          const int qpos = qp[e >> 1];
          bool ok = key <= qpos;
          if (window > 0) ok = ok && key > qpos - window;
          if (!ok) x = NEG;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_cur = fmaxf(m_r[hh], mx[hh]);
      alpha[hh] = expf(m_r[hh] - m_cur);
      m_r[hh] = m_cur;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float pe = x == -INFINITY ? 0.f : expf(x - m_r[e >> 1]);
        sum[e >> 1] += pe;
        s[j][e] = KX ? __bfloat162float(__float2bfloat16(pe)) : pe;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l_r[hh] = l_r[hh] * alpha[hh] + sum[hh];
#pragma unroll
    for (int i2 = 0; i2 < ND; ++i2) {
      acc[i2][0] *= alpha[0];
      acc[i2][1] *= alpha[0];
      acc[i2][2] *= alpha[1];
      acc[i2][3] *= alpha[1];
    }

    // O += P V: key 2t of an n-tile in k slot t, key 2t + 1 in slot t + 4
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t ab[4], as[4];
      tc::split(s[j][0], ab[0], as[0]);
      tc::split(s[j][2], ab[1], as[1]);
      tc::split(s[j][1], ab[2], as[2]);
      tc::split(s[j][3], ab[3], as[3]);
      const TKV* vr = vt + (j * 8 + 2 * tq) * LD + gq;
#pragma unroll
      for (int i2 = 0; i2 < ND; ++i2) {
        uint32_t bb[2], bs[2];
        tc::split(rt::to_f32(vr[i2 * 8]), bb[0], bs[0]);
        tc::split(rt::to_f32(vr[i2 * 8 + LD]), bb[1], bs[1]);
        if constexpr (KX) {
          tc::mma_tf32(acc[i2], ab, bb);
        } else {
          tc::mma_3xtf32(acc[i2], ab, as, bb, bs);
        }
      }
    }
    __syncwarp();   // this stage is free: the tile `stages` trips on lands in it
    if (i + stages < mine) fetch_tile(i + stages);
    gk::cp_async_commit();
  }
  gk::cp_async_wait<0>();

  // the warps' partials (l summed over the quad) replace the ring
  float lsum[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_r[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    lsum[hh] = l;
  }
  __syncthreads();
  float* wo_w = wo + warp * BQ * LDQ;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = gq + 8 * hh;
#pragma unroll
    for (int i2 = 0; i2 < ND; ++i2) {
      wo_w[row * LDQ + i2 * 8 + 2 * tq] = acc[i2][2 * hh];
      wo_w[row * LDQ + i2 * 8 + 2 * tq + 1] = acc[i2][2 * hh + 1];
    }
    if (tq == 0) {
      wm[warp * BQ + row] = m_r[hh];
      wl[warp * BQ + row] = lsum[hh];
    }
  }
  __syncthreads();

  // the CTA's partial: its warps' merged in warp order
  for (int e = tid; e < nr * d; e += THREADS) {
    const int r = e / d, c = e % d;
    float mw = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mw = fmaxf(mw, wm[w * BQ + r]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(wm[w * BQ + r] - mw);
      l += f * wl[w * BQ + r];
      o += f * wo[(w * BQ + r) * LDQ + c];
    }
    part_o[r * DP + c] = o;
    if (c == 0) {
      part_m[r] = mw;
      part_l[r] = l;
    }
  }

  // the cluster's partials through DSMEM, rank 0 first; each CTA finishes
  // 1/split of the live nr x d outputs
  cluster.sync();
  const int outs = nr * d;
  const int per_rank = (outs + split - 1) / split;
  const int e1 = min(outs, (rank + 1) * per_rank);
  for (int e = rank * per_rank + tid; e < e1; e += THREADS) {
    const int r = e / d, c = e % d;
    float ms[MAX_SPLIT], ls[MAX_SPLIT], os[MAX_SPLIT];
    float mc = NEG;
#pragma unroll
    for (int src = 0; src < MAX_SPLIT; ++src) {
      ms[src] = NEG;
      ls[src] = os[src] = 0.f;
      if (src < split) {
        const float* po = cluster.map_shared_rank(part_o, src);
        ms[src] = po[BQ * DP + r];
        ls[src] = po[BQ * DP + BQ + r];
        os[src] = po[r * DP + c];
      }
      mc = fmaxf(mc, ms[src]);
    }
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int src = 0; src < MAX_SPLIT; ++src) {
      const float f = expf(ms[src] - mc);
      l += f * ls[src];
      o += f * os[src];
    }
    if (l == 0.f) l = 1.f;
    const int gr = r0 + r;
    const size_t at = (((size_t)b * h + hk * g + gr / sq) * sq + gr % sq) * d + c;
    if (q_bf16) {
      static_cast<__nv_bfloat16*>(ov)[at] = __float2bfloat16(o / l);
    } else {
      static_cast<float*>(ov)[at] = o / l;
    }
  }
  cluster.sync();   // no CTA leaves while another still reads its partial
}

template <typename TKV, int DP>
int run(const void* q, const void* kp, const void* vp, const int* table, const int* last, void* o,
        int b, int h, int h_kv, int sq, int page, int pp, int d, float scale, int window,
        float softcap, int q_bf16, int split, int stages, int smem, void* stream) {
  constexpr int ELEM = sizeof(TKV);
  if (d > DP || split < 1 || split > MAX_SPLIT || stages < 1 || stages > MAX_STAGES ||
      smem != smem_of(DP, ELEM, stages) || smem > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_tiles = ((h / h_kv) * sq + BQ - 1) / BQ;
  if ((long long)row_tiles * h_kv > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = paged_kernel<TKV, DP>;
  constexpr int MOST = smem_of(DP, ELEM, MAX_STAGES) < MAX_SMEM ? smem_of(DP, ELEM, MAX_STAGES)
                                                                 : MAX_SMEM;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MOST);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  auto aligned = [](const void* p, int a) { return reinterpret_cast<uintptr_t>(p) % a == 0; };
  const int bytes = d * ELEM;
  const int gran = bytes % 16 == 0 && aligned(kp, 16) && aligned(vp, 16) ? 16 / ELEM
                   : bytes % 4 == 0 && aligned(kp, 4) && aligned(vp, 4)  ? 4 / ELEM
                                                                         : 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, row_tiles * h_kv, b);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = split;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = 1;
  cfg.attrs = la;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kern, q, static_cast<const TKV*>(kp), static_cast<const TKV*>(vp), table, last, o, h,
      h_kv, sq, page, pp, d, scale, window, softcap, q_bf16, stages, gran));
}

template <typename TKV>
int dispatch(const void* q, const void* kp, const void* vp, const int* table, const int* last,
             void* o, int b, int h, int h_kv, int sq, int page, int pp, int d, float scale,
             int window, float softcap, int q_bf16, int dp, int split, int stages, int smem,
             void* stream) {
#define PAGED_RUN(DP)                                                                        \
  run<TKV, DP>(q, kp, vp, table, last, o, b, h, h_kv, sq, page, pp, d, scale, window, softcap, \
               q_bf16, split, stages, smem, stream)
  switch (dp) {
    case 16: return PAGED_RUN(16);
    case 32: return PAGED_RUN(32);
    case 64: return PAGED_RUN(64);
    case 80: return PAGED_RUN(80);
    case 96: return PAGED_RUN(96);
    case 128: return PAGED_RUN(128);
    case 192: return PAGED_RUN(192);
    case 256: return PAGED_RUN(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PAGED_RUN
}

}  // namespace

// q (b, h, sq, d) f32 or bf16; k/v pages (n_pages, h_kv, page, d) f32 or
// bf16; table int32 (b, pp); last int32 (b,); o like q. dp, split, stages,
// smem: the launch plan (kernels/flash_attention.py::paged_plan), checked
// against the instantiations here.
extern "C" int paged_attention_launch(const void* q, const void* kp, const void* vp,
                                      const void* table, const void* last, void* o, int b, int h,
                                      int h_kv, int sq, int page, int pp, int d, float scale,
                                      int window, float softcap, int q_bf16, int kv_bf16, int dp,
                                      int split, int stages, int smem, void* stream) {
  if (d < 1 || d > 256 || b < 1 || h_kv < 1 || h % h_kv || sq < 1 || page < 1 || pp < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* tp = static_cast<const int*>(table);
  const int* lp = static_cast<const int*>(last);
  return kv_bf16 ? dispatch<__nv_bfloat16>(q, kp, vp, tp, lp, o, b, h, h_kv, sq, page, pp, d,
                                           scale, window, softcap, q_bf16, dp, split, stages,
                                           smem, stream)
                 : dispatch<float>(q, kp, vp, tp, lp, o, b, h, h_kv, sq, page, pp, d, scale,
                                   window, softcap, q_bf16, dp, split, stages, smem, stream);
}
