// The bf16 GEMVs of the probe tool: the streaming floor that the
// weight-only GEMVs (gemv_int4.cu, gemv_int8.cu) should approach.
//
// Replaces: tools/tpu_gemv_probe.py::gemv_pallas (y = x . W over N tiles of
// BN, W stored (K, N)) and gemv_pallas_t (the same product with W^T stored
// (N, K)); x (M, K) bf16 with M 1 to 8, y (M, N) bf16 (f32 sums rounded
// once, as the TPU's preferred_element_type f32 then astype).
//
// Bound on this card: bytes. At the tool's 4096 x 4096 the weight is 33.5
// MB, 0.010 ms at 3.35 TB/s; 2 * M * K * N flops are far below the bf16
// tensor-core rate. The weight stays in the 50 MB L2 across back-to-back
// calls: a caller that times it flushes L2 between calls.
//
// On W (K, N), gemv_bf16: one launch on the tensor cores (gemv_kn below),
// the register-streamed design of gemv_common.cuh (namespace ldg). A
// column block is 64 output columns; a unit is 32 contraction rows of it
// (4 KB). Lane (g, t) of a warp loads 16 bytes (columns 8 g .. 8 g + 7)
// of rows 8 t .. 8 t + 7 of the unit straight into registers (a warp-wide
// load covers four whole 128-byte rows) and x's row g at those 8 rows.
// mma.sync's A fragment wants two contraction rows of one column in a
// register; a 16-byte load holds 8 columns of one row, so rows 2m and
// 2m + 1 are paired by byte permutes (0x5410: their even columns, 0x7632:
// their odd ones), one instruction per 4 weight bytes. The mma's k order
// is free as long as A and B agree: k-step s takes rows 4 s, 4 s + 1 (K
// slots 2t, 2t + 1) and 4 s + 2, 4 s + 3 (slots 2t + 8, 2t + 9), the words
// 2 s and 2 s + 1 of x's 16 bytes; M row g of mma tile j is column
// 8 g + 2 j, row g + 8 column 8 g + 2 j + 1. Two units a warp are in
// flight (8 KB), the next one's loads issued as each is consumed. Rows
// past K and columns past N read as zeros. Plan:
// tools/gemv_probe.gemv_plan.
//
// Why this pairing: a lane's 16-byte load of W^T holds k-pairs already
// (gemv_bf16_t below); of W it does not. movmatrix.trans (a warp-wide
// 8 x 8 transpose) was not tried. CUDA-core f32 multiply-adds on the
// loaded values (the design this kernel replaces: a split pass plus a
// reduce kernel, x staged as f32 in shared memory) cost 8 per weight
// value at 8 rows against 1/4 of a permute and 1/64 of an mma here; on an
// H100 80GB HBM3 (700 W) that design took 0.0196 ms at 1 row (PERF.md).
//
// On W^T (N, K), gemv_bf16_t: one launch on the tensor cores, below
// (namespace tldg).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemv_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace gemv;

// ---- W (K, N): the one-launch kernel of gemv_bf16 ----

constexpr int kColsKN = 64;  // output columns of a column block
constexpr int kUnitKN = 32;  // contraction rows of a unit

struct ArgsKN {
  const bf16* x;  // (M, K), 16-byte aligned
  const bf16* w;  // (K, N), 16-byte aligned
  bf16* y;        // (M, N)
  int M, K, N, cluster;
  unsigned long long* tl;  // kTimeline: ldg::kStamps per block
};

// d += the unit's 32 rows (w, rows 8 t + r) times x's 8 values (xv)
__device__ __forceinline__ void unit_mma(const uint4 (&w)[8], const uint4& xv,
                                         float (&acc)[4][4]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const uint32_t b0 = ldg::word(xv, 2 * s), b1 = ldg::word(xv, 2 * s + 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t r0 = ldg::word(w[4 * s], j), r1 = ldg::word(w[4 * s + 1], j);
      const uint32_t r2 = ldg::word(w[4 * s + 2], j), r3 = ldg::word(w[4 * s + 3], j);
      ring::mma_bf16(acc[j], __byte_perm(r0, r1, 0x5410), __byte_perm(r0, r1, 0x7632),
                     __byte_perm(r2, r3, 0x5410), __byte_perm(r2, r3, 0x7632), b0, b1);
    }
  }
}

template <bool kTimeline>
__global__ void __launch_bounds__(ldg::kThreads, 2) gemv_kn(const ArgsKN a) {
  extern __shared__ __align__(16) float smem_kn[];
  const int C = a.cluster, M = a.M, K = a.K, N = a.N;
  const int rank = C > 1 ? static_cast<int>(hopper::cluster_rank()) : 0;
  const int col_blocks = (N + kColsKN - 1) / kColsKN, U = (K + kUnitKN - 1) / kUnitKN;
  const int cid = blockIdx.x / C, ncl = gridDim.x / C;
  const int ncb = (col_blocks - cid + ncl - 1) / ncl;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int W = ldg::kWarps * C, wi = rank * ldg::kWarps + warp;
  const int uw0 = wi * U / W, nuw = (wi + 1) * U / W - uw0;  // this warp's units
  const int ntiles = ncb * nuw;
  float* red = smem_kn;
  float* recv = smem_kn + ldg::kWarps * M * (kColsKN + ldg::kPad);
  if (C > 1) hopper::cluster_arrive();  // waited for before the first push
  unsigned long long* tl = kTimeline ? a.tl + blockIdx.x * ldg::kStamps : nullptr;
  if (kTimeline && threadIdx.x == 0) {
    tl[0] = ldg::stamp(0u);
    tl[6] = ntiles + (rank << 16);
    tl[7] = ldg::smid();
  }

  // unit i of the warp: unit uw0 + i % nuw of column block cid + (i / nuw) * ncl
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  auto load = [&](int i, uint4 (&w)[8], uint4& xv) {
    const int col = (cid + (i / nuw) * ncl) * kColsKN + 8 * g;
    const int k0 = (uw0 + i % nuw) * kUnitKN + 8 * t;
    const bf16* src = a.w + static_cast<size_t>(k0) * N + col;
#pragma unroll
    for (int r = 0; r < 8; ++r)
      w[r] = col < N && k0 + r < K ? ldg::ld_w(src + static_cast<size_t>(r) * N) : zero;
    xv = g < M && k0 < K ? ldg::ld_x(a.x + static_cast<size_t>(g) * K + k0) : zero;
  };
  uint4 wa[8], wb[8], xa = zero, xb = zero;  // units of even / odd index
  if (ntiles > 0) load(0, wa, xa);
  if (ntiles > 1) load(1, wb, xb);

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  int i = 0;
  for (int jb = 0; jb < ncb; ++jb) {
    for (int u = 0; u < nuw; ++u, ++i) {
      if (kTimeline && i == 0 && threadIdx.x == 0) tl[1] = ldg::stamp(wa[0].x ^ wa[7].w);
      if ((i & 1) == 0) {
        unit_mma(wa, xa, acc);
        if (i + 2 < ntiles) load(i + 2, wa, xa);
      } else {
        unit_mma(wb, xb, acc);
        if (i + 2 < ntiles) load(i + 2, wb, xb);
      }
      if (kTimeline && i + 1 == ntiles && threadIdx.x == 0)
        tl[2] = ldg::stamp(__float_as_uint(acc[3][3]));
    }
    // the warp's sums: M row g of tile j is column 8 g + 2 j, row g + 8
    // column 8 g + 2 j + 1; acc[j][e] is x's row 2 t + (e & 1)
    __syncthreads();  // the last column block's sums have been read
    constexpr int RS = kColsKN + ldg::kPad;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 2 * t + e;
      if (n < M) {
        float4* row = reinterpret_cast<float4*>(red + (warp * M + n) * RS + 8 * g);
        row[0] = make_float4(acc[0][e], acc[0][e + 2], acc[1][e], acc[1][e + 2]);
        row[1] = make_float4(acc[2][e], acc[2][e + 2], acc[3][e], acc[3][e + 2]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    ldg::finish<kColsKN>(red, recv, M, C, rank, jb & 1, jb == 0, (cid + jb * ncl) * kColsKN, N,
                         a.y, tl);
  }
  if (kTimeline && threadIdx.x == 0) tl[5] = ldg::stamp(0u);
}

// ---- W^T (N, K): the one-launch kernel of gemv_bf16_t ----
//
// A column block is 16 output columns = 16 rows of W^T, each 2K contiguous
// bytes. A block of W warps owns cpb column blocks; their contraction is
// split into S = W / cpb ranges of 32-value units, warp w taking column
// block w / S and range w % S. A warp walks its range 32 values at a time:
// lane (g, t) loads 16 bytes (8 values) of rows g and g + 8 at k + 8t and
// x's row g there (no shared memory, no barrier: the loads of kUnroll
// units are in flight together), and runs two mma.sync m16n8k16 on them.
// The mma's k order is free as long as A and B agree: step 1 takes the
// lane's values 0-3 (logical k 2t, 2t + 1 from values 0-1, 2t + 8, 2t + 9
// from values 2-3), step 2 values 4-7, for A (W^T rows) and B (x) alike.
// Each warp's sums (16 columns x 8 rows of x) meet the other ranges' in
// shared memory and are added in range order: results repeat from call to
// call, and no partial rows go to device memory. Rows of W^T past N and
// values past K are read as zeros. Plan: tools/gemv_probe.gemv_t_plan.
//
// Why loads into registers and not a TMA / bulk-copy ring into shared
// memory: on an H100 80GB HBM3 (700 W) the 33.5 MB of a 4096 x 4096 W^T
// streamed in 16.9-17.4 us by cp.async.bulk (row segments of 0.5-8 KB,
// any ring depth) or by cp.async, and in 13.6-15.1 us by 16-byte
// ld.global.nc into registers (tools/gemv_ab.py --only=floor,
// csrc/stream_floor.cu); this kernel takes ~17.1 us at 1 and 8 rows.
namespace tldg {

constexpr int kRows = 16;    // W^T rows (output columns) per column block
constexpr int kUnit = 32;    // contraction values per warp step: 8 a lane, 4 lanes a row
constexpr int kUnroll = 8;   // steps whose loads are in flight together
constexpr int kSums = kRows * 8;  // a warp's (column, x row) f32 sums

__device__ __forceinline__ uint4 ld_w(const bf16* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// d += A (16 x 16) . B (16 x 8), fragments as mma.sync takes them
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int W, int U = kUnroll>
__global__ void __launch_bounds__(W * 32) gemv_t_kernel(const bf16* __restrict__ x,
                                                        const bf16* __restrict__ wt,
                                                        bf16* __restrict__ y, int M, int K,
                                                        int N, int cpb) {
  __shared__ float sums[W][kSums];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int S = W / cpb;
  const int cb = blockIdx.x * cpb + warp / S, range = warp % S;
  const int units = (K + kUnit - 1) / kUnit;
  const int u0 = range * units / S, u1 = (range + 1) * units / S;
  const int r0 = cb * kRows + g, r1 = r0 + 8;
  const bool live0 = r0 < N, live1 = r1 < N, xlive = g < M;
  const bf16* w0 = wt + static_cast<size_t>(live0 ? r0 : 0) * K + 8 * t;
  const bf16* w1 = wt + static_cast<size_t>(live1 ? r1 : 0) * K + 8 * t;
  const bf16* xr = x + static_cast<size_t>(xlive ? g : 0) * K + 8 * t;
  float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int u = u0; u < u1; u += U) {
    uint4 a[U], b[U], xv[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int k = (u + j) * kUnit + 8 * t;  // this lane's 8 values
      const bool in = u + j < u1 && k < K;
      a[j] = in && live0 ? ld_w(w0 + (u + j) * kUnit) : zero;
      b[j] = in && live1 ? ld_w(w1 + (u + j) * kUnit) : zero;
      xv[j] = in && xlive ? __ldg(reinterpret_cast<const uint4*>(xr + (u + j) * kUnit)) : zero;
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      mma16816(acc[0], a[j].x, b[j].x, a[j].y, b[j].y, xv[j].x, xv[j].y);
      mma16816(acc[1], a[j].z, b[j].z, a[j].w, b[j].w, xv[j].z, xv[j].w);
    }
  }
  // acc: (column g, x rows 2t, 2t + 1), (column g + 8, the same rows)
  float* mine = sums[warp];
  mine[g * 8 + 2 * t] = acc[0][0] + acc[1][0];
  mine[g * 8 + 2 * t + 1] = acc[0][1] + acc[1][1];
  mine[(g + 8) * 8 + 2 * t] = acc[0][2] + acc[1][2];
  mine[(g + 8) * 8 + 2 * t + 1] = acc[0][3] + acc[1][3];
  __syncthreads();
  for (int idx = threadIdx.x; idx < cpb * kSums; idx += W * 32) {
    const int c = idx / kSums, e = idx - c * kSums, col = e >> 3, xrow = e & 7;
    const int out_col = (blockIdx.x * cpb + c) * kRows + col;
    if (xrow >= M || out_col >= N) continue;
    float v = sums[c * S][e];
    for (int r = 1; r < S; ++r) v += sums[c * S + r][e];
    y[static_cast<size_t>(xrow) * N + out_col] = __float2bfloat16_rn(v);
  }
}

}  // namespace tldg

}  // namespace

// y (M, N) bf16 = x (M, K) bf16 . W, W stored (K, N), in one launch; M 1 to
// 8, K and N multiples of 8, x and W 16-byte aligned. cluster / grid:
// tools/gemv_probe.gemv_plan; tl: null, or grid x ldg::kStamps timeline
// stamps.
extern "C" int gemv_bf16(const void* x, const void* w, void* y, int M, int K, int N,
                         int cluster, int grid, void* tl, void* stream) {
  const int col_blocks = (N + kColsKN - 1) / kColsKN;
  if (K <= 0 || K % 8 || N <= 0 || N % 8 || ldg::bad_launch(cluster, grid, col_blocks, M) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  ArgsKN a = {static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(y),
              M, K, N, cluster, static_cast<unsigned long long*>(tl)};
  return ldg::launch(tl != nullptr ? gemv_kn<true> : gemv_kn<false>, a, cluster, grid,
                     ldg::smem_bytes(kColsKN, M, cluster), static_cast<cudaStream_t>(stream));
}

// Clusters of `cluster` gemv_kn blocks (shared memory of 8 rows) the card
// runs at once (cudaOccupancyMaxActiveClusters), or -1.
extern "C" int gemv_bf16_max_clusters(int cluster) {
  return ldg::max_clusters(gemv_kn<false>, cluster, ldg::smem_bytes(kColsKN, 8, cluster));
}

// y (M, N) bf16 = x (M, K) bf16 . W, W^T stored (N, K), in one launch:
// blocks of `warps` warps (8 or 16), each owning cpb column blocks of 16
// outputs (cpb divides warps); M 1 to 8, K a multiple of 8, x and W^T
// 16-byte aligned.
extern "C" int gemv_bf16_t_one(const void* x, const void* wt, void* y, int M, int K, int N,
                               int warps, int cpb, void* stream) {
  if (M < 1 || M > 8 || K <= 0 || K % 8 || N <= 0 || (warps != 8 && warps != 16) ||
      cpb < 1 || warps % cpb || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(wt) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int col_blocks = (N + tldg::kRows - 1) / tldg::kRows;
  const int grid = (col_blocks + cpb - 1) / cpb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(wt);
  bf16* yb = static_cast<bf16*>(y);
  if (warps == 8)
    tldg::gemv_t_kernel<8><<<grid, 8 * 32, 0, st>>>(xb, wb, yb, M, K, N, cpb);
  else
    tldg::gemv_t_kernel<16><<<grid, 16 * 32, 0, st>>>(xb, wb, yb, M, K, N, cpb);
  return static_cast<int>(cudaGetLastError());
}
