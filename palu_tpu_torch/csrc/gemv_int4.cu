// Int4 weight-only GEMV and SwiGLU MLP for decode-sized inputs (1-8 rows).
//
// Replaces: palu_tpu/ops/pallas/gemv_int4.py::gemv_int4 and ::mlp_gemv_int4.
//
// Storage (core/wquant.quantize_weight4): wq4 (K/2, N) uint8, N contiguous;
// rows r and r + 64 of each 128-row group share a byte (low / high nibble),
// codes 0..15 stand for -8..7; ws (K/128, N) f32 scales per (group, column).
//
// Bound on this card: bytes. At 8 rows or fewer every weight byte feeds at
// most 16 multiply-adds, far below the ~295 operations per byte where the
// card stops being limited by its memory; the weights are read once.
//
// gemv_int4 over a bf16 x (the engine's path): one launch of gemv4_n32 (a
// block of 16 warps per 32 columns, further below) where N / 32 column
// blocks fit the card in one wave, else of gemv4_ldg below
// (ops/gemv_int4.gemv4_route), both on the register-streamed design of
// gemv_common.cuh (namespace ldg). A tile is one group (64 byte rows) of a
// 128-column block: lane (g, t) of a warp loads 16 bytes (columns 16 g ..
// 16 g + 15) of the 16 packed rows 16 t .. 16 t + 15 straight into
// registers, two rows a k-step, so that one warp-wide load covers four
// whole 128-byte rows. A ring of four k-steps keeps 4 KB a warp in flight
// ahead of the products (step s consumes its slot, then loads step s + 4,
// crossing into the next tile), so the products run as the bytes arrive
// instead of after a whole tile has. Each byte becomes one bf16x2 register
// in two integer instructions (ring::nibbles: the bf16 values 128 +
// nibble) and feeds mma.sync m16n8k16 with the columns as M and x's rows
// as N: k-step s takes packed rows 16 t + 2 s (K slots 2t, 2t + 1: its low
// and high nibble, code rows p and p + 64) and 16 t + 2 s + 1 (slots
// 2t + 8, 2t + 9); M row g is column 16 g + j of mma tile j, row g + 8
// column 16 g + 8 + j. x's fragments come from 4-byte loads of x's row g
// (values 16 t + 2 s and 64 + 16 t + 2 s, and the next of each) paired by
// byte permutes; the offset 128 + 8 is folded out after the
// product as 136 * sum(x over the group), the sum taken by one more mma
// against ones, before the group scale. To fit 128 registers (two blocks
// of 8 warps per SM, which doubles the clusters of 4 the card places at
// once: an H100 80GB HBM3 ran 30 at one block per SM, 62 at two), each
// warp keeps its sums in shared memory (they are also the block's
// reduction rows) and reads each tile's scales from a 512-byte per-warp
// staging row that cp.async fills a tile ahead. The contraction (the K / 128 groups) is split over
// the warps of a cluster and summed in a fixed order inside the launch
// (gemv_common.cuh, namespace ldg; plan: ops/gemv_int4.gemv4_plan).
//
// What it costs (tools/gemv_ab.py --timeline; NVIDIA H100 80GB HBM3,
// 700 W): the tiles stream at about the rate of plain 16-byte loads, and a
// clustered launch adds ~1.0-1.5 us of rank skew and exchange and ~0.5 us
// of output. At q_proj and w_fused (8.9 / 26.7 MB, 32 column blocks) the
// card placed its 32 clusters of 4 on 120 SMs, 8 of them holding two
// blocks, and gemv4_ldg took 0.0104 / 0.0203 ms, behind the split pass;
// gemv4_n32 serves those shapes without a cluster (0.0080 / 0.0184).
//
// mlp_gemv_int4 over a bf16 x runs the streaming tensor-core GEMV of
// gemv_common.cuh (namespace ring) in two launches:
// 1. gate and up: a block owns 128 columns of both and a K range of whole
//    groups; the K ranges of a column block form a cluster that adds them
//    in rank order, forms h = bf16(silu(x Wg) * (x Wu)) (rounded to x's
//    type where the TPU kernel rounds it) and writes h in the down
//    product's x-fragment order;
// 2. down: each block copies its groups of h in one bulk copy; its K splits
//    add through the cluster the same way. No f32 partial row goes to
//    device memory.
// Each weight byte costs ~2.25 integer instructions (permute, lop3, a
// quarter of a shift) and 1/32 of an mma. On an H100 80GB HBM3 the two
// launches take what the parent's four did at 1 row and 0.38x at 8 rows
// (PERF.md); the layout streams at ~1.5 TB/s in either design. Launching
// the down product with programmatic dependent launch (its ring filled
// before the first launch ends) lengthened the call's span (0.058 against
// 0.050 ms at 1 row) and was taken out. The TPU kernel carries the down
// product's accumulator across a sequential grid, which Hopper has not.
//
// On the CUDA-core split pass of gemv_common.cuh (each thread reads 8
// columns x 2 input rows per 8-byte load, unpacks them with a mask and a
// shift, subtracts the offset 8 exactly by the exponent trick, multiplies
// by the group scale once per group; a second kernel adds the splits in a
// fixed order): gemv_int4 and mlp_gemv_int4 over an f32 x (bf16 tensor
// cores would round x; gate and up share one split pass, swiglu_reduce
// forms h and the down GEMV reads it back), and mlp_gemv_int4 at 1 row
// below ops/gemv_int4.MLP_STREAM_MIN_1ROW.

#include "gemv_common.cuh"

using namespace gemv;

namespace {

// ---- gemv_int4 over a bf16 x: one launch (see the note above) ----

constexpr int kCols4 = 128;              // output columns of a column block
constexpr uint32_t kOnes = 0x3F803F80u;  // bf16x2 (1, 1)

struct Args4 {
  const __nv_bfloat16* x;  // (B, K), 16-byte aligned
  const uint8_t* wq;       // (K/2, N)
  const float* ws;         // (K/128, N)
  __nv_bfloat16* out;      // (B, N)
  int B, K, N, cluster;
  unsigned long long* tl;  // kTimeline: ldg::kStamps per block
};

// Shared memory of a block: ldg::smem_bytes (the warps' sums, which are
// also their accumulators, and the cluster's receive buffers), then each
// warp's staged tile scales (128 floats). Mirrored by ops/gemv_int8.ldg_smem.
__host__ __device__ inline int smem4_bytes(int B, int cluster) {
  return ldg::smem_bytes(kCols4, B, cluster) + ldg::kWarps * kCols4 * 4;
}

template <bool kTimeline>
__global__ void __launch_bounds__(ldg::kThreads, 2) gemv4_ldg(const Args4 a) {
  extern __shared__ __align__(16) float smem4[];
  constexpr int RS = kCols4 + ldg::kPad;
  const int C = a.cluster, B = a.B, N = a.N;
  const int rank = C > 1 ? static_cast<int>(hopper::cluster_rank()) : 0;
  const int G = a.K / kUnit, col_blocks = N / kCols4;
  const int cid = blockIdx.x / C, ncl = gridDim.x / C;
  const int ncb = (col_blocks - cid + ncl - 1) / ncl;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int W = ldg::kWarps * C, wi = rank * ldg::kWarps + warp;
  const int gw0 = wi * G / W, ngw = (wi + 1) * G / W - gw0;  // this warp's groups
  const bool xrow = g < B;  // lanes g >= B feed x's zero rows
  float* red = smem4;
  float* recv = red + ldg::kWarps * B * RS;
  float* mine = red + warp * B * RS;  // this warp's sums (x's rows n < B)
  float* stage = smem4 + ldg::smem_bytes(kCols4, B, C) / 4 + warp * kCols4;
  if (C > 1) hopper::cluster_arrive();  // waited for before the first push
  unsigned long long* tl = kTimeline ? a.tl + blockIdx.x * ldg::kStamps : nullptr;
  if (kTimeline && threadIdx.x == 0) {
    tl[0] = ldg::stamp(0u);
    tl[6] = ncb * ngw + (rank << 16);
    tl[7] = ldg::smid();
  }

  // The warp's tiles: groups gw0 .. gw0 + ngw - 1 of column blocks cid,
  // cid + ncl, ... A ring of four k-steps (two packed rows each) runs four
  // steps ahead of the products: step s of a tile consumes its slot s % 4,
  // then loads step s + 4 into it (the next tile's step s - 4 from s = 4).
  auto wptr = [&](int cb, int grp) {
    return a.wq + (static_cast<size_t>(grp) * 64 + 16 * t) * N + cb * kCols4 + 16 * g;
  };
  auto xptr = [&](int grp) {
    return a.x + static_cast<size_t>(g) * a.K + grp * kUnit + 16 * t;
  };
  auto sptr = [&](int cb, int grp) {
    return reinterpret_cast<const float4*>(a.ws + static_cast<size_t>(grp) * N + cb * kCols4) +
           lane;
  };
  uint4 q[8];
  if (ngw > 0) {
    const uint8_t* w0 = wptr(cid, gw0);
#pragma unroll
    for (int r = 0; r < 8; ++r) q[r] = ldg::ld_w(w0 + static_cast<size_t>(r) * N);
    ldg::cp_async16(stage + 4 * lane, sptr(cid, gw0));  // the first tile's scales
  }

  for (int j = 0; j < ncb; ++j) {
    const int cb = cid + j * ncl;
    __syncthreads();  // the last column block's sums have been read
#pragma unroll
    for (int n = 0; n < 8; ++n)
      if (n < B)
        *reinterpret_cast<float4*>(mine + n * RS + 4 * lane) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncwarp();
    for (int u = 0; u < ngw; ++u) {
      const bool more = u + 1 < ngw || j + 1 < ncb;
      const int grp = gw0 + u;  // pointers are formed where they are used
      const int ncb_next = u + 1 < ngw ? cb : cb + ncl, ngrp = u + 1 < ngw ? grp + 1 : gw0;
      float p[8][4], o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[m][e] = 0.0f;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int k = s & 3;
        // x's two words of the step (L1 or L2 hits: every warp of the SM
        // that shares the group reads them): x[16 t + 2 s ..], x[64 + 16 t + 2 s ..]
        const uint32_t wa = xrow ? ldg::ld_x4(xptr(grp) + 2 * s) : 0u;
        const uint32_t wb = xrow ? ldg::ld_x4(xptr(grp) + 64 + 2 * s) : 0u;
        const uint4 r0 = q[2 * k], r1 = q[2 * k + 1];
        if (kTimeline && j == 0 && u == 0 && s == 0 && threadIdx.x == 0)
          tl[1] = ldg::stamp(r0.x ^ r1.w);
        const uint32_t b0 = __byte_perm(wa, wb, 0x5410), b1 = __byte_perm(wa, wb, 0x7632);
        if (s < 4) {  // this tile's step s + 4
          const uint8_t* wc = wptr(cb, grp) + static_cast<size_t>(2 * s + 8) * N;
          q[2 * k] = ldg::ld_w(wc);
          q[2 * k + 1] = ldg::ld_w(wc + N);
        } else if (more) {  // the next tile's step s - 4
          const uint8_t* wn = wptr(ncb_next, ngrp) + static_cast<size_t>(2 * s - 8) * N;
          q[2 * k] = ldg::ld_w(wn);
          q[2 * k + 1] = ldg::ld_w(wn + N);
        }
        ring::mma_bf16(o, kOnes, kOnes, kOnes, kOnes, b0, b1);  // sums of x
        const uint32_t w0[4] = {r0.x, r0.y, r0.z, r0.w}, w1[4] = {r1.x, r1.y, r1.z, r1.w};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t ra = w0[h], rb = w0[2 + h], rc = w1[h], rd = w1[2 + h];
          const uint32_t ra4 = ra >> 4, rb4 = rb >> 4, rc4 = rc >> 4, rd4 = rd >> 4;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            ring::mma_bf16(p[4 * h + i], ring::nibbles<0x43004300u>(ra, ra4, i),
                           ring::nibbles<0x43004300u>(rb, rb4, i),
                           ring::nibbles<0x43004300u>(rc, rc4, i),
                           ring::nibbles<0x43004300u>(rd, rd4, i), b0, b1);
        }
      }
      // the tile's scales, copied into the warp's staging row (the lane's 4)
      // a tile ahead by cp.async; then the next tile's
      ldg::cp_async_wait();
      __syncwarp();
      const float4* sc = reinterpret_cast<const float4*>(stage + 16 * g);
      const float4 s0 = sc[0], s1 = sc[1], s2 = sc[2], s3 = sc[3];
      __syncwarp();  // every lane has read the staged scales
      if (more) ldg::cp_async16(stage + 4 * lane, sptr(ncb_next, ngrp));
      // sums += (p - 136 * sum(x)) * scale: M row g is column 16 g + m, row
      // g + 8 column 16 g + 8 + m; o[0], o[1] are x's rows 2t, 2t + 1
      const float slo[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const float shi[8] = {s2.x, s2.y, s2.z, s2.w, s3.x, s3.y, s3.z, s3.w};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 2 * t + e;
        if (n < B) {
          const float off = 136.0f * o[e];
          float4* row = reinterpret_cast<float4*>(mine + n * RS + 16 * g);
          float4 v[4] = {row[0], row[1], row[2], row[3]};
          float* f = reinterpret_cast<float*>(v);
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            f[m] = fmaf(p[m][e] - off, slo[m], f[m]);
            f[8 + m] = fmaf(p[m][e + 2] - off, shi[m], f[8 + m]);
          }
          row[0] = v[0];
          row[1] = v[1];
          row[2] = v[2];
          row[3] = v[3];
        }
      }
      if (kTimeline && !more && threadIdx.x == 0) tl[2] = ldg::stamp(__float_as_uint(s0.x));
    }
    ldg::finish<kCols4>(red, recv, B, C, rank, j & 1, j == 0, cb * kCols4, N, a.out, tl);
  }
  if (kTimeline && threadIdx.x == 0) tl[5] = ldg::stamp(0u);
}

// ---- gemv_int4 over a bf16 x, narrow column blocks: one launch, no cluster ----
//
// gemv4_n32: a block owns 32 output columns and the whole contraction; its
// 16 warps split the K / 128 groups (warp w: [w G / 16, (w + 1) G / 16))
// and add their sums in warp order in shared memory. A tile is one group
// of the 32 columns (64 byte rows x 32 bytes): lane (g, t) loads 4 bytes
// (columns 4 g .. 4 g + 3) of packed rows 16 t .. 16 t + 15, so a warp-wide
// load covers four 32-byte rows of the block's columns, the same rows the
// blocks of the neighbouring columns read at about the same time. The
// fragments are gemv4_ldg's with 4 bytes a lane: mma tile j (0, 1) of k-step
// s takes byte j of rows 16 t + 2 s and 16 t + 2 s + 1 as M row g (column
// 4 g + j) and byte 2 + j as M row g + 8 (column 4 g + 2 + j). A ring of
// one tile (2 KB a warp; two, 4 KB, where the warps take four tiles or
// more) runs ahead of the products. With
// N / 32 column blocks a q_proj or w_fused of 4096 columns fills 128 SMs
// without a cluster (no exchange between blocks, no rank skew).
constexpr int kColsN = 32;   // output columns of a narrow column block
constexpr int kWarpsN = 16;  // warps of a narrow block

__host__ __device__ inline int smem_n32_bytes(int B) {
  return kWarpsN * B * (kColsN + ldg::kPad) * 4;
}

template <bool kTimeline, int D>
__global__ void __launch_bounds__(kWarpsN * 32, 1) gemv4_n32(const Args4 a) {
  extern __shared__ __align__(16) float smem_n[];
  constexpr int RS = kColsN + ldg::kPad;
  const int B = a.B, N = a.N, G = a.K / kUnit, cb = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int gw0 = warp * G / kWarpsN, ngw = (warp + 1) * G / kWarpsN - gw0;
  const bool xrow = g < B;
  unsigned long long* tl = kTimeline ? a.tl + blockIdx.x * ldg::kStamps : nullptr;
  if (kTimeline && threadIdx.x == 0) {
    tl[0] = ldg::stamp(0u);
    tl[6] = ngw;
    tl[7] = ldg::smid();
  }
  auto wptr = [&](int grp) {
    return a.wq + (static_cast<size_t>(grp) * 64 + 16 * t) * N + cb * kColsN + 4 * g;
  };
  auto xptr = [&](int grp) {
    return a.x + static_cast<size_t>(g) * a.K + grp * kUnit + 16 * t;
  };
  auto sptr = [&](int grp) {
    return reinterpret_cast<const float4*>(a.ws + static_cast<size_t>(grp) * N + cb * kColsN +
                                           4 * g);
  };
  // the ring: D tiles of 8 k-steps; tile u's step s in q[16 (u % D) + 2 s], + 1
  uint32_t q[16 * D];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 xa = zero, xb = zero;
  float4 sc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // the columns' scales of the tile
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (d < ngw) {
      const uint8_t* w0 = wptr(gw0 + d);
#pragma unroll
      for (int r = 0; r < 16; ++r) q[16 * d + r] = ldg::ld_w4(w0 + static_cast<size_t>(r) * N);
    }
  if (ngw > 0) sc = __ldg(sptr(gw0));
  float acc[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  for (int u0 = 0; u0 < ngw; u0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int u = u0 + d;
      if (u >= ngw) break;
      const int grp = gw0 + u;
      const bool ahead = u + D < ngw;  // the tile D ahead, loaded into this one's slots
      float p[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        if ((s & 3) == 0 && xrow) {  // x for steps s .. s + 3
          xa = ldg::ld_x(xptr(grp) + 8 * (s >> 2));
          xb = ldg::ld_x(xptr(grp) + 64 + 8 * (s >> 2));
        }
        const uint32_t r0 = q[16 * d + 2 * s], r1 = q[16 * d + 2 * s + 1];
        if (kTimeline && u == 0 && s == 0 && threadIdx.x == 0) tl[1] = ldg::stamp(r0 ^ r1);
        if (ahead) {
          const uint8_t* wn = wptr(grp + D) + static_cast<size_t>(2 * s) * N;
          q[16 * d + 2 * s] = ldg::ld_w4(wn);
          q[16 * d + 2 * s + 1] = ldg::ld_w4(wn + N);
        }
        const uint32_t wa = ldg::word(xa, s & 3), wb = ldg::word(xb, s & 3);
        const uint32_t b0 = __byte_perm(wa, wb, 0x5410), b1 = __byte_perm(wa, wb, 0x7632);
        ring::mma_bf16(o, kOnes, kOnes, kOnes, kOnes, b0, b1);  // sums of x
        const uint32_t r04 = r0 >> 4, r14 = r1 >> 4;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          ring::mma_bf16(p[j], ring::nibbles<0x43004300u>(r0, r04, j),
                         ring::nibbles<0x43004300u>(r0, r04, 2 + j),
                         ring::nibbles<0x43004300u>(r1, r14, j),
                         ring::nibbles<0x43004300u>(r1, r14, 2 + j), b0, b1);
      }
      // (p - 136 * sum(x)) * scale: tile j's M row g is column 4 g + j, row
      // g + 8 column 4 g + 2 + j; o[0], o[1] are x's rows 2t, 2t + 1
      const float sl[4] = {sc.x, sc.y, sc.z, sc.w};
      if (u + 1 < ngw) sc = __ldg(sptr(grp + 1));
      const float o0 = 136.0f * o[0], o1 = 136.0f * o[1];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        acc[j][0] = fmaf(p[j][0] - o0, sl[j], acc[j][0]);
        acc[j][1] = fmaf(p[j][1] - o1, sl[j], acc[j][1]);
        acc[j][2] = fmaf(p[j][2] - o0, sl[2 + j], acc[j][2]);
        acc[j][3] = fmaf(p[j][3] - o1, sl[2 + j], acc[j][3]);
      }
    }
  }
  if (kTimeline && threadIdx.x == 0) tl[2] = ldg::stamp(__float_as_uint(acc[1][3]));
  // the warps' sums, added in warp order
  float* red = smem_n;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int n = 2 * t + e;
    if (n < B)
      *reinterpret_cast<float4*>(red + (warp * B + n) * RS + 4 * g) =
          make_float4(acc[0][e], acc[1][e], acc[0][e + 2], acc[1][e + 2]);
  }
  __syncthreads();
  if (kTimeline && threadIdx.x == 0) tl[3] = tl[4] = ldg::stamp(0u);
  for (int idx = threadIdx.x; idx < B * kColsN; idx += kWarpsN * 32) {
    const int n = idx / kColsN, c = idx - n * kColsN;
    float v = red[n * RS + c];
#pragma unroll
    for (int w = 1; w < kWarpsN; ++w) v += red[(w * B + n) * RS + c];
    a.out[static_cast<size_t>(n) * N + cb * kColsN + c] = __float2bfloat16_rn(v);
  }
  if (kTimeline && threadIdx.x == 0) tl[5] = ldg::stamp(0u);
}

int run_gemv4_n32(const void* x, int B, int K, int N, const void* wq, const void* ws, void* out,
                  unsigned long long* tl, cudaStream_t st) {
  if (K <= 0 || K % kUnit || N <= 0 || N % kColsN || B < 1 || B > 8 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wq) % 4 ||
      reinterpret_cast<uintptr_t>(ws) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Args4 a = {static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(wq),
             static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(out), B, K, N, 1, tl};
  // the ring runs two tiles ahead where the warps take four or more tiles
  const bool deep = K / kUnit >= 4 * kWarpsN;
  auto kernel = tl != nullptr ? (deep ? gemv4_n32<true, 2> : gemv4_n32<true, 1>)
                              : (deep ? gemv4_n32<false, 2> : gemv4_n32<false, 1>);
  kernel<<<N / kColsN, kWarpsN * 32, smem_n32_bytes(B), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int run_gemv4_ldg(const void* x, int B, int K, int N, const void* wq, const void* ws,
                  int cluster, int grid, void* out, unsigned long long* tl, cudaStream_t st) {
  if (K <= 0 || K % kUnit || N <= 0 || N % kCols4 ||
      ldg::bad_launch(cluster, grid, N / kCols4, B) || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(wq) % 16 || reinterpret_cast<uintptr_t>(ws) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Args4 a = {static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(wq),
             static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(out), B, K, N, cluster,
             tl};
  return ldg::launch(tl != nullptr ? gemv4_ldg<true> : gemv4_ldg<false>, a, cluster, grid,
                     smem4_bytes(B, cluster), st);
}

// The streaming MLP: gate and up, then down (see the note above).
int run_mlp_stream(const void* x, int B, int H, int I, const void* wg, const void* sg,
                   const void* wu, const void* su, const void* wd, const void* sd, void* hp,
                   int c1, int grid1, int c2, int grid2, void* out, unsigned long long* tl,
                   cudaStream_t st) {
  CUtensorMap mg, mu, md;
  if (!ring::weight_map(&mg, wg, H / 2, I, I) || !ring::weight_map(&mu, wu, H / 2, I, I) ||
      !ring::weight_map(&md, wd, I / 2, H, H))
    return static_cast<int>(cudaErrorInvalidValue);
  ring::Args a = {};
  a.x = x;
  a.s0 = static_cast<const float*>(sg);
  a.s1 = static_cast<const float*>(su);
  a.h_out = static_cast<uint32_t*>(hp);
  a.B = B;
  a.K = H;
  a.N = I;
  a.units = H / kUnit;
  a.cluster = c1;
  a.tl = tl;
  int err = ring::launch<ring::kGateUp>(mg, mu, a, grid1, st);
  if (err != 0) return err;
  ring::Args d = {};
  d.x = hp;
  d.s0 = static_cast<const float*>(sd);
  d.out = static_cast<__nv_bfloat16*>(out);
  d.B = B;
  d.K = I;
  d.N = H;
  d.units = I / kUnit;
  d.cluster = c2;
  d.tl = tl == nullptr ? nullptr : tl + grid1 * ring::kStamps;
  return ring::launch<ring::kDown>(md, md, d, grid2, st);
}

constexpr int kGroup = kUnit;                     // rows per scale group
constexpr int kHalf = kGroup / 2;                 // packed rows per group
constexpr int kRowsPerLane = kHalf / kRowLanes;   // 4

// Partial sums over groups [blockIdx.y * gps, + gps) for the block's 128
// columns. Column blocks past col_blocks read the second weight (w1, s1)
// and write columns N.. of the partial rows (the MLP's up projection).
template <int B, typename T>
__global__ void __launch_bounds__(kThreads)
gemv4_split(const T* __restrict__ x, int K, const uint8_t* __restrict__ w0,
            const float* __restrict__ s0, const uint8_t* __restrict__ w1,
            const float* __restrict__ s1, int N, int col_blocks, int gps,
            float* __restrict__ part, int ldp) {
  extern __shared__ float smem[];
  float* red = smem;
  float* xs = smem + kWarps * kBlockN;
  int cb = blockIdx.x, col_off = 0;
  const uint8_t* w = w0;
  const float* s = s0;
  if (cb >= col_blocks) {
    cb -= col_blocks;
    w = w1;
    s = s1;
    col_off = N;
  }
  const int ng = K / kGroup;
  const int g0 = blockIdx.y * gps;
  const int g1 = min(g0 + gps, ng);
  const int len = (g1 - g0) * kGroup;
  stage_x<B>(x, K, g0 * kGroup, len, xs);
  __syncthreads();

  const int ct = threadIdx.x % kColThreads, rl = threadIdx.x / kColThreads;
  const int n0 = cb * kBlockN + ct * kCols;
  float acc[B][kCols];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[b][j] = 0.0f;

  for (int g = g0; g < g1; ++g) {
    uint2 v[kRowsPerLane];
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i)
      v[i] = ld_stream(w + (static_cast<size_t>(g) * kHalf + rl + i * kRowLanes) * N + n0);
    const float4 sa = *reinterpret_cast<const float4*>(s + static_cast<size_t>(g) * N + n0);
    const float4 sb = *reinterpret_cast<const float4*>(s + static_cast<size_t>(g) * N + n0 + 4);
    const float sc[kCols] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
    const float* xg = xs + (g - g0) * kGroup;

    float pg[B][kCols];
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int j = 0; j < kCols; ++j) pg[b][j] = 0.0f;
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) {
      const int r = rl + i * kRowLanes;
      float xlo[B], xhi[B];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        xlo[b] = xg[b * len + r];
        xhi[b] = xg[b * len + r + kHalf];
      }
      const uint32_t words[2] = {v[i].x, v[i].y};
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const uint32_t byte = words[j >> 2] >> (8 * (j & 3));
        const float lo = byte_to_f32(byte & 0xFu, 8.0f);
        const float hi = byte_to_f32((byte >> 4) & 0xFu, 8.0f);
#pragma unroll
        for (int b = 0; b < B; ++b) {
          pg[b][j] = fmaf(xlo[b], lo, pg[b][j]);
          pg[b][j] = fmaf(xhi[b], hi, pg[b][j]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[b][j] = fmaf(pg[b][j], sc[j], acc[b][j]);
  }
  block_reduce_store<B>(acc, red, part, blockIdx.y, ldp, col_off + cb * kBlockN);
}

template <int B, typename T>
int split_b(const T* x, int K, const uint8_t* w0, const float* s0, const uint8_t* w1,
            const float* s1, int N, int dual, int splits, int gps, float* part,
            cudaStream_t st) {
  const int col_blocks = N / kBlockN;
  const dim3 grid(col_blocks * (dual ? 2 : 1), splits);
  gemv4_split<B, T><<<grid, kThreads, split_smem(B, gps * kGroup), st>>>(
      x, K, w0, s0, w1, s1, N, col_blocks, gps, part, (dual ? 2 : 1) * N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_split(const void* x, int B, int K, const void* w0, const void* s0, const void* w1,
              const void* s1, int N, int dual, int splits, int gps, void* part,
              cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const uint8_t* a = static_cast<const uint8_t*>(w0);
  const uint8_t* c = static_cast<const uint8_t*>(w1);
  const float* sa = static_cast<const float*>(s0);
  const float* sc = static_cast<const float*>(s1);
  float* p = static_cast<float*>(part);
#define PALU_CALL(b) split_b<b, T>(xt, K, a, sa, c, sc, N, dual, splits, gps, p, st)
  PALU_SWITCH_B(B, PALU_CALL)
#undef PALU_CALL
}

template <typename T>
int run_gemv(const void* x, int B, int K, int N, const void* wq, const void* ws, void* part,
             int splits, int gps, void* out, cudaStream_t st) {
  int err = run_split<T>(x, B, K, wq, ws, nullptr, nullptr, N, 0, splits, gps, part, st);
  if (err != 0) return err;
  launch_reduce<T>(static_cast<const float*>(part), splits, B, N, nullptr,
                   static_cast<T*>(out), st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_mlp(const void* x, int B, int H, int I, const void* wg, const void* sg, const void* wu,
            const void* su, const void* wd, const void* sd, void* part1, int splits1,
            int gps1, void* h, void* part2, int splits2, int gps2, void* out,
            cudaStream_t st) {
  int err = run_split<T>(x, B, H, wg, sg, wu, su, I, 1, splits1, gps1, part1, st);
  if (err != 0) return err;
  launch_swiglu<T>(static_cast<const float*>(part1), splits1, B, I, nullptr, nullptr,
                   static_cast<T*>(h), st);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return run_gemv<T>(h, B, I, H, wd, sd, part2, splits2, gps2, out, st);
}

}  // namespace

// x (B, K) bf16 or f32; wq (K/2, N) u8; ws (K/128, N) f32; part
// (splits, B, N) f32 scratch; out (B, N) in x's type.
extern "C" int palu_gemv_int4(const void* x, int x_is_bf16, int B, int K, int N,
                              const void* wq, const void* ws, void* part, int splits,
                              int gps, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? run_gemv<__nv_bfloat16>(x, B, K, N, wq, ws, part, splits, gps, out, st)
                   : run_gemv<float>(x, B, K, N, wq, ws, part, splits, gps, out, st);
}

// x (B, H); gate/up (H/2, I) u8 + (H/128, I) f32; down (I/2, H) u8 +
// (I/128, H) f32; part1 (splits1, B, 2I) and part2 (splits2, B, H) f32
// scratch; h (B, I) and out (B, H) in x's type.
extern "C" int palu_mlp_gemv_int4(const void* x, int x_is_bf16, int B, int H, int I,
                                  const void* wg, const void* sg, const void* wu,
                                  const void* su, const void* wd, const void* sd,
                                  void* part1, int splits1, int gps1, void* h, void* part2,
                                  int splits2, int gps2, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_is_bf16
             ? run_mlp<__nv_bfloat16>(x, B, H, I, wg, sg, wu, su, wd, sd, part1, splits1, gps1,
                                  h, part2, splits2, gps2, out, st)
             : run_mlp<float>(x, B, H, I, wg, sg, wu, su, wd, sd, part1, splits1, gps1, h,
                          part2, splits2, gps2, out, st);
}

// The streaming MLP over a bf16 x (B, H): weights as in palu_mlp_gemv_int4;
// hp (B, I/128, 64) u32 scratch (h in the down product's fragment order);
// out (B, H) bf16. c1 / grid1 and c2 / grid2: each launch's cluster size
// and blocks (ops/gemv_int4.mlp_plan); tl: null, or (grid1 + grid2) x
// ring::kStamps timeline stamps.
extern "C" int palu_mlp_gemv_int4_stream(const void* x, int B, int H, int I, const void* wg,
                                         const void* sg, const void* wu, const void* su,
                                         const void* wd, const void* sd, void* hp, int c1,
                                         int grid1, int c2, int grid2, void* out, void* tl,
                                         void* stream) {
  if (H % kUnit || I % kUnit) return static_cast<int>(cudaErrorInvalidValue);
  return run_mlp_stream(x, B, H, I, wg, sg, wu, su, wd, sd, hp, c1, grid1, c2, grid2, out,
                        static_cast<unsigned long long*>(tl),
                        static_cast<cudaStream_t>(stream));
}

// Clusters of `cluster` MLP streaming blocks (kind 0 gate / up, 1 down) of
// `smem` bytes the card runs at once (cudaOccupancyMaxActiveClusters), or -1.
extern "C" int palu_mlp4_max_clusters(int kind, int cluster, int smem) {
  return kind == 0 ? ring::max_clusters<ring::kGateUp>(cluster, smem)
                   : ring::max_clusters<ring::kDown>(cluster, smem);
}

// gemv_int4 over a bf16 x in one launch: x (B, K) bf16, 16-byte aligned;
// wq (K/2, N) u8 and ws (K/128, N) f32 as in palu_gemv_int4; out (B, N)
// bf16. cluster / grid: ops/gemv_int4.gemv4_plan; tl: null, or grid x
// ldg::kStamps timeline stamps.
extern "C" int palu_gemv_int4_ldg(const void* x, int B, int K, int N, const void* wq,
                                  const void* ws, int cluster, int grid, void* out, void* tl,
                                  void* stream) {
  return run_gemv4_ldg(x, B, K, N, wq, ws, cluster, grid, out,
                       static_cast<unsigned long long*>(tl), static_cast<cudaStream_t>(stream));
}

// Clusters of `cluster` gemv4_ldg blocks (shared memory of 8 rows) the card
// runs at once (cudaOccupancyMaxActiveClusters), or -1.
extern "C" int palu_gemv4_ldg_max_clusters(int cluster) {
  return ldg::max_clusters(gemv4_ldg<false>, cluster, smem4_bytes(8, cluster));
}

// The blocks' shared memory (scales 1: gemv4_ldg's, else ldg::smem_bytes),
// for the Python mirror's test on the card.
extern "C" int palu_gemv_ldg_smem(int cols, int B, int cluster, int scales) {
  return scales ? smem4_bytes(B, cluster) : ldg::smem_bytes(cols, B, cluster);
}


// gemv_int4 over a bf16 x on narrow column blocks (gemv4_n32): one block of
// 16 warps per 32 output columns, no cluster; x, wq, ws and out as in
// palu_gemv_int4_ldg; tl: null, or N / 32 x ldg::kStamps timeline stamps.
extern "C" int palu_gemv_int4_n32(const void* x, int B, int K, int N, const void* wq,
                                  const void* ws, void* out, void* tl, void* stream) {
  return run_gemv4_n32(x, B, K, N, wq, ws, out, static_cast<unsigned long long*>(tl),
                       static_cast<cudaStream_t>(stream));
}
