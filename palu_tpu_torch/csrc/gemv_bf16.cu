// Blocked bf16 GEMV: the streaming floor that the weight-only GEMVs
// (gemv_int4.cu, gemv_int8.cu) should approach.
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
// Design on W (K, N), gemv_bf16: the TPU grid walks N tiles in order; here
// block (j, s) owns the BN columns [j * BN, (j + 1) * BN) and the s-th
// range of the contraction, so that some four blocks run per SM (split-K),
// and a second kernel adds the splits in a fixed order (gemv_common.cuh's
// reduce_out: results repeat from run to run). x's slice is staged in
// shared memory in f32. A block's BN / 8 column threads each read 16 bytes
// (8 columns) of a row, neighbouring threads on neighbouring bytes, and its
// 256 / (BN / 8) row lanes take every such row of the range; the row lanes
// are summed in shared memory. Loads skip L1
// (ld.global.nc.L1::no_allocate): every weight byte is read once.
//
// On W^T (N, K), gemv_bf16_t: one launch on the tensor cores, below
// (namespace tldg).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemv_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;

__device__ __forceinline__ uint4 ld_nc16(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(h[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

// x[:, k0 : k0 + len] as f32 into xs[m * len + k] (the block reads it so)
template <int M>
__device__ __forceinline__ void stage_x(const bf16* __restrict__ x, int K, int k0, int len,
                                        float* xs) {
  for (int i = threadIdx.x; i < M * len; i += kThreads) {
    const int m = i / len, k = i - m * len;
    xs[i] = __bfloat162float(x[static_cast<size_t>(m) * K + k0 + k]);
  }
}

// W (K, N): part[s, m, n] for the block's columns and rows [k0, k0 + krange).
template <int M>
__global__ void __launch_bounds__(kThreads)
    gemv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, float* __restrict__ part,
                int K, int N, int BN, int krange) {
  extern __shared__ float sm[];
  const int ct_n = BN / 8, lanes = kThreads / ct_n;
  const int ct = threadIdx.x % ct_n, rl = threadIdx.x / ct_n;
  const int n0 = blockIdx.x * BN + ct * 8, split = blockIdx.y;
  const int k0 = split * krange, len = min(krange, K - k0);
  float* xs = sm;                       // [M][krange]
  float* red = sm + M * krange;         // [lanes][M][BN]
  stage_x<M>(x, K, k0, len, xs);
  __syncthreads();
  float acc[M][8];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.0f;
#pragma unroll 4
  for (int k = rl; k < len; k += lanes) {
    float f[8];
    unpack8(ld_nc16(w + static_cast<size_t>(k0 + k) * N + n0), f);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float xv = xs[m * len + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[m][j] += xv * f[j];
    }
  }
  for (int m = 0; m < M; ++m) {
    float4* dst = reinterpret_cast<float4*>(red + (rl * M + m) * BN + ct * 8);
    dst[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    dst[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M * BN; i += kThreads) {
    const int m = i / BN, c = i - m * BN;
    float s = 0.0f;
    for (int l = 0; l < lanes; ++l) s += red[(l * M + m) * BN + c];
    part[(static_cast<size_t>(split) * M + m) * N + blockIdx.x * BN + c] = s;
  }
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

template <int M>
int launch(const bf16* x, const bf16* w, float* part, int K, int N, int BN, int splits, int krange,
           cudaStream_t st) {
  const int lanes = kThreads / (BN / 8);
  const size_t smem = sizeof(float) * (static_cast<size_t>(M) * krange +
                                       static_cast<size_t>(lanes) * M * BN);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      gemv_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gemv_kernel<M><<<dim3(N / BN, splits), kThreads, smem, st>>>(x, w, part, K, N, BN, krange);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (M, N) bf16 = x (M, K) bf16 . W, W stored (K, N); M 1 to 8. BN columns
// per block: a power of two between 64 and 2048 that divides N. The
// contraction splits into `splits` ranges of krange rows (a multiple of 8;
// splits * krange >= K); part holds splits * M * N f32. K and N multiples
// of 8.
extern "C" int gemv_bf16(const void* x, const void* w, void* part, void* y, int M, int K, int N,
                         int BN, int splits, int krange, void* stream) {
  if (K % 8 || N % 8 || BN <= 0 || N % BN || krange % 8 || krange <= 0 ||
      static_cast<long long>(splits) * krange < K || (splits - 1) * krange >= K ||
      BN % 8 || BN < 64 || BN > 2048 || kThreads % (BN / 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  float* pf = static_cast<float*>(part);
#define PALU_GEMV_BF16(B) launch<B>(xb, wb, pf, K, N, BN, splits, krange, st)
  const int err = [&]() -> int { PALU_SWITCH_B(M, PALU_GEMV_BF16) }();
#undef PALU_GEMV_BF16
  if (err != 0) return err;
  gemv::launch_reduce<bf16>(pf, splits, M, N, nullptr, static_cast<bf16*>(y), st);
  return static_cast<int>(cudaGetLastError());
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
