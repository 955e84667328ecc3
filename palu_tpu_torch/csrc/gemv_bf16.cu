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
// Design: the TPU grid walks N tiles in order; here block (j, s) owns the
// BN columns [j * BN, (j + 1) * BN) and the s-th range of the contraction,
// so that some four blocks run per SM (split-K), and a second kernel adds
// the splits in a fixed order (gemv_common.cuh's reduce_out: results
// repeat from run to run). x's slice is staged in shared memory in f32.
// On W (K, N) a block's BN / 8 column threads each read 16 bytes (8
// columns) of a row, neighbouring threads on neighbouring bytes, and its
// 256 / (BN / 8) row lanes take every such row of the range; the row lanes
// are summed in shared memory. On W^T (N, K) each warp takes four rows of
// W^T (output columns) at a time and reads the range 16 bytes a lane, 512
// contiguous bytes a row and step, four loads in flight, and sums each row
// with shuffles. Loads skip L1
// (ld.global.nc.L1::no_allocate): every weight byte is read once.

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

// W^T (N, K): part[s, m, n] for the block's BN rows of W^T and the range;
// each warp takes kRows rows at a time, so that kRows loads are in flight.
constexpr int kRows = 4;

template <int M>
__global__ void __launch_bounds__(kThreads)
    gemv_t_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                  float* __restrict__ part, int K, int N, int BN, int krange) {
  extern __shared__ float sm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, split = blockIdx.y;
  const int k0 = split * krange, len = min(krange, K - k0);
  float* xs = sm;  // [M][len]
  stage_x<M>(x, K, k0, len, xs);
  __syncthreads();
  for (int r0 = warp * kRows; r0 < BN; r0 += (kThreads / 32) * kRows) {
    const int nr = min(kRows, BN - r0);
    const size_t n0 = static_cast<size_t>(blockIdx.x) * BN + r0;
    float acc[kRows][M];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int m = 0; m < M; ++m) acc[i][m] = 0.0f;
    for (int k = lane * 8; k < len; k += 256) {
      uint4 u[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        if (i < nr) u[i] = ld_nc16(wt + (n0 + i) * K + k0 + k);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (i < nr) {
          float f[8];
          unpack8(u[i], f);
#pragma unroll
          for (int m = 0; m < M; ++m)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][m] += xs[m * len + k + j] * f[j];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        float s = acc[i][m];
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0 && i < nr) part[(static_cast<size_t>(split) * M + m) * N + n0 + i] = s;
      }
    }
  }
}

template <int M>
int launch(bool t, const bf16* x, const bf16* w, float* part, int K, int N, int BN, int splits,
           int krange, cudaStream_t st) {
  const int lanes = kThreads / (BN / 8);
  const size_t smem = sizeof(float) * (static_cast<size_t>(M) * krange +
                                       (t ? 0 : static_cast<size_t>(lanes) * M * BN));
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(t ? gemv_t_kernel<M> : gemv_kernel<M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N / BN, splits);
  if (t)
    gemv_t_kernel<M><<<grid, kThreads, smem, st>>>(x, w, part, K, N, BN, krange);
  else
    gemv_kernel<M><<<grid, kThreads, smem, st>>>(x, w, part, K, N, BN, krange);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (M, N) bf16 = x (M, K) bf16 . W, W stored (K, N) (transposed = 0) or
// W^T stored (N, K) (transposed = 1); M 1 to 8. BN columns per block: a
// power of two between 64 and 2048 that divides N (on W^T any divisor of
// N). The contraction splits into `splits` ranges of krange rows (a
// multiple of 8; splits * krange >= K); part holds splits * M * N f32. K
// and N multiples of 8.
extern "C" int gemv_bf16(const void* x, const void* w, void* part, void* y, int M, int K, int N,
                         int BN, int splits, int krange, int transposed, void* stream) {
  if (K % 8 || N % 8 || BN <= 0 || N % BN || krange % 8 || krange <= 0 ||
      static_cast<long long>(splits) * krange < K || (splits - 1) * krange >= K)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!transposed && (BN % 8 || BN < 64 || BN > 2048 || kThreads % (BN / 8)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  float* pf = static_cast<float*>(part);
  const bool t = transposed != 0;
#define PALU_GEMV_BF16(B) launch<B>(t, xb, wb, pf, K, N, BN, splits, krange, st)
  const int err = [&]() -> int { PALU_SWITCH_B(M, PALU_GEMV_BF16) }();
#undef PALU_GEMV_BF16
  if (err != 0) return err;
  gemv::launch_reduce<bf16>(pf, splits, M, N, nullptr, static_cast<bf16*>(y), st);
  return static_cast<int>(cudaGetLastError());
}
