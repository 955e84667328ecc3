// Shared pieces of the weight-only GEMV kernels (gemv_int4.cu, gemv_int8.cu).
//
// Layout of the split-K pass: a block owns kBlockN = 128 output columns and
// a range of whole 128-row units of the contraction (the int4 scale group,
// or a 128-row chunk of an int8 weight). Its 256 threads are 16 column
// threads (8 columns each, one 8-byte load per weight row) times 16 row
// lanes that take every 16th row of the unit. The block sums its row lanes
// in shared memory and writes one f32 partial row per (split, batch row);
// a second kernel adds the splits in a fixed order, so results repeat from
// run to run (no float atomics).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Dispatch a runtime row count 1..8 to the kernel instantiated for it.
#define PALU_SWITCH_B(B, CALL)                                \
  switch (B) {                                                \
    case 1: return CALL(1);                                   \
    case 2: return CALL(2);                                   \
    case 3: return CALL(3);                                   \
    case 4: return CALL(4);                                   \
    case 5: return CALL(5);                                   \
    case 6: return CALL(6);                                   \
    case 7: return CALL(7);                                   \
    case 8: return CALL(8);                                   \
    default: return static_cast<int>(cudaErrorInvalidValue);  \
  }

namespace gemv {

constexpr int kThreads = 256;
constexpr int kCols = 8;                        // columns per thread
constexpr int kColThreads = 16;                 // threads across a row
constexpr int kBlockN = kColThreads * kCols;    // 128 columns per block
constexpr int kRowLanes = kThreads / kColThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kUnit = 128;                      // contraction rows per split unit

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Weights are read once per call: keep them out of L1.
__device__ __forceinline__ uint2 ld_stream(const uint8_t* p) {
  uint2 v;
  asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p));
  return v;
}

// 0..255 -> float exactly, by the exponent trick (one logic op and one add
// in place of an integer-to-float conversion): 2^23 + v - offset.
__device__ __forceinline__ float byte_to_f32(uint32_t v, float offset) {
  return __int_as_float(0x4B000000u | v) - (8388608.0f + offset);
}

// x[:, k0 : k0 + len] as f32 in shared memory, xs[b * len + k]; rows past K
// read as 0.
template <int B, typename T>
__device__ __forceinline__ void stage_x(const T* __restrict__ x, int K, int k0, int len,
                                        float* xs) {
  for (int i = threadIdx.x; i < B * len; i += kThreads) {
    const int b = i / len, k = i - b * len;
    xs[i] = (k0 + k < K) ? to_f32(x[static_cast<size_t>(b) * K + k0 + k]) : 0.0f;
  }
}

// Sum acc over the block's row lanes and store the block's partial sums for
// its kBlockN columns at part[(split * B + b) * ldp + col0 + c].
// red: kWarps * kBlockN floats of shared memory.
template <int B>
__device__ __forceinline__ void block_reduce_store(float (&acc)[B][kCols], float* red,
                                                   float* __restrict__ part, int split,
                                                   int ldp, int col0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ct = threadIdx.x % kColThreads;
#pragma unroll
  for (int b = 0; b < B; ++b) {
    // lanes c and c + 16 of a warp are two row lanes of the same columns
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      acc[b][j] += __shfl_xor_sync(0xffffffffu, acc[b][j], 16);
    if (lane < kColThreads) {
      float4* dst = reinterpret_cast<float4*>(red + warp * kBlockN + ct * kCols);
      dst[0] = make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
      dst[1] = make_float4(acc[b][4], acc[b][5], acc[b][6], acc[b][7]);
    }
    __syncthreads();
    if (threadIdx.x < kBlockN) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w * kBlockN + threadIdx.x];
      part[(static_cast<size_t>(split) * B + b) * ldp + col0 + threadIdx.x] = s;
    }
    __syncthreads();
  }
}

// out[b, n] = T(sum over splits of part[s, b, n], times scale[n] if given).
template <typename T>
__global__ void reduce_out(const float* __restrict__ part, int splits, int B, int N,
                           const float* __restrict__ scale, T* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * N) return;
  const size_t stride = static_cast<size_t>(B) * N;
  float s = 0.0f;
  for (int sp = 0; sp < splits; ++sp) s += part[sp * stride + i];
  if (scale != nullptr) s *= scale[i % N];
  out[i] = from_f32<T>(s);
}

// SwiGLU of the gate/up partials: part rows hold 2N columns (gate, then up).
// h[b, n] = T(silu(g) * u), with g and u the split sums, each times its
// per-channel scale when given (int8), applied before silu.
template <typename T>
__global__ void swiglu_reduce(const float* __restrict__ part, int splits, int B, int N,
                              const float* __restrict__ gs, const float* __restrict__ us,
                              T* __restrict__ h) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * N) return;
  const int b = i / N, n = i - b * N;
  float g = 0.0f, u = 0.0f;
  for (int sp = 0; sp < splits; ++sp) {
    const float* row = part + (static_cast<size_t>(sp) * B + b) * 2 * N;
    g += row[n];
    u += row[N + n];
  }
  if (gs != nullptr) {
    g *= gs[n];
    u *= us[n];
  }
  const float silu = g * (1.0f / (1.0f + expf(-g)));
  h[i] = from_f32<T>(silu * u);
}

constexpr int kReduceThreads = 256;

template <typename T>
inline void launch_reduce(const float* part, int splits, int B, int N, const float* scale,
                          T* out, cudaStream_t st) {
  const int n = B * N;
  reduce_out<T><<<(n + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, st>>>(
      part, splits, B, N, scale, out);
}

template <typename T>
inline void launch_swiglu(const float* part, int splits, int B, int N, const float* gs,
                          const float* us, T* h, cudaStream_t st) {
  const int n = B * N;
  swiglu_reduce<T><<<(n + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, st>>>(
      part, splits, B, N, gs, us, h);
}

// Shared memory of a split-K block: the reduction buffer, then x's slice.
inline size_t split_smem(int B, int rows) {
  return (static_cast<size_t>(kWarps) * kBlockN + static_cast<size_t>(B) * rows) *
         sizeof(float);
}

}  // namespace gemv
