// Int8 weight-only GEMV and SwiGLU MLP for decode-sized inputs (1-8 rows).
//
// Replaces: palu_tpu/ops/pallas/gemv_int8.py::gemv_int8 and ::mlp_gemv_int8.
//
// Storage (core/wquant.quantize_weight): wq8 (K, N) int8 codes -127..127
// (exact in f32), ws (1, N) f32 per-output-channel scales, applied once
// after the whole sum as the TPU kernel does.
//
// Bound on this card: bytes. At 8 rows or fewer every weight byte feeds at
// most 8 multiply-adds; the weights are read once.
// Design (gemv_common.cuh): for a weight with N contiguous, split K into
// 128-row chunks across blocks (at N = 1024, one block per 128 columns
// would give 8 blocks for 132 SMs); each thread reads 8 columns per 8-byte
// load and converts the codes by the exponent trick. Splits are summed in a
// fixed order by a second kernel that also applies the scales.
// The tied int8 lm_head is a transposed view (embedding codes (V, H) read as
// (H, V) with K contiguous); copying it would cost more than the product, so
// it has its own kernel: a warp per output column walks K with 4-byte loads
// against x staged in shared memory, and reduces across its lanes.
//
// The MLP runs as two GEMVs under one call, as in gemv_int4.cu: gate and up
// in one split pass, a reduce kernel that applies their scales before silu
// and rounds h to x's type, then the down GEMV whose scale comes after its
// sum.

#include "gemv_common.cuh"

using namespace gemv;

namespace {

constexpr int kUnroll = 4;        // rows in flight per thread
constexpr int kColsPerWarp = 4;   // K-major kernel: output columns per warp
constexpr int kKTile = 1024;      // K-major kernel: x rows staged per pass

__device__ __forceinline__ float code_f32(uint32_t byte) {
  return byte_to_f32((byte & 0xFFu) ^ 0x80u, 128.0f);  // two's complement byte
}

// Partial sums over rows [blockIdx.y * ups * 128, + ups * 128) of K for the
// block's 128 columns; weight rows are ldw bytes apart. Column blocks past
// col_blocks read w1 and write columns N.. of the partial rows.
template <int B, typename T>
__global__ void __launch_bounds__(kThreads)
gemv8_split(const T* __restrict__ x, int K, const int8_t* __restrict__ w0,
            const int8_t* __restrict__ w1, int ldw, int N, int col_blocks, int ups,
            float* __restrict__ part, int ldp) {
  extern __shared__ float smem[];
  float* red = smem;
  float* xs = smem + kWarps * kBlockN;
  int cb = blockIdx.x, col_off = 0;
  const int8_t* w = w0;
  if (cb >= col_blocks) {
    cb -= col_blocks;
    w = w1;
    col_off = N;
  }
  const int k0 = blockIdx.y * ups * kUnit;
  const int len = min(ups * kUnit, K - k0);
  stage_x<B>(x, K, k0, len, xs);
  __syncthreads();

  const int ct = threadIdx.x % kColThreads, rl = threadIdx.x / kColThreads;
  const int n0 = cb * kBlockN + ct * kCols;
  const uint8_t* wb = reinterpret_cast<const uint8_t*>(w) + static_cast<size_t>(k0) * ldw + n0;
  float acc[B][kCols];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[b][j] = 0.0f;

  for (int r0 = 0; r0 < len; r0 += kRowLanes * kUnroll) {
    uint2 v[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int r = r0 + rl + i * kRowLanes;
      v[i] = r < len ? ld_stream(wb + static_cast<size_t>(r) * ldw) : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int r = r0 + rl + i * kRowLanes;
      if (r >= len) break;
      float xv[B];
#pragma unroll
      for (int b = 0; b < B; ++b) xv[b] = xs[b * len + r];
      const uint32_t words[2] = {v[i].x, v[i].y};
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float c = code_f32(words[j >> 2] >> (8 * (j & 3)));
#pragma unroll
        for (int b = 0; b < B; ++b) acc[b][j] = fmaf(xv[b], c, acc[b][j]);
      }
    }
  }
  block_reduce_store<B>(acc, red, part, blockIdx.y, ldp, col_off + cb * kBlockN);
}

// y[b, n] = T(scale[n] * sum_k x[b, k] w[n * ldw + k]): K contiguous.
template <int B, typename T>
__global__ void __launch_bounds__(kThreads)
gemv8_kmajor(const T* __restrict__ x, int K, const int8_t* __restrict__ w, int ldw, int N,
             const float* __restrict__ scale, T* __restrict__ out) {
  __shared__ __align__(16) float xs[B * kKTile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nbase = (blockIdx.x * kWarps + warp) * kColsPerWarp;
  float acc[kColsPerWarp][B];
#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
    for (int b = 0; b < B; ++b) acc[c][b] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kKTile) {
    const int len = min(kKTile, K - k0);
    __syncthreads();
    stage_x<B>(x, K, k0, len, xs);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c) {
      const int n = nbase + c;
      if (n >= N) break;
      const uint8_t* col = reinterpret_cast<const uint8_t*>(w) + static_cast<size_t>(n) * ldw + k0;
      for (int kk = lane * 4; kk < len; kk += 32 * 4) {
        const uint32_t word = __ldg(reinterpret_cast<const uint32_t*>(col + kk));
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const float4 xv = *reinterpret_cast<const float4*>(xs + b * len + kk);
          float a = acc[c][b];
          a = fmaf(xv.x, code_f32(word), a);
          a = fmaf(xv.y, code_f32(word >> 8), a);
          a = fmaf(xv.z, code_f32(word >> 16), a);
          a = fmaf(xv.w, code_f32(word >> 24), a);
          acc[c][b] = a;
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[c][b] += __shfl_xor_sync(0xffffffffu, acc[c][b], o);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c) {
      const int n = nbase + c;
      if (n >= N) break;
#pragma unroll
      for (int b = 0; b < B; ++b)
        out[static_cast<size_t>(b) * N + n] = from_f32<T>(acc[c][b] * scale[n]);
    }
  }
}

template <int B, typename T>
int split_b(const T* x, int K, const int8_t* w0, const int8_t* w1, int ldw, int N, int dual,
            int splits, int ups, float* part, cudaStream_t st) {
  const int col_blocks = N / kBlockN;
  const dim3 grid(col_blocks * (dual ? 2 : 1), splits);
  gemv8_split<B, T><<<grid, kThreads, split_smem(B, ups * kUnit), st>>>(
      x, K, w0, w1, ldw, N, col_blocks, ups, part, (dual ? 2 : 1) * N);
  return static_cast<int>(cudaGetLastError());
}

template <int B, typename T>
int kmajor_b(const T* x, int K, const int8_t* w, int ldw, int N, const float* scale, T* out,
             cudaStream_t st) {
  const int cols = kWarps * kColsPerWarp;
  gemv8_kmajor<B, T><<<(N + cols - 1) / cols, kThreads, 0, st>>>(x, K, w, ldw, N, scale, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_split(const void* x, int B, int K, const void* w0, const void* w1, int ldw, int N,
              int dual, int splits, int ups, void* part, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const int8_t* a = static_cast<const int8_t*>(w0);
  const int8_t* c = static_cast<const int8_t*>(w1);
  float* p = static_cast<float*>(part);
#define PALU_CALL(b) split_b<b, T>(xt, K, a, c, ldw, N, dual, splits, ups, p, st)
  PALU_SWITCH_B(B, PALU_CALL)
#undef PALU_CALL
}

template <typename T>
int run_kmajor(const void* x, int B, int K, const void* w, int ldw, int N, const void* scale,
               void* out, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const int8_t* wt = static_cast<const int8_t*>(w);
  const float* s = static_cast<const float*>(scale);
  T* o = static_cast<T*>(out);
#define PALU_CALL(b) kmajor_b<b, T>(xt, K, wt, ldw, N, s, o, st)
  PALU_SWITCH_B(B, PALU_CALL)
#undef PALU_CALL
}

template <typename T>
int run_gemv(const void* x, int B, int K, int N, const void* wq, int ldw, int k_major,
             const void* ws, void* part, int splits, int ups, void* out, cudaStream_t st) {
  if (k_major) return run_kmajor<T>(x, B, K, wq, ldw, N, ws, out, st);
  int err = run_split<T>(x, B, K, wq, nullptr, ldw, N, 0, splits, ups, part, st);
  if (err != 0) return err;
  launch_reduce<T>(static_cast<const float*>(part), splits, B, N,
                   static_cast<const float*>(ws), static_cast<T*>(out), st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_mlp(const void* x, int B, int H, int I, const void* wg, const void* sg, const void* wu,
            const void* su, const void* wd, const void* sd, void* part1, int splits1,
            int ups1, void* h, void* part2, int splits2, int ups2, void* out,
            cudaStream_t st) {
  int err = run_split<T>(x, B, H, wg, wu, I, I, 1, splits1, ups1, part1, st);
  if (err != 0) return err;
  launch_swiglu<T>(static_cast<const float*>(part1), splits1, B, I,
                   static_cast<const float*>(sg), static_cast<const float*>(su),
                   static_cast<T*>(h), st);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return run_gemv<T>(h, B, I, H, wd, H, 0, sd, part2, splits2, ups2, out, st);
}

}  // namespace

// x (B, K) bf16 or f32; wq int8 codes of a (K, N) weight: row k of N
// contiguous codes at wq + k * ldw (k_major == 0), or column n of K
// contiguous codes at wq + n * ldw (k_major == 1, the transposed tied
// head); ws (N,) f32; part (splits, B, N) f32 scratch (unused when
// k_major); out (B, N) in x's type.
extern "C" int palu_gemv_int8(const void* x, int x_is_bf16, int B, int K, int N,
                              const void* wq, int ldw, int k_major, const void* ws, void* part,
                              int splits, int ups, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? run_gemv<__nv_bfloat16>(x, B, K, N, wq, ldw, k_major, ws, part, splits,
                                             ups, out, st)
                   : run_gemv<float>(x, B, K, N, wq, ldw, k_major, ws, part, splits, ups,
                                     out, st);
}

// x (B, H); gate/up (H, I) int8 + (I,) f32; down (I, H) int8 + (H,) f32, all
// row-major; part1 (splits1, B, 2I) and part2 (splits2, B, H) f32 scratch;
// h (B, I) and out (B, H) in x's type.
extern "C" int palu_mlp_gemv_int8(const void* x, int x_is_bf16, int B, int H, int I,
                                  const void* wg, const void* sg, const void* wu,
                                  const void* su, const void* wd, const void* sd,
                                  void* part1, int splits1, int ups1, void* h, void* part2,
                                  int splits2, int ups2, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_is_bf16
             ? run_mlp<__nv_bfloat16>(x, B, H, I, wg, sg, wu, su, wd, sd, part1, splits1,
                                      ups1, h, part2, splits2, ups2, out, st)
             : run_mlp<float>(x, B, H, I, wg, sg, wu, su, wd, sd, part1, splits1, ups1, h,
                              part2, splits2, ups2, out, st);
}
