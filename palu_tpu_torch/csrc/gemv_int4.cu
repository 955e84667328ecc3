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
// Design (gemv_common.cuh): split K into whole 128-row groups across blocks
// so that a 4096-column product still fills the 132 SMs; each thread reads
// 8 columns x 2 input rows per 8-byte load and unpacks them with one mask
// and one shift. The offset 8 is subtracted from the code before the
// multiply (exact: the exponent trick yields code - 8 as a float), where the
// TPU kernel folds it out of the dot algebraically; the group's partial dot
// is accumulated in f32 and multiplied by the group scale once per group.
// Splits are summed by a second kernel in a fixed order.
//
// The MLP (h = x.dtype(silu(x Wg) * (x Wu)), y = h Wd) runs as two such
// GEMVs under one call: gate and up share one split pass (their column
// blocks side by side), a reduce kernel forms h (rounded to x's type where
// the TPU kernel rounds it), and the down GEMV reads h from device memory
// (22 KB at one row; it stays in L2). The TPU kernel carries the down
// product's accumulator across a sequential grid, which Hopper has not.

#include "gemv_common.cuh"

using namespace gemv;

namespace {

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
