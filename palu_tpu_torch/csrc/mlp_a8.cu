// SwiGLU MLP over int8 weights with the activations quantized to int8 on
// the fly (W8A8): int8 x int8 products summed in int32.
//
// Replaces: tools/tpu_mlp_a8_probe.py::mlp_a8 (kernel _mlp_kernel_a8), the
// probe that asks whether int8 x int8 dots beat the production w8a16
// mlp_gemv_int8.
//
// What it computes, for x (B, H) bf16 and int8 weights {wq8, ws}: gate and
// up (H, I), down (I, H), per-output-channel f32 scales gs, us, ds:
//   xs = max(max_k |x[b, k]| / 127, 1e-30) per row, xq = rint(x / xs);
//   per tile j of bn columns of I (bn is part of the function):
//     g = f32(xq . Wg[:, tile]) * (xs * gs), u likewise with Wu, us;
//     h = silu(g) * u in f32;
//     hs = max(max_n |h[b, n]| / 127, 1e-30) per row of the tile,
//     hq = rint(h / hs);
//     acc += f32(hq . Wd[tile, :]) * hs;
//   out = bf16(acc * ds).
// Divisions are IEEE f32 divisions, rint rounds half to even, and the
// int32 sums convert to f32 once (round to nearest), as the TPU kernel's
// int32 dots and casts do. acc sums the tiles in order j = 0, 1, ... in
// f32, as the TPU kernel's sequential grid does, so the only difference
// from the plain version is silu's last bits (x / (1 + expf(-x)), PyTorch's
// CUDA formula); a code of hq on a rounding edge can differ by one.
//
// Bound on this card: bytes. The three int8 weights are 3 * H * I bytes
// (135 MB at 4096 x 11008: 0.040 ms at 3.35 TB/s); the 2 * 3 * B * H * I
// int8 operations take 0.14 us at the int8 tensor-core rate.
//
// Design: three kernels after a memset of the int32 gate/up sums.
//   gate_up: grid (I / 128, splits of H). A block takes 128 columns and a
//     range of rows of Wg and Wu; it quantizes x's rows (every block forms
//     xs from the whole row, then xq for its rows, in shared memory); each
//     thread reads 4 columns (one 32-bit word) of 4 consecutive rows of a
//     weight, transposes the 4 x 4 bytes with byte permutes into 4 words of
//     k-consecutive codes, and takes __dp4a (4 signed int8 products and an
//     int32 add) with the packed xq; warps take interleaved 4-row groups
//     and meet in shared int32 sums, which go to global memory with one
//     int32 atomicAdd per (row, column): integer sums in any order are
//     exact, so the split over H changes nothing.
//   down: grid (H / 128, I / bn). A block forms h of its tile from the int32
//     sums (twice: once for the row max, once to quantize, the same f32
//     arithmetic both times), then the int32 products of hq with 128
//     columns of the tile's bn rows of Wd, as above, and writes its tile's
//     f32 partial f32(sum) * hs.
//   finish: out = bf16((sum of the partials over j in order) * ds).
// The blocks of column block 0 also write xq and hq, so the caller can hold
// the codes against the plain version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;     // columns per block: 4 per thread of a warp
constexpr int kMaxRows = 8;    // rows of x

// acc[b][c] += the int32 dot of codes W[k0 + 4i .. k0 + 4i + 3][col .. col
// + 3] (rows of ldw bytes) with the int8 rows a[b][...] (shared memory,
// stride lda bytes, k counted from k0), over this warp's 4-row groups of
// [k0, k1): group i goes to warp i % kWarps.
template <int ROWS>
__device__ __forceinline__ void dot4(int (&acc)[ROWS][4], const int8_t* __restrict__ w,
                                     size_t ldw, int k0, int k1, int col,
                                     const int8_t* a, int lda, int warp) {
#pragma unroll 4
  for (int k = k0 + 4 * warp; k < k1; k += 4 * kWarps) {
    const int8_t* p = w + static_cast<size_t>(k) * ldw + col;
    const uint32_t r0 = __ldg(reinterpret_cast<const uint32_t*>(p));
    const uint32_t r1 = __ldg(reinterpret_cast<const uint32_t*>(p + ldw));
    const uint32_t r2 = __ldg(reinterpret_cast<const uint32_t*>(p + 2 * ldw));
    const uint32_t r3 = __ldg(reinterpret_cast<const uint32_t*>(p + 3 * ldw));
    // 4 x 4 byte transpose: word c holds column col + c at rows k .. k + 3
    const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r2, r3, 0x5140);
    const uint32_t t2 = __byte_perm(r0, r1, 0x7362), t3 = __byte_perm(r2, r3, 0x7362);
    const int c[4] = {static_cast<int>(__byte_perm(t0, t1, 0x5410)),
                      static_cast<int>(__byte_perm(t0, t1, 0x7632)),
                      static_cast<int>(__byte_perm(t2, t3, 0x5410)),
                      static_cast<int>(__byte_perm(t2, t3, 0x7632))};
#pragma unroll
    for (int b = 0; b < ROWS; ++b) {
      const int x4 = *reinterpret_cast<const int*>(a + b * lda + (k - k0));
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[b][j] = __dp4a(c[j], x4, acc[b][j]);
    }
  }
}

// The warps' sums of acc into red[ROWS][kCols] (zeroed before, with a
// barrier); ends with a barrier.
template <int ROWS>
__device__ __forceinline__ void reduce_warps(int* red, const int (&acc)[ROWS][4], int lane) {
#pragma unroll
  for (int b = 0; b < ROWS; ++b)
#pragma unroll
    for (int j = 0; j < 4; ++j) atomicAdd(red + b * kCols + 4 * lane + j, acc[b][j]);
  __syncthreads();
}

__device__ __forceinline__ float block_max(float v, float* red_f) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x / 32;
  __syncthreads();  // red_f free
  if (threadIdx.x % 32 == 0) red_f[warp] = v;
  __syncthreads();
  float m = red_f[0];
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red_f[w]);
  return m;
}

// h of row b, column n: silu(g) * u from the int32 sums, in f32.
__device__ __forceinline__ float h_at(const int* gi, const int* ui, const float* gs,
                                      const float* us, float xs, size_t i, int n) {
  const float g = static_cast<float>(gi[i]) * (xs * gs[n]);
  const float u = static_cast<float>(ui[i]) * (xs * us[n]);
  return g / (1.0f + expf(-g)) * u;
}

// grid (I / kCols, splits): rows [split * krange, ...) of Wg and Wu.
template <int ROWS>
__global__ void __launch_bounds__(kThreads) gate_up_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wg,
    const int8_t* __restrict__ wu, int* __restrict__ gi, int* __restrict__ ui,
    int8_t* __restrict__ xq_out, float* __restrict__ xs_out, int H, int I, int krange) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* red_g = reinterpret_cast<int*>(smem);            // [ROWS][kCols]
  int* red_u = red_g + ROWS * kCols;
  float* red_f = reinterpret_cast<float*>(red_u + ROWS * kCols);  // [kWarps]
  float* xs_s = red_f + kWarps;                         // [ROWS]
  int8_t* xq = reinterpret_cast<int8_t*>(xs_s + kMaxRows);  // [ROWS][krange]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col = blockIdx.x * kCols + 4 * lane;
  const int k0 = blockIdx.y * krange, k1 = min(H, k0 + krange);

  for (int i = tid; i < 2 * ROWS * kCols; i += kThreads) red_g[i] = 0;
  for (int b = 0; b < ROWS; ++b) {
    float m = 0.0f;
    for (int k = tid; k < H; k += kThreads)
      m = fmaxf(m, fabsf(__bfloat162float(x[static_cast<size_t>(b) * H + k])));
    m = block_max(m, red_f);
    if (tid == 0) xs_s[b] = fmaxf(m / 127.0f, 1e-30f);
  }
  __syncthreads();
  for (int i = tid; i < ROWS * (k1 - k0); i += kThreads) {
    const int b = i / (k1 - k0), k = k0 + i % (k1 - k0);
    const float v = rintf(__bfloat162float(x[static_cast<size_t>(b) * H + k]) / xs_s[b]);
    xq[b * krange + (k - k0)] = static_cast<int8_t>(v);
    if (blockIdx.x == 0) xq_out[static_cast<size_t>(b) * H + k] = static_cast<int8_t>(v);
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid < ROWS) xs_out[tid] = xs_s[tid];
  __syncthreads();

  int ag[ROWS][4] = {}, au[ROWS][4] = {};
  dot4<ROWS>(ag, wg, I, k0, k1, col, xq, krange, warp);
  dot4<ROWS>(au, wu, I, k0, k1, col, xq, krange, warp);
  reduce_warps<ROWS>(red_g, ag, lane);
  reduce_warps<ROWS>(red_u, au, lane);
  for (int i = tid; i < ROWS * kCols; i += kThreads) {
    const size_t o = static_cast<size_t>(i / kCols) * I + blockIdx.x * kCols + i % kCols;
    atomicAdd(gi + o, red_g[i]);
    atomicAdd(ui + o, red_u[i]);
  }
}

// grid (H / kCols, I / bn): tile j = blockIdx.y.
template <int ROWS>
__global__ void __launch_bounds__(kThreads) down_kernel(
    const int* __restrict__ gi, const int* __restrict__ ui, const float* __restrict__ gs,
    const float* __restrict__ us, const float* __restrict__ xs, const int8_t* __restrict__ wd,
    float* __restrict__ part, int8_t* __restrict__ hq_out, int H, int I, int bn) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* red = reinterpret_cast<int*>(smem);              // [ROWS][kCols]
  float* red_f = reinterpret_cast<float*>(red + ROWS * kCols);  // [kWarps]
  float* hs_s = red_f + kWarps;                         // [ROWS]
  int8_t* hq = reinterpret_cast<int8_t*>(hs_s + kMaxRows);  // [ROWS][bn]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int j = blockIdx.y, n0 = j * bn;
  const int col = blockIdx.x * kCols + 4 * lane;

  for (int i = tid; i < ROWS * kCols; i += kThreads) red[i] = 0;
  for (int b = 0; b < ROWS; ++b) {
    const float xb = xs[b];
    float m = 0.0f;
    for (int n = tid; n < bn; n += kThreads) {
      const size_t i = static_cast<size_t>(b) * I + n0 + n;
      m = fmaxf(m, fabsf(h_at(gi, ui, gs, us, xb, i, n0 + n)));
    }
    m = block_max(m, red_f);
    if (tid == 0) hs_s[b] = fmaxf(m / 127.0f, 1e-30f);
  }
  __syncthreads();
  for (int i = tid; i < ROWS * bn; i += kThreads) {
    const int b = i / bn, n = i % bn;
    const size_t gidx = static_cast<size_t>(b) * I + n0 + n;
    const float v = rintf(h_at(gi, ui, gs, us, xs[b], gidx, n0 + n) / hs_s[b]);
    hq[b * bn + n] = static_cast<int8_t>(v);
    if (blockIdx.x == 0) hq_out[gidx] = static_cast<int8_t>(v);
  }
  __syncthreads();

  int acc[ROWS][4] = {};
  dot4<ROWS>(acc, wd + static_cast<size_t>(n0) * H, H, 0, bn, col, hq, bn, warp);
  reduce_warps<ROWS>(red, acc, lane);
  for (int i = tid; i < ROWS * kCols; i += kThreads) {
    const int b = i / kCols;
    part[(static_cast<size_t>(j) * ROWS + b) * H + blockIdx.x * kCols + i % kCols] =
        static_cast<float>(red[i]) * hs_s[b];
  }
}

__global__ void __launch_bounds__(kThreads) finish_kernel(const float* __restrict__ part,
                                                          const float* __restrict__ ds,
                                                          __nv_bfloat16* __restrict__ out,
                                                          int rows, int H, int nj) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= rows * H) return;
  float acc = 0.0f;
  for (int j = 0; j < nj; ++j) acc += part[static_cast<size_t>(j) * rows * H + i];
  out[i] = __float2bfloat16(acc * ds[i % H]);
}

template <int ROWS>
int launch(const void* x, const void* wg, const void* gs, const void* wu, const void* us,
           const void* wd, const void* ds, void* gi, void* ui, void* part, void* xq,
           void* xs, void* hq, void* out, int H, int I, int bn, int splits, int krange,
           cudaStream_t st) {
  const size_t head = sizeof(int) * ROWS * kCols + sizeof(float) * (kWarps + kMaxRows);
  const size_t smem1 = head + sizeof(int) * ROWS * kCols + static_cast<size_t>(ROWS) * krange;
  const size_t smem2 = head + static_cast<size_t>(ROWS) * bn;
  cudaError_t err = cudaFuncSetAttribute(gate_up_kernel<ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem1));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(down_kernel<ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem2));
  if (err == cudaSuccess)
    err = cudaMemsetAsync(gi, 0, sizeof(int) * 2 * ROWS * static_cast<size_t>(I), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  gate_up_kernel<ROWS><<<dim3(I / kCols, splits), kThreads, smem1, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wg),
      static_cast<const int8_t*>(wu), static_cast<int*>(gi), static_cast<int*>(ui),
      static_cast<int8_t*>(xq), static_cast<float*>(xs), H, I, krange);
  down_kernel<ROWS><<<dim3(H / kCols, I / bn), kThreads, smem2, st>>>(
      static_cast<const int*>(gi), static_cast<const int*>(ui), static_cast<const float*>(gs),
      static_cast<const float*>(us), static_cast<const float*>(xs),
      static_cast<const int8_t*>(wd), static_cast<float*>(part), static_cast<int8_t*>(hq), H,
      I, bn);
  finish_kernel<<<(ROWS * H + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(ds),
      static_cast<__nv_bfloat16*>(out), ROWS, H, I / bn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, H) bf16; wg, wu (H, I) and wd (I, H) int8 row-major, 16-byte
// aligned; gs, us (I,) and ds (H,) f32. Scratch: gi, ui (B, I) int32 (ui
// right after gi), part (I / bn, B, H) f32. Outputs: xq (B, H) and hq (B, I)
// int8, xs (B,) f32, out (B, H) bf16. 1 <= B <= 8; H and I multiples of
// 128; bn a multiple of 4 that divides I; krange (rows of Wg / Wu per
// block, a multiple of 4) times splits covers H.
extern "C" int palu_mlp_a8(const void* x, const void* wg, const void* gs, const void* wu,
                           const void* us, const void* wd, const void* ds, void* gi, void* ui,
                           void* part, void* xq, void* xs, void* hq, void* out, int B, int H,
                           int I, int bn, int splits, int krange, void* stream) {
  if (B < 1 || B > kMaxRows || H % kCols || I % kCols || bn <= 0 || bn % 4 || I % bn ||
      krange % 4 || static_cast<long long>(splits) * krange < H)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (B) {
#define PALU_A8(R)                                                                           \
  case R:                                                                                  \
    return launch<R>(x, wg, gs, wu, us, wd, ds, gi, ui, part, xq, xs, hq, out, H, I, bn,   \
                     splits, krange, st);
    PALU_A8(1) PALU_A8(2) PALU_A8(3) PALU_A8(4) PALU_A8(5) PALU_A8(6) PALU_A8(7) PALU_A8(8)
#undef PALU_A8
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
