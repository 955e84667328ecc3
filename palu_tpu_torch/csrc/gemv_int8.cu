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
//
// gemv_int8 over a bf16 x and a weight with N contiguous in 16-byte aligned
// rows runs the streaming tensor-core GEMV of gemv_common.cuh (namespace
// ring, kind kInt8) where it is the faster (ops/gemv_int8.use_stream): each
// block issues its weight slice at entry into an 8-stage TMA ring (VT_v's
// 64 KB whole) and reads x while the copies are in flight; a code byte
// becomes one bf16x2 register of its two nibbles (the high one times 16, its
// top bit flipped) against x's row repeated, on mma.sync, so 8 rows cost
// what 1 costs; the K splits of a column block are a cluster of up to 16
// blocks that add in rank order, apply the per-channel scales and write x's
// type: one launch, no partial rows in device memory. What held the split
// pass back at 1 row was a fixed cost per call (6.2 us + bytes / 2.7 TB/s
// over five shapes); the streaming kernel's is no smaller (the first tile
// lands ~3 us after launch, the cluster sums take ~1-2 us), so at 1 row and
// at VT_k the split pass stays.
//
// On the CUDA-core split pass of gemv_common.cuh (16-row lanes x 8 columns
// per thread, codes converted by the exponent trick; a second kernel adds
// the splits in a fixed order and applies the scales): mlp_gemv_int8 (gate
// and up in one split pass, a reduce kernel that applies their scales
// before silu and rounds h to x's type, then the down GEMV), and gemv_int8
// over an f32 x (bf16 tensor cores would round it) or a weight whose rows
// are not 16-byte aligned.
// The tied int8 lm_head is a transposed view (embedding codes (V, H) read as
// (H, V) with K contiguous); copying it would cost more than the product, so
// it has its own kernel: a warp per output column walks K with 4-byte loads
// against x staged in shared memory, and reduces across its lanes.

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

// The streaming GEMV over a bf16 x (B, K): wq int8 codes of a (K, N) weight,
// row k of N contiguous codes at wq + k * ldw (16-byte aligned rows); ws
// (N,) f32; out (B, N) bf16. cluster / grid: the plan
// (ops/gemv_int8.gemv8_plan); x_vec: x's rows may be read 16 bytes at a
// time (K % 8 == 0, 16-byte aligned); tl: null, or grid x ring::kStamps
// timeline stamps.
extern "C" int palu_gemv_int8_stream(const void* x, int B, int K, int N, const void* wq, int ldw,
                                     const void* ws, int cluster, int grid,
                                     int x_vec, void* out, void* tl, void* stream) {
  if (ldw % 16) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m;
  if (!ring::weight_map(&m, wq, K, N, ldw)) return static_cast<int>(cudaErrorInvalidValue);
  ring::Args a = {};
  a.x = x;
  a.ws = static_cast<const float*>(ws);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B;
  a.K = K;
  a.N = N;
  a.units = (K + ring::kTileRows - 1) / ring::kTileRows;
  a.cluster = cluster;
  a.x_vec = x_vec;
  a.tl = static_cast<unsigned long long*>(tl);
  return ring::launch<ring::kInt8>(m, m, a, grid, static_cast<cudaStream_t>(stream));
}

// Shared memory bytes of a streaming block (ring::Layout): kind 0 gate /
// up, 1 down, 2 int8; `units` of its K range. For the plan's mirror test.
extern "C" int palu_gemv_stream_smem(int kind, int B, int units) {
  return ring::Layout(kind, B, units).bytes;
}

// Clusters of `cluster` int8 streaming blocks of `smem` bytes the card runs
// at once (cudaOccupancyMaxActiveClusters), or -1.
extern "C" int palu_gemv8_max_clusters(int cluster, int smem) {
  return ring::max_clusters<ring::kInt8>(cluster, smem);
}
