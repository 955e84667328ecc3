// Shared pieces of the weight-only GEMV kernels (gemv_int4.cu, gemv_int8.cu)
// and of the bf16 GEMV over W (K, N) (gemv_bf16.cu): the CUDA-core split
// pass below, the streaming tensor-core GEMV (namespace ring, further
// down), and the sums of the register-streamed one-launch GEMVs (namespace
// ldg, last).
//
// The split pass serves mlp_gemv_int8 and the inputs the tensor-core
// kernels do not take: an f32 x (tensor cores would round it to bf16;
// these keep f32 products) for gemv_int4, mlp_gemv_int4 and gemv_int8, and
// an int8 weight whose rows are not 16-byte aligned. It is
// bound by integer issue more than by bytes: each weight byte costs ~4
// integer instructions and 2 float subtracts before its multiply-adds.
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

#include <mutex>
#include <unordered_map>

#include "hopper.cuh"

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


// ---------------------------------------------------------------------------
// The streaming GEMV (Hopper): weights through an asynchronous ring onto
// tensor cores, the K splits of a column block summed inside the launch.
// ---------------------------------------------------------------------------
//
// A weight tile is 64 byte rows x 128 byte columns (8 KB): an int4 scale
// group of 128 contraction rows (rows p and p + 64 share a byte), or 64 rows
// of int8 codes. A producer warp copies tiles by TMA (128-byte swizzle) into
// a ring of 8 stages, each guarded by an mbarrier, and the int4 group scales
// (512 bytes) by a bulk copy beside them. Four consumer warps take whole
// tiles in turn (warp w: tiles w, w + 4, ...; with a stage count that is a
// multiple of 4 a warp's next tile reuses a stage it freed itself, so no
// warp waits on a parity two phases ahead), read their rows into registers
// and free the stage before their products, after a proxy fence that orders
// those reads before the TMA that refills the stage (without it a refill
// could land before a read: results that did not repeat from call to call,
// seen on an H100 where one block owns several column blocks, at every ring
// size tried, and wrong results at 4 stages). Each byte becomes one bf16x2
// register in two integer instructions (a byte permute that puts its low
// nibble at bits 0-3 and its high nibble at bits 16-19, and one lop3 that
// masks them and ORs the exponent 0x4300: the bf16 value 128 + nibble) and
// feeds mma.sync m16n8k16: the tile's columns are M, x's rows (1-8, zeros
// past B) are N, so 8 rows cost what one row costs. The K slots of a
// register are the byte's two nibbles, with x's fragment in the same order:
// int4 (x[p], x[p + 64]); int8 (x[p], x[p]) with the high nibble's exponent
// 0x4500 (16 x (128 + nibble)) and its top bit flipped (two's complement
// codes). The offsets are folded out after the product: int4 subtracts
// 136 * sum(x over the group) before the group scale, int8 subtracts
// 2304 * sum(x over the block's rows) once. Output columns are permuted
// within a tile so that one 16-byte shared-memory read of a swizzled row
// feeds eight mmas without bank conflicts: M row r (r < 8) of mma tile j is
// physical column 16 cg(r) + j and row r + 8 is 16 cg(r) + 8 + j, with
// cg(r) = (r >> 1) | ((r & 1) << 2) (the eight lanes of a quarter warp then
// read distinct 16-byte chunks under TMA's chunk ^ (row % 8) swizzle).
//
// The K splits of one 128-column block form a thread-block cluster (1-16
// blocks; over 8 with the non-portable attribute): each block sums its
// warps in a fixed order into shared memory; once every rank has read its
// last tile (a release / acquire cluster barrier), each rank pushes the
// sums of the columns another rank finishes into that rank's ring, and
// after a second barrier every rank adds its columns' rows in rank order,
// so two calls are bit-identical and no f32 partial row goes to device
// memory. A cluster of one may own several column blocks in turn (int8 at a
// large N). The plan (ops/gemv_int8.stream_plan) keeps the grid one wave of
// two blocks per SM within the card's cluster capacity.
//
// What bounds it: one warp per SM sub-partition and role runs ~2,000 cycles
// a tile (576 integer instructions, 64 mmas, waits), and this layout streams
// at ~1.5-2 TB/s whichever kernel reads it (128 bytes of each of 64 rows
// per tile); at 1 row the split pass below, with 8 warps per sub-partition,
// keeps pace, from 2-6 rows (the shape's size) the streaming kernel wins.
//
// Kinds: kGateUp (the int4 MLP's first launch: gate and up tiles of the
// same columns alternate; h = bf16(silu(g) * u) is written as the down
// launch's x fragments), kDown (the int4 down product over h), kInt8
// (y = bf16((x @ codes) * ws)).

namespace ring {

constexpr int kWarps = 4;                     // consumer warps
constexpr int kThreads = (kWarps + 1) * 32;   // + one producer warp
constexpr int kTileRows = 64;                 // byte rows of a weight tile
constexpr int kTileCols = 128;                // byte columns = output columns
constexpr int kTileBytes = kTileRows * kTileCols;
constexpr int kScaleBytes = kTileCols * 4;    // int4: f32 scales of a group's columns
constexpr int kStages = 8;                    // ring stages: a multiple of kWarps
constexpr int kMaxCluster = 16;
constexpr int kSmemBudget = 112 * 1024;       // dynamic bytes: two blocks per SM

enum Kind { kGateUp = 0, kDown = 1, kInt8 = 2 };

// Shared memory of a block, offsets from a 1024-byte aligned base. `units`
// are the block's int4 groups or int8 64-row tiles along K. Mirrored by
// ops/gemv_int8.stream_smem.
struct Layout {
  int scales, xs, xsum, loc, recv, wss, hb, bars, bytes;
  __host__ __device__ Layout(int kind, int B, int units) {
    int o = kStages * kTileBytes;  // the ring
    scales = o;
    if (kind != kInt8) o += kStages * kScaleBytes;
    xs = o;  // x fragments: int4 (b, group, 64 words); int8 (b, tile, 64 bf16)
    o += (kind == kInt8 ? 128 : 256) * B * units;
    xsum = o;  // sums of x: int4 (group, 8 rows); int8 (8 rows)
    o += (kind == kInt8 ? 1 : units) * 32;
    loc = o;  // the block's f32 sums (set, b, column): warps 0 + 2, 1 + 3
    o += 2 * B * kTileCols * 4;
    // cluster > 1: the ranks' sums of this rank's columns (rank, set, b,
    // column), over the ring: no rank pushes until every rank has read its
    // last tile (2 * 8 * 16 * 8 * 4 bytes at most, within 8 stages)
    recv = 0;
    wss = o;  // kInt8: the column block's scales
    if (kind == kInt8) o += kTileCols * 4;
    hb = o;  // kGateUp: h as bf16 (b, column)
    if (kind == kGateUp) o += B * kTileCols * 2;
    bars = o;  // full[kStages], empty[kStages], x
    o += (2 * kStages + 1) * 8;
    bytes = o + 1024;  // + alignment slack
  }
};

struct Args {
  const void* x;           // kGateUp, kInt8: x (B, K) bf16; kDown: h fragments (B, G, 64) u32
  const float* s0;         // int4: scales (G, N) of the first weight
  const float* s1;         // kGateUp: scales of up
  const float* ws;         // kInt8: (N,) per-column scales
  uint32_t* h_out;         // kGateUp: h fragments (B, N / 128, 64)
  __nv_bfloat16* out;      // kDown, kInt8: (B, N)
  int B, K, N;             // rows of x, contraction length, output columns
  int units;               // int4 groups or int8 64-row tiles along K
  int cluster;
  int x_vec;               // kInt8: rows of x may be read 16 bytes at a time
  unsigned long long* tl;  // timeline (tools/gemv_ab --timeline): kStamps per block, or null
};

// Timeline stamps of a block (%globaltimer ns, except the two sums of
// warp 0's clock64 cycles): start, first and last tile issued, x staged,
// first tile arrived, last tile computed, sums begin, end, cycles waiting
// for tiles, cycles computing them. Only the kernel's kTimeline
// instantiation (launched when Args::tl is given) reads the clocks.
constexpr int kStamps = 10;

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Position of K slot pair p (0..63) of a tile in x's fragment order: thread
// (g, t) of a warp reads its 16 words (k-step s, half) at 16 t + 2 s + half.
__host__ __device__ __forceinline__ int frag_index(int p) {
  return 16 * (p & 3) + 2 * (p >> 3) + ((p >> 2) & 1);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Byte i of w as a bf16x2 register: its low nibble at bits 0-3, its high
// nibble at bits 16-19, then lop3 f = copy ? t ^ bits : bits (0x6A) with copy
// = 0x000F000F: the nibbles kept, the constant bits ORed, and a nibble bit
// that is also set in kBits flipped.
template <uint32_t kBits>
__device__ __forceinline__ uint32_t nibbles(uint32_t w, uint32_t w4, int i) {
  const uint32_t t = __byte_perm(w, w4, i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12));
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;" : "=r"(d) : "r"(t), "r"(0x000F000Fu), "r"(kBits));
  return d;
}

// Thread (g, t)'s swizzled 16-byte rows of a tile's eight k-steps: rows
// 8 s + t and 8 s + 4 + t at chunk cg(g) ^ (row % 8).
__device__ __forceinline__ void load_rows(const uint8_t* tile, int g, int t, uint4 (&q)[16]) {
  const int cg = (g >> 1) | ((g & 1) << 2);
  const uint8_t* r0p = tile + t * kTileCols + ((cg ^ t) << 4);
  const uint8_t* r1p = tile + (t + 4) * kTileCols + ((cg ^ (t + 4)) << 4);
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    q[2 * s] = *reinterpret_cast<const uint4*>(r0p + s * 8 * kTileCols);
    q[2 * s + 1] = *reinterpret_cast<const uint4*>(r1p + s * 8 * kTileCols);
  }
}

// acc[j] += the eight k-steps of rows q (load_rows) times x's fragment
// words xw (two per k-step).
template <bool kInt8>
__device__ __forceinline__ void rows_mma(const uint4 (&q)[16], const uint32_t (&xw)[16],
                                         float (&acc)[8][4]) {
  constexpr uint32_t kBits = kInt8 ? 0x45084300u : 0x43004300u;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const uint4 r0 = q[2 * s], r1 = q[2 * s + 1];
    const uint32_t q0[4] = {r0.x, r0.y, r0.z, r0.w}, q1[4] = {r1.x, r1.y, r1.z, r1.w};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t wa = q0[h], wb = q0[2 + h], wc = q1[h], wd = q1[2 + h];
      const uint32_t wa4 = wa >> 4, wb4 = wb >> 4, wc4 = wc >> 4, wd4 = wd >> 4;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mma_bf16(acc[4 * h + i], nibbles<kBits>(wa, wa4, i), nibbles<kBits>(wb, wb4, i),
                 nibbles<kBits>(wc, wc4, i), nibbles<kBits>(wd, wd4, i), xw[2 * s],
                 xw[2 * s + 1]);
    }
  }
}

// A warp's accumulators into the block's sums dst[(n, column)], n < B:
// stored less an offset per row (warps 0 and 1), or added (warps 2 and 3).
__device__ __forceinline__ void put_acc(const float (&acc)[8][4], float* dst, int B, int g,
                                        int t, bool add, float off0, float off1) {
  const int cg = (g >> 1) | ((g & 1) << 2);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int n = 2 * t + (e & 1);
    if (n >= B) continue;
    float* row = dst + n * kTileCols + 16 * cg + 8 * (e >> 1);
    const float off = (e & 1) ? off1 : off0;
#pragma unroll
    for (int j = 0; j < 8; ++j) row[j] = add ? row[j] + acc[j][e] : acc[j][e] - off;
  }
}

// The ranks of a cluster of C finish column pairs (p, p + 64): rank r the
// pairs [pair_start(r), pair_start(r + 1)), its column k of them at
// owned_col(k, pair_start(r), pairs).
__device__ __forceinline__ int pair_start(int r, int C) { return r * 64 / C; }

__device__ __forceinline__ int owned_col(int k, int q0, int half) {
  return k < half ? q0 + k : 64 + q0 + k - half;
}

// The rank that finishes pair p.
__device__ __forceinline__ int pair_owner(int p, int C) {
  const int r = p * C / 64;
  return pair_start(r + 1, C) <= p ? r + 1 : r;
}

template <int KIND, bool kTimeline>
__global__ void __launch_bounds__(kThreads, 2)
stream_kernel(const __grid_constant__ CUtensorMap map0, const __grid_constant__ CUtensorMap map1,
              const Args a) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const int C = a.cluster, S = kStages, B = a.B;
  const Layout L(KIND, B, (a.units + C - 1) / C);
  const int rank = static_cast<int>(cluster_rank());
  const int first_cb = blockIdx.x / C, ncl = gridDim.x / C;
  const int col_blocks = a.N / kTileCols;
  const int u0 = rank * a.units / C, nu = (rank + 1) * a.units / C - u0;
  const int tiles_cb = KIND == kGateUp ? 2 * nu : nu;  // tiles per column block
  const int ncb = (col_blocks - first_cb + ncl - 1) / ncl;
  const uint32_t full = base + L.bars, empty = full + 8 * S, xbar = empty + 8 * S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);
    }
    mbar_init(xbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  unsigned long long* tl = kTimeline ? a.tl + blockIdx.x * kStamps : nullptr;
  if (kTimeline && tid == 0) tl[0] = globaltimer();

  if (warp == kWarps) {
    // producer: lane 0 keeps the ring full
    if (lane == 0) {
      const uint32_t xbytes = nu * 256;  // int4: a row's fragments over the block's groups
      if (KIND == kGateUp) {             // x's rows, raw
        mbar_expect_tx(xbar, B * xbytes);
        for (int b = 0; b < B; ++b)
          bulk_load(base + L.xs + b * xbytes,
                    static_cast<const __nv_bfloat16*>(a.x) + static_cast<size_t>(b) * a.K +
                        u0 * 128,
                    xbytes, xbar);
      }
      if (KIND == kDown) {  // h's fragments over the block's groups
        mbar_expect_tx(xbar, B * xbytes);
        for (int b = 0; b < B; ++b)
          bulk_load(base + L.xs + b * xbytes,
                    static_cast<const uint32_t*>(a.x) +
                        (static_cast<size_t>(b) * a.units + u0) * 64,
                    xbytes, xbar);
      }
      const int n = tiles_cb * ncb;
      for (int i = 0; i < n; ++i) {
        const int s = i % S, round = i / S;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        const int j = i / tiles_cb, lt = i - j * tiles_cb;
        const int cb = first_cb + j * ncl;
        const int unit = u0 + (KIND == kGateUp ? lt >> 1 : lt);
        const bool second = KIND == kGateUp && (lt & 1);
        const uint32_t fb = full + 8 * s;
        mbar_expect_tx(fb, kTileBytes + (KIND == kInt8 ? 0 : kScaleBytes));
        tma_load_2d(base + s * kTileBytes, second ? &map1 : &map0, fb, cb * kTileCols,
                    unit * kTileRows);
        if (KIND != kInt8)
          bulk_load(base + L.scales + s * kScaleBytes,
                    (second ? a.s1 : a.s0) + static_cast<size_t>(unit) * a.N + cb * kTileCols,
                    kScaleBytes, fb);
        if (kTimeline && (i == 0 || i == n - 1)) tl[i == 0 ? 1 : 2] = globaltimer();
      }
    }
    __syncwarp();
    if (C > 1) {  // the consumers' two cluster barriers (one column block)
      cluster_arrive();
      cluster_wait();
      cluster_sync();
    }
    return;
  }

  // consumers
  const int g = lane >> 2, t = lane & 3;
  float* xsum = reinterpret_cast<float*>(sm + L.xsum);
  float* loc = reinterpret_cast<float*>(sm + L.loc);
  if (KIND != kInt8) {
    // int4: x's fragments and each group's sum of x, one (row, group) per
    // warp task. kGateUp turns raw x into fragment order in place; kDown's h
    // came in fragment order.
    mbar_wait(xbar, 0);
    for (int task = warp; task < B * nu; task += kWarps) {
      const int b = task / nu, gl = task - b * nu;
      uint32_t* xw = reinterpret_cast<uint32_t*>(sm + L.xs) + task * 64;
      float v0, v1, v2, v3;
      if (KIND == kGateUp) {
        const __nv_bfloat16* xr = reinterpret_cast<const __nv_bfloat16*>(xw);
        const __nv_bfloat16 r0 = xr[lane], r1 = xr[lane + 32], r2 = xr[lane + 64],
                            r3 = xr[lane + 96];
        __syncwarp();
        xw[frag_index(lane)] = static_cast<uint32_t>(__bfloat16_as_ushort(r0)) |
                               static_cast<uint32_t>(__bfloat16_as_ushort(r2)) << 16;
        xw[frag_index(lane + 32)] = static_cast<uint32_t>(__bfloat16_as_ushort(r1)) |
                                    static_cast<uint32_t>(__bfloat16_as_ushort(r3)) << 16;
        v0 = __bfloat162float(r0);
        v1 = __bfloat162float(r1);
        v2 = __bfloat162float(r2);
        v3 = __bfloat162float(r3);
      } else {
        const uint32_t w0 = xw[lane], w1 = xw[lane + 32];
        v0 = __uint_as_float(w0 << 16);
        v1 = __uint_as_float(w0 & 0xFFFF0000u);
        v2 = __uint_as_float(w1 << 16);
        v3 = __uint_as_float(w1 & 0xFFFF0000u);
      }
      float sum = (v0 + v1) + (v2 + v3);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) xsum[gl * 8 + b] = sum;
    }
    for (int i = tid; i < nu * 8; i += kWarps * 32)
      if ((i & 7) >= B) xsum[i] = 0.0f;
  } else {
    // x's rows [u0 * 64, (u0 + nu) * 64) as bf16 in fragment order (zeros
    // past K), and each row's sum: per-thread runs in loc, then a fixed-order
    // sum. Eight chunks of 8 rows are loaded before any is stored.
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(sm + L.xs);
    for (int i = tid; i < B * kTileCols; i += kWarps * 32) loc[i] = 0.0f;
    named_sync(1, kWarps * 32);
    const int chunks = nu * 8;  // of 8 rows
    int cur = -1;
    float run = 0.0f;
    for (int c0 = tid; c0 < B * chunks; c0 += 8 * kWarps * 32) {
      uint4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int c = c0 + u * kWarps * 32;
        const int b = c / chunks, k0 = u0 * kTileRows + (c - b * chunks) * 8;
        const __nv_bfloat16* src = x + static_cast<size_t>(b) * a.K + k0;
        if (c >= B * chunks) {
          v[u] = make_uint4(0u, 0u, 0u, 0u);
        } else if (a.x_vec && k0 + 8 <= a.K) {
          v[u] = *reinterpret_cast<const uint4*>(src);
        } else {
          __align__(16) __nv_bfloat16 e8[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            e8[e] = k0 + e < a.K ? src[e] : __float2bfloat16_rn(0.0f);
          v[u] = *reinterpret_cast<const uint4*>(e8);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int c = c0 + u * kWarps * 32;
        if (c >= B * chunks) break;
        const int b = c / chunks, ck = c - b * chunks;
        if (b != cur) {
          if (cur >= 0) loc[cur * kTileCols + tid] = run;
          cur = b;
          run = 0.0f;
        }
        const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&v[u]);
        __nv_bfloat16* dst = xs + (b * nu + ck / 8) * kTileRows;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          dst[frag_index((ck & 7) * 8 + e)] = e8[e];
          run += __bfloat162float(e8[e]);
        }
      }
    }
    if (cur >= 0) loc[cur * kTileCols + tid] = run;
    named_sync(1, kWarps * 32);
    for (int b = warp; b < 8; b += kWarps) {
      float sum = 0.0f;
      if (b < B) {
        const float* r = loc + b * kTileCols;
        sum = (r[lane] + r[lane + 32]) + (r[lane + 64] + r[lane + 96]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      }
      if (lane == 0) xsum[b] = sum;
    }
  }
  named_sync(1, kWarps * 32);
  if (kTimeline && tid == 0) tl[3] = globaltimer();
  long long wait_cycles = 0, mma_cycles = 0;  // kTimeline: warp 0's clock64 cycles

  const int cg = (g >> 1) | ((g & 1) << 2);
  // this rank finishes pairs (p, p + 64), p in [q0, q0 + half); per_max
  // columns per rank make a receive row
  const int q0 = pair_start(rank, C), half = pair_start(rank + 1, C) - q0, per = 2 * half;
  const int per_max = 2 * ((64 + C - 1) / C);
  float* wss = reinterpret_cast<float*>(sm + L.wss);
  for (int j = 0; j < ncb; ++j) {
    const int cb = first_cb + j * ncl;
    float acc[8][4];
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][e] = 0.0f;
    // int8: the column block's scales, read while the tiles stream (used
    // after the barriers below)
    if (KIND == kInt8) wss[tid] = a.ws[cb * kTileCols + tid];
    // whole tiles per warp (int4: a group's scale multiplies its sum): warp
    // w takes the tiles i = w mod 4 of the block's whole sequence, whatever
    // the column block, so its next tile is always on a stage it freed; it
    // reads its rows into registers and frees the stage before its products
    const int lt0 = ((warp - j * tiles_cb) % kWarps + kWarps) % kWarps;
    for (int lt = lt0; lt < tiles_cb; lt += kWarps) {
      const int i = j * tiles_cb + lt;
      const int s = i % S;
      const long long c0 = kTimeline ? clock64() : 0;
      mbar_wait(full + 8 * s, (i / S) & 1);
      const long long c1 = kTimeline ? clock64() : 0;
      if (kTimeline && tid == 0 && i == 0) tl[4] = globaltimer();
      const uint8_t* tile = sm + s * kTileBytes;
      const int gl = KIND == kGateUp ? lt >> 1 : lt;
      if (KIND == kInt8) {
        uint4 q[16];
        load_rows(tile, g, t, q);
        fence_async_shared();  // the reads above before the TMA that refills the stage
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
        uint32_t xw[16];
        if (g < B) {
          const uint4* src =
              reinterpret_cast<const uint4*>(sm + L.xs + ((g * nu + gl) * 64 + 16 * t) * 2);
          const uint4 v0 = src[0], v1 = src[1];
          const uint32_t pr[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            xw[2 * k] = __byte_perm(pr[k], 0, 0x1010);
            xw[2 * k + 1] = __byte_perm(pr[k], 0, 0x3232);
          }
        } else {
#pragma unroll
          for (int k = 0; k < 16; ++k) xw[k] = 0u;
        }
        rows_mma<true>(q, xw, acc);
      } else {
        uint4 q[16];
        load_rows(tile, g, t, q);
        const float4* sc =
            reinterpret_cast<const float4*>(sm + L.scales + s * kScaleBytes) + 4 * cg;
        const float4 s0 = sc[0], s1 = sc[1], s2 = sc[2], s3 = sc[3];
        fence_async_shared();
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
        uint32_t xw[16];
        if (g < B) {
          const uint4* src =
              reinterpret_cast<const uint4*>(sm + L.xs + ((g * nu + gl) * 64 + 16 * t) * 4);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const uint4 v = src[k];
            xw[4 * k] = v.x;
            xw[4 * k + 1] = v.y;
            xw[4 * k + 2] = v.z;
            xw[4 * k + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int k = 0; k < 16; ++k) xw[k] = 0u;
        }
        float p[8][4];
#pragma unroll
        for (int m = 0; m < 8; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[m][e] = 0.0f;
        rows_mma<false>(q, xw, p);
        const float slo[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        const float shi[8] = {s2.x, s2.y, s2.z, s2.w, s3.x, s3.y, s3.z, s3.w};
        const float2 xg = *reinterpret_cast<const float2*>(xsum + gl * 8 + 2 * t);
        const float o0 = 136.0f * xg.x, o1 = 136.0f * xg.y;
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          acc[m][0] = fmaf(p[m][0] - o0, slo[m], acc[m][0]);
          acc[m][1] = fmaf(p[m][1] - o1, slo[m], acc[m][1]);
          acc[m][2] = fmaf(p[m][2] - o0, shi[m], acc[m][2]);
          acc[m][3] = fmaf(p[m][3] - o1, shi[m], acc[m][3]);
        }
      }
      if (kTimeline) {
        wait_cycles += c1 - c0;
        mma_cycles += clock64() - c1;
      }
    }
    if (kTimeline && tid == 0) {
      tl[5] = globaltimer();
      tl[8] = wait_cycles;
      tl[9] = mma_cycles;
    }
    // this block has read its last tile: the other ranks may push into its
    // ring once every rank has arrived
    if (C > 1) cluster_arrive();

    // the block's sums in two sets: warps 0 + 2 and 1 + 3 (kGateUp: gate and
    // up); int8 subtracts its offset once, in warp 0's store
    {
      float* dst = loc + (warp & 1) * B * kTileCols;
      const bool first = warp == 0 && KIND == kInt8;
      const float off0 = first ? 2304.0f * xsum[2 * t] : 0.0f;
      const float off1 = first ? 2304.0f * xsum[2 * t + 1] : 0.0f;
      if (warp < 2) put_acc(acc, dst, B, g, t, false, off0, off1);
      named_sync(1, kWarps * 32);
      if (warp >= 2) put_acc(acc, dst, B, g, t, true, 0.0f, 0.0f);
    }
    named_sync(1, kWarps * 32);
    // push the sums of the columns another rank finishes into that rank's
    // ring (its row of this rank's slot), then one cluster barrier; every
    // rank then adds its columns' slots in rank order
    if (C > 1) {
      cluster_wait();  // every rank has read its tiles: the rings take the pushes
      for (int idx = tid; idx < 2 * B * kTileCols; idx += kWarps * 32) {
        const int qn = idx / kTileCols, c = idx - qn * kTileCols;  // (set, b), column
        const int p = c & 63, r = pair_owner(p, C);
        const int r0 = pair_start(r, C), pj = p - r0;
        const int k = c < 64 ? pj : pair_start(r + 1, C) - r0 + pj;
        st_cluster_f32(base + L.recv + (((rank * 2 * B) + qn) * per_max + k) * 4, r, loc[idx]);
      }
      cluster_sync();
    }
    if (kTimeline && tid == 0) tl[6] = globaltimer();

    const float* recv = reinterpret_cast<const float*>(sm + L.recv);
    __nv_bfloat16* hb = reinterpret_cast<__nv_bfloat16*>(sm + L.hb);
    for (int idx = tid; idx < B * per; idx += kWarps * 32) {
      const int n = idx / per, k = idx - n * per;
      const int c = owned_col(k, q0, half);
      float v0, v1;
      if (C == 1) {
        v0 = loc[n * kTileCols + c];
        v1 = loc[(B + n) * kTileCols + c];
      } else {
        v0 = recv[(0 * B + n) * per_max + k];
        v1 = recv[(1 * B + n) * per_max + k];
        for (int r = 1; r < C; ++r) {
          v0 += recv[((r * 2) * B + n) * per_max + k];
          v1 += recv[((r * 2 + 1) * B + n) * per_max + k];
        }
      }
      const int col = cb * kTileCols + c;
      if (KIND == kGateUp) {
        const float silu = v0 * (1.0f / (1.0f + expf(-v0)));
        hb[n * kTileCols + c] = __float2bfloat16_rn(silu * v1);
      } else {
        const float y = v0 + v1;
        a.out[static_cast<size_t>(n) * a.N + col] =
            __float2bfloat16_rn(KIND == kInt8 ? y * wss[c] : y);
      }
    }
    if (KIND == kGateUp) {
      named_sync(1, kWarps * 32);
      for (int idx = tid; idx < B * half; idx += kWarps * 32) {
        const int n = idx / half, p = q0 + idx - n * half;
        a.h_out[(static_cast<size_t>(n) * col_blocks + cb) * 64 + frag_index(p)] =
            static_cast<uint32_t>(__bfloat16_as_ushort(hb[n * kTileCols + p])) |
            static_cast<uint32_t>(__bfloat16_as_ushort(hb[n * kTileCols + p + 64])) << 16;
      }
    }
    if (C == 1) named_sync(1, kWarps * 32);  // loc is reused by the next column block
  }
  if (kTimeline && tid == 0) tl[7] = globaltimer();
}

// ---- host side ----

// A weight's tensor map, encoded once per (pointer, shape, row stride) and
// cached (the decode step is host-bound; a map depends on nothing else):
// (rows, cols) bytes with rows `ld` bytes apart, boxes of 64 rows x 128
// bytes, 128-byte swizzle.
inline bool weight_map(CUtensorMap* out, const void* ptr, uint64_t rows, uint64_t cols,
                       uint64_t ld) {
  struct Key {
    const void* p;
    uint64_t rows, cols, ld;
    bool operator==(const Key& o) const {
      return p == o.p && rows == o.rows && cols == o.cols && ld == o.ld;
    }
  };
  struct Hash {
    size_t operator()(const Key& k) const {
      return std::hash<const void*>()(k.p) ^ (k.rows * 0x9E3779B97F4A7C15ull) ^
             (k.cols << 20) ^ (k.ld << 40);
    }
  };
  static std::mutex mu;
  static std::unordered_map<Key, CUtensorMap, Hash> cache;
  const Key key{ptr, rows, cols, ld};
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return true;
  }
  if (cache.size() >= 4096) cache.clear();
  if (!hopper::make_map_2d_u8(out, ptr, cols, rows, ld, kTileCols, kTileRows,
                              CU_TENSOR_MAP_SWIZZLE_128B))
    return false;
  cache.emplace(key, *out);
  return true;
}

// The kernel's attributes, set once: two blocks of kSmemBudget per SM,
// clusters of up to 16.
template <int KIND, bool kTimeline>
inline cudaError_t kernel_attributes() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(stream_kernel<KIND, kTimeline>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBudget);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(stream_kernel<KIND, kTimeline>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  return err;
}

// Clusters of `cluster` blocks of `smem` bytes that the card runs at once.
template <int KIND>
inline int max_clusters(int cluster, int smem) {
  if (kernel_attributes<KIND, false>() != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, stream_kernel<KIND, false>, &cfg) == cudaSuccess
             ? n
             : -1;
}

// Launch `grid` blocks in clusters of a.cluster (the instantiation with
// timeline stamps when a.tl is given).
template <int KIND>
inline int launch(const CUtensorMap& m0, const CUtensorMap& m1, const Args& a, int grid,
                  cudaStream_t st) {
  const cudaError_t attr_err = a.tl != nullptr ? kernel_attributes<KIND, true>()
                                               : kernel_attributes<KIND, false>();
  if (attr_err != cudaSuccess) return static_cast<int>(attr_err);
  if (a.cluster < 1 || a.cluster > kMaxCluster || grid <= 0 || grid % a.cluster || a.B < 1 ||
      a.B > 8 ||
      a.N % kTileCols || a.units < a.cluster ||
      grid / a.cluster > a.N / kTileCols ||  // a cluster with no column block
      (a.cluster > 1 && grid / a.cluster < a.N / kTileCols))  // clusters own one each
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L(KIND, a.B, (a.units + a.cluster - 1) / a.cluster);
  if (L.bytes > kSmemBudget) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(a.tl != nullptr
                              ? cudaLaunchKernelEx(&cfg, stream_kernel<KIND, true>, m0, m1, a)
                              : cudaLaunchKernelEx(&cfg, stream_kernel<KIND, false>, m0, m1, a));
}

}  // namespace ring

// ---------------------------------------------------------------------------
// The register-streamed GEMVs (Hopper): gemv_int4 over a bf16 x
// (gemv_int4.cu) and the probe's gemv_bf16 over W (K, N) (gemv_bf16.cu).
// ---------------------------------------------------------------------------
//
// One launch, no shared-memory ring: each warp loads its weight rows 16
// bytes a lane straight into registers (ld.global.nc, L1 not allocated),
// turns them into mma.sync fragments with byte permutes, and issues the
// loads of its next tile as it consumes the current one, so that ~8 KB a
// warp stay in flight. On an H100 80GB HBM3 (700 W) plain 16-byte loads
// streamed a 33.5 MB matrix at 2.2-2.5 TB/s against ~2 TB/s for TMA, bulk
// copies or cp.async (tools/gemv_ab.py --only=floor).
//
// A column block (int4 128 output columns, bf16 64) is the unit of the
// sums. Its contraction is split over the 8 warps of each of the `cluster`
// blocks of a thread-block cluster: warp w of rank r is split
// wi = 8 r + w of W = 8 * cluster, and takes the contraction units [wi * U
// / W, (wi + 1) * U / W). Each warp keeps f32 sums of its units for the
// block's columns and x's rows (x's rows are mma's N: 8 rows cost what one
// costs); the block adds its warps in warp order in shared memory, the
// ranks push the sums of the columns another rank finishes into that
// rank's shared memory (distributed shared memory), and after a cluster
// barrier each rank adds its columns' rows in rank order and writes them
// rounded to bf16. Two calls are bit-identical; no f32 partial row goes to
// device memory and no float atomic is used. A cluster owns column blocks
// cid, cid + ncl, ... (cid = blockIdx / cluster, ncl clusters); the plan
// (ops/gemv_int8.ldg_plan) keeps the grid in one wave.

namespace ldg {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxCluster = 8;  // portable cluster sizes: 1, 2, 4, 8
constexpr int kPad = 4;         // floats added to a row of the warps' sums

// Shared memory of a block: the warps' sums red[warp][row][cols + kPad]
// and, in a cluster of more than one, two receive buffers (by the column
// block's parity) [source rank][row][cols / cluster]. Mirrored by
// ops/gemv_int8.ldg_smem.
__host__ __device__ inline int smem_bytes(int cols, int B, int cluster) {
  return (kWarps * B * (cols + kPad) + (cluster > 1 ? 2 * B * cols : 0)) * 4;
}

// 16 (or 4) bytes of a weight (read once: no L1 line) and 16 (or 4) of x
// (read by every warp that shares its contraction rows: cached).
__device__ __forceinline__ uint4 ld_w(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t ld_w4(const void* p) {
  uint32_t v;
  asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t ld_x4(const void* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ uint4 ld_x(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// 16 bytes from global into shared memory, asynchronously (cp.async), and
// the wait for this thread's copies.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\ncp.async.commit_group;" ::"r"(
                   hopper::smem_u32(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Timeline stamps of a block (%globaltimer ns; tools/gemv_ab.py
// --timeline), written by thread 0 of the kernels' kTimeline
// instantiation: start, warp 0's first tile data in registers, warp 0's
// last tile computed, every warp's sums in shared memory (the last column
// block), the cluster's pushes received, end; then warp 0's tiles (its warp 0's, plus 65536 times its cluster rank) and SM.
constexpr int kStamps = 8;

__device__ __forceinline__ unsigned smid() {
  unsigned r;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(r));
  return r;
}

// %globaltimer once `dep` is in a register (a loaded value's arrival).
__device__ __forceinline__ unsigned long long stamp(uint32_t dep) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) : "r"(dep));
  return t;
}

// The block's sums of one column block [col0, col0 + COLS) of out (B, N):
// red holds each warp's sums (rows n < B), written by the caller after a
// __syncthreads; recv is this block's receive buffers (C > 1), par the
// column block's parity, first whether it is the cluster's first column
// block (the wait of the barrier the kernel arrived at on entry: every
// block of the cluster runs before any pushes into its shared memory).
// Columns at or past N are not written.
template <int COLS>
__device__ __forceinline__ void finish(const float* red, float* recv, int B, int C, int rank,
                                       int par, bool first, int col0, int N,
                                       __nv_bfloat16* __restrict__ out,
                                       unsigned long long* tl) {
  constexpr int RS = COLS + kPad;
  __syncthreads();  // every warp's sums are in red
  const int tid = threadIdx.x;
  if (tl != nullptr && tid == 0) tl[3] = tl[4] = stamp(0u);
  if (C == 1) {
    for (int idx = tid; idx < B * COLS; idx += kThreads) {
      const int n = idx / COLS, c = idx - n * COLS;
      float v = red[n * RS + c];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += red[(w * B + n) * RS + c];
      if (col0 + c < N) out[static_cast<size_t>(n) * N + col0 + c] = __float2bfloat16_rn(v);
    }
    return;
  }
  const int per = COLS / C;
  if (first) hopper::cluster_wait();
  const uint32_t rbase = hopper::smem_u32(recv) + par * (B * COLS * 4);
  for (int idx = tid; idx < B * COLS; idx += kThreads) {
    const int n = idx / COLS, c = idx - n * COLS;
    float v = red[n * RS + c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += red[(w * B + n) * RS + c];
    const int owner = c / per;
    hopper::st_cluster_f32(rbase + ((rank * B + n) * per + c - owner * per) * 4, owner, v);
  }
  hopper::cluster_arrive();  // release: the pushes above
  hopper::cluster_wait();    // acquire: every rank's pushes into this block
  if (tl != nullptr && tid == 0) tl[4] = stamp(0u);
  const float* mine = recv + par * B * COLS;
  for (int idx = tid; idx < B * per; idx += kThreads) {
    const int n = idx / per, k = idx - n * per;
    float v = mine[n * per + k];
    for (int r = 1; r < C; ++r) v += mine[(r * B + n) * per + k];
    const int col = col0 + rank * per + k;
    if (col < N) out[static_cast<size_t>(n) * N + col] = __float2bfloat16_rn(v);
  }
}

// Launch `grid` blocks of kernel(a) in clusters of `cluster` (1: no
// cluster attribute) with `smem` bytes of dynamic shared memory.
template <typename A>
inline int launch(void (*kernel)(A), const A& a, int cluster, int grid, int smem,
                  cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, a));
}

// Clusters of `cluster` blocks of kernel (smem bytes each) that the card
// runs at once, or -1.
template <typename A>
inline int max_clusters(void (*kernel)(A), int cluster, int smem) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess ? n : -1;
}

// A launch the kernel does not take: a cluster size other than 1, 2, 4
// or 8, a grid that is not whole clusters or has a cluster with no column
// block, rows outside 1..8.
inline bool bad_launch(int cluster, int grid, int col_blocks, int B) {
  return !(cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) || grid <= 0 ||
         grid % cluster || grid / cluster > col_blocks || B < 1 || B > 8;
}

}  // namespace ldg

}  // namespace gemv
