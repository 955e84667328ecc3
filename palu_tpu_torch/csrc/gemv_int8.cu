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
// mlp_gemv_int8 over a bf16 x (the engine's path at weight_bits 8) runs
// two launches of mlp8_ldg, on the register-streamed design of
// gemv_common.cuh (namespace ldg) that gemv_int4 uses:
// 1. gate and up: a block owns the same 128 columns of both and a K range
//    of whole 64-row tiles; its warps take the gate and the up tile of each
//    of their tiles in turn, the K ranges of a column block are the blocks
//    of a cluster, summed in rank order inside the launch, and the rank that
//    finishes a column applies the gate / up scales before silu and writes
//    h = bf16(silu(g) * u) (B, I) once;
// 2. down: the same kernel over h (K = I) with one weight; the down scale
//    is applied after the whole sum, as the TPU kernel does.
// No f32 partial row goes to device memory. Lane (g, t) of a warp loads 16
// bytes (columns 16 g .. 16 g + 15) of the tile rows 16 t .. 16 t + 15
// straight into registers, two rows a k-step, four k-steps ahead of the
// products; each code byte becomes one bf16x2 register in two integer
// instructions (ring::nibbles with the exponents 0x4300 / 0x4500 and the top
// bit flipped: 128 + low nibble, 16 x (128 + high nibble + 8), together
// code + 2304) and feeds mma.sync m16n8k16 with the columns as M and x's
// rows as N (x's value repeated in both halves of its register), so 8 rows
// cost what 1 costs; the offset is folded out per tile as 2304 * sum(x),
// the sum taken by one more mma against (1, 0). The plan (ops/gemv_int8.
// mlp8_plan) picks the block's warps (16, one block an SM, gate / up
// only; or 8, two) and the largest cluster size (1-8: a rank finishes
// columns [r * 128 / C, (r + 1) * 128 / C)) with which every column block
// has its own cluster in one wave within the card's capacity. A launch took
// about what its busiest SM's bytes take at the rate 16 warps stream with
// 4 KB each in flight (~25 GB/s an SM), and a second round of column blocks
// or an uneven split of a cluster's tiles added a barrier's wait for the
// slowest rank: on an H100 80GB HBM3 (700 W; tools/gemv_ab.py
// --only=mlp8plans) Llama-2-7B's gate / up (86 column blocks) took 39.8 us
// in 16-warp blocks without a cluster (the tile pattern's floor for its
// bytes: 2.26 TB/s, --only=floor), 43.2-43.6 in clusters of 2 or 4 of
// 8-warp blocks, 46.3 in 8-warp blocks alone and 46-57 in clusters of 3,
// 5, 6, 7 or 8 owning two or three column blocks; its down product (32
// column blocks) 23.3 us in clusters of 7 (20.0 for the bytes). A deeper
// register ring spilled; a ring of a whole tile at one 8-warp block an SM,
// blocks of 4 warps, L2 prefetches of the next tiles and the L2::256B hint
// ran slower (PERF.md §6).
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
// the splits in a fixed order and applies the scales): mlp_gemv_int8 over
// an f32 x (bf16 tensor cores would round it; gate and up in one split
// pass, a reduce kernel that applies their scales before silu and rounds h
// to x's type, then the down GEMV), and gemv_int8 over an f32 x or a weight
// whose rows are not 16-byte aligned.
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


// ---- mlp_gemv_int8 over a bf16 x: two launches of mlp8_ldg (see the note above) ----

constexpr int kCols8 = 128;                // output columns of a column block
constexpr int kRows8 = 64;                 // contraction rows of a tile
constexpr int kMaxCluster8 = 8;
constexpr uint32_t kOnesLo = 0x00003F80u;  // bf16x2 (1, 0)
constexpr uint32_t kBits8 = 0x45084300u;   // int8: 128 + low nibble, 16 (128 + high ^ 8)

struct Args8 {
  const __nv_bfloat16* x;  // (B, K), 4-byte aligned rows
  const int8_t* w0;        // (K, N), N contiguous, 16-byte aligned: gate, or down
  const int8_t* w1;        // SETS 2: up
  const float* s0;         // (N,) scales of w0
  const float* s1;         // SETS 2: scales of w1
  __nv_bfloat16* out;      // (B, N): h, or the MLP's output
  int B, K, N, cluster;
};

// Shared memory of a block of `warps` warps: the warps' sums
// red[set][warp][row][128 + pad] and, in a cluster of C > 1, two receive
// buffers (by the column block's parity) [set][source rank][row][ceil(128 /
// C)]. Mirrored by ops/gemv_int8.mlp8_smem.
__host__ __device__ inline int mlp8_smem_bytes(int sets, int warps, int B, int C) {
  const int red = sets * warps * B * (kCols8 + ldg::kPad);
  const int recv = C > 1 ? 2 * sets * C * B * ((kCols8 + C - 1) / C) : 0;
  return 4 * (red + recv);
}

// The most any cluster size takes at 8 rows: the kernel's shared memory limit.
__host__ __device__ inline int mlp8_smem_max(int sets, int warps) {
  int m = 0;
  for (int c = 1; c <= kMaxCluster8; ++c) {
    const int b = mlp8_smem_bytes(sets, warps, 8, c);
    m = b > m ? b : m;
  }
  return m;
}

// The columns rank r of a cluster of C finishes: [col_start(r), col_start(r + 1)).
__device__ __forceinline__ int col_start(int r, int C) { return r * kCols8 / C; }

__device__ __forceinline__ int col_owner(int c, int C) {
  const int r = c * C / kCols8;
  return col_start(r + 1, C) <= c ? r + 1 : r;
}

// Column block cb's sums: every warp's rows are in red; with C > 1 each
// rank pushes the warps' sums of the columns another rank finishes into
// that rank's receive buffer `par` (first: the wait of the barrier arrived
// at on entry, after which every block of the cluster runs), and after a
// cluster barrier adds its columns' rows in rank order. Then the epilogue:
// SETS 2 h = bf16(silu(g * s0) * (u * s1)), SETS 1 bf16(y * s0).
template <int SETS, int WARPS>
__device__ __forceinline__ void finish8(const float* red, float* recv, const Args8& a, int C,
                                        int rank, int par, bool first, int cb) {
  constexpr int RS = kCols8 + ldg::kPad;
  const int B = a.B, tid = threadIdx.x, N = a.N;
  __syncthreads();  // every warp's sums are in red
  auto warp_sum = [&](int set, int n, int c) {
    const float* r = red + static_cast<size_t>(set) * WARPS * B * RS;
    float v = r[n * RS + c];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v += r[(w * B + n) * RS + c];
    return v;
  };
  auto put = [&](int n, int col, const float (&v)[SETS]) {
    float y;
    if (SETS == 2) {
      const float g = v[0] * a.s0[col], u = v[SETS - 1] * a.s1[col];
      y = g * (1.0f / (1.0f + expf(-g))) * u;
    } else {
      y = v[0] * a.s0[col];
    }
    a.out[static_cast<size_t>(n) * N + col] = __float2bfloat16_rn(y);
  };
  if (C == 1) {
    for (int idx = tid; idx < B * kCols8; idx += WARPS * 32) {
      const int n = idx / kCols8, c = idx - n * kCols8;
      float v[SETS];
#pragma unroll
      for (int set = 0; set < SETS; ++set) v[set] = warp_sum(set, n, c);
      put(n, cb * kCols8 + c, v);
    }
    return;
  }
  const int wmax = (kCols8 + C - 1) / C, span = SETS * C * B * wmax;
  if (first) hopper::cluster_wait();
  const uint32_t rbase = hopper::smem_u32(recv) + par * span * 4;
  for (int idx = tid; idx < SETS * B * kCols8; idx += WARPS * 32) {
    const int set = idx / (B * kCols8), rem = idx - set * B * kCols8;
    const int n = rem / kCols8, c = rem - n * kCols8;
    const int owner = col_owner(c, C);
    hopper::st_cluster_f32(
        rbase + (((set * C + rank) * B + n) * wmax + c - col_start(owner, C)) * 4, owner,
        warp_sum(set, n, c));
  }
  hopper::cluster_arrive();  // release: the pushes above
  hopper::cluster_wait();    // acquire: every rank's pushes into this block
  const float* mine = recv + par * span;
  const int c0 = col_start(rank, C), width = col_start(rank + 1, C) - c0;
  for (int idx = tid; idx < B * width; idx += WARPS * 32) {
    const int n = idx / width, k = idx - n * width;
    float v[SETS];
#pragma unroll
    for (int set = 0; set < SETS; ++set) {
      float s = mine[((set * C) * B + n) * wmax + k];
      for (int r = 1; r < C; ++r) s += mine[((set * C + r) * B + n) * wmax + k];
      v[set] = s;
    }
    put(n, cb * kCols8 + c0 + k, v);
  }
}

// 8 warps (two blocks an SM) or 16 (one); 128 registers a thread either way
template <int SETS, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 512 / (WARPS * 32)) mlp8_ldg(const Args8 a) {
  extern __shared__ __align__(16) float smem8[];
  constexpr int RS = kCols8 + ldg::kPad;
  const int C = a.cluster, B = a.B, N = a.N;
  const int rank = C > 1 ? static_cast<int>(hopper::cluster_rank()) : 0;
  const int U = a.K / kRows8, col_blocks = N / kCols8;
  const int cid = blockIdx.x / C, ncl = gridDim.x / C;
  const int ncb = (col_blocks - cid + ncl - 1) / ncl;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int W = WARPS * C, wi = rank * WARPS + warp;
  const int u0 = wi * U / W, nu = (wi + 1) * U / W - u0;  // this warp's tiles of a column block
  const bool xrow = g < B;  // lanes g >= B feed x's zero rows
  float* red = smem8;
  float* recv = red + SETS * WARPS * B * RS;
  if (C > 1) hopper::cluster_arrive();  // waited for before the first push

  // The warp's tiles, in order: column blocks cid, cid + ncl, ...; in each,
  // its tiles u0 .. u0 + nu - 1, each as gate then up (SETS 2). Lane (g, t)
  // reads rows 16 t .. 16 t + 15 of a tile at bytes 16 g .. 16 g + 15. A
  // ring of four k-steps (two rows each) runs four steps ahead of the
  // products: step s of a tile consumes its slot s % 4, then loads step
  // s + 4 into it (the next tile's step s - 4 from s = 4).
  const int per_cb = nu * SETS, ntiles = ncb * per_cb;
  auto wptr = [&](int i) {
    const int j = i / per_cb, r = i - j * per_cb, u = r / SETS;
    const int8_t* w = (SETS == 2 && r != u * SETS) ? a.w1 : a.w0;
    return reinterpret_cast<const uint8_t*>(w) +
           (static_cast<size_t>(u0 + u) * kRows8 + 16 * t) * N + (cid + j * ncl) * kCols8 +
           16 * g;
  };
  uint4 q[8];
  if (ntiles > 0) {
    const uint8_t* w0 = wptr(0);
#pragma unroll
    for (int r = 0; r < 8; ++r) q[r] = ldg::ld_w(w0 + static_cast<size_t>(r) * N);
  }
  int i = 0;  // the warp's tile
  for (int j = 0; j < ncb; ++j) {
    const int cb = cid + j * ncl;
    __syncthreads();  // the last column block's sums have been read
#pragma unroll
    for (int set = 0; set < SETS; ++set) {
      float* mine = red + (set * WARPS + warp) * B * RS;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        if (n < B)
          *reinterpret_cast<float4*>(mine + n * RS + 4 * lane) =
              make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncwarp();
    for (int u = 0; u < nu; ++u) {
      // x's words of the tile's rows 16 t + 2 s, + 1 (L1 or L2 hits: every
      // warp of the SM that shares the tile reads them)
      const __nv_bfloat16* xp = a.x + static_cast<size_t>(g) * a.K + (u0 + u) * kRows8 + 16 * t;
#pragma unroll
      for (int set = 0; set < SETS; ++set, ++i) {
        const bool more = i + 1 < ntiles;
        const uint8_t* w = wptr(i);  // this tile, then from step 4 the next one
        float p[8][4], o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int m = 0; m < 8; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[m][e] = 0.0f;
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const int k = s & 3;
          const uint32_t xw = xrow ? ldg::ld_x4(xp + 2 * s) : 0u;
          const uint4 r0 = q[2 * k], r1 = q[2 * k + 1];
          if (s == 4 && more) w = wptr(i + 1);
          if (s < 4 || more) {  // this tile's step s + 4, or the next tile's step s - 4
            const uint8_t* r = w + static_cast<size_t>(s < 4 ? 2 * s + 8 : 2 * s - 8) * N;
            q[2 * k] = ldg::ld_w(r);
            q[2 * k + 1] = ldg::ld_w(r + N);
          }
          // x[16 t + 2 s] in both halves (K slots 2t, 2t + 1: one code's two
          // nibbles), x[16 t + 2 s + 1] for slots 2t + 8, 2t + 9
          const uint32_t b0 = __byte_perm(xw, 0u, 0x1010), b1 = __byte_perm(xw, 0u, 0x3232);
          ring::mma_bf16(o, kOnesLo, kOnesLo, kOnesLo, kOnesLo, b0, b1);  // sums of x
          const uint32_t w0[4] = {r0.x, r0.y, r0.z, r0.w}, w1[4] = {r1.x, r1.y, r1.z, r1.w};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t ra = w0[h], rb = w0[2 + h], rc = w1[h], rd = w1[2 + h];
            const uint32_t ra4 = ra >> 4, rb4 = rb >> 4, rc4 = rc >> 4, rd4 = rd >> 4;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              ring::mma_bf16(p[4 * h + e], ring::nibbles<kBits8>(ra, ra4, e),
                             ring::nibbles<kBits8>(rb, rb4, e), ring::nibbles<kBits8>(rc, rc4, e),
                             ring::nibbles<kBits8>(rd, rd4, e), b0, b1);
          }
        }
        // sums += p - 2304 * sum(x): M row g of mma tile m is column 16 g + m,
        // row g + 8 column 16 g + 8 + m; o[0], o[1] are x's rows 2t, 2t + 1
        float* mine = red + (set * WARPS + warp) * B * RS;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 2 * t + e;
          if (n < B) {
            const float off = 2304.0f * o[e];
            float4* row = reinterpret_cast<float4*>(mine + n * RS + 16 * g);
            float4 v[4] = {row[0], row[1], row[2], row[3]};
            float* f = reinterpret_cast<float*>(v);
#pragma unroll
            for (int m = 0; m < 8; ++m) {
              f[m] += p[m][e] - off;
              f[8 + m] += p[m][e + 2] - off;
            }
            row[0] = v[0];
            row[1] = v[1];
            row[2] = v[2];
            row[3] = v[3];
          }
        }
      }
    }
    finish8<SETS, WARPS>(red, recv, a, C, rank, j & 1, j == 0, cb);
  }
}

// Raise mlp8_ldg<SETS, WARPS>'s dynamic shared memory limit to mlp8_smem_max
// (once); the error of that call.
template <int SETS, int WARPS>
int mlp8_smem_limit() {
  static const int err = static_cast<int>(cudaFuncSetAttribute(
      mlp8_ldg<SETS, WARPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      mlp8_smem_max(SETS, WARPS)));
  return err;
}

// The launch configuration of `grid` blocks of `warps` warps in clusters of
// `cluster` (1: no cluster attribute), `smem` bytes of dynamic shared memory.
struct Launch8 {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  Launch8(int grid, int warps, int cluster, int smem, cudaStream_t st) {
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(warps * 32);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = cluster > 1 ? 1 : 0;
  }
};

template <int SETS, int WARPS>
int mlp8_launch(const Args8& a, int grid, cudaStream_t st) {
  if (const int err = mlp8_smem_limit<SETS, WARPS>()) return err;
  if (a.cluster < 1 || a.cluster > kMaxCluster8 || grid <= 0 || grid % a.cluster ||
      grid / a.cluster > a.N / kCols8 || a.B < 1 || a.B > 8 || a.K <= 0 || a.K % kRows8 ||
      a.N <= 0 || a.N % kCols8 || reinterpret_cast<uintptr_t>(a.x) % 4 ||
      reinterpret_cast<uintptr_t>(a.w0) % 16 ||
      (SETS == 2 && reinterpret_cast<uintptr_t>(a.w1) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  Launch8 l(grid, WARPS, a.cluster, mlp8_smem_bytes(SETS, WARPS, a.B, a.cluster), st);
  return static_cast<int>(cudaLaunchKernelEx(&l.cfg, mlp8_ldg<SETS, WARPS>, a));
}

template <int SETS, int WARPS>
int mlp8_max_clusters(int cluster) {
  if (mlp8_smem_limit<SETS, WARPS>()) return -1;
  Launch8 l(cluster, WARPS, cluster, mlp8_smem_bytes(SETS, WARPS, 8, cluster), nullptr);
  l.cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, mlp8_ldg<SETS, WARPS>, &l.cfg) == cudaSuccess ? n
                                                                                         : -1;
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

// The int8 SwiGLU MLP over a bf16 x (B, H): gate / up (H, I) int8 codes and
// (I,) f32 scales, down (I, H) and (H,), all row-major with 16-byte aligned
// rows; h (B, I) bf16 scratch; out (B, H) bf16. Two launches of mlp8_ldg on
// the plans of ops/gemv_int8.mlp8_plans: gate and up in blocks of w1 (8 or
// 16) warps in clusters of c1, grid1 blocks; down in blocks of 8 warps, c2,
// grid2.
extern "C" int palu_mlp_gemv_int8_ldg(const void* x, int B, int H, int I, const void* wg,
                                      const void* sg, const void* wu, const void* su,
                                      const void* wd, const void* sd, void* h, int w1, int c1,
                                      int grid1, int c2, int grid2, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args8 a = {static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wg),
             static_cast<const int8_t*>(wu), static_cast<const float*>(sg),
             static_cast<const float*>(su), static_cast<__nv_bfloat16*>(h), B, H, I, c1};
  const int err = w1 == 16 ? mlp8_launch<2, 16>(a, grid1, st)
                  : w1 == 8 ? mlp8_launch<2, 8>(a, grid1, st)
                            : static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  Args8 d = {static_cast<const __nv_bfloat16*>(h), static_cast<const int8_t*>(wd), nullptr,
             static_cast<const float*>(sd), nullptr, static_cast<__nv_bfloat16*>(out), B, I, H,
             c2};
  return mlp8_launch<1, 8>(d, grid2, st);
}

// Shared memory bytes of an mlp8_ldg block (sets 2: gate / up, 1: down; 8
// or 16 warps). For the plan's mirror test.
extern "C" int palu_mlp8_smem(int sets, int warps, int B, int cluster) {
  return mlp8_smem_bytes(sets, warps, B, cluster);
}

// Clusters of `cluster` blocks of the launch the card runs at once at 8
// rows (cudaOccupancyMaxActiveClusters): gate / up (sets 2) in blocks of 8
// or 16 warps, down (sets 1) of 8; -1 for another kind or a failed query.
extern "C" int palu_mlp8_max_clusters(int sets, int warps, int cluster) {
  if (sets == 2 && warps == 16) return mlp8_max_clusters<2, 16>(cluster);
  if (sets == 2 && warps == 8) return mlp8_max_clusters<2, 8>(cluster);
  if (sets == 1 && warps == 8) return mlp8_max_clusters<1, 8>(cluster);
  return -1;
}
