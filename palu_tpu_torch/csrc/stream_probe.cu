// Streaming floor of the latent cache: a grid that stages tiles of the
// cache into shared memory and does no compute.
//
// Replaces: tools/tpu_stream_probe.py::_noop_call (its noop_kernel), the
// TPU tool's Pallas grid whose BlockSpecs copy the cache block by block
// while the body only counts blocks. Three layouts, chosen by the caller:
// split-g, a K plane (G, S, rk) and a V plane (G, S, rv) as the v1 decode
// reads them (`bs<N>`), the K plane alone (`konly<N>`), and one merged
// (S, G * (rk + rv)) array (`merged<N>`).
//
// Bound on this card: bytes. At the tool's shape (G 8, rk 128, rv 384, S
// 64K, bf16) the planes are 537 MB, 0.160 ms at 3.35 TB/s; the K plane
// alone 134 MB, 0.040 ms.
//
// Design: the TPU grid walks N-token blocks in order on one core; here
// block (i, p) takes rows [i * N, (i + 1) * N) of plane p (a plane is
// (rows, width bytes), contiguous), and walks them in tiles of `tile_rows`
// rows, each tile one contiguous run per array, copied with 16-byte
// cp.async into shared memory, as palu_decode_fp.cu stages its seq-major
// tiles (64 tokens of K and V: 64 KB; the merged array's 8-KB rows go 8 to
// a tile, the same 64 KB). After the copies land, each thread reads back
// the pieces it copied and folds each one (the XOR of its four words) into
// an exact 64-bit checksum, so a check can show every byte arrived. A
// second kernel adds the blocks' checksums and writes the tool's output,
// c + the number of sequence blocks, into the (8, 128) f32 array.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"

namespace {

using decode::cp_async16;
using decode::cp_async_wait_all;

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned long long fold_pieces(const uint8_t* sm, int pieces) {
  unsigned long long ck = 0;
  for (int i = threadIdx.x; i < pieces; i += kThreads) {
    const uint4 u = *reinterpret_cast<const uint4*>(sm + static_cast<size_t>(i) * 16);
    ck += u.x ^ u.y ^ u.z ^ u.w;
  }
  return ck;
}

__device__ __forceinline__ void copy_pieces(uint8_t* sm, const uint8_t* src, int pieces) {
  for (int i = threadIdx.x; i < pieces; i += kThreads)
    cp_async16(sm + static_cast<size_t>(i) * 16, src + static_cast<size_t>(i) * 16);
}

// a0 (planes, S, w0 bytes), a1 (planes, S, w1 bytes) or null; part
// (planes, gridDim.x) block checksums.
__global__ void __launch_bounds__(kThreads)
    stream_kernel(const uint8_t* __restrict__ a0, int w0, const uint8_t* __restrict__ a1, int w1,
                  int S, int rows_per_block, int tile_rows, unsigned long long* part) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int plane = blockIdx.y;
  const size_t base0 = static_cast<size_t>(plane) * S * w0;
  const size_t base1 = static_cast<size_t>(plane) * S * w1;
  uint8_t* s1 = smem + static_cast<size_t>(tile_rows) * w0;
  const int r_end = min(S, (blockIdx.x + 1) * rows_per_block);
  unsigned long long ck = 0;
  for (int r0 = blockIdx.x * rows_per_block; r0 < r_end; r0 += tile_rows) {
    const int n = min(tile_rows, r_end - r0);
    copy_pieces(smem, a0 + base0 + static_cast<size_t>(r0) * w0, n * w0 / 16);
    if (a1 != nullptr) copy_pieces(s1, a1 + base1 + static_cast<size_t>(r0) * w1, n * w1 / 16);
    cp_async_wait_all();
    __syncthreads();
    ck += fold_pieces(smem, n * w0 / 16);
    if (a1 != nullptr) ck += fold_pieces(s1, n * w1 / 16);
    __syncthreads();  // the next tile's copies overwrite
  }
  for (int o = 16; o > 0; o >>= 1) ck += __shfl_xor_sync(0xffffffffu, ck, o);
  __shared__ unsigned long long w_s[kThreads / 32];
  if (threadIdx.x % 32 == 0) w_s[threadIdx.x / 32] = ck;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s = 0;
    for (int w = 0; w < kThreads / 32; ++w) s += w_s[w];
    part[static_cast<size_t>(plane) * gridDim.x + blockIdx.x] = s;
  }
}

// ck_out[0] = sum of the n block checksums; out[i] = c[i] + 1 for each of
// the n_seq_blocks sequence blocks, added in order as the TPU grid's steps
// add them (the (8, 128) output).
__global__ void __launch_bounds__(kThreads)
    stream_finish(const unsigned long long* __restrict__ part, int n, const float* __restrict__ c,
                  int n_seq_blocks, float* __restrict__ out,
                  unsigned long long* __restrict__ ck_out) {
  __shared__ unsigned long long w_s[kThreads / 32];
  unsigned long long s = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) s += part[i];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (threadIdx.x % 32 == 0) w_s[threadIdx.x / 32] = s;
  for (int i = threadIdx.x; i < 8 * 128; i += kThreads) {  // one count per block, in order
    float v = c[i];
    for (int b = 0; b < n_seq_blocks; ++b) v += 1.0f;
    out[i] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t = 0;
    for (int w = 0; w < kThreads / 32; ++w) t += w_s[w];
    ck_out[0] = t;
  }
}

}  // namespace

// Stream `planes` planes of a0 (planes, S, w0) and, if given, a1 (planes, S,
// w1) in blocks of rows_per_block rows and tiles of tile_rows rows; widths
// in bytes, multiples of 16; tile_rows * (w0 + w1) at most 227 KB. part
// holds planes * ceil(S / rows_per_block) checksums; c and out are (8, 128)
// f32; ck_out one u64.
extern "C" int stream_probe(const void* a0, int w0, const void* a1, int w1, int planes, int S,
                            int rows_per_block, int tile_rows, void* part, const void* c,
                            void* out, void* ck_out, void* stream) {
  if (w0 % 16 || w1 % 16 || rows_per_block <= 0 || tile_rows <= 0 || planes <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(tile_rows) * (w0 + (a1 != nullptr ? w1 : 0));
  if (smem > decode::kSmemMax - 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (S + rows_per_block - 1) / rows_per_block;
  stream_kernel<<<dim3(blocks, planes), kThreads, smem, st>>>(
      static_cast<const uint8_t*>(a0), w0, static_cast<const uint8_t*>(a1), w1, S,
      rows_per_block, tile_rows, static_cast<unsigned long long*>(part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_finish<<<1, kThreads, 0, st>>>(static_cast<const unsigned long long*>(part),
                                        blocks * planes, static_cast<const float*>(c),
                                        blocks, static_cast<float*>(out),
                                        static_cast<unsigned long long*>(ck_out));
  return static_cast<int>(cudaGetLastError());
}
