// Decode-step cache append: quantize one token's latents per (lane, group),
// pack the codes rank-major, and write column `pos` of the cache in place.
//
// Replaces: palu_tpu/ops/pallas/cache_append.py::append_token_quantized
// (math in _quantize_pack_rows).
//
// Bound on this card: neither bytes nor operations. One call moves
// B * G * (rank * 2 + nrows + 8) bytes (a few KB at the 7B shapes) and does
// a few operations per latent, so the call costs what a launch costs.
// Design: one block per (group, lane), one pass: load the rank latents to
// shared memory in f32, reduce max|x| (sym) or max/min (asym) over the
// block, quantize, pack the pack_codes_t geometry (byte row j, field k
// holds rank k * (rank / fields) + j) and write one byte per row at stride
// S. A lane with writeable == 0 returns before touching memory, so its
// slot stays bit-identical.
//
// Bit-exactness with quantize_affine + pack_codes_t: the f32 operations are
// the ones XLA compiles the JAX code into, each with an explicit rounding
// intrinsic so nvcc contracts nothing on its own: the division by the
// constant q_max is a multiply by its f32 reciprocal, the sym clip multiply
// folds into that constant, the asym clipped range is one fused
// multiply-add; rounding is rintf (half to even, as jnp.round and
// torch.round); x / scale is an IEEE division (no --use_fast_math).
// Pack widths 2, 4 and 8 only (append_supported); exact 3-bit packing
// keeps the plain append.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cfloat>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float load_f32(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cache_append_kernel(const T* __restrict__ lat, uint8_t* __restrict__ codes,
                    float* __restrict__ scale, float* __restrict__ zero,
                    const int* __restrict__ pos, const uint8_t* __restrict__ writeable,
                    int G, int rank, int nrows, int S, int bits, int pbits,
                    int sym, float clip_ratio, int do_clip) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int p = pos[b];
  if (writeable[b] == 0 || p < 0 || p >= S) return;

  extern __shared__ float smem[];
  float* x = smem;                               // [rank]
  int* code = reinterpret_cast<int*>(smem + rank);  // [rank]
  __shared__ float red_hi[kThreads / 32];
  __shared__ float red_lo[kThreads / 32];

  const T* src = lat + (static_cast<size_t>(b) * G + g) * rank;
  float hi = -FLT_MAX, lo = FLT_MAX;
  for (int r = threadIdx.x; r < rank; r += kThreads) {
    const float v = load_f32(src, r);
    x[r] = v;
    if (sym) {
      hi = fmaxf(hi, fabsf(v));
    } else {
      hi = fmaxf(hi, v);
      lo = fminf(lo, v);
    }
  }
  hi = warp_max(hi);
  lo = warp_min(lo);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red_hi[warp] = hi;
    red_lo[warp] = lo;
  }
  __syncthreads();
  hi = red_hi[0];
  lo = red_lo[0];
  for (int w = 1; w < kThreads / 32; ++w) {
    hi = fmaxf(hi, red_hi[w]);
    lo = fminf(lo, red_lo[w]);
  }

  float q_min, q_max, sc, base;
  if (sym) {
    q_max = static_cast<float>((1 << (bits - 1)) - 1);
    q_min = static_cast<float>(-(1 << (bits - 1)));
    const float inv = __frcp_rn(q_max);
    sc = __fmul_rn(fmaxf(hi, 1e-5f), do_clip ? __fmul_rn(clip_ratio, inv) : inv);
    base = 0.0f;
  } else {
    q_max = static_cast<float>((1 << bits) - 1);
    q_min = 0.0f;
    float w_min = lo, diff;
    if (do_clip) {
      w_min = __fmul_rn(lo, clip_ratio);
      diff = __fmaf_rn(hi, clip_ratio, -w_min);
    } else {
      diff = __fsub_rn(hi, lo);
    }
    sc = __fmul_rn(fmaxf(diff, 1e-5f), __frcp_rn(q_max));
    base = fminf(fmaxf(rintf(__fdiv_rn(-w_min, sc)), q_min), q_max);
  }

  for (int r = threadIdx.x; r < rank; r += kThreads) {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(x[r], sc)) + base, q_min), q_max);
    code[r] = static_cast<int>(q - q_min);
  }
  __syncthreads();

  const size_t lane_group = static_cast<size_t>(b) * G + g;
  uint8_t* dst = codes + lane_group * nrows * S + p;
  const int s = 8 / pbits, w = rank / s;
  for (int j = threadIdx.x; j < nrows; j += kThreads) {
    unsigned v = 0;
    for (int k = 0; k < s; ++k) v |= static_cast<unsigned>(code[k * w + j]) << (pbits * k);
    dst[static_cast<size_t>(j) * S] = static_cast<uint8_t>(v);
  }
  if (threadIdx.x == 0) {
    scale[lane_group * S + p] = sc;
    if (!sym) zero[lane_group * S + p] = (q_min - base) * sc;
  }
}

}  // namespace

// lat (B, G, rank) bf16 or f32; codes (B, G, nrows, S) u8; scale/zero
// (B, G, S) f32 (zero unused when sym); pos (B,) int32; writeable (B,)
// bool (one byte each).
extern "C" int palu_cache_append(const void* lat, int lat_is_bf16, void* codes,
                                 void* scale, void* zero, const void* pos,
                                 const void* writeable, int B, int G, int rank,
                                 int nrows, int S, int bits, int pbits, int sym,
                                 float clip_ratio, int do_clip, void* stream) {
  const dim3 grid(G, B);
  const size_t smem = static_cast<size_t>(rank) * (sizeof(float) + sizeof(int));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lat_is_bf16) {
    cache_append_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(lat), static_cast<uint8_t*>(codes),
        static_cast<float*>(scale), static_cast<float*>(zero),
        static_cast<const int*>(pos), static_cast<const uint8_t*>(writeable), G,
        rank, nrows, S, bits, pbits, sym, clip_ratio, do_clip);
  } else {
    cache_append_kernel<float><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(lat), static_cast<uint8_t*>(codes),
        static_cast<float*>(scale), static_cast<float*>(zero),
        static_cast<const int*>(pos), static_cast<const uint8_t*>(writeable), G,
        rank, nrows, S, bits, pbits, sym, clip_ratio, do_clip);
  }
  return static_cast<int>(cudaGetLastError());
}
