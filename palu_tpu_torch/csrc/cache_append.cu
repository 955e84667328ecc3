// Decode-step cache append of one layer: quantize one token's latents per
// (side, lane, group), pack the codes rank-major, and write column `pos` of
// both sides' caches (K and V) in place, in one launch.
//
// Replaces: palu_tpu/ops/pallas/cache_append.py::append_token_quantized
// (math in _quantize_pack_rows), which the JAX engine calls once per side.
//
// Bound on this card: neither bytes nor operations. One call moves
// B * G * (rank * 2 + nrows + 8) bytes a side (a few KB at the 7B shapes)
// and does a few operations per latent, so the call costs what a launch and
// one dependent chain (load, reduce, divide, store) cost.
// Design: one warp per (side, lane, group) row, four rows a block, with no
// shared memory and no barrier: the extrema are warp shuffles. Lane t owns
// the packed byte rows j = t, t + 32, ... (the pack_codes_t geometry: byte
// row j, field k holds rank k * nrows + j), so the fields of a byte are in
// one lane's registers and no exchange is needed to pack; each load of rank
// k * nrows + j is coalesced across the lanes. A lane holds up to 16
// latents in registers, all loaded before the first is used (one DRAM
// latency, not one a byte row); a longer row takes more rounds, reloaded in
// the second pass. The position and mask are read beside the latents and used
// only at the stores; a lane with writeable == 0, or a position outside [0,
// S), writes nothing, so its slot stays bit-identical. The divisions by the
// row's scale are one reciprocal a row and three roundings a latent
// (div_rn). On an H100 80GB HBM3 (700 W; tools/gemv_ab.py --only=append),
// caches cold, a layer of serve takes 3.2 us against 5.9-6.0 for the two
// one-side launches before; IEEE divisions (__fdiv_rn: the largest part of
// the launch), a loop whose loads waited on the last one's folds, and V's
// rows split over more warps (their extrema added through shared memory,
// or found by each warp) were each slower.
//
// Bit-exactness with quantize_affine + pack_codes_t: the f32 operations are
// the ones XLA compiles the JAX code into, each with an explicit rounding
// intrinsic so nvcc contracts nothing on its own: the division by the
// constant q_max is a multiply by its f32 reciprocal, the sym clip multiply
// folds into that constant, the asym clipped range is one fused
// multiply-add; rounding is rintf (half to even, as jnp.round and
// torch.round); x / scale is an IEEE division (no --use_fast_math). max and
// min are exact in any order. Pack widths 2, 4 and 8 only
// (append_supported); exact 3-bit packing keeps the plain append.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cfloat>

namespace {

constexpr int kWarps = 4;   // rows of a block
constexpr int kVals = 16;   // latents a lane holds at once (one round: rank <= 512)

// What the host fills once per layer's buffers (ops/cache_append.KVAppend,
// a ctypes mirror of this struct): side 0 is K, side 1 V (absent when
// sides == 1). codes (B, G, nrows, S) u8; scale / zero (B, G, S) f32.
struct Plan {
  void* codes[2];
  void* scale[2];
  void* zero[2];
  int G[2];
  int rank[2];
  int sides, B, S, bits, pbits, sym, do_clip;
  float clip_ratio;
};

struct Side {
  const void* lat;
  uint8_t* codes;
  float* scale;
  float* zero;
  int G, rank;
};

struct Args {
  Side side[2];
  const int* pos;
  const uint8_t* writeable;
  int B, S, bits, sym, do_clip;
  float clip_ratio;
};

__device__ __forceinline__ float load_f32(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

// x / sc rounded to nearest (even), the IEEE quotient __fdiv_rn gives, from
// y = RN(1 / sc) (__frcp_rn, once a row): q = RN(x y) is within about an
// ulp of x / sc, and RN(q + RN(x - q sc) y), two fmas, is the correctly
// rounded quotient (Markstein's correction; held against the IEEE quotient
// in exact rational arithmetic, over 60 binades and the quantizer's own
// (latent, scale) pairs, by tests/test_torch_append_kv.py), without
// __fdiv_rn's range checks and slow path.
__device__ __forceinline__ float div_rn(float x, float sc, float y) {
  const float q = __fmul_rn(x, y);
  return __fmaf_rn(__fmaf_rn(-q, sc, x), y, q);
}

template <typename T, int PBITS>
__global__ void __launch_bounds__(kWarps * 32) append_kernel(const Args a) {
  constexpr int kFields = 8 / PBITS;     // codes in a byte
  constexpr int kPer = kVals / kFields;  // byte rows of a lane in a round
  constexpr int kRound = 32 * kPer;      // byte rows of a round
  const int lane = threadIdx.x & 31;
  int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int rows0 = a.B * a.side[0].G;
  const bool second = row >= rows0;
  const Side sd = second ? a.side[1] : a.side[0];
  if (second) row -= rows0;
  if (row >= a.B * sd.G) return;  // past the last row (or no second side)
  const int b = row / sd.G;
  const int p = a.pos[b];  // used only at the stores: its load overlaps the latents'
  const bool live = a.writeable[b] != 0 && p >= 0 && p < a.S;

  const int nrows = sd.rank / kFields;
  const T* src = static_cast<const T*>(sd.lat) + static_cast<size_t>(row) * sd.rank;
  float x[kVals];  // byte row j0 + 32 r + lane, field k at r * kFields + k
  auto load = [&](int j0) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int j = j0 + 32 * r + lane;
#pragma unroll
      for (int k = 0; k < kFields; ++k)
        x[r * kFields + k] = j < nrows ? load_f32(src, k * nrows + j) : 0.0f;
    }
  };
  float hi = -FLT_MAX, lo = FLT_MAX;
  for (int j0 = 0; j0 < nrows; j0 += kRound) {
    load(j0);  // every load of the round issued before the first is used
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      if (j0 + 32 * r + lane >= nrows) break;
#pragma unroll
      for (int k = 0; k < kFields; ++k) {
        const float v = x[r * kFields + k];
        if (a.sym) {
          hi = fmaxf(hi, fabsf(v));
        } else {
          hi = fmaxf(hi, v);
          lo = fminf(lo, v);
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
  }

  float q_min, q_max, sc, base;
  if (a.sym) {
    q_max = static_cast<float>((1 << (a.bits - 1)) - 1);
    q_min = static_cast<float>(-(1 << (a.bits - 1)));
    const float inv = __frcp_rn(q_max);
    sc = __fmul_rn(fmaxf(hi, 1e-5f), a.do_clip ? __fmul_rn(a.clip_ratio, inv) : inv);
    base = 0.0f;
  } else {
    q_max = static_cast<float>((1 << a.bits) - 1);
    q_min = 0.0f;
    float w_min = lo, diff;
    if (a.do_clip) {
      w_min = __fmul_rn(lo, a.clip_ratio);
      diff = __fmaf_rn(hi, a.clip_ratio, -w_min);
    } else {
      diff = __fsub_rn(hi, lo);
    }
    sc = __fmul_rn(fmaxf(diff, 1e-5f), __frcp_rn(q_max));
    base = fminf(fmaxf(rintf(__fdiv_rn(-w_min, sc)), q_min), q_max);
  }
  if (!live) return;

  const float y = __frcp_rn(sc);
  uint8_t* dst = sd.codes + static_cast<size_t>(row) * nrows * a.S + p;
  for (int j0 = 0; j0 < nrows; j0 += kRound) {
    if (nrows > kRound) load(j0);  // one round (rank <= 512): x holds it still
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int j = j0 + 32 * r + lane;
      if (j >= nrows) break;
      unsigned v = 0;
#pragma unroll
      for (int k = 0; k < kFields; ++k) {
        const float q =
            fminf(fmaxf(rintf(div_rn(x[r * kFields + k], sc, y)) + base, q_min), q_max);
        v |= static_cast<unsigned>(static_cast<int>(q - q_min)) << (PBITS * k);
      }
      dst[static_cast<size_t>(j) * a.S] = static_cast<uint8_t>(v);
    }
  }
  if (lane == 0) {
    sd.scale[static_cast<size_t>(row) * a.S + p] = sc;
    if (!a.sym) sd.zero[static_cast<size_t>(row) * a.S + p] = (q_min - base) * sc;
  }
}

template <typename T>
int launch(const Args& a, int pbits, int grid, cudaStream_t st) {
  switch (pbits) {
    case 2: append_kernel<T, 2><<<grid, kWarps * 32, 0, st>>>(a); break;
    case 4: append_kernel<T, 4><<<grid, kWarps * 32, 0, st>>>(a); break;
    case 8: append_kernel<T, 8><<<grid, kWarps * 32, 0, st>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One append: `plan` points at the host's Plan of the layer's buffers;
// lat_k / lat_v (B, G, rank) of each side, bf16 or f32 (lat_v null when
// plan->sides == 1); pos (B,) int32; writeable (B,) bool (one byte each).
extern "C" int palu_cache_append(const void* plan, const void* lat_k, const void* lat_v,
                                 int lat_is_bf16, const void* pos, const void* writeable,
                                 void* stream) {
  const Plan& pl = *static_cast<const Plan*>(plan);
  if (pl.sides < 1 || pl.sides > 2 || pl.B < 1 || pl.S < 1 || (pl.sides == 2 && !lat_v))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  const void* lats[2] = {lat_k, lat_v};
  int rows = 0;
  for (int s = 0; s < pl.sides; ++s) {
    a.side[s] = {lats[s], static_cast<uint8_t*>(pl.codes[s]), static_cast<float*>(pl.scale[s]),
                 static_cast<float*>(pl.zero[s]), pl.G[s], pl.rank[s]};
    rows += pl.B * pl.G[s];
  }
  a.pos = static_cast<const int*>(pos);
  a.writeable = static_cast<const uint8_t*>(writeable);
  a.B = pl.B;
  a.S = pl.S;
  a.bits = pl.bits;
  a.sym = pl.sym;
  a.do_clip = pl.do_clip;
  a.clip_ratio = pl.clip_ratio;
  const int grid = (rows + kWarps - 1) / kWarps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lat_is_bf16 ? launch<__nv_bfloat16>(a, pl.pbits, grid, st)
                     : launch<float>(a, pl.pbits, grid, st);
}
