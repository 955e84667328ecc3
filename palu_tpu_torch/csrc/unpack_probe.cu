// What sub-byte extraction costs: the latent cache's packed codes streamed
// with extraction, with and without the products that follow it.
//
// Replaces: tools/tpu_unpack_probe.py::_mk (the Pallas grid) with the
// variant bodies of its `make`: base, ext4nc, ext4cc, ext4mm, ext4ccmm,
// ext3nc, ext3cc, conv8. Codes are rank-major (G, rows, S) uint8, as the
// packed cache keeps them: 4-bit, byte row i holds rank i in its low nibble
// and rank rows + i in its high one (unpack4_parts); 3-bit, three bit
// planes of rank / 8 rows each, and bit k of planes 0 / 1 / 2 at row i form
// the code of rank k * (rank / 8) + i (unpack3_parts); conv8 reads int8
// codes (G, rank, S).
//
// The nc / cc split on this card. On the TPU, "cc" concatenates the parts
// sublane-wise (a relayout) and "nc" consumes each part as it comes. Here
// `cc` assembles one bf16 (rank x tile) array in shared memory, which is
// what palu_decode.cu does for K (its header, lines 37-38), and then reads
// it back (the sum, or ldmatrix for the products); `nc` consumes each
// extracted part in registers (summed, or packed straight into mma.sync A
// fragments).
//
// Outputs: base folds each 16-byte piece of codes (the XOR of its words)
// into an exact checksum; the ext / conv variants add every extracted value
// (converted to bf16, summed in f32 per tile, where it is exact, then in
// 64-bit integers) into the exact integer total; ext4mm / ext4ccmm run
// the K product x^T (tokens x rank) . B (rank x W) and the V product
// x (rank x tokens) . p (tokens x 8) on mma.sync (bf16 in, f32 accumulate)
// and write each (group, block) sum of their products, K and V apart.
//
// Bound on this card: bytes. At the tool's shape (G 8, rk 128, rv 384, S
// 64K) the 4-bit codes are 134 MB (0.040 ms at 3.35 TB/s), the 3-bit 101
// MB (0.030 ms), the int8 codes 268 MB (0.080 ms); the mm variants' 11.8
// GFLOP take 0.012 ms on the bf16 tensor cores.
//
// Design: block (i, g) takes the BS tokens [i * BS, (i + 1) * BS) of group
// g, in tiles of 128 tokens: the K and V code tiles (128 bytes per row,
// padded to 144) come into shared memory with 16-byte cp.async copies,
// then the variant's body runs on them. The mm variants stage B (rk x W)
// and p (BS x 8) once per block. A second kernel adds the blocks' integer
// totals.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"

namespace {

using decode::cp_async16;
using decode::cp_async_wait_all;
using decode::ldmatrix_x4;
using decode::ldmatrix_x4_trans;
using decode::mma_bf16;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 128;        // tokens per tile
constexpr int kCS = kT + 16;   // code tile row stride (bytes)
constexpr int kUS = kT + 8;    // assembled bf16 tile row stride (elements)
constexpr int kMaxNT = 8;      // 8-wide column tiles of W (W <= 64)

enum Var { kBase, kExt4Nc, kExt4Cc, kExt4Mm, kExt4CcMm, kExt3Nc, kExt3Cc, kConv8 };

struct UpArgs {
  const uint8_t* kc;  // (G, rows_k, S)
  const uint8_t* vc;  // (G, rows_v, S)
  const bf16* b1;     // (G, rk, W), mm variants
  const bf16* p;      // (G, BS, 8), mm variants
  long long* part_i;  // (G, blocks) integer totals
  float* part_f;      // (2, G, blocks) K and V product sums, mm variants
  int rows_k, rows_v, rk, rv, W, S, BS;
};

struct Layout {
  size_t kc, vc, u, b, p, total;
};

__host__ __device__ inline Layout up_layout(int var, int rows_k, int rows_v, int rk, int rv,
                                            int W, int BS) {
  const bool cc = var == kExt4Cc || var == kExt4CcMm || var == kExt3Cc;
  const bool mm = var == kExt4Mm || var == kExt4CcMm;
  Layout L;
  size_t off = 0;
  L.kc = off; off = decode::al(off + static_cast<size_t>(rows_k) * kCS);
  L.vc = off; off = decode::al(off + static_cast<size_t>(rows_v) * kCS);
  L.u = off;  off = decode::al(off + (cc ? sizeof(bf16) * (rk > rv ? rk : rv) * kUS : 0));
  L.b = off;  off = decode::al(off + (mm ? sizeof(bf16) * rk * (W + 8) : 0));
  L.p = off;  off = decode::al(off + (mm ? sizeof(bf16) * BS * 8 : 0));
  L.total = off;
  return L;
}

__device__ __forceinline__ float bf_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// four byte fields of v (each 0..255) converted to bf16 and added, as f32
__device__ __forceinline__ float add_bytes(uint32_t v) {
  float s = 0.0f;
#pragma unroll
  for (int b = 0; b < 4; ++b) s += bf_round(static_cast<float>((v >> (8 * b)) & 0xffu));
  return s;
}

__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 3-bit code k of the four bytes: bit k of planes 0, 1, 2 as bits 0, 1, 2
__device__ __forceinline__ uint32_t code3(uint32_t w0, uint32_t w1, uint32_t w2, int k) {
  return ((w0 >> k) & 0x01010101u) | (((w1 >> k) & 0x01010101u) << 1) |
         (((w2 >> k) & 0x01010101u) << 2);
}

// the 16 byte fields of four words (tokens in order) as bf16 into dst
__device__ __forceinline__ void store16(bf16* dst, const uint32_t (&w)[4]) {
  uint32_t h[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    h[2 * q] = pack_bf2(static_cast<float>(w[q] & 0xffu), static_cast<float>((w[q] >> 8) & 0xffu));
    h[2 * q + 1] = pack_bf2(static_cast<float>((w[q] >> 16) & 0xffu),
                            static_cast<float>(w[q] >> 24));
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(h[0], h[1], h[2], h[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(h[4], h[5], h[6], h[7]);
}

__device__ __forceinline__ void load_codes(uint8_t* dst, const uint8_t* src, int rows, int S,
                                           int s0) {
  for (int i = threadIdx.x; i < rows * (kT / 16); i += kThreads) {
    const int r = i / (kT / 16), c = i % (kT / 16);
    cp_async16(dst + r * kCS + c * 16, src + static_cast<size_t>(r) * S + s0 + c * 16);
  }
}

__device__ __forceinline__ uint4 piece(const uint8_t* tile, int i) {
  return *reinterpret_cast<const uint4*>(tile + (i / (kT / 16)) * kCS + (i % (kT / 16)) * 16);
}

// The integer variants on one tile of `rank` ranks; returns the f32 sum of
// the values this thread consumed (exact: at most 256 values of <= 255).
// cc variants assemble u [rank][token] and the caller sums it.
template <int VAR>
__device__ __forceinline__ float tile_values(const uint8_t* tile, int rank, bf16* u) {
  float s = 0.0f;
  if constexpr (VAR == kConv8) {
    for (int i = threadIdx.x; i < rank * (kT / 16); i += kThreads) {
      const uint4 q = piece(tile, i);
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          s += bf_round(static_cast<float>(static_cast<int8_t>((w[j] >> (8 * b)) & 0xffu)));
    }
  } else if constexpr (VAR == kExt4Nc || VAR == kExt4Cc) {
    const int half = rank / 2;
    for (int i = threadIdx.x; i < half * (kT / 16); i += kThreads) {
      const uint4 q = piece(tile, i);
      const int row = i / (kT / 16), c = i % (kT / 16);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const uint32_t w[4] = {(q.x >> (4 * k)) & 0x0f0f0f0fu, (q.y >> (4 * k)) & 0x0f0f0f0fu,
                               (q.z >> (4 * k)) & 0x0f0f0f0fu, (q.w >> (4 * k)) & 0x0f0f0f0fu};
        if constexpr (VAR == kExt4Cc) {
          store16(u + (k * half + row) * kUS + c * 16, w);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) s += add_bytes(w[j]);
        }
      }
    }
  } else if constexpr (VAR == kExt3Nc || VAR == kExt3Cc) {
    const int r = rank / 8;
    for (int i = threadIdx.x; i < r * (kT / 16); i += kThreads) {
      const uint4 q0 = piece(tile, i), q1 = piece(tile, i + r * (kT / 16)),
                  q2 = piece(tile, i + 2 * r * (kT / 16));
      const int row = i / (kT / 16), c = i % (kT / 16);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t w[4] = {code3(q0.x, q1.x, q2.x, k), code3(q0.y, q1.y, q2.y, k),
                               code3(q0.z, q1.z, q2.z, k), code3(q0.w, q1.w, q2.w, k)};
        if constexpr (VAR == kExt3Cc) {
          store16(u + (k * r + row) * kUS + c * 16, w);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) s += add_bytes(w[j]);
        }
      }
    }
  }
  return s;
}

// sum of the assembled bf16 array u [rank][token]
__device__ __forceinline__ float sum_assembled(const bf16* u, int rank) {
  float s = 0.0f;
  for (int i = threadIdx.x; i < rank * (kT / 8); i += kThreads) {
    const uint4 q = *reinterpret_cast<const uint4*>(u + (i / (kT / 8)) * kUS + (i % (kT / 8)) * 8);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      s += f.x + f.y;
    }
  }
  return s;
}

// nibble k of two bytes as a bf16 pair (lo from the first byte)
__device__ __forceinline__ uint32_t nib2(uint8_t a, uint8_t b, int k) {
  return pack_bf2(static_cast<float>((a >> (4 * k)) & 15), static_cast<float>((b >> (4 * k)) & 15));
}

template <int VAR>
__global__ void __launch_bounds__(kThreads) unpack_kernel(UpArgs a) {
  constexpr bool kCc = VAR == kExt4Cc || VAR == kExt4CcMm || VAR == kExt3Cc;
  constexpr bool kMm = VAR == kExt4Mm || VAR == kExt4CcMm;
  extern __shared__ __align__(128) uint8_t smem[];
  const Layout L = up_layout(VAR, a.rows_k, a.rows_v, a.rk, a.rv, a.W, a.BS);
  uint8_t* kt = smem + L.kc;
  uint8_t* vt = smem + L.vc;
  bf16* u = reinterpret_cast<bf16*>(smem + L.u);
  bf16* bs = reinterpret_cast<bf16*>(smem + L.b);
  bf16* ps = reinterpret_cast<bf16*>(smem + L.p);
  const int blk = blockIdx.x, g = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int fg = lane / 4, ft = lane % 4, mi = lane / 8, ri = lane % 8;
  const uint8_t* kc = a.kc + static_cast<size_t>(g) * a.rows_k * a.S;
  const uint8_t* vc = a.vc + static_cast<size_t>(g) * a.rows_v * a.S;
  const int WS = a.W + 8, NT = a.W / 8;

  if constexpr (kMm) {  // B and p of the group, once
    const bf16* b1 = a.b1 + static_cast<size_t>(g) * a.rk * a.W;
    for (int i = tid; i < a.rk * (a.W / 8); i += kThreads) {
      const int r = i / (a.W / 8), c = i % (a.W / 8);
      cp_async16(bs + r * WS + c * 8, b1 + static_cast<size_t>(r) * a.W + c * 8);
    }
    const bf16* p = a.p + static_cast<size_t>(g) * a.BS * 8;
    for (int i = tid; i < a.BS; i += kThreads) cp_async16(ps + i * 8, p + i * 8);
  }

  long long tot = 0;        // integer variants
  unsigned long long ck = 0;  // base
  float acc_k[kMaxNT][4], acc_v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kMaxNT; ++j) acc_k[j][0] = acc_k[j][1] = acc_k[j][2] = acc_k[j][3] = 0.f;

  for (int t0 = 0; t0 < a.BS; t0 += kT) {
    const int s0 = blk * a.BS + t0;
    load_codes(kt, kc, a.rows_k, a.S, s0);
    load_codes(vt, vc, a.rows_v, a.S, s0);
    cp_async_wait_all();
    __syncthreads();

    if constexpr (VAR == kBase) {
      for (int i = tid; i < a.rows_k * (kT / 16); i += kThreads) {
        const uint4 q = piece(kt, i);
        ck += q.x ^ q.y ^ q.z ^ q.w;
      }
      for (int i = tid; i < a.rows_v * (kT / 16); i += kThreads) {
        const uint4 q = piece(vt, i);
        ck += q.x ^ q.y ^ q.z ^ q.w;
      }
    } else if constexpr (!kMm) {
      if constexpr (kCc) {
        tile_values<VAR>(kt, a.rk, u);
        __syncthreads();
        float s = sum_assembled(u, a.rk);
        __syncthreads();
        tile_values<VAR>(vt, a.rv, u);
        __syncthreads();
        s += sum_assembled(u, a.rv);
        tot += __float2ll_rn(s);
      } else {
        tot += __float2ll_rn(tile_values<VAR>(kt, a.rk, u) + tile_values<VAR>(vt, a.rv, u));
      }
    } else {
      // ---- K: x^T (this warp's 16 tokens x rk) . B (rk x W)
      const int m0 = warp * 16, half_k = a.rk / 2;
      if constexpr (VAR == kExt4CcMm) {
        tile_values<kExt4Cc>(kt, a.rk, u);
        __syncthreads();
      }
      for (int ks = 0; ks < a.rk / 16; ++ks) {
        const int rb = ks * 16;
        uint32_t af[4];
        if constexpr (VAR == kExt4CcMm) {
          ldmatrix_x4_trans(af, u + (rb + ri + (mi >> 1) * 8) * kUS + m0 + (mi & 1) * 8);
        } else {
          const int k = rb / half_k, row = rb % half_k + 2 * ft;
          const uint8_t* c0 = kt + row * kCS + m0 + fg;
          af[0] = nib2(c0[0], c0[kCS], k);
          af[1] = nib2(c0[8], c0[kCS + 8], k);
          af[2] = nib2(c0[8 * kCS], c0[9 * kCS], k);
          af[3] = nib2(c0[8 * kCS + 8], c0[9 * kCS + 8], k);
        }
        const bf16* brow = bs + (rb + ri + (mi & 1) * 8) * WS + (mi >> 1) * 8;
#pragma unroll
        for (int j = 0; j < kMaxNT; j += 2) {
          if (j < NT) {
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, brow + j * 8);
            mma_bf16(acc_k[j], af, bf[0], bf[1]);
            mma_bf16(acc_k[j + 1], af, bf[2], bf[3]);
          }
        }
      }
      if constexpr (VAR == kExt4CcMm) {
        __syncthreads();  // K's array read: V's overwrites it
        tile_values<kExt4Cc>(vt, a.rv, u);
        __syncthreads();
      }
      // ---- V: x (16 ranks x tile) . p (tile x 8), m-tiles over the warps
      uint32_t pb[kT / 16][2];
#pragma unroll
      for (int ks = 0; ks < kT / 16; ++ks) {
        const bf16* pr = ps + (t0 + ks * 16 + 2 * ft) * 8 + fg;
        pb[ks][0] = pack_bf2(__bfloat162float(pr[0]), __bfloat162float(pr[8]));
        pb[ks][1] = pack_bf2(__bfloat162float(pr[64]), __bfloat162float(pr[72]));
      }
      const int half_v = a.rv / 2;
      for (int mt = warp; mt < a.rv / 16; mt += kWarps) {
        const int rb = mt * 16;
#pragma unroll
        for (int ks = 0; ks < kT / 16; ++ks) {
          uint32_t af[4];
          if constexpr (VAR == kExt4CcMm) {
            ldmatrix_x4(af, u + (rb + ri + (mi & 1) * 8) * kUS + ks * 16 + (mi >> 1) * 8);
          } else {
            const int k = rb / half_v, row = rb % half_v + fg;
            const uint8_t* c0 = vt + row * kCS + ks * 16 + 2 * ft;
            af[0] = nib2(c0[0], c0[1], k);
            af[1] = nib2(c0[8 * kCS], c0[8 * kCS + 1], k);
            af[2] = nib2(c0[8], c0[9], k);
            af[3] = nib2(c0[8 * kCS + 8], c0[8 * kCS + 9], k);
          }
          mma_bf16(acc_v, af, pb[ks][0], pb[ks][1]);
        }
      }
    }
    __syncthreads();  // the next tile's copies overwrite
  }

  __shared__ long long red_i[kWarps];
  __shared__ float red_f[2][kWarps];
  if constexpr (kMm) {
    float sk = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j) sk += acc_k[j][0] + acc_k[j][1] + acc_k[j][2] + acc_k[j][3];
    float sv = acc_v[0] + acc_v[1] + acc_v[2] + acc_v[3];
    sk = decode::warp_sum(sk);
    sv = decode::warp_sum(sv);
    if (lane == 0) {
      red_f[0][warp] = sk;
      red_f[1][warp] = sv;
    }
    __syncthreads();
    if (tid < 2) {
      float s = 0.0f;
      for (int w = 0; w < kWarps; ++w) s += red_f[tid][w];
      a.part_f[(static_cast<size_t>(tid) * gridDim.y + g) * gridDim.x + blk] = s;
    }
  } else {
    long long v = VAR == kBase ? static_cast<long long>(ck) : tot;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red_i[warp] = v;
    __syncthreads();
    if (tid == 0) {
      long long s = 0;
      for (int w = 0; w < kWarps; ++w) s += red_i[w];
      a.part_i[static_cast<size_t>(g) * gridDim.x + blk] = s;
    }
  }
}

__global__ void __launch_bounds__(kThreads) unpack_finish(const long long* __restrict__ part,
                                                          int n, long long* __restrict__ out) {
  __shared__ long long w_s[kWarps];
  long long s = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) s += part[i];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (threadIdx.x % 32 == 0) w_s[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long t = 0;
    for (int w = 0; w < kWarps; ++w) t += w_s[w];
    out[0] = t;
  }
}

template <int VAR>
int launch(const UpArgs& a, int G, cudaStream_t st) {
  const size_t smem = up_layout(VAR, a.rows_k, a.rows_v, a.rk, a.rv, a.W, a.BS).total;
  if (smem > decode::kSmemMax - 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(unpack_kernel<VAR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  unpack_kernel<VAR><<<dim3(a.S / a.BS, G), kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant: 0 base, 1 ext4nc, 2 ext4cc, 3 ext4mm, 4 ext4ccmm, 5 ext3nc, 6
// ext3cc, 7 conv8. kc / vc: (G, rows_k / rows_v, S) codes, rows = rank / 2
// (4-bit, base), 3 * rank / 8 (3-bit) or rank (int8). b1 (G, rk, W) and p
// (G, BS, 8) bf16 for the mm variants (4-bit codes). part_i holds G * S /
// BS totals and total one i64 (every variant but the mm ones); part_f
// (2, G, S / BS) f32 (mm). S a multiple of BS, BS of 128; rk and rv
// multiples of 32 (4-bit), of 8 (3-bit); W a multiple of 16 up to 64.
extern "C" int unpack_probe(int variant, const void* kc, const void* vc, const void* b1,
                            const void* p, void* part_i, void* part_f, void* total, int G, int rk,
                            int rv, int W, int S, int BS, void* stream) {
  if (variant < kBase || variant > kConv8 || BS <= 0 || BS % kT || S % BS || rk % 8 || rv % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool four = variant <= kExt4CcMm;
  if (four && (rk % 32 || rv % 32)) return static_cast<int>(cudaErrorInvalidValue);
  if ((variant == kExt4Mm || variant == kExt4CcMm) && (W % 16 || W > 8 * kMaxNT || W <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  UpArgs a{};
  a.kc = static_cast<const uint8_t*>(kc);
  a.vc = static_cast<const uint8_t*>(vc);
  a.b1 = static_cast<const bf16*>(b1);
  a.p = static_cast<const bf16*>(p);
  a.part_i = static_cast<long long*>(part_i);
  a.part_f = static_cast<float*>(part_f);
  a.rk = rk;
  a.rv = rv;
  a.W = W;
  a.S = S;
  a.BS = BS;
  a.rows_k = four ? rk / 2 : variant == kConv8 ? rk : 3 * rk / 8;
  a.rows_v = four ? rv / 2 : variant == kConv8 ? rv : 3 * rv / 8;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch (variant) {
    case kBase: err = launch<kBase>(a, G, st); break;
    case kExt4Nc: err = launch<kExt4Nc>(a, G, st); break;
    case kExt4Cc: err = launch<kExt4Cc>(a, G, st); break;
    case kExt4Mm: err = launch<kExt4Mm>(a, G, st); break;
    case kExt4CcMm: err = launch<kExt4CcMm>(a, G, st); break;
    case kExt3Nc: err = launch<kExt3Nc>(a, G, st); break;
    case kExt3Cc: err = launch<kExt3Cc>(a, G, st); break;
    default: err = launch<kConv8>(a, G, st); break;
  }
  if (err != 0 || variant == kExt4Mm || variant == kExt4CcMm) return err;
  unpack_finish<<<1, kThreads, 0, st>>>(static_cast<const long long*>(part_i), G * (S / BS),
                                        static_cast<long long*>(total));
  return static_cast<int>(cudaGetLastError());
}
