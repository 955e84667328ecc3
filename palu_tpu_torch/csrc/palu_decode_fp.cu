// Latent decode attention over the unquantized (bf16) latent caches and
// over the seq-major packed cache, split over the sequence (flash-decoding)
// with a second kernel that combines the splits (decode_common.cuh).
//
// Replaces: palu_tpu/ops/pallas/palu_decode.py::palu_flash_decode, the v1
// kernel over seq-major latents (B, G, S, r);
// palu_tpu/ops/pallas/palu_decode4.py::palu_flash_decode4, the v4 kernel
// over rank-major latents (B, G, r, S); and
// palu_tpu/ops/pallas/palu_decode.py::palu_flash_decode_quantized, the v1
// kernel over seq-major packed codes (B, G, S, nbytes) with per-token
// scale and base (B, G, S, 1). One kernel template serves the three; only
// the tile load (and, for codes, the per-token scales) differ. The two
// latent variants take the v4 kernel's pre-RoPE K bias (k_bias, Qwen2);
// JAX's engine runs the seq-major cache with a bias through its XLA
// fallback, flash_decode_latent, which this kernel computes all the same.
//
// What it computes, per lane b, group g and q-head h of the group:
//   K_h(s) = B_h^T x_k(s) [+ b_h, the K bias, added before RoPE]
//   logit(s) = q_h . RoPE_s(K_h(s)) / sqrt(hd), masked by kv_len and window
//   out_h = sum_s softmax(logit)(s) x_v(s)
// -> (B, nh, rv) f32 in latent space (o_proj is U_v-fused).
//
// Bound on this card: the latents are (rk + rv) * 2 bytes per token and
// group (67 MB per layer at 8K tokens of the 7B shapes: 20 us at 3.35
// TB/s), the K rebuild 2 * nh * rk * hd flops per token (8.6 GFLOP, 9 us
// on the bf16 tensor cores): bound by bytes, where the packed cache of
// palu_decode.cu is bound by operations. The rebuild runs on the tensor
// cores all the same (on the f32 pipes it would take ~130 us).
//
// The packed variant (QUANT) dequantizes in its tile load: each thread
// reads 4-byte words of a token's packed row (a 64-token tile is one
// contiguous run of 64 * nbytes bytes; exact 3-bit reads the matching word
// of the 1-bit plane too), unpacks them in registers and writes the values
// code + q_min - base(s), formed in f32 and rounded once to bf16 (exact for
// the integer base that quantize gives), into the same bf16 tile the
// latent variants fill. The per-token scale multiplies the f32 K
// accumulators before RoPE and folds into p on the V side, so K and V are
// exact up to f32 summation order. At 3 bits the packed tile is 208 bytes
// per token and group against 1024 for bf16 latents: the K rebuild (2 * nh
// * rk * hd flops per token, 8.6 GFLOP per layer at 8K) bounds it.
//
// Design: the split pass of palu_decode.cu without the unpack and the
// per-token scales. Grid (splits, G, B), 8 warps, about one block per SM.
// A block stages the B_h of its group's heads in shared memory once with
// cp.async (in chunks of heads when they do not all fit), then walks its
// tiles of 64 tokens. Each tile of K and V latents comes into shared memory
// with 16-byte cp.async copies in the cache's own layout, so global reads
// stay coalesced: rank-major as r rows of 64 tokens (128 B, padded to 144 B
// so ldmatrix rows fall on distinct banks), seq-major as 64 rows of r ranks
// (padded by 16 B). ldmatrix (.trans for rank-major) turns the K tile into
// the mma A operand x^T (16 tokens x 16 ranks) directly. Per head, K (64
// tokens x hd) = x^T . B_h runs as mma.sync m16n8k16 (bf16 in, f32
// accumulate): warp w takes 16 tokens and matching quarters of both halves
// of hd, so both halves of each RoPE pair sit in one thread's
// accumulators; RoPE and the q dot run on them in registers and quad
// shuffles finish each partial logit. Ranks above 128 (up to 512, a G-LRD
// group's rank at group size 4 and hd 128) run in rank chunks of at most
// 128 ranks: the latent tiles hold every rank, the chunk's rows of B stream
// through the B buffer per tile (B of 4 heads at rk 512 is 512 KB), and the
// chunks' partial logits add up in f32 (RoPE and the q dot are linear in
// K). When all of B fits it is staged once per block. Each
// thread reads the f32 cos/sin of its two tokens and its dims straight into
// registers (the tables the wrapper built exactly as the plain version
// does); staging them in shared memory would not leave room for the 48 KB
// V tile at rv 384 beside four heads of B. Each head keeps (m, l) and a
// latent accumulator (rv) in shared memory; a thread per rank reads its 64
// V values once per tile and contracts them against p for every head.
// Blocks past kv_len (or before the window) do no tile work. Nothing
// allocates here: the wrapper hands in the partials.
//
// The dissection (palu_decode_fp_dissect; port of
// tools/tpu_dissect.py::call, the TPU tool that splits the v1 kernel's
// time): the split kernel's MODE removes parts of the seq-major bf16
// variant, so that each mode times the kernel that serves, minus a part.
// kFull (0) is the production instantiation itself. kNoValue drops the V
// contraction and emits each head's softmax statistics (m, l). kNoLogits
// replaces the B staging, the K rebuild and the q dot with the tool's fake
// logits, 1e-6 times the sum over ranks of each token's x_k, and keeps the
// value path (the TPU block holds every group and sums group 0's x_k; a
// block here holds one group and sums its own). kDmaOnly keeps the
// cp.async tile loads and adds every staged element's 16-bit pattern into
// an exact checksum; kNoop keeps the tile loads and folds each 16-byte
// piece once (the XOR of its four words) into the checksum, as the TPU
// kept its BlockSpec copies in its noop (a grid with no loads would time
// only the launch). The four cut modes stage no B and read no RoPE rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"

namespace {

using decode::al;
using decode::cp_async16;
using decode::cp_async_wait_all;
using decode::kSmemMax;
using decode::ldmatrix_x4;
using decode::ldmatrix_x4_trans;
using decode::mma_bf16;
using decode::warp_max;
using decode::warp_sum;
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;      // tokens per tile
constexpr int kThreads = 256;  // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeads = 32;  // q-heads per group (Qwen2-7B: 28 over one kv group of 4)
constexpr int kMaxKSteps = 8;  // k-steps of one rank chunk held in registers
constexpr int kRc = 16 * kMaxKSteps;  // the largest rank chunk, 128
constexpr int kMaxRank = 512;  // rk limit: a G-LRD group's rank at hd 128, group 4
// padded rows (16 bytes) of the rank-major tiles, the seq-major tiles and
// B, so the eight row addresses of one ldmatrix fall on distinct banks
constexpr int kCk = kTile + 8;
constexpr int kPad = 8;
constexpr int kBPad = 8;

// dissection modes of the split kernel (kFull: production)
constexpr int kFull = 0, kNoValue = 1, kNoLogits = 2, kDmaOnly = 3, kNoop = 4;

struct FpArgs {
  const void* q;      // (B, nh, hd) bf16 or f32, roped at the current position
  int q_bf16;
  const bf16* bk;     // (G, hpg, rk, hd)
  const bf16* xk;     // (B, G, S, rk) seq-major or (B, G, rk, S) rank-major
  const bf16* xv;     // (B, G, S, rv) or (B, G, rv, S)
  const uint8_t* kc;  // packed variant: (B, G, S, nbk) codes
  const uint8_t* vc;  // (B, G, S, nbv)
  const float* ks;    // (B, G, S) per-token scale and base
  const float* kb;
  const float* vs;
  const float* vb;
  const int* kv_len;  // (B,)
  const float* cos_t; // (S, hd/2)
  const float* sin_t;
  const float* kbias; // (G, hpg, hd) f32 pre-RoPE K bias, or null
  float* part_m;      // (B, nh, splits)
  float* part_l;
  float* part_acc;    // (B, nh, splits, rv)
  unsigned long long* part_ck;  // dissection: (B, G, splits) checksums
  int G, hpg, rk, rv, S, window;
  int nbk, nbv, pbits, qmin;  // packed variant
  int splits, tiles_per_split, chunk_heads;
  int rc;             // ranks of B per chunk (rk when one chunk)
  float sqrt_hd;
};

// Elements of one latent tile in shared memory (rows padded).
__host__ __device__ inline size_t tile_elems(bool rm, int r) {
  return rm ? static_cast<size_t>(r) * kCk : static_cast<size_t>(kTile) * (r + kPad);
}

// Byte offsets of the split kernel's shared-memory regions (one place for
// the kernel's carve and the launcher's size); `chunk` heads of `rc` rows
// of B staged.
struct FpLayout {
  size_t bsm, kt, vt, q, acc, lg, pw, red, stat, sc, total;
};

__host__ __device__ inline FpLayout fp_layout(bool rm, int rk, int hd, int hpg, int rv,
                                              int chunk, bool quant, int rc) {
  FpLayout L;
  size_t off = 0;
  L.bsm = off;  off = al(off + sizeof(bf16) * chunk * rc * (hd + kBPad));
  L.kt = off;   off = al(off + sizeof(bf16) * tile_elems(rm, rk));
  L.vt = off;   off = al(off + sizeof(bf16) * tile_elems(rm, rv));
  L.q = off;    off = al(off + sizeof(float) * hpg * hd);
  L.acc = off;  off = al(off + sizeof(float) * hpg * rv);
  L.lg = off;   off = al(off + sizeof(float) * hpg * kTile);
  L.pw = off;   off = al(off + sizeof(float) * hpg * kTile);
  L.red = off;  off = al(off + sizeof(float) * 4 * kTile);
  L.stat = off; off = al(off + sizeof(float) * 3 * kMaxHeads);
  L.sc = off;   off = al(off + (quant ? sizeof(float) * 2 * kTile : 0));
  L.total = off;
  return L;
}

// cp.async the latent tile of tokens [s0, s0 + kTile) of one (b, g) plane
// with `rows` ranks into shared memory: rank-major as [rank][token]
// (stride kCk), seq-major as [token][rank] (stride rows + kPad). Tokens at
// or past S are zero (S and rows are multiples of 8, so a 16-byte piece is
// wholly in or out).
template <bool RM>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int rows, int S, int s0,
                                          int tid) {
  if (RM) {
    constexpr int kVec = kTile / 8;  // 16-byte pieces per rank row
    for (int i = tid; i < rows * kVec; i += kThreads) {
      const int r = i / kVec, c = i % kVec, s = s0 + c * 8;
      bf16* d = dst + r * kCk + c * 8;
      if (s < S)
        cp_async16(d, src + static_cast<size_t>(r) * S + s);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  } else {
    const int vec = rows / 8;  // 16-byte pieces per token row
    for (int i = tid; i < kTile * vec; i += kThreads) {
      const int t = i / vec, c = i % vec, s = s0 + t;
      bf16* d = dst + t * (rows + kPad) + c * 8;
      if (s < S)
        cp_async16(d, src + static_cast<size_t>(s) * rows + c * 8);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  }
}

// Dequantize the packed seq-major tile of tokens [s0, s0 + kTile) of one
// (b, g) plane with r ranks (nb bytes per token) into dst [token][rank]
// (stride r + kPad) as bf16 integers code + qmin - base(s). Field k of
// byte j of the main plane (field width pw, w = r / (8 / pw) bytes) holds
// rank j + k * w; exact 3-bit adds bit (j / w1) + 2k of byte j % w1 of the
// 1-bit plane (w1 = r / 8 bytes, after the main plane) as the code's bit 2.
// One thread per 4-byte word of the main plane; tokens at or past S are 0.
__device__ __forceinline__ void unpack_tile(bf16* dst, const uint8_t* src, const float* base,
                                            int r, int nb, int pbits, int qmin, int S, int s0,
                                            int tid) {
  const int pw = pbits == 3 ? 2 : pbits;
  const int nf = 8 / pw, w = r / nf, w1 = r / 8, nw = w / 4;
  const uint32_t mask = (1u << pw) - 1;
  for (int i = tid; i < kTile * nw; i += kThreads) {
    const int t = i / nw, j = (i % nw) * 4, s = s0 + t;
    bf16* d = dst + t * (r + kPad) + j;
    uint32_t lo = 0, hi = 0;
    int hs = 0;
    float off = 0.0f;
    const bool in = s < S;
    if (in) {
      const uint8_t* row = src + static_cast<size_t>(s) * nb;
      lo = *reinterpret_cast<const uint32_t*>(row + j);
      if (pbits == 3) {
        hi = *reinterpret_cast<const uint32_t*>(row + w + j % w1);
        hs = j / w1;
      }
      off = static_cast<float>(qmin) - base[s];
    }
    for (int k = 0; k < nf; ++k) {
      float v[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        uint32_t c = (lo >> (8 * b + pw * k)) & mask;
        if (pbits == 3) c |= ((hi >> (8 * b + hs + 2 * k)) & 1u) << 2;
        v[b] = in ? static_cast<float>(c) + off : 0.0f;
      }
      __nv_bfloat162 p0 = __floats2bfloat162_rn(v[0], v[1]);
      __nv_bfloat162 p1 = __floats2bfloat162_rn(v[2], v[3]);
      uint2 u;
      u.x = *reinterpret_cast<uint32_t*>(&p0);
      u.y = *reinterpret_cast<uint32_t*>(&p1);
      *reinterpret_cast<uint2*>(d + k * w) = u;
    }
  }
}

// Fold every 16-byte piece this thread copied into the seq-major tile of
// `rows` ranks (load_tile's index pattern, so no barrier is needed): the
// pieces' 16-bit patterns summed (kDmaOnly) or the XOR of their words
// (kNoop). Zero-filled pieces past S add 0.
template <int MODE>
__device__ __forceinline__ unsigned long long fold_tile(const bf16* src, int rows, int tid) {
  const int vec = rows / 8;
  unsigned long long ck = 0;
  for (int i = tid; i < kTile * vec; i += kThreads) {
    const int t = i / vec, c = i % vec;
    const uint4 u = *reinterpret_cast<const uint4*>(src + t * (rows + kPad) + c * 8);
    if (MODE == kNoop) {
      ck += u.x ^ u.y ^ u.z ^ u.w;
    } else {
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) ck += (w[k] & 0xffffu) + (w[k] >> 16);
    }
  }
  return ck;
}

// BIAS compiles the K bias in (a.kbias set; the latent variants only).
// MODE is kFull except in the dissection (seq-major bf16 latents only).
template <int HD, bool RM, bool QUANT, bool BIAS, int MODE = kFull>
__global__ void __launch_bounds__(kThreads) palu_decode_fp_split_kernel(FpArgs a) {
  static_assert(MODE == kFull || (!RM && !QUANT && !BIAS), "dissection: seq-major bf16 only");
  constexpr bool kRebuild = MODE == kFull || MODE == kNoValue;  // K rebuilt, q dotted
  constexpr bool kStream = MODE == kDmaOnly || MODE == kNoop;   // loads only
  constexpr int half = HD / 2;
  constexpr int HS = HD + kBPad;  // B row stride
  constexpr int NTH = HD / 16;    // 8-wide column tiles per half of hd
  constexpr int NTW = NTH / 2;    // ... per warp (two warps share 16 tokens)
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int fg = lane / 4, ft = lane % 4;  // mma fragment row group / column pair
  const int mi = lane / 8, ri = lane % 8;  // ldmatrix tile / row of this lane
  const int hpg = a.hpg, rk = a.rk, rv = a.rv;
  const int nh = a.G * hpg;
  const int m0 = (warp & 3) * 16;    // this warp's 16 tokens of the tile
  const int jw = (warp >> 2) * NTW;  // its first column tile in each half of hd
  const int kstride = RM ? kCk : rk + kPad;  // K tile row stride (elements)

  extern __shared__ __align__(128) unsigned char smem[];
  const FpLayout L = fp_layout(RM, rk, HD, hpg, rv, a.chunk_heads, QUANT, a.rc);
  const int rc = a.rc, nrc = (rk + rc - 1) / rc;          // rank chunks of B
  bf16* bsm = reinterpret_cast<bf16*>(smem + L.bsm);     // [chunk][rc][HS]
  bf16* kt = reinterpret_cast<bf16*>(smem + L.kt);       // K latent tile
  bf16* vt = reinterpret_cast<bf16*>(smem + L.vt);       // V latent tile
  float* q_s = reinterpret_cast<float*>(smem + L.q);     // [hpg][hd]
  float* acc_s = reinterpret_cast<float*>(smem + L.acc); // [hpg][rv]
  float* lg = reinterpret_cast<float*>(smem + L.lg);     // [hpg][kTile] logits
  float* pw = reinterpret_cast<float*>(smem + L.pw);     // [hpg][kTile] p
  float* red = reinterpret_cast<float*>(smem + L.red);   // [head parity][warp half][kTile]
  float* stat = reinterpret_cast<float*>(smem + L.stat); // [3][kMaxHeads]: m, l, alpha
  float* sc_k = reinterpret_cast<float*>(smem + L.sc);   // [kTile] K scales (packed)
  float* sc_v = sc_k + kTile;                            // [kTile] V scales
  float* m_s = stat;
  float* l_s = stat + kMaxHeads;
  float* alpha_s = stat + 2 * kMaxHeads;

  const size_t bg = static_cast<size_t>(b) * a.G + g;
  const bf16* xk = QUANT ? nullptr : a.xk + bg * rk * a.S;
  const bf16* xv = QUANT ? nullptr : a.xv + bg * rv * a.S;
  const uint8_t* kc = QUANT ? a.kc + bg * a.nbk * a.S : nullptr;
  const uint8_t* vc = QUANT ? a.vc + bg * a.nbv * a.S : nullptr;
  const bf16* bk_g = a.bk + static_cast<size_t>(g) * hpg * rk * HD;
  const float* kb_g = BIAS ? a.kbias + static_cast<size_t>(g) * hpg * HD : nullptr;

  for (int i = tid; i < hpg * HD; i += kThreads) {
    const size_t qi = (static_cast<size_t>(b) * nh + g * hpg) * HD + i;
    q_s[i] = a.q_bf16 ? __bfloat162float(static_cast<const bf16*>(a.q)[qi])
                      : static_cast<const float*>(a.q)[qi];
  }
  for (int i = tid; i < hpg * rv; i += kThreads) acc_s[i] = 0.0f;
  if (tid < kMaxHeads) {
    m_s[tid] = -1e30f;
    l_s[tid] = 0.0f;
    alpha_s[tid] = 1.0f;
  }

  const int kvl = a.kv_len[b];
  const int lo_pos = a.window > 0 ? max(0, kvl - a.window) : 0;
  const int tile_lo = lo_pos / kTile;
  const int tile_hi = (min(kvl, a.S) + kTile - 1) / kTile;
  const int t_begin = max(split * a.tiles_per_split, tile_lo);
  const int t_end = min((split + 1) * a.tiles_per_split, tile_hi);
  const int tok_a = m0 + fg, tok_b = tok_a + 8;  // accumulator rows of this lane

  unsigned long long ck = 0;  // kDmaOnly / kNoop checksum

  // heads in chunks whose B fits in shared memory (one chunk when all fit);
  // each chunk walks the block's tiles
  for (int c0 = 0; c0 < hpg && t_begin < t_end; c0 += a.chunk_heads) {
    const int nc = min(a.chunk_heads, hpg - c0);
    __syncthreads();  // set-up done / the previous chunk's B reads done
    if (kRebuild && nrc == 1) {  // all of B fits: staged once
      for (int i = tid; i < nc * rk * (HD / 8); i += kThreads) {
        const int row = i / (HD / 8), c = i % (HD / 8);  // row = head * rk + rank
        cp_async16(bsm + row * HS + c * 8,
                   bk_g + (static_cast<size_t>(c0) * rk + row) * HD + c * 8);
      }
      cp_async_wait_all();
      __syncthreads();
    }

    for (int tile = t_begin; tile < t_end; ++tile) {
      const int s0 = tile * kTile;
      // ---- load: K and V latent tiles (cp.async), this thread's rope rows
      if constexpr (QUANT) {
        unpack_tile(kt, kc, a.kb + bg * a.S, rk, a.nbk, a.pbits, a.qmin, a.S, s0, tid);
        unpack_tile(vt, vc, a.vb + bg * a.S, rv, a.nbv, a.pbits, a.qmin, a.S, s0, tid);
        if (tid < kTile) {
          const int s = s0 + tid;
          sc_k[tid] = s < a.S ? a.ks[bg * a.S + s] : 0.0f;
          sc_v[tid] = s < a.S ? a.vs[bg * a.S + s] : 0.0f;
        }
      } else {
        load_tile<RM>(kt, xk, rk, a.S, s0, tid);
        load_tile<RM>(vt, xv, rv, a.S, s0, tid);
      }
      float ca[NTW][2], sa[NTW][2], cb[NTW][2], sb[NTW][2];
      if constexpr (kRebuild) {
        const int pa = s0 + tok_a, pb = s0 + tok_b;
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          const int d = (jw + j) * 8 + 2 * ft;
          float2 c = make_float2(0.f, 0.f), s = c, c2 = c, s2 = c;
          if (pa < a.S) {
            c = *reinterpret_cast<const float2*>(a.cos_t + static_cast<size_t>(pa) * half + d);
            s = *reinterpret_cast<const float2*>(a.sin_t + static_cast<size_t>(pa) * half + d);
          }
          if (pb < a.S) {
            c2 = *reinterpret_cast<const float2*>(a.cos_t + static_cast<size_t>(pb) * half + d);
            s2 = *reinterpret_cast<const float2*>(a.sin_t + static_cast<size_t>(pb) * half + d);
          }
          ca[j][0] = c.x;  ca[j][1] = c.y;  sa[j][0] = s.x;  sa[j][1] = s.y;
          cb[j][0] = c2.x; cb[j][1] = c2.y; sb[j][0] = s2.x; sb[j][1] = s2.y;
        }
      }
      cp_async_wait_all();
      __syncthreads();

      if constexpr (kStream) {
        ck += fold_tile<MODE>(kt, rk, tid) + fold_tile<MODE>(vt, rv, tid);
        __syncthreads();  // as after the V contraction: the next loads overwrite
        continue;
      }

      if constexpr (MODE == kNoLogits) {
        // fake logits: 1e-6 * sum over ranks of x_k, four threads per token
        const int t = tid / 4, part = tid % 4;
        float cs = 0.0f;
        for (int r = part; r < rk; r += 4) cs += __bfloat162float(kt[t * kstride + r]);
        cs += __shfl_xor_sync(0xffffffffu, cs, 1);
        cs += __shfl_xor_sync(0xffffffffu, cs, 2);
        if (part == 0)
          for (int h = c0; h < c0 + nc; ++h) lg[h * kTile + t] = cs * 1e-6f;
      }

      // packed: the per-token scales of this lane's two rows
      const float ska = QUANT ? sc_k[tok_a] : 1.0f, skb = QUANT ? sc_k[tok_b] : 1.0f;

      for (int ci = 0; ci < (kRebuild ? nrc : 0); ++ci) {
        // ---- rank chunk ci: ranks [r0, r0 + nr)
        const int r0 = ci * rc, nr = min(rc, rk - r0), nkc = nr / 16;
        if (nrc > 1) {  // stream this chunk's rows of B for the chunk's heads
          if (ci > 0) __syncthreads();  // the previous chunk's reads of B done
          const int per_head = nr * (HD / 8);
          for (int i = tid; i < nc * per_head; i += kThreads) {
            const int hh = i / per_head, row = (i % per_head) / (HD / 8), c = i % (HD / 8);
            cp_async16(bsm + (hh * rc + row) * HS + c * 8,
                       bk_g + (static_cast<size_t>(c0 + hh) * rk + r0 + row) * HD + c * 8);
          }
          cp_async_wait_all();
          __syncthreads();
        }

        // A fragments: x_k^T (16 tokens x 16 ranks) per k-step, shared by the
        // heads; a rank-major tile is stored [rank][token], hence .trans
        uint32_t af[kMaxKSteps][4];
#pragma unroll
        for (int ks = 0; ks < kMaxKSteps; ++ks) {
          if (ks < nkc) {
            const int rr = r0 + ks * 16;
            if (RM)
              ldmatrix_x4_trans(af[ks],
                                kt + (rr + ri + (mi >> 1) * 8) * kCk + m0 + (mi & 1) * 8);
            else
              ldmatrix_x4(af[ks],
                          kt + (m0 + ri + (mi & 1) * 8) * kstride + rr + (mi >> 1) * 8);
          }
        }

        // ---- per head: K_h (tokens x hd) = x_k^T B_h, then RoPE + q . K
        for (int hc = 0; hc < nc; ++hc) {
          const int h = c0 + hc;
          const bf16* bh = bsm + static_cast<size_t>(hc) * rc * HS;
          // acc[j]: column tile jw + j (first half of hd); acc[NTW + j]: tile
          // NTH + jw + j, its RoPE partner in the second half
          float acc[2 * NTW][4];
#pragma unroll
          for (int j = 0; j < 2 * NTW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
          for (int ks = 0; ks < kMaxKSteps; ++ks) {
            if (ks < nkc) {
              const bf16* brow = bh + (ks * 16 + ri + (mi & 1) * 8) * HS + (mi >> 1) * 8;
#pragma unroll
              for (int p = 0; p < NTW; p += 2) {
                uint32_t bf[4];
                ldmatrix_x4_trans(bf, brow + (jw + p) * 8);
                mma_bf16(acc[p], af[ks], bf[0], bf[1]);
                mma_bf16(acc[p + 1], af[ks], bf[2], bf[3]);
                ldmatrix_x4_trans(bf, brow + (NTH + jw + p) * 8);
                mma_bf16(acc[NTW + p], af[ks], bf[0], bf[1]);
                mma_bf16(acc[NTW + p + 1], af[ks], bf[2], bf[3]);
              }
            }
          }
          const float* qh = q_s + h * HD;
          const float* kbh = BIAS ? kb_g + static_cast<size_t>(h) * HD : nullptr;
          float part_a = 0.0f, part_b = 0.0f;
#pragma unroll
          for (int j = 0; j < NTW; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int d = (jw + j) * 8 + 2 * ft + e;
              const float q1 = qh[d], q2 = qh[d + half];
              float k1 = acc[j][e], k2 = acc[NTW + j][e];
              float l1 = acc[j][e + 2], l2 = acc[NTW + j][e + 2];
              if constexpr (QUANT) {
                k1 *= ska;
                k2 *= ska;
                l1 *= skb;
                l2 *= skb;
              }
              if (BIAS && ci == 0) {  // the K bias, pre-RoPE, once per token
                const float b1 = __ldg(kbh + d), b2 = __ldg(kbh + d + half);
                k1 += b1;
                k2 += b2;
                l1 += b1;
                l2 += b2;
              }
              part_a += q1 * (k1 * ca[j][e] - k2 * sa[j][e]) + q2 * (k2 * ca[j][e] + k1 * sa[j][e]);
              part_b += q1 * (l1 * cb[j][e] - l2 * sb[j][e]) + q2 * (l2 * cb[j][e] + l1 * sb[j][e]);
            }
          }
          part_a += __shfl_xor_sync(0xffffffffu, part_a, 1);
          part_a += __shfl_xor_sync(0xffffffffu, part_a, 2);
          part_b += __shfl_xor_sync(0xffffffffu, part_b, 1);
          part_b += __shfl_xor_sync(0xffffffffu, part_b, 2);
          // two warps hold each token's partial logits; buffers alternate by
          // head parity so one barrier per head suffices
          float* rh = red + ((hc & 1) * 2 + (warp >> 2)) * kTile;
          if (ft == 0) {
            rh[tok_a] = part_a;
            rh[tok_b] = part_b;
          }
          __syncthreads();
          if (tid < kTile) {
            const float* r2 = red + (hc & 1) * 2 * kTile;
            const float part = (r2[tid] + r2[kTile + tid]) / a.sqrt_hd;
            lg[h * kTile + tid] = ci == 0 ? part : lg[h * kTile + tid] + part;
          }
        }
      }  // rank chunks
      __syncthreads();

      // ---- online softmax, one warp per head
      for (int h = c0 + warp; h < c0 + nc; h += kWarps) {
        float e[2], x[2];
        bool ok[2];
        float mx = -1e30f;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int t = lane + 32 * u, s = s0 + t;
          ok[u] = s < kvl && s < a.S && (a.window <= 0 || s > kvl - 1 - a.window);
          x[u] = ok[u] ? lg[h * kTile + t] : -1e30f;
          mx = fmaxf(mx, x[u]);
        }
        mx = warp_max(mx);
        const float m_old = m_s[h];
        const float m_new = fmaxf(m_old, mx);
        const float alpha = expf(m_old - m_new);
        float sum = 0.0f;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int t = lane + 32 * u;
          e[u] = ok[u] ? expf(x[u] - m_new) : 0.0f;
          sum += e[u];
          pw[h * kTile + t] = QUANT ? e[u] * sc_v[t] : e[u];
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          m_s[h] = m_new;
          l_s[h] = l_s[h] * alpha + sum;
          alpha_s[h] = alpha;
        }
      }
      __syncthreads();

      // ---- latent V: acc[h][r] = acc * alpha + sum_t p[h][t] x_v[t][r]
      for (int r = tid; r < (MODE == kNoValue ? 0 : rv); r += kThreads) {
        float cv[kTile];
        if (RM) {
          const uint4* row = reinterpret_cast<const uint4*>(vt + r * kCk);
#pragma unroll
          for (int c = 0; c < kTile / 8; ++c) {
            const uint4 u = row[c];
            const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float2 f = __bfloat1622float2(p2[k]);
              cv[c * 8 + 2 * k] = f.x;
              cv[c * 8 + 2 * k + 1] = f.y;
            }
          }
        } else {
#pragma unroll
          for (int t = 0; t < kTile; ++t) cv[t] = __bfloat162float(vt[t * (rv + kPad) + r]);
        }
        for (int h = c0; h < c0 + nc; ++h) {
          float acc = acc_s[h * rv + r] * alpha_s[h];
          const float* ph = pw + h * kTile;
#pragma unroll
          for (int t = 0; t < kTile; ++t) acc += ph[t] * cv[t];
          acc_s[h * rv + r] = acc;
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();

  if constexpr (kStream) {  // the block's checksum
    for (int o = 16; o > 0; o >>= 1) ck += __shfl_xor_sync(0xffffffffu, ck, o);
    unsigned long long* ck_w = reinterpret_cast<unsigned long long*>(red);
    if (lane == 0) ck_w[warp] = ck;
    __syncthreads();
    if (tid == 0) {
      unsigned long long s = 0;
      for (int w = 0; w < kWarps; ++w) s += ck_w[w];
      a.part_ck[bg * a.splits + split] = s;
    }
    return;
  }
  const size_t head0 = static_cast<size_t>(b) * nh + g * hpg;
  for (int i = tid; i < (MODE == kNoValue ? 0 : hpg * rv); i += kThreads) {
    const int h = i / rv, r = i % rv;
    a.part_acc[((head0 + h) * a.splits + split) * rv + r] = acc_s[i];
  }
  if (tid < hpg) {
    a.part_m[(head0 + tid) * a.splits + split] = m_s[tid];
    a.part_l[(head0 + tid) * a.splits + split] = l_s[tid];
  }
}

template <int HD, bool RM, bool QUANT, bool BIAS = false, int MODE = kFull>
int launch_split(const FpArgs& a, int B, cudaStream_t st) {
  const size_t smem = fp_layout(RM, a.rk, HD, a.hpg, a.rv, a.chunk_heads, QUANT, a.rc).total;
  cudaError_t err = cudaFuncSetAttribute(palu_decode_fp_split_kernel<HD, RM, QUANT, BIAS, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  palu_decode_fp_split_kernel<HD, RM, QUANT, BIAS, MODE>
      <<<dim3(a.splits, a.G, B), kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The dissection's second pass. kNoValue: per (lane, q-head) row, the
// splits' statistics merged, out[row] = (M, L) with M = max m_s and
// L = sum_s e^(m_s - M) l_s. kDmaOnly / kNoop: one block adds the n block
// checksums into ck_out[0].
__global__ void __launch_bounds__(256) dissect_finish(const float* __restrict__ part_m,
                                                      const float* __restrict__ part_l,
                                                      const unsigned long long* __restrict__ ck,
                                                      float* __restrict__ stats,
                                                      unsigned long long* __restrict__ ck_out,
                                                      int rows, int splits, int n_ck) {
  if (ck != nullptr) {
    __shared__ unsigned long long w_s[8];
    unsigned long long s = 0;
    for (int i = threadIdx.x; i < n_ck; i += blockDim.x) s += ck[i];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (threadIdx.x % 32 == 0) w_s[threadIdx.x / 32] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long t = 0;
      for (int w = 0; w < 8; ++w) t += w_s[w];
      ck_out[0] = t;
    }
    return;
  }
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const float* m = part_m + static_cast<size_t>(row) * splits;
  const float* l = part_l + static_cast<size_t>(row) * splits;
  float mx = -1e30f;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, m[s]);
  float den = 0.0f;
  for (int s = 0; s < splits; ++s) den += expf(m[s] - mx) * l[s];
  stats[2 * row] = mx;
  stats[2 * row + 1] = den;
}

// The latent variants: rank-major or seq-major, with or without the K bias.
template <int HD>
int launch_latent(const FpArgs& a, bool rm, int B, cudaStream_t st) {
  if (a.kbias)
    return rm ? launch_split<HD, true, false, true>(a, B, st)
              : launch_split<HD, false, false, true>(a, B, st);
  return rm ? launch_split<HD, true, false>(a, B, st) : launch_split<HD, false, false>(a, B, st);
}

// Heads of B that fit in shared memory beside the rest, and the rank chunk
// (a.rc): up to 128 ranks, fewer when not even one head's 128 rows fit;
// a.chunk_heads is 0 when nothing fits.
void fit_heads(FpArgs& a, bool rm, int hd, bool quant) {
  const int rcs[4] = {min(a.rk, kRc), 64, 32, 16};
  a.chunk_heads = 0;
  for (int k = 0; k < 4 && a.chunk_heads == 0; ++k) {
    if (k > 0 && rcs[k] >= rcs[0]) continue;
    a.rc = rcs[k];
    a.chunk_heads = a.hpg;
    while (a.chunk_heads > 0 &&
           fp_layout(rm, a.rk, hd, a.hpg, a.rv, a.chunk_heads, quant, a.rc).total > kSmemMax)
      --a.chunk_heads;
  }
}

}  // namespace

// Shapes in the comments of FpArgs; rank_major selects the latent layout;
// out (B, nh, rv) f32. The partial buffers hold B * nh * splits (m, l) and
// B * nh * splits * rv accumulators. hd is 64 or 128, rk a multiple of 16
// up to 512, rv and S multiples of 8. kbias is null or the (G, hpg, hd) f32
// pre-RoPE K bias.
extern "C" int palu_decode_fp(const void* q, int q_bf16, const void* bk, const void* xk,
                              const void* xv, const void* kv_len, const void* cos_t,
                              const void* sin_t, const void* kbias, void* part_m, void* part_l,
                              void* part_acc, void* out, int B, int G, int hpg, int hd, int rk,
                              int rv, int S,
                              int rank_major, int window, int splits, int tiles_per_split,
                              float sqrt_hd, void* stream) {
  if ((hd != 64 && hd != 128) || rk % 16 || rk > kMaxRank || rv % 8 || S % 8 ||
      hpg > kMaxHeads)
    return static_cast<int>(cudaErrorInvalidValue);
  FpArgs a{};
  a.q = q;
  a.q_bf16 = q_bf16;
  a.bk = static_cast<const bf16*>(bk);
  a.xk = static_cast<const bf16*>(xk);
  a.xv = static_cast<const bf16*>(xv);
  a.kv_len = static_cast<const int*>(kv_len);
  a.cos_t = static_cast<const float*>(cos_t);
  a.sin_t = static_cast<const float*>(sin_t);
  a.kbias = static_cast<const float*>(kbias);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.part_acc = static_cast<float*>(part_acc);
  a.G = G;
  a.hpg = hpg;
  a.rk = rk;
  a.rv = rv;
  a.S = S;
  a.window = window;
  a.splits = splits;
  a.tiles_per_split = tiles_per_split;
  a.sqrt_hd = sqrt_hd;
  // as many heads' B in shared memory as fit beside the rest
  const bool rm = rank_major != 0;
  fit_heads(a, rm, hd, false);
  if (a.chunk_heads == 0) return static_cast<int>(cudaErrorInvalidValue);

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = hd == 128 ? launch_latent<128>(a, rm, B, st) : launch_latent<64>(a, rm, B, st);
  if (err != 0) return err;
  return decode::launch_combine(a.part_m, a.part_l, a.part_acc, static_cast<float*>(out),
                                B * G * hpg, splits, rv, st);
}

// The dissection of palu_decode_fp over seq-major bf16 latents (no bias, no
// window), in the same split grid: mode 0 (kFull) launches the production
// kernel and combine, so its out (B, nh, rv) f32 is palu_decode_fp's;
// kNoLogits also writes out. kNoValue writes stats (B, nh, 2) f32 = (m, l);
// kDmaOnly / kNoop write the checksum ck_out (one u64) from part_ck (B * G
// * splits). Every head's B must fit in shared memory in one rank chunk
// (rk <= 128), so each block walks its tiles once.
extern "C" int palu_decode_fp_dissect(int mode, const void* q, int q_bf16, const void* bk,
                                      const void* xk, const void* xv, const void* kv_len,
                                      const void* cos_t, const void* sin_t, void* part_m,
                                      void* part_l, void* part_acc, void* part_ck, void* out,
                                      void* stats, void* ck_out, int B, int G, int hpg, int hd,
                                      int rk, int rv, int S, int splits, int tiles_per_split,
                                      float sqrt_hd, void* stream) {
  if ((hd != 64 && hd != 128) || rk % 16 || rk > kRc || rv % 8 || S % 8 || hpg > kMaxHeads ||
      mode < kFull || mode > kNoop)
    return static_cast<int>(cudaErrorInvalidValue);
  FpArgs a{};
  a.q = q;
  a.q_bf16 = q_bf16;
  a.bk = static_cast<const bf16*>(bk);
  a.xk = static_cast<const bf16*>(xk);
  a.xv = static_cast<const bf16*>(xv);
  a.kv_len = static_cast<const int*>(kv_len);
  a.cos_t = static_cast<const float*>(cos_t);
  a.sin_t = static_cast<const float*>(sin_t);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ck = static_cast<unsigned long long*>(part_ck);
  a.G = G;
  a.hpg = hpg;
  a.rk = rk;
  a.rv = rv;
  a.S = S;
  a.splits = splits;
  a.tiles_per_split = tiles_per_split;
  a.sqrt_hd = sqrt_hd;
  fit_heads(a, false, hd, false);
  if (a.chunk_heads != hpg) return static_cast<int>(cudaErrorInvalidValue);

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
#define PALU_DISSECT(M)                                                               \
  (hd == 128 ? launch_split<128, false, false, false, M>(a, B, st)                  \
             : launch_split<64, false, false, false, M>(a, B, st))
  switch (mode) {
    case kFull: err = PALU_DISSECT(kFull); break;
    case kNoValue: err = PALU_DISSECT(kNoValue); break;
    case kNoLogits: err = PALU_DISSECT(kNoLogits); break;
    case kDmaOnly: err = PALU_DISSECT(kDmaOnly); break;
    default: err = PALU_DISSECT(kNoop); break;
  }
#undef PALU_DISSECT
  if (err != 0) return err;
  if (mode == kFull || mode == kNoLogits)
    return decode::launch_combine(a.part_m, a.part_l, a.part_acc, static_cast<float*>(out),
                                  B * G * hpg, splits, rv, st);
  const int rows = B * G * hpg;
  if (mode == kNoValue)
    dissect_finish<<<(rows + 255) / 256, 256, 0, st>>>(a.part_m, a.part_l, nullptr,
                                                      static_cast<float*>(stats), nullptr, rows,
                                                      splits, 0);
  else
    dissect_finish<<<1, 256, 0, st>>>(nullptr, nullptr, a.part_ck, nullptr,
                                      static_cast<unsigned long long*>(ck_out), rows, splits,
                                      B * G * splits);
  return static_cast<int>(cudaGetLastError());
}

// The packed seq-major variant: codes (B, G, S, nbk) / (B, G, S, nbv) uint8
// at pack width pbits (2, 3 or 4), per-token scale and base (B, G, S) f32;
// x = (code + qmin - base) * scale. hd is 64 or 128, rk a multiple of 32 up
// to 512, rv a multiple of 32, S a multiple of 8.
extern "C" int palu_decode_seq_q(const void* q, int q_bf16, const void* bk, const void* kc,
                                 const void* ks, const void* kb, const void* vc, const void* vs,
                                 const void* vb, const void* kv_len, const void* cos_t,
                                 const void* sin_t, void* part_m, void* part_l, void* part_acc,
                                 void* out, int B, int G, int hpg, int hd, int rk, int rv, int S,
                                 int nbk, int nbv, int pbits, int qmin, int window, int splits,
                                 int tiles_per_split, float sqrt_hd, void* stream) {
  if ((hd != 64 && hd != 128) || rk % 32 || rk > kMaxRank || rv % 32 || S % 8 ||
      hpg > kMaxHeads || (pbits != 2 && pbits != 3 && pbits != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  FpArgs a{};
  a.q = q;
  a.q_bf16 = q_bf16;
  a.bk = static_cast<const bf16*>(bk);
  a.kc = static_cast<const uint8_t*>(kc);
  a.vc = static_cast<const uint8_t*>(vc);
  a.ks = static_cast<const float*>(ks);
  a.kb = static_cast<const float*>(kb);
  a.vs = static_cast<const float*>(vs);
  a.vb = static_cast<const float*>(vb);
  a.kv_len = static_cast<const int*>(kv_len);
  a.cos_t = static_cast<const float*>(cos_t);
  a.sin_t = static_cast<const float*>(sin_t);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.part_acc = static_cast<float*>(part_acc);
  a.G = G;
  a.hpg = hpg;
  a.rk = rk;
  a.rv = rv;
  a.S = S;
  a.window = window;
  a.splits = splits;
  a.tiles_per_split = tiles_per_split;
  a.sqrt_hd = sqrt_hd;
  a.nbk = nbk;
  a.nbv = nbv;
  a.pbits = pbits;
  a.qmin = qmin;
  fit_heads(a, false, hd, true);
  if (a.chunk_heads == 0) return static_cast<int>(cudaErrorInvalidValue);

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = hd == 128 ? launch_split<128, false, true>(a, B, st)
                            : launch_split<64, false, true>(a, B, st);
  if (err != 0) return err;
  return decode::launch_combine(a.part_m, a.part_l, a.part_acc, static_cast<float*>(out),
                                B * G * hpg, splits, rv, st);
}
