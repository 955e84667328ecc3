// The split pass of the latent decode over the rank-major packed cache and
// its host-side launch, shared by three generations of the decode:
// palu_decode.cu (v4's int8 K-path modes; its header describes the design;
// v4's exact modes run on palu_decode_exact.cu), and the archived A/B
// baselines palu_decode2.cu (v2) and palu_decode3.cu (v3), which run the
// exact K path over per-row affine scales and differ only in how RoPE and
// the scales reach the kernel (the template argument GEN):
//   4 - the int8 modes (MODE 1 and 2): block-relative tables (below);
//   2 - cos/sin computed in the kernel, sincosf of the f32 angle
//       (position * inv_freq[j]) times rope_scale, as the v2 TPU kernel
//       forms them; no table of positions is read;
//   3 - one (block_s, hd/2) table of block-relative cos/sin (rope_scale
//       folded in) and one (S / block_s, hd/2) table of block-start
//       offsets: when the tile walk enters a rotation block the query is
//       rotated by the block start, q' = R(-s0) q (RoPE(s) = R(s0) R(s -
//       s0)), so each token reads only its relative row; the query arrives
//       pre-scaled by 1/sqrt(hd); scales and zeros arrive packed as one
//       (B, S, 2G) array (v3's sz_pack), each token's row read with stride
//       2G.
// GEN 2 and 3 run MODE 0 (exact) asym only: the v2 / v3 caches always carry
// a zero row (zero = (q_min - base) * scale for sym, too), so the zero
// term rides on palu_decode's asym path (zero(s) * rowsum B added to K
// before RoPE; RoPE is linear, so this is v2's "virtual key" logit).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"

namespace {

using decode::al;
using decode::cp_async16;
using decode::cp_async_wait_all;
using decode::kSmemMax;
using decode::ldmatrix_x4_trans;
using decode::mma_bf16;
using decode::mma_s8;
using decode::warp_max;
using decode::warp_sum;

constexpr int kTile = 64;      // tokens per tile
constexpr int kThreads = 256;  // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeads = 32;  // q-heads per group (Qwen2-7B: 28 over one kv group of 4)
constexpr int kMaxKSteps = 8;  // k-steps of one rank chunk held in registers
constexpr int kRc = 16 * kMaxKSteps;  // the largest rank chunk, 128
constexpr int kMaxRank = 512;  // rk limit: a G-LRD group's rank at hd 128, group 4
constexpr int kByteStride = kTile + 4;  // padded byte rows: odd word stride
// padded rows (16 bytes) of the bf16 code tile and of B, so the eight row
// addresses of one ldmatrix fall on distinct banks
constexpr int kCk = kTile + 8;
constexpr int kBPad = 8;
constexpr int kI8Pad = 16;  // int8 rows of rk + 16 bytes: (rk + 16) / 4 words, 4 mod 32 banks
constexpr int kRed = 16;    // reduction rows: [head parity][4 sums][warp half]

struct DecodeArgs {
  const void* q;               // (B, nh, hd) bf16 or f32, roped at the current position
  int q_bf16;
  const __nv_bfloat16* bk;     // (G, hpg / rep, rk, hd): q-head h reads B of h / rep
  const uint8_t* kc;           // (B, G, nrk, S)
  const float* ks;             // (B, G, S)
  const float* kz;             // the same, asym only
  const uint8_t* vc;           // (B, G, nrv, S)
  const float* vs;
  const float* vz;
  const int* kv_len;           // (B,) absolute positions: column t is position pos_offset + t
  const float* c0;             // int8 modes: (S / block_s, hd/2) block-start rotation
  const float* s0;
  const float* rcos;           // (block_s, hd/2) block-relative rotation
  const float* rsin;
  const int8_t* cos8;          // int8_rot: (block_s, hd/2) at scale 63 / cmax
  const int8_t* sin8;
  const float* kbias;          // (G, hpg / rep, hd) pre-RoPE K bias, or null
  const float* inv_freq;       // GEN 2: (hd/2,) f32 RoPE frequencies
  float* part_m;               // (B, nh, splits)
  float* part_l;
  float* part_acc;             // (B, nh, splits, rv)
  int G, hpg, rep, rk, rv, S, nrk, nrv, pbits, qoff, asym, window;
  int splits, tiles_per_split, chunk_heads, block_s;
  int rc;                      // exact mode: ranks per chunk (rk when one chunk)
  float sqrt_hd, i8r_inv;
  float rope_scale;            // GEN 2: multiplies cos and sin
  int layer;                   // the layer of (L, B, G, ...) stacked cache buffers (0: one layer)
  int pos_offset;              // absolute position of column 0 (a sequence shard's start)
};

// The two rows of the query-folded operand for one (frequency, rank), in
// f32 without contraction (as the plain version and XLA form them).
__device__ __forceinline__ void fold(float a1, float a2, __nv_bfloat16 b1h, __nv_bfloat16 b2h,
                                     float& v1, float& v2) {
  const float b1 = __bfloat162float(b1h), b2 = __bfloat162float(b2h);
  v1 = __fadd_rn(__fmul_rn(a1, b1), __fmul_rn(a2, b2));
  v2 = __fsub_rn(__fmul_rn(a2, b1), __fmul_rn(a1, b2));
}

// Where rank r (of n) lives in a packed rank-major plane: byte row and
// bit shift of its field (and for exact 3-bit the row and shift of its
// high bit in the 1-bit plane), packed into one word so the per-token
// unpack is a table lookup plus shifts. Built once per block.
__device__ __forceinline__ uint32_t rank_entry(int r, int n, int pbits) {
  if (pbits == 3) {
    const int w2 = n / 4, w1 = n / 8;
    return static_cast<uint32_t>(r % w2) | (static_cast<uint32_t>(2 * (r / w2)) << 12) |
           (static_cast<uint32_t>(w2 + r % w1) << 16) | (static_cast<uint32_t>(r / w1) << 28);
  }
  const int w = n / (8 / pbits);
  return static_cast<uint32_t>(r % w) | (static_cast<uint32_t>(pbits * (r / w)) << 12);
}

// The mma A fragment of int8 codes at ra (this lane's first byte of a
// 16-token x 32-rank k-step; rows of `stride` bytes).
__device__ __forceinline__ void load_a8(uint32_t (&a)[4], const int8_t* ra, int stride) {
  a[0] = *reinterpret_cast<const uint32_t*>(ra);
  a[1] = *reinterpret_cast<const uint32_t*>(ra + 8 * stride);
  a[2] = *reinterpret_cast<const uint32_t*>(ra + 16);
  a[3] = *reinterpret_cast<const uint32_t*>(ra + 8 * stride + 16);
}

// One k-step of the int8 dots: acc[p] += codes . operand rows of column
// tile p (u), acc[NTW + p] the same rows `vofs` bytes on (v); rb is this
// lane's first operand byte of tile 0 at this k-step.
template <int NTW>
__device__ __forceinline__ void s8_dots(int (&acc)[2 * NTW][4], const uint32_t (&a)[4],
                                        const int8_t* rb, int stride, int vofs) {
#pragma unroll
  for (int p = 0; p < NTW; ++p) {
    const int8_t* u = rb + p * 8 * stride;
    mma_s8(acc[p], a, *reinterpret_cast<const uint32_t*>(u),
           *reinterpret_cast<const uint32_t*>(u + 16));
    mma_s8(acc[NTW + p], a, *reinterpret_cast<const uint32_t*>(u + vofs),
           *reinterpret_cast<const uint32_t*>(u + vofs + 16));
  }
}

// Element i of the query (B, nh, hd), bf16 or f32.
__device__ __forceinline__ float q_at(const DecodeArgs& a, size_t i) {
  return a.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[i])
                  : static_cast<const float*>(a.q)[i];
}

// Code at column t of a (rows, stride) byte tile for a rank_entry.
__device__ __forceinline__ int unpack_code(const uint8_t* tile, int stride, int t,
                                           uint32_t e, int pbits) {
  const int lo_mask = pbits == 3 ? 3 : (1 << pbits) - 1;
  int c = (tile[(e & 0xfff) * stride + t] >> ((e >> 12) & 0xf)) & lo_mask;
  if (pbits == 3) c |= ((tile[((e >> 16) & 0xfff) * stride + t] >> (e >> 28)) & 1) << 2;
  return c;
}

// Copy a (rows, kTile) byte tile at column s0 of a (rows, S) plane into
// shared memory with row stride kByteStride, 16 bytes per load; columns at
// or past S read as 0 (S is a multiple of 16).
__device__ __forceinline__ void load_byte_tile(uint8_t* dst, const uint8_t* src, int rows,
                                               int S, int s0, int tid) {
  constexpr int kVec = kTile / 16;
  for (int i = tid; i < rows * kVec; i += kThreads) {
    const int row = i / kVec, c = i % kVec, s = s0 + c * 16;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (s < S) v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row) * S + s);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst + row * kByteStride + c * 16);
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

// Byte offsets of the split kernel's shared-memory regions (one place for
// the kernel's carve and the launcher's size); `chunk` heads of B staged.
struct SplitLayout {
  size_t bsm, ck, cos, sin, c8, s8, op, kbytes, vbytes, ktab, vtab, q, rs, acc, lg, pw, red,
      sk, stat, total;
};

// mode 0 stages rc ranks of B in bf16 and a bf16 code tile of rc ranks;
// modes 1 and 2 the int8 operand (chunk heads x hd rows of rk bytes) with
// its six per-row f32 / int arrays (a1|a2, row max, scale, row sum, scaled
// row sum, the bias fold U_b|V_b) and an int8 code tile; mode 2 also the
// int8 rotation rows of the tile.
__host__ __device__ inline SplitLayout split_layout(int rk, int hd, int hpg, int rv, int nrk,
                                                    int nrv, int asym, int chunk, int mode,
                                                    int rc) {
  const bool exact = mode == 0;
  const size_t rope = sizeof(float) * kTile * (hd / 2 + 1);
  const size_t i8row = static_cast<size_t>(rk + kI8Pad);
  SplitLayout L;
  size_t off = 0;
  L.bsm = off;
  off = al(off + (exact ? sizeof(__nv_bfloat16) * chunk * rc * (hd + kBPad)
                        : i8row * chunk * hd));
  L.op = off;     off = al(off + (exact ? 0 : sizeof(float) * 6 * chunk * hd));
  L.ck = off;
  off = al(off + (exact ? sizeof(__nv_bfloat16) * rc * kCk : i8row * kTile));
  L.cos = off;    off = al(off + rope);
  L.sin = off;    off = al(off + rope);
  L.c8 = off;     off = al(off + (mode == 2 ? static_cast<size_t>(kTile) * (hd / 2) : 0));
  L.s8 = off;     off = al(off + (mode == 2 ? static_cast<size_t>(kTile) * (hd / 2) : 0));
  L.kbytes = off; off = al(off + static_cast<size_t>(nrk) * kByteStride);
  L.vbytes = off; off = al(off + static_cast<size_t>(nrv) * kByteStride);
  L.ktab = off;   off = al(off + sizeof(uint32_t) * rk);
  L.vtab = off;   off = al(off + sizeof(uint32_t) * rv);
  L.q = off;      off = al(off + sizeof(float) * hpg * hd);
  L.rs = off;     off = al(off + (asym && mode == 0 ? sizeof(float) * hpg * hd : 0));
  L.acc = off;    off = al(off + sizeof(float) * hpg * rv);
  L.lg = off;     off = al(off + sizeof(float) * hpg * kTile);
  L.pw = off;     off = al(off + sizeof(float) * hpg * kTile);
  L.red = off;    off = al(off + sizeof(float) * (exact ? 4 : kRed) * kTile);
  L.sk = off;     off = al(off + sizeof(float) * 4 * kTile);
  L.stat = off;   off = al(off + sizeof(float) * 4 * kMaxHeads);
  L.total = off;
  return L;
}

// BIAS compiles the K bias in (a.kbias set); without it the kernel carries
// no trace of the bias (a null test in the inner loops slowed the decodes
// that take none). GEN: the decode generation (this file's header).
template <int HD, int MODE, bool BIAS, int GEN = 4>
__global__ void __launch_bounds__(kThreads) palu_decode_split_kernel(DecodeArgs a) {
  static_assert((GEN == 4 && (MODE == 1 || MODE == 2)) ||
                    ((GEN == 2 || GEN == 3) && MODE == 0 && !BIAS),
                "v4: the int8 modes; v2 / v3: the exact mode over per-row scales, no bias");
  constexpr bool EXACT = MODE == 0;  // K rebuilt in bf16 mma
  constexpr int half = HD / 2;
  constexpr int HS = HD + kBPad;  // B row stride
  constexpr int NTH = HD / 16;    // 8-wide column tiles per half of hd
  constexpr int NTW = NTH / 2;    // ... per warp (two warps share 16 tokens)
  constexpr int cs = half + 1;    // padded rope rows
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int fg = lane / 4, ft = lane % 4;  // mma fragment row group / column pair
  const int mi = lane / 8, ri = lane % 8;  // ldmatrix tile / row of this lane
  const int hpg = a.hpg, rk = a.rk, rv = a.rv, nks = rk / 16;  // nks: int8 modes
  const int nh = a.G * hpg;
  const int m0 = (warp & 3) * 16;    // this warp's 16 tokens of the tile
  const int jw = (warp >> 2) * NTW;  // its first column tile in each half of hd

  extern __shared__ __align__(128) unsigned char smem[];
  const SplitLayout L = split_layout(rk, HD, hpg, rv, a.nrk, a.nrv, a.asym, a.chunk_heads,
                                     MODE, a.rc);
  const int i8s = rk + kI8Pad;  // int8 row stride (operand and code tile)
  const int rc = a.rc, nrc = (rk + rc - 1) / rc;  // exact mode's rank chunks
  __nv_bfloat16* bsm = reinterpret_cast<__nv_bfloat16*>(smem + L.bsm);  // [chunk][rc][HS]
  __nv_bfloat16* ck = reinterpret_cast<__nv_bfloat16*>(smem + L.ck);    // [rc][kCk]
  float* cos_s = reinterpret_cast<float*>(smem + L.cos);                // [kTile][cs]
  float* sin_s = reinterpret_cast<float*>(smem + L.sin);
  uint8_t* kbytes = smem + L.kbytes;                                    // [nrk][kByteStride]
  uint8_t* vbytes = smem + L.vbytes;                                    // [nrv][kByteStride]
  uint32_t* ktab = reinterpret_cast<uint32_t*>(smem + L.ktab);          // [rk]
  uint32_t* vtab = reinterpret_cast<uint32_t*>(smem + L.vtab);          // [rv]
  float* q_s = reinterpret_cast<float*>(smem + L.q);                    // [hpg][hd]
  float* rs_b = reinterpret_cast<float*>(smem + L.rs);  // [hpg][hd] rowsum of B (asym)
  float* acc_s = reinterpret_cast<float*>(smem + L.acc);                // [hpg][rv]
  float* lg = reinterpret_cast<float*>(smem + L.lg);    // [hpg][kTile] logits
  float* pw = reinterpret_cast<float*>(smem + L.pw);    // [hpg][kTile] p * scale_v
  float* red = reinterpret_cast<float*>(smem + L.red);  // [head parity][warp half][kTile]
  float* sk = reinterpret_cast<float*>(smem + L.sk);    // [4][kTile]: sk, zk, sv, zv
  float* stat = reinterpret_cast<float*>(smem + L.stat);  // [4][kMaxHeads]: m, l, alpha, zsum
  // int8 modes: the operand [chunk][hd][i8s] and its per-row arrays
  int8_t* nq = reinterpret_cast<int8_t*>(smem + L.bsm);
  int8_t* ck8 = reinterpret_cast<int8_t*>(smem + L.ck);                 // [kTile][i8s]
  const int8_t* c8s = reinterpret_cast<const int8_t*>(smem + L.c8);     // [kTile][hd/2]
  const int8_t* s8s = reinterpret_cast<const int8_t*>(smem + L.s8);
  const int nop = a.chunk_heads * HD;
  float* aq = reinterpret_cast<float*>(smem + L.op);  // [chunk][hd]: a1 | a2
  unsigned* amax = reinterpret_cast<unsigned*>(aq + nop);  // row max of |operand|
  float* osc = aq + 2 * nop;                               // operand scale per row
  int* rsn = reinterpret_cast<int*>(aq + 3 * nop);         // row sum of the int8 operand
  float* ors = aq + 4 * nop;                               // rsn * osc
  float* bqb = aq + 5 * nop;  // the K bias fold per head: U_b | V_b
  float* zk = sk + kTile;
  float* sv = sk + 2 * kTile;
  float* zv = sk + 3 * kTile;
  float* m_s = stat;
  float* l_s = stat + kMaxHeads;
  float* alpha_s = stat + 2 * kMaxHeads;
  float* zsum = stat + 3 * kMaxHeads;

  // the cache planes of (layer, lane, group): a layer-stacked buffer holds
  // L copies of the (B, G, ...) planes and a.layer picks one
  const size_t bg = (static_cast<size_t>(a.layer) * gridDim.z + b) * a.G + g;
  const uint8_t* kc = a.kc + bg * a.nrk * a.S;
  const uint8_t* vc = a.vc + bg * a.nrv * a.S;
  // per-row scales and zeros of token s at [s * sst]: (B, G, S) rows, or
  // v3's (B, S, 2G) packed rows (scale in column g, zero in column G + g)
  const int sst = GEN == 3 ? 2 * a.G : 1;
  const size_t sz0 = static_cast<size_t>(b) * a.S * sst + g;  // GEN 3
  const float* ksc = GEN == 3 ? a.ks + sz0 : a.ks + bg * a.S;
  const float* vsc = GEN == 3 ? a.vs + sz0 : a.vs + bg * a.S;
  const float* kzp = GEN == 3 ? ksc + a.G : a.asym ? a.kz + bg * a.S : nullptr;
  const float* vzp = GEN == 3 ? vsc + a.G : a.asym ? a.vz + bg * a.S : nullptr;
  // B and the K bias of q-head h are kv-head h / rep's (rep 1: the repeated form)
  const int nkv = hpg / a.rep;
  const float* kb_g = BIAS ? a.kbias + static_cast<size_t>(g) * nkv * HD : nullptr;
  const __nv_bfloat16* bk_g = a.bk + static_cast<size_t>(g) * nkv * rk * HD;

  for (int r = tid; r < rk; r += kThreads) ktab[r] = rank_entry(r, rk, a.pbits);
  for (int r = tid; r < rv; r += kThreads) vtab[r] = rank_entry(r, rv, a.pbits);
  for (int i = tid; i < hpg * HD; i += kThreads) {
    q_s[i] = q_at(a, (static_cast<size_t>(b) * nh + g * hpg) * HD + i);
    if (MODE == 0 && a.asym) {
      const int h = i / HD, d = i % HD;
      float rs = 0.0f;
      for (int r = 0; r < rk; ++r)
        rs += __bfloat162float(bk_g[(static_cast<size_t>(h) * rk + r) * HD + d]);
      rs_b[i] = rs;
    }
  }
  for (int i = tid; i < hpg * rv; i += kThreads) acc_s[i] = 0.0f;
  if (tid < kMaxHeads) {
    m_s[tid] = -1e30f;
    l_s[tid] = 0.0f;
    alpha_s[tid] = 1.0f;
    zsum[tid] = 0.0f;
  }

  // kv_len and the window in column coordinates: a sequence shard past
  // kv_len gets kvl <= 0 and walks no tile
  const int kvl = a.kv_len[b] - a.pos_offset;
  const int lo_pos = a.window > 0 ? max(0, kvl - a.window) : 0;
  const int tile_lo = lo_pos / kTile;
  const int tile_hi = (max(0, min(kvl, a.S)) + kTile - 1) / kTile;
  const int t_begin = max(split * a.tiles_per_split, tile_lo);
  const int t_end = min((split + 1) * a.tiles_per_split, tile_hi);

  // heads in chunks whose B fits in shared memory (one chunk when all fit);
  // each chunk walks the block's tiles
  for (int c0 = 0; c0 < hpg && t_begin < t_end; c0 += a.chunk_heads) {
    const int nc = min(a.chunk_heads, hpg - c0);
    __syncthreads();  // set-up done / the previous chunk's B reads done
    if (EXACT && nrc == 1) {  // all of B fits: staged once
      for (int i = tid; i < nc * rk * (HD / 8); i += kThreads) {
        const int row = i / (HD / 8), c = i % (HD / 8);  // row = head * rk + rank
        cp_async16(bsm + row * HS + c * 8,
                   bk_g + (static_cast<size_t>(c0) * rk + row) * HD + c * 8);
      }
      cp_async_wait_all();
      __syncthreads();
    }

    int cur_blk = -1;
    for (int tile = t_begin; tile < t_end; ++tile) {
      const int s0 = tile * kTile;
      const int blk = EXACT && GEN != 3 ? 0 : s0 / a.block_s;
      if (GEN == 3 && blk != cur_blk) {
        // ---- v3: the query rotated back by this rotation block's start,
        // q' = R(-s0) q, in f32 (the previous tile's reads of q_s ended at
        // its last barrier; the tile load's barrier precedes the next)
        cur_blk = blk;
        for (int i = tid; i < hpg * half; i += kThreads) {
          const int h = i / half, e = i % half;
          const size_t qi = (static_cast<size_t>(b) * nh + g * hpg + h) * HD + e;
          const float q1 = q_at(a, qi), q2 = q_at(a, qi + half);
          const float c = a.c0[blk * half + e], sn = a.s0[blk * half + e];
          q_s[h * HD + e] = __fadd_rn(__fmul_rn(q1, c), __fmul_rn(q2, sn));
          q_s[h * HD + half + e] = __fsub_rn(__fmul_rn(q2, c), __fmul_rn(q1, sn));
        }
      }
      if (!EXACT && blk != cur_blk) {
        // ---- int8 modes: the query-folded operand of this rotation block
        cur_blk = blk;
        for (int i = tid; i < nc * half; i += kThreads) {
          const int h = i / half, e = i % half;
          const float qa = q_s[(c0 + h) * HD + e] / a.sqrt_hd;
          const float qb = q_s[(c0 + h) * HD + half + e] / a.sqrt_hd;
          const float c = a.c0[blk * half + e], sn = a.s0[blk * half + e];
          aq[h * HD + e] = __fadd_rn(__fmul_rn(qa, c), __fmul_rn(qb, sn));
          aq[h * HD + half + e] = __fsub_rn(__fmul_rn(qb, c), __fmul_rn(qa, sn));
        }
        for (int i = tid; i < nc * HD; i += kThreads) {
          amax[i] = 0u;
          rsn[i] = 0;
        }
        __syncthreads();
        if (BIAS) {  // the bias fold of this block's rotated query (cache-independent)
          for (int i = tid; i < nc * half; i += kThreads) {
            const int h = i / half, e = i % half;
            const float* kbh = kb_g + (c0 + h) / a.rep * HD;
            const float kb1 = kbh[e], kb2 = kbh[half + e];
            const float a1 = aq[h * HD + e], a2 = aq[h * HD + half + e];
            bqb[h * HD + e] = __fadd_rn(__fmul_rn(a1, kb1), __fmul_rn(a2, kb2));
            bqb[h * HD + half + e] = __fsub_rn(__fmul_rn(a2, kb1), __fmul_rn(a1, kb2));
          }
        }
        const int e = tid % half, rstep = kThreads / half;  // half divides kThreads
        for (int h = 0; h < nc; ++h) {
          const float a1 = aq[h * HD + e], a2 = aq[h * HD + half + e];
          const __nv_bfloat16* bh = bk_g + static_cast<size_t>((c0 + h) / a.rep) * rk * HD;
          float m1 = 0.0f, m2 = 0.0f;
          for (int r = tid / half; r < rk; r += rstep) {
            float v1, v2;
            fold(a1, a2, bh[r * HD + e], bh[r * HD + half + e], v1, v2);
            m1 = fmaxf(m1, fabsf(v1));
            m2 = fmaxf(m2, fabsf(v2));
          }
          atomicMax(amax + h * HD + e, __float_as_uint(m1));  // order of non-negative floats
          atomicMax(amax + h * HD + half + e, __float_as_uint(m2));
        }
        __syncthreads();
        for (int i = tid; i < nc * HD; i += kThreads) {
          float m = __uint_as_float(amax[i]);
          if (MODE == 2) {  // one scale per head and half
            const unsigned* seg = amax + (i / HD) * HD + ((i % HD) < half ? 0 : half);
            m = 0.0f;
            for (int k = 0; k < half; ++k) m = fmaxf(m, __uint_as_float(seg[k]));
          }
          osc[i] = __fmul_rn(fmaxf(m, 1e-30f), 1.0f / 127.0f);
        }
        __syncthreads();
        for (int h = 0; h < nc; ++h) {
          const float a1 = aq[h * HD + e], a2 = aq[h * HD + half + e];
          const float sc1 = osc[h * HD + e], sc2 = osc[h * HD + half + e];
          const __nv_bfloat16* bh = bk_g + static_cast<size_t>((c0 + h) / a.rep) * rk * HD;
          int n1s = 0, n2s = 0;
          for (int r = tid / half; r < rk; r += rstep) {
            float v1, v2;
            fold(a1, a2, bh[r * HD + e], bh[r * HD + half + e], v1, v2);
            const int n1 = static_cast<int>(fminf(fmaxf(rintf(v1 / sc1), -127.0f), 127.0f));
            const int n2 = static_cast<int>(fminf(fmaxf(rintf(v2 / sc2), -127.0f), 127.0f));
            nq[(h * HD + e) * i8s + r] = static_cast<int8_t>(n1);
            nq[(h * HD + half + e) * i8s + r] = static_cast<int8_t>(n2);
            n1s += n1;
            n2s += n2;
          }
          atomicAdd(rsn + h * HD + e, n1s);
          atomicAdd(rsn + h * HD + half + e, n2s);
        }
        __syncthreads();
        for (int i = tid; i < nc * HD; i += kThreads)
          ors[i] = __fmul_rn(static_cast<float>(rsn[i]), osc[i]);
        // (the tile load below ends in a barrier before anyone reads these)
      }
      // ---- load: packed K/V byte tiles, scales, rope rows (vector loads)
      load_byte_tile(kbytes, kc, a.nrk, a.S, s0, tid);
      load_byte_tile(vbytes, vc, a.nrv, a.S, s0, tid);
      if (tid < kTile) {
        const int s = s0 + tid;
        const bool in = s < a.S;
        sk[tid] = in ? ksc[s * sst] : 0.0f;
        sv[tid] = in ? vsc[s * sst] : 0.0f;
        // int8 modes fold the symmetric offset into the zero correction
        zk[tid] = (in && a.asym) ? kzp[s * sst]
                  : (in && !EXACT) ? sk[tid] * static_cast<float>(-a.qoff) : 0.0f;
        zv[tid] = (in && a.asym) ? vzp[s * sst] : 0.0f;
      }
      // rope rows: block-relative ones (int8, v3), or computed here from the
      // positions (v2)
      const float* cos_src = a.rcos;
      const float* sin_src = a.rsin;
      const int row0 = s0 - blk * a.block_s;
      if constexpr (GEN == 2) {
        for (int i = tid; i < kTile * half; i += kThreads) {
          const int t = i / half, f = i % half;
          float sn, c;
          sincosf(static_cast<float>(s0 + t) * __ldg(a.inv_freq + f), &sn, &c);
          cos_s[t * cs + f] = c * a.rope_scale;
          sin_s[t * cs + f] = sn * a.rope_scale;
        }
      }
      for (int i = tid; i < (GEN == 2 ? 0 : kTile * (half / 4)); i += kThreads) {
        const int t = i / (half / 4), f = (i % (half / 4)) * 4, s = s0 + t;
        float4 c = make_float4(0.f, 0.f, 0.f, 0.f), n = c;
        if (s < a.S) {
          const size_t row = static_cast<size_t>(row0 + t) * half + f;
          c = *reinterpret_cast<const float4*>(cos_src + row);
          n = *reinterpret_cast<const float4*>(sin_src + row);
        }
        float* cd = cos_s + t * cs + f;
        float* sd = sin_s + t * cs + f;
        cd[0] = c.x; cd[1] = c.y; cd[2] = c.z; cd[3] = c.w;
        sd[0] = n.x; sd[1] = n.y; sd[2] = n.z; sd[3] = n.w;
      }
      if (MODE == 2) {  // the int8 rotation rows (block-relative; S % 64 == 0 here)
        for (int i = tid; i < kTile * (half / 4); i += kThreads) {
          const size_t row = static_cast<size_t>(row0) * half + i * 4;
          reinterpret_cast<uint32_t*>(smem + L.c8)[i] =
              *reinterpret_cast<const uint32_t*>(a.cos8 + row);
          reinterpret_cast<uint32_t*>(smem + L.s8)[i] =
              *reinterpret_cast<const uint32_t*>(a.sin8 + row);
        }
      }
      __syncthreads();
      if (!EXACT) {
        // raw unsigned K codes -> int8 [token][rank]
        for (int i = tid; i < rk * kTile; i += kThreads) {
          const int t = i / rk, r = i % rk;
          ck8[t * i8s + r] =
              static_cast<int8_t>(unpack_code(kbytes, kByteStride, t, ktab[r], a.pbits));
        }
        __syncthreads();
      }
      const int tok_a = m0 + fg, tok_b = tok_a + 8;  // accumulator rows of this lane

      if (!EXACT) {
        // ---- int8 modes: per head u|v (tokens x hd) = codes^T . operand^T.
        // The A fragments (codes, 16 tokens x 32 ranks) of the first 128
        // ranks stay in registers for all heads; higher ranks' load per
        // k-step from shared memory
        const int8_t* ra = ck8 + (m0 + fg) * i8s + 4 * ft;
        uint32_t a8[kMaxKSteps / 2][4];
#pragma unroll
        for (int ks = 0; ks < kMaxKSteps / 2; ++ks)
          if (ks < nks / 2) load_a8(a8[ks], ra + ks * 32, i8s);
        for (int hc = 0; hc < nc; ++hc) {
          const int h = c0 + hc;
          const int8_t* nqh = nq + (hc * HD + jw * 8 + fg) * i8s + 4 * ft;
          int acc[2 * NTW][4];
#pragma unroll
          for (int j = 0; j < 2 * NTW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
#pragma unroll
          for (int ks = 0; ks < kMaxKSteps / 2; ++ks)
            if (ks < nks / 2) s8_dots<NTW>(acc, a8[ks], nqh + ks * 32, i8s, half * i8s);
          for (int ks = kMaxKSteps / 2; ks < nks / 2; ++ks) {
            uint32_t at[4];
            load_a8(at, ra + ks * 32, i8s);
            s8_dots<NTW>(acc, at, nqh + ks * 32, i8s, half * i8s);
          }
          // acc[j]: u at frequency (jw + j) * 8 + ...; acc[NTW + j]: v there
          float pa = 0.0f, pb = 0.0f, ca = 0.0f, cb = 0.0f, ba = 0.0f, bb = 0.0f;
          int ia1 = 0, ia2 = 0, ib1 = 0, ib2 = 0;
#pragma unroll
          for (int j = 0; j < NTW; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int d = (jw + j) * 8 + 2 * ft + e;
              const float r1 = ors[hc * HD + d], r2 = ors[hc * HD + half + d];
              const float cosa = cos_s[tok_a * cs + d], sina = sin_s[tok_a * cs + d];
              const float cosb = cos_s[tok_b * cs + d], sinb = sin_s[tok_b * cs + d];
              ca += r1 * cosa + r2 * sina;
              cb += r1 * cosb + r2 * sinb;
              if (BIAS) {
                const float u1 = bqb[hc * HD + d], u2 = bqb[hc * HD + half + d];
                ba += u1 * cosa + u2 * sina;
                bb += u1 * cosb + u2 * sinb;
              }
              if (MODE == 1) {
                const float sc1 = osc[hc * HD + d], sc2 = osc[hc * HD + half + d];
                pa += (static_cast<float>(acc[j][e]) * sc1) * cosa +
                      (static_cast<float>(acc[NTW + j][e]) * sc2) * sina;
                pb += (static_cast<float>(acc[j][e + 2]) * sc1) * cosb +
                      (static_cast<float>(acc[NTW + j][e + 2]) * sc2) * sinb;
              } else {
                ia1 += static_cast<int>(c8s[tok_a * half + d]) * acc[j][e];
                ia2 += static_cast<int>(s8s[tok_a * half + d]) * acc[NTW + j][e];
                ib1 += static_cast<int>(c8s[tok_b * half + d]) * acc[j][e + 2];
                ib2 += static_cast<int>(s8s[tok_b * half + d]) * acc[NTW + j][e + 2];
              }
            }
          }
#pragma unroll
          for (int o = 1; o <= 2; o <<= 1) {
            ca += __shfl_xor_sync(0xffffffffu, ca, o);
            cb += __shfl_xor_sync(0xffffffffu, cb, o);
            if (BIAS) {
              ba += __shfl_xor_sync(0xffffffffu, ba, o);
              bb += __shfl_xor_sync(0xffffffffu, bb, o);
            }
            if (MODE == 1) {
              pa += __shfl_xor_sync(0xffffffffu, pa, o);
              pb += __shfl_xor_sync(0xffffffffu, pb, o);
            } else {
              ia1 += __shfl_xor_sync(0xffffffffu, ia1, o);
              ia2 += __shfl_xor_sync(0xffffffffu, ia2, o);
              ib1 += __shfl_xor_sync(0xffffffffu, ib1, o);
              ib2 += __shfl_xor_sync(0xffffffffu, ib2, o);
            }
          }
          // [parity][sum: main | int8_rot's sin part | correction | bias][warp half][kTile]
          float* rh = red + ((hc & 1) * 8 + (warp >> 2)) * kTile;
          if (ft == 0) {
            rh[tok_a] = MODE == 1 ? pa : __int_as_float(ia1);
            rh[tok_b] = MODE == 1 ? pb : __int_as_float(ib1);
            rh[2 * kTile + tok_a] = __int_as_float(ia2);
            rh[2 * kTile + tok_b] = __int_as_float(ib2);
            rh[4 * kTile + tok_a] = ca;
            rh[4 * kTile + tok_b] = cb;
            if (BIAS) {
              rh[6 * kTile + tok_a] = ba;
              rh[6 * kTile + tok_b] = bb;
            }
          }
          __syncthreads();
          if (tid < kTile) {
            const float* r2 = red + (hc & 1) * 8 * kTile;
            const float corr = r2[4 * kTile + tid] + r2[5 * kTile + tid];
            const float bias = BIAS ? r2[6 * kTile + tid] + r2[7 * kTile + tid] : 0.0f;
            float main;
            if (MODE == 1) {
              main = r2[tid] + r2[kTile + tid];
            } else {
              const int t1 = __float_as_int(r2[tid]) + __float_as_int(r2[kTile + tid]);
              const int t2 = __float_as_int(r2[2 * kTile + tid]) +
                             __float_as_int(r2[3 * kTile + tid]);
              main = static_cast<float>(t1) * (osc[hc * HD] * a.i8r_inv) +
                     static_cast<float>(t2) * (osc[hc * HD + half] * a.i8r_inv);
            }
            // the bias term is cache-independent: after the per-token scale
            lg[h * kTile + tid] = main * sk[tid] + corr * zk[tid] + bias;
          }
        }
      } else {
        const float sk_a = sk[tok_a], sk_b = sk[tok_b], zk_a = zk[tok_a], zk_b = zk[tok_b];
        for (int ci = 0; ci < nrc; ++ci) {
          // ---- rank chunk ci: ranks [r0, r0 + nr)
          const int r0 = ci * rc, nr = min(rc, rk - r0), nkc = nr / 16;
          if (ci > 0) __syncthreads();  // the previous chunk's reads of B and codes done
          if (nrc > 1) {  // stream this chunk's rows of B for the chunk's heads
            const int per_head = nr * (HD / 8);
            for (int i = tid; i < nc * per_head; i += kThreads) {
              const int hh = i / per_head, row = (i % per_head) / (HD / 8), c = i % (HD / 8);
              cp_async16(bsm + (hh * rc + row) * HS + c * 8,
                         bk_g + (static_cast<size_t>(c0 + hh) * rk + r0 + row) * HD + c * 8);
            }
          }
          // K codes -> bf16 (nr x kTile), re-centred for sym; exact in bf16
          for (int i = tid; i < nr * kTile; i += kThreads) {
            const int r = i / kTile, t = i % kTile;
            ck[r * kCk + t] = __float2bfloat16(static_cast<float>(
                unpack_code(kbytes, kByteStride, t, ktab[r0 + r], a.pbits) - a.qoff));
          }
          if (nrc > 1) cp_async_wait_all();
          __syncthreads();

          // A fragments: codes^T (16 tokens x 16 ranks) per k-step, shared by
          // the heads; the code tile is stored [rank][token], hence .trans
          uint32_t af[kMaxKSteps][4];
#pragma unroll
          for (int ks = 0; ks < kMaxKSteps; ++ks)
            if (ks < nkc)
              ldmatrix_x4_trans(af[ks],
                                ck + (ks * 16 + ri + (mi >> 1) * 8) * kCk + m0 + (mi & 1) * 8);

          // ---- per head: K_h (tokens x hd) = codes^T B_h, then RoPE + q . K
          for (int hc = 0; hc < nc; ++hc) {
            const int h = c0 + hc;
            const __nv_bfloat16* bh = bsm + static_cast<size_t>(hc) * rc * HS;
            // acc[j]: column tile jw + j (first half of hd); acc[NTW + j]: tile
            // NTH + jw + j, its RoPE partner in the second half
            float acc[2 * NTW][4];
#pragma unroll
            for (int j = 0; j < 2 * NTW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
            for (int ks = 0; ks < kMaxKSteps; ++ks) {
              if (ks < nkc) {
                const __nv_bfloat16* brow =
                    bh + (ks * 16 + ri + (mi & 1) * 8) * HS + (mi >> 1) * 8;
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
            const float* rsh = rs_b + h * HD;
            const float* kbh = BIAS ? kb_g + static_cast<size_t>(h) * HD : nullptr;
            float part_a = 0.0f, part_b = 0.0f;
#pragma unroll
            for (int j = 0; j < NTW; ++j) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int d = (jw + j) * 8 + 2 * ft + e;
                const float q1 = qh[d], q2 = qh[d + half];
                float k1 = acc[j][e] * sk_a, k2 = acc[NTW + j][e] * sk_a;
                float l1 = acc[j][e + 2] * sk_b, l2 = acc[NTW + j][e + 2] * sk_b;
                if (MODE == 0 && a.asym && ci == 0) {  // rs_b (all ranks): per-row asym only
                  k1 += zk_a * rsh[d];
                  k2 += zk_a * rsh[d + half];
                  l1 += zk_b * rsh[d];
                  l2 += zk_b * rsh[d + half];
                }
                if (BIAS && ci == 0) {  // the K bias, pre-RoPE, once per token
                  const float b1 = __ldg(kbh + d), b2 = __ldg(kbh + d + half);
                  k1 += b1;
                  k2 += b2;
                  l1 += b1;
                  l2 += b2;
                }
                float c = cos_s[tok_a * cs + d], s = sin_s[tok_a * cs + d];
                part_a += q1 * (k1 * c - k2 * s) + q2 * (k2 * c + k1 * s);
                c = cos_s[tok_b * cs + d];
                s = sin_s[tok_b * cs + d];
                part_b += q1 * (l1 * c - l2 * s) + q2 * (l2 * c + l1 * s);
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
      }  // MODE
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
        float sum = 0.0f, zs = 0.0f;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int t = lane + 32 * u;
          e[u] = ok[u] ? expf(x[u] - m_new) : 0.0f;
          sum += e[u];
          zs += e[u] * zv[t];
          pw[h * kTile + t] = e[u] * sv[t];
        }
        sum = warp_sum(sum);
        zs = warp_sum(zs);
        if (lane == 0) {
          m_s[h] = m_new;
          l_s[h] = l_s[h] * alpha + sum;
          alpha_s[h] = alpha;
          zsum[h] = zsum[h] * alpha + zs;
        }
      }
      __syncthreads();

      // ---- latent V: acc[h][r] = acc * alpha + sum_t p[h][t] scale_v[t] (code - qoff)
      for (int r = tid; r < rv; r += kThreads) {
        const uint32_t e = vtab[r];
        float cv[kTile];
#pragma unroll
        for (int t = 0; t < kTile; ++t)
          cv[t] = static_cast<float>(unpack_code(vbytes, kByteStride, t, e, a.pbits) - a.qoff);
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

  const size_t head0 = static_cast<size_t>(b) * nh + g * hpg;
  for (int i = tid; i < hpg * rv; i += kThreads) {
    const int h = i / rv, r = i % rv;
    a.part_acc[((head0 + h) * a.splits + split) * rv + r] = acc_s[i] + zsum[h];
  }
  if (tid < hpg) {
    a.part_m[(head0 + tid) * a.splits + split] = m_s[tid];
    a.part_l[(head0 + tid) * a.splits + split] = l_s[tid];
  }
}

template <int HD, int MODE, bool BIAS, int GEN = 4>
int launch_split(const DecodeArgs& a, int B, cudaStream_t st) {
  const size_t smem = split_layout(a.rk, HD, a.hpg, a.rv, a.nrk, a.nrv, a.asym, a.chunk_heads,
                                  MODE, a.rc).total;
  cudaError_t err = cudaFuncSetAttribute(palu_decode_split_kernel<HD, MODE, BIAS, GEN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  palu_decode_split_kernel<HD, MODE, BIAS, GEN>
      <<<dim3(a.splits, a.G, B), kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool BIAS>
int launch_mode(const DecodeArgs& a, int mode, int B, cudaStream_t st) {
  return mode == 1 ? launch_split<HD, 1, BIAS>(a, B, st) : launch_split<HD, 2, BIAS>(a, B, st);
}

template <int HD>
int launch_bias(const DecodeArgs& a, int mode, int B, cudaStream_t st) {
  return a.kbias ? launch_mode<HD, true>(a, mode, B, st) : launch_mode<HD, false>(a, mode, B, st);
}

// Fit as many heads' B (or int8 operands) in shared memory as fit beside
// the rest (the exact mode takes ranks in chunks of up to 128, and of fewer
// when not even one head's 128 rows of B fit), launch the split pass of
// generation GEN (4: mode 1 or 2, with or without bias; 2 and 3: mode 0, no
// bias) and then the combine into out (B, nh, rv): normalised, or with
// m_out / l_out given the raw statistics (decode_common.cuh). hd is 64 or 128.
template <int GEN>
int run_split(DecodeArgs& a, int mode, int B, int hd, float* out, cudaStream_t st,
              float* m_out = nullptr, float* l_out = nullptr) {
  const bool exact = mode == 0;
  a.chunk_heads = 0;
  const int rcs[4] = {exact ? min(a.rk, kRc) : a.rk, 64, 32, 16};
  for (int k = 0; k < (exact ? 4 : 1) && a.chunk_heads == 0; ++k) {
    if (k > 0 && rcs[k] >= rcs[0]) continue;
    a.rc = rcs[k];
    a.chunk_heads = a.hpg;
    while (a.chunk_heads > 0 && split_layout(a.rk, hd, a.hpg, a.rv, a.nrk, a.nrv, a.asym,
                                             a.chunk_heads, mode, a.rc).total >
                                    kSmemMax)
      --a.chunk_heads;
  }
  if (a.chunk_heads == 0) return static_cast<int>(cudaErrorInvalidValue);
  int err;
  if constexpr (GEN == 4)
    err = hd == 128 ? launch_bias<128>(a, mode, B, st) : launch_bias<64>(a, mode, B, st);
  else
    err = hd == 128 ? launch_split<128, 0, false, GEN>(a, B, st)
                    : launch_split<64, 0, false, GEN>(a, B, st);
  if (err != 0) return err;
  return decode::launch_combine(a.part_m, a.part_l, a.part_acc, out, B * a.G * a.hpg, a.splits,
                                a.rv, st, m_out, l_out);
}

}  // namespace
