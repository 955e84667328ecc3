// The split pass of the latent decode over the rank-major packed cache and
// its host-side launch, behind the archived A/B baseline palu_decode3.cu
// (v3), the exact K path over per-row affine scales with v3's way of
// bringing RoPE and the scales to the kernel: one (block_s, hd/2) table of
// block-relative cos/sin (rope_scale folded in) and one (S / block_s, hd/2)
// table of block-start offsets: when the tile walk enters a rotation block
// the query is rotated by the block start, q' = R(-s0) q (RoPE(s) = R(s0)
// R(s - s0)), so each token reads only its relative row; the query arrives
// pre-scaled by 1/sqrt(hd); scales and zeros arrive packed as one (B, S,
// 2G) array (v3's sz_pack), each token's row read with stride 2G. It runs
// asym only: the v3 cache always carries a zero row (zero = (q_min - base) *
// scale for sym, too), so the zero term is zero(s) * rowsum B added to K
// before RoPE (RoPE is linear, so this is v2's "virtual key" logit). v4's
// decode runs on palu_decode_exact.cu and palu_decode_i8.cu, v2's on
// palu_decode_exact.cu.
//
// Design: grid (splits, G, B), 8 warps, about one block per SM. A block
// walks its runs of tiles of 64 tokens: 16-byte loads bring the packed K
// and V byte rows into shared memory, a per-block table of each rank's byte
// row and shift turns unpacking into lookups and shifts; K is rebuilt per
// head on mma.sync (bf16 codes x B in rank chunks of up to 128), each head
// keeps (m, l) and a latent accumulator (rv) in shared memory, and the
// combine kernel merges the splits.

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

struct DecodeArgs {
  const void* q;               // (B, nh, hd) bf16 or f32, roped at the current position
  int q_bf16;
  const __nv_bfloat16* bk;     // (G, hpg, rk, hd)
  const uint8_t* kc;           // (B, G, nrk, S)
  const float* ks;             // (B, S, 2G) scale | zero rows
  const uint8_t* vc;           // (B, G, nrv, S)
  const float* vs;
  const int* kv_len;           // (B,)
  const float* c0;             // (S / block_s, hd/2) block-start rotation
  const float* s0;
  const float* rcos;           // (block_s, hd/2) block-relative rotation
  const float* rsin;
  float* part_m;               // (B, nh, splits)
  float* part_l;
  float* part_acc;             // (B, nh, splits, rv)
  int G, hpg, rk, rv, S, nrk, nrv, pbits, qoff, asym, window;
  int splits, tiles_per_split, chunk_heads, block_s;
  int rc;                      // ranks per chunk (rk when one chunk)
  float sqrt_hd;
};

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
  size_t bsm, ck, cos, sin, kbytes, vbytes, ktab, vtab, q, rs, acc, lg, pw, red, sk, stat, total;
};

// rc ranks of B in bf16 for `chunk` heads and a bf16 code tile of rc ranks.
__host__ __device__ inline SplitLayout split_layout(int rk, int hd, int hpg, int rv, int nrk,
                                                    int nrv, int chunk, int rc) {
  const size_t rope = sizeof(float) * kTile * (hd / 2 + 1);
  SplitLayout L;
  size_t off = 0;
  L.bsm = off;    off = al(off + sizeof(__nv_bfloat16) * chunk * rc * (hd + kBPad));
  L.ck = off;     off = al(off + sizeof(__nv_bfloat16) * rc * kCk);
  L.cos = off;    off = al(off + rope);
  L.sin = off;    off = al(off + rope);
  L.kbytes = off; off = al(off + static_cast<size_t>(nrk) * kByteStride);
  L.vbytes = off; off = al(off + static_cast<size_t>(nrv) * kByteStride);
  L.ktab = off;   off = al(off + sizeof(uint32_t) * rk);
  L.vtab = off;   off = al(off + sizeof(uint32_t) * rv);
  L.q = off;      off = al(off + sizeof(float) * hpg * hd);
  L.rs = off;     off = al(off + sizeof(float) * hpg * hd);
  L.acc = off;    off = al(off + sizeof(float) * hpg * rv);
  L.lg = off;     off = al(off + sizeof(float) * hpg * kTile);
  L.pw = off;     off = al(off + sizeof(float) * hpg * kTile);
  L.red = off;    off = al(off + sizeof(float) * 4 * kTile);
  L.sk = off;     off = al(off + sizeof(float) * 4 * kTile);
  L.stat = off;   off = al(off + sizeof(float) * 4 * kMaxHeads);
  L.total = off;
  return L;
}

template <int HD>
__global__ void __launch_bounds__(kThreads) palu_decode_split_kernel(DecodeArgs a) {
  constexpr int half = HD / 2;
  constexpr int HS = HD + kBPad;  // B row stride
  constexpr int NTH = HD / 16;    // 8-wide column tiles per half of hd
  constexpr int NTW = NTH / 2;    // ... per warp (two warps share 16 tokens)
  constexpr int cs = half + 1;    // padded rope rows
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int fg = lane / 4, ft = lane % 4;  // mma fragment row group / column pair
  const int mi = lane / 8, ri = lane % 8;  // ldmatrix tile / row of this lane
  const int hpg = a.hpg, rk = a.rk, rv = a.rv;
  const int nh = a.G * hpg;
  const int m0 = (warp & 3) * 16;    // this warp's 16 tokens of the tile
  const int jw = (warp >> 2) * NTW;  // its first column tile in each half of hd

  extern __shared__ __align__(128) unsigned char smem[];
  const SplitLayout L = split_layout(rk, HD, hpg, rv, a.nrk, a.nrv, a.chunk_heads, a.rc);
  const int rc = a.rc, nrc = (rk + rc - 1) / rc;  // rank chunks
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
  float* zk = sk + kTile;
  float* sv = sk + 2 * kTile;
  float* zv = sk + 3 * kTile;
  float* m_s = stat;
  float* l_s = stat + kMaxHeads;
  float* alpha_s = stat + 2 * kMaxHeads;
  float* zsum = stat + 3 * kMaxHeads;

  const size_t bg = static_cast<size_t>(b) * a.G + g;
  const uint8_t* kc = a.kc + bg * a.nrk * a.S;
  const uint8_t* vc = a.vc + bg * a.nrv * a.S;
  // per-row scales and zeros of token s at [s * sst]: v3's (B, S, 2G)
  // packed rows (scale in column g, zero in column G + g)
  const int sst = 2 * a.G;
  const size_t sz0 = static_cast<size_t>(b) * a.S * sst + g;
  const float* ksc = a.ks + sz0;
  const float* vsc = a.vs + sz0;
  const float* kzp = ksc + a.G;
  const float* vzp = vsc + a.G;
  const __nv_bfloat16* bk_g = a.bk + static_cast<size_t>(g) * hpg * rk * HD;

  for (int r = tid; r < rk; r += kThreads) ktab[r] = rank_entry(r, rk, a.pbits);
  for (int r = tid; r < rv; r += kThreads) vtab[r] = rank_entry(r, rv, a.pbits);
  for (int i = tid; i < hpg * HD; i += kThreads) {
    q_s[i] = q_at(a, (static_cast<size_t>(b) * nh + g * hpg) * HD + i);
    if (a.asym) {
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

  const int kvl = a.kv_len[b];
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
    if (nrc == 1) {  // all of B fits: staged once
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
      const int blk = s0 / a.block_s;
      if (blk != cur_blk) {
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
      // ---- load: packed K/V byte tiles, scales, rope rows (vector loads)
      load_byte_tile(kbytes, kc, a.nrk, a.S, s0, tid);
      load_byte_tile(vbytes, vc, a.nrv, a.S, s0, tid);
      if (tid < kTile) {
        const int s = s0 + tid;
        const bool in = s < a.S;
        sk[tid] = in ? ksc[s * sst] : 0.0f;
        sv[tid] = in ? vsc[s * sst] : 0.0f;
        zk[tid] = (in && a.asym) ? kzp[s * sst] : 0.0f;
        zv[tid] = (in && a.asym) ? vzp[s * sst] : 0.0f;
      }
      // rope rows: the block-relative ones
      const float* cos_src = a.rcos;
      const float* sin_src = a.rsin;
      const int row0 = s0 - blk * a.block_s;
      for (int i = tid; i < kTile * (half / 4); i += kThreads) {
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
      __syncthreads();
      const int tok_a = m0 + fg, tok_b = tok_a + 8;  // accumulator rows of this lane

      {
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
            float part_a = 0.0f, part_b = 0.0f;
#pragma unroll
            for (int j = 0; j < NTW; ++j) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int d = (jw + j) * 8 + 2 * ft + e;
                const float q1 = qh[d], q2 = qh[d + half];
                float k1 = acc[j][e] * sk_a, k2 = acc[NTW + j][e] * sk_a;
                float l1 = acc[j][e + 2] * sk_b, l2 = acc[NTW + j][e + 2] * sk_b;
                if (a.asym && ci == 0) {  // rs_b (all ranks)
                  k1 += zk_a * rsh[d];
                  k2 += zk_a * rsh[d + half];
                  l1 += zk_b * rsh[d];
                  l2 += zk_b * rsh[d + half];
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
      }
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

template <int HD>
int launch_split(const DecodeArgs& a, int B, cudaStream_t st) {
  const size_t smem =
      split_layout(a.rk, HD, a.hpg, a.rv, a.nrk, a.nrv, a.chunk_heads, a.rc).total;
  cudaError_t err = cudaFuncSetAttribute(palu_decode_split_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  palu_decode_split_kernel<HD><<<dim3(a.splits, a.G, B), kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Fit as many heads' B in shared memory as fit beside the rest (ranks in
// chunks of up to 128, and of fewer when not even one head's 128 rows of B
// fit), launch the split pass and then the combine into out (B, nh, rv)
// (decode_common.cuh). hd is 64 or 128.
inline int run_split(DecodeArgs& a, int B, int hd, float* out, cudaStream_t st) {
  a.chunk_heads = 0;
  const int rcs[4] = {min(a.rk, kRc), 64, 32, 16};
  for (int k = 0; k < 4 && a.chunk_heads == 0; ++k) {
    if (k > 0 && rcs[k] >= rcs[0]) continue;
    a.rc = rcs[k];
    a.chunk_heads = a.hpg;
    while (a.chunk_heads > 0 &&
           split_layout(a.rk, hd, a.hpg, a.rv, a.nrk, a.nrv, a.chunk_heads, a.rc).total >
               kSmemMax)
      --a.chunk_heads;
  }
  if (a.chunk_heads == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int err = hd == 128 ? launch_split<128>(a, B, st) : launch_split<64>(a, B, st);
  if (err != 0) return err;
  return decode::launch_combine(a.part_m, a.part_l, a.part_acc, out, B * a.G * a.hpg, a.splits,
                                a.rv, st);
}

}  // namespace
