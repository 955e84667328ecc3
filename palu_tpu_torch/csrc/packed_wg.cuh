// Shared pieces of the warp-specialised decodes over the rank-major packed
// cache (palu_decode_exact.cu, the exact K path and the v3 decode, and
// palu_decode_i8.cu, the int8 K-path modes): where a rank lives in a packed
// byte plane and its branch-free unpack, the K warpgroup's online softmax
// over one 64-token tile (which hands P^T to the V warpgroup in bf16 high
// and low parts), and the V warpgroup's value product on mma.sync with its
// write of the partials.
//
// P^T layout: rows of 128 bytes, one per head (NP rows of high parts, then
// NP of low parts); token t sits at K column k(t) (below), 16-byte chunks
// XOR-swizzled by the head, so that one ldmatrix gives a warp the B
// fragments of a 16-token k-step for 8 heads.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "hopper.cuh"

namespace packed {

constexpr int kTile = 64;      // tokens per tile (the wgmma M of the K warpgroup)
constexpr int kMaxHeads = 32;  // q-heads per group (Qwen2-7B: 28)

// Where rank r (of n) lives in a packed rank-major plane: byte row and bit
// shift of its field, and the row and shift of its high bit in the 1-bit
// plane of exact 3-bit packing (the field's own row otherwise, masked off
// by the unpack's hmask), in one word.
__device__ __forceinline__ uint32_t rank_entry(int r, int n, int pbits) {
  if (pbits == 3) {
    const int w2 = n / 4, w1 = n / 8;
    return static_cast<uint32_t>(r % w2) | (static_cast<uint32_t>(2 * (r / w2)) << 12) |
           (static_cast<uint32_t>(w2 + r % w1) << 16) | (static_cast<uint32_t>(r / w1) << 28);
  }
  const int w = n / (8 / pbits);
  return static_cast<uint32_t>(r % w) | (static_cast<uint32_t>(pbits * (r / w)) << 12) |
         (static_cast<uint32_t>(r % w) << 16);
}

// The unpack of one pack width: the field mask, and the high-bit mask (1
// for exact 3-bit packing, else 0). Branch-free, so that the loads of many
// codes overlap (each role has one warp per SM sub-partition).
struct Unpack {
  uint32_t mask, hmask;
  __device__ __forceinline__ explicit Unpack(int pbits)
      : mask(pbits == 3 ? 3u : (1u << pbits) - 1u), hmask(pbits == 3 ? 1u : 0u) {}
  // the code in field (lo, hi) of a byte pair at bit b (0 or 8) of each
  __device__ __forceinline__ int code(uint32_t w, uint32_t h, uint32_t e, int b) const {
    return static_cast<int>(((w >> (b + ((e >> 12) & 0xf))) & mask) |
                            (((h >> (b + (e >> 28))) & hmask) << 2));
  }
};

// The codes of one rank (entry e) at tokens t and t + 1 (t even) of a
// (rows, 64) byte tile: c0 at t, c1 at t + 1.
__device__ __forceinline__ void code_pair(const uint8_t* tile, uint32_t e, int t, const Unpack& u,
                                          int& c0, int& c1) {
  const uint32_t w = *reinterpret_cast<const uint16_t*>(tile + (e & 0xfff) * kTile + t);
  const uint32_t h = *reinterpret_cast<const uint16_t*>(tile + ((e >> 16) & 0xfff) * kTile + t);
  c0 = u.code(w, h, e, 0);
  c1 = u.code(w, h, e, 8);
}

// One bf16 pair (v0, v1) split into its bf16 high part and the bf16 of the rest.
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = hopper::pack_bf16(v0 - hf.x, v1 - hf.y);
}

// Softmax statistics of a work item in shared memory: per head the running
// max m, the denominator l, the last tile's rescale factor alpha and (per-row
// asym) the sum of p * zero_v.
struct Stats {
  float *m, *l, *alpha, *zsum;
};

// The online softmax of one tile, one warp per head (of 4 warps): heads
// [h0, h1) take the tile's logits lg[h][t] at columns s0 + t inside [vlo,
// vhi); the other heads of the group keep their statistics (alpha 1) and
// get p = 0. Writes P^T (pt: high then low parts) for the V product: per-row
// scales (!CHUNKED) p * scale_v (vsc) and, asym, the zero term's sum of p *
// zero_v (vzc), restarted at the item's first tile (`first`). Heads past
// hpg are padding rows of P^T, which stay 0 (hpg <= NP, kMaxHeads).
template <int NP, bool CHUNKED>
__device__ __forceinline__ void softmax_tile(uint8_t* pt, const float* lg, const Stats& st,
                                             int hpg, int h0, int h1, int s0, int vlo, int vhi,
                                             bool first, const float* vsc, const float* vzc,
                                             int asym, int warp, int lane) {
  for (int hb = 0; hb < hpg; hb += 4) {
    const int h = hb + warp;
    const bool hv = h >= h0 && h < h1;  // warp-uniform
    float x[2], mx = -1e30f;
    bool ok[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = lane + 32 * u, s = s0 + t;
      ok[u] = hv && s >= vlo && s < vhi;
      x[u] = ok[u] ? lg[h * kTile + t] : -1e30f;
      mx = fmaxf(mx, x[u]);
    }
    mx = decode::warp_max(mx);
    const float m_old = hv ? st.m[h] : 0.0f, m_new = fmaxf(m_old, mx);
    const float alpha = hv ? expf(m_old - m_new) : 1.0f;
    float sum = 0.0f, zs = 0.0f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = lane + 32 * u;
      const float p = ok[u] ? expf(x[u] - m_new) : 0.0f;
      sum += p;
      float pw = p;
      if constexpr (!CHUNKED) {
        pw = ok[u] ? p * vsc[t] : 0.0f;
        zs += ok[u] && asym ? p * vzc[t] : 0.0f;
      }
      const __nv_bfloat16 ph = __float2bfloat16_rn(pw);
      const __nv_bfloat16 pl = __float2bfloat16_rn(pw - __bfloat162float(ph));
      // K column of token t (the V warpgroup's A holds tokens 16q .. 16q + 15)
      const int k = 16 * ((t & 15) >> 2) + 8 * ((t & 3) >> 1) + 2 * (t >> 4) + (t & 1);
      const uint32_t off = h * 128 + ((((k >> 3) ^ (h & 7)) << 4) | ((k & 7) << 1));
      *reinterpret_cast<__nv_bfloat16*>(pt + off) = ph;
      *reinterpret_cast<__nv_bfloat16*>(pt + NP * 128 + off) = pl;
    }
    sum = decode::warp_sum(sum);
    if constexpr (!CHUNKED) zs = decode::warp_sum(zs);
    if (hv) {  // every lane holds the warp's results
      st.m[h] = m_new;
      st.l[h] = st.l[h] * alpha + sum;
      // (restarted at the item's first tile: the V side wrote the last
      // item's partials before its p_empty, which this softmax waited)
      st.zsum[h] = (first ? 0.0f : st.zsum[h] * alpha) + zs;
    }
    st.alpha[h] = alpha;
  }
}

// The V warpgroup's product of one tile: acc (per 64-rank tile mt and
// 8-head tile j: rows gq, gq + 8 of this warp's 16 ranks) rescaled by each
// head's alpha, then out^T (rv x heads) += Vdeq (rv x 64 tokens) . P^T per
// warp on mma.sync m16n8k16. A: per-row scales, the raw codes (code - qoff,
// exact in bf16; the scale rides in P); per chunk (gsv ranks a scale row),
// the dequantized values in bf16 high and low parts (hi.hi + hi.lo + lo.hi:
// the f32 class). Tokens outside the valid columns weigh p = 0 in P^T.
template <int NP, int MT, bool CHUNKED>
__device__ __forceinline__ void v_tile(float (&acc)[MT][NP / 8][4], const uint8_t* pt,
                                       const float* alpha_s, const uint8_t* vbytes,
                                       const float* vsc, const float* vzc, const uint32_t* vtab,
                                       int rv, int gsv, int asym, int qoff, const Unpack& un,
                                       int warp, int lane) {
  const int gq = lane / 4, qd = lane % 4;
  const int nmt = (rv + 63) / 64;
  // rescale by the tile's alpha: columns 8j + 2q + {0, 1} are heads
#pragma unroll
  for (int j = 0; j < NP / 8; ++j) {
    const float2 al = *reinterpret_cast<const float2*>(alpha_s + 8 * j + 2 * qd);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      acc[mt][j][0] *= al.x, acc[mt][j][1] *= al.y;
      acc[mt][j][2] *= al.x, acc[mt][j][3] *= al.y;
    }
  }
  // this thread's 16 tokens 16q .. 16q + 15: K columns 16kk + 8hh + 2q +
  // {0, 1} hold tokens 16q + 4kk + 2hh + {0, 1} (P^T is stored so)
  const int t0 = 16 * qd;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (mt >= nmt) continue;
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      // A row: rank r; rows past rv (a real rank's codes) are never written out
      const int rl = min(mt * 64 + 16 * warp + gq + 8 * rr, rv - 1);
      const uint32_t e = vtab[rl];
      const uint4 wv = *reinterpret_cast<const uint4*>(vbytes + (e & 0xfff) * kTile + t0);
      const uint4 hv = *reinterpret_cast<const uint4*>(vbytes + ((e >> 16) & 0xfff) * kTile + t0);
      // four tokens at a time: x is k-step kk's tokens 4kk .. 4kk + 3
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const uint32_t wd = x == 0 ? wv.x : x == 1 ? wv.y : x == 2 ? wv.z : wv.w;
        const uint32_t hd = x == 0 ? hv.x : x == 1 ? hv.y : x == 2 ? hv.z : hv.w;
        float v[4];
#pragma unroll
        for (int y = 0; y < 4; ++y) v[y] = static_cast<float>(un.code(wd, hd, e, 8 * y) - qoff);
        if constexpr (CHUNKED) {
          const int sc = rl / gsv;
          const float4 s4 = *reinterpret_cast<const float4*>(vsc + sc * kTile + t0 + 4 * x);
          const float4 z4 = asym ? *reinterpret_cast<const float4*>(vzc + sc * kTile + t0 + 4 * x)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          v[0] = fmaf(s4.x, v[0], z4.x), v[1] = fmaf(s4.y, v[1], z4.y);
          v[2] = fmaf(s4.z, v[2], z4.z), v[3] = fmaf(s4.w, v[3], z4.w);
          split_bf16(v[0], v[1], ah[x][rr], al[x][rr]);
          split_bf16(v[2], v[3], ah[x][2 + rr], al[x][2 + rr]);
        } else {
          ah[x][rr] = hopper::pack_bf16(v[0], v[1]);
          ah[x][2 + rr] = hopper::pack_bf16(v[2], v[3]);
        }
      }
    }
    // per warp: its 16 ranks x NP heads += A (16 ranks x 16 tokens) . P
    // (16 tokens x 8 heads) per k-step and 8-head tile, mma.sync (the
    // accumulators hold the m64nNP layout's rows of this warp); B fragments
    // of P^T high and low by one ldmatrix
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        const int m = lane >> 3, h = 8 * j + (lane & 7), u = 2 * kk + (m & 1);
        uint32_t bf[4];
        decode::ldmatrix_x4(bf, reinterpret_cast<const __nv_bfloat16*>(
                                    pt + (m >> 1) * NP * 128 + h * 128 + ((u ^ (h & 7)) << 4)));
        decode::mma_bf16(acc[mt][j], ah[kk], bf[0], bf[1]);  // A (hi) . P hi
        decode::mma_bf16(acc[mt][j], ah[kk], bf[2], bf[3]);  // A (hi) . P lo
        if constexpr (CHUNKED) decode::mma_bf16(acc[mt][j], al[kk], bf[0], bf[1]);  // A lo . P hi
      }
    }
  }
}

// The V warpgroup's partial accumulators of a work item: element e of tile
// (mt, j) is rank mt*64 + 16w + gq (+8 for e >= 2), head 8j + 2q + e % 2;
// plus, per-row asym, the zero term sum_s p(s) zero_v(s) of the head (none
// for an item with no tile: any false).
template <int NP, int MT>
__device__ __forceinline__ void v_store(const float (&acc)[MT][NP / 8][4], float* part_acc,
                                        const float* zsum_s, bool any, size_t head0, int splits,
                                        int split, int rv, int hpg, int warp, int lane) {
  const int gq = lane / 4, qd = lane % 4;
  const int nmt = (rv + 63) / 64;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (mt >= nmt) continue;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = mt * 64 + 16 * warp + gq + 8 * (e >> 1), h = 8 * j + 2 * qd + (e & 1);
        const float zs = any ? zsum_s[min(h, kMaxHeads - 1)] : 0.0f;
        if (r < rv && h < hpg) part_acc[((head0 + h) * splits + split) * rv + r] = acc[mt][j][e] + zs;
      }
  }
}

}  // namespace packed
