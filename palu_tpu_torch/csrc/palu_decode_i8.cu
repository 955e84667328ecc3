// Latent decode attention over the rank-major packed cache in the int8
// K-path modes, for Hopper: the query-folded operand built in shared memory
// by its own warps, the int8 dots on warpgroup MMA (wgmma s8), the value
// product on mma.sync, a TMA-fed mbarrier ring of cache tiles, one wave of
// blocks.
//
// Replaces: palu_tpu/ops/pallas/palu_decode4.py::palu_flash_decode4_quantized
// (body _make_kernel4, launch _call4) in its int8 K-path modes, MODE 1
// (int8_dots: k_path, :361-383, with the zero correction :423-446) and
// MODE 2 (int8_rot: k_path_i8, :448-510), per-row scales, sym and asym,
// pack widths 2, 3 and 4, with the pre-RoPE K bias (k_bias), pos_offset,
// return_stats and layer_idx.
//
// What it computes, per lane b, group g, q-head h (reading kv-head h / rep)
// and rotation block j of block_s tokens (a1 / a2 the halves of q_h /
// sqrt(hd) rotated to the block's absolute start by c0 / s0; B1 / B2 the
// halves of the kv-head's B, rk x hd/2 each):
//   bq1 = a1 B1^T + a2 B2^T, bq2 = a2 B1^T - a1 B2^T   (hd/2 x rk each, f32)
//   n1 = round(bq1 / s1), n2 = round(bq2 / s2)   int8; s = max|row| / 127 per
//       row (int8_dots) or per head and half (int8_rot)
//   u(t) = n1 . code(t), v(t) = n2 . code(t)      int32, raw unsigned codes
//   int8_dots: main(t) = sum_e (u_e s1_e) rcos(t,e) + (v_e s2_e) rsin(t,e)
//   int8_rot:  main(t) = (sum_e cos8(t,e) u_e) s1 i8r_inv + (sum_e sin8(t,e) v_e) s2 i8r_inv
//   logit(t) = main(t) scale_k(t) + corr(t) zero_k(t) + bias(t)
//       corr(t) = sum_e r1_e rcos(t,e) + r2_e rsin(t,e), r = rowsum(n) s
//       bias(t) = sum_e U_b,e rcos(t,e) + V_b,e rsin(t,e), U_b = a1 b1 + a2 b2,
//                 V_b = a2 b1 - a1 b2 (b the K bias), with zero_k = -qoff scale_k (sym)
//   out_h = sum_t softmax(logit)(t) (scale_v(t) (code_v(t) - qoff) [+ zero_v(t)])
// (t block-relative for the tables), masked by kv_len and the window ->
// (B, nh, rv) in latent space.
//
// Bound on this card: the dots are 2 rk hd int8 operations per q-head and
// token (at the Llama-2-7B group, 4 heads at rk 128: 131 kop per token and
// group) against (rk + rv) bits / 8 bytes of codes: 512 int8 operations per
// byte, above the card's ~590 (1979 TOP/s over 3.35 TB/s) only for wider
// groups, so bytes bound it; each rotation block also folds the query into
// hpg hd/2 x rk operand rows (f32, ~10 operations per element).
//
// Design. A block is 3 warpgroups (roles broadcast warp-uniform):
//  - producer (setmaxnreg 40): thread 0 keeps a ring of 2-3 tile stages full
//    by TMA, as the exact kernel's (a stage: one 64-token tile of the K and
//    V byte planes and the scale, and zero, rows); warps 1-3 (96 threads)
//    build the operand of each (work item, head chunk, rotation block) from
//    B staged by TMA into shared memory (with 4-byte loads of B from L2 a
//    build took 90-150 us): while the K and V warpgroups still read the last
//    operand they fold the query into bq1 | bq2 and find each row's (or
//    half's) max and scale, then, once the slot is free, quantize and write
//    hd int8 rows of rk bytes per head, K-major with the 128-byte swizzle
//    wgmma reads, with the row scales, the scaled row sums r (the
//    correction) and U_b | V_b (the bias). Two slots where they fit beside
//    3 tile stages (the next block's operand then built ahead), else one.
//    The ranks sit in the K order the A tile is cheapest to build in (4-bit
//    packing: k-step kk holds byte rows 16kk .. 16kk + 15, low nibbles first,
//    then high);
//  - K warpgroup (setmaxnreg 232): per tile, unpacks the codes into an s8
//    A tile in shared memory, K-major and swizzled as the operand (4-bit:
//    four 16-bit loads of two tokens and a byte transpose by prmt per
//    k-step; each thread writes its tokens ta and ta + 1 to rows gq and gq +
//    8 of its warp, the rows of its accumulators; A in registers spilled
//    beside two accumulators and took twice as long), and per q-head of the
//    chunk runs u | v (64 tokens x hd) = codes . operand^T as m64n(hd)k32
//    s32.s8.s8 wgmma, both operands in shared memory, head h + 1's products
//    under head h's epilogue: column e and e + hd/2 (u and v of one
//    frequency) lie in one thread's accumulators; the rotation (f32 against
//    the tile's rcos / rsin rows, or int32 against its cos8 / sin8 rows),
//    the correction (r . rcos + r . rsin from the same f32 rows), a quad
//    shuffle, the token scale, the correction times the token's zero and the
//    bias; then the online softmax, which writes P^T (p * scale_v in bf16
//    high and low parts) for the V warpgroup. int8_dots over symmetric codes
//    takes code - qoff in its A tile instead of a correction (sum_r n (code -
//    qoff) = u - qoff rowsum(n), the same sum in exact integers);
//  - V warpgroup (setmaxnreg 232): per tile, forms the K bias's term per
//    head and token (from U_b | V_b and the f32 rows in L2, into one of two
//    buffers, before the K side frees the rows), copies the tile's rotation
//    rows (rcos / rsin f32; int8_rot also cos8 / sin8) into shared memory,
//    then runs the exact kernel's value product of the previous tile
//    (packed_wg.cuh).
// Heads whose operands do not fit in shared memory at once (Qwen2-7B's 28
// heads at rk 256) go in chunks: a work item walks its tiles once per chunk
// (a visit is one chunk on one tile), the other heads' statistics held.
// mbarriers order it all: full / empty per stage, ofull / oempty per operand
// slot, one per staging buffer of B, rope_full / rope_empty (the rotation
// rows and bias term of a visit) and p_full / p_empty (P^T and alpha).
//
// The grid is one wave: work items (lane, group, sequence split) number at
// most SMs (the wrapper's _splits), blocks min(items, SMs), each looping
// over items; the splits of a (lane, group) cut its valid tiles
// (decode::tile_range); an item may start inside a rotation block (it builds
// that block's operand); block_s % 64 == 0, so no tile straddles two. A
// split with no tile writes m = -1e30, l = 0, acc = 0; the combine kernel
// (decode_common.cuh) merges the splits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "hopper.cuh"
#include "packed_wg.cuh"

namespace {

using namespace hopper;
using packed::code_pair;
using packed::kMaxHeads;
using packed::kTile;
using packed::rank_entry;
using packed::Unpack;

constexpr int kWG = 128;        // threads per warpgroup
constexpr int kThreads = 3 * kWG;
constexpr int kBuilders = 96;   // warps 1-3 of the producer warpgroup
constexpr int kMaxRank = 512;
constexpr int kMaxKSteps = 8;   // k32 steps of one chain (256 ranks)
constexpr int kSmemBudget = static_cast<int>(decode::kSmemMax) - 1024;  // - alignment slack

// The shared-memory plan (ops/palu_decode.py::_i8_plan is the same function
// in Python): ns stages of one tile; nob operand slots, each `chunk` heads'
// int8 operands (nkb K-blocks of hd rows x 128 bytes per head) and their
// per-row scales, scaled row sums and (bias) U_b | V_b; nst staging buffers
// of B, bch ranks x hd bf16 each (bch = min(rk, 128)), which the builder
// fills by TMA; the A tile of the dots (64 tokens x rk s8 codes, K-major,
// swizzled as the operand); the rotation rows of a visit (rcos / rsin f32,
// rows of hd/2 + 4; int8_rot also cos8 / sin8, rows of hd/2 + 4 bytes); the
// bias term per chunk head and token (two visits); P^T (high, low); the
// logits; the rank tables; softmax statistics; the builder's scratch (a1 |
// a2, row maxima, row sums); the mbarriers.
struct Plan {
  int ok, ns, nob, nst, chunk, nch, nkb, bch;
  int rows_k, nbox_k, rows_v, nbox_v;
  uint32_t stage_bytes, tx_bytes;
  uint32_t kc, vc, ks, kz, vs, vz;  // within a stage
  uint32_t head_bytes, slot_bytes;  // one head's int8 operand; one slot
  uint32_t osc, ors, bqb;           // within a slot: per-row f32 arrays
  uint32_t slots, stg, stg_bytes, atile, rope, corr, p, lg, vtab, ktab, stats, scratch, bars;
  uint32_t total;
};

inline uint32_t up(uint32_t x, uint32_t a) { return (x + a - 1) / a * a; }

Plan make_plan(int hd, int rk, int rv, int hpg, int nrk, int nrv, int asym, int mode, int bias) {
  Plan p{};
  const int np = hpg <= 8 ? 8 : 32;
  p.nbox_k = (nrk + 255) / 256;
  p.rows_k = (nrk + p.nbox_k - 1) / p.nbox_k;
  p.nbox_v = (nrv + 255) / 256;
  p.rows_v = (nrv + p.nbox_v - 1) / p.nbox_v;
  uint32_t o = 0;
  p.kc = o; o = up(o + p.nbox_k * p.rows_k * kTile, 128);
  p.vc = o; o = up(o + p.nbox_v * p.rows_v * kTile, 128);
  p.ks = o; o = up(o + kTile * 4, 128);
  p.kz = o; o = up(o + (asym ? kTile * 4 : 0), 128);
  p.vs = o; o = up(o + kTile * 4, 128);
  p.vz = o; o = up(o + (asym ? kTile * 4 : 0), 128);
  p.stage_bytes = o;
  p.tx_bytes = (p.nbox_k * p.rows_k + p.nbox_v * p.rows_v) * kTile + (1 + asym) * 2 * kTile * 4;
  p.nkb = (rk + 127) / 128;
  p.head_bytes = p.nkb * hd * 128;
  const int half = hd / 2;
  auto layout = [&](int ns, int nob, int nst, int bch, int chunk) {
    p.bch = bch;
    p.stg_bytes = bch * hd * 2;
    p.osc = chunk * p.head_bytes;
    p.ors = p.osc + chunk * hd * 4;
    p.bqb = p.ors + chunk * hd * 4;
    p.slot_bytes = up(p.bqb + (bias ? chunk * hd * 4 : 0), 1024);
    p.slots = up(ns * p.stage_bytes, 1024);
    uint32_t t = p.slots + nob * p.slot_bytes;
    p.stg = t; t += nst * p.stg_bytes;
    p.atile = up(t, 1024); t = p.atile + p.nkb * kTile * 128;
    p.rope = t;
    t += 2 * kTile * (half + 4) * 4 + (mode == 2 ? up(2 * kTile * (half + 4), 16) : 0);
    p.corr = t; t += 2 * chunk * kTile * 4;  // [2 visits] the bias term (0 without)
    p.p = up(t, 1024); t = p.p + 2 * np * 128;
    p.lg = t; t += hpg * kTile * 4;
    p.vtab = t; t += rv * 4;
    p.ktab = t; t += rk * 4;
    p.stats = t; t += 4 * kMaxHeads * 4;
    p.scratch = t; t += 4 * chunk * hd * 4;  // a1 | a2, row maxima, row sums, scales
    p.bars = up(t, 8); t = p.bars + 8 * (2 * ns + 2 * nob + nst + 4);
    return t;
  };
  // all heads in one chunk: two slots, else one, two staging buffers, else
  // one (of up to 128 ranks of B, else 64, else 32); then chunks of fewer
  // heads. (Two slots with 2 stages and smaller staging buffers ran slower
  // at the Llama group than one with 3: the builder then runs all the time
  // beside the K and V warpgroups.)
  const int tries[5][3] = {{2, 3, 2}, {2, 3, 1}, {1, 3, 2}, {1, 3, 1}, {1, 2, 1}};  // nob, ns, nst
  const int bchs[3] = {rk < 128 ? rk : 128, 64, 32};
  for (int pass = 0; pass < 2; ++pass) {
    for (int bi = 0; bi < 3; ++bi) {
      if (bi > 0 && bchs[bi] >= bchs[0]) continue;
      for (const auto& tr : tries) {
        for (int chunk = pass == 0 ? hpg : hpg - 1; chunk >= 1; --chunk) {
          const uint32_t total = layout(tr[1], tr[0], tr[2], bchs[bi], chunk);
          if (total <= static_cast<uint32_t>(kSmemBudget)) {
            p.ok = 1, p.nob = tr[0], p.ns = tr[1], p.nst = tr[2], p.chunk = chunk;
            p.nch = (hpg + chunk - 1) / chunk, p.total = total;
            return p;
          }
          if (pass == 0) break;
        }
      }
    }
  }
  p.ok = 0;
  return p;
}

struct I8Args {
  const void* q;            // (B, nh, hd) bf16 or f32, roped at the current position
  int q_bf16;
  const __nv_bfloat16* bk;  // (G, nkv, rk, hd)
  const float* kbias;       // (G, nkv, hd) pre-RoPE K bias, or null
  const float* c0;          // (S / block_s, hd/2): rotation at each block's absolute start
  const float* s0;
  const float* rcos;        // (block_s, hd/2) block-relative rotation, f32
  const float* rsin;
  const int8_t* cos8;       // int8_rot: (block_s, hd/2) at scale 63 / cmax
  const int8_t* sin8;
  const int* kv_len;        // (B,) absolute
  float* part_m;            // (B, nh, splits)
  float* part_l;
  float* part_acc;          // (B, nh, splits, rv)
  int B, G, hpg, nkv, rep, rk, rv, S, pbits, qoff, asym, window;
  int splits, n_items, layer, pos_offset, block_s;
  float sqrt_hd, i8r_inv;
  Plan L;
};

// A work item's coordinates and its tile range [t0, t1) (empty when t1 <= t0).
struct Item {
  int b, g, split, t0, t1, vlo, vhi;  // vlo / vhi: valid columns [vlo, vhi)
};

__device__ __forceinline__ Item item_at(const I8Args& a, int item) {
  Item it;
  it.split = item % a.splits;
  const int bg = item / a.splits;
  it.g = bg % a.G;
  it.b = bg / a.G;
  const decode::TileRange r = decode::tile_range(a.kv_len[it.b], a.pos_offset, a.window, a.S,
                                                 a.splits, it.split, kTile);
  it.t0 = r.t0, it.t1 = r.t1, it.vlo = r.vlo, it.vhi = r.vhi;
  return it;
}

// Visit vi of an item: head chunk c on tile `tile`; a new operand is needed
// at the item's first tile of each chunk and where a rotation block starts.
struct Visit {
  int c, tile, newb;
};

__device__ __forceinline__ Visit visit_at(const Item& w, int vi, int block_s) {
  const int nt = w.t1 - w.t0;
  Visit v;
  v.c = vi / nt;
  v.tile = w.t0 + vi % nt;
  v.newb = v.tile == w.t0 || (v.tile * kTile) % block_s == 0;
  return v;
}

// The K position of rank r in the operand and the A fragments: 4-bit
// packing puts byte rows 16kk .. 16kk + 15 in k-step kk, their low nibbles
// (ranks) at positions 32kk + 0..15 and high nibbles (ranks + rk / 2) at
// 32kk + 16..31; other widths keep rank order. Four ranks r .. r + 3 (r % 4
// == 0) take four consecutive positions.
__device__ __forceinline__ int kpos(int r, int rk, int pbits) {
  if (pbits != 4) return r;
  const int w = rk / 2, hi = r >= w, rr = hi ? r - w : r;
  return 32 * (rr / 16) + 16 * hi + rr % 16;
}

// Byte offset of row n, K position k (k % 4 == 0 for a word) in a K-major
// s8 operand of ROWS rows (a head's operand: hd; the A tile: 64 tokens):
// K-blocks of ROWS rows x 128 bytes, 16-byte chunks swizzled by the row
// (the 128-byte swizzle of wgmma's K-major layout).
template <int ROWS>
__device__ __forceinline__ uint32_t op_off(int n, int k) {
  return (k >> 7) * ROWS * 128 + n * 128 + ((((k & 127) >> 4) ^ (n & 7)) << 4) + (k & 15);
}

// The tile's codes as the dots' A operand (64 tokens x rk s8, K-major,
// swizzled) in shared memory at `at`: this thread's tokens ta and ta + 1 go
// to rows ra and ra + 8 of its warp (the rows of its accumulators), K
// positions 4qd .. 4qd + 3 and 16 + 4qd .. of each of the nks k-steps; each
// byte less `sub`'s (the symmetric offset, or 0).
template <bool P4>
__device__ __forceinline__ void k_tile(uint8_t* at, const uint8_t* kbytes, const uint32_t* ktab,
                                       int nks, int ta, int ra, int qd, const Unpack& un,
                                       uint32_t sub) {
  for (int kk = 0; kk < nks; ++kk) {
    uint32_t w[4];  // token ta at 4qd.., ta + 1 there, ta at 16 + 4qd.., ta + 1 there
    if constexpr (P4) {
      // byte rows 16kk + 4qd + i: low nibbles are positions 4qd + i, high
      // ones 16 + 4qd + i; each 16-bit load holds tokens ta and ta + 1
      const uint8_t* src = kbytes + (16 * kk + 4 * qd) * kTile + ta;
      const uint32_t w0 = *reinterpret_cast<const uint16_t*>(src);
      const uint32_t w1 = *reinterpret_cast<const uint16_t*>(src + kTile);
      const uint32_t w2 = *reinterpret_cast<const uint16_t*>(src + 2 * kTile);
      const uint32_t w3 = *reinterpret_cast<const uint16_t*>(src + 3 * kTile);
      const uint32_t p01 = __byte_perm(w0, w1, 0x5140), p23 = __byte_perm(w2, w3, 0x5140);
      const uint32_t ta4 = __byte_perm(p01, p23, 0x5410), tb4 = __byte_perm(p01, p23, 0x7632);
      w[0] = ta4 & 0x0F0F0F0Fu;
      w[1] = tb4 & 0x0F0F0F0Fu;
      w[2] = (ta4 >> 4) & 0x0F0F0F0Fu;
      w[3] = (tb4 >> 4) & 0x0F0F0F0Fu;
    } else {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        uint32_t x0 = 0, x1 = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          int c0, c1;
          code_pair(kbytes, ktab[32 * kk + 16 * hh + 4 * qd + i], ta, un, c0, c1);
          x0 |= static_cast<uint32_t>(c0) << (8 * i);
          x1 |= static_cast<uint32_t>(c1) << (8 * i);
        }
        w[2 * hh] = x0;
        w[2 * hh + 1] = x1;
      }
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) w[x] = __vsub4(w[x], sub);  // per byte: code - qoff, or code
    const int k = 32 * kk + 4 * qd;
    *reinterpret_cast<uint32_t*>(at + op_off<kTile>(ra, k)) = w[0];
    *reinterpret_cast<uint32_t*>(at + op_off<kTile>(ra + 8, k)) = w[1];
    *reinterpret_cast<uint32_t*>(at + op_off<kTile>(ra, k + 16)) = w[2];
    *reinterpret_cast<uint32_t*>(at + op_off<kTile>(ra + 8, k + 16)) = w[3];
  }
}

template <int HD>
__device__ __forceinline__ void wgmma_i8(uint32_t (&d)[HD / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (HD == 128) {
    wgmma_s8_n128(d, da, db, scale_d);
  } else {
    wgmma_s8_n64(d, da, db, scale_d);
  }
}

// The descriptor of k-step kk of a K-major s8 operand of ROWS rows at
// `addr` (shared address).
template <int ROWS>
__device__ __forceinline__ uint64_t k_desc(uint32_t addr, int kk) {
  return sw128_desc(addr + (kk >> 2) * ROWS * 128 + (kk & 3) * 32, 16, 1024);
}

// kv (+)= k-steps kk0 .. kk0 + N - 1 of the A tile at `at` . the head
// operand at `head`, one unguarded chain (a guard between the products of a
// chain makes ptxas serialize them, C7520).
template <int HD, int N>
__device__ __forceinline__ void k_chain(uint32_t (&kv)[HD / 2], uint32_t at, uint32_t head,
                                        int kk0, int first) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    wgmma_i8<HD>(kv, k_desc<kTile>(at, kk0 + j), k_desc<HD>(head, kk0 + j), j > 0 || !first);
}

template <int HD>
__device__ __forceinline__ void k_chain_n(int n, uint32_t (&kv)[HD / 2], uint32_t at,
                                          uint32_t head, int kk0, int first) {
  switch (n) {
    case 1: k_chain<HD, 1>(kv, at, head, kk0, first); break;
    case 2: k_chain<HD, 2>(kv, at, head, kk0, first); break;
    case 3: k_chain<HD, 3>(kv, at, head, kk0, first); break;
    case 4: k_chain<HD, 4>(kv, at, head, kk0, first); break;
    case 5: k_chain<HD, 5>(kv, at, head, kk0, first); break;
    case 6: k_chain<HD, 6>(kv, at, head, kk0, first); break;
    case 7: k_chain<HD, 7>(kv, at, head, kk0, first); break;
    default: k_chain<HD, kMaxKSteps>(kv, at, head, kk0, first); break;
  }
}

// Issue one head's dots (all nks k-steps) into kv, one commit group.
template <int HD>
__device__ __forceinline__ void k_issue(uint32_t (&kv)[HD / 2], int nks, uint32_t at,
                                        uint32_t head) {
  fence_regs(kv);
  wgmma_fence();
  k_chain_n<HD>(min(nks, kMaxKSteps), kv, at, head, 0, 1);
  if (nks > kMaxKSteps) k_chain_n<HD>(nks - kMaxKSteps, kv, at, head, kMaxKSteps, 0);
  wgmma_commit();
}

// The epilogue of q-head h (chunk head hc) on its u | v accumulators (rows:
// tokens ta, ta + 1; columns 8jj + 2q + {0, 1}, u below hd/2, v above): the
// rotation of MODE against the visit's rows, with (CORR) the correction
// sum_e r1_e rcos + r2_e rsin from the same f32 rows and the head's scaled
// row sums `ors`, a quad shuffle, then the token scale, the correction times
// the token's zero and the bias, into lg.
template <int HD, int MODE, bool CORR>
__device__ __forceinline__ void k_finish(const uint32_t (&kv)[HD / 2], const float* osc,
                                         const float* ors, const float* cos_s,
                                         const float* sin_s, const int8_t* c8s,
                                         const int8_t* s8s, const float* bias, float i8r_inv,
                                         float ska, float skb, float zka, float zkb, float* lg,
                                         int h, int hc, int ta, int qd) {
  constexpr int NJ = HD / 8, HALF = HD / 2, RS = HALF + 4, C8 = HALF + 4;
  float pa = 0.0f, pb = 0.0f, ca = 0.0f, cb = 0.0f;
  int ia1 = 0, ia2 = 0, ib1 = 0, ib2 = 0;
#pragma unroll
  for (int jj = 0; jj < NJ / 2; ++jj) {
    const int f = 8 * jj + 2 * qd, u = 4 * jj, v = 4 * (jj + NJ / 2);
    const float2 xa = *reinterpret_cast<const float2*>(cos_s + ta * RS + f);
    const float2 ya = *reinterpret_cast<const float2*>(sin_s + ta * RS + f);
    const float2 xb = *reinterpret_cast<const float2*>(cos_s + (ta + 1) * RS + f);
    const float2 yb = *reinterpret_cast<const float2*>(sin_s + (ta + 1) * RS + f);
    if constexpr (CORR) {
      const float2 r1 = *reinterpret_cast<const float2*>(ors + f);
      const float2 r2 = *reinterpret_cast<const float2*>(ors + HALF + f);
      ca += r1.x * xa.x + r2.x * ya.x + r1.y * xa.y + r2.y * ya.y;
      cb += r1.x * xb.x + r2.x * yb.x + r1.y * xb.y + r2.y * yb.y;
    }
    if constexpr (MODE == 1) {
      const float2 s1 = *reinterpret_cast<const float2*>(osc + f);
      const float2 s2 = *reinterpret_cast<const float2*>(osc + HALF + f);
      const auto x = [&](int i) { return static_cast<float>(static_cast<int>(kv[i])); };
      pa += (x(u) * s1.x) * xa.x + (x(v) * s2.x) * ya.x;
      pa += (x(u + 1) * s1.y) * xa.y + (x(v + 1) * s2.y) * ya.y;
      pb += (x(u + 2) * s1.x) * xb.x + (x(v + 2) * s2.x) * yb.x;
      pb += (x(u + 3) * s1.y) * xb.y + (x(v + 3) * s2.y) * yb.y;
    } else {
      const char2 c8a = *reinterpret_cast<const char2*>(c8s + ta * C8 + f);
      const char2 s8a = *reinterpret_cast<const char2*>(s8s + ta * C8 + f);
      const char2 c8b = *reinterpret_cast<const char2*>(c8s + (ta + 1) * C8 + f);
      const char2 s8b = *reinterpret_cast<const char2*>(s8s + (ta + 1) * C8 + f);
      const auto x = [&](int i) { return static_cast<int>(kv[i]); };
      ia1 += c8a.x * x(u) + c8a.y * x(u + 1);
      ia2 += s8a.x * x(v) + s8a.y * x(v + 1);
      ib1 += c8b.x * x(u + 2) + c8b.y * x(u + 3);
      ib2 += s8b.x * x(v + 2) + s8b.y * x(v + 3);
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    if constexpr (MODE == 1) {
      pa += __shfl_xor_sync(0xffffffffu, pa, o);
      pb += __shfl_xor_sync(0xffffffffu, pb, o);
    } else {
      ia1 += __shfl_xor_sync(0xffffffffu, ia1, o);
      ia2 += __shfl_xor_sync(0xffffffffu, ia2, o);
      ib1 += __shfl_xor_sync(0xffffffffu, ib1, o);
      ib2 += __shfl_xor_sync(0xffffffffu, ib2, o);
    }
    if constexpr (CORR) {
      ca += __shfl_xor_sync(0xffffffffu, ca, o);
      cb += __shfl_xor_sync(0xffffffffu, cb, o);
    }
  }
  if constexpr (MODE == 2) {
    const float w1 = osc[0] * i8r_inv, w2 = osc[HALF] * i8r_inv;  // one scale per half
    pa = static_cast<float>(ia1) * w1 + static_cast<float>(ia2) * w2;
    pb = static_cast<float>(ib1) * w1 + static_cast<float>(ib2) * w2;
  }
  // the correction and the bias are cache-independent: after the token scale
  const float* bh = bias + hc * kTile;
  lg[h * kTile + ta] = pa * ska + ca * zka + bh[ta];  // every lane of the quad holds the sums
  lg[h * kTile + ta + 1] = pb * skb + cb * zkb + bh[ta + 1];
}

// Shared-memory views of an operand slot.
struct Slot {
  uint32_t ops;       // shared address of head 0's int8 operand
  uint8_t* bytes;     // the same, generic
  float *osc, *ors, *bqb;
};

// The builder's staging ring of B: buffer 0's shared address and generic
// pointer, its full barriers (one per buffer), and the count of entries
// staged by the builds before this one (the ring's position).
struct Stager {
  uint32_t stg, bars;
  const uint8_t* p;
  int n;
};

// Stage entry j of a build's sequence into its ring buffer by TMA: the
// rank chunks (bch rows of B, the kv-head's) of each head of the build,
// heads h0 .. in order, once for the scales' pass and again for the int8
// rows' (entry j: pass j / (nc nck), head, chunk). Ranks past rk arrive as
// zeros.
template <int HD>
__device__ __forceinline__ void stage_entry(const I8Args& a, const CUtensorMap* tm_b,
                                            const Stager& st, int j, int g, int h0, int nc,
                                            int nck) {
  const int e = j % (nc * nck), hc = e / nck, ck = e % nck;
  const int buf = (st.n + j) % a.L.nst;
  const uint32_t fb = st.bars + 8 * buf;
  mbar_expect_tx(fb, a.L.stg_bytes);
  tma_load(st.stg + buf * a.L.stg_bytes, tm_b, fb, 0, ck * a.L.bch,
           g * a.nkv + (h0 + hc) / a.rep);
}

// The builder's work on one operand of (lane b, group g, heads h0 .. h0 +
// nc - 1, rotation block blk), by the kBuilders threads bt of warps 1-3
// (named barrier 3), from B staged in shared memory (the caller staged the
// first nst entries; each entry consumed is replaced by the one nst further
// on). Its first half, before the slot is free (while the K and V
// warpgroups still read the last operand): (1) a1 | a2 of each head, (2)
// each row's max |bq| (int8_rot: each half's), (3) the scales, into the
// scratch. A thread keeps one e-pair (2ep, 2ep + 1) and walks rank quads.
// Arithmetic as the plain version's (_int8_ref): f32 products and sums
// without contraction.
// (the fold of chunk row r at e-pair ep: b1 = B[r][2ep..], b2 = B[r][HALF + 2ep..])
template <int HD>
__device__ __forceinline__ void fold(const __nv_bfloat16* bs, int r, float2 a1, float2 a2,
                                     float4& v) {
  constexpr int HALF = HD / 2;
  const uint32_t w1 = *reinterpret_cast<const uint32_t*>(bs + r * HD);
  const uint32_t w2 = *reinterpret_cast<const uint32_t*>(bs + r * HD + HALF);
  const float b1x = __uint_as_float(w1 << 16), b1y = __uint_as_float(w1 & 0xffff0000u);
  const float b2x = __uint_as_float(w2 << 16), b2y = __uint_as_float(w2 & 0xffff0000u);
  v.x = __fadd_rn(__fmul_rn(a1.x, b1x), __fmul_rn(a2.x, b2x));  // bq1 at e
  v.y = __fadd_rn(__fmul_rn(a1.y, b1y), __fmul_rn(a2.y, b2y));  // bq1 at e + 1
  v.z = __fsub_rn(__fmul_rn(a2.x, b1x), __fmul_rn(a1.x, b2x));  // bq2 at e
  v.w = __fsub_rn(__fmul_rn(a2.y, b1y), __fmul_rn(a1.y, b2y));  // bq2 at e + 1
}

// Wait for entry j of the staging ring and return this thread's e-pair
// column in it; release(j) when every builder is done with entry j.
struct Ring {
  const I8Args& a;
  const CUtensorMap* tm_b;
  const Stager& st;
  int g, h0, nc, nck, nseq, ep, bt;
  __device__ __forceinline__ const __nv_bfloat16* wait(int j) const {
    const int c = st.n + j;
    mbar_wait(st.bars + 8 * (c % a.L.nst), (c / a.L.nst) & 1);
    return reinterpret_cast<const __nv_bfloat16*>(st.p + (c % a.L.nst) * a.L.stg_bytes) + 2 * ep;
  }
  template <int HD>
  __device__ __forceinline__ void release(int j) const {
    named_sync(3, kBuilders);
    if (bt == 0 && j + a.L.nst < nseq) stage_entry<HD>(a, tm_b, st, j + a.L.nst, g, h0, nc, nck);
  }
};

template <int HD, int MODE>
__device__ void build_scales(const I8Args& a, const CUtensorMap* tm_b, const Stager& st,
                             float* aq, unsigned* amax, int* rsn, float* osc, int b, int g,
                             int h0, int nc, int blk, int bt) {
  constexpr int HALF = HD / 2, EPN = HALF / 2;  // e-pairs per head
  const int nh = a.G * a.hpg, nck = (a.rk + a.L.bch - 1) / a.L.bch;
  const size_t qbase = (static_cast<size_t>(b) * nh + static_cast<size_t>(g) * a.hpg + h0) * HD;
  for (int i = bt; i < nc * HALF; i += kBuilders) {
    const int hc = i / HALF, e = i % HALF;
    const size_t qi = qbase + static_cast<size_t>(hc) * HD + e;
    const float q1 = a.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[qi])
                              : static_cast<const float*>(a.q)[qi];
    const float q2 = a.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[qi + HALF])
                              : static_cast<const float*>(a.q)[qi + HALF];
    const float qa = __fdiv_rn(q1, a.sqrt_hd), qb = __fdiv_rn(q2, a.sqrt_hd);
    const float c = a.c0[blk * HALF + e], sn = a.s0[blk * HALF + e];
    aq[hc * HD + e] = __fadd_rn(__fmul_rn(qa, c), __fmul_rn(qb, sn));
    aq[hc * HD + HALF + e] = __fsub_rn(__fmul_rn(qb, c), __fmul_rn(qa, sn));
    amax[hc * HD + e] = amax[hc * HD + HALF + e] = 0u;
    rsn[hc * HD + e] = rsn[hc * HD + HALF + e] = 0;
  }
  named_sync(3, kBuilders);
  const int ep = bt % EPN, q0 = bt / EPN, qstep = kBuilders / EPN, lane = bt % 32;
  const Ring ring{a, tm_b, st, g, h0, nc, nck, 2 * nc * nck, ep, bt};
  for (int hc = 0; hc < nc; ++hc) {
    const float2 a1 = *reinterpret_cast<const float2*>(aq + hc * HD + 2 * ep);
    const float2 a2 = *reinterpret_cast<const float2*>(aq + hc * HD + HALF + 2 * ep);
    float4 m = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int ck = 0; ck < nck; ++ck) {
      const __nv_bfloat16* bs = ring.wait(hc * nck + ck);
      const int quads = min(a.L.bch, a.rk - ck * a.L.bch) / 4;
      for (int q = q0; q < quads; q += qstep) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float4 v;
          fold<HD>(bs, 4 * q + i, a1, a2, v);
          m.x = fmaxf(m.x, fabsf(v.x)), m.y = fmaxf(m.y, fabsf(v.y));
          m.z = fmaxf(m.z, fabsf(v.z)), m.w = fmaxf(m.w, fabsf(v.w));
        }
      }
      ring.release<HD>(hc * nck + ck);
    }
    unsigned* am = amax + hc * HD;  // (non-negative floats order as their bits)
    if (MODE == 2) {  // one scale per head and half
      m.x = decode::warp_max(fmaxf(m.x, m.y)), m.z = decode::warp_max(fmaxf(m.z, m.w));
      if (lane == 0) {
        atomicMax(am, __float_as_uint(m.x));
        atomicMax(am + HALF, __float_as_uint(m.z));
      }
    } else {
      atomicMax(am + 2 * ep, __float_as_uint(m.x));
      atomicMax(am + 2 * ep + 1, __float_as_uint(m.y));
      atomicMax(am + HALF + 2 * ep, __float_as_uint(m.z));
      atomicMax(am + HALF + 2 * ep + 1, __float_as_uint(m.w));
    }
  }
  named_sync(3, kBuilders);
  // (3) scales: max(amax, 1e-30) * f32(1 / 127)
  for (int i = bt; i < nc * HD; i += kBuilders) {
    const int src = MODE == 2 ? (i / HD) * HD + ((i % HD) < HALF ? 0 : HALF) : i;
    osc[i] = __fmul_rn(fmaxf(__uint_as_float(amax[src]), 1e-30f), 1.0f / 127.0f);
  }
  named_sync(3, kBuilders);
}

// The second half, into slot s once it is free: the scales and (4) the bias
// fold U_b | V_b, (5) the int8 rows and their sums, (6) the scaled sums. The
// quotient bq / s is bq times the correctly rounded 1 / s, so a value on a
// rounding tie may take the neighbouring int8 code.
template <int HD, int MODE>
__device__ void build_rows(const I8Args& a, const CUtensorMap* tm_b, const Slot& s,
                           const Stager& st, const float* aq, int* rsn, const float* osc, int g,
                           int h0, int nc, int bt) {
  constexpr int HALF = HD / 2, EPN = HALF / 2;
  const int nck = (a.rk + a.L.bch - 1) / a.L.bch;
  for (int i = bt; i < nc * HD; i += kBuilders) {
    s.osc[i] = osc[i];
    if (a.kbias != nullptr && i % HD < HALF) {
      const int hc = i / HD, e = i % HD;
      const float* kb = a.kbias + (static_cast<size_t>(g) * a.nkv + (h0 + hc) / a.rep) * HD;
      const float kb1 = kb[e], kb2 = kb[HALF + e];
      const float a1 = aq[hc * HD + e], a2 = aq[hc * HD + HALF + e];
      s.bqb[hc * HD + e] = __fadd_rn(__fmul_rn(a1, kb1), __fmul_rn(a2, kb2));
      s.bqb[hc * HD + HALF + e] = __fsub_rn(__fmul_rn(a2, kb1), __fmul_rn(a1, kb2));
    }
  }
  const int ep = bt % EPN, q0 = bt / EPN, qstep = kBuilders / EPN;
  const Ring ring{a, tm_b, st, g, h0, nc, nck, 2 * nc * nck, ep, bt};
  for (int hc = 0; hc < nc; ++hc) {
    const float2 a1 = *reinterpret_cast<const float2*>(aq + hc * HD + 2 * ep);
    const float2 a2 = *reinterpret_cast<const float2*>(aq + hc * HD + HALF + 2 * ep);
    const float2 s1 = *reinterpret_cast<const float2*>(osc + hc * HD + 2 * ep);
    const float2 s2 = *reinterpret_cast<const float2*>(osc + hc * HD + HALF + 2 * ep);
    const float i1x = __frcp_rn(s1.x), i1y = __frcp_rn(s1.y);
    const float i2x = __frcp_rn(s2.x), i2y = __frcp_rn(s2.y);
    uint8_t* oh = s.bytes + hc * a.L.head_bytes;
    int4 sum = make_int4(0, 0, 0, 0);
    for (int ck = 0; ck < nck; ++ck) {
      const int j = nc * nck + hc * nck + ck;
      const __nv_bfloat16* bs = ring.wait(j);
      const int r0 = ck * a.L.bch, quads = min(a.L.bch, a.rk - r0) / 4;
      for (int q = q0; q < quads; q += qstep) {
        int nx[4], ny[4], nz[4], nw[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float4 v;
          fold<HD>(bs, 4 * q + i, a1, a2, v);
          nx[i] = __float2int_rn(v.x * i1x), ny[i] = __float2int_rn(v.y * i1y);
          nz[i] = __float2int_rn(v.z * i2x), nw[i] = __float2int_rn(v.w * i2y);
        }
        // the four ranks' low bytes into one word, and its byte sum
        const auto pack = [](const int (&n)[4]) {
          return __byte_perm(__byte_perm(n[0], n[1], 0x0040), __byte_perm(n[2], n[3], 0x0040),
                             0x5410);
        };
        const uint32_t wx = pack(nx), wy = pack(ny), wz = pack(nz), ww = pack(nw);
        sum.x = __dp4a(static_cast<int>(wx), 0x01010101, sum.x);
        sum.y = __dp4a(static_cast<int>(wy), 0x01010101, sum.y);
        sum.z = __dp4a(static_cast<int>(wz), 0x01010101, sum.z);
        sum.w = __dp4a(static_cast<int>(ww), 0x01010101, sum.w);
        const int k = kpos(r0 + 4 * q, a.rk, a.pbits);
        *reinterpret_cast<uint32_t*>(oh + op_off<HD>(2 * ep, k)) = wx;
        *reinterpret_cast<uint32_t*>(oh + op_off<HD>(2 * ep + 1, k)) = wy;
        *reinterpret_cast<uint32_t*>(oh + op_off<HD>(HALF + 2 * ep, k)) = wz;
        *reinterpret_cast<uint32_t*>(oh + op_off<HD>(HALF + 2 * ep + 1, k)) = ww;
      }
      ring.release<HD>(j);
    }
    int* rs = rsn + hc * HD;
    atomicAdd(rs + 2 * ep, sum.x);
    atomicAdd(rs + 2 * ep + 1, sum.y);
    atomicAdd(rs + HALF + 2 * ep, sum.z);
    atomicAdd(rs + HALF + 2 * ep + 1, sum.w);
  }
  named_sync(3, kBuilders);
  // (6) the correction's factors r = rowsum(n) * s
  for (int i = bt; i < nc * HD; i += kBuilders)
    s.ors[i] = __fmul_rn(static_cast<float>(rsn[i]), osc[i]);
  fence_async_shared();  // the int8 rows are read by wgmma (the async proxy)
}

// HD: head dim; MODE 1 (int8_dots) or 2 (int8_rot); NP: heads per group
// rounded up to 8 or 32 (the V product's N); MT: V accumulator tiles of 64
// ranks, rv <= 64 MT (4 at NP 32 when rv <= 256: 8 x 16 accumulators would
// spill)
template <int HD, int MODE, int NP, int MT>
__global__ void __launch_bounds__(kThreads, 1)
palu_decode_i8_kernel(const __grid_constant__ CUtensorMap tm_kc,
                      const __grid_constant__ CUtensorMap tm_vc,
                      const __grid_constant__ CUtensorMap tm_ks,
                      const __grid_constant__ CUtensorMap tm_kz,
                      const __grid_constant__ CUtensorMap tm_vs,
                      const __grid_constant__ CUtensorMap tm_vz,
                      const __grid_constant__ CUtensorMap tm_b, const I8Args a) {
  constexpr int NACC = HD / 2;  // accumulator registers per thread
  constexpr int HALF = HD / 2;
  constexpr int RS = HALF + 4;  // padded rows of the f32 rotation rows
  constexpr int C8 = HALF + 4;  // and of the int8 ones (bytes)
  const Plan& L = a.L;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t bars = base + L.bars;
  const uint32_t full = bars, empty = bars + 8 * L.ns;
  const uint32_t ofull = bars + 16 * L.ns, oempty = ofull + 8 * L.nob;
  // rope_full: V -> K, the visit's rotation rows and bias term are ready;
  // rope_empty: K -> V, read; p_full: K -> V, P^T and alpha are
  // ready; p_empty: V -> K, read
  const uint32_t rope_full = oempty + 8 * L.nob, rope_empty = rope_full + 8;
  const uint32_t p_full = rope_empty + 8, p_empty = p_full + 8;
  const uint32_t sfull = p_empty + 8;  // the builder's staging buffers, [nst]
  uint32_t* ktab = reinterpret_cast<uint32_t*>(sm + L.ktab);
  uint32_t* vtab = reinterpret_cast<uint32_t*>(sm + L.vtab);
  float* lg = reinterpret_cast<float*>(sm + L.lg);          // [hpg][kTile] logits
  float* cos_s = reinterpret_cast<float*>(sm + L.rope);     // [kTile][RS] f32 rows
  float* sin_s = cos_s + kTile * RS;
  int8_t* c8s = reinterpret_cast<int8_t*>(sin_s + kTile * RS);  // int8_rot: [kTile][C8]
  int8_t* s8s = c8s + kTile * C8;
  // the K bias's logit term, [visit parity][chunk][kTile]: the V warpgroup
  // forms visit i + 1's while the K warpgroup reads visit i's
  float* bias_s = reinterpret_cast<float*>(sm + L.corr);
  float* m_s = reinterpret_cast<float*>(sm + L.stats);
  float* l_s = m_s + kMaxHeads;
  float* alpha_s = m_s + 2 * kMaxHeads;
  float* zsum_s = m_s + 3 * kMaxHeads;
  const packed::Stats stats{m_s, l_s, alpha_s, zsum_s};
  auto slot_at = [&](int s) {
    Slot o;
    const uint32_t off = L.slots + s * L.slot_bytes;
    o.ops = base + off;
    o.bytes = sm + off;
    o.osc = reinterpret_cast<float*>(sm + off + L.osc);
    o.ors = reinterpret_cast<float*>(sm + off + L.ors);
    o.bqb = reinterpret_cast<float*>(sm + off + L.bqb);
    return o;
  };

  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / kWG, 0);
  const int nh = a.G * a.hpg;
  if (tid == 0) {
    for (int s = 0; s < L.ns; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * kWG);
    }
    for (int s = 0; s < L.nob; ++s) {
      mbar_init(ofull + 8 * s, kBuilders);
      mbar_init(oempty + 8 * s, 2 * kWG);
    }
    mbar_init(rope_full, kWG);
    mbar_init(rope_empty, kWG);
    mbar_init(p_full, kWG);
    mbar_init(p_empty, kWG);
    for (int s = 0; s < L.nst; ++s) mbar_init(sfull + 8 * s, 1);
    mbar_init_fence();
  }
  for (int r = tid; r < a.rk; r += kThreads) ktab[r] = rank_entry(r, a.rk, a.pbits);
  for (int r = tid; r < a.rv; r += kThreads) vtab[r] = rank_entry(r, a.rv, a.pbits);
  for (int i = tid; i < 2 * NP * 128 / 4; i += kThreads)
    reinterpret_cast<uint32_t*>(sm + L.p)[i] = 0u;  // heads past hpg stay 0
  for (int i = tid; i < 2 * L.chunk * kTile; i += kThreads) bias_s[i] = 0.0f;  // no bias: stays 0
  if (tid < kMaxHeads) alpha_s[tid] = 1.0f;
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int lt = tid - 2 * kWG;
    if (lt == 0) {
      // ---- producer: one thread streams the tiles of every visit
      int it = 0;
      for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
        const Item w = item_at(a, item);
        const int plane = (a.layer * a.B + w.b) * a.G + w.g;
        const int nv = w.t1 > w.t0 ? L.nch * (w.t1 - w.t0) : 0;
        for (int vi = 0; vi < nv; ++vi, ++it) {
          const int st = it % L.ns, s0 = visit_at(w, vi, a.block_s).tile * kTile;
          mbar_wait(empty + 8 * st, ((it / L.ns) & 1) ^ 1);
          const uint32_t fb = full + 8 * st, sb = base + st * L.stage_bytes;
          mbar_expect_tx(fb, L.tx_bytes);
          for (int x = 0; x < L.nbox_k; ++x)
            tma_load(sb + L.kc + x * L.rows_k * kTile, &tm_kc, fb, s0, x * L.rows_k, plane);
          for (int x = 0; x < L.nbox_v; ++x)
            tma_load(sb + L.vc + x * L.rows_v * kTile, &tm_vc, fb, s0, x * L.rows_v, plane);
          tma_load(sb + L.ks, &tm_ks, fb, s0, 0, plane);
          tma_load(sb + L.vs, &tm_vs, fb, s0, 0, plane);
          if (a.asym) {
            tma_load(sb + L.kz, &tm_kz, fb, s0, 0, plane);
            tma_load(sb + L.vz, &tm_vz, fb, s0, 0, plane);
          }
        }
      }
    } else if (lt >= 32) {
      // ---- builder: the operand of every new (item, chunk, rotation block):
      // its scales while the slot is still in use, its rows once it is free
      const int bt = lt - 32;
      float* aq = reinterpret_cast<float*>(sm + L.scratch);
      unsigned* amax = reinterpret_cast<unsigned*>(aq + L.chunk * HD);
      int* rsn = reinterpret_cast<int*>(aq + 2 * L.chunk * HD);
      float* osc = aq + 3 * L.chunk * HD;
      const int nck = (a.rk + L.bch - 1) / L.bch;
      Stager st{base + L.stg, sfull, sm + L.stg, 0};
      int ob = 0;
      for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
        const Item w = item_at(a, item);
        const int nv = w.t1 > w.t0 ? L.nch * (w.t1 - w.t0) : 0;
        for (int vi = 0; vi < nv; ++vi) {
          const Visit v = visit_at(w, vi, a.block_s);
          if (!v.newb) continue;
          const int s = ob % L.nob, h0 = v.c * L.chunk, nc = min(L.chunk, a.hpg - h0);
          for (int j = 0; bt == 0 && j < min(L.nst, 2 * nc * nck); ++j)
            stage_entry<HD>(a, &tm_b, st, j, w.g, h0, nc, nck);
          build_scales<HD, MODE>(a, &tm_b, st, aq, amax, rsn, osc, w.b, w.g, h0, nc,
                                 v.tile * kTile / a.block_s, bt);
          mbar_wait(oempty + 8 * s, ((ob / L.nob) & 1) ^ 1);
          build_rows<HD, MODE>(a, &tm_b, slot_at(s), st, aq, rsn, osc, w.g, h0, nc, bt);
          mbar_arrive(ofull + 8 * s);
          st.n += 2 * nc * nck;
          ++ob;
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wt = tid % kWG, warp = wt / 32, lane = tid % 32;
  const int gq = lane / 4, qd = lane % 4;

  if (wg == 0) {
    // ---- K warpgroup: int8 dots, epilogues, online softmax
    const int ta = 16 * warp + 2 * gq;  // this thread's tokens ta (row gq) and ta + 1 (row gq + 8)
    const Unpack un(a.pbits);
    const int nks = a.rk / 32;
    // int8_dots over symmetric codes takes code - qoff (the correction folded
    // in: sum_r n (code - qoff) = u - qoff rowsum(n)); otherwise the raw codes
    const uint32_t sub = MODE == 1 && !a.asym ? 0x01010101u * a.qoff : 0u;
    const bool corr = MODE == 2 || a.asym;  // else no correction (folded in, above)
    int it = 0, ob = 0;
    for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
      const Item w = item_at(a, item);
      const size_t head0 = static_cast<size_t>(w.b) * nh + static_cast<size_t>(w.g) * a.hpg;
      named_sync(1, kWG);  // the previous item's reads of the statistics done
      if (wt < kMaxHeads) {
        m_s[wt] = -1e30f;
        l_s[wt] = 0.0f;
      }
      named_sync(1, kWG);
      const int nv = w.t1 > w.t0 ? L.nch * (w.t1 - w.t0) : 0;
      for (int vi = 0; vi < nv; ++vi, ++it) {
        const Visit v = visit_at(w, vi, a.block_s);
        const int st = it % L.ns, s0 = v.tile * kTile;
        const int h0 = v.c * L.chunk, nc = min(L.chunk, a.hpg - h0);
        if (v.newb) {  // the last operand's products are done; take the next
          if (ob > 0) mbar_arrive(oempty + 8 * ((ob - 1) % L.nob));
          mbar_wait(ofull + 8 * (ob % L.nob), (ob / L.nob) & 1);
          ++ob;
        }
        const Slot op = slot_at((ob - 1) % L.nob);
        mbar_wait(full + 8 * st, (it / L.ns) & 1);
        const uint8_t* stage = sm + st * L.stage_bytes;
        const uint8_t* kbytes = stage + L.kc;
        const float* ksc = reinterpret_cast<const float*>(stage + L.ks);
        const float* kzc = reinterpret_cast<const float*>(stage + L.kz);
        const float ska = ksc[ta], skb = ksc[ta + 1];
        const float zka = a.asym ? kzc[ta] : ska * static_cast<float>(-a.qoff);
        const float zkb = a.asym ? kzc[ta + 1] : skb * static_cast<float>(-a.qoff);
        const float* bias_v = bias_s + (it & 1) * L.chunk * kTile;
        auto finish = [&](const uint32_t(&kv)[NACC], int hc) {
          if (corr)
            k_finish<HD, MODE, true>(kv, op.osc + hc * HD, op.ors + hc * HD, cos_s, sin_s, c8s,
                                     s8s, bias_v, a.i8r_inv, ska, skb, zka, zkb, lg, h0 + hc, hc,
                                     ta, qd);
          else
            k_finish<HD, MODE, false>(kv, op.osc + hc * HD, op.ors + hc * HD, cos_s, sin_s, c8s,
                                      s8s, bias_v, a.i8r_inv, ska, skb, zka, zkb, lg, h0 + hc, hc,
                                      ta, qd);
        };
        // the codes as the dots' A operand (its rows: this thread's tokens)
        if (a.pbits == 4)
          k_tile<true>(sm + L.atile, kbytes, ktab, nks, ta, 16 * warp + gq, qd, un, sub);
        else
          k_tile<false>(sm + L.atile, kbytes, ktab, nks, ta, 16 * warp + gq, qd, un, sub);
        fence_async_shared();
        named_sync(1, kWG);  // the whole tile is written before any wgmma reads it
        // head hc + 1's products run under head hc's epilogue (two accumulators)
        const uint32_t at = base + L.atile;
        uint32_t kva[NACC], kvb[NACC];
        k_issue<HD>(kva, nks, at, op.ops);
        for (int hc = 0; hc < nc; hc += 2) {
          if (hc + 1 < nc) {
            k_issue<HD>(kvb, nks, at, op.ops + (hc + 1) * L.head_bytes);
            wgmma_wait1();
          } else {
            wgmma_wait0();
          }
          fence_regs(kva);
          if (hc == 0) mbar_wait(rope_full, it & 1);  // this visit's rows
          finish(kva, hc);
          if (hc + 1 < nc) {
            if (hc + 2 < nc) {
              k_issue<HD>(kva, nks, at, op.ops + (hc + 2) * L.head_bytes);
              wgmma_wait1();
            } else {
              wgmma_wait0();
            }
            fence_regs(kvb);
            finish(kvb, hc + 1);
          }
        }
        mbar_arrive(rope_empty);  // the rotation rows and the bias term are read
        named_sync(1, kWG);       // every head's logits of the visit are in lg
        if (it > 0) mbar_wait(p_empty, (it - 1) & 1);  // the last visit's P^T and alpha are read
        packed::softmax_tile<NP, false>(sm + L.p, lg, stats, a.hpg, h0, h0 + nc, s0, w.vlo, w.vhi,
                                        v.tile == w.t0,
                                        reinterpret_cast<const float*>(stage + L.vs),
                                        reinterpret_cast<const float*>(stage + L.vz), a.asym,
                                        warp, lane);
        mbar_arrive(empty + 8 * st);  // the stage is read (the V scales above)
        mbar_arrive(p_full);
      }
      named_sync(1, kWG);  // the softmax warps' statistics are final
      if (wt < a.hpg) {
        a.part_m[(head0 + wt) * a.splits + w.split] = m_s[wt];
        a.part_l[(head0 + wt) * a.splits + w.split] = l_s[wt];
      }
    }
  } else {
    // ---- V warpgroup: per visit k its rotation rows and bias term,
    // then out^T += Vdeq . P^T of visit k - 1 (the K warpgroup's epilogues
    // of k overlap it)
    const Unpack un(a.pbits);
    float acc[MT][NP / 8][4];  // per 64-rank tile and 8-head tile: rows gq, gq + 8
    int it = 0, ob = 0;
    for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
      const Item w = item_at(a, item);
      const size_t head0 = static_cast<size_t>(w.b) * nh + static_cast<size_t>(w.g) * a.hpg;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NP / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;
      const int nv = w.t1 > w.t0 ? L.nch * (w.t1 - w.t0) : 0;
      // visit steps 0 .. nv: the rows of visit vi, then the V product of vi
      // - 1 (the last step only the product)
      for (int vi = 0; vi <= nv && nv > 0; ++vi) {
        if (vi < nv) {
          const Visit v = visit_at(w, vi, a.block_s);
          const int s0 = v.tile * kTile, blk = s0 / a.block_s, row0 = s0 - blk * a.block_s;
          const int h0 = v.c * L.chunk, nc = min(L.chunk, a.hpg - h0);
          // the tile's block-relative rotation rows, as the wrapper built
          // them: the visit's bias term formed from the f32 ones (global
          // memory, L2), then the rows the K side reads (f32, and int8_rot's
          // int8 ones) loaded, all before the K side frees their buffer
          const float* rc = a.rcos + static_cast<size_t>(row0) * HALF;
          const float* rsi = a.rsin + static_cast<size_t>(row0) * HALF;
          if (v.newb) {  // the last operand's factors are read; take the next
            if (ob > 0) mbar_arrive(oempty + 8 * ((ob - 1) % L.nob));
            mbar_wait(ofull + 8 * (ob % L.nob), (ob / L.nob) & 1);
            ++ob;
          }
          const Slot op = slot_at((ob - 1) % L.nob);
          // per chunk head and token, the K bias's U_b . rcos + V_b . rsin into
          // this visit's buffer (the K side read it two visits ago). Eight
          // lanes share a token, each with hd/16 frequencies of its rows
          // (coalesced loads, all four rounds of 16 tokens issued first), and
          // sum over the eight by shuffles.
          if (a.kbias != nullptr) {
            constexpr int EPL = HALF / 8, NV = EPL / 4, ROUNDS = kTile / 16;
            float* bias_v = bias_s + (it & 1) * L.chunk * kTile;
            const int e0 = (lane % 8) * EPL, tl = warp * 4 + lane / 8;
            float4 cv[ROUNDS][NV], sv[ROUNDS][NV];
#pragma unroll
            for (int rd = 0; rd < ROUNDS; ++rd)
#pragma unroll
              for (int k = 0; k < NV; ++k) {
                const int t = 16 * rd + tl;
                cv[rd][k] = __ldg(reinterpret_cast<const float4*>(rc + t * HALF + e0 + 4 * k));
                sv[rd][k] = __ldg(reinterpret_cast<const float4*>(rsi + t * HALF + e0 + 4 * k));
              }
            for (int hc = 0; hc < nc; ++hc) {
              const float* y1 = op.bqb + hc * HD + e0;
              const float* y2 = y1 + HALF;
#pragma unroll
              for (int rd = 0; rd < ROUNDS; ++rd) {
                float bb = 0.0f;
#pragma unroll
                for (int k = 0; k < NV; ++k) {
                  const float4 u = *reinterpret_cast<const float4*>(y1 + 4 * k);
                  const float4 z = *reinterpret_cast<const float4*>(y2 + 4 * k);
                  bb += u.x * cv[rd][k].x + u.y * cv[rd][k].y + u.z * cv[rd][k].z + u.w * cv[rd][k].w;
                  bb += z.x * sv[rd][k].x + z.y * sv[rd][k].y + z.z * sv[rd][k].z + z.w * sv[rd][k].w;
                }
#pragma unroll
                for (int o = 1; o < 8; o <<= 1) bb += __shfl_xor_sync(0xffffffffu, bb, o);
                if (lane % 8 == 0) bias_v[hc * kTile + 16 * rd + tl] = bb;
              }
            }
          }
          constexpr int NPF = kTile * HALF / 4 / kWG;  // float4 (or 4-byte) row pieces per thread
          float4 cpf[NPF], spf[NPF];
          uint32_t c8pf[MODE == 2 ? NPF : 1], s8pf[MODE == 2 ? NPF : 1];
#pragma unroll
          for (int k = 0; k < NPF; ++k) {
            const int i = wt + k * kWG, t = i / (HALF / 4), f = 4 * (i % (HALF / 4));
            cpf[k] = __ldg(reinterpret_cast<const float4*>(rc + t * HALF + f));
            spf[k] = __ldg(reinterpret_cast<const float4*>(rsi + t * HALF + f));
            if constexpr (MODE == 2) {
              c8pf[k] = __ldg(reinterpret_cast<const uint32_t*>(a.cos8 + (row0 + t) * HALF + f));
              s8pf[k] = __ldg(reinterpret_cast<const uint32_t*>(a.sin8 + (row0 + t) * HALF + f));
            }
          }
          if (it > 0) mbar_wait(rope_empty, (it - 1) & 1);  // the K side read the last rows
#pragma unroll
          for (int k = 0; k < NPF; ++k) {
            const int i = wt + k * kWG, t = i / (HALF / 4), f = 4 * (i % (HALF / 4));
            *reinterpret_cast<float4*>(cos_s + t * RS + f) = cpf[k];
            *reinterpret_cast<float4*>(sin_s + t * RS + f) = spf[k];
            if constexpr (MODE == 2) {
              *reinterpret_cast<uint32_t*>(c8s + t * C8 + f) = c8pf[k];
              *reinterpret_cast<uint32_t*>(s8s + t * C8 + f) = s8pf[k];
            }
          }
          mbar_arrive(rope_full);
          ++it;
        }
        if (vi == 0) continue;
        const int vit = it - 1 - (vi < nv);  // the V product's visit
        const int st = vit % L.ns;
        mbar_wait(full + 8 * st, (vit / L.ns) & 1);
        mbar_wait(p_full, vit & 1);
        const uint8_t* stage = sm + st * L.stage_bytes;
        packed::v_tile<NP, MT, false>(acc, sm + L.p, alpha_s, stage + L.vc,
                                      reinterpret_cast<const float*>(stage + L.vs),
                                      reinterpret_cast<const float*>(stage + L.vz), vtab, a.rv,
                                      a.rv, a.asym, a.qoff, un, warp, lane);
        // P^T and alpha are read (the item's last: after its partials, below)
        if (vi < nv) mbar_arrive(p_empty);
        mbar_arrive(empty + 8 * st);
      }
      packed::v_store<NP, MT>(acc, a.part_acc, zsum_s, nv > 0, head0, a.splits, w.split, a.rv,
                              a.hpg, warp, lane);
      if (nv > 0) mbar_arrive(p_empty);  // the item's last P^T is read
    }
  }
}

template <int HD, int MODE, int NP, int MT>
int launch(int grid, const CUtensorMap (&tm)[7], const I8Args& a, cudaStream_t st) {
  const int smem = static_cast<int>(a.L.total) + 1024;
  auto kern = palu_decode_i8_kernel<HD, MODE, NP, MT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, kThreads, smem, st>>>(tm[0], tm[1], tm[2], tm[3], tm[4], tm[5], tm[6], a);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for hpg heads per group and rv: NP 8 (hpg <= 8) or 32,
// MT 8, or 4 at NP 32 and rv <= 256.
template <int HD, int MODE>
int launch_shape(int hpg, int rv, int grid, const CUtensorMap (&tm)[7], const I8Args& a,
                 cudaStream_t st) {
  if (hpg <= 8) return launch<HD, MODE, 8, 8>(grid, tm, a, st);
  if (rv <= 256) return launch<HD, MODE, 32, 4>(grid, tm, a, st);
  return launch<HD, MODE, 32, 8>(grid, tm, a, st);
}

}  // namespace

// The plan at these shapes: out[0] the shared memory a launch takes (-1
// when no plan fits in one block: the wrapper raises then), out[1] the
// stages, out[2] the operand slots, out[3] the staging buffers of B, out[4]
// the heads per chunk.
extern "C" int palu_decode_i8_plan(int hd, int rk, int rv, int hpg, int nrk, int nrv, int asym,
                                   int mode, int bias, void* out) {
  const Plan p = make_plan(hd, rk, rv, hpg, nrk, nrv, asym, mode, bias);
  int* o = static_cast<int*>(out);
  o[0] = p.ok ? static_cast<int>(p.total) + 1024 : -1;
  o[1] = p.ns, o[2] = p.nob, o[3] = p.nst, o[4] = p.chunk;
  return 0;
}

// q (B, nh, hd) bf16 or f32; bk (G, nkv, rk, hd) bf16 with nkv dividing hpg
// = nh / G (q-head h of a group reads kv-head h / (hpg / nkv)); codes kc /
// vc (L, B, G, nrk / nrv, S) uint8 (L = n_layers, 1 for one layer's
// buffers; layer picks one); per-row scales and zeros (L, B, G, S) f32,
// zeros only when asym; kv_len (B,) int32 absolute; kbias null or (G, nkv,
// hd) f32; c0 / s0 (S / block_s, hd/2) f32 at each block's absolute start
// (pos_offset + j block_s); rcos / rsin (block_s, hd/2) f32; cos8 / sin8
// (block_s, hd/2) int8 (int8_rot) and i8r_inv their inverse scale; partials
// as in palu_decode_exact.cu; out (B, nh, rv) f32, or with m_out / l_out
// the raw statistics. hd 64 or 128, rk a multiple of 32 up to 512, rv a
// multiple of 16 up to 512, hpg <= 32, S a multiple of block_s, block_s of
// 64, pack width <= 4, mode 1 (int8_dots) or 2 (int8_rot). splits: the
// wrapper's _splits; grid blocks loop over the B * G * splits work items;
extern "C" int palu_decode_i8(const void* q, int q_bf16, const void* bk, const void* kc,
                              const void* ks, const void* kz, const void* vc, const void* vs,
                              const void* vz, const void* kv_len, const void* c0, const void* s0,
                              const void* rcos, const void* rsin, const void* cos8,
                              const void* sin8, const void* kbias, void* part_m,
                              void* part_l, void* part_acc, void* out, int B, int G, int hpg,
                              int nkv, int hd, int rk, int rv, int S, int nrk, int nrv,
                              int pbits, int qoff, int asym, int window, int splits, int grid,
                              int mode, int block_s, int layer, int n_layers, int pos_offset,
                              float sqrt_hd, float i8r_inv, void* m_out,
                              void* l_out, void* stream) {
  if ((hd != 64 && hd != 128) || rk % 32 || rv % 16 || rk > kMaxRank || rv > kMaxRank ||
      hpg > kMaxHeads || nkv <= 0 || hpg % nkv || (mode != 1 && mode != 2) || pbits > 4 ||
      block_s <= 0 || block_s % kTile || S % block_s || layer < 0 || layer >= n_layers ||
      (m_out == nullptr) != (l_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  I8Args a{};
  a.L = make_plan(hd, rk, rv, hpg, nrk, nrv, asym, mode, kbias != nullptr);
  if (!a.L.ok) return static_cast<int>(cudaErrorInvalidValue);
  a.q = q;
  a.q_bf16 = q_bf16;
  a.bk = static_cast<const __nv_bfloat16*>(bk);
  a.kbias = static_cast<const float*>(kbias);
  a.c0 = static_cast<const float*>(c0);
  a.s0 = static_cast<const float*>(s0);
  a.rcos = static_cast<const float*>(rcos);
  a.rsin = static_cast<const float*>(rsin);
  a.cos8 = static_cast<const int8_t*>(cos8);
  a.sin8 = static_cast<const int8_t*>(sin8);
  a.kv_len = static_cast<const int*>(kv_len);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.part_acc = static_cast<float*>(part_acc);
  a.B = B, a.G = G, a.hpg = hpg, a.nkv = nkv, a.rep = hpg / nkv, a.rk = rk, a.rv = rv, a.S = S;
  a.pbits = pbits, a.qoff = qoff, a.asym = asym, a.window = window;
  a.splits = splits, a.n_items = B * G * splits;
  a.layer = layer, a.pos_offset = pos_offset, a.block_s = block_s;
  a.sqrt_hd = sqrt_hd, a.i8r_inv = i8r_inv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint64_t planes = static_cast<uint64_t>(n_layers) * B * G;
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8, f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const auto none = CU_TENSOR_MAP_SWIZZLE_NONE;
  CUtensorMap tm[7];
  bool ok = make_map_3d(&tm[0], u8, 1, kc, S, nrk, planes, kTile, a.L.rows_k, none) &&
            make_map_3d(&tm[6], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, bk, hd, rk,
                        static_cast<uint64_t>(G) * nkv, hd, a.L.bch, none) &&
            make_map_3d(&tm[1], u8, 1, vc, S, nrv, planes, kTile, a.L.rows_v, none) &&
            make_map_3d(&tm[2], f32, 4, ks, S, 1, planes, kTile, 1, none) &&
            make_map_3d(&tm[4], f32, 4, vs, S, 1, planes, kTile, 1, none);
  if (ok && asym)
    ok = make_map_3d(&tm[3], f32, 4, kz, S, 1, planes, kTile, 1, none) &&
         make_map_3d(&tm[5], f32, 4, vz, S, 1, planes, kTile, 1, none);
  else
    tm[3] = tm[2], tm[5] = tm[4];
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  int err;
  if (hd == 128)
    err = mode == 1 ? launch_shape<128, 1>(hpg, rv, grid, tm, a, st)
                    : launch_shape<128, 2>(hpg, rv, grid, tm, a, st);
  else
    err = mode == 1 ? launch_shape<64, 1>(hpg, rv, grid, tm, a, st)
                    : launch_shape<64, 2>(hpg, rv, grid, tm, a, st);
  if (err != 0) return err;
  return decode::launch_combine(static_cast<const float*>(part_m),
                                static_cast<const float*>(part_l),
                                static_cast<const float*>(part_acc), static_cast<float*>(out),
                                B * G * hpg, splits, rv, st, static_cast<float*>(m_out),
                                static_cast<float*>(l_out));
}
