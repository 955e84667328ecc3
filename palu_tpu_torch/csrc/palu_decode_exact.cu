// Latent decode attention over the rank-major packed cache, exact K path,
// for Hopper: the K rebuild on warpgroup MMA (wgmma), the value product on
// mma.sync, a TMA-fed mbarrier ring of cache tiles, one wave of blocks.
//
// Replaces: palu_tpu/ops/pallas/palu_decode4.py::palu_flash_decode4_quantized
// (body _make_kernel4, launch _call4) in its exact mode, over per-row
// scales and over per-chunk scales (group_chunk, the reference's
// --lt_group_size), sym and asym, with the pre-RoPE K bias (k_bias),
// pos_offset, return_stats and layer_idx. The int8 K-path modes run on
// palu_decode_i8.cu; the softmax and the value product are shared with it
// (packed_wg.cuh).
//
// What it computes, per lane b, group g, kv-head j of the group and each of
// the rep q-heads h that read it (rep = hpg / nkv; 1 for the repeated form):
//   K_j(s) = sum_c scale_c(s) * B_jc^T (code_c(s) - qoff)
//            [+ zero_c(s) * rowsum B_jc] [+ b_j, the K bias]
//            (one chunk c of all ranks for per-row scales)
//   logit_h(s) = q_h . RoPE_s(K_j(s)) / sqrt(hd), masked by kv_len and window
//   out_h = sum_s softmax(logit_h)(s) * (scale_c(s) * (code_v(s) - qoff) [+ zero_c(s)])
// -> (B, nh, rv) in latent space (o_proj is U_v-fused).
//
// Bound on this card: at batch 1 the K rebuild is 2 * nkv * rk * hd flops
// per token and group, against (rk + rv) * bits / 8 bytes of codes and a
// few of scales: at the Llama-2-7B group (4 kv-heads, rk 128, rv 384, 3-bit
// in nibble containers) 131 kflop per 256 bytes, 512 flops per byte, above
// the card's ~295 bf16 flops per byte: operations bound, on the tensor
// cores. Qwen2-7B's compact form (4 kv-heads for 28 q-heads) rebuilds K 4
// times per token instead of 28. What the kernel must avoid is everything
// around the products: the earlier kernel ran them on mma.sync per q-head
// with a block barrier per head, loaded each tile with plain loads (nothing
// in flight while it computed) and read f32 RoPE tables as large as the
// cache they rotate.
//
// Design. A block is 3 warpgroups (roles broadcast warp-uniform):
//  - producer (setmaxnreg 40): one thread keeps a ring of 3-4 tile stages
//    full by TMA (cp.async.bulk.tensor): a stage is one 64-token tile of the
//    packed K and V byte planes ((rows, 64) boxes of the (S, rows, planes)
//    maps, S innermost) and of the scale (and zero) rows; a second thread
//    streams B (the group's kv-heads' rk x hd bf16 reconstruction rows) by
//    TMA with a 128-byte swizzle into B slots, once per work item when all
//    of it fits beside the ring (resident), else per tile in rank chunks
//    through a ring of slots (streamed: Qwen2-7B's 4 x 256 x 128, ranks 512);
//  - K warpgroup (setmaxnreg 232): per tile, unpacks its K codes into the
//    bf16 A fragments of wgmma (codes are small integers, exact in bf16;
//    each thread owns two adjacent tokens, so one 16-bit load gives both),
//    and per kv-head runs K (64 tokens x hd) = codes^T B_j as m64n(hd)k16
//    wgmma with B read MN-major from the slot, kv-head j + 1's products
//    under kv-head j's epilogue (per-row scales: two accumulators); then,
//    on the accumulator registers, the per-token scale (per scale chunk:
//    each chunk's k-steps accumulate on their own and fold at the chunk's
//    end, so K stays exact up to the f32 summation order; with neither a
//    zero term nor a bias the scale multiplies the logits instead), the
//    asym zero term, the K bias, RoPE, and the dot with each of the rep
//    q-heads (a quad shuffle finishes each logit: no block barrier per
//    head); then the online softmax, which writes P^T (per-row scales:
//    p * scale_v, with the zero term's sum of p * zero_v per head) in bf16
//    high and low parts;
//  - V warpgroup (setmaxnreg 232): per tile i, forms the RoPE rotation of
//    the tile's 64 positions in shared memory from the same f32 angle
//    (position * inv_freq) the plain version uses (a branch-free sincos; no
//    table is read), then out^T (rv x heads) += V (rv x 64 tokens) . P^T of
//    tile i - 1 per warp on mma.sync m16n8k16 (A from 16-byte code loads:
//    per-row scales the raw codes, exact, times P^T high and low; per-chunk
//    the dequantized values split into bf16 high and low parts too, hi.hi +
//    hi.lo + lo.hi: the f32 class), its accumulators in registers for the
//    whole work item. (On wgmma from this second warpgroup the product ran
//    serialized, 2.7 us per 64 ranks.)
// The K warpgroup's epilogue of tile i overlaps the V warpgroup's product of
// tile i - 1 and the producer's loads of the next tiles. mbarriers order it
// all: full / empty per stage and per B slot, rope_full / rope_empty (the
// rotation tile) and p_full / p_empty (P^T and the rescale factors).
// Each role runs one warp per SM sub-partition, so latency, not the
// tensor cores, sets the pace: unpacking and the rotation are branch-free.
//
// The grid is one wave: work items (lane, group, sequence split) number at
// most SMs (the wrapper's _splits), blocks min(items, SMs), each looping
// over items; the splits of a (lane, group) cut its valid tiles
// (decode::tile_range); a split with none writes m = -1e30, l = 0, acc = 0.
// The combine kernel (decode_common.cuh) merges the splits.
//
// The v3 packed decode (palu_decode_v3_kernel, the body's V3 argument;
// replaces palu_tpu/ops/pallas/archive/palu_decode3.py::
// palu_flash_decode3_quantized, an A/B baseline with no product call site):
// this kernel's function over asym per-row rows with qoff 0, the query
// pre-scaled by 1 / sqrt(hd) and rounded to its dtype by the wrapper, and
// two differences in how the inputs come:
//  - the scales and zeros of every group packed per token as (B, S, 2G)
//    f32 (sz_pack: scales in columns [0, G), zeros in [G, 2G)), read in
//    place. A TMA box's inner extent must be 16 bytes, so one group's
//    column is no box of its own: two (4 columns x 64 tokens) boxes a side
//    at columns g and G + g would bring 4 KB a tile (one box of all 2G
//    columns 8 KB at G 8), against v2's four 256-byte rows and ~12 KB of
//    3-bit codes, and cost the 3-bit plan a stage (3 KB more a stage: 3
//    instead of 4). That form was built and its box loads failed on the
//    card (an illegal instruction at G 2; cause not found). So warp 2 of
//    the producer warpgroup gathers the tile's four columns with 4-byte
//    loads (64 tokens x 4 values; two 32-byte sectors a token and side, 8 KB
//    of sectors a tile at G 8, L2-resident after the first group) into the
//    stage's v2 rows and arrives on the stage's full barrier beside the
//    TMA bytes: the stage, the plan and the K and V warpgroups' reads are
//    v2's, and G may be odd;
//  - RoPE from v3's f32 tables, built in float64 by the wrapper: the
//    block-relative rows rcos / rsin (block_s, hd / 2, rope_scale folded
//    in) and the block starts' c0 / s0 (S / block_s, hd / 2). A 64-token
//    tile never straddles two rotation blocks (block_s % 64 == 0), so the V
//    warpgroup's rotation stage forms the tile's R(s) = R(s0) R(s - s0) from
//    the tile's 64 table rows and its block's start (cos = c0 rc - s0 rs,
//    sin = s0 rc + c0 rs): the K warpgroup's epilogue and q stay as they
//    are (the TPU kernel rotated the query back by s0 instead; the two
//    differ by f32 rounding).
// The v3 mode is a template argument: the instantiations that serve
// palu_decode are compiled as before. v3 has one instantiation, at the A/B
// tool's shape (hd 128, at most 8 heads a group): it is an A/B baseline,
// and each instantiation of this body lengthens the longest build of the
// port by about ten seconds.

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
using packed::kTile;  // tokens per tile (the wgmma M of the K rebuild)
using packed::rank_entry;
using packed::Unpack;

constexpr int kWG = 128;         // threads per warpgroup
constexpr int kThreads = 3 * kWG;
constexpr int kMaxRank = 512;
constexpr int kMaxKSteps = 8;    // A fragments held in registers: 128 ranks
constexpr int kSmemBudget = static_cast<int>(decode::kSmemMax) - 1024;  // - alignment slack

struct Plan {
  int ok, ns, nb, rc, nrc, resident;
  int rows_k, nbox_k, rows_v, nbox_v;
  uint32_t stage_bytes, tx_bytes, slot_bytes;
  uint32_t kc, vc, ks, kz, vs, vz;  // within a stage
  uint32_t slots, p, rope, q, lg, ktab, vtab, stats, bars, total;
};

struct ExactArgs {
  const void* q;           // (B, nh, hd) bf16 or f32, roped at the current position
  int q_bf16;
  const float* kbias;      // (G, nkv, hd) pre-RoPE K bias, or null
  const float* rsum;       // asym: (G, nkv, nsk, hd) row sums of B per scale chunk
  const float* inv_freq;   // (hd / 2,) RoPE frequencies
  const float* ksz;        // v3: (B, S, 2G) scales and zeros of K and of V
  const float* vsz;
  const float* c0;         // v3: (S / block_s, hd / 2) cos / sin of each block start
  const float* s0;
  const float* rcos;       // v3: (block_s, hd / 2) block-relative cos / sin, rope_scale in
  const float* rsin;
  const int* kv_len;       // (B,) absolute
  float* part_m;           // (B, nh, splits)
  float* part_l;
  float* part_acc;         // (B, nh, splits, rv)
  int B, G, hpg, nkv, rep, rk, rv, S, pbits, qoff, asym, window;
  int nsk, nsv, gsk, gsv;  // scale rows per token of K / V, ranks per scale chunk
  int splits, n_items, layer, pos_offset;
  int block_s;             // v3: the rotation block
  float inv_sqrt_hd, rope_scale;
  Plan L;
};

inline uint32_t up(uint32_t x, uint32_t a) { return (x + a - 1) / a * a; }

// The shared-memory plan: ns stages of one tile, B slots (resident: all
// nkv x nrc rank chunks of the group; streamed: nb >= 2 slots of rc ranks),
// then the P^T tile (high, low), the RoPE rotation of the tile, q, the
// logits, the rank tables, softmax statistics and the mbarriers. ok = 0
// when no plan fits in a block's shared memory. gathered: the scale and zero
// rows come by loads, not TMA (v3), and count no transaction bytes.
Plan make_plan(int hd, int rk, int rv, int hpg, int nkv, int nrk, int nrv, int nsk, int nsv,
               int asym, int np, int gathered = 0) {
  Plan p{};
  p.nbox_k = (nrk + 255) / 256;
  p.rows_k = (nrk + p.nbox_k - 1) / p.nbox_k;
  p.nbox_v = (nrv + 255) / 256;
  p.rows_v = (nrv + p.nbox_v - 1) / p.nbox_v;
  uint32_t o = 0;
  p.kc = o; o = up(o + p.nbox_k * p.rows_k * kTile, 128);
  p.vc = o; o = up(o + p.nbox_v * p.rows_v * kTile, 128);
  p.ks = o; o = up(o + nsk * kTile * 4, 128);
  p.kz = o; o = up(o + (asym ? nsk * kTile * 4 : 0), 128);
  p.vs = o; o = up(o + nsv * kTile * 4, 128);
  p.vz = o; o = up(o + (asym ? nsv * kTile * 4 : 0), 128);
  p.stage_bytes = up(o, 1024);
  p.tx_bytes = (p.nbox_k * p.rows_k + p.nbox_v * p.rows_v) * kTile +
               (gathered ? 0 : (1 + asym) * (nsk + nsv) * kTile * 4);
  auto tail = [&](uint32_t at, int ns, int nb) {
    p.p = up(at, 1024);
    uint32_t t = p.p + 2 * np * 128;
    p.rope = t; t = up(t + 2 * kTile * (hd / 2 + 4) * 4, 16);
    p.q = t; t = up(t + hpg * hd * 4, 16);
    p.lg = t; t = up(t + hpg * kTile * 4, 16);
    p.ktab = t; t = up(t + rk * 4, 16);
    p.vtab = t; t = up(t + rv * 4, 16);
    p.stats = t; t = up(t + 4 * kMaxHeads * 4, 16);
    p.bars = t; t += 8 * (2 * ns + 2 * nb + 4);
    return t;
  };
  const int rc_res = rk < 128 ? rk : 128;
  const int nrc_res = (rk + rc_res - 1) / rc_res;
  for (int ns = 4; ns >= 3; --ns) {  // resident B
    const uint32_t slot = rc_res * hd * 2, nb = nkv * nrc_res;
    p.slots = ns * p.stage_bytes;
    const uint32_t total = tail(p.slots + nb * slot, ns, nb);
    if (total <= static_cast<uint32_t>(kSmemBudget)) {
      p.ok = 1, p.ns = ns, p.nb = nb, p.rc = rc_res, p.nrc = nrc_res, p.resident = 1;
      p.slot_bytes = slot, p.total = total;
      return p;
    }
  }
  const int rcs[4] = {rc_res, 64, 32, 16};
  for (int i = 0; i < 4; ++i) {  // B streamed through nb >= 2 slots
    const int rc = rcs[i];
    if (i > 0 && rc >= rc_res) continue;
    const uint32_t slot = rc * hd * 2;
    p.slots = 3 * p.stage_bytes;
    int nb = 2;
    while (tail(p.slots + (nb + 1) * slot, 3, nb + 1) <= static_cast<uint32_t>(kSmemBudget) &&
           nb < 8)
      ++nb;
    const uint32_t total = tail(p.slots + nb * slot, 3, nb);
    if (total <= static_cast<uint32_t>(kSmemBudget)) {
      p.ok = 1, p.ns = 3, p.nb = nb, p.rc = rc, p.nrc = (rk + rc - 1) / rc, p.resident = 0;
      p.slot_bytes = slot, p.total = total;
      return p;
    }
  }
  p.ok = 0;
  return p;
}

// The K rebuild's A fragments (codes^T, 64 tokens x 16 ranks per k-step) of
// ranks [r0, r0 + 16 * nks): this thread's rows are tokens ta and ta + 1,
// its columns ranks 2q, 2q + 1, 2q + 8, 2q + 9 of each k-step.
__device__ __forceinline__ void k_fragments(uint32_t (&af)[kMaxKSteps][4], const uint8_t* kbytes,
                                            const uint32_t* ktab, int r0, int nks, int ta,
                                            int qd, const Unpack& u, int qoff) {
#pragma unroll
  for (int kk = 0; kk < kMaxKSteps; ++kk) {
    if (kk < nks) {
      const int r = r0 + 16 * kk + 2 * qd;
      const uint2 e01 = *reinterpret_cast<const uint2*>(ktab + r);
      const uint2 e89 = *reinterpret_cast<const uint2*>(ktab + r + 8);
      int a0, b0, a1, b1, a8, b8, a9, b9;
      code_pair(kbytes, e01.x, ta, u, a0, b0);
      code_pair(kbytes, e01.y, ta, u, a1, b1);
      code_pair(kbytes, e89.x, ta, u, a8, b8);
      code_pair(kbytes, e89.y, ta, u, a9, b9);
      af[kk][0] = pack_bf16(static_cast<float>(a0 - qoff), static_cast<float>(a1 - qoff));
      af[kk][1] = pack_bf16(static_cast<float>(b0 - qoff), static_cast<float>(b1 - qoff));
      af[kk][2] = pack_bf16(static_cast<float>(a8 - qoff), static_cast<float>(a9 - qoff));
      af[kk][3] = pack_bf16(static_cast<float>(b8 - qoff), static_cast<float>(b9 - qoff));
    }
  }
}

// The same for 4-bit packing (byte row i holds rank i in its low nibble and
// rank i + rk / 2 in its high one): two 16-bit loads per rank pair, a byte
// permute, and bf16(128 + code) built directly (0x4300 + code) less 128 +
// qoff in one bf16x2 subtraction (small integers: exact).
__device__ __forceinline__ void k_fragments4(uint32_t (&af)[kMaxKSteps][4],
                                             const uint8_t* kbytes, int rk, int r0, int nks,
                                             int ta, int qd, int qoff) {
  const int w = rk / 2;
  const __nv_bfloat162 off = __float2bfloat162_rn(128.0f + static_cast<float>(qoff));
#pragma unroll
  for (int kk = 0; kk < kMaxKSteps; ++kk) {
    if (kk < nks) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {  // ranks 2q, 2q + 1, then 2q + 8, 2q + 9
        const int r = r0 + 16 * kk + 2 * qd + 8 * p;
        const bool hi = r >= w;
        const uint8_t* src = kbytes + (hi ? r - w : r) * kTile + ta;
        const uint32_t w0 = *reinterpret_cast<const uint16_t*>(src);
        const uint32_t w1 = *reinterpret_cast<const uint16_t*>(src + kTile);
#pragma unroll
        for (int t = 0; t < 2; ++t) {  // token ta, then ta + 1 (byte t of each row)
          uint32_t x = __byte_perm(w0, w1, t ? 0x2521 : 0x2420);  // [r, 0, r + 1, 0]
          x = ((x >> (hi ? 4 : 0)) & 0x000F000Fu) + 0x43004300u;
          const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&x), off);
          af[kk][2 * p + t] = *reinterpret_cast<const uint32_t*>(&v);
        }
      }
    }
  }
}

template <int HD>
__device__ __forceinline__ void wgmma_k(float (&d)[HD / 2], const uint32_t (&a)[4], uint64_t db,
                                        int scale_d) {
  if constexpr (HD == 128) {
    wgmma_rs_n128(d, a, db, scale_d);
  } else {
    wgmma_rs_n64(d, a, db, scale_d);
  }
}

// kv (+)= the first N k-steps of A (af) . the slot's B rows, one unguarded
// chain (scale_d 0 on the first product when `first`): a guard between the
// products of a chain makes ptxas serialize them (C7520).
template <int HD, int N>
__device__ __forceinline__ void k_chain(float (&kv)[HD / 2], const uint32_t (&af)[kMaxKSteps][4],
                                        int k0, uint32_t bsl, uint32_t lbo, int first) {
#pragma unroll
  for (int kk = 0; kk < N; ++kk) {
    const int k = (k0 + kk) & (kMaxKSteps - 1);  // k0 + kk < kMaxKSteps where it runs
    wgmma_k<HD>(kv, af[k], sw128_desc(bsl + k * 2048, lbo, 1024), kk > 0 || !first);
  }
}

// The chain of the first n (1 .. kMaxKSteps) k-steps, dispatched once.
template <int HD>
__device__ __forceinline__ void k_chain_n(int n, float (&kv)[HD / 2],
                                          const uint32_t (&af)[kMaxKSteps][4], uint32_t bsl,
                                          uint32_t lbo, int first) {
  switch (n) {
    case 1: k_chain<HD, 1>(kv, af, 0, bsl, lbo, first); break;
    case 2: k_chain<HD, 2>(kv, af, 0, bsl, lbo, first); break;
    case 3: k_chain<HD, 3>(kv, af, 0, bsl, lbo, first); break;
    case 4: k_chain<HD, 4>(kv, af, 0, bsl, lbo, first); break;
    case 5: k_chain<HD, 5>(kv, af, 0, bsl, lbo, first); break;
    case 6: k_chain<HD, 6>(kv, af, 0, bsl, lbo, first); break;
    case 7: k_chain<HD, 7>(kv, af, 0, bsl, lbo, first); break;
    default: k_chain<HD, kMaxKSteps>(kv, af, 0, bsl, lbo, first); break;
  }
}

// Fold the finished scale chunk sc, whose partial sum codes^T B is in kv,
// with each row's token scale and the zero term (zero_c(s) * rowsum B_c):
// into kacc (CHUNKED), or in place (one chunk of all ranks). Rows: tokens
// ta and ta + 1; columns 8jj + 2q + {0, 1}.
template <int HD, bool CHUNKED>
__device__ __forceinline__ void fold_chunk(float (&kv)[HD / 2], float (&kacc)[HD / 2],
                                           const float* ksc, const float* kzc, const float* rs,
                                           int sc, int ta, int qd, int asym) {
  const float sa = ksc[sc * kTile + ta], sb = ksc[sc * kTile + ta + 1];
  const float za = asym ? kzc[sc * kTile + ta] : 0.0f;
  const float zb = asym ? kzc[sc * kTile + ta + 1] : 0.0f;
#pragma unroll
  for (int jj = 0; jj < HD / 8; ++jj) {
    float2 r = make_float2(0.0f, 0.0f);
    if (asym) r = __ldg(reinterpret_cast<const float2*>(rs + sc * HD + 8 * jj + 2 * qd));
    const float k0 = kv[4 * jj] * sa + za * r.x, k1 = kv[4 * jj + 1] * sa + za * r.y;
    const float k2 = kv[4 * jj + 2] * sb + zb * r.x, k3 = kv[4 * jj + 3] * sb + zb * r.y;
    if constexpr (CHUNKED) {
      kacc[4 * jj] += k0, kacc[4 * jj + 1] += k1, kacc[4 * jj + 2] += k2, kacc[4 * jj + 3] += k3;
    } else {
      kv[4 * jj] = k0, kv[4 * jj + 1] = k1, kv[4 * jj + 2] = k2, kv[4 * jj + 3] = k3;
    }
  }
}

// Issue one kv-head's K products into kv (waiting for its B slot first):
// the chain over the first nks k-steps of af, committed as one group.
template <int HD>
__device__ __forceinline__ void k_issue(float (&kv)[HD / 2], const uint32_t (&af)[kMaxKSteps][4],
                                        int nks, uint32_t slot_full, uint32_t parity,
                                        uint32_t slot, uint32_t lbo) {
  mbar_wait(slot_full, parity);
  fence_regs(kv);
  wgmma_fence();
  k_chain_n<HD>(nks, kv, af, slot, lbo, 1);
  wgmma_commit();
}

// The epilogue of one kv-head on its K registers (rows: tokens ta, ta + 1;
// columns 8jj + 2q + {0, 1}): the K bias (bias: its hd values, or null),
// RoPE with the tile's rotation (rows of RS floats), and the logits of its
// q-heads h0 .. h0 + rep - 1 into lg (q_s pre-scaled by 1 / sqrt(hd)),
// times sa / sb (a token scale not yet applied to K, else 1); a quad
// shuffle finishes each logit.
template <int HD>
__device__ __forceinline__ void k_finish(float (&kf)[HD / 2], const float* bias,
                                         const float* cos_s, const float* sin_s,
                                         const float* q_s, float* lg, int h0, int rep, int ta,
                                         int qd, float sa = 1.0f, float sb = 1.0f) {
  constexpr int NJ = HD / 8, RS = HD / 2 + 4;
  if (bias != nullptr) {
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + 8 * jj + 2 * qd));
      kf[4 * jj] += bb.x, kf[4 * jj + 1] += bb.y;
      kf[4 * jj + 2] += bb.x, kf[4 * jj + 3] += bb.y;
    }
  }
  // column f < hd / 2 pairs with f + hd / 2
#pragma unroll
  for (int jj = 0; jj < NJ / 2; ++jj) {
    const int f = 8 * jj + 2 * qd;
    const float2 ca = *reinterpret_cast<const float2*>(cos_s + ta * RS + f);
    const float2 sa = *reinterpret_cast<const float2*>(sin_s + ta * RS + f);
    const float2 cb = *reinterpret_cast<const float2*>(cos_s + (ta + 1) * RS + f);
    const float2 sb = *reinterpret_cast<const float2*>(sin_s + (ta + 1) * RS + f);
    const int u = 4 * jj, v = 4 * (jj + NJ / 2);
    float k1, k2;
    k1 = kf[u], k2 = kf[v];
    kf[u] = k1 * ca.x - k2 * sa.x, kf[v] = k2 * ca.x + k1 * sa.x;
    k1 = kf[u + 1], k2 = kf[v + 1];
    kf[u + 1] = k1 * ca.y - k2 * sa.y, kf[v + 1] = k2 * ca.y + k1 * sa.y;
    k1 = kf[u + 2], k2 = kf[v + 2];
    kf[u + 2] = k1 * cb.x - k2 * sb.x, kf[v + 2] = k2 * cb.x + k1 * sb.x;
    k1 = kf[u + 3], k2 = kf[v + 3];
    kf[u + 3] = k1 * cb.y - k2 * sb.y, kf[v + 3] = k2 * cb.y + k1 * sb.y;
  }
  for (int h = h0; h < h0 + rep; ++h) {
    const float* qh = q_s + h * HD;
    float la = 0.0f, lb = 0.0f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const float2 qv = *reinterpret_cast<const float2*>(qh + 8 * jj + 2 * qd);
      la += qv.x * kf[4 * jj] + qv.y * kf[4 * jj + 1];
      lb += qv.x * kf[4 * jj + 2] + qv.y * kf[4 * jj + 3];
    }
    la += __shfl_xor_sync(0xffffffffu, la, 1);
    la += __shfl_xor_sync(0xffffffffu, la, 2);
    lb += __shfl_xor_sync(0xffffffffu, lb, 1);
    lb += __shfl_xor_sync(0xffffffffu, lb, 2);
    lg[h * kTile + ta] = la * sa;  // every lane of the quad holds the sums
    lg[h * kTile + ta + 1] = lb * sb;
  }
}

// A work item's coordinates and its tile range [t0, t1) (empty when t1 <= t0).
struct Item {
  int b, g, split, t0, t1, vlo, vhi;  // vlo / vhi: valid columns [vlo, vhi)
};

__device__ __forceinline__ Item item_at(const ExactArgs& a, int item) {
  Item it;
  it.split = item % a.splits;
  const int bg = item / a.splits;
  it.g = bg % a.G;
  it.b = bg / a.G;
  // the splits cut this lane's valid tiles (decode_common.cuh)
  const decode::TileRange r = decode::tile_range(a.kv_len[it.b], a.pos_offset, a.window, a.S,
                                                 a.splits, it.split, kTile);
  it.t0 = r.t0, it.t1 = r.t1, it.vlo = r.vlo, it.vhi = r.vhi;
  return it;
}

// HD: head dim; CHUNKED: per-chunk scales; NP: heads per group rounded up to
// 8 or 32 (the V product's N); MT: V accumulator tiles of 64 ranks, rv <= 64 MT
// (4 at NP 32 when rv <= 256: 8 x 16 accumulators would spill); V3: v3's
// packed scales, gathered by the producer's warp 2 (tm_ks .. tm_vz unread),
// and RoPE tables (header)
template <int HD, bool CHUNKED, int NP, int MT, bool V3>
__device__ __forceinline__ void exact_body(const CUtensorMap& tm_kc, const CUtensorMap& tm_vc,
                                           const CUtensorMap& tm_ks, const CUtensorMap& tm_kz,
                                           const CUtensorMap& tm_vs, const CUtensorMap& tm_vz,
                                           const CUtensorMap& tm_b, const ExactArgs& a) {
  static_assert(!V3 || !CHUNKED, "v3: per-row scales");
  constexpr int NACC = HD / 2;     // K accumulator registers per thread
  constexpr int HALF = HD / 2;
  constexpr int RS = HALF + 4;     // padded rows of the rotation tile
  const Plan& L = a.L;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t bars = base + L.bars;
  const uint32_t full = bars, empty = bars + 8 * L.ns;
  const uint32_t bfull = bars + 16 * L.ns, bempty = bfull + 8 * L.nb;
  // rope_full: V -> K, the tile's rotation is ready; rope_empty: K -> V, it
  // is read; p_full: K -> V, P^T and alpha are ready; p_empty: V -> K, read
  const uint32_t rope_full = bempty + 8 * L.nb, rope_empty = rope_full + 8;
  const uint32_t p_full = rope_empty + 8, p_empty = p_full + 8;
  uint32_t* ktab = reinterpret_cast<uint32_t*>(sm + L.ktab);
  uint32_t* vtab = reinterpret_cast<uint32_t*>(sm + L.vtab);
  float* q_s = reinterpret_cast<float*>(sm + L.q);      // [hpg][HD], times 1 / sqrt(hd)
  float* lg = reinterpret_cast<float*>(sm + L.lg);      // [hpg][kTile] logits
  float* cos_s = reinterpret_cast<float*>(sm + L.rope);  // [kTile][RS]
  float* sin_s = cos_s + kTile * RS;
  // [4][kMaxHeads]: m, l, alpha, and (per-row asym) the sum of p * zero_v
  float* m_s = reinterpret_cast<float*>(sm + L.stats);
  float* l_s = m_s + kMaxHeads;
  float* alpha_s = m_s + 2 * kMaxHeads;
  float* zsum_s = m_s + 3 * kMaxHeads;
  const packed::Stats stats{m_s, l_s, alpha_s, zsum_s};

  // the warpgroup's role, broadcast from lane 0 so that ptxas sees it warp-
  // uniform: wgmma under a branch it takes for divergent runs serialized (C7520)
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / kWG, 0);
  const int nh = a.G * a.hpg;
  const int nchunks = a.nkv * L.nrc;
  if (tid == 0) {
    for (int s = 0; s < L.ns; ++s) {
      mbar_init(full + 8 * s, V3 ? 1 + 32 : 1);  // V3: and the scale warp's lanes
      mbar_init(empty + 8 * s, 2 * kWG);
    }
    for (int s = 0; s < L.nb; ++s) {
      mbar_init(bfull + 8 * s, 1);
      mbar_init(bempty + 8 * s, kWG);
    }
    mbar_init(rope_full, kWG);
    mbar_init(rope_empty, kWG);
    mbar_init(p_full, kWG);
    mbar_init(p_empty, kWG);
    mbar_init_fence();
  }
  for (int r = tid; r < a.rk; r += kThreads) ktab[r] = rank_entry(r, a.rk, a.pbits);
  for (int r = tid; r < a.rv; r += kThreads) vtab[r] = rank_entry(r, a.rv, a.pbits);
  for (int i = tid; i < 2 * NP * 128 / 4; i += kThreads)
    reinterpret_cast<uint32_t*>(sm + L.p)[i] = 0u;  // heads past hpg stay 0
  if (tid < kMaxHeads) alpha_s[tid] = 1.0f;
  __syncthreads();

  if (wg == 2) {
    // ---- producer: thread 0 of warp 8 streams tiles, thread 0 of warp 9 B
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int lt = tid - 2 * kWG;
    if (lt == 0) {
      int it = 0;
      for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
        const Item w = item_at(a, item);
        const int plane = (a.layer * a.B + w.b) * a.G + w.g;
        for (int tile = w.t0; tile < w.t1; ++tile, ++it) {
          const int st = it % L.ns;
          mbar_wait(empty + 8 * st, ((it / L.ns) & 1) ^ 1);
          const uint32_t fb = full + 8 * st, sb = base + st * L.stage_bytes;
          mbar_expect_tx(fb, L.tx_bytes);
          const int s0 = tile * kTile;
          for (int x = 0; x < L.nbox_k; ++x)
            tma_load(sb + L.kc + x * L.rows_k * kTile, &tm_kc, fb, s0, x * L.rows_k, plane);
          for (int x = 0; x < L.nbox_v; ++x)
            tma_load(sb + L.vc + x * L.rows_v * kTile, &tm_vc, fb, s0, x * L.rows_v, plane);
          if constexpr (!V3) {  // (V3: the scale warp's)
            tma_load(sb + L.ks, &tm_ks, fb, s0, 0, plane);
            tma_load(sb + L.vs, &tm_vs, fb, s0, 0, plane);
            if (a.asym) {
              tma_load(sb + L.kz, &tm_kz, fb, s0, 0, plane);
              tma_load(sb + L.vz, &tm_vz, fb, s0, 0, plane);
            }
          }
        }
      }
    } else if (V3 && lt >= 64 && lt < 96) {
      // V3: warp 2 gathers each tile's columns g and G + g of the (B, S, 2G)
      // scales and zeros into the stage's rows, two tokens a lane (zeros
      // past S), then each lane arrives on the stage's full barrier
      const int ln = lt - 64;
      int it = 0;
      for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
        const Item w = item_at(a, item);
        for (int tile = w.t0; tile < w.t1; ++tile, ++it) {
          const int st = it % L.ns;
          mbar_wait(empty + 8 * st, ((it / L.ns) & 1) ^ 1);
          float* rows = reinterpret_cast<float*>(sm + st * L.stage_bytes);
#pragma unroll
          for (int t = ln; t < kTile; t += 32) {
            const int s = tile * kTile + t;
            float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (s < a.S) {
              const size_t row = (static_cast<size_t>(w.b) * a.S + s) * 2 * a.G + w.g;
              v[0] = __ldg(a.ksz + row), v[1] = __ldg(a.ksz + row + a.G);
              v[2] = __ldg(a.vsz + row), v[3] = __ldg(a.vsz + row + a.G);
            }
            rows[L.ks / 4 + t] = v[0], rows[L.kz / 4 + t] = v[1];
            rows[L.vs / 4 + t] = v[2], rows[L.vz / 4 + t] = v[3];
          }
          mbar_arrive(full + 8 * st);
        }
      }
    } else if (lt == 32) {
      int kb = 0;
      auto load_chunk = [&](int g, int j, int c) {
        const int slot = kb % L.nb;
        mbar_wait(bempty + 8 * slot, ((kb / L.nb) & 1) ^ 1);
        const uint32_t fb = bfull + 8 * slot, dst = base + L.slots + slot * L.slot_bytes;
        mbar_expect_tx(fb, L.slot_bytes);
#pragma unroll
        for (int cc = 0; cc < HD / 64; ++cc)
          tma_load(dst + cc * L.rc * 128, &tm_b, fb, cc * 64, c * L.rc, g * a.nkv + j);
        ++kb;
      };
      for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
        const Item w = item_at(a, item);
        if (w.t1 <= w.t0) continue;
        const int nt = L.resident ? 1 : w.t1 - w.t0;
        for (int t = 0; t < nt; ++t)
          for (int j = 0; j < a.nkv; ++j)
            for (int c = 0; c < L.nrc; ++c) load_chunk(w.g, j, c);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wt = tid % kWG, warp = wt / 32, lane = tid % 32;
  const int gq = lane / 4, qd = lane % 4;

  if (wg == 0) {
    // ---- K warpgroup: K rebuild, logits, online softmax
    const int ta = 16 * warp + 2 * gq;  // this thread's tokens ta (row gq) and ta + 1 (row gq + 8)
    const Unpack un(a.pbits);
    int it = 0, kb = 0;
    for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
      const Item w = item_at(a, item);
      const size_t head0 = static_cast<size_t>(w.b) * nh + static_cast<size_t>(w.g) * a.hpg;
      named_sync(1, kWG);  // the previous item's reads of q_s and the statistics done
      for (int i = wt; i < a.hpg * HD; i += kWG) {
        const size_t qi = head0 * HD + i;
        const float qv = a.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[qi])
                                  : static_cast<const float*>(a.q)[qi];
        q_s[i] = qv * a.inv_sqrt_hd;
      }
      if (wt < kMaxHeads) {
        m_s[wt] = -1e30f;
        l_s[wt] = 0.0f;
      }
      named_sync(1, kWG);
      const int kb0 = kb;
      const int vlo = w.vlo, vhi = w.vhi;
      for (int tile = w.t0; tile < w.t1; ++tile, ++it) {
        const int st = it % L.ns, s0 = tile * kTile;
        mbar_wait(full + 8 * st, (it / L.ns) & 1);
        const uint8_t* stage = sm + st * L.stage_bytes;
        const uint8_t* kbytes = stage + L.kc;
        const float* ksc = reinterpret_cast<const float*>(stage + L.ks);
        const float* kzc = reinterpret_cast<const float*>(stage + L.kz);
        const float* vsc = reinterpret_cast<const float*>(stage + L.vs);
        const float* vzc = reinterpret_cast<const float*>(stage + L.vz);
        uint32_t af[kMaxKSteps][4];
        if (L.nrc == 1) {
          if (a.pbits == 4)
            k_fragments4(af, kbytes, a.rk, 0, a.rk / 16, ta, qd, a.qoff);
          else
            k_fragments(af, kbytes, ktab, 0, a.rk / 16, ta, qd, un, a.qoff);
        }
        auto bias_of = [&](int j) {
          return a.kbias ? a.kbias + (static_cast<size_t>(w.g) * a.nkv + j) * HD : nullptr;
        };
        auto rsum_of = [&](int j) {
          return a.asym ? a.rsum + (static_cast<size_t>(w.g) * a.nkv + j) * a.nsk * HD : nullptr;
        };
        // per-row scales, all ranks in one chunk: kv-head j + 1's products run
        // under kv-head j's epilogue (two accumulators)
        const bool pingpong = !CHUNKED && L.nrc == 1;
        if (pingpong) {
          float kva[NACC], kvb[NACC];
          const int nks = a.rk / 16, lbo = L.rc * 128;
          // with no K bias and no zero term K is scale * codes^T B: the token
          // scale multiplies the logits (RoPE and the dot are linear) rather
          // than every K value
          const bool fold = a.asym || a.kbias != nullptr;
          const float la_s = fold ? 1.0f : ksc[ta], lb_s = fold ? 1.0f : ksc[ta + 1];
          // kv-head j's B slot: use j of the tile (resident: of the item)
          auto use_of = [&](int j) { return L.resident ? kb0 + j : kb + j; };
          auto slot_of = [&](int j) { return use_of(j) % L.nb; };
          auto full_of = [&](int j) { return bfull + 8 * slot_of(j); };
          auto parity_of = [&](int j) { return static_cast<uint32_t>(use_of(j) / L.nb) & 1u; };
          auto addr_of = [&](int j) { return base + L.slots + slot_of(j) * L.slot_bytes; };
          k_issue<HD>(kva, af, nks, full_of(0), parity_of(0), addr_of(0), lbo);
          for (int j = 0; j < a.nkv; j += 2) {
            if (j + 1 < a.nkv) {
              k_issue<HD>(kvb, af, nks, full_of(j + 1), parity_of(j + 1), addr_of(j + 1), lbo);
              wgmma_wait1();
            } else {
              wgmma_wait0();
            }
            fence_regs(kva);
            if (!L.resident) mbar_arrive(bempty + 8 * slot_of(j));
            if (fold) fold_chunk<HD, false>(kva, kva, ksc, kzc, rsum_of(j), 0, ta, qd, a.asym);
            if (j == 0) mbar_wait(rope_full, it & 1);  // this tile's rotation
            k_finish<HD>(kva, bias_of(j), cos_s, sin_s, q_s, lg, j * a.rep, a.rep, ta, qd, la_s,
                         lb_s);
            if (j + 1 < a.nkv) {
              if (j + 2 < a.nkv) {
                k_issue<HD>(kva, af, nks, full_of(j + 2), parity_of(j + 2), addr_of(j + 2), lbo);
                wgmma_wait1();
              } else {
                wgmma_wait0();
              }
              fence_regs(kvb);
              if (!L.resident) mbar_arrive(bempty + 8 * slot_of(j + 1));
              if (fold)
                fold_chunk<HD, false>(kvb, kvb, ksc, kzc, rsum_of(j + 1), 0, ta, qd, a.asym);
              k_finish<HD>(kvb, bias_of(j + 1), cos_s, sin_s, q_s, lg, (j + 1) * a.rep, a.rep,
                           ta, qd, la_s, lb_s);
            }
          }
          if (!L.resident) kb += a.nkv;
        }
        for (int j = 0; j < (pingpong ? 0 : a.nkv); ++j) {
          float kv[NACC];    // K of kv-head j (its scale chunk's partial sum when CHUNKED)
          float kacc[NACC];  // CHUNKED: K, the sum of the folded chunks
          if constexpr (CHUNKED) {
#pragma unroll
            for (int i = 0; i < NACC; ++i) kacc[i] = 0.0f;
          }
          const float* rs = rsum_of(j);
          int first = 1;         // the next product starts a new partial sum (scale_d 0)
          bool need_fence = true;  // registers of kv were touched since the last issue
          for (int c = 0; c < L.nrc; ++c) {
            const int r0 = c * L.rc, nks = min(L.rc, a.rk - r0) / 16;
            if (L.nrc > 1) {
              if (a.pbits == 4)
                k_fragments4(af, kbytes, a.rk, r0, nks, ta, qd, a.qoff);
              else
                k_fragments(af, kbytes, ktab, r0, nks, ta, qd, un, a.qoff);
            }
            const int use = L.resident ? kb0 + j * L.nrc + c : kb;
            const int slot = use % L.nb;
            mbar_wait(bfull + 8 * slot, (use / L.nb) & 1);  // (resident: done after the first)
            const uint32_t bsl = base + L.slots + slot * L.slot_bytes;
            if constexpr (!CHUNKED) {
              fence_regs(kv);
              wgmma_fence();
              k_chain_n<HD>(nks, kv, af, bsl, L.rc * 128, first);
              first = 0;
              wgmma_commit();
              wgmma_wait0();
              fence_regs(kv);
            } else if (a.gsk % 16 == 0 && (a.gsk & (a.gsk - 1)) == 0 && L.rc % a.gsk == 0 &&
                       a.gsk <= 16 * kMaxKSteps) {
              // scale chunks of 1, 2, 4 or 8 whole k-steps inside the rank
              // chunk: one chain per scale chunk, folded at its end
              const int len = a.gsk / 16;
#pragma unroll
              for (int k0 = 0; k0 < kMaxKSteps; ++k0) {
                if (k0 % len || k0 >= nks) continue;
                fence_regs(kv);
                wgmma_fence();
                switch (len) {
                  case 1: k_chain<HD, 1>(kv, af, k0, bsl, L.rc * 128, 1); break;
                  case 2: k_chain<HD, 2>(kv, af, k0, bsl, L.rc * 128, 1); break;
                  case 4: k_chain<HD, 4>(kv, af, k0, bsl, L.rc * 128, 1); break;
                  default: k_chain<HD, kMaxKSteps>(kv, af, 0, bsl, L.rc * 128, 1); break;
                }
                wgmma_commit();
                wgmma_wait0();
                fence_regs(kv);
                const int sc = (r0 + 16 * (k0 + len) - 1) / a.gsk;
                fold_chunk<HD, CHUNKED>(kv, kacc, ksc, kzc, rs, sc, ta, qd, a.asym);
              }
            } else {
              // scale chunks of gsk ranks; a chunk of 8 ends inside a k-step:
              // then each half k-step runs alone on a masked A fragment
              const int nsub = a.gsk % 16 ? 2 : 1;
#pragma unroll
              for (int kk = 0; kk < kMaxKSteps; ++kk) {
                if (kk >= nks) continue;
                for (int sub = 0; sub < nsub; ++sub) {
                  const int r_end = r0 + 16 * kk + (sub + 1) * (16 / nsub);
                  const bool chunk_end = r_end % a.gsk == 0;
                  const uint64_t bd = sw128_desc(bsl + kk * 2048, L.rc * 128, 1024);
                  if (need_fence) {
                    fence_regs(kv);
                    wgmma_fence();
                    need_fence = false;
                  }
                  if (nsub == 1) {
                    wgmma_k<HD>(kv, af[kk], bd, !first);
                  } else {  // one half k-step alone, waited at once (am is a temporary)
                    uint32_t am[4] = {sub == 0 ? af[kk][0] : 0u, sub == 0 ? af[kk][1] : 0u,
                                      sub == 1 ? af[kk][2] : 0u, sub == 1 ? af[kk][3] : 0u};
                    wgmma_k<HD>(kv, am, bd, !first);
                    wgmma_commit();
                    wgmma_wait0();
                    fence_regs(am);
                    fence_regs(kv);
                    need_fence = true;
                  }
                  first = 0;
                  if (nsub == 1 && (chunk_end || r_end == r0 + 16 * nks)) {
                    wgmma_commit();
                    wgmma_wait0();
                    fence_regs(kv);
                    need_fence = true;
                  }
                  if (chunk_end) {
                    fold_chunk<HD, CHUNKED>(kv, kacc, ksc, kzc, rs, (r_end - 1) / a.gsk, ta,
                                            qd, a.asym);
                    first = 1;
                  }
                }
              }
            }
            if (!L.resident) {
              mbar_arrive(bempty + 8 * slot);
              ++kb;
            }
          }
          if constexpr (!CHUNKED)
            fold_chunk<HD, CHUNKED>(kv, kacc, ksc, kzc, rs, 0, ta, qd, a.asym);
          float(&kf)[NACC] = CHUNKED ? kacc : kv;
          if (j == 0) mbar_wait(rope_full, it & 1);  // this tile's rotation
          k_finish<HD>(kf, bias_of(j), cos_s, sin_s, q_s, lg, j * a.rep, a.rep, ta, qd);
        }
        mbar_arrive(rope_empty);      // the rotation is read
        named_sync(1, kWG);           // every head's logits of the tile are in lg
        if (it > 0) mbar_wait(p_empty, (it - 1) & 1);  // the last tile's P^T and alpha are read
        // ---- online softmax, one warp per head; P^T in bf16 high + low parts
        packed::softmax_tile<NP, CHUNKED>(sm + L.p, lg, stats, a.hpg, 0, a.hpg, s0, vlo, vhi,
                                          tile == w.t0, vsc, vzc, a.asym, warp, lane);
        mbar_arrive(empty + 8 * st);  // the stage is read (the V scales above)
        mbar_arrive(p_full);
      }
      if (L.resident && w.t1 > w.t0) {
        for (int k = kb0; k < kb0 + nchunks; ++k) mbar_arrive(bempty + 8 * (k % L.nb));
        kb = kb0 + nchunks;
      }
      named_sync(1, kWG);  // the softmax warps' statistics are final
      if (wt < a.hpg) {
        a.part_m[(head0 + wt) * a.splits + w.split] = m_s[wt];
        a.part_l[(head0 + wt) * a.splits + w.split] = l_s[wt];
      }
    }
  } else {
    // ---- V warpgroup: per tile k the rotation of k, then out^T += Vdeq .
    // P^T of tile k - 1 (the K warpgroup's epilogue of k overlaps it)
    const int fr = wt % HALF, t_step = kWG / HALF;
    const float inv = V3 ? 0.0f : a.inv_freq[fr];
    const Unpack un(a.pbits);
    float acc[MT][NP / 8][4];  // per 64-rank tile and 8-head tile: rows gq, gq + 8
    int it = 0;
    for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
      const Item w = item_at(a, item);
      const size_t head0 = static_cast<size_t>(w.b) * nh + static_cast<size_t>(w.g) * a.hpg;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NP / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;
      // tile steps t0 .. t1: the rotation of tile `tile`, then the V product
      // of tile - 1 (the last step only the product)
      for (int tile = w.t0; w.t1 > w.t0 && tile <= w.t1; ++tile) {
        if (tile < w.t1) {
          const int s0 = tile * kTile;
          if (it > 0) mbar_wait(rope_empty, (it - 1) & 1);  // the K side read the last one
          if constexpr (V3) {
            // R(s) = R(s0) R(s - s0): the tile's rows of the block-relative
            // tables composed with its rotation block's start
            const int blk = s0 / a.block_s, r0 = s0 - blk * a.block_s;
            const float c0 = __ldg(a.c0 + blk * HALF + fr), sn0 = __ldg(a.s0 + blk * HALF + fr);
            const float* rc = a.rcos + static_cast<size_t>(r0) * HALF + fr;
            const float* rn = a.rsin + static_cast<size_t>(r0) * HALF + fr;
#pragma unroll 8
            for (int t = wt / HALF; t < kTile; t += t_step) {
              const float c = __ldg(rc + t * HALF), sn = __ldg(rn + t * HALF);
              cos_s[t * RS + fr] = c0 * c - sn0 * sn;
              sin_s[t * RS + fr] = sn0 * c + c0 * sn;
            }
          } else {
            // RoPE of positions pos_offset + s0 + t at the plain version's f32 angle
#pragma unroll 4
            for (int t = wt / HALF; t < kTile; t += t_step) {
              float sn, cs;
              decode::sincos_fast(__fmul_rn(static_cast<float>(a.pos_offset + s0 + t), inv), sn,
                                  cs);
              cos_s[t * RS + fr] = cs * a.rope_scale;
              sin_s[t * RS + fr] = sn * a.rope_scale;
            }
          }
          mbar_arrive(rope_full);
          ++it;
        }
        if (tile == w.t0) continue;
        const int vit = it - 1 - (tile < w.t1);  // the V product's tile
        const int st = vit % L.ns;
        mbar_wait(full + 8 * st, (vit / L.ns) & 1);
        mbar_wait(p_full, vit & 1);
        const uint8_t* stage = sm + st * L.stage_bytes;
        packed::v_tile<NP, MT, CHUNKED>(acc, sm + L.p, alpha_s, stage + L.vc,
                                        reinterpret_cast<const float*>(stage + L.vs),
                                        reinterpret_cast<const float*>(stage + L.vz), vtab, a.rv,
                                        a.gsv, a.asym, a.qoff, un, warp, lane);
        // P^T and alpha are read (the item's last: after its partials, below)
        if (tile < w.t1) mbar_arrive(p_empty);
        mbar_arrive(empty + 8 * st);
      }
      packed::v_store<NP, MT>(acc, a.part_acc, zsum_s, w.t1 > w.t0, head0, a.splits, w.split,
                              a.rv, a.hpg, warp, lane);
      if (w.t1 > w.t0) mbar_arrive(p_empty);  // the item's last P^T is read
    }
  }
}

template <int HD, bool CHUNKED, int NP, int MT>
__global__ void __launch_bounds__(kThreads, 1)
palu_decode_exact_kernel(const __grid_constant__ CUtensorMap tm_kc,
                         const __grid_constant__ CUtensorMap tm_vc,
                         const __grid_constant__ CUtensorMap tm_ks,
                         const __grid_constant__ CUtensorMap tm_kz,
                         const __grid_constant__ CUtensorMap tm_vs,
                         const __grid_constant__ CUtensorMap tm_vz,
                         const __grid_constant__ CUtensorMap tm_b, const ExactArgs a) {
  exact_body<HD, CHUNKED, NP, MT, false>(tm_kc, tm_vc, tm_ks, tm_kz, tm_vs, tm_vz, tm_b, a);
}

// the v3 packed decode (header): no scale map, the scale warp gathers them
template <int HD, int NP, int MT>
__global__ void __launch_bounds__(kThreads, 1)
palu_decode_v3_kernel(const __grid_constant__ CUtensorMap tm_kc,
                      const __grid_constant__ CUtensorMap tm_vc,
                      const __grid_constant__ CUtensorMap tm_b, const ExactArgs a) {
  exact_body<HD, false, NP, MT, true>(tm_kc, tm_vc, tm_b, tm_b, tm_b, tm_b, tm_b, a);
}

template <int HD, bool CHUNKED, int NP, int MT, bool V3>
int launch(int grid, const CUtensorMap (&tm)[7], const ExactArgs& a, cudaStream_t st) {
  const int smem = static_cast<int>(a.L.total) + 1024;
  if constexpr (V3) {
    auto kern = palu_decode_v3_kernel<HD, NP, MT>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, kThreads, smem, st>>>(tm[0], tm[1], tm[6], a);
  } else {
    auto kern = palu_decode_exact_kernel<HD, CHUNKED, NP, MT>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, kThreads, smem, st>>>(tm[0], tm[1], tm[2], tm[3], tm[4], tm[5], tm[6], a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for hpg heads per group and rv: NP 8 (hpg <= 8) or 32,
// MT 8, or 4 at NP 32 and rv <= 256.
template <int HD, bool CHUNKED>
int launch_shape(int hpg, int rv, int grid, const CUtensorMap (&tm)[7], const ExactArgs& a,
                 cudaStream_t st) {
  if (hpg <= 8) return launch<HD, CHUNKED, 8, 8, false>(grid, tm, a, st);
  if (rv <= 256) return launch<HD, CHUNKED, 32, 4, false>(grid, tm, a, st);
  return launch<HD, CHUNKED, 32, 8, false>(grid, tm, a, st);
}

template <int HD>
int launch_hd(bool chunked, int hpg, int rv, int grid, const CUtensorMap (&tm)[7],
              const ExactArgs& a, cudaStream_t st) {
  return chunked ? launch_shape<HD, true>(hpg, rv, grid, tm, a, st)
                 : launch_shape<HD, false>(hpg, rv, grid, tm, a, st);
}

}  // namespace

// The shared memory a launch at these shapes takes, or -1 when no plan of
// the kernel fits in one block (the wrapper raises then).
extern "C" int palu_decode_exact_smem(int hd, int rk, int rv, int hpg, int nkv, int nrk, int nrv,
                                      int nsk, int nsv, int asym) {
  const Plan p = make_plan(hd, rk, rv, hpg, nkv, nrk, nrv, nsk, nsv, asym, hpg <= 8 ? 8 : 32);
  return p.ok ? static_cast<int>(p.total) + 1024 : -1;
}

// q (B, nh, hd) bf16 or f32; bk (G, nkv, rk, hd) bf16 with nkv dividing
// hpg = nh / G (q-head h of a group reads kv-head h / (hpg / nkv)); codes
// kc / vc (L, B, G, nrk / nrv, S) uint8 (L = n_layers, 1 for one layer's
// buffers; layer picks one); scales and zeros (L, B, G, nsk / nsv, S) f32
// (nsk = nsv = 1: per-row scales; else rank / gs per-chunk rows), zeros
// only when asym; kv_len (B,) int32 absolute; kbias null or (G, nkv, hd)
// f32; inv_freq (hd / 2,) f32; rsum scratch of G * nkv * nsk * hd f32
// (asym); partials (B, nh, splits) m and l, (B, nh, splits, rv) accumulators;
// out (B, nh, rv) f32, or with m_out / l_out the raw statistics. hd 64 or
// 128, rk and rv multiples of 16 up to 512, hpg <= 32, S a multiple of 16. splits: the wrapper's _splits; grid
// blocks loop over the B * G * splits work items.
extern "C" int palu_decode_exact(const void* q, int q_bf16, const void* bk, const void* kc,
                                 const void* ks, const void* kz, const void* vc, const void* vs,
                                 const void* vz, const void* kv_len, const void* kbias,
                                 const void* inv_freq, void* rsum, void* part_m, void* part_l,
                                 void* part_acc, void* out, int B, int G, int hpg, int nkv,
                                 int hd, int rk, int rv, int S, int nrk, int nrv, int pbits,
                                 int qoff, int asym, int window, int nsk, int nsv, int splits,
                                 int grid, int layer, int n_layers, int pos_offset,
                                 float inv_sqrt_hd, float rope_scale, void* m_out, void* l_out,
                                 void* stream) {
  if ((hd != 64 && hd != 128) || rk % 16 || rv % 16 || rk > kMaxRank || rv > kMaxRank ||
      hpg > kMaxHeads || nkv <= 0 || hpg % nkv || S % 16 || nsk <= 0 || nsv <= 0 || rk % nsk ||
      rv % nsv || layer < 0 || layer >= n_layers ||
      (m_out == nullptr) != (l_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int np = hpg <= 8 ? 8 : 32;
  ExactArgs a{};
  a.L = make_plan(hd, rk, rv, hpg, nkv, nrk, nrv, nsk, nsv, asym, np);
  if (!a.L.ok) return static_cast<int>(cudaErrorInvalidValue);
  a.q = q;
  a.q_bf16 = q_bf16;
  a.kbias = static_cast<const float*>(kbias);
  a.rsum = static_cast<const float*>(rsum);
  a.inv_freq = static_cast<const float*>(inv_freq);
  a.kv_len = static_cast<const int*>(kv_len);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.part_acc = static_cast<float*>(part_acc);
  a.B = B, a.G = G, a.hpg = hpg, a.nkv = nkv, a.rep = hpg / nkv, a.rk = rk, a.rv = rv, a.S = S;
  a.pbits = pbits, a.qoff = qoff, a.asym = asym, a.window = window;
  a.nsk = nsk, a.nsv = nsv, a.gsk = rk / nsk, a.gsv = rv / nsv;
  a.splits = splits, a.n_items = B * G * splits;
  a.layer = layer, a.pos_offset = pos_offset;
  a.inv_sqrt_hd = inv_sqrt_hd, a.rope_scale = rope_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (asym) {
    const int err = decode::launch_rowsum(static_cast<const __nv_bfloat16*>(bk),
                                          static_cast<float*>(rsum), G * nkv, nsk, rk, hd, st);
    if (err != 0) return err;
  }
  const uint64_t planes = static_cast<uint64_t>(n_layers) * B * G;
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8, f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const auto none = CU_TENSOR_MAP_SWIZZLE_NONE;
  CUtensorMap tm[7];
  bool ok = make_map_3d(&tm[0], u8, 1, kc, S, nrk, planes, kTile, a.L.rows_k, none) &&
            make_map_3d(&tm[1], u8, 1, vc, S, nrv, planes, kTile, a.L.rows_v, none) &&
            make_map_3d(&tm[2], f32, 4, ks, S, nsk, planes, kTile, nsk, none) &&
            make_map_3d(&tm[4], f32, 4, vs, S, nsv, planes, kTile, nsv, none) &&
            make_map_3d(&tm[6], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, bk, hd, rk,
                        static_cast<uint64_t>(G) * nkv, 64, a.L.rc, CU_TENSOR_MAP_SWIZZLE_128B);
  if (ok && asym)
    ok = make_map_3d(&tm[3], f32, 4, kz, S, nsk, planes, kTile, nsk, none) &&
         make_map_3d(&tm[5], f32, 4, vz, S, nsv, planes, kTile, nsv, none);
  else
    tm[3] = tm[2], tm[5] = tm[4];
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const bool chunked = nsk > 1 || nsv > 1;
  int err = hd == 128 ? launch_hd<128>(chunked, hpg, rv, grid, tm, a, st)
                      : launch_hd<64>(chunked, hpg, rv, grid, tm, a, st);
  if (err != 0) return err;
  return decode::launch_combine(static_cast<const float*>(part_m),
                                static_cast<const float*>(part_l),
                                static_cast<const float*>(part_acc), static_cast<float*>(out),
                                B * G * hpg, splits, rv, st, static_cast<float*>(m_out),
                                static_cast<float*>(l_out));
}

// The v3 decode's shared memory at these shapes (per-row asym rows, one B
// per q-head: v2's plan), or -1 when no plan fits in one block (the
// wrapper raises then).
extern "C" int palu_decode_v3_smem(int hd, int rk, int rv, int hpg, int nrk, int nrv) {
  const Plan p = make_plan(hd, rk, rv, hpg, hpg, nrk, nrv, 1, 1, 1, hpg <= 8 ? 8 : 32, 1);
  return p.ok ? static_cast<int>(p.total) + 1024 : -1;
}

// The v3 packed decode (header): q (B, nh, hd) bf16 or f32, pre-scaled by
// 1 / sqrt(hd); bk (G, hpg, rk, hd) bf16; codes kc / vc (B, G, nrk / nrv, S)
// uint8 rank-major; ksz / vsz (B, S, 2G) f32, scales in columns [0, G) and
// zeros in [G, 2G); kv_len (B,) int32; c0 / s0 (S / block_s, hd / 2) and
// rcos / rsin (block_s, hd / 2) f32; rsum scratch of G * hpg * hd f32;
// partials and out as palu_decode_exact. hd 128, rk and rv multiples of 16
// up to 512, hpg <= 8, S a multiple of 16 and at least 64, block_s a
// multiple of 64 that divides S, codes and bk 16-byte aligned.
extern "C" int palu_decode_v3(const void* q, int q_bf16, const void* bk, const void* kc,
                              const void* ksz, const void* vc, const void* vsz,
                              const void* kv_len, const void* c0, const void* s0,
                              const void* rcos, const void* rsin, void* rsum, void* part_m,
                              void* part_l, void* part_acc, void* out, int B, int G, int hpg,
                              int hd, int rk, int rv, int S, int nrk, int nrv, int pbits,
                              int window, int block_s, int splits, int grid, void* stream) {
  if (hd != 128 || rk % 16 || rv % 16 || rk > kMaxRank || rv > kMaxRank || hpg <= 0 ||
      hpg > 8 || G <= 0 || S % 16 || S < kTile ||
      (pbits != 2 && pbits != 3 && pbits != 4 && pbits != 8) || block_s <= 0 ||
      block_s % kTile || S % block_s)
    return static_cast<int>(cudaErrorInvalidValue);
  ExactArgs a{};
  a.L = make_plan(hd, rk, rv, hpg, hpg, nrk, nrv, 1, 1, 1, hpg <= 8 ? 8 : 32, 1);
  if (!a.L.ok) return static_cast<int>(cudaErrorInvalidValue);
  a.q = q;
  a.q_bf16 = q_bf16;
  a.rsum = static_cast<const float*>(rsum);
  a.ksz = static_cast<const float*>(ksz);
  a.vsz = static_cast<const float*>(vsz);
  a.c0 = static_cast<const float*>(c0);
  a.s0 = static_cast<const float*>(s0);
  a.rcos = static_cast<const float*>(rcos);
  a.rsin = static_cast<const float*>(rsin);
  a.kv_len = static_cast<const int*>(kv_len);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.part_acc = static_cast<float*>(part_acc);
  a.B = B, a.G = G, a.hpg = hpg, a.nkv = hpg, a.rep = 1, a.rk = rk, a.rv = rv, a.S = S;
  a.pbits = pbits, a.qoff = 0, a.asym = 1, a.window = window;
  a.nsk = a.nsv = 1, a.gsk = rk, a.gsv = rv;
  a.splits = splits, a.n_items = B * G * splits;
  a.block_s = block_s;
  a.inv_sqrt_hd = 1.0f, a.rope_scale = 1.0f;  // q pre-scaled; rope_scale in the tables
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = decode::launch_rowsum(static_cast<const __nv_bfloat16*>(bk),
                                  static_cast<float*>(rsum), G * hpg, 1, rk, hd, st);
  if (err != 0) return err;
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const auto none = CU_TENSOR_MAP_SWIZZLE_NONE;
  const uint64_t planes = static_cast<uint64_t>(B) * G;
  CUtensorMap tm[7];  // codes and B; the scales come by loads (tm[2] .. tm[5] unread)
  const bool ok = make_map_3d(&tm[0], u8, 1, kc, S, nrk, planes, kTile, a.L.rows_k, none) &&
                  make_map_3d(&tm[1], u8, 1, vc, S, nrv, planes, kTile, a.L.rows_v, none) &&
                  make_map_3d(&tm[6], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, bk, hd, rk,
                              static_cast<uint64_t>(G) * hpg, 64, a.L.rc,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  err = launch<128, false, 8, 8, true>(grid, tm, a, st);
  if (err != 0) return err;
  return decode::launch_combine(static_cast<const float*>(part_m),
                                static_cast<const float*>(part_l),
                                static_cast<const float*>(part_acc), static_cast<float*>(out),
                                B * G * hpg, splits, rv, st);
}
