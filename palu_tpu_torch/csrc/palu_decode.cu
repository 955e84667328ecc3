// Latent decode attention over the rank-major packed cache, split over the
// sequence (flash-decoding) with a second kernel that combines the splits.
//
// Replaces: palu_tpu/ops/pallas/palu_decode4.py::palu_flash_decode4_quantized
// (body _make_kernel4, launch _call4), per-row scales, sym and asym, in its
// three K-path modes: exact (the default), int8_dots and int8_rot (MODE 0,
// 1, 2 below; the V path and the combine are the same in all three); its
// per-chunk scales (group_chunk, the reference's --lt_group_size) in the
// exact mode (MODE 3); and its pre-RoPE K bias (k_bias, Qwen2) in all four.
//
// What it computes, per lane b, group g and q-head h of the group:
//   K_h(s) = scale_k(s) * B_h^T (code_k(s) - qoff)  [+ zero_k(s) * rowsum B_h]
//            [+ b_h, the K bias]
//   logit(s) = q_h . RoPE_s(K_h(s)) / sqrt(hd), masked by kv_len and window
//   out_h = sum_s softmax(logit)(s) * (scale_v(s) * (code_v(s) - qoff) [+ zero_v(s)])
// -> (B, nh, rv) in latent space (o_proj is U_v-fused). With per-chunk
// scales each contiguous chunk of gs ranks has its own scale (and zero)
// per token: K_h(s) = sum_c scale_c(s) * B_hc^T (code_c(s) - qoff)
// [+ zero_c(s) * rowsum B_hc], and the V values likewise.
//
// Bound on this card: rebuilding K costs rk * hd multiply-adds per head per
// token (2 * nh * rk * hd flops per token, ~8.6 GFLOP per layer at 8K
// tokens of the 7B shapes), against (rk + rv) / 2 bytes of codes per token
// and group in 4-bit containers (18 MB per layer at 8K). On the tensor
// cores the flops take about as long as the bytes (9 vs 5.5 us); on the
// f32 pipes they would take ~15x longer. So the reconstruct runs on the
// tensor cores: codes are small integers, exact in bf16, and B is the
// engine's bf16 weight, so a bf16 product with f32 accumulation is exact
// up to f32 summation order; the per-token scale multiplies the f32 result
// afterwards.
//
// The split kernel lives in palu_decode_split.cuh (shared with the
// archived v2 and v3 decodes, palu_decode2.cu and palu_decode3.cu).
//
// Design: grid (splits, G, B), 8 warps, about one block per SM. A block
// stages the B_h of its group's heads in shared memory once with cp.async
// (in chunks of heads when they do not all fit), then walks its tiles of 64
// tokens: 16-byte loads bring the packed K and V byte rows and the rope
// rows into shared memory, a per-block table of each rank's byte row and
// shift turns unpacking into lookups and shifts, and the K codes are
// unpacked as a bf16 (ranks x 64) tile. Ranks above 128 (a G-LRD group
// reaches 512 at group size 4 and hd 128) run in rank chunks of at most 128:
// B_h for 4 heads at rk 512 is 512 KB, beyond a block's 227 KB, and the
// A fragments of all k-steps would not fit in registers either. RoPE and
// the q dot are linear in K, so each chunk's partial K (codes of its ranks
// times its rows of B) is rotated and dotted in registers and its partial
// logits are summed in f32 across chunks; the chunk's B rows stream through
// the buffer that holds all of B when it fits (then it is staged once per
// block). Per head, K (64 tokens x hd) = codes^T . B_h runs as mma.sync
// m16n8k16 (bf16 in, f32 accumulate): warp w
// takes 16 tokens and matching quarters of both halves of hd, so the two
// halves of each RoPE pair sit in one thread's accumulators; RoPE and the
// q dot run on them in registers and quad shuffles finish each partial
// logit. RoPE uses f32 cos/sin tables the wrapper built exactly as the
// plain version does (no __sinf on large angles). Each head keeps (m, l)
// and a latent accumulator (rv) in shared memory; the V codes are unpacked
// once per tile per rank into registers and contracted against
// p * scale_v. Blocks past kv_len (or before the window) do no tile work.
// The combine kernel merges the per-split (m, l, acc) with the usual
// rescaling. Nothing allocates here: the wrapper hands in the partials.
//
// Per-chunk scales (MODE 3): a scale that changes inside a row cannot
// multiply the f32 result of the whole rank sum, so the K rebuild keeps one
// more set of accumulators: each chunk's k-steps (16 ranks each; a chunk of
// 8 takes one half of a k-step's A fragment, the other half zeroed) sum
// codes^T B into it, and at the chunk's end the thread adds it to the main
// accumulators times the chunk's scale of the accumulator row's token. The
// asym zero term zero_c(s) * rowsum B_hc comes from a third set, the same
// mma with an A fragment of ones, times the chunk's zero. So K stays exact
// up to f32 summation order, as in the per-row mode (the JAX kernel instead
// dequantizes the chunk into its bf16 operand). The V side dequantizes each
// rank's 64 codes in registers with its chunk's scale and zero.
//
// The K bias (k_bias, f32 (G, hpg, hd)): the exact modes add b_h to the two
// RoPE halves of K in registers before the rotation, as JAX's XLA fallback
// does. The int8 modes add JAX's cache-independent logit term instead,
// U_b . rcos(t) + V_b . rsin(t) with U_b = a1 b1 + a2 b2, V_b = a2 b1 - a1 b2
// (a1 / a2 the scaled query rotated to the block's start), formed per
// rotation block beside the operand and summed per token with the zero
// correction, after the per-token scale.
//
// The int8 modes (k_path / k_path_i8 of the JAX kernel) fold the query into
// the reconstruction operand per rotation block of block_s tokens: with
// a1/a2 the scaled query rotated to the block's start (tables c0/s0),
// bq1 = a1 B1^T + a2 B2^T and bq2 = a2 B1^T - a1 B2^T, (hd/2, rk) per head
// each, quantized to int8 per row (int8_dots) or per head and half
// (int8_rot). The block builds them when its tile walk enters a new
// rotation block, from B in global memory (L2-resident: 128 KB per group at
// rk 128), into shared memory as one int8 (hd, rk) operand per head (at rk
// 512 one head's operand is 66 KB: fewer heads per chunk), with their
// scales and the scaled row sums of the quantized operand (the zero
// correction). Unsigned codes, unpacked once per tile as an int8 (64 x rk)
// tile, meet the operand in mma.sync m16n8k32 s8 x s8 -> s32 (the A
// fragments of ranks past 128 loaded per k-step): u and v land
// in one thread's accumulators for the same frequency, exactly as K's two
// RoPE halves do in the exact mode. int8_dots then rotates in f32 against
// the block-relative tables (rcos/rsin); int8_rot rotates in int32 against
// the int8 tables (cos8/sin8) and sums each head in int32. Either way the
// per-token scale multiplies afterwards and the zero correction adds
// zero(s) * sum_e (r1 rcos + r2 rsin), zero = -qoff * scale for sym. The
// wrapper requires block_s % 64 == 0, so a tile never straddles two blocks.
// Bound: the int8 dots halve the K rebuild's tensor-core time (4.3 us at
// 8K on the 7B shapes at the int8 peak) below the 18.4 MB of codes (5.5
// us), so these modes are bound by bytes where the exact one is bound by
// operations.


#include "palu_decode_split.cuh"

// Shapes in the comments of DecodeArgs; out (B, nh, rv) f32. The partial
// buffers hold B * nh * splits (m, l) and B * nh * splits * rv accumulators.
// hd is 64 or 128, rk a multiple of 16 up to 512, S a multiple of 16.
// modes 0 (exact) and 3 (exact over per-chunk scales: gs, a multiple of 8
// that divides rk and rv, ranks per scale chunk; 0 otherwise) read cos_t /
// sin_t; modes 1 (int8_dots) and 2 (int8_rot) read c0 .. sin8 and need
// rk % 32 == 0, pack width <= 4, block_s % 64 == 0 and S % block_s == 0.
// kbias is null or the (G, hpg, hd) f32 pre-RoPE K bias.
// layer selects one layer of (L, B, G, ...) stacked cache buffers (0 for a
// single layer's); the kernel offsets every cache plane by it. pos_offset is
// the absolute position of column 0 (a sequence shard's start): kv_len
// stays absolute and cos_t / sin_t (or c0 / s0) must already start at that
// position. With m_out and l_out (B * nh f32 each) the combine writes the
// raw statistics: out the unnormalised accumulator, m_out the running max,
// l_out the softmax denominator.
extern "C" int palu_decode(const void* q, int q_bf16, const void* bk, const void* kc,
                           const void* ks, const void* kz, const void* vc, const void* vs,
                           const void* vz, const void* kv_len, const void* cos_t,
                           const void* sin_t, const void* c0, const void* s0, const void* rcos,
                           const void* rsin, const void* cos8, const void* sin8,
                           const void* kbias, void* part_m, void* part_l, void* part_acc,
                           void* out, int B, int G, int hpg, int hd, int rk, int rv, int S,
                           int nrk, int nrv, int pbits, int qoff, int asym, int window,
                           int splits, int tiles_per_split, int mode, int block_s, int gs,
                           float sqrt_hd, float i8r_inv, int layer, int pos_offset,
                           void* m_out, void* l_out, void* stream) {
  if ((hd != 64 && hd != 128) || rk % 16 || rk > kMaxRank || hpg > kMaxHeads ||
      mode < 0 || mode > 3 || layer < 0 || (m_out == nullptr) != (l_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((mode == 1 || mode == 2) && (rk % 32 || pbits > 4 || block_s % kTile || S % block_s))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 3 ? (gs <= 0 || gs % 8 || rk % gs || rv % gs) : gs != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a{};
  a.q = q;
  a.q_bf16 = q_bf16;
  a.bk = static_cast<const __nv_bfloat16*>(bk);
  a.kc = static_cast<const uint8_t*>(kc);
  a.ks = static_cast<const float*>(ks);
  a.kz = static_cast<const float*>(kz);
  a.vc = static_cast<const uint8_t*>(vc);
  a.vs = static_cast<const float*>(vs);
  a.vz = static_cast<const float*>(vz);
  a.kv_len = static_cast<const int*>(kv_len);
  a.cos_t = static_cast<const float*>(cos_t);
  a.sin_t = static_cast<const float*>(sin_t);
  a.c0 = static_cast<const float*>(c0);
  a.s0 = static_cast<const float*>(s0);
  a.rcos = static_cast<const float*>(rcos);
  a.rsin = static_cast<const float*>(rsin);
  a.cos8 = static_cast<const int8_t*>(cos8);
  a.sin8 = static_cast<const int8_t*>(sin8);
  a.kbias = static_cast<const float*>(kbias);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.part_acc = static_cast<float*>(part_acc);
  a.G = G;
  a.hpg = hpg;
  a.rk = rk;
  a.rv = rv;
  a.S = S;
  a.nrk = nrk;
  a.nrv = nrv;
  a.pbits = pbits;
  a.qoff = qoff;
  a.asym = asym;
  a.window = window;
  a.splits = splits;
  a.tiles_per_split = tiles_per_split;
  a.sqrt_hd = sqrt_hd;
  a.block_s = block_s;
  a.i8r_inv = i8r_inv;
  a.gs = gs;
  a.nsk = mode == 3 ? rk / gs : 1;
  a.nsv = mode == 3 ? rv / gs : 1;
  a.layer = layer;
  a.pos_offset = pos_offset;
  return run_split<4>(a, mode, B, hd, static_cast<float*>(out),
                      static_cast<cudaStream_t>(stream), static_cast<float*>(m_out),
                      static_cast<float*>(l_out));
}
