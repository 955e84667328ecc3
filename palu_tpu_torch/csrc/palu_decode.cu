// Latent decode attention over the rank-major packed cache in the int8
// K-path modes, split over the sequence (flash-decoding) with a second
// kernel that combines the splits.
//
// Replaces: palu_tpu/ops/pallas/palu_decode4.py::palu_flash_decode4_quantized
// (body _make_kernel4, launch _call4), per-row scales, sym and asym, in its
// int8_dots and int8_rot K-path modes (MODE 1 and 2 below), with its
// pre-RoPE K bias (k_bias, Qwen2), pos_offset, return_stats and layer_idx.
// The exact mode, over per-row and per-chunk scales, runs on
// palu_decode_exact.cu (wgmma, TMA).
//
// What it computes, per lane b, group g and q-head h of the group (B_h the
// kv-head's rows that h reads):
//   K_h(s) = scale_k(s) * B_h^T (code_k(s) - qoff)  [+ zero_k(s) * rowsum B_h]
//            [+ b_h, the K bias]
//   logit(s) = q_h . RoPE_s(K_h(s)) / sqrt(hd), masked by kv_len and window
//   out_h = sum_s softmax(logit)(s) * (scale_v(s) * (code_v(s) - qoff) [+ zero_v(s)])
// -> (B, nh, rv) in latent space (o_proj is U_v-fused); the int8 modes
// approximate the K dots as below.
//
// The split kernel lives in palu_decode_split.cuh (shared with the
// archived v2 and v3 decodes, palu_decode2.cu and palu_decode3.cu).
//
// Design: grid (splits, G, B), 8 warps, about one block per SM. A block
// walks its tiles of 64 tokens: 16-byte loads bring the packed K and V
// byte rows into shared memory, a per-block table of each rank's byte row
// and shift turns unpacking into lookups and shifts. Each head keeps (m, l)
// and a latent accumulator (rv) in shared memory; the V codes are unpacked
// once per tile per rank into registers and contracted against
// p * scale_v. Blocks past kv_len (or before the window) do no tile work.
// The combine kernel merges the per-split (m, l, acc) with the usual
// rescaling. Nothing allocates here: the wrapper hands in the partials.
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
// fragments of ranks past 128 loaded per k-step): u and v land in one
// thread's accumulators for the same frequency. int8_dots then rotates in
// f32 against the block-relative tables (rcos/rsin); int8_rot rotates in
// int32 against the int8 tables (cos8/sin8) and sums each head in int32.
// Either way the per-token scale multiplies afterwards and the zero
// correction adds zero(s) * sum_e (r1 rcos + r2 rsin), zero = -qoff * scale
// for sym. The wrapper requires block_s % 64 == 0, so a tile never
// straddles two blocks. The K bias adds JAX's cache-independent logit term,
// U_b . rcos(t) + V_b . rsin(t) with U_b = a1 b1 + a2 b2, V_b = a2 b1 - a1 b2,
// formed per rotation block beside the operand and summed per token with
// the zero correction, after the per-token scale. Bound: the int8 dots
// halve the K rebuild's tensor-core time (4.3 us at 8K on the 7B shapes at
// the int8 peak) below the 18.4 MB of codes (5.5 us), so these modes are
// bound by bytes.


#include "palu_decode_split.cuh"

// Shapes in the comments of DecodeArgs; out (B, nh, rv) f32. The partial
// buffers hold B * nh * splits (m, l) and B * nh * splits * rv accumulators.
// hd is 64 or 128, rk a multiple of 32 up to 512, S a multiple of 16 and of
// block_s, block_s a multiple of 64, pack width <= 4; mode 1 (int8_dots)
// or 2 (int8_rot). bk (G, nkv, rk, hd) with nkv dividing hpg: q-head h of a
// group reads kv-head h / (hpg / nkv) (the compact GQA form; nkv = hpg is
// JAX's repeated form). kbias is null or the (G, nkv, hd) f32 pre-RoPE K
// bias. layer selects one layer of (L, B, G, ...) stacked cache buffers (0
// for a single layer's); the kernel offsets every cache plane by it.
// pos_offset is the absolute position of column 0 (a sequence shard's
// start): kv_len stays absolute and c0 / s0 must already start at that
// position. With m_out and l_out (B * nh f32 each) the combine writes the
// raw statistics: out the unnormalised accumulator, m_out the running max,
// l_out the softmax denominator.
extern "C" int palu_decode(const void* q, int q_bf16, const void* bk, const void* kc,
                           const void* ks, const void* kz, const void* vc, const void* vs,
                           const void* vz, const void* kv_len, const void* c0, const void* s0,
                           const void* rcos, const void* rsin, const void* cos8,
                           const void* sin8, const void* kbias, void* part_m, void* part_l,
                           void* part_acc, void* out, int B, int G, int hpg, int nkv, int hd,
                           int rk, int rv, int S, int nrk, int nrv, int pbits, int qoff,
                           int asym, int window, int splits, int tiles_per_split, int mode,
                           int block_s, float sqrt_hd, float i8r_inv, int layer,
                           int pos_offset, void* m_out, void* l_out, void* stream) {
  if ((hd != 64 && hd != 128) || rk % 32 || rk > kMaxRank || hpg > kMaxHeads || nkv <= 0 ||
      hpg % nkv || (mode != 1 && mode != 2) || layer < 0 || pbits > 4 || block_s % kTile ||
      S % block_s || (m_out == nullptr) != (l_out == nullptr))
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
  a.rep = hpg / nkv;
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
  a.layer = layer;
  a.pos_offset = pos_offset;
  return run_split<4>(a, mode, B, hd, static_cast<float*>(out),
                      static_cast<cudaStream_t>(stream), static_cast<float*>(m_out),
                      static_cast<float*>(l_out));
}
