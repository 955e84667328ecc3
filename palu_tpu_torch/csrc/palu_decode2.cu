// Latent decode attention over the rank-major packed cache, v2's way of
// bringing RoPE to the kernel: cos/sin computed in the kernel from the
// positions (an A/B baseline with no product call site).
//
// Replaces: palu_tpu/ops/pallas/archive/palu_decode2.py::
// palu_flash_decode2_quantized (body _make_kernel2, launch _call2), per-row
// affine scales and zeros, pack widths 2, 3, 4 and 8.
//
// What it computes, per lane b, group g and q-head h of the group (v2's
// fold of the affine dequantization x = scale * code + zero past the
// products):
//   logit(s) = [scale_k(s) q_h . RoPE_s(B_h^T code_k(s))
//               + zero_k(s) q_h . RoPE_s(rowsum B_h)] / sqrt(hd)
//   out_h = sum_s p(s) scale_v(s) code_v(s) + sum_s p(s) zero_v(s)
// with p the softmax of the logits masked by kv_len and the window, and
// RoPE_s at the f32 angle s * inv_freq[j] (inv_freq f32, 1 / theta^(2j/hd)
// or the rope_scaling override), cos and sin times rope_scale.
//
// Bound on this card: the function of v4's exact mode over the same codes,
// so the same bound: the K rebuild's 2 * nh * rk * hd flops per
// token on the bf16 tensor cores (68.7 GFLOP at the A/B's 64K x 32 heads,
// 0.069 ms) above the codes' bytes (0.033 ms at 3 bits).
//
// Design: the split pass and combine of palu_decode_split.cuh (GEN 2),
// asym (the zero rows carry v2's virtual-key term). Each tile computes its
// 64 x hd/2 cos/sin rows with sincosf (full accuracy; the angles reach
// 6.6e4 rad at 64K) into the shared-memory rows that GEN 3 fills from its
// tables; no per-position table is read.

#include "palu_decode_split.cuh"

// q (B, nh, hd) bf16 or f32; bk (G, hpg, rk, hd) bf16; kc / vc (B, G,
// nrk / nrv, S) uint8 rank-major codes; ks, kz, vs, vz (B, G, S) f32;
// kv_len (B,) int32; inv_freq (hd/2,) f32. Partials and out as palu_decode.
// hd 64 or 128, rk a multiple of 16 up to 512, S a multiple of 16, pack
// width 2, 3, 4 or 8.
extern "C" int palu_decode2_quantized(const void* q, int q_bf16, const void* bk, const void* kc,
                                      const void* ks, const void* kz, const void* vc,
                                      const void* vs, const void* vz, const void* kv_len,
                                      const void* inv_freq, void* part_m, void* part_l,
                                      void* part_acc, void* out, int B, int G, int hpg, int hd,
                                      int rk, int rv, int S, int nrk, int nrv, int pbits,
                                      int window, int splits, int tiles_per_split,
                                      float rope_scale, float sqrt_hd, void* stream) {
  if ((hd != 64 && hd != 128) || rk % 16 || rk > kMaxRank || hpg > kMaxHeads || S % 16 ||
      (pbits != 2 && pbits != 3 && pbits != 4 && pbits != 8))
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
  a.inv_freq = static_cast<const float*>(inv_freq);
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
  a.asym = 1;
  a.window = window;
  a.splits = splits;
  a.tiles_per_split = tiles_per_split;
  a.sqrt_hd = sqrt_hd;
  a.rope_scale = rope_scale;
  return run_split<2>(a, B, hd, static_cast<float*>(out),
                      static_cast<cudaStream_t>(stream));
}
