// Latent decode attention over the rank-major packed cache, v3's way of
// bringing RoPE and the scales to the kernel: static block-relative
// tables, a per-block rotation of the query and one packed scale/zero
// array (an A/B baseline with no product call site).
//
// Replaces: palu_tpu/ops/pallas/archive/palu_decode3.py::
// palu_flash_decode3_quantized (body _make_kernel3), per-row affine scales
// and zeros packed as (B, S, 2G) by sz_pack, pack widths 2, 3, 4 and 8.
//
// What it computes: v2's function (ops/archive/palu_decode2.py's module
// docstring: the affine dequantization x = scale * code + zero folded past
// the products), with RoPE(s) = R(s0) R(s - s0) for the rotation block [s0,
// s0 + block_s) that holds s: the query
// (pre-scaled by 1/sqrt(hd) and rounded to its dtype by the wrapper, as
// the TPU wrapper does) is rotated back by s0 with the offset tables
// (c0, s0: cos / sin of each block start, (S / block_s, hd/2) f32), and
// each token's K by s - s0 with the relative tables (rcos, rsin: (block_s,
// hd/2) f32, rope_scale folded into both). Tables are built in float64 and
// rounded to f32 by the wrapper, as the TPU wrapper builds them.
//
// Bound on this card: the function of v4's exact mode over the same codes:
// the K rebuild's 2 * nh * rk * hd flops per token on the bf16 tensor cores
// (68.7 GFLOP at the A/B's 64K x 32 heads, 0.069 ms) above the codes' bytes
// (0.033 ms at 3 bits).
//
// Design: the split pass and combine of palu_decode_split.cuh,
// asym: the rotated query replaces q_s in shared memory when the tile walk
// enters a new rotation block (block_s % 64 == 0, so a 64-token tile never
// straddles two), the relative rows fill the shared-memory rotation rows,
// and each tile's scales and zeros are read with stride 2G.

#include "palu_decode_split.cuh"

// q (B, nh, hd) bf16 or f32, pre-scaled; bk (G, hpg, rk, hd) bf16; kc / vc
// (B, G, nrk / nrv, S) uint8 rank-major codes; ksz / vsz (B, S, 2G) f32
// (scales in columns [0, G), zeros in [G, 2G)); kv_len (B,) int32; c0, s0
// (S / block_s, hd/2) and rcos, rsin (block_s, hd/2) f32. Partials and out
// as palu_decode. hd 64 or 128, rk a multiple of 16 up to 512, pack width
// 2, 3, 4 or 8, block_s a multiple of 64 that divides S.
extern "C" int palu_decode3_quantized(const void* q, int q_bf16, const void* bk, const void* kc,
                                      const void* ksz, const void* vc, const void* vsz,
                                      const void* kv_len, const void* c0, const void* s0,
                                      const void* rcos, const void* rsin, void* part_m,
                                      void* part_l, void* part_acc, void* out, int B, int G,
                                      int hpg, int hd, int rk, int rv, int S, int nrk, int nrv,
                                      int pbits, int window, int splits, int tiles_per_split,
                                      int block_s, void* stream) {
  if ((hd != 64 && hd != 128) || rk % 16 || rk > kMaxRank || hpg > kMaxHeads ||
      (pbits != 2 && pbits != 3 && pbits != 4 && pbits != 8) || block_s <= 0 ||
      block_s % kTile || S % block_s)
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a{};
  a.q = q;
  a.q_bf16 = q_bf16;
  a.bk = static_cast<const __nv_bfloat16*>(bk);
  a.kc = static_cast<const uint8_t*>(kc);
  a.ks = static_cast<const float*>(ksz);
  a.vc = static_cast<const uint8_t*>(vc);
  a.vs = static_cast<const float*>(vsz);
  a.kv_len = static_cast<const int*>(kv_len);
  a.c0 = static_cast<const float*>(c0);
  a.s0 = static_cast<const float*>(s0);
  a.rcos = static_cast<const float*>(rcos);
  a.rsin = static_cast<const float*>(rsin);
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
  a.sqrt_hd = 1.0f;  // the query comes pre-scaled
  a.block_s = block_s;
  return run_split(a, B, hd, static_cast<float*>(out),
                      static_cast<cudaStream_t>(stream));
}
