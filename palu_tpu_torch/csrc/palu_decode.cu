// Latent decode attention over the rank-major packed cache, split over the
// sequence (flash-decoding) with a second kernel that combines the splits.
//
// Replaces: palu_tpu/ops/pallas/palu_decode4.py::palu_flash_decode4_quantized
// (body _make_kernel4, launch _call4), per-row scales, sym and asym.
//
// What it computes, per lane b, group g and q-head h of the group:
//   K_h(s) = scale_k(s) * B_h^T (code_k(s) - qoff)  [+ zero_k(s) * rowsum B_h]
//   logit(s) = q_h . RoPE_s(K_h(s)) / sqrt(hd), masked by kv_len and window
//   out_h = sum_s softmax(logit)(s) * (scale_v(s) * (code_v(s) - qoff) [+ zero_v(s)])
// -> (B, nh, rv) in latent space (o_proj is U_v-fused).
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
// Design: grid (splits, G, B), 8 warps, about one block per SM. A block
// stages the B_h of its group's heads in shared memory once with cp.async
// (in chunks of heads when they do not all fit), then walks its tiles of 64
// tokens: 16-byte loads bring the packed K and V byte rows and the rope
// rows into shared memory, a per-block table of each rank's byte row and
// shift turns unpacking into lookups and shifts, and the K codes are
// unpacked once as a bf16 (rk x 64) tile. Per head, K (64 tokens x hd) =
// codes^T . B_h runs as mma.sync m16n8k16 (bf16 in, f32 accumulate): warp w
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
constexpr int kMaxHeads = 16;  // q-heads per group
constexpr int kMaxKSteps = 8;  // rk / 16, rk <= 128
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
  const float* ks;             // (B, G, S)
  const float* kz;             // (B, G, S) asym only
  const uint8_t* vc;           // (B, G, nrv, S)
  const float* vs;
  const float* vz;
  const int* kv_len;           // (B,)
  const float* cos_t;          // (S, hd/2)
  const float* sin_t;
  float* part_m;               // (B, nh, splits)
  float* part_l;
  float* part_acc;             // (B, nh, splits, rv)
  int G, hpg, rk, rv, S, nrk, nrv, pbits, qoff, asym, window;
  int splits, tiles_per_split, chunk_heads;
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
  size_t bsm, ck, cos, sin, kbytes, vbytes, ktab, vtab, q, rs, acc, lg, pw, red, sk, stat,
      total;
};

__host__ __device__ inline SplitLayout split_layout(int rk, int hd, int hpg, int rv, int nrk,
                                                    int nrv, int asym, int chunk) {
  const size_t rope = sizeof(float) * kTile * (hd / 2 + 1);
  SplitLayout L;
  size_t off = 0;
  L.bsm = off;    off = al(off + sizeof(__nv_bfloat16) * chunk * rk * (hd + kBPad));
  L.ck = off;     off = al(off + sizeof(__nv_bfloat16) * rk * kCk);
  L.cos = off;    off = al(off + rope);
  L.sin = off;    off = al(off + rope);
  L.kbytes = off; off = al(off + static_cast<size_t>(nrk) * kByteStride);
  L.vbytes = off; off = al(off + static_cast<size_t>(nrv) * kByteStride);
  L.ktab = off;   off = al(off + sizeof(uint32_t) * rk);
  L.vtab = off;   off = al(off + sizeof(uint32_t) * rv);
  L.q = off;      off = al(off + sizeof(float) * hpg * hd);
  L.rs = off;     off = al(off + (asym ? sizeof(float) * hpg * hd : 0));
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
  const int hpg = a.hpg, rk = a.rk, rv = a.rv, nks = rk / 16;
  const int nh = a.G * hpg;
  const int m0 = (warp & 3) * 16;    // this warp's 16 tokens of the tile
  const int jw = (warp >> 2) * NTW;  // its first column tile in each half of hd

  extern __shared__ __align__(128) unsigned char smem[];
  const SplitLayout L = split_layout(rk, HD, hpg, rv, a.nrk, a.nrv, a.asym, a.chunk_heads);
  __nv_bfloat16* bsm = reinterpret_cast<__nv_bfloat16*>(smem + L.bsm);  // [chunk][rk][HS]
  __nv_bfloat16* ck = reinterpret_cast<__nv_bfloat16*>(smem + L.ck);    // [rk][kCk]
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
  const float* ksc = a.ks + bg * a.S;
  const float* vsc = a.vs + bg * a.S;
  const float* kzp = a.asym ? a.kz + bg * a.S : nullptr;
  const float* vzp = a.asym ? a.vz + bg * a.S : nullptr;
  const __nv_bfloat16* bk_g = a.bk + static_cast<size_t>(g) * hpg * rk * HD;

  for (int r = tid; r < rk; r += kThreads) ktab[r] = rank_entry(r, rk, a.pbits);
  for (int r = tid; r < rv; r += kThreads) vtab[r] = rank_entry(r, rv, a.pbits);
  for (int i = tid; i < hpg * HD; i += kThreads) {
    const size_t qi = (static_cast<size_t>(b) * nh + g * hpg) * HD + i;
    q_s[i] = a.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[qi])
                      : static_cast<const float*>(a.q)[qi];
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
  const int tile_hi = (min(kvl, a.S) + kTile - 1) / kTile;
  const int t_begin = max(split * a.tiles_per_split, tile_lo);
  const int t_end = min((split + 1) * a.tiles_per_split, tile_hi);

  // heads in chunks whose B fits in shared memory (one chunk when all fit);
  // each chunk walks the block's tiles
  for (int c0 = 0; c0 < hpg && t_begin < t_end; c0 += a.chunk_heads) {
    const int nc = min(a.chunk_heads, hpg - c0);
    __syncthreads();  // set-up done / the previous chunk's B reads done
    for (int i = tid; i < nc * rk * (HD / 8); i += kThreads) {
      const int row = i / (HD / 8), c = i % (HD / 8);  // row = head * rk + rank
      cp_async16(bsm + row * HS + c * 8,
                 bk_g + (static_cast<size_t>(c0) * rk + row) * HD + c * 8);
    }
    cp_async_wait_all();
    __syncthreads();

    for (int tile = t_begin; tile < t_end; ++tile) {
      const int s0 = tile * kTile;
      // ---- load: packed K/V byte tiles, scales, rope rows (vector loads)
      load_byte_tile(kbytes, kc, a.nrk, a.S, s0, tid);
      load_byte_tile(vbytes, vc, a.nrv, a.S, s0, tid);
      if (tid < kTile) {
        const int s = s0 + tid;
        const bool in = s < a.S;
        sk[tid] = in ? ksc[s] : 0.0f;
        sv[tid] = in ? vsc[s] : 0.0f;
        zk[tid] = (in && a.asym) ? kzp[s] : 0.0f;
        zv[tid] = (in && a.asym) ? vzp[s] : 0.0f;
      }
      for (int i = tid; i < kTile * (half / 4); i += kThreads) {
        const int t = i / (half / 4), f = (i % (half / 4)) * 4, s = s0 + t;
        float4 c = make_float4(0.f, 0.f, 0.f, 0.f), n = c;
        if (s < a.S) {
          c = *reinterpret_cast<const float4*>(a.cos_t + static_cast<size_t>(s) * half + f);
          n = *reinterpret_cast<const float4*>(a.sin_t + static_cast<size_t>(s) * half + f);
        }
        float* cd = cos_s + t * cs + f;
        float* sd = sin_s + t * cs + f;
        cd[0] = c.x; cd[1] = c.y; cd[2] = c.z; cd[3] = c.w;
        sd[0] = n.x; sd[1] = n.y; sd[2] = n.z; sd[3] = n.w;
      }
      __syncthreads();
      // K codes -> bf16 (rk x kTile), re-centred for sym; exact in bf16
      for (int i = tid; i < rk * kTile; i += kThreads) {
        const int r = i / kTile, t = i % kTile;
        ck[r * kCk + t] = __float2bfloat16(
            static_cast<float>(unpack_code(kbytes, kByteStride, t, ktab[r], a.pbits) - a.qoff));
      }
      __syncthreads();

      // A fragments: codes^T (16 tokens x 16 ranks) per k-step, shared by
      // the heads; the code tile is stored [rank][token], hence .trans
      uint32_t af[kMaxKSteps][4];
#pragma unroll
      for (int ks = 0; ks < kMaxKSteps; ++ks)
        if (ks < nks)
          ldmatrix_x4_trans(af[ks],
                            ck + (ks * 16 + ri + (mi >> 1) * 8) * kCk + m0 + (mi & 1) * 8);

      // ---- per head: K_h (tokens x hd) = codes^T B_h, then RoPE + q . K
      const int tok_a = m0 + fg, tok_b = tok_a + 8;  // accumulator rows of this lane
      const float sk_a = sk[tok_a], sk_b = sk[tok_b], zk_a = zk[tok_a], zk_b = zk[tok_b];
      for (int hc = 0; hc < nc; ++hc) {
        const int h = c0 + hc;
        const __nv_bfloat16* bh = bsm + static_cast<size_t>(hc) * rk * HS;
        // acc[j]: column tile jw + j (first half of hd); acc[NTW + j]: tile
        // NTH + jw + j, its RoPE partner in the second half
        float acc[2 * NTW][4];
#pragma unroll
        for (int j = 0; j < 2 * NTW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < kMaxKSteps; ++ks) {
          if (ks < nks) {
            const __nv_bfloat16* brow = bh + (ks * 16 + ri + (mi & 1) * 8) * HS + (mi >> 1) * 8;
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
            if (a.asym) {  // rs_b exists only for asym caches
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
          lg[h * kTile + tid] = (r2[tid] + r2[kTile + tid]) / a.sqrt_hd;
        }
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
      split_layout(a.rk, HD, a.hpg, a.rv, a.nrk, a.nrv, a.asym, a.chunk_heads).total;
  cudaError_t err = cudaFuncSetAttribute(palu_decode_split_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  palu_decode_split_kernel<HD><<<dim3(a.splits, a.G, B), kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes in the comments of DecodeArgs; out (B, nh, rv) f32. The partial
// buffers hold B * nh * splits (m, l) and B * nh * splits * rv accumulators.
// hd is 64 or 128, rk a multiple of 16 up to 128, S a multiple of 16.
extern "C" int palu_decode(const void* q, int q_bf16, const void* bk, const void* kc,
                           const void* ks, const void* kz, const void* vc, const void* vs,
                           const void* vz, const void* kv_len, const void* cos_t,
                           const void* sin_t, void* part_m, void* part_l, void* part_acc,
                           void* out, int B, int G, int hpg, int hd, int rk, int rv, int S,
                           int nrk, int nrv, int pbits, int qoff, int asym, int window,
                           int splits, int tiles_per_split, float sqrt_hd, void* stream) {
  if ((hd != 64 && hd != 128) || rk % 16 || rk > 16 * kMaxKSteps || hpg > kMaxHeads)
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a;
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
  // as many heads' B in shared memory as fit beside the rest
  a.chunk_heads = hpg;
  while (a.chunk_heads > 0 &&
         split_layout(rk, hd, hpg, rv, nrk, nrv, asym, a.chunk_heads).total > kSmemMax)
    --a.chunk_heads;
  if (a.chunk_heads == 0) return static_cast<int>(cudaErrorInvalidValue);

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = hd == 128 ? launch_split<128>(a, B, st) : launch_split<64>(a, B, st);
  if (err != 0) return err;
  return decode::launch_combine(a.part_m, a.part_l, a.part_acc, static_cast<float*>(out),
                                B * G * hpg, splits, rv, st);
}
