// The archived v2 decode over bf16 latents (palu_decode_fp_v2; replaces
// palu_tpu/ops/pallas/archive/palu_decode2.py::palu_flash_decode2, an A/B
// baseline with no product call site): K seq-major (B, G, S, rk), V
// rank-major (B, G, rv, S), the v2 cache's layouts, on the split kernel
// that served every unquantized and seq-major decode before they moved to
// palu_decode_fp_wg.cu, with a second kernel that combines the splits
// (decode_common.cuh). It stays until the v2 layout moves onto that
// pipeline.
//
// What it computes, per lane b, group g and q-head h of the group:
//   K_h(s) = B_h^T x_k(s)
//   logit(s) = q_h . RoPE_s(K_h(s)) / sqrt(hd), masked by kv_len and window
//   out_h = sum_s softmax(logit)(s) x_v(s)
// -> (B, nh, rv) f32 in latent space (o_proj is U_v-fused). The RoPE angle
// of position s and frequency j is the f32 product s * inv_freq[j]; each
// thread's cos / sin come from sincosf of it (times rope_scale), as the v2
// TPU kernel forms them. No K bias.
//
// Bound on this card: over bf16 latents the bytes do.
//
// Design: Grid (splits, G, B), 8 warps, about one block per SM.
// A block stages the B_h of its group's heads in shared memory once with
// cp.async (in chunks of heads when they do not all fit), then walks its
// tiles of 64 tokens. Each tile of K and V latents comes into shared memory
// with 16-byte cp.async copies in the cache's own layout, so global reads
// stay coalesced: K seq-major as 64 rows of rk ranks (padded by 16 B so
// ldmatrix rows fall on distinct banks), V rank-major as rv rows of 64
// tokens (128 B, padded to 144 B). ldmatrix turns the K tile into the
// mma A operand x^T (16 tokens x 16 ranks) directly. Per head, K (64
// tokens x hd) = x^T . B_h runs as mma.sync m16n8k16 (bf16 in, f32
// accumulate): warp w takes 16 tokens and matching quarters of both halves
// of hd, so both halves of each RoPE pair sit in one thread's
// accumulators; RoPE and the q dot run on them in registers and quad
// shuffles finish each partial logit. Ranks above 128 (up to 512, a G-LRD
// group's rank at group size 4 and hd 128) run in rank chunks of at most
// 128 ranks: the latent tiles hold every rank, the chunk's rows of B stream
// through the B buffer per tile (B of 4 heads at rk 512 is 512 KB), and the
// chunks' partial logits add up in f32 (RoPE and the q dot are linear in
// K). When all of B fits it is staged once per block. Each head keeps (m,
// l) and a latent accumulator (rv) in shared memory; a thread per rank
// reads its 64 V values once per tile and contracts them against p for
// every head. Blocks past kv_len (or before the window) do no tile work.
// Nothing allocates here: the wrapper hands in the partials.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"

namespace {

using decode::al;
using decode::cp_async16;
using decode::cp_async_wait_all;
using decode::kSmemMax;
using decode::ldmatrix_x4;
using decode::ldmatrix_x4_trans;
using decode::mma_bf16;
using decode::warp_max;
using decode::warp_sum;
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;      // tokens per tile
constexpr int kThreads = 256;  // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeads = 32;  // q-heads per group (Qwen2-7B: 28 over one kv group of 4)
constexpr int kMaxKSteps = 8;  // k-steps of one rank chunk held in registers
constexpr int kRc = 16 * kMaxKSteps;  // the largest rank chunk, 128
constexpr int kMaxRank = 512;  // rk limit: a G-LRD group's rank at hd 128, group 4
// padded rows (16 bytes) of the rank-major tiles, the seq-major tiles and
// B, so the eight row addresses of one ldmatrix fall on distinct banks
constexpr int kCk = kTile + 8;
constexpr int kPad = 8;
constexpr int kBPad = 8;

struct FpArgs {
  const void* q;      // (B, nh, hd) bf16 or f32, roped at the current position
  int q_bf16;
  const bf16* bk;     // (G, hpg, rk, hd)
  const bf16* xk;     // (B, G, S, rk) seq-major
  const bf16* xv;     // (B, G, rv, S) rank-major
  const int* kv_len;  // (B,)
  const float* inv_freq;  // (hd/2,) f32 RoPE frequencies
  float* part_m;      // (B, nh, splits)
  float* part_l;
  float* part_acc;    // (B, nh, splits, rv)
  int G, hpg, rk, rv, S, window;
  int splits, tiles_per_split, chunk_heads;
  int rc;             // ranks of B per chunk (rk when one chunk)
  float sqrt_hd;
  float rope_scale;   // multiplies cos and sin
};

// Elements of one latent tile in shared memory (rows padded).
__host__ __device__ inline size_t tile_elems(bool rm, int r) {
  return rm ? static_cast<size_t>(r) * kCk : static_cast<size_t>(kTile) * (r + kPad);
}

// Byte offsets of the split kernel's shared-memory regions (one place for
// the kernel's carve and the launcher's size); `chunk` heads of `rc` rows
// of B staged.
struct FpLayout {
  size_t bsm, kt, vt, q, acc, lg, pw, red, stat, total;
};

__host__ __device__ inline FpLayout fp_layout(bool rmk, bool rmv, int rk, int hd, int hpg,
                                              int rv, int chunk, int rc) {
  FpLayout L;
  size_t off = 0;
  L.bsm = off;  off = al(off + sizeof(bf16) * chunk * rc * (hd + kBPad));
  L.kt = off;   off = al(off + sizeof(bf16) * tile_elems(rmk, rk));
  L.vt = off;   off = al(off + sizeof(bf16) * tile_elems(rmv, rv));
  L.q = off;    off = al(off + sizeof(float) * hpg * hd);
  L.acc = off;  off = al(off + sizeof(float) * hpg * rv);
  L.lg = off;   off = al(off + sizeof(float) * hpg * kTile);
  L.pw = off;   off = al(off + sizeof(float) * hpg * kTile);
  L.red = off;  off = al(off + sizeof(float) * 4 * kTile);
  L.stat = off; off = al(off + sizeof(float) * 3 * kMaxHeads);
  L.total = off;
  return L;
}

// cp.async the latent tile of tokens [s0, s0 + kTile) of one (b, g) plane
// with `rows` ranks into shared memory: rank-major (the V tile) as
// [rank][token] (stride kCk), seq-major (the K tile) as [token][rank]
// (stride rows + kPad). Tokens at
// or past S are zero (S and rows are multiples of 8, so a 16-byte piece is
// wholly in or out).
template <bool RM>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int rows, int S, int s0,
                                          int tid) {
  if (RM) {
    constexpr int kVec = kTile / 8;  // 16-byte pieces per rank row
    for (int i = tid; i < rows * kVec; i += kThreads) {
      const int r = i / kVec, c = i % kVec, s = s0 + c * 8;
      bf16* d = dst + r * kCk + c * 8;
      if (s < S)
        cp_async16(d, src + static_cast<size_t>(r) * S + s);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  } else {
    const int vec = rows / 8;  // 16-byte pieces per token row
    for (int i = tid; i < kTile * vec; i += kThreads) {
      const int t = i / vec, c = i % vec, s = s0 + t;
      bf16* d = dst + t * (rows + kPad) + c * 8;
      if (s < S)
        cp_async16(d, src + static_cast<size_t>(s) * rows + c * 8);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) palu_decode_fp_split_kernel(FpArgs a) {
  constexpr bool RMV = true;  // V tile layout: rank-major
  constexpr int half = HD / 2;
  constexpr int HS = HD + kBPad;  // B row stride
  constexpr int NTH = HD / 16;    // 8-wide column tiles per half of hd
  constexpr int NTW = NTH / 2;    // ... per warp (two warps share 16 tokens)
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int fg = lane / 4, ft = lane % 4;  // mma fragment row group / column pair
  const int mi = lane / 8, ri = lane % 8;  // ldmatrix tile / row of this lane
  const int hpg = a.hpg, rk = a.rk, rv = a.rv;
  const int nh = a.G * hpg;
  const int m0 = (warp & 3) * 16;    // this warp's 16 tokens of the tile
  const int jw = (warp >> 2) * NTW;  // its first column tile in each half of hd
  const int kstride = rk + kPad;  // K tile row stride (elements)

  extern __shared__ __align__(128) unsigned char smem[];
  const FpLayout L = fp_layout(false, RMV, rk, HD, hpg, rv, a.chunk_heads, a.rc);
  const int rc = a.rc, nrc = (rk + rc - 1) / rc;          // rank chunks of B
  bf16* bsm = reinterpret_cast<bf16*>(smem + L.bsm);     // [chunk][rc][HS]
  bf16* kt = reinterpret_cast<bf16*>(smem + L.kt);       // K latent tile
  bf16* vt = reinterpret_cast<bf16*>(smem + L.vt);       // V latent tile
  float* q_s = reinterpret_cast<float*>(smem + L.q);     // [hpg][hd]
  float* acc_s = reinterpret_cast<float*>(smem + L.acc); // [hpg][rv]
  float* lg = reinterpret_cast<float*>(smem + L.lg);     // [hpg][kTile] logits
  float* pw = reinterpret_cast<float*>(smem + L.pw);     // [hpg][kTile] p
  float* red = reinterpret_cast<float*>(smem + L.red);   // [head parity][warp half][kTile]
  float* stat = reinterpret_cast<float*>(smem + L.stat); // [3][kMaxHeads]: m, l, alpha
  float* m_s = stat;
  float* l_s = stat + kMaxHeads;
  float* alpha_s = stat + 2 * kMaxHeads;

  const size_t bg = static_cast<size_t>(b) * a.G + g;
  const bf16* xk = a.xk + bg * rk * a.S;
  const bf16* xv = a.xv + bg * rv * a.S;
  const bf16* bk_g = a.bk + static_cast<size_t>(g) * hpg * rk * HD;

  for (int i = tid; i < hpg * HD; i += kThreads) {
    const size_t qi = (static_cast<size_t>(b) * nh + g * hpg) * HD + i;
    q_s[i] = a.q_bf16 ? __bfloat162float(static_cast<const bf16*>(a.q)[qi])
                      : static_cast<const float*>(a.q)[qi];
  }
  for (int i = tid; i < hpg * rv; i += kThreads) acc_s[i] = 0.0f;
  if (tid < kMaxHeads) {
    m_s[tid] = -1e30f;
    l_s[tid] = 0.0f;
    alpha_s[tid] = 1.0f;
  }

  const int kvl = a.kv_len[b];
  const int lo_pos = a.window > 0 ? max(0, kvl - a.window) : 0;
  const int tile_lo = lo_pos / kTile;
  const int tile_hi = (max(0, min(kvl, a.S)) + kTile - 1) / kTile;
  const int t_begin = max(split * a.tiles_per_split, tile_lo);
  const int t_end = min((split + 1) * a.tiles_per_split, tile_hi);
  const int tok_a = m0 + fg, tok_b = tok_a + 8;  // accumulator rows of this lane

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

    for (int tile = t_begin; tile < t_end; ++tile) {
      const int s0 = tile * kTile;
      // ---- load: K and V latent tiles (cp.async), this thread's rope rows
      load_tile<false>(kt, xk, rk, a.S, s0, tid);
      load_tile<RMV>(vt, xv, rv, a.S, s0, tid);
      // sincosf of the f32 angle, times rope_scale
      float ca[NTW][2], sa[NTW][2], cb[NTW][2], sb[NTW][2];
      const int pa = s0 + tok_a, pb = s0 + tok_b;
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int d = (jw + j) * 8 + 2 * ft;
        const float2 f = *reinterpret_cast<const float2*>(a.inv_freq + d);
        const float fr[2] = {f.x, f.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sincosf(static_cast<float>(pa) * fr[e], &sa[j][e], &ca[j][e]);
          sincosf(static_cast<float>(pb) * fr[e], &sb[j][e], &cb[j][e]);
          ca[j][e] *= a.rope_scale;
          sa[j][e] *= a.rope_scale;
          cb[j][e] *= a.rope_scale;
          sb[j][e] *= a.rope_scale;
        }
      }
      cp_async_wait_all();
      __syncthreads();

      for (int ci = 0; ci < nrc; ++ci) {
        // ---- rank chunk ci: ranks [r0, r0 + nr)
        const int r0 = ci * rc, nr = min(rc, rk - r0), nkc = nr / 16;
        if (nrc > 1) {  // stream this chunk's rows of B for the chunk's heads
          if (ci > 0) __syncthreads();  // the previous chunk's reads of B done
          const int per_head = nr * (HD / 8);
          for (int i = tid; i < nc * per_head; i += kThreads) {
            const int hh = i / per_head, row = (i % per_head) / (HD / 8), c = i % (HD / 8);
            cp_async16(bsm + (hh * rc + row) * HS + c * 8,
                       bk_g + (static_cast<size_t>(c0 + hh) * rk + r0 + row) * HD + c * 8);
          }
          cp_async_wait_all();
          __syncthreads();
        }

        // A fragments: x_k^T (16 tokens x 16 ranks) per k-step, shared by the
        // heads
        uint32_t af[kMaxKSteps][4];
#pragma unroll
        for (int ks = 0; ks < kMaxKSteps; ++ks) {
          if (ks < nkc) {
            const int rr = r0 + ks * 16;
            ldmatrix_x4(af[ks], kt + (m0 + ri + (mi & 1) * 8) * kstride + rr + (mi >> 1) * 8);
          }
        }

        // ---- per head: K_h (tokens x hd) = x_k^T B_h, then RoPE + q . K
        for (int hc = 0; hc < nc; ++hc) {
          const int h = c0 + hc;
          const bf16* bh = bsm + static_cast<size_t>(hc) * rc * HS;
          // acc[j]: column tile jw + j (first half of hd); acc[NTW + j]: tile
          // NTH + jw + j, its RoPE partner in the second half
          float acc[2 * NTW][4];
#pragma unroll
          for (int j = 0; j < 2 * NTW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
          for (int ks = 0; ks < kMaxKSteps; ++ks) {
            if (ks < nkc) {
              const bf16* brow = bh + (ks * 16 + ri + (mi & 1) * 8) * HS + (mi >> 1) * 8;
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
          float part_a = 0.0f, part_b = 0.0f;
#pragma unroll
          for (int j = 0; j < NTW; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int d = (jw + j) * 8 + 2 * ft + e;
              const float q1 = qh[d], q2 = qh[d + half];
              const float k1 = acc[j][e], k2 = acc[NTW + j][e];
              const float l1 = acc[j][e + 2], l2 = acc[NTW + j][e + 2];
              part_a += q1 * (k1 * ca[j][e] - k2 * sa[j][e]) + q2 * (k2 * ca[j][e] + k1 * sa[j][e]);
              part_b += q1 * (l1 * cb[j][e] - l2 * sb[j][e]) + q2 * (l2 * cb[j][e] + l1 * sb[j][e]);
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
        float sum = 0.0f;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int t = lane + 32 * u;
          e[u] = ok[u] ? expf(x[u] - m_new) : 0.0f;
          sum += e[u];
          pw[h * kTile + t] = e[u];
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          m_s[h] = m_new;
          l_s[h] = l_s[h] * alpha + sum;
          alpha_s[h] = alpha;
        }
      }
      __syncthreads();

      // ---- latent V: acc[h][r] = acc * alpha + sum_t p[h][t] x_v[t][r]
      for (int r = tid; r < rv; r += kThreads) {
        float cv[kTile];
        const uint4* row = reinterpret_cast<const uint4*>(vt + r * kCk);
#pragma unroll
        for (int c = 0; c < kTile / 8; ++c) {
          const uint4 u = row[c];
          const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 f = __bfloat1622float2(p2[k]);
            cv[c * 8 + 2 * k] = f.x;
            cv[c * 8 + 2 * k + 1] = f.y;
          }
        }
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
    a.part_acc[((head0 + h) * a.splits + split) * rv + r] = acc_s[i];
  }
  if (tid < hpg) {
    a.part_m[(head0 + tid) * a.splits + split] = m_s[tid];
    a.part_l[(head0 + tid) * a.splits + split] = l_s[tid];
  }
}

template <int HD>
int launch_split(const FpArgs& a, int B, cudaStream_t st) {
  const size_t smem = fp_layout(false, true, a.rk, HD, a.hpg, a.rv, a.chunk_heads, a.rc).total;
  cudaError_t err =
      cudaFuncSetAttribute(palu_decode_fp_split_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  palu_decode_fp_split_kernel<HD><<<dim3(a.splits, a.G, B), kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Heads of B that fit in shared memory beside the rest, and the rank chunk
// (a.rc): up to 128 ranks, fewer when not even one head's 128 rows fit;
// a.chunk_heads is 0 when nothing fits.
void fit_heads(FpArgs& a, bool rmk, bool rmv, int hd) {
  const int rcs[4] = {min(a.rk, kRc), 64, 32, 16};
  a.chunk_heads = 0;
  for (int k = 0; k < 4 && a.chunk_heads == 0; ++k) {
    if (k > 0 && rcs[k] >= rcs[0]) continue;
    a.rc = rcs[k];
    a.chunk_heads = a.hpg;
    while (a.chunk_heads > 0 &&
           fp_layout(rmk, rmv, a.rk, hd, a.hpg, a.rv, a.chunk_heads, a.rc).total >
               kSmemMax)
      --a.chunk_heads;
  }
}

}  // namespace

// The archived v2 decode over bf16 latents: x_k (B, G, S, rk) seq-major,
// x_v_t (B, G, rv, S) rank-major; inv_freq (hd/2,) f32, the RoPE angle of
// position s and frequency j is the f32 product s * inv_freq[j], cos and
// sin times rope_scale. Otherwise as palu_decode_fp (hd 64 or 128, rk a
// multiple of 16 up to 512, rv and S multiples of 8; no K bias).
extern "C" int palu_decode_fp_v2(const void* q, int q_bf16, const void* bk, const void* xk,
                                 const void* xv_t, const void* kv_len, const void* inv_freq,
                                 void* part_m, void* part_l, void* part_acc, void* out, int B,
                                 int G, int hpg, int hd, int rk, int rv, int S, int window,
                                 int splits, int tiles_per_split, float rope_scale,
                                 float sqrt_hd, void* stream) {
  if ((hd != 64 && hd != 128) || rk % 16 || rk > kMaxRank || rv % 8 || S % 8 ||
      hpg > kMaxHeads)
    return static_cast<int>(cudaErrorInvalidValue);
  FpArgs a{};
  a.q = q;
  a.q_bf16 = q_bf16;
  a.bk = static_cast<const bf16*>(bk);
  a.xk = static_cast<const bf16*>(xk);
  a.xv = static_cast<const bf16*>(xv_t);
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
  a.window = window;
  a.splits = splits;
  a.tiles_per_split = tiles_per_split;
  a.sqrt_hd = sqrt_hd;
  a.rope_scale = rope_scale;
  fit_heads(a, false, true, hd);
  if (a.chunk_heads == 0) return static_cast<int>(cudaErrorInvalidValue);

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = hd == 128 ? launch_split<128>(a, B, st) : launch_split<64>(a, B, st);
  if (err != 0) return err;
  return decode::launch_combine(a.part_m, a.part_l, a.part_acc, static_cast<float*>(out),
                                B * G * hpg, splits, rv, st);
}
