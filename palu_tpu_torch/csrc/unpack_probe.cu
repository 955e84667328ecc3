// What sub-byte extraction costs: the latent cache's packed codes streamed
// with extraction, with and without the products that follow it.
//
// Replaces: tools/tpu_unpack_probe.py::_mk (the Pallas grid) with the
// variant bodies of its `make`: base, ext4nc, ext4cc, ext4mm, ext4ccmm,
// ext3nc, ext3cc, conv8. Codes are rank-major (G, rows, S) uint8, as the
// packed cache keeps them: 4-bit, byte row i holds rank i in its low nibble
// and rank rows + i in its high one (unpack4_parts); 3-bit, three bit
// planes of rank / 8 rows each, and bit k of planes 0 / 1 / 2 at row i form
// the code of rank k * (rank / 8) + i (unpack3_parts); conv8 reads int8
// codes (G, rank, S).
//
// The nc / cc split on this card, as the production packed decodes made it.
// On the TPU, "cc" concatenates the parts sublane-wise (a relayout) and
// "nc" consumes each part as it comes. Here `nc` consumes each extracted
// part in registers, and `cc` assembles it as bf16 in shared memory in the
// 128-byte swizzle for the tensor cores to read, as the seq-major packed
// decode's producer writes its chunks (palu_decode_fp_wg.cu): rank-major
// boxes of 64 ranks x 64 tokens (8 KB; rows of one rank, the layout the
// codes come in, so nothing is transposed), each 16-byte store one rank's 8
// tokens. A code c reaches bf16 by a byte permute (bf16 0x4300 | c is 128 +
// c) and one bf16x2 subtraction of 128, exact.
//  - base folds each 16-byte piece of codes (the XOR of its words) into an
//    exact 64-bit checksum;
//  - ext4nc / ext3nc / conv8 convert every value of each piece in registers
//    and add them: 4- and 3-bit values as bf16 pairs (bf16x2 additions,
//    exact: at most 16 values of <= 15 a lane before each f32 flush), int8
//    values through f32 (2^23 + (c + 128) built by a byte permute, less
//    2^23 + 128);
//  - ext4cc / ext3cc assemble the boxes and read each back: after a warp's
//    barrier each lane loads the units its neighbour lane wrote and adds
//    them as bf16x2 (flushed to f32 per box);
//  - ext4mm (nc): the K product x^T (64 tokens x 16 ranks) . B (16 ranks x
//    W, W <= 64 padded to 64 with zero columns) on wgmma m64n64k16 with A
//    from registers, its fragments unpacked from the stage's bytes as the
//    exact decode's K warpgroup builds them (palu_decode_exact.cu:
//    k_fragments4), 8 steps a group; the V product x (64 ranks x 16 tokens)
//    . p (16 tokens x 8) on wgmma m64n8k16, A from registers (each thread's
//    16-bit pairs taken as tokens (4q, 4q + 2) and (4q + 1, 4q + 3) of one
//    32-bit load, p stored in that order), a group a 16-token step with
//    each 64-rank block in its own accumulator (rv <= 512), p^T in shared
//    memory;
//  - ext4ccmm (cc): the same products on SS wgmma, A read from the
//    assembled boxes (K: M-major x^T; V: K-major x; the K box's ranks in the
//    order the assembly writes them, B's rows in the same order).
// Each integer variant's total is exact, whatever the order (one int64,
// added to with atomicAdd by each warp after an 8-byte memset); each mm
// variant writes each (group, block) sum of its products, K and V apart,
// from the one block that walks it (ext4ccmm's V products of every 64-rank
// block accumulate into one m64n8 accumulator: their sum is what is
// reported).
//
// Bound on this card: bytes. At the tool's shape (G 8, rk 128, rv 384, S
// 64K) the 4-bit codes are 134 MB (0.040 ms at 3.35 TB/s), the 3-bit 101
// MB (0.030 ms), the int8 codes 268 MB (0.080 ms); the mm variants' 11.8
// GFLOP take 0.012 ms on the bf16 tensor cores. At the byte bound an SM
// takes ~14 bytes of codes a cycle: ~29 values a cycle at 4 bits. The cc
// variants' shared-memory round trip (2 bytes written and read per value,
// plus the codes written by TMA and read: ~5 bytes a value) then needs ~145
// of the SM's 128 bytes a cycle: they are shared-memory bound, ~10-20 %
// past the byte bound.
//
// Design: one wave. Work items are (group, BS-token block), N = G * S / BS
// of them; block b of the grid (min(N, SMs) blocks) walks items [b N /
// grid, (b + 1) N / grid) in order, each in BS / 128 tiles, so every (group,
// block) is written by exactly one block. A block is 9 warps:
//  - warp 8, the producer: one thread keeps an mbarrier ring of ns stages
//    full by TMA (cp.async.bulk.tensor, 128-byte swizzle), a stage one
//    128-token tile of the item's group, its K then its V codes (4-bit at
//    the tool's shape: 64 + 192 rows x 128 bytes, 32 KB), each side as
//    boxes of at most 256 rows (conv8's 384 V rows: two of 192), and for
//    the mm variants the tile's 128 rows of p by a bulk copy (2 KB), every
//    box counted on the stage's barrier;
//  - warps 0-7, the consumers (two warpgroups): base and the nc sums take
//    the stage's 16-byte pieces in turn over all 256 threads; the cc and mm
//    variants give warpgroup h the tile's tokens [64 h, 64 h + 64): its
//    four warps unpack (every thread, into its boxes or its fragments) and
//    the same warpgroup runs the products on them (ext4ccmm: a wgmma group
//    a box; ext4mm: a group of 8 16-rank K steps, then one a 16-token V
//    step); every consumer thread frees a stage after its last read of it.
// Every unpack is branch-free (a row past a side is read from row 0 and
// zeroed): a guard around each load compiled to a branch around it, and no
// two loads overlapped.
// Shared memory (227 KB): the ring, then (mm) B (64-column rows, 16 KB at
// rk 128) and two 1 KB p^T buffers a warpgroup, (cc) the assembled boxes
// (two 8 KB buffers a warpgroup, three with products: a buffer is refilled
// only after every warp passed a barrier behind its product's wait), the
// reduction rows and the barriers. At the tool's shape (W 64) the ring
// holds 7 stages of 32 KB for base / ext4nc, 6 beside ext4cc's boxes, 6 of
// 34 KB (with p's rows) beside ext4mm's B and p^T, 4 beside all three for
// ext4ccmm, 8 of 24 KB at 3 bits (the most a plan takes), 3 of 64 KB for
// conv8.
// palu_tpu_torch/tools/unpack_probe.py (unpack_plan, unpack_items) mirrors
// the plan and the item walk.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kT = 128;                       // tokens per tile (a stage)
constexpr int kWG = 128;                      // threads per consumer warpgroup
constexpr int kConsumers = 2 * kWG;
constexpr int kThreads = kConsumers + 32;     // + the producer warp
constexpr int kBoxBytes = 64 * 128;           // an assembled box: 64 ranks x 64 tokens bf16
constexpr int kMaxStages = 8;
constexpr int kSmemBudget = static_cast<int>(decode::kSmemMax) - 1024;  // - alignment slack
constexpr uint32_t kBf128 = 0x43004300u;      // bf16 pair (128, 128)

enum Var { kBase, kExt4Nc, kExt4Cc, kExt4Mm, kExt4CcMm, kExt3Nc, kExt3Cc, kConv8 };

__host__ __device__ constexpr bool is_cc(int v) {
  return v == kExt4Cc || v == kExt4CcMm || v == kExt3Cc;
}
__host__ __device__ constexpr bool is_mm(int v) { return v == kExt4Mm || v == kExt4CcMm; }
__host__ __device__ constexpr bool is_four(int v) { return v <= kExt4CcMm; }

inline uint32_t up(uint32_t x, uint32_t a) { return (x + a - 1) / a * a; }

// The shared-memory plan: each side's code rows (rows), TMA boxes of br
// rows (nbox of them, br a multiple of 8 when more than one), the stage
// (each side 1024-aligned; the mm variants' stage also holds the tile's 128
// rows of p, 2 KB), the cc boxes a warpgroup assembles per side
// (ccb), B's rows (mm), then the offsets and the ring depth ns (the most
// stages up to 8 that fit, at least 2; ok 0 when 2 do not).
struct Plan {
  int ok, ns, rows_k, rows_v, br_k, nbox_k, br_v, nbox_v, ccb_k, ccb_v, b_rows;
  uint32_t side_v, side_p, stage, load_bytes, b, pt, asm_, red, bars, total;
};

int code_rows(int var, int r) { return is_four(var) ? r / 2 : var == kConv8 ? r : 3 * r / 8; }

void boxes(int rows, int* br, int* nbox) {
  *nbox = (rows + 255) / 256;
  *br = *nbox == 1 ? rows : ((rows + *nbox - 1) / *nbox + 7) / 8 * 8;
}

// assembled boxes of one side: 4-bit, 32 byte rows (both nibbles) a box;
// 3-bit, 8 plane rows (all eight parts) a box
int cc_boxes(int var, int r) {
  if (!is_cc(var)) return 0;
  return var == kExt3Cc ? (r / 8 + 7) / 8 : (r / 2 + 31) / 32;
}

Plan make_plan(int var, int rk, int rv) {
  Plan p{};
  p.rows_k = code_rows(var, rk), p.rows_v = code_rows(var, rv);
  boxes(p.rows_k, &p.br_k, &p.nbox_k);
  boxes(p.rows_v, &p.br_v, &p.nbox_v);
  p.ccb_k = cc_boxes(var, rk), p.ccb_v = cc_boxes(var, rv);
  p.b_rows = var == kExt4Mm ? (rk + 127) / 128 * 128 : var == kExt4CcMm ? 64 * p.ccb_k : 0;
  p.side_v = up(p.nbox_k * p.br_k * 128, 1024);
  p.side_p = p.side_v + up(p.nbox_v * p.br_v * 128, 1024);
  p.stage = p.side_p + (is_mm(var) ? kT * 8 * 2 : 0);  // mm: the tile's rows of p
  p.load_bytes = (p.nbox_k * p.br_k + p.nbox_v * p.br_v) * 128 + (is_mm(var) ? kT * 8 * 2 : 0);
  const uint32_t nbuf = is_cc(var) ? (is_mm(var) ? 3 : 2) : 0;
  for (int ns = kMaxStages; ns >= 2; --ns) {
    uint32_t o = ns * p.stage;
    p.b = o; o = up(o + p.b_rows * 128, 1024);
    p.pt = o; o += is_mm(var) ? 2 * 2 * 1024 : 0;
    p.asm_ = o; o += 2 * nbuf * kBoxBytes;
    p.red = o; o += is_mm(var) ? 2 * 8 * 2 * 4 : 0;
    p.bars = up(o, 8);
    p.total = p.bars + 2 * 8 * ns;
    if (p.total <= static_cast<uint32_t>(kSmemBudget)) {
      p.ok = 1, p.ns = ns;
      return p;
    }
  }
  p.ok = 0;
  return p;
}

struct UpArgs {
  const bf16* b1;        // (G, rk, W), mm variants
  const bf16* p;         // (G, BS, 8), mm variants
  float* part_f;         // (2, G, S / BS) K and V product sums, mm variants
  unsigned long long* total;  // the integer total (zeroed before the launch)
  int G, rk, rv, W, BS, nblk, n_items;
  Plan L;
};

// byte offset of byte `col` of code row `row` in a 128-byte-swizzled side
__device__ __forceinline__ uint32_t code_at(int row, int col) {
  return row * 128 + ((((col >> 4) ^ row) & 7) << 4) + (col & 15);
}

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// bf16 pairs of bytes 0, 1 (sel 0x4140) or 2, 3 (0x4342) of x, each a code
// c <= 127: 128 + c, less 128
__device__ __forceinline__ uint32_t bf_pair(uint32_t x, uint32_t sel) {
  return as_u32(__hsub2(as_bf2(__byte_perm(x, 0x43434343u, sel)), as_bf2(kBf128)));
}

// bf16 pair of the codes in the low nibbles of bytes 0 and 2 of x
__device__ __forceinline__ uint32_t bf_nib02(uint32_t x) {
  return as_u32(__hsub2(as_bf2((x & 0x000F000Fu) | kBf128), as_bf2(kBf128)));
}

__device__ __forceinline__ uint32_t hadd(uint32_t a, uint32_t b) {
  return as_u32(__hadd2(as_bf2(a), as_bf2(b)));
}

__device__ __forceinline__ float flush(uint32_t a) {
  const float2 f = __bfloat1622float2(as_bf2(a));
  return f.x + f.y;
}

// 3-bit code k of the four bytes: bit k of planes 0, 1, 2 as bits 0, 1, 2
__device__ __forceinline__ uint32_t code3(uint32_t w0, uint32_t w1, uint32_t w2, int k) {
  return ((w0 >> k) & 0x01010101u) | (((w1 >> k) & 0x01010101u) << 1) |
         (((w2 >> k) & 0x01010101u) << 2);
}

__device__ __forceinline__ uint4 lds128(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// ---- the consumers' bodies over the whole stage (256 threads)

// base: the checksum of one side's pieces
__device__ __forceinline__ unsigned long long fold_side(const uint8_t* side, int rows, int tid) {
  unsigned long long ck = 0;
  for (int i = tid; i < rows * 8; i += kConsumers) {
    const uint4 q = lds128(side + i * 16);
    ck += q.x ^ q.y ^ q.z ^ q.w;
  }
  return ck;
}

// ext4nc: every nibble of one side as bf16, added in pairs
__device__ __forceinline__ float ext4_side(const uint8_t* side, int rows, int tid) {
  float s = 0.0f;
  for (int i = tid; i < rows * 8; i += kConsumers) {
    const uint4 q = lds128(side + i * 16);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
    uint32_t acc[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t lo = w[j] & 0x0F0F0F0Fu, hi = (w[j] >> 4) & 0x0F0F0F0Fu;
      acc[0] = hadd(acc[0], bf_pair(lo, 0x4140));
      acc[1] = hadd(acc[1], bf_pair(lo, 0x4342));
      acc[0] = hadd(acc[0], bf_pair(hi, 0x4140));
      acc[1] = hadd(acc[1], bf_pair(hi, 0x4342));
    }
    s += flush(acc[0]) + flush(acc[1]);
  }
  return s;
}

// ext3nc: the eight parts of each (plane row, 16 tokens) of one side
__device__ __forceinline__ float ext3_side(const uint8_t* side, int rank, int tid) {
  const int w1 = rank / 8;
  float s = 0.0f;
  for (int i = tid; i < w1 * 8; i += kConsumers) {
    const int row = i >> 3, col = (i & 7) << 4;
    const uint4 a = lds128(side + code_at(row, col)), b = lds128(side + code_at(row + w1, col)),
                c = lds128(side + code_at(row + 2 * w1, col));
    const uint32_t p0[4] = {a.x, a.y, a.z, a.w}, p1[4] = {b.x, b.y, b.z, b.w},
                   p2[4] = {c.x, c.y, c.z, c.w};
    uint32_t acc[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t x = code3(p0[j], p1[j], p2[j], k);
        acc[(k & 1) * 2] = hadd(acc[(k & 1) * 2], bf_pair(x, 0x4140));
        acc[(k & 1) * 2 + 1] = hadd(acc[(k & 1) * 2 + 1], bf_pair(x, 0x4342));
      }
    s += flush(acc[0]) + flush(acc[1]) + flush(acc[2]) + flush(acc[3]);
  }
  return s;
}

// conv8: every int8 value of one side through f32
__device__ __forceinline__ float conv8_side(const uint8_t* side, int rows, int tid) {
  constexpr float kOff = 8388736.0f;  // 2^23 + 128
  float s0 = 0.0f, s1 = 0.0f;
  for (int i = tid; i < rows * 8; i += kConsumers) {
    const uint4 q = lds128(side + i * 16);
    const uint32_t w[4] = {q.x ^ 0x80808080u, q.y ^ 0x80808080u, q.z ^ 0x80808080u,
                           q.w ^ 0x80808080u};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s0 += __uint_as_float(__byte_perm(w[j], 0x4B000000u, 0x7540)) - kOff;
      s1 += __uint_as_float(__byte_perm(w[j], 0x4B000000u, 0x7541)) - kOff;
      s0 += __uint_as_float(__byte_perm(w[j], 0x4B000000u, 0x7542)) - kOff;
      s1 += __uint_as_float(__byte_perm(w[j], 0x4B000000u, 0x7543)) - kOff;
    }
  }
  return s0 + s1;
}

// ---- the cc boxes (a warpgroup, its 64 tokens [64 h, 64 h + 64))

// 4-bit box b of a side (half = rank / 2 byte rows): byte rows [32 b, 32 b
// + 32); box row i holds the low nibbles (rank 32 b + i), row 32 + i the
// high ones (rank half + 32 b + i); rows of byte rows past half are zeros.
// Thread wt writes two (row, 8-token) units of each nibble.
__device__ __forceinline__ void box4(uint32_t dst, const uint8_t* side, int half, int b, int h,
                                     int wt) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int c = wt + kWG * n, j = c & 7;
    // byte rows i and i + 4 a half-warp: their swizzles take other banks
    const int i = ((c >> 3) & 1) * 4 + ((c >> 4) & 3) + ((c >> 6) << 3);
    const int row = 32 * b + i;
    const bool ok = row < half;  // branch-free: past half, row 0 is loaded and zeroed
    uint2 w = *reinterpret_cast<const uint2*>(side + code_at(ok ? row : 0, 64 * h + 8 * j));
    w.x = ok ? w.x : 0u, w.y = ok ? w.y : 0u;
    const uint32_t l0 = w.x & 0x0F0F0F0Fu, l1 = w.y & 0x0F0F0F0Fu;
    const uint32_t h0 = (w.x >> 4) & 0x0F0F0F0Fu, h1 = (w.y >> 4) & 0x0F0F0F0Fu;
    const uint4 lo = make_uint4(bf_pair(l0, 0x4140), bf_pair(l0, 0x4342), bf_pair(l1, 0x4140),
                                bf_pair(l1, 0x4342));
    const uint4 hi = make_uint4(bf_pair(h0, 0x4140), bf_pair(h0, 0x4342), bf_pair(h1, 0x4140),
                                bf_pair(h1, 0x4342));
    const uint32_t off = ((j ^ i) & 7) << 4;  // rows i and 32 + i: the same swizzle
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(dst + i * 128 + off),
                 "r"(lo.x), "r"(lo.y), "r"(lo.z), "r"(lo.w) : "memory");
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(dst + (32 + i) * 128 + off),
                 "r"(hi.x), "r"(hi.y), "r"(hi.z), "r"(hi.w) : "memory");
  }
}

// 3-bit box b of a side (w1 = rank / 8 plane rows): plane rows [8 b, 8 b +
// 8); box row 8 i + k holds part k of plane row 8 b + i (rank k w1 + 8 b +
// i); rows of plane rows past w1 are zeros. Thread wt: plane row i, tokens
// 4 q .. 4 q + 3 of every part.
__device__ __forceinline__ void box3(uint32_t dst, const uint8_t* side, int w1, int b, int h,
                                     int wt) {
  const int q = wt & 15, i = (wt >> 5) + 4 * ((wt >> 4) & 1);
  const int row = 8 * b + i, col = 64 * h + 4 * q;
  const bool ok = row < w1;  // branch-free: past w1, row 0 is loaded and zeroed
  const int rw = ok ? row : 0;
  uint32_t w0 = *reinterpret_cast<const uint32_t*>(side + code_at(rw, col));
  uint32_t w1v = *reinterpret_cast<const uint32_t*>(side + code_at(rw + w1, col));
  uint32_t w2 = *reinterpret_cast<const uint32_t*>(side + code_at(rw + 2 * w1, col));
  w0 = ok ? w0 : 0u, w1v = ok ? w1v : 0u, w2 = ok ? w2 : 0u;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t x = code3(w0, w1v, w2, k);
    const uint32_t a = bf_pair(x, 0x4140), c = bf_pair(x, 0x4342);
    const uint32_t d = dst + (8 * i + k) * 128 + ((((q >> 1) ^ k) & 7) << 4) + (q & 1) * 8;
    asm volatile("st.shared.v2.u32 [%0], {%1, %2};" ::"r"(d), "r"(a), "r"(c) : "memory");
  }
}

// ext4cc's read-back: the sum of the four 16-byte units thread wt ^ 1 (a
// lane of this warp) wrote into the box (box4's map)
__device__ __forceinline__ float box4_back(const uint8_t* box, int wt) {
  uint32_t acc[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int c = (wt ^ 1) + kWG * n, j = c & 7;
    const int i = ((c >> 3) & 1) * 4 + ((c >> 4) & 3) + ((c >> 6) << 3);
    const int off = ((j ^ i) & 7) << 4;
    const uint4 u = lds128(box + i * 128 + off), v = lds128(box + (32 + i) * 128 + off);
    acc[0] = hadd(acc[0], hadd(u.x, v.x)), acc[1] = hadd(acc[1], hadd(u.y, v.y));
    acc[2] = hadd(acc[2], hadd(u.z, v.z)), acc[3] = hadd(acc[3], hadd(u.w, v.w));
  }
  return flush(acc[0]) + flush(acc[1]) + flush(acc[2]) + flush(acc[3]);
}

// ext3cc's read-back: the eight 8-byte halves thread wt ^ 1 wrote (box3's map)
__device__ __forceinline__ float box3_back(const uint8_t* box, int wt) {
  const int o = wt ^ 1, q = o & 15, i = (o >> 5) + 4 * ((o >> 4) & 1);
  uint32_t acc[2] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint2 u = *reinterpret_cast<const uint2*>(
        box + (8 * i + k) * 128 + ((((q >> 1) ^ k) & 7) << 4) + (q & 1) * 8);
    acc[0] = hadd(acc[0], u.x), acc[1] = hadd(acc[1], u.y);
  }
  return flush(acc[0]) + flush(acc[1]);
}

// ---- products

// d (64 x 64) += A (64 tokens x 16 ranks, M-major in shared memory) . B (16
// ranks x 64, MN-major)
__device__ __forceinline__ void wgmma_k_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, 1, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

// d (64 ranks x 8) += A (64 ranks x 16 tokens, K-major in shared memory) .
// B (16 tokens x 8, K-major: p^T)
__device__ __forceinline__ void wgmma_v_ss(float (&d)[4], uint64_t da, uint64_t db) {
  asm volatile("wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, "
               "1, 1, 1, 0, 0;\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "l"(da), "l"(db));
}

// the same with A (64 ranks x 16 tokens) in registers
__device__ __forceinline__ void wgmma_v_rs(float (&d)[4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile("wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, "
               "{%4, %5, %6, %7}, %8, 1, 1, 1, 0;\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// ext4mm's K fragments of 16-rank step kk (x^T, 64 tokens x 16 ranks, as
// palu_decode_exact.cu::k_fragments4): this thread's rows are tokens ta and
// ta + 1 (a 16-bit load each rank), its columns ranks 16 kk + 2 q + {0, 1,
// 8, 9}; zeros past rk. Branch-free (a rank past rk loads rank 0's row and
// is zeroed after): a guard per load kept the loads from overlapping.
__device__ __forceinline__ void k_frag(uint32_t (&af)[4], const uint8_t* side, int rk, int kk,
                                       int col, int qd) {
  const int half = rk / 2;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int r = 16 * kk + 2 * qd + 8 * p;
    const bool hi = r >= half, ok = r < rk;
    const int row = ok ? (hi ? r - half : r) : 0;
    const uint32_t w0 = *reinterpret_cast<const uint16_t*>(side + code_at(row, col));
    const uint32_t w1 = *reinterpret_cast<const uint16_t*>(side + code_at(row + 1, col));
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const uint32_t x = __byte_perm(w0, w1, t ? 0x2521 : 0x2420) >> (hi ? 4 : 0);
      af[2 * p + t] = ok ? bf_nib02(x) : 0u;
    }
  }
}

// ext4mm's V fragments of 64-rank block m, 16-token step j: rows ranks 64 m
// + 16 w + gq (+ 8), columns k = 2 q + e (token 4 q + 2 e) and 8 + 2 q + e
// (token 4 q + 2 e + 1) of the step; ranks past rv are zeros (branch-free,
// as k_frag)
__device__ __forceinline__ void v_frag(uint32_t (&af)[4], const uint8_t* side, int rv, int m,
                                       int j, int h, int warp, int gq, int qd) {
  const int half = rv / 2;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = 64 * m + 16 * warp + gq + 8 * rr;
    const bool ok = r < rv, hi = r >= half;
    const int row = ok ? (hi ? r - half : r) : 0;
    uint32_t w = *reinterpret_cast<const uint32_t*>(side + code_at(row, 64 * h + 16 * j + 4 * qd));
    w >>= hi ? 4 : 0;
    af[rr] = ok ? bf_nib02(w) : 0u;
    af[2 + rr] = ok ? bf_nib02(w >> 8) : 0u;
  }
}

// p^T of this warpgroup's 64 tokens of the tile (8 rows of 128 bytes in the
// 128-byte swizzle, K-major B of the V product): token t at K position t
// (cc) or, per 16-token step, at the column v_frag gives it (nc)
template <bool NC>
__device__ __forceinline__ void write_pt(uint8_t* pt, const bf16* p, int wt) {
  const int t = wt >> 1, c0 = 4 * (wt & 1);
  const uint2 v = *reinterpret_cast<const uint2*>(p + t * 8 + c0);
  int k = t;
  if (NC) {
    const int u = t & 15, qd = u >> 2, rem = u & 3;
    k = (t & ~15) + 2 * qd + (rem >> 1) + 8 * (rem & 1);
  }
  const uint16_t vals[4] = {static_cast<uint16_t>(v.x), static_cast<uint16_t>(v.x >> 16),
                            static_cast<uint16_t>(v.y), static_cast<uint16_t>(v.y >> 16)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = c0 + i;
    *reinterpret_cast<uint16_t*>(pt + n * 128 + ((((k >> 3) ^ n) & 7) << 4) + (k & 7) * 2) =
        vals[i];
  }
}

// B (rk x W bf16 of group g) as rows of 64 columns in the 128-byte swizzle,
// zeros past W; row k holds rank perm(k): ext4mm the ranks in order (zero
// rows up to a whole 128-rank chunk), ext4ccmm the assembled K boxes' order
// (box k / 64, row k % 64: box4's rows), zeros where a box row has no rank
template <int VAR>
__device__ __forceinline__ void load_b(uint8_t* bs, const UpArgs& a, int g, int tid) {
  const int half = a.rk / 2;
  for (int i = tid; i < a.L.b_rows * 8; i += kConsumers) {
    const int k = i >> 3, c = i & 7;
    int rank = k < a.rk ? k : -1;
    if (VAR == kExt4CcMm) {
      const int b = k / 64, rho = k % 64, byte_row = 32 * b + (rho & 31);
      rank = byte_row >= half ? -1 : rho < 32 ? byte_row : half + byte_row;
    }
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (rank >= 0 && c * 8 < a.W)
      v = *reinterpret_cast<const uint4*>(a.b1 + (static_cast<size_t>(g) * a.rk + rank) * a.W +
                                          c * 8);
    *reinterpret_cast<uint4*>(bs + k * 128 + (((c ^ k) & 7) << 4)) = v;
  }
}

// VAR: the variant; NMV: ext4mm's 64-rank V blocks (rv <= 64 NMV), 1 else
template <int VAR, int NMV>
__global__ void __launch_bounds__(kThreads, 1)
unpack_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
              const UpArgs a) {
  constexpr bool kCc = is_cc(VAR), kMm = is_mm(VAR);
  const Plan& L = a.L;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t full = base + L.bars, empty = full + 8 * L.ns;
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid / 32, 0), lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < L.ns; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int i0 = static_cast<int>(static_cast<long long>(blockIdx.x) * a.n_items / gridDim.x);
  const int i1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * a.n_items / gridDim.x);
  const int tpi = a.BS / kT;

  if (warp == kConsumers / 32) {  // ---- producer
    if (lane == 0) {
      int it = 0;
      for (int item = i0; item < i1; ++item) {
        const int g = item / a.nblk, blk = item % a.nblk;
        for (int t = 0; t < tpi; ++t, ++it) {
          const int st = it % L.ns, s0 = blk * a.BS + t * kT;
          mbar_wait(empty + 8 * st, ((it / L.ns) & 1) ^ 1);
          const uint32_t fb = full + 8 * st, dst = base + st * L.stage;
          mbar_expect_tx(fb, L.load_bytes);
          for (int x = 0; x < L.nbox_k; ++x)
            tma_load(dst + x * L.br_k * 128, &tm_k, fb, s0, x * L.br_k, g);
          for (int x = 0; x < L.nbox_v; ++x)
            tma_load(dst + L.side_v + x * L.br_v * 128, &tm_v, fb, s0, x * L.br_v, g);
          if (kMm)  // the tile's rows of p (G, BS, 8)
            bulk_load(dst + L.side_p, a.p + (static_cast<size_t>(g) * a.BS + t * kT) * 8,
                      kT * 8 * 2, fb);
        }
      }
    }
    return;
  }

  // ---- consumers
  const int wg = warp / 4, wt = tid % kWG, w = warp % 4, gq = lane / 4, qd = lane % 4;
  const int sync_wg = 1 + wg, sync_all = 3;
  long long tot = 0;           // the integer variants' exact total
  unsigned long long ck = 0;   // base
  float acc_k[32], acc_v[NMV][4];  // mm
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_k[i] = 0.0f;
#pragma unroll
  for (int m = 0; m < NMV; ++m) acc_v[m][0] = acc_v[m][1] = acc_v[m][2] = acc_v[m][3] = 0.0f;
  uint8_t* bs = sm + L.b;
  const uint32_t box0 = base + L.asm_ + wg * (kMm ? 3 : 2) * kBoxBytes;
  uint8_t* pt0 = sm + L.pt + wg * 2 * 1024;
  float* red = reinterpret_cast<float*>(sm + L.red);  // [item parity][warp][K, V]
  int it = 0, bc = 0, g_b = -1;
  for (int item = i0; item < i1; ++item) {
    const int g = item / a.nblk, blk = item % a.nblk;
    if (kMm && g != g_b) {  // B of the group (every product of the last item waited on)
      load_b<VAR>(bs, a, g, tid);
      fence_async_shared();
      named_sync(sync_all, kConsumers);
      g_b = g;
    }
    for (int t = 0; t < tpi; ++t, ++it) {
      const int st = it % L.ns;
      mbar_wait(full + 8 * st, (it / L.ns) & 1);
      const uint8_t* ks = sm + st * L.stage;
      const uint8_t* vs = ks + L.side_v;
      if constexpr (!kCc && !kMm) {
        if constexpr (VAR == kBase) {
          ck += fold_side(ks, L.rows_k, tid) + fold_side(vs, L.rows_v, tid);
        } else {
          float s;
          if constexpr (VAR == kExt4Nc)
            s = ext4_side(ks, L.rows_k, tid) + ext4_side(vs, L.rows_v, tid);
          else if constexpr (VAR == kExt3Nc)
            s = ext3_side(ks, a.rk, tid) + ext3_side(vs, a.rv, tid);
          else
            s = conv8_side(ks, L.rows_k, tid) + conv8_side(vs, L.rows_v, tid);
          tot += __float2ll_rn(s);
        }
        fence_async_shared();  // the reads are done before a TMA refill
        mbar_arrive(empty + 8 * st);
      } else if constexpr (!kMm) {
        // ext4cc / ext3cc: assemble the boxes two at a time, then read both
        // back (each lane the units its neighbour wrote: a round trip
        // through shared memory with a warp's barrier, as nothing but the
        // warp reads them; a second barrier before the buffers refill)
        const int nb = L.ccb_k + L.ccb_v;
        float s = 0.0f;
        for (int b0 = 0; b0 < nb; b0 += 2) {
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int b = b0 + x;
            if (b >= nb) break;
            const bool v = b >= L.ccb_k;
            const uint32_t dst = box0 + x * kBoxBytes;
            if constexpr (VAR == kExt4Cc)
              box4(dst, v ? vs : ks, (v ? a.rv : a.rk) / 2, v ? b - L.ccb_k : b, wg, wt);
            else
              box3(dst, v ? vs : ks, (v ? a.rv : a.rk) / 8, v ? b - L.ccb_k : b, wg, wt);
          }
          if (b0 + 2 >= nb) {  // the tile's last read of the stage
            fence_async_shared();
            mbar_arrive(empty + 8 * st);
          }
          __syncwarp();  // the warp's units are written
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            if (b0 + x >= nb) break;
            const uint8_t* box = sm + (box0 - base) + x * kBoxBytes;
            if constexpr (VAR == kExt4Cc)
              s += box4_back(box, wt);
            else
              s += box3_back(box, wt);
          }
          __syncwarp();  // the warp's lanes read both before the next pair refills them
        }
        tot += __float2ll_rn(s);
      } else {
        const bf16* pg = reinterpret_cast<const bf16*>(ks + L.side_p) + 64 * wg * 8;
        uint8_t* pt = pt0 + (it & 1) * 1024;  // its last reader: tile it - 2, waited on
        write_pt<VAR == kExt4Mm>(pt, pg, wt);
        const uint32_t pt_a = smem_u32(pt);
        if constexpr (VAR == kExt4Mm) {
          // x^T . B, one group of 8 16-rank steps a 128-rank chunk (steps
          // past rk: zero fragments, against B's zero rows), then x . p
          fence_async_shared();
          named_sync(sync_wg, kWG);  // p^T is whole
          // the lane's coordinates made opaque each tile: otherwise the
          // compiler hoists every fragment's address offset out of the loop
          // and spills them
          int wl = w * 32 + lane;
          asm volatile("" : "+r"(wl));
          const int tw = wl >> 5, tgq = (wl & 31) >> 2, tqd = wl & 3;
          const int col = 64 * wg + 16 * tw + 2 * tgq;
          uint32_t afk[8][4];
          for (int c = 0; c < L.b_rows / 128; ++c) {
            if (c > 0) wgmma_wait0();
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) k_frag(afk[kk], ks, a.rk, 8 * c + kk, col, tqd);
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) fence_regs(afk[kk]);
            fence_regs(acc_k);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 8; ++kk)
              wgmma_rs_n64(acc_k, afk[kk],
                           sw128_desc(base + L.b + (8 * c + kk) * 2048, 8192, 1024), 1);
            wgmma_commit();
          }
          // x . p per 16-token step, a group of one product a 64-rank block,
          // each block its own accumulator; two fragment sets, one refilled
          // after wgmma_wait1 (only the last group in flight)
          uint32_t afv[2][NMV][4];
#pragma unroll
          for (int j = 0; j < 4; j += 2) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              wgmma_wait1();
#pragma unroll
              for (int m = 0; m < NMV; ++m)
                v_frag(afv[u][m], vs, a.rv, m, j + u, wg, tw, tgq, tqd);
#pragma unroll
              for (int m = 0; m < NMV; ++m) fence_regs(afv[u][m]);
#pragma unroll
              for (int m = 0; m < NMV; ++m) fence_regs(acc_v[m]);
              wgmma_fence();
#pragma unroll
              for (int m = 0; m < NMV; ++m)
                wgmma_v_rs(acc_v[m], afv[u][m], sw128_desc(pt_a + (j + u) * 32, 16, 1024));
              wgmma_commit();
            }
          }
          fence_async_shared();  // the tile's codes and p are read
          mbar_arrive(empty + 8 * st);
          wgmma_wait0();
          fence_regs(acc_k);
#pragma unroll
          for (int m = 0; m < NMV; ++m) fence_regs(acc_v[m]);
        } else {
          // ext4ccmm: per box, assemble, then its products (K: 4 16-rank
          // steps against B's rows of the box; V: 4 16-token steps against
          // p^T); three buffers, one barrier a box; the K and the V boxes in
          // loops of their own (no branch around a product)
          for (int b = 0; b < L.ccb_k; ++b, ++bc) {
            const uint32_t dst = box0 + (bc % 3) * kBoxBytes;
            box4(dst, ks, a.rk / 2, b, wg, wt);
            fence_async_shared();
            named_sync(sync_wg, kWG);  // the box (and p^T) whole; box bc - 3's products done
            fence_regs(acc_k);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_k_ss(acc_k, sw128_desc(dst + kk * 2048, 8192, 1024),
                         sw128_desc(base + L.b + (4 * b + kk) * 2048, 8192, 1024));
            wgmma_commit();
            wgmma_wait1();
          }
          for (int b = 0; b < L.ccb_v; ++b, ++bc) {
            const uint32_t dst = box0 + (bc % 3) * kBoxBytes;
            box4(dst, vs, a.rv / 2, b, wg, wt);
            if (b == L.ccb_v - 1) {  // the tile's last read of the stage
              fence_async_shared();
              mbar_arrive(empty + 8 * st);
            }
            fence_async_shared();
            named_sync(sync_wg, kWG);
            fence_regs(acc_v[0]);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_v_ss(acc_v[0], sw128_desc(dst + kk * 32, 16, 1024),
                         sw128_desc(pt_a + kk * 32, 16, 1024));
            wgmma_commit();
            wgmma_wait1();
          }
          wgmma_wait0();
          fence_regs(acc_k);
          fence_regs(acc_v[0]);
        }
      }
    }
    if constexpr (kMm) {  // the item's sums: warp, then the 8 warps in order
      float sk = 0.0f, sv = 0.0f;
#pragma unroll
      for (int i = 0; i < 32; ++i) sk += acc_k[i];
#pragma unroll
      for (int m = 0; m < NMV; ++m) sv += acc_v[m][0] + acc_v[m][1] + acc_v[m][2] + acc_v[m][3];
      sk = decode::warp_sum(sk);
      sv = decode::warp_sum(sv);
      float* rp = red + ((item - i0) & 1) * 16;
      if (lane == 0) rp[2 * warp] = sk, rp[2 * warp + 1] = sv;
      named_sync(sync_all, kConsumers);
      if (tid == 0) {
        float k = 0.0f, v = 0.0f;
        for (int x = 0; x < 8; ++x) k += rp[2 * x], v += rp[2 * x + 1];
        const size_t o = static_cast<size_t>(g) * a.nblk + blk;
        a.part_f[o] = k;
        a.part_f[static_cast<size_t>(a.G) * a.nblk + o] = v;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_k[i] = 0.0f;
#pragma unroll
      for (int m = 0; m < NMV; ++m) acc_v[m][0] = acc_v[m][1] = acc_v[m][2] = acc_v[m][3] = 0.0f;
    }
  }
  if constexpr (!kMm) {  // the block's total: a 64-bit add per warp
    unsigned long long v = VAR == kBase ? ck : static_cast<unsigned long long>(tot);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) atomicAdd(a.total, v);
  }
}

template <int VAR, int NMV = 1>
int launch(const CUtensorMap (&tm)[2], const UpArgs& a, int grid, cudaStream_t st) {
  const int smem = static_cast<int>(a.L.total) + 1024;
  auto kern = unpack_kernel<VAR, NMV>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, kThreads, smem, st>>>(tm[0], tm[1], a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plan of a variant at these ranks (the wrapper's mirror is held against
// it): out = {smem bytes, stages, stage bytes, K box rows, K boxes, V box
// rows, V boxes, cc boxes of K, of V, B rows}; out[0] = -1 when 2 stages do
// not fit.
extern "C" int unpack_probe_plan(int variant, int rk, int rv, int* out) {
  const Plan p = make_plan(variant, rk, rv);
  out[0] = p.ok ? static_cast<int>(p.total) + 1024 : -1;
  out[1] = p.ns, out[2] = static_cast<int>(p.stage), out[3] = p.br_k, out[4] = p.nbox_k;
  out[5] = p.br_v, out[6] = p.nbox_v, out[7] = p.ccb_k, out[8] = p.ccb_v, out[9] = p.b_rows;
  return 0;
}

// variant: 0 base, 1 ext4nc, 2 ext4cc, 3 ext4mm, 4 ext4ccmm, 5 ext3nc, 6
// ext3cc, 7 conv8. kc / vc: (G, rows_k / rows_v, S) codes, rows = rank / 2
// (4-bit, base), 3 * rank / 8 (3-bit) or rank (int8), 16-byte aligned. b1
// (G, rk, W) and p (G, BS, 8) bf16 for the mm variants (4-bit codes);
// part_f (2, G, S / BS) f32 (mm); total one i64 (the other variants,
// zeroed here). S a multiple of BS, BS of 128; rk and rv multiples of 32
// (4-bit), of 8 (3-bit, int8); W a multiple of 16 up to 64; grid blocks
// (at most the items G * S / BS: the wrapper's min(items, SMs)).
extern "C" int unpack_probe(int variant, const void* kc, const void* vc, const void* b1,
                            const void* p, void* part_f, void* total, int G, int rk, int rv, int W,
                            int S, int BS, int grid, void* stream) {
  if (variant < kBase || variant > kConv8 || BS <= 0 || BS % kT || S % BS || rk % 8 || rv % 8 ||
      rk <= 0 || rv <= 0 || G <= 0 || grid <= 0 || grid > G * (S / BS))
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_four(variant) && (rk % 32 || rv % 32)) return static_cast<int>(cudaErrorInvalidValue);
  if (is_mm(variant) && (W % 16 || W > 64 || W <= 0 || rv > 512))
    return static_cast<int>(cudaErrorInvalidValue);
  UpArgs a{};
  a.L = make_plan(variant, rk, rv);
  if (!a.L.ok) return static_cast<int>(cudaErrorInvalidValue);
  a.b1 = static_cast<const bf16*>(b1);
  a.p = static_cast<const bf16*>(p);
  a.part_f = static_cast<float*>(part_f);
  a.total = static_cast<unsigned long long*>(total);
  a.G = G, a.rk = rk, a.rv = rv, a.W = W, a.BS = BS, a.nblk = S / BS, a.n_items = G * (S / BS);
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap tm[2];
  if (!(make_map_3d(&tm[0], u8, 1, kc, S, a.L.rows_k, G, kT, a.L.br_k, sw) &&
        make_map_3d(&tm[1], u8, 1, vc, S, a.L.rows_v, G, kT, a.L.br_v, sw)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_mm(variant)) {
    const cudaError_t e = cudaMemsetAsync(total, 0, sizeof(unsigned long long), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  switch (variant) {
    case kBase: return launch<kBase>(tm, a, grid, st);
    case kExt4Nc: return launch<kExt4Nc>(tm, a, grid, st);
    case kExt4Cc: return launch<kExt4Cc>(tm, a, grid, st);
    case kExt4Mm:
      return rv <= 128   ? launch<kExt4Mm, 2>(tm, a, grid, st)
             : rv <= 256 ? launch<kExt4Mm, 4>(tm, a, grid, st)
             : rv <= 384 ? launch<kExt4Mm, 6>(tm, a, grid, st)
                         : launch<kExt4Mm, 8>(tm, a, grid, st);
    case kExt4CcMm: return launch<kExt4CcMm>(tm, a, grid, st);
    case kExt3Nc: return launch<kExt3Nc>(tm, a, grid, st);
    case kExt3Cc: return launch<kExt3Cc>(tm, a, grid, st);
    default: return launch<kConv8>(tm, a, grid, st);
  }
}
