// Latent decode attention over the unquantized (bf16) latent caches, for
// Hopper: the K rebuild on warpgroup MMA (wgmma) once per kv-head, the
// value product on mma.sync, a TMA-fed mbarrier ring of cache chunks, one
// wave of blocks whose splits cut each lane's valid tiles.
//
// Replaces: palu_tpu/ops/pallas/palu_decode.py::palu_flash_decode (the v1
// kernel over seq-major latents (B, G, S, r)) and
// palu_tpu/ops/pallas/palu_decode4.py::palu_flash_decode4 (the v4 kernel
// over rank-major latents (B, G, r, S), with k_bias, pos_offset,
// return_stats and layer_idx); RM selects the layout, nothing else differs.
// And palu_tpu/ops/pallas/archive/palu_decode2.py::palu_flash_decode2, the
// archived v2 kernel over K seq-major and V rank-major latents
// (palu_decode_fp_v2_kernel: the body's K and V layouts apart, RMK false,
// RMV true; each side's chunks come in their own form, see k_chain and the
// V product).
//
// What it computes, per lane b, group g, kv-head j of the group and each of
// the rep q-heads h that read it (rep = hpg / nkv; 1 for JAX's repeated
// form):
//   K_j(s) = B_j^T x_k(s) [+ b_j, the K bias, before RoPE]
//   logit_h(s) = q_h . RoPE_s(K_j(s)) / sqrt(hd), masked by kv_len and window
//   out_h = sum_s softmax(logit_h)(s) x_v(s)
// -> (B, nh, rv) f32 in latent space (o_proj is U_v-fused).
//
// Bound on this card: bytes. A token costs (rk + rv) * 2 bytes of latents
// per group and 2 * nkv * rk * hd flops of K rebuild: at the Llama-2-7B
// group (4 kv-heads, rk 128, rv 384) 1024 bytes against 131 kflop, 128
// flops per byte, under the card's ~295 bf16 flops per byte. At the byte
// bound a 64-token tile (64 KB) streams in ~2.5 us per SM, against ~1.1 us
// of tensor time for its four K rebuilds: the products must run on the
// tensor cores and everything around them must hide under the stream.
//
// Design. A block is 3 warpgroups (roles broadcast warp-uniform):
//  - producer (setmaxnreg 40): thread 0 keeps a ring of ns 16 KB chunks
//    full by TMA (cp.async.bulk.tensor, 128-byte swizzle), each chunk 64
//    tokens x 128 ranks of one side taken straight from the cache's layout:
//    rank-major planes as one (64 tokens, up to 128 ranks) box, seq-major
//    ones as two (64 ranks, 64 tokens) boxes; per tile the K chunks, then
//    the V chunks. Threads 32 and 64 stream B for consumer warpgroups 0 and
//    1 (each kv-head's 128-rank chunks of rows, hd in 64-column boxes): once
//    per work item when the warpgroups' B fits beside the ring (resident),
//    else per tile through a ring of nb >= 2 slots (streamed); the boxes
//    of the K chunks and of B always span 128 ranks, so the ranks past rk
//    arrive as zeros;
//  - two consumer warpgroups (setmaxnreg 232), each owning a contiguous
//    half of the group's q-heads (at most 16) and the kv-heads they read,
//    so neither waits on the other. Per tile: the RoPE rotation in
//    registers (each thread's 2 tokens x hd/4 frequencies, sin and cos of
//    the same f32 angle position * inv_freq the plain version takes, one
//    token on the special-function unit and one by polynomial; no table is
//    read); per kv-head K (64 tokens x hd) = x_k^T B_j as m64n(hd)k16 wgmma,
//    8 k-steps per 128-rank chunk, both operands in shared memory (x_k^T
//    from the ring chunk: M-major for rank-major chunks, K-major for
//    seq-major ones; B_j MN-major from its slot), then on the accumulator
//    registers the K bias, RoPE (the pair d, d + hd/2 falls in one thread),
//    the dot with each q-head that reads the kv-head and a quad shuffle per
//    logit (no block barrier per head); the online softmax (one warp per
//    head), which writes P^T in bf16 high and low parts in the 128-byte
//    swizzle; and out^T (rv x heads) += V (rv x 64 tokens) . P^T on wgmma
//    m64n16k16 per 64-rank block, V straight from the ring chunk, P^T's
//    high and low rows side by side in one product when a consumer has at
//    most 8 heads (hi.V + lo.V: the f32 class), the accumulators in
//    registers for the whole item.
// Shared memory (227 KB): the ring (ns x 16 KB, ns 3-8), B (resident: the
// group's kv-heads x 128-rank chunks x hd x 2 bytes, 128 KB at the Llama
// group; streamed: 2 x nb slots), per consumer P^T (2 x heads x 128 B), q
// (heads x hd f32), logits (heads x 64 f32), softmax statistics and the
// mbarriers. At the Llama group: B 128 KB resident, 5 chunks (80 KB: a
// whole 64 KB tile plus one chunk in flight), ~16 KB of the rest.
// Registers per consumer thread (232 at most): the K accumulator (hd / 2),
// the tile's rotation (hd / 2), the V accumulators (MT x 8: 48 at the Llama
// group) and ~40 more.
//
// Where a tile's time goes: palu_tpu_torch/tools/decode_timeline.py stamps
// a copy of this kernel per phase and times the loads alone. At the Llama
// group the loads alone nearly reach the byte bound; the consumers' work
// (the rotation, both kv-heads' products and epilogues, the softmax and
// the V products, each a sizable share) sets the pace. Small wgmma cost
// about the same whatever their width, hence the fold of P^T's high and
// low rows into one product. Tried and slower: the value product on
// mma.sync (however its loops were ordered), the rotation or the previous
// tile's V products placed under the K products, the V products retired a
// tile later.
//
// The grid is one wave: work items (lane, group, sequence split) number at
// most SMs (the wrapper's _splits), blocks min(items, SMs), each looping
// over items; the splits of a (lane, group) cut its valid tiles (from
// kv_len, the window and pos_offset, read on the device:
// decode::tile_range), so every valid tile is read once and no block walks
// past kv_len; a split with no tile writes m = -1e30, l = 0, acc = 0. The
// combine kernel (decode_common.cuh) merges the splits.
//
// The seq-major packed cache (palu_decode_seq_wg_kernel; replaces
// palu_tpu/ops/pallas/palu_decode.py::palu_flash_decode_quantized, the v1
// kernel over codes (B, G, S, nbytes) in core/quant.pack_codes' plane
// packing, 2, 3 or 4 bits, with per-token scale and base (B, G, S, 1), x =
// (code + q_min - base) * scale). Bound: at 3 bits a token is (rk + rv) * 3 /
// 8 + 16 bytes per group against the same K rebuild, so the operations
// bound it (0.0090 ms at the Llama group and 8K at an H100's 989 bf16
// TFLOP/s). The consumers run
// unchanged on the chunk images a bf16 seq-major cache gives them; only the
// producer differs. Its thread 0 copies each 64-token tile of one (b, g)
// plane as six bulk copies (the K and V code runs of 64 x nbytes bytes,
// contiguous, and the four scale and base rows; the last tile stops at S)
// into a ring of npk packed stages, npk tiles ahead. With B resident it
// loads each item's B too, and all 128 producer threads unpack; with B
// streamed, threads 32 and 64 stream it as for the bf16 caches (the loads
// wait on the consumers, so they cannot sit in the unpacking loop) and
// warps 0 and 3 unpack. Unpacking writes the stage into the 128-rank chunks
// of the bf16 ring, thread (t0, u) 8 ranks of tokens t0, t0 + nthr / 16,
// ... as one 16-byte store into the 128-byte swizzle (conflict-free per
// quarter warp), from a per-block table of each 8-rank unit's byte offsets
// and shifts; at 40 registers it spilled, so this kernel takes 56 / 224 /
// 224. The operand is exact: code + q_min as a bf16 small integer (bf16
// 0x4300 | c is 128 + c; one bf16x2 subtraction takes 128 - q_min off), so
// a base far from zero loses nothing. The per-token terms ride on the
// accumulators: K(s) = scale(s) (B^T (code + q_min) - base(s) rowsum B)
// before RoPE (rowsum B from decode::launch_rowsum), P^T = p scale_v(s) in
// bf16 high and low parts, and each head's sum of (hi + lo) (-base_v(s))
// adds to every rank of its output. Each chunk's per-token scale and -base
// ride in a 512-byte side row per ring slot. Ranks past rk in the last K
// chunk hold whatever finite values the ring had (zeroed at the start), and
// B's rows there are zero; tokens past kv_len are masked before any scale
// multiplies them.
//
// The dissection (palu_decode_fp_dissect; replaces tools/tpu_dissect.py::
// call, the TPU tool that splits the v1 decode's time): each mode takes a
// part out of the kernel palu_decode_fp launches, at its splits, over
// seq-major bf16 latents with one B per q-head. kFull is that kernel itself
// (palu_decode_fp_wg; the tool launches it through palu_decode_fp's own
// launcher). The others run palu_decode_fp_dissect_kernel, the body's MODE
// argument, at the tool's head dim (128) and one 8-head tile a consumer
// (MT 6 up to rv 384, else 8, for the one with V products): kNoValue keeps
// everything but the V products (the consumers wait for the V chunks and
// release them) and emits each head's (m, l); kNoLogits streams no B and
// runs no K product or rotation: 1e-6 times each token's x_k summed over
// ranks (its group's, from the K chunks) is every head's logit, and the
// softmax and V products run on it; kDmaOnly keeps the producer's ring,
// and consumer c adds the 16-bit patterns of box c of every chunk into an
// exact 64-bit checksum before both release it; kNoop folds each 16-byte
// unit once (the XOR of its four words) instead. The swizzle permutes whole 16-byte units
// and the boxes bring ranks past r and tokens past S as zeros, which add
// nothing: the checksums are those of the cache's own elements (a V
// chunk's second box counts only when it was loaded). The modes with no K
// work take palu_decode_fp's ring depth with no B slots and no B barrier;
// kNoValue keeps B.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kTile = 64;          // tokens per tile (the wgmma M of the K rebuild)
constexpr int kWG = 128;           // threads per warpgroup
constexpr int kThreads = 3 * kWG;  // two consumer warpgroups, one producer
constexpr int kMaxHeads = 32;      // q-heads per group (Qwen2-7B: 28)
constexpr int kWgHeads = 16;       // q-heads per consumer warpgroup
constexpr int kMaxRank = 512;
constexpr int kChunk = 128;        // ranks per ring chunk
constexpr uint32_t kChunkBytes = kTile * kChunk * 2;  // 16 KB
constexpr int kMaxKSteps = kChunk / 16;
constexpr int kSmemBudget = static_cast<int>(decode::kSmemMax) - 1024;  // - alignment slack
// the dissection's modes (header); kFull is the kernel that serves
constexpr int kFull = 0, kNoValue = 1, kNoLogits = 2, kDmaOnly = 3, kNoop = 4;

struct Plan {
  int ok, ns, nb, resident, nck, ncv, rows_v;
  uint32_t slot_bytes;                      // one B slot: 128 ranks x hd, hd / 64 boxes
  uint32_t bslots, p, q, lg, stats, bars, total;
  // the packed cache: npk stages of pstage bytes at pk (K codes at 0, V codes
  // at pv, the K scale, K base, V scale and V base rows at psc), the unit
  // table at utab and the ring slots' side rows at aux
  int npk;
  uint32_t pstage, pv, psc, pk, utab, aux;
};

// what the packed variant adds to Args
struct Packed {
  const uint8_t* kc;       // (B, G, S, nbk) codes
  const uint8_t* vc;       // (B, G, S, nbv)
  const float* ks;         // (B, G, S) scale and base per token
  const float* kb;
  const float* vs;
  const float* vb;
  const float* rsum;       // (G, hpg, hd) row sums of B
  int nbk, nbv, pbits, qmin;
};

struct Args {
  const void* q;           // (B, nh, hd) bf16 or f32, roped at the current position
  int q_bf16;
  const float* kbias;      // (G, nkv, hd) pre-RoPE K bias, or null
  const float* inv_freq;   // (hd / 2,) RoPE frequencies
  const int* kv_len;       // (B,) absolute
  float* part_m;           // (B, nh, splits)
  float* part_l;
  float* part_acc;         // (B, nh, splits, rv)
  int B, G, hpg, nkv, rep, rk, rv, S, window;
  int hsplit;              // consumer 0 owns q-heads [0, hsplit), consumer 1 the rest
  int splits, n_items, layer, pos_offset;
  float inv_sqrt_hd, rope_scale;
  Plan L;
  Packed pk;
  unsigned long long* ck;  // the dissection's checksum (kDmaOnly, kNoop), zeroed before
};

inline uint32_t up(uint32_t x, uint32_t a) { return (x + a - 1) / a * a; }

// The shared-memory plan: ns ring chunks, B (resident: every kv-head of
// both consumers, all rank chunks; streamed: nb slots per consumer, each one
// 128-rank chunk of one kv-head), then per consumer P^T (high, low), q, the
// logits and the softmax statistics, then the mbarriers. Preference: B
// resident with the deepest ring up to 8 chunks and at least one tile's K
// chunks plus one; else B streamed, a whole tile plus one chunk in flight
// if it fits. ok = 0 when nothing fits.
//
// The packed cache (nbk > 0: bytes per token of K codes, nbv of V) adds the
// fourth statistic (each head's offset sum), the unit table, a side row per
// ring slot and npk packed stages; the ring need only hold one side's
// chunks (max(nck, ncv): the K chunks are free before the softmax waits
// for the first V chunk). Preference: B resident with the deepest ring up
// to 8 chunks, 2 stages before 1; else B streamed, the ring from a tile
// plus one chunk down, 2 stages before 1, the most B slots up to 8 (at least
// 2, else 1).
//
// ring > 0: the dissection's modes with no K work, a ring of that many
// chunks and no B slots.
Plan make_plan(int hd, int rk, int rv, int nkv0, int nkv1, int npw, int nbk = 0, int nbv = 0,
               int ring = 0) {
  Plan p{};
  const bool pk = nbk > 0;
  p.nck = (rk + kChunk - 1) / kChunk;
  p.ncv = (rv + kChunk - 1) / kChunk;
  p.rows_v = rv < kChunk ? rv : kChunk;
  p.pv = up(kTile * nbk, 128);
  p.psc = p.pv + up(kTile * nbv, 128);
  p.pstage = pk ? p.psc + 4 * kTile * 4 : 0;
  auto tail = [&](int ns, int nb, uint32_t slot, int npk) {
    uint32_t o = ns * kChunkBytes;
    p.bslots = o;
    o = up(o + 2 * nb * slot, 1024);
    p.p = o; o += 2 * 2 * npw * 128;
    p.q = o; o += 2 * npw * hd * 4;
    p.lg = o; o += 2 * npw * kTile * 4;
    p.stats = o; o += 2 * (pk ? 4 : 3) * npw * 4;
    if (pk) {
      p.utab = up(o, 16); o = p.utab + 2 * 4 * 16 * 8;  // [side][chunk][unit] uint2
      p.aux = o; o += ns * 2 * kTile * 4;
      p.pk = up(o, 128); o = p.pk + npk * p.pstage;
    }
    p.bars = up(o, 8);
    return p.bars + 8 * (2 * ns + 4 * nb + npk);
  };
  const int nkvw = nkv0 > nkv1 ? nkv0 : nkv1;
  const int want = p.nck + p.ncv + 1 < 8 ? p.nck + p.ncv + 1 : 8;
  const int least = pk ? (p.nck > p.ncv ? p.nck : p.ncv) : p.nck + 1;
  const uint32_t slot = kChunk * hd * 2;
  const uint32_t budget = static_cast<uint32_t>(kSmemBudget);
  auto take = [&](int ns, int nb, int resident, int npk) {
    p.ok = 1, p.ns = ns, p.nb = nb, p.resident = resident, p.slot_bytes = slot, p.npk = npk;
    p.total = tail(ns, nb, slot, npk);
  };
  if (ring > 0) {
    take(ring, 0, 0, 0);
    p.ok = p.total <= budget;
    return p;
  }
  const int nb_res = nkvw * p.nck > 0 ? nkvw * p.nck : 1;
  const int npk_hi = pk ? 2 : 0, npk_lo = pk ? 1 : 0;
  for (int ns = 8; ns >= least; --ns)  // resident
    for (int npk = npk_hi; npk >= npk_lo; --npk)
      if (tail(ns, nb_res, slot, npk) <= budget) {
        take(ns, nb_res, 1, npk);
        return p;
      }
  for (int nb0 = 2; nb0 >= (pk ? 1 : 2); --nb0)  // streamed
    for (int ns = want; ns >= least; --ns)
      for (int npk = npk_hi; npk >= npk_lo; --npk) {
        int nb = nb0;
        if (tail(ns, nb, slot, npk) > budget) continue;
        while (nb < 8 && tail(ns, nb + 1, slot, npk) <= budget) ++nb;
        take(ns, nb, 0, npk);
        return p;
      }
  p.ok = 0;
  return p;
}

// The q-head split between the consumers: by whole kv-heads when each half
// stays within kWgHeads, else by halves of the group's q-heads (both then
// rebuild the kv-head across the cut).
int head_split(int hpg, int nkv) {
  const int rep = hpg / nkv, hs = rep * ((nkv + 1) / 2);
  return hs <= kWgHeads && hpg - hs <= kWgHeads ? hs : (hpg + 1) / 2;
}

#define PALU_ACC64                                                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),   \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),   \
      "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define PALU_ACC128                                                                                \
  PALU_ACC64, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),       \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),   \
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),   \
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]),   \
      "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define PALU_REGS32                                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define PALU_REGS64                                                                          \
  PALU_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, " \
              "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// d (64 tokens x N, f32) (+)= A (64 tokens x 16 ranks, shared memory: K-major
// when TA is 0, M-major when 1) . B (16 ranks x N dims, MN-major in shared
// memory), scale_d 0 on a chain's first product.
template <int N, int TA>
__device__ __forceinline__ void wgmma_k(float (&d)[N / 2], uint64_t da, uint64_t db,
                                        int scale_d) {
  if constexpr (N == 128) {
    if constexpr (TA) {
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" PALU_REGS64
                   "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
                   : PALU_ACC128
                   : "l"(da), "l"(db), "r"(scale_d));
    } else {
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" PALU_REGS64
                   "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
                   : PALU_ACC128
                   : "l"(da), "l"(db), "r"(scale_d));
    }
  } else {
    if constexpr (TA) {
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" PALU_REGS32
                   "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
                   : PALU_ACC64
                   : "l"(da), "l"(db), "r"(scale_d));
    } else {
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" PALU_REGS32
                   "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
                   : PALU_ACC64
                   : "l"(da), "l"(db), "r"(scale_d));
    }
  }
}

// d (64 ranks x 16 columns, f32) += A (64 ranks x 16 tokens, shared memory:
// K-major when TA is 0, M-major when 1) . B (16 tokens x 16 columns,
// K-major in shared memory)
template <int TA>
__device__ __forceinline__ void wgmma_v(float (&d)[8], uint64_t da, uint64_t db) {
  if constexpr (TA) {
    asm volatile("wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, 1, 1, 1, 1, 0;\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7])
                 : "l"(da), "l"(db));
  } else {
    asm volatile("wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, 1, 1, 1, 0, 0;\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7])
                 : "l"(da), "l"(db));
  }
}

// kv (+)= the 8 k-steps of one 128-rank chunk, x_k^T (ring chunk at
// `aslot`) . B (slot `bslot`), one unguarded chain of fixed length: a chain
// length picked at run time (a switch), beside the mma.sync value product,
// makes ptxas serialize every product (C7520). Ranks past rk are zero in
// both operands (TMA fills the boxes' out-of-range rows with zeros). The A
// descriptor: rank-major chunks hold 16 ranks per 2048 bytes (M-major);
// seq-major ones 64 ranks per 8 KB box, 16 per 32 bytes of a swizzled row
// (K-major).
template <int HD, bool RM>
__device__ __forceinline__ void k_chain(float (&kv)[HD / 2], uint32_t aslot, uint32_t bslot,
                                        int first) {
#pragma unroll
  for (int kk = 0; kk < kMaxKSteps; ++kk) {
    const uint64_t da = RM ? sw128_desc(aslot + kk * 2048, kChunkBytes, 1024)
                           : sw128_desc(aslot + (kk >> 2) * 8192 + (kk & 3) * 32, 16, 1024);
    wgmma_k<HD, RM ? 1 : 0>(kv, da, sw128_desc(bslot + kk * 2048, kChunk * 128, 1024),
                            kk > 0 || !first);
  }
}

// sin and cos of an f32 angle: decode::sincos_fast's reduction to r in
// [-pi/4, pi/4] and quadrant, then the special-function unit on r (absolute
// error ~2^-21 there): about half of the polynomial's instructions.
__device__ __forceinline__ void sincos_sfu(float x, float& sn, float& cs) {
  const float j = rintf(x * 0x1.45f306p-1f);  // 2 / pi
  float r = fmaf(j, -0x1.921fb6p+0f, x);      // pi/2 in three parts
  r = fmaf(j, 0x1.777a5cp-25f, r);
  r = fmaf(j, 0x1.ee59dap-50f, r);
  const float s = __sinf(r), c = __cosf(r);
  const int q = static_cast<int>(j) & 3;
  const float a = (q & 1) ? c : s, b = (q & 1) ? s : c;
  sn = (q & 2) ? -a : a;
  cs = ((q + 1) & 2) ? -b : b;
}

// The tile's RoPE rotation in this thread's registers: its tokens ta and ta
// + 8 (rows of the K accumulator) at frequencies 8jj + 2qd + e (jj < hd/16),
// sin and cos of the f32 angle position * inv_freq, times rope_scale; token
// ta's on the special-function unit, ta + 8's by polynomial on the FMA pipe,
// so that the two units share the work.
template <int HD>
__device__ __forceinline__ void rotation(float (&rc)[HD / 16][2][2], float (&rs)[HD / 16][2][2],
                                         const float* inv_freq, float pa, int qd,
                                         float rope_scale) {
#pragma unroll
  for (int jj = 0; jj < HD / 16; ++jj) {
    const float2 f = __ldg(reinterpret_cast<const float2*>(inv_freq + 8 * jj + 2 * qd));
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float inv = e ? f.y : f.x;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float sn, cs;
        const float x = __fmul_rn(pa + 8.0f * t, inv);
        if (t == 0)
          sincos_sfu(x, sn, cs);
        else
          decode::sincos_fast(x, sn, cs);
        rc[jj][e][t] = cs * rope_scale;
        rs[jj][e][t] = sn * rope_scale;
      }
    }
  }
}

// The epilogue of one kv-head on its K registers (element 4jj + 2t + e: token
// ta + 8t, column 8jj + 2qd + e): the K bias (its hd values, or null), RoPE,
// and the logits of the consumer's q-heads hw0 .. hw1 - 1 into lg (q_s
// pre-scaled by 1 / sqrt(hd)); a quad shuffle finishes each logit.
template <int HD>
__device__ __forceinline__ void k_finish(float (&kf)[HD / 2], const float (&rc)[HD / 16][2][2],
                                         const float (&rs)[HD / 16][2][2], const float* bias,
                                         const float* q_s, float* lg, int hw0, int hw1, int ta,
                                         int qd) {
  constexpr int NJ = HD / 8, H = NJ / 2;
  if (bias != nullptr) {
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + 8 * jj + 2 * qd));
      kf[4 * jj] += bb.x, kf[4 * jj + 1] += bb.y;
      kf[4 * jj + 2] += bb.x, kf[4 * jj + 3] += bb.y;
    }
  }
#pragma unroll
  for (int jj = 0; jj < H; ++jj)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // column f < hd / 2 pairs with f + hd / 2
        const int u = 4 * jj + 2 * t + e, v = u + 4 * H;
        const float c = rc[jj][e][t], s = rs[jj][e][t], k1 = kf[u], k2 = kf[v];
        kf[u] = k1 * c - k2 * s;
        kf[v] = k2 * c + k1 * s;
      }
  for (int h = hw0; h < hw1; ++h) {
    const float* qh = q_s + h * HD;
    float la = 0.0f, lb = 0.0f, la2 = 0.0f, lb2 = 0.0f;  // two chains per token
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const float2 qv = *reinterpret_cast<const float2*>(qh + 8 * jj + 2 * qd);
      la = fmaf(qv.x, kf[4 * jj], la);
      la2 = fmaf(qv.y, kf[4 * jj + 1], la2);
      lb = fmaf(qv.x, kf[4 * jj + 2], lb);
      lb2 = fmaf(qv.y, kf[4 * jj + 3], lb2);
    }
    la += la2;
    lb += lb2;
    la += __shfl_xor_sync(0xffffffffu, la, 1);
    la += __shfl_xor_sync(0xffffffffu, la, 2);
    lb += __shfl_xor_sync(0xffffffffu, lb, 1);
    lb += __shfl_xor_sync(0xffffffffu, lb, 2);
    if (qd == 0) {  // every lane of the quad holds the sums
      lg[h * kTile + ta] = la;
      lg[h * kTile + ta + 8] = lb;
    }
  }
}

// The packed cache's per-token terms on one kv-head's K registers (element
// 4jj + 2t + e: token ta + 8t, column 8jj + 2qd + e): K = scale (K + off
// rowsum B_j), scale and off = -base from kx, the side rows of the tile's
// first K chunk.
template <int HD>
__device__ __forceinline__ void k_affine(float (&kf)[HD / 2], const float* rs, const float* kx,
                                         int ta, int qd) {
  const float sa = kx[ta], sb = kx[ta + 8], oa = kx[kTile + ta], ob = kx[kTile + ta + 8];
#pragma unroll
  for (int jj = 0; jj < HD / 8; ++jj) {
    const float2 r = __ldg(reinterpret_cast<const float2*>(rs + 8 * jj + 2 * qd));
    kf[4 * jj] = fmaf(oa, r.x, kf[4 * jj]) * sa;
    kf[4 * jj + 1] = fmaf(oa, r.y, kf[4 * jj + 1]) * sa;
    kf[4 * jj + 2] = fmaf(ob, r.x, kf[4 * jj + 2]) * sb;
    kf[4 * jj + 3] = fmaf(ob, r.y, kf[4 * jj + 3]) * sb;
  }
}

// The unit table of the packed cache: per side (K, V), 128-rank chunk c and
// 8-rank unit u (ranks r0 = 128 c + 8 u of that side's r), where its codes
// lie in a token's row of nbytes: x = the byte j0 of the main plane's 8
// bytes | their field's shift << 16 (~0: past r); y (3-bit) = for ranks r0
// .. r0 + 3 and r0 + 4 .. r0 + 7 the byte of the 1-bit plane (bits 0-9 and
// 16-25) and its bit (10-12, 26-28). A main plane byte j holds ranks j + k r
// / nf in field k (nf = 8 / its width); the 1-bit plane holds rank r at byte
// r mod (r / 8), bit r div (r / 8) (core/quant.pack_codes).
__device__ __forceinline__ uint2 unit_entry(int side, int c, int u, int rk, int rv, int pbits) {
  const int r = side ? rv : rk, r0 = c * kChunk + 8 * u;
  if (r0 >= r) return make_uint2(~0u, 0u);
  const int pw = pbits == 3 ? 2 : pbits, wpl = r / (8 / pw), k = r0 / wpl;
  uint2 e = make_uint2(static_cast<uint32_t>(r0 - k * wpl) | (static_cast<uint32_t>(pw * k) << 16),
                       0u);
  if (pbits == 3) {
    const int w1 = r / 8;
    for (int h = 0; h < 2; ++h) {
      const int rq = r0 + 4 * h;
      e.y |= (static_cast<uint32_t>(wpl + rq % w1) | (static_cast<uint32_t>(rq / w1) << 10))
             << (16 * h);
    }
  }
  return e;
}

// Unpack one 128-rank chunk (side, c) of the packed stage into ring slot
// `dst` (bf16, two 64-rank x 64-token boxes in the 128-byte swizzle), as
// thread (t0 = ut / 16, u = ut % 16) of the producer's nthr unpacking
// threads: unit u's 8 ranks of tokens t0, t0 + nthr / 16, ... as one
// 16-byte store each (eight threads fill one 128-byte row: no bank
// conflict); tokens at or past nvalid are zeros. `rows` is the side's code
// rows in the stage, nb bytes a token; `sub` the bf16 pair 128 - q_min.
__device__ __forceinline__ void unpack_chunk(uint32_t dst, const uint8_t* rows, int nb, uint2 e,
                                             int ut, int nthr, int pbits, uint32_t sub,
                                             int nvalid) {
  const int kStep = nthr / 16;  // tokens a pass
  if (e.x == ~0u) return;
  const int u = ut & 15, t0 = ut >> 4;
  const int j0 = e.x & 0xFFFF, sh = e.x >> 16;
  const uint32_t mask = pbits == 4 ? 0x0F0F0F0Fu : 0x03030303u;
  const uint8_t* row = rows + t0 * nb;
  const uint32_t d0 = dst + (u >> 3) * 8192;
#pragma unroll 2
  for (int t = t0; t < kTile; t += kStep, row += kStep * nb) {
    uint32_t c0 = (*reinterpret_cast<const uint32_t*>(row + j0) >> sh) & mask;
    uint32_t c1 = (*reinterpret_cast<const uint32_t*>(row + j0 + 4) >> sh) & mask;
    if (pbits == 3) {
      const uint32_t h0 = *reinterpret_cast<const uint32_t*>(row + (e.y & 0x3FF));
      const uint32_t h1 = *reinterpret_cast<const uint32_t*>(row + ((e.y >> 16) & 0x3FF));
      c0 |= ((h0 >> ((e.y >> 10) & 7)) & 0x01010101u) << 2;
      c1 |= ((h1 >> ((e.y >> 26) & 7)) & 0x01010101u) << 2;
    }
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
    if (t < nvalid) {  // bf16 0x4300 | c = 128 + c, less 128 - q_min
      o.x = __byte_perm(c0, 0x43434343u, 0x4140), o.y = __byte_perm(c0, 0x43434343u, 0x4342);
      o.z = __byte_perm(c1, 0x43434343u, 0x4140), o.w = __byte_perm(c1, 0x43434343u, 0x4342);
      uint32_t* w = &o.x;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(w + i),
                                         *reinterpret_cast<const __nv_bfloat162*>(&sub));
        w[i] = *reinterpret_cast<const uint32_t*>(&v);
      }
    }
    const uint32_t d = d0 + t * 128 + (((u & 7) ^ (t & 7)) << 4);
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(d), "r"(o.x), "r"(o.y),
                 "r"(o.z), "r"(o.w)
                 : "memory");
  }
}

// The dissection's checksum of one seq-major ring chunk's box (64 tokens x
// 64 ranks, 8 KB at `box`), 4 of its 512 16-byte units per thread of a
// consumer (wt): kDmaOnly adds each unit's eight 16-bit patterns, kNoop the
// XOR of its four words. The swizzle only permutes whole units, and ranks
// past r and tokens past S arrive as zeros, which add 0: the sums equal
// those over the cache's own elements.
template <int MODE>
__device__ __forceinline__ unsigned long long fold_box(uint32_t box, int wt) {
  unsigned long long ck = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint4 u;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
                 : "r"(box + (wt + 128 * k) * 16));
    if constexpr (MODE == kNoop) {
      ck += u.x ^ u.y ^ u.z ^ u.w;
    } else {
      ck += (u.x & 0xffffu) + (u.x >> 16) + (u.y & 0xffffu) + (u.y >> 16) + (u.z & 0xffffu) +
            (u.z >> 16) + (u.w & 0xffffu) + (u.w >> 16);
    }
  }
  return ck;
}

// The dissection's fake logits (kNoLogits) of the tile whose K chunks start
// at ring index q0: 1e-6 times each token's x_k summed over ranks (its K
// chunks' rows; ranks past rk are zeros), in lg for the consumer's nhw
// heads. Thread wt sums token wt / 2's row of box wt % 2 of every chunk.
__device__ __forceinline__ void fake_logits(uint32_t base, int q0, int ns, int nck, float* lg,
                                            int nhw, int wt) {
  const int t = wt >> 1, x = wt & 1;
  float sum = 0.0f;
  for (int ck = 0; ck < nck; ++ck) {
    const uint32_t row = base + ((q0 + ck) % ns) * kChunkBytes + x * 8192 + t * 128;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      uint4 v;
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(row + u * 16));
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        sum += f.x + f.y;
      }
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  if (x == 0)
    for (int h = 0; h < nhw; ++h) lg[h * kTile + t] = sum * 1e-6f;
}

// A work item's coordinates and its tiles [t0, t1) (empty when t1 <= t0).
struct Item {
  int b, g, split, t0, t1, vlo, vhi;
};

__device__ __forceinline__ Item item_at(const Args& a, int item) {
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

// The packed copies' place in the block's sequence of tiles (its items'
// tiles in order): item (>= n_items when done), tile, the item's end, plane.
struct Cursor {
  int item, tile, t1, plane;
};

__device__ __forceinline__ void cursor_next(const Args& a, Cursor& c) {
  ++c.tile;
  while (c.tile >= c.t1) {
    c.item += gridDim.x;
    if (c.item >= a.n_items) return;
    const Item w = item_at(a, c.item);
    c.tile = w.t0, c.t1 = w.t1, c.plane = w.b * a.G + w.g;
  }
}

// HD: head dim; RMK / RMV: rank-major K / V latents (the v2 layout: K
// seq-major, V rank-major; every other caller one layout for both); NT:
// 8-head tiles of a consumer's q-heads; MT: 64-rank blocks of the V
// accumulators, rv <= 64 MT; PK: the packed seq-major cache (RMK and RMV
// false); MODE: a dissection mode (kFull serves)
template <int HD, bool RMK, bool RMV, int NT, int MT, bool PK, int MODE = kFull>
__device__ __forceinline__ void decode_body(const CUtensorMap& tm_k, const CUtensorMap& tm_v,
                                            const CUtensorMap& tm_b, const Args& a) {
  constexpr int NACC = HD / 2;  // K accumulator registers per thread
  constexpr int NPW = 8 * NT;   // q-head rows of a consumer's P^T
  const Plan& L = a.L;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t bars = base + L.bars;
  const uint32_t full = bars, empty = bars + 8 * L.ns;
  const uint32_t bfull = bars + 16 * L.ns, bempty = bfull + 16 * L.nb;  // [consumer][nb]
  const uint32_t pfull = bempty + 16 * L.nb;                            // PK: [npk]
  float* aux = reinterpret_cast<float*>(sm + L.aux);  // PK: [ring slot][scale, -base][kTile]

  // the warpgroup's role, broadcast from lane 0 so that ptxas sees it warp-
  // uniform: wgmma under a branch it takes for divergent runs serialized (C7520)
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / kWG, 0);
  const int nh = a.G * a.hpg;
  if (tid == 0) {
    for (int s = 0; s < L.ns; ++s) {
      mbar_init(full + 8 * s, PK ? (L.resident ? kWG : kWG / 2) : 1);  // PK: the unpackers
      mbar_init(empty + 8 * s, 2 * kWG);
    }
    for (int s = 0; s < 2 * L.nb; ++s) {
      mbar_init(bfull + 8 * s, 1);
      mbar_init(bempty + 8 * s, kWG);
    }
    for (int s = 0; s < L.npk; ++s) mbar_init(pfull + 8 * s, 1);
    mbar_init_fence();
  }
  for (int i = tid; i < 2 * 2 * NPW * 128 / 4; i += kThreads)
    reinterpret_cast<uint32_t*>(sm + L.p)[i] = 0u;  // P^T rows past a consumer's heads stay 0
  if constexpr (PK) {
    // the ring zeroed: its bytes past rk in the last K chunk are only ever
    // finite values, against B's zero rows
    for (int i = tid; i < L.ns * static_cast<int>(kChunkBytes) / 16; i += kThreads)
      reinterpret_cast<uint4*>(sm)[i] = make_uint4(0u, 0u, 0u, 0u);
    uint2* utab = reinterpret_cast<uint2*>(sm + L.utab);
    for (int i = tid; i < 2 * 4 * 16; i += kThreads)
      utab[i] = unit_entry(i / 64, (i / 16) % 4, i % 16, a.rk, a.rv, a.pk.pbits);
    fence_async_shared();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: thread 0 streams the ring, threads 32 and 64 the B of
    // consumers 0 and 1 (PK: warps 0 and 3 copy and unpack the packed
    // tiles into the ring)
    // PK: 56 registers for the unpack (at 40 it spilled), 224 for the consumers
    if constexpr (PK)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int lt = tid - 2 * kWG;
    // consumer c's B for group g: its kv-heads' 128-rank chunks, slot by
    // slot (kb counts its slot uses)
    auto load_b = [&](int c, int g, int& kb) {
      const int h0 = c ? a.hsplit : 0, h1 = c ? a.hpg : a.hsplit;
      const int j0 = h0 / a.rep, j1 = h1 > h0 ? (h1 - 1) / a.rep + 1 : j0;
      for (int j = j0; j < j1; ++j)
        for (int bc = 0; bc < L.nck; ++bc, ++kb) {
          const int slot = kb % L.nb;
          mbar_wait(bempty + 8 * (c * L.nb + slot), ((kb / L.nb) & 1) ^ 1);
          const uint32_t fb = bfull + 8 * (c * L.nb + slot);
          const uint32_t dst = base + L.bslots + (c * L.nb + slot) * L.slot_bytes;
          mbar_expect_tx(fb, L.slot_bytes);
#pragma unroll
          for (int cc = 0; cc < HD / 64; ++cc)
            tma_load(dst + cc * kChunk * 128, &tm_b, fb, cc * 64, bc * kChunk, g * a.nkv + j);
        }
    };
    if (PK && (L.resident || lt < 32 || lt >= 96)) {
      // PK: thread 0 copies the packed tiles npk ahead (and, B resident,
      // loads each item's B), and the unpacking threads (B resident: all
      // 128; streamed: warps 0 and 3, as threads 32 and 64 stream B) unpack
      // each tile into the ring's chunks
      const Packed& pa = a.pk;
      const int nthr = L.resident ? kWG : kWG / 2;
      const int ut = L.resident || lt < 32 ? lt : lt - 64;
      // the packed tile at the cursor into stage s: the K and V code runs,
      // then the K scale, K base, V scale and V base rows (stopping at S)
      auto copy_tile = [&](int s, const Cursor& cu) {
        const int s0 = cu.tile * kTile, n = min(kTile, a.S - s0);
        const uint32_t fb = pfull + 8 * s, dst = base + L.pk + s * L.pstage;
        const size_t row = static_cast<size_t>(cu.plane) * a.S + s0;
        mbar_expect_tx(fb, n * (pa.nbk + pa.nbv + 16));
        bulk_load(dst, pa.kc + row * pa.nbk, n * pa.nbk, fb);
        bulk_load(dst + L.pv, pa.vc + row * pa.nbv, n * pa.nbv, fb);
        bulk_load(dst + L.psc, pa.ks + row, n * 4, fb);
        bulk_load(dst + L.psc + kTile * 4, pa.kb + row, n * 4, fb);
        bulk_load(dst + L.psc + 2 * kTile * 4, pa.vs + row, n * 4, fb);
        bulk_load(dst + L.psc + 3 * kTile * 4, pa.vb + row, n * 4, fb);
      };
      Cursor cu{static_cast<int>(blockIdx.x) - static_cast<int>(gridDim.x), 0, 0, 0};
      if (ut == 0)
        for (int s = 0; s < L.npk; ++s) {
          cursor_next(a, cu);
          if (cu.item < a.n_items) copy_tile(s, cu);
        }
      const uint2* utab = reinterpret_cast<const uint2*>(sm + L.utab);
      const float qsub = 128.0f - static_cast<float>(pa.qmin);
      const uint32_t sub = pack_bf16(qsub, qsub);
      int it = 0, pt = 0, kb0 = 0, kb1 = 0;
      for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
        const Item w = item_at(a, item);
        if (L.resident && ut == 0 && w.t1 > w.t0) load_b(0, w.g, kb0), load_b(1, w.g, kb1);
        for (int tile = w.t0; tile < w.t1; ++tile, ++pt) {
          const int ps = pt % L.npk, nvalid = min(kTile, a.S - tile * kTile);
          mbar_wait(pfull + 8 * ps, (pt / L.npk) & 1);
          const uint8_t* stage = sm + L.pk + ps * L.pstage;
          for (int ch = 0; ch < L.nck + L.ncv; ++ch, ++it) {
            const int side = ch >= L.nck, c = side ? ch - L.nck : ch, st = it % L.ns;
            mbar_wait(empty + 8 * st, ((it / L.ns) & 1) ^ 1);
            unpack_chunk(base + st * kChunkBytes, stage + (side ? L.pv : 0),
                         side ? pa.nbv : pa.nbk, utab[(side * 4 + c) * 16 + (ut & 15)], ut,
                         nthr, pa.pbits, sub, nvalid);
            if (c == 0 && ut < kTile) {  // the side's per-token scale and -base
              const float* sc = reinterpret_cast<const float*>(stage + L.psc) + side * 2 * kTile;
              float* ax = aux + st * 2 * kTile;
              ax[ut] = ut < nvalid ? sc[ut] : 0.0f;
              ax[kTile + ut] = ut < nvalid ? -sc[kTile + ut] : 0.0f;
            }
            fence_async_shared();  // the chunk is read by wgmma (the async proxy)
            mbar_arrive(full + 8 * st);
          }
          fence_async_shared();  // the stage's reads are done before a copy refills it
          named_sync(3, nthr);
          if (ut == 0) {
            cursor_next(a, cu);
            if (cu.item < a.n_items) copy_tile(ps, cu);
          }
        }
      }
    } else if (!PK && lt == 0) {
      int it = 0;
      for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
        const Item w = item_at(a, item);
        const int plane = (a.layer * a.B + w.b) * a.G + w.g;
        for (int tile = w.t0; tile < w.t1; ++tile) {
          const int s0 = tile * kTile;
          for (int ch = 0; ch < L.nck + L.ncv; ++ch, ++it) {
            const int st = it % L.ns;
            mbar_wait(empty + 8 * st, ((it / L.ns) & 1) ^ 1);
            const uint32_t fb = full + 8 * st, dst = base + st * kChunkBytes;
            const bool v = ch >= L.nck;
            const int c = v ? ch - L.nck : ch, r = v ? a.rv : a.rk;
            const CUtensorMap* map = v ? &tm_v : &tm_k;
            if (v ? RMV : RMK) {
              mbar_expect_tx(fb, kTile * (v ? L.rows_v : kChunk) * 2);
              tma_load(dst, map, fb, s0, c * kChunk, plane);
            } else {  // the K chunk whole (its k-steps read both boxes), V as far as rv
              const int nbox = !v || r - c * kChunk > 64 ? 2 : 1;
              mbar_expect_tx(fb, nbox * kTile * 128);
              for (int x = 0; x < nbox; ++x)
                tma_load(dst + x * kTile * 128, map, fb, c * kChunk + 64 * x, s0, plane);
            }
          }
        }
      }
    } else if (MODE < kNoLogits && (lt == 32 || lt == 64)) {  // (the modes with no K work: no B)
      int kb = 0;
      for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
        const Item w = item_at(a, item);
        if (w.t1 <= w.t0) continue;
        const int nt = L.resident ? 1 : w.t1 - w.t0;
        for (int t = 0; t < nt; ++t) load_b(lt / 32 - 1, w.g, kb);
      }
    }
    return;
  }
  if constexpr (PK)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg;  // this consumer
  const int wt = tid % kWG, warp = wt / 32, lane = tid % 32;
  const int gq = lane / 4, qd = lane % 4;
  const int ta = 16 * warp + gq;  // this thread's K rows: tokens ta and ta + 8
  const int h0 = c ? a.hsplit : 0, h1 = c ? a.hpg : a.hsplit;  // its q-heads
  const int nhw = h1 - h0;
  // its kv-heads (none in the dissection's modes with no K work)
  const int j0 = h0 / a.rep, j1 = MODE < kNoLogits && h1 > h0 ? (h1 - 1) / a.rep + 1 : j0;
  const int sync_id = 1 + c;
  float* q_s = reinterpret_cast<float*>(sm + L.q) + c * NPW * HD;  // [head][HD] / sqrt(hd)
  float* lg = reinterpret_cast<float*>(sm + L.lg) + c * NPW * kTile;  // [head][kTile]
  float* m_s = reinterpret_cast<float*>(sm + L.stats) + c * (PK ? 4 : 3) * NPW;
  float* l_s = m_s + NPW;
  float* alpha_s = m_s + 2 * NPW;
  float* zs_s = m_s + 3 * NPW;  // PK: each head's sum of P^T . (-base_v)
  const uint32_t p_hi = base + L.p + c * 2 * NPW * 128, p_lo = p_hi + NPW * 128;
  uint8_t* p_sm = sm + L.p + c * 2 * NPW * 128;
  const uint32_t my_bfull = bfull + 8 * c * L.nb, my_bempty = bempty + 8 * c * L.nb;
  const uint32_t my_bslots = base + L.bslots + c * L.nb * L.slot_bytes;

  int it = 0, kb = 0;
  unsigned long long csum = 0;  // kDmaOnly / kNoop: this thread's checksum
  constexpr bool FOLD = NT == 1;  // P^T high and low side by side in one product
  float vacc[MT][8];  // out^T: element 4j + e of block mt is rank 64mt + 16warp + gq (+8 for
                      // e >= 2), column 8j + 2qd + e % 2: head (FOLD: 2qd + e % 2, high
                      // part for j 0, low for j 1)
  for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
    const Item w = item_at(a, item);
    const size_t head0 = static_cast<size_t>(w.b) * nh + static_cast<size_t>(w.g) * a.hpg;
    named_sync(sync_id, kWG);  // the last item's reads of q_s and the statistics are done
    for (int i = wt; i < nhw * HD; i += kWG) {
      const size_t qi = (head0 + h0) * HD + i;
      const float qv = a.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[qi])
                                : static_cast<const float*>(a.q)[qi];
      q_s[i] = qv * a.inv_sqrt_hd;
    }
    if (wt < NPW) {
      m_s[wt] = -1e30f;
      l_s[wt] = 0.0f;
      alpha_s[wt] = 1.0f;
      if (PK) zs_s[wt] = 0.0f;
    }
    named_sync(sync_id, kWG);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 8; ++e) vacc[mt][e] = 0.0f;
    // out^T (rv x heads) = out^T * alpha + V . P^T of the tile whose chunks
    // start at ring index q0, on wgmma m64n16k16: per 16-token k-step, each
    // 64-rank block mt of the 128-rank chunks (A: V from the ring chunk,
    // K-major for rank-major chunks, M-major for seq-major ones) times 16
    // rows of P^T (B: K-major). FOLD (<= 8 heads): rows 0-7 P^T high and
    // 8-15 its low part, one product, and the two column halves add up at
    // the end; else 16 heads, high then low, two products. A product costs
    // about the same at n8 as at n16 (measured), hence the fold. One fixed
    // chain: a block past rv reads some other bytes into accumulator rows
    // that are never written out.
    auto v_product = [&](int q0) {
      if constexpr (MODE == kNoValue) {  // the V chunks waited for and released, no product
        for (int cv = 0; cv < L.ncv; ++cv) {
          const int q = q0 + cv;
          mbar_wait(full + 8 * (q % L.ns), (q / L.ns) & 1);
        }
        for (int cv = 0; cv < L.ncv; ++cv) mbar_arrive(empty + 8 * ((q0 + cv) % L.ns));
        return;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // column 8j + 2qd + e of the accumulators
        const float2 al =
            *reinterpret_cast<const float2*>(alpha_s + (FOLD ? 0 : 8 * j) + 2 * qd);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          vacc[mt][4 * j] *= al.x, vacc[mt][4 * j + 1] *= al.y;
          vacc[mt][4 * j + 2] *= al.x, vacc[mt][4 * j + 3] *= al.y;
        }
      }
      for (int cv = 0; cv < L.ncv; ++cv) {
        const int q = q0 + cv;
        mbar_wait(full + 8 * (q % L.ns), (q / L.ns) & 1);
      }
      uint32_t blk[MT];  // each 64-rank block's first byte
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        blk[mt] = base + ((q0 + mt / 2) % L.ns) * kChunkBytes + (mt % 2) * 8192;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_regs(vacc[mt]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // blocks innermost: consecutive products
#pragma unroll                         // feed different accumulators
        for (int part = 0; part < (FOLD ? 1 : 2); ++part)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            wgmma_v<RMV ? 0 : 1>(vacc[mt],
                                 RMV ? sw128_desc(blk[mt] + kk * 32, 16, 1024)
                                     : sw128_desc(blk[mt] + kk * 2048, 8192, 1024),
                                 sw128_desc((part ? p_lo : p_hi) + kk * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_regs(vacc[mt]);
      for (int cv = 0; cv < L.ncv; ++cv) mbar_arrive(empty + 8 * ((q0 + cv) % L.ns));
    };
    const int kb0 = kb;
    for (int tile = w.t0; tile < w.t1; ++tile, it += L.nck + L.ncv) {
      const int s0 = tile * kTile;
      if constexpr (MODE >= kDmaOnly) {
        // loads only: consumer c folds box c of each of the tile's chunks
        // (a V chunk's second box is loaded only when rv reaches past its
        // first 64 ranks) and both release every chunk
        for (int ch = 0; ch < L.nck + L.ncv; ++ch) {
          const int q = it + ch, cv = ch - L.nck;
          mbar_wait(full + 8 * (q % L.ns), (q / L.ns) & 1);
          if (c == 0 || cv < 0 || a.rv - cv * kChunk > 64)
            csum += fold_box<MODE>(base + (q % L.ns) * kChunkBytes + c * 8192, wt);
          mbar_arrive(empty + 8 * (q % L.ns));
        }
        continue;
      }
      float rcs[HD / 16][2][2], rsn[HD / 16][2][2];  // the tile's rotation (cos, sin)
      rotation<HD>(rcs, rsn, a.inv_freq, static_cast<float>(a.pos_offset + s0 + ta), qd,
                   a.rope_scale);
      for (int ck = 0; ck < L.nck; ++ck)
        mbar_wait(full + 8 * ((it + ck) % L.ns), ((it + ck) / L.ns) & 1);
      if constexpr (MODE == kNoLogits) fake_logits(base, it, L.ns, L.nck, lg, nhw, wt);
      for (int j = j0; j < j1; ++j) {
        float kv[NACC];
        for (int bc = 0; bc < L.nck; ++bc) {  // the 128-rank chunks of B_j
          const int use = L.resident ? kb0 + (j - j0) * L.nck + bc : kb++;
          const int slot = use % L.nb;
          mbar_wait(my_bfull + 8 * slot, (use / L.nb) & 1);  // (resident: done after the first)
          fence_regs(kv);
          wgmma_fence();
          k_chain<HD, RMK>(kv, base + ((it + bc) % L.ns) * kChunkBytes,
                          my_bslots + slot * L.slot_bytes, bc == 0);
          wgmma_commit();
          wgmma_wait0();
          fence_regs(kv);
          if (!L.resident) mbar_arrive(my_bempty + 8 * slot);
        }
        if constexpr (PK)
          k_affine<HD>(kv, a.pk.rsum + (static_cast<size_t>(w.g) * a.nkv + j) * HD,
                       aux + (it % L.ns) * 2 * kTile, ta, qd);
        const float* bias =
            a.kbias ? a.kbias + (static_cast<size_t>(w.g) * a.nkv + j) * HD : nullptr;
        k_finish<HD>(kv, rcs, rsn, bias, q_s, lg, max(h0, j * a.rep) - h0,
                     min(h1, (j + 1) * a.rep) - h0, ta, qd);
      }
      for (int ck = 0; ck < L.nck; ++ck) mbar_arrive(empty + 8 * ((it + ck) % L.ns));
      named_sync(sync_id, kWG);  // every head's logits of the tile are in lg; the last
                                 // tile's V products (their reads of P^T and alpha) are done
      // ---- online softmax, one warp per head; P^T in bf16 high and low
      // parts (a uniform loop: h < NPW as nhw <= NPW). PK: P^T = p scale_v,
      // masked before the scale multiplies, and the offset sum per head, from
      // the side row of the tile's first V chunk
      const float* vx = aux;
      if constexpr (PK) {
        const int q = it + L.nck;
        mbar_wait(full + 8 * (q % L.ns), (q / L.ns) & 1);
        vx = aux + (q % L.ns) * 2 * kTile;
      }
      for (int hb = 0; hb < nhw; hb += 4) {
        const int h = hb + warp;
        const bool hv = h < nhw;
        float x[2], mx = -1e30f;
        bool ok[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int t = lane + 32 * u, s = s0 + t;
          ok[u] = hv && s >= w.vlo && s < w.vhi;
          x[u] = ok[u] ? lg[h * kTile + t] : -1e30f;
          mx = fmaxf(mx, x[u]);
        }
        mx = decode::warp_max(mx);
        const float m_old = m_s[h], m_new = fmaxf(m_old, mx);
        const float alpha = expf(m_old - m_new);
        float sum = 0.0f, zs = 0.0f;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int t = lane + 32 * u;
          const float p = ok[u] ? expf(x[u] - m_new) : 0.0f;
          sum += p;
          const float pv = PK ? (ok[u] ? p * vx[t] : 0.0f) : p;
          const __nv_bfloat16 ph = __float2bfloat16_rn(pv);
          const __nv_bfloat16 pl = __float2bfloat16_rn(pv - __bfloat162float(ph));
          if (PK && ok[u])
            zs = fmaf(__bfloat162float(ph) + __bfloat162float(pl), vx[kTile + t], zs);
          const uint32_t off = h * 128 + ((((t >> 3) ^ (h & 7)) << 4) | ((t & 7) << 1));
          if (hv) {
            *reinterpret_cast<__nv_bfloat16*>(p_sm + off) = ph;
            *reinterpret_cast<__nv_bfloat16*>(p_sm + NPW * 128 + off) = pl;
          }
        }
        sum = decode::warp_sum(sum);
        if (PK) zs = decode::warp_sum(zs);
        if (hv) {  // every lane holds the warp's results
          m_s[h] = m_new;
          l_s[h] = l_s[h] * alpha + sum;
          alpha_s[h] = alpha;
          if (PK) zs_s[h] = zs_s[h] * alpha + zs;
        }
      }
      fence_async_shared();      // P^T is read by wgmma (the async proxy)
      named_sync(sync_id, kWG);  // P^T and alpha are ready
      v_product(it + L.nck);
    }
    if (L.resident && w.t1 > w.t0) {
      const int n = (j1 - j0) * L.nck;
      for (int k = kb0; k < kb0 + n; ++k) mbar_arrive(my_bempty + 8 * (k % L.nb));
      kb = kb0 + n;
    }
    // this item's partials (the statistics are final since the last softmax's barrier);
    // rv read here, so that the stores' rank predicates are not held (and
    // spilled) across the item's tiles
    int rv = a.rv;
    asm volatile("" : "+r"(rv));
    float* part = a.part_acc + ((head0 + h0) * a.splits + w.split) * rv;
    const int hstride = a.splits * rv;
#pragma unroll
    for (int mt = 0; mt < (MODE == kNoValue || MODE >= kDmaOnly ? 0 : MT); ++mt)
#pragma unroll
      for (int j = 0; j < (FOLD ? 1 : 2); ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 64 * mt + 16 * warp + gq + 8 * (e >> 1), hw = 8 * j + 2 * qd + (e & 1);
          const float v = FOLD ? vacc[mt][e] + vacc[mt][4 + e] : vacc[mt][4 * j + e];
          if (r < rv && hw < nhw) part[hw * hstride + r] = PK ? v + zs_s[hw] : v;
        }
    if (MODE < kDmaOnly && wt < nhw) {
      a.part_m[(head0 + h0 + wt) * a.splits + w.split] = m_s[wt];
      a.part_l[(head0 + h0 + wt) * a.splits + w.split] = l_s[wt];
    }
  }
  if constexpr (MODE >= kDmaOnly) {  // the block's checksum: a 64-bit add per warp
    for (int o = 16; o > 0; o >>= 1) csum += __shfl_xor_sync(0xffffffffu, csum, o);
    if (lane == 0) atomicAdd(a.ck, csum);
  }
}

template <int HD, bool RM, int NT, int MT>
__global__ void __launch_bounds__(kThreads, 1)
palu_decode_fp_wg_kernel(const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_b, const Args a) {
  decode_body<HD, RM, RM, NT, MT, false>(tm_k, tm_v, tm_b, a);
}

// the packed seq-major cache (tm_b alone is read)
template <int HD, int NT, int MT>
__global__ void __launch_bounds__(kThreads, 1)
palu_decode_seq_wg_kernel(const __grid_constant__ CUtensorMap tm_b, const Args a) {
  decode_body<HD, false, false, NT, MT, true>(tm_b, tm_b, tm_b, a);
}

// the dissection's modes other than kFull over seq-major latents, one
// 8-head tile a consumer
template <int HD, int MT, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
palu_decode_fp_dissect_kernel(const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_b, const Args a) {
  decode_body<HD, false, false, 1, MT, false, MODE>(tm_k, tm_v, tm_b, a);
}

// the archived v2 layout (K seq-major, V rank-major, one B per q-head), at
// the v2 tool's head dim and one 8-head tile a consumer: the instantiations
// its tool and tests run (each adds to this source's build)
template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
palu_decode_fp_v2_kernel(const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_b, const Args a) {
  decode_body<128, false, true, 1, MT, false>(tm_k, tm_v, tm_b, a);
}

template <int MT>
int launch_v2(int grid, const CUtensorMap (&tm)[3], const Args& a, cudaStream_t st) {
  const int smem = static_cast<int>(a.L.total) + 1024;
  auto kern = palu_decode_fp_v2_kernel<MT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, kThreads, smem, st>>>(tm[0], tm[1], tm[2], a);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int MT, int MODE>
int launch_dissect(int grid, const CUtensorMap (&tm)[3], const Args& a, cudaStream_t st) {
  const int smem = static_cast<int>(a.L.total) + 1024;
  auto kern = palu_decode_fp_dissect_kernel<HD, MT, MODE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, kThreads, smem, st>>>(tm[0], tm[1], tm[2], a);
  return static_cast<int>(cudaGetLastError());
}

// The mode's instantiation at the tool's head dim: the V blocks MT for
// kNoLogits (the only cut mode with V products) 6 up to rv 384 (the Llama
// group's, as palu_decode_fp's instantiation there), else 8; 4 otherwise
// (no V accumulator is used).
int launch_dissect_mode(int mode, int rv, int grid, const CUtensorMap (&tm)[3], const Args& a,
                        cudaStream_t st) {
  switch (mode) {
    case kNoValue: return launch_dissect<128, 4, kNoValue>(grid, tm, a, st);
    case kNoLogits:
      return rv <= 384 ? launch_dissect<128, 6, kNoLogits>(grid, tm, a, st)
                       : launch_dissect<128, 8, kNoLogits>(grid, tm, a, st);
    case kDmaOnly: return launch_dissect<128, 4, kDmaOnly>(grid, tm, a, st);
    default: return launch_dissect<128, 4, kNoop>(grid, tm, a, st);
  }
}

// The dissection's second pass of kNoValue: per (lane, q-head) row, the
// splits' statistics merged, stats[row] = (M, L) with M = max m_s and L =
// sum_s e^(m_s - M) l_s.
__global__ void __launch_bounds__(256) dissect_finish(const float* __restrict__ part_m,
                                                      const float* __restrict__ part_l,
                                                      float* __restrict__ stats, int rows,
                                                      int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const float* m = part_m + static_cast<size_t>(row) * splits;
  const float* l = part_l + static_cast<size_t>(row) * splits;
  float mx = -1e30f;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, m[s]);
  float den = 0.0f;
  for (int s = 0; s < splits; ++s) den += expf(m[s] - mx) * l[s];
  stats[2 * row] = mx;
  stats[2 * row + 1] = den;
}

template <int HD, bool RM, int NT, int MT, bool PK>
int launch(int grid, const CUtensorMap (&tm)[3], const Args& a, cudaStream_t st) {
  const int smem = static_cast<int>(a.L.total) + 1024;
  if constexpr (PK) {
    auto kern = palu_decode_seq_wg_kernel<HD, NT, MT>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, kThreads, smem, st>>>(tm[2], a);
  } else {
    auto kern = palu_decode_fp_wg_kernel<HD, RM, NT, MT>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, kThreads, smem, st>>>(tm[0], tm[1], tm[2], a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for the consumers' heads and rv: NT 1 (<= 8 heads each)
// or 2, and MT 64-rank blocks, 4 (rv <= 256), 6 (NT 1, rv <= 384) or 8.
template <int HD, bool RM, bool PK>
int launch_shape(int nt, int rv, int grid, const CUtensorMap (&tm)[3], const Args& a,
                 cudaStream_t st) {
  if (nt == 1) {
    if (rv <= 256) return launch<HD, RM, 1, 4, PK>(grid, tm, a, st);
    if (rv <= 384) return launch<HD, RM, 1, 6, PK>(grid, tm, a, st);
    return launch<HD, RM, 1, 8, PK>(grid, tm, a, st);
  }
  if (rv <= 256) return launch<HD, RM, 2, 4, PK>(grid, tm, a, st);
  return launch<HD, RM, 2, 8, PK>(grid, tm, a, st);
}

template <int HD>
int launch_hd(bool rm, bool pk, int nt, int rv, int grid, const CUtensorMap (&tm)[3],
              const Args& a, cudaStream_t st) {
  if (pk) return launch_shape<HD, false, true>(nt, rv, grid, tm, a, st);
  return rm ? launch_shape<HD, true, false>(nt, rv, grid, tm, a, st)
            : launch_shape<HD, false, false>(nt, rv, grid, tm, a, st);
}

// The plan and the consumers' q-head split; nbk / nbv > 0: the packed cache.
Plan plan_for(int hd, int rk, int rv, int hpg, int nkv, int* hs_out, int* nt_out, int nbk = 0,
              int nbv = 0) {
  const int hs = head_split(hpg, nkv), rep = hpg / nkv;
  const int nkv0 = hs > 0 ? (hs - 1) / rep + 1 : 0;
  const int nkv1 = hpg > hs ? (hpg - 1) / rep + 1 - hs / rep : 0;
  const int nhw = hs > hpg - hs ? hs : hpg - hs;
  const int nt = nhw > 8 ? 2 : 1;
  if (hs_out) *hs_out = hs;
  if (nt_out) *nt_out = nt;
  return make_plan(hd, rk, rv, nkv0, nkv1, 8 * nt, nbk, nbv);
}

// Bytes per token of one side's codes at pack width pbits (core/quant.packed_nbytes).
int packed_nbytes(int r, int pbits) { return pbits == 3 ? r / 4 + r / 8 : r * pbits / 8; }

// The dissection's plan of `mode` (one B per q-head): palu_decode_fp's, and
// for the modes with no K work the same ring with no B slots.
Plan dissect_plan(int mode, int hd, int rk, int rv, int hpg, int* hs_out, int* nt_out) {
  const Plan p = plan_for(hd, rk, rv, hpg, hpg, hs_out, nt_out);
  if (!p.ok || mode < kNoLogits) return p;
  return make_plan(hd, rk, rv, 0, 0, 8 * *nt_out, 0, 0, p.ns);
}

}  // namespace

// The shared memory a launch at these shapes takes, or -1 when no plan of
// the kernel fits in one block (the wrapper raises then).
extern "C" int palu_decode_fp_wg_smem(int hd, int rk, int rv, int hpg, int nkv) {
  if (nkv <= 0 || hpg % nkv) return -1;
  const Plan p = plan_for(hd, rk, rv, hpg, nkv, nullptr, nullptr);
  return p.ok ? static_cast<int>(p.total) + 1024 : -1;
}

// q (B, nh, hd) bf16 or f32; bk (G, nkv, rk, hd) bf16 with nkv dividing hpg
// = nh / G (q-head h of a group reads kv-head h / (hpg / nkv)); latents xk /
// xv bf16, rank-major (L, B, G, r, S) or seq-major (L, B, G, S, r) (L =
// n_layers, 1 for one layer's buffers; layer picks one); kv_len (B,) int32
// absolute; kbias null or (G, nkv, hd) f32; inv_freq (hd / 2,) f32;
// partials (B, nh, splits) m and l, (B, nh, splits, rv) accumulators; out
// (B, nh, rv) f32, or with m_out / l_out the raw statistics. hd 64 or 128,
// rk a multiple of 16 up to 512, rv a multiple of 8 up to 512, hpg <= 32, S
// a multiple of 8. splits: the
// wrapper's _splits; grid blocks loop over the B * G * splits work items.
extern "C" int palu_decode_fp_wg(const void* q, int q_bf16, const void* bk, const void* xk,
                                 const void* xv, const void* kv_len, const void* kbias,
                                 const void* inv_freq, void* part_m, void* part_l,
                                 void* part_acc, void* out, int B, int G, int hpg, int nkv,
                                 int hd, int rk, int rv, int S, int rank_major, int window,
                                 int splits, int grid, int layer, int n_layers, int pos_offset,
                                 float inv_sqrt_hd, float rope_scale, void* m_out, void* l_out,
                                 void* stream) {
  if ((hd != 64 && hd != 128) || rk % 16 || rv % 8 || rk > kMaxRank || rv > kMaxRank ||
      hpg > kMaxHeads || nkv <= 0 || hpg % nkv || S % 8 || layer < 0 || layer >= n_layers ||
      (m_out == nullptr) != (l_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  int nt = 1;
  a.L = plan_for(hd, rk, rv, hpg, nkv, &a.hsplit, &nt);
  if (!a.L.ok) return static_cast<int>(cudaErrorInvalidValue);
  a.q = q;
  a.q_bf16 = q_bf16;
  a.kbias = static_cast<const float*>(kbias);
  a.inv_freq = static_cast<const float*>(inv_freq);
  a.kv_len = static_cast<const int*>(kv_len);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.part_acc = static_cast<float*>(part_acc);
  a.B = B, a.G = G, a.hpg = hpg, a.nkv = nkv, a.rep = hpg / nkv, a.rk = rk, a.rv = rv, a.S = S;
  a.window = window;
  a.splits = splits, a.n_items = B * G * splits;
  a.layer = layer, a.pos_offset = pos_offset;
  a.inv_sqrt_hd = inv_sqrt_hd, a.rope_scale = rope_scale;
  const uint64_t planes = static_cast<uint64_t>(n_layers) * B * G;
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tm[3];
  bool ok;
  if (rank_major)
    ok = make_map_3d(&tm[0], bf, 2, xk, S, rk, planes, kTile, kChunk, sw) &&
         make_map_3d(&tm[1], bf, 2, xv, S, rv, planes, kTile, a.L.rows_v, sw);
  else
    ok = make_map_3d(&tm[0], bf, 2, xk, rk, S, planes, 64, kTile, sw) &&
         make_map_3d(&tm[1], bf, 2, xv, rv, S, planes, 64, kTile, sw);
  ok = ok && make_map_3d(&tm[2], bf, 2, bk, hd, rk, static_cast<uint64_t>(G) * nkv, 64, kChunk,
                         sw);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = hd == 128 ? launch_hd<128>(rank_major != 0, false, nt, rv, grid, tm, a, st)
                      : launch_hd<64>(rank_major != 0, false, nt, rv, grid, tm, a, st);
  if (err != 0) return err;
  return decode::launch_combine(static_cast<const float*>(part_m),
                                static_cast<const float*>(part_l),
                                static_cast<const float*>(part_acc), static_cast<float*>(out),
                                B * G * hpg, splits, rv, st, static_cast<float*>(m_out),
                                static_cast<float*>(l_out));
}

// The v2 layout's plan (one B per q-head; palu_decode_fp's plan, the same
// 16 KB chunks): out = {smem bytes, ring chunks, B slots per consumer,
// resident, 8-head tiles a consumer}, or out[0] = -1 when no plan fits in
// one block.
extern "C" int palu_decode_fp_v2_plan(int hd, int rk, int rv, int hpg, int* out) {
  int nt = 1;
  const Plan p = plan_for(hd, rk, rv, hpg, hpg, nullptr, &nt);
  out[0] = p.ok ? static_cast<int>(p.total) + 1024 : -1;
  out[1] = p.ns, out[2] = p.nb, out[3] = p.resident, out[4] = nt;
  return 0;
}

// The archived v2 decode over bf16 latents (replaces
// palu_tpu/ops/pallas/archive/palu_decode2.py::palu_flash_decode2, an A/B
// baseline with no product call site): the kernel palu_decode_fp launches,
// with K seq-major and V rank-major (the v2 cache's layouts; the producer
// loads each side's chunks in its own form, K's product reads x_k^T
// K-major and V's reads V K-major). q (B, nh, hd) bf16 or f32, roped at the
// current position; bk (G, hpg, rk, hd) bf16, one B per q-head; xk (B, G,
// S, rk) and xv_t (B, G, rv, S) bf16; kv_len (B,) int32; inv_freq (hd / 2,)
// f32 (the RoPE angle of position s and frequency j is the f32 product s *
// inv_freq[j], cos and sin times rope_scale); partials and out as
// palu_decode_fp_wg. hd 128, rk a multiple of 16 and rv of 8, both up to
// 512, hpg <= 16 (one 8-head tile a consumer), S a multiple of 8; no K
// bias, offset or layer stack.
extern "C" int palu_decode_fp_v2(const void* q, int q_bf16, const void* bk, const void* xk,
                                 const void* xv_t, const void* kv_len, const void* inv_freq,
                                 void* part_m, void* part_l, void* part_acc, void* out, int B,
                                 int G, int hpg, int hd, int rk, int rv, int S, int window,
                                 int splits, int grid, float inv_sqrt_hd, float rope_scale,
                                 void* stream) {
  if (hd != 128 || rk % 16 || rv % 8 || rk <= 0 || rv <= 0 || rk > kMaxRank || rv > kMaxRank ||
      hpg <= 0 || hpg > kWgHeads || S % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  int nt = 1;
  a.L = plan_for(hd, rk, rv, hpg, hpg, &a.hsplit, &nt);
  if (!a.L.ok || nt != 1) return static_cast<int>(cudaErrorInvalidValue);
  a.q = q;
  a.q_bf16 = q_bf16;
  a.inv_freq = static_cast<const float*>(inv_freq);
  a.kv_len = static_cast<const int*>(kv_len);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.part_acc = static_cast<float*>(part_acc);
  a.B = B, a.G = G, a.hpg = hpg, a.nkv = hpg, a.rep = 1, a.rk = rk, a.rv = rv, a.S = S;
  a.window = window;
  a.splits = splits, a.n_items = B * G * splits;
  a.inv_sqrt_hd = inv_sqrt_hd, a.rope_scale = rope_scale;
  const uint64_t planes = static_cast<uint64_t>(B) * G;
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tm[3];
  if (!(make_map_3d(&tm[0], bf, 2, xk, rk, S, planes, 64, kTile, sw) &&
        make_map_3d(&tm[1], bf, 2, xv_t, S, rv, planes, kTile, a.L.rows_v, sw) &&
        make_map_3d(&tm[2], bf, 2, bk, hd, rk, static_cast<uint64_t>(G) * hpg, 64, kChunk, sw)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = rv <= 256   ? launch_v2<4>(grid, tm, a, st)
                  : rv <= 384 ? launch_v2<6>(grid, tm, a, st)
                              : launch_v2<8>(grid, tm, a, st);
  if (err != 0) return err;
  return decode::launch_combine(static_cast<const float*>(part_m),
                                static_cast<const float*>(part_l),
                                static_cast<const float*>(part_acc), static_cast<float*>(out),
                                B * G * hpg, splits, rv, st);
}

// The packed seq-major decode's plan at these shapes (q-heads per group hpg,
// each its own B): out = {smem bytes, ring chunks, B slots per consumer,
// resident, packed stages}, or out[0] = -1 when no plan fits in one block.
extern "C" int palu_decode_seq_wg_plan(int hd, int rk, int rv, int hpg, int pbits, int* out) {
  const Plan p = plan_for(hd, rk, rv, hpg, hpg, nullptr, nullptr, packed_nbytes(rk, pbits),
                          packed_nbytes(rv, pbits));
  out[0] = p.ok ? static_cast<int>(p.total) + 1024 : -1;
  out[1] = p.ns, out[2] = p.nb, out[3] = p.resident, out[4] = p.npk;
  return 0;
}

// q (B, nh, hd) bf16 or f32; bk (G, hpg, rk, hd) bf16 (JAX's repeated form:
// one B per q-head); codes kc (B, G, S, nbk) / vc (B, G, S, nbv) uint8 in
// core/quant.pack_codes' plane packing at pack width pbits (2, 3 or 4);
// per-token ks, kb, vs, vb (B, G, S) f32, x = (code + qmin - base) * scale;
// kv_len (B,) int32; inv_freq (hd / 2,) f32; rsum scratch of G * hpg * hd f32
// (row sums of B); partials and out as palu_decode_fp_wg. hd 64 or 128, rk
// and rv multiples of 32 up to 512, hpg <= 32, S a multiple of 8, every
// buffer 16-byte aligned.
extern "C" int palu_decode_seq_wg(const void* q, int q_bf16, const void* bk, const void* kc,
                                  const void* ks, const void* kb, const void* vc, const void* vs,
                                  const void* vb, const void* kv_len, const void* inv_freq,
                                  void* rsum, void* part_m, void* part_l, void* part_acc,
                                  void* out, int B, int G, int hpg, int hd, int rk, int rv, int S,
                                  int pbits, int qmin, int window, int splits, int grid,
                                  float inv_sqrt_hd, float rope_scale, void* stream) {
  if ((hd != 64 && hd != 128) || rk % 32 || rv % 32 || rk <= 0 || rv <= 0 || rk > kMaxRank ||
      rv > kMaxRank || hpg <= 0 || hpg > kMaxHeads || S % 8 ||
      (pbits != 2 && pbits != 3 && pbits != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  int nt = 1;
  a.pk.nbk = packed_nbytes(rk, pbits), a.pk.nbv = packed_nbytes(rv, pbits);
  a.L = plan_for(hd, rk, rv, hpg, hpg, &a.hsplit, &nt, a.pk.nbk, a.pk.nbv);
  if (!a.L.ok) return static_cast<int>(cudaErrorInvalidValue);
  a.q = q;
  a.q_bf16 = q_bf16;
  a.inv_freq = static_cast<const float*>(inv_freq);
  a.kv_len = static_cast<const int*>(kv_len);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.part_acc = static_cast<float*>(part_acc);
  a.B = B, a.G = G, a.hpg = hpg, a.nkv = hpg, a.rep = 1, a.rk = rk, a.rv = rv, a.S = S;
  a.window = window;
  a.splits = splits, a.n_items = B * G * splits;
  a.inv_sqrt_hd = inv_sqrt_hd, a.rope_scale = rope_scale;
  a.pk.kc = static_cast<const uint8_t*>(kc);
  a.pk.vc = static_cast<const uint8_t*>(vc);
  a.pk.ks = static_cast<const float*>(ks);
  a.pk.kb = static_cast<const float*>(kb);
  a.pk.vs = static_cast<const float*>(vs);
  a.pk.vb = static_cast<const float*>(vb);
  a.pk.rsum = static_cast<const float*>(rsum);
  a.pk.pbits = pbits, a.pk.qmin = qmin;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = decode::launch_rowsum(static_cast<const __nv_bfloat16*>(bk),
                                  static_cast<float*>(rsum), G * hpg, 1, rk, hd, st);
  if (err != 0) return err;
  CUtensorMap tm[3];
  if (!make_map_3d(&tm[2], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, bk, hd, rk,
                   static_cast<uint64_t>(G) * hpg, 64, kChunk, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  tm[0] = tm[1] = tm[2];
  err = hd == 128 ? launch_hd<128>(false, true, nt, rv, grid, tm, a, st)
                  : launch_hd<64>(false, true, nt, rv, grid, tm, a, st);
  if (err != 0) return err;
  return decode::launch_combine(static_cast<const float*>(part_m),
                                static_cast<const float*>(part_l),
                                static_cast<const float*>(part_acc), static_cast<float*>(out),
                                B * G * hpg, splits, rv, st);
}

// The dissection's plan (the tool's mirror is held against it): out = {smem
// bytes, ring chunks, B slots per consumer, resident, 8-head tiles a
// consumer}, or out[0] = -1 when no plan fits in one block.
extern "C" int palu_decode_fp_dissect_plan(int mode, int hd, int rk, int rv, int hpg, int* out) {
  int hs = 0, nt = 1;
  const Plan p = dissect_plan(mode, hd, rk, rv, hpg, &hs, &nt);
  out[0] = p.ok ? static_cast<int>(p.total) + 1024 : -1;
  out[1] = p.ns, out[2] = p.nb, out[3] = p.resident, out[4] = nt;
  return 0;
}

// The dissection's modes 1-4 (kNoValue, kNoLogits, kDmaOnly, kNoop; kFull is
// palu_decode_fp_wg itself) of the kernel over seq-major bf16 latents, at
// palu_decode_fp's splits: q (B, nh, hd) bf16 or f32; bk (G, hpg, rk, hd)
// bf16; xk (B, G, S, rk), xv (B, G, S, rv) bf16; kv_len (B,) int32;
// inv_freq (hd / 2,) f32; partials as palu_decode_fp_wg. kNoLogits writes
// out (B, nh, rv) f32, kNoValue stats (B, nh, 2) f32 = (m, l), kDmaOnly and
// kNoop the checksum ck (one u64). hd 128 (the tool's), rk a multiple of 16
// and rv of 8 up to 512, hpg <= 16 (one 8-head tile a consumer), S a
// multiple of 8; no bias, window or offset.
extern "C" int palu_decode_fp_dissect(int mode, const void* q, int q_bf16, const void* bk,
                                      const void* xk, const void* xv, const void* kv_len,
                                      const void* inv_freq, void* part_m, void* part_l,
                                      void* part_acc, void* out, void* stats, void* ck, int B,
                                      int G, int hpg, int hd, int rk, int rv, int S, int splits,
                                      int grid, float inv_sqrt_hd, void* stream) {
  if (mode < kNoValue || mode > kNoop || hd != 128 || rk % 16 || rv % 8 ||
      rk > kMaxRank || rv > kMaxRank || hpg <= 0 || hpg > kMaxHeads || S % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  int nt = 1;
  a.L = dissect_plan(mode, hd, rk, rv, hpg, &a.hsplit, &nt);
  if (!a.L.ok || nt != 1) return static_cast<int>(cudaErrorInvalidValue);
  a.q = q;
  a.q_bf16 = q_bf16;
  a.inv_freq = static_cast<const float*>(inv_freq);
  a.kv_len = static_cast<const int*>(kv_len);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.part_acc = static_cast<float*>(part_acc);
  a.ck = static_cast<unsigned long long*>(ck);
  a.B = B, a.G = G, a.hpg = hpg, a.nkv = hpg, a.rep = 1, a.rk = rk, a.rv = rv, a.S = S;
  a.splits = splits, a.n_items = B * G * splits;
  a.inv_sqrt_hd = inv_sqrt_hd, a.rope_scale = 1.0f;
  const uint64_t planes = static_cast<uint64_t>(B) * G;
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tm[3];
  if (!(make_map_3d(&tm[0], bf, 2, xk, rk, S, planes, 64, kTile, sw) &&
        make_map_3d(&tm[1], bf, 2, xv, rv, S, planes, 64, kTile, sw) &&
        make_map_3d(&tm[2], bf, 2, bk, hd, rk, static_cast<uint64_t>(G) * hpg, 64, kChunk, sw)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode >= kDmaOnly) {
    const cudaError_t e = cudaMemsetAsync(ck, 0, sizeof(unsigned long long), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int err = launch_dissect_mode(mode, rv, grid, tm, a, st);
  if (err != 0 || mode >= kDmaOnly) return err;
  const int rows = B * G * hpg;
  if (mode == kNoLogits)
    return decode::launch_combine(static_cast<const float*>(part_m),
                                  static_cast<const float*>(part_l),
                                  static_cast<const float*>(part_acc), static_cast<float*>(out),
                                  rows, splits, rv, st);
  dissect_finish<<<(rows + 255) / 256, 256, 0, st>>>(static_cast<const float*>(part_m),
                                                     static_cast<const float*>(part_l),
                                                     static_cast<float*>(stats), rows, splits);
  return static_cast<int>(cudaGetLastError());
}
