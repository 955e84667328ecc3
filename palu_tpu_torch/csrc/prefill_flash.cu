// Causal flash attention for chunked prefill with an absolute query offset,
// a per-lane kv length, GQA and an optional sliding window.
//
// Replaces: palu_tpu/ops/pallas/prefill_flash.py::prefill_flash (body
// _make_kernel), in its exp2 form: logits carry log2(e) / sqrt(hd), the
// softmax runs in base 2, and the output is acc / max(l, 1e-30).
//
// Bound on this card: operations. A 512-row chunk at offset 3584 of the 7B
// shapes does 4 * hd flops per (query, key) pair and head, 32 GFLOP over
// 75 MB of q, K, V and output, some 430 flops per byte, above the card's
// ~295 bf16 flops per byte. So both products run on the tensor cores, by
// Hopper's warpgroup MMA (wgmma, bf16 in, f32 accumulate), and the logits,
// probabilities and output accumulator never leave registers.
//
// Design. A block owns 128 (query row, q-head) pairs of one kv head and
// lane: the q-heads that read kv head h (h * nh / nkv .. + nh / nkv - 1)
// times a run of query rows, flattened row-major into the M dimension, so
// each K/V tile is read once per kv head and not once per q-head (Qwen2-7B
// puts 7 q-heads of ~18 rows in a block). Three warpgroups: two consumers
// own 64 pairs each; a producer warp streams 128-key K and V tiles by TMA
// (cp.async.bulk.tensor, 128-byte swizzle, hd split in 64-column boxes)
// into a ring of 2 stages, completed on mbarriers, and each consumer
// releases a stage by an arrive on its `empty` mbarrier. Q is loaded once
// into the same swizzled layout. S = Q K^T is one m64n128k16 wgmma per 16
// of hd with both operands in shared memory; the f32 logits' accumulator
// layout is the A-operand register layout of the next product, so P goes
// to bf16 in registers and O += P V is m64n(hd)k16 wgmma with V read
// transposed (MN-major) from shared memory. One consumer's softmax runs
// while the other's products occupy the tensor cores. The block walks key
// tiles from the window's first tile to min(kv_len, its last position + 1):
// tiles wholly outside are never loaded; a consumer skips the tiles its own
// pairs cannot see, and masks only the tiles that cross the causal
// diagonal, kv_len or the window edge. TMA fills zeros past S only, and the
// cache may hold anything at or past kv_len, so the tile that crosses
// kv_len has those V rows zeroed before its P V product.
//
// Occupancy: 160 KB of shared memory at hd 128 (Q 32 KB, 2 stages of K and
// V at 64 KB), one block per SM; a 512-row chunk of 32 MHA heads is 128
// blocks, one wave on the 132 SMs, each with ~30 key tiles at offset 3584.
// Smaller tiles (64 pairs) would double the blocks and halve the reuse of
// each K/V tile; 128 keys per tile give the n128 wgmma shape, which keeps
// the shared-memory reads of the operands under the tensor cores' rate.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;       // (row, q-head) pairs per block
constexpr int kBK = 128;       // keys per tile
constexpr int kStages = 2;     // K/V ring depth
constexpr int kConsumers = 2;  // consumer warpgroups of 64 pairs
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kRowBytes = 128;  // one 128-byte swizzle row: 64 bf16

struct PrefillArgs {
  const __nv_bfloat16* q;  // (B, nh, Cq, hd)
  __nv_bfloat16* out;      // (B, nh, Cq, hd)
  const int* q_offset;     // (B,)
  const int* kv_len;       // (B,)
  int nh, nkv, cq, S, window;
  float scale_log2;        // log2(e) / sqrt(hd)
};

// Shared memory, from a 1024-byte aligned base: Q as hd / 64 buffers of
// kBM rows x 128 bytes; per stage K then V, each hd / 64 buffers of kBK
// rows x 128 bytes; then the full and empty mbarriers.
template <int HD>
struct Layout {
  static constexpr int kChunks = HD / 64;
  static constexpr int kQBytes = kBM * HD * 2;
  static constexpr int kTileBytes = kBK * HD * 2;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  static constexpr int kBytes = kBarOffset + 16 * kStages + 1024;  // + alignment slack
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 128, f32) = A (64 x 16, K-major in shared memory) . B (16 x 128,
// K-major in shared memory) (+ d when scale_d != 0)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HD == 128) {
    wgmma_rs_n128(o, a, db, 1);
  } else {
    wgmma_rs_n64(o, a, db, 1);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
prefill_flash_kernel(const __grid_constant__ CUtensorMap tmk,
                     const __grid_constant__ CUtensorMap tmv, PrefillArgs a) {
  using L = Layout<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t q_s = base;
  const uint32_t kv_s = base + L::kQBytes;
  const uint32_t full = base + L::kBarOffset;  // kStages mbarriers of 8 bytes
  const uint32_t empty = full + 8 * kStages;

  const int rep = a.nh / a.nkv;
  const int pairs = a.cq * rep;  // (row, q-head) pairs of one kv head
  const int tile = gridDim.x - 1 - blockIdx.x;  // the latest rows (most keys) first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int f0 = tile * kBM;
  const int f_last = min(f0 + kBM, pairs) - 1;
  const int q_off = a.q_offset[b];
  const int kvl = min(a.kv_len[b], a.S);
  const int pos_lo = q_off + f0 / rep, pos_hi = q_off + f_last / rep;
  int lo = a.window > 0 ? max(0, pos_lo - a.window + 1) : 0;
  lo = lo / kBK * kBK;
  const int hi = min(kvl, pos_hi + 1);
  const int ntiles = hi > lo ? (hi - lo + kBK - 1) / kBK : 0;

  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kConsumerThreads) {
      const int zc = b * a.nkv + kvh;
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % kStages;
        mbar_wait(empty + 8 * st, ((it / kStages) & 1) ^ 1);
        const uint32_t fb = full + 8 * st;
        mbar_expect_tx(fb, 2 * L::kTileBytes);
        const uint32_t ks = kv_s + st * L::kStageBytes, vs = ks + L::kTileBytes;
        const int k0 = lo + it * kBK;
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load(ks + c * kBK * kRowBytes, &tmk, fb, c * 64, k0, zc);
          tma_load(vs + c * kBK * kRowBytes, &tmv, fb, c * 64, k0, zc);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wt = tid % 128, lane = tid % 32;
    const int g = lane / 4, qd = lane % 4;

    // Q: the block's pairs into the swizzled layout (16-byte unit u of row
    // m at m * 128 + (u ^ (m % 8)) * 16); pairs past the chunk are zero
    for (int i = tid; i < kBM * (HD / 8); i += kConsumerThreads) {
      const int m = i / (HD / 8), u16 = i % (HD / 8);
      const int f = f0 + m;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (f < pairs) {
        const int row = f / rep, head = kvh * rep + f % rep;
        v = *reinterpret_cast<const uint4*>(
            a.q + ((static_cast<size_t>(b) * a.nh + head) * a.cq + row) * HD + u16 * 8);
      }
      *reinterpret_cast<uint4*>(sm + (u16 / 8) * kBM * kRowBytes + m * kRowBytes +
                                (((u16 % 8) ^ (m & 7)) * 16)) = v;
    }
    fence_async_shared();
    named_sync(1, kConsumerThreads);

    // this thread's two pairs (rows g and g + 8 of its warp) and this
    // warpgroup's position range
    const int fa = f0 + wg * 64 + (wt / 32) * 16 + g, fb = fa + 8;
    const bool va = fa < pairs, vb = fb < pairs;
    const int pa_pos = q_off + (va ? fa : f_last) / rep;
    const int pb_pos = q_off + (vb ? fb : f_last) / rep;
    const int wf0 = f0 + wg * 64;
    const bool wg_any = wf0 < pairs;
    const int wf1 = min(wf0 + 64, pairs) - 1;
    const int wpos_lo = q_off + wf0 / rep, wpos_hi = q_off + wf1 / rep;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
    float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F, l_a = 0.0f, l_b = 0.0f;
    const float c = a.scale_log2;

    for (int it = 0; it < ntiles; ++it) {
      const int st = it % kStages;
      const int k0 = lo + it * kBK;
      mbar_wait(full + 8 * st, (it / kStages) & 1);
      const uint32_t ks = kv_s + st * L::kStageBytes, vs = ks + L::kTileBytes;
      if (k0 + kBK > kvl) {
        // zero the V rows at or past kv_len (block-uniform: both consumers)
        if (wg == 0) {
          const int r0 = max(0, kvl - k0);
          uint8_t* vp = sm + (vs - base);
          for (int i = wt; i < (kBK - r0) * 8 * L::kChunks; i += 128) {
            const int cc = i / ((kBK - r0) * 8), r = i % ((kBK - r0) * 8);
            *reinterpret_cast<uint4*>(vp + cc * kBK * kRowBytes + (r0 + r / 8) * kRowBytes +
                                      (r % 8) * 16) = make_uint4(0, 0, 0, 0);
          }
          fence_async_shared();
        }
        named_sync(1, kConsumerThreads);
      }
      const bool skip = !wg_any || k0 > wpos_hi ||
                        (a.window > 0 && k0 + kBK - 1 <= wpos_lo - a.window);
      if (!skip) {
        // S (64 x 128 keys) = Q K^T
        float s[64];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t cq_off = (kk / 4) * kBM * kRowBytes + wg * 64 * kRowBytes + (kk % 4) * 32;
          const uint32_t ck_off = (kk / 4) * kBK * kRowBytes + (kk % 4) * 32;
          wgmma_ss_n128(s, sw128_desc(q_s + cq_off, 16, 1024), sw128_desc(ks + ck_off, 16, 1024),
                        kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(s);

        // mask where the tile crosses the diagonal, kv_len or the window;
        // element 4j + e: row g (e < 2) or g + 8, key k0 + 8j + 2qd + e % 2
        const bool inside = k0 + kBK - 1 <= wpos_lo && k0 + kBK <= kvl &&
                            (a.window <= 0 || k0 > wpos_hi - a.window);
        if (!inside) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + 8 * j + 2 * qd + (e & 1);
              const int pos = e < 2 ? pa_pos : pb_pos;
              const bool ok = key <= pos && key < kvl && (a.window <= 0 || key > pos - a.window);
              s[4 * j + e] = ok ? s[4 * j + e] : -CUDART_INF_F;
            }
        }
        float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
          mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
        const float mn_a = fmaxf(m_a, mx_a * c), mn_b = fmaxf(m_b, mx_b * c);
        // a row with no visible key so far keeps max -inf: exponents relative to 0
        const float ua = mn_a == -CUDART_INF_F ? 0.0f : mn_a;
        const float ub = mn_b == -CUDART_INF_F ? 0.0f : mn_b;
        const float al_a = ex2(m_a - ua), al_b = ex2(m_b - ub);
        m_a = mn_a;
        m_b = mn_b;
        float sum_a = 0.0f, sum_b = 0.0f;
        uint32_t p[8][4];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          float e[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            e[i] = ex2(fmaf(s[8 * kk + i], c, -((i & 2) ? ub : ua)));
          }
          sum_a += e[0] + e[1] + e[4] + e[5];
          sum_b += e[2] + e[3] + e[6] + e[7];
          p[kk][0] = pack_bf16(e[0], e[1]);
          p[kk][1] = pack_bf16(e[2], e[3]);
          p[kk][2] = pack_bf16(e[4], e[5]);
          p[kk][3] = pack_bf16(e[6], e[7]);
        }
        l_a = l_a * al_a + sum_a;  // per-lane partial sums; the quad adds them at the end
        l_b = l_b * al_b + sum_b;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          o[4 * j] *= al_a;
          o[4 * j + 1] *= al_a;
          o[4 * j + 2] *= al_b;
          o[4 * j + 3] *= al_b;
        }

        // O (64 x hd) += P (64 x 128 keys) V: V MN-major, its hd / 64
        // column buffers kBK * 128 bytes apart
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_pv<HD>(o, p[kk], sw128_desc(vs + kk * 16 * kRowBytes, kBK * kRowBytes, 1024));
        wgmma_commit();
        wgmma_wait0();
        fence_regs(o);
      }
      mbar_arrive(empty + 8 * st);
    }

    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
    if (va) {
      __nv_bfloat16* ob = a.out + ((static_cast<size_t>(b) * a.nh + kvh * rep + fa % rep) * a.cq +
                                   fa / rep) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(ob + 8 * j + 2 * qd) =
            pack_bf16(o[4 * j] / den_a, o[4 * j + 1] / den_a);
    }
    if (vb) {
      __nv_bfloat16* ob = a.out + ((static_cast<size_t>(b) * a.nh + kvh * rep + fb % rep) * a.cq +
                                   fb / rep) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(ob + 8 * j + 2 * qd) =
            pack_bf16(o[4 * j + 2] / den_b, o[4 * j + 3] / den_b);
    }
  }
}

// (hd, S, B * nkv) bf16, boxes of 64 x kBK x 1, 128-byte swizzle, zeros
// past the tensor's edge.
bool make_map(CUtensorMap* map, const void* ptr, int hd, int S, int z) {
  return hopper::make_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, hd, S, z, 64, kBK,
                             CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int HD>
int launch(dim3 grid, const CUtensorMap& mk, const CUtensorMap& mv, const PrefillArgs& a,
           cudaStream_t st) {
  const int smem = Layout<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(prefill_flash_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  prefill_flash_kernel<HD><<<grid, kThreads, smem, st>>>(mk, mv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, nh, Cq, hd), k/v (B, nkv, S, hd), out (B, nh, Cq, hd): bf16,
// contiguous, 16-byte aligned; hd is 64 or 128. q_offset / kv_len: (B,)
// int32. window <= 0: none.
extern "C" int palu_prefill_flash(const void* q, const void* k, const void* v, void* out,
                                  const void* q_offset, const void* kv_len, int B, int nh,
                                  int nkv, int cq, int S, int hd, int window,
                                  float scale_log2, void* stream) {
  if ((hd != 64 && hd != 128) || nkv <= 0 || nh % nkv)
    return static_cast<int>(cudaErrorInvalidValue);
  PrefillArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.q_offset = static_cast<const int*>(q_offset);
  a.kv_len = static_cast<const int*>(kv_len);
  a.nh = nh;
  a.nkv = nkv;
  a.cq = cq;
  a.S = S;
  a.window = window;
  a.scale_log2 = scale_log2;
  CUtensorMap mk, mv;
  if (!make_map(&mk, k, hd, S, B * nkv) || !make_map(&mv, v, hd, S, B * nkv))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((cq * (nh / nkv) + kBM - 1) / kBM, nkv, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd == 128 ? launch<128>(grid, mk, mv, a, st) : launch<64>(grid, mk, mv, a, st);
}
