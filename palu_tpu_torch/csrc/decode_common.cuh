// Shared pieces of the latent decode kernels (palu_decode_exact.cu and
// palu_decode_i8.cu over the rank-major packed cache and the v3 one,
// palu_decode_fp_wg.cu over the unquantized caches, v2's among them, and
// the seq-major packed one) and of the tools' kernels: async copies,
// ldmatrix and bf16 mma.sync wrappers, warp reductions, the work items'
// tiles, the row sums of B, and the kernel that combines the
// split-sequence partials.
//
// The split pass writes, per (lane, q-head) row and split s, the running
// max m_s, the softmax denominator l_s and the unnormalised latent
// accumulator acc_s (rv values); the combine kernel merges the splits with
// the usual rescaling: out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s,
// or hands out the numerator, M and the denominator (return_stats).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode {

constexpr size_t kSmemMax = 232448;  // 227 KB, the most one block may use

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Four 8x8 bf16 tiles from shared memory, not transposed.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// sin and cos of an f32 angle, branch-free (sincosf branches, which keeps
// its instances from overlapping): x - j pi/2 by a three-part Cody-Waite
// reduction with fused multiply-adds (accurate for |j| < 2^22), then
// minimax polynomials on [-pi/4, pi/4] (Cephes' sinf / cosf), ~2 ulp.
__device__ __forceinline__ void sincos_fast(float x, float& sn, float& cs) {
  const float j = rintf(x * 0x1.45f306p-1f);  // 2 / pi
  float r = fmaf(j, -0x1.921fb6p+0f, x);      // pi/2 in three parts
  r = fmaf(j, 0x1.777a5cp-25f, r);
  r = fmaf(j, 0x1.ee59dap-50f, r);
  const float r2 = r * r;
  const float s = fmaf(r * r2, fmaf(r2, fmaf(r2, -1.9515295891e-4f, 8.3321608736e-3f),
                                     -1.6666654611e-1f), r);
  const float c = fmaf(r2 * r2, fmaf(r2, fmaf(r2, 2.443315711809948e-5f, -1.388731625493765e-3f),
                                     4.166664568298827e-2f), fmaf(r2, -0.5f, 1.0f));
  const int q = static_cast<int>(j) & 3;
  const float a = (q & 1) ? c : s, b = (q & 1) ? s : c;
  sn = (q & 2) ? -a : a;
  cs = ((q + 1) & 2) ? -b : b;
}

// The work item of a one-wave decode: lane b's valid columns [vlo, vhi)
// (kv_len and the window in column coordinates: column t is absolute
// position pos_offset + t, so a shard past kv_len has none) and the tiles
// [t0, t1) of split `split` of `splits`, which cut the lane's valid tiles
// (not the buffer's S) into runs of ceil(valid tiles / splits): every valid
// tile falls in exactly one split; a split past them is empty (t1 <= t0).
// ops/palu_decode.py::_item_tiles is the same function in Python.
struct TileRange {
  int t0, t1, vlo, vhi;
};

__device__ __forceinline__ TileRange tile_range(int kv_len, int pos_offset, int window, int S,
                                                int splits, int split, int tile) {
  TileRange r;
  const int kvl = kv_len - pos_offset;
  r.vlo = window > 0 ? max(0, kvl - window) : 0;
  r.vhi = max(0, min(kvl, S));
  const int lo = r.vlo / tile, n = max(0, (r.vhi + tile - 1) / tile - lo);
  const int per = (n + splits - 1) / splits;
  r.t0 = lo + split * per;
  r.t1 = min(r.t0 + per, lo + n);
  return r;
}

// One block per (lane-head, 128 ranks): merge the splits' (m, l, acc).
// STATS writes the raw statistics instead of their quotient: out the
// accumulator sum_s e^(m_s - M) acc_s, m_out the running max M and l_out
// the denominator sum_s e^(m_s - M) l_s, as a sequence shard hands them to
// the cross-shard combine. A row with no valid column in any split keeps
// m = -1e30, l = 0 and acc = 0 there (the normalised quotient is 0 / 0).
template <bool STATS>
__global__ void __launch_bounds__(128) combine_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, float* __restrict__ out, int splits, int rv,
    float* __restrict__ m_out, float* __restrict__ l_out) {
  extern __shared__ float wgt[];  // [splits] exp(m_s - max m)
  __shared__ float den_s;
  const size_t bh = blockIdx.x;
  const float* m = part_m + bh * splits;
  const float* l = part_l + bh * splits;
  if (threadIdx.x < 32) {
    float mx = -1e30f;
    for (int s = threadIdx.x; s < splits; s += 32) mx = fmaxf(mx, m[s]);
    mx = warp_max(mx);
    float den = 0.0f;
    for (int s = threadIdx.x; s < splits; s += 32) {
      const float w = expf(m[s] - mx);
      wgt[s] = w;
      den += w * l[s];
    }
    den = warp_sum(den);
    if (threadIdx.x == 0) {
      den_s = den;
      if (STATS && blockIdx.y == 0) {
        m_out[bh] = mx;
        l_out[bh] = den;
      }
    }
  }
  __syncthreads();
  const int r = blockIdx.y * 128 + threadIdx.x;
  if (r >= rv) return;
  float num = 0.0f;
  for (int s = 0; s < splits; ++s) num += wgt[s] * part_acc[(bh * splits + s) * rv + r];
  out[bh * rv + r] = STATS ? num : num / den_s;
}

// Row sums of B per scale chunk, the zero or base term's factor of the
// packed decodes: rs[gj][c][d] = sum over the gs ranks of chunk c of
// B[gj][r][d], in f32 (gj: a (group, kv-head) pair of bk (G, nkv, rk, hd)).
static __global__ void rowsum_kernel(const __nv_bfloat16* __restrict__ bk, float* __restrict__ rs,
                                     int rk, int gs, int hd) {
  const int gj = blockIdx.x, c = blockIdx.y, d = threadIdx.x;
  const __nv_bfloat16* src = bk + (static_cast<size_t>(gj) * rk + c * gs) * hd + d;
  float s = 0.0f;
  for (int r = 0; r < gs; ++r) s += __bfloat162float(src[static_cast<size_t>(r) * hd]);
  rs[(static_cast<size_t>(gj) * gridDim.y + c) * hd + d] = s;
}

// Launch rowsum_kernel over n_gj (group, kv-head) pairs of B in nsc chunks
// of rk / nsc ranks; returns the launch error.
inline int launch_rowsum(const __nv_bfloat16* bk, float* rs, int n_gj, int nsc, int rk, int hd,
                         cudaStream_t st) {
  rowsum_kernel<<<dim3(n_gj, nsc), hd, 0, st>>>(bk, rs, rk, rk / nsc, hd);
  return static_cast<int>(cudaGetLastError());
}

// Launch the combine over `rows` (lane, q-head) rows, normalised or (m_out
// and l_out given) raw; returns the launch error.
inline int launch_combine(const float* part_m, const float* part_l, const float* part_acc,
                          float* out, int rows, int splits, int rv, cudaStream_t st,
                          float* m_out = nullptr, float* l_out = nullptr) {
  const dim3 grid(rows, (rv + 127) / 128);
  const size_t smem = sizeof(float) * splits;
  if (m_out != nullptr)
    combine_kernel<true><<<grid, 128, smem, st>>>(part_m, part_l, part_acc, out, splits, rv,
                                                  m_out, l_out);
  else
    combine_kernel<false><<<grid, 128, smem, st>>>(part_m, part_l, part_acc, out, splits, rv,
                                                   nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace decode
