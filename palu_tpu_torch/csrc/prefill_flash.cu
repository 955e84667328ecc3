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
// ~295 bf16 flops per byte. So both products run on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate) and the logits,
// probabilities and output accumulator never leave registers.
//
// Design: one block of 4 warps per (64-row query tile, q-head, lane); q-head
// h reads kv head h * nkv / nh. Each warp owns 16 query rows and keeps
// their Q fragments, the (16 x 64) logits of the current key tile and the
// (16 x hd) f32 output in registers, in the mma.sync fragment layout:
// the logits' accumulator layout is the A-operand layout of the P V
// product, so probabilities go from one product to the next without
// shared memory. Row max and sum need only the 4 lanes of a quad. The
// block walks 64-key tiles from the window's first tile up to
// min(kv_len, last query position + 1), so tiles past the causal edge or
// past kv_len are never read; K and V tiles sit in shared memory with
// padded rows (conflict-free fragment loads; V through ldmatrix.trans),
// double-buffered with cp.async so the next tile loads during this one's
// products. Keys at or past kv_len load as zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kBQ = 16 * kWarps;  // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;           // bf16 per shared row past hd (16 bytes)

struct PrefillArgs {
  const __nv_bfloat16* q;  // (B, nh, Cq, hd)
  const __nv_bfloat16* k;  // (B, nkv, S, hd)
  const __nv_bfloat16* v;
  __nv_bfloat16* out;      // (B, nh, Cq, hd)
  const int* q_offset;     // (B,)
  const int* kv_len;       // (B,)
  int nh, nkv, cq, S, window;
  float scale_log2;        // log2(e) / sqrt(hd)
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// Four transposed 8x8 bf16 tiles from shared memory (row addresses per lane).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes global -> shared without passing through registers; with
// valid == false the destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying a K and a V tile (kBK rows of HD) at src offset kv_off into
// shared rows of stride HD + kPad; rows at or past n_valid are zero-filled.
template <int HD>
__device__ __forceinline__ void load_kv_async(__nv_bfloat16* k_dst, __nv_bfloat16* v_dst,
                                              const PrefillArgs& a, size_t kv_off,
                                              int n_valid, int tid) {
  constexpr int vpr = HD / 8;
  for (int i = tid; i < kBK * vpr; i += kThreads) {
    const int row = i / vpr, c = i % vpr;
    const bool valid = row < n_valid;
    const size_t src = kv_off + (valid ? static_cast<size_t>(row) * HD + c * 8 : 0);
    cp_async16(k_dst + row * (HD + kPad) + c * 8, a.k + src, valid);
    cp_async16(v_dst + row * (HD + kPad) + c * 8, a.v + src, valid);
  }
  cp_async_commit();
}

// rows x HD bf16 from src (row stride HD) into dst (row stride HD + kPad),
// 16 bytes per load; rows at or past nrows_valid are zero.
template <int HD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int rows, int nrows_valid, int tid) {
  constexpr int vpr = HD / 8;
  for (int i = tid; i < rows * vpr; i += kThreads) {
    const int row = i / vpr, c = i % vpr;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < nrows_valid)
      val = reinterpret_cast<const uint4*>(src + static_cast<size_t>(row) * HD)[c];
    reinterpret_cast<uint4*>(dst + row * (HD + kPad))[c] = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) prefill_flash_kernel(PrefillArgs a) {
  constexpr int HS = HD + kPad;  // shared row stride
  constexpr int KS = HD / 16;    // k-steps over hd
  constexpr int NO = HD / 8;     // output n-tiles
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group / column pair
  const int kvh = h * a.nkv / a.nh;
  const int row0 = qt * kBQ;

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [kBQ][HS]
  // two K/V tile buffers, each [kBK][HS] K then [kBK][HS] V: the next
  // tile loads while this one is used
  __nv_bfloat16* kv_s = q_s + kBQ * HS;
  constexpr int kBuf = 2 * kBK * HS;

  const int q_off = a.q_offset[b];
  const int kvl = min(a.kv_len[b], a.S);
  const int rows_valid = min(kBQ, a.cq - row0);
  const __nv_bfloat16* qb = a.q + ((static_cast<size_t>(b) * a.nh + h) * a.cq + row0) * HD;
  load_rows<HD>(q_s, qb, kBQ, rows_valid, tid);
  __syncthreads();

  // this warp's Q fragments, kept for the whole kernel
  const int wr = warp * 16;
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const __nv_bfloat16* r0 = q_s + (wr + g) * HS + ks * 16 + 2 * t;
    const __nv_bfloat16* r1 = r0 + 8 * HS;
    qf[ks][0] = lds32(r0);
    qf[ks][1] = lds32(r1);
    qf[ks][2] = lds32(r0 + 8);
    qf[ks][3] = lds32(r1 + 8);
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_a = -1e30f, m_b = -1e30f, l_a = 0.0f, l_b = 0.0f;  // rows g and g + 8
  const int qpos_a = q_off + row0 + wr + g, qpos_b = qpos_a + 8;

  const int first_q = q_off + row0;
  const int last_q = q_off + row0 + rows_valid - 1;
  const int kv_end = min(kvl, last_q + 1);
  int kv_start = a.window > 0 ? max(0, first_q - a.window + 1) : 0;
  kv_start = (kv_start / kBK) * kBK;
  const size_t kv_base = (static_cast<size_t>(b) * a.nkv + kvh) * a.S * HD;

  if (kv_start < kv_end)
    load_kv_async<HD>(kv_s, kv_s + kBK * HS, a, kv_base + static_cast<size_t>(kv_start) * HD,
                      min(kBK, kv_end - kv_start), tid);
  for (int kv0 = kv_start, it = 0; kv0 < kv_end; kv0 += kBK, ++it) {
    const int nxt = kv0 + kBK;
    if (nxt < kv_end) {
      __nv_bfloat16* nb = kv_s + ((it + 1) & 1) * kBuf;
      load_kv_async<HD>(nb, nb + kBK * HS, a, kv_base + static_cast<size_t>(nxt) * HD,
                        min(kBK, kv_end - nxt), tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* k_s = kv_s + (it & 1) * kBuf;
    const __nv_bfloat16* v_s = k_s + kBK * HS;

    // logits S (16 x 64) = Q K^T: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // B = K^T (hd x keys), col layout: key row j*8 + g, d pair 2t
        const __nv_bfloat16* kr = k_s + (j * 8 + g) * HS + ks * 16 + 2 * t;
        mma_bf16(s[j], qf[ks], lds32(kr), lds32(kr + 8));
      }
    }

    // mask, scale, online softmax (base 2) on rows g and g + 8; a tile
    // wholly inside every row's causal range and window skips the mask
    const int warp_q0 = q_off + row0 + wr;
    const bool full = kv0 + kBK <= min(kvl, warp_q0 + 1) &&
                      (a.window <= 0 || kv0 > warp_q0 + 15 - a.window);
    uint32_t ok_bits = 0;
    float mx_a = -1e30f, mx_b = -1e30f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + j * 8 + 2 * t + (e & 1);
        const int qp = e < 2 ? qpos_a : qpos_b;
        const bool ok = full || (key <= qp && key < kvl &&
                                 (a.window <= 0 || key > qp - a.window));
        s[j][e] = ok ? s[j][e] * a.scale_log2 : -1e30f;
        ok_bits |= static_cast<uint32_t>(ok) << (j * 4 + e);
        if (e < 2) {
          mx_a = fmaxf(mx_a, s[j][e]);
        } else {
          mx_b = fmaxf(mx_b, s[j][e]);
        }
      }
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = (ok_bits >> (j * 4 + e)) & 1u;
        const float p = ok ? exp2f(s[j][e] - (e < 2 ? mn_a : mn_b)) : 0.0f;
        s[j][e] = p;
        if (e < 2) {
          sum_a += p;
        } else {
          sum_b += p;
        }
      }
    }
    l_a = l_a * al_a + sum_a;  // per-lane partial sums; the quad adds them at the end
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= al_a;
      o[n][1] *= al_a;
      o[n][2] *= al_b;
      o[n][3] *= al_b;
    }

    // O (16 x hd) += P (16 x 64) . V (64 x hd); P's A fragments are the
    // logits' accumulators, V's B fragments come through ldmatrix.trans
    const int mi = lane / 8, ri = lane % 8;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vrow = v_s + (kk * 16 + ri + (mi & 1) * 8) * HS + (mi >> 1) * 8;
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vrow + np * 16);
        mma_bf16(o[2 * np], pa, vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  __nv_bfloat16* ob = a.out + ((static_cast<size_t>(b) * a.nh + h) * a.cq + row0 + wr) * HD;
  const bool store_a = wr + g < rows_valid, store_b = wr + g + 8 < rows_valid;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * t;
    if (store_a)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(g) * HD + col) =
          pack_bf16(o[n][0] / den_a, o[n][1] / den_a);
    if (store_b)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(g + 8) * HD + col) =
          pack_bf16(o[n][2] / den_b, o[n][3] / den_b);
  }
}

template <int HD>
int launch(dim3 grid, const PrefillArgs& a, cudaStream_t st) {
  const int smem = static_cast<int>(sizeof(__nv_bfloat16) * (kBQ + 4 * kBK) * (HD + kPad));
  cudaError_t err = cudaFuncSetAttribute(prefill_flash_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  prefill_flash_kernel<HD><<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, nh, Cq, hd), k/v (B, nkv, S, hd), out (B, nh, Cq, hd): bf16,
// contiguous; hd is 64 or 128. q_offset / kv_len: (B,) int32. window <= 0:
// none.
extern "C" int palu_prefill_flash(const void* q, const void* k, const void* v, void* out,
                                  const void* q_offset, const void* kv_len, int B, int nh,
                                  int nkv, int cq, int S, int hd, int window,
                                  float scale_log2, void* stream) {
  PrefillArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.q_offset = static_cast<const int*>(q_offset);
  a.kv_len = static_cast<const int*>(kv_len);
  a.nh = nh;
  a.nkv = nkv;
  a.cq = cq;
  a.S = S;
  a.window = window;
  a.scale_log2 = scale_log2;
  const dim3 grid((cq + kBQ - 1) / kBQ, nh, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd == 128 ? launch<128>(grid, a, st)
       : hd == 64  ? launch<64>(grid, a, st)
                   : static_cast<int>(cudaErrorInvalidValue);
}
