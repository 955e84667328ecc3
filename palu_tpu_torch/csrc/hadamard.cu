// Orthonormal Hadamard transform over the last dim, n = K * 2^m <= 4096:
// a Walsh-Hadamard butterfly on each of the K contiguous chunks of 2^m,
// then the K x K Hadamard mix across the chunks, scaled by 1/sqrt(n).
//
// Replaces: palu_tpu/ops/pallas/fwht.py::hadamard_transform (body
// _fwht_kernel), which multiplies blocks of rows by the dense constant
// kron(H_K, H_m) / sqrt(n): a layout for the TPU's matrix unit.
//
// What it computes, per row x (f32 or bf16) of the (rows, n) input:
//   y = FWHT_m of each chunk x[k*m : (k+1)*m]        (Sylvester order)
//   out[j*m + i] = scale * sum_k H_K[j, k] y[k*m + i]  (K > 1; else scale*y)
// in f32, stored in x's type: out = x @ (kron(H_K, H_m) / sqrt(n))^T.
//
// Bound on this card: bytes. The function reads and writes n values per
// row and does n * (log2 m + K) additions at most, ~8 per byte moved in f32
// (K 60, m 8) against the ~20 the f32 pipes reach per byte of memory
// traffic (67 TFLOP/s over 3.35 TB/s). The TPU kernel's dense product
// would do 2n flops per element, bound by operations, so the GPU runs the
// butterfly. At the compress path's sizes (4096 rows, 4-8 MB) a warp
// handles a few rows once: what counts is that a warp's reads are in flight
// before it computes, that its memory traffic moves in large pieces, and
// that the arithmetic per value stays small.
//
// Three kernels, picked by ops/hadamard.hadamard_plan (the launch checks
// the plan it is given against its own rules):
//
// fwht_kernel (K == 1, 8 <= n): each thread holds 8 consecutive values of a
// row (16-byte loads and stores), runs the butterfly's first three stages
// in registers and the next ones across the lanes of its row with
// __shfl_xor_sync: a warp takes 32 / (n / 8) rows of at most 256 values.
// Longer rows (n >= 512): one row per block and every stage past a warp's
// 256 values through shared memory (an exchange and two barriers per
// stage).
//
// mix_kernel (K in 12..60 with a sign table below, 2 <= m <= 32; get_hadK
// gives K 20 only at n 20, m 1, so it has none): a warp takes 32 / m
// rows. In bf16 one lane copies them into the warp's own
// shared-memory tile by cp.async.bulk and, once the warp has written its
// outputs back in place, stores them the same way; in f32 each lane loads
// and stores its own values. Lane i of a row holds column i of every
// chunk (its K values, y[k * m + i]), so the butterfly runs across the
// row's m lanes with shuffles (K per stage) and the mix needs no other
// thread. The mix takes the K values four at a time: the 8 signed sums
// v0 +- v1 +- v2 +- v3 (12 additions) serve every output, which adds or
// subtracts the one its row of H_K picks (K / 4 additions an output,
// against K - 1 for a sum over the row). H_K's rows are compile-time
// constants (HadK<K>::row, one 64-bit sign mask per row, bit k set where
// H_K[j, k] = +1; held bit for bit against core/hadamard.get_hadK by the
// CPU tests), so each pick is a plain FADD or FSUB with no table read,
// sign select or branch. (In bf16, lanes that loaded their own columns
// from device memory, two bytes at a time, ran slower than the tiles on
// the card; in f32 faster.)
//
// general_kernel (the rest: K > 60, m > 32 or m == 1 with K > 1, n < 8):
// one block per row, the row in shared memory, a barrier per butterfly
// stage, then the mix from a +-1 table staged per block. Nothing allocates
// here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "hopper.cuh"

namespace {

constexpr int kMaxN = 4096;
constexpr int kMaxThreads = 256;

// ---- H_K as sign masks: bit k of row[j] is set where H_K[j, k] == +1 ----

template <int K>
struct HadK;
template <>
struct HadK<12> {
  static constexpr uint64_t row[12] = {
    0x0000000000000fffull, 0x0000000000000b8aull, 0x0000000000000716ull,
    0x0000000000000e2cull, 0x0000000000000c5aull, 0x00000000000008b6ull,
    0x000000000000016eull, 0x00000000000002dcull, 0x00000000000005b8ull,
    0x0000000000000b70ull, 0x00000000000006e2ull, 0x0000000000000dc4ull};
};
template <>
struct HadK<28> {
  static constexpr uint64_t row[28] = {
    0x000000000ffffffdull, 0x0000000005555554ull, 0x000000000cf00f37ull,
    0x00000000065aa591ull, 0x0000000003c03cdfull, 0x00000000096a9645ull,
    0x000000000f00f373ull, 0x0000000005aa5919ull, 0x000000000c03cdcfull,
    0x0000000006a96465ull, 0x00000000000f373full, 0x000000000aa59195ull,
    0x00000000003cdcf3ull, 0x000000000a964659ull, 0x0000000000f373c3ull,
    0x000000000a591969ull, 0x0000000003cdcf03ull, 0x00000000096465a9ull,
    0x000000000f373c03ull, 0x00000000059196a9ull, 0x000000000cdcf00full,
    0x0000000006465aa5ull, 0x000000000373c03full, 0x0000000009196a95ull,
    0x000000000dcf00f3ull, 0x000000000465aa59ull, 0x00000000073c03cfull,
    0x000000000196a965ull};
};
template <>
struct HadK<36> {
  static constexpr uint64_t row[36] = {
    0x0000000ffffffffdull, 0x0000000555555554ull, 0x0000000f303c0cf7ull,
    0x000000059a96a651ull, 0x0000000cc0f033dfull, 0x000000066a5a9945ull,
    0x0000000303c0cf7full, 0x00000009a96a6515ull, 0x0000000c0f033df3ull,
    0x00000006a5a99459ull, 0x000000003c0cf7cfull, 0x0000000a96a65165ull,
    0x00000000f033df33ull, 0x0000000a5a994599ull, 0x00000003c0cf7cc3ull,
    0x000000096a651669ull, 0x0000000f033df303ull, 0x00000005a99459a9ull,
    0x0000000c0cf7cc0full, 0x00000006a65166a5ull, 0x0000000033df303full,
    0x0000000a99459a95ull, 0x00000000cf7cc0f3ull, 0x0000000a65166a59ull,
    0x000000033df303c3ull, 0x000000099459a969ull, 0x0000000cf7cc0f03ull,
    0x000000065166a5a9ull, 0x00000003df303c0full, 0x00000009459a96a5ull,
    0x0000000f7cc0f033ull, 0x00000005166a5a99ull, 0x0000000df303c0cfull,
    0x0000000459a96a65ull, 0x00000007cc0f033full, 0x0000000166a5a995ull};
};
template <>
struct HadK<40> {
  static constexpr uint64_t row[40] = {
    0x000000ffffffffffull, 0x0000009ea1a9ea1aull, 0x0000003d4363d436ull,
    0x0000007a86c7a86cull, 0x000000f50d8f50d8ull, 0x000000ea1b2ea1b2ull,
    0x000000d4366d4366ull, 0x000000a86cea86ceull, 0x00000050d9e50d9eull,
    0x000000a1b3ca1b3cull, 0x0000004367a4367aull, 0x00000086cf486cf4ull,
    0x0000000d9ea0d9eaull, 0x0000001b3d41b3d4ull, 0x000000367a8367a8ull,
    0x0000006cf506cf50ull, 0x000000d9ea0d9ea0ull, 0x000000b3d42b3d42ull,
    0x00000067a8667a86ull, 0x000000cf50ccf50cull, 0x00000000000fffffull,
    0x000000615e59ea1aull, 0x000000c2bc93d436ull, 0x000000857937a86cull,
    0x0000000af27f50d8ull, 0x00000015e4dea1b2ull, 0x0000002bc99d4366ull,
    0x00000057931a86ceull, 0x000000af26150d9eull, 0x0000005e4c3a1b3cull,
    0x000000bc9854367aull, 0x0000007930b86cf4ull, 0x000000f26150d9eaull,
    0x000000e4c2b1b3d4ull, 0x000000c9857367a8ull, 0x000000930af6cf50ull,
    0x0000002615fd9ea0ull, 0x0000004c2bdb3d42ull, 0x0000009857967a86ull,
    0x00000030af3cf50cull};
};
template <>
struct HadK<44> {
  static constexpr uint64_t row[44] = {
    0x00000fffffffffffull, 0x0000094ef8b8235aull, 0x0000029df17046b6ull,
    0x0000053be2e08d6cull, 0x00000a77c5c11ad8ull, 0x000004ef8b8235b2ull,
    0x000009df17046b64ull, 0x000003be2e08d6caull, 0x0000077c5c11ad94ull,
    0x00000ef8b8235b28ull, 0x00000df17046b652ull, 0x00000be2e08d6ca6ull,
    0x000007c5c11ad94eull, 0x00000f8b8235b29cull, 0x00000f17046b653aull,
    0x00000e2e08d6ca76ull, 0x00000c5c11ad94eeull, 0x000008b8235b29deull,
    0x0000017046b653beull, 0x000002e08d6ca77cull, 0x000005c11ad94ef8ull,
    0x00000b8235b29df0ull, 0x000007046b653be2ull, 0x00000e08d6ca77c4ull,
    0x00000c11ad94ef8aull, 0x000008235b29df16ull, 0x00000046b653be2eull,
    0x0000008d6ca77c5cull, 0x0000011ad94ef8b8ull, 0x00000235b29df170ull,
    0x0000046b653be2e0ull, 0x000008d6ca77c5c0ull, 0x000001ad94ef8b82ull,
    0x0000035b29df1704ull, 0x000006b653be2e08ull, 0x00000d6ca77c5c10ull,
    0x00000ad94ef8b822ull, 0x000005b29df17046ull, 0x00000b653be2e08cull,
    0x000006ca77c5c11aull, 0x00000d94ef8b8234ull, 0x00000b29df17046aull,
    0x00000653be2e08d6ull, 0x00000ca77c5c11acull};
};
template <>
struct HadK<52> {
  static constexpr uint64_t row[52] = {
    0x000ffffffffffffdull, 0x0005555555555554ull, 0x0003c30cc30f0ff7ull,
    0x000969a669a5a551ull, 0x000f00330cfc0fdfull, 0x0005aa99a656a545ull,
    0x000c0ccc33303f7full, 0x0006a666999a9515ull, 0x00003f30cc00fdffull,
    0x000a959a66aa5455ull, 0x0000f0c330c3c7ffull, 0x000a5a699a696155ull,
    0x000c330c3c3fd3c3ull, 0x000699a696954969ull, 0x0000cc33f03f7f03ull,
    0x000a66995a9515a9ull, 0x000330ccc0fdfc0full, 0x00099a666a5456a5ull,
    0x000cc33003f7f03full, 0x0006699aa9515a95ull, 0x00030cc30f1ff0f3ull,
    0x0009a669a5855a59ull, 0x000c30f0ff4f0c33ull, 0x00069a5a5525a699ull,
    0x0000cfc0fdfc00cfull, 0x000a656a5456aa65ull, 0x00033303f7f03333ull,
    0x000999a9515a9999ull, 0x000cc00fdfc0fcc3ull, 0x00066aa5456a5669ull,
    0x00030c3c7fc3c30full, 0x0009a696156969a5ull, 0x0003c3fd3c30cc33ull,
    0x00096954969a6699ull, 0x000f03f7f00330cfull, 0x0005a9515aa99a65ull,
    0x000c0fdfc0ccc333ull, 0x0006a5456a666999ull, 0x00003f7f03f30cc3ull,
    0x000a9515a959a669ull, 0x0000f1ff0f0c330full, 0x000a5855a5a699a5ull,
    0x000ff4f0c330c3c3ull, 0x0005525a699a6969ull, 0x000fdfc00cc33f03ull,
    0x0005456aa66995a9ull, 0x000f7f03330ccc0full, 0x000515a999a666a5ull,
    0x000dfc0fcc33003full, 0x000456a56699aa95ull, 0x0007fc3c30cc30f3ull,
    0x000156969a669a59ull};
};
template <>
struct HadK<60> {
  static constexpr uint64_t row[60] = {
    0x0fffffffffffffffull, 0x0ba93bcf8308da8aull, 0x0752779f0611b516ull,
    0x0ea4ef3e0c236a2cull, 0x0d49de7c1846d45aull, 0x0a93bcf8308da8b6ull,
    0x052779f0611b516eull, 0x0a4ef3e0c236a2dcull, 0x049de7c1846d45baull,
    0x093bcf8308da8b74ull, 0x02779f0611b516eaull, 0x04ef3e0c236a2dd4ull,
    0x09de7c1846d45ba8ull, 0x03bcf8308da8b752ull, 0x0779f0611b516ea4ull,
    0x0ef3e0c236a2dd48ull, 0x0de7c1846d45ba92ull, 0x0bcf8308da8b7526ull,
    0x079f0611b516ea4eull, 0x0f3e0c236a2dd49cull, 0x0e7c1846d45ba93aull,
    0x0cf8308da8b75276ull, 0x09f0611b516ea4eeull, 0x03e0c236a2dd49deull,
    0x07c1846d45ba93bcull, 0x0f8308da8b752778ull, 0x0f0611b516ea4ef2ull,
    0x0e0c236a2dd49de6ull, 0x0c1846d45ba93bceull, 0x08308da8b752779eull,
    0x00611b516ea4ef3eull, 0x00c236a2dd49de7cull, 0x01846d45ba93bcf8ull,
    0x0308da8b752779f0ull, 0x0611b516ea4ef3e0ull, 0x0c236a2dd49de7c0ull,
    0x0846d45ba93bcf82ull, 0x008da8b752779f06ull, 0x011b516ea4ef3e0cull,
    0x0236a2dd49de7c18ull, 0x046d45ba93bcf830ull, 0x08da8b752779f060ull,
    0x01b516ea4ef3e0c2ull, 0x036a2dd49de7c184ull, 0x06d45ba93bcf8308ull,
    0x0da8b752779f0610ull, 0x0b516ea4ef3e0c22ull, 0x06a2dd49de7c1846ull,
    0x0d45ba93bcf8308cull, 0x0a8b752779f0611aull, 0x0516ea4ef3e0c236ull,
    0x0a2dd49de7c1846cull, 0x045ba93bcf8308daull, 0x08b752779f0611b4ull,
    0x016ea4ef3e0c236aull, 0x02dd49de7c1846d4ull, 0x05ba93bcf8308da8ull,
    0x0b752779f0611b50ull, 0x06ea4ef3e0c236a2ull, 0x0dd49de7c1846d44ull};
};

// H_K[j, k] == +1 (H_K^T's when TR); constant-evaluated only (template
// arguments), so the tables never reach device memory.
template <int K, bool TR>
__host__ __device__ constexpr bool plus(int j, int k) {
  return TR ? ((HadK<K>::row[k] >> j) & 1u) != 0 : ((HadK<K>::row[j] >> k) & 1u) != 0;
}

// Output j's pick from the signed sums of values 4b..4b+3: index p (bit e -
// 1 set where value 4b + e takes the sign opposite value 4b's) and the sign
// of value 4b.
template <int K, bool TR>
__host__ __device__ constexpr int pick(int j, int b) {
  const bool h0 = plus<K, TR>(j, 4 * b);
  return (plus<K, TR>(j, 4 * b + 1) != h0 ? 1 : 0) | (plus<K, TR>(j, 4 * b + 2) != h0 ? 2 : 0) |
         (plus<K, TR>(j, 4 * b + 3) != h0 ? 4 : 0);
}

// t[p] = v0 + s1 v1 + s2 v2 + s3 v3 with s_e = -1 where bit e - 1 of p is
// set, v_e = v[4B + e]: 12 additions.
template <int K, int B>
__device__ __forceinline__ void signed_sums(const float (&v)[K], float (&t)[8]) {
  const float a = v[4 * B] + v[4 * B + 1], b = v[4 * B] - v[4 * B + 1];
  const float c = v[4 * B + 2] + v[4 * B + 3], d = v[4 * B + 2] - v[4 * B + 3];
  t[0] = a + c;
  t[1] = b + c;
  t[2] = a - d;
  t[3] = b - d;
  t[4] = a + d;
  t[5] = b + d;
  t[6] = a - c;
  t[7] = b - c;
}

template <bool POS, int P, bool FIRST>
__device__ __forceinline__ void take(float& acc, const float (&t)[8]) {
  if constexpr (FIRST)
    acc = POS ? t[P] : -t[P];
  else
    acc = POS ? acc + t[P] : acc - t[P];
}

template <int K, bool TR, int B, int... Js>
__device__ __forceinline__ void mix_block(const float (&v)[K], float (&acc)[K],
                                          std::integer_sequence<int, Js...>) {
  float t[8];
  signed_sums<K, B>(v, t);
  (take<plus<K, TR>(Js, 4 * B), pick<K, TR>(Js, B), B == 0>(acc[Js], t), ...);
}

// acc[j] = sum_k H_K[j, k] v[k] (H_K^T when TR), the blocks of four in order
template <int K, bool TR, int... Bs>
__device__ __forceinline__ void mix(const float (&v)[K], float (&acc)[K],
                                    std::integer_sequence<int, Bs...>) {
  (mix_block<K, TR, Bs>(v, acc, std::make_integer_sequence<int, K>{}), ...);
}

// Raw values as loaded: f32, or bf16's 16 bits (converted when used, so
// that a load in flight does not stall the warp at its conversion).
template <bool BF16>
struct Raw {
  using T = float;
};
template <>
struct Raw<true> {
  using T = unsigned short;
};

template <bool BF16>
__device__ __forceinline__ typename Raw<BF16>::T load_raw(const void* x, size_t i) {
  if constexpr (BF16)
    return __ldg(static_cast<const unsigned short*>(x) + i);
  else
    return __ldg(static_cast<const float*>(x) + i);
}

template <bool BF16>
__device__ __forceinline__ float to_f32(typename Raw<BF16>::T r) {
  if constexpr (BF16)
    return __uint_as_float(static_cast<uint32_t>(r) << 16);
  else
    return r;
}

template <bool BF16>
__device__ __forceinline__ typename Raw<BF16>::T from_f32(float v) {
  if constexpr (BF16)
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  else
    return v;
}

template <bool BF16>
__device__ __forceinline__ float load1(const void* x, size_t i) {
  return to_f32<BF16>(load_raw<BF16>(x, i));
}

template <bool BF16>
__device__ __forceinline__ void store1(void* out, size_t i, float v) {
  if constexpr (BF16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[i] = v;
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst), "r"(src),
               "r"(bytes)
               : "memory");
}

// K > 1, 2 <= m = 2^log_m <= 32: blocks of 8 warps, warp w a set of 32 / m
// rows (lane (r, i) column i of row r). bf16: lane 0 copies the set's rows
// (contiguous in x) into the warp's own tile by one cp.async.bulk; the
// lanes read their columns there, transform them, write the outputs back
// in place, and lane 0 stores the tile by one cp.async.bulk. No warp waits
// for another, so the copies, the arithmetic and the stores of a block's
// warps overlap. f32: each lane loads its K values straight from device
// memory, all before the first is used, and stores its outputs the same
// way (on the card faster than the tiles in f32, whose reads meet 4-way
// bank conflicts there, 2-way in bf16).
template <int K, bool TR, bool BF16>
__global__ void __launch_bounds__(kMaxThreads, BF16 || K > 52 ? 1 : 2) mix_kernel(
    const void* __restrict__ x, void* __restrict__ out, int rows, int log_m, float scale) {
  using T = typename Raw<BF16>::T;
  extern __shared__ __align__(128) unsigned char tiles[];  // bf16: [8 warps][32 / m rows][n]
  __shared__ __align__(8) uint64_t bars[kMaxThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, m = 1 << log_m, n = K * m;
  const int rpw = 32 >> log_m;
  const int row0 = (blockIdx.x * (kMaxThreads / 32) + warp) * rpw;
  const int nr = min(rpw, rows - row0);
  if (nr <= 0) return;
  const int r = lane >> log_m, i = lane & (m - 1);
  T* tile = reinterpret_cast<T*>(tiles) + warp * rpw * n;
  const uint32_t bar = hopper::smem_u32(&bars[warp]), tile_addr = hopper::smem_u32(tile);
  const uint32_t bytes = nr * n * sizeof(T);
  const size_t base = static_cast<size_t>(row0 + (r < nr ? r : 0)) * n + i;
  float v[K];
  if constexpr (BF16) {
    if (lane == 0) {
      hopper::mbar_init(bar, 1);
      hopper::mbar_init_fence();
      hopper::mbar_expect_tx(bar, bytes);
      hopper::bulk_load(tile_addr, static_cast<const T*>(x) + static_cast<size_t>(row0) * n, bytes,
                        bar);
    }
    __syncwarp();
    hopper::mbar_wait(bar, 0);
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = to_f32<BF16>(tile[r * n + k * m + i]);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = r < nr ? load1<BF16>(x, base + k * m) : 0.0f;
  }
  // butterfly stages across the row's lanes: with a the value of the lane
  // whose bit h is clear and b its partner's, that lane keeps a + b and the
  // partner a - b (fmaf(-1, b, a): exact sums, as the plain butterfly's)
  for (int h = 1; h < m; h <<= 1) {
    const float sgn = (i & h) ? -1.0f : 1.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = fmaf(sgn, v[k], __shfl_xor_sync(0xffffffffu, v[k], h));
  }
  float acc[K];
  mix<K, TR>(v, acc, std::make_integer_sequence<int, K / 4>{});
  if constexpr (BF16) {
    __syncwarp();  // every lane has read its columns: the outputs overwrite them
#pragma unroll
    for (int j = 0; j < K; ++j) tile[r * n + j * m + i] = from_f32<BF16>(acc[j] * scale);
    hopper::fence_async_shared();  // the writes above before the bulk store reads them
    __syncwarp();
    if (lane == 0) {
      bulk_store(static_cast<T*>(out) + static_cast<size_t>(row0) * n, tile_addr, bytes);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");  // done before the tile goes
    }
  } else if (r < nr) {
#pragma unroll
    for (int j = 0; j < K; ++j) store1<BF16>(out, base + j * m, acc[j] * scale);
  }
}

__device__ __forceinline__ void load8(const void* x, size_t i, bool bf16_in, bool live,
                                      uint4 (&raw)[2]) {
  if (!live) {
    raw[0] = raw[1] = make_uint4(0u, 0u, 0u, 0u);
  } else if (bf16_in) {
    raw[0] = __ldg(reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(x) + i));
  } else {
    const uint4* p = reinterpret_cast<const uint4*>(static_cast<const float*>(x) + i);
    raw[0] = __ldg(p);
    raw[1] = __ldg(p + 1);
  }
}

template <bool BF16>
__device__ __forceinline__ void unpack8(const uint4 (&raw)[2], float (&v)[8]) {
  if constexpr (BF16) {
    const uint32_t w[4] = {raw[0].x, raw[0].y, raw[0].z, raw[0].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[2 * e] = __uint_as_float(w[e] << 16);
      v[2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
    }
  } else {
    const uint32_t w[8] = {raw[0].x, raw[0].y, raw[0].z, raw[0].w,
                           raw[1].x, raw[1].y, raw[1].z, raw[1].w};
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __uint_as_float(w[e]);
  }
}

// the butterfly's stages inside 8 registers
__device__ __forceinline__ void fwht8(float (&v)[8]) {
#pragma unroll
  for (int h = 1; h < 8; h <<= 1)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (!(e & h)) {
        const float a = v[e], b = v[e + h];
        v[e] = a + b;
        v[e + h] = a - b;
      }
}

template <bool BF16>
__device__ __forceinline__ void store8(void* out, size_t i, const float (&v)[8], float scale) {
  if constexpr (BF16) {
    uint4 u;
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 b2 = __floats2bfloat162_rn(v[2 * e] * scale, v[2 * e + 1] * scale);
      w[e] = *reinterpret_cast<const uint32_t*>(&b2);
    }
    __stcs(reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + i), u);
  } else {
    float4* p = reinterpret_cast<float4*>(static_cast<float*>(out) + i);
    __stcs(p, make_float4(v[0] * scale, v[1] * scale, v[2] * scale, v[3] * scale));
    __stcs(p + 1, make_float4(v[4] * scale, v[5] * scale, v[6] * scale, v[7] * scale));
  }
}

// K == 1, n = 2^log_m >= 8, T = n / 8 threads per row, each 8 consecutive
// values (16-byte loads and stores). T <= 32: blocks of 8 warps, warp w a
// set of 32 / T rows. T > 32: blockDim.x = T, one row per block, the
// stages past a warp through shared memory.
template <bool BF16>
__global__ void __launch_bounds__(512) fwht_kernel(const void* __restrict__ x,
                                                   void* __restrict__ out, int rows, int log_m,
                                                   float scale) {
  extern __shared__ __align__(16) float xbuf[];  // T > 32: [n]
  const int log_t = log_m - 3, T = 1 << log_t, n = 1 << log_m;
  const int t = threadIdx.x & (T - 1);
  const int row =
      T > 32 ? blockIdx.x : blockIdx.x * (kMaxThreads >> log_t) + (threadIdx.x >> log_t);
  const bool live = row < rows;
  const size_t base = static_cast<size_t>(live ? row : 0) * n + t * 8;
  uint4 raw[2];
  load8(x, base, BF16, live, raw);
  float v[8];
  unpack8<BF16>(raw, v);
  fwht8(v);
  for (int hb = 1; hb < (T < 32 ? T : 32); hb <<= 1) {
    const float sgn = (t & hb) ? -1.0f : 1.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = fmaf(sgn, v[e], __shfl_xor_sync(0xffffffffu, v[e], hb));
  }
  float* mine = xbuf + t * 8;
  for (int hb = 32; hb < T; hb <<= 1) {  // stages past a warp: exchange through shared memory
    reinterpret_cast<float4*>(mine)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(mine)[1] = make_float4(v[4], v[5], v[6], v[7]);
    __syncthreads();
    const float4* q = reinterpret_cast<const float4*>(xbuf + (t ^ hb) * 8);
    const float4 a = q[0], b = q[1];
    const float p[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    const float sgn = (t & hb) ? -1.0f : 1.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = fmaf(sgn, v[e], p[e]);
    __syncthreads();
  }
  if (live) store8<BF16>(out, base, v, scale);
}

// Every other shape: one block per row, n/2 threads (32 to 256), the row
// in shared memory as f32, a barrier per butterfly stage, then each output
// from the K values of its column and the +-1 table of H_K (staged once
// per block).
template <bool BF16>
__global__ void __launch_bounds__(kMaxThreads) general_kernel(
    const void* __restrict__ x, const int8_t* __restrict__ hk, void* __restrict__ out, int n,
    int K, int log_m, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* buf = reinterpret_cast<float*>(smem);          // [n]
  int8_t* hks = reinterpret_cast<int8_t*>(buf + n);      // [K][K] of +-1
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const int m = 1 << log_m;

  for (int i = tid; i < n; i += nt) buf[i] = load1<BF16>(x, base + i);
  if (K > 1)
    for (int i = tid; i < K * K; i += nt) hks[i] = hk[i];
  __syncthreads();

  // butterflies of stride h inside each chunk of m
  for (int lh = 0; lh < log_m; ++lh) {
    const int h = 1 << lh;
    for (int p = tid; p < n / 2; p += nt) {
      const int i0 = ((p >> lh) << (lh + 1)) + (p & (h - 1));
      const float a = buf[i0], b = buf[i0 + h];
      buf[i0] = a + b;
      buf[i0 + h] = a - b;
    }
    __syncthreads();
  }

  for (int o = tid; o < n; o += nt) {
    float v;
    if (K == 1) {
      v = buf[o];
    } else {
      const int j = o >> log_m, i = o & (m - 1);
      const int8_t* row = hks + j * K;
      v = 0.0f;
      for (int k = 0; k < K; ++k) v += row[k] > 0 ? buf[k * m + i] : -buf[k * m + i];
    }
    store1<BF16>(out, base + o, v * scale);
  }
}

template <int K, bool TR, bool BF16>
int launch_mix(const void* x, void* out, int rows, int log_m, float scale, int blocks, int smem,
               cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mix_kernel<K, TR, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mix_kernel<K, TR, BF16><<<blocks, kMaxThreads, smem, st>>>(x, out, rows, log_m, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_mix_k(const void* x, void* out, int rows, int log_m, int bf16, int tr, float scale,
                 int blocks, int smem, cudaStream_t st) {
  if (bf16)
    return tr ? launch_mix<K, true, true>(x, out, rows, log_m, scale, blocks, smem, st)
              : launch_mix<K, false, true>(x, out, rows, log_m, scale, blocks, smem, st);
  return tr ? launch_mix<K, true, false>(x, out, rows, log_m, scale, blocks, smem, st)
            : launch_mix<K, false, false>(x, out, rows, log_m, scale, blocks, smem, st);
}

bool mix_k(int K) {
  switch (K) {
    case 12: case 28: case 36: case 40: case 44: case 52: case 60: return true;
    default: return false;
  }
}

}  // namespace

// The plan ops/hadamard.hadamard_plan makes for (n, K) and the element size
// (4 f32, 2 bf16): kind 0 fwht, 1 mix, 2 general; threads per block; rows
// per block; dynamic shared bytes. Returns -1 for a shape the kernels do
// not take.
extern "C" int hadamard_plan(int n, int K, int esize, int* kind, int* threads,
                             int* rows_per_block, int* smem) {
  if (n <= 0 || n > kMaxN || K < 1 || n % K || (esize != 2 && esize != 4)) return -1;
  const int m = n / K;
  if (m & (m - 1)) return -1;
  if (K == 1 && m >= 8) {
    const int T = m / 8;
    *kind = 0;
    *threads = T > 32 ? T : kMaxThreads;
    *rows_per_block = T > 32 ? 1 : kMaxThreads / T;
    *smem = T > 32 ? m * static_cast<int>(sizeof(float)) : 0;
  } else if (mix_k(K) && 2 <= m && m <= 32) {
    *kind = 1;
    *threads = kMaxThreads;
    *rows_per_block = (kMaxThreads / 32) * (32 / m);
    *smem = esize == 2 ? *rows_per_block * n * esize : 0;
  } else {
    int t = (n / 2 + 31) / 32 * 32;
    *kind = 2;
    *threads = t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
    *rows_per_block = 1;
    *smem = static_cast<int>(sizeof(float)) * n + K * K;
  }
  return 0;
}

// x, out (rows, n) contiguous and 16-byte aligned, f32 (bf16 == 0) or
// bf16; hk the K x K +-1 table of H_K as int8, row-major (the wrapper
// passes H_K^T for the transposed transform; read only by the general
// kernel, which needs it when K > 1); n = K * 2^log_m <= 4096; scale = 1 /
// sqrt(n); kind, threads, rows_per_block and smem: the plan, which must
// equal hadamard_plan's.
extern "C" int hadamard_transform(const void* x, const void* hk, void* out, int rows, int n,
                                  int K, int log_m, int bf16, int transpose, float scale,
                                  int kind, int threads, int rows_per_block, int smem,
                                  void* stream) {
  int pk, pt, pr, ps;
  if (rows <= 0 || log_m < 0 || log_m > 12 || (K << log_m) != n ||
      hadamard_plan(n, K, bf16 ? 2 : 4, &pk, &pt, &pr, &ps) != 0 || pk != kind || pt != threads ||
      pr != rows_per_block || ps != smem || (kind == 2 && K > 1 && hk == nullptr) ||
      (kind != 2 && (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (kind == 0) {
    if (bf16)
      fwht_kernel<true><<<blocks, threads, smem, st>>>(x, out, rows, log_m, scale);
    else
      fwht_kernel<false><<<blocks, threads, smem, st>>>(x, out, rows, log_m, scale);
    return static_cast<int>(cudaGetLastError());
  }
  if (kind == 1) {
#define PALU_MIX(KK) \
  case KK:           \
    return launch_mix_k<KK>(x, out, rows, log_m, bf16, transpose, scale, blocks, smem, st)
    switch (K) {
      PALU_MIX(12);
      PALU_MIX(28);
      PALU_MIX(36);
      PALU_MIX(40);
      PALU_MIX(44);
      PALU_MIX(52);
      PALU_MIX(60);
#undef PALU_MIX
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int8_t* h = static_cast<const int8_t*>(hk);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bf16 ? general_kernel<true> : general_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (bf16)
    general_kernel<true><<<rows, threads, smem, st>>>(x, h, out, n, K, log_m, scale);
  else
    general_kernel<false><<<rows, threads, smem, st>>>(x, h, out, n, K, log_m, scale);
  return static_cast<int>(cudaGetLastError());
}
