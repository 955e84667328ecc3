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
// Bound on this card: the function reads and writes n values per row and
// does n * (log2 m + K) additions, at most ~8 per byte moved in f32 (K 60,
// m 8) against the 20 the f32 pipes reach per byte of memory traffic
// (67 TFLOP/s over 3.35 TB/s): bound by bytes. The TPU kernel's dense
// product would do 2n flops per element (128 per byte at n 512), bound by
// operations, so the GPU runs the butterfly.
//
// Design: one block per row, n/2 threads (32 to 256). The row comes into
// shared memory as f32 (16 KB at n 4096) with coalesced loads; log2(m)
// butterfly stages run over the whole row (a stage's pairs never cross a
// chunk, since 2h divides m), a barrier after each; then each thread forms
// its outputs from the K values of its column across chunks, reading the
// +-1 table of H_K (K^2 bytes, staged once per block) and storing in x's
// type. Nothing allocates here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 4096;
constexpr int kMaxThreads = 256;

template <bool BF16>
__global__ void __launch_bounds__(kMaxThreads) hadamard_kernel(
    const void* __restrict__ x, const int8_t* __restrict__ hk, void* __restrict__ out, int n,
    int K, int log_m, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* buf = reinterpret_cast<float*>(smem);          // [n]
  int8_t* hks = reinterpret_cast<int8_t*>(buf + n);      // [K][K] of +-1
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const int m = 1 << log_m;

  for (int i = tid; i < n; i += nt)
    buf[i] = BF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(x)[base + i])
                  : static_cast<const float*>(x)[base + i];
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
    v *= scale;
    if (BF16)
      static_cast<__nv_bfloat16*>(out)[base + o] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(out)[base + o] = v;
  }
}

template <bool BF16>
int launch(const void* x, const int8_t* hk, void* out, int rows, int n, int K, int log_m,
           float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) * n + static_cast<size_t>(K) * K;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hadamard_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = (n / 2 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  hadamard_kernel<BF16><<<rows, threads, smem, st>>>(x, hk, out, n, K, log_m, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out (rows, n) contiguous, f32 (bf16 == 0) or bf16; hk the K x K +-1
// table of H_K as int8, row-major (the wrapper passes H_K^T for the
// transposed transform; unused when K == 1); n = K * 2^log_m <= 4096;
// scale = 1 / sqrt(n).
extern "C" int hadamard_transform(const void* x, const void* hk, void* out, int rows, int n,
                                  int K, int log_m, int bf16, float scale, void* stream) {
  if (rows <= 0 || n <= 0 || n > kMaxN || K < 1 || log_m < 0 || (K << log_m) != n ||
      (K > 1 && hk == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* h = static_cast<const int8_t*>(hk);
  return bf16 ? launch<true>(x, h, out, rows, n, K, log_m, scale, st)
              : launch<false>(x, h, out, rows, n, K, log_m, scale, st);
}
