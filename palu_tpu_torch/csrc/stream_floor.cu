// The rate at which the card streams a (rows, rowbytes) matrix from device
// memory by each load path a GEMV over W^T can take, with nothing computed:
// 16-byte ld.global.nc into registers (a grid-stride walk), 16-byte
// cp.async into a shared-memory ring, and cp.async.bulk of row segments
// into an mbarrier ring (one producer thread, four consumer warps that
// free each stage); and gemv_int4's one-launch pattern (gemv4_ldg's
// loads with nothing computed: 64-row x 128-byte tiles, lane (g, t)
// loading 16 bytes of rows 16 t .. 16 t + 15 at byte 16 g). A
// measurement tool (tools/gemv_ab.py --only=floor), not a kernel of any
// path; it replaces no TPU kernel. Bound: bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ uint4 ld16(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__global__ void ldg_kernel(const uint4* __restrict__ w, size_t n16, unsigned* __restrict__ sink) {
  unsigned acc = 0;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n16;
       i += stride) {
    uint4 v;
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(w + i));
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  if (acc == 0x9E3779B9u) sink[0] = acc;  // keeps the loads
}

// block b: rows [b * R, (b + 1) * R), seg bytes of each row per stage
__global__ void cpasync_kernel(const uint8_t* __restrict__ w, int rowbytes, int R, int seg,
                               unsigned* __restrict__ sink) {
  constexpr int kStages = 4;
  extern __shared__ __align__(16) uint8_t sm[];
  const int stage_bytes = R * seg, nseg = rowbytes / seg, per = stage_bytes / 16;
  const uint8_t* blk = w + static_cast<size_t>(blockIdx.x) * R * rowbytes;
  unsigned acc = 0;
  auto fetch = [&](int i) {
    if (i < nseg)
      for (int q = threadIdx.x; q < per; q += blockDim.x) {
        const int r = q / (seg / 16), c = q - r * (seg / 16);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                         hopper::smem_u32(sm + (i % kStages) * stage_bytes + q * 16)),
                     "l"(blk + static_cast<size_t>(r) * rowbytes + static_cast<size_t>(i) * seg +
                         c * 16)
                     : "memory");
      }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  for (int i = 0; i < kStages - 1; ++i) fetch(i);
  for (int i = 0; i < nseg; ++i) {
    fetch(i + kStages - 1);
    asm volatile("cp.async.wait_group 2;" ::: "memory");
    __syncthreads();
    acc ^= *reinterpret_cast<const unsigned*>(sm + (i % kStages) * stage_bytes + threadIdx.x * 4);
    __syncthreads();
  }
  if (acc == 0x9E3779B9u) sink[0] = acc;
}

__global__ void __launch_bounds__(160) bulk_kernel(const uint8_t* __restrict__ w, int rowbytes,
                                                   int R, int seg, int S,
                                                   unsigned* __restrict__ sink) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;
  const int stage_bytes = R * seg, nseg = rowbytes / seg;
  const uint32_t full = base + S * stage_bytes, empty = full + 8 * S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const uint8_t* blk = w + static_cast<size_t>(blockIdx.x) * R * rowbytes;
  if (warp == 4) {
    if (lane == 0)
      for (int i = 0; i < nseg; ++i) {
        const int s = i % S;
        if (i >= S) mbar_wait(empty + 8 * s, ((i / S) - 1) & 1);
        mbar_expect_tx(full + 8 * s, stage_bytes);
        for (int r = 0; r < R; ++r)
          bulk_load(base + s * stage_bytes + r * seg,
                    blk + static_cast<size_t>(r) * rowbytes + static_cast<size_t>(i) * seg, seg,
                    full + 8 * s);
      }
    return;
  }
  unsigned acc = 0;
  for (int i = 0; i < nseg; ++i) {
    const int s = i % S;
    mbar_wait(full + 8 * s, (i / S) & 1);
    acc ^= *reinterpret_cast<const unsigned*>(smem_raw + (base - raw) + s * stage_bytes + tid * 4);
    fence_async_shared();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
  if (acc == 0x9E3779B9u) sink[0] = acc;
}

// gemv4_ldg's loads: tiles of 64 rows x 8 W bytes (W = 16: 128 bytes),
// numbered column-block major (order 0: consecutive tiles are consecutive
// row groups of one column block, as a cluster's warps take them) or
// row-group major (order 1: consecutive column blocks of one row group);
// lane (g, t) loads W bytes at byte W g of rows 16 t .. 16 t + 15; warp w
// of the grid's W takes tiles w, w + W, ..., loading the next tile before
// it folds the current one (two tiles in flight).
template <int W>
__device__ __forceinline__ void ldw(const uint8_t* p, uint4& v) {
  if (W == 16) {
    v = ld16(p);
  } else if (W == 8) {
    asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
                 : "=r"(v.x), "=r"(v.y)
                 : "l"(p));
  } else {
    asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v.x) : "l"(p));
  }
}

template <int W>
__global__ void __launch_bounds__(256, 1) tiles_kernel(const uint8_t* __restrict__ w,
                                                       int rows, int rowbytes, int order,
                                                       unsigned* __restrict__ sink) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nw = gridDim.x * 8, wid = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int cbs = rowbytes / (8 * W), groups = rows / 64, tiles = cbs * groups;
  auto ptr = [&](int i) {
    const int cb = order == 0 ? i / groups : i % cbs, grp = order == 0 ? i % groups : i / cbs;
    return w + (static_cast<size_t>(grp) * 64 + 16 * t) * rowbytes + cb * 8 * W + W * g;
  };
  unsigned acc = 0;
  uint4 q[16];
  for (int r = 0; r < 16; ++r) q[r] = make_uint4(0u, 0u, 0u, 0u);
  if (wid < tiles) {
    const uint8_t* p = ptr(wid);
#pragma unroll
    for (int r = 0; r < 16; ++r) ldw<W>(p + static_cast<size_t>(r) * rowbytes, q[r]);
  }
  for (int i = wid; i < tiles; i += nw) {
    uint4 n[16];
    if (i + nw < tiles) {
      const uint8_t* p = ptr(i + nw);
#pragma unroll
      for (int r = 0; r < 16; ++r) ldw<W>(p + static_cast<size_t>(r) * rowbytes, n[r]);
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      acc ^= q[r].x ^ q[r].y ^ q[r].z ^ q[r].w;
      q[r] = n[r];
    }
  }
  if (acc == 0x9E3779B9u) sink[0] = acc;
}

}  // namespace

// path 0: ld.global.nc (blocks x 256 threads); 1: cp.async (rows / R
// blocks of 128 threads, 4 stages of R x seg bytes); 2: cp.async.bulk
// (rows / R blocks, S stages of R x seg bytes); 3: gemv4_ldg's tiles
// (blocks x 256 threads, R the tile order, seg the bytes a lane loads: 4,
// 8 or 16). w 16-byte aligned, rows % R == 0, rowbytes % seg == 0, seg %
// 16 == 0 (path 3: rows % 64 == 0, rowbytes % 128 == 0).
extern "C" int stream_floor(int path, const void* w, int rows, int rowbytes, int R, int seg,
                            int S, int blocks, void* sink, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  unsigned* sk = static_cast<unsigned*>(sink);
  if (path == 0) {
    ldg_kernel<<<blocks, 256, 0, st>>>(reinterpret_cast<const uint4*>(w),
                                       static_cast<size_t>(rows) * rowbytes / 16, sk);
    return static_cast<int>(cudaGetLastError());
  }
  if (path == 3) {  // seg: bytes a lane loads (4, 8 or 16)
    if (rows % 64 || rowbytes % 128 || blocks <= 0 || (seg != 4 && seg != 8 && seg != 16))
      return static_cast<int>(cudaErrorInvalidValue);
    if (seg == 16)
      tiles_kernel<16><<<blocks, 256, 0, st>>>(wb, rows, rowbytes, R, sk);
    else if (seg == 8)
      tiles_kernel<8><<<blocks, 256, 0, st>>>(wb, rows, rowbytes, R, sk);
    else
      tiles_kernel<4><<<blocks, 256, 0, st>>>(wb, rows, rowbytes, R, sk);
    return static_cast<int>(cudaGetLastError());
  }
  if (R <= 0 || rows % R || seg % 16 || rowbytes % seg)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = path == 1 ? 4 * R * seg : S * R * seg + 2 * S * 8 + 128;
  const void* fn = path == 1 ? reinterpret_cast<const void*>(cpasync_kernel)
                             : reinterpret_cast<const void*>(bulk_kernel);
  const cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (path == 1)
    cpasync_kernel<<<rows / R, 128, smem, st>>>(wb, rowbytes, R, seg, sk);
  else
    bulk_kernel<<<rows / R, 160, smem, st>>>(wb, rowbytes, R, seg, S, sk);
  return static_cast<int>(cudaGetLastError());
}
