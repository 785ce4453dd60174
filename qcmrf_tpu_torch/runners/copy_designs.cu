// Candidate designs of the plane copy (both float32 planes of 2^n values
// read and written once), built and timed by copy_designs.py beside the
// library's copy_kernel and the planes' two copy_ calls. Not part of the
// kernel library: nothing in the port launches these.
//
// (s)    the earlier copy_kernel: one grid-stride loop over both planes,
//        a float4 load and store of each plane an iteration (four
//        interleaved streams), at most 16 blocks of 256 threads an SM;
// (a)    one plane after the other: the same loop on one plane, launched
//        once a plane;
// (b)    U float4 loads a thread issued before any store, on a grid that
//        covers both planes (the first half of the blocks copy the real
//        plane); U = 2 is the library's copy_kernel, and so is not
//        repeated here;
// (c)    a bulk-copy ring: one thread of each persistent block moves
//        chunks of C bytes with cp.async.bulk global -> shared (completion
//        on an mbarrier a stage), then shared -> global, S stages, B
//        blocks an SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

unsigned capped_grid(int64_t items) {
  int64_t blocks = (items + kThreads - 1) / kThreads;
  const int64_t cap = int64_t(sm_count()) * 16;
  if (blocks > cap) blocks = cap;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

__global__ void __launch_bounds__(kThreads)
strided_kernel(const float4* __restrict__ src_re,
               const float4* __restrict__ src_im,
               float4* __restrict__ dst_re, float4* __restrict__ dst_im,
               int64_t groups) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t g = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    dst_re[g] = src_re[g];
    dst_im[g] = src_im[g];
  }
}

__global__ void __launch_bounds__(kThreads)
plane_kernel(const float4* __restrict__ src, float4* __restrict__ dst,
             int64_t groups) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t g = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    dst[g] = src[g];
  }
}

template <int U>
__global__ void __launch_bounds__(kThreads)
unrolled_kernel(const float4* __restrict__ src_re,
                const float4* __restrict__ src_im,
                float4* __restrict__ dst_re, float4* __restrict__ dst_im,
                int64_t groups, int64_t blocks_per_plane) {
  const bool second = blockIdx.x >= blocks_per_plane;
  const float4* src = second ? src_im : src_re;
  float4* dst = second ? dst_im : dst_re;
  const int64_t base =
      (blockIdx.x - (second ? blocks_per_plane : 0)) * int64_t(kThreads) * U +
      threadIdx.x;
  float4 v[U];
#pragma unroll
  for (int k = 0; k < U; ++k) {
    if (base + k * kThreads < groups) v[k] = src[base + k * kThreads];
  }
#pragma unroll
  for (int k = 0; k < U; ++k) {
    if (base + k * kThreads < groups) dst[base + k * kThreads] = v[k];
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(bar), "r"(parity) : "memory");
}

// dynamic shared memory: 1 KB of mbarriers (8 bytes a stage), then the
// stages
constexpr int kBarrierBytes = 1024;

__global__ void __launch_bounds__(32, 1)
bulk_kernel(const char* __restrict__ src_re, const char* __restrict__ src_im,
            char* __restrict__ dst_re, char* __restrict__ dst_im,
            int64_t plane_bytes, int chunk, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x != 0) return;
  const uint32_t bars = smem_addr(smem);
  const uint32_t data = bars + kBarrierBytes;
  for (int s = 0; s < stages; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 ::"r"(bars + 8 * s) : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  const int64_t per_plane = plane_bytes / chunk;
  const int64_t total = 2 * per_plane;
  if (blockIdx.x >= total) return;
  const int64_t mine = (total - blockIdx.x + gridDim.x - 1) / gridDim.x;
  auto offset = [&](int64_t k, bool& second) {
    const int64_t c = blockIdx.x + k * gridDim.x;
    second = c >= per_plane;
    return (second ? c - per_plane : c) * chunk;
  };
  auto load = [&](int64_t k) {
    bool second;
    const int64_t off = offset(k, second);
    const int s = static_cast<int>(k % stages);
    bulk_load(data + uint32_t(s) * chunk, (second ? src_im : src_re) + off,
              chunk, bars + 8 * s);
  };
  for (int64_t k = 0; k < mine && k < stages; ++k) load(k);
  for (int64_t k = 0; k < mine; ++k) {
    const int s = static_cast<int>(k % stages);
    bar_wait(bars + 8 * s, static_cast<uint32_t>((k / stages) & 1));
    bool second;
    const int64_t off = offset(k, second);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 ::"l"((second ? dst_im : dst_re) + off),
                 "r"(data + uint32_t(s) * chunk), "r"(chunk) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    if (k >= 1 && k - 1 + stages < mine) {
      // the store of chunk k - 1 has read its stage: refill it
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      load(k - 1 + stages);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace

extern "C" {

const char* design_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int copy_strided(const float* src_re, const float* src_im, float* dst_re,
                 float* dst_im, int64_t values, void* stream) {
  const int64_t groups = values / 4;
  strided_kernel<<<capped_grid(groups), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(src_re),
      reinterpret_cast<const float4*>(src_im),
      reinterpret_cast<float4*>(dst_re), reinterpret_cast<float4*>(dst_im),
      groups);
  return static_cast<int>(cudaGetLastError());
}

int copy_plane_by_plane(const float* src_re, const float* src_im,
                        float* dst_re, float* dst_im, int64_t values,
                        void* stream) {
  const int64_t groups = values / 4;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  plane_kernel<<<capped_grid(groups), kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(src_re),
      reinterpret_cast<float4*>(dst_re), groups);
  plane_kernel<<<capped_grid(groups), kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(src_im),
      reinterpret_cast<float4*>(dst_im), groups);
  return static_cast<int>(cudaGetLastError());
}

int copy_unrolled(int unroll, const float* src_re, const float* src_im,
                  float* dst_re, float* dst_im, int64_t values,
                  void* stream) {
  const int64_t groups = values / 4;
  const int64_t per_block = int64_t(kThreads) * unroll;
  const int64_t bpp = (groups + per_block - 1) / per_block;
  const unsigned grid = static_cast<unsigned>(2 * bpp);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = reinterpret_cast<const float4*>(src_re);
  const auto* b = reinterpret_cast<const float4*>(src_im);
  auto* c = reinterpret_cast<float4*>(dst_re);
  auto* d = reinterpret_cast<float4*>(dst_im);
  switch (unroll) {
    case 4:
      unrolled_kernel<4><<<grid, kThreads, 0, s>>>(a, b, c, d, groups, bpp);
      break;
    case 8:
      unrolled_kernel<8><<<grid, kThreads, 0, s>>>(a, b, c, d, groups, bpp);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int copy_bulk(int chunk, int stages, int blocks_per_sm, const float* src_re,
              const float* src_im, float* dst_re, float* dst_im,
              int64_t values, void* stream) {
  const int64_t plane_bytes = values * 4;
  if (chunk > plane_bytes) chunk = static_cast<int>(plane_bytes);
  if (stages * 8 > kBarrierBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = kBarrierBytes + size_t(stages) * chunk;
  cudaError_t err = cudaFuncSetAttribute(
      bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(sm_count() * blocks_per_sm);
  bulk_kernel<<<grid, 32, bytes, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const char*>(src_re),
      reinterpret_cast<const char*>(src_im), reinterpret_cast<char*>(dst_re),
      reinterpret_cast<char*>(dst_im), plane_bytes, chunk, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
