// Candidate store designs of the log-potential table (logpot_kernel of
// csrc/qcmrf_kernels.cu), built and timed by logpot_designs.py beside the
// library's kernel. Not part of the kernel library: nothing in the port
// launches these. The library's source is included whole, so every
// design evaluates its sub-blocks through the same split_values and
// differs only in how the finished values reach device memory:
//
// (i)    the library's logpot_kernel: each value stored from its
//        register (a warp's value r is 128 contiguous bytes), not
//        repeated here;
// (i')   the same stores with the evict-first hint (st.global.cs): the
//        table is written once and read later, by another kernel;
// (ii)   the values of a sub-block (2^L floats, 16 KB at L = 12) go to one
//        of two shared-memory buffers; after a proxy fence and a barrier
//        one thread sends the whole buffer with cp.async.bulk (shared ->
//        global, one bulk group a sub-block) and the block computes the
//        next sub-block; before a buffer is filled again, two sub-blocks
//        later, that thread waits until its copy has been read
//        (cp.async.bulk.wait_group.read 1), and the next barrier of
//        split_values passes that on to the block.

#include "../csrc/qcmrf_kernels.cu"

namespace {

enum StoreDesign { kEvictFirst = 0, kBulk = 1 };

__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(s), "r"(bytes)
      : "memory");
}

template <int R, int kDesign>
__global__ void __launch_bounds__(kThreads)
logpot_design_kernel(SplitPlan pl, const float* __restrict__ coef, int ncoef,
                     int64_t per_block, int parts, float beta, int fuse_amp,
                     float amp_scale, float* __restrict__ out) {
  extern __shared__ unsigned long long smem64[];
  const int b = blockIdx.y;
  float* rest;
  const SplitShared sp = load_split(
      smem64, 0, pl, coef + static_cast<int64_t>(b) * ncoef, &rest);
  const int L = pl.L;
  // two staging buffers of 2^L floats, 128-byte aligned (design ii)
  float* buf = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(rest) + 127) & ~static_cast<uintptr_t>(127));
  float* row = out + static_cast<int64_t>(b) * parts * per_block;
  const int64_t subs = per_block >> L;
  int staged = 0;
  for (int p = blockIdx.x; p < parts; p += gridDim.x) {
    const unsigned long long h0 = static_cast<unsigned long long>(p) * subs;
    for (int64_t i = 0; i < subs; ++i, ++staged) {
      const unsigned long long h = h0 + i;
      if (kDesign == kBulk && threadIdx.x == 0) {
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      }
      float v[R];
      split_values<R>(sp, pl, h, beta, v);
      float* dst = row + (h << L);
      if (kDesign == kEvictFirst) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int x = r * kThreads + threadIdx.x;
          if (x < (1 << L)) {
            __stcs(dst + x, table_value(v[r], fuse_amp, amp_scale));
          }
        }
      } else {
        float* stage = buf + ((staged & 1) << L);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int x = r * kThreads + threadIdx.x;
          if (x < (1 << L)) stage[x] = table_value(v[r], fuse_amp, amp_scale);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        if (threadIdx.x == 0) bulk_store(dst, stage, 4 << L);
      }
    }
  }
  if (kDesign == kBulk && threadIdx.x == 0) {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

template <int R, int kDesign>
int launch_design(const SplitPlan& pl, const float* coef, int B, int ncoef,
                  int64_t per_block, int parts, float beta, int fuse_amp,
                  float amp_scale, float* out, void* stream) {
  size_t smem = split_smem_bytes(pl);
  if (kDesign == kBulk) smem += 128 + (static_cast<size_t>(8) << pl.L);
  const cudaError_t err = allow_shared(logpot_design_kernel<R, kDesign>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  logpot_design_kernel<R, kDesign><<<split_grid(parts, B), kThreads, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      pl, coef, ncoef, per_block, parts, beta, fuse_amp, amp_scale, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// design: 0 (i') or 1 (ii); the bulk copy moves whole 16-byte units, so
// (ii) takes sub-blocks of at least 4 floats (L >= 2).
int design_logpot(int design, SplitPlan plan, const float* coef, int B,
                  int ncoef, int64_t per_block, int parts, float beta,
                  int fuse_amp, float amp_scale, float* out, void* stream) {
  if (design == kBulk && plan.L < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return with_values_per_thread(plan.L, [&](auto r) {
    constexpr int R = decltype(r)::value;
    return design == kBulk
               ? launch_design<R, kBulk>(plan, coef, B, ncoef, per_block,
                                         parts, beta, fuse_amp, amp_scale,
                                         out, stream)
               : launch_design<R, kEvictFirst>(plan, coef, B, ncoef,
                                               per_block, parts, beta,
                                               fuse_amp, amp_scale, out,
                                               stream);
  });
}

}  // extern "C"
