// Hand-written Hopper (sm_90a) kernels of the closed-form QCMRF sampling
// path, of exact inference and of exact-MLE training: the fused outcome
// sampler, the log-potential table, the streaming logsumexp, argmax and
// monomial-moment sweeps, and the fused lnZ + moments sweep. The sampler,
// the table, the argmax and the moments kernels evaluate a clique's
// multilinear (Moebius) form state by state with one shared device
// function, moebius_chain; the logsumexp and the fused sweep evaluate whole
// sub-blocks of states through the block-invariant split (section 3).
//
// Built by qcmrf_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes. Each extern "C" entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().
//
// Structure arguments, shared by the kernels:
//   coef   float32 (B, K << cmax)  per-row Moebius coefficients, clique-major;
//                                  subset s of clique k at k * 2^cmax + s
//   shifts int32   (K, cmax)       state-id right-shift of clique k's slot i
//   sizes  int32   (K,)            clique sizes (slots >= size are unused)
// The split kernels take coef and a SplitPlan in place of shifts and sizes.
// Row b of a launch is blockIdx.y.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

// The block-invariant split of a structure (section 3), built by
// qcmrf_tpu_torch/ops/kernels.py::split_plan and passed by value; at
// namespace scope, as the extern "C" entry points take it.
struct SplitPlan {
  const unsigned long long* hm;  // (U,) high mask of each monomial
  const int* coef_index;         // (C,) coefficient entries by monomial
  const int* c_items;            // (CI + 1,) entry offsets of the items
  const int* c_heads;            // (U + 1,) item offsets of each monomial
  const int* m_items;            // (MI + 1,) monomial offsets of the items
  const int* m_heads;            // (G + 1,) item offsets of each target
  const int* targets;            // (G,) the target of each group
  int L, U, CI, MI, G;
};

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// Shared arithmetic
// ---------------------------------------------------------------------------

// acc + sum_{s < 2^m} coef[s] * prod_{i in s} bit_i, where bit_i is bit i of
// the clique's slot word y. The order and rounding of
// qcmrf_tpu_torch/utils/moebius.py::eval_multilinear: subsets in increasing
// s, one product and one sum each, rounded separately (the _rn intrinsics
// are never contracted into an FMA), so the plain PyTorch versions
// reproduce the result bit for bit.
__device__ __forceinline__ float moebius_chain(const float* coef, uint32_t y,
                                               int m, float acc) {
  acc = __fadd_rn(acc, coef[0]);
  const uint32_t n_sub = 1u << m;
  for (uint32_t s = 1; s < n_sub; ++s) {
    const float p = ((y & s) == s) ? 1.0f : 0.0f;
    acc = __fadd_rn(acc, __fmul_rn(coef[s], p));
  }
  return acc;
}

// Slot word of one clique: bit i = the bit of its slot-i variable in x.
template <typename Id>
__device__ __forceinline__ uint32_t clique_slots(Id x, const int* shifts,
                                                 int m) {
  uint32_t y = 0;
  for (int i = 0; i < m; ++i) {
    y |= static_cast<uint32_t>((x >> shifts[i]) & 1) << i;
  }
  return y;
}

// theta^T phi(x): the clique sum of qcmrf_tpu/ops/kernels.py::_logpot_block.
template <typename Id>
__device__ __forceinline__ float log_potential(Id x, const float* coef,
                                               const int* shifts,
                                               const int* sizes, int K,
                                               int cmax) {
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    const int m = sizes[k];
    acc = moebius_chain(coef + (k << cmax),
                        clique_slots(x, shifts + k * cmax, m), m, acc);
  }
  return acc;
}

// Copies row b's coefficients and the structure into dynamic shared memory.
struct SharedStructure {
  const float* coef;
  const int* shifts;
  const int* sizes;
};

__device__ __forceinline__ SharedStructure load_structure(
    float* smem, const float* coef, const int* shifts, const int* sizes,
    int K, int cmax, int b) {
  const int ncoef = K << cmax;
  float* s_coef = smem;
  int* s_shifts = reinterpret_cast<int*>(smem + ncoef);
  int* s_sizes = s_shifts + K * cmax;
  const float* row = coef + static_cast<int64_t>(b) * ncoef;
  for (int i = threadIdx.x; i < ncoef; i += blockDim.x) s_coef[i] = row[i];
  for (int i = threadIdx.x; i < K * cmax; i += blockDim.x) {
    s_shifts[i] = shifts[i];
  }
  for (int i = threadIdx.x; i < K; i += blockDim.x) s_sizes[i] = sizes[i];
  __syncthreads();
  return {s_coef, s_shifts, s_sizes};
}

// Philox4x32-10 (Salmon et al., SC'11), the Random123 constants and round.
__device__ __forceinline__ void philox4x32_10(uint32_t c0, uint32_t c1,
                                              uint32_t c2, uint32_t c3,
                                              uint32_t k0, uint32_t k1,
                                              uint32_t& w0, uint32_t& w1,
                                              uint32_t& w2, uint32_t& w3) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  w0 = c0;
  w1 = c1;
  w2 = c2;
  w3 = c3;
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(static_cast<int>(0xff800000u));
}

// ---------------------------------------------------------------------------
// 1. Fused outcome sampler
// ---------------------------------------------------------------------------
// Replaces qcmrf_tpu/ops/sampler_kernel.py::_build_sampler_kernel.
// One thread per shot: x uniform in [0, 2^n) from Philox word 0, then one
// Bernoulli per clique with keep probability c2_k(x) from moebius_chain.
// Random words: key (seed, stream), counter (shot_lo, shot_hi, j, 0); word
// t = k + 1 of the shot's stream drives clique k, as u = (w >> 8) * 2^-24.
// Bound on this card: integer and float ALU work (10 Philox rounds per four
// cliques plus the chain), not memory: the parts mode writes 8 bytes a shot
// and the count mode none. The design keeps everything but the outputs in
// registers, the coefficients in shared memory, and reduces the count in
// the block before one 64-bit atomic.
enum SampleMode { kParts = 0, kFlagsX = 1, kFlags = 2, kCount = 3 };

__global__ void __launch_bounds__(kThreads)
sampler_kernel(const float* __restrict__ coef, const int* __restrict__ shifts,
               const int* __restrict__ sizes, int K, int cmax, int n,
               int64_t shots, uint32_t seed, uint32_t stream0, int mode,
               int32_t* __restrict__ x_out, int32_t* __restrict__ a_out,
               unsigned long long* __restrict__ count_out) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const SharedStructure st =
      load_structure(smem, coef, shifts, sizes, K, cmax, b);

  const int64_t shot =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int accept = 0;
  if (shot < shots) {
    const uint32_t k0 = seed;
    const uint32_t k1 = stream0 + static_cast<uint32_t>(b);
    const uint32_t lo = static_cast<uint32_t>(shot);
    const uint32_t hi = static_cast<uint32_t>(shot >> 32);
    uint32_t w0, w1, w2, w3;
    philox4x32_10(lo, hi, 0u, 0u, k0, k1, w0, w1, w2, w3);
    const uint32_t x = w0 & ((1u << n) - 1u);
    uint32_t fired = 0;
    accept = 1;
    for (int k = 0; k < K; ++k) {
      const int t = k + 1;
      if ((t & 3) == 0) {
        philox4x32_10(lo, hi, static_cast<uint32_t>(t >> 2), 0u, k0, k1, w0,
                      w1, w2, w3);
      }
      const int q = t & 3;
      const uint32_t w = q == 0 ? w0 : q == 1 ? w1 : q == 2 ? w2 : w3;
      const float u = __fmul_rn(__uint2float_rn(w >> 8), 5.9604644775390625e-08f);
      const int m = st.sizes[k];
      const float c2 = moebius_chain(
          st.coef + (k << cmax), clique_slots(x, st.shifts + k * cmax, m), m,
          0.0f);
      if (mode == kParts) {
        fired |= static_cast<uint32_t>(u >= c2) << k;
      } else {
        accept &= static_cast<int>(u < c2);
      }
    }
    const int64_t o = static_cast<int64_t>(b) * shots + shot;
    if (mode == kParts) {
      x_out[o] = static_cast<int32_t>(x);
      a_out[o] = static_cast<int32_t>(fired);
    } else if (mode == kFlagsX) {
      x_out[o] = static_cast<int32_t>(x);
      a_out[o] = accept;
    } else if (mode == kFlags) {
      a_out[o] = accept;
    }
  }
  if (mode == kCount) {
    // threads past the ragged tail hold accept = 0
    __shared__ int warp_sums[kThreads / 32];
    int c = accept;
    for (int off = 16; off > 0; off >>= 1) {
      c += __shfl_down_sync(0xffffffffu, c, off);
    }
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
    __syncthreads();
    if (threadIdx.x == 0) {
      int total = 0;
      for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
      if (total) {
        atomicAdd(count_out + b, static_cast<unsigned long long>(total));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. Log-potential table
// ---------------------------------------------------------------------------
// Replaces qcmrf_tpu/ops/kernels.py::_build_logpot_kernel and its single-
// program twin _build_logpot_loop_kernel (both give the same table).
// One thread per int64 state id (grid-stride), beta * theta^T phi(x), with
// the optional 2^(-n/2) * exp(lp / 2) amplitude epilogue.
// Bound on this card: float ALU work of the chains (about 3 operations per
// subset per clique) against 4 bytes written per state; the writes are
// coalesced and nothing else touches device memory.
__global__ void __launch_bounds__(kThreads)
logpot_kernel(const float* __restrict__ coef, const int* __restrict__ shifts,
              const int* __restrict__ sizes, int K, int cmax,
              int64_t num_states, float beta, int fuse_amp, float amp_scale,
              float* __restrict__ out) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const SharedStructure st =
      load_structure(smem, coef, shifts, sizes, K, cmax, b);
  float* row = out + static_cast<int64_t>(b) * num_states;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t x = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       x < num_states; x += stride) {
    float v = __fmul_rn(
        beta, log_potential(x, st.coef, st.shifts, st.sizes, K, cmax));
    if (fuse_amp) v = __fmul_rn(expf(__fmul_rn(0.5f, v)), amp_scale);
    row[x] = v;
  }
}

// ---------------------------------------------------------------------------
// 3. The block-invariant split, and the streaming logsumexp
// ---------------------------------------------------------------------------
// The split evaluator of lse_kernel and lnz_moments_kernel (the port of
// qcmrf_tpu/ops/kernels.py::_split_logpot, the JAX loop kernels' split).
// A block's states are cut into sub-blocks of 2^L consecutive ids, across
// which h = x >> L is fixed. The log-potential is sum_g c_g [x holds g] over
// the monomials g of the structure (c_g: the sum of the coefficient entries
// whose subset is g). With g's low part t (an index into [0, 2^L)) and high
// part hm (a mask on h), a sub-block needs P[t] = sum of c_g over the
// monomials of target t with (h & hm) == hm, and then the subset-sum (zeta)
// transform value[xl] = sum_{t subset of xl} P[t], L add stages, gives the
// log-potential of its 2^L states. qcmrf_tpu_torch/ops/kernels.py::
// split_plan builds the plan from the structure alone: the monomials sorted
// by target, and every fixed-order sum cut into items of about sqrt(its
// length) entries, summed by one thread each, then each group's items by
// one thread. No atomics: every sum has one order, and two launches on the
// same inputs are bit-equal.
//
// A thread holds R = 2^L / 256 values of a sub-block (R = 1 below L = 8,
// where threads past 2^L idle): value r of thread tid is xl = r * 256 +
// tid, so id bits 0-4 are lane bits, 5-7 warp bits and 8 up register bits.
// The transform's stages on bits 5-7 run in shared memory on P, those on
// bits 0-4 by __shfl_xor_sync and those on bits 8 up inside a thread's
// registers, as the lane pass of gate_kernels.cu does its butterflies.
// The plan's per-sub-block tables in shared memory.
struct SplitShared {
  const unsigned long long* hm;  // (U,)
  float* c;                      // (U,) the monomial coefficients
  const int* m_items;
  const int* m_heads;
  const int* targets;
  float* part;                   // (max(CI, MI),) item sums
  float* P;                      // (2^L,) zero between sub-blocks
};

// Carves the tables out of dynamic shared memory (`base`: U 64-bit masks,
// then `u64_extra` 64-bit slots of the caller's, then the 32-bit tables),
// copies them, computes row `coef_row`'s monomial coefficients in the
// plan's order and zeroes P; `*rest` points past the tables.
__device__ __forceinline__ SplitShared load_split(
    unsigned long long* base, int u64_extra, const SplitPlan& pl,
    const float* __restrict__ coef_row, float** rest) {
  unsigned long long* s_hm = base;
  float* s_c = reinterpret_cast<float*>(base + pl.U + u64_extra);
  int* s_items = reinterpret_cast<int*>(s_c + pl.U);
  int* s_heads = s_items + pl.MI + 1;
  int* s_targets = s_heads + pl.G + 1;
  float* s_part = reinterpret_cast<float*>(s_targets + pl.G);
  float* s_P = s_part + (pl.CI > pl.MI ? pl.CI : pl.MI);
  *rest = s_P + (1 << pl.L);
  for (int i = threadIdx.x; i < pl.U; i += blockDim.x) s_hm[i] = pl.hm[i];
  for (int i = threadIdx.x; i <= pl.MI; i += blockDim.x) {
    s_items[i] = pl.m_items[i];
  }
  for (int i = threadIdx.x; i <= pl.G; i += blockDim.x) {
    s_heads[i] = pl.m_heads[i];
  }
  for (int i = threadIdx.x; i < pl.G; i += blockDim.x) {
    s_targets[i] = pl.targets[i];
  }
  for (int i = threadIdx.x; i < (1 << pl.L); i += blockDim.x) s_P[i] = 0.0f;
  for (int i = threadIdx.x; i < pl.CI; i += blockDim.x) {
    float a = 0.0f;
    for (int j = pl.c_items[i]; j < pl.c_items[i + 1]; ++j) {
      a += coef_row[pl.coef_index[j]];
    }
    s_part[i] = a;
  }
  __syncthreads();
  for (int u = threadIdx.x; u < pl.U; u += blockDim.x) {
    float a = 0.0f;
    for (int i = pl.c_heads[u]; i < pl.c_heads[u + 1]; ++i) a += s_part[i];
    s_c[u] = a;
  }
  __syncthreads();
  return {s_hm, s_c, s_items, s_heads, s_targets, s_part, s_P};
}

// Low index of pair q of the 2^(L-1) pairs that differ in bit j.
__device__ __forceinline__ int pair_low(int q, int j) {
  return ((q >> j) << (j + 1)) | (q & ((1 << j) - 1));
}

// The stages of the subset-sum transform (kSuperset: the superset sums)
// on the lane bits 0-4 and the register bits 8 up of a thread's R values.
template <bool kSuperset, int R>
__device__ __forceinline__ void transform_in_registers(float (&v)[R],
                                                       int L) {
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < 5 && j < L; ++j) {
    const bool take = (((lane >> j) & 1) != 0) != kSuperset;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float o = __shfl_xor_sync(0xffffffffu, v[r], 1 << j);
      if (take) v[r] += o;
    }
  }
#pragma unroll
  for (int bit = 1; bit < R; bit <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (((r & bit) != 0) != kSuperset) v[r] += v[r ^ bit];
    }
  }
}

// The stages on the warp bits 5-7 of a 2^L table in shared memory; each
// ends in a barrier.
template <bool kSuperset>
__device__ __forceinline__ void transform_in_shared(float* t, int L) {
  for (int j = 5; j < L && j < 8; ++j) {
    for (int q = threadIdx.x; q < (1 << (L - 1)); q += blockDim.x) {
      const int lo = pair_low(q, j);
      if (kSuperset) {
        t[lo] += t[lo | (1 << j)];
      } else {
        t[lo | (1 << j)] += t[lo];
      }
    }
    __syncthreads();
  }
}

// beta * theta^T phi(x) of sub-block h: thread tid's values r * 256 + tid
// (0 past 2^L). Starts and ends with P zero; holds four or more barriers,
// so every thread of the block calls it.
template <int R>
__device__ __forceinline__ void split_values(const SplitShared& s,
                                             const SplitPlan& pl,
                                             unsigned long long h, float beta,
                                             float (&v)[R]) {
  for (int i = threadIdx.x; i < pl.MI; i += blockDim.x) {
    float a = 0.0f;
    for (int j = s.m_items[i]; j < s.m_items[i + 1]; ++j) {
      const unsigned long long hm = s.hm[j];
      a += (h & hm) == hm ? s.c[j] : 0.0f;
    }
    s.part[i] = a;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < pl.G; g += blockDim.x) {
    float a = 0.0f;
    for (int i = s.m_heads[g]; i < s.m_heads[g + 1]; ++i) a += s.part[i];
    s.P[s.targets[g]] = a;
  }
  __syncthreads();
  transform_in_shared<false>(s.P, pl.L);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int x = r * kThreads + threadIdx.x;
    v[r] = 0.0f;
    if (x < (1 << pl.L)) {
      v[r] = s.P[x];
      s.P[x] = 0.0f;
    }
  }
  transform_in_registers<false>(v, pl.L);
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = __fmul_rn(beta, v[r]);
}

// Replaces qcmrf_tpu/ops/kernels.py::_build_lse_loop_kernel.
// Block p of lse_geometry sweeps the ids [p * per_block, (p + 1) *
// per_block), sub-block by sub-block through split_values; each thread
// carries a running (max, scaled sum) of its values in registers; the
// block merges its threads' pairs in shared memory and writes one partial
// pair. A CUDA block computes the monomial coefficients once and then
// sweeps blocks p = blockIdx.x, blockIdx.x + gridDim.x, ... combine_lse
// (plain torch) finishes. No table is written.
// Bound on this card: float work, about L / 2 adds a state for the
// transform, beta, the max, the exp and the sum, and the plan's tests a
// sub-block (2 U operations over 2^L states); device memory sees only the
// partials. What the count leaves out sets the pace: 5 shuffles, 3
// shared-memory stages and 6 barriers a sub-block.
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  const float M = fmaxf(m, m2);
  if (M == neg_inf()) return;  // both empty
  s = s * expf(m - M) + s2 * expf(m2 - M);
  m = M;
}

template <int R>
__global__ void __launch_bounds__(kThreads)
lse_kernel(SplitPlan pl, const float* __restrict__ coef, int ncoef,
           int64_t per_block, int parts, float beta,
           float* __restrict__ m_out, float* __restrict__ s_out) {
  extern __shared__ unsigned long long smem64[];
  __shared__ float sm[kThreads];
  __shared__ float ss[kThreads];
  const int b = blockIdx.y;
  float* rest;
  const SplitShared sp = load_split(
      smem64, 0, pl, coef + static_cast<int64_t>(b) * ncoef, &rest);
  const int64_t subs = per_block >> pl.L;
  const bool active = static_cast<int>(threadIdx.x) < (1 << pl.L);
  for (int p = blockIdx.x; p < parts; p += gridDim.x) {
    float m = neg_inf();
    float s = 0.0f;
    const unsigned long long h0 = static_cast<unsigned long long>(p) * subs;
    for (int64_t i = 0; i < subs; ++i) {
      float v[R];
      split_values<R>(sp, pl, h0 + i, beta, v);
      if (active) {
        float top = v[0];
#pragma unroll
        for (int r = 1; r < R; ++r) top = fmaxf(top, v[r]);
        if (top > m) {
          s *= expf(m - top);
          m = top;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) s += expf(v[r] - m);
      }
    }
    sm[threadIdx.x] = m;
    ss[threadIdx.x] = s;
    __syncthreads();
    for (int half = kThreads / 2; half > 0; half >>= 1) {
      if (static_cast<int>(threadIdx.x) < half) {
        float mm = sm[threadIdx.x];
        float sv = ss[threadIdx.x];
        lse_merge(mm, sv, sm[threadIdx.x + half], ss[threadIdx.x + half]);
        sm[threadIdx.x] = mm;
        ss[threadIdx.x] = sv;
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      const int64_t o = static_cast<int64_t>(b) * parts + p;
      m_out[o] = sm[0];
      s_out[o] = ss[0];
    }
  }
}

// ---------------------------------------------------------------------------
// 4. Streaming argmax
// ---------------------------------------------------------------------------
// Replaces qcmrf_tpu/ops/kernels.py::_build_map_loop_kernel.
// Block p sweeps the int64 ids [p * per_block, (p + 1) * per_block), each
// thread carrying its best (value, id) in registers. A thread's ids rise, so
// a strict > keeps the earliest of equal values; the block merges its
// threads' pairs in shared memory (the larger value, and of equal values the
// smaller id) and writes one partial pair. combine_map (plain torch) merges
// the blocks by the same rule, so the earliest state id of the maxima wins.
// Ids are int64 end to end: the TPU kernel's float-encoded block and row
// coordinates are not needed.
// Bound on this card: float ALU work of the chains (as the lse kernel, with a
// compare in place of the exp); device memory sees only the partials.
constexpr int64_t kNoState = INT64_MAX;

__device__ __forceinline__ bool map_better(float v, int64_t x, float bv,
                                           int64_t bx) {
  return v > bv || (v == bv && x < bx);
}

__global__ void __launch_bounds__(kThreads)
map_kernel(const float* __restrict__ coef, const int* __restrict__ shifts,
           const int* __restrict__ sizes, int K, int cmax, int64_t num_states,
           int64_t per_block, float beta, float* __restrict__ v_out,
           int64_t* __restrict__ x_out) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const SharedStructure st =
      load_structure(smem, coef, shifts, sizes, K, cmax, b);
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t end =
      begin + per_block < num_states ? begin + per_block : num_states;
  float best = neg_inf();
  int64_t best_x = kNoState;
  for (int64_t x = begin + threadIdx.x; x < end; x += blockDim.x) {
    const float v = __fmul_rn(
        beta, log_potential(x, st.coef, st.shifts, st.sizes, K, cmax));
    if (v > best || best_x == kNoState) {
      best = v;
      best_x = x;
    }
  }
  __shared__ float sv[kThreads];
  __shared__ int64_t sx[kThreads];
  sv[threadIdx.x] = best;
  sx[threadIdx.x] = best_x;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (static_cast<int>(threadIdx.x) < h &&
        map_better(sv[threadIdx.x + h], sx[threadIdx.x + h], sv[threadIdx.x],
                   sx[threadIdx.x])) {
      sv[threadIdx.x] = sv[threadIdx.x + h];
      sx[threadIdx.x] = sx[threadIdx.x + h];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int64_t o = static_cast<int64_t>(b) * gridDim.x + blockIdx.x;
    v_out[o] = sv[0];
    x_out[o] = sx[0];
  }
}

// ---------------------------------------------------------------------------
// 5. Streaming monomial moments
// ---------------------------------------------------------------------------
// Replaces qcmrf_tpu/ops/kernels.py::_build_gram_loop_kernel (and the XLA
// sweep qcmrf_tpu/models/moments.py::_chunk_mono_partials, which covers
// cliques of more than 4 variables there).
// For every monomial g (a set of variables, given as the state-id bit mask
// mask_g) it sums w(x) = exp(beta * lp(x) - lnZ) over the states x with
// (x & mask_g) == mask_g. Block p sweeps [p * per_block, (p + 1) *
// per_block) in tiles of kThreads states: each thread evaluates one state's
// w through moebius_chain into shared memory beside its id (w = 0 past the
// end), then each thread adds the tile's matching weights to the shared-
// memory sums of the monomials it owns (g = tid, tid + kThreads, ...). One
// float32 partial per (block, monomial); the wrapper adds them in float64.
// The masks and sums of a launch live in shared memory, so the wrapper
// splits a mask list longer than what 227 KB holds over several launches.
// Bound on this card: float ALU work: the chains and one exp per state, then
// a 64-bit mask test and an add per (state, monomial); device memory sees
// only the partials. The TPU kernel's lane packing, selector matrices and
// bf16 operand splits served the MXU and have no counterpart here.
__global__ void __launch_bounds__(kThreads)
moments_kernel(const float* __restrict__ coef, const int* __restrict__ shifts,
               const int* __restrict__ sizes, int K, int cmax,
               int64_t num_states, int64_t per_block, float beta,
               const float* __restrict__ lnz,
               const unsigned long long* __restrict__ masks, int m,
               float* __restrict__ out) {
  // layout: masks (m), tile ids (kThreads), tile weights (kThreads),
  // sums (m), then the structure tables of load_structure
  extern __shared__ unsigned long long smem64[];
  unsigned long long* s_mask = smem64;
  unsigned long long* s_x = s_mask + m;
  float* s_w = reinterpret_cast<float*>(s_x + kThreads);
  float* s_acc = s_w + kThreads;
  const int b = blockIdx.y;
  for (int g = threadIdx.x; g < m; g += blockDim.x) {
    s_mask[g] = masks[g];
    s_acc[g] = 0.0f;
  }
  const SharedStructure st =
      load_structure(s_acc + m, coef, shifts, sizes, K, cmax, b);
  const float lz = lnz[b];
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t end =
      begin + per_block < num_states ? begin + per_block : num_states;
  for (int64_t t0 = begin; t0 < end; t0 += kThreads) {
    const int64_t x = t0 + threadIdx.x;
    float w = 0.0f;
    if (x < end) {
      const float v = __fmul_rn(
          beta, log_potential(x, st.coef, st.shifts, st.sizes, K, cmax));
      w = expf(v - lz);
    }
    s_x[threadIdx.x] = static_cast<unsigned long long>(x);
    s_w[threadIdx.x] = w;
    __syncthreads();
    for (int g = threadIdx.x; g < m; g += kThreads) {
      const unsigned long long mask = s_mask[g];
      float a = 0.0f;
#pragma unroll 8
      for (int t = 0; t < kThreads; ++t) {
        a += (s_x[t] & mask) == mask ? s_w[t] : 0.0f;
      }
      s_acc[g] += a;
    }
    __syncthreads();
  }
  float* row = out + (static_cast<int64_t>(b) * gridDim.x + blockIdx.x) * m;
  for (int g = threadIdx.x; g < m; g += blockDim.x) row[g] = s_acc[g];
}

// ---------------------------------------------------------------------------
// 6. Fused lnZ and monomial moments
// ---------------------------------------------------------------------------
// Replaces qcmrf_tpu/ops/kernels.py::_build_gram_lse_loop_kernel, the
// forward sweep of the differentiable lnZ
// (qcmrf_tpu/models/moments.py::lnz_and_moments_streaming).
// Block p of lse_geometry sweeps [p * per_block, (p + 1) * per_block)
// sub-block by sub-block (split_values) and carries a running max M of v =
// beta * lp(x). Per sub-block h: the block takes the sub-block's max (warp
// shuffles, then one exchange of the warp maxima in shared memory); if it
// raises M, each thread rescales the sums of the monomials it owns by
// exp(M_old - M_new) (the raise is strict, so two -inf never meet; on the
// first sub-block the factor is exp(-inf) = 0 on sums of 0); then w = exp(v
// - M), and the superset-sum transform W[t] = sum_{xl superset of t} w[xl]
// (registers and lanes, then the warp bits in shared memory). Monomial g
// (the id-bit mask mask_g) holds at every state of W[mask_g & (2^L - 1)]
// iff (h & (mask_g >> L)) == mask_g >> L: one test and one add a monomial
// a sub-block. Out: one (M_b, S_b[0..m)) per block; mask 0, the empty
// monomial, gives the block's scaled Z. The masks and sums of a launch live
// in shared memory beside the plan, so the wrapper splits a mask list
// longer than what 227 KB holds over several launches.
// Bound on this card: float work, as lse_kernel's with a second transform
// (the superset sums) and the monomials' tests and adds a sub-block;
// device memory sees only the partials. Float32 throughout, no TF32: the
// JAX package holds its fused sweep to a float32 oracle.
template <int R>
__global__ void __launch_bounds__(kThreads)
lnz_moments_kernel(SplitPlan pl, const float* __restrict__ coef, int ncoef,
                   int64_t per_block, int parts, float beta,
                   const unsigned long long* __restrict__ masks, int m,
                   float* __restrict__ m_out, float* __restrict__ s_out) {
  // layout: the plan's masks, the monomial masks (m), the plan's 32-bit
  // tables, then W (2^L) and the sums (m)
  extern __shared__ unsigned long long smem64[];
  __shared__ float s_warp_max[kThreads / 32];
  unsigned long long* s_mask = smem64 + pl.U;
  for (int g = threadIdx.x; g < m; g += blockDim.x) s_mask[g] = masks[g];
  const int b = blockIdx.y;
  float* rest;
  const SplitShared sp = load_split(
      smem64, m, pl, coef + static_cast<int64_t>(b) * ncoef, &rest);
  float* W = rest;
  float* s_acc = W + (1 << pl.L);
  const int L = pl.L;
  const unsigned long long low = (1ull << L) - 1;
  const int64_t subs = per_block >> L;
  const bool active = static_cast<int>(threadIdx.x) < (1 << L);
  for (int p = blockIdx.x; p < parts; p += gridDim.x) {
    for (int g = threadIdx.x; g < m; g += kThreads) s_acc[g] = 0.0f;
    float M = neg_inf();
    const unsigned long long h0 = static_cast<unsigned long long>(p) * subs;
    for (int64_t i = 0; i < subs; ++i) {
      const unsigned long long h = h0 + i;
      float v[R];
      split_values<R>(sp, pl, h, beta, v);
      float top = neg_inf();
      if (active) {
#pragma unroll
        for (int r = 0; r < R; ++r) top = fmaxf(top, v[r]);
      }
      for (int off = 16; off > 0; off >>= 1) {
        top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, off));
      }
      if ((threadIdx.x & 31) == 0) s_warp_max[threadIdx.x >> 5] = top;
      __syncthreads();
      top = s_warp_max[0];
      for (int k = 1; k < kThreads / 32; ++k) top = fmaxf(top, s_warp_max[k]);
      if (top > M) {
        const float scale = expf(M - top);
        for (int g = threadIdx.x; g < m; g += kThreads) s_acc[g] *= scale;
        M = top;
      }
      float w[R];
#pragma unroll
      for (int r = 0; r < R; ++r) w[r] = active ? expf(v[r] - M) : 0.0f;
      transform_in_registers<true>(w, L);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int x = r * kThreads + threadIdx.x;
        if (x < (1 << L)) W[x] = w[r];
      }
      __syncthreads();
      transform_in_shared<true>(W, L);
      for (int g = threadIdx.x; g < m; g += kThreads) {
        const unsigned long long mask = s_mask[g];
        const unsigned long long gh = mask >> L;
        if ((h & gh) == gh) s_acc[g] += W[mask & low];
      }
    }
    const int64_t o = static_cast<int64_t>(b) * parts + p;
    if (threadIdx.x == 0) m_out[o] = M;
    float* row = s_out + o * m;
    for (int g = threadIdx.x; g < m; g += kThreads) row[g] = s_acc[g];
  }
}

size_t structure_smem_bytes(int K, int cmax) {
  return (static_cast<size_t>(K) << cmax) * sizeof(float) +
         static_cast<size_t>(K) * (cmax + 1) * sizeof(int);
}

size_t moments_smem_bytes(int K, int cmax, int m) {
  return static_cast<size_t>(m + kThreads) *
             (sizeof(unsigned long long) + sizeof(float)) +
         structure_smem_bytes(K, cmax);
}

// Dynamic shared memory of load_split's tables and P: U 64-bit masks and
// U coefficients, the item and group tables, the item sums and P.
size_t split_smem_bytes(const SplitPlan& pl) {
  const int part = pl.CI > pl.MI ? pl.CI : pl.MI;
  return static_cast<size_t>(pl.U) *
             (sizeof(unsigned long long) + sizeof(float)) +
         static_cast<size_t>(pl.MI + 2 * pl.G + 2 + part + (1 << pl.L)) *
             sizeof(int);
}

// lnz_moments_kernel's: the split's, the masks and sums, and W.
size_t lnz_moments_smem_bytes(const SplitPlan& pl, int m) {
  return split_smem_bytes(pl) +
         static_cast<size_t>(m) *
             (sizeof(unsigned long long) + sizeof(float)) +
         (static_cast<size_t>(1) << pl.L) * sizeof(float);
}

// CUDA blocks of a split sweep: each computes the monomial coefficients
// once and sweeps several blocks of lse_geometry; 512 a launch fill the
// 132 SMs about once at the kernels' occupancy.
dim3 split_grid(int parts, int B) {
  int blocks = 512 / B;
  if (blocks < 1) blocks = 1;
  if (blocks > parts) blocks = parts;
  return dim3(blocks, B);
}

// launch(std::integral_constant<int, R>) for the R = 2^(L - 8) values a
// thread (1 below L = 8) of a sub-block of 2^L states; L runs 1..12.
template <typename Launch>
int with_values_per_thread(int L, Launch launch) {
  if (L < 1 || L > 12) return static_cast<int>(cudaErrorInvalidValue);
  switch (L <= 8 ? 1 : 1 << (L - 8)) {
    case 1: return launch(std::integral_constant<int, 1>());
    case 2: return launch(std::integral_constant<int, 2>());
    case 4: return launch(std::integral_constant<int, 4>());
    case 8: return launch(std::integral_constant<int, 8>());
    default: return launch(std::integral_constant<int, 16>());
  }
}

// Lets `kernel` take `bytes` of dynamic shared memory. Past 48 KB, static
// and dynamic together, a launch must opt in; the wrappers keep the sum
// within sm_90's 227 KB. Set on every launch: it is a host-side attribute.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

unsigned grid_blocks(int64_t items, int64_t cap) {
  int64_t blocks = (items + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

template <int R>
int launch_lse(const SplitPlan& pl, const float* coef, int B, int ncoef,
               int64_t per_block, int parts, float beta, float* m_out,
               float* s_out, void* stream) {
  const size_t smem = split_smem_bytes(pl);
  const cudaError_t err = allow_shared(lse_kernel<R>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lse_kernel<R><<<split_grid(parts, B), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      pl, coef, ncoef, per_block, parts, beta, m_out, s_out);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch_lnz_moments(const SplitPlan& pl, const float* coef, int B,
                       int ncoef, int64_t per_block, int parts, float beta,
                       const unsigned long long* masks, int m, float* m_out,
                       float* s_out, void* stream) {
  const size_t smem = lnz_moments_smem_bytes(pl, m);
  const cudaError_t err = allow_shared(lnz_moments_kernel<R>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lnz_moments_kernel<R><<<split_grid(parts, B), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      pl, coef, ncoef, per_block, parts, beta, masks, m, m_out, s_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int qcmrf_sample(const float* coef, const int* shifts, const int* sizes,
                 int B, int K, int cmax, int n, int64_t shots, uint32_t seed,
                 uint32_t stream0, int mode, int32_t* x_out, int32_t* a_out,
                 unsigned long long* count_out, void* stream) {
  const dim3 grid(grid_blocks(shots, INT64_C(0x7fffffff)), B);
  const size_t smem = structure_smem_bytes(K, cmax);
  const cudaError_t err = allow_shared(sampler_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sampler_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      coef, shifts, sizes, K, cmax, n, shots, seed, stream0, mode, x_out,
      a_out, count_out);
  return static_cast<int>(cudaGetLastError());
}

int qcmrf_logpot(const float* coef, const int* shifts, const int* sizes,
                 int B, int K, int cmax, int64_t num_states, float beta,
                 int fuse_amp, float amp_scale, float* out, void* stream) {
  // grid-stride: enough blocks to fill 132 SMs many times over
  const dim3 grid(grid_blocks(num_states, 132 * 64), B);
  const size_t smem = structure_smem_bytes(K, cmax);
  const cudaError_t err = allow_shared(logpot_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  logpot_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      coef, shifts, sizes, K, cmax, num_states, beta, fuse_amp, amp_scale,
      out);
  return static_cast<int>(cudaGetLastError());
}

int qcmrf_lse(SplitPlan plan, const float* coef, int B, int ncoef,
              int64_t per_block, int parts, float beta, float* m_out,
              float* s_out, void* stream) {
  return with_values_per_thread(plan.L, [&](auto r) {
    return launch_lse<decltype(r)::value>(plan, coef, B, ncoef, per_block,
                                          parts, beta, m_out, s_out, stream);
  });
}

int qcmrf_map(const float* coef, const int* shifts, const int* sizes, int B,
              int K, int cmax, int64_t num_states, int64_t per_block,
              int parts, float beta, float* v_out, int64_t* x_out,
              void* stream) {
  const dim3 grid(parts, B);
  const size_t smem = structure_smem_bytes(K, cmax);
  const cudaError_t err = allow_shared(map_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  map_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      coef, shifts, sizes, K, cmax, num_states, per_block, beta, v_out,
      x_out);
  return static_cast<int>(cudaGetLastError());
}

int qcmrf_moments(const float* coef, const int* shifts, const int* sizes,
                  int B, int K, int cmax, int64_t num_states,
                  int64_t per_block, int parts, float beta, const float* lnz,
                  const unsigned long long* masks, int m, float* out,
                  void* stream) {
  const dim3 grid(parts, B);
  const size_t smem = moments_smem_bytes(K, cmax, m);
  const cudaError_t err = allow_shared(moments_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  moments_kernel<<<grid, kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      coef, shifts, sizes, K, cmax, num_states, per_block, beta, lnz, masks,
      m, out);
  return static_cast<int>(cudaGetLastError());
}

int qcmrf_lnz_moments(SplitPlan plan, const float* coef, int B, int ncoef,
                      int64_t per_block, int parts, float beta,
                      const unsigned long long* masks, int m, float* m_out,
                      float* s_out, void* stream) {
  return with_values_per_thread(plan.L, [&](auto r) {
    return launch_lnz_moments<decltype(r)::value>(
        plan, coef, B, ncoef, per_block, parts, beta, masks, m, m_out, s_out,
        stream);
  });
}

const char* qcmrf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
