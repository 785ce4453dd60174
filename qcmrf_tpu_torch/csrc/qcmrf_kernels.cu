// Hand-written Hopper (sm_90a) kernels of the closed-form QCMRF sampling
// path, of exact inference and of exact-MLE training: the fused outcome
// sampler, the log-potential table, the streaming logsumexp, argmax and
// monomial-moment sweeps, and the fused lnZ + moments sweep. All evaluate a
// clique's multilinear (Moebius) form with one shared device function,
// moebius_chain.
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
// Row b of a launch is blockIdx.y.

#include <cstdint>
#include <cuda_runtime.h>

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
// 3. Streaming logsumexp
// ---------------------------------------------------------------------------
// Replaces qcmrf_tpu/ops/kernels.py::_build_lse_loop_kernel.
// Block p sweeps the int64 ids [p * per_block, (p + 1) * per_block), each
// thread carrying a running (max, scaled sum) in registers; the block merges
// its threads' pairs in shared memory and writes one partial pair.
// combine_lse (plain torch) finishes. No table is written.
// Bound on this card: float ALU work (the chains plus one expf per state);
// device memory sees only the partials.
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  const float M = fmaxf(m, m2);
  if (M == neg_inf()) return;  // both empty
  s = s * expf(m - M) + s2 * expf(m2 - M);
  m = M;
}

__global__ void __launch_bounds__(kThreads)
lse_kernel(const float* __restrict__ coef, const int* __restrict__ shifts,
           const int* __restrict__ sizes, int K, int cmax, int64_t num_states,
           int64_t per_block, float beta, float* __restrict__ m_out,
           float* __restrict__ s_out) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const SharedStructure st =
      load_structure(smem, coef, shifts, sizes, K, cmax, b);
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t end =
      begin + per_block < num_states ? begin + per_block : num_states;
  float m = neg_inf();
  float s = 0.0f;
  for (int64_t x = begin + threadIdx.x; x < end; x += blockDim.x) {
    const float v = __fmul_rn(
        beta, log_potential(x, st.coef, st.shifts, st.sizes, K, cmax));
    if (v > m) {
      s = s * expf(m - v) + 1.0f;
      m = v;
    } else {
      s += expf(v - m);
    }
  }
  __shared__ float sm[kThreads];
  __shared__ float ss[kThreads];
  sm[threadIdx.x] = m;
  ss[threadIdx.x] = s;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (static_cast<int>(threadIdx.x) < h) {
      float mm = sm[threadIdx.x];
      float sv = ss[threadIdx.x];
      lse_merge(mm, sv, sm[threadIdx.x + h], ss[threadIdx.x + h]);
      sm[threadIdx.x] = mm;
      ss[threadIdx.x] = sv;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int64_t o = static_cast<int64_t>(b) * gridDim.x + blockIdx.x;
    m_out[o] = sm[0];
    s_out[o] = ss[0];
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
// moments_kernel without a given lnZ: block p sweeps [p * per_block, (p +
// 1) * per_block) in tiles of kThreads states and carries a running max M
// of v = beta * lp(x), as lse_kernel does for its one sum. Per tile: each
// thread evaluates one state's v; the block takes the tile's max (warp
// shuffles, then one exchange of the warp maxima in shared memory); if it
// raises M, each thread rescales the sums of the monomials it owns by
// exp(M_old - M_new) (the raise is strict, so two -inf never meet; on the
// first tile the factor is exp(-inf) = 0 on sums of 0); then w = exp(v - M)
// goes into shared memory beside the state id and the matching weights are
// added as in moments_kernel. Out: one (M_b, S_b[0..m)) per block; mask 0,
// the empty monomial, gives the block's scaled Z. A block past the last
// state would write M = -inf and zero sums, which combine_lnz_moments
// (plain torch, float64) weighs by exp(-inf) = 0.
// Bound on this card: float ALU work, as moments_kernel's (the chains, one
// exp per state, a 64-bit mask test and an add per (state, monomial)), plus
// one max per state and, each time M rises, one product per monomial;
// device memory sees only the partials. Float32 FMAs throughout, no TF32:
// the JAX package holds its fused sweep to a float32 oracle.
__global__ void __launch_bounds__(kThreads)
lnz_moments_kernel(const float* __restrict__ coef,
                   const int* __restrict__ shifts,
                   const int* __restrict__ sizes, int K, int cmax,
                   int64_t num_states, int64_t per_block, float beta,
                   const unsigned long long* __restrict__ masks, int m,
                   float* __restrict__ m_out, float* __restrict__ s_out) {
  // layout as moments_kernel's: masks (m), tile ids (kThreads), tile
  // weights (kThreads), sums (m), then the structure tables
  extern __shared__ unsigned long long smem64[];
  __shared__ float s_warp_max[kThreads / 32];
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
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t end =
      begin + per_block < num_states ? begin + per_block : num_states;
  float M = neg_inf();
  for (int64_t t0 = begin; t0 < end; t0 += kThreads) {
    const int64_t x = t0 + threadIdx.x;
    float v = neg_inf();
    if (x < end) {
      v = __fmul_rn(beta,
                    log_potential(x, st.coef, st.shifts, st.sizes, K, cmax));
    }
    float tile = v;
    for (int off = 16; off > 0; off >>= 1) {
      tile = fmaxf(tile, __shfl_xor_sync(0xffffffffu, tile, off));
    }
    if ((threadIdx.x & 31) == 0) s_warp_max[threadIdx.x >> 5] = tile;
    __syncthreads();
    tile = s_warp_max[0];
    for (int i = 1; i < kThreads / 32; ++i) tile = fmaxf(tile, s_warp_max[i]);
    if (tile > M) {
      const float scale = expf(M - tile);
      for (int g = threadIdx.x; g < m; g += kThreads) s_acc[g] *= scale;
      M = tile;
    }
    s_x[threadIdx.x] = static_cast<unsigned long long>(x);
    s_w[threadIdx.x] = x < end ? expf(v - M) : 0.0f;
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
  const int64_t o = static_cast<int64_t>(b) * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) m_out[o] = M;
  float* row = s_out + o * m;
  for (int g = threadIdx.x; g < m; g += blockDim.x) row[g] = s_acc[g];
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

int qcmrf_lse(const float* coef, const int* shifts, const int* sizes, int B,
              int K, int cmax, int64_t num_states, int64_t per_block,
              int parts, float beta, float* m_out, float* s_out,
              void* stream) {
  const dim3 grid(parts, B);
  const size_t smem = structure_smem_bytes(K, cmax);
  const cudaError_t err = allow_shared(lse_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lse_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      coef, shifts, sizes, K, cmax, num_states, per_block, beta, m_out,
      s_out);
  return static_cast<int>(cudaGetLastError());
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

int qcmrf_lnz_moments(const float* coef, const int* shifts, const int* sizes,
                      int B, int K, int cmax, int64_t num_states,
                      int64_t per_block, int parts, float beta,
                      const unsigned long long* masks, int m, float* m_out,
                      float* s_out, void* stream) {
  const dim3 grid(parts, B);
  const size_t smem = moments_smem_bytes(K, cmax, m);
  const cudaError_t err = allow_shared(lnz_moments_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lnz_moments_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      coef, shifts, sizes, K, cmax, num_states, per_block, beta, masks, m,
      m_out, s_out);
  return static_cast<int>(cudaGetLastError());
}

const char* qcmrf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
