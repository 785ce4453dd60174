// Hand-written Hopper (sm_90a) kernels of the closed-form QCMRF sampling
// path, of exact inference and of exact-MLE training: the fused outcome
// sampler, the log-potential table, the streaming logsumexp, argmax and
// monomial-moment sweeps, and the fused lnZ + moments sweep. The table,
// the logsumexp and both moment sweeps evaluate whole sub-blocks of states
// through the block-invariant split (section 2); the argmax screens states
// through the split and decides among the few near its maximum with the
// per-state chain, log_potential (section 4); the sampler reads each
// clique's keep probability from a shared-memory table (section 1).
//
// Built by qcmrf_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes. Each extern "C" entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().
//
// Structure arguments:
//   coef   float32 (B, K << cmax)  per-row Moebius coefficients, clique-major;
//                                  subset s of clique k at k * 2^cmax + s
//   plan   SplitPlan               the split's tables (section 2)
// and for the argmax's chain (log_potential) also
//   shifts int32   (K, cmax)       state-id right-shift of clique k's slot i
//   sizes  int32   (K,)            clique sizes (slots >= size are unused)
// Row b of a launch is blockIdx.y.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

// The block-invariant split of a structure (section 2), built by
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

// moebius_chain and clique_slots of an M-variable clique, unrolled: the
// same operations in the same order.
template <int M, typename Id>
__device__ __forceinline__ float clique_chain(Id x, const float* coef,
                                              const int* shifts, float acc) {
  uint32_t y = 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    y |= static_cast<uint32_t>((x >> shifts[i]) & 1) << i;
  }
  acc = __fadd_rn(acc, coef[0]);
#pragma unroll
  for (uint32_t s = 1; s < (1u << M); ++s) {
    const float p = ((y & s) == s) ? 1.0f : 0.0f;
    acc = __fadd_rn(acc, __fmul_rn(coef[s], p));
  }
  return acc;
}

// theta^T phi(x): the clique sum of qcmrf_tpu/ops/kernels.py::_logpot_block.
// Cliques of up to 4 variables take the unrolled chain.
template <typename Id>
__device__ __forceinline__ float log_potential(Id x, const float* coef,
                                               const int* shifts,
                                               const int* sizes, int K,
                                               int cmax) {
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    const int m = sizes[k];
    const float* c = coef + (k << cmax);
    const int* sh = shifts + k * cmax;
    switch (m) {
      case 1: acc = clique_chain<1>(x, c, sh, acc); break;
      case 2: acc = clique_chain<2>(x, c, sh, acc); break;
      case 3: acc = clique_chain<3>(x, c, sh, acc); break;
      case 4: acc = clique_chain<4>(x, c, sh, acc); break;
      default: acc = moebius_chain(c, clique_slots(x, sh, m), m, acc);
    }
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

// Philox4x32-10 (Salmon et al., SC'11), the Random123 constants and round,
// with the key of every round computed once (a key is fixed per row).
struct PhiloxKey {
  uint32_t k0[10];
  uint32_t k1[10];
};

__device__ __forceinline__ PhiloxKey philox_key(uint32_t k0, uint32_t k1) {
  PhiloxKey key;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    key.k0[r] = k0 + static_cast<uint32_t>(r) * 0x9E3779B9u;
    key.k1[r] = k1 + static_cast<uint32_t>(r) * 0xBB67AE85u;
  }
  return key;
}

// Words (w0, w1, w2, w3) of counter (c0, c1, c2, c3): per round two 32x32
// -> 64-bit products, whose high words are XORed with the other counter
// words and the round's key.
__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t c3,
                                               const PhiloxKey& key) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint64_t p0 = static_cast<uint64_t>(0xD2511F53u) * c0;
    const uint64_t p1 = static_cast<uint64_t>(0xCD9E8D57u) * c2;
    c0 = static_cast<uint32_t>(p1 >> 32) ^ c1 ^ key.k0[r];
    c1 = static_cast<uint32_t>(p1);
    c2 = static_cast<uint32_t>(p0 >> 32) ^ c3 ^ key.k1[r];
    c3 = static_cast<uint32_t>(p0);
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(static_cast<int>(0xff800000u));
}

// ---------------------------------------------------------------------------
// 1. Fused outcome sampler
// ---------------------------------------------------------------------------
// Replaces qcmrf_tpu/ops/sampler_kernel.py::_build_sampler_kernel.
// Per shot: x uniform in [0, 2^n) from Philox word 0, then one Bernoulli
// per clique k that fires when u >= c2_k(x) = exp(beta theta_{k, y}), y the
// clique's slot word of x. Random words: key (seed, stream), counter
// (shot_lo, shot_hi, j, 0); word t = k + 1 of the shot's stream drives
// clique k, as u = (w >> 8) * 2^-24.
//
// c2 is one shared-memory load: the TPU kernel rebuilt it from Moebius
// coefficients by a chain of products and sums, because a TPU vector unit
// has no per-lane gather; here a block copies the row's keep-probability
// table into shared memory once, as integer thresholds: u >= c2 iff (w >>
// 8) >= ceil(c2 * 2^24) (u is a multiple of 2^-24 and c2 * 2^24 is exact),
// so the comparison needs no conversion to float. The slot word is CMAX
// shifts and masks unrolled; a clique with fewer slots points the rest at
// id bit 31, which is 0 (n <= 31). The table is padded with cliques that
// never fire up to a whole number of Philox calls, so every call's four
// words go to four cliques with no tail test.
//
// Blocks stay resident (a few an SM, a grid-stride loop over shots): the
// table is loaded once a block and the round keys once a thread.
// Bound on this card: integer and logic work, Philox's 10 rounds of two
// wide products and two XORs a call (1 + floor(K / 4) calls a shot) and
// about a dozen instructions a clique; memory sees 8 bytes a shot in the parts
// mode and none in the count mode, which reduces in the block before one
// 64-bit atomic (an integer: exact in any order).
enum SampleMode { kParts = 0, kFlagsX = 1, kFlags = 2, kCount = 3 };

// Cliques of the padded table: 1 + K words rounded up to whole calls,
// less word 0.
__host__ __device__ __forceinline__ int sampler_cliques(int K) {
  return 4 * ((K + 4) / 4) - 1;
}

// 1 when word w fires clique k at x.
template <int CMAX>
__device__ __forceinline__ uint32_t fires(uint32_t x, uint32_t w, int k,
                                          const uint32_t* thr,
                                          const int* sh) {
  uint32_t y = 0;
#pragma unroll
  for (int i = 0; i < CMAX; ++i) {
    y |= ((x >> sh[k * CMAX + i]) & 1u) << i;
  }
  return (w >> 8) >= thr[(k << CMAX) | y] ? 1u : 0u;
}

template <int CMAX>
__global__ void __launch_bounds__(kThreads)
sampler_kernel(const float* __restrict__ keep, const int* __restrict__ shifts,
               int K, int n, int64_t shots, uint32_t seed, uint32_t stream0,
               int mode, int32_t* __restrict__ x_out,
               int32_t* __restrict__ a_out,
               unsigned long long* __restrict__ count_out) {
  // layout: thresholds (Kp << CMAX), then slot shifts (Kp * CMAX)
  extern __shared__ uint32_t s_thr[];
  __shared__ unsigned long long warp_sums[kThreads / 32];
  const int b = blockIdx.y;
  const int Kp = sampler_cliques(K);
  int* s_sh = reinterpret_cast<int*>(s_thr + (Kp << CMAX));
  const float* row = keep + static_cast<int64_t>(b) * (K << CMAX);
  for (int i = threadIdx.x; i < (Kp << CMAX); i += blockDim.x) {
    // __float2uint_ru: the ceiling, saturating past 2^32
    s_thr[i] = i < (K << CMAX) ? __float2uint_ru(row[i] * 16777216.0f)
                               : 0xFFFFFFFFu;
  }
  for (int i = threadIdx.x; i < Kp * CMAX; i += blockDim.x) {
    s_sh[i] = i < K * CMAX ? shifts[i] : 31;
  }
  __syncthreads();

  const PhiloxKey key = philox_key(seed, stream0 + static_cast<uint32_t>(b));
  const uint32_t xmask = (1u << n) - 1u;
  const int calls = (Kp + 1) >> 2;
  unsigned long long accepted = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t shot = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
       shot < shots; shot += stride) {
    const uint32_t lo = static_cast<uint32_t>(shot);
    const uint32_t hi = static_cast<uint32_t>(shot >> 32);
    uint4 w = philox4x32_10(lo, hi, 0u, 0u, key);
    const uint32_t x = w.x & xmask;
    // bit k: clique k fired; `any` keeps every clique past 32 too
    uint32_t fired = fires<CMAX>(x, w.y, 0, s_thr, s_sh) |
                     fires<CMAX>(x, w.z, 1, s_thr, s_sh) << 1 |
                     fires<CMAX>(x, w.w, 2, s_thr, s_sh) << 2;
    uint32_t any = fired;
    for (int j = 1; j < calls; ++j) {
      w = philox4x32_10(lo, hi, static_cast<uint32_t>(j), 0u, key);
      const int k = 4 * j - 1;
      const uint32_t g = fires<CMAX>(x, w.x, k, s_thr, s_sh) |
                         fires<CMAX>(x, w.y, k + 1, s_thr, s_sh) << 1 |
                         fires<CMAX>(x, w.z, k + 2, s_thr, s_sh) << 2 |
                         fires<CMAX>(x, w.w, k + 3, s_thr, s_sh) << 3;
      // the parts mode has K <= 32: k <= 31, and bits past 31 are padding
      fired |= g << (k & 31);
      any |= g;
    }
    const int64_t o = static_cast<int64_t>(b) * shots + shot;
    if (mode == kParts) {
      x_out[o] = static_cast<int32_t>(x);
      a_out[o] = static_cast<int32_t>(fired);
    } else if (mode == kFlagsX) {
      x_out[o] = static_cast<int32_t>(x);
      a_out[o] = any == 0;
    } else if (mode == kFlags) {
      a_out[o] = any == 0;
    } else {
      accepted += any == 0;
    }
  }
  if (mode == kCount) {
    for (int off = 16; off > 0; off >>= 1) {
      accepted += __shfl_down_sync(0xffffffffu, accepted, off);
    }
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = accepted;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long total = 0;
      for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
      if (total) atomicAdd(count_out + b, total);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. The block-invariant split, and the streaming logsumexp
// ---------------------------------------------------------------------------
// The split evaluator of lse_kernel, logpot_kernel and lnz_moments_kernel
// (the port of qcmrf_tpu/ops/kernels.py::_split_logpot, the JAX loop
// kernels' split).
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
// one thread. The monomial coefficients and the P sums are taken in
// float64 and P is rounded to float32 once: float32 sums there carry an
// error common to every state of a sub-block, which does not average out
// of a moment (about 3e-6 on 650 4-variable cliques at |v| near 30). No
// atomics: every sum has one order, and two launches on the same inputs
// are bit-equal.
//
// The state-id offset (the JAX loop kernels' x0_blocks). Every split
// kernel sweeps `parts` blocks of per_block ids (lse_geometry of the whole
// 2^n sweep) starting at block x0_blocks, in 64 bits: its block p covers
// ids [(x0_blocks + p) * per_block, (x0_blocks + p + 1) * per_block), and
// its outputs are indexed by p. per_block is a multiple of 2^L (L <=
// log2 per_block), so the offset x0_blocks * per_block is a multiple of
// 2^L: it moves only id bits L and up, the sub-block index h = x >> L
// (by x0_blocks * per_block >> L), never the low bits xl inside a
// sub-block. The split's block-invariant part is a function of xl and of
// the structure alone: the monomials' targets t, the plan's items, the
// monomial coefficients c_g and the transform's stages. It is the same at
// any offset. Only the tests (h & hm) == hm that pick each sub-block's P
// (and the moments' (h & (mask >> L)) tests) see the moved bits, and they
// take the absolute h. So a sweep split into block ranges evaluates every
// state exactly as the whole sweep does, and its partials, in range order,
// are the whole sweep's bit for bit (at x0_blocks = 0, the sweep of before
// the offset existed). Ids past 2^31 stay exact: h and x are 64-bit.
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
  double* c;                     // (U,) the monomial coefficients
  double* part;                  // (max(CI, MI),) item sums
  const int* m_items;
  const int* m_heads;
  const int* targets;
  float* P;                      // (2^L,) zero between sub-blocks
};

// Carves the tables out of dynamic shared memory (`base`: U 64-bit masks,
// then `u64_extra` 64-bit slots of the caller's, then the float64
// coefficients and item sums, then the 32-bit tables and P), copies them,
// computes row `coef_row`'s monomial coefficients in the plan's order and
// zeroes P; `*rest` points past the tables.
__device__ __forceinline__ SplitShared load_split(
    unsigned long long* base, int u64_extra, const SplitPlan& pl,
    const float* __restrict__ coef_row, float** rest) {
  unsigned long long* s_hm = base;
  double* s_c = reinterpret_cast<double*>(base + pl.U + u64_extra);
  double* s_part = s_c + pl.U;
  int* s_items = reinterpret_cast<int*>(s_part +
                                        (pl.CI > pl.MI ? pl.CI : pl.MI));
  int* s_heads = s_items + pl.MI + 1;
  int* s_targets = s_heads + pl.G + 1;
  float* s_P = reinterpret_cast<float*>(s_targets + pl.G);
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
    double a = 0.0;
    for (int j = pl.c_items[i]; j < pl.c_items[i + 1]; ++j) {
      a = __dadd_rn(a, static_cast<double>(coef_row[pl.coef_index[j]]));
    }
    s_part[i] = a;
  }
  __syncthreads();
  for (int u = threadIdx.x; u < pl.U; u += blockDim.x) {
    double a = 0.0;
    for (int i = pl.c_heads[u]; i < pl.c_heads[u + 1]; ++i) {
      a = __dadd_rn(a, s_part[i]);
    }
    s_c[u] = a;
  }
  __syncthreads();
  return {s_hm, s_c, s_part, s_items, s_heads, s_targets, s_P};
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
    double a = 0.0;
    for (int j = s.m_items[i]; j < s.m_items[i + 1]; ++j) {
      const unsigned long long hm = s.hm[j];
      a = __dadd_rn(a, (h & hm) == hm ? s.c[j] : 0.0);
    }
    s.part[i] = a;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < pl.G; g += blockDim.x) {
    double a = 0.0;
    for (int i = s.m_heads[g]; i < s.m_heads[g + 1]; ++i) {
      a = __dadd_rn(a, s.part[i]);
    }
    s.P[s.targets[g]] = __double2float_rn(a);
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
// Block p of a launch sweeps block x0_blocks + p of lse_geometry, the ids
// [(x0_blocks + p) * per_block, (x0_blocks + p + 1) * per_block), sub-block by sub-block through split_values; each thread
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
           int64_t per_block, int64_t x0_blocks, int parts, float beta,
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
    const unsigned long long h0 =
        static_cast<unsigned long long>(x0_blocks + p) * subs;
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
// 3. Log-potential table
// ---------------------------------------------------------------------------
// Replaces qcmrf_tpu/ops/kernels.py::_build_logpot_loop_kernel, the JAX
// package's table past _MAX_GRID, which evaluates the same split
// (_split_logpot), and _build_logpot_kernel, its per-state chain for
// small grids: the two tables differ in the last bits, each value of one
// within 2 e_b of the other's (e_b = gamma_{N+1} |beta| sum |coef_b|,
// kernels.py::split_gap). Block p of a launch (block x0_blocks + p of
// lse_geometry) sweeps its sub-blocks
// through split_values, as lse_kernel, applies beta and the optional
// amplitude epilogue 2^(-n/2) exp(v / 2), and stores each value from its
// register: value r of a warp's 32 lanes is 128 contiguous bytes of the
// row, and a sub-block is 2^L contiguous floats. A store does not hold the
// thread, so a sub-block's writes drain while the block computes the next
// one's P sums and transform (these plain stores were timed on the card
// beside the same stores with the evict-first hint and beside a bulk copy
// of each sub-block from shared memory: the plain stores are the fastest
// on K27, the table the main path writes; PERF.md section 6, row 2).
// Bound on this card: the larger of 4 bytes written a state and the
// split's float work (lse_kernel's without the max, the exp and the sum;
// with the epilogue, its exp and two products a state).
__device__ __forceinline__ float table_value(float v, int fuse_amp,
                                             float amp_scale) {
  return fuse_amp ? __fmul_rn(expf(__fmul_rn(0.5f, v)), amp_scale) : v;
}

template <int R>
__global__ void __launch_bounds__(kThreads)
logpot_kernel(SplitPlan pl, const float* __restrict__ coef, int ncoef,
              int64_t per_block, int64_t x0_blocks, int parts, float beta,
              int fuse_amp,
              float amp_scale, float* __restrict__ out) {
  extern __shared__ unsigned long long smem64[];
  const int b = blockIdx.y;
  float* rest;
  const SplitShared sp = load_split(
      smem64, 0, pl, coef + static_cast<int64_t>(b) * ncoef, &rest);
  const int L = pl.L;
  float* row = out + static_cast<int64_t>(b) * parts * per_block;
  const int64_t subs = per_block >> L;
  for (int p = blockIdx.x; p < parts; p += gridDim.x) {
    const unsigned long long h0 =
        static_cast<unsigned long long>(x0_blocks + p) * subs;
    for (int64_t i = 0; i < subs; ++i) {
      const unsigned long long h = h0 + i;
      float v[R];
      split_values<R>(sp, pl, h, beta, v);
      float* dst = row + ((static_cast<int64_t>(p) * subs + i) << L);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int x = r * kThreads + threadIdx.x;
        if (x < (1 << L)) dst[x] = table_value(v[r], fuse_amp, amp_scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 4. Streaming argmax
// ---------------------------------------------------------------------------
// Replaces qcmrf_tpu/ops/kernels.py::_build_map_loop_kernel.
// Block p of a launch (block x0_blocks + p of lse_geometry; ids absolute)
// writes the best value of beta * theta^T phi(x)
// over its ids as the per-state chain computes it (log_potential, then
// beta, the order of the plain version), and the earliest id that holds
// it: the plain version's answer bit for bit, ties included. The chain
// costs about 3 K 2^cmax operations a state, so the block screens its
// states through the split (split_values, as lse_kernel) and evaluates the
// chain only where the split value is within tol[b] of the block's running
// maximum M. tol[b] (kernels.map_tolerance) is twice the largest
// difference between the split's and the chain's value of any state: both
// sum the same coefficient entries of row b, each rounded at most N times
// (N = K << cmax), so each lies within gamma_{N+1} |beta| sum |coef_b| of
// the exact value. A state x* of the chain's maximum then has a split value
// of at least M_final - tol: the chain ranks x* at or above the split's
// best state s, whose chain value is at least M_final - tol / 2, and the
// split's value of x* is within tol / 2 of its chain value. M rises
// through the sweep, so the threshold fl_down(M - tol) at any sub-block
// lies at or below M_final - tol: every state that could hold the maximum
// is evaluated, with states that tie in the chain among them. Generic
// theta leaves a few candidates a block (about 5 of K27's 2^15); theta = 0
// makes every state one (slower, still exact). A chain is about 4 K
// dependent adds, long beside a sub-block's split, and a thread that ran
// it alone at its sub-block would hold the block at the next barrier with
// one lane of its warp busy: the block lists its candidates in shared
// memory instead (a slot by an integer atomic; past kHeld a thread
// evaluates its candidate at once), and at the block's end its first
// threads evaluate the list lane by lane, one chain's time for up to 32.
// Each thread keeps its best (value, id) by map_better; the block merges
// by the same rule and writes one partial pair, and the candidates it
// evaluated when cand_out is not null.
// combine_map (plain torch) merges the blocks. No float atomics: two
// launches are bit-equal. Ids are int64 end to end.
// Bound on this card: float work, the split's (as lse_kernel's, with a
// compare in place of the exp and the sum) and the candidates' chains;
// device memory sees only the partials.
constexpr int64_t kNoState = INT64_MAX;
// candidates a block holds back for its end
constexpr int kHeld = 256;

__device__ __forceinline__ bool map_better(float v, int64_t x, float bv,
                                           int64_t bx) {
  return v > bv || (v == bv && x < bx);
}

template <int R>
__global__ void __launch_bounds__(kThreads)
map_kernel(SplitPlan pl, const float* __restrict__ coef,
           const int* __restrict__ shifts, const int* __restrict__ sizes,
           int K, int cmax, int64_t per_block, int64_t x0_blocks, int parts,
           float beta, const float* __restrict__ tol, float* __restrict__ v_out,
           int64_t* __restrict__ x_out, long long* __restrict__ cand_out) {
  // layout: the split's tables and P, then the structure tables of
  // load_structure for the chain
  extern __shared__ unsigned long long smem64[];
  __shared__ float s_warp_max[kThreads / 32];
  __shared__ long long s_warp_cand[kThreads / 32];
  __shared__ float sv[kThreads];
  __shared__ int64_t sx[kThreads];
  __shared__ int64_t s_held_x[kHeld];
  __shared__ int s_held;
  if (threadIdx.x == 0) s_held = 0;
  const int b = blockIdx.y;
  float* rest;
  const SplitShared sp = load_split(
      smem64, 0, pl, coef + static_cast<int64_t>(b) * (K << cmax), &rest);
  const SharedStructure st =
      load_structure(rest, coef, shifts, sizes, K, cmax, b);
  const float delta = tol[b];
  const int L = pl.L;
  const int64_t subs = per_block >> L;
  const bool active = static_cast<int>(threadIdx.x) < (1 << L);
  for (int p = blockIdx.x; p < parts; p += gridDim.x) {
    float M = neg_inf();
    float best = neg_inf();
    int64_t best_x = kNoState;
    long long cand = 0;
    const auto decide = [&](int64_t x) {
      const float c = __fmul_rn(
          beta, log_potential(x, st.coef, st.shifts, st.sizes, K, cmax));
      if (map_better(c, x, best, best_x)) {
        best = c;
        best_x = x;
      }
    };
    const unsigned long long h0 =
        static_cast<unsigned long long>(x0_blocks + p) * subs;
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
      for (int k = 0; k < kThreads / 32; ++k) M = fmaxf(M, s_warp_max[k]);
      const float T = __fsub_rd(M, delta);
      uint32_t hits = 0;
      if (active) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          hits |= static_cast<uint32_t>(v[r] >= T) << r;
        }
      }
      cand += __popc(hits);
      while (hits) {
        const int r = __ffs(hits) - 1;
        hits &= hits - 1;
        const int64_t x = static_cast<int64_t>(
            (h << L) | static_cast<unsigned long long>(r * kThreads +
                                                       threadIdx.x));
        const int at = atomicAdd(&s_held, 1);
        if (at < kHeld) {
          s_held_x[at] = x;
        } else {
          decide(x);
        }
      }
    }
    __syncthreads();
    const int held = s_held < kHeld ? s_held : kHeld;
    for (int t = threadIdx.x; t < held; t += kThreads) decide(s_held_x[t]);
    for (int off = 16; off > 0; off >>= 1) {
      cand += __shfl_down_sync(0xffffffffu, cand, off);
    }
    if ((threadIdx.x & 31) == 0) s_warp_cand[threadIdx.x >> 5] = cand;
    sv[threadIdx.x] = best;
    sx[threadIdx.x] = best_x;
    __syncthreads();
    for (int half = kThreads / 2; half > 0; half >>= 1) {
      if (static_cast<int>(threadIdx.x) < half &&
          map_better(sv[threadIdx.x + half], sx[threadIdx.x + half],
                     sv[threadIdx.x], sx[threadIdx.x])) {
        sv[threadIdx.x] = sv[threadIdx.x + half];
        sx[threadIdx.x] = sx[threadIdx.x + half];
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      s_held = 0;
      const int64_t o = static_cast<int64_t>(b) * parts + p;
      v_out[o] = sv[0];
      x_out[o] = sx[0];
      if (cand_out) {
        long long total = 0;
        for (int k = 0; k < kThreads / 32; ++k) total += s_warp_cand[k];
        cand_out[o] = total;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 5. Monomial moments: the fused lnZ + moments sweep, and the sweep for a
//    given lnZ
// ---------------------------------------------------------------------------
// kLnzGiven = false replaces qcmrf_tpu/ops/kernels.py::
// _build_gram_lse_loop_kernel, the forward sweep of the differentiable lnZ
// (qcmrf_tpu/models/moments.py::lnz_and_moments_streaming); kLnzGiven =
// true replaces _build_gram_loop_kernel (and the XLA sweep qcmrf_tpu/
// models/moments.py::_chunk_mono_partials, which covers cliques of more
// than 4 variables there), the moments for a given lnZ.
// Block p of a launch sweeps block x0_blocks + p of lse_geometry
// sub-block by sub-block (split_values). The fused sweep carries a running
// max M of v = beta * lp(x). Per sub-block h: the block takes the
// sub-block's max (warp shuffles, then one exchange of the warp maxima in
// shared memory); if it raises M, each thread rescales the sums of the
// monomials it owns by exp(M_old - M_new) (the raise is strict, so two -inf
// never meet; on the first sub-block the factor is exp(-inf) = 0 on sums
// of 0). With lnZ given, M is lnz[b] throughout: no max, no exchange, no
// rescale. Then w = exp(v - M), and the superset-sum transform W[t] =
// sum_{xl superset of t} w[xl] (registers and lanes, then the warp bits in
// shared memory). Monomial g (the id-bit mask mask_g) holds at every state
// of W[mask_g & (2^L - 1)] iff (h & (mask_g >> L)) == mask_g >> L: one test
// and one add a monomial a sub-block. Out: per block the float32 sums
// S_b[0..m) and, fused, M_b; mask 0, the empty monomial, gives the
// fused block's scaled Z. The masks and sums of a launch live in shared
// memory beside the plan, so the wrappers split a mask list longer than
// what 227 KB holds over several launches.
// Bound on this card: float work, as lse_kernel's with a second transform
// (the superset sums) and the monomials' tests and adds a sub-block (with
// lnZ given, less the max); device memory sees only the partials. Float32
// throughout, no TF32: the JAX package holds its sweeps to a float32
// oracle.
template <int R, bool kLnzGiven>
__global__ void __launch_bounds__(kThreads)
lnz_moments_kernel(SplitPlan pl, const float* __restrict__ coef, int ncoef,
                   int64_t per_block, int64_t x0_blocks, int parts,
                   float beta,
                   const float* __restrict__ lnz,
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
    float M = kLnzGiven ? lnz[b] : neg_inf();
    const unsigned long long h0 =
        static_cast<unsigned long long>(x0_blocks + p) * subs;
    for (int64_t i = 0; i < subs; ++i) {
      const unsigned long long h = h0 + i;
      float v[R];
      split_values<R>(sp, pl, h, beta, v);
      if (!kLnzGiven) {
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
        for (int k = 1; k < kThreads / 32; ++k) {
          top = fmaxf(top, s_warp_max[k]);
        }
        if (top > M) {
          const float scale = expf(M - top);
          for (int g = threadIdx.x; g < m; g += kThreads) s_acc[g] *= scale;
          M = top;
        }
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
    if (!kLnzGiven && threadIdx.x == 0) m_out[o] = M;
    float* row = s_out + o * m;
    for (int g = threadIdx.x; g < m; g += kThreads) row[g] = s_acc[g];
  }
}

size_t structure_smem_bytes(int K, int cmax) {
  return (static_cast<size_t>(K) << cmax) * sizeof(float) +
         static_cast<size_t>(K) * (cmax + 1) * sizeof(int);
}

// Dynamic shared memory of load_split's tables and P: U 64-bit masks and
// U float64 coefficients, the float64 item sums, the item and group tables
// and P.
size_t split_smem_bytes(const SplitPlan& pl) {
  const int part = pl.CI > pl.MI ? pl.CI : pl.MI;
  return static_cast<size_t>(2 * pl.U + part) * sizeof(double) +
         static_cast<size_t>(pl.MI + 2 * pl.G + 2 + (1 << pl.L)) *
             sizeof(int);
}

// lnz_moments_kernel's (both forms): the split's, the masks and sums, and
// W.
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

// The sampler's dynamic shared memory: the padded table's thresholds and
// slot shifts.
size_t sampler_smem_bytes(int K, int cmax) {
  return static_cast<size_t>(sampler_cliques(K)) * ((1 << cmax) + cmax) *
         sizeof(uint32_t);
}

// launch(std::integral_constant<int, CMAX>) for the cliques' largest size:
// 1..15 (a 16-variable clique's table, 256 KB, outgrows shared memory).
template <typename Launch>
int with_clique_size(int cmax, Launch launch) {
  switch (cmax) {
    case 1: return launch(std::integral_constant<int, 1>());
    case 2: return launch(std::integral_constant<int, 2>());
    case 3: return launch(std::integral_constant<int, 3>());
    case 4: return launch(std::integral_constant<int, 4>());
    case 5: return launch(std::integral_constant<int, 5>());
    case 6: return launch(std::integral_constant<int, 6>());
    case 7: return launch(std::integral_constant<int, 7>());
    case 8: return launch(std::integral_constant<int, 8>());
    case 9: return launch(std::integral_constant<int, 9>());
    case 10: return launch(std::integral_constant<int, 10>());
    case 11: return launch(std::integral_constant<int, 11>());
    case 12: return launch(std::integral_constant<int, 12>());
    case 13: return launch(std::integral_constant<int, 13>());
    case 14: return launch(std::integral_constant<int, 14>());
    case 15: return launch(std::integral_constant<int, 15>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

unsigned grid_blocks(int64_t items, int64_t cap) {
  int64_t blocks = (items + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

template <int R>
int launch_lse(const SplitPlan& pl, const float* coef, int B, int ncoef,
               int64_t per_block, int64_t x0_blocks, int parts, float beta,
               float* m_out, float* s_out, void* stream) {
  const size_t smem = split_smem_bytes(pl);
  const cudaError_t err = allow_shared(lse_kernel<R>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lse_kernel<R><<<split_grid(parts, B), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      pl, coef, ncoef, per_block, x0_blocks, parts, beta, m_out, s_out);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch_logpot(const SplitPlan& pl, const float* coef, int B, int ncoef,
                  int64_t per_block, int64_t x0_blocks, int parts,
                  float beta, int fuse_amp, float amp_scale, float* out,
                  void* stream) {
  const size_t smem = split_smem_bytes(pl);
  const cudaError_t err = allow_shared(logpot_kernel<R>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  logpot_kernel<R><<<split_grid(parts, B), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      pl, coef, ncoef, per_block, x0_blocks, parts, beta, fuse_amp,
      amp_scale, out);
  return static_cast<int>(cudaGetLastError());
}

template <int R, bool kLnzGiven>
int launch_lnz_moments(const SplitPlan& pl, const float* coef, int B,
                       int ncoef, int64_t per_block, int64_t x0_blocks,
                       int parts, float beta, const float* lnz,
                       const unsigned long long* masks, int m, float* m_out,
                       float* s_out, void* stream) {
  const size_t smem = lnz_moments_smem_bytes(pl, m);
  const cudaError_t err =
      allow_shared(lnz_moments_kernel<R, kLnzGiven>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lnz_moments_kernel<R, kLnzGiven><<<split_grid(parts, B), kThreads, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      pl, coef, ncoef, per_block, x0_blocks, parts, beta, lnz, masks, m,
      m_out, s_out);
  return static_cast<int>(cudaGetLastError());
}

// The sampler's grid: as many blocks as stay resident on the card (each
// loads its table once and loops over shots), fewer for a small call.
template <int CMAX>
int launch_sampler(const float* keep, const int* shifts, int B, int K, int n,
                   int64_t shots, uint32_t seed, uint32_t stream0, int mode,
                   int32_t* x_out, int32_t* a_out,
                   unsigned long long* count_out, void* stream) {
  const size_t smem = sampler_smem_bytes(K, CMAX);
  cudaError_t err = allow_shared(sampler_kernel<CMAX>, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sampler_kernel<CMAX>, kThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t cap = static_cast<int64_t>(sms) * (per_sm < 1 ? 1 : per_sm) / B;
  const dim3 grid(grid_blocks(shots, cap < 1 ? 1 : cap), B);
  sampler_kernel<CMAX><<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      keep, shifts, K, n, shots, seed, stream0, mode, x_out, a_out,
      count_out);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch_map(const SplitPlan& pl, const float* coef, const int* shifts,
               const int* sizes, int B, int K, int cmax, int64_t per_block,
               int64_t x0_blocks, int parts, float beta, const float* tol,
               float* v_out, int64_t* x_out, long long* cand_out,
               void* stream) {
  const size_t smem = split_smem_bytes(pl) + structure_smem_bytes(K, cmax);
  const cudaError_t err = allow_shared(map_kernel<R>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  map_kernel<R><<<split_grid(parts, B), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      pl, coef, shifts, sizes, K, cmax, per_block, x0_blocks, parts, beta,
      tol, v_out, x_out, cand_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int qcmrf_sample(const float* keep, const int* shifts, int B, int K,
                 int cmax, int n, int64_t shots, uint32_t seed,
                 uint32_t stream0, int mode, int32_t* x_out, int32_t* a_out,
                 unsigned long long* count_out, void* stream) {
  return with_clique_size(cmax, [&](auto c) {
    return launch_sampler<decltype(c)::value>(keep, shifts, B, K, n, shots,
                                              seed, stream0, mode, x_out,
                                              a_out, count_out, stream);
  });
}

int qcmrf_logpot(SplitPlan plan, const float* coef, int B, int ncoef,
                 int64_t per_block, int64_t x0_blocks, int parts, float beta,
                 int fuse_amp, float amp_scale, float* out, void* stream) {
  return with_values_per_thread(plan.L, [&](auto r) {
    return launch_logpot<decltype(r)::value>(plan, coef, B, ncoef, per_block,
                                             x0_blocks, parts, beta,
                                             fuse_amp, amp_scale, out,
                                             stream);
  });
}

int qcmrf_lse(SplitPlan plan, const float* coef, int B, int ncoef,
              int64_t per_block, int64_t x0_blocks, int parts, float beta,
              float* m_out, float* s_out, void* stream) {
  return with_values_per_thread(plan.L, [&](auto r) {
    return launch_lse<decltype(r)::value>(plan, coef, B, ncoef, per_block,
                                          x0_blocks, parts, beta, m_out,
                                          s_out, stream);
  });
}

int qcmrf_map(SplitPlan plan, const float* coef, const int* shifts,
              const int* sizes, int B, int K, int cmax, int64_t per_block,
              int64_t x0_blocks, int parts, float beta, const float* tol,
              float* v_out, int64_t* x_out, long long* cand_out,
              void* stream) {
  return with_values_per_thread(plan.L, [&](auto r) {
    return launch_map<decltype(r)::value>(plan, coef, shifts, sizes, B, K,
                                          cmax, per_block, x0_blocks, parts,
                                          beta, tol, v_out, x_out, cand_out,
                                          stream);
  });
}

int qcmrf_moments(SplitPlan plan, const float* coef, int B, int ncoef,
                  int64_t per_block, int64_t x0_blocks, int parts,
                  float beta, const float* lnz,
                  const unsigned long long* masks, int m, float* s_out,
                  void* stream) {
  return with_values_per_thread(plan.L, [&](auto r) {
    return launch_lnz_moments<decltype(r)::value, true>(
        plan, coef, B, ncoef, per_block, x0_blocks, parts, beta, lnz, masks,
        m, nullptr, s_out, stream);
  });
}

int qcmrf_lnz_moments(SplitPlan plan, const float* coef, int B, int ncoef,
                      int64_t per_block, int64_t x0_blocks, int parts,
                      float beta, const unsigned long long* masks, int m,
                      float* m_out, float* s_out, void* stream) {
  return with_values_per_thread(plan.L, [&](auto r) {
    return launch_lnz_moments<decltype(r)::value, false>(
        plan, coef, B, ncoef, per_block, x0_blocks, parts, beta, nullptr,
        masks, m, m_out, s_out, stream);
  });
}

const char* qcmrf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
