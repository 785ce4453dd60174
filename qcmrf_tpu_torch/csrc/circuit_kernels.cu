// Hand-written Hopper (sm_90a) kernels of the QCMRF gate-level engine:
// the H·D·H sandwich passes of the plane engine (k <= 7 adjacent ancillas,
// read-write, k = 1 being the single sandwich; k ancillas on the folded
// uniform state, write-only; the read-write one also in a probability form
// that stores |amplitude|^2 in place of the amplitude) and the
// whole-circuit kernel of `run --engine statevector`.
//
// Built with qcmrf_kernels.cu into one library by
// qcmrf_tpu_torch/ops/_build.py (nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3) and bound with ctypes. Each extern "C" entry point
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().
//
// State layout: two float32 planes (real, imaginary) of 2^w values, qubit 0
// the least significant bit of the index. All index arithmetic is 64-bit:
// at w = 32 the planes hold 2^32 values and an ancilla at 31 has a stride
// of 2^31.
//
// Phase profiles. A sandwich pass reads its profiles from a table the
// wrapper builds on the host (ops/kernels.py::_profile_table):
//   Profile[n_prof]  {cos base, sin base, first term, end term}
//   Term[n_terms]    {care, want, cos a, sin a}
// Profile 0 is mu (the common phase), profile 1 + t is nu_t (ancilla
// a_lo + t). A term holds at index x iff (x & care) == want; its angle a
// is composed into (cos, sin) by one rotation (the host computes cos a and
// sin a in float64). One compiled kernel serves every term structure: the
// block copies the table into shared memory once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCircuitThreads = 512;
// grid-stride passes keep this many blocks per SM in flight at most
constexpr int kBlocksCap = 132 * 16;

struct Profile {
  float c, s;
  int begin, end;
};
struct Term {
  unsigned long long care, want;
  float c, s;
};
static_assert(sizeof(Profile) == 16, "profile record is 16 bytes");
static_assert(sizeof(Term) == 24, "term record is 24 bytes");

__device__ __forceinline__ void load_words(unsigned char* dst,
                                           const unsigned char* src,
                                           int bytes) {
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  for (int i = threadIdx.x; i < bytes / 4; i += blockDim.x) d[i] = s[i];
}

// (cos, sin) of profile p at index x: its base rotated by every term that
// holds at x.
__device__ __forceinline__ void profile_cs(const Profile* prof,
                                           const Term* terms, int p,
                                           uint64_t x, float& c, float& s) {
  const Profile P = prof[p];
  float cc = P.c;
  float ss = P.s;
  for (int t = P.begin; t < P.end; ++t) {
    const Term T = terms[t];
    if ((x & T.care) == T.want) {
      const float nc = cc * T.c - ss * T.s;
      ss = ss * T.c + cc * T.s;
      cc = nc;
    }
  }
  c = cc;
  s = ss;
}

// e^{-i nu X} on the pair (v0, v1) = H · diag(e^{-i nu}, e^{i nu}) · H:
// v0' = cos nu v0 - i sin nu v1, v1' = -i sin nu v0 + cos nu v1.
__device__ __forceinline__ void rx_pair(float c, float s, float& r0,
                                        float& i0, float& r1, float& i1) {
  const float a = c * r0 + s * i1;
  const float b = c * i0 - s * r1;
  const float d = s * i0 + c * r1;
  const float e = c * i1 - s * r0;
  r0 = a;
  i0 = b;
  r1 = d;
  i1 = e;
}

__device__ __forceinline__ void store_phased(float* re, float* im,
                                             uint64_t idx, float cm,
                                             float sm, float r, float i) {
  re[idx] = cm * r - sm * i;
  im[idx] = cm * i + sm * r;
}

// A pass's store of value (r, i) at idx. The amplitude form writes
// e^{i mu} (r + i i) into both planes. The probability form (kProbs)
// writes |r + i i|^2 into the real plane alone: |e^{i mu} u|^2 = |u|^2, so
// mu is not applied, and the imaginary plane is not written.
template <bool kProbs>
__device__ __forceinline__ void store_value(float* re, float* im,
                                            uint64_t idx, float cm, float sm,
                                            float r, float i) {
  if constexpr (kProbs) {
    re[idx] = r * r + i * i;
  } else {
    store_phased(re, im, idx, cm, sm, r, i);
  }
}

// Index of anchor A with the k ancilla bits a_lo .. a_lo+k-1 zero: the low
// a_lo bits of A stay, the rest move up by k.
__device__ __forceinline__ uint64_t anchor_base(uint64_t A, int a_lo,
                                                int k) {
  const uint64_t lo = A & ((uint64_t(1) << a_lo) - 1);
  return ((A >> a_lo) << (a_lo + k)) | lo;
}

unsigned capped_blocks(int64_t items, int per_block) {
  int64_t blocks = (items + per_block - 1) / per_block;
  if (blocks > kBlocksCap) blocks = kBlocksCap;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

// ---------------------------------------------------------------------------
// 1. k adjacent sandwiches, read-write
// ---------------------------------------------------------------------------
// Replaces qcmrf_tpu/ops/kernels.py::_build_hdh_multi_kernel in its
// read-write form (_hdh_multi_call); at K = 1 it replaces _build_hdh_kernel
// (_hdh_call) and at K = 2 _build_hdh_pair_kernel (_hdh_pair_call). The K
// sandwiches on ancillas a_lo .. a_lo+K-1 commute and compose as the tensor
// product of K position-dependent Rx rotations over the 2^K values of each
// anchor.
// Bound on this card: device memory, 16 bytes read and 16 written per
// value against 6 float operations per value and level. One anchor's 2^7
// complex values are 256 floats, more than a thread's registers, so the
// block works on a tile of T anchors (consecutive low index bits, so each
// warp's accesses coalesce into 128-byte lines) in two phases:
//   phase 0  (cos, sin) of mu and every nu_t per anchor, once, into shared
//            memory;
//   phase A  G = 2^(K-4) threads per anchor each load 16 values (ancilla
//            bits 0-3) into registers and apply levels 0-3 there;
//   phase B  (K > 4) through a shared-memory tile of 2^K x T values, each
//            thread takes columns of 2^(K-4) values (ancilla bits 4..K-1),
//            applies the remaining levels and mu, and stores.
// Every value is read once and written once; the block writes only what it
// has read, so the update is in place.
// Probability form (kProbs): the last pass of a stream run for its outcome
// distribution (sim/planes.py::simulate_probs) stores r*r + i*i of each
// value into the real plane instead of the phased amplitude, from the
// registers that hold it: 8 bytes read and 4 written a value, where the
// amplitude form and the three elementwise PyTorch passes of re * re +
// im * im after it moved 16 + 28. Bound on this card: device memory, as
// the amplitude form. The imaginary plane is read and left as it was.
template <int K, bool kProbs>
__global__ void __launch_bounds__(kThreads)
hdh_multi_kernel(const unsigned char* __restrict__ table, int n_terms,
                 float* __restrict__ re, float* __restrict__ im,
                 int64_t num_anchors, int a_lo) {
  constexpr int KA = K < 4 ? K : 4;
  constexpr int KB = K - KA;
  constexpr int NA = 1 << KA;
  constexpr int G = 1 << KB;
  constexpr int T = kThreads / G;
  constexpr int NP = K + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int table_bytes = NP * sizeof(Profile) + n_terms * sizeof(Term);
  load_words(smem, table, table_bytes);
  const Profile* prof = reinterpret_cast<const Profile*>(smem);
  const Term* terms =
      reinterpret_cast<const Term*>(smem + NP * sizeof(Profile));
  float* cs_c = reinterpret_cast<float*>(smem + table_bytes);
  float* cs_s = cs_c + NP * T;
  float* v_re = cs_s + NP * T;  // (2^K, T), phase B only
  float* v_im = v_re + (1 << K) * T;
  __syncthreads();

  const uint64_t S = uint64_t(1) << a_lo;
  const int a = threadIdx.x % T;
  const int g = threadIdx.x / T;
  const int64_t num_tiles = (num_anchors + T - 1) / T;
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t tile0 = tile * T;
    for (int i = threadIdx.x; i < NP * T; i += kThreads) {
      const uint64_t x = anchor_base(tile0 + i % T, a_lo, K);
      profile_cs(prof, terms, i / T, x, cs_c[i], cs_s[i]);
    }
    __syncthreads();

    const int64_t A = tile0 + a;
    const bool valid = A < num_anchors;
    const uint64_t x0 = anchor_base(A, a_lo, K);
    float vr[NA], vi[NA];
    if (valid) {
#pragma unroll
      for (int jl = 0; jl < NA; ++jl) {
        const uint64_t idx = x0 + static_cast<uint64_t>((g << KA) | jl) * S;
        vr[jl] = re[idx];
        vi[jl] = im[idx];
      }
#pragma unroll
      for (int b = 0; b < KA; ++b) {
        const float c = cs_c[(1 + b) * T + a];
        const float s = cs_s[(1 + b) * T + a];
#pragma unroll
        for (int jl = 0; jl < NA; ++jl) {
          if (jl & (1 << b)) continue;
          rx_pair(c, s, vr[jl], vi[jl], vr[jl | (1 << b)],
                  vi[jl | (1 << b)]);
        }
      }
    }
    if constexpr (KB == 0) {
      if (valid) {
        const float cm = cs_c[a], sm = cs_s[a];
#pragma unroll
        for (int jl = 0; jl < NA; ++jl) {
          store_value<kProbs>(re, im, x0 + static_cast<uint64_t>(jl) * S,
                              cm, sm, vr[jl], vi[jl]);
        }
      }
    } else {
      if (valid) {
#pragma unroll
        for (int jl = 0; jl < NA; ++jl) {
          v_re[((g << KA) | jl) * T + a] = vr[jl];
          v_im[((g << KA) | jl) * T + a] = vi[jl];
        }
      }
      __syncthreads();
      if (valid) {
        const float cm = cs_c[a], sm = cs_s[a];
#pragma unroll
        for (int q = 0; q < NA / G; ++q) {
          const int jl = g + q * G;
          float ur[G], ui[G];
#pragma unroll
          for (int jh = 0; jh < G; ++jh) {
            ur[jh] = v_re[((jh << KA) | jl) * T + a];
            ui[jh] = v_im[((jh << KA) | jl) * T + a];
          }
#pragma unroll
          for (int b = 0; b < KB; ++b) {
            const float c = cs_c[(1 + KA + b) * T + a];
            const float s = cs_s[(1 + KA + b) * T + a];
#pragma unroll
            for (int jh = 0; jh < G; ++jh) {
              if (jh & (1 << b)) continue;
              rx_pair(c, s, ur[jh], ui[jh], ur[jh | (1 << b)],
                      ui[jh | (1 << b)]);
            }
          }
#pragma unroll
          for (int jh = 0; jh < G; ++jh) {
            store_value<kProbs>(
                re, im, x0 + static_cast<uint64_t>((jh << KA) | jl) * S, cm,
                sm, ur[jh], ui[jh]);
          }
        }
      }
    }
    __syncthreads();  // the next tile reuses cs_* and v_*
  }
}

// ---------------------------------------------------------------------------
// 2. k adjacent sandwiches on the folded uniform state, write-only
// ---------------------------------------------------------------------------
// Replaces the write-only form of _build_hdh_multi_kernel
// (_hdh_multi_uniform_call). The input is H^{folded}|0>: amplitude amp
// where (x & comp) == 0, else 0, and its K ancilla bits are 0 (ancillas
// are never folded), so value j of anchor x0 is
//   e^{i mu} * amp(x0) * (-i)^popcount(j) * prod_t (bit t of j ? sin : cos)
// (column 0 of the Rx tensor power). Nothing is read.
// Bound on this card: device memory, 8 bytes written per value against
// K + 6 float operations. T anchors per block (consecutive low bits, so a
// warp's stores coalesce), G = min(2^K, 8) values of an anchor in flight
// per pass; (cos, sin) of every profile is computed once per anchor.
template <int K>
__global__ void __launch_bounds__(kThreads)
hdh_multi_uniform_kernel(const unsigned char* __restrict__ table,
                         int n_terms, float* __restrict__ re,
                         float* __restrict__ im, int64_t num_anchors,
                         int a_lo, unsigned long long comp, float amp) {
  constexpr int NJ = 1 << K;
  constexpr int G = NJ < 8 ? NJ : 8;
  constexpr int T = kThreads / G;
  constexpr int NP = K + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int table_bytes = NP * sizeof(Profile) + n_terms * sizeof(Term);
  load_words(smem, table, table_bytes);
  const Profile* prof = reinterpret_cast<const Profile*>(smem);
  const Term* terms =
      reinterpret_cast<const Term*>(smem + NP * sizeof(Profile));
  float* cs_c = reinterpret_cast<float*>(smem + table_bytes);
  float* cs_s = cs_c + NP * T;
  float* a_amp = cs_s + NP * T;
  __syncthreads();

  const uint64_t S = uint64_t(1) << a_lo;
  const int a = threadIdx.x % T;
  const int r = threadIdx.x / T;
  const int64_t num_tiles = (num_anchors + T - 1) / T;
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t tile0 = tile * T;
    for (int i = threadIdx.x; i < NP * T; i += kThreads) {
      const uint64_t x = anchor_base(tile0 + i % T, a_lo, K);
      profile_cs(prof, terms, i / T, x, cs_c[i], cs_s[i]);
      if (i < T) a_amp[i] = (x & comp) == 0 ? amp : 0.0f;
    }
    __syncthreads();
    const int64_t A = tile0 + a;
    if (A < num_anchors) {
      const uint64_t x0 = anchor_base(A, a_lo, K);
      const float cm = cs_c[a], sm = cs_s[a];
      float c[K], s[K];
#pragma unroll
      for (int b = 0; b < K; ++b) {
        c[b] = cs_c[(1 + b) * T + a];
        s[b] = cs_s[(1 + b) * T + a];
      }
#pragma unroll
      for (int q = 0; q < NJ / G; ++q) {
        const int j = r + q * G;
        float p = a_amp[a];
#pragma unroll
        for (int b = 0; b < K; ++b) p *= ((j >> b) & 1) ? s[b] : c[b];
        float rv, iv;
        switch (__popc(j) & 3) {
          case 0: rv = p; iv = 0.0f; break;
          case 1: rv = 0.0f; iv = -p; break;
          case 2: rv = -p; iv = 0.0f; break;
          default: rv = 0.0f; iv = p; break;
        }
        store_phased(re, im, x0 + static_cast<uint64_t>(j) * S, cm, sm, rv,
                     iv);
      }
    }
    __syncthreads();  // the next tile reuses cs_* and a_amp
  }
}

// ---------------------------------------------------------------------------
// 3. The whole QCMRF circuit, one block per circuit, any mix of structures
// ---------------------------------------------------------------------------
// Replaces qcmrf_tpu/ops/circuit_kernel.py::_build_circuit_kernel
// (_circuit_call). Block b runs circuit b of the call: its descriptor
// names its structure's table, its theta row, its output and, at widths 15
// and 16, its state in a global scratch of the wrapper's (else the state
// lives in dynamic shared memory: 2^14 x 8 bytes = 128 KB at width 14).
// The block first turns its theta row into rotation pairs in shared
// memory: gamma = arccos(exp(beta theta / 2)) / 2 puts 2 gamma in
// [0, pi/2], so (cos 2 gamma, sin 2 gamma) = (exp(beta theta / 2),
// sqrt(-expm1(beta theta))), taken in float64 and rounded to float32 once
// (no arccos, cos or sin, and no trig table from the host). Then the
// closed-form H-wall state, per clique k the fused H.D.H on its ancilla
// n+1+k as e^{-i nu X} with nu(x) = 2 gamma of x's clique state (one
// butterfly pass), then |psi|^2. One launch serves every circuit of a
// call, so the 70-circuit suite (7 structures) is one launch: the host
// packs one buffer (descriptors, tables, thetas) for one copy.
// Bound on this card: at the suite's widths (<= 10) the launch itself; the
// work is K passes over 2^w values per block, ~6 float operations per
// value and pass, and device memory sees only the 4-byte outputs.
struct CircuitDesc {
  int64_t theta;      // its first theta (float64 element)
  int64_t out;        // its first output float
  int64_t scratch;    // its state's first scratch float; -1: shared memory
  int32_t structure;  // first word of its structure's table
  int32_t pad;
};
static_assert(sizeof(CircuitDesc) == 32, "circuit descriptor is 32 bytes");

// A structure's table (int32 words): n, K, cmax, width, d (thetas a
// row), the float32 bits of 2^(-n/2), the K clique sizes, then (K, cmax)
// qubits, qubit (n - 1) - v of clique slot v.
constexpr int kStructureHeader = 6;

__global__ void __launch_bounds__(kCircuitThreads)
circuit_kernel(const CircuitDesc* __restrict__ circuits,
               const int* __restrict__ structures,
               const double* __restrict__ thetas, double beta,
               float* __restrict__ scratch, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const CircuitDesc cd = circuits[blockIdx.x];
  const int* tab = structures + cd.structure;
  const int n = tab[0], K = tab[1], cmax = tab[2], width = tab[3];
  const int d = tab[4];
  const float amp = __int_as_float(tab[5]);
  const int* sizes = tab + kStructureHeader;
  const int* qubits = sizes + K;
  const int64_t N = int64_t(1) << width;
  const bool in_shared = cd.scratch < 0;
  float* st_re = in_shared ? reinterpret_cast<float*>(smem)
                           : scratch + cd.scratch;
  float* st_im = st_re + N;
  float2* pairs = reinterpret_cast<float2*>(smem + (in_shared ? 8 * N : 0));
  const double* th = thetas + cd.theta;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const double bt = beta * th[i];
    pairs[i] = make_float2(__double2float_rn(exp(0.5 * bt)),
                           __double2float_rn(sqrt(-expm1(bt))));
  }
  const int64_t nonvar = (N - 1) ^ ((int64_t(1) << n) - 1);
  for (int64_t x = threadIdx.x; x < N; x += blockDim.x) {
    st_re[x] = (x & nonvar) == 0 ? amp : 0.0f;
    st_im[x] = 0.0f;
  }
  __syncthreads();
  int goff = 0;
  for (int k = 0; k < K; ++k) {
    const int anc = n + 1 + k;
    const int m = sizes[k];
    const int* q = qubits + k * cmax;
    const int64_t lo_mask = (int64_t(1) << anc) - 1;
    for (int64_t p = threadIdx.x; p < N / 2; p += blockDim.x) {
      const int64_t x0 = ((p >> anc) << (anc + 1)) | (p & lo_mask);
      const int64_t x1 = x0 | (int64_t(1) << anc);
      int y = 0;
      for (int i = 0; i < m; ++i) {
        y |= static_cast<int>((x0 >> q[i]) & 1) << (m - 1 - i);
      }
      const float2 cs = pairs[goff + y];
      float r0 = st_re[x0], i0 = st_im[x0], r1 = st_re[x1], i1 = st_im[x1];
      rx_pair(cs.x, cs.y, r0, i0, r1, i1);
      st_re[x0] = r0;
      st_im[x0] = i0;
      st_re[x1] = r1;
      st_im[x1] = i1;
    }
    __syncthreads();
    goff += 1 << m;
  }
  float* o = out + cd.out;
  for (int64_t x = threadIdx.x; x < N; x += blockDim.x) {
    o[x] = st_re[x] * st_re[x] + st_im[x] * st_im[x];
  }
}

size_t table_bytes(int n_prof, int n_terms) {
  return n_prof * sizeof(Profile) + static_cast<size_t>(n_terms) * sizeof(Term);
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int K, bool kProbs>
cudaError_t launch_multi(const unsigned char* table, int n_terms, float* re,
                         float* im, int64_t num_anchors, int a_lo,
                         cudaStream_t stream) {
  constexpr int KA = K < 4 ? K : 4;
  constexpr int T = kThreads >> (K - KA);
  const size_t bytes = table_bytes(K + 1, n_terms) +
                       2 * sizeof(float) * (K + 1) * T +
                       (K > 4 ? 2 * sizeof(float) * (1 << K) * T : 0);
  cudaError_t err = allow_shared(hdh_multi_kernel<K, kProbs>, bytes);
  if (err != cudaSuccess) return err;
  hdh_multi_kernel<K, kProbs><<<capped_blocks(num_anchors, T), kThreads,
                                bytes, stream>>>(table, n_terms, re, im,
                                                 num_anchors, a_lo);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_uniform(const unsigned char* table, int n_terms,
                           float* re, float* im, int64_t num_anchors,
                           int a_lo, unsigned long long comp, float amp,
                           cudaStream_t stream) {
  constexpr int G = (1 << K) < 8 ? (1 << K) : 8;
  constexpr int T = kThreads / G;
  const size_t bytes = table_bytes(K + 1, n_terms) +
                       sizeof(float) * (2 * (K + 1) + 1) * T;
  cudaError_t err = allow_shared(hdh_multi_uniform_kernel<K>, bytes);
  if (err != cudaSuccess) return err;
  hdh_multi_uniform_kernel<K><<<capped_blocks(num_anchors, T), kThreads,
                                bytes, stream>>>(
      table, n_terms, re, im, num_anchors, a_lo, comp, amp);
  return cudaGetLastError();
}

// The read-write pass at k = 1..7 ancillas, in either form.
template <bool kProbs>
cudaError_t multi_pass(const unsigned char* table, int n_terms, int k,
                       float* re, float* im, int64_t num_anchors, int a_lo,
                       cudaStream_t s) {
  switch (k) {
    case 1: return launch_multi<1, kProbs>(table, n_terms, re, im, num_anchors, a_lo, s);
    case 2: return launch_multi<2, kProbs>(table, n_terms, re, im, num_anchors, a_lo, s);
    case 3: return launch_multi<3, kProbs>(table, n_terms, re, im, num_anchors, a_lo, s);
    case 4: return launch_multi<4, kProbs>(table, n_terms, re, im, num_anchors, a_lo, s);
    case 5: return launch_multi<5, kProbs>(table, n_terms, re, im, num_anchors, a_lo, s);
    case 6: return launch_multi<6, kProbs>(table, n_terms, re, im, num_anchors, a_lo, s);
    case 7: return launch_multi<7, kProbs>(table, n_terms, re, im, num_anchors, a_lo, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int qcmrf_hdh_multi(const unsigned char* table, int n_terms, int k,
                    float* re, float* im, int64_t num_anchors, int a_lo,
                    void* stream) {
  return static_cast<int>(multi_pass<false>(
      table, n_terms, k, re, im, num_anchors, a_lo,
      static_cast<cudaStream_t>(stream)));
}

// The read-write pass's probability form: probabilities into re.
int qcmrf_hdh_multi_probs(const unsigned char* table, int n_terms, int k,
                          float* re, const float* im, int64_t num_anchors,
                          int a_lo, void* stream) {
  return static_cast<int>(multi_pass<true>(
      table, n_terms, k, re, const_cast<float*>(im), num_anchors, a_lo,
      static_cast<cudaStream_t>(stream)));
}

int qcmrf_hdh_multi_uniform(const unsigned char* table, int n_terms, int k,
                            float* re, float* im, int64_t num_anchors,
                            int a_lo, unsigned long long comp, float amp,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (k) {
    case 1: err = launch_uniform<1>(table, n_terms, re, im, num_anchors, a_lo, comp, amp, s); break;
    case 2: err = launch_uniform<2>(table, n_terms, re, im, num_anchors, a_lo, comp, amp, s); break;
    case 3: err = launch_uniform<3>(table, n_terms, re, im, num_anchors, a_lo, comp, amp, s); break;
    case 4: err = launch_uniform<4>(table, n_terms, re, im, num_anchors, a_lo, comp, amp, s); break;
    case 5: err = launch_uniform<5>(table, n_terms, re, im, num_anchors, a_lo, comp, amp, s); break;
    case 6: err = launch_uniform<6>(table, n_terms, re, im, num_anchors, a_lo, comp, amp, s); break;
    case 7: err = launch_uniform<7>(table, n_terms, re, im, num_anchors, a_lo, comp, amp, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

int qcmrf_circuit(const void* circuits, const int* structures,
                  const double* thetas, int num_circuits, double beta,
                  int shared_bytes, float* scratch, float* out,
                  void* stream) {
  cudaError_t err = allow_shared(circuit_kernel, shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  circuit_kernel<<<num_circuits, kCircuitThreads, shared_bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const CircuitDesc*>(circuits), structures, thetas, beta,
      scratch, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
