// Hand-written Hopper (sm_90a) kernels of the QCMRF gate-level engine:
// the H·D·H sandwich passes of the plane engine (k <= 7 adjacent ancillas,
// read-write, k = 1 being the single sandwich; k <= 16 ancillas on the
// folded uniform state, write-only; each also in a probability form that
// stores |amplitude|^2 in place of the amplitude) and the
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
// 2. K adjacent sandwiches on the folded uniform state, write-only
// ---------------------------------------------------------------------------
// Replaces the write-only form of _build_hdh_multi_kernel
// (_hdh_multi_uniform_call) at K <= 7. The input is H^{folded}|0>:
// amplitude amp where (x & comp) == 0, else 0, and its K ancilla bits are 0
// (ancillas are never folded), so value j of anchor x0 is
//   e^{i mu} * amp(x0) * (-i)^popcount(j) * prod_t (bit t of j ? sin : cos)
// (column 0 of the Rx tensor power). Nothing is read. K runs to 16: a run
// of sandwich groups whose ancillas are all still |0> when it starts, and
// whose profiles condition on none of them, is one such pass over all
// their ancillas (sim/planes.py::fold_fresh), since each group's input on
// its own ancillas is then (psi, 0, ..., 0).
// Probability form (kProbs): the stream's last pass, run for its outcome
// distribution (sim/planes.py::simulate_probs), writes
//   amp(x0)^2 * prod_t (bit t of j ? sin^2 : cos^2)
// into one float32 buffer of 2^w values (re; im is not touched): mu and
// the phases change no probability. 4 bytes written a value, where the
// amplitude form writes 8.
// Bound on this card: device memory, the bytes written. The product of a
// value's K factors splits into its low KL = min(K, 5) ancilla bits and the
// KH = K - KL high ones. A tile is T anchors (consecutive low index bits),
// and a work item a tile's share of the high patterns (all of them up to
// 64; past 64, items of 64, so that many items keep the last wave short);
// per item the block tabulates each anchor's 2^KL low products in shared
// memory. The block's G groups of threads take the low patterns in turn;
// each thread takes 4 consecutive anchors, so that a warp stores 128
// consecutive values of one pattern (512 bytes, one 16-byte store a thread:
// long runs keep the scattered rows' writes near the rate of a sequential
// fill). For one high pattern at a time a thread forms its anchors' high
// products (KH multiplies each, from shared memory) and stores 2^KL / G
// vectors, each value one multiply (a complex one in the amplitude form)
// from the table. Streaming stores: nothing reads the values back in the
// pass. Where the 4 anchors are not 4 adjacent values (a_lo < 2, or a tile
// runs past the last anchor), the thread stores them one by one.
template <int K, bool kProbs>
struct UniformShape {
  static constexpr int KL = K < 5 ? K : 5;
  static constexpr int KH = K - KL;
  static constexpr int NL = 1 << KL;
  static constexpr int G = NL < 8 ? NL : 8;  // thread groups
  static constexpr int V = 4;                // anchors a thread
  static constexpr int T = V * (kThreads / G);
  static constexpr int NP = K + 1;
  // high patterns a work item: a tile's are split into NC items so that
  // the last wave of blocks is short
  static constexpr int JC = KH > 6 ? 64 : 1 << KH;
  static constexpr int NC = (1 << KH) / JC;
  // floats of shared memory after the profile table: (cos, sin) of every
  // profile, the anchors' amplitudes, the low products' table(s)
  static constexpr int kFloats = 2 * NP * T + T + (kProbs ? 1 : 2) * NL * T;
};

__device__ __forceinline__ int align16(int bytes) {
  return (bytes + 15) & ~15;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}
__device__ __forceinline__ float4 neg4(float4 a) {
  return make_float4(-a.x, -a.y, -a.z, -a.w);
}

template <int K, bool kProbs>
__global__ void __launch_bounds__(kThreads)
hdh_multi_uniform_kernel(const unsigned char* __restrict__ table,
                         int n_terms, float* __restrict__ re,
                         float* __restrict__ im, int64_t num_anchors,
                         int a_lo, unsigned long long comp, float amp) {
  using U = UniformShape<K, kProbs>;
  constexpr int KL = U::KL, KH = U::KH, NL = U::NL, G = U::G, V = U::V;
  constexpr int T = U::T, NP = U::NP, JC = U::JC, NC = U::NC;
  extern __shared__ __align__(16) unsigned char smem[];
  const int table_bytes = NP * sizeof(Profile) + n_terms * sizeof(Term);
  load_words(smem, table, table_bytes);
  const Profile* prof = reinterpret_cast<const Profile*>(smem);
  const Term* terms =
      reinterpret_cast<const Term*>(smem + NP * sizeof(Profile));
  float* cs_c = reinterpret_cast<float*>(smem + align16(table_bytes));
  float* cs_s = cs_c + NP * T;
  float* a_amp = cs_s + NP * T;
  float* lo_r = a_amp + T;      // (NL, T): the low products, or squares
  float* lo_i = lo_r + NL * T;  // amplitude form only
  __syncthreads();

  const uint64_t S = uint64_t(1) << a_lo;
  const int u = V * (threadIdx.x % (kThreads / G));  // first anchor's slot
  const int g = threadIdx.x / (kThreads / G);
  const int64_t num_items = (num_anchors + T - 1) / T * NC;
  for (int64_t item = blockIdx.x; item < num_items; item += gridDim.x) {
    const int64_t tile0 = item / NC * T;
    const int jh0 = item % NC * JC;
    for (int i = threadIdx.x; i < NP * T; i += kThreads) {
      const uint64_t x = anchor_base(tile0 + i % T, a_lo, K);
      profile_cs(prof, terms, i / T, x, cs_c[i], cs_s[i]);
      if (i < T) a_amp[i] = (x & comp) == 0 ? amp : 0.0f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < NL * T; i += kThreads) {
      const int jl = i / T, t = i % T;
      float m = 1.0f;
#pragma unroll
      for (int b = 0; b < KL; ++b) {
        m *= ((jl >> b) & 1) ? cs_s[(1 + b) * T + t] : cs_c[(1 + b) * T + t];
      }
      if constexpr (kProbs) {
        lo_r[i] = m * m;
      } else {  // (-i)^popcount(jl) m
        const int ph = __popc(jl) & 3;
        lo_r[i] = ph == 0 ? m : (ph == 2 ? -m : 0.0f);
        lo_i[i] = ph == 1 ? -m : (ph == 3 ? m : 0.0f);
      }
    }
    __syncthreads();
    const int64_t A0 = tile0 + u;
    if (A0 < num_anchors) {
      // 4 consecutive anchors are 4 consecutive floats where a_lo >= 2;
      // the wrapper holds every output to a 16-byte boundary
      const bool vec = a_lo >= 2 && A0 + V <= num_anchors;
      const uint64_t x0 = anchor_base(A0, a_lo, K);
      const float4 am = load4(a_amp + u);
      const float4 cm = load4(cs_c + u), sm = load4(cs_s + u);  // mu
#pragma unroll 1
      for (int jh = jh0; jh < jh0 + JC; ++jh) {
        float4 m = am;  // amp * the high product, each anchor
#pragma unroll
        for (int b = 0; b < KH; ++b) {
          m = mul4(m, load4((((jh >> b) & 1) ? cs_s : cs_c) +
                            (1 + KL + b) * T + u));
        }
        const uint64_t row = x0 + static_cast<uint64_t>(jh << KL) * S;
        float4 wr, wi;  // the high part of each value (probs: wr alone)
        if constexpr (kProbs) {
          wr = wi = mul4(m, m);
        } else {  // e^{i mu} amp (-i)^popcount(jh) high product
          const float4 hr = mul4(m, cm), hi = mul4(m, sm);
          switch (__popc(jh) & 3) {
            case 0: wr = hr; wi = hi; break;
            case 1: wr = hi; wi = neg4(hr); break;
            case 2: wr = neg4(hr); wi = neg4(hi); break;
            default: wr = neg4(hi); wi = hr; break;
          }
        }
#pragma unroll
        for (int q = 0; q < NL / G; ++q) {
          const int jl = g + q * G;
          const uint64_t off = row + static_cast<uint64_t>(jl) * S;
          const float4 lr = load4(lo_r + jl * T + u);
          float4 vr, vi;
          if constexpr (kProbs) {
            vr = vi = mul4(wr, lr);
          } else {
            const float4 li = load4(lo_i + jl * T + u);
            vr = sub4(mul4(wr, lr), mul4(wi, li));
            vi = add4(mul4(wr, li), mul4(wi, lr));
          }
          if (vec) {
            __stcs(reinterpret_cast<float4*>(re + off), vr);
            if constexpr (!kProbs) {
              __stcs(reinterpret_cast<float4*>(im + off), vi);
            }
          } else {
            const float r4[4] = {vr.x, vr.y, vr.z, vr.w};
            const float i4[4] = {vi.x, vi.y, vi.z, vi.w};
            const uint64_t jS = static_cast<uint64_t>((jh << KL) | jl) * S;
            for (int v = 0; v < V && A0 + v < num_anchors; ++v) {
              const uint64_t idx = anchor_base(A0 + v, a_lo, K) + jS;
              __stcs(re + idx, r4[v]);
              if constexpr (!kProbs) __stcs(im + idx, i4[v]);
            }
          }
        }
      }
    }
    __syncthreads();  // the next item reuses cs_*, a_amp and lo_*
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

template <int K, bool kProbs>
cudaError_t launch_uniform(const unsigned char* table, int n_terms,
                           float* re, float* im, int64_t num_anchors,
                           int a_lo, unsigned long long comp, float amp,
                           cudaStream_t stream) {
  using U = UniformShape<K, kProbs>;
  const size_t bytes = ((table_bytes(K + 1, n_terms) + 15) & ~size_t(15)) +
                       sizeof(float) * U::kFloats;
  cudaError_t err = allow_shared(hdh_multi_uniform_kernel<K, kProbs>, bytes);
  if (err != cudaSuccess) return err;
  hdh_multi_uniform_kernel<K, kProbs><<<capped_blocks(
                                            num_anchors * U::NC, U::T),
                                        kThreads, bytes, stream>>>(
      table, n_terms, re, im, num_anchors, a_lo, comp, amp);
  return cudaGetLastError();
}

// The write-only pass at k = 1..kMaxUniformK ancillas, in either form.
constexpr int kMaxUniformK = 16;

template <bool kProbs, int K = 1>
cudaError_t uniform_pass(const unsigned char* table, int n_terms, int k,
                         float* re, float* im, int64_t num_anchors, int a_lo,
                         unsigned long long comp, float amp,
                         cudaStream_t s) {
  if constexpr (K > kMaxUniformK) {
    return cudaErrorInvalidValue;
  } else {
    if (k == K) {
      return launch_uniform<K, kProbs>(table, n_terms, re, im, num_anchors,
                                       a_lo, comp, amp, s);
    }
    return uniform_pass<kProbs, K + 1>(table, n_terms, k, re, im,
                                       num_anchors, a_lo, comp, amp, s);
  }
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
  return static_cast<int>(uniform_pass<false>(
      table, n_terms, k, re, im, num_anchors, a_lo, comp, amp,
      static_cast<cudaStream_t>(stream)));
}

// The write-only pass's probability form: probabilities into out.
int qcmrf_hdh_multi_uniform_probs(const unsigned char* table, int n_terms,
                                  int k, float* out, int64_t num_anchors,
                                  int a_lo, unsigned long long comp,
                                  float amp, void* stream) {
  return static_cast<int>(uniform_pass<true>(
      table, n_terms, k, out, nullptr, num_anchors, a_lo, comp, amp,
      static_cast<cudaStream_t>(stream)));
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
