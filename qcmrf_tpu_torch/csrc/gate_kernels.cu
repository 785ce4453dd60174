// Hand-written Hopper (sm_90a) kernels of the plane engine's generic gate
// passes: the diagonal profile (also the masked rotation), the 2x2 / 4x4
// row-qubit gates, the lane-qubit pass (factored: one butterfly a factor,
// for the planner's lane ops; dense: the 128x128 product, for an M given
// without factors), the plane copy that normalises the gate passes' rates,
// and the float32 FMA chain that normalises the float kernels' rates.
//
// Built with the other sources of csrc/ into one library by
// qcmrf_tpu_torch/ops/_build.py (nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3) and bound with ctypes. Each extern "C" entry point
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().
//
// State layout: two float32 planes (real, imaginary) of 2^w values, qubit 0
// the least significant bit of the index, updated in place. All index
// arithmetic is 64-bit (a condition or a partner qubit may sit at bit 31 or
// above). Every pass moves 4-value groups as float4: the planes hold 2^w
// values with w >= 7, and the row passes' qubits are >= 7, so the four
// values of a group are consecutive in every plane the pass touches.

#include <cstdint>
#include <cuda_runtime.h>

// A gate's matrix, row-major (out, in): 2x2 in the first 4 entries, or 4x4
// with index bit(q_lo + 1) * 2 + bit(q_lo). Passed by value; at namespace
// scope, since the exported qcmrf_row_gate takes it.
struct GateMatrix {
  float re[16];
  float im[16];
};

// The seven 2x2 factors of a lane op, factor q's entry (o, i) at 4 q + 2 o
// + i; passed by value to qcmrf_lane_factored.
struct LaneFactors {
  float re[28];
  float im[28];
};

namespace {

constexpr int kThreads = 256;
// grid-stride passes keep at most this many blocks per SM in flight
constexpr int kBlocksPerSm = 16;

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

unsigned grid_blocks(int64_t items, int per_block) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int64_t blocks = (items + per_block - 1) / per_block;
  const int64_t cap = int64_t(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

__device__ __forceinline__ float4 load4(const float* p, uint64_t i) {
  return *reinterpret_cast<const float4*>(p + i);
}

__device__ __forceinline__ void store4(float* p, uint64_t i, float4 v) {
  *reinterpret_cast<float4*>(p + i) = v;
}

__device__ __forceinline__ float& lane4(float4& v, int i) {
  return (&v.x)[i];
}

// ---------------------------------------------------------------------------
// 1. Diagonal profile: e^{i (base + sum_t a_t [term t holds])}
// ---------------------------------------------------------------------------
// Replaces qcmrf_tpu/ops/kernels.py::_build_diag_profile_kernel
// (_diag_profile_call) and, at one term, _build_masked_rotation_kernel
// (_masked_rotation_call). The profile is the host-made table of the
// sandwich kernels (circuit_kernels.cu): one Profile record, then its
// terms; a term holds at x iff (x & care) == want, with 64-bit masks. The
// phase is composed as rotors in float32 from (cos a_t, sin a_t) taken in
// float64 on the host: no transcendental on the card and no angle summed in
// float32 (a 64-term run can reach ~200 rad), so the error stays at a few
// float32 ulps per holding term. One compiled kernel serves every term
// structure: the block copies the table into shared memory once.
// Bound on this card: device memory, 16 bytes read and written per value
// against 6 float operations per value and 8 per holding term. Each thread
// takes groups of 4 consecutive values (float4 loads); the term table is
// read by all threads of a warp at one address (a broadcast).
__global__ void __launch_bounds__(kThreads)
diag_kernel(const unsigned char* __restrict__ table, int n_terms,
            float* __restrict__ re, float* __restrict__ im,
            int64_t num_groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bytes = sizeof(Profile) + n_terms * sizeof(Term);
  {
    uint32_t* d = reinterpret_cast<uint32_t*>(smem);
    const uint32_t* s = reinterpret_cast<const uint32_t*>(table);
    for (int i = threadIdx.x; i < bytes / 4; i += blockDim.x) d[i] = s[i];
  }
  __syncthreads();
  const Profile P = *reinterpret_cast<const Profile*>(smem);
  const Term* terms = reinterpret_cast<const Term*>(smem + sizeof(Profile));
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t g = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       g < num_groups; g += stride) {
    const uint64_t x0 = uint64_t(g) << 2;
    float c[4], s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c[i] = P.c;
      s[i] = P.s;
    }
    for (int t = P.begin; t < P.end; ++t) {
      const Term T = terms[t];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (((x0 + i) & T.care) == T.want) {
          const float nc = c[i] * T.c - s[i] * T.s;
          s[i] = s[i] * T.c + c[i] * T.s;
          c[i] = nc;
        }
      }
    }
    float4 r = load4(re, x0);
    float4 m = load4(im, x0);
    float4 orr, om;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lane4(orr, i) = lane4(r, i) * c[i] - lane4(m, i) * s[i];
      lane4(om, i) = lane4(r, i) * s[i] + lane4(m, i) * c[i];
    }
    store4(re, x0, orr);
    store4(im, x0, om);
  }
}

// ---------------------------------------------------------------------------
// 2. A gate on K adjacent row qubits q_lo .. q_lo + K - 1 (K = 1, 2)
// ---------------------------------------------------------------------------
// Replaces qcmrf_tpu/ops/kernels.py::_row_gate_kernel (_row_gate_call) at
// K = 1 and _row_pair_kernel (_row_pair_call) at K = 2. The TPU's (groups,
// 2^K, stride, 128) block tiling is not carried over: one kernel serves
// every stride. A thread owns 4 consecutive anchors (indices with the K
// target bits zero); with q_lo >= 7 their values are 4 consecutive floats
// in each of the 2^K partner rows, so consecutive threads read and write
// consecutive 16-byte words in every partner row, at any stride up to
// 2^(w-1).
// Bound on this card: device memory, 16 bytes read and written per value
// against 8 * 2^K float operations per value.
template <int K>
__global__ void __launch_bounds__(kThreads)
row_gate_kernel(GateMatrix u, float* __restrict__ re, float* __restrict__ im,
                int64_t num_quads, int q_lo) {
  constexpr int NJ = 1 << K;
  const uint64_t S = uint64_t(1) << q_lo;
  const uint64_t lo_mask = S - 1;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       t < num_quads; t += stride) {
    const uint64_t A = uint64_t(t) << 2;
    const uint64_t x0 = ((A & ~lo_mask) << K) | (A & lo_mask);
    float4 vr[NJ], vi[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      vr[j] = load4(re, x0 + j * S);
      vi[j] = load4(im, x0 + j * S);
    }
#pragma unroll
    for (int o = 0; o < NJ; ++o) {
      float4 ar, ai;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float sr = 0.0f, si = 0.0f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float ur = u.re[o * NJ + j], ui = u.im[o * NJ + j];
          sr += ur * lane4(vr[j], i) - ui * lane4(vi[j], i);
          si += ur * lane4(vi[j], i) + ui * lane4(vr[j], i);
        }
        lane4(ar, i) = sr;
        lane4(ai, i) = si;
      }
      store4(re, x0 + o * S, ar);
      store4(im, x0 + o * S, ai);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. Lane pass: out = state . M^T on every 128-value row, M complex 128x128
// ---------------------------------------------------------------------------
// Replaces qcmrf_tpu/ops/kernels.py::_build_matmul_pair_kernel
// (_lane_matmul_call): composed 1q gates on qubits 0-6. Full float32 FMAs,
// no tensor cores and no TF32 (the TPU kernel's bf16-pass emulation is not
// carried over).
// Bound on this card: float operations, 128 complex multiply-adds (1024
// float operations) per value against 16 bytes moved, so the pass is
// compute-bound at 67 TFLOP/s. Design: one block per SM (about 192 KB of
// shared memory) holds M^T as two float32 planes (m[l][j] = M[j][l], 128 KB)
// for all its tiles, and a tile of kLaneRows rows of the state. Warp w owns
// kWarpRows rows of the tile; lane t owns columns 4t .. 4t+3. Per step of 4
// l values a thread reads 8 float4 of M^T (consecutive lanes on consecutive
// 16-byte words: no bank conflict) and, per row, 2 float4 of the state (one
// address across the warp: a broadcast), then issues 4 * 4 * kWarpRows
// complex multiply-adds into 2 * 4 * kWarpRows register accumulators. The
// block reads its whole tile before any thread writes it back, so the
// update is in place.
constexpr int kWarpRows = 8;
constexpr int kLaneRows = (kThreads / 32) * kWarpRows;  // 64
constexpr int kLaneShared = (2 * 128 * 128 + 2 * kLaneRows * 128) * 4;

__global__ void __launch_bounds__(kThreads, 1)
lane_kernel(const float* __restrict__ mt, float* __restrict__ re,
            float* __restrict__ im, int64_t rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* m_re = reinterpret_cast<float*>(smem_raw);
  float* m_im = m_re + 128 * 128;
  float* v_re = m_im + 128 * 128;
  float* v_im = v_re + kLaneRows * 128;
  {
    const float4* src = reinterpret_cast<const float4*>(mt);
    float4* dst = reinterpret_cast<float4*>(m_re);
    for (int i = threadIdx.x; i < 2 * 128 * 128 / 4; i += blockDim.x) {
      dst[i] = src[i];
    }
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t num_tiles = (rows + kLaneRows - 1) / kLaneRows;
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t row0 = tile * kLaneRows;
    __syncthreads();  // M is loaded; the last tile's reads are done
    for (int i = threadIdx.x; i < kLaneRows * 32; i += blockDim.x) {
      const int64_t row = row0 + i / 32;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (row < rows) {
        a = load4(re, uint64_t(row) * 128 + (i % 32) * 4);
        b = load4(im, uint64_t(row) * 128 + (i % 32) * 4);
      }
      reinterpret_cast<float4*>(v_re)[i] = a;
      reinterpret_cast<float4*>(v_im)[i] = b;
    }
    __syncthreads();
    float acc_re[kWarpRows][4], acc_im[kWarpRows][4];
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc_re[r][c] = 0.0f;
        acc_im[r][c] = 0.0f;
      }
    }
    const float* wr = v_re + warp * kWarpRows * 128;
    const float* wi = v_im + warp * kWarpRows * 128;
#pragma unroll 1
    for (int l = 0; l < 128; l += 4) {
      float4 mr[4], mi[4];
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        mr[d] = load4(m_re, (l + d) * 128 + 4 * lane);
        mi[d] = load4(m_im, (l + d) * 128 + 4 * lane);
      }
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r) {
        float4 xr = load4(wr, r * 128 + l);
        float4 xi = load4(wi, r * 128 + l);
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          const float a = lane4(xr, d), b = lane4(xi, d);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float p = lane4(mr[d], c), q = lane4(mi[d], c);
            acc_re[r][c] = fmaf(p, a, acc_re[r][c]);
            acc_re[r][c] = fmaf(-q, b, acc_re[r][c]);
            acc_im[r][c] = fmaf(p, b, acc_im[r][c]);
            acc_im[r][c] = fmaf(q, a, acc_im[r][c]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) {
      const int64_t row = row0 + warp * kWarpRows + r;
      if (row < rows) {
        store4(re, uint64_t(row) * 128 + 4 * lane,
               make_float4(acc_re[r][0], acc_re[r][1], acc_re[r][2],
                           acc_re[r][3]));
        store4(im, uint64_t(row) * 128 + 4 * lane,
               make_float4(acc_im[r][0], acc_im[r][1], acc_im[r][2],
                           acc_im[r][3]));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3b. Factored lane pass: M = F6 (x) ... (x) F0, one 2x2 butterfly a qubit
// ---------------------------------------------------------------------------
// Replaces qcmrf_tpu/ops/kernels.py::_build_matmul_pair_kernel
// (_lane_matmul_call) on every lane op the planner emits. Such an op
// composes 1q gates on qubits 0-6, each I (x) U (x) I, and gates on
// different qubits commute, so its M is a Kronecker product of seven 2x2
// factors (the planner carries them beside M). The TPU's MXU makes the
// dense 128-wide product almost free; this card has no float32-exact
// tensor-core path as cheap, and the dense product is compute-bound
// (lane_kernel above). Factor by factor the pass does at most 7 complex
// butterflies a value (16 float operations each, 112 at most) against 16
// bytes moved, below the card's ridge: bound by device memory, like the
// copy.
// Design: one warp owns one 128-value row; lane t holds values 4t .. 4t+3
// of each plane as a float4 (512 coalesced bytes a plane a row). Qubits 0
// and 1 lie inside the float4, so their butterflies are register
// arithmetic; qubits 2-6 are lane bits 0-4, so a butterfly on qubit q
// takes its partner from lane t ^ (1 << (q - 2)) by __shfl_xor_sync, and
// the lane's own bit picks the row of F_q. Every value is updated as
// new = F[b][b] own + F[b][1-b] partner (b its bit of q), which the plain
// version repeats. Identity factors are skipped (the host passes a 7-bit
// mask). A warp takes kFactoredRows rows, all loaded before any is
// computed, on a grid that covers the rows (no grid-stride cap): the copy
// kernel's design, and at one row a warp its two float4 loads a thread;
// a warp reads its rows before it writes them and no warp touches
// another's rows, so the pass is in place.
constexpr int kFactoredRows = 1;

// out = c_own own + c_par par, complex, in this order of rounding
__device__ __forceinline__ void butterfly(float own_r, float own_i,
                                          float par_r, float par_i,
                                          float cor, float coi, float cpr,
                                          float cpi, float& out_r,
                                          float& out_i) {
  out_r = fmaf(-cpi, par_i, fmaf(cpr, par_r, fmaf(-coi, own_i, cor * own_r)));
  out_i = fmaf(cpi, par_r, fmaf(cpr, par_i, fmaf(coi, own_r, cor * own_i)));
}

__global__ void __launch_bounds__(kThreads)
lane_factored_kernel(LaneFactors f, int mask, float* __restrict__ re,
                     float* __restrict__ im, int64_t rows) {
  const int lane = threadIdx.x & 31;
  const int64_t row0 =
      ((int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5) * kFactoredRows;
  float4 vr[kFactoredRows], vi[kFactoredRows];
#pragma unroll
  for (int r = 0; r < kFactoredRows; ++r) {
    if (row0 + r < rows) {  // one answer for the whole warp
      vr[r] = load4(re, uint64_t(row0 + r) * 128 + 4 * lane);
      vi[r] = load4(im, uint64_t(row0 + r) * 128 + 4 * lane);
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (!(mask >> q & 1)) continue;
#pragma unroll
    for (int r = 0; r < kFactoredRows; ++r) {
      float4 nr, ni;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = e >> q & 1, p = e ^ (1 << q);
        const int own = 4 * q + 3 * b, par = 4 * q + 2 * b + (1 - b);
        butterfly(lane4(vr[r], e), lane4(vi[r], e), lane4(vr[r], p),
                  lane4(vi[r], p), f.re[own], f.im[own], f.re[par],
                  f.im[par], lane4(nr, e), lane4(ni, e));
      }
      vr[r] = nr;
      vi[r] = ni;
    }
  }
#pragma unroll
  for (int q = 2; q < 7; ++q) {
    if (!(mask >> q & 1)) continue;
    const int b = lane >> (q - 2) & 1;
    const float cor = b ? f.re[4 * q + 3] : f.re[4 * q];
    const float coi = b ? f.im[4 * q + 3] : f.im[4 * q];
    const float cpr = b ? f.re[4 * q + 2] : f.re[4 * q + 1];
    const float cpi = b ? f.im[4 * q + 2] : f.im[4 * q + 1];
#pragma unroll
    for (int r = 0; r < kFactoredRows; ++r) {
      if (row0 + r >= rows) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr =
            __shfl_xor_sync(0xffffffffu, lane4(vr[r], e), 1 << (q - 2));
        const float pi =
            __shfl_xor_sync(0xffffffffu, lane4(vi[r], e), 1 << (q - 2));
        butterfly(lane4(vr[r], e), lane4(vi[r], e), pr, pi, cor, coi, cpr,
                  cpi, lane4(vr[r], e), lane4(vi[r], e));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kFactoredRows; ++r) {
    if (row0 + r < rows) {
      store4(re, uint64_t(row0 + r) * 128 + 4 * lane, vr[r]);
      store4(im, uint64_t(row0 + r) * 128 + 4 * lane, vi[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// 4. Plane copy: the same bytes as a gate pass, no arithmetic
// ---------------------------------------------------------------------------
// Replaces qcmrf_tpu/runners/bench.py::copy_kernel_gbps's kernel: reads both
// planes and writes both (16 bytes a value), the same-run rate the gate
// passes are held against. Bound on this card: device memory.
// Design, the fastest of those timed side by side on the card
// (runners/copy_designs.py, on an H100 SXM at 700 W): each thread issues
// kCopyUnroll float4 loads, kThreads apart, before any store, on a grid
// that covers both planes (the first half of the blocks copy the real
// plane) with no grid-stride cap. There a grid-stride loop of one float4
// a plane an iteration (at most 16 blocks an SM) moved 2.83 TB/s, the
// same loop one plane after the other no more, a cp.async.bulk ring
// through shared memory 2.90, this design with 4-16 loads a thread
// 2.96-3.00 and with 2 loads 3.02, the planes' two copy_ calls 3.01.
constexpr int kCopyUnroll = 2;

__global__ void __launch_bounds__(kThreads)
copy_kernel(const float4* __restrict__ src_re,
            const float4* __restrict__ src_im, float4* __restrict__ dst_re,
            float4* __restrict__ dst_im, int64_t num_groups,
            int64_t blocks_per_plane) {
  const bool second = blockIdx.x >= blocks_per_plane;
  const float4* src = second ? src_im : src_re;
  float4* dst = second ? dst_im : dst_re;
  const int64_t base =
      (blockIdx.x - (second ? blocks_per_plane : 0)) * kThreads * kCopyUnroll +
      threadIdx.x;
  float4 v[kCopyUnroll];
#pragma unroll
  for (int k = 0; k < kCopyUnroll; ++k) {
    if (base + k * kThreads < num_groups) v[k] = src[base + k * kThreads];
  }
#pragma unroll
  for (int k = 0; k < kCopyUnroll; ++k) {
    if (base + k * kThreads < num_groups) dst[base + k * kThreads] = v[k];
  }
}

// ---------------------------------------------------------------------------
// 5. Float32 FMA peak: the compute rate the float kernels are held against
// ---------------------------------------------------------------------------
// Replaces bench.py::main's inner _vpu_kern (1024 chained x * x + b per
// value of a (512 * 512, 128) float32 array). Each thread runs four
// independent chains of `steps` x = fmaf(x, x, b) (1024 in the rate run),
// one per value of a float4, unrolled by 32; the block reduces its chains'
// final values to one max, written per block, so no chain is dead code.
// With `out` each chain's final value is written too, so that a short
// chain can be held value by value against its plain version; the count
// is a launch argument, so the check and the rate run execute the same
// loop. Bound on this card: float32 FMAs, 2 * steps operations a value
// against 4 bytes read.
__global__ void __launch_bounds__(kThreads)
fma_peak_kernel(const float* __restrict__ x, float b, int steps,
                int64_t num_quads, float* __restrict__ block_max,
                float* __restrict__ out) {
  __shared__ float warp_max[kThreads / 32];
  const int64_t q = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  float best = __int_as_float(static_cast<int>(0xff800000u));  // -inf
  if (q < num_quads) {
    float4 v = load4(x, uint64_t(q) << 2);
#pragma unroll 32
    for (int i = 0; i < steps; ++i) {
      v.x = fmaf(v.x, v.x, b);
      v.y = fmaf(v.y, v.y, b);
      v.z = fmaf(v.z, v.z, b);
      v.w = fmaf(v.w, v.w, b);
    }
    if (out != nullptr) store4(out, uint64_t(q) << 2, v);
    best = fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
  }
  for (int off = 16; off > 0; off >>= 1) {
    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, off));
  }
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kThreads / 32; ++i) best = fmaxf(best, warp_max[i]);
    block_max[blockIdx.x] = best;
  }
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int K>
cudaError_t launch_row(GateMatrix u, float* re, float* im, int64_t num_quads,
                       int q_lo, cudaStream_t stream) {
  row_gate_kernel<K><<<grid_blocks(num_quads, kThreads), kThreads, 0,
                       stream>>>(u, re, im, num_quads, q_lo);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int qcmrf_diag(const unsigned char* table, int n_terms, float* re, float* im,
               int64_t num_groups, void* stream) {
  const size_t bytes = sizeof(Profile) + size_t(n_terms) * sizeof(Term);
  cudaError_t err = allow_shared(diag_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  diag_kernel<<<grid_blocks(num_groups, kThreads), kThreads, bytes,
                static_cast<cudaStream_t>(stream)>>>(table, n_terms, re, im,
                                                     num_groups);
  return static_cast<int>(cudaGetLastError());
}

int qcmrf_row_gate(GateMatrix u, int k, float* re, float* im,
                   int64_t num_quads, int q_lo, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (k) {
    case 1: err = launch_row<1>(u, re, im, num_quads, q_lo, s); break;
    case 2: err = launch_row<2>(u, re, im, num_quads, q_lo, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

int qcmrf_lane(const float* mt, float* re, float* im, int64_t rows,
               void* stream) {
  cudaError_t err = allow_shared(lane_kernel, kLaneShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (rows + kLaneRows - 1) / kLaneRows;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const unsigned blocks = static_cast<unsigned>(tiles < sms ? tiles : sms);
  lane_kernel<<<blocks, kThreads, kLaneShared,
                static_cast<cudaStream_t>(stream)>>>(mt, re, im, rows);
  return static_cast<int>(cudaGetLastError());
}

int qcmrf_lane_factored(LaneFactors f, int mask, float* re, float* im,
                        int64_t rows, void* stream) {
  const int64_t per_block = (kThreads / 32) * kFactoredRows;
  const int64_t blocks = (rows + per_block - 1) / per_block;
  lane_factored_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(f, mask, re, im,
                                                              rows);
  return static_cast<int>(cudaGetLastError());
}

int qcmrf_copy(const float* src_re, const float* src_im, float* dst_re,
               float* dst_im, int64_t num_groups, void* stream) {
  const int64_t per_block = int64_t(kThreads) * kCopyUnroll;
  const int64_t blocks_per_plane = (num_groups + per_block - 1) / per_block;
  copy_kernel<<<static_cast<unsigned>(2 * blocks_per_plane), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(src_re),
      reinterpret_cast<const float4*>(src_im),
      reinterpret_cast<float4*>(dst_re), reinterpret_cast<float4*>(dst_im),
      num_groups, blocks_per_plane);
  return static_cast<int>(cudaGetLastError());
}

int qcmrf_fma_peak(const float* x, float b, int steps, int64_t num_quads,
                   float* block_max, float* out, void* stream) {
  const int64_t blocks = (num_quads + kThreads - 1) / kThreads;
  fma_peak_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      x, b, steps, num_quads, block_max, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
