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
// (_lane_matmul_call) for an M given without factors: composed 1q gates on
// qubits 0-6. The TPU kernel's bf16-pass emulation is not carried over.
// Bound on this card: 128 complex multiply-adds (1024 float operations) a
// value against 16 bytes moved. On the CUDA cores that is the float32 rate
// (67 TFLOP/s: 4.10 ms at width 28, where an FMA design of this kernel
// took 7.7 ms and one float32 torch.matmul 5.7); on the tensor cores it is
// the dense TF32 rate (495 TFLOP/s), three products a value for float32
// accuracy: 1.67 ms, above the 1.28 ms of bytes.
// Design (3xTF32 on wgmma): each float32 operand x is split into
// hi = tf32_rna(x) and lo = tf32_rna(x - hi), and every product is taken
// as lo_a hi_b + hi_a lo_b + hi_a hi_b by wgmma.mma_async m64n64k8 TF32
// with float32 accumulators (lo_a lo_b, 2^-22 relative, is dropped). The
// tensor cores add with truncation: one sum over all 128 l was 1.8e-6
// from the float64 product on the card, 6x float32's error, so each
// kLaneFold k-steps (of 8 l) accumulate from zero, smaller terms first,
// and are added to the running sums by rounded float adds (2.2e-7 at
// fold 2, float32 torch.matmul 2.9e-7; fold 4 was 3% faster at 4.3e-7,
// 3.5x float32's error at width 8, too near the card's 4x check). M is split
// once, when a block starts, into hi and lo TF32 planes in shared memory
// (wgmma reads B there): 256 KB for all of M, so a cluster of two CTAs
// splits the output columns, CTA r holding M's rows j = 64 r .. 64 r + 63
// of both planes (128 KB, K-major without swizzle: core matrices of 8
// rows x 4 values, 32 along l a row group). A k-step is twelve m64n64k8
// products from A registers (the state's fragments, read from shared
// memory and split there). Two warpgroups a CTA take 64 rows each of a
// 128-row tile, so one runs its products while the other drains and adds
// its partial sums. The tile passes through a ring of two chunk slots (32
// l of both planes, rows padded to kLaneStride floats so that the
// fragments' 8-byte loads hit 32 distinct banks), chunk k + 1 fetched by
// cp.async while chunk k is multiplied. Within a k-step the k slots hold
// l in the order 0 2 4 6 1 3 5 7 (M's layout is written so), so the
// thread of fragment coordinates (g, t) reads l = 2t and 2t + 1 as one
// float2. out_re = Xr Mr^T - Xi Mi^T takes Xi's fragments with the sign
// bit flipped. Both CTAs of a cluster read the same tile and meet at a
// cluster barrier before either writes its half back, so the pass is in
// place. Designs timed beside it on the card (mma.sync with M split as
// each fragment is read, one warpgroup a CTA, ...): PERF.md section 6, row 8.
constexpr int kLaneThreads = 256;  // two warpgroups
constexpr int kLaneRows = 128;     // a tile: 64 rows a warpgroup
constexpr int kLaneStride = 40;    // a slot row: 32 l and padding
constexpr int kLaneSlot = 2 * kLaneRows * kLaneStride;  // floats
constexpr int kLaneShared = 2 * 128 * 128 * 4 + 2 * kLaneSlot * 4;
constexpr int kLaneFold = 2;

// cvt.rna.tf32.f32 for finite x (ptxas expands the instruction with a
// NaN / Inf test and a select): half a TF32 ulp added to the magnitude,
// the 13 low bits cleared.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to 2^-22 |x|, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// The split halves of one fragment: A's four registers or B's two.
template <int N>
struct Split {
  uint32_t hi[N], lo[N];
};

__device__ __forceinline__ float2 load2(const float* p, int i) {
  return *reinterpret_cast<const float2*>(p + i);
}

// 16 bytes global -> shared, without registers; zeros when bytes is 0
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

// d (+)= a . B: a the state's (64 x 8) A fragment in registers, B (8 x 64)
// K-major in shared memory at desc; scale_d 0 starts from zero (d's
// values are then ignored)
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// wgmma's descriptor of a K-major tile without swizzle at p: core
// matrices 128 bytes apart along l (the leading byte offset) and 4096
// bytes apart from one 8-row group to the next (the stride byte offset).
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  constexpr uint64_t kLbo = 128, kSbo = 32 * 128;
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return uint64_t((a & 0x3FFFF) >> 4) | ((kLbo >> 4) << 16) |
         ((kSbo >> 4) << 32);
}

// pins the accumulators' registers across the asynchronous products (no
// instruction: the compiler may not move them while a wgmma is in flight)
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int q = 0; q < 32; ++q) asm volatile("" : "+f"(d[q])::"memory");
}

// One k-step of 3xTF32 products into (re, im) as N = 64 wgmmas, the
// small terms first: re += Xr Mr - Xi Mi, im += Xr Mi + Xi Mr; go = 0
// starts the sums from zero.
__device__ __forceinline__ void wgmma_kstep(float (&re)[32], float (&im)[32],
                                            const Split<4>& ar,
                                            const Split<4>& ai,
                                            const Split<4>& an,
                                            uint64_t dh, uint64_t dl,
                                            int go) {
  constexpr uint64_t kMi = (64 / 8) * 32 * 128 / 16;  // Mi's first row
  wgmma_n64(re, ar.lo, dh, go);
  wgmma_n64(re, ar.hi, dl, 1);
  wgmma_n64(im, ar.lo, dh + kMi, go);
  wgmma_n64(im, ar.hi, dl + kMi, 1);
  wgmma_n64(re, an.lo, dh + kMi, 1);
  wgmma_n64(re, an.hi, dl + kMi, 1);
  wgmma_n64(im, ai.lo, dh, 1);
  wgmma_n64(im, ai.hi, dl, 1);
  wgmma_n64(re, ar.hi, dh, 1);
  wgmma_n64(im, ar.hi, dh + kMi, 1);
  wgmma_n64(re, an.hi, dh + kMi, 1);
  wgmma_n64(im, ai.hi, dh, 1);
}

// M's rows j0 .. j0 + 63 of both planes, split into hi and lo, in the
// wgmma layout; storage row R: R < 64 Mr[j0 + R], else Mi[j0 + R - 64].
__device__ __forceinline__ void lane_store_b(const float* __restrict__ m,
                                             int j0, uint32_t* b_hi,
                                             uint32_t* b_lo) {
  for (int i = threadIdx.x; i < 128 * 128; i += blockDim.x) {
    const int R = i >> 7, l = i & 127;
    const float v = m[(R >> 6) * 128 * 128 + (j0 + (R & 63)) * 128 + l];
    const int p = l & 7;
    const int kappa = (p & 1) ? 4 + (p >> 1) : (p >> 1);
    const int off = ((R >> 3) * 32 + 2 * (l >> 3) + (kappa >> 2)) * 32 +
                    (R & 7) * 4 + (kappa & 3);
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    b_hi[off] = hi;
    b_lo[off] = lo;
  }
  // the generic proxy's stores, seen by wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// chunk c of the tile at row0 into a slot by cp.async; one commit group
__device__ __forceinline__ void lane_fetch(const float* re, const float* im,
                                           int64_t row0, int64_t rows, int c,
                                           float* slot) {
  for (int i = threadIdx.x; i < 2 * kLaneRows * 8; i += blockDim.x) {
    const int r = (i >> 3) % kLaneRows, q = i & 7;
    const bool second = i >= kLaneRows * 8;
    const int64_t row = row0 + r;
    const float* plane = second ? im : re;
    cp_async16(slot + (second ? kLaneRows * kLaneStride : 0) +
                   r * kLaneStride + 4 * q,
               row < rows ? plane + uint64_t(row) * 128 + 32 * c + 4 * q
                          : plane,
               row < rows ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kFold>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kLaneThreads, 1)
lane_kernel(const float* __restrict__ m, float* __restrict__ re,
            float* __restrict__ im, int64_t rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* b_hi = reinterpret_cast<uint32_t*>(smem_raw);
  uint32_t* b_lo = b_hi + 128 * 128;
  float* slots = reinterpret_cast<float*>(b_lo + 128 * 128);
  const int j0 = 64 * (blockIdx.x & 1);
  const int64_t cluster = blockIdx.x >> 1, clusters = gridDim.x >> 1;
  const int64_t num_tiles = (rows + kLaneRows - 1) / kLaneRows;
  // chunk k of this CTA's sequence: tile cluster + (k / 4) clusters,
  // chunk k % 4, in slot k % 2
  const int64_t my_tiles =
      cluster < num_tiles ? (num_tiles - 1 - cluster) / clusters + 1 : 0;
  const int64_t chunks = 4 * my_tiles;
  if (chunks > 0) lane_fetch(re, im, cluster * kLaneRows, rows, 0, slots);
  lane_store_b(m, j0, b_hi, b_lo);
  const uint64_t d_hi = smem_desc(b_hi);
  const uint64_t d_lo = smem_desc(b_lo);
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 64 * wg + 16 * warp + g;
  float acc_re[32] = {}, acc_im[32] = {};
  float part_re[32] = {}, part_im[32] = {};
  for (int64_t k = 0; k < chunks; ++k) {
    const int64_t tile = cluster + (k >> 2) * clusters;
    const int c = static_cast<int>(k & 3);
    if (k + 1 < chunks) {
      const int64_t t1 = cluster + ((k + 1) >> 2) * clusters;
      lane_fetch(re, im, t1 * kLaneRows, rows, static_cast<int>((k + 1) & 3),
                 slots + ((k + 1) & 1) * kLaneSlot);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const float* x_re = slots + (k & 1) * kLaneSlot;
    const float* x_im = x_re + kLaneRows * kLaneStride;
#pragma unroll
    for (int f = 0; f < 4 / kFold; ++f) {
#pragma unroll
      for (int s = 0; s < kFold; ++s) {
        const int ks = 4 * c + kFold * f + s;
        const int l = 8 * (kFold * f + s) + 2 * t;
        const float2 r0 = load2(x_re, wr * kLaneStride + l);
        const float2 r1 = load2(x_re, (wr + 8) * kLaneStride + l);
        const float2 i0 = load2(x_im, wr * kLaneStride + l);
        const float2 i1 = load2(x_im, (wr + 8) * kLaneStride + l);
        const float xr[4] = {r0.x, r1.x, r0.y, r1.y};
        const float xi[4] = {i0.x, i1.x, i0.y, i1.y};
        Split<4> ar, ai, an;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split_tf32(xr[e], ar.hi[e], ar.lo[e]);
          split_tf32(xi[e], ai.hi[e], ai.lo[e]);
          an.hi[e] = ai.hi[e] ^ 0x80000000u;
          an.lo[e] = ai.lo[e] ^ 0x80000000u;
        }
        fence_operands(part_re);
        fence_operands(part_im);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        wgmma_kstep(part_re, part_im, ar, ai, an, d_hi + 16 * ks,
                    d_lo + 16 * ks, s == 0 ? 0 : 1);
        fence_operands(part_re);
        fence_operands(part_im);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n"
                   "wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(part_re);
      fence_operands(part_im);
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        acc_re[q] += part_re[q];
        acc_im[q] += part_im[q];
      }
    }
    __syncthreads();  // every warp is done with this slot
    if (c == 3) {
      // both CTAs hold the tile: only now may either write its half back
      asm volatile("barrier.cluster.arrive.release.aligned;\n"
                   "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
      const int64_t row0 = tile * kLaneRows;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = row0 + wr + 8 * h;
        if (row < rows) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const uint64_t o = uint64_t(row) * 128 + j0 + 8 * i + 2 * t;
            *reinterpret_cast<float2*>(re + o) = make_float2(
                acc_re[4 * i + 2 * h], acc_re[4 * i + 2 * h + 1]);
            *reinterpret_cast<float2*>(im + o) = make_float2(
                acc_im[4 * i + 2 * h], acc_im[4 * i + 2 * h + 1]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 32; ++q) acc_re[q] = acc_im[q] = 0.0f;
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
// (PERF.md section 6, row 17; an H100 SXM at 700 W): each thread issues
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

// One cluster of two CTAs a pair of SMs, at most one a tile; each CTA
// holds its half of M for all its tiles.
template <int kFold>
cudaError_t launch_lane(const float* m, float* re, float* im, int64_t rows,
                        cudaStream_t stream) {
  cudaError_t err = allow_shared(lane_kernel<kFold>, kLaneShared);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (rows + kLaneRows - 1) / kLaneRows;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int64_t clusters = tiles < sms / 2 ? tiles : sms / 2;
  lane_kernel<kFold><<<static_cast<unsigned>(2 * clusters), kLaneThreads,
                       kLaneShared, stream>>>(m, re, im, rows);
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

int qcmrf_lane(const float* m, float* re, float* im, int64_t rows,
               void* stream) {
  return static_cast<int>(launch_lane<kLaneFold>(
      m, re, im, rows, static_cast<cudaStream_t>(stream)));
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
