// Candidate designs of the dense lane pass (lane_kernel of
// csrc/gate_kernels.cu: out = state . M^T on every 128-value row, M
// complex 128x128), built and timed by lane_designs.py beside the
// library's kernel and one float32 torch.matmul. Not part of the kernel
// library: nothing in the port launches these. The library's source is
// included whole, so the designs share its splits, wgmma k-steps and M
// layout:
//
// (f)  the library's kernel (3xTF32 on wgmma, two warpgroups a CTA, a
//      2-CTA cluster) at fold 4: its partial sums added into the float32
//      running sums every 4 k-steps of 8 instead of 2;
// (w)  the same with one warpgroup a CTA on a 64-row tile;
// (m)  mma.sync.m16n8k8 TF32 (its comment below) at folds 1, 2 and 4, and
//      (t) with lo left unrounded;
// (s)  design (m) with the tile read whole into shared memory before its
//      products and written back after them (the first tensor-core
//      version of this kernel), at fold 2 and at fold 16 (one truncating
//      tensor-core sum over all 128 l);
// (1)  one TF32 pass: design (s)'s tiles and MMAs with hi alone (a third
//      of the tensor-core work, about 3e-4 relative error: what the
//      card's accuracy check must refuse);
// (c)  the first port's design on the CUDA cores: M^T in shared memory,
//      a 64-row tile, an 8 x 4 register tile a thread, float32 FMAs.

#include "../csrc/gate_kernels.cu"

namespace {

// (m)  an earlier tensor-core design: mma.sync.m16n8k8 TF32, M (both
//      planes, padded rows) and a 64-row tile in shared memory, one block
//      an SM, M split as each fragment is read, each product as lo hi +
//      hi lo + hi hi, partial sums folded into float32 every kFold
//      k-steps (fold 1, 2, 4); the tile arrives in four cp.async chunks,
//      chunk c of the next tile fetched once every warp is done with
//      chunk c. (t) the same with lo = x - hi left to the tensor cores'
//      truncation. mma.sync runs TF32 at about half the wgmma rate.
constexpr int kMmaRows = 64;
constexpr int kMmaStride = 136;
constexpr int kMmaChunks = 4;  // of 32 l, 4 k-steps each
constexpr int kMmaShared = (2 * 128 + 2 * kMmaRows) * kMmaStride * 4;

// x = hi + lo; lo rounded to TF32 (the library's split) or left to the
// tensor cores' truncation
template <bool kRoundLo>
__device__ __forceinline__ void split_mma(float x, uint32_t& hi,
                                          uint32_t& lo) {
  if (kRoundLo) {
    split_tf32(x, hi, lo);
  } else {
    hi = tf32_rna(x);
    lo = __float_as_uint(x - __uint_as_float(hi));
  }
}

// d += a b: a the (16 x 8) row-major A fragment, b the (8 x 8) B fragment
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += x y and d += u v in 3xTF32, the four small products first
__device__ __forceinline__ void mma3x2(float (&d)[4], const Split<4>& x,
                                       const Split<2>& y, const Split<4>& u,
                                       const Split<2>& v) {
  mma_tf32(d, x.lo, y.hi[0], y.hi[1]);
  mma_tf32(d, x.hi, y.lo[0], y.lo[1]);
  mma_tf32(d, u.lo, v.hi[0], v.hi[1]);
  mma_tf32(d, u.hi, v.lo[0], v.lo[1]);
  mma_tf32(d, x.hi, y.hi[0], y.hi[1]);
  mma_tf32(d, u.hi, v.hi[0], v.hi[1]);
}

// M's planes (row j, l contiguous) into shared memory, rows padded.
__device__ __forceinline__ void mma_store_m(const float* __restrict__ m,
                                             float* m_re, float* m_im) {
  for (int i = threadIdx.x; i < 2 * 128 * 32; i += blockDim.x) {
    const int row = (i >> 5) & 127, c4 = i & 31;
    store4(i >> 12 ? m_im : m_re, row * kMmaStride + 4 * c4,
           reinterpret_cast<const float4*>(m)[i]);
  }
}

// Chunk c (l = 32 c .. 32 c + 31, both planes) of the tile at row0 into
// shared memory by cp.async, zeros past the last row; one commit group.
__device__ __forceinline__ void mma_fetch_chunk(const float* re,
                                                 const float* im,
                                                 int64_t row0, int64_t rows,
                                                 int c, float* x_re,
                                                 float* x_im) {
  for (int i = threadIdx.x; i < 2 * kMmaRows * 8; i += blockDim.x) {
    const int r = (i >> 3) % kMmaRows, q = 8 * c + (i & 7);
    const bool second = i >= kMmaRows * 8;
    const int64_t row = row0 + r;
    const float* plane = second ? im : re;
    cp_async16((second ? x_im : x_re) + r * kMmaStride + 4 * q,
               row < rows ? plane + uint64_t(row) * 128 + 4 * q : plane,
               row < rows ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One k-step (l = l0 .. l0 + 7) of a warp: part += x . M^T on its two
// m-tiles and four n-tiles. wr and wj are the thread's first tile row and
// output column j (both + g), l = l0 + 2t.
template <bool kRoundLo>
__device__ __forceinline__ void mma_kstep(const float* m_re,
                                           const float* m_im,
                                           const float* x_re,
                                           const float* x_im, int l, int wr,
                                           int wj, float (&part_re)[2][4][4],
                                           float (&part_im)[2][4][4]) {
  Split<2> br[4], bi[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const float2 vr = load2(m_re, (wj + 8 * nt) * kMmaStride + l);
    const float2 vi = load2(m_im, (wj + 8 * nt) * kMmaStride + l);
    split_mma<kRoundLo>(vr.x, br[nt].hi[0], br[nt].lo[0]);
    split_mma<kRoundLo>(vr.y, br[nt].hi[1], br[nt].lo[1]);
    split_mma<kRoundLo>(vi.x, bi[nt].hi[0], bi[nt].lo[0]);
    split_mma<kRoundLo>(vi.y, bi[nt].hi[1], bi[nt].lo[1]);
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    // A's registers: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
    const int r = (wr + 16 * mt) * kMmaStride + l;
    const float2 r0 = load2(x_re, r), r1 = load2(x_re, r + 8 * kMmaStride);
    const float2 i0 = load2(x_im, r), i1 = load2(x_im, r + 8 * kMmaStride);
    const float xr[4] = {r0.x, r1.x, r0.y, r1.y};
    const float xi[4] = {i0.x, i1.x, i0.y, i1.y};
    Split<4> ar, ai, an;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      split_mma<kRoundLo>(xr[e], ar.hi[e], ar.lo[e]);
      split_mma<kRoundLo>(xi[e], ai.hi[e], ai.lo[e]);
      an.hi[e] = ai.hi[e] ^ 0x80000000u;
      an.lo[e] = ai.lo[e] ^ 0x80000000u;
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      mma3x2(part_re[mt][nt], ar, br[nt], an, bi[nt]);
      mma3x2(part_im[mt][nt], ar, bi[nt], ai, br[nt]);
    }
  }
}

// acc += part; part = 0 (the rounded float adds of a fold)
__device__ __forceinline__ void mma_fold(float (&acc)[2][4][4],
                                          float (&part)[2][4][4]) {
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[a][b][c] += part[a][b][c];
        part[a][b][c] = 0.0f;
      }
}

// A warp's accumulators ([m-tile][n-tile][D register]) back to the planes.
// D's registers: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_store_acc(const float (&acc_re)[2][4][4],
                                               const float (&acc_im)[2][4][4],
                                               float* re, float* im,
                                               int64_t row0, int64_t rows,
                                               int wr, int wj, int g, int t) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = row0 + wr + 16 * mt + 8 * h;
      if (row >= rows) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint64_t o = uint64_t(row) * 128 + (wj - g) + 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(re + o) =
            make_float2(acc_re[mt][nt][2 * h], acc_re[mt][nt][2 * h + 1]);
        *reinterpret_cast<float2*>(im + o) =
            make_float2(acc_im[mt][nt][2 * h], acc_im[mt][nt][2 * h + 1]);
      }
    }
  }
}

template <int kFold, bool kRoundLo>
__global__ void __launch_bounds__(kThreads, 1)
lane_mma_kernel(const float* __restrict__ m, float* __restrict__ re,
            float* __restrict__ im, int64_t rows) {
  static_assert(4 % kFold == 0, "a fold is a whole part of a chunk");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* m_re = reinterpret_cast<float*>(smem_raw);
  float* m_im = m_re + 128 * kMmaStride;
  float* x_re = m_im + 128 * kMmaStride;
  float* x_im = x_re + kMmaRows * kMmaStride;
  const int64_t num_tiles = (rows + kMmaRows - 1) / kMmaRows;
  if (blockIdx.x < num_tiles) {
    for (int c = 0; c < kMmaChunks; ++c) {
      mma_fetch_chunk(re, im, int64_t(blockIdx.x) * kMmaRows, rows, c,
                       x_re, x_im);
    }
  }
  mma_store_m(m, m_re, m_im);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp >> 2) * 32 + g;
  const int wj = (warp & 3) * 32 + g;
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t row0 = tile * kMmaRows;
    const int64_t next = tile + gridDim.x;
    float acc_re[2][4][4] = {}, acc_im[2][4][4] = {};
    float part_re[2][4][4] = {}, part_im[2][4][4] = {};
#pragma unroll 1
    for (int c = 0; c < kMmaChunks; ++c) {
      // chunk c of this tile is in: of the groups committed since, the
      // later chunks of this tile and the earlier ones of the next
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kMmaChunks - 1)
                   : "memory");
      __syncthreads();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        mma_kstep<kRoundLo>(m_re, m_im, x_re, x_im, 32 * c + 8 * s + 2 * t,
                             wr, wj, part_re, part_im);
        if ((s + 1) % kFold == 0) {
          mma_fold(acc_re, part_re);
          mma_fold(acc_im, part_im);
        }
      }
      __syncthreads();  // every warp is done with chunk c
      if (next < num_tiles) {
        mma_fetch_chunk(re, im, next * kMmaRows, rows, c, x_re, x_im);
      } else {
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      }
    }
    mma_store_acc(acc_re, acc_im, re, im, row0, rows, wr, wj, g, t);
  }
}

// Rows row0 .. row0 + kMmaRows - 1 of both planes into shared memory,
// zeros past the last row (designs s and 1).
__device__ __forceinline__ void lane_load_tile(const float* re,
                                               const float* im, int64_t row0,
                                               int64_t rows, float* x_re,
                                               float* x_im) {
  for (int i = threadIdx.x; i < 2 * kMmaRows * 32; i += blockDim.x) {
    const int r = (i >> 5) % kMmaRows, c4 = i & 31;
    const bool second = i >= kMmaRows * 32;
    const int64_t row = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rows) v = load4(second ? im : re, uint64_t(row) * 128 + 4 * c4);
    store4(second ? x_im : x_re, r * kMmaStride + 4 * c4, v);
  }
}


// (s) the tile read whole before its products
template <int kFold>
__global__ void __launch_bounds__(kThreads, 1)
lane_sync_kernel(const float* __restrict__ m, float* __restrict__ re,
                 float* __restrict__ im, int64_t rows) {
  static_assert(16 % kFold == 0, "a fold is a whole number of k-steps");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* m_re = reinterpret_cast<float*>(smem_raw);
  float* m_im = m_re + 128 * kMmaStride;
  float* x_re = m_im + 128 * kMmaStride;
  float* x_im = x_re + kMmaRows * kMmaStride;
  mma_store_m(m, m_re, m_im);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp >> 2) * 32 + g;
  const int wj = (warp & 3) * 32 + g;
  const int64_t num_tiles = (rows + kMmaRows - 1) / kMmaRows;
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t row0 = tile * kMmaRows;
    __syncthreads();
    lane_load_tile(re, im, row0, rows, x_re, x_im);
    __syncthreads();
    float acc_re[2][4][4] = {}, acc_im[2][4][4] = {};
    float part_re[2][4][4] = {}, part_im[2][4][4] = {};
#pragma unroll 1
    for (int f = 0; f < 16 / kFold; ++f) {
#pragma unroll
      for (int s = 0; s < kFold; ++s) {
        mma_kstep<true>(m_re, m_im, x_re, x_im, (f * kFold + s) * 8 + 2 * t,
                         wr, wj, part_re, part_im);
      }
      mma_fold(acc_re, part_re);
      mma_fold(acc_im, part_im);
    }
    mma_store_acc(acc_re, acc_im, re, im, row0, rows, wr, wj, g, t);
  }
}


__global__ void __launch_bounds__(kThreads, 1)
lane_one_pass_kernel(const float* __restrict__ m, float* __restrict__ re,
                     float* __restrict__ im, int64_t rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* m_re = reinterpret_cast<float*>(smem_raw);
  float* m_im = m_re + 128 * kMmaStride;
  float* x_re = m_im + 128 * kMmaStride;
  float* x_im = x_re + kMmaRows * kMmaStride;
  mma_store_m(m, m_re, m_im);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp >> 2) * 32 + g;
  const int wj = (warp & 3) * 32 + g;
  const int64_t num_tiles = (rows + kMmaRows - 1) / kMmaRows;
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t row0 = tile * kMmaRows;
    __syncthreads();
    lane_load_tile(re, im, row0, rows, x_re, x_im);
    __syncthreads();
    float acc_re[2][4][4] = {}, acc_im[2][4][4] = {};
#pragma unroll 2
    for (int s = 0; s < 16; ++s) {
      const int l = s * 8 + 2 * t;
      uint32_t br[4][2], bi[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float2 vr = load2(m_re, (wj + 8 * nt) * kMmaStride + l);
        const float2 vi = load2(m_im, (wj + 8 * nt) * kMmaStride + l);
        br[nt][0] = tf32_rna(vr.x);
        br[nt][1] = tf32_rna(vr.y);
        bi[nt][0] = tf32_rna(vi.x);
        bi[nt][1] = tf32_rna(vi.y);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = (wr + 16 * mt) * kMmaStride + l;
        const float2 r0 = load2(x_re, r);
        const float2 r1 = load2(x_re, r + 8 * kMmaStride);
        const float2 i0 = load2(x_im, r);
        const float2 i1 = load2(x_im, r + 8 * kMmaStride);
        const uint32_t ar[4] = {tf32_rna(r0.x), tf32_rna(r1.x),
                                tf32_rna(r0.y), tf32_rna(r1.y)};
        const uint32_t ai[4] = {tf32_rna(i0.x), tf32_rna(i1.x),
                                tf32_rna(i0.y), tf32_rna(i1.y)};
        const uint32_t an[4] = {ai[0] ^ 0x80000000u, ai[1] ^ 0x80000000u,
                                ai[2] ^ 0x80000000u, ai[3] ^ 0x80000000u};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_tf32(acc_re[mt][nt], ar, br[nt][0], br[nt][1]);
          mma_tf32(acc_re[mt][nt], an, bi[nt][0], bi[nt][1]);
          mma_tf32(acc_im[mt][nt], ar, bi[nt][0], bi[nt][1]);
          mma_tf32(acc_im[mt][nt], ai, br[nt][0], br[nt][1]);
        }
      }
    }
    mma_store_acc(acc_re, acc_im, re, im, row0, rows, wr, wj, g, t);
  }
}


// (w) wgmma with one warpgroup a CTA: the library's k-steps, M's halves
//     and cluster barrier, on design (m)'s 64-row tile in four cp.async
//     chunks; the partial sums are drained and added every kWFold
//     k-steps. Three variants that ptxas serialized (its notes C7511,
//     C7514, C7520) ran 5.8-5.9 ms at width 28 on an H100: Xr against
//     [Mr; Mi] as one N = 128 product, two sets of partial sums in turn,
//     and the next fold's fragments read during a fold's products.
constexpr int kWThreads = 128;
constexpr int kWFold = 2;
constexpr int kWShared = 2 * 128 * 128 * 4 + 2 * kMmaRows * kMmaStride * 4;

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kWThreads, 1)
lane_wgmma_kernel(const float* __restrict__ m, float* __restrict__ re,
                  float* __restrict__ im, int64_t rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* b_hi = reinterpret_cast<uint32_t*>(smem_raw);
  uint32_t* b_lo = b_hi + 128 * 128;
  float* x_re = reinterpret_cast<float*>(b_lo + 128 * 128);
  float* x_im = x_re + kMmaRows * kMmaStride;
  const int j0 = 64 * (blockIdx.x & 1);
  const int64_t cluster = blockIdx.x >> 1, clusters = gridDim.x >> 1;
  const int64_t num_tiles = (rows + kMmaRows - 1) / kMmaRows;
  if (cluster < num_tiles) {
    for (int c = 0; c < kMmaChunks; ++c) {
      mma_fetch_chunk(re, im, cluster * kMmaRows, rows, c, x_re, x_im);
    }
  }
  lane_store_b(m, j0, b_hi, b_lo);
  const uint64_t d_hi = smem_desc(b_hi);
  const uint64_t d_lo = smem_desc(b_lo);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * warp + g;
  for (int64_t tile = cluster; tile < num_tiles; tile += clusters) {
    const int64_t row0 = tile * kMmaRows;
    const int64_t next = tile + clusters;
    float acc_re[32] = {}, acc_im[32] = {};
    float part_re[32] = {}, part_im[32] = {};
#pragma unroll 1
    for (int c = 0; c < kMmaChunks; ++c) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kMmaChunks - 1)
                   : "memory");
      __syncthreads();
#pragma unroll
      for (int f = 0; f < 4 / kWFold; ++f) {
#pragma unroll
        for (int s = 0; s < kWFold; ++s) {
          const int ks = 4 * c + kWFold * f + s;
          const int l = 8 * ks + 2 * t;
          const float2 r0 = load2(x_re, wr * kMmaStride + l);
          const float2 r1 = load2(x_re, (wr + 8) * kMmaStride + l);
          const float2 i0 = load2(x_im, wr * kMmaStride + l);
          const float2 i1 = load2(x_im, (wr + 8) * kMmaStride + l);
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
      __syncthreads();
      if (next < num_tiles) {
        mma_fetch_chunk(re, im, next * kMmaRows, rows, c, x_re, x_im);
      } else {
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      }
    }
    // both CTAs hold this tile: only now may either write its half back
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = row0 + wr + 8 * h;
      if (row >= rows) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint64_t o = uint64_t(row) * 128 + j0 + 8 * i + 2 * t;
        *reinterpret_cast<float2*>(re + o) =
            make_float2(acc_re[4 * i + 2 * h], acc_re[4 * i + 2 * h + 1]);
        *reinterpret_cast<float2*>(im + o) =
            make_float2(acc_im[4 * i + 2 * h], acc_im[4 * i + 2 * h + 1]);
      }
    }
  }
}


// (c) the CUDA-core kernel, as the library had it before the tensor cores
constexpr int kWarpRows = 8;
constexpr int kFmaRows = (kThreads / 32) * kWarpRows;  // 64
constexpr int kFmaShared = (2 * 128 * 128 + 2 * kFmaRows * 128) * 4;

__global__ void __launch_bounds__(kThreads, 1)
lane_fma_kernel(const float* __restrict__ mt, float* __restrict__ re,
            float* __restrict__ im, int64_t rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* m_re = reinterpret_cast<float*>(smem_raw);
  float* m_im = m_re + 128 * 128;
  float* v_re = m_im + 128 * 128;
  float* v_im = v_re + kFmaRows * 128;
  {
    const float4* src = reinterpret_cast<const float4*>(mt);
    float4* dst = reinterpret_cast<float4*>(m_re);
    for (int i = threadIdx.x; i < 2 * 128 * 128 / 4; i += blockDim.x) {
      dst[i] = src[i];
    }
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t num_tiles = (rows + kFmaRows - 1) / kFmaRows;
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t row0 = tile * kFmaRows;
    __syncthreads();  // M is loaded; the last tile's reads are done
    for (int i = threadIdx.x; i < kFmaRows * 32; i += blockDim.x) {
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


unsigned lane_blocks(int64_t rows, int per_block) {
  const int64_t tiles = (rows + per_block - 1) / per_block;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return static_cast<unsigned>(tiles < sms ? tiles : sms);
}


template <int kFold, bool kRoundLo>
cudaError_t launch_mma(const float* m, float* re, float* im, int64_t rows,
                       cudaStream_t stream) {
  cudaError_t err =
      allow_shared(lane_mma_kernel<kFold, kRoundLo>, kMmaShared);
  if (err != cudaSuccess) return err;
  lane_mma_kernel<kFold, kRoundLo><<<lane_blocks(rows, kMmaRows), kThreads,
                                     kMmaShared, stream>>>(m, re, im, rows);
  return cudaGetLastError();
}

template <int kFold>
cudaError_t launch_sync(const float* m, float* re, float* im, int64_t rows,
                        cudaStream_t stream) {
  cudaError_t err = allow_shared(lane_sync_kernel<kFold>, kMmaShared);
  if (err != cudaSuccess) return err;
  lane_sync_kernel<kFold><<<lane_blocks(rows, kMmaRows), kThreads,
                            kMmaShared, stream>>>(m, re, im, rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int design_lane_mma(int fold, int round_lo, const float* m, float* re,
                     float* im, int64_t rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (fold * 2 + (round_lo ? 1 : 0)) {
    case 3: err = launch_mma<1, true>(m, re, im, rows, s); break;
    case 5: err = launch_mma<2, true>(m, re, im, rows, s); break;
    case 4: err = launch_mma<2, false>(m, re, im, rows, s); break;
    case 9: err = launch_mma<4, true>(m, re, im, rows, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

int design_lane_sync(int fold, const float* m, float* re, float* im,
                     int64_t rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (fold) {
    case 2: err = launch_sync<2>(m, re, im, rows, s); break;
    case 16: err = launch_sync<16>(m, re, im, rows, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

int design_lane_one_pass(const float* m, float* re, float* im, int64_t rows,
                         void* stream) {
  cudaError_t err = allow_shared(lane_one_pass_kernel, kMmaShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  lane_one_pass_kernel<<<lane_blocks(rows, kMmaRows), kThreads, kMmaShared,
                         static_cast<cudaStream_t>(stream)>>>(m, re, im,
                                                              rows);
  return static_cast<int>(cudaGetLastError());
}

int design_lane_fma(const float* mt, float* re, float* im, int64_t rows,
                    void* stream) {
  cudaError_t err = allow_shared(lane_fma_kernel, kFmaShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  lane_fma_kernel<<<lane_blocks(rows, kFmaRows), kThreads, kFmaShared,
                    static_cast<cudaStream_t>(stream)>>>(mt, re, im, rows);
  return static_cast<int>(cudaGetLastError());
}

int design_lane_wgmma(const float* m, float* re, float* im, int64_t rows,
                      void* stream) {
  cudaError_t err = allow_shared(lane_wgmma_kernel, kWShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one cluster of two CTAs a pair of SMs, at most one a tile
  const int64_t tiles = (rows + kMmaRows - 1) / kMmaRows;
  const int64_t pairs = lane_blocks(rows, 1) / 2;
  const int64_t clusters = tiles < pairs ? tiles : (pairs ? pairs : 1);
  lane_wgmma_kernel<<<static_cast<unsigned>(2 * clusters), kWThreads,
                      kWShared, static_cast<cudaStream_t>(stream)>>>(
      m, re, im, rows);
  return static_cast<int>(cudaGetLastError());
}

int design_lane_fold(int fold, const float* m, float* re, float* im,
                     int64_t rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (fold) {
    case 2: err = launch_lane<2>(m, re, im, rows, s); break;
    case 4: err = launch_lane<4>(m, re, im, rows, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* design_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
