// Hand-written Hopper (sm_90a) kernel of the classical Gibbs sampler: C
// independent single-site systematic-scan chains of one clique structure,
// each with its own theta, in one launch. Not the port of a TPU kernel: the
// JAX package runs its chains as lax.scan loops compiled on the device
// (qcmrf_tpu/models/sample.py::sample_gibbs and ::sample_gibbs_bits), and
// in eager PyTorch a site update would be six to eight small launches.
//
// Built and bound as qcmrf_kernels.cu (qcmrf_tpu_torch/ops/_build.py):
// the extern "C" entry point launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError().
//
// One warp a chain, one block a warp. Each sweep starts with the warp
// drawing the sweep's uniforms into shared memory (a Philox call a lane
// and four sites); then the sites v = 0 .. n-1 go in order (variable 0
// first, as the JAX package's chains), clamped sites skipped. At site v:
//   delta = the sum over the items of v (clique k, slot j) of
//           theta[off_k + y + 2^(m-1-j)] - theta[off_k + y],
//           y the clique's slot word with slot j at 0: lane l adds the
//           differences of items l, l + 32, ... in turn (from 0), then a
//           butterfly of shuffles adds the 32 lane sums (xor 16, 8, 4, 2,
//           1), every sum rounded once in float32, so every lane holds the
//           same delta;
//   p1    = 1 / (1 + exp(-beta * delta));
//   bit   = u < p1, u = (w >> 8) * 2^-24, w word v % 4 of Philox4x32-10 at
//           key (seed, chain id) and counter (s, v / 4, 0, 0).
// The initial bit of a free site is bit 0 of word v % 4 at counter
// (0, v / 4, 1, 0). After sweep burn + i * thin the state is sample i.
// qcmrf_tpu_torch/ops/gibbs_kernel.py::gibbs_chains_reference repeats this
// arithmetic in the same order, vectorised over the chains.
//
// What bounds it: a chain is a dependent sequence of site updates (each
// reads the bits the previous ones wrote), so one chain is bound by the
// latency of a site's chain: an item's loads (its record, its other
// slots' bits, two theta entries through the read-only cache), the
// shuffles, exp and the division; not by the card's rate. The warp takes
// a site's items in parallel and the sweep's random words off that chain.
// Many chains a launch run side by side on the 132 SMs. theta stays in
// device memory (a clique of 18 variables holds 2^18 entries); what a site
// update indexes by is in shared memory.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

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

// Philox4x32-10 (Salmon et al., SC'11), as in qcmrf_kernels.cu.
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

__device__ __forceinline__ uint32_t word(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

struct GibbsArgs {
  const int* chain_ids;     // (C,) Philox key word 1 of each chain
  const float* thetas;      // (C, d) each chain's theta, clique-major
  int64_t d;
  const int* heads;         // (n + 1,) item offsets of each site
  const int4* items;        // (I,) theta offset, bit of the slot, and the
                            // item's range of other slots in `others`
  const int2* others;       // (M,) variable and bit of each other slot
  const signed char* evidence;  // (n,) -1 free, else the clamped bit; or null
  signed char* out;         // (C, num_samples, n) bits
  float beta;
  uint32_t seed;
  int n, n_items, n_others, sweeps, burn, thin, num_samples;
};

constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(32) gibbs_kernel(GibbsArgs a) {
  extern __shared__ int4 smem[];
  const int n = a.n;
  const int lane = threadIdx.x;
  int4* s_items = smem;
  int2* s_others = reinterpret_cast<int2*>(s_items + a.n_items);
  int* s_heads = reinterpret_cast<int*>(s_others + a.n_others);
  float* s_u = reinterpret_cast<float*>(s_heads + n + 1);
  signed char* s_ev = reinterpret_cast<signed char*>(s_u + n);
  unsigned char* s_bits = reinterpret_cast<unsigned char*>(s_ev + n);

  const int c = blockIdx.x;
  const PhiloxKey key = philox_key(a.seed, static_cast<uint32_t>(
                                               a.chain_ids[c]));
  for (int i = lane; i < a.n_items; i += 32) s_items[i] = a.items[i];
  for (int i = lane; i < a.n_others; i += 32) s_others[i] = a.others[i];
  for (int i = lane; i <= n; i += 32) s_heads[i] = a.heads[i];
  for (int g = lane; 4 * g < n; g += 32) {
    const uint4 w = philox4x32_10(0u, static_cast<uint32_t>(g), 1u, 0u, key);
    for (int i = 0; i < 4 && 4 * g + i < n; ++i) {
      const int v = 4 * g + i;
      const signed char e = a.evidence ? a.evidence[v] : -1;
      s_ev[v] = e;
      s_bits[v] = e >= 0 ? static_cast<unsigned char>(e)
                         : static_cast<unsigned char>(word(w, i) & 1u);
    }
  }
  __syncwarp();

  const float* __restrict__ th = a.thetas + static_cast<int64_t>(c) * a.d;
  signed char* out = a.out + static_cast<int64_t>(c) * a.num_samples * n;
  int sample = 0;
  for (int s = 0; s < a.sweeps; ++s) {
    for (int g = lane; 4 * g < n; g += 32) {
      const uint4 w = philox4x32_10(static_cast<uint32_t>(s),
                                    static_cast<uint32_t>(g), 0u, 0u, key);
      for (int i = 0; i < 4 && 4 * g + i < n; ++i)
        s_u[4 * g + i] = static_cast<float>(word(w, i) >> 8) * 0x1p-24f;
    }
    __syncwarp();
    for (int v = 0; v < n; ++v) {
      if (s_ev[v] >= 0) continue;
      float delta = 0.0f;
      for (int it = s_heads[v] + lane; it < s_heads[v + 1]; it += 32) {
        const int4 item = s_items[it];
        int y = 0;
        for (int q = item.z; q < item.w; ++q) {
          const int2 o = s_others[q];
          y += static_cast<int>(s_bits[o.x]) * o.y;
        }
        const float* t = th + item.x + y;
        delta = __fadd_rn(delta, __fsub_rn(__ldg(t + item.y), __ldg(t)));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        delta = __fadd_rn(delta, __shfl_xor_sync(kFull, delta, off));
      const float x = __fmul_rn(a.beta, delta);
      const float p1 = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
      const unsigned char bit = s_u[v] < p1 ? 1 : 0;
      __syncwarp();
      if (lane == 0) s_bits[v] = bit;
      __syncwarp();
    }
    if (s >= a.burn && (s - a.burn) % a.thin == 0 && sample < a.num_samples) {
      signed char* row = out + static_cast<int64_t>(sample) * n;
      for (int v = lane; v < n; v += 32)
        row[v] = static_cast<signed char>(s_bits[v]);
      ++sample;
    }
    __syncwarp();
  }
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

constexpr int kChase = 256;

// The latency of each dependent step of a site update, measured by one warp
// (a probe: it computes nothing the sampler uses). out[k] is the clock64
// cycles of `steps` dependent repeats of step k:
//   0 a shared-memory load (a pointer chase, one address for the warp),
//   1 an __ldg load that hits L1 (a pointer chase over 1 KiB, warmed),
//   2 a shuffle and the addition of its value (a step of the butterfly),
//   3 p1 from delta: the product with beta, expf, the addition, the division,
//   4 a bit's round trip: __syncwarp, lane 0's shared store, __syncwarp and
//     the load of the stored value,
//   5 a float32 addition;
// out[6] and out[7] are the clock64 cycles and the %globaltimer nanoseconds
// of the whole probe, which give the SM clock while it ran.
__global__ void __launch_bounds__(32) gibbs_latency_kernel(
    const int* __restrict__ chase, int steps, float beta, long long* out,
    int* sink) {
  __shared__ int s_chase[kChase];
  __shared__ int s_cell;
  const int lane = threadIdx.x;
  for (int i = lane; i < kChase; i += 32) s_chase[i] = chase[i];
  if (lane == 0) s_cell = 0;
  __syncwarp();
  int idx = 0;
  for (int i = 0; i < kChase; ++i) idx = __ldg(chase + idx);
  long long t[7];
  const uint64_t ns0 = global_ns();
  t[0] = clock64();
#pragma unroll 16
  for (int s = 0; s < steps; ++s) idx = s_chase[idx];
  t[1] = clock64();
#pragma unroll 16
  for (int s = 0; s < steps; ++s) idx = __ldg(chase + idx);
  float x = 0.25f * static_cast<float>(idx + lane);
  t[2] = clock64();
#pragma unroll 16
  for (int s = 0; s < steps; ++s)
    x = __fadd_rn(__shfl_xor_sync(kFull, x, 1), -0.5f);
  float p = __fmaf_rn(1e-9f, x, 0.5f);
  t[3] = clock64();
#pragma unroll 16
  for (int s = 0; s < steps; ++s)
    p = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-__fmul_rn(beta, p))));
  idx += p > 2.0f;
  t[4] = clock64();
#pragma unroll 16
  for (int s = 0; s < steps; ++s) {
    __syncwarp();
    if (lane == 0) s_cell = idx + 1;
    __syncwarp();
    idx = s_cell;
  }
  float q = static_cast<float>(idx);
  t[5] = clock64();
#pragma unroll 16
  for (int s = 0; s < steps; ++s) q = __fadd_rn(q, 1.0f);
  t[6] = clock64();
  const uint64_t ns1 = global_ns();
  sink[lane] = idx + static_cast<int>(x + p + q);
  if (lane == 0) {
    for (int k = 0; k < 6; ++k) out[k] = t[k + 1] - t[k];
    out[6] = t[6] - t[0];
    out[7] = static_cast<long long>(ns1 - ns0);
  }
}

}  // namespace

extern "C" {

int qcmrf_gibbs_latency(const int* chase, int steps, float beta,
                        long long* out, int* sink, void* stream) {
  gibbs_latency_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      chase, steps, beta, out, sink);
  return static_cast<int>(cudaGetLastError());
}

int qcmrf_gibbs(uint32_t seed, const int* chain_ids, const float* thetas,
                int64_t d, float beta, int n, const int* heads,
                const int* items, int n_items, const int* others,
                int n_others, const signed char* evidence, int C, int sweeps,
                int burn, int thin, int num_samples, signed char* out,
                int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gibbs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  GibbsArgs a{chain_ids, thetas, d, heads,
              reinterpret_cast<const int4*>(items),
              reinterpret_cast<const int2*>(others), evidence, out, beta,
              seed, n, n_items, n_others, sweeps, burn, thin, num_samples};
  gibbs_kernel<<<C, 32, smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
