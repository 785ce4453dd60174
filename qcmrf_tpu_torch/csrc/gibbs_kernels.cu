// Hand-written Hopper (sm_90a) kernel of the classical Gibbs sampler: C
// independent single-site systematic-scan chains, each on its own theta and
// on one of several clique structures, in one launch. Not the port of a TPU
// kernel: the JAX package runs its chains as lax.scan loops compiled on the
// device (qcmrf_tpu/models/sample.py::sample_gibbs and ::sample_gibbs_bits),
// and in eager PyTorch a site update would be six to eight small launches.
//
// Built and bound as qcmrf_kernels.cu (qcmrf_tpu_torch/ops/_build.py):
// the extern "C" entry points launch on the caller's stream, allocate
// nothing, and return cudaGetLastError().
//
// Two warps a chain, one block a chain. Each sweep visits the chain's free
// sites in order (variable 0 first, as the JAX package's chains; clamped
// sites are not in the list). At site v:
//   delta = the sum over the items of v (clique k, slot j) of
//           D_k,j[y] = theta[off_k + y + 2^(m-1-j)] - theta[off_k + y],
//           y the clique's slot word with slot j at 0, every sum rounded
//           once in float32; with I <= 2^k <= 32 items, lane l takes item
//           l mod 2^k (0.0 past I) and a butterfly of k shuffles (xor
//           2^(k-1) .. 1) adds them; past 32 items lane l adds items l,
//           l + 32, ... in turn, then the 5 levels. Every lane ends with
//           the same delta, the sum the full 5-level butterfly gives (the
//           levels skipped add exact zeros);
//   bit   = beta * delta >= T(u), T(u) the least float32 above
//           logit(u) = log(k) - log(2^24 - k) (in float64), u = k * 2^-24,
//           k = w >> 8 and w word v % 4 of Philox4x32-10 at key (seed,
//           chain id) and counter (s, v / 4, 0, 0): the draw u < sigmoid(x)
//           decided without exp or division.
// The initial bit of a free site is bit 0 of word v % 4 at counter
// (0, v / 4, 1, 0). After sweep burn + i * thin the state is sample i.
// qcmrf_tpu_torch/ops/gibbs_kernel.py::gibbs_chains_reference computes the
// same chains from theta directly, the sums in the same order.
//
// What bounds it: a chain is a dependent sequence of site updates (each
// reads the bits the one before wrote), so one chain is bound by the
// latency of a site's dependent path, not by the card's rate. The design
// cuts that path to the sum:
//   - the state of n <= 64 variables is one 64-bit word that every lane
//     holds; each lane decides the bit itself and sets it in its word (no
//     shared store, no __syncwarp); an item's slot word comes from the
//     word by shifts and masks;
//   - D = theta difference, one float32 per (item, slot word), is built at
//     the launch's start: one shared load an item (device memory where the
//     table does not fit);
//   - a site's records are loaded while the site before is updated;
//   - the second warp draws the coming sweeps' uniforms and computes their
//     thresholds while the first runs the sites: G = 32 / free sites
//     sweeps a pass (one lane a sweep and site), through a ring of two
//     groups in shared memory and four named barriers;
//   - the butterfly is only as deep as the site's item count needs.
// Two loops run the sites. The fast loop takes a structure of n <= 63
// whose sites hold at most 32 items of at most 4 other slots, D in shared
// memory: templated on the structure's butterfly depth and slot count, it
// runs a ring group as one flat sequence of updates over a lane table in
// shared memory (a row a site and lane: the lane's item, its packed slot
// variables, the site's bit), with no branch on its path. The general
// loop takes every other structure: per-site depths, items past 32 lanes
// in rounds, long slot lists, D in device memory, and past 64 variables
// the state as a byte a site in shared memory (template kRegState =
// false), where lane 0 stores the bit and the warp syncs.
//
// AIS mode (template kAis, entry point qcmrf_gibbs_ais): the chains of
// annealed importance sampling (qcmrf_tpu/models/ais.py::_ais_body, a
// lax.scan over rungs; no Pallas kernel), every rung of every chain in one
// launch. Chain c starts from the same uniform initial state; rung t = 0 ..
// T-1 first adds w_t * theta^T phi(x) to the chain's log-weight, then runs
// per_temp sweeps deciding fl(s_t * delta) >= T(u), where the schedule
// sched[t] = s_t = fl(beta_{t+1} * beta) and sched[T + t] = w_t =
// fl(fl(beta_{t+1} - beta_t) * beta) comes from the wrapper (beta_t the
// float32 linear schedule). Sweep t * per_temp + j draws from counter
// (t * per_temp + j, v / 4, 0, 0), so the producer warp and the thresholds
// are those of a Gibbs chain of T * per_temp sweeps. theta^T phi(x) is
// summed in a warp's order: lane l adds cliques l, l + 32, ... in turn,
// then the 5-level butterfly (gibbs_kernel.py::warp_sum). The launch writes
// each chain's final state (its `out` row) and log-weight, no samples.

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

// T(u) for u = k * 2^-24: the least float32 strictly above logit(u), so
// that x >= T(u) exactly when x > logit(u) (u < sigmoid(x)); T(0) is
// -FLT_MAX. gibbs_kernel.py::site_thresholds computes the same.
__device__ __forceinline__ float site_threshold(uint32_t k) {
  const double L = log(static_cast<double>(k)) -
                   log(static_cast<double>(16777216u - k));
  float t = __double2float_rn(L);
  if (static_cast<double>(t) <= L)
    t = nextafterf(t, __int_as_float(0x7f800000));
  return t;
}

// Bit `var` (0..63) of the state word.
__device__ __forceinline__ uint32_t state_bit(uint64_t st, uint32_t var) {
  return static_cast<uint32_t>(st >> var) & 1u;
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStructInts = 12;
// Other slots of an item packed into its record, 6 bits a variable, on the
// register-state path; an item with more reads its list in `others`.
constexpr int kInline = 4;

// Per structure (int32 x kStructInts): n, free sites, first meta row, D
// entries (the zero entry at that index follows them), evidence offset
// (-1: none), first and end record (the ones whose D this structure
// builds), 1 where an item has 6 or more other slots (its D built by the
// whole block), the fast loop's K | C << 4 | 1 << 8 (0: the general loop),
// its first lane-table row.
// A lane-table row (int4, one a free site and lane, the free sites
// repeated G times, fast loop only): the
// lane's D entry base (item l mod 2^K of the site, or the zero entry), its
// C other slots' variables packed 6 bits each (63, a bit that is always 0
// below n = 64, for a slot the item lacks), and the site's bit 1 << v as
// two words.
// Per chain (int64 x 4): theta offset, output offset, D offset in the
// device-memory table (0 where D is in shared memory), Philox key word 1
// in the low and the structure in the high 32 bits.
// A record (int4): x the low 32 bits of the item's first D entry; y the
// clique's theta offset; z = c | pos << 8 | (first D entry >> 32) << 16,
// c the clique's other slots, pos = m-1-j the item's bit in the slot
// word; w its other slots' variables packed (register path, c <= kInline)
// or the first of them in `others`. The other slots are in increasing
// order of their bit in the slot word: bit i of an entry's index is the
// i-th of them. A meta row (int2): the site's first record, and v | k <<
// 24; the next row's first record ends the site's.
struct GibbsArgs {
  const long long* chains;
  const int* structs;
  const int4* records;
  const int4* lanes;
  const int2* meta;
  const int* others;
  const signed char* evidence;
  const float* thetas;
  float* delta;       // device-memory D tables, or null: D in shared
  signed char* out;
  float beta;
  uint32_t seed;
  int sweeps, burn, thin, num_samples;
  // AIS mode only (null and 0 otherwise): the schedule (2 x temps floats:
  // the sweeps' scales, then the rungs' weight factors), the structure's
  // cliques (int4 a clique: theta offset, first variable in `vars`, size,
  // and where `packed` its variables 6 bits each, the first lowest), the
  // rungs' sweeps, and the chains' log-weights (C floats)
  const float* sched;
  const int4* cliques;
  const int* vars;
  int num_cliques, packed, temps, per_temp;
  float* logw;
};

// The largest clique whose variables pack into one record (6 bits each).
constexpr int kPackedClique = 5;

// theta's full slot word for entry e of an item: e with a 0 inserted at
// bit pos.
__device__ __forceinline__ uint32_t expand_entry(uint32_t e, int pos) {
  const uint32_t low = e & ((1u << pos) - 1u);
  return low | ((e >> pos) << (pos + 1));
}

__device__ __forceinline__ float item_entry(const float* th, const int4& r,
                                            uint32_t e) {
  const int pos = (r.z >> 8) & 0xff;
  const float* t = th + r.y + expand_entry(e, pos);
  return __fsub_rn(t[1u << pos], t[0]);
}

__device__ __forceinline__ long long item_base(const int4& r) {
  return (static_cast<long long>(static_cast<unsigned>(r.z) >> 16) << 32) |
         static_cast<unsigned>(r.x);
}

// Build the chain's D table: small items a thread each, items of 64 or
// more entries by the whole block.
__device__ void build_delta(const GibbsArgs& a, const int* sd,
                            const float* th, float* dl) {
  const int tid = threadIdx.x;
  for (int i = sd[5] + tid; i < sd[6]; i += blockDim.x) {
    const int4 r = __ldg(a.records + i);
    const int c = r.z & 0xff;
    if (c >= 6) continue;
    const long long b = item_base(r);
    for (uint32_t e = 0; e < (1u << c); ++e) dl[b + e] = item_entry(th, r, e);
  }
  for (int i = sd[5]; sd[7] && i < sd[6]; ++i) {
    const int4 r = __ldg(a.records + i);
    const int c = r.z & 0xff;
    if (c < 6) continue;
    const long long b = item_base(r);
    for (uint32_t e = tid; e < (1u << c); e += blockDim.x)
      dl[b + e] = item_entry(th, r, e);
  }
  if (tid == 0) dl[sd[3]] = 0.0f;
}

// The site's records as the consumer lane holds them while the site
// before is updated.
struct Site {
  uint64_t mask;   // 1 << v
  int v, base, items, k;
  int4 rec;        // this lane's first item, or the zero item
};

__device__ __forceinline__ Site load_site(const GibbsArgs& a, int row,
                                          int lane, int zero) {
  Site s;
  const int2 m = __ldg(a.meta + row);
  const int end = __ldg(&a.meta[row + 1].x);
  s.v = m.y & 0xffffff;
  s.k = m.y >> 24;
  s.base = m.x;
  s.items = end - m.x;
  s.mask = 1ull << (s.v & 63);
  const int idx = s.items > 32 ? lane : (lane & ((1 << s.k) - 1));
  s.rec = idx < s.items ? __ldg(a.records + m.x + idx)
                        : make_int4(zero, 0, 0, 0);
  return s;
}

template <bool kRegState>
__device__ __forceinline__ uint32_t slot_word(const GibbsArgs& a,
                                              const int4& r, uint64_t st,
                                              const unsigned char* bits) {
  const int c = r.z & 0xff;
  uint32_t y = 0;
  if (kRegState && c <= kInline) {
    const uint32_t p = static_cast<uint32_t>(r.w);
#pragma unroll
    for (int q = 0; q < kInline; ++q)
      y |= state_bit(st, (p >> (6 * q)) & 63u) << q;
    return y & ((1u << c) - 1u);
  }
  for (int q = 0; q < c; ++q) {
    const int var = __ldg(a.others + r.w + q);
    y |= (kRegState ? state_bit(st, var) : bits[var]) << q;
  }
  return y;
}

template <bool kRegState, bool kDeltaShared>
__device__ __forceinline__ float item_delta(const GibbsArgs& a,
                                            const int4& r, uint64_t st,
                                            const unsigned char* bits,
                                            const float* dl) {
  const uint32_t y = slot_word<kRegState>(a, r, st, bits);
  if (kDeltaShared) return dl[static_cast<int>(r.x) + y];
  return dl[item_base(r) + y];
}

__device__ __forceinline__ float butterfly(float acc, int k) {
  switch (k) {
    case 5:
      acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, 16));
      [[fallthrough]];
    case 4:
      acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, 8));
      [[fallthrough]];
    case 3:
      acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, 4));
      [[fallthrough]];
    case 2:
      acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, 2));
      [[fallthrough]];
    case 1:
      acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, 1));
      [[fallthrough]];
    default:
      break;
  }
  return acc;
}

// The thresholds pass from the producer warp to the consumer warp through
// a ring of two slots, each a group of G sweeps (G = 32 / free sites, at
// least 1: a producer pass fills a group, one lane a sweep and site).
// Named barrier 1 + k says slot k is full (the producer arrives, the
// consumer waits), 3 + k that it is empty (the consumer arrives, the
// producer waits before it fills the slot again). A barrier a slot: the
// producer may fill both slots before the consumer waits once, and two
// arrivals of one warp at one barrier would complete it without the
// other.
struct Ring {
  float* base;
  int n_free, G, groups;

  __device__ Ring(float* b, int free, int sweeps)
      : base(b), n_free(free), G(free > 0 && free < 32 ? 32 / free : 1),
        groups((sweeps + G - 1) / G) {}

  __device__ float* slot(int g) const { return base + (g & 1) * G * n_free; }
};

// (the ids are immediates: a register id makes ptxas reserve all 16)
__device__ __forceinline__ void wait_full(int g) {
  if (g & 1) asm volatile("bar.sync 2, 64;" ::: "memory");
  else asm volatile("bar.sync 1, 64;" ::: "memory");
}
__device__ __forceinline__ void arrive_full(int g) {
  __threadfence_block();
  if (g & 1) asm volatile("bar.arrive 2, 64;" ::: "memory");
  else asm volatile("bar.arrive 1, 64;" ::: "memory");
}
__device__ __forceinline__ void wait_empty(int g) {
  if (g & 1) asm volatile("bar.sync 4, 64;" ::: "memory");
  else asm volatile("bar.sync 3, 64;" ::: "memory");
}
__device__ __forceinline__ void arrive_empty(int g) {
  if (g & 1) asm volatile("bar.arrive 4, 64;" ::: "memory");
  else asm volatile("bar.arrive 3, 64;" ::: "memory");
}

// The consumer's walk over the ring: the thresholds of the current sweep.
struct RingCursor {
  const Ring r;
  int g = 0, j = 0;

  __device__ explicit RingCursor(const Ring& ring) : r(ring) {}

  // at the start of a sweep: its thresholds, waiting for a full group
  __device__ const float* begin() {
    if (j == 0) wait_full(g);
    return r.slot(g) + j * r.n_free;
  }
  // at its end: hand an exhausted group back, unless no pass refills it
  __device__ void end() {
    if (++j == r.G) {
      if (g + 2 < r.groups) arrive_empty(g);
      j = 0;
      ++g;
    }
  }
};

// The fast loop: a structure of n <= 63 variables with free sites, each
// holding at most 32 items of at most kC other slots, D in shared memory.
// It runs a ring group (G sweeps) as one flat loop of G x free-site
// updates over a lane table repeated G times. An update is one shared load
// of the lane's row (an update ahead), the slot word from the state word,
// one D load, kK butterfly levels (item l mod 2^kK on lane l, so a site of
// fewer items adds exact zeros: the sum is warp_sum's), the product, the
// compare and the select; the sample test is the only other branch.
struct FastArgs {
  const int4* lt;      // the lane table, in shared memory
  Ring ring;           // the thresholds
  const float* dl;     // D, in shared memory
  signed char* out;
  float beta;
  int n, n_free, sweeps, burn, thin;
};

// One site update of the fast loop: the slot word of the lane's row from
// the state word, its D entry, kK butterfly levels, the decision.
template <int kK, int kC>
__device__ __forceinline__ uint64_t fast_update(const FastArgs& f,
                                                const int4& row, float tv,
                                                uint64_t st, float scale) {
  uint32_t y = 0;
#pragma unroll
  for (int q = 0; q < kC; ++q)
    y |= state_bit(st, (static_cast<uint32_t>(row.y) >> (6 * q)) & 63u) << q;
  float acc = f.dl[row.x + static_cast<int>(y)];
#pragma unroll
  for (int off = (1 << kK) >> 1; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
  const uint64_t m = static_cast<uint64_t>(static_cast<uint32_t>(row.w))
                         << 32 |
                     static_cast<uint32_t>(row.z);
  return __fmul_rn(scale, acc) >= tv ? (st | m) : (st & ~m);
}

// AIS: the rung's log-weight step, logw + w_rung * theta^T phi(x), every
// lane with the same value. theta^T phi(x) in a warp's order: lane l adds
// cliques l, l + 32, ... in turn from 0.0, then the 5-level butterfly. On
// the word path with packed cliques a clique is one record load (`recs`,
// the records in shared memory) and one theta load, the loop unrolled so
// that several cliques' loads are in flight at once (a rung would
// otherwise wait on three dependent device loads a clique: the record, its
// variables, the theta entry).
template <bool kRegState>
__device__ __forceinline__ float rung_weight(const GibbsArgs& a,
                                             const int4* recs,
                                             const float* th, int rung,
                                             uint64_t st,
                                             const unsigned char* bits,
                                             float logw) {
  const int lane = threadIdx.x & 31;
  float acc = 0.0f;
  if (kRegState && a.packed) {
#pragma unroll 4
    for (int k = lane; k < a.num_cliques; k += 32) {
      const int4 q = recs[k];
      const uint32_t p = static_cast<uint32_t>(q.w);
      uint32_t idx = 0;
#pragma unroll
      for (int j = 0; j < kPackedClique; ++j)
        if (j < q.z) idx = idx << 1 | state_bit(st, (p >> (6 * j)) & 63u);
      acc = __fadd_rn(acc, __ldg(th + q.x + idx));
    }
  } else {
    for (int k = lane; k < a.num_cliques; k += 32) {
      const int4 q = __ldg(a.cliques + k);
      uint32_t idx = 0;
      for (int j = 0; j < q.z; ++j) {
        const int var = __ldg(a.vars + q.y + j);
        idx = idx << 1 | (kRegState ? state_bit(st, var) : bits[var]);
      }
      acc = __fadd_rn(acc, __ldg(th + q.x + idx));
    }
  }
  acc = butterfly(acc, 5);
  return __fadd_rn(logw, __fmul_rn(__ldg(a.sched + a.temps + rung), acc));
}

// One chain on the fast loop: the ring's groups in turn, the lane table's
// rows prefetched a row ahead. Gibbs mode runs a group's updates in
// segments, each ending where a sample's sweep does (`at`) or with the
// group; AIS mode runs it sweep by sweep, each at its rung's scale, the
// rung's log-weight step (rung_weight) before its first sweep.
template <bool kAis, int kK, int kC>
__device__ __forceinline__ uint64_t fast_chain(const FastArgs& f,
                                               const GibbsArgs& a,
                                               const int4* recs,
                                               const float* th, uint64_t st,
                                               float& logw) {
  const int lane = threadIdx.x & 31;
  const Ring& r = f.ring;
  const int per = r.G * f.n_free;   // site updates of a full group
  int next_sample = f.burn;
  signed char* out = f.out;
  int4 cur = f.lt[lane];
  for (int g = 0; g < r.groups; ++g) {
    wait_full(g);
    const float* t = r.slot(g);
    const int s0 = g * r.G;
    if constexpr (kAis) {
      const int nsw = min(r.G, f.sweeps - s0);
      int e = 0;
      for (int j = 0; j < nsw; ++j) {
        const int s = s0 + j;
        const int rung = s / a.per_temp;
        if (s == rung * a.per_temp)
          logw = rung_weight<true>(a, recs, th, rung, st, nullptr, logw);
        const float scale = __ldg(a.sched + rung);
        for (const int stop = e + f.n_free; e < stop; ++e) {
          const int4 nxt = f.lt[(e + 1 == per ? 0 : e + 1) * 32 + lane];
          st = fast_update<kK, kC>(f, cur, t[e], st, scale);
          cur = nxt;
        }
      }
    } else {
      const int count = min(r.G, f.sweeps - s0) * f.n_free;
      int at = next_sample - s0 < r.G ? (next_sample - s0 + 1) * f.n_free - 1
                                      : count;
      for (int e = 0; e < count;) {
        const int stop = at < count ? at + 1 : count;
        for (; e < stop; ++e) {
          const int4 nxt = f.lt[(e + 1 == per ? 0 : e + 1) * 32 + lane];
          st = fast_update<kK, kC>(f, cur, t[e], st, f.beta);
          cur = nxt;
        }
        if (stop == at + 1) {
          if (lane < f.n)
            out[lane] = static_cast<signed char>(state_bit(st, lane));
          if (lane + 32 < f.n)
            out[lane + 32] =
                static_cast<signed char>(state_bit(st, lane + 32));
          out += f.n;
          next_sample += f.thin;
          at = next_sample - s0 < r.G
                   ? (next_sample - s0 + 1) * f.n_free - 1
                   : count;
        }
      }
    }
    if (g + 2 < r.groups) arrive_empty(g);
  }
  return st;
}

template <bool kAis, int kK>
__device__ __forceinline__ uint64_t fast_chains_c(
    int C, const FastArgs& f, const GibbsArgs& a, const int4* recs,
    const float* th, uint64_t st, float& logw) {
  switch (C) {
    case 0: return fast_chain<kAis, kK, 0>(f, a, recs, th, st, logw);
    case 1: return fast_chain<kAis, kK, 1>(f, a, recs, th, st, logw);
    case 2: return fast_chain<kAis, kK, 2>(f, a, recs, th, st, logw);
    case 3: return fast_chain<kAis, kK, 3>(f, a, recs, th, st, logw);
    default: return fast_chain<kAis, kK, 4>(f, a, recs, th, st, logw);
  }
}

template <bool kAis>
__device__ __forceinline__ uint64_t fast_chains(
    int K, int C, const FastArgs& f, const GibbsArgs& a, const int4* recs,
    const float* th, uint64_t st, float& logw) {
  switch (K) {
    case 0: return fast_chains_c<kAis, 0>(C, f, a, recs, th, st, logw);
    case 1: return fast_chains_c<kAis, 1>(C, f, a, recs, th, st, logw);
    case 2: return fast_chains_c<kAis, 2>(C, f, a, recs, th, st, logw);
    case 3: return fast_chains_c<kAis, 3>(C, f, a, recs, th, st, logw);
    case 4: return fast_chains_c<kAis, 4>(C, f, a, recs, th, st, logw);
    default: return fast_chains_c<kAis, 5>(C, f, a, recs, th, st, logw);
  }
}

// AIS: the chain's final state into its `out` row and its log-weight.
template <bool kRegState>
__device__ __forceinline__ void ais_finish(const GibbsArgs& a,
                                           signed char* out, int n,
                                           uint64_t st,
                                           const unsigned char* bits,
                                           float logw) {
  const int lane = threadIdx.x & 31;
  for (int v = lane; v < n; v += 32)
    out[v] = static_cast<signed char>(kRegState ? state_bit(st, v) : bits[v]);
  if (lane == 0) a.logw[blockIdx.x] = logw;
}

template <bool kRegState, bool kDeltaShared, bool kAis>
__global__ void __launch_bounds__(64) gibbs_kernel(GibbsArgs a) {
  extern __shared__ float smem[];
  const int c = blockIdx.x;
  const long long* cd = a.chains + 4 * static_cast<long long>(c);
  const int s_idx = static_cast<int>(cd[3] >> 32);
  const int* sd = a.structs + kStructInts * s_idx;
  const int n = sd[0], n_free = sd[1], meta0 = sd[2], zero = sd[3];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const PhiloxKey key = philox_key(a.seed, static_cast<uint32_t>(cd[3]));
  // shared memory: the fast loop's lane table, the two threshold buffers,
  // D where it is in shared memory, the state past the word path
  Ring ring(nullptr, n_free, a.sweeps);
  const int lane_rows =
      kRegState && kDeltaShared && sd[8] ? 32 * ring.G * n_free : 0;
  int4* s_lanes = reinterpret_cast<int4*>(smem);
  ring.base = smem + 4 * lane_rows;
  float* after_ring = ring.base + 2 * ring.G * n_free;
  float* dl = kDeltaShared ? after_ring : a.delta + cd[2];
  unsigned char* s_bits = reinterpret_cast<unsigned char*>(
      after_ring + (kDeltaShared ? zero + 1 : 0));
  for (int i = threadIdx.x; i < lane_rows; i += blockDim.x)
    s_lanes[i] = __ldg(a.lanes + sd[9] + i);
  // AIS on the word path with packed cliques: the clique records in shared
  // memory past the state bytes' place (none on the word path), on a
  // 16-byte boundary
  const int4* recs = a.cliques;
  if constexpr (kAis && kRegState) {
    if (a.packed) {
      int4* s_recs = reinterpret_cast<int4*>(
          (reinterpret_cast<uintptr_t>(s_bits) + 15) & ~uintptr_t{15});
      for (int i = threadIdx.x; i < a.num_cliques; i += blockDim.x)
        s_recs[i] = __ldg(a.cliques + i);
      recs = s_recs;
    }
  }
  build_delta(a, sd, a.thetas + cd[0], dl);
  __syncthreads();

  if (warp == 1) {
    // the producer: group g's thresholds (sweeps g G .. g G + G - 1) into
    // its slot, once the consumer has emptied the group before in it
    for (int g = 0; g < ring.groups; ++g) {
      if (g >= 2) wait_empty(g);
      float* t = ring.slot(g);
      for (int e = lane; e < ring.G * n_free; e += 32) {
        const int j = e / n_free, i = e - j * n_free;
        const int s = g * ring.G + j;
        if (s >= a.sweeps) break;
        const int v = __ldg(&a.meta[meta0 + i].y) & 0xffffff;
        const uint4 w = philox4x32_10(static_cast<uint32_t>(s),
                                      static_cast<uint32_t>(v >> 2), 0u, 0u,
                                      key);
        t[e] = site_threshold(word(w, v & 3) >> 8);
      }
      arrive_full(g);
    }
    return;
  }

  // the consumer: the initial state
  const signed char* ev = sd[4] >= 0 ? a.evidence + sd[4] : nullptr;
  uint64_t st = 0;
  for (int v = lane; v < (kRegState ? 64 : n); v += 32) {
    uint32_t b = 0;
    if (v < n) {
      const uint4 w = philox4x32_10(0u, static_cast<uint32_t>(v >> 2), 1u, 0u,
                                    key);
      const signed char e = ev ? ev[v] : -1;
      b = e >= 0 ? static_cast<uint32_t>(e) : (word(w, v & 3) & 1u);
    }
    if (kRegState) {
      st |= static_cast<uint64_t>(__ballot_sync(kFull, b)) << (v & 32);
    } else {
      s_bits[v] = static_cast<unsigned char>(b);
    }
  }
  if (!kRegState) __syncwarp();

  signed char* out = a.out + cd[1];
  const float* th = a.thetas + cd[0];
  float logw = 0.0f;
  if constexpr (kRegState && kDeltaShared) {
    if (sd[8]) {
      const FastArgs f{s_lanes, ring, dl, out, a.beta, n, n_free,
                       a.sweeps, a.burn, a.thin};
      st = fast_chains<kAis>(sd[8] & 15, (sd[8] >> 4) & 15, f, a, recs,
                             th, st, logw);
      if constexpr (kAis) ais_finish<true>(a, out, n, st, s_bits, logw);
      return;
    }
  }
  int next_sample = a.burn;
  Site cur = n_free ? load_site(a, meta0, lane, zero) : Site{};
  RingCursor thr(ring);
  for (int s = 0; s < a.sweeps; ++s) {
    float scale = a.beta;
    if constexpr (kAis) {
      const int rung = s / a.per_temp;
      if (s == rung * a.per_temp)
        logw = rung_weight<kRegState>(a, recs, th, rung, st, s_bits, logw);
      scale = __ldg(a.sched + rung);
    }
    const float* t = thr.begin();
    for (int i = 0; i < n_free; ++i) {
      const float tv = t[i];
      const Site nxt = load_site(a, meta0 + (i + 1 == n_free ? 0 : i + 1),
                                 lane, zero);
      float acc = item_delta<kRegState, kDeltaShared>(a, cur.rec, st, s_bits,
                                                      dl);
      for (int it = cur.base + 32 + lane; it < cur.base + cur.items;
           it += 32)
        acc = __fadd_rn(acc, item_delta<kRegState, kDeltaShared>(
                                 a, __ldg(a.records + it), st, s_bits, dl));
      acc = butterfly(acc, cur.k);
      const bool bit = __fmul_rn(scale, acc) >= tv;
      if (kRegState) {
        st = bit ? (st | cur.mask) : (st & ~cur.mask);
      } else {
        if (lane == 0) s_bits[cur.v] = bit;
        __syncwarp();
      }
      cur = nxt;
    }
    thr.end();
    if (!kAis && s == next_sample) {
      signed char* row = out + static_cast<long long>(
                                   (s - a.burn) / a.thin) * n;
      for (int v = lane; v < n; v += 32)
        row[v] = static_cast<signed char>(
            kRegState ? state_bit(st, v) : s_bits[v]);
      next_sample += a.thin;
      if (!kRegState) __syncwarp();
    }
  }
  if constexpr (kAis) ais_finish<kRegState>(a, out, n, st, s_bits, logw);
}

// The instantiation, with its dynamic shared memory raised to smem_bytes
// past the default 48 KB.
template <bool kRegState, bool kDeltaShared, bool kAis>
cudaError_t gibbs_instance(int smem_bytes, void (**k)(GibbsArgs)) {
  *k = gibbs_kernel<kRegState, kDeltaShared, kAis>;
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      *k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

template <bool kRegState, bool kDeltaShared, bool kAis>
cudaError_t launch_gibbs(const GibbsArgs& a, int C, int smem_bytes,
                         cudaStream_t stream) {
  void (*k)(GibbsArgs);
  const cudaError_t e =
      gibbs_instance<kRegState, kDeltaShared, kAis>(smem_bytes, &k);
  if (e != cudaSuccess) return e;
  k<<<C, 64, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

__global__ void gibbs_threshold_kernel(int count, float* out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < count) out[k] = site_threshold(static_cast<uint32_t>(k));
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

constexpr int kChase = 256;
constexpr int kSteps = 8;

// The latency of each dependent step of a site update, measured by one warp
// (a probe: it computes nothing the sampler uses). out[k] is the clock64
// cycles of `steps` dependent repeats of step k:
//   0 a shared-memory load (a pointer chase, one address for the warp),
//   1 an __ldg load that hits L1 (a pointer chase over 1 KiB, warmed),
//   2 a shuffle and the addition of its value (a step of the butterfly),
//   3 p1 from delta: the product with beta, expf, the addition, the division
//     (a decision by p1, which the threshold replaces here),
//   4 a bit's round trip: __syncwarp, lane 0's shared store, __syncwarp and
//     the load of the stored value (the state past 64 variables),
//   5 a float32 addition,
//   6 the register state's decision and slot word: the product with beta,
//     the compare with the threshold, the select of the new state word,
//     and the next item's slot word from it (kInline shifts and masks),
//   7 the producer's work for a site: a Philox4x32-10 call and the
//     threshold of one of its words (two float64 logarithms);
// out[8] and out[9] are the clock64 cycles and the %globaltimer nanoseconds
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
  long long t[kSteps + 1];
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
  // the state word starts from the chase's value, the masks and the
  // packed variables from the lane, so that nothing folds at compile time
  uint64_t st = static_cast<uint64_t>(idx) * 0x9E3779B97F4A7C15ull;
  const uint64_t mask = 1ull << (lane + 7);
  const uint32_t packed = (lane + 3) | (lane + 40) << 6 | (lane + 9) << 12 |
                          (lane + 20) << 18;
  const float thr = q * 1e-30f;
  float d = 0.0f;
#pragma unroll 16
  for (int s = 0; s < steps; ++s) {
    st = __fmul_rn(beta, d) >= thr ? (st | mask) : (st & ~mask);
    uint32_t y = 0;
#pragma unroll
    for (int k = 0; k < kInline; ++k)
      y |= state_bit(st, (packed >> (6 * k)) & 63u) << k;
    d = __int_as_float(static_cast<int>(y & 3u));
  }
  t[7] = clock64();
  const PhiloxKey key = philox_key(static_cast<uint32_t>(idx), lane);
  uint32_t c0 = static_cast<uint32_t>(st);
#pragma unroll 1
  for (int s = 0; s < steps; ++s)
    c0 = __float_as_uint(site_threshold(
        philox4x32_10(c0, 1u, 0u, 0u, key).x >> 8));
  t[8] = clock64();
  const uint64_t ns1 = global_ns();
  sink[lane] = idx + static_cast<int>(x + p + q) + __float_as_int(d) +
               static_cast<int>(st) + static_cast<int>(c0);
  if (lane == 0) {
    for (int k = 0; k < kSteps; ++k) out[k] = t[k + 1] - t[k];
    out[kSteps] = t[kSteps] - t[0];
    out[kSteps + 1] = static_cast<long long>(ns1 - ns0);
  }
}

template <bool kAis>
int launch_mode(const GibbsArgs& a, int C, int reg_state, int smem_bytes,
                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (reg_state) {
    e = a.delta ? launch_gibbs<true, false, kAis>(a, C, smem_bytes, s)
                : launch_gibbs<true, true, kAis>(a, C, smem_bytes, s);
  } else {
    e = a.delta ? launch_gibbs<false, false, kAis>(a, C, smem_bytes, s)
                : launch_gibbs<false, true, kAis>(a, C, smem_bytes, s);
  }
  return static_cast<int>(e);
}

// Blocks of the AIS mode's instantiation for (reg_state, D in shared
// memory) that one SM holds at once with smem_bytes of dynamic shared
// memory, as the runtime reports them for this card.
cudaError_t ais_occupancy(int reg_state, int delta_shared, int smem_bytes,
                          int* blocks) {
  void (*k)(GibbsArgs);
  cudaError_t e;
  if (reg_state) {
    e = delta_shared ? gibbs_instance<true, true, true>(smem_bytes, &k)
                     : gibbs_instance<true, false, true>(smem_bytes, &k);
  } else {
    e = delta_shared ? gibbs_instance<false, true, true>(smem_bytes, &k)
                     : gibbs_instance<false, false, true>(smem_bytes, &k);
  }
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, 64,
                                                       smem_bytes);
}

}  // namespace

extern "C" {

int qcmrf_gibbs_latency(const int* chase, int steps, float beta,
                        long long* out, int* sink, void* stream) {
  gibbs_latency_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      chase, steps, beta, out, sink);
  return static_cast<int>(cudaGetLastError());
}

int qcmrf_gibbs_thresholds(int count, float* out, void* stream) {
  gibbs_threshold_kernel<<<(count + 255) / 256, 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(count, out);
  return static_cast<int>(cudaGetLastError());
}

int qcmrf_gibbs(const long long* chains, int C, const int* structs,
                const int* records, const int* lanes, const int* meta,
                const int* others,
                const signed char* evidence, const float* thetas,
                float* delta, signed char* out, float beta, uint32_t seed,
                int sweeps, int burn, int thin, int num_samples,
                int reg_state, int smem_bytes, void* stream) {
  const GibbsArgs a{chains, structs, reinterpret_cast<const int4*>(records),
                    reinterpret_cast<const int4*>(lanes),
                    reinterpret_cast<const int2*>(meta), others, evidence,
                    thetas, delta, out, beta, seed, sweeps, burn, thin,
                    num_samples, nullptr, nullptr, nullptr, 0, 0, 0, 0,
                    nullptr};
  return launch_mode<false>(a, C, reg_state, smem_bytes, stream);
}

// AIS mode: C chains of one structure, no evidence; out (C x n) the final
// states, logw (C) the log-weights; temps rungs of per_temp sweeps; packed
// 1 where every clique record packs its variables (word state only).
int qcmrf_gibbs_ais(const long long* chains, int C, const int* structs,
                    const int* records, const int* lanes, const int* meta,
                    const int* others, const float* thetas, float* delta,
                    signed char* out, const float* sched, const int* cliques,
                    const int* vars, int num_cliques, int packed, int temps,
                    int per_temp, float* logw, uint32_t seed, int reg_state,
                    int smem_bytes, void* stream) {
  const int sweeps = temps * per_temp;
  const GibbsArgs a{chains, structs, reinterpret_cast<const int4*>(records),
                    reinterpret_cast<const int4*>(lanes),
                    reinterpret_cast<const int2*>(meta), others, nullptr,
                    thetas, delta, out, 0.0f, seed, sweeps, sweeps - 1, 1, 1,
                    sched, reinterpret_cast<const int4*>(cliques), vars,
                    num_cliques, packed, temps, per_temp, logw};
  return launch_mode<true>(a, C, reg_state, smem_bytes, stream);
}

// The AIS mode's resident blocks an SM (ais_occupancy) into *blocks; the
// stream is unused.
int qcmrf_gibbs_ais_occupancy(int reg_state, int delta_shared, int smem_bytes,
                              int* blocks, void* stream) {
  (void)stream;
  return static_cast<int>(
      ais_occupancy(reg_state, delta_shared, smem_bytes, blocks));
}

}  // extern "C"
