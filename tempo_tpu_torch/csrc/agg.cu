// K7 agg_counts and K8 analytics_count: dense integer histograms.
//
// K7 replaces tempo_tpu/search/multiblock.py `agg_entry_counts` (the query
// half of TPU kernel B7, fused there into `multi_scan_kernel` and, through
// jax.vmap, into `coalesced_scan_kernel`):
//
//   hist[q][k] = #{ i : scores[q, i] >= 0 && entry_agg[i] == k },  0 <= k < K
//
// for Q score rows [Q, N] as K1, K1s and K4 write them (score >= 0 exactly
// where the final mask, verdicts included, accepts the entry) and the
// batch's staged composite keys entry_agg [N] (search/analytics.py:
// (service, ms bucket, error)). It is a launch of its own after the scan,
// not a stage inside it: one small kernel over the score column serves
// every scan mode.
//
// K8 replaces tempo_tpu/search/analytics.py `analytics_count_kernel` (the
// ingest half of B7):
//
//   b[i]   = #{ t : dur[i] >= T[t] }         (T ascending, int64 ns)
//   key[i] = min(sidx[i] * (nb + 1) + b[i], K)
//   hist[k] = #{ i : key[i] == k },  0 <= k < K
//
// The reference splits durations and thresholds into two int31 limbs (JAX
// runs x32); the card has int64, so K8 compares whole nanoseconds and is
// exact for every duration.
//
// Both count what the reference's sort + searchsorted + diff counts: a key
// outside [0, K) is not counted anywhere. Integer adds are exact in any
// order, so every route gives the plain version's counts.
//
// Bound on an H100: bytes. K7 reads each score row once (Q*N*4) and the
// keys of the entries some row accepts (N*4 at most), and writes Q*K*4;
// K8 reads n*(4+8) and writes K*4. At the main path's shapes (N = 4.2M
// entries, K = 3,840) that is ~10 us per row of HBM time.
//
// K7's design (`agg_kernel`): one cooperative launch a call, no zeroing
// launch, no atomics into global memory while K bins fit a CTA's shared
// memory (K rounded up to kTile, at most kSharedBins = 56,320 bins: 220 KB,
// the opt-in allowance of one CTA an SM; that includes K = 30,720, 1,024
// services).
//   - A persistent grid of one 1,024-thread CTA an SM (no more CTAs than
//     steps of work). The rows' work splits into units: S = G / Q shares
//     of a row (at least 1), each one contiguous run of the row's 16-byte
//     vectors. A thread takes two vectors (8 entries) a step: their
//     scores were loaded one step earlier, and a vector's keys are loaded
//     only where one of its four scores is accepted, so no key load waits
//     on its own score and a selective request (red_svc: 1.6% accepted)
//     reads few key sectors; red_all, which accepts every entry, reads
//     them all.
//   - A row's vectors start at its first 16-byte-aligned score; the
//     entries before it and after the last whole vector are counted one by
//     one, spread over the row's units. A score row whose address differs
//     from the keys' modulo 16 (a row view at an odd offset) is counted
//     one by one whole.
//   - Each unit counts into its CTA's histogram in shared memory (one
//     shared atomicAdd per accepted entry: on this card that costs the
//     same on one hot bin as on keys spread over every bin, and
//     __match_any_sync first made red_all's count 3x slower) and writes
//     it as one row of partials [units, Kp] with coalesced 16-byte stores.
//     After one grid barrier the grid sums each row's partials by column,
//     a tile of 128 bins a CTA at a time: lane l of every warp adds bins
//     4l..4l+3 of its partial rows (16-byte loads, 512 contiguous bytes a
//     warp), and the 32 warps' sums meet in the histogram's shared memory.
//     `out` is written exactly once. The partials live in the output's
//     own allocation (the wrapper's), so concurrent calls share no
//     scratch.
//   - Past kSharedBins the same grid zeroes `out` itself, crosses one grid
//     barrier, and adds each accepted entry into `out` with a global atomic
//     (the global route).
// Why: short CTAs that each zero and flush all K bins cost as many global
// atomics as the count has entries, and those on one bin serialize at L2;
// a zeroing memset is a second operation on the stream; 4-byte loads with
// a key waiting on its score leave the stream latency-bound; and grouping
// a warp's keys with __match_any_sync saves nothing when neighbouring
// entries belong to different services.
//
// K8's design (`count_kernel`): one cooperative launch a call, no memset,
// `out` written exactly once. Its bound at the ingest count's main shape
// (1,048,576 rows, K = 61,440) is 12.6 MB read and 0.25 MB written:
// 3.8 us of HBM time, below the ~5.5 us a cooperative grid takes to
// launch and retire empty, so launch and barriers, not bytes, set its
// pace there.
//   - The thresholds (at most 64) and nb ride in the launch's parameter
//     struct (`__grid_constant__`): a warp reads each with one uniform
//     constant-bank load, four entries against it at a time (the linear
//     walk; a binary search would read the bank at divergent indices).
//   - A persistent grid of 1,024-thread CTAs, one an SM. Each CTA takes a
//     contiguous share of the rows' 16-byte vectors: four series ids in
//     one int4 and their four durations in two longlong2, from the first
//     element at which both columns are 16-byte aligned, the next vectors
//     loaded before the current ones are counted. The entries before it
//     and after the last whole vector are counted one by one, spread over
//     the CTAs; columns whose addresses can never be aligned together (a
//     series id view whose phase the durations cannot match) are counted
//     one by one whole.
//   - The CTA route, up to kCtaBins = 36,864 bins (K rounded up to
//     kTile): each CTA counts into its own histogram in shared memory and
//     writes it as one row of partials [CTAs, Kp] with 16-byte stores;
//     after one grid barrier the grid sums the rows by column and writes
//     `out` once (K7's tiles, `column_sums`; up to 64 rows in one pass, a
//     lane a row slice of 4 bins, `column_sums_few`). The partials live
//     in the output's allocation (the wrapper's), after the counts.
//   - Past kCtaBins, the global route: the grid zeroes `out` itself,
//     crosses one grid barrier and adds each entry into `out` with a
//     global atomic.
//   - A warp whose 128 entries share one bin adds once (a vote and a
//     shuffle), and four entries of one bin add once: one hot bin costs
//     less than keys spread over every bin.
// The limit is measured (bench_agg.py, device ms over 1,048,576 rows,
// H100 80GB HBM3 at 700 W; PERF.md §6): one CTA's histogram beats the
// global route at K = 15,360 (0.0153 against 0.0236) and 30,720 (0.0196
// against 0.0234) and still at its limit (K = 36,855: 0.0222-0.0226
// against 0.0239-0.0240 at 36,870); past it the CTAs' partial rows of K
// bins cost the column sum more than the atomics into L2 cost the count,
// and at K = 61,440 the global route takes 0.0216-0.0227.
// Tried and dropped: one histogram a thread-block cluster in distributed
// shared memory, each CTA owning a slice and an entry one atomic into its
// owner's (`map_shared_rank`), clusters of 2, 4 and 8 (bench_agg.py's
// "a cluster of C" variants): a remote add costs more than a local one, so
// every cluster lost to one CTA while K fits it and to the global route
// past that (K = 61,440: C = 2 / 4 / 8 0.0261 / 0.0250 / 0.0253; C = 2
// adding into its own CTA instead, 0.0234).
// Why: the first K8 zeroed `out` with a memset (a second operation on
// the stream), counted K = 61,440 with a global atomic per entry behind
// __match_any_sync grouping (3x slower for K7 when neighbours differ, as
// (service, operation, bucket) keys do), stopped its shared route at 48
// KB without the opt-in allowance, loaded 4 and 8 bytes a thread, and
// read its thresholds from device memory in every CTA.

#include <atomic>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kAggThreads = 1024;      // K7 and K8: one CTA an SM
constexpr int kAggWarps = kAggThreads / 32;
constexpr int kSumBytes = kAggWarps * 32 * 16;   // the column sums' smem
constexpr int kTile = 128;             // bins: a column tile, the pitch's unit
constexpr int kSharedBins = 56320;     // a CTA's bins at most: 220 KB
constexpr int kMaxDevices = 64;

constexpr int kMaxThresholds = 64;     // K8's duration edges, at most
constexpr int kCtaBins = 36864;        // K8's CTA route: up to this pitch

struct AggArgs {
  const int32_t* scores;   // [rows, n]
  const int32_t* keys;     // [n]
  int32_t* out;            // [rows, K]
  unsigned* partials;      // [units, Kp] (shared route)
  int64_t n;
  int rows, K, Kp, per_row;  // per_row: units (shares) a row
};

struct CountArgs {
  const int32_t* sidx;     // [n]
  const int64_t* dur;      // [n]
  int32_t* out;            // [K]
  unsigned* partials;      // [CTAs, Kp] (CTA route)
  int64_t n;
  int K, Kp, nb;
  long long thr[kMaxThresholds];   // ascending; the first nb are used
};

// Adds a thread's accepted keys (key < 0: none) into hist, one shared
// (or, on the global route, global) atomic each.
template <int kN>
__device__ __forceinline__ void count_keys(unsigned* hist,
                                           const int (&key)[kN]) {
#pragma unroll
  for (int j = 0; j < kN; ++j)
    if (key[j] >= 0) atomicAdd(hist + key[j], 1u);
}

__device__ __forceinline__ int kept(int score, int key, unsigned K) {
  return (score >= 0 && (unsigned)key < K) ? key : -1;
}

// The counts of `rows` output rows [rows, K] from their partial rows
// [rows * S, Kp] (row q's S first), a tile of kTile bins a CTA at a time:
// lane l of warp w adds bins 4l..4l+3 of partial rows w, w + 32, ..., the
// warps' sums meet in `smem` (kSumBytes, free by now), and kTile threads
// add them and write each count once.
__device__ __forceinline__ void column_sums(const unsigned* partials,
                                            int rows, int S, int Kp, int K,
                                            int32_t* out, unsigned* smem) {
  uint4* red = reinterpret_cast<uint4*>(smem);      // [kAggWarps][32]
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int per_q = Kp / kTile;
  const int tiles = rows * per_q;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int q = tile / per_q;
    const int c0 = (tile - q * per_q) * kTile;
    const uint4* base = reinterpret_cast<const uint4*>(
        partials + (int64_t)q * S * Kp + c0) + lane;
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 4
    for (int r = warp; r < S; r += kAggWarps) {
      const uint4 v = __ldcg(base + (int64_t)r * (Kp / 4));
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    red[warp * 32 + lane] = acc;
    __syncthreads();
    if (t < kTile) {
      const unsigned* col = reinterpret_cast<const unsigned*>(red) + t;
      unsigned sum = 0;
#pragma unroll 8
      for (int w = 0; w < kAggWarps; ++w) sum += col[w * kTile];
      if (c0 + t < K) out[(int64_t)q * K + c0 + t] = (int32_t)sum;
    }
    __syncthreads();
  }
}

// The counts [K] from S <= kFewRows partial rows [S, Kp] in one pass: a
// warp takes 8 column groups of 4 bins and its lanes 4 row slices (lane
// = slice * 8 + group), so 8 lanes read 128 contiguous bytes of a row;
// each lane adds its rows (S / 4 loads in flight), the slices meet by
// shuffle, and the first slice's lanes write their 4 counts.
constexpr int kFewRows = 64;

__device__ __forceinline__ void column_sums_few(const unsigned* partials,
                                                int S, int Kp, int K,
                                                int32_t* out) {
  const int lane = threadIdx.x & 31;
  const int slice = lane >> 3, group = lane & 7;
  const int64_t warps = (int64_t)gridDim.x * kAggWarps;
  for (int64_t w = (int64_t)blockIdx.x * kAggWarps + (threadIdx.x >> 5);
       w < Kp / 32; w += warps) {
    const int64_t c = w * 32 + group * 4;          // the group's first bin
    const uint4* col = reinterpret_cast<const uint4*>(partials + c);
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 4
    for (int r = slice; r < S; r += 4) {
      const uint4 v = __ldcg(col + (int64_t)r * (Kp / 4));
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
#pragma unroll
    for (int m = 8; m < 32; m <<= 1) {
      acc.x += __shfl_xor_sync(0xffffffffu, acc.x, m);
      acc.y += __shfl_xor_sync(0xffffffffu, acc.y, m);
      acc.z += __shfl_xor_sync(0xffffffffu, acc.z, m);
      acc.w += __shfl_xor_sync(0xffffffffu, acc.w, m);
    }
    if (slice == 0) {
      if (c + 4 <= K) {
        reinterpret_cast<int4*>(out)[c / 4] =
            make_int4((int)acc.x, (int)acc.y, (int)acc.z, (int)acc.w);
      } else {
        const unsigned v[4] = {acc.x, acc.y, acc.z, acc.w};
        for (int j = 0; j < 4 && c + j < K; ++j) out[c + j] = (int32_t)v[j];
      }
    }
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kAggThreads, 1)
agg_kernel(const AggArgs a) {
  extern __shared__ __align__(16) unsigned hist[];
  const int t = threadIdx.x;
  const unsigned K = (unsigned)a.K;
  const int S = a.per_row;
  const int units = a.rows * S;
  if (!kShared) {
    const int64_t total = (int64_t)a.rows * a.K;
    for (int64_t i = (int64_t)blockIdx.x * kAggThreads + t; i < total;
         i += (int64_t)gridDim.x * kAggThreads)
      a.out[i] = 0;
    cg::this_grid().sync();
  }
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int q = u / S, s = u - q * S;
    unsigned* h = kShared ? hist : (unsigned*)a.out + (int64_t)q * a.K;
    if (kShared) {
      for (int i = t; i < a.Kp / 4; i += kAggThreads)
        reinterpret_cast<uint4*>(hist)[i] = make_uint4(0u, 0u, 0u, 0u);
      __syncthreads();
    }
    const int32_t* sc = a.scores + (int64_t)q * a.n;
    const uintptr_t addr = (uintptr_t)sc;
    int64_t head = (int64_t)((16 - (addr & 15)) & 15) / 4;
    if (((addr ^ (uintptr_t)a.keys) & 15) != 0 || head > a.n) head = a.n;
    const int64_t nv = (a.n - head) >> 2;
    const int64_t lo = nv * s / S, hi = nv * (s + 1) / S;
    const int4* s4 = reinterpret_cast<const int4*>(sc + head);
    const int4* k4 = reinterpret_cast<const int4*>(a.keys + head);
    // vectors v0 and v0 + T a step; their scores were loaded a step
    // earlier, so a key vector's load (only where one of its 4 scores is
    // accepted: every 16-byte word of 4 scores ANDs to a negative number
    // exactly when all 4 are) waits on no score load of its own step
    const int64_t T = kAggThreads;
    const int4 none = make_int4(-1, -1, -1, -1);
    int64_t v0 = lo + t;
    int4 sa = v0 < hi ? __ldg(s4 + v0) : none;
    int4 sb = v0 + T < hi ? __ldg(s4 + v0 + T) : none;
    for (; v0 < hi; v0 += 2 * T) {
      const int64_t v1 = v0 + T;
      int4 ka = none, kb = none;
      if ((sa.x & sa.y & sa.z & sa.w) >= 0) ka = __ldg(k4 + v0);
      if ((sb.x & sb.y & sb.z & sb.w) >= 0) kb = __ldg(k4 + v1);
      const int4 na = v0 + 2 * T < hi ? __ldg(s4 + v0 + 2 * T) : none;
      const int4 nb = v1 + 2 * T < hi ? __ldg(s4 + v1 + 2 * T) : none;
      const int key[8] = {kept(sa.x, ka.x, K), kept(sa.y, ka.y, K),
                          kept(sa.z, ka.z, K), kept(sa.w, ka.w, K),
                          kept(sb.x, kb.x, K), kept(sb.y, kb.y, K),
                          kept(sb.z, kb.z, K), kept(sb.w, kb.w, K)};
      count_keys(h, key);
      sa = na;
      sb = nb;
    }
    // the head and the tail, one entry a thread
    const int64_t tail = head + 4 * nv;
    const int64_t n_one = head + (a.n - tail);
    for (int64_t j0 = (int64_t)s * kAggThreads; j0 < n_one;
         j0 += (int64_t)S * kAggThreads) {
      const int64_t j = j0 + t;
      int key[1] = {-1};
      if (j < n_one) {
        const int64_t e = j < head ? j : tail + (j - head);
        key[0] = kept(sc[e], a.keys[e], K);
      }
      count_keys(h, key);
    }
    if (kShared) {
      __syncthreads();
      uint4* dst = reinterpret_cast<uint4*>(a.partials + (int64_t)u * a.Kp);
      for (int i = t; i < a.Kp / 4; i += kAggThreads)
        dst[i] = reinterpret_cast<const uint4*>(hist)[i];
      __syncthreads();   // before the next unit zeroes the bins
    }
  }
  if (!kShared) return;
  cg::this_grid().sync();
  column_sums(a.partials, a.rows, S, a.Kp, a.K, a.out, hist);
}

// K8's routes: one CTA's shared memory, or the grid's atomics into `out`.
constexpr int kRouteGlobal = 0, kRouteCta = 1;

// `v` counts into bin k (< K): the CTA's histogram, or `out` on the
// global route.
template <int kRoute>
__device__ __forceinline__ void add_key(unsigned* hist, const CountArgs& a,
                                        unsigned k, unsigned v) {
  atomicAdd((kRoute == kRouteGlobal ? (unsigned*)a.out : hist) + k, v);
}

// Four entries' keys: their buckets by the thresholds in the parameter
// bank (one uniform load a threshold for all four), and whether each key
// lies in [0, K) (`ok`).
__device__ __forceinline__ void keys4(const CountArgs& a,
                                      const int (&sidx)[4],
                                      const long long (&dur)[4],
                                      unsigned (&key)[4], bool (&ok)[4]) {
  int b[4] = {0, 0, 0, 0};
  for (int i = 0; i < a.nb; ++i) {
    const long long edge = a.thr[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] += dur[j] >= edge;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long k = (long long)sidx[j] * (a.nb + 1) + b[j];
    ok[j] = (unsigned long long)k < (unsigned long long)a.K;
    key[j] = (unsigned)k;
  }
}

// Four entries counted straight into their bins: one add each whose key
// lies in [0, K), one add where all four share a bin and, where the whole
// warp's do (a hot series), one add for the warp (a vote and a shuffle,
// not __match_any_sync's grouping).
template <int kRoute>
__device__ __forceinline__ void count4(unsigned* hist, const CountArgs& a,
                                       const int (&sidx)[4],
                                       const long long (&dur)[4]) {
  unsigned key[4];
  bool ok[4];
  keys4(a, sidx, dur, key, ok);
  const bool same = ok[0] && key[1] == key[0] && key[2] == key[0] &&
                    key[3] == key[0];
  const unsigned act = __activemask();
  const int lead = __ffs(act) - 1;
  const unsigned k0 = __shfl_sync(act, key[0], lead);
  if (__all_sync(act, same && key[0] == k0)) {
    if ((int)(threadIdx.x & 31) == lead)
      add_key<kRoute>(hist, a, k0, 4u * __popc(act));
  } else if (same) {
    add_key<kRoute>(hist, a, key[0], 4u);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (ok[j]) add_key<kRoute>(hist, a, key[j], 1u);
  }
}

template <int kRoute>
__global__ void __launch_bounds__(kAggThreads, 1)
count_kernel(const __grid_constant__ CountArgs a) {
  extern __shared__ __align__(16) unsigned hist[];
  const int t = threadIdx.x;
  const int g = blockIdx.x, G = gridDim.x;
  if (kRoute == kRouteCta) {
    for (int i = t; i < a.Kp / 4; i += kAggThreads)
      reinterpret_cast<uint4*>(hist)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();              // every bin zeroed before any add
  } else {
    for (int64_t i = (int64_t)g * kAggThreads + t; i < a.K;
         i += (int64_t)G * kAggThreads)
      a.out[i] = 0;
    cg::this_grid().sync();
  }
  // the vectors: from the first element where both columns are 16-byte
  // aligned (series ids at 4 bytes, durations at 8: a head of 0-3
  // entries, or none that fits both, and then every entry one by one)
  const uintptr_t as = (uintptr_t)a.sidx, ad = (uintptr_t)a.dur;
  int64_t head = (int64_t)((16 - (as & 15)) & 15) / 4;
  if (((ad + 8 * head) & 15) != 0 || head > a.n) head = a.n;
  const int64_t nv = (a.n - head) >> 2;
  const int64_t lo = nv * g / G, hi = nv * (g + 1) / G;
  const int4* s4 = reinterpret_cast<const int4*>(a.sidx + head);
  const longlong2* d2 = reinterpret_cast<const longlong2*>(a.dur + head);
  int64_t v = lo + t;
  int4 s = make_int4(0, 0, 0, 0);
  longlong2 d0 = make_longlong2(0, 0), d1 = d0;
  if (v < hi) {
    s = __ldg(s4 + v);
    d0 = __ldg(d2 + 2 * v);
    d1 = __ldg(d2 + 2 * v + 1);
  }
  for (; v < hi; v += kAggThreads) {
    const int64_t w = v + kAggThreads;
    int4 ns = s;
    longlong2 n0 = d0, n1 = d1;
    if (w < hi) {      // the next vectors, in flight while these count
      ns = __ldg(s4 + w);
      n0 = __ldg(d2 + 2 * w);
      n1 = __ldg(d2 + 2 * w + 1);
    }
    const int si[4] = {s.x, s.y, s.z, s.w};
    const long long du[4] = {d0.x, d0.y, d1.x, d1.y};
    count4<kRoute>(hist, a, si, du);
    s = ns;
    d0 = n0;
    d1 = n1;
  }
  // the head and the tail, one entry a thread (lanes 1-3 of the four
  // count nothing: a key past K is never counted)
  const int64_t tail = head + 4 * nv;
  const int64_t n_one = head + (a.n - tail);
  for (int64_t j = (int64_t)g * kAggThreads + t; j < n_one;
       j += (int64_t)G * kAggThreads) {
    const int64_t e = j < head ? j : tail + (j - head);
    const int si[4] = {a.sidx[e], -1, -1, -1};
    const long long du[4] = {a.dur[e], 0, 0, 0};
    count4<kRoute>(hist, a, si, du);
  }
  if (kRoute == kRouteGlobal) return;
  __syncthreads();                // every add has landed
  uint4* dst = reinterpret_cast<uint4*>(a.partials + (int64_t)g * a.Kp);
  for (int i = t; i < a.Kp / 4; i += kAggThreads)
    dst[i] = reinterpret_cast<const uint4*>(hist)[i];
  cg::this_grid().sync();         // every partial row written
  if (G <= kFewRows)
    column_sums_few(a.partials, G, a.Kp, a.K, a.out);
  else
    column_sums(a.partials, 1, G, a.Kp, a.K, a.out, hist);
}

int64_t round_up(int64_t x, int64_t m) { return (x + m - 1) / m * m; }

// The ints of K7's output buffer: rows * K counts, then on the shared
// route (rounded to 16 bytes) the partials of at most max(rows, sms) units.
int64_t agg_out_ints(int rows, int K, int sms) {
  const int64_t kp = round_up(K, kTile);
  const int64_t counts = (int64_t)rows * K;
  if (kp > kSharedBins) return counts;
  return round_up(counts, 4) + (rows > sms ? rows : sms) * kp;
}

// K8's route for K bins: one CTA's shared memory while K rounded up to
// kTile is at most kCtaBins, else global atomics.
int count_route(int K) {
  return round_up(K, kTile) <= kCtaBins ? kRouteCta : kRouteGlobal;
}

// The ints of K8's output buffer: K counts, then on the CTA route (from a
// 16-byte boundary) the partial rows of at most `sms` CTAs.
int64_t count_out_ints(int K, int sms) {
  if (count_route(K) == kRouteGlobal) return K;
  return round_up(K, 4) + (int64_t)sms * round_up(K, kTile);
}

// Per device: the SM count, once the kernel's shared-memory allowance is
// set (once, to the most any call asks: never per call, since other host
// threads launch the same kernel) and one CTA an SM is known to fit.
template <typename Kern>
int agg_setup(Kern kern, std::atomic<int>* ready, int* sms) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const int known = ready[dev].load(std::memory_order_acquire);
  if (known > 0) {
    *sms = known;
    return 0;
  }
  rc = cudaFuncSetAttribute((const void*)kern,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            kSharedBins * 4);
  int per_sm = 0, count = 0;
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, kAggThreads, (size_t)kSharedBins * 4);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return (int)rc;
  if (per_sm < 1 || count < 1) return (int)cudaErrorInvalidConfiguration;
  ready[dev].store(count, std::memory_order_release);
  *sms = count;
  return 0;
}

int agg_launch(const void* scores, const void* keys, int rows, int64_t n,
               int K, void* out, int64_t out_ints, cudaStream_t s) {
  static std::atomic<int> ready_shared[kMaxDevices];
  static std::atomic<int> ready_global[kMaxDevices];
  const int64_t kp = round_up(K, kTile);
  const bool shared = kp <= kSharedBins;
  int sms = 0;
  const int rc = shared
      ? agg_setup(agg_kernel<true>, ready_shared, &sms)
      : agg_setup(agg_kernel<false>, ready_global, &sms);
  if (rc != 0) return rc;
  if (out_ints < agg_out_ints(rows, K, sms))
    return (int)cudaErrorInvalidValue;
  // one CTA an SM, no more than the rows have steps of 8 entries a thread
  const int64_t steps = (n + 8LL * kAggThreads - 1) / (8LL * kAggThreads);
  int64_t grid = (int64_t)rows * (steps < 1 ? 1 : steps);
  if (grid > sms) grid = sms;
  AggArgs a;
  a.scores = (const int32_t*)scores;
  a.keys = (const int32_t*)keys;
  a.out = (int32_t*)out;
  a.partials = (unsigned*)out + round_up((int64_t)rows * K, 4);
  a.n = n;
  a.rows = rows;
  a.K = K;
  a.Kp = (int)kp;
  a.per_row = grid >= rows ? (int)(grid / rows) : 1;
  void* args[] = {(void*)&a};
  if (shared)
    return (int)cudaLaunchCooperativeKernel(
        (const void*)agg_kernel<true>, dim3((unsigned)grid),
        dim3(kAggThreads), args,
        (size_t)(kp * 4 > kSumBytes ? kp * 4 : kSumBytes), s);
  return (int)cudaLaunchCooperativeKernel(
      (const void*)agg_kernel<false>, dim3((unsigned)grid),
      dim3(kAggThreads), args, 0, s);
}

int count_launch(const int32_t* sidx, const int64_t* dur, int64_t n,
                 const int64_t* thr, int nb, int K, int32_t* out,
                 int64_t out_ints, cudaStream_t s) {
  static std::atomic<int> ready_cta[kMaxDevices];
  static std::atomic<int> ready_global[kMaxDevices];
  const int route = count_route(K);
  int sms = 0;
  const int rc = route == kRouteCta
      ? agg_setup(count_kernel<kRouteCta>, ready_cta, &sms)
      : agg_setup(count_kernel<kRouteGlobal>, ready_global, &sms);
  if (rc != 0) return rc;
  if (out_ints < count_out_ints(K, sms)) return (int)cudaErrorInvalidValue;
  CountArgs a;
  a.sidx = sidx;
  a.dur = dur;
  a.out = out;
  a.n = n;
  a.K = K;
  a.nb = nb;
  for (int i = 0; i < kMaxThresholds; ++i) a.thr[i] = i < nb ? thr[i] : 0;
  // CTAs: no more than the entries have steps of four a thread
  const int64_t steps = (n + 4LL * kAggThreads - 1) / (4LL * kAggThreads);
  int64_t want = steps < 1 ? 1 : steps;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kAggThreads);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (route == kRouteCta) {
    const int64_t kp = round_up(K, kTile);
    a.Kp = (int)kp;
    a.partials = (unsigned*)out + round_up(K, 4);
    if (want > sms) want = sms;
    cfg.dynamicSmemBytes = (size_t)(kp * 4 > kSumBytes ? kp * 4 : kSumBytes);
  } else {
    // the global route: enough CTAs to zero `out` quickly too
    a.Kp = 0;
    a.partials = nullptr;
    const int64_t zero = ((int64_t)K + 4LL * kAggThreads - 1) /
                         (4LL * kAggThreads);
    if (want < zero) want = zero;
    if (want > sms) want = sms;
    cfg.dynamicSmemBytes = 0;
  }
  cfg.gridDim = dim3((unsigned)want);
  if (route == kRouteCta)
    return (int)cudaLaunchKernelEx(&cfg, count_kernel<kRouteCta>, a);
  return (int)cudaLaunchKernelEx(&cfg, count_kernel<kRouteGlobal>, a);
}

}  // namespace

extern "C" {

// The bin count (K rounded up to kTile) up to which K7 counts in shared
// memory: also the most bins one K8 CTA holds.
int tt_agg_shared_bins() { return kSharedBins; }

// The int32 elements K7's `out` must hold for `rows` rows of K bins on a
// card of `sms` SMs.
int64_t tt_agg_out_ints(int rows, int K, int sms) {
  return agg_out_ints(rows, K, sms);
}

// The bin count (K rounded up to kTile) up to which K8 counts in one
// CTA's shared memory, and the int32 elements its `out` must hold for K
// bins on a card of `sms` SMs.
int tt_count_cta_bins() { return kCtaBins; }
int64_t tt_count_out_ints(int K, int sms) { return count_out_ints(K, sms); }

// K7. scores: int32 [rows, n]; keys: int32 [n]; out: int32 [out_ints] of
// at least tt_agg_out_ints(rows, K, SMs): the counts [rows, K] first, the
// kernel's partials after them. One launch, nothing else on the stream.
// Returns the cudaError_t of the launch (0 = launched).
int tt_agg_counts(const void* scores, const void* keys, int rows, int64_t n,
                  int K, void* out, int64_t out_ints, void* stream) {
  if (rows <= 0) return 0;
  if (K <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  return agg_launch(scores, keys, rows, n, K, out, out_ints,
                    (cudaStream_t)stream);
}

// K8. sidx: int32 [n]; dur: int64 [n]; thr: int64 [nb] in HOST memory,
// ascending (copied into the launch's parameters); out: int32 [out_ints]
// of at least tt_count_out_ints(K, SMs): the counts [K] first, the
// kernel's partials after them. One launch, nothing else on the stream.
// Returns the cudaError_t of the launch (0 = launched).
int tt_analytics_count(const void* sidx, const void* dur, int64_t n,
                       const void* thr, int nb, int K, void* out,
                       int64_t out_ints, void* stream) {
  if (K <= 0 || n < 0 || nb < 0 || nb > kMaxThresholds ||
      (nb > 0 && thr == nullptr))
    return (int)cudaErrorInvalidValue;
  return count_launch((const int32_t*)sidx, (const int64_t*)dur, n,
                      (const int64_t*)thr, nb, K, (int32_t*)out, out_ints,
                      (cudaStream_t)stream);
}

const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
