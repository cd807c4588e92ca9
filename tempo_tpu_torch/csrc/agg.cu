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
// K8 (`count_kernel`) keeps its first design: one thread per entry per
// loop step, four entries in flight a thread; each warp groups its lanes
// by key (__match_any_sync) and one leader adds the group's count. Up to
// kCountSharedBins bins (48 KB without opting in) each CTA counts in
// shared memory and adds its non-zero bins into the output, zeroed on the
// stream first; past that the atomics go straight to the output.

#include <atomic>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kAggThreads = 1024;      // K7: one CTA an SM
constexpr int kAggWarps = kAggThreads / 32;
constexpr int kSumBytes = kAggWarps * 32 * 16;   // the column sums' smem
constexpr int kTile = 128;             // bins: a column tile, the pitch's unit
constexpr int kSharedBins = 56320;     // K7's shared route: 220 KB of bins
constexpr int kMaxDevices = 64;

constexpr int kThreads = 512;          // K8
constexpr int kItems = 4;              // entries a K8 thread loads a step
constexpr int kCountSharedBins = 12160;  // K8: 47.5 KB of bins
constexpr int kMaxThresholds = 64;     // K8's duration edges, at most

struct AggArgs {
  const int32_t* scores;   // [rows, n]
  const int32_t* keys;     // [n]
  int32_t* out;            // [rows, K]
  unsigned* partials;      // [units, Kp] (shared route)
  int64_t n;
  int rows, K, Kp, per_row;  // per_row: units (shares) a row
};

// One count for each lane's key into hist (key < 0: none). Every lane of
// the warp must call it together.
__device__ __forceinline__ void warp_count(unsigned* hist, int key) {
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  if (key >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(hist + key, (unsigned)__popc(peers));
}

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
  // column sums, a tile of kTile bins at a time: lane l of warp w adds
  // bins 4l..4l+3 of partial rows w, w + 32, ..., the warps' sums meet in
  // the (now free) histogram's shared memory, and kTile threads add them
  uint4* red = reinterpret_cast<uint4*>(hist);      // [kAggWarps][32]
  const int lane = t & 31, warp = t >> 5;
  const int per_q = a.Kp / kTile;
  const int tiles = a.rows * per_q;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int q = tile / per_q;
    const int c0 = (tile - q * per_q) * kTile;
    const uint4* base = reinterpret_cast<const uint4*>(
        a.partials + (int64_t)q * S * a.Kp + c0) + lane;
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 4
    for (int r = warp; r < S; r += kAggWarps) {
      const uint4 v = __ldcg(base + (int64_t)r * (a.Kp / 4));
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
      if (c0 + t < a.K) a.out[(int64_t)q * a.K + c0 + t] = (int32_t)sum;
    }
    __syncthreads();
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
count_kernel(const int32_t* __restrict__ sidx,
             const int64_t* __restrict__ dur, int64_t n,
             const int64_t* __restrict__ thr, int nb, int K,
             unsigned* __restrict__ out) {
  extern __shared__ unsigned smem[];
  __shared__ long long edges[kMaxThresholds];
  for (int t = threadIdx.x; t < nb; t += kThreads) edges[t] = thr[t];
  unsigned* hist = kShared ? smem : out;
  if (kShared)
    for (int k = threadIdx.x; k < K; k += kThreads) smem[k] = 0;
  __syncthreads();   // publishes the edges (and the zeroed bins)
  const int64_t step = (int64_t)gridDim.x * kThreads * kItems;
  for (int64_t base = (int64_t)blockIdx.x * kThreads * kItems; base < n;
       base += step) {
    int key[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t i = base + j * kThreads + threadIdx.x;
      key[j] = -1;
      if (i < n) {
        const long long d = dur[i];
        int b = 0;
        for (int t = 0; t < nb; ++t) b += d >= edges[t];
        const long long k = (long long)sidx[i] * (nb + 1) + b;
        if (k >= 0 && k < K) key[j] = (int)k;
      }
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) warp_count(hist, key[j]);
  }
  if (kShared) {
    __syncthreads();
    for (int k = threadIdx.x; k < K; k += kThreads) {
      const unsigned c = smem[k];
      if (c) atomicAdd(out + k, c);
    }
  }
}

// K8's CTAs: enough for four 512-thread CTAs an SM, never more than the
// entries have steps of work.
unsigned count_grid(int64_t n, int sm_count) {
  const int64_t tiles = (n + (int64_t)kThreads * kItems - 1) /
                        ((int64_t)kThreads * kItems);
  int64_t g = 4LL * sm_count;
  if (g > tiles) g = tiles;
  return (unsigned)(g < 1 ? 1 : g);
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

}  // namespace

extern "C" {

// The bin count (K rounded up to kTile) up to which K7 counts in shared
// memory, and K8's.
int tt_agg_shared_bins() { return kSharedBins; }
int tt_count_shared_bins() { return kCountSharedBins; }

// The int32 elements K7's `out` must hold for `rows` rows of K bins on a
// card of `sms` SMs.
int64_t tt_agg_out_ints(int rows, int K, int sms) {
  return agg_out_ints(rows, K, sms);
}

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

// sidx: int32 [n]; dur: int64 [n]; thr: int64 [nb], ascending; out: int32
// [K], zeroed here. Returns the cudaError_t of the launches.
int tt_analytics_count(const void* sidx, const void* dur, int64_t n,
                       const void* thr, int nb, int K, void* out,
                       int sm_count, void* stream) {
  if (K <= 0) return 0;
  if (nb < 0 || nb > kMaxThresholds) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)K * 4, s);
  if (e != cudaSuccess || n <= 0) return (int)e;
  const unsigned g = count_grid(n, sm_count);
  if (K <= kCountSharedBins)
    count_kernel<true><<<g, kThreads, (size_t)K * 4, s>>>(
        (const int32_t*)sidx, (const int64_t*)dur, n,
        (const int64_t*)thr, nb, K, (unsigned*)out);
  else
    count_kernel<false><<<g, kThreads, 0, s>>>(
        (const int32_t*)sidx, (const int64_t*)dur, n,
        (const int64_t*)thr, nb, K, (unsigned*)out);
  return (int)cudaGetLastError();
}

const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
