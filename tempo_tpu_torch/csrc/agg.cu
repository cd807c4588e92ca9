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
// every scan mode, and K4 (which already spills) grows no histogram.
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
// outside [0, K) is not counted anywhere.
//
// Bound on an H100: bytes. K7 reads each score row once (Q*N*4) and the
// keys of the entries some row accepts (N*4 at most), and writes Q*K*4;
// K8 reads n*(4+8) and writes K*4. At the main path's shapes (N = 4.2M
// entries, K = 3,840) that is ~10 us per row of HBM time.
//
// Design: one thread per entry per loop step, four entries in flight a
// thread, neighbouring threads on neighbouring addresses; the loop bound is
// uniform across each warp, so every lane reaches the counting step. There
// each warp groups its lanes by key (__match_any_sync) and one leader adds
// the group's count: 32 entries of one hot bin cost one atomic, not 32.
// When K bins fit in shared memory beside K8's edge table (K <= 12,160:
// 47.5 KB plus 0.5 KB, the 48 KB a CTA gets without opting in; the K of
// up to 256 services, or of 512 ingest series), each CTA counts into its
// own shared histogram and then adds its non-zero bins into the output
// with one global atomic each; past that the atomics go straight to the
// output in global memory. Integer atomics
// are exact in any order, so both routes give the plain version's counts.
// The output is zeroed on the same stream first. K7's rows run on
// gridDim.y; each CTA covers a stride of one row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 4;              // entries a thread loads per step
constexpr int kSharedBins = 12160;     // 47.5 KB of bins: the shared route
constexpr int kMaxThresholds = 64;     // K8's duration edges, at most

// One count for each lane's key into hist (key < 0: none). Every lane of
// the warp must call it together.
__device__ __forceinline__ void warp_count(unsigned* hist, int key) {
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  if (key >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(hist + key, (unsigned)__popc(peers));
}

__device__ __forceinline__ void zero_bins(unsigned* smem, int K) {
  for (int k = threadIdx.x; k < K; k += kThreads) smem[k] = 0;
  __syncthreads();
}

__device__ __forceinline__ void flush_bins(const unsigned* smem, int K,
                                           unsigned* dst) {
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const unsigned c = smem[k];
    if (c) atomicAdd(dst + k, c);
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
agg_rows_kernel(const int32_t* __restrict__ scores,
                const int32_t* __restrict__ keys, int64_t n, int K,
                unsigned* __restrict__ out) {
  extern __shared__ unsigned smem[];
  const int32_t* sc = scores + (int64_t)blockIdx.y * n;
  unsigned* dst = out + (int64_t)blockIdx.y * K;
  unsigned* hist = kShared ? smem : dst;
  if (kShared) zero_bins(smem, K);
  const int64_t step = (int64_t)gridDim.x * kThreads * kItems;
  for (int64_t base = (int64_t)blockIdx.x * kThreads * kItems; base < n;
       base += step) {
    int key[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t i = base + j * kThreads + threadIdx.x;
      key[j] = (i < n && sc[i] >= 0) ? keys[i] : -1;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      warp_count(hist, key[j] < K ? key[j] : -1);
  }
  if (kShared) flush_bins(smem, K, dst);
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
  if (kShared) zero_bins(smem, K);   // also publishes the edges
  else __syncthreads();
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
  if (kShared) flush_bins(smem, K, out);
}

// CTAs along one row: enough for four 512-thread CTAs an SM over all rows,
// never more than the row has steps of work.
unsigned grid_x(int64_t n, int rows, int sm_count) {
  const int64_t tiles = (n + (int64_t)kThreads * kItems - 1) /
                        ((int64_t)kThreads * kItems);
  int64_t g = (4LL * sm_count + rows - 1) / rows;
  if (g > tiles) g = tiles;
  return (unsigned)(g < 1 ? 1 : g);
}

}  // namespace

extern "C" {

// The bin count up to which both kernels count in shared memory.
int tt_agg_shared_bins() { return kSharedBins; }

// scores: int32 [rows, n]; keys: int32 [n]; out: int32 [rows, K], zeroed
// here on the stream before the count. Returns the cudaError_t of the
// launches (0 = launched).
int tt_agg_counts(const void* scores, const void* keys, int rows, int64_t n,
                  int K, void* out, int sm_count, void* stream) {
  if (rows <= 0 || K <= 0) return 0;
  if (rows > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)rows * K * 4, s);
  if (e != cudaSuccess || n <= 0) return (int)e;
  const dim3 grid(grid_x(n, rows, sm_count), rows);
  if (K <= kSharedBins)
    agg_rows_kernel<true><<<grid, kThreads, (size_t)K * 4, s>>>(
        (const int32_t*)scores, (const int32_t*)keys, n, K, (unsigned*)out);
  else
    agg_rows_kernel<false><<<grid, kThreads, 0, s>>>(
        (const int32_t*)scores, (const int32_t*)keys, n, K, (unsigned*)out);
  return (int)cudaGetLastError();
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
  const unsigned g = grid_x(n, 1, sm_count);
  if (K <= kSharedBins)
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
