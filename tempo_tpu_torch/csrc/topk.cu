// K2 topk and K2r topk_rows: the k most recent matches of a score column,
// or of each row of Q score columns.
//
// K2 replaces tempo_tpu/search/engine.py `masked_topk` (TPU kernel B2);
// K2r is the same function lifted over a query axis, as the `jax.vmap` at
// tempo_tpu/search/multiblock.py:1084 lifts it inside
// `coalesced_scan_kernel` (B6). From int32 scores [Q, N] (the start
// second of a match, -1 for a non-match, as K1 and K4 write them) return,
// per row, the k_eff = min(k, N) best (score [Q, k_eff], flat index within
// the row [Q, k_eff]), highest score first and, among equal scores,
// lowest index first -- the order lax.top_k gives. K2 is the case Q = 1.
// k has no upper cap: a request limit of L asks for the next power of two
// at or above max(128, L).
//
// Every element gets a unique 63-bit key that sorts ascending in that
// order:  key = (0x7FFFFFFF - score) << 31 | index   (score >= -1, N < 2^31).
// 1. Radix select (passes of 11 bits from bit 62 down): each pass builds a
//    2048-bin histogram per row of the keys that share the prefix resolved
//    so far (warp-aggregated shared-memory atomics, then one global atomic
//    per bin and block); one block per row scans it and fixes the next
//    digit of the row's k_eff-th smallest key. A pass whose bin holds
//    exactly the keys still needed resolves the row's threshold, and every
//    later pass returns at once for that row. The state lives on the
//    device, so no pass waits for the host.
// 2. Gather: every key <= its row's threshold (exactly k_eff of them, keys
//    being unique) is appended to the row's scratch array with an atomic
//    slot counter.
// 3. Sort each row's <= k_eff winners: bitonic sort in shared memory when
//    the padded count fits (<= 4096 keys), else bitonic stages in global
//    memory.
// 4. Unpack keys to (score, index).
// The output is exactly the plain version's (a stable sort of the keys),
// whatever order the atomics ran in. The row is blockIdx.y of every launch,
// so Q rows cost the same ~17 launches as one.
//
// Bound on an H100: bytes -- each radix pass and the gather read the Q x N
// int32 scores once (the bound counts one read, the least any method
// needs); the sort touches only Q x k_eff keys.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBins = 2048;
constexpr int kDigitBits = 11;
constexpr int kHistThreads = 256;
constexpr int kSelectThreads = 1024;
constexpr int kSmemSortMax = 4096;

// state, per row: [0] prefix, [1] keys still needed inside the prefix,
// [2] done, [3] threshold, [4] gather slot counter
enum { kPrefix = 0, kNeed = 1, kDone = 2, kThresh = 3, kSlot = 4, kState = 5 };

__device__ __forceinline__ unsigned long long make_key(int32_t score,
                                                       int64_t i) {
  return ((unsigned long long)(0x7FFFFFFFLL - (long long)score) << 31) |
         (unsigned long long)i;
}

__global__ void init_kernel(unsigned long long* st, unsigned* hist,
                            unsigned long long need) {
  unsigned* h = hist + (int64_t)blockIdx.y * kBins;
  for (int j = threadIdx.x; j < kBins; j += blockDim.x) h[j] = 0;
  if (threadIdx.x == 0) {
    unsigned long long* s = st + (int64_t)blockIdx.y * kState;
    s[kPrefix] = 0;
    s[kNeed] = need;
    s[kDone] = 0;
    s[kThresh] = 0;
    s[kSlot] = 0;
  }
}

__global__ void __launch_bounds__(kHistThreads)
hist_kernel(const int32_t* __restrict__ scores, int64_t n,
            const unsigned long long* __restrict__ st, int shift,
            int prev_shift, unsigned* __restrict__ hist) {
  const int64_t row = blockIdx.y;
  const unsigned long long* s = st + row * kState;
  if (s[kDone]) return;
  const int32_t* sc = scores + row * n;
  __shared__ unsigned sh[kBins];
  for (int j = threadIdx.x; j < kBins; j += kHistThreads) sh[j] = 0;
  __syncthreads();
  const unsigned long long hi =
      prev_shift >= 63 ? 0ull : (s[kPrefix] >> prev_shift);
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kHistThreads;
  // the loop bound is block-uniform, so all 32 lanes reach __match_any_sync
  for (int64_t i0 = (int64_t)blockIdx.x * kHistThreads; i0 < n; i0 += stride) {
    const int64_t i = i0 + threadIdx.x;
    int bin = -1;
    if (i < n) {
      const unsigned long long key = make_key(sc[i], i);
      if (prev_shift >= 63 || (key >> prev_shift) == hi)
        bin = (int)((key >> shift) & (kBins - 1));
    }
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    if (bin >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&sh[bin], (unsigned)__popc(peers));
  }
  __syncthreads();
  unsigned* h = hist + row * kBins;
  for (int j = threadIdx.x; j < kBins; j += kHistThreads)
    if (sh[j]) atomicAdd(&h[j], sh[j]);
}

// one block per row: inclusive scan of the row's histogram, pick the digit
// holding the need-th smallest key of the prefix, clear the histogram for
// the next pass
__global__ void __launch_bounds__(kSelectThreads)
select_kernel(unsigned* __restrict__ hist, unsigned long long* st, int shift) {
  unsigned long long* s = st + (int64_t)blockIdx.y * kState;
  if (s[kDone]) return;
  unsigned* h = hist + (int64_t)blockIdx.y * kBins;
  // read before the first barrier: the one thread that picks the digit
  // rewrites the state after it
  const unsigned long long need = s[kNeed];
  const unsigned long long prefix_in = s[kPrefix];
  __shared__ unsigned buf[2][kBins];
  const int t = threadIdx.x;
  for (int j = t; j < kBins; j += kSelectThreads) buf[0][j] = h[j];
  __syncthreads();
  int src = 0;
  for (int off = 1; off < kBins; off <<= 1) {
    for (int j = t; j < kBins; j += kSelectThreads)
      buf[src ^ 1][j] = buf[src][j] + (j >= off ? buf[src][j - off] : 0u);
    __syncthreads();
    src ^= 1;
  }
  for (int j = t; j < kBins; j += kSelectThreads) {
    const unsigned long long incl = buf[src][j];
    const unsigned long long cnt = h[j];
    const unsigned long long excl = incl - cnt;
    if (cnt > 0 && excl < need && need <= incl) {
      const unsigned long long prefix =
          prefix_in | ((unsigned long long)j << shift);
      const unsigned long long rest = need - excl;
      s[kPrefix] = prefix;
      s[kNeed] = rest;
      if (cnt == rest) {
        s[kThresh] = prefix | ((1ull << shift) - 1ull);
        s[kDone] = 1;
      }
    }
  }
  __syncthreads();
  for (int j = t; j < kBins; j += kSelectThreads) h[j] = 0;
}

__global__ void gather_kernel(const int32_t* __restrict__ scores, int64_t n,
                              unsigned long long* st,
                              unsigned long long* __restrict__ out,
                              int n_pad) {
  const int64_t row = blockIdx.y;
  unsigned long long* s = st + row * kState;
  const int32_t* sc = scores + row * n;
  unsigned long long* o = out + row * n_pad;
  const unsigned long long thr = s[kThresh];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const unsigned long long key = make_key(sc[i], i);
    if (key <= thr) o[atomicAdd(&s[kSlot], 1ull)] = key;
  }
}

__global__ void bitonic_smem_kernel(unsigned long long* keys, int n_pad) {
  extern __shared__ unsigned long long sm[];
  unsigned long long* a = keys + (int64_t)blockIdx.y * n_pad;
  const int t = threadIdx.x;
  for (int i = t; i < n_pad; i += blockDim.x) sm[i] = a[i];
  __syncthreads();
  for (int k = 2; k <= n_pad; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = t; i < n_pad; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const bool up = (i & k) == 0;
          const unsigned long long x = sm[i], y = sm[ixj];
          if ((x > y) == up) {
            sm[i] = y;
            sm[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = t; i < n_pad; i += blockDim.x) a[i] = sm[i];
}

__global__ void bitonic_step_kernel(unsigned long long* keys, int n_pad,
                                    int k, int j) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  unsigned long long* a = keys + (int64_t)blockIdx.y * n_pad;
  const int ixj = i ^ j;
  if (ixj > i) {
    const bool up = (i & k) == 0;
    const unsigned long long x = a[i], y = a[ixj];
    if ((x > y) == up) {
      a[i] = y;
      a[ixj] = x;
    }
  }
}

__global__ void unpack_kernel(const unsigned long long* __restrict__ keys,
                              int n_pad, int k_eff,
                              int32_t* __restrict__ out_scores,
                              int32_t* __restrict__ out_idx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k_eff) return;
  const int64_t row = blockIdx.y;
  const unsigned long long key = keys[row * n_pad + i];
  out_scores[row * k_eff + i] =
      (int32_t)(0x7FFFFFFFLL - (long long)(key >> 31));
  out_idx[row * k_eff + i] = (int32_t)(key & 0x7FFFFFFFull);
}

}  // namespace

extern "C" {

// scores: int32 [rows, n]; hist: uint32 [rows, 2048] scratch; st: uint64
// [rows, 5] scratch; winners: uint64 [rows, n_pad] scratch, n_pad = next
// pow2 >= k_eff; out_scores/out_idx: int32 [rows, k_eff]. Returns the
// first cudaError_t seen.
int tt_topk_rows(const void* scores, int rows, int64_t n, int k_eff,
                 int n_pad, void* hist, void* st, void* winners,
                 void* out_scores, void* out_idx, int sm_count,
                 void* stream) {
  if (rows <= 0 || n <= 0 || k_eff <= 0) return 0;
  if (rows > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* state = (unsigned long long*)st;
  unsigned* h = (unsigned*)hist;
  const int32_t* sc = (const int32_t*)scores;
  int err;

  init_kernel<<<dim3(1, rows), 256, 0, s>>>(state, h,
                                           (unsigned long long)k_eff);
  if ((err = (int)cudaGetLastError())) return err;

  // about 8 blocks per SM over all rows
  const int64_t want = (n + kHistThreads - 1) / kHistThreads;
  int64_t cap = (int64_t)sm_count * 8 / rows;
  if (cap < 1) cap = 1;
  const dim3 grid((unsigned)(want < cap ? want : cap), rows);
  int prev_shift = 63;
  for (int shift = 63 - kDigitBits;; shift -= kDigitBits) {
    if (shift < 0) shift = 0;
    hist_kernel<<<grid, kHistThreads, 0, s>>>(sc, n, state, shift,
                                              prev_shift, h);
    if ((err = (int)cudaGetLastError())) return err;
    select_kernel<<<dim3(1, rows), kSelectThreads, 0, s>>>(h, state, shift);
    if ((err = (int)cudaGetLastError())) return err;
    if (shift == 0) break;
    prev_shift = shift;
  }

  unsigned long long* w = (unsigned long long*)winners;
  if ((err = (int)cudaMemsetAsync(
           w, 0xFF, (size_t)rows * n_pad * sizeof(unsigned long long), s)))
    return err;
  gather_kernel<<<grid, 256, 0, s>>>(sc, n, state, w, n_pad);
  if ((err = (int)cudaGetLastError())) return err;

  if (n_pad <= kSmemSortMax) {
    const int threads = n_pad < 1024 ? (n_pad < 32 ? 32 : n_pad) : 1024;
    bitonic_smem_kernel<<<dim3(1, rows), threads,
                          n_pad * sizeof(unsigned long long), s>>>(w, n_pad);
    if ((err = (int)cudaGetLastError())) return err;
  } else {
    const dim3 blocks((unsigned)((n_pad + 255) / 256), rows);
    for (int k = 2; k <= n_pad; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        bitonic_step_kernel<<<blocks, 256, 0, s>>>(w, n_pad, k, j);
        if ((err = (int)cudaGetLastError())) return err;
      }
    }
  }
  unpack_kernel<<<dim3((k_eff + 255) / 256, rows), 256, 0, s>>>(
      w, n_pad, k_eff, (int32_t*)out_scores, (int32_t*)out_idx);
  return (int)cudaGetLastError();
}

const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
