// K9 shard_topk: the global top-k of the shards' gathered top-k lists.
//
// K9 replaces the post-gather tail of the reference's mesh kernels (TPU
// kernel family B10): `gidx = idx + shard * local_flat`, the all_gather,
// `jax.lax.top_k(all_scores, k)` and `all_idx[pos]`, at
// tempo_tpu/search/multiblock.py:984-992 (`dist_multi_scan_kernel`),
// :1186-1200 (its [Q] form in `dist_coalesced_scan_kernel`) and
// tempo_tpu/parallel/dist_search.py:225-235 (`_dist_kernel`). The shards
// own contiguous page ranges, shard s the flat entries
// [s * local_flat, (s + 1) * local_flat).
//
// Input: the gathered per-shard K2/K2r outputs, int32 scores [S, Q, kp]
// and local flat indices [S, Q, kp], each (s, q) list in K2's order:
// highest score first, lowest index first among equal scores. The two are
// read in place through one pair of strides (shard, row; unit stride along
// kp), so the [S, 2, Q, kp] tensor an all_gather returns is read as it
// lies, with no copy. Output, per row q, the kk = min(k, S * kp) best
// candidates (score [Q, kk], global flat index [Q, kk]) in that same order
// over global indices, so the answer equals the single-device K2 answer
// over the whole column, indices included, whatever S is (any element of
// the global top-k is in its own shard's top-kp, kp = min(k, local N)).
//
// Every candidate has a unique 63-bit key that sorts ascending in K2's
// order, key = (0x7FFFFFFF - score) << 31 | global index, and each list
// is sorted by it. A candidate's output position is therefore its
// position j in its own list plus, for every other list, the count of
// that list's keys below its own (a binary search: the merge-path rank).
// The ranks of all S * kp candidates are a permutation, so every output
// slot is written exactly once, with no atomics and no second pass.
//
// Bound on an H100: bytes -- the 8 * S * Q * kp input bytes once and the
// 8 * Q * kk output bytes (2 KB at the main path's [1, 1, 128]:
// 0.6 ns). Nothing that small is bound by the card: on an H100 the first
// version of K9 took 0.0013 ms on the device and 0.026 ms a call back to
// back, the rest host work (two copies, two allocations, a device
// context; the wrapper now does none of those) -- and at [8, 8, 1024] it
// lost to torch.topk, one CTA a row (8 CTAs on 132 SMs) doing (S - 1)
// binary searches in global memory, rebuilding each probed key.
//
// The design: a grid of (ceil(S * kp / 256), Q) CTAs, one thread a
// candidate. Each CTA first builds its row's S * kp keys once into shared
// memory (64 KB at [8, 8, 1024]: dynamic shared memory, the attribute set
// once a device), and the binary searches probe keys there. Past
// kSmemKeysMax bytes of keys the wrapper hands in a global scratch array
// [Q, S * kp] and a first launch builds the keys there instead (a route
// chosen by shape before the launch). At S = 1 a candidate's rank is its
// position, and the kernel copies.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kSmemKeysMax = 200 * 1024;   // bytes; the wrapper's too
constexpr int kMaxDevices = 64;

__device__ __forceinline__ unsigned long long make_key(int32_t score,
                                                       int64_t gidx) {
  return ((unsigned long long)(0x7FFFFFFFLL - (long long)score) << 31) |
         (unsigned long long)gidx;
}

struct Lists {
  const int32_t* scores;   // element (s, q, j) at s * ss + q * sq + j
  const int32_t* idx;      // the same strides
  long long ss, sq;
  int S, Q, kp;
  long long local_flat;
  __device__ __forceinline__ unsigned long long key(int q, int c) const {
    const int s = c / kp;
    const int64_t off = s * ss + q * sq + (c - s * kp);
    return make_key(scores[off], (int64_t)idx[off] + s * local_flat);
  }
};

__global__ void shard_keys_kernel(const Lists l,
                                  unsigned long long* __restrict__ keys) {
  const int q = blockIdx.y;
  const int n = l.S * l.kp;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c < n) keys[(int64_t)q * n + c] = l.key(q, c);
}

__global__ void __launch_bounds__(kThreads)
shard_topk_kernel(const Lists l, int kk,
                  const unsigned long long* __restrict__ gkeys,
                  int32_t* __restrict__ out_s, int32_t* __restrict__ out_i) {
  extern __shared__ unsigned long long sk[];
  const int q = blockIdx.y;
  const int n = l.S * l.kp;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (l.S == 1) {   // the rank is the position
    if (c < kk) {
      const int64_t off = q * l.sq + c;
      out_s[(int64_t)q * kk + c] = l.scores[off];
      out_i[(int64_t)q * kk + c] = l.idx[off];
    }
    return;
  }
  const unsigned long long* keys;
  if (gkeys) {
    keys = gkeys + (int64_t)q * n;
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) sk[i] = l.key(q, i);
    __syncthreads();
    keys = sk;
  }
  if (c >= n) return;
  const int s = c / l.kp;
  const int j = c - s * l.kp;
  if (j >= kk) return;
  const unsigned long long key = keys[c];
  int64_t rank = j;
  for (int t = 0; t < l.S && rank < kk; ++t) {
    if (t == s) continue;
    const unsigned long long* list = keys + t * l.kp;
    int lo = 0, hi = l.kp;   // keys of list t below `key`
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (list[mid] < key)
        lo = mid + 1;
      else
        hi = mid;
    }
    rank += lo;
  }
  if (rank < kk) {
    out_s[(int64_t)q * kk + rank] =
        (int32_t)(0x7FFFFFFFLL - (long long)(key >> 31));
    out_i[(int64_t)q * kk + rank] = (int32_t)(key & 0x7FFFFFFFull);
  }
}

// dynamic shared memory allowed for shard_topk_kernel, per device
long long g_smem_set[kMaxDevices];

}  // namespace

extern "C" {

// scores, idx: int32, element (s, q, j) of [S, Q, kp] at s * stride_s +
// q * stride_q + j; out_scores, out_idx: int32 [Q, kk], kk <= S * kp;
// S * local_flat < 2^31; keys: NULL, or int64 [Q, S * kp] scratch when
// S > 1 and 8 * S * kp > kSmemKeysMax (and only then). Issues on
// `stream`, on the current device. Returns a CUDA error code.
int tt_shard_topk(const void* scores, const void* idx, int S, int Q, int kp,
                  long long stride_s, long long stride_q,
                  long long local_flat, int kk, void* out_scores,
                  void* out_idx, void* keys, void* stream) {
  const long long n = (long long)S * kp;
  if (S < 1 || Q < 0 || kp < 0 || kk < 0 || kk > n ||
      n >= (1ll << 31) || local_flat < 0 ||
      (S > 1 && (keys != nullptr) != (n * 8 > kSmemKeysMax)))
    return (int)cudaErrorInvalidValue;
  if (Q == 0 || kk == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  size_t smem = 0;
  int err;
  if (!keys && S > 1) {
    smem = (size_t)n * 8;
    if (smem > 48 * 1024) {
      int dev;
      if ((err = (int)cudaGetDevice(&dev))) return err;
      if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
      if (g_smem_set[dev] < kSmemKeysMax) {
        if ((err = (int)cudaFuncSetAttribute(
                 shard_topk_kernel,
                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                 (int)kSmemKeysMax)))
          return err;
        g_smem_set[dev] = kSmemKeysMax;
      }
    }
  }
  // rows on gridDim.y, 65,535 at most a launch
  for (int q0 = 0; q0 < Q; q0 += 65535) {
    const int rq = Q - q0 < 65535 ? Q - q0 : 65535;
    const Lists l = {(const int32_t*)scores + q0 * stride_q,
                     (const int32_t*)idx + q0 * stride_q, stride_s, stride_q,
                     S, rq, kp, local_flat};
    unsigned long long* gk =
        keys ? (unsigned long long*)keys + (int64_t)q0 * n : nullptr;
    const dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)rq);
    if (gk) {
      shard_keys_kernel<<<grid, kThreads, 0, s>>>(l, gk);
      if ((err = (int)cudaGetLastError())) return err;
    }
    shard_topk_kernel<<<grid, kThreads, smem, s>>>(
        l, kk, gk, (int32_t*)out_scores + (int64_t)q0 * kk,
        (int32_t*)out_idx + (int64_t)q0 * kk);
    if ((err = (int)cudaGetLastError())) return err;
  }
  return 0;
}

// tt_shard_topk with its first twelve arguments packed in order into one
// int64 array (NULL keys as 0): one foreign-call argument, not twelve,
// which is ~2 us of host time a call at the main path's shape.
int tt_shard_topk_packed(const long long* a, void* stream) {
  return tt_shard_topk((const void*)a[0], (const void*)a[1], (int)a[2],
                       (int)a[3], (int)a[4], a[5], a[6], a[7], (int)a[8],
                       (void*)a[9], (void*)a[10], (void*)a[11], stream);
}

const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
