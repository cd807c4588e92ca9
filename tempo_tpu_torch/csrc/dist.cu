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
// highest score first, lowest index first among equal scores. Output,
// per row q, the kk = min(k, S * kp) best candidates (score [Q, kk],
// global flat index [Q, kk]) in that same order over global indices, so
// the answer equals the single-device K2 answer over the whole column,
// indices included, whatever S is (any element of the global top-k is
// in its own shard's top-kp, kp = min(k, local N)).
//
// Every candidate has a unique 63-bit key that sorts ascending in K2's
// order, key = (0x7FFFFFFF - score) << 31 | global index, and each list
// is sorted by it. A candidate's output position is therefore its
// position j in its own list plus, for every other list, the count of
// that list's keys below its own (a binary search: the merge-path rank).
// One CTA per row, one thread per candidate; a candidate whose rank is
// below kk writes itself there. The ranks of all S * kp candidates are a
// permutation, so every output slot is written exactly once, with no
// atomics and no second pass. One launch, where K2's chain is ~17; at
// S = 1 it is a copy.
//
// Bound on an H100: bytes -- the 8 * S * Q * kp input bytes once and the
// 8 * Q * kk output bytes; the binary searches re-read the inputs from
// L2 (S * kp * (S - 1) * log2(kp) probes a row).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned long long make_key(int32_t score,
                                                       int64_t gidx) {
  return ((unsigned long long)(0x7FFFFFFFLL - (long long)score) << 31) |
         (unsigned long long)gidx;
}

__global__ void shard_topk_kernel(const int32_t* __restrict__ scores,
                                  const int32_t* __restrict__ idx, int S,
                                  int Q, int kp, int64_t local_flat, int kk,
                                  int32_t* __restrict__ out_s,
                                  int32_t* __restrict__ out_i) {
  const int q = blockIdx.x;
  const int n = S * kp;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int s = c / kp;
    const int j = c - s * kp;
    const int64_t base = ((int64_t)s * Q + q) * kp;
    const int32_t sc = scores[base + j];
    const int64_t g = (int64_t)idx[base + j] + s * local_flat;
    const unsigned long long key = make_key(sc, g);
    int64_t rank = j;
    for (int t = 0; t < S && rank < kk; ++t) {
      if (t == s) continue;
      const int64_t o = ((int64_t)t * Q + q) * kp;
      const int64_t shift = t * local_flat;
      int lo = 0, hi = kp;          // keys of list t below `key`
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (make_key(scores[o + mid], (int64_t)idx[o + mid] + shift) < key)
          lo = mid + 1;
        else
          hi = mid;
      }
      rank += lo;
    }
    if (rank < kk) {
      out_s[(int64_t)q * kk + rank] = sc;
      out_i[(int64_t)q * kk + rank] = (int32_t)g;
    }
  }
}

}  // namespace

extern "C" {

// scores, idx: int32 [S, Q, kp], contiguous; out_scores, out_idx: int32
// [Q, kk], kk <= S * kp; S * local_flat < 2^31. Returns a CUDA error code.
int tt_shard_topk(const void* scores, const void* idx, int S, int Q, int kp,
                  long long local_flat, int kk, void* out_scores,
                  void* out_idx, void* stream) {
  if (S < 1 || Q < 0 || kp < 0 || kk < 0 || (long long)kk > (long long)S * kp ||
      local_flat < 0)
    return (int)cudaErrorInvalidValue;
  if (Q == 0 || kk == 0) return 0;
  shard_topk_kernel<<<Q, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)scores, (const int32_t*)idx, S, Q, kp,
      (int64_t)local_flat, kk, (int32_t*)out_scores, (int32_t*)out_idx);
  return (int)cudaGetLastError();
}

const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
