// K3 dict_probe: substring probe of T needles over a value dictionary.
//
// Replaces tempo_tpu/search/dict_probe.py `_probe_core` and `probe_kernel`
// (TPU kernel B5, one shard: the mesh split is B10):
//
//   hits[t, v]   = value v's bytes buf[off[v] .. off[v+1]) contain needle t
//                  (lens[t] == 0: every value, including empty ones;
//                   lens[t] <  0: no value — a term whose key is absent)
//   any_hits[t]  = OR over v of hits[t, v]
//
// A match never spans two values: the search for value v runs inside its
// own byte range. The dictionary is the packed UTF-8 of the sorted value
// dictionary, `buf u8 [N]` and `off i32 [V+1]`, and nothing else: the
// reference's per-byte position map (`pos`, 4 bytes per dictionary byte)
// and its power-of-two padding exist for the TPU's shifted-compare
// formulation and jit shape reuse, and a thread that walks
// off[v]..off[v+1] needs neither.
//
// Bound on an H100: bytes. The function reads the dictionary once (buf
// and off) and writes T*V hit bytes; a needle is compared a few bytes at
// a time against values of ~10-30 bytes, a handful of integer operations
// per byte, far below the compute ridge. Design: one thread per value
// (adjacent threads on adjacent values, so a warp's byte reads fall in a
// few consecutive cache lines and each line is fetched from device memory
// once); the needles sit in shared memory, loaded once per block in chunks
// of kChunk terms; the first needle byte filters candidate positions;
// any_hits is set in the same launch by one plain store of 1 per warp that
// found a hit (every writer writes the same value, so the race is benign),
// into an array the wrapper zeroes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNeedle = 64;  // dict_probe.MAX_NEEDLE_BYTES
constexpr int kChunk = 32;      // terms held in shared memory at a time

__global__ void __launch_bounds__(kThreads)
probe_kernel(const uint8_t* __restrict__ buf, const int32_t* __restrict__ off,
             int64_t n_vals, const uint8_t* __restrict__ needles,  // [T, L]
             const int32_t* __restrict__ lens, int n_terms, int L,
             bool* __restrict__ hits, bool* __restrict__ any_hits) {
  __shared__ uint8_t s_needle[kChunk][kMaxNeedle];
  __shared__ int s_len[kChunk];
  const int64_t v = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool real = v < n_vals;
  const int32_t beg = real ? __ldg(off + v) : 0;
  const int32_t end = real ? __ldg(off + v + 1) : 0;
  for (int t0 = 0; t0 < n_terms; t0 += kChunk) {
    const int nt = min(kChunk, n_terms - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int j = threadIdx.x; j < nt * L; j += kThreads) {
      const int t = j / L, c = j % L;
      s_needle[t][c] = needles[(int64_t)(t0 + t) * L + c];
    }
    for (int t = threadIdx.x; t < nt; t += kThreads) s_len[t] = lens[t0 + t];
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const int len = s_len[t];
      bool hit = false;
      if (real && len == 0) {
        hit = true;
      } else if (real && len > 0) {
        const uint8_t first = s_needle[t][0];
        for (int32_t s = beg; s + len <= end && !hit; ++s) {
          if (__ldg(buf + s) != first) continue;
          int j = 1;
          while (j < len && __ldg(buf + s + j) == s_needle[t][j]) ++j;
          hit = j == len;
        }
      }
      if (real) hits[(int64_t)(t0 + t) * n_vals + v] = hit;
      // every lane of every warp reaches the ballot (kThreads % 32 == 0)
      const unsigned bal = __ballot_sync(0xffffffffu, hit);
      if (bal && (threadIdx.x & 31) == 0) any_hits[t0 + t] = true;
    }
  }
}

}  // namespace

extern "C" {

// needles: u8 [n_terms, L] (L <= 64), lens: i32 [n_terms];
// hits: bool [n_terms, n_vals]; any_hits: bool [n_terms], zeroed by the
// caller. Returns the cudaError_t of the launch (0 = launched).
int tt_dict_probe(const void* buf, const void* off, int64_t n_vals,
                  const void* needles, const void* lens, int n_terms, int L,
                  void* hits, void* any_hits, void* stream) {
  if (n_vals <= 0 || n_terms <= 0) return 0;
  if (L < 1 || L > kMaxNeedle) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n_vals + kThreads - 1) / kThreads;
  probe_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, (const int32_t*)off, n_vals,
      (const uint8_t*)needles, (const int32_t*)lens, n_terms, L,
      (bool*)hits, (bool*)any_hits);
  return (int)cudaGetLastError();
}

const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
