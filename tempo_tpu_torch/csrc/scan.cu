// K1 multi_scan: the batched tag-search predicate over stacked blocks.
//
// Replaces tempo_tpu/search/multiblock.py `multi_entry_mask` and the
// count/inspected reductions of `multi_scan_kernel` (TPU kernel B3, without
// its optional probe, structural, packed and aggregate inputs), and the
// score column of tempo_tpu/search/engine.py `masked_topk` (B2's input):
//
//   live[i]   = entry_valid[i] && page_block[page(i)] >= 0
//   match[i]  = live[i]
//            && AND over terms t < n_terms of
//                 OR over slots c < C of  kv_key[i,c] == term_keys[b,t]
//                       && kv_val[i,c] in some [lo,hi] of val_ranges[b,t,:]
//            && dur_lo <= entry_dur[i] <= dur_hi             (unsigned)
//            && entry_end[i] >= win_start && entry_start[i] <= win_end  (unsigned)
//   score[i]  = match ? min(entry_start[i], 2^31-1) : -1
//   counts[0] += match, counts[1] += live
//
// where b = page_block[page(i)] selects the block's row of the small term
// tables. The entry columns are uint32 in the container; they arrive as
// int32 tensors holding the same bits and are compared as uint32 here.
//
// Bound on an H100: bytes. Every entry reads its valid flag and writes
// one int32 score; a live entry reads its C key slots and the value slots
// whose key a term names (int8/int16/int32, as the batch was narrowed);
// only entries that pass the terms read the u32 columns, and only those
// columns that a non-trivial bound needs (start always, for the score).
// That is ~15-50 bytes per entry for a handful of integer compares, far
// below the card's compute ridge; the bound is the 32-byte sectors those
// reads and writes touch, over 3.35 TB/s. Design: one thread per entry
// (adjacent threads on adjacent entries, so the column reads coalesce);
// the term tables are tiny and are read through the read-only cache; the
// score is written even for non-matches, so the top-k (K2) needs no
// separate mask array; count and inspected reduce per warp with ballots,
// per block in shared memory, then with one integer atomic per block,
// which is exact in any order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename KT, typename VT>
__global__ void __launch_bounds__(kThreads)
multi_scan_kernel(const KT* __restrict__ kv_key, const VT* __restrict__ kv_val,
                  const uint32_t* __restrict__ entry_start,
                  const uint32_t* __restrict__ entry_end,
                  const uint32_t* __restrict__ entry_dur,
                  const bool* __restrict__ entry_valid,
                  const int32_t* __restrict__ page_block,
                  const int32_t* __restrict__ term_keys,   // [B, t_stride]
                  const int32_t* __restrict__ val_ranges,  // [B, t_stride, R, 2]
                  int64_t n_entries, int E, int C, int n_terms, int t_stride,
                  int R, uint32_t dur_lo, uint32_t dur_hi, uint32_t win_start,
                  uint32_t win_end, int32_t* __restrict__ scores,
                  int32_t* __restrict__ counts) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  bool live = false;
  bool match = false;
  if (i < n_entries) {
    const int32_t b = __ldg(page_block + i / E);
    live = entry_valid[i] && b >= 0;
    match = live;
    if (match && n_terms > 0) {
      const KT* kk = kv_key + i * C;
      const VT* vv = kv_val + i * C;
      for (int t = 0; t < n_terms && match; ++t) {
        const int64_t row = (int64_t)b * t_stride + t;
        const int32_t key = __ldg(term_keys + row);
        const int32_t* rg = val_ranges + row * R * 2;
        bool hit = false;
        for (int c = 0; c < C && !hit; ++c) {
          if ((int32_t)kk[c] != key) continue;
          const int32_t v = (int32_t)vv[c];
          for (int r = 0; r < R; ++r) {
            if (v >= __ldg(rg + 2 * r) && v <= __ldg(rg + 2 * r + 1)) {
              hit = true;
              break;
            }
          }
        }
        match = hit;
      }
    }
    // the entry columns are read only for entries that passed the terms,
    // and a bound that admits every value reads no column
    int32_t score = -1;
    if (match && (dur_lo != 0u || dur_hi != 0xFFFFFFFFu)) {
      const uint32_t d = entry_dur[i];
      match = d >= dur_lo && d <= dur_hi;
    }
    if (match && win_start != 0u) match = entry_end[i] >= win_start;
    if (match) {
      const uint32_t start = entry_start[i];
      match = start <= win_end;
      if (match) score = (int32_t)min(start, 0x7FFFFFFFu);
    }
    scores[i] = score;
  }
  // every lane of every warp reaches the ballots (kThreads % 32 == 0)
  const unsigned m_bal = __ballot_sync(0xffffffffu, match);
  const unsigned l_bal = __ballot_sync(0xffffffffu, live);
  __shared__ int s_cnt[2];
  if (threadIdx.x == 0) {
    s_cnt[0] = 0;
    s_cnt[1] = 0;
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&s_cnt[0], __popc(m_bal));
    atomicAdd(&s_cnt[1], __popc(l_bal));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (s_cnt[0]) atomicAdd(&counts[0], s_cnt[0]);
    if (s_cnt[1]) atomicAdd(&counts[1], s_cnt[1]);
  }
}

template <typename KT, typename VT>
void launch(const void* kv_key, const void* kv_val, const void* entry_start,
            const void* entry_end, const void* entry_dur,
            const void* entry_valid, const void* page_block,
            const void* term_keys, const void* val_ranges, int64_t n_entries,
            int E, int C, int n_terms, int t_stride, int R, uint32_t dur_lo,
            uint32_t dur_hi, uint32_t win_start, uint32_t win_end,
            void* scores, void* counts, cudaStream_t stream) {
  const int64_t blocks = (n_entries + kThreads - 1) / kThreads;
  multi_scan_kernel<KT, VT><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const KT*)kv_key, (const VT*)kv_val, (const uint32_t*)entry_start,
      (const uint32_t*)entry_end, (const uint32_t*)entry_dur,
      (const bool*)entry_valid, (const int32_t*)page_block,
      (const int32_t*)term_keys, (const int32_t*)val_ranges, n_entries, E, C,
      n_terms, t_stride, R, dur_lo, dur_hi, win_start, win_end,
      (int32_t*)scores, (int32_t*)counts);
}

template <typename KT>
int dispatch_val(int val_bytes, const void* kv_key, const void* kv_val,
                 const void* entry_start, const void* entry_end,
                 const void* entry_dur, const void* entry_valid,
                 const void* page_block, const void* term_keys,
                 const void* val_ranges, int64_t n_entries, int E, int C,
                 int n_terms, int t_stride, int R, uint32_t dur_lo,
                 uint32_t dur_hi, uint32_t win_start, uint32_t win_end,
                 void* scores, void* counts, cudaStream_t stream) {
#define TT_LAUNCH(VT)                                                        \
  launch<KT, VT>(kv_key, kv_val, entry_start, entry_end, entry_dur,          \
                 entry_valid, page_block, term_keys, val_ranges, n_entries,  \
                 E, C, n_terms, t_stride, R, dur_lo, dur_hi, win_start,      \
                 win_end, scores, counts, stream)
  switch (val_bytes) {
    case 1: TT_LAUNCH(int8_t); break;
    case 2: TT_LAUNCH(int16_t); break;
    case 4: TT_LAUNCH(int32_t); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef TT_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// key_bytes/val_bytes: itemsize of the narrowed kv columns (1, 2 or 4).
// Returns the cudaError_t of the launch (0 = launched).
int tt_multi_scan(int key_bytes, int val_bytes, const void* kv_key,
                  const void* kv_val, const void* entry_start,
                  const void* entry_end, const void* entry_dur,
                  const void* entry_valid, const void* page_block,
                  const void* term_keys, const void* val_ranges,
                  int64_t n_entries, int E, int C, int n_terms, int t_stride,
                  int R, uint32_t dur_lo, uint32_t dur_hi, uint32_t win_start,
                  uint32_t win_end, void* scores, void* counts, void* stream) {
  if (n_entries <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define TT_DISPATCH(KT)                                                      \
  return dispatch_val<KT>(val_bytes, kv_key, kv_val, entry_start, entry_end, \
                          entry_dur, entry_valid, page_block, term_keys,     \
                          val_ranges, n_entries, E, C, n_terms, t_stride, R, \
                          dur_lo, dur_hi, win_start, win_end, scores,        \
                          counts, s)
  switch (key_bytes) {
    case 1: TT_DISPATCH(int8_t);
    case 2: TT_DISPATCH(int16_t);
    case 4: TT_DISPATCH(int32_t);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TT_DISPATCH
}

const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
