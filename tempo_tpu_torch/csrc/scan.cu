// K1 multi_scan and K1s scan_single: the tag-search predicate, count and
// score column.
//
// K1 replaces tempo_tpu/search/multiblock.py `multi_entry_mask` and the
// count/inspected reductions of `multi_scan_kernel` (TPU kernel B3,
// without its packed, structural and aggregate inputs); K1s replaces
// tempo_tpu/search/engine.py `entry_match_mask` and the count/inspected
// half of `scan_kernel` (B1). Both write the score column of
// tempo_tpu/search/engine.py `masked_topk` (B2's input):
//
//   live[i]   = entry_valid[i] && page_block[page(i)] >= 0   (K1s: valid)
//   match[i]  = live[i]
//            && AND over terms t < n_terms of
//                 OR over slots c < C of  kv_key[i,c] == term_keys[b,t]
//                       && value_ok(b, t, kv_val[i,c])
//            && dur_lo <= entry_dur[i] <= dur_hi             (unsigned)
//            && entry_end[i] >= win_start && entry_start[i] <= win_end  (unsigned)
//   score[i]  = match ? min(entry_start[i], 2^31-1) : -1
//   counts[0] += match, counts[1] += live
//
// where b = page_block[page(i)] selects the block's row of the small term
// tables (K1s: one block, b = 0). value_ok is the range test, v in some
// [lo,hi] of val_ranges[b,t,:], or, in hit-mask mode, a lookup in the
// dictionary probe's output (K3): for K1, on the pages of a block with
// g = block_group[b] >= 0, v >= 0 && val_hits[g, t, v] (rows g < 0 keep
// the ranges, so one batch mixes probed and range blocks); for K1s,
// v >= 0 && val_hits[t, v] on every page. An id past the table clamps to
// its last entry, as the reference's gather does. The entry columns are
// uint32 in the container; they arrive as int32 tensors holding the same
// bits and are compared as uint32 here.
//
// Bound on an H100: bytes. Every entry reads its valid flag and writes
// one int32 score; a live entry reads its C key slots and the value slots
// whose key a term names (int8/int16/int32, as the batch was narrowed),
// plus, in hit-mask mode, one byte of the hit table per such slot (the
// table is a few MB and stays in L2); only entries that pass the terms
// read the u32 columns, and only those columns that a non-trivial bound
// needs (start always, for the score). That is ~15-50 bytes per entry for
// a handful of integer compares, far below the card's compute ridge; the
// bound is the 32-byte sectors those reads and writes touch, over
// 3.35 TB/s. Design: one thread per entry (adjacent threads on adjacent
// entries, so the column reads coalesce); the term tables are tiny and are
// read through the read-only cache; the score is written even for
// non-matches, so the top-k (K2) needs no separate mask array; count and
// inspected reduce per warp with ballots, per block in shared memory, then
// with one integer atomic per block, which is exact in any order. The two
// modes and the single-block form are template parameters of one body, so
// the range path compiles to the same code as before.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct ScanArgs {
  const void* kv_key;            // [P, E, C] KT
  const void* kv_val;            // [P, E, C] VT
  const uint32_t* entry_start;   // [P, E]
  const uint32_t* entry_end;
  const uint32_t* entry_dur;
  const bool* entry_valid;
  const int32_t* page_block;     // [P]; unused by K1s
  const int32_t* term_keys;      // [B, t_stride]
  const int32_t* val_ranges;     // [B, t_stride, R, 2]
  const uint8_t* val_hits;       // [G, t_stride, n_vals] (K1s: G = 1)
  const int32_t* block_group;    // [B]; K1 hit-mask mode only
  int64_t n_entries;
  int E, C, n_terms, t_stride, R;
  int64_t n_vals;
  uint32_t dur_lo, dur_hi, win_start, win_end;
  int32_t* scores;               // [P * E]
  int32_t* counts;               // [2], zeroed by the caller
};

template <typename KT, typename VT, bool kSingle, bool kHits>
__global__ void __launch_bounds__(kThreads) scan_kernel(const ScanArgs a) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  bool live = false;
  bool match = false;
  if (i < a.n_entries) {
    int32_t b = 0;
    if (kSingle) {
      live = a.entry_valid[i];
    } else {
      b = __ldg(a.page_block + i / a.E);
      live = a.entry_valid[i] && b >= 0;
    }
    match = live;
    if (match && a.n_terms > 0) {
      const KT* kk = (const KT*)a.kv_key + i * a.C;
      const VT* vv = (const VT*)a.kv_val + i * a.C;
      // this entry's block's hit table, or null for the range test
      const uint8_t* htab = nullptr;
      if (kHits) {
        if (kSingle) {
          htab = a.val_hits;
        } else {
          const int32_t g = __ldg(a.block_group + b);
          if (g >= 0) htab = a.val_hits + (int64_t)g * a.t_stride * a.n_vals;
        }
      }
      for (int t = 0; t < a.n_terms && match; ++t) {
        const int64_t row = (int64_t)b * a.t_stride + t;
        const int32_t key = __ldg(a.term_keys + row);
        bool hit = false;
        if (kHits && htab != nullptr) {
          const uint8_t* h = htab + (int64_t)t * a.n_vals;
          for (int c = 0; c < a.C && !hit; ++c) {
            if ((int32_t)kk[c] != key) continue;
            const int64_t v = (int64_t)vv[c];
            if (v >= 0 && a.n_vals > 0)
              hit = __ldg(h + (v < a.n_vals ? v : a.n_vals - 1)) != 0;
          }
        } else {
          const int32_t* rg = a.val_ranges + row * a.R * 2;
          for (int c = 0; c < a.C && !hit; ++c) {
            if ((int32_t)kk[c] != key) continue;
            const int32_t v = (int32_t)vv[c];
            for (int r = 0; r < a.R; ++r) {
              if (v >= __ldg(rg + 2 * r) && v <= __ldg(rg + 2 * r + 1)) {
                hit = true;
                break;
              }
            }
          }
        }
        match = hit;
      }
    }
    // the entry columns are read only for entries that passed the terms,
    // and a bound that admits every value reads no column
    int32_t score = -1;
    if (match && (a.dur_lo != 0u || a.dur_hi != 0xFFFFFFFFu)) {
      const uint32_t d = a.entry_dur[i];
      match = d >= a.dur_lo && d <= a.dur_hi;
    }
    if (match && a.win_start != 0u) match = a.entry_end[i] >= a.win_start;
    if (match) {
      const uint32_t start = a.entry_start[i];
      match = start <= a.win_end;
      if (match) score = (int32_t)min(start, 0x7FFFFFFFu);
    }
    a.scores[i] = score;
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
    if (s_cnt[0]) atomicAdd(&a.counts[0], s_cnt[0]);
    if (s_cnt[1]) atomicAdd(&a.counts[1], s_cnt[1]);
  }
}

template <typename KT, typename VT, bool kSingle>
int launch(const ScanArgs& a, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((a.n_entries + kThreads - 1) / kThreads);
  if (a.val_hits != nullptr)
    scan_kernel<KT, VT, kSingle, true><<<blocks, kThreads, 0, stream>>>(a);
  else
    scan_kernel<KT, VT, kSingle, false><<<blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename KT>
int dispatch_val(int val_bytes, const ScanArgs& a, cudaStream_t stream) {
  switch (val_bytes) {
    case 1: return launch<KT, int8_t, false>(a, stream);
    case 2: return launch<KT, int16_t, false>(a, stream);
    case 4: return launch<KT, int32_t, false>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

ScanArgs make_args(const void* kv_key, const void* kv_val,
                   const void* entry_start, const void* entry_end,
                   const void* entry_dur, const void* entry_valid,
                   const void* page_block, const void* term_keys,
                   const void* val_ranges, const void* val_hits,
                   const void* block_group, int64_t n_entries, int E, int C,
                   int n_terms, int t_stride, int R, int64_t n_vals,
                   uint32_t dur_lo, uint32_t dur_hi, uint32_t win_start,
                   uint32_t win_end, void* scores, void* counts) {
  ScanArgs a;
  a.kv_key = kv_key;
  a.kv_val = kv_val;
  a.entry_start = (const uint32_t*)entry_start;
  a.entry_end = (const uint32_t*)entry_end;
  a.entry_dur = (const uint32_t*)entry_dur;
  a.entry_valid = (const bool*)entry_valid;
  a.page_block = (const int32_t*)page_block;
  a.term_keys = (const int32_t*)term_keys;
  a.val_ranges = (const int32_t*)val_ranges;
  a.val_hits = (const uint8_t*)val_hits;
  a.block_group = (const int32_t*)block_group;
  a.n_entries = n_entries;
  a.E = E;
  a.C = C;
  a.n_terms = n_terms;
  a.t_stride = t_stride;
  a.R = R;
  a.n_vals = n_vals;
  a.dur_lo = dur_lo;
  a.dur_hi = dur_hi;
  a.win_start = win_start;
  a.win_end = win_end;
  a.scores = (int32_t*)scores;
  a.counts = (int32_t*)counts;
  return a;
}

}  // namespace

extern "C" {

// K1. key_bytes/val_bytes: itemsize of the narrowed kv columns (1, 2 or
// 4). val_hits (u8 [G, t_stride, n_vals]) and block_group (i32 [B]) are
// both null (range mode) or both set (hit-mask mode). Returns the
// cudaError_t of the launch (0 = launched).
int tt_multi_scan(int key_bytes, int val_bytes, const void* kv_key,
                  const void* kv_val, const void* entry_start,
                  const void* entry_end, const void* entry_dur,
                  const void* entry_valid, const void* page_block,
                  const void* term_keys, const void* val_ranges,
                  const void* val_hits, const void* block_group,
                  int64_t n_entries, int E, int C, int n_terms, int t_stride,
                  int R, int64_t n_vals, uint32_t dur_lo, uint32_t dur_hi,
                  uint32_t win_start, uint32_t win_end, void* scores,
                  void* counts, void* stream) {
  if (n_entries <= 0) return 0;
  if ((val_hits == nullptr) != (block_group == nullptr))
    return (int)cudaErrorInvalidValue;
  const ScanArgs a = make_args(
      kv_key, kv_val, entry_start, entry_end, entry_dur, entry_valid,
      page_block, term_keys, val_ranges, val_hits, block_group, n_entries, E,
      C, n_terms, t_stride, R, n_vals, dur_lo, dur_hi, win_start, win_end,
      scores, counts);
  cudaStream_t s = (cudaStream_t)stream;
  switch (key_bytes) {
    case 1: return dispatch_val<int8_t>(val_bytes, a, s);
    case 2: return dispatch_val<int16_t>(val_bytes, a, s);
    case 4: return dispatch_val<int32_t>(val_bytes, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K1s: one block's int32 kv columns, term tables [t_stride] and
// [t_stride, R, 2], and an optional hit table u8 [t_stride, n_vals] (null
// = range mode). Returns the cudaError_t of the launch.
int tt_scan_single(const void* kv_key, const void* kv_val,
                   const void* entry_start, const void* entry_end,
                   const void* entry_dur, const void* entry_valid,
                   const void* term_keys, const void* val_ranges,
                   const void* val_hits, int64_t n_entries, int E, int C,
                   int n_terms, int t_stride, int R, int64_t n_vals,
                   uint32_t dur_lo, uint32_t dur_hi, uint32_t win_start,
                   uint32_t win_end, void* scores, void* counts,
                   void* stream) {
  if (n_entries <= 0) return 0;
  const ScanArgs a = make_args(
      kv_key, kv_val, entry_start, entry_end, entry_dur, entry_valid,
      nullptr, term_keys, val_ranges, val_hits, nullptr, n_entries, E, C,
      n_terms, t_stride, R, n_vals, dur_lo, dur_hi, win_start, win_end,
      scores, counts);
  return launch<int32_t, int32_t, true>(a, (cudaStream_t)stream);
}

const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
