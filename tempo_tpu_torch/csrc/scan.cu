// K1 multi_scan, K1s scan_single and K4 coalesced_scan: the tag-search
// predicate, count and score column, for one query (K1, K1s) or for Q
// queries over the same staged pages in one launch (K4).
//
// K1 replaces tempo_tpu/search/multiblock.py `multi_entry_mask` and the
// count/inspected reductions of `multi_scan_kernel` (TPU kernel B3,
// without its aggregate input); K1s replaces
// tempo_tpu/search/engine.py `entry_match_mask` and the count/inspected
// half of `scan_kernel` (B1). Both write the score column of
// tempo_tpu/search/engine.py `masked_topk` (B2's input):
//
//   live[i]   = entry_valid[i] && page_block[page(i)] >= 0   (K1s: valid)
//   match[i]  = live[i] && (no verdicts || verdicts[i] != 0)
//            && AND over terms t < n_terms of
//                 OR over slots c < C of  key(i,c) == term_keys[b,t]
//                       && value_ok(b, t, val(i,c))
//            && dur_ok(i)                                     (unsigned)
//            && entry_end[i] >= win_start && entry_start[i] <= win_end  (unsigned)
//   score[i]  = match ? min(entry_start[i], 2^31-1) : -1
//   counts[0] += match, counts[1] += live
//
// where b = page_block[page(i)] selects the block's row of the small term
// tables (K1s: one block, b = 0). value_ok is the range test, v in some
// [lo,hi] of val_ranges[b,t,:], or, in hit-mask mode, a lookup in the
// dictionary probe's output (K3): for K1, on the pages of a block with
// g = block_group[b] >= 0, v >= 0 && hit(g, t, v) (rows g < 0 keep the
// ranges, so one batch mixes probed and range blocks); for K1s,
// v >= 0 && hit(t, v) on every page. The container's uint32 columns
// arrive as int32 tensors holding the same bits and are compared as
// uint32 here.
//
// Packed residency (tempo_tpu/search/packing.py, the scan half of TPU
// kernel B4: `unpack_ids`, `duration_ok`, `mask_select(_grouped)`). The
// same kernels read a batch staged in the packed layout, in registers,
// with no widening pass in device memory:
//   - kv columns: the unpacked layout holds signed ids (int8/16/32, pad
//     -1); the packed one holds codes id+1 (pad 0) as u8/u16/u32, or u4,
//     two codes per byte with slot 2j in the low nibble of byte j. The
//     column's reader (a template parameter: the only axis the inner
//     loop needs specialised) turns slot c into its id.
//   - duration: u32 (unpacked), exact u16, or u16 buckets dur >> s plus
//     an s-bit residual (u8 for s <= 8, else u16). A bucket strictly
//     between the bounds' buckets passes, one outside them fails, and
//     only a row on a boundary bucket reads its residual and compares
//     (q << s) | res exactly. A runtime-uniform branch.
//   - hit tables: one byte per value, or 32-bit words with value v at
//     bit v & 31 of word v >> 5. An id past the table reads its last
//     element (for words: the last word, at bit v & 31), as the
//     reference's gather does. A runtime-uniform branch in K1 and K1s,
//     a template parameter of K4 (below).
//
// Structural verdicts (kernel K6, csrc/structural.cu): an optional u8
// column [P*E] (K4: [rows, P*E], one row per query, a query past the rows
// matching nothing) that ANDs into the match before the terms, so count,
// score and top-k see it, as the reference ANDs structural_entry_mask into
// the mask (multiblock.py:869-877, :1060-1066, engine.py:351-354). A null
// pointer is one untaken branch.
//
// K4 replaces tempo_tpu/search/multiblock.py `coalesced_scan_kernel`
// (TPU kernel B6, without its aggregate input): the vmap
// of `multi_entry_mask` over a query axis. The query tables stack as
// term_keys [Q,B,T], val_ranges [Q,B,T,R,2], term_active [Q,T] and four
// uint32 bounds [Q]. An inactive term is neutral-true in the AND (unlike
// the -1 key, which is neutral-false for its block), and a query whose
// duration range is empty (the pad queries: dur_lo 1 > dur_hi 0) matches
// nothing. In hit-mask mode each query has its own hit table
// [G_q, T_q, V_q] (bytes or words), found through a small device table of
// addresses so that a fused dispatch copies no member's table, and its
// own row of block_group [Q,B]. K4 writes scores [Q, P*E], counts [Q] and
// one inspected count.
//
// Bound on an H100: bytes. Every entry reads its valid flag and writes
// one int32 score; a live entry reads its C key slots and the value slots
// whose key a term names (at the batch's width: 0.5 to 4 bytes a slot),
// plus, in hit-mask mode, one byte or word of the hit table per such slot
// (the table stays in L2); only entries that pass the terms read the
// duration, end and start columns, and only those columns that a
// non-trivial bound needs (start always, for the score). That is ~15-50
// bytes per entry for a handful of integer compares, far below the card's
// compute ridge; the bound is the 32-byte sectors those reads and writes
// touch, over 3.35 TB/s. Design: one thread per entry (adjacent threads
// on adjacent entries, so the column reads coalesce); the term tables are
// tiny and are read through the read-only cache; the score is written
// even for non-matches, so the top-k (K2) needs no separate mask array;
// count and inspected reduce per warp with ballots, per block in shared
// memory, then with one integer atomic per block, which is exact in any
// order. K1 and K1s are one body (the single-block form is a template
// parameter). K4 is bound by the same reads, made once for all Q queries,
// plus Q score columns written: one CTA covers (part of) one page, so all
// its entries share one block, whose rows of the Q queries' tables it
// stages in shared memory; each thread loads its entry's first 16 key and
// value slots into registers once and then runs every query and term over
// them, reading the entry columns only if some query passed its terms.
// K4's hit-mask mode and table format are a template parameter (as
// runtime branches they doubled its registers, 114-122, and slowed its
// hit mode ~1.5x on the card); K1's are runtime-uniform branches. K1, K1s and K4 test a slot with the same
// function (`slot_hit`) and a duration with the same one (`dur_ok`), so
// the three cannot drift apart.

#include "scan_common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int32_t score_of(uint32_t start) {
  return (int32_t)min(start, 0x7FFFFFFFu);
}

struct ScanArgs {
  const void* kv_key;            // [P, E, C] in the key layout
  const void* kv_val;            // [P, E, C] in the value layout
  const uint32_t* entry_start;   // [P, E]
  const uint32_t* entry_end;
  DurCol dur;
  const bool* entry_valid;
  const int32_t* page_block;     // [P]; unused by K1s
  const int32_t* term_keys;      // [B, t_stride]
  const int32_t* val_ranges;     // [B, t_stride, R, 2]
  const void* val_hits;          // [G, t_stride, n_vals] (K1s: G = 1)
  const int32_t* block_group;    // [B]; K1 hit-mask mode only
  const uint8_t* verdicts;       // [P * E] or null
  int64_t n_entries;
  int E, C, n_terms, t_stride, R;
  int64_t n_vals;                // hit row length, in elements
  int hit_words;                 // the hit table holds words
  uint32_t dur_lo, dur_hi, win_start, win_end;
  int32_t* scores;               // [P * E]
  int32_t* counts;               // [2], zeroed by the caller
};

template <typename KR, typename VR, bool kSingle>
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
    if (match && a.verdicts != nullptr) match = a.verdicts[i] != 0;
    if (match && a.n_terms > 0) {
      KR kk;
      VR vv;
      kk.at(a.kv_key, i, a.C);
      vv.at(a.kv_val, i, a.C);
      const bool words = a.hit_words != 0;
      // this entry's block's hit table (first row), or null for the
      // range test
      int64_t hrow = -1;
      if (a.val_hits != nullptr) {
        if (kSingle) {
          hrow = 0;
        } else {
          const int32_t g = __ldg(a.block_group + b);
          if (g >= 0) hrow = (int64_t)g * a.t_stride;
        }
      }
      for (int t = 0; t < a.n_terms && match; ++t) {
        const int64_t row = (int64_t)b * a.t_stride + t;
        const int32_t key = __ldg(a.term_keys + row);
        const int32_t* rg = a.val_ranges + row * a.R * 2;
        const void* h = hrow >= 0
                            ? hit_row(a.val_hits, hrow + t, a.n_vals, words)
                            : nullptr;
        bool hit = false;
        for (int c = 0; c < a.C && !hit; ++c)
          hit = slot_hit(kk, vv, c, key, rg, a.R, h, a.n_vals, words);
        match = hit;
      }
    }
    // the entry columns are read only for entries that passed the terms,
    // and a bound that admits every value reads no column
    int32_t score = -1;
    if (match && (a.dur_lo != 0u || a.dur_hi != 0xFFFFFFFFu))
      match = dur_ok(a.dur, i, dur_raw(a.dur, i), a.dur_lo, a.dur_hi);
    if (match && a.win_start != 0u) match = a.entry_end[i] >= a.win_start;
    if (match) {
      const uint32_t start = a.entry_start[i];
      match = start <= a.win_end;
      if (match) score = score_of(start);
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

template <bool kSingle>
int launch_scan(int kl, int vl, const ScanArgs& a, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((a.n_entries + kThreads - 1) / kThreads);
  return with_readers<kSingle>(kl, vl, [&](auto k, auto v) {
    scan_kernel<decltype(k), decltype(v), kSingle>
        <<<blocks, kThreads, 0, stream>>>(a);
    return (int)cudaGetLastError();
  });
}

ScanArgs make_args(const void* kv_key, const void* kv_val,
                   const void* entry_start, const void* entry_end,
                   const void* entry_dur, const void* entry_dur_res,
                   int dur_shift, int res_bytes, const void* entry_valid,
                   const void* page_block, const void* term_keys,
                   const void* val_ranges, const void* val_hits,
                   int hit_words, const void* block_group, int64_t n_entries,
                   int E, int C, int n_terms, int t_stride, int R,
                   int64_t n_vals, uint32_t dur_lo, uint32_t dur_hi,
                   uint32_t win_start, uint32_t win_end,
                   const void* verdicts, void* scores, void* counts) {
  ScanArgs a;
  a.kv_key = kv_key;
  a.kv_val = kv_val;
  a.entry_start = (const uint32_t*)entry_start;
  a.entry_end = (const uint32_t*)entry_end;
  a.dur = DurCol{entry_dur, entry_dur_res, dur_shift, res_bytes};
  a.entry_valid = (const bool*)entry_valid;
  a.page_block = (const int32_t*)page_block;
  a.term_keys = (const int32_t*)term_keys;
  a.val_ranges = (const int32_t*)val_ranges;
  a.val_hits = val_hits;
  a.hit_words = hit_words;
  a.block_group = (const int32_t*)block_group;
  a.verdicts = (const uint8_t*)verdicts;
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


// ---------------------------------------------------------------------
// K4 coalesced_scan

constexpr int kMaxQ = 64;     // queries per launch (one bit each of a mask)
constexpr int kRegC = 16;     // kv slots an entry keeps in registers
constexpr int kSmemMax = 48 * 1024;

struct CoalArgs {
  const void* kv_key;            // [P, E, C] in the key layout
  const void* kv_val;            // [P, E, C] in the value layout
  const uint32_t* entry_start;   // [P, E]
  const uint32_t* entry_end;
  DurCol dur;
  const bool* entry_valid;
  const int32_t* page_block;     // [P]
  const int32_t* term_keys;      // [Q, B, T]
  const int32_t* val_ranges;     // [Q, B, T, R, 2]
  const bool* term_active;       // [Q, T]
  const uint32_t* dur_lo;        // [Q] each
  const uint32_t* dur_hi;
  const uint32_t* win_start;
  const uint32_t* win_end;
  const int32_t* block_group;    // [Q, B]; hit-mask mode only
  const uint8_t* verdicts;       // [v_rows, P * E] or null
  int v_rows;
  const int64_t* hit_meta;       // [Q, 3]: table address (0: none),
                                 // t_stride, row length in elements;
                                 // hit-mask mode only
  int hit_words;                 // every table holds words
  int E, C, Q, B, T, R;
  int chunks;                    // CTAs per page
  int stage_tables;              // the block's [Q,T] rows go to smem
  int32_t* scores;               // [Q, P * E]
  int32_t* counts;               // [Q + 1]: matches per query, inspected;
                                 // zeroed by the caller
};

// shared-memory layout of one K4 CTA, computed alike on host and device
struct CoalLayout {
  int hmeta, cnt, bounds, bg, tk, rg, act, bytes;
};

__host__ __device__ inline CoalLayout coal_layout(int Q, int T, int R,
                                                  bool staged) {
  CoalLayout l;
  int off = 0;
  l.hmeta = off;  off += 3 * Q * 8;           // int64 [Q][3]
  l.cnt = off;    off += (Q + 1) * 4;         // int32 [Q + 1]
  l.bounds = off; off += 4 * Q * 4;           // uint32 [4][Q]
  l.bg = off;     off += Q * 4;               // int32 [Q]
  l.tk = off;     if (staged) off += Q * T * 4;          // int32 [Q][T]
  l.rg = off;     if (staged) off += Q * T * R * 2 * 4;  // int32 [Q][T][R][2]
  l.act = off;    off += Q * T;               // u8 [Q][T]
  l.bytes = (off + 15) & ~15;
  return l;
}

// kHit: 0 = range mode, 1 = byte hit tables, 2 = word hit tables
template <typename KR, typename VR, int kHit>
__global__ void __launch_bounds__(kThreads)
coalesced_kernel(const CoalArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const CoalLayout L = coal_layout(a.Q, a.T, a.R, a.stage_tables != 0);
  int64_t* s_hm = (int64_t*)(smem + L.hmeta);
  int* s_cnt = (int*)(smem + L.cnt);
  uint32_t* s_bd = (uint32_t*)(smem + L.bounds);
  int32_t* s_bg = (int32_t*)(smem + L.bg);
  int32_t* s_tk = (int32_t*)(smem + L.tk);
  int32_t* s_rg = (int32_t*)(smem + L.rg);
  uint8_t* s_act = smem + L.act;

  const int Q = a.Q, T = a.T, R = a.R;
  // template parameters, unlike K1's runtime branches: with the mode and
  // the table format known, K4 keeps its slot tests in about half the
  // registers (and twice the resident warps)
  constexpr bool hits = kHit != 0;
  constexpr bool words = kHit == 2;
  const int tid = threadIdx.x;
  const int64_t page = blockIdx.x / a.chunks;
  const int e = (blockIdx.x % a.chunks) * blockDim.x + tid;
  const int32_t b = __ldg(a.page_block + page);   // one block per CTA

  // stage the per-query scalars and this block's rows of the tables
  for (int j = tid; j <= Q; j += blockDim.x) s_cnt[j] = 0;
  for (int j = tid; j < Q; j += blockDim.x) {
    s_bd[j] = a.dur_lo[j];
    s_bd[Q + j] = a.dur_hi[j];
    s_bd[2 * Q + j] = a.win_start[j];
    s_bd[3 * Q + j] = a.win_end[j];
  }
  for (int j = tid; j < Q * T; j += blockDim.x) s_act[j] = a.term_active[j];
  if (b >= 0) {
    if (hits) {
      for (int j = tid; j < Q; j += blockDim.x)
        s_bg[j] = a.block_group[(int64_t)j * a.B + b];
      for (int j = tid; j < 3 * Q; j += blockDim.x) s_hm[j] = a.hit_meta[j];
    }
    if (a.stage_tables) {
      for (int j = tid; j < Q * T; j += blockDim.x)
        s_tk[j] = a.term_keys[((int64_t)(j / T) * a.B + b) * T + j % T];
      const int per_q = T * R * 2;
      for (int j = tid; j < Q * per_q; j += blockDim.x)
        s_rg[j] = a.val_ranges[((int64_t)(j / per_q) * a.B + b) * per_q +
                               j % per_q];
    }
  }
  __syncthreads();
  // key(q, t) = tk[q * tk_qs + t]; ranges(q, t) = rg + q * rg_qs + t * R * 2
  const int32_t* tk = s_tk;
  const int32_t* rg = s_rg;
  int64_t tk_qs = T, rg_qs = (int64_t)T * R * 2;
  if (!a.stage_tables) {
    const int64_t bb = b < 0 ? 0 : b;
    tk = a.term_keys + bb * T;
    rg = a.val_ranges + bb * T * R * 2;
    tk_qs = (int64_t)a.B * T;
    rg_qs = (int64_t)a.B * T * R * 2;
  }

  const bool in = e < a.E;
  const int64_t i = page * a.E + e;
  const int64_t n = (int64_t)gridDim.x / a.chunks * a.E;   // P * E
  const bool live = in && b >= 0 && a.entry_valid[i];
  uint64_t tmask = 0;   // bit q: the entry passes query q's terms
  if (live) {
    const int C = a.C;
    KR kk;
    VR vv;
    kk.at(a.kv_key, i, C);
    vv.at(a.kv_val, i, C);
    // the entry's slots, read from device memory once for all queries
    int32_t rk[kRegC], rv[kRegC];
#pragma unroll
    for (int c = 0; c < kRegC; ++c) {
      rk[c] = c < C ? kk[c] : -1;
      rv[c] = c < C ? vv[c] : -1;
    }
    for (int q = 0; q < Q; ++q) {
      if (s_bd[q] > s_bd[Q + q]) continue;   // empty duration range
      if (a.verdicts != nullptr &&
          (q >= a.v_rows || a.verdicts[(int64_t)q * n + i] == 0))
        continue;
      const void* hq = nullptr;      // row (g, 0) of query q's table
      int64_t hv = 0;
      if (hits) {
        const int32_t g = s_bg[q];
        if (g >= 0 && s_hm[3 * q] != 0) {
          hv = s_hm[3 * q + 2];
          hq = hit_row((const void*)(uintptr_t)s_hm[3 * q],
                       (int64_t)g * s_hm[3 * q + 1], hv, words);
        }
      }
      bool m = true;
      for (int t = 0; t < T && m; ++t) {
        if (!s_act[q * T + t]) continue;          // inactive: neutral-true
        const int32_t key = tk[q * tk_qs + t];
        const int32_t* r = rg + q * rg_qs + (int64_t)t * R * 2;
        const void* h =
            hits && hq != nullptr ? hit_row(hq, t, hv, words) : nullptr;
        bool hit = false;
#pragma unroll
        for (int c = 0; c < kRegC; ++c)
          if (c < C && !hit)
            hit = slot_hit(rk, rv, c, key, r, R, h, hv, words);
        for (int c = kRegC; c < C && !hit; ++c)
          hit = slot_hit(kk, vv, c, key, r, R, h, hv, words);
        m = hit;
      }
      if (m) tmask |= 1ull << q;
    }
  }
  // the entry columns, only for entries that passed some query's terms
  uint32_t dq = 0, end = 0, start = 0;
  if (tmask) {
    dq = dur_raw(a.dur, i);
    end = a.entry_end[i];
    start = a.entry_start[i];
  }
  const int lane = tid & 31;
  // every lane of every warp reaches the ballots (blockDim % 32 == 0)
  for (int q = 0; q < Q; ++q) {
    bool m = (tmask >> q) & 1ull;
    if (m)
      m = dur_ok(a.dur, i, dq, s_bd[q], s_bd[Q + q]) &&
          end >= s_bd[2 * Q + q] && start <= s_bd[3 * Q + q];
    if (in) a.scores[q * n + i] = m ? score_of(start) : -1;
    const unsigned bal = __ballot_sync(0xffffffffu, m);
    if (lane == 0 && bal) atomicAdd(&s_cnt[q], __popc(bal));
  }
  const unsigned lbal = __ballot_sync(0xffffffffu, live);
  if (lane == 0 && lbal) atomicAdd(&s_cnt[Q], __popc(lbal));
  __syncthreads();
  for (int j = tid; j <= Q; j += blockDim.x)
    if (s_cnt[j]) atomicAdd(&a.counts[j], s_cnt[j]);
}

}  // namespace

extern "C" {

// K1. key_layout/val_layout: the kv columns' Layout (both unpacked or
// both packed). dur_shift: -1 = u32 durations, 0 = exact u16, s > 0 = u16
// buckets with an s-bit residual of res_bytes bytes (entry_dur_res).
// val_hits ([G, t_stride, n_vals] bytes, or words with hit_words) and
// block_group (i32 [B]) are both null (range mode) or both set (hit-mask
// mode). verdicts: u8 [n_entries] structural verdicts, or null. Returns
// the cudaError_t of the launch (0 = launched).
int tt_multi_scan(int key_layout, int val_layout, const void* kv_key,
                  const void* kv_val, const void* entry_start,
                  const void* entry_end, const void* entry_dur,
                  const void* entry_dur_res, int dur_shift, int res_bytes,
                  const void* entry_valid, const void* page_block,
                  const void* term_keys, const void* val_ranges,
                  const void* val_hits, int hit_words,
                  const void* block_group, int64_t n_entries, int E, int C,
                  int n_terms, int t_stride, int R, int64_t n_vals,
                  uint32_t dur_lo, uint32_t dur_hi, uint32_t win_start,
                  uint32_t win_end, const void* verdicts, void* scores,
                  void* counts, void* stream) {
  if (n_entries <= 0) return 0;
  if ((val_hits == nullptr) != (block_group == nullptr) ||
      !valid_dur(dur_shift, res_bytes, entry_dur_res) ||
      !valid_layouts(key_layout, val_layout, C))
    return (int)cudaErrorInvalidValue;
  const ScanArgs a = make_args(
      kv_key, kv_val, entry_start, entry_end, entry_dur, entry_dur_res,
      dur_shift, res_bytes, entry_valid, page_block, term_keys, val_ranges,
      val_hits, hit_words, block_group, n_entries, E, C, n_terms, t_stride,
      R, n_vals, dur_lo, dur_hi, win_start, win_end, verdicts, scores,
      counts);
  return launch_scan<false>(key_layout, val_layout, a, (cudaStream_t)stream);
}

// K1s: one block's kv columns (the unpacked layout: int32 ids; or any
// packed pair), term tables [t_stride] and [t_stride, R, 2], durations
// as for K1, and an optional hit table [t_stride, n_vals] (bytes, or
// words with hit_words; null = range mode), and verdicts as for K1.
// Returns the cudaError_t of the launch.
int tt_scan_single(int key_layout, int val_layout, const void* kv_key,
                   const void* kv_val, const void* entry_start,
                   const void* entry_end, const void* entry_dur,
                   const void* entry_dur_res, int dur_shift, int res_bytes,
                   const void* entry_valid, const void* term_keys,
                   const void* val_ranges, const void* val_hits,
                   int hit_words, int64_t n_entries, int E, int C,
                   int n_terms, int t_stride, int R, int64_t n_vals,
                   uint32_t dur_lo, uint32_t dur_hi, uint32_t win_start,
                   uint32_t win_end, const void* verdicts, void* scores,
                   void* counts, void* stream) {
  if (n_entries <= 0) return 0;
  if (!valid_dur(dur_shift, res_bytes, entry_dur_res) ||
      !valid_layouts(key_layout, val_layout, C))
    return (int)cudaErrorInvalidValue;
  const ScanArgs a = make_args(
      kv_key, kv_val, entry_start, entry_end, entry_dur, entry_dur_res,
      dur_shift, res_bytes, entry_valid, nullptr, term_keys, val_ranges,
      val_hits, hit_words, nullptr, n_entries, E, C, n_terms, t_stride, R,
      n_vals, dur_lo, dur_hi, win_start, win_end, verdicts, scores, counts);
  return launch_scan<true>(key_layout, val_layout, a, (cudaStream_t)stream);
}

// K4. Q <= 64 queries; term_keys [Q, B, T], val_ranges [Q, B, T, R, 2],
// term_active (bool) [Q, T], the four bounds [Q] (uint32 bits); layouts
// and durations as for K1; hit-mask mode when block_group ([Q, B]) and
// hit_meta ([Q, 3] int64) are both set, every table in bytes or, with
// hit_words, in words. verdicts: u8 [v_rows, P * E] structural verdicts
// (query q >= v_rows matches nothing), or null. scores [Q, P * E]; counts
// [Q + 1], zeroed. Returns the cudaError_t of the launch.
int tt_coalesced_scan(int key_layout, int val_layout, const void* kv_key,
                      const void* kv_val, const void* entry_start,
                      const void* entry_end, const void* entry_dur,
                      const void* entry_dur_res, int dur_shift,
                      int res_bytes, const void* entry_valid,
                      const void* page_block, const void* term_keys,
                      const void* val_ranges, const void* term_active,
                      const void* dur_lo, const void* dur_hi,
                      const void* win_start, const void* win_end,
                      const void* block_group, const void* hit_meta,
                      int hit_words, int64_t P, int E, int C, int Q, int B,
                      int T, int R, const void* verdicts, int v_rows,
                      void* scores, void* counts, void* stream) {
  if (P <= 0 || E <= 0) return 0;
  if (Q < 1 || Q > kMaxQ || T < 1 || R < 1 ||
      (block_group == nullptr) != (hit_meta == nullptr) ||
      !valid_dur(dur_shift, res_bytes, entry_dur_res) ||
      !valid_layouts(key_layout, val_layout, C))
    return (int)cudaErrorInvalidValue;
  CoalArgs a;
  a.kv_key = kv_key;
  a.kv_val = kv_val;
  a.entry_start = (const uint32_t*)entry_start;
  a.entry_end = (const uint32_t*)entry_end;
  a.dur = DurCol{entry_dur, entry_dur_res, dur_shift, res_bytes};
  a.entry_valid = (const bool*)entry_valid;
  a.page_block = (const int32_t*)page_block;
  a.term_keys = (const int32_t*)term_keys;
  a.val_ranges = (const int32_t*)val_ranges;
  a.term_active = (const bool*)term_active;
  a.dur_lo = (const uint32_t*)dur_lo;
  a.dur_hi = (const uint32_t*)dur_hi;
  a.win_start = (const uint32_t*)win_start;
  a.win_end = (const uint32_t*)win_end;
  a.block_group = (const int32_t*)block_group;
  a.hit_meta = (const int64_t*)hit_meta;
  a.verdicts = (const uint8_t*)verdicts;
  a.v_rows = v_rows;
  a.hit_words = hit_words;
  a.E = E;
  a.C = C;
  a.Q = Q;
  a.B = B;
  a.T = T;
  a.R = R;
  const int threads = E >= kThreads ? kThreads : ((E + 31) / 32) * 32;
  a.chunks = (E + threads - 1) / threads;
  if (P * a.chunks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  a.stage_tables = coal_layout(Q, T, R, true).bytes <= kSmemMax;
  const int smem = coal_layout(Q, T, R, a.stage_tables != 0).bytes;
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  a.scores = (int32_t*)scores;
  a.counts = (int32_t*)counts;
  const unsigned grid = (unsigned)(P * a.chunks);
  cudaStream_t s = (cudaStream_t)stream;
  return with_readers<false>(key_layout, val_layout, [&](auto k, auto v) {
    if (a.hit_meta == nullptr)
      coalesced_kernel<decltype(k), decltype(v), 0>
          <<<grid, threads, smem, s>>>(a);
    else if (a.hit_words)
      coalesced_kernel<decltype(k), decltype(v), 2>
          <<<grid, threads, smem, s>>>(a);
    else
      coalesced_kernel<decltype(k), decltype(v), 1>
          <<<grid, threads, smem, s>>>(a);
    return (int)cudaGetLastError();
  });
}

const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
