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
// parameter). K1 and K1s test a slot with `slot_hit`, and K1, K1s and K4
// test a duration with `dur_ok`, so they cannot drift apart.
//
// K4 is bound by the same reads, made once for all Q queries, plus Q
// score columns written. Its work per entry would grow as Q x T x C if
// every query tested every slot (the first design did: 0.79 ms at Q = 8,
// 11x its bound, on an H100 80GB HBM3 at 700 W), yet the members of a fused
// dispatch name few keys and often the same term. So K4 matches keys
// first, in two launches:
//   - `coalesced_terms_kernel`, one CTA a block, reduces the Q x T
//     (query, term) pairs of the block to their distinct terms (the same
//     key and the same test, a range list or one member's hit row, tested
//     once however many members name it), in key order, cut into chunks
//     of 64 with a need mask per query and chunk (bit u of need[k][q]:
//     q needs distinct term 64k + u). Each key's terms in a chunk form a
//     segment, hit rows first; a segment's range terms become one sorted
//     list of range endpoints, each with the mask of the terms whose
//     ranges hold it. It writes one table a block into scratch.
//     `kernels/scan.py` `k4_terms` is this reduction in PyTorch.
//   - `coalesced_kernel`: a persistent grid (as many 256-thread CTAs as
//     fit) walks runs of tiles (256 entries of one page) in page order and
//     copies a block's table into shared memory when the page's block
//     changes. A tile's key, value and valid bytes are one contiguous run
//     of each column, copied by cp.async into one of two buffers while the
//     CTA works on the other (the run need not be aligned); no slot is
//     held in registers (32 register slots spilled 460 B before). Per
//     entry and chunk, each slot's key is read once and compared with the
//     chunk's keys; only a matching segment tests the value: its hit rows
//     by lookups issued four at a time, its ranges by one binary search
//     of the endpoints. The hits OR into a term mask tm, and query q keeps
//     its terms while (need[k][q] & ~tm) == 0. The work an entry is C x
//     (keys) plus the value tests, whatever Q.
//   - A short per-query epilogue: the duration and window bounds, reading
//     the entry columns only if some query passed its terms, a coalesced
//     score store per query and ballots into shared counts.
// Pad queries and queries past the verdict rows are out of every mask.
// The hit-mask mode and table format are a template parameter (as runtime
// branches they doubled the registers); K1's are runtime-uniform
// branches.

#include <atomic>
#include <type_traits>

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

constexpr int kMaxQ = 64;      // queries per launch (one bit each of a mask)
constexpr int kTileMax = 64 * 1024;       // both buffers of a staged tile
constexpr int kIntervalMax = 64 * 1024;   // a block's interval tables
constexpr int kSmemMax = 232448;          // a CTA's dynamic shared memory

// bytes of one entry's C slots in a kv column of `layout`
inline int slot_bytes(int layout, int C) {
  switch (layout) {
    case kU4: return C >> 1;
    case kIds16: case kU16: return 2 * C;
    case kIds32: case kU32: return 4 * C;
    default: return C;
  }
}

// One block's term table (see the header): byte offsets within it,
// computed alike on host and device. coalesced_terms_kernel writes one a
// block into global scratch; a scan CTA copies its block's into shared
// memory. The header holds the distinct term count U.
struct TermTable {
  int need;    // u64 [chunk][Q]: bit u of need[k][q]: q needs term 64k+u
  int qmask;   // u64 [QT]: the queries that need each distinct term
  int planes;  // u64 [chunk][4]: bit q of plane p is bit p of q's count of
               // needed terms in the chunk, planes 0-2; plane 3 is all
               // ones when every count is below 8 (else the per-query test)
  int term;    // longlong2 [QT]: a hit row (address, length), or the
               // ranges (address, count) of a term tested in place
  int bnd;     // int64 [2 QT R]: each segment's sorted range endpoints
  int mask;    // u64 [2 QT R]: the terms whose ranges hold each endpoint
  int seg;     // int4 [segments]: key, first term, first range term, end
  int segi;    // int2 [segments]: its endpoints (first, count)
  int cseg;    // int32 [chunks + 1]: each chunk's first segment
  int bytes;
};

__host__ __device__ inline TermTable term_table(int Q, int T, int R,
                                                bool intervals) {
  const int QT = Q * T, nch = (QT + 63) >> 6, ns = QT + nch;
  const int ni = intervals ? 2 * QT * R : 0;
  TermTable t;
  int off = 16;                          // int32 header: U
  t.need = off;  off += (nch * Q * 8 + 15) & ~15;   // int4 below: 16-B
  t.qmask = off; off += (QT * 8 + 15) & ~15;        // sections
  t.planes = off; off += nch * 32;
  t.term = off;  off += QT * 16;
  t.bnd = off;   off += ni * 8;
  t.mask = off;  off += ni * 8;
  t.seg = off;   off += ns * 16;
  t.segi = off;  off += ns * 8;
  t.cseg = off;  off += (nch + 1) * 4;
  t.bytes = (off + 15) & ~15;
  return t;
}

// range terms go through endpoint tables when those fit
inline bool use_intervals(int Q, int T, int R) {
  return (int64_t)2 * Q * T * R * 16 <= kIntervalMax;
}

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
  int hits;                      // hit-mask mode
  int64_t hm[kMaxQ][3];          // per query: hit table address (0:
                                 // none), t_stride, row length in
                                 // elements, passed by value
  unsigned char* tables;         // [B] term tables, tt.bytes each
  TermTable tt;
  int intervals;                 // range terms go through endpoint tables
  int E, C, Q, B, T, R;
  int te;                        // entries a tile (the CTA's threads)
  int tpp;                       // tiles a page
  int64_t tiles;                 // P * tpp
  int64_t n;                     // P * E
  int kbytes, vbytes;            // an entry's key / value slot bytes
  int tile_k, tile_v, tile_f;    // shared bytes of one buffer of a staged
                                 // tile's key, value and valid columns
                                 // (0: the columns are read in place)
  // the scan CTA's shared memory: the term table, bounds, counts, the
  // query mask, the tile buffers
  int s_bd, s_cnt, s_elig, s_kt, s_vt, s_vf, s_bytes;
  int32_t* scores;               // [Q, P * E]
  int32_t* counts;               // [Q + 1]: matches per query, inspected
};

// the queries that can match at all: a pad query (empty duration range)
// and a query past the verdict rows are out
__device__ __forceinline__ bool query_live(const CoalArgs& a, int q) {
  return a.dur_lo[q] <= a.dur_hi[q] &&
         (a.verdicts == nullptr || q < a.v_rows);
}

// the build kernel's shared memory past the table: per (query, term) pair
// j = q * T + t its test (jp, jn), key, leader, first pair of its key and
// place; per distinct term its key and kind; per endpoint its segment
struct BuildLayout {
  int jp, jn, jkey, jlead, jfk, jpos, tkey, tseg, jhit, thit, eseg, bytes;
};

__host__ __device__ inline BuildLayout build_layout(const TermTable& tt,
                                                    int QT, int ni) {
  BuildLayout l;
  int off = tt.bytes;
  l.jp = off;    off += QT * 8;
  l.jn = off;    off += QT * 8;
  l.jkey = off;  off += QT * 4;
  l.jlead = off; off += QT * 4;
  l.jfk = off;   off += QT * 4;
  l.jpos = off;  off += QT * 4;
  l.tkey = off;  off += QT * 4;
  l.tseg = off;  off += QT * 4;
  l.eseg = off;  off += ni * 4;
  l.jhit = off;  off += QT;
  l.thit = off;  off += QT;
  l.bytes = (off + 15) & ~15;
  return l;
}

__device__ __forceinline__ bool seg_start(const int32_t* tkey, int p) {
  return p == 0 || (p & 63) == 0 || tkey[p] != tkey[p - 1];
}

// Block b's term table (b = blockIdx.x), built by one CTA from the Q
// queries' rows of the tables: which pairs are active, which of them test
// the same thing (the first is the leader), the distinct terms ordered by
// key (keys in order of first appearance), hit rows before ranges, then
// pair; the need masks, the segments and, with `intervals`, each
// segment's sorted range endpoints with the terms holding each. The
// reduction in PyTorch is kernels/scan.py `k4_terms`.
template <int kHit>
__global__ void __launch_bounds__(kThreads)
coalesced_terms_kernel(const CoalArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool hits = kHit != 0;
  constexpr bool words = kHit == 2;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int Q = a.Q, T = a.T, R = a.R, QT = Q * T;
  const int nch = (QT + 63) >> 6, ni = a.intervals ? 2 * QT * R : 0;
  const TermTable& tt = a.tt;
  const BuildLayout L = build_layout(tt, QT, ni);
  int32_t* hdr = (int32_t*)smem;
  unsigned long long* need = (unsigned long long*)(smem + tt.need);
  long long* term = (long long*)(smem + tt.term);
  long long* bnd = (long long*)(smem + tt.bnd);
  unsigned long long* mask = (unsigned long long*)(smem + tt.mask);
  int4* seg = (int4*)(smem + tt.seg);
  int2* segi = (int2*)(smem + tt.segi);
  int32_t* cseg = (int32_t*)(smem + tt.cseg);
  long long* jp = (long long*)(smem + L.jp);
  long long* jn = (long long*)(smem + L.jn);
  int32_t* jkey = (int32_t*)(smem + L.jkey);
  int32_t* jlead = (int32_t*)(smem + L.jlead);
  int32_t* jfk = (int32_t*)(smem + L.jfk);
  int32_t* jpos = (int32_t*)(smem + L.jpos);
  int32_t* tkey = (int32_t*)(smem + L.tkey);
  int32_t* tseg = (int32_t*)(smem + L.tseg);
  int32_t* eseg = (int32_t*)(smem + L.eseg);
  uint8_t* jhit = smem + L.jhit;
  uint8_t* thit = smem + L.thit;

  unsigned long long* qmask = (unsigned long long*)(smem + tt.qmask);
  unsigned long long* planes = (unsigned long long*)(smem + tt.planes);
  if (tid == 0) hdr[0] = 0;
  for (int k = tid; k < nch * Q; k += nt) need[k] = 0ull;
  for (int k = tid; k < QT; k += nt) qmask[k] = 0ull;
  for (int k = tid; k < nch * 4; k += nt)
    planes[k] = (k & 3) == 3 ? ~0ull : 0ull;
  // each pair's key and test; an inactive pair leads nothing (-1)
  for (int j = tid; j < QT; j += nt) {
    const int q = j / T, t = j - q * T;
    const bool act = query_live(a, q) && a.term_active[j];
    const int64_t row = ((int64_t)q * a.B + b) * T + t;
    jkey[j] = a.term_keys[row];
    bool hit = false;
    long long p = 0, n = 0;
    if (hits) {
      const int32_t g = a.block_group[(int64_t)q * a.B + b];
      if (g >= 0 && a.hm[q][0] != 0) {
        hit = true;
        n = a.hm[q][2];
        p = (long long)hit_row((const void*)(uintptr_t)a.hm[q][0],
                               (int64_t)g * a.hm[q][1] + t, n, words);
      }
    }
    if (!hit) {
      // ranges past the last non-empty one can match nothing
      const int32_t* rg = a.val_ranges + row * R * 2;
      int r = act ? R : 0;
      while (r > 0 && rg[2 * r - 2] > rg[2 * r - 1]) --r;
      p = (long long)rg;
      n = r;
    }
    jp[j] = p;
    jn[j] = n;
    jhit[j] = hit;
    jlead[j] = act ? j : -1;
  }
  __syncthreads();
  // leaders: the first active pair of the same key and test; jfk: the
  // first active pair of the same key. jlead[j] stays >= 0 for an active
  // pair, which is all that other threads read of it here
  for (int j = tid; j < QT; j += nt) {
    if (jlead[j] < 0) continue;
    const int32_t key = jkey[j];
    int fk = j, lead = j;
    for (int i = 0; i < j; ++i) {
      if (jlead[i] < 0 || jkey[i] != key) continue;
      if (fk == j) fk = i;
      bool same = jhit[i] == jhit[j] && jn[i] == jn[j];
      if (same && jhit[j]) {
        same = jp[i] == jp[j];
      } else if (same) {
        const int32_t* x = (const int32_t*)jp[i];
        const int32_t* y = (const int32_t*)jp[j];
        for (int w = 0; w < 2 * (int)jn[j] && same; ++w) same = x[w] == y[w];
      }
      if (same) {
        lead = i;
        break;
      }
    }
    jfk[j] = fk;
    jlead[j] = lead;
  }
  __syncthreads();
  // a leader's place among the distinct terms
  for (int j = tid; j < QT; j += nt) {
    if (jlead[j] != j) continue;
    const int fk = jfk[j], kind = !jhit[j];
    int pos = 0;
    for (int i = 0; i < QT; ++i) {
      if (jlead[i] != i) continue;
      const int fi = jfk[i], ki = !jhit[i];
      pos += fi < fk || (fi == fk && (ki < kind || (ki == kind && i < j)));
    }
    jpos[j] = pos;
    term[2 * pos] = jp[j];
    term[2 * pos + 1] = jn[j];
    thit[pos] = jhit[j];
    tkey[pos] = jkey[j];
    atomicAdd(&hdr[0], 1);
  }
  __syncthreads();
  const int U = hdr[0];
  for (int j = tid; j < QT; j += nt) {
    const int lead = jlead[j];
    if (lead < 0) continue;
    const int pos = jpos[lead];
    atomicOr(&need[(pos >> 6) * Q + j / T], 1ull << (pos & 63));
    atomicOr(&qmask[pos], 1ull << (j / T));
  }
  __syncthreads();
  // each query's count of needed terms per chunk, as bit planes
  for (int w = tid; w < nch * Q; w += nt) {
    const int k = w / Q, q = w - k * Q;
    const int c = __popcll(need[w]);
    for (int p = 0; p < 3; ++p)
      if ((c >> p) & 1) atomicOr(&planes[4 * k + p], 1ull << q);
    if (c > 7) atomicAnd(&planes[4 * k + 3], 0ull);
  }
  // segments: each key's terms within one chunk
  for (int p = tid; p < U; p += nt) {
    if (!seg_start(tkey, p)) continue;
    int si = 0;
    for (int pp = 0; pp < p; ++pp) si += seg_start(tkey, pp);
    int end = p + 1;
    while (end < U && !seg_start(tkey, end)) ++end;
    int mid = p;
    while (mid < end && thit[mid]) ++mid;
    seg[si] = make_int4(tkey[p], p, mid, end);
    int m2 = 0;                 // its range endpoints
    for (int u = mid; u < end; ++u) {
      tseg[u] = si;
      m2 += 2 * (int)term[2 * u + 1];
    }
    segi[si] = make_int2(0, ni ? m2 : -1);
    if ((p & 63) == 0) cseg[p >> 6] = si;
    if (end == U) cseg[(U + 63) >> 6] = si + 1;
  }
  __syncthreads();
  if (ni) {
    const int nseg = U ? cseg[(U + 63) >> 6] : 0;
    // each segment's first endpoint, then each range term's endpoints,
    // unsorted: lo and hi + 1 of each of its ranges
    for (int s = tid; s < nseg; s += nt) {
      int base = 0;
      for (int ss = 0; ss < s; ++ss) base += segi[ss].y;
      segi[s].x = base;
    }
    __syncthreads();
    for (int u = tid; u < U; u += nt) {
      if (thit[u]) continue;
      const int s = tseg[u];
      int off = segi[s].x;
      for (int w = seg[s].z; w < u; ++w) off += 2 * (int)term[2 * w + 1];
      const int32_t* rg = (const int32_t*)term[2 * u];
      for (int r = 0; r < (int)term[2 * u + 1]; ++r) {
        mask[off + 2 * r] = (unsigned long long)(long long)rg[2 * r];
        mask[off + 2 * r + 1] =
            (unsigned long long)((long long)rg[2 * r + 1] + 1);
        eseg[off + 2 * r] = eseg[off + 2 * r + 1] = s;
      }
    }
    __syncthreads();
    const int total = nseg ? segi[nseg - 1].x + segi[nseg - 1].y : 0;
    // sort each segment's endpoints (mask holds them unsorted) into bnd
    for (int e = tid; e < total; e += nt) {
      const int2 si = segi[eseg[e]];
      const long long x = (long long)mask[e];
      int rank = 0;
      for (int f = si.x; f < si.x + si.y; ++f) {
        const long long y = (long long)mask[f];
        rank += y < x || (y == x && f < e);
      }
      bnd[si.x + rank] = x;
    }
    __syncthreads();
    // the terms whose ranges hold each endpoint
    for (int e = tid; e < total; e += nt) {
      const int s = eseg[e];
      const long long x = bnd[e];
      unsigned long long m = 0ull;
      for (int u = seg[s].z; u < seg[s].w; ++u) {
        const int32_t* rg = (const int32_t*)term[2 * u];
        for (int r = 0; r < (int)term[2 * u + 1]; ++r)
          if (rg[2 * r] <= x && x <= rg[2 * r + 1]) {
            m |= 1ull << (u & 63);
            break;
          }
      }
      mask[e] = m;
    }
  }
  __syncthreads();
  uint4* out = (uint4*)(a.tables + (int64_t)b * tt.bytes);
  for (int w = tid; w < tt.bytes / 16; w += nt) out[w] = ((uint4*)smem)[w];
}

// the bits of segment s's terms (seg: key x, terms [y, w), hit rows
// before z) that value id v passes: the hit rows four lookups at a time
// (independent loads, those past z predicated off), then the range terms
// by a binary search of the segment's endpoints (or, without them, each
// term's ranges in place)
template <int kHit>
__device__ __forceinline__ unsigned long long segment_hits(
    const CoalArgs& a, const unsigned char* tab, int s, int32_t v) {
  const int4 sg = ((const int4*)(tab + a.tt.seg))[s];
  const long long* term = (const long long*)(tab + a.tt.term);
  unsigned long long tm = 0ull;
  if (kHit != 0 && v >= 0)
    for (int u = sg.y; u < sg.z; u += 4) {
      // hit_lookup's reads, issued together: an id past the row reads its
      // last element; a row of length 0 holds no hit
      uint32_t x[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const longlong2 t = ((const longlong2*)term)[min(u + k, sg.z - 1)];
        const int64_t at = kHit == 2 ? (v >> 5) : v;
        const int64_t el = at < t.y ? at : t.y - 1;
        x[k] = 0u;
        if (u + k < sg.z && t.y > 0)
          x[k] = kHit == 2 ? __ldg((const uint32_t*)t.x + el)
                           : (uint32_t)__ldg((const uint8_t*)t.x + el);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (kHit == 2 ? (x[k] >> (v & 31)) & 1u : x[k] != 0u)
          tm |= 1ull << ((u + k) & 63);
    }
  if (sg.z == sg.w) return tm;
  if (a.intervals) {
    const int2 si = ((const int2*)(tab + a.tt.segi))[s];
    const long long* bnd = (const long long*)(tab + a.tt.bnd);
    int lo = si.x, hi = si.x + si.y;   // the first endpoint past v
    while (lo < hi) {
      const int md = (lo + hi) >> 1;
      if (bnd[md] <= v) lo = md + 1;
      else hi = md;
    }
    if (lo > si.x)
      tm |= ((const unsigned long long*)(tab + a.tt.mask))[lo - 1];
    return tm;
  }
  for (int u = sg.z; u < sg.w; ++u) {
    const int32_t* rg = (const int32_t*)term[2 * u];
    for (int r = 0; r < (int)term[2 * u + 1]; ++r)
      if (v >= __ldg(rg + 2 * r) && v <= __ldg(rg + 2 * r + 1)) {
        tm |= 1ull << (u & 63);
        break;
      }
  }
  return tm;
}

// issues cp.async copies of nbytes from src into dst, 16 bytes each from
// the aligned-down address
__device__ __forceinline__ void stage_async(unsigned char* dst,
                                           const void* src,
                                           int64_t nbytes) {
  const uintptr_t g = (uintptr_t)src;
  const uintptr_t a0 = g & ~(uintptr_t)15;
  const int nvec = (int)(((int)(g - a0) + nbytes + 15) >> 4);
  const unsigned base = (unsigned)__cvta_generic_to_shared(dst);
  for (int v = threadIdx.x; v < nvec; v += blockDim.x)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     base + 16 * v),
                 "l"((const uint4*)a0 + v));
}

// kHit: 0 = range mode, 1 = byte hit tables, 2 = word hit tables
// at least 3 CTAs an SM: ptxas keeps the builds within 85 registers, and
// none spills (without the floor it chose 64 registers and spilled up to
// 36 bytes)
template <typename KR, typename VR, int kHit>
__global__ void __launch_bounds__(kThreads, 3)
coalesced_kernel(const CoalArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned char* tab = smem;         // the term table, at offset 0
  uint4* bd = (uint4*)(smem + a.s_bd);     // dur_lo, dur_hi, window
  int* cnt = (int*)(smem + a.s_cnt);
  unsigned long long* elig_s = (unsigned long long*)(smem + a.s_elig);
  const int Q = a.Q, C = a.C;
  const int tid = threadIdx.x, lane = tid & 31;
  const bool staged = a.tile_k != 0;

  // the per-query scalars, once a CTA
  for (int j = tid; j <= Q; j += blockDim.x) cnt[j] = 0;
  for (int j = tid; j < Q; j += blockDim.x)
    bd[j] = make_uint4(a.dur_lo[j], a.dur_hi[j], a.win_start[j],
                       a.win_end[j]);
  if (tid == 0) *elig_s = 0ull;
  __syncthreads();
  for (int q = tid; q < Q; q += blockDim.x)
    if (query_live(a, q)) atomicOr(elig_s, 1ull << q);

  // this CTA's run of tiles, in page order; a tile's key, value and valid
  // bytes are one contiguous run of each column, copied into one of two
  // buffers while the CTA works on the other
  const int t0 = (int)((int64_t)blockIdx.x * a.tiles / gridDim.x);
  const int t1 = (int)((int64_t)(blockIdx.x + 1) * a.tiles / gridDim.x);
  auto issue = [&](int tile, int buf) {
    const int64_t page = tile / a.tpp;
    const int64_t first = page * a.E + (tile - page * a.tpp) * a.te;
    const int64_t left = (page + 1) * a.E - first;
    const int64_t ne = left < a.te ? left : a.te;
    stage_async(smem + a.s_kt + buf * a.tile_k,
                (const unsigned char*)a.kv_key + first * a.kbytes,
                ne * a.kbytes);
    stage_async(smem + a.s_vt + buf * a.tile_v,
                (const unsigned char*)a.kv_val + first * a.vbytes,
                ne * a.vbytes);
    stage_async(smem + a.s_vf + buf * a.tile_f, a.entry_valid + first, ne);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if (staged && t0 < t1) issue(t0, 0);
  __syncthreads();
  const unsigned long long elig = *elig_s;
  int32_t built = -1;
  int32_t b_next = t0 < t1 ? __ldg(a.page_block + t0 / a.tpp) : -1;
  for (int tile = t0; tile < t1; ++tile) {
    const int buf = (tile - t0) & 1;
    const int page = tile / a.tpp;
    const int e0 = (tile - page * a.tpp) * a.te;
    const int32_t b = b_next;                        // one block a tile
    if (tile + 1 < t1) b_next = __ldg(a.page_block + (tile + 1) / a.tpp);
    __syncthreads();          // the last tile's reads of smem are done
    if (staged) {
      if (tile + 1 < t1) {
        issue(tile + 1, buf ^ 1);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
    }
    if (b >= 0 && b != built) {   // this block's term table
      const uint4* src = (const uint4*)(a.tables + (int64_t)b * a.tt.bytes);
      for (int w = tid; w < a.tt.bytes / 16; w += blockDim.x)
        ((uint4*)smem)[w] = src[w];
      built = b;
    }
    __syncthreads();          // this tile's copies are visible
    const int e = e0 + tid;
    const bool in = e < a.E;
    const int64_t i = (int64_t)page * a.E + e;
    KR kk;
    VR vv;
    bool valid;
    if (staged) {
      const int64_t first = (int64_t)page * a.E + e0;
      kk.at(smem + a.s_kt + buf * a.tile_k +
                (((uintptr_t)a.kv_key + first * a.kbytes) & 15),
            tid, C);
      vv.at(smem + a.s_vt + buf * a.tile_v +
                (((uintptr_t)a.kv_val + first * a.vbytes) & 15),
            tid, C);
      valid = in && smem[a.s_vf + buf * a.tile_f +
                         (((uintptr_t)a.entry_valid + first) & 15) + tid];
    } else {
      kk.at(a.kv_key, i, C);
      vv.at(a.kv_val, i, C);
      valid = in && a.entry_valid[i];
    }
    const bool live = b >= 0 && valid;
    unsigned long long pass = 0ull;   // bit q: the entry passes q's terms
    if (live) {
      pass = elig;
      if (a.verdicts != nullptr)   // eight rows' reads issued together
        for (int q0 = 0; q0 < a.v_rows; q0 += 8) {
          uint8_t x[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            x[k] = (pass >> (q0 + k)) & 1ull
                       ? a.verdicts[(int64_t)(q0 + k) * a.n + i] : 1;
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (x[k] == 0) pass &= ~(1ull << (q0 + k));
        }
      const int U = ((const int32_t*)tab)[0];
      const int4* seg = (const int4*)(tab + a.tt.seg);   // .x: the key
      const int32_t* cseg = (const int32_t*)(tab + a.tt.cseg);
      for (int k = 0; pass != 0ull && k < ((U + 63) >> 6); ++k) {
        // the chunk's term bits: each slot's key is compared with the
        // chunk's keys once (the first four held in registers; segments
        // of a chunk have distinct keys), and only that key's terms test
        // the value
        unsigned long long tm = 0ull;
        const int s0 = cseg[k], ns = cseg[k + 1] - s0;
        const int32_t k0 = seg[s0].x, k1 = seg[s0 + min(1, ns - 1)].x,
                      k2 = seg[s0 + min(2, ns - 1)].x,
                      k3 = seg[s0 + min(3, ns - 1)].x;
        for (int c = 0; c < C; ++c) {
          const int32_t key = kk[c];
          int s = key == k0 ? 0 : key == k1 ? 1 : key == k2 ? 2
                                : key == k3 ? 3 : -1;
          for (int t = 4; s < 0 && t < ns; ++t)
            if (key == seg[s0 + t].x) s = t;
          if (s >= 0) tm |= segment_hits<kHit>(a, tab, s0 + s, vv[c]);
        }
        // q keeps its terms while it needs none outside tm: the count of
        // its needed terms in tm, summed in bit planes over the terms hit,
        // equals its count of needed terms
        const unsigned long long* pl =
            (const unsigned long long*)(tab + a.tt.planes) + 4 * k;
        if (pl[3] != 0ull) {
          const unsigned long long* qmask =
              (const unsigned long long*)(tab + a.tt.qmask) + 64 * k;
          unsigned long long c0 = 0ull, c1 = 0ull, c2 = 0ull;
          for (unsigned long long r = tm; r; r &= r - 1) {
            unsigned long long m = qmask[__ffsll((long long)r) - 1], t;
            t = c0 & m; c0 ^= m; m = t;
            t = c1 & m; c1 ^= m; m = t;
            c2 ^= m;
          }
          pass &= ~((c0 ^ pl[0]) | (c1 ^ pl[1]) | (c2 ^ pl[2]));
        } else {
          const unsigned long long* need =
              (const unsigned long long*)(tab + a.tt.need) + k * Q;
          for (unsigned long long r = pass; r; r &= r - 1) {
            const int q = __ffsll((long long)r) - 1;
            if (need[q] & ~tm) pass &= ~(1ull << q);
          }
        }
      }
    }
    // the bounds of the queries that passed their terms, reading the entry
    // columns only for such an entry
    int32_t score = -1;
    if (pass != 0ull) {
      const uint32_t dq = dur_raw(a.dur, i);
      const uint32_t end = a.entry_end[i], start = a.entry_start[i];
      for (unsigned long long r = pass; r; r &= r - 1) {
        const int q = __ffsll((long long)r) - 1;
        const uint4 w = bd[q];
        if (!(dur_ok(a.dur, i, dq, w.x, w.y) && end >= w.z && start <= w.w))
          pass &= ~(1ull << q);
      }
      score = score_of(start);
    }
    // counts: a ballot for each query some lane of the warp passed (every
    // lane reaches them: blockDim % 32 == 0)
    unsigned long long wor =
        __reduce_or_sync(0xffffffffu, (unsigned)(pass >> 32));
    wor = (wor << 32) | __reduce_or_sync(0xffffffffu, (unsigned)pass);
    for (; wor; wor &= wor - 1) {
      const int q = __ffsll((long long)wor) - 1;
      const unsigned bal = __ballot_sync(0xffffffffu, (pass >> q) & 1ull);
      if (lane == 0) atomicAdd(&cnt[q], __popc(bal));
    }
    if (in)
      for (int q = 0; q < Q; ++q)
        a.scores[q * a.n + i] = (pass >> q) & 1ull ? score : -1;
    const unsigned lbal = __ballot_sync(0xffffffffu, live);
    if (lane == 0 && lbal) atomicAdd(&cnt[Q], __popc(lbal));
  }
  __syncthreads();
  for (int j = tid; j <= Q; j += blockDim.x)
    if (cnt[j]) atomicAdd(&a.counts[j], cnt[j]);
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

// The bytes of K4's per-block term tables (the `tables` scratch of
// tt_coalesced_scan) for Q queries of T terms and R ranges over B blocks,
// or -1 for shapes K4 refuses.
int64_t tt_coalesced_table_bytes(int Q, int T, int R, int B) {
  if (Q < 1 || Q > kMaxQ || T < 1 || R < 1 || B < 0 ||
      (int64_t)Q * T > 65536 || (int64_t)Q * T * R > (1 << 24))
    return -1;
  return (int64_t)B * term_table(Q, T, R, use_intervals(Q, T, R)).bytes;
}

// K4. Q <= 64 queries; term_keys [Q, B, T], val_ranges [Q, B, T, R, 2],
// term_active (bool) [Q, T], the four bounds [Q] (uint32 bits); layouts
// and durations as for K1; hit-mask mode when block_group ([Q, B]) and
// hit_meta (host int64 [Q, 3]: each query's table address or 0, its
// t_stride and row length) are both set, every table in bytes or, with
// hit_words, in words. verdicts: u8 [v_rows, P * E] structural verdicts
// (query q >= v_rows matches nothing), or null. tables: scratch of
// table_bytes >= tt_coalesced_table_bytes(Q, T, R, B). scores [Q, P * E];
// counts [Q + 1], zeroed here. Two launches: the term tables, then the
// scan. Returns the cudaError_t of the launches.
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
                      void* tables, int64_t table_bytes, void* scores,
                      void* counts, void* stream) {
  if (P <= 0 || E <= 0) return 0;
  const int64_t need = tt_coalesced_table_bytes(Q, T, R, B);
  if (need < 0 || table_bytes < need ||
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
  a.hits = hit_meta != nullptr;
  for (int q = 0; q < Q; ++q)
    for (int f = 0; f < 3; ++f)
      a.hm[q][f] = a.hits ? ((const int64_t*)hit_meta)[3 * q + f] : 0;
  a.verdicts = (const uint8_t*)verdicts;
  a.v_rows = v_rows;
  a.tables = (unsigned char*)tables;
  a.intervals = use_intervals(Q, T, R);
  a.tt = term_table(Q, T, R, a.intervals != 0);
  a.E = E;
  a.C = C;
  a.Q = Q;
  a.B = B;
  a.T = T;
  a.R = R;
  a.te = E >= kThreads ? kThreads : ((E + 31) / 32) * 32;
  a.tpp = (E + a.te - 1) / a.te;
  a.tiles = P * a.tpp;
  a.n = P * E;
  if (a.tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  a.kbytes = slot_bytes(key_layout, C);
  a.vbytes = slot_bytes(val_layout, C);
  // a staged column takes its run plus up to 31 bytes of alignment
  const int64_t tk = ((int64_t)a.te * a.kbytes + 32 + 15) & ~15LL;
  const int64_t tv = ((int64_t)a.te * a.vbytes + 32 + 15) & ~15LL;
  const int64_t tf = ((int64_t)a.te + 32 + 15) & ~15LL;
  const bool stage_kv = 2 * (tk + tv + tf) <= kTileMax;
  a.tile_k = stage_kv ? (int)tk : 0;
  a.tile_v = stage_kv ? (int)tv : 0;
  a.tile_f = stage_kv ? (int)tf : 0;
  a.s_bd = a.tt.bytes;
  a.s_cnt = a.s_bd + 16 * Q;
  a.s_elig = (a.s_cnt + 4 * (Q + 1) + 7) & ~7;
  a.s_kt = (a.s_elig + 8 + 15) & ~15;
  a.s_vt = a.s_kt + 2 * a.tile_k;
  a.s_vf = a.s_vt + 2 * a.tile_v;
  a.s_bytes = a.s_vf + 2 * a.tile_f;
  const int build_smem =
      build_layout(a.tt, Q * T, a.intervals ? 2 * Q * T * R : 0).bytes;
  if (a.s_bytes > kSmemMax || build_smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  a.scores = (int32_t*)scores;
  a.counts = (int32_t*)counts;
  cudaStream_t s = (cudaStream_t)stream;
  // The allowance is always raised to the card's whole 227 KB, never to
  // this call's size: dispatches on other host threads launch the same
  // kernel, and a smaller allowance set by one of them between another's
  // set and launch would fail that launch.
  auto smem_ok = [](const void* kern, int bytes) {
    return bytes <= 48 * 1024
               ? cudaSuccess
               : cudaFuncSetAttribute(
                     kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                     kSmemMax);
  };
  auto go = [&](auto k, auto v, auto hit) -> int {
    constexpr int H = decltype(hit)::value;
    void (*build)(const CoalArgs) = coalesced_terms_kernel<H>;
    void (*kern)(const CoalArgs) =
        coalesced_kernel<decltype(k), decltype(v), H>;
    cudaError_t rc = smem_ok((const void*)build, build_smem);
    if (rc == cudaSuccess) rc = smem_ok((const void*)kern, a.s_bytes);
    // a persistent grid: as many CTAs as fit on the card at once, each
    // walking its run of tiles in page order. The occupancy of this build
    // is kept for the block and shared-memory sizes it was last asked for.
    static std::atomic<long long> occupancy{-1};   // (smem, threads, per SM)
    const long long shape = ((long long)a.s_bytes << 20) | (a.te << 8);
    int per_sm = 0, dev = 0, sms = 0;
    const long long known = occupancy.load(std::memory_order_relaxed);
    if (known >= 0 && (known & ~255LL) == shape) {
      per_sm = (int)(known & 255);
    } else if (rc == cudaSuccess) {
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, a.te,
                                                         a.s_bytes);
      if (rc == cudaSuccess)
        occupancy.store(shape | (per_sm & 255), std::memory_order_relaxed);
    }
    if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess)
      rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return (int)rc;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    rc = cudaMemsetAsync(counts, 0, (size_t)(Q + 1) * 4, s);
    if (rc != cudaSuccess) return (int)rc;
    if (B > 0) {
      build<<<B, kThreads, build_smem, s>>>(a);
      rc = cudaGetLastError();
      if (rc != cudaSuccess) return (int)rc;
    }
    const int64_t grid = a.tiles < (int64_t)per_sm * sms
                             ? a.tiles : (int64_t)per_sm * sms;
    kern<<<(unsigned)grid, a.te, a.s_bytes, s>>>(a);
    return (int)cudaGetLastError();
  };
  return with_readers<false>(key_layout, val_layout, [&](auto k, auto v) {
    if (!a.hits) return go(k, v, std::integral_constant<int, 0>{});
    if (hit_words) return go(k, v, std::integral_constant<int, 2>{});
    return go(k, v, std::integral_constant<int, 1>{});
  });
}

const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
