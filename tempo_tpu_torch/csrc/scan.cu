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
// touch, over 3.35 TB/s.
//
// K1 and K1s share their kernels (K1s: no page_block, every page block 0,
// its hit table on every page). The first design, one thread an entry in
// 16K short CTAs, ran range mode at 2.9x that bound at 4,096 pages (0.105
// ms on an H100 80GB HBM3 at 700 W): per entry it divided by E for the
// page, read its keys a byte at a time and again for every term, and the
// wrapper zeroed the counts with a launch of its own. The design now:
//   - A request with terms runs `k1_kernel`: a persistent cooperative grid
//     (5 CTAs an SM, 48 registers) walks runs of tiles, 256 entries of
//     one page, so a tile's block and hit row are read once and no entry
//     divides. Each thread loads its entry's valid flag, key run and, when
//     it is up to 16 bytes, value run in one batch of aligned vector loads
//     (a warp's runs are contiguous). The key test is SWAR: each 32-bit
//     word of the key run is compared with a term's lane value at once,
//     4, 8, 16 or 32 bits a lane (zero_lanes), so each slot's key is read
//     once and no loop searches the slots; only a lane whose key names
//     the term has its value tested, and an entry stops at its first term
//     that fails (most fail the first). A range block's terms test a value
//     by one bit of a per-block bitmap of ids 0..8,191 in shared memory
//     (built from the ranges when the page's block changes, the CTA's only
//     barrier), a probed block's by its hit row.
//   - A request without terms (a duration or window bound, or structural
//     verdicts alone) reads no kv slot: `k1_cols_kernel` streams the
//     valid flags, verdicts, durations and ends, 4 entries a thread in
//     16-byte vectors, and reads a start only where the bounds pass.
//   - Counts: each CTA writes its pair of partial counts, and after one
//     grid barrier CTA 0 sums them into counts; the wrapper allocates
//     scores, counts and partials in one buffer, and no launch zeroes
//     them. (Many short CTAs adding into one address serialize at L2.)
//   - The host path: kernels/scan.py checks a staged batch's arrays and a
//     predicate's tables once and keeps the call's descriptor for as long
//     as those tensors live unchanged; a call passes that descriptor, the
//     verdicts and one output buffer.
// Tried on the card and not kept (PERF.md, PR 13): tiles staged through
// shared memory by cp.async (3 stages a CTA, or a warp's own): the copies
// alone ran range mode at ~0.05 ms, but reading keys, a key table and
// values back from shared memory made it 0.09-0.15 ms; a key-id lookup
// table instead of SWAR; 6-8 CTAs an SM (spills). The hit modes stay
// behind the first design's: their random hit-table lookups want the
// warps that 26 registers an entry gave it.
// The score is written even for non-matches, so the top-k (K2) needs no
// separate mask array. K1, K1s and K6 test a value with `value_ok`, and
// K1, K1s and K4 test a duration with `dur_ok`, so they cannot drift
// apart. `kernels/scan.py` `scan_tiled` is this rule in PyTorch.
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

#include <cooperative_groups.h>

#include <atomic>
#include <type_traits>

#include "scan_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int32_t score_of(uint32_t start) {
  return (int32_t)min(start, 0x7FFFFFFFu);
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


// ---------------------------------------------------------------------
// K1 multi_scan and K1s scan_single (see the header)

constexpr int kK1PatTerms = 32;           // terms the SWAR key test takes
constexpr int kK1MaxGrid = 2048;          // CTAs, at most (the partials)
constexpr int kK1Warps = kThreads / 32;
constexpr int kK1BitTerms = 8;            // range terms with value bitmaps
constexpr int kK1BitWords = 256;          // a bitmap's words: ids 0..8,191
constexpr int kK1BitMaxR = 16;            // ranges a term, for bitmaps


struct K1Args {
  const void* kv_key;            // [P, E, C] in the key layout
  const void* kv_val;            // [P, E, C] in the value layout
  const uint32_t* entry_start;   // [P, E]
  const uint32_t* entry_end;
  DurCol dur;
  const uint8_t* entry_valid;    // [P, E] bool
  const int32_t* page_block;     // [P]; null for K1s (every page block 0)
  const int32_t* term_keys;      // [B, t_stride]
  const int32_t* val_ranges;     // [B, t_stride, R, 2]
  const void* val_hits;          // [G, t_stride, n_vals] or null
  const int32_t* block_group;    // [B]; null with val_hits: K1s (group 0)
  const uint8_t* verdicts;       // [P * E] or null
  int E, C, n_terms, t_stride, R;
  int64_t n_vals;                // hit row length, in elements
  int hit_words;                 // the hit table holds words
  uint32_t dur_lo, dur_hi, win_start, win_end;
  int te;                        // entries a tile, at most (a page's)
  int tpp;                       // tiles a page
  int64_t tiles;                 // P * tpp
  int kbytes, vbytes;            // an entry's key / value slot bytes
  int dbytes;                    // a duration's bytes (4 or 2)
  int s_pat, s_bits, s_rng, s_red;  // shared memory: the terms' lane
                                 // values, the value bitmaps and the
                                 // ranges they come from, counts
  int bits;                      // range blocks build value bitmaps
  int32_t* scores;               // [P * E]
  int32_t* counts;               // [2]
  int32_t* partials;             // [2 * gridDim.x]
};

// The lanes of a key column: each slot's bits in its run (kBits: 4, 8, 16
// or 32) and, for a key id, the lane value that holds it -- the id itself
// (Ids), or its code id + 1 (Codes, Nibbles) -- or false when no lane of
// the column can hold that id (then no slot matches it).
template <typename KR>
struct KeyLanes;

template <typename T>
struct KeyLanes<Ids<T>> {
  static constexpr int kBits = 8 * sizeof(T);
  __device__ static bool lane(int32_t key, uint32_t& v) {
    if constexpr (kBits < 32) {
      if (key < -(1 << (kBits - 1)) || key >= (1 << (kBits - 1)))
        return false;
      v = (uint32_t)key & ((1u << kBits) - 1u);
    } else {
      v = (uint32_t)key;
    }
    return true;
  }
};

template <typename U>
struct KeyLanes<Codes<U>> {
  static constexpr int kBits = 8 * sizeof(U);
  __device__ static bool lane(int32_t key, uint32_t& v) {
    v = (uint32_t)key + 1u;
    if constexpr (kBits < 32) return v < (1u << kBits);
    return true;
  }
};

template <>
struct KeyLanes<Nibbles> {
  static constexpr int kBits = 4;
  __device__ static bool lane(int32_t key, uint32_t& v) {
    v = (uint32_t)key + 1u;
    return v < 16u;
  }
};

// a lane value repeated over a 32-bit word
template <int B>
__device__ __forceinline__ uint32_t lane_splat(uint32_t v) {
  if constexpr (B == 4) return v * 0x11111111u;
  if constexpr (B == 8) return v * 0x01010101u;
  if constexpr (B == 16) return v * 0x00010001u;
  return v;
}

// the top bit of every B-bit lane of y that is zero, exactly (no borrow
// crosses a lane)
template <int B>
__device__ __forceinline__ uint32_t zero_lanes(uint32_t y) {
  if constexpr (B == 32) return y == 0u ? 0x80000000u : 0u;
  constexpr uint32_t lo = B == 4 ? 0x77777777u
                          : B == 8 ? 0x7F7F7F7Fu : 0x7FFF7FFFu;
  return ~(((y & lo) + lo) | y | lo);
}

// The block's state a CTA keeps in shared memory while its tiles stay on
// one block (read by every thread as broadcasts, so it holds no
// registers): the block, each term's lane value splatted over a word, the
// terms the key column can hold, its first hit row, and whether `bits`
// holds the value bitmaps of its range terms.
struct K1Block {
  int32_t b;               // -1 before the first block
  unsigned can;            // bit t: a lane can hold term t's key
  int32_t use_bits;
  int32_t pad;
  long long hrow;          // first hit row of the block's group, or -1
  uint32_t pat[kK1PatTerms];   // term t's lane value, splatted
};

// one term's value test for the block: its bitmap (a range term t < 8 and
// an id below 8,192), else its hit row or its ranges
__device__ __forceinline__ bool k1_value(const K1Args& a, const K1Block& k,
                                         const uint32_t* bits, int t,
                                         int32_t v) {
  if (k.use_bits && t < kK1BitTerms &&
      (unsigned)v < (unsigned)(kK1BitWords * 32))
    return (bits[t * kK1BitWords + (v >> 5)] >> (v & 31)) & 1u;
  const bool words = a.hit_words != 0;
  return value_ok(v,
                  a.val_ranges + ((int64_t)k.b * a.t_stride + t) * a.R * 2,
                  a.R,
                  k.hrow >= 0 ? hit_row(a.val_hits, k.hrow + t, a.n_vals,
                                        words)
                              : nullptr,
                  a.n_vals, words);
}

// Up to 16 bytes of a run from device memory, as the 4 words of its
// bytes [0, 16): the aligned words that hold it, loaded together, shifted
// into place. Bytes past the run are left 0; nothing past it is read.
struct Run16 {
  uint32_t x[4];
  __device__ __forceinline__ void load(const void* p, int nbytes) {
    const uintptr_t g = (uintptr_t)p;
    // one vector where the run is a whole aligned vector (the common
    // widths: 16 bytes of int16/u16 values, 8 of int8 keys, 4 of u4 keys)
    if (nbytes == 16 && (g & 15) == 0) {
      const uint4 v = __ldg((const uint4*)p);
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
      return;
    }
    if (nbytes == 8 && (g & 7) == 0) {
      const uint2 v = __ldg((const uint2*)p);
      x[0] = v.x; x[1] = v.y; x[2] = x[3] = 0u;
      return;
    }
    if (nbytes == 4 && (g & 3) == 0) {
      x[0] = __ldg((const uint32_t*)p);
      x[1] = x[2] = x[3] = 0u;
      return;
    }
    const uint32_t* w = (const uint32_t*)(g & ~(uintptr_t)3);
    const unsigned off = (unsigned)(g & 3u);
    const int na = (int)((off + nbytes + 3u) >> 2);   // 1..5 words
    uint32_t r[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) r[k] = k < na ? __ldg(w + k) : 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = __funnelshift_r(r[k], r[k + 1], 8u * off);
  }
  // lane c of B bits (c * B < 128)
  template <int B>
  __device__ __forceinline__ uint32_t lane(int c) const {
    const int bit = c * B;
    const int q = bit >> 5;
    const uint32_t w = q == 0 ? x[0] : q == 1 ? x[1] : q == 2 ? x[2] : x[3];
    return B == 32 ? w : (w >> (bit & 31)) & ((1u << (B & 31)) - 1u);
  }
};

// a value slot of a run held in registers, as its reader would read it
template <typename VR>
struct ValueLanes;
template <typename T>
struct ValueLanes<Ids<T>> {
  static constexpr int kBits = 8 * sizeof(T);
  __device__ static int32_t id(uint32_t lane) {
    return kBits == 32 ? (int32_t)lane
                       : (int32_t)(lane << (32 - kBits)) >> (32 - kBits);
  }
};
template <typename U>
struct ValueLanes<Codes<U>> {
  static constexpr int kBits = 8 * sizeof(U);
  __device__ static int32_t id(uint32_t lane) {
    return (int32_t)(lane - 1u);
  }
};
template <>
struct ValueLanes<Nibbles> {
  static constexpr int kBits = 4;
  __device__ static int32_t id(uint32_t lane) {
    return (int32_t)(lane - 1u);
  }
};

// The terms of the block over entry i. Its key run is read once: up to 16
// bytes as one batch of aligned words (Run16), a longer one a word at a
// time through L1 (a warp's runs are contiguous). Term by term, each run
// word's lanes are compared with the term's lane value at once (SWAR: one
// xor and a zero-lane test per word), and only a lane whose key names the
// term has its value tested: from the value run loaded with the keys when
// it is up to 16 bytes, else read then. The entry stops at its first term
// that no slot passes. Terms past the
// first 32 (never on a request's path) take a slot loop one term at a
// time.
template <typename KR, typename VR>
__device__ __forceinline__ bool k1_terms(const K1Args& a, int64_t i,
                                         const K1Block& k,
                                         const uint32_t* bits,
                                         const Run16& kr, const Run16& vr) {
  constexpr int B = KeyLanes<KR>::kBits, kLanes = 32 / B;
  constexpr int VB = ValueLanes<VR>::kBits;
  const int tl = min(a.n_terms, kK1PatTerms);
  const unsigned want = tl == 32 ? ~0u : (1u << tl) - 1u;
  if ((k.can & want) != want) return false;
  KR kk;
  VR vv;
  kk.at(a.kv_key, i, a.C);
  vv.at(a.kv_val, i, a.C);
  const char* krun = (const char*)a.kv_key + i * a.kbytes;
  const bool kfast = a.kbytes <= 16, vfast = a.vbytes <= 16;
  const uintptr_t g = (uintptr_t)krun;
  const uint32_t* w = (const uint32_t*)(g & ~(uintptr_t)3);
  const unsigned off = (unsigned)(g & 3u);
  const int na = (int)((off + a.kbytes + 3u) >> 2);
  const int nw = (a.C + kLanes - 1) / kLanes;           // run words
  // term by term, in order: an entry stops at its first term that no
  // slot passes (most entries fail the first term, and a hit lookup or
  // a value read is the costly part)
  for (int t = 0; t < tl; ++t) {
    const uint32_t pt = k.pat[t];
    bool found = false;
    uint32_t w0 = kfast ? 0u : __ldg(w);
    for (int j = 0; j < nw && !found; ++j) {
      uint32_t x;
      if (kfast) {
        x = j == 0 ? kr.x[0] : j == 1 ? kr.x[1] : j == 2 ? kr.x[2] : kr.x[3];
      } else {
        const uint32_t w1 = j + 1 < na ? __ldg(w + j + 1) : 0u;
        x = __funnelshift_r(w0, w1, 8u * off);
        w0 = w1;
      }
      const int nl = min(kLanes, a.C - j * kLanes);
      uint32_t z = zero_lanes<B>(x ^ pt) &
                   (nl == kLanes ? ~0u : (1u << (nl * B)) - 1u);
      while (z) {
        const int c = j * kLanes + (__ffs(z) - 1) / B;
        z &= z - 1u;
        // the value: from the run held in registers, else read now
        const int32_t v = vfast ? ValueLanes<VR>::id(vr.lane<VB>(c)) : vv[c];
        if (k1_value(a, k, bits, t, v)) {
          found = true;
          break;
        }
      }
    }
    if (!found) return false;
  }
  for (int t = kK1PatTerms; t < a.n_terms; ++t) {
    const int32_t key = __ldg(a.term_keys + (int64_t)k.b * a.t_stride + t);
    bool h = false;
    for (int c = 0; c < a.C && !h; ++c)
      h = kk[c] == key && k1_value(a, k, bits, t, vv[c]);
    if (!h) return false;
  }
  return true;
}

// Rebuilds the block state for block b (every thread; the caller has
// passed a barrier since the last tile read the old state): each term's
// lane value, and for a block tested by ranges (R <= 16) a bitmap of
// value ids 0..8,191 for each of its first 8 terms, built from the
// block's ranges copied once into shared memory. The caller's next
// barrier publishes it.
template <typename KR>
__device__ __forceinline__ void k1_rebuild(const K1Args& a, K1Block& k,
                                           uint32_t* bits, int32_t* rng,
                                           int32_t b) {
  const int tid = threadIdx.x;
  long long hrow = -1;
  if (a.val_hits != nullptr) {
    const int32_t g = a.block_group == nullptr ? 0
                                               : __ldg(a.block_group + b);
    if (g >= 0) hrow = (long long)g * a.t_stride;
  }
  const bool use_bits = hrow < 0 && a.bits;
  const int tb = min(a.n_terms, kK1BitTerms);
  const int32_t* tk = a.term_keys + (int64_t)b * a.t_stride;
  const int32_t* rg = a.val_ranges + (int64_t)b * a.t_stride * a.R * 2;
  if (use_bits)
    for (int w = tid; w < tb * a.R * 2; w += kThreads) rng[w] = __ldg(rg + w);
  bool can = true;
  if (tid < kK1PatTerms) {
    uint32_t v = 0u;
    can = tid < a.n_terms && KeyLanes<KR>::lane(__ldg(tk + tid), v);
    k.pat[tid] = lane_splat<KeyLanes<KR>::kBits>(v);
  }
  const unsigned mask = __ballot_sync(0xffffffffu, can);
  if (tid == 0) {          // warp 0's lanes are the terms
    k.b = b;
    k.can = mask;
    k.hrow = hrow;
    k.use_bits = use_bits;
  }
  __syncthreads();         // the ranges are in
  if (use_bits)
    for (int w = tid; w < tb * kK1BitWords; w += kThreads) {
      const int t = w / kK1BitWords;
      const int32_t lo32 = (w % kK1BitWords) * 32;
      uint32_t x = 0u;
      for (int r = 0; r < a.R; ++r) {
        const int32_t l = max(rng[(t * a.R + r) * 2], lo32);
        const int32_t h = min(rng[(t * a.R + r) * 2 + 1], lo32 + 31);
        if (l <= h) x |= (~0u >> (31 - (h - l))) << (l - lo32);
      }
      bits[w] = x;
    }
}

// One entry's bounds and score, its duration and end given (read only where
// the bound needs them); the start is read only where those pass.
__device__ __forceinline__ bool k1_bounds(const K1Args& a, int64_t i,
                                          uint32_t dq, uint32_t end,
                                          int32_t& score) {
  score = -1;
  if ((a.dur_lo != 0u || a.dur_hi != 0xFFFFFFFFu) &&
      !dur_ok(a.dur, i, dq, a.dur_lo, a.dur_hi))
    return false;
  if (a.win_start != 0u && end < a.win_start) return false;
  const uint32_t start = a.entry_start[i];
  if (start > a.win_end) return false;
  score = score_of(start);
  return true;
}

// Counts: each thread's pair summed per warp, per CTA into `partials`,
// then after one grid barrier CTA 0 sums them into `counts` (a cooperative
// launch), so no launch zeroes them first.
__device__ __forceinline__ void k1_counts(const K1Args& a, int* red,
                                          int n_match, int n_live) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  n_match = __reduce_add_sync(0xffffffffu, n_match);
  n_live = __reduce_add_sync(0xffffffffu, n_live);
  if (lane == 0) {
    red[2 * warp] = n_match;
    red[2 * warp + 1] = n_live;
  }
  __syncthreads();
  if (tid == 0) {
    int m = 0, l = 0;
    for (int w = 0; w < kK1Warps; ++w) {
      m += red[2 * w];
      l += red[2 * w + 1];
    }
    a.partials[2 * blockIdx.x] = m;
    a.partials[2 * blockIdx.x + 1] = l;
  }
  cg::this_grid().sync();
  if (blockIdx.x == 0) {
    int m = 0, l = 0;
    for (int k = tid; k < (int)gridDim.x; k += kThreads) {
      m += __ldcg(a.partials + 2 * k);
      l += __ldcg(a.partials + 2 * k + 1);
    }
    m = __reduce_add_sync(0xffffffffu, m);
    l = __reduce_add_sync(0xffffffffu, l);
    if (lane == 0) {
      red[2 * warp] = m;
      red[2 * warp + 1] = l;
    }
    __syncthreads();
    if (tid == 0) {
      m = l = 0;
      for (int w = 0; w < kK1Warps; ++w) {
        m += red[2 * w];
        l += red[2 * w + 1];
      }
      a.counts[0] = m;
      a.counts[1] = l;
    }
  }
}

// A persistent cooperative grid: CTA j walks its run of tiles (256
// entries of one page, one a thread) in page order, with no barrier a
// tile: each thread reads its entry's valid flag, verdict and key run
// straight from device memory (the warp's runs are contiguous, so the
// words coalesce and L1 serves their neighbours), prefetches its value run
// into L1, and tests the terms in registers. The CTA meets only where the
// page's block changes, to rebuild the block state. Enough warps stay
// resident to cover the loads' latency.
// 5 CTAs an SM: ptxas keeps every build within 48 registers and none
// spills (at 6 and more some spill; run I-series, PERF.md PR 13)
template <typename KR, typename VR>
__global__ void __launch_bounds__(kThreads, 5) k1_kernel(const K1Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  K1Block& blk = *(K1Block*)(smem + a.s_pat);
  uint32_t* bits = (uint32_t*)(smem + a.s_bits);
  int32_t* rng = (int32_t*)(smem + a.s_rng);
  int* red = (int*)(smem + a.s_red);          // [kK1Warps][2]
  const int tid = threadIdx.x;
  const int t0 = (int)((int64_t)blockIdx.x * a.tiles / gridDim.x);
  const int t1 = (int)((int64_t)(blockIdx.x + 1) * a.tiles / gridDim.x);
  int page = t0 / a.tpp;                      // no division past this one
  int sub = t0 - page * a.tpp;
  if (tid == 0) blk.b = -1;
  __syncthreads();
  int n_match = 0, n_live = 0;
  for (int tile = t0; tile < t1; ++tile) {
    const int e = sub * kThreads + tid;
    const int64_t i = (int64_t)page * a.E + e;
    const int32_t b = a.page_block == nullptr ? 0
                                              : __ldg(a.page_block + page);
    if (++sub == a.tpp) {
      sub = 0;
      ++page;
    }
    if (b >= 0 && b != blk.b) {   // the same tile in every thread
      __syncthreads();        // no thread still reads the old state
      k1_rebuild<KR>(a, blk, bits, rng, b);
      __syncthreads();
    }
    if (e >= a.E) continue;
    // the key and value runs of up to 16 bytes load with the valid flag,
    // not after it: entries are nearly all live, and a latency saved here
    // is one less in each entry's chain
    Run16 kr, vr;
    if (b >= 0) {
      if (a.kbytes <= 16)
        kr.load((const char*)a.kv_key + i * a.kbytes, a.kbytes);
      if (a.vbytes <= 16)
        vr.load((const char*)a.kv_val + i * a.vbytes, a.vbytes);
    }
    const bool live = b >= 0 && a.entry_valid[i] != 0;
    bool match = live;
    if (match && a.verdicts != nullptr) match = a.verdicts[i] != 0;
    if (match)
      match = k1_terms<KR, VR>(a, i, blk, bits, kr, vr);
    // the entry columns are read only for entries that passed the terms,
    // and a bound that admits every value reads no column
    int32_t score = -1;
    if (match)
      match = k1_bounds(
          a, i,
          a.dur_lo != 0u || a.dur_hi != 0xFFFFFFFFu ? dur_raw(a.dur, i) : 0u,
          a.win_start != 0u ? a.entry_end[i] : 0u, score);
    a.scores[i] = score;
    n_match += match;
    n_live += live;
  }
  k1_counts(a, red, n_match, n_live);
}

// K1 and K1s for a request without terms (a duration or window bound, or
// structural verdicts alone): no kv slot is read, and every live entry
// reads the bounds' columns, so the kernel streams them with no stage:
// each thread takes 4 consecutive entries of a tile (1,024 entries of one
// page), their valid flags, verdicts, durations and ends in one vector
// load each (kVec: the page length and the columns keep 4 entries
// aligned; else one entry at a time), and reads the starts only of the
// entries that pass. A persistent cooperative grid of short-lived warps
// (no barrier a tile) keeps enough loads in flight.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) k1_cols_kernel(const K1Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* red = (int*)smem;                      // [kK1Warps][2]
  const int tid = threadIdx.x;
  const int64_t t0 = (int64_t)blockIdx.x * a.tiles / gridDim.x;
  const int64_t t1 = (int64_t)(blockIdx.x + 1) * a.tiles / gridDim.x;
  const bool by_dur = a.dur_lo != 0u || a.dur_hi != 0xFFFFFFFFu;
  int64_t page = t0 / a.tpp;
  int sub = (int)(t0 - page * a.tpp);
  int n_match = 0, n_live = 0;
  for (int64_t tile = t0; tile < t1; ++tile) {
    const int e0 = sub * a.te;
    const int ne = min(a.te, a.E - e0);
    const int64_t base = page * a.E + e0;
    const bool pad = a.page_block != nullptr && __ldg(a.page_block + page) < 0;
    if (++sub == a.tpp) {
      sub = 0;
      ++page;
    }
    if (kVec) {
      const int e = 4 * tid;
      if (e >= ne) continue;
      const int64_t i = base + e;
      if (pad) {
        *(int4*)(a.scores + i) = make_int4(-1, -1, -1, -1);
        continue;
      }
      const uchar4 v4 = *(const uchar4*)(a.entry_valid + i);
      uchar4 d4 = make_uchar4(1, 1, 1, 1);
      if (a.verdicts != nullptr) d4 = *(const uchar4*)(a.verdicts + i);
      uint4 q = make_uint4(0, 0, 0, 0), en = make_uint4(0, 0, 0, 0);
      if (by_dur) {
        if (a.dbytes == 4) {
          q = *(const uint4*)((const uint32_t*)a.dur.dur + i);
        } else {
          const ushort4 h = *(const ushort4*)((const uint16_t*)a.dur.dur + i);
          q = make_uint4(h.x, h.y, h.z, h.w);
        }
      }
      if (a.win_start != 0u) en = *(const uint4*)(a.entry_end + i);
      const bool lv[4] = {v4.x != 0, v4.y != 0, v4.z != 0, v4.w != 0};
      const bool vd[4] = {d4.x != 0, d4.y != 0, d4.z != 0, d4.w != 0};
      const uint32_t qs[4] = {q.x, q.y, q.z, q.w};
      const uint32_t es[4] = {en.x, en.y, en.z, en.w};
      int32_t sc[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        sc[k] = -1;
        const bool m = lv[k] && vd[k] && k1_bounds(a, i + k, qs[k], es[k],
                                                   sc[k]);
        n_match += m;
        n_live += lv[k];
      }
      *(int4*)(a.scores + i) = make_int4(sc[0], sc[1], sc[2], sc[3]);
    } else {
      for (int e = tid; e < ne; e += kThreads) {
        const int64_t i = base + e;
        int32_t sc = -1;
        if (!pad) {
          const bool live = a.entry_valid[i] != 0;
          n_live += live;
          if (live && (a.verdicts == nullptr || a.verdicts[i] != 0))
            n_match += k1_bounds(
                a, i, by_dur ? dur_raw(a.dur, i) : 0u,
                a.win_start != 0u ? a.entry_end[i] : 0u, sc);
        }
        a.scores[i] = sc;
      }
    }
  }
  k1_counts(a, red, n_match, n_live);
}

// A cooperative launch of a K1 kernel over a.tiles: as many CTAs as fit
// on the card (at most kK1MaxGrid), the resident count kept in `occ` for
// the shared-memory size last asked. The allowance is raised to the whole
// 227 KB, never to this call's size: other host threads launch the same
// kernel.
template <typename Kern>
int k1_launch(Kern kern, std::atomic<long long>& occ, K1Args& a, int smem,
              int64_t n, void* out, int64_t out_ints, cudaStream_t s) {
  cudaError_t rc = cudaSuccess;
  if (smem > 48 * 1024)
    rc = cudaFuncSetAttribute((const void*)kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemMax);
  int per_sm = 0, dev = 0, sms = 0;
  const long long known = occ.load(std::memory_order_relaxed);
  if (known >= 0 && (known >> 8) == smem) {
    per_sm = (int)(known & 255);
  } else if (rc == cudaSuccess) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                       kThreads, smem);
    if (rc == cudaSuccess)
      occ.store(((long long)smem << 8) | (per_sm & 255),
                std::memory_order_relaxed);
  }
  if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return (int)rc;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int64_t grid = (int64_t)per_sm * sms;
  if (grid > kK1MaxGrid) grid = kK1MaxGrid;
  if (grid > a.tiles) grid = a.tiles;
  if (out_ints < n + 2 + 2 * grid) return (int)cudaErrorInvalidValue;
  a.scores = (int32_t*)out;
  a.counts = a.scores + n;
  a.partials = a.counts + 2;
  void* args[] = {(void*)&a};
  return (int)cudaLaunchCooperativeKernel((const void*)kern,
                                          dim3((unsigned)grid),
                                          dim3(kThreads), args, (size_t)smem,
                                          s);
}

}  // namespace

extern "C" {

// K1 and K1s: one launcher, given a descriptor of the call (int64 each,
// in the order of the K1Desc enum; kernels/scan.py builds it once per
// staged batch and predicate). key/val layout: the kv columns' Layout
// (both unpacked or both packed; without page_block, K1s, the unpacked
// pair is int32/int32). dur_shift: -1 = u32 durations, 0 = exact u16,
// s > 0 = u16 buckets with an s-bit residual of res_bytes bytes.
// val_hits: null (range mode), [G, t_stride, n_vals] with block_group
// [B] (K1), or [t_stride, n_vals] on every page (K1s: page_block and
// block_group null); bytes, or words with hit_words. verdicts: u8
// [P * E] structural verdicts, or null. out: int32 [out_ints] of at
// least P * E + 2 + 2 * kK1MaxGrid, receiving the scores, then the two
// counts (match count, inspected), then the CTAs' partial counts.
// Returns the cudaError_t of the launch (0 = launched).
enum K1Desc {
  kdKeyLayout, kdValLayout, kdKvKey, kdKvVal, kdStart, kdEnd, kdDur,
  kdDurRes, kdDurShift, kdResBytes, kdValid, kdPageBlock, kdTermKeys,
  kdValRanges, kdValHits, kdHitWords, kdBlockGroup, kdP, kdE, kdC,
  kdNTerms, kdTStride, kdR, kdNVals, kdDurLo, kdDurHi, kdWinStart,
  kdWinEnd, kdCount
};

int tt_scan_k1_desc_len() { return kdCount; }

int tt_scan_k1_max_grid() { return kK1MaxGrid; }

int tt_scan_k1(const int64_t* d, const void* verdicts, void* out,
               int64_t out_ints, void* stream) {
  auto ptr = [&](int k) { return (const void*)(uintptr_t)d[k]; };
  const int kl = (int)d[kdKeyLayout], vl = (int)d[kdValLayout];
  const int64_t P = d[kdP];
  K1Args a;
  a.kv_key = ptr(kdKvKey);
  a.kv_val = ptr(kdKvVal);
  a.entry_start = (const uint32_t*)ptr(kdStart);
  a.entry_end = (const uint32_t*)ptr(kdEnd);
  a.dur = DurCol{ptr(kdDur), ptr(kdDurRes), (int)d[kdDurShift],
                 (int)d[kdResBytes]};
  a.entry_valid = (const uint8_t*)ptr(kdValid);
  a.page_block = (const int32_t*)ptr(kdPageBlock);
  a.term_keys = (const int32_t*)ptr(kdTermKeys);
  a.val_ranges = (const int32_t*)ptr(kdValRanges);
  a.val_hits = ptr(kdValHits);
  a.hit_words = (int)d[kdHitWords];
  a.block_group = (const int32_t*)ptr(kdBlockGroup);
  a.verdicts = (const uint8_t*)verdicts;
  a.E = (int)d[kdE];
  a.C = (int)d[kdC];
  a.n_terms = (int)d[kdNTerms];
  a.t_stride = (int)d[kdTStride];
  a.R = (int)d[kdR];
  a.n_vals = d[kdNVals];
  a.dur_lo = (uint32_t)d[kdDurLo];
  a.dur_hi = (uint32_t)d[kdDurHi];
  a.win_start = (uint32_t)d[kdWinStart];
  a.win_end = (uint32_t)d[kdWinEnd];
  const bool single = a.page_block == nullptr;
  if (P <= 0 || a.E <= 0) return 0;
  if ((single ? a.block_group != nullptr
              : (a.val_hits == nullptr) != (a.block_group == nullptr)) ||
      !valid_dur(a.dur.shift, a.dur.res_bytes, a.dur.res) ||
      !valid_layouts(kl, vl, a.C) || a.C < 1 || a.n_terms < 0 ||
      a.n_terms > a.t_stride || a.R < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t n = P * a.E;
  cudaStream_t s = (cudaStream_t)stream;
  a.dbytes = a.dur.shift < 0 ? 4 : 2;
  if (a.n_terms == 0) {
    // no terms: the streaming kernel, 4 entries a thread, tiles of 1,024
    // entries of a page; vectors where the page length and the columns
    // keep 4 entries aligned
    a.te = a.E < 4 * kThreads ? (a.E + 3) & ~3 : 4 * kThreads;
    a.tpp = (a.E + a.te - 1) / a.te;
    a.tiles = P * a.tpp;
    auto al = [](const void* p, int b) { return ((uintptr_t)p % b) == 0; };
    const bool vec = a.E % 4 == 0 && al(a.entry_valid, 4) &&
                     al(a.verdicts, 4) && al(a.dur.dur, 4 * a.dbytes) &&
                     al(a.entry_end, 16) && al(out, 16);
    static std::atomic<long long> occ_vec{-1}, occ_one{-1};
    if (vec)
      return k1_launch(k1_cols_kernel<true>, occ_vec, a, kK1Warps * 8, n,
                       out, out_ints, s);
    return k1_launch(k1_cols_kernel<false>, occ_one, a, kK1Warps * 8, n, out,
                     out_ints, s);
  }
  // terms: tiles of 256 entries of a page, one a thread
  a.kbytes = slot_bytes(kl, a.C);
  a.vbytes = slot_bytes(vl, a.C);
  a.te = kThreads;
  a.tpp = (a.E + kThreads - 1) / kThreads;
  a.tiles = P * a.tpp;
  if (a.tiles > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  // the block state: the terms' lane values (and the mask of those a lane
  // can hold), the value bitmaps of range blocks (R <= 16, range mode)
  // and their ranges, the counts
  a.bits = a.R <= kK1BitMaxR && a.val_hits == nullptr;
  a.s_pat = 0;
  a.s_bits = a.s_pat + (int)((sizeof(K1Block) + 15) & ~(size_t)15);
  a.s_rng = a.s_bits + (a.bits ? kK1BitTerms * kK1BitWords * 4 : 0);
  a.s_red = a.s_rng + (a.bits ? kK1BitTerms * kK1BitMaxR * 8 : 0);
  const int smem = a.s_red + kK1Warps * 8;
  auto go = [&](auto k, auto v) -> int {
    static std::atomic<long long> occ{-1};
    return k1_launch(k1_kernel<decltype(k), decltype(v)>, occ, a, smem, n,
                     out, out_ints, s);
  };
  if (single) return with_readers<true>(kl, vl, go);
  return with_readers<false>(kl, vl, go);
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
