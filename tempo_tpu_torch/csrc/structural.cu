// K6 structural_mask: structural trace verdicts, one u8 per entry and
// query lane, from a slot program over the staged span segment.
//
// Replaces tempo_tpu/search/structural.py `structural_entry_mask`
// (TPU kernel B8) and what it runs: `_span_mask`, `_trace_mask` and
// `_seg_count` for an exact plan, `_bucket_span_regs` and
// `_bucket_trace_mask` for a shape-bucketed group. Every plan arrives
// flattened into the reference's slot programs (structural.py
// `_flatten_plan`, which it states gives the static plan's verdicts), so
// one interpreter serves both forms:
//
//   span rows  [NS][4] = (opcode, a, b, 0); register 0 is all-false,
//     slot i writes register i + 1 over the spans:
//     1 tag   a = term       any slot c: key == term_keys[blk, a] and the
//                            value in its ranges or hit row (slot_hit)
//     2 dur   a = dur row    dur_params[a][0] <= span_dur <= [a][1]
//     3 kind  a = kind row   span_kind == kind_params[a]
//     4 and / 5 or           reg a, reg b
//     6 not                  !reg a
//     7 child                reg b here and reg a at the parent
//     8 desc                 reg b here and reg a at some ancestor
//     (leaves and not also require a real span, span_trace >= 0)
//   trace rows [NT][4] = (opcode, a, b, c) over the entries:
//     1 ttag  a = term       the entry's kv slots, as K1 tests a term
//     2 tdur  a = dur row    dur_ok on the entry duration (any layout)
//     3 exists a = span reg  count > 0
//     4 count a, b = agg row, c = compare code: count CMP agg[b][0]
//     5 q     nearest-rank quantile as integer rank counts:
//             r = (qn*n + qd - 1) / qd, ok_hi: #(dur >(=) x) >= n - r + 1,
//             ok_lo: #(dur <(=) x) >= r, all uint32 (wrapping as the
//             reference's), and n > 0
//     6 and / 7 or / 8 not   trace registers
//   the verdict is register NT (the last slot: the root copy), and the
//   entry must be valid on a real page. Register indices clamp to
//   [0, slot] and table rows to their tables, as the reference's clipped
//   gathers do. Without a span segment (span_parent null) exists and q
//   are false and count compares 0.
//
// The cycles the container format allows (a span its own parent, A->B->A)
// give the reference's pointer doubling every span reachable by one or
// more parent steps; `desc` here walks at most the trace's span count of
// steps, which visits that same set. The staging check
// (search/structural.py check_span_segment) guarantees each entry's spans
// are its run [begin, begin + count) and parents stay inside it.
//
// Design, for the H100 (bound by bytes in principle; the accesses are
// irregular and a span's work is short, so no tensor core or TMA work).
// A persistent grid of CTAs of kThreads threads, every lane of the
// launch in one CTA; each CTA takes a contiguous share of the entries,
// window by window:
//   1. a window of up to kWindow entries: validity and run lengths, an
//      exclusive scan, and the longest prefix whose runs fit `cap` spans
//      (cap_of: kTileSpans, or fewer where wide span rows would pass
//      kTileRowBytes) is the tile;
//      the next window starts past it. A tile's runs are gathered into
//      shared memory at their entries' offsets by cp.async, parents
//      rebased to rows (sound: runs are disjoint and parents stay inside
//      them). A span's columns are read from device memory once a launch,
//      whatever Q; columns no lane reads are not read; runs out of entry
//      order and invalid entries' spans cost nothing.
//   2. per lane: the span program, kRows rows a thread, their registers
//      in the thread's own registers, one dispatch a slot. Leaf and
//      boolean slots need no barrier; before a child or desc slot each
//      thread publishes the register word that slot reads at the parent,
//      then one __syncthreads. desc walks the ancestors in shared memory,
//      at most the run's length of steps (cycles end there).
//   3. per lane, after publishing the registers: kGroup lanes of a warp
//      per entry run the trace program; segment counts and the quantile's
//      c_hi/c_lo come from __ballot_sync/__popc over the run's bits in
//      shared memory, kGroup spans a step; the trace registers spread
//      over the group.
// An entry whose run passes `cap` is taken by its CTA alone over global
// scratch [grid][span_words][max_run] (max_run at least the longest run;
// the grid is the launch's, clamped to the occupancy), every
// slot's bits straight in device memory. The lane tables (programs, term
// keys, ranges, parameters, hit-table rows) are copied into shared memory
// once a CTA, or read in place when they would not fit; hit tables stay
// in device memory. No allocation but the verdicts (and the scratch when
// a run passes `cap`). On the H100 at the structural cell's shape the
// kernel is bound by its instructions and latencies, not bytes (PERF.md).

#include <algorithm>
#include <vector>

#include <cuda_pipeline.h>

#include "scan_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                      // span rows a thread holds
constexpr int kTileSpans = kThreads * kRows;  // 1,024: the most a tile holds
constexpr int kWindow = 128;                  // entries a tile takes, at most
constexpr int kMaxLanes = 32;                 // lanes a launch takes
constexpr int kGroup = 4;                     // lanes of a warp an entry
constexpr int kMaxRegWords = 8;               // registers a program, <= 256
constexpr int kMaxSmem = 232448 - 1024;       // 227 KB a block, less the
                                              // static shared memory
constexpr int kTileRowBytes = 160 * 1024;     // a tile's rows, at most
constexpr unsigned kFull = 0xFFFFFFFFu;
static_assert(2 * kGroup >= kMaxRegWords, "a group holds 8 trace words");
enum Need : int { kNeedKv = 1, kNeedDur = 2, kNeedKind = 4, kNeedPar = 8 };

// The kv reader of a runtime layout (K6 is not specialised per layout):
// each read builds the layout's shared reader (scan_common.cuh), so the
// decoding of every layout lives in one place.
struct Dyn {
  const void* base;
  int layout;
  int64_t i;
  int C;
  template <typename R>
  __device__ __forceinline__ int32_t read(R r, int c) const {
    r.at(base, i, C);
    return r[c];
  }
  __device__ __forceinline__ int32_t operator[](int c) const {
    switch (layout) {
      case kIds8: return read(Ids<int8_t>{}, c);
      case kIds16: return read(Ids<int16_t>{}, c);
      case kIds32: return read(Ids<int32_t>{}, c);
      case kU4: return read(Nibbles{}, c);
      case kU8: return read(Codes<uint8_t>{}, c);
      case kU16: return read(Codes<uint16_t>{}, c);
      default: return read(Codes<uint32_t>{}, c);
    }
  }
};

// A span's kv slots in a tile: slot c at stride `cap`.
struct Strided {
  const int32_t* p;
  int stride;
  __device__ __forceinline__ int32_t operator[](int c) const {
    return p[c * stride];
  }
};

struct K6Args {
  // entries
  const void* kv_key;
  const void* kv_val;
  int key_layout, val_layout;
  DurCol dur;
  const bool* entry_valid;       // [n]
  const int32_t* page_block;     // [n / E]
  int64_t n;
  int E, C;
  // the span segment; span_parent null: a batch without spans
  const int32_t* span_trace;     // [S]
  const int32_t* span_parent;
  const int32_t* span_block;
  const uint32_t* span_dur;
  const int8_t* span_kind;
  const int32_t* span_kv_key;    // [S, Cs]
  const int32_t* span_kv_val;
  int Cs;
  const int32_t* seg_begin;      // [n]
  const int32_t* seg_count;
  int cap;                       // spans a tile holds
  uint32_t* scratch;             // [grid][span_words][max_run] or null
  int max_run;
  int span_words;                // register words a span program needs
  // this launch's lanes
  int Q, B, T, R, D, K, A, NS, NT;
  const int32_t* span_prog;      // [Q, NS, 4]
  const int32_t* trace_prog;     // [Q, NT, 4]
  const int32_t* term_keys;      // [Q, B, T]
  const int32_t* val_ranges;     // [Q, B, T, R, 2]
  const uint32_t* dur_params;    // [Q, D, 2]
  const int32_t* kind_params;    // [Q, K]
  const uint32_t* agg_params;    // [Q, A, 3]
  const int32_t* block_group;    // [Q, B] or null (no hit tables)
  int64_t hit[kMaxLanes * 3];    // per lane: address (0: none), T, row
  int hit_words;                 //   length in elements
  int table_words;               // the tables in shared memory; 0: in place
  uint8_t* verdicts;             // [Q, n]
};

// The launch's lane tables, in shared memory or in place.
struct Tables {
  const int32_t* sprog;
  const int32_t* tprog;
  const int32_t* tk;
  const int32_t* vr;
  const uint32_t* dp;
  const int32_t* kp;
  const uint32_t* ap;
  const int32_t* bg;
  const int64_t* hit;
};

// Byte offsets of the dynamic shared memory a CTA uses.
struct SmemPlan {
  int tables, off, cnt, beg, eblk, ok, bits, kk, vv, dur, blk, trace, par,
      kind, total;
};

__host__ __device__ inline int align16(int o) { return (o + 15) & ~15; }

__host__ __device__ inline SmemPlan layout_of(int table_words, int cap,
                                              int Cs, int sw) {
  SmemPlan L;
  int o = 0;
  L.tables = o;
  o = align16(o + table_words * 4);
  L.off = o;
  o += kWindow * 4;
  L.cnt = o;
  o += kWindow * 4;
  L.beg = o;
  o += kWindow * 4;
  L.eblk = o;
  o += kWindow * 4;
  L.ok = o;
  o = align16(o + kWindow);
  L.bits = o;
  o += sw * cap * 4;
  L.kk = o;
  o += Cs * cap * 4;
  L.vv = o;
  o += Cs * cap * 4;
  L.dur = o;
  o += cap * 4;
  L.blk = o;
  o += cap * 4;
  L.trace = o;
  o += cap * 4;
  L.par = o;
  o += cap * 4;
  L.kind = o;
  o += cap;
  L.total = align16(o);
  return L;
}

// Span rows a tile holds for spans of Cs kv slots: kTileSpans, or the
// most (a multiple of 32, maybe 0) whose layout at 8 register words
// stays within kTileRowBytes. A longer run goes through scratch.
inline int cap_of(int Cs) {
  int cap = kTileSpans;
  while (cap > 0 && layout_of(0, cap, Cs, kMaxRegWords).total > kTileRowBytes)
    cap -= 32;
  return cap;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ bool cmp_code(uint32_t x, uint32_t y, int c) {
  switch (c) {
    case 0: return x > y;
    case 1: return x >= y;
    case 2: return x < y;
    case 3: return x <= y;
    case 4: return x == y;
    default: return x != y;
  }
}

// Any of the slots c0, c0 + step, ... < C against term t of lane q and
// block row blk (term index clamped to the tables; the hit row clamped
// to the lane's own table).
template <typename KR, typename VR>
__device__ __forceinline__ bool term_hit(const K6Args& a, const Tables& tb,
                                         int q, int blk, int t, const KR& kk,
                                         const VR& vv, int c0, int C,
                                         int step) {
  t = clampi(t, 0, a.T - 1);
  const int64_t row = ((int64_t)q * a.B + blk) * a.T + t;
  const int32_t key = tb.tk[row];
  const int32_t* rg = tb.vr + row * a.R * 2;
  const void* h = nullptr;
  int64_t nv = 0;
  const bool words = a.hit_words != 0;
  if (tb.bg != nullptr) {
    const int32_t g = tb.bg[(int64_t)q * a.B + blk];
    const int64_t base = tb.hit[3 * q];
    if (g >= 0 && base != 0) {
      const int64_t ts = tb.hit[3 * q + 1];
      nv = tb.hit[3 * q + 2];
      h = hit_row((const void*)(uintptr_t)base,
                  (int64_t)g * ts + (t < ts ? t : ts - 1), nv, words);
    }
  }
  for (int c = c0; c < C; c += step)
    if (slot_hit(kk, vv, c, key, rg, a.R, h, nv, words)) return true;
  return false;
}

// A thread's register words of one span row.
template <int SW>
struct Bits {
  uint32_t w[SW];
  __device__ __forceinline__ uint32_t word(int i) const {
    uint32_t x = 0;
#pragma unroll
    for (int k = 0; k < SW; ++k)
      if (k == i) x = w[k];
    return x;
  }
  __device__ __forceinline__ bool operator()(int r) const {
    return (word(r >> 5) >> (r & 31)) & 1u;
  }
  __device__ __forceinline__ void set(int r) {
#pragma unroll
    for (int k = 0; k < SW; ++k)
      if (k == (r >> 5)) w[k] |= 1u << (r & 31);
  }
};

// A tile group's span rows [0, n) in shared memory.
struct TileRows {
  uint32_t* bits;                // [SW][cap], published words
  int32_t* kk;                   // [Cs][cap]
  int32_t* vv;
  uint32_t* dur_;
  int32_t* blk_;
  int32_t* trace;                // span_trace
  int32_t* par;                  // the run length << 16 | the parent's row
                                 // (int16, -1: none)
  int8_t* kind_;
  int cap;
  __device__ __forceinline__ bool real(int r) const { return trace[r] >= 0; }
  __device__ __forceinline__ int blk(int r) const { return blk_[r]; }
  __device__ __forceinline__ uint32_t dur(int r) const { return dur_[r]; }
  __device__ __forceinline__ int kind(int r) const { return kind_[r]; }
  __device__ __forceinline__ int parent(int r) const {
    return (int16_t)(par[r] & 0xFFFF);
  }
  __device__ __forceinline__ int steps(int r) const {
    return (uint32_t)par[r] >> 16;
  }
  __device__ __forceinline__ Strided keys(int r) const {
    return Strided{kk + r, cap};
  }
  __device__ __forceinline__ Strided vals(int r) const {
    return Strided{vv + r, cap};
  }
  __device__ __forceinline__ bool bit(int r, int reg) const {
    return (bits[(reg >> 5) * cap + r] >> (reg & 31)) & 1u;
  }
};

// One long run [b, b + cnt) read in place, its registers in global
// scratch [span_words][max_run].
struct RunRows {
  const K6Args* a;
  uint32_t* bits;
  int64_t b;
  int cnt;
  int stride;
  __device__ __forceinline__ bool real(int j) const {
    return a->span_trace[b + j] >= 0;
  }
  __device__ __forceinline__ int blk(int j) const {
    return a->span_block[b + j];
  }
  __device__ __forceinline__ uint32_t dur(int j) const {
    return a->span_dur[b + j];
  }
  __device__ __forceinline__ int kind(int j) const {
    return a->span_kind[b + j];
  }
  __device__ __forceinline__ int parent(int j) const {
    const int64_t p = a->span_parent[b + j];
    return p >= b && p < b + cnt ? (int)(p - b) : -1;
  }
  __device__ __forceinline__ int steps(int) const { return cnt; }
  __device__ __forceinline__ Ids<int32_t> keys(int j) const {
    return Ids<int32_t>{a->span_kv_key + (b + j) * a->Cs};
  }
  __device__ __forceinline__ Ids<int32_t> vals(int j) const {
    return Ids<int32_t>{a->span_kv_val + (b + j) * a->Cs};
  }
  __device__ __forceinline__ bool bit(int j, int reg) const {
    return (bits[(int64_t)(reg >> 5) * stride + j] >> (reg & 31)) & 1u;
  }
};

// Span slot `opc` at row r; `own(reg)` reads the row's own registers.
template <class Rows, class Own>
__device__ __forceinline__ bool span_value(const K6Args& a, const Tables& tb,
                                           int q, const Rows& rows, int r,
                                           bool real, int blk, int opc,
                                           int ia, int ra, int rb,
                                           const Own& own) {
  switch (opc) {
    case 1:
      return real && term_hit(a, tb, q, blk, ia, rows.keys(r), rows.vals(r),
                              0, a.Cs, 1);
    case 2: {
      const uint32_t* d = tb.dp + (q * a.D + clampi(ia, 0, a.D - 1)) * 2;
      const uint32_t x = rows.dur(r);
      return real && x >= d[0] && x <= d[1];
    }
    case 3:
      return real && rows.kind(r) == tb.kp[q * a.K + clampi(ia, 0, a.K - 1)];
    case 4: return own(ra) && own(rb);
    case 5: return own(ra) || own(rb);
    case 6: return real && !own(ra);
    case 7: {
      const int p = rows.parent(r);
      return own(rb) && p >= 0 && rows.bit(p, ra);
    }
    case 8: {   // desc: a bounded walk up the ancestors
      if (!own(rb)) return false;
      const int steps = rows.steps(r);
      int p = rows.parent(r);
      for (int s = 0; s < steps && p >= 0; ++s) {
        if (rows.bit(p, ra)) return true;
        p = rows.parent(p);
      }
      return false;
    }
    default: return false;
  }
}

// Trace register x of this lane's group: its 8 words spread over the
// group's kGroup lanes, word w in lane w % kGroup, in m0 for w < kGroup
// and m1 past it (x is the same on every lane of the warp).
__device__ __forceinline__ bool tbit(uint32_t m0, uint32_t m1, int x) {
  const int base = threadIdx.x & 31 & ~(kGroup - 1), w = x >> 5;
  const uint32_t v = __shfl_sync(kFull, w < kGroup ? m0 : m1,
                                 base + (w & (kGroup - 1)));
  return (v >> (x & 31)) & 1u;
}

// One warp, kGroup lanes an entry: lane q's trace program over entry i of
// this lane's group (`has`: a valid entry; the others only keep step),
// its span rows [off, off + cnt) of `rows`; the verdict into out[i].
template <class Rows>
__device__ __forceinline__ void trace_group(
    const K6Args& a, const Tables& tb, int q, const Rows& rows, bool has,
    int64_t i, int blk, int off, int cnt, bool spans, uint8_t* out) {
  const int lane = threadIdx.x & 31, gl = lane & (kGroup - 1);
  const unsigned gmask = ((1u << kGroup) - 1) << (lane & ~(kGroup - 1));
  const int32_t* prog = tb.tprog + (int64_t)q * a.NT * 4;
  if (!has) cnt = 0;
  uint32_t m0 = 0, m1 = 0;
  for (int s = 0; s < a.NT; ++s) {
    const int opc = prog[4 * s], ia = prog[4 * s + 1], ib = prog[4 * s + 2],
              ic = prog[4 * s + 3];
    bool v = false;
    switch (opc) {
      case 1: {
        bool hit = false;
        if (has) {
          const Dyn kk{a.kv_key, a.key_layout, i, a.C};
          const Dyn vv{a.kv_val, a.val_layout, i, a.C};
          hit = term_hit(a, tb, q, blk, ia, kk, vv, gl, a.C, kGroup);
        }
        v = (__ballot_sync(kFull, hit) & gmask) != 0;
        break;
      }
      case 2: {
        if (has) {
          const uint32_t* d =
              tb.dp + ((int64_t)q * a.D + clampi(ia, 0, a.D - 1)) * 2;
          v = dur_ok(a.dur, i, dur_raw(a.dur, i), d[0], d[1]);
        }
        break;
      }
      case 3:
      case 4:
      case 5: {
        const int r = clampi(ia, 0, a.NS);
        const uint32_t* g =
            tb.ap + ((int64_t)q * a.A + clampi(ib, 0, a.A - 1)) * 3;
        const uint32_t x = g[2];
        const int most = __reduce_max_sync(kFull, cnt);
        uint32_t n = 0, c_hi = 0, c_lo = 0;
        for (int j0 = 0; j0 < most; j0 += kGroup) {
          const int j = j0 + gl;
          const bool m = j < cnt && rows.bit(off + j, r);
          n += __popc(__ballot_sync(kFull, m) & gmask);
          if (opc == 5) {
            const uint32_t d = m ? rows.dur(off + j) : 0u;
            c_hi += __popc(__ballot_sync(kFull, m && (ic == 0 ? d > x
                                                              : d >= x))
                           & gmask);
            c_lo += __popc(__ballot_sync(kFull, m && (ic == 2 ? d < x
                                                              : d <= x))
                           & gmask);
          }
        }
        if (opc == 3) {
          v = spans && n > 0;
        } else if (opc == 4) {
          v = cmp_code(n, g[0], ic);
        } else if (spans && n > 0) {
          const uint32_t qd = max(g[1], 1u);
          const uint32_t rank = (g[0] * n + qd - 1u) / qd;
          const bool ok_hi = c_hi >= n - rank + 1u;
          const bool ok_lo = c_lo >= rank;
          const bool eq = ok_hi && ok_lo;
          v = ic <= 1 ? ok_hi : ic <= 3 ? ok_lo : ic == 4 ? eq : !eq;
        }
        break;
      }
      case 6:
      case 7: {   // both shuffles on every lane: the groups differ
        const bool x = tbit(m0, m1, clampi(ia, 0, s));
        const bool y = tbit(m0, m1, clampi(ib, 0, s));
        v = opc == 6 ? x && y : x || y;
        break;
      }
      case 8: v = !tbit(m0, m1, clampi(ia, 0, s)); break;
      default: break;
    }
    const int w = (s + 1) >> 5;
    if (v && gl == (w & (kGroup - 1))) {
      if (w < kGroup) m0 |= 1u << ((s + 1) & 31);
      else m1 |= 1u << ((s + 1) & 31);
    }
  }
  const bool verdict = tbit(m0, m1, a.NT);
  if (has && gl == 0) out[i] = verdict ? 1 : 0;
}

// The CTA's window of entries in shared memory.
struct Tile {
  int* off;                      // [kWindow] exclusive scan of the runs
  int* cnt;                      // run lengths (0: invalid or none)
  int* beg;                      // run begins
  int* blk;                      // page_block
  uint8_t* ok;                   // valid on a real page
};

// The verdicts of entries [0, g1) of the window at c0 for lane q, one
// entry a kGroup of a warp's lanes, their span rows from `rows`.
template <class Rows>
__device__ __forceinline__ void trace_entries(const K6Args& a,
                                              const Tables& tb, const Tile& s,
                                              const Rows& rows, int q,
                                              int64_t c0, int g1) {
  const int tid = threadIdx.x;
  const bool spans = a.span_parent != nullptr;
  const int slot = tid / kGroup;           // this lane's group in the CTA
  uint8_t* out = a.verdicts + (int64_t)q * a.n;
  for (int e0 = 0; e0 < g1; e0 += kThreads / kGroup) {
    const int e = e0 + slot;
    const bool in = e < g1;
    const bool has = in && s.ok[e];
    if (in && !has && (tid & (kGroup - 1)) == 0) out[c0 + e] = 0;
    trace_group(a, tb, q, rows, has, c0 + e, has ? s.blk[e] : 0,
                has ? s.off[e] : 0, has ? s.cnt[e] : 0, spans, out);
  }
}

// Entries [0, g1) of the window at c0 (their runs n <= cap spans in all):
// the runs gathered into shared memory at their offsets, then every lane
// of the launch evaluated over them.
template <int SW>
__device__ __forceinline__ void tile_group(const K6Args& a, const Tables& tb,
                                           const Tile& s, const TileRows& rows,
                                           int need, int64_t c0, int g1) {
  const int tid = threadIdx.x;
  const int n = s.off[g1 - 1] + s.cnt[g1 - 1];
  // gather: rows r = k * kThreads + tid, copied into shared memory by
  // cp.async (kind, a byte, by a plain load), then the parents rebased
  int ent[kRows];
  int8_t kind[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = k * kThreads + tid;
    ent[k] = -1;
    if (r >= n) continue;
    int lo = 0, hi = g1 - 1;  // the last entry with off <= r
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s.off[mid] <= r) lo = mid; else hi = mid - 1;
    }
    ent[k] = lo;
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = k * kThreads + tid;
    if (ent[k] < 0) continue;
    const int e = ent[k];
    const int64_t g = (int64_t)s.beg[e] + (r - s.off[e]);
    __pipeline_memcpy_async(rows.trace + r, a.span_trace + g, 4);
    if (need & kNeedPar)
      __pipeline_memcpy_async(rows.par + r, a.span_parent + g, 4);
    if (need & kNeedDur)
      __pipeline_memcpy_async(rows.dur_ + r, a.span_dur + g, 4);
    if (need & kNeedKind) kind[k] = __ldg(a.span_kind + g);
    if (need & kNeedKv) {
      __pipeline_memcpy_async(rows.blk_ + r, a.span_block + g, 4);
      for (int c = 0; c < a.Cs; ++c) {
        __pipeline_memcpy_async(rows.kk + c * rows.cap + r,
                                a.span_kv_key + g * a.Cs + c, 4);
        __pipeline_memcpy_async(rows.vv + c * rows.cap + r,
                                a.span_kv_val + g * a.Cs + c, 4);
      }
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = k * kThreads + tid;
    if (ent[k] < 0) continue;
    if (need & kNeedKind) rows.kind_[r] = kind[k];
    if (need & kNeedPar) {
      const int e = ent[k];
      const int b = s.beg[e], len = s.cnt[e], at = s.off[e];
      const int32_t p = rows.par[r];
      const int lp = p >= b && p < b + len ? p - b + at : -1;
      rows.par[r] = (len << 16) | (lp & 0xFFFF);
    }
  }
  __syncthreads();
  // bit k: row k * kThreads + tid is a real span of the group
  uint32_t realm = 0;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = k * kThreads + tid;
    if (r < n && rows.real(r)) realm |= 1u << k;
  }
  for (int q = 0; q < a.Q; ++q) {
    if (n > 0) {
      Bits<SW> w[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
#pragma unroll
        for (int x = 0; x < SW; ++x) w[k].w[x] = 0;
      const int32_t* prog = tb.sprog + q * a.NS * 4;
      for (int i = 0; i < a.NS; ++i) {
        const int opc = prog[4 * i], ia = prog[4 * i + 1],
                  ib = prog[4 * i + 2];
        const int ra = clampi(ia, 0, i), rb = clampi(ib, 0, i);
        if (opc == 7 || opc == 8) {
          // publish the word the slot reads at the parent, then wait
          const int wd = ra >> 5;
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            const int r = k * kThreads + tid;
            if (r < n) rows.bits[wd * rows.cap + r] = w[k].word(wd);
          }
          __syncthreads();
        }
        // one dispatch a slot, then its rows (a row past n has no bits
        // and no real flag)
        const int dst = i + 1;
        switch (opc) {
          case 1:
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
              const int r = k * kThreads + tid;
              if (((realm >> k) & 1) &&
                  term_hit(a, tb, q, max(rows.blk(r), 0), ia, rows.keys(r),
                           rows.vals(r), 0, a.Cs, 1))
                w[k].set(dst);
            }
            break;
          case 2: {
            const uint32_t* d = tb.dp + (q * a.D + clampi(ia, 0, a.D - 1)) * 2;
            const uint32_t lo = d[0], hi = d[1];
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
              const uint32_t x = rows.dur(k * kThreads + tid);
              if (((realm >> k) & 1) && x >= lo && x <= hi) w[k].set(dst);
            }
            break;
          }
          case 3: {
            const int want = tb.kp[q * a.K + clampi(ia, 0, a.K - 1)];
#pragma unroll
            for (int k = 0; k < kRows; ++k)
              if (((realm >> k) & 1) &&
                  rows.kind(k * kThreads + tid) == want)
                w[k].set(dst);
            break;
          }
          case 4:
          case 5:
          case 6:
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
              const bool x = w[k](ra), y = w[k](rb);
              if (opc == 4 ? x && y : opc == 5 ? x || y
                                               : ((realm >> k) & 1) && !x)
                w[k].set(dst);
            }
            break;
          case 7:
          case 8:
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
              const int r = k * kThreads + tid;
              if (r >= n || !w[k](rb)) continue;
              // child: the parent; desc: a bounded walk up the ancestors
              const int steps = opc == 7 ? 1 : rows.steps(r);
              int p = rows.parent(r);
              for (int st = 0; st < steps && p >= 0; ++st) {
                if (rows.bit(p, ra)) {
                  w[k].set(dst);
                  break;
                }
                p = rows.parent(p);
              }
            }
            break;
          default: break;
        }
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int r = k * kThreads + tid;
        if (r < n)
#pragma unroll
          for (int x = 0; x < SW; ++x) rows.bits[x * rows.cap + r] = w[k].w[x];
      }
      __syncthreads();
    }
    trace_entries(a, tb, s, rows, q, c0, g1);
    __syncthreads();   // the next lane rewrites the published words
  }
}

// Entry 0 of the window at c0, a run longer than a tile holds: the CTA
// alone, the run read in place, its registers in the CTA's scratch.
template <int SW>
__device__ __forceinline__ void long_entry(const K6Args& a, const Tables& tb,
                                           const Tile& s, int64_t c0) {
  const int tid = threadIdx.x;
  const int cnt = s.cnt[0];
  // staging sizes max_run to the longest run: a longer one would overrun
  // this CTA's scratch, so the launch fails
  if (a.scratch == nullptr || cnt > a.max_run) __trap();
  uint32_t* bits =
      a.scratch + (int64_t)blockIdx.x * a.span_words * a.max_run;
  const RunRows rows{&a, bits, s.beg[0], cnt, a.max_run};
  for (int q = 0; q < a.Q; ++q) {
    for (int j = tid; j < cnt; j += kThreads)
      for (int x = 0; x < a.span_words; ++x)
        bits[(int64_t)x * a.max_run + j] = 0;
    const int32_t* prog = tb.sprog + q * a.NS * 4;
    for (int k = 0; k < a.NS; ++k) {
      const int opc = prog[4 * k], ia = prog[4 * k + 1],
                ib = prog[4 * k + 2];
      const int ra = clampi(ia, 0, k), rb = clampi(ib, 0, k);
      if (opc == 7 || opc == 8) __syncthreads();
      if (opc < 1 || opc > 8) continue;
      const int dst = k + 1;
      for (int j = tid; j < cnt; j += kThreads) {
        const auto own = [&](int reg) { return rows.bit(j, reg); };
        if (span_value(a, tb, q, rows, j, rows.real(j),
                       max(rows.blk(j), 0), opc, ia, ra, rb, own))
          bits[(int64_t)(dst >> 5) * a.max_run + j] |= 1u << (dst & 31);
      }
    }
    __syncthreads();
    if (tid < 32)
      trace_group(a, tb, q, rows, tid < kGroup, c0, s.blk[0], 0, cnt, true,
                  a.verdicts + (int64_t)q * a.n);
    __syncthreads();   // the next lane clears the scratch
  }
}

// The window of entries [c0, c0 + ne), ne <= kWindow: their runs scanned,
// then the longest prefix whose spans fit a tile evaluated (or entry 0
// alone through long_entry when its run does not fit). Returns the
// entries taken; the next window starts past them.
template <int SW>
__device__ __forceinline__ int window(const K6Args& a, const Tables& tb,
                                      const Tile& s, const TileRows& rows,
                                      int need, int64_t c0, int ne) {
  __shared__ int s_warp[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool spans = a.span_parent != nullptr;
  int x = 0;
  if (tid < ne) {
    const int64_t i = c0 + tid;
    const bool valid = a.entry_valid[i];
    const int32_t pb = a.page_block[i / a.E];
    const int32_t len = spans ? a.seg_count[i] : 0;
    const int32_t b = spans ? a.seg_begin[i] : 0;
    const bool ok = valid && pb >= 0;
    const int run = ok ? max(len, 0) : 0;
    s.ok[tid] = ok;
    s.cnt[tid] = run;
    s.beg[tid] = b;
    s.blk[tid] = pb;
    x = min(run, a.cap + 1);   // a longer run counts as cap + 1
  }
  // exclusive scan of x over the window
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    incl += w < warp ? s_warp[w] : 0;
  if (tid < ne) s.off[tid] = incl - x;
  // the entries whose runs end within cap: a prefix, as incl only grows
  const int g1 = __syncthreads_count(tid < ne && incl <= a.cap);
  if (g1 == 0) {
    long_entry<SW>(a, tb, s, c0);
    return 1;
  }
  tile_group<SW>(a, tb, s, rows, need, c0, g1);
  return g1;
}

// A table's words copied into shared memory at dst (advanced past it).
template <typename T>
__device__ const T* stage_table(const T* src, int64_t words, int32_t*& dst) {
  if (src == nullptr) return src;
  const int32_t* s = (const int32_t*)src;
  for (int64_t k = threadIdx.x; k < words; k += kThreads) dst[k] = s[k];
  const T* out = (const T*)dst;
  dst += words;
  return out;
}

// TS: the lane tables copied into shared memory (else read in place).
template <int SW, bool TS>
__global__ void __launch_bounds__(kThreads, SW == 1 ? 3 : 2)
structural_kernel(const K6Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int64_t s_hit[kMaxLanes * 3];
  __shared__ int s_need;
  const int tid = threadIdx.x;
  const SmemPlan L = layout_of(TS ? a.table_words : 0, a.cap, a.Cs, SW);
  // the lane tables, once a CTA
  Tables tb{a.span_prog, a.trace_prog, a.term_keys, a.val_ranges,
            a.dur_params, a.kind_params, a.agg_params, a.block_group,
            s_hit};
  if constexpr (TS) {
    int32_t* dst = (int32_t*)(smem + L.tables);
    const int64_t Q = a.Q;
    tb.sprog = stage_table(a.span_prog, Q * a.NS * 4, dst);
    tb.tprog = stage_table(a.trace_prog, Q * a.NT * 4, dst);
    tb.tk = stage_table(a.term_keys, Q * a.B * a.T, dst);
    tb.vr = stage_table(a.val_ranges, Q * a.B * a.T * a.R * 2, dst);
    tb.dp = stage_table(a.dur_params, Q * a.D * 2, dst);
    tb.kp = stage_table(a.kind_params, Q * a.K, dst);
    tb.ap = stage_table(a.agg_params, Q * a.A * 3, dst);
    tb.bg = stage_table(a.block_group, Q * a.B, dst);
  }
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < kMaxLanes * 3; ++k) s_hit[k] = a.hit[k];
    s_need = 0;
  }
  __syncthreads();
  // the span columns some lane reads
  int need = 0;
  for (int k = tid; k < a.Q * a.NS; k += kThreads) {
    const int op = tb.sprog[4 * k];
    need |= op == 1 ? kNeedKv : op == 2 ? kNeedDur : op == 3 ? kNeedKind
          : op == 7 || op == 8 ? kNeedPar : 0;
  }
  for (int k = tid; k < a.Q * a.NT; k += kThreads)
    if (tb.tprog[4 * k] == 5) need |= kNeedDur;
  if (need) atomicOr(&s_need, need);
  const Tile s{(int*)(smem + L.off), (int*)(smem + L.cnt),
               (int*)(smem + L.beg), (int*)(smem + L.eblk), smem + L.ok};
  const TileRows rows{(uint32_t*)(smem + L.bits), (int32_t*)(smem + L.kk),
                      (int32_t*)(smem + L.vv), (uint32_t*)(smem + L.dur),
                      (int32_t*)(smem + L.blk), (int32_t*)(smem + L.trace),
                      (int32_t*)(smem + L.par), (int8_t*)(smem + L.kind),
                      a.cap};
  __syncthreads();
  need = s_need;
  // the CTA's share of the entries, a contiguous range, window by window
  const int64_t per = (a.n + gridDim.x - 1) / gridDim.x;
  const int64_t end = min(a.n, (blockIdx.x + 1) * per);
  for (int64_t c0 = blockIdx.x * per; c0 < end;)
    c0 += window<SW>(a, tb, s, rows, need, c0,
                     (int)min((int64_t)kWindow, end - c0));
}

// One launch's shape: the variant (span words, tables in shared memory
// or in place), its dynamic shared memory and its grid.
struct Plan {
  void (*kernel)(const K6Args);
  int variant;       // 2 * (SW == 8) + (tables in place)
  int table_words;   // in shared memory; 0: in place
  int smem;
  int grid;
};

// The plan of a launch of `a.Q` lanes whose tables take `table_words`:
// the tables go into shared memory where they and the tile fit, the
// dynamic shared memory is allowed, and the grid is one CTA per kWindow
// entries clamped to what the SMs hold at once. Returns a cudaError_t.
template <int SW>
int plan_of(const K6Args& a, int64_t table_words, Plan& p) {
  int tw = table_words * 4 < kMaxSmem ? (int)table_words : 0;
  SmemPlan L = layout_of(tw, a.cap, a.Cs, SW);
  if (tw == 0 || L.total > kMaxSmem) {    // the tables stay in place
    tw = 0;
    L = layout_of(0, a.cap, a.Cs, SW);
    if (L.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  }
  p.kernel = tw > 0 ? structural_kernel<SW, true>
                    : structural_kernel<SW, false>;
  p.variant = 2 * (SW != 1) + (tw == 0);
  p.table_words = tw;
  p.smem = L.total;
  // always the whole allowance, never this plan's size: dispatches on
  // other host threads launch the same kernel, and a smaller allowance set
  // between their set and their launch would fail it
  cudaError_t e = cudaFuncSetAttribute(
      p.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, p.kernel, kThreads, L.total)) != cudaSuccess)
    return (int)e;
  p.grid = (int)std::max<int64_t>(
      1, std::min<int64_t>((a.n + kWindow - 1) / kWindow,
                           (int64_t)std::max(1, per_sm) * sms));
  return 0;
}

}  // namespace

extern "C" {

// The span rows a K6 tile holds for spans of Cs kv slots (cap_of).
int tt_structural_cap(int Cs) { return cap_of(Cs); }

// K6. Entry columns as for K1 (layouts, durations); the span segment
// (span_parent null: none) and max_run, at least its longest run; Q
// lanes of programs and tables (block_group and hit_meta both null or
// both set; hit_meta on the host, [Q, 3]), one launch per kMaxLanes
// lanes. verdicts [Q, n]. When some run is longer than a tile holds
// (tt_structural_cap), the launches need scratch of grid * span_words *
// max_run u32: *scratch_words holds the words `scratch` has and is set
// to those the launches need; when they need more, nothing is launched.
// Returns the cudaError_t of the launches (0 = launched or short of
// scratch), in *launches how many, and adds each launch to
// variant_launches[2 * (span words > 1) + (tables in place)].
int tt_structural_mask(
    int key_layout, int val_layout, const void* kv_key, const void* kv_val,
    const void* entry_dur, const void* entry_dur_res, int dur_shift,
    int res_bytes, const void* entry_valid, const void* page_block,
    int64_t P, int E, int C, const void* span_trace, const void* span_parent,
    const void* span_block, const void* span_dur, const void* span_kind,
    const void* span_kv_key, const void* span_kv_val, int Cs,
    const void* seg_begin, const void* seg_count, void* scratch,
    int64_t* scratch_words, int max_run, int span_words, int Q, int B,
    int T, int R, int D, int K, int A, int NS, int NT, const void* span_prog,
    const void* trace_prog, const void* term_keys, const void* val_ranges,
    const void* dur_params, const void* kind_params, const void* agg_params,
    const void* block_group, const int64_t* hit_meta, int hit_words,
    void* verdicts, int* launches, int* variant_launches, void* stream) {
  *launches = 0;
  const int64_t have = *scratch_words;
  *scratch_words = 0;
  if (P <= 0 || E <= 0 || Q <= 0) return 0;
  const bool spans = span_parent != nullptr;
  const int cap = spans ? cap_of(Cs) : 0;
  if (B < 1 || T < 1 || R < 1 || D < 1 || K < 1 || A < 1 || NS < 1 ||
      NT < 1 || NS + 1 > 32 * span_words || NT + 1 > 32 * kMaxRegWords ||
      span_words > kMaxRegWords || Cs < 0 || (spans && max_run < 0) ||
      (block_group == nullptr) != (hit_meta == nullptr) ||
      !valid_dur(dur_shift, res_bytes, entry_dur_res) ||
      !valid_layouts(key_layout, val_layout, C) ||
      (key_layout < kU4) != (val_layout < kU4))
    return (int)cudaErrorInvalidValue;
  const int sw = span_words > 1 ? kMaxRegWords : 1;
  K6Args a{};
  a.kv_key = kv_key;
  a.kv_val = kv_val;
  a.key_layout = key_layout;
  a.val_layout = val_layout;
  a.dur = DurCol{entry_dur, entry_dur_res, dur_shift, res_bytes};
  a.entry_valid = (const bool*)entry_valid;
  a.page_block = (const int32_t*)page_block;
  a.n = P * E;
  a.E = E;
  a.C = C;
  a.span_trace = (const int32_t*)span_trace;
  a.span_parent = (const int32_t*)span_parent;
  a.span_block = (const int32_t*)span_block;
  a.span_dur = (const uint32_t*)span_dur;
  a.span_kind = (const int8_t*)span_kind;
  a.span_kv_key = (const int32_t*)span_kv_key;
  a.span_kv_val = (const int32_t*)span_kv_val;
  a.Cs = spans ? Cs : 0;
  a.seg_begin = (const int32_t*)seg_begin;
  a.seg_count = (const int32_t*)seg_count;
  a.cap = cap;
  a.scratch = nullptr;
  a.max_run = max_run;
  a.span_words = span_words;
  a.B = B;
  a.T = T;
  a.R = R;
  a.D = D;
  a.K = K;
  a.A = A;
  a.NS = NS;
  a.NT = NT;
  a.hit_words = hit_words;
  // every launch's plan first: the scratch is sized by the largest grid
  const int chunks = (Q + kMaxLanes - 1) / kMaxLanes;
  std::vector<Plan> plans(chunks);
  int64_t grid = 0;
  for (int c = 0; c < chunks; ++c) {
    a.Q = std::min(kMaxLanes, Q - c * kMaxLanes);
    const int64_t Ql = a.Q;
    const int64_t table_words =
        Ql * (NS * 4 + NT * 4 + (int64_t)B * T + (int64_t)B * T * R * 2 +
              D * 2 + K + A * 3 + (block_group != nullptr ? B : 0));
    const int rc = sw == 1 ? plan_of<1>(a, table_words, plans[c])
                           : plan_of<kMaxRegWords>(a, table_words, plans[c]);
    if (rc != 0) return rc;
    grid = std::max<int64_t>(grid, plans[c].grid);
  }
  if (spans && max_run > cap) {
    *scratch_words = grid * span_words * (int64_t)max_run;
    if (scratch == nullptr || have < *scratch_words) return 0;
    a.scratch = (uint32_t*)scratch;
  }
  for (int c = 0; c < chunks; ++c) {
    const int64_t q = (int64_t)c * kMaxLanes;
    const Plan& p = plans[c];
    a.Q = std::min(kMaxLanes, Q - c * kMaxLanes);
    a.table_words = p.table_words;
    a.span_prog = (const int32_t*)span_prog + q * NS * 4;
    a.trace_prog = (const int32_t*)trace_prog + q * NT * 4;
    a.term_keys = (const int32_t*)term_keys + q * B * T;
    a.val_ranges = (const int32_t*)val_ranges + q * B * T * R * 2;
    a.dur_params = (const uint32_t*)dur_params + q * D * 2;
    a.kind_params = (const int32_t*)kind_params + q * K;
    a.agg_params = (const uint32_t*)agg_params + q * A * 3;
    a.block_group = block_group == nullptr
                        ? nullptr
                        : (const int32_t*)block_group + q * B;
    for (int k = 0; k < kMaxLanes * 3; ++k)
      a.hit[k] = hit_meta != nullptr && k < a.Q * 3 ? hit_meta[q * 3 + k]
                                                    : 0;
    a.verdicts = (uint8_t*)verdicts + q * a.n;
    p.kernel<<<p.grid, kThreads, p.smem, (cudaStream_t)stream>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ++*launches;
    ++variant_launches[p.variant];
  }
  return 0;
}

const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
