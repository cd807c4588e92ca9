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
// order:  key = (0x7FFFFFFF - score) << 31 | index   (N < 2^31), so any
// exact selection of the k_eff smallest keys, sorted, is the answer.
//
// Bound on an H100: bytes -- the Q x N int32 scores read once and the
// Q x k_eff results written once (16.8 MB: 5.0 us at 3.35 TB/s for the
// main path's column). The column was written by K1 or K4 just before, so
// it sits in the 50 MB L2 and a re-read costs less than the bound's read.
//
// The design, for k_eff <= kCoopMaxK (every k of the main path): ONE
// cooperative launch (cudaLaunchCooperativeKernel), every CTA resident,
// `grid.sync()` between phases. A chain of kernels took 17 launches a
// call (six histogram + select pairs, init, memset, gather, sort, unpack)
// and, on an H100, about half of a call was launch gaps; here the host
// sees one.
// 1. Zero the histograms and counters (scratch is per call).
// 2. Radix passes. Each splits the row's candidate key range (at first
//    all of [0, 2^63)) into 2,048 bins of 2^s keys. Each CTA owns a
//    slice of one row (16-byte loads where the row allows), builds a
//    shared-memory histogram of its keys in the range and adds it to the
//    row's global histogram, one atomic per non-empty bin. Lanes that
//    share a bin count it in a register until it changes (a column's
//    non-matches all share one), so the hot bin costs almost no shared
//    atomics. After the barrier every CTA of the row reads the 8 KB
//    histogram and picks the bin itself (no select kernel): the keys
//    below it are winners (`below`), the bin holds `cnt` candidates and
//    becomes the range. Histograms rotate over three buffers, so one
//    barrier a pass suffices: the buffer a pass zeroes was last read two
//    passes ago. Ranges on the score's bits use 32-bit arithmetic.
// 3. The narrow window. The tag cell's matches all start within 256 x
//    600 s of one base second, so their keys share ~14-17 top bits and
//    bit-aligned 11-bit digits split nothing until the index bits. Pass 0
//    also takes, per row, the span of scores in its smallest and in its
//    largest bin; when the k-th key lies in one of them (the matches, or
//    the non-matches of a column with fewer than k), the range shrinks to
//    exactly that span, so pass 1's bins are ~32 s wide in the tag cell's
//    window wherever it falls against bit boundaries, and split the
//    indices at once where the span is one score (-1).
// 4. A row stops as soon as below + cnt <= cap: its winners and the
//    candidates that complete them are then the keys under one bound
//    (the last pass always resolves exactly, one key a bin). Once
//    below + cnt <= kBig (32,768) instead, the row copies those keys out
//    of its column in one more read and its later passes read the copy
//    (the candidate buffer of AIR top-k, Zhang et al., SC '23): K4's
//    sparse rows (~8,200 matches in 4.2M) read their column twice, not
//    three times. A row that is done does no more work; the grid leaves
//    the step loop one barrier after the last row is done.
// 5. Gather the keys under each row's bound (warp-aggregated slot
//    counter), barrier, then rank them: every CTA of the row loads the
//    row's m <= cap keys into shared memory and, a warp a key, counts the
//    keys below each of its share; a key whose rank is below k_eff writes
//    itself there. Keys are unique, so the ranks are a permutation and
//    every output slot is written once. This spreads the final ordering
//    over the whole grid, where a bitonic sort in one CTA took ~15 us
//    on an H100.
// The grid is sized from cudaOccupancyMaxActiveBlocksPerMultiprocessor
// (at most kMaxBlocksPerSm a SM), at least kMinPerBlock elements a CTA
// and 16 CTAs a row where the card holds them; Q rows share one grid, the
// rows' slices split it; cap is twice the padded k, 2,048-8,192 keys (the
// rank costs m^2 over the row's CTAs: at m = 8,192 and 33 CTAs a row it
// took ~120 us on an H100). More rows than the grid holds run in
// chunks of at most that many rows, one launch each. A grid the card
// cannot hold resident is refused by the runtime
// (cudaErrorCooperativeLaunchTooLarge), and that code is returned;
// nothing waits on a CTA that is not running.
//
// Past kCoopMaxK (no main-path k; the ranks outgrow shared memory) the
// launcher keeps that chain: radix select kernels, a gather and bitonic
// stages in global memory, ending in `unpack_kernel`.
//
// The output is exactly the plain version's (a stable sort of the keys),
// whatever order the atomics ran in.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBins = 2048;
constexpr int kDigitBits = 11;
constexpr int kMaxDevices = 64;

// the cooperative route
constexpr int kCoopMaxK = 4096;
constexpr int kCapMin = 2048;
constexpr int kCapMax = 8192;     // keys a row gathers; 64 KB of shared memory
constexpr int kThreads = 512;
constexpr int kUnroll = 8;        // scalar loads in flight a thread
constexpr int kVecUnroll = 2;     // 16-byte loads in flight a thread
constexpr int kMaxBlocksPerSm = 2;
constexpr int64_t kMinPerBlock = 8192;
constexpr int kMinBlocksPerRow = 16;
constexpr int kBig = 32768;       // candidates a row copies out of its column
constexpr int kSteps = 16;        // passes, fills and the last empty step
static_assert(kThreads * 4 == kBins, "the select reads four bins a thread");

// the long route
constexpr int kHistThreads = 256;
constexpr int kSelectThreads = 1024;

__device__ __forceinline__ unsigned long long make_key(int32_t score,
                                                       int64_t i) {
  return ((unsigned long long)(0x7FFFFFFFLL - (long long)score) << 31) |
         (unsigned long long)i;
}

__device__ __forceinline__ int64_t i64min(int64_t x, int64_t y) {
  return x < y ? x : y;
}

__device__ __forceinline__ int32_t key_score(unsigned long long key) {
  return (int32_t)(0x7FFFFFFFLL - (long long)(key >> 31));
}

__device__ __forceinline__ int32_t key_index(unsigned long long key) {
  return (int32_t)(key & 0x7FFFFFFFull);
}

int next_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// per row: the two key buffers, three histograms, two fill counters and
// the four pass-0 scores
constexpr size_t kCoopRowBytes =
    (size_t)(kCapMax + kBig) * 8 + 3 * kBins * 4 + 8 + 16;

size_t long_scratch_bytes(int rows, int k_eff) {
  return (size_t)rows * ((size_t)next_pow2(k_eff) * 8 + 5 * 8 + kBins * 4);
}

// ---------------------------------------------------------------------------
// the cooperative route

struct Coop {
  const int32_t* scores;     // [rows, n], this launch's rows
  int64_t n;
  int rows, k_eff, cap;
  bool vec;                  // rows 16-byte aligned and n % 4 == 0
  unsigned long long* buf;   // [rows, kCapMax] the keys ranked at the end
  unsigned long long* big;   // [rows, kBig] candidates, once they fit
  unsigned* hist;            // [rows, 3, kBins]
  unsigned* slot;            // [rows] buf's fill counters
  unsigned* big_cnt;         // [rows] big's fill counters
  unsigned* track;           // [rows, 4] pass 0's inv extremes (kTrack)
  unsigned* active;          // [kSteps] rows not yet done, per step
  int32_t* out_s;            // [rows, k_eff]
  int32_t* out_i;
};

// Hand every element of the slice [lo, hi) of a row to f(score, index,
// valid) in warp-synchronous steps: the loop bounds are block-uniform, so
// all 32 lanes reach f's warp votes. With `vec` (lo, hi multiples of 4)
// each lane loads 16 bytes, four consecutive elements.
template <class F>
__device__ __forceinline__ void for_slice(const int32_t* __restrict__ sc,
                                          int64_t lo, int64_t hi, bool vec,
                                          F&& f) {
  const int t = threadIdx.x;
  if (vec) {
    const int4* v4 = reinterpret_cast<const int4*>(sc);
    const int64_t lo4 = lo >> 2, hi4 = hi >> 2;
    for (int64_t j0 = lo4; j0 < hi4; j0 += (int64_t)kThreads * kVecUnroll) {
      int4 x[kVecUnroll];
#pragma unroll
      for (int u = 0; u < kVecUnroll; ++u) {
        const int64_t j = j0 + u * kThreads + t;
        x[u] = j < hi4 ? __ldg(v4 + j) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kVecUnroll; ++u) {
        const int64_t j = j0 + u * kThreads + t;
        const bool ok = j < hi4;
        f(x[u].x, 4 * j, ok);
        f(x[u].y, 4 * j + 1, ok);
        f(x[u].z, 4 * j + 2, ok);
        f(x[u].w, 4 * j + 3, ok);
      }
    }
    return;
  }
  for (int64_t i0 = lo; i0 < hi; i0 += (int64_t)kThreads * kUnroll) {
    int32_t x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * kThreads + t;
      x[u] = i < hi ? __ldg(sc + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * kThreads + t;
      f(x[u], i, i < hi);
    }
  }
}

// The same over keys [lo, hi) of a buffer written earlier in the launch.
template <class F>
__device__ __forceinline__ void for_keys(const unsigned long long* keys,
                                         int64_t lo, int64_t hi, F&& f) {
  for (int64_t i0 = lo; i0 < hi; i0 += kThreads) {
    const int64_t i = i0 + threadIdx.x;
    f(i < hi ? __ldcg(keys + i) : 0ull, i < hi);
  }
}

// Warp-synchronous histogram counts into shared memory: lanes that share
// the first valid lane's bin count it in a warp-uniform register until
// that bin changes (a column's non-matches all share one), so the hot
// bin takes almost no shared atomics; the other lanes add one each.
struct BinCounter {
  unsigned* sh;
  int lane;
  int wbin = -1;
  unsigned wcnt = 0;
  __device__ __forceinline__ void add(int bin) {
    const unsigned valid = __ballot_sync(0xffffffffu, bin >= 0);
    if (!valid) return;
    const int lead = __ffs(valid) - 1;
    const int lbin = __shfl_sync(0xffffffffu, bin, lead);
    const unsigned same = __ballot_sync(0xffffffffu, bin == lbin);
    if (lbin == wbin) {
      wcnt += __popc(same);
    } else {
      if (lane == 0 && wcnt) atomicAdd(&sh[wbin], wcnt);
      wbin = lbin;
      wcnt = __popc(same);
    }
    if (bin >= 0 && bin != lbin) atomicAdd(&sh[bin], 1u);
  }
  __device__ __forceinline__ void flush() {
    if (lane == 0 && wcnt) atomicAdd(&sh[wbin], wcnt);
  }
};

// Warp-synchronous append of the keys a lane takes to out[*slot ...].
__device__ __forceinline__ void append(bool take, unsigned long long key,
                                       unsigned* slot,
                                       unsigned long long* out, int lane) {
  const unsigned bal = __ballot_sync(0xffffffffu, take);
  if (!bal) return;
  const int lead = __ffs(bal) - 1;
  unsigned base = 0;
  if (lane == lead) base = atomicAdd(slot, (unsigned)__popc(bal));
  base = __shfl_sync(0xffffffffu, base, lead);
  if (take) out[base + __popc(bal & ((1u << lane) - 1u))] = key;
}

// One radix pass of a CTA's slice of the column into `bc`: every key in
// the row's candidate range [r_lo, r_lo + w) counts in bin
// (key - r_lo) >> s (< kBins). kInv: the range and the bins lie on the
// score's bits (s >= 31, r_lo and w multiples of 2^31), so 32-bit
// arithmetic on inv = 0x7FFFFFFF - score, the key's bits 62..31,
// suffices. kTrack (pass 0): also, into trk[0..3], the slice's smallest
// inv, the minimum of ((inv & bin bits) | (~inv & the bits below)), which
// picks the largest inv in the smallest bin, the largest inv, and the
// maximum of the same mix, which picks the smallest inv in the largest
// bin.
template <bool kInv, bool kTrack>
__device__ __forceinline__ void hist_slice(const int32_t* __restrict__ sc,
                                           int64_t lo, int64_t hi, bool vec,
                                           unsigned long long r_lo,
                                           unsigned long long w, int s,
                                           BinCounter& bc, unsigned* trk) {
  const unsigned i_lo = (unsigned)(r_lo >> 31);
  const unsigned long long i_w = w >> 31;
  const int i_s = s - 31;
  unsigned ilo = ~0u, tlo = ~0u, ihi = 0u, thi = 0u;
  for_slice(sc, lo, hi, vec, [&](int32_t score, int64_t i, bool ok) {
    int bin = -1;
    if (ok) {
      if (kInv) {
        const unsigned inv = 0x7FFFFFFFu - (unsigned)score;
        const unsigned d = inv - i_lo;   // wraps below the range
        if ((unsigned long long)d < i_w) bin = (int)(d >> i_s);
        if (kTrack) {
          const unsigned mix = (inv & 0xFFE00000u) | (~inv & 0x1FFFFFu);
          ilo = min(ilo, inv);
          tlo = min(tlo, mix);
          ihi = max(ihi, inv);
          thi = max(thi, mix);
        }
      } else {
        const unsigned long long d = make_key(score, i) - r_lo;
        if (d < w) bin = (int)(d >> s);
      }
    }
    bc.add(bin);
  });
  if (kTrack) {
    ilo = __reduce_min_sync(0xffffffffu, ilo);
    tlo = __reduce_min_sync(0xffffffffu, tlo);
    ihi = __reduce_max_sync(0xffffffffu, ihi);
    thi = __reduce_max_sync(0xffffffffu, thi);
    if (bc.lane == 0) {
      atomicMin(&trk[0], ilo);
      atomicMin(&trk[1], tlo);
      atomicMax(&trk[2], ihi);
      atomicMax(&trk[3], thi);
    }
  }
}

// What a row's CTAs do in a step; each step ends at a grid barrier.
enum Mode {
  kColPass,    // a radix pass over the column
  kBigFill,    // gather the column's candidates (keys < bound) into big
  kBigPass,    // a radix pass over big
  kFillCol,    // gather the keys to rank (keys < bound) from the column
  kFillBig,    // the same from big
  kRowDone
};

__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSm)
topk_radix_kernel(const Coop a) {
  cg::grid_group grid = cg::this_grid();
  // the histogram during the passes, the row's gathered keys after them
  extern __shared__ unsigned long long sm_keys[];
  unsigned* sh = reinterpret_cast<unsigned*>(sm_keys);
  __shared__ unsigned warp_tot[kThreads / 32];
  __shared__ unsigned pick[3];   // digit, keys below its bin, its count
  __shared__ unsigned trk[4];

  const int G = gridDim.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t n = a.n;
  // the CTA's slice of its row (rows <= G: the launcher cuts chunks);
  // slices are multiples of 4 elements for the 16-byte loads
  const int spr = G / a.rows;
  const int row = blockIdx.x / spr;
  const bool working = row < a.rows;   // else idle but for the barriers
  const int slice = blockIdx.x - row * spr;
  const int64_t per = (((n + spr - 1) / spr) + 3) & ~(int64_t)3;
  const int64_t lo = working ? i64min(n, slice * per) : 0;
  const int64_t hi = working ? i64min(n, lo + per) : 0;
  const int32_t* sc = a.scores + (working ? (int64_t)row * n : 0);
  const bool owner = working && slice == 0 && t == 0;
  const int64_t gt = (int64_t)blockIdx.x * kThreads + t;
  const int64_t gs = (int64_t)G * kThreads;
  const int64_t hist_words = (int64_t)a.rows * kBins;
  unsigned long long* keys = a.buf + (int64_t)row * kCapMax;
  unsigned long long* big = a.big + (int64_t)row * kBig;

  // 1. zero histogram buffer 0 and the counters
  for (int64_t j = gt; j < hist_words; j += gs)
    a.hist[(j / kBins) * 3 * kBins + (j % kBins)] = 0;
  for (int64_t j = gt; j < a.rows; j += gs) {
    a.slot[j] = a.big_cnt[j] = 0;
    a.track[4 * j] = a.track[4 * j + 1] = ~0u;
    a.track[4 * j + 2] = a.track[4 * j + 3] = 0u;
  }
  if (gt < kSteps) a.active[gt] = 0;
  grid.sync();

  // 2-5. steps over the row's candidate range [r_lo, r_lo + w): keys
  // below it are winners (`below`), `need` more lie in it. The state is
  // the same in every CTA of a row; the grid leaves the loop one barrier
  // after the last row is done.
  unsigned long long r_lo = 0, w = 1ull << 63, bound = ~0ull;
  unsigned need = (unsigned)a.k_eff, below = 0;
  int mode = n <= a.cap ? kFillCol : kColPass;   // a short row: all keys
  int col_passes = 0, s = 0;
  for (int step = 0; step < kSteps; ++step) {
    if (step > 0) {
      if (__ldcg(&a.active[step - 1]) == 0) break;   // every row done
      if (working && (mode == kColPass || mode == kBigPass)) {
        // the previous step's histogram: exclusive prefix, four bins a
        // thread, and the bin that holds the need-th key of the range
        const unsigned* h =
            a.hist + ((int64_t)row * 3 + (step - 1) % 3) * kBins;
        const uint4 c4 = __ldcg(reinterpret_cast<const uint4*>(h) + t);
        const unsigned mine = c4.x + c4.y + c4.z + c4.w;
        unsigned incl = mine;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += y;
        }
        if (lane == 31) warp_tot[warp] = incl;
        __syncthreads();
        if (warp == 0) {
          unsigned v = lane < kThreads / 32 ? warp_tot[lane] : 0u;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const unsigned y = __shfl_up_sync(0xffffffffu, v, o);
            if (lane >= o) v += y;
          }
          if (lane < kThreads / 32) warp_tot[lane] = v;
        }
        __syncthreads();
        unsigned e = incl - mine + (warp ? warp_tot[warp - 1] : 0u);
        const unsigned c[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (c[b] && e < need && need <= e + c[b]) {
            pick[0] = 4 * t + b;
            pick[1] = e;
            pick[2] = c[b];
          }
          e += c[b];
        }
        __syncthreads();
        const unsigned digit = pick[0], excl = pick[1], cnt = pick[2];
        __syncthreads();
        const unsigned long long off = (unsigned long long)digit << s;
        r_lo += off;
        w = w - off < (1ull << s) ? w - off : (1ull << s);
        below += excl;
        need -= excl;
        const unsigned long long m = (unsigned long long)below + cnt;
        if (m <= (unsigned long long)a.cap) {
          bound = r_lo + w;
          mode = mode == kColPass ? kFillCol : kFillBig;
        } else if (mode == kColPass) {
          if (col_passes == 1) {
            // after pass 0: the k-th key lies in the smallest bin (a
            // narrow window of matches) or the largest (a column's
            // non-matches): its invs span [ilo, ihi], and the next bins
            // split that span alone, wherever it falls against bit
            // boundaries; a single inv leaves the n indices to split
            const unsigned* tr = a.track + 4 * row;
            const unsigned mlo = __ldcg(tr + 1), mhi = __ldcg(tr + 3);
            unsigned ilo = 1, ihi = 0;
            if (digit == __ldcg(tr) >> 21) {
              ilo = __ldcg(tr);
              ihi = (mlo & 0xFFE00000u) | (~mlo & 0x1FFFFFu);
            } else if (digit == __ldcg(tr + 2) >> 21) {
              ilo = (mhi & 0xFFE00000u) | (~mhi & 0x1FFFFFu);
              ihi = __ldcg(tr + 2);
            }
            if (ilo <= ihi) {
              r_lo = (unsigned long long)ilo << 31;
              w = ilo < ihi ? (unsigned long long)(ihi - ilo + 1) << 31
                            : (unsigned long long)n;
            }
          }
          if (m <= (unsigned long long)kBig) {
            // few enough to copy out: later passes read them, not the
            // column
            bound = r_lo + w;
            mode = kBigFill;
          }
        }
      } else if (mode == kBigFill) {
        mode = kBigPass;
      } else if (mode == kFillCol || mode == kFillBig) {
        mode = kRowDone;
      }
    }
    if (working && mode != kRowDone) {
      if (mode == kColPass || mode == kBigPass) {
        // bins of 2^s keys, 2,048 of them covering the range
        s = w > kBins ? 64 - __clzll(w - 1) - kDigitBits : 0;
        for (int j = t; j < kBins; j += kThreads) sh[j] = 0;
        if (t < 4) trk[t] = t < 2 ? ~0u : 0u;
        __syncthreads();
        BinCounter bc{sh, lane};
        if (mode == kBigPass) {
          const int64_t bn = __ldcg(a.big_cnt + row);
          const int64_t bp = (bn + spr - 1) / spr;
          const int64_t blo = i64min(bn, slice * bp);
          for_keys(big, blo, i64min(bn, blo + bp),
                   [&](unsigned long long key, bool ok) {
                     const unsigned long long d = key - r_lo;
                     bc.add(ok && d < w ? (int)(d >> s) : -1);
                   });
        } else if (col_passes == 0) {
          hist_slice<true, true>(sc, lo, hi, a.vec, r_lo, w, s, bc, trk);
        } else if (s >= 31) {
          hist_slice<true, false>(sc, lo, hi, a.vec, r_lo, w, s, bc, trk);
        } else {
          hist_slice<false, false>(sc, lo, hi, a.vec, r_lo, w, s, bc, trk);
        }
        bc.flush();
        __syncthreads();
        unsigned* h = a.hist + ((int64_t)row * 3 + step % 3) * kBins;
        for (int j = t; j < kBins; j += kThreads)
          if (sh[j]) atomicAdd(&h[j], sh[j]);
        if (mode == kColPass && col_passes == 0) {
          if (t < 2) atomicMin(&a.track[4 * row + t], trk[t]);
          if (t >= 2 && t < 4) atomicMax(&a.track[4 * row + t], trk[t]);
        }
        if (mode == kColPass) ++col_passes;
      } else if (mode == kFillBig) {
        const int64_t bn = __ldcg(a.big_cnt + row);
        const int64_t bp = (bn + spr - 1) / spr;
        const int64_t blo = i64min(bn, slice * bp);
        for_keys(big, blo, i64min(bn, blo + bp),
                 [&](unsigned long long key, bool ok) {
                   append(ok && key < bound, key, a.slot + row, keys, lane);
                 });
      } else {   // kBigFill, kFillCol: the column's keys under the bound
        unsigned* cnt = mode == kBigFill ? a.big_cnt + row : a.slot + row;
        unsigned long long* out = mode == kBigFill ? big : keys;
        for_slice(sc, lo, hi, a.vec, [&](int32_t score, int64_t i, bool ok) {
          const unsigned long long key = make_key(score, i);
          append(ok && key < bound, key, cnt, out, lane);
        });
      }
      if (owner) atomicAdd(&a.active[step], 1u);
    }
    // the buffer step + 1 fills was last read by step - 1's select,
    // before the previous barrier
    const int nb = (step + 1) % 3;
    for (int64_t j = gt; j < hist_words; j += gs)
      a.hist[((j / kBins) * 3 + nb) * kBins + (j % kBins)] = 0;
    grid.sync();
  }

  // rank the row's keys: this CTA's share, a warp a key
  if (working) {
    const int m = (int)__ldcg(&a.slot[row]);
    for (int i = t; i < m; i += kThreads) sm_keys[i] = __ldcg(keys + i);
    __syncthreads();
    const int per_k = (m + spr - 1) / spr;
    const int c1 = min(m, (slice + 1) * per_k);
    int32_t* os = a.out_s + (int64_t)row * a.k_eff;
    int32_t* oi = a.out_i + (int64_t)row * a.k_eff;
    for (int c = slice * per_k + warp; c < c1; c += kThreads / 32) {
      const unsigned long long key = sm_keys[c];
      unsigned lower = 0;
      for (int x = lane; x < m; x += 32) lower += sm_keys[x] < key;
      const unsigned rank = __reduce_add_sync(0xffffffffu, lower);
      if (lane == 0 && rank < (unsigned)a.k_eff) {
        os[rank] = key_score(key);
        oi[rank] = key_index(key);
      }
    }
  }
}

// per device: SM count and resident CTAs a SM (0: not asked yet)
int g_sms[kMaxDevices];
int g_blocks[kMaxDevices];

// The largest cooperative grid the current device holds resident.
int coop_grid_max(int* out) {
  int dev, err;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!g_blocks[dev]) {
    if ((err = (int)cudaFuncSetAttribute(
             topk_radix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             kCapMax * 8)))
      return err;
    int sms = 0, b = 0;
    if ((err = (int)cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)))
      return err;
    if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &b, topk_radix_kernel, kThreads, (size_t)kCapMax * 8)))
      return err;
    if (b < 1) return (int)cudaErrorInvalidConfiguration;
    g_sms[dev] = sms;
    g_blocks[dev] = b < kMaxBlocksPerSm ? b : kMaxBlocksPerSm;
  }
  *out = g_blocks[dev] * g_sms[dev];
  return 0;
}

int launch_coop(const int32_t* sc, int rows, int64_t n, int k_eff,
                char* scratch, int32_t* out_s, int32_t* out_i,
                cudaStream_t s) {
  int gmax, err;
  if ((err = coop_grid_max(&gmax))) return err;
  // launches run one after another on the stream and share the scratch
  const int chunk = rows < gmax ? rows : gmax;
  unsigned long long* buf = (unsigned long long*)scratch;
  unsigned long long* big = buf + (size_t)chunk * kCapMax;
  unsigned* hist = (unsigned*)(big + (size_t)chunk * kBig);
  unsigned* slot = hist + (size_t)chunk * 3 * kBins;
  unsigned* big_cnt = slot + chunk;
  unsigned* track = big_cnt + chunk;
  unsigned* active = track + 4 * (size_t)chunk;
  const bool vec = ((uintptr_t)sc & 15) == 0 && n % 4 == 0;
  const int kpad2 = 2 * next_pow2(k_eff);
  for (int r0 = 0; r0 < rows; r0 += chunk) {
    const int rc = rows - r0 < chunk ? rows - r0 : chunk;
    int64_t g = ((int64_t)rc * n + kMinPerBlock - 1) / kMinPerBlock;
    if (g < (int64_t)rc * kMinBlocksPerRow) g = (int64_t)rc * kMinBlocksPerRow;
    if (g > gmax) g = gmax;
    // keys a row ranks: their ranking costs m^2 / (CTAs of the row), and
    // larger candidate sets go through big first, so the least that
    // holds twice the padded k
    const int cap = kpad2 < kCapMin ? kCapMin
                                    : (kpad2 > kCapMax ? kCapMax : kpad2);
    const Coop a = {sc + (int64_t)r0 * n, n, rc, k_eff, cap, vec, buf, big,
                    hist, slot, big_cnt, track, active,
                    out_s + (int64_t)r0 * k_eff, out_i + (int64_t)r0 * k_eff};
    void* args[] = {(void*)&a};
    if ((err = (int)cudaLaunchCooperativeKernel(
             (const void*)topk_radix_kernel, dim3((unsigned)g),
             dim3(kThreads), args, (size_t)kCapMax * 8, s)))
      return err;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// the long route (k_eff > kCoopMaxK)

// state, per row: [0] prefix, [1] keys still needed inside the prefix,
// [2] done, [3] threshold, [4] gather slot counter
enum { kPrefix = 0, kNeed = 1, kDone = 2, kThresh = 3, kSlot = 4, kState = 5 };

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
  out_scores[row * k_eff + i] = key_score(key);
  out_idx[row * k_eff + i] = key_index(key);
}

int launch_long(const int32_t* sc, int rows, int64_t n, int k_eff,
                char* scratch, int32_t* out_s, int32_t* out_i,
                cudaStream_t s) {
  int dev, err;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  int sm_count = 0;
  if ((err = (int)cudaDeviceGetAttribute(
           &sm_count, cudaDevAttrMultiProcessorCount, dev)))
    return err;
  const int n_pad = next_pow2(k_eff);
  unsigned long long* w = (unsigned long long*)scratch;
  unsigned long long* state = w + (size_t)rows * n_pad;
  unsigned* h = (unsigned*)(state + (size_t)rows * kState);

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
  if ((err = (int)cudaMemsetAsync(
           w, 0xFF, (size_t)rows * n_pad * sizeof(unsigned long long), s)))
    return err;
  gather_kernel<<<grid, 256, 0, s>>>(sc, n, state, w, n_pad);
  if ((err = (int)cudaGetLastError())) return err;
  const dim3 blocks((unsigned)((n_pad + 255) / 256), rows);
  for (int k = 2; k <= n_pad; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      bitonic_step_kernel<<<blocks, 256, 0, s>>>(w, n_pad, k, j);
      if ((err = (int)cudaGetLastError())) return err;
    }
  }
  unpack_kernel<<<dim3((k_eff + 255) / 256, rows), 256, 0, s>>>(
      w, n_pad, k_eff, out_s, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The most rows one cooperative launch takes on the current device (its
// largest resident grid), or minus a CUDA error code.
int tt_topk_rows_per_launch(void) {
  int gmax;
  const int err = coop_grid_max(&gmax);
  return err ? -err : gmax;
}

// Scratch bytes tt_topk_rows needs for `rows` rows and k_eff on the
// current device (0 on a CUDA error: the launch reports it).
long long tt_topk_scratch_bytes(int rows, int k_eff) {
  if (rows <= 0 || k_eff <= 0) return 0;
  if (k_eff > kCoopMaxK) return (long long)long_scratch_bytes(rows, k_eff);
  int gmax;
  if (coop_grid_max(&gmax)) return 0;
  const int chunk = rows < gmax ? rows : gmax;
  return (long long)(chunk * kCoopRowBytes + kSteps * 4);
}

// scores: int32 [rows, n], contiguous; scratch: `scratch_bytes` bytes of
// device memory, 256-byte aligned, at least tt_topk_scratch_bytes(rows,
// k_eff) (zeroed in-kernel); out_scores/out_idx: int32 [rows, k_eff].
// Issues on `stream`, on the current device. Returns the first
// cudaError_t seen.
int tt_topk_rows(const void* scores, int rows, long long n, int k_eff,
                 void* scratch, long long scratch_bytes, void* out_scores,
                 void* out_idx, void* stream) {
  if (rows <= 0 || n <= 0 || k_eff <= 0) return 0;
  if (rows > 65535 || n >= (1ll << 31) || k_eff > n)
    return (int)cudaErrorInvalidValue;
  const long long need = tt_topk_scratch_bytes(rows, k_eff);
  if (need == 0 || scratch_bytes < need) return (int)cudaErrorInvalidValue;
  const int32_t* sc = (const int32_t*)scores;
  int32_t* os = (int32_t*)out_scores;
  int32_t* oi = (int32_t*)out_idx;
  cudaStream_t s = (cudaStream_t)stream;
  if (k_eff <= kCoopMaxK)
    return launch_coop(sc, rows, n, k_eff, (char*)scratch, os, oi, s);
  return launch_long(sc, rows, n, k_eff, (char*)scratch, os, oi, s);
}

const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
