// K3 dict_probe: substring probe of T needles over a value dictionary.
//
// Replaces tempo_tpu/search/dict_probe.py `_probe_core` and `probe_kernel`
// (TPU kernel B5, one shard: the mesh split is B10) and, on the packed
// route, the `pack_mask_words` that follows it (packing.py, B4):
//
//   hits[t, v]   = value v's bytes buf[off[v] .. off[v+1]) contain needle t
//                  (lens[t] == 0: every value, including empty ones;
//                   lens[t] <  0: no value — a term whose key is absent)
//   any_hits[t]  = OR over v of hits[t, v]
//   words[t, w]  = OR over i < 32 with 32w + i < V of hits[t, 32w + i] << i
//                  (the word form; bits past V are 0)
//
// A match never spans two values. The dictionary is the packed UTF-8 of
// the sorted value dictionary, `buf u8 [N]` and `off i32 [V+1]`, and
// nothing else: the reference's per-byte position map and power-of-two
// padding exist for the TPU's shifted-compare formulation.
//
// Bound on an H100: bytes. The function reads the dictionary once (buf
// and off: 21 MB for the hc cell's 1,050,711 values of 16 bytes) and
// writes T*V hit bytes or T*V/8 word bytes: ~6.6 us at 3.35 TB/s. The
// first design (one thread a value walking its bytes with 1-byte loads,
// every term walking them again, a bool mask that K5 then packed, a
// zeroing fill for any_hits) ran at ~0.030 ms on `77`, paced by load
// instructions: a warp's byte load touched 16 sectors to use 32 bytes.
//
// Design: one cooperative launch a call; a grid of at most one CTA a
// tile, sized from the occupancy (4 CTAs of 256 threads an SM), with
// tiles of up to kTile values chosen so the tiles fill the card in one
// wave (``tile_for``: 522 tiles of 2,016 values for the hc dictionary).
//   - A CTA stages its tile's offsets, then its bytes chunk by chunk into
//     shared memory with 16-byte loads, all of a chunk's loads in flight
//     before the first store: starts [c0, c0 + kChunk) with a halo of
//     kMaxNeedle - 1 bytes, from the 16-byte boundary at or below buf + c0
//     (the partial vectors at either end byte by byte, so nothing outside
//     the tile's bytes is read). A tile of more bytes walks them chunk by
//     chunk inside the CTA, so values of any length stay exact and no CTA
//     writes another's values.
//   - (A) For each term, a candidate bitmap: 32 staged bytes a thread a
//     step, the needle's last two bytes (its one byte) tested at every
//     position of each 32-bit word at once (an exact zero-byte test on the
//     word xor the byte, and on the word shifted by one byte with
//     __byte_perm), no branch. The last two bytes, not the first: ids that
//     share a prefix ("session-0012345") would make every value's start a
//     candidate.
//   - (B) Each candidate names a start; one in the chunk whose whole
//     needle matches in shared memory counts for the value that holds it
//     if the match ends inside that value, and sets its bit in a word of
//     flags (atomicOr in shared memory). The owner: where candidates are
//     dense (more than one thread in 8 holds one, __syncthreads_count), a
//     table of each 32-byte group's value built once a chunk and then a
//     step or two forward; where sparse, a binary search over the staged
//     offsets (the table costs more than it saves on a point lookup).
//   - Every term runs against the staged chunk, kPass terms at a time (each
//     pass's flags in shared memory), so the dictionary is read from HBM
//     once whatever T is (a tile of more than one chunk is staged again
//     each pass of kPass terms).
//   - The needles travel by value in the launch's parameters (at most
//     kLaunchTerms a launch, under 4 KB of parameters): no host-to-device
//     copy.
//   - Both output forms come out of the one launch: bool rows with
//     coalesced stores (4 values a 32-bit store where the row allows it),
//     or the flag words themselves, which are K5's words bit for bit
//     (tiles are multiples of 32 values, so a tile's words are whole words
//     of the row).
//   - any_hits: each CTA writes its OR of every term as one row of
//     partials [T, grid] inside the output's own allocation; after one
//     grid barrier the grid ORs them by term. No zeroing launch, no
//     memset, no global atomics.
// On the card (bench_probe.py, PERF.md §6) the device time of a T = 1
// call is mostly fixed costs: the launch of the grid, the grid barrier
// and its reduction, and the staging wave (every CTA loads, then every CTA
// computes, so loads and passes do not overlap). Tried and dropped:
// holding the chunk in registers (spills at 8 vectors a thread, slower at
// 4), an owner binary search for every candidate (slow when candidates
// are dense), and a per-value pass over the bitmap (slow for several
// terms).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;             // values a tile, at most
constexpr int kTileWords = kTile / 32;
constexpr int kChunk = 32640;           // starts a staged chunk
constexpr int kMaxNeedle = 64;          // dict_probe.MAX_NEEDLE_BYTES
// a chunk's staged bytes: up to 15 before it (the 16-byte boundary), its
// kChunk starts and the kMaxNeedle - 1 halo, in whole 32-byte groups of
// the candidate scan, and one more word for the scan's next-word reads
constexpr int kStage = (15 + kChunk + kMaxNeedle - 1 + 31) / 32 * 32 + 16;
constexpr int kCandWords = kStage / 32;  // a candidate bit a staged byte
// a staged chunk's 16-byte loads a thread (8: a chunk's 2,045 at most)
constexpr int kStageVec =
    ((15 + kChunk + kMaxNeedle - 1 + 15) / 16 + kThreads - 1) / kThreads;
constexpr int kOffVec = ((kTile + 1) / 4 + kThreads - 1) / kThreads;
static_assert(kStageVec == 8 && kOffVec == 2, "the loads a thread holds");
constexpr int kPass = 8;                // terms whose flags a tile keeps
constexpr int kLaunchTerms = 56;        // at most, a launch (< 4 KB args)
constexpr int kMaxDevices = 64;

static_assert(kTile % 32 == 0, "a tile holds whole words of flags");
static_assert(kStage % 16 == 0, "the offsets follow on a 16-byte boundary");

// A CTA's shared memory (dynamic: ~52 KB, past the 48 KB of static
// shared memory; the allowance is set once per device).
struct Shared {
  uint8_t bytes[kStage];          // the staged chunk (16-byte aligned)
  int32_t off[kTile + 4];         // the tile's offsets
  uint32_t cand[kCandWords];      // (A): a candidate bit a staged byte
  int first[kCandWords];          // the value that holds staged byte 32w
  uint32_t flags[kPass][kTileWords];   // the pass's value flags
  uint8_t needle[kPass][kMaxNeedle];
  int len[kPass];
  int key[kPass];                 // the filter's needle offset
  uint32_t pat[kPass][2];         // its two bytes x 0x01010101
};

struct ProbeArgs {
  const uint8_t* buf;
  const int32_t* off;
  uint8_t* out;         // bool [T, V] or u32 words [T, W]: this launch's rows
  uint8_t* any_hits;    // [T]
  uint8_t* partials;    // [T, grid]
  int64_t n_vals;
  int64_t pitch;        // elements a row: V (bool) or W (words)
  int n_terms;
  int words;
  int tile;             // values a tile: a multiple of 32, <= kTile
  int tiles;
  int32_t len[kLaunchTerms];
  uint8_t needle[kLaunchTerms][kMaxNeedle];
};

__device__ __forceinline__ uint32_t low_bits(int n) {
  return n >= 32 ? 0xffffffffu : (n <= 0 ? 0u : (1u << n) - 1u);
}

// 0x80 in each byte of t that is 0, exactly (no borrow between bytes).
__device__ __forceinline__ uint32_t zero_bytes(uint32_t t) {
  return ~(((t & 0x7f7f7f7fu) + 0x7f7f7f7fu) | t) & 0x80808080u;
}

// The high bits of a zero_bytes() word (bits 7, 15, 23, 31) as bits 0..3.
__device__ __forceinline__ uint32_t byte_flags(uint32_t z) {
  return (z * 0x00204081u) >> 28;
}

// Stages bytes [c0, e1) of buf into s from the 16-byte boundary at or below
// buf + c0 (s[shift] is buf[c0]): all of a chunk's 16-byte loads in flight
// at once (kStageVec a thread), the partial vectors at either end byte by
// byte.
__device__ __forceinline__ void stage_bytes(const uint8_t* buf, int c0,
                                            int e1, uint8_t* s, int shift) {
  const uint8_t* lo = buf + c0 - shift;
  const int n = shift + (e1 - c0);
  const int n16 = (n + 15) >> 4;
  uint4 v[kStageVec];
#pragma unroll
  for (int u = 0; u < kStageVec; ++u) {
    const int b = (threadIdx.x + u * kThreads) << 4;
    v[u] = b >= shift && b + 16 <= n
               ? __ldg(reinterpret_cast<const uint4*>(lo + b))
               : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int u = 0; u < kStageVec; ++u) {
    const int k = threadIdx.x + u * kThreads, b = k << 4;
    if (k >= n16) break;
    if (b >= shift && b + 16 <= n) {
      reinterpret_cast<uint4*>(s)[k] = v[u];
    } else {
#pragma unroll 1
      for (int j = 0; j < 16; ++j)
        s[b + j] = (b + j >= shift && b + j < n) ? __ldg(lo + b + j) : 0;
    }
  }
}

// Stages off[0 .. n) into s, n <= kTile + 1: 16-byte loads where the
// source allows, all in flight before the first store.
__device__ __forceinline__ void stage_offsets(const int32_t* off, int n,
                                              int32_t* s) {
  const bool vec = ((uintptr_t)off & 15) == 0;
  const int nv4 = vec ? n >> 2 : 0;
  int4 v[kOffVec];
#pragma unroll
  for (int u = 0; u < kOffVec; ++u) {
    const int k = threadIdx.x + u * kThreads;
    v[u] = k < nv4 ? __ldg(reinterpret_cast<const int4*>(off) + k)
                   : make_int4(0, 0, 0, 0);
  }
#pragma unroll
  for (int u = 0; u < kOffVec; ++u) {
    const int k = threadIdx.x + u * kThreads;
    if (k < nv4) reinterpret_cast<int4*>(s)[k] = v[u];
  }
#pragma unroll 1
  for (int i = (nv4 << 2) + threadIdx.x; i < n; i += kThreads)
    s[i] = __ldg(off + i);
}

__global__ void __launch_bounds__(kThreads, 4)
probe_kernel(const __grid_constant__ ProbeArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  uint8_t* s_bytes = sh.bytes;
  int32_t* s_off = sh.off;
  uint32_t* s_cand = sh.cand;
  int* s_first = sh.first;
  __shared__ uint8_t s_any[kLaunchTerms];
  const int tid = threadIdx.x;
  const uint32_t* w32 = reinterpret_cast<const uint32_t*>(s_bytes);
  const uint4* w128 = reinterpret_cast<const uint4*>(s_bytes);
  for (int t = tid; t < a.n_terms; t += kThreads) s_any[t] = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int64_t v0 = (int64_t)tile * a.tile;
    const int nv = (int)min((int64_t)a.tile, a.n_vals - v0);
    const int nv32 = (nv + 31) & ~31;
    // the tile's byte range, read by every thread (one broadcast each), so
    // that its bytes' loads need not wait for the staged offsets
    const int b0 = __ldg(a.off + v0), b1 = __ldg(a.off + v0 + nv);
    const bool one_chunk = b1 - b0 <= kChunk;
    bool have_first = false;   // s_first holds the staged chunk's owners
    __syncthreads();   // the previous tile's readers are done
    stage_offsets(a.off + v0, nv + 1, s_off);
    for (int p0 = 0; p0 < a.n_terms; p0 += kPass) {
      const int np = min(kPass, a.n_terms - p0);
      if (p0 > 0) __syncthreads();   // the previous pass's rows are out
      for (int i = tid; i < np * kMaxNeedle; i += kThreads)
        sh.needle[i / kMaxNeedle][i % kMaxNeedle] =
            a.needle[p0 + i / kMaxNeedle][i % kMaxNeedle];
      if (tid < np) {
        const int len = a.len[p0 + tid];
        const int key = len > 1 ? len - 2 : 0;
        sh.len[tid] = len;
        sh.key[tid] = key;
        sh.pat[tid][0] = a.needle[p0 + tid][key] * 0x01010101u;
        sh.pat[tid][1] = a.needle[p0 + tid][key + 1] * 0x01010101u;
      }
      for (int i = tid; i < kPass * kTileWords; i += kThreads)
        (&sh.flags[0][0])[i] = 0u;
      for (int c0 = b0; c0 < b1; c0 += min(kChunk, b1 - c0)) {
        const int c1 = c0 + min(kChunk, b1 - c0);             // starts
        const int e1 = c1 + min(kMaxNeedle - 1, b1 - c1);     // bytes
        const int shift = (int)((uintptr_t)(a.buf + c0) & 15);
        const int span = c1 - c0, lim = e1 - c0;
        const bool fresh = !(one_chunk && p0 > 0);
        if (fresh) {
          stage_bytes(a.buf, c0, e1, s_bytes, shift);
          have_first = false;
        }
        __syncthreads();   // bytes, offsets, needles and cleared flags
        for (int t = 0; t < np; ++t) {
          const int len = sh.len[t];
          if (len <= 0) continue;   // uniform: the output phase rules
          const int key = sh.key[t];
          // (A) a bit at every staged byte where the needle's bytes key
          // and key + 1 sit (key only, for a needle of one byte): 32
          // staged bytes a thread a step, no branch
          const int ncw = (shift + span + key + 31) >> 5;
          const uint32_t pa = sh.pat[t][0], pb = sh.pat[t][1];
          int busy = 0;
          for (int k = tid; k < ncw; k += kThreads) {
            const uint4 u0 = w128[2 * k], u1 = w128[2 * k + 1];
            const uint32_t x[9] = {u0.x, u0.y, u0.z, u0.w, u1.x,
                                   u1.y, u1.z, u1.w, w32[8 * k + 8]};
            uint32_t m = 0;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              uint32_t z = zero_bytes(x[i] ^ pa);
              if (len > 1)
                z &= zero_bytes(__byte_perm(x[i], x[i + 1], 0x4321) ^ pb);
              m |= byte_flags(z) << (4 * i);
            }
            s_cand[k] = m;
            busy |= m != 0;
          }
          // dense candidates take their owners from a table of the chunk
          // (built once a chunk, for every term), sparse ones a binary
          // search over the offsets each
          const bool table = __syncthreads_count(busy) > kThreads / 8;
          if (table && !have_first) {
            // s_first[w]: the value that holds staged byte 32w (0 before
            // the tile's first byte)
            for (int i = tid; i < nv; i += kThreads) {
              const int sa = s_off[i] - c0 + shift;
              const int sb = s_off[i + 1] - c0 + shift;
              const int w_end = min((sb + 31) >> 5, kCandWords);
              for (int w = sa <= 0 ? 0 : (sa + 31) >> 5; w < w_end; ++w)
                s_first[w] = i;
            }
            if (tid == 0 && c0 - shift < b0) s_first[0] = 0;
            have_first = true;
            __syncthreads();
          }
          // (B) each candidate: a start in this chunk, the whole needle
          // there, the owner and the match ending inside it
          for (int k = tid; k < ncw; k += kThreads) {
            uint32_t m = s_cand[k];
            while (m) {
              const int s = (k << 5) + __ffs(m) - 1 - key;   // staged start
              m &= m - 1;
              const int r = s - shift;
              if (r < 0 || r >= span || r + len > lim) continue;
              int j = 0;
              while (j < len && s_bytes[s + j] == sh.needle[t][j]) ++j;
              if (j < len) continue;
              const int p = c0 + r;
              int o = 0;
              if (table) {
                o = s_first[s >> 5];
                while (o + 1 < nv && s_off[o + 1] <= p) ++o;
              } else {
                int h = nv;   // s_off[o] <= p < s_off[h]
                while (h - o > 1) {
                  const int mid = (o + h) >> 1;
                  if (s_off[mid] <= p) o = mid; else h = mid;
                }
              }
              if (p + len <= s_off[o + 1])
                atomicOr(&sh.flags[t][o >> 5], 1u << (o & 31));
            }
          }
          __syncthreads();   // (A)'s bitmap is free for the next term
        }
      }
      __syncthreads();   // the pass's flags (and, for an empty tile, its
                         // needles) are final
      if (a.words) {
        uint32_t* out = reinterpret_cast<uint32_t*>(a.out);
        const int per = nv32 >> 5;
        for (int j = tid; j < np * per; j += kThreads) {
          const int t = j / per, k = j - t * per;
          const int len = sh.len[t];
          const uint32_t word = len > 0 ? sh.flags[t][k]
                                : len == 0 ? low_bits(nv - 32 * k) : 0u;
          out[(int64_t)(p0 + t) * a.pitch + (v0 >> 5) + k] = word;
          if (word) s_any[p0 + t] = 1;
        }
      } else {
        const int per = (nv + 3) >> 2;
        for (int j = tid; j < np * per; j += kThreads) {
          const int t = j / per, i = 4 * (j - t * per);
          const int len = sh.len[t];
          const int n = min(4, nv - i);
          const uint32_t bits =
              (len > 0 ? sh.flags[t][i >> 5] >> (i & 31)
                       : len == 0 ? 0xfu : 0u) & low_bits(n);
          const uint32_t bytes = (bits & 1u) | ((bits & 2u) << 7) |
                                 ((bits & 4u) << 14) | ((bits & 8u) << 21);
          uint8_t* dst = a.out + (int64_t)(p0 + t) * a.pitch + v0 + i;
          if (n == 4 && ((uintptr_t)dst & 3) == 0)
            *reinterpret_cast<uint32_t*>(dst) = bytes;
          else
            for (int k = 0; k < n; ++k) dst[k] = (uint8_t)(bits >> k & 1u);
          if (bits) s_any[p0 + t] = 1;
        }
      }
    }
  }
  __syncthreads();
  const int G = gridDim.x;
  for (int t = tid; t < a.n_terms; t += kThreads)
    a.partials[(int64_t)t * G + blockIdx.x] = s_any[t];
  cg::this_grid().sync();
  for (int t = blockIdx.x; t < a.n_terms; t += G) {
    int v = 0;
    for (int g = tid; g < G; g += kThreads)
      v |= __ldcg(a.partials + (int64_t)t * G + g);
    v = __syncthreads_or(v);
    if (tid == 0) a.any_hits[t] = v != 0;
  }
}

int64_t round16(int64_t x) { return (x + 15) / 16 * 16; }

// The output allocation's bytes and layout: the rows (bool [T, V] or
// words [T, W]), any_hits [T] from the next 16-byte boundary, then the
// partials [T, grid] from the one after (grid <= tiles <= ceil(V / 32)),
// in whole 16-byte units.
int64_t out_bytes(int T, int64_t V, int words, int64_t* any_at,
                  int64_t* part_at) {
  const int64_t W = (V + 31) / 32;
  const int64_t rows = words ? (int64_t)T * W * 4 : (int64_t)T * V;
  *any_at = round16(rows);
  *part_at = round16(*any_at + T);
  return round16(*part_at + (int64_t)T * (W > 1 ? W : 1));
}

// Values a tile for V values on a card that holds `cap` CTAs at once: no
// more tiles than CTAs where V allows; a multiple of 32 in [32, kTile].
int tile_for(int64_t V, int cap) {
  const int64_t t = (V + cap - 1) / (cap > 0 ? cap : 1);
  const int64_t t32 = (t + 31) / 32 * 32;
  return (int)(t32 < 32 ? 32 : (t32 > kTile ? kTile : t32));
}

// Per device, once: the kernel's shared-memory allowance (the same for
// every call, so never set per call while other host threads launch it)
// and the CTAs of probe_kernel the card holds at once.
int probe_capacity(int* cap) {
  static std::atomic<int> ready[kMaxDevices];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const int known = ready[dev].load(std::memory_order_acquire);
  if (known > 0) {
    *cap = known;
    return 0;
  }
  int per_sm = 0, sms = 0;
  rc = cudaFuncSetAttribute((const void*)probe_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)sizeof(Shared));
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, probe_kernel, kThreads, sizeof(Shared));
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return (int)rc;
  if (per_sm < 1 || sms < 1) return (int)cudaErrorInvalidConfiguration;
  ready[dev].store(per_sm * sms, std::memory_order_release);
  *cap = per_sm * sms;
  return 0;
}

// One launch over terms [t0, t0 + nt) of the call.
int probe_launch(const void* buf, const void* off, int64_t n_vals,
                 const uint8_t* needles,
                 const int32_t* lens, int t0, int nt, int pitch_bytes,
                 int words, uint8_t* out, int64_t any_at, int64_t part_at,
                 cudaStream_t s) {
  int cap = 0;
  const int rc = probe_capacity(&cap);
  if (rc != 0) return rc;
  const int tile = tile_for(n_vals, cap);
  const int64_t tiles = (n_vals + tile - 1) / tile;
  int64_t grid = tiles < cap ? tiles : cap;
  if (grid < 1) grid = 1;
  ProbeArgs a;
  memset(&a, 0, sizeof(a));
  a.buf = (const uint8_t*)buf;
  a.off = (const int32_t*)off;
  a.pitch = words ? (n_vals + 31) / 32 : n_vals;
  a.out = out + (int64_t)t0 * a.pitch * (words ? 4 : 1);
  a.any_hits = out + any_at + t0;
  a.partials = out + part_at + (int64_t)t0 * grid;
  a.n_vals = n_vals;
  a.n_terms = nt;
  a.words = words;
  a.tile = tile;
  a.tiles = (int)tiles;
  for (int t = 0; t < nt; ++t) {
    const int len = lens[t0 + t];
    if (len > pitch_bytes) return (int)cudaErrorInvalidValue;
    a.len[t] = len < 0 ? -1 : len;
    if (len > 0)
      memcpy(a.needle[t], needles + (int64_t)(t0 + t) * pitch_bytes,
             (size_t)len);
  }
  void* args[] = {(void*)&a};
  return (int)cudaLaunchCooperativeKernel((const void*)probe_kernel,
                                          dim3((unsigned)grid),
                                          dim3(kThreads), args,
                                          sizeof(Shared), s);
}

}  // namespace

extern "C" {

// K3's constants, for the wrapper to check its mirror of them.
int tt_probe_tile() { return kTile; }
int tt_probe_chunk() { return kChunk; }
int tt_probe_launch_terms() { return kLaunchTerms; }
int tt_probe_tile_for(int64_t V, int cap) { return tile_for(V, cap); }

// The bytes tt_dict_probe's `out` must hold for T terms over V values.
int64_t tt_probe_out_bytes(int T, int64_t V, int words) {
  int64_t any_at = 0, part_at = 0;
  return out_bytes(T, V, words, &any_at, &part_at);
}

// buf: u8 [N] and off: i32 [V+1] on the card; needles: u8 [T, pitch] and
// lens: i32 [T] in host memory (they travel in the launch's parameters;
// lens 0 = the empty needle, < 0 = a term that matches nothing); out: u8
// [out_bytes] on the card, at least tt_probe_out_bytes(T, V, words): the
// rows (bool [T, V], or with `words` u32 [T, ceil(V/32)]), any_hits [T]
// and the kernel's partials. One launch for up to kLaunchTerms terms (one
// more for each further kLaunchTerms), nothing else on the stream. Returns
// the cudaError_t of the launches (0 = launched).
int tt_dict_probe(const void* buf, const void* off, int64_t n_vals,
                  const void* needles, const void* lens, int n_terms,
                  int pitch, int words, void* out, int64_t out_len,
                  void* stream) {
  if (n_terms <= 0) return 0;
  if (n_vals < 0 || n_vals >= 0x7fffffffLL || pitch < 1 ||
      pitch > kMaxNeedle)
    return (int)cudaErrorInvalidValue;
  int64_t any_at = 0, part_at = 0;
  if (out_len < out_bytes(n_terms, n_vals, words, &any_at, &part_at))
    return (int)cudaErrorInvalidValue;
  for (int t0 = 0; t0 < n_terms; t0 += kLaunchTerms) {
    const int nt =
        n_terms - t0 < kLaunchTerms ? n_terms - t0 : kLaunchTerms;
    const int rc = probe_launch(buf, off, n_vals, (const uint8_t*)needles,
                                (const int32_t*)lens, t0, nt, pitch, words,
                                (uint8_t*)out, any_at, part_at,
                                (cudaStream_t)stream);
    if (rc != 0) return rc;
  }
  return 0;
}

const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
