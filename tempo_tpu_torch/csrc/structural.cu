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
// Design (correct first; speed is a later PR's): a fixed grid of CTAs
// walks work items (page, lane). A page's spans lie in the range from its
// entries' smallest run begin to their largest run end: exactly its spans
// when runs are in entry order (as the container and stack_spans write
// them), other pages' spans as well otherwise (evaluated, never read).
// Its registers live as bit words in this CTA's slice of a global scratch
// [grid][max_run][W], max_run the widest page's range; a wider range
// traps. Span slots run in order with a __syncthreads between them,
// threads striding over the range; then one thread per entry runs the whole trace
// program, its registers in local words, each segment reduction a loop
// over the entry's run. Bound on an H100: bytes; the span columns (~49 B a
// span), the entry columns and one verdict byte per entry and lane.

#include "scan_common.cuh"

namespace {

constexpr int kK6Threads = 256;
constexpr int kMaxRegWords = 8;      // registers per program, at most 256

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

struct K6Args {
  // entries
  const void* kv_key;
  const void* kv_val;
  int key_layout, val_layout;
  DurCol dur;
  const bool* entry_valid;       // [P, E]
  const int32_t* page_block;     // [P]
  int64_t P;
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
  const int32_t* seg_begin;      // [P * E]
  const int32_t* seg_count;
  int max_run;                   // the widest page's span range
  uint32_t* scratch;             // [grid][max_run][span_words]
  int span_words;
  // lanes
  int Q, B, T, R, D, K, A, NS, NT;
  const int32_t* span_prog;      // [Q, NS, 4]
  const int32_t* trace_prog;     // [Q, NT, 4]
  const int32_t* term_keys;      // [Q, B, T]
  const int32_t* val_ranges;     // [Q, B, T, R, 2]
  const uint32_t* dur_params;    // [Q, D, 2]
  const int32_t* kind_params;    // [Q, K]
  const uint32_t* agg_params;    // [Q, A, 3]
  const int32_t* block_group;    // [Q, B] or null
  const int64_t* hit_meta;       // [Q, 3]: address (0: none), t_stride,
                                 // row length in elements; or null
  int hit_words;
  uint8_t* verdicts;             // [Q, P * E]
};

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

// One term's test over a row of kv slots, for lane q and block row blk
// (term index clamped to the tables; the hit row clamped to the lane's
// own table).
template <typename KR, typename VR>
__device__ bool term_test(const K6Args& a, int q, int blk, int t,
                          const KR& kk, const VR& vv, int C) {
  t = clampi(t, 0, a.T - 1);
  const int64_t row = ((int64_t)q * a.B + blk) * a.T + t;
  const int32_t key = __ldg(a.term_keys + row);
  const int32_t* rg = a.val_ranges + row * a.R * 2;
  const void* h = nullptr;
  int64_t nv = 0;
  const bool words = a.hit_words != 0;
  if (a.hit_meta != nullptr) {
    const int32_t g = __ldg(a.block_group + (int64_t)q * a.B + blk);
    const int64_t base = a.hit_meta[3 * q];
    if (g >= 0 && base != 0) {
      const int64_t ts = a.hit_meta[3 * q + 1];
      nv = a.hit_meta[3 * q + 2];
      h = hit_row((const void*)(uintptr_t)base,
                  (int64_t)g * ts + (t < ts ? t : ts - 1), nv, words);
    }
  }
  for (int c = 0; c < C; ++c)
    if (slot_hit(kk, vv, c, key, rg, a.R, h, nv, words)) return true;
  return false;
}

__device__ __forceinline__ bool reg_bit(const uint32_t* w, int r) {
  return (w[r >> 5] >> (r & 31)) & 1u;
}

__global__ void __launch_bounds__(kK6Threads)
structural_kernel(const K6Args a) {
  __shared__ int s_lo, s_hi;
  const int tid = threadIdx.x;
  const int sw = a.span_words;
  uint32_t* scratch =
      a.scratch + (int64_t)blockIdx.x * a.max_run * (int64_t)sw;
  const int64_t n = a.P * a.E;
  const bool spans = a.span_parent != nullptr;
  for (int64_t w = blockIdx.x; w < a.P * a.Q; w += gridDim.x) {
    const int64_t page = w / a.Q;
    const int q = (int)(w % a.Q);
    const int32_t blk = __ldg(a.page_block + page);
    uint8_t* out = a.verdicts + (int64_t)q * n + page * a.E;
    if (blk < 0) {                      // a pad page: nothing is valid
      for (int e = tid; e < a.E; e += blockDim.x) out[e] = 0;
      continue;
    }
    // ---- span slots over this page's run [lo, hi)
    int lo = 0, hi = 0;
    if (spans) {
      if (tid == 0) {
        s_lo = 0x7FFFFFFF;
        s_hi = 0;
      }
      __syncthreads();
      int mlo = 0x7FFFFFFF, mhi = 0;
      for (int e = tid; e < a.E; e += blockDim.x) {
        const int64_t i = page * a.E + e;
        const int32_t c = a.seg_count[i];
        if (c > 0) {
          mlo = min(mlo, a.seg_begin[i]);
          mhi = max(mhi, a.seg_begin[i] + c);
        }
      }
      if (mhi > 0) {
        atomicMin(&s_lo, mlo);
        atomicMax(&s_hi, mhi);
      }
      __syncthreads();
      lo = s_lo;
      hi = s_hi;
      if (hi <= lo) hi = lo;                           // no spans
      // staging sizes max_run to every page's run (max_page_run); a
      // wider one would overrun this CTA's scratch: fail the launch
      if (hi - lo > a.max_run) __trap();
      for (int j = tid; j < (hi - lo) * sw; j += blockDim.x) scratch[j] = 0;
      __syncthreads();
      const int32_t* prog = a.span_prog + (int64_t)q * a.NS * 4;
      for (int i = 0; i < a.NS && hi > lo; ++i) {
        const int opc = prog[4 * i], ia = prog[4 * i + 1],
                  ib = prog[4 * i + 2];
        const int ra = clampi(ia, 0, i), rb = clampi(ib, 0, i);
        const int dst = i + 1;
        if (opc >= 1 && opc <= 8) {
          for (int j = lo + tid; j < hi; j += blockDim.x) {
            const uint32_t* rj = scratch + (int64_t)(j - lo) * sw;
            const bool real = a.span_trace[j] >= 0;
            bool v = false;
            switch (opc) {
              case 1: {
                const int sb = max(a.span_block[j], 0);
                const Ids<int32_t> kk{a.span_kv_key + (int64_t)j * a.Cs};
                const Ids<int32_t> vv{a.span_kv_val + (int64_t)j * a.Cs};
                v = real && term_test(a, q, sb, ia, kk, vv, a.Cs);
                break;
              }
              case 2: {
                const uint32_t* d =
                    a.dur_params + ((int64_t)q * a.D + clampi(ia, 0, a.D - 1)) * 2;
                const uint32_t x = a.span_dur[j];
                v = real && x >= d[0] && x <= d[1];
                break;
              }
              case 3:
                v = real && (int32_t)a.span_kind[j] ==
                                a.kind_params[(int64_t)q * a.K +
                                              clampi(ia, 0, a.K - 1)];
                break;
              case 4: v = reg_bit(rj, ra) && reg_bit(rj, rb); break;
              case 5: v = reg_bit(rj, ra) || reg_bit(rj, rb); break;
              case 6: v = real && !reg_bit(rj, ra); break;
              case 7: {
                const int32_t p = a.span_parent[j];
                v = reg_bit(rj, rb) && p >= lo && p < hi &&
                    reg_bit(scratch + (int64_t)(p - lo) * sw, ra);
                break;
              }
              default: {   // 8 desc: a bounded walk up the ancestors
                if (!reg_bit(rj, rb)) break;
                const int32_t t = a.span_trace[j];
                const int32_t steps = t >= 0 ? a.seg_count[t] : 0;
                int32_t p = a.span_parent[j];
                for (int32_t s = 0; s < steps && p >= lo && p < hi; ++s) {
                  const uint32_t* rp = scratch + (int64_t)(p - lo) * sw;
                  if (reg_bit(rp, ra)) {
                    v = true;
                    break;
                  }
                  p = a.span_parent[p];
                }
                break;
              }
            }
            if (v) scratch[(int64_t)(j - lo) * sw + (dst >> 5)] |=
                1u << (dst & 31);
          }
        }
        __syncthreads();
      }
    }
    // ---- trace slots, one thread per entry
    const int32_t* tprog = a.trace_prog + (int64_t)q * a.NT * 4;
    for (int e = tid; e < a.E; e += blockDim.x) {
      const int64_t i = page * a.E + e;
      if (!a.entry_valid[i]) {
        out[e] = 0;
        continue;
      }
      int32_t sb = 0, sn = 0;
      if (spans && hi > lo) {
        sn = a.seg_count[i];
        sb = a.seg_begin[i];
        if (sn < 0 || sb < lo || sb + sn > hi) sn = 0;
      }
      uint32_t tr[kMaxRegWords];
#pragma unroll
      for (int k = 0; k < kMaxRegWords; ++k) tr[k] = 0;
      for (int s = 0; s < a.NT; ++s) {
        const int opc = tprog[4 * s], ia = tprog[4 * s + 1],
                  ib = tprog[4 * s + 2], ic = tprog[4 * s + 3];
        bool v = false;
        switch (opc) {
          case 1: {
            const Dyn kk{a.kv_key, a.key_layout, i, a.C};
            const Dyn vv{a.kv_val, a.val_layout, i, a.C};
            v = term_test(a, q, blk, ia, kk, vv, a.C);
            break;
          }
          case 2: {
            const uint32_t* d =
                a.dur_params + ((int64_t)q * a.D + clampi(ia, 0, a.D - 1)) * 2;
            v = dur_ok(a.dur, i, dur_raw(a.dur, i), d[0], d[1]);
            break;
          }
          case 3:
          case 4:
          case 5: {
            const int r = clampi(ia, 0, a.NS);
            const uint32_t* g =
                a.agg_params + ((int64_t)q * a.A + clampi(ib, 0, a.A - 1)) * 3;
            uint32_t cnt = 0, c_hi = 0, c_lo = 0;
            const uint32_t x = g[2];
            for (int32_t j = sb; j < sb + sn; ++j) {
              if (!reg_bit(scratch + (int64_t)(j - lo) * sw, r)) continue;
              ++cnt;
              if (opc == 5) {
                const uint32_t d = a.span_dur[j];
                c_hi += ic == 0 ? d > x : d >= x;
                c_lo += ic == 2 ? d < x : d <= x;
              }
            }
            if (opc == 3) {
              v = spans && cnt > 0;
            } else if (opc == 4) {
              v = cmp_code(cnt, g[0], ic);
            } else if (spans && cnt > 0) {
              const uint32_t qd = max(g[1], 1u);
              const uint32_t rank = (g[0] * cnt + qd - 1u) / qd;
              const bool ok_hi = c_hi >= cnt - rank + 1u;
              const bool ok_lo = c_lo >= rank;
              const bool eq = ok_hi && ok_lo;
              v = ic <= 1 ? ok_hi : ic <= 3 ? ok_lo : ic == 4 ? eq : !eq;
            }
            break;
          }
          case 6:
            v = reg_bit(tr, clampi(ia, 0, s)) && reg_bit(tr, clampi(ib, 0, s));
            break;
          case 7:
            v = reg_bit(tr, clampi(ia, 0, s)) || reg_bit(tr, clampi(ib, 0, s));
            break;
          case 8: v = !reg_bit(tr, clampi(ia, 0, s)); break;
          default: break;
        }
        if (v) tr[(s + 1) >> 5] |= 1u << ((s + 1) & 31);
      }
      out[e] = reg_bit(tr, a.NT) ? 1 : 0;
    }
    __syncthreads();   // the next item reuses s_lo/s_hi and the scratch
  }
}

}  // namespace

extern "C" {

// K6. Entry columns as for K1 (layouts, durations); the span segment
// (span_parent null: none) with each page's span range at most max_run
// and scratch of grid * max_run * span_words u32; Q lanes of programs and
// tables (block_group and hit_meta both null or both set). verdicts
// [Q, P * E]. Returns the cudaError_t of the launch (0 = launched).
int tt_structural_mask(
    int key_layout, int val_layout, const void* kv_key, const void* kv_val,
    const void* entry_dur, const void* entry_dur_res, int dur_shift,
    int res_bytes, const void* entry_valid, const void* page_block,
    int64_t P, int E, int C, const void* span_trace, const void* span_parent,
    const void* span_block, const void* span_dur, const void* span_kind,
    const void* span_kv_key, const void* span_kv_val, int Cs,
    const void* seg_begin, const void* seg_count, int max_run,
    void* scratch, int span_words, int grid, int Q, int B, int T, int R,
    int D, int K, int A, int NS, int NT, const void* span_prog,
    const void* trace_prog, const void* term_keys, const void* val_ranges,
    const void* dur_params, const void* kind_params, const void* agg_params,
    const void* block_group, const void* hit_meta, int hit_words,
    void* verdicts, void* stream) {
  if (P <= 0 || E <= 0 || Q <= 0) return 0;
  if (Q < 1 || B < 1 || T < 1 || R < 1 || D < 1 || K < 1 || A < 1 ||
      NS < 1 || NT < 1 || NS + 1 > 32 * span_words ||
      NT + 1 > 32 * kMaxRegWords || span_words > kMaxRegWords ||
      grid < 1 || (block_group == nullptr) != (hit_meta == nullptr) ||
      (span_parent != nullptr && (scratch == nullptr || max_run < 0)) ||
      !valid_dur(dur_shift, res_bytes, entry_dur_res) ||
      !valid_layouts(key_layout, val_layout, C) ||
      (key_layout < kU4) != (val_layout < kU4))
    return (int)cudaErrorInvalidValue;
  K6Args a;
  a.kv_key = kv_key;
  a.kv_val = kv_val;
  a.key_layout = key_layout;
  a.val_layout = val_layout;
  a.dur = DurCol{entry_dur, entry_dur_res, dur_shift, res_bytes};
  a.entry_valid = (const bool*)entry_valid;
  a.page_block = (const int32_t*)page_block;
  a.P = P;
  a.E = E;
  a.C = C;
  a.span_trace = (const int32_t*)span_trace;
  a.span_parent = (const int32_t*)span_parent;
  a.span_block = (const int32_t*)span_block;
  a.span_dur = (const uint32_t*)span_dur;
  a.span_kind = (const int8_t*)span_kind;
  a.span_kv_key = (const int32_t*)span_kv_key;
  a.span_kv_val = (const int32_t*)span_kv_val;
  a.Cs = Cs;
  a.seg_begin = (const int32_t*)seg_begin;
  a.seg_count = (const int32_t*)seg_count;
  a.max_run = max_run;
  a.scratch = (uint32_t*)scratch;
  a.span_words = span_words;
  a.Q = Q;
  a.B = B;
  a.T = T;
  a.R = R;
  a.D = D;
  a.K = K;
  a.A = A;
  a.NS = NS;
  a.NT = NT;
  a.span_prog = (const int32_t*)span_prog;
  a.trace_prog = (const int32_t*)trace_prog;
  a.term_keys = (const int32_t*)term_keys;
  a.val_ranges = (const int32_t*)val_ranges;
  a.dur_params = (const uint32_t*)dur_params;
  a.kind_params = (const int32_t*)kind_params;
  a.agg_params = (const uint32_t*)agg_params;
  a.block_group = (const int32_t*)block_group;
  a.hit_meta = (const int64_t*)hit_meta;
  a.hit_words = hit_words;
  a.verdicts = (uint8_t*)verdicts;
  structural_kernel<<<grid, kK6Threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
