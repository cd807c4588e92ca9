// Device helpers shared by csrc/scan.cu (K1, K1s, K4) and
// csrc/structural.cu (K6): the kv column readers of the unpacked and
// packed layouts, the hit-table lookup, a term's value test, one kv
// slot's term test and the duration test, so that the kernels cannot
// drift apart. See scan.cu's
// header for the layouts.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// kv column layouts, as the wrappers in kernels/scan.py number them
enum Layout : int {
  kIds8 = 0, kIds16 = 1, kIds32 = 2,   // unpacked: signed ids, pad -1
  kU4 = 3, kU8 = 4, kU16 = 5, kU32 = 6  // packed: codes id+1, pad 0
};

// Readers of one entry's kv slots: `at` points at entry i of a column
// with C (unpacked) slots per entry; r[c] is slot c's id, -1 for a pad.
template <typename T>
struct Ids {
  const T* p;
  __device__ __forceinline__ void at(const void* base, int64_t i, int C) {
    p = (const T*)base + i * C;
  }
  __device__ __forceinline__ int32_t operator[](int c) const {
    return (int32_t)p[c];
  }
};

template <typename U>
struct Codes {
  const U* p;
  __device__ __forceinline__ void at(const void* base, int64_t i, int C) {
    p = (const U*)base + i * C;
  }
  __device__ __forceinline__ int32_t operator[](int c) const {
    return (int32_t)((uint32_t)p[c] - 1u);
  }
};

struct Nibbles {            // C is even; an entry holds C / 2 bytes
  const uint8_t* p;
  __device__ __forceinline__ void at(const void* base, int64_t i, int C) {
    p = (const uint8_t*)base + i * (C >> 1);
  }
  __device__ __forceinline__ int32_t operator[](int c) const {
    return (int32_t)((p[c >> 1] >> ((c & 1) << 2)) & 0xF) - 1;
  }
};

// One term's hit row: bytes (one per value) or 32-bit words; n = its
// length in elements. v >= 0.
__device__ __forceinline__ bool hit_lookup(const void* h, int64_t n,
                                           bool words, int32_t v) {
  if (words) {
    int64_t w = v >> 5;
    if (w >= n) w = n - 1;
    return (__ldg((const uint32_t*)h + w) >> (v & 31)) & 1u;
  }
  return __ldg((const uint8_t*)h + ((int64_t)v < n ? (int64_t)v : n - 1))
         != 0;
}

__device__ __forceinline__ const void* hit_row(const void* base, int64_t row,
                                               int64_t n, bool words) {
  return words ? (const void*)((const uint32_t*)base + row * n)
               : (const void*)((const uint8_t*)base + row * n);
}

// One term's value test of value id v: a lookup in the term's hit row
// `h` (hit-mask mode; an id < 0 never hits), or the range test over `rg`
// [R][2].
__device__ __forceinline__ bool value_ok(int32_t v, const int32_t* rg,
                                         int R, const void* h,
                                         int64_t n_vals, bool words) {
  if (h != nullptr) return v >= 0 && n_vals > 0 &&
                           hit_lookup(h, n_vals, words, v);
  for (int r = 0; r < R; ++r)
    if (v >= rg[2 * r] && v <= rg[2 * r + 1]) return true;
  return false;
}

// One kv slot against one term: key equality, then value_ok. `kk`/`vv`
// are readers of the entry's slots; the value slot is read only when the
// key matches.
template <typename KP, typename VP>
__device__ __forceinline__ bool slot_hit(const KP& kk, const VP& vv, int c,
                                         int32_t key, const int32_t* rg,
                                         int R, const void* h,
                                         int64_t n_vals, bool words) {
  if (kk[c] != key) return false;
  return value_ok(vv[c], rg, R, h, n_vals, words);
}

// The duration column: u32 (shift -1), exact u16 (shift 0), or u16
// buckets with an s-bit residual of res_bytes bytes (shift s > 0).
struct DurCol {
  const void* dur;
  const void* res;
  int shift;
  int res_bytes;
};

__device__ __forceinline__ uint32_t dur_raw(const DurCol& d, int64_t i) {
  return d.shift < 0 ? ((const uint32_t*)d.dur)[i]
                     : (uint32_t)((const uint16_t*)d.dur)[i];
}

// lo <= duration(i) <= hi, given its raw column value q
__device__ __forceinline__ bool dur_ok(const DurCol& d, int64_t i,
                                       uint32_t q, uint32_t lo,
                                       uint32_t hi) {
  if (d.shift <= 0) return q >= lo && q <= hi;
  const uint32_t lq = lo >> d.shift, hq = hi >> d.shift;
  if (q > lq && q < hq) return true;
  if (q != lq && q != hq) return false;
  const uint32_t r = d.res_bytes == 1
                         ? (uint32_t)((const uint8_t*)d.res)[i]
                         : (uint32_t)((const uint16_t*)d.res)[i];
  const uint32_t full = (q << d.shift) | r;
  return full >= lo && full <= hi;
}

// Calls f(KR{}, VR{}) with the readers of a layout pair: both unpacked
// (all nine pairs) or both packed (all sixteen); kIds32Only admits the
// unpacked int32 pair alone (K1s stages int32 ids).
template <typename F>
int with_codes(int layout, F&& f) {
  switch (layout) {
    case kU4: return f(Nibbles{});
    case kU8: return f(Codes<uint8_t>{});
    case kU16: return f(Codes<uint16_t>{});
    case kU32: return f(Codes<uint32_t>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename F>
int with_ids(int layout, F&& f) {
  switch (layout) {
    case kIds8: return f(Ids<int8_t>{});
    case kIds16: return f(Ids<int16_t>{});
    case kIds32: return f(Ids<int32_t>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kIds32Only, typename F>
int with_readers(int kl, int vl, F&& f) {
  if (kl >= kU4 && vl >= kU4)
    return with_codes(kl, [&](auto k) {
      return with_codes(vl, [&](auto v) { return f(k, v); });
    });
  if constexpr (kIds32Only) {
    if (kl != kIds32 || vl != kIds32) return (int)cudaErrorInvalidValue;
    return f(Ids<int32_t>{}, Ids<int32_t>{});
  } else {
    if (kl < kU4 && vl < kU4)
      return with_ids(kl, [&](auto k) {
        return with_ids(vl, [&](auto v) { return f(k, v); });
      });
    return (int)cudaErrorInvalidValue;
  }
}

bool valid_dur(int shift, int res_bytes, const void* res) {
  if (shift <= 0) return true;
  return shift <= 16 && res != nullptr &&
         res_bytes == (shift <= 8 ? 1 : 2);
}

// C counts unpacked slots; a u4 column needs it even
bool valid_layouts(int kl, int vl, int C) {
  return !((kl == kU4 || vl == kU4) && (C & 1));
}

}  // namespace
