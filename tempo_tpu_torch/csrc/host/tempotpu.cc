// The port's native host runtime: block codecs, hashing, the dictionary
// substring scan and the OTLP ingest walker, bound with ctypes by
// tempo_tpu_torch/ops/native.py, which builds this file with the host's
// C++ compiler at its first use. It is the port's own copy of the
// reference's host runtime (native/tempotpu.cc, libtempotpu.so) and shares
// no file or library with it; the exported functions have the reference's
// names and calling conventions, so the two agree on every wire form.
//
// Where it differs from the reference's source:
// - No codec header or library is needed at compile time. zstd and lz4
//   are resolved by soname (dlopen) at their first use, so a host without
//   one of those libraries loses only that codec (its functions return
//   ERR_NO_CODEC, and the binding raises naming it). Snappy is written out
//   here (the raw snappy block format), since hosts may lack libsnappy.
//   The walker, the scan, XXH64 and CRC32C need nothing external.
// - The ingest walker writes a regrouped ResourceSpans as resource (1),
//   scope_spans (2), schema_url (3), and a ScopeSpans as scope (1), spans
//   (2), schema_url (3), dropping any other field: the bytes protobuf
//   writes for the Python walk (modules/distributor.py regroup_extract).
//   The reference's walker copies those fields in input order, so a
//   pushed schema_url lands before the spans there, and unknown fields
//   pass through.
//
// All functions return the produced byte count, or a negative error code.

#ifndef _GNU_SOURCE
#define _GNU_SOURCE  // memmem
#endif
#include <dlfcn.h>

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <mutex>

namespace {

constexpr long long ERR_FAILED = -1;
constexpr long long ERR_GROW = -2;      // the caller must grow dst
constexpr long long ERR_NO_CODEC = -5;  // the codec's library is missing

// ---- codec libraries, resolved by soname at first use ----

// the zstd and lz4 functions used, declared by hand (stable C ABIs)
constexpr unsigned long long ZSTD_CONTENTSIZE_UNKNOWN = 0ULL - 1;
constexpr unsigned long long ZSTD_CONTENTSIZE_ERROR = 0ULL - 2;
constexpr int ZSTD_error_dstSize_tooSmall = 70;  // zstd_errors.h

struct Zstd {
  size_t (*compress)(void*, size_t, const void*, size_t, int) = nullptr;
  size_t (*decompress)(void*, size_t, const void*, size_t) = nullptr;
  unsigned long long (*content_size)(const void*, size_t) = nullptr;
  unsigned (*is_error)(size_t) = nullptr;
  int (*error_code)(size_t) = nullptr;
};

struct Lz4 {
  int (*compress)(const char*, char*, int, int) = nullptr;
  int (*decompress)(const char*, char*, int, int) = nullptr;
};

void* open_first(const char* const* names) {
  for (; *names; names++) {
    void* h = dlopen(*names, RTLD_NOW | RTLD_LOCAL);
    if (h) return h;
  }
  return nullptr;
}

template <typename F>
bool sym(void* h, const char* name, F& out) {
  out = reinterpret_cast<F>(dlsym(h, name));
  return out != nullptr;
}

// thread-safe one-time resolution (a function-local static); a codec
// whose library or a symbol is missing stays null
const Zstd* zstd_lib() {
  static const Zstd* lib = [] () -> const Zstd* {
    static const char* const names[] = {"libzstd.so.1", "libzstd.so",
                                        nullptr};
    void* h = open_first(names);
    static Zstd z;
    if (!h || !sym(h, "ZSTD_compress", z.compress) ||
        !sym(h, "ZSTD_decompress", z.decompress) ||
        !sym(h, "ZSTD_getFrameContentSize", z.content_size) ||
        !sym(h, "ZSTD_isError", z.is_error) ||
        !sym(h, "ZSTD_getErrorCode", z.error_code))
      return nullptr;
    return &z;
  }();
  return lib;
}

const Lz4* lz4_lib() {
  static const Lz4* lib = [] () -> const Lz4* {
    static const char* const names[] = {"liblz4.so.1", "liblz4.so",
                                        nullptr};
    void* h = open_first(names);
    static Lz4 l;
    if (!h || !sym(h, "LZ4_compress_default", l.compress) ||
        !sym(h, "LZ4_decompress_safe", l.decompress))
      return nullptr;
    return &l;
  }();
  return lib;
}

// ---- snappy, the raw block format (no framing) ----
//
// A varint of the uncompressed length, then elements: a literal (tag
// low bits 00, length - 1 in the tag's upper six bits below 60, else in
// the 1-4 bytes after it) or a copy of earlier output (01: length 4-11,
// an 11-bit offset; 10: length 1-64, a 16-bit offset; 11: a 32-bit
// offset). The encoder works in 64 KiB blocks, so its offsets fit 16
// bits, with a hash table of 4-byte prefixes; any snappy decoder reads
// its output, and the decoder reads any snappy encoder's.

constexpr size_t SNAPPY_BLOCK = 1 << 16;
constexpr int SNAPPY_HASH_BITS = 14;   // the most; a short input uses fewer

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

inline uint32_t snappy_hash(uint32_t v, int shift) {
  return (v * 0x1e35a7bdu) >> shift;
}

uint8_t* put_varint32(uint8_t* op, uint32_t v) {
  while (v >= 0x80) {
    *op++ = (uint8_t)(v | 0x80);
    v >>= 7;
  }
  *op++ = (uint8_t)v;
  return op;
}

uint8_t* emit_literal(uint8_t* op, const uint8_t* lit, size_t len) {
  size_t n = len - 1;
  if (n < 60) {
    *op++ = (uint8_t)(n << 2);
  } else {
    int bytes = n < (1u << 8) ? 1 : n < (1u << 16) ? 2 : n < (1u << 24) ? 3 : 4;
    *op++ = (uint8_t)((59 + bytes) << 2);
    for (int i = 0; i < bytes; i++) *op++ = (uint8_t)(n >> (8 * i));
  }
  memcpy(op, lit, len);
  return op + len;
}

uint8_t* emit_copy_upto64(uint8_t* op, size_t offset, size_t len) {
  if (len < 12 && offset < 2048) {
    *op++ = (uint8_t)(1 | ((len - 4) << 2) | ((offset >> 8) << 5));
    *op++ = (uint8_t)offset;
  } else {
    *op++ = (uint8_t)(2 | ((len - 1) << 2));
    *op++ = (uint8_t)offset;
    *op++ = (uint8_t)(offset >> 8);
  }
  return op;
}

uint8_t* emit_copy(uint8_t* op, size_t offset, size_t len) {
  while (len >= 68) {
    op = emit_copy_upto64(op, offset, 64);
    len -= 64;
  }
  if (len > 64) {
    op = emit_copy_upto64(op, offset, 60);
    len -= 60;
  }
  return emit_copy_upto64(op, offset, len);
}

// one block of at most SNAPPY_BLOCK bytes; matches stay inside it. The
// table has about as many slots as the block has bytes (256 to 16,384),
// so a short segment clears little of it
uint8_t* compress_block(const uint8_t* in, size_t n, uint8_t* op,
                        uint16_t* table) {
  const uint8_t* lit = in;   // start of the pending literal
  if (n >= 15) {
    int bits = 8;
    while (bits < SNAPPY_HASH_BITS && ((size_t)1 << bits) < n) bits++;
    const int shift = 32 - bits;
    memset(table, 0, sizeof(uint16_t) << bits);
    const uint8_t* ip = in + 1;
    const uint8_t* limit = in + n - 4;   // a 4-byte load stays inside
    uint32_t misses = 32;
    while (ip < limit) {
      uint32_t cur = load32(ip);
      uint32_t h = snappy_hash(cur, shift);
      const uint8_t* cand = in + table[h];
      table[h] = (uint16_t)(ip - in);
      if (cand >= ip || load32(cand) != cur) {
        ip += misses++ >> 5;   // skip faster through incompressible bytes
        continue;
      }
      misses = 32;
      if (ip > lit) op = emit_literal(op, lit, (size_t)(ip - lit));
      size_t len = 4;
      const uint8_t* end = in + n;
      while (ip + len < end && cand[len] == ip[len]) len++;
      op = emit_copy(op, (size_t)(ip - cand), len);
      ip += len;
      lit = ip;
      if (ip < limit) table[snappy_hash(load32(ip - 1), shift)] =
          (uint16_t)(ip - 1 - in);
    }
  }
  if (lit < in + n) op = emit_literal(op, lit, (size_t)(in + n - lit));
  return op;
}

}  // namespace

extern "C" {

// bit 0: zstd, bit 1: lz4, bit 2: snappy (always); the libraries are
// resolved here if they were not yet
int tt_codecs() {
  return (zstd_lib() ? 1 : 0) | (lz4_lib() ? 2 : 0) | 4;
}

long long tt_zstd_compress(const char* src, size_t src_len,
                           char* dst, size_t dst_cap, int level) {
  const Zstd* z = zstd_lib();
  if (!z) return ERR_NO_CODEC;
  size_t n = z->compress(dst, dst_cap, src, src_len, level);
  if (z->is_error(n)) return ERR_FAILED;
  return (long long)n;
}

long long tt_zstd_content_size(const char* src, size_t src_len) {
  // the exact decompressed size from the frame header, so the caller can
  // allocate once; -2: the frame declares no size (a streamed writer);
  // -1: not a zstd frame
  const Zstd* z = zstd_lib();
  if (!z) return ERR_NO_CODEC;
  unsigned long long c = z->content_size(src, src_len);
  if (c == ZSTD_CONTENTSIZE_ERROR) return ERR_FAILED;
  if (c == ZSTD_CONTENTSIZE_UNKNOWN) return ERR_GROW;
  return (long long)c;
}

long long tt_zstd_decompress(const char* src, size_t src_len,
                             char* dst, size_t dst_cap) {
  const Zstd* z = zstd_lib();
  if (!z) return ERR_NO_CODEC;
  unsigned long long content = z->content_size(src, src_len);
  if (content != ZSTD_CONTENTSIZE_UNKNOWN &&
      content != ZSTD_CONTENTSIZE_ERROR && content > dst_cap)
    return ERR_GROW;
  size_t n = z->decompress(dst, dst_cap, src, src_len);
  if (z->is_error(n))
    // a frame without its content size surfaces a small dst here
    return z->error_code(n) == ZSTD_error_dstSize_tooSmall ? ERR_GROW
                                                           : ERR_FAILED;
  return (long long)n;
}

long long tt_lz4_compress(const char* src, size_t src_len,
                          char* dst, size_t dst_cap) {
  const Lz4* l = lz4_lib();
  if (!l) return ERR_NO_CODEC;
  if (src_len > 0x7E000000 || dst_cap > 0x7FFFFFFF) return ERR_FAILED;
  int n = l->compress(src, dst, (int)src_len, (int)dst_cap);
  if (n <= 0) return ERR_FAILED;
  return (long long)n;
}

long long tt_lz4_decompress(const char* src, size_t src_len,
                            char* dst, size_t dst_cap) {
  const Lz4* l = lz4_lib();
  if (!l) return ERR_NO_CODEC;
  if (src_len > 0x7FFFFFFF || dst_cap > 0x7FFFFFFF) return ERR_FAILED;
  int n = l->decompress(src, dst, (int)src_len, (int)dst_cap);
  if (n < 0) return ERR_FAILED;
  return (long long)n;
}

long long tt_snappy_compress(const char* src, size_t src_len,
                             char* dst, size_t dst_cap) {
  // the most this encoder writes: 32 + n + n / 6 bytes
  if (src_len > 0xFFFFFFFFu || dst_cap < 32 + src_len + src_len / 6)
    return ERR_FAILED;
  const uint8_t* in = (const uint8_t*)src;
  uint8_t* op = put_varint32((uint8_t*)dst, (uint32_t)src_len);
  uint16_t table[1 << SNAPPY_HASH_BITS];
  for (size_t off = 0; off < src_len; off += SNAPPY_BLOCK) {
    size_t n = src_len - off < SNAPPY_BLOCK ? src_len - off : SNAPPY_BLOCK;
    op = compress_block(in + off, n, op, table);
  }
  return (long long)(op - (uint8_t*)dst);
}

long long tt_snappy_decompress(const char* src, size_t src_len,
                               char* dst, size_t dst_cap) {
  const uint8_t* ip = (const uint8_t*)src;
  const uint8_t* end = ip + src_len;
  uint64_t want = 0;
  for (int shift = 0;; shift += 7) {
    if (ip >= end || shift > 28) return ERR_FAILED;
    uint8_t b = *ip++;
    want |= (uint64_t)(b & 0x7f) << shift;
    if (!(b & 0x80)) break;
  }
  if (want > 0xFFFFFFFFu || want > dst_cap) return ERR_FAILED;
  uint8_t* out = (uint8_t*)dst;
  size_t op = 0;
  while (ip < end) {
    uint8_t tag = *ip++;
    size_t len, offset;
    switch (tag & 3) {
      case 0: {  // literal
        len = (tag >> 2) + 1;
        if (len > 60) {
          size_t bytes = len - 60;
          if ((size_t)(end - ip) < bytes) return ERR_FAILED;
          len = 0;
          for (size_t i = 0; i < bytes; i++) len |= (size_t)ip[i] << (8 * i);
          len += 1;
          ip += bytes;
        }
        if ((size_t)(end - ip) < len || want - op < len) return ERR_FAILED;
        memcpy(out + op, ip, len);
        ip += len;
        op += len;
        continue;
      }
      case 1:
        if (end - ip < 1) return ERR_FAILED;
        len = ((tag >> 2) & 7) + 4;
        offset = ((size_t)(tag >> 5) << 8) | ip[0];
        ip += 1;
        break;
      case 2:
        if (end - ip < 2) return ERR_FAILED;
        len = (tag >> 2) + 1;
        offset = (size_t)ip[0] | ((size_t)ip[1] << 8);
        ip += 2;
        break;
      default:
        if (end - ip < 4) return ERR_FAILED;
        len = (tag >> 2) + 1;
        offset = (size_t)load32(ip);
        ip += 4;
        break;
    }
    if (offset == 0 || offset > op || want - op < len) return ERR_FAILED;
    const uint8_t* from = out + op - offset;
    if (offset >= len) {
      memcpy(out + op, from, len);
    } else {
      for (size_t i = 0; i < len; i++) out[op + i] = from[i];  // overlaps
    }
    op += len;
  }
  if (op != want) return ERR_FAILED;
  return (long long)op;
}

// Dictionary substring scan: the ids of the strings of a packed
// dictionary that contain `needle` (bytes.Contains semantics). Packed
// layout: the concatenated utf-8 bytes and an (n+1)-entry offset table.
// The search's host route for large dictionaries (search/pipeline.py
// substring_value_ids), where a numpy scan is slow.
long long tt_substr_scan(const char* buf, const long long* offsets,
                         long long n_strs, const char* needle,
                         long long needle_len, int* out_ids,
                         long long out_cap) {
  long long found = 0;
  if (needle_len == 0) {
    if (n_strs > out_cap) return -2;  // grow, never truncate silently
    for (long long i = 0; i < n_strs; i++)
      out_ids[found++] = (int)i;
    return found;
  }
  // ONE memmem pass over the whole packed buffer instead of one call
  // per string: at 10M short values the per-call overhead dominates
  // (~500ms vs ~100ms measured). Strings are concatenated WITHOUT
  // separators, so a raw hit can straddle a boundary — validate that
  // the match lies inside a single string before accepting, else resume
  // one byte past the false hit.
  const char* end = buf + offsets[n_strs];
  const char* p = buf;
  long long cur = 0;       // monotone string cursor (offsets ascend)
  while (p < end) {
    const char* hit =
        (const char*)memmem(p, (size_t)(end - p), needle, (size_t)needle_len);
    if (hit == nullptr) break;
    long long pos = hit - buf;
    while (offsets[cur + 1] <= pos) cur++;
    if (pos + needle_len <= offsets[cur + 1]) {
      if (found >= out_cap) return -2;  // caller must grow out buffer
      out_ids[found++] = (int)cur;
      p = buf + offsets[cur + 1];  // further hits in this string are dupes
      cur++;
    } else {
      p = hit + 1;  // boundary-straddling false hit
    }
  }
  return found;
}

// XXH64, self-contained (utils/xxh64.py's plain version is the same
// algorithm in Python).
static const uint64_t P1 = 11400714785074694791ULL;
static const uint64_t P2 = 14029467366897019727ULL;
static const uint64_t P3 = 1609587929392839161ULL;
static const uint64_t P4 = 9650029242287828579ULL;
static const uint64_t P5 = 2870177450012600261ULL;

static inline uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}
static inline uint64_t read64(const char* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
static inline uint32_t read32(const char* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
static inline uint64_t round1(uint64_t acc, uint64_t input) {
  acc += input * P2;
  acc = rotl64(acc, 31);
  acc *= P1;
  return acc;
}
static inline uint64_t merge_round(uint64_t acc, uint64_t val) {
  val = round1(0, val);
  acc ^= val;
  acc = acc * P1 + P4;
  return acc;
}

unsigned long long tt_xxhash64(const char* data, size_t len,
                               unsigned long long seed) {
  const char* p = data;
  const char* end = data + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const char* limit = end - 32;
    do {
      v1 = round1(v1, read64(p)); p += 8;
      v2 = round1(v2, read64(p)); p += 8;
      v3 = round1(v3, read64(p)); p += 8;
      v4 = round1(v4, read64(p)); p += 8;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = merge_round(h, v1);
    h = merge_round(h, v2);
    h = merge_round(h, v3);
    h = merge_round(h, v4);
  } else {
    h = seed + P5;
  }
  h += (uint64_t)len;
  while (p + 8 <= end) {
    h ^= round1(0, read64(p));
    h = rotl64(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)read32(p) * P1;
    h = rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (uint64_t)(uint8_t)(*p) * P5;
    h = rotl64(h, 11) * P1;
    p++;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// CRC32C (Castagnoli), slice-by-8: the Kafka RecordBatch v2 checksum.
static uint32_t crc32c_tbl[8][256];

// built at library load (single-threaded) — ctypes callers drop the GIL,
// so lazy init here would be a data race
static bool crc32c_tables_built = [] {
  for (uint32_t n = 0; n < 256; n++) {
    uint32_t c = n;
    for (int k = 0; k < 8; k++) c = c & 1 ? 0x82f63b78u ^ (c >> 1) : c >> 1;
    crc32c_tbl[0][n] = c;
  }
  for (uint32_t n = 0; n < 256; n++) {
    uint32_t c = crc32c_tbl[0][n];
    for (int s = 1; s < 8; s++) {
      c = crc32c_tbl[0][c & 0xff] ^ (c >> 8);
      crc32c_tbl[s][n] = c;
    }
  }
  return true;
}();

unsigned int tt_crc32c(const char* data, size_t len, unsigned int crc) {
  (void)crc32c_tables_built;
  const unsigned char* p = (const unsigned char*)data;
  uint32_t c = crc ^ 0xffffffffu;
  while (len && ((uintptr_t)p & 7)) {
    c = crc32c_tbl[0][(c ^ *p++) & 0xff] ^ (c >> 8);
    len--;
  }
  while (len >= 8) {
    uint64_t x;
    memcpy(&x, p, 8);
    x ^= c;
    c = crc32c_tbl[7][x & 0xff] ^ crc32c_tbl[6][(x >> 8) & 0xff] ^
        crc32c_tbl[5][(x >> 16) & 0xff] ^ crc32c_tbl[4][(x >> 24) & 0xff] ^
        crc32c_tbl[3][(x >> 32) & 0xff] ^ crc32c_tbl[2][(x >> 40) & 0xff] ^
        crc32c_tbl[1][(x >> 48) & 0xff] ^ crc32c_tbl[0][(x >> 56) & 0xff];
    p += 8;
    len -= 8;
  }
  while (len--) c = crc32c_tbl[0][(c ^ *p++) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// OTLP ingest walker: regroup by trace, search-data extraction and the time
// range in one pass over SERIALIZED ResourceSpans (the Python walk is
// modules/distributor.py regroup_extract; the items are byte for byte its).
//
// Input:  concatenated [u32le len][ResourceSpans bytes] records.
// Output: u32 n_traces, u32 n_spans, then per trace:
//           16B padded trace id, u32 start_s, u32 end_s,
//           u32 seg_len  + seg   (8B v2 header + Trace proto bytes),
//           u32 sd_len   + sd    (search/data.py's wire format),
//         then the span summaries (a string table and 56-byte rows).
// Returns bytes written; -2 malformed proto; -3 output too small (caller
// grows and retries); -4 invalid trace id (the caller runs the Python
// walk, so the user sees its error).

#include <algorithm>
#include <array>
#include <charconv>
#include <cstdio>
#include <map>
#include <set>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Range { size_t off, len; };  // into the input buffer

static bool rd_varint(const uint8_t* p, size_t n, size_t& off, uint64_t& v) {
  v = 0;
  int shift = 0;
  while (off < n && shift < 64) {
    uint8_t b = p[off++];
    v |= (uint64_t)(b & 0x7f) << shift;
    if (!(b & 0x80)) return true;
    shift += 7;
  }
  return false;
}

// skip one field's value given its wire type; LEN returns the payload range
static bool rd_skip(const uint8_t* p, size_t n, size_t& off, uint32_t wt,
                    Range* payload) {
  uint64_t v;
  switch (wt) {
    case 0: return rd_varint(p, n, off, v);
    case 1: if (off + 8 > n) return false; off += 8; return true;
    case 5: if (off + 4 > n) return false; off += 4; return true;
    case 2: {
      // v can be a full 64-bit value from a hostile 10-byte varint:
      // compare against the REMAINING bytes so `off + v` cannot wrap
      if (!rd_varint(p, n, off, v) || v > n - off) return false;
      if (payload) *payload = {off, (size_t)v};
      off += v;
      return true;
    }
    default: return false;
  }
}

// python repr() of a double, byte-for-byte: shortest round-trip digits
// (std::to_chars scientific), re-formatted by CPython's rule — FIXED
// notation when the decimal exponent is in [-4, 16), scientific with a
// 2-digit signed exponent otherwise. to_chars alone picks scientific
// whenever strictly shorter (2e5 → "2e+05" where Python says
// "200000.0"), which would break search-data parity.
static std::string py_double_repr(double d) {
  if (d != d) return "nan";
  if (d == __builtin_inf()) return "inf";
  if (d == -__builtin_inf()) return "-inf";
  char buf[64];
  auto res = std::to_chars(buf, buf + sizeof(buf), d,
                           std::chars_format::scientific);
  std::string s(buf, res.ptr);  // [-]D[.DDDD]e±EE — shortest digits
  bool neg = s[0] == '-';
  size_t i = neg ? 1 : 0;
  size_t epos = s.find('e', i);
  std::string digits;
  for (size_t j = i; j < epos; j++)
    if (s[j] != '.') digits += s[j];
  int exp = atoi(s.c_str() + epos + 1);
  std::string out = neg ? "-" : "";
  if (exp >= -4 && exp < 16) {
    if (exp >= (int)digits.size() - 1) {        // integral: pad + ".0"
      out += digits;
      out.append(exp - (digits.size() - 1), '0');
      out += ".0";
    } else if (exp >= 0) {                      // point inside digits
      out += digits.substr(0, exp + 1) + "." + digits.substr(exp + 1);
    } else {                                    // leading zeros
      out += "0.";
      out.append(-exp - 1, '0');
      out += digits;
    }
  } else {                                      // python scientific
    out += digits.substr(0, 1);
    if (digits.size() > 1) out += "." + digits.substr(1);
    char e[8];
    snprintf(e, sizeof(e), "e%+03d", exp);
    out += e;
  }
  return out;
}

// AnyValue → string per data.py _any_value_str (empty = unindexed type)
static bool anyvalue_str(const uint8_t* p, Range r, std::string& out) {
  size_t off = r.off, end = r.off + r.len;
  out.clear();
  // last occurrence wins (proto3 oneof semantics on the wire)
  while (off < end) {
    uint64_t tag;
    if (!rd_varint(p, end, off, tag)) return false;
    uint32_t f = (uint32_t)(tag >> 3), wt = (uint32_t)(tag & 7);
    Range pay{0, 0};
    size_t before = off;
    if (f == 1 && wt == 2) {           // string_value
      if (!rd_skip(p, end, off, wt, &pay)) return false;
      out.assign((const char*)p + pay.off, pay.len);
    } else if (f == 2 && wt == 0) {    // bool_value
      uint64_t v; if (!rd_varint(p, end, off, v)) return false;
      out = v ? "true" : "false";
    } else if (f == 3 && wt == 0) {    // int_value (zigzag? no — int64)
      uint64_t v; if (!rd_varint(p, end, off, v)) return false;
      char b[24];
      auto res = std::to_chars(b, b + sizeof(b), (long long)v);
      out.assign(b, res.ptr);
    } else if (f == 4 && wt == 1) {    // double_value
      if (off + 8 > end) return false;
      double d; memcpy(&d, p + off, 8); off += 8;
      out = py_double_repr(d);
    } else {
      if (!rd_skip(p, end, off, wt, nullptr)) return false;
      out.clear();                     // array/kvlist/bytes → unindexed
    }
    (void)before;
  }
  return true;
}

// AnyValue → its string_value field ONLY (python `kv.value.string_value`
// semantics — collect_span_rows derives the per-span service name this
// way, so an int-typed service.name yields "" here while the trace-level
// rollup stringifies it). Last occurrence wins; only a RECOGNIZED later
// oneof arm (fields 2-7 at their declared wire types) clears a set
// string_value — protobuf parsers treat unknown fields and wire-type
// mismatches as unknown, which never clear a oneof, and the Python
// fallback path must read the same value.
static bool anyvalue_string_only(const uint8_t* p, Range r,
                                 std::string& out) {
  size_t off = r.off, end = r.off + r.len;
  out.clear();
  while (off < end) {
    uint64_t tag;
    if (!rd_varint(p, end, off, tag)) return false;
    uint32_t f = (uint32_t)(tag >> 3), wt = (uint32_t)(tag & 7);
    Range pay{0, 0};
    if (!rd_skip(p, end, off, wt, &pay)) return false;
    if (f == 1 && wt == 2)
      out.assign((const char*)p + pay.off, pay.len);
    else if ((f == 2 && wt == 0) ||   // bool_value
             (f == 3 && wt == 0) ||   // int_value
             (f == 4 && wt == 1) ||   // double_value
             (f >= 5 && f <= 7 && wt == 2))  // array/kvlist/bytes
      out.clear();
  }
  return true;
}

// utf-8 character count (python len(str)) — budget accounting must match
static size_t u8len(const std::string& s) {
  size_t n = 0;
  for (unsigned char c : s) n += (c & 0xC0) != 0x80;
  return n;
}

static size_t varint_size(uint64_t v) {
  size_t n = 1;
  while (v >= 0x80) { v >>= 7; n++; }
  return n;
}

// per-span summary row for the metrics-generator feed (56B fixed records
// + a string table), so the generator need not walk the protos again
struct RowTmp {
  uint32_t trace_idx, svc_idx, name_idx, kind, status, flags;
  uint64_t start_ns, end_ns;
  uint8_t span_id[8], parent_id[8];
};

// per-span summary captured for the search-data SPAN SECTION (the
// structural engine's ingest substrate, data.py collect_span_rows) —
// only populated when the caller asked for span rows (flags bit 0), so
// the legacy path allocates nothing extra
struct SpanSum {
  uint64_t start_ns = 0, end_ns = 0;
  uint32_t kind = 0, status = 0;
  std::string name;
  std::string span_id, parent_id;  // RAW bytes (python keys idx_of raw)
  std::vector<std::pair<std::string, std::string>> attrs;
};

// A regrouped ScopeSpans keeps its scope (field 1), its spans (2) and
// its schema_url (3), written in that order, and drops any other field:
// what protobuf writes for the Python walk's copy. An absent scope is
// written empty (`0a 00`), as the Python walk's CopyFrom marks it set.
struct ScopeOut {
  std::vector<Range> scope;        // field 1 occurrences, verbatim
  Range schema{0, 0};              // field 3, verbatim (len 0: none)
  std::vector<Range> spans;        // span payloads (field 2 LEN values)
  std::vector<SpanSum> sums;       // parallel to `spans` (span section)
  size_t body_size = 0;            // computed at emit
};

// A regrouped ResourceSpans likewise: resource (1), scope_spans (2),
// schema_url (3), nothing else.
struct BatchOut {
  std::vector<Range> resource;     // field 1 occurrences, verbatim
  Range schema{0, 0};              // field 3, verbatim (len 0: none)
  std::vector<ScopeOut> scopes;
  // resource service.name with STRING_VALUE-only semantics (python
  // collect_span_rows reads kv.value.string_value, not the any-value
  // stringification the trace-level rollup uses) — last key wins
  std::string svc_str;
  size_t body_size = 0;
};

struct TraceOut {
  std::array<uint8_t, 16> tid{};
  std::vector<BatchOut> batches;
  std::map<std::string, std::set<std::string>> kvs;
  long long budget = 0;
  uint64_t min_start = ~0ull, max_end = 0;
  bool have_root = false;
  uint64_t root_start = 0, first_start = 0;
  std::string root_svc, root_name, first_svc, first_name;
  bool have_first = false;
};

static void kv_add(TraceOut& t, const std::string& k, const std::string& v) {
  if (v.empty()) return;
  long long cost = (long long)(u8len(k) + u8len(v));
  if (t.budget < cost) return;
  auto& s = t.kvs[k];
  if (s.insert(v).second) t.budget -= cost;
  else if (s.size() == 0) t.kvs.erase(k);  // unreachable; keep -Wall quiet
}

// bytes of a message field's occurrences; none is written as an empty
// message (`0a 00`, 2 bytes), since the Python walk's CopyFrom marks it set
static size_t fields_size(const std::vector<Range>& rs) {
  if (rs.empty()) return 2;
  size_t n = 0;
  for (auto& r : rs) n += r.len;
  return n;
}

static void emit_fields(std::string& out, const uint8_t* p,
                        const std::vector<Range>& rs) {
  if (rs.empty()) {
    out.append("\x0a\x00", 2);
    return;
  }
  for (auto& r : rs) out.append((const char*)p + r.off, r.len);
}

static void put_u32(std::string& out, uint32_t v) {
  char b[4];
  memcpy(b, &v, 4);
  out.append(b, 4);
}

static void put_u16s(std::string& out, const std::string& s) {
  size_t n = std::min(s.size(), (size_t)0xFFFF);
  uint16_t len = (uint16_t)n;
  char b[2];
  memcpy(b, &len, 2);
  out.append(b, 2);
  out.append(s.data(), n);
}

}  // namespace

// full regroup implementation; `flags` bit 0 asks for the search-data
// SPAN SECTION (data.py optional trailing section) capped at
// `max_spans` rows / `max_span_kvs` kv pairs per span — byte-identical
// to the Python walk (collect_span_rows + encode_search_data)
static long long ingest_regroup_impl(const char* src_c, size_t src_len,
                                     long long max_search_bytes,
                                     long long flags, long long max_spans,
                                     long long max_span_kvs,
                                     char* dst, size_t dst_cap) {
  const bool want_spans = (flags & 1) != 0;
  const uint8_t* p = (const uint8_t*)src_c;
  std::vector<TraceOut> traces;
  std::unordered_map<std::string, int> tid_idx;  // padded tid → index
  uint64_t n_spans = 0;
  std::vector<RowTmp> rows;                      // generator summaries
  std::vector<std::string> strtab;
  std::unordered_map<std::string, uint32_t> str_idx;
  auto intern = [&](const std::string& s) -> uint32_t {
    auto it = str_idx.find(s);
    if (it != str_idx.end()) return it->second;
    uint32_t i = (uint32_t)strtab.size();
    strtab.push_back(s);
    str_idx.emplace(s, i);
    return i;
  };

  size_t off = 0;
  while (off < src_len) {
    if (off + 4 > src_len) return -2;
    uint32_t blen;
    memcpy(&blen, p + off, 4);
    off += 4;
    if (off + blen > src_len) return -2;
    size_t bend = off + blen;

    // ---- one ResourceSpans ----
    std::vector<Range> rs_resource;
    Range rs_schema{0, 0};
    std::string svc;                       // resource service.name
    std::string svc_sv;                    // ...string_value-only form
    std::vector<std::pair<std::string, std::string>> res_kvs;
    std::vector<Range> scope_payloads;
    {
      size_t o = off;
      while (o < bend) {
        size_t field_start = o;
        uint64_t tag;
        if (!rd_varint(p, bend, o, tag)) return -2;
        uint32_t f = (uint32_t)(tag >> 3), wt = (uint32_t)(tag & 7);
        Range pay{0, 0};
        if (!rd_skip(p, bend, o, wt, &pay)) return -2;
        if (f == 2 && wt == 2) {           // scope_spans
          scope_payloads.push_back(pay);
        } else if (f == 3 && wt == 2) {    // schema_url: the last one wins
          rs_schema = pay.len ? Range{field_start, o - field_start}
                              : Range{0, 0};
        } else if (f == 1 && wt == 2) {    // resource
          rs_resource.push_back({field_start, o - field_start});
          {                                // its attributes
            size_t ro = pay.off, rend = pay.off + pay.len;
            while (ro < rend) {
              uint64_t rtag;
              if (!rd_varint(p, rend, ro, rtag)) return -2;
              Range rpay{0, 0};
              if (!rd_skip(p, rend, ro, (uint32_t)(rtag & 7), &rpay)) return -2;
              if ((rtag >> 3) == 1 && (rtag & 7) == 2) {  // KeyValue
                size_t ko = rpay.off, kend = rpay.off + rpay.len;
                std::string key, val;
                Range val_r{0, 0};
                while (ko < kend) {
                  uint64_t ktag;
                  if (!rd_varint(p, kend, ko, ktag)) return -2;
                  Range kpay{0, 0};
                  if (!rd_skip(p, kend, ko, (uint32_t)(ktag & 7), &kpay))
                    return -2;
                  if ((ktag >> 3) == 1 && (ktag & 7) == 2)
                    key.assign((const char*)p + kpay.off, kpay.len);
                  else if ((ktag >> 3) == 2 && (ktag & 7) == 2) {
                    if (!anyvalue_str(p, kpay, val)) return -2;
                    val_r = kpay;
                  }
                }
                res_kvs.emplace_back(key, val);
                if (key == "service.name") {
                  svc = val;  // last wins (py parity)
                  // span rows read string_value ONLY (py parity:
                  // collect_span_rows vs extract_search_data)
                  if (!anyvalue_string_only(p, val_r, svc_sv)) return -2;
                }
              }
            }
          }
        }
      }
    }

    // per-batch dest map: tid index → BatchOut index (id()-keyed regroup)
    std::unordered_map<int, int> batch_dest;

    for (const Range& sp : scope_payloads) {
      // ---- one ScopeSpans ----
      std::vector<Range> sc_scope;
      Range sc_schema{0, 0};
      std::vector<Range> span_payloads;
      size_t o = sp.off, send = sp.off + sp.len;
      while (o < send) {
        size_t field_start = o;
        uint64_t tag;
        if (!rd_varint(p, send, o, tag)) return -2;
        uint32_t f = (uint32_t)(tag >> 3), wt = (uint32_t)(tag & 7);
        Range pay{0, 0};
        if (!rd_skip(p, send, o, wt, &pay)) return -2;
        if (f == 2 && wt == 2) span_payloads.push_back(pay);
        else if (f == 1 && wt == 2)
          sc_scope.push_back({field_start, o - field_start});
        else if (f == 3 && wt == 2)
          sc_schema = pay.len ? Range{field_start, o - field_start}
                              : Range{0, 0};
      }

      // tid idx → (batch idx, scope idx), as a pair: a packed int would
      // overflow past a few thousand scopes
      std::unordered_map<int, std::pair<int, int>> scope_dest;

      for (const Range& spn : span_payloads) {
        // ---- one Span ----
        size_t so = spn.off, ssend = spn.off + spn.len;
        Range tid_r{0, 0}, name_r{0, 0};
        Range span_id_r{0, 0}, parent_r{0, 0};
        bool have_parent = false;
        uint64_t start_ns = 0, end_ns = 0, kind = 0;
        uint32_t status_code = 0;
        std::vector<std::pair<std::string, std::string>> span_kvs;
        while (so < ssend) {
          uint64_t tag;
          if (!rd_varint(p, ssend, so, tag)) return -2;
          uint32_t f = (uint32_t)(tag >> 3), wt = (uint32_t)(tag & 7);
          Range pay{0, 0};
          if (f == 7 && wt == 1) {
            if (so + 8 > ssend) return -2;
            memcpy(&start_ns, p + so, 8); so += 8;
            continue;
          }
          if (f == 8 && wt == 1) {
            if (so + 8 > ssend) return -2;
            memcpy(&end_ns, p + so, 8); so += 8;
            continue;
          }
          if (f == 6 && wt == 0) {                 // kind
            if (!rd_varint(p, ssend, so, kind)) return -2;
            continue;
          }
          if (!rd_skip(p, ssend, so, wt, &pay)) return -2;
          if (f == 1 && wt == 2) tid_r = pay;
          else if (f == 2 && wt == 2) span_id_r = pay;
          else if (f == 4 && wt == 2 && pay.len > 0) {
            have_parent = true;
            parent_r = pay;
          }
          else if (f == 5 && wt == 2) name_r = pay;
          else if (f == 9 && wt == 2) {            // attributes KeyValue
            size_t ko = pay.off, kend = pay.off + pay.len;
            std::string key, val;
            while (ko < kend) {
              uint64_t ktag;
              if (!rd_varint(p, kend, ko, ktag)) return -2;
              Range kpay{0, 0};
              if (!rd_skip(p, kend, ko, (uint32_t)(ktag & 7), &kpay))
                return -2;
              if ((ktag >> 3) == 1 && (ktag & 7) == 2)
                key.assign((const char*)p + kpay.off, kpay.len);
              else if ((ktag >> 3) == 2 && (ktag & 7) == 2) {
                if (!anyvalue_str(p, kpay, val)) return -2;
              }
            }
            span_kvs.emplace_back(key, val);
          } else if (f == 15 && wt == 2) {         // status → code
            size_t to = pay.off, tend = pay.off + pay.len;
            while (to < tend) {
              uint64_t ttag;
              if (!rd_varint(p, tend, to, ttag)) return -2;
              if ((ttag >> 3) == 3 && (ttag & 7) == 0) {
                uint64_t v;
                if (!rd_varint(p, tend, to, v)) return -2;
                status_code = (uint32_t)v;
              } else {
                Range tpay{0, 0};
                if (!rd_skip(p, tend, to, (uint32_t)(ttag & 7), &tpay))
                  return -2;
              }
            }
          }
        }
        if (tid_r.len == 0 || tid_r.len > 16) return -4;

        std::string padded(16, '\0');
        memcpy(&padded[16 - tid_r.len], p + tid_r.off, tid_r.len);
        auto it = tid_idx.find(padded);
        int ti;
        if (it == tid_idx.end()) {
          ti = (int)traces.size();
          tid_idx.emplace(padded, ti);
          traces.emplace_back();
          memcpy(traces[ti].tid.data(), padded.data(), 16);
          traces[ti].budget = max_search_bytes;
        } else {
          ti = it->second;
        }
        n_spans++;
        // NOTE: `traces` may reallocate on emplace above — take the
        // reference AFTER any potential growth
        TraceOut& T = traces[ti];

        auto sd_it = scope_dest.find(ti);
        ScopeOut* SO;
        if (sd_it == scope_dest.end()) {
          auto bd_it = batch_dest.find(ti);
          int bi;
          if (bd_it == batch_dest.end()) {
            bi = (int)T.batches.size();
            T.batches.emplace_back();
            T.batches[bi].resource = rs_resource;
            T.batches[bi].schema = rs_schema;
            T.batches[bi].svc_str = svc_sv;
            batch_dest.emplace(ti, bi);
            for (auto& kv : res_kvs) kv_add(T, kv.first, kv.second);
          } else {
            bi = bd_it->second;
          }
          BatchOut& B = T.batches[bi];
          int si = (int)B.scopes.size();
          B.scopes.emplace_back();
          B.scopes[si].scope = sc_scope;
          B.scopes[si].schema = sc_schema;
          scope_dest.emplace(ti, std::make_pair(bi, si));
          SO = &B.scopes[si];
        } else {
          SO = &T.batches[sd_it->second.first].scopes[sd_it->second.second];
        }
        SO->spans.push_back(spn);

        if (start_ns < T.min_start) T.min_start = start_ns;
        if (end_ns > T.max_end) T.max_end = end_ns;

        std::string name((const char*)p + name_r.off, name_r.len);
        if (!name.empty()) {
          long long cost = 4 + (long long)u8len(name);
          if (T.budget >= cost) {
            auto& s = T.kvs["name"];
            if (s.insert(name).second) T.budget -= cost;
          }
        }
        if (status_code == 2 && T.budget >= 9) {   // STATUS_CODE_ERROR
          auto& s = T.kvs["error"];
          if (s.insert("true").second) T.budget -= 9;
        }
        for (auto& kv : span_kvs) kv_add(T, kv.first, kv.second);

        if (want_spans) {
          // span-section capture (parallel to SO->spans): raw ids for
          // the parent resolve, attrs MOVED (kv_add above was their
          // last reader) so capture adds only the short name/id copies
          // per span — the legacy path (flags=0) stores nothing. The
          // max_spans cap applies at emit, in REGROUPED order: parse
          // order can differ from the regrouped walk order when one
          // trace's spans interleave across scopes, so an early
          // capture cap would truncate a different row set than the
          // Python walk.
          SpanSum sum;
          sum.start_ns = start_ns;
          sum.end_ns = end_ns;
          sum.kind = (uint32_t)kind;
          sum.status = status_code;
          sum.name = name;
          sum.span_id.assign((const char*)p + span_id_r.off, span_id_r.len);
          if (have_parent)
            sum.parent_id.assign((const char*)p + parent_r.off,
                                 parent_r.len);
          sum.attrs = std::move(span_kvs);
          SO->sums.push_back(std::move(sum));
        }

        if (!have_parent) {
          if (!T.have_root || start_ns < T.root_start) {
            T.have_root = true;
            T.root_start = start_ns;
            T.root_svc = svc;
            T.root_name = name;
          }
        } else if (!T.have_first || start_ns < T.first_start) {
          T.have_first = true;
          T.first_start = start_ns;
          T.first_svc = svc;
          T.first_name = name;
        }

        RowTmp row{};
        row.trace_idx = (uint32_t)ti;
        row.svc_idx = intern(svc);
        row.name_idx = intern(name);
        row.kind = (uint32_t)kind;
        row.status = status_code;
        row.flags = have_parent ? 1u : 0u;
        row.start_ns = start_ns;
        row.end_ns = end_ns;
        if (span_id_r.len && span_id_r.len <= 8)   // right-align, zero-pad
          memcpy(row.span_id + (8 - span_id_r.len), p + span_id_r.off,
                 span_id_r.len);
        if (parent_r.len && parent_r.len <= 8)
          memcpy(row.parent_id + (8 - parent_r.len), p + parent_r.off,
                 parent_r.len);
        rows.push_back(row);
      }
    }
    off = bend;
  }

  // ---- emit ----
  std::string out;
  out.reserve(src_len + (traces.size() * 256) + 64);
  put_u32(out, (uint32_t)traces.size());
  put_u32(out, (uint32_t)n_spans);
  for (auto& T : traces) {
    uint64_t start_ns = T.max_end ? T.min_start : 0;
    uint64_t end_ns = T.max_end;
    uint32_t start_s = (uint32_t)((start_ns / 1000000000ull) & 0xFFFFFFFF);
    uint32_t end_s = (uint32_t)((end_ns / 1000000000ull) & 0xFFFFFFFF);
    // max(0, end - start): clock-skewed end < start must clamp to 0 (the
    // unsigned underflow previously saturated to 0xFFFFFFFF, diverging
    // from the Python walks, which now clamp to 0 too)
    uint64_t dur_ms =
        (end_ns > start_ns) ? (end_ns - start_ns) / 1000000ull : 0;
    if (dur_ms > 0xFFFFFFFFull) dur_ms = 0xFFFFFFFFull;

    out.append((const char*)T.tid.data(), 16);
    put_u32(out, start_s);
    put_u32(out, end_s);

    // segment: 8B header + Trace{repeated ResourceSpans batches = 1}
    size_t seg_size = 8;
    for (auto& B : T.batches) {
      size_t body = fields_size(B.resource) + B.schema.len;
      for (auto& S : B.scopes) {
        size_t sbody = fields_size(S.scope) + S.schema.len;
        for (auto& r : S.spans) sbody += 1 + varint_size(r.len) + r.len;
        S.body_size = sbody;
        body += 1 + varint_size(sbody) + sbody;
      }
      B.body_size = body;
      seg_size += 1 + varint_size(body) + body;
    }
    put_u32(out, (uint32_t)seg_size);
    char hdr[8];
    memcpy(hdr, &start_s, 4);
    memcpy(hdr + 4, &end_s, 4);
    out.append(hdr, 8);
    auto emit_varint = [&out](uint64_t v) {
      while (v >= 0x80) { out.push_back((char)(v | 0x80)); v >>= 7; }
      out.push_back((char)v);
    };
    for (auto& B : T.batches) {
      out.push_back((char)0x0A);               // Trace.batches (field 1 LEN)
      emit_varint(B.body_size);
      emit_fields(out, p, B.resource);         // ResourceSpans.resource
      for (auto& S : B.scopes) {
        out.push_back((char)0x12);             // ResourceSpans.scope_spans
        emit_varint(S.body_size);
        emit_fields(out, p, S.scope);          // ScopeSpans.scope
        for (auto& r : S.spans) {
          out.push_back((char)0x12);           // ScopeSpans.spans
          emit_varint(r.len);
          out.append((const char*)p + r.off, r.len);
        }
        out.append((const char*)p + S.schema.off, S.schema.len);
      }
      out.append((const char*)p + B.schema.off, B.schema.len);
    }

    // search data (data.py encode_search_data wire format)
    std::string sd;
    put_u32(sd, start_s);
    put_u32(sd, end_s);
    put_u32(sd, (uint32_t)dur_ms);
    const std::string& rsvc = T.have_root ? T.root_svc
                              : (T.have_first ? T.first_svc : std::string());
    const std::string& rname = T.have_root ? T.root_name
                               : (T.have_first ? T.first_name : std::string());
    put_u16s(sd, rsvc);
    put_u16s(sd, rname);
    uint16_t nk = (uint16_t)std::min(T.kvs.size(), (size_t)0xFFFF);
    sd.append((const char*)&nk, 2);
    size_t ki = 0;
    for (auto& kv : T.kvs) {                   // std::map: sorted keys
      if (ki++ >= nk) break;
      put_u16s(sd, kv.first);
      uint16_t nv = (uint16_t)std::min(kv.second.size(), (size_t)0xFFFF);
      sd.append((const char*)&nv, 2);
      size_t vi = 0;
      for (auto& v : kv.second) {              // std::set: sorted values
        if (vi++ >= nv) break;
        put_u16s(sd, v);
      }
    }

    if (want_spans) {
      // ---- optional trailing SPAN SECTION (data.py collect_span_rows
      // + encode_search_data parity): rows in REGROUPED walk order
      // (batches → scopes → spans — the exact order the Python walk
      // sees on the regrouped trace), parents resolved by raw span id
      // within this trace's captured rows (first id occurrence wins,
      // never self), caps applied like the Python walk. A trace with
      // zero captured rows emits NO section — byte-identical to the
      // legacy wire form.
      struct SpanRow {
        int parent = -1;
        uint32_t dur_ms = 0, kind = 0;
        std::map<std::string, std::set<std::string>> kvs;
      };
      std::vector<SpanRow> srows;
      std::unordered_map<std::string, int> idx_of;  // raw span id → row
      std::vector<std::string> parent_ids;
      for (auto& B : T.batches) {
        const std::string& ssvc = B.svc_str;
        for (auto& S : B.scopes) {
          for (auto& sum : S.sums) {
            if ((long long)srows.size() >= max_spans) break;
            SpanRow r;
            uint64_t d = (sum.end_ns > sum.start_ns)
                             ? (sum.end_ns - sum.start_ns) / 1000000ull
                             : 0;
            if (d > 0xFFFFFFFFull) d = 0xFFFFFFFFull;
            r.dur_ms = sum.end_ns ? (uint32_t)d : 0;
            r.kind = sum.kind;
            long long n_kv = 0;
            if (!ssvc.empty()) {
              r.kvs["service.name"].insert(ssvc);
              n_kv++;
            }
            if (!sum.name.empty() && n_kv < max_span_kvs) {
              r.kvs["name"].insert(sum.name);
              n_kv++;
            }
            if (sum.status == 2 && n_kv < max_span_kvs) {
              r.kvs["error"].insert("true");
              n_kv++;
            }
            for (auto& kv : sum.attrs) {
              if (n_kv >= max_span_kvs) break;
              if (kv.second.empty()) continue;  // unindexed value type
              r.kvs[kv.first].insert(kv.second);
              n_kv++;  // counts per attribute, dupes included (py parity)
            }
            if (!sum.span_id.empty())
              idx_of.emplace(sum.span_id, (int)srows.size());
            parent_ids.push_back(sum.parent_id);
            srows.push_back(std::move(r));
          }
        }
      }
      for (size_t i = 0; i < srows.size(); i++) {
        const std::string& pid = parent_ids[i];
        if (pid.empty()) continue;
        auto it = idx_of.find(pid);
        if (it != idx_of.end() && it->second != (int)i)
          srows[i].parent = it->second;  // self-parent stays -1
      }
      if (!srows.empty()) {
        uint16_t ns = (uint16_t)std::min(srows.size(), (size_t)0xFFFF);
        sd.append((const char*)&ns, 2);
        size_t ri = 0;
        for (auto& r : srows) {
          if (ri++ >= ns) break;
          uint16_t par = (r.parent >= 0 && r.parent < 0xFFFF)
                             ? (uint16_t)r.parent
                             : 0xFFFF;
          sd.append((const char*)&par, 2);
          put_u32(sd, r.dur_ms);
          sd.push_back((char)(r.kind & 0xFF));
          uint16_t nsk = (uint16_t)std::min(r.kvs.size(), (size_t)0xFFFF);
          sd.append((const char*)&nsk, 2);
          size_t ski = 0;
          for (auto& kv : r.kvs) {             // std::map: sorted keys
            if (ski++ >= nsk) break;
            put_u16s(sd, kv.first);
            uint16_t nsv =
                (uint16_t)std::min(kv.second.size(), (size_t)0xFFFF);
            sd.append((const char*)&nsv, 2);
            size_t svi = 0;
            for (auto& v : kv.second) {        // std::set: sorted values
              if (svi++ >= nsv) break;
              put_u16s(sd, v);
            }
          }
        }
      }
    }

    put_u32(out, (uint32_t)sd.size());
    out += sd;
  }

  // ---- span summaries (generator feed): string table + 56B rows ----
  put_u32(out, (uint32_t)strtab.size());
  for (auto& s : strtab) put_u16s(out, s);
  put_u32(out, (uint32_t)rows.size());
  static_assert(sizeof(RowTmp) == 56, "summary row layout is the ABI");
  for (auto& r : rows) out.append((const char*)&r, sizeof(RowTmp));

  if (out.size() > dst_cap) return -3;
  memcpy(dst, out.data(), out.size());
  return (long long)out.size();
}

extern "C" {

long long tt_ingest_regroup2(const char* src_c, size_t src_len,
                             long long max_search_bytes, long long flags,
                             long long max_spans, long long max_span_kvs,
                             char* dst, size_t dst_cap) {
  return ingest_regroup_impl(src_c, src_len, max_search_bytes, flags,
                             max_spans, max_span_kvs, dst, dst_cap);
}

}  // extern "C"
