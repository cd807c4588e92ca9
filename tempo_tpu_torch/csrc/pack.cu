// K5 pack_mask_words: bool hit masks to 32-bit words.
//
// Replaces tempo_tpu/search/packing.py `_pack_mask_jit` / `pack_mask_words`
// (the mask half of TPU kernel B4):
//
//   words[r, w] = OR over i < 32 with 32w + i < V of  hits[r, 32w + i] << i
//
// for a bool mask hits [R, V] (R = the product of the leading axes), into
// uint32 words [R, ceil(V/32)]; the bits past V are 0. The scans (K1, K1s,
// K4) read a word table as (word[v >> 5] >> (v & 31)) & 1.
//
// Bound on an H100: bytes (R*V bytes read, R*ceil(V/32)*4 written, one
// ballot per 32 values); for a dictionary probe's output of one term over
// ~1M values that is ~1.2 MB, well under a microsecond of HBM time, so a
// call is launch-bound. Design: one warp per 32 consecutive values of one
// row, a thread per value (adjacent lanes on adjacent bytes, so a warp's
// read is one 32-byte sector); __ballot_sync builds the word, lane 0
// stores it. No shared memory, no atomics.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pack_kernel(const bool* __restrict__ hits, int64_t rows, int64_t V,
            int64_t W, uint32_t* __restrict__ words) {
  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows * W) return;   // whole warps leave together
  const int64_t r = warp / W;
  const int64_t v = (warp % W) * 32 + lane;
  const bool bit = v < V && hits[r * V + v];
  const unsigned word = __ballot_sync(0xffffffffu, bit);
  if (lane == 0) words[warp] = word;
}

}  // namespace

extern "C" {

// hits: bool [rows, V]; words: uint32 [rows, ceil(V/32)]. Returns the
// cudaError_t of the launch (0 = launched).
int tt_pack_mask_words(const void* hits, int64_t rows, int64_t V,
                       void* words, void* stream) {
  if (rows <= 0 || V <= 0) return 0;
  const int64_t W = (V + 31) / 32;
  const int64_t threads = rows * W * 32;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  pack_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const bool*)hits, rows, V, W, (uint32_t*)words);
  return (int)cudaGetLastError();
}

const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
