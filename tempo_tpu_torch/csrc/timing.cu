// A measurement helper of chip_smoke.py, not a port of a TPU kernel: one
// thread that holds its stream until the host has issued the work to be
// timed. It spins until a counter in pinned host memory reaches `target`
// (the host stores it after issuing that work), or until `max_cycles`
// pass, so it cannot hang the card. An event recorded after it on the
// stream then fires just before the timed work starts, however long the
// host took to issue that work (a fixed-length spin does not hold when
// another host thread keeps the interpreter past it).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void wait_host_kernel(const volatile long long* counter,
                                 long long target, long long max_cycles) {
  const long long t0 = clock64();
  while (*counter < target && clock64() - t0 < max_cycles) {
  }
}

}  // namespace

extern "C" {

// counter: pinned host memory (a device-visible pointer under unified
// addressing). Returns the cudaError_t of the launch.
int tt_wait_host(const void* counter, long long target, long long max_cycles,
                 void* stream) {
  wait_host_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const volatile long long*)counter, target, max_cycles);
  return (int)cudaGetLastError();
}

}  // extern "C"
