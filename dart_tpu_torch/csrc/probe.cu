// A measurement probe, not a port of a TPU kernel: the latency of one
// dependent global load on this card, for the seed scan's critical-path
// floor (the longest read's count of dependent table loads times this
// latency). One thread follows a chain of 32-bit indices through a buffer
// (next = buf[next]), so that each load's address is the previous load's
// value; the caller lays the chain out as a random cycle over the buffer's
// 32-byte lines and times `steps` loads with CUDA events. A buffer of 20 MB
// stays in the 50 MB L2 once warm; one of 125 MB or more does not.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void chase_kernel(const uint32_t* __restrict__ buf,
                             long long steps, uint32_t start,
                             uint32_t* __restrict__ out) {
  uint32_t j = start;
  for (long long i = 0; i < steps; ++i) j = __ldcg(buf + j);
  *out = j;  // keeps the chain live
}

}  // namespace

extern "C" int dart_probe_chase(const void* buf, long long steps,
                                unsigned start, void* out, void* stream) {
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(buf), steps, start,
      static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}
