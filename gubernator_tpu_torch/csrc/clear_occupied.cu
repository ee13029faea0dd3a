// K2: the eviction clear for Hopper (sm_90a).
//
// Replaces gubernator_tpu/ops/bucket_kernel.py:329 `_clear_occupied_impl`
// (an XLA gather + scatter of the meta column).  For each lane whose
// slot lies in [0, cap), clear meta bit 0 (occupied) and keep the other
// bits; lanes outside (the `cap + lane` padding) are dropped.  The host
// passes unique slots, so lanes never race.  The plain PyTorch version
// is gubernator_tpu_torch/ops/bucket_kernel.py `clear_occupied_reference`.
//
// One thread per lane.  Bound: 4 B of slot read and one 4 B meta word
// read and written per lane (12 B; a 16-lane clear is 192 B), so the
// launch latency is the whole cost at the widths the engine uses.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
clear_occupied_kernel(int32_t* __restrict__ meta, long long cap,
                      const int32_t* __restrict__ slots, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t s = __ldg(slots + i);
  if (s >= 0 && (long long)s < cap) meta[s] &= ~1;
}

}  // namespace

// meta: int32 [cap] on the device; slots: int32 [n], n >= 1; stream: a
// cudaStream_t.  Returns cudaGetLastError() after the launch.
extern "C" int guber_clear_occupied(void* meta, long long cap, const void* slots, int n,
                                    void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  clear_occupied_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(meta), cap, static_cast<const int32_t*>(slots), n);
  return static_cast<int>(cudaGetLastError());
}
