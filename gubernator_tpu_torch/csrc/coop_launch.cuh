// Cooperative launch of the port's one persistent-grid kernel, K1
// (`rounds_kernel` in fused_step.cu): a grid of at most as many blocks as
// fit on the device at once, so that `grid.sync()` is legal.  K3 and K4
// have no grid barrier and make plain launches.

#pragma once

#include <atomic>
#include <cuda_runtime.h>

namespace coop {

// One count of co-resident blocks per device (0: not read yet).
using ResidentCache = std::atomic<int>[64];

// Blocks of `kernel` (`threads` a block, no dynamic shared memory) that
// fit on the current device at once, read once per device into `cache`;
// cooperative launch support is checked with it.
template <class Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, ResidentCache& cache, int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  int n = cache[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return e;
    if (!coop) return cudaErrorNotSupported;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    if (e != cudaSuccess) return e;
    n = per_sm * sms;
    if (n < 1) return cudaErrorCooperativeLaunchTooLarge;
    cache[dev].store(n, std::memory_order_relaxed);
  }
  *out = n;
  return cudaSuccess;
}

// Launch `kernel` cooperatively on `stream` over min(ceil(lanes /
// threads), co-resident blocks) blocks, at least one.  Returns 0 once it
// is launched, else the cudaError (a refused launch is not retried in
// another form).
template <class Kernel>
int launch(Kernel kernel, int threads, ResidentCache& cache, int lanes, void** args,
           void* stream) {
  int resident = 0;
  cudaError_t e = resident_blocks(kernel, threads, cache, &resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  int grid = (lanes + threads - 1) / threads;
  if (grid > resident) grid = resident;
  if (grid < 1) grid = 1;
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                  dim3(threads), args, 0, static_cast<cudaStream_t>(stream));
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

}  // namespace coop
