#!/usr/bin/env python3
"""The page swap that was tried for K9 and K10 (the page spill and refill of
paged state) and not kept, built apart and timed beside them on one GPU in
one run.

    python3 scripts/torch_page_swap.py

The swap: one launch a fault batch, reading and writing the host page
store where it lies.  The store (int32 [num_pages, 12, P], 48 B a row) is
anonymous mmap memory registered pinned and mapped (`cudaHostRegister`);
frame i (device row starts[i]) goes to host block victims[i] (none where
it is -1, a page never used) and host block pages[i] comes into the frame;
a thread owns one 16-byte quad of one column of one frame, issues the host
read first (`ld.global.cv`), spills the frame's quad (`st.global.wt`),
then writes the refill.  The engine's fault path becomes: the victim picks
as `core/paging.py` makes them, one upload of the three index arrays, one
launch, and no copy of the words on the host.  The port keeps K9 and K10
(csrc/page_words.cu) around a staged copy up and a copy home.

In order, on the card:

1. the swap held bit-equal to a plain numpy swap at P = 16, 64 and 512,
   k = 1 and 64, frames at row 0 and at the last frame, used and
   never-used victims, every word random (bit 31 of the `*_lo` words set);
2. a fault batch at P = 512 and k = 1, 16 (a fill batch of path (b)) and
   596 (path (b)'s median zipf batch), every victim used: K9 / K10 as the
   port's `_fault_batch` queues them (the staged copy up, K9, the copy of
   its block home, K10, through the port's wrappers) and the swap, in
   turns (K9 / K10, swap, swap, K9 / K10), CUDA events behind a spin
   kernel, beside the PCIe bound at the card's pinned-copy rates (64 MiB
   each way);
3. at k = 16 and 596, the swap on stores made two more ways (the mmap
   advised MADV_HUGEPAGE, a pinned torch tensor), variants of its
   kernel (plain, streaming and L2 256-byte-prefetch loads, 4 quads a
   thread, spill writes after the refill read returns, one TMA bulk read
   of a page's 24 KiB block; each held to the swap's effect first), one
   direction alone, and the copy engines one way and both ways on two
   streams;
4. chip_smoke.py's path (b) (pages of 512, 2^24 resident rows, 2^25 keys,
   the fill, 48 zipf(1.2) batches of 8192), each batch answered as a
   dense card engine answers it, once through the port's engine and once
   through the same engine with its fault path replaced by the swap's, in
   turns (K9 / K10, swap, swap, K9 / K10): the fault wall a faulted page
   split into victim picks, host copies and bookkeeping, and
   launch-and-wait, decisions/s and the device's idle share; the page
   table and host store of the two paths compared word for word.

Prints one line per reading, then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import mmap
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402  (the paged path's helpers)

SWAP_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>

struct Cols { int32_t* p[12]; };

namespace {

constexpr int kCols = 12;

constexpr int kMaxThreads = 256;
constexpr int kMaxPagesInGrid = 65535;  // gridDim.z limit; pages beyond loop

__device__ __forceinline__ long long clamp_start(int32_t s, long long cap, int page) {
  long long v = s < 0 ? s + cap : s;
  if (v > cap - page) v = cap - page;
  return v < 0 ? 0 : v;
}

__global__ void __launch_bounds__(kMaxThreads)
swap_pages_kernel(Cols st, long long cap, const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ pages, const int32_t* __restrict__ victims, int k,
                  int page, int32_t* host, long long num_pages) {
  const int c = blockIdx.y;
  const int quads = page >> 2;
  for (int pg = blockIdx.z; pg < k; pg += gridDim.z) {
    const long long s = clamp_start(starts[pg], cap, page);
    const int32_t refill = pages[pg];
    const int32_t victim = victims[pg];
    if (refill < 0 || refill >= num_pages || victim < -1 || victim >= num_pages) __trap();
    int32_t* col = st.p[c] + s;
    const int32_t* src = host + ((size_t)refill * kCols + c) * page;
    int32_t* dst = victim >= 0 ? host + ((size_t)victim * kCols + c) * page : nullptr;
    const bool aligned = (s & 3) == 0;
    for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < quads; q += gridDim.x * blockDim.x) {
      // The host read first: its round trip overlaps the frame's moves.
      const int4 in = __ldcv(reinterpret_cast<const int4*>(src) + q);
      if (aligned) {
        int4* f = reinterpret_cast<int4*>(col) + q;
        if (dst != nullptr) __stwt(reinterpret_cast<int4*>(dst) + q, *f);
        *f = in;
      } else {
        int32_t* f = col + 4 * q;
        if (dst != nullptr) {
          __stwt(reinterpret_cast<int4*>(dst) + q, make_int4(f[0], f[1], f[2], f[3]));
        }
        f[0] = in.x;
        f[1] = in.y;
        f[2] = in.z;
        f[3] = in.w;
      }
    }
  }
}

}  // namespace

// cols: the 12 state columns (int32 [cap] each, BucketState order, 16-byte
// aligned); starts, pages, victims: int32 [k] on the device, k >= 1; page:
// rows a page, a multiple of 4 in [4, cap]; host: the device pointer of the
// mapped host store, int32 [num_pages, 12, page], 16-byte aligned; stream:
// a cudaStream_t.  Returns cudaGetLastError() after the launch.
extern "C" int guber_swap_pages(void* const* cols, long long cap, const void* starts,
                                const void* pages, const void* victims, int k, int page,
                                void* host, long long num_pages, void* stream) {
  Cols st;
  for (int c = 0; c < kCols; ++c) st.p[c] = static_cast<int32_t*>(cols[c]);
  const int quads = page >> 2;
  int threads = quads < kMaxThreads ? quads : kMaxThreads;
  threads = (threads + 31) / 32 * 32;
  const dim3 grid((quads + threads - 1) / threads, kCols,
                  k < kMaxPagesInGrid ? k : kMaxPagesInGrid);
  swap_pages_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      st, cap, static_cast<const int32_t*>(starts), static_cast<const int32_t*>(pages),
      static_cast<const int32_t*>(victims), k, page, static_cast<int32_t*>(host), num_pages);
  return static_cast<int>(cudaGetLastError());
}

// Register `bytes` of host memory at `ptr` as pinned and mapped into the
// card's address space (the host page store); its device pointer goes to
// *dev.  Returns a cudaError_t (0 = registered), the error cleared.
extern "C" int guber_host_register(void* ptr, long long bytes, void** dev) {
  cudaError_t rc = cudaHostRegister(ptr, static_cast<size_t>(bytes),
                                    cudaHostRegisterMapped | cudaHostRegisterPortable);
  if (rc == cudaSuccess) rc = cudaHostGetDevicePointer(dev, ptr, 0);
  if (rc != cudaSuccess) cudaGetLastError();
  return static_cast<int>(rc);
}

extern "C" int guber_host_unregister(void* ptr) {
  const cudaError_t rc = cudaHostUnregister(ptr);
  if (rc != cudaSuccess) cudaGetLastError();
  return static_cast<int>(rc);
}

// The device pointer of host memory [ptr, ptr + bytes) if all of it is
// pinned and mapped as one span, else a cudaError_t (the error cleared):
// the wrapper's check that the kernel may reach the store.
extern "C" int guber_host_device_pointer(void* ptr, long long bytes, void** dev) {
  void* first = nullptr;
  void* last = nullptr;
  cudaError_t rc = cudaHostGetDevicePointer(&first, ptr, 0);
  if (rc == cudaSuccess) {
    rc = cudaHostGetDevicePointer(&last, static_cast<char*>(ptr) + bytes - 1, 0);
  }
  if (rc != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(rc);
  }
  if (static_cast<char*>(last) - static_cast<char*>(first) != bytes - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *dev = first;
  return 0;
}



// kOps: 0 ld.cv / st.wt (the port's), 1 plain, 2 streaming (.cs).
// kDirs: bit 0 spill, bit 1 refill.  kQ: quads a thread, reads first.
template <int kOps, int kDirs, int kQ>
__global__ void __launch_bounds__(256) probe(Cols st, const int32_t* starts, const int32_t* pages,
                                             const int32_t* victims, int k, int page,
                                             int32_t* host) {
  const int c = blockIdx.y, quads = page >> 2;
  for (int pg = blockIdx.z; pg < k; pg += gridDim.z) {
    int4* col = reinterpret_cast<int4*>(st.p[c] + starts[pg]);
    const int4* src = reinterpret_cast<const int4*>(host + ((size_t)pages[pg] * 12 + c) * page);
    int4* dst = reinterpret_cast<int4*>(host + ((size_t)victims[pg] * 12 + c) * page);
    for (int q0 = blockIdx.x * blockDim.x * kQ + threadIdx.x; q0 < quads;
         q0 += gridDim.x * blockDim.x * kQ) {
      int4 in[kQ];
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const int q = q0 + j * blockDim.x;
        if ((kDirs & 2) && q < quads)
          in[j] = kOps == 0 ? __ldcv(src + q) : kOps == 2 ? __ldcs(src + q) : src[q];
      }
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const int q = q0 + j * blockDim.x;
        if (q >= quads) continue;
        if (kDirs & 1) {
          if (kOps == 0) __stwt(dst + q, col[q]);
          else if (kOps == 2) __stcs(dst + q, col[q]);
          else dst[q] = col[q];
        }
        if (kDirs & 2) col[q] = in[j];
      }
    }
  }
}

template <int kOps, int kDirs, int kQ>
int run(void* const* cols, const void* s, const void* p, const void* v, int k, int page,
        void* host, void* stream) {
  Cols st;
  for (int c = 0; c < 12; ++c) st.p[c] = static_cast<int32_t*>(cols[c]);
  const int quads = page >> 2;
  int threads = quads / kQ < 256 ? quads / kQ : 256;
  threads = (threads + 31) / 32 * 32;
  const dim3 grid((quads + threads * kQ - 1) / (threads * kQ), 12, k < 65535 ? k : 65535);
  probe<kOps, kDirs, kQ><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      st, static_cast<const int32_t*>(s), static_cast<const int32_t*>(p),
      static_cast<const int32_t*>(v), k, page, static_cast<int32_t*>(host));
  return static_cast<int>(cudaGetLastError());
}

// The refill's host reads with the L2 256-byte prefetch hint.
__global__ void __launch_bounds__(256) probe_l2(Cols st, const int32_t* starts,
                                                const int32_t* pages, const int32_t* victims,
                                                int k, int page, int32_t* host) {
  const int c = blockIdx.y, quads = page >> 2;
  for (int pg = blockIdx.z; pg < k; pg += gridDim.z) {
    int4* col = reinterpret_cast<int4*>(st.p[c] + starts[pg]);
    const int4* src = reinterpret_cast<const int4*>(host + ((size_t)pages[pg] * 12 + c) * page);
    int4* dst = reinterpret_cast<int4*>(host + ((size_t)victims[pg] * 12 + c) * page);
    for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < quads; q += gridDim.x * blockDim.x) {
      int4 in;
      asm volatile("ld.global.L2::256B.v4.s32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(in.x), "=r"(in.y), "=r"(in.z), "=r"(in.w) : "l"(src + q));
      __stwt(dst + q, col[q]);
      col[q] = in;
    }
  }
}

// A block a page: one TMA bulk read of the page's 12 * P * 4 byte host
// block into shared memory, the spill by the threads meanwhile, then the
// shared block into the frame.
__global__ void __launch_bounds__(256) probe_tma(Cols st, const int32_t* starts,
                                                 const int32_t* pages, const int32_t* victims,
                                                 int k, int page, int32_t* host) {
  extern __shared__ __align__(128) int4 block[];
  __shared__ __align__(8) unsigned long long bar;
  const int quads = page >> 2, n = 12 * quads;
  const unsigned bytes = 12u * page * 4u;
  const unsigned bar_s = static_cast<unsigned>(__cvta_generic_to_shared(&bar));
  const unsigned blk_s = static_cast<unsigned>(__cvta_generic_to_shared(block));
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_s));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  unsigned phase = 0;
  for (int pg = blockIdx.x; pg < k; pg += gridDim.x) {
    const int32_t* src = host + (size_t)pages[pg] * 12 * page;
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(bar_s), "r"(bytes) : "memory");
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                   "[%0], [%1], %2, [%3];"
                   ::"r"(blk_s), "l"(src), "r"(bytes), "r"(bar_s) : "memory");
    }
    const long long s = starts[pg];
    int4* dst = reinterpret_cast<int4*>(host + (size_t)victims[pg] * 12 * page);
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      __stwt(dst + i, reinterpret_cast<const int4*>(st.p[i / quads] + s)[i % quads]);
    __syncthreads();
    asm volatile("{\n .reg .pred p;\n WAIT_%=:\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
                 " @!p bra WAIT_%=;\n}" ::"r"(bar_s), "r"(phase) : "memory");
    phase ^= 1;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      reinterpret_cast<int4*>(st.p[i / quads] + s)[i % quads] = block[i];
    __syncthreads();
  }
}

// The spill write after the refill read has come back: the frame's quad
// is loaded, the refill stored over it (which waits for the read), then
// the old quad goes home.  kQ quads a thread, all reads issued first.
template <int kQ>
__global__ void __launch_bounds__(256) probe_rw(Cols st, const int32_t* starts,
                                                const int32_t* pages, const int32_t* victims,
                                                int k, int page, int32_t* host) {
  const int c = blockIdx.y, quads = page >> 2;
  for (int pg = blockIdx.z; pg < k; pg += gridDim.z) {
    int4* col = reinterpret_cast<int4*>(st.p[c] + starts[pg]);
    const int4* src = reinterpret_cast<const int4*>(host + ((size_t)pages[pg] * 12 + c) * page);
    int4* dst = reinterpret_cast<int4*>(host + ((size_t)victims[pg] * 12 + c) * page);
    for (int q0 = blockIdx.x * blockDim.x * kQ + threadIdx.x; q0 < quads;
         q0 += gridDim.x * blockDim.x * kQ) {
      int4 in[kQ], old[kQ];
#pragma unroll
      for (int j = 0; j < kQ; ++j)
        if (q0 + j * blockDim.x < quads) in[j] = __ldcv(src + q0 + j * blockDim.x);
#pragma unroll
      for (int j = 0; j < kQ; ++j)
        if (q0 + j * blockDim.x < quads) old[j] = col[q0 + j * blockDim.x];
#pragma unroll
      for (int j = 0; j < kQ; ++j)
        if (q0 + j * blockDim.x < quads) col[q0 + j * blockDim.x] = in[j];
#pragma unroll
      for (int j = 0; j < kQ; ++j)
        if (q0 + j * blockDim.x < quads) __stwt(dst + q0 + j * blockDim.x, old[j]);
    }
  }
}

template <int kQ>
int run_rw(void* const* cols, const void* s, const void* p, const void* v, int k, int page,
           void* host, void* stream) {
  Cols st;
  for (int c = 0; c < 12; ++c) st.p[c] = static_cast<int32_t*>(cols[c]);
  const int quads = page >> 2;
  int threads = quads / kQ < 256 ? quads / kQ : 256;
  threads = (threads + 31) / 32 * 32;
  const dim3 grid((quads + threads * kQ - 1) / (threads * kQ), 12, k < 65535 ? k : 65535);
  probe_rw<kQ><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      st, static_cast<const int32_t*>(s), static_cast<const int32_t*>(p),
      static_cast<const int32_t*>(v), k, page, static_cast<int32_t*>(host));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int launch_rw1(void* const* cols, const void* s, const void* p, const void* v, int k,
                          int page, void* host, void* stream) {
  return run_rw<1>(cols, s, p, v, k, page, host, stream);
}

extern "C" int launch_rw4(void* const* cols, const void* s, const void* p, const void* v, int k,
                          int page, void* host, void* stream) {
  return run_rw<4>(cols, s, p, v, k, page, host, stream);
}

extern "C" int launch_l2(void* const* cols, const void* s, const void* p, const void* v, int k,
                         int page, void* host, void* stream) {
  Cols st;
  for (int c = 0; c < 12; ++c) st.p[c] = static_cast<int32_t*>(cols[c]);
  const int quads = page >> 2;
  int threads = quads < 256 ? quads : 256;
  threads = (threads + 31) / 32 * 32;
  const dim3 grid((quads + threads - 1) / threads, 12, k < 65535 ? k : 65535);
  probe_l2<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      st, static_cast<const int32_t*>(s), static_cast<const int32_t*>(p),
      static_cast<const int32_t*>(v), k, page, static_cast<int32_t*>(host));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int launch_tma(void* const* cols, const void* s, const void* p, const void* v, int k,
                          int page, void* host, void* stream) {
  Cols st;
  for (int c = 0; c < 12; ++c) st.p[c] = static_cast<int32_t*>(cols[c]);
  const int smem = 12 * page * 4;
  cudaFuncSetAttribute(probe_tma, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  probe_tma<<<k < 65535 ? k : 65535, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      st, static_cast<const int32_t*>(s), static_cast<const int32_t*>(p),
      static_cast<const int32_t*>(v), k, page, static_cast<int32_t*>(host));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int launch(int variant, void* const* cols, const void* s, const void* p, const void* v,
                      int k, int page, void* host, void* stream) {
  switch (variant) {
    case 0: return run<1, 3, 1>(cols, s, p, v, k, page, host, stream);  // plain
    case 1: return run<2, 3, 1>(cols, s, p, v, k, page, host, stream);  // cs
    case 2: return run<0, 3, 4>(cols, s, p, v, k, page, host, stream);  // q4
    case 3: return run<0, 2, 1>(cols, s, p, v, k, page, host, stream);  // refill
    case 4: return run<0, 1, 1>(cols, s, p, v, k, page, host, stream);  // spill
  }
  return -1;
}
"""
VARIANTS = ("plain", "cs", "q4", "refill", "spill")
PAGE, FRAMES, NUM_PAGES = 512, 1 << 15, 1 << 16
BLOCK = 12 * 4 * PAGE
ZIPF_K = 596  # the median zipf fault batch of path (b)


class Swap:
    """The swap library: build, mapped stores, launches."""

    def __init__(self, torch):
        from gubernator_tpu_torch.ops import native_build as nb

        nb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src, so = nb.BUILD_DIR / "page_swap.cu", nb.BUILD_DIR / "libpage_swap.so"
        src.write_text(SWAP_CU)
        r = subprocess.run([nb.nvcc_path(), *nb.NVCC_FLAGS, "-o", str(so), str(src)],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(r.stdout + r.stderr)
        self.ptxas = r.stdout + r.stderr
        lib = ctypes.CDLL(str(so))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.guber_swap_pages.argtypes = [ctypes.POINTER(p), ll, p, p, p, i, i, p, ll, p]
        lib.guber_host_register.argtypes = [p, ll, ctypes.POINTER(p)]
        lib.guber_host_unregister.argtypes = [p]
        lib.guber_host_device_pointer.argtypes = [p, ll, ctypes.POINTER(p)]
        lib.launch.argtypes = [i, ctypes.POINTER(p), p, p, p, i, i, p, p]
        for fn in (lib.launch_l2, lib.launch_tma, lib.launch_rw1, lib.launch_rw4):
            fn.argtypes = lib.launch.argtypes[1:]
        self.lib, self.torch = lib, torch

    def store(self, num_pages: int, page: int, huge: bool = False) -> np.ndarray:
        """A zeroed host store in anonymous mmap memory, pinned and mapped."""
        buf = mmap.mmap(-1, num_pages * 12 * 4 * page)
        if huge:
            buf.madvise(mmap.MADV_HUGEPAGE)
        words = np.frombuffer(buf, dtype=np.int32).reshape(num_pages, 12, page)
        dev = ctypes.c_void_p()
        rc = self.lib.guber_host_register(words.ctypes.data, words.nbytes, ctypes.byref(dev))
        if rc:
            raise RuntimeError(f"cudaHostRegister failed: cudaError {rc}")
        return words

    def release(self, words: np.ndarray) -> None:
        self.lib.guber_host_unregister(words.ctypes.data)

    def device_pointer(self, words: np.ndarray) -> ctypes.c_void_p:
        dev = ctypes.c_void_p()
        rc = self.lib.guber_host_device_pointer(words.ctypes.data, words.nbytes,
                                                ctypes.byref(dev))
        if rc:
            raise ValueError(f"the host store is not pinned, mapped memory: cudaError {rc}")
        return dev

    def launch(self, state, idx, words, host) -> None:
        """One swap: idx = (starts, pages, victims) int32 CUDA tensors."""
        from gubernator_tpu_torch.ops.fused_step import state_pointers, stream_of

        dev = state.meta.device
        cols, cap = state_pointers(state, dev)
        rc = self.lib.guber_swap_pages(cols, cap, *(t.data_ptr() for t in idx), idx[0].shape[0],
                                       words.shape[2], host, words.shape[0], stream_of(dev))
        if rc:
            raise RuntimeError(f"swap launch failed: cudaError {rc}")


def plain_swap(state_np: dict, fields, words: np.ndarray, idx) -> None:
    """The swap's plain version on host copies: state_np maps a column
    name to its int32 array."""
    starts, pages, victims = idx
    page = words.shape[2]
    for s, pg, v in zip(starts, pages, victims):
        frame = np.stack([state_np[f][s : s + page] for f in fields])
        if v >= 0:
            words[v] = frame
        for c, f in enumerate(fields):
            state_np[f][s : s + page] = words[pg, c]


def swap_sets(rng, frames, num_pages, k, page, n=1, never_used=True):
    """n index triples (int32 numpy [3, k]): distinct frames (row 0 and the
    last frame among them where k > 1), refilled pages at or past
    `frames`, victims below it, every third one -1 with `never_used`."""
    out = []
    for _ in range(n):
        fr = rng.choice(frames, k, replace=False)
        if k > 1:
            fr[np.argmin(fr)], fr[np.argmax(fr)] = 0, frames - 1
        victims = rng.choice(frames, k, replace=False)
        if never_used:
            victims[::3] = -1
        out.append(np.stack([fr * page, rng.choice(np.arange(frames, num_pages), k,
                                                   replace=False), victims]).astype(np.int32))
    return out


def holds(torch, sw, rng) -> None:
    from gubernator_tpu_torch.ops import bucket_kernel as tk

    frames, num_pages = 256, 512
    for page in (16, 64, 512):
        state = cs.extreme_page_state(torch, np, rng, frames * page)
        words = sw.store(num_pages, page)
        words[:] = rng.integers(-(2**31), 2**31, words.shape, dtype=np.int64).astype(np.int32)
        host = sw.device_pointer(words)
        for k in (1, 64):
            for idx in swap_sets(rng, frames, num_pages, k, page, 2):
                plain = {f: c.cpu().numpy().copy() for f, c in zip(tk.BucketState._fields, state)}
                plain_words = words.copy()
                sw.launch(state, tuple(torch.from_numpy(a).cuda() for a in idx), words, host)
                torch.cuda.synchronize()
                plain_swap(plain, tk.BucketState._fields, plain_words, idx)
                same = np.array_equal(words, plain_words) and all(
                    np.array_equal(c.cpu().numpy(), plain[f])
                    for f, c in zip(tk.BucketState._fields, state))
                cs.check(same, f"the swap differs from its plain version at P={page} k={k}")
        sw.release(words)
    print("holds: the swap bit-equal to its plain version at P = 16, 64, 512, k = 1 and 64, "
          "frames at row 0 and at the last frame, used and never-used victims", flush=True)


def fault_batches(torch, sw, rng, rates) -> None:
    """A fault batch at P = 512: K9 / K10 (the port's) and the swap, in turns."""
    from gubernator_tpu_torch.ops.bucket_kernel import make_state
    from gubernator_tpu_torch.ops.page_words import gather_pages, load_pages

    state = make_state(FRAMES * PAGE, torch.device("cuda"))
    words = sw.store(NUM_PAGES, PAGE)
    host = sw.device_pointer(words)
    for k in (1, 16, ZIPF_K):
        sets = [tuple(torch.from_numpy(a).cuda() for a in idx)
                for idx in swap_sets(rng, FRAMES, NUM_PAGES, k, PAGE, 16, never_used=False)]
        n_starts = -(-(2 * k) // 4) * 4
        buf = torch.zeros(n_starts + k * 12 * PAGE, dtype=torch.int32, pin_memory=True)
        buf[:k] = buf[k : 2 * k] = sets[0][0].cpu()
        staged = torch.empty_like(buf, device="cuda")
        home = torch.empty((k, 12, PAGE), dtype=torch.int32, pin_memory=True)

        def k9_k10(_i):
            staged.copy_(buf, non_blocking=True)
            home.copy_(gather_pages(state, staged[:k], PAGE), non_blocking=True)
            load_pages(state, staged[k : 2 * k], staged[n_starts:].view(k, 12, PAGE))

        def swap(i):
            sw.launch(state, sets[i % 16], words, host)

        n = 200 if k <= 16 else 40
        turns = [(name, cs.device_ms(torch, fn, n)) for name, fn in
                 (("K9 / K10", k9_k10), ("swap", swap), ("swap", swap), ("K9 / K10", k9_k10))]
        bound = cs.pcie_bound_ms(k, k, PAGE, rates)
        print(f"fault batch at P=512, k={k}: " + ", ".join(
            f"{name} {ms * 1e3:.2f} us" for name, ms in turns)
            + f"; PCIe bound {bound * 1e3:.2f} us", flush=True)
    sw.release(words)
    del state
    torch.cuda.empty_cache()


def variants(torch, sw, rng) -> None:
    """The swap's kernel variants, stores and the copy engines."""
    from gubernator_tpu_torch.ops.bucket_kernel import make_state
    from gubernator_tpu_torch.ops.fused_step import state_pointers, stream_of

    state = make_state(FRAMES * PAGE, torch.device("cuda"))
    dev = state.meta.device
    stream = stream_of(dev)
    cols, _cap = state_pointers(state, dev)
    stores = {"mmap 4 KiB": sw.store(NUM_PAGES, PAGE),
              "mmap MADV_HUGEPAGE": sw.store(NUM_PAGES, PAGE, huge=True)}
    pinned = torch.zeros((NUM_PAGES, 12, PAGE), dtype=torch.int32, pin_memory=True)
    stores["torch pinned"] = pinned.numpy()
    thp = Path("/sys/kernel/mm/transparent_hugepage/enabled")
    print(f"transparent huge pages: {thp.read_text().strip() if thp.exists() else 'unknown'}",
          flush=True)
    words = stores["mmap 4 KiB"]
    host = sw.device_pointer(words)
    for k in (16, ZIPF_K):
        idx = [tuple(torch.from_numpy(a).cuda() for a in t)
               for t in swap_sets(rng, FRAMES, NUM_PAGES, k, PAGE, 16, never_used=False)]
        n = 200 if k <= 16 else 30
        gb = k * BLOCK / 1e3  # bytes each way / 1e3: GB/s from µs

        def line(what, ms):
            print(f"k={k:4d} {what:42s} {ms * 1e3:9.2f} us  {gb / (ms * 1e3):6.2f} GB/s each way",
                  flush=True)

        for name, st in stores.items():
            try:
                sh = sw.device_pointer(st)
            except ValueError as e:  # a store the card cannot reach: reported, not timed
                print(f"k={k:4d} swap, {name}: refused ({e})", flush=True)
                continue
            line(f"swap, {name}", cs.device_ms(
                torch, lambda i, st=st, sh=sh: sw.launch(state, idx[i % 16], st, sh), n))
        hp = words.ctypes.data
        lib = sw.lib
        for name, fn in (("rw", lib.launch_rw1), ("rw-q4", lib.launch_rw4),
                         ("l2-256B", lib.launch_l2), ("tma", lib.launch_tma)):
            st_, pg_, vic_ = (t.cpu().numpy() for t in idx[0])
            words[pg_] = rng.integers(-(2**31), 2**31, words[pg_].shape, dtype=np.int32)
            for col in state:
                col.copy_(torch.randint(-(2**31), 2**31, col.shape, dtype=torch.int64,
                                        device=col.device))
            rows = torch.from_numpy((st_[:, None] + np.arange(PAGE)).reshape(-1)).cuda().long()
            frames0 = torch.stack([col[rows].view(k, PAGE) for col in state], 1).cpu().numpy()
            refill0 = words[pg_].copy()
            torch.cuda.synchronize()
            rc = fn(cols, *(t.data_ptr() for t in idx[0]), k, PAGE, hp, stream)
            torch.cuda.synchronize()
            frames1 = torch.stack([col[rows].view(k, PAGE) for col in state], 1).cpu().numpy()
            cs.check(rc == 0 and np.array_equal(words[vic_], frames0)
                     and np.array_equal(frames1, refill0),
                     f"the {name} variant differs from the swap's effect (rc {rc})")
            line(f"variant {name}", cs.device_ms(
                torch, lambda i, fn=fn: fn(cols, *(t.data_ptr() for t in idx[i % 16]), k, PAGE,
                                          hp, stream), n))
        for v, name in enumerate(VARIANTS):
            line(f"variant {name}", cs.device_ms(
                torch, lambda i, v=v: lib.launch(v, cols, *(t.data_ptr() for t in idx[i % 16]),
                                                 k, PAGE, hp, stream), n))
        up_h = torch.empty(k * BLOCK, dtype=torch.uint8, pin_memory=True)
        down_h = torch.empty(k * BLOCK, dtype=torch.uint8, pin_memory=True)
        up_d = torch.empty(k * BLOCK, dtype=torch.uint8, device=dev)
        down_d = torch.empty(k * BLOCK, dtype=torch.uint8, device=dev)
        line("copy engine up", cs.device_ms(
            torch, lambda i: up_d.copy_(up_h, non_blocking=True), n))
        line("copy engine down", cs.device_ms(
            torch, lambda i: down_h.copy_(down_d, non_blocking=True), n))
        side = torch.cuda.Stream()

        def both(_i):
            side.wait_stream(torch.cuda.current_stream())
            up_d.copy_(up_h, non_blocking=True)
            with torch.cuda.stream(side):
                down_h.copy_(down_d, non_blocking=True)
            torch.cuda.current_stream().wait_stream(side)

        line("copy engines, both ways on two streams", cs.device_ms(torch, both, n))
    for name in ("mmap 4 KiB", "mmap MADV_HUGEPAGE"):
        sw.release(stores[name])
    del state, pinned
    torch.cuda.empty_cache()


def use_swap(engine, sw, acc) -> None:
    """Replace the paged engine's fault path by the swap's: the victim picks
    and the page table exactly as `PagePlane._fault_batch` keeps them, the
    store mapped, one index upload and one launch, no copy of the words."""
    pp = engine.paging
    words = sw.store(pp.num_pages, pp.page_size)
    words[:] = pp.host_words
    pp.host_words = words
    host = sw.device_pointer(words)
    acc["store"] = words

    def fault_batch(eng, missing, pinned):
        t0 = time.monotonic()
        frames, victims = [], []
        for page in missing:
            frame = pp._pick_victim(pinned)
            victim = int(pp.page_of[frame])
            victims.append(victim if pp._ever_used[victim] else -1)
            pp.frame_of[victim] = -1
            pp.frame_of[page] = frame
            pp.page_of[frame] = page
            pp._ref[frame] = True
            frames.append(frame)
        k, ks = len(missing), len(victims) - victims.count(-1)
        tl = time.perf_counter()
        idx = np.array([frames, missing, victims], dtype=np.int64)
        idx[0] <<= pp.page_shift
        staged = eng._stage(idx.astype(np.int32).reshape(-1)).view(3, k)
        sw.launch(eng._state, (staged[0], staged[1], staged[2]), words, host)
        eng.dispatches_total += 1
        acc["launch"] += time.perf_counter() - tl
        acc["launches"] += 1
        pp.faults += k
        pp.refills += k
        pp.spills += ks
        pp.fault_batches += 1
        pp.fault_duration.observe(time.monotonic() - t0, k)

    pp._fault_batch = fault_batch


def path_b(torch, sw, swap: bool, card: str):
    """chip_smoke.py's path (b) through the port's fault path or the swap's.
    Returns (readings, page table, host store)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.core.engine import DecisionEngine

    rng = np.random.default_rng(cs.SEED + 9)
    page, frames, n_keys = cs.PAGED_B
    ns = cs.NOW0 * 10**6
    with cs.paged_env(page, frames):
        paged = DecisionEngine(n_keys, clock=Clock().freeze_at(ns))
    dense = DecisionEngine(n_keys, clock=Clock().freeze_at(ns))
    acc = {"launch": 0.0, "launches": 0}
    if swap:
        use_swap(paged, sw, acc)
    fill_cols = cs.paged_cols(np, np.zeros(cs.PAGED_FILL, np.int64))
    for lo in range(0, n_keys, cs.PAGED_FILL):
        keys = cs.paged_keys(np, np.arange(lo, lo + cs.PAGED_FILL))
        cs.same_answers(np, paged.apply_columnar(keys, *fill_cols, now_ms=cs.NOW0),
                        dense.apply_columnar(keys, *fill_cols, now_ms=cs.NOW0), "fill")
    perm = rng.permutation(n_keys)
    pp = paged.paging
    batches = []
    for _ in range(cs.PAGED_B_BATCHES):
        idx = cs.paged_zipf(np, rng, perm, cs.ZIPF_BATCH)
        batches.append((cs.paged_keys(np, idx), cs.paged_cols(np, idx)))
    walls, n_prof = [], 8
    launch0 = acc["launch"]

    def run(b, eng):
        keys, cols = batches[b]
        return eng.apply_columnar(keys, *cols, now_ms=cs.NOW0 + 7 * (b + 1))

    def timed(b):
        t = time.perf_counter()
        got = run(b, paged)
        walls.append(time.perf_counter() - t)
        return got

    with cs.fault_split(pp) as split:
        for b in range(cs.PAGED_B_BATCHES - n_prof):
            cs.same_answers(np, timed(b), run(b, dense), "zipf")
        tail = range(cs.PAGED_B_BATCHES - n_prof, cs.PAGED_B_BATCHES)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = [timed(b) for b in tail]
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t) * 1e6
    for b, g in zip(tail, got):
        cs.same_answers(np, g, run(b, dense), "zipf")
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0)
    split["launch"] += acc["launch"] - launch0
    per = {k: split[k] / split["pages"] * 1e6 for k in ("wall", "picks", "launch")}
    per["copies"] = per["wall"] - per["picks"] - per["launch"]
    rate = cs.ZIPF_BATCH * len(walls) / sum(walls)
    what = "swap" if swap else "K9 / K10"
    print(f"path (b), {what}: {split['pages'] / cs.PAGED_B_BATCHES:.1f} faults a zipf batch, "
          f"fault wall a faulted page {per['wall']:.2f} us = victim picks {per['picks']:.2f} + "
          f"host copies and bookkeeping {per['copies']:.2f} + launch-and-wait "
          f"{per['launch']:.2f}; {rate:.0f} decisions/s; profiled window of {n_prof} batches: "
          f"wall {window_us:.1f} us, device busy {busy_us:.1f} us, idle share "
          f"{1 - busy_us / window_us:.4f}; fault batches {pp.fault_batches} | {card}", flush=True)
    torch.cuda.synchronize()
    table = {n: getattr(pp, n).copy() for n in ("frame_of", "page_of", "_ref", "_ever_used")}
    table["_hand"] = pp._hand
    words = pp.host_words[np.nonzero(pp._ever_used)[0]].copy()
    paged.close()
    dense.close()
    if swap:
        sw.release(acc["store"])
    return table, words


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_page_swap: needs a CUDA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip()
    sw = Swap(torch)
    for line in sw.ptxas.splitlines():
        if "swap_pages_kernel" in line or ("Used" in line and "registers" in line):
            print("ptxas:", line.strip())
    rng = np.random.default_rng(cs.SEED + 13)
    rates = cs.pinned_copy_rates(torch)
    print(f"pinned copies {rates[0] / 1e9:.2f} GB/s up, {rates[1] / 1e9:.2f} GB/s down "
          f"(64 MiB each) | {card}", flush=True)
    holds(torch, sw, rng)
    fault_batches(torch, sw, rng, rates)
    variants(torch, sw, rng)
    runs = [path_b(torch, sw, swap, card) for swap in (False, True, True, False)]
    for table, words in runs[1:]:
        same = all(np.array_equal(runs[0][0][n], table[n]) for n in table) and np.array_equal(
            runs[0][1], words)
        cs.check(same, "the swap's path (b) must leave the page table and host store of K9 / K10")
    print("path (b): page tables and host stores of all four runs equal word for word", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
