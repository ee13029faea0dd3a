#!/usr/bin/env python3
"""K8 (the sketch's window rotation: zero one plane, or both) beside the
TMA design that was tried for it and not kept, timed on one GPU in one
run.

    python3 scripts/torch_k8_tma.py

The TMA design: a zeroed shared-memory tile of C KiB streamed over the
span by Hopper's bulk asynchronous copy (`cp.async.bulk.global.
shared::cta.bulk_group`, one elected thread a block, then
`commit_group` and `wait_group 0`), the span's unaligned head and tail
zeroed word by word, in two forms:

* tma-span-cC-bB — a persistent grid of B blocks an SM
  (`cudaDevAttrMultiProcessorCount`), each owning one contiguous run;
* tma-turn-cC — C KiB chunks dealt out one a block, the grid uncapped.

At depth 4 and widths 2^20 (16 MiB a plane, the default) and 2^24
(256 MiB), on one plane (a window step) and on both (a gap), each
candidate is first held bit-equal to `rotate_reference`, then K8
(csrc/sketch.cu `guber_sketch_rotate`, as the port launches it), the
TMA forms and `zero_()` (the one PyTorch call that computes the same
function) are timed with CUDA events in four turns (the list, the list
reversed, and both again from its middle; each figure the mean of its
turns).  Prints one line per width and span, fastest first, with the
bytes bound, then the card's name and power limit.  The TMA source is
below; it is built with the port's nvcc flags into
gubernator_tpu_torch/csrc/build/.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TMA_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>
constexpr int kThreads = 256;

template <int CHUNK, bool TURN>
__global__ void __launch_bounds__(kThreads) tma(int32_t* __restrict__ p, long long n, int head,
                                                long long nv, long long per_block) {
  constexpr int kVecs = CHUNK / 16;
  __shared__ int4 tile[kVecs];
  const int tid = threadIdx.x;
  if (blockIdx.x == 0 && tid < head) p[tid] = 0;
  if (blockIdx.x == gridDim.x - 1)
    for (long long k = head + nv * 4 + tid; k < n; k += kThreads) p[k] = 0;
  int4* body = reinterpret_cast<int4*>(p + head);
  for (int i = tid; i < kVecs; i += kThreads) tile[i] = make_int4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (tid != 0) return;
  const uint32_t src = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  long long v0 = TURN ? blockIdx.x * static_cast<long long>(kVecs) : blockIdx.x * per_block;
  const long long v1 = TURN ? nv : (v0 + per_block < nv ? v0 + per_block : nv);
  const long long step = TURN ? static_cast<long long>(gridDim.x) * kVecs : kVecs;
  for (; v0 < v1; v0 += step) {
    const long long len = v1 - v0 < kVecs ? v1 - v0 : kVecs;
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 :: "l"(body + v0), "r"(src), "r"(static_cast<uint32_t>(len * 16)) : "memory");
  }
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// turn: 0 span, 1 dealt chunks; chunk in KiB (16 or 32); bps: blocks an
// SM (0 = one block a chunk, no cap).
extern "C" int launch(int turn, int chunk, int bps, void* vp, long long n, void* stream) {
  if (n <= 0) return 0;
  int32_t* p = static_cast<int32_t*>(vp);
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / 4);
  const int head = mis == 0 ? 0 : (4 - mis < n ? 4 - mis : static_cast<int>(n));
  const long long nv = (n - head) / 4;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long unit = chunk * 64LL;
  long long blocks = (nv + unit - 1) / unit;
  if (bps > 0 && blocks > static_cast<long long>(bps) * sms) blocks = static_cast<long long>(bps) * sms;
  if (blocks < 1) blocks = 1;
  const long long per_block = (nv + blocks - 1) / blocks;
  const unsigned g = static_cast<unsigned>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk == 16 && turn) tma<16 * 1024, true><<<g, kThreads, 0, s>>>(p, n, head, nv, per_block);
  else if (chunk == 16) tma<16 * 1024, false><<<g, kThreads, 0, s>>>(p, n, head, nv, per_block);
  else if (chunk == 32) tma<32 * 1024, false><<<g, kThreads, 0, s>>>(p, n, head, nv, per_block);
  else return -1;
  return static_cast<int>(cudaGetLastError());
}
"""

DEPTH = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM peak memory rate (NVIDIA data sheet)
# name → (turn, chunk KiB, blocks an SM); None: K8 or zero_()
CANDIDATES = {"K8": None, "zero_()": None,
              "tma-span-c16-b1": (0, 16, 1), "tma-span-c16-b2": (0, 16, 2),
              "tma-span-c32-b1": (0, 32, 1), "tma-span-c32-b2": (0, 32, 2),
              "tma-turn-c16": (1, 16, 0)}


def device_ms(torch, fn, n: int = 40, windows: int = 5) -> float:
    """Median device time per launch: n launches queued behind a spin
    kernel, timed with CUDA events."""
    per = []
    for _ in range(windows):
        torch.cuda._sleep(100_000_000)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(n):
            fn(i)
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / n)
    return statistics.median(per)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_k8_tma: needs a CUDA GPU", file=sys.stderr)
        return 2
    from gubernator_tpu_torch.ops import native_build as nb
    from gubernator_tpu_torch.ops import sketch as ps
    from gubernator_tpu_torch.ops.fused_step import stream_of

    nb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, so = nb.BUILD_DIR / "k8_tma.cu", nb.BUILD_DIR / "libk8_tma.so"
    src.write_text(TMA_CU)
    r = subprocess.run([nb.nvcc_path(), *nb.NVCC_FLAGS, "-o", str(so), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        print(r.stdout + r.stderr, file=sys.stderr)
        return 1
    tma = ctypes.CDLL(str(so))
    tma.launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_void_p]
    tma.launch.restype = ctypes.c_int
    dev = torch.device("cuda")
    stream = stream_of(dev)

    def make(name, arg, counts, delta):
        """A rotation of `counts` by `delta` windows from plane i & 1
        (one plane or both, as K8's wrapper picks the span); the launch
        returns 0 or a cudaError."""
        def span(i):
            return counts[1 - (i & 1)] if delta == 1 else counts
        if name == "K8":
            return lambda i: (ps.sketch_rotate(counts, i & 1, delta), 0)[1]
        if name == "zero_()":
            return lambda i: (span(i).zero_(), 0)[1]
        return lambda i: tma.launch(*arg, span(i).data_ptr(), span(i).numel(), stream)

    for width in (1 << 20, 1 << 24):
        counts = torch.empty((2, DEPTH, width), dtype=torch.int32, device=dev)
        for label, delta in (("one plane", 1), ("both planes", 3)):
            fns = {name: make(name, arg, counts, delta) for name, arg in CANDIDATES.items()}
            for name, fn in fns.items():
                counts.random_(-1000, 1000)
                plain = counts.cpu()
                ps.rotate_reference(plain, 0, delta)
                rc = fn(0)
                torch.cuda.synchronize()
                if rc != 0 or not torch.equal(counts.cpu(), plain):
                    print(f"torch_k8_tma: {name} differs from rotate_reference at width {width}, "
                          f"{label}", file=sys.stderr)
                    return 1
            got = {name: [] for name in fns}
            names = list(fns)
            half = names[len(names) // 2:] + names[: len(names) // 2]
            for name in names + names[::-1] + half + half[::-1]:
                got[name].append(device_ms(torch, fns[name]))
            words = counts[0].numel() * (1 if delta == 1 else 2)
            bound_us = words * 4 / HBM_BYTES_PER_S * 1e6
            ranked = sorted((statistics.mean(v) * 1e3, name) for name, v in got.items())
            print(f"width {width}, {label} ({words * 4 >> 20} MiB, bound {bound_us:.2f} us, "
                  "bytes): " + ", ".join(f"{name} {us:.2f}" for us, name in ranked), flush=True)
        del counts
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
