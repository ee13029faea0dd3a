#!/usr/bin/env python3
"""K12 (the sharded engine's collapsed chunk of every shard,
csrc/sharded_step.cu `shard_collapsed_kernel`: K3's tiles a shard, one
publication chain a shard) beside its block form, tried and not kept,
on one GPU in one run.

    python3 scripts/torch_k12_block.py

The block form is one block of W threads a shard (thread = lane, W = 64
to 1024): the block holds the shard's whole chunk, so every segment's
lanes are in it; owners (position 0) gather, update and write their
segment's closed-form terms to shared memory, and after one
__syncthreads the other lanes answer from them.  No publish buffer, no
ticket, no wait on another block.  A clear entry is found among the
chunk's segment slots (row 1, staged in shared memory) and marked for
its owner, or, a slot of no segment, written at once.  It is built from
the source below with the port's nvcc flags, `lane_math.cuh` and
`collapsed_tile.cuh` (K3's closed form).

It is first held bit-equal to the plain version
(`shard_clears_reference` + `sharded_collapsed_step_reference`: pout and
all 12 state columns) at 64 to 1024 lanes a shard over 4 shards of 2.5 x
10^7 and 8 shards of 2^16: zipf chunks (a hot key over half of shard 0),
padding, an empty shard, clears of segment slots and of other slots.
Then it and K12 as the port launches it are timed with CUDA events
behind a spin kernel in four turns (block, K12, K12, block; each figure
the median of its turns) at the same widths over 4 shards of 2.5 x 10^7.
Prints one line per reading, then the card's name and power limit.

The form was not kept: one SM issues every segment's random state reads
and their address translation, so from 512 lanes a shard it loses to the
chain, whose tiles spread the reads over W / 64 SMs a shard (PERF.md §6).
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BLOCK_CU = r"""
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include "collapsed_tile.cuh"
#include "lane_math.cuh"

using namespace lane;

namespace {

constexpr int kCollapsedRows = 19;
constexpr int kOutRows = 5;

__device__ __forceinline__ Cols shard_cols(const Cols& st, long long shard_cap, int sh) {
  Cols c;
#pragma unroll
  for (int k = 0; k < kCols; ++k) c.p[k] = st.p[k] + (size_t)sh * (size_t)shard_cap;
  return c;
}

// K12's block form: one block of W threads holds shard blockIdx.x's
// whole chunk (thread = lane; see the note at the top).
template <int W>
__global__ void __launch_bounds__(W)
shard_collapsed_block_kernel(Cols st, long long shard_cap, const int32_t* __restrict__ pin,
                             const int32_t* __restrict__ clear_slots, int n_clear,
                             int32_t* __restrict__ pout) {
  using collapsed::Extra;
  constexpr int kPre = collapsed::kPre;
  extern __shared__ __align__(16) unsigned char smem[];
  Extra* ext = reinterpret_cast<Extra*>(smem);                // owner lane -> its terms
  int32_t* seg_slot = reinterpret_cast<int32_t*>(ext + W);    // row 1, segment column -> slot
  int32_t* cleared = seg_slot + W;                            // segment column -> cleared
  const int sh = (int)blockIdx.x;
  const Cols c = shard_cols(st, shard_cap, sh);
  const int32_t* p = pin + (size_t)sh * kCollapsedRows * W;
  const int32_t* cl = clear_slots + (size_t)sh * (size_t)n_clear;
  int32_t* o = pout + (size_t)sh * kOutRows * W;
  const int lane = threadIdx.x;
  auto at = [&](int r, int i) { return __ldg(p + (size_t)r * W + i); };
  auto at64 = [&](int hr, int i) { return combine(at(hr, i), at(hr + 1, i)); };
  const int64_t now = combine(__ldg(p), __ldg(p + 1));

  // The lane's segment and position, then the segment's slot, then (the
  // owner, position 0) its request and the slot's 12 words.
  int32_t sg = at(17, lane);
  sg = sg < 0 ? 0 : (sg >= W ? W - 1 : sg);
  const int32_t pos = at(18, lane);
  const bool owner = pos == 0;
  const int32_t slot = at(1, sg);
  const bool valid = owner && slot >= 0 && (long long)slot < shard_cap;
  int32_t m = 0;
  Req q{};
  int32_t g[kCols];
  if (owner) {
    m = at(2, sg);
    q = Req{at(3, sg), at(4, sg), at64(5, sg), at64(7, sg),
            at64(9, sg), at64(11, sg), at64(13, sg), at64(15, sg)};
    gather(c, slot, valid, g);
  }

  // Clears: a segment's slot is marked for its owner, which drops the bit
  // in registers; any other in-range slot is read by nobody here, so it
  // is written at once.
  if (n_clear > 0) {  // uniform across the block
    seg_slot[lane] = at(1, lane);  // ascending: the segments', then cap + j
    cleared[lane] = 0;
    __syncthreads();
    for (int i0 = lane; i0 < n_clear; i0 += kPre * W) {
      int32_t e[kPre];
#pragma unroll
      for (int k = 0; k < kPre; ++k) {
        const int i = i0 + k * W;
        e[k] = i < n_clear ? __ldg(cl + i) : -1;
      }
#pragma unroll
      for (int k = 0; k < kPre; ++k) {
        const int32_t s = e[k];
        if (s < 0 || (long long)s >= shard_cap) continue;
        int a = 0, z = W;  // first column with seg_slot >= s
        while (a < z) {
          const int mid = (a + z) >> 1;
          if (seg_slot[mid] < s) a = mid + 1; else z = mid;
        }
        if (a < W && seg_slot[a] == s) {
          cleared[a] = 1;
        } else {
          c.p[kMeta][s] = __ldcg(c.p[kMeta] + s) & ~1;
        }
      }
    }
    __syncthreads();
    if (owner && cleared[sg]) g[kMeta] &= ~1;
  }

  if (owner) {
    Vals v;
    Resp r1;
    int64_t lk_rate_i;
    update_lane(g, valid, q, now, v, r1, lk_rate_i);
    // The closed form for the m - 1 extras, as K3's owner computes it.
    const int64_t extras = m - 1 > 0 ? m - 1 : 0;
    const int64_t h = q.hits;
    const int64_t h_safe = h > 1 ? h : 1;
    const bool is_tok = q.algo == 0;
    auto clip = [&](int64_t x) { return x < 0 ? 0 : (x > extras ? extras : x); };
    const double W1f = v.rem_f;
    Extra e;
    e.base = is_tok ? v.rem : f2i64(W1f);
    e.a2 = h > 0 ? clip(floordiv_pos(e.base, h_safe)) : extras;
    e.h = h;
    e.after = sub64(e.base, mul64(e.a2, h));
    e.reset = is_tok ? v.exp : q.limit;
    e.lk_rate = lk_rate_i;
    e.acc_status = is_tok ? v.status : kUnder;
    e.tok = is_tok;
    ext[lane] = e;
    o[lane] = r1.status;
    o[W + lane] = hi_word(r1.rem);
    o[2 * W + lane] = lo_word(r1.rem);
    o[3 * W + lane] = hi_word(r1.reset);
    o[4 * W + lane] = lo_word(r1.reset);
    if (valid) {  // the segment's final values
      if (is_tok) {
        v.rem = e.after;
        if (h > 0 && e.after == 0 && e.a2 < extras) v.status = kOver;  // the sticky OVER
      } else {
        v.rem_f = W1f - (double)mul64(e.a2, h);
      }
      int32_t words[kCols];
      encode_vals(v, words);
      store(c, slot, words);
    }
  }
  __syncthreads();
  if (!owner) {
    // Every segment's lanes are in the block: the owner is lane - pos.
    const int own = lane - pos;
    int32_t status;
    int64_t rem, reset;
    collapsed::answer_extra(ext[own < 0 ? 0 : own], pos, now, status, rem, reset);
    o[lane] = status;
    o[W + lane] = hi_word(rem);
    o[2 * W + lane] = lo_word(rem);
    o[3 * W + lane] = hi_word(reset);
    o[4 * W + lane] = lo_word(reset);
  }
}

// Dynamic shared memory of the block form at width W: the terms and two
// int32 rows a lane.
constexpr size_t block_smem(int W) {
  return (size_t)W * (sizeof(collapsed::Extra) + 2 * sizeof(int32_t));
}

template <int W>
int launch_block(const Cols& c, long long shard_cap, int n_sh, const void* pin,
                 const void* clear_slots, int n_clear, void* pout, cudaStream_t stream) {
  constexpr size_t smem = block_smem(W);
  if (smem > 48 * 1024) {  // above the default, the kernel must be allowed it first
    const cudaError_t e = cudaFuncSetAttribute(shard_collapsed_block_kernel<W>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  shard_collapsed_block_kernel<W><<<n_sh, W, smem, stream>>>(
      c, shard_cap, static_cast<const int32_t*>(pin), static_cast<const int32_t*>(clear_slots),
      n_clear, static_cast<int32_t*>(pout));
  return static_cast<int>(cudaGetLastError());
}


}  // namespace

// cols: 12 device pointers; pin int32 [n_sh, 19, width], width a power of
// two in [64, 1024]; clear_slots int32 [n_sh, n_clear]; pout int32
// [n_sh, 5, width].  Returns 0 once launched, else the cudaError.
extern "C" int launch(void* const* cols, long long shard_cap, int n_sh, const void* pin,
                      int width, const void* clear_slots, int n_clear, void* pout,
                      void* stream) {
  if (n_sh < 1 || n_clear < 0 || shard_cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  Cols c;
  for (int i = 0; i < kCols; ++i) c.p[i] = static_cast<int32_t*>(cols[i]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 64: return launch_block<64>(c, shard_cap, n_sh, pin, clear_slots, n_clear, pout, s);
    case 128: return launch_block<128>(c, shard_cap, n_sh, pin, clear_slots, n_clear, pout, s);
    case 256: return launch_block<256>(c, shard_cap, n_sh, pin, clear_slots, n_clear, pout, s);
    case 512: return launch_block<512>(c, shard_cap, n_sh, pin, clear_slots, n_clear, pout, s);
    case 1024: return launch_block<1024>(c, shard_cap, n_sh, pin, clear_slots, n_clear, pout, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
"""

WIDTHS = (64, 128, 256, 512, 1024)


def build():
    from gubernator_tpu_torch.ops import native_build as nb

    out = nb.BUILD_DIR / "k12_block"
    out.mkdir(parents=True, exist_ok=True)
    src, so = out / "k12_block.cu", out / "libk12_block.so"
    src.write_text(BLOCK_CU)
    r = subprocess.run([nb.nvcc_path(), *nb.NVCC_FLAGS, f"-I{nb.CSRC}", "-o", str(so), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}\n{r.stderr}")
    print(f"[build] {so.name}: " + " | ".join(
        ln.strip() for ln in (r.stdout + r.stderr).splitlines() if "registers" in ln))
    lib = ctypes.CDLL(str(so))
    p = ctypes.c_void_p
    lib.launch.argtypes = [ctypes.POINTER(p), ctypes.c_longlong, ctypes.c_int, p, ctypes.c_int, p,
                           ctypes.c_int, p, p]
    lib.launch.restype = ctypes.c_int
    return lib


def block_form(torch, lib, state, pin, cap: int, rows):
    """The block form over pin [n_sh, 19, W] on the current stream."""
    from gubernator_tpu_torch.ops.fused_step import state_pointers, stream_of

    cols, _ = state_pointers(state, pin.device)
    pout = torch.empty((pin.shape[0], 5, pin.shape[2]), dtype=torch.int32, device=pin.device)
    rc = lib.launch(cols, cap, pin.shape[0], pin.data_ptr(), pin.shape[2], rows.data_ptr(),
                    rows.shape[1], pout.data_ptr(), stream_of(pin.device))
    if rc != 0:
        raise RuntimeError(f"block form launch failed: cudaError {rc}")
    return pout


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from gubernator_tpu_torch.ops import bucket_kernel as tk
    from gubernator_tpu_torch.ops.sharded_step import shard_collapsed_step

    if not torch.cuda.is_available():
        print("torch_k12_block: needs a CUDA GPU", file=sys.stderr)
        return 2
    lib = build()
    rng = np.random.default_rng(1612)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    for n_sh, cap in ((8, 1 << 16), (4, 25_000_000)):
        state = cs.random_state(torch, n_sh * cap, cs.NOW0, int(rng.integers(2**31)))
        plain = cs.copy_state(state)
        for width in WIDTHS:
            for it in range(2):
                pin_np, slots_of = cs.sharded_pin(np, rng, n_sh, cap, width, cs.NOW0 + it,
                                                  collapsed=True)
                rows_np = cs.shard_clears(np, rng, cap, slots_of)
                pin, rows = torch.from_numpy(pin_np).cuda(), torch.from_numpy(rows_np).cuda()
                got = block_form(torch, lib, state, pin, cap, rows)
                tk.shard_clears_reference(plain, rows, cap)
                want = tk.sharded_collapsed_step_reference(plain, pin, cap)
                torch.cuda.synchronize()
                err = max(int((got.long() - want.long()).abs().max().item()),
                          cs.compare_states(torch, state, plain))
                if err:
                    print(f"block form differs from the plain version: {n_sh} x {cap}, W "
                          f"{width}, err {err}", file=sys.stderr)
                    return 1
        print(f"[hold] block form = plain (pout and 12 columns), {n_sh} x {cap}, W {WIDTHS}")
        del plain
        if n_sh == 4:
            for width in WIDTHS:
                pin_np, slots_of = cs.sharded_pin(np, rng, n_sh, cap, width, cs.NOW0,
                                                  collapsed=True)
                rows_np = cs.shard_clears(np, rng, cap, slots_of)
                pin, rows = torch.from_numpy(pin_np).cuda(), torch.from_numpy(rows_np).cuda()
                runs = {
                    "block": lambda i: block_form(torch, lib, state, pin, cap, rows),
                    "K12": lambda i: shard_collapsed_step(state, pin, cap, rows),
                }
                got = {k: [] for k in runs}
                for name in ("block", "K12", "K12", "block"):
                    got[name].append(cs.device_ms(torch, runs[name], 40))
                print(f"[time] W {width}, {n_sh} x {cap}: block form "
                      f"{statistics.median(got['block']) * 1e3:.3f} us, K12 (the chain) "
                      f"{statistics.median(got['K12']) * 1e3:.3f} us a launch "
                      f"(turns {[round(x * 1e3, 3) for x in got['block']]} / "
                      f"{[round(x * 1e3, 3) for x in got['K12']]}) | {card}")
        del state
        torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
