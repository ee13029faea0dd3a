// K6 and K13: the expiry sweep of a group of windows in one launch, for
// Hopper (sm_90a).  K6 sweeps one state; K13 the same windows of every
// shard of a sharded state.  One kernel serves both: K6 is K13 with one
// shard.
//
// Replaces gubernator_tpu/ops/expiry.py:40 `sweep_window_scan` and :78
// `sweep_window_commit`, run window after window by :89 `windowed_sweep`
// (and :131 `sweep_expired`, which is one window of the whole capacity),
// and the same two programs over the sharded engine's [n_sh, shard_cap]
// state (gubernator_tpu/parallel/sharded_engine.py:727 `sweep`), whose
// scan runs along the last axis, so a window [start, start + window)
// covers that range of every shard.  Over a window a slot is freed when
// meta bit 0 (occupied) is set and its expiry, the 64-bit pair
// (hi2 & 0x7FF, expire_lo), is below `now`; the pair compares as the
// reference's does, hi word signed, low word UNSIGNED (expire_lo holds a
// uint32 as its int32 bit pattern, and a signed compare would free the
// wrong slots whenever bit 31 is set).  Freed slots get meta bit 0 cleared
// in place.  Output, int32 [n_windows, n_sh, window + 1]: each row
// (window w, shard sh) holds the count, then the window-local indices of
// the freed slots in ascending order (the stable compaction the reference
// gets from `argsort(~freed, stable=True)`); what follows is unspecified.
// The result is that of the windows run one after another: a row frees
// only the slots of its window that no earlier row of the launch covers
// (`own_lo` / `own_hi`, from the host), since with one `now` an earlier
// row has already freed every expired occupied slot of the overlap.  The
// plain PyTorch version is gubernator_tpu_torch/ops/expiry.py
// `sweep_windows_reference`.
//
// Bound: bytes.  12 B read per owned slot (meta, hi2, expire_lo), 8 B per
// freed slot (its index and its meta word) and 4 B a row's count: 1.5 MB
// for a 2^17-slot window, 0.47 us at 3.35 TB/s, times the windows and
// shards of the launch.  The old design paid three device operations a
// window (a memset of ticket counters, a count pass that ended in one
// block scanning every tile count, a scatter pass) and one launch pair a
// window; each small launch sits on a floor of 2-3 us.  This design:
//
//   * One launch a group of up to kMaxWindows windows, one pass, no
//     memset.  The grid is windows x shards x tiles; a tile is kThreads
//     threads of Q 16-byte quads each (Q = 1, 2, 4 or 8: 512 to 4096
//     slots), the largest Q that leaves the launch 512 blocks or more
//     (ops/expiry.py `tile_quads`): a lone 2^17 window gets 256 blocks of
//     512 slots for the 132 SMs, a group of 16 windows 512 of 4096, and
//     fewer, larger tiles mean fewer tickets and shorter look-backs.
//   * Decoupled look-back.  A block takes its tile by a ticket (atomicAdd
//     on word 0 of `pub`, a buffer the host keeps per device and stream),
//     so tickets run in row-major order of (window, shard, tile) and a
//     tile's predecessors hold smaller tickets and are already running.
//     It publishes its count, then its inclusive prefix, as one 64-bit
//     word (stamp, inclusive flag, value) that needs no fence; it waits
//     only on the tiles before it in its own row, reading 32 of them at
//     once with warp 0.  The ticket counter runs on from launch to launch
//     and every launch has a stamp its buffer never saw, so nothing is
//     zeroed between launches.  A wait that times out traps: it is never
//     read as stale data.
//   * 16-byte loads (int4) of the three columns, all of a thread's issued
//     before the first compare, a warp's 512 contiguous bytes a column at
//     a time, with a scalar head and tail where a row's first slot is not
//     16-byte aligned (a window start, or a shard stride, not a multiple
//     of 4).
//   * The freed slots' meta words are stored from the loaded word (no
//     second read), and their indices go straight to their ranks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;                     // 4 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kTileSlots = kThreads * 4;          // slots of a tile of one quad a thread
constexpr int kMaxWindows = 16;                   // windows a launch
constexpr int32_t kHi11 = 0x7FF;
// Polls of a predecessor's word before the wait traps (each an L2 round
// trip and a 32 ns sleep: far longer than any running block takes).
constexpr int kSpinLimit = 1 << 20;

// What a launch sweeps: window w is [start[w], start[w] + window) of
// every shard, of which it owns (frees in) the window-local range
// [own_lo[w], own_hi[w]).
struct Windows {
  long long start[kMaxWindows];
  int own_lo[kMaxWindows];
  int own_hi[kMaxWindows];
};

// A tile's published word: stamp (31 bits), inclusive flag, value.
__device__ __forceinline__ unsigned long long tile_word(unsigned int stamp, bool inclusive,
                                                        int value) {
  return (unsigned long long)(stamp * 2u + (inclusive ? 1u : 0u)) << 32 | (unsigned int)value;
}
__device__ __forceinline__ void publish(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ unsigned long long peek(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ bool expired(int32_t m, int32_t h, int32_t e, int32_t now_hi,
                                        uint32_t now_lo) {
  const int32_t ehi = h & kHi11;
  const uint32_t elo = static_cast<uint32_t>(e);
  return (m & 1) && (ehi < now_hi || (ehi == now_hi && elo < now_lo));
}

// Grid: one block a tile, n_windows * n_sh * tiles_per_row of them; a
// tile is kThreads * 4 * Q slots, warp w's share the Q runs of 128 slots
// from w * 128 * Q, lane l the quad at 4 * l of each run (so a warp's
// loads are 512 contiguous bytes a column).  Shard sh's columns start at
// sh * stride; row (w, sh) of `out` at (w * n_sh + sh) * (window + 1).
// `vec`: the three columns share their 16-byte alignment, so the int4
// loads may be used.  `silent_tile`: a ticket that publishes nothing, so
// that a test can show the wait traps (-1 in every real launch).
template <int Q>
__global__ void __launch_bounds__(kThreads)
sweep_group_kernel(int32_t* meta, const int32_t* __restrict__ hi2,
                   const int32_t* __restrict__ expire_lo, long long stride, int n_sh,
                   long long window, long long tiles_per_row, int vec, int32_t now_hi,
                   uint32_t now_lo, const Windows win, unsigned long long* pub,
                   unsigned long long tiles_before, unsigned int stamp, long long silent_tile,
                   int32_t* __restrict__ out) {
  constexpr int kTile = kThreads * 4 * Q;
  __shared__ long long s_ticket;
  __shared__ int s_warp[kWarps];
  __shared__ int s_before;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    // `tiles_before` tickets were taken from this counter by earlier
    // launches, so this launch's run from there.
    const unsigned long long k = atomicAdd(pub, 1ULL) - tiles_before;
    if (k >= gridDim.x) __trap();
    s_ticket = static_cast<long long>(k);
  }
  __syncthreads();
  const long long k = s_ticket;
  const long long row = k / tiles_per_row;
  const long long tile = k - row * tiles_per_row;
  const int w = static_cast<int>(row / n_sh);
  const long long base = (row - static_cast<long long>(w) * n_sh) * stride + win.start[w];
  const int lo = win.own_lo[w], hi = win.own_hi[w];
  // Slots before the row's first 16-byte boundary: tiles start there.
  const int head = vec ? static_cast<int>((reinterpret_cast<uintptr_t>(meta) / 4 + base) & 3)
                       : 0;
  // Window-local index of this thread's first slot in run 0.
  const long long i00 = tile * kTile + static_cast<long long>(warp) * 128 * Q + 4 * lane - head;

  // All the loads first, then the compares (bit 4q + j: slot i00 + 128q + j).
  int32_t m[Q][4], h[Q][4], e[Q][4];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const long long i0 = i00 + 128 * q;
#pragma unroll
    for (int j = 0; j < 4; ++j) m[q][j] = h[q][j] = e[q][j] = 0;
    if (i0 >= hi || i0 + 3 < lo) continue;
    if (vec && i0 >= 0 && i0 + 3 < window) {
      const int4 mv = *reinterpret_cast<const int4*>(meta + base + i0);
      const int4 hv = __ldg(reinterpret_cast<const int4*>(hi2 + base + i0));
      const int4 ev = __ldg(reinterpret_cast<const int4*>(expire_lo + base + i0));
      m[q][0] = mv.x, m[q][1] = mv.y, m[q][2] = mv.z, m[q][3] = mv.w;
      h[q][0] = hv.x, h[q][1] = hv.y, h[q][2] = hv.z, h[q][3] = hv.w;
      e[q][0] = ev.x, e[q][1] = ev.y, e[q][2] = ev.z, e[q][3] = ev.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long i = i0 + j;
        if (i >= lo && i < hi) {
          m[q][j] = meta[base + i];
          h[q][j] = __ldg(hi2 + base + i);
          e[q][j] = __ldg(expire_lo + base + i);
        }
      }
    }
  }
  unsigned int bits = 0;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = i00 + 128 * q + j;
      if (i >= lo && i < hi && expired(m[q][j], h[q][j], e[q][j], now_hi, now_lo)) {
        bits |= 1u << (4 * q + j);
        meta[base + i] = m[q][j] & ~1;
      }
    }
  }

  // Ranks within the warp, run by run (slot order is run, lane, j), then
  // the warps' totals over the block.
  int rank[Q];
  int in_warp = 0;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int c = __popc((bits >> (4 * q)) & 0xFu);
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += o;
    }
    rank[q] = in_warp + incl - c;
    in_warp += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) s_warp[warp] = in_warp;
  __syncthreads();
  int total = 0, warp_before = 0;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    const int t = s_warp[v];
    total += t;
    if (v < warp) warp_before += t;
  }

  // The tiles before this one in its row: warp 0 looks back.
  if (warp == 0) {
    unsigned long long* const words = pub + 1;
    const bool speaks = k != silent_tile;
    int before = 0;
    if (tile == 0) {
      if (lane == 0 && speaks) publish(words + k, tile_word(stamp, true, total));
    } else {
      if (lane == 0 && speaks) publish(words + k, tile_word(stamp, false, total));
      const long long first = k - tile;  // the row's first tile: always inclusive
      for (long long p0 = k - 1;; p0 -= 32) {
        const long long p = p0 - lane;
        const bool in = p >= first;
        unsigned long long v = 0;
        if (in) {
          for (int spin = 0; ((v = peek(words + p)) >> 33) != stamp; ++spin) {
            if (spin == kSpinLimit) __trap();  // no predecessor published: fail, never guess
            __nanosleep(32);
          }
        }
        // Sum back to the nearest inclusive prefix (the lowest lane that
        // has one), or over all 32 and go on.
        const unsigned int stops = __ballot_sync(0xffffffffu, in && ((v >> 32) & 1));
        const int last = stops ? __ffs(stops) - 1 : 31;
        int val = in && lane <= last ? static_cast<int>(static_cast<unsigned int>(v)) : 0;
#pragma unroll
        for (int d = 16; d; d >>= 1) val += __shfl_xor_sync(0xffffffffu, val, d);
        before += val;
        if (stops) break;
      }
      if (lane == 0 && speaks) publish(words + k, tile_word(stamp, true, before + total));
    }
    if (lane == 0) s_before = before;
  }
  __syncthreads();
  const int before = s_before + warp_before;
  int32_t* const orow = out + row * (window + 1);
  if (tid == 0 && tile == tiles_per_row - 1) orow[0] = s_before + total;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    int r = 1 + before + rank[q];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if ((bits >> (4 * q + j)) & 1u) orow[r++] = static_cast<int32_t>(i00 + 128 * q + j);
  }
}

}  // namespace

// Slots of a tile of one quad a thread; a launch takes 1, 2, 4 or 8.
extern "C" int guber_sweep_tile_slots() { return kTileSlots; }

// meta, hi2, expire_lo: int32 [n_sh * stride] on the device, shard sh's
// columns at sh * stride; starts / own_lo / own_hi: host arrays of
// n_windows (1..kMaxWindows) entries, each window [start, start + window)
// inside [0, stride), each owned range inside [0, window); out: int32
// [n_windows, n_sh, window + 1]; pub: the stream's publish buffer, int64
// [1 + n_windows * n_sh * tiles_per_row] at least, word 0 its ticket
// counter, from which `tiles_before` tickets were taken; stamp: 1 .. 2^31
// - 1, never used before with this buffer.  Returns the launch's CUDA
// error.
extern "C" int guber_sweep_windows(void* meta, const void* hi2, const void* expire_lo, int n_sh,
                                   long long stride, int n_windows, const long long* starts,
                                   const int* own_lo, const int* own_hi, long long window,
                                   long long tiles_per_row, int quads, int vec, long long now_ms,
                                   void* pub,
                                   unsigned long long tiles_before, unsigned int stamp,
                                   long long silent_tile, void* out, void* stream) {
  const long long blocks = static_cast<long long>(n_windows) * n_sh * tiles_per_row;
  if (n_windows < 1 || n_windows > kMaxWindows || n_sh < 1 || tiles_per_row < 1 ||
      (quads != 1 && quads != 2 && quads != 4 && quads != 8) ||
      blocks > 0x7fffffffLL || window < 1 || window >= 0x7fffffffLL || stamp == 0 ||
      stamp >= 0x80000000u)
    return static_cast<int>(cudaErrorInvalidValue);
  Windows win{};
  for (int w = 0; w < n_windows; ++w) {
    win.start[w] = starts[w];
    win.own_lo[w] = own_lo[w];
    win.own_hi[w] = own_hi[w];
  }
  const int32_t now_hi = static_cast<int32_t>(now_ms >> 32);
  const uint32_t now_lo = static_cast<uint32_t>(now_ms & 0xFFFFFFFFLL);
  auto kernel = quads == 8   ? sweep_group_kernel<8>
                : quads == 4 ? sweep_group_kernel<4>
                : quads == 2 ? sweep_group_kernel<2>
                             : sweep_group_kernel<1>;
  kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(meta), static_cast<const int32_t*>(hi2),
      static_cast<const int32_t*>(expire_lo), stride, n_sh, window, tiles_per_row, vec, now_hi,
      now_lo, win, static_cast<unsigned long long*>(pub), tiles_before, stamp, silent_tile,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
