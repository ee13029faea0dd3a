// K6 and K13: the expiry sweep of one window, for Hopper (sm_90a); K13
// sweeps the same window of every shard of a sharded state in one launch
// pair.
//
// Replaces gubernator_tpu/ops/expiry.py:40 `sweep_window_scan` and :78
// `sweep_window_commit` (and :131 `sweep_expired`, which is one window of
// the whole capacity).  Over the window [start, start + window) a slot is
// freed when meta bit 0 (occupied) is set and its expiry, the 64-bit pair
// (hi2 & 0x7FF, expire_lo), is below `now`; the pair compares as the
// reference's does, hi word signed, low word UNSIGNED (expire_lo holds a
// uint32 as its int32 bit pattern, and a signed compare would free the
// wrong slots whenever bit 31 is set).  Freed slots get meta bit 0 cleared
// in place.  Output `out`, int32 [window + 1]: out[0] the count, then the
// window-local indices of the freed slots in ascending order (the stable
// compaction the reference gets from `argsort(~freed, stable=True)`).
// The plain PyTorch version is gubernator_tpu_torch/ops/expiry.py
// `sweep_window_reference`.
//
// Two launches per window (the reference's scan / commit split exists only
// for XLA's buffer donation; here the commit is fused into the scatter):
//
//   count:   one block of 32 warps per tile of kTileSlots slots.  Each warp
//            reads 32 consecutive slots at a time (coalesced) and keeps
//            the freed flags as one ballot word; the block writes its
//            words and its count.  The last block to finish (a ticket
//            counter, zeroed by the launcher) scans the tile counts into
//            tile offsets and writes the total to out[0].
//   scatter: one block per tile again.  A block-wide exclusive scan of
//            the tile's word popcounts, plus the tile's offset, places
//            each word; then each warp takes the same words its count
//            warp took, lane l bit l, and every freed lane writes its
//            index at its rank (ascending) and clears its meta bit, so the
//            writes of a word are one coalesced store each.
//
// K13 replaces the same two programs over the sharded engine's
// [n_sh, shard_cap] state (gubernator_tpu/parallel/sharded_engine.py:727
// `sweep`): the reference's scan runs along the last axis, so one window
// [start, start + window) covers that range of every shard, and gives
// each shard's freed count and compacted indices.  The kernels are K6's
// with the shard as the grid's y index: shard sh reads its columns at
// sh * shard_cap, writes its output row (int32 [n_sh, window + 1], each
// row laid out as K6's `out`) and keeps its own ballot words, tile counts
// and ticket counter, so its last block scans its own tiles only.  K6 is
// K13 with one shard.  The plain version is `shard_sweep_window_reference`.
//
// Bound: bytes.  12 B read per slot of the window (meta, hi2, expire_lo),
// 8 B per freed slot (its index and its meta word) and the 4 B count;
// 1.5 MB for a 2^17-slot window, 0.47 us at 3.35 TB/s (times n_sh in
// K13).  What this design
// adds: the ballot words (1/8 B per slot, written and read back), the
// freed slots' meta words read again, and a second launch.  A decoupled
// look-back scan could make it one launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;                       // 32 warps a block
constexpr int kWordsPerWarp = 4;                     // ballot words per warp
constexpr int kTileWords = kThreads / 32 * kWordsPerWarp;  // 128 words
constexpr int kTileSlots = kTileWords * 32;          // 4096 slots per tile
constexpr int32_t kHi11 = 0x7FF;

// The three words are loaded whatever meta says: no load waits on another.
__device__ __forceinline__ bool expired(const int32_t* __restrict__ meta,
                                        const int32_t* __restrict__ hi2,
                                        const int32_t* __restrict__ expire_lo, long long s,
                                        int32_t now_hi, uint32_t now_lo) {
  const int32_t m = __ldg(meta + s);
  const int32_t ehi = __ldg(hi2 + s) & kHi11;
  const uint32_t elo = static_cast<uint32_t>(__ldg(expire_lo + s));
  return (m & 1) && (ehi < now_hi || (ehi == now_hi && elo < now_lo));
}

// Exclusive prefix of `v` over the block (blockDim.x a multiple of 32, at
// most 1024); `total` gets the block's sum.  `warp_sums` holds 32 ints.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += o;
    }
    if (lane < n_warps) warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  total = warp_sums[n_warps - 1];
  const int before = warp == 0 ? 0 : warp_sums[warp - 1];
  __syncthreads();  // warp_sums may be reused by the caller
  return before + incl - v;
}

// The scratch of a launch: one ticket counter a shard, then each shard's
// ballot words and tile counts.
struct Scratch {
  unsigned int* done;    // [n_sh]
  uint32_t* ballots;     // this shard's [tiles * kTileWords]
  int32_t* tile_counts;  // this shard's [tiles]
};

__device__ __forceinline__ Scratch shard_scratch(int32_t* scratch, int n_sh, int sh, int tiles) {
  const size_t per = (size_t)tiles * kTileWords + tiles;
  uint32_t* ballots = reinterpret_cast<uint32_t*>(scratch + n_sh + (size_t)sh * per);
  return {reinterpret_cast<unsigned int*>(scratch) + sh, ballots,
          reinterpret_cast<int32_t*>(ballots + (size_t)tiles * kTileWords)};
}

// Grid (tiles, n_sh): shard blockIdx.y's columns start at blockIdx.y *
// stride, its output row at blockIdx.y * (window + 1).
__global__ void __launch_bounds__(kThreads)
sweep_count_kernel(const int32_t* __restrict__ meta, const int32_t* __restrict__ hi2,
                   const int32_t* __restrict__ expire_lo, long long stride, long long start,
                   long long window, int32_t now_hi, uint32_t now_lo, int32_t* scratch,
                   int32_t* out) {
  __shared__ int warp_sums[32];
  __shared__ bool is_last;
  const int sh = (int)blockIdx.y;
  const Scratch sc = shard_scratch(scratch, (int)gridDim.y, sh, (int)gridDim.x);
  uint32_t* __restrict__ ballots = sc.ballots;
  int32_t* tile_counts = sc.tile_counts;
  unsigned int* done = sc.done;
  meta += sh * stride;
  hi2 += sh * stride;
  expire_lo += sh * stride;
  out += sh * (window + 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long word0 = (long long)blockIdx.x * kTileWords + warp * kWordsPerWarp;
  int count = 0;
#pragma unroll
  for (int w = 0; w < kWordsPerWarp; ++w) {
    const long long i = (word0 + w) * 32 + lane;  // window-local slot
    const bool f = i < window && expired(meta, hi2, expire_lo, start + i, now_hi, now_lo);
    const unsigned int b = __ballot_sync(0xffffffffu, f);
    if (lane == 0) ballots[word0 + w] = b;
    count += __popc(b);
  }
  if (lane == 0) warp_sums[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int k = 0; k < kThreads / 32; ++k) t += warp_sums[k];
    tile_counts[blockIdx.x] = t;
    __threadfence();  // the count is visible before the ticket is taken
    is_last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;

  // The last block: tile counts → exclusive tile offsets, in place.
  __threadfence();
  const int n_tiles = gridDim.x;
  const int per = (n_tiles + kThreads - 1) / kThreads;
  const int lo = min(n_tiles, (int)threadIdx.x * per), hi = min(n_tiles, lo + per);
  int mine = 0;
  for (int k = lo; k < hi; ++k) mine += __ldcg(tile_counts + k);
  int total;
  int run = block_exclusive_scan(mine, warp_sums, total);
  for (int k = lo; k < hi; ++k) {
    const int c = __ldcg(tile_counts + k);
    tile_counts[k] = run;
    run += c;
  }
  if (threadIdx.x == 0) {
    out[0] = total;
    *done = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
sweep_scatter_kernel(int32_t* __restrict__ meta, long long stride, long long start,
                     long long window, int32_t* scratch, int32_t* __restrict__ out) {
  const int sh = (int)blockIdx.y;
  const Scratch sc = shard_scratch(scratch, (int)gridDim.y, sh, (int)gridDim.x);
  const uint32_t* __restrict__ ballots = sc.ballots;
  const int32_t* __restrict__ tile_offsets = sc.tile_counts;
  meta += sh * stride;
  out += sh * (window + 1);
  __shared__ int warp_sums[32];
  __shared__ unsigned int s_bits[kTileWords];
  __shared__ int s_base[kTileWords];
  const long long tile_word0 = (long long)blockIdx.x * kTileWords;
  const int t = threadIdx.x;
  const unsigned int b = t < kTileWords ? ballots[tile_word0 + t] : 0u;
  int total;
  const int excl = block_exclusive_scan(__popc(b), warp_sums, total);
  if (t < kTileWords) {
    s_bits[t] = b;
    s_base[t] = tile_offsets[blockIdx.x] + excl;
  }
  __syncthreads();
  if (total == 0) return;
  const int lane = t & 31, warp = t >> 5;
  const unsigned int below = (1u << lane) - 1u;  // lanes under this one
#pragma unroll
  for (int w = 0; w < kWordsPerWarp; ++w) {
    const int j = warp * kWordsPerWarp + w;
    const unsigned int bits = s_bits[j];
    if ((bits >> lane) & 1u) {
      const long long i = (tile_word0 + j) * 32 + lane;  // window-local slot
      out[1 + s_base[j] + __popc(bits & below)] = static_cast<int32_t>(i);
      meta[start + i] &= ~1;
    }
  }
}

}  // namespace

// The scratch the launcher needs, in int32 words, for a window of
// `window` slots over n_sh shards: a ticket counter a shard, then each
// shard's ballot words and tile counts.
extern "C" long long guber_shard_sweep_scratch_words(int n_sh, long long window) {
  const long long tiles = (window + kTileSlots - 1) / kTileSlots;
  return n_sh + n_sh * (tiles * kTileWords + tiles);
}

extern "C" long long guber_sweep_scratch_words(long long window) {
  return guber_shard_sweep_scratch_words(1, window);
}

// meta, hi2, expire_lo: int32 [n_sh * stride] on the device, shard sh's
// columns at sh * stride; the window [start, start + window) lies in
// [0, stride), window >= 1; now_ms the sweep's instant; out: int32
// [n_sh, window + 1]; scratch: int32
// [guber_shard_sweep_scratch_words(n_sh, window)].  Returns the first CUDA
// error of the memset and the two launches.
extern "C" int guber_shard_sweep_window(void* meta, const void* hi2, const void* expire_lo,
                                        int n_sh, long long stride, long long start,
                                        long long window, long long now_ms, void* out,
                                        void* scratch, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (window + kTileSlots - 1) / kTileSlots;
  if (tiles > 0x7fffffffLL || n_sh < 1 || n_sh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)n_sh * sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int32_t now_hi = static_cast<int32_t>(now_ms >> 32);
  const uint32_t now_lo = static_cast<uint32_t>(now_ms & 0xFFFFFFFFLL);
  const dim3 grid((unsigned)tiles, (unsigned)n_sh);
  sweep_count_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int32_t*>(meta), static_cast<const int32_t*>(hi2),
      static_cast<const int32_t*>(expire_lo), stride, start, window, now_hi, now_lo,
      static_cast<int32_t*>(scratch), static_cast<int32_t*>(out));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sweep_scatter_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<int32_t*>(meta), stride, start, window, static_cast<int32_t*>(scratch),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K6: one window of one state (meta, hi2, expire_lo int32 [cap]); out
// int32 [window + 1]; scratch int32 [guber_sweep_scratch_words(window)].
extern "C" int guber_sweep_window(void* meta, const void* hi2, const void* expire_lo,
                                  long long start, long long window, long long now_ms,
                                  void* out, void* scratch, void* stream) {
  return guber_shard_sweep_window(meta, hi2, expire_lo, 1, 0, start, window, now_ms, out,
                                  scratch, stream);
}
