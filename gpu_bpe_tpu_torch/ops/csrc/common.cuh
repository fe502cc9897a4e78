// Shared definitions of the training kernels (sm_90a, plain C entry points).
//
// Storage conventions, fixed by the Python wrappers in ops/kernels.py:
//   * symbols and weights are int32 arrays; a symbol is tok | WS_BIT with
//     tok < 2^16, read here as uint32_t;
//   * pair ids, window slots, counts and every scalar are int64 tensors on
//     the device; pair ids hold the unsigned 32-bit value and are cast to
//     uint32_t here, so the winner order is the unsigned one;
//   * counts, probe counts and histogram masses are summed in 64-bit
//     integers and never pass through floats or tensor cores.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bpe {

constexpr uint32_t TOKEN_MASK = 0xFFFFu;
constexpr uint32_t WS_BIT = 0x10000u;
constexpr int W_SLOTS = 256;   // candidate window: K_CANDIDATES + S_CREATED
constexpr int N_PROBES = 64;   // fused probe-pair slots
constexpr int NBINS = 256;     // 16 x 16 created-pair hash bins
constexpr int TILE = 1024;     // stream elements per block (one per thread)

// (tok * 2654435761) >> 16 & 255 in wrapping u32 arithmetic: the bin of a
// 16-bit token (row = h >> 4, column = h & 15 of the [16, 16] histogram).
__device__ __forceinline__ int bin_of(uint32_t tok) {
    return (int)(((tok * 2654435761u) >> 16) & (uint32_t)(NBINS - 1));
}

__device__ __forceinline__ uint32_t as_u32(long long v) { return (uint32_t)(unsigned long long)v; }

// Exclusive prefix sum of one int per thread over a block of blockDim.x
// (a multiple of 32, at most 1024) threads. Returns the block total in
// *total. Uses shared memory of 32 ints.
__device__ __forceinline__ int block_exclusive_scan(int x, int* total) {
    __shared__ int warp_sums[32];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    int inc = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        int y = __shfl_up_sync(0xFFFFFFFFu, inc, d);
        if (lane >= d) inc += y;
    }
    if (lane == 31) warp_sums[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        int s = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            int y = __shfl_up_sync(0xFFFFFFFFu, s, d);
            if (lane >= d) s += y;
        }
        warp_sums[lane] = s;  // inclusive over warps
    }
    __syncthreads();
    const int before = warp == 0 ? 0 : warp_sums[warp - 1];
    *total = warp_sums[nwarps - 1];
    __syncthreads();  // warp_sums may be reused by the next call
    return before + inc - x;
}

// Run by ONE block: exclusive prefix sum, in place, of `count` per-block
// counts (each at most TILE), so that words[b] becomes the output offset
// of block b. Returns the total to every thread.
__device__ __forceinline__ long long scan_block_counts(long long* words, long long count) {
    long long carry = 0;
    for (long long base = 0; base < count; base += blockDim.x) {
        const long long i = base + threadIdx.x;
        const int x = i < count ? (int)words[i] : 0;
        int tot;
        const int ex = block_exclusive_scan(x, &tot);
        if (i < count) words[i] = carry + ex;
        carry += tot;
    }
    return carry;
}

// ── Decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", NVIDIA 2016), shared by the one-pass
// compactions (compact_mask.cu, merge_compact_tracked.cu). Tile ids come
// from an atomic counter, so a tile that waits on a predecessor was
// scheduled after it. Each tile publishes a 64-bit status word: the flag in
// the top two bits, the value below them, in one store.
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr unsigned long long ST_COUNT = 1ull << 62;   // value = this tile's count
constexpr unsigned long long ST_PREFIX = 1ull << 63;  // value = count of tiles 0..this one
constexpr unsigned long long ST_VALUE = (1ull << 62) - 1;

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
    return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
    *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// Exclusive prefix of tile `tile` > 0, run by one full warp. Lane i reads
// the status of tile `pred - i` of the current window of 32 predecessors,
// the window waits until all of them have published, the counts are summed
// down to the nearest published prefix (inclusive), and the search ends
// there or moves 32 tiles back. Tiles before 0 read as a prefix of 0.
__device__ inline unsigned long long look_back(const unsigned long long* status, long long tile, int lane) {
    unsigned long long excl = 0;
    for (long long pred = tile - 1 - lane;; pred -= 32) {
        unsigned long long s;
        do {
            s = pred >= 0 ? load_status(status + pred) : ST_PREFIX;
        } while (__any_sync(FULL_MASK, s == 0));
        const unsigned prefixes = __ballot_sync(FULL_MASK, (s & ST_PREFIX) != 0);
        const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
        unsigned long long v = lane <= stop ? (s & ST_VALUE) : 0;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL_MASK, v, d);
        excl += v;
        if (prefixes) return excl;
    }
}

// Run by warp 0 of a tile of 32 (load, warp) groups: exclusive scan, in
// place, of the 32 group counts in `group_off`; lane 31 stores the tile's
// count in *count and publishes it in the tile's status word (as a prefix
// for tile 0).
__device__ __forceinline__ void scan_and_publish(int* group_off, unsigned long long* status, long long tile,
                                                 int lane, int* count) {
    const int x = group_off[lane];
    int inc = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL_MASK, inc, d);
        if (lane >= d) inc += y;
    }
    group_off[lane] = inc - x;
    if (lane == 31) {
        *count = inc;
        store_status(status + tile, (tile == 0 ? ST_PREFIX : ST_COUNT) | (unsigned long long)inc);
    }
}

}  // namespace bpe
