// count_pairs2: exact pair-stream counts of two pairs on a hole-free stream.
//
// Replaces the TPU kernel `_count_pairs_kernel` of
// gpu_bpe_tpu/ops/pallas_kernels.py:641 (public entry `count_pairs2`,
// pallas_kernels.py:693).
//
// Pair (p, p+1) adds w[p] iff p < n-1, the successor lacks the word-start
// bit and neither token is 0 (ops/train_step.py `_masked_pairs`), so pair
// id 0 and pairs with a zero member count nothing.
//
// Bound on this card: bytes, one read of symbols and weights over the live
// stream (8 B per symbol, ~7 MB at n = 0.9 M: ~2 us at 3.35 TB/s).
//
// Design: the TPU kernel carried running sums across a sequential grid in
// SMEM and patched the next-block halo. Here one launch does everything: a
// grid-stride loop reads symbols and weights as 16-byte vectors (the p+1
// neighbour of a vector's last entry is one edge read, an L1 hit), each
// thread sums in 64-bit integers, a warp-shuffle and shared-memory
// reduction gives each block's sums, which it adds into two words of the
// caller's scratch; the last block, found by a ticket counter, moves them
// to out[2] and zeroes the scratch. No output is zeroed beforehand, so a
// call is one kernel and no fill. The loads of a thread's first vector do
// not wait for n: vectors are bounded by the capacity.
#include "common.cuh"

using namespace bpe;

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;
constexpr int MAX_BLOCKS = 132 * 4;  // four blocks per SM, grid-stride beyond
constexpr int WARPS = THREADS / 32;

// scratch layout (int64 words), zero between calls: the ticket and the two
// sums
constexpr int SC_TICKET = 0;
constexpr int SC_SUM = 1;

__device__ __forceinline__ void count_one(uint32_t self, uint32_t nxt, int w, uint32_t p1, uint32_t p2,
                                          long long& s1, long long& s2) {
    const uint32_t st = self & TOKEN_MASK, nt = nxt & TOKEN_MASK;
    if ((nxt & WS_BIT) != 0u || st == 0u || nt == 0u) return;
    const uint32_t pr = (st << 16) | nt;
    if (pr == p1) s1 += w;
    if (pr == p2) s2 += w;
}

__global__ void __launch_bounds__(THREADS)
count_pairs2_kernel(const uint32_t* __restrict__ sym, const int* __restrict__ w, long long cap, const long long* n_p,
                    const long long* p1_p, const long long* p2_p, long long* out, long long* scratch) {
    const long long n = min(*n_p, cap);
    const uint32_t p1 = as_u32(*p1_p), p2 = as_u32(*p2_p);
    const bool aligned = ((reinterpret_cast<unsigned long long>(sym) | reinterpret_cast<unsigned long long>(w)) & 15) == 0;
    long long s1 = 0, s2 = 0;
    const long long pairs = n - 1;  // pair p for p in [0, n - 1)
    // vectors are bounded by the capacity, so their loads need not wait for
    // n; a thread stops at its first vector past the live stream
    const long long nfull = cap / VEC;
    const long long stride = (long long)gridDim.x * THREADS;
    for (long long vi = (long long)blockIdx.x * THREADS + threadIdx.x; vi < nfull; vi += stride) {
        const long long p = vi * VEC;
        uint32_t s[VEC + 1];
        int ww[VEC];
        if (aligned) {
            const uint4 x = __ldg(reinterpret_cast<const uint4*>(sym + p));
            const int4 y = __ldg(reinterpret_cast<const int4*>(w + p));
            s[0] = x.x, s[1] = x.y, s[2] = x.z, s[3] = x.w;
            ww[0] = y.x, ww[1] = y.y, ww[2] = y.z, ww[3] = y.w;
        } else {
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
                s[k] = __ldg(sym + p + k);
                ww[k] = __ldg(w + p + k);
            }
        }
        s[VEC] = p + VEC < cap ? __ldg(sym + p + VEC) : 0u;  // the p+1 neighbour of the last entry
        if (p >= pairs) break;
#pragma unroll
        for (int k = 0; k < VEC; ++k)
            if (p + k < pairs) count_one(s[k], s[k + 1], ww[k], p1, p2, s1, s2);
    }
    if (blockIdx.x == 0 && threadIdx.x == 0)  // the last cap % VEC entries
        for (long long q = nfull * VEC; q < pairs; ++q) count_one(sym[q], sym[q + 1], w[q], p1, p2, s1, s2);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
        s1 += __shfl_down_sync(FULL_MASK, s1, d);
        s2 += __shfl_down_sync(FULL_MASK, s2, d);
    }
    __shared__ long long red[2][WARPS];
    __shared__ int s_last;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
        red[0][warp] = s1;
        red[1][warp] = s2;
    }
    __syncthreads();
    auto* words = reinterpret_cast<unsigned long long*>(scratch);
    if (threadIdx.x == 0) {
        long long b1 = 0, b2 = 0;
        for (int i = 0; i < WARPS; ++i) {
            b1 += red[0][i];
            b2 += red[1][i];
        }
        if (b1) atomicAdd(&words[SC_SUM], (unsigned long long)b1);
        if (b2) atomicAdd(&words[SC_SUM + 1], (unsigned long long)b2);
        __threadfence();  // the sums are in before the ticket
        s_last = atomicAdd(&words[SC_TICKET], 1ull) == gridDim.x - 1;
    }
    __syncthreads();
    if (!s_last) return;

    // the last block: every block's sums are in; hand them out and leave
    // the scratch zeroed
    if (threadIdx.x == 0) {
        __threadfence();
        out[0] = (long long)atomicExch(&words[SC_SUM], 0ull);
        out[1] = (long long)atomicExch(&words[SC_SUM + 1], 0ull);
        words[SC_TICKET] = 0;
    }
}

long long blocks_for(long long cap) {
    long long blocks = (cap + THREADS * VEC - 1) / (THREADS * VEC);
    if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
    return blocks < 1 ? 1 : blocks;
}

}  // namespace

// Scratch words (int64) of a call: the ticket and the two sums. Zeroed by
// the caller once; the kernel leaves it clean.
extern "C" long long cp_scratch_words() { return SC_SUM + 2; }

extern "C" int count_pairs2(const int* sym, const int* w, long long cap, const long long* n,
                            const long long* pair1, const long long* pair2, long long* out,
                            long long* scratch, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    count_pairs2_kernel<<<(unsigned)blocks_for(cap), THREADS, 0, s>>>(reinterpret_cast<const uint32_t*>(sym), w,
                                                                        cap, n, pair1, pair2, out, scratch);
    return (int)cudaGetLastError();
}
