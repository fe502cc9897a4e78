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
// SMEM and patched the next-block halo. Here a grid-stride loop reads p and
// p+1 straight from global memory, each thread sums in 64-bit integers, a
// warp-shuffle and shared-memory reduction gives the block sums, and one
// 64-bit atomic per block and pair adds them to the output, which the
// wrapper zeroes.
#include "common.cuh"

using namespace bpe;

namespace {

constexpr int THREADS = 256;

__global__ void count_pairs2_kernel(const int* sym, const int* w, long long cap, const long long* n_p,
                                    const long long* p1_p, const long long* p2_p, long long* out) {
    const long long n = min(*n_p, cap);
    const uint32_t p1 = as_u32(*p1_p), p2 = as_u32(*p2_p);
    long long s1 = 0, s2 = 0;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < n - 1; p += stride) {
        const uint32_t self = (uint32_t)sym[p], nxt = (uint32_t)sym[p + 1];
        const uint32_t st = self & TOKEN_MASK, nt = nxt & TOKEN_MASK;
        if ((nxt & WS_BIT) != 0u || st == 0u || nt == 0u) continue;
        const uint32_t pr = (st << 16) | nt;
        if (pr == p1) s1 += w[p];
        if (pr == p2) s2 += w[p];
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
        s1 += __shfl_down_sync(0xFFFFFFFFu, s1, d);
        s2 += __shfl_down_sync(0xFFFFFFFFu, s2, d);
    }
    __shared__ long long red[2][THREADS / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
        red[0][warp] = s1;
        red[1][warp] = s2;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        long long b1 = 0, b2 = 0;
        for (int i = 0; i < THREADS / 32; ++i) {
            b1 += red[0][i];
            b2 += red[1][i];
        }
        unsigned long long* o = reinterpret_cast<unsigned long long*>(out);
        if (b1) atomicAdd(&o[0], (unsigned long long)b1);
        if (b2) atomicAdd(&o[1], (unsigned long long)b2);
    }
}

}  // namespace

extern "C" int count_pairs2(const int* sym, const int* w, long long cap, const long long* n,
                            const long long* pair1, const long long* pair2, long long* out,
                            void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    long long blocks = (cap + THREADS - 1) / THREADS;
    if (blocks > 132 * 8) blocks = 132 * 8;  // eight blocks per SM, grid-stride beyond
    if (blocks < 1) blocks = 1;
    count_pairs2_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(sym, w, cap, n, pair1, pair2, out);
    return (int)cudaGetLastError();
}
