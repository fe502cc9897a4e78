// bitonic_rounds: R compare-exchange rounds of a bitonic network over rows
// of 128 keys of three u32 words.
//
// Replaces the TPU kernel `kernel` of scripts/microbench_bitonic.py:44
// (pallas_call :78, in `main`), round for round: in round r the stride is
// j = 1 << (r % 7) (1 to 64, inside a row) and the direction bit is
// k = 1 << (7 + r % 10). Element e of a row (flat index fi = row * 128 + e)
// meets its partner e ^ j: the low one (e & j == 0) reads e + j, the high
// one e - j, which is what the TPU kernel's two rolls give. The keys are
// compared in lexicographic unsigned order; x1 = asc ^ lo with
// asc = (fi & k) == 0, and an element takes its partner's words where
// (x1 && self < partner) || (!x1 && self > partner), so equal keys are
// both kept.
//
// Bound on this card: bytes. The function moves 24 B per element (three
// words read once, three written once): 462.4 MB at the microbenchmark's
// 147 blocks of 2^17, 0.138 ms at 3.35 TB/s. Its compares and selects are
// below that at the card's peak rate, but the kernel runs ~18 integer
// instructions per element and round (three compares, the take, three
// selects, the lane test) on 64 INT32 lanes per SM, so at 32 rounds it is
// expected to take several times the bound, limited by that instruction rate.
//
// Design: every stride is below the row's 128 elements, so the rows are
// independent and one warp takes one row with no shared memory and no
// barrier. Lane l holds elements l + 32 q, q = 0..3, in registers, so a
// warp's load of one word for one q is 128 consecutive bytes. Strides 1-16
// are __shfl_xor_sync across lanes (12 shuffles per row and round); 32 and
// 64 pair register q with q ^ 1 or q ^ 2 inside the lane. Since k >= 128,
// fi & k depends on the row only, so the direction is uniform across the
// warp; the stride is uniform too, and neither branch diverges. CUDA
// compares uint32_t directly, so the TPU kernel's INT_MIN bias is not
// needed. R is a runtime argument. One launch per call, out of place, no
// memset.
#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int LANES = 128;                 // elements per row
constexpr int PER_LANE = LANES / 32;       // element lane + 32 q in register q
constexpr int ROWS_PER_BLOCK = 8;          // one warp per row
constexpr int THREADS = 32 * ROWS_PER_BLOCK;

__global__ void __launch_bounds__(THREADS)
bitonic_rounds_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                      const uint32_t* __restrict__ c, uint32_t* __restrict__ oa, uint32_t* __restrict__ ob,
                      uint32_t* __restrict__ oc, long long rows, int rounds) {
    const int lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
    if (row >= rows) return;  // the whole warp leaves together
    const long long base = row * LANES + lane;
    uint32_t x0[PER_LANE], x1[PER_LANE], x2[PER_LANE];
#pragma unroll
    for (int q = 0; q < PER_LANE; ++q) {
        x0[q] = a[base + 32 * q];
        x1[q] = b[base + 32 * q];
        x2[q] = c[base + 32 * q];
    }
    int rj = 0, rk = 0;  // r % 7 and r % 10
    for (int r = 0; r < rounds; ++r) {
        const int j = 1 << rj;
        // (fi & k) == 0 with fi = row * 128 + e and k = 128 << rk: bit rk of
        // the row (the block-local row of the TPU kernel has the same bits,
        // since k < 2^17, one block's size)
        const bool asc = ((row >> rk) & 1) == 0;
        uint32_t p0[PER_LANE], p1[PER_LANE], p2[PER_LANE];
        if (j < 32) {
#pragma unroll
            for (int q = 0; q < PER_LANE; ++q) {
                p0[q] = __shfl_xor_sync(FULL, x0[q], j);
                p1[q] = __shfl_xor_sync(FULL, x1[q], j);
                p2[q] = __shfl_xor_sync(FULL, x2[q], j);
            }
        } else {
            const bool near = j == 32;  // partner register q ^ 1, else q ^ 2
#pragma unroll
            for (int q = 0; q < PER_LANE; ++q) {
                p0[q] = near ? x0[q ^ 1] : x0[q ^ 2];
                p1[q] = near ? x1[q ^ 1] : x1[q ^ 2];
                p2[q] = near ? x2[q ^ 1] : x2[q ^ 2];
            }
        }
#pragma unroll
        for (int q = 0; q < PER_LANE; ++q) {
            const bool lo = ((lane + 32 * q) & j) == 0;
            const bool e0 = x0[q] == p0[q], e1 = x1[q] == p1[q];
            const bool lt = x0[q] < p0[q] || (e0 && (x1[q] < p1[q] || (e1 && x2[q] < p2[q])));
            const bool eq = e0 && e1 && x2[q] == p2[q];
            const bool take = (asc != lo) ? lt : !(lt || eq);
            if (take) {
                x0[q] = p0[q];
                x1[q] = p1[q];
                x2[q] = p2[q];
            }
        }
        rj = rj == 6 ? 0 : rj + 1;
        rk = rk == 9 ? 0 : rk + 1;
    }
#pragma unroll
    for (int q = 0; q < PER_LANE; ++q) {
        oa[base + 32 * q] = x0[q];
        ob[base + 32 * q] = x1[q];
        oc[base + 32 * q] = x2[q];
    }
}

}  // namespace

// a, b, c: [rows, 128] u32 words (int32 tensors of the same bits); oa, ob,
// oc: their outputs after `rounds` rounds, which may not overlap the inputs.
extern "C" int bitonic_rounds(const int* a, const int* b, const int* c, int* oa, int* ob, int* oc, long long rows,
                              long long rounds, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    bitonic_rounds_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
        reinterpret_cast<const uint32_t*>(a), reinterpret_cast<const uint32_t*>(b),
        reinterpret_cast<const uint32_t*>(c), reinterpret_cast<uint32_t*>(oa), reinterpret_cast<uint32_t*>(ob),
        reinterpret_cast<uint32_t*>(oc), rows, (int)rounds);
    return (int)cudaGetLastError();
}
