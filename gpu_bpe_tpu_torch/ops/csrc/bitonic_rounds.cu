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
// (x1 && self < partner) || (!x1 && self > partner). Since k >= 128,
// fi & k is bit r % 10 of the row: the direction is one per row and round.
//
// Bound on this card: operations. The function moves 24 B per element (three
// words read once, three written once): 462.4 MB at the microbenchmark's 147
// blocks of 2^17, 0.138 ms at 3.35 TB/s. Its least ALU work is 5 integer
// operations per element and round (per pair: one 3-word compare, the
// direction, six selects), 0.184 ms at 64 integer lanes per clock per SM on
// 132 SMs at 1980 MHz. Warp shuffles run at half that rate per lane.
//
// Design (one launch, out of place, no memset, no shared memory):
// * Rule: where the keys are equal, taking the partner's words changes
//   nothing, since all three words are the key. So an element takes them
//   where (self < partner) == x1 up to ties, and the test needs no equality
//   term: the pair's order is one 96-bit borrow chain (sub.cc, subc.cc,
//   subc.cc, subc: four integer adds) giving an all-ones mask, flipped by the
//   row's direction with one XOR, and each word is picked with one LOP3.
// * Layout: 16 elements per lane, a row on 8 lanes and 4 rows per warp.
//   Element e of a row lies in lane e % 8 of the row's group, register
//   e / 8. Strides 8-64 pair two registers of one lane: each pair is compared
//   once (11 operations for two elements, against 2 x 8 and six shuffles
//   when the two sit in two lanes). Strides 1-4 are __shfl_xor_sync within
//   the group: three shuffles, the compare, the flip and three picks per
//   element. Against one row per warp and four elements per lane (two
//   register strides of seven), this takes two more strides into registers
//   and cuts the shuffles per element from 15 to 9 a cycle.
// * Schedule: one cycle of the seven strides is unrolled with compile-time
//   strides, so the partner register, the shuffle-or-register choice and the
//   lane's high/low mask are constants; the cycle stops after the round
//   count (a uniform branch per round). The direction of the lane's row is
//   one shift per lane and round.
// * Loads: for one register, the 8 lanes of a row read 32 consecutive bytes,
//   so every load and store fills whole 32-byte sectors at any 4-byte
//   alignment; no vector loads are needed at 32 rounds.
// Measured on an H100 SXM (scripts/torch_ablate_bitonic.py): the round loop
// issues 6.15 ALU, 1.39 IMAD-path and 1.29 shuffle instructions per element
// and round, and one more round takes ~97% of the time those ALU
// instructions need at the integer rate. 8 or 32 elements per lane, the
// compare as C comparisons, or the picks as IMADs were no faster.
// The wrapper guarantees rows % 1024 == 0, so every warp holds whole rows
// and all its lanes take part in each shuffle.
#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int LANES = 128;                    // elements per row
constexpr int PER_LANE = 16;                  // elements of a row in one lane
constexpr int ROW_LANES = LANES / PER_LANE;   // lanes per row
constexpr int ROWS_PER_WARP = 32 / ROW_LANES;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS_PER_BLOCK = ROWS_PER_WARP * WARPS;
constexpr int CYCLE = 7;                      // strides 1, 2, ..., 64
constexpr uint32_t DIR_BITS = 10;             // the direction bit cycles over bits 0-9 of the row

// ~0 where (a0, a1, a2) < (b0, b1, b2) in lexicographic unsigned order, else
// 0: the borrow of a - b over the 96-bit keys, least significant word first.
__device__ __forceinline__ uint32_t less_mask(uint32_t a0, uint32_t a1, uint32_t a2, uint32_t b0, uint32_t b1,
                                              uint32_t b2) {
    uint32_t m;
    asm("{\n\t.reg .u32 t;\n\t"
        "sub.cc.u32 t, %3, %6;\n\t"
        "subc.cc.u32 t, %2, %5;\n\t"
        "subc.cc.u32 t, %1, %4;\n\t"
        "subc.u32 %0, %7, %7;\n\t}"
        : "=r"(m)
        : "r"(a0), "r"(a1), "r"(a2), "r"(b0), "r"(b1), "r"(b2), "r"(0u));
    return m;
}

// `yes` where m is all ones, `no` where it is 0 (one LOP3)
__device__ __forceinline__ uint32_t pick(uint32_t m, uint32_t yes, uint32_t no) { return (yes & m) | (no & ~m); }

struct Row {
    uint32_t x0[PER_LANE], x1[PER_LANE], x2[PER_LANE];  // register q holds element lane % ROW_LANES + ROW_LANES q
};

// One round of stride J. desc: ~0 where the lane's row sorts descending in
// this round (the low element of each pair ends with the larger key), else 0.
template <int J>
__device__ __forceinline__ void exchange(Row& v, uint32_t desc, int lane) {
    if constexpr (J >= ROW_LANES) {
        constexpr int D = J / ROW_LANES;  // partner register q ^ D
#pragma unroll
        for (int q = 0; q < PER_LANE; ++q) {
            if (q & D) continue;
            const int h = q | D;
            // swap where the high element is the smaller (ascending), or not
            // the smaller (descending; equal keys swap to the same words)
            const uint32_t s = less_mask(v.x0[h], v.x1[h], v.x2[h], v.x0[q], v.x1[q], v.x2[q]) ^ desc;
            const uint32_t l0 = v.x0[q], l1 = v.x1[q], l2 = v.x2[q];
            v.x0[q] = pick(s, v.x0[h], l0);
            v.x1[q] = pick(s, v.x1[h], l1);
            v.x2[q] = pick(s, v.x2[h], l2);
            v.x0[h] = pick(s, l0, v.x0[h]);
            v.x1[h] = pick(s, l1, v.x1[h]);
            v.x2[h] = pick(s, l2, v.x2[h]);
        }
    } else {
        // the low element takes a smaller partner (ascending) or one not
        // smaller (descending); the high element the opposite
        const uint32_t flip = desc ^ ((lane & J) ? ~0u : 0u);
#pragma unroll
        for (int q = 0; q < PER_LANE; ++q) {
            const uint32_t p0 = __shfl_xor_sync(FULL, v.x0[q], J);
            const uint32_t p1 = __shfl_xor_sync(FULL, v.x1[q], J);
            const uint32_t p2 = __shfl_xor_sync(FULL, v.x2[q], J);
            const uint32_t t = less_mask(p0, p1, p2, v.x0[q], v.x1[q], v.x2[q]) ^ flip;
            v.x0[q] = pick(t, p0, v.x0[q]);
            v.x1[q] = pick(t, p1, v.x1[q]);
            v.x2[q] = pick(t, p2, v.x2[q]);
        }
    }
}

// Rounds S.. of the cycle of strides 1 << S, until `rounds` are done.
// rbits: the row's bits 0-9; rk: r % 10.
template <int S>
__device__ __forceinline__ void cycle(Row& v, int& r, int rounds, uint32_t& rk, uint32_t rbits, int lane) {
    if constexpr (S < CYCLE) {
        if (r == rounds) return;
        exchange<1 << S>(v, 0u - ((rbits >> rk) & 1u), lane);
        ++r;
        rk = rk == DIR_BITS - 1 ? 0 : rk + 1;
        cycle<S + 1>(v, r, rounds, rk, rbits, lane);
    }
}

__global__ void __launch_bounds__(THREADS)
bitonic_rounds_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                      const uint32_t* __restrict__ c, uint32_t* __restrict__ oa, uint32_t* __restrict__ ob,
                      uint32_t* __restrict__ oc, long long rows, int rounds) {
    const int lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5) * ROWS_PER_WARP + lane / ROW_LANES;
    if (row >= rows) return;  // whole warps: rows % ROWS_PER_WARP == 0
    const long long base = row * LANES + lane % ROW_LANES;
    Row v;
#pragma unroll
    for (int q = 0; q < PER_LANE; ++q) {
        v.x0[q] = a[base + ROW_LANES * q];
        v.x1[q] = b[base + ROW_LANES * q];
        v.x2[q] = c[base + ROW_LANES * q];
    }
    // (fi & k) == 0 with fi = row * 128 + e and k = 128 << (r % 10): bit
    // r % 10 of the row (the block-local row of the TPU kernel has the same
    // bits, since k < 2^17, one block's size)
    const uint32_t rbits = (uint32_t)row & ((1u << DIR_BITS) - 1);
    uint32_t rk = 0;
    for (int r = 0; r < rounds;) cycle<0>(v, r, rounds, rk, rbits, lane);
#pragma unroll
    for (int q = 0; q < PER_LANE; ++q) {
        oa[base + ROW_LANES * q] = v.x0[q];
        ob[base + ROW_LANES * q] = v.x1[q];
        oc[base + ROW_LANES * q] = v.x2[q];
    }
}

}  // namespace

// a, b, c: [rows, 128] u32 words (int32 tensors of the same bits), rows a
// multiple of 1024; oa, ob, oc: their outputs after `rounds` rounds, which
// may not overlap the inputs.
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
