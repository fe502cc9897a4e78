// expand_to_mask: out[p] = vals[rank(p)] where mask[p] is set, 0 elsewhere;
// rank(p) is the number of set entries before p. The inverse of
// compact_mask.
//
// Replaces the TPU kernel `_expand_mask_kernel` of
// gpu_bpe_tpu/ops/pallas_kernels.py:943 (pallas_call :1049, public entry
// `expand_to_mask` :1072).
//
// Bound on this card: bytes. One read of the mask (1 B per entry), one read
// of the used values (4 B per set entry) and one write of the output (4 B
// per entry): ~88 MB on the tokenizer's rank-space chain (2^24 entries,
// ~1.08 M set), ~26 us at 3.35 TB/s. The output is three quarters of it.
//
// Design: one pass, the mirror of compact_mask.cu's stream compaction with
// decoupled look-back (Merrill & Garland, NVIDIA 2016; look_back in
// common.cuh). The TPU kernel windowed a DMA of the value stream into VMEM
// and moved each value to its position through log-shift networks; an
// earlier port scanned the mask in three launches (per-tile counts, a
// one-block scan of all counts on one SM, a gather that read the mask
// again). Now:
//   * each block takes one tile of TILE_N = 8192 entries, 32 per thread,
//     read as eight 4-byte words of the mask in a striped layout: the four
//     output words of a mask word go out as one 16-byte store, and both a
//     warp's loads (128 B) and its stores (512 B) are contiguous;
//   * the tile's count (a warp __reduce_add_sync of __popc, one shared
//     atomic per warp) is published as soon as the mask is read; tile ids
//     come from an atomic counter, so a tile that waits on a predecessor
//     was scheduled after it. Warp 0 then looks back for the tile's offset
//     in the values and publishes the tile's prefix, while the other warps
//     rank their entries: ranks inside a warp come from __ballot_sync and
//     __popc, and one warp scans the 64 per-(load, warp) counts;
//   * the tile's values are one contiguous run vals[base, base + count),
//     read coalesced into shared memory; each set entry picks its value
//     there, at its in-tile rank. Value indices at or past `m` read as 0.
// The counter and the status words are the caller's scratch, zeroed by one
// cudaMemsetAsync: a call is one memset and one kernel.
//
// What still holds it back (PERF.md; scripts/torch_ablate_tokenize.py
// builds and times the variants): the value read waits on the look-back,
// which compact_mask never had to: without the look-back the kernel takes
// ~0.8 of its time. Writing a load's zeros before the look-back (most
// loads at ~6% density) was slower, as stores that cover a 32-byte sector
// in two instructions at different times are; 4096-entry tiles were
// slower, and a counting pre-pass, reads of the values straight from
// device memory, or 8 blocks per SM were no faster.
#include "common.cuh"

using namespace bpe;

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;    // mask entries per 4-byte load, output words per 16-byte store
constexpr int LOADS = 8;  // mask words per thread
constexpr int WARPS = THREADS / 32;
constexpr int GROUPS = LOADS * WARPS;  // (load, warp) groups of a tile, in entry order
constexpr int PER_LANE = GROUPS / 32;  // groups per lane of the scanning warp
constexpr int TILE_N = THREADS * VEC * LOADS;  // entries per tile
constexpr int MIN_BLOCKS = 6;  // resident blocks per SM the registers must allow
static_assert(GROUPS % 32 == 0 && LOADS * VEC <= 32, "one warp scans the groups; a thread's bits fit a word");

// out[p + k] = x_k for the entries below n, as one 16-byte store when all
// four are
__device__ __forceinline__ void store_out(uint32_t* out, long long n, long long p, uint32_t x0, uint32_t x1,
                                          uint32_t x2, uint32_t x3) {
    if (p + VEC <= n) {
        *reinterpret_cast<uint4*>(out + p) = make_uint4(x0, x1, x2, x3);
    } else {
        const uint32_t x[VEC] = {x0, x1, x2, x3};
#pragma unroll
        for (int k = 0; k < VEC; ++k)
            if (p + k < n) out[p + k] = x[k];
    }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
expand_tiles(const unsigned char* __restrict__ mask, long long n, const uint32_t* __restrict__ vals, long long m,
             uint32_t* __restrict__ out, unsigned long long* next_tile, unsigned long long* status) {
    __shared__ uint32_t stage[TILE_N];
    __shared__ int load_off[GROUPS];
    __shared__ long long s_tile;
    __shared__ unsigned long long s_base;
    __shared__ int s_count;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

    if (t == 0) {
        s_tile = (long long)atomicAdd(next_tile, 1ull);
        s_count = 0;
    }
    __syncthreads();
    const long long tile = s_tile;
    const long long start = tile * TILE_N;

    // load j of thread t holds entries start + VEC * (j * THREADS + t) + [0, VEC);
    // bit VEC * j + k of `set` marks entry k of load j
    const bool aligned = (reinterpret_cast<unsigned long long>(mask) & 3) == 0;
    unsigned set = 0;
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
        const long long p = start + (long long)VEC * (j * THREADS + t);
        if (aligned && p + VEC <= n) {
            const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(mask + p));
#pragma unroll
            for (int k = 0; k < VEC; ++k) set |= (unsigned)(((w >> (8 * k)) & 0xFFu) != 0u) << (VEC * j + k);
        } else {
#pragma unroll
            for (int k = 0; k < VEC; ++k) set |= (unsigned)(p + k < n && mask[p + k] != 0) << (VEC * j + k);
        }
    }
    // the tile's count, so that it is published before any rank is known
    const int warp_set = __reduce_add_sync(FULL_MASK, __popc(set));
    if (lane == 0) atomicAdd(&s_count, warp_set);
    __syncthreads();

    // warp 0 publishes the tile's count, looks back for the tile's offset
    // among the values and publishes the tile's prefix, while the other
    // warps rank their entries
    if (warp == 0) {
        const int count = s_count;
        if (lane == 0) store_status(status + tile, (tile == 0 ? ST_PREFIX : ST_COUNT) | (unsigned long long)count);
        const unsigned long long base = tile == 0 ? 0 : look_back(status, tile, lane);
        if (lane == 0) {
            if (tile != 0) store_status(status + tile, ST_PREFIX | (base + count));
            s_base = base;
        }
    }
    // in-tile order is (load, warp, lane, k): first[j] counts the set
    // entries of lower lanes in load j of this warp (ballots), and each
    // (load, warp) count goes to shared memory for the tile scan
    const unsigned below = (1u << lane) - 1u;
    int first[LOADS];
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
        int r = 0, warp_count = 0;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            const unsigned b = __ballot_sync(FULL_MASK, (set >> (VEC * j + k)) & 1u);
            r += __popc(b & below);
            warp_count += __popc(b);
        }
        first[j] = r;
        if (lane == 0) load_off[j * WARPS + warp] = warp_count;
    }
    __syncthreads();
    const long long base = (long long)s_base;
    const int count = s_count;

    // warp 0 turns the (load, warp) counts into in-tile offsets (lane i
    // takes PER_LANE consecutive groups) while the block reads the tile's
    // run of values, coalesced
    if (warp == 0) {
        int x[PER_LANE], sum = 0;
#pragma unroll
        for (int q = 0; q < PER_LANE; ++q) sum += x[q] = load_off[PER_LANE * lane + q];
        int inc = sum;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(FULL_MASK, inc, d);
            if (lane >= d) inc += y;
        }
        int run = inc - sum;
#pragma unroll
        for (int q = 0; q < PER_LANE; ++q) {
            load_off[PER_LANE * lane + q] = run;
            run += x[q];
        }
    }
#pragma unroll 4
    for (int i = t; i < count; i += THREADS) stage[i] = base + i < m ? __ldg(vals + base + i) : 0u;
    __syncthreads();

    // entry k of load j takes the value at its in-tile rank; the four
    // entries of a load go out as one 16-byte store
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
        int r = first[j] + load_off[j * WARPS + warp];
        uint32_t x[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            x[k] = 0u;
            if ((set >> (VEC * j + k)) & 1u) x[k] = stage[r++];
        }
        store_out(out, n, start + (long long)VEC * (j * THREADS + t), x[0], x[1], x[2], x[3]);
    }
}

}  // namespace

extern "C" long long em_tile_entries() { return TILE_N; }

// Scratch words (int64) of a call on n entries: the tile counter, then one
// status word per tile.
extern "C" long long em_scratch_words(long long n) { return 1 + (n + TILE_N - 1) / TILE_N; }

// mask: n bytes (any alignment); vals: m u32 words; out: n u32 words,
// 16-byte aligned; scratch: em_scratch_words(n) int64 words, zeroed here.
extern "C" int expand_to_mask(const unsigned char* mask, long long n, const uint32_t* vals, long long m,
                              uint32_t* out, long long* scratch, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n < 0 || m < 0 || (reinterpret_cast<unsigned long long>(out) & 15) != 0) return (int)cudaErrorInvalidValue;
    const long long ntiles = (n + TILE_N - 1) / TILE_N;
    if (ntiles == 0) return (int)cudaGetLastError();
    const cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(long long) * em_scratch_words(n), s);
    if (err != cudaSuccess) return (int)err;
    auto* words = reinterpret_cast<unsigned long long*>(scratch);
    expand_tiles<<<(unsigned)ntiles, THREADS, 0, s>>>(mask, n, vals, m, out, words, words + 1);
    return (int)cudaGetLastError();
}
