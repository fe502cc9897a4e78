// compact_mask / compact_valid: stable compaction of a u32 stream. Entries
// whose primary word is 0xFFFFFFFF are dropped; survivors keep their order.
// The primary output keeps the low 16 bits of each surviving word; up to
// MAX_EXTRA full-width u32 arrays ride along under the same mask.
//
// Replaces the TPU kernel `_make_compact_kernel(n_extra)` of
// gpu_bpe_tpu/ops/pallas_kernels.py:746 (pallas_call :878; public entries
// `compact_mask` :906 and `compact_valid` :927, the latter with no extras).
//
// Bound on this card: bytes. The least traffic is one read of the primary
// (4 B per entry), one read of each extra at the kept entries only, and one
// write of every output at the kept entries (4 B each), plus the total. On
// the tokenizer's PAD strip (2^24 entries, ~1/5 kept, no extras) that is
// ~80 MB, ~24 us at 3.35 TB/s.
//
// Design: one pass, stream compaction with decoupled look-back (Merrill &
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// NVIDIA 2016). The TPU kernel's sequential grid, log-shift displacement
// network and aligned-carry DMA have no counterpart here; an earlier
// two-pass design (count, one-block scan of the counts on one SM, scatter)
// read the primary twice in three launches and ran at ~10x the bound. Now:
//   * each block takes one tile of TILE_N = 4096 entries, 16 per thread,
//     loaded as four 16-byte vectors in a striped layout (neighbouring
//     threads on neighbouring addresses), so the primary is read once;
//   * ranks inside a warp come from __ballot_sync/__popc; one warp scans the
//     32 per-(load, warp) counts, which gives the in-tile rank of every kept
//     entry and the tile's count. A thread keeps its 16 words, a 16-bit keep
//     mask and four offsets (48 registers), so five blocks share an SM;
//   * tile ids come from an atomicAdd on a counter, not from blockIdx, so a
//     tile that waits on a predecessor was scheduled after it (forward
//     progress). Each tile publishes its count in a 64-bit status word
//     (flag in the top bits, value below, one store), then its first warp
//     looks back over the predecessors' words, 32 at a time, summing counts
//     down to the nearest published prefix, and publishes its own prefix;
//   * survivors are staged in shared memory at their in-tile rank, with their
//     offsets in the tile, and written out as one contiguous run from the
//     tile's offset; output i of the run reads each extra at the i-th kept
//     offset, so extras are read only at kept entries, all of them in one
//     round trip, and written as contiguous runs too;
//   * the last tile writes the total.
// The counter and the status words are the caller's scratch, zeroed by one
// cudaMemsetAsync before the launch: a call is one memset and one kernel.
// Nothing is written at or past n; entries of the outputs past the total
// are left as they were (unspecified, as in the JAX kernel).
//
// What still holds it back (PERF.md; scripts/torch_ablate_compact.py builds
// and times the variants): the work of a tile after its loads
// (staging, look-back, write-out), during which its block moves few bytes.
// A variant that stops once the tile's count is published runs near the
// card's copy rate; the look-back is about a quarter of the rest. 4 or 6
// resident blocks per SM change nothing, tile ids from blockIdx save little,
// and writes without the shared-memory run are slower.
#include "common.cuh"

using namespace bpe;

namespace {

constexpr int MAX_EXTRA = 9;  // 1 + 2 * (stab levels - 1) with at most 5 levels
constexpr uint32_t DROP = 0xFFFFFFFFu;
constexpr int THREADS = 256;
constexpr int VEC = 4;     // u32 entries per 16-byte load
constexpr int LOADS = 4;   // 16-byte loads per thread
constexpr int WARPS = THREADS / 32;
constexpr int TILE_N = THREADS * VEC * LOADS;  // entries per tile
constexpr int MIN_BLOCKS = 5;  // resident blocks per SM the registers must allow
static_assert(LOADS * WARPS == 32, "one warp scans the per-(load, warp) counts");

// The status words, look_back and scan_and_publish are in common.cuh.
struct Extras {
    const uint32_t* in[MAX_EXTRA];
    uint32_t* out[MAX_EXTRA];
};

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
compact_tiles(const uint32_t* __restrict__ vals, long long n, long long ntiles, uint32_t* __restrict__ out,
              Extras ex, int n_extra, unsigned long long* next_tile, unsigned long long* status,
              long long* total) {
    __shared__ uint32_t stage[TILE_N];
    __shared__ uint16_t stage_pos[TILE_N];
    __shared__ int load_off[LOADS * WARPS];
    __shared__ long long s_tile;
    __shared__ unsigned long long s_base;
    __shared__ int s_count;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

    if (t == 0) s_tile = (long long)atomicAdd(next_tile, 1ull);
    __syncthreads();
    const long long tile = s_tile;
    const long long start = tile * TILE_N;

    // load j of thread t holds entries start + VEC * (j * THREADS + t) + [0, VEC)
    const bool aligned = (reinterpret_cast<unsigned long long>(vals) & 15) == 0;
    uint32_t v[LOADS][VEC];
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
        const long long p = start + (long long)VEC * (j * THREADS + t);
        if (aligned && p + VEC <= n) {
            const uint4 q = __ldg(reinterpret_cast<const uint4*>(vals + p));
            v[j][0] = q.x;
            v[j][1] = q.y;
            v[j][2] = q.z;
            v[j][3] = q.w;
        } else {
#pragma unroll
            for (int k = 0; k < VEC; ++k) v[j][k] = p + k < n ? vals[p + k] : DROP;
        }
    }

    // in-tile order is (load, warp, lane, k): bit VEC * j + k of `keep` marks
    // a kept entry, first[j] counts the kept entries of lower lanes in load
    // j of this warp (ballots), and each (load, warp) count goes to shared
    // memory for the tile scan
    const unsigned below = (1u << lane) - 1u;
    unsigned keep = 0;
    int first[LOADS];
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
        int r = 0, warp_count = 0;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            const bool kept = v[j][k] != DROP;
            const unsigned b = __ballot_sync(FULL_MASK, kept);
            r += __popc(b & below);
            warp_count += __popc(b);
            keep |= (unsigned)kept << (VEC * j + k);
        }
        first[j] = r;
        if (lane == 0) load_off[j * WARPS + warp] = warp_count;
    }
    __syncthreads();

    // warp 0 scans the 32 counts into in-tile offsets and publishes the
    // tile's count; the block stages its survivors while warp 0 then looks
    // back for the tile's offset in the output
    if (warp == 0) scan_and_publish(load_off, status, tile, lane, &s_count);
    __syncthreads();
    const int count = s_count;

    // entry k of load j lands at first[j] + (kept entries before k in the
    // load): stage its 16-bit payload and its offset in the tile
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
        const int off = first[j] + load_off[j * WARPS + warp];
#pragma unroll
        for (int k = 0; k < VEC; ++k)
            if ((keep >> (VEC * j + k)) & 1u) {
                const int r = off + __popc((keep >> (VEC * j)) & ((1u << k) - 1u));
                stage[r] = v[j][k] & TOKEN_MASK;
                stage_pos[r] = (uint16_t)(VEC * (j * THREADS + t) + k);
            }
    }
    if (warp == 0) {
        const unsigned long long base = tile == 0 ? 0 : look_back(status, tile, lane);
        if (lane == 0) {
            if (tile != 0) store_status(status + tile, ST_PREFIX | (base + count));
            s_base = base;
            if (tile == ntiles - 1) *total = (long long)(base + count);
        }
    }
    __syncthreads();
    const long long base = (long long)s_base;
    // output i of the tile: the staged payload, and each extra read at the
    // kept entry's position (all extras' loads issued before their stores)
    for (int i = t; i < count; i += THREADS) {
        out[base + i] = stage[i];
        const long long p = start + stage_pos[i];
        uint32_t x[MAX_EXTRA];
#pragma unroll
        for (int e = 0; e < MAX_EXTRA; ++e)
            if (e < n_extra) x[e] = ex.in[e][p];
#pragma unroll
        for (int e = 0; e < MAX_EXTRA; ++e)
            if (e < n_extra) ex.out[e][base + i] = x[e];
    }
}

}  // namespace

extern "C" long long cm_tile_entries() { return TILE_N; }

// Scratch words (int64) of a call on n entries: the tile counter, then one
// status word per tile.
extern "C" long long cm_scratch_words(long long n) { return 1 + (n + TILE_N - 1) / TILE_N; }

// extras_in / extras_out: host arrays of n_extra device pointers; scratch:
// cm_scratch_words(n) int64 words on the device, zeroed here.
extern "C" int compact_mask(const uint32_t* vals, long long n, const void* const* extras_in,
                            void* const* extras_out, long long n_extra, uint32_t* out, long long* total,
                            long long* scratch, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n < 0 || n_extra < 0 || n_extra > MAX_EXTRA) return (int)cudaErrorInvalidValue;
    Extras ex{};
    for (int e = 0; e < n_extra; ++e) {
        ex.in[e] = static_cast<const uint32_t*>(extras_in[e]);
        ex.out[e] = static_cast<uint32_t*>(extras_out[e]);
    }
    const long long ntiles = (n + TILE_N - 1) / TILE_N;
    if (ntiles == 0) return (int)cudaMemsetAsync(total, 0, sizeof(long long), s);
    const cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(long long) * cm_scratch_words(n), s);
    if (err != cudaSuccess) return (int)err;
    auto* words = reinterpret_cast<unsigned long long*>(scratch);
    compact_tiles<<<(unsigned)ntiles, THREADS, 0, s>>>(vals, n, ntiles, out, ex, (int)n_extra, words,
                                                        words + 1, total);
    return (int)cudaGetLastError();
}
