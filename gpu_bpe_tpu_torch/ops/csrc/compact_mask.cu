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
// Design: the TPU kernel walked a sequential grid with a log-shift
// displacement network per block and an aligned-carry DMA into the output.
// None of that carries over. Placement here is two-pass, as in
// merge_compact_tracked.cu: per-1024-entry keep counts, a one-block scan of
// the counts, then a scatter of each survivor to block_offset + local_rank.
// The primary is read twice (count, scatter) so every block stays
// independent; extras are read only at kept entries. Entries of the outputs
// past the total are left as they were (unspecified, as in the JAX kernel).
#include "common.cuh"

using namespace bpe;

namespace {

constexpr int MAX_EXTRA = 9;  // 1 + 2 * (stab levels - 1) with at most 5 levels
constexpr uint32_t DROP = 0xFFFFFFFFu;

struct Extras {
    const uint32_t* in[MAX_EXTRA];
    uint32_t* out[MAX_EXTRA];
};

__global__ void count_keep(const uint32_t* vals, long long n, long long* blk) {
    const long long p = (long long)blockIdx.x * TILE + threadIdx.x;
    const int keep = p < n && vals[p] != DROP;
    const int cnt = __syncthreads_count(keep);
    if (threadIdx.x == 0) blk[blockIdx.x] = cnt;
}

__global__ void scan_counts(long long* blk, long long nblocks, long long* total) {
    const long long tot = scan_block_counts(blk, nblocks);
    if (threadIdx.x == 0) *total = tot;
}

__global__ void scatter_keep(const uint32_t* vals, long long n, const long long* blk, uint32_t* out,
                             Extras ex, int n_extra) {
    const long long p = (long long)blockIdx.x * TILE + threadIdx.x;
    const uint32_t v = p < n ? vals[p] : DROP;
    const int keep = v != DROP;
    int tot;
    const int rank = block_exclusive_scan(keep, &tot);
    if (!keep) return;
    const long long dst = blk[blockIdx.x] + rank;
    out[dst] = v & TOKEN_MASK;
#pragma unroll
    for (int e = 0; e < MAX_EXTRA; ++e)
        if (e < n_extra) ex.out[e][dst] = ex.in[e][p];
}

}  // namespace

extern "C" long long cm_scratch_words(long long n) { return (n + TILE - 1) / TILE; }

// extras_in / extras_out: host arrays of n_extra device pointers.
extern "C" int compact_mask(const uint32_t* vals, long long n, const void* const* extras_in,
                            void* const* extras_out, long long n_extra, uint32_t* out, long long* total,
                            long long* scratch, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n_extra < 0 || n_extra > MAX_EXTRA) return (int)cudaErrorInvalidValue;
    Extras ex{};
    for (int e = 0; e < n_extra; ++e) {
        ex.in[e] = static_cast<const uint32_t*>(extras_in[e]);
        ex.out[e] = static_cast<uint32_t*>(extras_out[e]);
    }
    const long long nblocks = (n + TILE - 1) / TILE;
    if (nblocks == 0) {
        cudaMemsetAsync(total, 0, sizeof(long long), s);
        return (int)cudaGetLastError();
    }
    count_keep<<<(unsigned)nblocks, TILE, 0, s>>>(vals, n, scratch);
    scan_counts<<<1, TILE, 0, s>>>(scratch, nblocks, total);
    scatter_keep<<<(unsigned)nblocks, TILE, 0, s>>>(vals, n, scratch, out, ex, (int)n_extra);
    return (int)cudaGetLastError();
}
