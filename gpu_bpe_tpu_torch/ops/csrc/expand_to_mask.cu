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
// per entry): ~84 MB at the rank-space chain's 2^24 entries, ~25 us at
// 3.35 TB/s.
//
// Design: the TPU kernel windowed a DMA of the value stream into VMEM and
// moved each value to its position through a left then an MSB-first right
// log-shift network. Here the rank is an exclusive scan of the mask in two
// passes (per-1024-entry counts, a one-block scan of the counts) and each
// set position gathers its value directly. A value index past the `m`
// values given reads as 0 instead of faulting.
#include "common.cuh"

using namespace bpe;

namespace {

__global__ void count_set(const unsigned char* mask, long long n, long long* blk) {
    const long long p = (long long)blockIdx.x * TILE + threadIdx.x;
    const int set = p < n && mask[p] != 0;
    const int cnt = __syncthreads_count(set);
    if (threadIdx.x == 0) blk[blockIdx.x] = cnt;
}

__global__ void scan_counts(long long* blk, long long nblocks) { scan_block_counts(blk, nblocks); }

__global__ void gather_set(const unsigned char* mask, long long n, const uint32_t* vals, long long m,
                           const long long* blk, uint32_t* out) {
    const long long p = (long long)blockIdx.x * TILE + threadIdx.x;
    const int set = p < n && mask[p] != 0;
    int tot;
    const int rank = block_exclusive_scan(set, &tot);
    if (p >= n) return;
    const long long src = blk[blockIdx.x] + rank;
    out[p] = set && src < m ? vals[src] : 0u;
}

}  // namespace

extern "C" long long em_scratch_words(long long n) { return (n + TILE - 1) / TILE; }

extern "C" int expand_to_mask(const unsigned char* mask, long long n, const uint32_t* vals, long long m,
                              uint32_t* out, long long* scratch, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long nblocks = (n + TILE - 1) / TILE;
    if (nblocks == 0) return (int)cudaGetLastError();
    count_set<<<(unsigned)nblocks, TILE, 0, s>>>(mask, n, scratch);
    scan_counts<<<1, TILE, 0, s>>>(scratch, nblocks);
    gather_set<<<(unsigned)nblocks, TILE, 0, s>>>(mask, n, vals, m, scratch, out);
    return (int)cudaGetLastError();
}
