// merge_compact_tracked: one BPE merge (a,b) -> Z with stable compaction,
// created-pair tracking and exact probe counts, in window-probe mode.
//
// Replaces the TPU kernel `_merge_compact_kernel` of
// gpu_bpe_tpu/ops/pallas_kernels.py:136 (public entry
// `merge_compact_tracked`, pallas_kernels.py:1289).
//
// Bound on this card: bytes. The work is a few integer compares per
// symbol; the least traffic is reading symbols and weights once (8 B per
// live symbol) and writing the compacted stream and its zero tail once
// (8 B per capacity slot), about 16 MB at capacity 2^20 (~5 us at
// 3.35 TB/s).
//
// Design: the TPU kernel walked a sequential grid, carrying the previous
// block's last symbol, the output offset and a partial DMA tile in SMEM,
// and compacted each block with a log-shift network. None of that carries
// over. Here every launch is a parallel grid with one symbol per thread:
//   1. probe_setup (one block): the affected window slots and the probe
//      list, and zeroes the accumulators;
//   2. flag_count: each thread reads p-1, p and p+1 straight from global
//      memory (neighbours hit L1/L2) and the block counts its removals;
//   3. scan_blocks (one block): exclusive scan of the block counts -> n';
//   4. scatter: survivors go to out[block_offset + local_rank], Z written
//      as new_id | (sym & WS); the tail past n' is zeroed;
//   5. track: one pass over adjacent pairs of the compacted output that
//      folds the left/right created-pair histograms (64-bit integer atomics
//      in shared memory, then global), the heaviest created pair per side
//      (64-bit atomicMax on (weight << 32) | (0xFFFF - tok)) and the probe
//      counts (integer atomics);
//   6. finalize (one block): histograms to f32 once, and the sample words.
// The merge and the compaction read the same neighbours twice (launches 2
// and 4) instead of keeping a per-block carry; that costs one more read of
// the stream and keeps every block independent.
#include "common.cuh"

using namespace bpe;

namespace {

// scratch layout (int64 words)
constexpr int SC_BINS = 0;     // [512] unsigned: left bins, then right bins
constexpr int SC_SAMP = 512;   // [2] packed (weight << 32) | (0xFFFF - tok)
constexpr int SC_NPE = 514;    // effective probe count (0..N_PROBES)
constexpr int SC_BLK = 520;    // [nblocks] removals per block -> offsets

struct MergeSite {
    uint32_t self;
    bool site;
    bool removed;
};

// The merge rule of pallas_kernels.py:257-271, computed from the original
// array (read-all-before-write, overlap-collapse quirk). Sites and
// removals are masked to the live prefix, so garbage past n never matches.
__device__ __forceinline__ MergeSite merge_at(const int* sym, long long p, long long cap,
                                              long long n, uint32_t pair) {
    MergeSite m{0u, false, false};
    if (p >= cap) return m;
    const uint32_t a = pair >> 16, b = pair & TOKEN_MASK;
    const bool noop = pair == 0u;  // pair 0 merges nothing
    m.self = (uint32_t)sym[p];
    const uint32_t prev = p > 0 ? (uint32_t)sym[p - 1] : 0u;
    const uint32_t tok = m.self & TOKEN_MASK;
    m.removed = !noop && p < n && (prev & TOKEN_MASK) == a && tok == b && (m.self & WS_BIT) == 0u;
    if (!noop && p < n - 1 && tok == a) {
        const uint32_t nxt = (uint32_t)sym[p + 1];
        m.site = (nxt & TOKEN_MASK) == b && (nxt & WS_BIT) == 0u;
    }
    return m;
}

__global__ void probe_setup(const long long* cand, const long long* counts, const long long* pair_p,
                            long long* probes, long long* pcnt, long long* naff_out,
                            long long* scratch) {
    const int t = threadIdx.x;  // one window slot per thread
    const uint32_t pair = as_u32(*pair_p);
    const uint32_t a = pair >> 16, b = pair & TOKEN_MASK;
    const uint32_t c = as_u32(cand[t]);
    // affected set (the _post_counts theorem): live slots whose pair ends
    // in a or starts with b, excluding (a,b) itself
    const int aff = counts[t] >= 0 && ((c & TOKEN_MASK) == a || (c >> 16) == b) && c != pair;
    int naff;
    const int rank = block_exclusive_scan(aff, &naff);
    const int npe = naff <= N_PROBES ? naff : 0;
    if (aff && rank < npe) probes[rank] = c;
    if (t < N_PROBES) {
        if (t >= npe) probes[t] = 1;  // sentinel pair 1 in unused slots
        pcnt[t] = 0;
    }
    scratch[SC_BINS + t] = 0;
    scratch[SC_BINS + NBINS + t] = 0;
    if (t == 0) {
        scratch[SC_SAMP] = 0;
        scratch[SC_SAMP + 1] = 0;
        scratch[SC_NPE] = npe;
        *naff_out = naff;
    }
}

__global__ void flag_count(const int* sym, long long cap, const long long* n_p, const long long* pair_p,
                           long long* scratch) {
    const long long p = (long long)blockIdx.x * TILE + threadIdx.x;
    const long long n = min(*n_p, cap);
    const MergeSite m = merge_at(sym, p, cap, n, as_u32(*pair_p));
    const int cnt = __syncthreads_count(m.removed);
    if (threadIdx.x == 0) scratch[SC_BLK + blockIdx.x] = cnt;
}

__global__ void scan_blocks(long long nblocks, long long cap, const long long* n_p, long long* n_new,
                            long long* scratch) {
    const long long removed = scan_block_counts(scratch + SC_BLK, nblocks);
    if (threadIdx.x == 0) *n_new = min(*n_p, cap) - removed;
}

__global__ void scatter(const int* sym, const int* w, long long cap, const long long* n_p,
                        const long long* pair_p, const long long* new_id_p, const long long* n_new,
                        const long long* scratch, int* out_sym, int* out_w) {
    const long long p = (long long)blockIdx.x * TILE + threadIdx.x;
    const long long n = min(*n_p, cap);
    const MergeSite m = merge_at(sym, p, cap, n, as_u32(*pair_p));
    int tot;
    const int before = block_exclusive_scan(m.removed ? 1 : 0, &tot);
    if (p < n && !m.removed) {
        const long long dst = p - (scratch[SC_BLK + blockIdx.x] + before);
        const uint32_t z = as_u32(*new_id_p) | (m.self & WS_BIT);
        out_sym[dst] = (int)(m.site ? z : m.self);
        out_w[dst] = w[p];
    }
    if (p >= *n_new && p < cap) {  // zero tail (survivors all land below n')
        out_sym[p] = 0;
        out_w[p] = 0;
    }
}

__device__ __forceinline__ unsigned long long sample_word(int weight, uint32_t tok) {
    return ((unsigned long long)(uint32_t)weight << 32) | (unsigned long long)(TOKEN_MASK - tok);
}

__global__ void track(const int* out_sym, const int* out_w, long long cap, const long long* n_new,
                      const long long* new_id_p, const long long* probes, long long* pcnt,
                      long long* scratch) {
    __shared__ unsigned long long s_bins[2 * NBINS];
    __shared__ unsigned long long s_pcnt[N_PROBES];
    __shared__ uint32_t s_probe[N_PROBES];
    __shared__ unsigned long long s_samp[2];
    __shared__ int s_any;
    const int t = threadIdx.x;
    for (int i = t; i < 2 * NBINS; i += blockDim.x) s_bins[i] = 0;
    if (t < N_PROBES) {
        s_pcnt[t] = 0;
        s_probe[t] = as_u32(probes[t]);
    }
    if (t < 2) s_samp[t] = 0;
    if (t == 0) s_any = 0;
    const int npe = (int)scratch[SC_NPE];
    const uint32_t z16 = as_u32(*new_id_p) & TOKEN_MASK;
    __syncthreads();

    // every adjacent pair (q, q+1) of the compacted stream, plus the pair
    // of the last symbol with the zero pad when the capacity has room for
    // one (the Pallas window sees the same pad symbol)
    const long long q = (long long)blockIdx.x * TILE + t;
    if (q < min(*n_new, cap - 1)) {
        const uint32_t u = (uint32_t)out_sym[q], v = (uint32_t)out_sym[q + 1];
        if ((v & WS_BIT) == 0u) {
            const uint32_t ut = u & TOKEN_MASK, vt = v & TOKEN_MASK;
            const int uw = out_w[q], vw = out_w[q + 1];
            if (vt == z16 && vw > 0) {  // left created pair (u, Z), v's weight
                atomicAdd(&s_bins[bin_of(ut)], (unsigned long long)vw);
                atomicMax(&s_samp[0], sample_word(vw, ut));
                s_any = 1;
            }
            if (ut == z16 && uw > 0) {  // right created pair (Z, v), u's weight
                atomicAdd(&s_bins[NBINS + bin_of(vt)], (unsigned long long)uw);
                atomicMax(&s_samp[1], sample_word(uw, vt));
                s_any = 1;
            }
            const uint32_t pr = (ut << 16) | vt;
            for (int k = 0; k < npe; ++k) {
                if (pr == s_probe[k]) {
                    atomicAdd(&s_pcnt[k], (unsigned long long)(long long)uw);
                    s_any = 1;
                }
            }
        }
    }
    __syncthreads();
    if (!s_any) return;
    unsigned long long* g = reinterpret_cast<unsigned long long*>(scratch);
    for (int i = t; i < 2 * NBINS; i += blockDim.x)
        if (s_bins[i]) atomicAdd(&g[SC_BINS + i], s_bins[i]);
    if (t < 2 && s_samp[t]) atomicMax(&g[SC_SAMP + t], s_samp[t]);
    if (t < npe && s_pcnt[t]) atomicAdd(reinterpret_cast<unsigned long long*>(&pcnt[t]), s_pcnt[t]);
}

__global__ void finalize(const long long* scratch, float* bins, long long* samp) {
    const int t = threadIdx.x;  // NBINS threads
    bins[t] = __ll2float_rn(scratch[SC_BINS + t]);  // exact mass -> f32 once
    bins[NBINS + t] = __ll2float_rn(scratch[SC_BINS + NBINS + t]);
    if (t == 0) {
        const unsigned long long pl = (unsigned long long)scratch[SC_SAMP];
        const unsigned long long pr = (unsigned long long)scratch[SC_SAMP + 1];
        // weight -1 when no block saw created-pair mass, 0 when only the
        // other side did (the Pallas kernel's sample-state semantics)
        samp[0] = pl ? (long long)(pl >> 32) : (pr ? 0 : -1);
        samp[1] = pl ? (long long)(TOKEN_MASK - (uint32_t)(pl & 0xFFFFFFFFull)) : 0;
        samp[2] = pr ? (long long)(pr >> 32) : (pl ? 0 : -1);
        samp[3] = pr ? (long long)(TOKEN_MASK - (uint32_t)(pr & 0xFFFFFFFFull)) : 0;
    }
}

}  // namespace

extern "C" long long mc_scratch_words(long long cap) { return SC_BLK + (cap + TILE - 1) / TILE; }

extern "C" int merge_compact_tracked(const int* sym, const int* w, long long cap, const long long* n,
                                     const long long* pair, const long long* new_id,
                                     const long long* cand, const long long* counts, int* out_sym,
                                     int* out_w, long long* n_new, float* bins, long long* samp,
                                     long long* pcnt, long long* probes, long long* naff,
                                     long long* scratch, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long nblocks = (cap + TILE - 1) / TILE;
    probe_setup<<<1, W_SLOTS, 0, s>>>(cand, counts, pair, probes, pcnt, naff, scratch);
    flag_count<<<(unsigned)nblocks, TILE, 0, s>>>(sym, cap, n, pair, scratch);
    scan_blocks<<<1, TILE, 0, s>>>(nblocks, cap, n, n_new, scratch);
    scatter<<<(unsigned)nblocks, TILE, 0, s>>>(sym, w, cap, n, pair, new_id, n_new, scratch, out_sym,
                                               out_w);
    track<<<(unsigned)nblocks, TILE, 0, s>>>(out_sym, out_w, cap, n_new, new_id, probes, pcnt, scratch);
    finalize<<<1, NBINS, 0, s>>>(scratch, bins, samp);
    return (int)cudaGetLastError();
}
