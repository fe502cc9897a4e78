// merge_compact_tracked: one BPE merge (a,b) -> Z with stable compaction,
// created-pair tracking and, in window-probe mode, exact probe counts.
//
// Replaces the TPU kernel `_merge_compact_kernel` of
// gpu_bpe_tpu/ops/pallas_kernels.py:136 (public entry
// `merge_compact_tracked`, pallas_kernels.py:1289, in all three modes;
// `merge_compact`, pallas_kernels.py:625, is the probe-less one).
//
// Modes: with a candidate window (cand, counts) the block that draws tile
// 0 derives the probe list from it and the tracking pass counts each probe.
// With an explicit probe list (probe_words, probe_count: the Pallas
// `probes=(words, count)`, pallas_kernels.py:195-200) that block copies
// the caller's list and count into the probe slots instead, and the
// tracking pass looks every pair up in the list (the caller's pairs need
// not be in the affected set). With null window and probe pointers (the
// probe-less mode of the data-parallel trainer, parallel/dist_train.py)
// the set-up is skipped: tile 0 only records that nothing is probed.
//
// Gated mode (the window mode of the default training loop's certified
// merge, ops/train_step.py): the pair is the state's pending winner, and
// the call also takes the pending count and the window's fill by pointer.
// Every block of A derives the gate itself: the merge is active when the
// count is at least 2 and new_id still fits in 16 bits, and a stopped merge
// runs as the no-op pair 0; the window has room for the two sampled created
// pairs when fill <= W_SLOTS - 2 and the merge is active. Tile 0's block
// writes the effective pair and both flags to the arena, and B reads the
// pair from there. B's last block, once the samples are known, writes the
// words the merge's count_pairs2 and window_post launches read in place:
// each sampled pair's flag (room, weight > 0, token != 0), its token (the
// 17-bit sentinel 0x10000 when not sampled, which matches no 16-bit token),
// its pair id for the count (sentinel pair 1 when not sampled) and whether
// the probe counts are used (n_aff <= N_PROBES). So the loop computes no
// scalar between the three launches.
//
// samp: per side, the heaviest created pair's weight and, among the pairs
// of that weight, the smallest token over the whole stream. That is the
// function the data-parallel trainer needs: the JAX package's own
// distributed path takes the same global minimum token on each shard
// (gpu_bpe_tpu/parallel/dist_train.py:150-157) and then the minimum over
// the shards attaining the maximum weight (:159-160). The Pallas kernel's
// token on a tie across its 32K-entry blocks is that of the earliest block
// reaching the weight, an artefact of the TPU's block layout; any tied
// token is sound for the histogram exclusion (:220-231), which subtracts
// that pair's exact count from its bin.
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
// over. The merge rule depends only on positions p-1, p and p+1 of the
// ORIGINAL stream (the overlap-collapse quirk included), so the keep flag
// of each position is local and the merge is a stable compaction under
// "p < n and not removed" whose transform rewrites a site to
// new_id | (sym & WS_BIT). A call is two kernels and nothing else:
//
//   A. merge_tiles: one pass of stream compaction with decoupled look-back,
//      the machinery of compact_mask.cu (common.cuh): 4096-entry tiles whose
//      symbols are read once as 16-byte vectors into registers and shared
//      memory with one halo symbol on each side (the original p-1 and p+1
//      at the tile's edges), ballot ranks, tile ids from an atomic counter,
//      64-bit status words, survivors staged in shared memory and written
//      as contiguous runs (weights read at the kept offsets). The same pass
//      writes the zero tail [n', cap): the r-th removal of the stream
//      zeroes output n - 1 - r (so [n', n) needs no n'), and each tile
//      zeroes its own slots at or past n. In window mode the block that
//      draws tile 0 also computes the affected window slots, the probe
//      list, n_aff and the effective probe count (0 with no window; the
//      caller's list and count, clamped to [0, N_PROBES], in explicit mode),
//      and, gated, the effective pair and the two gate flags.
//   B. track: one pass over adjacent pairs of the compacted output (in L2
//      right after A; all of a thread's 16-byte loads issued first),
//      folding the left/right created-pair histograms (integer atomics in
//      shared memory, each sum as two exact 32-bit halves), the heaviest
//      created pair per side (a running max of (weight << 32) |
//      (0xFFFF - tok) per thread, then per warp) and the probe counts (the
//      probe list as a small hash table in shared memory); each block then
//      adds its sums into the global accumulators. The last block, found
//      by a ticket counter, turns the bins into f32 once, writes the
//      samples, the probe counts and, gated, the sampled pairs' words, and
//      leaves the scratch (accumulators, tile counter, ticket, status
//      words) zeroed for the next call, so no memset is needed.
//
// The scratch belongs to the caller, zeroed once when it is made and kept
// clean by B; calls that share it run in stream order.
#include "common.cuh"

using namespace bpe;

namespace {

constexpr int THREADS = 256;  // = W_SLOTS: tile 0's block takes one window slot per thread
constexpr int VEC = 4;        // u32 entries per 16-byte load
constexpr int LOADS = 4;      // 16-byte loads per thread
constexpr int WARPS = THREADS / 32;
constexpr int TILE_N = THREADS * VEC * LOADS;  // entries per compaction tile
constexpr int TRACK_LOADS = 2;  // 16-byte loads of symbols and of weights per tracking thread
constexpr int TRACK_N = THREADS * VEC * TRACK_LOADS;  // pairs per tracking block
constexpr int HALO = 4;  // s_sym[HALO - 1] = p-1 of the tile's first entry, 16-byte aligned body
constexpr int PTAB = 2 * N_PROBES;  // slots of the tracking pass's probe hash table
static_assert(LOADS * WARPS == 32, "one warp scans the per-(load, warp) counts");
static_assert(THREADS == W_SLOTS, "tile 0's block reads one window slot per thread");
static_assert(N_PROBES <= THREADS, "one pass of threads writes the probe list");

// scratch layout (int64 words); all zero between calls but SC_NPE
constexpr int SC_BINS = 0;                    // [2 * NBINS] B's sums: left bins, then right bins
constexpr int SC_SAMP = SC_BINS + 2 * NBINS;  // [2] B's max of (weight << 32) | (0xFFFF - tok)
constexpr int SC_PCNT = SC_SAMP + 2;          // [N_PROBES] B's probe counts
constexpr int SC_ACC = SC_PCNT + N_PROBES;    // words of B's accumulators
constexpr int SC_NPE = SC_ACC;                // effective probe count (0..N_PROBES), written by A
constexpr int SC_NEXT = SC_NPE + 1;           // A's tile counter
constexpr int SC_TICKET = SC_NPE + 2;         // B's finished-block counter
constexpr int SC_STATUS = SC_NPE + 8;         // [ntiles] A's tile status words

// output arena (int64 words), mirrored by ARENA_* in ops/kernels.py
constexpr int AR_BINS = 0;                  // [2 * NBINS] f32 = NBINS words
constexpr int AR_SAMP = AR_BINS + NBINS;    // [4]
constexpr int AR_PCNT = AR_SAMP + 4;        // [N_PROBES]
constexpr int AR_PROBES = AR_PCNT + N_PROBES;  // [N_PROBES]
constexpr int AR_GATE = AR_PROBES + N_PROBES;  // [G_WORDS] the gated mode's words, in enum Gate's order
constexpr int G_WORDS = 10;
constexpr int AR_SOUT = AR_GATE + G_WORDS;  // [8] left to the caller (window_post's outputs in the gated loop)
constexpr int AR_NNEW = AR_SOUT + 8;
constexpr int AR_NAFF = AR_NNEW + 1;
constexpr int AR_WORDS = AR_NAFF + 1;
enum Gate { G_PAIR, G_ACTIVE, G_HAS_ROOM, G_USE_PROBES, G_L_OK, G_R_OK, G_L_TOK, G_R_TOK, G_L_SLOT, G_R_SLOT };
static_assert(G_R_SLOT + 1 == G_WORDS, "gate words shared with ops/kernels.py");
constexpr long long NO_EXCL = 0x10000;  // token of an unsampled pair: matches no 16-bit token

// the gate of the gated mode: the pending count is at least 2 and the new
// id still fits in 16 bits
__device__ __forceinline__ bool gate_active(const long long* count, const long long* new_id) {
    return *count >= 2 && *new_id <= (long long)TOKEN_MASK;
}

__device__ __forceinline__ long long ntiles_of(long long cap) { return (cap + TILE_N - 1) / TILE_N; }

__device__ __forceinline__ unsigned long long sample_word(int weight, uint32_t tok) {
    return ((unsigned long long)(uint32_t)weight << 32) | (unsigned long long)(TOKEN_MASK - tok);
}

// A block's sums of int32 weights in shared memory, as two native 32-bit
// atomics per weight: the low 16 bits (unsigned) and the rest (signed, so
// the split is exact for any int32). Neither half overflows for TRACK_N
// pairs, and 64-bit shared atomics under contention are several times
// slower (scripts/torch_ablate_merge.py).
struct Split {
    uint32_t lo;
    int hi;
};

__device__ __forceinline__ void add_split(Split* acc, int w) {
    atomicAdd(&acc->lo, (uint32_t)w & 0xFFFFu);
    atomicAdd(&acc->hi, w >> 16);
}

__device__ __forceinline__ long long joined(const Split& acc) {
    return (long long)acc.hi * 65536 + (long long)acc.lo;
}

__device__ __forceinline__ int ptab_slot(uint32_t pair) { return (int)((pair * 2654435761u) >> 25) & (PTAB - 1); }

__device__ __forceinline__ unsigned long long warp_max(unsigned long long x) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
        const unsigned long long y = __shfl_xor_sync(FULL_MASK, x, d);
        x = y > x ? y : x;
    }
    return x;
}

__global__ void __launch_bounds__(THREADS, 3)
merge_tiles(const uint32_t* __restrict__ sym, const int* __restrict__ w, long long cap, const long long* n_p,
            const long long* pair_p, const long long* new_id_p, const long long* cand, const long long* counts,
            const long long* probe_words, const long long* probe_count, const long long* gate_count,
            const long long* gate_fill, int* __restrict__ out_sym,
            int* __restrict__ out_w, long long* arena, long long* scratch) {
    __shared__ __align__(16) uint32_t s_sym[HALO + TILE_N + HALO];  // the tile and its halo; then the staged run
    __shared__ uint16_t stage_pos[TILE_N];
    __shared__ int load_off[LOADS * WARPS];
    __shared__ long long s_tile;
    __shared__ unsigned long long s_base;
    __shared__ int s_count;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    auto* words = reinterpret_cast<unsigned long long*>(scratch);
    unsigned long long* status = words + SC_STATUS;

    if (t == 0) s_tile = (long long)atomicAdd(&words[SC_NEXT], 1ull);
    const long long n = min(*n_p, cap);
    const bool active = gate_count == nullptr || gate_active(gate_count, new_id_p);
    const uint32_t pair = active ? as_u32(*pair_p) : 0u;  // a stopped gated merge runs as pair 0
    const uint32_t a = pair >> 16, b = pair & TOKEN_MASK;
    const bool noop = pair == 0u;  // pair 0 merges nothing
    __syncthreads();
    const long long tile = s_tile;
    const long long start = tile * TILE_N;

    // load j of thread t holds entries start + VEC * (j * THREADS + t) + [0, VEC)
    const bool aligned = (reinterpret_cast<unsigned long long>(sym) & 15) == 0;
    uint32_t v[LOADS][VEC];
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
        const int local = VEC * (j * THREADS + t);
        const long long p = start + local;
        if (aligned && p + VEC <= cap) {
            const uint4 q = __ldg(reinterpret_cast<const uint4*>(sym + p));
            v[j][0] = q.x;
            v[j][1] = q.y;
            v[j][2] = q.z;
            v[j][3] = q.w;
        } else {
#pragma unroll
            for (int k = 0; k < VEC; ++k) v[j][k] = p + k < cap ? sym[p + k] : 0u;
        }
        *reinterpret_cast<uint4*>(&s_sym[HALO + local]) = make_uint4(v[j][0], v[j][1], v[j][2], v[j][3]);
    }
    if (t == 0) s_sym[HALO - 1] = start > 0 ? sym[start - 1] : 0u;
    if (t == 1) s_sym[HALO + TILE_N] = start + TILE_N < cap ? sym[start + TILE_N] : 0u;
    __syncthreads();

    // the merge rule of pallas_kernels.py:257-271 on the original stream
    // (read-all-before-write); sites and removals are masked to the live
    // prefix, so garbage past n never matches. Bit VEC * j + k of `keep`
    // and `site` belongs to entry k of load j.
    unsigned keep = 0, site = 0;
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
        const int local = VEC * (j * THREADS + t);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            const long long p = start + local + k;
            const uint32_t self = v[j][k];
            const uint32_t prev = k > 0 ? v[j][k - 1] : s_sym[HALO + local - 1];
            const uint32_t nxt = k < VEC - 1 ? v[j][k + 1] : s_sym[HALO + local + VEC];
            const uint32_t tok = self & TOKEN_MASK;
            const bool removed = !noop && (prev & TOKEN_MASK) == a && tok == b && (self & WS_BIT) == 0u;
            const bool is_site = !noop && p < n - 1 && tok == a && (nxt & TOKEN_MASK) == b && (nxt & WS_BIT) == 0u;
            keep |= (unsigned)(p < n && !removed) << (VEC * j + k);
            site |= (unsigned)is_site << (VEC * j + k);
        }
    }

    // ranks: first[j] counts the kept entries of lower lanes in load j of
    // this warp (ballots); each (load, warp) count goes to the tile scan
    const unsigned below = (1u << lane) - 1u;
    int first[LOADS];
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
        int r = 0, warp_count = 0;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            const unsigned bal = __ballot_sync(FULL_MASK, (keep >> (VEC * j + k)) & 1u);
            r += __popc(bal & below);
            warp_count += __popc(bal);
        }
        first[j] = r;
        if (lane == 0) load_off[j * WARPS + warp] = warp_count;
    }
    __syncthreads();  // every read of s_sym's halo is done: it becomes the stage
    if (warp == 0) scan_and_publish(load_off, status, tile, lane, &s_count);
    __syncthreads();
    const int count = s_count;

    // stage each survivor's output word and its offset in the tile
    const uint32_t z = as_u32(*new_id_p);
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
        const int off = first[j] + load_off[j * WARPS + warp];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            const int bit = VEC * j + k;
            if ((keep >> bit) & 1u) {
                const int r = off + __popc((keep >> (VEC * j)) & ((1u << k) - 1u));
                s_sym[r] = (site >> bit) & 1u ? (z | (v[j][k] & WS_BIT)) : v[j][k];
                stage_pos[r] = (uint16_t)(VEC * (j * THREADS + t) + k);
            }
        }
    }
    if (warp == 0) {
        const unsigned long long base = tile == 0 ? 0 : look_back(status, tile, lane);
        if (lane == 0) {
            if (tile != 0) store_status(status + tile, ST_PREFIX | (base + count));
            s_base = base;
            if (tile == ntiles_of(cap) - 1) arena[AR_NNEW] = (long long)(base + count);
        }
    }
    __syncthreads();
    const long long base = (long long)s_base;
    for (int i = t; i < count; i += THREADS) {
        out_sym[base + i] = (int)s_sym[i];
        out_w[base + i] = w[start + stage_pos[i]];
    }
    // zero tail: the live entries before this tile lost `before` removals,
    // its own `mine`; removal r of the stream zeroes slot n - 1 - r, which
    // is >= n' = n - (all removals), where no survivor lands. Slots at or
    // past n in the tile's own range are zeroed too.
    const long long end = min(start + TILE_N, cap);
    const long long live = max(0ll, min(end, n) - start);
    const long long mine = live - count;
    const long long before = min(start, n) - base;
    for (long long i = t; i < mine; i += THREADS) {
        const long long q = n - before - mine + i;
        out_sym[q] = 0;
        out_w[q] = 0;
    }
    for (long long q = max(start, n) + t; q < end; q += THREADS) {
        out_sym[q] = 0;
        out_w[q] = 0;
    }

    if (tile == 0 && probe_words != nullptr) {  // explicit-probe mode: the caller's list
        const long long c = *probe_count;
        if (t < N_PROBES) arena[AR_PROBES + t] = probe_words[t];
        if (t == 0) {
            scratch[SC_NPE] = c < 0 ? 0 : (c > N_PROBES ? N_PROBES : c);
            arena[AR_NAFF] = c;
        }
    } else if (tile == 0 && cand == nullptr) {  // probe-less mode: nothing to probe
        if (t == 0) {
            scratch[SC_NPE] = 0;
            arena[AR_NAFF] = 0;
        }
    } else if (tile == 0) {  // the probe set-up, one window slot per thread
        const uint32_t c = as_u32(cand[t]);
        // affected set (the _post_counts theorem): live slots whose pair
        // ends in a or starts with b, excluding (a,b) itself
        const int aff = counts[t] >= 0 && ((c & TOKEN_MASK) == a || (c >> 16) == b) && c != pair;
        int naff;
        const int rank = block_exclusive_scan(aff, &naff);
        const int npe = naff <= N_PROBES ? naff : 0;
        long long* probes = arena + AR_PROBES;
        if (aff && rank < npe) probes[rank] = c;
        if (t < N_PROBES && t >= npe) probes[t] = 1;  // sentinel pair 1 in unused slots
        if (t == 0) {
            scratch[SC_NPE] = npe;
            arena[AR_NAFF] = naff;
            if (gate_count != nullptr) {
                long long* g = arena + AR_GATE;
                g[G_PAIR] = (long long)pair;
                g[G_ACTIVE] = active;
                g[G_HAS_ROOM] = active && *gate_fill <= W_SLOTS - 2;
            }
        }
    }
}

__global__ void __launch_bounds__(THREADS)
track(const int* __restrict__ out_sym, const int* __restrict__ out_w, long long cap, const long long* pair_p,
      const long long* new_id_p, bool any_pair, bool gated, long long* arena, long long* scratch) {
    __shared__ Split s_bins[2 * NBINS];
    __shared__ Split s_pcnt[N_PROBES];
    __shared__ uint32_t s_key[PTAB];  // probe pair
    __shared__ int s_idx[PTAB];       // its probe index, -1 when the slot is empty
    __shared__ unsigned long long s_samp[2];
    __shared__ int s_any, s_last;
    const int t = threadIdx.x, lane = t & 31;
    auto* words = reinterpret_cast<unsigned long long*>(scratch);
    for (int i = t; i < 2 * NBINS; i += THREADS) s_bins[i] = Split{0u, 0};
    if (t < N_PROBES) s_pcnt[t] = Split{0u, 0};
    if (t < PTAB) s_idx[t] = -1;
    if (t < 2) s_samp[t] = 0;
    if (t == 0) s_any = 0;
    const int npe = (int)scratch[SC_NPE];
    __syncthreads();
    // the probe list as an open-addressing hash table (linear probing, at
    // most half full); a pair listed twice gets two entries, as the probe
    // list counts it twice
    if (t < npe) {
        const uint32_t key = as_u32(arena[AR_PROBES + t]);
        for (int i = ptab_slot(key);; i = (i + 1) & (PTAB - 1)) {
            if (atomicCAS(&s_idx[i], -1, t) == -1) {
                s_key[i] = key;
                break;
            }
        }
    }
    const uint32_t pair = as_u32(*pair_p);
    const uint32_t a = pair >> 16, b = pair & TOKEN_MASK;
    const uint32_t z16 = as_u32(*new_id_p) & TOKEN_MASK;
    // every adjacent pair (q, q+1) of the compacted stream, plus the pair
    // of the last symbol with the zero pad at n' when the capacity has room
    // for one (the Pallas window sees the same pad symbol; A wrote it)
    const long long lim = min(arena[AR_NNEW], cap - 1);
    __syncthreads();

    // load j of thread t holds pairs (q, q+1) for q in q0 + [0, VEC), q0 =
    // block start + VEC * (j * THREADS + t): the symbols and weights at
    // q0 .. q0 + VEC, all loads issued before any pair is looked at
    const bool aligned = ((reinterpret_cast<unsigned long long>(out_sym) |
                           reinterpret_cast<unsigned long long>(out_w)) & 15) == 0;
    uint32_t us[TRACK_LOADS][VEC + 1];
    int uw[TRACK_LOADS][VEC + 1];
#pragma unroll
    for (int j = 0; j < TRACK_LOADS; ++j) {
        const long long q0 = (long long)blockIdx.x * TRACK_N + VEC * (j * THREADS + t);
        if (aligned && q0 + VEC <= cap) {
            const int4 x = *reinterpret_cast<const int4*>(out_sym + q0);
            const int4 y = *reinterpret_cast<const int4*>(out_w + q0);
            us[j][0] = x.x, us[j][1] = x.y, us[j][2] = x.z, us[j][3] = x.w;
            uw[j][0] = y.x, uw[j][1] = y.y, uw[j][2] = y.z, uw[j][3] = y.w;
        } else {
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
                us[j][k] = q0 + k < cap ? (uint32_t)out_sym[q0 + k] : 0u;
                uw[j][k] = q0 + k < cap ? out_w[q0 + k] : 0;
            }
        }
        us[j][VEC] = q0 + VEC < cap ? (uint32_t)out_sym[q0 + VEC] : 0u;
        uw[j][VEC] = q0 + VEC < cap ? out_w[q0 + VEC] : 0;
    }
    bool any = false;
    unsigned long long samp_l = 0, samp_r = 0;  // this thread's heaviest created pair per side
#pragma unroll
    for (int j = 0; j < TRACK_LOADS; ++j) {
        const long long q0 = (long long)blockIdx.x * TRACK_N + VEC * (j * THREADS + t);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            const uint32_t u = us[j][k], v = us[j][k + 1];
            if (q0 + k >= lim || (v & WS_BIT) != 0u) continue;
            const uint32_t ut = u & TOKEN_MASK, vt = v & TOKEN_MASK;
            const int wu = uw[j][k], wv = uw[j][k + 1];
            if (vt == z16 && wv > 0) {  // left created pair (u, Z), v's weight
                add_split(&s_bins[bin_of(ut)], wv);
                samp_l = max(samp_l, sample_word(wv, ut));
                any = true;
            }
            if (ut == z16 && wu > 0) {  // right created pair (Z, v), u's weight
                add_split(&s_bins[NBINS + bin_of(vt)], wu);
                samp_r = max(samp_r, sample_word(wu, vt));
                any = true;
            }
            // a window's probes end in a or start with b (the affected
            // set), so other pairs skip the list; an explicit list may hold
            // any pair (any_pair)
            if (npe && (any_pair || vt == a || ut == b)) {
                const uint32_t pr = (ut << 16) | vt;
                for (int i = ptab_slot(pr); s_idx[i] >= 0; i = (i + 1) & (PTAB - 1)) {
                    if (s_key[i] == pr) {
                        add_split(&s_pcnt[s_idx[i]], wu);
                        any = true;
                    }
                }
            }
        }
    }
    samp_l = warp_max(samp_l);
    samp_r = warp_max(samp_r);
    if (lane == 0) {
        if (samp_l) atomicMax(&s_samp[0], samp_l);
        if (samp_r) atomicMax(&s_samp[1], samp_r);
    }
    if (any) s_any = 1;
    __syncthreads();
    if (s_any) {
        for (int i = t; i < 2 * NBINS; i += THREADS)
            if (const long long x = joined(s_bins[i])) atomicAdd(&words[SC_BINS + i], (unsigned long long)x);
        if (t < 2 && s_samp[t]) atomicMax(&words[SC_SAMP + t], s_samp[t]);
        if (t < npe)
            if (const long long x = joined(s_pcnt[t])) atomicAdd(&words[SC_PCNT + t], (unsigned long long)x);
    }
    __syncthreads();
    if (t == 0) {
        __threadfence();  // the block's sums are visible before its ticket
        s_last = atomicAdd(&words[SC_TICKET], 1ull) == gridDim.x - 1;
    }
    __syncthreads();
    if (!s_last) return;

    // the last block: every other block's sums are in. It hands them out
    // and zeroes them; the histograms go to f32 once (exact mass, rounded
    // once)
    __threadfence();
    float* bins = reinterpret_cast<float*>(arena + AR_BINS);
    for (int i = t; i < SC_ACC; i += THREADS) {
        const unsigned long long x = __ldcg(&words[i]);
        words[i] = 0;
        if (i < SC_SAMP) bins[i - SC_BINS] = __ll2float_rn((long long)x);
        else if (i < SC_PCNT) s_samp[i - SC_SAMP] = x;
        else arena[AR_PCNT + i - SC_PCNT] = (long long)x;
    }
    __syncthreads();
    if (t == 0) {
        const unsigned long long pl = s_samp[0];
        const unsigned long long pr = s_samp[1];
        // weight -1 when no block saw created-pair mass, 0 when only the
        // other side did (the Pallas kernel's sample-state semantics)
        const long long s0 = pl ? (long long)(pl >> 32) : (pr ? 0 : -1);
        const long long s1 = pl ? (long long)(TOKEN_MASK - (uint32_t)(pl & 0xFFFFFFFFull)) : 0;
        const long long s2 = pr ? (long long)(pr >> 32) : (pl ? 0 : -1);
        const long long s3 = pr ? (long long)(TOKEN_MASK - (uint32_t)(pr & 0xFFFFFFFFull)) : 0;
        long long* samp = arena + AR_SAMP;
        samp[0] = s0;
        samp[1] = s1;
        samp[2] = s2;
        samp[3] = s3;
        if (gated) {  // the sampled created pairs of the gated merge (A wrote has_room)
            long long* g = arena + AR_GATE;
            const long long z16 = *new_id_p & TOKEN_MASK;
            const bool room = g[G_HAS_ROOM] != 0;
            const bool l_ok = room && s0 > 0 && s1 != 0;  // a pair with token 0 is never counted
            const bool r_ok = room && s2 > 0 && s3 != 0;
            const long long l_tok = l_ok ? s1 : NO_EXCL, r_tok = r_ok ? s3 : NO_EXCL;
            g[G_USE_PROBES] = arena[AR_NAFF] <= N_PROBES;
            g[G_L_OK] = l_ok;
            g[G_R_OK] = r_ok;
            g[G_L_TOK] = l_tok;
            g[G_R_TOK] = r_tok;
            g[G_L_SLOT] = l_ok ? (l_tok << 16) | z16 : 1;
            g[G_R_SLOT] = r_ok ? (z16 << 16) | r_tok : 1;
        }
        words[SC_NEXT] = 0;
        words[SC_TICKET] = 0;
    }
    for (long long i = t; i < ntiles_of(cap); i += THREADS) words[SC_STATUS + i] = 0;
}

}  // namespace

// Scratch words (int64) of a call at capacity cap: accumulators, counters
// and one status word per compaction tile. Zeroed by the caller once.
extern "C" long long mc_scratch_words(long long cap) { return SC_STATUS + (cap + TILE_N - 1) / TILE_N; }

extern "C" long long mc_arena_words() { return AR_WORDS; }

// out: [2, cap] int32 (merged symbols, then weights); arena: mc_arena_words()
// int64 words (bins as 2 x NBINS f32, samp[4], pcnt, probes, the gate
// words, 8 words for the caller, n_new, n_aff). cand and counts are the
// W_SLOTS-slot window; probe_words (N_PROBES pairs) and probe_count an
// explicit probe list; all four null for the probe-less mode (then pcnt is
// zero and probes is left unwritten). A window and a probe list are
// exclusive. gate_count and gate_fill (both or neither, with a window) make
// the call gated: pair is then the pending winner, gate_count its count.
extern "C" int merge_compact_tracked(const int* sym, const int* w, long long cap, const long long* n,
                                     const long long* pair, const long long* new_id,
                                     const long long* cand, const long long* counts,
                                     const long long* probe_words, const long long* probe_count,
                                     const long long* gate_count, const long long* gate_fill, int* out,
                                     long long* arena, long long* scratch, void* stream) {
    if (cand != nullptr && probe_words != nullptr) return (int)cudaErrorInvalidValue;
    const bool gated = gate_count != nullptr;
    if (gated != (gate_fill != nullptr) || (gated && cand == nullptr)) return (int)cudaErrorInvalidValue;
    if (cap < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long ntiles = (cap + TILE_N - 1) / TILE_N;
    const long long ntrack = cap > 1 ? (cap - 1 + TRACK_N - 1) / TRACK_N : 1;
    merge_tiles<<<(unsigned)ntiles, THREADS, 0, s>>>(reinterpret_cast<const uint32_t*>(sym), w, cap, n, pair,
                                                       new_id, cand, counts, probe_words, probe_count,
                                                       gate_count, gate_fill, out, out + cap, arena, scratch);
    track<<<(unsigned)ntrack, THREADS, 0, s>>>(out, out + cap, cap, gated ? arena + AR_GATE + G_PAIR : pair, new_id,
                                               probe_words != nullptr, gated, arena, scratch);
    return (int)cudaGetLastError();
}
