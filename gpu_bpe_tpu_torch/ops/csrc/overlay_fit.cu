// overlay_fit: the balanced-parens overlay and deepest in-chunk fit of the
// tokenizer's interval-stabbing join, over a sorted [nseg, m] stream.
//
// Replaces the TPU kernel `_make_overlay_fit_kernel` of
// gpu_bpe_tpu/ops/stab_kernels.py:81 (pallas_call :175, public entry
// `overlay_fit` :149); its plain version is the XLA doubling scan
// `_paren_overlay` + `_deepest_fit` of gpu_bpe_tpu/ops/tokenize.py:439-519.
//
// Each row is skp = flag << 30 | depth << 25 | pay25: flag 0 opens an
// interval at `depth` with payload `pay` (a vocab or group id), flag 2
// closes one, flag 1 is a position whose payload is its byte offset. Per
// depth the state of a row is the latest open or close at that depth
// within the segment, up to and including the row; an open is live until
// its close. Outputs per row:
//   packed = (base_len + d) << 16 | id of the deepest live open d <= max_depth
//            with base_len + d <= min((pos / cs + 1) * cs, input_len) - pos
//            (positions only, 0 elsewhere or with no fit);
//   key2   = pos for positions, 0xFFFFFFFF elsewhere;
//   gid    = id of the live open at group_depth for positions, else 0xFFFF.
// Ties of equal opens resolve to the last in sort order, the max id.
//
// Bound on this card: bytes. One read of skp (4 B per row) and one write
// of the three outputs (12 B per row): ~310 MB for the level-1 join of a
// 2^24-byte pass at an 8K vocab (147 x 2^17 rows), ~92 us at 3.35 TB/s.
//
// Design: the TPU kernel scanned 2^14-row blocks in lane-roll networks and
// carried the state per depth across a sequential grid in VMEM; an earlier
// port ran three passes (tile aggregates, a one-block scan per segment,
// then the apply pass), reading skp twice. Now one pass with decoupled
// look-back (Merrill & Garland, NVIDIA 2016) scoped to a segment:
//   * a state word is 17 bits: (id & 0xFFFF) + 1 for an open, CLOSED =
//     0x1FFFF for a close, 0 for no op. The combine "per depth, the later
//     non-zero word wins" is associative but not commutative;
//   * each block takes one tile of TROWS = 4096 rows of one segment (tiles
//     never cross segments); tile ids come from an atomic counter, so a
//     tile that waits on a predecessor of its segment was scheduled after
//     it. The rows arrive as 16-byte vectors in a striped layout (a warp
//     reads 512-byte runs), key2 goes straight out the same way, and the
//     rows are staged in shared memory, from which each thread takes 16
//     consecutive rows;
//   * the tile's last op per depth (depths 1..9) is a shared atomicMax of
//     row << 17 | state as the rows arrive, so it is published right after
//     the loads: three 64-bit status words of three 17-bit states each,
//     flag in the top two bits (aggregate, or inclusive prefix), each
//     written in one store, so a reader needs no fence. Warp 0 then looks
//     back while the other warps scan: it reads 32 predecessors at a time,
//     and each depth takes the state of the nearest tile whose state there
//     is non-zero or that published a prefix, as soon as every tile before
//     that one has published (not the whole window). A segment's first
//     tile starts from nothing. The tile then publishes its prefix;
//   * a thread keeps its state per depth in its column of a shared table
//     and the depths whose state is a live open as a bitmask. Inside a
//     warp the last lower lane with an op at depth d is one __ballot_sync
//     and __clz, its state one __shfl_sync (no shuffle ladder); one warp
//     combines the 8 warps' last ops with the tile's carry-in;
//   * replaying its rows, a thread finds the deepest fitting open as one
//     __clz of the live bits under the chunk's limit and reads its id from
//     the table; the position arithmetic is 32-bit, a shift when the chunk
//     size is a power of two. packed and gid (16-bit) are staged in shared
//     memory and go out as coalesced 16-byte stores.
// The counter and the status words are the caller's scratch, zeroed by one
// cudaMemsetAsync: a call is one memset and one kernel.
//
// What still holds it back (PERF.md; scripts/torch_ablate_tokenize.py
// builds and times the variants): at the 8K pass's level-1 join the kernel
// alone moving its bytes (loads, staging and stores, no scan) takes ~0.6
// of the whole time, the look-back ~0.1 and the per-row work the rest.
// Stores must cover whole 32-byte sectors in one instruction: 8 rows per
// thread as two 16-byte vectors 32 bytes apart, without the shared-memory
// transpose, moved its bytes at less than half the copy rate. 4 or 8 rows
// per thread are slower (more tiles, more look-backs), and a shuffle
// ladder or a 64-bit division change little now that they run once per
// 16 rows.
#include "common.cuh"

using namespace bpe;

namespace {

constexpr int ND = 10;  // depth slots: the level-1 join's 1..8 plus the group slot 9
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RPT = 16;  // consecutive rows per thread
constexpr int VEC = 4;  // rows per 16-byte vector
constexpr int LOADS = RPT / VEC;  // 16-byte loads, and stores of each output, per thread
constexpr int TROWS = THREADS * RPT;  // rows per tile
constexpr int MIN_BLOCKS = 6;  // resident blocks per SM the registers must allow
constexpr uint32_t CLOSED = 0x1FFFFu;
constexpr uint32_t NO_GROUP = 0xFFFFu;
constexpr uint32_t NO_ROW = 3u << 30;  // past m: neither an op nor a position
constexpr int SBITS = 17;  // bits of a state word
constexpr int WORD_DEPTHS = 3;  // states per status word
constexpr int NSTATUS = (ND - 1 + WORD_DEPTHS - 1) / WORD_DEPTHS;  // status words per tile
static_assert(WORD_DEPTHS * SBITS <= 62, "three states and the flag fit one status word");
static_assert(RPT % VEC == 0, "a thread's rows are whole 16-byte vectors");

struct Params {
    long long m, tiles;  // rows and tiles per segment
    uint32_t input_len;  // clamped to [0, 2^31 - 1]
    uint32_t cs;         // chunk size, 1..2^30
    int cs_shift;        // log2(cs) when cs is a power of two, else -1
    int depths, base_len, fit_top, group_depth;  // fit_top = min(max_depth, depths - 1)
};

// Depth and state word of one row's op; depth -1 when it is no op (a
// position, a depth outside 1..depths-1, or a flag other than 0 and 2).
__device__ __forceinline__ int row_op(uint32_t kp, int depths, uint32_t* word) {
    const uint32_t flag = kp >> 30, ln = (kp >> 25) & 0x1Fu;
    if ((flag != 0u && flag != 2u) || ln < 1u || (int)ln >= depths) return -1;
    *word = flag == 0u ? (kp & 0xFFFFu) + 1u : CLOSED;
    return (int)ln;
}

__device__ __forceinline__ uint32_t key2_of(uint32_t kp) { return (kp >> 30) == 1u ? (kp & 0x1FFFFFFu) : 0xFFFFFFFFu; }

// The last non-zero `last` of a lower lane of the warp, 0 if none; `has`
// says whether this lane's is non-zero.
__device__ __forceinline__ uint32_t warp_last_before(uint32_t last, bool has, int lane) {
    const unsigned lo = __ballot_sync(FULL_MASK, has) & ((1u << lane) - 1u);
    const uint32_t y = __shfl_sync(FULL_MASK, last, lo ? 31 - __clz(lo) : 0);
    return lo ? y : 0u;
}

__device__ __forceinline__ uint32_t state_of(unsigned long long word, int d) {
    return (uint32_t)(word >> (SBITS * ((d - 1) % WORD_DEPTHS))) & CLOSED;
}

// The tile's status words from lane d's state (1 <= d < ND): lane k <
// NSTATUS gets word k, without its flag.
__device__ __forceinline__ unsigned long long pack_states(uint32_t x, int lane) {
    unsigned long long word = 0;
#pragma unroll
    for (int d = 1; d < ND; ++d) {
        const uint32_t y = __shfl_sync(FULL_MASK, x, d);
        if (lane == (d - 1) / WORD_DEPTHS) word |= (unsigned long long)y << (SBITS * ((d - 1) % WORD_DEPTHS));
    }
    return word;
}

// The carry-in of tile `tile` > 0 of a segment whose tiles' status words
// start at `status`, run by one full warp: lane d (1 <= d < ND) returns the
// latest op at depth d < depths in the segment's tiles before `tile`, 0 if
// none. Lane i reads the status of tile `pred - i` of the current window
// of 32 predecessors. Each unresolved depth takes the state of the nearest
// tile whose state there is non-zero or that published a prefix, provided
// every tile before it has published; the window is read again while a
// depth waits on a tile that has not published, and the walk moves 32
// tiles back once the whole window is published and leaves a depth open.
// Tiles before the segment's first read as a prefix of nothing.
__device__ inline uint32_t seg_look_back(const unsigned long long* status, long long tile, int depths, int lane) {
    uint32_t carry = 0;
    unsigned todo = ((1u << depths) - 1u) & ~1u;  // unresolved depths 1..depths-1 (warp-uniform)
    for (long long pred = tile - 1 - lane; todo;) {
        unsigned long long s[NSTATUS];
        bool ready = true;
#pragma unroll
        for (int k = 0; k < NSTATUS; ++k) {
            s[k] = pred >= 0 ? load_status(status + pred * NSTATUS + k) : ST_PREFIX;
            ready &= s[k] != 0;
        }
        const unsigned late = ~__ballot_sync(FULL_MASK, ready);
        const unsigned usable = late ? (1u << (__ffs(late) - 1)) - 1u : FULL_MASK;  // lanes before the first late one
        bool blocked = false;
#pragma unroll
        for (int d = 1; d < ND; ++d) {
            const unsigned long long w = s[(d - 1) / WORD_DEPTHS];
            const uint32_t v = state_of(w, d);
            const unsigned hit = __ballot_sync(FULL_MASK, v != 0u || (w & ST_PREFIX) != 0) & usable;
            if ((todo >> d) & 1u) {
                if (hit) {
                    const uint32_t x = __shfl_sync(FULL_MASK, v, __ffs(hit) - 1);
                    if (lane == d) carry = x;
                    todo &= ~(1u << d);
                } else {
                    blocked |= late != 0;
                }
            }
        }
        if (!blocked) pred -= 32;
    }
    return carry;
}

// x[k] to out[first + r + k] for the rows below `left`: one 16-byte store
// when the four are aligned and present
__device__ __forceinline__ void store_rows(uint32_t* out, long long first, int r, long long left, bool aligned,
                                           const uint32_t (&x)[VEC]) {
    if (aligned && r + VEC <= left) {
        *reinterpret_cast<uint4*>(out + first + r) = make_uint4(x[0], x[1], x[2], x[3]);
    } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k)
            if (r + k < left) out[first + r + k] = x[k];
    }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
overlay_tiles(const uint32_t* __restrict__ skp, Params P, uint32_t* __restrict__ packed,
              uint32_t* __restrict__ key2, uint32_t* __restrict__ gid, unsigned long long* next_tile,
              unsigned long long* status) {
    __shared__ __align__(16) uint32_t s_rows[TROWS];  // the tile's rows; then its packed output
    __shared__ __align__(16) uint16_t s_gid[TROWS];   // its gid output
    __shared__ uint32_t s_tab[ND][THREADS];  // a thread's last op per depth, then its state per depth
    __shared__ uint32_t s_grp[WARPS][ND];    // each warp's last op per depth, then its carry-in
    __shared__ unsigned s_open[WARPS];       // bit d: the warp's carry-in at depth d is a live open
    __shared__ uint32_t s_agg[ND];           // the tile's last op per depth, as row << SBITS | state
    __shared__ long long s_tile;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

    if (t == 0) s_tile = (long long)atomicAdd(next_tile, 1ull);
    if (t < ND) s_agg[t] = 0u;
    __syncthreads();
    const long long g = s_tile;
    const long long seg = g / P.tiles, tile = g - seg * P.tiles;
    const long long first = seg * P.m + tile * TROWS;  // the tile's first row in the stream
    const bool aligned = ((reinterpret_cast<unsigned long long>(skp + first) | reinterpret_cast<unsigned long long>(packed + first)
                           | reinterpret_cast<unsigned long long>(key2 + first)
                           | reinterpret_cast<unsigned long long>(gid + first)) & 15) == 0;
    const long long left = P.m - tile * TROWS;  // rows of the segment from the tile's first on

    // load j of thread t: rows VEC * (j * THREADS + t) + [0, VEC) of the
    // tile, so that a warp reads (and writes each output as) contiguous
    // 512-byte runs; key2 needs no state and goes out at once; the rows are
    // staged in shared memory for the transpose, and each op takes part in
    // the tile's last op per depth (a shared max over row << SBITS | state)
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
        const int r = VEC * (j * THREADS + t);
        uint32_t x[VEC], k2[VEC];
        if (aligned && r + VEC <= left) {
            const uint4 q = __ldg(reinterpret_cast<const uint4*>(skp + first + r));
            x[0] = q.x;
            x[1] = q.y;
            x[2] = q.z;
            x[3] = q.w;
        } else {
#pragma unroll
            for (int k = 0; k < VEC; ++k) x[k] = r + k < left ? skp[first + r + k] : NO_ROW;
        }
        *reinterpret_cast<uint4*>(&s_rows[r]) = make_uint4(x[0], x[1], x[2], x[3]);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            k2[k] = key2_of(x[k]);
            uint32_t w = 0u;
            const int od = row_op(x[k], P.depths, &w);
            if (od > 0) atomicMax(&s_agg[od], ((uint32_t)(r + k) << SBITS) | w);
        }
        store_rows(key2, first, r, left, aligned, k2);
    }
    __syncthreads();

    // warp 0, lane d: the tile's aggregate is published at once; its
    // carry-in is found by the look-back (nothing for a segment's first
    // tile) while the other warps scan, and its prefix published
    uint32_t carry = 0u;
    if (warp == 0) {
        const uint32_t agg = lane >= 1 && lane < ND ? s_agg[lane] & CLOSED : 0u;
        unsigned long long* tile_status = status + (seg * P.tiles + tile) * NSTATUS;
        const unsigned long long word = pack_states(agg, lane);
        if (tile == 0) {
            if (lane < NSTATUS) store_status(tile_status + lane, ST_PREFIX | word);
        } else {
            if (lane < NSTATUS) store_status(tile_status + lane, ST_COUNT | word);
            carry = seg_look_back(status + seg * P.tiles * NSTATUS, tile, P.depths, lane);
            const unsigned long long pw = pack_states(agg ? agg : carry, lane);
            if (lane < NSTATUS) store_status(tile_status + lane, ST_PREFIX | pw);
        }
    }

    // this thread's RPT consecutive rows, read from shared memory: its
    // last op per depth goes to its s_tab column (bit d of `mine`: it has
    // one); then per depth the warp's exclusive scan, whose result (the
    // thread's state entering its rows) replaces it; `own`: the depths
    // where that state is an op, `live`: where it is a live open
    const uint32_t* rows = s_rows + RPT * t;
    unsigned mine = 0;
#pragma unroll
    for (int v = 0; v < LOADS; ++v) {
        const uint4 q = *reinterpret_cast<const uint4*>(rows + VEC * v);
        const uint32_t x[VEC] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            uint32_t w = 0u;
            const int od = row_op(x[k], P.depths, &w);
            if (od > 0) {
                s_tab[od][t] = w;
                mine |= 1u << od;
            }
        }
    }
    unsigned own = 0, live = 0;
#pragma unroll
    for (int d = 1; d < ND; ++d) {
        const bool has = (mine >> d) & 1u;
        const uint32_t last = has ? s_tab[d][t] : 0u;
        const uint32_t e = warp_last_before(last, has, lane);
        s_tab[d][t] = e;
        own |= (unsigned)(e != 0u) << d;
        live |= (unsigned)(e - 1u < 0x10000u) << d;
        if (lane == 31) s_grp[warp][d] = has ? last : e;
    }
    __syncthreads();

    // warp 0, lane d: the warps' exclusive last ops at depth d (in place),
    // then each warp's carry-in in s_grp and its live opens in s_open
    if (warp == 0) {
        const bool dl = lane >= 1 && lane < ND;
        uint32_t before = carry;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            uint32_t x = 0u;
            if (dl) {
                x = s_grp[w][lane];
                s_grp[w][lane] = before;
            }
            const unsigned open = __ballot_sync(FULL_MASK, dl && before - 1u < 0x10000u);
            if (lane == 0) s_open[w] = open;
            if (x) before = x;
        }
    }
    __syncthreads();

    // replay the rows: the state at depth d is the thread's s_tab column
    // where `own` has d, else the warp's carry-in; `live` tracks the live
    // opens, so the deepest fitting open is one __clz
    const uint32_t* grp = s_grp[warp];
    live |= s_open[warp] & ~own;
    const unsigned gd_bit = P.group_depth >= 1 ? 1u << P.group_depth : 0u;
    uint32_t gst = 0u;  // the state at group_depth
    if (gd_bit) gst = (own & gd_bit) ? s_tab[P.group_depth][t] : grp[P.group_depth];
#pragma unroll
    for (int v = 0; v < LOADS; ++v) {
        const uint4 q = *reinterpret_cast<const uint4*>(rows + VEC * v);
        const uint32_t xs[VEC] = {q.x, q.y, q.z, q.w};
        uint32_t pk[VEC], gd[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            const uint32_t x = xs[k];
            uint32_t w = 0u;
            const int od = row_op(x, P.depths, &w);
            if (od > 0) {
                const unsigned bit = 1u << od;
                s_tab[od][t] = w;
                own |= bit;
                live = w != CLOSED ? live | bit : live & ~bit;
                if (bit == gd_bit) gst = w;
            }
            pk[k] = 0u;
            gd[k] = NO_GROUP;
            if ((x >> 30) == 1u) {
                const uint32_t pos = x & 0x1FFFFFFu;
                const uint32_t q = P.cs_shift >= 0 ? pos >> P.cs_shift : pos / P.cs;
                const uint32_t cend = min(q * P.cs + P.cs, P.input_len);
                const int room = cend > pos ? (int)(cend - pos) : 0;
                const int top = min(P.fit_top, room - P.base_len);  // deepest d with base_len + d in the chunk
                const unsigned fit = top >= 1 ? live & ((2u << top) - 2u) : 0u;
                if (fit) {
                    const int best = 31 - __clz(fit);
                    const uint32_t st = (own >> best) & 1u ? s_tab[best][t] : grp[best];
                    pk[k] = ((uint32_t)(P.base_len + best) << 16) | (st - 1u);
                }
                if (live & gd_bit) gd[k] = gst - 1u;
            }
        }
        const int r = RPT * t + VEC * v;  // the rows' own slots: packed replaces them
        *reinterpret_cast<uint4*>(&s_rows[r]) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
        *reinterpret_cast<uint2*>(&s_gid[r]) = make_uint2(gd[0] | gd[1] << 16, gd[2] | gd[3] << 16);
    }
    __syncthreads();

    // the packed and gid outputs, coalesced
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
        const int r = VEC * (j * THREADS + t);
        const uint4 a = *reinterpret_cast<const uint4*>(&s_rows[r]);
        const uint2 b = *reinterpret_cast<const uint2*>(&s_gid[r]);
        const uint32_t pk[VEC] = {a.x, a.y, a.z, a.w};
        const uint32_t gd[VEC] = {b.x & 0xFFFFu, b.x >> 16, b.y & 0xFFFFu, b.y >> 16};
        store_rows(packed, first, r, left, aligned, pk);
        store_rows(gid, first, r, left, aligned, gd);
    }
}

long long tiles_of(long long m) { return (m + TROWS - 1) / TROWS; }

}  // namespace

extern "C" long long of_tile_rows() { return TROWS; }

// Scratch words (int64) of a call: the tile counter, then NSTATUS status
// words per tile.
extern "C" long long of_scratch_words(long long nseg, long long m) { return 1 + nseg * tiles_of(m) * NSTATUS; }

// out: [3, nseg, m] u32 (packed, key2, gid); scratch: of_scratch_words(nseg,
// m) int64 words, zeroed here.
extern "C" int overlay_fit(const uint32_t* skp, long long nseg, long long m, long long input_len,
                           long long chunk_size, long long depths, long long base_len,
                           long long max_depth, long long group_depth, uint32_t* out,
                           long long* scratch, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (depths < 1 || depths > ND || group_depth >= depths || chunk_size < 1 || chunk_size > (1ll << 30)
        || base_len <= -(1ll << 30) || base_len >= (1ll << 30) || nseg < 0 || m < 0)
        return (int)cudaErrorInvalidValue;
    if (nseg == 0 || m == 0) return (int)cudaGetLastError();
    int shift = -1;
    if ((chunk_size & (chunk_size - 1)) == 0)
        for (shift = 0; (1ll << shift) < chunk_size; ++shift) {}
    const long long len = input_len < 0 ? 0 : (input_len < 0x7FFFFFFFll ? input_len : 0x7FFFFFFFll);
    Params P{m, tiles_of(m), (uint32_t)len,
             (uint32_t)chunk_size, shift, (int)depths, (int)base_len,
             (int)(max_depth < depths - 1 ? max_depth : depths - 1), (int)group_depth};
    const long long ntiles = nseg * P.tiles;
    const cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(long long) * of_scratch_words(nseg, m), s);
    if (err != cudaSuccess) return (int)err;
    auto* words = reinterpret_cast<unsigned long long*>(scratch);
    const long long rows = nseg * m;
    overlay_tiles<<<(unsigned)ntiles, THREADS, 0, s>>>(skp, P, out, out + rows, out + 2 * rows, words, words + 1);
    return (int)cudaGetLastError();
}
