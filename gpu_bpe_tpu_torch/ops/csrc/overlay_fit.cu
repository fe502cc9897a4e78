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
// 2^24-byte pass at an 8K vocab (147 x 2^17 rows), ~93 us at 3.35 TB/s.
//
// Design: the TPU kernel scanned 2^14-row blocks in lane-roll networks and
// carried the state per depth across a sequential grid in VMEM. Here the
// "latest op" combine (b ? b : a, with 0 for no op) is associative, so the
// scan is three parallel passes whose occupancy does not depend on nseg:
//   1. tile_last: one block per 2048-row tile of a segment stages the tile
//      in shared memory; each thread folds its 8 consecutive rows into one
//      state word per depth, and a warp-shuffle block scan gives the
//      tile's last op per depth;
//   2. scan_tiles: one block per segment turns the tiles' last ops into
//      each tile's carry-in (an exclusive scan over the segment's tiles,
//      which is where a segment starts from nothing);
//   3. apply: each tile redoes its block scan from its carry-in, walks its
//      rows in order and writes the three outputs through shared memory.
// skp is read twice (passes 1 and 3); the state words are (id & 0xFFFF) + 1
// for an open (the XLA path's u16 payloads) and CLOSED for a close.
#include "common.cuh"

using namespace bpe;

namespace {

constexpr int ND = 10;  // depth slots: the level-1 join's 1..8 plus the group slot 9
constexpr int THREADS = 256;
constexpr int RPT = 8;  // consecutive rows per thread
constexpr int TROWS = THREADS * RPT;
constexpr int SMEM_WORDS = TROWS + TROWS / 32;
constexpr uint32_t CLOSED = 0xFFFFFFFFu;
constexpr uint32_t NO_GROUP = 0xFFFFu;
constexpr uint32_t POS_ROW = 1u << 30;  // a position row: never an op

struct Params {
    long long m, tiles, input_len, cs;
    int depths, base_len, max_depth, group_depth;
};

// one padding word per 32 so that a thread's 8 consecutive rows and a
// warp's 32 strided rows both fall in distinct banks
__device__ __forceinline__ int sidx(int j) { return j + (j >> 5); }

// Depth and state word of one row's op; depth -1 when it is no op (a
// position, a depth outside 1..depths-1, or a flag other than 0 and 2).
__device__ __forceinline__ int row_op(uint32_t kp, int depths, uint32_t* word) {
    const uint32_t flag = kp >> 30, ln = (kp >> 25) & 0x1Fu;
    if ((flag != 0u && flag != 2u) || ln < 1u || (int)ln >= depths) return -1;
    *word = flag == 0u ? (kp & 0xFFFFu) + 1u : CLOSED;
    return (int)ln;
}

// Exclusive "latest op" scan of one state vector per thread over the block:
// ex[d] is the last non-zero v[d] among earlier threads (0 if none), tot[d]
// the block's last non-zero v[d].
__device__ __forceinline__ void block_scan_last(const uint32_t (&v)[ND], uint32_t (&ex)[ND],
                                                uint32_t (&tot)[ND]) {
    __shared__ uint32_t s_warp[32][ND];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    uint32_t inc[ND];
#pragma unroll
    for (int d = 0; d < ND; ++d) inc[d] = v[d];
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
#pragma unroll
        for (int d = 0; d < ND; ++d) {
            const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, inc[d], s);
            if (lane >= s && inc[d] == 0u) inc[d] = y;
        }
    }
    if (lane == 31) {
#pragma unroll
        for (int d = 0; d < ND; ++d) s_warp[warp][d] = inc[d];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
        for (int d = 0; d < ND; ++d) {
            uint32_t w = lane < nwarps ? s_warp[lane][d] : 0u;
#pragma unroll
            for (int s = 1; s < 32; s <<= 1) {
                const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, w, s);
                if (lane >= s && w == 0u) w = y;
            }
            if (lane < nwarps) s_warp[lane][d] = w;  // inclusive over warps
        }
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < ND; ++d) {
        uint32_t e = __shfl_up_sync(0xFFFFFFFFu, inc[d], 1);
        if (lane == 0) e = 0u;
        const uint32_t wp = warp > 0 ? s_warp[warp - 1][d] : 0u;
        ex[d] = e != 0u ? e : wp;
        tot[d] = s_warp[nwarps - 1][d];
    }
    __syncthreads();  // s_warp may be reused by the next call
}

// Stage one tile of a segment in shared memory (coalesced); rows past m
// read as position rows. With key2 given, also write each row's key2.
__device__ __forceinline__ void load_tile(const uint32_t* skp, long long base, long long row0,
                                          long long m, uint32_t* s, uint32_t* key2) {
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
        const int j = k * THREADS + threadIdx.x;
        const long long r = row0 + j;
        uint32_t v = POS_ROW;
        if (r < m) {
            v = skp[base + r];
            if (key2) key2[base + r] = (v >> 30) == 1u ? (v & 0x1FFFFFFu) : 0xFFFFFFFFu;
        }
        s[sidx(j)] = v;
    }
    __syncthreads();
}

// This thread's 8 rows from shared memory and their last op per depth.
__device__ __forceinline__ void thread_rows(const uint32_t* s, int depths, uint32_t (&kp)[RPT],
                                            uint32_t (&last)[ND]) {
#pragma unroll
    for (int d = 0; d < ND; ++d) last[d] = 0u;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        kp[i] = s[sidx(threadIdx.x * RPT + i)];
        uint32_t w = 0u;
        const int od = row_op(kp[i], depths, &w);
#pragma unroll
        for (int d = 0; d < ND; ++d)
            if (od == d) last[d] = w;
    }
}

__global__ void __launch_bounds__(THREADS) tile_last(const uint32_t* skp, Params P, uint32_t* agg) {
    __shared__ uint32_t s[SMEM_WORDS];
    const long long seg = blockIdx.x / P.tiles, tile = blockIdx.x % P.tiles;
    load_tile(skp, seg * P.m, tile * TROWS, P.m, s, nullptr);
    uint32_t kp[RPT], last[ND], ex[ND], tot[ND];
    thread_rows(s, P.depths, kp, last);
    block_scan_last(last, ex, tot);
    if (threadIdx.x == 0) {
#pragma unroll
        for (int d = 0; d < ND; ++d) agg[(long long)blockIdx.x * ND + d] = tot[d];
    }
}

// In place: each tile's last op per depth becomes the tile's carry-in.
__global__ void __launch_bounds__(THREADS) scan_tiles(Params P, uint32_t* agg) {
    const long long first = (long long)blockIdx.x * P.tiles;  // this segment's tiles
    const long long per = (P.tiles + THREADS - 1) / THREADS;
    const long long t0 = min((long long)threadIdx.x * per, P.tiles), t1 = min(t0 + per, P.tiles);
    uint32_t loc[ND], ex[ND], tot[ND];
#pragma unroll
    for (int d = 0; d < ND; ++d) loc[d] = 0u;
    for (long long j = t0; j < t1; ++j) {
#pragma unroll
        for (int d = 0; d < ND; ++d) {
            const uint32_t w = agg[(first + j) * ND + d];
            if (w != 0u) loc[d] = w;
        }
    }
    block_scan_last(loc, ex, tot);
    for (long long j = t0; j < t1; ++j) {
#pragma unroll
        for (int d = 0; d < ND; ++d) {
            const uint32_t w = agg[(first + j) * ND + d];
            agg[(first + j) * ND + d] = ex[d];
            if (w != 0u) ex[d] = w;
        }
    }
}

__global__ void __launch_bounds__(THREADS) apply(const uint32_t* skp, Params P, const uint32_t* carry,
                                                 uint32_t* packed, uint32_t* key2, uint32_t* gid) {
    __shared__ uint32_t s[SMEM_WORDS];
    const long long seg = blockIdx.x / P.tiles, tile = blockIdx.x % P.tiles;
    const long long base = seg * P.m, row0 = tile * TROWS;
    load_tile(skp, base, row0, P.m, s, key2);
    uint32_t kp[RPT], st[ND], ex[ND], tot[ND];
    thread_rows(s, P.depths, kp, st);
    block_scan_last(st, ex, tot);
#pragma unroll
    for (int d = 0; d < ND; ++d) {
        const uint32_t c = carry[(long long)blockIdx.x * ND + d];
        st[d] = ex[d] != 0u ? ex[d] : c;
    }
    uint32_t pk[RPT], gd[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        uint32_t w = 0u;
        const int od = row_op(kp[i], P.depths, &w);
#pragma unroll
        for (int d = 0; d < ND; ++d)
            if (od == d) st[d] = w;
        pk[i] = 0u;
        gd[i] = NO_GROUP;
        if ((kp[i] >> 30) != 1u) continue;
        const long long pos = kp[i] & 0x1FFFFFFu;
        const long long cend = min((pos / P.cs + 1) * P.cs, P.input_len);
        const long long limit = cend - pos;
#pragma unroll
        for (int d = 1; d < ND; ++d) {
            const bool open = d < P.depths && st[d] != 0u && st[d] != CLOSED;
            if (!open) continue;
            if (d == P.group_depth) gd[i] = st[d] - 1u;
            // ascending depth: the deepest fitting open wins
            if (d <= P.max_depth && P.base_len + d <= limit)
                pk[i] = ((uint32_t)(P.base_len + d) << 16) | (st[d] - 1u);
        }
    }
    // outputs through shared memory so that the stores are coalesced
    uint32_t* outs[2] = {packed, gid};
#pragma unroll
    for (int o = 0; o < 2; ++o) {
        __syncthreads();
#pragma unroll
        for (int i = 0; i < RPT; ++i) s[sidx(threadIdx.x * RPT + i)] = o == 0 ? pk[i] : gd[i];
        __syncthreads();
#pragma unroll
        for (int k = 0; k < RPT; ++k) {
            const int j = k * THREADS + threadIdx.x;
            if (row0 + j < P.m) outs[o][base + row0 + j] = s[sidx(j)];
        }
    }
}

long long tiles_of(long long m) { return (m + TROWS - 1) / TROWS; }

}  // namespace

extern "C" long long of_scratch_words(long long nseg, long long m) { return nseg * tiles_of(m) * ND; }

extern "C" int overlay_fit(const uint32_t* skp, long long nseg, long long m, long long input_len,
                           long long chunk_size, long long depths, long long base_len,
                           long long max_depth, long long group_depth, uint32_t* packed,
                           uint32_t* key2, uint32_t* gid, uint32_t* scratch, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (depths < 1 || depths > ND || group_depth >= depths || chunk_size < 1 || nseg < 0 || m < 0)
        return (int)cudaErrorInvalidValue;
    if (nseg == 0 || m == 0) return (int)cudaGetLastError();
    Params P{m, tiles_of(m), input_len, chunk_size, (int)depths, (int)base_len, (int)max_depth,
             (int)group_depth};
    const long long blocks = nseg * P.tiles;
    tile_last<<<(unsigned)blocks, THREADS, 0, s>>>(skp, P, scratch);
    scan_tiles<<<(unsigned)nseg, THREADS, 0, s>>>(P, scratch);
    apply<<<(unsigned)blocks, THREADS, 0, s>>>(skp, P, scratch, packed, key2, gid);
    return (int)cudaGetLastError();
}
