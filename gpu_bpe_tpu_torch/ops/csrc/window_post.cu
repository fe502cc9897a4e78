// window_post: candidate-window upkeep after one merge, the next winner and
// its certificate.
//
// Replaces the TPU kernel `_window_post_kernel` of
// gpu_bpe_tpu/ops/pallas_kernels.py:1094 (pallas_call :1219, public entry
// `window_post` :1256), step by step (pallas_kernels.py:1138-1213):
// probe-count adoption, merged-pair zeroing, scratch append of the two
// sampled created pairs, histogram exclusion and the created-pair ceiling,
// the merge-log row, the scalar advances, and the next winner (count desc,
// then pair asc in unsigned order) with the certificate
// m2 > theta && m2 > ub_new2 && m2 >= 2.
//
// Bound on this card: bytes, and tiny: the window (2 x 256 x 8 B), the
// histograms (2 x 1 KB) and the merge log (3072 x 8 B) read once and
// written once, ~60 KB (~0.02 us at 3.35 TB/s), below the cost of any
// launch. What costs is the launch and the host work around it: the kernel
// runs once per merge in a host-driven loop.
//
// Design: one launch per call and nothing else on the device. The 18
// scalars are read where they already live (0-d int64 or bool tensors,
// views included): the wrapper passes their addresses and element sizes by
// value in `ScalarRefs`, in ops/kernels.py's _SCALAR_ORDER, and the probe
// pairs and counts by pointer, so no packing, conversion or concatenation
// runs before the launch. One block of 256 threads, one window slot and one
// histogram bin per side per thread; 18 lanes read the scalars and 128
// threads stage the probes in shared memory (one barrier). The two
// histogram maxima and the next winner are one warp-shuffle pass each warp
// (the winner as a lexicographic (count desc, pair asc) pick on the int64
// count and the u32 pair, exact for any count), then one barrier and a pass
// over the 8 warp results. The ceiling keeps the reference's f32 arithmetic
// exactly: the subtraction, max * (1 + 4e-3) + 4 with separate rounding of
// the product and the sum (no fused multiply-add), the clamp above 2e9 and
// the truncating conversion. Outputs are out of place: the rare wide merge
// calls the kernel again on the same pre-merge window and log.
#include <climits>
#include <cstring>

#include "common.cuh"

using namespace bpe;

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int WARPS = W_SLOTS / 32;
constexpr int N_SCALARS = 18;
// indices into ScalarRefs, in ops/kernels.py's _SCALAR_ORDER
enum Scalar {
    PAIR, COUNT, NEXT_ID, THETA, UB_NEW, FILL, MERGES_DONE, ACTIVE, EARLY_STOP, USE_PROBES, N_AFF, C_L,
    C_R, L_OK, R_OK, L_TOK, R_TOK, HAS_ROOM,
};
static_assert(HAS_ROOM + 1 == N_SCALARS, "scalar order shared with ops/kernels.py");

}  // namespace

// Where each scalar lives on the device and its element size in bytes
// (1 for a bool, 8 for an int64); packed by ops/kernels.py as _REFS.
struct ScalarRefs {
    const void* ptr[N_SCALARS];
    int size[N_SCALARS];
};
static_assert(sizeof(ScalarRefs) == 8 * N_SCALARS + 4 * N_SCALARS, "layout of ops/kernels.py _REFS");

namespace {

__device__ __forceinline__ int ceiling_from_max(float mx_bin) {
    const float slack = (float)(1.0 + 4e-3);
    const float mx = __fadd_rn(__fmul_rn(mx_bin, slack), 4.0f);
    return mx > 2e9f ? INT_MAX : (int)mx;
}

// (count, pair) of b replaces a's when its count is larger, or equal with a
// smaller unsigned pair
__device__ __forceinline__ void pick_winner(long long& cnt, uint32_t& pair, long long ocnt, uint32_t opair) {
    if (ocnt > cnt || (ocnt == cnt && opair < pair)) {
        cnt = ocnt;
        pair = opair;
    }
}

__global__ void __launch_bounds__(W_SLOTS)
window_post_kernel(ScalarRefs refs, const long long* probes, const long long* pcnt, const long long* cand,
                   const long long* counts, const float* bins_l, const float* bins_r, const long long* log,
                   long long log_len, long long* cand_out, long long* counts_out, long long* log_out,
                   long long* sout) {
    __shared__ long long s_sc[N_SCALARS];
    __shared__ uint32_t s_probe[N_PROBES];
    __shared__ int s_pcnt[N_PROBES];
    __shared__ float s_max[2][WARPS];
    __shared__ long long s_cnt[WARPS];
    __shared__ uint32_t s_pair[WARPS];
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

    if (t < N_SCALARS) {
        const void* p = refs.ptr[0];
        int size = refs.size[0];
#pragma unroll
        for (int i = 1; i < N_SCALARS; ++i)
            if (t == i) {
                p = refs.ptr[i];
                size = refs.size[i];
            }
        s_sc[t] = size == 1 ? (long long)*static_cast<const unsigned char*>(p) : *static_cast<const long long*>(p);
    } else if (t >= 32 && t < 32 + N_PROBES) {
        s_probe[t - 32] = as_u32(probes[t - 32]);
    } else if (t >= 32 + N_PROBES && t < 32 + 2 * N_PROBES) {
        s_pcnt[t - 32 - N_PROBES] = (int)as_u32(pcnt[t - 32 - N_PROBES]);
    }
    const uint32_t c = as_u32(cand[t]);
    const long long cnt0 = counts[t];
    const float bin_l = bins_l[t], bin_r = bins_r[t];
    __syncthreads();

    const uint32_t pair = as_u32(s_sc[PAIR]);
    const long long count = s_sc[COUNT];
    const uint32_t next_id = as_u32(s_sc[NEXT_ID]);
    const long long theta = s_sc[THETA], ub_new = s_sc[UB_NEW];
    const int fill = (int)s_sc[FILL], md = (int)s_sc[MERGES_DONE];
    const bool active = s_sc[ACTIVE] != 0, early_in = s_sc[EARLY_STOP] != 0, use_probes = s_sc[USE_PROBES] != 0;
    const long long naff = s_sc[N_AFF], c_l = s_sc[C_L], c_r = s_sc[C_R];
    const bool l_ok = s_sc[L_OK] != 0, r_ok = s_sc[R_OK] != 0;
    const uint32_t l_tok = as_u32(s_sc[L_TOK]), r_tok = as_u32(s_sc[R_TOK]);
    const bool has_room = s_sc[HAS_ROOM] != 0;  // includes the active gate

    // ── maintained-count adoption from the fused probe counts ──
    const bool live = cnt0 >= 0;
    const uint32_t a = pair >> 16, b = pair & TOKEN_MASK;
    const bool aff = live && ((c & TOKEN_MASK) == a || (c >> 16) == b) && c != pair;
    long long rec = 0;
    for (int k = 0; k < N_PROBES; ++k) {
        if (k < naff && c == s_probe[k]) {
            const long long v = s_pcnt[k];
            rec = v > rec ? v : rec;
        }
    }
    long long cnt = (aff && use_probes) ? rec : cnt0;
    if (live && c == pair) cnt = 0;

    // ── scratch append of the sampled created pairs ──
    const uint32_t z16 = next_id & TOKEN_MASK;
    const uint32_t l_pair = l_ok ? ((l_tok << 16) | z16) : 0xFFFFFFFFu;
    const uint32_t r_pair = r_ok ? ((z16 << 16) | r_tok) : 0xFFFFFFFFu;
    uint32_t c2 = c;
    if (has_room && t == fill) {
        c2 = l_pair;
        cnt = l_ok ? c_l : -1;
    }
    if (has_room && t == fill + 1) {
        c2 = r_pair;
        cnt = r_ok ? c_r : -1;
    }
    cand_out[t] = c2;
    counts_out[t] = cnt;

    // ── histogram exclusion (thread t owns bin t of each side), the two
    //    maxima and the next winner: one shuffle pass per warp ──
    float ml = t == bin_of(l_tok) ? __fsub_rn(bin_l, __ll2float_rn(c_l)) : bin_l;
    float mr = t == bin_of(r_tok) ? __fsub_rn(bin_r, __ll2float_rn(c_r)) : bin_r;
    long long wc = cnt;
    uint32_t wp = c2;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
        ml = fmaxf(ml, __shfl_xor_sync(FULL, ml, d));
        mr = fmaxf(mr, __shfl_xor_sync(FULL, mr, d));
        const long long oc = __shfl_xor_sync(FULL, wc, d);
        const uint32_t op = __shfl_xor_sync(FULL, wp, d);
        pick_winner(wc, wp, oc, op);
    }
    if (lane == 0) {
        s_max[0][warp] = ml;
        s_max[1][warp] = mr;
        s_cnt[warp] = wc;
        s_pair[warp] = wp;
    }

    // ── merge-log row (a neutralized pass writes past md2, never read) ──
    for (long long i = t; i < log_len; i += W_SLOTS) {
        long long v = log[i];
        if (i == 3LL * md) v = pair;
        if (i == 3LL * md + 1) v = next_id;
        if (i == 3LL * md + 2) v = (long long)(uint32_t)(unsigned long long)count;
        log_out[i] = v;
    }
    __syncthreads();

    if (t == 0) {
        float mx_l = s_max[0][0], mx_r = s_max[1][0];
        long long m2 = s_cnt[0];
        uint32_t pend_pair = s_pair[0];
        for (int w = 1; w < WARPS; ++w) {
            mx_l = fmaxf(mx_l, s_max[0][w]);
            mx_r = fmaxf(mx_r, s_max[1][w]);
            pick_winner(m2, pend_pair, s_cnt[w], s_pair[w]);
        }
        const long long ub_l = ceiling_from_max(mx_l);
        const long long ub_r = ceiling_from_max(mx_r);
        const long long ub_merge = active ? (ub_l > ub_r ? ub_l : ub_r) : 0;
        const long long ub_new2 = ub_new > ub_merge ? ub_new : ub_merge;
        const int adv = active ? 1 : 0;
        sout[0] = md + adv;
        sout[1] = has_room ? fill + 2 : fill;
        sout[2] = (early_in || !active) ? 1 : 0;
        sout[3] = ub_new2;
        sout[4] = m2;
        sout[5] = (m2 > theta && m2 > ub_new2 && m2 >= 2) ? 1 : 0;
        sout[6] = (long long)(uint32_t)(next_id + (uint32_t)adv);
        sout[7] = (long long)pend_pair;
    }
}

}  // namespace

// refs: a host block holding one ScalarRefs (ops/kernels.py _REFS), passed
// to the launch by value; probes / pcnt: int64 [N_PROBES] on the device.
extern "C" int window_post(const void* refs, const long long* probes, const long long* pcnt,
                           const long long* cand, const long long* counts, const float* bins_l,
                           const float* bins_r, const long long* log, long long log_len, long long* cand_out,
                           long long* counts_out, long long* log_out, long long* sout, void* stream) {
    ScalarRefs r;
    memcpy(&r, refs, sizeof r);
    window_post_kernel<<<1, W_SLOTS, 0, static_cast<cudaStream_t>(stream)>>>(
        r, probes, pcnt, cand, counts, bins_l, bins_r, log, log_len, cand_out, counts_out, log_out, sout);
    return (int)cudaGetLastError();
}
