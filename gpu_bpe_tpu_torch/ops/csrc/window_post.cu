// window_post: candidate-window upkeep after one merge, the next winner and
// its certificate.
//
// Replaces the TPU kernel `_window_post_kernel` of
// gpu_bpe_tpu/ops/pallas_kernels.py:1094 (public entry `window_post`,
// pallas_kernels.py:1256), step by step (pallas_kernels.py:1138-1213):
// probe-count adoption, merged-pair zeroing, scratch append of the two
// sampled created pairs, histogram exclusion and the created-pair ceiling,
// the merge-log row, the scalar advances, and the next winner (count desc,
// then pair asc in unsigned order) with the certificate
// m2 > theta && m2 > ub_new2 && m2 >= 2.
//
// Bound on this card: bytes, and tiny: the window (2 x 256 x 8 B), the
// histograms (2 x 1 KB) and the merge log (3072 x 8 B) read once and
// written once, ~60 KB (~0.02 us at 3.35 TB/s); the launch itself costs
// more than the work.
//
// Design: one block of 256 threads, one window slot (and one histogram bin
// per side) per thread; the maxima and the unsigned winner pick are
// shared-memory tree reductions. The ceiling keeps the reference's f32
// arithmetic exactly: the subtraction, max * (1 + 4e-3) + 4 with separate
// rounding of the product and the sum (no fused multiply-add), the clamp
// above 2e9 and the truncating conversion.
#include <climits>

#include "common.cuh"

using namespace bpe;

namespace {

constexpr int NSC = 18 + 2 * N_PROBES;  // packed scalars, see ops/kernels.py

__device__ __forceinline__ int ceiling_from_max(float mx_bin) {
    const float slack = (float)(1.0 + 4e-3);
    const float mx = __fadd_rn(__fmul_rn(mx_bin, slack), 4.0f);
    return mx > 2e9f ? INT_MAX : (int)mx;
}

__global__ void window_post_kernel(const long long* sc, const long long* cand, const long long* counts,
                                   const float* bins_l, const float* bins_r, const long long* log,
                                   long long log_len, long long* cand_out, long long* counts_out,
                                   long long* log_out, long long* sout) {
    __shared__ float s_max[2][W_SLOTS];
    __shared__ long long s_cnt[W_SLOTS];
    __shared__ uint32_t s_pair[W_SLOTS];
    const int t = threadIdx.x;

    const uint32_t pair = as_u32(sc[0]);
    const long long count = sc[1];
    const uint32_t next_id = as_u32(sc[2]);
    const long long theta = sc[3], ub_new = sc[4];
    const int fill = (int)sc[5], md = (int)sc[6];
    const bool active = sc[7] != 0, early_in = sc[8] != 0, use_probes = sc[9] != 0;
    const long long naff = sc[10], c_l = sc[11], c_r = sc[12];
    const bool l_ok = sc[13] != 0, r_ok = sc[14] != 0;
    const uint32_t l_tok = as_u32(sc[15]), r_tok = as_u32(sc[16]);
    const bool has_room = sc[17] != 0;  // includes the active gate
    const long long* probes = sc + 18;
    const long long* pcnt = sc + 18 + N_PROBES;

    // ── maintained-count adoption from the fused probe counts ──
    const uint32_t c = as_u32(cand[t]);
    const long long cnt0 = counts[t];
    const bool live = cnt0 >= 0;
    const uint32_t a = pair >> 16, b = pair & TOKEN_MASK;
    const bool aff = live && ((c & TOKEN_MASK) == a || (c >> 16) == b) && c != pair;
    long long rec = 0;
    for (int k = 0; k < N_PROBES; ++k) {
        if (k < naff && c == as_u32(probes[k])) {
            const long long v = (long long)(int)as_u32(pcnt[k]);
            rec = v > rec ? v : rec;
        }
    }
    long long cnt = (aff && use_probes) ? rec : cnt0;
    if (live && c == pair) cnt = 0;

    // ── scratch append of the sampled created pairs ──
    const uint32_t z16 = next_id & TOKEN_MASK;
    const uint32_t l_pair = l_ok ? ((l_tok << 16) | z16) : 0xFFFFFFFFu;
    const uint32_t r_pair = r_ok ? ((z16 << 16) | r_tok) : 0xFFFFFFFFu;
    const int slot0 = has_room ? fill : W_SLOTS - 2;
    uint32_t c2 = c;
    if (has_room && t == slot0) {
        c2 = l_pair;
        cnt = l_ok ? c_l : -1;
    }
    if (has_room && t == slot0 + 1) {
        c2 = r_pair;
        cnt = r_ok ? c_r : -1;
    }
    cand_out[t] = c2;
    counts_out[t] = cnt;

    // ── histogram exclusion: thread t owns bin t of each side ──
    const int hl = bin_of(l_tok), hr = bin_of(r_tok);
    s_max[0][t] = t == hl ? __fsub_rn(bins_l[t], __ll2float_rn(c_l)) : bins_l[t];
    s_max[1][t] = t == hr ? __fsub_rn(bins_r[t], __ll2float_rn(c_r)) : bins_r[t];
    s_cnt[t] = cnt;
    __syncthreads();
    for (int d = W_SLOTS / 2; d > 0; d >>= 1) {
        if (t < d) {
            s_max[0][t] = fmaxf(s_max[0][t], s_max[0][t + d]);
            s_max[1][t] = fmaxf(s_max[1][t], s_max[1][t + d]);
            s_cnt[t] = max(s_cnt[t], s_cnt[t + d]);
        }
        __syncthreads();
    }
    const long long m2 = s_cnt[0];
    // next winner: smallest unsigned pair among the slots at the max count
    s_pair[t] = cnt == m2 ? c2 : 0xFFFFFFFFu;
    __syncthreads();
    for (int d = W_SLOTS / 2; d > 0; d >>= 1) {
        if (t < d) s_pair[t] = min(s_pair[t], s_pair[t + d]);
        __syncthreads();
    }

    // ── merge-log row (a neutralized pass writes past md2, never read) ──
    for (long long i = t; i < log_len; i += blockDim.x) {
        long long v = log[i];
        if (i == 3LL * md) v = pair;
        if (i == 3LL * md + 1) v = next_id;
        if (i == 3LL * md + 2) v = (long long)(uint32_t)(unsigned long long)count;
        log_out[i] = v;
    }

    if (t == 0) {
        const long long ub_l = ceiling_from_max(s_max[0][0]);
        const long long ub_r = ceiling_from_max(s_max[1][0]);
        long long ub_merge = active ? (ub_l > ub_r ? ub_l : ub_r) : 0;
        const long long ub_new2 = ub_new > ub_merge ? ub_new : ub_merge;
        const int adv = active ? 1 : 0;
        sout[0] = md + adv;
        sout[1] = has_room ? fill + 2 : fill;
        sout[2] = (early_in || !active) ? 1 : 0;
        sout[3] = ub_new2;
        sout[4] = m2;
        sout[5] = (m2 > theta && m2 > ub_new2 && m2 >= 2) ? 1 : 0;
        sout[6] = (long long)(uint32_t)(next_id + (uint32_t)adv);
        sout[7] = (long long)s_pair[0];
    }
}

}  // namespace

extern "C" int window_post(const long long* sc, const long long* cand, const long long* counts,
                           const float* bins_l, const float* bins_r, const long long* log,
                           long long log_len, long long* cand_out, long long* counts_out,
                           long long* log_out, long long* sout, void* stream) {
    static_assert(NSC == 146, "scalar layout shared with ops/kernels.py");
    window_post_kernel<<<1, W_SLOTS, 0, static_cast<cudaStream_t>(stream)>>>(
        sc, cand, counts, bins_l, bins_r, log, log_len, cand_out, counts_out, log_out, sout);
    return (int)cudaGetLastError();
}
