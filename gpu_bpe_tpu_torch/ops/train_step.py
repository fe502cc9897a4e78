"""Device-resident BPE training step (single device, fused-window structure).

Counterpart of the single-chip fused structure of
``gpu_bpe_tpu/ops/train_step.py``. The winner of each merge is the global
weighted argmax pair with the reference tie-break (count desc, pair id asc,
unsigned). It is certified from a 256-slot candidate window whose exact
counts are maintained across merges: a merge (a,b) -> Z can only change
counts of pairs ending in a, starting with b, equal to (a,b) or containing
Z (proof in the reference's ``_post_counts``), so each merge recounts just
that affected subset inside the merge kernel. When the certificate fails,
``_ensure_pending`` runs a full sort-based recount: one monolithic sort
below capacity 2^22, the two-level segmented recount (``compact_mask`` on
the per-segment run summaries) from there on. The merge list is bitwise
equal to recounting before every merge (``force_recount=True``).

Each certified merge launches the three kernels of ``ops/kernels.py``:
``merge_compact_tracked`` (merge, compaction, created-pair tracking, probe
counts), ``count_pairs2`` (exact counts of the two sampled created pairs)
and ``window_post`` (window upkeep, next winner, certificate). Between them
everything stays on the device; the Python loop reads one small vector per
merge to decide whether to go on (a second read only in the rare merge that
affects more than ``N_PROBES`` window slots), and a segmented recount reads
its summary count once to pick its tier.

With ``multi_merge=True`` (the reference's ``GPU_BPE_TPU_MULTI``) the batch
runs the classic iteration ``_one_merge`` instead: the winner, the second
and the third candidate from the maintained window counts, an inline full
recount when the certificate fails, and up to three merges that share one
certificate decision and one host read (``_merge_and_track``: the window
mode of ``merge_compact_tracked``, ``count_pairs2`` and torch ops, no
``window_post``). The merge list is the same in either mode.

There is no ``jit``: data-dependent loops are Python loops around kernel
launches. Every tensor of ``TrainState`` lives on one device.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from ..constants import BATCH_MERGES, TOKEN_MASK, WORD_START_BIT
from ..utils.timing import span
from .kernels import (
    I32_MAX,
    INVALID,
    N_PROBES,
    W_SLOTS,
    _to_i32,
    bin_index,
    compact_mask,
    count_pairs2,
    merge_compact,
    merge_compact_tracked,
    window_post,
)

# Lazy-candidate window: tracked top pairs from the last recount plus
# append-only scratch slots for created pairs sampled since (2 per merge).
K_CANDIDATES = 128
S_CREATED = 128
assert K_CANDIDATES + S_CREATED == W_SLOTS
_NO_EXCL = 0x10000  # 17-bit sentinel: matches no 16-bit token
# Capacity below which the mid-batch collapse stop is disabled.
_MIN_SHRINK_CAP = 4096

# Host reads of the single-device loops by site: "batch" (one per batch),
# "merge" (one per certified merge of the default loop), "iteration" (one
# per multi-merge iteration), "wide" (the redo after a merge that affects
# more than N_PROBES window slots), "seg_recount" (the segmented recount's
# tier); the trainer adds "summary" per batch. clear() to reset.
HOST_READS: Counter = Counter()


@dataclass
class TrainState:
    """Device-side iteration state (the reference's IterState). Scalars are
    0-d int64 tensors (flags 0/1); pair ids hold unsigned 32-bit values."""

    symbols: torch.Tensor  # int32 [cap] — tok | word-start bit; 0 past n
    weights: torch.Tensor  # int32 [cap] — word frequency per position
    n: torch.Tensor  # live symbol count
    next_id: torch.Tensor  # next token id to assign
    early_stop: torch.Tensor
    merges_done: torch.Tensor  # merges done this batch
    merge_log: torch.Tensor  # int64 [BATCH_MERGES * 3] — (pair, new_id, count) rows
    cand: torch.Tensor  # int64 [W_SLOTS] tracked pairs (INVALID when dead)
    cand_counts: torch.Tensor  # int64 [W_SLOTS] EXACT live counts, -1 when dead
    theta: torch.Tensor  # ceiling on every untracked pair present at the last recount
    ub_new: torch.Tensor  # ceiling on pairs created since the last recount
    recounts: torch.Tensor  # full recounts performed (diagnostics)
    fill: torch.Tensor  # next free created-pair scratch slot
    duals: torch.Tensor  # second and third merges of a multi-merge iteration
    pend_pair: torch.Tensor  # next winner, computed by the previous window_post
    pend_count: torch.Tensor
    pend_cert: torch.Tensor  # 0 forces a full recount before the next merge


def _i64(x, device) -> torch.Tensor:
    return torch.tensor(int(x), dtype=torch.int64, device=device)


def init_state(symbols, weights, n: int, next_id: int, device="cuda") -> TrainState:
    """State for a padded stream (``symbols`` uint32 / ``weights`` int32 numpy
    arrays of the capacity's length, or int32 tensors, zero past ``n``)."""
    dev = torch.device(device)
    if isinstance(symbols, torch.Tensor):
        sym, w = symbols.to(device=dev, dtype=torch.int32), weights.to(device=dev, dtype=torch.int32)
    else:
        sym = torch.as_tensor(np.asarray(symbols, dtype=np.uint32).astype(np.int32)).to(dev)
        w = torch.as_tensor(np.asarray(weights, dtype=np.int32)).to(dev)
    return TrainState(
        symbols=sym,
        weights=w,
        n=_i64(n, dev),
        next_id=_i64(next_id, dev),
        early_stop=_i64(0, dev),
        merges_done=_i64(0, dev),
        merge_log=torch.zeros(BATCH_MERGES * 3, dtype=torch.int64, device=dev),
        cand=torch.full((W_SLOTS,), INVALID, dtype=torch.int64, device=dev),
        cand_counts=torch.full((W_SLOTS,), -1, dtype=torch.int64, device=dev),
        theta=_i64(2**31 - 1, dev),  # forces a recount first
        ub_new=_i64(0, dev),
        recounts=_i64(0, dev),
        fill=_i64(K_CANDIDATES, dev),
        duals=_i64(0, dev),
        pend_pair=_i64(0, dev),
        pend_count=_i64(-1, dev),
        pend_cert=_i64(0, dev),
    )


def _pair_ids(symbols: torch.Tensor, n):
    """Packed pair ids (int64, 0 where invalid) of a hole-free stream and
    their validity: pair (p, p+1) counts iff p < n-1, the successor lacks
    the word-start bit and neither token is 0 (train.wgsl:393-399)."""
    s = symbols.to(torch.int64)
    nxt = torch.cat([s[1:], s.new_zeros(1)])
    tok, ntok = s & TOKEN_MASK, nxt & TOKEN_MASK
    iota = torch.arange(s.shape[0], device=s.device)
    valid = (iota < n - 1) & ((nxt & WORD_START_BIT) == 0) & (tok != 0) & (ntok != 0)
    return torch.where(valid, (tok << 16) | ntok, 0), valid


def _run_totals(sp: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """Per-run weight totals of a sorted pair stream, placed at run ends (0
    elsewhere and for the invalid pair id 0). The int64 prefix sum gives
    each run's exact mass; it is wrapped to i32 as the reference's u32
    difference cast is, so results agree at the envelope's edge."""
    m = sp.shape[0]
    is_end = torch.ones(m, dtype=torch.bool, device=sp.device)
    is_end[:-1] = sp[:-1] != sp[1:]
    csum = torch.cumsum(sw, 0)
    iota = torch.arange(1, m + 1, device=sp.device)
    end_pos1 = torch.where(is_end, iota, 0)  # 1-based end positions
    prev_end1 = torch.cat([end_pos1.new_zeros(1), torch.cummax(end_pos1, 0).values[:-1]])
    prev_csum = torch.where(prev_end1 > 0, csum[(prev_end1 - 1).clamp(min=0)], 0)
    run = (csum - prev_csum) & 0xFFFFFFFF
    run = torch.where(run >= 2**31, run - 2**32, run)
    return torch.where(is_end & (sp != 0), run, 0)


def _pick_window(sp: torch.Tensor, run_total: torch.Tensor):
    """Winner + fresh candidate window + theta from a sorted pair stream
    with per-run totals at run ends. Candidate picks use an exact
    ``topk``; any pick is sound because theta is the EXACT max count over
    the untracked pairs."""
    bc = run_total.max()
    bp = torch.where((run_total == bc) & (sp != 0), sp, INVALID).min()
    bp = torch.where(bc > 0, bp, 0)
    picked, ai = torch.topk(run_total, K_CANDIDATES)
    # a pick with run_total == 0 is not a run end (fewer than K distinct
    # pairs): its sp is some run's interior — leave the slot dead
    ok = picked > 0
    cand = torch.where(ok, sp[ai], INVALID)
    counts = torch.where(ok, picked, -1)
    cand[0], counts[0] = bp, bc
    theta = torch.where(torch.isin(sp, cand), 0, run_total).max()
    cand = torch.cat([cand, cand.new_full((S_CREATED,), INVALID)])
    counts = torch.cat([counts, counts.new_full((S_CREATED,), -1)])
    return bp, bc, cand, counts, theta


def find_best_pair(symbols: torch.Tensor, weights: torch.Tensor, n):
    """Exact weighted argmax pair of a hole-free stream, the single-call
    API: ``(pair, count)`` as 0-d int64 tensors, count descending then pair
    id ascending; ``(0, 0)`` when no pair is live. One sort of the pair ids
    and their run totals."""
    pair, valid = _pair_ids(symbols, n)
    sp, order = torch.sort(pair)
    run_total = _run_totals(sp, torch.where(valid, weights.to(torch.int64), 0)[order])
    bc = run_total.max()
    bp = torch.where((run_total == bc) & (sp != 0), sp, INVALID).min()
    return torch.where(bc > 0, bp, 0), bc


def apply_merge_device(symbols: torch.Tensor, weights: torch.Tensor, n, pair, new_id):
    """One merge ``pair`` -> ``new_id`` with immediate compaction of a
    hole-free int32 stream: ``(symbols', weights', n')``, zero past ``n'``.
    The probe-less ``merge_compact`` kernel on the card, its plain version
    for CPU tensors."""
    return merge_compact(symbols, weights, n, pair, new_id)


# From this capacity on the recount runs the two-level segmented scheme
# (the reference's gate and segment length; tests lower both). On an H100
# it beats the monolithic sort at every capacity from 2^22 to 2^25
# (chip_smoke.py's recount_timing: 4.8 against 15.2 ms at 2^22).
_SEG_RECOUNT_MIN_CAP = 1 << 22
_SEG_RECOUNT_M = 1 << 17

# Full recounts by path: "monolithic", or the segmented recount's tier
# ("seg_cap/8", "seg_cap/2", "seg_fallback"); clear() to reset.
RECOUNTS: Counter = Counter()


def _run_totals_reset(sp: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """Per-run totals of a ``[nseg, m]`` segment-sorted pair stream, at run
    ends (0 elsewhere and for pair id 0); runs break at row boundaries.

    Gather-free: weights are >= 0, so the int64 prefix sum of a row never
    falls, and the mass before each run's start, carried forward to its
    end, is one ``cummax`` of the start values. Each run's exact mass is
    wrapped to i32 as ``_run_totals`` wraps it."""
    start = torch.ones_like(sp, dtype=torch.bool)
    start[:, 1:] = sp[:, 1:] != sp[:, :-1]
    is_end = torch.ones_like(start)
    is_end[:, :-1] = start[:, 1:]
    csum = torch.cumsum(sw, 1)
    before = torch.cummax(torch.where(start, csum - sw, 0), 1).values
    run = _to_i32(csum - before)
    return torch.where(is_end & (sp != 0), run, 0)


def _recount_monolithic(pair: torch.Tensor, w: torch.Tensor):
    sp, order = torch.sort(pair)
    return _pick_window(sp, _run_totals(sp, w[order]))


def _full_recount_segmented(pair: torch.Tensor, w: torch.Tensor, cap: int):
    """Two-level exact recount: sort each ``_SEG_RECOUNT_M``-row segment
    (one batched sort), take per-segment run totals, compact the (pair,
    count) run summaries with ``compact_mask`` and combine them with one
    smaller sort over the first cap/8 or cap/2 summaries (the monolithic
    sort when there are more). Every count is an exact sum, so winner,
    count and theta equal the monolithic recount's; candidate picks may
    differ, which moves certificate windows, never a merge.

    The tier is chosen on the host: one read of the summary count per
    recount. Returns (tier, recount): the ``RECOUNTS`` key it bumped, and
    the recount."""
    m = _SEG_RECOUNT_M
    sp, order = torch.sort(pair.reshape(cap // m, m), dim=1)
    rt = _run_totals_reset(sp, torch.gather(w.reshape(cap // m, m), 1, order))
    flat_rt = rt.reshape(-1)
    # the primary word keeps only its low 16 bits: pair id and count ride
    # as extras, as their u32 bit patterns
    prim = torch.where(flat_rt > 0, 0, -1).to(torch.int32)
    (_, sp_c, rt_c), total = compact_mask(
        prim, (_to_i32(sp.reshape(-1)).to(torch.int32), flat_rt.to(torch.int32)),
    )
    with span("train.read", "seg_recount"):
        cnt = int(total)
    HOST_READS["seg_recount"] += 1
    for rcap, tier in ((cap >> 3, "seg_cap/8"), (cap >> 1, "seg_cap/2")):
        if cnt <= rcap:
            RECOUNTS[tier] += 1
            live = torch.arange(rcap, device=pair.device) < cnt
            sp2 = torch.where(live, sp_c[:rcap].to(torch.int64) & 0xFFFFFFFF, 0)
            c2 = torch.where(live, rt_c[:rcap].to(torch.int64), 0)
            return tier, _recount_monolithic(sp2, c2)
    RECOUNTS["seg_fallback"] += 1
    return "seg_fallback", _recount_monolithic(pair, w)


def _full_recount_impl(symbols: torch.Tensor, weights: torch.Tensor, n):
    """Exact full recount: (best_pair, count, cand, counts, theta). From
    capacity ``_SEG_RECOUNT_MIN_CAP`` on (a multiple of ``_SEG_RECOUNT_M``)
    it runs the segmented scheme, below it one monolithic sort. The span's
    ``tier`` is the ``RECOUNTS`` key the recount bumped."""
    with span("train.recount") as sp:
        pair, valid = _pair_ids(symbols, n)
        w = torch.where(valid, weights.to(torch.int64), 0)
        cap = symbols.shape[0]
        if cap >= _SEG_RECOUNT_MIN_CAP and cap % _SEG_RECOUNT_M == 0:
            tier, out = _full_recount_segmented(pair, w, cap)
        else:
            tier, out = "monolithic", _recount_monolithic(pair, w)
            RECOUNTS[tier] += 1
        sp.note(tier=tier)
        return out


def _ensure_pending(st: TrainState, certified: bool) -> TrainState:
    """Refresh the pending winner with a full recount unless the carried
    certificate holds (``certified`` is the host's copy of ``pend_cert``)."""
    if certified:
        return st
    bp, bc, cand, counts, theta = _full_recount_impl(st.symbols, st.weights, st.n)
    dev = st.n.device
    return replace(
        st, pend_pair=bp, pend_count=bc, cand=cand, cand_counts=counts, theta=theta,
        ub_new=_i64(0, dev), fill=_i64(K_CANDIDATES, dev), pend_cert=_i64(1, dev),
        recounts=st.recounts + 1,
    )


def _post_counts(cand, counts, merged_pair, l_slot, r_slot, sym2, w2, n2):
    """Dense window recount on the post-merge stream, for the rare merge
    that affects more than ``N_PROBES`` slots: exact counts of every window
    pair and of the two sampled created pairs (sentinel 1 counts 0).
    ``searchsorted`` into the sorted window plus an int64 scatter-add keeps
    it O(cap log W) in time and O(cap) in memory."""
    pair2, valid = _pair_ids(sym2, n2)
    w2m = torch.where(valid, w2.to(torch.int64), 0)
    lst = torch.cat([cand, l_slot.reshape(1), r_slot.reshape(1)])
    slst = torch.sort(lst).values
    idx = torch.searchsorted(slst, pair2).clamp_(max=slst.shape[0] - 1)
    hit = slst[idx] == pair2
    sums = torch.zeros_like(slst).index_add_(0, idx, torch.where(hit, w2m, 0))
    cnt = sums[torch.searchsorted(slst, lst)]
    live = counts >= 0
    counts2 = torch.where(live, cnt[:W_SLOTS], counts)
    counts2 = torch.where(live & (cand == merged_pair), 0, counts2)
    return counts2, cnt[W_SLOTS], cnt[W_SLOTS + 1]


def _gate(st: TrainState):
    """(active, effective pair, has_room) of the next merge. A stop (count
    < 2 or ids exhausted) runs the kernels once with the no-op pair 0 and
    every state change gated off."""
    active = (st.pend_count >= 2) & (st.next_id <= TOKEN_MASK)
    pair_eff = torch.where(active, st.pend_pair, 0)
    has_room = (st.fill <= W_SLOTS - 2) & active
    return active, pair_eff, has_room


def _affected(cand, counts, pair) -> torch.Tensor:
    """Live window slots whose pair ends in a or starts with b, other than
    (a,b) itself: the only counts merging (a,b) can change but its own."""
    a, b = pair >> 16, pair & TOKEN_MASK
    return (counts >= 0) & (((cand & TOKEN_MASK) == a) | ((cand >> 16) == b)) & (cand != pair)


def _decision(cand, counts) -> torch.Tensor:
    """(m, winner, m2, q, m3, r3, n_aff(winner)) of a window: the best,
    second and third tracked candidates (count desc, pair asc) and the
    number of slots merging the winner affects."""
    m = counts.max()
    winner = torch.where(counts == m, cand, INVALID).min()
    c2 = torch.where(cand == winner, -1, counts)
    m2 = c2.max()
    q = torch.where(c2 == m2, cand, INVALID).min()
    c3 = torch.where(cand == q, -1, c2)
    m3 = c3.max()
    r3 = torch.where(c3 == m3, cand, INVALID).min()
    return torch.stack([m, winner, m2, q, m3, r3, _affected(cand, counts, winner).sum()])


class _Plan(NamedTuple):
    certified: bool
    dual_pre: bool
    triple_pre: bool


def _plan(dec: list[int], theta: int, ub: int, nid: int, md: int, batch_merges: int) -> _Plan:
    """The certificate of the winner and the preconditions of the dual and
    triple merges (the reference's ``_one_merge``), on the host."""
    m, w, m2, q, m3, r3 = dec[:6]
    certified = m > theta and m > ub and m >= 2
    first, second, third = {w >> 16, w & TOKEN_MASK}, {q >> 16, q & TOKEN_MASK}, {r3 >> 16, r3 & TOKEN_MASK}
    dual_pre = (certified and not first & second and m2 >= 2 and m2 > theta and m2 > ub
                and nid + 1 <= TOKEN_MASK and md + 2 <= batch_merges)
    triple_pre = (dual_pre and not (first | second) & third and m3 >= 2 and m3 > theta and m3 > ub
                  and nid + 2 <= TOKEN_MASK and md + 3 <= batch_merges)
    return _Plan(certified, dual_pre, triple_pre)


def _ub_from_bins(bins: torch.Tensor) -> torch.Tensor:
    """Sound i32 ceiling per row of f32 bins: the max bin times (1 + 4e-3)
    plus 4 in f32 (product and sum rounded separately), i32 max above 2e9
    (the reference's ``_ub_from_bins``)."""
    one = torch.ones((), dtype=torch.float32, device=bins.device)
    mx = bins.max(dim=-1).values * (one * (1.0 + 4e-3)) + one * 4.0
    return torch.where(mx > 2e9, I32_MAX, mx.to(torch.int64))


def _sampled_pairs(st: TrainState, samp: torch.Tensor, has_room: torch.Tensor) -> dict:
    """The two sampled created pairs of a merge: their window_post flags and
    tokens, and their slots for ``count_pairs2`` (sentinel pair 1 when not
    sampled). Token-0 guard: a pair with a zero member is never counted by
    the pair stream, so it is left unsampled (its mass stays in the
    ceiling)."""
    z16 = st.next_id & TOKEN_MASK
    l_ok = has_room & (samp[0] > 0) & (samp[1] != 0)
    r_ok = has_room & (samp[2] > 0) & (samp[3] != 0)
    l_tok = torch.where(l_ok, samp[1], _NO_EXCL)
    r_tok = torch.where(r_ok, samp[3], _NO_EXCL)
    return dict(
        l_ok=l_ok, r_ok=r_ok, l_tok=l_tok, r_tok=r_tok,
        l_slot=torch.where(l_ok, (l_tok << 16) | z16, 1),
        r_slot=torch.where(r_ok, (z16 << 16) | r_tok, 1),
    )


def _one_merge_fused_certified(st: TrainState, force_recount: bool = False):
    """One merge over the already-certified pending winner.

    Returns ``(state, host)`` where ``host`` is the one small vector read
    back per merge, as Python ints: (merges_done, fill, early_stop, ub_new,
    pend_count, pend_cert, next_id, pend_pair, n, n_aff)."""
    active, pair_eff, has_room = _gate(st)
    sym2, w2, n_new, bins_l, bins_r, samp, pcnt, probes, n_aff = merge_compact_tracked(
        st.symbols, st.weights, st.n, pair_eff, st.next_id, st.cand, st.cand_counts,
    )
    sampled = _sampled_pairs(st, samp, has_room)
    l_slot, r_slot = sampled.pop("l_slot"), sampled.pop("r_slot")
    cnt2 = count_pairs2(sym2, w2, n_new, l_slot, r_slot)
    scalars = dict(
        pair=pair_eff, count=st.pend_count, next_id=st.next_id, theta=st.theta,
        ub_new=st.ub_new, fill=st.fill, merges_done=st.merges_done, active=active,
        early_stop=st.early_stop, use_probes=n_aff <= N_PROBES, n_aff=n_aff,
        c_l=cnt2[0], c_r=cnt2[1], has_room=has_room, **sampled,
    )
    cand2, counts3, log2, sout = window_post(
        st.cand, st.cand_counts, bins_l, bins_r, st.merge_log, probes=probes, pcnt=pcnt, **scalars,
    )
    with span("train.read", "merge"):
        host = torch.cat([sout, n_new.reshape(1), n_aff.reshape(1)]).tolist()
    HOST_READS["merge"] += 1
    if host[9] > N_PROBES:
        # rare wide merge: nothing was probed; recount the window densely
        # and redo the window update with those counts
        counts_sel, c_l, c_r = _post_counts(
            st.cand, st.cand_counts, pair_eff, l_slot, r_slot, sym2, w2, n_new,
        )
        scalars.update(c_l=c_l, c_r=c_r)
        cand2, counts3, log2, sout = window_post(
            st.cand, counts_sel, bins_l, bins_r, st.merge_log, probes=probes, pcnt=pcnt, **scalars,
        )
        with span("train.read", "wide"):
            host[:8] = sout.tolist()
        HOST_READS["wide"] += 1
    pend_cert = sout[5]
    if force_recount:  # ground truth: never carry a certificate
        pend_cert = torch.zeros_like(pend_cert)
        host[5] = 0
    st = replace(
        st, symbols=sym2, weights=w2, n=n_new, next_id=sout[6], early_stop=sout[2],
        merges_done=sout[0], merge_log=log2, cand=cand2, cand_counts=counts3,
        ub_new=sout[3], fill=sout[1], pend_pair=sout[7], pend_count=sout[4], pend_cert=pend_cert,
    )
    return st, host


def _merge_and_track(st: TrainState, pair, count, row: int, active=None):
    """Apply one merge ``pair`` -> ``next_id`` and keep the window: the
    reference's ``_merge_and_track`` on its Pallas branch (the stream is
    compacted after every merge, so no hole chain).

    ``merge_compact_tracked`` in window mode derives the affected slots
    from the window and counts them exactly on the post-merge stream;
    ``count_pairs2`` counts the two sampled created pairs. Each affected
    slot takes its probe count by rank (the kernel's probe list is the
    affected slots in window order); a merge that affects more than
    ``N_PROBES`` slots keeps its old counts here, and the caller recounts
    the window densely (``_post_counts``) before anyone reads them. Each
    sampled pair's exact count leaves its f32 bin, the ceiling of the
    merge's other created pairs follows ``_ub_from_bins``, the two sampled
    pairs take the next scratch slots and the merge writes log row ``row``
    (a host int).

    ``active`` (a device bool, or None for always) neutralises the merge:
    pair 0 merges nothing and every change of the state is gated off (the
    log row past ``merges_done`` is never read). Returns ``(state,
    ceilings, n_aff)``: ``ceilings`` = (ub_merge, c_l, c_r), what a later
    merge of the iteration must beat, and ``n_aff`` the affected slots."""
    has_room = st.fill <= W_SLOTS - 2
    if active is not None:
        pair = torch.where(active, pair, 0)
        has_room = has_room & active
    sym2, w2, n2, bins_l, bins_r, samp, pcnt, _probes, n_aff = merge_compact_tracked(
        st.symbols, st.weights, st.n, pair, st.next_id, st.cand, st.cand_counts,
    )
    sp = _sampled_pairs(st, samp, has_room)
    slots = torch.stack([sp["l_slot"], sp["r_slot"]])
    c_lr = count_pairs2(sym2, w2, n2, slots[0], slots[1])

    cand, counts = st.cand, st.cand_counts
    affected = _affected(cand, counts, pair)
    rank = (torch.cumsum(affected, 0) - 1).clamp_(0, N_PROBES - 1)
    counts2 = torch.where(affected & (n_aff <= N_PROBES), pcnt[rank], counts)
    counts2 = torch.where((counts >= 0) & (cand == pair), 0, counts2)

    # the bins hold every created pair's mass: take each sampled pair's
    # exact count out of its bin (its whole mass lies there)
    bins = torch.stack([bins_l.reshape(-1), bins_r.reshape(-1)])
    rows = torch.arange(2, device=bins.device)
    bins[rows, bin_index(torch.stack([sp["l_tok"], sp["r_tok"]]))] -= c_lr.to(torch.float32)
    ub_merge = _ub_from_bins(bins).max()

    ok = torch.stack([sp["l_ok"], sp["r_ok"]])
    at = torch.where(has_room, st.fill, W_SLOTS - 2) + rows
    cand2, counts3 = cand.clone(), counts2.clone()
    cand2[at] = torch.where(has_room, torch.where(ok, slots, INVALID), cand[at])
    counts3[at] = torch.where(has_room, torch.where(ok, c_lr, -1), counts2[at])
    st.merge_log[3 * row : 3 * row + 3] = torch.stack([pair, st.next_id, count & 0xFFFFFFFF])
    adv = 1 if active is None else active.to(torch.int64)
    if active is not None:  # a no-op pass adds nothing to the running ceiling
        ub_merge = torch.where(active, ub_merge, 0)
    st = replace(
        st, symbols=sym2, weights=w2, n=n2, next_id=st.next_id + adv, merges_done=st.merges_done + adv,
        cand=cand2, cand_counts=counts3, ub_new=torch.maximum(st.ub_new, ub_merge),
        fill=torch.where(has_room, st.fill + 2, st.fill),
    )
    return st, (ub_merge, c_lr[0], c_lr[1]), n_aff


def _one_merge(st: TrainState, dec: torch.Tensor, plan: _Plan, md: int) -> tuple[TrainState, torch.Tensor]:
    """One multi-merge iteration (the reference's ``_one_merge``): the
    winner of ``dec`` (the window's device ``_decision``) when ``plan``
    certifies it, else the winner of an inline full recount; then up to
    two more merges from the same decision. ``md`` is the batch's merge
    count (the log row of the first merge).

    Dual: the second candidate q, member-disjoint from the winner and
    strictly above theta and ub_new (``plan.dual_pre``, decided on the
    host), merges when its count m2 also strictly beats the first merge's
    created-pair ceiling and the exact counts of its two sampled pairs.
    Triple: the third candidate, disjoint from both, must beat both merges'
    ceilings. Those last comparisons are made on the device: the second
    (third) merge runs neutralised when they fail, so the iteration needs
    no host read between its merges. The proof that this is the serial
    argmax sequence is the reference's ``_one_merge`` docstring.

    Returns ``(state, n_aff)``: the largest affected-slot count of the
    iteration's merges (neutralised ones affect none)."""
    if plan.certified:
        pair, count, active = dec[1], dec[0], None
    else:
        bp, bc, cand, counts, theta = _full_recount_impl(st.symbols, st.weights, st.n)
        dev = st.n.device
        st = replace(st, cand=cand, cand_counts=counts, theta=theta, ub_new=_i64(0, dev),
                     fill=_i64(K_CANDIDATES, dev), recounts=st.recounts + 1)
        pair, count = bp, bc
        # neutralised stop: count < 2 or the ids ran out
        active = (bc >= 2) & (st.next_id <= TOKEN_MASK)
        st = replace(st, early_stop=st.early_stop | ~active)
    st, ceilings, n_aff = _merge_and_track(st, pair, count, md, active)
    if not plan.dual_pre:
        return st, n_aff
    m2 = dec[2]
    dual = (m2 > ceilings[0]) & (m2 > ceilings[1]) & (m2 > ceilings[2])
    st, ceilings2, n_aff2 = _merge_and_track(st, dec[3], m2, md + 1, dual)
    n_aff = torch.maximum(n_aff, n_aff2)
    if not plan.triple_pre:
        return st, n_aff
    m3 = dec[4]
    triple = dual
    for c in (*ceilings, *ceilings2):
        triple = triple & (m3 > c)
    st, _, n_aff3 = _merge_and_track(st, dec[5], m3, md + 2, triple)
    return st, torch.maximum(n_aff, n_aff3)


def _multi_batch(st: TrainState, batch_merges: int, recount_budget: int | None, force_recount: bool) -> TrainState:
    """``train_batch`` with multi-merge iterations: one host read per
    iteration (the merges done, the stop, the window's next decision and
    its ceilings), a second one after a merge that affected more than
    ``N_PROBES`` slots, whose window is then recounted densely on the
    iteration's final stream (every merged pair counts 0 there, and every
    other live slot's exact count is what the sparse updates would have
    kept). With ``force_recount`` no iteration is certified."""

    def read(st, n_aff, site):
        """The window's device decision and, on the host, [merges_done,
        early_stop, n, recounts, theta, ub_new, next_id, n_aff, *decision];
        one host read, counted under ``site``."""
        dec = _decision(st.cand, st.cand_counts)
        head = torch.stack([st.merges_done, st.early_stop, st.n, st.recounts, st.theta, st.ub_new, st.next_id,
                            n_aff])
        with span("train.read", site):
            h = torch.cat([head, dec]).tolist()
        HOST_READS[site] += 1
        return dec, h

    cap = st.symbols.shape[0]
    dec, h = read(st, torch.zeros_like(st.n), "batch")
    recounts0 = h[3]
    md = duals = 0
    while True:
        early, n, recounts, theta, ub, nid = bool(h[1]), h[2], h[3], h[4], h[5], h[6]
        if md >= batch_merges or early or (cap > _MIN_SHRINK_CAP and n + 32 <= cap // 2 and md > 0):
            break
        if recount_budget is not None and recounts - recounts0 >= recount_budget:
            break
        plan = _Plan(False, False, False) if force_recount else _plan(h[8:], theta, ub, nid, md, batch_merges)
        if plan.certified and nid > TOKEN_MASK:  # the ids ran out: the reference's neutralised stop
            st = replace(st, early_stop=torch.ones_like(st.early_stop))
            break
        st, n_aff = _one_merge(st, dec, plan, md)
        dec, h = read(st, n_aff, "iteration")
        if h[7] > N_PROBES:
            # rare wide merge: nothing was probed; recount the whole window
            one = torch.ones_like(st.n)
            counts, _, _ = _post_counts(st.cand, st.cand_counts, one, one, one, st.symbols, st.weights, st.n)
            st = replace(st, cand_counts=counts)
            dec, h = read(st, n_aff, "wide")
        duals += max(h[0] - md - 1, 0)
        md = h[0]
    return replace(st, duals=st.duals + duals)


def train_batch(
    st: TrainState, batch_merges: int, recount_budget: int | None = None,
    force_recount: bool = False, multi_merge: bool = False,
) -> TrainState:
    """Run up to ``batch_merges`` merges with early stopping.

    Nested loops as in the reference: the outer loop recounts when the
    certificate failed (or always, with ``force_recount``), the inner loop
    runs certified merges; with ``multi_merge`` one loop of multi-merge
    iterations instead (``_one_merge``). Collapse stop: when the live count
    falls below half the capacity the batch returns early so the host can
    shrink onto the next power-of-two rung. ``recount_budget`` caps the
    full recounts of one batch (the merge list is invariant: it only moves
    batch ends).
    """
    dev = st.n.device
    st = replace(st, merges_done=_i64(0, dev))
    if multi_merge:
        return _multi_batch(st, batch_merges, recount_budget, force_recount)
    cap = st.symbols.shape[0]
    with span("train.read", "batch"):
        early, n, cert, recounts = (bool(x) if i in (0, 2) else int(x) for i, x in enumerate(
            torch.stack([st.early_stop, st.n, st.pend_cert, st.recounts]).tolist()))
    HOST_READS["batch"] += 1
    recounts0 = recounts
    md = 0

    def go() -> bool:
        if md >= batch_merges or early:
            return False
        return not (cap > _MIN_SHRINK_CAP and n + 32 <= cap // 2 and md > 0)

    while go() and (recount_budget is None or recounts - recounts0 < recount_budget):
        if force_recount or not cert:
            st = _ensure_pending(st, certified=False)
            recounts += 1
            cert = True
        while go() and cert:
            st, host = _one_merge_fused_certified(st, force_recount)
            md, early, cert, n = host[0], bool(host[2]), bool(host[5]), host[8]
    return st


def _pack_summary(st: TrainState) -> torch.Tensor:
    """Merge log + batch scalars packed into ONE int64 tensor: the host's
    whole per-batch readback (duals, merges_done, n, early_stop, recounts
    at the end)."""
    scalars = torch.stack([st.duals, st.merges_done, st.n, st.early_stop, st.recounts])
    return torch.cat([st.merge_log, scalars])
