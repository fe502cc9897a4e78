"""Data-parallel BPE training on ``torch.distributed``: one shard per rank.

The port's counterpart of ``gpu_bpe_tpu/parallel/dist_train.py``. The
deduplicated unique-word stream is split into whole-word shards
(``shard_stream``), one per rank, so a merge never crosses a shard and
needs no halo. The merge decision is the GLOBAL argmax over summed pair
counts (count desc, pair id asc), certified by the same lazy-candidate
window as the single-chip trainer with every certificate quantity made
global:

* candidate counts: exact global counts of the 256 window slots,
  maintained across merges. A merge (a,b) -> Z changes only the counts of
  pairs that end in a, start with b, equal (a,b) or hold Z, so each merge
  recounts that affected subset on the local post-merge stream and sums it
  over the ranks (``psum`` of 4 + 2, 16 + 2 or 256 + 2 counts: the tiers
  ``A_FAST``, ``A_AFFECTED`` and dense);
* theta, the ceiling of untracked pairs: at a full recount each rank takes
  its local top-(K+1) runs, the union is all-gathered and counted exactly
  everywhere; a pair outside every local selection has a global count of
  at most the sum of each rank's largest count outside its selection. When
  the union's winner does not strictly beat that bound, the ranks
  all-gather their whole pair streams and recount them (dense);
* ub_new, the ceiling of created pairs: the per-merge created-pair
  histograms are summed over the ranks; the heaviest created pair per side
  (max weight, then min token, one ``pmax`` of packed keys) is tracked
  exactly in the append-only slots and its exact count taken out of its
  bin;
* dual and triple merges: when the second (third) best tracked candidate
  strictly beats every ceiling, including the ones the first merge
  created, member-disjoint merges apply from one window.

Per shard the merge is the probe-less ``merge_compact_tracked`` kernel, and
the stream is compacted after every merge, as on the TPU path: no holes, no
deferred compaction. Counting uses sort + ``searchsorted`` + ``index_add_``
in int64, never an ``[L, N]`` compare matrix.

Every rank must take every branch alike, or one rank enters a collective
that another skips and the run hangs. The JAX ``lax.cond``s become host
decisions on replicated values only: values that came out of a collective
or were replicated from the start, read in one packed host read per merge
(plus one per batch and one or two per full recount). A rank-local value
(``n``, the stream) never decides a branch. The counts of the created-pair
histograms are summed as int64 (their f32 values are integers), so the sum
has the same bits on every rank. The merge list is independent of the
world size; ``recounts`` and ``duals`` are not (the ceilings move with it).

Spans, under the single-chip trainer's names: ``train.recount`` around a
full recount (``tier``: ``dist_sparse``, or ``dist_dense`` where the whole
shards were gathered), and ``train.read`` (``site``: the ``HOST_READS``
key) around each host read; each collective is a ``train.collective``
(``parallel/mesh.py``).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..constants import BATCH_MERGES, TOKEN_MASK, WORD_START_BIT
from ..ops.kernels import INVALID, I32_MAX, bin_index, merge_compact_tracked, to_i32
from ..ops.train_step import (
    K_CANDIDATES,
    S_CREATED,
    _NO_EXCL,
    _affected,
    _decision,
    _pair_ids,
    _pick_window,
    _plan,
    _run_totals,
    _ub_from_bins,
)
from ..utils.timing import span
from .mesh import DataGroup

N_SLOTS = K_CANDIDATES + S_CREATED
# Affected-recount widths (the reference package's tiers): at most A_FAST,
# else at most A_AFFECTED affected slots are summed, else the whole window.
A_FAST = 4
A_AFFECTED = 16

# Host reads by site ("batch", "merge", "recount", and the trainer's
# "summary" per batch); clear() to reset.
HOST_READS: Counter = Counter()


@dataclass
class DistState:
    """One rank's training state. ``symbols``/``weights``/``n`` are this
    rank's shard; every other field is replicated (equal on every rank).
    Scalars are 0-d int64 tensors on the rank's device (flags 0/1); pair ids
    hold unsigned 32-bit values."""

    symbols: torch.Tensor  # int32 [cap_shard] — tok | word-start bit; 0 past n
    weights: torch.Tensor  # int32 [cap_shard]
    n: torch.Tensor  # this shard's live count (rank-local)
    next_id: torch.Tensor
    early_stop: torch.Tensor
    merges_done: torch.Tensor  # merges done this batch
    merge_log: torch.Tensor  # int64 [BATCH_MERGES * 3] — (pair, new_id, count) rows
    cand: torch.Tensor  # int64 [N_SLOTS] tracked pairs (INVALID when dead)
    cand_counts: torch.Tensor  # int64 [N_SLOTS] EXACT global counts, -1 when dead
    theta: torch.Tensor  # ceiling on every untracked pair present at the last recount
    ub_new: torch.Tensor  # ceiling on pairs created since the last recount
    recounts: torch.Tensor  # full recounts (diagnostics)
    fill: torch.Tensor  # next free created-pair slot
    duals: torch.Tensor  # second and third merges of an iteration (diagnostics)


def shard_stream(symbols: np.ndarray, weights: np.ndarray, n_devices: int):
    """Split a unique-word stream into per-rank shards on the host.

    Whole words per shard (each word to the shard with the fewest symbols
    so far, the first such), padded to one capacity: a multiple of 1024
    plus 1024. Returns (symbols [D, CAP] uint32, weights [D, CAP] int32,
    n [D] int32), bitwise the JAX package's split."""
    symbols = np.asarray(symbols, np.uint32)
    weights = np.asarray(weights, np.int32)
    starts = np.flatnonzero(symbols & np.uint32(WORD_START_BIT))
    if len(starts) == 0 and len(symbols):
        starts = np.array([0])
    ends = np.append(starts[1:], len(symbols))

    shard_words: list[list[tuple[int, int]]] = [[] for _ in range(n_devices)]
    shard_sizes = np.zeros(n_devices, dtype=np.int64)
    for s, e in zip(starts.tolist(), ends.tolist()):
        d = int(np.argmin(shard_sizes))
        shard_words[d].append((s, e))
        shard_sizes[d] += e - s

    cap = int(max(shard_sizes.max(), 1))
    cap = ((cap + 1023) // 1024) * 1024 + 1024
    out_sym = np.zeros((n_devices, cap), np.uint32)
    out_w = np.zeros((n_devices, cap), np.int32)
    n_arr = np.zeros(n_devices, np.int32)
    for d in range(n_devices):
        pos = 0
        for s, e in shard_words[d]:
            ln = e - s
            out_sym[d, pos : pos + ln] = symbols[s:e]
            out_w[d, pos : pos + ln] = weights[s:e]
            pos += ln
        n_arr[d] = pos
    return out_sym, out_w, n_arr


def _i64(x, device) -> torch.Tensor:
    return torch.tensor(int(x), dtype=torch.int64, device=device)


def init_dist_state(group: DataGroup, symbols, weights, n, next_id) -> DistState:
    """This rank's state from the host split of ``shard_stream`` (every rank
    computes it alike): only the rank's own row is uploaded; the window
    starts dead with theta at i32 max, which forces a recount first."""
    dev, r = group.device, group.rank
    return DistState(
        symbols=torch.from_numpy(np.asarray(symbols[r], np.uint32).view(np.int32).copy()).to(dev),
        weights=torch.from_numpy(np.asarray(weights[r], np.int32).copy()).to(dev),
        n=_i64(np.asarray(n)[r], dev),
        next_id=_i64(next_id, dev),
        early_stop=_i64(0, dev),
        merges_done=_i64(0, dev),
        merge_log=torch.zeros(BATCH_MERGES * 3, dtype=torch.int64, device=dev),
        cand=torch.full((N_SLOTS,), INVALID, dtype=torch.int64, device=dev),
        cand_counts=torch.full((N_SLOTS,), -1, dtype=torch.int64, device=dev),
        theta=_i64(I32_MAX, dev),
        ub_new=_i64(0, dev),
        recounts=_i64(0, dev),
        fill=_i64(K_CANDIDATES, dev),
        duals=_i64(0, dev),
    )


def _local_counts(lst: torch.Tensor, pair: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int64 pair-stream counts of each entry of ``lst`` (duplicates
    allowed) on this shard: the stream's pairs are looked up in the sorted
    list and their weights added where they hit, O(N log L) in time and
    O(N) in memory."""
    slst = torch.sort(lst).values
    idx = torch.searchsorted(slst, pair).clamp_(max=slst.shape[0] - 1)
    hit = slst[idx] == pair
    sums = torch.zeros_like(slst).index_add_(0, idx, torch.where(hit, w, 0))
    return sums[torch.searchsorted(slst, lst)]


def _stream_pairs(symbols, weights, n):
    """Pair ids (0 where invalid) and int64 weights of a hole-free shard."""
    pair, valid = _pair_ids(symbols, n)
    return pair, torch.where(valid, weights.to(torch.int64), 0)


def _full_recount(g: DataGroup, st: DistState):
    """Exact global recount: a fresh window, theta and the winner. Returns
    ``(state, best_pair, count, host)`` with ``host`` = [count, n_aff of
    the best pair, theta] read on the host; the sparse path needs one host
    read, the dense one two."""
    with span("train.recount") as rec:
        pair, w = _stream_pairs(st.symbols, st.weights, st.n)
        sp, order = torch.sort(pair)
        rt = _run_totals(sp, w[order])
        # any local top-(K+1) is sound: the bound below is an exact masked max
        vals, idx = torch.topk(rt, K_CANDIDATES + 1)
        loc = torch.where(vals > 0, sp[idx], INVALID)
        su = torch.sort(g.all_gather(loc)).values  # [D * (K+1)]
        dup = torch.zeros_like(su, dtype=torch.bool)
        dup[1:] = su[1:] == su[:-1]
        su = torch.where(dup, INVALID, su)
        # exact global counts of the union, and the sum over ranks of each
        # rank's largest count outside its own selection, in one psum (the
        # reference sums both in int32)
        outside = torch.where(torch.isin(sp, loc), 0, rt).max()
        tot = to_i32(g.psum(torch.cat([_local_counts(su, pair, w), outside.reshape(1)])))
        uc = torch.where(su == INVALID, 0, tot[:-1])
        bound1 = tot[-1]
        o = torch.argsort(su, stable=True)
        o = o[torch.argsort(-uc[o], stable=True)]  # (count desc, pair asc)
        sorted_pairs, sorted_counts = su[o], uc[o]
        # the union's result is exact only if its winner strictly beats the
        # bound (a tie could hide a smaller pair id outside every selection)
        cand = torch.cat([sorted_pairs[:K_CANDIDATES], sorted_pairs.new_full((S_CREATED,), INVALID)])
        counts = torch.cat([torch.where(sorted_pairs[:K_CANDIDATES] == INVALID, -1, sorted_counts[:K_CANDIDATES]),
                            sorted_counts.new_full((S_CREATED,), -1)])
        theta = torch.maximum(bound1, sorted_counts[K_CANDIDATES])
        best, count = sorted_pairs[0], sorted_counts[0]
        head = torch.stack([(count > bound1).to(torch.int64), count, _affected(cand, counts, best).sum(), theta])
        with span("train.read", "recount"):
            head = head.tolist()
        HOST_READS["recount"] += 1
        provable, host = head[0], head[1:]
        rec.note(tier="dist_sparse" if provable else "dist_dense")
        if not provable:
            # dense: all-gather the masked pair streams (shards start at word
            # starts, so no pair crosses two) and recount them globally; the
            # theta this gives is tight
            gp, gw = g.all_gather(pair), g.all_gather(w)
            sp2, order2 = torch.sort(gp)
            best, count, cand, counts, theta = _pick_window(sp2, _run_totals(sp2, gw[order2]))
            host = torch.stack([count, _affected(cand, counts, best).sum(), theta])
            with span("train.read", "recount"):
                host = host.tolist()
            HOST_READS["recount"] += 1
        dev = st.n.device
        st = replace(st, cand=cand, cand_counts=counts, theta=theta, ub_new=_i64(0, dev),
                     fill=_i64(K_CANDIDATES, dev), recounts=st.recounts + 1)
        return st, best, count, host


def _merge_and_track(g: DataGroup, st: DistState, pair, count, n_aff: int, md: int, follow=None):
    """Apply one certified merge ``pair`` -> next_id on every shard and keep
    the replicated window: the global sample of the heaviest created pair
    per side, the maintained exact counts (affected-subset recount), the
    ceiling of this merge's created pairs, the created-pair slots and the
    log row ``md``. ``n_aff`` (host) picks the recount's tier.

    Returns ``(state, decision, host)``: the new state, the device
    ``_decision`` of its window, and its one host read, [ub_merge, c_l,
    c_r, n_aff(follow), theta, ub_new, *decision] (n_aff(follow) is the
    number of slots ``follow`` affects in the new window, 0 without one)."""
    nid = st.next_id
    z16 = nid & TOKEN_MASK
    sym2, w2, n2, bins_l, bins_r, samp = merge_compact_tracked(st.symbols, st.weights, st.n, pair, nid)
    # global heaviest created pair per side: max weight, then min token
    key = g.pmax(((samp[0::2] + 1) << 32) | (TOKEN_MASK - samp[1::2]))
    wmax, tok = (key >> 32) - 1, TOKEN_MASK - (key & 0xFFFFFFFF)
    has_room = st.fill <= N_SLOTS - 2
    # token-0 guard: a pair with a zero member is never counted by the pair
    # stream, so tracking it would seed a wrong count
    ok = has_room & (wmax > 0) & (tok != 0)
    toks = torch.where(ok, tok, _NO_EXCL)
    created = torch.where(ok, torch.stack([(toks[0] << 16) | z16, (z16 << 16) | toks[1]]), INVALID)
    slots = torch.where(ok, created, 1)  # sentinel pair 1 counts 0

    cand, counts = st.cand, st.cand_counts
    live = counts >= 0
    if n_aff <= A_AFFECTED:
        width = A_FAST if n_aff <= A_FAST else A_AFFECTED
        affected = _affected(cand, counts, pair)
        first = torch.sort(affected.to(torch.int8), descending=True, stable=True).indices[:width]
        lst = torch.where(torch.arange(width, device=cand.device) < n_aff, cand[first], 1)
    else:
        width = N_SLOTS
        lst = cand
    pair2, w2m = _stream_pairs(sym2, w2, n2)
    bins = torch.cat([bins_l.reshape(-1), bins_r.reshape(-1)])
    # one psum: the counts, then the histograms as int64 (exact integers)
    tot = g.psum(torch.cat([_local_counts(torch.cat([lst, slots]), pair2, w2m), bins.to(torch.int64)]))
    cnt, c_lr = to_i32(tot[:width]), to_i32(tot[width : width + 2])
    if width == N_SLOTS:
        counts2 = torch.where(live, cnt, counts)
    else:
        s, perm = torch.sort(lst)
        pos = torch.searchsorted(s, cand).clamp_(max=width - 1)
        counts2 = torch.where(affected, cnt[perm][pos], counts)
    counts2 = torch.where(live & (cand == pair), 0, counts2)
    # histograms arrive unexcluded: take each sampled pair's exact global
    # count out of its bin
    bins = tot[width + 2 :].to(torch.float32).reshape(2, -1)
    rows = torch.arange(2, device=bins.device)
    bins[rows, bin_index(toks)] -= c_lr.to(torch.float32)
    ub_merge = _ub_from_bins(bins).max()

    at = torch.where(has_room, st.fill, N_SLOTS - 2) + rows
    cand2, counts3 = cand.clone(), counts2.clone()
    cand2[at] = torch.where(has_room, created, cand[at])
    counts3[at] = torch.where(has_room, torch.where(ok, c_lr, -1), counts2[at])
    st.merge_log[3 * md : 3 * md + 3] = torch.stack([pair, nid, count & 0xFFFFFFFF])
    ub_new = torch.maximum(st.ub_new, ub_merge)
    st = replace(st, symbols=sym2, weights=w2, n=n2, next_id=nid + 1, merges_done=st.merges_done + 1,
                 cand=cand2, cand_counts=counts3, ub_new=ub_new, fill=torch.where(has_room, st.fill + 2, st.fill))
    dec = _decision(cand2, counts3)
    n_follow = _affected(cand2, counts3, follow).sum() if follow is not None else torch.zeros_like(nid)
    host = torch.cat([torch.stack([ub_merge, c_lr[0], c_lr[1], n_follow, st.theta, ub_new]), dec])
    with span("train.read", "merge"):
        host = host.tolist()
    HOST_READS["merge"] += 1
    return st, dec, host


def dist_train_batch(group: DataGroup, st: DistState, batch_merges: int) -> DistState:
    """Run up to ``batch_merges`` merges on every rank, stopping early when
    the best count falls below 2 or the 16-bit ids run out (the body of the
    reference's ``shard_step``). Every rank calls it with its own state and
    takes the same branches. The merge log is updated in place."""
    st = replace(st, merges_done=torch.zeros_like(st.merges_done))
    dec = _decision(st.cand, st.cand_counts)
    head = torch.cat([torch.stack([st.next_id, st.early_stop, st.theta, st.ub_new]), dec])
    with span("train.read", "batch"):
        head = head.tolist()
    HOST_READS["batch"] += 1
    nid, stop, theta, ub = head[0], bool(head[1]), head[2], head[3]
    h = head[4:]
    md = duals = 0
    while md < batch_merges and not stop:
        plan = _plan(h, theta, ub, nid, md, batch_merges)
        if plan.certified:
            pair, count, n_aff, c = dec[1], dec[0], h[6], h[0]
        else:
            st, pair, count, (c, n_aff, theta) = _full_recount(group, st)
            ub = 0
        if c < 2 or nid > TOKEN_MASK:
            stop = True
            break
        d0, h0 = dec, h  # this iteration's window: m2, q at 2, 3 and m3, r3 at 4, 5
        st, dec, out = _merge_and_track(group, st, pair, count, n_aff, md, d0[3] if plan.dual_pre else None)
        md, nid = md + 1, nid + 1
        ceilings = out[:3]  # ub_merge, c_l, c_r: what a second merge must beat
        if plan.dual_pre and all(h0[2] > x for x in ceilings):
            st, dec, out2 = _merge_and_track(group, st, d0[3], d0[2], out[3], md,
                                             d0[5] if plan.triple_pre else None)
            md, nid, duals = md + 1, nid + 1, duals + 1
            ceilings += out2[:3]
            if plan.triple_pre and all(h0[4] > x for x in ceilings):
                st, dec, out2 = _merge_and_track(group, st, d0[5], d0[4], out2[3], md)
                md, nid, duals = md + 1, nid + 1, duals + 1
            out = out2
        theta, ub, h = out[4], out[5], out[6:]
    dev = st.n.device
    return replace(st, early_stop=_i64(stop, dev), duals=st.duals + duals)
