"""The training and compaction kernels: CUDA wrappers, their plain PyTorch
versions and launch counters (counterpart of
``gpu_bpe_tpu/ops/pallas_kernels.py``).

Each public wrapper takes the plain version for tensors that lie on the
CPU, and launches its hand-written CUDA kernel (``ops/csrc``) for CUDA
tensors, raising if the build or the launch fails; there is no fallback.
``LAUNCHES`` (``ops/build.py``, with the rest of the launch plumbing)
counts kernel launches per wrapper.

Storage conventions (shared with the CUDA sources):

* symbols and weights: int32 ``[cap]``; a symbol is ``tok | WS_BIT``;
* pair ids, window slots, counts, probe counts, the merge log and every
  scalar: int64, a pair id holding its unsigned 32-bit value, so every
  comparison of pair ids is in unsigned order;
* scalars are 0-d int64 tensors on the stream's device (Python ints are
  accepted and copied there; ``window_post`` also takes bool flags and
  reads every scalar in place), so the three launches of a merge need no
  host read between them;
* the compaction kernels take and return u32 words as int32 tensors of
  the same bits (``INVALID`` is -1 there), and boolean masks.

Outputs differ from the Pallas functions only where the Pallas ones are
approximations or layout artefacts: ``bins`` hold the exact integer mass
rounded to f32 once (the Pallas bins are one-hot matmul sums), and a
``samp`` token is the smallest token among the positions of the heaviest
weight over the whole stream (the Pallas kernel keeps the smallest token of
the earliest 32K block that reaches that weight). A ``samp`` token is only
meaningful when its weight is > 0.
"""

from __future__ import annotations

import struct
from types import SimpleNamespace
from typing import NamedTuple

import torch

from ..constants import TOKEN_MASK, WORD_START_BIT
from .build import LAUNCHES, cached_scratch, check, check_scratch, current_stream, on_cpu, on_device, ptr, require

W_SLOTS = 256  # candidate window: K_CANDIDATES + S_CREATED
N_PROBES = 64  # fused probe-pair slots
TRACK_SIDE = 16  # created-pair histograms are TRACK_SIDE x TRACK_SIDE bins
N_SCALARS = 18  # window_post's packed scalars before probes and pcnt
INVALID = 0xFFFFFFFF
I32_MAX = 2**31 - 1

PROBE_LESS = "merge_compact_tracked/probe-less"  # LAUNCHES key of the no-window mode
EXPLICIT_PROBES = "merge_compact_tracked/explicit-probes"  # LAUNCHES key of the explicit-probe mode
GATED = "merge_compact_tracked/gated"  # LAUNCHES key of the gated window mode


def _scalar(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64).reshape(())
    return torch.tensor(int(x), dtype=torch.int64, device=device)


def _dev_scalar(x, device: torch.device) -> torch.Tensor:
    """``_scalar``, taking a 0-d int64 tensor already on ``device`` as it is
    (the train step's scalars are such tensors)."""
    if isinstance(x, torch.Tensor) and x.dtype is torch.int64 and x.dim() == 0 and x.device == device:
        return x
    return _scalar(x, device)


# Small outputs of merge_compact_tracked and count_pairs2, by (kernel,
# device index, stream): one allocation serves POOL_CALLS calls, each call
# takes the next unused set of views and no set is handed out twice, so
# every call's outputs are new memory. Making a view costs about as much
# host time as an allocation, and a merge returns nine outputs.
POOL_CALLS = 64
_POOLS: dict[tuple, list] = {}


def _pooled(key: tuple, make):
    """The next unused item of ``key``'s pool; ``make()`` refills it with a
    list of items when it is empty."""
    pool = _POOLS.get(key)
    if not pool:
        pool = _POOLS[key] = make()
    return pool.pop()


def bin_index(tok: torch.Tensor) -> torch.Tensor:
    """Hash bin of 16-bit tokens: (tok * 2654435761) >> 16 & 255 in
    wrapping u32 arithmetic (int64 masked before the shift)."""
    return (((tok * 2654435761) & 0xFFFFFFFF) >> 16) & (TRACK_SIDE * TRACK_SIDE - 1)


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret the low 32 bits of int64 values as signed int32 (kept in int64)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x)


# ─────────────────────────── merge_compact_tracked ───────────────────────────


def window_probes(cand: torch.Tensor, counts: torch.Tensor, pair: torch.Tensor):
    """Affected window slots of merging ``pair`` (live slots whose pair ends
    in a or starts with b, excluding the pair itself) and the probe list:
    the first ``N_PROBES`` affected pairs in window order when they fit, else
    none; sentinel pair 1 fills the unused slots. Returns (probes, n_aff)."""
    a, b = pair >> 16, pair & TOKEN_MASK
    aff = (counts >= 0) & (((cand & TOKEN_MASK) == a) | ((cand >> 16) == b)) & (cand != pair)
    n_aff = aff.sum()
    picked = cand[aff][:N_PROBES]
    probes = torch.ones(N_PROBES, dtype=torch.int64, device=cand.device)
    if int(n_aff) <= N_PROBES:
        probes[: picked.shape[0]] = picked
    return probes, n_aff


def probe_list(words, count, device) -> tuple[torch.Tensor, torch.Tensor]:
    """An explicit probe list as the kernel reads it: int64 ``[N_PROBES]``
    pairs and a 0-d int64 count, on ``device``."""
    words = torch.as_tensor(words, dtype=torch.int64).to(device).reshape(N_PROBES)
    return words.contiguous(), _dev_scalar(count, device)


class Gated(NamedTuple):
    """What the gated mode of ``merge_compact_tracked`` writes beyond the
    window mode, as views of its output arena: 0-d int64 words, then two
    vectors.

    * ``pair``, ``active``, ``has_room``: the gate of the train step's
      ``_gate`` (the effective pair, 0 for a stopped merge; flags 0/1);
    * ``use_probes``: ``n_aff <= N_PROBES`` (0/1);
    * ``l_ok``, ``r_ok``, ``l_tok``, ``r_tok``, ``l_slot``, ``r_slot``: the
      train step's ``_sampled_pairs``, flags 0/1;
    * ``sout``: int64 ``[8]``, left for ``window_post(..., sout=)``, and
      ``sout_words``, its eight words as 0-d views;
    * ``host``: int64 ``[10]`` = ``sout``, n_new, n_aff: what the loop
      reads back after the merge, in one copy."""

    pair: torch.Tensor
    active: torch.Tensor
    has_room: torch.Tensor
    use_probes: torch.Tensor
    l_ok: torch.Tensor
    r_ok: torch.Tensor
    l_tok: torch.Tensor
    r_tok: torch.Tensor
    l_slot: torch.Tensor
    r_slot: torch.Tensor
    sout: torch.Tensor
    sout_words: tuple
    host: torch.Tensor


GATE_WORDS = 10  # the 0-d words, in merge_compact_tracked.cu's enum Gate order
SOUT_WORDS = 8  # window_post's sout


def gated_views(tail: torch.Tensor) -> list[Gated]:
    """The ``Gated`` of each row of an int64 ``[k, GATE_WORDS + SOUT_WORDS +
    2]`` arena tail: the gate words, ``sout``, n_new and n_aff."""
    words = [tail[:, i].unbind(0) for i in range(GATE_WORDS)]
    sout = tail[:, GATE_WORDS : GATE_WORDS + SOUT_WORDS].unbind(0)
    sout_words = zip(*(tail[:, GATE_WORDS + i].unbind(0) for i in range(SOUT_WORDS)))
    host = tail[:, GATE_WORDS:].unbind(0)
    return [Gated(*w, so, sw, h) for *w, so, sw, h in zip(*words, sout, sout_words, host)]


def _gated_plain(symbols, weights, n, pair, new_id, cand, counts, count, fill):
    """The gated mode's plain version: the train step's own ``_gate`` and
    ``_sampled_pairs`` around the window-mode plain merge, the words laid
    out as in the arena (n_new and n_aff are views of ``host``)."""
    from .train_step import _gate, _sampled_pairs

    dev = symbols.device
    st = SimpleNamespace(pend_pair=_scalar(pair, dev), pend_count=_scalar(count, dev),
                         next_id=_scalar(new_id, dev), fill=_scalar(fill, dev))
    active, pair_eff, has_room = _gate(st)
    out = merge_compact_tracked_plain(symbols, weights, n, pair_eff, new_id, cand, counts)
    sp = _sampled_pairs(st, out[5], has_room)
    tail = torch.zeros(1, GATE_WORDS + SOUT_WORDS + 2, dtype=torch.int64, device=dev)
    words = (pair_eff, active, has_room, out[8] <= N_PROBES, sp["l_ok"], sp["r_ok"], sp["l_tok"], sp["r_tok"],
             sp["l_slot"], sp["r_slot"])
    tail[0, :GATE_WORDS] = torch.stack([x.to(torch.int64) for x in words])
    tail[0, -2:] = torch.stack([out[2], out[8]])
    (g,) = gated_views(tail)
    return (*out[:2], g.host[-2], *out[3:8], g.host[-1], g)


def merge_compact_tracked_plain(symbols, weights, n, pair, new_id, cand=None, counts=None, probes=None, gate=None):
    """Plain PyTorch version of ``merge_compact_tracked`` (same outputs: the
    10-tuple gated, the 9-tuple with a window, the 7-tuple with ``probes``,
    else the 6-tuple)."""
    if gate is not None:
        return _gated_plain(symbols, weights, n, pair, new_id, cand, counts, *gate)
    dev = symbols.device
    cap = symbols.shape[0]
    n, pair, new_id = (_scalar(x, dev) for x in (n, pair, new_id))
    nn = min(int(n), cap)
    pair_i = int(pair)
    a, b = pair_i >> 16, pair_i & TOKEN_MASK
    s = symbols.to(torch.int64)
    pos = torch.arange(cap, device=dev)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    prev = torch.cat([zero, s[:-1]])
    nxt = torch.cat([s[1:], zero])
    tok, ws = s & TOKEN_MASK, s & WORD_START_BIT
    site = (pos < nn - 1) & (tok == a) & ((nxt & TOKEN_MASK) == b) & ((nxt & WORD_START_BIT) == 0)
    removed = (pos < nn) & ((prev & TOKEN_MASK) == a) & (tok == b) & (ws == 0)
    if pair_i == 0:  # pair 0 merges nothing
        site, removed = torch.zeros_like(site), torch.zeros_like(removed)
    vals = torch.where(site, (new_id & 0xFFFFFFFF) | ws, s)
    keep = (pos < nn) & ~removed
    n_new = int(keep.sum())
    sym2 = torch.zeros(cap, dtype=torch.int32, device=dev)
    w2 = torch.zeros(cap, dtype=torch.int32, device=dev)
    sym2[:n_new] = vals[keep].to(torch.int32)
    w2[:n_new] = weights[keep]

    # created-pair tracking over adjacent pairs of the compacted stream
    # (and the last symbol with the zero pad when the capacity has room)
    lim = min(n_new, cap - 1)
    u, v = sym2[:lim].to(torch.int64), sym2[1 : lim + 1].to(torch.int64)
    uw, vw = w2[:lim].to(torch.int64), w2[1 : lim + 1].to(torch.int64)
    ut, vt = u & TOKEN_MASK, v & TOKEN_MASK
    v_ok = (v & WORD_START_BIT) == 0
    z16 = int(new_id) & TOKEN_MASK
    lm = v_ok & (vt == z16) & (vw > 0)
    rm = v_ok & (ut == z16) & (uw > 0)
    nb = TRACK_SIDE * TRACK_SIDE
    acc_l = torch.zeros(nb, dtype=torch.int64, device=dev).index_add_(0, bin_index(ut[lm]), vw[lm])
    acc_r = torch.zeros(nb, dtype=torch.int64, device=dev).index_add_(0, bin_index(vt[rm]), uw[rm])
    any_l, any_r = bool(lm.any()), bool(rm.any())

    def sample(mask, wts, toks, any_this, any_other):
        if not any_this:
            return (0 if any_other else -1), 0
        wmax = int(wts[mask].max())
        return wmax, int(toks[mask & (wts == wmax)].min())

    sl = sample(lm, vw, ut, any_l, any_r)
    sr = sample(rm, uw, vt, any_r, any_l)
    samp = torch.tensor([sl[0], sl[1], sr[0], sr[1]], dtype=torch.int64, device=dev)
    bins_l = acc_l.to(torch.float32).reshape(TRACK_SIDE, TRACK_SIDE)
    bins_r = acc_r.to(torch.float32).reshape(TRACK_SIDE, TRACK_SIDE)
    n_new_t = torch.tensor(n_new, dtype=torch.int64, device=dev)
    if cand is None and probes is None:
        return sym2, w2, n_new_t, bins_l, bins_r, samp

    if probes is not None:  # the caller's list: its first `count` slots, count clamped to [0, N_PROBES]
        words, count = probe_list(*probes, dev)
        probes, npe = words & 0xFFFFFFFF, min(max(int(count), 0), N_PROBES)
    else:
        probes, n_aff = window_probes(cand, counts, pair)
        npe = int(n_aff) if int(n_aff) <= N_PROBES else 0
    pcnt = torch.zeros(N_PROBES, dtype=torch.int64, device=dev)
    pairs = (ut << 16) | vt
    for k in range(npe):
        pcnt[k] = uw[v_ok & (pairs == probes[k])].sum()
    if cand is None:
        return sym2, w2, n_new_t, bins_l, bins_r, samp, pcnt
    return sym2, w2, n_new_t, bins_l, bins_r, samp, pcnt, probes, n_aff.to(torch.int64)


# merge_compact_tracked.cu's output arena, in int64 words: the left and
# right bins as 2 x 256 f32, samp[4], pcnt, probes, the gated mode's words,
# sout (for window_post), n_new, n_aff (mc_arena_words() in the library);
# the last ten words are the gated loop's host read
ARENA_BINS = 0
ARENA_SAMP = ARENA_BINS + TRACK_SIDE * TRACK_SIDE  # 2 x 256 f32 fill 256 words
ARENA_PCNT = ARENA_SAMP + 4
ARENA_PROBES = ARENA_PCNT + N_PROBES
ARENA_GATE = ARENA_PROBES + N_PROBES
ARENA_SOUT = ARENA_GATE + GATE_WORDS
ARENA_NNEW = ARENA_SOUT + SOUT_WORDS
ARENA_NAFF = ARENA_NNEW + 1
ARENA_WORDS = ARENA_NAFF + 1
_ARENA_SPLIT = (ARENA_SAMP - ARENA_BINS, 4, N_PROBES, N_PROBES, ARENA_NNEW - ARENA_GATE, 1, 1)


def merge_arenas(count: int, device, gated: bool = False) -> list:
    """``count`` output arenas of ``merge_compact_tracked`` in one int64
    ``[count, ARENA_WORDS]`` allocation, each as ``(address, (n_new,
    bins_l, bins_r, samp, pcnt, probes, n_aff))``: the arena's device
    address and its small outputs as views at the ``ARENA_*`` offsets, with
    the plain version's shapes (a few view operations for all of them);
    ``gated`` appends each arena's ``Gated`` to its views."""
    bulk = torch.empty(count, ARENA_WORDS, dtype=torch.int64, device=device)
    bins, samp, pcnt, probes, _, n_new, n_aff = bulk.split(_ARENA_SPLIT, dim=1)
    bins = bins.view(torch.float32).view(count, 2, TRACK_SIDE, TRACK_SIDE)
    views = [n_new.squeeze(1).unbind(0), bins[:, 0].unbind(0), bins[:, 1].unbind(0), samp.unbind(0),
             pcnt.unbind(0), probes.unbind(0), n_aff.squeeze(1).unbind(0)]
    if gated:
        views.append(gated_views(bulk[:, ARENA_GATE:]))
    base, row = bulk.data_ptr(), 8 * ARENA_WORDS
    return [(base + i * row, v) for i, v in enumerate(zip(*views))]


def merge_compact_tracked(symbols, weights, n, pair, new_id, cand=None, counts=None, probes=None, gate=None):
    """One merge ``pair`` -> ``new_id`` with stable compaction, created-pair
    tracking and, in window and explicit-probe modes, probe counts.

    ``symbols``/``weights`` are int32 ``[cap]``, live in ``[0, n)``; what
    lies past ``n`` is never matched. Four modes:

    * window: ``cand``/``counts``, the int64 ``[W_SLOTS]`` candidate
      window; the kernel derives the probe list from it. Returns ``(sym2,
      w2, n_new, bins_l, bins_r, samp, pcnt, probes, n_aff)``;
    * gated: a window and ``gate=(count, fill)``, the default training
      loop's certified merge: ``pair`` is the pending winner, ``count`` its
      count and ``fill`` the window's next free scratch slot (0-d int64
      tensors, or ints). The kernel applies the train step's gate itself
      (a merge with count < 2 or ``new_id`` past 16 bits runs as the no-op
      pair 0) and writes the sampled pairs' words. Returns the window
      mode's nine outputs, then a ``Gated``;
    * explicit probes: ``probes=(words, count)``, ``words`` ``N_PROBES``
      packed pairs (int64 holding their u32 values; a tensor or a
      sequence) and ``count`` (0..N_PROBES, an int or a 0-d tensor) its
      live leading slots, counted as they are (the Pallas ``probes=``
      mode). Returns the first seven;
    * probe-less: neither (the data-parallel trainer's and the replay's;
      the kernel reads no window and skips the probe set-up). Returns the
      first six.

    A window and ``probes`` are exclusive, and ``gate`` needs a window. The
    outputs:

    * ``sym2``/``w2``: the merged, compacted stream, zero past ``n_new``;
      a site becomes ``new_id | (sym & WS_BIT)``, the overlap-collapse
      quirk and the word-start block of the reference rule hold;
    * ``bins_l``/``bins_r``: f32 ``[16, 16]`` hashed histograms of the
      created pairs' mass, left pairs (u, Z) keyed by u, right pairs (Z, v)
      keyed by v, the exact integer mass rounded to f32 once;
    * ``samp``: int64 ``[4]`` = (max left weight, its token, max right
      weight, its token); ties on weight go to the smallest token; weight
      -1 when no created pair exists on either side, 0 when only the other
      side has one;
    * ``probes``/``pcnt``/``n_aff``: the affected window slots' count, the
      probe list (``window_probes``) and each probe's exact post-merge
      pair-stream count (valid for the first ``n_aff`` slots when
      ``n_aff <= N_PROBES``; nothing is probed otherwise). With an explicit
      list, ``pcnt[k]`` is the count of ``words[k]`` for ``k < count``
      and 0 past it; like the Pallas mode, a probed pair with a zero member
      may see the zero pad after ``n_new``, so callers probe only pairs of
      nonzero tokens.

    The ``samp`` rule (weight descending, then token ascending over the
    whole stream) is the one the data-parallel trainer reduces across
    ranks; see the notes of ``merge_compact_tracked.cu``.

    On the card the small outputs are views of an allocation shared by
    ``POOL_CALLS`` calls (``merge_arenas``), each call's its own. Window-mode
    launches count under ``merge_compact_tracked`` in ``LAUNCHES``, gated
    ones under ``GATED``, probe-less ones under ``PROBE_LESS`` and
    explicit-probe ones under ``EXPLICIT_PROBES``.
    """
    window = () if cand is None and counts is None else (cand, counts)
    if len(window) and (cand is None or counts is None):
        raise ValueError("merge_compact_tracked: give both cand and counts, or neither")
    if len(window) and probes is not None:
        raise ValueError("merge_compact_tracked: a window and probes are exclusive")
    if gate is not None and not window:
        raise ValueError("merge_compact_tracked: the gated mode needs a window")
    if on_cpu(symbols, weights, *window):
        return merge_compact_tracked_plain(symbols, weights, n, pair, new_id, cand, counts, probes, gate)
    from .build import load

    dev = symbols.device
    cap = symbols.shape[0]
    require(symbols, torch.int32, (cap,), "symbols")
    require(weights, torch.int32, (cap,), "weights")
    if window:
        require(cand, torch.int64, (W_SLOTS,), "cand")
        require(counts, torch.int64, (W_SLOTS,), "counts")
    if cap < 1:
        raise ValueError("merge_compact_tracked: empty stream")
    n, pair, new_id = _dev_scalar(n, dev), _dev_scalar(pair, dev), _dev_scalar(new_id, dev)
    listed = () if probes is None else probe_list(*probes, dev)
    gated = () if gate is None else tuple(_dev_scalar(x, dev) for x in gate)
    lib = load()["merge_compact_tracked"]
    stream = current_stream(dev)
    key = ("merge_compact_tracked", dev.index, cap, stream)
    scratch = cached_scratch(key, dev, lambda: lib.mc_scratch_words(cap))
    mode = GATED if gated else "merge_compact_tracked" if window else EXPLICIT_PROBES if listed else PROBE_LESS
    arena, (n_new, bins_l, bins_r, samp, pcnt, probes_out, n_aff, *g) = _pooled(
        ("merge_compact_tracked", dev.index, stream, bool(gated)), lambda: merge_arenas(POOL_CALLS, dev, bool(gated)))
    out = torch.empty(2, cap, dtype=torch.int32, device=dev)  # merged symbols, then weights
    with on_device(dev):
        rc = lib.merge_compact_tracked(
            symbols.data_ptr(), weights.data_ptr(), cap, n.data_ptr(), pair.data_ptr(), new_id.data_ptr(),
            cand.data_ptr() if window else 0, counts.data_ptr() if window else 0,
            listed[0].data_ptr() if listed else 0, listed[1].data_ptr() if listed else 0,
            gated[0].data_ptr() if gated else 0, gated[1].data_ptr() if gated else 0, out.data_ptr(), arena,
            scratch.data_ptr(), stream,
        )
    check_scratch(rc, "merge_compact_tracked", key)
    LAUNCHES[mode] += 1
    sym2, w2 = out.unbind(0)
    if gated:
        return sym2, w2, n_new, bins_l, bins_r, samp, pcnt, probes_out, n_aff, g[0]
    if listed:
        return sym2, w2, n_new, bins_l, bins_r, samp, pcnt
    if not window:
        return sym2, w2, n_new, bins_l, bins_r, samp
    return sym2, w2, n_new, bins_l, bins_r, samp, pcnt, probes_out, n_aff


def merge_compact(symbols, weights, n, pair, new_id):
    """One merge with full stable compaction of a hole-free stream:
    ``(sym2, w2, n_new)`` of the probe-less ``merge_compact_tracked``
    (counterpart of the Pallas ``merge_compact``)."""
    return merge_compact_tracked(symbols, weights, n, pair, new_id)[:3]


# ─────────────────────────────── count_pairs2 ────────────────────────────────


def count_pairs2_plain(symbols, weights, n, pair1, pair2):
    """Plain PyTorch version of ``count_pairs2``."""
    dev = symbols.device
    cap = symbols.shape[0]
    nn = min(int(_scalar(n, dev)), cap)
    s = symbols.to(torch.int64)
    nxt = torch.cat([s[1:], torch.zeros(1, dtype=torch.int64, device=dev)])
    tok, ntok = s & TOKEN_MASK, nxt & TOKEN_MASK
    pos = torch.arange(cap, device=dev)
    valid = (pos < nn - 1) & ((nxt & WORD_START_BIT) == 0) & (tok != 0) & (ntok != 0)
    pr = torch.where(valid, (tok << 16) | ntok, 0)
    wm = torch.where(valid, weights.to(torch.int64), 0)
    p1, p2 = _scalar(pair1, dev), _scalar(pair2, dev)
    return torch.stack([wm[pr == p1].sum(), wm[pr == p2].sum()])


def count_pairs2(symbols, weights, n, pair1, pair2):
    """Exact pair-stream counts of two pairs: int64 ``[2]``.

    Pair (p, p+1) adds ``weights[p]`` iff p < n-1, the successor lacks the
    word-start bit and neither token is 0, so pair 0 and pairs with a zero
    member count 0."""
    if on_cpu(symbols, weights):
        return count_pairs2_plain(symbols, weights, n, pair1, pair2)
    from .build import load

    dev = symbols.device
    cap = symbols.shape[0]
    require(symbols, torch.int32, (cap,), "symbols")
    require(weights, torch.int32, (cap,), "weights")
    n, pair1, pair2 = _dev_scalar(n, dev), _dev_scalar(pair1, dev), _dev_scalar(pair2, dev)
    lib = load()["count_pairs2"]
    stream = current_stream(dev)
    key = ("count_pairs2", dev.index, 0, stream)
    scratch = cached_scratch(key, dev, lib.cp_scratch_words)
    out = _pooled(("count_pairs2", dev.index, stream),
                  lambda: list(torch.empty(POOL_CALLS, 2, dtype=torch.int64, device=dev).unbind(0)))
    with on_device(dev):
        rc = lib.count_pairs2(
            symbols.data_ptr(), weights.data_ptr(), cap, n.data_ptr(), pair1.data_ptr(), pair2.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), stream,
        )
    check_scratch(rc, "count_pairs2", key)
    LAUNCHES["count_pairs2"] += 1
    return out


# ──────────────────────────────── window_post ────────────────────────────────

_SCALAR_ORDER = (
    "pair", "count", "next_id", "theta", "ub_new", "fill", "merges_done", "active",
    "early_stop", "use_probes", "n_aff", "c_l", "c_r", "l_ok", "r_ok", "l_tok", "r_tok",
    "has_room",
)


def _ceiling(bins: torch.Tensor, tok: int, c: int) -> int:
    """Created-pair ceiling of one side: subtract the sampled pair's exact
    count from its bin, then max * (1 + 4e-3) + 4 in f32 (product and sum
    rounded separately), clamped to i32 max above 2e9."""
    b2 = bins.reshape(-1).clone()
    h = int(bin_index(torch.tensor(tok)))
    b2[h] = b2[h] - torch.tensor(c, dtype=torch.float32, device=b2.device)
    mx = b2.max() * torch.tensor(1.0 + 4e-3, dtype=torch.float32, device=b2.device)
    mx = mx + torch.tensor(4.0, dtype=torch.float32, device=b2.device)
    v = float(mx)
    return I32_MAX if v > 2e9 else int(v)


def window_post_plain(sc, cand, counts, bins_l, bins_r, log):
    """Plain PyTorch version of the window_post kernel on packed scalars."""
    dev = cand.device
    v = dict(zip(_SCALAR_ORDER, (int(x) for x in sc[:N_SCALARS].tolist())))
    probes = sc[N_SCALARS : N_SCALARS + N_PROBES]
    pcnt = to_i32(sc[N_SCALARS + N_PROBES :])
    pair, md, fill = v["pair"], v["merges_done"], v["fill"]
    active, has_room = v["active"] != 0, v["has_room"] != 0
    live = counts >= 0
    a, b = pair >> 16, pair & TOKEN_MASK
    aff = live & (((cand & TOKEN_MASK) == a) | ((cand >> 16) == b)) & (cand != pair)
    rec = torch.zeros_like(counts)
    for k in range(min(v["n_aff"], N_PROBES)):
        rec = torch.maximum(rec, torch.where(cand == probes[k], pcnt[k], 0))
    cnt = torch.where(aff & (v["use_probes"] != 0), rec, counts)
    cnt = torch.where(live & (cand == pair), 0, cnt)

    z16 = v["next_id"] & TOKEN_MASK
    l_ok, r_ok = v["l_ok"] != 0, v["r_ok"] != 0
    l_pair = ((v["l_tok"] << 16) | z16) & 0xFFFFFFFF if l_ok else INVALID
    r_pair = ((z16 << 16) | v["r_tok"]) & 0xFFFFFFFF if r_ok else INVALID
    cand2 = cand.clone()
    if has_room:
        cand2[fill], cand2[fill + 1] = l_pair, r_pair
        cnt[fill] = v["c_l"] if l_ok else -1
        cnt[fill + 1] = v["c_r"] if r_ok else -1

    ub_merge = max(_ceiling(bins_l, v["l_tok"], v["c_l"]), _ceiling(bins_r, v["r_tok"], v["c_r"]))
    ub_new2 = max(v["ub_new"], ub_merge if active else 0)

    log2 = log.clone()
    row = (pair, v["next_id"], v["count"] & 0xFFFFFFFF)
    for j, val in enumerate(row):
        if 3 * md + j < log2.shape[0]:
            log2[3 * md + j] = val

    adv = 1 if active else 0
    m2 = int(cnt.max())
    pend_pair = int(cand2[cnt == m2].min())
    cert = m2 > v["theta"] and m2 > ub_new2 and m2 >= 2
    sout = torch.tensor(
        [md + adv, fill + 2 if has_room else fill, int(v["early_stop"] != 0 or not active),
         ub_new2, m2, int(cert), (v["next_id"] + adv) & 0xFFFFFFFF, pend_pair],
        dtype=torch.int64, device=dev,
    )
    return cand2, cnt, log2, sout


def pack_scalars(device, *, probes, pcnt, **scalars) -> torch.Tensor:
    """window_post's packed scalar vector: int64 [N_SCALARS + 2 * N_PROBES]
    = the scalars in ``_SCALAR_ORDER``, the probe pairs, the probe counts
    (the plain version's input)."""
    _check_names(scalars)
    return torch.cat([
        torch.stack([_scalar(scalars[k], device) for k in _SCALAR_ORDER]),
        probes.to(device=device, dtype=torch.int64).reshape(N_PROBES),
        pcnt.to(device=device, dtype=torch.int64).reshape(N_PROBES),
    ])


_SCALAR_NAMES = frozenset(_SCALAR_ORDER)
_SCALAR_BYTES = {torch.int64: 8, torch.bool: 1}
# window_post.cu's ScalarRefs: the scalars' device addresses, then their
# element sizes in bytes, in _SCALAR_ORDER
_REFS = struct.Struct(f"<{N_SCALARS}Q{N_SCALARS}i")


def _scalar_bytes(name: str, x: torch.Tensor, device: torch.device) -> int:
    """Element size of a window_post scalar tensor; raises unless it is one
    int64 or bool element on ``device``."""
    size = _SCALAR_BYTES.get(x.dtype)
    if size is None or x.numel() != 1 or x.device != device:
        raise ValueError(f"window_post scalar {name}: want one int64 or bool element on {device}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    return size


def _check_names(scalars: dict) -> None:
    if scalars.keys() != _SCALAR_NAMES:
        raise TypeError(f"window_post scalars: want {sorted(_SCALAR_ORDER)}, got {sorted(scalars)}")


def scalar_refs(device, scalars: dict) -> tuple[bytes, torch.Tensor | None]:
    """Where window_post's scalars live on ``device``, for the kernel to read
    them in place: window_post.cu's ``ScalarRefs`` packed as ``_REFS``, and
    the int64 tensor holding the scalars given as Python ints (one
    ``torch.tensor`` for all of them, None when every scalar is a tensor),
    which the caller keeps alive across the launch. Raises unless each
    tensor is one int64 or bool element on ``device``."""
    _check_names(scalars)
    vals = [scalars[k] for k in _SCALAR_ORDER]
    ints = [int(x) for x in vals if not isinstance(x, torch.Tensor)]
    held = torch.tensor(ints, dtype=torch.int64, device=device) if ints else None
    addr = held.data_ptr() if ints else 0
    ptrs, sizes = [], []
    for k, x in zip(_SCALAR_ORDER, vals):
        if isinstance(x, torch.Tensor):
            sizes.append(_scalar_bytes(k, x, device))
            ptrs.append(x.data_ptr())
        else:
            ptrs.append(addr)
            sizes.append(8)
            addr += 8
    return _REFS.pack(*ptrs, *sizes), held


def window_post(cand, counts, bins_l, bins_r, log, *, probes, pcnt, sout=None, **scalars):
    """Post-merge window update (counterpart of the Pallas ``window_post``).

    ``log`` is the int64 merge log, flat ``[BATCH_MERGES * 3]``; ``probes``
    and ``pcnt`` are int64 ``[N_PROBES]``. The keyword scalars are those of
    ``_SCALAR_ORDER``: Python ints or one-element int64 or bool tensors on
    the window's device, views included (``count`` is the merged pair's
    count, ``has_room`` already includes the active gate). On the card the
    kernel reads each tensor in place: one launch, nothing else. Returns
    ``(cand2, counts2, log2, sout)`` with ``sout`` int64 ``[8]`` =
    (merges_done2, fill2, early2, ub_new2, pend_count, pend_cert, next_id2,
    pend_pair), pair ids and next_id as unsigned values. Given ``sout``
    (int64 ``[8]``, contiguous, on the window's device: the gated merge's
    ``Gated.sout``), the call writes it there and returns it.
    """
    dev = cand.device
    if on_cpu(cand, counts, bins_l, bins_r, log, probes, pcnt):
        for k, x in scalars.items():
            if isinstance(x, torch.Tensor):
                _scalar_bytes(k, x, dev)
        sc = pack_scalars(dev, probes=probes, pcnt=pcnt, **scalars)
        out = window_post_plain(sc, cand, counts, bins_l, bins_r, log)
        if sout is None:
            return out
        require(sout, torch.int64, (SOUT_WORDS,), "sout")
        return (*out[:3], sout.copy_(out[3]))
    from .build import load

    require(cand, torch.int64, (W_SLOTS,), "cand")
    require(counts, torch.int64, (W_SLOTS,), "counts")
    require(bins_l, torch.float32, (TRACK_SIDE, TRACK_SIDE), "bins_l")
    require(bins_r, torch.float32, (TRACK_SIDE, TRACK_SIDE), "bins_r")
    require(log, torch.int64, None, "log")
    require(probes, torch.int64, (N_PROBES,), "probes")
    require(pcnt, torch.int64, (N_PROBES,), "pcnt")
    if sout is not None:
        require(sout, torch.int64, (SOUT_WORDS,), "sout")
        if sout.device != dev:
            raise ValueError(f"window_post: sout on {sout.device}, the window on {dev}")
    refs, held = scalar_refs(dev, scalars)  # `held` stays alive until the launch is enqueued
    n_log = log.shape[0]
    out = torch.empty(2 * W_SLOTS + n_log + (0 if sout is not None else SOUT_WORDS), dtype=torch.int64, device=dev)
    base = out.data_ptr()
    if sout is None:
        sout = out[-SOUT_WORDS:]
    with on_device(dev):
        rc = load()["window_post"].window_post(
            refs, ptr(probes), ptr(pcnt), ptr(cand), ptr(counts), ptr(bins_l),
            ptr(bins_r), ptr(log), n_log, base, base + 8 * W_SLOTS, base + 16 * W_SLOTS,
            sout.data_ptr(), current_stream(dev),
        )
    check(rc, "window_post")
    LAUNCHES["window_post"] += 1
    return out[:W_SLOTS], out[W_SLOTS : 2 * W_SLOTS], out[2 * W_SLOTS : 2 * W_SLOTS + n_log], sout


# ───────────────────────── compact_mask / compact_valid ──────────────────────

MAX_EXTRA = 9  # arrays riding along in compact_mask (compact_mask.cu MAX_EXTRA)
COMPACT_TILE = 4096  # entries per block of compact_mask.cu (TILE_N, cm_tile_entries())


def compact_mask_plain(vals, extras=()):
    """Plain PyTorch version of ``compact_mask`` (zeros past the total)."""
    keep = vals != -1
    outs = []
    for src in (vals & TOKEN_MASK, *extras):
        kept = src[keep]
        out = torch.zeros_like(src)
        out[: kept.shape[0]] = kept
        outs.append(out)
    return outs, keep.sum()


def _compact_launch(name: str, vals, extras):
    from .build import load

    dev = vals.device
    n = vals.shape[0]
    require(vals, torch.int32, (n,), "vals")
    if len(extras) > MAX_EXTRA:
        raise ValueError(f"{name}: at most {MAX_EXTRA} extras, got {len(extras)}")
    for e in extras:
        require(e, torch.int32, (n,), "extra")
    lib = load()["compact_mask"]
    out = torch.empty_like(vals)
    outs = [torch.empty_like(e) for e in extras]
    # word 0 is the total, the rest the kernel's tile counter and status words
    words = torch.empty(1 + int(lib.cm_scratch_words(n)), dtype=torch.int64, device=dev)
    ptrs = struct.Struct(f"<{len(extras)}Q")
    with on_device(dev):
        rc = lib.compact_mask(
            ptr(vals), n, ptrs.pack(*[e.data_ptr() for e in extras]), ptrs.pack(*[o.data_ptr() for o in outs]),
            len(extras), ptr(out), words.data_ptr(), words.data_ptr() + 8, current_stream(dev),
        )
    total = words[0]
    check(rc, name)
    LAUNCHES[name] += 1
    return [out, *outs], total


def compact_mask(vals, extras=()):
    """Stable compaction under the mask ``vals != INVALID``.

    ``vals`` and each of the at most ``MAX_EXTRA`` ``extras`` are int32
    ``[n]`` u32 words. Returns ``([primary, *extras_c], total)``: arrays of
    length n whose first ``total`` entries are the survivors in order (the
    primary keeps the low 16 bits of its words, the extras their full
    words); what lies past ``total`` is unspecified. ``total`` is a 0-d
    int64 tensor on the device."""
    extras = tuple(extras)
    if on_cpu(vals, *extras):
        return compact_mask_plain(vals, extras)
    return _compact_launch("compact_mask", vals, extras)


def compact_valid(vals):
    """``compact_mask`` without extras (the tokenizer's PAD strip): returns
    ``(compacted, total)``."""
    if on_cpu(vals):
        outs, total = compact_mask_plain(vals)
    else:
        outs, total = _compact_launch("compact_valid", vals, ())
    return outs[0], total


# ─────────────────────────────── expand_to_mask ──────────────────────────────

EXPAND_TILE = 8192  # entries per block of expand_to_mask.cu (TILE_N, em_tile_entries())


def expand_to_mask_plain(mask, vals):
    """Plain PyTorch version of ``expand_to_mask``."""
    out = torch.zeros(mask.shape[0], dtype=torch.int32, device=mask.device)
    out[mask] = vals[: int(mask.sum())]
    return out


def expand_to_mask(mask, vals):
    """The inverse of ``compact_mask``: int32 ``[n]`` with ``vals[r]`` at the
    r-th set entry of the bool ``[n]`` ``mask`` and 0 elsewhere. ``vals``
    (int32) must hold at least as many entries as ``mask`` has set."""
    if on_cpu(mask, vals):
        return expand_to_mask_plain(mask, vals)
    from .build import load

    dev = mask.device
    n = mask.shape[0]
    require(mask, torch.bool, (n,), "mask")
    require(vals, torch.int32, None, "vals")
    lib = load()["expand_to_mask"]
    stream = current_stream(dev)
    scratch = cached_scratch(("expand_to_mask", dev.index, n, stream), dev, lambda: lib.em_scratch_words(n))
    out = torch.empty(n, dtype=torch.int32, device=dev)
    with on_device(dev):
        rc = lib.expand_to_mask(ptr(mask), n, ptr(vals), vals.numel(), ptr(out), ptr(scratch), stream)
    check(rc, "expand_to_mask")
    LAUNCHES["expand_to_mask"] += 1
    return out
