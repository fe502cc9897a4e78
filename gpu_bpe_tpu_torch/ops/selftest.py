"""Kernel selftest: every kernel of the port on one device, held to numpy
references and to its plain PyTorch version (the port's counterpart of
``gpu_bpe_tpu/ops/selftest.py``, with the same cases, names, seeds and
sizes, and two more: ``overlay_fit`` and ``dense_match``).

``run_kernel_selftest()`` runs on the card by default: it is how a user
checks the CUDA kernels on their own card. ``device="cpu"`` runs the same
cases through the plain versions. A case that disagrees is False in the
result; an exception (a failed build or launch) propagates.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import BATCH_MERGES, TOKEN_MASK, WORD_START_BIT, pack_pair
from . import kernels as K
from .stab_kernels import overlay_fit, overlay_fit_plain

BLOCK = 32768  # stream length of the cases' block-boundary layouts

CASES = (
    "random_stream", "overlap_quirk", "block_boundary_sites", "poisoned_tail", "tracked_hist_multiblock",
    "count_pairs2", "window_probe_prep", "probe_count_heavy", "window_post", "compact_valid",
    "compact_expand_roundtrip", "overlay_fit", "dense_match",
)


def _random_stream(rng, n, alphabet=6, ws_p=0.15):
    cap = ((n + 1023) // 1024) * 1024 + 1024
    toks = rng.integers(1, alphabet, size=n).astype(np.uint32)
    ws = rng.random(n) < ws_p
    sym = toks | (ws.astype(np.uint32) << 16)
    sym[0] |= 1 << 16
    w = rng.integers(1, 9, size=n).astype(np.int32)
    symf = np.zeros(cap, np.uint32)
    symf[:n] = sym
    wf = np.zeros(cap, np.int32)
    wf[:n] = w
    return symf, wf


def apply_merge_np(sym: np.ndarray, w: np.ndarray, n: int, pair: int, new_id: int):
    """numpy oracle of one merge with compaction (the JAX package's
    ``apply_merge_device``): sites (p, p+1) with p < n - 1 and no word start
    at p + 1 become ``new_id | ws``, each site's successor is dropped; the
    tail past the new count is zero."""
    cap = len(sym)
    s = sym.astype(np.int64)
    nxt = np.append(s[1:], 0)
    a, b = pair >> 16, pair & TOKEN_MASK
    pos = np.arange(cap)
    sites = (pos < n - 1) & ((s & TOKEN_MASK) == a) & ((nxt & TOKEN_MASK) == b) & ((nxt & WORD_START_BIT) == 0)
    merged = np.where(sites, new_id | (s & WORD_START_BIT), s)
    removed = np.append(False, sites[:-1])
    keep = (pos < n) & ~removed
    n_new = int(keep.sum())
    sym2 = np.zeros(cap, np.int64)
    w2 = np.zeros(cap, np.int64)
    sym2[:n_new] = merged[keep]
    w2[:n_new] = w.astype(np.int64)[keep]
    return sym2, w2, n_new


def masked_pairs_np(sym: np.ndarray, w: np.ndarray, n: int):
    """Pair ids and weights of a hole-free stream as the recount sees them:
    (p, p+1) counts iff p < n - 1, p + 1 has no word start and neither
    token is 0; (0, 0) elsewhere."""
    s = np.asarray(sym).astype(np.int64) & 0xFFFFFFFF
    nxt = np.append(s[1:], 0)
    tok, ntok = s & TOKEN_MASK, nxt & TOKEN_MASK
    valid = (np.arange(len(s)) < n - 1) & ((nxt & WORD_START_BIT) == 0) & (tok != 0) & (ntok != 0)
    return np.where(valid, (tok << 16) | ntok, 0), np.where(valid, np.asarray(w).astype(np.int64), 0)


def _bins_np(toks, wts) -> np.ndarray:
    """The created-pair histogram of tokens and weights: exact int64 sums
    per hash bin, rounded to f32 once."""
    t = np.asarray(toks).astype(np.int64) & TOKEN_MASK
    h = (((t * 2654435761) & 0xFFFFFFFF) >> 16) & (K.TRACK_SIDE * K.TRACK_SIDE - 1)
    out = np.zeros(K.TRACK_SIDE * K.TRACK_SIDE, np.int64)
    np.add.at(out, h, np.asarray(wts).astype(np.int64))
    return out.astype(np.float32).reshape(K.TRACK_SIDE, K.TRACK_SIDE)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _equal(got, want) -> bool:
    return all(np.array_equal(_np(g), _np(w)) for g, w in zip(got, want, strict=True))


def run_kernel_selftest(device: str | torch.device = "cuda") -> dict[str, bool]:
    """Run every case on ``device``; returns {case: passed}, in ``CASES``
    order."""
    from .trainer import resolve_device

    dev = resolve_device(device)
    results: dict[str, bool] = {}

    def i32(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(np.uint32).view(np.int32))).to(dev)

    def stream_args(symf, wf, n):
        return i32(symf), torch.from_numpy(np.asarray(wf, np.int32)).to(dev), torch.tensor(n, device=dev)

    def check_merge(name, symf, wf, n, pair, new_id=300):
        clean_s, clean_w = symf.copy(), wf.copy()
        clean_s[n:], clean_w[n:] = 0, 0
        ref_s, ref_w, ref_n = apply_merge_np(clean_s, clean_w, n, pair, new_id)
        sym2, w2, n2 = K.merge_compact(*stream_args(symf, wf, n), pair, new_id)
        results[name] = (np.array_equal(_np(sym2).astype(np.int64) & 0xFFFFFFFF, ref_s)
                         and np.array_equal(_np(w2), ref_w) and int(n2) == ref_n)

    rng = np.random.default_rng(7)

    # 1. random stream (mid-size, several blocks)
    symf, wf = _random_stream(rng, 70_000)
    check_merge("random_stream", symf, wf, 70_000, pack_pair(2, 3))

    # 2. the overlap-collapse quirk: "aaaa..." merging (a,a)
    symf = np.zeros(2048, np.uint32)
    symf[:300] = 1
    symf[0] |= 1 << 16
    wf = np.zeros(2048, np.int32)
    wf[:300] = 1
    check_merge("overlap_quirk", symf, wf, 300, pack_pair(1, 1))

    # 3. sites straddling block boundaries
    n = BLOCK * 2 + 100
    cap = ((n + 1023) // 1024) * 1024 + 1024
    symf = np.zeros(cap, np.uint32)
    symf[:n] = 7
    symf[0] |= 1 << 16
    for p in (BLOCK - 2, BLOCK - 1, BLOCK, 2 * BLOCK - 1, 2 * BLOCK):
        symf[p] = 2
        symf[p + 1] = 3
    wf = np.zeros(cap, np.int32)
    wf[:n] = 1
    check_merge("block_boundary_sites", symf, wf, n, pack_pair(2, 3))

    # 4. poisoned tail: pair-matching garbage past n must not leak
    n, cap = 40_000, 65_536
    base_s, base_w = _random_stream(rng, n)
    symf = np.zeros(cap, np.uint32)
    symf[:n] = base_s[:n]
    wf = np.zeros(cap, np.int32)
    wf[:n] = base_w[:n]
    symf[n:] = np.tile([2, 3], (cap - n) // 2).astype(np.uint32)
    wf[n:] = 999
    check_merge("poisoned_tail", symf, wf, n, pack_pair(2, 3))

    # 5. created-pair tracking (histograms and sample) against numpy, over
    #    several blocks, and the whole output against the plain version
    n = 3 * BLOCK // 2 + 77
    symf, wf = _random_stream(rng, n, alphabet=10)
    args = (*stream_args(symf, wf, n), pack_pair(5, 7), 300)
    got = K.merge_compact_tracked(*args)
    sym2, w2 = _np(got[0]).astype(np.int64) & 0xFFFFFFFF, _np(got[1]).astype(np.int64)
    zm = (sym2 & TOKEN_MASK) == 300
    prev2, next2 = np.roll(sym2, 1), np.roll(sym2, -1)
    wl = np.where(zm & ((sym2 & WORD_START_BIT) == 0), w2, 0)
    wr = np.where(zm & ((next2 & WORD_START_BIT) == 0), w2, 0)
    samp = _np(got[5])
    ok = np.array_equal(_np(got[3]), _bins_np(prev2, wl)) and np.array_equal(_np(got[4]), _bins_np(next2, wr))
    ok &= samp[0] == wl.max() and samp[2] == wr.max()
    ok &= _equal(got, K.merge_compact_tracked_plain(*args))
    results["tracked_hist_multiblock"] = bool(ok)

    # 5b. count_pairs2 against a numpy count, with a boundary-straddling
    #     occurrence and the sentinel pair 1 (a token-0 pair: counts 0)
    n, cap5 = BLOCK + 200, 2 * BLOCK
    symf = np.zeros(cap5, np.uint32)
    symf[:n] = 7
    symf[0] |= 1 << 16
    symf[BLOCK - 1], symf[BLOCK] = 2, 3
    wf = np.zeros(cap5, np.int32)
    wf[:n] = 4
    got = _np(K.count_pairs2(*stream_args(symf, wf, n), pack_pair(2, 3), 1))
    p5, w5 = masked_pairs_np(symf, wf, n)
    results["count_pairs2"] = bool(got[0] == w5[p5 == pack_pair(2, 3)].sum() and got[1] == 0)

    # 5c. window mode's probe set-up against the explicit-probe mode given
    #     the affected subset (probes, n_aff, pcnt), with the streams, bins
    #     and samples of the two calls equal
    n = BLOCK + 333
    symf, wf = _random_stream(rng, n, alphabet=12)
    pair = pack_pair(5, 7)
    cand = np.full(K.W_SLOTS, K.INVALID, np.int64)
    counts = np.full(K.W_SLOTS, -1, np.int64)
    wins = [pack_pair(3, 5), pack_pair(7, 2), pack_pair(5, 7), pack_pair(9, 9), pack_pair(2, 5), pack_pair(7, 7)]
    for k, pw in enumerate(wins):
        cand[k], counts[k] = pw, 100 - k
    live = counts >= 0
    aff = live & (((cand & TOKEN_MASK) == pair >> 16) | ((cand >> 16) == pair & TOKEN_MASK)) & (cand != pair)
    exp_list = np.ones(K.N_PROBES, np.int64)
    exp_list[: aff.sum()] = cand[aff]
    args = (*stream_args(symf, wf, n), pair, 300)
    out_w = K.merge_compact_tracked(*args, torch.from_numpy(cand).to(dev), torch.from_numpy(counts).to(dev))
    out_e = K.merge_compact_tracked(*args, probes=(torch.from_numpy(exp_list).to(dev), int(aff.sum())))
    ok = int(out_w[8]) == int(aff.sum()) and np.array_equal(_np(out_w[7]), exp_list)
    ok &= _equal(out_w[:7], out_e)
    results["window_probe_prep"] = bool(ok)

    # 5c2. probe counts against numpy with single-site weights past 2^16:
    #      the counts' high bits must survive
    n = 2 * BLOCK + 77
    symf, wf = _random_stream(rng, n, alphabet=8)
    wf = wf.astype(np.int32) * 40_000
    pair = pack_pair(3, 4)
    cand = np.full(K.W_SLOTS, K.INVALID, np.int64)
    counts = np.full(K.W_SLOTS, -1, np.int64)
    wins = [pack_pair(2, 3), pack_pair(4, 5), pack_pair(6, 3), pack_pair(4, 7), pack_pair(1, 3), pack_pair(4, 2)]
    for k, pw in enumerate(wins):
        cand[k], counts[k] = pw, 10 + k
    out = K.merge_compact_tracked(*stream_args(symf, wf, n), pair, 300, torch.from_numpy(cand).to(dev),
                                  torch.from_numpy(counts).to(dev))
    naff = int(out[8])
    ok, any_heavy = 0 < naff <= K.N_PROBES, False
    if ok:
        p_h, w_h = masked_pairs_np(_np(out[0]), _np(out[1]), int(out[2]))
        pc, pr = _np(out[6]), _np(out[7])
        for k in range(naff):
            want = int(w_h[p_h == pr[k]].sum())
            any_heavy |= want > (1 << 16)
            ok &= int(pc[k]) == want
    results["probe_count_heavy"] = bool(ok and any_heavy)

    # 5d. window_post against a numpy reference of the window update (count
    #     adoption, scratch append, histogram exclusion and ceiling, log
    #     row, scalar advances, next winner)
    r2 = np.random.default_rng(11)
    cand = r2.integers(1, 1 << 17, size=K.W_SLOTS).astype(np.int64)
    cand[0] = pack_pair(5, 7)
    counts = r2.integers(0, 1000, size=K.W_SLOTS).astype(np.int64)
    counts[200:], cand[200:] = -1, K.INVALID
    pair = pack_pair(5, 7)
    bins_l = r2.random((K.TRACK_SIDE, K.TRACK_SIDE)).astype(np.float32) * 500
    bins_r = r2.random((K.TRACK_SIDE, K.TRACK_SIDE)).astype(np.float32) * 500
    probes = cand[: K.N_PROBES].copy()
    pcnt = r2.integers(0, 800, size=K.N_PROBES).astype(np.int64)
    scalars = dict(pair=pair, count=321, next_id=300, theta=400, ub_new=350, fill=180, merges_done=9, active=1,
                   early_stop=0, use_probes=1, n_aff=6, c_l=77, c_r=55, l_ok=1, r_ok=1, l_tok=9, r_tok=12,
                   has_room=1)
    t = {k: torch.from_numpy(v).to(dev) for k, v in dict(cand=cand, counts=counts, bins_l=bins_l, bins_r=bins_r,
                                                          probes=probes, pcnt=pcnt).items()}
    log = torch.zeros(BATCH_MERGES * 3, dtype=torch.int64, device=dev)
    cand2, counts2, log2, sout = (_np(x) for x in K.window_post(
        t["cand"], t["counts"], t["bins_l"], t["bins_r"], log, probes=t["probes"], pcnt=t["pcnt"], **scalars))
    a, b = pair >> 16, pair & TOKEN_MASK
    live = counts >= 0
    aff = live & (((cand & TOKEN_MASK) == a) | ((cand >> 16) == b)) & (cand != pair)
    rec = np.zeros(K.W_SLOTS, np.int64)
    for k in range(6):
        rec = np.maximum(rec, np.where(cand == probes[k], pcnt[k], 0))
    cexp = np.where(live & (cand == pair), 0, np.where(aff, rec, counts))
    pexp = cand.copy()
    pexp[180], pexp[181] = (9 << 16) | 300, (300 << 16) | 12
    cexp[180], cexp[181] = 77, 55

    def ceiling(bins, tok, c):
        h = ((tok * 2654435761) & 0xFFFFFFFF) >> 16 & 255
        b2 = bins.copy().reshape(-1)
        b2[h] -= c
        mx = np.float32(np.float32(b2.max()) * np.float32(1.0 + 4e-3) + np.float32(4.0))
        return int(mx) if mx <= 2e9 else 2**31 - 1

    ub_exp = max(350, ceiling(bins_l, 9, 77), ceiling(bins_r, 12, 55))
    m2 = cexp.max()
    ok = np.array_equal(cand2, pexp) and np.array_equal(counts2, cexp)
    ok &= sout[3] == ub_exp and sout[0] == 10 and sout[1] == 182 and sout[2] == 0 and sout[6] == 301
    ok &= sout[7] == cand2[cexp == m2].min() and sout[4] == m2
    ok &= (sout[5] != 0) == bool(m2 > 400 and m2 > ub_exp and m2 >= 2)
    ok &= log2[27] == pair and log2[28] == 300 and log2[29] == 321
    results["window_post"] = bool(ok)

    # 6. compact_valid (the tokenizer's PAD strip): sparse survivors with
    #    dropped runs across block boundaries and a ragged length
    n = 3 * BLOCK + 500
    vals = rng.integers(0, 0xFFFF, size=n, dtype=np.uint32).astype(np.uint32)
    vals[rng.random(n) < 0.7] = 0xFFFFFFFF
    vals[BLOCK - 64 : BLOCK + 64] = 0xFFFFFFFF
    out, total = K.compact_valid(i32(vals))
    ref_c = vals[vals != 0xFFFFFFFF]
    results["compact_valid"] = bool(int(total) == len(ref_c) and np.array_equal(
        _np(out)[: len(ref_c)].view(np.uint32), ref_c))

    # 7. compact_mask with a full-width extra, then expand_to_mask back to
    #    the kept positions (the rank-space join's round trip)
    n = 2 * BLOCK + 300
    prim = rng.integers(0, 0xFFFF, size=n, dtype=np.uint32)
    drop = rng.random(n) < 0.8
    prim[drop] = 0xFFFFFFFF
    ex = rng.integers(0, 2**32 - 1, size=n, dtype=np.uint32)
    outs, tot = K.compact_mask(i32(prim), [i32(ex)])
    keep = ~drop
    g = int(keep.sum())
    ok = int(tot) == g
    ok &= np.array_equal(_np(outs[0])[:g].view(np.uint32), prim[keep])
    ok &= np.array_equal(_np(outs[1])[:g].view(np.uint32), ex[keep])
    back = K.expand_to_mask(torch.from_numpy(keep).to(dev), outs[1])
    ok &= np.array_equal(_np(back).view(np.uint32), np.where(keep, ex, 0).astype(np.uint32))
    results["compact_expand_roundtrip"] = bool(ok)

    # 8. overlay_fit (no Pallas selftest case): two segments of random rows
    #    (opens and closes at depths 0..11, positions), each sorted by its
    #    payload, against the plain version
    r3 = np.random.default_rng(13)
    nseg, m = 2, 5000
    flag = np.where(r3.random((nseg, m)) < 0.1, r3.choice([0, 2], size=(nseg, m)), 1).astype(np.uint32)
    depth = r3.integers(0, 12, size=(nseg, m), dtype=np.uint32)
    pay = np.where(flag == 1, r3.integers(0, 20_000, size=(nseg, m)),
                   r3.integers(0, 1 << 16, size=(nseg, m))).astype(np.uint32)
    kp = (flag << 30) | (depth << 25) | pay
    kp = np.take_along_axis(kp, np.argsort(pay, axis=1, kind="stable"), axis=1)
    kw = dict(chunk_size=512, depths=10, base_len=0, max_depth=8, group_depth=9)
    got = overlay_fit(i32(kp), 20_000, **kw)
    want = overlay_fit_plain(i32(kp).cpu(), 20_000, **kw)
    results["overlay_fit"] = _equal(got, want)

    # 9. dense_match (no Pallas selftest case): 300 keys of 2..20 bytes over
    #    four letters, and keys of NUL and 0xFF bytes, on a pass of three
    #    tiles and 300 bytes whose input ends inside a 512-byte chunk; the
    #    single-byte step in the kernel, an incoming match, and a table at
    #    its least size (colliding probes), against the plain version
    from .dense_kernels import TILE, DenseHash, DenseTables, dense_match, dense_match_plain
    from .tokenize import MatchTables

    r4 = np.random.default_rng(17)
    keys = {bytes(r4.integers(97, 101, size=int(r4.integers(2, 21))).tolist()) for _ in range(300)}
    keys |= {b"\x00\x00", b"ab\x00", b"ab\x00\x00\x00\x00", b"\xff" * 5, b"\x00\xff" * 4}
    tables = MatchTables.from_vocab([bytes([b]) for b in range(256)] + sorted(keys))
    words = sorted(keys)
    text = b"".join(words[int(i)] if i < len(words) else b"\x00\xff"[: int(i) % 3]
                    for i in r4.integers(0, len(words) + 60, size=3000))
    n = 3 * TILE + 300
    data = np.frombuffer((text * 2)[:n], dtype=np.uint8).copy()
    in_id = r4.integers(-1, 2000, size=n)
    in_len = r4.integers(0, 9, size=n)
    ok = True
    for n_slots in (None, 1 << len(keys).bit_length()):
        hashed = DenseHash.build(tables, n_slots=n_slots)
        on_dev, on_cpu = DenseTables(tables, hashed, dev), DenseTables(tables, hashed, "cpu")
        for incoming in ((), (in_id, in_len)):
            args = [torch.from_numpy(data), n - 700, 512, *[torch.from_numpy(a) for a in incoming]]
            got = dense_match(args[0].to(dev), on_dev, *args[1:3], *[a.to(dev) for a in args[3:]])
            want = dense_match_plain(args[0], on_cpu, *args[1:])
            ok &= _equal(got, want) and bool((want[1] > 1).any())
    results["dense_match"] = bool(ok)

    return {k: results[k] for k in CASES}
