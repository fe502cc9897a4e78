"""The port's three training kernels (plain PyTorch versions, CPU) against
the Pallas functions of gpu_bpe_tpu in interpret mode.

Tolerance: bitwise on every integer output. The exceptions are the ones
the port states: ``bins`` (allclose to the Pallas one-hot matmul bins,
exactly equal to a numpy ``np.add.at`` histogram of the same mass) and the
``samp`` token on weight ties (the port takes the smallest token among all
positions of the heaviest weight; the Pallas token must lie in that set).
"""

import struct

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from gpu_bpe_tpu.ops import pallas_kernels as pk  # noqa: E402
from gpu_bpe_tpu_torch.constants import BATCH_MERGES, pack_pair  # noqa: E402
from gpu_bpe_tpu_torch.ops import build  # noqa: E402
from gpu_bpe_tpu_torch.ops import kernels as tk  # noqa: E402

BLOCK = pk.BLOCK
SMALL_CAP = 4096
BIG_CAP = 50176  # 1.5 x BLOCK streams fit with a zero tail


def _stream(rng, n, cap, toks, ws_p=0.15):
    """Random stream over ``toks`` (word starts with probability ws_p),
    zero past n."""
    sym = np.zeros(cap, np.uint32)
    sym[:n] = rng.choice(np.asarray(toks, np.uint32), size=n)
    sym[:n] |= (rng.random(n) < ws_p).astype(np.uint32) << 16
    sym[0] |= 1 << 16
    w = np.zeros(cap, np.int32)
    w[:n] = rng.integers(1, 9, size=n)
    return sym, w


def _window(rng, toks, pair, n_aff, n_other=40):
    """A 256-slot window with exactly ``n_aff`` affected live slots for
    ``pair`` plus unaffected live slots, the merged pair itself and dead
    slots."""
    a, b = pair >> 16, pair & 0xFFFF
    aff = [pack_pair(t, a) for t in toks] + [pack_pair(b, t) for t in toks]
    aff = [p for p in dict.fromkeys(aff) if p != pair]
    assert len(aff) >= n_aff
    picked = list(rng.permutation(aff)[:n_aff])
    others = [pack_pair(x, y) for x in toks for y in toks if x != b and y != a]
    picked += list(rng.permutation(others)[:n_other]) + [pair]
    cand = np.full(tk.W_SLOTS, 0xFFFFFFFF, np.uint32)
    counts = np.full(tk.W_SLOTS, -1, np.int32)
    slots = rng.permutation(tk.W_SLOTS)[: len(picked)]
    cand[slots] = picked
    counts[slots] = rng.integers(0, 5000, size=len(picked))
    return cand, counts


def _jax_merge(sym, w, n, pair, new_id, cand, counts):
    out = pk.merge_compact_tracked(
        jnp.asarray(sym), jnp.asarray(w), jnp.asarray(n), jnp.uint32(pair), jnp.uint32(new_id),
        window=(jnp.asarray(cand), jnp.asarray(counts)), interpret=True,
    )
    return [np.asarray(o) for o in out]


def _port_merge(sym, w, n, pair, new_id, cand, counts):
    out = tk.merge_compact_tracked(
        torch.from_numpy(sym.astype(np.int32)), torch.from_numpy(w), n, pair, new_id,
        torch.from_numpy(cand.astype(np.int64)), torch.from_numpy(counts.astype(np.int64)),
    )
    return [o.numpy() for o in out]


def _ref_tracking(sym2, w2, n2, new_id):
    """numpy reference of the created-pair histograms and max weights over
    the pairs (q, q+1), q < min(n', cap-1) of the compacted stream."""
    lim = min(n2, len(sym2) - 1)
    u, v = sym2[:lim].astype(np.int64), sym2[1 : lim + 1].astype(np.int64)
    uw, vw = w2[:lim].astype(np.int64), w2[1 : lim + 1].astype(np.int64)
    ut, vt = u & 0xFFFF, v & 0xFFFF
    ok = (v & 0x10000) == 0
    z = new_id & 0xFFFF
    lm, rm = ok & (vt == z) & (vw > 0), ok & (ut == z) & (uw > 0)

    def hist(toks, wts):
        h = (((toks * 2654435761) & 0xFFFFFFFF) >> 16) & 255
        out = np.zeros(256, np.int64)
        np.add.at(out, h, wts)
        return out.reshape(16, 16)

    return hist(ut[lm], vw[lm]), hist(vt[rm], uw[rm]), (lm, vw, ut), (rm, uw, vt)


def _compare_merge(sym, w, n, pair, new_id, cand, counts):
    j = _jax_merge(sym, w, n, pair, new_id, cand, counts)
    p = _port_merge(sym, w, n, pair, new_id, cand, counts)
    sym2, w2 = p[0].astype(np.uint32), p[1]
    np.testing.assert_array_equal(sym2, j[0])
    np.testing.assert_array_equal(w2, j[1])
    n2 = int(p[2])
    assert n2 == int(j[2])
    hl, hr, left, right = _ref_tracking(sym2, w2, n2, new_id)
    np.testing.assert_array_equal(p[3], hl.astype(np.float32))
    np.testing.assert_array_equal(p[4], hr.astype(np.float32))
    np.testing.assert_allclose(p[3], j[3], rtol=1e-5)
    np.testing.assert_allclose(p[4], j[4], rtol=1e-5)
    samp_p, samp_j = p[5], j[5].astype(np.int64)
    for side, (mask, wts, toks) in ((0, left), (2, right)):
        assert samp_p[side] == samp_j[side]
        if samp_p[side] > 0:
            at_max = set(toks[mask & (wts == samp_p[side])].tolist())
            assert samp_p[side + 1] == min(at_max)
            assert int(samp_j[side + 1]) in at_max
    n_aff = int(p[8])
    assert n_aff == int(j[8][0])
    np.testing.assert_array_equal(p[7], j[7].astype(np.int64) & 0xFFFFFFFF)
    npe = n_aff if n_aff <= tk.N_PROBES else 0
    np.testing.assert_array_equal(p[6][:npe], j[6][:npe])
    return p


TOKS_LOW = list(range(1, 7))
TOKS_HIGH = [0x8000 + 17 * i for i in range(6)] + [0xFFFE]


@pytest.mark.parametrize(
    "seed,n,toks",
    [(0, 16, TOKS_LOW), (1, 2771, TOKS_LOW), (2, 4000, TOKS_HIGH), (3, 3000, list(range(1, 40))),
     (4, 0, TOKS_LOW), (5, 1, TOKS_LOW), (6, 2, TOKS_LOW), (7, SMALL_CAP, TOKS_LOW),
     (8, SMALL_CAP, TOKS_HIGH)],
)
def test_random_streams(seed, n, toks):
    """Random streams, n in {0, 1, 2} among them, and full streams (n ==
    cap) with a site at cap - 2: its removal at cap - 1 leaves one zero slot,
    the pad pair of the last symbol."""
    rng = np.random.default_rng(seed)
    sym, w = _stream(rng, n, SMALL_CAP, toks)
    pair = pack_pair(toks[1], toks[2])
    if n == SMALL_CAP:
        sym[n - 2], sym[n - 1] = toks[1], toks[2]
    cand, counts = _window(rng, toks, pair, n_aff=min(5, 2 * len(toks) - 1))
    _compare_merge(sym, w, n, pair, 0x9000 if toks is TOKS_HIGH else 300, cand, counts)


@pytest.mark.parametrize("n_aff", [0, 1, 9, 16, 17, 40, 64, 65, 75])
def test_window_probe_tiers(n_aff):
    """Affected sets in each 16-probe tier and above N_PROBES (nothing
    probed), with ids >= 0x8000 on both sides of the merged pair."""
    rng = np.random.default_rng(100 + n_aff)
    toks = [0x8000 + 3 * i for i in range(45)]
    sym, w = _stream(rng, 3500, SMALL_CAP, toks, ws_p=0.1)
    pair = pack_pair(toks[0], toks[1])
    cand, counts = _window(rng, toks, pair, n_aff)
    _compare_merge(sym, w, 3500, pair, 0xC123, cand, counts)


def test_crosses_block_boundary():
    """A stream of 1.5 x BLOCK with sites and word starts straddling the
    32K block edge."""
    rng = np.random.default_rng(7)
    n = 3 * BLOCK // 2 + 77
    toks = [1, 2, 3, 4, 5]
    sym, w = _stream(rng, n, BIG_CAP, toks)
    for p in (BLOCK - 2, BLOCK - 1, BLOCK):
        sym[p], sym[p + 1] = 2, 3
    sym[BLOCK + 5] = 2
    sym[BLOCK + 6] = 3 | (1 << 16)  # word start on the b side blocks the site
    pair = pack_pair(2, 3)
    cand, counts = _window(rng, toks, pair, n_aff=6)
    _compare_merge(sym, w, n, pair, 300, cand, counts)


@pytest.mark.parametrize("cap,n", [(SMALL_CAP, 300), (BIG_CAP, 20_000)])
def test_overlap_quirk_runs(cap, n):
    """Runs of identical symbols under (a,a) collapse (read-all-before-
    write): "aaa" -> "Z". At BIG_CAP one run spans positions 153..8999, so
    it crosses the 4096-entry compaction tiles' edges at 4096 and 8192 and
    leaves the whole tile [4096, 8192) without a survivor; a word start at
    9000 restarts it, and random tokens follow from 13000."""
    sym = np.zeros(cap, np.uint32)
    sym[:n] = 1
    sym[0] |= 1 << 16
    sym[100] |= 1 << 16
    sym[150:153] = 2
    if n > 13_000:
        sym[9000] |= 1 << 16
        sym[13_000:n] = np.random.default_rng(1).integers(1, 4, size=n - 13_000)
    w = np.zeros(cap, np.int32)
    w[:n] = 3
    rng = np.random.default_rng(0)
    cand, counts = _window(rng, [1, 2], pack_pair(1, 1), n_aff=2)
    p = _compare_merge(sym, w, n, pack_pair(1, 1), 300, cand, counts)
    assert int(p[2]) < n
    if n > 13_000:
        assert int(p[2]) < n - 13_000 + 10  # each run collapsed to one symbol


def test_word_start_blocks_merge():
    n = 64
    sym = np.zeros(SMALL_CAP, np.uint32)
    sym[:n] = np.tile([2, 3], n // 2)
    sym[0] |= 1 << 16
    sym[33] |= 1 << 16
    w = np.zeros(SMALL_CAP, np.int32)
    w[:n] = 1
    cand, counts = _window(np.random.default_rng(1), [2, 3], pack_pair(2, 3), n_aff=1)
    p = _compare_merge(sym, w, n, pack_pair(2, 3), 300, cand, counts)
    assert (p[0][: int(p[2])] & 0xFFFF == 300).sum() == 31


def test_noop_pair_zero():
    rng = np.random.default_rng(11)
    n = 512
    sym = np.zeros(SMALL_CAP, np.uint32)
    sym[:n] = rng.integers(0, 3, size=n)  # many 0s: (0,0) must not match
    sym[0] |= 1 << 16
    w = np.zeros(SMALL_CAP, np.int32)
    w[:n] = 1
    cand = np.full(tk.W_SLOTS, 0xFFFFFFFF, np.uint32)
    counts = np.full(tk.W_SLOTS, -1, np.int32)
    cand[:3], counts[:3] = [pack_pair(1, 2), pack_pair(2, 1), pack_pair(1, 1)], 5
    p = _compare_merge(sym, w, n, 0, 300, cand, counts)
    assert int(p[2]) == n
    np.testing.assert_array_equal(p[0].astype(np.uint32), sym)


def test_garbage_tail_never_matches():
    """Garbage past n (a recycled buffer) creates no site or removal and
    never leaks into any output: the port's result equals its result on
    the clean stream, whose stream equals the Pallas one."""
    rng = np.random.default_rng(3)
    n = 3000
    sym, w = _stream(rng, n, SMALL_CAP, TOKS_LOW)
    pair = pack_pair(2, 3)
    cand, counts = _window(rng, TOKS_LOW, pair, n_aff=5)
    clean = _compare_merge(sym, w, n, pair, 300, cand, counts)
    dirty_s, dirty_w = sym.copy(), w.copy()
    dirty_s[n:] = np.tile([2, 3], (SMALL_CAP - n) // 2)
    dirty_w[n:] = 999
    dirty = _port_merge(dirty_s, dirty_w, n, pair, 300, cand, counts)
    for c, d in zip(clean, dirty):
        np.testing.assert_array_equal(c, d)


# ─────────────────────────────── count_pairs2 ────────────────────────────────


def _compare_count(sym, w, n, p1, p2):
    j = np.asarray(pk.count_pairs2(
        jnp.asarray(sym), jnp.asarray(w), jnp.asarray(n), jnp.uint32(p1), jnp.uint32(p2),
        interpret=True,
    ))
    p = tk.count_pairs2(torch.from_numpy(sym.astype(np.int32)), torch.from_numpy(w), n, p1, p2)
    np.testing.assert_array_equal(p.numpy(), j.astype(np.int64))
    return p.numpy()


@pytest.mark.parametrize(
    "seed,n,toks",
    [(0, 16, TOKS_LOW), (1, 4000, TOKS_LOW), (2, 4000, TOKS_HIGH),
     (3, 16, TOKS_LOW), (4, 4001, TOKS_HIGH), (5, SMALL_CAP, TOKS_LOW)],
)
def test_count_pairs2_random(seed, n, toks):
    """Random streams; from seed 3 on, the pairs hold a token Z that occurs
    only at the first and the last live position (the first and the last
    16-byte vector's edges; n == cap in the last case)."""
    rng = np.random.default_rng(seed)
    sym, w = _stream(rng, n, SMALL_CAP, toks)
    p1, p2 = pack_pair(toks[0], toks[1]), pack_pair(toks[2], toks[3])
    if seed >= 3:
        z = 0x7777
        sym[0], sym[n - 1] = z | (1 << 16), z
        p1, p2 = pack_pair(z, int(sym[1]) & 0xFFFF), pack_pair(int(sym[n - 2]) & 0xFFFF, z)
        sym[1] &= 0xFFFF  # no word start after the first Z
    got = _compare_count(sym, w, n, p1, p2)
    assert n < 100 or got.min() > 0
    if seed >= 3:
        assert got.tolist() == [w[0], w[n - 2]]


def test_count_pairs2_token0_and_sentinel():
    rng = np.random.default_rng(3)
    n = 4000
    sym = np.zeros(SMALL_CAP, np.uint32)
    sym[:n] = rng.integers(0, 4, size=n)
    sym[0] |= 1 << 16
    w = np.zeros(SMALL_CAP, np.int32)
    w[:n] = 1
    assert _compare_count(sym, w, n, 1, pack_pair(0, 2)).tolist() == [0, 0]
    _compare_count(sym, w, n, 0, pack_pair(3, 0))


def test_count_pairs2_block_edge_and_last():
    n = BLOCK + 64
    sym = np.zeros(BIG_CAP, np.uint32)
    sym[:n] = 7
    sym[0] |= 1 << 16
    sym[BLOCK - 1], sym[BLOCK] = 2, 3
    sym[n - 1] = 2  # the last symbol has no successor
    w = np.zeros(BIG_CAP, np.int32)
    w[:n] = 5
    assert _compare_count(sym, w, n, pack_pair(2, 3), pack_pair(7, 2))[0] == 5


# ──────────────────────────────── window_post ────────────────────────────────


def _wp_inputs(rng, *, big_bins=False, has_room=True, active=True, use_probes=True, hi=False):
    base = 0x8000 if hi else 1
    toks = [base + 5 * i for i in range(30)]
    pair = pack_pair(toks[0], toks[1])
    cand, counts = _window(rng, toks, pair, n_aff=20, n_other=120)
    scale = 3e9 if big_bins else 7e5
    bins_l = (rng.random((16, 16)) * scale).astype(np.float32)
    bins_r = (rng.random((16, 16)) * scale).astype(np.float32)
    log = np.zeros(BATCH_MERGES * 3, np.uint32)
    log[:30] = rng.integers(0, 2**32 - 1, size=30, dtype=np.uint32)
    aff = [k for k in range(tk.W_SLOTS) if counts[k] >= 0 and cand[k] != pair
           and ((cand[k] & 0xFFFF) == toks[0] or (cand[k] >> 16) == toks[1])]
    probes = np.ones(tk.N_PROBES, np.uint32)
    probes[: len(aff)] = cand[aff]
    pcnt = np.zeros(tk.N_PROBES, np.int32)
    pcnt[: len(aff)] = rng.integers(0, 9000, size=len(aff))
    fill = int(rng.integers(128, 250))
    scalars = dict(
        pair=pair, count=4321, next_id=0x9ABC if hi else 300, theta=int(rng.integers(100, 6000)),
        ub_new=int(rng.integers(0, 3000)), fill=fill, merges_done=9, active=active,
        early_stop=False, use_probes=use_probes, n_aff=len(aff), c_l=int(bins_l.max() // 2),
        c_r=77, l_ok=True, r_ok=has_room, l_tok=toks[3], r_tok=toks[4] if has_room else 0x10000,
        has_room=has_room and active,
    )
    return cand, counts, bins_l, bins_r, log, probes, pcnt, scalars


_WP_FLAGS = ("active", "early_stop", "use_probes", "l_ok", "r_ok", "has_room")


def _scalar_form(sc: dict, form: str) -> dict:
    """The scalars as Python values ("ints"), as 0-d int64 and bool tensors
    ("tensors"), or as views into one int64 and one bool tensor, 0-d and
    one-element slices, as the train step passes ``cnt2[0]`` ("views")."""
    if form == "ints":
        return sc
    if form == "tensors":
        return {k: torch.tensor(bool(v) if k in _WP_FLAGS else int(v)) for k, v in sc.items()}
    ints = [k for k in sc if k not in _WP_FLAGS]
    big = torch.tensor([0] + [int(sc[k]) for k in ints], dtype=torch.int64)
    flags = torch.tensor([True] + [bool(sc[k]) for k in _WP_FLAGS])
    out = {k: big[1 + i] if i % 2 else big[1 + i : 2 + i] for i, k in enumerate(ints)}
    out.update({k: flags[1 + i] for i, k in enumerate(_WP_FLAGS)})
    return out


@pytest.mark.parametrize(
    "case",
    [dict(), dict(hi=True), dict(big_bins=True), dict(has_room=False), dict(active=False),
     dict(use_probes=False), dict(hi=True, big_bins=True), dict(form="tensors"),
     dict(form="views", hi=True), dict(form="views", has_room=False, big_bins=True),
     dict(form="tensors", active=False)],
)
def test_window_post_identical_inputs(case):
    case = dict(case)
    form = case.pop("form", "ints")
    rng = np.random.default_rng(len(str(case)))
    cand, counts, bins_l, bins_r, log, probes, pcnt, sc = _wp_inputs(rng, **case)
    jsc = {k: (jnp.uint32(v) if k in ("pair", "next_id", "l_tok", "r_tok") else jnp.asarray(v))
           for k, v in sc.items()}
    j = pk.window_post(
        jnp.asarray(cand), jnp.asarray(counts), jnp.asarray(bins_l), jnp.asarray(bins_r),
        jnp.asarray(log), probes=jnp.asarray(probes), pcnt=jnp.asarray(pcnt), interpret=True, **jsc,
    )
    j = [np.asarray(x) for x in j]
    p = tk.window_post(
        torch.from_numpy(cand.astype(np.int64)), torch.from_numpy(counts.astype(np.int64)),
        torch.from_numpy(bins_l), torch.from_numpy(bins_r), torch.from_numpy(log.astype(np.int64)),
        probes=torch.from_numpy(probes.astype(np.int64)), pcnt=torch.from_numpy(pcnt.astype(np.int64)),
        **_scalar_form(sc, form),
    )
    p = [x.numpy() for x in p]
    np.testing.assert_array_equal(p[0], j[0].astype(np.int64))
    np.testing.assert_array_equal(p[1], j[1].astype(np.int64))
    np.testing.assert_array_equal(p[2], j[2].astype(np.int64))
    want = j[3].astype(np.int64)
    want[6:] &= 0xFFFFFFFF  # next_id and pend_pair as unsigned values
    np.testing.assert_array_equal(p[3], want)


def test_window_post_unsigned_winner_order():
    """Two slots tie on the max count; the one whose first token is >=
    0x8000 must lose to the smaller unsigned pair id."""
    cand = np.full(tk.W_SLOTS, 0xFFFFFFFF, np.uint32)
    counts = np.full(tk.W_SLOTS, -1, np.int32)
    cand[:3] = [pack_pair(0x9000, 5), pack_pair(0x7000, 5), pack_pair(1, 2)]
    counts[:3] = [500, 500, 10]
    zeros = np.zeros((16, 16), np.float32)
    sc = dict(pair=pack_pair(1, 2), count=10, next_id=300, theta=0, ub_new=0, fill=128,
              merges_done=0, active=True, early_stop=False, use_probes=True, n_aff=0, c_l=0,
              c_r=0, l_ok=False, r_ok=False, l_tok=0x10000, r_tok=0x10000, has_room=True)
    p = tk.window_post(
        torch.from_numpy(cand.astype(np.int64)), torch.from_numpy(counts.astype(np.int64)),
        torch.from_numpy(zeros), torch.from_numpy(zeros), torch.zeros(BATCH_MERGES * 3, dtype=torch.int64),
        probes=torch.ones(tk.N_PROBES, dtype=torch.int64), pcnt=torch.zeros(tk.N_PROBES, dtype=torch.int64),
        **sc,
    )
    sout = p[3].tolist()
    assert sout[7] == pack_pair(0x7000, 5) and sout[4] == 500 and sout[5] == 1


def _wp_call(sc):
    rng = np.random.default_rng(5)
    cand, counts, bins_l, bins_r, log, probes, pcnt, _ = _wp_inputs(rng)
    return tk.window_post(
        torch.from_numpy(cand.astype(np.int64)), torch.from_numpy(counts.astype(np.int64)),
        torch.from_numpy(bins_l), torch.from_numpy(bins_r), torch.from_numpy(log.astype(np.int64)),
        probes=torch.from_numpy(probes.astype(np.int64)), pcnt=torch.from_numpy(pcnt.astype(np.int64)), **sc,
    )


@pytest.mark.parametrize(
    "name,bad",
    [("count", torch.tensor(5, dtype=torch.int32)), ("theta", torch.tensor(3.0)),
     ("c_l", torch.tensor([1, 2])), ("active", torch.ones(2, dtype=torch.bool)),
     ("fill", torch.tensor(130, device="meta"))],
)
def test_window_post_rejects_bad_scalars(name, bad):
    """A scalar must be one int64 or bool element on the window's device."""
    _, _, _, _, _, _, _, sc = _wp_inputs(np.random.default_rng(5))
    _wp_call(sc)  # the same call with good scalars runs
    with pytest.raises(ValueError, match=name):
        _wp_call({**sc, name: bad})
    with pytest.raises(TypeError):
        _wp_call({k: v for k, v in sc.items() if k != name})


@pytest.mark.parametrize("form", ["tensors", "views", "mixed"])
def test_scalar_refs_in_scalar_order(form):
    """The pointer struct window_post.cu reads lists each scalar's address and
    element size in ``_SCALAR_ORDER``; Python ints land in one held tensor."""
    _, _, _, _, _, _, _, sc = _wp_inputs(np.random.default_rng(9))
    given = _scalar_form(sc, "views" if form == "views" else "tensors")
    if form == "mixed":
        given.update({k: sc[k] for k in ("pair", "theta", "early_stop", "r_tok")})
    refs, held = tk.scalar_refs(torch.device("cpu"), given)
    assert len(tk._SCALAR_ORDER) == tk.N_SCALARS
    fields = struct.unpack(f"<{tk.N_SCALARS}Q{tk.N_SCALARS}i", refs)
    ptrs, sizes = fields[: tk.N_SCALARS], fields[tk.N_SCALARS :]
    for i, k in enumerate(tk._SCALAR_ORDER):
        x = given[k]
        if isinstance(x, torch.Tensor):
            assert (ptrs[i], sizes[i]) == (x.data_ptr(), 1 if x.dtype == torch.bool else 8)
        else:
            assert sizes[i] == 8
            slot = (ptrs[i] - held.data_ptr()) // 8
            assert int(held[slot]) == int(sc[k])
    assert (held is None) == (form != "mixed")


def test_wrappers_reject_unsupported_devices():
    t = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        tk.count_pairs2(t, t.to("meta"), 4, 1, 2)


# ───────────────────────── the wrappers' host helpers ────────────────────────


@pytest.mark.parametrize("count", [1, 3])
def test_merge_outputs_arena_layout(count):
    """The merge's small outputs are views of one int64 arena per call at the
    ARENA_* offsets that merge_compact_tracked.cu writes (the bins as
    2 x 256 f32), ``count`` arenas to one allocation, each at the address
    handed to the kernel, with the plain version's shapes and dtypes."""
    arenas = tk.merge_arenas(count, torch.device("cpu"))
    plain = tk.merge_compact_tracked_plain(
        torch.zeros(64, dtype=torch.int32), torch.zeros(64, dtype=torch.int32), 0, 0, 300,
        torch.full((tk.W_SLOTS,), tk.INVALID), torch.full((tk.W_SLOTS,), -1),
    )
    want = [(p.shape, p.dtype) for p in plain[2:]]
    assert len(arenas) == count
    for i, (addr, outs) in enumerate(arenas):
        assert addr == arenas[0][0] + 8 * tk.ARENA_WORDS * i
        assert [(o.shape, o.dtype) for o in outs] == want
        assert all(o.is_contiguous() for o in outs)
        n_new, bins_l, bins_r, samp, pcnt, probes, n_aff = outs
        word = {tk.ARENA_NNEW: n_new, tk.ARENA_SAMP: samp, tk.ARENA_PCNT: pcnt, tk.ARENA_PROBES: probes,
                tk.ARENA_NAFF: n_aff}
        for off, view in word.items():
            assert view.data_ptr() == addr + 8 * off
        assert bins_l.data_ptr() == addr + 8 * tk.ARENA_BINS
        assert bins_r.data_ptr() == addr + 8 * tk.ARENA_BINS + 4 * 256
    assert tk.ARENA_PROBES + tk.N_PROBES + tk.GATE_WORDS + tk.SOUT_WORDS + 2 == tk.ARENA_WORDS
    assert tk.ARENA_WORDS == 256 + 4 + 2 * tk.N_PROBES + 10 + 8 + 2


@pytest.mark.parametrize("count", [1, 3])
def test_gated_arena_views(count):
    """A gated arena's ``Gated`` words sit at ARENA_GATE in enum Gate's order
    (merge_compact_tracked.cu), ``sout`` at ARENA_SOUT, and ``host`` is the
    ten words from ARENA_SOUT: sout, then the n_new and n_aff views the merge
    returns, so the loop's read is one contiguous copy."""
    arenas = tk.merge_arenas(count, torch.device("cpu"), gated=True)
    for addr, (n_new, *_, n_aff, g) in arenas:
        assert [w.data_ptr() for w in g[: tk.GATE_WORDS]] == [addr + 8 * (tk.ARENA_GATE + i)
                                                              for i in range(tk.GATE_WORDS)]
        assert all(w.shape == () and w.dtype == torch.int64 for w in g[: tk.GATE_WORDS])
        assert g.sout.shape == (8,) and g.sout.data_ptr() == addr + 8 * tk.ARENA_SOUT and g.sout.is_contiguous()
        assert g.host.shape == (10,) and g.host.data_ptr() == g.sout.data_ptr()
        assert [w.data_ptr() for w in g.sout_words] == [g.sout.data_ptr() + 8 * i for i in range(8)]
        assert all(w.shape == () for w in g.sout_words)
        assert n_new.data_ptr() == g.host[8].data_ptr() and n_aff.data_ptr() == g.host[9].data_ptr()
        assert addr + 8 * tk.ARENA_WORDS == g.host[9].data_ptr() + 8


def test_pooled_items_go_out_once():
    """Each pooled item is handed out once; an empty pool is refilled."""
    made = []

    def make():
        made.append(len(made))
        return [(len(made), i) for i in range(3)]

    key = ("test", 0, 0)
    try:
        got = [tk._pooled(key, make) for _ in range(7)]
        assert len(set(got)) == 7 and len(made) == 3
    finally:
        tk._POOLS.pop(key, None)


def test_cached_scratch_keys_and_failed_launch():
    """Scratch is made zeroed once per (kernel, device, size, stream) key and
    reused; a failed launch drops its key before raising, so the next call
    starts from fresh zeroed scratch."""
    cpu = torch.device("cpu")
    made = []

    def words():
        made.append(1)
        return 40

    keys = [("k", 0, 4096, 11), ("k", 0, 2048, 11), ("k", 0, 4096, 12), ("k", 1, 4096, 11)]
    try:
        bufs = [build.cached_scratch(key, cpu, words) for key in keys]
        assert len(made) == 4 and len({b.data_ptr() for b in bufs}) == 4
        assert all(b.shape == (40,) and int(b.abs().sum()) == 0 for b in bufs)
        assert build.cached_scratch(keys[0], cpu, words) is bufs[0] and len(made) == 4
        build.check_scratch(0, "k", keys[0])
        assert build.cached_scratch(keys[0], cpu, words) is bufs[0]
        bufs[0][3] = 7  # as a launch that failed half way might leave it
        with pytest.raises(RuntimeError, match="cudaError 700"):
            build.check_scratch(700, "k", keys[0])
        fresh = build.cached_scratch(keys[0], cpu, words)
        assert fresh is not bufs[0] and int(fresh.abs().sum()) == 0 and len(made) == 5
    finally:
        for key in keys:
            build._SCRATCH.pop(key, None)


@pytest.mark.parametrize("given", ["int", "0d_int64", "1elem_int64", "0d_int32"])
def test_dev_scalar_forms(given):
    """A 0-d int64 tensor on the device is passed as it is; other forms are
    converted to one."""
    cpu = torch.device("cpu")
    x = {"int": 7, "0d_int64": torch.tensor(7), "1elem_int64": torch.tensor([7]),
         "0d_int32": torch.tensor(7, dtype=torch.int32)}[given]
    got = tk._dev_scalar(x, cpu)
    assert got.dtype == torch.int64 and got.shape == () and int(got) == 7
    assert (got is x) == (given == "0d_int64")


_PROBE_LESS_JAX: dict = {}


@pytest.mark.parametrize("window", ["none", "dead"])
@pytest.mark.parametrize(
    "seed,n,cap,toks", [(40, 3000, SMALL_CAP, TOKS_LOW), (41, 4000, SMALL_CAP, TOKS_HIGH),
                        (42, BIG_CAP - 100, BIG_CAP, list(range(1, 30))), (43, 0, SMALL_CAP, TOKS_LOW)],
)
def test_probe_less_mode_is_the_dead_window_call(seed, n, cap, toks, window):
    """The Pallas ``merge_compact_tracked(..., probes=None, window=None)``
    (the distributed trainer's and the selftest's mode) against the port's
    probe-less call (no window: the 6-tuple) and its window-mode call with
    every window slot dead (nothing probed): bitwise on symbols, weights, n
    and both f32 bins (integer masses below 2^24), and on ``samp`` while the
    stream fits one Pallas block. Across blocks (the 1.5-block stream) the
    ``samp`` token on a weight tie is the one documented difference: the
    port takes the smallest token of the whole stream, the Pallas kernel
    that of the earliest block reaching the weight, so there the weights
    must be equal and the Pallas token must lie among the tied ones."""
    rng = np.random.default_rng(seed)
    sym, w = _stream(rng, n, cap, toks)
    pair = pack_pair(toks[1], toks[2])
    new_id = 0x9000 if toks is TOKS_HIGH else 300
    if seed not in _PROBE_LESS_JAX:
        _PROBE_LESS_JAX[seed] = pk.merge_compact_tracked(
            jnp.asarray(sym), jnp.asarray(w), jnp.asarray(n), jnp.uint32(pair), jnp.uint32(new_id), interpret=True)
    j = _PROBE_LESS_JAX[seed]
    assert len(j) == 6
    if window == "dead":
        dead = np.full(tk.W_SLOTS, 0xFFFFFFFF, np.uint32), np.full(tk.W_SLOTS, -1, np.int32)
        p = _port_merge(sym, w, n, pair, new_id, *dead)
        assert len(p) == 9 and int(p[8]) == 0 and not p[6].any()
    else:
        p = [o.numpy() for o in tk.merge_compact_tracked(torch.from_numpy(sym.astype(np.int32)),
                                                         torch.from_numpy(w), n, pair, new_id)]
        assert len(p) == 6
    np.testing.assert_array_equal(p[0].astype(np.uint32), np.asarray(j[0]))
    np.testing.assert_array_equal(p[1], np.asarray(j[1]))
    n2 = int(p[2])
    assert n2 == int(np.asarray(j[2]).reshape(-1)[0])
    np.testing.assert_array_equal(p[3], np.asarray(j[3]))
    np.testing.assert_array_equal(p[4], np.asarray(j[4]))
    samp_p, samp_j = p[5], np.asarray(j[5]).astype(np.int64)
    if cap <= BLOCK:
        np.testing.assert_array_equal(samp_p, samp_j)
    else:
        _, _, left, right = _ref_tracking(p[0].astype(np.uint32), p[1], n2, new_id)
        for side, (mask, wts, tks) in ((0, left), (2, right)):
            assert samp_p[side] == samp_j[side] > 0
            tied = set(tks[mask & (wts == samp_p[side])].tolist())
            assert samp_p[side + 1] == min(tied) and int(samp_j[side + 1]) in tied


def test_merge_window_is_both_or_neither():
    sym = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="both cand and counts"):
        tk.merge_compact_tracked(sym, sym, 0, 1, 300, cand=torch.zeros(tk.W_SLOTS, dtype=torch.int64))
