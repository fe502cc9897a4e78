"""The port's bitonic compare-exchange rounds (``ops/bitonic.py``, plain
version and the wrapper on CPU tensors) against the Pallas kernel of
``scripts/microbench_bitonic.py`` in interpret mode.

The script builds its kernel inside ``main()`` and times it under
``jax.jit``; the test runs ``main()`` with ``--interpret`` and keeps the
callable that ``pl.pallas_call`` returns there, then calls it on its own
inputs under ``jax.jit``, which reuses the executable ``main()`` compiled
(an eager call compiles it again, as long as ``main()`` took). Tolerance
0: every output is a u32 word.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

# One intra-op thread: the suite runs several test processes side by side.
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from gpu_bpe_tpu_torch.ops import bitonic as tb  # noqa: E402
from gpu_bpe_tpu_torch.ops import kernels as tk  # noqa: E402

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "microbench_bitonic.py"
ROWS, LANES = tb.ROWS, tb.LANES
_KEPT: dict[tuple[int, int], object] = {}


def _pallas_kernel(blocks: int, rounds: int):
    """The script's ``pl.pallas_call`` callable for ``--blocks blocks
    --rounds rounds --interpret``, made once per shape by running its
    ``main()`` (no compile cache is written)."""
    key = (blocks, rounds)
    if key not in _KEPT:
        spec = importlib.util.spec_from_file_location("microbench_bitonic", SCRIPT)
        script = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(script)
        kept = []
        original = pl.pallas_call

        def keep(*args, **kwargs):
            fn = original(*args, **kwargs)
            kept.append(fn)
            return fn

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pl, "pallas_call", keep)
            mp.setattr(sys, "argv", [str(SCRIPT), "--interpret", "--blocks", str(blocks),
                                     "--rounds", str(rounds)])
            mp.setenv("GPU_BPE_TPU_CACHE_DIR", "")
            script.main()
        (_KEPT[key],) = kept
    return _KEPT[key]


def _script_inputs(blocks: int) -> list[np.ndarray]:
    """The script's own inputs: ``default_rng(0)``, words below 2^31."""
    rng = np.random.default_rng(0)
    shape = (blocks * ROWS, LANES)
    return [rng.integers(0, 1 << 31, size=shape, dtype=np.int64).astype(np.int32) for _ in range(3)]


def _hard_inputs(blocks: int, seed: int = 7) -> list[np.ndarray]:
    """Words with bit 31 set (word 0 always), ties in word 0 and in words
    0-1 (each from a handful of values around 2^31), equal triples, and
    every eighth row a copy of the row before it."""
    rng = np.random.default_rng(seed)
    shape = (blocks * ROWS, LANES)
    w0 = rng.choice(np.array([0x80000000, 0x80000001, 0xFFFFFFFF, 0xC0000000], np.uint32), size=shape)
    w1 = rng.choice(np.array([0x7FFFFFFF, 0x80000000, 0, 0xFFFFFFFE], np.uint32), size=shape)
    w2 = rng.integers(0, 1 << 32, size=shape, dtype=np.int64).astype(np.uint32)
    w2 = np.where(rng.random(shape) < 0.5, w2 & np.uint32(0x80000003), w2)
    words = [w0, w1, w2]
    for w in words:
        w[8::8] = w[7::8][: w[8::8].shape[0]]
    return [w.view(np.int32) for w in words]


def _run_pallas(blocks: int, rounds: int, words: list[np.ndarray]) -> list[np.ndarray]:
    out = jax.jit(_pallas_kernel(blocks, rounds))(*(jnp.asarray(w) for w in words))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("inputs", ["script", "hard"])
@pytest.mark.parametrize("blocks", [1, 2])
@pytest.mark.parametrize("rounds", [1, 17, 71])
def test_plain_and_wrapper_equal_the_pallas_kernel(rounds, blocks, inputs):
    words = _script_inputs(blocks) if inputs == "script" else _hard_inputs(blocks)
    if inputs == "hard":
        assert all((w.view(np.uint32) >= 1 << 31).any() for w in words)
        assert (words[0].view(np.uint32) >= 1 << 31).all()
    want = _run_pallas(blocks, rounds, words)
    t = [torch.from_numpy(w) for w in words]
    plain = tb.bitonic_rounds_plain(*t, rounds)
    before = tk.LAUNCHES["bitonic_rounds"]
    wrapped = tb.bitonic_rounds(*t, rounds)
    assert tk.LAUNCHES["bitonic_rounds"] == before  # the CPU takes the plain version
    for w, p, q in zip(want, plain, wrapped, strict=True):
        assert p.dtype == q.dtype == torch.int32 and tuple(p.shape) == w.shape
        np.testing.assert_array_equal(p.numpy(), w)
        np.testing.assert_array_equal(q.numpy(), w)
    assert any(not np.array_equal(w, x) for w, x in zip(want, words))


def _row_multisets(words) -> np.ndarray:
    """Each row's triples, [rows, 128, 3], in lexicographic order within
    the row."""
    u = np.stack([w.numpy().view(np.uint32).astype(np.uint64) for w in words], axis=-1)
    key = (u[..., 0] << np.uint64(32)) | u[..., 1]
    order = np.lexsort((u[..., 2], key), axis=-1)
    return np.take_along_axis(u, order[..., None], axis=1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_zero_rounds_is_the_identity_and_rows_keep_their_triples(seed):
    rng = np.random.default_rng(100 + seed)
    blocks = 1 + seed % 2
    words = _hard_inputs(blocks, seed) if seed % 2 else _script_inputs(blocks)
    t = [torch.from_numpy(w) for w in words]
    same = tb.bitonic_rounds(*t, 0)
    for x, y in zip(t, same, strict=True):
        assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()
    rounds = int(rng.integers(1, 90))
    out = tb.bitonic_rounds(*t, rounds)
    np.testing.assert_array_equal(_row_multisets(out), _row_multisets(t))


def _keys(words) -> np.ndarray:
    """Each element's rank among all the triples in lexicographic order,
    [rows, 128]."""
    u = np.stack([w.numpy().view(np.uint32).astype(np.uint64).ravel() for w in words], axis=-1)
    _, rank = np.unique(u, axis=0, return_inverse=True)
    return rank.reshape(words[0].shape)


@pytest.mark.parametrize("rounds", list(range(1, 15)) + [21, 70])
def test_the_last_round_orders_each_pair_by_its_rows_direction(rounds):
    """After R rounds every pair (e, e + j) of the last round's stride j
    (e's bit j clear) is in the last round's order: key[e] <= key[e + j]
    in rows whose block-local index has bit (R - 1) % 10 clear, >= in the
    others (ties included)."""
    t = [torch.from_numpy(w) for w in _hard_inputs(1, seed=rounds)]
    key = _keys(tb.bitonic_rounds_plain(*t, rounds))
    j, k = tb._round(rounds - 1)
    lane = np.arange(LANES)
    low = lane[(lane & j) == 0]
    first, second = key[:, low], key[:, low + j]
    asc = ((np.arange(key.shape[0]) % ROWS * LANES) & k) == 0
    assert asc.any() and (~asc).any()
    assert (first[asc] <= second[asc]).all()
    assert (first[~asc] >= second[~asc]).all()


@pytest.mark.parametrize("bad", ["dtype", "rows", "lanes", "empty", "mismatch", "rounds", "view"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    shape = (ROWS, LANES)
    a = torch.zeros(shape, dtype=torch.int32)
    b, c, rounds = a.clone(), a.clone(), 3
    if bad == "dtype":
        a = a.to(torch.int64)
    elif bad == "rows":
        a = b = c = torch.zeros(ROWS + 8, LANES, dtype=torch.int32)
    elif bad == "lanes":
        a = b = c = torch.zeros(ROWS * 2, LANES // 2, dtype=torch.int32)
    elif bad == "empty":
        a = b = c = torch.zeros(0, LANES, dtype=torch.int32)
    elif bad == "mismatch":
        c = torch.zeros(2 * ROWS, LANES, dtype=torch.int32)
    elif bad == "rounds":
        rounds = -1
    elif bad == "view":
        a = torch.zeros(LANES, ROWS, dtype=torch.int32).t()
    with pytest.raises(ValueError):
        tb.bitonic_rounds(a, b, c, rounds)
    with pytest.raises(ValueError):
        tb.bitonic_rounds_plain(a, b, c, rounds)


def _rule_inputs(kind: str) -> list[np.ndarray]:
    """One block of words: the script's; every word in [0, 2) or [0, 4)
    (nearly every pair ties, often in all three words); every word with
    bit 31 set; or random words whose odd rows repeat the row before."""
    if kind == "script":
        return _script_inputs(1)
    rng = np.random.default_rng(len(kind))
    shape = (ROWS, LANES)
    if kind in ("ties2", "ties4"):
        high = int(kind[-1])
        return [rng.integers(0, high, size=shape, dtype=np.int64).astype(np.uint32).view(np.int32)
                for _ in range(3)]
    words = [rng.integers(0, 1 << 32, size=shape, dtype=np.int64).astype(np.uint32) for _ in range(3)]
    if kind == "bit31":
        words = [w | np.uint32(0x80000000) for w in words]
    else:
        for w in words:
            w[1::2] = w[0::2]
    return [w.view(np.int32) for w in words]


def _round_without_equality(words: list[torch.Tensor], r: int) -> list[torch.Tensor]:
    """Round ``r`` of ``bitonic_rounds_plain``'s body, with the take rule of
    ``bitonic_rounds.cu``: ``take = (x1 == lt)``, no equality test (where
    the keys are equal, the partner's words are the element's own)."""
    lane = torch.arange(LANES)
    row_fi = (torch.arange(words[0].shape[0]) % ROWS * LANES).view(-1, 1)
    j, k = tb._round(r)
    lo = (lane & j) == 0
    part = [torch.where(lo, torch.roll(x, LANES - j, 1), torch.roll(x, j, 1)) for x in words]
    u = [x.to(torch.int64) & 0xFFFFFFFF for x in words]
    pu = [x.to(torch.int64) & 0xFFFFFFFF for x in part]
    lt = (u[0] < pu[0]) | ((u[0] == pu[0]) & ((u[1] < pu[1]) | ((u[1] == pu[1]) & (u[2] < pu[2]))))
    x1 = ((row_fi & k) == 0) ^ lo
    take = x1 == lt
    return [torch.where(take, p, x) for p, x in zip(part, words)]


@pytest.mark.parametrize("kind", ["script", "ties2", "ties4", "bit31", "dup_rows"])
def test_dropping_the_equality_test_changes_no_output(kind):
    """The design rule of ``bitonic_rounds.cu``: an element takes its
    partner's words where ``x1 == lt``, with no equality term, and the
    outputs equal ``bitonic_rounds_plain`` bit for bit after every round
    count checked."""
    t = [torch.from_numpy(w) for w in _rule_inputs(kind)]
    if kind.startswith("ties"):
        assert (t[0] == torch.roll(t[0], 1, 1)).float().mean() > 0.2
    checked = set(range(1, 15)) | {32, 70, 71}
    words = t
    for r in range(max(checked)):
        words = _round_without_equality(words, r)
        if r + 1 in checked:
            for got, want in zip(words, tb.bitonic_rounds_plain(*t, r + 1), strict=True):
                assert torch.equal(got, want), (kind, r + 1)


def _kernel_schedule(words: list[np.ndarray], rounds: int, per_lane: int) -> list[np.ndarray]:
    """``bitonic_rounds.cu``'s schedule in numpy: element e of a row in
    lane e % (128 / per_lane) of the row's group, register e // (128 /
    per_lane); a stride of at least 128 / per_lane pairs two registers of
    one lane and swaps them where ``less(high, low) ^ desc``; a smaller one
    pairs two lanes, each taking its partner's words where ``less(partner,
    self) ^ desc ^ high``; desc is bit r % 10 of the row."""
    group = LANES // per_lane
    u = np.stack([w.view(np.uint32).astype(np.uint64) for w in words])
    rows = u.shape[1]
    v = u.reshape(3, rows, per_lane, group).transpose(0, 1, 3, 2).copy()  # [word, row, lane, register]

    def less(a, b):
        return (a[0] < b[0]) | ((a[0] == b[0]) & ((a[1] < b[1]) | ((a[1] == b[1]) & (a[2] < b[2]))))

    lane = np.arange(group)
    for r in range(rounds):
        j = 1 << (r % 7)
        desc = (((np.arange(rows) % ROWS) >> (r % 10)) & 1).astype(bool)[:, None]
        if j >= group:
            d = j // group
            for q in range(per_lane):
                if q & d:
                    continue
                low, high = v[..., q].copy(), v[..., q | d].copy()
                swap = less(high, low) ^ desc
                v[..., q] = np.where(swap, high, low)
                v[..., q | d] = np.where(swap, low, high)
        else:
            part = v[:, :, lane ^ j, :]
            take = less(part, v) ^ (desc ^ ((lane & j) != 0)[None, :])[:, :, None]
            v = np.where(take, part, v)
    out = v.transpose(0, 1, 3, 2).reshape(3, rows, LANES)
    return [o.astype(np.uint32).view(np.int32) for o in out]


@pytest.mark.parametrize("per_lane", [8, 16, 32])
@pytest.mark.parametrize("kind", ["ties4", "bit31"])
def test_the_kernels_register_and_lane_schedule_equals_the_plain_version(kind, per_lane):
    """The kernel's layout and its two exchange rules (one compare per
    register pair, a flipped compare per shuffled element), modelled in
    numpy at 16 elements per lane as built and at 8 and 32, equal the plain
    version bitwise; on the card phase 25 of chip_smoke.py holds the kernel
    itself to it."""
    words = _rule_inputs(kind)
    t = [torch.from_numpy(w) for w in words]
    for rounds in (7, 13, 71):
        got = _kernel_schedule(words, rounds, per_lane)
        for g, w in zip(got, tb.bitonic_rounds_plain(*t, rounds), strict=True):
            np.testing.assert_array_equal(g, w.numpy())
