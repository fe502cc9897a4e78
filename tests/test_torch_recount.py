"""The port's two-level segmented recount (``_full_recount_segmented``) on
the CPU against the JAX package's (Pallas ``compact_mask`` in interpret
mode) and the port's monolithic recount, with the capacity gate lowered to
2^12 and segments of 2^10 rows.

Tolerance 0: winner, count and theta are exact integers and must be equal
(candidate picks may differ: the JAX package takes ``approx_max_k``, the
port an exact ``topk``), and the merge lists of whole runs must be
bitwise equal.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from gpu_bpe_tpu.ops import train_step as jts  # noqa: E402
from gpu_bpe_tpu_torch import Trainer  # noqa: E402
from gpu_bpe_tpu_torch.ops import train_step as ts  # noqa: E402

CAP = 1 << 12
SEG = 1 << 10


@pytest.fixture
def low_gate(monkeypatch):
    """The gate lowered on both sides and the JAX package's Pallas kernels
    in interpret mode. The JAX package caches the interpret flag at its
    first read, so the cache is cleared here and again afterwards (when
    the flag's old value comes back)."""
    monkeypatch.setattr(ts, "_SEG_RECOUNT_MIN_CAP", CAP)
    monkeypatch.setattr(ts, "_SEG_RECOUNT_M", SEG)
    monkeypatch.setattr(jts, "_SEG_RECOUNT_M", SEG)
    monkeypatch.setenv("GPU_BPE_TPU_PALLAS_INTERPRET", "1")
    jts._pallas_interpret.cache_clear()
    ts.RECOUNTS.clear()
    yield
    jts._pallas_interpret.cache_clear()


def _pairs(rng, distinct: int, high: bool, w_hi: int):
    """A cap-2^12 pair stream as ``_pair_ids`` gives it: ``distinct`` pair
    ids (both tokens >= 0x8000 when ``high``, so ids pass 2^31), one in
    ten invalid (pair 0, weight 0)."""
    lo = 0x8000 if high else 1
    toks = rng.integers(lo, lo + 0x7000, size=(distinct, 2), dtype=np.uint64)
    ids = (toks[:, 0] << np.uint64(16)) | toks[:, 1]
    pair = ids[rng.integers(0, distinct, size=CAP)].astype(np.uint32)
    w = rng.integers(1, w_hi, size=CAP).astype(np.int32)
    dead = rng.random(CAP) < 0.1
    pair[dead], w[dead] = 0, 0
    return pair, w


def _check(pair, w, tier):
    jb = jts._full_recount_segmented(jnp.asarray(pair), jnp.asarray(w), CAP)
    tp, tw = torch.from_numpy(pair.astype(np.int64)), torch.from_numpy(w.astype(np.int64))
    got_tier, seg = ts._full_recount_segmented(tp, tw, CAP)
    mono = ts._recount_monolithic(tp, tw)
    for got in (seg, mono):
        assert int(got[0]) == int(jb[0]) and int(got[1]) == int(jb[1]) and int(got[4]) == int(jb[4])
    assert ts.RECOUNTS == {tier: 1} and got_tier == tier
    return seg


@pytest.mark.parametrize(
    "distinct,tier", [(100, "seg_cap/8"), (400, "seg_cap/2"), (100_000, "seg_fallback")],
)
@pytest.mark.parametrize("high", [False, True])
def test_tiers_match_jax_and_monolithic(low_gate, distinct, tier, high):
    """The cap/8 tier (<= 512 run summaries), the cap/2 tier (<= 2048) and
    the monolithic fallback, with pair ids below and above 2^31."""
    pair, w = _pairs(np.random.default_rng(distinct + high), distinct, high, 1000)
    seg = _check(pair, w, tier)
    if high:
        assert int(seg[0]) >= 1 << 31


def test_stream_mass_past_int32(low_gate):
    """Stream mass far past 2^31 with every pair's total below it: the
    counts stay exact through both levels."""
    pair, w = _pairs(np.random.default_rng(3), 40, True, 2)
    w[w > 0] = (1 << 21) + np.arange(int((w > 0).sum())) % 977
    assert int(w.astype(np.int64).sum()) > 1 << 32
    seg = _check(pair, w, "seg_cap/8")
    assert int(seg[1]) > 1 << 25


def test_run_totals_reset_rows():
    """Each row's run totals equal the monolithic ``_run_totals`` of that
    row and JAX ``_run_totals_reset``, with stream mass past 2^32 and one
    run past 2^31 (wrapped to i32 by all three)."""
    rng = np.random.default_rng(8)
    sp = np.sort(rng.integers(0, 40, size=(4, 512)), axis=1).astype(np.int64)
    sp[2, :300] = 7  # one run of 300 x 2^23 > 2^31
    sw = rng.integers(1, 1 << 23, size=(4, 512)).astype(np.int64)
    sw[2, :300] = 1 << 23
    sw[sp == 0] = 0
    got = ts._run_totals_reset(torch.from_numpy(sp), torch.from_numpy(sw))
    for r in range(4):
        want = ts._run_totals(torch.from_numpy(sp[r]), torch.from_numpy(sw[r]))
        np.testing.assert_array_equal(got[r].numpy(), want.numpy())
    jax_rt = jts._run_totals_reset(jnp.asarray(sp.astype(np.uint32)), jnp.asarray(sw.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_rt).astype(np.int64))
    assert int(got[2, 299]) == (300 << 23) - (1 << 32)


def _corpus():
    """Many distinct words, so the dedup stream's capacity clears 2^12."""
    rng = np.random.default_rng(11)
    syll = [a + b for a in "btkdsmnlr" for b in "aeiou"]
    words = ["".join(syll[i] for i in rng.integers(0, len(syll), size=k))
             for k in rng.integers(2, 5, size=1500)]
    data = " ".join(words[i] for i in rng.integers(0, len(words), size=4000)).encode()
    starts = np.zeros(len(data), np.uint8)
    starts[0] = 1
    starts[1:] = np.frombuffer(data, np.uint8)[:-1] == 32
    return data, starts


def test_merge_list_with_segmented_recounts(monkeypatch):
    """With the gate lowered every recount at capacity >= 2^12 runs
    segmented; the merge list equals the monolithic run's and the
    ``force_recount=True`` run's."""
    data, starts = _corpus()
    mono = Trainer(device="cpu").train(data, starts, target_vocab_size=256 + 80)
    monkeypatch.setattr(ts, "_SEG_RECOUNT_MIN_CAP", CAP)
    monkeypatch.setattr(ts, "_SEG_RECOUNT_M", SEG)
    ts.RECOUNTS.clear()
    seg = Trainer(device="cpu").train(data, starts, target_vocab_size=256 + 80)
    assert sum(v for k, v in ts.RECOUNTS.items() if k.startswith("seg")) >= 1
    truth = Trainer(device="cpu", force_recount=True).train(data, starts, target_vocab_size=256 + 80)
    assert ts.RECOUNTS["seg_cap/8"] + ts.RECOUNTS["seg_cap/2"] > 10
    for r in (seg, truth):
        assert r.merges == mono.merges and r.merge_counts == mono.merge_counts
    assert len(mono.merges) == 80
