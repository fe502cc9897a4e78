"""The port's trainer on the CPU (``device="cpu"``, plain kernel versions)
against the JAX package's TPUTrainer (JAX CPU) and the CPU oracle
ReferenceTrainer: merge lists and counts bitwise equal."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from gpu_bpe_tpu.core import ReferenceTrainer, bytes_to_symbols, tag_word_boundaries  # noqa: E402
from gpu_bpe_tpu.core import Vocab as JaxVocab  # noqa: E402
from gpu_bpe_tpu.ops import TPUTrainer  # noqa: E402
from gpu_bpe_tpu.pretok import PreTokenizer  # noqa: E402
from gpu_bpe_tpu_torch import Trainer, Vocab  # noqa: E402
from gpu_bpe_tpu_torch.ops import train_step as ts  # noqa: E402
from gpu_bpe_tpu_torch.ops.ingest import make_stream, pad_stream  # noqa: E402


def _pretok(text: str):
    return PreTokenizer().pre_tokenize(text)


def _oracle(data: bytes, starts, vocab_size: int, vocab=None):
    sym = bytes_to_symbols(data)
    if starts is not None:
        sym = tag_word_boundaries(sym, starts)
    else:
        sym[0] |= 1 << 16
    return ReferenceTrainer(vocab).train(sym, target_vocab_size=vocab_size)


def _port(data, starts, vocab_size, **kw):
    dedup = kw.pop("dedup", True)
    return Trainer(device="cpu", **kw).train(data, starts, target_vocab_size=vocab_size, dedup=dedup)


def _same(a, b):
    assert a.merges == b.merges
    assert a.merge_counts == b.merge_counts


@pytest.mark.parametrize("dedup", [False, True])
def test_english_matches_jax_and_oracle(english_text, dedup):
    data, starts = _pretok(english_text[:8000])
    oracle = _oracle(data, starts, 330)
    jax_r = TPUTrainer().train(data, starts, target_vocab_size=330, dedup=dedup)
    port = _port(data, starts, 330, dedup=dedup)
    _same(port, oracle)
    _same(port, jax_r)
    assert port.vocab == oracle.vocab and port.vocab_strings == oracle.vocab_strings


@pytest.mark.parametrize(
    "data,dedup",
    [
        (b"abracadabra " * 50, True),  # no word boundaries
        (b"aaaa bbbb aaaa cccc aaaa", False),  # overlap runs
        (b"xy" + b"a" * 64 + b"xy" + b"a" * 64 + b"zz" + b"a" * 32, False),
        (b"ab" * 100 + b"\x00" + b"cd" * 50, False),  # alternating overlap
        (b"\x00\x00ab\x00ab\x00\x00", True),  # NUL bytes never pair
    ],
)
def test_no_word_boundaries_fixtures(data, dedup):
    oracle = _oracle(data, None, 300)
    port = _port(data, None, 300, dedup=dedup)
    _same(port, oracle)
    _same(port, TPUTrainer().train(data, None, target_vocab_size=300, dedup=dedup))


def test_tie_break():
    data = b"ab\x00cd\x00ab\x00cd"
    port = _port(data, None, 258)
    _same(port, _oracle(data, None, 258))
    assert port.merges[0][:2] == (ord("a"), ord("b"))


def test_multibatch_with_shrink(english_text):
    # small batches force many summary reads, collapse stops and shrinks
    data, starts = _pretok(english_text[:12000])
    oracle = _oracle(data, starts, 256 + 200)
    events = []
    port = Trainer(device="cpu", batch_merges=32).train(
        data, starts, target_vocab_size=256 + 200, on_progress=events.append,
    )
    _same(port, oracle)
    _same(port, TPUTrainer(batch_merges=32).train(data, starts, target_vocab_size=256 + 200))
    assert len(events) >= 200 // 32


def test_early_stop():
    port = _port(b"abcdefgh", None, 300)
    assert port.merges == [] and port.vocab_size == 256


def test_empty_raises():
    with pytest.raises(ValueError):
        _port(b"", None, 300)


def test_progress_schema(english_text):
    data, starts = _pretok(english_text[:5000])
    events = []
    Trainer(device="cpu").train(data, starts, target_vocab_size=300, on_progress=events.append)
    assert events
    assert {"mergeIndex", "totalMerges", "mergeString", "bestCount", "symbolCount",
            "mergesPerSecond"} <= set(events[0])


def test_force_recount_equals_certified(english_text):
    data, starts = _pretok(english_text[:10000])
    cert = _port(data, starts, 400)
    truth = _port(data, starts, 400, force_recount=True)
    _same(cert, truth)
    assert truth.recounts == len(truth.merges) + (1 if len(truth.merges) < 144 else 0)
    assert cert.recounts < truth.recounts


def test_permuted_word_order(english_text):
    # the same multiset of pre-tokenized words in another order
    d1, s1 = _pretok(english_text[:12000])
    cuts = np.append(np.flatnonzero(s1), len(d1))
    words = [d1[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    perm = [words[i] for i in np.random.default_rng(9).permutation(len(words))]
    d2 = b"".join(perm)
    s2 = np.zeros(len(d2), np.uint8)
    s2[np.cumsum([0] + [len(w) for w in perm[:-1]])] = 1
    first = _port(d1, s1, 400, dedup=False)
    _same(first, _port(d2, s2, 400, dedup=False))
    _same(first, _port(d2, s2, 400, dedup=True))


def test_capacity_collapse_and_shrink():
    """A dedup stream of ~5K symbols starts at capacity 8192; merges push it
    below half capacity, so a batch stops early and the host shrinks onto
    the next rung."""
    rng = np.random.default_rng(4)
    words = [bytes(rng.integers(97, 103, size=int(rng.integers(3, 9))).tolist()) for _ in range(900)]
    data = b" ".join(words[int(i)] for i in rng.integers(0, 900, 6000))
    starts = np.zeros(len(data), np.uint8)
    starts[0] = 1
    starts[1:] = np.frombuffer(data, np.uint8)[:-1] == 32
    stream = make_stream(data, starts)
    assert pad_stream(stream).symbols.shape[0] == 8192
    events = []
    port = Trainer(device="cpu").train(data, starts, target_vocab_size=256 + 400,
                                       on_progress=events.append)
    _same(port, _oracle(data, starts, 256 + 400))
    assert len(events) >= 2 and events[0]["symbolCount"] + 32 <= 4096


def test_next_id_above_0x8000(english_text):
    """Merged tokens get ids >= 0x8000, so pair ids of created pairs reach
    past 2^31: the winner order must stay unsigned."""
    filler = [bytes([1, i & 0xFF, i >> 8]) for i in range(0x8000 + 7 - 256)]
    base = [bytes([i]) for i in range(256)] + filler
    data, starts = _pretok(english_text[:6000])
    port = Trainer(Vocab.from_entries(base), device="cpu").train(data, starts, target_vocab_size=len(base) + 80)
    oracle = _oracle(data, starts, len(base) + 80, vocab=JaxVocab.from_entries(base))
    _same(port, oracle)
    assert any(a >= 0x8000 for a, _b, _z in port.merges)
    jax_r = TPUTrainer(JaxVocab.from_entries(base)).train(data, starts, target_vocab_size=len(base) + 80)
    _same(port, jax_r)


def test_nul_adjacent_created_pairs():
    word = b"\x00ab\x00"
    data = (word + b" ") * 300 + b"xy " * 200
    starts = np.zeros(len(data), np.uint8)
    starts[:: len(word) + 1][:300] = 1
    for pos in range(300 * (len(word) + 1), len(data), 3):
        starts[pos] = 1
    _same(_port(data, starts, 256 + 40), _oracle(data, starts, 256 + 40))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fuzz_random_corpora(seed):
    rng = np.random.default_rng(seed)
    alpha = int(rng.integers(3, 30))
    n_words = int(rng.integers(50, 400))
    words = [bytes(rng.integers(1, 1 + alpha, size=int(rng.integers(1, 12))).tolist())
             for _ in range(n_words)]
    reps = rng.zipf(1.3, size=n_words).clip(1, 500)
    corpus = [w for w, r in zip(words, reps) for _ in range(int(r))]
    rng.shuffle(corpus)
    data = b" ".join(corpus)
    starts = np.zeros(len(data), np.uint8)
    pos = 0
    for w in corpus:
        starts[pos] = 1
        pos += len(w) + 1
    target = 256 + int(rng.integers(20, 200))
    _same(_port(data, starts, target), _oracle(data, starts, target))


def test_wide_merges_take_the_dense_path(monkeypatch):
    """A corpus where the first winner (a,b) leaves more than N_PROBES
    affected window slots: the dense window recount runs and the merge
    list still equals the oracle."""
    words = [bytes([x, 1, 2, y]) for x in range(40, 120) for y in range(40, 52)]
    data = b" ".join(w for w in words for _ in range(3))
    starts = np.zeros(len(data), np.uint8)
    starts[:: 5] = 1
    calls = []
    real = ts._post_counts
    monkeypatch.setattr(ts, "_post_counts", lambda *a: calls.append(1) or real(*a))
    _same(_port(data, starts, 256 + 30), _oracle(data, starts, 256 + 30))
    assert calls


def test_post_counts_matches_jax():
    import jax.numpy as jnp

    from gpu_bpe_tpu.ops.train_step import _post_counts as jax_post_counts

    rng = np.random.default_rng(5)
    cap, n = 4096, 3000
    sym = np.zeros(cap, np.uint32)
    sym[:n] = rng.integers(1, 12, size=n)
    sym[:n] |= (rng.random(n) < 0.2).astype(np.uint32) << 16
    w = np.zeros(cap, np.int32)
    w[:n] = rng.integers(1, 50, size=n)
    cand = np.full(256, 0xFFFFFFFF, np.uint32)
    counts = np.full(256, -1, np.int32)
    live = rng.permutation(256)[:150]
    cand[live] = rng.integers(1, 12, size=150) << 16 | rng.integers(1, 12, size=150)
    counts[live] = 7
    pair, l_slot, r_slot = (3 << 16) | 4, (5 << 16) | 6, 1
    j = jax_post_counts(jnp.asarray(cand), jnp.asarray(counts), jnp.uint32(pair), jnp.uint32(l_slot),
                        jnp.uint32(r_slot), jnp.asarray(sym), jnp.asarray(w), jnp.asarray(n), 0)
    t = lambda x: torch.tensor(x, dtype=torch.int64)  # noqa: E731
    p = ts._post_counts(torch.from_numpy(cand.astype(np.int64)), torch.from_numpy(counts.astype(np.int64)),
                        t(pair), t(l_slot), t(r_slot), torch.from_numpy(sym.astype(np.int32)),
                        torch.from_numpy(w), t(n))
    np.testing.assert_array_equal(p[0].numpy(), np.asarray(j[0]).astype(np.int64))
    assert int(p[1]) == int(j[1]) and int(p[2]) == int(j[2])


def test_maintained_counts_stay_exact():
    """CLAUDE.md invariant 3b on the port: after every batch, each live
    window slot's count equals its pair-stream count."""
    text = "aaaaaa bb aaaa abab baba " * 40 + "cc ccc cccc the then there " * 30
    data, starts = _pretok(text)
    stream = make_stream(data, starts)
    padded = pad_stream(stream)
    st = ts.init_state(padded.symbols, padded.weights, stream.n, 256, device="cpu")
    for _ in range(6):
        st = ts.train_batch(st, 16)
        pair, valid = ts._pair_ids(st.symbols, st.n)
        w = torch.where(valid, st.weights.to(torch.int64), 0)
        for c, k in zip(st.cand.tolist(), st.cand_counts.tolist()):
            if k >= 0:
                assert int(w[pair == c].sum()) == k
        if int(st.early_stop):
            break


def test_recount_budget_only_moves_batch_ends(english_text):
    data, starts = _pretok(english_text[:8000])
    stream = make_stream(data, starts)
    padded = pad_stream(stream)
    runs = {}
    for budget in (None, 1):
        st = ts.init_state(padded.symbols, padded.weights, stream.n, 256, device="cpu")
        merges, batches = [], 0
        while len(merges) < 74 and not int(st.early_stop):
            st = ts.train_batch(st, 74 - len(merges), budget)
            log = ts._pack_summary(st)[: 3 * 1024].reshape(-1, 3)
            merges += log[: int(st.merges_done)].tolist()
            batches += 1
        runs[budget] = (merges, batches)
    assert runs[None][0] == runs[1][0]
    assert runs[1][1] > runs[None][1]


def test_checkpoint_not_ported(tmp_path):
    """Checkpointing is ported (tests/test_torch_checkpoint.py): a run with
    ``checkpoint_path`` writes its merge list there."""
    from gpu_bpe_tpu_torch.ops.checkpoint import TrainingCheckpoint

    stream = make_stream(b"hello world, hello world", None)
    path = str(tmp_path / "x.json")
    res = Trainer(device="cpu").train_stream(stream, 300, checkpoint_path=path)
    assert TrainingCheckpoint.load(path).merges == res.merges and res.merges


def test_cuda_device_requires_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        Trainer(device="cuda")


def test_run_totals_mass_beyond_int32():
    """Global stream mass past 2^31 must not corrupt run totals; per-run
    totals (each < 2^31) are exact and pair id 0 yields none."""
    sp = torch.from_numpy(np.repeat(np.arange(1, 9), 4))
    sw = torch.full((32,), 125_000_000, dtype=torch.int64)
    rt = ts._run_totals(sp, sw)
    ends = torch.nonzero(rt).flatten()
    assert len(ends) == 8 and bool((rt[ends] == 500_000_000).all())
    assert int(ts._run_totals(torch.zeros(4, dtype=torch.int64), torch.ones(4, dtype=torch.int64)).abs().sum()) == 0


def test_recount_winner_matches_jax():
    import jax.numpy as jnp
    from jax import lax

    from gpu_bpe_tpu.ops.train_step import _full_recount_impl as jax_recount

    rng = np.random.default_rng(12)
    cap, n = 8192, 6000
    sym = np.zeros(cap, np.uint32)
    sym[:n] = rng.choice(np.array([3, 0x8001, 0x8002, 0xFFF0, 7], np.uint32), size=n)
    sym[:n] |= (rng.random(n) < 0.1).astype(np.uint32) << 16
    w = np.zeros(cap, np.int32)
    w[:n] = rng.integers(1, 1000, size=n)
    iota = lax.broadcasted_iota(jnp.int32, (cap,), 0)
    jb = jax_recount(jnp.asarray(sym), jnp.asarray(w), jnp.asarray(n), iota, 0)
    pb = ts._full_recount_impl(torch.from_numpy(sym.astype(np.int32)), torch.from_numpy(w), torch.tensor(n))
    assert int(pb[0]) == int(jb[0]) and int(pb[1]) == int(jb[1])
    assert int(pb[0]) >> 16 >= 0x8000 or int(pb[1]) > 0


# ───────────── the gated merge: the certified merge's scalar glue in the kernel ─────────────

from dataclasses import replace  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from gpu_bpe_tpu_torch.ops import kernels as tk  # noqa: E402
from gpu_bpe_tpu_torch.ops.build import LAUNCHES  # noqa: E402

_PAIR = (97 << 16) | 98


def _kernel_gate_words(pend_pair, pend_count, next_id, fill, samp, n_aff):
    """The gate words as merge_compact_tracked.cu computes them, in Python
    ints and in enum Gate's order: the gate in every block of merge_tiles,
    the sampled pairs in track's last block."""
    active = pend_count >= 2 and next_id <= 0xFFFF
    has_room = active and fill <= tk.W_SLOTS - 2
    z16 = next_id & 0xFFFF
    l_ok = has_room and samp[0] > 0 and samp[1] != 0
    r_ok = has_room and samp[2] > 0 and samp[3] != 0
    l_tok, r_tok = samp[1] if l_ok else 0x10000, samp[3] if r_ok else 0x10000
    return [pend_pair if active else 0, int(active), int(has_room), int(n_aff <= tk.N_PROBES), int(l_ok),
            int(r_ok), l_tok, r_tok, (l_tok << 16) | z16 if l_ok else 1, (z16 << 16) | r_tok if r_ok else 1]


def _glue_words(st, samp, n_aff):
    """The same words from the train step's torch glue: ``_gate``,
    ``_sampled_pairs`` and ``n_aff <= N_PROBES``."""
    active, pair, has_room = ts._gate(st)
    sp = ts._sampled_pairs(st, samp, has_room)
    return [int(x) for x in (pair, active, has_room, n_aff <= tk.N_PROBES, sp["l_ok"], sp["r_ok"], sp["l_tok"],
                             sp["r_tok"], sp["l_slot"], sp["r_slot"])]


def _gate_state(pend_pair, pend_count, next_id, fill):
    t = lambda x: torch.tensor(x, dtype=torch.int64)  # noqa: E731
    return SimpleNamespace(pend_pair=t(pend_pair), pend_count=t(pend_count), next_id=t(next_id), fill=t(fill))


@pytest.mark.parametrize("pend_pair,pend_count,next_id,fill", [
    (_PAIR, 5, 300, 128),
    (_PAIR, 2, 300, 254),  # the last room in the window
    (_PAIR, 5, 300, 255),  # a full window
    (_PAIR, 1, 300, 128),  # stopped: count < 2
    (_PAIR, -1, 300, 128),  # the initial pending count
    (_PAIR, 5, 0xFFFF, 128),  # the last id that fits
    (_PAIR, 5, 0x10000, 128),  # stopped: the ids ran out
    ((0xFFFE << 16) | 0xFFFD, 7, 0xFFF0, 130),  # pair ids past 2^31
])
def test_gate_words_model_the_train_step_glue(pend_pair, pend_count, next_id, fill):
    """The kernel's gate and sampled-pair words equal ``_gate`` and
    ``_sampled_pairs`` for every sample state: weight -1 (no created pair),
    0 (only the other side), a sampled token of 0 on either side, the
    largest token, and n_aff at and above N_PROBES."""
    st = _gate_state(pend_pair, pend_count, next_id, fill)
    samps = [(7, 97, 3, 98), (-1, 0, -1, 0), (0, 0, 4, 99), (5, 98, 0, 0), (6, 0, 2, 0), (6, 99, 2, 0),
             (3, 0, 3, 97), (1, 0xFFFF, 1, 0xFFFF)]
    for samp in samps:
        for n_aff in (0, 3, tk.N_PROBES, tk.N_PROBES + 1, 200):
            want = _kernel_gate_words(pend_pair, pend_count, next_id, fill, samp, n_aff)
            assert _glue_words(st, torch.tensor(samp, dtype=torch.int64), torch.tensor(n_aff)) == want, (samp, n_aff)


WS = 1 << 16


def _gated_case(name):
    """(symbols, weights, n, cand, counts, pend_count, next_id, fill) of one
    crafted gated merge of (97, 98); capacity 64."""
    a, b, c = 97, 98, 99
    cand = np.full(tk.W_SLOTS, 0xFFFFFFFF, np.int64)
    counts = np.full(tk.W_SLOTS, -1, np.int64)
    cand[:4], counts[:4] = [_PAIR, (c << 16) | a, (b << 16) | c, (c << 16) | c], [9, 4, 3, 2]
    count, next_id, fill = 9, 300, 132
    rng = np.random.default_rng(len(name))
    if name == "no_created":  # [a b] words, none last (Z before the zero pad makes (Z, 0)): samp (-1, 0, -1, 0)
        sym, w = [WS | a, b, WS | c, WS | a, b, WS | c], [3, 3, 3, 2, 2, 2]
    elif name == "right_only":  # only (Z, c): samp (0, 0, w, c)
        sym, w = [WS | a, b, c, WS | a, b, c], [4, 4, 4, 1, 1, 1]
    elif name == "token0_left":  # the heaviest left pair is (0, Z): not sampled
        sym, w = [WS | 0, a, b, WS | c, a, b], [9, 9, 9, 2, 2, 2]
    elif name == "token0_right":  # the heaviest right pair is (Z, 0): not sampled
        sym, w = [WS | a, b, 0, WS | a, b, c], [9, 9, 9, 2, 2, 2]
    else:
        sym = list(rng.choice([a, b, c, 100], size=50) | ((rng.random(50) < 0.2) << 16))
        w = list(rng.integers(1, 9, size=50))
        if name == "wide":  # more than N_PROBES affected slots
            aff = [(t << 16) | a for t in range(200, 200 + tk.N_PROBES + 6)]
            cand[4 : 4 + len(aff)], counts[4 : 4 + len(aff)] = aff, 1
        count = {"stopped_count": 1, "initial_count": -1}.get(name, count)
        next_id = {"stopped_id": 0x10000, "last_id": 0xFFFF}.get(name, next_id)
        fill = {"full_window": 255, "last_room": 254}.get(name, fill)
    sym = np.asarray(sym + [0] * (64 - len(sym)), np.int64).astype(np.int32)
    w = np.asarray(w + [0] * (64 - len(w)), np.int32)
    n = int(np.count_nonzero(w))
    return (torch.from_numpy(sym), torch.from_numpy(w), n, torch.from_numpy(cand), torch.from_numpy(counts),
            count, next_id, fill)


@pytest.mark.parametrize("name", ["random", "no_created", "right_only", "token0_left", "token0_right", "wide",
                                  "stopped_count", "initial_count", "stopped_id", "last_id", "full_window",
                                  "last_room"])
def test_gated_plain_merge_equals_the_glue(name):
    """The plain gated mode: the window-mode merge of the gated pair, and
    gate words equal to the kernel's model and to the torch glue on the
    merge's own samples; host = sout, n_new, n_aff. No launch on the CPU."""
    sym, w, n, cand, counts, count, next_id, fill = _gated_case(name)
    before = LAUNCHES.copy()
    out = tk.merge_compact_tracked(sym, w, n, _PAIR, next_id, cand, counts, gate=(count, fill))
    assert LAUNCHES == before
    assert len(out) == 10 and isinstance(out[9], tk.Gated)
    g = out[9]
    st = _gate_state(_PAIR, count, next_id, fill)
    _, pair_eff, _ = ts._gate(st)
    window = tk.merge_compact_tracked(sym, w, n, pair_eff, next_id, cand, counts)
    for got, want in zip(out[:9], window):
        assert got.dtype == want.dtype and torch.equal(got, want)
    samp, n_aff = out[5], int(out[8])
    words = [int(x) for x in g[: tk.GATE_WORDS]]
    assert words == _kernel_gate_words(_PAIR, count, next_id, fill, samp.tolist(), n_aff)
    assert words == _glue_words(st, samp, out[8])
    assert g.host.tolist()[8:] == [int(out[2]), n_aff] and g.host[:8].data_ptr() == g.sout.data_ptr()
    expect = {"no_created": [-1, 0, -1, 0], "right_only": [0, 0, 4, 99]}
    if name in expect:
        assert samp.tolist() == expect[name]
    if name.startswith("token0"):
        side = 1 if name == "token0_left" else 3
        assert int(samp[side]) == 0 and int(samp[side - 1]) == 9 and words[4 + side // 2] == 0
    if name == "wide":
        assert n_aff > tk.N_PROBES and words[3] == 0
    if name in ("stopped_count", "initial_count", "stopped_id"):
        assert words[:3] == [0, 0, 0] and int(out[2]) == n


def _parent_certified_merge(st):
    """The certified merge as the loop ran it with its torch glue: ``_gate``
    and ``_sampled_pairs`` around the window mode, ``torch.cat`` before the
    read."""
    active, pair_eff, has_room = ts._gate(st)
    sym2, w2, n_new, bins_l, bins_r, samp, pcnt, probes, n_aff = tk.merge_compact_tracked(
        st.symbols, st.weights, st.n, pair_eff, st.next_id, st.cand, st.cand_counts)
    sampled = ts._sampled_pairs(st, samp, has_room)
    l_slot, r_slot = sampled.pop("l_slot"), sampled.pop("r_slot")
    cnt2 = tk.count_pairs2(sym2, w2, n_new, l_slot, r_slot)
    scalars = dict(pair=pair_eff, count=st.pend_count, next_id=st.next_id, theta=st.theta, ub_new=st.ub_new,
                   fill=st.fill, merges_done=st.merges_done, active=active, early_stop=st.early_stop,
                   use_probes=n_aff <= tk.N_PROBES, n_aff=n_aff, c_l=cnt2[0], c_r=cnt2[1], has_room=has_room,
                   **sampled)
    cand2, counts3, log2, sout = tk.window_post(st.cand, st.cand_counts, bins_l, bins_r, st.merge_log,
                                                probes=probes, pcnt=pcnt, **scalars)
    host = torch.cat([sout, n_new.reshape(1), n_aff.reshape(1)]).tolist()
    if host[9] > tk.N_PROBES:
        counts_sel, c_l, c_r = ts._post_counts(st.cand, st.cand_counts, pair_eff, l_slot, r_slot, sym2, w2, n_new)
        scalars.update(c_l=c_l, c_r=c_r)
        cand2, counts3, log2, sout = tk.window_post(st.cand, counts_sel, bins_l, bins_r, st.merge_log,
                                                    probes=probes, pcnt=pcnt, **scalars)
        host[:8] = sout.tolist()
    st = replace(st, symbols=sym2, weights=w2, n=n_new, next_id=sout[6], early_stop=sout[2],
                 merges_done=sout[0], merge_log=log2, cand=cand2, cand_counts=counts3, ub_new=sout[3],
                 fill=sout[1], pend_pair=sout[7], pend_count=sout[4], pend_cert=sout[5])
    return st, host


def _same_state(a, b):
    for f in ("symbols", "weights", "n", "next_id", "early_stop", "merges_done", "merge_log", "cand",
              "cand_counts", "theta", "ub_new", "recounts", "fill", "pend_pair", "pend_count", "pend_cert"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f


@pytest.mark.parametrize("tweak", ["none", "full_window", "stopped_count", "stopped_id", "wide"])
def test_gated_certified_merge_equals_the_parent_glue(english_text, tweak):
    """``_one_merge_fused_certified`` (the gated mode) and the parent's glue,
    step for step from the same states of a real stream, give equal states
    and host vectors: certified merges, a full window, both stops, and
    wide merges (more than N_PROBES affected slots)."""
    if tweak == "wide":
        words = [bytes([x, 1, 2, y]) for x in range(40, 120) for y in range(40, 52)]
        data = b" ".join(w for w in words for _ in range(3))
        starts = np.zeros(len(data), np.uint8)
        starts[::5] = 1
    else:
        data, starts = _pretok(english_text[:6000])
    stream = make_stream(data, starts)
    padded = pad_stream(stream)
    st = ts._ensure_pending(ts.init_state(padded.symbols, padded.weights, stream.n, 256, device="cpu"), False)
    t = lambda x: torch.tensor(x, dtype=torch.int64)  # noqa: E731
    wide = 0
    for i in range(24):
        if tweak == "full_window" and i % 3 == 0:
            st = replace(st, fill=t(255))
        elif tweak == "stopped_count" and i == 20:
            st = replace(st, pend_count=t(1))
        elif tweak == "stopped_id" and i == 20:
            st = replace(st, next_id=t(0x10000))
        want, want_host = _parent_certified_merge(st)
        got, host = ts._one_merge_fused_certified(st)
        assert host == want_host
        _same_state(got, want)
        wide += host[9] > tk.N_PROBES
        if host[2]:
            break
        st = ts._ensure_pending(got, certified=bool(host[5]))
    if tweak == "wide":
        assert wide
    if tweak.startswith("stopped"):
        assert host[2] == 1 and i == 20


def test_default_cpu_trainer_launches_nothing(english_text):
    """The default loop on the CPU takes the plain gated mode: no launch is
    counted under any key, and the merge list equals force_recount's."""
    data, starts = _pretok(english_text[:4000])
    before = LAUNCHES.copy()
    cert = _port(data, starts, 320)
    assert LAUNCHES == before
    _same(cert, _port(data, starts, 320, force_recount=True))
