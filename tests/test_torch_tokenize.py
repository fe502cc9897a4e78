"""The port's bulk tokenizer (``gpu_bpe_tpu_torch.Tokenizer``, CPU path)
against ``TPUTokenizer`` on the JAX CPU path and the greedy reference
``GreedyTrieEncoder``, on the fixtures of ``tests/test_ops_tokenize.py``.

Tolerance 0 everywhere: tables, packed matches and token ids are integers.
The rank-space chain is held to the JAX package's ``rank_mode="interpret"``
with its overlay kernel in interpret mode too; deep stab levels are forced
with ``_LEVEL_MIN_TOKENS = 1`` in both packages where a test needs them.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

# One intra-op thread: the suite runs several test processes side by side,
# and a full torch CPU thread pool in each of them oversubscribes the cores.
torch.set_num_threads(1)

from gpu_bpe_tpu.core import GreedyTrieEncoder, ReferenceTrainer, bytes_to_symbols  # noqa: E402
from gpu_bpe_tpu.core import tag_word_boundaries  # noqa: E402
from gpu_bpe_tpu.ops import tokenize as jtz  # noqa: E402
from gpu_bpe_tpu.pretok import PreTokenizer  # noqa: E402
from gpu_bpe_tpu_torch import Tokenizer  # noqa: E402
from gpu_bpe_tpu_torch.core import GreedyTrieEncoder as PortGreedy  # noqa: E402
from gpu_bpe_tpu_torch.ops import tokenize as ttz  # noqa: E402


@pytest.fixture(scope="module")
def model(english_text):
    data, starts = PreTokenizer().pre_tokenize(english_text[:15000])
    sym = tag_word_boundaries(bytes_to_symbols(data), starts)
    return ReferenceTrainer().train(sym, target_vocab_size=400)


@pytest.fixture
def deep_levels(monkeypatch):
    """Chain every stab level the vocab can fill, in both packages."""
    monkeypatch.setattr(jtz, "_LEVEL_MIN_TOKENS", 1)
    monkeypatch.setattr(ttz, "_LEVEL_MIN_TOKENS", 1)


def _base():
    return [bytes([i]) for i in range(256)]


def _random_vocab(seed, size, lo, hi, letters=8):
    rng = np.random.default_rng(seed)
    toks = {bytes([b]) for b in range(256)}
    vocab = _base()
    while len(vocab) < size:
        t = bytes(rng.integers(97, 97 + letters, size=int(rng.integers(lo, hi))).tolist())
        if t not in toks:
            toks.add(t)
            vocab.append(t)
    return vocab


def _multi_level_vocab(extra=()):
    """tests/test_ops_tokenize.py TestMultiLevelStab: four chained levels."""
    return _random_vocab(11, 2500, 2, 9) + [
        b"the quick brown", b"the quick brown fox j", b"the quick brown fox jumps lover",
        b"the quick brown f", b"the quick brawn", b"commonprefixiscommon", b"commonprefixisc",
        b"commonprefixi", b"commonpr", *extra,
    ]


def _two_level_vocab():
    """tests/test_ops_tokenize.py TestTwoLevelStab: shared 8-byte prefixes."""
    return _random_vocab(5, 2500, 2, 9) + [
        b"prefixAAs", b"prefixAAsuffi", b"prefixAAsuffix", b"prefixAA", b"prefixBBtail",
        b"overlongtoken0", b"overlongtoken001",
    ]


def _vocab64k(english_text):
    """tests/test_ops_tokenize.py Test64KVocabScale: 65,536 entries."""
    rng = np.random.default_rng(41)
    words = list({w.encode() for w in english_text.split() if 1 < len(w) <= 28})
    vocab = _base()
    seen = set(vocab)
    cands = []
    for w in sorted(words):
        cands += [w, b" " + w] + ([w[: len(w) // 2]] if len(w) > 4 else [])
    rng.shuffle(cands)
    for t in cands:
        if len(vocab) >= 65536:
            break
        if t not in seen and len(t) <= 32:
            seen.add(t)
            vocab.append(t)
    while len(vocab) < 65536:
        t = bytes(rng.integers(97, 123, size=int(rng.integers(2, 16))).tolist())
        if t not in seen:
            seen.add(t)
            vocab.append(t)
    return vocab


# ──────────────────────────────── tables ────────────────────────────────


def _assert_same_tables(a, b):
    assert a.lengths == b.lengths and a.max_token_len == b.max_token_len
    assert a.dense_lengths == b.dense_lengths and a.byte_ids_identity == b.byte_ids_identity
    np.testing.assert_array_equal(a.byte_ids, b.byte_ids)
    assert a.keys.keys() == b.keys.keys()
    for ln in a.keys:
        np.testing.assert_array_equal(a.keys[ln], b.keys[ln])
        np.testing.assert_array_equal(a.ids[ln], b.ids[ln])
    assert (a.stab is None) == (b.stab is None)
    if a.stab is None:
        return
    assert a.stab.keys() == b.stab.keys()
    for k in ("count", "n_groups", "max_len"):
        assert a.stab[k] == b.stab[k], k
    for k in ("open_words", "close_words", "ln", "id"):
        np.testing.assert_array_equal(a.stab[k], b.stab[k])
        assert a.stab[k].dtype == b.stab[k].dtype
    assert len(a.stab["levels"]) == len(b.stab["levels"])
    for la, lb in zip(a.stab["levels"], b.stab["levels"], strict=True):
        assert la.keys() == lb.keys() and la["count"] == lb["count"]
        assert la["n_groups"] == lb["n_groups"]
        for k in ("open", "close", "ln", "id"):
            np.testing.assert_array_equal(la[k], lb[k])


@pytest.mark.parametrize("name", ["base_plus", "trained", "stab4000", "two_level", "multi_level",
                                  "dense_beyond_32", "vocab64k"])
def test_match_tables_equal_jax(name, model, english_text, deep_levels, monkeypatch):
    if name == "vocab64k":  # production threshold, as the 64K fixture uses it
        monkeypatch.setattr(jtz, "_LEVEL_MIN_TOKENS", 512)
        monkeypatch.setattr(ttz, "_LEVEL_MIN_TOKENS", 512)
    vocab = {
        "base_plus": lambda: _base() + [b"ab", b"abc", b" the", b"abcdef"],
        "trained": lambda: model.vocab,
        "stab4000": lambda: _random_vocab(9, 4000, 2, 12, letters=10),
        "two_level": _two_level_vocab,
        "multi_level": _multi_level_vocab,
        "dense_beyond_32": lambda: _multi_level_vocab(extra=[b"A" * 40]),
        "vocab64k": lambda: _vocab64k(english_text),
    }[name]()
    ours, theirs = ttz.MatchTables.from_vocab(vocab), jtz.MatchTables.from_vocab(vocab)
    _assert_same_tables(ours, theirs)
    if name in ("multi_level", "vocab64k"):
        assert len(ours.stab["levels"]) >= (4 if name == "multi_level" else 1)


# ─────────────────────────────── stab join ───────────────────────────────


def _rank_vocab():
    """tests/test_ops_tokenize.py TestRankSpaceStab, plus a NUL token."""
    return _random_vocab(21, 2600, 2, 9) + [
        b"the quick brown", b"the quick brown fox j", b"the quick brown fox jumps lover",
        b"commonprefixiscommon", b"prefixAAsuffix", b"aaaaaaaaa", b"ab\x00\x00",
    ]


def _buffer(data: bytes, n: int):
    buf = np.zeros(n, np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    return buf


def _port_stab_match(vocab, buf, input_len, chunk_size, rank_mode):
    t = ttz.MatchTables.from_vocab(vocab)
    rows = ttz._StabTables(t.stab, "cpu")
    out = ttz._stab_match(torch.from_numpy(buf), rows, input_len, chunk_size, rank_mode)
    return out.numpy().astype(np.uint32)


def test_stab_match_full_width_and_rank_space_match_jax(deep_levels, monkeypatch):
    """One pass of 2^16 positions (two segments at level 1), sparse group
    candidates, long tokens across 512-byte chunk ends, NULs: the port's
    full width and rank space both equal the JAX rank-space chain with its
    Pallas kernels in interpret mode."""
    rng = np.random.default_rng(22)
    filler = bytes(rng.integers(97, 105, size=40000).tolist())
    data = (filler[:9000] + b"the quick brown fox jumps loverXXcommonprefixiscommonYY" * 10
            + b"a" * 490 + b"the quick brown fox jumps lover" * 40 + b"ab\x00\x00ab\x00" * 20
            + filler[9000:20000] + b"prefixAAsuffixthe quick brown fox jZZ" * 5 + filler[20000:])
    n = 1 << 16
    buf = _buffer(data, n)
    vocab = _rank_vocab()
    monkeypatch.setenv("GPU_BPE_TPU_STAB_SCAN", "interpret")
    t = jtz.MatchTables.from_vocab(vocab)
    want = np.asarray(jtz._stab_match(jnp.asarray(buf).astype(jnp.uint32), t.stab,
                                      jnp.asarray(len(data), jnp.int32), 512, rank_mode="interpret"))
    assert ttz._seg_shape(n, 2 * t.stab["count"])[0] == 2
    assert (want >> 16).max() == 31  # the 31-byte token rides the last level
    for mode in ("off", "on"):
        np.testing.assert_array_equal(_port_stab_match(vocab, buf, len(data), 512, mode), want)


@pytest.mark.parametrize("case", ["empty_candidates", "small_tier", "big_tier", "over_capacity"])
def test_rank_space_tiers_equal_full_width(case, deep_levels, monkeypatch):
    """Every capacity tier of the rank-space chain, and the full-width
    chain past both, give the full-width result. The capacity floor is
    lowered so that a 2^16-byte pass reaches every tier: n/32 = 2^11 and
    n/8 = 2^13 group candidates."""
    monkeypatch.setattr(ttz, "_RANK_CAP_FLOOR", 1 << 10)
    n = 1 << 16
    rng = np.random.default_rng(23)
    data = {
        "empty_candidates": bytes(rng.integers(106, 122, size=60000).tolist()),
        "small_tier": bytes(rng.integers(97, 105, size=40000).tolist()) + b"the quick brown fox jQQ" * 100,
        "big_tier": b"aaaaaaaab" * 5000 + b"the quick brown fox jumps lover" * 300,
        "over_capacity": b"a" * 20000 + bytes(rng.integers(97, 105, size=30000).tolist()),
    }[case]
    buf = _buffer(data, n)
    vocab = _rank_vocab()
    count = int(_port_group_count(ttz.MatchTables.from_vocab(vocab), buf, len(data)))
    lo, hi = {"empty_candidates": (0, 0), "small_tier": (1, 1 << 11), "big_tier": ((1 << 11) + 1, 1 << 13),
              "over_capacity": ((1 << 13) + 1, n)}[case]
    assert lo <= count <= hi, (case, count)
    full = _port_stab_match(vocab, buf, len(data), 2048, "off")
    np.testing.assert_array_equal(_port_stab_match(vocab, buf, len(data), 2048, "on"), full)


def _port_group_count(tables, buf, input_len):
    """Positions that carry a level-1 group id (the rank-space candidates)."""
    rows = ttz._StabTables(tables.stab, "cpu")
    d = torch.from_numpy(buf)
    iota = torch.arange(d.shape[0], dtype=torch.int64)
    _, gid = ttz._stab_join(ttz._pack_bytes(d, 0, 4), ttz._pack_bytes(d, 4, 4), iota, rows.level1,
                            input_len, 2048, base_len=0, max_depth=8, depths=10, group_depth=9)
    return (gid != 0xFFFF).sum()


# ───────────────────────────── encode_bytes ─────────────────────────────


def _check(vocab, data: bytes, chunk_size=None, jax_too=True, **kw):
    port = Tokenizer(vocab, chunk_size=chunk_size, device="cpu", **kw)
    ref = GreedyTrieEncoder(vocab, chunk_size=port.chunk_size).encode(data)
    got = port.encode_bytes(data)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(PortGreedy(vocab, chunk_size=port.chunk_size).encode(data), ref)
    if jax_too:
        tpu = jtz.TPUTokenizer(vocab, chunk_size=chunk_size,
                               **({"max_pass_bytes": kw["max_pass_bytes"]} if "max_pass_bytes" in kw else {}))
        assert tpu.chunk_size == port.chunk_size and tpu.max_pass_bytes == port.max_pass_bytes
        np.testing.assert_array_equal(got, tpu.encode_bytes(data))
    return port


def test_base_vocab_identity():
    _check(_base(), b"hello world")


def test_trained_vocab_dense_join(model, english_text):
    port = _check(model.vocab, english_text[:6000].encode())
    assert port.tables.stab is None and port.tables.dense_lengths


def test_longest_match_priority():
    _check(_base() + [b"ab", b"abc", b"abcd"], b"abcd abc ab a abcdabcd")


def test_chunk_boundary_artifact():
    _check(_base() + [b"ab"], b"x" * 511 + b"ab" + b"x" * 100, chunk_size=512)


def test_in_chunk_shorter_match_fallback():
    _check(_base() + [b"ab", b"abcd"], b"x" * 510 + b"abcd" + b"y" * 50, chunk_size=512)


def test_missing_byte_token_fallback():
    port = _check([b"ab"], b"abxab", chunk_size=512)
    assert port.encode_bytes(b"abxab").tolist() == [0, ord("x"), 0]


def test_long_tokens_dense():
    _check(_base() + [b"internationalization", b"internation", b"tion"],
           b"internationalization internation nation tion")


def test_nul_and_high_bytes(model):
    _check(model.vocab, bytes(range(256)) * 4)


def test_stab_vocab_with_long_tokens_and_nuls():
    vocab = _random_vocab(9, 3000, 2, 12, letters=10)
    vocab += [b"x" * 20, b"x" * 24, b"ab\x00", b"ab\x00\x00", b"\x00\x00"]
    rng = np.random.default_rng(2)
    data = (bytes(rng.integers(97, 122, size=5000).tolist()) + b"x" * 100 + b"ab\x00\x00ab\x00"
            + b"\x00" * 7)
    port = _check(vocab, data)
    assert port.tables.stab is not None and port.tables.dense_lengths


def test_chained_multi_level(deep_levels):
    vocab = _multi_level_vocab()
    rng = np.random.default_rng(12)
    filler = bytes(rng.integers(97, 105, size=2000).tolist())
    probes = (b"the quick brown fox jumps loverXXthe quick brown fox jthe quick brown"
              b"the quick brawnthe quick brownZcommonprefixiscommoncommonprefixisc"
              b"commonprefixicommonprXcommonprefixiscommo")
    # the JAX side of this chain is held in test_stab_match_full_width_and_rank_space_match_jax
    port = _check(vocab, filler + probes + filler[:257] + probes, jax_too=False)
    assert len(port.tables.stab["levels"]) == 4 and port.tables.dense_lengths == []
    # rank space on the CPU gives the same ids
    np.testing.assert_array_equal(
        Tokenizer(vocab, device="cpu", rank_mode="on").encode_bytes(filler + probes),
        port.encode_bytes(filler + probes))


def test_wide_walk_32_to_63(deep_levels):
    vocab = _multi_level_vocab(extra=[b"B" * 40, b"B" * 63])
    port = _check(vocab, b"B" * 200 + b"the quick brown fox jumps lover" + b"B" * 63)
    assert port.tables.max_token_len == 63


def test_gather_walk_beyond_63():
    vocab = _base() + [b"C" * 70, b"C" * 64, b"CC"]
    port = _check(vocab, b"C" * 300 + b"xyz" + b"C" * 65 + b"C" * 140)
    assert port.tables.max_token_len == 70


def test_multipass_slicing():
    _check(_base() + [b"ab"], (b"ab" * 3000)[:5000], chunk_size=512, max_pass_bytes=2048)


def test_empty():
    assert Tokenizer(_base(), device="cpu").encode_bytes(b"").tolist() == []


def test_decode_roundtrip(model):
    port = Tokenizer.from_model(model, device="cpu")
    data = "the quick brown fox don't stop".encode()
    assert port.decode(port.encode_bytes(data)) == data


# ───────────────────────────── the port itself ─────────────────────────────


def test_tokenizer_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        Tokenizer(_base())
    assert Tokenizer(_base(), device="cpu").device.type == "cpu"


def test_rank_mode_values():
    with pytest.raises(ValueError):
        Tokenizer(_base(), device="cpu", rank_mode="interpret")
    cpu = torch.zeros(1 << 20, dtype=torch.uint8)
    assert not ttz._use_rank(None, cpu)  # full width on the CPU by default
    assert ttz._use_rank("on", cpu) and not ttz._use_rank("off", cpu)
