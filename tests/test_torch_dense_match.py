"""The dense join's hash table and probe (``ops/dense_kernels.py``), held to
the plain equality join on the CPU.

``dense_match.cu`` runs only on a card (``ops/selftest.py`` and
``chip_smoke.py`` hold it to ``dense_match_plain`` there). Here the host
table is checked through ``DenseHash.lookup``, the numpy mirror of the
kernel's probe: every dense key is found at its id, no other window is
found, and a numpy model of the kernel's pass (lengths longest first, each
within the position's room, the first hit ends the position) gives the
plain join's ids and lengths, at chunk ends and at the input's end.
"""

import functools

import numpy as np
import pytest
import torch

from gpu_bpe_tpu_torch import Tokenizer
from gpu_bpe_tpu_torch.core import ReferenceTrainer, bytes_to_symbols
from gpu_bpe_tpu_torch.ops import build
from gpu_bpe_tpu_torch.ops import dense_kernels as dk
from gpu_bpe_tpu_torch.ops import kernels as tk

VOCABS = ("trained_1k", "stab_8k_tail", "gather_64_200", "nul_ff", "forced_collisions")


def _base():
    return [bytes([i]) for i in range(256)]


def _add_random(vocab, rng, count, lo, hi, letters):
    seen = set(vocab)
    while count:
        t = bytes(rng.integers(97, 97 + letters, size=int(rng.integers(lo, hi + 1))).tolist())
        if t not in seen:
            seen.add(t)
            vocab.append(t)
            count -= 1
    return vocab


@functools.cache
def _vocab(name: str) -> list[bytes]:
    rng = np.random.default_rng(VOCABS.index(name))
    if name == "forced_collisions":
        return _vocab("trained_1k")
    if name == "trained_1k":
        from bench_torch import synth_corpus

        corpus = synth_corpus(64 << 10, seed=0)
        return ReferenceTrainer().train(bytes_to_symbols(corpus), target_vocab_size=1024).vocab
    if name == "stab_8k_tail":  # 2..14 on two stab levels, 15..16 left to the dense join
        vocab = _add_random(_base(), rng, 2600, 2, 12, 8)
        return _add_random(vocab, rng, 40, 15, 16, 3)
    if name == "gather_64_200":  # tokens past the 63-byte walk step
        vocab = _add_random(_base(), rng, 300, 2, 10, 4)
        return _add_random(vocab, rng, 40, 64, 200, 2)
    return _base() + [  # keys that differ only in NUL padding, and 0xFF runs
        b"ab", b"ab\x00", b"ab\x00\x00", b"ab\x00\x00\x00", b"ab\x00\x00\x00\x00", b"\x00\x00",
        b"\x00\x00\x00\x00\x00", b"\x00" * 9, b"\xff\xff", b"\xff" * 4, b"\xff" * 7, b"\x00\xff" * 5,
        b"a\x00\x00\x00\x00b", b"\xff\x00\xff", b"\xfe\xff\xff\xff\xff",
    ]


def _tokenizer(name: str) -> Tokenizer:
    return Tokenizer(_vocab(name), device="cpu")


def _hash(name: str, tables) -> dk.DenseHash:
    if name != "forced_collisions":
        return dk.DenseHash.build(tables)
    n_keys = sum(len(tables.ids[ln]) for ln in tables.dense_lengths)
    return dk.DenseHash.build(tables, n_slots=1 << n_keys.bit_length())  # the least power of two above


def _words(rows: np.ndarray, ln: int) -> np.ndarray:
    """Big-endian u32 words of byte rows ``[N, >= ln]``, the last word
    masked to the length's bytes."""
    nw = (ln + 3) // 4
    b = np.zeros((rows.shape[0], 4 * nw), dtype=np.uint32)
    b[:, :ln] = rows[:, :ln]
    w = b.reshape(-1, nw, 4)
    return (w[..., 0] << 24) | (w[..., 1] << 16) | (w[..., 2] << 8) | w[..., 3]


@pytest.mark.parametrize("name", VOCABS)
def test_hash_table_finds_every_key_and_nothing_else(name):
    tables = _tokenizer(name).tables
    h = _hash(name, tables)
    n_keys = sum(len(tables.ids[ln]) for ln in tables.dense_lengths)
    n_slots = h.slots.shape[0]
    assert tables.dense_lengths and list(h.lengths) == sorted(tables.dense_lengths, reverse=True)
    assert int((h.slots[:, 0] != 0).sum()) == n_keys
    if name == "forced_collisions":
        assert n_slots < 2 * n_keys and h.max_probes > 8
    else:
        assert 2 * n_keys <= n_slots < max(32, 4 * n_keys)
    if name == "stab_8k_tail":
        assert tables.stab is not None and tables.dense_lengths == [15, 16]
    rng = np.random.default_rng(7)
    keys = {bytes(t) for t in _vocab(name)}
    for ln in tables.dense_lengths:
        np.testing.assert_array_equal(h.lookup(ln, tables.keys[ln]), tables.ids[ln])
        # windows of the keys' own bytes, one byte changed, and random ones
        rows = np.array([list(t) for t in _vocab(name) if len(t) == ln], dtype=np.uint8)
        near = rows[rng.integers(0, len(rows), size=400)]
        near[np.arange(400), rng.integers(0, ln, size=400)] += rng.integers(1, 256, size=400).astype(np.uint8)
        far = rng.integers(0, 256, size=(400, ln), dtype=np.uint8)
        far[:100] = np.where(far[:100] < 128, 0, 255)  # NUL and 0xFF runs
        others = np.array([r for r in np.concatenate([near, far]) if bytes(r) not in keys], dtype=np.uint8)
        assert len(others) > 100
        assert (h.lookup(ln, _words(others, ln)) == -1).all()


def _murmur(ln: int, words) -> int:
    """murmur3's block mix and finaliser, one u32 at a time."""
    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & 0xFFFFFFFF

    h = (ln * 0x9E3779B9) & 0xFFFFFFFF
    for w in words:
        k = rotl((int(w) * 0xCC9E2D51) & 0xFFFFFFFF, 15) * 0x1B873593 & 0xFFFFFFFF
        h = (rotl(h ^ k, 13) * 5 + 0xE6546B64) & 0xFFFFFFFF
    h ^= ln
    h ^= h >> 16
    h = h * 0x85EBCA6B & 0xFFFFFFFF
    h ^= h >> 13
    h = h * 0xC2B2AE35 & 0xFFFFFFFF
    return h ^ (h >> 16)


def test_hash_words_is_murmur3_word_by_word():
    rng = np.random.default_rng(3)
    for ln in (2, 4, 5, 13, 16, 17, 200):
        words = rng.integers(0, 2**32, size=(50, (ln + 3) // 4), dtype=np.uint64).astype(np.uint32)
        words[:5] = 0
        words[5:10] = 0xFFFFFFFF
        np.testing.assert_array_equal(dk.hash_words(ln, words), [_murmur(ln, row) for row in words])


def _kernel_model(buf: np.ndarray, h: dk.DenseHash, input_len: int, chunk: int, in_id=None, in_len=None):
    """dense_match.cu in numpy: per position, the dense lengths longest
    first, each only within the room; the first hit ends the position."""
    n = len(buf)
    p = np.arange(n)
    if in_id is None:
        mid = np.where(p < input_len, h.byte_ids[buf], -1).astype(np.int64)
        mlen = (mid >= 0).astype(np.int64)
    else:
        mid, mlen = in_id.copy(), in_len.copy()
    room = np.minimum((p // chunk + 1) * chunk, input_len) - p
    padded = np.concatenate([buf, np.zeros(int(h.lengths[0]) + 8, np.uint8)])
    done = np.zeros(n, dtype=bool)
    for ln in h.lengths:
        at = np.flatnonzero(~done & (ln <= room))
        rows = padded[at[:, None] + np.arange(ln)[None, :]]
        found = h.lookup(int(ln), _words(rows, int(ln)))
        hit = at[found >= 0]
        mid[hit], mlen[hit] = found[found >= 0], ln
        done[hit] = True
    return mid, mlen


def _pass_input(name: str, tok: Tokenizer, rng):
    """A pass of keys and noise: 3.5 chunks of input in a buffer of 4
    chunks, so chunk ends and the input's end cut tokens."""
    dense = [t for t in _vocab(name) if len(t) in tok.tables.dense_lengths]
    multi = [t for t in _vocab(name) if len(t) > 1]
    parts, size = [], 0
    while size < 4 * tok.chunk_size:
        u = rng.random()
        pool = dense if u < 0.5 else multi
        t = pool[int(rng.integers(len(pool)))] if u < 0.8 else rng.bytes(int(rng.integers(1, 4)))
        parts.append(t)
        size += len(t)
    buf = np.frombuffer(b"".join(parts), dtype=np.uint8)[: 4 * tok.chunk_size].copy()
    return buf, 4 * tok.chunk_size - tok.chunk_size // 2


@pytest.mark.parametrize("incoming", ["bytes", "stab"])
@pytest.mark.parametrize("name", VOCABS)
def test_probe_model_equals_plain_join(name, incoming):
    tok = _tokenizer(name)
    dense = tok._dense
    h = _hash(name, tok.tables)
    rng = np.random.default_rng(11)
    buf, input_len = _pass_input(name, tok, rng)
    cs = tok.chunk_size
    args = {}
    if incoming == "stab":  # an incoming match of its own, as the stab join gives
        n = len(buf)
        args = {"in_id": rng.integers(-1, len(tok.vocab), size=n), "in_len": rng.integers(0, 9, size=n)}
    got = _kernel_model(buf, h, input_len, cs, **args)
    want = dk.dense_match_plain(torch.from_numpy(buf), dense, input_len, cs,
                                *[torch.from_numpy(a) for a in args.values()])
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w.numpy())
    assert (got[1] > 1).sum() > 50  # the dense join matched
    assert (got[1][input_len:] == (0 if incoming == "bytes" else got[1][input_len:])).all()
    ends = np.arange(cs, len(buf), cs)
    assert (got[1][ends - 1] <= 1).all() or incoming == "stab"  # nothing crosses a chunk end


def test_dense_match_rejects_unsupported_devices():
    tok = _tokenizer("nul_ff")
    data = torch.zeros(64, dtype=torch.uint8)
    with pytest.raises(ValueError):
        dk.dense_match(data.to("meta"), tok._dense, 64, 512)
    with pytest.raises(ValueError):
        dk.dense_match(data, tok._dense, 64, 512, torch.zeros(64, dtype=torch.int64, device="meta"),
                       torch.zeros(64, dtype=torch.int64))


def test_dense_match_never_falls_back_off_the_cpu(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel: where the kernel
    cannot be built, the call raises and the plain join is not taken."""
    tok = _tokenizer("nul_ff")

    def no_compiler():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(dk, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(build, "load", no_compiler)
    monkeypatch.setattr(dk, "dense_match_plain", None)
    before = tk.LAUNCHES["dense_match"]
    with pytest.raises(RuntimeError, match="nvcc"):
        dk.dense_match(torch.zeros(64, dtype=torch.uint8), tok._dense, 64, 512)
    assert tk.LAUNCHES["dense_match"] == before
