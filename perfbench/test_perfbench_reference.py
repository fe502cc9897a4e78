"""The benchmark's plain references against the program's CPU path and its
CPU oracles, at small sizes.

    python3 -m pytest perfbench/test_perfbench_reference.py -q
"""

from __future__ import annotations

import logging

import numpy as np
import pytest

from perfbench.corpus import synth_corpus
from perfbench.reference import bpe, greedy

logging.getLogger("gpu_bpe_tpu_torch").setLevel(logging.WARNING)


@pytest.mark.parametrize("seed,n_bytes,vocab", [(3, 1 << 16, 400), (2**31 + 11, 100_003, 520)])
@pytest.mark.parametrize("pre_tokenize", [True, False])
def test_merges_equal_the_program(seed, n_bytes, vocab, pre_tokenize):
    from gpu_bpe_tpu_torch import api

    corpus = synth_corpus(n_bytes, seed)
    ref = bpe.train(corpus, vocab)
    _, res = api.train(corpus, api.TrainConfig(vocab_size=vocab, device="cpu", pre_tokenize=pre_tokenize,
                                               show_progress=False))
    assert res.merges == ref.merges
    assert res.merge_counts == ref.merge_counts
    assert res.vocab == ref.vocab


def test_word_starts_equal_both_rules_of_the_program():
    from gpu_bpe_tpu_torch.pretok import PreTokenizer, byte_word_starts

    text = synth_corpus(50_000, 9) + b"  two  spaces\n\n x\n"
    want = bpe.word_starts(text)
    data, starts = PreTokenizer().pre_tokenize_bytes(text)
    assert data == text
    assert np.array_equal(starts.astype(bool), want)
    assert np.array_equal(byte_word_starts(text).astype(bool), want)


@pytest.mark.parametrize("bad", [b"it's", b"a\tb", b"x1", "café".encode()])
def test_word_starts_refuse_bytes_the_rules_part_on(bad):
    with pytest.raises(ValueError):
        bpe.word_starts(b"ok " + bad)


def test_overlapping_sites_collapse_and_ties_go_to_the_smaller_pair():
    # "aaaa" under (a, a) is one token; (a, a) and (b, b) tie at 3 with the
    # packed ids (97 << 16 | 97) < (98 << 16 | 98)
    ref = bpe.train_words({b"aaaa": 1, b"bbbb": 1}, 2)
    assert ref.merges == [(97, 97, 256), (98, 98, 257)]
    assert ref.merge_counts == [3, 3]
    assert bpe.train_words({b"aaaa": 1, b"bbbb": 1}, 1, break_ties=True).merges == [(98, 98, 256)]


@pytest.mark.parametrize("seed,vocab", [(5, 700), (2**31 + 3, 1000)])
def test_ids_equal_the_program_and_its_oracle(seed, vocab):
    from gpu_bpe_tpu_torch.core.encoder_ref import GreedyTrieEncoder
    from gpu_bpe_tpu_torch.ops.tokenize import Tokenizer

    corpus = synth_corpus(1 << 17, seed)
    words = bpe.train(corpus, vocab).vocab
    m = greedy.Matcher(words, corpus)
    assert m.chunk == max(512, min(2048, 8 * max(len(v) for v in words)))
    tok = Tokenizer(words, device="cpu")
    n = len(corpus)
    for off, length in [(0, n), (12_345, n), (n - 7, 40_000), (777, 513)]:
        shard = (corpus + corpus)[off : off + length]
        got = m.encode(off, length)
        assert np.array_equal(got, GreedyTrieEncoder(words).encode(shard))
        assert np.array_equal(got, tok.encode_bytes(shard))


def test_duplicate_entries_take_the_larger_id_and_unchunked_differs():
    corpus = b"ab ab abab\n" * 200
    vocab = [bytes([i]) for i in range(256)] + [b"ab", b" ab", b"ab"]
    m = greedy.Matcher(vocab, corpus)
    ids = m.encode(0, len(corpus))
    assert 256 not in ids and 258 in ids
    from gpu_bpe_tpu_torch.core.encoder_ref import GreedyTrieEncoder

    assert np.array_equal(ids, GreedyTrieEncoder(vocab).encode(corpus))
    assert not np.array_equal(m.encode(0, len(corpus), chunked=False), ids)


def test_entries_across_word_boundaries_are_refused():
    with pytest.raises(ValueError):
        greedy.Matcher([bytes([i]) for i in range(256)] + [b"a b"], b"a b a b\n")
