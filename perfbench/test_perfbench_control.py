"""The comparison that decides ``correct`` has to fail: the controls, and a
run with the timed path broken underneath, at sizes a test run holds.

    python3 -m pytest perfbench/test_perfbench_control.py -q

The controls are the plain reference with one guarantee of the
configuration broken (``perfbench/control.py``); on the card they run at
the cells' own size. The faults drive the rest of a run on the CPU (the
look for a card skipped) and break what the window produces: a merge step
that returns its state unchanged, half of the input left out, one token or
count altered where it is produced. A cell on one card has no exchange
between chips to leave out.
"""

from __future__ import annotations

import logging

import numpy as np
import pytest

from perfbench import control, run

logging.getLogger("gpu_bpe_tpu_torch").setLevel(logging.WARNING)
SMALL = {"corpus_mib": 0.0625, "vocab_size": 300, "shard_mib": 0.015625}
CELLS = ("train.words-8k", "tokenize.words-8k", "train.bytes-1k", "tokenize.bytes-1k")


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 5])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, seed):
    got = control.control(cell, seed, SMALL)
    assert got["correct"] is False, got


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    assert run.run_cell(cell, 2**31 + 9, 0.3, False, device="cpu", overrides=SMALL)["correct"]


def _unchanged_merge(monkeypatch):
    from gpu_bpe_tpu_torch.ops import train_step

    orig = train_step.merge_compact_tracked

    def step(symbols, weights, n, *args, **kwargs):
        out = orig(symbols, weights, n, *args, **kwargs)
        return (symbols, weights, n) + tuple(out[3:])

    monkeypatch.setattr(train_step, "merge_compact_tracked", step)


def _half_corpus(monkeypatch, ctx):
    orig = ctx.api.train
    monkeypatch.setattr(ctx.api, "train", lambda corpus, *a, **k: orig(corpus[: len(corpus) // 2], *a, **k))


def _altered_count(monkeypatch, ctx):
    orig = ctx.api.train

    def train(*a, **k):
        tok, res = orig(*a, **k)
        res.merge_counts[len(res.merge_counts) // 2] += 1
        return tok, res

    monkeypatch.setattr(ctx.api, "train", train)


def _half_shard(monkeypatch, ctx):
    from gpu_bpe_tpu_torch.ops.tokenize import Tokenizer

    orig = Tokenizer.encode_bytes
    monkeypatch.setattr(Tokenizer, "encode_bytes", lambda self, data: orig(self, bytes(data)[: len(data) // 2]))
    ctx.tok._greedy = None  # the bound method cached by the warm call


def _altered_id(monkeypatch, ctx):
    from gpu_bpe_tpu_torch.ops.tokenize import Tokenizer

    orig = Tokenizer.encode_bytes

    def encode(self, data):
        ids = orig(self, data).copy()
        ids[len(ids) // 2] = np.uint32(ids[len(ids) // 2] ^ 1)
        return ids

    monkeypatch.setattr(Tokenizer, "encode_bytes", encode)
    ctx.tok._greedy = None


FAULTS = [
    ("train.words-8k", "unchanged_step", lambda mp, ctx: _unchanged_merge(mp)),
    ("train.bytes-1k", "unchanged_step", lambda mp, ctx: _unchanged_merge(mp)),
    ("train.words-8k", "half_left_out", _half_corpus),
    ("train.bytes-1k", "half_left_out", _half_corpus),
    ("train.words-8k", "answer_altered", _altered_count),
    ("train.bytes-1k", "answer_altered", _altered_count),
    ("tokenize.words-8k", "half_left_out", _half_shard),
    ("tokenize.bytes-1k", "half_left_out", _half_shard),
    ("tokenize.words-8k", "answer_altered", _altered_id),
    ("tokenize.bytes-1k", "answer_altered", _altered_id),
]


@pytest.mark.parametrize("cell,fault,apply", FAULTS, ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault, apply):
    result = run.run_cell(cell, 2**31 + 9, 0.3, False, device="cpu", overrides=SMALL,
                          patch=lambda ctx: apply(monkeypatch, ctx))
    assert result["correct"] is False, result["checks"]
