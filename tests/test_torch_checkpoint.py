"""Checkpoint and resume of the port (ops/checkpoint.py,
Trainer.train_stream(checkpoint_path=...)) against the numpy oracle and the
JAX package, on the CPU.

Tolerance 0: replayed streams, merge lists, counts, checkpoint bytes and
fingerprints are compared exactly.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from gpu_bpe_tpu.ops import TPUTrainer  # noqa: E402
from gpu_bpe_tpu.ops import checkpoint as jck  # noqa: E402
from gpu_bpe_tpu_torch.core import BPEModel  # noqa: E402
from gpu_bpe_tpu_torch.core.trainer_ref import apply_merge  # noqa: E402
from gpu_bpe_tpu_torch.ops import Trainer, make_stream  # noqa: E402
from gpu_bpe_tpu_torch.ops import checkpoint as ck  # noqa: E402
from gpu_bpe_tpu_torch.pretok import PreTokenizer  # noqa: E402


@pytest.fixture(scope="module")
def stream(english_text):
    data, starts = PreTokenizer().pre_tokenize(english_text[:6000])
    return make_stream(data, starts, dedup=True)


@pytest.fixture(scope="module")
def one_shot(stream):
    """The port's one-shot run to 340 and the JAX package's."""
    return (Trainer(device="cpu").train_stream(stream, target_vocab_size=340),
            TPUTrainer().train_stream(stream, target_vocab_size=340))


def test_one_shot_runs_agree(one_shot):
    port, jax_run = one_shot
    assert port.merges == jax_run.merges and port.merge_counts == jax_run.merge_counts


def test_replay_equals_oracle_and_jax(stream, one_shot):
    merges = one_shot[0].merges[:60]
    state = ck.replay_merges(stream, merges, device="cpu")
    expected = stream.symbols[: stream.n].copy()
    for a, b, new_id in merges:
        expected = apply_merge(expected, a, b, new_id)
    n = int(state.n)
    assert n == len(expected) and int(state.next_id) == merges[-1][2] + 1
    assert state.symbols[:n].numpy().view(np.uint32).tolist() == expected.tolist()
    assert not state.symbols[n:].any() and not state.weights[n:].any()
    jstate = jck.replay_merges(stream, merges)
    assert int(jstate.n) == n
    np.testing.assert_array_equal(state.symbols.numpy().view(np.uint32), np.asarray(jstate.symbols))
    np.testing.assert_array_equal(state.weights.numpy(), np.asarray(jstate.weights))


def test_replay_of_no_merges(stream):
    state = ck.replay_merges(stream, [], device="cpu")
    assert int(state.n) == stream.n and int(state.next_id) == 256
    np.testing.assert_array_equal(state.symbols[: stream.n].numpy().view(np.uint32), stream.symbols[: stream.n])


def test_resume_equals_one_shot(stream, one_shot, tmp_path):
    path = str(tmp_path / "ckpt.json")
    first = Trainer(batch_merges=16, device="cpu").train_stream(stream, target_vocab_size=300,
                                                                checkpoint_path=path, checkpoint_every=1)
    assert ck.TrainingCheckpoint.load(path).merges == first.merges
    resumed = Trainer(batch_merges=16, device="cpu").train_stream(stream, target_vocab_size=340,
                                                                  checkpoint_path=path, checkpoint_every=1)
    assert resumed.merges == one_shot[0].merges and resumed.merge_counts == one_shot[0].merge_counts
    assert ck.TrainingCheckpoint.load(path).merges == one_shot[0].merges


def test_checkpoint_every_batch(stream, tmp_path, monkeypatch):
    """A checkpoint lands every ``checkpoint_every`` batches and at the end."""
    path = str(tmp_path / "every.json")
    written = []
    save = ck.TrainingCheckpoint.save
    monkeypatch.setattr(ck.TrainingCheckpoint, "save",
                        lambda self, p: (written.append(len(self.merges)), save(self, p)))
    Trainer(batch_merges=16, device="cpu").train_stream(stream, target_vocab_size=256 + 80, checkpoint_path=path,
                                                        checkpoint_every=2)
    assert written == [32, 64, 80]


def test_json_and_fingerprint_equal_jax(stream, one_shot, tmp_path):
    r = one_shot[0]
    fp = ck.fingerprint_stream(stream)
    assert fp == jck.fingerprint_stream(stream) and len(fp) == 32
    kw = dict(merges=r.merges[:24], merge_counts=r.merge_counts[:24], next_token_id=280, corpus_fingerprint=fp,
              target_vocab_size=340)
    text = ck.TrainingCheckpoint(**kw).to_json()
    assert text == jck.TrainingCheckpoint(**kw).to_json()
    path = tmp_path / "c.json"
    ck.TrainingCheckpoint(**kw).save(str(path))
    assert path.read_text() == text
    loaded = jck.TrainingCheckpoint.load(str(path))
    assert loaded.merges == kw["merges"] and loaded.corpus_fingerprint == fp
    assert ck.TrainingCheckpoint.from_json(text) == ck.TrainingCheckpoint(**kw)
    assert BPEModel.load(str(path)).vocab_size == 280  # a checkpoint is a partial model


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_across_packages(stream, one_shot, tmp_path, writer):
    """A checkpoint written by either package, resumed by the other, gives
    the one-shot merge list."""
    path = str(tmp_path / f"{writer}.json")
    first = (TPUTrainer(batch_merges=16) if writer == "jax" else Trainer(batch_merges=16, device="cpu"))
    first.train_stream(stream, target_vocab_size=300, checkpoint_path=path, checkpoint_every=1)
    second = (Trainer(batch_merges=16, device="cpu") if writer == "jax" else TPUTrainer(batch_merges=16))
    resumed = second.train_stream(stream, target_vocab_size=340, checkpoint_path=path)
    assert resumed.merges == one_shot[0].merges and resumed.merge_counts == one_shot[0].merge_counts


def test_fingerprint_mismatch_raises(stream):
    bad = ck.TrainingCheckpoint(merges=[(97, 98, 256)], merge_counts=[2], next_token_id=257,
                                corpus_fingerprint="deadbeef", target_vocab_size=300)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        ck.resume_stream(stream, bad, strict=True, device="cpu")
    gap = ck.TrainingCheckpoint(merges=[(97, 98, 257)], merge_counts=[2], next_token_id=258,
                                corpus_fingerprint=ck.fingerprint_stream(stream), target_vocab_size=300)
    with pytest.raises(ValueError, match="not contiguous"):
        ck.resume_stream(stream, gap, device="cpu")


def test_mismatched_checkpoint_is_ignored(stream, one_shot, tmp_path, monkeypatch):
    """A checkpoint of another corpus is left aside with a warning and the
    run starts fresh (and then overwrites it)."""
    path = tmp_path / "other.json"
    ck.TrainingCheckpoint(merges=[(97, 98, 256)], merge_counts=[2], next_token_id=257,
                          corpus_fingerprint="deadbeef", target_vocab_size=300).save(str(path))
    from gpu_bpe_tpu_torch.ops import trainer

    warned = []
    monkeypatch.setattr(trainer.logger, "warning", lambda msg, *args: warned.append(msg % args))
    res = Trainer(device="cpu").train_stream(stream, target_vocab_size=340, checkpoint_path=str(path))
    assert len(warned) == 1 and "does not match" in warned[0]
    assert res.merges == one_shot[0].merges
    assert ck.TrainingCheckpoint.load(str(path)).corpus_fingerprint == ck.fingerprint_stream(stream)
