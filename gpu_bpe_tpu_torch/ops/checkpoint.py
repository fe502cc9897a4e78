"""Mid-training checkpoint and resume (the port's counterpart of
``gpu_bpe_tpu/ops/checkpoint.py``; the file format is the same byte for
byte, so a checkpoint written by either package loads in the other).

* ``TrainingCheckpoint``: the merge list so far, the vocab cursor and a
  fingerprint of the corpus stream, as JSON. Training is deterministic, so
  the merge list is the whole training state: the symbol stream is rebuilt
  by replaying the merges.
* ``replay_merges``: the replay on the trainer's device, one launch of the
  probe-less merge kernel (``kernels.merge_compact``) per merge. The merge
  rows live in a device tensor whose elements are the launches' ``pair``
  and ``new_id``, and each launch's live count is the previous one's
  device ``n_new``, so the host reads nothing until the end.
* ``resume_stream``: checkpoint + original stream -> (state, vocab) ready
  to continue training.

Checkpoint files are a superset of the model JSON: ``BPEModel.from_json``
of one gives the partial model.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import TOKEN_MASK
from ..core.vocab import Vocab
from .ingest import SymbolStream, pad_stream
from .kernels import merge_compact
from .train_step import TrainState, init_state


@dataclass
class TrainingCheckpoint:
    merges: list[tuple[int, int, int]]
    merge_counts: list[int]
    next_token_id: int
    corpus_fingerprint: str
    target_vocab_size: int

    def to_json(self) -> str:
        vocab = Vocab()
        for a, b, _ in self.merges:
            vocab.add_merge(a, b)
        return json.dumps(
            {
                "version": 1,
                "kind": "gpu_bpe_tpu.checkpoint",
                "vocabSize": vocab.size,
                "vocab": [list(e) for e in vocab.entries],
                "merges": [list(m) for m in self.merges],
                "mergeCounts": self.merge_counts,
                "nextTokenId": self.next_token_id,
                "corpusFingerprint": self.corpus_fingerprint,
                "targetVocabSize": self.target_vocab_size,
            },
            separators=(",", ":"),
        )

    @classmethod
    def from_json(cls, text: str | bytes) -> "TrainingCheckpoint":
        obj = json.loads(text)
        return cls(
            merges=[tuple(m) for m in obj["merges"]],
            merge_counts=obj.get("mergeCounts", []),
            next_token_id=obj["nextTokenId"],
            corpus_fingerprint=obj["corpusFingerprint"],
            target_vocab_size=obj.get("targetVocabSize", 0),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "TrainingCheckpoint":
        with open(path) as f:
            return cls.from_json(f.read())


def fingerprint_stream(stream: SymbolStream) -> str:
    """32 hex characters of the SHA-256 of the live symbols and weights."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(stream.symbols[: stream.n]).tobytes())
    h.update(np.ascontiguousarray(stream.weights[: stream.n]).tobytes())
    return h.hexdigest()[:32]


def merge_rows(merges) -> np.ndarray:
    """int64 ``[M, 2]`` rows ``(a << 16 | b, new_id)`` of a merge list."""
    rows = [((a & TOKEN_MASK) << 16 | (b & TOKEN_MASK), new_id) for a, b, new_id in merges]
    return np.array(rows, dtype=np.int64).reshape(-1, 2)


def replay_merges(stream: SymbolStream, merges, next_token_id_start: int = 256,
                  device: str | torch.device = "cuda") -> TrainState:
    """Rebuild the training state on ``device`` by replaying a merge list
    over the padded stream (at its padded capacity; the trainer shrinks
    afterwards). One ``merge_compact`` per merge, enqueued back to back;
    the live count is read once, at the end."""
    dev = torch.device(device)
    padded = pad_stream(stream)
    sym = torch.from_numpy(padded.symbols.view(np.int32)).to(dev)
    w = torch.from_numpy(padded.weights).to(dev)
    n = torch.tensor(stream.n, dtype=torch.int64, device=dev)
    rows = torch.from_numpy(merge_rows(merges)).to(dev)
    for pair, new_id in zip(rows[:, 0].unbind(0), rows[:, 1].unbind(0)):
        sym, w, n = merge_compact(sym, w, n, pair, new_id)
    next_id = merges[-1][2] + 1 if merges else next_token_id_start
    return init_state(sym, w, int(n), next_id, dev)


def resume_stream(stream: SymbolStream, ckpt: TrainingCheckpoint, strict: bool = True,
                  device: str | torch.device = "cuda"):
    """Checkpoint + original corpus stream -> (TrainState, Vocab) to go on
    training on ``device``. ``strict`` checks the corpus fingerprint (a
    replay means something only on the same stream)."""
    if strict:
        fp = fingerprint_stream(stream)
        if fp != ckpt.corpus_fingerprint:
            raise ValueError(f"corpus fingerprint mismatch: checkpoint {ckpt.corpus_fingerprint}, stream {fp}")
    vocab = Vocab()
    for a, b, new_id in ckpt.merges:
        if vocab.add_merge(a, b) != new_id:
            raise ValueError("corrupt checkpoint: merge ids not contiguous")
    return replay_merges(stream, ckpt.merges, device=device), vocab
