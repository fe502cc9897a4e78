"""Model import/export: merge-list JSON and the tokenized-corpus .bin (DXFT)
(the port's own copy of ``gpu_bpe_tpu/core/model_io.py``, wire formats
unchanged):

* model JSON ``{version: 1, vocabSize, vocab: byte[][], merges: [[a,b,newId]]}``;
* tokenized corpus ``.bin`` v2: u32 header [magic 'DXFT', vocabSize,
  tokenCount, vocabBytesLen] + u32 tokens + the embedded model JSON bytes.

``BPEModel.from_json`` also takes a Hugging Face byte-level BPE
``tokenizer.json`` (detected by its ``model`` object; ``core/hf_io.py``).
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass

import numpy as np

from ..constants import DXFT_MAGIC
from .vocab import Vocab


@dataclass
class BPEModel:
    """A trained BPE model: vocabulary byte sequences + ordered merges."""

    vocab: list[bytes]
    merges: list[tuple[int, int, int]]

    def __post_init__(self) -> None:
        self.vocab = [bytes(v) for v in self.vocab]
        self.merges = [tuple(m) for m in self.merges]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def byte_ids(self) -> list[int] | None:
        """byte -> token id for the 256 initial byte tokens, or None when the
        layout is canonical (ids 0-255 are the bytes themselves, as trained
        models always are); missing bytes map to -1."""
        cached = getattr(self, "_byte_ids", False)
        if cached is not False:
            return cached
        canonical = len(self.vocab) >= 256 and all(self.vocab[b] == bytes([b]) for b in range(256))
        if canonical:
            ids = None
        else:
            ids = [-1] * 256
            for tid, entry in enumerate(self.vocab):
                if len(entry) == 1 and ids[entry[0]] < 0:
                    ids[entry[0]] = tid
        self._byte_ids = ids
        return ids

    def to_json_obj(self) -> dict:
        return {
            "version": 1,
            "vocabSize": self.vocab_size,
            "vocab": [list(v) for v in self.vocab],
            "merges": [list(m) for m in self.merges],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_json_obj(), separators=(",", ":"))

    @classmethod
    def from_json_obj(cls, obj: dict) -> "BPEModel":
        from .hf_io import looks_like_hf_json, model_from_hf_obj

        if looks_like_hf_json(obj):  # a Hugging Face tokenizer.json
            return model_from_hf_obj(obj)[0]
        if "vocab" not in obj or "merges" not in obj:
            raise ValueError("Invalid vocabulary file: missing vocab or merges")
        return cls(vocab=[bytes(v) for v in obj["vocab"]], merges=[tuple(m) for m in obj["merges"]])

    @classmethod
    def from_json(cls, text: str | bytes) -> "BPEModel":
        return cls.from_json_obj(json.loads(text))

    @classmethod
    def from_vocab_obj(cls, vocab: Vocab, merges: list[tuple[int, int, int]]) -> "BPEModel":
        """A model of a ``Vocab``'s entries and the merges that made them."""
        return cls(vocab=list(vocab.entries), merges=merges)

    def to_vocab(self) -> Vocab:
        return Vocab.from_entries(self.vocab)

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "BPEModel":
        with open(path, "rb") as f:
            return cls.from_json(f.read())


def write_dxft(tokens: np.ndarray, model: BPEModel | None) -> bytes:
    """Serialize tokens (+ the embedded model JSON) to the .bin v2 format."""
    tokens = np.asarray(tokens, dtype="<u4")
    vocab_bytes = model.to_json().encode("utf-8") if model is not None else b""
    vocab_size = model.vocab_size if model is not None else 256
    header = struct.pack("<4I", DXFT_MAGIC, vocab_size, len(tokens), len(vocab_bytes))
    return header + tokens.tobytes() + vocab_bytes


def read_dxft(data: bytes) -> tuple[np.ndarray, BPEModel | None, dict]:
    """Parse a .bin v2 file -> (tokens, embedded model or None, header dict)."""
    if len(data) < 16:
        raise ValueError("Truncated DXFT file")
    magic, vocab_size, token_count, vocab_bytes_len = struct.unpack("<4I", data[:16])
    if magic != DXFT_MAGIC:
        raise ValueError(f"Invalid DXFT magic: 0x{magic:x}")
    tokens_end = 16 + token_count * 4
    if len(data) < tokens_end + vocab_bytes_len:
        raise ValueError("Truncated DXFT file")
    tokens = np.frombuffer(data[16:tokens_end], dtype="<u4").astype(np.uint32)
    model = None
    if vocab_bytes_len:
        model = BPEModel.from_json(data[tokens_end : tokens_end + vocab_bytes_len])
    return tokens, model, {"vocabSize": vocab_size, "tokenCount": token_count}
