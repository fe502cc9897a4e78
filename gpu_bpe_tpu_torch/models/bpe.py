"""BPETokenizer: a trained model with its encode, decode and export paths
(the port's counterpart of ``gpu_bpe_tpu/models/bpe.py``):

* ``encode(text)``: merge-priority-order BPE (exact reference semantics);
* ``encode_bytes_greedy(data)``: bulk chunked greedy longest match, on the
  card through ``Tokenizer`` (``backend="cuda"``) or on the host through
  ``GreedyTrieEncoder`` (``backend="cpu"``);
* ``decode(tokens)``: byte concatenation with U+FFFD for unknown ids;
* ``compile_trie()``: the v3 binary trie;
* ``export_bin(data)``: tokenize + the DXFT .bin container;
* ``export_hf_json()``: a Hugging Face ``tokenizer.json``;
* ``save`` / ``load``: the merge-list JSON (``load`` also reads a Hugging
  Face ``tokenizer.json``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.encoder_ref import GreedyTrieEncoder, decode_tokens, encode_merge_order
from ..core.model_io import BPEModel, write_dxft
from ..trie.compile import compile_vocab_to_trie

BACKENDS = ("cuda", "cpu")


class BPETokenizer:
    """``backend="cuda"`` tokenizes in bulk with the port's ``Tokenizer`` on
    ``device`` (the card unless ``device="cpu"``, which runs the same code
    through the kernels' plain versions); ``backend="cpu"`` with
    ``GreedyTrieEncoder``."""

    def __init__(self, model: BPEModel, backend: str = "cuda", chunk_size: int | None = None,
                 device: str | torch.device = "cuda"):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.model = model
        self.backend = backend
        self.chunk_size = chunk_size
        self.device = device
        self._greedy = None

    @classmethod
    def from_json(cls, text: str | bytes, **kw) -> "BPETokenizer":
        return cls(BPEModel.from_json(text), **kw)

    @classmethod
    def load(cls, path: str, **kw) -> "BPETokenizer":
        return cls(BPEModel.load(path), **kw)

    @classmethod
    def from_training_result(cls, result, **kw) -> "BPETokenizer":
        return cls(BPEModel(vocab=result.vocab, merges=result.merges), **kw)

    @property
    def vocab_size(self) -> int:
        return self.model.vocab_size

    def encode(self, text: str) -> list[int]:
        """Merge-priority-order BPE over the text's UTF-8 bytes."""
        return encode_merge_order(text.encode("utf-8"), self.model.merges, byte_ids=self.model.byte_ids)

    def encode_bytes_greedy(self, data: bytes) -> np.ndarray:
        """Bulk chunked greedy longest match: uint32 token ids."""
        if self._greedy is None:
            if self.backend == "cuda":
                from ..ops.tokenize import Tokenizer

                tok = Tokenizer(self.model.vocab, chunk_size=self.chunk_size, device=self.device)
                self._greedy = tok.encode_bytes
            else:
                self._greedy = GreedyTrieEncoder(self.model.vocab, chunk_size=self.chunk_size).encode
        return self._greedy(data)

    def decode(self, tokens) -> bytes:
        return decode_tokens(tokens, self.model.vocab)

    def decode_text(self, tokens) -> str:
        return self.decode(tokens).decode("utf-8", errors="replace")

    def compression_ratio(self, data: bytes, tokens) -> float:
        """Bytes per token of ``data`` tokenized as ``tokens`` (0.0 for no
        tokens)."""
        n = len(tokens)
        return len(data) / n if n else 0.0

    def compile_trie(self) -> bytes:
        return compile_vocab_to_trie(self.model.vocab)

    def export_bin(self, data: bytes) -> bytes:
        """Tokenize ``data`` and wrap the ids in the DXFT .bin v2 container."""
        return write_dxft(self.encode_bytes_greedy(data), self.model)

    def export_vocab_text(self) -> str:
        return self.model.to_vocab().export_text()

    def export_hf_json(self, pretok: str = "none") -> str:
        """Hugging Face ``tokenizer.json`` (byte-level BPE; ``core/hf_io.py``)."""
        from ..core.hf_io import model_to_hf_json

        return model_to_hf_json(self.model, pretok=pretok)

    def save(self, path: str) -> None:
        self.model.save(path)
