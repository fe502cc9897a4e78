"""Result schema and symbol helpers of the trainer (the part of
``gpu_bpe_tpu.core.trainer_ref`` that the port's trainer needs; the CPU
oracle ``ReferenceTrainer`` stays on the reference side as the test oracle)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..constants import WORD_START_BIT

ProgressFn = Callable[[dict], None]


@dataclass
class TrainingResult:
    """Result schema matching the reference trainer (src/bpe/trainer.js:328-334)."""

    vocab: list[bytes]
    vocab_strings: list[str]
    vocab_size: int
    merges: list[tuple[int, int, int]]  # (symbol_a, symbol_b, new_token_id)
    merge_counts: list[int] = field(default_factory=list)  # count at merge time
    training_time_s: float = 0.0
    # window-machinery diagnostics: full certificate recounts and
    # dual/multi-merge fires over the run (the port never multi-merges)
    recounts: int = 0
    duals: int = 0


def bytes_to_symbols(data: bytes) -> np.ndarray:
    """Raw bytes → u32 symbol array (no word-start flags)."""
    return np.frombuffer(bytes(data), dtype=np.uint8).astype(np.uint32)


def tag_word_boundaries(symbols: np.ndarray, word_starts: np.ndarray) -> np.ndarray:
    """OR the word-start flag into flagged positions (src/bpe/trainer.js:115-121)."""
    out = symbols.copy()
    out[word_starts.astype(bool)] |= WORD_START_BIT
    return out
