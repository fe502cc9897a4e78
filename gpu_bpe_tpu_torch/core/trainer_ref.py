"""The CPU oracle trainer, the result schema and the symbol helpers (the
port's own copy of ``gpu_bpe_tpu/core/trainer_ref.py``).

``ReferenceTrainer`` is a numpy implementation of the exact training
semantics, the ``backend="cpu"`` path of ``api.train``:

* pair counting: pair ``(s[i], s[i+1])`` counts unless the second symbol
  carries the word-start flag or either token id is 0 (NUL never merges);
* winner: highest count, ties to the smaller packed pair id ``(a << 16) | b``;
* early stop when the best count is < 2 or the next id would pass 0xFFFF;
* merge: sites and removals are both read from the ORIGINAL array, so
  overlapping occurrences collapse ("aaa" under (a,a) -> Z becomes "Z").
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..constants import MAX_VOCAB, TOKEN_MASK, WORD_START_BIT
from .vocab import Vocab

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
    # dual/multi-merge fires over the run (second and third merges of the
    # multi-merge iteration and of the data-parallel loop; 0 in the
    # default single-chip loop)
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


def count_pairs(symbols: np.ndarray, weights: np.ndarray | None = None):
    """Exact pair counts over a symbol stream.

    Returns ``(pair_ids, counts)`` over distinct pairs, sorted by pair id.
    ``weights`` (optional, per-symbol-position weight for the pair starting at
    that position) supports the deduplicated word-multiset formulation.
    """
    if len(symbols) < 2:
        return np.empty(0, np.uint32), np.empty(0, np.int64)
    a_raw = symbols[:-1]
    b_raw = symbols[1:]
    mask = (b_raw & WORD_START_BIT) == 0
    a = a_raw & TOKEN_MASK
    b = b_raw & TOKEN_MASK
    mask &= (a != 0) & (b != 0)
    pairs = ((a << np.uint32(16)) | b)[mask]
    if weights is None:
        uniq, counts = np.unique(pairs, return_counts=True)
        return uniq, counts.astype(np.int64)
    w = weights[:-1][mask]
    uniq, inverse = np.unique(pairs, return_inverse=True)
    sums = np.zeros(len(uniq), np.int64)
    np.add.at(sums, inverse, w)
    return uniq, sums


def best_pair(pair_ids: np.ndarray, counts: np.ndarray) -> tuple[int, int]:
    """Deterministic winner: max count, ties → smallest pair id.

    Returns ``(pair_id, count)``; ``(0, 0)`` when there are no pairs.
    """
    if len(pair_ids) == 0:
        return 0, 0
    max_count = int(counts.max())
    winner = int(pair_ids[counts == max_count].min())
    return winner, max_count


def merge_sites(symbols: np.ndarray, a: int, b: int) -> np.ndarray:
    """Boolean mask of A-side merge sites, computed from the original array."""
    n = len(symbols)
    tok = symbols & TOKEN_MASK
    ws = symbols & WORD_START_BIT
    sites = np.zeros(n, dtype=bool)
    if n >= 2:
        sites[:-1] = (tok[:-1] == a) & (tok[1:] == b) & (ws[1:] == 0)
    return sites


def apply_merge(symbols: np.ndarray, a: int, b: int, new_symbol: int) -> np.ndarray:
    """One merge step with the reference's exact overlap semantics."""
    sites = merge_sites(symbols, a, b)
    ws = symbols & WORD_START_BIT
    out = np.where(sites, np.uint32(new_symbol) | ws, symbols)
    removed = np.zeros(len(symbols), dtype=bool)
    removed[1:] = sites[:-1]
    return out[~removed]


class ReferenceTrainer:
    """Naive-but-exact CPU BPE trainer (the oracle).

    Takes a pre-tagged symbol array, a target vocab size and an optional
    progress callback with the reference's progress schema.
    """

    def __init__(self, vocab: Vocab | None = None):
        self.vocab = vocab or Vocab()

    def train(
        self,
        symbols: np.ndarray,
        target_vocab_size: int = 4096,
        on_progress: ProgressFn | None = None,
        progress_every: int = 128,
    ) -> TrainingResult:
        if len(symbols) == 0:
            raise ValueError("No symbols to train on — corpus is empty after pre-processing")
        symbols = np.asarray(symbols, dtype=np.uint32)

        start = time.perf_counter()
        merges: list[tuple[int, int, int]] = []
        merge_counts: list[int] = []
        merges_needed = target_vocab_size - self.vocab.size

        for i in range(max(merges_needed, 0)):
            pair_ids, counts = count_pairs(symbols)
            pair, count = best_pair(pair_ids, counts)
            if count < 2 or self.vocab.next_token_id > TOKEN_MASK:
                break
            a, b = pair >> 16, pair & TOKEN_MASK
            new_id = self.vocab.add_merge(a, b)
            merges.append((a, b, new_id))
            merge_counts.append(count)
            symbols = apply_merge(symbols, a, b, new_id)

            if on_progress and ((i + 1) % progress_every == 0 or i + 1 == merges_needed):
                elapsed = time.perf_counter() - start
                on_progress(
                    {
                        "mergeIndex": i + 1,
                        "totalMerges": merges_needed,
                        "mergeString": self.vocab.strings[-1],
                        "bestCount": count,
                        "symbolCount": int(len(symbols)),
                        "mergesPerSecond": (i + 1) / max(elapsed, 1e-9),
                    }
                )

        elapsed = time.perf_counter() - start
        assert self.vocab.next_token_id <= MAX_VOCAB
        return TrainingResult(
            vocab=list(self.vocab.entries),
            vocab_strings=list(self.vocab.strings),
            vocab_size=self.vocab.size,
            merges=merges,
            merge_counts=merge_counts,
            training_time_s=elapsed,
        )
