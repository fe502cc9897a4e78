"""Corpus ingestion: symbol streams, padding, and unique-word deduplication.

The trainer operates on a flat u32 symbol stream with word-start flags plus a
per-position weight array enabling the *deduplicated word multiset*
formulation: because merges never cross word boundaries and act on each word
instance identically, global pair counts equal
``Σ_unique_words freq(w) · in-word counts``. Deduplication makes per-merge
cost proportional to unique-word mass instead of corpus size.

The port's copy of ``gpu_bpe_tpu.ops.ingest``: the numpy dedup path, whose
output is bitwise equal to the native C++ loader of the reference package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import TOKEN_MASK, WORD_START_BIT


@dataclass
class SymbolStream:
    """Flat training input: symbols (tok|WS) + per-position weights."""

    symbols: np.ndarray  # uint32 [N]
    weights: np.ndarray  # int32  [N] — word frequency at each position
    n: int  # valid prefix length
    total_bytes: int  # original (non-deduplicated) corpus size in symbols

    @property
    def dedup_ratio(self) -> float:
        return self.total_bytes / max(self.n, 1)


def _unique_rows(mat: np.ndarray, weights: np.ndarray | None = None):
    """``np.unique(mat, axis=0, return_counts=True)`` replacement, ~5-10x
    faster: rows are packed into big-endian u64 words (byteswapped to
    native once) so the sort compares machine words instead of void rows.
    ``weights`` sums per-row weights instead of counting occurrences.
    Returns (uniq [u, ln] u8, counts int64) with rows in ascending
    byte-lexicographic order — the order np.unique produces for
    same-length rows."""
    k, ln = mat.shape
    if k == 0:
        return mat.copy(), np.zeros(0, np.int64)
    nw = (ln + 7) // 8
    if ln == nw * 8 and mat.flags.c_contiguous:
        padded = mat
    else:
        padded = np.zeros((k, nw * 8), np.uint8)
        padded[:, :ln] = mat
    # big-endian view: numeric u64 order == byte-lexicographic row order
    words = padded.view(">u8").astype(np.uint64)  # [k, nw], native after astype
    if nw == 1 and weights is None:
        # value sort (no permutation needed): ~2x argsort, and the unique
        # rows reconstruct from the sorted words themselves
        sw0 = np.sort(words[:, 0])
        neq = np.empty(k, bool)
        neq[0] = True
        np.not_equal(sw0[1:], sw0[:-1], out=neq[1:])
        starts = np.flatnonzero(neq)
        counts = np.diff(np.append(starts, k)).astype(np.int64)
        uniq_words = sw0[starts].astype(">u8")
        uniq = uniq_words.view(np.uint8).reshape(-1, 8)[:, :ln]
        return uniq, counts
    if nw == 1:
        w0 = words[:, 0]
        order = np.argsort(w0, kind="stable")
        sw0 = w0[order]
        neq = np.empty(k, bool)
        neq[0] = True
        np.not_equal(sw0[1:], sw0[:-1], out=neq[1:])
    else:
        order = np.lexsort(tuple(words[:, j] for j in range(nw - 1, -1, -1)))
        sw = words[order]
        neq = np.empty(k, bool)
        neq[0] = True
        np.any(sw[1:] != sw[:-1], axis=1, out=neq[1:])
    starts = np.flatnonzero(neq)
    if weights is None:
        counts = np.diff(np.append(starts, k)).astype(np.int64)
    else:
        counts = np.add.reduceat(np.asarray(weights, np.int64)[order], starts)
    uniq = padded[order[starts]][:, :ln]
    return uniq, counts



def make_stream(
    data: bytes | np.ndarray,
    word_starts: np.ndarray | None,
    dedup: bool = True,
) -> SymbolStream:
    """Build a SymbolStream from pre-tokenized bytes + word-start mask.

    With ``dedup=True``, identical words collapse to one copy with a frequency
    weight (exact — see module docstring). With no mask, the stream is a
    single "word" starting at position 0 and dedup is skipped.
    """
    if isinstance(data, (bytes, bytearray)):
        bytes_arr = np.frombuffer(bytes(data), dtype=np.uint8)
        tokens = None  # u32 view made lazily (only the no-dedup path needs it)
    else:
        tokens = np.asarray(data, dtype=np.uint32) & np.uint32(TOKEN_MASK)
        bytes_arr = tokens.astype(np.uint8)
    n_total = len(bytes_arr)

    if word_starts is None or not dedup or n_total == 0:
        symbols = (bytes_arr.astype(np.uint32) if tokens is None else tokens.copy())
        if word_starts is not None:
            symbols[word_starts.astype(bool)] |= np.uint32(WORD_START_BIT)
        elif n_total:
            symbols[0] |= np.uint32(WORD_START_BIT)
        return SymbolStream(
            symbols=symbols,
            weights=np.ones(n_total, dtype=np.int32),
            n=n_total,
            total_bytes=n_total,
        )

    starts = word_starts.astype(bool).copy()
    if n_total:
        starts[0] = True  # position 0 always starts a word (rule 1)

    # Vectorized dedup: bucket words by length, dedupe each bucket with
    # np.unique over fixed-width rows (C-speed; the previous Python dict
    # loop dominated ingestion on multi-GB corpora). Deterministic output
    # order: (length asc, bytes asc).
    boundaries = np.flatnonzero(starts)
    ends = np.append(boundaries[1:], n_total)
    lengths = ends - boundaries

    # group word indices by length with ONE sort (a per-length boolean
    # scan is O(distinct_lengths x words) and showed up at 64 MB scale)
    len_order = np.argsort(lengths, kind="stable")
    sorted_lengths = lengths[len_order]
    change = np.flatnonzero(np.diff(sorted_lengths)) + 1
    group_starts = np.concatenate([[0], change]) if len(sorted_lengths) else change
    group_ends = np.append(change, len(sorted_lengths))
    uniq_lengths = sorted_lengths[group_starts] if len(sorted_lengths) else sorted_lengths

    out_syms: list[np.ndarray] = []
    out_wts: list[np.ndarray] = []
    total_unique = 0
    for ln, gs, ge in zip(uniq_lengths, group_starts, group_ends):
        ln = int(ln)
        sel = boundaries[len_order[gs:ge]]
        if ln == 0:
            continue
        # [k, ln] matrix of word bytes via strided gather
        mat = bytes_arr[sel[:, None] + np.arange(ln)[None, :]]
        uniq, cnt = _unique_rows(mat)
        assert cnt.max(initial=0) < 2**31, "word frequency overflows int32"
        k = len(uniq)
        sym = uniq.astype(np.uint32)
        sym[:, 0] |= np.uint32(WORD_START_BIT)
        out_syms.append(sym.reshape(-1))
        out_wts.append(np.repeat(cnt.astype(np.int32), ln))
        total_unique += k * ln

    if not out_syms:
        return SymbolStream(
            symbols=np.zeros(0, np.uint32), weights=np.zeros(0, np.int32),
            n=0, total_bytes=n_total,
        )
    symbols = np.concatenate(out_syms)
    weights = np.concatenate(out_wts)
    return SymbolStream(symbols=symbols, weights=weights, n=total_unique, total_bytes=n_total)


def pad_stream(stream: SymbolStream, multiple: int = 1024) -> SymbolStream:
    """Pad to a power-of-two capacity (tail symbols = 0, which never pair).

    Power-of-two capacities give the trainer its shrink ladder (every pass
    of the merge loop costs O(capacity)). The headroom keeps at least one
    zero past the stream, the same layout as the reference package.
    """
    headroom = 16
    cap = max(multiple, 2048)
    while cap < stream.n + headroom:
        cap <<= 1
    symbols = np.zeros(cap, dtype=np.uint32)
    weights = np.zeros(cap, dtype=np.int32)
    symbols[: stream.n] = stream.symbols[: stream.n]
    weights[: stream.n] = stream.weights[: stream.n]
    return SymbolStream(symbols=symbols, weights=weights, n=stream.n, total_bytes=stream.total_bytes)
