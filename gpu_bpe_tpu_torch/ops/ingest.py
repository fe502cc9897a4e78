"""Corpus ingestion: symbol streams, padding, and unique-word deduplication.

The trainer operates on a flat u32 symbol stream with word-start flags plus a
per-position weight array enabling the *deduplicated word multiset*
formulation: because merges never cross word boundaries and act on each word
instance identically, global pair counts equal
``Σ_unique_words freq(w) · in-word counts``. Deduplication makes per-merge
cost proportional to unique-word mass instead of corpus size.

The port's copy of ``gpu_bpe_tpu.ops.ingest``. The dedup runs in the native
C++ library (``ops/native.py``) where it builds, else in numpy
(``numpy_dedup``, ``StreamAccumulator``'s per-length sets); both give the
same stream bit for bit. ``stream_paths`` and ``make_stream_chunked`` ingest
files chunk by chunk with host memory bounded by the unique-word mass plus
two chunks (``api.train_files``).

The streamed ingest is traced: ``make_stream_chunked`` is a
``train.ingest`` span (``bytes``, ``chunks``, ``symbols``) holding one
``train.pretokenize`` span (``bytes``) per chunk and one ``train.dedup``
span per ``StreamAccumulator.add_chunk`` (``bytes``) and ``finish``
(``symbols``); the rest of ``train.ingest`` is reading the files and
carrying the partial word. ``INGEST`` counts what it ingested.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import numpy as np

from ..constants import TOKEN_MASK, WORD_START_BIT
from ..utils.timing import span
from . import native

# The streamed ingest's work (``make_stream_chunked``): "chunks" read,
# "bytes" of corpus (the streams' ``total_bytes``) and unique-word
# "symbols" (the streams' ``n``). clear() to reset.
INGEST: Counter = Counter()


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

    nat = native.native_dedup(bytes_arr, starts, WORD_START_BIT)
    if nat is not None:
        syms, wts, total_unique = nat
        return SymbolStream(symbols=syms, weights=wts, n=total_unique, total_bytes=n_total)
    return numpy_dedup(bytes_arr, starts)


def numpy_dedup(bytes_arr: np.ndarray, starts: np.ndarray) -> SymbolStream:
    """The numpy dedup of ``make_stream``: ``bytes_arr`` u8 with the bool
    word-start mask ``starts`` (``starts[0]`` set). Bitwise equal to the
    native path."""
    n_total = len(bytes_arr)
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


class StreamAccumulator:
    """Incremental unique-word accumulator for streamed ingestion.

    Host memory is bounded by the unique-word mass (plus one chunk), not
    the corpus size. Words arrive chunk by chunk as (pre-tokenized bytes,
    word-start mask); each chunk's first position starts a word. With the
    native library the C++ hash table and arena persist across chunks;
    without it each chunk is deduplicated per length as in ``make_stream``
    and merged into running per-length unique sets with summed counts.
    ``finish()`` gives the stream ``make_stream`` would give on the
    concatenated input (same (length asc, bytes asc) order)."""

    def __init__(self):
        self._rows: dict[int, np.ndarray] = {}  # ln -> [k, ln] uint8
        self._counts: dict[int, np.ndarray] = {}  # ln -> [k] int64
        self._total = 0
        self._native = native.NativeAccumulator() if native.native_available() else None

    def add_chunk(self, data: bytes | np.ndarray, word_starts: np.ndarray) -> None:
        with span("train.dedup") as sp:
            sp.note(bytes=len(data))
            self._add(data, word_starts)

    def _add(self, data: bytes | np.ndarray, word_starts: np.ndarray) -> None:
        if isinstance(data, (bytes, bytearray)):
            bytes_arr = np.frombuffer(bytes(data), dtype=np.uint8)
        else:
            bytes_arr = np.asarray(data, dtype=np.uint8)
        n = len(bytes_arr)
        if n == 0:
            return
        self._total += n
        if self._native is not None:
            # (mask != 0), not astype(uint8): an int mask value that is a
            # multiple of 256 must stay a word start, as on the numpy path
            starts = (np.asarray(word_starts) != 0).astype(np.uint8)
            starts[0] = 1
            self._native.add_chunk(bytes_arr, starts)
            return
        starts = word_starts.astype(bool).copy()
        starts[0] = True
        boundaries = np.flatnonzero(starts)
        ends = np.append(boundaries[1:], n)
        lengths = ends - boundaries
        for ln in np.unique(lengths):
            ln = int(ln)
            sel = boundaries[lengths == ln]
            mat = bytes_arr[sel[:, None] + np.arange(ln)[None, :]]
            uniq, cnt = _unique_rows(mat)
            if ln not in self._rows:
                self._rows[ln], self._counts[ln] = uniq, cnt
            else:
                merged = np.concatenate([self._rows[ln], uniq])
                mcnt = np.concatenate([self._counts[ln], cnt])
                self._rows[ln], self._counts[ln] = _unique_rows(merged, weights=mcnt)

    def finish(self) -> SymbolStream:
        with span("train.dedup") as sp:
            stream = self._finish()
            sp.note(symbols=stream.n)
        return stream

    def _finish(self) -> SymbolStream:
        if self._native is not None:
            syms, wts, total_unique = self._native.finish(WORD_START_BIT)
            return SymbolStream(symbols=syms, weights=wts, n=total_unique, total_bytes=self._total)
        out_syms, out_wts = [], []
        total_unique = 0
        for ln in sorted(self._rows):
            uniq, cnt = self._rows[ln], self._counts[ln]
            assert cnt.max(initial=0) < 2**31, "word frequency overflows int32"
            sym = uniq.astype(np.uint32)
            sym[:, 0] |= np.uint32(WORD_START_BIT)
            out_syms.append(sym.reshape(-1))
            out_wts.append(np.repeat(cnt.astype(np.int32), ln))
            total_unique += len(uniq) * ln
        if not out_syms:
            return SymbolStream(symbols=np.zeros(0, np.uint32), weights=np.zeros(0, np.int32), n=0,
                                total_bytes=self._total)
        return SymbolStream(symbols=np.concatenate(out_syms), weights=np.concatenate(out_wts), n=total_unique,
                            total_bytes=self._total)


def _utf8_safe_split(buf: bytes, limit: int) -> int:
    """Largest split point <= limit that does not cut a UTF-8 sequence."""
    if limit >= len(buf):
        return len(buf)
    cut = limit
    while cut > 0 and (buf[cut] & 0xC0) == 0x80:
        cut -= 1
    return cut


def stream_paths(paths: list[str], chunk_bytes: int = 64 << 20):
    """Yield raw corpus chunks of about ``chunk_bytes`` from files joined
    with \\n\\n separators (``api.build_corpus``'s corpus), split at UTF-8
    boundaries.

    A chunk is cut only once the byte after it has been read, so no cut
    falls inside a UTF-8 sequence. A chunk that ended inside one would fail
    strict decoding and take the pre-tokenizer's raw-bytes path, which skips
    NFC for the whole chunk and so changes the stream of text that NFC
    changes (decomposed accents, conjoining jamo). The JAX package's
    ``stream_paths`` yields a buffer of exactly ``chunk_bytes`` as it is."""
    first = True
    pending = b""
    for path in paths:
        if not first:
            pending += b"\n\n"
        first = False
        with open(path, "rb") as f:
            while True:
                block = f.read(chunk_bytes)
                if not block:
                    break
                pending += block
                while len(pending) > chunk_bytes:
                    cut = _utf8_safe_split(pending, chunk_bytes)
                    if cut == 0:
                        break  # no UTF-8 boundary in the chunk: let it grow
                    yield pending[:cut]
                    pending = pending[cut:]
    if pending:
        yield pending


# Boundary decisions near a chunk's end are provisional: the rules look
# ahead up to 3 codepoints (contractions), so a boundary within the last
# MARGIN bytes could flip once more text arrives. Words that start before
# the margin are final.
MARGIN = 16


def make_stream_chunked(chunks, pre_tokenizer=None) -> SymbolStream:
    """Streamed equivalent of pre-tokenize + ``make_stream(dedup=True)``.

    Each raw chunk is pre-tokenized with the trailing partial word carried
    into the next chunk, so word boundaries are computed with full context:
    the carry restarts at the last final word start, NFC is idempotent on
    the re-fed normalized carry, and the boundary rules never look left of
    a word start. The last chunk has no text after it, so all its words are
    final. Host memory stays bounded by the unique-word mass plus two
    chunks (the one pre-tokenized and the next, read to tell the last)."""
    from ..pretok import PreTokenizer

    pt = pre_tokenizer or PreTokenizer()
    acc = StreamAccumulator()
    carry = b""
    n_chunks = 0
    with span("train.ingest") as ingest:
        chunks = iter(chunks)
        raw = next(chunks, None)
        while raw is not None:
            after = next(chunks, None)
            n_chunks += 1
            with span("train.pretokenize") as sp:
                sp.note(bytes=len(carry) + len(raw))
                data, starts = pt.pre_tokenize_bytes(carry + raw)
            if after is None:
                last = len(data)
            else:
                ws = np.flatnonzero(starts.astype(bool))
                ws = ws[ws < len(data) - MARGIN]
                last = int(ws[-1]) if len(ws) else 0
                carry = bytes(data[last:])
            if last > 0:
                acc.add_chunk(data[:last], starts[:last])
            raw = after
        stream = acc.finish()
        ingest.note(bytes=stream.total_bytes, chunks=n_chunks, symbols=stream.n)
    INGEST.update(chunks=n_chunks, bytes=stream.total_bytes, symbols=stream.n)
    return stream


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
