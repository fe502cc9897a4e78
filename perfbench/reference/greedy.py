"""Plain NumPy chunked greedy longest match: the benchmark's reference for
bulk tokenize ids.

Semantics, written from the tokenizer's contract and not from the program:

* The chunk size is ``max(512, min(2048, 8 * L))`` for a vocab whose
  longest entry has ``L`` bytes. The input is cut into chunks of that size
  from its first byte, and a token never crosses a chunk's end.
* In each chunk, from its first byte, the longest vocab entry that starts
  there and ends inside the chunk is emitted and the walk moves past it; a
  byte that starts no entry is emitted as its own value and passed.
* Where two ids hold the same bytes, the larger id is emitted; empty
  entries match nothing.

``Matcher(vocab, corpus)`` finds, once, every (position, length) of a
circular corpus at which a vocab entry starts: a bit mask of lengths per
position, from exact packed keys up to 8 bytes and verified 64-bit
polynomial hashes beyond. ``encode(offset, n)`` then gives the ids of the
``n`` bytes that start at ``offset`` and wrap around the corpus's end: the
longest length that fits in the chunk is read off the mask, and the walk is
a plain loop over the emitted positions. ``chunked=False`` is the
benchmark's control for tokenize: the greedy match without chunks.
"""

from __future__ import annotations

import numpy as np

from .bpe import word_starts

DEFAULT_CHUNK = 512
MAX_CHUNK = 2048
_PACKED = 8  # lengths up to this many bytes are keyed exactly
_BASE = np.uint64(0x9E3779B97F4A7C15)


def chunk_size(vocab: list[bytes]) -> int:
    longest = max((len(v) for v in vocab), default=0)
    return max(DEFAULT_CHUNK, min(MAX_CHUNK, 8 * longest))


def _keys(windows: list[np.ndarray], length: int) -> np.ndarray:
    """Key of each row of byte columns ``windows[0..length-1]``: the bytes
    packed big-endian up to 8 bytes, a polynomial hash beyond."""
    k = np.zeros(len(windows[0]), dtype=np.uint64)
    with np.errstate(over="ignore"):
        for j in range(length):
            col = windows[j].astype(np.uint64)
            k = (k << np.uint64(8)) | col if length <= _PACKED else k * _BASE + col
    return k


class Matcher:
    def __init__(self, vocab: list[bytes], corpus: bytes):
        table: dict[bytes, int] = {}
        for i, v in enumerate(vocab):
            if v:
                table[bytes(v)] = i  # the larger id wins
        for v in table:
            if len(v) > 1 and bool(word_starts(v)[1:].any()):
                raise ValueError(f"vocab entry {v!r} spans a word boundary")
        self.chunk = chunk_size(vocab)
        self.max_len = max(len(v) for v in table)
        if self.max_len > 52:  # the highest bit is read through a float64
            raise ValueError("the reference masks lengths up to 52 bytes")
        corpus = bytes(corpus)
        self.n = len(corpus)
        self.data = np.frombuffer(corpus, dtype=np.uint8)
        # per length: sorted keys and their ids
        self.by_len = {}
        for length in sorted({len(v) for v in table}):
            ents = [v for v in table if len(v) == length]
            mat = np.frombuffer(b"".join(ents), dtype=np.uint8).reshape(len(ents), length)
            keys = _keys([mat[:, j] for j in range(length)], length)
            order = np.argsort(keys, kind="stable")
            if len(np.unique(keys)) != len(keys):
                raise ValueError(f"two vocab entries of {length} bytes share a key")
            self.by_len[length] = (keys[order], np.array([table[ents[i]] for i in order], dtype=np.int64))
        # Mask bit L-1: an entry of L bytes starts at the position. Entries
        # hold no word boundary, and the boundary rule reads two adjacent
        # bytes, so no match crosses a word of the corpus: the masks are
        # found once per distinct word and spread over its occurrences. The
        # corpus is circular, so its last word runs on into its first.
        starts = np.flatnonzero(word_starts(corpus)).tolist()
        if not starts or starts[0] != 0:
            raise ValueError("empty corpus")
        bounds = starts + [self.n]
        words = [corpus[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
        uid: dict[bytes, int] = {}
        occ = np.array([uid.setdefault(w, len(uid)) for w in words], dtype=np.int64)
        flat: list[int] = []
        base = np.zeros(len(uid), dtype=np.int64)
        for u, w in enumerate(uid):
            base[u] = len(flat)
            for i in range(len(w)):
                m = 0
                for ln in range(1, min(self.max_len, len(w) - i) + 1):
                    if w[i : i + ln] in table:
                        m |= 1 << (ln - 1)
                flat.append(m)
        lens = np.diff(np.array(bounds, dtype=np.int64))
        offs = np.arange(self.n, dtype=np.int64) - np.repeat(np.array(starts, dtype=np.int64), lens)
        self.mask = np.array(flat, dtype=np.uint64)[np.repeat(base[occ], lens) + offs]
        # a word cut by the corpus's end goes on in the first word
        if not word_starts(corpus[-1:] + corpus[:1])[1]:
            head = words[-1] + words[0]
            for i in range(len(words[-1])):
                m = 0
                for ln in range(1, min(self.max_len, len(head) - i) + 1):
                    if head[i : i + ln] in table:
                        m |= 1 << (ln - 1)
                self.mask[starts[-1] + i] = m

    def encode(self, offset: int, n: int, chunked: bool = True) -> np.ndarray:
        """Ids (uint32) of the ``n`` circular corpus bytes from ``offset``."""
        idx = (offset + np.arange(n, dtype=np.int64)) % self.n
        q = np.arange(n, dtype=np.int64)
        room = n - q
        if chunked:
            room = np.minimum(room, self.chunk - q % self.chunk)
        room = np.minimum(room, self.max_len)
        fits = self.mask[idx] & ((np.uint64(1) << room.astype(np.uint64)) - np.uint64(1))
        _, exp = np.frexp(fits.astype(np.float64))  # highest set bit + 1
        length = np.maximum(exp, 1).astype(np.int64)
        hit = fits != 0
        step = length.tolist()
        starts = []
        chunk = self.chunk if chunked else max(n, 1)
        for c0 in range(0, n, chunk):
            p, end = c0, min(c0 + chunk, n)
            while p < end:
                starts.append(p)
                p += step[p]
        starts = np.array(starts, dtype=np.int64)
        out = self.data[idx[starts]].astype(np.int64)  # the raw-byte fallback
        lens = np.where(hit[starts], length[starts], 0)
        for ln, (keys, ids) in self.by_len.items():
            sel = np.flatnonzero(lens == ln)
            if not len(sel):
                continue
            p = idx[starts[sel]]
            cols = [self.data[(p + j) % self.n] for j in range(ln)]
            out[sel] = ids[np.searchsorted(keys, _keys(cols, ln))]
        return out.astype(np.uint32)
