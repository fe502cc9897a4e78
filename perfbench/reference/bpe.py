"""Plain Python BPE training: the benchmark's reference for the merge list.

It is written from the training semantics, not from the program:

* Words. A corpus of ASCII letters, spaces and newlines is cut into words
  at position 0, at a space that follows a non-space, and on both sides of
  every newline; a letter after a space continues the space's word. On this
  alphabet the Unicode pre-tokenizer and the byte heuristic cut alike.
  Other bytes are refused, because the two rules part on them.
* Pairs. Every adjacent pair inside a word counts, with the word's
  multiplicity, overlapping pairs too ("aaa" holds (a, a) twice); a pair
  with token 0 never counts.
* Winner. The highest count; ties go to the smaller packed id
  ``(a << 16) | b``. Training stops early when the best count is below 2 or
  the next id would pass 0xFFFF.
* Merge. Sites are found on the word as it stood before the merge, and the
  token after every site is removed, so a run of overlapping sites
  collapses into one new token ("aaa" under (a, a) becomes one token).
* Vocab. Ids 0-255 are the single bytes; merge k makes id 256 + k, whose
  bytes are its two tokens' bytes.

``train_words(words, merges, ...)`` runs on a {word bytes: count} mapping
with a heap of (-count, packed pair) and per-pair word sets, both brought
up to date lazily. ``break_ties`` exists for the benchmark's control
(``perfbench/control.py``); the reference itself never sets it.
"""

from __future__ import annotations

import heapq
from collections import Counter
from dataclasses import dataclass

import numpy as np

_LETTERS = np.zeros(256, dtype=bool)
_LETTERS[ord("a") : ord("z") + 1] = True
_LETTERS[ord("A") : ord("Z") + 1] = True
_SPACE, _NEWLINE = 0x20, 0x0A
MAX_ID = 0xFFFF


@dataclass
class RefTraining:
    merges: list[tuple[int, int, int]]
    merge_counts: list[int]
    vocab: list[bytes]


def word_starts(data: bytes) -> np.ndarray:
    """Boolean mask of word starts of an ASCII letters/space/newline text."""
    b = np.frombuffer(bytes(data), dtype=np.uint8)
    allowed = _LETTERS[b] | (b == _SPACE) | (b == _NEWLINE)
    if not bool(allowed.all()):
        bad = sorted(set(b[~allowed].tolist()))[:8]
        raise ValueError(f"the reference cuts words of ASCII letters, spaces and newlines only; found bytes {bad}")
    starts = np.zeros(len(b), dtype=bool)
    if len(b) == 0:
        return starts
    starts[0] = True
    prev, cur = b[:-1], b[1:]
    starts[1:] = ((cur == _NEWLINE) | (prev == _NEWLINE)
                  | ((cur == _SPACE) & (prev != _SPACE)))
    return starts


def word_counts(data: bytes) -> Counter:
    """{word bytes: occurrences}."""
    data = bytes(data)
    idx = np.flatnonzero(word_starts(data)).tolist()
    idx.append(len(data))
    return Counter(data[s:e] for s, e in zip(idx[:-1], idx[1:]))


def _pairs(tokens: list[int]):
    for a, b in zip(tokens, tokens[1:]):
        if a and b:
            yield a, b


def _merged(tokens: list[int], a: int, b: int, new_id: int) -> list[int]:
    """The merge's overlap rule: sites on the old word, the token after each
    site removed."""
    n = len(tokens)
    site = [tokens[i] == a and tokens[i + 1] == b for i in range(n - 1)] + [False]
    out = []
    for i in range(n):
        if i and site[i - 1]:
            continue
        out.append(new_id if site[i] else tokens[i])
    return out


def train_words(words: Counter, n_merges: int, break_ties: bool = False) -> RefTraining:
    """BPE over a word multiset, ``n_merges`` merges at most. ``break_ties``
    (a control) sends ties to the larger packed pair id."""
    toks = [list(w) for w in words]
    mult = list(words.values())
    counts: dict[tuple[int, int], int] = {}
    where: dict[tuple[int, int], set[int]] = {}
    for wi, t in enumerate(toks):
        m = mult[wi]
        for p in _pairs(t):
            counts[p] = counts.get(p, 0) + m
            where.setdefault(p, set()).add(wi)
    sign = -1 if break_ties else 1

    def key(p, c):
        return (-c, sign * ((p[0] << 16) | p[1]))

    heap = [key(p, c) + (p,) for p, c in counts.items()]
    heapq.heapify(heap)
    vocab = [bytes([i]) for i in range(256)]
    merges: list[tuple[int, int, int]] = []
    merge_counts: list[int] = []
    while len(merges) < n_merges and heap:
        neg, _, p = heapq.heappop(heap)
        c = counts.get(p, 0)
        if c != -neg:
            continue  # stale entry
        new_id = len(vocab)
        if c < 2 or new_id > MAX_ID:
            break
        a, b = p
        merges.append((a, b, new_id))
        merge_counts.append(c)
        vocab.append(vocab[a] + vocab[b])
        touched: dict[tuple[int, int], int] = {}
        for wi in where.pop(p, ()):
            old = toks[wi]
            if not any(x == a and y == b for x, y in zip(old, old[1:])):
                continue  # the word lost the pair to an earlier merge
            new = _merged(old, a, b, new_id)
            m = mult[wi]
            for q in _pairs(old):
                touched[q] = touched.get(q, 0) - m
            for q in _pairs(new):
                touched[q] = touched.get(q, 0) + m
                where.setdefault(q, set()).add(wi)
            toks[wi] = new
        counts.pop(p, None)
        for q, d in touched.items():
            if q == p or not d:
                continue
            c2 = counts.get(q, 0) + d
            if c2:
                counts[q] = c2
                heapq.heappush(heap, key(q, c2) + (q,))
            else:
                counts.pop(q, None)
    return RefTraining(merges=merges, merge_counts=merge_counts, vocab=vocab)


def train(data: bytes, vocab_size: int, break_ties: bool = False) -> RefTraining:
    """The merge list, merge counts and vocab of ``vocab_size`` entries (or
    fewer, on an early stop) learned from ``data``."""
    return train_words(word_counts(data), max(vocab_size - 256, 0), break_ties)
