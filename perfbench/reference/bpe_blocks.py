"""Word counts of a corpus too large to count in one piece, for the plain
reference trainer (``bpe.py``): the corpus is cut into blocks that end just
past a newline, each block's words are counted on its own, and the counts
are summed.

A newline is a word of its own and the byte after it starts a word
(``bpe.py``'s rules), so no block boundary cuts a word, and the blocks'
counts sum to ``bpe.word_counts`` of the whole text. Inside a block the
words are matched left to right as ``" *[^ \\n]+"`` (spaces, then every byte
up to the next space or newline), ``" +"`` (spaces before a newline or the
end) or ``"\\n"``: the cuts of ``bpe.word_starts``, at position 0, at a space
after a non-space and on both sides of a newline. Like it, the count
refuses any byte but ASCII letters, spaces and newlines.

The blocks are counted in ``workers`` spawned processes, one block at a
time each (``workers=1``: in this process), so 1 GiB takes seconds where
``bpe.word_counts`` would hold some 150M word starts as Python ints at once.
"""

from __future__ import annotations

import os
import re
from collections import Counter
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

BLOCK_BYTES = 64 << 20
_WORD = re.compile(rb" *[^ \n]+| +|\n")
_ALLOWED = bytes(range(ord("a"), ord("z") + 1)) + bytes(range(ord("A"), ord("Z") + 1)) + b" \n"


def blocks(data: bytes, block_bytes: int = BLOCK_BYTES) -> list[tuple[int, int]]:
    """``(start, end)`` of each block: about ``block_bytes`` each, every one
    but the last ending just past a newline (a block with no newline runs on
    to the next one)."""
    out, start, n = [], 0, len(data)
    while start < n:
        end = min(start + block_bytes, n)
        if end < n:
            nl = data.rfind(b"\n", start, end)
            if nl < 0:
                nl = data.find(b"\n", end)
            end = n if nl < 0 else nl + 1
        out.append((start, end))
        start = end
    return out


def count_block(block: bytes) -> Counter:
    """{word bytes: occurrences} of one block."""
    bad = block.translate(None, _ALLOWED)
    if bad:
        raise ValueError(f"the reference cuts words of ASCII letters, spaces and newlines only; "
                         f"found bytes {sorted(set(bad))[:8]}")
    return Counter(_WORD.findall(block))


def word_counts(data: bytes, block_bytes: int = BLOCK_BYTES, workers: int | None = None) -> Counter:
    """{word bytes: occurrences} of ``data``, counted block by block in
    ``workers`` processes (default: one per CPU, at most one per block)."""
    cuts = blocks(data, block_bytes)
    workers = min(len(cuts), workers or os.cpu_count() or 1)
    total: Counter = Counter()
    if workers <= 1:
        for s, e in cuts:
            total.update(count_block(data[s:e]))
        return total
    with ProcessPoolExecutor(workers, mp_context=get_context("spawn")) as pool:
        for counts in pool.map(count_block, (data[s:e] for s, e in cuts)):
            total.update(counts)
    return total
