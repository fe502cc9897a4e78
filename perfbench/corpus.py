"""The benchmark's corpus: a frozen copy of ``synth_corpus`` from the
repository's headline bench (80-byte ASCII lines of syllable words over a
120,000-word vocabulary drawn Zipf(1.05)), copied, not imported, so that
the yardstick cannot move with the program (a test holds the copy equal to
the original), and ``seeded_corpus``, the run's corpus drawn from its seed.

The seed draws the bytes but not the amount of work: it relabels the 26
lowercase letters by a permutation and orders the lines, on the one text
``synth_corpus(n, 0)``. Every seed so has the same number of words of each
length, the same word frequencies and the same pair counts up to the
relabeling, so the same number of merges, symbols and tokens; but the
pair ids differ, count ties fall to other pairs, and the merge list, the
vocab and the ids all differ from seed to seed. Each line keeps its
newline (the last, cut short, stays last), and words never cross a newline.
"""

from __future__ import annotations

import numpy as np


def synth_corpus(n_bytes: int, seed: int = 0, vocab_size: int = 120_000) -> bytes:
    """Deterministic Zipfian text over a large synthetic word vocabulary
    (syllable compositions, Zipf rank-frequency sampling)."""
    rng = np.random.default_rng(seed)
    syllables = np.array(
        [a + b for a in "btkdsmnlrpfgvz" for b in ("a", "e", "i", "o", "u", "ar", "en", "il", "on", "ust")]
        + ["tion", "ing", "er", "ed", "ly", "pre", "con", "anti", "ment", "ness"],
        dtype=object,
    )
    n_syll = rng.integers(1, 5, size=vocab_size)
    words = []
    for k in n_syll:
        idx = rng.integers(0, len(syllables), size=k)
        words.append("".join(syllables[i] for i in idx))
    words = np.array(words, dtype=object)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = ranks**-1.05
    probs /= probs.sum()
    parts = []
    size = 0
    while size < n_bytes:
        idx = rng.choice(vocab_size, size=65536, p=probs)
        text = " ".join(words[i] for i in idx)
        lines = [text[i : i + 80] for i in range(0, len(text), 80)]
        blob = ("\n".join(lines) + "\n").encode()
        parts.append(blob)
        size += len(blob)
    return b"".join(parts)[:n_bytes]


def seeded_corpus(n_bytes: int, seed: int, vocab_size: int = 120_000) -> bytes:
    """``synth_corpus(n_bytes, 0, vocab_size)`` with its lowercase letters
    relabeled by a permutation drawn from ``seed`` and its lines in an order
    drawn from it."""
    text = synth_corpus(n_bytes, 0, vocab_size)
    table = bytearray(range(256))
    table[ord("a") : ord("z") + 1] = bytes(ord("a") + int(i) for i in np.random.default_rng([seed, 3]).permutation(26))
    lines = text.translate(table).split(b"\n")
    tail = lines.pop()  # after the last newline: b"" or a line cut short
    order = np.random.default_rng([seed, 0]).permutation(len(lines))
    return b"\n".join(lines[i] for i in order) + b"\n" + tail
