"""GPT-4-style word boundary detection over codepoints (the port's own copy
of ``gpu_bpe_tpu/pretok/boundaries.py``).

A vectorized form of the reference rule engine ``findWordBoundaries``, in
priority order:

1. position 0 always starts a word
2. newlines force boundaries on both sides
3. whitespace after non-whitespace starts a new word (space-prefix model);
   consecutive whitespace stays in the same word
4. non-whitespace after whitespace CONTINUES the space-prefixed word
5. English contractions ('s 't 'm 'd 're 've 'll, ASCII ' or U+2019) merge
   with the preceding word and suppress boundaries inside the span
6. class transitions (letter<->digit, letter<->punct/symbol, digit<->punct/symbol)
7. digit runs split every 3 digits from the left

The vectorized form equals the sequential loop: the only multi-codepoint
state is the contraction span, and spans never contain an apostrophe or
overlap another span, so per-position evaluation with span suppression
reproduces the loop exactly.
"""

from __future__ import annotations

import numpy as np

from ..unicode.fallback import CharClass

_APOSTROPHES = (0x27, 0x2019)

# Transition-boundary table (pre_tokenizer.mjs:175-189)
_TRANSITION = np.zeros((7, 7), dtype=bool)
_PS = (CharClass.PUNCTUATION, CharClass.SYMBOL)
_TRANSITION[CharClass.LETTER, CharClass.DIGIT] = True
_TRANSITION[CharClass.DIGIT, CharClass.LETTER] = True
for _c in _PS:
    _TRANSITION[CharClass.LETTER, _c] = True
    _TRANSITION[_c, CharClass.LETTER] = True
    _TRANSITION[_c, CharClass.DIGIT] = True
    _TRANSITION[CharClass.DIGIT, _c] = True


def _contraction_spans(cps: np.ndarray, classes: np.ndarray) -> np.ndarray:
    """Boolean mask of positions suppressed by contraction matches.

    Matches ``matchContraction`` (pre_tokenizer.mjs:83-110): single-char
    suffixes s/t/m/d then two-char re/ve/ll, each requiring the codepoint after
    the suffix to be a non-letter (or end of input).
    """
    n = len(cps)
    suppressed = np.zeros(n, dtype=bool)
    if n < 2:
        return suppressed

    is_apos = (cps == _APOSTROPHES[0]) | (cps == _APOSTROPHES[1])
    cand = np.zeros(n, dtype=bool)
    cand[1:] = is_apos[1:] & (classes[:-1] == CharClass.LETTER)

    def cp_at(offset: int) -> np.ndarray:
        """cps shifted by +offset with 0 padding (0 matches nothing)."""
        out = np.zeros(n, dtype=np.int64)
        if offset < n:
            out[: n - offset] = cps[offset:]
        return out

    def letter_at(offset: int) -> np.ndarray:
        """classes[i+offset] == LETTER, False past the end."""
        out = np.zeros(n, dtype=bool)
        if offset < n:
            out[: n - offset] = classes[offset:] == CharClass.LETTER
        return out

    c1 = cp_at(1)
    c2 = cp_at(2)
    has1 = np.zeros(n, dtype=bool)
    has1[: n - 1] = True
    has2 = np.zeros(n, dtype=bool)
    if n >= 2:
        has2[: n - 2] = True

    def is_any(x: np.ndarray, chars: str) -> np.ndarray:
        m = np.zeros(len(x), dtype=bool)
        for ch in chars:
            m |= x == ord(ch)
        return m

    single = cand & has1 & is_any(c1, "sStTmMdD") & ~letter_at(2)
    two = (
        cand
        & has2
        & (
            (is_any(c1, "rR") & is_any(c2, "eE"))
            | (is_any(c1, "vV") & is_any(c2, "eE"))
            | (is_any(c1, "lL") & is_any(c2, "lL"))
        )
        & ~letter_at(3)
    )
    # Single-char matches take priority (checked first in the reference).
    two &= ~single

    suppressed |= single | two
    suppressed[1:] |= (single | two)[:-1]
    suppressed[2:] |= two[:-2]
    return suppressed


def _digit_run_splits(classes: np.ndarray) -> np.ndarray:
    """Positions i where (i - run_start) % 3 == 0 within a digit run.

    Matches ``isDigitRunSplitPoint`` (pre_tokenizer.mjs:198-204): run start is
    the first digit of the run containing position i-1.
    """
    n = len(classes)
    idx = np.arange(n, dtype=np.int64)
    is_digit = classes == CharClass.DIGIT
    last_non_digit = np.maximum.accumulate(np.where(~is_digit, idx, -1))
    run_start = last_non_digit + 1
    return (idx - run_start) % 3 == 0


def find_word_boundaries(cps: np.ndarray, classes: np.ndarray) -> np.ndarray:
    """Codepoint-level word-start mask (1 = word start)."""
    cps = np.asarray(cps, dtype=np.int64)
    classes = np.asarray(classes, dtype=np.int64)
    n = len(cps)
    starts = np.zeros(n, dtype=np.uint8)
    if n == 0:
        return starts
    starts[0] = 1
    if n == 1:
        return starts

    prev = classes[:-1]
    curr = classes[1:]
    start = np.zeros(n - 1, dtype=bool)
    handled = np.zeros(n - 1, dtype=bool)

    # Rule: newlines force boundaries on both sides.
    nl = (curr == CharClass.NEWLINE) | (prev == CharClass.NEWLINE)
    start |= nl
    handled |= nl

    # Rule: whitespace handling (space-prefix model).
    ws_cur = curr == CharClass.WHITESPACE
    ws_prev = prev == CharClass.WHITESPACE
    start |= ~handled & ws_cur & ~ws_prev
    handled |= ws_cur
    handled |= ws_prev  # non-ws after ws continues the word

    # Rule: contraction spans suppress everything inside them.
    suppressed = _contraction_spans(cps, classes)[1:]
    handled |= suppressed

    # Rule: class transitions.
    trans = _TRANSITION[prev, curr]
    start |= ~handled & trans
    handled |= trans

    # Rule: digit runs split every 3.
    dd = (curr == CharClass.DIGIT) & (prev == CharClass.DIGIT)
    splits = _digit_run_splits(classes)[1:]
    start |= ~handled & dd & splits

    starts[1:] = start.astype(np.uint8)
    starts[0] = 1
    return starts

