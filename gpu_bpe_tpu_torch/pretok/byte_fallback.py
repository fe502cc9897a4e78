"""Byte-level heuristic word boundaries (pre-tokenizer fallback).

Vectorized equivalent of the reference's GPU fallback kernel
(src/bpe/train.wgsl:87-186 ``bpe_word_boundary``), used when
no Unicode pre-tokenization mask is available. Operates directly on the symbol
array's low byte values.

Byte classes (train.wgsl:111-127):
  0 = letter (a-z, A-Z, and every byte ≥ 0x80)
  1 = digit (0-9)
  2 = space (0x20)
  3 = punctuation / other
  4 = newline (0x0A)
"""

from __future__ import annotations

import numpy as np

from ..constants import TOKEN_MASK, WORD_START_BIT

_CLASS_TABLE = np.full(256, 3, dtype=np.uint8)
_CLASS_TABLE[0x0A] = 4
_CLASS_TABLE[0x20] = 2
_CLASS_TABLE[0x30:0x3A] = 1
_CLASS_TABLE[0x80:] = 0
_CLASS_TABLE[0x61:0x7B] = 0
_CLASS_TABLE[0x41:0x5B] = 0


def byte_char_class(tokens: np.ndarray) -> np.ndarray:
    return _CLASS_TABLE[np.asarray(tokens, dtype=np.int64) & 0xFF]


def tag_word_boundaries_bytes(symbols: np.ndarray) -> np.ndarray:
    """Set WORD_START_BIT per the byte-heuristic rules; returns a new array.

    Rules (train.wgsl:144-186): first symbol always starts; class change is a
    boundary; space followed by letter/digit is NOT a boundary (space attaches
    to the next word); a space after non-space always starts; newlines force
    boundaries on both sides.
    """
    symbols = np.asarray(symbols, dtype=np.uint32)
    n = len(symbols)
    if n == 0:
        return symbols.copy()
    tok = symbols & np.uint32(TOKEN_MASK)
    cls = byte_char_class(tok)

    boundary = np.zeros(n, dtype=bool)
    boundary[0] = True
    if n > 1:
        prev = cls[:-1]
        curr = cls[1:]
        b = prev != curr
        b &= ~((prev == 2) & ((curr == 0) | (curr == 1)))
        b |= (curr == 2) & (prev != 2)
        b |= (prev == 4) | (curr == 4)
        boundary[1:] = b

    # The kernel rewrites boundary symbols as tok | WORD_START_BIT and leaves
    # others as-is (it never clears a pre-existing flag on non-boundaries
    # because inputs arrive flag-free; we reproduce tok-masked semantics).
    out = tok.copy()
    out[boundary] |= np.uint32(WORD_START_BIT)
    nonb = ~boundary
    out[nonb] = tok[nonb]
    return out


def byte_word_starts(data: bytes | np.ndarray) -> np.ndarray:
    """Word-start mask (uint8, 1 at each word start) of raw corpus bytes under
    the byte heuristic — the ``word_starts`` argument of ``Trainer.train``."""
    tok = np.frombuffer(bytes(data), np.uint8) if isinstance(data, (bytes, bytearray)) else data
    tagged = tag_word_boundaries_bytes(np.asarray(tok, np.uint32))
    return ((tagged & np.uint32(WORD_START_BIT)) != 0).astype(np.uint8)
