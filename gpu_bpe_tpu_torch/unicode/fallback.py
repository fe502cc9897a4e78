"""Pure-Python Unicode backend: what pre-tokenization needs when the native
decoder cannot be built (the port's own copy of the pre-tokenize surface of
``gpu_bpe_tpu/unicode/fallback.py``).

Classes come from the reference decoder's own category data
(``data/ref_properties.json``, identical to the native tables);
normalization is CPython's ``unicodedata``.
"""

from __future__ import annotations

import json
import unicodedata
from functools import lru_cache
from pathlib import Path

import numpy as np

MAX_CODEPOINT = 0x110000

# Unicode White_Space property (PropList.txt), stable across recent versions.
WHITESPACE_CODEPOINTS = frozenset(
    list(range(0x09, 0x0E))
    + [0x20, 0x85, 0xA0, 0x1680]
    + list(range(0x2000, 0x200B))
    + [0x2028, 0x2029, 0x202F, 0x205F, 0x3000]
)

# Newlines get their own class.
NEWLINE_CODEPOINTS = frozenset([0x0A, 0x0D, 0x85, 0x2028, 0x2029])

_PROPERTIES = Path(__file__).resolve().parent / "data" / "ref_properties.json"

# the reference's category-enum index -> two-letter name
_CAT_NAMES = (
    "Cn Lu Ll Lt Lm Lo Mn Mc Me Nd Nl No Pc Pd Ps Pe Pi Pf Po Sm Sc Sk So "
    "Zs Zl Zp Cc Cf Cs Co"
).split()
_CAT_HEADS = "".join(c[0] for c in _CAT_NAMES)


class CharClass:
    """Broad character classes for pre-tokenization."""

    LETTER = 0
    DIGIT = 1
    WHITESPACE = 2
    PUNCTUATION = 3
    SYMBOL = 4
    NEWLINE = 5
    OTHER = 6


@lru_cache(maxsize=1)
def class_table() -> np.ndarray:
    """Dense uint8 class table over the full codepoint space (1.1 MB), from
    the category runs of ``data/ref_properties.json``: marks stay with
    letters, the whitespace and newline sets override the categories."""
    runs = json.loads(_PROPERTIES.read_text())["category"]
    table = np.full(MAX_CODEPOINT, CharClass.OTHER, dtype=np.uint8)
    group_to_class = {
        "L": CharClass.LETTER, "M": CharClass.LETTER, "N": CharClass.DIGIT,
        "P": CharClass.PUNCTUATION, "S": CharClass.SYMBOL,
    }
    for i, (start, cat) in enumerate(runs):
        end = runs[i + 1][0] if i + 1 < len(runs) else MAX_CODEPOINT
        cls = group_to_class.get(_CAT_HEADS[cat])
        if cls is not None:
            table[start:end] = cls
    table[sorted(WHITESPACE_CODEPOINTS)] = CharClass.WHITESPACE
    table[sorted(NEWLINE_CODEPOINTS)] = CharClass.NEWLINE
    return table


class PyUnicodeBackend:
    """Python backend: normalization and batch classification."""

    name = "python-unicodedata"
    _FORMS = ("NFC", "NFD", "NFKC", "NFKD")

    def normalize(self, text: str, form: int | str = "NFC") -> str:
        if isinstance(form, int):
            form = self._FORMS[form]
        return unicodedata.normalize(form, text)

    def normalize_bytes(self, data: bytes, form: int | str = "NFC") -> bytes:
        """UTF-8 bytes -> normalized UTF-8 bytes. Raises on invalid UTF-8
        (callers take the reference's raw-bytes fallback)."""
        return self.normalize(bytes(data).decode("utf-8", errors="strict"), form).encode("utf-8")

    def classify_codepoints(self, codepoints: np.ndarray) -> np.ndarray:
        """Vectorized per-codepoint CharClass lookup."""
        cps = np.clip(np.asarray(codepoints, dtype=np.int64), 0, MAX_CODEPOINT - 1)
        return class_table()[cps]
