"""Pure-Python Unicode backend (the port's own copy of
``gpu_bpe_tpu/unicode/fallback.py``): the whole interface of the native
decoder where g++ is missing, and the yardstick the native backend is held
to.

Property predicates, scripts, blocks and identifier sets come from the
reference decoder's own data (``data/ref_properties.json``, identical to the
native tables); confusables and the suspicious-character ranges from
``data/ref_confusables.json`` and ``data/ref_suspicious_extra.json``;
normalization, case maps, names and numeric values from CPython's
``unicodedata`` (Unicode 15.0 in CPython 3.12, against the reference's
17.0: they differ only for codepoints assigned since 15.0).
"""

from __future__ import annotations

import bisect
import json
import os
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

_DATA = Path(__file__).resolve().parent / "data"

# the reference's category-enum index -> two-letter name
_CAT_NAMES = (
    "Cn Lu Ll Lt Lm Lo Mn Mc Me Nd Nl No Pc Pd Ps Pe Pi Pf Po Sm Sc Sk So "
    "Zs Zl Zp Cc Cf Cs Co"
).split()
_CAT_HEADS = "".join(c[0] for c in _CAT_NAMES)

# environment switch of the reference-compat Hangul mode, read by both
# backends (the JAX package's backends read the same variable)
REF_HANGUL_ENV = "GPU_BPE_TPU_REF_HANGUL"


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
def _properties() -> dict:
    return json.loads((_DATA / "ref_properties.json").read_text())


@lru_cache(maxsize=None)
def _run_starts(key: str) -> list[int]:
    """Start codepoints of the runs or ranges of a property-data field."""
    return [r[0] for r in _properties()[key]]


@lru_cache(maxsize=1)
def _suspicious_ranges():
    ranges = json.loads((_DATA / "ref_suspicious_extra.json").read_text())["ranges"]
    return [r[0] for r in ranges], [r[1] for r in ranges]


@lru_cache(maxsize=1)
def _confusable_table() -> dict[int, tuple[int, int]]:
    """The reference's UTS #39 prototype map: cp -> (first codepoint of the
    prototype, prototype length)."""
    entries = json.loads((_DATA / "ref_confusables.json").read_text())["entries"]
    return {int(k): (v, plen) for k, (v, plen) in entries.items()}


@lru_cache(maxsize=1)
def _category_ids() -> np.ndarray:
    """Dense uint8 category id per codepoint (index into ``_CAT_NAMES``)."""
    runs = _properties()["category"]
    starts = np.array([r[0] for r in runs] + [MAX_CODEPOINT], dtype=np.int64)
    return np.repeat(np.array([r[1] for r in runs], dtype=np.uint8), np.diff(starts))


@lru_cache(maxsize=1)
def class_table() -> np.ndarray:
    """Dense uint8 class table over the full codepoint space (1.1 MB), from
    the category runs of ``data/ref_properties.json``: marks stay with
    letters, the whitespace and newline sets override the categories."""
    runs = _properties()["category"]
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
    """Python implementation of the Unicode backend interface: predicates,
    case maps, the four normalization forms (strings, UTF-8 bytes and
    codepoint arrays), scripts, blocks, identifier sets, confusables,
    sanitizing, transcoding, segmentation and batch classification."""

    name = "python-unicodedata"

    @property
    def unicode_version(self) -> str:
        return unicodedata.unidata_version

    # ── codepoint properties ────────────────────────────────────────
    @staticmethod
    def get_category(cp: int) -> str:
        return _CAT_NAMES[_category_ids()[cp]]

    def is_letter(self, cp: int) -> bool:
        return self.get_category(cp).startswith("L")

    def is_mark(self, cp: int) -> bool:
        return self.get_category(cp).startswith("M")

    def is_digit(self, cp: int) -> bool:
        return self.get_category(cp) == "Nd"

    def is_number(self, cp: int) -> bool:
        return self.get_category(cp).startswith("N")

    def is_punctuation(self, cp: int) -> bool:
        return self.get_category(cp).startswith("P")

    def is_symbol(self, cp: int) -> bool:
        return self.get_category(cp).startswith("S")

    def is_whitespace(self, cp: int) -> bool:
        return cp in WHITESPACE_CODEPOINTS

    def is_separator(self, cp: int) -> bool:
        return self.get_category(cp).startswith("Z")

    def is_control(self, cp: int) -> bool:
        return self.get_category(cp) == "Cc"

    def is_format(self, cp: int) -> bool:
        return self.get_category(cp) == "Cf"

    def is_uppercase(self, cp: int) -> bool:
        return self.get_category(cp) == "Lu"

    def is_lowercase(self, cp: int) -> bool:
        return self.get_category(cp) == "Ll"

    def is_titlecase(self, cp: int) -> bool:
        return self.get_category(cp) == "Lt"

    def is_alphanumeric(self, cp: int) -> bool:
        return self.is_letter(cp) or self.is_number(cp)

    def is_valid(self, cp: int) -> bool:
        return 0 <= cp < MAX_CODEPOINT and not (0xD800 <= cp <= 0xDFFF)

    def is_surrogate(self, cp: int) -> bool:
        return 0xD800 <= cp <= 0xDFFF

    def is_noncharacter(self, cp: int) -> bool:
        return (0xFDD0 <= cp <= 0xFDEF) or (cp & 0xFFFE) == 0xFFFE

    def is_assigned(self, cp: int) -> bool:
        return self.get_category(cp) != "Cn"

    def is_private_use(self, cp: int) -> bool:
        return self.get_category(cp) == "Co"

    def get_numeric_value(self, cp: int) -> float:
        return unicodedata.numeric(chr(cp), float("nan"))

    def get_digit_value(self, cp: int) -> int:
        return unicodedata.digit(chr(cp), -1)

    def get_name(self, cp: int) -> str:
        return unicodedata.name(chr(cp), "")

    def from_name(self, name: str) -> int:
        try:
            return ord(unicodedata.lookup(name))
        except KeyError:
            return -1

    # ── case maps ───────────────────────────────────────────────────
    def to_upper(self, cp: int) -> int:
        u = chr(cp).upper()
        return ord(u) if len(u) == 1 else cp

    def to_lower(self, cp: int) -> int:
        lo = chr(cp).lower()
        return ord(lo) if len(lo) == 1 else cp

    def to_title(self, cp: int) -> int:
        t = chr(cp).title()
        return ord(t[0]) if t else cp

    def case_fold(self, cp: int) -> int:
        f = chr(cp).casefold()
        return ord(f) if len(f) == 1 else cp

    def to_upper_full(self, cp: int) -> list[int]:
        return [ord(c) for c in chr(cp).upper()]

    def to_lower_full(self, cp: int) -> list[int]:
        return [ord(c) for c in chr(cp).lower()]

    def case_fold_full(self, cp: int) -> list[int]:
        return [ord(c) for c in chr(cp).casefold()]

    def string_to_upper(self, s: str) -> str:
        return s.upper()

    def string_to_lower(self, s: str) -> str:
        return s.lower()

    def string_case_fold(self, s: str) -> str:
        return s.casefold()

    # ── normalization ───────────────────────────────────────────────
    _FORMS = ("NFC", "NFD", "NFKC", "NFKD")

    def set_ref_hangul(self, enabled: bool) -> None:
        """Reference-compat Hangul mode (see ``CppUnicodeBackend.set_ref_hangul``):
        Hangul syllables and conjoining jamo pass through normalization
        untouched, as in the reference's wasm. Done here by splitting the
        text on Hangul runs and normalizing the segments between them
        (Hangul has ccc = 0 and no table decompositions, so the segments
        are independent). The environment variable ``GPU_BPE_TPU_REF_HANGUL``
        turns it on as well."""
        self._ref_hangul = enabled

    @property
    def ref_hangul(self) -> bool:
        return getattr(self, "_ref_hangul", False) or bool(os.environ.get(REF_HANGUL_ENV))

    @staticmethod
    def _is_hangul_inert_cp(o: int) -> bool:
        # syllables and conjoining jamo (the codepoints the algorithmic step touches)
        return 0xAC00 <= o <= 0xD7A3 or 0x1100 <= o <= 0x11FF

    def normalize(self, text: str, form: int | str = "NFC") -> str:
        if isinstance(form, int):
            form = self._FORMS[form]
        if self.ref_hangul and any(self._is_hangul_inert_cp(ord(c)) for c in text):
            out: list[str] = []
            seg: list[str] = []
            for ch in text:
                if self._is_hangul_inert_cp(ord(ch)):
                    if seg:
                        out.append(unicodedata.normalize(form, "".join(seg)))
                        seg = []
                    out.append(ch)
                else:
                    seg.append(ch)
            if seg:
                out.append(unicodedata.normalize(form, "".join(seg)))
            return "".join(out)
        return unicodedata.normalize(form, text)

    def normalize_bytes(self, data: bytes, form: int | str = "NFC") -> bytes:
        """UTF-8 bytes -> normalized UTF-8 bytes. Raises on invalid UTF-8
        (callers take the reference's raw-bytes fallback)."""
        return self.normalize(bytes(data).decode("utf-8", errors="strict"), form).encode("utf-8")

    def is_normalized(self, text: str, form: int | str = "NFC") -> bool:
        if isinstance(form, int):
            form = self._FORMS[form]
        return unicodedata.is_normalized(form, text)

    def decompose(self, cp: int) -> str:
        return unicodedata.decomposition(chr(cp))

    def combining_class(self, cp: int) -> int:
        return unicodedata.combining(chr(cp))

    def is_combining(self, cp: int) -> bool:
        return unicodedata.combining(chr(cp)) != 0

    # ── batch classification ────────────────────────────────────────
    def classify_codepoints(self, codepoints: np.ndarray) -> np.ndarray:
        """Vectorized per-codepoint CharClass lookup."""
        cps = np.clip(np.asarray(codepoints, dtype=np.int64), 0, MAX_CODEPOINT - 1)
        return class_table()[cps]

    def classify_bytes(self, data: bytes) -> tuple[np.ndarray, int]:
        """UTF-8 bytes -> (per-codepoint CharClass array, codepoint count)."""
        from .utf8 import utf8_to_codepoints

        cps = utf8_to_codepoints(data)
        return self.classify_codepoints(cps), len(cps)

    # ── scripts, blocks, identifiers, security ──────────────────────
    def get_script(self, cp: int) -> int:
        i = bisect.bisect_right(_run_starts("script"), cp) - 1
        return _properties()["script"][i][1] if i >= 0 else 0

    def get_script_name(self, script_id: int) -> str:
        names = _properties()["script_names"]
        return names[script_id] if 0 <= script_id < len(names) else ""

    def get_block_name(self, cp: int) -> str:
        i = bisect.bisect_right(_run_starts("blocks"), cp) - 1
        return _properties()["blocks"][i][1] if i >= 0 else ""

    def _in_ranges(self, key: str, cp: int) -> bool:
        i = bisect.bisect_right(_run_starts(key), cp) - 1
        return i >= 0 and cp <= _properties()[key][i][1]

    def is_identifier_start(self, cp: int) -> bool:
        return self._in_ranges("identifier_start", cp)

    def is_identifier_continue(self, cp: int) -> bool:
        return self._in_ranges("identifier_continue", cp)

    def is_suspicious(self, s: str) -> bool:
        """The reference's rule (the native backend's too): a non-ASCII
        codepoint with a confusable mapping, a codepoint of the extra
        suspicious ranges (controls, bidi, private use, noncharacters), or
        a script other than the first codepoint's (Common and Inherited
        aside)."""
        if not s:
            return False
        starts, ends = _suspicious_ranges()

        def extra(cp: int) -> bool:
            i = bisect.bisect_right(starts, cp) - 1
            return i >= 0 and cp <= ends[i]

        base = self.get_script(ord(s[0]))
        script_clause = base not in (1, 2)
        for i, ch in enumerate(s):
            cp = ord(ch)
            if cp > 0x7F and self.has_confusable_mapping(cp):
                return True
            if extra(cp):
                return True
            if script_clause and i > 0:
                sc = self.get_script(cp)
                if sc != base and sc not in (1, 2):
                    return True
        return False

    # ── segmentation counts ─────────────────────────────────────────
    def count_graphemes(self, s: str) -> int:
        from .segmentation import count_graphemes

        return count_graphemes(s)

    def count_words(self, s: str) -> int:
        from .segmentation import count_words

        return count_words(s)

    def count_sentences(self, s: str) -> int:
        from .segmentation import count_sentences

        return count_sentences(s)

    # ── UTF validation ──────────────────────────────────────────────
    def is_valid_utf8(self, data: bytes) -> bool:
        try:
            bytes(data).decode("utf-8", errors="strict")
            return True
        except UnicodeDecodeError:
            return False

    def utf8_length(self, s: str) -> int:
        return len(s.encode("utf-8"))

    def char_count(self, s: str) -> int:
        return len(s)

    def to_codepoints(self, s: str) -> np.ndarray:
        return np.array([ord(c) for c in s], dtype=np.uint32)

    # ── the rest of the reference's surface ─────────────────────────
    def is_alphabetic(self, cp: int) -> bool:
        cat = unicodedata.category(chr(cp))
        return cat.startswith("L") or cat == "Nl"

    def is_numeric(self, cp: int) -> bool:
        return unicodedata.category(chr(cp)).startswith("N")

    def to_title_full(self, cp: int) -> list[int]:
        return [ord(c) for c in chr(cp).title()]

    def string_to_title(self, s: str) -> str:
        return s.title()

    def case_compare(self, a: str, b: str) -> int:
        fa, fb = a.casefold(), b.casefold()
        return -1 if fa < fb else (1 if fa > fb else 0)

    @staticmethod
    def _confusable_proto(cp: int) -> int:
        ent = _confusable_table().get(cp)
        return ent[0] if ent else cp

    def check_confusables(self, a: str, b: str) -> bool:
        # the reference's rule: equal lengths and equal prototypes position by position
        if len(a) != len(b):
            return False
        return all(self._confusable_proto(ord(x)) == self._confusable_proto(ord(y)) for x, y in zip(a, b))

    def check_confusables_widened(self, a: str, b: str) -> bool:
        return self.get_skeleton(a) == self.get_skeleton(b)

    @classmethod
    def _proto_widened(cls, cp: int) -> int:
        # single-codepoint prototypes only: a multi-codepoint entry carries
        # just its first codepoint, and NFKD already expands those characters
        ent = _confusable_table().get(cp)
        return ent[0] if ent and ent[1] == 1 else cp

    def get_skeleton(self, s: str) -> str:
        k = unicodedata.normalize("NFKD", s).casefold()
        return "".join(chr(self._proto_widened(ord(c))) for c in k if unicodedata.combining(c) == 0)

    def is_confusable(self, a: int, b: int) -> bool:
        # the reference's rule: distinct codepoints sharing a prototype
        return a != b and self._confusable_proto(a) == self._confusable_proto(b)

    def has_confusable_mapping(self, cp: int) -> bool:
        return cp in _confusable_table()

    def confusable_proto_len(self, cp: int) -> int:
        ent = _confusable_table().get(cp)
        return ent[1] if ent else 1

    @staticmethod
    def _cp_ill_formed(cp: int) -> bool:
        return cp > 0x10FFFF or 0xD800 <= cp <= 0xDFFF or 0xFDD0 <= cp <= 0xFDEF or (cp & 0xFFFE) == 0xFFFE

    def sanitize(self, data: bytes) -> bytes:
        return bytes(data).decode("utf-8", errors="replace").encode("utf-8")

    def sanitize_codepoints(self, s: str) -> str:
        return "".join(c for c in s if not self._cp_ill_formed(ord(c)))

    def is_well_formed(self, data: bytes) -> bool:
        return self.is_valid_utf8(data)

    def is_well_formed_codepoints(self, s) -> bool:
        cps = [ord(c) for c in s] if isinstance(s, str) else list(s)
        return not any(self._cp_ill_formed(cp) for cp in cps)

    def is_valid_utf16(self, units) -> bool:
        try:
            np.asarray(units, dtype=np.uint16).tobytes().decode("utf-16-le", errors="strict")
            return True
        except UnicodeDecodeError:
            return False

    def utf16_to_utf32(self, units) -> np.ndarray:
        s = np.asarray(units, dtype=np.uint16).tobytes().decode("utf-16-le")
        return self.to_codepoints(s)

    def utf32_to_utf16(self, cps) -> np.ndarray:
        s = "".join(chr(int(c)) for c in np.asarray(cps, dtype=np.uint32))
        return np.frombuffer(s.encode("utf-16-le"), dtype=np.uint16).copy()

    def utf32_to_utf8(self, cps) -> bytes:
        return "".join(chr(int(c)) for c in np.asarray(cps, dtype=np.uint32)).encode("utf-8")

    def utf8_to_utf16(self, data: bytes) -> np.ndarray:
        s = bytes(data).decode("utf-8")
        return np.frombuffer(s.encode("utf-16-le"), dtype=np.uint16).copy()

    def utf16_to_utf8(self, units) -> bytes:
        return np.asarray(units, dtype=np.uint16).tobytes().decode("utf-16-le").encode("utf-8")

    def is_grapheme_boundary(self, s: str, pos: int) -> bool:
        if pos <= 0 or pos >= len(s):
            return True
        prev, cur = s[pos - 1], s[pos]
        if prev == "\r" and cur == "\n":
            return False
        if prev in "\r\n" or cur in "\r\n":
            return True
        if unicodedata.combining(cur) or unicodedata.category(cur).startswith("M"):
            return False
        if prev == "‍" or cur in "‍︎️":
            return False
        if "\U0001f3fb" <= cur <= "\U0001f3ff":
            return False
        return True

    def is_word_boundary(self, s: str, pos: int) -> bool:
        if pos <= 0 or pos >= len(s):
            return True

        def wordish(c):
            cat = unicodedata.category(c)
            return cat.startswith(("L", "N")) or c in "'_’"

        return wordish(s[pos - 1]) != wordish(s[pos])

    def is_sentence_boundary(self, s: str, pos: int) -> bool:
        if pos <= 0 or pos >= len(s):
            return True
        return s[pos - 1] in ".!?‼‽⁇⁈⁉。！．？"

    def next_grapheme(self, s: str, pos: int) -> int:
        for i in range(pos + 1, len(s)):
            if self.is_grapheme_boundary(s, i):
                return i
        return len(s)

    def next_word(self, s: str, pos: int) -> int:
        for i in range(pos + 1, len(s)):
            if self.is_word_boundary(s, i):
                return i
        return len(s)

    def next_sentence(self, s: str, pos: int) -> int:
        for i in range(pos + 1, len(s)):
            if self.is_sentence_boundary(s, i):
                return i
        return len(s)

    def normalize_codepoints(self, cps, form: int | str = "NFC") -> np.ndarray:
        if isinstance(form, int):
            form = self._FORMS[form]
        s = "".join(chr(int(c)) for c in np.asarray(cps, dtype=np.uint32))
        return self.to_codepoints(unicodedata.normalize(form, s))

    def quick_check(self, s: str, form: int | str = "NFC") -> bool:
        if isinstance(form, int):
            form = self._FORMS[form]
        return unicodedata.is_normalized(form, s)
