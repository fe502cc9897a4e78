"""ctypes binding of the native decoder library (the port's own copy of
``gpu_bpe_tpu/unicode/cpp_backend.py``), built from this package's ``cpp/``
sources by ``utils/build.py``: ``LIBRARY`` declares its 97 exports.

``CppUnicodeBackend`` has the interface of ``fallback.PyUnicodeBackend``,
the reference decoder's API, on the native tables, and adds the exports
the Python backend lacks (``compose``, ``decompose_full``, blocks, pattern
and XID sets, ``is_mixed_script``) and the pre-tokenizer's hot paths: the
fused ``pretokenize_prepare`` (NFC + classify + byte offsets in one native
pass, into a pooled scratch), the word-boundary rule engine and the
byte-level word-start scatter.
"""

from __future__ import annotations

import ctypes as C
import os
from pathlib import Path

import numpy as np

from ..utils.build import Library, load
from .fallback import REF_HANGUL_ENV, PyUnicodeBackend

_I = C.c_int
_U32 = C.c_uint32
_I64 = C.c_int64
_S = C.c_char_p
_U8P = C.POINTER(C.c_uint8)
_U16P = C.POINTER(C.c_uint16)
_U32P = C.POINTER(C.c_uint32)
_I64P = C.POINTER(C.c_int64)
_CPP = Path(__file__).resolve().parent / "cpp"
LIBRARY = Library(
    name="decoder",
    source=_CPP / "decoder.cpp",
    flags=("-O2", "-shared", "-fPIC", "-std=c++17"),
    headers=(_CPP / "unicode_tables.h",),
    entries={
        "decoder_init decoder_get_hangul_inert": (_I, []),
        "decoder_get_unicode_version": (_S, []),
        (
            "decoder_get_category decoder_is_valid decoder_is_assigned decoder_is_surrogate "
            "decoder_is_noncharacter decoder_is_private_use decoder_is_letter decoder_is_mark "
            "decoder_is_digit decoder_is_number decoder_is_punctuation decoder_is_symbol "
            "decoder_is_separator decoder_is_control decoder_is_format decoder_is_uppercase "
            "decoder_is_lowercase decoder_is_titlecase decoder_is_whitespace "
            "decoder_is_alphanumeric decoder_is_combining decoder_get_combining_class "
            "decoder_get_script decoder_get_block decoder_is_identifier_start "
            "decoder_is_identifier_continue decoder_is_pattern_syntax decoder_is_pattern_whitespace "
            "decoder_is_xid_start decoder_is_xid_continue decoder_is_alphabetic decoder_is_numeric "
            "decoder_has_confusable_mapping decoder_confusable_proto_len"
        ): (_I, [_U32]),
        "decoder_to_upper decoder_to_lower decoder_to_title decoder_case_fold": (_U32, [_U32]),
        "decoder_compose": (_I64, [_U32, _U32]),
        "decoder_is_confusable": (_I, [_U32, _U32]),
        "decoder_is_in_block": (_I, [_U32, _I]),
        (
            "decoder_decompose decoder_decompose_full decoder_to_upper_full decoder_to_lower_full "
            "decoder_to_title_full decoder_case_fold_full"
        ): (_I, [_U32, _U32P, _I]),
        "decoder_is_valid_utf8 decoder_is_well_formed_utf8": (_I, [_S, _I64]),
        "decoder_utf8_char_count decoder_utf8_length": (_I64, [_S, _I64]),
        "decoder_normalize_utf8": (_I, [_S, _I64, _I, _U8P, _I64, _I64P]),
        "decoder_is_normalized_utf8": (_I, [_S, _I64, _I]),
        "decoder_classify_codepoints decoder_sanitize_utf8": (_I, [_S, _I64, _U8P, _I64, _I64P]),
        "decoder_classify_utf32": (None, [_U32P, _I64, _U8P]),
        "decoder_pretokenize_prepare": (_I, [_S, _I64, _U8P, _I64, _I64P, _U32P, _U8P, _U32P, _I64, _I64P]),
        "decoder_byte_word_starts": (None, [_U32P, _U8P, _I64, _U8P, _I64]),
        "decoder_find_word_boundaries": (None, [_U32P, _U8P, _I64, _U8P]),
        "decoder_count_graphemes decoder_count_words decoder_count_sentences decoder_utf8_encoded_length": (
            _I64, [_U32P, _I64]),
        "decoder_is_suspicious decoder_is_mixed_script decoder_is_well_formed": (_I, [_U32P, _I64]),
        "decoder_case_compare decoder_check_confusables decoder_check_confusables_widened": (
            _I, [_U32P, _I64, _U32P, _I64]),
        "decoder_get_skeleton": (_I64, [_U32P, _I64, _U32P, _I64]),
        "decoder_string_to_upper decoder_string_to_lower decoder_string_to_title": (None, [_U32P, _I64, _U32P]),
        "decoder_normalize": (_I64, [_U32P, _I64, _I, _U32P, _I64]),
        "decoder_is_normalized decoder_quick_check": (_I, [_U32P, _I64, _I]),
        "decoder_sanitize": (_I, [_U32P, _I64, _U32P, _I64, _I64P, _I]),
        "decoder_is_valid_utf16": (_I, [_U16P, _I64]),
        "decoder_utf16_to_utf32": (_I64, [_U16P, _I64, _U32P, _I64]),
        "decoder_utf32_to_utf16": (_I64, [_U32P, _I64, _U16P, _I64]),
        "decoder_utf32_to_utf8": (_I64, [_U32P, _I64, _U8P, _I64]),
        "decoder_utf8_to_utf16": (_I64, [_S, _I64, _U16P, _I64]),
        "decoder_utf16_to_utf8": (_I64, [_U16P, _I64, _U8P, _I64]),
        "decoder_utf8_to_utf32": (_I64, [_S, _I64, _U32P, _I64]),
        "decoder_is_grapheme_boundary decoder_is_word_boundary decoder_is_sentence_boundary": (
            _I, [_U32P, _I64, _I64]),
        "decoder_next_grapheme decoder_next_word decoder_next_sentence": (_I64, [_U32P, _I64, _I64]),
        "decoder_get_script_name decoder_get_block_id_name": (_S, [_I]),
        "decoder_get_block_name": (_S, [_U32]),
        "decoder_set_hangul_inert": (None, [_I]),
    },
)


def _load():
    """The decoder library, built if missing, its exports declared and its
    tables initialised."""
    lib = load([LIBRARY])["decoder"]
    lib.decoder_init()
    return lib


def _cps(s: str) -> "np.ndarray":
    return np.array([ord(c) for c in s], dtype=np.uint32)


_FORMS = {"NFC": 0, "NFD": 1, "NFKC": 2, "NFKD": 3}


class CppUnicodeBackend(PyUnicodeBackend):
    """Native backend: every method the native library has, the rest
    (names, numeric values, ``to_codepoints``, ...) from the Python one."""

    name = "cpp-decoder"

    def __init__(self):
        self._lib = _load()
        self._prep_pool = None
        if os.environ.get(REF_HANGUL_ENV):
            self.set_ref_hangul(True)

    def set_ref_hangul(self, enabled: bool) -> None:
        """Reference-compat Hangul mode: skip the UAX #15 algorithmic
        Hangul decompose and compose steps, as the reference's wasm does,
        so that NFC and NFD leave Hangul syllables and conjoining jamo as
        they are; on a decomposed-jamo corpus the merge list is then the
        reference's. The flag lives in the loaded library and holds for
        every user of it in the process. ``GPU_BPE_TPU_REF_HANGUL`` set
        when the backend is created turns it on."""
        self._lib.decoder_set_hangul_inert(1 if enabled else 0)

    @property
    def ref_hangul(self) -> bool:
        return bool(self._lib.decoder_get_hangul_inert())

    @property
    def unicode_version(self) -> str:
        return self._lib.decoder_get_unicode_version().decode()

    # ── hot paths ────────────────────────────────────────────────────
    def normalize_bytes(self, data: bytes, form: int | str = "NFC") -> bytes:
        data = bytes(data)
        if isinstance(form, str):
            form = _FORMS[form]
        # K-form expansions can be long (e.g. U+FDFA -> 18 codepoints /
        # 33 UTF-8 bytes from a 3-byte input); cap covers the worst case.
        cap = len(data) * 12 + 64
        out = np.empty(cap, dtype=np.uint8)
        out_len = C.c_int64(0)
        rc = self._lib.decoder_normalize_utf8(
            data, len(data), form,
            out.ctypes.data_as(C.POINTER(C.c_uint8)), cap, C.byref(out_len),
        )
        if rc == -3:
            raise UnicodeDecodeError("utf-8", data, 0, 1, "invalid UTF-8 (native decoder)")
        if rc != 0:
            raise RuntimeError(f"decoder_normalize_utf8 failed: {rc}")
        return out[: out_len.value].tobytes()

    def normalize(self, text: str, form: int | str = "NFC") -> str:
        return self.normalize_bytes(text.encode("utf-8"), form).decode("utf-8")

    def classify_bytes(self, data: bytes):
        data = bytes(data)
        cap = max(len(data), 1)
        classes = np.empty(cap, dtype=np.uint8)
        count = C.c_int64(0)
        rc = self._lib.decoder_classify_codepoints(
            data, len(data), classes.ctypes.data_as(C.POINTER(C.c_uint8)), cap, C.byref(count)
        )
        if rc != 0:
            raise UnicodeDecodeError("utf-8", data, 0, 1, "invalid UTF-8 (native decoder)")
        return classes[: count.value], count.value

    def classify_codepoints(self, codepoints) -> np.ndarray:
        cps = np.ascontiguousarray(np.asarray(codepoints, dtype=np.uint32))
        out = np.empty(len(cps), dtype=np.uint8)
        if len(cps):
            self._lib.decoder_classify_utf32(
                cps.ctypes.data_as(C.POINTER(C.c_uint32)), len(cps),
                out.ctypes.data_as(C.POINTER(C.c_uint8)),
            )
        return out

    def pretokenize_prepare(self, data: bytes, reuse: bool = True):
        """Fused NFC + classify + offsets: (normalized bytes, codepoints,
        classes, byte offsets). Raises on invalid UTF-8 (callers take the
        staged path).

        The three codepoint arrays are views into a grow-only scratch pool
        that the next call overwrites: the caller consumes them before the
        next call (the pre-tokenizer does), which saves touching fresh
        pages on every call. ``reuse=False`` returns copies instead."""
        data = bytes(data)
        u8p, u32p = C.POINTER(C.c_uint8), C.POINTER(C.c_uint32)
        # codepoints <= bytes and NFC output is almost always <= input: try
        # tight buffers first, 4x on -2 (a rare expanding normalization)
        for factor in (1, 4):
            cap = len(data) * factor + 16
            if self._prep_pool is None or len(self._prep_pool[0]) < cap:
                self._prep_pool = (np.empty(cap, dtype=np.uint8), np.empty(cap, dtype=np.uint32),
                                   np.empty(cap, dtype=np.uint8), np.empty(cap, dtype=np.uint32))
            out, cps, classes, offsets = self._prep_pool
            out_len = C.c_int64(0)
            cp_count = C.c_int64(0)
            rc = self._lib.decoder_pretokenize_prepare(
                data, len(data), out.ctypes.data_as(u8p), cap, C.byref(out_len),
                cps.ctypes.data_as(u32p), classes.ctypes.data_as(u8p), offsets.ctypes.data_as(u32p),
                cap, C.byref(cp_count),
            )
            if rc != -2:
                break
        if rc == -3:
            raise UnicodeDecodeError("utf-8", data, 0, 1, "invalid UTF-8 (native decoder)")
        if rc != 0:
            raise RuntimeError(f"decoder_pretokenize_prepare failed: {rc}")
        n = cp_count.value
        views = (cps[:n], classes[:n], offsets[:n])
        return (out[: out_len.value].tobytes(), *(views if reuse else (v.copy() for v in views)))

    # ── predicates via native lib ────────────────────────────────────
    def is_letter(self, cp: int) -> bool:
        return bool(self._lib.decoder_is_letter(cp))

    def is_mark(self, cp: int) -> bool:
        return bool(self._lib.decoder_is_mark(cp))

    def is_digit(self, cp: int) -> bool:
        return bool(self._lib.decoder_is_digit(cp))

    def is_number(self, cp: int) -> bool:
        return bool(self._lib.decoder_is_number(cp))

    def is_punctuation(self, cp: int) -> bool:
        return bool(self._lib.decoder_is_punctuation(cp))

    def is_symbol(self, cp: int) -> bool:
        return bool(self._lib.decoder_is_symbol(cp))

    def is_whitespace(self, cp: int) -> bool:
        return bool(self._lib.decoder_is_whitespace(cp))

    def to_upper(self, cp: int) -> int:
        return self._lib.decoder_to_upper(cp)

    def to_lower(self, cp: int) -> int:
        return self._lib.decoder_to_lower(cp)

    def case_fold(self, cp: int) -> int:
        return self._lib.decoder_case_fold(cp)

    def compose(self, a: int, b: int) -> int:
        """Reference semantics: 0 when the pair does not compose."""
        return self._lib.decoder_compose(a, b)

    def is_combining(self, cp: int) -> bool:
        return bool(self._lib.decoder_is_combining(cp))

    def combining_class(self, cp: int) -> int:
        return self._lib.decoder_get_combining_class(cp)

    def is_valid_utf8(self, data: bytes) -> bool:
        data = bytes(data)
        return bool(self._lib.decoder_is_valid_utf8(data, len(data)))

    # ── scripts, blocks, identifier security ──────────────────────────
    def get_script(self, cp: int) -> int:
        return self._lib.decoder_get_script(cp)

    def get_block(self, cp: int) -> int:
        return self._lib.decoder_get_block(cp)

    def is_in_block(self, cp: int, block: int) -> bool:
        return bool(self._lib.decoder_is_in_block(cp, block))

    def is_identifier_start(self, cp: int) -> bool:
        return bool(self._lib.decoder_is_identifier_start(cp))

    def is_identifier_continue(self, cp: int) -> bool:
        return bool(self._lib.decoder_is_identifier_continue(cp))

    def is_pattern_syntax(self, cp: int) -> bool:
        return bool(self._lib.decoder_is_pattern_syntax(cp))

    def is_pattern_whitespace(self, cp: int) -> bool:
        return bool(self._lib.decoder_is_pattern_whitespace(cp))

    def is_suspicious(self, s: str) -> bool:
        """The reference's rule: any non-ASCII codepoint with a confusable
        mapping, any codepoint of the extra ranges (controls, bidi, private
        use, noncharacters), or >= 2 distinct scripts (Common and Inherited
        aside)."""
        cps = np.array([ord(c) for c in s], dtype=np.uint32)
        if not len(cps):
            return False
        return bool(
            self._lib.decoder_is_suspicious(cps.ctypes.data_as(C.POINTER(C.c_uint32)), len(cps))
        )

    def is_mixed_script(self, s: str) -> bool:
        """UTS #39-style highly-restrictive check (sanctions Han+kana/
        Hangul combos) — extra API beyond the reference."""
        cps = np.array([ord(c) for c in s], dtype=np.uint32)
        if not len(cps):
            return False
        return bool(
            self._lib.decoder_is_mixed_script(cps.ctypes.data_as(C.POINTER(C.c_uint32)), len(cps))
        )

    def is_xid_start(self, cp: int) -> bool:
        return bool(self._lib.decoder_is_xid_start(cp))

    def is_xid_continue(self, cp: int) -> bool:
        return bool(self._lib.decoder_is_xid_continue(cp))

    def decompose(self, cp: int) -> list[int]:
        """Reference semantics: single-level canonical decomposition
        (no Hangul, no recursion)."""
        out = (C.c_uint32 * 4)()
        n = self._lib.decoder_decompose(cp, out, 4)
        return [out[i] for i in range(n)]

    def decompose_full(self, cp: int) -> list[int]:
        out = (C.c_uint32 * 18)()
        n = self._lib.decoder_decompose_full(cp, out, 18)
        return [out[i] for i in range(n)]

    def count_graphemes(self, s: str) -> int:
        cps = np.array([ord(c) for c in s], dtype=np.uint32)
        if not len(cps):
            return 0
        return self._lib.decoder_count_graphemes(
            cps.ctypes.data_as(C.POINTER(C.c_uint32)), len(cps)
        )

    def count_words(self, s: str) -> int:
        cps = np.array([ord(c) for c in s], dtype=np.uint32)
        if not len(cps):
            return 0
        return self._lib.decoder_count_words(cps.ctypes.data_as(C.POINTER(C.c_uint32)), len(cps))

    def count_sentences(self, s: str) -> int:
        cps = np.array([ord(c) for c in s], dtype=np.uint32)
        if not len(cps):
            return 0
        return self._lib.decoder_count_sentences(
            cps.ctypes.data_as(C.POINTER(C.c_uint32)), len(cps)
        )

    # ── the rest of the reference's surface: case, segmentation, security ──
    def is_alphabetic(self, cp: int) -> bool:
        return bool(self._lib.decoder_is_alphabetic(cp))

    def is_numeric(self, cp: int) -> bool:
        return bool(self._lib.decoder_is_numeric(cp))

    def _full_case(self, fn, cp: int) -> list[int]:
        buf = (C.c_uint32 * 4)()
        n = fn(cp, buf, 4)
        return [buf[i] for i in range(n)]

    def to_upper_full(self, cp: int) -> list[int]:
        return self._full_case(self._lib.decoder_to_upper_full, cp)

    def to_lower_full(self, cp: int) -> list[int]:
        return self._full_case(self._lib.decoder_to_lower_full, cp)

    def to_title_full(self, cp: int) -> list[int]:
        return self._full_case(self._lib.decoder_to_title_full, cp)

    def case_fold_full(self, cp: int) -> list[int]:
        return self._full_case(self._lib.decoder_case_fold_full, cp)

    def case_compare(self, a: str, b: str) -> int:
        ca, cb = _cps(a), _cps(b)
        pa = ca.ctypes.data_as(C.POINTER(C.c_uint32)) if len(ca) else None
        pb = cb.ctypes.data_as(C.POINTER(C.c_uint32)) if len(cb) else None
        return self._lib.decoder_case_compare(pa, len(ca), pb, len(cb))

    def string_to_upper(self, s: str) -> str:
        return self._string_case(self._lib.decoder_string_to_upper, s)

    def string_to_lower(self, s: str) -> str:
        return self._string_case(self._lib.decoder_string_to_lower, s)

    def string_to_title(self, s: str) -> str:
        return self._string_case(self._lib.decoder_string_to_title, s)

    def _string_case(self, fn, s: str) -> str:
        cps = _cps(s)
        if not len(cps):
            return s
        out = np.empty(len(cps), dtype=np.uint32)
        fn(
            cps.ctypes.data_as(C.POINTER(C.c_uint32)), len(cps),
            out.ctypes.data_as(C.POINTER(C.c_uint32)),
        )
        return "".join(chr(int(c)) for c in out)

    def is_confusable(self, a: int, b: int) -> bool:
        """Reference semantics: distinct codepoints sharing a UTS #39
        prototype, as in the reference (identical codepoints are never
        confusable)."""
        return bool(self._lib.decoder_is_confusable(a, b))

    def has_confusable_mapping(self, cp: int) -> bool:
        return bool(self._lib.decoder_has_confusable_mapping(cp))

    def confusable_proto_len(self, cp: int) -> int:
        return int(self._lib.decoder_confusable_proto_len(cp))

    def check_confusables(self, a: str, b: str) -> bool:
        """Reference semantics: equal length + positionwise prototype
        equality (no normalization or case folding), as in the reference."""
        ca, cb = _cps(a), _cps(b)
        pa = ca.ctypes.data_as(C.POINTER(C.c_uint32)) if len(ca) else None
        pb = cb.ctypes.data_as(C.POINTER(C.c_uint32)) if len(cb) else None
        return bool(self._lib.decoder_check_confusables(pa, len(ca), pb, len(cb)))

    def check_confusables_widened(self, a: str, b: str) -> bool:
        """Widened skeleton comparison (NFKD + case fold + prototype map,
        marks stripped) — catches ligature/length-changing spoofs the
        reference's positionwise rule cannot."""
        ca, cb = _cps(a), _cps(b)
        pa = ca.ctypes.data_as(C.POINTER(C.c_uint32)) if len(ca) else None
        pb = cb.ctypes.data_as(C.POINTER(C.c_uint32)) if len(cb) else None
        return bool(self._lib.decoder_check_confusables_widened(pa, len(ca), pb, len(cb)))

    def get_skeleton(self, s: str) -> str:
        cps = _cps(s)
        p = cps.ctypes.data_as(C.POINTER(C.c_uint32)) if len(cps) else None
        cap = max(4 * len(cps) + 16, 64)
        out = np.empty(cap, dtype=np.uint32)
        n = self._lib.decoder_get_skeleton(
            p, len(cps), out.ctypes.data_as(C.POINTER(C.c_uint32)), cap
        )
        if n > cap:
            out = np.empty(n, dtype=np.uint32)
            n = self._lib.decoder_get_skeleton(
                p, len(cps), out.ctypes.data_as(C.POINTER(C.c_uint32)), n
            )
        return "".join(chr(int(c)) for c in out[:n])

    def sanitize(self, data: bytes) -> bytes:
        data = bytes(data)
        cap = len(data) * 3 + 16
        out = np.empty(cap, dtype=np.uint8)
        out_len = C.c_int64(0)
        rc = self._lib.decoder_sanitize_utf8(
            data, len(data), out.ctypes.data_as(C.POINTER(C.c_uint8)), cap, C.byref(out_len)
        )
        if rc != 0:
            raise RuntimeError(f"decoder_sanitize_utf8 failed: {rc}")
        return out[: out_len.value].tobytes()

    def sanitize_codepoints(self, s: str) -> str:
        """The reference's decoder_sanitize: drop surrogates,
        noncharacters and out-of-range values; keep all else."""
        cps = _cps(s)
        p = cps.ctypes.data_as(C.POINTER(C.c_uint32)) if len(cps) else None
        out = np.empty(max(len(cps), 1), dtype=np.uint32)
        out_len = C.c_int64(0)
        self._lib.decoder_sanitize(
            p, len(cps), out.ctypes.data_as(C.POINTER(C.c_uint32)), len(out),
            C.byref(out_len), 0,
        )
        return "".join(chr(int(c)) for c in out[: out_len.value])

    def is_well_formed_codepoints(self, s) -> bool:
        """Reference decoder_is_well_formed semantics over a codepoint
        stream (accepts a str or an iterable of ints; raw surrogate /
        noncharacter / out-of-range values make it ill-formed)."""
        if isinstance(s, str):
            cps = _cps(s)
        else:
            cps = np.ascontiguousarray(np.asarray(list(s), dtype=np.uint32))
        p = cps.ctypes.data_as(C.POINTER(C.c_uint32)) if len(cps) else None
        return bool(self._lib.decoder_is_well_formed(p, len(cps)))

    def is_well_formed(self, data: bytes) -> bool:
        data = bytes(data)
        return bool(self._lib.decoder_is_well_formed_utf8(data, len(data)))

    def is_valid_utf16(self, units) -> bool:
        arr = np.ascontiguousarray(np.asarray(units, dtype=np.uint16))
        p = arr.ctypes.data_as(C.POINTER(C.c_uint16)) if len(arr) else None
        return bool(self._lib.decoder_is_valid_utf16(p, len(arr)))

    def utf16_to_utf32(self, units) -> np.ndarray:
        arr = np.ascontiguousarray(np.asarray(units, dtype=np.uint16))
        out = np.empty(max(len(arr), 1), dtype=np.uint32)
        n = self._lib.decoder_utf16_to_utf32(
            arr.ctypes.data_as(C.POINTER(C.c_uint16)), len(arr),
            out.ctypes.data_as(C.POINTER(C.c_uint32)), len(out),
        )
        if n < 0:
            raise ValueError("invalid UTF-16")
        return out[:n].copy()

    def utf32_to_utf16(self, cps) -> np.ndarray:
        arr = np.ascontiguousarray(np.asarray(cps, dtype=np.uint32))
        out = np.empty(max(2 * len(arr), 1), dtype=np.uint16)
        n = self._lib.decoder_utf32_to_utf16(
            arr.ctypes.data_as(C.POINTER(C.c_uint32)), len(arr),
            out.ctypes.data_as(C.POINTER(C.c_uint16)), len(out),
        )
        if n < 0:
            raise ValueError("invalid codepoints")
        return out[:n].copy()

    def utf32_to_utf8(self, cps) -> bytes:
        arr = np.ascontiguousarray(np.asarray(cps, dtype=np.uint32))
        out = np.empty(max(4 * len(arr), 1), dtype=np.uint8)
        n = self._lib.decoder_utf32_to_utf8(
            arr.ctypes.data_as(C.POINTER(C.c_uint32)), len(arr),
            out.ctypes.data_as(C.POINTER(C.c_uint8)), len(out),
        )
        if n < 0:
            raise ValueError("invalid codepoints")
        return out[:n].tobytes()

    def utf8_to_utf16(self, data: bytes) -> np.ndarray:
        data = bytes(data)
        out = np.empty(max(len(data), 1), dtype=np.uint16)
        n = self._lib.decoder_utf8_to_utf16(
            data, len(data), out.ctypes.data_as(C.POINTER(C.c_uint16)), len(out)
        )
        if n < 0:
            raise ValueError("invalid UTF-8")
        return out[:n].copy()

    def utf16_to_utf8(self, units) -> bytes:
        arr = np.ascontiguousarray(np.asarray(units, dtype=np.uint16))
        out = np.empty(max(4 * len(arr), 1), dtype=np.uint8)
        n = self._lib.decoder_utf16_to_utf8(
            arr.ctypes.data_as(C.POINTER(C.c_uint16)), len(arr),
            out.ctypes.data_as(C.POINTER(C.c_uint8)), len(out),
        )
        if n < 0:
            raise ValueError("invalid UTF-16")
        return out[:n].tobytes()

    def utf8_length(self, cps) -> int:
        """Encoded UTF-8 byte length of a codepoint sequence. (The
        reference's decoder_utf8_length export returns the codepoint count
        of UTF-8 bytes; ``utf8_codepoint_count`` binds it.)"""
        arr = np.ascontiguousarray(np.asarray(cps, dtype=np.uint32))
        p = arr.ctypes.data_as(C.POINTER(C.c_uint32)) if len(arr) else None
        return self._lib.decoder_utf8_encoded_length(p, len(arr))

    def utf8_codepoint_count(self, data: bytes) -> int:
        """The reference decoder_utf8_length semantics: codepoint count
        of a UTF-8 byte string."""
        data = bytes(data)
        return self._lib.decoder_utf8_length(data, len(data))

    def _boundary(self, fn, s: str, pos: int) -> bool:
        cps = _cps(s)
        p = cps.ctypes.data_as(C.POINTER(C.c_uint32)) if len(cps) else None
        return bool(fn(p, len(cps), pos))

    def is_grapheme_boundary(self, s: str, pos: int) -> bool:
        return self._boundary(self._lib.decoder_is_grapheme_boundary, s, pos)

    def is_word_boundary(self, s: str, pos: int) -> bool:
        return self._boundary(self._lib.decoder_is_word_boundary, s, pos)

    def is_sentence_boundary(self, s: str, pos: int) -> bool:
        return self._boundary(self._lib.decoder_is_sentence_boundary, s, pos)

    def _next(self, fn, s: str, pos: int) -> int:
        cps = _cps(s)
        p = cps.ctypes.data_as(C.POINTER(C.c_uint32)) if len(cps) else None
        return int(fn(p, len(cps), pos))

    def next_grapheme(self, s: str, pos: int) -> int:
        return self._next(self._lib.decoder_next_grapheme, s, pos)

    def next_word(self, s: str, pos: int) -> int:
        return self._next(self._lib.decoder_next_word, s, pos)

    def next_sentence(self, s: str, pos: int) -> int:
        return self._next(self._lib.decoder_next_sentence, s, pos)

    def normalize_codepoints(self, cps, form: int | str = "NFC") -> np.ndarray:
        if isinstance(form, str):
            form = _FORMS[form]
        arr = np.ascontiguousarray(np.asarray(cps, dtype=np.uint32))
        # NFKC/NFKD can expand up to 18x per codepoint (U+FDFA -> 18 cps);
        # match the byte path's worst-case sizing rather than retry
        out = np.empty(max(18 * len(arr) + 16, 16), dtype=np.uint32)
        n = self._lib.decoder_normalize(
            arr.ctypes.data_as(C.POINTER(C.c_uint32)), len(arr), form,
            out.ctypes.data_as(C.POINTER(C.c_uint32)), len(out),
        )
        if n < 0:
            raise RuntimeError(f"decoder_normalize failed: {n}")
        return out[:n].copy()

    def quick_check(self, s: str, form: int | str = "NFC") -> bool:
        if isinstance(form, str):
            form = _FORMS[form]
        cps = _cps(s)
        p = cps.ctypes.data_as(C.POINTER(C.c_uint32)) if len(cps) else None
        return bool(self._lib.decoder_quick_check(p, len(cps), form))

    def find_word_boundaries(self, cps, classes) -> np.ndarray:
        """GPT-4-style word-start mask — the native rule engine
        (decoder_find_word_boundaries; the reference's CPU hot loop #1)."""
        cps = np.ascontiguousarray(np.asarray(cps, dtype=np.uint32))
        classes = np.ascontiguousarray(np.asarray(classes, dtype=np.uint8))
        out = np.zeros(len(cps), dtype=np.uint8)
        if len(cps):
            self._lib.decoder_find_word_boundaries(
                cps.ctypes.data_as(C.POINTER(C.c_uint32)),
                classes.ctypes.data_as(C.POINTER(C.c_uint8)),
                len(cps),
                out.ctypes.data_as(C.POINTER(C.c_uint8)),
            )
        return out

    def byte_word_starts(self, offsets, cp_starts, n_bytes: int) -> np.ndarray:
        """Scatter codepoint-level word starts to a byte-level mask through
        the UTF-8 byte offsets (native; out-of-range offsets dropped)."""
        offsets = np.ascontiguousarray(np.asarray(offsets, dtype=np.uint32))
        cp_starts = np.ascontiguousarray(np.asarray(cp_starts, dtype=np.uint8))
        out = np.zeros(n_bytes, dtype=np.uint8)
        if len(offsets) and n_bytes:
            self._lib.decoder_byte_word_starts(
                offsets.ctypes.data_as(C.POINTER(C.c_uint32)),
                cp_starts.ctypes.data_as(C.POINTER(C.c_uint8)),
                len(offsets),
                out.ctypes.data_as(C.POINTER(C.c_uint8)),
                n_bytes,
            )
        return out

    def get_script_name(self, script_id: int) -> str:
        return self._lib.decoder_get_script_name(script_id).decode()

    def get_block_name(self, cp: int) -> str:
        """Reference ABI: takes a codepoint, returns the UCD block
        display name ("Latin-1 Supplement")."""
        return self._lib.decoder_get_block_name(cp).decode()

    def get_block_id_name(self, block_id: int) -> str:
        return self._lib.decoder_get_block_id_name(block_id).decode()
