"""ctypes binding of the native decoder, trimmed to the pre-tokenize surface
(the port's own copy of that part of ``gpu_bpe_tpu/unicode/cpp_backend.py``):
NFC normalization, batch classification, the fused ``pretokenize_prepare``
(NFC + classify + byte offsets in one native pass, into a pooled scratch), the word-boundary rule
engine and the byte-level word-start scatter. The library is built from
this package's ``cpp/`` sources (``cpp/build.py``).
"""

from __future__ import annotations

import ctypes as C

import numpy as np

from .fallback import PyUnicodeBackend

_U8P = C.POINTER(C.c_uint8)
_U32P = C.POINTER(C.c_uint32)
_FORMS = {"NFC": 0, "NFD": 1, "NFKC": 2, "NFKD": 3}


def _load():
    from .cpp.build import build

    lib = C.CDLL(str(build()))
    lib.decoder_init.argtypes = []
    lib.decoder_init.restype = C.c_int
    lib.decoder_normalize_utf8.argtypes = [C.c_char_p, C.c_int64, C.c_int, _U8P, C.c_int64,
                                           C.POINTER(C.c_int64)]
    lib.decoder_normalize_utf8.restype = C.c_int
    lib.decoder_classify_utf32.argtypes = [_U32P, C.c_int64, _U8P]
    lib.decoder_classify_utf32.restype = None
    lib.decoder_pretokenize_prepare.argtypes = [
        C.c_char_p, C.c_int64, _U8P, C.c_int64, C.POINTER(C.c_int64),
        _U32P, _U8P, _U32P, C.c_int64, C.POINTER(C.c_int64),
    ]
    lib.decoder_pretokenize_prepare.restype = C.c_int
    lib.decoder_find_word_boundaries.argtypes = [_U32P, _U8P, C.c_int64, _U8P]
    lib.decoder_find_word_boundaries.restype = None
    lib.decoder_byte_word_starts.argtypes = [_U32P, _U8P, C.c_int64, _U8P, C.c_int64]
    lib.decoder_byte_word_starts.restype = None
    lib.decoder_init()
    return lib


class CppUnicodeBackend(PyUnicodeBackend):
    """Native backend: the pre-tokenizer's hot paths in C++."""

    name = "cpp-decoder"

    def __init__(self):
        self._lib = _load()
        self._prep_pool = None

    def normalize_bytes(self, data: bytes, form: int | str = "NFC") -> bytes:
        data = bytes(data)
        if isinstance(form, str):
            form = _FORMS[form]
        # K-form expansions can be long (U+FDFA -> 18 codepoints, 33 UTF-8
        # bytes from a 3-byte input); the capacity covers the worst case
        cap = len(data) * 12 + 64
        out = np.empty(cap, dtype=np.uint8)
        out_len = C.c_int64(0)
        rc = self._lib.decoder_normalize_utf8(data, len(data), form, out.ctypes.data_as(_U8P), cap,
                                              C.byref(out_len))
        if rc == -3:
            raise UnicodeDecodeError("utf-8", data, 0, 1, "invalid UTF-8 (native decoder)")
        if rc != 0:
            raise RuntimeError(f"decoder_normalize_utf8 failed: {rc}")
        return out[: out_len.value].tobytes()

    def normalize(self, text: str, form: int | str = "NFC") -> str:
        return self.normalize_bytes(text.encode("utf-8"), form).decode("utf-8")

    def classify_codepoints(self, codepoints) -> np.ndarray:
        cps = np.ascontiguousarray(np.asarray(codepoints, dtype=np.uint32))
        out = np.empty(len(cps), dtype=np.uint8)
        if len(cps):
            self._lib.decoder_classify_utf32(cps.ctypes.data_as(_U32P), len(cps), out.ctypes.data_as(_U8P))
        return out

    def pretokenize_prepare(self, data: bytes):
        """Fused NFC + classify + offsets: (normalized bytes, codepoints,
        classes, byte offsets). Raises on invalid UTF-8 (callers take the
        staged path).

        The three codepoint arrays are views into a grow-only scratch pool
        that the next call overwrites: the caller consumes them before the
        next call (the pre-tokenizer does), which saves touching fresh
        pages on every call."""
        data = bytes(data)
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
                data, len(data), out.ctypes.data_as(_U8P), cap, C.byref(out_len),
                cps.ctypes.data_as(_U32P), classes.ctypes.data_as(_U8P), offsets.ctypes.data_as(_U32P),
                cap, C.byref(cp_count),
            )
            if rc != -2:
                break
        if rc == -3:
            raise UnicodeDecodeError("utf-8", data, 0, 1, "invalid UTF-8 (native decoder)")
        if rc != 0:
            raise RuntimeError(f"decoder_pretokenize_prepare failed: {rc}")
        n = cp_count.value
        return out[: out_len.value].tobytes(), cps[:n], classes[:n], offsets[:n]

    def find_word_boundaries(self, cps, classes) -> np.ndarray:
        """Codepoint-level word-start mask (the native rule engine)."""
        cps = np.ascontiguousarray(np.asarray(cps, dtype=np.uint32))
        classes = np.ascontiguousarray(np.asarray(classes, dtype=np.uint8))
        out = np.zeros(len(cps), dtype=np.uint8)
        if len(cps):
            self._lib.decoder_find_word_boundaries(cps.ctypes.data_as(_U32P), classes.ctypes.data_as(_U8P),
                                                   len(cps), out.ctypes.data_as(_U8P))
        return out

    def byte_word_starts(self, offsets, cp_starts, n_bytes: int) -> np.ndarray:
        """Scatter codepoint-level word starts to a byte-level mask through
        the UTF-8 byte offsets (out-of-range offsets dropped)."""
        offsets = np.ascontiguousarray(np.asarray(offsets, dtype=np.uint32))
        cp_starts = np.ascontiguousarray(np.asarray(cp_starts, dtype=np.uint8))
        out = np.zeros(n_bytes, dtype=np.uint8)
        if len(offsets) and n_bytes:
            self._lib.decoder_byte_word_starts(offsets.ctypes.data_as(_U32P), cp_starts.ctypes.data_as(_U8P),
                                               len(offsets), out.ctypes.data_as(_U8P), n_bytes)
        return out
