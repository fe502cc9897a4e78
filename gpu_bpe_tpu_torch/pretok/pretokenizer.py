"""PreTokenizer: NFC normalization + classification + word-start masks (the
port's own copy of ``gpu_bpe_tpu/pretok/pretokenizer.py``).

* ``pre_tokenize(text)``: string path: NFC -> classify -> boundaries ->
  UTF-8 encode with the codepoint -> byte boundary mapping;
* ``pre_tokenize_bytes(data)``: byte path: NFC over bytes -> lenient UTF-8
  decode -> classify -> boundaries -> byte-level mask.

Both return ``(bytes, word_starts)``, ``word_starts`` a parallel uint8 mask
(1 = word start). As in the reference, raw input is used when normalization
fails or returns nothing.
"""

from __future__ import annotations

import logging

import numpy as np

from ..unicode import get_backend, utf8_byte_lengths, utf8_to_codepoints
from .boundaries import find_word_boundaries

logger = logging.getLogger(__name__)

_EMPTY = (b"", np.zeros(0, dtype=np.uint8))


class PreTokenizer:
    """GPT-4-style word boundary detection over Unicode property tables."""

    def __init__(self, backend=None):
        self.backend = backend or get_backend()
        # the native rule engine when there is one (same output as the numpy one)
        self._boundaries = getattr(self.backend, "find_word_boundaries", None) or find_word_boundaries

    def pre_tokenize(self, text: str) -> tuple[bytes, np.ndarray]:
        if not text:
            return _EMPTY
        try:
            normalized = self.backend.normalize(text, "NFC")
        except Exception as e:  # noqa: BLE001 (the reference's fallback)
            logger.warning("PreTokenizer: normalize failed, using raw text: %s", e)
            normalized = text
        if not normalized:
            logger.warning("PreTokenizer: normalize returned empty string, using raw text")
            normalized = text

        cps = np.array([ord(c) for c in normalized], dtype=np.uint32)
        cp_starts = self._boundaries(cps, self.backend.classify_codepoints(cps))
        data = normalized.encode("utf-8")
        offsets = np.concatenate([[0], np.cumsum(utf8_byte_lengths(cps))[:-1]])
        word_starts = np.zeros(len(data), dtype=np.uint8)
        word_starts[offsets[cp_starts.astype(bool)]] = 1
        return data, word_starts

    def pre_tokenize_bytes(self, data: bytes) -> tuple[bytes, np.ndarray]:
        data = bytes(data)
        if not data:
            return _EMPTY

        # fused native path: NFC + classify + byte offsets in one pass, the
        # same result as the staged path below
        prepare = getattr(self.backend, "pretokenize_prepare", None)
        if prepare is not None:
            try:
                # the pooled scratch views are consumed before this returns
                normalized, cps, classes, offsets = prepare(data)
                if normalized:
                    cp_starts = self._boundaries(cps, classes)
                    return normalized, self.backend.byte_word_starts(offsets, cp_starts, len(normalized))
            except UnicodeDecodeError:
                pass  # invalid UTF-8: the staged path with its raw-bytes fallback

        try:
            normalized = self.backend.normalize_bytes(data, "NFC")
        except Exception as e:  # noqa: BLE001
            logger.warning("PreTokenizer: normalize_bytes failed, using raw bytes: %s", e)
            normalized = data
        if not normalized:
            logger.warning("PreTokenizer: normalize_bytes returned empty, using raw bytes")
            normalized = data

        cps = utf8_to_codepoints(normalized)
        cp_starts = self._boundaries(cps, self.backend.classify_codepoints(cps))
        # codepoint -> byte mapping through the DECODED codepoints' lengths,
        # as the reference maps it: for invalid input it may drift, and
        # out-of-range writes are dropped
        offsets = np.concatenate([[0], np.cumsum(utf8_byte_lengths(cps))[:-1]])
        word_starts = np.zeros(len(normalized), dtype=np.uint8)
        sel = offsets[cp_starts.astype(bool)]
        word_starts[sel[sel < len(normalized)]] = 1
        return normalized, word_starts
