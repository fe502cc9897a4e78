"""UTF-8 transcoding helpers with the reference's lenient semantics (the
port's own copy of ``gpu_bpe_tpu/unicode/utf8.py``).

The reference decodes UTF-8 without validation: lead-byte size classes are
<0x80 -> 1, 0xC0-0xDF -> 2, 0xE0-0xEF -> 3, everything else (stray
continuation bytes included) -> 4. For valid UTF-8 this is a normal
decoder; for invalid input the quirk is part of the conformance surface
(the byte path runs it on raw bytes whenever normalization fails).
"""

from __future__ import annotations

import numpy as np


def utf8_byte_length(cp: int) -> int:
    """Encoded UTF-8 length of one codepoint."""
    if cp <= 0x7F:
        return 1
    if cp <= 0x7FF:
        return 2
    if cp <= 0xFFFF:
        return 3
    return 4


def utf8_byte_lengths(cps: np.ndarray) -> np.ndarray:
    """Encoded UTF-8 length of each codepoint (``utf8_byte_length`` over an
    array)."""
    cps = np.asarray(cps, dtype=np.int64)
    return (1 + (cps > 0x7F).astype(np.int64) + (cps > 0x7FF) + (cps > 0xFFFF)).astype(np.int64)


def _lenient_decode_loop(data: bytes) -> np.ndarray:
    """Sequential lenient decoder (the reference's utf8ToCodepoints)."""
    n = len(data)
    out = np.empty(n, dtype=np.uint32)
    count = 0
    i = 0
    while i < n:
        b = data[i]
        if b < 0x80:
            cp = b
            size = 1
        elif (b & 0xE0) == 0xC0:
            cp = ((b & 0x1F) << 6) | (data[i + 1] & 0x3F if i + 1 < n else 0)
            size = 2
        elif (b & 0xF0) == 0xE0:
            cp = (
                ((b & 0x0F) << 12)
                | ((data[i + 1] & 0x3F) << 6 if i + 1 < n else 0)
                | (data[i + 2] & 0x3F if i + 2 < n else 0)
            )
            size = 3
        else:
            cp = (
                ((b & 0x07) << 18)
                | ((data[i + 1] & 0x3F) << 12 if i + 1 < n else 0)
                | ((data[i + 2] & 0x3F) << 6 if i + 2 < n else 0)
                | (data[i + 3] & 0x3F if i + 3 < n else 0)
            )
            size = 4
        out[count] = cp
        count += 1
        i += size
    return out[:count]


def utf8_to_codepoints(data: bytes) -> np.ndarray:
    """UTF-8 bytes -> codepoints (uint32): vectorized for valid input, the
    sequential lenient decoder for invalid input."""
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    n = len(buf)
    if n == 0:
        return np.empty(0, dtype=np.uint32)

    start_idx = np.flatnonzero((buf & 0xC0) != 0x80)
    lead = buf[start_idx].astype(np.uint32)
    size = np.where(
        lead < 0x80, 1, np.where((lead & 0xE0) == 0xC0, 2, np.where((lead & 0xF0) == 0xE0, 3, 4))
    )
    # valid iff each lead's span covers exactly the continuation bytes up to
    # the next lead (and the last span ends at the buffer's end)
    next_start = np.empty_like(start_idx)
    next_start[:-1] = start_idx[1:]
    next_start[-1] = n
    if not np.array_equal(start_idx + size, next_start):
        return _lenient_decode_loop(bytes(data))

    cont = (buf & 0x3F).astype(np.uint32)

    def _at(offset: int) -> np.ndarray:
        return cont[np.minimum(start_idx + offset, n - 1)]

    two = ((lead & np.uint32(0x1F)) << np.uint32(6)) | _at(1)
    three = ((lead & np.uint32(0x0F)) << np.uint32(12)) | (_at(1) << np.uint32(6)) | _at(2)
    four = (
        ((lead & np.uint32(0x07)) << np.uint32(18))
        | (_at(1) << np.uint32(12))
        | (_at(2) << np.uint32(6))
        | _at(3)
    )
    cp = np.where(size == 1, lead, 0).astype(np.uint32)
    cp = np.where(size == 2, two, cp)
    cp = np.where(size == 3, three, cp)
    cp = np.where(size == 4, four, cp)
    return cp.astype(np.uint32)


def codepoints_to_utf8(cps: np.ndarray) -> bytes:
    """Codepoints -> UTF-8 bytes (surrogates pass through as their 3-byte
    forms)."""
    cps = np.asarray(cps, dtype=np.uint32)
    return "".join(chr(int(c)) for c in cps).encode("utf-8", errors="surrogatepass")
