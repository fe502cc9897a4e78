"""ctypes binding of the native ingest library (``ops/cpp/ingest.cpp``, the
port's own copy, built with g++ by ``utils/build.py`` into
``gpu_bpe_tpu_torch/_build/`` at first use).

``native_dedup`` is the fast path of ``make_stream(dedup=True)`` and
``NativeAccumulator`` that of ``StreamAccumulator``: one hash pass over the
words instead of numpy's length-bucketed sorts, with output bitwise equal
to the numpy path (``ingest.numpy_dedup``). This is host code. Where the
library does not build or load (a host without g++) the numpy path runs,
with a logged warning, as the Unicode backend does; ``native_available()``
says which path runs.
"""

from __future__ import annotations

import ctypes
import functools
import logging
from pathlib import Path

import numpy as np

from ..utils.build import Library, load

logger = logging.getLogger(__name__)

_P = ctypes.c_void_p
_I = ctypes.c_int64
LIBRARY = Library(
    name="ingest",
    source=Path(__file__).resolve().parent / "cpp" / "ingest.cpp",
    flags=("-O3", "-shared", "-fPIC", "-std=c++17"),
    entries={
        "ingest_dedup": (_I, [_P, _P, _I, ctypes.c_uint32, _P, _P, _I, _P]),
        "ingest_acc_new": (_P, []),
        "ingest_acc_add": (_I, [_P, _P, _P, _I]),
        "ingest_acc_unique_bytes": (_I, [_P]),
        "ingest_acc_finish": (_I, [_P, ctypes.c_uint32, _P, _P, _I, _P]),
        "ingest_acc_free": (None, [_P]),
    },
)


@functools.cache
def _raw_lib():
    """The loaded library with its entry points declared, or None when it
    does not build or load."""
    try:
        return load([LIBRARY])["ingest"]
    except Exception as e:  # noqa: BLE001 (no g++, or a failed build)
        logger.warning("native ingest unavailable (%s); using the numpy path", e)
        return None


def _lib():
    lib = _raw_lib()
    return lib.ingest_dedup if lib is not None else None


def native_available() -> bool:
    """True when the native library runs the dedup, False when numpy does."""
    return _raw_lib() is not None


class NativeAccumulator:
    """Incremental unique-word dedup over chunked ingestion: the C++ hash
    table and byte arena persist across chunks (host memory bounded by the
    unique-word mass)."""

    def __init__(self):
        lib = _raw_lib()
        if lib is None:
            raise RuntimeError("native ingest unavailable")
        self._libref = lib
        self._h = lib.ingest_acc_new()
        if not self._h:
            raise MemoryError("ingest_acc_new failed")
        self.total = 0

    def add_chunk(self, bytes_arr: np.ndarray, starts_u8: np.ndarray) -> None:
        n = len(bytes_arr)
        if n == 0:
            return
        data = np.ascontiguousarray(bytes_arr, np.uint8)
        starts = np.ascontiguousarray(starts_u8, np.uint8)
        rc = self._libref.ingest_acc_add(self._h, data.ctypes.data, starts.ctypes.data, n)
        if rc != 0:
            raise MemoryError(f"ingest_acc_add rc={rc}")
        self.total += n

    def finish(self, ws_bit: int):
        """(symbols u32, weights i32, total_unique); frees the handle."""
        lib = self._libref
        cap = lib.ingest_acc_unique_bytes(self._h)
        out_syms = np.empty(max(cap, 1), np.uint32)
        out_wts = np.empty(max(cap, 1), np.int32)
        out_n = ctypes.c_int64(0)
        rc = lib.ingest_acc_finish(self._h, ws_bit, out_syms.ctypes.data, out_wts.ctypes.data, cap,
                                   ctypes.addressof(out_n))
        self.close()
        assert rc != -2, "word frequency overflows int32"
        if rc != 0:
            raise RuntimeError(f"ingest_acc_finish rc={rc}")
        k = out_n.value
        return out_syms[:k], out_wts[:k], k

    def close(self) -> None:
        if self._h:
            self._libref.ingest_acc_free(self._h)
            self._h = None

    def __del__(self):
        self.close()


def native_dedup(bytes_arr: np.ndarray, starts_bool: np.ndarray, ws_bit: int):
    """(symbols u32, weights i32, total_unique), or None when the library is
    unavailable (the caller runs the numpy path).

    Raises AssertionError on int32 weight overflow (the numpy path's
    assert)."""
    fn = _lib()
    if fn is None:
        return None
    n = len(bytes_arr)
    data = np.ascontiguousarray(bytes_arr, np.uint8)
    starts = np.ascontiguousarray(starts_bool, np.uint8)
    out_syms = np.empty(n, np.uint32)
    out_wts = np.empty(n, np.int32)
    out_n = ctypes.c_int64(0)
    rc = fn(data.ctypes.data, starts.ctypes.data, n, ws_bit, out_syms.ctypes.data, out_wts.ctypes.data, n,
            ctypes.addressof(out_n))
    assert rc != -2, "word frequency overflows int32"
    if rc != 0:
        raise RuntimeError(f"ingest_dedup rc={rc}")
    k = out_n.value
    # copy: the stream outlives this call and is a dedup factor smaller
    return out_syms[:k].copy(), out_wts[:k].copy(), k
