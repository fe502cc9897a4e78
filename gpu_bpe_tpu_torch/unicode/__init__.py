"""The Unicode library: the reference decoder's API (property predicates,
case maps, the four normalization forms, scripts, blocks, identifier sets,
confusables, sanitizing, UTF-8/16/32 transcoding, UAX #29 segmentation)
and the pre-tokenizer's batch classification, in two implementations with
one interface:

* ``cpp-decoder``: the native decoder (``cpp/decoder.cpp``), built with g++
  into ``gpu_bpe_tpu_torch/_build/`` at first use; the hot path;
* ``python-unicodedata``: pure Python over ``unicodedata`` and the
  reference's property data, for hosts without g++.

``get_backend()`` returns the native one when it builds, logs which one it
took, and ``backend_name()`` says which. The reference-compat Hangul mode
(``set_ref_hangul``, or ``GPU_BPE_TPU_REF_HANGUL`` set before the backend is
created) leaves Hangul syllables and conjoining jamo unnormalized, as the
reference does; the pre-tokenizer, and so training, follows it. The
optional ``regex`` module gives the Python backend the exact UAX #29 word
and sentence rules (``segmentation``).
"""

from __future__ import annotations

import logging

from .fallback import CharClass, PyUnicodeBackend, class_table
from .utf8 import utf8_byte_length, utf8_byte_lengths, utf8_to_codepoints

logger = logging.getLogger(__name__)

_BACKEND = None


def get_backend():
    """The native backend if it builds and loads, else the Python one."""
    global _BACKEND
    if _BACKEND is None:
        try:
            from .cpp_backend import CppUnicodeBackend

            _BACKEND = CppUnicodeBackend()
        except Exception as e:  # noqa: BLE001 (no g++, or a failed build)
            logger.warning("native Unicode decoder unavailable (%s); using the Python backend", e)
            _BACKEND = PyUnicodeBackend()
        logger.info("Unicode backend: %s", _BACKEND.name)
    return _BACKEND


def backend_name() -> str:
    """Name of the backend ``get_backend()`` returns."""
    return get_backend().name


__all__ = [
    "CharClass",
    "PyUnicodeBackend",
    "backend_name",
    "class_table",
    "get_backend",
    "utf8_byte_length",
    "utf8_byte_lengths",
    "utf8_to_codepoints",
]
