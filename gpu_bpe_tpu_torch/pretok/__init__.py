"""Pre-tokenization: the Unicode pre-tokenizer (``PreTokenizer``, the
default of ``api.train``) and the byte-heuristic word boundaries."""

from .boundaries import find_word_boundaries
from .byte_fallback import byte_char_class, byte_word_starts, tag_word_boundaries_bytes
from .pretokenizer import PreTokenizer

__all__ = [
    "PreTokenizer",
    "byte_char_class",
    "byte_word_starts",
    "find_word_boundaries",
    "tag_word_boundaries_bytes",
]
