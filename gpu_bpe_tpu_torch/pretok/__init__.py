"""Pre-tokenization: the byte-heuristic word boundaries (the Unicode
pre-tokenizer is not ported yet)."""

from .byte_fallback import byte_char_class, byte_word_starts, tag_word_boundaries_bytes

__all__ = ["byte_char_class", "byte_word_starts", "tag_word_boundaries_bytes"]
