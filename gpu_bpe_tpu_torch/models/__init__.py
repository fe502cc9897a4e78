"""Trained-model wrappers: the user-facing tokenizer object."""

from .bpe import BPETokenizer

__all__ = ["BPETokenizer"]
