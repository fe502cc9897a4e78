"""Trie compiler: vocab -> flat BFS trie -> the v3 binary artifact."""

from .compile import build_flat_trie, compile_vocab_to_trie, parse_header, parse_trie, serialize_trie

__all__ = ["build_flat_trie", "compile_vocab_to_trie", "parse_header", "parse_trie", "serialize_trie"]
