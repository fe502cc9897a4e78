"""Trie compiler: vocab -> flat BFS trie -> the v3 binary artifact."""

from .compile import (
    FlatTrie,
    TrieHeader,
    build_flat_trie,
    compile_vocab_to_trie,
    parse_header,
    parse_trie,
    serialize_trie,
)

__all__ = [
    "FlatTrie",
    "TrieHeader",
    "build_flat_trie",
    "compile_vocab_to_trie",
    "parse_header",
    "parse_trie",
    "serialize_trie",
]
