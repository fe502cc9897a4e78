"""Trie compiler: vocab (byte sequences) → flat BFS trie → v3 binary.

The port's own copy of ``gpu_bpe_tpu/trie/compile.py``, byte-for-byte
compatible with the reference's trie artifact format:

* Header (28 bytes): magic 'TRIE', version=3, nodeCount, edgeCount,
  maxTokenLen, vocabSize, flags — all little-endian u32.
* Nodes (12 B each): [firstChild u32, numChildren u32, tokenId u32].
* Edges (8 B each):  [symbol u8 + 3 pad, targetNode u32].

Nodes are flattened breadth-first with children sorted by byte value (the
reference requires this for its binary-search lookup; we keep it so compiled
artifacts are interchangeable). Duplicate byte sequences in the vocab resolve
to the LAST token id (trie.js:56 overwrites).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ..constants import INVALID_TOKEN, TRIE_HEADER_SIZE, TRIE_MAGIC, TRIE_SUPPORTED_VERSIONS, TRIE_VERSION


@dataclass
class TrieHeader:
    version: int
    node_count: int
    edge_count: int
    max_token_len: int
    vocab_size: int = 0
    flags: int = 0


@dataclass
class FlatTrie:
    """Flat trie arrays: nodes as u32[N,3], edges as u32[E,2]."""

    nodes: np.ndarray  # [N, 3]: firstChild, numChildren, tokenId
    edges: np.ndarray  # [E, 2]: symbol, targetNode
    max_token_len: int
    vocab_size: int


def build_flat_trie(vocab: list[bytes]) -> FlatTrie:
    """Build the BFS-flattened trie from a vocabulary of byte sequences."""
    # In-memory tree: dict children keyed by byte, token id payload.
    root: dict = {"children": {}, "token": INVALID_TOKEN}
    max_token_len = 0
    for token_id, entry in enumerate(vocab):
        entry = bytes(entry)
        if not entry:
            continue
        node = root
        for byte in entry:
            child = node["children"].get(byte)
            if child is None:
                child = {"children": {}, "token": INVALID_TOKEN}
                node["children"][byte] = child
            node = child
        node["token"] = token_id  # later duplicates overwrite (trie.js:56)
        max_token_len = max(max_token_len, len(entry))

    # BFS flatten with children sorted by symbol.
    flat_nodes: list[tuple[int, int, int]] = []
    flat_edges: list[tuple[int, int]] = []
    queue = [root]
    head = 0
    flat_nodes.append((0, 0, 0))  # placeholder for root
    while head < len(queue):
        tree_node = queue[head]
        my_index = head
        head += 1
        entries = sorted(tree_node["children"].items())
        first_child = len(flat_edges)
        for symbol, child in entries:
            child_index = len(queue)
            queue.append(child)
            flat_nodes.append((0, 0, 0))
            flat_edges.append((symbol, child_index))
        flat_nodes[my_index] = (first_child, len(entries), tree_node["token"])

    nodes = np.array(flat_nodes, dtype=np.uint32).reshape(-1, 3)
    edges = (
        np.array(flat_edges, dtype=np.uint32).reshape(-1, 2)
        if flat_edges
        else np.zeros((0, 2), dtype=np.uint32)
    )
    return FlatTrie(nodes=nodes, edges=edges, max_token_len=max_token_len, vocab_size=len(vocab))


def serialize_trie(trie: FlatTrie) -> bytes:
    """FlatTrie → v3 binary (trie.js:166-206)."""
    node_count = len(trie.nodes)
    edge_count = len(trie.edges)
    header = struct.pack(
        "<7I",
        TRIE_MAGIC,
        TRIE_VERSION,
        node_count,
        edge_count,
        trie.max_token_len,
        trie.vocab_size,
        0,
    )
    node_bytes = trie.nodes.astype("<u4").tobytes()
    edge_buf = np.zeros((edge_count, 2), dtype="<u4")
    if edge_count:
        edge_buf[:, 0] = trie.edges[:, 0] & 0xFF  # symbol u8 + 3 pad bytes
        edge_buf[:, 1] = trie.edges[:, 1]
    return header + node_bytes + edge_buf.tobytes()


def compile_vocab_to_trie(vocab: list[bytes]) -> bytes:
    """vocab → v3 binary trie (compileVocabToTrie, trie.js:39-98)."""
    return serialize_trie(build_flat_trie(vocab))


def parse_header(data: bytes) -> TrieHeader:
    """Parse + validate the binary header (trie.js:110-128)."""
    if len(data) < TRIE_HEADER_SIZE:
        raise ValueError(f"trie blob too short for a header ({len(data)} bytes)")
    magic, version, node_count, edge_count, max_token_len, vocab_size, flags = struct.unpack(
        "<7I", data[:TRIE_HEADER_SIZE]
    )
    if magic != TRIE_MAGIC:
        raise ValueError(f"not a trie blob (magic word 0x{magic:08x} != 'TRIE')")
    if version not in TRIE_SUPPORTED_VERSIONS:
        raise ValueError(f"trie format v{version} not supported (have: v2, v3)")
    return TrieHeader(
        version=version,
        node_count=node_count,
        edge_count=edge_count,
        max_token_len=max_token_len,
        vocab_size=vocab_size,
        flags=flags,
    )


def parse_trie(data: bytes, header: TrieHeader | None = None) -> FlatTrie:
    """Binary trie → flat arrays; supports v3 and legacy v2 (trie.js:137-160)."""
    header = header or parse_header(data)
    bytes_per_node = 12 if header.version == 3 else 8
    bytes_per_edge = 8 if header.version == 3 else 4
    node_bytes = header.node_count * bytes_per_node
    edge_bytes = header.edge_count * bytes_per_edge
    if len(data) < TRIE_HEADER_SIZE + node_bytes + edge_bytes:
        raise ValueError(
            f"trie blob ends mid-table: header promises {header.node_count} nodes"
            f" + {header.edge_count} edges but only {len(data)} bytes present"
        )

    node_view = data[TRIE_HEADER_SIZE : TRIE_HEADER_SIZE + node_bytes]
    edge_view = data[TRIE_HEADER_SIZE + node_bytes : TRIE_HEADER_SIZE + node_bytes + edge_bytes]

    if header.version == 3:
        nodes = np.frombuffer(node_view, dtype="<u4").reshape(-1, 3).astype(np.uint32)
        raw_edges = np.frombuffer(edge_view, dtype="<u4").reshape(-1, 2)
        edges = np.stack([raw_edges[:, 0] & 0xFF, raw_edges[:, 1]], axis=1).astype(np.uint32)
    else:  # v2: u16 fields, 0xFFFF token sentinel
        raw_nodes = np.frombuffer(node_view, dtype="<u2").reshape(-1, 4)
        nodes = raw_nodes[:, :3].astype(np.uint32)
        nodes[:, 2] = np.where(nodes[:, 2] == 0xFFFF, INVALID_TOKEN, nodes[:, 2])
        raw_edges = np.frombuffer(edge_view, dtype="<u2").reshape(-1, 2)
        edges = np.stack([raw_edges[:, 0] & 0xFF, raw_edges[:, 1]], axis=1).astype(np.uint32)

    return FlatTrie(
        nodes=nodes,
        edges=edges,
        max_token_len=header.max_token_len,
        vocab_size=header.vocab_size,
    )
