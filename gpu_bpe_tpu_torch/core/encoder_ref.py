"""CPU reference encoders (numpy only): the port's own copy of
``encode_merge_order``, ``GreedyTrieEncoder`` and ``decode_tokens`` from
``gpu_bpe_tpu/core/encoder_ref.py``.

* ``encode_merge_order``: exact BPE semantics, each learned merge applied
  over the token list in training order (``BPETokenizer.encode``);
* ``GreedyTrieEncoder``: greedy longest match over fixed-size chunks, with
  the token-split-at-chunk-boundary artifact and the raw-byte fallback for
  unmatched bytes; ``Tokenizer.encode_bytes`` is held to it.
"""

from __future__ import annotations

import numpy as np

from ..constants import adaptive_chunk_size

UTF8_REPLACEMENT = bytes([0xEF, 0xBF, 0xBD])  # U+FFFD


def encode_merge_order(
    data: bytes,
    merges: list[tuple[int, int, int]],
    byte_ids: list[int] | None = None,
) -> list[int]:
    """Apply merges in training order over the byte stream.

    Semantics: one pass per merge rule, left-to-right, non-overlapping within
    the pass. Implemented as lowest-rank-first
    with leftmost tie-break over a linked token list — O(n log n) instead of
    the reference's O(merges*n), which produces IDENTICAL output: a merge at
    rank r only creates adjacencies involving its output token, and any rule
    consuming that token has rank > r, so no earlier rule ever becomes newly
    applicable.

    ``byte_ids`` maps each initial byte to its token id for vocabularies
    (e.g. imported HF byte-level BPE) where the single-byte tokens are not at
    ids 0-255; bytes with no single-byte token (entry -1) keep the raw byte
    value, matching the trie walk's raw-byte fallback.
    """
    if byte_ids is None:
        tokens = list(bytes(data))
    else:
        tokens = [byte_ids[b] if byte_ids[b] >= 0 else b for b in bytes(data)]
    n = len(tokens)
    if n < 2 or not merges:
        return tokens

    import heapq

    # First rule wins for a repeated (a,b) pair: by the time a later
    # duplicate rule runs, the earlier one already consumed every site,
    # and sites formed afterwards involve tokens the earlier rule's pass
    # no longer sees — but those sites match the EARLIER rank in
    # lowest-rank-first order too, so keeping the first occurrence is
    # exactly the sequential-pass behavior.
    rules: dict[tuple[int, int], tuple[int, int]] = {}
    for rank, (a, b, new_id) in enumerate(merges):
        rules.setdefault((a, b), (rank, new_id))

    nxt = list(range(1, n)) + [-1]
    prv = [-1] + list(range(n - 1))
    alive = [True] * n

    heap: list[tuple[int, int]] = []
    for i in range(n - 1):
        r = rules.get((tokens[i], tokens[i + 1]))
        if r is not None:
            heap.append((r[0], i))
    heapq.heapify(heap)

    while heap:
        rank, i = heapq.heappop(heap)
        if not alive[i]:
            continue
        j = nxt[i]
        if j < 0:
            continue
        r = rules.get((tokens[i], tokens[j]))
        if r is None or r[0] != rank:
            continue  # stale entry: the pair at i changed since it was pushed
        tokens[i] = r[1]
        alive[j] = False
        k = nxt[j]
        nxt[i] = k
        if k >= 0:
            prv[k] = i
            nr = rules.get((tokens[i], tokens[k]))
            if nr is not None:
                heapq.heappush(heap, (nr[0], i))
        p = prv[i]
        if p >= 0:
            pr = rules.get((tokens[p], tokens[i]))
            if pr is not None:
                heapq.heappush(heap, (pr[0], p))
    return [t for t, a in zip(tokens, alive) if a]


class GreedyTrieEncoder:
    """Chunked greedy longest-match encoder (CPU reference for the device path)."""

    def __init__(self, vocab: list[bytes], chunk_size: int | None = None):
        self.vocab = [bytes(v) for v in vocab]
        # Duplicate byte sequences resolve to the LAST id.
        self.token_map: dict[bytes, int] = {}
        self.max_token_len = 0
        for token_id, entry in enumerate(self.vocab):
            if not entry:
                continue
            self.token_map[entry] = token_id
            self.max_token_len = max(self.max_token_len, len(entry))
        self.chunk_size = chunk_size or adaptive_chunk_size(self.max_token_len)

    def encode(self, data: bytes) -> np.ndarray:
        """Greedy longest-match per chunk; returns uint32 token ids."""
        data = bytes(data)
        n = len(data)
        out: list[int] = []
        token_map = self.token_map
        max_len = self.max_token_len
        cs = self.chunk_size
        for chunk_start in range(0, n, cs):
            chunk_end = min(chunk_start + cs, n)
            pos = chunk_start
            while pos < chunk_end:
                best_id = -1
                best_end = pos
                limit = min(pos + max_len, chunk_end)
                # longest match wins; scan down from the longest candidate
                for end in range(limit, pos, -1):
                    tid = token_map.get(data[pos:end])
                    if tid is not None:
                        best_id = tid
                        best_end = end
                        break
                if best_id >= 0:
                    out.append(best_id)
                    pos = best_end
                else:
                    out.append(data[pos])  # raw byte fallback
                    pos += 1
        return np.array(out, dtype=np.uint32)


def decode_tokens(tokens, vocab: list[bytes]) -> bytes:
    """Token ids -> bytes; unknown ids become U+FFFD."""
    parts = []
    vocab_len = len(vocab)
    for t in np.asarray(tokens).tolist():
        if 0 <= t < vocab_len and len(vocab[t]) > 0:
            parts.append(bytes(vocab[t]))
        else:
            parts.append(UTF8_REPLACEMENT)
    return b"".join(parts)
