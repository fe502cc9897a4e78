"""CPU reference encoder of the chunked greedy tokenizer (numpy only).

The port's own copy of ``GreedyTrieEncoder`` and ``decode_tokens`` from
``gpu_bpe_tpu/core/encoder_ref.py:134-189``: greedy longest match over
fixed-size chunks, with the token-split-at-chunk-boundary artifact and the
raw-byte fallback for unmatched bytes. ``Tokenizer.encode_bytes`` is held
to it.
"""

from __future__ import annotations

import numpy as np

from ..constants import adaptive_chunk_size

UTF8_REPLACEMENT = bytes([0xEF, 0xBF, 0xBD])  # U+FFFD


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
