"""Framework-wide constants (the port's own copy of ``gpu_bpe_tpu.constants``).

Token ids are 16-bit, bit 16 of a u32 symbol is the word-start flag, and the
pair id packing ``(a << 16) | b`` defines the deterministic tie-break order.
"""

# Bit 16 of a u32 symbol marks the start of a pre-tokenized word.
WORD_START_BIT = 0x10000

# Lower 16 bits of a symbol are the token id -> max vocab 65,536.
TOKEN_MASK = 0xFFFF

# Maximum merges performed per device->host round trip (one merge-log read).
BATCH_MERGES = 1024

# Merge log stride: [pair, new_token_id, count] per merge.
MERGE_LOG_STRIDE = 3


def pack_pair(a: int, b: int) -> int:
    """Pack a token pair into the canonical 32-bit pair id."""
    return ((a & TOKEN_MASK) << 16) | (b & TOKEN_MASK)
