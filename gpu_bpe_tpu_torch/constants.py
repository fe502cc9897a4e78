"""Framework-wide constants (the port's own copy of ``gpu_bpe_tpu.constants``).

Token ids are 16-bit, bit 16 of a u32 symbol is the word-start flag, and the
pair id packing ``(a << 16) | b`` defines the deterministic tie-break order.
"""

# Bit 16 of a u32 symbol marks the start of a pre-tokenized word.
WORD_START_BIT = 0x10000

# Lower 16 bits of a symbol are the token id -> max vocab 65,536.
TOKEN_MASK = 0xFFFF

# Maximum vocabulary size implied by 16-bit token ids.
MAX_VOCAB = 0x10000

# Sentinel for "no token" (the tokenizer's PAD between emitted tokens).
INVALID_TOKEN = 0xFFFFFFFF

# Maximum merges performed per device->host round trip (one merge-log read).
BATCH_MERGES = 1024

# Merge log stride: [pair, new_token_id, count] per merge.
MERGE_LOG_STRIDE = 3

# Trie binary format (v3; v2 is read too).
TRIE_MAGIC = 0x54524945  # 'TRIE'
TRIE_VERSION = 3
TRIE_SUPPORTED_VERSIONS = (2, 3)
TRIE_HEADER_SIZE = 28

# Tokenized-corpus binary export ('DXFT').
DXFT_MAGIC = 0x44584654

# Greedy tokenizer chunking (the reference tokenizer's chunk sizes).
DEFAULT_CHUNK_SIZE = 512
MAX_CHUNK_SIZE = 2048


def adaptive_chunk_size(max_token_len: int) -> int:
    """Chunk size of the chunked greedy tokenizer for a vocab whose longest
    token has ``max_token_len`` bytes."""
    return max(DEFAULT_CHUNK_SIZE, min(MAX_CHUNK_SIZE, max_token_len * 8))


def pack_pair(a: int, b: int) -> int:
    """Pack a token pair into the canonical 32-bit pair id."""
    return ((a & TOKEN_MASK) << 16) | (b & TOKEN_MASK)


def unpack_pair(pair: int) -> tuple[int, int]:
    return (pair >> 16) & TOKEN_MASK, pair & TOKEN_MASK
