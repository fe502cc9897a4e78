"""Host time of the chunk walk per MB in the traced calls: the walk is a
host loop over the chunk's offsets (``chunk_walk``, or
``chunk_walk_gather`` past 63-byte tokens)."""

LAYER = "Chunk walk"
UNIT = "ms/MB"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "tokenize_mb_per_s"
RANGES = ("gpu_bpe_tpu_torch.ops.tokenize:chunk_walk", "gpu_bpe_tpu_torch.ops.tokenize:chunk_walk_gather")
WALKS = ("chunk_walk", "chunk_walk_gather")


def read(s):
    mb = s.counters.get("traced_bytes", 0) / 1e6
    if not mb or not any(s.has_range(w) for w in WALKS):
        return None
    return 1e3 * sum(s.host_s(w) for w in WALKS) / mb
