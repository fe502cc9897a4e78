"""Device operations launched inside the chunk walk per MB in the traced
calls."""

LAYER = "Chunk walk"
UNIT = "launches/MB"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "tokenize_mb_per_s"
RANGES = ("gpu_bpe_tpu_torch.ops.tokenize:chunk_walk", "gpu_bpe_tpu_torch.ops.tokenize:chunk_walk_gather")
WALKS = ("chunk_walk", "chunk_walk_gather")


def read(s):
    mb = s.counters.get("traced_bytes", 0) / 1e6
    n = sum(s.count(within=w) for w in WALKS)
    return n / mb if mb and n else None
