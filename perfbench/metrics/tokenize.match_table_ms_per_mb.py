"""Device time of the match table per MB in the traced calls: the
operations launched inside ``build_match_table`` (byte ids, the stab join
``_stab_match`` / ``_stab_join`` where the vocab has a stab table, the
dense join)."""

LAYER = "Match table"
UNIT = "ms/MB"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "tokenize_mb_per_s"
RANGES = ("gpu_bpe_tpu_torch.ops.tokenize:build_match_table",)


def read(s):
    mb = s.counters.get("traced_bytes", 0) / 1e6
    if not mb or not s.count(within="build_match_table"):
        return None
    return 1e3 * s.device_s(within="build_match_table") / mb
