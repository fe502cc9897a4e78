"""Device time of the port's tokenize kernels per MB in the traced calls:
the operations launched inside the kernels' entries (``compact_valid``,
the PAD strip, and ``compact_mask``, the rank-space compaction:
``compact_mask.cu``; ``expand_to_mask``; ``overlay_fit``); the last three
run only where the vocab has a stab table. Selected by entry and not by a
CUDA symbol, so a kernel that is renamed keeps its time here; an entry that
is gone fails the traced run, naming it, and a cell lists under ``traced``
the entries it has to enter."""

LAYER = "Tokenize kernels"
UNIT = "ms/MB"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "tokenize_mb_per_s"
RANGES = (
    "gpu_bpe_tpu_torch.ops.kernels:compact_valid",
    "gpu_bpe_tpu_torch.ops.kernels:compact_mask",
    "gpu_bpe_tpu_torch.ops.kernels:expand_to_mask",
    "gpu_bpe_tpu_torch.ops.stab_kernels:overlay_fit",
)
ENTRIES = tuple(r.rpartition(":")[2] for r in RANGES)


def read(s):
    mb = s.counters.get("traced_bytes", 0) / 1e6
    if not mb or not s.count(within=ENTRIES):
        return None
    return 1e3 * s.device_s(within=ENTRIES) / mb
