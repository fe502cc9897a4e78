"""Device time of the port's training kernels per merge in the traced job:
the operations launched inside the kernels' entries in ``ops/kernels.py``
(``merge_compact_tracked`` and ``merge_compact``: ``merge_compact_tracked.cu``;
``count_pairs2``; ``window_post``; ``compact_mask``, in the segmented
recount). Selected by entry and not by a CUDA symbol, so a kernel that is
renamed keeps its time here; an entry that is gone fails the traced run,
naming it, and a cell lists under ``traced`` the entries it has to enter."""

LAYER = "Training kernels"
UNIT = "us/merge"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_merges_per_s"
RANGES = tuple(f"gpu_bpe_tpu_torch.ops.kernels:{f}" for f in (
    "merge_compact_tracked", "merge_compact", "count_pairs2", "window_post", "compact_mask"))
ENTRIES = tuple(r.rpartition(":")[2] for r in RANGES)


def read(s):
    m = s.counters.get("traced_merges")
    if not m or not s.count(within=ENTRIES):
        return None
    return 1e6 * s.device_s(within=ENTRIES) / m
