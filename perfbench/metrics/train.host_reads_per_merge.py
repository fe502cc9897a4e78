"""Host reads of the batch loop per merge: the program's own counter
``ops.train_step.HOST_READS`` (every site), over every job of the window."""

LAYER = "Batch loop"
UNIT = "reads/merge"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "train_merges_per_s"
RANGES = ("gpu_bpe_tpu_torch.ops.train_step:train_batch",)


def read(s):
    c = s.counters
    return c["host_reads"] / c["merges"] if c.get("merges") else None
