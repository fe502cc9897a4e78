"""Host reads of the data-parallel step per merge on rank 0: the program's
own counter ``parallel.dist_train.HOST_READS`` (every site: ``batch``,
``merge``, ``recount``, the trainer's ``summary``), over every job of the
window."""

LAYER = "Data-parallel step"
UNIT = "reads/merge"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "train_merges_per_s"
RANGES = ()


def read(s):
    c = s.counters
    return c["host_reads"] / c["merges"] if c.get("merges") else None
