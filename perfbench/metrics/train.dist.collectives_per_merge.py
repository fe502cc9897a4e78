"""Collectives per merge of the data-parallel trainer: the program's own
counter ``parallel.mesh.COLLECTIVES`` on rank 0 (every ``psum``, ``pmax``,
``pmin`` and ``all_gather`` call, not its ``bytes``), over every job of the
window. A program without the counter gives nothing to read."""

LAYER = "Collectives"
UNIT = "calls/merge"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "train_merges_per_s"
RANGES = ()


def read(s):
    c = s.counters
    return c["collectives"] / c["merges"] if c.get("merges") and "collectives" in c else None
