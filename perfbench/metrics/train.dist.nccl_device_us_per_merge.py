"""Device time of NCCL's kernels per merge on rank 0 in the traced job: every
kernel named ``ncclDevKernel...`` or ``ncclKernel...`` that started inside
the program's ``train.job`` span. A collective's kernel runs until the last
rank has joined it, so this holds the wait for the slowest rank too. Left
out: the CUDA-side annotation ProcessGroupNCCL puts around each collective
(``nccl:all_reduce``, ``nccl:all_gather``), which spans its kernel and
would count it twice, and the harness's own collectives (the job's
broadcast and its gather of digests), which start outside ``train.job``.
Where no such kernel ran (gloo, or NCCL at one rank, which copies
instead), or in a program without the tracer, there is nothing to read;
a tracer that recorded no ``train.job`` fails the run."""

import importlib

from perfbench import spans as sp
from perfbench.trace import short_name

LAYER = "Collectives"
UNIT = "us/merge"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_merges_per_s"
RANGES = ()
KERNELS = ("ncclDevKernel", "ncclKernel")
sp.enable()


def _jobs():
    """The program's ``train.job`` spans; None without the tracer."""
    try:
        spans = importlib.import_module(sp.TRACER).spans
    except (ImportError, AttributeError):
        return None
    jobs = [j for j in spans() if j.name == "train.job"]
    if not jobs:
        raise LookupError("the program recorded no span named train.job")
    return jobs


def read(s):
    m = s.counters.get("traced_merges")
    if not m or not s.device:
        return None
    jobs = _jobs()
    if jobs is None:
        return None
    nccl = [a for a in s.select(kinds=("kernel",)) if short_name(a.name).startswith(KERNELS)
            and any(j.start_ns <= a.start < j.end_ns for j in jobs)]
    if not nccl:
        return None
    return sum(a.end - a.start for a in nccl) / 1e3 / m
