"""Traffic kind ``train_jobs``: whole ``api.train`` jobs back to back on the
set-up's corpus, one caller.

Mix parameters (``traffic/<mix>.json``): ``warmup_merges``, the merges of
the set-up's warm-up job (it runs the whole path once: pre-tokenizing or
the byte stream, the upload at the cell's capacity, one recount, the
tokenizer build).

A job is ``api.train(corpus, TrainConfig(...))`` followed by
``torch.cuda.synchronize()``. Jobs start while the window lasts; the job in
flight when it ends finishes and counts. ``train_merges_per_s`` is all the
merges of all the jobs over the time from the window's start to the end of
the last job. The traced run profiles the first job.

Every job's merge list, merge counts and vocab are compared with the plain
reference trainer's (``reference/bpe.py``) on the same corpus: the numbers
compared are the positions that differ, summed over the jobs, limit 0. The
control (``control``) breaks the tie rule.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field


@dataclass
class Window:
    start: float
    end: float = 0.0
    jobs: list = field(default_factory=list)  # dicts, one per job
    attempted: int = 0


def load_program(ctx) -> None:
    """Import the program and load its libraries (set-up)."""
    from gpu_bpe_tpu_torch import api
    from gpu_bpe_tpu_torch.ops import native, train_step
    from gpu_bpe_tpu_torch.unicode import get_backend

    ctx.api = api
    ctx.host_reads = train_step.HOST_READS
    get_backend()
    native.native_available()
    if ctx.device == "cuda":
        from gpu_bpe_tpu_torch.ops import build

        build.load()


def _config(ctx, vocab_size: int):
    c = ctx.config
    return ctx.api.TrainConfig(vocab_size=vocab_size, device=ctx.device, pre_tokenize=c["pre_tokenize"],
                               dedup=c["dedup"], show_progress=False)


def setup(ctx):
    _, res = ctx.api.train(ctx.corpus, _config(ctx, 256 + ctx.mix["warmup_merges"]))
    ctx.sync()
    if res.recounts < 1:
        raise RuntimeError("the warm-up job ran no recount")
    return None


def _job(ctx) -> dict:
    reads0 = sum(ctx.host_reads.values())
    t0 = time.perf_counter()
    _, res = ctx.api.train(ctx.corpus, _config(ctx, ctx.config["vocab_size"]))
    ctx.sync()
    wall = time.perf_counter() - t0
    return {"merges": res.merges, "merge_counts": res.merge_counts, "vocab": res.vocab, "wall_s": wall,
            "train_s": res.training_time_s, "recounts": res.recounts,
            "host_reads": sum(ctx.host_reads.values()) - reads0}


def window(ctx, state, seconds: float) -> Window:
    win = Window(start=time.perf_counter())
    deadline = win.start + seconds
    while not win.jobs or time.perf_counter() < deadline:
        win.attempted += 1
        first = not win.jobs
        if first:
            ctx.tracer.start()
        job = _job(ctx)
        if first:
            ctx.tracer.stop()
        job["traced"] = first and ctx.tracer.on
        win.jobs.append(job)
    win.end = time.perf_counter()
    print("jobs: " + " ".join(f"{j['wall_s']:.3f}" for j in win.jobs) + " s", file=sys.stderr, flush=True)
    return win


def end_to_end(ctx, win: Window) -> dict:
    merges = sum(len(j["merges"]) for j in win.jobs)
    return {"train_merges_per_s": merges / (win.end - win.start)}


def counters(ctx, win: Window) -> dict:
    jobs = win.jobs
    traced = [j for j in jobs if j.get("traced")]
    return {
        "merges": sum(len(j["merges"]) for j in jobs),
        "host_reads": sum(j["host_reads"] for j in jobs),
        "recounts": sum(j["recounts"] for j in jobs),
        "train_s": sum(j["train_s"] for j in jobs),
        "wall_s": sum(j["wall_s"] for j in jobs),
        "traced_jobs": len(traced),
        "traced_merges": sum(len(j["merges"]) for j in traced),
    }


def release(ctx, state, win: Window) -> None:
    """Nothing of the program outlives a job."""


def reference(ctx):
    """The plain reference trainer's result on the corpus, once per run."""
    from perfbench.reference import bpe

    if getattr(ctx, "reference", None) is None:
        ctx.reference = bpe.train(ctx.corpus, ctx.config["vocab_size"])
    return ctx.reference


def control(ctx) -> Window:
    """The control in the program's place: the reference trainer with ties
    sent to the larger packed pair id, one job."""
    from perfbench.reference import bpe

    ctl = bpe.train(ctx.corpus, ctx.config["vocab_size"], break_ties=True)
    return Window(start=0.0, jobs=[{"merges": ctl.merges, "merge_counts": ctl.merge_counts, "vocab": ctl.vocab}])


def check(ctx, win: Window) -> dict:
    from perfbench.compare import diff

    ref = reference(ctx)
    return {
        "merges_wrong": {"value": sum(diff(j["merges"], ref.merges) for j in win.jobs), "limit": 0},
        "counts_wrong": {"value": sum(diff(j["merge_counts"], ref.merge_counts) for j in win.jobs), "limit": 0},
        "vocab_wrong": {"value": sum(diff(j["vocab"], ref.vocab) for j in win.jobs), "limit": 0},
    }
