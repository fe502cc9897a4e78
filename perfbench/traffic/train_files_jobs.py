"""Traffic kind ``train_files_jobs``: whole ``api.train_files`` jobs back to
back on one file that holds the set-up's corpus, one caller.

Mix parameters (``traffic/<mix>.json``): ``warmup_merges``, the merges of
the set-up's warm-up job (it runs the whole path once: the streamed ingest
of the whole file, the upload at the cell's capacity, one recount, the
tokenizer build).

Set-up writes the corpus to one file in a temporary directory and syncs
it to its device. A job is
``api.train_files([path], TrainConfig(vocab_size, device,
show_progress=False), chunk_bytes)`` followed by
``torch.cuda.synchronize()``, ``chunk_bytes`` the configuration's
``chunk_mib``. Jobs start while the window lasts; the job in flight when it
ends finishes and counts (the window loop is ``train_jobs``'s, copied with
this job in it). ``train_merges_per_s`` is ``train_jobs``'s: all the
merges over the time from the window's start to the end of the last job.
The traced run profiles the first job whole. ``counters`` gives
``train_jobs``'s keys and, from the program's ingest counter
(``ops.ingest.INGEST``), ``bytes`` and ``chunks`` over every job and
``traced_bytes`` over the traced one; a program without that counter gives
none of the three. ``release`` deletes the file.

Every job's merge list, merge counts and vocab are compared with the plain
reference trainer's (``reference/bpe.py``'s ``train_words``) on the same
corpus, its words counted block by block (``reference/bpe_blocks.py``):
the numbers compared are ``train_jobs``'s, limit 0. The control
(``control``) breaks the tie rule.
"""

from __future__ import annotations

import atexit
import os
import shutil
import sys
import tempfile
import time

from perfbench.traffic import train_jobs
from perfbench.traffic.train_jobs import Window, end_to_end  # noqa: F401 (end_to_end: the kind's interface)

INGEST_KEYS = ("bytes", "chunks")


def load_program(ctx) -> None:
    """``train_jobs``'s set-up of the program, and its ingest counter where
    it has one."""
    train_jobs.load_program(ctx)
    from gpu_bpe_tpu_torch.ops import ingest

    ctx.ingest = getattr(ingest, "INGEST", None)


def _train(ctx, vocab_size: int):
    config = ctx.api.TrainConfig(vocab_size=vocab_size, device=ctx.device, show_progress=False)
    return ctx.api.train_files([ctx.path], config, chunk_bytes=int(ctx.config["chunk_mib"] * (1 << 20)))


def setup(ctx):
    ctx.dir = tempfile.mkdtemp(prefix="perfbench-files-")
    atexit.register(shutil.rmtree, ctx.dir, True)  # a run that fails before release leaves nothing behind
    ctx.path = os.path.join(ctx.dir, "corpus.txt")
    with open(ctx.path, "wb") as f:
        f.write(ctx.corpus)
        f.flush()
        os.fsync(f.fileno())  # the file's write-back happens here, not during a timed job
    _, res = _train(ctx, 256 + ctx.mix["warmup_merges"])
    ctx.sync()
    if res.recounts < 1:
        raise RuntimeError("the warm-up job ran no recount")
    return None


def _job(ctx) -> dict:
    ingest0 = dict(ctx.ingest) if ctx.ingest is not None else None
    reads0 = sum(ctx.host_reads.values())
    t0 = time.perf_counter()
    _, res = _train(ctx, ctx.config["vocab_size"])
    ctx.sync()
    wall = time.perf_counter() - t0
    job = {"merges": res.merges, "merge_counts": res.merge_counts, "vocab": res.vocab, "wall_s": wall,
           "train_s": res.training_time_s, "recounts": res.recounts,
           "host_reads": sum(ctx.host_reads.values()) - reads0}
    if ingest0 is not None:
        job["ingest"] = {k: ctx.ingest[k] - ingest0.get(k, 0) for k in INGEST_KEYS}
    return job


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


def counters(ctx, win: Window) -> dict:
    out = train_jobs.counters(ctx, win)
    if all("ingest" in j for j in win.jobs):
        for k in INGEST_KEYS:
            out[k] = sum(j["ingest"][k] for j in win.jobs)
        out["traced_bytes"] = sum(j["ingest"]["bytes"] for j in win.jobs if j.get("traced"))
    return out


def release(ctx, state, win: Window) -> None:
    """The corpus file goes; nothing of the program outlives a job."""
    shutil.rmtree(ctx.dir, ignore_errors=True)


def _words(ctx):
    """The corpus's word counts, block by block, once per run."""
    from perfbench.reference import bpe_blocks

    if getattr(ctx, "words", None) is None:
        t0 = time.perf_counter()
        ctx.words = bpe_blocks.word_counts(ctx.corpus)
        print(f"reference: {len(ctx.words)} distinct words counted in {time.perf_counter() - t0:.2f} s",
              file=sys.stderr, flush=True)
    return ctx.words


def reference(ctx):
    """The plain reference trainer's result on the corpus's word counts,
    once per run."""
    from perfbench.reference import bpe

    if getattr(ctx, "reference", None) is None:
        words = _words(ctx)
        t0 = time.perf_counter()
        ctx.reference = bpe.train_words(words, max(ctx.config["vocab_size"] - 256, 0))
        print(f"reference: {len(ctx.reference.merges)} merges in {time.perf_counter() - t0:.2f} s",
              file=sys.stderr, flush=True)
    return ctx.reference


def control(ctx) -> Window:
    """The control in the program's place: the reference trainer with ties
    sent to the larger packed pair id, one job."""
    from perfbench.reference import bpe

    ctl = bpe.train_words(_words(ctx), max(ctx.config["vocab_size"] - 256, 0), break_ties=True)
    return Window(start=0.0, jobs=[{"merges": ctl.merges, "merge_counts": ctl.merge_counts, "vocab": ctl.vocab}])


def check(ctx, win: Window) -> dict:
    reference(ctx)  # train_jobs' comparison takes the reference cached on ctx
    return train_jobs.check(ctx, win)
