"""Traffic kind ``train_jobs_dist``: whole ``api.train(backend="dist")`` jobs
back to back on ``ranks`` processes of one host, one per card, one caller.

Mix parameters (``traffic/<mix>.json``): ``warmup_merges``, the merges of
the set-up's warm-up job, and ``ranks``, the processes of the group.

``run.py``'s process is rank 0 on the first card. It imports the program
first (its data-parallel trainer and collective counter, so a program
without them fails before any process starts), then starts ranks 1 to
``ranks - 1`` as processes of this interpreter
(``train_jobs_dist_worker.py``), each with a free local port, the seed and
the configuration, and loads its own libraries while they start (the
set-up's stderr says when the group formed). Every rank builds the same
seeded corpus and joins the group with the program's ``init_multihost``:
rank 0 with a timeout of ``JOIN_TIMEOUT_S``, polling its workers
meanwhile, so a worker that exits before the group forms ends the run at
once with the end of its stderr.

A job: rank 0 broadcasts the vocab size, every rank runs ``api.train(corpus,
TrainConfig(vocab_size, backend="dist"))`` and synchronizes, and the ranks
all-gather a digest of their results and the host CPU seconds of their
job. The job's wall time runs from the broadcast to that gather, so the
slowest rank is inside it; every rank's CPU seconds go to stderr. Jobs start
while the window lasts; the job in flight when it ends finishes and
counts. ``train_merges_per_s`` is all the merges of all the jobs over the
time from the window's start to the end of the last job. The traced run
profiles the first job on rank 0 only.

Rank 0's merge list, merge counts and vocab of every job are compared with
the plain reference trainer's (``reference/bpe.py``), and every rank's
digest with rank 0's: the numbers compared are the positions that differ
and the (job, rank) pairs that disagree, summed over the jobs, limit 0.
The control (``control``) breaks the tie rule. ``Window``,
``end_to_end``, ``reference`` and the comparison with the reference are
``train_jobs``'s.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

from perfbench.traffic import train_jobs
from perfbench.traffic import train_jobs_dist_worker as worker
from perfbench.traffic.train_jobs import Window, end_to_end  # noqa: F401 (end_to_end: the kind's interface)

ROOT = Path(__file__).resolve().parents[2]
JOIN_TIMEOUT_S = 60.0  # rank 0's group: the wait for the workers, and each collective
EXIT_TIMEOUT_S = 60.0  # the wait for the workers to leave at release


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: str, n: int = 3000) -> str:
    with open(path, "rb") as f:
        return f.read().decode(errors="replace")[-n:]


def _stop_workers(ctx) -> None:
    """Kill the workers still running and drop their logs."""
    for p in ctx.workers:
        if p.poll() is None:
            p.kill()
    for p in ctx.workers:
        p.wait()
    shutil.rmtree(ctx.logs, ignore_errors=True)


def load_program(ctx) -> None:
    """Import the program, start the workers, then load rank 0's libraries
    while the workers start (set-up)."""
    from gpu_bpe_tpu_torch import api
    from gpu_bpe_tpu_torch.parallel import dist_train, init_multihost, shutdown_multihost
    from gpu_bpe_tpu_torch.parallel.mesh import COLLECTIVES
    from gpu_bpe_tpu_torch.unicode import get_backend

    ctx.api, ctx.host_reads, ctx.collectives = api, dist_train.HOST_READS, COLLECTIVES
    ctx.init_multihost, ctx.shutdown_multihost = init_multihost, shutdown_multihost
    ctx.ranks = int(ctx.mix["ranks"])
    if int(ctx.config.get("ranks", ctx.ranks)) != ctx.ranks:
        raise SystemExit(f"perfbench: the mix has {ctx.ranks} ranks, the configuration {ctx.config['ranks']}")
    _start_workers(ctx)
    get_backend()
    if ctx.device == "cuda":
        import torch

        from gpu_bpe_tpu_torch.ops import build

        torch.cuda.set_device(0)
        build.load()


def _start_workers(ctx) -> None:
    ctx.addr = f"127.0.0.1:{_free_port()}"
    ctx.logs = tempfile.mkdtemp(prefix="train_jobs_dist-")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, (str(ROOT), os.environ.get("PYTHONPATH")))))
    ctx.workers, ctx.workers_started = [], time.perf_counter()
    for r in range(1, ctx.ranks):
        with open(os.path.join(ctx.logs, f"rank{r}.log"), "wb") as log:
            ctx.workers.append(subprocess.Popen(
                [sys.executable, "-m", "perfbench.traffic.train_jobs_dist_worker", "--addr", ctx.addr,
                 "--world", str(ctx.ranks), "--rank", str(r), "--seed", str(ctx.seed), "--device", ctx.device,
                 "--config", json.dumps(ctx.config)],
                cwd=ROOT, env=env, stdin=subprocess.DEVNULL, stdout=log, stderr=subprocess.STDOUT))


def _join(ctx) -> None:
    """Rank 0 joins the group, polling its workers while it waits."""
    failed = []

    def join():
        try:
            ctx.init_multihost(ctx.addr, ctx.ranks, 0, device=ctx.device, timeout_s=JOIN_TIMEOUT_S)
        except Exception as e:  # noqa: BLE001 (reported below)
            failed.append(e)

    t = threading.Thread(target=join, daemon=True)
    t.start()
    while t.is_alive():
        t.join(0.1)
        for r, p in enumerate(ctx.workers, 1):
            if p.poll() is not None:
                tail = _tail(os.path.join(ctx.logs, f"rank{r}.log"))
                _stop_workers(ctx)
                raise SystemExit(f"perfbench: rank {r} exited with {p.returncode} before the group formed:\n{tail}")
    if failed:
        _stop_workers(ctx)
        raise SystemExit(f"perfbench: rank 0 could not form the group of {ctx.ranks}: {failed[0]}")


def _job(ctx, vocab_size: int) -> dict:
    reads0 = sum(ctx.host_reads.values())
    coll0 = dict(ctx.collectives)
    t0 = time.perf_counter()
    worker.broadcast_vocab(ctx.dev, vocab_size)
    res, ranks = worker.run_job(ctx.api, ctx.corpus, ctx.config, vocab_size, ctx.device, ctx.ranks)
    wall = time.perf_counter() - t0
    coll = {k: v - coll0.get(k, 0) for k, v in ctx.collectives.items()}
    return {"merges": res.merges, "merge_counts": res.merge_counts, "vocab": res.vocab,
            "digests": [d for d, _ in ranks], "host_cpu_s": [c for _, c in ranks], "wall_s": wall, "train_s": res.training_time_s, "recounts": res.recounts,
            "host_reads": sum(ctx.host_reads.values()) - reads0,
            "collectives": sum(v for k, v in coll.items() if k != "bytes"), "collective_bytes": coll.get("bytes", 0)}


def setup(ctx):
    _join(ctx)
    joined = time.perf_counter() - ctx.workers_started
    ctx.dev = worker.device(ctx.device)
    job = _job(ctx, 256 + ctx.mix["warmup_merges"])
    if job["recounts"] < 1:
        raise RuntimeError("the warm-up job ran no recount")
    print(f"set-up: the group formed {joined:.2f} s after the workers started; warm-up job {job['wall_s']:.2f} s",
          file=sys.stderr, flush=True)
    return None


def window(ctx, state, seconds: float) -> Window:
    win = Window(start=time.perf_counter())
    deadline = win.start + seconds
    while not win.jobs or time.perf_counter() < deadline:
        win.attempted += 1
        first = not win.jobs
        if first:
            ctx.tracer.start()
        job = _job(ctx, ctx.config["vocab_size"])
        if first:
            ctx.tracer.stop()
        job["traced"] = first and ctx.tracer.on
        win.jobs.append(job)
    win.end = time.perf_counter()
    print("jobs: " + " ".join(f"{j['wall_s']:.3f}" for j in win.jobs) + " s; host CPU s by rank: "
          + " ".join("/".join(f"{c:.3f}" for c in j["host_cpu_s"]) for j in win.jobs)
          + f"; {os.cpu_count()} CPUs", file=sys.stderr, flush=True)
    return win


def counters(ctx, win: Window) -> dict:
    return {**train_jobs.counters(ctx, win),
            "collectives": sum(j["collectives"] for j in win.jobs),
            "collective_bytes": sum(j["collective_bytes"] for j in win.jobs)}


def release(ctx, state, win: Window) -> None:
    """Rank 0 says quit and leaves the group; the workers, each after
    printing its card's peak memory, leave too, or are killed."""
    worker.broadcast_vocab(ctx.dev, 0)
    ctx.shutdown_multihost()
    deadline = time.monotonic() + EXIT_TIMEOUT_S
    for r, p in enumerate(ctx.workers, 1):
        try:
            p.wait(max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            print(f"rank {r}: still running {EXIT_TIMEOUT_S:.0f} s after quit; killed", file=sys.stderr, flush=True)
        lines = [ln for ln in _tail(os.path.join(ctx.logs, f"rank{r}.log")).splitlines() if "memory_peak_bytes" in ln]
        if lines:
            print(lines[-1], file=sys.stderr, flush=True)
    _stop_workers(ctx)


def control(ctx) -> Window:
    """``train_jobs``'s control, on which every rank agrees."""
    win = train_jobs.control(ctx)
    for j in win.jobs:
        j["digests"] = [worker.digest(SimpleNamespace(**j))] * int(ctx.mix["ranks"])
    return win


def check(ctx, win: Window) -> dict:
    return {**train_jobs.check(ctx, win),
            "ranks_disagree": {"value": sum(d != j["digests"][0] for j in win.jobs for d in j["digests"][1:]),
                               "limit": 0}}
