"""The ``train_jobs_dist`` traffic kind and its five readers, on the CPU: four
ranks over gloo at a small size, a worker whose result is changed, the
control, a worker that exits before the group forms, and the readers on a
fixed trace.

    python3 -m pytest perfbench/test_perfbench_dist.py -q

A worker is changed, or made to exit, by a ``sitecustomize`` module on its
``PYTHONPATH``, which each rank process imports at start: the harness and
the program are run as they are.
"""

from __future__ import annotations

import time

import pytest

from gpu_bpe_tpu_torch.utils import timing
from gpu_bpe_tpu_torch.utils.timing import Span
from perfbench import control, run, trace

CELL = "train.dist4-words-8k"
SMALL = {"corpus_mib": 0.03125, "vocab_size": 320}
NEW = ("train.dist.collectives_per_merge", "train.dist.nccl_device_us_per_merge",
       "train.dist.local_counts_device_ms_per_job", "train.dist.host_reads_per_merge",
       "train.dist.idle_dispatch_share")

CHANGE_RANK_2 = """
import sys
if "--rank" in sys.argv and sys.argv[sys.argv.index("--rank") + 1] == "2":
    from gpu_bpe_tpu_torch import api
    _train = api.train

    def train(*args, **kwargs):
        tok, res = _train(*args, **kwargs)
        res.merge_counts[-1] += 1
        return tok, res

    api.train = train
"""

EXIT_RANK_1 = """
import os, sys
if "--rank" in sys.argv and sys.argv[sys.argv.index("--rank") + 1] == "1":
    print("rank 1 leaves before the group forms", file=sys.stderr, flush=True)
    os._exit(7)
"""


@pytest.fixture(autouse=True)
def tracer_off():
    yield
    timing.disable()
    timing.clear()


def _sitecustomize(tmp_path, monkeypatch, body: str) -> None:
    (tmp_path / "sitecustomize.py").write_text(body)
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


@pytest.mark.parametrize("traced", [False, True])
def test_four_gloo_ranks_are_correct(monkeypatch, traced):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    r = run.run_cell(CELL, 2**31 + 12345, 0.2, traced, device="cpu", overrides=SMALL)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"merges_wrong", "counts_wrong", "vocab_wrong", "ranks_disagree"}
    if traced:
        m = r["metrics"]
        assert 2.0 <= m["train.dist.collectives_per_merge"]["value"] <= 2.5
        assert 1.0 <= m["train.dist.host_reads_per_merge"]["value"] <= 1.2
        assert "train.dist.idle_dispatch_share" not in m  # no device on the CPU: nothing idle to split
    else:
        assert r["metrics"]["train_merges_per_s"]["value"] > 0 and "setup_s" in r["metrics"]


def test_a_changed_worker_disagrees(tmp_path, monkeypatch):
    _sitecustomize(tmp_path, monkeypatch, CHANGE_RANK_2)
    r = run.run_cell(CELL, 3, 0.2, False, device="cpu", overrides=SMALL)
    c = r["checks"]
    assert not r["correct"]
    assert c["ranks_disagree"]["value"] == r["attempted"]  # rank 2, once a job
    assert c["merges_wrong"]["value"] == c["counts_wrong"]["value"] == c["vocab_wrong"]["value"] == 0


def test_the_control_is_not_correct():
    got = control.control(CELL, 4, SMALL)
    assert not got["correct"] and got["checks"]["merges_wrong"]["value"] > 0
    assert got["checks"]["ranks_disagree"]["value"] == 0


def test_a_worker_that_exits_before_the_group_forms_ends_the_run(tmp_path, monkeypatch):
    _sitecustomize(tmp_path, monkeypatch, EXIT_RANK_1)
    kind = run.load_module("traffic", "train_jobs_dist")
    t0 = time.monotonic()
    with pytest.raises(SystemExit, match="rank 1 exited with 7 before the group formed") as e:
        run.run_cell(CELL, 5, 0.2, False, device="cpu", overrides=SMALL)
    assert "rank 1 leaves before the group forms" in str(e.value.code)
    assert time.monotonic() - t0 < kind.JOIN_TIMEOUT_S


def _summary():
    """A fixed traced job of 40 merges in a 10 ms window: two NCCL kernels,
    the annotation ProcessGroupNCCL lays over the first, the harness's
    broadcast after the job's span, two counting kernels inside
    ``_local_counts``, a merge kernel; the program's spans on the same
    clock."""
    ms = 1_000_000
    A = trace.Activity
    dev = [
        A("ncclDevKernel_AllReduce_Sum_i64_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "kernel", 1 * ms,
          int(1.5 * ms), frozenset()),
        A("nccl:all_reduce", trace.device_kind("nccl:all_reduce"), 1 * ms, int(1.5 * ms), None),
        A("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "kernel", 4 * ms, int(4.3 * ms),
          frozenset()),
        A("ncclDevKernel_Broadcast_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "kernel", int(9.6 * ms),
          int(9.8 * ms), frozenset()),
        A("void at::native::index_add_kernel(long*)", "kernel", 2 * ms, int(2.4 * ms), frozenset({"_local_counts"})),
        A("void at::native::sort_kernel<long>(long*)", "kernel", int(2.4 * ms), 3 * ms, frozenset({"_local_counts"})),
        A("merge_tiles(unsigned int const*, int)", "kernel", 5 * ms, 6 * ms, frozenset()),
    ]
    counters = {"merges": 80, "host_reads": 88, "collectives": 168, "collective_bytes": 4096, "traced_jobs": 1,
                "traced_merges": 40}
    spans = [
        Span("train.collective", int(0.5 * ms), int(0.9 * ms), 2, {"op": "psum", "bytes": 8}),
        Span("train.read", 3 * ms, int(3.5 * ms), 2, {"site": "merge"}),
        Span("train.batch", 0, 7 * ms, 4, {"merges": 40, "capacity": 2048}),
        Span("train.recount", int(6.5 * ms), 7 * ms, 4, {"tier": "dist_sparse"}),
        Span("train.job", 0, int(9.5 * ms), -1, {"merges": 40}),
    ]
    return trace.Summary(window=(0, 10 * ms), device=dev, ranges=[("_local_counts", 2 * ms, 3 * ms)],
                         counters=counters), spans


def test_readers_on_a_fixed_trace(monkeypatch, capsys):
    mods = {name: run.load_module("metrics", name) for name in NEW}
    s, spans = _summary()
    monkeypatch.setattr(timing, "spans", lambda: spans)
    got = {name: mod.read(s) for name, mod in mods.items()}
    # idle: 0-1 ms (the collective 0.5-0.9, the batch the rest), 1.5-2,
    # 3-4 (the read 3-3.5), 4.3-5, 6-7 (the recount from 6.5), 7-9.5 (the
    # job), 9.5-9.6 and 9.8-10 (no span)
    assert got == pytest.approx({
        "train.dist.collectives_per_merge": 168 / 80,
        "train.dist.nccl_device_us_per_merge": 800 / 40,
        "train.dist.local_counts_device_ms_per_job": 1.0,
        "train.dist.host_reads_per_merge": 88 / 80,
        "train.dist.idle_dispatch_share": (0.6 + 0.4 + 0.5 + 0.5 + 0.7 + 0.5 + 0.5) / 10,
    })
    assert "spans: train.dist: idle" in capsys.readouterr().err
    for mod in mods.values():
        assert mod.read(trace.Summary()) is None  # nothing to read
    nccl = mods["train.dist.nccl_device_us_per_merge"]
    assert nccl.read(trace.Summary(window=s.window, device=s.device[4:], counters=s.counters)) is None  # no NCCL
    monkeypatch.setattr(timing, "spans", lambda: [sp for sp in spans if sp.name != "train.job"])
    with pytest.raises(LookupError, match="train.job"):
        nccl.read(s)
    # the parent's counters: no collective count
    no_coll = dict(s.counters)
    del no_coll["collectives"]
    assert mods["train.dist.collectives_per_merge"].read(trace.Summary(counters=no_coll)) is None
