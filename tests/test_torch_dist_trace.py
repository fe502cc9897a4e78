"""The data-parallel trainer's spans and counters (``gpu_bpe_tpu_torch.parallel``)
on the CPU over gloo, and its results against the benchmark's plain
reference trainer (``perfbench/reference/bpe.py``).

Four ranks run as real processes, each calling ``init_multihost`` and then
``api.train(backend="dist", device="cpu")`` with tracing on, on a small
seeded ASCII corpus. Every rank's merges, counts and vocab must equal the
reference's; each rank records the single-chip trainer's spans
(``train.dedup``, ``train.upload``, ``train.batch``, ``train.recount`` with
a ``dist_*`` tier, ``train.read``) and a ``train.collective`` per
collective; its ``train.read`` spans equal ``dist_train.HOST_READS`` by
site and its ``train.collective`` spans equal ``mesh.COLLECTIVES`` by op
and in bytes. At world size 1 the counter counts too.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest
import torch

from gpu_bpe_tpu_torch.parallel import one_rank_group
from gpu_bpe_tpu_torch.parallel.mesh import COLLECTIVES
from gpu_bpe_tpu_torch.utils import timing
from perfbench.corpus import seeded_corpus
from perfbench.reference import bpe

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
VOCAB = 420
RANK_TIMEOUT_S = 60  # the process group's timeout in each rank
RUN_TIMEOUT_S = 240  # each rank process's own

WORKER = """
import json, sys
from gpu_bpe_tpu_torch import api
from gpu_bpe_tpu_torch.parallel import dist_train, init_multihost, shutdown_multihost
from gpu_bpe_tpu_torch.parallel.mesh import COLLECTIVES
from gpu_bpe_tpu_torch.utils import timing

addr, world, rank, corpus_path, vocab_size, out_path, timeout_s = sys.argv[1:8]
rank, world = init_multihost(addr, int(world), int(rank), device="cpu", timeout_s=float(timeout_s))
timing.enable()
with open(corpus_path, "rb") as f:
    corpus = f.read()
_, res = api.train(corpus, api.TrainConfig(vocab_size=int(vocab_size), backend="dist", device="cpu",
                                           show_progress=False))
spans = timing.spans()
out = {"merges": res.merges, "counts": res.merge_counts, "vocab": [v.hex() for v in res.vocab],
       "recounts": res.recounts, "spans": [[s.name, s.parent, s.attrs] for s in spans],
       "host_reads": dict(dist_train.HOST_READS), "collectives": dict(COLLECTIVES)}
with open(out_path + f".rank{rank}", "w") as f:
    json.dump(out, f)
shutdown_multihost()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def corpus() -> bytes:
    return seeded_corpus(24 << 10, 11)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, corpus) -> list[dict]:
    """Each rank's result, spans and counters."""
    tmp = tmp_path_factory.mktemp("dist_trace")
    (tmp / "worker.py").write_text(WORKER)
    (tmp / "corpus.txt").write_bytes(corpus)
    out = tmp / "out.json"
    addr = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen([sys.executable, str(tmp / "worker.py"), addr, str(WORLD), str(r), str(tmp / "corpus.txt"),
                          str(VOCAB), str(out), str(RANK_TIMEOUT_S)],
                         cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"},
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(WORLD)
    ]
    try:
        done = [p.communicate(timeout=RUN_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, done):
        assert p.returncode == 0, err.decode()[-3000:]
    return [json.loads(Path(f"{out}.rank{r}").read_text()) for r in range(WORLD)]


def test_every_rank_equals_the_reference(ranks, corpus):
    ref = bpe.train(corpus, VOCAB)
    assert len(ref.merges) == VOCAB - 256
    for r in ranks:
        assert [tuple(m) for m in r["merges"]] == ref.merges
        assert r["counts"] == ref.merge_counts
        assert [bytes.fromhex(v) for v in r["vocab"]] == ref.vocab


def test_every_rank_records_the_trainers_spans(ranks):
    for r in ranks:
        names = Counter(name for name, _, _ in r["spans"])
        for name in ("train.job", "train.dedup", "train.upload", "train.batch", "train.recount", "train.read",
                     "train.collective"):
            assert names[name] > 0, name
        assert names["train.job"] == names["train.dedup"] == names["train.upload"] == 1
        attrs = {name: a for name, _, a in r["spans"] if name in ("train.dedup", "train.upload")}
        assert attrs["train.dedup"]["symbols"] > 0
        assert attrs["train.upload"]["ranks"] == WORLD and attrs["train.upload"]["capacity"] % 1024 == 0
        tiers = [a["tier"] for name, _, a in r["spans"] if name == "train.recount"]
        assert len(tiers) == r["recounts"] and set(tiers) <= {"dist_sparse", "dist_dense"}
        # every span leads up to the job's root
        sp = r["spans"]
        for i, (_, parent, _) in enumerate(sp):
            while parent != -1:
                assert parent > i
                i, parent = parent, sp[parent][1]
            assert sp[i][0] == "train.job"


def test_read_spans_equal_host_reads(ranks):
    for r in ranks:
        sites = Counter(a["site"] for name, _, a in r["spans"] if name == "train.read")
        assert sites == Counter(r["host_reads"])
        assert set(sites) == {"batch", "merge", "recount", "summary"}


def test_collective_spans_equal_the_counter(ranks):
    for r in ranks:
        coll = [a for name, _, a in r["spans"] if name == "train.collective"]
        want = dict(r["collectives"])
        assert sum(a["bytes"] for a in coll) == want.pop("bytes") > 0
        assert Counter(a["op"] for a in coll) == Counter(want)
        assert {"psum", "pmax", "all_gather"} <= set(want)
    assert all(r["collectives"] == ranks[0]["collectives"] for r in ranks)  # every rank takes every branch


def test_collectives_counted_at_world_size_one():
    timing.disable()
    timing.clear()
    COLLECTIVES.clear()
    x = torch.tensor([3, -1, 7])
    timing.enable()
    try:
        with one_rank_group("cpu") as g:
            g.psum(x), g.pmax(x), g.pmin(x), g.psum(x), g.all_gather(x.to(torch.int32))
        spans = [s for s in timing.spans() if s.name == "train.collective"]
    finally:
        timing.disable()
        timing.clear()
    assert dict(COLLECTIVES) == {"psum": 2, "pmax": 1, "pmin": 1, "all_gather": 1, "bytes": 4 * 24 + 12}
    assert [(s.attrs["op"], s.attrs["bytes"]) for s in spans] == [
        ("psum", 24), ("pmax", 24), ("pmin", 24), ("psum", 24), ("all_gather", 12)]
    COLLECTIVES.clear()
