"""The port's data-parallel trainer (``gpu_bpe_tpu_torch.parallel``) on the
CPU over gloo, against the JAX package.

Ranks run as real processes (one per rank, a process group on a port the
OS picked, a timeout on the group and on each process). For 1, 2 and 4
ranks the merge list and counts must equal, bitwise, the JAX
``DistributedTrainer`` on a mesh of as many virtual CPU devices, the port's
single-chip ``Trainer(device="cpu")`` and ``ReferenceTrainer``; the cases
mirror ``tests/test_parallel.py`` (a deduplicated corpus, the ``dedup=False``
tiny corpus, the flat-count tie storm, the 64K-id stop seeded through
``convert.dist_state_from_numpy``). ``recounts`` and ``duals`` depend on
the ceilings, which move with the world size, and are printed, not
compared. Also: ``shard_stream`` bitwise, the probe-less merge against the
Pallas ``merge_compact`` in interpret mode, the tokenizer's round robin of
passes, and ``api.train(backend="dist")`` in one process.
"""

from __future__ import annotations

import json
import os
import random
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from gpu_bpe_tpu.core import ReferenceTrainer, bytes_to_symbols, tag_word_boundaries  # noqa: E402
from gpu_bpe_tpu.ops import make_stream as jax_make_stream  # noqa: E402
from gpu_bpe_tpu.ops import pallas_kernels as pk  # noqa: E402
from gpu_bpe_tpu.parallel import DistributedTrainer as JaxDistributedTrainer  # noqa: E402
from gpu_bpe_tpu.parallel import make_mesh  # noqa: E402
from gpu_bpe_tpu.parallel import shard_stream as jax_shard_stream  # noqa: E402
from gpu_bpe_tpu.pretok import PreTokenizer as JaxPreTokenizer  # noqa: E402
from gpu_bpe_tpu_torch import Tokenizer, Trainer, api  # noqa: E402
from gpu_bpe_tpu_torch.constants import pack_pair  # noqa: E402
from gpu_bpe_tpu_torch.ops import kernels as tk  # noqa: E402
from gpu_bpe_tpu_torch.parallel import DataGroup, DistributedTrainer, init_multihost, one_rank_group  # noqa: E402
from gpu_bpe_tpu_torch.parallel import shard_stream  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
WORLDS = (1, 2, 4)
RANK_TIMEOUT_S = 60  # the process group's timeout in each rank
RUN_TIMEOUT_S = 240  # each rank process's own
K64_START = 65_530  # 6 ids of room before the 16-bit cap
K64_BATCH = 64

WORKER = """
import json, sys
import numpy as np
from gpu_bpe_tpu_torch.convert import dist_state_from_numpy
from gpu_bpe_tpu_torch.parallel import (DataGroup, DistributedTrainer, dist_train_batch, init_multihost,
                                        shutdown_multihost)

addr, world, rank, cases_path, out_path, timeout_s = sys.argv[1:7]
rank, world = init_multihost(addr, int(world), int(rank), device="cpu", timeout_s=float(timeout_s))
arrays = np.load(cases_path)
spec = json.loads(str(arrays["spec"]))
out = {}
for name, (vocab_size, dedup, has_starts) in spec.items():
    starts = arrays[name + "/starts"] if has_starts else None
    res = DistributedTrainer(device="cpu").train(arrays[name + "/data"].tobytes(), starts, vocab_size, dedup)
    out[name] = {"merges": res.merges, "counts": res.merge_counts, "recounts": res.recounts,
                 "duals": res.duals}
k64 = {k.split("/", 1)[1]: arrays[k] for k in arrays.files if k.startswith("k64/")}
st = dist_train_batch(DataGroup.current("cpu"), dist_state_from_numpy(k64, rank, "cpu"), int(arrays["k64_batch"]))
done = int(st.merges_done)
out["k64"] = {"log": st.merge_log.reshape(-1, 3)[:done].tolist(), "done": done, "early": int(st.early_stop)}
with open(out_path + f".rank{rank}", "w") as f:
    json.dump(out, f)
shutdown_multihost()
"""


def _pretok(text: str):
    return JaxPreTokenizer().pre_tokenize(text)


def _tie_storm_text() -> str:
    """Hundreds of distinct words of identical frequency (the flat-count
    regression of ``tests/test_parallel.py``)."""
    rng = random.Random(7)
    words = [a + b + c for a in "abcdef" for b in "uvwxyz" for c in "mnop"]
    corpus = [w for w in words for _ in range(4)]
    rng.shuffle(corpus)
    return " ".join(corpus)


def _cases(english_text) -> dict:
    """name -> (data, word starts or None, vocab size, dedup)."""
    data, starts = _pretok(english_text[:6000])
    storm, storm_starts = _pretok(_tie_storm_text())
    return {
        "dedup": (data, starts, 300, True),
        "tiny": (b"ab cd ab cd ef gh", None, 280, False),
        "tie_storm": (storm, storm_starts, 256 + 120, True),
    }


def _k64_state(english_text, world: int):
    """The JAX package's DistState for ``world`` shards with next_id a few
    ids below 65,536."""
    from gpu_bpe_tpu.parallel.dist_train import init_dist_state

    data, starts = _pretok(english_text[:8000])
    stream = jax_make_stream(data, starts, dedup=True)
    sym, w, n = jax_shard_stream(stream.symbols[: stream.n], stream.weights[: stream.n], world)
    return init_dist_state(make_mesh(world), sym, w, n, K64_START)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Runs:
    """The rank processes of every world size, started together; ``get``
    waits for one world's ranks and returns rank 0's results after checking
    that every rank returned the same."""

    def __init__(self, tmp: Path, english_text):
        script = tmp / "worker.py"
        script.write_text(WORKER)
        cases = _cases(english_text)
        spec = {k: (v, d, s is not None) for k, (_, s, v, d) in cases.items()}
        self.procs, self.outs = {}, {}
        for world in WORLDS:
            arrays = {"spec": np.array(json.dumps(spec)), "k64_batch": np.array(K64_BATCH)}
            for name, (data, starts, _, _) in cases.items():
                arrays[name + "/data"] = np.frombuffer(data, np.uint8)
                if starts is not None:
                    arrays[name + "/starts"] = np.asarray(starts)
            arrays.update({f"k64/{k}": np.asarray(v) for k, v in _k64_state(english_text, world)._asdict().items()})
            path = tmp / f"cases{world}.npz"
            np.savez(path, **arrays)
            out = tmp / f"out{world}.json"
            addr = f"127.0.0.1:{_free_port()}"
            self.outs[world] = out
            self.procs[world] = [
                subprocess.Popen([sys.executable, str(script), addr, str(world), str(rank), str(path), str(out),
                                  str(RANK_TIMEOUT_S)],
                                 cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"},
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE)
                for rank in range(world)
            ]
        self.results = {}

    def get(self, world: int) -> dict:
        if world not in self.results:
            procs = self.procs[world]
            try:
                done = [p.communicate(timeout=RUN_TIMEOUT_S) for p in procs]
            finally:
                for p in procs:
                    p.kill()
            for p, (_, err) in zip(procs, done):
                assert p.returncode == 0, err.decode()[-3000:]
            per_rank = [json.loads(Path(f"{self.outs[world]}.rank{r}").read_text()) for r in range(world)]
            assert all(r == per_rank[0] for r in per_rank), f"the {world} ranks disagree"
            self.results[world] = per_rank[0]
        return self.results[world]

    def close(self):
        for procs in self.procs.values():
            for p in procs:
                p.kill()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, english_text):
    r = _Runs(tmp_path_factory.mktemp("dist"), english_text)
    yield r
    r.close()


_REFS: dict = {}


def _references(name: str, english_text):
    """(port single-chip result, ReferenceTrainer result) of a case."""
    if name not in _REFS:
        data, starts, vocab_size, dedup = _cases(english_text)[name]
        single = Trainer(device="cpu").train(data, starts, target_vocab_size=vocab_size, dedup=dedup)
        sym = bytes_to_symbols(data)
        if starts is not None:
            sym = tag_word_boundaries(sym, starts)
        oracle = ReferenceTrainer().train(sym, target_vocab_size=vocab_size)
        _REFS[name] = single, oracle
    return _REFS[name]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["dedup", "tiny", "tie_storm"])
def test_dist_matches_jax_single_chip_and_reference(runs, english_text, name, world):
    data, starts, vocab_size, dedup = _cases(english_text)[name]
    jax_res = JaxDistributedTrainer(make_mesh(world)).train(data, starts, target_vocab_size=vocab_size,
                                                            dedup=dedup)
    single, oracle = _references(name, english_text)
    port = runs.get(world)[name]
    merges = [tuple(m) for m in port["merges"]]
    print(f"{name} x{world}: {len(merges)} merges; recounts/duals port {port['recounts']}/{port['duals']}, "
          f"jax {jax_res.recounts}/{jax_res.duals}")
    assert len(merges) == len(oracle.merges) > 0
    assert merges == jax_res.merges == single.merges == oracle.merges
    assert port["counts"] == jax_res.merge_counts == single.merge_counts == oracle.merge_counts


@pytest.mark.parametrize("world", WORLDS)
def test_dist_64k_id_stop(runs, english_text, world):
    """Seeded with next_id 6 below the 16-bit cap through
    ``dist_state_from_numpy``: the batch stops after id 65,535 with the JAX
    distributed batch's log and the JAX single-chip step's."""
    from gpu_bpe_tpu.ops import init_state
    from gpu_bpe_tpu.ops.ingest import pad_stream
    from gpu_bpe_tpu.ops.train_step import train_batch
    from gpu_bpe_tpu.parallel.dist_train import make_dist_train_batch

    data, starts = _pretok(english_text[:8000])
    stream = jax_make_stream(data, starts, dedup=True)
    padded = pad_stream(stream)
    st = init_state(jnp.asarray(padded.symbols), jnp.asarray(padded.weights), stream.n, K64_START)
    st = jax.jit(train_batch)(st, jnp.asarray(K64_BATCH, jnp.int32))
    log_single = np.asarray(st.merge_log)[: int(st.merges_done)]
    dst = jax.jit(make_dist_train_batch(make_mesh(world)))(_k64_state(english_text, world),
                                                     jnp.asarray(K64_BATCH, jnp.int32))
    log_dist = np.asarray(dst.merge_log)[: int(dst.merges_done)]
    port = runs.get(world)["k64"]
    assert port["early"] == 1 and port["done"] == 65_536 - K64_START
    assert port["log"][-1][1] == 65_535
    np.testing.assert_array_equal(np.asarray(port["log"], np.int64), log_dist.astype(np.int64))
    np.testing.assert_array_equal(log_dist, log_single)


@pytest.mark.parametrize("world", [1, 2, 3, 8])
def test_shard_stream_bitwise(english_text, world):
    data, starts = _pretok(english_text)
    stream = jax_make_stream(data, starts, dedup=True)
    args = (stream.symbols[: stream.n], stream.weights[: stream.n], world)
    for got, want in zip(shard_stream(*args), jax_shard_stream(*args), strict=True):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _stream(rng, n, cap, toks, ws_p=0.15):
    sym = np.zeros(cap, np.uint32)
    sym[:n] = rng.choice(np.asarray(toks, np.uint32), size=n)
    sym[:n] |= (rng.random(n) < ws_p).astype(np.uint32) << 16
    sym[0] |= 1 << 16
    w = np.zeros(cap, np.int32)
    w[:n] = rng.integers(1, 9, size=n)
    return sym, w


@pytest.mark.parametrize("cap,n", [(4096, 3000), (5120, 5000), (3072, 0)])
def test_merge_compact_matches_pallas(cap, n):
    """The probe-less merge at shard capacities (a multiple of 1024 that is
    not a power of two among them) against the Pallas ``merge_compact`` in
    interpret mode, bitwise; the 6-tuple call agrees with the 3-tuple one."""
    rng = np.random.default_rng(cap + n)
    toks = list(range(1, 7))
    sym, w = _stream(rng, n, cap, toks)
    pair, new_id = pack_pair(toks[1], toks[2]), 300
    j = pk.merge_compact(jnp.asarray(sym), jnp.asarray(w), jnp.asarray(n), jnp.uint32(pair), jnp.uint32(new_id),
                         interpret=True)
    args = (torch.from_numpy(sym.view(np.int32)), torch.from_numpy(w), n, pair, new_id)
    p = tk.merge_compact(*args)
    assert len(p) == 3
    np.testing.assert_array_equal(p[0].numpy().view(np.uint32), np.asarray(j[0]))
    np.testing.assert_array_equal(p[1].numpy(), np.asarray(j[1]))
    assert int(p[2]) == int(np.asarray(j[2]).reshape(-1)[0])
    full = tk.merge_compact_tracked(*args)
    assert len(full) == 6
    for a, b in zip(full[:3], p):
        assert torch.equal(a, b)


def test_round_robin_equals_sequential_passes(english_text):
    """Passes spread over two devices (both the CPU here), with the window of
    passes in flight, give the ids of passes run one after another and of
    one single pass."""
    vocab = _references("dedup", english_text)[1].vocab
    corpus = english_text.encode()[:12_000]
    seq = Tokenizer(vocab, device="cpu", max_pass_bytes=2048)
    rr = Tokenizer(vocab, device="cpu", max_pass_bytes=2048, devices=["cpu", "cpu"])
    assert rr.devices == [torch.device("cpu")] * 2 and len(corpus) > 4 * rr.max_pass_bytes
    got = rr.encode_bytes(corpus)
    np.testing.assert_array_equal(got, seq.encode_bytes(corpus))
    np.testing.assert_array_equal(got, Tokenizer(vocab, device="cpu").encode_bytes(corpus))


def test_api_dist_in_one_process(english_text):
    """``api.train(backend="dist", device="cpu")`` with no process group set
    up trains in a group of this process alone, tears it down, and equals
    the single-chip backend."""
    import torch.distributed as dist

    text = english_text[:3000]
    cfg = dict(vocab_size=300, device="cpu", show_progress=False)
    tok, res = api.train(text, api.TrainConfig(backend="dist", **cfg))
    assert not dist.is_initialized()
    _, single = api.train(text, api.TrainConfig(**cfg))
    assert res.merges == single.merges and res.merge_counts == single.merge_counts
    assert tok.backend == "cuda" and tok.model.merges == single.merges


def test_one_rank_group_collectives():
    with one_rank_group("cpu") as g:
        assert (g.rank, g.world_size, g.device, g.backend) == (0, 1, torch.device("cpu"), "gloo")
        x = torch.tensor([3, -1, 7])
        assert torch.equal(g.psum(x), x) and torch.equal(g.pmax(x), x) and torch.equal(g.pmin(x), x)
        assert torch.equal(g.all_gather(x), x)
        y = g.psum(x)
        y += 1
        assert torch.equal(x, torch.tensor([3, -1, 7]))  # the input is left as it is


def test_no_group_is_an_error(monkeypatch):
    from gpu_bpe_tpu_torch.parallel import multihost

    for var in (multihost.ENV_COORDINATOR, multihost.ENV_NUM_PROCESSES, multihost.ENV_PROCESS_ID):
        monkeypatch.delenv(var, raising=False)
    assert init_multihost(device="cpu") == (0, 1)  # nothing configured: one process, no group
    with pytest.raises(RuntimeError, match="init_multihost"):
        DistributedTrainer(device="cpu")
    with pytest.raises(RuntimeError, match="init_multihost"):
        DataGroup.current("cpu")
    monkeypatch.setenv(multihost.ENV_COORDINATOR, "127.0.0.1:1")
    with pytest.raises(ValueError, match="num_processes"):
        init_multihost(device="cpu")
