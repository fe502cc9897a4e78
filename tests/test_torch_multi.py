"""The port's multi-merge iteration (``Trainer(multi_merge=True)``, the
reference's ``GPU_BPE_TPU_MULTI``) on the CPU with the plain kernels.

Tolerance 0: merge lists and counts are compared exactly, against the JAX
package's TPUTrainer with ``GPU_BPE_TPU_MULTI=1`` (in a subprocess: the
flag is read once per process and cached at trace time), with and without
``GPU_BPE_TPU_PALLAS_INTERPRET=1`` (the Pallas branch of its
``_merge_and_track`` in interpret mode), the port's default loop and the
CPU oracle ``ReferenceTrainer``. The same holds for the ground truth of
``GPU_BPE_TPU_FORCE_RECOUNT=1`` in both loops, which must also reach the
port's API, streamed API and CLI."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from gpu_bpe_tpu.core import ReferenceTrainer, bytes_to_symbols, tag_word_boundaries  # noqa: E402
from gpu_bpe_tpu.core import Vocab as JaxVocab  # noqa: E402
from gpu_bpe_tpu.ops import init_state as jax_init_state  # noqa: E402
from gpu_bpe_tpu.ops.ingest import make_stream as jax_make_stream  # noqa: E402
from gpu_bpe_tpu.ops.ingest import pad_stream as jax_pad_stream  # noqa: E402
from gpu_bpe_tpu.ops.pallas_kernels import merge_compact_tracked as pallas_merge  # noqa: E402
from gpu_bpe_tpu.ops.train_step import train_batch as jax_train_batch  # noqa: E402
from gpu_bpe_tpu.pretok import PreTokenizer  # noqa: E402
from gpu_bpe_tpu_torch import Trainer, Vocab, api  # noqa: E402
from gpu_bpe_tpu_torch.ops import kernels  # noqa: E402
from gpu_bpe_tpu_torch.ops import train_step as ts  # noqa: E402
from gpu_bpe_tpu_torch.ops import trainer as tr  # noqa: E402
from gpu_bpe_tpu_torch.ops.ingest import make_stream, pad_stream  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
VOCAB = 330
JAX_WORKER = """\
import sys, json
import jax
jax.config.update('jax_platforms', 'cpu')
from gpu_bpe_tpu.ops import TPUTrainer
from gpu_bpe_tpu.pretok import PreTokenizer
data, starts = PreTokenizer().pre_tokenize_bytes(open(sys.argv[1], 'rb').read())
r = TPUTrainer().train(data, starts, target_vocab_size=int(sys.argv[3]))
json.dump({'m': r.merges, 'c': r.merge_counts, 'duals': r.duals, 'recounts': r.recounts}, open(sys.argv[2], 'w'))
"""
JAX_MODES = {"jnp": {}, "interpret": {"GPU_BPE_TPU_PALLAS_INTERPRET": "1"}}
# GPU_BPE_TPU_FORCE_RECOUNT=1: the port's three entry points in one process,
# each run's result taken from Trainer.train_stream
PORT_FORCE_WORKER = """\
import sys, json
from gpu_bpe_tpu_torch import api, cli
from gpu_bpe_tpu_torch.ops import trainer as tr
runs = []
real = tr.Trainer.train_stream
def record(self, *a, **k):
    r = real(self, *a, **k)
    runs.append({'m': r.merges, 'c': r.merge_counts, 'recounts': r.recounts, 'duals': r.duals,
                 'force_recount': self.force_recount})
    return r
tr.Trainer.train_stream = record
corpus, out, vocab, tmp = sys.argv[1:5]
config = api.TrainConfig(vocab_size=int(vocab), device='cpu', show_progress=False)
api.train(open(corpus, 'rb').read(), config)
api.train_files([corpus], config)
assert cli.main(['train', corpus, '-o', tmp + '/m.json', '--vocab-size', vocab, '--device', 'cpu']) == 0
json.dump(runs, open(out, 'w'))
"""
FORCE_LOOPS = {"default": {}, "multi": {"GPU_BPE_TPU_MULTI": "1"}}
ENTRY_POINTS = ("api.train", "api.train_files", "cli train")


@pytest.fixture(scope="module")
def corpus(english_text) -> bytes:
    """The 8000-byte English corpus of the JAX package's multi-merge test."""
    return (english_text * 12).encode()[:8000]


@pytest.fixture(scope="module")
def jax_multi(corpus, tmp_path_factory):
    """TPUTrainer with GPU_BPE_TPU_MULTI=1 in both JAX modes, the two
    processes run side by side: {mode: {"m", "c", "duals", "recounts"}}."""
    tmp = tmp_path_factory.mktemp("jax_multi")
    (tmp / "w.py").write_text(JAX_WORKER)
    (tmp / "c.txt").write_bytes(corpus)
    procs = {}
    for mode, extra in JAX_MODES.items():
        env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", GPU_BPE_TPU_MULTI="1", **extra)
        procs[mode] = subprocess.Popen([sys.executable, str(tmp / "w.py"), str(tmp / "c.txt"),
                                        str(tmp / f"{mode}.json"), str(VOCAB)],
                                       env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out = {}
    for mode, p in procs.items():
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-2000:]
        out[mode] = json.loads((tmp / f"{mode}.json").read_text())
    return out


@pytest.fixture(scope="module")
def force_env_runs(corpus, tmp_path_factory):
    """With GPU_BPE_TPU_FORCE_RECOUNT=1, side by side: TPUTrainer in the
    default loop and with GPU_BPE_TPU_MULTI=1 ({"jax": {loop: result}}), and
    the port's api.train, api.train_files and CLI train in one process
    ({"port": [result per entry point]})."""
    tmp = tmp_path_factory.mktemp("force_env")
    (tmp / "w.py").write_text(JAX_WORKER)
    (tmp / "p.py").write_text(PORT_FORCE_WORKER)
    (tmp / "c.txt").write_bytes(corpus)
    base = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", GPU_BPE_TPU_FORCE_RECOUNT="1")
    base.pop("GPU_BPE_TPU_MULTI", None)
    procs = {("jax", loop): subprocess.Popen(
        [sys.executable, str(tmp / "w.py"), str(tmp / "c.txt"), str(tmp / f"jax_{loop}.json"), str(VOCAB)],
        env=dict(base, **extra), stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for loop, extra in FORCE_LOOPS.items()}
    procs[("port", None)] = subprocess.Popen(
        [sys.executable, str(tmp / "p.py"), str(tmp / "c.txt"), str(tmp / "port.json"), str(VOCAB), str(tmp)],
        env=base, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out = {"jax": {}}
    for (who, loop), p in procs.items():
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-2000:]
        if who == "jax":
            out["jax"][loop] = json.loads((tmp / f"jax_{loop}.json").read_text())
        else:
            out["port"] = json.loads((tmp / "port.json").read_text())
    return out


def _pretok(text):
    return PreTokenizer().pre_tokenize(text) if isinstance(text, str) else PreTokenizer().pre_tokenize_bytes(text)


def _oracle(data, starts, vocab_size, vocab=None):
    sym = bytes_to_symbols(data)
    sym = tag_word_boundaries(sym, starts) if starts is not None else sym
    if starts is None:
        sym[0] |= 1 << 16
    return ReferenceTrainer(vocab).train(sym, target_vocab_size=vocab_size)


def _multi(data, starts, vocab_size, **kw):
    dedup = kw.pop("dedup", True)
    return Trainer(device="cpu", multi_merge=True, **kw).train(data, starts, target_vocab_size=vocab_size,
                                                                dedup=dedup)


def _same(a, b):
    assert a.merges == b.merges
    assert a.merge_counts == b.merge_counts


@pytest.mark.parametrize("mode", list(JAX_MODES))
def test_multi_matches_jax_multi_default_and_oracle(corpus, jax_multi, mode):
    data, starts = _pretok(corpus)
    port = _multi(data, starts, VOCAB)
    jr = jax_multi[mode]
    print(f"{mode}: duals port {port.duals} jax {jr['duals']}; recounts port {port.recounts} jax {jr['recounts']}")
    assert port.merges == [tuple(m) for m in jr["m"]] and port.merge_counts == jr["c"]
    _same(port, Trainer(device="cpu").train(data, starts, target_vocab_size=VOCAB))
    _same(port, _oracle(data, starts, VOCAB))
    assert len(port.merges) == VOCAB - 256
    assert port.duals >= 1
    if mode == "interpret":
        # the stream fits one 32K Pallas block, so the samp rules agree and
        # so do the ceilings, the certificates and with them the duals
        assert (port.duals, port.recounts) == (jr["duals"], jr["recounts"])


def test_window_probes_equal_the_jax_explicit_list(corpus, monkeypatch):
    """Merges of the multi path (three that affect window slots, one that
    affects none): the kernel's window-mode probe list and probe counts
    equal the list the reference builds from the window
    (``train_step.py:575-593``: affected slots gathered by rank, count 0
    when more than N_PROBES) counted by the Pallas kernel in interpret mode."""
    calls = []
    real = ts.merge_compact_tracked

    def record(*args):
        out = real(*args)
        calls.append(([a.clone() if isinstance(a, torch.Tensor) else a for a in args], out))
        return out

    monkeypatch.setattr(ts, "merge_compact_tracked", record)
    data, starts = _pretok(corpus)
    _multi(data, starts, VOCAB)
    n_aff = [int(out[8]) for _, out in calls]
    picks = [i for i, k in enumerate(n_aff) if k > 0][:3] + [n_aff.index(0)]
    assert len(picks) == 4
    for i in picks:
        (sym, w, n, pair, new_id, cand, counts), out = calls[i]
        u32 = lambda t: jnp.asarray(t.numpy().astype(np.uint32))  # noqa: E731
        jc, jcnt, jpair = u32(cand), jnp.asarray(counts.numpy().astype(np.int32)), jnp.uint32(int(pair))
        affected = (jcnt >= 0) & (((jc & 0xFFFF) == (jpair >> 16)) | ((jc >> 16) == (jpair & 0xFFFF))) & (jc != jpair)
        naff = jnp.sum(affected.astype(jnp.int32))
        rank = jnp.cumsum(affected.astype(jnp.int32)) - 1
        ia = jnp.arange(kernels.N_PROBES)
        sel = affected[None, :] & (rank[None, :] == ia[:, None])
        probes = jnp.where(ia < naff, jnp.sum(jnp.where(sel, jc[None, :], jnp.uint32(0)), axis=1), jnp.uint32(1))
        count = jnp.where(naff <= kernels.N_PROBES, naff, 0)
        j = pallas_merge(u32(sym), jnp.asarray(w.numpy()), jnp.int32(int(n)), jpair, jnp.uint32(int(new_id)),
                         probes=(probes, count), interpret=True)
        assert int(naff) == int(out[8])
        np.testing.assert_array_equal(np.asarray(probes).astype(np.int64), out[7].numpy())
        np.testing.assert_array_equal(np.asarray(j[6]).astype(np.int64), out[6].numpy())
        np.testing.assert_array_equal(np.asarray(j[0]).astype(np.uint32), out[0].numpy().astype(np.uint32))
        assert int(j[2]) == int(out[2])


def test_force_recount(english_text):
    data, starts = _pretok(english_text[:10000])
    cert = _multi(data, starts, 400)
    truth = _multi(data, starts, 400, force_recount=True)
    _same(cert, truth)
    _same(cert, _oracle(data, starts, 400))
    assert truth.duals == 0 and truth.recounts >= len(truth.merges)
    assert cert.duals > 0 and cert.recounts < truth.recounts


def test_permuted_word_order(english_text):
    d1, s1 = _pretok(english_text[:12000])
    cuts = np.append(np.flatnonzero(s1), len(d1))
    words = [d1[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    perm = [words[i] for i in np.random.default_rng(9).permutation(len(words))]
    d2 = b"".join(perm)
    s2 = np.zeros(len(d2), np.uint8)
    s2[np.cumsum([0] + [len(w) for w in perm[:-1]])] = 1
    first = _multi(d1, s1, 400, dedup=False)
    _same(first, _oracle(d1, s1, 400))
    _same(first, _multi(d2, s2, 400, dedup=False))
    _same(first, _multi(d2, s2, 400, dedup=True))


def test_wide_merges_take_the_dense_path(monkeypatch):
    """The first winner (a,b) leaves more than N_PROBES affected window
    slots: the iteration's window is recounted densely (a second host
    read) and the merge list still equals the oracle's."""
    words = [bytes([x, 1, 2, y]) for x in range(40, 120) for y in range(40, 52)]
    data = b" ".join(w for w in words for _ in range(3))
    starts = np.zeros(len(data), np.uint8)
    starts[::5] = 1
    calls = []
    real = ts._post_counts
    monkeypatch.setattr(ts, "_post_counts", lambda *a: calls.append(1) or real(*a))
    ts.HOST_READS.clear()
    port = _multi(data, starts, 256 + 30)
    _same(port, _oracle(data, starts, 256 + 30))
    assert calls and ts.HOST_READS["wide"] == len(calls)


def test_wide_merges_of_a_dual(english_text, monkeypatch):
    """With the probe limit lowered to 2 in the train step (the kernel still
    probes up to 64 slots, and those counts are ignored), most merges are
    wide, among them both merges of duals: each such iteration's window is
    recounted densely on its final stream, and the merge list equals the
    oracle's and the run with the real limit."""
    data, starts = _pretok(english_text[:10000])
    full = _multi(data, starts, 400)
    trace = []
    real_one, real_track = ts._one_merge, ts._merge_and_track

    def one(*a):
        trace.append([])
        return real_one(*a)

    def track(st, pair, count, row, active=None):
        out = real_track(st, pair, count, row, active)
        if active is None or bool(active):
            trace[-1].append(int(out[2]))
        return out

    monkeypatch.setattr(ts, "N_PROBES", 2)
    monkeypatch.setattr(ts, "_one_merge", one)
    monkeypatch.setattr(ts, "_merge_and_track", track)
    ts.HOST_READS.clear()
    port = _multi(data, starts, 400)
    _same(port, full)
    _same(port, _oracle(data, starts, 400))
    both_wide = [it for it in trace if len(it) >= 2 and min(it[:2]) > 2]
    assert both_wide and ts.HOST_READS["wide"] == sum(max(it, default=0) > 2 for it in trace)


def test_segmented_recount(monkeypatch):
    rng = np.random.default_rng(3)
    words = ["".join(chr(97 + int(c)) for c in rng.integers(0, 12, size=int(rng.integers(2, 9))))
             for _ in range(300)]
    data = " ".join(words[i] for i in rng.integers(0, len(words), size=4000)).encode()
    starts = np.zeros(len(data), np.uint8)
    starts[0] = 1
    starts[1:] = np.frombuffer(data, np.uint8)[:-1] == 32
    oracle = _oracle(data, starts, 256 + 80)
    monkeypatch.setattr(ts, "_SEG_RECOUNT_MIN_CAP", 1 << 12)
    monkeypatch.setattr(ts, "_SEG_RECOUNT_M", 1 << 9)
    ts.RECOUNTS.clear()
    port = _multi(data, starts, 256 + 80, dedup=False)
    assert ts.RECOUNTS["seg_cap/8"] + ts.RECOUNTS["seg_cap/2"] >= 1
    _same(port, oracle)
    _same(port, _multi(data, starts, 256 + 80, dedup=False, force_recount=True))


def test_next_id_above_0x8000(english_text):
    filler = [bytes([1, i & 0xFF, i >> 8]) for i in range(0x8000 + 7 - 256)]
    base = [bytes([i]) for i in range(256)] + filler
    data, starts = _pretok(english_text[:6000])
    port = Trainer(Vocab.from_entries(base), device="cpu", multi_merge=True).train(
        data, starts, target_vocab_size=len(base) + 80)
    _same(port, _oracle(data, starts, len(base) + 80, vocab=JaxVocab.from_entries(base)))
    assert any(a >= 0x8000 for a, _b, _z in port.merges) and port.duals > 0


def test_64k_id_stop(english_text):
    """Next id 6 below the 16-bit cap: the batch stops after id 65,535, its
    log equal to the JAX single-chip batch's; through the trainer, the
    merge list equals the oracle's with the same 65,530-entry vocab."""
    start = 65_530
    data, starts = _pretok(english_text[:8000])
    stream = make_stream(data, starts)
    padded = pad_stream(stream)
    st = ts.train_batch(ts.init_state(padded.symbols, padded.weights, stream.n, start, device="cpu"), 64,
                        multi_merge=True)
    jstream = jax_make_stream(data, starts, dedup=True)
    jp = jax_pad_stream(jstream)
    jst = jax_train_batch(jax_init_state(jnp.asarray(jp.symbols), jnp.asarray(jp.weights), jstream.n, start),
                          jnp.asarray(64, jnp.int32))
    done = int(st.merges_done)
    assert int(st.early_stop) == 1 and done == 65_536 - start == int(jst.merges_done)
    np.testing.assert_array_equal(st.merge_log[: 3 * done].reshape(-1, 3).numpy(),
                                  np.asarray(jst.merge_log)[:done].astype(np.int64))
    base = [bytes([i]) for i in range(256)] + [bytes([1, i & 0xFF, i >> 8]) for i in range(start - 256)]
    port = Trainer(Vocab.from_entries(base), device="cpu", multi_merge=True).train(data, starts, 65_600)
    _same(port, _oracle(data, starts, 65_600, vocab=JaxVocab.from_entries(base)))
    assert port.vocab_size == 65_536


@pytest.mark.parametrize("write_multi", [True, False])
def test_checkpoint_resumed_in_the_other_mode(english_text, tmp_path, write_multi):
    data, starts = _pretok(english_text[:6000])
    stream = make_stream(data, starts)
    one_shot = Trainer(device="cpu").train_stream(stream, target_vocab_size=340)
    path = str(tmp_path / "ckpt.json")
    Trainer(batch_merges=16, device="cpu", multi_merge=write_multi).train_stream(
        stream, target_vocab_size=300, checkpoint_path=path, checkpoint_every=1)
    resumed = Trainer(batch_merges=16, device="cpu", multi_merge=not write_multi).train_stream(
        stream, target_vocab_size=340, checkpoint_path=path)
    _same(resumed, one_shot)


def test_env_selects_the_multi_path(corpus, monkeypatch):
    """GPU_BPE_TPU_MULTI is read when the Trainer is built, so api.train,
    api.train_files and the CLI reach the path through the environment."""
    config = api.TrainConfig(vocab_size=VOCAB, device="cpu", show_progress=False)
    monkeypatch.delenv("GPU_BPE_TPU_MULTI", raising=False)
    assert not Trainer(device="cpu").multi_merge
    _, default = api.train(corpus, config)
    monkeypatch.setenv("GPU_BPE_TPU_MULTI", "1")
    assert Trainer(device="cpu").multi_merge and not Trainer(device="cpu", multi_merge=False).multi_merge
    _, multi = api.train(corpus, config)
    _same(multi, default)
    assert default.duals == 0 and multi.duals > 0


def test_dispatch_target_only_moves_batch_ends(english_text, monkeypatch):
    """GPU_BPE_TPU_DISPATCH_TARGET_S sets the recount budget per batch as in
    the reference package; a budget of 4 recounts per batch splits a
    recount-every-merge run into more batches with the same merge list."""
    data, starts = _pretok(english_text[:6000])
    runs = {}
    for target in (None, "1e-9"):
        if target is None:
            monkeypatch.delenv("GPU_BPE_TPU_DISPATCH_TARGET_S", raising=False)
        else:
            monkeypatch.setenv("GPU_BPE_TPU_DISPATCH_TARGET_S", target)
        events = []
        res = Trainer(device="cpu", force_recount=True, multi_merge=True).train(
            data, starts, target_vocab_size=300, on_progress=events.append)
        runs[target] = (res, len(events))
    assert tr._recount_budget(1 << 20) == 4
    monkeypatch.delenv("GPU_BPE_TPU_DISPATCH_TARGET_S")
    assert tr._recount_budget(1 << 20) == int(tr._DISPATCH_TARGET_S / (tr._RECOUNT_S_PER_ELEM * (1 << 20)))
    _same(runs[None][0], runs["1e-9"][0])
    assert runs[None][1] == 1 and runs["1e-9"][1] >= 44 // 4


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fuzz_random_corpora(seed):
    rng = np.random.default_rng(seed)
    alpha = int(rng.integers(3, 30))
    n_words = int(rng.integers(50, 400))
    words = [bytes(rng.integers(1, 1 + alpha, size=int(rng.integers(1, 12))).tolist())
             for _ in range(n_words)]
    reps = rng.zipf(1.3, size=n_words).clip(1, 500)
    corpus = [w for w, r in zip(words, reps) for _ in range(int(r))]
    rng.shuffle(corpus)
    data = b" ".join(corpus)
    starts = np.zeros(len(data), np.uint8)
    pos = 0
    for w in corpus:
        starts[pos] = 1
        pos += len(w) + 1
    target = 256 + int(rng.integers(20, 200))
    port = _multi(data, starts, target)
    _same(port, _oracle(data, starts, target))
    _same(port, Trainer(device="cpu").train(data, starts, target_vocab_size=target))


def test_maintained_counts_stay_exact():
    """The exact-window-counts invariant on the multi path: after every
    batch, each live window slot's count equals its pair-stream count."""
    text = "aaaaaa bb aaaa abab baba " * 40 + "cc ccc cccc the then there " * 30
    data, starts = _pretok(text)
    stream = make_stream(data, starts)
    padded = pad_stream(stream)
    st = ts.init_state(padded.symbols, padded.weights, stream.n, 256, device="cpu")
    duals = 0
    for _ in range(6):
        st = ts.train_batch(st, 16, multi_merge=True)
        pair, valid = ts._pair_ids(st.symbols, st.n)
        w = torch.where(valid, st.weights.to(torch.int64), 0)
        for c, k in zip(st.cand.tolist(), st.cand_counts.tolist()):
            if k >= 0:
                assert int(w[pair == c].sum()) == k
        duals = int(st.duals)
        if int(st.early_stop):
            break
    assert duals > 0


@pytest.mark.parametrize("loop", list(FORCE_LOOPS))
def test_force_recount_env_matches_jax(corpus, force_env_runs, monkeypatch, loop):
    """GPU_BPE_TPU_FORCE_RECOUNT=1 read by Trainer(): the merge list, counts
    and recounts equal TPUTrainer's under the same variables, in the
    default loop and in the multi-merge loop."""
    monkeypatch.setenv("GPU_BPE_TPU_FORCE_RECOUNT", "1")
    monkeypatch.delenv("GPU_BPE_TPU_MULTI", raising=False)
    for k, v in FORCE_LOOPS[loop].items():
        monkeypatch.setenv(k, v)
    data, starts = _pretok(corpus)
    trainer = Trainer(device="cpu")
    assert trainer.force_recount and trainer.multi_merge == (loop == "multi")
    port = trainer.train(data, starts, target_vocab_size=VOCAB)
    jr = force_env_runs["jax"][loop]
    print(f"{loop}: recounts port {port.recounts} jax {jr['recounts']}; duals port {port.duals} jax {jr['duals']}")
    assert port.merges == [tuple(m) for m in jr["m"]] and port.merge_counts == jr["c"]
    assert port.recounts == jr["recounts"] == len(port.merges) == VOCAB - 256
    assert port.duals == jr["duals"] == 0


@pytest.mark.parametrize("entry", range(len(ENTRY_POINTS)), ids=ENTRY_POINTS)
def test_force_recount_env_reaches_the_entry_points(corpus, force_env_runs, monkeypatch, entry):
    """api.train, api.train_files and the CLI's train, in a process with
    GPU_BPE_TPU_FORCE_RECOUNT=1: a recount before every merge, and the merge
    list of a run without the variable."""
    monkeypatch.delenv("GPU_BPE_TPU_FORCE_RECOUNT", raising=False)
    monkeypatch.delenv("GPU_BPE_TPU_MULTI", raising=False)
    _, plain = api.train(corpus, api.TrainConfig(vocab_size=VOCAB, device="cpu", show_progress=False))
    runs = force_env_runs["port"]
    assert len(runs) == len(ENTRY_POINTS)
    run = runs[entry]
    assert run["force_recount"] and run["recounts"] == len(run["m"]) == VOCAB - 256 and run["duals"] == 0
    assert [tuple(m) for m in run["m"]] == plain.merges and run["c"] == plain.merge_counts
    assert plain.recounts < len(plain.merges)


def test_explicit_force_recount_false_wins_over_the_env(corpus, monkeypatch):
    monkeypatch.setenv("GPU_BPE_TPU_FORCE_RECOUNT", "1")
    assert Trainer(device="cpu").force_recount
    trainer = Trainer(device="cpu", force_recount=False)
    assert not trainer.force_recount
    data, starts = _pretok(corpus)
    res = trainer.train(data, starts, target_vocab_size=VOCAB)
    assert res.recounts < len(res.merges)
    monkeypatch.setenv("GPU_BPE_TPU_FORCE_RECOUNT", "")  # the reference's truthiness: empty is off
    assert not Trainer(device="cpu").force_recount


@pytest.mark.parametrize("multi", [False, True])
def test_force_recount_env_after_a_resume(english_text, tmp_path, monkeypatch, multi):
    """A checkpoint written without the variable, resumed with it set: the
    loop entered after the replay recounts before every merge, and the
    list equals the one-shot run's."""
    monkeypatch.delenv("GPU_BPE_TPU_FORCE_RECOUNT", raising=False)
    data, starts = _pretok(english_text[:6000])
    stream = make_stream(data, starts)
    one_shot = Trainer(device="cpu", multi_merge=multi).train_stream(stream, target_vocab_size=340)
    path = str(tmp_path / "ckpt.json")
    Trainer(batch_merges=16, device="cpu", multi_merge=multi).train_stream(
        stream, target_vocab_size=300, checkpoint_path=path, checkpoint_every=1)
    monkeypatch.setenv("GPU_BPE_TPU_FORCE_RECOUNT", "1")
    resumed = Trainer(batch_merges=16, device="cpu", multi_merge=multi).train_stream(
        stream, target_vocab_size=340, checkpoint_path=path)
    _same(resumed, one_shot)
    assert resumed.recounts == 340 - 300 and resumed.duals == 0
