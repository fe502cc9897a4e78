"""The port's tracer (``gpu_bpe_tpu_torch.utils.timing``) and the benchmark's
readers of its spans (``perfbench/spans.py``, ``perfbench/metrics/``), on
the CPU.

Off, a span records nothing, reads no clock and enters no profiler range.
On, spans nest with parent indices in the order they end, one root per
``api.train`` job or ``Tokenizer.encode_bytes`` call; each ``train.read``
sits where ``train_step.HOST_READS`` counts and each ``train.recount``
carries the ``RECOUNTS`` key it bumped. Spans share the clock of
``torch.profiler``'s events. The idle split by innermost span and the two
span readers are held to numbers worked out by hand on a fixed span list.
"""

import time

import numpy as np
import pytest
import torch

from gpu_bpe_tpu_torch import api
from gpu_bpe_tpu_torch.ops import train_step as ts
from gpu_bpe_tpu_torch.ops import tokenize as ttz
from gpu_bpe_tpu_torch.ops.tokenize import Tokenizer
from gpu_bpe_tpu_torch.utils import PhaseTimer, timing
from gpu_bpe_tpu_torch.utils.timing import Span, span
from perfbench import run, spans, trace

CORPUS = b"the cat sat on the mat and the hat ran to the cat that sat " * 60


@pytest.fixture(autouse=True)
def tracer_off():
    """Each test starts and ends with tracing off and no spans (the
    readers turn it on when they are loaded)."""
    timing.disable()
    timing.clear()
    yield
    timing.disable()
    timing.clear()


def _names(sp):
    return [s.name for s in sp]


def _roots(sp):
    """For each span, the index of its root."""
    out = [-1] * len(sp)
    for i in range(len(sp) - 1, -1, -1):  # a parent ends after its children
        out[i] = i if sp[i].parent == -1 else out[sp[i].parent]
    return out


# ─────────────────────────────── the tracer ───────────────────────────────


def test_off_records_nothing_reads_no_clock_and_enters_no_range(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("read or entered while tracing is off")

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]), monkeypatch.context() as m:
        m.setattr(time, "time_ns", boom)
        m.setattr(torch.profiler, "record_function", boom)
        m.setattr(timing, "_range", boom)
        for _ in range(3):
            with span("train.read", "merge") as a, span("train.batch") as b:
                b.note(merges=4)
    assert a is b and a is span("x")  # one shared object
    assert timing.spans() == []


def test_nesting_parents_attributes_and_roots():
    assert timing.enable() is False and timing.enable() is True
    for job in range(2):
        with span("train.job") as root:
            with span("train.batch") as b:
                b.note(merges=8, capacity=2048)
                with span("train.read", "merge"):
                    pass
                with span("train.recount") as r:
                    with span("train.read", "seg_recount"):
                        pass
                    r.note(tier="seg_cap/8")
            with span("train.read", "summary"):
                pass
            root.note(merges=8, symbols=100)
    sp = timing.spans()
    assert _names(sp[:6]) == ["train.read", "train.read", "train.recount", "train.batch", "train.read", "train.job"]
    assert [s.parent for s in sp[:6]] == [3, 2, 3, 5, 5, -1]
    assert sp[0].attrs == {"site": "merge"} and sp[2].attrs == {"tier": "seg_cap/8"}
    assert sp[3].attrs == {"merges": 8, "capacity": 2048} and sp[5].attrs == {"merges": 8, "symbols": 100}
    assert [s.parent for s in sp[6:]] == [9, 8, 9, 11, 11, -1]  # the second job's own root
    assert _roots(sp) == [5] * 6 + [11] * 6
    for s in sp:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = sp[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    timing.clear(6)
    assert timing.spans() == sp[:6]
    timing.clear()
    assert timing.spans() == []


def test_clear_keeps_the_open_spans_parents_right():
    timing.enable()
    with span("train.job"):
        with span("train.upload"):
            pass
        timing.clear()
        with span("train.batch"):
            pass
    assert _names(timing.spans()) == ["train.batch", "train.job"]
    assert [s.parent for s in timing.spans()] == [1, -1]


def test_span_still_open_has_no_parent_yet():
    timing.enable()
    with span("tokenize.call"):
        with span("tokenize.pass"):
            pass
        assert timing.spans()[0].parent is None
    assert timing.spans()[0].parent == 1


@pytest.mark.parametrize("on", [False, True])
def test_phase_timer_phase_is_a_span(on, tmp_path):
    """A phase is a span; with ``profile_dir`` it is one profiler range of
    its name whether tracing is on or off."""
    if on:
        timing.enable()
    t = PhaseTimer(profile_dir=str(tmp_path))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with t.phase("export"):
            with span("inner"):
                pass
    assert _names(timing.spans()) == ["inner", "export"][: 2 * on] and t.counts == {"export": 1}
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("export") == 1 and names.count("inner") == int(on)
    timing.disable()
    with PhaseTimer(profile_dir=str(tmp_path)).phase("export"):
        pass
    assert len(timing.spans()) == 2 * on


# ──────────────────────────── spans of the program ────────────────────────────


@pytest.mark.parametrize("mode", ["words", "bytes", "multi", "no_dedup"])
def test_train_gives_its_spans_and_one_read_per_host_read(mode, monkeypatch):
    if mode == "multi":
        monkeypatch.setenv("GPU_BPE_TPU_MULTI", "1")
    cfg = api.TrainConfig(vocab_size=300, device="cpu", show_progress=False, pre_tokenize=mode != "bytes",
                          dedup=mode != "no_dedup")
    reads0 = sum(ts.HOST_READS.values())
    timing.enable()
    _, res = api.train(CORPUS, cfg)
    sp = timing.spans()
    reads = sum(ts.HOST_READS.values()) - reads0
    assert [s.name for s in sp].count("train.read") == reads
    root = sp[-1]
    assert root.name == "train.job" and root.parent == -1 and _roots(sp) == [len(sp) - 1] * len(sp)
    assert root.attrs == {"merges": len(res.merges), "symbols": len(CORPUS)}
    top = [s.name for s in sp if s.parent == len(sp) - 1]
    ingest = ["train.byte_stream"] if mode == "bytes" else ["train.pretokenize", "train.dedup"]
    assert top[: len(ingest) + 1] == ingest + ["train.upload"]
    assert top[-1] == "train.build" and {"train.batch", "train.read"} == set(top[len(ingest) + 1 : -1])
    sites = {s.attrs["site"] for s in sp if s.name == "train.read"}
    assert "summary" in sites and "batch" in sites
    assert ("iteration" in sites) == (mode == "multi") and ("merge" in sites) != (mode == "multi")
    batch = {i for i, s in enumerate(sp) if s.name == "train.batch"}
    assert all(s.parent in batch for s in sp if s.name == "train.recount")
    assert sum(s.name == "train.recount" for s in sp) == res.recounts
    assert all(s.attrs["tier"] == "monolithic" for s in sp if s.name == "train.recount")


@pytest.mark.parametrize("letters,tier", [(6, "seg_cap/8"), (20, "seg_cap/2"), (200, "seg_fallback"),
                                          (6, "monolithic")])
def test_recount_span_carries_the_tier_it_bumped(letters, tier, monkeypatch):
    if tier != "monolithic":  # the segmented gate lowered to 2^12, segments of 2^10 rows
        monkeypatch.setattr(ts, "_SEG_RECOUNT_MIN_CAP", 1 << 12)
        monkeypatch.setattr(ts, "_SEG_RECOUNT_M", 1 << 10)
    rng = np.random.default_rng(letters)
    sym = torch.from_numpy(rng.integers(1, letters + 1, size=1 << 12).astype(np.int32))
    ts.RECOUNTS.clear()
    reads0 = ts.HOST_READS["seg_recount"]
    timing.enable()
    ts._full_recount_impl(sym, torch.ones(1 << 12, dtype=torch.int32), torch.tensor(1 << 12))
    sp = timing.spans()
    assert dict(ts.RECOUNTS) == {tier: 1}
    assert sp[-1].name == "train.recount" and sp[-1].attrs == {"tier": tier}
    seg_reads = [s for s in sp if s.attrs.get("site") == "seg_recount"]
    assert len(seg_reads) == ts.HOST_READS["seg_recount"] - reads0 == (tier != "monolithic")


def _random_vocab(seed, size, lo, hi, letters=8):
    rng = np.random.default_rng(seed)
    vocab = [bytes([b]) for b in range(256)]
    seen = set(vocab)
    while len(vocab) < size:
        t = bytes(rng.integers(97, 97 + letters, size=int(rng.integers(lo, hi))).tolist())
        if t not in seen:
            seen.add(t)
            vocab.append(t)
    return vocab


@pytest.mark.parametrize("case", ["dense", "rank", "gather"])
def test_encode_bytes_gives_its_spans(case, monkeypatch):
    data = bytes(np.random.default_rng(3).integers(97, 105, size=3000).tolist())
    if case == "dense":
        tok = Tokenizer(_random_vocab(1, 400, 2, 6), device="cpu")
    elif case == "rank":
        monkeypatch.setattr(ttz, "_LEVEL_MIN_TOKENS", 1)
        vocab = _random_vocab(5, 2500, 2, 9) + [b"prefixAAsuffix", b"prefixAAs", b"overlongtoken001"]
        tok = Tokenizer(vocab, device="cpu", rank_mode="on")
        data += b"prefixAAsuffixoverlongtoken001"
    else:
        tok = Tokenizer([bytes([b]) for b in range(256)] + [b"C" * 70, b"CC"], device="cpu")
        data += b"C" * 150
    timing.enable()
    ids = tok.encode_bytes(memoryview(data))
    sp = timing.spans()
    assert sp[-1].name == "tokenize.call" and sp[-1].attrs == {"bytes": len(data)}
    assert _roots(sp) == [len(sp) - 1] * len(sp)
    passes = [i for i, s in enumerate(sp) if s.name == "tokenize.pass"]
    assert len(passes) == 1 and sp[passes[0]].attrs == {"bytes": len(data)}
    table = next(s for s in sp if s.name == "tokenize.match_table")
    assert table.parent == passes[0]
    assert table.attrs == {"stab": int(case == "rank"), "dense": len(tok.tables.dense_lengths)}
    assert next(s for s in sp if s.name == "tokenize.walk").parent == passes[0]
    sites = [s.attrs["site"] for s in sp if s.name == "tokenize.read"]
    assert sites[-1] == "ids" and sites.count("ids") == 1
    assert ("rank_count" in sites) == (case == "rank") and ("gather_step" in sites) == (case == "gather")
    timing.disable()
    np.testing.assert_array_equal(ids, tok.encode_bytes(data))  # tracing changes no id


def test_spans_share_the_profilers_clock():
    """Under a CPU profiler every span is also a profiler range of its name,
    an operator's range and not a user annotation (which would add a
    device-side annotation), and lies within 1 ms of it."""
    timing.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm-up"):  # a session's first range carries its lazy set-up
            pass
        api.train(CORPUS, api.TrainConfig(vocab_size=280, device="cpu", show_progress=False))
    sp = timing.spans()
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("train.")]
    assert len(events) == len(sp) > 10
    assert not any(e.is_user_annotation() for e in events)
    by_name = {}
    for e in events:
        by_name.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    for name, got in by_name.items():
        mine = sorted((s.start_ns, s.end_ns) for s in sp if s.name == name)
        assert len(mine) == len(got)
        for (a, b), (c, d) in zip(mine, sorted(got)):
            assert c <= a <= b <= d, name  # read inside the range, on its clock
            assert a - c < 1_000_000 and d - b < 1_000_000, name


# ──────────────────────────────── the readers ────────────────────────────────

MS = 1_000_000
READERS = ("train.idle_dispatch_share", "tokenize.idle_dispatch_share")


def _job(t0, merges):
    """One train job's spans from ``t0`` (ms), in end order; its root last."""
    def s(name, a, b, parent, **attrs):
        return Span(name, int((t0 + a) * MS), int((t0 + b) * MS), parent, attrs)

    return [
        s("train.pretokenize", 0, 30, 9, bytes=1000),
        s("train.dedup", 30, 40, 9, symbols=50),
        s("train.upload", 40, 45, 9, capacity=2048),
        s("train.read", 46, 47, 6, site="batch"),
        s("train.read", 50, 52, 5, site="seg_recount"),
        s("train.recount", 48, 55, 6, tier="seg_cap/8"),
        s("train.batch", 45, 65, 9, merges=merges, capacity=2048),
        s("train.read", 65, 68, 9, site="summary"),
        s("train.build", 68, 70, 9),
        s("train.job", 0, 71, -1, merges=merges, symbols=1000),
    ]


def _offset(sp, base):
    return [x._replace(parent=x.parent + base if x.parent >= 0 else -1) for x in sp]


def _call(t0, nbytes):
    def s(name, a, b, parent, **attrs):
        return Span(name, int((t0 + a) * MS), int((t0 + b) * MS), parent, attrs)

    return [
        s("tokenize.input", 0, 1, 6),
        s("tokenize.read", 3, 4, 2, site="rank_count"),
        s("tokenize.match_table", 2, 6, 4, stab=1),
        s("tokenize.walk", 6, 9, 4),
        s("tokenize.pass", 1, 10, 6, bytes=nbytes),
        s("tokenize.read", 10, 14, 6, site="ids"),
        s("tokenize.call", 0, 15, -1, bytes=nbytes),
    ]


def _fixed():
    """A profiled job (0-71 ms, the window 0-72 ms) and a later one; a call
    after them; on the same clock, with device activity in the window."""
    sp = _job(0, 8) + _offset(_job(100, 10), 10) + _offset(_call(300, 2_000_000), 20)
    A = trace.Activity
    dev = [A("k", "kernel", 0, 47 * MS, None), A("k", "kernel", 50 * MS, 60 * MS, None),
           A("k", "kernel", 66 * MS, 72 * MS, None)]
    return sp, trace.Summary(window=(0, 72 * MS), device=dev)


@pytest.fixture
def readers(monkeypatch):
    sp, summary = _fixed()
    mods = {name: run.load_module("metrics", name) for name in READERS}
    monkeypatch.setattr(timing, "spans", lambda: list(sp))
    return mods, sp, summary


def test_span_readers_on_a_fixed_list(readers, capsys):
    mods, sp, summary = readers
    assert timing._on  # loading a reader turns the tracer on
    got = {name: mod.read(summary) for name, mod in mods.items()}
    # idle 47-50 ms: the batch 47-48, the recount 48-50; idle 60-66 ms:
    # the batch 60-65, the summary read 65-66. Dispatch 1 + 2 + 5 ms of 72.
    assert got["train.idle_dispatch_share"] == pytest.approx(8 / 72)
    # no tokenize call is open in the window: no idle under its spans
    assert got["tokenize.idle_dispatch_share"] == 0.0
    err = capsys.readouterr().err
    assert "spans: train: idle 0.0090 s" in err and "below the root 1.0000" in err


def test_tokenize_reader_on_a_profiled_call(monkeypatch, capsys):
    """Idle under the pass's own spans counts; under its reads, its input
    copy and the root it does not."""
    sp = _call(0, 1_000_000)
    monkeypatch.setattr(timing, "spans", lambda: list(sp))
    A = trace.Activity
    # busy 0-2 and 9-10 ms of a 0-16 ms window: idle 2-9 (match table 2-3,
    # its rank read 3-4, match table 4-6, walk 6-9) and 10-16 (the ids
    # read 10-14, the root 14-15, no span 15-16)
    summary = trace.Summary(window=(0, 16 * MS), device=[A("k", "kernel", 0, 2 * MS, None),
                                                         A("k", "kernel", 9 * MS, 10 * MS, None)])
    got = run.load_module("metrics", "tokenize.idle_dispatch_share").read(summary)
    assert got == pytest.approx(6 / 16)
    err = capsys.readouterr().err
    assert "spans: tokenize: idle 0.0130 s" in err and f"below the root {11 / 13:.4f}" in err


@pytest.mark.parametrize("busy_order", ["sorted", "reversed"])
def test_idle_by_span(readers, busy_order):
    _, sp, summary = readers
    busy = [(a.start, a.end) for a in summary.device]
    if busy_order == "reversed":
        busy = busy[::-1] + [(10 * MS, 20 * MS)]  # any order, overlaps counted once
    idle = timing.idle_by_span(summary.window, busy, sp)
    ms = {k: v / MS for k, v in idle.items()}
    assert ms == pytest.approx({"train.batch": 6.0, "train.recount": 2.0, "train.read": 1.0})
    assert timing.idle_by_span((0, 100 * MS), busy, sp)[None] == 28 * MS  # 72-100 ms: no span open
    timing.enable()
    with span("train.job"):
        pass
    assert set(timing.idle_by_span((0, 1), [])) <= {"train.job", None}  # the tracer's own spans by default


def test_span_readers_raise_on_missing_spans_and_read_nothing_without_a_tracer(readers, monkeypatch):
    mods, sp, summary = readers
    renamed = [s._replace(name=s.name.replace("train.", "x.").replace("tokenize.", "y.")) for s in sp]
    monkeypatch.setattr(timing, "spans", lambda: renamed)
    for name, mod in mods.items():
        with pytest.raises(LookupError, match="no span named"):
            mod.read(summary)
    monkeypatch.setattr(spans, "_tracer", lambda: None)  # a program without the tracer
    assert all(mod.read(summary) is None for mod in mods.values())
    assert all(mod.read(trace.Summary()) is None for mod in mods.values())  # no traced window
