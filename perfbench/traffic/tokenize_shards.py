"""Traffic kind ``tokenize_shards``: one caller in a closed loop of
``BPETokenizer.encode_bytes_greedy(shard)`` with the vocab that set-up
trained.

Mix parameters (``traffic/<mix>.json``): ``shard_mib``, the bytes of each
call; ``trace_calls``, the calls the traced run profiles (from the first);
``sample_calls``, how many calls' ids are compared besides the last one.

Set-up trains the configuration's vocab with ``api.train`` on the corpus
and makes one warm call. Call ``i`` takes ``shard_mib`` MiB of the corpus
from an offset drawn from the seed, wrapping around its end, so every call
is a different byte sequence; the shard is handed over as a memoryview of
the corpus written twice, so the program's own copy is inside the call.
``tokenize_mb_per_s`` is all the bytes of all the calls (10^6 bytes to the
MB) over the window, from its start to the end of the last call;
``tokenize_p95_ms`` is the nearest-rank 95th percentile of every call's
latency.

The comparison: the set-up's vocab against the plain reference trainer's,
and the ids of ``sample_calls`` calls drawn from the seed among the first
``sample_calls * 4`` (those that ran) and of the last call against the
plain chunked greedy match (``reference/greedy.py``) over the reference's
own vocab; each number is the positions that differ, limit 0. The control
(``control``) drops the chunks.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Window:
    start: float
    end: float = 0.0
    latencies: list = field(default_factory=list)
    offsets: list = field(default_factory=list)
    kept: dict = field(default_factory=dict)  # call index -> ids
    attempted: int = 0
    bytes: int = 0
    traced_bytes: int = 0


def load_program(ctx) -> None:
    from gpu_bpe_tpu_torch import api
    from gpu_bpe_tpu_torch.ops import native
    from gpu_bpe_tpu_torch.unicode import get_backend

    ctx.api = api
    get_backend()
    native.native_available()
    if ctx.device == "cuda":
        from gpu_bpe_tpu_torch.ops import build

        build.load()


def _shard_bytes(ctx) -> int:
    return min(int(ctx.mix["shard_mib"] * (1 << 20)), len(ctx.corpus))


def _offsets(ctx):
    rng = np.random.default_rng([ctx.seed, 1])
    while True:
        yield int(rng.integers(len(ctx.corpus)))


def setup(ctx):
    c = ctx.config
    tok, res = ctx.api.train(ctx.corpus, ctx.api.TrainConfig(
        vocab_size=c["vocab_size"], device=ctx.device, pre_tokenize=c["pre_tokenize"], dedup=c["dedup"],
        show_progress=False))
    ctx.vocab = list(res.vocab)
    ctx.twice = memoryview(ctx.corpus + ctx.corpus)
    ctx.tok = tok
    tok.encode_bytes_greedy(ctx.twice[: _shard_bytes(ctx)])  # the warm call
    ctx.sync()
    sample = np.random.default_rng([ctx.seed, 2]).choice(ctx.mix["sample_calls"] * 4, ctx.mix["sample_calls"],
                                                          replace=False)
    ctx.sample = {int(i) for i in sample}
    return tok


def window(ctx, tok, seconds: float) -> Window:
    n = _shard_bytes(ctx)
    offsets = _offsets(ctx)
    win = Window(start=time.perf_counter())
    deadline = win.start + seconds
    last = None
    i = 0
    while i == 0 or time.perf_counter() < deadline:
        off = next(offsets)
        shard = ctx.twice[off : off + n]
        if i == 0:
            ctx.tracer.start()
        t0 = time.perf_counter()
        ids = tok.encode_bytes_greedy(shard)
        t1 = time.perf_counter()
        if ctx.tracer.on and i < ctx.mix["trace_calls"]:
            win.traced_bytes += n
        if i + 1 == ctx.mix["trace_calls"]:
            ctx.tracer.stop()
        win.latencies.append(t1 - t0)
        win.offsets.append(off)
        if i in ctx.sample:
            win.kept[i] = ids
        last = (i, ids)
        i += 1
    win.end = time.perf_counter()
    ctx.tracer.stop()  # where the window ended first
    win.kept[last[0]] = last[1]
    win.attempted = i
    win.bytes = i * n
    return win


def end_to_end(ctx, win: Window) -> dict:
    lat = sorted(win.latencies)
    p95 = lat[max(0, -(-95 * len(lat) // 100) - 1)]
    return {"tokenize_mb_per_s": win.bytes / 1e6 / (win.end - win.start), "tokenize_p95_ms": p95 * 1e3}


def counters(ctx, win: Window) -> dict:
    return {"traced_bytes": win.traced_bytes}


def release(ctx, tok, win: Window) -> None:
    ctx.tok = None


def reference(ctx):
    """The plain reference's vocab and its matcher on the corpus, once per
    run."""
    from perfbench.reference import bpe, greedy

    if getattr(ctx, "reference", None) is None:
        vocab = bpe.train(ctx.corpus, ctx.config["vocab_size"]).vocab
        ctx.reference = (vocab, greedy.Matcher(vocab, ctx.corpus))
    return ctx.reference


def control(ctx) -> Window:
    """The control in the program's place: the reference's vocab, and the
    greedy match over each whole shard, without chunks, for as many calls
    as a run compares."""
    vocab, matcher = reference(ctx)
    ctx.vocab = vocab
    n, offsets = _shard_bytes(ctx), _offsets(ctx)
    win = Window(start=0.0)
    for i in range(ctx.mix["sample_calls"] + 1):
        win.offsets.append(next(offsets))
        win.kept[i] = matcher.encode(win.offsets[i], n, chunked=False)
    return win


def check(ctx, win: Window) -> dict:
    from perfbench.compare import diff, ids_diff

    vocab, matcher = reference(ctx)
    n = _shard_bytes(ctx)
    wrong = sum(ids_diff(ids, matcher.encode(win.offsets[i], n)) for i, ids in win.kept.items())
    return {
        "vocab_wrong": {"value": diff(ctx.vocab, vocab), "limit": 0},
        "ids_wrong": {"value": wrong, "limit": 0},
    }
