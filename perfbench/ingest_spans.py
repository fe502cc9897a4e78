"""The streamed ingest's spans in the traced ``api.train_files`` job, for
the ``train.files.*`` readers.

The program records the job as a ``train.job`` root holding one
``train.ingest`` span, which holds a ``train.pretokenize`` span per chunk
and a ``train.dedup`` span per accumulated chunk and at the finish
(``gpu_bpe_tpu_torch.ops.ingest``); the traffic kind gives the bytes the
traced job ingested (``traced_bytes``, from the program's counter
``INGEST``). The readers take the spans that lie inside the traced window.

A program without the ingest counter or without the tracer gives the
readers nothing to read (``None``); a program with both whose traced job
recorded none of a reader's spans fails the run, naming them.
"""

from __future__ import annotations

from perfbench import spans as sp

GIB = 1 << 30
RANGES = (
    "gpu_bpe_tpu_torch.api:train_files",
    "gpu_bpe_tpu_torch.ops.ingest:make_stream_chunked",
    "gpu_bpe_tpu_torch.ops.ingest:StreamAccumulator.add_chunk",
    "gpu_bpe_tpu_torch.pretok.pretokenizer:PreTokenizer.pre_tokenize_bytes",
    "gpu_bpe_tpu_torch.ops.train_step:train_batch",
    "gpu_bpe_tpu_torch.ops.train_step:_full_recount_impl",
    "gpu_bpe_tpu_torch.models.bpe:BPETokenizer.from_training_result",
)


def traced(summary, names):
    """The tracer's spans and the indices of those inside the traced
    window, or None where there is nothing to read; raises where the
    window holds none of a span in ``names``."""
    if not summary.window or "traced_bytes" not in summary.counters:
        return None
    tracer = sp._tracer()
    if tracer is None:
        return None
    spans = tracer.spans()
    lo, hi = summary.window
    inside = [i for i, s in enumerate(spans) if lo <= s.start_ns and s.end_ns <= hi]
    missing = [n for n in names if not any(spans[i].name == n for i in inside)]
    if missing:
        raise LookupError(f"the program recorded no span named {', '.join(missing)} in the traced job")
    return spans, inside


def _seconds(spans, idx) -> float:
    return sum(spans[i].end_ns - spans[i].start_ns for i in idx) / 1e9


def _under(spans, i: int, name: str) -> bool:
    p = spans[i].parent
    while p is not None and p >= 0:
        if spans[p].name == name:
            return True
        p = spans[p].parent
    return False


def ingest_share(summary) -> float | None:
    """Time under ``train.ingest`` over the traced ``train.job`` roots' wall."""
    got = traced(summary, ("train.job", "train.ingest"))
    if got is None:
        return None
    spans, inside = got
    job = _seconds(spans, [i for i in inside if spans[i].name == "train.job" and spans[i].parent == -1])
    return _seconds(spans, [i for i in inside if spans[i].name == "train.ingest"]) / job if job else None


def s_per_gib(summary, name: str) -> float | None:
    """Seconds under the ``name`` spans inside ``train.ingest`` per GiB the
    traced job ingested."""
    got = traced(summary, ("train.ingest", name))
    gib = summary.counters.get("traced_bytes", 0) / GIB
    if got is None or not gib:
        return None
    spans, inside = got
    return _seconds(spans, [i for i in inside if spans[i].name == name and _under(spans, i, "train.ingest")]) / gib
