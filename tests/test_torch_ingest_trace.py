"""The streamed ingest's spans and counter (``gpu_bpe_tpu_torch.ops.ingest``:
``train.ingest``, ``train.pretokenize``, ``train.dedup``, ``INGEST``) inside
``api.train_files``' ``train.job``, the benchmark's readers of them
(``perfbench/ingest_spans.py``), its cell ``train.words-32k-1g`` at a small
size, and the block-by-block word counts of its reference
(``perfbench/reference/bpe_blocks.py``), on the CPU.
"""

import logging

import pytest

from gpu_bpe_tpu_torch import api
from gpu_bpe_tpu_torch.ops import ingest
from gpu_bpe_tpu_torch.utils import timing
from perfbench import control, ingest_spans, run, trace
from perfbench.corpus import seeded_corpus, synth_corpus
from perfbench.reference import bpe, bpe_blocks

logging.getLogger("gpu_bpe_tpu_torch").setLevel(logging.WARNING)

CELL = "train.words-32k-1g"
SMALL = {"corpus_mib": 0.25, "vocab_size": 400, "chunk_mib": 16 / 1024}  # 16 KiB chunks cut words


@pytest.fixture(autouse=True)
def tracer_off():
    timing.disable()
    timing.clear()
    yield
    timing.disable()
    timing.clear()


@pytest.fixture(scope="module")
def corpus_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("files") / "corpus.txt"
    path.write_bytes(synth_corpus(70_001, 4))
    return str(path)


def _train_files(path, chunk):
    return api.train_files([path], api.TrainConfig(vocab_size=270, device="cpu", show_progress=False),
                           chunk_bytes=chunk)


@pytest.mark.parametrize("chunk", [4096, 16_384, 1 << 20])
def test_train_files_job_holds_the_ingest_with_a_span_per_chunk(corpus_file, chunk):
    n_chunks = len(list(ingest.stream_paths([corpus_file], chunk)))
    timing.enable()
    _, res = _train_files(corpus_file, chunk)
    sp = timing.spans()
    root = len(sp) - 1
    assert sp[root].name == "train.job" and sp[root].parent == -1
    (ing,) = [i for i, s in enumerate(sp) if s.name == "train.ingest"]
    assert sp[ing].parent == root
    assert [s.name for s in sp if s.parent == root][:2] == ["train.ingest", "train.upload"]
    stream = ingest.make_stream_chunked(ingest.stream_paths([corpus_file], chunk))
    assert sp[ing].attrs == {"bytes": stream.total_bytes, "chunks": n_chunks, "symbols": stream.n}
    assert sp[root].attrs == {"bytes": stream.total_bytes, "symbols": stream.n, "merges": len(res.merges)}
    kids = [s for s in sp if s.parent == ing]
    pre = [s for s in kids if s.name == "train.pretokenize"]
    adds = [s for s in kids if s.name == "train.dedup" and "bytes" in s.attrs]
    finish = [s for s in kids if s.name == "train.dedup" and "symbols" in s.attrs]
    assert len(pre) == len(adds) == n_chunks and len(kids) == 2 * n_chunks + 1
    assert [s.attrs for s in finish] == [{"symbols": stream.n}]
    assert sum(s.attrs["bytes"] for s in adds) == stream.total_bytes
    assert sum(s.attrs["bytes"] for s in pre) >= stream.total_bytes  # the carried partial words again


@pytest.mark.parametrize("chunk", [4096, 1 << 20])
def test_ingest_counter_counts_the_stream(corpus_file, chunk):
    before = dict(ingest.INGEST)
    stream = ingest.make_stream_chunked(ingest.stream_paths([corpus_file], chunk))
    got = {k: ingest.INGEST[k] - before.get(k, 0) for k in ("chunks", "bytes", "symbols")}
    assert got == {"chunks": len(list(ingest.stream_paths([corpus_file], chunk))), "bytes": stream.total_bytes,
                   "symbols": stream.n}


def test_tracing_off_records_nothing_and_still_counts(corpus_file):
    before = ingest.INGEST["chunks"]
    _train_files(corpus_file, 4096)
    assert timing.spans() == []
    assert ingest.INGEST["chunks"] - before == len(list(ingest.stream_paths([corpus_file], 4096)))


def test_span_readers_read_the_job_and_name_what_is_missing(corpus_file):
    timing.enable()
    before = ingest.INGEST["bytes"]
    _train_files(corpus_file, 4096)
    sp = timing.spans()
    job = sp[-1]
    counters = {"traced_bytes": ingest.INGEST["bytes"] - before}
    s = trace.Summary(window=(job.start_ns, job.end_ns), counters=counters)
    secs = {n: sum(x.end_ns - x.start_ns for x in sp if x.name == n) / 1e9 for n in ("train.ingest", "train.job")}
    assert ingest_spans.ingest_share(s) == pytest.approx(secs["train.ingest"] / secs["train.job"])
    gib = counters["traced_bytes"] / (1 << 30)
    for name in ("train.pretokenize", "train.dedup"):  # every one of them is inside the ingest here
        want = sum(x.end_ns - x.start_ns for x in sp if x.name == name) / 1e9 / gib
        assert ingest_spans.s_per_gib(s, name) == pytest.approx(want)
    # a program without the ingest counter: nothing to read
    assert ingest_spans.ingest_share(trace.Summary(window=s.window)) is None
    # the counter, and no span of the reader's in the traced window: named
    empty = trace.Summary(window=(job.end_ns + 1, job.end_ns + 2), counters=counters)
    with pytest.raises(LookupError, match="train.ingest"):
        ingest_spans.s_per_gib(empty, "train.dedup")


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_the_cell_at_a_small_size_is_correct(traced):
    r = run.run_cell(CELL, 2**31 + 21, 0.2, traced, device="cpu", overrides=SMALL)
    assert r["correct"], r["checks"]
    assert all(c["value"] == 0 for c in r["checks"].values())
    if traced:
        assert set(r["metrics"]) == {"train.files.ingest_share", "train.files.pretokenize_s_per_gib",
                                     "train.files.accumulate_s_per_gib"}
        assert 0 < r["metrics"]["train.files.ingest_share"]["value"] < 1
    else:
        assert set(r["metrics"]) == {"train_merges_per_s", "setup_s"}


def test_the_cells_control_is_not_correct():
    assert not control.control(CELL, 9, SMALL)["correct"]


EDGES = b"ab  cd\n  lead\ntrail  \n\n\n x\n \nend no newline"


@pytest.mark.parametrize("block", [1, 7, 80, 81, 4096, 1 << 20])
@pytest.mark.parametrize("text", ["zipf", "edges"])
def test_blocked_word_counts_equal_the_whole_texts(text, block):
    data = seeded_corpus(100_003, 2**31 + 1) if text == "zipf" else EDGES
    assert bpe_blocks.word_counts(data, block, workers=1) == bpe.word_counts(data)


def test_blocks_end_past_a_newline_and_cover_the_text():
    data = b"abc def\nghi\n\nxyzxyzxyz tail"
    cuts = bpe_blocks.blocks(data, 5)
    assert cuts[0][0] == 0 and cuts[-1][1] == len(data)
    assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
    assert all(data[e - 1 : e] == b"\n" for _, e in cuts[:-1])


def test_blocked_word_counts_in_worker_processes():
    data = seeded_corpus(60_001, 3)
    assert bpe_blocks.word_counts(data, 8192, workers=2) == bpe.word_counts(data)


@pytest.mark.parametrize("bad", [b"it's", b"a\tb", b"x1", "café".encode()])
def test_blocked_word_counts_refuse_bytes_the_rules_part_on(bad):
    with pytest.raises(ValueError):
        bpe_blocks.word_counts(b"ok\n" + bad, 2, workers=1)
