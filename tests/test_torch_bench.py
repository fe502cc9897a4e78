"""The port's headline bench (``bench_torch.py``) and its vocab sweep
(``scripts/torch_bench_tokenize_vocabs.py``) on the CPU, at a small size:
the corpus generator and the synthetic 64K vocab equal ``bench.py``'s byte
for byte; one run of the bench prints one stdout line, trains the merge list
of ``api.train`` and of the JAX package's reference trainer on the same
corpus (tolerance 0), and prints tokenize rows whose bytes per token are
those of the port's CPU ``Tokenizer``; the sweep writes rows with the JAX
sweep's keys. On the card ``chip_smoke.py`` phase 26 runs the bench at its
full size."""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import bench  # noqa: E402
import bench_torch  # noqa: E402
from gpu_bpe_tpu.core import trainer_ref as jax_ref  # noqa: E402
from gpu_bpe_tpu.pretok import PreTokenizer as JaxPreTokenizer  # noqa: E402
from gpu_bpe_tpu_torch import Tokenizer, api  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
MERGES = 64
ARGS = ["--device", "cpu", "--mb", "1", "--merges", str(MERGES), "--runs", "2", "--dense-vocab", "300",
        "--tokenize-vocab", "400", "--passes", "1"]
LINE_KEYS = {"metric", "value", "unit", "vs_baseline"}
ROW_KEYS = {"unit", "value", "wall_mb_per_sec", "bytes_per_token", "tokens", "pass_ms", "max_token_len",
            "stab_levels", "dense_lengths", "walk", "pass_mb", "rank_space", "vocab_entries",
            "distinct_entries", "launches"}


@pytest.mark.parametrize("n_bytes,seed", [(1 << 16, 0), (1 << 20, 0), (300_001, 7)])
def test_synth_corpus_equals_bench_py(n_bytes, seed):
    got = bench_torch.synth_corpus(n_bytes, seed)
    assert len(got) == n_bytes and got == bench.synth_corpus(n_bytes, seed)


@pytest.mark.parametrize("n_bytes", [2 << 20, 64 << 10])
def test_synth_vocab_64k_equals_bench_py(n_bytes):
    """At 2 MB the corpus's words fill the vocab; 64 KB runs dry and takes
    the ``#%d`` padding."""
    corpus = bench_torch.synth_corpus(n_bytes)
    got = bench_torch.synth_vocab_64k(corpus)
    assert len(got) == len(set(got)) == 65536 and got == bench._synth_vocab_64k(corpus)
    assert (b"#0" in got) == (n_bytes < 1 << 20)


def _run_main(module, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        report = module.main(argv)
    return report, out.getvalue(), err.getvalue()


def _lines(err: str) -> dict:
    lines = {}
    for text in err.splitlines():
        if text.startswith("{"):
            obj = json.loads(text)
            lines.setdefault(obj["metric"], []).append(obj)
    return lines


@pytest.fixture(scope="module")
def run():
    report, out, err = _run_main(bench_torch, ARGS)
    return report, out, _lines(err)


def test_bench_prints_one_line_with_the_median(run):
    report, out, lines = run
    assert out.count("\n") == 1
    line = json.loads(out)
    assert set(line) == LINE_KEYS and line == report["line"]
    assert line["metric"] == "train_merges_per_sec" and line["value"] > 0
    runs = [r["merges_per_sec"] for r in lines["train_run"]]
    assert len(runs) == 2 and line["value"] == lines["train_runs"][0]["median"] == float(np.median(runs))
    assert line["vs_baseline"] == line["value"] / bench.BASELINE_MERGES_PER_SEC
    assert "1MB corpus, 64 merges" in line["unit"] and "cpu" in line["unit"]
    assert list(lines)[0] == "device" and lines["device"][0]["name"] == "cpu"
    assert all(lines["kernel_selftest"][0]["value"].values())
    assert lines["corpus"][0]["unicode_backend"] == "cpp-decoder"
    assert lines["dist_smoke"][0] == {**lines["dist_smoke"][0], "merges": MERGES, "matches_single_chip": True,
                                      "backend": "gloo"}


def test_bench_merges_equal_api_train_and_the_jax_reference(run):
    report, _, lines = run
    corpus = bench.synth_corpus(1 << 20)
    _, res = api.train(corpus, api.TrainConfig(vocab_size=256 + MERGES, device="cpu", show_progress=False))
    assert (report["merges"], report["merge_counts"]) == (res.merges, res.merge_counts)
    assert lines["train_runs"][0]["sha_merges"] == bench_torch.sha_pair(res)["sha_merges"]
    data, starts = JaxPreTokenizer().pre_tokenize_bytes(corpus)
    assert bytes(data) == report["data"]
    symbols = jax_ref.tag_word_boundaries(jax_ref.bytes_to_symbols(data), starts)
    ref = jax_ref.ReferenceTrainer().train(symbols, target_vocab_size=256 + MERGES)
    assert [tuple(m) for m in ref.merges] == report["merges"] and list(ref.merge_counts) == report["merge_counts"]
    assert report["stream"].n == lines["corpus"][0]["stream_n"]


def test_tokenize_rows(run):
    """The three rows, in ``bench.py``'s order and shape; the last vocab is
    trained by the Trainer of the first, so it starts with the first's
    entries; bytes per token equal the port's CPU Tokenizer's on the cut."""
    report, _, lines = run
    rows = lines["tokenize_mb_per_sec"]
    labels = ["300", "65536-synth", "400"]
    assert list(report["vocabs"]) == labels and len(rows) == 3
    for label, row in zip(labels, rows):
        assert set(row) == ROW_KEYS | {"metric"} | ({"vs_baseline"} if label == "400" else set())
        assert f"vocab {label}" in row["unit"] and row["value"] > 0 and row["wall_mb_per_sec"] > 0
        vocab = report["vocabs"][label]
        assert row["vocab_entries"] == len(vocab) and row["distinct_entries"] == len(set(vocab))
        cut = report["data"][: row["pass_mb"] << 20]
        ids = Tokenizer(vocab, device="cpu").encode_bytes(cut)
        assert row["tokens"] == len(ids) and row["bytes_per_token"] == len(cut) / len(ids)
        assert row["rank_space"] is False and row["walk"] == "scan64"  # full width on the CPU
    dense, synth, last = (report["vocabs"][k] for k in labels)
    assert rows[1]["stab_levels"] >= 2 and rows[0]["stab_levels"] == 0
    assert len(last) == 400 and last[:300] == dense and len(set(last)) < 400
    assert rows[2]["vs_baseline"] == rows[2]["value"] / bench.BASELINE_TOKENIZE_MB_S
    assert lines["kernel_launches"][0]["rank_space_rows"] == []


def test_selftest_only_and_no_fallback_to_the_cpu(monkeypatch):
    report, out, err = _run_main(bench_torch, ["--device", "cpu", "--selftest-only"])
    assert json.loads(out) == report["line"] == {"metric": "kernel_selftest_only", "value": "pass"}
    assert out.count("\n") == 1 and all(_lines(err)["kernel_selftest"][0]["value"].values())
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with pytest.raises(SystemExit) as exc, contextlib.redirect_stdout(out):
        bench_torch.main([])
    assert exc.value.code not in (0, None) and out.getvalue() == ""


def test_sweep_writes_the_jax_sweeps_rows(tmp_path):
    spec = importlib.util.spec_from_file_location("torch_bench_tokenize_vocabs",
                                                  REPO / "scripts/torch_bench_tokenize_vocabs.py")
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    out = tmp_path / "rates.json"
    artifact, stdout, _ = _run_main(sweep, ["--device", "cpu", "--sizes", "300", "512", "--corpus-mb", "1",
                                            "--out", str(out), "--cache", str(tmp_path / "cache"), "--passes", "1"])
    assert json.loads(out.read_text()) == artifact and artifact["device"] == "cpu"
    jax_keys = set(json.loads((REPO / "docs/artifacts/tokenize_rates.json").read_text())["rows"][0])
    assert [r["vocab"] for r in artifact["rows"]] == [300, 512]
    for row in artifact["rows"]:
        assert set(row) == jax_keys | {"rank_space", "train_seconds"}
        assert row["device_mb_per_sec"] > 0 and row["device_mb_per_sec_rank_off"] is None  # no stab levels
    assert sorted(p.name for p in (tmp_path / "cache").iterdir()) == ["vocab_1mb_300.json", "vocab_1mb_512.json"]
    assert [json.loads(line)["vocab"] for line in stdout.splitlines()[:2]] == [300, 512]
