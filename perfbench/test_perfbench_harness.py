"""The harness's own checks, on the CPU: its files and names, the readers on
a fixed synthetic trace, a run without a card, what a run imports, and the
frozen corpus generator.

    python3 -m pytest perfbench/test_perfbench_harness.py -q
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import run, trace
from perfbench.corpus import synth_corpus

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = sorted(p.stem for p in (ROOT / "perfbench" / "metrics").glob("*.py"))


def test_benchmark_has_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_file_loads_and_agrees(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    body, config, mix, kind = run.load_cell(cell)
    assert {k: body[k] for k in entry} == entry
    assert config["name"] == entry["config"]
    for fn in ("load_program", "setup", "window", "end_to_end", "counters", "release", "control", "check"):
        assert callable(getattr(kind, fn))
    assert entry["chips"] == 1 and 1 <= len(entry["why"]) <= 200
    # every range the traced part has to enter is one the cell's metrics install
    installed = {r.rpartition(":")[2] for m in run.cell_metrics(cell, "per_layer")
                 for r in run.load_module("metrics", m["name"]).RANGES}
    assert body["traced"] and set(body["traced"]) <= installed


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_file_loads_and_agrees(config):
    body = json.loads((ROOT / config["file"]).read_text())
    assert body["name"] == config["name"] and body["source"] == config["source"]
    assert body["reduced"] == config["reduced"] and all(k in body for k in config["reduced"])
    assert config["file"].startswith("perfbench/")


@pytest.mark.parametrize("name", METRICS)
def test_every_metric_file_loads_and_agrees(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    mod = run.load_module("metrics", name)
    assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.SOURCE, mod.MOVES) == (
        entry["layer"], entry["unit"], entry["better"], entry["source"], entry["moves"])
    assert callable(mod.read)
    assert mod.read(trace.Summary()) is None  # nothing to read: no number


def test_names_units_and_keys_use_allowed_characters():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[section]:
            names.append(e["name"])
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in BENCH[section]}) == len(BENCH[section])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert sorted(m["name"] for m in BENCH["per_layer"]) == METRICS


def test_each_per_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert m["workloads"] and set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        reported = {m["name"] for m in run.cell_metrics(cell, "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert run.cell_metrics(cell, "per_layer")


def _summary():
    """A fixed trace: a 10 ms window; a job's ranges; kernels, copies and a
    memset, two overlapping."""
    ms = 1_000_000
    ranges = [("train_batch", 0, 8 * ms), ("merge_compact_tracked", 0, int(1.2 * ms)),
              ("_full_recount_impl", 1 * ms, 3 * ms), ("compact_mask", int(1.9 * ms), int(2.2 * ms)),
              ("build_match_table", 8 * ms, 9 * ms), ("chunk_walk", 9 * ms, 10 * ms),
              ("compact_valid", int(9.55 * ms), int(9.75 * ms))]
    A = trace.Activity
    dev = [
        A("(anonymous namespace)::merge_tiles(unsigned int const*, int)", "kernel", 0, 1 * ms,
          frozenset({"train_batch", "merge_compact_tracked"})),
        A("void at::native::sort_kernel<long>(long*)", "kernel", int(1.5 * ms), int(2.5 * ms),
          frozenset({"train_batch", "_full_recount_impl"})),
        A("(anonymous namespace)::compact_tiles(int const*)", "kernel", 2 * ms, 3 * ms,
          frozenset({"train_batch", "_full_recount_impl", "compact_mask"})),
        A("Memcpy HtoD (Pageable -> Device)", "memcpy_htod", int(8.5 * ms), 9 * ms, frozenset({"build_match_table"})),
        A("Memcpy DtoH (Device -> Pinned)", "memcpy_dtoh", int(9.5 * ms), 10 * ms, frozenset({"chunk_walk"})),
        A("Memset (Device)", "memset", int(9.6 * ms), int(9.7 * ms), frozenset({"chunk_walk", "compact_valid"})),
        A("void at::native::copy_kernel(int*)", "kernel", int(9.8 * ms), int(9.9 * ms), None),
    ]
    counters = {"jobs": 2, "merges": 100, "host_reads": 150, "recounts": 5, "train_s": 6.0, "wall_s": 8.0,
                "traced_jobs": 1, "traced_merges": 50, "traced_bytes": 2_000_000}
    return trace.Summary(window=(0, 10 * ms), device=dev, ranges=ranges, counters=counters)


def test_readers_on_a_fixed_trace():
    s = _summary()
    assert s.busy_s() == pytest.approx(0.0035)  # 0-1, 1.5-3 (an overlap counted once), 8.5-9, 9.5-10 ms
    assert s.window_s == pytest.approx(0.01)
    want = {
        "train.outside_loop_share": 0.25,
        "train.host_reads_per_merge": 1.5,
        "train.launches_per_merge": 3 / 50,  # launched inside the batch loop
        "train.recounts_per_kmerge": 50.0,
        "train.recount_device_ms_per_job": 2.0,
        "train.kernel_device_us_per_merge": 2000 / 50,
        "train.device_idle_share": 0.65,
        "tokenize.copy_ms_per_mb": 1.0 / 2,
        "tokenize.match_table_ms_per_mb": 0.5 / 2,
        "tokenize.walk_host_ms_per_mb": 1.0 / 2,
        "tokenize.walk_launches_per_mb": 2 / 2,
        # by entry and not by name: compact_tiles inside compact_mask, the memset inside compact_valid
        "tokenize.kernel_device_ms_per_mb": 1.1 / 2,
        "tokenize.device_idle_share": 0.65,
    }
    for name, value in want.items():
        assert run.load_module("metrics", name).read(s) == pytest.approx(value), name
    entries = run.load_module("metrics", "tokenize.kernel_device_ms_per_mb").ENTRIES
    bare = _summary()
    bare.device = [a for a in bare.device if not (a.ranges or frozenset()) & set(entries)]
    assert run.load_module("metrics", "tokenize.kernel_device_ms_per_mb").read(bare) is None  # none of its entries
    b = s.breakdown()
    assert b["device_ops"][0] == ["merge_tiles", pytest.approx(0.001)]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    # 1-1.5 ms inside the recount, 3-8.5 ms by its midpoint in the batch, 9-9.5 ms in the walk
    assert gaps == pytest.approx({"_full_recount_impl": 0.0005, "train_batch": 0.0055, "chunk_walk": 0.0005})


def test_union_and_sweep():
    assert trace._union([(0, 5), (1, 2), (4, 8), (10, 11)]) == 9
    got = trace._sweep([("a", 0, 10), ("b", 2, 4)], [3, 5, 11])
    assert got[0] == (frozenset({"a", "b"}), "b")
    assert got[1] == (frozenset({"a"}), "a")
    assert got[2] == (frozenset(), None)
    assert trace.short_name("void at::native::k<long>(long*)") == "at::native::k<long>"


def test_missing_traced_function_is_named():
    with pytest.raises(LookupError, match="no_such_function"):
        trace.install_ranges(["gpu_bpe_tpu_torch.ops.train_step:no_such_function"])


def _env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    env.pop("JAX_PLATFORMS", None)
    return env


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "train.words-8k", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


IMPORT_CHECK = r"""
import json, sys
from perfbench import compare, control, corpus, run, trace
from perfbench.reference import bpe, greedy
for cell in ("train.words-8k", "tokenize.words-8k"):
    r = run.run_cell(cell, 5, 0.2, False, device="cpu",
                     overrides={"corpus_mib": 0.03125, "vocab_size": 290, "shard_mib": 0.0078125})
    assert r["correct"], r
for name in ("train_jobs", "tokenize_shards"):
    run.load_module("traffic", name)
for p in (run.BENCH / "metrics").glob("*.py"):
    run.load_module("metrics", p.stem)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_nothing_the_harness_runs_imports_jax_or_the_reference_package():
    p = subprocess.run([sys.executable, "-c", IMPORT_CHECK], cwd=ROOT, env=_env(), capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "gpu_bpe_tpu_torch" in top  # the program ran
    assert not top & {"jax", "jaxlib", "flax", "gpu_bpe_tpu", "bench", "bench_torch", "chip_smoke"}


@pytest.mark.parametrize("n_bytes,seed", [(1 << 16, 0), (300_001, 7)])
def test_generator_is_a_frozen_copy_of_the_bench_one(n_bytes, seed):
    sys.path.insert(0, str(ROOT))
    from bench_torch import synth_corpus as original

    assert synth_corpus(n_bytes, seed) == original(n_bytes, seed)


def test_the_seed_draws_the_bytes_and_keeps_the_work():
    from collections import Counter

    from perfbench.corpus import seeded_corpus
    from perfbench.reference.bpe import word_counts

    a, b = seeded_corpus(200_003, 1), seeded_corpus(200_003, 2**31 + 77)
    base = synth_corpus(200_003, 0)
    assert a != b and len(a) == len(b) == 200_003
    assert a == seeded_corpus(200_003, 1)
    assert set(word_counts(a)) != set(word_counts(b))  # other words

    def shape(text):  # the words' frequencies and lengths, and the lines, up to the letters' names
        counts = word_counts(text)
        return Counter((len(w), c) for w, c in counts.items()), Counter(len(ln) for ln in text.split(b"\n"))

    assert shape(a) == shape(b) == shape(base)


def test_a_traced_run_names_a_range_its_cell_lists_and_never_entered(monkeypatch):
    small = {"corpus_mib": 0.03125, "vocab_size": 290}
    ok = run.run_cell("train.words-8k", 3, 0.2, True, device="cpu", overrides=small)
    assert ok["correct"]  # every range the cell lists was entered (no device operations on the CPU)
    load = run.load_cell

    def renamed(workload, overrides=None):
        cell, *rest = load(workload, overrides)
        return ({**cell, "traced": cell["traced"] + ["no_such_range"]}, *rest)

    monkeypatch.setattr(run, "load_cell", renamed)
    with pytest.raises(SystemExit, match="never entered no_such_range"):
        run.run_cell("train.words-8k", 3, 0.2, True, device="cpu", overrides=small)
