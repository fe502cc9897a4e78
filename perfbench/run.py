"""One run of one benchmark cell of ``gpu_bpe_tpu_torch`` on the card.

    python3 perfbench/run.py --workload train.words-8k --seed 7 --seconds 30 --trace 0

Everything the run needs is found by name under ``perfbench/``: the cell
(``workloads/<cell>.json``), its configuration (``configs/<config>.json``),
its traffic mix (``traffic/<mix>.json``) and the mix's kind, the code that
drives the program (``traffic/<kind>.py``), and with ``--trace 1`` the
per-layer metrics that ``BENCHMARK.json`` lists for the cell
(``metrics/<metric>.py``). The harness holds no list of any of them.

A run: set-up (the program's libraries, the corpus from ``--seed``, the
kind's warm-up) from process start to the window's start is ``setup_s``;
the window runs the kind's traffic for ``--seconds``; the device's peak
memory is read; the program's state is freed; the outputs the window
produced are compared with the plain reference under ``reference/``; the
last line on stdout is one JSON object. With ``--trace 1`` the profiler
covers the part of the window the kind chooses, and the line carries the
per-layer metrics, ``busy_s``, ``window_s`` and a breakdown. The numbers
compared, each with its limit, come last in the line (``checks``) and as
the last lines of stderr. The run exits 1, printing no result, without
enough cards, or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gpu_bpe_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path.relative_to(ROOT)})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} module named {name!r} ({path.relative_to(ROOT)})")
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_metrics(workload: str, section: str) -> list[dict]:
    """The entries of ``BENCHMARK.json[section]`` that ``workload`` reports."""
    return [m for m in benchmark()[section] if workload in m.get("workloads", [workload])]


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(torch, device: str, chips: int) -> dict:
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": chips,
        "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips)),
    }


def load_cell(workload: str, overrides: dict | None = None):
    """The cell, its configuration, its traffic mix and the mix's kind;
    ``overrides`` replace keys of the configuration or the mix (the tests'
    small sizes)."""
    cell = load_json("workloads", workload)
    config = load_json("configs", cell["config"])
    mix = load_json("traffic", cell["traffic"])
    for k, v in (overrides or {}).items():
        (config if k in config else mix)[k] = v
    return cell, config, mix, load_module("traffic", mix["kind"])


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: dict | None = None, patch=None) -> dict:
    """One run; returns the result object. ``device="cpu"`` and
    ``overrides`` (keys of the configuration and the mix, at a small size)
    serve the tests; ``patch(ctx)``, called after set-up, lets a test break
    the timed path."""
    cell, config, mix, kind = load_cell(workload, overrides)
    metrics = []
    if trace:
        for entry in cell_metrics(workload, "per_layer"):
            metrics.append((entry["name"], load_module("metrics", entry["name"])))

    import torch

    if device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        raise SystemExit(f"perfbench: the cell needs {cell['chips']} CUDA device(s); "
                         f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")

    from . import trace as tr
    from .corpus import seeded_corpus

    if trace:
        tr.install_ranges([r for _, m in metrics for r in m.RANGES])
    cuda = device == "cuda"
    ctx = SimpleNamespace(device=device, seed=seed, config=config, mix=mix, tracer=tr.Tracer(trace, cuda),
                          sync=torch.cuda.synchronize if cuda else (lambda: None))
    kind.load_program(ctx)
    ctx.corpus = seeded_corpus(int(config["corpus_mib"] * (1 << 20)), seed, config["generator_words"])
    state = kind.setup(ctx)
    ctx.tracer.warm()
    ctx.sync()
    setup_s = process_age_s()
    log(f"set-up: {setup_s:.2f} s")
    if patch is not None:
        patch(ctx)
    gc.collect()
    gc.freeze()  # what set-up made is never scanned by the window's collections
    t0 = time.perf_counter()
    win = kind.window(ctx, state, seconds)
    log(f"window: {time.perf_counter() - t0:.2f} s, {win.attempted} attempted")
    dev = device_info(torch, device, cell["chips"])

    # a call that raises ends the run with no result, so none failed
    result = {"correct": False, "attempted": win.attempted, "failed": 0, "metrics": {}, "device": dev}
    if trace:
        summary = tr.summarize(ctx.tracer.events or [], kind.counters(ctx, win))
        missing = [r for r in cell.get("traced", []) if not summary.has_range(r)]
        if missing:
            raise SystemExit(f"perfbench: the traced part of {workload} never entered {', '.join(missing)}, "
                             f"which workloads/{workload}.json lists under 'traced'")
        log(f"trace: {len(summary.device)} device operations, "
            f"{sum(a.ranges is None for a in summary.device)} not matched to a launch, "
            f"{len(summary.ranges)} ranges, window {summary.window_s:.3f} s")
        for name, mod in metrics:
            value = mod.read(summary)
            if value is not None:
                result["metrics"][name] = {"value": value, "unit": mod.UNIT}
        dev["busy_s"] = summary.busy_s() if summary.window else 0.0
        dev["window_s"] = summary.window_s
        if summary.window:
            result["breakdown"] = summary.breakdown()
    else:
        e2e = kind.end_to_end(ctx, win)
        e2e["setup_s"] = setup_s
        for entry in cell_metrics(workload, "end_to_end"):
            if entry["name"] in e2e:
                result["metrics"][entry["name"]] = {"value": e2e[entry["name"]], "unit": entry["unit"]}

    kind.release(ctx, state, win)
    del state
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = kind.check(ctx, win)
    log(f"comparison with the reference: {time.perf_counter() - t0:.2f} s")
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except SystemExit as e:
        log(e.code if isinstance(e.code, str) else f"perfbench: exit {e.code}")
        return 1
    found = forbidden_modules()
    if found:
        log(f"perfbench: the run loaded {', '.join(found)}; the benchmark may load none of {', '.join(FORBIDDEN)}")
        return 1
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    if __package__ in (None, ""):
        sys.path.insert(0, str(ROOT))
        __package__ = "perfbench"  # noqa: A001 (relative imports when run as a file)
        import perfbench  # noqa: F401
    sys.exit(main())
