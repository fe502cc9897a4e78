"""The program's own spans, for the per-layer readers that read them.

The program records spans at its layer boundaries
(``gpu_bpe_tpu_torch.utils.timing``: ``span``, ``enable``, ``spans``),
stamped on the clock ``torch.profiler`` gives its events, so they line up
with the ``Summary`` of the traced part. A reader module calls
``enable()`` when it is imported: readers are imported only in ``--trace 1``
runs, before the program loads, so a ``--trace 0`` run keeps the tracer
off. The readers take the device-idle time of the traced window by the
innermost program span open on the host (the program's
``timing.idle_by_span``).

A program without the tracer gives every reader nothing to read (``None``);
a program with it whose run recorded none of a reader's spans fails the
run, naming them, so a renamed span cannot read as a quiet ``None``.
"""

from __future__ import annotations

import importlib
import sys

TRACER = "gpu_bpe_tpu_torch.utils.timing"


def _tracer():
    try:
        mod = importlib.import_module(TRACER)
    except ImportError:
        return None
    ok = all(callable(getattr(mod, f, None)) for f in ("enable", "spans", "idle_by_span"))
    return mod if ok else None


def enable() -> None:
    """Turn the program's tracer on, where the program has one."""
    tracer = _tracer()
    if tracer is not None:
        tracer.enable()


def idle_share(summary, names, root: str, label: str) -> float | None:
    """The share of the traced window with no device operation running
    while the innermost open program span is one of ``names``; logs the
    whole split of the idle time by innermost span on stderr. None where
    there is nothing to read (no traced window, or a program without the
    tracer); raises where the program recorded none of ``names``."""
    tracer = _tracer()
    if not summary.window or not summary.device or tracer is None:
        return None
    spans = tracer.spans()
    if not any(s.name in names for s in spans):
        raise LookupError(f"the program recorded no span named {', '.join(sorted(names))}")
    idle = tracer.idle_by_span(summary.window, summary.busy_intervals(), spans)
    total = sum(idle.values())
    below = total - idle.get(None, 0) - idle.get(root, 0)
    split = ", ".join(f"{k}: {v / 1e9:.4f}" for k, v in sorted(idle.items(), key=lambda kv: -kv[1]))
    print(f"spans: {label}: idle {total / 1e9:.4f} s by innermost program span ({split}); "
          f"below the root {below / max(total, 1):.4f}", file=sys.stderr, flush=True)
    window_ns = summary.window[1] - summary.window[0]
    return sum(v for k, v in idle.items() if k in names) / window_ns
