"""Phase timing and human-readable formatting (the port's copy of
``gpu_bpe_tpu/utils/timing.py``).

``PhaseTimer`` times named phases on the host's wall clock, as the
reference's ``performance.now()`` spans do (trainer.js:230,291-303). With
``profile_dir`` set, each phase is also a ``torch.profiler.record_function``
range, so a trace taken around it shows the phase by name.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


def format_duration(seconds: float) -> str:
    """The reference's formatting: seconds below a minute, else ``Nm Ss``."""
    if seconds < 60:
        return f"{seconds:.1f}s"
    m = int(seconds // 60)
    s = round(seconds % 60)
    return f"{m}m {s}s" if s > 0 else f"{m}m"


def format_size(n_bytes: int) -> str:
    if n_bytes < 1024:
        return f"{n_bytes} B"
    if n_bytes < 1 << 20:
        return f"{n_bytes / 1024:.1f} KB"
    if n_bytes < 1 << 30:
        return f"{n_bytes / (1 << 20):.1f} MB"
    return f"{n_bytes / (1 << 30):.2f} GB"


@dataclass
class PhaseTimer:
    """Accumulating named-phase timer with optional profiler ranges. It
    reads the host clock only: a phase that enqueues device work ends when
    the host returns, not when the card finishes."""

    profile_dir: str | None = None
    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        ctx = contextlib.nullcontext()
        if self.profile_dir:
            import torch

            ctx = torch.profiler.record_function(name)
        t0 = time.perf_counter()
        with ctx:
            yield
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = [
            f"{name}: {format_duration(total)} ({self.counts[name]}x)"
            for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)
