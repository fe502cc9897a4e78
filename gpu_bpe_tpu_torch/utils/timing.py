"""Spans on the profiler's clock, phase timing and human-readable formatting
(the port's copy of ``gpu_bpe_tpu/utils/timing.py``, with the tracer).

The tracer records the program's layers as spans: ``span(name)`` is a
context manager that, while tracing is on, records ``Span(name, start_ns,
end_ns, parent, attrs)`` in an in-memory list, in the order spans end.
``parent`` is the index in that list of the enclosing span (-1 for a root,
None while the enclosing span is still open); every span of one
``api.train`` job or one ``Tokenizer.encode_bytes`` call leads up to that
call's root. ``attrs`` holds small ints and strings: a constant ``site``
passed with the name, and whatever ``note(**attrs)`` adds while the span is
open.

Spans are stamped with ``time.time_ns()`` (CLOCK_REALTIME), the clock that
``torch.profiler`` gives its events, host ranges and device activity alike,
so a span lines up with the kernels launched inside it. While a profiler is
active, each span is also a profiler range of its name (a ``cpu_op`` event,
as an operator's, not a user annotation, which would add a device-side
annotation spanning the kernels), so a trace such as ``api``'s
``profile_dir`` shows the program's layers beside the kernels.
``idle_by_span`` splits a traced window's device-idle time by the innermost
span open on the host.

Tracing is off by default: ``enable()``, ``disable()``, ``spans()`` and
``clear()`` turn it on and off and read it; a caller that turns tracing on
owns ``clear()``: the list grows until then. Off, ``span`` tests one flag and
hands back a shared object that does nothing: no clock read, no
allocation.

``PhaseTimer`` times named phases on the host's wall clock, as the
reference's ``performance.now()`` spans do (trainer.js:230,291-303); each
phase is also a span. With ``profile_dir`` set and tracing off, each phase
is a ``torch.profiler.record_function`` range.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import NamedTuple


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int | None  # index in spans() of the enclosing span; -1 for a root
    attrs: dict


_on = False
_spans: list[Span] = []
_open: list["_Live"] = []  # the spans entered and not yet left, innermost last
_profiling = _range = None  # bound by enable(), which imports torch


def enable() -> bool:
    """Turn tracing on; returns whether it was on."""
    global _on, _profiling, _range
    import torch

    _profiling = torch._C._autograd._profiler_enabled
    _range = torch._C._profiler._RecordFunctionFast
    was, _on = _on, True
    return was


def disable() -> None:
    global _on
    _on = False


def spans() -> list[Span]:
    """The finished spans, in the order they ended."""
    return list(_spans)


def clear(keep: int = 0) -> None:
    """Drop the finished spans, all but the first ``keep``."""
    del _spans[keep:]
    for live in _open:
        live.kids[:] = [k for k in live.kids if k < keep]


class _Off:
    """The shared span of tracing off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def note(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Live:
    __slots__ = ("name", "attrs", "start", "kids", "rf")

    def __init__(self, name: str, site: str | None):
        self.name = name
        self.attrs = {} if site is None else {"site": site}
        self.kids: list[int] = []

    def note(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        self.rf = None
        if _profiling():
            self.rf = _range(self.name)
            self.rf.__enter__()
        _open.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _open.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        i = len(_spans)
        for k in self.kids:
            _spans[k] = _spans[k]._replace(parent=i)
        if _open:
            _open[-1].kids.append(i)
        _spans.append(Span(self.name, self.start, end, None if _open else -1, self.attrs))
        return None


def span(name: str, site: str | None = None):
    """A span of ``name`` (never starting with ``pb:`` or ``cu``, which a
    trace reader takes for the benchmark's ranges and for launches);
    ``site`` is a constant attribute, for the sites that run once per
    merge."""
    if not _on:
        return _OFF
    return _Live(name, site)


def idle_by_span(window: tuple[int, int], busy, spans_=None) -> dict:
    """The device-idle time of ``window`` (ns, on the spans' clock) by the
    innermost span open on the host at the time: ``{name or None: ns}``,
    None where no span is open. ``busy`` holds the device's (start, end)
    intervals, in any order and overlapping; ``spans_`` defaults to
    ``spans()``."""
    lo, hi = window
    spans_ = _spans if spans_ is None else spans_
    gaps, prev = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in busy if e > lo and s < hi):
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    # the innermost open span over time: spans nest, so it is the open
    # span entered last
    marks = []
    for i, s in enumerate(spans_):
        if s.end_ns > lo and s.start_ns < hi:
            marks.append((max(s.start_ns, lo), 1, -s.end_ns, i))  # of two at one time, the outer first
            marks.append((min(s.end_ns, hi), 0, 0, i))
    marks.sort()
    segs, stack, t_prev = [], [], lo
    for t, entering, _, i in marks:
        if t > t_prev:
            segs.append((t_prev, t, spans_[stack[-1]].name if stack else None))
            t_prev = t
        if entering:
            stack.append(i)
        else:
            stack.remove(i)
    segs.append((t_prev, hi, spans_[stack[-1]].name if stack else None))
    out: dict = {}
    j = 0
    for g0, g1 in gaps:
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < g1:
            s0, s1, name = segs[k]
            out[name] = out.get(name, 0) + min(g1, s1) - max(g0, s0)
            k += 1
    return out


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
    """Accumulating named-phase timer; each phase is a span. It reads the
    host clock only: a phase that enqueues device work ends when the host
    returns, not when the card finishes."""

    profile_dir: str | None = None
    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        ctx = contextlib.nullcontext()
        if self.profile_dir and not _on:  # else the span is the range
            import torch

            ctx = torch.profiler.record_function(name)
        t0 = time.perf_counter()
        with span(name), ctx:
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
