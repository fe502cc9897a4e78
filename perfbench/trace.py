"""The traced run's instruments: ranges around the program's functions, the
profiler over part of the window, and the summary the per-layer readers
take their numbers from.

* ``install_ranges(specs)`` wraps each named function of the program
  (``"module:attr"`` or ``"module:Class.method"``) in a
  ``torch.profiler.record_function`` range named after the attribute,
  in its module and in every module of the program that holds the same
  object. A name that is missing raises, naming it.
* ``Tracer`` runs ``torch.profiler`` (CPU and CUDA activities) over the
  part of the window a traffic kind chooses, inside one range
  ``window``. Its raw events are read directly, without the profiler's own
  per-event post-processing, which would take minutes at a million events.
* ``Summary`` holds what the readers need: the device activities, each
  with the ranges that were open on the host when it was launched (matched
  by the launch's correlation id), the host ranges, the traced window and
  the traffic kind's counters. Its helpers give device time, counts, the
  busy time as the union of device intervals, and the breakdown.
"""

from __future__ import annotations

import functools
import importlib
import inspect
import sys
from collections import defaultdict
from dataclasses import dataclass, field

PREFIX = "pb:"  # the harness's range names
WINDOW = "window"
PROGRAM = "gpu_bpe_tpu_torch"


# ---------------------------------------------------------------- ranges

def _ranged(fn, name: str):
    import torch

    label = PREFIX + name

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    return wrapper


def install_ranges(specs) -> None:
    """Wrap each ``"module:attr.path"`` in a range named ``attr.path``."""
    for spec in sorted(set(specs)):
        mod_name, _, path = spec.partition(":")
        try:
            owner = importlib.import_module(mod_name)
            parts = path.split(".")
            for p in parts[:-1]:
                owner = getattr(owner, p)
            raw = inspect.getattr_static(owner, parts[-1])
        except (ImportError, AttributeError) as e:
            raise LookupError(f"traced function {spec} is missing from the program: {e}") from e
        if isinstance(raw, (classmethod, staticmethod)):
            new = type(raw)(_ranged(raw.__func__, path))
        elif callable(raw):
            new = _ranged(raw, path)
        else:
            raise LookupError(f"traced function {spec} is not callable")
        setattr(owner, parts[-1], new)
        if inspect.ismodule(owner):  # names bound by `from ... import`
            for mname, mod in list(sys.modules.items()):
                if mod is not None and mname.split(".")[0] == PROGRAM:
                    for k, v in list(vars(mod).items()):
                        if v is raw:
                            setattr(mod, k, new)


# ---------------------------------------------------------------- capture

class Tracer:
    """``start()`` and ``stop()`` bound the traced part of the window (once
    per run); ``events`` holds the profiler's raw events afterwards. A
    Tracer that is off does nothing."""

    def __init__(self, on: bool, cuda: bool = True):
        self.on = on
        self.cuda = cuda
        self.events = None
        self._prof = self._range = None

    def warm(self) -> None:
        """Start and stop the profiler once over a trivial operation, so that
        its own initialisation falls in set-up and not in the window."""
        import torch

        if self.on:
            once = Tracer(True, self.cuda)
            once.start()
            torch.ones(1, device="cuda" if self.cuda else "cpu").add_(1)
            once.stop()

    def start(self) -> None:
        import torch

        if not self.on or self._prof is not None:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._range = torch.profiler.record_function(PREFIX + WINDOW)
        self._range.__enter__()

    def stop(self) -> None:
        import torch
        from torch.autograd import profiler as autograd_profiler

        if self._range is None:
            return
        self._range.__exit__(None, None, None)
        self._range = None
        if self.cuda:
            torch.cuda.synchronize()
        # keep the raw results only: the per-event FunctionEvent parse is
        # skipped (it is lazy in newer releases, eager in older ones)
        parse = autograd_profiler.profile._parse_kineto_results
        autograd_profiler.profile._parse_kineto_results = lambda self, *a, **k: []
        try:
            self._prof.stop()
        finally:
            autograd_profiler.profile._parse_kineto_results = parse
        self.events = self._prof.profiler.kineto_results.events()


# ---------------------------------------------------------------- summary

def device_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        if "HtoD" in name:
            return "memcpy_htod"
        if "DtoH" in name:
            return "memcpy_dtoh"
        return "memcpy_other"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    argument list, at most 120 characters."""
    if name.startswith(("Memcpy", "Memset")):
        return name[:120]
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(", 1)[0].strip()[:120]


@dataclass
class Activity:
    name: str
    kind: str
    start: int  # ns
    end: int
    ranges: frozenset | None  # ranges open at the launch; None when unmatched


@dataclass
class Summary:
    window: tuple[int, int] | None = None  # ns
    device: list[Activity] = field(default_factory=list)
    ranges: list[tuple[str, int, int]] = field(default_factory=list)
    counters: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9 if self.window else 0.0

    def select(self, *, kinds=None, names=None, within=None):
        """Device activities of ``kinds``, whose short name is in ``names``,
        launched inside range ``within`` (a name, or a tuple of names: any
        of them), each once."""
        if isinstance(within, str):
            within = (within,)
        for a in self.device:
            if kinds is not None and a.kind not in kinds:
                continue
            if names is not None and short_name(a.name) not in names:
                continue
            if within is not None and (a.ranges is None or a.ranges.isdisjoint(within)):
                continue
            yield a

    def device_s(self, **sel) -> float:
        return sum(a.end - a.start for a in self.select(**sel)) / 1e9

    def count(self, **sel) -> int:
        return sum(1 for _ in self.select(**sel))

    def host_s(self, name: str) -> float:
        """Host time inside range ``name``, nested calls counted once."""
        spans = sorted((s, e) for n, s, e in self.ranges if n == name)
        return _union(spans) / 1e9

    def has_range(self, name: str) -> bool:
        return any(n == name for n, _, _ in self.ranges)

    def busy_intervals(self) -> list[tuple[int, int]]:
        lo, hi = self.window
        spans = sorted((max(a.start, lo), min(a.end, hi)) for a in self.device if a.end > lo and a.start < hi)
        merged: list[list[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def breakdown(self) -> dict:
        ops = defaultdict(int)
        for a in self.device:
            ops[short_name(a.name)] += a.end - a.start
        lo, hi = self.window
        gaps, prev = [], lo
        for s, e in self.busy_intervals():
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if hi > prev:
            gaps.append((prev, hi))
        by_host = defaultdict(int)
        for (s, e), (_, inner) in zip(gaps, _sweep(self.ranges, [(s + e) // 2 for s, e in gaps])):
            by_host[inner or "outside the traced ranges"] += e - s
        top = lambda d: [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
        return {"device_ops": top(ops), "idle_gaps": top(by_host)}


def _union(spans) -> int:
    total, end = 0, None
    for s, e in spans:
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _sweep(ranges, times):
    """For each query time (any order), the ranges open at it, as
    (frozenset of names, innermost name or None)."""
    marks = []
    for i, (name, s, e) in enumerate(ranges):
        marks.append((s, 0, i))
        marks.append((e, 2, i))
    for j, t in enumerate(times):
        marks.append((t, 1, j))
    marks.sort()
    open_ = {}  # range index -> (start, name)
    out = [None] * len(times)
    cache = {}
    for t, what, i in marks:
        if what == 0:
            open_[i] = (ranges[i][1], ranges[i][0])
        elif what == 2:
            open_.pop(i, None)
        else:
            key = tuple(sorted(open_))
            got = cache.get(key)
            if got is None:
                names = frozenset(n for _, n in open_.values())
                inner = max(open_.values())[1] if open_ else None
                got = cache[key] = (names, inner)
            out[i] = got
    return out


def summarize(events, counters: dict) -> Summary:
    """The Summary of a profiler's raw events."""
    from torch.autograd import DeviceType

    ranges, launches, dev = [], {}, []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name.startswith(PREFIX):
                ranges.append((name[len(PREFIX):], e.start_ns(), e.end_ns()))
            elif name.startswith("cu") and e.correlation_id():
                launches[e.correlation_id()] = e.start_ns()
        elif e.device_type() == DeviceType.CUDA and not name.startswith(PREFIX):
            dev.append((name, e.start_ns(), e.end_ns(), e.correlation_id()))
    win = [(s, e) for n, s, e in ranges if n == WINDOW]
    window = win[0] if win else None
    ranges = [r for r in ranges if r[0] != WINDOW]
    times = [launches.get(c) for _, _, _, c in dev]
    found = _sweep(ranges, [-1 if t is None else t for t in times])
    activities = [
        Activity(name, device_kind(name), s, e, None if times[i] is None else found[i][0])
        for i, (name, s, e, _) in enumerate(dev)
    ]
    return Summary(window=window, device=activities, ranges=ranges, counters=dict(counters))
