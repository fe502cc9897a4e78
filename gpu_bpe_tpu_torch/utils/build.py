"""Build and load the port's native libraries: the CUDA kernels
(``ops/csrc/*.cu``, with ``nvcc``, described in ``ops/build.py``), the
ingest library (``ops/cpp/ingest.cpp``, with g++, ``ops/native.py``) and the
Unicode decoder (``unicode/cpp/decoder.cpp``, with g++,
``unicode/cpp_backend.py``).

Each library is a ``Library``: its source, the headers it includes, its
compiler and flags, and its entry points' C signatures. ``load`` builds
what is missing and binds the rest with ``ctypes``. A library lands in
``gpu_bpe_tpu_torch/_build/`` (git-ignored) as ``lib<name>-<hash>.so``, the
hash taken over the source, the headers and the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is: each library is built
once per tree, at first use.

Several processes may ask at once (the tests run in parallel workers, the
data-parallel trainer in one process per card). Each library has its own
exclusive file lock (``lib<name>.lock``); a build takes the locks of every
library it lacks, in name order, and looks again under them, starts one
compiler per library still missing, all together, into
``<library>.<pid>.tmp``, and moves each finished one into place with
``os.replace``. Waiting processes find them built. A failed compile raises
with the compiler's output and leaves no temporary file behind.

This module imports nothing of the package, so the Unicode library uses it
without importing ``ops/`` or torch.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import subprocess
from collections.abc import Callable, Sequence
from dataclasses import dataclass
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


def gxx() -> str:
    """The host C++ compiler (a missing one raises when the build starts it)."""
    return "g++"


@dataclass(frozen=True)
class Library:
    """One shared library: ``source`` compiled by ``compiler()`` with
    ``flags``; ``headers`` are the files the source includes, hashed with it.
    ``entries`` declares the entry points, ``{names: (restype, argtypes)}``,
    a key holding one or more space-separated names of one signature."""

    name: str
    source: Path
    flags: tuple[str, ...]
    entries: dict
    headers: tuple[Path, ...] = ()
    compiler: Callable[[], str] = gxx

    def path(self) -> Path:
        """Where the library of the current source, headers and flags lives."""
        h = hashlib.sha256()
        for part in (self.source, *self.headers):
            h.update(part.read_bytes())
        h.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"


def _compile(todo: list[tuple[Library, Path]]) -> None:
    """Start one compiler per library, all together, and move each finished
    one into place; raises with the output of every compile that failed."""
    compilers = [lib.compiler() for lib, _ in todo]  # a missing one raises before any compile starts
    procs = []
    for (lib, out), cc in zip(todo, compilers):
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cc, *lib.flags, "-o", str(tmp), str(lib.source)]
        procs.append((lib, out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                      text=True)))
    errors = []
    for lib, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{lib.source.name} (rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("native library build failed:\n" + "\n".join(errors))


def build(libs: Sequence[Library]) -> dict[str, Path]:
    """Build every library of ``libs`` whose file is missing; returns
    ``{name: path}``."""
    paths = {lib.name: lib.path() for lib in libs}
    todo = sorted((lib for lib in libs if not paths[lib.name].exists()), key=lambda lib: lib.name)
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with contextlib.ExitStack() as locks:
        for lib in todo:
            lock = locks.enter_context(open(BUILD_DIR / f"lib{lib.name}.lock", "w"))
            fcntl.flock(lock, fcntl.LOCK_EX)
        _compile([(lib, paths[lib.name]) for lib in todo if not paths[lib.name].exists()])
    return paths


def declare(lib: ctypes.CDLL, entries: dict) -> ctypes.CDLL:
    """Give each entry point of ``entries`` its argument and result types."""
    for names, (restype, argtypes) in entries.items():
        for name in names.split():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
    return lib


def load(libs: Sequence[Library]) -> dict[str, ctypes.CDLL]:
    """Build what is missing, then load each library with its entry points
    declared: ``{name: library}``."""
    paths = build(libs)
    return {lib.name: declare(ctypes.CDLL(str(paths[lib.name])), lib.entries) for lib in libs}
