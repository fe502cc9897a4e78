"""Build and load the hand-written CUDA kernels (``ops/csrc/*.cu``).

Each source is compiled on first use by its own ``nvcc`` process (all of
them started together) into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

The libraries land in ``gpu_bpe_tpu_torch/_build/`` (git-ignored), named by
a hash of the source, the shared header and the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is. They are bound with
``ctypes``: every pointer and the stream pass as ``c_void_p``, sizes as
``c_longlong``, host blocks of packed device addresses as ``bytes``, and
each entry point returns its ``cudaGetLastError()``, which the wrappers in
``ops/kernels.py``, ``ops/stab_kernels.py``, ``ops/dense_kernels.py`` and
``ops/bitonic.py`` raise on. A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = (
    "merge_compact_tracked", "count_pairs2", "window_post",
    "compact_mask", "expand_to_mask", "overlay_fit", "bitonic_rounds", "dense_match",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_longlong
_B = ctypes.c_char_p  # a host block of packed addresses (bytes), read by the entry point
# argument types of each library's entry points (see the .cu files)
_SIGNATURES = {
    "merge_compact_tracked": {
        "merge_compact_tracked": [_P, _P, _I] + [_P] * 11,
        "mc_scratch_words": [_I],
        "mc_arena_words": [],
    },
    "count_pairs2": {
        "count_pairs2": [_P, _P, _I] + [_P] * 6,
        "cp_scratch_words": [],
    },
    "window_post": {"window_post": [_B] + [_P] * 7 + [_I] + [_P] * 5},
    "compact_mask": {
        "compact_mask": [_P, _I, _B, _B, _I, _P, _P, _P, _P],
        "cm_scratch_words": [_I],
        "cm_tile_entries": [],
    },
    "expand_to_mask": {
        "expand_to_mask": [_P, _I, _P, _I, _P, _P, _P],
        "em_scratch_words": [_I],
        "em_tile_entries": [],
    },
    "overlay_fit": {
        "overlay_fit": [_P] + [_I] * 8 + [_P] * 3,
        "of_scratch_words": [_I, _I],
        "of_tile_rows": [],
    },
    "bitonic_rounds": {"bitonic_rounds": [_P] * 6 + [_I, _I, _P]},
    "dense_match": {
        "dense_match": [_P, _I, _I, _I, _P, _I, _I, _P, _I, _P, _I, _I] + [_P] * 6,
        "dm_tile_positions": [],
    },
}
_RESTYPES = {name: ctypes.c_longlong
             for name in ("mc_scratch_words", "mc_arena_words", "cp_scratch_words", "cm_scratch_words",
                          "cm_tile_entries", "em_scratch_words", "em_tile_entries", "of_scratch_words",
                          "of_tile_rows", "dm_tile_positions")}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all in parallel. Returns {name: library path}; raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in SOURCES}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    errors = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}.cu (rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[name])
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return paths


@functools.cache
def load() -> dict[str, ctypes.CDLL]:
    """Build if needed, then load each library once per process with its
    entry points' argument and result types declared."""
    libs = {}
    for name, path in build_all().items():
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = _RESTYPES.get(fn, ctypes.c_int)
        libs[name] = lib
    return libs
