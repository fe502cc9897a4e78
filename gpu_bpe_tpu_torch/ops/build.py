"""The hand-written CUDA kernels (``ops/csrc/*.cu``): their build, their
bindings and the plumbing every wrapper launches them with.

Each source is compiled on first use by its own ``nvcc`` process (all of
them started together, by ``utils/build.py``, which owns the build
directory, the hash naming, the locks and the errors) into a shared
library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

``KERNELS`` lists each library's entry points with their C signatures;
adding a kernel takes its ``.cu`` file, one entry there and its wrapper.
Every pointer and the stream pass as ``c_void_p``, sizes as ``c_longlong``,
host blocks of packed device addresses as ``bytes``, and each launch entry
returns its ``cudaGetLastError()``, which the wrappers (``ops/kernels.py``,
``ops/stab_kernels.py``, ``ops/dense_kernels.py``, ``ops/walk_kernels.py``,
``ops/bitonic.py``) raise on through ``check``. A failed build raises.

The launch plumbing the wrappers share lives here too: ``on_cpu`` (which
path a call takes), ``require`` (dtype, shape, contiguity), ``ptr``,
``current_stream`` and ``on_device`` for the launch, ``check`` and
``check_scratch`` for its result, ``cached_scratch`` for look-back and
reduction scratch kept between calls, and ``LAUNCHES``, the launch counts
by wrapper.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import shutil
from collections import Counter
from pathlib import Path

import torch

from ..utils import build as native_build

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_R = ctypes.c_int  # a launch's cudaGetLastError()
_P = ctypes.c_void_p
_I = ctypes.c_longlong
_B = ctypes.c_char_p  # a host block of packed addresses (bytes), read by the entry point
# each library's entry points, {names: (restype, argtypes)} (see the .cu files)
KERNELS = {
    "merge_compact_tracked": {
        "merge_compact_tracked": (_R, [_P, _P, _I] + [_P] * 13),
        "mc_scratch_words": (_I, [_I]),
        "mc_arena_words": (_I, []),
    },
    "count_pairs2": {
        "count_pairs2": (_R, [_P, _P, _I] + [_P] * 6),
        "cp_scratch_words": (_I, []),
    },
    "window_post": {"window_post": (_R, [_B] + [_P] * 7 + [_I] + [_P] * 5)},
    "compact_mask": {
        "compact_mask": (_R, [_P, _I, _B, _B, _I, _P, _P, _P, _P]),
        "cm_scratch_words": (_I, [_I]),
        "cm_tile_entries": (_I, []),
    },
    "expand_to_mask": {
        "expand_to_mask": (_R, [_P, _I, _P, _I, _P, _P, _P]),
        "em_scratch_words": (_I, [_I]),
        "em_tile_entries": (_I, []),
    },
    "overlay_fit": {
        "overlay_fit": (_R, [_P] + [_I] * 8 + [_P] * 3),
        "of_scratch_words": (_I, [_I, _I]),
        "of_tile_rows": (_I, []),
    },
    "bitonic_rounds": {"bitonic_rounds": (_R, [_P] * 6 + [_I, _I, _P])},
    "dense_match": {
        "dense_match": (_R, [_P, _I, _I, _I, _P, _I, _I, _P, _I, _P, _I, _I] + [_P] * 6),
        "dm_tile_positions": (_I, []),
    },
    "chunk_walk": {
        "chunk_walk": (_R, [_P, _P, _P, _I, _I, _I, _P, _P]),
        "cw_chunks_per_block": (_I, [_I]),
    },
}


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


LIBRARIES = tuple(
    native_build.Library(name, CSRC / f"{name}.cu", NVCC_FLAGS, entries, (CSRC / "common.cuh",), _nvcc)
    for name, entries in KERNELS.items()
)


def build_all() -> dict[str, Path]:
    """Compile every kernel library that is missing, one ``nvcc`` per
    source, all in parallel. Returns {name: library path}; raises with the
    compiler's output if any build fails."""
    return native_build.build(LIBRARIES)


@functools.cache
def load() -> dict[str, ctypes.CDLL]:
    """Build if needed, then load each library once per process with its
    entry points' argument and result types declared."""
    return native_build.load(LIBRARIES)


# ───────────────────────────── launch plumbing ─────────────────────────────

LAUNCHES: Counter = Counter()  # kernel launches per wrapper; clear() to reset


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on the CPU (the wrapper takes the plain
    version), False on one CUDA device (it launches the kernel); raises
    for several devices or another kind."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def require(t: torch.Tensor, dtype, shape=None, name="tensor") -> None:
    """Raise unless ``t`` is contiguous, of ``dtype`` and, given one, of ``shape``."""
    if t.dtype != dtype or not t.is_contiguous() or (shape is not None and tuple(t.shape) != shape):
        raise ValueError(f"{name}: want contiguous {dtype} {shape or ''}, got {t.dtype} {tuple(t.shape)}")


def ptr(t: torch.Tensor) -> int:
    """Device address of ``t``, for a ``c_void_p`` argument (ctypes takes the
    int as it is, with no wrapper object per argument)."""
    return t.data_ptr()


def current_stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device`` as a raw handle (the lookup
    Triton's launcher makes; ``torch.cuda.current_stream`` builds a Stream
    object per call); the caller launches inside ``on_device(device)`` so
    that the kernel runs on that card."""
    return torch._C._cuda_getCurrentRawStream(device.index)


_SAME_DEVICE = contextlib.nullcontext()


def on_device(device: torch.device):
    """A context in which ``device`` is the current CUDA device: nothing to
    do when it already is (the usual case), else ``torch.cuda.device``."""
    return _SAME_DEVICE if torch.cuda.current_device() == device.index else torch.cuda.device(device)


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


# Look-back and reduction scratch of the kernels, by (kernel, device index,
# size, stream): zeroed once when it is made. merge_compact_tracked.cu and
# count_pairs2.cu leave it zeroed again, so no call clears it;
# expand_to_mask.cu and overlay_fit.cu clear it with one memset per call.
# A stream orders the calls that share one.
_SCRATCH: dict[tuple, torch.Tensor] = {}


def cached_scratch(key: tuple, device: torch.device, words) -> torch.Tensor:
    """The int64 scratch of ``key``, made zeroed with ``words()`` words on
    ``device`` (on its current stream) at first use."""
    buf = _SCRATCH.get(key)
    if buf is None:
        buf = _SCRATCH[key] = torch.zeros(int(words()), dtype=torch.int64, device=device)
    return buf


def check_scratch(rc: int, name: str, key: tuple) -> None:
    """``check`` for a launch on cached scratch: a failed launch may leave
    it dirty, so its entry is dropped before raising."""
    if rc != 0:
        _SCRATCH.pop(key, None)
        check(rc, name)
