"""Build the native ingest library (``ingest.cpp``, no external
dependencies) into a shared library with g++:

    g++ -O3 -shared -fPIC -std=c++17

The library lands in ``gpu_bpe_tpu_torch/_build/`` (git-ignored), named by a
hash of the source and the flags, so it is built once per tree, at first
use. Several processes may ask at once (the tests run in parallel workers):
the first builds into a temporary file under an exclusive file lock and
moves it into place with ``os.replace``; the others wait on the lock and
find it built. A failed build raises.

    python -m gpu_bpe_tpu_torch.ops.cpp.build
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "ingest.cpp"
BUILD_DIR = HERE.parent.parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libingest-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The ingest library's path, building it first if it is missing."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libingest.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = ["g++", *FLAGS, "-o", str(tmp), str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"ingest build failed (rc {proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(build(), file=sys.stderr)
