"""The JAX package's native Unicode decoder for the port's tests, from a
private copy of its library.

``gpu_bpe_tpu.unicode.cpp.build.build()`` rebuilds
``gpu_bpe_tpu/unicode/cpp/libdecoder.so`` in place, with no lock, whenever
the file is not newer than its sources, which on a fresh copy of the tree
is a matter of chance. Test workers that build it at once then load it
while another one writes it, and get a short file. So the port's tests never
load that file: ``library()`` compiles the decoder once per process into a
directory of its own, with the JAX package's own ``build()`` (its source,
its tables and its g++ command) pointed there, and ``backend()`` returns
JAX ``CppUnicodeBackend`` instances bound to that copy. The copy has its
own reference-compat Hangul flag, shared by every backend ``backend()``
returns in the process.
"""

import atexit
import functools
import shutil
import tempfile
from pathlib import Path

import pytest

from gpu_bpe_tpu.unicode import cpp_backend
from gpu_bpe_tpu.unicode.cpp import build


@functools.cache
def library() -> Path:
    """This process's copy of the JAX decoder library, built at first use."""
    out = Path(tempfile.mkdtemp(prefix="jax-decoder-"))
    atexit.register(shutil.rmtree, out, ignore_errors=True)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(build, "LIB", out / "libdecoder.so")
        return build.build(force=True)


def backend() -> cpp_backend.CppUnicodeBackend:
    """A JAX native backend bound to this process's copy of the library."""
    path = library()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(build, "build", lambda force=False: path)
        return cpp_backend.CppUnicodeBackend()
