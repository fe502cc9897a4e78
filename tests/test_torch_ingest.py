"""The port's ingest (make_stream, pad_stream) and byte-heuristic word
boundaries against the JAX package's, bitwise; and the port's import
isolation from JAX and from gpu_bpe_tpu."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gpu_bpe_tpu.ops.ingest import make_stream as jax_make_stream
from gpu_bpe_tpu.ops.ingest import pad_stream as jax_pad_stream
from gpu_bpe_tpu.pretok import PreTokenizer, tag_word_boundaries_bytes
from gpu_bpe_tpu_torch.ops.ingest import make_stream, pad_stream
from gpu_bpe_tpu_torch.pretok import byte_word_starts
from gpu_bpe_tpu_torch.pretok import tag_word_boundaries_bytes as port_tag

REPO = Path(__file__).resolve().parent.parent


def _equal(a, b):
    assert a.n == b.n and a.total_bytes == b.total_bytes
    np.testing.assert_array_equal(a.symbols[: a.n], b.symbols[: b.n])
    np.testing.assert_array_equal(a.weights[: a.n], b.weights[: b.n])
    assert a.symbols.dtype == b.symbols.dtype and a.weights.dtype == b.weights.dtype


def _cases():
    rng = np.random.default_rng(17)
    d = rng.integers(97, 123, size=80000, dtype=np.uint8).tobytes()
    yield d, (rng.random(80000) < 0.2).astype(np.uint8)
    w = b"abcdefghijklmnopqrstuvwxyz0123456789" * 3  # long words
    d2 = b"the " * 2000 + w * 50 + b"a" * 500
    s2 = np.zeros(len(d2), np.uint8)
    s2[::4] = 1
    yield d2, s2
    yield b"hello", np.zeros(5, np.uint8)  # single word
    yield b"abcabc", np.ones(6, np.uint8)  # 1-byte words
    yield b"\x00\x00ab\x00ab\x00\x00", np.array([1, 0, 1, 0, 0, 1, 0, 0, 0], np.uint8)


@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("dedup", [True, False])
def test_make_stream_bitwise(case, dedup):
    data, starts = list(_cases())[case]
    _equal(make_stream(data, starts, dedup=dedup), jax_make_stream(data, starts, dedup=dedup))


def test_make_stream_pretokenized_and_unmasked(english_text):
    data, starts = PreTokenizer().pre_tokenize(english_text[:20000])
    _equal(make_stream(data, starts), jax_make_stream(data, starts))
    _equal(make_stream(data, None), jax_make_stream(data, None))
    _equal(make_stream(b"", None), jax_make_stream(b"", None))


@pytest.mark.parametrize("n", [0, 5, 2032, 2033, 70000])
def test_pad_stream_bitwise(n):
    rng = np.random.default_rng(n)
    data = rng.integers(97, 100, size=n, dtype=np.uint8).tobytes()
    a = pad_stream(make_stream(data, None, dedup=False))
    b = jax_pad_stream(jax_make_stream(data, None, dedup=False))
    np.testing.assert_array_equal(a.symbols, b.symbols)
    np.testing.assert_array_equal(a.weights, b.weights)
    assert a.n == b.n


def test_byte_heuristic_bitwise(english_text):
    data = (english_text[:6000] + "\n\n  x1 y22;z\tend").encode()
    sym = np.frombuffer(data, np.uint8).astype(np.uint32)
    ref = tag_word_boundaries_bytes(sym)
    np.testing.assert_array_equal(port_tag(sym), ref)
    np.testing.assert_array_equal(byte_word_starts(data), ((ref >> 16) & 1).astype(np.uint8))


def test_import_leaves_out_jax_and_the_reference_package():
    """Every module of the port, found by walking the package (a new
    subpackage is covered without a change here), imports neither JAX nor
    the JAX package: both are blocked, and none is loaded at the end; nor
    do ``scripts/torch_soak_fuzz.py``, which makes a case of the soak,
    ``scripts/torch_microbench_bitonic.py``, which makes its inputs, and the
    headline bench ``bench_torch.py`` and its vocab sweep
    ``scripts/torch_bench_tokenize_vocabs.py``, each run through its
    ``main`` on the CPU (``bench.py`` is blocked as well). The optional
    ``regex`` module is blocked too, and the Unicode library, segmentation
    included, still runs."""
    code = (
        "import importlib, importlib.abc, pkgutil, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'gpu_bpe_tpu', 'regex', 'bench'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import gpu_bpe_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(gpu_bpe_tpu_torch.__path__, 'gpu_bpe_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert {'gpu_bpe_tpu_torch.parallel.dist_train', 'gpu_bpe_tpu_torch.convert',\n"
        "        'gpu_bpe_tpu_torch.unicode.cpp_backend', 'gpu_bpe_tpu_torch.cli',\n"
        "        'gpu_bpe_tpu_torch.ops.native', 'gpu_bpe_tpu_torch.ops.checkpoint',\n"
        "        'gpu_bpe_tpu_torch.ops.selftest', 'gpu_bpe_tpu_torch.core.hf_io',\n"
        "        'gpu_bpe_tpu_torch.utils.logging', 'gpu_bpe_tpu_torch.utils.timing',\n"
        "        'gpu_bpe_tpu_torch.unicode.segmentation', 'gpu_bpe_tpu_torch.unicode.enums',\n"
        "        'gpu_bpe_tpu_torch.unicode.selftest', 'gpu_bpe_tpu_torch.ops.bitonic'} <= set(names), names\n"
        "from gpu_bpe_tpu_torch import unicode as u\n"
        "from gpu_bpe_tpu_torch.unicode import segmentation as seg\n"
        "b = u.get_backend()\n"
        "assert b.name == 'cpp-decoder' and u.PyUnicodeBackend().count_words('two words.') == 2\n"
        "assert seg.count_sentences('One. Two!') == 2 and seg.count_graphemes('e\\u0301x') == 2\n"
        "assert b.is_suspicious('p\\u0430ypal') and b.get_skeleton('\\ufb01le') == 'file'\n"
        "import gpu_bpe_tpu_torch.ops.native as nat\n"
        "assert nat.native_available()\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('torch_soak_fuzz', 'scripts/torch_soak_fuzz.py')\n"
        "soak = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(soak)\n"
        "assert soak.tokenizer_case(1000)['shape'] == 'dense'\n"
        "spec = importlib.util.spec_from_file_location('torch_microbench_bitonic', "
        "'scripts/torch_microbench_bitonic.py')\n"
        "bench = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(bench)\n"
        "assert [tuple(t.shape) for t in bench.script_inputs(1, 'cpu')] == [(1024, 128)] * 3\n"
        "import contextlib, io, tempfile\n"
        "import bench_torch\n"
        "with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):\n"
        "    line = bench_torch.main(['--device', 'cpu', '--selftest-only'])['line']\n"
        "assert line == {'metric': 'kernel_selftest_only', 'value': 'pass'}\n"
        "spec = importlib.util.spec_from_file_location('torch_bench_tokenize_vocabs', "
        "'scripts/torch_bench_tokenize_vocabs.py')\n"
        "sweep = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(sweep)\n"
        "with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):\n"
        "    art = sweep.main(['--device', 'cpu', '--sizes', '257', '--corpus-mb', '1', '--passes', '1', "
        "'--out', tmp + '/r.json', '--cache', tmp])\n"
        "assert [r['vocab'] for r in art['rows']] == [257]\n"
        "bad = [m for m in sys.modules if m in ('jax', 'gpu_bpe_tpu', 'regex') "
        "or m == 'bench' or m.startswith(('jax.', 'gpu_bpe_tpu.', 'regex.'))]\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
