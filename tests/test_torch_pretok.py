"""The port's Unicode pre-tokenizer against the JAX package's, bitwise
(tolerance 0: normalized bytes and word-start masks must be equal), with
each package's native backend and each one's Python backend, on the
fixtures of ``tests/test_pretok.py`` and ``tests/test_unicode_cpp.py``,
invalid UTF-8, NFC-changing input and a 1 MB cut of the synthetic corpus;
and the port's native-library builder (``utils/build.py``) on its two g++
libraries: one build per tree, concurrent first builds, a failed compile."""

import subprocess
import sys

import numpy as np
import pytest
from jax_decoder import backend as jax_native

from gpu_bpe_tpu.pretok import PreTokenizer as JaxPreTokenizer
from gpu_bpe_tpu.pretok import find_word_boundaries as jax_boundaries
from gpu_bpe_tpu.unicode import PyUnicodeBackend as JaxPy
from gpu_bpe_tpu_torch import unicode as tuni
from gpu_bpe_tpu_torch.ops import native
from gpu_bpe_tpu_torch.pretok import PreTokenizer, find_word_boundaries
from gpu_bpe_tpu_torch.unicode import PyUnicodeBackend, cpp_backend
from gpu_bpe_tpu_torch.unicode.cpp_backend import CppUnicodeBackend
from gpu_bpe_tpu_torch.utils import build

TEXTS = [
    # tests/test_pretok.py
    "kabul edilmek", "a   b", "ab\ncd", "a\n\nb", "don't stop they'll wait we've seen it's fine",
    "I'm here he'd go you're ok", "don’t stop", "a'sand", "DON'T", "abc123 123abc", "end. .end a+b",
    "1234567 12 123456", "!!!??? ---", "the quick brown fox",
    "don't they'll we've it's I'm he'd you're O'Brien's", "abc123def456 12,345,678.90",
    "line1\nline2\r\nline3 line4", "  leading and   multiple   spaces ", "naïve café ağır ğışçöü İstanbul",
    "北京 москва الශ්‍රී 🙂🙂", "a'sa b'ts c're'll d'Re E'LL f'Ve", "tabs\tand\x0bvtabs\x0cff",
    "mixed!@#$%^&*()123abc...def", "'''", "a'", "1'000'000", "ağır café",
    # tests/test_unicode_cpp.py NFC samples (several change under NFC)
    "hello world", "étude déjà-vu naïve", "étude", "ä́", "ḍ̇", "한국어 조합", "각",
    "北京 москва الشرق", "🙂👨‍👩‍👧‍👦", "Ǻx", "ﬁle", "q̣̇", "ཷ", "Å", "ﬁle ﬂow ﬀ",
    "①②③ ㊤ ㎒ ㎞", "ﷺ", "²³ ¼½¾ ⅓", "ＡＢＣ１２３ ｶﾞｷﾞ", "㈱ ㌀ ｟｠",
]
INVALID = [b"ok \xff\xfe bytes", b"\xc3", b"abc \xe2\x82 def", b"\x80\x80 x", b"caf\xc3\xa9 \xf0\x9f\x99"]


@pytest.fixture(scope="module")
def pairs():
    """(port, JAX) pre-tokenizers per backend."""
    return {"cpp": (PreTokenizer(CppUnicodeBackend()), JaxPreTokenizer(jax_native())),
            "python": (PreTokenizer(PyUnicodeBackend()), JaxPreTokenizer(JaxPy()))}


def _same(a, b):
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("backend", ["cpp", "python"])
def test_fixtures(pairs, backend):
    port, ref = pairs[backend]
    for text in TEXTS:
        _same(port.pre_tokenize(text), ref.pre_tokenize(text))
        _same(port.pre_tokenize_bytes(text.encode()), ref.pre_tokenize_bytes(text.encode()))
    for raw in INVALID:
        _same(port.pre_tokenize_bytes(raw), ref.pre_tokenize_bytes(raw))
    assert port.pre_tokenize("")[0] == port.pre_tokenize_bytes(b"")[0] == b""


@pytest.mark.parametrize("backend", ["cpp", "python"])
def test_english_and_synthetic_corpus(pairs, backend, english_text):
    from chip_smoke import synth_corpus

    port, ref = pairs[backend]
    _same(port.pre_tokenize(english_text), ref.pre_tokenize(english_text))
    data = synth_corpus(1 << 20, seed=0) if backend == "cpp" else synth_corpus(1 << 17, seed=0)
    # an NFC-changing prefix (decomposed accents) ahead of the corpus
    data = "Café étude Å ".encode() + data
    got = port.pre_tokenize_bytes(data)
    _same(got, ref.pre_tokenize_bytes(data))
    assert len(got[0]) < len(data) and got[1].sum() > len(data) // 20


def test_boundaries_numpy_and_native(english_text):
    cps = np.array([ord(c) for c in english_text + "".join(TEXTS)], dtype=np.uint32)
    classes = PyUnicodeBackend().classify_codepoints(cps)
    want = jax_boundaries(cps, classes)
    np.testing.assert_array_equal(find_word_boundaries(cps, classes), want)
    np.testing.assert_array_equal(CppUnicodeBackend().find_word_boundaries(cps, classes), want)
    np.testing.assert_array_equal(CppUnicodeBackend().classify_codepoints(cps), classes)


def test_backend_is_native_and_built_once():
    """With g++ present the default backend is the native one, built into
    the package's ``_build/`` (not the JAX package's library), once."""
    assert tuni.backend_name() == "cpp-decoder"
    path = build.build([cpp_backend.LIBRARY])["decoder"]
    assert path.parent == build.BUILD_DIR and path.name.startswith("libdecoder-") and path.exists()
    mtime = path.stat().st_mtime_ns
    assert build.build([cpp_backend.LIBRARY])["decoder"] == path and path.stat().st_mtime_ns == mtime


@pytest.mark.parametrize("module", ["gpu_bpe_tpu_torch.unicode.cpp_backend", "gpu_bpe_tpu_torch.ops.native"])
def test_concurrent_first_builds(tmp_path, module):
    """Three processes building one g++ library into an empty directory at
    once: each gets the library, and no temporary file is left behind."""
    code = ("import importlib, sys; from pathlib import Path; from gpu_bpe_tpu_torch.utils import build; "
            "build.BUILD_DIR = Path(sys.argv[1]); lib = importlib.import_module(sys.argv[2]).LIBRARY; "
            "print(build.build([lib])[lib.name])")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path), module], stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = {p.communicate(timeout=300)[0].strip() for p in procs}
    assert all(p.returncode == 0 for p in procs) and len(outs) == 1
    name = outs.pop().rsplit("/", 1)[1]
    assert {f.name for f in tmp_path.iterdir()} == {name.split("-")[0] + ".lock", name}


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """A compile that fails raises with the compiler's output and leaves no
    temporary file behind; a library built beside it in the same call
    lands."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    broken = tmp_path / "broken.cpp"
    broken.write_text('#error "deliberately broken source"\n')
    libs = [build.Library("broken", broken, native.LIBRARY.flags, {}), native.LIBRARY]
    with pytest.raises(RuntimeError, match=r"broken\.cpp \(rc 1\):\n(.|\n)*deliberately broken source"):
        build.build(libs)
    assert {f.name for f in (tmp_path / "out").iterdir()} == {
        "libbroken.lock", "libingest.lock", native.LIBRARY.path().name}
