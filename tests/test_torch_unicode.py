"""The port's Unicode library (``gpu_bpe_tpu_torch.unicode``) against the
JAX package's (``gpu_bpe_tpu.unicode``), exactly (tolerance 0: ints, bools,
strings, bytes and integer arrays, and their types, must be equal; an input
one package refuses the other must refuse with the same exception type).

* every public method of the two backends, native against native and
  Python against Python, on all ASCII, a seeded sample of 20,000
  codepoints over the whole space, the Hangul and jamo ranges, the
  codepoints assigned since Unicode 15.0 and every confusable entry, and
  on strings, bytes and code-unit arrays made from them;
* every one of the 97 bound native exports, with the JAX binding's
  argument and result types, called directly on both libraries;
* batch classification and categories over all 0x110000 codepoints;
* ``segmentation``, ``enums``, ``utf8`` and the package's exports, with the
  ``regex`` module present and hidden;
* the reference-compat Hangul mode: normalization in both modes, the two
  libraries' flags apart, the environment variable in a subprocess, and
  ``api.train(device="cpu")`` on a 1 MB decomposed-jamo cut against JAX
  ``api.train`` in each mode;
* ``ops.apply_merge_device`` and ``ops.find_best_pair`` against JAX's on
  seeded streams, and the package's top-level names.

The JAX native backend comes from this process's own build of the JAX
decoder (``jax_decoder.py``), never from ``gpu_bpe_tpu/unicode/cpp/``,
whose library other test processes may be rebuilding in place.
"""

import ctypes
import inspect
import itertools
import math
import os
import subprocess
import sys
import unicodedata
from pathlib import Path

import numpy as np
import pytest
import torch
from jax_decoder import backend as jax_native
from jax_decoder import library as jax_native_library
from test_unicode_cpp import NFC_SAMPLES

import gpu_bpe_tpu
import gpu_bpe_tpu.unicode as jun
import gpu_bpe_tpu_torch
import gpu_bpe_tpu_torch.unicode as tun
from gpu_bpe_tpu.unicode import enums as jenums
from gpu_bpe_tpu.unicode import segmentation as jseg
from gpu_bpe_tpu.unicode import utf8 as jutf8
from gpu_bpe_tpu.unicode.cpp_backend import CppUnicodeBackend as JaxCpp
from gpu_bpe_tpu.unicode.fallback import PyUnicodeBackend as JaxPy
from gpu_bpe_tpu_torch.unicode import enums, segmentation, utf8
from gpu_bpe_tpu_torch.unicode.cpp_backend import CppUnicodeBackend
from gpu_bpe_tpu_torch.unicode.fallback import PyUnicodeBackend, _category_ids

REPO = Path(__file__).resolve().parent.parent
FORMS = ("NFC", "NFD", "NFKC", "NFKD", 0, 1, 2, 3)


# ───────────────────────────────── inputs ─────────────────────────────────


def _post_15():
    """Codepoints assigned since Unicode 15.0 (CPython's ``unicodedata``
    tables): assigned in the ``regex`` module's newer data, or, without it,
    those whose decompositions were recovered from the reference binary."""
    try:
        import regex
    except ImportError:
        from gpu_bpe_tpu.unicode.cpp.gen_tables import EXTRA_CANONICAL, EXTRA_COMPAT

        return sorted(set(EXTRA_CANONICAL) | set(EXTRA_COMPAT))
    every = "".join(map(chr, range(0x110000)))
    return [m.start() + k for m in regex.finditer(r"\p{Assigned}+", every)
            for k in range(m.end() - m.start()) if unicodedata.category(every[m.start() + k]) == "Cn"]


def _confusables():
    from gpu_bpe_tpu_torch.unicode.fallback import _confusable_table

    return sorted(_confusable_table())


def _codepoints():
    rng = np.random.default_rng(0)
    groups = {
        "ascii": list(range(128)),
        "sample": [int(c) for c in rng.integers(0, 0x110000, 20_000)],
        "hangul": list(range(0x1100, 0x1200)) + list(range(0xAC00, 0xD7A4)),
        "post15": _post_15(),
        "confusables": _confusables(),
        "edges": [0x10FFFF, 0x110000, 0xFFFFFFFF, 0xD800, 0xDFFF, 0xFFFE, 0xFDD0],
    }
    return groups, sorted({cp for g in groups.values() for cp in g})


GROUPS, CPS = _codepoints()
assert 1000 < len(GROUPS["post15"]) < 20_000 and len(GROUPS["confusables"]) == 6565


def _strings():
    """NFC_SAMPLES, texts of the sample's codepoints (surrogates left out,
    as a str with one cannot be encoded), Hangul and jamo runs, confusable
    spoofs and segmentation cases."""
    rng = np.random.default_rng(1)
    pool = np.array([cp for cp in CPS if cp < 0x110000 and not 0xD800 <= cp <= 0xDFFF])
    out = list(NFC_SAMPLES) + ["", "a", "Hello. World! ok?", "don't 12.5 stop. Mr. Smith went.",
                               "ﬁle ﬂow ﬀ", "ＡＢＣ１２３", "①②③ ㊤ ㎒", "ﷺ", "ΣΑΣ ß İı", "pаypal", "日本語ひらがな漢字",
                               "\r\n\n\t x", "🇺🇸🇫🇷🇩", "👨\u200d👩\u200d👧", "e\u0301\u0327", "1,234.5 a.b",
                               "\u1100\u1161\u11a8 \uac00\u11a8 \u1100\uac00", "\u0041\u030a\u212b"]
    for k in range(120):
        out.append("".join(chr(int(c)) for c in rng.choice(pool, size=int(rng.integers(1, 14)))))
    for k in range(40):  # jamo sequences and syllables, composing and not
        cps = rng.choice(GROUPS["hangul"], size=int(rng.integers(1, 8)))
        out.append("".join(chr(int(c)) for c in cps) + " x")
    conf = GROUPS["confusables"]
    for k in range(40):
        out.append("".join(chr(int(c)) for c in rng.choice(conf, size=int(rng.integers(1, 6)))))
    return out


STRS = _strings()
INVALID = [b"ok \xff\xfe bytes", b"\xc3", b"abc \xe2\x82 def", b"\x80\x80 x", b"caf\xc3\xa9 \xf0\x9f\x99",
           b"\xed\xa0\x80", b"\xf4\x90\x80\x80", b"\xc0\xaf", b"\xef\xbf\xbe"]
BYTES = [s.encode() for s in STRS] + INVALID
UNITS = ([np.frombuffer(s.encode("utf-16-le"), np.uint16) for s in STRS[:60]]
         + [np.array(u, np.uint16) for u in ([0xD800], [0xDC00, 0x41], [0x41, 0xD83D], [0xD83D, 0xDE42], [])])
CP_ARRAYS = ([np.array([ord(c) for c in s], np.uint32) for s in STRS[:80]]
             + [np.array(a, np.uint32) for a in ([0xD800, 0x41], [0x110000], [0x41, 0xFFFE, 0xFDD0], [])])


def _pairs():
    rng = np.random.default_rng(2)
    out = []
    for cp in CPS[::7]:  # canonical pairs that compose, and their swaps
        d = unicodedata.decomposition(chr(cp)) if cp < 0x110000 else ""
        parts = d.split()
        if len(parts) == 2 and not parts[0].startswith("<"):
            a, b = (int(p, 16) for p in parts)
            out += [(a, b), (b, a)]
    conf = GROUPS["confusables"]
    out += [(int(a), int(b)) for a, b in rng.choice(conf, size=(300, 2))]
    out += [(c, c) for c in conf[:50]] + [(0x6F, 0x3BF), (0x61, 0x430), (0x1100, 0x1161), (0xAC00, 0x11A8)]
    out += [(int(a), int(b)) for a, b in rng.integers(0, 0x110000, size=(200, 2))]
    return out


PAIRS = _pairs()

# the argument kind of every public method of the JAX backends
KIND = {
    **dict.fromkeys(
        "case_fold case_fold_full combining_class confusable_proto_len decompose decompose_full get_block "
        "get_block_name get_category get_digit_value get_name get_numeric_value get_script "
        "has_confusable_mapping is_alphabetic is_alphanumeric is_assigned is_combining is_control is_digit "
        "is_format is_identifier_continue is_identifier_start is_letter is_lowercase is_mark is_noncharacter "
        "is_number is_numeric is_pattern_syntax is_pattern_whitespace is_private_use is_punctuation "
        "is_separator is_surrogate is_symbol is_titlecase is_uppercase is_valid is_whitespace "
        "is_xid_continue is_xid_start to_lower to_lower_full to_title to_title_full to_upper "
        "to_upper_full".split(), "cp"),
    **dict.fromkeys(["compose", "is_confusable"], "cp_pair"),
    "is_in_block": "cp_block",
    **dict.fromkeys(["get_script_name", "get_block_id_name"], "id"),
    **dict.fromkeys(
        "char_count count_graphemes count_sentences count_words get_skeleton is_mixed_script is_suspicious "
        "is_well_formed_codepoints sanitize_codepoints string_case_fold string_to_lower string_to_title "
        "string_to_upper to_codepoints".split(), "str"),
    **dict.fromkeys(["normalize", "is_normalized", "quick_check"], "str_form"),
    "normalize_bytes": "bytes_form",
    "normalize_codepoints": "cps_form",
    **dict.fromkeys(
        "is_grapheme_boundary is_word_boundary is_sentence_boundary next_grapheme next_word "
        "next_sentence".split(), "str_pos"),
    **dict.fromkeys(["case_compare", "check_confusables", "check_confusables_widened"], "str_pair"),
    "from_name": "name",
    **dict.fromkeys(
        "classify_bytes is_valid_utf8 is_well_formed sanitize utf8_to_utf16 utf8_codepoint_count "
        "pretokenize_prepare".split(), "bytes"),
    **dict.fromkeys(["is_valid_utf16", "utf16_to_utf32", "utf16_to_utf8"], "units"),
    **dict.fromkeys(["utf32_to_utf16", "utf32_to_utf8", "classify_codepoints"], "cps"),
    "utf8_length": "utf8_length",
    "find_word_boundaries": "cps_classes",
    "byte_word_starts": "scatter",
    **dict.fromkeys(["name", "unicode_version", "ref_hangul"], "attribute"),
    "set_ref_hangul": "hangul",  # test_ref_hangul_normalize
}


def _args(kind: str, native: bool):
    if kind == "cp":
        return [(cp,) for cp in CPS]
    if kind == "cp_pair":
        return PAIRS
    if kind == "cp_block":
        get_block = jax_native().get_block
        return [(cp, get_block(cp)) for cp in CPS[::5]] + [(cp, 7) for cp in CPS[::11]]
    if kind == "id":
        return [(i,) for i in range(-2, 420)]
    if kind == "str":
        return [(s,) for s in STRS] + ([([0x41, 0xD800],), ([0x110000],), ([0x61, 0x62],)] if native else [])
    if kind == "str_form":
        return [(s, f) for s in STRS for f in FORMS]
    if kind == "bytes_form":
        return [(b, f) for b in BYTES for f in FORMS] + [(b"\xef\xb7\xba" * 700, "NFKD")]
    if kind == "cps_form":
        return [(a, f) for a in CP_ARRAYS for f in FORMS] + [(np.full(500, 0xFDFA, np.uint32), "NFKC")]
    if kind == "str_pos":
        return [(s, p) for s in STRS[::3] for p in range(-1, len(s) + 2)]
    if kind == "str_pair":
        rs = np.random.default_rng(3)
        idx = rs.integers(0, len(STRS), size=(150, 2))
        return ([(STRS[i], STRS[j]) for i, j in idx] + [(s, s.upper()) for s in STRS[:40]]
                + [("paypal", "pаypal"), ("ﬁle", "file"), ("rn", "m"), ("Straße", "STRASSE"), ("", "")])
    if kind == "name":
        return [(unicodedata.name(chr(cp), "NO SUCH NAME"),) for cp in CPS[::9] if cp < 0x110000] + [
            ("latin small letter a",), ("HANGUL SYLLABLE GA",), ("CJK UNIFIED IDEOGRAPH-4E00",), ("",)]
    if kind == "bytes":
        return [(b,) for b in BYTES]
    if kind == "units":
        return [(u,) for u in UNITS]
    if kind == "cps":
        return [(a,) for a in CP_ARRAYS] + ([(np.arange(0x110000, dtype=np.uint32),)] if native else [])
    if kind == "utf8_length":  # the native method takes codepoints, the Python one a str
        return [(a,) for a in CP_ARRAYS] if native else [(s,) for s in STRS]
    if kind == "cps_classes":
        return [(a, PyUnicodeBackend().classify_codepoints(a)) for a in CP_ARRAYS]
    if kind == "scatter":
        rs = np.random.default_rng(4)
        return [(np.sort(rs.integers(0, 300, n)).astype(np.uint32), (rs.random(n) < 0.3).astype(np.uint8), m)
                for n, m in ((0, 5), (10, 0), (50, 200), (200, 300), (400, 250))]
    raise KeyError(kind)


def _val(x):
    """A comparable form of a result: its type with its value; arrays with
    their dtype; NaN as a tag."""
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.tolist())
    if isinstance(x, (tuple, list)):
        return (type(x).__name__, tuple(_val(v) for v in x))
    if isinstance(x, float) and math.isnan(x):
        return ("float", "nan")
    return (type(x).__name__, x)


def _outcome(fn, args):
    try:
        return _val(fn(*args))
    except Exception as e:  # noqa: BLE001 (the exception type is the result)
        return ("raises", type(e).__name__)


@pytest.fixture(scope="module")
def backends():
    return {"native": (CppUnicodeBackend(), jax_native()), "python": (PyUnicodeBackend(), JaxPy())}


def test_jax_native_backend_is_a_private_copy(backends):
    """The JAX native backend the tests compare with is loaded from this
    process's own build, never from the JAX package's tree, where other
    test processes may be rebuilding ``libdecoder.so`` in place."""
    jax_tree = Path(gpu_bpe_tpu.__file__).resolve().parent
    for lib in (backends["native"][1]._lib, jax_native()._lib):
        path = Path(lib._name).resolve()
        assert path == jax_native_library().resolve() and path.exists()
        assert not path.is_relative_to(jax_tree), path


JAX_METHODS = sorted(n for n in dir(JaxCpp) if not n.startswith("_"))


def test_every_jax_method_has_a_counterpart():
    """The JAX backends' public names are a subset of the port's, with
    the same parameters, and every one is exercised below."""
    for jax_cls, port_cls in ((JaxCpp, CppUnicodeBackend), (JaxPy, PyUnicodeBackend)):
        names = {n for n in dir(jax_cls) if not n.startswith("_")}
        assert names <= {n for n in dir(port_cls) if not n.startswith("_")}
        for n in names:
            j, p = getattr(jax_cls, n), getattr(port_cls, n)
            if callable(j):
                assert list(inspect.signature(j).parameters) == list(inspect.signature(p).parameters), n
    assert set(JAX_METHODS) == set(KIND)
    assert len(JAX_METHODS) > 95
    held = {n for b, k in CASES for n in _checked(b, k)} | {n for n in KIND if KIND[n] in ("attribute", "hangul")}
    assert held == set(JAX_METHODS), set(JAX_METHODS) - held


def _results(fn, args, block: int = 512):
    """The result of every call: plain calls a block at a time, and each
    call's ``_outcome`` in a block where one raises."""
    out = []
    for i in range(0, len(args), block):
        part = args[i : i + block]
        try:
            out += itertools.starmap(fn, part)
        except Exception:  # noqa: BLE001 (some input raises: compare each outcome)
            out += [_Raised(_outcome(fn, a)) for a in part]
    return out


class _Raised(tuple):
    """An ``_outcome`` among plain results."""


def _first_difference(got: list, want: list):
    """Index of the first result that differs in type or value, or None."""
    try:
        if got == want and list(map(type, got)) == list(map(type, want)):
            return None
    except ValueError:  # arrays among the results: compare their _val forms
        pass
    forms = [[r if isinstance(r, _Raised) else _val(r) for r in rs] for rs in (got, want)]
    return next((i for i, (g, w) in enumerate(zip(*forms)) if g != w), None)


def _consumed(backend, name: str):
    """The method, its array results copied as they come: the port's
    ``pretokenize_prepare`` returns views of a scratch that its next call
    overwrites, which its callers consume first."""
    fn = getattr(backend, name)
    if name != "pretokenize_prepare":
        return fn
    return lambda *a: tuple(x.copy() if isinstance(x, np.ndarray) else x for x in fn(*a))


def _own(cls, name: str) -> bool:
    """Whether a native backend class defines ``name`` itself (else it
    runs the Python backend's code, which the python cases hold)."""
    return any(name in vars(k) for k in cls.__mro__ if k.__name__ == "CppUnicodeBackend")


def _checked(backend: str, kind: str) -> list[str]:
    """The methods of an argument kind that a backend's case holds: all of
    the JAX Python backend's, and those a native backend defines itself."""
    if backend == "python":
        return [n for n in JAX_METHODS if KIND[n] == kind and hasattr(JaxPy, n)]
    return [n for n in JAX_METHODS if KIND[n] == kind and (_own(JaxCpp, n) or _own(CppUnicodeBackend, n))]


CASES = [(b, k) for b in ("native", "python") for k in sorted(set(KIND.values()) - {"attribute", "hangul"})
         if _checked(b, k)]


@pytest.mark.parametrize("backend,method", CASES)
def test_methods_equal_jax(backends, backend, method):
    """One case per argument kind: each method of that kind gives the JAX
    package's result on every input. A native backend's method that is the
    Python backend's is held in the python case."""
    port, ref = backends[backend]
    args = _args(method, backend == "native")
    for name in _checked(backend, method):
        got, want = _results(_consumed(port, name), args), _results(_consumed(ref, name), args)
        bad = _first_difference(got, want)
        assert bad is None, (name, args[bad], got[bad], want[bad])


def test_pretokenize_prepare_copies_unless_reused(backends):
    """``reuse=False`` gives arrays that the next call leaves alone, equal
    to the JAX package's (whose default it is)."""
    port, ref = backends["native"]
    for data in BYTES[:40]:
        got = port.pretokenize_prepare(data, reuse=False)
        port.pretokenize_prepare("later call".encode())
        assert _val(got) == _val(ref.pretokenize_prepare(data)), data


@pytest.mark.parametrize("backend", ["native", "python"])
def test_attributes_equal_jax(backends, backend):
    port, ref = backends[backend]
    for name in ("name", "unicode_version", "ref_hangul"):
        assert _val(getattr(port, name)) == _val(getattr(ref, name)), name


# exports of one codepoint that no method of either backend calls
UNREACHED = {f"decoder_{n}" for n in (
    "get_category is_alphanumeric is_assigned is_control is_format is_lowercase is_noncharacter "
    "is_private_use is_separator is_surrogate is_titlecase is_uppercase").split()}


def test_exports_bound_as_jax_binds_them(backends):
    """All 97 exports the JAX binding declares, with its argument and result
    types (a narrower ``restype`` would truncate silently), and each scalar
    export that no method reaches called directly on both libraries over
    every codepoint input (the methods hold the others)."""
    port_lib, jax_lib = backends["native"][0]._lib, backends["native"][1]._lib
    names = sorted(n for n in dir(jax_lib) if n.startswith("decoder_"))
    assert len(names) == 97, names
    for n in names:
        pf, jf = getattr(port_lib, n), getattr(jax_lib, n)
        assert pf.restype == jf.restype and list(pf.argtypes or []) == list(jf.argtypes or []), n
        args = list(jf.argtypes or [])
        if args == [ctypes.c_uint32] and n in UNREACHED:
            for cp in CPS:
                assert pf(cp) == jf(cp), (n, cp)
        elif args == [ctypes.c_uint32, ctypes.c_uint32]:
            for a, b in PAIRS:
                assert pf(a, b) == jf(a, b), (n, a, b)
        elif args == [ctypes.c_uint32, ctypes.c_int]:
            for cp in CPS[::13]:
                for blk in (0, 1, 7, 300, jax_lib.decoder_get_block(cp)):
                    assert pf(cp, blk) == jf(cp, blk), (n, cp, blk)
        elif args == [ctypes.c_int] and pf.restype is ctypes.c_char_p:
            for i in range(-2, 420):
                assert pf(i) == jf(i), (n, i)
    assert port_lib.decoder_init() == jax_lib.decoder_init() == 0
    assert port_lib.decoder_get_unicode_version() == jax_lib.decoder_get_unicode_version()
    # the exports no method reaches, over UTF-8 and codepoint buffers
    u32p = ctypes.POINTER(ctypes.c_uint32)
    for data in BYTES + [("한국어 " * 30000).encode()]:  # lengths past 2^16 and 2^17
        for lib_pair in ((port_lib, jax_lib),):
            got = [lib.decoder_utf8_char_count(data, len(data)) for lib in lib_pair]
            assert got[0] == got[1] == (len(data.decode()) if _ok(data) else got[1]), data[:20]
            outs = [np.zeros(len(data) + 1, np.uint32) for _ in lib_pair]
            ns = [lib.decoder_utf8_to_utf32(data, len(data), o.ctypes.data_as(u32p), len(o))
                  for lib, o in zip(lib_pair, outs)]
            assert ns[0] == ns[1] and np.array_equal(outs[0][: max(ns[0], 0)], outs[1][: max(ns[1], 0)])
            for form in range(4):
                assert (port_lib.decoder_is_normalized_utf8(data, len(data), form)
                        == jax_lib.decoder_is_normalized_utf8(data, len(data), form))
    for a in CP_ARRAYS:
        p = a.ctypes.data_as(u32p) if len(a) else None
        for form in range(4):
            assert port_lib.decoder_is_normalized(p, len(a), form) == jax_lib.decoder_is_normalized(p, len(a), form)


@pytest.mark.parametrize("regex", ["present", "hidden"])
def test_selftest_holds_every_export(monkeypatch, regex):
    """``unicode.selftest`` (``chip_smoke.py`` phase 20) holds each of the 97
    exports to the Python backend, with or without the optional ``regex``
    module, and a wrong answer of the Python backend fails exactly the
    exports held to it."""
    from gpu_bpe_tpu_torch.unicode.selftest import run_unicode_selftest

    if regex == "hidden":
        monkeypatch.setitem(sys.modules, "regex", None)
    held = run_unicode_selftest()
    assert len(held) == 97 and [n for n, ok in held.items() if not ok] == []

    class Wrong(PyUnicodeBackend):
        def is_letter(self, cp):
            return False

        def get_skeleton(self, s):
            return s

    held = run_unicode_selftest(fallback=Wrong())
    assert [n for n, ok in held.items() if not ok] == [
        "decoder_check_confusables_widened", "decoder_get_skeleton", "decoder_is_alphanumeric", "decoder_is_letter"]


def _ok(data: bytes) -> bool:
    try:
        data.decode()
        return True
    except UnicodeDecodeError:
        return False


def test_batch_calls_over_every_codepoint(backends):
    """classify_codepoints and the categories over all 0x110000 codepoints,
    and the native category export beside them."""
    every = np.arange(0x110000, dtype=np.uint32)
    want = JaxPy().classify_codepoints(every)
    for port, ref in backends.values():
        np.testing.assert_array_equal(port.classify_codepoints(every), ref.classify_codepoints(every))
        np.testing.assert_array_equal(port.classify_codepoints(every), want)
    np.testing.assert_array_equal(tun.class_table(), jun.class_table())
    port, ref = PyUnicodeBackend(), JaxPy()
    assert [port.get_category(cp) for cp in range(0x110000)] == [ref.get_category(cp) for cp in range(0x110000)]
    lib = backends["native"][0]._lib
    ids = np.array([lib.decoder_get_category(cp) for cp in range(0x110000)], np.uint8)
    np.testing.assert_array_equal(ids, _category_ids())
    assert enums.CATEGORIES[ids[0x41]] == "Lu"


# ─────────────────────────── segmentation, enums, utf8 ───────────────────────────


@pytest.mark.parametrize("regex", ["present", "hidden"])
def test_segmentation_equal_jax(monkeypatch, regex):
    if regex == "hidden":
        monkeypatch.setitem(sys.modules, "regex", None)
        with pytest.raises(ImportError):
            import regex as _  # noqa: F401
    else:
        import regex as _  # noqa: F401
    for s in STRS:
        for name in ("count_graphemes", "count_words", "count_sentences"):
            assert getattr(segmentation, name)(s) == getattr(jseg, name)(s), (name, s)
        py = PyUnicodeBackend()
        assert py.count_words(s) == JaxPy().count_words(s)
    if regex == "present":
        for s in STRS:
            assert segmentation.count_words_exact(s) == jseg.count_words_exact(s)
            assert segmentation.count_sentences_exact(s) == jseg.count_sentences_exact(s)
            cps = [ord(c) for c in s]
            wb, sb = [segmentation._wb_of(c) for c in cps], [segmentation._sb_of(c) for c in cps]
            assert wb == [jseg._wb_of(c) for c in cps] and sb == [jseg._sb_of(c) for c in cps]
            for pos in range(1, len(cps)):
                assert segmentation.word_boundary(cps, wb, len(cps), pos) == jseg.word_boundary(cps, wb, len(cps), pos)
                assert segmentation.sentence_boundary(sb, len(cps), pos) == jseg.sentence_boundary(sb, len(cps), pos)
        # with regex the Python counts equal the native engine's
        native = CppUnicodeBackend()
        for s in STRS[:60]:
            for name in ("count_graphemes", "count_words", "count_sentences"):
                assert getattr(segmentation, name)(s) == getattr(native, name)(s), (name, s)


def test_data_files_equal_jax():
    """The port's copies of the confusable and suspicious-range data: every
    field equal to the JAX package's, the confusables' ``source`` note
    aside (it names where the data was extracted)."""
    import json

    port_dir = REPO / "gpu_bpe_tpu_torch" / "unicode" / "data"
    jax_dir = REPO / "gpu_bpe_tpu" / "unicode" / "data"
    for name in ("ref_confusables.json", "ref_suspicious_extra.json", "ref_properties.json"):
        port, ref = (json.loads((d / name).read_text(encoding="utf-8")) for d in (port_dir, jax_dir))
        assert set(port) == set(ref), name
        assert all(port[k] == ref[k] for k in ref if k != "source"), name
    assert (port_dir / "ref_suspicious_extra.json").read_bytes() == (jax_dir / "ref_suspicious_extra.json").read_bytes()


def test_enums_and_utf8_equal_jax():
    for port, ref in ((enums.Status, jenums.Status), (enums.NormalizationForm, jenums.NormalizationForm),
                      (enums.Script, jenums.Script)):
        assert [(m.name, int(m)) for m in port] == [(m.name, int(m)) for m in ref]
    assert enums.CATEGORIES == jenums.CATEGORIES and len(enums.Script) == 179
    assert enums.REFERENCE_SCRIPTS == list(jenums.REFERENCE_SCRIPTS)
    assert [utf8.utf8_byte_length(cp) for cp in CPS] == [jutf8.utf8_byte_length(cp) for cp in CPS]
    np.testing.assert_array_equal(utf8.utf8_byte_lengths(np.array(CPS)), jutf8.utf8_byte_lengths(np.array(CPS)))
    for a in CP_ARRAYS:
        assert _outcome(utf8.codepoints_to_utf8, (a,)) == _outcome(jutf8.codepoints_to_utf8, (a,))
    for b in BYTES:
        np.testing.assert_array_equal(utf8.utf8_to_codepoints(b), jutf8.utf8_to_codepoints(b))


def test_package_exports():
    for jax_mod, port_mod in ((jseg, segmentation), (jenums, enums), (jutf8, utf8), (jun, tun)):
        public = {n for n in dir(jax_mod) if not n.startswith("_") and not inspect.ismodule(getattr(jax_mod, n))}
        assert public <= set(dir(port_mod)), (port_mod.__name__, public - set(dir(port_mod)))
    assert set(jun.__all__) | {"backend_name"} == set(tun.__all__)
    for name in jun.__all__:
        assert getattr(tun, name) is not None
    assert set(gpu_bpe_tpu.__all__) <= set(gpu_bpe_tpu_torch.__all__)
    for name in gpu_bpe_tpu.__all__:
        got, want = getattr(gpu_bpe_tpu_torch, name), getattr(gpu_bpe_tpu, name)
        assert type(got) is type(want) or callable(got), name
        if not callable(want):
            assert got == want, name
    from gpu_bpe_tpu_torch import ops

    assert {"apply_merge_device", "find_best_pair"} <= set(ops.__all__)


# ─────────────────────────── the reference-compat Hangul mode ───────────────────────────

HANGUL_TEXTS = ["\u1100\u1161\u11a8", "\uac01", "\u1100\u1161 \u1100\u1161\u11a8 x\u0301 \uac00\u11a8",
                "한국어 조합 각", "Cafe\u0301 \u1112\u1161\u11ab\u1100\u116e\u11a8", "\u3131\u314f ㄱ"] + STRS[-80:-40]


@pytest.mark.parametrize("backend", ["native", "python"])
def test_ref_hangul_normalize(backends, backend):
    """normalize and normalize_bytes in both modes, port against JAX; the
    mode leaves syllables and jamo alone."""
    port, ref = backends[backend]
    outs = {}
    try:
        for on in (False, True):
            port.set_ref_hangul(on)
            ref.set_ref_hangul(on)
            assert port.ref_hangul is on and ref.ref_hangul is on
            for s in HANGUL_TEXTS:
                for form in ("NFC", "NFD", "NFKC", "NFKD"):
                    got = port.normalize(s, form)
                    assert got == ref.normalize(s, form), (on, s, form)
                    assert port.normalize_bytes(s.encode(), form) == ref.normalize_bytes(s.encode(), form)
                    outs[on, s, form] = got
            for b in INVALID:
                assert _outcome(port.normalize_bytes, (b,)) == _outcome(ref.normalize_bytes, (b,))
    finally:
        port.set_ref_hangul(False)
        ref.set_ref_hangul(False)
    assert outs[True, "\u1100\u1161\u11a8", "NFC"] == "\u1100\u1161\u11a8"
    assert outs[False, "\u1100\u1161\u11a8", "NFC"] == "\uac01"
    assert outs[True, "\uac01", "NFD"] == "\uac01" and outs[False, "\uac01", "NFD"] == "\u1100\u1161\u11a8"


def test_ref_hangul_flags_are_apart(backends):
    """Each library has its own flag: setting one leaves the other."""
    port, ref = backends["native"]
    try:
        port.set_ref_hangul(True)
        assert port.ref_hangul and not ref.ref_hangul
        assert CppUnicodeBackend().ref_hangul  # one library, one flag in this process
        port.set_ref_hangul(False)
        ref.set_ref_hangul(True)
        assert ref.ref_hangul and not port.ref_hangul
    finally:
        port.set_ref_hangul(False)
        ref.set_ref_hangul(False)


def test_ref_hangul_environment_variable():
    """GPU_BPE_TPU_REF_HANGUL set before the backend is created turns the
    mode on in both of the port's backends, and in the pre-tokenizer."""
    code = (
        "from gpu_bpe_tpu_torch.unicode import get_backend, PyUnicodeBackend\n"
        "from gpu_bpe_tpu_torch.pretok import PreTokenizer\n"
        "b = get_backend()\n"
        "assert b.name == 'cpp-decoder' and b.ref_hangul, b.name\n"
        "s = '\\u1100\\u1161\\u11a8 \\uac00'\n"
        "assert b.normalize(s) == s and PyUnicodeBackend().normalize(s) == s\n"
        "assert PreTokenizer().pre_tokenize_bytes(s.encode())[0] == s.encode()\n"
        "print('ok')\n"
    )
    env = {**os.environ, "GPU_BPE_TPU_REF_HANGUL": "1"}
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0 and p.stdout.strip() == "ok", p.stdout + p.stderr


def test_ref_hangul_training_equals_jax(tmp_path, monkeypatch):
    """api.train(device="cpu") on a 1 MB cut of the decomposed-jamo corpus
    equals JAX api.train in each mode, and so does api.train_files on the
    cut in four chunks; the two modes differ."""
    from chip_smoke import synth_hangul_corpus

    from gpu_bpe_tpu import api as japi
    from gpu_bpe_tpu_torch import api

    corpus = synth_hangul_corpus(1 << 20, seed=0)
    port, ref = tun.get_backend(), jax_native()
    monkeypatch.setattr(jun, "_BACKEND", ref)  # what JAX api.train's pre-tokenizer takes
    lists = {}
    try:
        for on in (False, True):
            port.set_ref_hangul(on)
            ref.set_ref_hangul(on)
            _, got = api.train(corpus, api.TrainConfig(vocab_size=256 + 64, device="cpu", show_progress=False))
            _, want = japi.train(corpus, japi.TrainConfig(vocab_size=256 + 64, backend="cpu", show_progress=False))
            assert got.merges == want.merges and got.merge_counts == want.merge_counts, on
            # the streamed entry point takes the mode too, chunk by chunk
            path = tmp_path / "cut.txt"
            path.write_bytes(corpus)
            _, streamed = api.train_files([str(path)], api.TrainConfig(vocab_size=256 + 64, device="cpu",
                                                                       show_progress=False), chunk_bytes=1 << 18)
            assert streamed.merges == got.merges and streamed.merge_counts == got.merge_counts
            lists[on] = got.merges
    finally:
        port.set_ref_hangul(False)
        ref.set_ref_hangul(False)
    assert lists[False] != lists[True]
    assert lists[True][0] == (225, 132, 256)  # a jamo's lead bytes, which NFC would have composed away


# ─────────────────────────── ops and model surface ───────────────────────────


def _stream(rng, n, cap, alphabet):
    toks = rng.integers(1, alphabet, size=n).astype(np.uint32)
    ws = rng.random(n) < 0.15
    sym = np.zeros(cap, np.uint32)
    sym[:n] = toks | (ws.astype(np.uint32) << 16)
    sym[0] |= 1 << 16
    w = np.zeros(cap, np.int32)
    w[:n] = rng.integers(1, 9, size=n)
    return sym, w


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_merge_and_find_best_pair_equal_jax(seed):
    import jax.numpy as jnp

    from gpu_bpe_tpu.ops import apply_merge_device as jax_apply
    from gpu_bpe_tpu.ops import find_best_pair as jax_best
    from gpu_bpe_tpu_torch.ops import apply_merge_device, find_best_pair

    rng = np.random.default_rng(seed)
    cap = 4096
    n = int(rng.integers(3000, cap))
    sym, w = _stream(rng, n, cap, alphabet=(3, 6, 40)[seed])
    for step in range(6):
        pair, count = find_best_pair(torch.from_numpy(sym.view(np.int32)), torch.from_numpy(w), n)
        jp, jc = jax_best(jnp.asarray(sym), jnp.asarray(w), jnp.int32(n))
        assert (int(pair), int(count)) == (int(jp), int(jc)), step
        new_id = 256 + step
        s2, w2, n2 = apply_merge_device(torch.from_numpy(sym.view(np.int32)), torch.from_numpy(w), n, int(pair), new_id)
        js, jw, jn = jax_apply(jnp.asarray(sym), jnp.asarray(w), jnp.int32(n), jnp.uint32(int(jp)), jnp.uint32(new_id))
        np.testing.assert_array_equal(s2.numpy().view(np.uint32), np.asarray(js))
        np.testing.assert_array_equal(w2.numpy(), np.asarray(jw))
        assert int(n2) == int(jn)
        sym, w, n = s2.numpy().view(np.uint32).copy(), w2.numpy().copy(), int(n2)
    # no live pair: pair 0, count 0
    empty = find_best_pair(torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=torch.int32), 0)
    assert (int(empty[0]), int(empty[1])) == (0, 0)


def test_compression_ratio_and_from_vocab_obj():
    from gpu_bpe_tpu.core import BPEModel as JaxModel
    from gpu_bpe_tpu.core import Vocab as JaxVocab
    from gpu_bpe_tpu.models import BPETokenizer as JaxTok
    from gpu_bpe_tpu_torch.core import BPEModel, Vocab
    from gpu_bpe_tpu_torch.models import BPETokenizer

    merges = [(104, 101, 256), (256, 108, 257)]
    vocab, jvocab = Vocab(), JaxVocab()
    for v in (vocab, jvocab):
        v.add_merge(104, 101)
        v.add_merge(256, 108)
    model, jmodel = BPEModel.from_vocab_obj(vocab, merges), JaxModel.from_vocab_obj(jvocab, merges)
    assert model.to_json() == jmodel.to_json()
    tok = BPETokenizer(model, backend="cpu")
    jtok = JaxTok(jmodel, backend="cpu")
    for data, tokens in ((b"hello", [257, 108, 111]), (b"", []), (b"abc", [97])):
        assert tok.compression_ratio(data, tokens) == jtok.compression_ratio(data, tokens)
