"""Self-check of the native Unicode library: every export bound by
``cpp_backend._load`` called on a fixed sample and held against the Python
backend (or, for the few exports the Python backend lacks, against
CPython's own Unicode data) on the host the library was built on.

    python -m gpu_bpe_tpu_torch.unicode.selftest

The sample is Unicode 15.0 text (the version of CPython's ``unicodedata``
that the Python backend reads), where the two backends agree: ASCII,
Latin-1 and Latin Extended-A, combining marks, Greek, Cyrillic, jamo,
Hangul syllables, general punctuation, kana, CJK, ligatures, fullwidth
forms and a few astral characters, and strings of them. Where the Python
backend's rule is a simplification (its boundary and quick-check rules,
its UTF-8 repair), the sample is the inputs on which the simplification is
exact. ``run_unicode_selftest`` returns ``{export: held}`` for every bound
export and raises if a bound export was never called.
"""

from __future__ import annotations

import string
import unicodedata

import numpy as np

from .enums import CATEGORIES
from .fallback import PyUnicodeBackend

SAMPLE_CPS = (
    list(range(0x80)) + list(range(0xA0, 0x180)) + list(range(0x300, 0x370)) + list(range(0x391, 0x3CA))
    + list(range(0x410, 0x450)) + list(range(0x1100, 0x1113)) + list(range(0x1161, 0x1176))
    + list(range(0x11A8, 0x11C3)) + list(range(0x2000, 0x2070)) + list(range(0x3041, 0x3061))
    + list(range(0x4E00, 0x4E20)) + list(range(0xAC00, 0xAC20)) + list(range(0xFB00, 0xFB07))
    + list(range(0xFF01, 0xFF21)) + [0xD800, 0xFDD0, 0xFFFE, 0xE000, 0x1F600, 0x1F1E6, 0x10400, 0x20000]
)
SAMPLE_TEXTS = (
    "hello world", "étude déjà-vu naïve", "étude", "ä́", "q̣̇", "한국어 조합",
    "각", "北京 москва الشرق", "🙂👨\u200d👩\u200d👧", "ﬁle ﬂow", "①② ㎒", "ﷺ", "ＡＢＣ１２３",
    "Å", "ΣΑΣ", "pаypal", "paypal", "Ρ", "日本語ひらがな", "abc", "ABD", "",
)
# texts on which both backends' normalization checks answer alike (the
# native ones keep the reference's quick-check and Hangul answers)
NORM_TEXTS = ("hello world", "abc", "北京 москва الشرق", "e\u0301", "\u00c5", "\u212b", "\ufb01le",
              "a\u0323\u0307", "\uff21\uff11")
QUICK_CHECK_TEXTS = ("hello world", "abc", "北京 москва الشرق", "e\u0301")
# texts on which the Python backend's counters (with or without the regex
# module) and simplified boundary rules give the UAX #29 answer
COUNT_TEXTS = ("hello world", "한국어 조합", "one two three", "Stop. Go on!")
BOUNDARY_CASES = {
    "grapheme": ("hello world", "a\r\nb", "éx", "한국어 조합", "one two three"),
    "word": ("hello world", "one two three", "한국어 조합", "a\r\nb"),
    "sentence": ("hello world", "one two three", "한국어 조합", "Stop!Go"),
}
# UTF-8 whose repair is the same byte by byte and by maximal subpart
REPAIRABLE = (b"ok \xff\xfe bytes", b"\xc3", b"\x80\x80 x", b"\xed\xa0\x80", "naïve".encode())
# ASCII and Latin-1 members of Pattern_Syntax (UAX #31), and Pattern_White_Space
PATTERN_SYNTAX = (set(map(ord, string.punctuation)) - {0x5F}) | {
    0xA1, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA9, 0xAB, 0xAC, 0xAE, 0xB0, 0xB1, 0xB6, 0xBB, 0xBF, 0xD7, 0xF7}
PATTERN_WS = {0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0x200E, 0x200F, 0x2028, 0x2029}
# exports of one codepoint -> the Python backend's method that answers the same
PREDICATES = (
    "letter mark digit number punctuation symbol separator control format uppercase lowercase titlecase "
    "whitespace alphanumeric valid assigned surrogate noncharacter private_use combining numeric "
    "identifier_start identifier_continue"
).split()


class _Recorder:
    """The library, noting the name of every export looked up on it."""

    def __init__(self, lib):
        self._real = lib
        self.called: set[str] = set()

    def __getattr__(self, name):
        if name.startswith("decoder_"):
            self.called.add(name)
        return getattr(self._real, name)


def _canonical(decomposition: str) -> list[int]:
    """A ``unicodedata.decomposition`` string as codepoints, [] for none or a
    compatibility one."""
    if not decomposition or decomposition.startswith("<"):
        return []
    return [int(h, 16) for h in decomposition.split()]


def _mixed_script(py: PyUnicodeBackend, text: str) -> bool:
    """UTS #39-style mixed script over the Python backend's script ids:
    Common, Inherited and Unknown aside, Han joins Hiragana, Katakana,
    Hangul and Bopomofo."""
    cjk = {26, 34, 35, 36, 37}
    base = 0
    for ch in text:
        s = py.get_script(ord(ch))
        if s <= 2:
            continue
        if base == 0:
            base = 37 if s in cjk else s
        elif not (s in cjk and base == 37) and s != base:
            return True
    return False


def _equal(a, b) -> bool:
    return np.array_equal(a, b) if isinstance(a, np.ndarray) or isinstance(b, np.ndarray) else a == b


def run_unicode_selftest(native=None, fallback: PyUnicodeBackend | None = None) -> dict[str, bool]:
    """``{export: held}`` for every export the native backend binds. The
    check runs with the Hangul mode off (and both modes in its Hangul part),
    so ``GPU_BPE_TPU_REF_HANGUL``, which the Python backend cannot turn off,
    must be unset."""
    from .cpp_backend import CppUnicodeBackend

    native = native or CppUnicodeBackend()
    py = fallback or PyUnicodeBackend()
    py.set_ref_hangul(False)
    if py.ref_hangul:
        raise ValueError("the Unicode self-check runs with GPU_BPE_TPU_REF_HANGUL unset")
    bound = sorted(n for n in vars(native._lib) if n.startswith("decoder_"))
    lib = _Recorder(native._lib)
    held: dict[str, bool] = {}

    def hold(names: str, ok) -> None:
        for n in names.split():
            held[n] = held.get(n, True) and bool(ok)

    def same(method: str, inputs, export: str | None = None) -> None:
        """Hold ``export`` (``decoder_<method>``) to the two backends'
        ``method`` agreeing on every input (a tuple of arguments or one)."""
        args = [a if isinstance(a, tuple) else (a,) for a in inputs]
        nf, pf = getattr(native, method), getattr(py, method)
        hold(export or f"decoder_{method}", all(_equal(nf(*a), pf(*a)) for a in args))

    real, native._lib = native._lib, lib
    was = native.ref_hangul
    try:
        native.set_ref_hangul(False)
        cps, texts = SAMPLE_CPS, SAMPLE_TEXTS
        hold("decoder_init", lib.decoder_init() == 0)
        hold("decoder_get_unicode_version", native.unicode_version.startswith("17.0"))
        for p in PREDICATES:
            export = getattr(lib, f"decoder_is_{p}")
            hold(f"decoder_is_{p}", all(bool(export(c)) == getattr(py, f"is_{p}")(c) for c in cps))
        same("is_alphabetic", [c for c in cps if c != 0x3A2])
        hold("decoder_get_category", all(CATEGORIES[lib.decoder_get_category(c)] == py.get_category(c) for c in cps))
        same("combining_class", cps, "decoder_get_combining_class")
        for m in ("to_upper", "to_upper_full", "to_lower_full", "to_title_full", "case_fold_full"):
            same(m, cps)
        # the Python backend's simple maps come from the full ones, which
        # differ where a full map is longer than one codepoint
        hold("decoder_to_title", all(lib.decoder_to_title(c) == py.to_title(c) for c in cps
                                     if c < 0xD800 and len(chr(c).title()) == 1))
        for m in ("to_lower", "case_fold"):
            same(m, [c for c in cps if c not in (0x130, 0xFB05)])
        text_cps = [c for c in cps if not 0xD800 <= c <= 0xDFFF]
        hold("decoder_is_xid_start", all(native.is_xid_start(c) == (chr(c).isidentifier() and c != 0x5F)
                                         for c in text_cps))
        hold("decoder_is_xid_continue", all(native.is_xid_continue(c) == ("a" + chr(c)).isidentifier()
                                            for c in text_cps if c not in (0x200C, 0x200D)))
        hold("decoder_is_pattern_syntax", all(native.is_pattern_syntax(c) == (c in PATTERN_SYNTAX)
                                              for c in cps if c < 0x100))
        hold("decoder_is_pattern_whitespace", all(native.is_pattern_whitespace(c) == (c in PATTERN_WS) for c in cps))

        # decomposition and composition
        hold("decoder_decompose", all(native.decompose(c) == _canonical(py.decompose(c)) for c in cps))
        nfd = {c: unicodedata.normalize("NFD", chr(c)) for c in text_cps if not 0xAC00 <= c <= 0xD7A3}
        hold("decoder_decompose_full", all(native.decompose_full(c) == ([ord(x) for x in d] if d != chr(c) else [])
                                           for c, d in nfd.items()))
        pairs = [(c, _canonical(py.decompose(c))) for c in cps]
        composites = [(c, d) for c, d in pairs if len(d) == 2 and unicodedata.normalize("NFC", chr(c)) == chr(c)]
        hold("decoder_compose", composites and all(native.compose(*d) == c for c, d in composites)
             and native.compose(0x41, 0x42) == 0 and native.compose(0x1100, 0x1161) == 0xAC00)

        # scripts, blocks, identifier security
        same("get_script", cps)
        same("get_script_name", range(-1, 181))
        same("get_block_name", cps)
        blocks = {c: native.get_block(c) for c in cps}
        hold("decoder_get_block decoder_get_block_id_name",
             all(native.get_block_id_name(b) == _block_id(py.get_block_name(c)) for c, b in blocks.items()))
        hold("decoder_is_in_block", all(native.is_in_block(c, b) and not native.is_in_block(c, b + 1)
                                        for c, b in blocks.items()))
        same("is_suspicious", texts)
        hold("decoder_is_mixed_script", all(native.is_mixed_script(t) == _mixed_script(py, t) for t in texts))

        # confusables
        same("has_confusable_mapping", cps)
        same("confusable_proto_len", cps)
        same("is_confusable", [(a, b) for a in cps[::7] for b in (0x61, 0x6F, 0x430, 0x43E, 0x3BF, a)])
        for m in ("check_confusables", "check_confusables_widened", "case_compare"):
            same(m, [(a, b) for a in texts for b in texts])
        same("get_skeleton", texts)
        for m in ("string_to_upper", "string_to_lower", "string_to_title"):  # no ligature, no final sigma
            same(m, [t for t in texts if "\ufb01" not in t and "\u03a3" not in t])

        # normalization, in both Hangul modes
        arrays = [np.array([ord(c) for c in t], np.uint32) for t in texts]
        for f, form in enumerate(("NFC", "NFD", "NFKC", "NFKD")):
            same("normalize_bytes", [(t.encode(), form) for t in texts], "decoder_normalize_utf8")
            same("normalize_codepoints", [(a, form) for a in arrays], "decoder_normalize")
            norm = [py.is_normalized(t, form) for t in NORM_TEXTS]
            hold("decoder_is_normalized_utf8", [bool(lib.decoder_is_normalized_utf8(t.encode(), len(t.encode()), f))
                                                for t in NORM_TEXTS] == norm)
            hold("decoder_is_normalized", [bool(lib.decoder_is_normalized(_cps_ptr(t), len(t), f))
                                           for t in NORM_TEXTS] == norm)
            same("quick_check", [(t, form) for t in (NORM_TEXTS if form == "NFC" else QUICK_CHECK_TEXTS)])
        for on in (True, False):
            native.set_ref_hangul(on)
            py.set_ref_hangul(on)
            hold("decoder_set_hangul_inert decoder_get_hangul_inert", native.ref_hangul is on)
            same("normalize", [(t, form) for t in texts for form in ("NFC", "NFD")], "decoder_normalize_utf8")

        # UTF-8, UTF-16, UTF-32
        encoded = [t.encode() for t in texts]
        bad = [b"\xff", b"\xc3", b"a\xe2\x82", b"\xed\xa0\x80", b"\xf4\x90\x80\x80"]
        same("is_valid_utf8", encoded + bad)
        same("is_well_formed", encoded + bad, "decoder_is_well_formed_utf8")
        hold("decoder_utf8_char_count decoder_utf8_length",
             all(lib.decoder_utf8_char_count(b, len(b)) == native.utf8_codepoint_count(b) == len(b.decode())
                 for b in encoded))
        hold("decoder_utf8_encoded_length", all(native.utf8_length(a) == py.utf8_length(t)
                                                for t, a in zip(texts, arrays)))
        out = np.zeros(256, np.uint32)
        hold("decoder_utf8_to_utf32", all(
            lib.decoder_utf8_to_utf32(b, len(b), out.ctypes.data_as(_u32p()), len(out)) == len(a)
            and np.array_equal(out[: len(a)], a) for b, a in zip(encoded, arrays)))
        same("sanitize", encoded + list(REPAIRABLE), "decoder_sanitize_utf8")
        dirty = ["a\ud800b", "\ufdd0x\ufffe", "ok", *texts]
        same("sanitize_codepoints", dirty, "decoder_sanitize")
        same("is_well_formed_codepoints", dirty, "decoder_is_well_formed")
        units = [np.frombuffer(t.encode("utf-16-le"), np.uint16) for t in texts]
        lone = [np.array(u, np.uint16) for u in ([0xD800], [0xDC00, 0x41], [0x41, 0xD83D])]
        same("is_valid_utf16", units + lone)
        same("utf16_to_utf32", units)
        same("utf32_to_utf16", arrays)
        same("utf32_to_utf8", arrays)
        same("utf8_to_utf16", encoded)
        same("utf16_to_utf8", units)

        # classification and the pre-tokenizer's fused path
        same("classify_codepoints", [np.array(cps, np.uint32)], "decoder_classify_utf32")
        hold("decoder_classify_codepoints", all(np.array_equal(native.classify_bytes(b)[0], py.classify_bytes(b)[0])
                                                for b in encoded))
        hold("decoder_pretokenize_prepare decoder_find_word_boundaries decoder_byte_word_starts",
             all(_pretokenize_equal(native, py, b) for b in encoded + ["\n".join(texts).encode()]))

        # segmentation
        for m in ("count_graphemes", "count_words", "count_sentences"):
            same(m, COUNT_TEXTS)
        for kind, texts_k in BOUNDARY_CASES.items():
            for m in (f"is_{kind}_boundary", f"next_{kind}"):
                same(m, [(t, i) for t in texts_k for i in range(len(t))])
    finally:
        native.set_ref_hangul(was)
        native._lib = real
    missing = sorted(set(bound) - lib.called)
    if missing or not bound:
        raise AssertionError(f"bound exports the self-check never called: {missing}")
    return {n: held.get(n, False) for n in bound}


def _block_id(name: str) -> str:
    """A block's display name as the native id name spells it
    ("Latin-1 Supplement" -> "LATIN1SUPPLEMENT")."""
    return "".join(ch for ch in name.upper() if ch.isalnum())


def _u32p():
    import ctypes

    return ctypes.POINTER(ctypes.c_uint32)


def _cps_ptr(text: str):
    """A text's codepoints as a uint32 pointer (the array kept alive on it)."""
    arr = np.array([ord(c) for c in text], np.uint32)
    ptr = arr.ctypes.data_as(_u32p())
    ptr._keep = arr
    return ptr


def _pretokenize_equal(native, py, data: bytes) -> bool:
    """The fused native pass against the staged Python one: NFC bytes,
    codepoints, classes, byte offsets, word starts and the byte mask."""
    from ..pretok.boundaries import find_word_boundaries
    from .utf8 import utf8_byte_lengths, utf8_to_codepoints

    normalized, cps, classes, offsets = (x.copy() if isinstance(x, np.ndarray) else x
                                         for x in native.pretokenize_prepare(data))
    want = py.normalize_bytes(data)
    want_cps = utf8_to_codepoints(want)
    want_classes = py.classify_codepoints(want_cps)
    want_offsets = np.concatenate([[0], np.cumsum(utf8_byte_lengths(want_cps))[:-1]]).astype(np.uint32)
    starts = native.find_word_boundaries(cps, classes)
    want_starts = find_word_boundaries(want_cps, want_classes)
    mask = np.zeros(len(want), np.uint8)
    mask[want_offsets[want_starts.astype(bool)]] = 1
    return (normalized == want and np.array_equal(cps, want_cps) and np.array_equal(classes, want_classes)
            and np.array_equal(offsets, want_offsets[: len(cps)]) and np.array_equal(starts, want_starts)
            and np.array_equal(native.byte_word_starts(offsets, starts, len(normalized)), mask))


if __name__ == "__main__":
    import json
    import sys

    res = run_unicode_selftest()
    print(json.dumps({"exports": len(res), "failed": [n for n, ok in res.items() if not ok]}))
    sys.exit(0 if all(res.values()) else 1)
