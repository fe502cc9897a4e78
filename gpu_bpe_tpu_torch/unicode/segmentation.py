"""Text segmentation counts (grapheme, word, sentence): the port's own copy
of ``gpu_bpe_tpu/unicode/segmentation.py``, the reference decoder's
countGraphemes / countWords / countSentences.

Grapheme clusters follow the UAX #29 core rules (extend, ZWJ emoji
sequences, regional-indicator pairs, Hangul syllables). Words and sentences
run the exact UAX #29 engines (WB1..WB999, SB1..SB998) when the optional
``regex`` module imports, else simple run and terminator counters.
"""

from __future__ import annotations

import unicodedata

_REGIONAL = (0x1F1E6, 0x1F1FF)
_ZWJ = 0x200D


def _is_extend(cp: int) -> bool:
    cat = unicodedata.category(chr(cp))
    return cat in ("Mn", "Me", "Mc") or cp == 0xFE0F or cp == 0xFE0E or 0x1F3FB <= cp <= 0x1F3FF


def _hangul_type(cp: int) -> str | None:
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return "L"
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return "V"
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return "T"
    if 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    return None


def count_graphemes(s: str) -> int:
    if not s:
        return 0
    try:
        # exact UAX #29 clusters when the optional regex module is
        # present: the same clusters as the native rule engine
        import regex

        return len(regex.findall(r"\X", s))
    except ImportError:
        pass
    cps = [ord(c) for c in s]
    n = len(cps)
    count = 1
    for i in range(1, n):
        prev, curr = cps[i - 1], cps[i]
        # CRLF stays one cluster
        if prev == 0x0D and curr == 0x0A:
            continue
        # Control/newline always breaks
        if prev in (0x0A, 0x0D) or curr in (0x0A, 0x0D):
            count += 1
            continue
        if _is_extend(curr) or curr == _ZWJ:
            continue
        if prev == _ZWJ:
            # emoji ZWJ sequence continues
            continue
        if _REGIONAL[0] <= curr <= _REGIONAL[1] and _REGIONAL[0] <= prev <= _REGIONAL[1]:
            # pair regional indicators (only even-length runs pair; track run)
            run = 0
            j = i - 1
            while j >= 0 and _REGIONAL[0] <= cps[j] <= _REGIONAL[1]:
                run += 1
                j -= 1
            if run % 2 == 1:
                continue
        ph, ch = _hangul_type(prev), _hangul_type(curr)
        if ph and ch:
            if ph == "L" and ch in ("L", "V", "LV", "LVT"):
                continue
            if ph in ("LV", "V") and ch in ("V", "T"):
                continue
            if ph in ("LVT", "T") and ch == "T":
                continue
        count += 1
    return count


def _count_words_simple(s: str) -> int:
    """Word count: alphanumeric runs (UAX #29 simplified) — the no-regex
    last-resort fallback only."""
    in_word = False
    count = 0
    for c in s:
        cat = unicodedata.category(c)
        is_wordish = cat[0] in ("L", "N") or c in ("'", "’", "_")
        if is_wordish and not in_word:
            count += 1
        in_word = is_wordish
    return count


_SENTENCE_TERMINATORS = frozenset(".!?‼‽⁇⁈⁉。！．？")


def _count_sentences_simple(s: str) -> int:
    count = 0
    pending = False  # saw content since last terminator
    for c in s:
        if c in _SENTENCE_TERMINATORS:
            if pending:
                count += 1
            pending = False
        elif not c.isspace():
            pending = True
    if pending:
        count += 1
    return count


# ── Exact UAX #29 word/sentence engines ─────────────────────────────────
#
# The native rule engines (cpp/decoder.cpp word_boundary /
# sentence_boundary, WB1..WB999 / SB1..SB998) in Python, over break classes
# from the `regex` module's Unicode data, the source the native tables were
# generated from, so the native and Python backends count graphemes, words
# and sentences alike. The run-based counters above serve only where
# `regex` is missing.

from functools import lru_cache as _lru

_WB_VALUES = [
    "OTHER", "CR", "LF", "NEWLINE", "EXTEND", "ZWJ", "REGIONAL_INDICATOR",
    "FORMAT", "KATAKANA", "HEBREW_LETTER", "ALETTER", "SINGLE_QUOTE",
    "DOUBLE_QUOTE", "MIDNUMLET", "MIDLETTER", "MIDNUM", "NUMERIC",
    "EXTENDNUMLET", "WSEGSPACE",
]
_SB_VALUES = [
    "OTHER", "CR", "LF", "EXTEND", "SEP", "FORMAT", "SP", "LOWER", "UPPER",
    "OLETTER", "NUMERIC", "ATERM", "STERM", "CLOSE", "SCONTINUE",
]
(_WB_CR, _WB_LF, _WB_NL, _WB_EXTEND, _WB_ZWJ, _WB_RI, _WB_FORMAT,
 _WB_KATAKANA, _WB_HL, _WB_ALETTER, _WB_SQ, _WB_DQ, _WB_MIDNUMLET,
 _WB_MIDLETTER, _WB_MIDNUM, _WB_NUMERIC, _WB_EXTENDNUMLET,
 _WB_WSEGSPACE) = range(1, 19)
(_SB_CR, _SB_LF, _SB_EXTEND, _SB_SEP, _SB_FORMAT, _SB_SP, _SB_LOWER,
 _SB_UPPER, _SB_OLETTER, _SB_NUMERIC, _SB_ATERM, _SB_STERM, _SB_CLOSE,
 _SB_SCONT) = range(1, 15)


@_lru(maxsize=2)
def _break_patterns(prop: str):
    import regex

    values = _WB_VALUES if prop == "Word_Break" else _SB_VALUES
    pats = []
    for vid, name in enumerate(values):
        if vid == 0:
            continue
        try:
            pats.append((vid, regex.compile(rf"\p{{{prop}={name}}}")))
        except regex.error:  # pragma: no cover — property absent
            pass
    return pats


@_lru(maxsize=None)
def _wb_of(cp: int) -> int:
    ch = chr(cp)
    for vid, pat in _break_patterns("Word_Break"):
        if pat.match(ch):
            return vid
    return 0


@_lru(maxsize=None)
def _sb_of(cp: int) -> int:
    ch = chr(cp)
    for vid, pat in _break_patterns("Sentence_Break"):
        if pat.match(ch):
            return vid
    return 0


@_lru(maxsize=None)
def _ext_pict(cp: int) -> bool:
    import regex

    return bool(regex.match(r"\p{Extended_Pictographic}", chr(cp)))


def _wb_ignorable(w: int) -> bool:
    return w in (_WB_EXTEND, _WB_FORMAT, _WB_ZWJ)


def _wb_ahletter(w: int) -> bool:
    return w in (_WB_ALETTER, _WB_HL)


def _wb_midnumletq(w: int) -> bool:
    return w in (_WB_MIDNUMLET, _WB_SQ)


def _wb_left(wb, i):
    while i >= 0:
        if not _wb_ignorable(wb[i]):
            return wb[i], i
        i -= 1
    return -1, -1


def _wb_right(wb, n, i):
    while i < n:
        if not _wb_ignorable(wb[i]):
            return wb[i]
        i += 1
    return -1


def word_boundary(cps, wb, n: int, pos: int) -> bool:
    """WB1..WB999 between cps[pos-1] and cps[pos] (mirror of the native
    engine, cpp/decoder.cpp word_boundary)."""
    pr, cr = wb[pos - 1], wb[pos]
    if pr == _WB_CR and cr == _WB_LF:
        return False  # WB3
    if pr in (_WB_NL, _WB_CR, _WB_LF):
        return True  # WB3a
    if cr in (_WB_NL, _WB_CR, _WB_LF):
        return True  # WB3b
    if pr == _WB_ZWJ and _ext_pict(cps[pos]):
        return False  # WB3c
    if pr == _WB_WSEGSPACE and cr == _WB_WSEGSPACE:
        return False  # WB3d
    if _wb_ignorable(cr):
        return False  # WB4 (x)
    p, pi = _wb_left(wb, pos - 1)
    if p < 0:
        return True  # only ignorables before: WB999
    c = cr
    pp, _ = _wb_left(wb, pi - 1) if pi > 0 else (-1, -1)
    nx = _wb_right(wb, n, pos + 1)
    if _wb_ahletter(p) and _wb_ahletter(c):
        return False  # WB5
    if _wb_ahletter(p) and (c == _WB_MIDLETTER or _wb_midnumletq(c)) \
            and nx >= 0 and _wb_ahletter(nx):
        return False  # WB6
    if (p == _WB_MIDLETTER or _wb_midnumletq(p)) and _wb_ahletter(c) \
            and pp >= 0 and _wb_ahletter(pp):
        return False  # WB7
    if p == _WB_HL and c == _WB_SQ:
        return False  # WB7a
    if p == _WB_HL and c == _WB_DQ and nx == _WB_HL:
        return False  # WB7b
    if p == _WB_DQ and c == _WB_HL and pp == _WB_HL:
        return False  # WB7c
    if p == _WB_NUMERIC and c == _WB_NUMERIC:
        return False  # WB8
    if _wb_ahletter(p) and c == _WB_NUMERIC:
        return False  # WB9
    if p == _WB_NUMERIC and _wb_ahletter(c):
        return False  # WB10
    if (p == _WB_MIDNUM or _wb_midnumletq(p)) and c == _WB_NUMERIC \
            and pp == _WB_NUMERIC:
        return False  # WB11
    if p == _WB_NUMERIC and (c == _WB_MIDNUM or _wb_midnumletq(c)) \
            and nx == _WB_NUMERIC:
        return False  # WB12
    if p == _WB_KATAKANA and c == _WB_KATAKANA:
        return False  # WB13
    if (_wb_ahletter(p) or p in (_WB_NUMERIC, _WB_KATAKANA, _WB_EXTENDNUMLET)) \
            and c == _WB_EXTENDNUMLET:
        return False  # WB13a
    if p == _WB_EXTENDNUMLET and (_wb_ahletter(c) or c in (_WB_NUMERIC, _WB_KATAKANA)):
        return False  # WB13b
    if p == _WB_RI and c == _WB_RI:  # WB15/16
        count = 0
        i = pi
        while i >= 0:
            w = wb[i]
            if _wb_ignorable(w):
                i -= 1
                continue
            if w != _WB_RI:
                break
            count += 1
            i -= 1
        if count % 2 == 1:
            return False
    return True  # WB999


def count_words_exact(s: str) -> int:
    """Native-parity word count (decoder_count_words): word-boundary
    segments containing at least one AHLetter/Numeric/Katakana/
    ExtendNumLet codepoint."""
    cps = [ord(c) for c in s]
    n = len(cps)
    wb = [_wb_of(cp) for cp in cps]
    count = 0
    has_word_char = False
    for i in range(n):
        if i > 0 and word_boundary(cps, wb, n, i):
            if has_word_char:
                count += 1
            has_word_char = False
        w = wb[i]
        if _wb_ahletter(w) or w in (_WB_NUMERIC, _WB_KATAKANA, _WB_EXTENDNUMLET):
            has_word_char = True
    if has_word_char:
        count += 1
    return count


def _sb_ignorable(x: int) -> bool:
    return x in (_SB_EXTEND, _SB_FORMAT)


def _sb_parasep(x: int) -> bool:
    return x in (_SB_SEP, _SB_CR, _SB_LF)


def _sb_saterm(x: int) -> bool:
    return x in (_SB_ATERM, _SB_STERM)


def _sb_left(sb, i):
    while i >= 0:
        if not _sb_ignorable(sb[i]):
            return sb[i], i
        i -= 1
    return -1, -1


def _sb_match_saterm(sb, i, skip_sp: bool):
    s, idx = _sb_left(sb, i)
    if skip_sp:
        while s == _SB_SP:
            s, idx = _sb_left(sb, idx - 1)
    while s == _SB_CLOSE:
        s, idx = _sb_left(sb, idx - 1)
    return idx if (s >= 0 and _sb_saterm(s)) else -1


def sentence_boundary(sb, n: int, pos: int) -> bool:
    """SB1..SB998 between positions pos-1 and pos (mirror of the native
    engine, cpp/decoder.cpp sentence_boundary)."""
    pr, cr = sb[pos - 1], sb[pos]
    if pr == _SB_CR and cr == _SB_LF:
        return False  # SB3
    if _sb_parasep(pr):
        return True  # SB4
    if _sb_ignorable(cr):
        return False  # SB5 (x)
    p, pidx = _sb_left(sb, pos - 1)
    if p < 0:
        return False  # SB998
    c = cr
    if p == _SB_ATERM and c == _SB_NUMERIC:
        return False  # SB6
    if p == _SB_ATERM and c == _SB_UPPER:  # SB7
        pp, _ = _sb_left(sb, pidx - 1)
        if pp in (_SB_UPPER, _SB_LOWER):
            return False
    # SB8: ATerm Close* Sp* x (not (OLetter|Upper|Lower|ParaSep|SATerm))* Lower
    at = _sb_match_saterm(sb, pidx, True)
    if at >= 0 and sb[at] == _SB_ATERM:
        for i in range(pos, n):
            x = sb[i]
            if _sb_ignorable(x):
                continue
            if x == _SB_LOWER:
                return False
            if x == _SB_OLETTER or x == _SB_UPPER or _sb_parasep(x) or _sb_saterm(x):
                break
    # SB8a: SATerm Close* Sp* x (SContinue | SATerm)
    if c == _SB_SCONT or _sb_saterm(c):
        if _sb_match_saterm(sb, pidx, True) >= 0:
            return False
    # SB9: SATerm Close* x (Close | Sp | ParaSep)
    if c == _SB_CLOSE or c == _SB_SP or _sb_parasep(c):
        if _sb_match_saterm(sb, pidx, False) >= 0:
            return False
    # SB10: SATerm Close* Sp* x (Sp | ParaSep)
    if c == _SB_SP or _sb_parasep(c):
        if _sb_match_saterm(sb, pidx, True) >= 0:
            return False
    # SB11: SATerm Close* Sp* ParaSep? / (ParaSep handled by SB4)
    if _sb_match_saterm(sb, pidx, True) >= 0:
        return True
    return False  # SB998


def count_sentences_exact(s: str) -> int:
    """Native-parity sentence count (decoder_count_sentences): sentence-
    boundary segments containing non-whitespace content (the native uses
    its pre-tokenizer class table: WHITESPACE=2, NEWLINE=5)."""
    from .fallback import class_table

    cps = [ord(c) for c in s]
    n = len(cps)
    sb = [_sb_of(cp) for cp in cps]
    table = class_table()
    count = 0
    has_content = False
    for i in range(n):
        if i > 0 and sentence_boundary(sb, n, i):
            if has_content:
                count += 1
            has_content = False
        cl = int(table[cps[i]]) if cps[i] < len(table) else 6
        if cl != 2 and cl != 5:
            has_content = True
    if has_content:
        count += 1
    return count


def count_words(s: str) -> int:
    """Word count: the exact UAX #29 engine when `regex` is available
    (native-parity), else the simplified run counter."""
    if not s:
        return 0
    try:
        import regex  # noqa: F401
    except ImportError:  # pragma: no cover
        return _count_words_simple(s)
    return count_words_exact(s)


def count_sentences(s: str) -> int:
    """Sentence count: the exact UAX #29 engine when `regex` is available
    (native-parity), else the simplified terminator counter."""
    if not s:
        return 0
    try:
        import regex  # noqa: F401
    except ImportError:  # pragma: no cover
        return _count_sentences_simple(s)
    return count_sentences_exact(s)
