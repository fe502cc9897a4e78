// decoder.cpp — native Unicode processing library (C ABI).
//
// The framework's equivalent of the reference's decoder.wasm (Emscripten C,
// 71 exports — the reference's src/wasm/decoder.js): codepoint property
// predicates, NFC/NFD normalization over UTF-8 byte streams, batch
// codepoint classification, case mapping, and segmentation counts. Built as
// a shared library and loaded via ctypes (pybind11 is not available in this
// image); unicode/cpp_backend.py is the Python binding.
//
// Hot paths (consumed by the pre-tokenizer, pre_tokenizer.mjs:459-509
// equivalents): decoder_normalize_utf8, decoder_classify_codepoints.
//
// Tables are generated from CPython's unicodedata by gen_tables.py.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

#include "unicode_tables.h"

namespace {

constexpr uint32_t kMaxCp = 0x110000;

// ── table lookups ───────────────────────────────────────────────────

inline uint8_t category_of(uint32_t cp) {
  if (cp >= kMaxCp) return 0;  // Cn
  // binary search over RLE ranges
  uint32_t lo = 0, hi = kCatRangeCount;
  while (hi - lo > 1) {
    uint32_t mid = (lo + hi) >> 1;
    if (kCatRangeStart[mid] <= cp) lo = mid; else hi = mid;
  }
  return kCatRangeValue[lo];
}

inline uint8_t class_of(uint32_t cp) {
  if (cp >= kMaxCp) return 6;  // OTHER
  return kClassPages[kClassPageIndex[cp >> 8]][cp & 0xFF];
}

inline uint8_t ccc_of(uint32_t cp) {
  const uint32_t* end = kCccCp + kCccCount;
  const uint32_t* it = std::lower_bound(kCccCp, end, cp);
  if (it != end && *it == cp) return kCccValue[it - kCccCp];
  return 0;
}

inline int32_t sparse_map(const uint32_t* keys, const uint32_t* vals,
                          uint32_t count, uint32_t cp) {
  const uint32_t* end = keys + count;
  const uint32_t* it = std::lower_bound(keys, end, cp);
  if (it != end && *it == cp) return (int32_t)vals[it - keys];
  return -1;
}

// category group helpers (indices into CATEGORIES in gen_tables.py)
inline bool cat_in(uint8_t c, uint8_t lo, uint8_t hi) { return c >= lo && c <= hi; }
inline bool is_letter_cat(uint8_t c) { return cat_in(c, 1, 5); }       // Lu..Lo
inline bool is_mark_cat(uint8_t c) { return cat_in(c, 6, 8); }          // Mn..Me
inline bool is_number_cat(uint8_t c) { return cat_in(c, 9, 11); }       // Nd..No
inline bool is_punct_cat(uint8_t c) { return cat_in(c, 12, 18); }       // Pc..Po
inline bool is_symbol_cat(uint8_t c) { return cat_in(c, 19, 22); }      // Sm..So
inline bool is_sep_cat(uint8_t c) { return cat_in(c, 23, 25); }         // Zs..Zp

// ── UTF-8 ───────────────────────────────────────────────────────────

// Strict UTF-8 decode; returns codepoint count or -1 on invalid input.
int64_t utf8_decode(const uint8_t* in, int64_t len, uint32_t* out) {
  int64_t n = 0;
  int64_t i = 0;
  while (i < len) {
    uint8_t b = in[i];
    uint32_t cp;
    int size;
    if (b < 0x80) { cp = b; size = 1; }
    else if ((b & 0xE0) == 0xC0) {
      if (i + 1 >= len || (in[i+1] & 0xC0) != 0x80) return -1;
      cp = ((b & 0x1F) << 6) | (in[i+1] & 0x3F);
      if (cp < 0x80) return -1;
      size = 2;
    } else if ((b & 0xF0) == 0xE0) {
      if (i + 2 >= len || (in[i+1] & 0xC0) != 0x80 || (in[i+2] & 0xC0) != 0x80) return -1;
      cp = ((b & 0x0F) << 12) | ((in[i+1] & 0x3F) << 6) | (in[i+2] & 0x3F);
      if (cp < 0x800 || (cp >= 0xD800 && cp <= 0xDFFF)) return -1;
      size = 3;
    } else if ((b & 0xF8) == 0xF0) {
      if (i + 3 >= len || (in[i+1] & 0xC0) != 0x80 || (in[i+2] & 0xC0) != 0x80 ||
          (in[i+3] & 0xC0) != 0x80) return -1;
      cp = ((b & 0x07) << 18) | ((in[i+1] & 0x3F) << 12) | ((in[i+2] & 0x3F) << 6) | (in[i+3] & 0x3F);
      if (cp < 0x10000 || cp > 0x10FFFF) return -1;
      size = 4;
    } else {
      return -1;
    }
    if (out) out[n] = cp;
    n++;
    i += size;
  }
  return n;
}

inline int utf8_encode_one(uint32_t cp, uint8_t* out) {
  if (cp <= 0x7F) { out[0] = (uint8_t)cp; return 1; }
  if (cp <= 0x7FF) {
    out[0] = 0xC0 | (cp >> 6); out[1] = 0x80 | (cp & 0x3F); return 2;
  }
  if (cp <= 0xFFFF) {
    out[0] = 0xE0 | (cp >> 12); out[1] = 0x80 | ((cp >> 6) & 0x3F);
    out[2] = 0x80 | (cp & 0x3F); return 3;
  }
  out[0] = 0xF0 | (cp >> 18); out[1] = 0x80 | ((cp >> 12) & 0x3F);
  out[2] = 0x80 | ((cp >> 6) & 0x3F); out[3] = 0x80 | (cp & 0x3F); return 4;
}

// ── normalization (NFC / NFD over codepoints) ───────────────────────

constexpr uint32_t kSBase = 0xAC00, kLBase = 0x1100, kVBase = 0x1161, kTBase = 0x11A7;
constexpr uint32_t kLCount = 19, kVCount = 21, kTCount = 28;
constexpr uint32_t kNCount = kVCount * kTCount, kSCount = kLCount * kNCount;

// Reference-compat mode (GPU_BPE_TPU_REF_HANGUL / decoder_set_hangul_inert):
// the reference's wasm treats Hangul as normalization-INERT — its NFD/NFKD
// never algorithmically decomposes syllables and its NFC/NFKC never composes
// conjoining jamo (oracle-probed: decoder_compose(0x1109,0x1161) == 0; see
// docs/CONFORMANCE.md "Hangul normalization"). We implement the UAX #15
// algorithmic step by default; this flag restores the reference's behavior
// so merge lists match it bit-for-bit on decomposed-jamo corpora.
bool g_hangul_inert = false;

void decompose_cp(uint32_t cp, std::vector<uint32_t>& out, bool compat = false) {
  if (!g_hangul_inert && cp >= kSBase && cp < kSBase + kSCount) {  // Hangul (UAX #15 §3.12)
    uint32_t s = cp - kSBase;
    out.push_back(kLBase + s / kNCount);
    out.push_back(kVBase + (s % kNCount) / kTCount);
    uint32_t t = s % kTCount;
    if (t) out.push_back(kTBase + t);
    return;
  }
  // Both tables are fully expanded at generation time, so one lookup
  // suffices; the compat table is a superset of the canonical one.
  const uint32_t* cps = compat ? kCompatCp : kDecompCp;
  const uint32_t* offlen = compat ? kCompatOffLen : kDecompOffLen;
  const uint32_t* pool = compat ? kCompatPool : kDecompPool;
  uint32_t count = compat ? kCompatCount : kDecompCount;
  const uint32_t* end = cps + count;
  const uint32_t* it = std::lower_bound(cps, end, cp);
  if (it != end && *it == cp) {
    uint32_t ol = offlen[it - cps];
    uint32_t off = ol >> 8, len = ol & 0xFF;
    for (uint32_t k = 0; k < len; k++) out.push_back(pool[off + k]);
    return;
  }
  out.push_back(cp);
}

void canonical_order(std::vector<uint32_t>& cps) {
  // stable bubble over combining sequences (sequences are short)
  size_t n = cps.size();
  for (size_t i = 1; i < n; i++) {
    uint8_t cc = ccc_of(cps[i]);
    if (cc == 0) continue;
    size_t j = i;
    while (j > 0 && ccc_of(cps[j - 1]) > cc) {
      std::swap(cps[j - 1], cps[j]);
      j--;
    }
  }
}

inline int64_t compose_pair(uint32_t a, uint32_t b) {
  // Hangul algorithmic composition (skipped in reference-compat mode —
  // the reference binary cannot compose conjoining jamo, see g_hangul_inert)
  if (!g_hangul_inert) {
    if (a >= kLBase && a < kLBase + kLCount && b >= kVBase && b < kVBase + kVCount) {
      return kSBase + ((a - kLBase) * kVCount + (b - kVBase)) * kTCount;
    }
    if (a >= kSBase && a < kSBase + kSCount && ((a - kSBase) % kTCount) == 0 &&
        b > kTBase && b < kTBase + kTCount) {
      return a + (b - kTBase);
    }
  }
  uint64_t key = ((uint64_t)a << 21) | b;
  const uint64_t* end = kCompKey + kCompCount;
  const uint64_t* it = std::lower_bound(kCompKey, end, key);
  if (it != end && *it == key) return (int64_t)kCompValue[it - kCompKey];
  return -1;
}

void compose(std::vector<uint32_t>& cps) {
  // UAX #15 canonical composition
  if (cps.empty()) return;
  size_t last_starter = (size_t)-1;
  int last_starter_cc = -1;  // cc of last combining char seen after starter
  std::vector<uint32_t> out;
  out.reserve(cps.size());
  for (size_t i = 0; i < cps.size(); i++) {
    uint32_t cp = cps[i];
    uint8_t cc = ccc_of(cp);
    if (last_starter != (size_t)-1 && last_starter_cc < (int)cc) {
      int64_t comp = compose_pair(out[last_starter], cp);
      if (comp >= 0) { out[last_starter] = (uint32_t)comp; continue; }
    }
    if (cc == 0) {
      // starter: can it compose with previous starter when adjacent?
      if (last_starter != (size_t)-1 && last_starter_cc == -1 &&
          last_starter == out.size() - 1) {
        int64_t comp = compose_pair(out[last_starter], cp);
        if (comp >= 0) { out[last_starter] = (uint32_t)comp; continue; }
      }
      out.push_back(cp);
      last_starter = out.size() - 1;
      last_starter_cc = -1;
    } else {
      out.push_back(cp);
      last_starter_cc = cc;
    }
  }
  cps.swap(out);
}

// Post-15.0 codepoints whose decomposition the REFERENCE's NFC/NFKC
// pipeline does not know (its composing forms use an older table than
// its NFD — oracle-verified): inert under the composing forms, fully
// decomposed under NFD/NFKD. Mirrored for parity.
static inline bool nfc_inert(uint32_t cp) {
  if (kNfcInertCount == 0) return false;
  const uint32_t* end = kNfcInertCp + kNfcInertCount;
  const uint32_t* it = std::lower_bound(kNfcInertCp, end, cp);
  return it != end && *it == cp;
}

void normalize_cps(std::vector<uint32_t>& cps, int form) {
  // form: 0=NFC, 1=NFD, 2=NFKC, 3=NFKD (UAX #15; K-forms use the fully
  // expanded compatibility decomposition table)
  bool compat = form >= 2;
  bool composing = form == 0 || form == 2;
  std::vector<uint32_t> decomposed;
  decomposed.reserve(cps.size() + 16);
  for (uint32_t cp : cps) {
    if (composing && nfc_inert(cp)) decomposed.push_back(cp);
    else decompose_cp(cp, decomposed, compat);
  }
  canonical_order(decomposed);
  if (composing) compose(decomposed);
  cps.swap(decomposed);
}

}  // namespace

extern "C" {

// ── lifecycle ────────────────────────────────────────────────────────
int decoder_init() { return 0; }
void decoder_cleanup() {}
const char* decoder_get_unicode_version() { return kUnicodeVersion; }

// Reference-compat Hangul mode (see g_hangul_inert above): 1 = skip the
// UAX #15 algorithmic Hangul step exactly like the reference binary does.
void decoder_set_hangul_inert(int v) { g_hangul_inert = v != 0; }
int decoder_get_hangul_inert() { return g_hangul_inert ? 1 : 0; }

// ── properties ───────────────────────────────────────────────────────
int decoder_get_category(uint32_t cp) { return category_of(cp); }
int decoder_is_valid(uint32_t cp) { return cp < kMaxCp && !(cp >= 0xD800 && cp <= 0xDFFF); }
int decoder_is_assigned(uint32_t cp) { return category_of(cp) != 0; }
int decoder_is_surrogate(uint32_t cp) { return cp >= 0xD800 && cp <= 0xDFFF; }
int decoder_is_noncharacter(uint32_t cp) {
  return (cp >= 0xFDD0 && cp <= 0xFDEF) || ((cp & 0xFFFE) == 0xFFFE && cp < kMaxCp);
}
int decoder_is_private_use(uint32_t cp) { return category_of(cp) == 29; }
int decoder_is_letter(uint32_t cp) { return is_letter_cat(category_of(cp)); }
int decoder_is_mark(uint32_t cp) { return is_mark_cat(category_of(cp)); }
int decoder_is_digit(uint32_t cp) { return category_of(cp) == 9; }
int decoder_is_number(uint32_t cp) { return is_number_cat(category_of(cp)); }
int decoder_is_punctuation(uint32_t cp) { return is_punct_cat(category_of(cp)); }
int decoder_is_symbol(uint32_t cp) { return is_symbol_cat(category_of(cp)); }
int decoder_is_separator(uint32_t cp) { return is_sep_cat(category_of(cp)); }
int decoder_is_control(uint32_t cp) { return category_of(cp) == 26; }
int decoder_is_format(uint32_t cp) { return category_of(cp) == 27; }
int decoder_is_uppercase(uint32_t cp) { return category_of(cp) == 1; }
int decoder_is_lowercase(uint32_t cp) { return category_of(cp) == 2; }
int decoder_is_titlecase(uint32_t cp) { return category_of(cp) == 3; }
int decoder_is_whitespace(uint32_t cp) { return class_of(cp) == 2 || class_of(cp) == 5; }
int decoder_is_alphanumeric(uint32_t cp) {
  uint8_t c = category_of(cp);
  return is_letter_cat(c) || is_number_cat(c);
}
int decoder_is_alphabetic(uint32_t cp) {
  // Alphabetic ~= L* + Nl (Other_Alphabetic marks approximated out)
  uint8_t c = category_of(cp);
  return is_letter_cat(c) || c == 10;  // Nl
}
int decoder_is_numeric(uint32_t cp) { return is_number_cat(category_of(cp)); }
int decoder_is_combining(uint32_t cp) { return ccc_of(cp) != 0; }
int decoder_get_combining_class(uint32_t cp) { return ccc_of(cp); }

// ── case mapping (simple) ────────────────────────────────────────────
uint32_t decoder_to_upper(uint32_t cp) {
  int32_t m = sparse_map(kUpperCp, kUpperMap, kUpperCount, cp);
  return m >= 0 ? (uint32_t)m : cp;
}
uint32_t decoder_to_lower(uint32_t cp) {
  int32_t m = sparse_map(kLowerCp, kLowerMap, kLowerCount, cp);
  return m >= 0 ? (uint32_t)m : cp;
}
uint32_t decoder_to_title(uint32_t cp) {
  int32_t m = sparse_map(kTitleCp, kTitleMap, kTitleCount, cp);
  return m >= 0 ? (uint32_t)m : cp;
}
uint32_t decoder_case_fold(uint32_t cp) {
  int32_t m = sparse_map(kFoldCp, kFoldMap, kFoldCount, cp);
  return m >= 0 ? (uint32_t)m : cp;
}

// ── case mapping (full, possibly multi-codepoint) ───────────────────
// Writes the full mapping into out (cap >= 3 covers all of Unicode);
// returns the mapped length. Falls back to the simple map.
static int full_case(uint32_t cp, const uint32_t* cps, const uint32_t* offlen,
                     uint32_t count, uint32_t simple, uint32_t* out, int cap) {
  const uint32_t* end = cps + count;
  const uint32_t* it = std::lower_bound(cps, end, cp);
  if (it != end && *it == cp) {
    uint32_t ol = offlen[it - cps];
    uint32_t off = ol >> 8, len = ol & 0xFF;
    int n = (int)std::min((uint32_t)cap, len);
    for (int i = 0; i < n; i++) out[i] = kFullCasePool[off + i];
    return n;
  }
  if (cap >= 1) { out[0] = simple; return 1; }
  return 0;
}

int decoder_to_upper_full(uint32_t cp, uint32_t* out, int cap) {
  return full_case(cp, kFullUpperCp, kFullUpperOffLen, kFullUpperCount,
                   decoder_to_upper(cp), out, cap);
}
int decoder_to_lower_full(uint32_t cp, uint32_t* out, int cap) {
  return full_case(cp, kFullLowerCp, kFullLowerOffLen, kFullLowerCount,
                   decoder_to_lower(cp), out, cap);
}
int decoder_to_title_full(uint32_t cp, uint32_t* out, int cap) {
  return full_case(cp, kFullTitleCp, kFullTitleOffLen, kFullTitleCount,
                   decoder_to_title(cp), out, cap);
}
int decoder_case_fold_full(uint32_t cp, uint32_t* out, int cap) {
  return full_case(cp, kFullFoldCp, kFullFoldOffLen, kFullFoldCount,
                   decoder_case_fold(cp), out, cap);
}

// Caseless compare of two codepoint strings (full case folding).
// Returns <0, 0, >0 like strcmp.
int decoder_case_compare(const uint32_t* a, int64_t an, const uint32_t* b, int64_t bn) {
  std::vector<uint32_t> fa, fb;
  uint32_t buf[4];
  for (int64_t i = 0; i < an; i++) {
    int n = decoder_case_fold_full(a[i], buf, 4);
    fa.insert(fa.end(), buf, buf + n);
  }
  for (int64_t i = 0; i < bn; i++) {
    int n = decoder_case_fold_full(b[i], buf, 4);
    fb.insert(fb.end(), buf, buf + n);
  }
  size_t m = std::min(fa.size(), fb.size());
  for (size_t i = 0; i < m; i++) {
    if (fa[i] != fb[i]) return fa[i] < fb[i] ? -1 : 1;
  }
  if (fa.size() == fb.size()) return 0;
  return fa.size() < fb.size() ? -1 : 1;
}

// string-level simple case conversion (codepoint arrays, 1:1)
void decoder_string_to_upper(const uint32_t* in, int64_t n, uint32_t* out) {
  for (int64_t i = 0; i < n; i++) out[i] = decoder_to_upper(in[i]);
}
void decoder_string_to_lower(const uint32_t* in, int64_t n, uint32_t* out) {
  for (int64_t i = 0; i < n; i++) out[i] = decoder_to_lower(in[i]);
}
void decoder_string_to_title(const uint32_t* in, int64_t n, uint32_t* out) {
  bool word_start = true;
  for (int64_t i = 0; i < n; i++) {
    uint8_t c = category_of(in[i]);
    bool cased = is_letter_cat(c);
    out[i] = word_start && cased ? decoder_to_title(in[i])
             : cased             ? decoder_to_lower(in[i])
                                 : in[i];
    if (cased || is_number_cat(c)) word_start = false;
    else word_start = true;
  }
}

// ── composition / decomposition ──────────────────────────────────────
// Reference semantics: 0 = no composition (not -1); composed cp otherwise.
int64_t decoder_compose(uint32_t a, uint32_t b) {
  int64_t c = compose_pair(a, b);
  return c < 0 ? 0 : c;
}
// Reference semantics (oracle-pinned): SINGLE-LEVEL canonical
// decomposition from the raw UCD mapping (0x1D5 -> [0xDC, 0x304], not
// the recursive [0x55, 0x308, 0x304]); Hangul is not decomposed.
// kRefDecomp* is sweep-extracted from the reference binary.
int decoder_decompose(uint32_t cp, uint32_t* out, int cap) {
  int64_t lo = 0, hi = (int64_t)kRefDecompCount - 1;
  while (lo <= hi) {
    int64_t mid = (lo + hi) >> 1;
    if (kRefDecompCp[mid] < cp) lo = mid + 1;
    else if (kRefDecompCp[mid] > cp) hi = mid - 1;
    else {
      int n = kRefDecompC1[mid] ? 2 : 1;
      for (int i = 0; i < n && i < cap; i++)
        out[i] = i == 0 ? kRefDecompC0[mid] : kRefDecompC1[mid];
      return n;
    }
  }
  return 0;
}

// Full recursive canonical decomposition incl. algorithmic Hangul (extra
// export; the internal NFD path).
int decoder_decompose_full(uint32_t cp, uint32_t* out, int cap) {
  std::vector<uint32_t> v;
  decompose_cp(cp, v);
  if (v.size() == 1 && v[0] == cp) return 0;
  int n = (int)std::min((size_t)cap, v.size());
  for (int i = 0; i < n; i++) out[i] = v[i];
  return n;
}

// ── UTF-8 validation / transcoding ───────────────────────────────────
int decoder_is_valid_utf8(const uint8_t* in, int64_t len) {
  return utf8_decode(in, len, nullptr) >= 0;
}
int64_t decoder_utf8_char_count(const uint8_t* in, int64_t len) {
  return utf8_decode(in, len, nullptr);
}
int64_t decoder_utf8_to_utf32(const uint8_t* in, int64_t len, uint32_t* out, int64_t cap) {
  // caller guarantees cap >= char count (<= len)
  (void)cap;
  return utf8_decode(in, len, out);
}

// ── normalization over UTF-8 bytes (the hot path) ────────────────────
// form: 0=NFC 1=NFD 2=NFKC 3=NFKD.
// Returns 0 on success, -3 on invalid UTF-8, -2 if out buffer too small.
int decoder_normalize_utf8(const uint8_t* in, int64_t len, int form,
                           uint8_t* out, int64_t cap, int64_t* out_len) {
  std::vector<uint32_t> cps((size_t)len);
  int64_t n = utf8_decode(in, len, cps.data());
  if (n < 0) return -3;
  cps.resize((size_t)n);
  normalize_cps(cps, form);
  int64_t pos = 0;
  for (uint32_t cp : cps) {
    if (pos + 4 > cap) return -2;
    pos += utf8_encode_one(cp, out + pos);
  }
  *out_len = pos;
  return 0;
}

int decoder_quick_check(const uint32_t* in, int64_t n, int form);

// Reference semantics: UAX #15 quick check over the decoded stream —
// MAYBE counts as NOT normalized (oracle-pinned: "q" + U+0301 is
// reported unnormalized under NFC even though it is). The exact
// (normalize-and-compare) checks survive as *_exact extras.
int decoder_is_normalized_utf8(const uint8_t* in, int64_t len, int form) {
  int64_t n = utf8_decode(in, len, nullptr);
  if (n < 0) return 0;
  std::vector<uint32_t> cps((size_t)n);
  utf8_decode(in, len, cps.data());
  return decoder_quick_check(cps.data(), n, form) == 1;
}

int decoder_is_normalized_utf8_exact(const uint8_t* in, int64_t len, int form) {
  std::vector<uint8_t> buf((size_t)len * 4 + 4);
  int64_t out_len = 0;
  if (decoder_normalize_utf8(in, len, form, buf.data(), (int64_t)buf.size(), &out_len) != 0)
    return 0;
  return out_len == len && std::memcmp(in, buf.data(), (size_t)len) == 0;
}

// ── normalization over codepoint arrays ─────────────────────────────
// Returns the normalized length, or -2 if out is too small.
int64_t decoder_normalize(const uint32_t* in, int64_t n, int form,
                          uint32_t* out, int64_t cap) {
  std::vector<uint32_t> cps(in, in + n);
  normalize_cps(cps, form);
  if ((int64_t)cps.size() > cap) return -2;
  std::copy(cps.begin(), cps.end(), out);
  return (int64_t)cps.size();
}

// Reference semantics: quick-check based (MAYBE = not normalized).
int decoder_is_normalized(const uint32_t* in, int64_t n, int form) {
  return decoder_quick_check(in, n, form) == 1;
}

// Exact normalize-and-compare check (extra export).
int decoder_is_normalized_exact(const uint32_t* in, int64_t n, int form) {
  std::vector<uint32_t> cps(in, in + n);
  normalize_cps(cps, form);
  return (int64_t)cps.size() == n && std::equal(cps.begin(), cps.end(), in);
}

// Normalization quick check: 1 = YES (already normalized), 0 = NO.
// (Computed by normalizing — no MAYBE; the tri-state NFC_QC property is
// not exposed by the table source, so this is exact but not "quick".)
// UAX #15 quick check, reference tri-state (oracle-pinned): MAYBE=0,
// YES=1, NO=2. Per-cp values come from sweep-extracted run tables
// (kQc*); a canonical-ordering violation (prev ccc > ccc > 0) is an
// immediate NO. String result: any NO -> NO, else any MAYBE -> MAYBE.
static uint8_t range_value_u8q(const uint32_t* starts, const uint8_t* values,
                               uint32_t count, uint32_t cp) {
  if (count == 0 || cp > 0x10FFFF) return 1;
  uint32_t lo = 0, hi = count;
  while (hi - lo > 1) {
    uint32_t mid = (lo + hi) >> 1;
    if (starts[mid] <= cp) lo = mid; else hi = mid;
  }
  return values[lo];
}

static inline uint8_t qc_of(int form, uint32_t cp) {
  switch (form) {
    case 0: return range_value_u8q(kQcStart0, kQcVal0, kQcCount0, cp);
    case 1: return range_value_u8q(kQcStart1, kQcVal1, kQcCount1, cp);
    case 2: return range_value_u8q(kQcStart2, kQcVal2, kQcCount2, cp);
    default: return range_value_u8q(kQcStart3, kQcVal3, kQcCount3, cp);
  }
}

int decoder_quick_check(const uint32_t* in, int64_t n, int form) {
  int res = 1;
  uint8_t prev_ccc = 0;
  for (int64_t i = 0; i < n; i++) {
    uint8_t c = ccc_of(in[i]);
    if (c != 0 && prev_ccc > c) return 2;
    prev_ccc = c;
    uint8_t q = qc_of(form, in[i]);
    if (q == 2) return 2;
    if (q == 0) res = 0;
  }
  return res;
}

// ── UTF-8 sanitization (lossy decode, U+FFFD for invalid sequences) ──
// Returns 0; out must hold up to 3x len bytes. (Extra export beyond the
// reference: its decoder_sanitize operates on codepoints, see below.)
int decoder_sanitize_utf8(const uint8_t* in, int64_t len,
                          uint8_t* out, int64_t cap, int64_t* out_len) {
  int64_t pos = 0;
  int64_t i = 0;
  auto put = [&](uint32_t cp) -> bool {
    if (pos + 4 > cap) return false;
    pos += utf8_encode_one(cp, out + pos);
    return true;
  };
  while (i < len) {
    uint8_t b = in[i];
    uint32_t cp = 0xFFFD;
    int size = 1;
    if (b < 0x80) { cp = b; }
    else if ((b & 0xE0) == 0xC0 && i + 1 < len && (in[i+1] & 0xC0) == 0x80) {
      uint32_t c = ((b & 0x1F) << 6) | (in[i+1] & 0x3F);
      if (c >= 0x80) { cp = c; size = 2; }
    } else if ((b & 0xF0) == 0xE0 && i + 2 < len && (in[i+1] & 0xC0) == 0x80 &&
               (in[i+2] & 0xC0) == 0x80) {
      uint32_t c = ((b & 0x0F) << 12) | ((in[i+1] & 0x3F) << 6) | (in[i+2] & 0x3F);
      if (c >= 0x800 && !(c >= 0xD800 && c <= 0xDFFF)) { cp = c; size = 3; }
    } else if ((b & 0xF8) == 0xF0 && i + 3 < len && (in[i+1] & 0xC0) == 0x80 &&
               (in[i+2] & 0xC0) == 0x80 && (in[i+3] & 0xC0) == 0x80) {
      uint32_t c = ((b & 0x07) << 18) | ((in[i+1] & 0x3F) << 12) |
                   ((in[i+2] & 0x3F) << 6) | (in[i+3] & 0x3F);
      if (c >= 0x10000 && c <= 0x10FFFF) { cp = c; size = 4; }
    }
    if (!put(cp)) return -2;
    i += size;
  }
  *out_len = pos;
  return 0;
}

int decoder_is_well_formed_utf8(const uint8_t* in, int64_t len) {
  return utf8_decode(in, len, nullptr) >= 0;
}

// ── codepoint-stream sanitization (reference semantics) ──────────────
// Matches the reference's src/wasm/decoder.wasm `decoder_sanitize` exactly
// (oracle-pinned): drops surrogates, noncharacters (U+FDD0..U+FDEF and
// plane-end U+xFFFE/U+xFFFF) and out-of-range values; keeps everything
// else (controls, bidi overrides, ZWSP, unassigned); silently truncates
// at `cap`; `flags` is accepted and ignored; always returns 0.
int decoder_sanitize(const uint32_t* in, int64_t n,
                     uint32_t* out, int64_t cap, int64_t* out_len,
                     int flags) {
  (void)flags;
  int64_t pos = 0;
  for (int64_t i = 0; i < n; i++) {
    uint32_t cp = in[i];
    if (cp > 0x10FFFF || decoder_is_surrogate(cp) || decoder_is_noncharacter(cp))
      continue;
    if (pos < cap) out[pos++] = cp;
  }
  *out_len = pos;
  return 0;
}

// 1 iff the codepoint stream contains no surrogate, noncharacter, or
// out-of-range value (reference `decoder_is_well_formed`, oracle-pinned).
int decoder_is_well_formed(const uint32_t* in, int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    uint32_t cp = in[i];
    if (cp > 0x10FFFF || decoder_is_surrogate(cp) || decoder_is_noncharacter(cp))
      return 0;
  }
  return 1;
}

// ── UTF-16 / UTF-32 transcoding ──────────────────────────────────────
int decoder_is_valid_utf16(const uint16_t* in, int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    uint16_t u = in[i];
    if (u >= 0xD800 && u <= 0xDBFF) {
      if (i + 1 >= n || in[i+1] < 0xDC00 || in[i+1] > 0xDFFF) return 0;
      i++;
    } else if (u >= 0xDC00 && u <= 0xDFFF) {
      return 0;
    }
  }
  return 1;
}

int64_t decoder_utf16_to_utf32(const uint16_t* in, int64_t n, uint32_t* out, int64_t cap) {
  int64_t m = 0;
  for (int64_t i = 0; i < n; i++) {
    uint32_t cp;
    uint16_t u = in[i];
    if (u >= 0xD800 && u <= 0xDBFF) {
      if (i + 1 >= n || in[i+1] < 0xDC00 || in[i+1] > 0xDFFF) return -3;
      cp = 0x10000 + (((uint32_t)(u - 0xD800) << 10) | (in[i+1] - 0xDC00));
      i++;
    } else if (u >= 0xDC00 && u <= 0xDFFF) {
      return -3;
    } else {
      cp = u;
    }
    if (m >= cap) return -2;
    out[m++] = cp;
  }
  return m;
}

int64_t decoder_utf32_to_utf16(const uint32_t* in, int64_t n, uint16_t* out, int64_t cap) {
  int64_t m = 0;
  for (int64_t i = 0; i < n; i++) {
    uint32_t cp = in[i];
    if (cp > 0x10FFFF || (cp >= 0xD800 && cp <= 0xDFFF)) return -3;
    if (cp >= 0x10000) {
      if (m + 2 > cap) return -2;
      cp -= 0x10000;
      out[m++] = (uint16_t)(0xD800 + (cp >> 10));
      out[m++] = (uint16_t)(0xDC00 + (cp & 0x3FF));
    } else {
      if (m + 1 > cap) return -2;
      out[m++] = (uint16_t)cp;
    }
  }
  return m;
}

int64_t decoder_utf32_to_utf8(const uint32_t* in, int64_t n, uint8_t* out, int64_t cap) {
  int64_t pos = 0;
  for (int64_t i = 0; i < n; i++) {
    if (in[i] > 0x10FFFF || (in[i] >= 0xD800 && in[i] <= 0xDFFF)) return -3;
    if (pos + 4 > cap) return -2;
    pos += utf8_encode_one(in[i], out + pos);
  }
  return pos;
}

int64_t decoder_utf8_to_utf16(const uint8_t* in, int64_t len, uint16_t* out, int64_t cap) {
  std::vector<uint32_t> cps((size_t)len);
  int64_t n = utf8_decode(in, len, cps.data());
  if (n < 0) return -3;
  return decoder_utf32_to_utf16(cps.data(), n, out, cap);
}

int64_t decoder_utf16_to_utf8(const uint16_t* in, int64_t n, uint8_t* out, int64_t cap) {
  std::vector<uint32_t> cps((size_t)n);
  int64_t m = decoder_utf16_to_utf32(in, n, cps.data(), n);
  if (m < 0) return m;
  return decoder_utf32_to_utf8(cps.data(), m, out, cap);
}

// UTF-8 byte length a codepoint array would encode to.
// Reference semantics (oracle-probed): despite the name, this takes
// UTF-8 BYTES and returns the CODEPOINT count (the reference's JS doc
// claims byte length — its binary counts codepoints).
int64_t decoder_utf8_length(const uint8_t* in, int64_t len) {
  return utf8_decode(in, len, nullptr);
}

// Encoded byte length of a codepoint array (the pre-rename behavior,
// kept as an extra export).
int64_t decoder_utf8_encoded_length(const uint32_t* in, int64_t n) {
  int64_t len = 0;
  for (int64_t i = 0; i < n; i++) {
    uint32_t cp = in[i];
    len += cp <= 0x7F ? 1 : cp <= 0x7FF ? 2 : cp <= 0xFFFF ? 3 : 4;
  }
  return len;
}

// ── batch classification (pre-tokenizer hot path) ────────────────────
// UTF-8 bytes -> per-codepoint CharClass. Returns 0, -3 on invalid UTF-8.
int decoder_classify_codepoints(const uint8_t* in, int64_t len,
                                uint8_t* classes, int64_t cap, int64_t* count) {
  std::vector<uint32_t> cps((size_t)len);
  int64_t n = utf8_decode(in, len, cps.data());
  if (n < 0 || n > cap) return -3;
  for (int64_t i = 0; i < n; i++) classes[i] = class_of(cps[i]);
  *count = n;
  return 0;
}

// classify an array of codepoints directly
void decoder_classify_utf32(const uint32_t* cps, int64_t n, uint8_t* classes) {
  for (int64_t i = 0; i < n; i++) classes[i] = class_of(cps[i]);
}

// ── fused pre-tokenization kernel (normalize + classify + decode) ────
// NFC-normalizes UTF-8 bytes and emits (normalized bytes, per-codepoint
// classes, per-codepoint byte offsets) in one pass — everything the word
// boundary pass needs. Returns 0, -3 invalid, -2 buffer too small.
int decoder_pretokenize_prepare(const uint8_t* in, int64_t len,
                                uint8_t* out, int64_t out_cap, int64_t* out_len,
                                uint32_t* cps_out, uint8_t* classes, uint32_t* offsets,
                                int64_t cp_cap, int64_t* cp_count) {
  // ASCII fast path: NFC is the identity, one byte per codepoint. Real
  // corpora are dominated by ASCII; this skips the decode/normalize/encode
  // machinery entirely (~20x on pure-ASCII input).
  bool ascii = true;
  for (int64_t i = 0; i < len; i++) {
    if (in[i] >= 0x80) { ascii = false; break; }
  }
  if (ascii) {
    if (len > cp_cap || len > out_cap) return -2;
    static uint8_t ascii_class[128];
    static bool ascii_init = false;
    if (!ascii_init) {
      for (uint32_t c = 0; c < 128; c++) ascii_class[c] = class_of(c);
      ascii_init = true;
    }
    std::memcpy(out, in, (size_t)len);
    for (int64_t i = 0; i < len; i++) {
      cps_out[i] = in[i];
      classes[i] = ascii_class[in[i]];
      offsets[i] = (uint32_t)i;
    }
    *out_len = len;
    *cp_count = len;
    return 0;
  }

  std::vector<uint32_t> cps((size_t)len);
  int64_t n = utf8_decode(in, len, cps.data());
  if (n < 0) return -3;
  cps.resize((size_t)n);
  normalize_cps(cps, 0);
  if ((int64_t)cps.size() > cp_cap) return -2;
  int64_t pos = 0;
  for (size_t i = 0; i < cps.size(); i++) {
    if (pos + 4 > out_cap) return -2;
    cps_out[i] = cps[i];
    classes[i] = class_of(cps[i]);
    offsets[i] = (uint32_t)pos;
    pos += utf8_encode_one(cps[i], out + pos);
  }
  *out_len = pos;
  *cp_count = (int64_t)cps.size();
  return 0;
}

// ── GPT-4-style word boundary rules (pre_tokenizer.mjs:226-292) ──────
// Sequential rule engine over (codepoints, classes) — the reference's CPU
// hot loop #1, here in native code. CharClass enum: 0=LETTER 1=DIGIT
// 2=WHITESPACE 3=PUNCTUATION 4=SYMBOL 5=NEWLINE 6=OTHER.
static int match_contraction(const uint32_t* cps, const uint8_t* classes,
                             int64_t n, int64_t i) {
  if (i + 1 >= n) return 0;
  uint32_t nxt = cps[i + 1];
  bool after1 = i + 2 >= n || classes[i + 2] != 0;
  switch (nxt) {
    case 's': case 'S': case 't': case 'T': case 'm': case 'M':
    case 'd': case 'D':
      if (after1) return 2;
      break;
    default:
      break;
  }
  if (i + 2 < n) {
    uint32_t n2 = cps[i + 2];
    bool after2 = i + 3 >= n || classes[i + 3] != 0;
    if (after2) {
      bool re = (nxt == 'r' || nxt == 'R') && (n2 == 'e' || n2 == 'E');
      bool ve = (nxt == 'v' || nxt == 'V') && (n2 == 'e' || n2 == 'E');
      bool ll = (nxt == 'l' || nxt == 'L') && (n2 == 'l' || n2 == 'L');
      if (re || ve || ll) return 3;
    }
  }
  return 0;
}

void decoder_find_word_boundaries(const uint32_t* cps, const uint8_t* classes,
                                  int64_t n, uint8_t* starts) {
  if (n <= 0) return;
  std::memset(starts, 0, (size_t)n);
  starts[0] = 1;
  static const bool kTransition[7][7] = {
      // to:  L      D      W      P      S      N      O     from:
      {false, true,  false, true,  true,  false, false},  // LETTER
      {true,  false, false, true,  true,  false, false},  // DIGIT
      {false, false, false, false, false, false, false},  // WHITESPACE
      {true,  true,  false, false, false, false, false},  // PUNCTUATION
      {true,  true,  false, false, false, false, false},  // SYMBOL
      {false, false, false, false, false, false, false},  // NEWLINE
      {false, false, false, false, false, false, false},  // OTHER
  };
  int64_t i = 1;
  while (i < n) {
    uint8_t prev = classes[i - 1], curr = classes[i];
    if (curr == 5 || prev == 5) { starts[i] = 1; i++; continue; }
    if (curr == 2) { if (prev != 2) starts[i] = 1; i++; continue; }
    if (prev == 2) { i++; continue; }
    if (prev == 0 && (cps[i] == 0x27 || cps[i] == 0x2019)) {
      int consumed = match_contraction(cps, classes, n, i);
      if (consumed > 0) { i += consumed; continue; }
    }
    if (prev < 7 && curr < 7 && kTransition[prev][curr]) { starts[i] = 1; i++; continue; }
    if (curr == 1 && prev == 1) {
      int64_t run_start = i - 1;
      while (run_start > 0 && classes[run_start - 1] == 1) run_start--;
      if ((i - run_start) % 3 == 0) starts[i] = 1;
      i++;
      continue;
    }
    i++;
  }
}

// codepoint-level word starts -> byte-level mask (scatter through the
// UTF-8 byte offsets from decoder_pretokenize_prepare). Out-of-range
// offsets are dropped — the reference's JS typed-array OOB semantics
// (pre_tokenizer.mjs byte mapping), replicated by the Python path too.
void decoder_byte_word_starts(const uint32_t* offsets, const uint8_t* cp_starts,
                              int64_t n_cps, uint8_t* out, int64_t n_bytes) {
  if (n_bytes <= 0) return;
  std::memset(out, 0, (size_t)n_bytes);
  for (int64_t i = 0; i < n_cps; ++i) {
    if (cp_starts[i] && (int64_t)offsets[i] < n_bytes) out[offsets[i]] = 1;
  }
}

// ── scripts / blocks / identifier security ──────────────────────────
static int range_value_u16(const uint32_t* starts, const uint16_t* values,
                           uint32_t count, uint32_t cp) {
  if (cp >= kMaxCp || count == 0) return 0;
  uint32_t lo = 0, hi = count;
  while (hi - lo > 1) {
    uint32_t mid = (lo + hi) >> 1;
    if (starts[mid] <= cp) lo = mid; else hi = mid;
  }
  return values[lo];
}

static int in_range_set(const uint32_t* starts, const uint32_t* ends,
                        uint32_t count, uint32_t cp) {
  if (count == 0) return 0;
  uint32_t lo = 0, hi = count;
  while (lo < hi) {
    uint32_t mid = (lo + hi) >> 1;
    if (ends[mid] <= cp) lo = mid + 1; else hi = mid;
  }
  return lo < count && starts[lo] <= cp;
}

int decoder_get_script(uint32_t cp) {
  return range_value_u16(kScriptRangeStart, kScriptRangeValue, kScriptRangeCount, cp);
}
int decoder_get_block(uint32_t cp) {
  return range_value_u16(kBlockRangeStart, kBlockRangeValue, kBlockRangeCount, cp);
}
int decoder_is_in_block(uint32_t cp, int block) { return decoder_get_block(cp) == block; }

const char* decoder_get_script_name(int script_id) {
  if (script_id < 0 || (uint32_t)script_id >= kScriptNameCount) return "";
  return kScriptNames[script_id];
}
// Reference ABI: takes a CODEPOINT, returns the UCD block display name
// ("Latin-1 Supplement"); table sweep-extracted from the binary.
const char* decoder_get_block_name(uint32_t cp) {
  if (kRefBlockCount == 0 || cp > 0x10FFFF) return "";
  uint32_t lo = 0, hi = kRefBlockCount;
  while (hi - lo > 1) {
    uint32_t mid = (lo + hi) >> 1;
    if (kRefBlockStart[mid] <= cp) lo = mid; else hi = mid;
  }
  return kRefBlockNames[kRefBlockNameIdx[lo]];
}

// By-internal-id block name (extra; pairs with decoder_get_block's
// regex-module block ids).
const char* decoder_get_block_id_name(int block_id) {
  if (block_id < 0 || (uint32_t)block_id >= kBlockNameCount) return "";
  return kBlockNames[block_id];
}

// ── confusables (UTS #39, the reference's exact extracted table) ─────
// kConfusableCp/kConfusableSkel carry the 6,558-entry prototype map
// extracted from decoder.wasm's confusables hash table and verified
// entry-by-entry against the live oracle (scripts/extract_confusables.py).
// proto(x) = table prototype's first codepoint, or x when unmapped.
static uint32_t skeleton_cp(uint32_t cp) {
  int32_t m = sparse_map(kConfusableCp, kConfusableSkel, kConfusableCount, cp);
  return m >= 0 ? (uint32_t)m : cp;
}

// Reference semantics (oracle-pinned): confusable iff the codepoints are
// DISTINCT and share a prototype. Identical codepoints are not confusable
// — decoder_is_confusable(a, a) == 0, even for mapped a.
int decoder_is_confusable(uint32_t a, uint32_t b) {
  return a != b && skeleton_cp(a) == skeleton_cp(b);
}

// 1 iff the cp has a confusable prototype entry (extra helper beyond the
// reference's export surface; its old 1-arg decoder_is_confusable role).
int decoder_has_confusable_mapping(uint32_t cp) {
  return sparse_map(kConfusableCp, kConfusableSkel, kConfusableCount, cp) >= 0;
}

// Prototype length from the reference table (1 when unmapped). The
// reference binary dead-strips multi-char continuation pools, so only
// the first prototype cp + this length are observable.
int decoder_confusable_proto_len(uint32_t cp) {
  int64_t lo = 0, hi = (int64_t)kConfusableCount - 1;
  while (lo <= hi) {
    int64_t mid = (lo + hi) >> 1;
    if (kConfusableCp[mid] < cp) lo = mid + 1;
    else if (kConfusableCp[mid] > cp) hi = mid - 1;
    else return kConfusableProtoLen[mid];
  }
  return 1;
}

// Reference semantics (oracle-pinned): equal length AND positionwise
// prototype equality. No normalization, case folding, or multi-char
// prototype expansion — decoder_check_confusables("ﬁ", "fi") == 0
// in the reference because the lengths differ.
int decoder_check_confusables(const uint32_t* a, int64_t an,
                              const uint32_t* b, int64_t bn) {
  if (an != bn) return 0;
  for (int64_t i = 0; i < an; i++)
    if (skeleton_cp(a[i]) != skeleton_cp(b[i])) return 0;
  return 1;
}

// Widened skeleton (extra capability beyond the reference): NFKD (native
// tables: folds fullwidth, mathematical alphanumerics, ligatures,
// enclosed forms) -> full case fold -> prototype map, with combining
// marks dropped (zalgo-style decorations don't defeat it).
// Only single-cp prototypes are applied here: a multi-char table entry
// (e.g. fi-ligature -> "fi") carries just its first cp in the reference
// binary, and mapping through it would LOSE characters that NFKD expands
// correctly.
static uint32_t skeleton_cp_widened(uint32_t cp) {
  return decoder_confusable_proto_len(cp) == 1 ? skeleton_cp(cp) : cp;
}

// Order matters: fold BEFORE mapping (the table maps 'I'->'l', so mapping
// first would send "FILE" to "flle" while "file" stays — fold-first keeps
// case variants of the same string on one skeleton).
static void skeleton_str(const uint32_t* s, int64_t n, std::vector<uint32_t>& out) {
  uint32_t buf[4];
  std::vector<uint32_t> dec;
  for (int64_t i = 0; i < n; i++) {
    dec.clear();
    decompose_cp(s[i], dec, /*compat=*/true);
    for (uint32_t d : dec) {
      if (ccc_of(d) != 0) continue;  // strip combining decorations
      int m = decoder_case_fold_full(d, buf, 4);
      for (int k = 0; k < m; k++) out.push_back(skeleton_cp_widened(buf[k]));
    }
  }
}

// Widened-skeleton string comparison (extra export; the pre-extraction
// behavior of decoder_check_confusables, kept for spoof detection that
// the reference's positionwise rule cannot catch, e.g. ligatures).
int decoder_check_confusables_widened(const uint32_t* a, int64_t an,
                                      const uint32_t* b, int64_t bn) {
  std::vector<uint32_t> sa, sb;
  skeleton_str(a, an, sa);
  skeleton_str(b, bn, sb);
  return sa == sb;
}

// Widened skeleton of a string (extra export). Returns the skeleton
// length, truncating at cap.
int64_t decoder_get_skeleton(const uint32_t* in, int64_t n,
                             uint32_t* out, int64_t cap) {
  std::vector<uint32_t> sk;
  skeleton_str(in, n, sk);
  int64_t m = (int64_t)sk.size();
  for (int64_t i = 0; i < m && i < cap; i++) out[i] = sk[i];
  return m;
}

// Reference parity: its identifier sets are range-generalized (cover
// unassigned gaps, exclude e.g. U+00B7) — sweep-extracted.  The true
// UAX #31 XID sets are the *_xid_* extras below.
int decoder_is_identifier_start(uint32_t cp) {
  return in_range_set(kXidStartStart, kXidStartEnd, kXidStartCount, cp);
}
int decoder_is_identifier_continue(uint32_t cp) {
  return in_range_set(kXidContinueStart, kXidContinueEnd, kXidContinueCount, cp);
}
int decoder_is_xid_start(uint32_t cp) {
  return in_range_set(kXidStartUaxStart, kXidStartUaxEnd, kXidStartUaxCount, cp);
}
int decoder_is_xid_continue(uint32_t cp) {
  return in_range_set(kXidContinueUaxStart, kXidContinueUaxEnd, kXidContinueUaxCount, cp);
}
int decoder_is_pattern_syntax(uint32_t cp) {
  return in_range_set(kPatternSyntaxStart, kPatternSyntaxEnd, kPatternSyntaxCount, cp);
}
int decoder_is_pattern_whitespace(uint32_t cp) {
  return in_range_set(kPatternWsStart, kPatternWsEnd, kPatternWsCount, cp);
}

// Mixed-script detection (UTS #39 style): suspicious when a single "word"
// mixes multiple non-Common/Inherited scripts (excluding sanctioned CJK
// combinations). Basis of the reference's decoder_is_suspicious.
// Reference semantics (oracle-pinned, validated by exhaustive singleton
// sweep + randomized string fuzz against decoder.wasm):
//   suspicious iff (a) any cp has a confusables-table entry and is
//   non-ASCII, (b) any cp is in the extra singleton set (C0 controls
//   minus \t\n\r, bidi/ZW format controls, private use, noncharacters,
//   a few punctuation singletons — kSuspExtra*, extracted from the
//   reference), or (c) the string mixes >=2 distinct script ids,
//   excluding COMMON/INHERITED but counting UNKNOWN; no CJK sanctioning
//   (Han+Hiragana IS suspicious in the reference).
int decoder_is_suspicious(const uint32_t* cps, int64_t n) {
  if (n <= 0) return 0;
  // the reference anchors on the FIRST cp's script verbatim: a Common or
  // Inherited first cp disables the mixed-script clause for the whole
  // string ("1aΩ" is not suspicious, "a1Ω" is — oracle-pinned), and
  // UNKNOWN(0) is a real base.
  int base = decoder_get_script(cps[0]);
  bool script_clause = (base != 1 && base != 2);
  for (int64_t i = 0; i < n; i++) {
    uint32_t cp = cps[i];
    if (cp > 0x7F && decoder_has_confusable_mapping(cp)) return 1;
    if (in_range_set(kSuspExtraStart, kSuspExtraEnd, kSuspExtraCount, cp)) return 1;
    if (script_clause && i > 0) {
      int s = decoder_get_script(cp);
      if (s != base && s != 1 && s != 2) return 1;
    }
  }
  return 0;
}

// The round-1 mixed-script heuristic (sanctions Han+kana/Hangul combos)
// survives as an extra export for callers who want UTS #39-style
// highly-restrictive checking rather than the reference's strict rule.
int decoder_is_mixed_script(const uint32_t* cps, int64_t n) {
  int base = 0;  // 0=unknown/common
  for (int64_t i = 0; i < n; i++) {
    int s = decoder_get_script(cps[i]);
    if (s <= 2) continue;  // UNKNOWN / COMMON / INHERITED
    // Han(37) combines with Hiragana(34)/Katakana(35)/Hangul(26)/Bopomofo(36)
    bool cjk = (s == 37 || s == 34 || s == 35 || s == 26 || s == 36);
    if (base == 0) { base = cjk ? 37 : s; continue; }
    bool base_cjk = (base == 37);
    if (cjk && base_cjk) continue;
    if (s != base) return 1;
  }
  return 0;
}

// ── segmentation: full UAX #29 rule engines ──────────────────────────
// Classes come from generated RLE tables (Grapheme_Cluster_Break,
// Word_Break, Sentence_Break, Extended_Pictographic, Indic_Conjunct_Break
// — ids fixed in gen_tables.py). Boundary queries are O(local run).

static uint8_t range_value_u8(const uint32_t* starts, const uint8_t* values,
                              uint32_t count, uint32_t cp) {
  if (cp >= kMaxCp || count == 0) return 0;
  uint32_t lo = 0, hi = count;
  while (hi - lo > 1) {
    uint32_t mid = (lo + hi) >> 1;
    if (starts[mid] <= cp) lo = mid; else hi = mid;
  }
  return values[lo];
}

// enums mirror GCB_VALUES / WB_VALUES / SB_VALUES in gen_tables.py
enum {
  GCB_OTHER = 0, GCB_CONTROL, GCB_LF, GCB_CR, GCB_EXTEND, GCB_PREPEND,
  GCB_SPACINGMARK, GCB_L, GCB_V, GCB_T, GCB_ZWJ, GCB_LV, GCB_LVT, GCB_RI,
};
enum {
  WB_OTHER = 0, WB_CR, WB_LF, WB_NL, WB_EXTEND, WB_ZWJ, WB_RI, WB_FORMAT,
  WB_KATAKANA, WB_HL, WB_ALETTER, WB_SQ, WB_DQ, WB_MIDNUMLET, WB_MIDLETTER,
  WB_MIDNUM, WB_NUMERIC, WB_EXTENDNUMLET, WB_WSEGSPACE,
};
enum {
  SB_OTHER = 0, SB_CR, SB_LF, SB_EXTEND, SB_SEP, SB_FORMAT, SB_SP, SB_LOWER,
  SB_UPPER, SB_OLETTER, SB_NUMERIC, SB_ATERM, SB_STERM, SB_CLOSE, SB_SCONT,
};

static inline uint8_t gcb_of(uint32_t cp) {
  return range_value_u8(kGcbRangeStart, kGcbRangeValue, kGcbRangeCount, cp);
}
static inline uint8_t wb_of(uint32_t cp) {
  return range_value_u8(kWbRangeStart, kWbRangeValue, kWbRangeCount, cp);
}
static inline uint8_t sb_of(uint32_t cp) {
  return range_value_u8(kSbRangeStart, kSbRangeValue, kSbRangeCount, cp);
}
static inline uint8_t incb_of(uint32_t cp) {
  return range_value_u8(kIncbRangeStart, kIncbRangeValue, kIncbRangeCount, cp);
}
static inline bool ext_pict(uint32_t cp) {
  return in_range_set(kExtPictStart, kExtPictEnd, kExtPictCount, cp);
}

// Grapheme cluster boundary between cps[pos-1] and cps[pos] (GB1..GB999,
// incl. GB9c Indic conjuncts, GB11 emoji ZWJ sequences, GB12/13 flags).
static bool grapheme_boundary(const uint32_t* cps, int64_t pos) {
  uint8_t p = gcb_of(cps[pos - 1]), c = gcb_of(cps[pos]);
  if (p == GCB_CR && c == GCB_LF) return false;                          // GB3
  if (p == GCB_CONTROL || p == GCB_CR || p == GCB_LF) return true;       // GB4
  if (c == GCB_CONTROL || c == GCB_CR || c == GCB_LF) return true;       // GB5
  if (p == GCB_L &&
      (c == GCB_L || c == GCB_V || c == GCB_LV || c == GCB_LVT)) return false;  // GB6
  if ((p == GCB_LV || p == GCB_V) && (c == GCB_V || c == GCB_T)) return false;  // GB7
  if ((p == GCB_LVT || p == GCB_T) && c == GCB_T) return false;          // GB8
  if (c == GCB_EXTEND || c == GCB_ZWJ) return false;                     // GB9
  if (c == GCB_SPACINGMARK) return false;                                // GB9a
  if (p == GCB_PREPEND) return false;                                    // GB9b
  if (incb_of(cps[pos]) == 1) {                                          // GB9c
    int64_t i = pos - 1;
    bool linker = false;
    while (i >= 0) {
      uint8_t ic = incb_of(cps[i]);
      if (ic == 3) { linker = true; i--; }
      else if (ic == 2) { i--; }
      else break;
    }
    if (linker && i >= 0 && incb_of(cps[i]) == 1) return false;
  }
  if (p == GCB_ZWJ && ext_pict(cps[pos])) {                              // GB11
    int64_t i = pos - 2;
    while (i >= 0 && gcb_of(cps[i]) == GCB_EXTEND) i--;
    if (i >= 0 && ext_pict(cps[i])) return false;
  }
  if (p == GCB_RI && c == GCB_RI) {                                      // GB12/13
    int64_t count = 0;
    for (int64_t i = pos - 1; i >= 0 && gcb_of(cps[i]) == GCB_RI; i--) count++;
    if (count % 2 == 1) return false;
  }
  return true;                                                           // GB999
}

static inline bool wb_ignorable(uint8_t w) {
  return w == WB_EXTEND || w == WB_FORMAT || w == WB_ZWJ;  // WB4
}
static inline bool wb_ahletter(uint8_t w) { return w == WB_ALETTER || w == WB_HL; }
static inline bool wb_midnumletq(uint8_t w) { return w == WB_MIDNUMLET || w == WB_SQ; }

// class of the nearest non-ignorable at or left of i (-1 if none)
static int wb_left(const uint32_t* cps, int64_t i) {
  for (; i >= 0; i--) {
    uint8_t w = wb_of(cps[i]);
    if (!wb_ignorable(w)) return w;
  }
  return -1;
}
static int wb_right(const uint32_t* cps, int64_t n, int64_t i) {
  for (; i < n; i++) {
    uint8_t w = wb_of(cps[i]);
    if (!wb_ignorable(w)) return w;
  }
  return -1;
}
// index (not class) of nearest non-ignorable strictly left of i
static int64_t wb_left_idx(const uint32_t* cps, int64_t i) {
  for (; i >= 0; i--) {
    if (!wb_ignorable(wb_of(cps[i]))) return i;
  }
  return -1;
}

// Word boundary between cps[pos-1] and cps[pos] (WB1..WB999).
static bool word_boundary(const uint32_t* cps, int64_t n, int64_t pos) {
  uint8_t pr = wb_of(cps[pos - 1]), cr = wb_of(cps[pos]);
  if (pr == WB_CR && cr == WB_LF) return false;                          // WB3
  if (pr == WB_NL || pr == WB_CR || pr == WB_LF) return true;            // WB3a
  if (cr == WB_NL || cr == WB_CR || cr == WB_LF) return true;            // WB3b
  if (pr == WB_ZWJ && ext_pict(cps[pos])) return false;                  // WB3c
  if (pr == WB_WSEGSPACE && cr == WB_WSEGSPACE) return false;           // WB3d
  if (wb_ignorable(cr)) return false;                                    // WB4 (×)
  int p = wb_left(cps, pos - 1);
  if (p < 0) return true;  // only ignorables before: no rule joins -> WB999
  uint8_t c = cr;
  int64_t pi = wb_left_idx(cps, pos - 1);
  int pp = pi > 0 ? wb_left(cps, pi - 1) : -1;
  int nx = wb_right(cps, n, pos + 1);
  if (wb_ahletter(p) && wb_ahletter(c)) return false;                    // WB5
  if (wb_ahletter(p) && (c == WB_MIDLETTER || wb_midnumletq(c)) &&
      nx >= 0 && wb_ahletter(nx)) return false;                          // WB6
  if ((p == WB_MIDLETTER || wb_midnumletq(p)) && wb_ahletter(c) &&
      pp >= 0 && wb_ahletter(pp)) return false;                          // WB7
  if (p == WB_HL && c == WB_SQ) return false;                            // WB7a
  if (p == WB_HL && c == WB_DQ && nx == WB_HL) return false;             // WB7b
  if (p == WB_DQ && c == WB_HL && pp == WB_HL) return false;             // WB7c
  if (p == WB_NUMERIC && c == WB_NUMERIC) return false;                  // WB8
  if (wb_ahletter(p) && c == WB_NUMERIC) return false;                   // WB9
  if (p == WB_NUMERIC && wb_ahletter(c)) return false;                   // WB10
  if ((p == WB_MIDNUM || wb_midnumletq(p)) && c == WB_NUMERIC &&
      pp == WB_NUMERIC) return false;                                    // WB11
  if (p == WB_NUMERIC && (c == WB_MIDNUM || wb_midnumletq(c)) &&
      nx == WB_NUMERIC) return false;                                    // WB12
  if (p == WB_KATAKANA && c == WB_KATAKANA) return false;                // WB13
  if ((wb_ahletter(p) || p == WB_NUMERIC || p == WB_KATAKANA ||
       p == WB_EXTENDNUMLET) && c == WB_EXTENDNUMLET) return false;      // WB13a
  if (p == WB_EXTENDNUMLET &&
      (wb_ahletter(c) || c == WB_NUMERIC || c == WB_KATAKANA)) return false;  // WB13b
  if (p == WB_RI && c == WB_RI) {                                        // WB15/16
    int64_t count = 0;
    for (int64_t i = pi; i >= 0; i--) {
      uint8_t w = wb_of(cps[i]);
      if (wb_ignorable(w)) continue;
      if (w != WB_RI) break;
      count++;
    }
    if (count % 2 == 1) return false;
  }
  return true;                                                           // WB999
}

static inline bool sb_ignorable(uint8_t s) { return s == SB_EXTEND || s == SB_FORMAT; }
static inline bool sb_parasep(uint8_t s) { return s == SB_SEP || s == SB_CR || s == SB_LF; }
static inline bool sb_saterm(uint8_t s) { return s == SB_ATERM || s == SB_STERM; }

static int sb_left(const uint32_t* cps, int64_t i, int64_t* idx) {
  for (; i >= 0; i--) {
    uint8_t s = sb_of(cps[i]);
    if (!sb_ignorable(s)) { if (idx) *idx = i; return s; }
  }
  if (idx) *idx = -1;
  return -1;
}

// Matches backwards from index i (inclusive): Sp* then Close* then SATerm.
// Returns the SATerm's skeleton index or -1. skip_sp selects whether Sp*
// may be consumed (SB8/8a/10/11 variants vs SB9, Close* only).
static int64_t sb_match_saterm(const uint32_t* cps, int64_t i, bool skip_sp) {
  int64_t idx;
  int s = sb_left(cps, i, &idx);
  if (skip_sp) {
    while (s == SB_SP) s = sb_left(cps, idx - 1, &idx);
  }
  while (s == SB_CLOSE) s = sb_left(cps, idx - 1, &idx);
  return (s >= 0 && sb_saterm((uint8_t)s)) ? idx : -1;
}

// Sentence boundary between cps[pos-1] and cps[pos] (SB1..SB998).
static bool sentence_boundary(const uint32_t* cps, int64_t n, int64_t pos) {
  uint8_t pr = sb_of(cps[pos - 1]), cr = sb_of(cps[pos]);
  if (pr == SB_CR && cr == SB_LF) return false;                          // SB3
  if (sb_parasep(pr)) return true;                                       // SB4
  if (sb_ignorable(cr)) return false;                                    // SB5 (×)
  int64_t pidx;
  int p = sb_left(cps, pos - 1, &pidx);
  if (p < 0) return false;  // only ignorables before -> SB998 no break
  uint8_t c = cr;
  if (p == SB_ATERM && c == SB_NUMERIC) return false;                    // SB6
  if (p == SB_ATERM && c == SB_UPPER) {                                  // SB7
    int64_t idx2;
    int pp = sb_left(cps, pidx - 1, &idx2);
    if (pp == SB_UPPER || pp == SB_LOWER) return false;
  }
  // SB8: ATerm Close* Sp* × (¬(OLetter|Upper|Lower|ParaSep|SATerm))* Lower
  {
    int64_t at = sb_match_saterm(cps, pidx, true);
    if (at >= 0 && sb_of(cps[at]) == SB_ATERM) {
      for (int64_t i = pos; i < n; i++) {
        uint8_t s = sb_of(cps[i]);
        if (sb_ignorable(s)) continue;
        if (s == SB_LOWER) return false;
        if (s == SB_OLETTER || s == SB_UPPER || sb_parasep(s) || sb_saterm(s))
          break;
      }
    }
  }
  // SB8a: SATerm Close* Sp* × (SContinue | SATerm)
  if (c == SB_SCONT || sb_saterm(c)) {
    if (sb_match_saterm(cps, pidx, true) >= 0) return false;
  }
  // SB9: SATerm Close* × (Close | Sp | ParaSep)
  if (c == SB_CLOSE || c == SB_SP || sb_parasep(c)) {
    if (sb_match_saterm(cps, pidx, false) >= 0) return false;
  }
  // SB10: SATerm Close* Sp* × (Sp | ParaSep)
  if (c == SB_SP || sb_parasep(c)) {
    if (sb_match_saterm(cps, pidx, true) >= 0) return false;
  }
  // SB11: SATerm Close* Sp* ParaSep? ÷ (ParaSep handled by SB4 above)
  if (sb_match_saterm(cps, pidx, true) >= 0) return true;
  return false;                                                          // SB998
}

// boundary BEFORE index pos (pos in [0, n]; 0 and n are always boundaries)
int decoder_is_grapheme_boundary(const uint32_t* cps, int64_t n, int64_t pos) {
  if (pos <= 0 || pos >= n) return 1;
  return grapheme_boundary(cps, pos);
}

int decoder_is_word_boundary(const uint32_t* cps, int64_t n, int64_t pos) {
  if (pos <= 0 || pos >= n) return 1;
  return word_boundary(cps, n, pos);
}

int decoder_is_sentence_boundary(const uint32_t* cps, int64_t n, int64_t pos) {
  if (pos <= 0 || pos >= n) return 1;
  return sentence_boundary(cps, n, pos);
}

// next boundary strictly after pos (returns n when none)
int64_t decoder_next_grapheme(const uint32_t* cps, int64_t n, int64_t pos) {
  for (int64_t i = pos + 1; i < n; i++) {
    if (grapheme_boundary(cps, i)) return i;
  }
  return n;
}

int64_t decoder_next_word(const uint32_t* cps, int64_t n, int64_t pos) {
  for (int64_t i = pos + 1; i < n; i++) {
    if (word_boundary(cps, n, i)) return i;
  }
  return n;
}

int64_t decoder_next_sentence(const uint32_t* cps, int64_t n, int64_t pos) {
  for (int64_t i = pos + 1; i < n; i++) {
    if (sentence_boundary(cps, n, i)) return i;
  }
  return n;
}

int64_t decoder_count_graphemes(const uint32_t* cps, int64_t n) {
  if (n <= 0) return 0;
  int64_t count = 1;
  for (int64_t i = 1; i < n; i++) {
    if (grapheme_boundary(cps, i)) count++;
  }
  return count;
}

// words = UAX #29 segments containing a letter/number unit (the ICU
// "word count" convention)
int64_t decoder_count_words(const uint32_t* cps, int64_t n) {
  int64_t count = 0;
  bool has_word_char = false;
  for (int64_t i = 0; i < n; i++) {
    if (i > 0 && word_boundary(cps, n, i)) {
      if (has_word_char) count++;
      has_word_char = false;
    }
    uint8_t w = wb_of(cps[i]);
    if (wb_ahletter(w) || w == WB_NUMERIC || w == WB_KATAKANA ||
        w == WB_EXTENDNUMLET) has_word_char = true;
  }
  if (has_word_char) count++;
  return count;
}

// sentences = UAX #29 segments containing any non-whitespace
int64_t decoder_count_sentences(const uint32_t* cps, int64_t n) {
  int64_t count = 0;
  bool has_content = false;
  for (int64_t i = 0; i < n; i++) {
    if (i > 0 && sentence_boundary(cps, n, i)) {
      if (has_content) count++;
      has_content = false;
    }
    uint8_t cl = class_of(cps[i]);
    if (cl != 2 && cl != 5) has_content = true;  // not WS/NL
  }
  if (has_content) count++;
  return count;
}

}  // extern "C"
