"""Hugging Face ``tokenizer.json`` interop for byte-level BPE (the port's own
copy of ``gpu_bpe_tpu/core/hf_io.py``; same output bytes).

* ``model_to_hf_json(model)``: export a trained model as a byte-level BPE
  ``tokenizer.json``. Token byte sequences are mapped through the GPT-2
  byte->unicode table, and merges keep training order (= HF rank order).
  With the default ``pretok="none"`` the exported tokenizer's encode is
  exactly ``encode_merge_order`` over the same bytes: applying merge rules
  in rank order equals HF's lowest-rank-first strategy, because a merge at
  rank r only creates adjacencies involving its new output token, so no
  rule of rank < r ever becomes newly applicable. ``pretok="byte-level"``
  emits the GPT-2 pre-split regex instead (word-bounded merges; not this
  package's pre-tokenizer rules).
* ``model_from_hf_json(text)``: import any byte-level BPE ``tokenizer.json``
  (e.g. the GPT-2/RoBERTa family) keeping its token ids, so the bulk
  tokenizer, the trie and the DXFT export can serve existing vocabularies.
  Gaps in the id space become empty entries (decoded as U+FFFD, skipped by
  the trie).
"""

from __future__ import annotations

import json
from functools import lru_cache

from .model_io import BPEModel


@lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """The GPT-2 byte→printable-unicode bijection (openai/gpt-2 encoder.py).

    Printable latin ranges map to themselves; the remaining bytes map to
    U+0100.. in order. This is the table every HF byte-level tokenizer uses.
    """
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAD))
        + list(range(0xAE, 0x100))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@lru_cache(maxsize=1)
def unicode_to_bytes() -> dict[str, int]:
    return {c: b for b, c in bytes_to_unicode().items()}


def token_bytes_to_hf(entry: bytes) -> str:
    table = bytes_to_unicode()
    return "".join(table[b] for b in entry)


def hf_token_to_bytes(s: str) -> bytes:
    table = unicode_to_bytes()
    try:
        return bytes(table[ch] for ch in s)
    except KeyError as e:
        raise ValueError(
            f"token {s!r} contains {e.args[0]!r}, which is not in the "
            "byte-level alphabet — not a byte-level BPE vocabulary"
        ) from None


_BYTE_LEVEL_DECODER = {
    "type": "ByteLevel",
    "add_prefix_space": True,
    "trim_offsets": True,
    "use_regex": True,
}


def model_to_hf_obj(model: BPEModel, pretok: str = "none") -> dict:
    """Build the ``tokenizer.json`` object for a trained model.

    pretok="none": pure byte mapping, no splitting — encode is exactly
    merge-order BPE over the whole byte stream (our ``encode()`` semantics,
    tokenizer-manager.js:13-61). pretok="byte-level": GPT-2 regex
    pre-splitting (ecosystem standard; merges stay within words).
    """
    if pretok not in ("none", "byte-level"):
        raise ValueError(f"unknown pretok mode {pretok!r}")

    vocab: dict[str, int] = {}
    dups: list[tuple[int, int, str]] = []
    for tid, entry in enumerate(model.vocab):
        s = token_bytes_to_hf(bytes(entry))
        if s in vocab:
            dups.append((vocab[s], tid, s))
        else:
            vocab[s] = tid
    if dups:
        a, b, s = dups[0]
        raise ValueError(
            f"vocabulary has {len(dups)} duplicate byte sequence(s) "
            f"(e.g. ids {a} and {b} are both {s!r}); the HF vocab is keyed "
            "by token string and cannot represent duplicates"
        )

    merges: list[list[str]] = []
    for a, b, new_id in model.merges:
        sa = token_bytes_to_hf(bytes(model.vocab[a]))
        sb = token_bytes_to_hf(bytes(model.vocab[b]))
        if vocab.get(sa + sb) != new_id:
            raise ValueError(
                f"merge ({a},{b})->{new_id} does not concatenate to the "
                f"vocab entry at id {new_id}; model is inconsistent"
            )
        merges.append([sa, sb])

    return {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": [],
        "normalizer": None,
        "pre_tokenizer": {
            "type": "ByteLevel",
            "add_prefix_space": False,
            "trim_offsets": True,
            "use_regex": pretok == "byte-level",
        },
        "post_processor": None,
        "decoder": dict(_BYTE_LEVEL_DECODER),
        "model": {
            "type": "BPE",
            "dropout": None,
            "unk_token": None,
            "continuing_subword_prefix": None,
            "end_of_word_suffix": None,
            "fuse_unk": False,
            "byte_fallback": False,
            "ignore_merges": False,
            "vocab": vocab,
            "merges": merges,
        },
    }


def model_to_hf_json(model: BPEModel, pretok: str = "none") -> str:
    return json.dumps(model_to_hf_obj(model, pretok=pretok), ensure_ascii=False)


def looks_like_hf_json(obj: dict) -> bool:
    return isinstance(obj.get("model"), dict) and "type" in obj["model"]


def _find_byte_level(pre) -> bool:
    if not isinstance(pre, dict):
        return False
    if pre.get("type") == "ByteLevel":
        return True
    if pre.get("type") == "Sequence":
        return any(_find_byte_level(p) for p in pre.get("pretokenizers", []))
    return False


def model_from_hf_obj(obj: dict) -> tuple[BPEModel, dict]:
    """Parse a ``tokenizer.json`` object → (BPEModel, extras).

    Token ids are preserved exactly. ``extras`` reports what was outside
    our model's scope: added/special tokens, whether the source had the
    GPT-2 pre-split regex, and bytes with no single-byte token.
    """
    mdl = obj.get("model")
    if not isinstance(mdl, dict) or mdl.get("type") != "BPE":
        kind = mdl.get("type") if isinstance(mdl, dict) else None
        raise ValueError(f"unsupported tokenizer model type {kind!r} (only BPE)")
    if mdl.get("continuing_subword_prefix") or mdl.get("end_of_word_suffix"):
        raise ValueError("subword prefix/suffix BPE is not byte-level BPE")

    vocab: dict[str, int] = mdl["vocab"]
    added = obj.get("added_tokens") or []
    added_ids = {t["id"] for t in added if isinstance(t, dict) and "id" in t}

    max_id = max(list(vocab.values()) + [t for t in added_ids], default=-1)
    entries: list[bytes] = [b""] * (max_id + 1)
    for s, tid in vocab.items():
        entries[tid] = hf_token_to_bytes(s)
    # added tokens (e.g. <|endoftext|>) keep their literal UTF-8 bytes so
    # decode() round-trips; they are NOT byte-level mapped in HF vocabs
    # when declared via added_tokens.
    for t in added:
        if isinstance(t, dict) and "id" in t and not entries[t["id"]]:
            entries[t["id"]] = str(t.get("content", "")).encode("utf-8")

    raw_merges = mdl.get("merges") or []
    merges: list[tuple[int, int, int]] = []
    for m in raw_merges:
        if isinstance(m, str):
            sa, _, sb = m.partition(" ")
        else:
            sa, sb = m
        try:
            a, b, new_id = vocab[sa], vocab[sb], vocab[sa + sb]
        except KeyError as e:
            raise ValueError(f"merge {m!r} references unknown token {e.args[0]!r}") from None
        merges.append((a, b, new_id))

    byte_ids = [-1] * 256
    for tid, entry in enumerate(entries):
        if len(entry) == 1 and byte_ids[entry[0]] < 0:
            byte_ids[entry[0]] = tid
    missing_bytes = [b for b, tid in enumerate(byte_ids) if tid < 0]

    extras = {
        "added_tokens": added,
        "pre_split_regex": _find_byte_level(obj.get("pre_tokenizer"))
        and bool(_deep_get(obj, "pre_tokenizer", "use_regex", default=True)),
        "missing_byte_tokens": missing_bytes,
        "normalizer": obj.get("normalizer"),
    }
    return BPEModel(vocab=entries, merges=merges), extras


def _deep_get(obj: dict, key: str, sub: str, default=None):
    node = obj.get(key)
    if isinstance(node, dict):
        if node.get("type") == "Sequence":
            for p in node.get("pretokenizers", []):
                if isinstance(p, dict) and p.get("type") == "ByteLevel":
                    return p.get(sub, default)
        return node.get(sub, default)
    return default


def model_from_hf_json(text: str | bytes) -> tuple[BPEModel, dict]:
    return model_from_hf_obj(json.loads(text))
