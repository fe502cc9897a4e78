"""Bulk greedy tokenization on the device: greedy longest match with chunk
semantics (counterpart of ``gpu_bpe_tpu/ops/tokenize.py``).

A pass over up to 2^24 bytes (2^25 without the stab join) runs in three
steps, with the token ids bitwise equal to ``TPUTokenizer`` and to the
greedy reference ``core.encoder_ref.GreedyTrieEncoder``:

1. **Match table** (``build_match_table``): for every position, the longest
   token that matches there and ends within the position's chunk. Single
   bytes map directly; token lengths 2..32 of a large vocab go through the
   chained sorted interval-stabbing join (``_stab_match``: one stable sort
   per level, the ``overlay_fit`` kernel, a scatter back to row order);
   the other lengths through the dense join (``dense_match``: one hash
   probe per position and length on the card, an equality join in
   position chunks on the CPU).
   On the card, levels >= 2 of the chain run in rank space: the positions
   that carry a prefix-group id are compacted (``compact_mask``), joined
   there, and expanded back (``expand_to_mask``).
2. **Chunk walk** (``chunk_walk``, ``ops/walk_kernels.py``): the
   reference's greedy rule per chunk, including the token split at a chunk
   boundary and the raw-byte fallback. On the card one launch of
   ``chunk_walk.cu`` a pass walks every chunk, a thread each, for any token
   length; on the CPU all chunks advance in lockstep over the chunk
   offsets with a 64-bit emission schedule per chunk (``chunk_walk_plain``),
   or, for tokens longer than 63 bytes, one gathered jump per step
   (``chunk_walk_gather``).
3. **PAD strip** (``compact_valid``): the position-aligned tokens lose
   their PAD holes on the device; the host reads back 16-bit ids.

u32 words are held in int64 tensors (values 0..2^32-1) so that every
comparison and sort is in unsigned order, and cross the kernels as int32
tensors of the same bits.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import INVALID_TOKEN, adaptive_chunk_size
from ..core.encoder_ref import decode_tokens
from ..utils.timing import span
from .dense_kernels import DenseHash, DenseTables, _pack_bytes, dense_match
from .kernels import compact_mask, compact_valid, expand_to_mask, to_i32
from .stab_kernels import NO_GROUP, overlay_fit
from .trainer import resolve_device
from .walk_kernels import MAX_WALK_STEP as _MAX_WALK_STEP
from .walk_kernels import chunk_walk

_PAD_TOKEN = INVALID_TOKEN  # never a real id (ids are 16-bit)

# Above this many multi-byte tokens the O(vocab)-per-position dense join is
# replaced by the sorted interval-stabbing join for token lengths 2..32;
# longer tokens stay on the dense join.
_DENSE_VOCAB_CUTOFF = 2048
_STAB_MAX_LEN = 8  # stab level 1 covers lengths 2..8 (8-byte sort keys)
_GROUP_DEPTH = _STAB_MAX_LEN + 1  # overlay slot carrying the prefix-group id
# Levels k >= 2 each cover 6 more bytes: the (group id, 6-byte window) key
# packs into two u32 words; level k covers lengths (8 + 6(k-2), 8 + 6(k-1)].
_STAB_MAX_SUFFIX = 6
_LVL_GROUP_DEPTH = _STAB_MAX_SUFFIX + 1  # level-k overlay slot for gids
_STAB_MAX_LEVELS = 5  # coverage cap: 8 + 6*4 = 32 bytes
# A level is chained only while more tokens than this remain beyond the
# current coverage; the dense join serves the dropped tail.
_LEVEL_MIN_TOKENS = 512
_RANK_MIN_N = 1 << 20  # rank-space level chain: passes of at least this many bytes
_RANK_CAP_FLOOR = 1 << 15  # smallest rank-space capacity
_SEG_MIN_ROWS = 1 << 16  # smallest join worth segmenting
_POS_NONE = 0x1FFFFFF  # position payload past any real position


def _stab_coverage(n_levels: int) -> int:
    """Longest token length served by an n-level stab join."""
    return _STAB_MAX_LEN + _STAB_MAX_SUFFIX * max(0, n_levels - 1)


def _pack_keys(token: bytes) -> np.ndarray:
    """Big-endian packed u32 key words for a token's bytes (``tokenize.py:97``)."""
    ln = len(token)
    n_words = (ln + 3) // 4
    padded = np.zeros(n_words * 4, dtype=np.uint32)
    padded[:ln] = np.frombuffer(token, dtype=np.uint8)
    w = padded.reshape(n_words, 4)
    return ((w[:, 0] << 24) | (w[:, 1] << 16) | (w[:, 2] << 8) | w[:, 3]).astype(np.uint32)


@dataclass
class MatchTables:
    """Per-length vocab key tables for the longest-match join
    (``tokenize.py:108``)."""

    lengths: list[int]
    keys: dict[int, np.ndarray]  # length -> [V_l, n_words] u32
    ids: dict[int, np.ndarray]  # length -> [V_l] i32
    max_token_len: int
    byte_ids: np.ndarray  # [256] id of the single-byte token or -1
    byte_ids_identity: bool  # True when byte_ids[b] == b for all b
    stab: dict | None  # interval rows for the stab join (large vocabs)
    dense_lengths: list[int]  # lengths served by the dense join

    @classmethod
    def from_vocab(cls, vocab: list[bytes]) -> "MatchTables":
        by_len: dict[int, dict[bytes, int]] = {}
        max_len = 1
        byte_ids = np.full(256, -1, dtype=np.int32)
        n_multi = 0
        for token_id, entry in enumerate(vocab):
            entry = bytes(entry)
            if not entry:
                continue
            max_len = max(max_len, len(entry))
            if len(entry) == 1:
                byte_ids[entry[0]] = token_id  # later duplicates overwrite
            else:
                by_len.setdefault(len(entry), {})[entry] = token_id
                n_multi += 1
        lengths = sorted(by_len)
        keys = {ln: np.stack([_pack_keys(t) for t in ents]) for ln, ents in by_len.items()}
        ids = {ln: np.array(list(ents.values()), dtype=np.int32) for ln, ents in by_len.items()}
        use_stab = n_multi > _DENSE_VOCAB_CUTOFF
        stab = _stab_vocab_rows(vocab) if use_stab else None
        if stab is not None and stab["count"] == 0:
            stab = None
        dense_lengths = [ln for ln in lengths if ln > stab["max_len"]] if stab else lengths
        return cls(
            lengths=lengths,
            keys=keys,
            ids=ids,
            max_token_len=max_len,
            byte_ids=byte_ids,
            byte_ids_identity=bool((byte_ids == np.arange(256)).all()),
            stab=stab,
            dense_lengths=dense_lengths,
        )


def _stab_vocab_rows(vocab: list[bytes]) -> dict:
    """Host-side interval rows for the chained multi-level stab join
    (``tokenize.py:156``).

    Level 1 (lengths 2..8): open key = bytes padded 0x00, close key = bytes
    padded 0xFF (8 bytes as 2 big-endian u32 words); a token is a prefix of
    a position's 8-byte window iff open <= window <= close, and the
    intervals nest. Distinct 8-byte prefixes of longer tokens become group
    rows at pseudo-depth ``_GROUP_DEPTH`` (open == close) carrying a 16-bit
    group id. Level k >= 2 joins (gid << 16 | 6-byte window at pos + base)
    against its suffix intervals (depth = suffix length) and group rows for
    the next level at ``_LVL_GROUP_DEPTH``. Row counts are padded to powers
    of two with inert rows (max key, depth 0)."""
    max_cov = _stab_coverage(_STAB_MAX_LEVELS)
    opens, closes, lns, ids = [], [], [], []
    long_toks: list[tuple[int, bytes]] = []  # stab-served tokens, len > 8
    for token_id, entry in enumerate(vocab):
        entry = bytes(entry)
        if 2 <= len(entry) <= _STAB_MAX_LEN:
            o = np.frombuffer(entry + b"\x00" * (8 - len(entry)), dtype=np.uint8)
            c = np.frombuffer(entry + b"\xff" * (8 - len(entry)), dtype=np.uint8)
            opens.append(o)
            closes.append(c)
            lns.append(len(entry))
            ids.append(token_id)
        elif _STAB_MAX_LEN < len(entry) <= max_cov:
            long_toks.append((token_id, entry))

    # chain level k+1 only while >= _LEVEL_MIN_TOKENS tokens remain beyond
    # the current coverage
    n_levels = 1
    while _stab_coverage(n_levels) < max_cov:
        beyond = sum(1 for _t, e in long_toks if len(e) > _stab_coverage(n_levels))
        if beyond == 0 or beyond < _LEVEL_MIN_TOKENS:
            break
        n_levels += 1
    # group ids are u16: a level whose seeding prefixes would overflow the
    # cap truncates the chain there (the dense join serves the tail)
    for k in range(1, n_levels):
        cov = _stab_coverage(k)
        hi = _stab_coverage(n_levels)
        n_groups = len({e[:cov] for _t, e in long_toks if cov < len(e) <= hi})
        if n_groups >= 0xFFFF:
            n_levels = k
            break
    stab_max = _stab_coverage(n_levels)
    long_toks = [(t, e) for t, e in long_toks if len(e) <= stab_max]

    # group chain: distinct 8-byte prefixes seed level 2
    groups: dict[bytes, int] = {}
    for _tid, entry in long_toks:
        groups.setdefault(entry[:_STAB_MAX_LEN], len(groups))
    assert len(groups) < 0xFFFF, "group-cap truncation above must prevent this"
    if not opens and not groups:
        return {"count": 0}

    def pack8(b):  # [V, 8] bytes -> 2 big-endian u32 words
        w = b.reshape(-1, 2, 4)
        return (w[:, :, 0] << 24) | (w[:, :, 1] << 16) | (w[:, :, 2] << 8) | w[:, :, 3]

    for prefix, gid in groups.items():
        pb = np.frombuffer(prefix, dtype=np.uint8)
        opens.append(pb)
        closes.append(pb)
        lns.append(_GROUP_DEPTH)
        ids.append(gid)
    v = len(lns)
    vpad = 1 << max(8, (v - 1).bit_length())
    pad = vpad - v
    ob = np.concatenate([np.stack(opens), np.full((pad, 8), 255, np.uint8)]).astype(np.uint32)
    cb = np.concatenate([np.stack(closes), np.full((pad, 8), 255, np.uint8)]).astype(np.uint32)
    out = {
        "count": vpad,
        "open_words": pack8(ob),  # [V, 2] u32
        "close_words": pack8(cb),
        "ln": np.concatenate([np.array(lns, np.uint32), np.zeros(pad, np.uint32)]),
        "id": np.concatenate([np.array(ids, np.uint32), np.zeros(pad, np.uint32)]),
        "n_groups": len(groups),
        "levels": [],
        "max_len": _STAB_MAX_LEN,  # raised below as levels are added
    }

    remaining = long_toks
    prev_groups = groups
    k = 2
    while remaining:
        base = _stab_coverage(k - 1)
        l_gids: list[int] = []
        l_bytes: list[tuple[bytes, bytes]] = []  # (open6, close6) suffix windows
        l_lns: list[int] = []
        l_ids: list[int] = []
        for token_id, entry in remaining:
            if len(entry) <= base + _STAB_MAX_SUFFIX:
                suffix = entry[base:]
                padn = _STAB_MAX_SUFFIX - len(suffix)
                l_gids.append(prev_groups[entry[:base]])
                l_bytes.append((suffix + b"\x00" * padn, suffix + b"\xff" * padn))
                l_lns.append(len(suffix))
                l_ids.append(token_id)
        next_toks = [(tid, e) for tid, e in remaining if len(e) > base + _STAB_MAX_SUFFIX]
        next_groups: dict[bytes, int] = {}
        for _tid, entry in next_toks:
            p = entry[: base + _STAB_MAX_SUFFIX]
            if p not in next_groups:
                next_groups[p] = len(next_groups)
                win = p[base:]
                l_gids.append(prev_groups[p[:base]])
                l_bytes.append((win, win))  # exact-equality group interval
                l_lns.append(_LVL_GROUP_DEPTH)
                l_ids.append(next_groups[p])
        assert len(next_groups) < 0xFFFF, "group-cap truncation above must prevent this"

        lv = len(l_ids)
        lpad_to = 1 << max(8, (lv - 1).bit_length())
        lpad = lpad_to - lv
        gid_arr = np.concatenate([np.array(l_gids, np.uint32), np.full(lpad, 0xFFFF, np.uint32)])
        lob = np.concatenate(
            [np.frombuffer(b"".join(o for o, _ in l_bytes), dtype=np.uint8).reshape(lv, 6),
             np.full((lpad, _STAB_MAX_SUFFIX), 255, np.uint8)]
        ).astype(np.uint32)
        lcb = np.concatenate(
            [np.frombuffer(b"".join(c for _, c in l_bytes), dtype=np.uint8).reshape(lv, 6),
             np.full((lpad, _STAB_MAX_SUFFIX), 255, np.uint8)]
        ).astype(np.uint32)

        def pack6(b):  # [V, 6] bytes + gids -> [V, 2] u32 key words
            w0 = (gid_arr << 16) | (b[:, 0] << 8) | b[:, 1]
            w1 = (b[:, 2] << 24) | (b[:, 3] << 16) | (b[:, 4] << 8) | b[:, 5]
            return np.stack([w0, w1], axis=1)

        out["levels"].append(
            {
                "count": lpad_to,
                "open": pack6(lob),
                "close": pack6(lcb),
                "ln": np.concatenate([np.array(l_lns, np.uint32), np.zeros(lpad, np.uint32)]),
                "id": np.concatenate([np.array(l_ids, np.uint32), np.zeros(lpad, np.uint32)]),
                "n_groups": len(next_groups),
            }
        )
        remaining = next_toks
        prev_groups = next_groups
        k += 1
    out["max_len"] = _stab_coverage(1 + len(out["levels"]))
    return out


def _seg_shape(rows: int, v2: int) -> tuple[int, int]:
    """Segmented sort-join shape (``tokenize.py:327``): split ``rows`` rows
    into ``nseg`` contiguous segments of ``S`` and replicate the ``v2``
    vocab rows into each, so that ``S + v2`` is a power of two chosen by
    the JAX package's cost model. Returns (1, rows) for small inputs."""
    if rows < _SEG_MIN_ROWS:
        return 1, rows
    best = None
    for k in range(16, 23):
        m = 1 << k
        s = m - v2
        if s <= m // 2 or s >= rows:  # >50% replication, or one segment
            continue
        nseg = -(-rows // s)
        cost = nseg * m * k * k
        if best is None or cost < best[0]:
            best = (cost, nseg, s)
    if best is None or best[1] < 2:
        return 1, rows
    return best[1], best[2]


def _k3(flag, ln, pay):
    """Packed third key word: flag (opens 0 < positions 1 < closes 2) <<
    30 | depth << 25 | payload (``tokenize.py:367``)."""
    return (flag << 30) | (ln << 25) | pay


def _sort_key(w0, w1):
    """Two u32 key words as one int64 whose signed order is the unsigned
    order of (w0, w1): (w0 - 2^31) * 2^32 + w1."""
    return (w0 - 2**31) * 2**32 + w1


_MAX_KEY = _sort_key(0xFFFFFFFF, 0xFFFFFFFF)


@dataclass
class _JoinRows:
    """One stab level's vocab rows on the device, opens and closes each in
    ascending order of their packed ``_k3`` word."""

    open_key: torch.Tensor  # int64 [V] _sort_key of the open words
    open_kp: torch.Tensor  # int32 [V] u32 bits of _k3(0, ln, id)
    close_key: torch.Tensor
    close_kp: torch.Tensor

    @classmethod
    def build(cls, open_words, close_words, ln, ids, device) -> "_JoinRows":
        ln, ids = ln.astype(np.int64), ids.astype(np.int64)
        out = {}
        for name, words, flag in (("open", open_words, 0), ("close", close_words, 2)):
            kp = _k3(np.int64(flag), ln, ids)
            order = np.argsort(kp, kind="stable")
            w = words[order].astype(np.int64)
            out[f"{name}_key"] = torch.from_numpy(_sort_key(w[:, 0], w[:, 1])).to(device)
            out[f"{name}_kp"] = torch.from_numpy(kp[order].astype(np.uint32).view(np.int32)).to(device)
        return cls(**out)

    @property
    def count(self) -> int:
        return self.open_key.shape[0]


def _sorted_rows(w0, w1, pos_pay, rows: _JoinRows, nseg: int, seg: int):
    """The sorted open/position/close stream of one join: returns (skp
    int32 [nseg, seg + 2V], perm). Segment s holds the opens, the row
    stream's rows [s*seg, (s+1)*seg) (padded with inert max-key rows) and
    the closes. The input order within a segment is ascending in the
    ``_k3`` word (opens, then rows by position, then closes), so one stable
    sort on the two key words gives the (w0, w1, kp) order of the JAX
    package's 3-operand sort; rows with equal keys and equal kp are
    identical, so skp is the same."""
    nrows = w0.shape[0]
    v = rows.count
    pad = nseg * seg - nrows
    key = _sort_key(w0, w1)
    kp = _k3(1, 0, pos_pay)
    if pad:
        key = torch.cat([key, torch.full((pad,), _MAX_KEY, dtype=torch.int64, device=key.device)])
        kp = torch.cat([kp, torch.full((pad,), _k3(1, 0, _POS_NONE), dtype=torch.int64, device=kp.device)])
    keys = torch.cat([rows.open_key.expand(nseg, v), key.view(nseg, seg),
                      rows.close_key.expand(nseg, v)], dim=1)
    kps = torch.cat([rows.open_kp.expand(nseg, v), kp.to(torch.int32).view(nseg, seg),
                     rows.close_kp.expand(nseg, v)], dim=1)
    _, perm = torch.sort(keys, dim=1, stable=True)
    return torch.gather(kps, 1, perm), perm


def _stab_join(w0, w1, pos_pay, rows: _JoinRows, input_len: int, chunk_size: int, *,
               base_len: int, max_depth: int, depths: int, group_depth: int):
    """One sorted interval-stabbing join over a row stream (positions or
    rank rows): ``w0``/``w1`` are the rows' key words and ``pos_pay`` their
    true positions, all int64. Returns (packed, gid) per row in row order,
    int64 u32 values; gid is None when ``group_depth`` < 0.

    Counterpart of the level-1 block of ``_stab_match`` and ``_lvl_join``
    (``tokenize.py:573-637``, ``:649-712``). The JAX package restores row
    order with a second sort on the restore key; here the inverse of the
    join sort's permutation puts every row back, which gives the same
    values (rows whose restore keys tie are padding or rank garbage rows
    with identical outputs)."""
    nrows = w0.shape[0]
    v = rows.count
    nseg, seg = _seg_shape(nrows, 2 * v)
    skp, perm = _sorted_rows(w0, w1, pos_pay, rows, nseg, seg)
    packed, _key2, gid = overlay_fit(skp, input_len, chunk_size=chunk_size, depths=depths,
                                     base_len=base_len, max_depth=max_depth, group_depth=group_depth)

    def restore(x):
        back = torch.empty_like(x).scatter_(1, perm, x)
        return back[:, v : v + seg].reshape(-1)[:nrows].to(torch.int64) & 0xFFFFFFFF

    return restore(packed), (restore(gid) if group_depth >= 0 else None)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> int64 u32 value."""
    return x.to(torch.int64) & 0xFFFFFFFF


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 u32 value -> int32 bits."""
    return to_i32(x).to(torch.int32)


class _StabTables:
    """A stab table's join rows on one device."""

    def __init__(self, stab: dict, device):
        self.level1 = _JoinRows.build(stab["open_words"], stab["close_words"], stab["ln"], stab["id"],
                                      device)
        self.levels = [_JoinRows.build(lv["open"], lv["close"], lv["ln"], lv["id"], device)
                       for lv in stab["levels"]]


def _use_rank(rank_mode: str | None, data: torch.Tensor) -> bool:
    """Rank-space chain for levels >= 2: always with "on", never with
    "off", and by default on CUDA for passes of at least ``_RANK_MIN_N``."""
    if rank_mode is None:
        return data.is_cuda and data.shape[0] >= _RANK_MIN_N
    return rank_mode == "on"


def _stab_match(data: torch.Tensor, stab_rows: _StabTables, input_len: int, chunk_size: int,
                rank_mode: str | None = None) -> torch.Tensor:
    """Longest in-chunk match per position for token lengths 2..32 through
    the chained stab join (``tokenize.py:522``). ``data`` is the pass's
    uint8 buffer. Returns packed (len << 16 | id) per position, 0 where
    nothing matches, int64.

    ``rank_mode`` picks the space of levels >= 2 (``_use_rank``). In rank
    space only positions that hold a group id take part: they are
    compacted with their position and window words to a capacity of n/32,
    else n/8 (the host reads the count to choose), joined there and
    expanded back; past both capacities the chain runs at full width.
    Every choice gives the same result."""
    n = data.shape[0]
    assert n < (1 << 25), "single pass capped at 2^25 positions (payload packing)"
    n_levels = len(stab_rows.levels)
    iota = torch.arange(n, dtype=torch.int64, device=data.device)
    result, gid_pos = _stab_join(
        _pack_bytes(data, 0, 4), _pack_bytes(data, 4, 4), iota, stab_rows.level1, input_len,
        chunk_size, base_len=0, max_depth=_STAB_MAX_LEN,
        depths=_GROUP_DEPTH + 1 if n_levels else _STAB_MAX_LEN + 1,
        group_depth=_GROUP_DEPTH if n_levels else -1,
    )
    if not n_levels:
        return result

    def levels_chain(gid0, sw_bytes, pos_pay):
        """All levels >= 2 over one row stream: max packed contribution."""
        contrib = torch.zeros_like(gid0)
        gid_cur = gid0
        for li, rows in enumerate(stab_rows.levels):
            b0b1, sw1 = sw_bytes[li]
            last = li == n_levels - 1
            packed2, gid_cur = _stab_join(
                (gid_cur << 16) | b0b1, sw1, pos_pay, rows, input_len, chunk_size,
                base_len=_stab_coverage(li + 1), max_depth=_STAB_MAX_SUFFIX,
                depths=_STAB_MAX_SUFFIX + 1 if last else _LVL_GROUP_DEPTH + 1,
                group_depth=-1 if last else _LVL_GROUP_DEPTH,
            )
            # a level-k match is strictly longer than any earlier level's
            contrib = torch.maximum(contrib, packed2)
        return contrib

    # per-level window words in position space
    sw_bytes_pos = []
    for li in range(n_levels):
        base = _stab_coverage(li + 1)
        sw_bytes_pos.append((_pack_bytes(data, base, 2), _pack_bytes(data, base + 2, 4)))

    if not _use_rank(rank_mode, data):
        return torch.maximum(result, levels_chain(gid_pos, sw_bytes_pos, iota))

    mask = gid_pos != NO_GROUP
    prim = torch.where(mask, gid_pos, 0xFFFFFFFF)
    extras = [iota] + [w for pair in sw_bytes_pos for w in pair]
    outs, cnt = compact_mask(_i32(prim), [_i32(e) for e in extras])
    with span("tokenize.read", "rank_count"):
        cnt = int(cnt)
    cap_small = min(n, max(n >> 5, _RANK_CAP_FLOOR))
    cap_big = min(n, max(n >> 3, _RANK_CAP_FLOOR))
    cap = next((c for c in (cap_small, cap_big) if cnt <= c), None)
    if cap is None:
        return torch.maximum(result, levels_chain(gid_pos, sw_bytes_pos, iota))
    # rows past cnt are garbage: max keys and a position past any real one,
    # so they sort to the tail of every join and match nothing
    live = torch.arange(cap, device=data.device) < cnt

    def rank_rows(i, fill):
        return torch.where(live, _u32(outs[i][:cap]), fill)

    sw_bytes_rank = [(rank_rows(2 + 2 * li, 0xFFFFFFFF), rank_rows(3 + 2 * li, 0xFFFFFFFF))
                     for li in range(n_levels)]
    contrib_r = levels_chain(rank_rows(0, NO_GROUP), sw_bytes_rank, rank_rows(1, _POS_NONE))
    return torch.maximum(result, _u32(expand_to_mask(mask, _i32(contrib_r))))


def build_match_table(data: torch.Tensor, tables: MatchTables, stab_rows: _StabTables | None,
                      dense: DenseTables, input_len: int, chunk_size: int,
                      rank_mode: str | None = None):
    """Longest in-chunk match per position (``tokenize.py:803``): (match_id,
    match_len), int64 ``[N]``. ``match_id`` is -1 where nothing, not even a
    single-byte token, matches; the walk then emits the raw byte.
    ``stab_rows``/``dense`` are ``tables`` on ``data``'s device
    (``stab_rows`` None without a stab table)."""
    if tables.stab is None and tables.dense_lengths:
        # the dense join takes the single-byte matches itself
        return dense_match(data, dense, input_len, chunk_size)
    dev = data.device
    n = data.shape[0]
    d64 = data.to(torch.int64)
    iota = torch.arange(n, dtype=torch.int64, device=dev)

    # length-1 matches
    if tables.byte_ids_identity:
        match_id = torch.where(iota < input_len, d64, -1)
    else:  # an imported vocab missing byte tokens
        bids = torch.from_numpy(tables.byte_ids.astype(np.int64)).to(dev)
        match_id = torch.where(iota < input_len, bids[d64], -1)
    match_len = torch.where(match_id >= 0, 1, 0)

    if tables.stab is not None:
        packed = _stab_match(data, stab_rows, input_len, chunk_size, rank_mode)
        s_ln = packed >> 16
        hit = s_ln > 0
        match_id = torch.where(hit, packed & 0xFFFF, match_id)
        match_len = torch.where(hit, s_ln, match_len)

    if not tables.dense_lengths:
        return match_id, match_len
    return dense_match(data, dense, input_len, chunk_size, match_id, match_len)


def chunk_walk_gather(match_id, match_len, data, input_len: int, chunk_size: int) -> torch.Tensor:
    """Greedy walk on the CPU for vocabs with tokens longer than
    ``_MAX_WALK_STEP`` bytes (``tokenize.py:1001``): one gathered jump per
    step for every chunk. Returns int32 ``[n]``, each chunk's tokens
    left-aligned in its row with PAD after them (``chunk_walk``'s tokens in
    the same order once PAD is stripped)."""
    n = match_id.shape[0]
    num_chunks = n // chunk_size
    dev = match_id.device
    chunk_start = torch.arange(num_chunks, dtype=torch.int64, device=dev) * chunk_size
    chunk_end = torch.clamp(chunk_start + chunk_size, max=input_len)
    matched = match_id >= 0
    tok_all = torch.where(matched, match_id, data.to(torch.int64))
    adv_all = torch.clamp(torch.where(matched, match_len, 1), min=1)
    toks = torch.full((num_chunks, chunk_size), _PAD_TOKEN, dtype=torch.int64, device=dev)
    pos = chunk_start
    for col in range(chunk_size):
        active = pos < chunk_end
        with span("tokenize.read", "gather_step"):
            more = bool(active.any())
        if not more:
            break
        safe = torch.clamp(pos, max=n - 1)
        toks[:, col] = torch.where(active, tok_all[safe], _PAD_TOKEN)
        pos = torch.where(active, pos + adv_all[safe], pos)
    return _i32(toks.reshape(-1))


def _concrete(device: torch.device) -> torch.device:
    """``device`` with its index: a CUDA device without one is the current
    card (the device a tensor moved there reports)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def pass_devices(device: torch.device) -> list[torch.device]:
    """The devices that take the passes of one input in turn when the
    caller names none (counterpart of ``TPUTokenizer._devices``,
    ``gpu_bpe_tpu/ops/tokenize.py:1136-1154``): every visible card, starting
    at ``device``, when ``device`` is a card; ``[device]`` on the CPU.
    ``GPU_BPE_TPU_TOKENIZE_ALL_DEVICES=1`` takes every visible device of
    ``device``'s type (the CPU is one), ``=0`` takes ``[device]`` alone.

    The reference spreads passes by default only on the TPU, because each
    device there compiles its own copy of the pass (on the CPU test mesh that
    would multiply the compile time by the device count). That reason does
    not hold here: the port's kernels are built once per tree and serve every
    card, and a card's only extra cost is one upload of the match tables. The
    port's accelerator is the card, so "every card" is its counterpart of the
    reference's "every TPU device"."""
    flag = os.environ.get("GPU_BPE_TPU_TOKENIZE_ALL_DEVICES")
    if flag == "0" or device.type != "cuda":
        return [device]
    count = torch.cuda.device_count()
    first = device.index or 0
    return [torch.device("cuda", (first + i) % count) for i in range(count)]


class Tokenizer:
    """Bulk greedy tokenizer: match table, chunk walk and PAD strip on the
    device (counterpart of ``TPUTokenizer``, ``tokenize.py:1044``).

    Chunk size ``max(512, min(2048, max_token_len * 8))`` unless given, the
    reference's chunk-boundary behaviour and raw-byte fallback, passes of at
    most ``max_pass_bytes`` (2^24 with the stab join) aligned to the chunk
    size, each padded to a power-of-two capacity of at least 2^16.
    ``rank_mode``: None (rank space on CUDA for passes >= 2^20 bytes, full
    width on the CPU), "off" (full width) or "on" (rank space on either
    device). Runs on the card unless ``device="cpu"``.

    ``devices``: the devices that take the passes of one input in turn (the
    JAX package's round robin, ``tokenize.py:1123-1154``), used as given;
    the default is ``pass_devices(device)``: every visible card on CUDA,
    ``device`` alone on the CPU, ``GPU_BPE_TPU_TOKENIZE_ALL_DEVICES``
    overriding either way. At most ``max(2, len(devices) + 1)`` passes are in
    flight; the ids equal those of passes run one after another."""

    def __init__(
        self,
        vocab: list[bytes],
        chunk_size: int | None = None,
        max_pass_bytes: int = 1 << 25,
        rank_mode: str | None = None,
        device: str | torch.device = "cuda",
        devices: list | None = None,
    ):
        if rank_mode not in (None, "off", "on"):
            raise ValueError(f"rank_mode must be None, 'off' or 'on', got {rank_mode!r}")
        self.device = _concrete(resolve_device(device))
        self.devices = [_concrete(resolve_device(d)) for d in devices] if devices else pass_devices(self.device)
        self.vocab = [bytes(v) for v in vocab]
        self.tables = MatchTables.from_vocab(self.vocab)
        self.rank_mode = rank_mode
        self.chunk_size = chunk_size or adaptive_chunk_size(self.tables.max_token_len)
        if self.tables.stab is not None:
            # the stab join packs positions into 25 payload bits; keep
            # passes a power of two below that bound
            max_pass_bytes = min(max_pass_bytes, 1 << 24)
        slice_bytes = max(max_pass_bytes, self.chunk_size)
        self.max_pass_bytes = (slice_bytes // self.chunk_size) * self.chunk_size
        hashed = DenseHash.build(self.tables)
        self._on_device = {}  # device -> (stab rows, dense tables) there
        for dev in [self.device, *self.devices]:
            if dev not in self._on_device:
                stab = _StabTables(self.tables.stab, dev) if self.tables.stab else None
                self._on_device[dev] = (stab, DenseTables(self.tables, hashed, dev))
        self._stab_rows, self._dense = self._on_device[self.device]

    @classmethod
    def from_model(cls, model, **kw) -> "Tokenizer":
        return cls(model.vocab, **kw)

    def capacity(self, n: int) -> int:
        """Pass capacity for ``n`` bytes: a power of two >= max(n, 2^16),
        rounded up to the chunk size."""
        cap = 1 << 16
        while cap < n:
            cap <<= 1
        return -(-cap // self.chunk_size) * self.chunk_size

    def encode_pass(self, buf: torch.Tensor, input_len: int):
        """One pass over a uint8 buffer on the device whose first
        ``input_len`` bytes are the input: returns (ids, total), ``ids``
        int32 ``[len(buf)]`` whose first ``total`` entries are the token
        ids, ``total`` a 0-d int64 tensor."""
        stab_rows, dense = self._on_device[buf.device]
        with span("tokenize.match_table") as sp:
            sp.note(stab=int(stab_rows is not None), dense=len(self.tables.dense_lengths))
            mid, mlen = build_match_table(buf, self.tables, stab_rows, dense, input_len,
                                          self.chunk_size, self.rank_mode)
        # the card's kernel takes any token length; on the CPU the plain
        # walk's schedule stops at _MAX_WALK_STEP bytes
        kernel = buf.is_cuda
        walk = chunk_walk if kernel or self.tables.max_token_len <= _MAX_WALK_STEP else chunk_walk_gather
        with span("tokenize.walk") as sp:
            sp.note(kernel=int(kernel))
            tokens = walk(mid, mlen, buf, input_len, self.chunk_size)
        return compact_valid(tokens)

    def encode_bytes(self, data: bytes) -> np.ndarray:
        """Token ids of ``data`` (uint32). The passes go to ``devices`` in
        turn; the oldest pass in flight is read back once the window of
        ``max(2, len(devices) + 1)`` passes is full."""
        with span("tokenize.call") as call:
            with span("tokenize.input"):
                data = bytes(data)
            call.note(bytes=len(data))
            if not data:
                return np.zeros(0, dtype=np.uint32)
            window = max(2, len(self.devices) + 1)
            parts: list[np.ndarray] = []
            in_flight: list[tuple] = []
            for i, off in enumerate(range(0, len(data), self.max_pass_bytes)):
                dev = self.devices[i % len(self.devices)]
                in_flight.append(self._start_pass(data[off : off + self.max_pass_bytes], dev))
                if len(in_flight) >= window:
                    parts.append(self._finish_pass(*in_flight.pop(0)))
            parts.extend(self._finish_pass(*p) for p in in_flight)
            return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def _start_pass(self, data: bytes, device: torch.device):
        """Enqueue one pass on ``device``: its ids as int16 bits (ids are
        16-bit) and its total, whose copy to the host is started without
        waiting (into pinned memory, with an event, on a card)."""
        n = len(data)
        with span("tokenize.pass") as sp:
            sp.note(bytes=n)
            buf = np.zeros(self.capacity(n), dtype=np.uint8)
            buf[:n] = np.frombuffer(data, dtype=np.uint8)
            ids, total = self.encode_pass(torch.from_numpy(buf).to(device), n)
            ids16 = torch.where(ids >= 0x8000, ids - 0x10000, ids).to(torch.int16)
            if device.type != "cuda":
                return ids16, total, None
            total_host = torch.empty((), dtype=torch.int64, pin_memory=True)
            total_host.copy_(total, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
            return ids16, total_host, done

    @staticmethod
    def _finish_pass(ids16: torch.Tensor, total: torch.Tensor, done) -> np.ndarray:
        with span("tokenize.read", "ids"):
            if done is not None:
                done.synchronize()
            return ids16[: int(total)].cpu().numpy().view(np.uint16).astype(np.uint32)

    def decode(self, tokens) -> bytes:
        return decode_tokens(tokens, self.vocab)
