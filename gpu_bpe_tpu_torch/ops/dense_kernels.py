"""The tokenizer's dense-join kernel: the vocab's hash table, the CUDA
wrapper, its plain PyTorch version and launch counter.

The dense join finds, for every position of a pass, the longest token of a
"dense" length (every multi-byte length below the stab table's 2048
entries, else the lengths the stab chain does not cover) that starts there
and ends within the position's chunk and the input. The JAX package
computes it in plain jnp (``gpu_bpe_tpu/ops/tokenize.py``,
``build_match_table``) as an equality join of every position with every key;
``dense_match_plain`` is that join in PyTorch, the path for CPU tensors and
the kernel's yardstick on the card. ``dense_match`` launches
``ops/csrc/dense_match.cu`` for CUDA tensors: one hash probe per position
and length into the open-addressed table that ``DenseHash.build`` makes
once per vocab (``hash_words`` and ``DenseHash.lookup`` mirror the
kernel's hash and probe in numpy). The two give the same ids.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .build import LAUNCHES, check, current_stream, on_cpu, on_device, ptr, require

TILE = 2048  # positions per tile of dense_match.cu (TILE_N, dm_tile_positions())
MAX_LEN = 1 << 16  # longest token the kernel can match (dense_match.cu MAX_STAGE_LEN)
_JOIN_TILE = 1 << 26  # plain join: positions x vocab entries compared per chunk


def _pack_bytes(data: torch.Tensor, base: int, count: int) -> torch.Tensor:
    """Big-endian word of the ``count`` bytes at p + base .. p + base +
    count - 1 for every position p, wrapping around the end as
    ``jnp.roll`` does (int64)."""
    w = torch.zeros(data.shape[0], dtype=torch.int64, device=data.device)
    for j in range(count):
        w = (w << 8) | torch.roll(data, -(base + j)).to(torch.int64)
    return w


# ─────────────────────────────── the host table ───────────────────────────────


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def hash_words(ln: int, words: np.ndarray) -> np.ndarray:
    """The probe's hash of length-``ln`` byte strings, ``words`` u32
    ``[N, ceil(ln / 4)]`` big-endian with the last word's unused low bytes
    zero: murmur3's block mix over the words, seeded with ``ln *
    0x9E3779B9``, and its finaliser with ``ln`` folded in (dense_match.cu
    ``mix_word`` and ``finish``). Returns u32 ``[N]``."""
    words = np.asarray(words, dtype=np.uint32)
    with np.errstate(over="ignore"):
        h = np.full(words.shape[0], (ln * 0x9E3779B9) & 0xFFFFFFFF, dtype=np.uint32)
        for k in range(words.shape[1]):
            w = _rotl(words[:, k] * np.uint32(0xCC9E2D51), 15) * np.uint32(0x1B873593)
            h = _rotl(h ^ w, 13) * np.uint32(5) + np.uint32(0xE6546B64)
        h ^= np.uint32(ln)
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return h


@dataclass
class DenseHash:
    """The open-addressed table of every dense (length, key) pair, as
    dense_match.cu reads it: ``slots`` u32 ``[S, 4]`` of {length (0 =
    empty), id, key word 0, offset of key words 1.. in ``words``}, ``S`` a
    power of two; linear probing from ``hash_words(...) & (S - 1)``, at most
    ``max_probes`` slots (the longest displacement of any key, plus one)."""

    lengths: np.ndarray  # int32 [L], dense lengths, longest first
    slots: np.ndarray  # uint32 [S, 4]
    words: np.ndarray  # uint32 [W], key words 1.. of every key longer than 4 bytes
    byte_ids: np.ndarray  # int32 [256], the single-byte tokens' ids (-1 none)
    max_probes: int

    @classmethod
    def build(cls, tables, n_slots: int | None = None) -> "DenseHash":
        """The table of ``tables`` (a ``MatchTables``): its ``dense_lengths``
        keys (unique per length; ``from_vocab`` keeps a duplicate's last id,
        the join's ``amax``). ``n_slots`` defaults to the smallest power of
        two of at least 16 and twice the key count (load at most 0.5); a
        smaller one (a power of two above the key count) makes probes
        collide. Vectorised: every unplaced key tries its next slot in each
        round, the first claimant of a free slot takes it."""
        lengths = sorted(tables.dense_lengths, reverse=True)
        cols = {"ln": [], "id": [], "w0": [], "off": [], "home": []}
        rest, off = [], 0
        for ln in lengths:
            keys = np.asarray(tables.keys[ln], dtype=np.uint32)
            v, nw = keys.shape
            cols["ln"].append(np.full(v, ln, dtype=np.uint32))
            cols["id"].append(np.asarray(tables.ids[ln]).astype(np.uint32))
            cols["w0"].append(keys[:, 0])
            cols["off"].append((off + (nw - 1) * np.arange(v)).astype(np.uint32))
            cols["home"].append(hash_words(ln, keys))
            rest.append(keys[:, 1:].reshape(-1))
            off += v * (nw - 1)
        col = {k: np.concatenate(v) if v else np.zeros(0, np.uint32) for k, v in cols.items()}
        n_keys = col["ln"].shape[0]
        if n_slots is None:
            n_slots = max(16, 1 << (2 * n_keys - 1).bit_length())
        if n_slots & (n_slots - 1) or n_slots <= n_keys:
            raise ValueError(f"n_slots {n_slots}: want a power of two above the {n_keys} keys")
        mask = n_slots - 1
        owner = np.full(n_slots, -1, dtype=np.int64)
        disp = np.zeros(n_keys, dtype=np.int64)
        home = col["home"].astype(np.int64)
        todo = np.arange(n_keys)
        while todo.size:
            cand = (home[todo] + disp[todo]) & mask
            free = np.flatnonzero(owner[cand] < 0)
            taken, first = np.unique(cand[free], return_index=True)
            owner[taken] = todo[free[first]]
            lost = np.ones(todo.size, dtype=bool)
            lost[free[first]] = False
            todo = todo[lost]
            disp[todo] += 1
        slots = np.zeros((n_slots, 4), dtype=np.uint32)
        live = owner >= 0
        slots[live] = np.stack([col["ln"], col["id"], col["w0"], col["off"]], axis=1)[owner[live]]
        return cls(
            lengths=np.asarray(lengths, dtype=np.int32),
            slots=slots,
            words=np.concatenate(rest) if rest else np.zeros(0, np.uint32),
            byte_ids=np.asarray(tables.byte_ids, dtype=np.int32),
            max_probes=int(disp.max()) + 1 if n_keys else 1,
        )

    def lookup(self, ln: int, windows: np.ndarray) -> np.ndarray:
        """The kernel's probe in numpy: the id of the length-``ln`` key equal
        to each window (u32 ``[N, ceil(ln / 4)]``, big-endian, the last word
        masked to its bytes), -1 where none is."""
        windows = np.asarray(windows, dtype=np.uint32)
        n = windows.shape[0]
        mask = self.slots.shape[0] - 1
        h = hash_words(ln, windows).astype(np.int64)
        found = np.full(n, -1, dtype=np.int64)
        active = np.ones(n, dtype=bool)
        for pr in range(self.max_probes):
            s = self.slots[(h + pr) & mask]
            active &= s[:, 0] != 0  # an empty slot ends the run
            hit = active & (s[:, 0] == ln) & (s[:, 2] == windows[:, 0])
            for k in range(1, windows.shape[1]):
                if not len(self.words):  # no key is longer than 4 bytes
                    hit[:] = False
                    break
                at = np.minimum(s[:, 3].astype(np.int64) + k - 1, len(self.words) - 1)
                hit &= self.words[at] == windows[:, k]
            found[hit] = s[hit, 1]
            active &= ~hit
        return found


class DenseTables:
    """The dense join's vocab on one device: per-length keys and ids for
    the plain version, ``DenseHash``'s arrays for the kernel."""

    def __init__(self, tables, hashed: DenseHash, device):
        self.lengths = list(tables.dense_lengths)  # ascending
        self.keys = {ln: torch.from_numpy(tables.keys[ln].astype(np.int64)).to(device) for ln in self.lengths}
        self.ids = {ln: torch.from_numpy(tables.ids[ln].astype(np.int64)).to(device) for ln in self.lengths}
        self.byte_ids = torch.from_numpy(np.asarray(hashed.byte_ids)).to(device)
        self.max_len = max(self.lengths, default=0)
        self.max_probes = hashed.max_probes
        self.hash_lengths = torch.from_numpy(hashed.lengths).to(device)
        self.slots = torch.from_numpy(hashed.slots.view(np.int32)).to(device)
        words = hashed.words if len(hashed.words) else np.zeros(1, np.uint32)
        self.words = torch.from_numpy(words.view(np.int32)).to(device)


# ──────────────────────────────── the dense join ────────────────────────────────


def dense_match_plain(data, dense: DenseTables, input_len: int, chunk_size: int, match_id=None,
                      match_len=None):
    """Plain PyTorch version of ``dense_match``: per-length exact joins over
    packed substring words, in position chunks of about ``_JOIN_TILE``
    compared pairs (ascending length: longer matches overwrite)."""
    dev = data.device
    n = data.shape[0]
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    if match_id is None:  # the single-byte matches
        match_id = torch.where(iota < input_len, dense.byte_ids[data.to(torch.int64)].to(torch.int64), -1)
        match_len = torch.where(match_id >= 0, 1, 0)
    chunk_end = torch.clamp((iota // chunk_size + 1) * chunk_size, max=input_len)
    max_words = (dense.max_len + 3) // 4
    sub = torch.stack([_pack_bytes(data, 4 * w, 4) for w in range(max_words)], dim=1)
    widest = max(dense.keys[ln].shape[0] for ln in dense.lengths)
    step = max(1, _JOIN_TILE // widest)
    ids_out, lens_out = [], []
    for a in range(0, n, step):
        sub_c, id_c, len_c = sub[a : a + step], match_id[a : a + step], match_len[a : a + step]
        room = chunk_end[a : a + step] - iota[a : a + step]
        for ln in dense.lengths:
            keys = dense.keys[ln]
            n_words = (ln + 3) // 4
            rem = ln - (n_words - 1) * 4
            eq = None
            for w in range(n_words):
                sw = sub_c[:, w]
                if w == n_words - 1 and rem < 4:
                    sw = sw & ((0xFFFFFFFF << ((4 - rem) * 8)) & 0xFFFFFFFF)
                e = sw[:, None] == keys[None, :, w]
                eq = e if eq is None else eq & e
            hit_id = torch.where(eq, dense.ids[ln][None, :], -1).amax(1)
            hit = (hit_id >= 0) & (ln <= room)  # must end within the chunk AND input
            id_c = torch.where(hit, hit_id, id_c)
            len_c = torch.where(hit, ln, len_c)
        ids_out.append(id_c)
        lens_out.append(len_c)
    return torch.cat(ids_out), torch.cat(lens_out)


def dense_match(data, dense: DenseTables, input_len: int, chunk_size: int, match_id=None, match_len=None):
    """The dense join over a pass: ``data`` uint8 ``[n]`` whose first
    ``input_len`` bytes are the input, chunks of ``chunk_size``. Returns
    (match_id, match_len), int64 ``[n]``: at each position the longest
    dense token that matches there and ends within the chunk and the input,
    else the incoming match: ``match_id``/``match_len`` (int64 ``[n]``, the
    stab join's result) when given, else the single-byte token's id and 1
    (-1 and 0 past the input or without a byte token). ``dense`` holds at
    least one length, on ``data``'s device. CPU tensors take the plain
    version; CUDA tensors launch ``dense_match.cu``, which matches tokens of
    at most ``MAX_LEN`` bytes (longer ones only where ``chunk_size`` and the
    input allow them)."""
    incoming = () if match_id is None else (match_id, match_len)
    if on_cpu(data, *incoming):
        return dense_match_plain(data, dense, input_len, chunk_size, match_id, match_len)
    from .build import load

    dev = data.device
    n = data.shape[0]
    require(data, torch.uint8, (n,), "data")
    for t in incoming:
        require(t, torch.int64, (n,), "incoming match")
    if dense.slots.device != dev or not dense.lengths:
        raise ValueError(f"dense_match: tables on {dense.slots.device} with {len(dense.lengths)} lengths, "
                         f"data on {dev}")
    if not 0 <= input_len <= n or chunk_size < 1:
        raise ValueError(f"dense_match: input_len {input_len} of {n}, chunk_size {chunk_size}")
    max_len = max(1, min(dense.max_len, chunk_size, input_len))  # no probe matches a longer token
    if max_len > MAX_LEN:
        raise ValueError(f"dense_match: tokens of {max_len} bytes can match, the kernel takes {MAX_LEN}")
    lib = load()["dense_match"]
    out = torch.empty(2, n, dtype=torch.int64, device=dev)  # match_id, match_len
    in_id, in_len = (0, 0) if match_id is None else (ptr(match_id), ptr(match_len))
    with on_device(dev):
        rc = lib.dense_match(
            ptr(data), n, int(input_len), int(chunk_size), ptr(dense.hash_lengths), len(dense.lengths),
            max_len, ptr(dense.slots), dense.slots.shape[0], ptr(dense.words), dense.words.numel(),
            dense.max_probes, ptr(dense.byte_ids), in_id, in_len, ptr(out[0]), ptr(out[1]), current_stream(dev),
        )
    check(rc, "dense_match")
    LAUNCHES["dense_match"] += 1
    return out[0], out[1]
