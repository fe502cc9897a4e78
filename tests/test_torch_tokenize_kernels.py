"""The port's tokenizer kernels (plain PyTorch versions, CPU) against the
JAX package's Pallas functions in interpret mode and its XLA overlay path.

``compact_mask`` / ``compact_valid`` / ``expand_to_mask`` against
``gpu_bpe_tpu.ops.pallas_kernels`` and ``overlay_fit`` against
``gpu_bpe_tpu.ops.stab_kernels.overlay_fit`` (and the XLA doubling scan of
``_overlay_fit_dispatch`` for any m), on sorted streams built from real stab
rows. Tolerance 0 everywhere: every output is an integer. Compaction
outputs are compared on their first ``total`` entries (what lies past it
is unspecified in both packages).
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

# One intra-op thread: the suite runs several test processes side by side,
# and a full torch CPU thread pool in each of them oversubscribes the cores.
torch.set_num_threads(1)

from gpu_bpe_tpu.ops import pallas_kernels as pk  # noqa: E402
from gpu_bpe_tpu.ops import stab_kernels as jsk  # noqa: E402
from gpu_bpe_tpu.ops import tokenize as jtz  # noqa: E402
from gpu_bpe_tpu_torch.ops import kernels as tk  # noqa: E402
from gpu_bpe_tpu_torch.ops import stab_kernels as tsk  # noqa: E402
from gpu_bpe_tpu_torch.ops import tokenize as ttz  # noqa: E402

BLOCK = pk.BLOCK  # 2^15
SBLK = jsk.SBLK  # 2^14


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# ───────────────────────────── compact_mask ─────────────────────────────


def _compact_case(name, rng):
    """(primary, extras) of one named case; dropped entries are 0xFFFFFFFF."""
    def payloads(n, hi=0xFFFF):
        return rng.integers(0, hi, size=n, dtype=np.uint64).astype(np.uint32)

    if name == "random":
        v = payloads(BLOCK + 4096)
        v[rng.random(v.size) < 0.7] = 0xFFFFFFFF
        return v, 0
    if name == "all_dropped":
        return np.full(BLOCK, 0xFFFFFFFF, np.uint32), 1
    if name == "none_dropped":
        return payloads(2 * BLOCK), 2
    if name == "ragged":
        v = payloads(3 * BLOCK // 2 + 321)
        v[rng.random(v.size) < 0.5] = 0xFFFFFFFF
        return v, 3
    if name == "block_runs":
        v = payloads(3 * BLOCK)
        v[BLOCK - 100 : 2 * BLOCK + 100] = 0xFFFFFFFF
        v[: BLOCK // 2] = 0xFFFFFFFF
        return v, 1
    tile = tk.COMPACT_TILE  # entries per block of the CUDA kernel
    straddle = {"tile_minus_1": (tile - 1, 0), "tile": (tile, 1), "tile_plus_1": (tile + 1, 3),
                "two_tiles_plus_1": (2 * tile + 1, 9)}
    if name in straddle:
        n, n_extra = straddle[name]
        v = payloads(n)
        v[rng.random(n) < 0.5] = 0xFFFFFFFF
        v[-1] = 0x1234  # the last entry survives
        return v, n_extra
    if name == "last_tile_only":
        # survivors only in the last (ragged) tile: a long look-back over
        # empty tiles on the card
        v = np.full(5 * tile + 33, 0xFFFFFFFF, np.uint32)
        v[4 * tile + 1 :: 3] = payloads(v[4 * tile + 1 :: 3].size)
        return v, 3
    if name == "all_kept":
        return payloads(3 * tile - 5), 9
    if name == "high_bits":
        # payloads with bits above 16 set: the primary keeps the low 16
        v = payloads(BLOCK + 77, hi=0xFFFFFFFF)
        v[rng.random(v.size) < 0.4] = 0xFFFFFFFF
        v[:6] = [0xFFFF, 0xFFFFFFFF, 0x0000, 0xFFFE, 0x8001_2345, 0xFFFF_FFFE]
        return v, 2
    raise KeyError(name)


CASES = ["random", "all_dropped", "none_dropped", "ragged", "block_runs", "high_bits",
         "tile_minus_1", "tile", "tile_plus_1", "two_tiles_plus_1", "last_tile_only", "all_kept"]


@pytest.mark.parametrize("name", CASES)
def test_compact_mask_matches_pallas(name):
    rng = np.random.default_rng(CASES.index(name))
    prim, n_extra = _compact_case(name, rng)
    n = prim.size
    extras = [rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32) for _ in range(n_extra)]
    want, want_total = pk.compact_mask(jnp.asarray(prim), [jnp.asarray(e) for e in extras],
                                       interpret=True)
    got, got_total = tk.compact_mask(_i32(prim), [_i32(e) for e in extras])
    total = int(want_total)
    assert int(got_total) == total == int(np.sum(prim != 0xFFFFFFFF))
    assert len(got) == 1 + n_extra
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(_u32(g)[:total], np.asarray(w)[:total])
    np.testing.assert_array_equal(_u32(got[0])[:total], prim[prim != 0xFFFFFFFF] & 0xFFFF)


@pytest.mark.parametrize("name", ["random", "all_dropped", "ragged", "high_bits", "tile_minus_1", "tile",
                                  "tile_plus_1", "last_tile_only"])
def test_compact_valid_matches_pallas(name):
    prim, _ = _compact_case(name, np.random.default_rng(7))
    want, want_total = pk.compact_valid(jnp.asarray(prim), interpret=True)
    got, got_total = tk.compact_valid(_i32(prim))
    total = int(want_total)
    assert int(got_total) == total
    np.testing.assert_array_equal(_u32(got)[:total], np.asarray(want)[:total])


# ───────────────────────────── expand_to_mask ────────────────────────────


def _expand_case(name, rng):
    if name == "sparse":
        n = 2 * BLOCK + 555
        return rng.random(n) < 0.1, n
    if name == "dense":
        n = BLOCK + 2048
        return rng.random(n) < 0.95, n
    if name == "all_set":
        return np.ones(2 * BLOCK, bool), 2 * BLOCK
    if name == "none_set":
        return np.zeros(BLOCK, bool), 0
    if name == "straddles_tiles":
        mask = np.zeros(3 * BLOCK, bool)
        mask[:777] = True
        mask[BLOCK : BLOCK + 5000] = True
        mask[2 * BLOCK + 100 :: 7] = True
        return mask, 3 * BLOCK
    if name == "max_displacement":
        mask = np.zeros(2 * BLOCK, bool)
        mask[BLOCK - 1] = mask[2 * BLOCK - 1] = True
        return mask, 2 * BLOCK
    tile = tk.EXPAND_TILE  # entries per block of the CUDA kernel
    sizes = {"tile_minus_1": tile - 1, "tile": tile, "tile_plus_1": tile + 1}
    if name in sizes:
        mask = rng.random(sizes[name]) < 0.5
        return mask, int(mask.sum())
    if name == "set_only_in_last_tile":
        # a look-back over empty tiles on the card
        mask = np.zeros(4 * tile + 77, bool)
        mask[4 * tile + 1 :: 3] = True
        return mask, int(mask.sum())
    if name == "vals_longer_than_count":
        mask = rng.random(2 * BLOCK + 99) < 0.3
        return mask, int(mask.sum()) + 1000
    raise KeyError(name)


@pytest.mark.parametrize("name", ["sparse", "dense", "all_set", "none_set", "straddles_tiles",
                                  "max_displacement", "tile_minus_1", "tile", "tile_plus_1",
                                  "set_only_in_last_tile", "vals_longer_than_count"])
def test_expand_to_mask_matches_pallas(name):
    rng = np.random.default_rng(11)
    mask, n_vals = _expand_case(name, rng)
    vals = rng.integers(0, 2**32, size=n_vals, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(pk.expand_to_mask(jnp.asarray(mask), jnp.asarray(vals), interpret=True))
    got = tk.expand_to_mask(torch.from_numpy(mask), _i32(vals))
    np.testing.assert_array_equal(_u32(got), want)


def test_expand_compact_roundtrip():
    rng = np.random.default_rng(12)
    n = BLOCK + 4321
    prim = rng.integers(0, 0xFFFF, size=n, dtype=np.uint64).astype(np.uint32)
    drop = rng.random(n) < 0.6
    prim[drop] = 0xFFFFFFFF
    ex = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    outs, _ = tk.compact_mask(_i32(prim), [_i32(ex)])
    back = tk.expand_to_mask(torch.from_numpy(~drop), outs[1])
    j_outs, _ = pk.compact_mask(jnp.asarray(prim), [jnp.asarray(ex)], interpret=True)
    j_back = pk.expand_to_mask(jnp.asarray(~drop), j_outs[1], interpret=True)
    np.testing.assert_array_equal(_u32(back), np.where(~drop, ex, 0).astype(np.uint32))
    np.testing.assert_array_equal(_u32(back), np.asarray(j_back))


# ─────────────────────────────── overlay_fit ─────────────────────────────


def _stab_vocab(extra=()):
    """2600 short tokens over 8 letters, long tokens with shared prefixes
    (two chained levels with the level threshold at 1), and an 'a'-run
    group that covers long runs of positions."""
    rng = np.random.default_rng(61)
    toks = {bytes([b]) for b in range(256)}
    vocab = [bytes([b]) for b in range(256)]
    while len(vocab) < 2600:
        t = bytes(rng.integers(97, 105, size=int(rng.integers(2, 9))).tolist())
        if t not in toks:
            toks.add(t)
            vocab.append(t)
    return vocab + [b"the quick brown", b"the quick brown fox j", b"prefixAAsuffix", b"aaaaaaaaa",
                    *extra]


def _data(n_bytes: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    filler = bytes(rng.integers(97, 105, size=n_bytes).tolist())
    mid = n_bytes // 3
    body = (filler[:mid] + b"the quick brown fox jQQprefixAAsuffixZ" * 30 + b"aaaaaaaab" * 600
            + filler[mid:])
    return body[:n_bytes]


def _streams(vocab, data: bytes, level: int, nseg: int, seg: int, monkeypatch):
    """The sorted [nseg, seg + 2V] stream of the level-1 join (level 1) or
    of the first chained level (level 2) over ``nseg * seg`` positions
    holding ``data``, built by the port's join; returns (skp int32, V)."""
    monkeypatch.setattr(ttz, "_LEVEL_MIN_TOKENS", 1)
    t = ttz.MatchTables.from_vocab(vocab)
    st = ttz._StabTables(t.stab, "cpu")
    n = nseg * seg
    assert len(data) <= n
    buf = np.zeros(n, np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    d = torch.from_numpy(buf)
    iota = torch.arange(n, dtype=torch.int64)
    w0, w1 = ttz._pack_bytes(d, 0, 4), ttz._pack_bytes(d, 4, 4)
    if level == 1:
        skp, _ = ttz._sorted_rows(w0, w1, iota, st.level1, nseg, seg)
        return skp, st.level1.count
    _, gid = ttz._stab_join(w0, w1, iota, st.level1, len(data), 2048, base_len=0, max_depth=8,
                            depths=10, group_depth=9)
    sw0 = (gid << 16) | ttz._pack_bytes(d, 8, 2)
    skp, _ = ttz._sorted_rows(sw0, ttz._pack_bytes(d, 10, 4), iota, st.levels[0], nseg, seg)
    return skp, st.levels[0].count


# (level, nseg, m, chunk_size, input_len cut, depths, base_len, max_depth, group_depth)
OVERLAY_CASES = {
    "level1_groups_two_segments": (1, 2, 2 * SBLK, 2048, 0, 10, 0, 8, 9),
    "level1_no_group_slot": (1, 1, 2 * SBLK, 2048, 0, 9, 0, 8, -1),
    "level1_chunk512_ragged_input": (1, 3, SBLK, 512, 1234, 10, 0, 8, 9),
    "level2_base8_groups": (2, 2, 2 * SBLK, 2048, 0, 8, 8, 6, 7),
    "level2_last_level": (2, 1, 3 * SBLK, 512, 77, 7, 8, 6, -1),
}


@pytest.mark.parametrize("case", list(OVERLAY_CASES))
def test_overlay_fit_matches_pallas(case, monkeypatch):
    level, nseg, m, cs, cut, depths, base_len, max_depth, gd = OVERLAY_CASES[case]
    vocab = _stab_vocab()
    v = 4096 if level == 1 else 256  # row counts of this vocab's tables
    seg = m - 2 * v
    data = _data(nseg * seg - cut, seed=len(case))
    skp, v_got = _streams(vocab, data, level, nseg, seg, monkeypatch)
    assert v_got == v and skp.shape == (nseg, m)
    # the stream exercises what the case names: opens at the group slot
    # that close in a later 2^14 block, positions near chunk ends
    kp = _u32(skp).astype(np.int64)
    assert ((kp >> 30) == 1).sum() >= seg and ((kp >> 30) == 0).any()
    kw = dict(chunk_size=cs, depths=depths, base_len=base_len, max_depth=max_depth, group_depth=gd)
    got = tsk.overlay_fit(skp, len(data), **kw)
    want = jsk.overlay_fit(jnp.asarray(_u32(skp)), len(data), interpret=True, **kw)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(_u32(g), np.asarray(w))
    assert (_u32(got[0]) > 0).any()
    if gd >= 0:  # level 1: the "aaaaaaaa" group of the a-runs; level 2: "the quick brow"
        assert (_u32(got[2]) != 0xFFFF).sum() >= (600 if level == 1 else 30)


def test_overlay_group_spans_blocks(monkeypatch):
    """A group interval whose open and close lie in different 2^14-row
    blocks (and many 2048-row tiles) of the sorted stream: the state must
    carry across tiles and end at the close."""
    vocab = _stab_vocab()
    m = 4 * SBLK
    data = b"a" * 40_000 + b"b" * (m - 2 * 4096 - 40_000)
    skp, _ = _streams(vocab, data, 1, 1, m - 2 * 4096, monkeypatch)
    kw = dict(chunk_size=2048, depths=10, base_len=0, max_depth=8, group_depth=9)
    got = tsk.overlay_fit(skp, len(data), **kw)
    want = jsk.overlay_fit(jnp.asarray(_u32(skp)), len(data), interpret=True, **kw)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(_u32(g), np.asarray(w))
    in_group = np.nonzero(_u32(got[2])[0] != 0xFFFF)[0]
    assert in_group.size > 0 and in_group[0] // SBLK != in_group[-1] // SBLK


@pytest.mark.parametrize("m", [20_000, 2 * 4096 + 777])
def test_overlay_fit_any_m_matches_xla(m, monkeypatch):
    """m not a multiple of the Pallas block: the port takes any m; the
    reference is the JAX package's XLA doubling scan."""
    vocab = _stab_vocab()
    seg = m - 2 * 4096
    data = _data(seg, seed=m)
    skp, _ = _streams(vocab, data, 1, 1, seg, monkeypatch)
    monkeypatch.setenv("GPU_BPE_TPU_STAB_SCAN", "0")
    packed, key2, gid = jtz._overlay_fit_dispatch(jnp.asarray(_u32(skp)), m, 10, len(data), 512, 0, 8, 9)
    got = tsk.overlay_fit(skp, len(data), chunk_size=512, depths=10, group_depth=9)
    for g, w in zip(got, (packed, key2, gid), strict=True):
        np.testing.assert_array_equal(_u32(g), np.asarray(w))


def _overlay_rows(rng, nseg, m, *, p_op, pos_hi):
    """Random u32 [nseg, m] overlay rows: opens and closes (16-bit ids, as
    the join's vocab and group ids are; depths 0..11, some outside the
    slots) with probability p_op, else positions below pos_hi."""
    flag = np.where(rng.random((nseg, m)) < p_op, rng.choice([0, 2], size=(nseg, m)), 1).astype(np.uint32)
    depth = rng.integers(0, 12, size=(nseg, m), dtype=np.uint32)
    pay = np.where(flag == 1, rng.integers(0, pos_hi, size=(nseg, m)),
                   rng.integers(0, 1 << 16, size=(nseg, m))).astype(np.uint32)
    return (flag << 30) | (depth << 25) | pay


def _overlay_synthetic(name):
    """(skp u32 [nseg, m], input_len, overlay kwargs) of one named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    base = dict(chunk_size=512, depths=10, base_len=0, max_depth=8, group_depth=9)
    if name == "many_short_segments":
        # a segment start every 20,000 rows (about 5 tiles of the CUDA
        # kernel) and every other segment without ops: the carry must
        # restart at each
        kp = _overlay_rows(rng, 6, 20_000, p_op=0.05, pos_hi=200_000)
        kp[1::2] = (1 << 30) | (kp[1::2] & 0x1FFFF)
        return kp, 150_000, base
    if name == "chunk_1000":
        kp = _overlay_rows(rng, 2, SBLK, p_op=0.05, pos_hi=40_000)
        at = np.array([999, 1000, 1999, 2000, 33_332, 33_333, 0, 1], np.uint32)
        kp[:, 50 : 50 + at.size] = (1 << 30) | at
        kp[:, -at.size :] = (1 << 30) | at
        return kp, 33_333, dict(base, chunk_size=1000, base_len=2)
    if name == "carry_over_empty_tiles":
        # opens (ids >= 0x8000) in the first rows, positions that fit
        # nothing through the middle, real positions in the last 4096 rows
        kp = np.full((1, 2 * SBLK), (1 << 30) | 0x1FFFFFF, np.uint32)
        opens = np.arange(900, dtype=np.uint32)
        kp[0, :900] = ((opens % 9 + 1) << 25) | (0x8000 + opens * 31)
        kp[0, -4096:] = (1 << 30) | (np.arange(4096, dtype=np.uint32) * 7)
        return kp, 4096 * 7, base
    if name == "group_depth_last_above_max_depth":
        return (_overlay_rows(rng, 2, SBLK, p_op=0.1, pos_hi=70_000), 65_536,
                dict(chunk_size=2048, depths=7, base_len=8, max_depth=4, group_depth=6))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["many_short_segments", "chunk_1000", "carry_over_empty_tiles",
                                  "group_depth_last_above_max_depth"])
def test_overlay_fit_synthetic_streams(name, monkeypatch):
    """Random and structured streams: against the Pallas function where m
    is a multiple of its block, else against the JAX package's XLA scan,
    one segment at a time (the [1, 20000] shape of the test above)."""
    kp, input_len, kw = _overlay_synthetic(name)
    nseg, m = kp.shape
    got = tsk.overlay_fit(_i32(kp), input_len, **kw)
    if m % SBLK == 0:
        want = jsk.overlay_fit(jnp.asarray(kp), input_len, interpret=True, **kw)
    else:
        monkeypatch.setenv("GPU_BPE_TPU_STAB_SCAN", "0")
        parts = [jtz._overlay_fit_dispatch(jnp.asarray(kp[i : i + 1]), m, kw["depths"], input_len,
                                           kw["chunk_size"], kw["base_len"], kw["max_depth"], kw["group_depth"])
                 for i in range(nseg)]
        want = [np.concatenate([np.asarray(part[k]) for part in parts]) for k in range(3)]
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(_u32(g), np.asarray(w))
    assert (_u32(got[0]) != 0).any() and (_u32(got[2]) != 0xFFFF).any()


def test_new_wrappers_reject_unsupported_devices():
    t = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        tk.compact_mask(t, [t.to("meta")])
    with pytest.raises(ValueError):
        tk.compact_valid(t.to("meta"))
    with pytest.raises(ValueError):
        tk.expand_to_mask(torch.zeros(8, dtype=torch.bool, device="meta"), t)
    with pytest.raises(ValueError):
        tsk.overlay_fit(t.view(1, 8).to("meta"), 8, chunk_size=512, depths=9)
    with pytest.raises(ValueError):
        tsk.overlay_fit(t.view(1, 8), 8, chunk_size=512, depths=11)  # more depths than slots
    for chunk_size, base_len in ((0, 0), (tsk.MAX_CHUNK + 1, 0), (512, -tsk.MAX_CHUNK)):
        with pytest.raises(ValueError):  # the chunk's end must stay in 32 bits
            tsk.overlay_fit(t.view(1, 8), 8, chunk_size=chunk_size, depths=9, base_len=base_len)
