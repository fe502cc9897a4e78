"""The tokenizer's overlay-scan kernel: CUDA wrapper, its plain PyTorch
version and launch counter (counterpart of ``gpu_bpe_tpu/ops/stab_kernels.py``).

``overlay_fit`` runs over the sorted open/position/close stream of the
interval-stabbing join (``ops/tokenize.py``). Per depth the state of a row
is the payload of the latest open at that depth within the segment, killed
by its close; every position row then takes the deepest open whose token
still fits in the position's chunk, and the group id at ``group_depth``.

The plain version is the XLA path of the JAX package
(``gpu_bpe_tpu/ops/tokenize.py:439-519``: ``_paren_overlay``'s doubling
scan, then ``_deepest_fit``); the CUDA kernel (``ops/csrc/overlay_fit.cu``)
computes the same outputs in one pass, a "latest op" scan over tiles with
decoupled look-back inside each segment. Words are u32 held as int32
tensors of the same bits, as in ``ops/kernels.py``.
"""

from __future__ import annotations

import torch

from .build import LAUNCHES, cached_scratch, check, current_stream, on_cpu, on_device, ptr, require
from .kernels import to_i32

MAX_DEPTHS = 10  # overlay_fit.cu ND: depth slots 0..9
MAX_CHUNK = 1 << 30  # overlay_fit.cu keeps a chunk's end in 32 bits
NO_GROUP = 0xFFFF
OVERLAY_TILE = 4096  # rows per block of overlay_fit.cu (TROWS, of_tile_rows())


def _shift_down(x: torch.Tensor, s: int) -> torch.Tensor:
    """Shift along the last axis by ``s``, filling with zeros."""
    pad = torch.zeros(x.shape[:-1] + (s,), dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :-s]], dim=-1)


def _paren_overlay(sflag, skp, m: int, depths: int):
    """Balanced-parens overlay scan (``tokenize.py:452``): an inclusive
    Hillis-Steele doubling scan that carries, per depth, the payload of the
    innermost enclosing open. Returns (vals [depths, nseg, m] u16 payloads
    in int32, openb [nseg, m] per-depth open bits, spay [nseg, m])."""
    sln = (skp >> 25) & 0x1F
    spay = skp & 0x1FFFFFF
    depth = torch.arange(depths, device=skp.device).view(depths, 1, 1)
    is_open = sflag == 0
    is_close = sflag == 2
    bit = torch.ones_like(sln) << sln
    mod = torch.where(is_open | is_close, bit, 0)
    openb = torch.where(is_open, bit, 0)
    vals = torch.where((sln[None] == depth) & is_open[None], spay[None] & 0xFFFF, 0).to(torch.int32)
    s = 1
    while s < m:
        pv, po, pm = _shift_down(vals, s), _shift_down(openb, s), _shift_down(mod, s)
        bmod_d = ((mod[None] >> depth) & 1) == 1
        vals = torch.where(bmod_d, vals, pv)
        openb = (po & ~mod) | (openb & mod)
        mod = pm | mod
        s <<= 1
    return vals, openb, spay


def _deepest_fit(vals, openb, spay, sflag, input_len: int, chunk_size: int, base_len: int,
                 max_depth: int):
    """Per-position deepest open whose token (``base_len + depth`` bytes)
    fits in the position's chunk (``tokenize.py:492``): packed
    ``len << 16 | id``, 0 where nothing fits."""
    depth = torch.arange(vals.shape[0], device=vals.device).view(-1, 1, 1)
    cend = torch.clamp((spay // chunk_size + 1) * chunk_size, max=input_len)
    fits = base_len + depth <= (cend - spay)[None]
    openable = (((openb[None] >> depth) & 1) == 1) & fits & (sflag == 1)[None] & (depth <= max_depth)
    best_d = torch.where(openable, depth, 0).amax(0)
    best_id = torch.where(openable & (depth == best_d[None]), vals, 0).amax(0).to(torch.int64)
    return torch.where((sflag == 1) & (best_d > 0), ((base_len + best_d) << 16) | best_id, 0)


def overlay_fit_plain(skp, input_len, *, chunk_size: int, depths: int, base_len: int = 0,
                      max_depth: int = 8, group_depth: int = -1):
    """Plain PyTorch version of ``overlay_fit``."""
    kp = skp.to(torch.int64) & 0xFFFFFFFF
    sflag = kp >> 30
    vals, openb, spay = _paren_overlay(sflag, kp, kp.shape[-1], depths)
    packed = _deepest_fit(vals, openb, spay, sflag, int(input_len), chunk_size, base_len, max_depth)
    key2 = torch.where(sflag == 1, spay, 0xFFFFFFFF)
    if group_depth >= 0:
        in_group = ((openb >> group_depth) & 1) == 1
        gid = torch.where(in_group & (sflag == 1), vals[group_depth].to(torch.int64), NO_GROUP)
    else:
        gid = torch.full_like(kp, NO_GROUP)
    return tuple(to_i32(x).to(torch.int32) for x in (packed, key2, gid))


def overlay_fit(skp, input_len, *, chunk_size: int, depths: int, base_len: int = 0,
                max_depth: int = 8, group_depth: int = -1):
    """Paren overlay + deepest fit over a sorted ``[nseg, m]`` stream.

    ``skp`` is int32 ``[nseg, m]`` of u32 rows ``flag << 30 | depth << 25 |
    pay``, sorted within each segment; the scan restarts at each segment.
    ``input_len`` is the pass's byte count (a Python int). Returns
    ``(packed, key2, gid)``, each int32 ``[nseg, m]`` of u32 bits, as the
    Pallas ``overlay_fit``: ``packed = (base_len + d) << 16 | id`` for
    positions with a fitting open, ``key2`` = the position (0xFFFFFFFF for
    vocab rows), ``gid`` = the id of the open at ``group_depth`` (0xFFFF
    where there is none, everywhere when ``group_depth < 0``). ``depths``
    is at most ``MAX_DEPTHS``, ``chunk_size`` at most ``MAX_CHUNK`` and
    ``|base_len|`` below it; any ``m`` is taken. On the card the three outputs are
    views of one ``[3, nseg, m]`` allocation."""
    if not 1 <= depths <= MAX_DEPTHS or group_depth >= depths:
        raise ValueError(f"overlay_fit: depths {depths} (max {MAX_DEPTHS}), group_depth {group_depth}")
    if not 1 <= chunk_size <= MAX_CHUNK or abs(base_len) >= MAX_CHUNK:
        raise ValueError(f"overlay_fit: chunk_size {chunk_size} and |base_len| {abs(base_len)} "
                         f"must lie in [1, {MAX_CHUNK}] and [0, {MAX_CHUNK})")
    if on_cpu(skp):
        return overlay_fit_plain(skp, input_len, chunk_size=chunk_size, depths=depths,
                                 base_len=base_len, max_depth=max_depth, group_depth=group_depth)
    from .build import load

    dev = skp.device
    if skp.dim() != 2:
        raise ValueError(f"overlay_fit: want [nseg, m], got {tuple(skp.shape)}")
    nseg, m = skp.shape
    require(skp, torch.int32, (nseg, m), "skp")
    lib = load()["overlay_fit"]
    stream = current_stream(dev)
    scratch = cached_scratch(("overlay_fit", dev.index, (nseg, m), stream), dev,
                             lambda: lib.of_scratch_words(nseg, m))
    out = torch.empty(3, nseg, m, dtype=torch.int32, device=dev)  # packed, key2, gid
    with on_device(dev):
        rc = lib.overlay_fit(
            ptr(skp), nseg, m, int(input_len), chunk_size, depths, base_len, max_depth, group_depth,
            ptr(out), ptr(scratch), stream,
        )
    check(rc, "overlay_fit")
    LAUNCHES["overlay_fit"] += 1
    return out.unbind(0)
