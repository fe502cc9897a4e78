"""Bitonic compare-exchange rounds: CUDA wrapper, its plain PyTorch version
and launch counter (counterpart of the Pallas kernel of
``scripts/microbench_bitonic.py``; the JAX package has no module for it).

The kernel is a microbenchmark's round body: it asks what a hand-made
segment sort would cost beside a library sort on the segments the port
sorts (the recount's ``[cap >> 17, 2^17]`` batched sort, the stab join's
stable sort). No training or tokenize path calls it.

The inputs are three int32 ``[blocks * 1024, 128]`` tensors holding the u32
bit patterns of a key's three words, as the script's. Round ``r`` pairs
element ``e`` of each 128-element row with ``e ^ j``, ``j = 1 << (r % 7)``
(the low element reads ``e + j``, the high one ``e - j``: the script's
``roll(x, 128 - j)`` and ``roll(x, j)``), compares the two triples in
lexicographic unsigned order, and with ``x1 = asc ^ lo``, ``asc =
(fi & k) == 0``, ``k = 1 << (7 + r % 10)`` and ``fi`` the element's flat
index within its 1024-row block, takes the partner's words where
``x1 and self < partner`` or ``not x1 and self > partner``. Equal triples
keep both sides.
"""

from __future__ import annotations

import torch

from .build import LAUNCHES, check, current_stream, on_cpu, on_device, require

ROWS, LANES = 1024, 128  # one block of the script: a 2^17-element segment


def _round(r: int) -> tuple[int, int]:
    """Round ``r``'s lane stride ``j`` and direction bit ``k``."""
    return 1 << (r % 7), 1 << (7 + r % 10)


def _check_inputs(a, b, c, rounds) -> None:
    shape = tuple(a.shape)
    if len(shape) != 2 or shape[1] != LANES or shape[0] == 0 or shape[0] % ROWS:
        raise ValueError(f"bitonic_rounds: want [blocks * {ROWS}, {LANES}] with blocks >= 1, got {shape}")
    for name, t in zip("abc", (a, b, c)):
        require(t, torch.int32, shape, name)
    if not isinstance(rounds, int) or not 0 <= rounds < 2**31:
        raise ValueError(f"bitonic_rounds: rounds must be an int in [0, 2^31), got {rounds!r}")


def bitonic_rounds_plain(a, b, c, rounds: int):
    """Plain PyTorch version of ``bitonic_rounds``: the script's round body,
    with ``torch.roll`` on dim 1 and the compares on int64 copies of the u32
    patterns."""
    _check_inputs(a, b, c, rounds)
    dev = a.device
    lane = torch.arange(LANES, device=dev)
    # fi & k for k >= 128 depends on the block-local row only
    row_fi = (torch.arange(a.shape[0], device=dev) % ROWS * LANES).view(-1, 1)
    words = [a.clone(), b.clone(), c.clone()]
    for r in range(rounds):
        j, k = _round(r)
        lo = (lane & j) == 0
        part = [torch.where(lo, torch.roll(x, LANES - j, 1), torch.roll(x, j, 1)) for x in words]
        u = [x.to(torch.int64) & 0xFFFFFFFF for x in words]
        pu = [x.to(torch.int64) & 0xFFFFFFFF for x in part]
        e0, e1 = u[0] == pu[0], u[1] == pu[1]
        lt = (u[0] < pu[0]) | (e0 & ((u[1] < pu[1]) | (e1 & (u[2] < pu[2]))))
        eq = e0 & e1 & (u[2] == pu[2])
        gt = ~(lt | eq)
        asc = (row_fi & k) == 0
        x1 = asc ^ lo
        take = (x1 & lt) | (~x1 & gt)
        words = [torch.where(take, p, x) for p, x in zip(part, words)]
    return tuple(words)


def bitonic_rounds(a, b, c, rounds: int):
    """``rounds`` compare-exchange rounds over ``[blocks * 1024, 128]``
    int32 words ``a``, ``b``, ``c``: three new tensors of the same shape.
    On the card they are views of one ``[3, rows, 128]`` allocation."""
    _check_inputs(a, b, c, rounds)
    if on_cpu(a, b, c):
        return bitonic_rounds_plain(a, b, c, rounds)
    from .build import load

    dev = a.device
    out = torch.empty(3, *a.shape, dtype=torch.int32, device=dev)
    step = a.numel() * 4
    base = out.data_ptr()
    lib = load()["bitonic_rounds"]
    stream = current_stream(dev)
    with on_device(dev):
        rc = lib.bitonic_rounds(a.data_ptr(), b.data_ptr(), c.data_ptr(), base, base + step, base + 2 * step,
                                a.shape[0], rounds, stream)
    check(rc, "bitonic_rounds")
    LAUNCHES["bitonic_rounds"] += 1
    return out.unbind(0)
