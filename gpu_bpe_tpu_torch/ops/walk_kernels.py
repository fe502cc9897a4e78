"""The tokenizer's chunk walk: the CUDA wrapper, its plain PyTorch version,
the numpy mirror of the kernel and the launch counter.

The walk turns a pass's match table into tokens with the reference's
chunked greedy rule: each chunk emits at its first byte, and from an
emitted position p the next emission is ``max(match_len[p], 1)`` bytes on
(1 where nothing matched, which emits the raw byte), never at or past the
chunk's end or the input's. The JAX package runs it as a ``lax.scan`` over
the chunk offsets (``gpu_bpe_tpu/ops/tokenize.py`` ``chunk_walk``);
``chunk_walk_plain`` is that loop in PyTorch, the CPU path and the
kernel's yardstick on the card. ``chunk_walk`` launches
``ops/csrc/chunk_walk.cu`` for CUDA tensors: one launch a pass, a thread
per chunk walking steps staged in shared memory, for any step up to the
chunk size. ``chunk_walk_model`` mirrors the kernel's three stages in
numpy. All give the same tokens.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import INVALID_TOKEN
from .build import LAUNCHES, check, current_stream, on_cpu, on_device, ptr, require
from .kernels import to_i32

MAX_WALK_STEP = 63  # longest jump of the plain walk's 64-bit emission schedule
BLOCK_POSITIONS = 8192  # positions a block of chunk_walk.cu stages (cw_chunks_per_block)
MAX_GROUP = 32  # chunks a block walks, one thread each
MAX_CHUNK = 0x7FFF  # longest chunk the kernel takes: steps and the emission flag share a u16
_EMIT = 0x8000


def chunks_per_block(chunk_size: int) -> int:
    """Chunks one block of ``chunk_walk.cu`` stages and walks
    (``cw_chunks_per_block``)."""
    return max(1, min(MAX_GROUP, BLOCK_POSITIONS // chunk_size))


def _row_stride(chunk_size: int) -> int:
    """u16 entries of a staged chunk row: even, an odd number of 4-byte
    words, so that the walkers of one block start in different banks."""
    even = (chunk_size + 1) & ~1
    return even if (even // 2) % 2 else even + 2


def chunk_walk_plain(match_id, match_len, data, input_len: int, chunk_size: int) -> torch.Tensor:
    """Greedy emission per chunk, all chunks in lockstep (``tokenize.py:885``
    and ``:948``), for match lengths up to ``MAX_WALK_STEP``.

    A Python loop over the chunk offset t keeps one 64-bit schedule per
    chunk, bit k meaning "an emission is due at offset t + k"; bit 0 starts
    set (each chunk emits at its first byte). Each step emits where bit 0
    is set and schedules the next emission ``step`` bytes on. Returns the
    tokens ``[num_chunks, chunk_size]`` int64, position-aligned with PAD
    holes; flattening the non-PAD entries row-major gives the reference's
    output order."""
    n = match_id.shape[0]
    num_chunks = n // chunk_size
    matched = match_id >= 0
    tok = torch.where(matched, match_id, data.to(torch.int64))
    step = torch.clamp(torch.where(matched, match_len, 1), 1, MAX_WALK_STEP)
    # (pending | 1 << step) >> 1 == (pending >> 1) | 1 << (step - 1): the
    # schedule stays below bit 63, so the signed shifts are exact
    half = (torch.ones_like(step) << (step - 1)).view(num_chunks, chunk_size).t().contiguous()
    pending = torch.ones(num_chunks, dtype=torch.int64, device=match_id.device)
    emit = torch.empty(chunk_size, num_chunks, dtype=torch.int64, device=match_id.device)
    sched = torch.empty_like(pending)
    for t in range(chunk_size):
        torch.bitwise_and(pending, 1, out=emit[t])
        torch.mul(emit[t], half[t], out=sched)
        pending >>= 1
        pending |= sched
    # positions past the input emit nothing (a chunk's later offsets are
    # past it too, so what they scheduled is never read)
    allowed = torch.arange(n, device=match_id.device) < input_len
    keep = (emit.t() == 1) & allowed.view(num_chunks, chunk_size)
    return torch.where(keep, tok.view(num_chunks, chunk_size), INVALID_TOKEN)


def chunk_walk_model(match_id, match_len, data, input_len: int, chunk_size: int) -> np.ndarray:
    """The kernel's walk in numpy, block by block: stage the steps (u16,
    clamped to the chunk) and tokens of ``chunks_per_block`` chunks, walk
    each chunk setting the emission flag of its steps, then write every
    position's token or PAD. Returns int32 ``[n]``, as ``chunk_walk``."""
    match_id, match_len, data = (np.asarray(a) for a in (match_id, match_len, data))
    n, cs = match_id.shape[0], chunk_size
    group, stride = chunks_per_block(cs), _row_stride(cs)
    out = np.empty(n, dtype=np.int32)
    for base in range(0, n, group * cs):
        span = min(group * cs, n - base)
        count = span // cs
        p = base + np.arange(span)
        inside = p < input_len
        at = np.minimum(p, n - 1)
        ids, lns = match_id[at], match_len[at]
        step = np.where((ids >= 0) & (lns > 1), np.minimum(lns, cs), 1)
        steps = np.zeros((group, stride), dtype=np.uint16)
        steps[:count, :cs] = np.where(inside, step, 0).reshape(count, cs)
        toks = np.where(ids >= 0, ids & 0xFFFFFFFF, data[at]).astype(np.uint32)
        for j in range(count):
            lim = min(cs, max(0, input_len - (base + j * cs)))
            pos = 0
            while pos < lim:
                s = int(steps[j, pos])
                steps[j, pos] = s | _EMIT
                pos += s
        emitted = (steps[:count, :cs].reshape(-1) & _EMIT) != 0
        out[base : base + span] = np.where(emitted, toks, INVALID_TOKEN).astype(np.uint32).view(np.int32)
    return out


def chunk_walk(match_id, match_len, data, input_len: int, chunk_size: int) -> torch.Tensor:
    """The walk over one pass: ``match_id``/``match_len`` int64 ``[n]`` (as
    ``build_match_table`` gives them; ``match_id`` < 0 emits the byte),
    ``data`` the pass's uint8 ``[n]``, chunks of ``chunk_size`` dividing
    ``n``. Returns int32 ``[n]``, position-aligned: the token's bits at each
    emitted position, PAD's (-1) elsewhere, ready for ``compact_valid``.

    CPU tensors take ``chunk_walk_plain`` (match lengths up to
    ``MAX_WALK_STEP``; the tokenizer takes ``chunk_walk_gather`` past them
    on the CPU); CUDA tensors launch ``chunk_walk.cu``, which takes any
    match length and chunks of up to ``MAX_CHUNK`` bytes."""
    n = match_id.shape[0]
    require(match_id, torch.int64, (n,), "match_id")
    require(match_len, torch.int64, (n,), "match_len")
    require(data, torch.uint8, (n,), "data")
    if chunk_size < 1 or n % chunk_size or not 0 <= input_len <= n:
        raise ValueError(f"chunk_walk: {n} positions, chunk_size {chunk_size}, input_len {input_len}")
    if on_cpu(match_id, match_len, data):
        return to_i32(chunk_walk_plain(match_id, match_len, data, input_len, chunk_size).reshape(-1)).to(torch.int32)
    if chunk_size > MAX_CHUNK:
        raise ValueError(f"chunk_walk: chunks of {chunk_size} bytes, the kernel takes {MAX_CHUNK}")
    from .build import load

    dev = data.device
    lib = load()["chunk_walk"]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    with on_device(dev):
        rc = lib.chunk_walk(ptr(match_id), ptr(match_len), ptr(data), n, int(input_len), int(chunk_size),
                            ptr(out), current_stream(dev))
    check(rc, "chunk_walk")
    LAUNCHES["chunk_walk"] += 1
    return out
