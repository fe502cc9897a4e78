"""The tokenizer's chunk walk (``ops/walk_kernels.py``), held to the plain
walks on the CPU.

``chunk_walk.cu`` runs only on a card (``ops/selftest.py`` and
``chip_smoke.py`` hold it to ``chunk_walk_plain`` there). Here
``chunk_walk_model``, the numpy mirror of the kernel's three stages
(staged u16 steps, the walk that flags emissions, the write), is held
bitwise to ``chunk_walk_plain`` for steps up to 63 bytes and, with PAD
removed, to ``chunk_walk_gather`` for steps up to the chunk size, on
random match tables and on the match tables of real passes.
"""

import numpy as np
import pytest
import torch

from gpu_bpe_tpu_torch import Tokenizer
from gpu_bpe_tpu_torch.ops import build
from gpu_bpe_tpu_torch.ops import kernels as tk
from gpu_bpe_tpu_torch.ops import tokenize as ttz
from gpu_bpe_tpu_torch.ops import walk_kernels as wk
from gpu_bpe_tpu_torch.utils import timing

torch.set_num_threads(1)

CHUNKS = (512, 2048)
ENDS = ("pass_end", "chunk_boundary", "mid_chunk", "first_chunk", "empty")


def _input_len(end: str, n: int, cs: int) -> int:
    return {"pass_end": n, "chunk_boundary": n - 2 * cs, "mid_chunk": n - cs - 217,
            "first_chunk": cs // 3, "empty": 0}[end]


def _table(seed: int, cs: int, max_step: int, chunks: int = 6):
    """A random match table over ``chunks`` chunks: ids up to 2^16 + 9 (a
    few past 16 bits), about a fifth unmatched (id -1, length 0; a few
    unmatched with a length), lengths 0..max_step."""
    rng = np.random.default_rng(seed)
    n = cs * chunks
    mid = rng.integers(0, (1 << 16) + 10, size=n)
    mlen = rng.integers(0, max_step + 1, size=n)
    unmatched = rng.random(n) < 0.2
    mid[unmatched] = -1
    mlen[unmatched & (rng.random(n) < 0.8)] = 0
    data = rng.integers(0, 256, size=n).astype(np.uint8)
    return mid, mlen, data


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _strip(x: np.ndarray) -> np.ndarray:
    return x[x != -1]


@pytest.mark.parametrize("end", ENDS)
@pytest.mark.parametrize("cs", CHUNKS)
def test_model_equals_plain_walk(cs, end):
    mid, mlen, data = _table(cs + len(end), cs, wk.MAX_WALK_STEP)
    n = len(mid)
    input_len = _input_len(end, n, cs)
    got = wk.chunk_walk_model(mid, mlen, data, input_len, cs)
    want = wk.chunk_walk(*_t(mid, mlen, data), input_len, cs)
    assert want.dtype == torch.int32 and want.shape == (n,)
    np.testing.assert_array_equal(got, want.numpy())
    plain = wk.chunk_walk_plain(*_t(mid, mlen, data), input_len, cs)
    np.testing.assert_array_equal(got, ttz._i32(plain.reshape(-1)).numpy())
    assert (got[input_len:] == -1).all()
    if input_len:
        assert got[0] != -1  # a chunk emits at its first byte
        raw = (got != -1) & (mid < 0)
        assert (got[raw] == data[raw]).all()  # unmatched positions emit the byte
        assert raw.any() or input_len < cs


@pytest.mark.parametrize("max_step", [100, 300, "chunk"])
@pytest.mark.parametrize("end", ENDS)
@pytest.mark.parametrize("cs", CHUNKS)
def test_model_equals_gather_walk(cs, end, max_step):
    """Steps past the plain walk's 63 bytes, up to the chunk size and
    beyond it: the model's tokens are the gather walk's."""
    top = 2 * cs if max_step == "chunk" else max_step
    mid, mlen, data = _table(7 * cs + len(end) + top, cs, top)
    n = len(mid)
    input_len = _input_len(end, n, cs)
    got = wk.chunk_walk_model(mid, mlen, data, input_len, cs)
    want = ttz.chunk_walk_gather(*_t(mid, mlen, data), input_len, cs)
    assert want.dtype == torch.int32 and want.shape == (n,)
    np.testing.assert_array_equal(_strip(got), _strip(want.numpy()))
    assert (got[input_len:] == -1).all()
    if input_len >= cs:
        jumps = np.diff(np.flatnonzero(got[:input_len] != -1))
        assert jumps.max() > wk.MAX_WALK_STEP  # the long steps were taken


@pytest.mark.parametrize("vocab", ["dense", "gather"])
def test_model_equals_walks_on_real_match_tables(vocab):
    rng = np.random.default_rng(21)
    base = [bytes([b]) for b in range(256)]
    words = {bytes(rng.integers(97, 101, size=int(rng.integers(2, 9))).tolist()) for _ in range(300)}
    if vocab == "gather":  # tokens past the plain walk's step
        words |= {bytes(rng.integers(97, 99, size=int(rng.integers(64, 201))).tolist()) for _ in range(30)}
    tok = Tokenizer(base[:200] + sorted(words), device="cpu")  # bytes 200..255 stay raw
    toks = sorted(words)
    text = b"".join(toks[int(i)] if i < len(toks) else bytes([200 + int(i) % 56])
                    for i in rng.integers(0, len(toks) + 80, size=6000))
    n = tok.capacity(len(text))
    buf = torch.zeros(n, dtype=torch.uint8)
    input_len = min(len(text), n - 700)
    buf[:input_len] = torch.from_numpy(np.frombuffer(text[:input_len], np.uint8).copy())
    cs = tok.chunk_size
    mid, mlen = ttz.build_match_table(buf, tok.tables, tok._stab_rows, tok._dense, input_len, cs)
    got = wk.chunk_walk_model(mid.numpy(), mlen.numpy(), buf.numpy(), input_len, cs)
    assert ((mid < 0) & (torch.arange(n) < input_len)).any()  # raw bytes to emit
    if vocab == "dense":
        np.testing.assert_array_equal(got, wk.chunk_walk(mid, mlen, buf, input_len, cs).numpy())
    else:
        assert int(mlen.max()) > wk.MAX_WALK_STEP
        want = ttz.chunk_walk_gather(mid, mlen, buf, input_len, cs).numpy()
        np.testing.assert_array_equal(_strip(got), _strip(want))
    ids, total = tok.encode_pass(buf, input_len)
    np.testing.assert_array_equal(_strip(got), ids[: int(total)].numpy())


@pytest.mark.parametrize("cs", [1, 7, 500, 501, 512, 1000, 2048, 8192, 8193, wk.MAX_CHUNK])
def test_block_layout_fits_and_spreads_the_walkers(cs):
    """The kernel's block of ``chunks_per_block`` chunks fits in shared
    memory (u32 tokens and u16 steps), its rows start in distinct banks,
    and the model walks partial last blocks."""
    g = wk.chunks_per_block(cs)
    stride = wk._row_stride(cs)
    assert 1 <= g <= wk.MAX_GROUP and (g * cs <= wk.BLOCK_POSITIONS or g == 1)
    assert stride >= cs and stride % 2 == 0 and (stride // 2) % 2 == 1
    assert g * cs * 4 + g * stride * 2 <= 227 * 1024
    assert len({(j * stride // 2) % 32 for j in range(g)}) == min(g, 32)
    if cs <= 2048:
        mid, mlen, data = _table(cs, cs, min(cs, 40), chunks=g + 3)
        n = len(mid)
        got = wk.chunk_walk_model(mid, mlen, data, n - 1, cs)
        want = ttz.chunk_walk_gather(*_t(mid, mlen, data), n - 1, cs).numpy()
        np.testing.assert_array_equal(_strip(got), _strip(want))


def test_cpu_tensors_take_the_plain_walk(monkeypatch):
    mid, mlen, data = _table(3, 512, 40)
    n = len(mid)

    def no_build():
        raise AssertionError("the CPU path built a kernel")

    monkeypatch.setattr(build, "load", no_build)
    before = tk.LAUNCHES["chunk_walk"]
    got = wk.chunk_walk(*_t(mid, mlen, data), n - 5, 512)
    assert tk.LAUNCHES["chunk_walk"] == before
    np.testing.assert_array_equal(got.numpy(), wk.chunk_walk_model(mid, mlen, data, n - 5, 512))


def _bad_inputs():
    mid, mlen, data = _t(*_table(4, 512, 40, chunks=2))
    n = mid.shape[0]
    return {
        "match_id_int32": (mid.to(torch.int32), mlen, data, n, 512),
        "match_len_float": (mid, mlen.to(torch.float64), data, n, 512),
        "data_int64": (mid, mlen, data.to(torch.int64), n, 512),
        "match_len_short": (mid, mlen[:-512], data, n, 512),
        "data_long": (mid, mlen, torch.cat([data, data]), n, 512),
        "match_id_2d": (mid.view(2, -1), mlen, data, n, 512),
        "match_id_strided": (torch.stack([mid, mid], 1)[:, 0], mlen, data, n, 512),
        "data_strided": (mid, mlen, torch.stack([data, data], 1)[:, 1], n, 512),
        "chunk_not_dividing": (mid, mlen, data, n, 500),
        "chunk_zero": (mid, mlen, data, n, 0),
        "input_past_pass": (mid, mlen, data, n + 1, 512),
        "input_negative": (mid, mlen, data, -1, 512),
        "meta_device": (mid.to("meta"), mlen.to("meta"), data.to("meta"), n, 512),
        "mixed_devices": (mid, mlen.to("meta"), data, n, 512),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_chunk_walk_rejects_what_the_kernel_does_not_take(case):
    before = tk.LAUNCHES["chunk_walk"]
    with pytest.raises(ValueError):
        wk.chunk_walk(*_bad_inputs()[case])
    assert tk.LAUNCHES["chunk_walk"] == before


def test_chunk_walk_never_falls_back_off_the_cpu(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel: where the kernel
    cannot be built, the call raises and the plain walk is not taken; a
    chunk longer than the kernel takes raises before the build."""
    mid, mlen, data = _t(*_table(5, 512, 40, chunks=2))
    n = mid.shape[0]

    def no_compiler():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(wk, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(build, "load", no_compiler)
    monkeypatch.setattr(wk, "chunk_walk_plain", None)
    before = tk.LAUNCHES["chunk_walk"]
    with pytest.raises(RuntimeError, match="nvcc"):
        wk.chunk_walk(mid, mlen, data, n, 512)
    big = wk.MAX_CHUNK + 1
    with pytest.raises(ValueError, match="kernel takes"):
        wk.chunk_walk(*_t(*_table(6, big, 40, chunks=1)), big, big)
    assert tk.LAUNCHES["chunk_walk"] == before


@pytest.mark.parametrize("vocab", ["plain", "gather"])
def test_walk_span_says_which_walk_ran(vocab, monkeypatch):
    """``encode_pass`` notes ``kernel=0`` on the CPU, where it takes the
    plain walk or, past 63-byte tokens, the gather walk."""
    base = [bytes([b]) for b in range(256)]
    tok = Tokenizer(base + ([b"ab", b"C" * 70] if vocab == "gather" else [b"ab"]), device="cpu")
    called = []
    for name in ("chunk_walk", "chunk_walk_gather"):
        fn = getattr(ttz, name)
        monkeypatch.setattr(ttz, name, lambda *a, _fn=fn, _name=name: called.append(_name) or _fn(*a))
    timing.disable()
    timing.clear()
    timing.enable()
    try:
        ids = tok.encode_bytes(b"abab" + b"C" * 150 + b"xab")
        walks = [s for s in timing.spans() if s.name == "tokenize.walk"]
    finally:
        timing.disable()
        timing.clear()
    assert [s.attrs for s in walks] == [{"kernel": 0}]
    assert called == ["chunk_walk_gather" if vocab == "gather" else "chunk_walk"]
    assert tok.decode(ids) == b"abab" + b"C" * 150 + b"xab"
