"""The port's kernel selftest (ops/selftest.py) on the CPU, and the
explicit-probe mode of ``merge_compact_tracked`` (plain version) against the
Pallas function of the JAX package in interpret mode.

Tolerance 0: every output is compared bit for bit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from gpu_bpe_tpu.ops import pallas_kernels as pk  # noqa: E402
from gpu_bpe_tpu.ops.train_step import apply_merge_device  # noqa: E402
from gpu_bpe_tpu_torch.constants import pack_pair  # noqa: E402
from gpu_bpe_tpu_torch.ops import kernels as tk  # noqa: E402
from gpu_bpe_tpu_torch.ops import selftest  # noqa: E402

JAX_SELFTEST = Path(pk.__file__).with_name("selftest.py")


def _jax_case_names() -> list[str]:
    """The case names of the JAX package's ``run_kernel_selftest``, read
    from its source (running it in interpret mode takes half a minute)."""
    src = JAX_SELFTEST.read_text()
    names = re.findall(r'check_merge\(\s*"(\w+)"|results\["(\w+)"\]|\("(\w+)", _sec\d\)', src)
    return list(dict.fromkeys(n for groups in names for n in groups if n))


def test_selftest_on_cpu_is_all_true():
    results = selftest.run_kernel_selftest(device="cpu")
    assert list(results) == list(selftest.CASES) == _jax_case_names() + ["overlay_fit", "dense_match", "chunk_walk"]
    assert all(results.values()), results


def test_selftest_sees_a_broken_kernel(monkeypatch):
    """A merge that drops the last survivor fails the merge cases."""
    merge = tk.merge_compact

    def broken(*args):
        sym2, w2, n2 = merge(*args)
        return sym2, w2, n2 - 1

    monkeypatch.setattr(tk, "merge_compact", broken)
    results = selftest.run_kernel_selftest(device="cpu")
    assert not any(results[k] for k in ("random_stream", "overlap_quirk", "block_boundary_sites", "poisoned_tail"))
    assert all(v for k, v in results.items() if k not in selftest.CASES[:4])


def test_selftest_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        selftest.run_kernel_selftest()


def test_merge_oracle_equals_apply_merge_device():
    rng = np.random.default_rng(3)
    symf, wf = selftest._random_stream(rng, 3000, alphabet=4)
    n = 2900
    symf[n:], wf[n:] = 0, 0
    for pair in (pack_pair(2, 3), pack_pair(1, 1)):
        got = selftest.apply_merge_np(symf, wf, n, pair, 300)
        want = apply_merge_device(jnp.asarray(symf), jnp.asarray(wf), jnp.asarray(n), jnp.uint32(pair),
                                  jnp.uint32(300))
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
        assert got[2] == int(want[2])


def _probe_case(rng, count, dup=False):
    """A stream over tokens 1..11, a merge of (5, 7) and a probe list of
    ``count`` pairs (affected and unaffected ones, optionally one listed
    twice), the sentinel pair 1 past them."""
    n, cap = 3000, 4096
    sym = np.zeros(cap, np.uint32)
    sym[:n] = rng.integers(1, 12, size=n)
    sym[:n] |= (rng.random(n) < 0.15).astype(np.uint32) << 16
    sym[0] |= 1 << 16
    w = np.zeros(cap, np.int32)
    w[:n] = rng.integers(1, 9, size=n)
    pool = [pack_pair(x, y) for x in range(1, 12) for y in range(1, 12) if (x, y) != (5, 7)]
    words = np.ones(tk.N_PROBES, np.uint32)
    picked = rng.permutation(pool)[:count]
    if dup and count >= 2:
        picked[-1] = picked[0]
    words[:count] = picked
    return sym, w, n, words


@pytest.mark.parametrize("count,dup", [(0, False), (3, False), (17, True), (tk.N_PROBES, False)])
def test_explicit_probes_plain_equals_pallas(count, dup):
    rng = np.random.default_rng(40 + count)
    sym, w, n, words = _probe_case(rng, count, dup)
    pair, new_id = pack_pair(5, 7), 300
    want = pk.merge_compact_tracked(jnp.asarray(sym), jnp.asarray(w), jnp.asarray(n), jnp.uint32(pair),
                                    jnp.uint32(new_id), probes=(jnp.asarray(words), jnp.asarray(count, jnp.int32)),
                                    interpret=True)
    got = tk.merge_compact_tracked(torch.from_numpy(sym.view(np.int32)), torch.from_numpy(w), n, pair, new_id,
                                   probes=(torch.from_numpy(words.astype(np.int64)), count))
    assert len(got) == len(want) == 7
    for g, x in zip(got, want):
        g, x = g.numpy(), np.asarray(x)
        if g.dtype == np.int32 and x.dtype == np.uint32:
            g = g.view(np.uint32)
        np.testing.assert_array_equal(g.astype(np.float64), x.astype(np.float64))
    pcnt = got[6].numpy()
    assert (pcnt[count:] == 0).all() and (count == 0 or pcnt[:count].any())


def test_explicit_probes_equal_window_mode_on_its_list():
    """Given the window's own probe list and count, the explicit mode counts
    what window mode counts."""
    rng = np.random.default_rng(5)
    sym, w, n, _ = _probe_case(rng, 0)
    cand = np.full(tk.W_SLOTS, tk.INVALID, np.int64)
    counts = np.full(tk.W_SLOTS, -1, np.int64)
    cand[:6] = [pack_pair(3, 5), pack_pair(7, 2), pack_pair(5, 7), pack_pair(9, 9), pack_pair(2, 5), pack_pair(7, 7)]
    counts[:6] = 50
    args = (torch.from_numpy(sym.view(np.int32)), torch.from_numpy(w), n, pack_pair(5, 7), 300)
    win = tk.merge_compact_tracked(*args, torch.from_numpy(cand), torch.from_numpy(counts))
    exp = tk.merge_compact_tracked(*args, probes=(win[7], win[8]))
    for a, b in zip(win[:7], exp):
        assert torch.equal(a, b)
    assert int(win[8]) == 4


def test_explicit_probes_are_exclusive_with_a_window():
    sym = torch.zeros(2048, dtype=torch.int32)
    w = torch.zeros(2048, dtype=torch.int32)
    window = (torch.full((tk.W_SLOTS,), -1, dtype=torch.int64), torch.full((tk.W_SLOTS,), -1, dtype=torch.int64))
    with pytest.raises(ValueError, match="exclusive"):
        tk.merge_compact_tracked(sym, w, 0, 1, 300, *window, probes=(np.ones(tk.N_PROBES), 0))
    assert tk.EXPLICIT_PROBES not in (tk.PROBE_LESS, "merge_compact_tracked")
