"""The last of the JAX package's surface in the port, on the CPU: the bulk
tokenizer's device list (``ops.tokenize.pass_devices``, the counterpart of
``TPUTokenizer._devices``) and ``GPU_BPE_TPU_TOKENIZE_ALL_DEVICES``,
``utils.PhaseTimer`` against the JAX one, the public names (``FlatTrie``,
``TrieHeader``, ``TrainConfig.extra``, ``api.BPEModel``) and the package's
``__all__`` lists against the JAX package's. Tolerance 0: ids, totals and
reports are compared exactly."""

import importlib
import itertools
import pkgutil
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import gpu_bpe_tpu  # noqa: E402
from gpu_bpe_tpu.core import GreedyTrieEncoder  # noqa: E402
from gpu_bpe_tpu.ops.tokenize import TPUTokenizer  # noqa: E402
from gpu_bpe_tpu.utils import PhaseTimer as JaxPhaseTimer  # noqa: E402

import gpu_bpe_tpu_torch  # noqa: E402
from gpu_bpe_tpu_torch import api  # noqa: E402
from gpu_bpe_tpu_torch.core import BPEModel  # noqa: E402
from gpu_bpe_tpu_torch.models import BPETokenizer  # noqa: E402
from gpu_bpe_tpu_torch.ops import Tokenizer  # noqa: E402
from gpu_bpe_tpu_torch.ops.tokenize import pass_devices  # noqa: E402
from gpu_bpe_tpu_torch.trie import compile as trie_compile  # noqa: E402
from gpu_bpe_tpu_torch.utils import PhaseTimer  # noqa: E402

FLAG = "GPU_BPE_TPU_TOKENIZE_ALL_DEVICES"
# names only JAX needs, and TPUTrainer, whose counterpart is the port's Trainer
JAX_ONLY = {"make_mesh", "make_dist_train_batch", "enable_compile_cache", "TPUTrainer"}


def _set_flag(monkeypatch, flag):
    if flag is None:
        monkeypatch.delenv(FLAG, raising=False)
    else:
        monkeypatch.setenv(FLAG, flag)


@pytest.mark.parametrize("cards", [1, 4])
@pytest.mark.parametrize("flag", [None, "0", "1"])
def test_pass_devices_on_cuda(monkeypatch, cards, flag):
    """Every visible card by default and with the variable at 1, the given
    card alone with it at 0; the list starts at the given card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    _set_flag(monkeypatch, flag)
    every = [torch.device("cuda", i) for i in range(cards)]
    assert pass_devices(torch.device("cuda", 0)) == ([torch.device("cuda", 0)] if flag == "0" else every)
    last = torch.device("cuda", cards - 1)
    want = [last] if flag == "0" else [torch.device("cuda", (cards - 1 + i) % cards) for i in range(cards)]
    assert pass_devices(last) == want


@pytest.mark.parametrize("flag", [None, "0", "1"])
def test_one_device_on_the_cpu(monkeypatch, flag):
    """The CPU is one device: the list is ``[cpu]`` whatever the variable
    says, and ``Tokenizer(device="cpu")`` takes it; an explicit list is used
    as given."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    _set_flag(monkeypatch, flag)
    cpu = torch.device("cpu")
    assert pass_devices(cpu) == [cpu]
    vocab = [bytes([i]) for i in range(256)] + [b"ab", b"abc"]
    assert Tokenizer(vocab, device="cpu").devices == [cpu]
    assert Tokenizer(vocab, device="cpu", devices=["cpu", "cpu"]).devices == [cpu, cpu]


def test_encode_bulk_with_all_devices_matches_jax(monkeypatch):
    """``api.encode_bulk`` on the CPU with GPU_BPE_TPU_TOKENIZE_ALL_DEVICES=1
    equals TPUTokenizer's ids under the same variable (its passes spread
    over the CPU mesh) and with it at 0, and the greedy oracle's
    (``tests/test_ops_tokenize.py``'s round-robin pattern)."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs the multi-device CPU mesh")
    vocab = [bytes([i]) for i in range(256)] + [b"ab", b"abc", b"the ", b"quick"]
    rng = np.random.default_rng(31)
    data = bytes(rng.integers(97, 123, size=9000).tolist()) + b"the quick" * 200

    monkeypatch.setenv(FLAG, "1")
    multi = TPUTokenizer(vocab, chunk_size=512, max_pass_bytes=2048).encode_bytes(data)
    port = api.encode_bulk(BPETokenizer(BPEModel(vocab=vocab, merges=[]), chunk_size=512, device="cpu"), data)
    sliced = Tokenizer(vocab, chunk_size=512, max_pass_bytes=2048, device="cpu").encode_bytes(data)
    monkeypatch.setenv(FLAG, "0")
    single = TPUTokenizer(vocab, chunk_size=512, max_pass_bytes=2048).encode_bytes(data)
    np.testing.assert_array_equal(port, multi)
    np.testing.assert_array_equal(sliced, multi)
    np.testing.assert_array_equal(single, multi)
    np.testing.assert_array_equal(port, np.asarray(GreedyTrieEncoder(vocab, chunk_size=512).encode(data), np.uint32))


# phases: (name, start, end) on a stubbed clock
PHASES = [("ingest", 0.0, 1.5), ("train", 2.0, 65.0), ("ingest", 70.0, 70.25), ("export", 80.0, 200.0),
          ("tiny", 201.0, 201.0)]


def _timed(cls, monkeypatch):
    ticks = iter(itertools.chain.from_iterable((a, b) for _, a, b in PHASES))
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    t = cls()
    for name, _, _ in PHASES:
        with t.phase(name):
            pass
    monkeypatch.undo()
    return t


def test_phase_timer_matches_jax(monkeypatch):
    """The same clock readings give the JAX timer's totals, counts and
    report."""
    port = _timed(PhaseTimer, monkeypatch)
    ref = _timed(JaxPhaseTimer, monkeypatch)
    assert port.totals == ref.totals == {"ingest": 1.75, "train": 63.0, "export": 120.0, "tiny": 0.0}
    assert port.counts == ref.counts == {"ingest": 2, "train": 1, "export": 1, "tiny": 1}
    assert port.report() == ref.report()
    assert port.report().splitlines()[0] == "export: 2m (1x)"


def test_phase_timer_names_profiler_ranges(tmp_path):
    """With ``profile_dir`` a phase is a ``torch.profiler.record_function``
    range of its name; without it, the phase records nothing."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with PhaseTimer(profile_dir=str(tmp_path)).phase("soak-phase-range"):
            torch.ones(8).sum()
        with PhaseTimer().phase("unprofiled-phase"):
            torch.ones(8).sum()
    names = {e.key for e in prof.key_averages()}
    assert "soak-phase-range" in names and "unprofiled-phase" not in names


def test_public_names():
    from gpu_bpe_tpu_torch import trie

    assert trie.FlatTrie is trie_compile.FlatTrie and trie.TrieHeader is trie_compile.TrieHeader
    assert {"FlatTrie", "TrieHeader"} <= set(trie.__all__)
    assert api.BPEModel is BPEModel
    config = api.TrainConfig(extra={"note": 1})
    assert config.extra == {"note": 1} and api.TrainConfig().extra == {}
    assert api.TrainConfig().extra is not api.TrainConfig().extra
    assert "PhaseTimer" in gpu_bpe_tpu_torch.utils.__all__


def _subpackages(pkg) -> dict:
    out = {"": pkg}
    for m in pkgutil.iter_modules(pkg.__path__):
        if m.ispkg:
            out[m.name] = importlib.import_module(f"{pkg.__name__}.{m.name}")
    return out


def test_every_public_name_of_the_jax_package_is_in_the_port():
    """Every name of the ``__all__`` of ``gpu_bpe_tpu`` and of each of its
    subpackages is in the ``__all__`` of the port's counterpart, but for the
    names only JAX needs and ``TPUTrainer``."""
    ref, port = _subpackages(gpu_bpe_tpu), _subpackages(gpu_bpe_tpu_torch)
    missing = {}
    for name, mod in ref.items():
        assert name in port, f"no counterpart of {mod.__name__}"
        gap = set(getattr(mod, "__all__", ())) - set(getattr(port[name], "__all__", ())) - JAX_ONLY
        if gap:
            missing[mod.__name__] = sorted(gap)
    assert not missing
