"""The port's randomized soak (``scripts/torch_soak_fuzz.py``) on the CPU:
its trials are the JAX soak's (``scripts/soak_fuzz.py``: the same
vocabularies, data, chunk sizes, word starts and targets from the same
seeds, byte for byte), its ids equal ``TPUTokenizer``'s, a fixed handful
of seeds runs with no failure and writes its artifact, and a planted fault
is reported with its seed and an exit code of 1. Tolerance 0."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import gpu_bpe_tpu.core as jcore  # noqa: E402
import gpu_bpe_tpu.ops as jops  # noqa: E402
import gpu_bpe_tpu.ops.tokenize as jtokenize  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


soak = _load("torch_soak_fuzz")
jsoak = _load("soak_fuzz")


class _Seen:
    """Stand-ins for the JAX soak's device and oracle classes: they record
    what the trial hands them and agree with each other."""

    def __init__(self):
        self.seen = {}
        seen = self.seen

        class Tok:
            def __init__(self, vocab, chunk_size=None, **kw):
                seen.update(vocab=list(vocab), chunk=chunk_size)

            def encode_bytes(self, data):
                seen["data"] = bytes(data)
                return np.zeros(0, np.uint32)

        class Greedy:
            def __init__(self, vocab, chunk_size=None):
                pass

            def encode(self, data):
                return []

        class Result:
            merges: list = []

        class Trainer:
            def train_stream(self, stream, target_vocab_size):
                seen["target"] = target_vocab_size
                return Result()

        class Ref:
            def train(self, symbols, target_vocab_size):
                return Result()

        def make_stream(data, starts, dedup):
            seen.update(data=bytes(data), starts=np.array(starts), dedup=dedup)

        self.Tok, self.Greedy, self.Trainer, self.Ref, self.make_stream = Tok, Greedy, Trainer, Ref, make_stream


@pytest.mark.parametrize("seed", range(1000, 1010))
def test_tokenizer_cases_equal_the_jax_soak(monkeypatch, seed):
    rec = _Seen()
    monkeypatch.setattr(jtokenize, "TPUTokenizer", rec.Tok)
    monkeypatch.setattr(jcore, "GreedyTrieEncoder", rec.Greedy)
    assert jsoak.tokenizer_trial(seed, rank_slice=False) is None
    case = soak.tokenizer_case(seed)
    assert case["vocab"] == rec.seen["vocab"]
    assert case["data"] == rec.seen["data"]
    assert case["chunk"] == rec.seen["chunk"]


@pytest.mark.parametrize("seed", range(1000, 1010))
def test_trainer_cases_equal_the_jax_soak(monkeypatch, seed):
    rec = _Seen()
    monkeypatch.setattr(jops, "TPUTrainer", rec.Trainer)
    monkeypatch.setattr(jops, "make_stream", rec.make_stream)
    monkeypatch.setattr(jcore, "ReferenceTrainer", rec.Ref)
    tseed = seed + soak.TRAINER_SEED_OFFSET
    assert jsoak.trainer_trial(tseed) is None
    case = soak.trainer_case(tseed)
    assert case["data"] == rec.seen["data"]
    np.testing.assert_array_equal(case["starts"], rec.seen["starts"])
    assert (case["dedup"], case["target"]) == (rec.seen["dedup"], rec.seen["target"])


def test_the_port_shapes_reach_their_paths():
    """The gather shape's tokens pass the walk's 63-byte step; the levels
    shape chains stab levels, which no JAX soak shape does."""
    from gpu_bpe_tpu_torch.ops.tokenize import _MAX_WALK_STEP, MatchTables

    for seed in (1000, 1004):
        t = MatchTables.from_vocab(soak.gather_case(seed)["vocab"])
        assert t.max_token_len > _MAX_WALK_STEP
    for seed in (1000, 1005, 1010):
        t = MatchTables.from_vocab(soak.levels_case(seed)["vocab"])
        assert t.stab and t.stab["levels"]
    for seed in range(1000, 1010):
        t = MatchTables.from_vocab(soak.tokenizer_case(seed)["vocab"])
        assert not (t.stab and t.stab["levels"])


@pytest.mark.parametrize("seed", [1000, 1002])
def test_ids_equal_tpu_tokenizer(seed):
    """A dense-join case and a stab-join case: the port's ids on the CPU
    equal TPUTokenizer's on the JAX CPU."""
    from gpu_bpe_tpu_torch.ops import Tokenizer

    case = soak.tokenizer_case(seed)
    assert case["shape"] == ("dense" if seed == 1000 else "chained")
    ref = jtokenize.TPUTokenizer(case["vocab"], chunk_size=case["chunk"]).encode_bytes(case["data"])
    got = Tokenizer(case["vocab"], chunk_size=case["chunk"], device="cpu").encode_bytes(case["data"])
    np.testing.assert_array_equal(got, ref)


def test_soak_runs_a_handful_of_seeds(tmp_path):
    """Five tokenizer seeds (every shape, a rank-space and a multi-pass
    trial) and four trainer seeds (one on each loop), with no failure."""
    out = tmp_path / "soak.json"
    assert soak.main(["--device", "cpu", "--tokenizer-seeds", "5", "--trainer-seeds", "4", "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    assert art["ok"] and art["failures"] == [] and art["device"] == "cpu" and art["nvidia_smi"] is None
    assert art["seed_range"] == [1000, 1004]
    trials = art["trials"]
    assert {f"trainer/{loop}" for loop in soak.LOOPS} <= set(trials)
    assert all(trials[f"trainer/{loop}"] == 1 for loop in soak.LOOPS)
    assert {"tokenizer/dense", "tokenizer/wide", "tokenizer/chained", "tokenizer/gather",
            "tokenizer/levels"} <= set(trials)
    assert trials["rank_vs_full"] >= 1 and trials["multi_pass"] >= 1
    assert art["tokenizer_trials"] == 8 and art["trainer_trials"] == 4
    assert set(art["launches"]) == set(soak.KERNELS) and art["kernels_not_launched"] == []


@pytest.mark.parametrize("kind", ["tokenizer", "trainer"])
def test_planted_failure_is_reported(tmp_path, monkeypatch, kind):
    """A stubbed oracle that disagrees: the failure carries its seed and
    stage, and the script exits 1."""
    if kind == "tokenizer":
        real = soak.GreedyTrieEncoder

        class Oracle(real):
            def encode(self, data):
                ids = list(super().encode(data))
                return [ids[0] ^ 1] + ids[1:]

        monkeypatch.setattr(soak, "GreedyTrieEncoder", Oracle)
        # seed 1001 has one case: the JAX soak's (a wide-walk vocab)
        argv = ["--seed0", "1001", "--tokenizer-seeds", "1", "--trainer-seeds", "0"]
        want = ("tokenizer", 1001, "oracle")
    else:
        real = soak.ReferenceTrainer

        class Oracle(real):
            def train(self, *a, **k):
                r = super().train(*a, **k)
                r.merges = r.merges[:-1]
                return r

        monkeypatch.setattr(soak, "ReferenceTrainer", Oracle)
        argv, want = ["--tokenizer-seeds", "0", "--trainer-seeds", "1"], ("trainer", 1_001_000, "merge_list")
    out = tmp_path / "soak.json"
    assert soak.main(["--device", "cpu", *argv, "--out", str(out)]) == 1
    art = json.loads(out.read_text())
    assert not art["ok"]
    assert [(f["kind"], f["seed"], f["stage"]) for f in art["failures"]] == [want]


def test_no_card_exits_2(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert soak.main(["--tokenizer-seeds", "1", "--out", str(tmp_path / "x.json")]) == 2
    assert not (tmp_path / "x.json").exists()
