"""Randomized conformance soak of the port: tokenizer and trainer against
their oracles, on the card (the counterpart of ``scripts/soak_fuzz.py``).

    python scripts/torch_soak_fuzz.py --minutes 20 --out docs/artifacts/torch_soak_fuzz.json
    python scripts/torch_soak_fuzz.py --device cpu --tokenizer-seeds 8 --trainer-seeds 4 --out FILE

Trial ``s`` builds the same vocabulary, data and chunk size as trial ``s``
of the JAX soak (the same generators and numpy seeds: tokenizer seeds from
``--seed0``, 1000, trainer seeds 1,000,000 above them), and runs it through
the port on ``--device``, the card unless "cpu" is asked for:

* tokenizer trials, held to the port's ``GreedyTrieEncoder``: the JAX
  soak's three vocab shapes (a small vocab on the dense join; the stab
  join with 10-60 tokens of 9-32 bytes; 33-60-byte tokens), and two shapes
  of the port's own, each with its own seeds: on every fourth seed
  64-200-byte tokens, which take the gather walk (``chunk_walk_gather``),
  and on every fifth seed 600-1500 tokens of 9-32 bytes, enough to chain
  stab levels >= 2 (a level needs 512 tokens beyond the one before). Those
  also run with ``rank_mode="on"`` (the rank-space chain: ``compact_mask``
  and ``expand_to_mask``) and must equal the full-width ids, the
  counterpart of the JAX ``rank_vs_full`` stage, which the JAX soak's own
  shapes never reach: none has the 512 long tokens a second level needs.
  Every case of every third seed also runs with passes of about a third
  of the input and ``devices=[dev, dev]`` (multi-pass slicing and the
  round robin on one device);
* trainer trials, held to the port's ``ReferenceTrainer`` (merge list and
  counts): the JAX soak's random small corpora, each on one of four loops
  in turn: the default certified loop, ``multi_merge=True``,
  ``force_recount=True`` (which must also recount before every merge) and
  ``DistributedTrainer`` in a one-rank group (the probe-less merge).

The artifact (``--out``) holds the trial counts by kind, the seed and stage
of every failure, every kernel's launches over the run and, on a card, its
name and power limit from ``nvidia-smi``. On a card every kernel must have
launched: the window and probe-less modes of ``merge_compact_tracked``,
``count_pairs2``, ``window_post``, ``compact_valid``, ``compact_mask``,
``expand_to_mask`` and ``overlay_fit``. The script exits 1 on any failure
(a failing seed reproduces deterministically) and 2 without the card it
was asked to run on.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gpu_bpe_tpu_torch.core import GreedyTrieEncoder, ReferenceTrainer, bytes_to_symbols, tag_word_boundaries  # noqa: E402
from gpu_bpe_tpu_torch.ops import Tokenizer, Trainer, make_stream  # noqa: E402
from gpu_bpe_tpu_torch.ops import kernels  # noqa: E402
from gpu_bpe_tpu_torch.parallel import DistributedTrainer, one_rank_group  # noqa: E402

SEED0 = 1000
TRAINER_SEED_OFFSET = 1_000_000  # the JAX soak's
GATHER_SEED_OFFSET = 2_000_000  # the port's own tokenizer shapes' seeds
LEVELS_SEED_OFFSET = 3_000_000
SHAPES = ("dense", "chained", "wide")  # the JAX soak's vocab shapes, by rng.integers(0, 3)
N_SHORT = 2600  # the port's own shapes: the vocab before its long tokens
LOOPS = ("default", "multi_merge", "force_recount", "dist")  # trainer trial s takes LOOPS[s % 4]
KERNELS = ("merge_compact_tracked", kernels.PROBE_LESS, "count_pairs2", "window_post",
           "compact_valid", "compact_mask", "expand_to_mask", "overlay_fit", "dense_match")


def random_vocab(rng, n_total, long_spec, min_long=9):
    """The JAX soak's vocab generator, with the long tokens' shortest length
    as a parameter (9 there)."""
    toks = {bytes([b]) for b in range(256)}
    vocab = [bytes([b]) for b in range(256)]
    alpha_lo, alpha_hi = 97, 97 + int(rng.integers(4, 20))
    while len(vocab) < n_total:
        ln = int(rng.integers(2, 9))
        t = bytes(rng.integers(alpha_lo, alpha_hi, size=ln).tolist())
        if t not in toks:
            toks.add(t)
            vocab.append(t)
    longs = set()
    n_long, max_long = long_spec
    while len(longs) < n_long:
        ln = int(rng.integers(min_long, max_long + 1))
        t = bytes(rng.integers(alpha_lo, alpha_hi, size=ln).tolist())
        if t not in toks:
            longs.add(t)
    return vocab + sorted(longs), alpha_lo, alpha_hi


def tokenizer_case(seed: int) -> dict:
    """Trial ``seed`` of the JAX soak: its shape, vocab, data and chunk size,
    drawn in the same order from the same generator."""
    rng = np.random.default_rng(seed)
    shape = int(rng.integers(0, 3))
    if shape == 0:  # small vocab -> dense join
        vocab, lo, hi = random_vocab(rng, 700, (0, 9))
    elif shape == 1:  # chained levels
        vocab, lo, hi = random_vocab(rng, 2600, (int(rng.integers(10, 60)), 32))
    else:  # wide walk (33..60-byte tokens)
        vocab, lo, hi = random_vocab(rng, 2600, (int(rng.integers(5, 20)), 60))

    pieces = vocab[256:]
    idx = rng.integers(0, len(pieces), size=1500)
    soup = b"".join(pieces[i] for i in idx)
    noise = bytes(rng.integers(lo, hi + 2, size=int(rng.integers(500, 30000))).tolist())
    data = (soup[:40000] + noise)[: int(rng.integers(2000, 60000))]
    chunk = int(rng.choice([512, 1024, 2048]))
    return {"shape": SHAPES[shape], "vocab": vocab, "data": data, "chunk": chunk}


def _own_case(shape: str, rng, n_long: int, min_long: int, max_long: int, long_every: int,
              max_bytes: int) -> dict:
    """A case of the port's own shapes: the JAX soak's short tokens and
    ``n_long`` tokens of ``min_long..max_long`` bytes, a soup in which one
    piece in ``long_every`` is a long token, then noise."""
    vocab, lo, hi = random_vocab(rng, N_SHORT, (n_long, max_long), min_long=min_long)
    short, longs = vocab[256:N_SHORT], vocab[N_SHORT:]
    picks = [longs[int(rng.integers(0, len(longs)))] if i % long_every == 0
             else short[int(rng.integers(0, len(short)))] for i in range(1500)]
    noise = bytes(rng.integers(lo, hi + 2, size=int(rng.integers(500, 30000))).tolist())
    data = (b"".join(picks)[:max_bytes] + noise)[: int(rng.integers(2000, max_bytes + 20000))]
    chunk = int(rng.choice([512, 1024, 2048]))
    return {"shape": shape, "vocab": vocab, "data": data, "chunk": chunk}


def gather_case(seed: int) -> dict:
    """64-200-byte tokens, past the walk's 63-byte step: the gather walk."""
    rng = np.random.default_rng(seed + GATHER_SEED_OFFSET)
    return _own_case("gather", rng, int(rng.integers(5, 20)), 64, 200, long_every=5, max_bytes=60000)


def levels_case(seed: int) -> dict:
    """600-1500 tokens of 9-32 bytes: stab levels >= 2 chain."""
    rng = np.random.default_rng(seed + LEVELS_SEED_OFFSET)
    return _own_case("levels", rng, int(rng.integers(600, 1500)), 9, 32, long_every=3, max_bytes=40000)


def seed_cases(seed: int) -> list[dict]:
    """The tokenizer cases of ``seed``: the JAX soak's, then the port's own
    shapes where the seed takes them."""
    return ([tokenizer_case(seed)] + ([gather_case(seed)] if seed % 4 == 0 else [])
            + ([levels_case(seed)] if seed % 5 == 0 else []))


def trainer_case(seed: int) -> dict:
    """Trainer trial ``seed`` of the JAX soak (``seed`` already offset):
    word-ish text, its word starts, the dedup choice and the target."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2000, 40000))
    data = bytes(rng.integers(97, 97 + int(rng.integers(3, 24)), size=n).tolist())
    starts = np.zeros(n, np.uint8)
    pos = 0
    while pos < n:
        starts[pos] = 1
        pos += int(rng.integers(1, 12))
    target = 256 + int(rng.integers(8, 200))
    dedup = bool(rng.integers(0, 2))
    return {"data": data, "starts": starts, "target": target, "dedup": dedup}


def _fail(kind: str, seed: int, stage: str, **info) -> dict:
    return {"kind": kind, "seed": seed, "stage": stage, **info}


def tokenizer_trial(case: dict, seed: int, dev: torch.device, counts: Counter) -> dict | None:
    """One tokenizer case through the port; the ids must equal the oracle's,
    and those of the rank-space and multi-pass runs where the seed takes
    them. Returns the failure, or None."""
    vocab, data, chunk = case["vocab"], case["data"], case["chunk"]
    counts[f"tokenizer/{case['shape']}"] += 1
    tok = Tokenizer(vocab, chunk_size=chunk, device=dev)
    got = tok.encode_bytes(data)
    ref = np.asarray(GreedyTrieEncoder(vocab, chunk_size=chunk).encode(data), np.uint32)
    if not np.array_equal(got, ref):
        return _fail("tokenizer", seed, "oracle", shape=case["shape"])
    if tok.tables.stab and tok.tables.stab.get("levels"):
        counts["rank_vs_full"] += 1
        rank = Tokenizer(vocab, chunk_size=chunk, rank_mode="on", device=dev).encode_bytes(data)
        if not np.array_equal(rank, got):
            return _fail("tokenizer", seed, "rank_vs_full", shape=case["shape"])
    if seed % 3 == 0:
        counts["multi_pass"] += 1
        sliced = Tokenizer(vocab, chunk_size=chunk, max_pass_bytes=max(chunk, len(data) // 3),
                           device=dev, devices=[dev, dev])
        if not np.array_equal(sliced.encode_bytes(data), got):
            return _fail("tokenizer", seed, "multi_pass", shape=case["shape"])
    return None


def trainer_trial(case: dict, seed: int, dev: torch.device, group, counts: Counter) -> dict | None:
    """One trainer case on loop ``LOOPS[seed % 4]``, held to the reference
    trainer. Returns the failure, or None."""
    loop = LOOPS[seed % len(LOOPS)]
    counts[f"trainer/{loop}"] += 1
    stream = make_stream(case["data"], case["starts"], dedup=case["dedup"])
    if loop == "dist":
        res = DistributedTrainer(group).train_stream(stream, target_vocab_size=case["target"])
    else:
        res = Trainer(device=dev, force_recount=loop == "force_recount",
                      multi_merge=loop == "multi_merge").train_stream(stream, target_vocab_size=case["target"])
    sym = tag_word_boundaries(bytes_to_symbols(np.frombuffer(case["data"], np.uint8)), case["starts"])
    ref = ReferenceTrainer().train(sym, target_vocab_size=case["target"])
    if res.merges != ref.merges:
        return _fail("trainer", seed, "merge_list", loop=loop)
    if res.merge_counts != ref.merge_counts:
        return _fail("trainer", seed, "merge_counts", loop=loop)
    if loop == "force_recount" and (res.recounts < len(res.merges) or res.duals):
        return _fail("trainer", seed, "recounts", loop=loop, recounts=res.recounts, duals=res.duals,
                     merges=len(res.merges))
    return None


def _guarded(fn, kind: str, seed: int) -> dict | None:
    """``fn()``, an exception recorded as the trial's failure."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 (a soak reports every fault and goes on)
        return _fail(kind, seed, "exception", error=f"{type(e).__name__}: {e}"[:500])


def soak(dev: torch.device, seed0: int = SEED0, tokenizer_seeds: float = float("inf"),
         trainer_seeds: float = float("inf"), deadline: float | None = None, progress=None) -> dict:
    """Tokenizer seeds ``seed0 ...`` and trainer seeds ``seed0 + 1e6 ...``
    in turns, as the JAX soak runs them, until both counts are done or the
    ``time.time()`` deadline passes. Returns the result: trial counts by
    kind, failures, launches by kernel (counted from 0 here), seconds."""
    counts: Counter = Counter()
    seconds: Counter = Counter()
    failures: list[dict] = []
    kernels.LAUNCHES.clear()
    t_start = time.perf_counter()
    last = seed0
    with one_rank_group(dev) as group:
        for i in itertools.count():
            if (i >= tokenizer_seeds and i >= trainer_seeds) or (deadline and time.time() >= deadline):
                break
            seed = last = seed0 + i
            if i < tokenizer_seeds:
                t0 = time.perf_counter()
                for case in seed_cases(seed):
                    f = _guarded(lambda c=case: tokenizer_trial(c, seed, dev, counts), "tokenizer", seed)
                    if f:
                        failures.append(f)
                seconds["tokenizer"] += time.perf_counter() - t0
            if i < trainer_seeds and not (deadline and time.time() >= deadline):
                t0 = time.perf_counter()
                tseed = seed + TRAINER_SEED_OFFSET
                f = _guarded(lambda: trainer_trial(trainer_case(tseed), tseed, dev, group, counts),
                             "trainer", tseed)
                if f:
                    failures.append(f)
                seconds["trainer"] += time.perf_counter() - t0
            if progress:
                progress(counts, failures)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = {k: kernels.LAUNCHES[k] for k in KERNELS}
    return {"trials": dict(sorted(counts.items())),
            "tokenizer_trials": sum(v for k, v in counts.items() if k.startswith("tokenizer/")),
            "trainer_trials": sum(v for k, v in counts.items() if k.startswith("trainer/")),
            "failures": failures, "seed_range": [seed0, last], "launches": launches,
            "seconds": time.perf_counter() - t_start, "seconds_by_kind": dict(seconds)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--minutes", type=float, help="run trials in turns until this much time has passed")
    ap.add_argument("--tokenizer-seeds", type=int, help="run this many tokenizer seeds (0 unless given, "
                    "once either count is given; else as many as the time allows)")
    ap.add_argument("--trainer-seeds", type=int, help="run this many trainer seeds (likewise)")
    ap.add_argument("--seed0", type=int, default=SEED0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="docs/artifacts/torch_soak_fuzz.json")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_soak_fuzz: no CUDA device available", file=sys.stderr)
        return 2
    fixed = args.tokenizer_seeds is not None or args.trainer_seeds is not None
    if args.minutes is None and not fixed:
        args.minutes = 30.0  # the JAX soak's default
    from chip_smoke import nvidia_smi_line

    smi = nvidia_smi_line() if dev.type == "cuda" else None
    if smi:
        print(smi, file=sys.stderr, flush=True)
    dev = torch.device("cuda", torch.cuda.current_device()) if dev.type == "cuda" else dev

    def progress(counts, failures):
        print(f"\r{sum(counts.values())} trials, {len(failures)} failures", end="", file=sys.stderr, flush=True)

    deadline = time.time() + args.minutes * 60 if args.minutes is not None else None
    counts = ((args.tokenizer_seeds or 0, args.trainer_seeds or 0) if fixed else (float("inf"), float("inf")))
    out = soak(dev, args.seed0, *counts, deadline, progress)
    print(file=sys.stderr)
    missing = [k for k, v in out["launches"].items() if v == 0] if dev.type == "cuda" else []
    artifact = {"script": "scripts/torch_soak_fuzz.py", "device": str(dev), "nvidia_smi": smi,
                "minutes": args.minutes, **out, "kernels_not_launched": missing,
                "ok": not out["failures"] and not missing,
                "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
        f.write("\n")
    print(json.dumps(artifact))
    return 0 if artifact["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
