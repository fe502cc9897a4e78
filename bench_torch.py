"""Headline benchmark of the PyTorch/CUDA port: BPE training merges/s on one card.

    python3 bench_torch.py [--runs 5]          # on the card
    python3 bench_torch.py --selftest-only     # the kernel selftest alone
    python3 bench_torch.py --device cpu --mb 1 --merges 64 --runs 2 \\
        --dense-vocab 300 --tokenize-vocab 400 --passes 1  # a rehearsal on the CPU

The port's counterpart of ``bench.py`` (it imports nothing of that file, of
``gpu_bpe_tpu`` or of JAX). Prints ONE JSON line on stdout:
{"metric": "train_merges_per_sec", "value", "unit", "vs_baseline"}, the
value being the median merges/s of ``--runs`` timed runs. Everything else
goes to stderr, as JSON lines or ``#`` lines, in this order:

  - device: the card's name and power limit (nvidia-smi), torch and CUDA;
  - kernel_build: the seconds to build ``ops/csrc`` (outside every clock);
  - kernel_selftest: ``run_kernel_selftest`` on the device, every case,
    seconds; a false case exits 1;
  - corpus: ``synth_corpus(--mb MiB)`` (seed 0) through ``PreTokenizer``
    (which must run on the native ``cpp-decoder`` backend) and
    ``make_stream(dedup=True)``: stream n, dedup ratio, capacity;
  - train_run: one line per timed run (after one full untimed warm-up run),
    each a fresh ``Trainer`` on a fresh copy of the stream, merges/s on the
    trainer's own clock (``TrainingResult.training_time_s``, started after
    the upload syncs) and the wall time including the upload; the runs must
    give the same merge list;
  - train_runs: median, min and max merges/s, the merge list's hashes, the
    recounts and the training kernels' launches;
  - dist_smoke: ``DistributedTrainer`` in a one-rank group (NCCL on the
    card, gloo on the CPU) for 64 merges; they must equal the single-card
    run's first 64, or the run exits 1;
  - tokenize_mb_per_sec, three rows on one ``Trainer``, as ``bench.py``
    makes them: a trained 1K vocab (dense join), the synthetic 64K vocab
    (the stab chain), then the trained 8K vocab (the headline row, with
    vs_baseline), each with device MB/s (passes on a resident buffer,
    enqueued back to back, timed by CUDA events), wall MB/s (``encode_bytes``
    end to end), bytes per token, stab levels, dense lengths, the walk and
    whether the rank-space chain served the measured passes. As in
    ``bench.py`` the 8K vocab is trained by the Trainer that trained the 1K
    one, so its first entries are the 1K vocab's and the rest come from a
    second run on the raw stream: ``distinct_entries`` says how many differ;
  - kernel_launches: every kernel's launches after the warm-up run (the
    timed runs, the dist smoke and the tokenize rows); on the card each of
    the six JAX kernels' counterparts (and both modes of the merge) must
    have launched, and the rank-space chain must have served one row.

vs_baseline normalises by ``bench.py``'s constants (BASELINE.md): 100 merges/s
and 250 MB/s, its normalisation of the reference WebGPU app.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np

BASELINE_MERGES_PER_SEC = 100.0
BASELINE_TOKENIZE_MB_S = 250.0
TARGET_MERGES = 1024
CORPUS_MB = 16
TOKENIZE_VOCAB = 8192  # the headline tokenize row
DENSE_VOCAB = 1024  # the dense-join row
SYNTH_VOCAB = 65536
DIST_MERGES = 64
RUNS = 5
DEVICE_PASSES = 5  # chained passes behind a device MB/s
GATED = "merge_compact_tracked/gated"  # ops/kernels.py GATED: the default loop's merge
TRAIN_KERNELS = (GATED, "count_pairs2", "window_post")  # what the default training loop launches
TOKENIZE_KERNELS = ("compact_valid", "compact_mask", "expand_to_mask", "overlay_fit", "dense_match", "chunk_walk")
PROBE_LESS = "merge_compact_tracked/probe-less"  # ops/kernels.py PROBE_LESS
BENCH_KERNELS = (*TRAIN_KERNELS, PROBE_LESS, *TOKENIZE_KERNELS)


def synth_corpus(n_bytes: int, seed: int = 0, vocab_size: int = 120_000) -> bytes:
    """``bench.py``'s deterministic Zipfian text over a large synthetic word
    vocabulary (syllable compositions, Zipf rank-frequency sampling; ~5-10x
    unique-word dedup at 16 MB)."""
    rng = np.random.default_rng(seed)
    syllables = np.array(
        [a + b for a in "btkdsmnlrpfgvz" for b in ("a", "e", "i", "o", "u", "ar", "en", "il", "on", "ust")]
        + ["tion", "ing", "er", "ed", "ly", "pre", "con", "anti", "ment", "ness"],
        dtype=object,
    )
    n_syll = rng.integers(1, 5, size=vocab_size)
    words = []
    for k in n_syll:
        idx = rng.integers(0, len(syllables), size=k)
        words.append("".join(syllables[i] for i in idx))
    words = np.array(words, dtype=object)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = ranks**-1.05
    probs /= probs.sum()
    parts = []
    size = 0
    while size < n_bytes:
        idx = rng.choice(vocab_size, size=65536, p=probs)
        text = " ".join(words[i] for i in idx)
        lines = [text[i : i + 80] for i in range(0, len(text), 80)]
        blob = ("\n".join(lines) + "\n").encode()
        parts.append(blob)
        size += len(blob)
    return b"".join(parts)[:n_bytes]


def synth_vocab_64k(corpus: bytes) -> list[bytes]:
    """``bench.py``'s deterministic 65,536-entry vocab: the corpus's frequent
    words and their prefixes (2..20 bytes), padded with numeric strings
    where the corpus runs dry. Its shape (entry count, lengths, shared
    prefixes) sets the stab levels and dense lengths of the wide row."""
    vocab: list[bytes] = [bytes([b]) for b in range(256)]
    seen = set(vocab)
    freq = Counter(corpus.split())
    for w, _ in freq.most_common():
        if len(vocab) >= SYNTH_VOCAB:
            break
        for end in range(2, min(len(w), 20) + 1):
            cand = w[:end]
            if cand not in seen:
                seen.add(cand)
                vocab.append(cand)
                if len(vocab) >= SYNTH_VOCAB:
                    break
    k = 0
    while len(vocab) < SYNTH_VOCAB:
        cand = b"#%d" % k
        if cand not in seen:
            seen.add(cand)
            vocab.append(cand)
        k += 1
    return vocab


def sha_pair(res) -> dict:
    """The certificate recipe's hashes of a merge list and its counts
    (``scripts/validate_certificate.py``)."""
    blob = json.dumps([[a, b, c] for a, b, c in res.merges]).encode()
    return {"sha_merges": hashlib.sha256(blob).hexdigest(),
            "sha_counts": hashlib.sha256(json.dumps(res.merge_counts).encode()).hexdigest()}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_line(torch, device) -> dict:
    """What the run ran on: the card's name and power limit, or the CPU."""
    line = {"torch": torch.__version__, "cuda": torch.version.cuda}
    if device.type == "cuda":
        return {"nvidia_smi": nvidia_smi_line(), "name": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count(), **line}
    return {"nvidia_smi": None, "name": "cpu", "count": 0, **line}


def fresh(stream):
    """A copy of ``stream`` that a trainer may consume."""
    return dataclasses.replace(stream, symbols=stream.symbols.copy(), weights=stream.weights.copy())


def device_rate(torch, tok, data: bytes, passes: int = DEVICE_PASSES) -> dict:
    """``passes`` passes of ``tok`` over ``data`` on a buffer already on
    its device, enqueued back to back (each pass still reads its rank-space
    candidate count on the host), after one warm-up pass: CUDA events on a
    card, the host clock on the CPU. ``rank_space``: the rank-space chain
    (``expand_to_mask``) launched in the timed passes."""
    from gpu_bpe_tpu_torch.ops import kernels

    n = len(data)
    buf = np.zeros(tok.capacity(n), np.uint8)
    buf[:n] = np.frombuffer(data, np.uint8)
    dbuf = torch.from_numpy(buf).to(tok.device)
    tok.encode_pass(dbuf, n)
    before = kernels.LAUNCHES["expand_to_mask"]
    if tok.device.type == "cuda":
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(passes):
            tok.encode_pass(dbuf, n)
        end.record()
        end.synchronize()
        pass_ms = start.elapsed_time(end) / passes
    else:
        t0 = time.perf_counter()
        for _ in range(passes):
            tok.encode_pass(dbuf, n)
        pass_ms = (time.perf_counter() - t0) * 1e3 / passes
    return {"pass_ms": pass_ms, "device_mb_per_s": n / (pass_ms / 1e3) / 1e6,
            "rank_space": kernels.LAUNCHES["expand_to_mask"] > before}


def pass_rates(torch, tok, data: bytes, passes: int = DEVICE_PASSES) -> dict:
    """``device_rate`` and the wall rate: ``encode_bytes`` of ``data`` end
    to end (upload, pass, host copy of the ids), once, after the passes."""
    out = device_rate(torch, tok, data, passes)
    t0 = time.perf_counter()
    tok.encode_bytes(data)
    wall_s = time.perf_counter() - t0
    return {**out, "wall_s": wall_s, "wall_mb_per_s": len(data) / wall_s / 1e6}


def tokenize_row(torch, tok, data: bytes, passes: int = DEVICE_PASSES) -> dict:
    """One pass's worth of ``data`` through ``tok``: the rates, bytes per
    token and the shape of the fast path (``scripts/bench_tokenize_vocabs.py``'s
    row keys, with ``rank_space``). The first ``encode_bytes`` is the warm-up
    and gives the token count."""
    from gpu_bpe_tpu_torch.ops import tokenize as ttz

    pass_bytes = min(len(data), tok.max_pass_bytes)
    chunk = data[:pass_bytes]
    tokens = len(tok.encode_bytes(chunk))
    rates = pass_rates(torch, tok, chunk, passes)
    t = tok.tables
    return {"device_mb_per_sec": rates["device_mb_per_s"], "wall_mb_per_sec": rates["wall_mb_per_s"],
            "bytes_per_token": pass_bytes / max(1, tokens), "tokens": tokens, "pass_ms": rates["pass_ms"],
            "max_token_len": t.max_token_len, "stab_levels": 1 + len(t.stab["levels"]) if t.stab else 0,
            "dense_lengths": t.dense_lengths,
            "walk": "kernel" if tok.device.type == "cuda"
            else "scan64" if t.max_token_len <= ttz._MAX_WALK_STEP else "gather",
            "pass_mb": pass_bytes >> 20, "rank_space": rates["rank_space"]}


def info(obj) -> None:
    print(json.dumps(obj), file=sys.stderr, flush=True)


def fatal(msg: str) -> None:
    print(f"FATAL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--mb", type=int, default=CORPUS_MB, help="corpus MiB")
    ap.add_argument("--merges", type=int, default=TARGET_MERGES)
    ap.add_argument("--runs", type=int, default=RUNS, help="timed training runs; the headline is their median")
    ap.add_argument("--dense-vocab", type=int, default=DENSE_VOCAB, help="the first tokenize row's vocab")
    ap.add_argument("--tokenize-vocab", type=int, default=TOKENIZE_VOCAB, help="the headline tokenize row's vocab")
    ap.add_argument("--passes", type=int, default=DEVICE_PASSES, help="timed passes behind a device MB/s")
    ap.add_argument("--selftest-only", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the bench; returns what it printed (the stdout line under
    ``line``) with the merge list, the stream and the tokenize vocabs.
    Exits non-zero (SystemExit) on a failed check."""
    args = parse_args(argv)
    import torch

    from gpu_bpe_tpu_torch import PreTokenizer, Tokenizer, Trainer, make_stream
    from gpu_bpe_tpu_torch.ops import build, kernels
    from gpu_bpe_tpu_torch.ops.ingest import pad_stream
    from gpu_bpe_tpu_torch.ops.selftest import run_kernel_selftest
    from gpu_bpe_tpu_torch.parallel import DistributedTrainer, one_rank_group
    from gpu_bpe_tpu_torch.unicode import backend_name

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_torch: no CUDA device (pass --device cpu to run on the CPU)")
    cuda = device.type == "cuda"
    where = "1 GPU" if cuda else "cpu"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    info({"metric": "device", **device_line(torch, device)})
    if cuda:
        t0 = time.perf_counter()
        paths = build.build_all()
        info({"metric": "kernel_build", "seconds": time.perf_counter() - t0,
              "libraries": [p.name for p in paths.values()]})

    t0 = time.perf_counter()
    results = run_kernel_selftest(device=device)
    sync()
    info({"metric": "kernel_selftest", "value": results, "seconds": time.perf_counter() - t0})
    bad = [k for k, v in results.items() if not v]
    if bad:
        fatal(f"kernel selftest failed on {device}: {bad}")
    if args.selftest_only:
        line = {"metric": "kernel_selftest_only", "value": "pass"}
        print(json.dumps(line), flush=True)
        return {"line": line, "selftest": results}

    t0 = time.perf_counter()
    corpus = synth_corpus(args.mb << 20)
    gen_s = time.perf_counter() - t0
    backend = backend_name()  # builds the native decoder, outside the clock
    if backend != "cpp-decoder":
        raise AssertionError(f"the pre-tokenizer runs on the {backend} backend, want cpp-decoder")
    t0 = time.perf_counter()
    data, starts = PreTokenizer().pre_tokenize_bytes(corpus)
    pretok_s = time.perf_counter() - t0
    stream = make_stream(data, starts, dedup=True)
    raw = bytes(data)
    capacity = int(pad_stream(stream).symbols.shape[0])
    info({"metric": "corpus", "bytes": len(corpus), "generate_s": gen_s,
          "pretokenize_s": pretok_s, "unicode_backend": backend, "stream_n": stream.n,
          "dedup_ratio": stream.dedup_ratio, "capacity": capacity})

    # ── training: one untimed warm-up run of the full merge count, then the timed runs ──
    target = 256 + args.merges
    t0 = time.perf_counter()
    Trainer(device=device).train_stream(fresh(stream), target_vocab_size=target)
    sync()
    info({"metric": "train_warmup", "wall_s": time.perf_counter() - t0})
    kernels.LAUNCHES.clear()  # the selftest's and the warm-up's launches are not the bench's
    rates, first = [], None
    for i in range(args.runs):
        before = Counter(kernels.LAUNCHES)
        trainer = Trainer(device=device)
        t0 = time.perf_counter()
        res = trainer.train_stream(fresh(stream), target_vocab_size=target)
        sync()
        wall = time.perf_counter() - t0
        rates.append(len(res.merges) / res.training_time_s)
        info({"metric": "train_run", "run": i, "merges": len(res.merges), "seconds": res.training_time_s,
              "merges_per_sec": rates[-1], "wall_s": wall, "recounts": res.recounts,
              "launches": {k: kernels.LAUNCHES[k] - before[k] for k in TRAIN_KERNELS}})
        if first is None:
            first = res
        if (res.merges, res.merge_counts) != (first.merges, first.merge_counts):
            fatal(f"timed run {i} made another merge list than run 0")
    rate = statistics.median(rates)
    info({"metric": "train_runs", "runs": len(rates), "median": rate, "min": min(rates), "max": max(rates),
          "merges": len(first.merges), **sha_pair(first), "recounts": first.recounts,
          "launches": {k: kernels.LAUNCHES[k] for k in TRAIN_KERNELS}})

    # ── the data-parallel path in a group of this process alone ──
    k = min(DIST_MERGES, len(first.merges))
    before = kernels.LAUNCHES[PROBE_LESS]
    t0 = time.perf_counter()
    with one_rank_group(device) as group:
        dres = DistributedTrainer(group).train_stream(fresh(stream), target_vocab_size=256 + k)
        sync()
    ok = (dres.merges, dres.merge_counts) == (first.merges[:k], first.merge_counts[:k])
    info({"metric": "dist_smoke", "ranks": 1, "backend": "nccl" if cuda else "gloo", "merges": len(dres.merges),
          "matches_single_chip": ok, "wall_s": time.perf_counter() - t0,
          "launches": {PROBE_LESS: kernels.LAUNCHES[PROBE_LESS] - before}})
    if not ok:
        fatal("the data-parallel path diverged from the single-card run")

    # ── tokenize: three rows on one Trainer, as bench.py makes them ──
    trainer = Trainer(device=device)
    r_dense = trainer.train_stream(fresh(stream), target_vocab_size=args.dense_vocab)
    vocabs = {str(args.dense_vocab): r_dense.vocab, f"{SYNTH_VOCAB}-synth": synth_vocab_64k(raw)}
    r_tok = trainer.train_stream(fresh(stream), target_vocab_size=args.tokenize_vocab)
    vocabs[str(args.tokenize_vocab)] = r_tok.vocab
    rows = {}
    for label, vocab in vocabs.items():
        before = Counter(kernels.LAUNCHES)
        tok = Tokenizer(vocab, device=device)
        row = tokenize_row(torch, tok, raw, args.passes)
        rows[label] = row
        line = {"metric": "tokenize_mb_per_sec", "value": row["device_mb_per_sec"],
                "unit": f"{'device' if cuda else 'cpu'} MB/s ({row['pass_mb']}MB pass, vocab {label}, {where}; "
                        f"{args.passes} passes on a resident buffer, each reading its rank-space "
                        "candidate count on the host)",
                **{key: v for key, v in row.items() if key != "device_mb_per_sec"},
                "vocab_entries": len(vocab), "distinct_entries": len(set(vocab)),
                "launches": {key: kernels.LAUNCHES[key] - before[key] for key in TOKENIZE_KERNELS}}
        if label == str(args.tokenize_vocab):
            line["vs_baseline"] = row["device_mb_per_sec"] / BASELINE_TOKENIZE_MB_S
        info(line)

    launches = {key: kernels.LAUNCHES[key] for key in BENCH_KERNELS}
    rank_rows = [label for label, row in rows.items() if row["rank_space"]]
    info({"metric": "kernel_launches", "value": launches, "rank_space_rows": rank_rows})
    if cuda:
        missing = [key for key, v in launches.items() if v <= 0]
        if missing:
            fatal(f"kernels never launched in the bench: {missing}")
        if not rank_rows:
            fatal("the rank-space chain served no tokenize row")

    line = {"metric": "train_merges_per_sec", "value": rate,
            "unit": f"merges/s ({args.mb}MB corpus, {args.merges} merges, median of {len(rates)} runs, {where})",
            "vs_baseline": rate / BASELINE_MERGES_PER_SEC}
    print(json.dumps(line), flush=True)
    return {"line": line, "merges": first.merges, "merge_counts": first.merge_counts, "stream": stream,
            "data": raw, "vocabs": vocabs, "rows": rows, "launches": launches}


if __name__ == "__main__":
    main()
