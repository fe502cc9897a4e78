"""Streamed training of the port at the data size users call real.

    python scripts/torch_validate_stream.py [--gb 1] [--vocab 32768] [--device cuda] [--out FILE]

The port's counterpart of ``scripts/validate_stream.py``: a Zipfian corpus
of ``--gb`` GiB written to a temporary file in 256 MiB slabs (seeds 0, 1,
...; the generator is a copy of that script's ``synth_slab_fast``), then
``api.train_files`` on it (64 MB chunks, the native ingest, the Unicode
pre-tokenizer, dedup) to ``--vocab`` tokens on ``--device``. It prints one
JSON line: the merge list's fingerprint ``merge_list_sha256_16`` (the first
16 hex digits of the SHA-256 of ``json.dumps`` of ``[[a, b, id], ...]``),
corpus, ingest (``make_stream_chunked``, timed by wrapping it) and training
seconds, the stream's size, merges/s, recounts by tier, the process's peak
RSS after the corpus is written, after ingest and at the end, the card's
peak allocated memory, whether the saved
model loads back and round-trips a sample, the card's name and power limit.
Where the JAX package recorded a run of the same size and vocab
(``docs/artifacts/stream_*.json``), the fingerprint must equal its
``merge_list_sha256_16``; the script exits non-zero otherwise. ``--out``
also writes the JSON there.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import resource
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
SLAB = 1 << 28  # 256 MiB


def synth_slab_fast(n_bytes: int, seed: int, vocab_size: int = 120_000) -> bytes:
    """A Zipfian corpus slab over a synthetic word table of syllable
    compositions (``scripts/validate_stream.py``'s generator): the word
    table is rendered once, draws by inverse-CDF sampling, a newline every
    80 bytes (which may split a word)."""
    rng = np.random.default_rng(seed)
    syllables = [a + b for a in "btkdsmnlrpfgvz" for b in ("a", "e", "i", "o", "u", "ar", "en", "il", "on", "ust")]
    syllables += ["tion", "ing", "er", "ed", "ly", "pre", "con", "anti", "ment", "ness"]
    n_syll = rng.integers(1, 5, size=vocab_size)
    syl_idx = rng.integers(0, len(syllables), size=int(n_syll.sum()))
    words = []
    pos = 0
    for k in n_syll:
        words.append("".join(syllables[i] for i in syl_idx[pos : pos + k]) + " ")
        pos += k
    blobs = [w.encode() for w in words]
    lens = np.array([len(b) for b in blobs], np.int64)
    offs = np.zeros(vocab_size + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    pool = np.frombuffer(b"".join(blobs), np.uint8)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = ranks**-1.05
    cdf = np.cumsum(probs / probs.sum())

    draws_per_round = 1 << 20
    out = np.empty(int(n_bytes * 1.05) + 64, np.uint8)
    written = 0
    while written < n_bytes:
        idx = np.searchsorted(cdf, rng.random(draws_per_round)).clip(0, vocab_size - 1)
        total = int(lens[idx].sum())
        starts = offs[idx]
        wl = lens[idx]
        dst_off = np.zeros(len(idx), np.int64)
        np.cumsum(wl[:-1], out=dst_off[1:])
        flat = np.repeat(starts + wl - 1, wl)  # each word's last byte, repeated
        ramp = np.arange(total, dtype=np.int64) - np.repeat(dst_off + wl - 1, wl)
        chunk = pool[flat + ramp]
        chunk[79::80] = 0x0A
        take = min(total, len(out) - written)
        out[written : written + take] = chunk[:take]
        written += take
    return out[:n_bytes].tobytes()


def synth_to_disk(path: str, n_bytes: int) -> None:
    """The corpus written slab by slab (seeds 0, 1, ...), so host memory
    stays at one slab."""
    with open(path, "wb") as f:
        written, seed = 0, 0
        while written < n_bytes:
            blob = synth_slab_fast(min(SLAB, n_bytes - written), seed=seed)
            f.write(blob)
            written += len(blob)
            seed += 1


def recorded(gb: float, vocab: int) -> dict | None:
    """The JAX package's streamed run of the same size and vocab."""
    for path in sorted((REPO / "docs" / "artifacts").glob("stream_*.json")):
        rec = json.loads(path.read_text())
        if rec.get("corpus_gb") == gb and rec.get("vocab_target") == vocab:
            return {"file": str(path.relative_to(REPO)), "merge_list_sha256_16": rec["merge_list_sha256_16"]}
    return None


def rss() -> int:
    """The process's peak resident set so far, in bytes."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def card(device: str) -> dict:
    if device == "cpu":
        return {"device": "cpu"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    return {"device": "cuda", "nvidia_smi": smi}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gb", type=float, default=1.0)
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    from gpu_bpe_tpu_torch import api
    from gpu_bpe_tpu_torch.ops import ingest, native
    from gpu_bpe_tpu_torch.ops import train_step as ts

    ingested = {}
    chunked = ingest.make_stream_chunked

    def timed_ingest(*a, **kw):  # what api.train_files calls for its stream
        t = time.perf_counter()
        stream = chunked(*a, **kw)
        ingested.update(ingest_seconds=time.perf_counter() - t, stream_n=stream.n, peak_rss_after_ingest_bytes=rss())
        return stream

    ingest.make_stream_chunked = timed_ingest

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_validate_stream: no CUDA device available", file=sys.stderr)
        return 2
    n_bytes = int(args.gb * (1 << 30))
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus.txt")
        t0 = time.perf_counter()
        synth_to_disk(corpus, n_bytes)
        synth_s = time.perf_counter() - t0
        rss_synth = rss()
        ts.RECOUNTS.clear()
        if args.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tok, res = api.train_files([corpus], api.TrainConfig(vocab_size=args.vocab, device=args.device))
        if args.device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak_rss = rss()
        with open(corpus, "rb") as f:
            sample = f.read(1 << 14)
        model = os.path.join(tmp, "model.json")
        tok.save(model)
        tok2 = api.load_model(model, device=args.device)
        text = sample.decode("utf-8", errors="ignore")
        probe = "The quick brown fox; étude 中文 2026!"
        roundtrip = (tok2.decode_text(tok2.encode(text)) == text and tok2.decode_text(tok2.encode(probe)) == probe
                     and tok2.encode(probe) == tok.encode(probe)
                     and tok2.decode(tok2.encode_bytes_greedy(sample)) == sample)
    fp = hashlib.sha256(json.dumps([[a, b, c] for a, b, c in res.merges]).encode()).hexdigest()[:16]
    rec = recorded(args.gb, args.vocab)
    out = {
        "script": "scripts/torch_validate_stream.py", "corpus_bytes": n_bytes, "corpus_gb": args.gb,
        "vocab_target": args.vocab, "merges": len(res.merges), "vocab_size": tok2.vocab_size,
        "synth_seconds": synth_s, "wall_seconds": wall, "train_seconds": res.training_time_s,
        **ingested, "set_up_seconds": wall - res.training_time_s - ingested["ingest_seconds"],
        "merges_per_sec": len(res.merges) / res.training_time_s,
        "merges_per_sec_incl_ingest": len(res.merges) / wall, "recounts": res.recounts,
        "recounts_by_tier": dict(ts.RECOUNTS), "native_ingest": native.native_available(),
        "peak_rss_after_synth_bytes": rss_synth, "peak_rss_bytes": peak_rss,
        "peak_device_allocated_bytes": torch.cuda.max_memory_allocated() if args.device == "cuda" else None,
        "merge_list_sha256_16": fp, "record": rec,
        "equal_to_record": None if rec is None else fp == rec["merge_list_sha256_16"],
        "model_roundtrip_ok": roundtrip, **card(args.device),
    }
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=2) + "\n")
    return 0 if roundtrip and out["equal_to_record"] is not False else 1


if __name__ == "__main__":
    sys.exit(main())
