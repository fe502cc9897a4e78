"""Tokenize device and wall rates of the PyTorch/CUDA port across trained vocab sizes.

The port's counterpart of ``scripts/bench_tokenize_vocabs.py``, with its
arguments and row keys. Trains a vocab of each size on ``bench_torch``'s
synthetic Zipfian corpus (``--corpus-mb`` MiB, seed 0, through
``PreTokenizer`` and dedup), each with a fresh ``Trainer`` and cached per
corpus size and vocab size as a ``BPEModel`` under ``--cache``, then
measures bulk tokenization of one pass of that corpus (``bench_torch.
tokenize_row``):

* device MB/s: passes on a buffer already on the card, enqueued back to
  back and timed by CUDA events (each pass reads its rank-space candidate
  count on the host), and the same with ``Tokenizer(vocab, rank_mode="off")``
  (the full-width level chain) where the vocab has stab levels past the first
* wall MB/s: ``encode_bytes`` end to end (upload, pass, host copy of the ids)
* bytes per token, the longest token, stab levels, dense lengths, the walk
  (``kernel``: ``chunk_walk.cu`` on a card; on the CPU ``scan64``, the
  64-bit emission schedule, or ``gather``, tokens past 63 bytes) and
  whether the rank-space chain served the measured passes

    python3 scripts/torch_bench_tokenize_vocabs.py --sizes 1024 8192 32768 65536 \\
        --out docs/artifacts/torch_tokenize_rates.json
    python3 scripts/torch_bench_tokenize_vocabs.py --device cpu --sizes 300 512 \\
        --corpus-mb 1 --out /tmp/rates.json      # a rehearsal on the CPU

On a card the artifact's ``device`` is its name and power limit as
``nvidia-smi`` gives them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def train_vocab(torch, stream_factory, size: int, path: str, device) -> tuple[list[bytes], float | None]:
    """The vocab of ``size`` tokens trained on the stream, loaded from
    ``path`` when cached there; returns it and the training seconds (None
    when loaded)."""
    from gpu_bpe_tpu_torch import BPEModel, Trainer

    if os.path.exists(path):
        return BPEModel.load(path).vocab, None
    result = Trainer(device=device).train_stream(stream_factory(), target_vocab_size=size)
    if device.type == "cuda":
        torch.cuda.synchronize()
    BPEModel(vocab=result.vocab, merges=result.merges).save(path)
    return result.vocab, result.training_time_s


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[1024, 8192, 32768, 65536])
    ap.add_argument("--corpus-mb", type=int, default=64, help="training corpus size (larger -> longer tokens at 64K)")
    ap.add_argument("--out", default="docs/artifacts/torch_tokenize_rates.json")
    ap.add_argument("--cache", default=os.path.join(tempfile.gettempdir(), "torch_tokenize_vocab_cache"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--passes", type=int, default=5, help="timed passes behind a device MB/s")
    args = ap.parse_args(argv)

    import torch

    from bench_torch import device_line, device_rate, fresh, synth_corpus, tokenize_row
    from gpu_bpe_tpu_torch import PreTokenizer, Tokenizer, make_stream

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_bench_tokenize_vocabs: no CUDA device (pass --device cpu to run on the CPU)")
    os.makedirs(args.cache, exist_ok=True)
    where = device_line(torch, device)

    corpus = synth_corpus(args.corpus_mb << 20)
    data, starts = PreTokenizer().pre_tokenize_bytes(corpus)
    stream = make_stream(data, starts, dedup=True)
    raw = bytes(data)

    rows = []
    for size in args.sizes:
        vocab, train_s = train_vocab(torch, lambda: fresh(stream), size,
                                     os.path.join(args.cache, f"vocab_{args.corpus_mb}mb_{size}.json"), device)
        tok = Tokenizer(vocab, device=device)
        row = tokenize_row(torch, tok, raw, args.passes)
        stab = tok.tables.stab
        off = None
        if stab and stab.get("levels"):
            pass_bytes = min(len(raw), tok.max_pass_bytes)
            off = device_rate(torch, Tokenizer(vocab, device=device, rank_mode="off"), raw[:pass_bytes],
                              args.passes)["device_mb_per_s"]
        row = {"vocab": len(vocab), "device_mb_per_sec": row["device_mb_per_sec"],
               "device_mb_per_sec_rank_off": off,
               **{k: row[k] for k in ("wall_mb_per_sec", "bytes_per_token", "max_token_len", "stab_levels",
                                      "dense_lengths", "walk", "pass_mb", "rank_space")},
               "train_seconds": train_s}
        rows.append(row)
        print(json.dumps(row), flush=True)

    artifact = {
        "script": "scripts/torch_bench_tokenize_vocabs.py",
        "device": where["nvidia_smi"] or where["name"],
        "torch": where["torch"], "cuda": where["cuda"],
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "corpus_mb": args.corpus_mb,
        "passes": args.passes,
        "rows": rows,
    }
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
    print("wrote", args.out, flush=True)
    return artifact


if __name__ == "__main__":
    main()
