"""Certificate soundness of the port at scale (CLAUDE.md invariant 4).

    python scripts/torch_validate_certificate.py [--mb 64] [--merges 8192]

Trains gpu_bpe_tpu_torch.Trainer(device="cuda") three times on
chip_smoke.py's synthetic Zipfian corpus (seed 0) cut to ``--mb`` MB:

1. the certified run on the dedup stream;
2. the certified run on the same stream with its unique words in a
   permuted order (other positions, blocks and window picks);
3. ``force_recount=True``: a full recount before every merge.

All three merge lists (with counts) must be bitwise equal; the script
prints one JSON line per run and exits non-zero on any difference.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def permute_words(stream, seed: int):
    """The same multiset of unique words (each with its weight) in a random
    order."""
    from gpu_bpe_tpu_torch.constants import WORD_START_BIT
    from gpu_bpe_tpu_torch.convert import stream_from_numpy

    sym, w = stream.symbols[: stream.n], stream.weights[: stream.n]
    starts = np.flatnonzero(sym & WORD_START_BIT)
    ends = np.append(starts[1:], stream.n)
    order = np.random.default_rng(seed).permutation(len(starts))
    idx = np.concatenate([np.arange(starts[i], ends[i]) for i in order])
    return stream_from_numpy(sym[idx], w[idx], stream.n, stream.total_bytes)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=64)
    ap.add_argument("--merges", type=int, default=8192)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    from chip_smoke import synth_corpus
    from gpu_bpe_tpu_torch import Trainer
    from gpu_bpe_tpu_torch.ops.ingest import make_stream
    from gpu_bpe_tpu_torch.pretok import byte_word_starts

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    corpus = synth_corpus(args.mb << 20, seed=0)
    stream = make_stream(corpus, byte_word_starts(corpus))
    runs = {
        "certified": (stream, {}),
        "permuted": (permute_words(stream, 1), {}),
        "force_recount": (stream, {"force_recount": True}),
    }
    results = {}
    for name, (s, kw) in runs.items():
        r = Trainer(device="cuda", **kw).train_stream(s, target_vocab_size=256 + args.merges)
        results[name] = r
        print(json.dumps({"run": name, "stream_n": s.n, "merges": len(r.merges),
                          "recounts": r.recounts, "seconds": r.training_time_s,
                          "merges_per_s": len(r.merges) / r.training_time_s}), flush=True)
    ref = results["certified"]
    ok = all(r.merges == ref.merges and r.merge_counts == ref.merge_counts for r in results.values())
    print(json.dumps({"equal": ok, "merges": len(ref.merges)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
