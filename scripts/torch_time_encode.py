"""Wall time of multi-pass bulk tokenization on one CUDA card, for one or
more checkouts of the repository, measured in turns.

    python scripts/torch_time_encode.py [--rounds 2] [--reps 3] DIR [DIR ...]

The input is chip_smoke.py's phase 13 multi-pass case: the 16 MB synthetic
corpus plus its first MB (17 MB, two passes of at most 2^24 bytes) at the
synthetic 65,536-entry vocab. Each checkout runs in its own process (the
packages of two checkouts share a name) that builds the tokenizer, encodes
once to warm up, then times ``Tokenizer.encode_bytes`` ``--reps`` times
(host clock, each call ends with the ids on the host). The checkouts take
turns, ``--rounds`` times over, in the order given and then reversed (for
two: A, B, B, A). Prints the card's name and power limit, one JSON line per
process, and the median per checkout. The ids of every checkout must be
equal.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

CHILD = """
import hashlib, json, sys, time
sys.path.insert(0, ".")
import numpy as np
import torch
from chip_smoke import synth_corpus, synth_vocab_64k
from gpu_bpe_tpu_torch import Tokenizer
corpus = synth_corpus(16 << 20, seed=0)
data = corpus + corpus[: 1 << 20]
tok = Tokenizer(synth_vocab_64k(corpus))
ids = tok.encode_bytes(data)
times = []
for _ in range(int(sys.argv[1])):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok.encode_bytes(data)
    times.append(time.perf_counter() - t0)
print(json.dumps({"seconds": times, "passes": -(-len(data) // tok.max_pass_bytes),
                  "ids_sha": hashlib.sha256(np.ascontiguousarray(ids).tobytes()).hexdigest()}))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    order = []
    for r in range(args.rounds):
        order += args.dirs if r % 2 == 0 else args.dirs[::-1]
    seconds: dict[str, list[float]] = {d: [] for d in args.dirs}
    shas = set()
    for d in order:
        out = subprocess.run([sys.executable, "-c", CHILD, str(args.reps)], cwd=Path(d).resolve(),
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stderr[-3000:], file=sys.stderr)
            return 1
        row = json.loads(out.stdout.strip().splitlines()[-1])
        seconds[d] += row["seconds"]
        shas.add(row["ids_sha"])
        print(json.dumps({"dir": d, **row}), flush=True)
    print(json.dumps({"median_s": {d: statistics.median(v) for d, v in seconds.items()},
                      "ids_equal": len(shas) == 1}), flush=True)
    return 0 if len(shas) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
