"""Certificate soundness of the port at scale (CLAUDE.md invariant 4).

    python scripts/torch_validate_certificate.py [--mb 64] [--merges 8192] [--device cuda] [--multi] [--out FILE]

The JAX package's recipe (``scripts/validate_certificate.py``) on the port:
chip_smoke.py's synthetic Zipfian corpus (bench.py's, seed 0) cut to
``--mb`` MB, the port's Unicode ``PreTokenizer().pre_tokenize_bytes``, the
unique-word dedup stream, ``gpu_bpe_tpu_torch.Trainer`` on ``--device``
(the card unless "cpu" is asked for) to 256 + ``--merges`` tokens, three
times, each in its own process (fresh kernel scratch, pools and caches):

1. the certified run;
2. the certified run on the same stream with its unique words in a
   permuted order (other positions, blocks and window picks);
3. the ground truth: a full recount before every merge, asked for as the
   JAX recipe asks for it, with ``GPU_BPE_TPU_FORCE_RECOUNT=1`` in the
   run's own process and ``Trainer()``'s ``force_recount`` left at its
   default, which reads the variable. The run must report one recount per
   merge before any hash is compared: a trainer that ignored the variable
   would compare the certified loop with itself.

Each run prints one JSON line with the SHA-256 of ``json.dumps`` of its
merge list ``[[a, b, id], ...]`` and of its counts, the recipe's
serialisation. The three must be equal, and equal to the JAX package's
record for the same corpus size and merges
(``docs/artifacts/certificate_validation*.json``) where there is one; the
script exits non-zero otherwise. The parent builds the stream once and
hands it to the runs in a temporary ``.npz``.

``--multi`` runs all three with ``Trainer(multi_merge=True)`` (the
multi-merge iteration; the ``force_recount`` run then never merges twice
per iteration). ``--out FILE`` also writes the result, with the card's
``nvidia-smi`` name and power limit, as one JSON object.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
RUNS = ("certified", "permuted", "force_recount")


def recorded(mb: int, merges: int) -> dict | None:
    """The JAX package's recorded hashes for ``mb`` MB / ``merges`` merges."""
    for path in sorted((REPO / "docs" / "artifacts").glob("certificate_validation*.json")):
        rec = json.loads(path.read_text())
        if rec.get("ok") and rec["corpus_mb"] == mb and rec["merges"] == merges:
            return {"file": str(path.relative_to(REPO)), "sha_merges": rec["normal"]["sha_merges"],
                    "sha_counts": rec["normal"]["sha_counts"]}
    return None


def hashes(result) -> dict:
    blob = json.dumps([[a, b, c] for a, b, c in result.merges]).encode()
    return {"sha_merges": hashlib.sha256(blob).hexdigest(),
            "sha_counts": hashlib.sha256(json.dumps(result.merge_counts).encode()).hexdigest()}


def permuted(symbols: np.ndarray, weights: np.ndarray):
    """The recipe's permutation: each unique word's block moved, in a
    deterministic random order."""
    word_ids = np.cumsum((symbols >> 16) & 1) - 1
    perm = np.random.default_rng(1234).permutation(int(word_ids[-1]) + 1)
    order = np.argsort(perm[word_ids], kind="stable")
    return symbols[order].copy(), weights[order].copy()


def child(run: str, stream_path: str, merges: int, device: str, multi: bool) -> int:
    from gpu_bpe_tpu_torch import Trainer
    from gpu_bpe_tpu_torch.convert import stream_from_numpy

    z = np.load(stream_path)
    sym, w = z["symbols"], z["weights"]
    if run == "permuted":
        sym, w = permuted(sym, w)
    stream = stream_from_numpy(sym, w, len(sym), int(z["total_bytes"]))
    r = Trainer(device=device, multi_merge=multi).train_stream(stream, target_vocab_size=256 + merges)
    print(json.dumps({"run": run, "multi_merge": multi, "stream_n": stream.n, "merges": len(r.merges),
                      "recounts": r.recounts, "duals": r.duals, "seconds": r.training_time_s,
                      "merges_per_s": len(r.merges) / r.training_time_s, **hashes(r)}), flush=True)
    return 0


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=64)
    ap.add_argument("--merges", type=int, default=8192)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--multi", action="store_true", help="train with the multi-merge iteration")
    ap.add_argument("--out", help="also write the result as JSON to this file")
    ap.add_argument("--child", choices=RUNS, help=argparse.SUPPRESS)
    ap.add_argument("--stream", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    if args.child:
        return child(args.child, args.stream, args.merges, args.device, args.multi)

    from chip_smoke import synth_corpus
    from gpu_bpe_tpu_torch.ops.ingest import make_stream
    from gpu_bpe_tpu_torch.pretok import PreTokenizer
    from gpu_bpe_tpu_torch.unicode import backend_name

    smi = None
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        print(smi, flush=True)
    corpus = synth_corpus(args.mb << 20, seed=0)
    pretok = PreTokenizer()  # builds the native decoder, outside the clock
    t0 = time.perf_counter()
    data, starts = pretok.pre_tokenize_bytes(corpus)
    pretok_s = time.perf_counter() - t0
    stream = make_stream(data, starts, dedup=True)
    print(json.dumps({"phase": "stream", "device": args.device, "bytes": len(corpus), "backend": backend_name(),
                      "pretokenize_s": pretok_s, "stream_n": stream.n}), flush=True)
    want = recorded(args.mb, args.merges)
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "stream.npz")
        np.savez(path, symbols=stream.symbols[: stream.n], weights=stream.weights[: stream.n],
                 total_bytes=stream.total_bytes)
        for run in RUNS:
            env = dict(os.environ)
            env.pop("GPU_BPE_TPU_FORCE_RECOUNT", None)
            if run == "force_recount":
                env["GPU_BPE_TPU_FORCE_RECOUNT"] = "1"
            p = subprocess.run([sys.executable, __file__, "--child", run, "--stream", path,
                                "--merges", str(args.merges), "--device", args.device]
                               + (["--multi"] if args.multi else []),
                               capture_output=True, text=True, env=env)
            if p.returncode != 0:
                print(p.stderr[-3000:], file=sys.stderr)
                return 1
            results[run] = json.loads(p.stdout.strip().splitlines()[-1])
            print(json.dumps(results[run]), flush=True)
    truth = results["force_recount"]
    if truth["recounts"] != truth["merges"]:
        print(f"the force_recount run made {truth['recounts']} recounts in {truth['merges']} merges: "
              "GPU_BPE_TPU_FORCE_RECOUNT did not reach the trainer", file=sys.stderr)
        return 1
    keys = ("merges", "sha_merges", "sha_counts")
    same = all(all(r[k] == results["certified"][k] for k in keys) for r in results.values())
    matches = want is None or all(results["certified"][k] == want[k] for k in keys[1:])
    ok = same and matches and results["certified"]["merges"] == args.merges
    summary = {"equal": same, "recorded": want, "equal_to_recorded": matches if want else None,
               "merges": results["certified"]["merges"], "ok": ok}
    print(json.dumps(summary))
    if args.out:
        Path(args.out).write_text(json.dumps({
            "script": "scripts/torch_validate_certificate.py", "device": args.device, "nvidia_smi": smi,
            "corpus_mb": args.mb, "merges": args.merges, "multi_merge": args.multi, "stream_n": stream.n,
            "runs": results, **summary}, indent=1) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
