"""Record the JAX package's merge lists on the decomposed-jamo corpus, with
the reference-compat Hangul mode off and on.

    JAX_PLATFORMS=cpu python scripts/ref_hangul_record.py [--mb 16] [--merges 2048] [--out FILE]

The corpus is ``chip_smoke.synth_hangul_corpus(--mb MiB, seed 0)``: the
16 MB synthetic corpus of ``chip_smoke.py`` phase 11 with every other line
replaced by NFD Korean words. Each mode trains it with ``gpu_bpe_tpu.api.train``
(the Unicode pre-tokenizer, dedup) to 256 + ``--merges`` tokens, the mode
set on the package's Unicode backend (``set_ref_hangul``) and restored
after. The record holds each mode's ``sha_merges`` and ``sha_counts``
(``chip_smoke.sha_pair``: SHA-256 of ``json.dumps`` of ``[[a, b, id], ...]``
and of the counts), which ``chip_smoke.py`` phase 20 holds the port's
merge lists on the card to. It prints the record as one JSON line and
writes it to ``--out`` (default ``docs/artifacts/ref_hangul_cpu16mb.json``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=16)
    ap.add_argument("--merges", type=int, default=2048)
    ap.add_argument("--out", default=str(REPO / "docs" / "artifacts" / "ref_hangul_cpu16mb.json"))
    args = ap.parse_args()

    from chip_smoke import sha_pair, synth_hangul_corpus
    from gpu_bpe_tpu import api
    from gpu_bpe_tpu.unicode import get_backend

    corpus = synth_hangul_corpus(args.mb << 20, seed=0)
    jamo = sum(len(c.encode()) for c in corpus.decode() if 0x1100 <= ord(c) <= 0x11FF)
    backend = get_backend()
    record = {"script": "scripts/ref_hangul_record.py", "generator": "chip_smoke.synth_hangul_corpus",
              "seed": 0, "corpus_bytes": len(corpus), "jamo_byte_share": jamo / len(corpus),
              "merges": args.merges, "unicode_backend": backend.name}
    was = backend.ref_hangul
    try:
        for label, on in (("default", False), ("ref_hangul", True)):
            backend.set_ref_hangul(on)
            t0 = time.perf_counter()
            _, res = api.train(corpus, api.TrainConfig(vocab_size=256 + args.merges, show_progress=False))
            record[label] = {"merges": len(res.merges), **sha_pair(res), "first_merges": res.merges[:4],
                             "wall_s": time.perf_counter() - t0}
    finally:
        backend.set_ref_hangul(was)
    if record["default"]["sha_merges"] == record["ref_hangul"]["sha_merges"]:
        print("ref_hangul_record: the two modes gave the same merge list", file=sys.stderr)
        return 1
    print(json.dumps(record), flush=True)
    Path(args.out).write_text(json.dumps(record, indent=2) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
