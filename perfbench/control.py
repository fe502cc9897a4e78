"""The benchmark's controls: for one cell and seeds, the plain reference
with one guarantee of the configuration broken, put in the program's place
and judged by the cell's own comparison. Each has to come out not correct.

    python3 perfbench/control.py --workload train.words-8k --seed 1 --seed 2 --seed 3

* ``train_jobs``: ties go to the larger packed pair id (the configuration
  sends them to the smaller), the step a kernel that packs (count, pair)
  into one word for an atomic max would take.
* ``tokenize_shards``: the greedy match runs over the whole shard without
  chunks (the configuration cuts the input into chunks that no token
  crosses).

The controls run on the host at the cell's own size; they load nothing of
the program. One JSON line per seed: the numbers compared, each with its
limit, and ``correct``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.corpus import seeded_corpus  # noqa: E402
from perfbench.run import load_cell  # noqa: E402


def control(workload: str, seed: int, overrides: dict | None = None) -> dict:
    _, config, mix, kind = load_cell(workload, overrides)
    ctx = SimpleNamespace(seed=seed, config=config, mix=mix, reference=None)
    ctx.corpus = seeded_corpus(int(config["corpus_mib"] * (1 << 20)), seed, config["generator_words"])
    checks = kind.check(ctx, kind.control(ctx))
    return {"workload": workload, "seed": seed, "correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    for seed in args.seed:
        print(json.dumps(control(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
