"""Where the time of the port's main path goes on one CUDA card.

    python scripts/torch_profile_train.py [--mb 16] [--merges 1024] [--nodedup | --dist] [--multi]

Trains ``gpu_bpe_tpu_torch.Trainer(device="cuda")`` on chip_smoke.py's
synthetic corpus (bench.py's 16 MB Zipfian text, seed 0) once untraced (for
merges/s) and once under ``torch.profiler``, and prints JSON lines. The
stream is the byte-heuristic dedup stream, or with ``--nodedup`` the one
``api.train(pre_tokenize=False)`` trains on (one symbol per byte, capacity
2^25 at 16 MB, where the recount runs segmented). ``--dist`` trains the
dedup stream with the data-parallel ``DistributedTrainer`` in a one-rank
NCCL group instead, and adds its collectives and host reads by site to
``host_reads``. ``--multi`` trains with ``Trainer(multi_merge=True)`` (the
multi-merge iteration) and adds ``duals``; the single-device runs add their
host reads by site (``train_step.HOST_READS``) to ``host_reads``:

* ``run``: merges, recounts, wall seconds and merges/s of the untraced run;
* ``device``: device busy time (sum of kernel and copy times on the card)
  of the traced run against its wall time, and the idle share;
* ``by_kernel``: device time and calls per kernel name, the largest first;
* ``host_reads``: device-to-host copies, in total and per merge (each is a
  host sync of the Python merge loop; a segmented recount adds one, its
  summary count), and the traced run's recounts by path.

The card's name and power limit are printed first (nvidia-smi).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=16)
    ap.add_argument("--merges", type=int, default=1024)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--nodedup", action="store_true")
    mode.add_argument("--dist", action="store_true")
    ap.add_argument("--multi", action="store_true")
    args = ap.parse_args()
    if args.multi and args.dist:
        ap.error("--multi is the single-device trainer's mode")
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2

    from chip_smoke import counted_collectives, synth_corpus
    from gpu_bpe_tpu_torch import Trainer, api
    from gpu_bpe_tpu_torch.ops import build
    from gpu_bpe_tpu_torch.ops import train_step as ts
    from gpu_bpe_tpu_torch.ops.ingest import make_stream
    from gpu_bpe_tpu_torch.pretok import byte_word_starts

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    build.load()
    corpus = synth_corpus(args.mb << 20, seed=0)
    stream = api._byte_stream(corpus) if args.nodedup else make_stream(corpus, byte_word_starts(corpus))
    target = 256 + args.merges

    with contextlib.ExitStack() as stack:
        if args.dist:
            from gpu_bpe_tpu_torch.parallel import DistributedTrainer, dist_train, one_rank_group

            group = stack.enter_context(one_rank_group("cuda"))
            make = lambda: DistributedTrainer(group)  # noqa: E731
        else:
            make = lambda: Trainer(device="cuda", multi_merge=args.multi)  # noqa: E731
        make().train_stream(stream, target_vocab_size=256 + 64)  # warm-up
        res = make().train_stream(stream, target_vocab_size=target)
        print(json.dumps({"phase": "run", "merges": len(res.merges), "recounts": res.recounts,
                          "duals": res.duals, "seconds": res.training_time_s,
                          "merges_per_s": len(res.merges) / res.training_time_s}), flush=True)

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        ts.RECOUNTS.clear()
        ts.HOST_READS.clear()
        if args.dist:
            dist_train.HOST_READS.clear()
        with torch.profiler.profile(activities=acts) as prof, counted_collectives() as coll:
            t0 = time.perf_counter()
            traced = make().train_stream(stream, target_vocab_size=target)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        reads = dist_train.HOST_READS if args.dist else ts.HOST_READS
        extra = {"host_reads_by_site": dict(reads), "duals": traced.duals}
        if args.dist:
            extra["collectives"] = dict(coll)
    by_kernel = {}
    dtoh = 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.name
        if "DtoH" in name or "Device -> Pageable" in name or "Device -> Pinned" in name:
            dtoh += 1
        t = ev.device_time_total if hasattr(ev, "device_time_total") else ev.cuda_time_total
        row = by_kernel.setdefault(name, [0.0, 0])
        row[0] += t / 1e3
        row[1] += 1
    busy_ms = sum(v[0] for v in by_kernel.values())
    print(json.dumps({"phase": "device", "wall_ms": wall * 1e3, "busy_ms": busy_ms,
                      "idle_share": 1.0 - busy_ms / (wall * 1e3),
                      "merges": len(traced.merges)}), flush=True)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:25]
    print(json.dumps({"phase": "by_kernel",
                      "rows": [{"name": k[:90], "ms": v[0], "calls": v[1]} for k, v in top]}),
          flush=True)
    print(json.dumps({"phase": "host_reads", "dtoh_copies": dtoh,
                      "per_merge": dtoh / max(len(traced.merges), 1), "recounts": traced.recounts,
                      "recounts_by_path": dict(ts.RECOUNTS), **extra}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
