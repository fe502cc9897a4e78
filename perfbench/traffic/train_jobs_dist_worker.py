"""One rank of the ``train_jobs_dist`` traffic kind, and the job protocol
that every rank follows, rank 0 (``run.py``'s process) included.

    python3 -m perfbench.traffic.train_jobs_dist_worker --addr 127.0.0.1:<port> --world 4 --rank 1 \\
        --seed 7 --device cuda --config '<configuration JSON>'

A worker builds the run's seeded corpus, joins the process group with the
program's ``init_multihost`` (rank ``--rank`` on card ``rank % cards``),
then serves jobs until rank 0 says quit: rank 0 broadcasts a job's vocab
size (0 means quit), every rank runs ``api.train(corpus,
TrainConfig(vocab_size, backend="dist"))`` and synchronizes, and the ranks
all-gather a SHA-256 digest of their (merges, merge counts, vocab) and
the host CPU seconds the job took in their process. At
quit the worker prints its card's peak memory on stderr and leaves with
``shutdown_multihost``. A worker whose parent is gone exits.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import threading
import time
from pathlib import Path

# a worker waits on rank 0 while rank 0 sums up its traced window, so its
# group's timeout is long; it exits anyway when rank 0's process is gone
WORKER_TIMEOUT_S = 1800.0


def device(kind: str):
    """This rank's device: its current card, or the CPU."""
    import torch

    if kind == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def broadcast_vocab(dev, vocab_size: int = 0) -> int:
    """Rank 0's job vocab size on every rank (0: quit)."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([vocab_size], dtype=torch.int64, device=dev)
    dist.broadcast(t, 0)
    return int(t.item())


def train(api, corpus: bytes, config: dict, vocab_size: int, kind: str):
    """One job on this rank: the README's ``backend="dist"`` call."""
    _, res = api.train(corpus, api.TrainConfig(vocab_size=vocab_size, backend="dist", device=kind,
                                               pre_tokenize=config["pre_tokenize"], dedup=config["dedup"],
                                               show_progress=False))
    if kind == "cuda":
        import torch

        torch.cuda.synchronize()
    return res


def digest(res) -> str:
    return hashlib.sha256(repr((res.merges, res.merge_counts, res.vocab)).encode()).hexdigest()


def run_job(api, corpus: bytes, config: dict, vocab_size: int, kind: str, world: int):
    """One job on this rank, then every rank's (digest, host CPU seconds of
    the job), in rank order."""
    import torch.distributed as dist

    cpu0 = time.process_time()
    res = train(api, corpus, config, vocab_size, kind)
    out = [None] * world
    dist.all_gather_object(out, (digest(res), time.process_time() - cpu0))
    return res, out


def _exit_with_parent() -> None:
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(3)

    threading.Thread(target=watch, daemon=True).start()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--addr", required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), required=True)
    ap.add_argument("--config", required=True)
    args = ap.parse_args(argv)
    _exit_with_parent()
    config = json.loads(args.config)

    from gpu_bpe_tpu_torch import api
    from gpu_bpe_tpu_torch.parallel import init_multihost, shutdown_multihost
    from perfbench.corpus import seeded_corpus

    corpus = seeded_corpus(int(config["corpus_mib"] * (1 << 20)), args.seed, config["generator_words"])
    init_multihost(args.addr, args.world, args.rank, device=args.device, timeout_s=WORKER_TIMEOUT_S)
    dev = device(args.device)
    while True:
        vocab_size = broadcast_vocab(dev)
        if vocab_size == 0:
            break
        run_job(api, corpus, config, vocab_size, args.device, args.world)
    if args.device == "cuda":
        import torch

        print(f"rank {args.rank}: memory_peak_bytes {torch.cuda.max_memory_allocated()} on {dev}",
              file=sys.stderr, flush=True)
    shutdown_multihost()
    return 0


if __name__ == "__main__":
    if __package__ in (None, ""):
        sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    sys.exit(main())
