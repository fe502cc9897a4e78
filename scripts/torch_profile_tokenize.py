"""Where the time of the port's bulk tokenize pass goes on one CUDA card.

    python scripts/torch_profile_tokenize.py [--mb 16] [--vocab 8192] [--reps 5]

Trains ``gpu_bpe_tpu_torch.Trainer(device="cuda")`` to ``--vocab`` tokens on
chip_smoke.py's synthetic corpus (bench.py's 16 MB Zipfian text, seed 0),
builds ``Tokenizer(vocab)`` and runs one pass of the corpus layer by layer,
then the whole pass under ``torch.profiler``. Prints JSON lines:

* ``layers``: the median over ``--reps`` of each layer's time on the
  card's stream (CUDA events, the stream synchronised before and after, so
  launch gaps count) and on the host clock: upload of the buffer, the
  level-1 stab join, the chained levels (rank space on the card), the rest
  of the match table (byte ids and the dense join), the chunk walk, the
  PAD strip (compact_valid) and the host copy of the 16-bit ids; and the
  whole pass (``encode_pass``), in which the layers overlap;
* ``device``: device busy time (kernel, copy and memset times) of the
  traced pass against its wall time, and the idle share;
* ``by_kernel``: device time and calls per kernel name, the largest first;
* ``host_reads``: device-to-host copies in the traced pass.

The card's name and power limit are printed first (nvidia-smi).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=16)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2

    from chip_smoke import synth_corpus
    from gpu_bpe_tpu_torch import Tokenizer, Trainer
    from gpu_bpe_tpu_torch.ops import build, kernels
    from gpu_bpe_tpu_torch.ops import tokenize as ttz
    from gpu_bpe_tpu_torch.ops.ingest import make_stream
    from gpu_bpe_tpu_torch.pretok import byte_word_starts

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    build.load()
    corpus = synth_corpus(args.mb << 20, seed=0)
    stream = make_stream(corpus, byte_word_starts(corpus))
    vocab = Trainer(device="cuda").train_stream(stream, target_vocab_size=args.vocab).vocab
    tok = Tokenizer(vocab)
    data = corpus[: tok.max_pass_bytes]
    n = len(data)
    cs = tok.chunk_size
    host_buf = np.zeros(tok.capacity(n), np.uint8)
    host_buf[:n] = np.frombuffer(data, np.uint8)
    buf = torch.from_numpy(host_buf).cuda()
    stab = tok.tables.stab
    n_levels = len(stab["levels"]) if stab else 0

    def timed(fn):
        """(device ms, host ms, result) of fn on the synchronised stream."""
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end), (time.perf_counter() - t0) * 1e3, out

    iota = torch.arange(buf.shape[0], dtype=torch.int64, device=buf.device)

    def level1():
        return ttz._stab_join(ttz._pack_bytes(buf, 0, 4), ttz._pack_bytes(buf, 4, 4), iota,
                              tok._stab_rows.level1, n, cs, base_len=0, max_depth=ttz._STAB_MAX_LEN,
                              depths=ttz._GROUP_DEPTH + 1 if n_levels else ttz._STAB_MAX_LEN + 1,
                              group_depth=ttz._GROUP_DEPTH if n_levels else -1)

    layers = {}

    def add(name, ms):
        layers.setdefault(name, {"device": [], "host": []})
        layers[name]["device"].append(ms[0])
        layers[name]["host"].append(ms[1])

    tok.encode_pass(buf, n)  # warm-up
    for _ in range(args.reps):
        add("upload", timed(lambda: torch.from_numpy(host_buf).cuda()))
        if stab:
            add("stab_level1", timed(level1))
            add("stab_match", timed(lambda: ttz._stab_match(buf, tok._stab_rows, n, cs)))
        mt = timed(lambda: ttz.build_match_table(buf, tok.tables, tok._stab_rows, tok._dense, n, cs))
        add("match_table", mt)
        mid, mlen = mt[2]
        wk = timed(lambda: ttz.chunk_walk(mid, mlen, buf, n, cs))
        add("walk", wk)
        st = timed(lambda: kernels.compact_valid(wk[2]))
        add("strip", st)
        ids, total = st[2]

        def host_copy():
            got = ids[: int(total)]
            return torch.where(got >= 0x8000, got - 0x10000, got).to(torch.int16).cpu()

        add("host_copy", timed(host_copy))
        add("encode_pass", timed(lambda: tok.encode_pass(buf, n)))
    med = {k: {"device_ms": statistics.median(v["device"]), "host_ms": statistics.median(v["host"])}
           for k, v in layers.items()}
    if stab:  # split the match table into its parts
        for part, whole, sub in (("stab_levels_chain", "stab_match", "stab_level1"),
                                 ("match_table_rest", "match_table", "stab_match")):
            med[part] = {k: med[whole][k] - med[sub][k] for k in ("device_ms", "host_ms")}
    print(json.dumps({"phase": "layers", "bytes": n, "vocab": len(vocab), "chunk_size": cs,
                      "stab_levels": 1 + n_levels if stab else 0,
                      "dense_lengths": tok.tables.dense_lengths, "reps": args.reps, "median": med}),
          flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        ids, total = tok.encode_pass(buf, n)
        int(total)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
                      "launches": sum(v[1] for v in by_kernel.values())}), flush=True)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:25]
    print(json.dumps({"phase": "by_kernel",
                      "rows": [{"name": k[:90], "ms": v[0], "calls": v[1]} for k, v in top]}),
          flush=True)
    print(json.dumps({"phase": "host_reads", "dtoh_copies": dtoh}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
