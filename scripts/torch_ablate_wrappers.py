"""What each host step of the merge_compact_tracked and count_pairs2
wrappers costs on one CUDA card.

    python scripts/torch_ablate_wrappers.py [--reps 200]

On chip_smoke.py's synthetic main-path stream (capacity 2^20, 900,000 live
symbols, a live 256-slot window), times each step that a wrapper call
makes, alone, as the host time per call over ``--reps`` calls enqueued back
to back (after a warm-up; 200 calls of two launches stay inside the
launch queue, so the device's time does not hold the host back), and
prints one JSON line per step in microseconds: the two whole wrappers, the
raw ctypes launches (two kernels for the merge, one for the count), the
argument checks, the scalar handling, the pooled output views and the
stream buffer, the stream lookup (raw handle and Stream object), the
device guard, the scratch lookup, and the steps the wrappers of the parent
design made (nine output allocations, a zero fill, ``_scalar``
conversions, ``torch.cuda.device``). The card's name and power limit are
printed first (nvidia-smi).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def host_us(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / reps * 1e6


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2

    from chip_smoke import N_LIVE, nvidia_smi_line, synthetic_stream, window_for
    from gpu_bpe_tpu_torch.ops import build
    from gpu_bpe_tpu_torch.ops import kernels as k

    print(nvidia_smi_line(), flush=True)
    libs = build.load()
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(5)
    toks = list(range(97, 137))
    sym, w = synthetic_stream(rng, toks)
    pair = (toks[0] << 16) | toks[1]
    cand, counts = window_for(rng, toks, pair, 30)
    symbols, weights = torch.from_numpy(sym.astype(np.int32)).to(dev), torch.from_numpy(w).to(dev)
    cand, counts = torch.from_numpy(cand).to(dev), torch.from_numpy(counts).to(dev)
    n, pair_t, new_id = (torch.tensor(x, device=dev) for x in (N_LIVE, pair, 300))
    cap = symbols.shape[0]
    m = k.merge_compact_tracked(symbols, weights, n, pair_t, new_id, cand, counts)
    slots = (torch.tensor((97 << 16) | 300, device=dev), torch.tensor((300 << 16) | 98, device=dev))
    stream = build.current_stream(dev)
    mkey = ("merge_compact_tracked", dev.index, cap, stream)
    ckey = ("count_pairs2", dev.index, 0, stream)
    mlib, clib = libs["merge_compact_tracked"], libs["count_pairs2"]
    scratch_m = build.cached_scratch(mkey, dev, lambda: mlib.mc_scratch_words(cap))
    scratch_c = build.cached_scratch(ckey, dev, clib.cp_scratch_words)
    out = torch.empty(2, cap, dtype=torch.int32, device=dev)
    arena = torch.empty(k.ARENA_WORDS, dtype=torch.int64, device=dev)
    cout = torch.empty(2, dtype=torch.int64, device=dev)
    mptrs = (symbols.data_ptr(), weights.data_ptr(), cap, n.data_ptr(), pair_t.data_ptr(), new_id.data_ptr(),
             cand.data_ptr(), counts.data_ptr(), 0, 0, out.data_ptr(), arena.data_ptr(), scratch_m.data_ptr(),
             stream)
    cptrs = (m[0].data_ptr(), m[1].data_ptr(), cap, m[2].data_ptr(), slots[0].data_ptr(), slots[1].data_ptr(),
             cout.data_ptr(), scratch_c.data_ptr(), stream)
    i64 = dict(dtype=torch.int64, device=dev)

    def device_ctx():
        with torch.cuda.device(dev):
            pass

    def on_device():
        with build.on_device(dev):
            pass

    steps = {
        "merge_wrapper": lambda: k.merge_compact_tracked(symbols, weights, n, pair_t, new_id, cand, counts),
        "count_wrapper": lambda: k.count_pairs2(m[0], m[1], m[2], *slots),
        "merge_raw_ctypes_launch": lambda: mlib.merge_compact_tracked(*mptrs),
        "count_raw_ctypes_launch": lambda: clib.count_pairs2(*cptrs),
        "on_cpu_4_tensors": lambda: build.on_cpu(symbols, weights, cand, counts),
        "require_4_tensors": lambda: (build.require(symbols, torch.int32, (cap,)),
                                      build.require(weights, torch.int32, (cap,)),
                                      build.require(cand, torch.int64, (k.W_SLOTS,)),
                                      build.require(counts, torch.int64, (k.W_SLOTS,))),
        "dev_scalar_3": lambda: (k._dev_scalar(n, dev), k._dev_scalar(pair_t, dev), k._dev_scalar(new_id, dev)),
        "parent_scalar_3": lambda: [k._scalar(x, dev) for x in (n, pair_t, new_id)],
        "merge_outputs": lambda: (k._pooled(("ablate", 0), lambda: k.merge_arenas(k.POOL_CALLS, dev)),
                                  torch.empty(2, cap, dtype=torch.int32, device=dev).unbind(0)),
        "merge_arenas_64": lambda: k.merge_arenas(64, dev),
        "stream_object": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "parent_merge_9_empty": lambda: (
            torch.empty(cap, dtype=torch.int32, device=dev), torch.empty(cap, dtype=torch.int32, device=dev),
            torch.empty((), **i64), torch.empty(32, 16, dtype=torch.float32, device=dev), torch.empty(4, **i64),
            torch.empty(64, **i64), torch.empty(64, **i64), torch.empty((), **i64),
            torch.empty(int(mlib.mc_scratch_words(cap)), **i64)),
        "count_empty_2": lambda: torch.empty(2, **i64),
        "parent_count_zeros_2": lambda: torch.zeros(2, **i64),
        "raw_stream": lambda: build.current_stream(dev),
        "scratch_lookup": lambda: build.cached_scratch(mkey, dev, None),
        "torch_cuda_device_ctx": device_ctx,
        "on_device_ctx": on_device,
    }
    for name, fn in steps.items():
        print(json.dumps({"step": name, "host_us": host_us(torch, fn, args.reps)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
