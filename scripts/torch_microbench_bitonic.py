"""Time the bitonic compare-exchange rounds on the card, beside torch.sort
(the counterpart of ``scripts/microbench_bitonic.py``).

    python scripts/torch_microbench_bitonic.py [--rounds 32] [--blocks 147]
    python scripts/torch_microbench_bitonic.py --device cpu --blocks 1 --rounds 3 --caps 17

The JAX script asked whether a hand-made segment sort could beat the
library sort on 2^17-element segments. This one asks it on the card: it
makes the script's inputs (``default_rng(0)``, three int32 ``[blocks *
1024, 128]`` words below 2^31), runs ``--rounds`` rounds of
``gpu_bpe_tpu_torch.ops.bitonic.bitonic_rounds`` (the CUDA kernel
``ops/csrc/bitonic_rounds.cu``) back to back after a warm-up, times them
with CUDA events, and prints the JAX script's line: the time per call, ns
per element and round, and the estimate of a full 153-round sort of the
same elements. Then the yardsticks, each the median ms of one call over
CUDA events:

* ``torch.sort`` of one int64 key over ``[blocks, 2^17]`` along dim 1 (the
  same element count);
* the recount's batched segment sort (``ops/train_step.py``
  ``_full_recount_segmented``: ``[cap >> 17, 2^17]`` int64 pair ids, dim
  1) at each capacity of ``--caps`` (2^22 and 2^25 by default);
* a stable ``torch.sort`` of the ``[blocks, 2^17]`` keys, as the stab join
  calls it (``ops/tokenize.py`` ``_sorted_rows``).

What the estimate leaves out (printed as ``left_out``): like the JAX
script, it times the in-row strides 1-64 only. A full bitonic sort of a
2^17 segment also runs the strides 128 to 65536, which cross rows, and one
segment's three words take 1.5 MiB, more than one SM's 228 KB of shared
memory, so those strides go through L2 or device memory. The estimate is a
lower bound on a full bitonic sort, on the card as it was on the TPU.

It runs on the card unless ``--device cpu`` is given (then the plain
version runs and the host clock times it), and exits 2 without a card when
none is asked for. The last line is one JSON object with every number
unrounded and, on a card, its ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gpu_bpe_tpu_torch.ops.bitonic import LANES, ROWS, bitonic_rounds  # noqa: E402

FULL_SORT_ROUNDS = 153  # rounds of a bitonic sort of one 2^17 segment, as the JAX script counts them
SEGMENT = ROWS * LANES  # 2^17
LEFT_OUT = ("in-row strides 1-64 only: a full 2^17 bitonic sort also runs strides 128-65536, which cross "
            "rows, and one segment's three words (1.5 MiB) exceed one SM's 228 KB of shared memory; the "
            "estimate is a lower bound")


def script_inputs(blocks: int, device) -> list[torch.Tensor]:
    """The JAX script's inputs: ``default_rng(0)``, three int32 ``[blocks *
    1024, 128]`` arrays of words below 2^31."""
    rng = np.random.default_rng(0)
    shape = (blocks * ROWS, LANES)
    return [torch.from_numpy(rng.integers(0, 1 << 31, size=shape, dtype=np.int64).astype(np.int32)).to(device)
            for _ in range(3)]


def _elapsed_ms(fn, device, calls: int) -> float:
    """Time of ``calls`` back-to-back calls of ``fn``: CUDA events on a card,
    the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def median_ms(fn, device, reps: int, calls: int = 1) -> float:
    """Median over ``reps`` of the time per call of ``calls`` back-to-back
    calls of ``fn``, after one warm-up call."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return statistics.median(_elapsed_ms(fn, device, calls) / calls for _ in range(reps))


def time_rounds(device, blocks: int, rounds: int, calls: int = 20, reps: int = 5) -> dict:
    """The kernel on the script's inputs: ms per call (back to back), ns
    per element and round, and the 153-round estimate."""
    a, b, c = script_inputs(blocks, device)
    ms = median_ms(lambda: bitonic_rounds(a, b, c, rounds), device, reps, calls)
    elems = blocks * SEGMENT
    ns = ms * 1e6 / (rounds * elems)
    return {"rounds": rounds, "blocks": blocks, "elements": elems, "ms": ms, "ns_per_elem_round": ns,
            "est_full_sort_ms": ns * FULL_SORT_ROUNDS * elems / 1e6, "left_out": LEFT_OUT}


def sort_yardsticks(device, blocks: int, caps: list[int], reps: int = 10) -> dict:
    """Median ms of one ``torch.sort`` call: int64 keys over ``[blocks,
    2^17]``, unstable and stable, and the recount's ``[cap >> 17, 2^17]``
    sort of u32 pair ids held in int64 at each capacity."""
    rng = np.random.default_rng(1)
    keys = torch.from_numpy(rng.integers(0, 1 << 63, size=(blocks, SEGMENT), dtype=np.int64)).to(device)
    out = {"sort_ms": median_ms(lambda: torch.sort(keys, dim=1), device, reps),
           "stable_sort_ms": median_ms(lambda: torch.sort(keys, dim=1, stable=True), device, reps)}
    del keys
    recount = {}
    for cap in caps:
        pair = torch.from_numpy(rng.integers(0, 1 << 32, size=cap, dtype=np.int64)).to(device)
        seg = pair.reshape(cap // SEGMENT, SEGMENT)
        recount[f"2^{cap.bit_length() - 1}"] = median_ms(lambda: torch.sort(seg, dim=1), device, reps)
        del pair, seg
    out["recount_sort_ms"] = recount
    return out


def run(device, blocks: int, rounds: int, caps: list[int]) -> dict:
    """The kernel's timing, then the yardsticks."""
    return {"device": str(device), **time_rounds(device, blocks, rounds), **sort_yardsticks(device, blocks, caps)}


def script_line(out: dict) -> str:
    """The JAX script's line, with more digits."""
    return (f"rounds={out['rounds']} blocks={out['blocks']} dt={out['ms']:.4f} ms "
            f"-> {out['ns_per_elem_round']:.6f} ns/elem/round "
            f"-> est full {FULL_SORT_ROUNDS}-round sort of {out['elements'] / 1e6:.1f}M elems: "
            f"{out['est_full_sort_ms']:.3f} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=32)
    ap.add_argument("--blocks", type=int, default=147)
    ap.add_argument("--caps", default="22,25", help="log2 capacities of the recount's segment sort (>= 17)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    caps = [1 << int(x) for x in args.caps.split(",")]
    if args.rounds < 1 or args.blocks < 1 or min(caps) < SEGMENT:
        ap.error("--rounds and --blocks must be >= 1 and every --caps entry >= 17")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_microbench_bitonic: no CUDA device available", file=sys.stderr)
        return 2
    smi = None
    if dev.type == "cuda":
        from chip_smoke import nvidia_smi_line

        smi = nvidia_smi_line()
        dev = torch.device("cuda", torch.cuda.current_device())
        print(smi, flush=True)
    out = run(dev, args.blocks, args.rounds, caps)
    print(script_line(out), flush=True)
    print(json.dumps({**out, "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
