"""Where the time of bitonic_rounds.cu goes: variants of the kernel, each
built from the source with one change, timed on one CUDA card beside the
parent design, with the instructions of each one's round loop counted in
its SASS.

    python scripts/torch_ablate_bitonic.py [--passes 3] [--parent DIR]

The inputs are ``scripts/torch_microbench_bitonic.py``'s: 147 blocks of
[1024, 128] three-word keys (``default_rng(0)``), 32 rounds. Each variant of
``gpu_bpe_tpu_torch/ops/csrc/bitonic_rounds.cu`` is built into a temporary
directory with the repo's nvcc flags plus ``-Xptxas -v`` and bound like the
real library; ``--parent`` names a checkout of the parent commit (``git
archive``), whose kernel is built and timed the same way. Every variant that
computes the function is first checked bitwise against the plain version
(at 32 rounds on the 147 blocks, and at 13 and 71 rounds on two blocks of
hard words). Then the script prints, per variant:

* ``ptxas``: registers and spills;
* ``sass``: the instructions of the round loop (the longest backward
  branch of ``cuobjdump -sass``) by opcode and by class (``shfl``; ``alu``:
  integer add, logic, compare, select and shift; ``fma``: IMAD and moves the
  compiler put there; ``uniform``: one per warp, on the uniform datapath;
  ``mem``; ``ctl``), and each class per element and
  round (the loop runs ``rounds_per_loop`` rounds on ``per_lane`` elements
  of each lane);

and, in turns over ``--passes`` passes, ``loop_ms`` (CUDA events over 20
calls back to back), ``device_ms`` and ``device_ops`` (torch.profiler) at 32
rounds, and ``loop_ms`` at ``--long`` rounds (160 by default), so that
``(long - 32 rounds) / 128`` is the cost of one more round without the
loads and stores. The variants other than ``base`` and ``parent`` are
design probes; ``loads_only`` computes something else:

* ``base``: the kernel as it is (16 elements per lane, 8 lanes per row);
* ``lanes8`` / ``lanes32``: 8 or 32 elements per lane (16 or 4 lanes per
  row: 3 or 5 of the 7 strides in registers);
* ``bool_compare``: the 3-word compare written as C comparisons, for the
  compiler to choose its instructions, in place of the borrow chain;
* ``warps8``: 8 warps per block in place of 4;
* ``loads_only``: no rounds: the loads and stores alone;
* ``imad_shuffle``: the shuffle rounds' picks as ``x + t * (x - p)`` (t
  the all-ones mask), which the compiler puts on the IMAD path in place of
  LOP3; ``mad_shuffle``: as ``keep * x + take * p``; ``imad_pair``: the
  register pairs' picks as ``low + s * (low - high)`` and ``high - s *
  (low - high)``; ``imad_both``: both; ``imad_shuffle32``: ``imad_shuffle``
  at 32 elements per lane.

The card's name and power limit are printed first (nvidia-smi).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from scripts.torch_ablate_tokenize import build_libs, loop_ms, variant_source  # noqa: E402

ROUNDS, LONG_ROUNDS, BLOCKS = 32, 160, 147
LOOP = "    for (int r = 0; r < rounds;) cycle<0>(v, r, rounds, rk, rbits, lane);\n"
BOOL_COMPARE = """    const bool lt = (a0 < b0) | ((a0 == b0) & ((a1 < b1) | ((a1 == b1) & (a2 < b2))));
    return lt ? ~0u : 0u;
}"""
SHUFFLE_PICKS = """            v.x0[q] = pick(t, p0, v.x0[q]);
            v.x1[q] = pick(t, p1, v.x1[q]);
            v.x2[q] = pick(t, p2, v.x2[q]);
"""
PAIR_PICKS = """            v.x0[q] = pick(s, v.x0[h], l0);
            v.x1[q] = pick(s, v.x1[h], l1);
            v.x2[q] = pick(s, v.x2[h], l2);
            v.x0[h] = pick(s, l0, v.x0[h]);
            v.x1[h] = pick(s, l1, v.x1[h]);
            v.x2[h] = pick(s, l2, v.x2[h]);
"""
IMAD_SHUFFLE = """            v.x0[q] += t * (v.x0[q] - p0);
            v.x1[q] += t * (v.x1[q] - p1);
            v.x2[q] += t * (v.x2[q] - p2);
"""
MAD_SHUFFLE = """            const uint32_t take = 0u - t, keep = 1u - take;
            v.x0[q] = keep * v.x0[q] + take * p0;
            v.x1[q] = keep * v.x1[q] + take * p1;
            v.x2[q] = keep * v.x2[q] + take * p2;
"""
IMAD_PAIR = """            const uint32_t e0 = s * (l0 - v.x0[h]), e1 = s * (l1 - v.x1[h]), e2 = s * (l2 - v.x2[h]);
            v.x0[q] = l0 + e0;
            v.x1[q] = l1 + e1;
            v.x2[q] = l2 + e2;
            v.x0[h] -= e0;
            v.x1[h] -= e1;
            v.x2[h] -= e2;
"""
VARIANTS = {  # name -> (source changes, rounds per loop iteration, elements per lane)
    "base": ([], 7, 16),
    "lanes8": ([("constexpr int PER_LANE = 16;", "constexpr int PER_LANE = 8;")], 7, 8),
    "lanes32": ([("constexpr int PER_LANE = 16;", "constexpr int PER_LANE = 32;")], 7, 32),
    "bool_compare": ([(("span", "    uint32_t m;\n    asm(", "\n\n// `yes` where"), BOOL_COMPARE)], 7, 16),
    "warps8": ([("constexpr int WARPS = 4;", "constexpr int WARPS = 8;")], 7, 16),
    "loads_only": ([(LOOP, "")], 0, 16),
    "imad_shuffle": ([(SHUFFLE_PICKS, IMAD_SHUFFLE)], 7, 16),
    "mad_shuffle": ([(SHUFFLE_PICKS, MAD_SHUFFLE)], 7, 16),
    "imad_pair": ([(PAIR_PICKS, IMAD_PAIR)], 7, 16),
    "imad_both": ([(SHUFFLE_PICKS, IMAD_SHUFFLE), (PAIR_PICKS, IMAD_PAIR)], 7, 16),
    "imad_shuffle32": ([(SHUFFLE_PICKS, IMAD_SHUFFLE),
                        ("constexpr int PER_LANE = 16;", "constexpr int PER_LANE = 32;")], 7, 32),
}
EXACT = ("base", "lanes8", "lanes32", "bool_compare", "warps8", "imad_shuffle", "mad_shuffle", "imad_pair",
         "imad_both", "imad_shuffle32", "parent")
PARENT_LOOP = (1, 4)  # the parent's loop: one round on 4 elements per lane
SHFL, MEM = {"SHFL"}, {"LDG", "STG", "LDS", "STS", "LDL", "STL", "LD", "ST"}
CTL = {"BRA", "EXIT", "BSSY", "BSYNC", "WARPSYNC", "NOP", "BAR", "CALL", "RET", "YIELD", "BREAK", "BPT"}
FMA = {"IMAD", "FFMA", "FMUL", "FADD", "IMUL"}
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")
TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b")


def _cuobjdump(build) -> str:
    found = Path(build._nvcc()).with_name("cuobjdump")
    return str(found) if found.exists() else shutil.which("cuobjdump") or "cuobjdump"


def loop_counts(sass: str) -> Counter:
    """Mnemonics (opcode and modifiers) of the longest loop in a SASS listing:
    the instructions from the target of a backward branch to the branch."""
    insns, labels, pending = [], {}, []
    for line in sass.splitlines():
        m = LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSN.search(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for name in pending:
            labels[name] = addr
        pending = []
        text = re.sub(r"^@!?U?P\w+\s+", "", m.group(2).strip())
        insns.append((addr, text))
    best = None
    for addr, text in insns:
        if not text.startswith("BRA"):
            continue
        t = TARGET.search(text)
        if not t:
            continue
        target = labels.get(t.group(1)) if t.group(1) else int(t.group(2), 16)
        if target is not None and target <= addr and (best is None or addr - target > best[1] - best[0]):
            best = (target, addr)
    if best is None:
        return Counter()
    return Counter(text.split()[0] for addr, text in insns if best[0] <= addr <= best[1])


def sass_summary(build, so: Path, rounds_per_loop: int, per_lane: int) -> dict:
    """The round loop's opcodes, classes, and classes per element and round."""
    out = subprocess.run([_cuobjdump(build), "-sass", str(so)], capture_output=True, text=True, check=True).stdout
    mnemonics = loop_counts(out)
    ops = Counter()
    for mn, n in mnemonics.items():
        ops[mn.split(".")[0]] += n
    classes = Counter()
    for op, n in ops.items():
        classes["shfl" if op in SHFL else "mem" if op in MEM else "ctl" if op in CTL
                else "fma" if op in FMA else "uniform" if op.startswith("U") else "alu"] += n
    per = rounds_per_loop * per_lane
    return {"loop_opcodes": dict(ops.most_common()), "loop_mnemonics": dict(mnemonics.most_common()),
            "loop_classes": dict(classes),
            "per_element_round": {k: v / per for k, v in classes.items()} if per else None,
            "rounds_per_loop": rounds_per_loop, "per_lane": per_lane}


def launcher(torch, lib, words):
    """One call of a variant library's entry point, as ``ops/bitonic.py``
    launches it: a new [3, rows, 128] output per call."""
    fn = lib.bitonic_rounds
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    a, b, c = words
    step = a.numel() * 4

    def call(rounds: int):
        out = torch.empty(3, *a.shape, dtype=torch.int32, device=a.device)
        base = out.data_ptr()
        rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), base, base + step, base + 2 * step, a.shape[0], rounds,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"bitonic_rounds launch failed with cudaError {rc}")
        return out.unbind(0)

    return call


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--long", type=int, default=LONG_ROUNDS, help="the longer round count for the per-round cost")
    ap.add_argument("--parent", type=Path, default=None, help="a checkout of the parent commit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2

    from chip_smoke import bitonic_inputs, device_profile, nvidia_smi_line
    from gpu_bpe_tpu_torch.ops import bitonic, build
    from scripts.torch_microbench_bitonic import script_inputs

    print(nvidia_smi_line(), flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    words = script_inputs(BLOCKS, dev)
    hard = [torch.as_tensor(w, device=dev) for w in bitonic_inputs("ties01", 2, 7)]
    src = (build.CSRC / "bitonic_rounds.cu").read_text()
    common = (build.CSRC / "common.cuh").read_text()
    jobs = {name: (variant_source(src, name, changes), common) for name, (changes, _, _) in VARIANTS.items()}
    shapes = {name: (r, p) for name, (_, r, p) in VARIANTS.items()}
    if args.parent:
        pdir = args.parent / "gpu_bpe_tpu_torch" / "ops" / "csrc"
        jobs["parent"] = ((pdir / "bitonic_rounds.cu").read_text(), (pdir / "common.cuh").read_text())
        shapes["parent"] = PARENT_LOOP
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_libs(build, jobs, Path(tmp))
        calls = {}
        for name, (lib, ptxas) in libs.items():
            so = Path(tmp) / name / "k.so"  # where build_libs puts it
            print(json.dumps({"variant": name, "ptxas": ptxas, "sass": sass_summary(build, so, *shapes[name])}),
                  flush=True)
            calls[name] = (launcher(torch, lib, words), launcher(torch, lib, hard))
        want = {r: bitonic.bitonic_rounds_plain(*hard, r) for r in (13, 71)}
        want[ROUNDS] = bitonic.bitonic_rounds_plain(*words, ROUNDS)
        for name in [n for n in calls if n in EXACT]:
            main_call, hard_call = calls[name]
            got = {ROUNDS: main_call(ROUNDS), **{r: hard_call(r) for r in (13, 71)}}
            torch.cuda.synchronize()
            for r, outs in got.items():
                if not all(torch.equal(x, y) for x, y in zip(outs, want[r], strict=True)):
                    raise AssertionError(f"{name} disagrees with the plain version at {r} rounds")
        del want
        print(json.dumps({"checked": [n for n in calls if n in EXACT], "elements": words[0].numel(),
                          "rounds": ROUNDS, "long_rounds": args.long}), flush=True)
        for p in range(args.passes):
            for name, (call, _) in calls.items():
                prof = device_profile(torch, lambda: call(ROUNDS))
                short = loop_ms(torch, lambda: call(ROUNDS))
                long = loop_ms(torch, lambda: call(args.long))
                print(json.dumps({"pass": p, "variant": name, "loop_ms": short, "device_ms": prof["device_ms"],
                                  "device_ops": prof["device_ops"], "long_loop_ms": long,
                                  "ms_per_round": (long - short) / (args.long - ROUNDS)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
