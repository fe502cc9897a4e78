"""Where the device time of merge_compact_tracked.cu and count_pairs2.cu
goes: variants of each kernel, each built from the source with one change,
timed on one CUDA card.

    python scripts/torch_ablate_merge.py [--rounds 3]

Each variant is built into a temporary directory with the repo's nvcc flags
plus ``-Xptxas -v`` (all builds in parallel) and bound like the real
library. The inputs are the main path's real first merge: chip_smoke.py's
16 MB corpus (seed 0), its recount window and winner, capacity 2^20; the
count runs on that merge's output with its two sampled created pairs. The
unchanged kernels are first checked against the plain versions. Then, in
turns over ``--rounds`` rounds, the script prints JSON lines with the
device time per call of each kernel of each variant (torch.profiler).
Variants other than ``base`` compute something else and are timing probes
only:

* merge ``track_no_probes``: the tracking pass skips the probe list;
* merge ``track_no_created``: it skips the created-pair histograms and
  samples;
* merge ``track_nothing``: both, so the loads are dead too (what is left
  is the launch, the block set-up, the ticket and the finalize);
* merge ``track_loads_only``: the loads stay live, behind a test no weight
  passes;
* merge ``track_loads_1`` / ``track_loads_4``: 1 or 4 16-byte loads of
  symbols and of weights per tracking thread (the source has 2);
* count ``blocks_264`` / ``blocks_1056``: at most 2 or 8 blocks per SM (the
  source has 4);
* count ``no_reduction``: blocks add their sums and stop (no last block
  hands them out).

The card's name and power limit are printed first (nvidia-smi).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

VARIANTS = {
    "merge_compact_tracked": {
        "base": [],
        "track_no_probes": [("if (npe && (any_pair || vt == a || ut == b)) {", "if (false) {")],
        "track_no_created": [("if (vt == z16 && wv > 0) {", "if (false) {"),
                             ("if (ut == z16 && wu > 0) {", "if (false) {")],
        "track_nothing": [("if (npe && (any_pair || vt == a || ut == b)) {", "if (false) {"),
                          ("if (vt == z16 && wv > 0) {", "if (false) {"), ("if (ut == z16 && wu > 0) {", "if (false) {")],
        "track_loads_only": [("if (npe && (any_pair || vt == a || ut == b)) {", "if (false) {"),
                             ("if (vt == z16 && wv > 0) {", "if (wv == -7 && wu == -7) {"),
                             ("if (ut == z16 && wu > 0) {", "if (false) {")],
        "track_loads_1": [("constexpr int TRACK_LOADS = 2;", "constexpr int TRACK_LOADS = 1;")],
        "track_loads_4": [("constexpr int TRACK_LOADS = 2;", "constexpr int TRACK_LOADS = 4;")],
    },
    "count_pairs2": {
        "base": [],
        "blocks_264": [("constexpr int MAX_BLOCKS = 132 * 4;", "constexpr int MAX_BLOCKS = 132 * 2;")],
        "blocks_1056": [("constexpr int MAX_BLOCKS = 132 * 4;", "constexpr int MAX_BLOCKS = 132 * 8;")],
        "no_reduction": [("    if (!s_last) return;", "    return;")],
    },
}


def variant_source(src: str, name: str, change) -> str:
    for old, new in change:
        if old not in src:
            raise RuntimeError(f"{name}.cu no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def build_variants(build, out_dir: Path) -> dict:
    """{(source, variant): (library, ptxas lines)}, one nvcc per variant,
    all started together."""
    from gpu_bpe_tpu_torch.utils.build import declare

    (out_dir / "common.cuh").write_text((build.CSRC / "common.cuh").read_text())
    procs = {}
    for name, variants in VARIANTS.items():
        src = (build.CSRC / f"{name}.cu").read_text()
        for var, change in variants.items():
            cu = out_dir / f"{name}_{var}.cu"
            cu.write_text(variant_source(src, name, change))
            so = out_dir / f"lib{name}_{var}.so"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), str(cu)]
            procs[(name, var)] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                       text=True))
    libs = {}
    for (name, var), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}/{var}: nvcc failed\n{log}")
        lib = declare(ctypes.CDLL(str(so)), build.KERNELS[name])
        libs[(name, var)] = (lib, [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln])
    return libs


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2

    from chip_smoke import CORPUS_BYTES, device_profile, max_abs_diff, nvidia_smi_line, synth_corpus
    from gpu_bpe_tpu_torch.ops import build, kernels
    from gpu_bpe_tpu_torch.ops import train_step as ts
    from gpu_bpe_tpu_torch.ops.ingest import make_stream, pad_stream
    from gpu_bpe_tpu_torch.pretok import byte_word_starts

    print(nvidia_smi_line(), flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    corpus = synth_corpus(CORPUS_BYTES, seed=0)
    padded = pad_stream(make_stream(corpus, byte_word_starts(corpus)))
    st = ts._ensure_pending(ts.init_state(padded.symbols, padded.weights, padded.n, 256, dev), certified=False)
    margs = (st.symbols, st.weights, st.n, st.pend_pair, st.next_id, st.cand, st.cand_counts)
    cap = st.symbols.shape[0]
    m = kernels.merge_compact_tracked_plain(*margs)
    slots = (torch.tensor((int(m[5][1]) << 16) | 256, device=dev), torch.tensor((256 << 16) | int(m[5][3]), device=dev))
    cargs = (m[0], m[1], m[2], *slots)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launchers(name, lib):
        if name == "merge_compact_tracked":
            scratch = torch.zeros(int(lib.mc_scratch_words(cap)), dtype=torch.int64, device=dev)

            def run():
                out = torch.empty(2, cap, dtype=torch.int32, device=dev)
                arena = torch.empty(kernels.ARENA_WORDS, dtype=torch.int64, device=dev)
                ptrs = [x.data_ptr() for x in margs[:2]] + [cap] + [x.data_ptr() for x in margs[2:]] + [0, 0, 0, 0]
                rc = lib.merge_compact_tracked(*ptrs, out.data_ptr(), arena.data_ptr(), scratch.data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"launch failed with cudaError {rc}")
                return out, arena
            return run
        scratch = torch.zeros(int(lib.cp_scratch_words()), dtype=torch.int64, device=dev)

        def run():
            out = torch.empty(2, dtype=torch.int64, device=dev)
            ptrs = [cargs[0].data_ptr(), cargs[1].data_ptr(), cap] + [x.data_ptr() for x in cargs[2:]]
            rc = lib.count_pairs2(*ptrs, out.data_ptr(), scratch.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"launch failed with cudaError {rc}")
            return out
        return run

    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(build, Path(tmp))
        runs = {}
        for (name, var), (lib, ptxas) in libs.items():
            print(json.dumps({"source": name, "variant": var, "ptxas": ptxas}), flush=True)
            runs[(name, var)] = launchers(name, lib)
        # the unchanged kernels are exact (twice: the scratch is left clean)
        for _ in range(2):
            out, arena = runs[("merge_compact_tracked", "base")]()
            got = [out[0], out[1], arena[kernels.ARENA_NNEW]]
            torch.cuda.synchronize()
            e = max_abs_diff(got, [m[0], m[1], m[2]])
            c = runs[("count_pairs2", "base")]()
            torch.cuda.synchronize()
            e = max(e, max_abs_diff([c], [kernels.count_pairs2_plain(*cargs)]))
            if e != 0.0:
                raise AssertionError(f"a base variant disagrees with the plain version: {e}")
        for rnd in range(args.rounds):
            for (name, var), run in runs.items():
                try:
                    prof = device_profile(torch, run)
                except AssertionError as e:  # the tracer saw nothing: this reading is not measured
                    print(json.dumps({"round": rnd, "source": name, "variant": var, "not_measured": str(e)}),
                          flush=True)
                    continue
                ops = {k.replace("(anonymous namespace)::", "").split("(")[0]: v["ms"]
                       for k, v in prof["device_op_names"].items()}
                print(json.dumps({"round": rnd, "source": name, "variant": var, "device_ms_by_kernel": ops}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
