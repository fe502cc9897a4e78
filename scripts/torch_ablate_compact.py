"""Where the device time of compact_mask.cu goes: variants of the kernel,
each built from the source with one change, timed on one CUDA card.

    python scripts/torch_ablate_compact.py [--rounds 3]

Each variant of ``gpu_bpe_tpu_torch/ops/csrc/compact_mask.cu`` is built
into a temporary directory with the repo's nvcc flags plus ``-Xptxas -v``
and bound like the real library. The unchanged kernel is first checked
against the plain version. Then, for each variant, in turns over
``--rounds`` rounds, the script prints JSON lines with the registers and
spills and the device time per call (torch.profiler: the memset and the
kernel) on two shapes of the tokenizer's main path: the PAD strip (2^24
entries, 18.9% kept, no extras) and the rank-space chain (2^24 entries,
6.4% kept, 3 extras). A 64 MB device copy is timed beside them as the
card's copy rate. The variants other than ``base`` compute something else
and are timing probes only:

* ``base``: the kernel as it is;
* ``count_only``: a tile returns once it has loaded, ranked and published
  its count (no staging, look-back or write-out);
* ``no_look_back``: a tile takes its own start as its output offset;
* ``no_staging``: survivors go straight to their output slots after the
  look-back, without the shared-memory run;
* ``block_ids``: tile ids from blockIdx instead of the counter;
* ``blocks_4`` / ``blocks_6``: the register bound set for 4 or 6 resident
  blocks per SM (the source has 5).

The card's name and power limit are printed first (nvidia-smi).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import struct
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TAIL_START = "    // entry k of load j lands at first[j]"
TAIL_END = "}\n\n}  // namespace\n\nextern \"C\" long long cm_tile_entries"
DIRECT_TAIL = '''    if (warp == 0) {
        const unsigned long long base = tile == 0 ? 0 : look_back(status, tile, lane);
        if (lane == 0) {
            if (tile != 0) store_status(status + tile, ST_PREFIX | (base + count));
            s_base = base;
            if (tile == ntiles - 1) *total = (long long)(base + count);
        }
    }
    __syncthreads();
    const long long base = (long long)s_base;
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
        const int off = first[j] + load_off[j * WARPS + warp];
#pragma unroll
        for (int k = 0; k < VEC; ++k)
            if ((keep >> (VEC * j + k)) & 1u) {
                const long long r = base + off + __popc((keep >> (VEC * j)) & ((1u << k) - 1u));
                out[r] = v[j][k] & TOKEN_MASK;
                const long long p = start + VEC * (j * THREADS + t) + k;
#pragma unroll
                for (int e = 0; e < MAX_EXTRA; ++e)
                    if (e < n_extra) ex.out[e][r] = ex.in[e][p];
            }
    }
'''
VARIANTS = {
    "base": [],
    "count_only": [("    __syncthreads();\n    const int count = s_count;",
                    "    return;\n    __syncthreads();\n    const int count = s_count;")],
    "no_look_back": [("const unsigned long long base = tile == 0 ? 0 : look_back(status, tile, lane);",
                      "const unsigned long long base = (unsigned long long)start;")],
    "no_staging": "tail",
    "block_ids": [("if (t == 0) s_tile = (long long)atomicAdd(next_tile, 1ull);",
                   "if (t == 0) s_tile = blockIdx.x;")],
    "blocks_4": [("constexpr int MIN_BLOCKS = 5;", "constexpr int MIN_BLOCKS = 4;")],
    "blocks_6": [("constexpr int MIN_BLOCKS = 5;", "constexpr int MIN_BLOCKS = 6;")],
}


def variant_source(src: str, change) -> str:
    if change == "tail":
        return src[: src.index(TAIL_START)] + DIRECT_TAIL + src[src.index(TAIL_END) :]
    for old, new in change:
        if old not in src:
            raise RuntimeError(f"compact_mask.cu no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def build_variant(build, name: str, src: str, out_dir: Path):
    """(library, ptxas register/spill lines) of one variant."""
    from gpu_bpe_tpu_torch.utils.build import declare

    (out_dir / "common.cuh").write_text((build.CSRC / "common.cuh").read_text())
    cu = out_dir / f"compact_{name}.cu"
    cu.write_text(src)
    so = out_dir / f"libcompact_{name}.so"
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stdout}{res.stderr}")
    ptxas = [ln.strip() for ln in (res.stdout + res.stderr).splitlines() if "registers" in ln or "spill" in ln]
    return declare(ctypes.CDLL(str(so)), build.KERNELS["compact_mask"]), ptxas


def launch(torch, lib, vals, extras):
    """One call of a variant library, as ops/kernels.py's wrapper makes it."""
    n = vals.numel()
    out = torch.empty_like(vals)
    outs = [torch.empty_like(e) for e in extras]
    words = torch.empty(1 + int(lib.cm_scratch_words(n)), dtype=torch.int64, device=vals.device)
    ptrs = struct.Struct(f"<{len(extras)}Q")
    rc = lib.compact_mask(vals.data_ptr(), n, ptrs.pack(*[e.data_ptr() for e in extras]),
                          ptrs.pack(*[o.data_ptr() for o in outs]), len(extras), out.data_ptr(),
                          words.data_ptr(), words.data_ptr() + 8, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"compact_mask launch failed with cudaError {rc}")
    return [out, *outs], words[0]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2

    from chip_smoke import device_profile, nvidia_smi_line
    from gpu_bpe_tpu_torch.ops import build, kernels

    print(nvidia_smi_line(), flush=True)
    dev = torch.empty(0, device="cuda").device
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    n = 1 << 24
    words = torch.randint(0, 1 << 16, (n,), generator=g, device=dev, dtype=torch.int32)
    pad_strip = torch.where(torch.rand(n, generator=g, device=dev) < 0.1893, words, -1)
    rank_space = torch.where(torch.rand(n, generator=g, device=dev) < 0.0643, words, -1)
    extras = [torch.randint(0, 2**31 - 1, (n,), generator=g, device=dev, dtype=torch.int32) for _ in range(3)]
    shapes = {"pad_strip": (pad_strip, []), "rank_space_3_extras": (rank_space, extras)}

    src = (build.CSRC / "compact_mask.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for name, change in VARIANTS.items():
            libs[name], ptxas = build_variant(build, name, variant_source(src, change), Path(tmp))
            print(json.dumps({"variant": name, "ptxas": ptxas}), flush=True)
        for label, (vals, ex) in shapes.items():  # the unchanged kernel is exact
            got, got_t = launch(torch, libs["base"], vals, ex)
            want, want_t = kernels.compact_mask_plain(vals, ex)
            t = int(want_t)
            if int(got_t) != t or not all(torch.equal(a[:t], b[:t]) for a, b in zip(got, want)):
                raise AssertionError(f"base variant disagrees with the plain version on {label}")
        copy = device_profile(torch, lambda: pad_strip.clone())
        print(json.dumps({"copy_64MB_device_ms": copy["device_ms"]}), flush=True)
        for rnd in range(args.rounds):
            for name, lib in libs.items():
                row = {"round": rnd, "variant": name}
                for label, (vals, ex) in shapes.items():
                    row[label + "_device_ms"] = device_profile(
                        torch, lambda: launch(torch, lib, vals, ex))["device_ms"]
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
