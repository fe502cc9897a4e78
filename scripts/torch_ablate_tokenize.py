"""Where the device time of overlay_fit.cu and expand_to_mask.cu goes:
variants of each kernel, built from the source with one change, timed on
one CUDA card beside the parent design.

    python scripts/torch_ablate_tokenize.py [--rounds 3] [--parent DIR]

The inputs are the main path's first call of each kernel: the script trains
an 8,192-token vocab on chip_smoke.py's 16 MB corpus (bench.py's Zipfian
text, seed 0), runs one ``Tokenizer.encode_bytes`` pass and records the
level-1 stream of ``overlay_fit`` (147 x 2^17 rows) and the mask and values
of ``expand_to_mask`` (2^24 entries).

Each variant is built into a temporary directory with the repo's nvcc flags
plus ``-Xptxas -v`` and launched as the wrappers launch it; ``--parent``
names a checkout of the parent commit (``git archive``), whose two kernels
are built and timed the same way. The unchanged kernels (and the parent's)
are first checked against the plain versions. Then, in turns over
``--rounds`` rounds, the script prints one JSON line per variant with its
device time and device operations per call (torch.profiler: the memset and
the kernels) and its CUDA-event time per call over 20 calls enqueued back
to back (``loop_ms``). A device copy of the level-1 stream is timed beside
them as the card's copy rate. The variants other than ``base`` compute something
else and are timing probes only:

* overlay_fit: ``loads_only`` (each tile loads and stages its rows,
  builds its aggregate and stores the three outputs, with no scan, per-row
  work or look-back), ``no_look_back`` (a tile starts from nothing),
  ``div64`` (the chunk index by a 64-bit division), ``ladder`` (a 5-round
  shuffle ladder per depth in place of the ballots), ``rows4`` and
  ``rows8`` (4 or 8 rows per thread in place of 16), ``backoff`` (a
  __nanosleep between reads of a window that is not ready);
* expand_to_mask: ``count_only`` (a tile returns once its count is
  published), ``early_zeros`` (a load of four entries with none set stores
  its zeros before the look-back), ``no_look_back`` (a tile reads the
  values from the start), ``no_staging`` (each set entry reads its value
  from device memory), ``blocks8`` (registers bounded for 8 resident
  blocks per SM in place of 6), ``tile4096`` (4096-entry tiles in place of
  8192), ``backoff`` (a __nanosleep between reads of a window that is not
  ready), ``prepass`` (a kernel counts every tile first, so no look-back
  waits).

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

LADDER = """    uint32_t inc = last;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
        const uint32_t y = __shfl_up_sync(FULL_MASK, inc, s);
        if (lane >= s && inc == 0u) inc = y;
    }
    const uint32_t e = __shfl_up_sync(FULL_MASK, inc, 1);
    return lane ? e : 0u;
}

"""
COUNT_TILES = """__global__ void __launch_bounds__(THREADS) count_tiles(const unsigned char* mask, long long n,
                                                     unsigned long long* status) {
    __shared__ int s_count;
    const long long start = (long long)blockIdx.x * TILE_N;
    if (threadIdx.x == 0) s_count = 0;
    __syncthreads();
    int c = 0;
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
        const long long p = start + (long long)VEC * (j * THREADS + threadIdx.x);
#pragma unroll
        for (int k = 0; k < VEC; ++k) c += p + k < n && mask[p + k] != 0;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) c += __shfl_xor_sync(FULL_MASK, c, d);
    if ((threadIdx.x & 31) == 0) atomicAdd(&s_count, c);
    __syncthreads();
    if (threadIdx.x == 0)
        store_status(status + blockIdx.x, (blockIdx.x == 0 ? ST_PREFIX : ST_COUNT) | (unsigned long long)s_count);
}

}  // namespace
"""
BACKOFF_LOOK_BACK = """__device__ inline unsigned long long look_back_backoff(const unsigned long long* status, long long tile,
                                                     int lane) {
    unsigned long long excl = 0;
    for (long long pred = tile - 1 - lane;; pred -= 32) {
        unsigned long long s;
        for (;;) {
            s = pred >= 0 ? load_status(status + pred) : ST_PREFIX;
            if (!__any_sync(FULL_MASK, s == 0)) break;
            __nanosleep(100);
        }
        const unsigned prefixes = __ballot_sync(FULL_MASK, (s & ST_PREFIX) != 0);
        const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
        unsigned long long v = lane <= stop ? (s & ST_VALUE) : 0;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL_MASK, v, d);
        excl += v;
        if (prefixes) return excl;
    }
}

"""
# (file, [(old, new), ...]); an old text of the form ("CUT", start, end)
# removes everything from start up to (not including) end
VARIANTS = {
    "overlay_fit": {
        "base": [],
        "loads_only": [(("CUT", "    // warp 0, lane d: the tile's aggregate is published at once",
                         "    // the packed and gid outputs"),
                        "    __syncthreads();\n")],
        "no_look_back": [("carry = seg_look_back(status + seg * P.tiles * NSTATUS, tile, P.depths, lane);",
                          "carry = 0u;")],
        "div64": [("const uint32_t q = P.cs_shift >= 0 ? pos >> P.cs_shift : pos / P.cs;",
                   "const uint32_t q = (uint32_t)((long long)pos / (long long)P.cs);")],
        "ladder": [(("CUT", "    const unsigned lo = __ballot_sync(FULL_MASK, has)",
                     "__device__ __forceinline__ uint32_t state_of"), LADDER)],
        "rows4": [("constexpr int RPT = 16;", "constexpr int RPT = 4;")],
        "rows8": [("constexpr int RPT = 16;", "constexpr int RPT = 8;")],
        "backoff": [("        if (!blocked) pred -= 32;", "        if (!blocked) pred -= 32;\n        else __nanosleep(100);")],
    },
    "expand_to_mask": {
        "base": [],
        "count_only": [("    // warp 0 publishes the tile's count",
                        "    if (t == 0) store_status(status + tile, (tile == 0 ? ST_PREFIX : ST_COUNT) | "
                        "(unsigned long long)s_count);\n    return;\n    // warp 0 publishes the tile's count")],
        "early_zeros": [("    // warp 0 publishes the tile's count",
                         "#pragma unroll\n    for (int j = 0; j < LOADS; ++j)\n"
                         "        if (((set >> (VEC * j)) & 0xFu) == 0u)\n"
                         "            store_out(out, n, start + (long long)VEC * (j * THREADS + t), 0u, 0u, 0u, 0u);\n"
                         "    // warp 0 publishes the tile's count"),
                        ("        int r = first[j] + load_off[j * WARPS + warp];",
                         "        if (((set >> (VEC * j)) & 0xFu) == 0u) continue;\n"
                         "        int r = first[j] + load_off[j * WARPS + warp];")],
        "no_look_back": [("const unsigned long long base = tile == 0 ? 0 : look_back(status, tile, lane);",
                          "const unsigned long long base = 0;")],
        "no_staging": [("#pragma unroll 4\n"
                        "    for (int i = t; i < count; i += THREADS) stage[i] = base + i < m ? __ldg(vals + base + i) : 0u;\n"
                        "    __syncthreads();\n", "    __syncthreads();\n"),
                       ("if ((set >> (VEC * j + k)) & 1u) x[k] = stage[r++];",
                        "if ((set >> (VEC * j + k)) & 1u) { const long long src = base + r++; "
                        "x[k] = src < m ? vals[src] : 0u; }")],
        "blocks8": [("constexpr int MIN_BLOCKS = 6;", "constexpr int MIN_BLOCKS = 8;")],
        "tile4096": [("constexpr int LOADS = 8;", "constexpr int LOADS = 4;")],
        "backoff": [("const unsigned long long base = tile == 0 ? 0 : look_back(status, tile, lane);",
                     "const unsigned long long base = tile == 0 ? 0 : look_back_backoff(status, tile, lane);"),
                    ("__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)\nexpand_tiles(", BACKOFF_LOOK_BACK
                     + "__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)\nexpand_tiles(")],
        "prepass": [("}  // namespace\n", COUNT_TILES),
                    ("    expand_tiles<<<", "    count_tiles<<<(unsigned)ntiles, THREADS, 0, s>>>(mask, n, words + 1);\n"
                                          "    expand_tiles<<<")],
    },
}
_P, _I = ctypes.c_void_p, ctypes.c_longlong
SIGNATURES = {  # this tree's entry points, and the parent's overlay_fit
    "overlay_fit": [_P] + [_I] * 8 + [_P] * 3,
    "parent_overlay_fit": [_P] + [_I] * 8 + [_P] * 5,
    "expand_to_mask": [_P, _I, _P, _I, _P, _P, _P],
}


def variant_source(src: str, name: str, changes) -> str:
    for old, new in changes:
        if isinstance(old, tuple):
            _, a, b = old
            i = src.find(a)
            j = src.find(b, i) if i >= 0 else -1
            if i < 0 or j < 0:
                raise RuntimeError(f"{name}: the source no longer holds {a!r} ... {b!r}")
            src = src[:i] + new + src[j:]
            continue
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the source holds {old!r} {src.count(old)} times, want once")
        src = src.replace(old, new)
    return src


def build_libs(build, jobs: dict, out_dir: Path) -> dict:
    """Compile every (label -> (source text, common.cuh text)) in parallel;
    returns label -> (ctypes library, ptxas register and spill lines)."""
    procs = {}
    for label, (src, common) in jobs.items():
        d = out_dir / label
        d.mkdir()
        (d / "common.cuh").write_text(common)
        (d / "k.cu").write_text(src)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(d / "k.so"), str(d / "k.cu")]
        procs[label] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for label, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{label}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(out_dir / label / "k.so"))
        lines = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        libs[label] = (lib, lines)
    return libs


def bind(lib, kernel: str):
    """The entry point of a variant library with its argument types; the
    parent's overlay_fit (no of_tile_rows export) takes three outputs and an
    int32 scratch."""
    parent = kernel == "overlay_fit" and not hasattr(lib, "of_tile_rows")
    fn = getattr(lib, kernel)
    fn.argtypes = SIGNATURES[("parent_" if parent else "") + kernel]
    fn.restype = ctypes.c_int
    words = lib.of_scratch_words if kernel == "overlay_fit" else lib.em_scratch_words
    words.argtypes = [_I, _I] if kernel == "overlay_fit" else [_I]
    words.restype = ctypes.c_longlong
    return fn, words, parent


def overlay_launcher(torch, lib, skp, input_len: int, kw: dict):
    fn, words, parent = bind(lib, "overlay_fit")
    nseg, m = skp.shape
    args = (nseg, m, input_len, kw["chunk_size"], kw["depths"], kw["base_len"], kw["max_depth"], kw["group_depth"])

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        if parent:
            outs = [torch.empty_like(skp) for _ in range(3)]
            scratch = torch.empty(max(1, int(words(nseg, m))), dtype=torch.int32, device=skp.device)
            rc = fn(skp.data_ptr(), *args, *[o.data_ptr() for o in outs], scratch.data_ptr(), stream)
        else:
            out = torch.empty(3, nseg, m, dtype=torch.int32, device=skp.device)
            scratch = torch.empty(int(words(nseg, m)), dtype=torch.int64, device=skp.device)
            rc = fn(skp.data_ptr(), *args, out.data_ptr(), scratch.data_ptr(), stream)
            outs = out.unbind(0)
        if rc != 0:
            raise RuntimeError(f"overlay_fit launch failed with cudaError {rc}")
        return outs

    return call


def expand_launcher(torch, lib, mask, vals):
    fn, words, _ = bind(lib, "expand_to_mask")
    n = mask.numel()

    def call():
        out = torch.empty(n, dtype=torch.int32, device=mask.device)
        scratch = torch.empty(max(1, int(words(n))), dtype=torch.int64, device=mask.device)
        rc = fn(mask.data_ptr(), n, vals.data_ptr(), vals.numel(), out.data_ptr(), scratch.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"expand_to_mask launch failed with cudaError {rc}")
        return out

    return call


def loop_ms(torch, fn, calls: int = 20) -> float:
    """CUDA-event time per call of ``calls`` calls enqueued back to back
    (the card stays busy, so launch gaps count but host time hides)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def main_path_inputs(torch):
    """(overlay args, overlay kwargs, expand args) of the main path's first
    calls: an 8,192-token vocab trained on the 16 MB corpus, one pass."""
    from chip_smoke import TOKENIZE_VOCAB, recorded_calls, synth_corpus
    from gpu_bpe_tpu_torch import Tokenizer, Trainer
    from gpu_bpe_tpu_torch.ops import tokenize as ttz
    from gpu_bpe_tpu_torch.ops.ingest import make_stream
    from gpu_bpe_tpu_torch.pretok import byte_word_starts

    corpus = synth_corpus(16 << 20, seed=0)
    vocab = Trainer(device="cuda").train_stream(make_stream(corpus, byte_word_starts(corpus)),
                                                target_vocab_size=TOKENIZE_VOCAB).vocab
    with recorded_calls(ttz) as calls:
        Tokenizer(vocab).encode_bytes(corpus)
    (skp, input_len), kw = calls["overlay_fit"][0]
    (mask, vals), _ = calls["expand_to_mask"][0]
    return (skp, int(input_len)), kw, (mask, vals)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--parent", type=Path, default=None, help="a checkout of the parent commit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2

    from chip_smoke import device_profile, nvidia_smi_line
    from gpu_bpe_tpu_torch.ops import build, kernels, stab_kernels

    print(nvidia_smi_line(), flush=True)
    ov_args, ov_kw, ex_args = main_path_inputs(torch)
    skp, input_len = ov_args
    mask, vals = ex_args
    print(json.dumps({"overlay_fit": {"shape": list(skp.shape), "input_len": input_len, **ov_kw},
                      "expand_to_mask": {"n": mask.numel(), "set": int(mask.sum()), "vals": vals.numel()}}),
          flush=True)

    common = (build.CSRC / "common.cuh").read_text()
    jobs = {}
    for kernel, variants in VARIANTS.items():
        src = (build.CSRC / f"{kernel}.cu").read_text()
        for name, changes in variants.items():
            jobs[f"{kernel}/{name}"] = (variant_source(src, name, changes), common)
        if args.parent:
            pdir = args.parent / "gpu_bpe_tpu_torch" / "ops" / "csrc"
            jobs[f"{kernel}/parent"] = ((pdir / f"{kernel}.cu").read_text(), (pdir / "common.cuh").read_text())
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_libs(build, {k.replace("/", "__"): v for k, v in jobs.items()}, Path(tmp))
        calls = {}
        for label in jobs:
            lib, ptxas = libs[label.replace("/", "__")]
            kernel, name = label.split("/")
            print(json.dumps({"variant": label, "ptxas": ptxas}), flush=True)
            calls[label] = (overlay_launcher(torch, lib, skp, input_len, ov_kw) if kernel == "overlay_fit"
                            else expand_launcher(torch, lib, mask, vals))
        want_ov = stab_kernels.overlay_fit_plain(skp, input_len, **ov_kw)
        want_ex = kernels.expand_to_mask_plain(mask, vals)
        for label in [k for k in calls if k.endswith(("/base", "/parent"))]:  # the real kernels are exact
            got = calls[label]()
            torch.cuda.synchronize()
            want = want_ov if label.startswith("overlay_fit") else (want_ex,)
            got = got if label.startswith("overlay_fit") else (got,)
            if not all(torch.equal(a, b) for a, b in zip(got, want, strict=True)):
                raise AssertionError(f"{label} disagrees with the plain version")
        del want_ov, want_ex
        copy = device_profile(torch, lambda: skp.clone())
        print(json.dumps({"copy_device_ms": copy["device_ms"], "copy_bytes": 2 * 4 * skp.numel()}), flush=True)
        for rnd in range(args.rounds):
            for label, call in calls.items():
                prof = device_profile(torch, call)
                print(json.dumps({"round": rnd, "variant": label, "device_ms": prof["device_ms"],
                                  "device_ops": prof["device_ops"], "loop_ms": loop_ms(torch, call)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
