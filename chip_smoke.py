"""Smoke test of the PyTorch/CUDA port (gpu_bpe_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit from nvidia-smi, torch and CUDA
   versions;
2. build: the CUDA kernels built from ops/csrc with nvcc (seconds);
3. kernel checks: each kernel against its plain PyTorch version on the card,
   on inputs made from a numpy seed at the main path's shapes (capacity
   2^20, ~0.9 M live symbols, a live 256-slot window): affected sets in each
   16-probe tier and above 64, ids >= 0x8000, overlap runs and word starts
   at block edges, garbage past n; the merge's hard cases: an (a,a) run
   longer than a 4096-entry compaction tile (a whole tile with no
   survivor), a site at cap - 2 with n == cap, n in {0, 1, 2}, every
   capacity of the shrink ladder from 2^19 down to 2^11 called one after
   another (the cached scratch must stay clean across capacities), an
   unaligned view and calls on a second stream; the probe-less mode (a
   window with every slot dead, three streams, and the call with no window
   on the real first merge at the shard capacities of a split over 1 and 2
   ranks, called in turn, against its plain version and the dead-window
   call; its times beside the window-mode call's); count_pairs2 on pairs
   whose token Z sits only at the first and the last live position;
   window_post's scalars as the main path passes them (bool flags, 0-d
   int64 views, one-element slices) and as Python ints. Bitwise comparison
   (tolerance 0: both versions sum integers exactly and round the
   histograms to f32 once). Each line has the kernel's median time over
   CUDA events around one wrapper call (ms), its host time per call
   enqueued back to back (host_ms), its device time and device operations
   per call from torch.profiler (device_ms, device_ops; window_post and
   count_pairs2 must be exactly one kernel, merge_compact_tracked at most
   two), the plain version's time, the bytes it must move and the bound
   at 3.35 TB/s;
4. main path: Trainer(device="cuda") on bench.py's 16 MB synthetic Zipfian
   corpus (seed 0), 1024 merges (vocab 256 -> 1280), byte-heuristic word
   starts; merges/s, recounts, final n and capacity, and every kernel's
   launch count on this run (each must be > 0);
5. the same trainer with force_recount=True for the first 256 merges: its
   merge list must equal phase 4's first 256 merges;
6. phase 4's corpus cut to 1 MB, 128 merges, on cuda and on cpu: the merge
   lists must be equal;
7. tokenize vocab: Trainer(device="cuda") to 8,192 tokens on phase 4's
   corpus (bench.py's TOKENIZE_VOCAB), and bench.py's synthetic 65,536-entry
   vocab of the same corpus's words (full stab chain);
8. tokenize main path: Tokenizer(vocab).encode_bytes on the 16 MB corpus as
   one pass, at the 8K vocab and then at the 64K vocab; every tokenize
   kernel's launch count on these two runs (each must be > 0, and the
   rank-space chain must engage in at least one); device MB/s (passes
   chained on the card, timed by CUDA events), wall MB/s (upload, pass and
   host copy), bytes/token, stab levels, dense lengths;
9. tokenize checks: the ids equal rank_mode="off" on the card at the full
   16 MB for both vocabs; on a 1 MB cut the card's ids equal the port's CPU
   path and GreedyTrieEncoder; decode(ids) returns the corpus;
10. tokenize kernel checks: each of compact_valid, compact_mask,
   expand_to_mask, overlay_fit and dense_match (the long-token tails of
   both vocabs, over the stab join's result) against its plain version on
   the card
   (tolerance 0; compaction outputs on their first `total` entries), on the
   inputs the main path gave it (recorded during phase 8) and on synthetic
   edge cases (all or none dropped, a ragged tail, ids >= 0x8000, random
   sorted streams of any length; for the compactions also sizes of one
   tile - 1, tile and tile + 1, 2^24 + 7, survivors only in the last of
   4096 tiles, every entry kept and an unaligned view, each with 0, 1, 3
   and 9 extras; for expand_to_mask sizes of one tile - 1, tile and
   tile + 1, 2^24 + 7, no entry set, every entry set, set entries only in
   the last tile, a bool view 1 byte past its allocation and more values
   than set entries; for overlay_fit 400 segments of 3000 rows with every
   third one free of ops, one 2^21-row segment whose opens lie in its
   first tile and whose fitting positions in its last, segments of one
   tile - 1, tile and tile + 1 rows, group_depth = depths - 1 above
   max_depth, and a chunk size of 1000 with positions at cs - 1, cs and
   input_len - 1); at the main path's first call's shapes, the time of
   each and of one PyTorch call computing the same function (library),
   timed in turns, host_ms, device_ms and device_ops of both (each of the
   kernels at most one memset and one kernel), the plain version's time, the
   byte bound, and whether its inputs fit in the 50 MB L2 (so that the
   back-to-back timed calls may find them there); and compact_mask at the
   training recount's first call (2^25 entries, 2 extras, recorded in
   phase 12) with the same readings beside three `masked_select` calls;
11. api_train: `api.train` on the 16 MB corpus with the default Unicode
   pre-tokenizer (which must run on the native C++ backend) and dedup to
   256 + 2048 tokens: the merge list and counts must hash to the JAX
   package's record (docs/artifacts/certificate_validation_cpu16mb.json);
   pre-tokenize seconds and MB/s on the host, stream n, capacity, merges/s,
   recounts; on a 1 MB cut (128 merges) the card's merge list must equal
   `device="cpu"` and `backend="cpu"` (the CPU oracle);
12. api_train_nodedup: `api.train(pre_tokenize=False)` on the same 16 MB,
   one symbol per byte at capacity 2^25, 1024 merges: the segmented
   recount must engage (recounts by tier), compact_mask must launch; peak
   allocated memory; the first 128 merges must equal a `force_recount`
   run; then one segmented and one monolithic recount of the stream cut to
   capacities 2^20..2^25 (at 2^25 the whole stream: the run's first
   recount), timed, must give the same winner, count and theta;
13. api_encode: `api.encode_bulk` of the 16 MB corpus with phase 11's
   tokenizer must equal `Tokenizer` directly; `export_bin` round-trips
   through `read_dxft`; the trie and the saved model equal the CPU path's
   (and the 1 MB cut's card and CPU-path models are byte-identical); then
   the three paths no other run reaches, each through `api.encode_bulk`
   and held on a cut to the port's CPU path and `GreedyTrieEncoder`:
   multi-pass slicing (17 MB with the 64K vocab), the gather walk (80-byte
   tokens) and the rank chain's full-width fallback;
14. dist_train: `api.train(backend="dist")` on phase 11's corpus and recipe,
   in a one-rank NCCL group on the card: the merge list and counts must
   hash to the same JAX record; merges/s, recounts, duals, collectives and
   host reads per merge, and the launches (the probe-less merge only);
15. dist_train_2rank: two processes (this script with `--dist-worker`), a
   gloo group on the one card, train phase 4's stream for 1024 merges: both
   merge lists must equal phase 4's; shard sizes, merges/s, and the
   transport of the collectives (gloo takes the CUDA tensors as they are;
   nothing is staged by the port);
16. train_files: the 64 MB corpus (the certificate run's, of which the
   16 MB corpus is the head) written to a file and trained by
   `api.train_files` in 4 MB chunks to 256 + 8192 tokens on the native
   ingest: the chunked stream must equal `make_stream` of the whole
   pre-tokenized corpus, the merge list and counts must hash to the JAX
   package's 64 MB record (docs/artifacts/certificate_validation.json);
   ingest seconds, merges/s, the process's peak RSS; then the 16 MB head
   through `train_files(backend="dist")` in a one-rank NCCL group must hash
   to the 16 MB record;
17. checkpoint: phase 4's stream trained to 256 + 512 with a checkpoint
   after every 128-merge batch, the checkpoint replayed alone (seconds;
   512 probe-less launches) and resumed to 256 + 1024: the merge list and
   counts must equal phase 4's; phase 6's cut replayed on the card must
   equal the replay on the CPU;
18. cli: subprocesses of `python -m gpu_bpe_tpu_torch.cli` on the 1 MB cut
   in a file: `train` with and without `--stream` (model.json byte-equal to
   `api.train`'s on the card), `encode` then `decode`, `export-bin`,
   `export-trie` and `vocab` equal to the API's, `export-hf` with both
   `--pretok` values loaded back through `BPEModel.from_json`, `inspect`,
   and `warmup --min-log2 11 --max-log2 13`;
19. selftest: `run_kernel_selftest()` on the card, every case true; then
   the explicit-probe mode of merge_compact_tracked on phase 3's real
   first merge (the window's affected pairs as the caller's list), bitwise
   against its plain version and the window-mode call, timed in turns
   with it;
20. unicode: (a) `backend_name()` must be `cpp-decoder`, and every one of
   the 97 exports of the native Unicode library bound by
   `unicode/cpp_backend.py` is held against the port's Python backend on a
   fixed sample (`unicode.selftest`; whether the optional `regex` module is
   present is printed); (b) the reference-compat Hangul mode through
   `api.train` on the card: phase 11's corpus with every other line
   replaced by NFD Korean words (`synth_hangul_corpus`, about half of its
   bytes jamo), 256 + 2048 tokens, in the default mode and with
   `set_ref_hangul(True)`: each mode's merge list and counts must hash to
   the JAX package's record (docs/artifacts/ref_hangul_cpu16mb.json,
   written by `scripts/ref_hangul_record.py`); on each mode's 1 MB cut
   (128 merges) `api.train` on the card must equal the CPU oracle
   (`backend="cpu"`), `api.train_files` on the cut in a file, and the CLI's
   `train` in a process of its own that takes the mode from
   `GPU_BPE_TPU_REF_HANGUL`; the two modes' lists must differ;
   pre-tokenize MB/s and merges/s with the card's name and power limit;
21. multi_merge: `Trainer(multi_merge=True)` (the multi-merge iteration,
   up to three merges per certificate decision) on phase 4's stream for
   1024 merges: the merge list and counts must equal phase 4's, duals > 0,
   merge_compact_tracked and count_pairs2 must launch and window_post must
   not; merges/s, duals, recounts, host reads per merge by site and the
   neutralised merges (launches past the merges made); `api.train` on
   phase 11's recipe with `GPU_BPE_TPU_MULTI=1` must hash to the 16 MB
   record; `force_recount=True` for 256 merges must equal phase 4's first
   256; phase 12's no-dedup stream at 2^25 for 256 merges must equal
   phase 12's first 256, with segmented recounts and compact_mask; then
   the default and the multi-merge trainer in turns on phase 4's stream,
   five runs each: merges/s medians, extremes and host reads per merge,
   with the card's name and power limit;
22. force_recount_env: `api.train` on phase 11's recipe for 256 merges
   with `GPU_BPE_TPU_FORCE_RECOUNT=1` set in this process, in the default
   loop and with `GPU_BPE_TPU_MULTI=1`: each merge list and its counts
   must equal phase 11's first 256, with one recount per merge and no
   dual; the variables are restored afterwards;
23. tokenize_devices: the tokenizer's default device list
   (`ops.tokenize.pass_devices`) must be every visible card, `[cuda:0]`
   with `GPU_BPE_TPU_TOKENIZE_ALL_DEVICES=0` and every card with `=1`;
   `api.encode_bulk` of phase 11's model through a fresh `BPETokenizer` on
   the 16 MB corpus must equal phase 13's ids; a `Tokenizer` with
   `devices=["cuda:0", "cuda:0"]` and 1 MB passes must equal phase 8's
   one-pass ids at the 8K vocab;
24. soak: a fixed slice of `scripts/torch_soak_fuzz.py` on the card,
   tokenizer seeds 1000-1063 and trainer seeds 1,001,000-1,001,031 (eight
   on each trainer loop): no trial may fail, and every kernel, both modes
   of the merge included, must launch; trial counts by kind, seconds,
   trials per second and launches;
25. bitonic: the bitonic compare-exchange rounds (`ops/bitonic.py`,
   `bitonic_rounds.cu`, the port of the Pallas kernel of
   `scripts/microbench_bitonic.py`) against their plain version on the
   card (tolerance 0): at the JAX script's default shape (147 blocks of
   [1024, 128]) at 32 and at 153 rounds (a full sort's), at 0-8, 10, 13,
   32, 69, 70, 71 and 153 rounds (every end of the kernel's unrolled
   7-stride cycle and of the 10-round direction cycle) on 1 and 2 blocks
   for the script's inputs, words with bit 31 set in every word, ties in
   word 0, ties in words 0-1 and whole-row duplicates, and on a second
   stream; then `scripts/torch_microbench_bitonic.py`'s run at the
   default shape (the kernel's launches counted from 0 around it): ms per
   call back to back, ns per element and round, the 153-round estimate
   and the `torch.sort` yardsticks (int64 keys over [147, 2^17], stable
   and not, and the recount's [cap >> 17, 2^17] sort at 2^22 and 2^25);
   the kernel's ms, host_ms, device_ms and device_ops (one operation, at
   32 and at 153 rounds), the plain version's time, the bytes and
   operations bounds (5 integer operations per element and round at 64
   per clock per SM, from the card's SM count and maximum SM clock), the
   rate, `bound_by` and `bound_fraction` (the bound over the back-to-back
   ms);
26. bench: `python3 bench_torch.py --runs 3` (the port's headline bench,
   the counterpart of `bench.py`) in a process of its own: it must exit 0
   with exactly one stdout line of the four keys whose value is the median
   of its runs, every selftest case true, the dist smoke equal to the
   single-card run, its stream n equal to phase 11's and its 1024-merge
   list and counts hashing to phase 11's first 1024, and each of the six
   JAX kernels' counterparts (both modes of the merge) launched; the
   median, min and max merges/s, each run's, and the three tokenize rows;
27. dense_match: `dense_match.cu` (the dense join's hash probe) against its
   plain version on the card (tolerance 0) at phase 12's vocab cut to 1,024
   entries (768 keys, no stab table) on the 16 MB corpus as one pass, with
   the input ending inside a chunk, with a 500-byte chunk on a view 3 bytes
   in, over an incoming match, with the table at its least size (colliding
   probes) and too large for shared memory, at tile edges with 512-byte
   chunks, on one partial tile, and on a vocab of 64-200-byte tokens; the
   hits of each; at the 16 MB pass the kernel's ms beside the whole match
   table's (in turns), host_ms, device_ms and device_ops (one kernel), the
   plain version's ms, the byte bound and its fraction, the table's shape
   and the pass's device and wall MB/s.

The launch counts of the kernels' line are the sums over the main-path
runs (phases 4, 8, 11-17, 19 and 20, every rank's in phase 15, phase
21's main and 2^25 runs, phases 22-24, and the bench's run in phase 26
after its selftest), each counted from 0; the
explicit-probe mode runs on the selftest's path only, and
`bitonic_rounds`, which no training or tokenize path calls, on phase
25's run of the microbenchmark; phase 27's calls are not counted.
Then the kernels' JSON line, the nvidia-smi line and, last, the result line.
Any mismatch or exception exits non-zero; without a CUDA device the script
exits non-zero before printing anything.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from contextlib import contextmanager
from pathlib import Path

import numpy as np

# the bench's helpers; the scripts and tests import them from here too
from bench_torch import (  # noqa: F401
    PROBE_LESS,
    TOKENIZE_KERNELS,
    TRAIN_KERNELS,
    nvidia_smi_line,
    pass_rates,
    sha_pair,
    synth_corpus,
    synth_vocab_64k,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate
L2_BYTES = 50 << 20  # H100 L2 cache
CAP = 1 << 20
N_LIVE = 900_000
CORPUS_BYTES = 16 << 20
MERGES = 1024
FORCE_MERGES = 256
SMALL_BYTES = 1 << 20
SMALL_MERGES = 128
TOKENIZE_VOCAB = 8192
API_MERGES = 2048  # the JAX package's recorded 16 MB certificate run
NODEDUP_MERGES = 1024
NODEDUP_FORCE = 128
CERT16 = "docs/artifacts/certificate_validation_cpu16mb.json"
REF_HANGUL = "docs/artifacts/ref_hangul_cpu16mb.json"  # the JAX package's lists in both Hangul modes
UNICODE_EXPORTS = 97  # the native decoder's exports bound by unicode/cpp_backend.py
REPO = Path(__file__).resolve().parent
PALLAS = "gpu_bpe_tpu/ops/pallas_kernels.py"
CSRC = "gpu_bpe_tpu_torch/ops/csrc"
KERNELS = {
    "merge_compact_tracked": (f"{CSRC}/merge_compact_tracked.cu", f"{PALLAS}:136"),
    "count_pairs2": (f"{CSRC}/count_pairs2.cu", f"{PALLAS}:641"),
    "window_post": (f"{CSRC}/window_post.cu", f"{PALLAS}:1094"),
    "compact_valid": (f"{CSRC}/compact_mask.cu", f"{PALLAS}:746"),
    "compact_mask": (f"{CSRC}/compact_mask.cu", f"{PALLAS}:746"),
    "expand_to_mask": (f"{CSRC}/expand_to_mask.cu", f"{PALLAS}:943"),
    "overlay_fit": (f"{CSRC}/overlay_fit.cu", "gpu_bpe_tpu/ops/stab_kernels.py:81"),
    "bitonic_rounds": (f"{CSRC}/bitonic_rounds.cu", "scripts/microbench_bitonic.py:44"),
    "dense_match": (f"{CSRC}/dense_match.cu", "none: own design (the dense join is plain jnp)"),
}
EXPLICIT_PROBES = "merge_compact_tracked/explicit-probes"  # ops/kernels.py EXPLICIT_PROBES
KERNELS[PROBE_LESS] = KERNELS["merge_compact_tracked"]
KERNELS[EXPLICIT_PROBES] = KERNELS["merge_compact_tracked"]
CORPUS64_BYTES = 64 << 20  # the certificate run's corpus (its first 16 MB are CORPUS_BYTES')
CERT64 = "docs/artifacts/certificate_validation.json"
FILES_MERGES = 8192  # the recorded 64 MB certificate run
FILES_CHUNK = 4 << 20  # 16 chunks of the 64 MB file, each with a carry
CKPT_BATCH = 128  # merges per batch of the checkpointed run, a checkpoint after each
CKPT_MERGES = 512  # merges before the resume (phase 4 goes on to MERGES)
CLI_TIMEOUT_S = 300
MULTI_SEG_MERGES = 256  # the multi-merge run on phase 12's no-dedup stream
MULTI_PAIRS = 5  # runs of each trainer in phase 21's paired timing
DIST_RANKS = 2  # the ranks of the two-rank phase, both on the one card
DIST_TIMEOUT_S = 300  # the two-rank phase's process group and processes
DEVICES_PASS_BYTES = 1 << 20  # phase 23's passes over the 16 MB corpus, two entries in the device list
SOAK_SCRIPT = "scripts/torch_soak_fuzz.py"
SOAK_SEED0 = 1000  # phase 24: tokenizer seeds SOAK_SEED0.., trainer seeds 1,000,000 above them
SOAK_TOKENIZER_SEEDS = 64
SOAK_TRAINER_SEEDS = 32  # eight on each of the four trainer loops
BITONIC_SCRIPT = "scripts/torch_microbench_bitonic.py"
BITONIC_BLOCKS, BITONIC_ROUNDS = 147, 32  # scripts/microbench_bitonic.py's defaults
# identity, one round, every end of the unrolled 7-stride cycle (R % 7) and of
# the 10-round direction cycle (R % 10), both cycles whole, and a full sort's 153
BITONIC_EDGE_ROUNDS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 13, 32, 69, 70, 71, 153)
BITONIC_KINDS = ("script", "bit31", "ties0", "ties01", "dup_rows")
BITONIC_CAPS = (1 << 22, 1 << 25)  # the segmented recount's smallest and the no-dedup capacity
BITONIC_FULL_ROUNDS = 153  # a full bitonic sort of one 2^17 segment, also checked at the default blocks
# per element and round: one 3-word compare per pair (3 ops), its direction
# (1), six selects (6): 10 per pair of elements
BITONIC_OPS = 5
INT32_LANES_PER_SM = 64  # 32-bit integer add, compare, select and logic results per clock per SM (cc 9.0)
BENCH_SCRIPT = "bench_torch.py"
BENCH_RUNS = 3  # timed training runs of phase 26's bench
BENCH_TIMEOUT_S = 300


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def synth_hangul_corpus(n_bytes: int, seed: int = 0, vocab_size: int = 20_000) -> bytes:
    """``synth_corpus(n_bytes, seed)`` with every other line replaced by a
    line of NFD Korean words: Zipfian draws from a table of 1-4-syllable
    words, each syllable written as conjoining jamo (L V, or L V T), which
    NFC composes into precomposed syllables and the reference-compat Hangul
    mode leaves as they are. About half of the bytes are Korean. The corpus
    ends at the last whole line within ``n_bytes``, so any prefix cut at a
    newline is valid UTF-8."""
    base = synth_corpus(n_bytes, seed).split(b"\n")
    rng = np.random.default_rng(seed + 1)
    lead = rng.integers(0, 19, size=(vocab_size, 4))
    vowel = rng.integers(0, 21, size=(vocab_size, 4))
    trail = np.where(rng.random((vocab_size, 4)) < 0.4, rng.integers(1, 28, size=(vocab_size, 4)), 0)
    n_syll = rng.integers(1, 5, size=vocab_size)

    def syllable(w: int, k: int) -> str:
        return chr(0x1100 + lead[w, k]) + chr(0x1161 + vowel[w, k]) + (chr(0x11A7 + trail[w, k]) if trail[w, k] else "")

    words = np.array(["".join(syllable(w, k) for k in range(n_syll[w])) for w in range(vocab_size)], dtype=object)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = ranks**-1.05
    probs /= probs.sum()
    draws = iter(rng.choice(vocab_size, size=len(base) * 8, p=probs))
    lines = []
    for i, line in enumerate(base):
        if i % 2:
            parts = []
            while sum(len(p) for p in parts) < len(line):
                parts.append(words[next(draws)].encode())
            line = b" ".join(parts)
        lines.append(line)
    out = b"\n".join(lines)
    return out[: out.rfind(b"\n", 0, n_bytes) + 1]


def time_in_turns(torch, fns, reps: int) -> list[float]:
    """Median CUDA-event time of each of ``fns``, called in turns (one call
    of each per round, after one warm-up round), so that both see the same
    state of the card."""
    times = [[] for _ in fns]
    for r in range(reps + 1):
        for fn, ts in zip(fns, times):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            if r:
                ts.append(start.elapsed_time(end))
    return [statistics.median(ts) for ts in times]


def time_ms(torch, fn, reps: int) -> float:
    """Median over ``reps`` calls of CUDA-event time (after one warm-up)."""
    return time_in_turns(torch, [fn], reps)[0]


def host_ms(torch, fn, reps: int = 200) -> float:
    """Host time per call of ``fn`` over ``reps`` calls enqueued back to
    back (no synchronisation between them), as a loop that launches it
    pays; after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / reps * 1e3


def device_profile(torch, fn, reps: int = 20, attempts: int = 5) -> dict:
    """What one call of ``fn`` puts on the card, from torch.profiler's
    key_averages() over ``reps`` calls: device_ms, the time of its kernels,
    memsets and copies summed per call; device_ops, their number per call;
    and the count and time of each per call by name. The session traces a
    warm-up step of ``reps`` calls first and keeps only the second step (the
    device tracer misses the first operations of a session). Now and then
    the tracer also drops operations inside the kept step: a session in
    which some operation was seen a number of times that is not a whole
    multiple of ``reps`` (or none at all) is run again, up to ``attempts``
    times, and the last one is kept if none was whole."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    seen = None
    for _ in range(attempts):
        steps = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=acts, schedule=steps) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        us, ops, names = 0.0, 0, {}
        for avg in prof.key_averages():
            if avg.device_type != torch.autograd.DeviceType.CUDA or avg.key.startswith("ProfilerStep"):
                continue
            t = getattr(avg, "device_time_total", None) or getattr(avg, "cuda_time_total", 0.0)
            us += t
            ops += avg.count
            names[avg.key[:80]] = {"per_call": avg.count / reps, "ms": t / 1e3 / reps}
        if ops:
            seen = {"device_ms": us / 1e3 / reps, "device_ops": ops / reps, "device_op_names": names}
            if all(v["per_call"] == round(v["per_call"]) for v in names.values()):
                return seen
    if seen is None:
        raise AssertionError(f"the profiler saw no device operation in {attempts} sessions")
    return seen


def max_abs_diff(a, b) -> float:
    """Max |a - b| over two equal-length sequences of tensors; raises on a
    shape or dtype difference."""
    worst = 0.0
    for x, y in zip(a, b, strict=True):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"shape/dtype differ: {x.shape} {x.dtype} vs {y.shape} {y.dtype}")
        d = (x.double() - y.double()).abs()
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return worst


# ───────────────────────────── kernel inputs ─────────────────────────────


def synthetic_stream(rng, toks, ws_p=0.1):
    """cap-2^20 stream of N_LIVE symbols over ``toks`` with overlap runs and
    word starts at the 1024- and 32768-element block edges and pair-
    matching garbage past n."""
    toks = np.asarray(toks, np.uint32)
    sym = np.zeros(CAP, np.uint32)
    sym[:N_LIVE] = rng.choice(toks, size=N_LIVE)
    sym[:N_LIVE] |= (rng.random(N_LIVE) < ws_p).astype(np.uint32) << 16
    sym[0] |= 1 << 16
    a, b = int(toks[0]), int(toks[1])
    for edge in range(1024, N_LIVE - 64, 1024 * 37):
        sym[edge - 3 : edge + 3] = a  # an (a,a) overlap run across the edge
        sym[edge + 3 : edge + 7] = [a, b, a, b]
    for edge in range(32768, N_LIVE - 64, 32768):
        sym[edge - 1], sym[edge] = a, b | (1 << 16)  # word start blocks the site
        sym[edge + 1], sym[edge + 2] = a, b
    w = np.zeros(CAP, np.int32)
    w[:N_LIVE] = rng.integers(1, 400, size=N_LIVE)
    sym[N_LIVE:] = np.tile(np.array([a, b], np.uint32), (CAP - N_LIVE) // 2)
    w[N_LIVE:] = 77
    return sym, w


def window_for(rng, toks, pair, n_aff, n_other=100):
    a, b = pair >> 16, pair & 0xFFFF
    aff = list(dict.fromkeys([(int(t) << 16) | a for t in toks] + [(b << 16) | int(t) for t in toks]))
    aff = [p for p in aff if p != pair]
    others = [(int(x) << 16) | int(y) for x in toks for y in toks if x != b and y != a]
    picked = list(rng.permutation(aff)[:n_aff]) + list(rng.permutation(others)[:n_other]) + [pair]
    cand = np.full(256, 0xFFFFFFFF, np.int64)
    counts = np.full(256, -1, np.int64)
    slots = rng.permutation(256)[: len(picked)]
    cand[slots] = picked
    counts[slots] = rng.integers(0, 50_000, size=len(picked))
    return cand, counts


def small_stream(rng, cap, n, toks, ws_p=0.1):
    """A cap-``cap`` stream of ``n`` random symbols over ``toks`` (word
    starts with probability ws_p), pair-matching garbage past n."""
    toks = np.asarray(toks, np.uint32)
    sym = np.zeros(cap, np.uint32)
    sym[:n] = rng.choice(toks, size=n)
    sym[:n] |= (rng.random(n) < ws_p).astype(np.uint32) << 16
    w = np.zeros(cap, np.int32)
    w[:n] = rng.integers(1, 400, size=n)
    sym[n:] = np.tile(toks[:2], (cap - n + 1) // 2)[: cap - n]
    w[n:] = 77
    return sym, w


def merge_edge_cases(rng, toks):
    """(label, sym, w, n, pair, new_id, cand, counts) of the merge's hard
    cases: an (a,a) run longer than a 4096-entry compaction tile (it covers
    the whole tile [4096, 8192) so that tile keeps nothing, and crosses its
    edges), a site at cap - 2 with n == cap, n in {0, 1, 2}, and every
    capacity of the trainer's shrink ladder from 2^19 down to 2^11, called
    one after another (each call at another capacity than the last)."""
    a, b = toks[0], toks[1]
    pair, pair_aa = (a << 16) | b, (a << 16) | a
    out = []
    sym, w = small_stream(rng, 1 << 16, 60_000, toks)
    sym[3000:15_000] = a  # one word: an (a,a) run over tiles 0-3
    sym[20_000:20_010] = a
    sym[20_005] |= 1 << 16  # a word start splits a run
    out.append(("run>tile", sym, w, 60_000, pair_aa, 300, *window_for(rng, toks, pair_aa, 20)))
    sym, w = small_stream(rng, 1 << 12, 1 << 12, toks)
    sym[-2:] = [a, b]
    out.append(("n=cap site at cap-2", sym, w, 1 << 12, pair, 300, *window_for(rng, toks, pair, 8)))
    for n in (0, 1, 2):
        sym, w = small_stream(rng, 1 << 11, n, toks)
        sym[:2] = [a, b]  # a site when n == 2; at n == 1 its b is garbage
        out.append((f"n={n}", sym, w, n, pair, 300, *window_for(rng, toks, pair, 5)))
    for k in range(19, 10, -1):
        cap = 1 << k
        n = cap // 2 + 33 + k
        sym, w = small_stream(rng, cap, n, toks)
        sym[1:n:97], sym[2:n:97] = a, b  # sites at a fixed stride
        out.append((f"cap=2^{k}", sym, w, n, pair, 0xFF00, *window_for(rng, toks, pair, 40)))
    return out


def count_edge_cases(rng, toks):
    """(label, sym, w, n, pair1, pair2) of count_pairs2 cases whose pairs
    hold a token Z only at the first and the last live position, at
    several n (16-byte vector tails of several lengths, n == cap), and n in
    {0, 1, 2}."""
    z = 0x7777
    out = []
    for cap, n in ((1 << 11, 1 << 11), (1 << 11, 2045), (1 << 20, N_LIVE), (1 << 20, N_LIVE + 1),
                   (1 << 20, N_LIVE + 2), (1 << 20, 1 << 20), (1 << 11, 0), (1 << 11, 1), (1 << 11, 2)):
        sym, w = small_stream(rng, cap, n, toks)
        if n >= 3:
            sym[0], sym[n - 1], sym[1] = z | (1 << 16), z, sym[1] & 0xFFFF
            p1, p2 = (z << 16) | int(sym[1] & 0xFFFF), (int(sym[n - 2] & 0xFFFF) << 16) | z
        else:
            p1, p2 = (toks[0] << 16) | toks[1], (toks[1] << 16) | toks[0]
        out.append((f"z-ends cap={cap} n={n}", sym, w, n, p1, p2))
    return out


def kernel_phase(torch, kernels, ts, real_stream, dev):
    """Phase 3: every kernel against its plain version on the card."""
    rng = np.random.default_rng(1234)
    toks_hi = [0x8000 + 7 * i for i in range(40)] + [0xFFFE]
    toks_lo = list(range(97, 137))
    cases = []
    for toks, new_id in ((toks_hi, 0xFF00), (toks_lo, 300)):
        sym, w = synthetic_stream(rng, toks)
        pair = (toks[0] << 16) | toks[1]
        for n_aff in (0, 12, 30, 50, 64, 70):
            cand, counts = window_for(rng, toks, pair, n_aff)
            cases.append((f"{'hi' if toks is toks_hi else 'lo'}/aff{n_aff}", sym, w, N_LIVE, pair,
                          new_id, cand, counts))
    cases += merge_edge_cases(rng, toks_lo)
    # the real main-path stream, its real first winner and recount window
    rs = ts.init_state(real_stream.symbols, real_stream.weights, real_stream.n, 256, dev)
    rs = ts._ensure_pending(rs, certified=False)
    real = ("real/first-merge", rs.symbols.cpu().numpy(), rs.weights.cpu().numpy(), real_stream.n,
            int(rs.pend_pair), 256, rs.cand.cpu().numpy(), rs.cand_counts.cpu().numpy())
    cases.append(real)
    # probe-less mode (the distributed trainer's and the selftest's): the
    # window-mode call with every slot dead probes nothing
    dead = (np.full(256, 0xFFFFFFFF, np.int64), np.full(256, -1, np.int64))
    cases += [(f"probe-less/{c[0]}", *c[1:6], *dead) for c in (cases[0], cases[6], real)]

    err = {k: 0.0 for k in TRAIN_KERNELS}
    details = []
    for name, sym, w, n, pair, new_id, cand, counts in cases:
        args = (torch.from_numpy(sym.astype(np.int32)).to(dev), torch.from_numpy(w).to(dev),
                torch.tensor(n, device=dev), torch.tensor(pair, device=dev),
                torch.tensor(new_id, device=dev), torch.from_numpy(cand).to(dev),
                torch.from_numpy(counts).to(dev))
        got = kernels.merge_compact_tracked(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize()  # a fault in the kernel surfaces here
        want = kernels.merge_compact_tracked_plain(*args)
        e = max_abs_diff(got, want)
        err["merge_compact_tracked"] = max(err["merge_compact_tracked"], e)
        sym2, w2, n2 = got[0], got[1], got[2]
        slots = (torch.tensor((int(got[5][1]) << 16) | (new_id & 0xFFFF), device=dev),
                 torch.tensor(((new_id & 0xFFFF) << 16) | int(got[5][3]), device=dev))
        c_got = kernels.count_pairs2(sym2, w2, n2, *slots)
        c_want = kernels.count_pairs2_plain(sym2, w2, n2, *slots)
        err["count_pairs2"] = max(err["count_pairs2"], max_abs_diff([c_got], [c_want]))
        details.append({"case": name, "n_aff": int(got[8]), "n_new": int(n2), "max_abs_err": e,
                        "samp": got[5].tolist(), "created_counts": c_got.tolist()})
    for name, sym, w, n, p1, p2 in count_edge_cases(rng, toks_lo):
        args = (torch.from_numpy(sym.astype(np.int32)).to(dev), torch.from_numpy(w).to(dev),
                torch.tensor(n, device=dev), torch.tensor(p1, device=dev), torch.tensor(p2, device=dev))
        c_got = kernels.count_pairs2(*args)
        torch.cuda.synchronize()
        e = max_abs_diff([c_got], [kernels.count_pairs2_plain(*args)])
        err["count_pairs2"] = max(err["count_pairs2"], e)
        details.append({"case": f"count {name}", "max_abs_err": e, "counts": c_got.tolist()})
    # unaligned views (4 bytes past the allocation) and calls on a second
    # stream: each stream has its own cached scratch
    _, sym, w, n, pair, new_id, cand, counts = cases[1]
    base = (torch.from_numpy(sym.astype(np.int32)).to(dev), torch.from_numpy(w).to(dev))
    views = (base[0][1:], base[1][1:])
    rest = (torch.tensor(n - 1, device=dev), torch.tensor(pair, device=dev), torch.tensor(new_id, device=dev),
            torch.from_numpy(cand).to(dev), torch.from_numpy(counts).to(dev))
    side = torch.cuda.Stream(device=dev)
    for label, inputs, stream in (("unaligned view", views, None), ("second stream", base, side),
                                  ("second stream again", views, side)):
        args = inputs + rest
        slots = (torch.tensor((97 << 16) | 98, device=dev), torch.tensor((98 << 16) | 97, device=dev))
        if stream is None:
            got = kernels.merge_compact_tracked(*args)
            c_got = kernels.count_pairs2(got[0], got[1], got[2], *slots)
        else:
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                got = kernels.merge_compact_tracked(*args)
                c_got = kernels.count_pairs2(got[0], got[1], got[2], *slots)
            stream.synchronize()
        torch.cuda.synchronize()
        want = kernels.merge_compact_tracked_plain(*args)
        e = max_abs_diff(got, want)
        ce = max_abs_diff([c_got], [kernels.count_pairs2_plain(want[0], want[1], want[2], *slots)])
        err["merge_compact_tracked"] = max(err["merge_compact_tracked"], e)
        err["count_pairs2"] = max(err["count_pairs2"], ce)
        details.append({"case": label, "n_new": int(got[2]), "max_abs_err": max(e, ce)})

    # window_post on the real case's merge outputs, exactly as the main path
    # builds its inputs
    st = replace_state(ts, rs)
    wp_inputs = []
    for has_room_override in (None, False):
        active, pair_eff, has_room = ts._gate(st)
        if has_room_override is not None:
            has_room = torch.zeros_like(has_room)
        m = kernels.merge_compact_tracked_plain(st.symbols, st.weights, st.n, pair_eff, st.next_id,
                                                st.cand, st.cand_counts)
        sampled = ts._sampled_pairs(st, m[5], has_room)
        l_slot, r_slot = sampled.pop("l_slot"), sampled.pop("r_slot")
        cnt2 = kernels.count_pairs2_plain(m[0], m[1], m[2], l_slot, r_slot)
        scalars = dict(pair=pair_eff, count=st.pend_count, next_id=st.next_id, theta=st.theta,
                       ub_new=st.ub_new, fill=st.fill, merges_done=st.merges_done, active=active,
                       early_stop=st.early_stop, use_probes=m[8] <= kernels.N_PROBES, n_aff=m[8],
                       c_l=cnt2[0], c_r=cnt2[1], has_room=has_room, **sampled)
        wp_inputs.append((st.cand, st.cand_counts, m[3], m[4], st.merge_log, m[7], m[6], scalars))
    # the same scalars in every form the wrapper reads in place: bool flags,
    # 0-d int64 views of samp and cnt2, a one-element slice, Python ints
    first = wp_inputs[0][7]
    mixed = dict(first, l_tok=m[5][1], r_tok=m[5][3], c_r=first["c_r"].reshape(1),
                 n_aff=m[8].reshape(1), early_stop=False)
    mixed.update({k: int(mixed[k]) for k in ("theta", "ub_new", "fill", "merges_done", "next_id")})
    wp_inputs.append(wp_inputs[0][:7] + (mixed,))
    for cand, counts, bl, br, log, probes, pcnt, scalars in wp_inputs:
        got = kernels.window_post(cand, counts, bl, br, log, probes=probes, pcnt=pcnt, **scalars)
        sc = kernels.pack_scalars(dev, probes=probes, pcnt=pcnt, **scalars)
        want = kernels.window_post_plain(sc, cand, counts, bl, br, log)
        err["window_post"] = max(err["window_post"], max_abs_diff(got, want))
    for k, e in err.items():
        if e != 0.0:
            raise AssertionError(f"{k} disagrees with its plain version: max_abs_err {e}\n{details}")

    if any(d["case"].startswith("probe-less") and d["n_aff"] != 0 for d in details):
        raise AssertionError("a dead window was probed")

    # timings at the main path's shapes: the real first merge
    _, sym, w, n, pair, new_id, cand, counts = real
    targs = (torch.from_numpy(sym.astype(np.int32)).to(dev), torch.from_numpy(w).to(dev),
             torch.tensor(n, device=dev), torch.tensor(pair, device=dev),
             torch.tensor(new_id, device=dev), torch.from_numpy(cand).to(dev),
             torch.from_numpy(counts).to(dev))
    m = kernels.merge_compact_tracked(*targs)
    n2 = int(m[2])
    slots = (torch.tensor(1, device=dev), torch.tensor((256 << 16) | 97, device=dev))
    cand, counts, bl, br, log, probes, pcnt, scalars = wp_inputs[0]
    sc = kernels.pack_scalars(dev, probes=probes, pcnt=pcnt, **scalars)
    timing = {
        "merge_compact_tracked": (
            lambda: kernels.merge_compact_tracked(*targs),
            lambda: kernels.merge_compact_tracked_plain(*targs),
            8 * n + 8 * CAP + 2 * 256 * 8 + 2 * 256 * 4 + 4 * 64 * 8,
        ),
        "count_pairs2": (
            lambda: kernels.count_pairs2(m[0], m[1], m[2], *slots),
            lambda: kernels.count_pairs2_plain(m[0], m[1], m[2], *slots),
            8 * n2 + 16,
        ),
        "window_post": (
            lambda: kernels.window_post(cand, counts, bl, br, log, probes=probes, pcnt=pcnt, **scalars),
            lambda: kernels.window_post_plain(sc, cand, counts, bl, br, log),
            2 * (2 * 256 * 8 + log.numel() * 8) + 2 * 256 * 4 + sc.numel() * 8 + 8 * 8,
        ),
    }
    rows = {}
    for k, (kern, plain, nbytes) in timing.items():
        ms = time_ms(torch, kern, 20)
        plain_ms = time_ms(torch, plain, 3)
        prof = dict(host_ms=host_ms(torch, kern), **device_profile(torch, kern))
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows[k] = dict(ms=ms, plain_ms=plain_ms, bytes=nbytes, bound_ms=bound_ms,
                       max_abs_err=err[k], **prof)
        emit({"phase": "kernel", "name": k, "cases": len(cases) if k != "window_post" else len(wp_inputs),
              "max_abs_err": err[k], "tolerance": 0, "ms": ms, "plain_ms": plain_ms, **prof,
              "bytes": nbytes, "bound_ms": bound_ms, "bound_by": "bytes"})
    emit({"phase": "kernel_cases", "cases": details})
    if round(rows["window_post"]["device_ops"]) != 1:
        raise AssertionError(f"window_post put {rows['window_post']['device_op_names']} on the card "
                             "per call, want exactly one kernel")
    if round(rows["merge_compact_tracked"]["device_ops"]) > 2:
        raise AssertionError(f"merge_compact_tracked put {rows['merge_compact_tracked']['device_op_names']} "
                             "on the card per call, want at most two kernels")
    if round(rows["count_pairs2"]["device_ops"]) != 1:
        raise AssertionError(f"count_pairs2 put {rows['count_pairs2']['device_op_names']} on the card "
                             "per call, want exactly one kernel")
    rows[PROBE_LESS] = probe_less_phase(torch, kernels, real_stream, real[4], real[6], real[7], dev)
    return rows, real


def probe_less_phase(torch, kernels, padded, pair, cand, counts, dev) -> dict:
    """Phase 3, the probe-less mode (no window; the data-parallel trainer's):
    the real first merge of the 16 MB stream on each shard of a split over
    1 and 2 ranks (shard capacities that are multiples of 1024, not powers
    of two), called with the capacities in turn (1 rank, 2 ranks' rank 0
    and rank 1, 1 rank again), each bitwise against its plain version and
    against the window-mode call with every slot dead. Then its times at
    the 1-rank shard, in turns with the window-mode call on the real window
    at the same inputs."""
    from gpu_bpe_tpu_torch.parallel import shard_stream

    n_all = padded.n
    shards = {d: shard_stream(padded.symbols[:n_all], padded.weights[:n_all], d) for d in (1, DIST_RANKS)}
    dead = (torch.full((256,), 0xFFFFFFFF, dtype=torch.int64, device=dev),
            torch.full((256,), -1, dtype=torch.int64, device=dev))
    err, details = 0.0, []
    for d, r in ((1, 0), (DIST_RANKS, 0), (DIST_RANKS, 1), (1, 0)):
        sym, w, n = shards[d]
        args = (torch.from_numpy(sym[r].view(np.int32)).to(dev), torch.from_numpy(w[r]).to(dev),
                torch.tensor(int(n[r]), device=dev), torch.tensor(pair, device=dev), torch.tensor(256, device=dev))
        got = kernels.merge_compact_tracked(*args)
        torch.cuda.synchronize()  # a fault in the kernel surfaces here
        if len(got) != 6:
            raise AssertionError(f"the probe-less call returned {len(got)} outputs, want 6")
        e = max(max_abs_diff(got, kernels.merge_compact_tracked_plain(*args)),
                max_abs_diff(got, kernels.merge_compact_tracked(*args, *dead)[:6]))
        err = max(err, e)
        details.append({"ranks": d, "rank": r, "capacity": int(sym.shape[1]), "n": int(n[r]), "n_new": int(got[2]),
                        "samp": got[5].tolist(), "max_abs_err": e})
    if err != 0.0:
        raise AssertionError(f"the probe-less merge disagrees with its plain version or the dead-window call: "
                             f"{details}")
    sym, w, n = shards[1]
    n1, cap1 = int(n[0]), int(sym.shape[1])
    args = (torch.from_numpy(sym[0].view(np.int32)).to(dev), torch.from_numpy(w[0]).to(dev),
            torch.tensor(n1, device=dev), torch.tensor(pair, device=dev), torch.tensor(256, device=dev))
    window = (torch.from_numpy(cand).to(dev), torch.from_numpy(counts).to(dev))
    kern = lambda: kernels.merge_compact_tracked(*args)  # noqa: E731
    ms, window_ms = time_in_turns(torch, [kern, lambda: kernels.merge_compact_tracked(*args, *window)], 20)
    plain_ms = time_ms(torch, lambda: kernels.merge_compact_tracked_plain(*args), 3)
    prof = dict(host_ms=host_ms(torch, kern), **device_profile(torch, kern))
    nbytes = 8 * n1 + 8 * cap1 + 2 * 256 * 4 + 4 * 8 + 8  # stream in, stream and tail out, bins, samp, n'
    row = dict(ms=ms, plain_ms=plain_ms, bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               max_abs_err=err, window_mode_ms=window_ms, **prof)
    emit({"phase": "kernel", "name": PROBE_LESS, "cases": len(details), "max_abs_err": err, "tolerance": 0,
          "ms": ms, "window_mode_ms": window_ms, "plain_ms": plain_ms, **prof, "bytes": nbytes,
          "bound_ms": row["bound_ms"], "bound_by": "bytes", "shape": {"capacity": cap1, "n": n1},
          "shards": details})
    if round(prof["device_ops"]) > 2:
        raise AssertionError(f"the probe-less merge put {prof['device_op_names']} on the card per call, "
                             "want at most two kernels")
    return row


# ───────────────────────────── tokenize phases ─────────────────────────────


@contextmanager
def recorded_calls(module, names=TOKENIZE_KERNELS, keep=None):
    """Record the arguments of the calls that ``module`` makes to the
    kernel wrappers ``names``, by name, while the block runs (the first
    ``keep`` of each when given)."""
    calls = {name: [] for name in names}
    originals = {name: getattr(module, name) for name in names}

    def recording(name, fn):
        def call(*args, **kw):
            if keep is None or len(calls[name]) < keep:
                calls[name].append((args, kw))
            return fn(*args, **kw)
        return call

    for name, fn in originals.items():
        setattr(module, name, recording(name, fn))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)


def _u32_mask(n: int, rng, keep_p: float, hi: int):
    v = rng.integers(0, hi, size=n, dtype=np.uint64).astype(np.uint32)
    v[rng.random(n) >= keep_p] = 0xFFFFFFFF
    return v


def compaction_edge_cases(torch, dev, tile: int) -> list:
    """(label, vals) of the compaction edge cases, int32 words on the card
    made from a seed (-1 drops an entry, kept words carry bits above 16):
    sizes tile - 1, tile and tile + 1, 2^24 + 7, a 2^24 stream whose only
    survivors lie in its last tile (a look-back over 4095 empty tiles),
    every entry kept, and a view 4 bytes past a 16-byte boundary."""
    g = torch.Generator(device=dev)
    g.manual_seed(77)

    def words(n, keep_p):
        v = torch.randint(-2**31, 2**31 - 1, (n,), generator=g, device=dev, dtype=torch.int32)
        return torch.where(torch.rand(n, generator=g, device=dev) < keep_p, v, -1)

    big = 1 << 24
    last_only = torch.full((big,), -1, dtype=torch.int32, device=dev)
    last_only[big - tile + 1 :: 5] = words(len(range(big - tile + 1, big, 5)), 1.0) & 0xFFFF
    return [(f"n={tile - 1}", words(tile - 1, 0.5)), (f"n={tile}", words(tile, 0.5)),
            (f"n={tile + 1}", words(tile + 1, 0.5)), ("n=2^24+7", words(big + 7, 0.3)),
            ("n=2^24 last tile only", last_only), ("n=2^24 all kept", words(big, 1.0)),
            ("unaligned view", words(3 * tile + 9, 0.5)[1:])]


def expand_edge_cases(torch, dev, tile: int) -> list:
    """(label, mask, vals) of the expansion edge cases, made on the card from
    a seed (values with every bit pattern): sizes tile - 1, tile and
    tile + 1, 2^24 + 7, no entry set, every entry set, set entries only in
    the last tile of 2^24 entries (a look-back over 2^24 / tile - 1 empty
    tiles), a bool view 1 byte past the allocation, and more values than
    set entries."""
    g = torch.Generator(device=dev)
    g.manual_seed(79)

    def rand_mask(n, p):
        return torch.rand(n, generator=g, device=dev) < p

    def values(mask, extra=0):
        n = int(mask.sum()) + extra
        return torch.randint(-2**31, 2**31 - 1, (n,), generator=g, device=dev, dtype=torch.int32)

    big = 1 << 24
    masks = [(f"n={n}", rand_mask(n, 0.5), 0) for n in (tile - 1, tile, tile + 1)]
    last_only = torch.zeros(big, dtype=torch.bool, device=dev)
    last_only[big - tile + 1 :: 3] = True
    masks += [("n=2^24+7", rand_mask(big + 7, 0.064), 0),
              ("no entry set", torch.zeros(big, dtype=torch.bool, device=dev), 5),
              ("every entry set", torch.ones(big, dtype=torch.bool, device=dev), 0),
              ("set only in the last tile", last_only, 0),
              ("unaligned view", rand_mask(3 * tile + 9, 0.5)[1:], 0),
              ("vals longer than the set count", rand_mask(5 * tile + 3, 0.3), 1000)]
    return [(label, mask, values(mask, extra)) for label, mask, extra in masks]


def overlay_rows(rng, nseg: int, m: int, *, p_op: float, pos_hi: int, quiet_every: int = 0):
    """A u32 [nseg, m] overlay stream of random rows: opens and closes (ids
    of every 16-bit value, depths 0..11, so some lie outside the depth
    slots) with probability p_op, else positions below pos_hi, with a few
    flag-3 rows; every ``quiet_every``-th segment has no op at all (a carry
    leaked from the segment before would show there)."""
    flag = np.where(rng.random((nseg, m)) < p_op, rng.choice([0, 2], size=(nseg, m)), 1).astype(np.uint32)
    flag[rng.random((nseg, m)) < 0.002] = 3
    if quiet_every:
        flag[::quiet_every] = np.where(flag[::quiet_every] == 1, 1, 3)
    depth = rng.integers(0, 12, size=(nseg, m), dtype=np.uint32)
    pay = np.where(flag == 1, rng.integers(0, pos_hi, size=(nseg, m)),
                   rng.integers(0, 1 << 25, size=(nseg, m))).astype(np.uint32)
    return (flag << 30) | (depth << 25) | pay


def overlay_edge_cases(rng, tile: int) -> list:
    """(label, skp u32 [nseg, m], input_len, overlay kwargs) of the overlay
    edge cases: 400 segments of 3000 rows (the look-back must stop at each
    segment's start); one 2^21-row segment whose opens lie in its first
    tile and whose fitting positions lie in its last (the carry crosses
    2^21 / tile - 2 tiles with no op); segments of tile - 1, tile and
    tile + 1 rows; ids >= 0x8000 throughout; group_depth = depths - 1 with
    max_depth below it; a chunk size of 1000 with positions at cs - 1, cs
    and input_len - 1."""
    base = dict(chunk_size=512, depths=10, base_len=0, max_depth=8, group_depth=9)
    out = [("400 segments x 3000", overlay_rows(rng, 400, 3000, p_op=0.02, pos_hi=1 << 21, quiet_every=3),
            1 << 21, base)]
    big = 1 << 21
    skp = np.full((1, big), (1 << 30) | 0x1FFFFFF, np.uint32)  # positions past the input: no fit
    opens = np.arange(tile, dtype=np.uint32)
    skp[0, :tile] = ((opens % 9 + 1) << 25) | (0x8000 + opens * 7)  # opens at every depth
    skp[0, -tile:] = (1 << 30) | np.arange(tile, dtype=np.uint32) * 500
    out.append(("one 2^21-row segment, carry over every tile", skp, tile * 500, base))
    for m in (tile - 1, tile, tile + 1):
        out.append((f"segments of {m} rows", overlay_rows(rng, 5, m, p_op=0.1, pos_hi=3000), 2500,
                    dict(base, base_len=3)))
    out.append(("group_depth = depths - 1 > max_depth", overlay_rows(rng, 7, 40_000, p_op=0.05, pos_hi=1 << 20),
                1 << 20, dict(chunk_size=2048, depths=7, base_len=8, max_depth=4, group_depth=6)))
    skp = overlay_rows(rng, 3, 30_000, p_op=0.05, pos_hi=50_000)
    n_in = 47_777
    at = np.array([999, 1000, 1999, 2000, n_in - 1, n_in, 0, 1], np.uint32)
    skp[:, 100 : 100 + at.size] = (1 << 30) | at
    skp[:, 29_000 : 29_000 + at.size] = (1 << 30) | at
    out.append(("chunk 1000", skp, n_in, dict(base, chunk_size=1000)))
    return out


def tokenize_kernel_phase(torch, kernels, stab_kernels, dense_kernels, calls, dev) -> dict:
    """Phase 10: each tokenize kernel against its plain version on the card,
    on the inputs recorded from the main path and on synthetic edge cases;
    times at the main path's first call's shapes."""
    rng = np.random.default_rng(4321)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32)).to(dev)

    def compact_pair(fn, plain, vals, extras):
        got, got_t = fn(vals, extras) if extras is not None else fn(vals)
        torch.cuda.synchronize()  # a fault in the kernel surfaces here
        want, want_t = plain(vals, extras or ())
        t = int(want_t)
        got = got if extras is not None else [got]
        return max_abs_diff([g[:t] for g in got] + [got_t], [w[:t] for w in want] + [want_t])

    synth_compact = []
    for n, keep_p, ne in ((1 << 20, 0.0, 2), (1 << 20, 1.0, 3), ((1 << 20) + 12345, 0.3, 9),
                          (777, 0.5, 1)):
        vals = i32(_u32_mask(n, rng, keep_p, 0x10000))
        vals[: min(n, 64)] = i32(np.arange(0x8000, 0x8000 + min(n, 64), dtype=np.uint32))  # ids >= 0x8000
        extras = [i32(rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)) for _ in range(ne)]
        synth_compact.append((vals, extras))

    err = {k: 0.0 for k in TOKENIZE_KERNELS}
    cases = {k: 0 for k in TOKENIZE_KERNELS}
    for args, _ in calls["compact_valid"][:2]:
        err["compact_valid"] = max(err["compact_valid"], compact_pair(
            kernels.compact_valid, kernels.compact_mask_plain, args[0], None))
        cases["compact_valid"] += 1
    for args, _ in calls["compact_mask"][:2]:
        err["compact_mask"] = max(err["compact_mask"], compact_pair(
            kernels.compact_mask, kernels.compact_mask_plain, args[0], list(args[1])))
        cases["compact_mask"] += 1
    for vals, extras in synth_compact:
        err["compact_valid"] = max(err["compact_valid"], compact_pair(
            kernels.compact_valid, kernels.compact_mask_plain, vals, None))
        err["compact_mask"] = max(err["compact_mask"], compact_pair(
            kernels.compact_mask, kernels.compact_mask_plain, vals, extras))
        cases["compact_valid"] += 1
        cases["compact_mask"] += 1
        mask = vals != -1
        src = extras[0]
        got = kernels.expand_to_mask(mask, src)
        torch.cuda.synchronize()
        err["expand_to_mask"] = max(err["expand_to_mask"],
                                    max_abs_diff([got], [kernels.expand_to_mask_plain(mask, src)]))
        cases["expand_to_mask"] += 1
    # the compaction edge cases with 0, 1, 3 and 9 extras
    tile = kernels.COMPACT_TILE
    g = torch.Generator(device=dev)
    g.manual_seed(78)
    for label, vals in compaction_edge_cases(torch, dev, tile):
        pool = torch.randint(-2**31, 2**31 - 1, (kernels.MAX_EXTRA, vals.numel()), generator=g, device=dev,
                             dtype=torch.int32)
        err["compact_valid"] = max(err["compact_valid"], compact_pair(
            kernels.compact_valid, kernels.compact_mask_plain, vals, None))
        cases["compact_valid"] += 1
        for ne in (0, 1, 3, 9):
            e = compact_pair(kernels.compact_mask, kernels.compact_mask_plain, vals, list(pool[:ne]))
            if e != 0.0:
                raise AssertionError(f"compact_mask disagrees on {label} with {ne} extras: {e}")
            cases["compact_mask"] += 1
        del pool
    for args, _ in calls["expand_to_mask"][:2]:
        got = kernels.expand_to_mask(*args)
        torch.cuda.synchronize()
        err["expand_to_mask"] = max(err["expand_to_mask"],
                                    max_abs_diff([got], [kernels.expand_to_mask_plain(*args)]))
        cases["expand_to_mask"] += 1
    for label, mask, vals in expand_edge_cases(torch, dev, kernels.EXPAND_TILE):
        got = kernels.expand_to_mask(mask, vals)
        torch.cuda.synchronize()
        e = max_abs_diff([got], [kernels.expand_to_mask_plain(mask, vals)])
        if e != 0.0:
            raise AssertionError(f"expand_to_mask disagrees on {label}: {e}")
        cases["expand_to_mask"] += 1
    # overlay: the main path's level-1 stream, its first rank-space level
    # stream, and random sorted streams (any m, ids >= 0x8000, several
    # segments, with and without a group slot)
    overlay_inputs = [calls["overlay_fit"][0]] + [c for c in calls["overlay_fit"][1:] if c[1]["base_len"] > 0][:1]
    for nseg, m, gd in ((3, 70_001, 9), (1, 2_500_000, -1), (40, 4096, 7)):
        kp = np.sort(rng.integers(0, 2**32, size=(nseg, m), dtype=np.uint64).astype(np.uint32), axis=1)
        depths = 10 if gd != 7 else 8
        overlay_inputs.append(((i32(kp), 1_500_000), dict(chunk_size=512, depths=depths, base_len=3,
                                                           max_depth=depths - 2, group_depth=gd)))
    for args, kw in overlay_inputs:
        got = stab_kernels.overlay_fit(*args, **kw)
        torch.cuda.synchronize()
        err["overlay_fit"] = max(err["overlay_fit"],
                                 max_abs_diff(got, stab_kernels.overlay_fit_plain(*args, **kw)))
        cases["overlay_fit"] += 1
    for label, kp, input_len, kw in overlay_edge_cases(rng, stab_kernels.OVERLAY_TILE):
        skp = i32(kp)
        got = stab_kernels.overlay_fit(skp, input_len, **kw)
        torch.cuda.synchronize()
        e = max_abs_diff(got, stab_kernels.overlay_fit_plain(skp, input_len, **kw))
        if e != 0.0:
            raise AssertionError(f"overlay_fit disagrees on {label}: {e}")
        cases["overlay_fit"] += 1
    # dense_match: the main path's calls (the long-token tails of both
    # vocabs, on top of the stab join's result)
    for args, kw in calls["dense_match"]:
        got = dense_kernels.dense_match(*args, **kw)
        torch.cuda.synchronize()
        err["dense_match"] = max(err["dense_match"],
                                 max_abs_diff(got, dense_kernels.dense_match_plain(*args, **kw)))
        cases["dense_match"] += 1
    for k, e in err.items():
        if e != 0.0 or cases[k] == 0:
            raise AssertionError(f"{k} disagrees with its plain version: max_abs_err {e}, cases {cases[k]}")

    # timings at the main path's shapes: the first call of each kernel
    (cv_vals,), _ = calls["compact_valid"][0]
    cv_keep = cv_vals != -1
    cv_total = int(cv_keep.sum())
    (cm_vals, cm_extras), _ = calls["compact_mask"][0]
    cm_extras = list(cm_extras)
    cm_keep = cm_vals != -1
    cm_total = int(cm_keep.sum())
    (ex_mask, ex_vals), _ = calls["expand_to_mask"][0]
    ex_set = int(ex_mask.sum())
    ex_zeros = torch.zeros(ex_mask.shape[0], dtype=torch.int32, device=dev)
    (ov_skp, ov_len), ov_kw = calls["overlay_fit"][0]
    dm_args, dm_kw = calls["dense_match"][0]
    n_cv, n_cm, n_ex, n_dm = cv_vals.numel(), cm_vals.numel(), ex_mask.numel(), dm_args[0].numel()
    timing = {
        "compact_valid": (lambda: kernels.compact_valid(cv_vals),
                          lambda: kernels.compact_mask_plain(cv_vals),
                          lambda: torch.masked_select(cv_vals, cv_keep),
                          4 * n_cv + 4 * cv_total + 8,
                          {"n": n_cv, "total": cv_total}),
        "compact_mask": (lambda: kernels.compact_mask(cm_vals, cm_extras),
                         lambda: kernels.compact_mask_plain(cm_vals, cm_extras),
                         lambda: [torch.masked_select(a, cm_keep) for a in (cm_vals, *cm_extras)],
                         4 * n_cm + 4 * cm_total * (1 + 2 * len(cm_extras)) + 8,
                         {"n": n_cm, "n_extra": len(cm_extras), "total": cm_total}),
        "expand_to_mask": (lambda: kernels.expand_to_mask(ex_mask, ex_vals),
                           lambda: kernels.expand_to_mask_plain(ex_mask, ex_vals),
                           lambda: ex_zeros.masked_scatter(ex_mask, ex_vals),
                           n_ex + 4 * ex_set + 4 * n_ex,
                           {"n": n_ex, "set": ex_set, "vals": ex_vals.numel()}),
        "overlay_fit": (lambda: stab_kernels.overlay_fit(ov_skp, ov_len, **ov_kw),
                        lambda: stab_kernels.overlay_fit_plain(ov_skp, ov_len, **ov_kw),
                        None,
                        16 * ov_skp.numel(),
                        {"shape": list(ov_skp.shape), **ov_kw}),
        "dense_match": (lambda: dense_kernels.dense_match(*dm_args, **dm_kw),
                        lambda: dense_kernels.dense_match_plain(*dm_args, **dm_kw),
                        None,
                        33 * n_dm,
                        {"n": n_dm, "lengths": dm_args[1].lengths, "slots": dm_args[1].slots.shape[0],
                         "incoming": True}),
    }
    # inputs that fit in the L2 can stay there between the back-to-back
    # timed calls; the level-1 stream (77 MB) cannot
    input_bytes = {"compact_valid": 4 * n_cv, "compact_mask": 4 * n_cm * (1 + len(cm_extras)),
                   "expand_to_mask": n_ex + 4 * ex_vals.numel(), "overlay_fit": 4 * ov_skp.numel(),
                   "dense_match": 17 * n_dm}
    rows = {}
    for k, (kern, plain, library, nbytes, shape) in timing.items():
        if library:  # the kernel and the library call in turns
            ms, library_ms = time_in_turns(torch, [kern, library], 20)
        else:
            ms, library_ms = time_ms(torch, kern, 20), None
        plain_ms = time_ms(torch, plain, 3)
        prof = dict(host_ms=host_ms(torch, kern, 50), **device_profile(torch, kern))
        lib_prof = device_profile(torch, library) if library else {}
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows[k] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, library_ms=library_ms,
                       max_abs_err=err[k], **prof)
        emit({"phase": "kernel", "name": k, "cases": cases[k], "max_abs_err": err[k], "tolerance": 0,
              "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **prof,
              "library_device_ms": lib_prof.get("device_ms"), "library_device_ops": lib_prof.get("device_ops"),
              "bytes": nbytes, "bound_ms": bound_ms, "bound_by": "bytes", "shape": shape,
              "input_bytes": input_bytes[k], "inputs_warm_in_l2": input_bytes[k] <= L2_BYTES})
    for k in TOKENIZE_KERNELS:
        if round(rows[k]["device_ops"]) > 2:
            raise AssertionError(f"{k} put {rows[k]['device_op_names']} on the card per call, "
                                 "want at most one memset and one kernel")
    return rows


def recount_timing(torch, ts, padded) -> list:
    """One segmented and one monolithic recount of the no-dedup stream cut
    to capacities 2^20..2^25 (3/4 full, or all of it), timed in turns
    (median of 5, CUDA events): winner, count and theta must agree.
    ``ns_per_elem`` is the time per capacity element of the recount the
    trainer runs at that capacity (below the gate, the monolithic one)."""
    rows = []
    for k in range(20, 26):
        cap = 1 << k
        n = min(padded.n, cap * 3 // 4)
        sym = torch.zeros(cap, dtype=torch.int32, device="cuda")
        w = torch.zeros(cap, dtype=torch.int32, device="cuda")
        sym[:n] = torch.from_numpy(padded.symbols[:n].astype(np.int32)).cuda()
        w[:n] = torch.from_numpy(padded.weights[:n]).cuda()
        pair, valid = ts._pair_ids(sym, n)
        w64 = torch.where(valid, w.to(torch.int64), 0)
        fns = {"monolithic": lambda: ts._recount_monolithic(pair, w64),
               "segmented": lambda: ts._full_recount_segmented(pair, w64, cap)[1]}
        outs = {name: fn() for name, fn in fns.items()}
        picks = {name: (int(o[0]), int(o[1]), int(o[4])) for name, o in outs.items()}
        if len(set(picks.values())) != 1:
            raise AssertionError(f"recounts disagree at capacity 2^{k}: {picks}")
        times = dict(zip(fns, time_in_turns(torch, list(fns.values()), 5)))
        taken = "segmented" if cap >= ts._SEG_RECOUNT_MIN_CAP else "monolithic"
        rows.append({"capacity": cap, "n": n, "winner": picks["monolithic"],
                     **{f"{name}_ms": t for name, t in times.items()},
                     "taken": taken, "ns_per_elem": times[taken] / cap * 1e6})
        del pair, valid, w64, sym, w, outs
    ts.RECOUNTS.clear()
    return rows


def recount_compact_check(torch, kernels, call, dev) -> dict:
    """Phase 10, the recount's call of compact_mask (the first one of the
    no-dedup run): the kernel against its plain version (tolerance 0 on the
    first ``total`` entries and the total), its times and those of three
    ``masked_select`` calls computing the same."""
    (vals, extras), _ = call
    extras = list(extras)
    got, got_t = kernels.compact_mask(vals, extras)
    torch.cuda.synchronize()
    want, want_t = kernels.compact_mask_plain(vals, extras)
    t = int(want_t)
    err = max_abs_diff([g[:t] for g in got] + [got_t], [w[:t] for w in want] + [want_t])
    keep = vals != -1
    n = vals.numel()
    ms, library_ms = time_in_turns(torch, [lambda: kernels.compact_mask(vals, extras),
                                           lambda: [torch.masked_select(a, keep) for a in (vals, *extras)]], 10)
    plain_ms = time_ms(torch, lambda: kernels.compact_mask_plain(vals, extras), 2)
    prof = dict(host_ms=host_ms(torch, lambda: kernels.compact_mask(vals, extras), 20),
                **device_profile(torch, lambda: kernels.compact_mask(vals, extras), reps=5))
    lib_prof = device_profile(torch, lambda: [torch.masked_select(a, keep) for a in (vals, *extras)], reps=5)
    nbytes = 4 * n + 4 * t * (1 + 2 * len(extras)) + 8
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               max_abs_err=err, **prof)
    emit({"phase": "kernel", "name": "compact_mask", "call": "recount", "max_abs_err": err, "tolerance": 0,
          "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **prof,
          "library_device_ms": lib_prof["device_ms"], "library_device_ops": lib_prof["device_ops"],
          "bytes": nbytes, "bound_ms": row["bound_ms"], "bound_by": "bytes",
          "shape": {"n": n, "n_extra": len(extras), "total": t}})
    if err != 0.0:
        raise AssertionError(f"compact_mask disagrees with its plain version at the recount's call: {err}")
    if round(prof["device_ops"]) > 2:
        raise AssertionError(f"compact_mask put {prof['device_op_names']} on the card per call at the recount")
    return row


def cut_ids(ids, vocab, lo: int, hi: int):
    """The ids of the bytes [lo, hi) of their input (both ends on token
    ends, as chunk-aligned ends are)."""
    lens = np.array([len(v) for v in vocab], np.int64)[ids]
    ends = np.cumsum(lens)
    a, b = np.searchsorted(ends, [lo, hi], side="right")
    if (a and ends[a - 1] != lo) or ends[b - 1] != hi:
        raise AssertionError(f"[{lo}, {hi}) does not start and end on token ends")
    return ids[a:b]


def encode_path_cases(corpus: bytes, vocab8k, vocab64k) -> list:
    """(label, vocab, data, cut) of the three tokenize paths that the main
    runs do not reach: multi-pass slicing (input over 2^24 bytes with the
    stab vocab; the cut straddles the pass boundary), the gather walk (a
    vocab with 80-byte tokens) and the rank chain's full-width fallback (a
    vocab of 20,000 tokens of 17-20 bytes over {a, b}: every position holds
    a prefix group, more than the n/8 rank capacity)."""
    rng = np.random.default_rng(55)
    long_lines = sorted({corpus[81 * i : 81 * i + 80] for i in range(0, 4000, 7)})
    ab = np.frombuffer(b"ab", np.uint8)
    ab_toks = sorted({bytes(ab[rng.integers(0, 2, size=int(rng.integers(17, 21)))]) for _ in range(20_000)})
    big = 1 << 24
    return [
        ("multi_pass", vocab64k, corpus + corpus[: 1 << 20], (big - (1 << 18), big + (1 << 18))),
        ("gather_walk", vocab8k + long_lines, corpus[: 4 << 20], (0, 1 << 19)),
        ("rank_full_width", [bytes([b]) for b in range(256)] + ab_toks,
         bytes(ab[rng.integers(0, 2, size=2 << 20)]), (0, 1 << 18)),
    ]


def api_phases(torch, corpus: bytes, vocabs: dict, launches: dict, rows: dict) -> dict:
    """Phases 11-13: the public API on the card. Adds each run's kernel
    launches to ``launches`` and the recount's compact_mask check to
    ``rows``; returns phase 11's training result, tokenizer and stream n,
    phase 12's training result and phase 13's ids."""
    from gpu_bpe_tpu_torch import BPETokenizer, PreTokenizer, Tokenizer, Trainer, api
    from gpu_bpe_tpu_torch.core import BPEModel, GreedyTrieEncoder, read_dxft
    from gpu_bpe_tpu_torch.ops import kernels
    from gpu_bpe_tpu_torch.ops import tokenize as ttz
    from gpu_bpe_tpu_torch.ops import train_step as ts
    from gpu_bpe_tpu_torch.ops.ingest import make_stream, pad_stream
    from gpu_bpe_tpu_torch.unicode import backend_name

    # ── phase 11: api.train with the Unicode pre-tokenizer and dedup ──
    backend = backend_name()  # builds the native decoder, outside the clock
    t0 = time.perf_counter()
    data, starts = PreTokenizer().pre_tokenize_bytes(corpus)
    pretok_s = time.perf_counter() - t0
    u_stream = make_stream(data, starts)
    kernels.LAUNCHES.clear()
    tok11, res11 = api.train(corpus, api.TrainConfig(vocab_size=256 + API_MERGES, show_progress=False))
    torch.cuda.synchronize()
    run_launches = {k: kernels.LAUNCHES[k] for k in TRAIN_KERNELS}
    record = json.loads((REPO / CERT16).read_text())["normal"]
    got = sha_pair(res11)
    small = corpus[:SMALL_BYTES]
    cut = {label: api.train(small, api.TrainConfig(vocab_size=256 + SMALL_MERGES, show_progress=False, **kw))
           for label, kw in (("cuda", {}), ("cpu", {"device": "cpu"}), ("reference", {"backend": "cpu"}))}
    cut_equal = all(r.merges == cut["cuda"][1].merges and r.merge_counts == cut["cuda"][1].merge_counts
                    for _, r in cut.values())
    emit({"phase": "api_train", "bytes": len(corpus), "merges": len(res11.merges),
          "pretokenize_s": pretok_s, "pretokenize_mb_per_s": len(corpus) / pretok_s / 1e6,
          "unicode_backend": backend, "stream_n": u_stream.n,
          "capacity": int(pad_stream(u_stream).symbols.shape[0]), "seconds": res11.training_time_s,
          "merges_per_s": len(res11.merges) / res11.training_time_s, "recounts": res11.recounts,
          "launches": run_launches, **got, "record": CERT16, "equal_to_record": got == {k: record[k] for k in got},
          "cut_bytes": len(small), "cut_merges": len(cut["cuda"][1].merges), "cut_cuda_eq_cpu_eq_reference": cut_equal})
    if backend != "cpp-decoder":
        raise AssertionError(f"the pre-tokenizer runs on the {backend} backend, want cpp-decoder")
    if got != {k: record[k] for k in got}:
        raise AssertionError(f"api.train's merge list hashes {got}, the JAX package recorded {record}")
    if not cut_equal or len(cut["cuda"][1].merges) != SMALL_MERGES or min(run_launches.values()) <= 0:
        raise AssertionError("api.train: the 1 MB cut differs between card, CPU path and reference, "
                             f"or a training kernel never launched: {run_launches}")
    for k in TRAIN_KERNELS:
        launches[k] += run_launches[k]

    # ── phase 12: api.train without pre-tokenization (no dedup, capacity 2^25) ──
    nd = pad_stream(api._byte_stream(corpus))
    ts.RECOUNTS.clear()
    kernels.LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    with recorded_calls(ts, ("compact_mask",), keep=1) as rc_calls:
        _, res12 = api.train(corpus, api.TrainConfig(vocab_size=256 + NODEDUP_MERGES, pre_tokenize=False,
                                                     show_progress=False))
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    run_launches = {k: kernels.LAUNCHES[k] for k in (*TRAIN_KERNELS, "compact_mask")}
    tiers = dict(ts.RECOUNTS)
    truth, _ = train(torch, Trainer, api._byte_stream(corpus), NODEDUP_FORCE, "cuda", force_recount=True)
    same = truth.merges == res12.merges[:NODEDUP_FORCE] and truth.merge_counts == res12.merge_counts[:NODEDUP_FORCE]
    emit({"phase": "api_train_nodedup", "bytes": len(corpus), "stream_n": nd.n,
          "capacity": int(nd.symbols.shape[0]), "merges": len(res12.merges), "seconds": res12.training_time_s,
          "merges_per_s": len(res12.merges) / res12.training_time_s, "recounts": res12.recounts,
          "recounts_by_tier": tiers, "launches": run_launches, "peak_allocated_bytes": peak,
          "force_recount_merges": len(truth.merges), "force_recount_equal": same})
    # its last row is the phase's first recount: the whole stream at 2^25
    emit({"phase": "recount_timing", "seg_recount_min_cap": ts._SEG_RECOUNT_MIN_CAP,
          "rows": recount_timing(torch, ts, nd)})
    if nd.symbols.shape[0] != 1 << 25 or not any(k.startswith("seg") for k in tiers):
        raise AssertionError(f"the segmented recount did not engage at capacity {nd.symbols.shape[0]}: {tiers}")
    if min(run_launches.values()) <= 0 or not same:
        raise AssertionError(f"no-dedup training: launches {run_launches}, force_recount equal {same}")
    for k, v in run_launches.items():
        launches[k] += v
    rows["compact_mask"]["max_abs_err"] = max(
        rows["compact_mask"]["max_abs_err"],
        recount_compact_check(torch, kernels, rc_calls["compact_mask"][0], torch.device("cuda"))["max_abs_err"])
    del rc_calls, nd

    # ── phase 13: BPETokenizer / api.encode_bulk and the artifacts ──
    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    ids13 = api.encode_bulk(tok11, corpus)
    bulk_s = time.perf_counter() - t0
    run_launches = {k: kernels.LAUNCHES[k] for k in TOKENIZE_KERNELS}
    direct = Tokenizer(tok11.model.vocab).encode_bytes(corpus)
    toks, model, head = read_dxft(api.export_bin(tok11, corpus))
    on_cpu = BPETokenizer(tok11.model, backend="cpu")
    cpu_model = cut["cpu"][0].model
    with tempfile.TemporaryDirectory() as tmp:
        tok11.save(f"{tmp}/m.json")
        loaded = api.load_model(f"{tmp}/m.json")
        saved = open(f"{tmp}/m.json", "rb").read()
        cut["cpu"][0].save(f"{tmp}/c.json")
        saved_cut = (open(f"{tmp}/c.json", "rb").read(), cut["cpu"][0].compile_trie())
    checks = {
        "ids_eq_tokenizer": np.array_equal(ids13, direct),
        "dxft_roundtrip": np.array_equal(toks, ids13) and model.to_json() == tok11.model.to_json()
        and head["tokenCount"] == len(ids13),
        "trie_eq_cpu_path": tok11.compile_trie() == on_cpu.compile_trie() == loaded.compile_trie(),
        "save_load_eq": saved == tok11.model.to_json().encode() and loaded.model.merges == tok11.model.merges,
        "cut_model_and_trie_eq_cpu_path": (cut["cuda"][0].model.to_json().encode(), cut["cuda"][0].compile_trie())
        == saved_cut and cpu_model.merges == cut["cuda"][0].model.merges,
        "decode_roundtrip": api.decode(tok11, ids13).encode() == corpus,
    }
    emit({"phase": "api_encode", "bytes": len(corpus), "tokens": len(ids13), "first_call_seconds": bulk_s,
          "launches": run_launches, **checks})
    if not all(checks.values()) or run_launches["compact_valid"] <= 0:
        raise AssertionError(f"api_encode checks failed: {checks}, launches {run_launches}")
    for k, v in run_launches.items():
        launches[k] += v

    # ── phase 13, the tokenize paths no other run reaches ──
    for label, vocab, data, (lo, hi) in encode_path_cases(corpus, tok11.model.vocab, vocabs["65536-synth"]):
        tok = BPETokenizer(BPEModel(vocab=vocab, merges=[]))
        kernels.LAUNCHES.clear()
        ids = api.encode_bulk(tok, data)
        torch.cuda.synchronize()
        run_launches = {k: kernels.LAUNCHES[k] for k in TOKENIZE_KERNELS}
        t = Tokenizer(vocab)
        lo, hi = lo - lo % t.chunk_size, hi - hi % t.chunk_size  # the cut's ends on chunk ends
        part = cut_ids(ids, vocab, lo, hi)
        on_cpu = Tokenizer(vocab, device="cpu").encode_bytes(data[lo:hi])
        ref = GreedyTrieEncoder(vocab, chunk_size=t.chunk_size).encode(data[lo:hi])
        engaged = {"multi_pass": len(data) > t.max_pass_bytes,
                   "gather_walk": t.tables.max_token_len > ttz._MAX_WALK_STEP,
                   "rank_full_width": run_launches["compact_mask"] > 0 and run_launches["expand_to_mask"] == 0}
        row = {"phase": "api_encode_path", "path": label, "bytes": len(data), "tokens": len(ids),
               "passes": -(-len(data) // t.max_pass_bytes), "max_token_len": t.tables.max_token_len,
               "launches": run_launches, "engaged": engaged[label], "cut": [lo, hi],
               "cuda_eq_cpu": np.array_equal(part, on_cpu), "cuda_eq_greedy": np.array_equal(part, ref),
               "decode_roundtrip": tok.decode(ids) == data}
        emit(row)
        if not (row["engaged"] and row["cuda_eq_cpu"] and row["cuda_eq_greedy"] and row["decode_roundtrip"]):
            raise AssertionError(f"tokenize path {label} failed: {row}")
        for k, v in run_launches.items():
            launches[k] += v
    return {"train": res11, "tokenizer": tok11, "nodedup": res12, "ids": ids13, "stream_n": u_stream.n}


def dist_phases(torch, corpus: bytes, stream, main_merges, launches: dict) -> None:
    """Phases 14-15: the data-parallel trainer on the card. Adds the probe-less
    merge's launches of both runs (every rank's) to ``launches``."""
    import socket

    from gpu_bpe_tpu_torch import api
    from gpu_bpe_tpu_torch.ops import kernels
    from gpu_bpe_tpu_torch.parallel import dist_train
    from gpu_bpe_tpu_torch.parallel.mesh import COLLECTIVES

    # ── phase 14: api.train(backend="dist"), one rank, NCCL ──
    kernels.LAUNCHES.clear()
    dist_train.HOST_READS.clear()
    COLLECTIVES.clear()
    events = []
    _, res = api.train(corpus, api.TrainConfig(vocab_size=256 + API_MERGES, backend="dist", show_progress=False),
                       on_progress=events.append)
    torch.cuda.synchronize()
    coll = {k: v for k, v in COLLECTIVES.items() if k != "bytes"}
    run_launches = {k: kernels.LAUNCHES[k] for k in (PROBE_LESS, *TRAIN_KERNELS)}
    record = json.loads((REPO / CERT16).read_text())["normal"]
    got = sha_pair(res)
    n_merges = len(res.merges)
    reads = dict(dist_train.HOST_READS)
    emit({"phase": "dist_train", "ranks": 1, "backend": "nccl", "bytes": len(corpus), "merges": n_merges,
          "seconds": res.training_time_s, "merges_per_s": n_merges / res.training_time_s,
          "recounts": res.recounts, "duals": res.duals, "collectives": coll,
          "collective_bytes": COLLECTIVES["bytes"],
          "collectives_per_merge": sum(coll.values()) / n_merges, "host_reads": reads,
          "host_reads_per_merge": sum(reads.values()) / n_merges, "launches": run_launches, **got,
          "record": CERT16, "equal_to_record": got == {k: record[k] for k in got}})
    if got != {k: record[k] for k in got}:
        raise AssertionError(f"api.train(backend='dist')'s merge list hashes {got}, the JAX package recorded {record}")
    if run_launches[PROBE_LESS] <= 0 or any(run_launches[k] for k in TRAIN_KERNELS):
        raise AssertionError(f"the dist path must run the probe-less merge and only it: {run_launches}")
    launches[PROBE_LESS] += run_launches[PROBE_LESS]

    # ── phase 15: two ranks on the one card over gloo ──
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(f"{tmp}/stream.npz", symbols=stream.symbols[: stream.n], weights=stream.weights[: stream.n],
                 total=stream.total_bytes)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            addr = f"127.0.0.1:{sock.getsockname()[1]}"
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dist-worker", addr, str(r), tmp],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(DIST_RANKS)]
        try:
            done = [p.communicate(timeout=DIST_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                p.kill()
        for r, (p, (_, err)) in enumerate(zip(procs, done)):
            if p.returncode != 0:
                raise AssertionError(f"dist rank {r} exited with {p.returncode}:\n{err[-4000:]}")
        ranks = [json.loads(Path(f"{tmp}/rank{r}.json").read_text()) for r in range(DIST_RANKS)]
    equal = [[tuple(m) for m in rk["merges"]] == main_merges for rk in ranks]
    first = ranks[0]
    emit({"phase": "dist_train_2rank", "ranks": DIST_RANKS, "device": "cuda:0", "backend": "gloo",
          "transport": first["transport"], "shard_n": first["shard_n"], "capacity": first["capacity"],
          "merges": len(first["merges"]), "seconds": first["seconds"],
          "merges_per_s": len(first["merges"]) / first["seconds"], "recounts": first["recounts"],
          "duals": first["duals"], "collectives_per_merge": first["collectives"] / len(first["merges"]),
          "launches": [rk["launches"] for rk in ranks], "equal_to_main_path": equal})
    if not all(equal) or any(rk["launches"] <= 0 for rk in ranks):
        raise AssertionError(f"two ranks: merge lists equal to phase 4 {equal}, launches "
                             f"{[rk['launches'] for rk in ranks]}")
    launches[PROBE_LESS] += sum(rk["launches"] for rk in ranks)


def dist_worker(addr: str, rank: int, tmp: str) -> int:
    """One rank of phase 15: joins a gloo group of DIST_RANKS processes on
    cuda:0, trains phase 4's stream for MERGES merges and writes its result
    to ``tmp``. The collectives hand gloo the CUDA tensors as they are; a
    gloo that refused them would fail the phase."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from gpu_bpe_tpu_torch.ops import kernels
    from gpu_bpe_tpu_torch.ops.ingest import SymbolStream
    from gpu_bpe_tpu_torch.parallel import DataGroup, DistributedTrainer
    from gpu_bpe_tpu_torch.parallel.mesh import COLLECTIVES

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://{addr}", world_size=DIST_RANKS, rank=rank,
                            timeout=timedelta(seconds=DIST_TIMEOUT_S))
    try:
        group = DataGroup.current("cuda:0")
        z = np.load(f"{tmp}/stream.npz")
        stream = SymbolStream(symbols=z["symbols"], weights=z["weights"], n=len(z["symbols"]),
                              total_bytes=int(z["total"]))
        kernels.LAUNCHES.clear()
        COLLECTIVES.clear()
        res = DistributedTrainer(group).train_stream(stream, target_vocab_size=256 + MERGES)
        torch.cuda.synchronize()
        from gpu_bpe_tpu_torch.parallel import shard_stream

        sym, _, n = shard_stream(stream.symbols, stream.weights, DIST_RANKS)
        out = {"merges": res.merges, "counts": res.merge_counts, "seconds": res.training_time_s,
               "recounts": res.recounts, "duals": res.duals, "transport": "gloo-cuda", "shard_n": n.tolist(),
               "capacity": int(sym.shape[1]),
               "collectives": sum(v for k, v in COLLECTIVES.items() if k != "bytes"),
               "launches": kernels.LAUNCHES[PROBE_LESS]}
        Path(f"{tmp}/rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


# ───────────────────── streamed training, checkpoint, CLI, selftest ─────────────────────


def files_phase(torch, corpus64: bytes, launches: dict) -> None:
    """Phase 16: ``api.train_files`` on the 64 MB corpus in 4 MB chunks (the
    certificate run), then on its first 16 MB through ``backend="dist"`` in
    a one-rank NCCL group. Adds both runs' kernel launches to ``launches``."""
    import resource

    from gpu_bpe_tpu_torch import api
    from gpu_bpe_tpu_torch.ops import kernels, native
    from gpu_bpe_tpu_torch.ops.ingest import make_stream, make_stream_chunked, stream_paths
    from gpu_bpe_tpu_torch.pretok import PreTokenizer

    with tempfile.TemporaryDirectory() as tmp:
        big, part = Path(tmp, "corpus64.txt"), Path(tmp, "corpus16.txt")
        big.write_bytes(corpus64)
        part.write_bytes(corpus64[:CORPUS_BYTES])
        nat = native.native_available()
        t0 = time.perf_counter()
        chunked = make_stream_chunked(stream_paths([str(big)], FILES_CHUNK))
        ingest_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mono = make_stream(*PreTokenizer().pre_tokenize_bytes(corpus64))
        mono_s = time.perf_counter() - t0
        same_stream = (chunked.n == mono.n and chunked.total_bytes == mono.total_bytes
                       and np.array_equal(chunked.symbols, mono.symbols) and np.array_equal(chunked.weights, mono.weights))
        del mono
        kernels.LAUNCHES.clear()
        t0 = time.perf_counter()
        _, res = api.train_files([str(big)], api.TrainConfig(vocab_size=256 + FILES_MERGES, show_progress=False),
                                 chunk_bytes=FILES_CHUNK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = {k: kernels.LAUNCHES[k] for k in TRAIN_KERNELS}
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        got, record = sha_pair(res), json.loads((REPO / CERT64).read_text())["normal"]
        row = {"phase": "train_files", "bytes": len(corpus64), "chunk_bytes": FILES_CHUNK,
               "chunks": -(-len(corpus64) // FILES_CHUNK), "native_ingest": nat, "stream_n": chunked.n,
               "ingest_s": ingest_s, "monolithic_ingest_s": mono_s, "chunked_eq_monolithic": same_stream,
               "wall_s": wall, "training_s": res.training_time_s,
               "merges_per_s": len(res.merges) / res.training_time_s, "recounts": res.recounts,
               "peak_rss_bytes_process": rss, "launches": run, **got, "record": CERT64,
               "equal_to_record": got == {k: record[k] for k in got}}
        emit(row)
        if not (nat and same_stream and row["equal_to_record"]) or min(run.values()) <= 0:
            raise AssertionError(f"train_files: native {nat}, chunked == monolithic {same_stream}, hashes {got} "
                                 f"(record {record}), launches {run}")
        for k, v in run.items():
            launches[k] += v

        kernels.LAUNCHES.clear()
        _, dres = api.train_files([str(part)], api.TrainConfig(vocab_size=256 + API_MERGES, backend="dist",
                                                                show_progress=False), chunk_bytes=FILES_CHUNK)
        torch.cuda.synchronize()
    dist_launches = kernels.LAUNCHES[PROBE_LESS]
    got, record = sha_pair(dres), json.loads((REPO / CERT16).read_text())["normal"]
    emit({"phase": "train_files_dist", "ranks": 1, "backend": "nccl", "bytes": CORPUS_BYTES,
          "merges": len(dres.merges), "training_s": dres.training_time_s,
          "merges_per_s": len(dres.merges) / dres.training_time_s, "launches": dist_launches, **got,
          "record": CERT16, "equal_to_record": got == {k: record[k] for k in got}})
    if got != {k: record[k] for k in got} or dist_launches <= 0:
        raise AssertionError(f"train_files(backend='dist') hashes {got}, the record {record}; "
                             f"launches {dist_launches}")
    launches[PROBE_LESS] += dist_launches


def checkpoint_phase(torch, stream, main_res, s_stream, s_merges, launches: dict, dev="cuda") -> None:
    """Phase 17: phase 4's stream trained to CKPT_MERGES merges with a
    checkpoint after every 128-merge batch, the checkpoint replayed alone
    (timed, probe-less launches counted), then resumed to phase 4's
    MERGES merges; and phase 6's 1 MB cut replayed on ``dev`` and on the
    CPU."""
    from gpu_bpe_tpu_torch import Trainer
    from gpu_bpe_tpu_torch.ops import checkpoint as ck
    from gpu_bpe_tpu_torch.ops import kernels

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/ckpt.json"
        kernels.LAUNCHES.clear()
        first = Trainer(batch_merges=CKPT_BATCH, device=dev).train_stream(
            stream, 256 + CKPT_MERGES, checkpoint_path=path, checkpoint_every=1)
        torch.cuda.synchronize()
        run = Counter({k: kernels.LAUNCHES[k] for k in TRAIN_KERNELS})
        written = ck.TrainingCheckpoint.load(path)
        kernels.LAUNCHES.clear()
        t0 = time.perf_counter()
        state, _ = ck.resume_stream(stream, written, device=dev)
        n_replayed = int(state.n)  # the replay's one host read
        replay_s = time.perf_counter() - t0
        replay_launches = kernels.LAUNCHES[PROBE_LESS]
        del state
        kernels.LAUNCHES.clear()
        resumed = Trainer(batch_merges=CKPT_BATCH, device=dev).train_stream(
            stream, 256 + MERGES, checkpoint_path=path, checkpoint_every=1)
        torch.cuda.synchronize()
        resume_launches = {k: kernels.LAUNCHES[k] for k in (PROBE_LESS, *TRAIN_KERNELS)}
        final = ck.TrainingCheckpoint.load(path)
    run.update({k: resume_launches[k] for k in TRAIN_KERNELS})
    g = ck.replay_merges(s_stream, s_merges, device=dev)
    c = ck.replay_merges(s_stream, s_merges, device="cpu")
    cut_equal = (int(g.n) == int(c.n) and torch.equal(g.symbols.cpu(), c.symbols)
                 and torch.equal(g.weights.cpu(), c.weights))
    checks = {
        "first_eq_main_path": first.merges == main_res.merges[:CKPT_MERGES],
        "checkpoint_eq_first": written.merges == first.merges and written.merge_counts == first.merge_counts,
        "resumed_eq_main_path": resumed.merges == main_res.merges and resumed.merge_counts == main_res.merge_counts,
        "final_checkpoint_eq_resumed": final.merges == resumed.merges,
        "replay_launches_eq_merges": replay_launches == resume_launches[PROBE_LESS] == CKPT_MERGES,
        "cut_replay_card_eq_cpu": cut_equal,
    }
    emit({"phase": "checkpoint", "batch_merges": CKPT_BATCH, "checkpoint_merges": len(written.merges),
          "resumed_merges": len(resumed.merges), "replay_s": replay_s, "replay_n": n_replayed,
          "replay_launches": replay_launches, "resume_launches": resume_launches,
          "resume_training_s": resumed.training_time_s, "cut_merges": len(s_merges), **checks})
    if not all(checks.values()):
        raise AssertionError(f"checkpoint checks failed: {checks}")
    for k, v in run.items():
        launches[k] += v
    launches[PROBE_LESS] += replay_launches + resume_launches[PROBE_LESS]


def cli_phase(torch, small: bytes) -> None:
    """Phase 18: subprocesses of ``python -m gpu_bpe_tpu_torch.cli`` on the
    1 MB cut written to a file, those that do not depend on each other
    started together; their artifacts against ``api``'s on the card."""
    from gpu_bpe_tpu_torch import api
    from gpu_bpe_tpu_torch.core import BPEModel

    def run(*cmds):
        procs = [subprocess.Popen([sys.executable, "-m", "gpu_bpe_tpu_torch.cli", *map(str, c)], cwd=REPO,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for c in cmds]
        try:
            outs = [p.communicate(timeout=CLI_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                p.kill()
        for c, p, (_, err) in zip(cmds, procs, outs):
            if p.returncode != 0:
                raise AssertionError(f"cli {c[0]} exited with {p.returncode}:\n{err[-4000:]}")
        return [out for out, _ in outs]

    tok, _ = api.train(small, api.TrainConfig(vocab_size=256 + SMALL_MERGES, show_progress=False))
    text = small[:300].decode("utf-8", errors="ignore")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        f = {k: Path(tmp, k) for k in ("cut.txt", "model.json", "stream.json", "tokens.bin", "model.trie",
                                       "none.json", "byte-level.json")}
        f["cut.txt"].write_bytes(small)
        vocab_arg = ["--vocab-size", 256 + SMALL_MERGES]
        run(["train", f["cut.txt"], "-o", f["model.json"], *vocab_arg],
            ["train", f["cut.txt"], "-o", f["stream.json"], *vocab_arg, "--stream"])
        m = f["model.json"]
        enc, _, _, _, _, vocab_text, _ = run(
            ["encode", m, text], ["export-bin", m, f["cut.txt"], "-o", f["tokens.bin"]],
            ["export-trie", m, "-o", f["model.trie"]], ["export-hf", m, "-o", f["none.json"]],
            ["export-hf", m, "-o", f["byte-level.json"], "--pretok", "byte-level"], ["vocab", m],
            ["warmup", "--min-log2", 11, "--max-log2", 13])
        dec, inspect = run(["decode", m, *enc.split()], ["inspect", f["tokens.bin"]])
        model_bytes = tok.model.to_json().encode()
        hf = {p: BPEModel.from_json(f[f"{p}.json"].read_text(encoding="utf-8")) for p in ("none", "byte-level")}
        checks = {
            "train_eq_api": f["model.json"].read_bytes() == model_bytes,
            "train_stream_eq_api": f["stream.json"].read_bytes() == model_bytes,
            "encode_decode_roundtrip": dec == text + "\n" and len(enc.split()) > 0,
            "export_bin_eq_api": f["tokens.bin"].read_bytes() == api.export_bin(tok, small),
            "export_trie_eq_api": f["model.trie"].read_bytes() == api.export_trie(tok),
            "export_hf_loads_back": all(h.vocab == tok.model.vocab and h.merges == tok.model.merges
                                        for h in hf.values()),
            "vocab_eq_api": vocab_text == tok.export_vocab_text(),
            "inspect_runs": inspect.startswith("DXFT v2: vocabSize="),
        }
    emit({"phase": "cli", "bytes": len(small), "merges": SMALL_MERGES, "subprocesses": 11,
          "seconds": time.perf_counter() - t0, **checks})
    if not all(checks.values()):
        raise AssertionError(f"cli checks failed: {checks}")


def selftest_phase(torch, launches: dict) -> None:
    """Phase 19: ``run_kernel_selftest()`` on the card; adds its launches."""
    from gpu_bpe_tpu_torch.ops import kernels
    from gpu_bpe_tpu_torch.ops.selftest import run_kernel_selftest

    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    results = run_kernel_selftest()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    run = {k: kernels.LAUNCHES[k] for k in KERNELS}
    emit({"phase": "selftest", "seconds": secs, "cases": results, "launches": run})
    if not all(results.values()) or run[EXPLICIT_PROBES] <= 0:
        raise AssertionError(f"kernel selftest failed: {results}, launches {run}")
    for k, v in run.items():
        launches[k] = launches.get(k, 0) + v


def explicit_probe_row(torch, kernels, real, dev) -> dict:
    """Phase 19, the explicit-probe mode on phase 3's real first merge: the
    window's affected pairs as the caller's list, bitwise against its plain
    version and against the window-mode call; its times in turns with the
    window-mode call."""
    _, sym, w, n, pair, new_id, cand, counts = real
    args = (torch.from_numpy(sym.astype(np.int32)).to(dev), torch.from_numpy(w).to(dev), torch.tensor(n, device=dev),
            torch.tensor(pair, device=dev), torch.tensor(new_id, device=dev))
    window = (torch.from_numpy(cand).to(dev), torch.from_numpy(counts).to(dev))
    a, b = pair >> 16, pair & 0xFFFF
    aff = [int(c) for c, k in zip(cand, counts) if k >= 0 and ((c & 0xFFFF) == a or (c >> 16) == b) and c != pair]
    words = np.ones(kernels.N_PROBES, np.int64)
    count = min(len(aff), kernels.N_PROBES)
    words[:count] = aff[:count]
    probes = (torch.from_numpy(words).to(dev), torch.tensor(count, device=dev))
    got = kernels.merge_compact_tracked(*args, probes=probes)
    torch.cuda.synchronize()  # a fault in the kernel surfaces here
    err = max_abs_diff(got, kernels.merge_compact_tracked_plain(*args, probes=probes))
    win = kernels.merge_compact_tracked(*args, *window)
    eq_window = len(aff) <= kernels.N_PROBES and max_abs_diff(got, win[:7]) == 0.0
    kern = lambda: kernels.merge_compact_tracked(*args, probes=probes)  # noqa: E731
    ms, window_ms = time_in_turns(torch, [kern, lambda: kernels.merge_compact_tracked(*args, *window)], 20)
    plain_ms = time_ms(torch, lambda: kernels.merge_compact_tracked_plain(*args, probes=probes), 3)
    prof = dict(host_ms=host_ms(torch, kern), **device_profile(torch, kern))
    cap = sym.shape[0]
    # stream in, stream and tail out, the list and count, bins, samp, pcnt, n'
    nbytes = 8 * n + 8 * cap + 8 * kernels.N_PROBES + 8 + 2 * 256 * 4 + 4 * 8 + 8 * kernels.N_PROBES + 8
    row = dict(ms=ms, plain_ms=plain_ms, bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, max_abs_err=err,
               window_mode_ms=window_ms, **prof)
    emit({"phase": "kernel", "name": EXPLICIT_PROBES, "max_abs_err": err, "tolerance": 0, "ms": ms,
          "window_mode_ms": window_ms, "plain_ms": plain_ms, **prof, "bytes": nbytes, "bound_ms": row["bound_ms"],
          "bound_by": "bytes", "shape": {"capacity": cap, "n": n, "probes": count, "affected": len(aff)},
          "equal_to_window_mode": eq_window})
    if err != 0.0 or not eq_window:
        raise AssertionError(f"the explicit-probe merge disagrees with its plain version ({err}) or with the "
                             f"window-mode call ({eq_window})")
    if round(prof["device_ops"]) > 2:
        raise AssertionError(f"the explicit-probe merge put {prof['device_op_names']} on the card per call, "
                             "want at most two kernels")
    return row


# ───────────────────────────── the Unicode library ─────────────────────────────


def unicode_phase(torch, smi: str, launches: dict) -> None:
    """Phase 20: (a) the native Unicode library built on this host, every
    bound export held against the port's Python backend
    (``unicode.selftest``); (b) the reference-compat Hangul mode through
    ``api.train`` on the card, at phase 11's recipe on the decomposed-jamo
    corpus, in both modes: each full list hashes to the JAX package's
    record, each 1 MB cut equals the CPU oracle, and the modes differ."""
    import importlib.util

    from gpu_bpe_tpu_torch import api
    from gpu_bpe_tpu_torch.ops import kernels
    from gpu_bpe_tpu_torch.pretok import PreTokenizer
    from gpu_bpe_tpu_torch.unicode import backend_name, get_backend
    from gpu_bpe_tpu_torch.unicode.selftest import run_unicode_selftest

    backend = backend_name()
    t0 = time.perf_counter()
    held = run_unicode_selftest(get_backend())
    failed = [n for n, ok in held.items() if not ok]
    emit({"phase": "unicode_exports", "unicode_backend": backend,
          "regex_present": importlib.util.find_spec("regex") is not None, "exports": len(held),
          "failed": failed, "seconds": time.perf_counter() - t0})
    if backend != "cpp-decoder" or failed or len(held) != UNICODE_EXPORTS:
        raise AssertionError(f"unicode library on the {backend} backend: {len(held)} exports, failed {failed}")

    corpus = synth_hangul_corpus(CORPUS_BYTES, seed=0)
    cut = corpus[: corpus.rfind(b"\n", 0, SMALL_BYTES) + 1]
    record = json.loads((REPO / REF_HANGUL).read_text())
    if record["corpus_bytes"] != len(corpus) or record["merges"] != API_MERGES:
        raise AssertionError(f"the decomposed-jamo corpus has {len(corpus)} bytes, the record {record['corpus_bytes']}")
    lists = {}
    b = get_backend()
    was = b.ref_hangul
    try:
        for label, on in (("default", False), ("ref_hangul", True)):
            b.set_ref_hangul(on)
            t0 = time.perf_counter()
            data, _ = PreTokenizer().pre_tokenize_bytes(corpus)
            pretok_s = time.perf_counter() - t0
            kernels.LAUNCHES.clear()
            _, res = api.train(corpus, api.TrainConfig(vocab_size=256 + API_MERGES, show_progress=False))
            torch.cuda.synchronize()
            run = {k: kernels.LAUNCHES[k] for k in TRAIN_KERNELS}
            got = sha_pair(res)
            want = {k: record[label][k] for k in got}
            cut_config = api.TrainConfig(vocab_size=256 + SMALL_MERGES, show_progress=False)
            cut_tok, cut_res = api.train(cut, cut_config)
            on_cut = {"cuda": cut_res, "reference": api.train(cut, api.TrainConfig(
                vocab_size=256 + SMALL_MERGES, show_progress=False, backend="cpu"))[1]}
            with tempfile.TemporaryDirectory() as tmp:
                # the streamed entry point in-process, and the CLI in a process
                # of its own that takes the mode from the environment
                path, model = Path(tmp, "cut.txt"), Path(tmp, "model.json")
                path.write_bytes(cut)
                on_cut["train_files"] = api.train_files([str(path)], cut_config, chunk_bytes=1 << 18)[1]
                env = {**os.environ, "GPU_BPE_TPU_REF_HANGUL": "1"} if on else {
                    k: v for k, v in os.environ.items() if k != "GPU_BPE_TPU_REF_HANGUL"}
                argv = ["train", str(path), "-o", str(model), "--vocab-size", str(256 + SMALL_MERGES)]
                cli = subprocess.run([sys.executable, "-m", "gpu_bpe_tpu_torch.cli", *argv], cwd=REPO, env=env,
                                     capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
                cli_equal = cli.returncode == 0 and model.read_bytes() == cut_tok.model.to_json().encode()
            cut_equal = all(r.merges == cut_res.merges and r.merge_counts == cut_res.merge_counts
                            for r in on_cut.values()) and cli_equal
            emit({"phase": "unicode_ref_hangul", "mode": label, "ref_hangul": b.ref_hangul, "bytes": len(corpus),
                  "normalized_bytes": len(data), "jamo_byte_share": record["jamo_byte_share"],
                  "pretokenize_s": pretok_s, "pretokenize_mb_per_s": len(corpus) / pretok_s / 1e6,
                  "merges": len(res.merges), "seconds": res.training_time_s,
                  "merges_per_s": len(res.merges) / res.training_time_s, "recounts": res.recounts,
                  "first_merges": [list(m) for m in res.merges[:4]], "launches": run, **got, "record": REF_HANGUL,
                  "equal_to_record": got == want, "cut_bytes": len(cut), "cut_merges": len(cut_res.merges),
                  "cut_cuda_eq_reference_eq_train_files_eq_cli": cut_equal, "nvidia_smi": smi})
            if b.ref_hangul is not on or got != want:
                raise AssertionError(f"{label}: api.train's merge list hashes {got}, the JAX package recorded {want}")
            if not cut_equal or len(cut_res.merges) != SMALL_MERGES or min(run.values()) <= 0:
                raise AssertionError(f"{label}: the 1 MB cut differs between api.train on the card, the CPU "
                                     f"oracle, train_files and the CLI ({cli.stderr[-2000:]}), "
                                     f"or a training kernel never launched: {run}")
            lists[label] = res.merges
            for k in TRAIN_KERNELS:
                launches[k] += run[k]
    finally:
        b.set_ref_hangul(was)
    if lists["default"] == lists["ref_hangul"]:
        raise AssertionError("the two Hangul modes gave the same merge list")


# ─────────────────────────── the multi-merge iteration ───────────────────────────


@contextmanager
def environ(**values):
    """The block runs with ``values`` set in ``os.environ``; each variable is
    restored afterwards, or removed if it was not set."""
    was = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in was.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def multi_merge_phase(torch, corpus: bytes, stream, main_res, nodedup_res, launches: dict, smi: str) -> None:
    """Phase 21: ``Trainer(multi_merge=True)`` on the card. The main run on
    phase 4's stream (its merge list and counts must equal phase 4's, the
    merge and count_pairs2 kernels must launch, window_post must not);
    ``api.train`` on phase 11's recipe with ``GPU_BPE_TPU_MULTI=1`` (the
    16 MB record); ``force_recount`` for FORCE_MERGES merges (phase 4's
    head); phase 12's no-dedup stream at 2^25 for MULTI_SEG_MERGES merges
    (phase 12's head; segmented recounts and compact_mask on this path);
    then the default and the multi-merge trainer in turns, MULTI_PAIRS runs
    each. Adds the main run's and the 2^25 run's launches to ``launches``."""
    from gpu_bpe_tpu_torch import Trainer, api
    from gpu_bpe_tpu_torch.ops import kernels
    from gpu_bpe_tpu_torch.ops import train_step as ts

    def reads(merges: int) -> dict:
        return {"host_reads": dict(ts.HOST_READS), "host_reads_per_merge": sum(ts.HOST_READS.values()) / merges}

    # ── the main run ──
    kernels.LAUNCHES.clear()
    ts.HOST_READS.clear()
    res, _ = train(torch, Trainer, stream, MERGES, "cuda", multi_merge=True)
    run = {k: kernels.LAUNCHES[k] for k in TRAIN_KERNELS}
    same = res.merges == main_res.merges and res.merge_counts == main_res.merge_counts
    emit({"phase": "multi_merge", "merges": len(res.merges), "seconds": res.training_time_s,
          "merges_per_s": len(res.merges) / res.training_time_s, "duals": res.duals, "recounts": res.recounts,
          **reads(len(res.merges)), "launches": run,
          "neutralised_merges": run["merge_compact_tracked"] - len(res.merges), "equal_to_main_path": same})
    if not same or res.duals <= 0:
        raise AssertionError(f"multi-merge run: equal to phase 4 {same}, duals {res.duals}")
    if run["merge_compact_tracked"] <= 0 or run["count_pairs2"] <= 0 or run["window_post"]:
        raise AssertionError(f"the multi-merge path must launch the merge and count_pairs2, not window_post: {run}")
    for k in ("merge_compact_tracked", "count_pairs2"):
        launches[k] += run[k]

    # ── api.train with GPU_BPE_TPU_MULTI=1, phase 11's recipe ──
    with environ(GPU_BPE_TPU_MULTI="1"):
        ts.HOST_READS.clear()
        _, res_api = api.train(corpus, api.TrainConfig(vocab_size=256 + API_MERGES, show_progress=False))
        torch.cuda.synchronize()
    record = json.loads((REPO / CERT16).read_text())["normal"]
    got = sha_pair(res_api)
    emit({"phase": "multi_merge_api_train", "bytes": len(corpus), "merges": len(res_api.merges),
          "seconds": res_api.training_time_s, "merges_per_s": len(res_api.merges) / res_api.training_time_s,
          "duals": res_api.duals, "recounts": res_api.recounts, **reads(len(res_api.merges)), **got,
          "record": CERT16, "equal_to_record": got == {k: record[k] for k in got}})
    if got != {k: record[k] for k in got} or res_api.duals <= 0:
        raise AssertionError(f"api.train with GPU_BPE_TPU_MULTI=1 hashes {got} with {res_api.duals} duals, "
                             f"the JAX package recorded {record}")

    # ── force_recount, and the segmented recount at 2^25 ──
    truth, _ = train(torch, Trainer, stream, FORCE_MERGES, "cuda", force_recount=True, multi_merge=True)
    same_truth = (truth.merges == main_res.merges[:FORCE_MERGES]
                  and truth.merge_counts == main_res.merge_counts[:FORCE_MERGES] and truth.duals == 0)
    kernels.LAUNCHES.clear()
    ts.RECOUNTS.clear()
    seg, _ = train(torch, Trainer, api._byte_stream(corpus), MULTI_SEG_MERGES, "cuda", multi_merge=True)
    seg_run = {k: kernels.LAUNCHES[k] for k in (*TRAIN_KERNELS, "compact_mask")}
    tiers = dict(ts.RECOUNTS)
    same_seg = (seg.merges == nodedup_res.merges[:MULTI_SEG_MERGES]
                and seg.merge_counts == nodedup_res.merge_counts[:MULTI_SEG_MERGES])
    emit({"phase": "multi_merge_checks", "force_recount_merges": len(truth.merges),
          "force_recount_recounts": truth.recounts, "force_recount_equal": same_truth,
          "nodedup_merges": len(seg.merges), "nodedup_seconds": seg.training_time_s,
          "nodedup_merges_per_s": len(seg.merges) / seg.training_time_s, "nodedup_duals": seg.duals,
          "nodedup_recounts_by_tier": tiers, "nodedup_launches": seg_run, "nodedup_equal": same_seg})
    if not same_truth or not same_seg:
        raise AssertionError(f"multi-merge: force_recount equal {same_truth}, 2^25 no-dedup equal {same_seg}")
    if not any(k.startswith("seg") for k in tiers) or seg_run["compact_mask"] <= 0:
        raise AssertionError(f"the segmented recount did not run on the multi-merge path: {tiers} {seg_run}")
    for k in ("merge_compact_tracked", "count_pairs2", "compact_mask"):
        launches[k] += seg_run[k]

    # ── the paired timing: default and multi-merge in turns ──
    times = {False: [], True: []}
    per_merge = {False: [], True: []}
    duals = 0
    for i in range(2 * MULTI_PAIRS):
        multi = (i % 4) in (1, 2)  # default, multi, multi, default, ...
        ts.HOST_READS.clear()
        r, _ = train(torch, Trainer, stream, MERGES, "cuda", multi_merge=multi)
        if r.merges != main_res.merges:
            raise AssertionError(f"paired run {i} (multi_merge={multi}) differs from phase 4")
        times[multi].append(len(r.merges) / r.training_time_s)
        per_merge[multi].append(sum(ts.HOST_READS.values()) / len(r.merges))
        duals = r.duals if multi else duals
    emit({"phase": "multi_merge_timing", "runs_each": MULTI_PAIRS, "merges": MERGES, "nvidia_smi": smi,
          **{f"{label}_merges_per_s": {"median": statistics.median(times[m]), "min": min(times[m]),
                                        "max": max(times[m]), "runs": times[m]}
             for label, m in (("default", False), ("multi", True))},
          "default_host_reads_per_merge": statistics.median(per_merge[False]),
          "multi_host_reads_per_merge": statistics.median(per_merge[True]), "multi_duals": duals})


def force_recount_env_phase(torch, corpus: bytes, api_res, launches: dict) -> None:
    """Phase 22: ``api.train`` on phase 11's recipe for FORCE_MERGES merges
    with ``GPU_BPE_TPU_FORCE_RECOUNT=1`` set in this process, in the
    default loop and with ``GPU_BPE_TPU_MULTI=1``: each merge list and its
    counts must equal phase 11's first FORCE_MERGES, with one recount per
    merge and no dual. Adds both runs' launches to ``launches``."""
    from gpu_bpe_tpu_torch import api
    from gpu_bpe_tpu_torch.ops import kernels

    want_m, want_c = api_res.merges[:FORCE_MERGES], api_res.merge_counts[:FORCE_MERGES]
    for label, extra in (("default", {}), ("multi_merge", {"GPU_BPE_TPU_MULTI": "1"})):
        kernels.LAUNCHES.clear()
        with environ(GPU_BPE_TPU_FORCE_RECOUNT="1", **extra):
            t0 = time.perf_counter()
            _, r = api.train(corpus, api.TrainConfig(vocab_size=256 + FORCE_MERGES, show_progress=False))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        run = {k: kernels.LAUNCHES[k] for k in TRAIN_KERNELS}
        checks = {"equal_to_api_train": r.merges == want_m and r.merge_counts == want_c,
                  "recount_per_merge": r.recounts == len(r.merges) == FORCE_MERGES, "no_duals": r.duals == 0}
        emit({"phase": "force_recount_env", "loop": label, "bytes": len(corpus), "merges": len(r.merges),
              "recounts": r.recounts, "duals": r.duals, "seconds": secs, "training_seconds": r.training_time_s,
              "merges_per_s": len(r.merges) / r.training_time_s, "launches": run, **checks})
        if not all(checks.values()) or run["merge_compact_tracked"] <= 0:
            raise AssertionError(f"GPU_BPE_TPU_FORCE_RECOUNT=1 ({label}): {checks}, launches {run}")
        for k, v in run.items():
            launches[k] += v


def tokenize_devices_phase(torch, corpus: bytes, api_out: dict, vocab8k, ids8k, launches: dict) -> None:
    """Phase 23: the tokenizer's default device list is every visible card,
    ``GPU_BPE_TPU_TOKENIZE_ALL_DEVICES`` overriding it; ``api.encode_bulk``
    of a fresh tokenizer of phase 11's model on the 16 MB corpus equals
    phase 13's ids; a ``Tokenizer`` with ``devices=["cuda:0", "cuda:0"]`` and
    passes of DEVICES_PASS_BYTES equals phase 8's one-pass ids at the 8K
    vocab. Adds both runs' launches to ``launches``."""
    from gpu_bpe_tpu_torch import BPETokenizer, Tokenizer, api
    from gpu_bpe_tpu_torch.ops import kernels
    from gpu_bpe_tpu_torch.ops.tokenize import pass_devices

    dev0 = torch.device("cuda", 0)
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    with environ(GPU_BPE_TPU_TOKENIZE_ALL_DEVICES="0"):
        alone = pass_devices(dev0)
    with environ(GPU_BPE_TPU_TOKENIZE_ALL_DEVICES="1"):
        every = pass_devices(dev0)
    tok = BPETokenizer(api_out["tokenizer"].model)
    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    ids = api.encode_bulk(tok, corpus)
    bulk_s = time.perf_counter() - t0
    bulk_run = {k: kernels.LAUNCHES[k] for k in TOKENIZE_KERNELS}
    two = Tokenizer(vocab8k, max_pass_bytes=DEVICES_PASS_BYTES, devices=["cuda:0", "cuda:0"])
    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    ids_two = two.encode_bytes(corpus)
    two_s = time.perf_counter() - t0
    two_run = {k: kernels.LAUNCHES[k] for k in TOKENIZE_KERNELS}
    checks = {"default_is_every_card": pass_devices(dev0) == cards == Tokenizer(vocab8k).devices,
              "all_devices_0_is_cuda0": alone == [dev0], "all_devices_1_is_every_card": every == cards,
              "encode_bulk_eq_phase13": np.array_equal(ids, api_out["ids"]),
              "two_devices_eq_one": np.array_equal(ids_two, ids8k)}
    emit({"phase": "tokenize_devices", "cards": [str(d) for d in cards], "bytes": len(corpus),
          "encode_bulk_seconds": bulk_s, "encode_bulk_launches": bulk_run,
          "two_devices_passes": -(-len(corpus) // two.max_pass_bytes), "two_devices_seconds": two_s,
          "two_devices_launches": two_run, **checks})
    if not all(checks.values()) or two_run["compact_valid"] <= 0:
        raise AssertionError(f"tokenize devices: {checks}, launches {two_run}")
    for run in (bulk_run, two_run):
        for k, v in run.items():
            launches[k] += v


def soak_phase(torch, smi: str, launches: dict) -> None:
    """Phase 24: a fixed slice of the randomized soak (``scripts/
    torch_soak_fuzz.py``) on the card: tokenizer seeds SOAK_SEED0 on and
    trainer seeds 1,000,000 above them, in turns. No trial may fail and
    every kernel (both modes of the merge) must launch. Adds the launches to
    ``launches``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_soak_fuzz", REPO / SOAK_SCRIPT)
    soak = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(soak)
    out = soak.soak(torch.device("cuda", 0), SOAK_SEED0, SOAK_TOKENIZER_SEEDS, SOAK_TRAINER_SEEDS)
    trials = out["tokenizer_trials"] + out["trainer_trials"]
    emit({"phase": "soak", "script": SOAK_SCRIPT, "seed_range": out["seed_range"],
          "tokenizer_seeds": SOAK_TOKENIZER_SEEDS, "trainer_seeds": SOAK_TRAINER_SEEDS, "trials": out["trials"],
          "seconds": out["seconds"], "seconds_by_kind": out["seconds_by_kind"],
          "trials_per_s": trials / out["seconds"], "failures": out["failures"], "launches": out["launches"],
          "nvidia_smi": smi})
    missing = [k for k, v in out["launches"].items() if v <= 0]
    if out["failures"] or missing:
        raise AssertionError(f"soak: failures {out['failures']}, kernels never launched {missing}")
    for k, v in out["launches"].items():
        launches[k] = launches.get(k, 0) + v


def bitonic_inputs(kind: str, blocks: int, seed: int) -> list[np.ndarray]:
    """Three int32 [blocks * 1024, 128] arrays of u32 words for phase 25:
    every word with bit 31 set, word 0 from three values (ties in word 0),
    words 0 and 1 from three values each (ties in words 0-1), or random
    words whose every 16th row is one triple repeated and whose odd rows
    repeat the row before."""
    shape = (blocks * 1024, 128)
    rng = np.random.default_rng(seed)
    words = [rng.integers(0, 1 << 32, size=shape, dtype=np.int64).astype(np.uint32) for _ in range(3)]
    few = np.array([0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    if kind == "bit31":
        words = [w | np.uint32(0x80000000) for w in words]
    elif kind in ("ties0", "ties01"):
        for w in words[: 1 if kind == "ties0" else 2]:
            w[:] = rng.choice(few, size=shape)
    elif kind == "dup_rows":
        for w in words:
            w[::16] = w[::16, :1]
            w[1::2] = w[0::2]
    else:
        raise ValueError(kind)
    return [w.view(np.int32) for w in words]


def int32_ops_per_s(torch, dev) -> dict:
    """The card's 32-bit integer rate: INT32_LANES_PER_SM results per clock
    on each SM at the maximum SM clock that nvidia-smi reads."""
    out = subprocess.run(["nvidia-smi", "-i", str(dev.index), "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    mhz = float(out.stdout.strip().splitlines()[0].split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return {"int32_ops_per_s": INT32_LANES_PER_SM * sms * mhz * 1e6, "sms": sms, "max_sm_mhz": mhz}


def bitonic_phase(torch, smi: str, launches: dict, rows: dict) -> None:
    """Phase 25: the bitonic rounds against their plain version on every
    case, then the microbenchmark's run with the kernel's launches counted
    from 0, and the kernel's row."""
    import importlib.util

    from gpu_bpe_tpu_torch.ops import bitonic, kernels

    t0 = time.perf_counter()
    spec = importlib.util.spec_from_file_location("torch_microbench_bitonic", REPO / BITONIC_SCRIPT)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    dev = torch.device("cuda", torch.cuda.current_device())

    def check(words, rounds, stream=None):
        t = [torch.as_tensor(w, device=dev) for w in words]
        if stream is None:
            got = bitonic.bitonic_rounds(*t, rounds)
        else:
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                got = bitonic.bitonic_rounds(*t, rounds)
            stream.synchronize()
        torch.cuda.synchronize()  # a fault in the kernel surfaces here
        return max_abs_diff(got, bitonic.bitonic_rounds_plain(*t, rounds))

    a, b, c = bench.script_inputs(BITONIC_BLOCKS, dev)
    errs = {"default": check((a, b, c), BITONIC_ROUNDS)}
    for i, kind in enumerate(BITONIC_KINDS):
        for blocks in (1, 2):
            words = bench.script_inputs(blocks, dev) if kind == "script" else bitonic_inputs(kind, blocks, 100 + i)
            for r in BITONIC_EDGE_ROUNDS:
                errs[f"{kind}/b{blocks}/r{r}"] = check(words, r)
    errs["second_stream"] = check(bitonic_inputs("bit31", 2, 200), 71, torch.cuda.Stream(device=dev))
    errs[f"default/r{BITONIC_FULL_ROUNDS}"] = check((a, b, c), BITONIC_FULL_ROUNDS)
    full_prof = device_profile(torch, lambda: bitonic.bitonic_rounds(a, b, c, BITONIC_FULL_ROUNDS), reps=5)
    check_s = time.perf_counter() - t0

    kernels.LAUNCHES["bitonic_rounds"] = 0
    out = bench.run(dev, BITONIC_BLOCKS, BITONIC_ROUNDS, list(BITONIC_CAPS))
    n_launch = kernels.LAUNCHES["bitonic_rounds"]

    fn = lambda: bitonic.bitonic_rounds(a, b, c, BITONIC_ROUNDS)  # noqa: E731
    prof = device_profile(torch, fn)
    elems = out["elements"]
    rate = int32_ops_per_s(torch, dev)
    bound = {"bytes": 24 * elems / HBM_BYTES_PER_S * 1e3,
             "operations": BITONIC_OPS * elems * BITONIC_ROUNDS / rate["int32_ops_per_s"] * 1e3}
    row = {"max_abs_err": max(errs.values()), "ms": time_ms(torch, fn, 20), "host_ms": host_ms(torch, fn, 50),
           "device_ms": prof["device_ms"], "device_ops": prof["device_ops"],
           "plain_ms": time_ms(torch, lambda: bitonic.bitonic_rounds_plain(a, b, c, BITONIC_ROUNDS), 3),
           "bound_ms": max(bound.values()), "bound_by": max(bound, key=bound.get), "library_ms": None}
    emit({"phase": "bitonic", "script": BITONIC_SCRIPT, "cases": len(errs), "check_seconds": check_s, **row, "bytes_bound_ms": bound["bytes"],
          "ops_bound_ms": bound["operations"], "ops_per_element_round": BITONIC_OPS, **rate,
          "bound_fraction": row["bound_ms"] / out["ms"], "device_op_names": prof["device_op_names"],
          "full_rounds": BITONIC_FULL_ROUNDS, "full_device_ms": full_prof["device_ms"],
          "full_device_ops": full_prof["device_ops"], "launches": n_launch,
          "script_line": bench.script_line(out), "back_to_back_ms": out["ms"],
          **{k: v for k, v in out.items() if k not in ("ms", "device")},
          "seconds": time.perf_counter() - t0, "nvidia_smi": smi})
    if row["max_abs_err"] != 0:
        raise AssertionError(f"bitonic_rounds differs from its plain version: {errs}")
    for p in (prof, full_prof):
        if p["device_ops"] != 1:
            raise AssertionError(f"bitonic_rounds put {p['device_ops']} operations on the card per call, want 1")
    if n_launch <= 0:
        raise AssertionError("bitonic_rounds never launched in the microbenchmark's run")
    launches["bitonic_rounds"] = n_launch
    rows["bitonic_rounds"] = row


def bench_phase(torch, api_out: dict, launches: dict, smi: str) -> None:
    """Phase 26: ``bench_torch.py --runs BENCH_RUNS`` in a process of its
    own. It must exit 0 with one stdout line of the four keys whose value is
    the median of its runs, every selftest case true, the dist smoke equal,
    phase 11's stream n and phase 11's first MERGES merges and counts, and
    every kernel launched. Adds its launches to ``launches``."""
    from types import SimpleNamespace

    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, str(REPO / BENCH_SCRIPT), "--runs", str(BENCH_RUNS)], cwd=REPO,
                       capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    secs = time.perf_counter() - t0
    if p.returncode != 0:
        raise AssertionError(f"{BENCH_SCRIPT} exited with {p.returncode}:\n{p.stderr[-4000:]}")
    out = p.stdout.splitlines()
    lines = {}
    for text in p.stderr.splitlines():
        if text.startswith("{"):
            obj = json.loads(text)
            lines.setdefault(obj["metric"], []).append(obj)
    head = json.loads(out[0]) if len(out) == 1 else {}
    runs = lines["train_runs"][0]
    res11 = api_out["train"]
    want = sha_pair(SimpleNamespace(merges=res11.merges[:MERGES], merge_counts=res11.merge_counts[:MERGES]))
    run_launches = lines["kernel_launches"][0]["value"]
    checks = {
        "one_stdout_line": set(head) == {"metric", "value", "unit", "vs_baseline"}
        and head["metric"] == "train_merges_per_sec" and head["value"] == runs["median"] > 0,
        "selftest": all(lines["kernel_selftest"][0]["value"].values()),
        "dist_smoke": lines["dist_smoke"][0]["matches_single_chip"],
        "stream_n_eq_phase11": lines["corpus"][0]["stream_n"] == api_out["stream_n"],
        "merges_eq_phase11": runs["merges"] == MERGES and {k: runs[k] for k in want} == want,
        "kernels_launched": set(run_launches) == {*TRAIN_KERNELS, PROBE_LESS, *TOKENIZE_KERNELS}
        and min(run_launches.values()) > 0,
    }
    emit({"phase": "bench", "script": BENCH_SCRIPT, "seconds": secs, "line": head, "runs": runs["runs"],
          "median": runs["median"], "min": runs["min"], "max": runs["max"],
          "merges_per_sec": [r["merges_per_sec"] for r in lines["train_run"]],
          "stream_n": lines["corpus"][0]["stream_n"], "dedup_ratio": lines["corpus"][0]["dedup_ratio"],
          "tokenize": [{k: v for k, v in r.items() if k not in ("metric", "launches")}
                       for r in lines["tokenize_mb_per_sec"]],
          "launches": run_launches, **checks, "nvidia_smi": smi})
    if not all(checks.values()):
        raise AssertionError(f"{BENCH_SCRIPT}: {checks}\n{p.stderr[-4000:]}")
    for k, v in run_launches.items():
        launches[k] = launches.get(k, 0) + v


def dense_match_cases(torch, tok1k, buf, dev) -> list:
    """Phase 27's inputs: (label, data, dense tables, input_len, chunk,
    incoming) at the trained 1K vocab, a vocab of 64-200-byte tokens, a
    table at its least size (colliding probes) and one too large for shared
    memory."""
    from gpu_bpe_tpu_torch import Tokenizer
    from gpu_bpe_tpu_torch.ops import dense_kernels as dk

    t = tok1k.tables
    n, cs, dense = buf.numel(), tok1k.chunk_size, tok1k._dense
    n_keys = sum(len(t.ids[ln]) for ln in t.dense_lengths)
    forced = dk.DenseTables(t, dk.DenseHash.build(t, n_slots=1 << n_keys.bit_length()), dev)
    in_l2 = dk.DenseTables(t, dk.DenseHash.build(t, n_slots=1 << 14), dev)  # 256 KB of slots
    rng = np.random.default_rng(2718)
    vocab = [bytes([b]) for b in range(256)]
    while len(vocab) < 596:
        w = bytes(rng.integers(97, 101, size=int(rng.integers(2, 11))).tolist())
        vocab += [w] if w not in vocab else []
    vocab += [bytes(rng.integers(97, 99, size=int(rng.integers(64, 201))).tolist()) for _ in range(40)]
    gather = Tokenizer(vocab, device=dev)
    text = b"".join(vocab[int(i)] for i in rng.integers(256, len(vocab), size=80_000))[: (1 << 20) + 13]
    gbuf = torch.from_numpy(np.frombuffer(text, np.uint8).copy()).to(dev)
    m = 1 << 20
    incoming = (torch.randint(-1, len(tok1k.vocab), (m,), device=dev), torch.randint(0, 9, (m,), device=dev))
    return [
        ("1k_16mib", buf, dense, n, cs, ()),
        ("1k_input_ends_inside_a_chunk", buf, dense, n - 12345, cs, ()),
        ("1k_chunk_500_view_3_bytes_in", buf[3:], dense, n - 3 - 777, 500, ()),
        ("1k_incoming_match", buf[:m], dense, m - 5, cs, incoming),
        ("1k_forced_collisions", buf[: 1 << 22], forced, (1 << 22) - 1, cs, ()),
        ("1k_table_in_l2", buf[: 1 << 22], in_l2, 1 << 22, cs, ()),
        ("1k_tile_edges_chunk_512", buf[: 2 * dk.TILE + 1], dense, 2 * dk.TILE + 1, 512, ()),
        ("1k_one_partial_tile", buf[:77], dense, 70, cs, ()),
        ("gather_64_200", gbuf, gather._dense, gbuf.numel() - 1, gather.chunk_size, ()),
    ]


def dense_match_phase(torch, corpus: bytes, vocab1k, rows: dict) -> None:
    """Phase 27: dense_match.cu against its plain version on the card at
    the trained 1K vocab's 16 MiB pass and on the edge cases of
    ``dense_match_cases``; its time at the 1K pass's shape beside its byte
    bound and the plain version's, and the whole match table's and pass's
    times there."""
    from gpu_bpe_tpu_torch import Tokenizer
    from gpu_bpe_tpu_torch.ops import dense_kernels as dk
    from gpu_bpe_tpu_torch.ops import kernels
    from gpu_bpe_tpu_torch.ops import tokenize as ttz

    dev = torch.device("cuda")
    tok = Tokenizer(vocab1k)
    t = tok.tables
    if t.stab is not None or len(t.dense_lengths) < 2:
        raise AssertionError(f"the 1K vocab has a stab table or few dense lengths: {t.dense_lengths}")
    buf = torch.from_numpy(np.frombuffer(corpus, np.uint8).copy()).to(dev)
    err, hits = 0.0, {}
    before = kernels.LAUNCHES["dense_match"]
    for label, data, dense, input_len, cs, incoming in dense_match_cases(torch, tok, buf, dev):
        got = dk.dense_match(data, dense, input_len, cs, *incoming)
        torch.cuda.synchronize()
        want = dk.dense_match_plain(data, dense, input_len, cs, *incoming)
        e = max_abs_diff(got, want)
        if e != 0.0:
            raise AssertionError(f"dense_match disagrees with its plain version on {label}: {e}")
        hits[label] = int((want[1] > 1).sum())
        err = max(err, e)
    if kernels.LAUNCHES["dense_match"] - before != len(hits) or min(hits.values()) <= 0:
        raise AssertionError(f"dense_match: launches {kernels.LAUNCHES['dense_match'] - before}, hits {hits}")

    n, cs, dense = buf.numel(), tok.chunk_size, tok._dense
    kern = lambda: dk.dense_match(buf, dense, n, cs)  # noqa: E731
    plain = lambda: dk.dense_match_plain(buf, dense, n, cs)  # noqa: E731
    table = lambda: ttz.build_match_table(buf, t, None, dense, n, cs)  # noqa: E731
    ms, table_ms = time_in_turns(torch, [kern, table], 20)
    plain_ms = time_ms(torch, plain, 3)
    prof = dict(host_ms=host_ms(torch, kern, 50), **device_profile(torch, kern))
    nbytes = 17 * n  # the pass's bytes read, match_id and match_len written
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    slots = dense.slots.shape[0]
    rows["dense_match"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, library_ms=None,
                               max_abs_err=max(err, rows.get("dense_match", {}).get("max_abs_err", 0.0)), **prof)
    emit({"phase": "dense_match", "cases": len(hits), "hits": hits, "max_abs_err": err, "tolerance": 0,
          "ms": ms, "plain_ms": plain_ms, "match_table_ms": table_ms, **prof, "bytes": nbytes,
          "bound_ms": bound_ms, "bound_by": "bytes", "bound_fraction": bound_ms / ms,
          "shape": {"n": n, "chunk": cs, "lengths": t.dense_lengths, "keys": int((dense.slots[:, 0] != 0).sum()),
                    "slots": slots, "max_probes": dense.max_probes,
                    "table_bytes": 16 * slots + 4 * dense.words.numel()},
          "pass": pass_rates(torch, tok, corpus)})
    if round(prof["device_ops"]) > 1:
        raise AssertionError(f"dense_match put {prof['device_op_names']} on the card per call, want one kernel")


def replace_state(ts, st):
    """A copy of ``st`` whose tensors can be reused by several calls."""
    from dataclasses import fields

    return ts.TrainState(**{f.name: getattr(st, f.name).clone() for f in fields(st)})


def train(torch, Trainer, stream, merges, device, **kw):
    events = []
    trainer = Trainer(device=device, **kw)
    res = trainer.train_stream(stream, target_vocab_size=256 + merges, on_progress=events.append)
    if device == "cuda":
        torch.cuda.synchronize()
    return res, events


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from gpu_bpe_tpu_torch import Tokenizer, Trainer
    from gpu_bpe_tpu_torch.core import GreedyTrieEncoder
    from gpu_bpe_tpu_torch.ops import build, dense_kernels, kernels, stab_kernels
    from gpu_bpe_tpu_torch.ops import tokenize as ttz
    from gpu_bpe_tpu_torch.ops import train_step as ts
    from gpu_bpe_tpu_torch.ops.ingest import make_stream, pad_stream
    from gpu_bpe_tpu_torch.pretok import byte_word_starts

    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    paths = build.build_all()
    tile = build.load()["compact_mask"].cm_tile_entries()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [p.name for p in paths.values()]})
    if tile != kernels.COMPACT_TILE:
        raise AssertionError(f"compact_mask.cu tiles {tile} entries, ops/kernels.py says {kernels.COMPACT_TILE}")
    for lib, fn, want in (("expand_to_mask", "em_tile_entries", kernels.EXPAND_TILE),
                          ("overlay_fit", "of_tile_rows", stab_kernels.OVERLAY_TILE),
                          ("dense_match", "dm_tile_positions", dense_kernels.TILE)):
        got = getattr(build.load()[lib], fn)()
        if got != want:
            raise AssertionError(f"{lib}.cu tiles {got} entries, the wrapper's module says {want}")
    arena = build.load()["merge_compact_tracked"].mc_arena_words()
    if arena != kernels.ARENA_WORDS:
        raise AssertionError(f"merge_compact_tracked.cu's arena has {arena} words, "
                             f"ops/kernels.py says {kernels.ARENA_WORDS}")

    t0 = time.perf_counter()
    corpus64 = synth_corpus(CORPUS64_BYTES, seed=0)
    corpus = corpus64[:CORPUS_BYTES]  # = synth_corpus(CORPUS_BYTES): the generator only appends
    stream = make_stream(corpus, byte_word_starts(corpus))
    padded = pad_stream(stream)
    emit({"phase": "corpus", "bytes": len(corpus), "stream_n": stream.n,
          "capacity": int(padded.symbols.shape[0]), "seconds": time.perf_counter() - t0})

    rows, real = kernel_phase(torch, kernels, ts, padded, torch.device("cuda"))

    # ── phase 4: the main path, launch counts from this run only ──
    kernels.LAUNCHES.clear()
    res, events = train(torch, Trainer, stream, MERGES, "cuda")
    launches = {k: kernels.LAUNCHES[k] for k in TRAIN_KERNELS}
    cap = int(padded.symbols.shape[0])
    for ev in events:  # replay the trainer's shrink ladder
        while cap > 2048 and ev["symbolCount"] + 32 <= cap // 2:
            cap //= 2
    main = {"phase": "main_path", "merges": len(res.merges), "seconds": res.training_time_s,
            "merges_per_s": len(res.merges) / res.training_time_s, "recounts": res.recounts,
            "final_n": events[-1]["symbolCount"], "final_capacity": cap, "launches": launches,
            "vocab_size": res.vocab_size}
    emit(main)
    if len(res.merges) != MERGES or res.vocab_size != 256 + MERGES:
        raise AssertionError(f"main path made {len(res.merges)} merges, want {MERGES}")
    if min(res.merge_counts) < 2 or any(z != 256 + i for i, (_a, _b, z) in enumerate(res.merges)):
        raise AssertionError("main path merge list is malformed")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    # ── phase 5: ground truth, a recount before every merge ──
    truth, _ = train(torch, Trainer, stream, FORCE_MERGES, "cuda", force_recount=True)
    same = truth.merges == res.merges[:FORCE_MERGES] and truth.merge_counts == res.merge_counts[:FORCE_MERGES]
    emit({"phase": "force_recount", "merges": len(truth.merges), "recounts": truth.recounts,
          "equal": same})
    if not same:
        raise AssertionError("certified merge list differs from the force_recount ground truth")

    # ── phase 6: the card against the port's CPU path ──
    small = corpus[:SMALL_BYTES]
    s_stream = make_stream(small, byte_word_starts(small))
    on_gpu, _ = train(torch, Trainer, s_stream, SMALL_MERGES, "cuda")
    on_cpu, _ = train(torch, Trainer, s_stream, SMALL_MERGES, "cpu")
    same = on_gpu.merges == on_cpu.merges and on_gpu.merge_counts == on_cpu.merge_counts
    emit({"phase": "cuda_vs_cpu", "bytes": len(small), "merges": len(on_gpu.merges),
          "equal": same, "cuda_recounts": on_gpu.recounts, "cpu_recounts": on_cpu.recounts})
    if not same or len(on_gpu.merges) != SMALL_MERGES:
        raise AssertionError("cuda and cpu merge lists differ")
    cut_merges = on_gpu.merges  # replayed in phase 17

    # ── phase 7: the tokenize vocabs ──
    t0 = time.perf_counter()
    res8k, _ = train(torch, Trainer, stream, TOKENIZE_VOCAB - 256, "cuda")
    train_s = time.perf_counter() - t0
    vocabs = {"8192": res8k.vocab, "65536-synth": synth_vocab_64k(corpus)}
    emit({"phase": "tokenize_vocab", "vocab_size": res8k.vocab_size, "train_seconds": train_s,
          "merges_per_s": len(res8k.merges) / res8k.training_time_s, "recounts": res8k.recounts})
    if res8k.vocab_size != TOKENIZE_VOCAB:
        raise AssertionError(f"tokenize vocab has {res8k.vocab_size} tokens, want {TOKENIZE_VOCAB}")
    toks = {label: Tokenizer(v) for label, v in vocabs.items()}

    # ── phase 8: tokenize main path, launch counts from these runs only ──
    kernels.LAUNCHES.clear()
    ids, per_run = {}, {}
    with recorded_calls(ttz) as calls:
        for label, tok in toks.items():
            before = Counter(kernels.LAUNCHES)
            t0 = time.perf_counter()
            ids[label] = tok.encode_bytes(corpus)
            first_s = time.perf_counter() - t0
            per_run[label] = ({k: kernels.LAUNCHES[k] - before[k] for k in TOKENIZE_KERNELS}, first_s)
    tok_launches = {k: kernels.LAUNCHES[k] for k in TOKENIZE_KERNELS}
    launches.update(tok_launches)
    rank_engaged = {label: run[0]["expand_to_mask"] > 0 for label, run in per_run.items()}
    for label, tok in toks.items():
        t = tok.tables
        emit({"phase": "tokenize_main", "vocab": label, "bytes": len(corpus), "passes": 1,
              "tokens": len(ids[label]), "bytes_per_token": len(corpus) / len(ids[label]),
              "first_call_seconds": per_run[label][1], **pass_rates(torch, tok, corpus),
              "chunk_size": tok.chunk_size, "max_token_len": t.max_token_len,
              "stab_levels": 1 + len(t.stab["levels"]) if t.stab else 0,
              "dense_lengths": t.dense_lengths, "rank_space": rank_engaged[label],
              "launches": per_run[label][0]})
    emit({"phase": "tokenize_launches", "launches": tok_launches})
    if min(tok_launches.values()) <= 0:
        raise AssertionError(f"a tokenize kernel never launched on the main path: {tok_launches}")
    if not any(rank_engaged.values()):
        raise AssertionError("the rank-space chain engaged in neither tokenize run")

    # ── phase 9: tokenize results ──
    for label, vocab in vocabs.items():
        off = Tokenizer(vocab, rank_mode="off").encode_bytes(corpus)
        same = np.array_equal(off, ids[label])
        emit({"phase": "tokenize_rank_off", "vocab": label, "equal": same})
        if not same:
            raise AssertionError(f"vocab {label}: rank space and full width give different ids")
    tok8 = toks["8192"]
    decoded = tok8.decode(ids["8192"])
    small = corpus[:SMALL_BYTES]
    on_gpu = tok8.encode_bytes(small)
    on_cpu = Tokenizer(vocabs["8192"], device="cpu").encode_bytes(small)
    ref = GreedyTrieEncoder(vocabs["8192"], chunk_size=tok8.chunk_size).encode(small)
    checks = {"decode_roundtrip": decoded == corpus, "cuda_eq_cpu": np.array_equal(on_gpu, on_cpu),
              "cuda_eq_greedy": np.array_equal(on_gpu, ref)}
    emit({"phase": "tokenize_checks", "small_bytes": len(small), "small_tokens": len(on_gpu), **checks})
    if not all(checks.values()):
        raise AssertionError(f"tokenize checks failed: {checks}")

    # ── phase 10: tokenize kernels against their plain versions ──
    rows.update(tokenize_kernel_phase(torch, kernels, stab_kernels, dense_kernels, calls, torch.device("cuda")))
    del calls

    api_out = api_phases(torch, corpus, vocabs, launches, rows)
    launches[PROBE_LESS] = 0
    dist_phases(torch, corpus, stream, res.merges, launches)

    files_phase(torch, corpus64, launches)
    del corpus64
    checkpoint_phase(torch, stream, res, s_stream, cut_merges, launches)
    cli_phase(torch, corpus[:SMALL_BYTES])
    launches[EXPLICIT_PROBES] = 0
    selftest_phase(torch, launches)
    rows[EXPLICIT_PROBES] = explicit_probe_row(torch, kernels, real, torch.device("cuda"))
    unicode_phase(torch, smi, launches)
    multi_merge_phase(torch, corpus, stream, res, api_out["nodedup"], launches, smi)
    force_recount_env_phase(torch, corpus, api_out["train"], launches)
    tokenize_devices_phase(torch, corpus, api_out, vocabs["8192"], ids["8192"], launches)
    soak_phase(torch, smi, launches)
    bitonic_phase(torch, smi, launches, rows)
    bench_phase(torch, api_out, launches, smi)
    dense_match_phase(torch, corpus, api_out["nodedup"].vocab[:1024], rows)

    emit({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep, "launches": launches[k],
         "max_abs_err": rows[k]["max_abs_err"], "ms": rows[k]["ms"], "plain_ms": rows[k]["plain_ms"],
         "bound_ms": rows[k]["bound_ms"], "bound_by": rows[k].get("bound_by", "bytes"),
         "library_ms": rows[k].get("library_ms")}
        for k, (src, rep) in KERNELS.items()
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(dist_worker(sys.argv[2], int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
