"""Smoke test of the PyTorch/CUDA port (gpu_bpe_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit from nvidia-smi, torch and CUDA
   versions;
2. build: the three CUDA kernels built from ops/csrc with nvcc (seconds);
3. kernel checks: each kernel against its plain PyTorch version on the card,
   on inputs made from a numpy seed at the main path's shapes (capacity
   2^20, ~0.9 M live symbols, a live 256-slot window): affected sets in each
   16-probe tier and above 64, ids >= 0x8000, overlap runs and word starts
   at block edges, garbage past n. Bitwise comparison (tolerance 0: both
   versions sum integers exactly and round the histograms to f32 once).
   Each line has the kernel's median time over CUDA events, the plain
   version's, the bytes it must move and the bound at 3.35 TB/s;
4. main path: Trainer(device="cuda") on bench.py's 16 MB synthetic Zipfian
   corpus (seed 0), 1024 merges (vocab 256 -> 1280), byte-heuristic word
   starts; merges/s, recounts, final n and capacity, and every kernel's
   launch count on this run (each must be > 0);
5. the same trainer with force_recount=True for the first 256 merges: its
   merge list must equal phase 4's first 256 merges;
6. phase 4's corpus cut to 1 MB, 128 merges, on cuda and on cpu: the merge
   lists must be equal.

Then the kernels' JSON line, the nvidia-smi line and, last, the result line.
Any mismatch or exception exits non-zero; without a CUDA device the script
exits non-zero before printing anything.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate
CAP = 1 << 20
N_LIVE = 900_000
CORPUS_BYTES = 16 << 20
MERGES = 1024
FORCE_MERGES = 256
SMALL_BYTES = 1 << 20
SMALL_MERGES = 128
PALLAS = "gpu_bpe_tpu/ops/pallas_kernels.py"
KERNELS = {
    "merge_compact_tracked": ("gpu_bpe_tpu_torch/ops/csrc/merge_compact_tracked.cu", f"{PALLAS}:136"),
    "count_pairs2": ("gpu_bpe_tpu_torch/ops/csrc/count_pairs2.cu", f"{PALLAS}:641"),
    "window_post": ("gpu_bpe_tpu_torch/ops/csrc/window_post.cu", f"{PALLAS}:1094"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def synth_corpus(n_bytes: int, seed: int = 0, vocab_size: int = 120_000) -> bytes:
    """bench.py's deterministic Zipfian text over a large synthetic word
    vocabulary (syllable compositions, Zipf rank-frequency sampling)."""
    rng = np.random.default_rng(seed)
    syllables = np.array(
        [a + b for a in "btkdsmnlrpfgvz" for b in ("a", "e", "i", "o", "u", "ar", "en", "il", "on", "ust")]
        + ["tion", "ing", "er", "ed", "ly", "pre", "con", "anti", "ment", "ness"],
        dtype=object,
    )
    n_syll = rng.integers(1, 5, size=vocab_size)
    words = []
    for k in n_syll:
        idx = rng.integers(0, len(syllables), size=k)
        words.append("".join(syllables[i] for i in idx))
    words = np.array(words, dtype=object)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = ranks**-1.05
    probs /= probs.sum()
    parts = []
    size = 0
    while size < n_bytes:
        idx = rng.choice(vocab_size, size=65536, p=probs)
        text = " ".join(words[i] for i in idx)
        lines = [text[i : i + 80] for i in range(0, len(text), 80)]
        blob = ("\n".join(lines) + "\n").encode()
        parts.append(blob)
        size += len(blob)
    return b"".join(parts)[:n_bytes]


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Median over ``reps`` calls of CUDA-event time (after one warm-up)."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    # the real main-path stream, its real first winner and recount window
    rs = ts.init_state(real_stream.symbols, real_stream.weights, real_stream.n, 256, dev)
    rs = ts._ensure_pending(rs, certified=False)
    real = ("real/first-merge", rs.symbols.cpu().numpy(), rs.weights.cpu().numpy(), real_stream.n,
            int(rs.pend_pair), 256, rs.cand.cpu().numpy(), rs.cand_counts.cpu().numpy())
    cases.append(real)

    err = {k: 0.0 for k in KERNELS}
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
    for cand, counts, bl, br, log, probes, pcnt, scalars in wp_inputs:
        got = kernels.window_post(cand, counts, bl, br, log, probes=probes, pcnt=pcnt, **scalars)
        sc = kernels.pack_scalars(dev, probes=probes, pcnt=pcnt, **scalars)
        want = kernels.window_post_plain(sc, cand, counts, bl, br, log)
        err["window_post"] = max(err["window_post"], max_abs_diff(got, want))
    for k, e in err.items():
        if e != 0.0:
            raise AssertionError(f"{k} disagrees with its plain version: max_abs_err {e}\n{details}")

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
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows[k] = dict(ms=ms, plain_ms=plain_ms, bytes=nbytes, bound_ms=bound_ms,
                       max_abs_err=err[k])
        emit({"phase": "kernel", "name": k, "cases": len(cases) if k != "window_post" else 2,
              "max_abs_err": err[k], "tolerance": 0, "ms": ms, "plain_ms": plain_ms,
              "bytes": nbytes, "bound_ms": bound_ms, "bound_by": "bytes"})
    emit({"phase": "kernel_cases", "cases": details})
    return rows


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
    from gpu_bpe_tpu_torch import Trainer
    from gpu_bpe_tpu_torch.ops import build, kernels
    from gpu_bpe_tpu_torch.ops import train_step as ts
    from gpu_bpe_tpu_torch.ops.ingest import make_stream, pad_stream
    from gpu_bpe_tpu_torch.pretok import byte_word_starts

    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    paths = build.build_all()
    build.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [p.name for p in paths.values()]})

    t0 = time.perf_counter()
    corpus = synth_corpus(CORPUS_BYTES, seed=0)
    stream = make_stream(corpus, byte_word_starts(corpus))
    padded = pad_stream(stream)
    emit({"phase": "corpus", "bytes": len(corpus), "stream_n": stream.n,
          "capacity": int(padded.symbols.shape[0]), "seconds": time.perf_counter() - t0})

    rows = kernel_phase(torch, kernels, ts, padded, torch.device("cuda"))

    # ── phase 4: the main path, launch counts from this run only ──
    kernels.LAUNCHES.clear()
    res, events = train(torch, Trainer, stream, MERGES, "cuda")
    launches = {k: kernels.LAUNCHES[k] for k in KERNELS}
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

    emit({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep, "launches": launches[k],
         "max_abs_err": rows[k]["max_abs_err"], "ms": rows[k]["ms"], "plain_ms": rows[k]["plain_ms"],
         "bound_ms": rows[k]["bound_ms"], "bound_by": "bytes", "library_ms": None}
        for k, (src, rep) in KERNELS.items()
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
