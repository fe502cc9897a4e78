"""What each host step of the merge_compact_tracked and count_pairs2
wrappers, and one whole certified merge, costs on one CUDA card.

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
conversions, ``torch.cuda.device``). Then the whole certified merge of the
default training loop with its host read, ``--merge-rounds`` rounds in
turns (gated, glue, glue, gated): ``ops/train_step._one_merge_fused_certified``
(the gated mode: three launches and one copy) against the design it
replaced, the torch glue of ``_gate`` and ``_sampled_pairs`` around the
window mode and a ``torch.cat`` before the read; each call starts from the
same state, made by a recount of the stream, and waits for its read. The
card's name and power limit are printed first (nvidia-smi).
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


def glue_certified_merge(ts, k, st):
    """The certified merge as the loop made it before the gated mode: the
    torch glue of ``_gate`` and ``_sampled_pairs`` around the window-mode
    merge, ``count_pairs2`` and ``window_post``, then ``torch.cat`` and one
    read (the wide merge's redo left out: the state here is not wide)."""
    import torch

    active, pair_eff, has_room = ts._gate(st)
    sym2, w2, n_new, bins_l, bins_r, samp, pcnt, probes, n_aff = k.merge_compact_tracked(
        st.symbols, st.weights, st.n, pair_eff, st.next_id, st.cand, st.cand_counts)
    sampled = ts._sampled_pairs(st, samp, has_room)
    l_slot, r_slot = sampled.pop("l_slot"), sampled.pop("r_slot")
    cnt2 = k.count_pairs2(sym2, w2, n_new, l_slot, r_slot)
    scalars = dict(pair=pair_eff, count=st.pend_count, next_id=st.next_id, theta=st.theta, ub_new=st.ub_new,
                   fill=st.fill, merges_done=st.merges_done, active=active, early_stop=st.early_stop,
                   use_probes=n_aff <= k.N_PROBES, n_aff=n_aff, c_l=cnt2[0], c_r=cnt2[1], has_room=has_room,
                   **sampled)
    cand2, counts3, log2, sout = k.window_post(st.cand, st.cand_counts, bins_l, bins_r, st.merge_log,
                                               probes=probes, pcnt=pcnt, **scalars)
    host = torch.cat([sout, n_new.reshape(1), n_aff.reshape(1)]).tolist()
    return ts.replace(st, symbols=sym2, weights=w2, n=n_new, next_id=sout[6], early_stop=sout[2],
                      merges_done=sout[0], merge_log=log2, cand=cand2, cand_counts=counts3, ub_new=sout[3],
                      fill=sout[1], pend_pair=sout[7], pend_count=sout[4], pend_cert=sout[5]), host


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--merge-rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2

    from chip_smoke import N_LIVE, nvidia_smi_line, synthetic_stream, window_for
    from gpu_bpe_tpu_torch.ops import build
    from gpu_bpe_tpu_torch.ops import kernels as k
    from gpu_bpe_tpu_torch.ops import train_step as ts

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
             cand.data_ptr(), counts.data_ptr(), 0, 0, 0, 0, out.data_ptr(), arena.data_ptr(),
             scratch_m.data_ptr(), stream)
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

    # the whole certified merge with its read, from one recounted state
    st = ts._ensure_pending(ts.init_state(symbols, weights, N_LIVE, 300, dev), certified=False)
    merges = {"certified_merge_gated": lambda: ts._one_merge_fused_certified(st),
              "certified_merge_glue": lambda: glue_certified_merge(ts, k, st)}
    got, want = merges["certified_merge_gated"](), merges["certified_merge_glue"]()
    if got[1] != want[1]:
        raise AssertionError(f"the gated merge read {got[1]}, the glue {want[1]}")
    gate = (st.pend_count, st.fill)
    print(json.dumps({"step": "merge_wrapper_gated", "host_us": host_us(
        torch, lambda: k.merge_compact_tracked(st.symbols, st.weights, st.n, st.pend_pair, st.next_id, st.cand,
                                               st.cand_counts, gate=gate), args.reps)}), flush=True)
    reps = max(args.reps // 4, 10)
    for rnd in range(args.merge_rounds):
        for name in ("certified_merge_gated", "certified_merge_glue", "certified_merge_glue",
                     "certified_merge_gated"):
            print(json.dumps({"step": name, "round": rnd, "host_us": host_us(torch, merges[name], reps)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
