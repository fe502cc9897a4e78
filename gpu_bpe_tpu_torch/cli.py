"""Command-line interface of the port (the counterpart of
``gpu_bpe_tpu/cli.py``, with the same subcommands, flags, output files and
stderr lines):

  python -m gpu_bpe_tpu_torch.cli train   corpus1.txt corpus2.txt -o model.json \\
      --vocab-size 8192 --backend cuda --shuffle
  python -m gpu_bpe_tpu_torch.cli encode  model.json "some text"
  python -m gpu_bpe_tpu_torch.cli decode  model.json 104 105
  python -m gpu_bpe_tpu_torch.cli export-bin  model.json corpus.txt -o tokens.bin
  python -m gpu_bpe_tpu_torch.cli export-trie model.json -o model.trie
  python -m gpu_bpe_tpu_torch.cli export-hf   model.json -o tokenizer.json
  python -m gpu_bpe_tpu_torch.cli vocab   model.json
  python -m gpu_bpe_tpu_torch.cli inspect tokens.bin
  python -m gpu_bpe_tpu_torch.cli warmup  --min-log2 15 --max-log2 22

``train`` and ``export-bin`` run on the card unless ``--device cpu``;
``encode``, ``decode``, ``vocab``, ``export-trie`` and ``export-hf`` load
the model on the host. ``train --backend dist`` with ``--coordinator``,
``--num-processes`` and ``--process-id`` (or the ``GPU_BPE_TPU_*``
environment variables of ``parallel/multihost.py``) runs one process per
card over NCCL.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .api import TrainConfig, collect_files, export_bin, export_trie, load_model, train, train_files
from .constants import BATCH_MERGES
from .utils.timing import format_size


def _read_files(paths: list[str]) -> list[bytes]:
    """Read files; directories recurse with the text-extension filter."""
    out = []
    for p in collect_files(paths):
        with open(p, "rb") as f:
            out.append(f.read())
    return out


def cmd_train(args) -> int:
    # a multi-process launch joins the process group before anything else
    # touches the device; every process runs this same command
    from .parallel.multihost import init_multihost, multihost_requested, shutdown_multihost

    multihost = multihost_requested(args)
    rank = 0
    if multihost:
        rank, nproc = init_multihost(coordinator_address=args.coordinator, num_processes=args.num_processes,
                                     process_id=args.process_id, device=args.device)
        args.backend = "dist"
        print(f"multi-host: process {rank}/{nproc}", file=sys.stderr)

    paths = collect_files(args.files)
    total = sum(os.path.getsize(p) for p in paths)
    if rank == 0:
        print(f"corpus: {len(paths)} file(s), {format_size(total)} · vocab target: {args.vocab_size}",
              file=sys.stderr)
    config = TrainConfig(
        vocab_size=args.vocab_size,
        backend=args.backend,
        device=args.device,
        pre_tokenize=not args.byte_level,
        dedup=not args.no_dedup,
        shuffle=args.shuffle,
        batch_merges=args.batch_merges,
        profile_dir=args.profile,
    )
    t0 = time.perf_counter()
    # streamed ingestion keeps host memory bounded by the unique-word mass;
    # automatic above 1 GB, forced with --stream
    if args.stream or (total > (1 << 30) and not config.shuffle
                       and config.pre_tokenize and config.dedup and config.backend != "cpu"):
        tokenizer, result = train_files(paths, config)
    else:
        tokenizer, result = train(_read_files(paths), config)
    dt = time.perf_counter() - t0
    if rank == 0:
        print(f"✓ {len(result.merges)} merges, vocab {result.vocab_size}, "
              f"{dt:.1f}s ({len(result.merges) / max(dt, 1e-9):.1f} merges/s)", file=sys.stderr)
        tokenizer.save(args.output)
        print(f"→ {args.output}", file=sys.stderr)
    if multihost:
        shutdown_multihost()  # a barrier: rank 0 finishes writing first
    return 0


def cmd_encode(args) -> int:
    tok = load_model(args.model, backend="cpu")
    if args.greedy:
        tokens = tok.encode_bytes_greedy(args.text.encode()).tolist()
    else:
        tokens = tok.encode(args.text)
    print(" ".join(str(t) for t in tokens))
    data = args.text.encode()
    if tokens:
        print(f"# {len(tokens)} tokens · {len(data) / len(tokens):.2f} bytes/token", file=sys.stderr)
    return 0


def cmd_decode(args) -> int:
    tok = load_model(args.model, backend="cpu")
    sys.stdout.write(tok.decode_text([int(t) for t in args.tokens]))
    sys.stdout.write("\n")
    return 0


def cmd_export_bin(args) -> int:
    tok = load_model(args.model, backend=args.backend, device=args.device)
    data = b"\n\n".join(_read_files(args.files))
    t0 = time.perf_counter()
    blob = export_bin(tok, data, args.output)
    dt = time.perf_counter() - t0
    rate = len(data) / (1 << 20) / max(dt, 1e-9)
    print(f"→ {args.output}: {format_size(len(blob))} in {dt:.2f}s "
          f"({rate:.2f} MB/s; first runs include one-time kernel builds — "
          f"see `warmup`)", file=sys.stderr)
    return 0


def _timed(label: str, fn):
    """``fn()``, printing its seconds under ``label``."""
    t0 = time.perf_counter()
    out = fn()
    print(f"  {label}: {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    return out


def cmd_warmup(args) -> int:
    """Build the kernels and host libraries, then run the capacity ladder
    (8 merges at each power-of-two capacity) and, with ``--tokenize``, the
    tokenizer's vocab-row and input-size buckets, printing each step's
    seconds. The libraries are built once per tree (``_build/``), so later
    runs start without the builds."""
    import numpy as np
    import torch

    from .ops import Tokenizer, Trainer
    from .ops.ingest import SymbolStream
    from .ops.native import native_available
    from .ops.trainer import resolve_device
    from .unicode import backend_name

    device = resolve_device(args.device)
    if device.type == "cuda":
        from .ops.build import build_all

        _timed("nvcc kernels", build_all)
    native = _timed("native ingest library", native_available)
    unicode_backend = _timed("Unicode decoder library", backend_name)
    print(f"  ingest: {'native' if native else 'numpy (no g++)'}, Unicode backend: {unicode_backend}",
          file=sys.stderr)

    rng = np.random.default_rng(0)
    for logcap in range(args.min_log2, args.max_log2 + 1):
        n = (1 << logcap) - 64
        toks = rng.integers(1, 120, size=n).astype(np.uint32)
        ws = rng.random(n) < 0.2
        sym = toks | (ws.astype(np.uint32) << 16)
        sym[0] |= 1 << 16
        stream = SymbolStream(sym, np.ones(n, np.int32), n, n)

        def ladder_step():
            Trainer(device=device).train_stream(stream, target_vocab_size=256 + 8)
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        _timed(f"cap 2^{logcap}", ladder_step)

    if args.tokenize:
        # the tokenizer's vocab-row buckets (~4K / 8K / 32K-token models)
        # over input sizes of every other power of two
        for rows_log2 in (12, 13, 15):
            rng2 = np.random.default_rng(1)
            seen = {bytes([b]) for b in range(256)}
            vocab = [bytes([b]) for b in range(256)]
            target = (1 << rows_log2) + 200
            while len(vocab) < target:
                ln = int(rng2.integers(2, 13))
                t = bytes(rng2.integers(97, 122, size=ln).tolist())
                if t not in seen:
                    seen.add(t)
                    vocab.append(t)
            tok = Tokenizer(vocab, device=device)
            for in_log2 in range(args.min_log2, min(args.max_log2, 24) + 1, 2):
                data = bytes(rng2.integers(97, 122, size=(1 << in_log2) - 5).tolist())
                _timed(f"tokenize rows 2^{rows_log2} in 2^{in_log2}", lambda: tok.encode_bytes(data))
    print("✓ kernels built, ladder run", file=sys.stderr)
    return 0


def cmd_export_trie(args) -> int:
    tok = load_model(args.model, backend="cpu")
    blob = export_trie(tok, args.output)
    from .trie import parse_header

    h = parse_header(blob)
    print(f"→ {args.output}: {h.node_count} nodes, {h.edge_count} edges, "
          f"maxTokenLen={h.max_token_len} ({format_size(len(blob))})", file=sys.stderr)
    return 0


def cmd_export_hf(args) -> int:
    tok = load_model(args.model, backend="cpu")
    text = tok.export_hf_json(pretok=args.pretok)
    with open(args.output, "w", encoding="utf-8") as f:
        f.write(text)
    print(f"→ {args.output}: {tok.vocab_size} tokens, "
          f"{len(tok.model.merges)} merges, pretok={args.pretok}", file=sys.stderr)
    return 0


def cmd_vocab(args) -> int:
    tok = load_model(args.model, backend="cpu")
    sys.stdout.write(tok.export_vocab_text())
    return 0


def cmd_inspect(args) -> int:
    with open(args.file, "rb") as f:
        data = f.read()
    from .core.model_io import read_dxft

    tokens, model, header = read_dxft(data)
    print(f"DXFT v2: vocabSize={header['vocabSize']} tokens={header['tokenCount']}")
    if model:
        print(f"embedded model: {model.vocab_size} tokens, {len(model.merges)} merges")
    print("first tokens:", tokens[:16].tolist())
    return 0


def _device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the cuda and dist backends run: the card, or the CPU")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gpu_bpe_tpu_torch", description="BPE training & tokenization on NVIDIA GPUs")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a BPE vocabulary")
    t.add_argument("files", nargs="+")
    t.add_argument("-o", "--output", default="model.json")
    t.add_argument("--vocab-size", type=int, default=4096)
    t.add_argument("--backend", choices=["cuda", "dist", "cpu"], default="cuda")
    _device_flag(t)
    t.add_argument("--byte-level", action="store_true", help="skip Unicode pre-tokenization")
    t.add_argument("--no-dedup", action="store_true")
    t.add_argument("--shuffle", action="store_true", help="paragraph shuffle at ingest")
    t.add_argument("--batch-merges", type=int, default=BATCH_MERGES)
    t.add_argument("--stream", action="store_true",
                   help="streamed ingestion (bounded host memory; auto above 1 GB)")
    t.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a torch.profiler trace of training to DIR")
    t.add_argument("--coordinator", metavar="HOST:PORT", default=None,
                   help="multi-host: torch.distributed rendezvous address "
                        "(or env GPU_BPE_TPU_COORDINATOR); forces --backend dist")
    t.add_argument("--num-processes", type=int, default=None,
                   help="multi-host: total process count (env GPU_BPE_TPU_NUM_PROCESSES)")
    t.add_argument("--process-id", type=int, default=None,
                   help="multi-host: this process's rank (env GPU_BPE_TPU_PROCESS_ID)")
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("encode", help="encode text (merge-order semantics)")
    e.add_argument("model")
    e.add_argument("text")
    e.add_argument("--greedy", action="store_true", help="use the bulk greedy path")
    e.set_defaults(fn=cmd_encode)

    d = sub.add_parser("decode", help="decode token ids to text")
    d.add_argument("model")
    d.add_argument("tokens", nargs="+")
    d.set_defaults(fn=cmd_decode)

    b = sub.add_parser("export-bin", help="tokenize files into a .bin (DXFT)")
    b.add_argument("model")
    b.add_argument("files", nargs="+")
    b.add_argument("-o", "--output", default="tokens.bin")
    b.add_argument("--backend", choices=["cuda", "cpu"], default="cuda")
    _device_flag(b)
    b.set_defaults(fn=cmd_export_bin)

    tr = sub.add_parser("export-trie", help="compile the v3 binary trie artifact")
    tr.add_argument("model")
    tr.add_argument("-o", "--output", default="model.trie")
    tr.set_defaults(fn=cmd_export_trie)

    hf = sub.add_parser("export-hf", help="export a Hugging Face tokenizer.json (byte-level BPE)")
    hf.add_argument("model")
    hf.add_argument("-o", "--output", default="tokenizer.json")
    hf.add_argument(
        "--pretok", choices=("none", "byte-level"), default="none",
        help="none = exact merge-order semantics over the whole stream; "
             "byte-level = GPT-2 pre-split regex (ecosystem standard)",
    )
    hf.set_defaults(fn=cmd_export_hf)

    v = sub.add_parser("vocab", help="dump vocabulary as text")
    v.add_argument("model")
    v.set_defaults(fn=cmd_vocab)

    i = sub.add_parser("inspect", help="inspect a .bin artifact")
    i.add_argument("file")
    i.set_defaults(fn=cmd_inspect)

    w = sub.add_parser("warmup", help="build the kernels and run the capacity ladder (one-time)")
    w.add_argument("--min-log2", type=int, default=15)
    w.add_argument("--max-log2", type=int, default=22)
    w.add_argument("--tokenize", action="store_true", help="also run the tokenizer's shape buckets")
    _device_flag(w)
    w.set_defaults(fn=cmd_warmup)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
