"""High-level API: train / encode / decode / export (the port's counterpart
of ``gpu_bpe_tpu/api.py``), with backend selection:

* ``backend="cuda"``: device-resident training (``ops.Trainer``) on
  ``TrainConfig.device``, the card unless ``device="cpu"``;
* ``backend="cpu"``: the exact-semantics oracle (``core.ReferenceTrainer``);
* ``backend="dist"``: the data-parallel trainer (``parallel``) over the
  process group set up by ``parallel.init_multihost``, or over a group of
  this process alone on ``TrainConfig.device`` when there is none.

``train_files`` trains from files in streamed mode: the corpus is read,
pre-tokenized and deduplicated chunk by chunk (``ops.ingest.stream_paths``,
``make_stream_chunked``), so host memory stays bounded by the unique-word
mass plus two chunks, then trained on ``TrainConfig.device`` by ``backend``
"cuda" or "dist". Progress goes to the package logger (``utils.get_logger``).
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field

import numpy as np

from .core.model_io import BPEModel  # noqa: F401 (importable from here, as in the reference package)
from .core.trainer_ref import ProgressFn, ReferenceTrainer, TrainingResult, bytes_to_symbols, tag_word_boundaries
from .models.bpe import BPETokenizer
from .pretok import PreTokenizer, tag_word_boundaries_bytes
from .utils import get_logger, log_progress
from .utils.timing import span

logger = get_logger()


@dataclass
class TrainConfig:
    """Training configuration."""

    vocab_size: int = 4096
    backend: str = "cuda"  # cuda | cpu | dist
    device: str = "cuda"  # where backends "cuda" and "dist" run: the card, or "cpu"
    pre_tokenize: bool = True  # Unicode word boundaries (else the byte heuristic, no dedup)
    dedup: bool = True  # unique-word multiset (exact, faster)
    shuffle: bool = False  # paragraph shuffle at ingest
    batch_merges: int = 1024  # merges per host round trip (BATCH_MERGES cap)
    seed: int = 0
    show_progress: bool = True
    profile_dir: str | None = None  # capture a torch.profiler trace of training
    extra: dict = field(default_factory=dict)  # unused, as in the reference package


# Extensions taken as text when a directory is expanded
TEXT_EXTENSIONS = frozenset(
    "txt md markdown rst json jsonl csv tsv xml yaml yml toml html htm css "
    "py js mjs ts tsx jsx swift rs go c h cpp hpp cc java kt kts scala rb "
    "php pl lua sh bash zsh fish sql r jl zig wgsl glsl hlsl tex bib srt "
    "vtt log".split()
)


def collect_files(paths: list[str]) -> list[str]:
    """Expand files and directories into a sorted list of text-file paths:
    directories recursively with the text extension filter, named files
    always."""
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs.sort()  # machine-independent traversal order
                for name in sorted(names):
                    ext = name.rsplit(".", 1)[-1].lower() if "." in name else ""
                    if ext in TEXT_EXTENSIONS:
                        out.append(os.path.join(root, name))
        else:
            out.append(p)
    return out


def build_corpus(files: list[bytes], shuffle: bool = False, seed: int = 0) -> bytes:
    """Concatenate file contents with \\n\\n separators; optional paragraph
    shuffle."""
    corpus = b"\n\n".join(bytes(f) for f in files)
    if shuffle:
        paragraphs = [p for p in corpus.split(b"\n\n") if p]
        rng = np.random.default_rng(seed)
        rng.shuffle(paragraphs)
        corpus = b"\n\n".join(paragraphs)
    return corpus


def train(
    corpus: bytes | str | list[bytes],
    config: TrainConfig | None = None,
    on_progress: ProgressFn | None = None,
) -> tuple[BPETokenizer, TrainingResult]:
    """Train a BPE tokenizer. Returns (tokenizer, full training result)."""
    config = config or TrainConfig()
    _check_backend(config)
    if isinstance(corpus, list):
        corpus = build_corpus(corpus, config.shuffle, config.seed)
    if isinstance(corpus, str):
        corpus = corpus.encode("utf-8")

    if on_progress is None and config.show_progress:
        on_progress = log_progress

    with _profile_ctx(config), span("train.job") as job:
        if config.pre_tokenize:
            with span("train.pretokenize") as sp:
                sp.note(bytes=len(corpus))
                data, starts = PreTokenizer().pre_tokenize_bytes(corpus)
        else:
            data, starts = corpus, None
        result = _train_backend(config, data, starts, on_progress)
        with span("train.build"):
            tokenizer = BPETokenizer.from_training_result(
                result, backend="cpu" if config.backend == "cpu" else "cuda", device=config.device)
        job.note(merges=len(result.merges), symbols=len(data))
    return tokenizer, result


def _check_backend(config: TrainConfig) -> None:
    if config.backend not in ("cuda", "cpu", "dist"):
        raise ValueError(f"backend must be 'cuda', 'cpu' or 'dist', got {config.backend!r}")


def train_files(
    paths: list[str],
    config: TrainConfig | None = None,
    on_progress: ProgressFn | None = None,
    chunk_bytes: int = 64 << 20,
) -> tuple[BPETokenizer, TrainingResult]:
    """Streamed training from files (directories expand as in
    ``collect_files``): host memory stays bounded by the unique-word mass
    plus two chunks of ``chunk_bytes``, so corpora of many GB ingest without
    the whole corpus in memory. The stream, hence the merge list, is the one
    ``train`` makes of the same files.

    The job's root span ``train.job`` (``bytes``: corpus bytes, ``symbols``:
    the stream's unique-word symbols, ``merges``) holds the streamed ingest
    (``train.ingest``) as well as the training and the tokenizer build.

    Streamed mode needs the whole pipeline of word boundaries and dedup on
    the device backends; paragraph shuffle (which needs the whole corpus),
    byte-level and no-dedup streams, and ``backend="cpu"`` go through
    ``train``."""
    config = config or TrainConfig()
    _check_backend(config)
    if config.shuffle or not config.pre_tokenize or not config.dedup or config.backend == "cpu":
        files = []
        for p in collect_files(paths):
            with open(p, "rb") as f:
                files.append(f.read())
        return train(files, config, on_progress)

    from .ops.ingest import make_stream_chunked, stream_paths
    from .ops.trainer import resolve_device

    device = resolve_device(config.device)
    if on_progress is None and config.show_progress:
        on_progress = log_progress
    with _profile_ctx(config), span("train.job") as job:
        stream = make_stream_chunked(stream_paths(collect_files(paths), chunk_bytes))
        logger.info("streamed ingest: %d unique-word symbols from %d corpus bytes (%.1fx dedup)",
                    stream.n, stream.total_bytes, stream.dedup_ratio)
        if config.backend == "dist":
            from .parallel import DistributedTrainer, one_rank_group

            with one_rank_group(device) as group:
                trainer = DistributedTrainer(group, batch_merges=config.batch_merges)
                result = trainer.train_stream(stream, config.vocab_size, on_progress)
        else:
            from .ops import Trainer

            trainer = Trainer(batch_merges=config.batch_merges, device=device)
            result = trainer.train_stream(stream, config.vocab_size, on_progress)
        with span("train.build"):
            tokenizer = BPETokenizer.from_training_result(result, backend="cuda", device=config.device)
        job.note(bytes=stream.total_bytes, symbols=stream.n, merges=len(result.merges))
    return tokenizer, result


@contextlib.contextmanager
def _profile_ctx(config: TrainConfig):
    """A torch.profiler trace of the job written to ``profile_dir`` (view
    with TensorBoard or chrome://tracing); tracing is on meanwhile, so the
    trace names the program's spans beside the kernels. Where tracing was
    off, it is off again afterwards and the job's spans are dropped."""
    if not config.profile_dir:
        yield
        return
    import torch

    from .utils import timing

    acts = [torch.profiler.ProfilerActivity.CPU]
    if config.backend != "cpu" and config.device != "cpu":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    logger.info("capturing a torch.profiler trace to %s", config.profile_dir)
    was_on = timing.enable()
    kept = len(timing.spans())
    try:
        with torch.profiler.profile(
            activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(config.profile_dir),
        ):
            yield
    finally:
        if not was_on:
            timing.disable()
            timing.clear(kept)


def _train_backend(config: TrainConfig, data, starts, on_progress) -> TrainingResult:
    if config.backend == "cpu":
        symbols = bytes_to_symbols(data)
        if starts is not None:
            symbols = tag_word_boundaries(symbols, starts)
        else:
            symbols = tag_word_boundaries_bytes(symbols)
        return ReferenceTrainer().train(symbols, config.vocab_size, on_progress)

    if config.backend == "dist":
        from .ops.trainer import resolve_device
        from .parallel import DistributedTrainer, one_rank_group

        with one_rank_group(resolve_device(config.device)) as group:
            trainer = DistributedTrainer(group, batch_merges=config.batch_merges)
            return trainer.train(data, starts, config.vocab_size, config.dedup, on_progress)

    from .ops import Trainer

    trainer = Trainer(batch_merges=config.batch_merges, device=config.device)
    if starts is None:
        return trainer.train_stream(_byte_stream(data), config.vocab_size, on_progress)
    return trainer.train(data, starts, config.vocab_size, config.dedup, on_progress)


def _byte_stream(data: bytes):
    """The stream trained without pre-tokenization: byte-heuristic word
    starts, one symbol per byte, weight 1, no dedup."""
    from .ops import SymbolStream

    with span("train.byte_stream") as sp:
        symbols = tag_word_boundaries_bytes(bytes_to_symbols(data))
        sp.note(symbols=len(symbols))
    return SymbolStream(symbols=symbols, weights=np.ones(len(symbols), np.int32), n=len(symbols),
                        total_bytes=len(symbols))


def load_model(path: str, backend: str = "cuda", device: str = "cuda") -> BPETokenizer:
    return BPETokenizer.load(path, backend=backend, device=device)


def encode(tokenizer: BPETokenizer, text: str) -> list[int]:
    """Interactive encode: exact merge-order BPE semantics."""
    return tokenizer.encode(text)


def encode_bulk(tokenizer: BPETokenizer, data: bytes) -> np.ndarray:
    """Bulk greedy tokenization (chunked longest match)."""
    return tokenizer.encode_bytes_greedy(data)


def decode(tokenizer: BPETokenizer, tokens) -> str:
    return tokenizer.decode_text(tokens)


def export_bin(tokenizer: BPETokenizer, data: bytes, path: str | None = None) -> bytes:
    blob = tokenizer.export_bin(data)
    if path:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def export_trie(tokenizer: BPETokenizer, path: str | None = None) -> bytes:
    blob = tokenizer.compile_trie()
    if path:
        with open(path, "wb") as f:
            f.write(blob)
    return blob
