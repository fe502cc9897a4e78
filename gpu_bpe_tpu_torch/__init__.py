"""gpu_bpe_tpu_torch — the PyTorch/CUDA port of gpu_bpe_tpu.

Trains a BPE vocabulary on an NVIDIA H100 (Unicode pre-tokenization,
unique-word dedup ingest, then a device-resident merge loop) and tokenizes
text in bulk with it (greedy longest match over chunks); the hot paths run
in hand-written CUDA kernels (``ops/csrc``). ``api`` is the user-facing
surface: ``api.train`` and ``api.train_files``, ``BPETokenizer`` with
``encode_bulk``, decode, model JSON, trie and DXFT export. Entry points run
on the card unless the caller passes ``device="cpu"``. The JAX package
``gpu_bpe_tpu`` is the reference; nothing here imports it.

Layers (bottom-up):
  unicode/   the Unicode library: properties, normalization, segmentation,
             confusables, batch classify (native C++ and Python)
  pretok/    GPT-4-style word-boundary rules (string and byte paths)
  core/      CPU reference oracle: exact trainer and encoders, model IO
  trie/      trie compile and parse, binary artifacts
  ops/       device compute and its CUDA kernels: ingest, the training
             step, bulk tokenization, checkpoints, the kernel selftest
  parallel/  the data-parallel trainer on torch.distributed
  models/    trained-model wrappers (BPETokenizer)
  utils/     logging, timing
  api.py     train / encode / decode / export entry points
  cli.py     command-line interface
"""

__version__ = "0.1.0"

__all__ = [
    "BATCH_MERGES",
    "BPEModel",
    "BPETokenizer",
    "INVALID_TOKEN",
    "MAX_VOCAB",
    "PreTokenizer",
    "ReferenceTrainer",
    "SymbolStream",
    "TOKEN_MASK",
    "Tokenizer",
    "TrainConfig",
    "Trainer",
    "TrainingResult",
    "Vocab",
    "WORD_START_BIT",
    "__version__",
    "build_corpus",
    "collect_files",
    "decode",
    "encode",
    "encode_bulk",
    "export_bin",
    "export_trie",
    "load_model",
    "make_stream",
    "train",
    "train_files",
]

# where each name lives; resolved at first use (PEP 562), so that importing
# the package, or its torch-free parts such as ``unicode`` and ``pretok``,
# does not import torch
_HOMES = {
    **dict.fromkeys(["BATCH_MERGES", "INVALID_TOKEN", "MAX_VOCAB", "TOKEN_MASK", "WORD_START_BIT"], "constants"),
    **dict.fromkeys(["BPEModel", "ReferenceTrainer", "TrainingResult", "Vocab"], "core"),
    "BPETokenizer": "models",
    **dict.fromkeys(["SymbolStream", "Tokenizer", "Trainer", "make_stream"], "ops"),
    "PreTokenizer": "pretok",
    **dict.fromkeys(
        ["TrainConfig", "build_corpus", "collect_files", "decode", "encode", "encode_bulk", "export_bin",
         "export_trie", "load_model", "train", "train_files"], "api"),
}


def __getattr__(name: str):
    if name in _HOMES:
        import importlib

        return getattr(importlib.import_module(f".{_HOMES[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
