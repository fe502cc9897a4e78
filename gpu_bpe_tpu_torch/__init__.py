"""gpu_bpe_tpu_torch — the PyTorch/CUDA port of gpu_bpe_tpu.

Trains a BPE vocabulary on an NVIDIA H100: unique-word dedup ingest, then a
device-resident merge loop whose hot path runs in three hand-written CUDA
kernels (``ops/csrc``). Entry points run on the card unless the caller
passes ``device="cpu"``. The JAX package ``gpu_bpe_tpu`` is the reference;
nothing here imports it.
"""

from .core import TrainingResult, Vocab
from .ops import SymbolStream, Trainer, make_stream

__all__ = ["SymbolStream", "Trainer", "TrainingResult", "Vocab", "make_stream"]
