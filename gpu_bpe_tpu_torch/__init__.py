"""gpu_bpe_tpu_torch — the PyTorch/CUDA port of gpu_bpe_tpu.

Trains a BPE vocabulary on an NVIDIA H100 (unique-word dedup ingest, then a
device-resident merge loop) and tokenizes text in bulk with it (greedy
longest match over chunks); the hot paths run in hand-written CUDA kernels
(``ops/csrc``). Entry points run on the card unless the caller
passes ``device="cpu"``. The JAX package ``gpu_bpe_tpu`` is the reference;
nothing here imports it.
"""

from .core import TrainingResult, Vocab
from .ops import SymbolStream, Tokenizer, Trainer, make_stream

__all__ = ["SymbolStream", "Tokenizer", "Trainer", "TrainingResult", "Vocab", "make_stream"]
