"""gpu_bpe_tpu_torch — the PyTorch/CUDA port of gpu_bpe_tpu.

Trains a BPE vocabulary on an NVIDIA H100 (Unicode pre-tokenization,
unique-word dedup ingest, then a device-resident merge loop) and tokenizes
text in bulk with it (greedy longest match over chunks); the hot paths run
in hand-written CUDA kernels (``ops/csrc``). ``api`` is the user-facing
surface: ``api.train``, ``BPETokenizer`` with ``encode_bulk``, decode,
model JSON, trie and DXFT export. Entry points run on the card unless the
caller passes ``device="cpu"``. The JAX package ``gpu_bpe_tpu`` is the
reference; nothing here imports it.
"""

from .api import TrainConfig, train
from .core import BPEModel, TrainingResult, Vocab
from .models import BPETokenizer
from .ops import SymbolStream, Tokenizer, Trainer, make_stream
from .pretok import PreTokenizer

__all__ = [
    "BPEModel",
    "BPETokenizer",
    "PreTokenizer",
    "SymbolStream",
    "Tokenizer",
    "TrainConfig",
    "Trainer",
    "TrainingResult",
    "Vocab",
    "make_stream",
    "train",
]
