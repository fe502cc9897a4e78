"""Device compute of the port: ingest, the training step, bulk tokenization
and their kernels."""

from .ingest import SymbolStream, make_stream, pad_stream
from .train_step import TrainState, init_state, train_batch
from .tokenize import Tokenizer
from .trainer import Trainer

__all__ = [
    "SymbolStream",
    "Tokenizer",
    "TrainState",
    "Trainer",
    "init_state",
    "make_stream",
    "pad_stream",
    "train_batch",
]
