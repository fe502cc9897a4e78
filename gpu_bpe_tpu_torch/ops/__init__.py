"""Device compute of the port: ingest, the training step, bulk tokenization
and their kernels."""

from .ingest import SymbolStream, make_stream, pad_stream
from .train_step import TrainState, apply_merge_device, find_best_pair, init_state, train_batch
from .tokenize import Tokenizer
from .trainer import Trainer

__all__ = [
    "SymbolStream",
    "Tokenizer",
    "TrainState",
    "Trainer",
    "apply_merge_device",
    "find_best_pair",
    "init_state",
    "make_stream",
    "pad_stream",
    "train_batch",
]
