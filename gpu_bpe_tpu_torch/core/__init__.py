"""Host core of the port: vocabulary registry, model I/O, the training result
schema, the CPU oracle trainer and the reference encoders."""

from .encoder_ref import GreedyTrieEncoder, decode_tokens, encode_merge_order
from .model_io import BPEModel, read_dxft, write_dxft
from .trainer_ref import (
    ProgressFn,
    ReferenceTrainer,
    TrainingResult,
    apply_merge,
    best_pair,
    bytes_to_symbols,
    count_pairs,
    merge_sites,
    tag_word_boundaries,
)
from .vocab import Vocab, bytes_to_display_string

__all__ = [
    "BPEModel",
    "GreedyTrieEncoder",
    "ProgressFn",
    "ReferenceTrainer",
    "TrainingResult",
    "Vocab",
    "apply_merge",
    "best_pair",
    "bytes_to_display_string",
    "bytes_to_symbols",
    "count_pairs",
    "decode_tokens",
    "encode_merge_order",
    "merge_sites",
    "read_dxft",
    "tag_word_boundaries",
    "write_dxft",
]
