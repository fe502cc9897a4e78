"""Host core of the port: vocabulary registry, the training result schema and
the greedy encoder reference."""

from .encoder_ref import GreedyTrieEncoder, decode_tokens
from .trainer_ref import ProgressFn, TrainingResult, bytes_to_symbols, tag_word_boundaries
from .vocab import Vocab, bytes_to_display_string

__all__ = [
    "GreedyTrieEncoder",
    "ProgressFn",
    "TrainingResult",
    "Vocab",
    "bytes_to_display_string",
    "bytes_to_symbols",
    "decode_tokens",
    "tag_word_boundaries",
]
