"""Host core of the port: vocabulary registry and the training result schema."""

from .trainer_ref import ProgressFn, TrainingResult, bytes_to_symbols, tag_word_boundaries
from .vocab import Vocab, bytes_to_display_string

__all__ = [
    "ProgressFn",
    "TrainingResult",
    "Vocab",
    "bytes_to_display_string",
    "bytes_to_symbols",
    "tag_word_boundaries",
]
