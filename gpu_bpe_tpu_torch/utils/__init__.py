"""Utilities: logging, progress reporting, phase timing, size and duration
formatting.

The JAX package's ``utils/compile_cache.py`` (JAX's persistent compilation
cache) has no counterpart here: the port's compiled artifacts are the
kernel and host libraries in ``gpu_bpe_tpu_torch/_build/``, built once per
tree and named by a hash of their sources (``utils/build.py``).
"""

from .logging import get_logger, log_progress
from .timing import PhaseTimer, format_duration, format_size

__all__ = ["PhaseTimer", "format_duration", "format_size", "get_logger", "log_progress"]
