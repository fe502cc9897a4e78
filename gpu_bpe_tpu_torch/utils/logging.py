"""Logging and the reference's progress schema.

Training reports progress as dicts {mergeIndex, totalMerges, mergeString,
bestCount, symbolCount, mergesPerSecond}; ``log_progress`` renders one with
merges/s and, past 256 merges, an ETA. In a multi-process run only rank 0
prints.
"""

from __future__ import annotations

import logging
import sys

from .timing import format_duration

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def get_logger(name: str = "gpu_bpe_tpu_torch", level: int = logging.INFO) -> logging.Logger:
    """The package's logger, with a stderr handler the first time (the
    modules' ``logging.getLogger(__name__)`` loggers are its children)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
    return logger


def _is_primary_process() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def log_progress(progress: dict, logger: logging.Logger | None = None) -> None:
    """Log one progress event (merges/s, and an ETA after 256 merges)."""
    if not _is_primary_process():
        return
    logger = logger or get_logger()
    done, total, rate = progress["mergeIndex"], progress["totalMerges"], progress["mergesPerSecond"]
    eta = f" ETA {format_duration((total - done) / rate)}" if done >= 256 and rate > 0 else ""
    logger.info(
        "[%d/%d] '%s' count:%d symbols:%d (%.1f merges/s)%s", done, total, progress["mergeString"],
        progress["bestCount"], progress["symbolCount"], rate, eta,
    )
