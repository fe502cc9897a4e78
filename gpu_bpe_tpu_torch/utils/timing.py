"""Human-readable durations and sizes (the port's copy of
``gpu_bpe_tpu/utils/timing.py``'s formatting)."""

from __future__ import annotations


def format_duration(seconds: float) -> str:
    """The reference's formatting: seconds below a minute, else ``Nm Ss``."""
    if seconds < 60:
        return f"{seconds:.1f}s"
    m = int(seconds // 60)
    s = round(seconds % 60)
    return f"{m}m {s}s" if s > 0 else f"{m}m"


def format_size(n_bytes: int) -> str:
    if n_bytes < 1024:
        return f"{n_bytes} B"
    if n_bytes < 1 << 20:
        return f"{n_bytes / 1024:.1f} KB"
    if n_bytes < 1 << 30:
        return f"{n_bytes / (1 << 20):.1f} MB"
    return f"{n_bytes / (1 << 30):.2f} GB"
