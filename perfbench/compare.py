"""The comparisons that decide ``correct``: how many positions of two
outputs differ."""

from __future__ import annotations

import numpy as np


def diff(got: list, want: list) -> int:
    """Positions at which two lists differ, the surplus of the longer
    counted too."""
    return sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))


def ids_diff(got, want) -> int:
    """``diff`` for arrays of token ids."""
    k = min(len(got), len(want))
    return int(np.count_nonzero(np.asarray(got[:k], np.int64) != np.asarray(want[:k], np.int64))) + abs(
        len(got) - len(want))
