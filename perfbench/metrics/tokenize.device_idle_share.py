"""The share of the traced calls' window in which no operation ran on the
card: 1 - the union of the device intervals over the traced window."""

LAYER = "Device"
UNIT = "share"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "tokenize_mb_per_s"
RANGES = ()


def read(s):
    if not s.window or not s.device:
        return None
    return 1.0 - s.busy_s() / s.window_s
