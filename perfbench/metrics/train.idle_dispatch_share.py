"""The share of the traced job with no operation running on the card while
the host is enqueuing the batch loop's work: the innermost open program
span is ``train.batch`` or ``train.recount`` (not a ``train.read``). Over
the traced window, as ``train.device_idle_share``; the whole split of the
idle time by innermost span goes to stderr."""

from perfbench import spans as sp

LAYER = "Device"
UNIT = "share"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_merges_per_s"
RANGES = ()
SPANS = ("train.batch", "train.recount")
sp.enable()


def read(s):
    return sp.idle_share(s, SPANS, "train.job", "train")
