"""The share of rank 0's traced job with no operation running on its card
while the host is enqueuing the data-parallel step's work: the innermost
open program span is ``train.batch``, ``train.recount`` or
``train.collective`` (not a ``train.read``, where the host waits for the
card and, through the collectives, for the other ranks). Over the traced
window, as ``train.idle_dispatch_share`` for one card; the whole split of
the idle time by innermost span goes to stderr."""

from perfbench import spans as sp

LAYER = "Device"
UNIT = "share"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_merges_per_s"
RANGES = ()
SPANS = ("train.batch", "train.recount", "train.collective")
sp.enable()


def read(s):
    return sp.idle_share(s, SPANS, "train.job", "train.dist")
