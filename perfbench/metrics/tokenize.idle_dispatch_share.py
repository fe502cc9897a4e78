"""The share of the traced calls' window with no operation running on the
card while the host is enqueuing a pass: the innermost open program span is
``tokenize.pass``, ``tokenize.match_table`` or ``tokenize.walk`` (not a
``tokenize.read``). Over the traced window, as
``tokenize.device_idle_share``; the whole split of the idle time by
innermost span goes to stderr."""

from perfbench import spans as sp

LAYER = "Device"
UNIT = "share"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "tokenize_mb_per_s"
RANGES = ()
SPANS = ("tokenize.pass", "tokenize.match_table", "tokenize.walk")
sp.enable()


def read(s):
    return sp.idle_share(s, SPANS, "tokenize.call", "tokenize")
