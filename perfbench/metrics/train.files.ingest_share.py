"""The share of the traced ``api.train_files`` job's wall (its
``train.job`` root) spent under ``train.ingest``: reading the files,
pre-tokenizing, carrying partial words and the native dedup, before the
upload and the merge loop."""

from perfbench import ingest_spans, spans

LAYER = "API entry and host ingest"
UNIT = "share"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_merges_per_s"
RANGES = ingest_spans.RANGES
spans.enable()


def read(s):
    return ingest_spans.ingest_share(s)
