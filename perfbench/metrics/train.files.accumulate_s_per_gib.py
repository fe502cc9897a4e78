"""Seconds of the ``train.dedup`` spans inside ``train.ingest`` (each
chunk's ``StreamAccumulator.add_chunk`` into the native hash table, and its
``finish``) per GiB the traced ``api.train_files`` job ingested (the
program's counter ``INGEST["bytes"]``)."""

from perfbench import ingest_spans, spans

LAYER = "API entry and host ingest"
UNIT = "s/GiB"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_merges_per_s"
RANGES = ingest_spans.RANGES
spans.enable()


def read(s):
    return ingest_spans.s_per_gib(s, "train.dedup")
