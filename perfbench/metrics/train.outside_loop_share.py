"""The share of an ``api.train`` job spent outside the trainer's own clock
(``TrainingResult.training_time_s``, which starts after the upload): host
ingest (pre-tokenizing or the byte stream, dedup), the upload and the
tokenizer build. Over every job of the window: 1 - trainer time / job wall."""

LAYER = "API entry and host ingest"
UNIT = "share"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_merges_per_s"
RANGES = (
    "gpu_bpe_tpu_torch.api:train",
    "gpu_bpe_tpu_torch.api:_byte_stream",
    "gpu_bpe_tpu_torch.pretok.pretokenizer:PreTokenizer.pre_tokenize_bytes",
    "gpu_bpe_tpu_torch.ops.ingest:make_stream",
    "gpu_bpe_tpu_torch.models.bpe:BPETokenizer.from_training_result",
)


def read(s):
    c = s.counters
    if not c.get("wall_s"):
        return None
    return 1.0 - c["train_s"] / c["wall_s"]
