"""Host-to-device and device-to-host copy time per MB in the traced calls:
the entry's upload of each pass and its host copy of the ids
(``encode_bytes_greedy`` -> ``Tokenizer.encode_bytes``)."""

LAYER = "Tokenize entry"
UNIT = "ms/MB"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "tokenize_mb_per_s"
RANGES = (
    "gpu_bpe_tpu_torch.models.bpe:BPETokenizer.encode_bytes_greedy",
    "gpu_bpe_tpu_torch.ops.tokenize:Tokenizer.encode_bytes",
)
KINDS = ("memcpy_htod", "memcpy_dtoh")


def read(s):
    mb = s.counters.get("traced_bytes", 0) / 1e6
    if not mb or not s.count(kinds=KINDS):
        return None
    return 1e3 * s.device_s(kinds=KINDS) / mb
