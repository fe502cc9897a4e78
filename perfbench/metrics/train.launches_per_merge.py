"""Device operations (kernels, memcpys, memsets) launched inside the batch
loop (``ops/train_step.train_batch``, the recounts it runs included) per
merge in the traced job: what the loop's host dispatch enqueues."""

LAYER = "Batch loop"
UNIT = "launches/merge"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_merges_per_s"
RANGES = ("gpu_bpe_tpu_torch.ops.train_step:train_batch",)


def read(s):
    m = s.counters.get("traced_merges")
    n = s.count(within="train_batch")
    return n / m if m and n else None
