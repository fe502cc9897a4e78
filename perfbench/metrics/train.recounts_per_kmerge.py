"""Full recounts per 1000 merges: ``TrainingResult.recounts`` over every
job of the window."""

LAYER = "Recount"
UNIT = "recounts/kmerge"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "train_merges_per_s"
RANGES = ("gpu_bpe_tpu_torch.ops.train_step:_full_recount_impl",)


def read(s):
    c = s.counters
    return 1000.0 * c["recounts"] / c["merges"] if c.get("merges") else None
