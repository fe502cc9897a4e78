"""Device time of the recounts per job: the operations launched inside
``_full_recount_impl`` (the monolithic sort, or the segmented recount with
``compact_mask``) in the traced job."""

LAYER = "Recount"
UNIT = "ms/job"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_merges_per_s"
RANGES = ("gpu_bpe_tpu_torch.ops.train_step:_full_recount_impl",)


def read(s):
    jobs = s.counters.get("traced_jobs")
    if not jobs or not s.count(within="_full_recount_impl"):
        return None
    return 1e3 * s.device_s(within="_full_recount_impl") / jobs
