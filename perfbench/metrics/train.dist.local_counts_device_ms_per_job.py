"""Device time of the data-parallel step's exact counting per job: the
operations launched inside ``parallel.dist_train._local_counts`` (the sort,
``searchsorted`` and ``index_add_`` that count a list of pairs on the
rank's shard, after every merge and in every recount) in the traced job on
rank 0."""

LAYER = "Data-parallel step"
UNIT = "ms/job"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_merges_per_s"
RANGES = ("gpu_bpe_tpu_torch.parallel.dist_train:_local_counts",)


def read(s):
    jobs = s.counters.get("traced_jobs")
    if not jobs or not s.count(within="_local_counts"):
        return None
    return 1e3 * s.device_s(within="_local_counts") / jobs
