"""Distributed trainer: the host loop around the data-parallel batch step.

The port's counterpart of ``gpu_bpe_tpu/parallel/trainer.py``, with the same
host protocol as the single-chip ``Trainer``: one packed read per batch of
up to ``BATCH_MERGES`` merges, vocab reconstruction on the host from the
replicated merge log. Every rank returns the same result; only rank 0
reports progress. The merge list equals the single-chip trainer's and the
reference's for any world size (the exact global argmax, see
``parallel/dist_train.py``).
"""

from __future__ import annotations

import time

import torch

from ..constants import BATCH_MERGES, TOKEN_MASK
from ..core.trainer_ref import ProgressFn, TrainingResult
from ..core.vocab import Vocab
from ..ops.ingest import SymbolStream, make_stream
from ..ops.trainer import resolve_device
from .dist_train import HOST_READS, dist_train_batch, init_dist_state, shard_stream
from .mesh import DataGroup


class DistributedTrainer:
    """Data-parallel BPE trainer, one shard per rank of ``group``.

    ``group`` defaults to the initialized default process group
    (``init_multihost``) on ``device``: the card of this rank unless
    ``device="cpu"``. It reads neither ``GPU_BPE_TPU_FORCE_RECOUNT`` nor
    ``GPU_BPE_TPU_MULTI``: the reference package's data-parallel path
    (``gpu_bpe_tpu/parallel/dist_train.py``) has no such read either."""

    def __init__(self, group: DataGroup | None = None, vocab: Vocab | None = None,
                 batch_merges: int = BATCH_MERGES, device: str | torch.device = "cuda"):
        self.group = group or DataGroup.current(resolve_device(device))
        self.vocab = vocab or Vocab()
        self.batch_merges = min(batch_merges, BATCH_MERGES)

    def train(
        self,
        data: bytes,
        word_starts=None,
        target_vocab_size: int = 4096,
        dedup: bool = True,
        on_progress: ProgressFn | None = None,
    ) -> TrainingResult:
        stream = make_stream(data, word_starts, dedup=dedup)
        return self.train_stream(stream, target_vocab_size, on_progress)

    def train_stream(
        self,
        stream: SymbolStream,
        target_vocab_size: int = 4096,
        on_progress: ProgressFn | None = None,
    ) -> TrainingResult:
        if stream.n == 0:
            raise ValueError("No symbols to train on — corpus is empty after pre-processing")
        g = self.group
        sym, w, n = shard_stream(stream.symbols[: stream.n], stream.weights[: stream.n], g.world_size)
        state = init_dist_state(g, sym, w, n, self.vocab.next_token_id)
        if g.device.type == "cuda":
            torch.cuda.synchronize(g.device)  # upload outside the clock
        merges: list[tuple[int, int, int]] = []
        merge_counts: list[int] = []
        merges_needed = max(target_vocab_size - self.vocab.size, 0)
        start = time.perf_counter()
        total_done = 0
        early_stop = False
        recounts_total = duals_total = 0

        while total_done < merges_needed and not early_stop:
            batch = min(self.batch_merges, merges_needed - total_done)
            state = dist_train_batch(g, state, batch)
            # one packed read per batch; the shard sizes are rank-local, so
            # the global symbol count comes out of a psum
            symbol_count = g.psum(state.n.reshape(1))
            scalars = torch.stack([state.recounts, state.duals, state.merges_done, state.early_stop])
            packed = torch.cat([state.merge_log, scalars, symbol_count]).tolist()
            HOST_READS["summary"] += 1
            log = packed[: BATCH_MERGES * 3]
            recounts_total, duals_total, merges_done, early, symbol_count = packed[-5:]
            early_stop = bool(early)
            for i in range(merges_done):
                pair, new_id, count = log[3 * i : 3 * i + 3]
                a, b = pair >> 16, pair & TOKEN_MASK
                got = self.vocab.add_merge(a, b)
                if got != new_id:
                    raise RuntimeError(f"vocab id drift: {got} != {new_id}")
                merges.append((a, b, new_id))
                merge_counts.append(count)
            total_done += merges_done

            if on_progress and merges_done and g.rank == 0:
                elapsed = time.perf_counter() - start
                on_progress({
                    "mergeIndex": total_done,
                    "totalMerges": merges_needed,
                    "mergeString": self.vocab.strings[-1],
                    "bestCount": merge_counts[-1],
                    "symbolCount": symbol_count,
                    "mergesPerSecond": total_done / max(elapsed, 1e-9),
                })

        return TrainingResult(
            vocab=list(self.vocab.entries),
            vocab_strings=list(self.vocab.strings),
            vocab_size=self.vocab.size,
            merges=merges,
            merge_counts=merge_counts,
            training_time_s=time.perf_counter() - start,
            recounts=recounts_total,
            duals=duals_total,
        )
