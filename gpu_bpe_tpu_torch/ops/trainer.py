"""BPE trainer: host orchestration around the device batch step.

Counterpart of ``gpu_bpe_tpu.ops.trainer.TPUTrainer``: per batch of up to
``BATCH_MERGES`` merges, one packed merge-log read, CPU vocab
reconstruction and a progress callback with the reference's schema;
capacities live on a power-of-two ladder and shrink as the stream compacts.
With ``checkpoint_path`` the trainer writes a checkpoint every
``checkpoint_every`` batches and at the end, and resumes from one that
matches the stream (``ops/checkpoint.py``).
"""

from __future__ import annotations

import logging
import os
import time

import torch

from ..constants import BATCH_MERGES, TOKEN_MASK
from ..core.trainer_ref import ProgressFn, TrainingResult
from ..core.vocab import Vocab
from .ingest import SymbolStream, make_stream, pad_stream
from .train_step import HOST_READS, _pack_summary, init_state, train_batch

logger = logging.getLogger(__name__)

_MIN_CAP = 2048

# Recount budget per batch: the reference package's rule, with its target
# seconds per batch read from GPU_BPE_TPU_DISPATCH_TARGET_S at each batch.
# The cost per capacity element is the largest of the recount's measured on
# an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's recount_timing): 4.06
# ns with the monolithic sort at 2^20, 3.78 at 2^21, then segmented 1.15 at
# 2^22 down to 0.78 at 2^25. The budget only moves batch ends, never a merge.
_DISPATCH_TARGET_S = 12.0
_RECOUNT_S_PER_ELEM = 4.1e-9


def _recount_budget(cap: int) -> int:
    target = float(os.environ.get("GPU_BPE_TPU_DISPATCH_TARGET_S", _DISPATCH_TARGET_S))
    return max(4, int(target / (_RECOUNT_S_PER_ELEM * max(cap, 1))))


def _env_flag(name: str) -> bool:
    """The reference package's reading of a switch: set and non-empty."""
    return bool(os.environ.get(name))


def resolve_device(device: str | torch.device) -> torch.device:
    """The entry points' device: CUDA unless the caller asks for the CPU;
    asking for CUDA without a CUDA device raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class Trainer:
    """Device-resident BPE trainer with batched merge loops.

    ``force_recount=True`` recounts before every merge (the ground truth
    that the certified window must reproduce bit for bit), in either loop
    and in the loop a resumed checkpoint enters after its replay.
    ``multi_merge=True`` runs the multi-merge iteration (up to three merges
    per certificate decision, ``train_step._one_merge``). Each is read when
    the trainer is built where it is ``None``, with the reference package's
    truthiness (any non-empty value is on): ``force_recount`` from
    ``GPU_BPE_TPU_FORCE_RECOUNT``, ``multi_merge`` from ``GPU_BPE_TPU_MULTI``.
    So ``api.train``, ``api.train_files`` and the CLI follow both, and an
    explicit ``False`` wins over either variable. The data-parallel trainer
    (``parallel.DistributedTrainer``) reads neither, as in the reference
    package. The merge list is the same in every mode."""

    def __init__(
        self,
        vocab: Vocab | None = None,
        batch_merges: int = BATCH_MERGES,
        device: str | torch.device = "cuda",
        force_recount: bool | None = None,
        multi_merge: bool | None = None,
    ):
        self.vocab = vocab or Vocab()
        self.batch_merges = min(batch_merges, BATCH_MERGES)
        self.device = resolve_device(device)
        self.force_recount = _env_flag("GPU_BPE_TPU_FORCE_RECOUNT") if force_recount is None else force_recount
        self.multi_merge = _env_flag("GPU_BPE_TPU_MULTI") if multi_merge is None else multi_merge

    def train_stream(
        self,
        stream: SymbolStream,
        target_vocab_size: int = 4096,
        on_progress: ProgressFn | None = None,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 8,  # batches (1024 merges at the default batch)
    ) -> TrainingResult:
        """Train ``stream`` to ``target_vocab_size``. With
        ``checkpoint_path``: a checkpoint there whose corpus fingerprint
        matches the stream is resumed when the trainer's vocab is fresh
        (anything else is ignored with a warning), and one is written every
        ``checkpoint_every`` batches and at the end."""
        if stream.n == 0:
            raise ValueError("No symbols to train on — corpus is empty after pre-processing")
        if stream.total_bytes >= 2**31:
            logger.info(
                "corpus mass %d exceeds 2^31: exact while every single "
                "pair's mass stays < 2^31", stream.total_bytes,
            )

        merges: list[tuple[int, int, int]] = []
        merge_counts: list[int] = []
        fingerprint = None
        state = None
        if checkpoint_path and os.path.exists(checkpoint_path):
            from .checkpoint import TrainingCheckpoint, fingerprint_stream, resume_stream

            ckpt = TrainingCheckpoint.load(checkpoint_path)
            fingerprint = fingerprint_stream(stream)
            if ckpt.corpus_fingerprint == fingerprint and self.vocab.size == 256:
                state, self.vocab = resume_stream(stream, ckpt, strict=False, device=self.device)
                merges, merge_counts = list(ckpt.merges), list(ckpt.merge_counts)
                logger.info("resumed from %s at %d merges", checkpoint_path, len(merges))
            else:
                logger.warning("checkpoint %s does not match the corpus or the vocab; ignoring it", checkpoint_path)
        if state is None:
            padded = pad_stream(stream)
            state = init_state(
                padded.symbols, padded.weights, stream.n, self.vocab.next_token_id, self.device,
            )
        merges_needed = max(target_vocab_size - self.vocab.size, 0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # upload outside the clock
        start = time.perf_counter()
        total_done = 0
        early_stop = False
        recounts_total = 0
        duals_total = 0
        batches_run = 0

        def write_checkpoint():
            from .checkpoint import TrainingCheckpoint, fingerprint_stream

            nonlocal fingerprint
            if fingerprint is None:
                fingerprint = fingerprint_stream(stream)
            TrainingCheckpoint(
                merges=merges, merge_counts=merge_counts, next_token_id=self.vocab.next_token_id,
                corpus_fingerprint=fingerprint, target_vocab_size=target_vocab_size,
            ).save(checkpoint_path)

        while total_done < merges_needed and not early_stop:
            batch = min(self.batch_merges, merges_needed - total_done)
            cap = state.symbols.shape[0]
            state = train_batch(state, batch, _recount_budget(cap), self.force_recount, self.multi_merge)
            packed = _pack_summary(state).cpu().numpy()  # the batch's one log read
            HOST_READS["summary"] += 1
            log = packed[: BATCH_MERGES * 3].reshape(BATCH_MERGES, 3)
            duals_total, merges_done, n_now, early, recounts_total = (int(x) for x in packed[-5:])
            early_stop = bool(early)

            for i in range(merges_done):
                pair, new_id, count = int(log[i, 0]), int(log[i, 1]), int(log[i, 2])
                a, b = pair >> 16, pair & TOKEN_MASK
                got = self.vocab.add_merge(a, b)
                if got != new_id:
                    raise RuntimeError(f"vocab id drift: {got} != {new_id}")
                merges.append((a, b, new_id))
                merge_counts.append(count)
            total_done += merges_done

            # capacity shrink: every pass of the merge loop costs O(cap)
            new_cap = cap
            while new_cap > _MIN_CAP and n_now + 32 <= new_cap // 2:
                new_cap //= 2
            if new_cap != cap:  # the stream is hole-free and zero past n
                state.symbols = state.symbols[:new_cap].clone()
                state.weights = state.weights[:new_cap].clone()

            elapsed = time.perf_counter() - start
            if on_progress and merges_done:
                on_progress({
                    "mergeIndex": total_done,
                    "totalMerges": merges_needed,
                    "mergeString": self.vocab.strings[-1],
                    "bestCount": merge_counts[-1],
                    "symbolCount": n_now,
                    "mergesPerSecond": total_done / max(elapsed, 1e-9),
                })
            if early_stop:
                logger.info("early stop after %d merges", total_done)
            batches_run += 1
            if checkpoint_path and batches_run % checkpoint_every == 0:
                write_checkpoint()

        if checkpoint_path:
            write_checkpoint()
        elapsed = time.perf_counter() - start
        return TrainingResult(
            vocab=list(self.vocab.entries),
            vocab_strings=list(self.vocab.strings),
            vocab_size=self.vocab.size,
            merges=merges,
            merge_counts=merge_counts,
            training_time_s=elapsed,
            recounts=recounts_total,
            duals=duals_total,
        )

    def train(
        self,
        data: bytes,
        word_starts=None,
        target_vocab_size: int = 4096,
        dedup: bool = True,
        on_progress: ProgressFn | None = None,
    ) -> TrainingResult:
        """Train from pre-tokenized bytes + word-start mask."""
        stream = make_stream(data, word_starts, dedup=dedup)
        if dedup and word_starts is not None:
            logger.info(
                "dedup: %d -> %d symbols (%.1fx)", stream.total_bytes, stream.n, stream.dedup_ratio
            )
        return self.train_stream(stream, target_vocab_size, on_progress)
