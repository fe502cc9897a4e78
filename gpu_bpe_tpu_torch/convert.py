"""Carry state across from the JAX package as plain numpy arrays.

The tests feed both packages the identical mid-training state with these:
the reference side converts its arrays with ``np.asarray`` (nothing here
imports it), and the port builds its own stream, ``TrainState`` or, for one
rank of the data-parallel trainer, ``DistState``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .ops.ingest import SymbolStream
from .ops.train_step import TrainState
from .parallel.dist_train import DistState


def stream_from_numpy(symbols, weights, n: int, total_bytes: int) -> SymbolStream:
    return SymbolStream(
        symbols=np.asarray(symbols, np.uint32).copy(),
        weights=np.asarray(weights, np.int32).copy(),
        n=int(n),
        total_bytes=int(total_bytes),
    )


def state_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> TrainState:
    """``TrainState`` from the fields of a reference ``TrainState`` after
    ``train_batch`` (hole-free: ``extent == n`` and ``dirty == 0``), each
    given as a numpy array under its field name."""
    a = {k: np.asarray(v) for k, v in arrays.items()}
    if int(a.get("extent", a["n"])) != int(a["n"]) or int(a.get("dirty", 0)) != 0:
        raise ValueError("state has holes: convert it after train_batch's final compaction")
    dev = torch.device(device)

    def i64(x):
        return torch.as_tensor(np.asarray(x).astype(np.int64)).to(dev)

    return TrainState(
        symbols=torch.as_tensor(a["symbols"].astype(np.uint32).astype(np.int32)).to(dev),
        weights=torch.as_tensor(a["weights"].astype(np.int32)).to(dev),
        n=i64(a["n"]).reshape(()),
        next_id=i64(a["next_id"]).reshape(()),
        early_stop=i64(a["early_stop"]).reshape(()),
        merges_done=i64(a["merges_done"]).reshape(()),
        merge_log=i64(a["merge_log"].astype(np.uint32)).reshape(-1),
        cand=i64(a["cand"].astype(np.uint32)),
        cand_counts=i64(a["cand_counts"]),
        theta=i64(a["theta"]).reshape(()),
        ub_new=i64(a["ub_new"]).reshape(()),
        recounts=i64(a["recounts"]).reshape(()),
        fill=i64(a["fill"]).reshape(()),
        duals=i64(a["duals"]).reshape(()),
        pend_pair=i64(a["pend_pair"].astype(np.uint32)).reshape(()),
        pend_count=i64(a["pend_count"]).reshape(()),
        pend_cert=i64(a["pend_cert"]).reshape(()),
    )


def dist_state_from_numpy(arrays: Mapping[str, np.ndarray], rank: int, device="cuda") -> DistState:
    """Rank ``rank``'s ``DistState`` from the fields of a reference
    ``DistState`` (``symbols``/``weights`` ``[D, CAP]`` and ``n``,
    ``extent``, ``dirty`` ``[D]`` sharded by row, the rest replicated), each
    given as a numpy array under its field name. Only row ``rank`` of the
    sharded fields is taken; it must be hole-free (``extent == n``,
    ``dirty == 0``)."""
    a = {k: np.asarray(v) for k, v in arrays.items()}
    n = int(a["n"][rank])
    if int(a.get("extent", a["n"])[rank]) != n or int(a.get("dirty", np.zeros_like(a["n"]))[rank]) != 0:
        raise ValueError("shard has holes: convert it after a compaction")
    dev = torch.device(device)

    def i64(x):
        return torch.as_tensor(np.asarray(x).astype(np.int64)).to(dev)

    return DistState(
        symbols=torch.as_tensor(a["symbols"][rank].astype(np.uint32).astype(np.int32)).to(dev),
        weights=torch.as_tensor(a["weights"][rank].astype(np.int32)).to(dev),
        n=i64(n).reshape(()),
        next_id=i64(a["next_id"]).reshape(()),
        early_stop=i64(a["early_stop"]).reshape(()),
        merges_done=i64(a["merges_done"]).reshape(()),
        merge_log=i64(a["merge_log"].astype(np.uint32)).reshape(-1),
        cand=i64(a["cand"].astype(np.uint32)),
        cand_counts=i64(a["cand_counts"]),
        theta=i64(a["theta"]).reshape(()),
        ub_new=i64(a["ub_new"]).reshape(()),
        recounts=i64(a["recounts"]).reshape(()),
        fill=i64(a["fill"]).reshape(()),
        duals=i64(a["duals"]).reshape(()),
    )
