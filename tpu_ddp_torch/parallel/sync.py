"""The gradient-synchronization rungs of the ladder (tpu_ddp/parallel/
sync.py), acting in place on a model's ``.grad`` tensors.

=========  ======================================  =========================
strategy   reference                               here
=========  ======================================  =========================
none       part1: no sync                          identity
gather_    part2a ``sync_gradients``: rank 0       per leaf ``dist.gather``
scatter    gathers each grad, means, scatters      to rank 0, mean there,
           the mean back (part2a/main.py:97-115)   ``dist.scatter`` back
all_reduce part2b: per-param ``all_reduce(SUM)``   the same, then ``/= ws``
           then ``grad /= ws`` (part2b:97-103)
fused      part3 ``DDP(model)`` (part3/main.py:    ``DistributedData-
           174), 25 MB buckets                     Parallel(bucket_cap_mb=
                                                   25)``; the hook is the
                                                   identity, DDP syncs
                                                   inside backward
zero       part4 (beyond the reference): ZeRO-1    identity: the optimizer
           sharded optimizer state                 wrapper's reduce-scatter
                                                   is the sync
                                                   (parallel/zero.py ZeRO1)
fsdp       part5: FSDP / ZeRO-3 sharded params     identity: the backward of
                                                   the parameter all-gather
                                                   reduce-scatters (ZeRO3)
=========  ======================================  =========================

Every rung leaves the mean of the replicas' gradients on every replica
(the ladder's invariant, report §2.2); they differ in who sums and in
what order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def sync_none(grads):
    """part1: single device, no synchronization."""
    return grads


def sync_gather_scatter(grads):
    """part2a: per leaf, rank 0 gathers every replica's grad, takes the
    mean and scatters it back; every replica applies the root's mean."""
    world = dist.get_world_size()
    root = dist.get_rank() == 0
    for g in grads:
        bufs = [torch.empty_like(g) for _ in range(world)] if root else None
        dist.gather(g, gather_list=bufs, dst=0)
        mean = torch.stack(bufs).mean(0) if root else None
        dist.scatter(g, scatter_list=[mean] * world if root else None,
                     src=0)
    return grads


def sync_all_reduce(grads):
    """part2b: per leaf ``all_reduce(SUM)``, then divide by the world."""
    world = dist.get_world_size()
    for g in grads:
        dist.all_reduce(g, op=dist.ReduceOp.SUM)
        g /= world
    return grads


def sync_fused(grads):
    """part3: ``DistributedDataParallel`` already averaged the grads
    inside backward (the trainer wraps the model)."""
    return grads


SYNC_STRATEGIES = {
    "none": sync_none,
    "gather_scatter": sync_gather_scatter,
    "all_reduce": sync_all_reduce,
    "fused": sync_fused,
    # ZeRO's reduce-scatter IS the sync: the grads enter the optimizer
    # wrapper unsynced (train/engine.py), so the grads->grads hook is the
    # identity, as in the JAX package.
    "zero": sync_none,
    # FSDP: the gradient reduce-scatter is the backward of the forward's
    # parameter all-gather, so the hook is again the identity.
    "fsdp": sync_none,
}

PART_TO_STRATEGY = {
    "part1": "none",
    "part2a": "gather_scatter",
    "part2b": "all_reduce",
    "part3": "fused",
    "part4": "zero",
    "part5": "fsdp",
}


def canonical_strategy(name: str) -> str:
    """Resolve a part alias ('part3') to its strategy name ('fused')."""
    if name in PART_TO_STRATEGY:
        return PART_TO_STRATEGY[name]
    if name.startswith("part"):
        raise ValueError(
            f"unknown part alias {name!r}; available parts: "
            f"{sorted(PART_TO_STRATEGY)}")
    return name


def get_sync_strategy(name: str):
    key = canonical_strategy(name)
    try:
        return SYNC_STRATEGIES[key]
    except KeyError:
        raise ValueError(
            f"unknown sync strategy {name!r}; available: "
            f"{sorted(SYNC_STRATEGIES)} or parts {sorted(PART_TO_STRATEGY)}"
        ) from None
