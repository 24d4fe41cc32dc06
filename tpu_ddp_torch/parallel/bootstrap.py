"""Distributed process bootstrap (tpu_ddp/parallel/bootstrap.py; reference
part2/part2a/main.py:35-58,207) on ``torch.distributed``.

``init_distributed_setup`` joins the process group at
``tcp://master_ip:master_port`` with ``world_size`` and ``rank`` given
explicitly (the reference's MASTER_ADDR/MASTER_PORT contract; nothing is
read from a cluster environment): backend ``nccl`` on CUDA, ``gloo`` on
the CPU. A world of one process needs no rendezvous, except for
``DistributedDataParallel`` (``ddp=True``), which needs a process group.

Elastic membership (resilience/elastic.py) makes one group per
membership epoch with :func:`elastic_bootstrap` (the same backend rule, a
timeout on every collective, and under NCCL the watchdog set to abort a
failed communicator and raise, ``TORCH_NCCL_ASYNC_ERROR_HANDLING=2``
unless the environment says otherwise) and drops it with
:func:`elastic_teardown`, which aborts the communicators
(``_abort_process_group``) instead of entering a teardown a dead peer
could block.

:func:`mesh_groups` splits the world into the dp, sp, tp, pp and ep
sub-groups of sequence, tensor, pipeline and expert parallelism (the JAX
mesh's rank layout).
"""

from __future__ import annotations

import dataclasses
import os
import re
from datetime import timedelta
from typing import Any, NamedTuple

import torch
import torch.distributed as dist


@dataclasses.dataclass
class DistributedContext:
    """What the bootstrap hands to the rest of the stack."""

    rank: int
    world_size: int
    device: torch.device
    coordinator: str | None   # "tcp://ip:port" when a group was made
    backend: str              # "nccl", "gloo", or "none" without a group

    @property
    def is_initialized(self) -> bool:
        return self.coordinator is None or dist.is_initialized()


def get_rank_from_hostname(hostname: str | None = None) -> int:
    """Default rank = the digit in a ``nodeN`` hostname (reference
    part2/part2a/main.py:35-39), 0 for any other hostname."""
    if hostname is None:
        hostname = os.uname().nodename
    m = re.match(r"node(\d+)", hostname)
    return int(m.group(1)) if m else 0


def init_distributed_setup(
    master_ip: str = "10.10.1.1",
    master_port: str = "4000",
    rank: int = 0,
    world_size: int = 1,
    device=None,
    ddp: bool = False,
    timeout_s: float = 300.0,
) -> DistributedContext:
    """Join the process group and return a :class:`DistributedContext`.
    ``device`` is where this process computes (``None`` means cuda)."""
    from tpu_ddp_torch.utils.device import resolve_device
    if world_size is None:
        raise ValueError("--num-nodes is required (the reference CLI has "
                         "no default)")
    if not (0 <= rank < world_size):
        raise ValueError(
            f"rank {rank} out of range for world size {world_size}")
    dev = resolve_device(device)
    if world_size == 1 and not ddp:
        return DistributedContext(rank=0, world_size=1, device=dev,
                                  coordinator=None, backend="none")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    coordinator = f"tcp://{master_ip}:{master_port}"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # Blocks until all world_size processes join, like the reference's
    # gloo TCP rendezvous (part2/part2a/main.py:56-58).
    dist.init_process_group(backend, init_method=coordinator,
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    return DistributedContext(rank=rank, world_size=world_size, device=dev,
                              coordinator=coordinator, backend=backend)


def test_distributed_setup(ctx: DistributedContext) -> dict:
    """Print the reference's sanity probe (part2/part2a/main.py:42-49)
    and return it for tests."""
    info = {
        "is_initialized": ctx.is_initialized,
        "backend": ctx.backend,
        "world_size": ctx.world_size,
        "rank": ctx.rank,
        "num_devices": 1,
    }
    print(f"Distributed setup initialized: {info['is_initialized']}")
    print(f"Backend: {info['backend']}")
    print(f"World size: {info['world_size']}")
    print(f"Rank: {info['rank']} | devices: {info['num_devices']}")
    return info


class MeshGroups(NamedTuple):
    """This process's sub-groups of a dp x sp x tp x pp x ep world: the
    dp group (the ranks of one (s, t, p, e)), the sp group (one (d, t, p,
    e); None at sp 1), the ep group (one (d, s, t, p)), the dp x sp group
    (one (t, p, e): the replicas of an expert shard; the dp group itself
    at sp 1), the tp group (one (d, s, p, e); None at tp 1), the data
    group (one (t, p): the dp x sp x ep ranks that hold the same tensor-
    parallel slices of the same stage, over which a gradient is averaged;
    the world at tp = pp = 1) and the pp group (one (d, s, t, e): the
    stages of one pipeline; None at pp 1)."""

    dp: Any
    sp: Any
    ep: Any
    dp_sp: Any
    tp: Any = None
    data: Any = None
    pp: Any = None


def mesh_rank(d: int, s: int, e: int, sp: int = 1, ep: int = 1,
              t: int = 0, tp: int = 1, p: int = 0, pp: int = 1) -> int:
    """The rank of mesh coordinate (d, s, t, p, e): the JAX
    ``make_mesh(dp, sp, mp, pp, ep)`` reshape, ep fastest,
    ``(((d * sp + s) * tp + t) * pp + p) * ep + e`` (at pp 1,
    ``((d * sp + s) * tp + t) * ep + e``)."""
    return (((d * sp + s) * tp + t) * pp + p) * ep + e


def mesh_coords(rank: int, sp: int = 1, ep: int = 1, tp: int = 1,
                pp: int = 1) -> tuple:
    """The (d, s, e, t) coordinate of ``rank`` (:func:`mesh_rank`'s
    inverse but for the stage, which :func:`mesh_stage` gives)."""
    return (rank // (sp * tp * pp * ep), (rank // (tp * pp * ep)) % sp,
            rank % ep, (rank // (pp * ep)) % tp)


def mesh_stage(rank: int, ep: int = 1, pp: int = 1) -> int:
    """The pipeline stage p of ``rank`` in a mesh laid out as
    :func:`mesh_rank` (0 at pp 1)."""
    return (rank // ep) % pp


def mesh_groups(dp: int, ep: int, sp: int = 1, tp: int = 1,
                pp: int = 1) -> MeshGroups:
    """This process's :class:`MeshGroups` of a world of ``dp * sp * tp *
    pp * ep`` processes laid out as :func:`mesh_rank`. Every process
    makes every group, in one order, as ``new_group`` requires: the dp
    groups, the ep groups, then (at sp > 1) the sp groups and the dp x sp
    groups, then (at tp > 1) the tp groups, (at tp > 1 or pp > 1) the
    data groups and (at pp > 1) the pp groups. Every data-side group is
    made per (t, p), so that no mean crosses stages. At tp = pp = 1 no tp,
    data or pp group is made (the data group is the world), and at sp = tp
    = pp = 1 only the first two, the groups and ranks of a dp x ep
    world. A pipeline whose stages all run in each process
    (``PipelineLMTrainer(stages="in_process")``) passes pp = 1: its
    world is dp x sp x tp x ep in the same order with p dropped, and no
    pp group is made."""
    if dp * sp * tp * pp * ep != dist.get_world_size():
        raise ValueError(f"dp={dp} x sp={sp} x tp={tp} x pp={pp} x ep={ep}"
                         f" != world size {dist.get_world_size()}")
    rank = dist.get_rank()
    mine = {"sp": None, "tp": None, "pp": None, "data": dist.group.WORLD}

    def make(kind, sets):
        for ranks in sets:
            group = dist.new_group(ranks)
            if rank in ranks:
                mine[kind] = group

    def at(d, s, t, p, e):
        return mesh_rank(d, s, e, sp, ep, t, tp, p, pp)

    D, S, T, Q, E = range(dp), range(sp), range(tp), range(pp), range(ep)
    make("dp", [[at(d, s, t, p, e) for d in D]
                for s in S for t in T for p in Q for e in E])
    make("ep", [[at(d, s, t, p, e) for e in E]
                for d in D for s in S for t in T for p in Q])
    mine["dp_sp"] = mine["dp"]
    if sp > 1:
        make("sp", [[at(d, s, t, p, e) for s in S]
                    for d in D for t in T for p in Q for e in E])
        make("dp_sp", [[at(d, s, t, p, e) for d in D for s in S]
                       for t in T for p in Q for e in E])
    if tp > 1:
        make("tp", [[at(d, s, t, p, e) for t in T]
                    for d in D for s in S for p in Q for e in E])
    if tp > 1 or pp > 1:
        make("data", [sorted(at(d, s, t, p, e) for d in D for s in S
                             for e in E) for t in T for p in Q])
    if pp > 1:
        make("pp", [[at(d, s, t, p, e) for p in Q]
                    for d in D for s in S for t in T for e in E])
    return MeshGroups(mine["dp"], mine["sp"], mine["ep"], mine["dp_sp"],
                      mine["tp"], mine["data"], mine["pp"])


def shutdown(ctx: DistributedContext) -> None:
    """``dist.destroy_process_group()`` (reference
    part2/part2a/main.py:207), when a group was made."""
    if ctx.coordinator is not None and dist.is_initialized():
        dist.destroy_process_group()


#: seconds every collective of an elastic group may take.
COLLECTIVE_TIMEOUT_S = 60.0


def elastic_bootstrap(coordinator: str, world_size: int, rank: int,
                      device, timeout_s: float = COLLECTIVE_TIMEOUT_S
                      ) -> DistributedContext:
    """Join the world of one membership epoch at ``coordinator``
    (``"ip:port"``); rank 0 hosts the store. Safe after
    :func:`elastic_teardown`."""
    if dist.is_initialized():
        raise RuntimeError("a process group is up; call elastic_teardown() "
                           "before joining another")
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "2")
        torch.cuda.set_device(dev)
    init = f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init,
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    return DistributedContext(rank=rank, world_size=world_size, device=dev,
                              coordinator=init, backend=backend)


def elastic_teardown() -> None:
    """Abandon the current process group without a barrier: abort its
    communicators (``_abort_process_group``, where this PyTorch has it),
    then destroy whatever is left."""
    if not dist.is_initialized():
        return
    from torch.distributed import distributed_c10d as c10d
    abort = getattr(c10d, "_abort_process_group", None)
    if abort is not None:
        abort()
    if dist.is_initialized():
        dist.destroy_process_group()
