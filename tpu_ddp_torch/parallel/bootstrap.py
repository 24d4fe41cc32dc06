"""Distributed process bootstrap (tpu_ddp/parallel/bootstrap.py; reference
part2/part2a/main.py:35-58,207) on ``torch.distributed``.

``init_distributed_setup`` joins the process group at
``tcp://master_ip:master_port`` with ``world_size`` and ``rank`` given
explicitly (the reference's MASTER_ADDR/MASTER_PORT contract; nothing is
read from a cluster environment): backend ``nccl`` on CUDA, ``gloo`` on
the CPU. A world of one process needs no rendezvous, except for
``DistributedDataParallel`` (``ddp=True``), which needs a process group.
"""

from __future__ import annotations

import dataclasses
import os
import re
from datetime import timedelta

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


def shutdown(ctx: DistributedContext) -> None:
    """``dist.destroy_process_group()`` (reference
    part2/part2a/main.py:207), when a group was made."""
    if ctx.coordinator is not None and dist.is_initialized():
        dist.destroy_process_group()
