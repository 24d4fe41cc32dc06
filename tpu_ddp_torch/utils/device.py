"""The port's device rule: entry points run on the card unless the caller
asks for the CPU, and never drop to the CPU silently."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device without a usable card
    raises; ``"cpu"`` must be asked for. A CUDA device comes back with its
    index (``cuda`` -> ``cuda:<current>``), as process groups and
    ``DistributedDataParallel`` need it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (the default) but CUDA is not "
            "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: cuda or cpu")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
