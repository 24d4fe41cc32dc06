"""Runtime correctness invariants (tpu_ddp/utils/invariants.py).

The reference's correctness rests on two invariants: identical
parameter init on every node, and identical updates through gradient
sync. A silent sync bug shows up only as a bad loss curve, so this module
makes the invariant checkable at run time:

- :func:`replica_divergence`: per leaf, 0 when every process holds the
  same bits and ``inf`` when any differs. Each process holds one copy
  (one device per process), so the comparison runs across processes: a
  bitwise per-leaf digest (:func:`_bitwise_digest`) is all-gathered
  (gloo on the CPU, NCCL on the card) and compared.
- :func:`check_replica_consistency`: raises
  :class:`ReplicaDivergenceError` naming the worst leaf. The trainer
  calls it every ``check_replicas_every`` steps
  (``TPU_DDP_CHECK_REPLICAS_EVERY``).
- :func:`maybe_inject_failure`: the single-knob hard exit, re-exported
  from ``resilience/chaos.py``.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from tpu_ddp_torch.resilience.chaos import (  # noqa: F401  (re-export)
    FAULT_EXIT_CODE, maybe_inject_failure)
from tpu_ddp_torch.utils.tree import keyed_leaves


class ReplicaDivergenceError(RuntimeError):
    pass


def _bitwise_digest(arr: np.ndarray) -> np.uint64:
    """First 8 bytes of sha256 over the raw array bytes: equal iff (with
    overwhelming probability) the arrays are bitwise equal; a sum would
    miss two swapped elements."""
    h = hashlib.sha256(np.ascontiguousarray(arr).tobytes()).digest()
    return np.frombuffer(h[:8], dtype=np.uint64)[0]


def replica_divergence(tree) -> dict:
    """{leaf path: divergence} over the tensor leaves of ``tree``: 0.0
    where every process of the ``torch.distributed`` group holds the same
    bits, ``inf`` where any differs (a tolerance cannot be evaluated
    without shipping whole tensors between processes). Without a group
    there is one copy, and every leaf reads 0."""
    import torch.distributed as dist
    named = [(name, leaf) for name, leaf in keyed_leaves(tree)
             if isinstance(leaf, torch.Tensor)]
    out = {name: 0.0 for name, _ in named}
    if not named or not dist.is_initialized() or dist.get_world_size() < 2:
        return out
    digests = np.array([_bitwise_digest(leaf.detach().cpu().numpy())
                        for _, leaf in named], np.uint64)
    # NCCL gathers device tensors, gloo host ones.
    dev = (named[0][1].device if dist.get_backend() == "nccl"
           else torch.device("cpu"))
    mine = torch.from_numpy(digests.view(np.int64)).to(dev)
    gathered = [torch.empty_like(mine)
                for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, mine)
    table = torch.stack(gathered).cpu()
    for col, (name, _) in enumerate(named):
        if not bool((table[:, col] == table[0, col]).all()):
            out[name] = float("inf")
    return out


def check_replica_consistency(tree, atol: float = 0.0) -> dict:
    """Raise :class:`ReplicaDivergenceError` if any leaf's copies differ
    by more than ``atol``; returns the divergence map."""
    div = replica_divergence(tree)
    bad = {k: v for k, v in div.items() if v > atol}
    if bad:
        worst = max(bad, key=bad.get)
        raise ReplicaDivergenceError(
            f"replica divergence on {len(bad)} leaves; worst "
            f"{worst}: {bad[worst]:.3e} (invariant (ii) of the reference "
            f"report: replicas must hold identical parameters)")
    return div
