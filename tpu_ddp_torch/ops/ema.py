"""Exponential moving average of parameters (tpu_ddp/ops/ema.py):
Polyak averaging for evaluation.

``EMA.update`` blends the live parameters into the average in f32 and
stores the result in the average's own dtype. The effective decay warms
up as ``min(decay, (1 + t) / (10 + t))``, in f32 as in the JAX package,
so early averages follow the young model rather than its random init.
The state holds a tree of tensors shaped like the parameters (dicts and
tuples, or a leaf list) and a host step count; ``update`` writes the
average in place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_ddp_torch.utils.tree import tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class EMA:
    decay: float = 0.999
    warmup: bool = True

    def init(self, params) -> dict:
        """A copy of ``params`` (detached) and a zero count."""
        copies = [p.detach().clone() for p in tree_leaves(params)]
        return {"ema": tree_unflatten(params, copies), "count": 0}

    def weights(self, count: int) -> tuple:
        """(decay, 1 - decay) of 1-based step ``count`` as the JAX update
        rounds them: in f32 under the warm-up, else each from the Python
        float."""
        if not self.warmup:
            return float(np.float32(self.decay)), float(
                np.float32(1.0 - self.decay))
        c = np.float32(count)
        d = np.minimum(np.float32(self.decay),
                       (np.float32(1.0) + c) / (np.float32(10.0) + c))
        return float(d), float(np.float32(1.0) - d)

    @torch.no_grad()
    def update(self, state: dict, params) -> dict:
        count = state["count"] + 1
        keep, take = self.weights(count)
        for e, p in zip(tree_leaves(state["ema"]), tree_leaves(params)):
            e.copy_((e.float() * keep + p.detach().float() * take)
                    .to(e.dtype))
        state["count"] = count
        return state

    @staticmethod
    def params(state: dict):
        """The averaged parameters (the model's tree, for eval)."""
        return state["ema"]
