"""SGD with momentum and weight decay, torch semantics (tpu_ddp/ops/optim.py
``SGD``; reference part1/main.py:124-125)::

    g   <- grad + weight_decay * param
    buf <- momentum * buf + g
    p   <- p - lr * buf

The JAX optimizer is a pure pytree transform; here :meth:`SGD.apply`
updates the parameters and the momentum in place, which saves a copy of
both per step. Momentum starts at zero. ``use_pallas`` routes the update
to the fused kernel (``ops/sgd.py:fused_sgd_step``, one launch over all
leaves); otherwise the same arithmetic runs leaf by leaf in PyTorch.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_ddp_torch.ops import sgd as _sgd


@dataclasses.dataclass(frozen=True)
class SGD:
    learning_rate: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    use_pallas: bool = False

    def __post_init__(self):
        if callable(self.learning_rate):
            raise NotImplementedError(
                "scheduled learning rates are not ported to tpu_ddp_torch "
                "yet (ROADMAP Queue 1 item 9.1)")

    def init(self, params) -> dict:
        return {"momentum": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def apply(self, params, grads, state: dict) -> dict:
        """One update of ``params`` and ``state["momentum"]``, in place;
        returns ``state``."""
        step = (_sgd.fused_sgd_step if self.use_pallas
                else _sgd.fused_sgd_step_ref)
        step(params, grads, state["momentum"], lr=self.learning_rate,
             momentum=self.momentum, weight_decay=self.weight_decay)
        return state
