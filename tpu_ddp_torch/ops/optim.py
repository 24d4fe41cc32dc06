"""Optimizers of tpu_ddp/ops/optim.py: SGD (the VGG ladder) and AdamW
(the LM trainer).

SGD with momentum and weight decay, torch semantics (reference
part1/main.py:124-125)::

    g   <- grad + weight_decay * param
    buf <- momentum * buf + g
    p   <- p - lr * buf

The JAX optimizers are pure pytree transforms; here ``apply`` updates the
parameters and the state in place, which saves a copy of both per step.
State starts at zero. SGD's ``use_pallas`` routes the update to the fused
kernel (``ops/sgd.py:fused_sgd_step``, one launch over all leaves);
otherwise the same arithmetic runs leaf by leaf in PyTorch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
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
    def apply(self, params, grads, state: dict, skip=None) -> dict:
        """One update of ``params`` and ``state["momentum"]``, in place;
        returns ``state``. ``skip``: the step guard's 0-d device flag
        (nonzero leaves both as they were; ops/sgd.py)."""
        step = (_sgd.fused_sgd_step if self.use_pallas
                else _sgd.fused_sgd_step_ref)
        step(params, grads, state["momentum"], lr=self.learning_rate,
             momentum=self.momentum, weight_decay=self.weight_decay,
             skip=skip)
        return state


@dataclasses.dataclass(frozen=True)
class AdamW:
    """AdamW with decoupled weight decay, term for term as the JAX
    package's::

        mu <- b1 * mu + (1 - b1) * g
        nu <- b2 * nu + (1 - b2) * g^2
        p  <- p - lr * ((mu / bc1) / (sqrt(nu / bc2) + eps) + wd * p)

    with bc_i = 1 - b_i^count in f32, the decay only on leaves of rank >= 2
    (and with the old p), f32 moments and an int step count. Not
    ``torch.optim.AdamW``, whose order of operations rounds differently.
    """

    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def __post_init__(self):
        if callable(self.learning_rate):
            raise NotImplementedError(
                "scheduled learning rates are not ported to tpu_ddp_torch "
                "yet (ROADMAP Queue 1 item 9.1)")

    def init(self, params) -> dict:
        """State for a list of parameter leaves."""
        return {"mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params], "count": 0}

    @staticmethod
    def decay_mask(params) -> list:
        return [p.dim() >= 2 for p in params]

    @torch.no_grad()
    def apply(self, params, grads, state: dict) -> dict:
        """One update of ``params``, ``state["mu"]`` and ``state["nu"]``,
        in place; returns ``state`` with the count advanced."""
        count = state["count"] + 1
        c = np.float32(count)
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** c)
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** c)
        mu, nu = state["mu"], state["nu"]
        grads = [g.to(p.dtype) for p, g in zip(params, grads)]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.b2)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        del denom
        decay = [i for i, d in enumerate(self.decay_mask(params)) if d]
        if self.weight_decay and decay:
            torch._foreach_add_([upd[i] for i in decay],
                                [params[i] for i in decay],
                                alpha=self.weight_decay)
        torch._foreach_add_(params, upd, alpha=-self.learning_rate)
        state["count"] = count
        return state
