"""Optimizers of tpu_ddp/ops/optim.py: SGD (the VGG ladder), AdamW and
Adafactor (the LM trainer), global-norm clipping and ``warmup_cosine``.

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

A ``learning_rate`` may be a schedule, any callable ``step (f32, 1-based)
-> lr`` such as :func:`warmup_cosine`, evaluated at the state's own
count, so a resumed run continues the schedule. AdamW and Adafactor keep
that count on the host (an int: the LM trainer has no step guard);
scheduled SGD keeps it on the device (a 0-d int32 tensor), where the step
guard's flag can hold it back without a host read. The per-step scalars
are computed in f32, as the JAX package computes them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from tpu_ddp_torch.ops import sgd as _sgd

_F32 = np.float32


@dataclasses.dataclass(frozen=True)
class SGD:
    # Float, or a schedule ``step (f32, 1-based) -> lr``: scheduled SGD
    # carries a step count in its state and runs the plain update (the
    # kernel takes a static lr).
    learning_rate: Any = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    use_pallas: bool = False

    def __post_init__(self):
        if callable(self.learning_rate) and self.use_pallas:
            raise ValueError("use_pallas SGD takes a static lr; "
                             "scheduled learning rates use the plain path")

    def init(self, params) -> dict:
        state = {"momentum": [torch.zeros_like(p) for p in params]}
        if callable(self.learning_rate):
            state["count"] = torch.zeros((), dtype=torch.int32,
                                         device=params[0].device)
        return state

    @torch.no_grad()
    def apply(self, params, grads, state: dict, skip=None) -> dict:
        """One update of ``params`` and ``state["momentum"]``, in place;
        returns ``state``. ``skip``: the step guard's 0-d device flag
        (nonzero leaves both as they were, the count too; ops/sgd.py)."""
        lr = self.learning_rate
        if callable(lr):
            count = state["count"] + 1
            lr = lr(count.float())
            state["count"] = (count if skip is None
                              else count - (skip != 0).to(torch.int32))
        step = (_sgd.fused_sgd_step if self.use_pallas
                else _sgd.fused_sgd_step_ref)
        step(params, grads, state["momentum"], lr=lr,
             momentum=self.momentum, weight_decay=self.weight_decay,
             skip=skip)
        return state


def _host_lr(learning_rate, count: int):
    """A static lr as it is, or the schedule at 1-based ``count`` (f32)
    as a Python float."""
    if callable(learning_rate):
        return float(learning_rate(_F32(count)))
    return learning_rate


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

    learning_rate: Any = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

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
        c = _F32(count)
        bc1 = float(_F32(1.0) - _F32(self.b1) ** c)
        bc2 = float(_F32(1.0) - _F32(self.b2) ** c)
        lr = _host_lr(self.learning_rate, count)
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
        torch._foreach_add_(params, upd, alpha=-lr)
        state["count"] = count
        return state


@dataclasses.dataclass(frozen=True)
class Adafactor:
    """Adafactor (Shazeer & Stern, arXiv:1804.04235), the JAX package's
    variant term for term: a matrix leaf keeps its second moment factored
    as per-row and per-column MEANS of the EMA'd g^2 (``vr``, ``vc``),
    reconstructed as ``vr[i] * vc[j] / mean_i(vr)`` without forming the
    matrix; other leaves keep a full ``v``. Update clipping by RMS
    (``clip_threshold``), the decay ``beta2_t = 1 - t^-decay_rate`` and,
    when ``learning_rate`` is None, the relative step size
    ``min(1e-2, 1/sqrt(t)) * max(eps2, RMS(param))``. ``b1`` adds a first
    moment of the clipped update.

    The state is the JAX layout, leaf lists in parameter order: ``vr``,
    ``vc``, ``v`` and ``mu`` hold a ``(1,)`` f32 zero where a leaf does
    not use the slot, so a checkpoint restores in either package. Bare
    Adafactor only: the per-cell and ZeRO wrappers of
    tpu_ddp/parallel/zero.py come with tensor parallelism and ZeRO
    (ROADMAP Queue 1 items 10.6 and 9.4).
    """

    learning_rate: Any = None       # None -> relative step size schedule
    min_dim_size_to_factor: int = 128
    decay_rate: float = 0.8
    eps1: float = 1e-30             # regularizer inside sqrt
    eps2: float = 1e-3              # RMS(param) floor for relative steps
    clip_threshold: float = 1.0
    b1: float | None = None         # optional first moment
    weight_decay: float = 0.0

    def plan(self, shape):
        """How a leaf of ``shape`` factors: ``("batch", None)`` over its
        last two dims (batched over any leading ones), ``("split", k)``
        as the 2-D view (prod(shape[:k]), prod(shape[k:])) with the
        smallest vr + vc among the splits that qualify, or None (a full
        second moment). The JAX package's ``_plan``."""
        m = self.min_dim_size_to_factor
        if len(shape) >= 2 and min(shape[-2:]) >= m:
            return ("batch", None)
        if len(shape) > 2:
            best = None
            for k in range(1, len(shape)):
                r, c = math.prod(shape[:k]), math.prod(shape[k:])
                if min(r, c) >= m and (best is None or r + c < best[0]):
                    best = (r + c, k)
            if best is not None:
                return ("split", best[1])
        return None

    def view_shape(self, shape) -> tuple:
        """The shape the factoring runs over: the leaf's own under the
        "batch" plan, the 2-D split view under "split"."""
        plan = self.plan(shape)
        if plan is None or plan[0] == "batch":
            return tuple(shape)
        k = plan[1]
        return (math.prod(shape[:k]), math.prod(shape[k:]))

    def slot_shapes(self, shape) -> dict:
        """Each state slot's shape for a leaf of ``shape``."""
        one = (1,)
        if self.plan(shape) is None:
            vr = vc = one
            v = tuple(shape)
        else:
            view = self.view_shape(shape)
            vr, vc, v = view[:-1], view[:-2] + view[-1:], one
        return {"vr": vr, "vc": vc, "v": v,
                "mu": tuple(shape) if self.b1 is not None else one}

    def init(self, params) -> dict:
        state = {k: [] for k in ("vr", "vc", "v", "mu")}
        for p in params:
            for k, shape in self.slot_shapes(tuple(p.shape)).items():
                dt = p.dtype if k == "mu" and shape == tuple(p.shape) \
                    else torch.float32
                state[k].append(torch.zeros(shape, dtype=dt,
                                            device=p.device))
        state["count"] = 0
        return state

    @staticmethod
    def decay_mask(params) -> list:
        return [p.dim() >= 2 for p in params]

    def schedule_terms(self, count: int):
        """(beta2_t, rho, lr) for 1-based ``count``, in f32: rho is the
        relative step's min(1e-2, 1/sqrt(t)) (None with an explicit lr),
        lr None under the relative step."""
        c = _F32(count)
        beta2t = _F32(1.0) - c ** _F32(-self.decay_rate)
        if self.learning_rate is None:
            rho = np.minimum(_F32(1e-2), _F32(1.0) / np.sqrt(c))
            return beta2t, rho, None
        return beta2t, None, _host_lr(self.learning_rate, count)

    @torch.no_grad()
    def apply(self, params, grads, state: dict) -> dict:
        """One update of every leaf and its slots, in place; returns
        ``state`` with the count advanced."""
        count = state["count"] + 1
        beta2t, rho, lr = self.schedule_terms(count)
        decay = self.decay_mask(params)
        for i, (p, g) in enumerate(zip(params, grads)):
            self._leaf_update(p, g, state, i, decay[i], beta2t, rho, lr)
        state["count"] = count
        return state

    def _leaf_update(self, p, g, state, i, dk, beta2t, rho, lr):
        b2, omb2 = float(beta2t), float(_F32(1.0) - beta2t)
        g32 = g.float()
        g2 = g32.square().add_(self.eps1)
        if self.plan(tuple(p.shape)) is not None:
            view = self.view_shape(tuple(p.shape))
            g2v = g2.view(view)
            vr, vc = state["vr"][i], state["vc"][i]
            vr.mul_(b2).add_(g2v.mean(dim=-1), alpha=omb2)
            vc.mul_(b2).add_(g2v.mean(dim=-2), alpha=omb2)
            r = vr / vr.mean(dim=-1, keepdim=True)
            u = (g32.view(view) * torch.rsqrt(r)[..., :, None]
                 * torch.rsqrt(vc)[..., None, :]).view(p.shape)
        else:
            v = state["v"][i]
            v.mul_(b2).add_(g2, alpha=omb2)
            u = g32 * torch.rsqrt(v)
        del g2
        rms_u = u.square().mean().sqrt()
        u = u / torch.clamp_min(rms_u / self.clip_threshold, 1.0)
        if lr is None:
            rms_p = p.float().square().mean().sqrt()
            alpha = float(rho) * torch.clamp_min(rms_p, self.eps2)
        else:
            alpha = lr
        if self.b1 is not None:
            mu = state["mu"][i]
            mu.mul_(self.b1).add_(u.to(p.dtype), alpha=1 - self.b1)
            step = mu
        else:
            step = u
        upd = alpha * step
        if dk and self.weight_decay:
            upd = upd + (alpha * self.weight_decay) * p
        p.sub_(upd.to(p.dtype))


def global_sq_norm(grads) -> torch.Tensor:
    """The f32 sum of squares over every leaf: a 0-d tensor on the
    leaves' device (no host read)."""
    return torch.stack([g.float().square().sum() for g in grads]).sum()


def clip_scale_from_sq(sq, clip_norm: float):
    """Gradient scale for global-norm clipping from the squared sum:
    ``min(1, clip / (||g|| + 1e-12))``, a 0-d f32 device tensor (the JAX
    package's one definition). A non-finite sum gives a non-finite
    scale, as in JAX; the step guard reads the gradients before it."""
    num = torch.full_like(sq, clip_norm)
    return torch.clamp_max(num / (torch.sqrt(sq) + 1e-12), 1.0)


def clip_tree(grads, scale):
    """Scale every leaf by the 0-d ``scale`` in place, each keeping its
    dtype; returns ``grads``."""
    torch._foreach_mul_(grads, scale)
    return grads


def clip_by_global_norm(grads, clip_norm: float):
    """``clip_tree(grads, clip_scale_from_sq(global_sq_norm(grads)))``:
    torch.nn.utils.clip_grad_norm_ semantics, in place."""
    return clip_tree(grads, clip_scale_from_sq(global_sq_norm(grads),
                                               clip_norm))


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    """Linear warmup to ``peak_lr``, then cosine decay to ``floor`` at
    ``total_steps``. Returns ``step (1-based) -> lr`` in f32: on a tensor
    step a 0-d tensor on its device (scheduled SGD's device count), on a
    number a numpy f32 (the host counts of AdamW and Adafactor)."""
    if not 0 < warmup_steps < total_steps:
        raise ValueError(f"need 0 < warmup_steps={warmup_steps} < "
                         f"total_steps={total_steps}")
    # The JAX schedule's constants as its f32 arithmetic sees them.
    peak, lo, w = _F32(peak_lr), _F32(floor), _F32(warmup_steps)
    span = _F32(total_steps - warmup_steps)
    coef = _F32((peak_lr - floor) * 0.5)

    def schedule(step):
        if isinstance(step, torch.Tensor):
            step = step.float()
            warm = float(peak) * step / float(w)
            frac = torch.clamp((step - float(w)) / float(span), 0.0, 1.0)
            cos = float(lo) + float(coef) * (1 + torch.cos(math.pi * frac))
            return torch.where(step < float(w), warm, cos)
        step = _F32(step)
        frac = np.clip((step - w) / span, _F32(0.0), _F32(1.0))
        if step < w:
            return peak * step / w
        return lo + coef * (_F32(1.0) + np.cos(_F32(np.pi) * frac))

    return schedule
