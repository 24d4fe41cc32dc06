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
count, so a resumed run continues the schedule. The count is a 0-d int32
tensor on the device (AdamW, Adafactor, scheduled SGD), advanced in
place, and every term that depends on it is read or computed from it on
the device: a step captured in a CUDA graph (train/engine.py,
train/lm.py) then takes step t's terms on every replay, and the eager
step the same bits. AdamW's bias corrections come from a table of the
host's f32 values ``1 - b**t`` (:func:`_bias_table`: every t up to
where the value rounds to 1), so they are the bits the host computes;
Adafactor's ``beta2_t`` and relative step and a scheduled lr are
computed on the device in f32. The step guard's flag can hold scheduled
SGD's count back without a host read. The JAX checkpoint format keeps
the count an int32 (convert.py).
"""

from __future__ import annotations

import dataclasses
import functools
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
            state["count"] = new_count(params)
        return state

    @torch.no_grad()
    def apply(self, params, grads, state: dict, skip=None,
              decay_mask=None) -> dict:
        """One update of ``params`` and ``state["momentum"]``, in place;
        returns ``state``. ``skip``: the step guard's 0-d device flag
        (nonzero leaves both as they were, the count too; ops/sgd.py).
        ``decay_mask`` is taken as AdamW's and Adafactor's and ignored:
        SGD decays every leaf uniformly (JAX ``SGD.decay_mask``)."""
        lr = self.learning_rate
        if callable(lr):
            count = state["count"] + 1
            lr = lr(count.float())
            # In place, so a captured step (train/engine.py's K-step CUDA
            # graph) reads and writes the same count tensor every replay.
            state["count"].copy_(count if skip is None
                                 else count - (skip != 0).to(torch.int32))
        step = (_sgd.fused_sgd_step if self.use_pallas
                else _sgd.fused_sgd_step_ref)
        step(params, grads, state["momentum"], lr=lr,
             momentum=self.momentum, weight_decay=self.weight_decay,
             skip=skip)
        return state

    @staticmethod
    def decay_mask(params):
        """None: SGD decays every leaf uniformly (torch semantics; JAX
        ``SGD.decay_mask``)."""
        return None


def new_count(params) -> torch.Tensor:
    """A fresh step count: a 0-d int32 zero on the parameters' device."""
    return torch.zeros((), dtype=torch.int32, device=params[0].device)


@functools.lru_cache(maxsize=None)
def _bias_table(b: float, device) -> torch.Tensor:
    """``1 - b**t`` for t = 1, 2, ..., each as the JAX package computes it
    (numpy f32), up to the first t where it rounds to 1.0, which every
    later t gives too; on ``device``."""
    if not 0.0 <= b < 1.0:
        raise ValueError(f"AdamW's betas must lie in [0, 1), got {b}")
    one, bf = _F32(1.0), _F32(b)
    vals = [one - bf ** _F32(1)]
    while vals[-1] != one:
        vals.append(one - bf ** _F32(len(vals) + 1))
    return torch.tensor(np.array(vals, np.float32), device=device)


def _bias_correction(b: float, count) -> torch.Tensor:
    """AdamW's ``1 - b**count`` at the 1-based 0-d int32 device ``count``:
    a 0-d f32 read from :func:`_bias_table`, no host read."""
    table = _bias_table(b, count.device)
    idx = torch.clamp_max(count - 1, table.numel() - 1)
    return table.index_select(0, idx.reshape(1).long()).reshape(())


def _device_lr(learning_rate, c):
    """A static lr as it is, or the schedule at the 1-based f32 count
    ``c`` (a 0-d device tensor) as a 0-d device tensor."""
    if callable(learning_rate):
        return learning_rate(c)
    return learning_rate


def ema_(v, b2, omb2, x):
    """``v <- b2 * v + omb2 * x`` in place (the second-moment EMA of
    Adafactor and its row-sharded wrapper, one expression for both)."""
    return v.mul_(b2).add_(x * omb2)


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
                "nu": [torch.zeros_like(p) for p in params],
                "count": new_count(params)}

    @staticmethod
    def decay_mask(params) -> list:
        return [p.dim() >= 2 for p in params]

    @torch.no_grad()
    def apply(self, params, grads, state: dict, decay_mask=None) -> dict:
        """One update of ``params``, ``state["mu"]`` and ``state["nu"]``,
        in place; returns ``state`` with the count advanced in place.
        ``decay_mask`` overrides the rank rule (the ZeRO and FSDP
        wrappers pass the original leaves' mask: their flat slices are
        all rank 1)."""
        count = state["count"] + 1
        bc1 = _bias_correction(self.b1, count)
        bc2 = _bias_correction(self.b2, count)
        lr = _device_lr(self.learning_rate, count.to(torch.float32))
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
        if decay_mask is None:
            decay_mask = self.decay_mask(params)
        decay = [i for i, d in enumerate(decay_mask) if d]
        if self.weight_decay and decay:
            torch._foreach_add_([upd[i] for i in decay],
                                [params[i] for i in decay],
                                alpha=self.weight_decay)
        if isinstance(lr, torch.Tensor):
            torch._foreach_mul_(upd, lr)
            torch._foreach_sub_(params, upd)
        else:
            torch._foreach_add_(params, upd, alpha=-lr)
        state["count"].copy_(count)
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
    not use the slot, so a checkpoint restores in either package. Every
    mean is written as a sum divided by the count (what ``torch.mean``
    computes on the CPU), so the row-sharded ZeRO-1 of
    parallel/zero.py (``FactoredZeRO1``), which sums its row blocks
    across the group before it divides, gives these bits at a group of
    one on any device. Under tensor or expert parallelism it runs on
    each process's cells (parallel/zero.py ``CellAdafactor``).
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

    def factoring_view(self, shape):
        """``(lead, n, m)`` of the per-matrix view ``(*lead, n, m)`` the
        factoring runs over (JAX ``_view_shape``), or None for a leaf
        that keeps a full second moment (JAX ``_plan`` is None)."""
        if self.plan(shape) is None:
            return None
        view = self.view_shape(shape)
        return tuple(view[:-2]), view[-2], view[-1]

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
        state["count"] = new_count(params)
        return state

    @staticmethod
    def decay_mask(params) -> list:
        return [p.dim() >= 2 for p in params]

    def schedule_terms(self, count):
        """(beta2_t, rho, lr) for the 1-based 0-d int32 device ``count``,
        0-d f32 device tensors: rho is the relative step's
        min(1e-2, 1/sqrt(t)) (None with an explicit lr), lr None under
        the relative step (a float for a static lr)."""
        c = count.to(torch.float32)
        beta2t = 1.0 - torch.pow(c, _F32(-self.decay_rate))
        if self.learning_rate is None:
            rho = torch.clamp_max(1.0 / torch.sqrt(c), _F32(1e-2))
            return beta2t, rho, None
        return beta2t, None, _device_lr(self.learning_rate, c)

    @torch.no_grad()
    def apply(self, params, grads, state: dict, decay_mask=None) -> dict:
        """One update of every leaf and its slots, in place; returns
        ``state`` with the count advanced in place. ``decay_mask``
        overrides the rank rule (a pipeline's stacked leaves)."""
        count = state["count"] + 1
        beta2t, rho, lr = self.schedule_terms(count)
        decay = (self.decay_mask(params) if decay_mask is None
                 else decay_mask)
        for i, (p, g) in enumerate(zip(params, grads)):
            self._leaf_update(p, g, state, i, decay[i], beta2t, rho, lr)
        state["count"].copy_(count)
        return state

    def _leaf_update(self, p, g, state, i, dk, beta2t, rho, lr):
        b2, omb2 = beta2t, 1.0 - beta2t
        g32 = g.float()
        g2 = g32.square().add_(self.eps1)
        if self.plan(tuple(p.shape)) is not None:
            view = self.view_shape(tuple(p.shape))
            g2v = g2.view(view)
            vr, vc = state["vr"][i], state["vc"][i]
            n, m = view[-2], view[-1]
            ema_(vr, b2, omb2, g2v.sum(dim=-1) / m)
            ema_(vc, b2, omb2, g2v.sum(dim=-2) / n)
            r = vr / (vr.sum(dim=-1, keepdim=True) / n)
            u = (g32.view(view) * torch.rsqrt(r)[..., :, None]
                 * torch.rsqrt(vc)[..., None, :]).view(p.shape)
        else:
            v = state["v"][i]
            ema_(v, b2, omb2, g2)
            u = g32 * torch.rsqrt(v)
        del g2
        u = self.clip_update(u, u.square().sum(), u.numel())
        alpha = self.step_size(p, rho, lr)
        p.sub_(self.leaf_step(p, u, state["mu"][i], dk, alpha))

    def step_size(self, p, rho, lr):
        """The step's scale for the whole leaf ``p``: ``lr``, or the
        relative step ``rho * max(eps2, RMS(p))`` (a 0-d tensor)."""
        if lr is None:
            rms_p = p.float().square().mean().sqrt()
            return rho * torch.clamp_min(rms_p, self.eps2)
        return lr

    def clip_update(self, u, sq_sum, numel: int):
        """``u`` scaled down to RMS ``clip_threshold`` from the f32 sum of
        its squares over the whole leaf."""
        rms_u = (sq_sum / numel).sqrt()
        return u / torch.clamp_min(rms_u / self.clip_threshold, 1.0)

    def leaf_step(self, p, u, mu, dk: bool, alpha):
        """What the update subtracts from ``p`` (or from a block of its
        rows), in ``p``'s dtype: the clipped update ``u``, or the first
        moment ``mu`` advanced in place by it, times ``alpha``, plus the
        decoupled decay of ``p``."""
        if self.b1 is not None:
            mu.mul_(self.b1).add_(u.to(p.dtype), alpha=1 - self.b1)
            step = mu
        else:
            step = u
        upd = alpha * step
        if dk and self.weight_decay:
            upd = upd + (alpha * self.weight_decay) * p
        return upd.to(p.dtype)


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
    step a 0-d tensor on its device (the optimizers' device counts), on a
    number a numpy f32."""
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
