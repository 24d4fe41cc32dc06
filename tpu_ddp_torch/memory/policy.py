"""Activation-rematerialisation and residual-precision policies
(tpu_ddp/memory/policy.py), as far as the port carries them: the policy
vocabulary and its validation, the KV cache's storage dtype, and
``wrap_stage`` for ``remat="none"`` and ``"blocks"`` — one
``torch.utils.checkpoint`` region per transformer block, so the backward
recomputes the block from its saved input. ``"dots"`` (save the matmul
outputs only), ``"conv_stages"`` and a saved-activation dtype other than
the compute dtype are not ported yet."""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

REMAT_POLICIES = ("none", "blocks", "conv_stages", "dots")
ACT_DTYPES = ("compute", "bf16", "f32")
_UNPORTED = "ROADMAP Queue 1 item 9.7 (memory/policy.py)"


def validate_remat(value: str, where: str = "remat") -> str:
    if value not in REMAT_POLICIES:
        raise ValueError(
            f"{where}={value!r}: expected one of {'|'.join(REMAT_POLICIES)}"
            " (TPU_DDP_REMAT)")
    return value


def validate_act_dtype(value: str, where: str = "act_dtype") -> str:
    if value not in ACT_DTYPES:
        raise ValueError(
            f"{where}={value!r}: expected one of {'|'.join(ACT_DTYPES)}"
            " (TPU_DDP_ACT_DTYPE)")
    return value


def resolve_act_dtype(act_dtype: str, compute_dtype) -> torch.dtype:
    """The concrete dtype the policy name stands for."""
    validate_act_dtype(act_dtype)
    if act_dtype == "compute":
        return compute_dtype
    return torch.bfloat16 if act_dtype == "bf16" else torch.float32


def check_training_policy(remat: str, act_dtype: str) -> None:
    """Raise for the policies the port cannot train with yet."""
    validate_remat(remat)
    validate_act_dtype(act_dtype)
    if remat not in ("none", "blocks"):
        raise NotImplementedError(
            f"remat={remat!r} is not ported to tpu_ddp_torch yet "
            f"({_UNPORTED})")
    if act_dtype != "compute":
        raise NotImplementedError(
            f"act_dtype={act_dtype!r} is not ported to tpu_ddp_torch yet "
            f"({_UNPORTED})")


def wrap_stage(fn, remat: str):
    """``fn`` under the remat policy: itself for ``"none"``; for
    ``"blocks"`` a non-reentrant ``torch.utils.checkpoint`` region that
    saves only its inputs and recomputes the rest in the backward."""
    validate_remat(remat)
    if remat == "none":
        return fn
    if remat != "blocks":
        raise NotImplementedError(
            f"remat={remat!r} is not ported to tpu_ddp_torch yet "
            f"({_UNPORTED})")
    return functools.partial(checkpoint, fn, use_reentrant=False)
