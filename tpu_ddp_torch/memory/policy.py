"""Activation-rematerialisation and residual-precision policies
(tpu_ddp/memory/policy.py): one vocabulary for every model of the port,
each model applying it inside its own forward.

``remat``, which regions recompute in the backward instead of keeping
their interior activations:

- ``"none"``: save everything.
- ``"blocks"``: one region per natural block (a transformer block, a VGG
  conv->BN->ReLU unit): a non-reentrant ``torch.utils.checkpoint`` that
  saves only the region's inputs.
- ``"conv_stages"``: one region per VGG between-pool group. A
  transformer has no conv stages: :func:`effective_remat` degrades it to
  ``"blocks"`` with a warning.
- ``"dots"``: the region keeps the outputs of its matrix products
  (``aten.mm``/``addmm``/``bmm``/``baddbmm``, JAX's ``dots_saveable``)
  and recomputes everything else, through selective checkpointing. The
  hand-written kernels are ctypes calls the dispatcher never sees, so
  they run again in the recompute, as a Pallas call does under JAX's
  policy (it is not a ``dot_general``). A VGG stage holds no matrix
  product, so there it is the ``"conv_stages"`` program.

``act_dtype``, the dtype of the saved boundary residuals: ``"compute"``
(no cast), ``"bf16"`` or ``"f32"``. Each boundary is cast before it
enters the next region (:func:`cast_saved`) and every region casts back
to the compute dtype on entry, so the cast changes what is kept between
forward and backward, not the arithmetic inside a region.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

REMAT_POLICIES = ("none", "blocks", "conv_stages", "dots")
ACT_DTYPES = ("compute", "bf16", "f32")

# The ops whose outputs "dots" keeps (by overload packet).
_DOT_OPS = frozenset((torch.ops.aten.mm, torch.ops.aten.addmm,
                      torch.ops.aten.bmm, torch.ops.aten.baddbmm))


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


def cast_saved(x, act_dtype: str, compute_dtype):
    """A stage-boundary residual in the saved-activation dtype; ``x``
    itself when it already has it."""
    dt = resolve_act_dtype(act_dtype, compute_dtype)
    return x if x.dtype == dt else x.to(dt)


def _dots_saveable(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    if op.overloadpacket in _DOT_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def checkpoint_policy(remat: str):
    """The selective-checkpoint policy of a remat mode (None: save
    nothing inside the region but its inputs)."""
    validate_remat(remat)
    return _dots_saveable if remat == "dots" else None


def wrap_stage(fn, remat: str):
    """``fn`` under the remat policy: itself for ``"none"``, otherwise a
    non-reentrant checkpoint region (selective under ``"dots"``)."""
    policy = checkpoint_policy(remat)
    if remat == "none":
        return fn
    kwargs = {"use_reentrant": False}
    if policy is not None:
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    return functools.partial(checkpoint, fn, **kwargs)


def effective_remat(remat: str, family: str) -> str:
    """A remat mode resolved against a model family (``"conv"`` or
    ``"attn"``): ``conv_stages`` on a transformer degrades to
    ``blocks``, with a warning."""
    validate_remat(remat)
    if family == "attn" and remat == "conv_stages":
        warnings.warn(
            "remat='conv_stages' on a transformer family (no conv "
            "stages): degrading to per-block remat ('blocks')",
            stacklevel=2)
        return "blocks"
    return remat


def family_for_model(name: str) -> str:
    """``"conv"``, ``"attn"`` or ``""`` (unknown) for a model name."""
    if name.startswith(("VGG", "ResNet")):
        return "conv"
    if name.startswith(("ViT", "TransformerLM")):
        return "attn"
    return ""


def apply_policy(model, remat: str = "none", act_dtype: str = "compute"):
    """The config's memory policy imprinted on a built model. A config
    default never downgrades a model built with a policy (the
    TransformerLM-large preset's block remat); a non-default value
    wins. A dataclass model (the TransformerLM) comes back replaced; a
    module (the VGG) has its fields set and comes back itself. A model
    without the fields is returned unchanged, with a warning."""
    validate_remat(remat)
    validate_act_dtype(act_dtype)
    if remat == "none" and act_dtype == "compute":
        return model
    if not (hasattr(model, "remat") and hasattr(model, "act_dtype")):
        warnings.warn(
            f"model {type(model).__name__} does not carry memory-policy "
            f"fields; remat={remat!r} / act_dtype={act_dtype!r} ignored",
            stacklevel=2)
        return model
    updates = {}
    if remat != "none" and model.remat != remat:
        updates["remat"] = remat
    if act_dtype != "compute" and model.act_dtype != act_dtype:
        updates["act_dtype"] = act_dtype
    if not updates:
        return model
    if dataclasses.is_dataclass(model):
        return dataclasses.replace(model, **updates)
    for k, v in updates.items():
        setattr(model, k, v)
    return model
