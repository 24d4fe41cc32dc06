"""The saved-activation dtype vocabulary of tpu_ddp/memory/policy.py,
as far as serving uses it: the KV cache's storage dtype."""

from __future__ import annotations

import torch

ACT_DTYPES = ("compute", "bf16", "f32")


def resolve_act_dtype(act_dtype: str, compute_dtype) -> torch.dtype:
    """The concrete dtype the policy name stands for."""
    if act_dtype not in ACT_DTYPES:
        raise ValueError(
            f"act_dtype={act_dtype!r}: expected one of "
            f"{'|'.join(ACT_DTYPES)}")
    if act_dtype == "compute":
        return compute_dtype
    return torch.bfloat16 if act_dtype == "bf16" else torch.float32
