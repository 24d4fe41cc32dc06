"""Attention dispatch (tpu_ddp/parallel/ring_attention.py) as far as one
device needs it: the whole-sequence reference ``full_attention``, the GQA
expansion helper and ``attend``, which routes to the flash kernels
(``ops/flash_attention.py``) or to ``full_attention``. Ring and Ulysses
sequence parallelism are not ported yet."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def full_attention(q, k, v, causal: bool = False):
    """Single-device reference: the whole (L, L) score matrix in f32, a
    softmax and p . v in f32. (B, L, H, D) in and out; grouped-query k/v
    (KV < H heads) contract grouped, without expansion."""
    b, L, h, d = q.shape
    kvh = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    if kvh == h:
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    else:
        qg = q.float().reshape(b, L, kvh, h // kvh, d)
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg,
                              k.float()).reshape(b, h, L, L)
    scores = scores * scale
    if causal:
        pos = torch.arange(L, device=q.device)
        scores = torch.where(pos[None, None, None, :] > pos[None, None, :, None],
                             NEG_INF, scores)
    p = torch.softmax(scores, dim=-1)
    v32 = v.float()
    if kvh == h:
        out = torch.einsum("bhqk,bkhd->bqhd", p, v32)
    else:
        pg = p.reshape(b, kvh, h // kvh, L, L)
        out = torch.einsum("bkgqs,bskd->bqkgd", pg, v32).reshape(b, L, h, d)
    return out.to(q.dtype)


def repeat_kv_heads(k, v, rep: int):
    """Materialise the GQA expansion (group-contiguous, the ``jnp.repeat``
    order) for a consumer with no grouped path."""
    if rep == 1:
        return k, v
    return (k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2))


def attend(q, k, v, *, causal: bool = False, axis_name: str | None = None,
           axis_size: int | None = None, flash: bool = False,
           mode: str = "ring"):
    """Dispatch: the flash kernels (``flash=True``) or ``full_attention``.
    A sequence axis of extent > 1 (ring or Ulysses attention) raises:
    those paths are not ported yet."""
    if axis_name is not None:
        if axis_size is None:
            raise ValueError(
                "attend: axis_name given without axis_size; pass the sp "
                "extent")
        if axis_size > 1:
            raise NotImplementedError(
                f"attend: sequence-parallel attention (mode={mode!r}, "
                f"axis_size={axis_size}) is not ported to tpu_ddp_torch yet "
                "(ROADMAP Queue 1 item 10.5, ring and Ulysses)")
    if flash:
        from tpu_ddp_torch.ops.flash_attention import flash_attention
        return flash_attention(q, k, v, causal)
    return full_attention(q, k, v, causal=causal)
