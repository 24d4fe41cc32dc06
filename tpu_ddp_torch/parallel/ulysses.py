"""Ulysses sequence parallelism (tpu_ddp/parallel/ulysses.py): exact
attention over a sequence sharded across processes by all-to-all
re-sharding between sequence and heads (DeepSpeed-Ulysses, Jacobs et al.,
arXiv:2309.14509).

Activations arrive sequence-sharded over the sp process group, (B, L/sp,
H, D) per process. One all-to-all re-shards them from sequence to heads,
so every process holds the whole sequence for H/sp of the heads,
(B, L, H/sp, D); attention then runs locally (the flash kernels, or the
blockwise online-softmax path of parallel/ring_attention.py), and a
second all-to-all restores the sequence sharding. Ulysses needs
``H % sp == 0``; ring attention keeps the heads whole.

Each exchange is one ``all_to_all_single`` over the sp group on
contiguous blocks, block ``j`` to process ``j``, the received blocks in
source order (JAX's tiled ``lax.all_to_all``); its backward is the
reverse exchange (parallel/moe.py ``_AllToAll``). The local attention,
:func:`ulysses_local`, is a function of tensors alone.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpu_ddp_torch.parallel.moe import _AllToAll
from tpu_ddp_torch.parallel.ring_attention import (blockwise_attention,
                                                   repeat_kv_heads)


def _heads_to_seq(x, group, sp: int):
    """(..., B, L/sp, H, D) -> (..., B, L, H/sp, D): head block ``j`` goes
    to process ``j``, and the sequence chunks come back in source order,
    which is global order (process ``j`` held chunk ``j``). Leading axes
    (a (3, ...) or (2, ...) stack) ride along."""
    *lead, b, lc, h, d = x.shape
    hs = h // sp
    send = x.reshape(*lead, b, lc, sp, hs, d).movedim(-3, 0).contiguous()
    recv = _AllToAll.apply(send, group)       # (sp, ..., B, Lc, hs, D)
    return recv.movedim(0, -4).reshape(*lead, b, sp * lc, hs, d)


def _seq_to_heads(x, group, sp: int):
    """(B, L, H/sp, D) -> (B, L/sp, H, D): the inverse re-shard, sequence
    chunk ``j`` to process ``j``, the head blocks back in source order."""
    b, L, hs, d = x.shape
    lc = L // sp
    send = x.reshape(b, sp, lc, hs, d).movedim(1, 0).contiguous()
    recv = _AllToAll.apply(send, group)       # (sp, B, Lc, hs, D)
    return recv.movedim(0, 2).reshape(b, lc, sp * hs, d)


def ulysses_local(q, k, v, causal: bool = False, flash: bool = False, *,
                  idx: int = 0, sp: int = 1, q_offset=0, cache_k=None,
                  cache_v=None, cache_valid=None):
    """One process's attention after the exchange: the whole sequence for
    its head group ``idx`` of ``sp``, (B, L, H/sp, D) in and out. With a
    cache (``cache_k``/``cache_v`` (B, S, KV', D), replicated, KV' a
    multiple of ``sp``) the process slices its head group out of the
    cache, puts it before the chunk on the key axis and runs the
    blockwise path with explicit positions (the chunk at ``q_offset``..,
    the cache at 0..S-1 masked by ``cache_valid``); else the flash
    kernels (``flash``) or the blockwise path."""
    if cache_k is not None:
        L, S = q.shape[1], cache_k.shape[1]
        per = cache_k.shape[2] // sp
        ck = cache_k[:, :, idx * per:(idx + 1) * per]
        cv = cache_v[:, :, idx * per:(idx + 1) * per]
        dev = q.device
        pos = q_offset + torch.arange(L, device=dev)
        valid = (torch.ones(S, dtype=torch.bool, device=dev)
                 if cache_valid is None else cache_valid)
        return blockwise_attention(
            q, torch.cat([ck.to(k.dtype), k], dim=1),
            torch.cat([cv.to(v.dtype), v], dim=1), causal=causal,
            q_pos=pos, k_pos=torch.cat([torch.arange(S, device=dev), pos]),
            k_valid=torch.cat([valid, torch.ones(L, dtype=torch.bool,
                                                 device=dev)]))
    if flash:
        # Grouped K/V go straight in: the kernels read KV head
        # h // (H/KV) natively, and the exchange's contiguous head
        # blocks keep the groups whole.
        from tpu_ddp_torch.ops.flash_attention import flash_attention
        return flash_attention(q, k, v, causal)
    return blockwise_attention(q, k, v, causal=causal)


def ulysses_attention(q, k, v, group=None, axis_size: int | None = None,
                      causal: bool = False, flash: bool = False, *,
                      q_offset=0, cache_k=None, cache_v=None,
                      cache_valid=None):
    """Exact attention with the sequence sharded over the process group
    ``group`` (the default group when None) of ``axis_size`` processes:
    ``q``/``k``/``v`` are this process's chunks (B, L/sp, heads, D) with
    RoPE applied at their global positions; returns its output chunk
    (B, L/sp, H, D) in ``q``'s dtype. The cache arguments (context-
    parallel prefill) are :func:`ulysses_local`'s and need the blockwise
    path (``flash=False``). Differentiable."""
    if axis_size is None:
        raise ValueError("axis_size (the sp extent) is required: the "
                         "exchange cuts that many blocks")
    if cache_k is not None and flash:
        raise ValueError("ulysses_attention: cache prepending requires "
                         "the blockwise path (flash=False)")
    h, kvh = q.shape[2], k.shape[2]
    if h % axis_size:
        raise ValueError(
            f"ulysses_attention needs num_heads % sp == 0 (got heads={h}, "
            f"sp={axis_size}); use ring attention for head-poor models")
    if kvh != h and kvh % axis_size:
        # Grouped K/V scatter only when KV % sp == 0; otherwise expand
        # before the exchange (the wire saving is lost, the result the
        # same).
        k, v = repeat_kv_heads(k, v, h // kvh)
        if cache_k is not None:
            cache_k, cache_v = repeat_kv_heads(cache_k, cache_v, h // kvh)
        kvh = h
    sp = axis_size
    if kvh == h:
        # One exchange for the three tensors.
        q, k, v = _heads_to_seq(torch.stack([q, k, v]), group, sp)
    else:
        q = _heads_to_seq(q, group, sp)
        k, v = _heads_to_seq(torch.stack([k, v]), group, sp)
    out = ulysses_local(q, k, v, causal, flash, idx=dist.get_rank(group),
                        sp=sp, q_offset=q_offset, cache_k=cache_k,
                        cache_v=cache_v, cache_valid=cache_valid)
    return _seq_to_heads(out, group, sp)
