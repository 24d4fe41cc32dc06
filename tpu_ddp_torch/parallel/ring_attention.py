"""Exact attention over a sequence sharded across processes
(tpu_ddp/parallel/ring_attention.py): ring attention, the blockwise
online-softmax path, the whole-sequence reference and ``attend``, which
routes a call to ring or Ulysses attention (parallel/ulysses.py), the
flash kernels (ops/flash_attention.py) or ``full_attention``.

Ring attention (Liu et al., arXiv:2310.01889): the sequence is sharded
over an sp process group; each process keeps its Q chunk resident while
the K/V chunks travel one hop per step around the ring, so after
``step`` hops a process holds the chunk of the process ``step`` places
behind it. The softmax is computed online (running max, sum and output
in f32), so the result is exact attention. Causal masking uses global
positions; chunks above the diagonal are computed and masked, never
skipped, as the JAX package does (a skip would unbalance the ring's
steps).

The arithmetic of a process is kept apart from the movement of tensors:
:func:`block_attn` (one online-softmax update) and :func:`ring_local`
(one process's whole ring, fed the chunk of each step by an iterator)
are functions of tensors alone; :func:`ring_attention` feeds
:func:`ring_local` with the chunks its group rotates, one
``batch_isend_irecv`` to the ring's next and previous processes per hop
(NCCL on the card, gloo on the CPU). The rotation is an autograd
function whose backward is the inverse rotation, the transpose of JAX's
``lax.ppermute``.

The block products are large plain products, computed as the JAX
package computes them with ``jnp.einsum`` outside any Pallas kernel:
operands widened to f32 (the products of bf16 values are exact in f32)
and summed in f32, and ``p . v`` taken in f32.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30  # the mask value: no NaN from (-inf) - (-inf)
_INT32_MAX = 2 ** 31 - 1


def block_attn(q, k, v, m_prev, l_prev, acc_prev, q_pos, k_pos, causal,
               scale, k_valid=None):
    """One blockwise update of the online-softmax state.

    q: (B, Lq, H, D); k/v: (B, Lk, KV, D); positions (Lq,) and (Lk,).
    State: m (B, H, Lq) running max, l (B, H, Lq) running sum, acc
    (B, Lq, H, D) unnormalised output, all f32. ``k_valid`` (bool (Lk,))
    masks keys out. Under grouped-query attention (KV < H) each contiguous
    group of H/KV query heads contracts against its KV head, the expansion
    never built (the ``jnp.repeat`` head order)."""
    b, lq, h, d = q.shape
    kvh = k.shape[2]
    q32, k32 = q.float(), k.float()
    if kvh == h:
        scores = torch.einsum("bqhd,bkhd->bhqk", q32, k32) * scale
    else:
        qg = q32.reshape(b, lq, kvh, h // kvh, d)
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k32).reshape(
            b, h, lq, -1) * scale
    if causal:
        mask = k_pos[None, None, None, :] > q_pos[None, None, :, None]
        scores = scores.masked_fill(mask, NEG_INF)
    if k_valid is not None:
        scores = scores.masked_fill(~k_valid[None, None, None, :], NEG_INF)
    m_new = torch.maximum(m_prev, scores.amax(dim=-1))        # (B, H, Lq)
    p = torch.exp(scores - m_new[..., None])                  # (B, H, Lq, Lk)
    corr = torch.exp(m_prev - m_new)
    l_new = corr * l_prev + p.sum(dim=-1)
    v32 = v.float()
    if kvh == h:
        pv = torch.einsum("bhqk,bkhd->bqhd", p, v32)
    else:
        pg = p.reshape(b, kvh, h // kvh, lq, p.shape[-1])
        pv = torch.einsum("bkgqs,bskd->bqkgd", pg, v32).reshape(b, lq, h, d)
    acc_new = acc_prev * corr.transpose(1, 2)[..., None] + pv
    return m_new, l_new, acc_new


def init_state(q):
    """The empty online-softmax state (m, l, acc) for queries ``q``."""
    b, lq, h, d = q.shape
    return (torch.full((b, h, lq), NEG_INF, dtype=torch.float32,
                       device=q.device),
            torch.zeros((b, h, lq), dtype=torch.float32, device=q.device),
            torch.zeros((b, lq, h, d), dtype=torch.float32,
                        device=q.device))


def finish(state, dtype):
    """The normalised output of a state, in ``dtype``."""
    _, l, acc = state
    return (acc / l.transpose(1, 2)[..., None]).to(dtype)


def ring_local(q, chunks, my: int, axis_size: int, causal: bool = False,
               *, q_offset=0, cache_k=None, cache_v=None, cache_valid=None):
    """One process's ring: its output chunk (B, Lc, H, D) in ``q``'s
    dtype. ``chunks`` yields the (k, v) this process holds at each of the
    ``axis_size`` steps, step ``s`` the chunk of process
    ``(my - s) % axis_size`` (what the rotation delivers). The cache
    (``cache_k``/``cache_v`` (B, S, KV, D) at absolute positions
    0..S-1, ``cache_valid`` (bool (S,)) masking its tail) seeds the state
    with one update before the ring, and ``q_offset`` shifts every
    chunk position to absolute (context-parallel prefill)."""
    b, lc, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    ar = torch.arange(lc, device=q.device)
    q_pos = q_offset + my * lc + ar
    state = init_state(q)
    if cache_k is not None:
        lk = cache_k.shape[1]
        state = block_attn(q, cache_k, cache_v, *state, q_pos,
                           torch.arange(lk, device=q.device), False, scale,
                           k_valid=cache_valid)
    for step, (k_cur, v_cur) in enumerate(chunks):
        owner = (my - step) % axis_size
        k_pos = q_offset + owner * lc + ar
        state = block_attn(q, k_cur, v_cur, *state, q_pos, k_pos, causal,
                           scale)
    return finish(state, q.dtype)


def _ring_peers(group, axis_size: int):
    """(this process's index, the global ranks of the next and the
    previous process) on the ring of ``group``."""
    my = dist.get_rank(group)
    nxt, prv = (my + 1) % axis_size, (my - 1) % axis_size
    if group is not None:
        nxt = dist.get_global_rank(group, nxt)
        prv = dist.get_global_rank(group, prv)
    return my, nxt, prv


def _exchange(x, send_to: int, recv_from: int, group):
    """Send ``x`` to ``send_to`` and receive the same shape from
    ``recv_from`` (global ranks), one ``batch_isend_irecv``."""
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, send_to, group),
           dist.P2POp(dist.irecv, out, recv_from, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Rotate(torch.autograd.Function):
    """One hop of the ring: every process sends its tensor to the next and
    receives the previous one's. The backward is the inverse hop (each
    cotangent goes back to the process its value came from)."""

    @staticmethod
    def forward(ctx, x, group, nxt, prv):
        ctx.group, ctx.nxt, ctx.prv = group, nxt, prv
        return _exchange(x, nxt, prv, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.prv, ctx.nxt, ctx.group), None, None, None


def ring_attention(q, k, v, group=None, axis_size: int | None = None,
                   causal: bool = False, *, q_offset=0, cache_k=None,
                   cache_v=None, cache_valid=None):
    """Exact attention with the sequence sharded over the process group
    ``group`` (the default group when None) of ``axis_size`` processes:
    ``q``/``k``/``v`` are this process's chunks (B, L/sp, heads, D), the
    chunks in group-rank order; returns its output chunk in ``q``'s
    dtype. K and V rotate together, stacked, one hop per step. The cache
    arguments are :func:`ring_local`'s (replicated on every process).
    Differentiable."""
    if axis_size is None:
        raise ValueError("axis_size (the sp extent) is required: the ring "
                         "takes that many steps")
    my, nxt, prv = _ring_peers(group, axis_size)

    def hops():
        kv = torch.stack([k, v])
        for step in range(axis_size):
            yield kv[0], kv[1]
            if step != axis_size - 1:
                kv = _Rotate.apply(kv, group, nxt, prv)

    return ring_local(q, hops(), my, axis_size, causal, q_offset=q_offset,
                      cache_k=cache_k, cache_v=cache_v,
                      cache_valid=cache_valid)


def blockwise_attention(q, k, v, causal: bool = False,
                        block_size: int = 512, *, q_pos=None, k_pos=None,
                        k_valid=None):
    """Exact attention with K/V streamed in blocks of ``block_size`` keys
    (online softmax): the score buffer is (B, H, L, block), never
    (B, H, L, L). Each block's update is recomputed in the backward
    (``torch.utils.checkpoint``, as the JAX package's ``jax.checkpoint``),
    so the backward keeps no O(L^2) residuals.

    Explicit positions: ``q_pos`` (Lq,) and ``k_pos`` (Lk,) replace the
    0-based alignment and ``k_valid`` (bool (Lk,)) masks keys, which lets
    a caller prepend cache K/V at positions 0..S-1 to a chunk whose
    queries start at an offset. Padding keys take position 2**31 - 1 and
    are invalid."""
    b, L, h, d = q.shape
    Lk, kvh = k.shape[1], k.shape[2]
    explicit = (q_pos is not None or k_pos is not None
                or k_valid is not None)
    bs = min(block_size, Lk)
    n = -(-Lk // bs)
    pad = n * bs - Lk
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    if pad:
        k = torch.cat([k, k.new_zeros(b, pad, kvh, d)], dim=1)
        v = torch.cat([v, v.new_zeros(b, pad, kvh, d)], dim=1)
    if explicit:
        if q_pos is None:
            q_pos = torch.arange(L, device=dev)
        if k_pos is None:
            k_pos = torch.arange(Lk, device=dev)
        if k_valid is None:
            k_valid = torch.ones(Lk, dtype=torch.bool, device=dev)
        if pad:
            k_pos = torch.cat([k_pos, torch.full(
                (pad,), _INT32_MAX, dtype=k_pos.dtype, device=dev)])
            k_valid = torch.cat([k_valid, torch.zeros(
                pad, dtype=torch.bool, device=dev)])
    else:
        q_pos = torch.arange(L, device=dev)
        k_pos = torch.arange(n * bs, device=dev)
        k_valid = (k_pos < L) if pad else None

    def body(m, l, acc, kc, vc, kp, kw):
        return block_attn(q, kc, vc, m, l, acc, q_pos, kp, causal, scale,
                          k_valid=kw)

    state = init_state(q)
    for i in range(n):
        cut = slice(i * bs, (i + 1) * bs)
        args = (*state, k[:, cut], v[:, cut], k_pos[cut],
                None if k_valid is None else k_valid[cut])
        if torch.is_grad_enabled():
            state = checkpoint(body, *args, use_reentrant=False)
        else:
            state = body(*args)
    return finish(state, q.dtype)


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
           mode: str = "ring", group=None):
    """Dispatch: sequence-parallel attention over the process group
    ``group`` when a sequence axis of extent > 1 is given (``mode``:
    ``"ring"`` K/V rotation or ``"ulysses"`` all-to-all head re-sharding,
    parallel/ulysses.py), else the flash kernels (``flash=True``) or
    ``full_attention``. K/V may carry fewer heads than q (H % KV == 0)."""
    if axis_name is not None:
        if axis_size is None:
            # Falling back to full_attention here would compute
            # chunk-local attention on each process: wrong, silently.
            raise ValueError(
                "attend: axis_name given without axis_size; pass the sp "
                "extent")
        if axis_size > 1:
            if mode == "ulysses":
                from tpu_ddp_torch.parallel.ulysses import ulysses_attention
                return ulysses_attention(q, k, v, group, axis_size,
                                         causal=causal, flash=flash)
            if mode != "ring":
                raise ValueError(f"attend: unknown sequence-parallel mode "
                                 f"{mode!r}; expected 'ring' or 'ulysses'")
            return ring_attention(q, k, v, group, axis_size, causal=causal)
    if flash:
        from tpu_ddp_torch.ops.flash_attention import flash_attention
        return flash_attention(q, k, v, causal)
    return full_attention(q, k, v, causal=causal)
