"""Mixture of experts: the routed MLP of tpu_ddp/parallel/moe.py, with
expert parallelism over a ``torch.distributed`` process group.

Routing is the JAX package's algebra term for term: a softmax router in
f32, top-1 Switch routing with the raw probability as gate, top-k > 1 the
GShard scheme (an iterative argmax over masked probabilities, the gates
renormalised over the chosen experts, and each later choice queued in an
expert's capacity after the slots the earlier choices kept, so slots
never collide); ``cap = max(1, ceil(T * capacity_factor * top_k / E))``
slots per expert per source process, shared by a token's choices; an
assignment past its expert's capacity contributes zero and the token
rides the residual stream; the Switch load-balance loss
``E * sum_e f_e * P_e`` over the first choice.

The JAX layer computes dispatch and combine as dense einsums against a
(T, E, C) one-hot. The port computes both by index and never builds that
tensor: :func:`topk_route` returns, per choice, each token's flat slot
``expert * C + position`` (``E * C`` where the assignment was dropped)
and its gate. Dispatch gathers each slot's token (one nonzero term per
output of the JAX einsum, so the gather is exact); combine gathers each
choice's expert output and sums the gate-weighted rows in f32 (at most
``top_k`` nonzero terms per token of the JAX einsum).

Expert parallelism (``ep_size > 1``): the stacked expert weights hold
this process's ``E / ep`` experts; the (E, C, dm) slot queues go through
one ``all_to_all`` over the ep group before the experts and the reverse
one after them, both differentiable (the backward of an equal-split
all_to_all is the same exchange of the cotangents).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F


def capacity(tokens: int, num_experts: int, capacity_factor: float,
             top_k: int = 1) -> int:
    """Slots per expert per source process:
    ``max(1, ceil(T * capacity_factor * top_k / E))`` (JAX ``moe_mlp``,
    the same float arithmetic)."""
    return max(1, int(-(-tokens * capacity_factor * max(top_k, 1)
                        // num_experts)))


def topk_route(router_logits, num_experts: int, capacity: int,
               top_k: int = 1):
    """Top-k routing by index: (T, E) logits -> ``(slots, gates, aux)``.

    ``slots``: (k, T) int64, each token's flat slot ``e * C + pos`` per
    choice, ``E * C`` where it found no capacity. ``gates``: (k, T) f32,
    the combine weights (the raw probability at top-1, renormalised over
    the k choices otherwise; differentiable, the router's gradient path).
    ``aux``: the load-balance loss over the first choice (f32 scalar)."""
    if not 1 <= top_k <= num_experts:
        raise ValueError(f"top_k={top_k} must be in [1, num_experts="
                         f"{num_experts}] (beyond E the argmax of the "
                         "fully-masked probabilities would silently "
                         "re-route everything to expert 0)")
    E, C = num_experts, capacity
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)
    experts = choose_experts(probs, top_k)
    gates, aux = route_gates(probs, experts, E)
    base = torch.zeros(E, dtype=torch.int32, device=probs.device)
    ids = torch.arange(E, device=probs.device)[:, None]
    slots = []
    for e in experts:
        # (E, T) one-hot, scanned along its rows (the token axis innermost:
        # a scan over the outer axis of (T, E) is many times slower).
        oh = (e[None, :] == ids).to(torch.int32)
        # Position of each token in its expert's queue, in token order,
        # after the slots earlier choices kept.
        pos = oh.cumsum(dim=1, dtype=torch.int32).gather(
            0, e[None, :])[0] - 1 + base[e]
        kept = pos < C
        slots.append(torch.where(kept, e * C + pos, E * C))
        base = base + (oh * kept[None, :]).sum(dim=1, dtype=torch.int32)
    return torch.stack(slots), gates, aux


def choose_experts(probs, top_k: int):
    """(T, E) router probabilities -> (k, T) chosen experts: an argmax,
    then each later choice the argmax with the earlier ones masked out."""
    remaining = probs.detach()
    experts = []
    for _ in range(top_k):
        e = remaining.argmax(dim=-1)                        # (T,)
        experts.append(e)
        remaining = remaining.scatter(1, e[:, None], 0.0)
    return torch.stack(experts)


def route_gates(probs, experts, num_experts: int):
    """``(gates, aux)`` of :func:`topk_route` for the (k, T) ``experts``
    chosen from ``probs``: each choice's probability (renormalised over
    the k choices at k > 1) and the Switch load-balance loss
    ``E * sum_e f_e * P_e`` over the first choice."""
    gates = [probs.gather(1, e[:, None])[:, 0] for e in experts]
    if len(gates) > 1:
        denom = sum(gates) + 1e-9
        gates = [g / denom for g in gates]
    f = F.one_hot(experts[0], num_experts).to(torch.float32).mean(dim=0)
    aux = num_experts * torch.sum(f * probs.mean(dim=0))
    return torch.stack(gates), aux


def switch_route(router_logits, num_experts: int, capacity: int):
    """Top-1 (Switch) routing: :func:`topk_route` at ``top_k=1``."""
    return topk_route(router_logits, num_experts, capacity, top_k=1)


def routing_stats(slots, num_experts: int, capacity: int,
                  top_k: int = 1) -> dict:
    """Routing-health counters from the kept slots (JAX
    ``routing_stats``): ``dropped_frac``, the share of the T * top_k
    assignments that found no slot; ``expert_load`` (E,), the share each
    expert kept (summing to ``1 - dropped_frac``); ``imbalance``, the
    hottest expert's load times E. All f32."""
    T = slots.shape[1]
    kept = slots[slots < num_experts * capacity]
    per_expert = torch.bincount(kept // capacity,
                                minlength=num_experts).to(torch.float32)
    load = per_expert / float(T * max(top_k, 1))
    return {"dropped_frac": 1.0 - load.sum(),
            "expert_load": load,
            "imbalance": load.max() * num_experts}


class _Dispatch(torch.autograd.Function):
    """(T, dm) tokens -> (S, dm) slot queues by gather: slot s holds token
    ``src[s]`` (``T``: an empty slot, zeros). The backward sums each
    token's ``k`` slots' cotangents by gather (no scatter-add)."""

    @staticmethod
    def forward(ctx, x, src, slots):
        ctx.save_for_backward(slots)
        x_pad = torch.cat([x, x.new_zeros(1, x.shape[1])])
        return x_pad.index_select(0, src)

    @staticmethod
    def backward(ctx, g):
        (slots,) = ctx.saved_tensors
        g_pad = torch.cat([g, g.new_zeros(1, g.shape[1])])
        dx = g_pad.index_select(0, slots[0])
        if slots.shape[0] > 1:
            # Summed in f32 and rounded once, as JAX's transposed einsum.
            dx = dx.to(torch.float32)
            for j in range(1, slots.shape[0]):
                dx = dx + g_pad.index_select(0, slots[j])
        return dx.to(g.dtype), None, None


def _slot_sources(slots, n_slots: int, tokens: int):
    """(S,) int64: the token each slot holds, ``tokens`` where it is
    empty. Kept slots never collide, so the scatter writes each once
    (dropped assignments go to a spare entry that is cut off)."""
    src = torch.full((n_slots + 1,), tokens, dtype=torch.int64,
                     device=slots.device)
    ids = torch.arange(tokens, device=slots.device)
    for j in range(slots.shape[0]):
        src.scatter_(0, slots[j], ids)
    return src[:n_slots]


class _AllToAll(torch.autograd.Function):
    """An equal-split ``all_to_all_single`` over dim 0 of a contiguous
    tensor, differentiable: the backward exchanges the cotangents the
    same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def _wide_bmm(a, b):
    """Batched ``a @ b`` of compute-dtype operands with an f32 result (JAX
    ``einsum(..., preferred_element_type=f32)``)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    return _WideBmm.apply(a, b)


class _WideBmm(torch.autograd.Function):
    """:func:`_wide_bmm` with the backward of the dense path's
    ``_WideDot``: the cotangent rounded to the operands' dtype, the
    gradients in it."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.device.type != "cuda":
            return torch.bmm(a.float(), b.float())
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return torch.bmm(g, b.transpose(1, 2)), torch.bmm(
            a.transpose(1, 2), g)


def moe_mlp(y, router_w, w1, w2, *, num_experts: int,
            capacity_factor: float = 1.25, top_k: int = 1,
            ep_size: int = 1, ep_group=None, stats=None):
    """Top-k routed MoE MLP: (B, L, dm) -> ((B, L, dm), aux).

    ``w1`` (E_local, dm, dff) and ``w2`` (E_local, dff, dm) are the
    stacked weights of this process's experts (all E at ``ep_size`` 1).
    The router matmul gives f32 logits; the experts run two batched
    matmuls around the tanh GELU in f32 (the first with an f32 result,
    the second rounded to the compute dtype, as JAX casts it); combine
    sums the gate-weighted outputs in f32 with the gates rounded to the
    compute dtype first, as JAX's ``combine.astype(cd)``. ``stats``: a
    list that gets this call's :func:`routing_stats` (per process under
    ep)."""
    b, L, dm = y.shape
    T = b * L
    E = num_experts
    e_loc = w1.shape[0]
    if e_loc * max(ep_size, 1) != E:
        raise ValueError(f"{w1.shape[0]} local experts x ep={ep_size} "
                         f"!= num_experts={E}")
    C = capacity(T, E, capacity_factor, top_k)
    cd = y.dtype
    x = y.reshape(T, dm)
    from tpu_ddp_torch.models.transformer import train_dot
    logits = train_dot(x, router_w, cd, out_dtype=torch.float32)
    slots, gates, aux = topk_route(logits, E, C, top_k=top_k)
    if stats is not None:
        stats.append(routing_stats(slots, E, C, top_k))

    src = _slot_sources(slots, E * C, T)
    expert_in = _Dispatch.apply(x, src, slots).reshape(E, C, dm)
    if ep_size > 1:
        # (E, C, dm) -> this process's experts' queues from every source,
        # (E_loc, ep * C, dm) in source order (JAX's tiled all_to_all).
        recv = _AllToAll.apply(expert_in, ep_group)
        expert_in = recv.reshape(ep_size, e_loc, C, dm).transpose(
            0, 1).reshape(e_loc, ep_size * C, dm)
    h = _wide_bmm(expert_in, w1.to(cd))
    h = F.gelu(h, approximate="tanh").to(cd)
    out = torch.bmm(h, w2.to(cd))
    if ep_size > 1:
        out = out.reshape(e_loc, ep_size, C, dm).transpose(0, 1)
        out = _AllToAll.apply(out.contiguous(), ep_group).reshape(E, C, dm)
    out_pad = torch.cat([out.reshape(E * C, dm), out.new_zeros(1, dm)])
    g = gates.to(cd).to(torch.float32)
    y_out = out_pad.index_select(0, slots[0]).to(torch.float32) \
        * g[0][:, None]
    for j in range(1, slots.shape[0]):
        y_out = y_out + out_pad.index_select(0, slots[j]).to(
            torch.float32) * g[j][:, None]
    return y_out.to(cd).reshape(b, L, dm), aux
