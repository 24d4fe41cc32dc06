"""Cross-entropy losses (tpu_ddp/ops/loss.py): the reference's
``torch.nn.CrossEntropyLoss()`` (part1/main.py:119) written over
``logsumexp`` in f32, as the JAX package writes it, and the LM's
chunked-vocab cross-entropy, which never holds the (T, V) logits."""

from __future__ import annotations

import torch


def softmax_cross_entropy(logits, labels):
    """Per-example CE of integer ``labels`` against ``logits`` (f32)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.long()[:, None])[:, 0]
    return lse - picked


def cross_entropy_loss(logits, labels):
    """Mean-reduced CE (reference part1/main.py:74-75)."""
    return softmax_cross_entropy(logits, labels).mean()


def _mm_f32(a, b):
    """2-D ``a @ b`` of one dtype with f32 sums and an f32 result, as the
    LM's dense head computes its logits (models/transformer.py:_mm)."""
    if a.device.type != "cuda" or a.dtype == torch.float32:
        return torch.mm(a.float(), b.float())
    return torch.mm(a, b, out_dtype=torch.float32)


class _ChunkedCE(torch.autograd.Function):
    """Forward: an online logsumexp over vocabulary chunks, keeping the
    running max ``m``, the scaled sum ``s`` and the label's logit. Saves
    only the inputs and (m, s): the backward recomputes each chunk's
    logits, as the JAX scan body's ``jax.checkpoint`` does, so no tensor
    of T x V elements outlives a chunk."""

    @staticmethod
    def forward(ctx, hidden, head, labels, chunk):
        t, v = hidden.shape[0], head.shape[1]
        f32 = torch.float32
        m = torch.full((t,), float("-inf"), dtype=f32, device=hidden.device)
        s = torch.zeros((t,), dtype=f32, device=hidden.device)
        picked = torch.zeros((t,), dtype=f32, device=hidden.device)
        for c0 in range(0, v, chunk):
            logits = _mm_f32(hidden, head[:, c0:c0 + chunk].to(hidden.dtype))
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            local = labels - c0
            inside = (local >= 0) & (local < chunk)
            lab = logits.gather(-1, local.clamp(0, chunk - 1)[:, None])[:, 0]
            picked = torch.where(inside, lab, picked)
        ctx.chunk = chunk
        ctx.save_for_backward(hidden, head, labels, m, s)
        return m + torch.log(s) - picked

    @staticmethod
    def backward(ctx, g):
        hidden, head, labels, m, s = ctx.saved_tensors
        chunk = ctx.chunk
        lse = m + torch.log(s)
        g = g.float()
        dh = torch.zeros(hidden.shape, dtype=torch.float32,
                         device=hidden.device)
        dhead = torch.empty_like(head)
        for c0 in range(0, head.shape[1], chunk):
            w = head[:, c0:c0 + chunk].to(hidden.dtype)
            p = torch.exp(_mm_f32(hidden, w) - lse[:, None])
            local = labels - c0
            inside = (local >= 0) & (local < chunk)
            # Minus one at the label's column, where it is in this chunk
            # (a scatter: no host read of the mask).
            p.scatter_add_(1, local.clamp(0, chunk - 1)[:, None],
                           -inside.float()[:, None])
            # The dense head's backward: the logits' cotangent rounded to
            # the operands' dtype, each product with f32 sums.
            gc = (p * g[:, None]).to(hidden.dtype)
            dh += _mm_f32(gc, w.t())
            dhead[:, c0:c0 + chunk] = _mm_f32(hidden.t(), gc).to(
                hidden.dtype)
        return dh.to(hidden.dtype), dhead, None, None


def chunked_vocab_cross_entropy(hidden, head, labels, chunk: int):
    """Per-token CE of ``hidden @ head`` without the (T, V) logits.

    ``hidden``: (T, dm) final-LayerNorm activations in the compute dtype;
    ``head``: (dm, V) parameter; ``labels``: (T,) ints. Each chunk's
    logits are the dense head's (operands in ``hidden``'s dtype, f32
    sums and result), so the loss equals ``softmax_cross_entropy(hidden @
    head, labels)`` up to the order of the f32 sums. Memory is O(T *
    chunk) in the forward and in the backward, which recomputes each
    chunk's product: a memory lever that costs one more head product."""
    t, v = hidden.shape[0], head.shape[1]
    if chunk <= 0 or v % chunk:
        raise ValueError(f"vocab {v} not divisible by chunk {chunk}")
    if labels.shape != (t,):
        raise ValueError(f"labels {tuple(labels.shape)} for {t} rows")
    return _ChunkedCE.apply(hidden, head, labels.long(), int(chunk))
