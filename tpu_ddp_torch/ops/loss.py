"""Cross-entropy loss (tpu_ddp/ops/loss.py): the reference's
``torch.nn.CrossEntropyLoss()`` (part1/main.py:119) written over
``logsumexp`` in f32, as the JAX package writes it."""

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
