"""Eval metrics (tpu_ddp/ops/metrics.py; reference part1/main.py:96-111)."""

from __future__ import annotations


def top1_correct(logits, labels):
    """Number of argmax-correct predictions in the batch (a 0-d tensor)."""
    return (logits.argmax(-1) == labels).sum()
