"""The cold-page codec of the tiered KV pool — the port of the page half of
tpu_ddp/parallel/compress.py (``page_quantize``, ``page_dequantize``).
The gradient wires of that module are ROADMAP Queue 1 item 9.3.

The same per-block symmetric int8 scheme as the gradient compressor —
scale = max|x| / 127, clamped away from zero — with deterministic
round-half-to-even (``torch.round``, as ``jnp.round``): a KV page demoted
and promoted twice dequantizes identically both times. The scale is per
(layer, page, token row), so one row's outlier cannot flatten its
neighbours' resolution.
"""

from __future__ import annotations

import torch

__all__ = ["page_quantize", "page_dequantize"]


def page_quantize(x, cold_dtype):
    """Quantize KV pages ``x`` (..., bs, KV, hd) for cold storage.

    Returns ``(q, scale)`` with ``scale`` f32 shaped like ``x`` minus the
    two trailing (KV, hd) axes. ``cold_dtype`` ``torch.int8`` -> per-row
    symmetric int8; ``torch.bfloat16`` -> a plain downcast with unit
    scales (lossless when the hot dtype is already bf16)."""
    if cold_dtype == torch.bfloat16:
        return (x.to(torch.bfloat16),
                torch.ones(x.shape[:-2], dtype=torch.float32,
                           device=x.device))
    if cold_dtype != torch.int8:
        raise ValueError(f"cold dtype {cold_dtype}: expected torch.int8 "
                         "or torch.bfloat16")
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=(-2, -1))
    scale = torch.clamp_min(amax / 127.0, 1e-30)
    q = torch.clamp(torch.round(xf / scale[..., None, None]), -127, 127)
    return q.to(torch.int8), scale


def page_dequantize(q, scale, out_dtype):
    """Inverse of :func:`page_quantize`: (..., bs, KV, hd) pages back in
    ``out_dtype`` (the pool's hot dtype)."""
    return (q.to(torch.float32) * scale[..., None, None]).to(out_dtype)
