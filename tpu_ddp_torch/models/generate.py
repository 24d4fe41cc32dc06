"""Autoregressive generation over contiguous KV caches — the port of
tpu_ddp/models/generate.py, and what the serving engine is held against
inside the port.

The cache math is tpu_ddp_torch/models/decode.py, shared with the engine,
so both run the same projection/attention/MLP code; this module owns the
token loop. Sampling is :func:`decode.sample_token`, keyed by (``seed``,
the position the sampled token occupies) — the rule the engine uses, so a
request sampled here and served by the engine gets the same tokens.
"""

from __future__ import annotations

import torch

from tpu_ddp_torch.models.decode import (
    check_decodable,
    forward_cached,
    init_cache,
    sample_token,
)


@torch.no_grad()
def generate(model, params, prompt, max_new_tokens: int,
             temperature: float = 0.0, seed: int = 0):
    """Sample ``max_new_tokens`` continuations of ``prompt`` (B, P) on
    the device the parameters live on. ``temperature == 0`` is greedy
    argmax; otherwise stateless sampling at that temperature keyed by
    ``seed``. Returns the (B, max_new_tokens) generated tokens (int64).
    The prompt plus generation must fit ``model.max_seq_len``."""
    check_decodable(model)
    dev = params["embed"].device
    prompt = torch.as_tensor(prompt, dtype=torch.int64, device=dev)
    if prompt.dim() != 2 or prompt.shape[1] < 1:
        raise ValueError("prompt must be (batch, prompt_len >= 1)")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    b, p_len = prompt.shape
    total = p_len + max_new_tokens
    if total > model.max_seq_len:
        raise ValueError(f"prompt + generation = {total} exceeds "
                         f"max_seq_len={model.max_seq_len}")
    if temperature < 0:
        raise ValueError("temperature must be >= 0")
    caches = init_cache(model, b, total, dev)
    temps = torch.full((b,), float(temperature), device=dev)
    seeds = torch.full((b,), int(seed), dtype=torch.int64, device=dev)

    def pick(logits, position):
        pos = torch.full((b,), position, dtype=torch.int64, device=dev)
        return sample_token(model, logits, temps, seeds, pos)[0]

    logits = forward_cached(model, params, prompt, caches, 0)
    tok = pick(logits, p_len)
    out = [tok]
    for i in range(max_new_tokens - 1):
        logits = forward_cached(model, params, tok[:, None], caches,
                                p_len + i)
        tok = pick(logits, p_len + i + 1)
        out.append(tok)
    return torch.stack(out, dim=1)
