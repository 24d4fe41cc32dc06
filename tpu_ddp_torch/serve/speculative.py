"""Speculative decoding: up to ``k+1`` tokens per engine step instead of
one — the port of tpu_ddp/serve/speculative.py.

Three draft families, on the ``spec_draft`` knob:

``"chain"`` — one engine step runs k+1 sequential passes of the engine's
own one-token decode step (``engine.decode_bank``), each feeding the
token the previous pass sampled, with no host sync inside the window.
Every emitted sample comes from the same computation on the same inputs
as the k=0 step, so the (token, logprob) stream equals the k=0 stream
bit for bit. There is no separate draft: every proposal is accepted and
no KV rollback occurs. What it buys is the host work of an engine step
(admission, batch assembly, the output copy, per-token bookkeeping)
paid once per k+1 tokens.

``"self-<j>"`` / ``"quant"`` — draft then verify, in one step
(:func:`spec_step`): a draft (an early exit over the target's first j
blocks sharing ln_f and the head, or a full-depth int8 twin) proposes k
tokens, then the target evaluates all k+1 columns and samples its own
token at every position.

**The accept rule** (:func:`accept_length`): the host emits the longest
prefix of *target* samples whose inputs the draft guessed right — column
``c`` is valid iff the draft's proposal for position ``c`` equals the
target's own sample at ``c-1``. A wrong guess truncates the prefix; it
never substitutes a draft token, so every step emits at least one token
and every emitted token is the one the k=0 step would have sampled.
Every position samples with the (seed, position) key the one-token step
uses (models/decode.py), which is what buys acceptance at temperature
> 0.

**Verification per column.** Each verify column is the one-token
``decode_bank`` math at the same shapes (M = slots for every matmul),
never one W-column product, so in eager PyTorch an accepted column
computes exactly what the k=0 step computes: the verify overwrites every
layer's K/V at its position with target values before attending, and the
draft's values at later positions get exact-zero weights.

**KV rollback.** Draft and verify write positions ``L..L+k``; on
rejection the tail beyond the new length holds garbage (causally masked)
and the scheduler's ``trim_blocks`` frees whole tail blocks. Positions
at or beyond the request's ``prompt + max_new`` budget write to the null
block (``engine.write_slots``), so speculation never allocates beyond the
admission-time reservation.
"""

from __future__ import annotations

import torch

__all__ = ["parse_spec_draft", "draft_bank", "verify_bank", "spec_step",
           "accept_length"]


def parse_spec_draft(spec: str) -> tuple[str, int | None]:
    """Validate and parse ``spec_draft``: ``"chain"``, ``"self-<j>"``
    (j >= 1) or ``"quant"``. Returns ("chain", None), ("self", j) or
    ("quant", None); raises ValueError on anything else."""
    s = str(spec).strip()
    if s == "chain":
        return "chain", None
    if s == "quant":
        return "quant", None
    if s.startswith("self-"):
        try:
            j = int(s[len("self-"):])
        except ValueError:
            j = 0
        if j >= 1:
            return "self", j
    raise ValueError(
        f"spec_draft={spec!r}: expected 'chain', 'self-<j>' (j >= 1) "
        "or 'quant' (TPU_DDP_SPEC_DRAFT)")


def draft_bank(model, num_layers: int, block_size: int, params, pool_k,
               pool_v, tables, lengths, last_tokens, temps, seeds, limits,
               k: int):
    """Autoregressive k-token draft over the first ``num_layers`` blocks
    of ``params`` (the whole stack for a "quant" draft): k one-token
    whole-bank passes sharing the target's paged pool. Pass ``i`` feeds
    the previous token at position ``lengths + i``, writes its K/V (to
    the null block at or beyond ``limits``), attends and samples with the
    key the target uses at that position. Returns the proposals (S, k)."""
    from tpu_ddp_torch.serve.engine import bank_logits, sample_bank
    tok, drafted = last_tokens, []
    for i in range(k):
        pos = lengths + i
        logits = bank_logits(model, block_size, params, pool_k, pool_v,
                             tables, pos, tok, limits=limits,
                             num_layers=num_layers)
        tok, _, _ = sample_bank(model, logits, temps, seeds, pos)
        drafted.append(tok)
    return torch.stack(drafted, dim=1)


def verify_bank(model, block_size: int, params, pool_k, pool_v, tables,
                lengths, tok_mat, temps, seeds, limits):
    """The target's verification of ``tok_mat`` (S, W) — column 0 is each
    slot's pending token, columns 1..W-1 the draft's proposals — at
    positions ``lengths..lengths+W-1``, one column at a time, each column
    the one-token ``engine.decode_bank`` math. Returns tokens, logprobs
    and bad flags, each (S, W)."""
    from tpu_ddp_torch.serve.engine import decode_bank
    cols = []
    for c in range(tok_mat.shape[1]):
        _, _, toks, lps, bad = decode_bank(
            model, block_size, params, pool_k, pool_v, tables, lengths + c,
            tok_mat[:, c], temps, seeds, limits=limits)
        cols.append((toks, lps, bad))
    return tuple(torch.stack([col[i] for col in cols], dim=1)
                 for i in range(3))


@torch.no_grad()
def spec_step(model, block_size: int, params, dparams, pool_k, pool_v,
              tables, lengths, last_tokens, temps, seeds, limits, k: int,
              draft_layers: int):
    """The fused speculative step: the k-token draft (``dparams`` over
    its first ``draft_layers`` blocks), then the target's verification of
    all k+1 columns with ``params``. The pool is written in place.
    Returns (drafted (S, k), tokens, logprobs, bad (S, k+1))."""
    if not 1 <= draft_layers <= model.num_layers:
        raise ValueError(
            f"draft_layers must be in 1..{model.num_layers}, got "
            f"{draft_layers}")
    if k < 1:
        raise ValueError(f"spec_k must be >= 1 to speculate, got {k}")
    drafted = draft_bank(model, draft_layers, block_size, dparams, pool_k,
                         pool_v, tables, lengths, last_tokens, temps, seeds,
                         limits, k)
    tok_mat = torch.cat([last_tokens[:, None], drafted], dim=1)
    toks, lps, bad = verify_bank(model, block_size, params, pool_k, pool_v,
                                 tables, lengths, tok_mat, temps, seeds,
                                 limits)
    return drafted, toks, lps, bad


def accept_length(drafted, target, k: int) -> int:
    """The accept rule: the number of proposals accepted = the longest
    prefix where the draft's proposal for position c equals the target's
    own sample at c-1. The engine emits target columns
    ``0..accept_length`` — the +1 is the correction token, so a
    speculative step never emits fewer tokens than the one-token step."""
    g = 0
    while g < k and int(drafted[g]) == int(target[g]):
        g += 1
    return g
