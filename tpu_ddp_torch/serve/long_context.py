"""Long-context serving: the tiered-KV view of the step math — the port of
the tiered half of tpu_ddp/serve/long_context.py. Context-parallel
chunked prefill (the other half) shards a chunk over a mesh's sp axis and
is ROADMAP Queue 1 item 10.5: :func:`cp_prefill_step` raises.

The tiered steps read a pool whose pages straddle two device tiers
(serve/kv_pool.py): hot pages in the exact cache dtype, cold pages
quantized by the cold-page codec (parallel/compress.py). The block table
splits into two physical tables — hot slots and cold slots, zero where a
block is not in that tier — and each layer's attention view is
``where(is_hot, hot_gather, dequant(cold_gather))``. A block resident in
neither tier (fresh, or an idle row's null entries) reads both null pages
and contributes values the causal mask ignores. Writes always target hot
slots (the engine promotes each write frontier first), so the write is
the single-tier one with the hot table in place of the logical one: the
engine passes the hot table as ``tables`` and :func:`tiered_view` as the
view to ``engine.decode_bank`` and ``engine.prefill_chunk``.

Sampling is keyed on (seed, position) only, so dequantization error
perturbs logits, never the random stream; with the bf16 codec under a
bf16 hot dtype the round trip is exact and the tiered stream equals the
single-tier one bit for bit.
"""

from __future__ import annotations

import torch

from tpu_ddp_torch.parallel.compress import page_dequantize

__all__ = ["tiered_view", "tiered_decode_bank", "tiered_prefill_chunk",
           "cp_prefill_step"]


def _mixed_view(hot_buf, cold_buf, cold_scale, li, hot_tables, cold_tables):
    """Layer ``li``'s pages over a two-tier pool: hot pages gathered by
    their slot table, cold pages gathered and dequantized, selected per
    block. ``hot_tables``/``cold_tables`` (S, BPS), slot 0 = not in that
    tier. Returns (S, BPS, bs, KV, hd) in the hot dtype."""
    hk = hot_buf[li][hot_tables]
    ck = page_dequantize(cold_buf[li][cold_tables],
                         cold_scale[li][cold_tables], hot_buf.dtype)
    is_hot = (hot_tables > 0)[..., None, None, None]
    return torch.where(is_hot, hk, ck)


def tiered_view(pool, hot_tables, cold_tables):
    """The attention view ``view(li) -> (K, V)`` of the tiered steps,
    each (S, BPS * bs, KV, hd), read from ``pool``'s hot and cold
    buffers at call time (after the step's own writes)."""
    s, bps = hot_tables.shape

    def view(li):
        shape = (s, bps * pool.block_size) + tuple(pool.k.shape[3:])
        ck = _mixed_view(pool.k, pool.cold_k, pool.cold_sk, li,
                         hot_tables, cold_tables).reshape(shape)
        cv = _mixed_view(pool.v, pool.cold_v, pool.cold_sv, li,
                         hot_tables, cold_tables).reshape(shape)
        return ck, cv

    return view


def tiered_decode_bank(model, pool, params, hot_tables, cold_tables,
                       lengths, last_tokens, temps, seeds):
    """The tiered twin of ``engine.decode_bank``: one token for every live
    slot, reading hot pages directly and cold pages through the dequant,
    writing the new token's K/V to the frontier hot slot. Returns
    (tokens, logprobs, bad)."""
    from tpu_ddp_torch.serve.engine import decode_bank
    _, _, toks, lps, bad = decode_bank(
        model, pool.block_size, params, pool.k, pool.v, hot_tables,
        lengths, last_tokens, temps, seeds,
        view=tiered_view(pool, hot_tables, cold_tables))
    return toks, lps, bad


def tiered_prefill_chunk(model, pool, params, hot_table, cold_table,
                         tokens, start: int, prompt_len: int, temp, seed):
    """The tiered twin of ``engine.prefill_chunk`` for one slot: the
    chunk's own blocks are hot (the engine promotes them first), earlier
    chunks' pages may be cold and are read through the dequant. Returns
    (token, logprob)."""
    from tpu_ddp_torch.serve.engine import prefill_chunk
    _, _, tok, lp = prefill_chunk(
        model, pool.block_size, params, pool.k, pool.v, hot_table, tokens,
        start, prompt_len, temp, seed,
        view=tiered_view(pool, hot_table[None], cold_table[None]))
    return tok, lp


def cp_prefill_step(*args, **kwargs):
    """Context-parallel chunked prefill needs a mesh with an sp axis of
    extent >= 2; the port serves on one card."""
    raise NotImplementedError(
        "context-parallel prefill (ring / ulysses) is not ported to "
        "tpu_ddp_torch yet (ROADMAP Queue 1 item 10.5)")
