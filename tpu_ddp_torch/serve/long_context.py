"""Long-context serving (tpu_ddp/serve/long_context.py): the tiered-KV
view of the step math, and context-parallel chunked prefill.

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

Context-parallel chunked prefill (:func:`cp_prefill_step`) shards one
prefill chunk over the processes of an sp group: each embeds and
projects its ``C/sp`` slice of the chunk, attends with ring or Ulysses
attention seeded from the pool's view of the committed prefix (the
cache arguments of parallel/ring_attention.py and parallel/ulysses.py,
``q_offset`` the chunk's start), then the chunk's K/V and logits are
all-gathered over the group and land in the pool through the same
scatter and boundary sample as ``engine.prefill_chunk``. The engine runs
on every process of the group, in lockstep and with the same host state
(``ServeEngine(cp_prefill=..., sp_group=...)``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

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


def _gather(t, group, sp: int, dim: int):
    """Every process's ``t`` of the sp group, concatenated on ``dim`` in
    group-rank order."""
    parts = [torch.empty_like(t) for _ in range(sp)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


@torch.no_grad()
def cp_prefill_step(model, block_size: int, params, pool_k, pool_v, table,
                    tokens, start: int, prompt_len: int, temp, seed, *,
                    mode: str, group=None):
    """One prefill chunk of one slot, sharded over the sp group ``group``
    (the default group when None): the arguments and the result of
    ``engine.prefill_chunk``, and ``mode`` ("ring" or "ulysses"). Every
    process passes the whole chunk ``tokens`` (1, C), C a multiple of
    the group's size, and the same pool; each attends its slice's queries
    over the committed cache (positions < ``start``) and the chunk.
    Returns (pool_k, pool_v, token, logprob), the same on every
    process."""
    from tpu_ddp_torch.models.decode import (block_finish, project_qkv,
                                             sample_token)
    from tpu_ddp_torch.parallel.ring_attention import ring_attention
    from tpu_ddp_torch.parallel.ulysses import ulysses_attention
    from tpu_ddp_torch.serve.engine import write_slots
    if mode not in ("ring", "ulysses"):
        raise ValueError(f"cp_prefill={mode!r}: expected 'ring' or "
                         "'ulysses'")
    cd = model.compute_dtype
    sp, r = dist.get_world_size(group), dist.get_rank(group)
    C = tokens.shape[1]
    lc = C // sp
    dev = tokens.device
    cache_len = table.shape[0] * block_size
    p = start + r * lc + torch.arange(lc, device=dev)
    cache_valid = torch.arange(cache_len, device=dev) < start
    attn = ulysses_attention if mode == "ulysses" else ring_attention
    view = (1, cache_len) + tuple(pool_k.shape[3:])
    x = params["embed"][tokens[:, r * lc:(r + 1) * lc]].to(cd)
    ks, vs = [], []
    for li, blkp in enumerate(params["blocks"]):
        q, k, v = project_qkv(model, blkp, x, p)
        ck = pool_k[li][table].reshape(view).to(cd)
        cv = pool_v[li][table].reshape(view).to(cd)
        o = attn(q, k, v, group, sp, causal=True, q_offset=start,
                 cache_k=ck, cache_v=cv, cache_valid=cache_valid)
        x = block_finish(model, blkp, x, o)
        ks.append(k[0])
        vs.append(v[0])
    logits = _gather(model.head_apply(params, x)[0], group, sp, 0)
    kc = _gather(torch.stack(ks), group, sp, 1)        # (layers, C, KV, hd)
    vc = _gather(torch.stack(vs), group, sp, 1)
    pos = start + torch.arange(C, device=dev)
    limit = torch.full((1,), prompt_len, dtype=torch.int64, device=dev)
    blk_idx, off = write_slots(table[None], pos[None], block_size, limit)
    blk_idx, off = blk_idx[0], off[0]
    for li in range(kc.shape[0]):
        pool_k[li].index_put_((blk_idx, off), kc[li].to(pool_k.dtype))
        pool_v[li].index_put_((blk_idx, off), vc[li].to(pool_v.dtype))
    last = min(max(prompt_len - 1 - start, 0), C - 1)
    tok, lp = sample_token(model, logits[last:last + 1], temp, seed, limit)
    return pool_k, pool_v, tok[0], lp[0]
