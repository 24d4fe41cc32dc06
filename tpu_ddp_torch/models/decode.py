"""Shared KV-cache decode core — the port of tpu_ddp/models/decode.py.

One home for the incremental-attention math, used by both
:func:`tpu_ddp_torch.models.generate.generate` (contiguous
``(B, max_len, KV, hd)`` caches) and the continuous-batching serving
engine (tpu_ddp_torch/serve/, block-paged pool). Cache updates are in
place: a torch tensor is mutable, so the cache is written where it lies
instead of being returned as a new array.

Sampling differs from JAX's by design. Greedy decoding
(``temperature == 0``) is argmax and matches JAX exactly. For
``temperature > 0`` JAX draws from threefry keyed by
``fold_in(key(seed), position)``, which torch cannot reproduce bit for
bit; the port keeps the property that matters — the draw is stateless
and keyed only by ``(seed, position)`` — with Gumbel-max over a
counter-based integer hash of ``(seed, position, vocab index)``. The same
request therefore samples the same tokens on CPU and GPU, whatever its
batch neighbours, but not the tokens JAX samples.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_ddp_torch.models.transformer import layer_norm
from tpu_ddp_torch.ops.quant import qdot

_NEG_INF = -1e30
_M32 = 0xFFFFFFFF


def check_decodable(model) -> None:
    """Refuse model configs the decode path cannot serve: it runs dense
    single-device models (no sequence/tensor/expert sharding, no MoE)."""
    for attr in ("sp_axis", "tp_axis", "ep_axis"):
        if getattr(model, attr, None) is not None:
            raise ValueError(f"decode runs dense single-device models; "
                             f"{attr}={getattr(model, attr)!r} is set")
    if getattr(model, "moe_experts", 0):
        raise ValueError("decode serves dense models only; MoE is not "
                         "ported yet")


def mlp(model, blk, y):
    """Dense block MLP on an activation bank ``y`` (B, L, dm): two qdot
    matmuls around the tanh-approximate GELU (``jax.nn.gelu``'s
    default) in f32."""
    cd = model.compute_dtype
    y = qdot(y, blk["w1"], cd)
    y = F.gelu(y.to(torch.float32), approximate="tanh").to(cd)
    return qdot(y, blk["w2"], cd).to(cd)


def attend_cached(model, q, ck, cv, q_pos):
    """q: (B, Lq, H, hd) at absolute positions ``q_pos`` — (Lq,) shared
    across the batch, or (B, Lq) per row; ck/cv: full (B, S, KV, hd)
    cache views. Attends each query over cache positions <= its own: the
    causal mask also covers not-yet-written or stale slots, whose
    ``exp(-1e30 - max)`` underflows to an exact 0 weight. Under GQA the
    grouped einsum contracts Q heads (B, Lq, KV, G, hd) against the
    KV-width cache without expanding it. Scores, softmax and the PV
    product run in f32."""
    scale = 1.0 / (model.head_dim ** 0.5)
    b, lq, h, hd = q.shape
    kv = ck.shape[2]
    qg = q.reshape(b, lq, kv, h // kv, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                          ck.to(torch.float32)) * scale
    k_pos = torch.arange(ck.shape[1], device=q.device)
    qp = q_pos if q_pos.dim() == 2 else q_pos[None]
    mask = k_pos[None, None, None, None, :] > qp[:, None, None, :, None]
    scores = scores.masked_fill(mask, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, cv.to(torch.float32))
    return out.reshape(b, lq, h, hd).to(q.dtype)


def project_qkv(model, blk, x, pos):
    """Pre-attention half of a block: LN1 + the QKV projection with RoPE
    at ``pos`` ((L,) or (B, L)). The caller writes k/v into ITS cache
    layout before attending."""
    y = layer_norm(x, blk["ln1"]["scale"], blk["ln1"]["bias"])
    return model.qkv_proj(blk, y, pos)


def block_finish(model, blk, x, o):
    """Post-attention half of a block: output projection + residual,
    LN2 + MLP + residual. (B, L, dm) -> (B, L, dm)."""
    cd = model.compute_dtype
    b, L = x.shape[0], x.shape[1]
    o = qdot(o.reshape(b, L, -1), blk["wo"], cd,
             reshape=(-1, model.d_model)).to(cd)
    x = x + o
    y = layer_norm(x, blk["ln2"]["scale"], blk["ln2"]["bias"])
    return x + mlp(model, blk, y)


@torch.no_grad()
def forward_cached(model, params, tokens, caches, start: int):
    """Run ``tokens`` (B, L) at absolute positions ``start..start+L-1``
    against contiguous (B, max_len, KV, hd) caches, writing their K/V in
    place. Returns the last position's logits (B, V) f32."""
    cd = model.compute_dtype
    L = tokens.shape[1]
    pos = start + torch.arange(L, device=tokens.device)
    x = params["embed"][tokens].to(cd)
    for blk, (ck, cv) in zip(params["blocks"], caches):
        q, k, v = project_qkv(model, blk, x, pos)
        ck[:, start:start + L] = k.to(ck.dtype)
        cv[:, start:start + L] = v.to(cv.dtype)
        o = attend_cached(model, q, ck, cv, pos)
        x = block_finish(model, blk, x, o)
    return model.head_apply(params, x[:, -1:])[:, 0]


def init_cache(model, batch: int, max_len: int, device):
    """Per-block (K, V) buffers of (B, max_len, KV, hd) zeros each."""
    shape = (batch, max_len, model.kv_heads, model.head_dim)
    return tuple((torch.zeros(shape, dtype=model.compute_dtype,
                              device=device),
                  torch.zeros(shape, dtype=model.compute_dtype,
                              device=device))
                 for _ in range(model.num_layers))


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for int64 tensors holding uint32 values,
    in 16-bit halves of ``c`` so no product leaves int64's range."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x):
    """A 32-bit integer finalizer (lowbias32): every input bit affects
    every output bit."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gumbel_noise(seed, position, vocab: int):
    """Standard Gumbel noise (..., vocab) f64 that depends only on
    ``(seed, position, vocab index)``: a counter-based hash, so a draw
    needs no generator state and is the same on every device."""
    dev = seed.device
    h = _mix32(seed.to(torch.int64) & _M32)
    h = _mix32((h + (position.to(torch.int64) & _M32)) & _M32)
    idx = torch.arange(vocab, dtype=torch.int64, device=dev)
    h = _mix32((h[..., None] + idx) & _M32)
    u = ((h >> 8).to(torch.float64) + 0.5) * 2.0 ** -24  # in (0, 1)
    return -torch.log(-torch.log(u))


def sample_token(model, logits, temperature, seed, position):
    """The one sampling rule for serving: greedy argmax where
    ``temperature == 0``, else Gumbel-max at the given temperature keyed
    by (per-request ``seed``, the ``position`` the sampled token will
    occupy). ``logits`` (..., V); the other arguments are tensors of the
    leading shape. Returns (tokens, logprob-of-token), both of the
    leading shape."""
    del model
    logits = logits.to(torch.float32)
    temperature = temperature.to(torch.float32)
    greedy = logits.argmax(dim=-1)
    scaled = (logits.to(torch.float64)
              / temperature.clamp(min=1e-6).to(torch.float64)[..., None])
    sampled = (scaled + gumbel_noise(seed, position,
                                     logits.shape[-1])).argmax(dim=-1)
    tok = torch.where(temperature > 0, sampled, greedy)
    logp = F.log_softmax(logits, dim=-1)
    return tok, torch.gather(logp, -1, tok[..., None])[..., 0]
