"""Decoder-only transformer LM — the serving slice of
tpu_ddp/models/transformer.py.

Same conventions as the JAX package: parameters are a plain dict of
tensors in the JAX layouts (``wqkv`` (dm, 3, H, hd), ``wo`` (H, hd, dm),
``w1`` (dm, d_ff), ...), f32 parameters with a bf16 compute dtype, f32
softmax/LN statistics, and a frozen dataclass for the static config.
Only what the decode path needs is here: RoPE, LayerNorm, the QKV and
vocabulary projections (routed through ops/quant.py ``qdot``) and the
dense presets. Training ``apply`` arrives with the LM-training slice.
"""

from __future__ import annotations

import dataclasses

import torch


def rope(x, positions, base: float = 10000.0):
    """Rotary position embedding, half-split rotation with f32 angles.
    x: (B, L, H, D); positions: (L,) shared across the batch, or (B, L)
    per row (continuous batching, where every live sequence sits at its
    own offset)."""
    d = x.shape[-1]
    half = d // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]  # (..., L, 1, half)
    sin = torch.sin(angles)[..., None, :]
    if angles.dim() == 2:  # shared (L,) positions: add the batch dim
        cos, sin = cos[None], sin[None]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm in f32 with the population variance, cast back to the
    input dtype."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale
            + bias).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class TransformerLM:
    """GPT-style pre-LN decoder (dense, MHA or GQA). Causal by
    construction."""

    name: str = "TransformerLM"
    vocab_size: int = 32000
    num_layers: int = 4
    num_heads: int = 8
    # Grouped-query attention: K/V get ``num_kv_heads`` heads shared by
    # groups of Q heads. None -> MHA (the fused "wqkv" layout).
    num_kv_heads: int | None = None
    d_model: int = 512
    d_ff: int = 2048
    max_seq_len: int = 2048
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def kv_heads(self) -> int:
        return (self.num_kv_heads if self.num_kv_heads is not None
                else self.num_heads)

    @property
    def is_gqa(self) -> bool:
        return self.kv_heads != self.num_heads

    def __post_init__(self):
        if self.kv_heads < 1:
            raise ValueError(f"num_kv_heads must be >= 1, got "
                             f"{self.kv_heads}")
        if self.num_heads % self.kv_heads:
            raise ValueError(
                f"num_heads={self.num_heads} not divisible by "
                f"num_kv_heads={self.kv_heads}")

    def param_shapes(self) -> dict:
        """The parameter tree's shapes: :meth:`init`'s layout, which is
        the JAX package's."""
        dm, dff, v = self.d_model, self.d_ff, self.vocab_size
        h, hd = self.num_heads, self.head_dim
        ln = {"scale": (dm,), "bias": (dm,)}
        blk = {"ln1": dict(ln), "wo": (h, hd, dm), "ln2": dict(ln)}
        if self.is_gqa:
            blk["wq"] = (dm, h, hd)
            blk["wkv"] = (dm, 2, self.kv_heads, hd)
        else:
            blk["wqkv"] = (dm, 3, h, hd)
        blk["w1"] = (dm, dff)
        blk["w2"] = (dff, dm)
        return {"embed": (v, dm), "ln_f": dict(ln), "head": (dm, v),
                "blocks": tuple(dict(blk) for _ in range(self.num_layers))}

    def init(self, generator: torch.Generator) -> dict:
        """Parameter dict on ``generator.device``: matrices drawn
        N(0, 0.02^2) from ``generator``, LayerNorm scale 1 and bias 0."""
        dev, dt = generator.device, self.param_dtype

        def leaf(name, shape):
            if name == "scale":
                return torch.ones(shape, dtype=dt, device=dev)
            if name == "bias":
                return torch.zeros(shape, dtype=dt, device=dev)
            return 0.02 * torch.randn(shape, generator=generator,
                                      dtype=dt, device=dev)

        def build(name, node):
            if isinstance(node, dict):
                return {k: build(k, v) for k, v in node.items()}
            if isinstance(node, tuple) and node and isinstance(node[0],
                                                               dict):
                return tuple(build(name, b) for b in node)
            return leaf(name, node)

        return build("", self.param_shapes())

    def qkv_proj(self, blk, y, pos):
        """Projected + RoPE'd q (B, L, H, hd) and k/v (B, L, KV, hd) from
        normalized input ``y``: one fused "wqkv" matmul for MHA, separate
        "wq"/"wkv" for GQA, each through ``qdot``."""
        from tpu_ddp_torch.ops.quant import qdot
        cd = self.compute_dtype
        b, lc, hd = y.shape[0], y.shape[1], self.head_dim
        h = self.num_heads
        if not self.is_gqa:
            qkv = qdot(y, blk["wqkv"], cd, reshape=(self.d_model, -1))
            qkv = qkv.to(cd).reshape(b, lc, 3, h, hd)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q = qdot(y, blk["wq"], cd, reshape=(self.d_model, -1))
            q = q.to(cd).reshape(b, lc, h, hd)
            kvp = qdot(y, blk["wkv"], cd, reshape=(self.d_model, -1))
            kvp = kvp.to(cd).reshape(b, lc, 2, self.kv_heads, hd)
            k, v = kvp[:, :, 0], kvp[:, :, 1]
        return rope(q, pos), rope(k, pos), v

    def project(self, params, x):
        """Vocabulary projection of post-LN activations through ``qdot``:
        f32 logits, never rounded to the compute dtype."""
        from tpu_ddp_torch.ops.quant import qdot
        return qdot(x, params["head"], self.compute_dtype).to(torch.float32)

    def head_apply(self, params, x):
        """Final LayerNorm + LM head: (B, L, dm) -> (B, L, V) f32."""
        x = layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])
        return self.project(params, x)


def make_transformer(name: str = "TransformerLM-small",
                     **kwargs) -> TransformerLM:
    """The dense presets of tpu_ddp/models/transformer.py (training-only
    fields such as ``remat`` left out)."""
    presets = {
        "TransformerLM-tiny": dict(num_layers=2, num_heads=4, d_model=128,
                                   d_ff=512, vocab_size=1024),
        "TransformerLM-small": dict(num_layers=4, num_heads=8, d_model=512,
                                    d_ff=2048, vocab_size=32000),
        "TransformerLM-base": dict(num_layers=12, num_heads=12, d_model=768,
                                   d_ff=3072, vocab_size=32000),
        "TransformerLM-large": dict(num_layers=12, num_heads=16,
                                    d_model=2048, d_ff=8192,
                                    vocab_size=32000),
        "TransformerLM-tiny-8k": dict(num_layers=2, num_heads=4,
                                      d_model=128, d_ff=512,
                                      vocab_size=1024,
                                      max_seq_len=8192),
        "TransformerLM-small-32k": dict(num_layers=4, num_heads=8,
                                        d_model=512, d_ff=2048,
                                        vocab_size=32000,
                                        max_seq_len=32768),
    }
    if name not in presets:
        raise ValueError(f"unknown transformer preset {name!r}; "
                         f"available: {sorted(presets)}")
    cfg = dict(presets[name])
    cfg.update(kwargs)
    return TransformerLM(name=name, **cfg)
