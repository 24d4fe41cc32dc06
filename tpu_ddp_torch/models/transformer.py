"""Decoder-only transformer LM (tpu_ddp/models/transformer.py): the
decode path and the training forward of the dense model, on one device.

Same conventions as the JAX package: parameters are a plain dict of
tensors in the JAX layouts (``wqkv`` (dm, 3, H, hd), ``wo`` (H, hd, dm),
``w1`` (dm, d_ff), ...), f32 parameters with a bf16 compute dtype, f32
softmax/LN statistics, and a frozen dataclass for the static config.

Serving projects through ops/quant.py ``qdot`` (f32 products, or the int8
kernel). The training forward (:meth:`TransformerLM.apply`) projects
through :func:`train_dot`: one matmul of compute-dtype operands with f32
sums — in f32 the JAX package's f32 dot exactly; in bf16 a bf16 GEMM
whose output stays f32 where the JAX package keeps its
``preferred_element_type=jnp.float32`` result (the ``w1`` output, which
is the GELU input, and the logits) and is rounded to bf16 where JAX casts
it back (qkv, ``wo``, ``w2``). Attention goes through
``parallel/ring_attention.py:attend``, to the flash kernels when
``use_flash``. Sequence, tensor and expert parallelism, dropout and MoE
are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from tpu_ddp_torch.memory.policy import (check_training_policy,
                                         validate_act_dtype, validate_remat,
                                         wrap_stage)
from tpu_ddp_torch.parallel.ring_attention import attend


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
    # Mixture of experts (JAX: tpu_ddp/parallel/moe.py): not ported; any
    # value but 0 raises.
    moe_experts: int = 0
    # Attention through the flash kernels (ops/flash_attention.py) instead
    # of full_attention.
    use_flash: bool = False
    # Memory policy (memory/policy.py): "blocks" recomputes each block in
    # the backward from its saved input. Serving ignores both fields.
    remat: str = "none"
    act_dtype: str = "compute"
    # Dropout on the embedding and the residual branches: not ported; any
    # rate but 0 raises.
    dropout_rate: float = 0.0

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
        validate_remat(self.remat)
        validate_act_dtype(self.act_dtype)
        if self.dropout_rate != 0.0:
            raise NotImplementedError(
                f"dropout_rate={self.dropout_rate}: dropout is not ported to "
                "tpu_ddp_torch yet (ROADMAP Queue 1 item 10.3)")
        if self.moe_experts:
            raise NotImplementedError(
                f"moe_experts={self.moe_experts}: MoE is not ported to "
                "tpu_ddp_torch yet (ROADMAP Queue 1 item 10.8)")
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

    def qkv_proj(self, blk, y, pos, dot=None):
        """Projected + RoPE'd q (B, L, H, hd) and k/v (B, L, KV, hd) from
        normalized input ``y``: one fused "wqkv" matmul for MHA, separate
        "wq"/"wkv" for GQA, each through ``dot`` (``qdot`` by default;
        training passes :func:`train_dot`)."""
        from tpu_ddp_torch.ops.quant import qdot
        qdot = dot or qdot
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

    def project(self, params, x, dot=None):
        """Vocabulary projection of post-LN activations through ``dot``
        (``qdot`` by default: f32 logits, never rounded to the compute
        dtype); returns f32 logits."""
        from tpu_ddp_torch.ops.quant import qdot
        dot = dot or qdot
        return dot(x, params["head"], self.compute_dtype).to(torch.float32)

    # ---- training forward ---------------------------------------------

    def check_seq_len(self, local_len: int) -> None:
        """Validate the sequence length against ``max_seq_len``."""
        if local_len > self.max_seq_len:
            raise ValueError(f"sequence length {local_len} exceeds "
                             f"max_seq_len={self.max_seq_len}")

    def apply(self, params, tokens):
        """tokens: (B, L) integer ids -> logits (B, L, V) f32."""
        return self.apply_with_aux(params, tokens)[0]

    def apply_with_aux(self, params, tokens):
        """Like :meth:`apply`, with the mean MoE auxiliary loss (0.0: the
        port's model is dense)."""
        x, aux = self.trunk_with_aux(params, tokens)
        return self.project(params, x, dot=_train_dot_f32), aux

    def trunk_with_aux(self, params, tokens):
        """Embed -> blocks -> final LayerNorm: ((B, L, dm) activations,
        aux = 0.0). Under ``remat="blocks"`` each block is one checkpoint
        region whose backward recomputes it (flash forward included)."""
        cd = self.compute_dtype
        lc = tokens.shape[1]
        self.check_seq_len(lc)
        check_training_policy(self.remat, self.act_dtype)
        pos = torch.arange(lc, device=tokens.device)
        x = F.embedding(tokens.long(), params["embed"]).to(cd)
        blk_fn = (self.block_apply if self.remat == "none"
                  else wrap_stage(self._block_entry, self.remat))
        for blk in params["blocks"]:
            x = blk_fn(blk, x, pos)
        x = layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])
        return x, 0.0

    def block_apply_aux(self, blk, x, pos):
        """:meth:`block_apply` and the block's auxiliary loss (0.0)."""
        return self.block_apply(blk, x, pos), 0.0

    def _block_entry(self, blk, x, pos):
        """:meth:`block_apply` with the residual stream re-entering
        ``compute_dtype``: the checkpoint region's entry point."""
        return self.block_apply(blk, x.to(self.compute_dtype), pos)

    def block_apply(self, blk, x, pos):
        """One transformer block, (B, L, dm) -> (B, L, dm): LN1 -> qkv ->
        attention -> wo + residual -> LN2 -> w1 (f32 out) -> GELU (tanh,
        f32) -> w2 + residual."""
        cd = self.compute_dtype
        b, lc = x.shape[0], x.shape[1]
        h, hd = self.num_heads, self.head_dim
        y = layer_norm(x, blk["ln1"]["scale"], blk["ln1"]["bias"])
        q, k, v = self.qkv_proj(blk, y, pos, dot=train_dot)
        o = attend(q, k, v, causal=True, flash=self.use_flash)
        o = train_dot(o.reshape(b, lc, h * hd), blk["wo"], cd,
                      reshape=(h * hd, self.d_model)).to(cd)
        x = x + o
        y = layer_norm(x, blk["ln2"]["scale"], blk["ln2"]["bias"])
        y = train_dot(y, blk["w1"], cd, out_dtype=torch.float32)
        y = F.gelu(y, approximate="tanh").to(cd)
        y = train_dot(y, blk["w2"], cd).to(cd)
        return x + y

    def head_apply(self, params, x):
        """Final LayerNorm + LM head: (B, L, dm) -> (B, L, V) f32."""
        x = layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])
        return self.project(params, x)


def train_dot(y, w, cd, reshape=None, out_dtype=None):
    """The training forward's matmul: ``y @ w`` with both operands cast to
    the compute dtype ``cd`` (``w`` reshaped), f32 sums inside the GEMM,
    the result in ``out_dtype`` (default ``cd``). Differentiable."""
    w = w.to(cd)
    if reshape is not None:
        w = w.reshape(reshape)
    y = y.to(cd)
    if out_dtype is None or out_dtype == cd:
        return torch.matmul(y, w)
    return _WideDot.apply(y, w, out_dtype)


def _train_dot_f32(y, w, cd):
    return train_dot(y, w, cd, out_dtype=torch.float32)


def _mm(a, b, out_dtype):
    """2-D ``a @ b`` of one dtype with f32 sums, returned in ``out_dtype``:
    cuBLAS writes the wider type itself; on the CPU the operands are
    widened (exact) and the f32 product is cast."""
    if a.device.type != "cuda":
        return torch.mm(a.float(), b.float()).to(out_dtype)
    if out_dtype == a.dtype:
        return torch.mm(a, b)
    return torch.mm(a, b, out_dtype=out_dtype)


class _WideDot(torch.autograd.Function):
    """``y @ w`` of narrow operands with a wider output: JAX's ``jnp.dot``
    with ``preferred_element_type``. The backward rounds the cotangent to
    the operands' dtype and gives their dtype back, as the TPU's
    default-precision dot and a narrow GEMM's own backward do."""

    @staticmethod
    def forward(ctx, y, w, out_dtype):
        ctx.save_for_backward(y, w)
        out = _mm(y.reshape(-1, y.shape[-1]), w, out_dtype)
        return out.reshape(*y.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        y, w = ctx.saved_tensors
        g = g.to(y.dtype).reshape(-1, g.shape[-1])
        y2 = y.reshape(-1, y.shape[-1])
        dy = _mm(g, w.t(), y.dtype).reshape(y.shape)
        dw = _mm(y2.t(), g, w.dtype)
        return dy, dw, None


def make_transformer(name: str = "TransformerLM-small",
                     **kwargs) -> TransformerLM:
    """The dense presets of tpu_ddp/models/transformer.py."""
    presets = {
        "TransformerLM-tiny": dict(num_layers=2, num_heads=4, d_model=128,
                                   d_ff=512, vocab_size=1024),
        "TransformerLM-small": dict(num_layers=4, num_heads=8, d_model=512,
                                    d_ff=2048, vocab_size=32000),
        "TransformerLM-base": dict(num_layers=12, num_heads=12, d_model=768,
                                   d_ff=3072, vocab_size=32000),
        "TransformerLM-large": dict(num_layers=12, num_heads=16,
                                    d_model=2048, d_ff=8192,
                                    vocab_size=32000, remat="blocks"),
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
