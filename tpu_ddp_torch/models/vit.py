"""Vision Transformer (tpu_ddp/models/vit.py) as an ``nn.Module``: a
patch-embedding image classifier on the port's transformer pieces
(``models/transformer.py:layer_norm`` and ``train_dot``) and its
attention dispatch (``parallel/ring_attention.py:attend``), bidirectional:
``use_flash`` runs the three flash kernels non-causally, otherwise
``full_attention``.

The JAX model's parameter layouts are kept, under its names, so the
canonical view (convert.CanonicalView) is a checked copy:
``patch.kernel`` (p·p·C, dm), ``pos`` (N, dm), per block ``ln1``/``ln2``
(``scale``, ``bias``), ``wqkv`` (dm, 3, H, hd), ``wo`` (H, hd, dm), ``w1``
(dm, d_ff), ``w2`` (d_ff, dm), then ``ln_f`` and ``head`` (dm, classes).
Its arithmetic too:

- patchify orders each patch row (p, p, C) from the NHWC image, which
  is the NHWC view of the loader's NCHW ``channels_last`` batch;
- the patch embedding is one matmul with f32 output, its bias added in
  f32 before the cast to ``compute_dtype``, then the position table in
  ``compute_dtype``;
- matmuls in ``compute_dtype`` with f32 sums, LayerNorm in f32, GELU in
  its tanh form (``jax.nn.gelu``'s default) in f32;
- a global-average-pool head in f32 (no CLS token).

The memory policy: ``remat="blocks"`` makes each transformer block one
checkpoint region, ``"dots"`` keeps only matmul outputs inside it, and
``"conv_stages"`` (no conv stages) degrades to ``"blocks"``.
Initialisation: N(0, 0.02²) for every matrix and the position table,
LayerNorm scale 1 and bias 0, zero biases, from a CPU
``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpu_ddp_torch.memory.policy import (cast_saved, effective_remat,
                                         validate_act_dtype, validate_remat,
                                         wrap_stage)
from tpu_ddp_torch.models.transformer import layer_norm, train_dot
from tpu_ddp_torch.parallel.ring_attention import attend


class _Norm(nn.Module):
    def __init__(self, dm: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dm))
        self.bias = nn.Parameter(torch.zeros(dm))


class _Affine(nn.Module):
    """``kernel`` (in, out) and ``bias`` (out,), JAX's layout."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(d_out))


class ViTBlock(nn.Module):
    def __init__(self, dm: int, dff: int, h: int, hd: int):
        super().__init__()
        self.ln1 = _Norm(dm)
        self.wqkv = nn.Parameter(torch.empty(dm, 3, h, hd))
        self.wo = nn.Parameter(torch.empty(h, hd, dm))
        self.ln2 = _Norm(dm)
        self.w1 = nn.Parameter(torch.empty(dm, dff))
        self.w2 = nn.Parameter(torch.empty(dff, dm))


class ViTModel(nn.Module):
    """``forward(images)`` maps (N, C, H, W) images to f32 logits."""

    def __init__(self, name: str = "ViT", image_size: int = 32,
                 patch_size: int = 4, num_classes: int = 10,
                 in_channels: int = 3, num_layers: int = 6,
                 num_heads: int = 4, d_model: int = 256, d_ff: int = 1024,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32,
                 use_flash: bool = False, remat: str = "none",
                 act_dtype: str = "compute"):
        super().__init__()
        validate_remat(remat)
        validate_act_dtype(act_dtype)
        if image_size % patch_size:
            raise ValueError(f"image_size={image_size} not divisible by "
                             f"patch_size={patch_size}")
        if d_model % num_heads:
            raise ValueError(f"d_model={d_model} not divisible by "
                             f"num_heads={num_heads}")
        if param_dtype != torch.float32:
            raise NotImplementedError(
                "tpu_ddp_torch keeps ViT parameters in float32 (the fused "
                "SGD kernel takes f32)")
        self.name = name
        self.image_size, self.patch_size = image_size, patch_size
        self.num_classes, self.in_channels = num_classes, in_channels
        self.num_layers, self.num_heads = num_layers, num_heads
        self.d_model, self.d_ff = d_model, d_ff
        self.compute_dtype, self.param_dtype = compute_dtype, param_dtype
        self.use_flash = use_flash
        self.remat, self.act_dtype = remat, act_dtype
        self.patch = _Affine(patch_size ** 2 * in_channels, d_model)
        self.pos = nn.Parameter(torch.empty(self.num_patches, d_model))
        self.ln_f = _Norm(d_model)
        self.head = _Affine(d_model, num_classes)
        self.blocks = nn.ModuleList(
            ViTBlock(d_model, d_ff, num_heads, self.head_dim)
            for _ in range(num_layers))
        self.init()

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None) -> "ViTModel":
        """(Re)draw every parameter in place from ``generator`` (a CPU
        generator; default seed 0)."""
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)

        def normal(t):
            t.copy_(0.02 * torch.randn(t.shape, generator=gen))

        for name, p in self.named_parameters():
            if name.endswith(("kernel", "pos", "wqkv", "wo", "w1", "w2")):
                normal(p)
            elif name.endswith("scale"):
                p.fill_(1.0)
            else:
                p.zero_()
        return self

    def jax_leaf_paths(self) -> list:
        """``(port parameter name, JAX tree path, layout)`` of every
        parameter: the same names and layouts as JAX's tree."""
        return [(name, tuple(int(k) if k.isdigit() else k
                             for k in name.split(".")), None)
                for name, _ in self.named_parameters()]

    def _patchify(self, x):
        """(B, C, H, W) -> (B, N, p·p·C) patch rows in the NHWC image's
        (gh, gw, p, p, C) order."""
        b, p = x.shape[0], self.patch_size
        g = self.image_size // p
        x = x.permute(0, 2, 3, 1).reshape(b, g, p, g, p, self.in_channels)
        x = x.permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, g * g, p * p * self.in_channels)

    def _block_entry(self, blk, x):
        """:meth:`_block` with the residual stream re-entering
        ``compute_dtype``: the checkpoint region under a memory policy."""
        return self._block(blk, x.to(self.compute_dtype))

    def _block(self, blk, x):
        cd = self.compute_dtype
        b, n = x.shape[0], x.shape[1]
        h, hd, dm = self.num_heads, self.head_dim, self.d_model
        y = layer_norm(x, blk.ln1.scale, blk.ln1.bias)
        qkv = train_dot(y, blk.wqkv, cd, reshape=(dm, 3 * h * hd))
        qkv = qkv.reshape(b, n, 3, h, hd)
        o = attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=False,
                   flash=self.use_flash)
        o = train_dot(o.reshape(b, n, h * hd), blk.wo, cd,
                      reshape=(h * hd, dm))
        x = x + o
        y = layer_norm(x, blk.ln2.scale, blk.ln2.bias)
        y = train_dot(y, blk.w1, cd, out_dtype=torch.float32)
        y = F.gelu(y.float(), approximate="tanh").to(cd)
        return x + train_dot(y, blk.w2, cd)

    def forward(self, x):
        cd = self.compute_dtype
        if x.shape[2] != self.image_size or x.shape[3] != self.image_size:
            raise ValueError(f"expected {self.image_size}x"
                             f"{self.image_size} inputs, got "
                             f"{x.shape[2]}x{x.shape[3]}")
        tok = train_dot(self._patchify(x.to(cd)), self.patch.kernel, cd,
                        out_dtype=torch.float32)
        tok = (tok + self.patch.bias.float()).to(cd)
        tok = tok + self.pos.to(cd)
        remat = effective_remat(self.remat, "attn")
        if remat == "none" and self.act_dtype == "compute":
            blk_fn = self._block
        else:
            # _block_entry re-enters compute_dtype, so the boundary cast
            # changes only what autograd saves.
            blk_fn = wrap_stage(self._block_entry, remat)
        for blk in self.blocks:
            tok = blk_fn(blk, cast_saved(tok, self.act_dtype, cd))
        tok = layer_norm(tok, self.ln_f.scale, self.ln_f.bias)
        pooled = tok.float().mean(dim=1)
        return pooled @ self.head.kernel.float() + self.head.bias.float()

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


_PRESETS = {
    # CIFAR-scale: 4x4 patches over 32x32 -> 64 tokens.
    "ViT-tiny": dict(image_size=32, patch_size=4, num_layers=6,
                     num_heads=4, d_model=256, d_ff=1024, num_classes=10),
    # ImageNet-scale ViT-S/16: 196 tokens at 224x224.
    "ViT-S16": dict(image_size=224, patch_size=16, num_layers=12,
                    num_heads=6, d_model=384, d_ff=1536,
                    num_classes=1000),
}


def make_vit(name: str = "ViT-tiny", *, use_pallas_bn: bool = False,
             **kwargs) -> ViTModel:
    """A preset with overrides. ``use_pallas_bn`` is accepted, as every
    image model's factory takes it, and ignored: ViT has no
    BatchNorm."""
    del use_pallas_bn
    if name not in _PRESETS:
        raise ValueError(f"unknown ViT preset {name!r}; available: "
                         f"{sorted(_PRESETS)}")
    cfg = dict(_PRESETS[name])
    cfg.update(kwargs)
    return ViTModel(name=name, **cfg)
