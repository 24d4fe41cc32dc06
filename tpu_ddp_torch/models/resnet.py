"""Bottleneck ResNet family (tpu_ddp/models/resnet.py), the ResNet-50 /
ImageNet-1k scale-up, as ``nn.Module``s in the port's VGG idiom
(models/vgg.py): OIHW weights, activations NCHW tensors in
``torch.channels_last`` memory, f32 parameters and ``compute_dtype``
convs.

Everything else follows the JAX model:

- every conv is bias-free, casts its input and kernel to
  ``compute_dtype`` and pads as ``padding="SAME"`` does: ``(total // 2,
  total - total // 2)``, which is asymmetric where the total is odd (the
  stem's 7x7/2 conv on 224 pads (2, 3), each stride-2 3x3 conv on an even
  size (0, 1)); the 3x3/2 max-pool after the stem pads with -inf the
  same way (:func:`conv_same`, :func:`max_pool_same`);
- BatchNorm uses the current batch's statistics (the reference's
  ``track_running_stats=False``); ``use_pallas_bn`` routes the stem and
  each bottleneck's conv1 and conv2 (33 sites in ResNet-50) through the
  fused BN+ReLU op (ops/bn_relu.py) on the ``compute_dtype`` conv output,
  as the JAX model does; conv3 and the projections (20 sites) run the
  plain :func:`batch_norm` without ReLU;
- the residual sum and its ReLU in f32, cast to ``compute_dtype`` (every
  stride-2 block changes the width, so it has a projection: the JAX
  model's max-pool shortcut for a stride-2 block without one never
  runs, and the port has none); a
  global average pool in f32 and the head matmul in ``compute_dtype``;
- the memory policy (memory/policy.py): ``remat="blocks"`` makes each
  bottleneck block one checkpoint region, ``"conv_stages"`` (and
  ``"dots"``, which finds no matrix product inside a stage) each of the
  four stages; the stem lies outside every region. ``act_dtype`` is the
  saved dtype of the residual stream between regions.

Two sites hand the BN+ReLU op's backward a gradient that is not
``channels_last``-dense in plain PyTorch: a padding's backward is a
slice. :class:`_PadSame` gives back a dense ``channels_last`` copy
instead, and the max-pool needs no padding tensor at all (its -inf
padding is ``F.max_pool2d``'s own, with ``ceil_mode`` for the high
side), so the op never has to copy or raise.

Initialisation: He-normal conv and head kernels (std sqrt(2 / fan_in),
fan_in the kernel's receptive field times its input channels), BN scale
1 and bias 0, head bias 0, drawn from a CPU ``torch.Generator``.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from tpu_ddp_torch.memory.policy import (cast_saved, effective_remat,
                                         validate_act_dtype, validate_remat,
                                         wrap_stage)
from tpu_ddp_torch.models.vgg import BN_EPS, BatchNormUnit, Head, batch_norm

RESNET_CFG = {
    # Blocks per stage; the bottleneck's width multiplier is 4.
    "ResNet50": (3, 4, 6, 3),
    "ResNet101": (3, 4, 23, 3),
    "ResNet152": (3, 8, 36, 3),
}

STAGE_WIDTHS = (64, 128, 256, 512)


def same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis of extent ``n``: the
    output has ``ceil(n / stride)`` positions, and the total padding
    splits ``(total // 2, total - total // 2)``."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class _PadSame(torch.autograd.Function):
    """Zero padding of an NCHW tensor whose output and input gradient are
    ``channels_last``-dense (a plain pad's backward is a strided slice)."""

    @staticmethod
    def forward(ctx, x, pads):
        ctx.pads, ctx.hw = pads, x.shape[2:]
        return F.pad(x, pads).contiguous(memory_format=torch.channels_last)

    @staticmethod
    def backward(ctx, g):
        left, _, top, _ = ctx.pads
        h, w = ctx.hw
        gx = g[:, :, top:top + h, left:left + w]
        return gx.contiguous(memory_format=torch.channels_last), None


def conv_same(x, weight, stride: int):
    """``lax.conv_general_dilated(..., padding="SAME")`` of an NCHW input
    with an OIHW kernel, no bias: symmetric padding inside the conv,
    asymmetric through an explicit pad."""
    kh, kw = weight.shape[2:]
    (top, bottom) = same_pads(x.shape[2], kh, stride)
    (left, right) = same_pads(x.shape[3], kw, stride)
    if top == bottom and left == right:
        return F.conv2d(x, weight, stride=stride, padding=(top, left))
    x = _PadSame.apply(x, (left, right, top, bottom))
    return F.conv2d(x, weight, stride=stride)


def max_pool_same(x, k: int, stride: int):
    """``lax.reduce_window(x, -inf, max, ..., "SAME")`` over H and W.
    The low side's padding is the pool's own (-inf); where the total is
    odd the high side's one extra position is ``ceil_mode``'s window that
    runs past the input (also ignored, as -inf is)."""
    (top, bottom) = same_pads(x.shape[2], k, stride)
    (left, right) = same_pads(x.shape[3], k, stride)
    return F.max_pool2d(x, k, stride, padding=(top, left),
                        ceil_mode=bottom > top or right > left)


class ConvBN(nn.Module):
    """A bias-free conv (OIHW ``weight``) and its BN's scale and bias."""

    def __init__(self, c_in: int, c_out: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k))
        self.bn = BatchNormUnit(c_out)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4), with a 1x1 projection of the
    shortcut where the width changes."""

    def __init__(self, c_in: int, width: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = ConvBN(c_in, width, 1)
        self.conv2 = ConvBN(width, width, 3)
        self.conv3 = ConvBN(width, width * 4, 1)
        self.proj = (ConvBN(c_in, width * 4, 1) if c_in != width * 4
                     else None)


def _conv_paths(port: str, jax: tuple) -> list:
    return [(f"{port}.weight", (*jax, "kernel"), "conv"),
            (f"{port}.bn.weight", (*jax, "bn_scale"), None),
            (f"{port}.bn.bias", (*jax, "bn_bias"), None)]


class ResNetModel(nn.Module):
    """A bottleneck ResNet: ``forward(images)`` maps (N, C, H, W) images to
    f32 logits."""

    def __init__(self, name: str, stage_blocks: tuple,
                 num_classes: int = 1000, in_channels: int = 3,
                 small_inputs: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32,
                 use_pallas_bn: bool = False, remat: str = "none",
                 act_dtype: str = "compute"):
        super().__init__()
        validate_remat(remat)
        validate_act_dtype(act_dtype)
        if param_dtype != torch.float32:
            raise NotImplementedError(
                "tpu_ddp_torch keeps ResNet parameters in float32 (the "
                "fused SGD and BN kernels take f32)")
        self.name = name
        self.stage_blocks = tuple(stage_blocks)
        self.num_classes = num_classes
        self.in_channels = in_channels
        # True: a 3x3/1 stem and no stem pool (CIFAR-sized inputs).
        self.small_inputs = small_inputs
        self.compute_dtype = compute_dtype
        self.param_dtype = param_dtype
        self.use_pallas_bn = use_pallas_bn
        self.remat = remat
        self.act_dtype = act_dtype
        self.stem = ConvBN(in_channels, 64, 3 if small_inputs else 7)
        stages, c_in = [], 64
        for si, n_blocks in enumerate(self.stage_blocks):
            width, blocks = STAGE_WIDTHS[si], []
            for bi in range(n_blocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                blocks.append(Bottleneck(c_in, width, stride))
                c_in = width * 4
            stages.append(nn.ModuleList(blocks))
        self.stages = nn.ModuleList(stages)
        self.head = Head(c_in, num_classes)
        self.init()

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None
             ) -> "ResNetModel":
        """(Re)draw every parameter in place from ``generator`` (a CPU
        generator; default seed 0)."""
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)

        def he_normal(t, fan_in):
            t.copy_(torch.randn(t.shape, generator=gen)
                    * math.sqrt(2.0 / fan_in))

        for unit in self.modules():
            if isinstance(unit, ConvBN):
                he_normal(unit.weight, unit.weight[0].numel())
                unit.bn.weight.fill_(1.0)
                unit.bn.bias.zero_()
        he_normal(self.head.weight, self.head.weight.shape[0])
        self.head.bias.zero_()
        return self

    def jax_leaf_paths(self) -> list:
        """``(port parameter name, JAX tree path, layout)`` of every
        parameter; ``"conv"`` marks an OIHW kernel that is HWIO in JAX
        (convert.CanonicalView)."""
        out = _conv_paths("stem", ("stem",))
        for si, stage in enumerate(self.stages):
            for bi, block in enumerate(stage):
                for conv in ("conv1", "conv2", "conv3", "proj"):
                    if getattr(block, conv) is not None:
                        out += _conv_paths(f"stages.{si}.{bi}.{conv}",
                                           ("stages", si, bi, conv))
        return out + [("head.weight", ("head", "kernel"), None),
                      ("head.bias", ("head", "bias"), None)]

    def _conv(self, x, unit, stride):
        cd = self.compute_dtype
        return conv_same(x.to(cd), unit.weight.to(cd), stride)

    def _bn_relu(self, y, unit, relu=True):
        scale, bias = unit.bn.weight.float(), unit.bn.bias.float()
        if relu and self.use_pallas_bn:
            from tpu_ddp_torch.ops.bn_relu import batch_norm_relu
            # The compute_dtype conv output goes in as it is; the op
            # computes in f32 and keeps the small bf16 x for its backward.
            out = batch_norm_relu(y.permute(0, 2, 3, 1), scale, bias,
                                  BN_EPS).to(self.compute_dtype)
            return out.permute(0, 3, 1, 2)
        y = batch_norm(y, scale, bias)
        if relu:
            y = torch.relu(y)
        return y.to(self.compute_dtype)

    def _block(self, block, x):
        """One bottleneck block (the region under ``remat="blocks"``):
        enters in the saved dtype, computes in ``compute_dtype``."""
        cd = self.compute_dtype
        x = x.to(cd)
        shortcut = x
        y = self._bn_relu(self._conv(x, block.conv1, 1), block.conv1)
        y = self._bn_relu(self._conv(y, block.conv2, block.stride),
                          block.conv2)
        y = self._bn_relu(self._conv(y, block.conv3, 1), block.conv3,
                          relu=False)
        if block.proj is not None:
            shortcut = self._bn_relu(
                self._conv(shortcut, block.proj, block.stride), block.proj,
                relu=False)
        return torch.relu(y.float() + shortcut.float()).to(cd)

    def _stage(self, si, x):
        for block in self.stages[si]:
            x = self._block(block, x)
        return x

    def forward(self, x):
        cd = self.compute_dtype
        x = x.to(dtype=cd, memory_format=torch.channels_last)
        x = self._conv(x, self.stem, 1 if self.small_inputs else 2)
        x = self._bn_relu(x, self.stem)
        if not self.small_inputs:
            x = max_pool_same(x, 3, 2)
        remat = effective_remat(self.remat, "conv")
        if remat in ("conv_stages", "dots"):
            for si in range(len(self.stages)):
                stage = wrap_stage(functools.partial(self._stage, si), remat)
                x = stage(cast_saved(x, self.act_dtype, cd))
        else:
            block_fn = wrap_stage(self._block, remat)
            for stage in self.stages:
                for block in stage:
                    x = block_fn(block, cast_saved(x, self.act_dtype, cd))
        x = x.float().mean(dim=(2, 3))
        logits = x.to(cd) @ self.head.weight.to(cd)
        return logits.float() + self.head.bias.float()

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


def make_resnet(name: str = "ResNet50", **kwargs) -> ResNetModel:
    if name not in RESNET_CFG:
        raise ValueError(f"unknown ResNet variant {name!r}")
    return ResNetModel(name=name, stage_blocks=RESNET_CFG[name], **kwargs)


def resnet50(**kw):
    return make_resnet("ResNet50", **kw)
