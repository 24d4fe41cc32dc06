"""VGG family for 32x32 inputs (tpu_ddp/models/vgg.py; reference
part1/model.py:1-50) as ``nn.Module``s.

The JAX model is NHWC with HWIO kernels; here weights are OIHW and the
activations NCHW tensors kept in ``torch.channels_last`` memory, so each
conv output's ``permute(0, 2, 3, 1)`` is a contiguous (N, H, W, C) view:
exactly the (R = N*H*W, C) rows the BatchNorm+ReLU kernel takes, with no
copy. Everything else follows the JAX model:

- convs and the head matmul run in ``compute_dtype`` (bf16 by default)
  with f32 parameters, the conv bias added in f32;
- BatchNorm uses the current batch's statistics in train and eval alike
  (the reference's ``track_running_stats=False``), has only a scale and a
  bias, and computes in f32;
- ``use_pallas_bn`` routes each conv unit through the fused BN+ReLU op
  (ops/bn_relu.py) on the f32 ``conv + bias``, then casts to
  ``compute_dtype`` (the JAX model's ``vgg.py:185-190``); off, the unit
  runs the two-pass :func:`batch_norm` and ReLU in PyTorch.

Initialisation: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for conv and head
weights and biases, BN scale 1 and bias 0, drawn from a CPU
``torch.Generator`` so the same seed gives the same weights on any device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# Channel plans (reference part1/model.py:3-8). 'M' = 2x2/2 max-pool.
VGG_CFG = {
    "VGG11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "VGG13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
              512, 512, "M"),
    "VGG16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
              "M", 512, 512, 512, "M"),
    "VGG19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}

BN_EPS = 1e-5  # torch BatchNorm2d default


def batch_norm(x, scale, bias, eps=BN_EPS):
    """Batch normalisation of an NCHW tensor over (N, H, W) with the
    current batch's statistics (two-pass mean and variance, f32), as the
    JAX package's ``batch_norm``. Returns ``x.dtype``."""
    x32 = x.float()
    mean = x32.mean(dim=(0, 2, 3), keepdim=True)
    var = x32.var(dim=(0, 2, 3), correction=0, keepdim=True)
    inv = torch.rsqrt(var + eps) * scale.view(1, -1, 1, 1)
    return ((x32 - mean) * inv + bias.view(1, -1, 1, 1)).to(x.dtype)


def max_pool_2x2(x):
    """2x2 stride-2 max pool (reference part1/model.py:16)."""
    return F.max_pool2d(x, kernel_size=2, stride=2)


class BatchNormUnit(nn.Module):
    """The scale (``weight``) and bias of one batch-statistics BN."""

    def __init__(self, width: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))


class ConvUnit(nn.Module):
    """One 3x3 conv (pad 1, bias) -> BN -> ReLU entry."""

    def __init__(self, c_in: int, width: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(width, c_in, 3, 3))
        self.bias = nn.Parameter(torch.empty(width))
        self.bn = BatchNormUnit(width)

    def forward(self, x, compute_dtype, use_pallas_bn: bool):
        cd = compute_dtype
        y = F.conv2d(x.to(cd), self.weight.to(cd), padding=1)
        y = y.float() + self.bias.float().view(1, -1, 1, 1)
        if use_pallas_bn:
            from tpu_ddp_torch.ops.bn_relu import batch_norm_relu
            # A channels_last conv output makes this NHWC view contiguous;
            # batch_norm_relu raises on any other layout.
            out = batch_norm_relu(y.permute(0, 2, 3, 1),
                                  self.bn.weight.float(),
                                  self.bn.bias.float(), BN_EPS).to(cd)
            return out.permute(0, 3, 1, 2)
        y = batch_norm(y, self.bn.weight.float(), self.bn.bias.float())
        return torch.relu(y).to(cd)


class Head(nn.Module):
    """The final linear layer, weight kept (in, out) as in the JAX
    model."""

    def __init__(self, c_in: int, num_classes: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_in, num_classes))
        self.bias = nn.Parameter(torch.empty(num_classes))


class VGGModel(nn.Module):
    """A VGG variant: ``forward(images)`` maps (N, C, H, W) images to f32
    logits."""

    def __init__(self, name: str, cfg: tuple, num_classes: int = 10,
                 in_channels: int = 3,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32,
                 use_pallas_bn: bool = False):
        super().__init__()
        if param_dtype != torch.float32:
            raise NotImplementedError(
                "tpu_ddp_torch keeps VGG parameters in float32 (the fused "
                "SGD and BN kernels take f32)")
        self.name = name
        self.cfg = tuple(cfg)
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.compute_dtype = compute_dtype
        self.param_dtype = param_dtype
        self.use_pallas_bn = use_pallas_bn
        units, c_in = [], in_channels
        for width in self.cfg:
            if width == "M":
                continue
            units.append(ConvUnit(c_in, width))
            c_in = width
        self.features = nn.ModuleList(units)
        self.head = Head(c_in, num_classes)
        self.init()

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None) -> "VGGModel":
        """(Re)draw every parameter in place from ``generator`` (a CPU
        generator; default seed 0)."""
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)

        def uniform(t, fan_in):
            bound = 1.0 / math.sqrt(fan_in)
            v = torch.rand(t.shape, generator=gen, dtype=torch.float64)
            t.copy_((v * 2 - 1) * bound)

        for unit in self.features:
            fan_in = unit.weight.shape[1] * 9
            uniform(unit.weight, fan_in)
            uniform(unit.bias, fan_in)
            unit.bn.weight.fill_(1.0)
            unit.bn.bias.zero_()
        uniform(self.head.weight, self.head.weight.shape[0])
        uniform(self.head.bias, self.head.weight.shape[0])
        return self

    def forward(self, x):
        cd = self.compute_dtype
        x = x.to(dtype=cd, memory_format=torch.channels_last)
        units = iter(self.features)
        for width in self.cfg:
            if width == "M":
                x = max_pool_2x2(x)
            else:
                x = next(units)(x, cd, self.use_pallas_bn)
        # Flatten in the JAX model's NHWC order (the same as NCHW after
        # five pools leave 1x1).
        x = x.to(cd).permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        logits = x @ self.head.weight.to(cd)
        return logits.float() + self.head.bias.float()

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


def make_vgg(name: str = "VGG11", **kwargs) -> VGGModel:
    """Factory over the config table."""
    if name not in VGG_CFG:
        raise ValueError(f"unknown VGG variant {name!r}")
    return VGGModel(name=name, cfg=VGG_CFG[name], **kwargs)


def vgg11(**kw):
    return make_vgg("VGG11", **kw)


def vgg13(**kw):
    return make_vgg("VGG13", **kw)


def vgg16(**kw):
    return make_vgg("VGG16", **kw)


def vgg19(**kw):
    return make_vgg("VGG19", **kw)


def get_model(name: str, **kwargs) -> VGGModel:
    """Look up a model factory by name (``tpu_ddp.models.get_model``);
    the port has the VGG family so far."""
    factories = {"VGG11": vgg11, "VGG13": vgg13, "VGG16": vgg16,
                 "VGG19": vgg19}
    if name not in factories:
        raise NotImplementedError(
            f"model {name!r} is not ported to tpu_ddp_torch yet (ROADMAP "
            "Queue 1 items 9.10 and 10); available: "
            f"{sorted(factories)}")
    return factories[name](**kwargs)
