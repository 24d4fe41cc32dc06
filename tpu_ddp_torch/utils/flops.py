"""FLOP accounting for MFU (tpu_ddp/utils/flops.py): the forward FLOPs of
one step of each model family, 2 per multiply-add, and training as 3x
the forward (the backward's two products per forward product). The
counts are the JAX package's, integer for integer.

:func:`peak_tflops` and :func:`device_hbm_gbps` give the card's bf16
dense peak and memory rate by ``torch.cuda.get_device_name`` (published
figures), overridable with ``TPU_DDP_PEAK_TFLOPS`` and
``TPU_DDP_HBM_GBPS`` as in the JAX package; :func:`mfu_fields` is the
JAX package's MFU block. XLA's cost analysis has no counterpart here, so
``xla_flops_per_step`` is whatever the caller passes (None).
"""

from __future__ import annotations

import os

import torch

TRAIN_FLOPS_MULT = 3

# (substring of torch.cuda.get_device_name, bf16 dense peak TFLOP/s, HBM
# GB/s), checked in order, first match wins. Published figures: H100 SXM
# (HBM3) 989 and 3350, H100 PCIe 756 and 2000.
_CARDS = (
    ("H100 PCIe", 756.0, 2000.0),
    ("H100", 989.0, 3350.0),
)


def _card_name(device) -> tuple[str, str | None]:
    """(device type, card name or None) of a torch device or name."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type, None
    return dev.type, torch.cuda.get_device_name(dev)


def peak_tflops(device) -> tuple[float | None, str]:
    """(bf16 dense peak TFLOP/s of ``device``, source string).

    ``TPU_DDP_PEAK_TFLOPS`` overrides; a non-CUDA device or a card not in
    the table gives (None, reason), so MFU is reported null rather than
    wrong."""
    env = os.environ.get("TPU_DDP_PEAK_TFLOPS")
    if env:
        try:
            return float(env), "env:TPU_DDP_PEAK_TFLOPS"
        except ValueError:
            return None, f"unparseable TPU_DDP_PEAK_TFLOPS={env!r}"
    kind, name = _card_name(device)
    if name is None:
        return None, f"non-CUDA device type {kind!r}: no peak table"
    for sub, peak, _ in _CARDS:
        if sub in name:
            return peak, f"device name {name!r}"
    return None, f"unknown device name {name!r}"


def device_hbm_gbps(device, default: float = 3350.0) -> tuple[float, str]:
    """(memory rate GB/s of ``device``, source label).

    ``TPU_DDP_HBM_GBPS`` overrides; other devices fall back to
    ``default`` (the H100 SXM's) with the label saying so: an estimate,
    never a number that reads like the card's own."""
    env = os.environ.get("TPU_DDP_HBM_GBPS")
    if env:
        try:
            return float(env), "env:TPU_DDP_HBM_GBPS"
        except ValueError:
            pass
    kind, name = _card_name(device)
    for sub, _, bw in _CARDS:
        if name is not None and sub in name:
            return bw, f"device name {name!r}"
    return default, (f"FALLBACK default (device type {kind!r}, name "
                     f"{name!r} not in table) - estimate, not the real "
                     "card's bandwidth")


def mfu_fields(flops_per_step: float | None, step_seconds: float,
               device, xla_flops_per_step: float | None = None) -> dict:
    """The JAX bench's MFU block: achieved TFLOP/s, peak and MFU."""
    peak, peak_src = peak_tflops(device)
    out = {
        "flops_per_step": flops_per_step,
        "flops_source": "analytic" if flops_per_step is not None else None,
        "xla_flops_per_step": xla_flops_per_step,
        "peak_tflops_bf16": peak,
        "peak_source": peak_src,
        "achieved_tflops": None,
        "mfu": None,
    }
    if flops_per_step is None and xla_flops_per_step is not None:
        flops_per_step = xla_flops_per_step
        out["flops_per_step"] = flops_per_step
        out["flops_source"] = "xla_cost_analysis"
    if flops_per_step and step_seconds > 0:
        achieved = flops_per_step / step_seconds / 1e12
        out["achieved_tflops"] = round(achieved, 3)
        if peak:
            out["mfu"] = round(achieved / peak, 4)
    return out


def vgg_fwd_flops(cfg, image_size: int, batch: int,
                  num_classes: int = 10, in_channels: int = 3) -> int:
    """Forward FLOPs of one VGG step (models/vgg.py channel plans)."""
    h = w = image_size
    c_in = in_channels
    per_image = 0
    for width in cfg:
        if width == "M":
            h //= 2
            w //= 2
            continue
        per_image += 2 * 9 * c_in * width * h * w  # 3x3 SAME conv
        c_in = width
    per_image += 2 * c_in * num_classes  # 512 -> classes head
    return per_image * batch


def resnet_fwd_flops(stage_blocks, image_size: int, batch: int,
                     num_classes: int = 1000, in_channels: int = 3,
                     small_inputs: bool = False) -> int:
    """Forward FLOPs of one bottleneck-ResNet step, walking the shapes of
    models/resnet.py (stem, four stages, head)."""
    stage_widths = (64, 128, 256, 512)
    h = image_size // (1 if small_inputs else 2)
    stem_hw = 3 if small_inputs else 7
    per_image = 2 * stem_hw * stem_hw * in_channels * 64 * h * h
    if not small_inputs:
        h //= 2  # stem max-pool
    c_in = 64
    for si, n_blocks in enumerate(stage_blocks):
        width = stage_widths[si]
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            h_out = h // stride
            per_image += 2 * c_in * width * h * h            # conv1 1x1
            per_image += 2 * 9 * width * width * h_out * h_out  # conv2 3x3
            per_image += 2 * width * width * 4 * h_out * h_out  # conv3 1x1
            if bi == 0 and c_in != width * 4:
                per_image += 2 * c_in * width * 4 * h_out * h_out  # proj
            c_in = width * 4
            h = h_out
    per_image += 2 * c_in * num_classes
    return per_image * batch


def transformer_fwd_flops(model, batch: int, seq_len: int) -> int:
    """Forward FLOPs of one decoder-LM step: 2 x (matmul params) per token
    plus the attention score and value matmuls at 4 * d_model * L per
    token per layer (the full-L convention; GQA changes the K/V
    projections, not the score matmuls). A MoE model counts its active
    expert parameters (top_k experts per token) and the router."""
    dm, dff = model.d_model, model.d_ff
    h, kvh, hd = model.num_heads, model.kv_heads, model.head_dim
    per_layer = dm * (h * hd + 2 * kvh * hd)   # wqkv (fused or split)
    per_layer += h * hd * dm                   # wo
    mlp = 2 * dm * dff                         # w1 + w2
    if model.moe_experts:
        mlp *= max(model.moe_top_k, 1)         # active experts per token
        per_layer += dm * model.moe_experts    # router
    per_layer += mlp
    matmul_params = model.num_layers * per_layer + dm * model.vocab_size
    tokens = batch * seq_len
    attn = 4 * dm * seq_len * model.num_layers  # QK^T + AV per token
    return tokens * (2 * matmul_params + attn)


def vit_fwd_flops(model, batch: int) -> int:
    """Forward FLOPs of one ViT classifier step (models/vit.py): the
    patch embedding, the encoder blocks (full L^2 attention) and the
    pooled head."""
    n = model.num_patches
    dm, dff = model.d_model, model.d_ff
    patch_in = model.patch_size ** 2 * model.in_channels
    per_image = 2 * n * patch_in * dm                    # patch embed GEMM
    per_layer = 2 * n * (4 * dm * dm + 2 * dm * dff)     # qkv+o, mlp
    per_layer += 4 * n * n * dm                          # QK^T + AV
    per_image += model.num_layers * per_layer
    per_image += 2 * dm * model.num_classes
    return per_image * batch


def train_flops(fwd_flops: int) -> int:
    return TRAIN_FLOPS_MULT * fwd_flops
