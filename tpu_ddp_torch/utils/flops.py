"""FLOP accounting for MFU (tpu_ddp/utils/flops.py): the forward FLOPs of
one step of each model family, 2 per multiply-add, and training as 3x
the forward (the backward's two products per forward product). The
counts are the JAX package's, integer for integer."""

from __future__ import annotations

TRAIN_FLOPS_MULT = 3


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
    projections, not the score matmuls)."""
    if getattr(model, "moe_experts", 0):
        raise NotImplementedError("MoE FLOPs: the port's model is dense "
                                  "(ROADMAP Queue 1 item 10.8)")
    dm, dff = model.d_model, model.d_ff
    h, kvh, hd = model.num_heads, model.kv_heads, model.head_dim
    per_layer = dm * (h * hd + 2 * kvh * hd)   # wqkv (fused or split)
    per_layer += h * hd * dm                   # wo
    per_layer += 2 * dm * dff                  # w1 + w2
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
