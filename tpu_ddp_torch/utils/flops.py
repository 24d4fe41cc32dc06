"""FLOP accounting for MFU (tpu_ddp/utils/flops.py), dense decoder LM
only."""

from __future__ import annotations


def transformer_fwd_flops(model, batch: int, seq_len: int) -> int:
    """Forward FLOPs of one decoder-LM step: 2 x (matmul params) per token
    plus the attention score and value matmuls at 4 * d_model * L per
    token per layer (the full-L convention; GQA changes the K/V
    projections, not the score matmuls). Training is 3x this."""
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
