"""Tensor (model) parallelism over a ``torch.distributed`` process group
(tpu_ddp/parallel/tensor_parallel.py): Megatron's column/row-parallel
pair (Shoeybi et al., arXiv:1909.08053, from the paper's algebra).

- **column-parallel** ``y @ W_col``: ``W`` split on its output axis over
  the tp group, each rank computing its slice of the output with no
  communication. Its input carries ``f`` (:func:`tp_input`): the
  identity forward, an all-reduce SUM of the input's gradient backward,
  since each rank back-propagates only its slice's share of ``dy``.
- **row-parallel** ``h @ W_row``: ``W`` split on its input axis; each
  rank's product is a partial sum of the full output, all-reduced by
  ``g`` (:func:`tp_output`), whose backward is the identity.

One transformer block costs two all-reduces forward (after the attention
output projection and after the MLP down-projection) and two backward
(at the two ``f``). LayerNorms, the residual stream, the embedding and
the LM head stay replicated over tp; because ``f`` sits between a
LayerNorm and the column matmul, the gradients of those replicated
leaves come out whole and equal on every tp rank.

Serving (:func:`serve_param_specs`, :func:`shard_decode_params`) cuts a
dense decode tree into one rank's Megatron slices; JAX places the tree on
an ``mp`` mesh and lets GSPMD run the steps, the port runs one process
per card, each holding its slices, with ``g`` over the ``tp_group``.

Specs are the port's ``PartitionSpec`` (parallel/redistribute.py), the
model's tp axis named ``"mp"`` as in the JAX mesh.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from tpu_ddp_torch.parallel.redistribute import P

MODEL_AXIS = "mp"


def _size(group) -> int:
    if group is None or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def _all_reduce(x, group):
    """The SUM of ``x`` over ``group`` in a tensor of its own: never in
    place into a tensor autograd may have saved or handed out."""
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _Input(torch.autograd.Function):
    """Megatron's ``f``: identity forward, all-reduce SUM backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Output(torch.autograd.Function):
    """Megatron's ``g``: all-reduce SUM forward, identity backward (the
    output, hence its cotangent, is replicated over the group)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_input(x, group=None):
    """``f`` before a column-parallel matmul over ``group`` (the
    identity at tp 1 or without a group)."""
    if _size(group) == 1:
        return x
    return _Input.apply(x, group)


def tp_output(x, group=None):
    """``g`` after a row-parallel matmul: the partial sums all-reduced
    over ``group`` (the identity at tp 1 or without a group)."""
    if _size(group) == 1:
        return x
    return _Output.apply(x, group)


# ---- tensor-parallel serving ------------------------------------------


def serve_param_specs(model) -> dict:
    """The Megatron placement of a dense decode tree over ``mp``,
    whatever ``tp_size`` the model was trained at: attention heads and
    the MLP hidden axis split, LayerNorms, embedding and head
    replicated (JAX ``serve_param_specs``)."""
    if getattr(model, "moe_experts", 0):
        raise ValueError("tensor-parallel serving supports dense "
                         "models only (MoE routing is not decodable "
                         "through the paged engine)")
    mp = MODEL_AXIS
    ln = {"scale": P(), "bias": P()}
    blk = {"ln1": dict(ln), "wo": P(mp, None, None), "ln2": dict(ln),
           "w1": P(None, mp), "w2": P(mp, None)}
    if model.is_gqa:
        blk["wq"] = P(None, mp, None)
        blk["wkv"] = P(None, None, mp, None)
    else:
        blk["wqkv"] = P(None, None, mp, None)
    return {"embed": P(), "ln_f": dict(ln), "head": P(),
            "blocks": tuple(dict(blk) for _ in range(model.num_layers))}


def check_serve_tp(model, tp: int) -> None:
    """JAX's divisibility refusal of :func:`shard_decode_params`."""
    kv = model.kv_heads
    if model.num_heads % tp or kv % tp or model.d_ff % tp:
        raise ValueError(
            f"cannot shard decode params over {tp} devices: "
            f"num_heads={model.num_heads}, kv_heads={kv}, "
            f"d_ff={model.d_ff} must all be divisible by the "
            "tensor-parallel degree")


def shard_decode_params(model, params, tp: int, rank: int, device=None):
    """Rank ``rank``'s slices (of ``tp``) of a dense decode tree, by
    :func:`serve_param_specs`: each a tensor of its own on ``device``
    (default: where the leaf lies), so the dense tree can be dropped."""
    from tpu_ddp_torch.convert import cell_of, map_specs
    check_serve_tp(model, tp)

    def cut(spec, x):
        out = cell_of(x, spec, {MODEL_AXIS: rank}, {MODEL_AXIS: tp})
        return out.to(device if device is not None else out.device,
                      copy=True).contiguous()

    return map_specs(cut, serve_param_specs(model), params)


def with_serve_tp(model, group=None, tp: int | None = None):
    """The model the decode math runs for one rank of a tp group: local
    heads and d_ff slices, ``g`` over ``group``. ``tp`` overrides the
    group's size (one process composing every rank's arithmetic)."""
    tp = _size(group) if tp is None else int(tp)
    if tp == 1:
        return model
    check_serve_tp(model, tp)
    return dataclasses.replace(model, tp_axis=MODEL_AXIS, tp_size=tp,
                               tp_group=group)
