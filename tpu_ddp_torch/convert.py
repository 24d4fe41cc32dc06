"""Carry tpu_ddp parameter trees into the port and back.

TransformerLM: the port keeps the JAX package's parameter layouts
(``wqkv`` (dm, 3, H, hd), ``wo`` (H, hd, dm), ``w1`` (dm, d_ff), ...), so
conversion is a checked copy: every leaf the model needs must be present
with the shape :meth:`TransformerLM.param_shapes` gives, and lands as a
tensor of the model's ``param_dtype`` on ``device``. :func:`params_to_jax`
is the way back (numpy f32 leaves).

VGG: the JAX model's conv kernels are HWIO and the port's OIHW; each
unit's ``bn_scale``/``bn_bias`` become its BN unit's ``weight``/``bias``;
the head keeps its (C, classes) layout. :func:`vgg_params_from_jax` and
:func:`vgg_params_to_jax` are checked copies both ways, and
:func:`vgg_momentum_to_jax`/:func:`vgg_momentum_from_jax` carry SGD's
momentum (a leaf list in parameter order) through the same
transpositions. :func:`opt_state_to_jax` and :func:`opt_state_from_jax`
carry any of the LM trainer's optimizer states (AdamW's ``mu``/``nu``,
Adafactor's ``vr``/``vc``/``v``/``mu`` with their reduced shapes and
``(1,)`` placeholders, SGD's ``momentum``), each slot a tree shaped like
the params and ``count`` an int32, in the JAX package's layout. This module
is the one place a layout changes between the two packages.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_ddp_torch.utils.device import resolve_device
from tpu_ddp_torch.utils.tree import tree_unflatten


def params_from_jax(model, tree, device=None) -> dict:
    """Map a JAX parameter tree, given as nested dicts/tuples of numpy
    arrays (``jax.tree.map(np.asarray, params)``), to the port's
    parameter dict on ``device`` (``None`` means ``"cuda"``)."""
    dev = resolve_device(device)

    def conv(path, want, got):
        if isinstance(want, dict):
            if not isinstance(got, dict):
                raise ValueError(f"{path}: expected a dict, got "
                                 f"{type(got).__name__}")
            missing = sorted(set(want) - set(got))
            extra = sorted(set(got) - set(want))
            if missing or extra:
                raise ValueError(f"{path}: missing keys {missing}, "
                                 f"unexpected keys {extra}")
            return {k: conv(f"{path}/{k}", want[k], got[k]) for k in want}
        if isinstance(want, tuple) and want and isinstance(want[0], dict):
            if len(got) != len(want):
                raise ValueError(f"{path}: expected {len(want)} blocks, "
                                 f"got {len(got)}")
            return tuple(conv(f"{path}/{i}", w, g)
                         for i, (w, g) in enumerate(zip(want, got)))
        arr = np.asarray(got)
        if tuple(arr.shape) != tuple(want):
            raise ValueError(f"{path}: expected shape {tuple(want)}, got "
                             f"{tuple(arr.shape)}")
        return torch.as_tensor(np.array(arr, np.float32)).to(
            device=dev, dtype=model.param_dtype)

    return conv("params", model.param_shapes(), tree)


def params_to_jax(params):
    """The port's TransformerLM parameter tree (or any tree of the same
    structure, e.g. gradients or a moment) as nested dicts and tuples of
    numpy f32 arrays, the JAX package's layout."""
    if isinstance(params, dict):
        return {k: params_to_jax(v) for k, v in params.items()}
    if isinstance(params, (tuple, list)):
        return tuple(params_to_jax(v) for v in params)
    return params.detach().to("cpu", torch.float32).numpy().copy()


def _checked(path, arr, want):
    arr = np.asarray(arr)
    if tuple(arr.shape) != tuple(want):
        raise ValueError(f"{path}: expected shape {tuple(want)}, got "
                         f"{tuple(arr.shape)}")
    return arr


def vgg_params_from_jax(model, tree, device=None) -> dict:
    """Map a JAX VGG tree (``{"features": ({"kernel", "bias",
    "bn_scale", "bn_bias"}, ...), "head": {"kernel", "bias"}}`` of numpy
    arrays) to a state dict for ``model`` (a port ``VGGModel``) on
    ``device`` (``None`` means ``"cuda"``): load it with
    ``model.load_state_dict``. Any pytree of the same structure converts,
    gradients included."""
    dev = resolve_device(device)
    feats = tree["features"]
    if len(feats) != len(model.features):
        raise ValueError(f"params/features: expected {len(model.features)}"
                         f" conv units, got {len(feats)}")
    out = {}
    for i, (unit, leaf) in enumerate(zip(model.features, feats)):
        o, c_in = unit.weight.shape[:2]
        pre = f"params/features/{i}"
        kernel = _checked(f"{pre}/kernel", leaf["kernel"], (3, 3, c_in, o))
        out.update({
            f"features.{i}.weight": kernel.transpose(3, 2, 0, 1),
            f"features.{i}.bias": _checked(f"{pre}/bias", leaf["bias"], (o,)),
            f"features.{i}.bn.weight": _checked(f"{pre}/bn_scale",
                                                leaf["bn_scale"], (o,)),
            f"features.{i}.bn.bias": _checked(f"{pre}/bn_bias",
                                              leaf["bn_bias"], (o,)),
        })
    head = tree["head"]
    out["head.weight"] = _checked("params/head/kernel", head["kernel"],
                                  model.head.weight.shape)
    out["head.bias"] = _checked("params/head/bias", head["bias"],
                                model.head.bias.shape)
    return {k: torch.as_tensor(np.array(v, np.float32, order="C")).to(
        device=dev, dtype=model.param_dtype) for k, v in out.items()}


def vgg_params_to_jax(model) -> dict:
    """The port ``VGGModel``'s parameters as a JAX VGG tree of numpy f32
    arrays (HWIO kernels), for ``tpu_ddp``'s ``VGGModel.apply``."""
    return vgg_momentum_to_jax(model, list(model.parameters()))


def vgg_momentum_to_jax(model, momentum) -> dict:
    """A leaf list in ``model.parameters()`` order (SGD momentum, or the
    parameters themselves) as a JAX VGG tree of numpy f32 arrays: each
    leaf goes through its parameter's transposition (OIHW -> HWIO for the
    conv kernels), as the JAX optimizer's momentum mirrors its params."""
    names = [name for name, _ in model.named_parameters()]
    if len(momentum) != len(names):
        raise ValueError(f"{len(momentum)} leaves for {len(names)} "
                         "parameters")
    by_name = dict(zip(names, momentum))

    def arr(name):
        return by_name[name].detach().to("cpu", torch.float32).numpy().copy()

    feats = tuple({
        "kernel": np.ascontiguousarray(
            arr(f"features.{i}.weight").transpose(2, 3, 1, 0)),
        "bias": arr(f"features.{i}.bias"),
        "bn_scale": arr(f"features.{i}.bn.weight"),
        "bn_bias": arr(f"features.{i}.bn.bias"),
    } for i in range(len(model.features)))
    return {"features": feats,
            "head": {"kernel": arr("head.weight"), "bias": arr("head.bias")}}


def vgg_momentum_from_jax(model, tree, device=None) -> list:
    """A JAX VGG tree (momentum, or any tree shaped like the params) as a
    leaf list in ``model.parameters()`` order on ``device`` (``None``
    means ``"cuda"``): the inverse of :func:`vgg_momentum_to_jax`."""
    sd = vgg_params_from_jax(model, tree, device)
    return [sd[name] for name, _ in model.named_parameters()]


def opt_slot_shapes(optimizer, shapes) -> dict:
    """Each state slot's leaf shapes, in parameter order, for parameter
    leaves of ``shapes``: the JAX optimizers' state layouts (``count``
    aside)."""
    from tpu_ddp_torch.ops.optim import SGD, Adafactor, AdamW
    shapes = [tuple(s) for s in shapes]
    if isinstance(optimizer, Adafactor):
        per_leaf = [optimizer.slot_shapes(s) for s in shapes]
        return {k: [d[k] for d in per_leaf]
                for k in ("vr", "vc", "v", "mu")}
    if isinstance(optimizer, AdamW):
        return {"mu": shapes, "nu": shapes}
    if isinstance(optimizer, SGD):
        return {"momentum": shapes}
    raise TypeError(f"no state layout for {type(optimizer).__name__}")


def opt_state_to_jax(params, opt_state) -> dict:
    """An optimizer state of the port (slots as leaf lists in the order
    of ``tree_leaves(params)``, ``count`` an int or a 0-d tensor) as the
    JAX optimizer's state: each slot a tree shaped like ``params`` of
    numpy f32 arrays, ``count`` an int32."""
    out = {}
    for k, v in opt_state.items():
        if k == "count":
            out[k] = np.int32(int(v))
        else:
            out[k] = params_to_jax(tree_unflatten(params, v))
    return out


def opt_state_from_jax(model, optimizer, opt_state, device=None) -> dict:
    """The inverse of :func:`opt_state_to_jax` for ``model``'s params:
    every slot leaf checked against the optimizer's layout
    (:func:`opt_slot_shapes`) and placed on ``device`` (``None`` means
    ``"cuda"``). The count comes back as the optimizer keeps it: an int,
    or a 0-d int32 device tensor for scheduled SGD."""
    from tpu_ddp_torch.ops.optim import SGD
    dev = resolve_device(device)
    layout = model.param_shapes()
    out = {}
    for k, want in opt_slot_shapes(optimizer,
                                   shape_leaves(layout)).items():
        got = _leaves_like(f"opt_state/{k}", layout, opt_state[k])
        out[k] = [torch.as_tensor(np.array(
            _checked(f"opt_state/{k}/{i}", g, w), np.float32)).to(
                device=dev, dtype=model.param_dtype)
            for i, (g, w) in enumerate(zip(got, want))]
    if "count" in opt_state:
        count = int(np.asarray(opt_state["count"]))
        out["count"] = (torch.tensor(count, dtype=torch.int32, device=dev)
                        if isinstance(optimizer, SGD) else count)
    return out


def _leaves_like(path, want, got) -> list:
    """The leaves of ``got`` in the order of the ``param_shapes()`` tree
    ``want``, found by dict key (a JAX tree's dicts may be ordered
    otherwise) and by tuple index."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"{path}: expected keys {sorted(want)}")
        return [x for k in want for x in _leaves_like(f"{path}/{k}",
                                                       want[k], got[k])]
    if isinstance(want, tuple) and want and isinstance(want[0], dict):
        if len(got) != len(want):
            raise ValueError(f"{path}: expected {len(want)} blocks, got "
                             f"{len(got)}")
        return [x for i, (w, g) in enumerate(zip(want, got))
                for x in _leaves_like(f"{path}/{i}", w, g)]
    return [got]


def shape_leaves(node) -> list:
    """The shape tuples of a ``param_shapes()`` tree, in leaf order."""
    if isinstance(node, dict):
        return [s for v in node.values() for s in shape_leaves(v)]
    if isinstance(node, tuple) and node and isinstance(node[0], dict):
        return [s for v in node for s in shape_leaves(v)]
    return [node]
