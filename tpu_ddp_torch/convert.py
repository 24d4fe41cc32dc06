"""Carry tpu_ddp parameter trees into the port and back.

TransformerLM: the port keeps the JAX package's parameter layouts
(``wqkv`` (dm, 3, H, hd), ``wo`` (H, hd, dm), ``w1`` (dm, d_ff), ...), so
conversion is a checked copy: every leaf the model needs must be present
with the shape :meth:`TransformerLM.param_shapes` gives, and lands as a
tensor of the model's ``param_dtype`` on ``device``. :func:`params_to_jax`
is the way back (numpy f32 leaves).

The image models (VGG, ResNet, ViT) share one canonical view,
:class:`CanonicalView`: the JAX tree's leaf order and layouts. The JAX
models' conv kernels are HWIO and the port's OIHW; each conv's
``bn_scale``/``bn_bias`` become its BN unit's ``weight``/``bias``; heads
keep their (C, classes) layout and ViT keeps every JAX layout.
:func:`image_params_from_jax` and :func:`image_params_to_jax` (also
``resnet_params_*`` and ``vit_params_*``) are checked copies both ways,
and :func:`image_momentum_to_jax`/:func:`image_momentum_from_jax` carry
SGD's momentum (a leaf list in parameter order) through the same
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


class CanonicalView:
    """An image model's parameters (VGG, ResNet or ViT) in the JAX
    package's leaf order and layouts: the canonical view the converters,
    checkpoints, the flat ZeRO/FSDP layout, the bucket plan and the
    gradient wires work on, so their trees, shards and payloads hold the
    JAX package's bytes.

    The model names each parameter's JAX tree path and layout
    (``model.jax_leaf_paths()``); the order is JAX's pytree flatten of
    that tree (dict keys sorted, tuple entries in order), so it is the
    paths sorted: VGG per unit ``bias``, ``bn_bias``, ``bn_scale``,
    ``kernel``, then the head; ResNet the head, the stages, the stem,
    each conv's ``bn_bias``, ``bn_scale``, ``kernel``; ViT the blocks,
    ``head``, ``ln_f``, ``patch``, ``pos``. Conv kernels are HWIO in the
    view (the port's are OIHW); every other leaf is the port's
    tensor."""

    def __init__(self, model):
        named = [n for n, _ in model.named_parameters()]
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        entries = sorted(model.jax_leaf_paths(), key=lambda e: e[1])
        if sorted(e[0] for e in entries) != sorted(named):
            raise ValueError(f"{type(model).__name__}.jax_leaf_paths() "
                             "does not name every parameter once")
        self.names = [e[0] for e in entries]
        self.paths = [e[1] for e in entries]
        self.kernel = [e[2] == "conv" for e in entries]
        self.port_index = [named.index(n) for n in self.names]
        self.shapes = [(s[2], s[3], s[1], s[0]) if k else s
                       for s, k in ((shapes[n], k) for n, k in
                                    zip(self.names, self.kernel))]

    def leaves(self, tensors) -> list:
        """Tensors in ``model.parameters()`` order (params, grads or
        momentum) -> canonical views in JAX order."""
        return [self.leaf(i, tensors[j])
                for i, j in enumerate(self.port_index)]

    def leaf(self, i: int, t):
        """Leaf ``i``'s tensor in the port's layout -> a canonical
        view."""
        return t.permute(2, 3, 1, 0) if self.kernel[i] else t

    def to_port(self, i: int, t):
        """Canonical leaf ``i`` -> the port's layout (contiguous)."""
        return t.permute(3, 2, 0, 1).contiguous() if self.kernel[i] else t

    def tree(self, leaves):
        """Canonical leaves (numpy, or any leaf objects) -> the JAX
        tree: dicts by key, tuples where the keys are indices."""
        root = {}
        for path, leaf in zip(self.paths, leaves):
            node = root
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = leaf
        return _tuples(root)

    def from_tree(self, tree, lead: tuple = ()) -> list:
        """The JAX tree -> canonical leaves (numpy), each checked to be
        ``lead + shape`` (``lead=(dp,)``: the int8 wire's residual)."""
        out = []
        for path, want in zip(self.paths, self.shapes):
            where = "params/" + "/".join(map(str, path))
            node = tree
            try:
                for key in path:
                    node = node[key]
            except (KeyError, IndexError, TypeError):
                raise ValueError(f"{where}: missing from the tree") from None
            out.append(_checked(where, node, tuple(lead) + want))
        return out


def _tuples(node):
    if not isinstance(node, dict):
        return node
    out = {k: _tuples(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return tuple(out[i] for i in range(len(out)))
    return out


def image_params_from_jax(model, tree, device=None) -> dict:
    """Map a JAX parameter tree of an image model (VGG, ResNet or ViT;
    nested dicts and tuples of numpy arrays) to a state dict for the
    port's ``model`` on ``device`` (``None`` means ``"cuda"``): load it
    with ``model.load_state_dict``. Every leaf is checked against the
    model's shape; conv kernels go HWIO -> OIHW, and each conv's
    ``bn_scale``/``bn_bias`` become its BN unit's ``weight``/``bias``.
    Any pytree of the same structure converts, gradients included."""
    dev = resolve_device(device)
    canon = CanonicalView(model)
    out = {}
    for i, arr in enumerate(canon.from_tree(tree)):
        t = torch.as_tensor(np.array(arr, np.float32, order="C"))
        out[canon.names[i]] = canon.to_port(i, t).to(
            device=dev, dtype=model.param_dtype)
    names = [n for n, _ in model.named_parameters()]
    return {n: out[n] for n in names}


def image_params_to_jax(model) -> dict:
    """The port model's parameters as the JAX model's tree of numpy f32
    arrays (HWIO conv kernels), for ``tpu_ddp``'s ``apply``."""
    return image_momentum_to_jax(model, list(model.parameters()))


def image_momentum_to_jax(model, momentum) -> dict:
    """A leaf list in ``model.parameters()`` order (SGD momentum, or the
    parameters themselves) as the JAX model's tree of numpy f32 arrays:
    each leaf through its parameter's transposition, as the JAX
    optimizer's momentum mirrors its params."""
    canon = CanonicalView(model)
    if len(momentum) != len(canon.names):
        raise ValueError(f"{len(momentum)} leaves for {len(canon.names)} "
                         "parameters")
    return canon.tree([np.array(t.detach().to("cpu", torch.float32)
                                .numpy(), order="C", copy=True)
                       for t in canon.leaves(momentum)])


def image_momentum_from_jax(model, tree, device=None) -> list:
    """The inverse of :func:`image_momentum_to_jax`: a JAX tree shaped
    like the params as a leaf list in ``model.parameters()`` order on
    ``device`` (``None`` means ``"cuda"``)."""
    sd = image_params_from_jax(model, tree, device)
    return [sd[name] for name, _ in model.named_parameters()]


# ResNet's and ViT's converters keep the names the README gives them.
resnet_params_from_jax = vit_params_from_jax = image_params_from_jax
resnet_params_to_jax = vit_params_to_jax = image_params_to_jax


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
