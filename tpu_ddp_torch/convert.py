"""Carry a tpu_ddp TransformerLM parameter tree into the port.

The port keeps the JAX package's parameter layouts (``wqkv`` (dm, 3, H,
hd), ``wo`` (H, hd, dm), ``w1`` (dm, d_ff), ...), so conversion is a
checked copy: every leaf the model needs must be present with the shape
:meth:`TransformerLM.param_shapes` gives, and lands as a tensor of the
model's ``param_dtype`` on ``device``. This is the one place a layout
would change if the two packages ever diverge.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_ddp_torch.utils.device import resolve_device


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
