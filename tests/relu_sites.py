"""ReLU decisions carried from the JAX ResNet to the port's, for the tests
that hold the two through a whole network (test_torch_resnet.py,
test_torch_zero.py).

Both packages compute every BatchNorm's statistics, and each residual
sum, in f32, in different summation orders, so a pre-activation within
about 1e-7 of 0 can take the ReLU's other side on one of them, and one
gradient term then moves its BatchNorm's sums by up to 1%.
:func:`record_jax_relus` makes the JAX model send each ReLU's derivative
(in forward order) to the host as it runs; :func:`force_port_relus`
makes each of the port's ReLUs, in the same order, take that derivative,
and collects ``|pre-activation|`` wherever the port's own differed, for
the caller to hold within :data:`BAND` of 0.
"""

from __future__ import annotations

import itertools

import numpy as np

# The widest |pre-activation| at which the two packages may decide a ReLU
# differently: well above their f32 noise (about 1e-7 to 1e-5 at these
# sizes), well below the activations' size (about 1).
BAND = 1e-4


class _RecordingJnp:
    """``jax.numpy`` for the JAX ResNet's module, whose ``maximum(a, 0)``
    (the plain route's ReLU and each block's residual ReLU) also records
    its derivative: 1 where ``a > 0``, 0.5 where ``a == 0`` (lax.max's
    tie), else 0."""

    def __init__(self, record):
        self._record = record

    def __getattr__(self, name):
        import jax.numpy as jnp
        return getattr(jnp, name)

    def maximum(self, a, b):
        import jax.numpy as jnp
        self._record(jnp.where(a > 0, 1.0, jnp.where(a == 0, 0.5, 0.0)))
        return jnp.maximum(a, b)


def record_jax_relus(setattr_, store: dict, axis: str | None = None):
    """Patch the JAX ResNet (through ``setattr_``, e.g. a monkeypatch's)
    to append each ReLU's derivative as it runs to ``store[site]``, or
    under a ``shard_map`` over ``axis`` to ``store[(site, device)]``:
    every BN+ReLU site (the Pallas op's mask being its output > 0) and
    each block's residual ReLU, sites numbered in forward order."""
    import jax
    import jax.numpy as jnp

    import tpu_ddp.models.resnet as jax_resnet
    bn_relu, sites = jax_resnet.ResNetModel._bn_relu, itertools.count()

    def record(weight):
        site = next(sites)

        def put(*args):
            key = site if axis is None else (site, int(args[0]))
            store.setdefault(key, []).append(np.asarray(args[-1]))

        if axis is None:
            jax.debug.callback(put, weight)
        else:
            jax.debug.callback(put, jax.lax.axis_index(axis), weight)

    def pallas_site(self, x, p, relu=True):
        out = bn_relu(self, x, p, relu)
        if relu and self.use_pallas_bn:
            record(jnp.where(out > 0, 1.0, 0.0))
        return out

    setattr_(jax_resnet.ResNetModel, "_bn_relu", pallas_site)
    setattr_(jax_resnet, "jnp", _RecordingJnp(record))


def force_port_relus(setattr_, weights):
    """Give each of the port's ReLUs, in forward order, the next of
    ``weights`` (NHWC arrays) as its derivative: ``torch.relu`` (the
    plain BN route and the residual), and the BN+ReLU op's plain versions
    (its forward, and the mask in its backward). Returns a record it
    fills: ``sites``, the ReLUs run, and ``moved``, the
    ``|pre-activation|`` of every entry where the port's own derivative
    differed."""
    import types

    import torch

    from tpu_ddp_torch.ops import bn_relu as op
    queue, by_mean = iter(weights), {}
    out = types.SimpleNamespace(sites=0, moved=[])

    class Forced(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            ctx.save_for_backward(w)
            return torch.where(w > 0, x, torch.zeros_like(x))

        @staticmethod
        def backward(ctx, g):
            w, = ctx.saved_tensors
            return g * w.to(g.dtype), None

    def weight_for(pre, rows):
        w = torch.from_numpy(np.array(next(queue), np.float32))
        w = w.reshape(-1, w.shape[-1]) if rows else w.permute(0, 3, 1, 2)
        out.sites += 1
        out.moved.extend(pre[(pre > 0).to(w.dtype) != w].abs().tolist())
        return w

    def relu(x):
        return Forced.apply(x, weight_for(x.detach(), False))

    def norm_relu(x2d, mean, inv, scale, bias):
        pre = (x2d - mean) * (inv * scale) + bias
        by_mean[mean.data_ptr()] = keep = weight_for(pre, True) > 0
        return torch.where(keep, pre, torch.zeros_like(pre))

    def masked_grad(x2d, g2d, mean, inv, scale, bias):
        x_hat = (x2d - mean) * inv
        return x_hat, torch.where(by_mean[mean.data_ptr()], g2d,
                                  torch.zeros_like(g2d))

    setattr_(torch, "relu", relu)
    setattr_(op, "bn_norm_relu_ref", norm_relu)
    setattr_(op, "_masked_grad", masked_grad)
    return out
