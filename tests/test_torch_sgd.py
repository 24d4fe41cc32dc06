"""The port's fused SGD (tpu_ddp_torch/ops/sgd.py, ops/optim.py) held
against the JAX package's Pallas kernel (interpret mode) and its
``SGD`` on the same numpy-seeded trees, over 3 steps (rtol/atol 1e-6, the
tolerance of tests/test_pallas.py:55-57). The kernel itself runs only
on the card, where chip_smoke.py requires it to equal its plain version
bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.ops.optim import SGD as JaxSGD
from tpu_ddp.ops.pallas import fused_sgd_step as jax_fused_sgd_step
from tpu_ddp_torch.ops import sgd as tsgd
from tpu_ddp_torch.ops.optim import SGD

# The lane-unaligned toy tree of tests/test_pallas.py:32-42.
SHAPES = {"conv_kernel": (3, 3, 3, 64), "conv_bias": (64,),
          "head_kernel": (512, 10), "head_bias": (10,), "odd": (7, 13),
          "scalarish": (1,)}


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}


def _torch(tree):
    return [torch.from_numpy(tree[k].copy()) for k in SHAPES]


def _close(got, want):
    for g, k in zip(got, SHAPES):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lr,momentum,wd", [(0.1, 0.9, 1e-4),
                                            (0.05, 0.0, 0.0)])
def test_fused_sgd_step_matches_jax(lr, momentum, wd):
    params, grads = _tree(0), _tree(1)
    jp, jb = ({k: jnp.asarray(v) for k, v in params.items()},
              {k: jnp.zeros(s, jnp.float32) for k, s in SHAPES.items()})
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    tp, tg = _torch(params), _torch(grads)
    tbuf = [torch.zeros(s) for s in SHAPES.values()]
    for _ in range(3):
        jp, jb = jax_fused_sgd_step(jp, jg, jb, lr=lr, momentum=momentum,
                                    weight_decay=wd)
        out = tsgd.fused_sgd_step(tp, tg, tbuf, lr=lr, momentum=momentum,
                                  weight_decay=wd)
        assert out[0][0] is tp[0]  # updated in place
    _close(tp, jp)
    _close(tbuf, jb)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_sgd_matches_jax_sgd(use_pallas):
    params, grads = _tree(2), _tree(3)
    jopt = JaxSGD(use_pallas=use_pallas)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    opt = SGD(use_pallas=use_pallas)
    tp, tg = _torch(params), _torch(grads)
    state = opt.init(tp)
    for _ in range(3):
        jp, jstate = jopt.apply(jp, {k: jnp.asarray(v)
                                     for k, v in grads.items()}, jstate)
        opt.apply(tp, tg, state)
    _close(tp, jp)
    _close(state["momentum"], jstate["momentum"])


def test_zero_momentum_zero_decay():
    """tests/test_pallas.py:59-68's case: one step, exact values."""
    p, g, b = torch.ones(130), torch.full((130,), 2.0), torch.zeros(130)
    tsgd.fused_sgd_step([p], [g], [b], lr=0.1, momentum=0.0,
                        weight_decay=0.0)
    np.testing.assert_allclose(p.numpy(), np.full(130, 0.8), rtol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.full(130, 2.0), rtol=1e-6)


def test_cpu_route_counts_no_launch():
    before = tsgd.fused_sgd_step.launches
    tsgd.fused_sgd_step([torch.ones(3)], [torch.ones(3)], [torch.zeros(3)],
                        lr=0.1, momentum=0.9, weight_decay=1e-4)
    assert tsgd.fused_sgd_step.launches == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "noncontig", "count"])
def test_rejects_bad_inputs(bad):
    p, g, b = [torch.ones(4, 6)], [torch.ones(4, 6)], [torch.zeros(4, 6)]
    if bad == "shape":
        g = [torch.ones(6, 4)]
    elif bad == "dtype":
        g = [torch.ones(4, 6, dtype=torch.float64)]
    elif bad == "noncontig":
        p = [torch.ones(6, 4).t()]
    else:
        b = []
    with pytest.raises((TypeError, ValueError)):
        tsgd.fused_sgd_step(p, g, b, lr=0.1, momentum=0.9,
                            weight_decay=1e-4)

