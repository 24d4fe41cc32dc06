"""The port's fused BatchNorm+ReLU (tpu_ddp_torch/ops/bn_relu.py) held
against the JAX package's Pallas op (tpu_ddp/ops/pallas/bn_relu.py, run in
interpret mode on the CPU) on the same numpy-seeded inputs.

Tolerances are those of tests/test_pallas.py:92-114: forward rtol 1e-4 /
atol 1e-5, gradients 2e-4 (both sides sum in f32, in different orders).
The kernels themselves run only on the card, where chip_smoke.py holds
them against these plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.ops.pallas import batch_norm_relu as jax_bn_relu
from tpu_ddp_torch.ops import bn_relu as tb

SHAPES = [(32, 4, 4, 64), (16, 8, 8, 96), (64, 3)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=c).astype(np.float32)
    bias = (rng.normal(size=c) * 0.1).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_jax(shape):
    x, scale, bias = _inputs(shape)
    want = np.asarray(jax_bn_relu(jnp.asarray(x), jnp.asarray(scale),
                                  jnp.asarray(bias)))
    got = tb.batch_norm_relu(torch.from_numpy(x), torch.from_numpy(scale),
                             torch.from_numpy(bias))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(8, 4, 4, 32)] + SHAPES)
def test_gradients_match_jax(shape):
    x, scale, bias = _inputs(shape, seed=1)
    g_j = jax.grad(lambda a, s, b: jnp.sum(jax_bn_relu(a, s, b) ** 2),
                   argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale),
                                      jnp.asarray(bias))
    tx, ts, tbias = (torch.from_numpy(v).requires_grad_()
                     for v in (x, scale, bias))
    (tb.batch_norm_relu(tx, ts, tbias) ** 2).sum().backward()
    for got, want in zip((tx.grad, ts.grad, tbias.grad), g_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)


def test_op_matches_plain_composition_under_autograd():
    """The autograd Function's backward kernels against autograd through
    the plain forward (batch_norm_relu_ref)."""
    x, scale, bias = _inputs((16, 8, 8, 96), seed=2)
    g = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    grads = []
    for fn in (tb.batch_norm_relu, tb.batch_norm_relu_ref):
        ts = [torch.from_numpy(v).requires_grad_() for v in (x, scale, bias)]
        fn(*ts).backward(torch.from_numpy(g))
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-4)


def test_bf16_input_computes_in_f32_and_returns_bf16():
    x, scale, bias = _inputs((8, 4, 4, 16), seed=4)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tb.batch_norm_relu(xb, torch.from_numpy(scale),
                             torch.from_numpy(bias))
    want = tb.batch_norm_relu_ref(xb.float(), torch.from_numpy(scale),
                                  torch.from_numpy(bias)).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_cpu_route_is_the_plain_version_and_counts_nothing():
    x, scale, bias = _inputs((64, 8), seed=5)
    x2d, s, b = map(torch.from_numpy, (x, scale, bias))
    g2d = torch.from_numpy(np.random.default_rng(6).normal(
        size=x.shape).astype(np.float32))
    before = [w.launches for w in (tb.bn_stats, tb.bn_norm_relu,
                                   tb.bn_bwd_stats, tb.bn_bwd_dx)]
    mean, inv = tb.bn_stats(x2d)
    assert all(torch.equal(a, b_) for a, b_ in
               zip((mean, inv), tb.bn_stats_ref(x2d)))
    assert torch.equal(tb.bn_norm_relu(x2d, mean, inv, s, b),
                       tb.bn_norm_relu_ref(x2d, mean, inv, s, b))
    db, ds = tb.bn_bwd_stats(x2d, g2d, mean, inv, s, b)
    assert torch.equal(tb.bn_bwd_dx(x2d, g2d, mean, inv, s, b, db, ds),
                       tb.bn_bwd_dx_ref(x2d, g2d, mean, inv, s, b, db, ds))
    after = [w.launches for w in (tb.bn_stats, tb.bn_norm_relu,
                                  tb.bn_bwd_stats, tb.bn_bwd_dx)]
    assert after == before


@pytest.mark.parametrize("bad", ["noncontig", "dtype", "chan_shape",
                                 "rows_shape", "rank"])
def test_wrappers_reject_bad_layouts(bad):
    x = torch.randn(32, 8)
    c = torch.ones(8)
    g = torch.randn(32, 8)
    if bad == "noncontig":
        x = torch.randn(8, 32).t()
    elif bad == "dtype":
        x = x.double()
    elif bad == "chan_shape":
        c = torch.ones(9)
    elif bad == "rows_shape":
        g = torch.randn(31, 8)
    else:
        x = x.reshape(4, 8, 8)
    with pytest.raises((TypeError, ValueError)):
        if bad == "rows_shape":
            tb.bn_bwd_stats(x, g, c, c, c, c)
        else:
            tb.bn_norm_relu(x, c, c, c, c)


def test_op_rejects_a_non_contiguous_activation():
    x = torch.randn(4, 8, 6, 6).permute(0, 2, 3, 1)  # NCHW-contiguous
    with pytest.raises(ValueError, match="C-contiguous"):
        tb.batch_norm_relu(x, torch.ones(8), torch.zeros(8))

