"""The port's fused BatchNorm+ReLU (tpu_ddp_torch/ops/bn_relu.py) held
against the JAX package's Pallas op (tpu_ddp/ops/pallas/bn_relu.py, run in
interpret mode on the CPU) on the same numpy-seeded inputs.

Tolerances are those of tests/test_pallas.py:92-114: forward rtol 1e-4 /
atol 1e-5, gradients 2e-4 (both sides sum in f32, in different orders).
The kernels themselves run only on the card, where chip_smoke.py holds
them against these plain versions.
"""

import re
from pathlib import Path

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


def _counts(wrapper):
    """A copy of a wrapper's launch count: an int, or a dict by route."""
    n = wrapper.launches
    return dict(n) if isinstance(n, dict) else n


def test_cpu_route_is_the_plain_version_and_counts_nothing():
    x, scale, bias = _inputs((64, 8), seed=5)
    x2d, s, b = map(torch.from_numpy, (x, scale, bias))
    g2d = torch.from_numpy(np.random.default_rng(6).normal(
        size=x.shape).astype(np.float32))
    before = [_counts(w) for w in (tb.bn_stats, tb.bn_norm_relu,
                                   tb.bn_bwd_stats, tb.bn_bwd_dx)]
    mean, inv = tb.bn_stats(x2d)
    assert all(torch.equal(a, b_) for a, b_ in
               zip((mean, inv), tb.bn_stats_ref(x2d)))
    assert torch.equal(tb.bn_norm_relu(x2d, mean, inv, s, b),
                       tb.bn_norm_relu_ref(x2d, mean, inv, s, b))
    db, ds = tb.bn_bwd_stats(x2d, g2d, mean, inv, s, b)
    assert torch.equal(tb.bn_bwd_dx(x2d, g2d, mean, inv, s, b, db, ds),
                       tb.bn_bwd_dx_ref(x2d, g2d, mean, inv, s, b, db, ds))
    after = [_counts(w) for w in (tb.bn_stats, tb.bn_norm_relu,
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


# VGG-11's conv outputs at batch 256 as (R, C) rows, and the small rows
# that take the kernels' scalar and ragged paths (chip_smoke.py's
# BN_SHAPES and BN_EDGE_SHAPES).
VGG_ROWS = [(262144, 64), (65536, 128), (16384, 256), (4096, 512),
            (1024, 512)]
EDGE_ROWS = [(300, 3), (999, 96), (1000, 30), (33, 4), (517, 1)]


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("name", ["bn_stats", "bn_bwd_stats"])
@pytest.mark.parametrize("r,c", VGG_ROWS + EDGE_ROWS)
def test_stats_plan_covers_every_row_once(r, c, name, sms):
    """The one-pass launch plan: every row in exactly one block, no empty
    block, whole clusters, every channel in one column block, at most one
    wave of blocks, and each lane walks its minimum of rows unless the
    layer is too small for more than one block."""
    vec = 4 if c % 4 == 0 else 1
    per_sm = 4
    plan = tb.stats_plan(name, r, c, vec, sms, per_sm)
    assert 1 <= plan.cluster <= 8 and plan.blocks % plan.cluster == 0
    assert plan.partials == plan.blocks // plan.cluster
    assert 1 <= plan.blocks <= r
    assert plan.blocks * plan.columns <= max(sms * 2, plan.columns)
    rows = [plan.rows(r, b) for b in range(plan.blocks)]
    assert all(len(rr) > 0 for rr in rows)
    assert [i for rr in rows for i in rr] == list(range(r))
    assert (plan.columns - 1) * plan.width < c <= plan.columns * plan.width
    assert plan.width <= 32 * vec
    assert plan.lanes * (plan.width // vec) <= 256
    if plan.blocks > 1:
        least = min(len(rr) for rr in rows)
        assert least >= plan.lanes * tb._MIN_ROWS_PER_LANE[name]


def test_stats_plan_fills_the_card_at_vgg_shapes():
    """The largest VGG-11 layer takes one wave of two blocks per SM; a
    small layer takes fewer, fuller blocks."""
    big = tb.stats_plan("bn_stats", 262144, 64, 4, 132, 4)
    assert 132 * 2 - 8 < big.blocks <= 132 * 2 and big.cluster == 8
    assert tb.stats_plan("bn_stats", 262144, 64, 4, 132, 1).blocks == 128
    small = tb.stats_plan("bn_stats", 1024, 512, 4, 132, 4)
    assert small.blocks * small.columns < 132
    assert small.partials <= 2


def test_stats_plan_rejects_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="multiple of vec"):
        tb.stats_plan("bn_stats", 64, 6, 4, 132, 4)
    too_wide = 4 * tb._ONE_PASS_GROUPS * (tb._COUNTERS + 1)
    with pytest.raises(ValueError, match="column blocks"):
        tb.stats_plan("bn_bwd_stats", 64, too_wide, 4, 132, 4)


@pytest.mark.parametrize("r,c", VGG_ROWS + EDGE_ROWS)
def test_stats_route_is_one_pass_on_the_main_path(r, c):
    assert tb.stats_route(r, c) == "one_pass"


def test_workspace_is_one_per_device_and_stream():
    saved = dict(tb._WORKSPACES)
    tb._WORKSPACES.clear()
    try:
        a = tb._workspace("cpu", 11)
        assert tb._workspace(torch.device("cpu"), 11) is a
        b = tb._workspace("cpu", 12)
        assert b is not a
        for ws in (a, b):
            assert ws.dtype == torch.int32
            assert tuple(ws.shape) == (tb._COUNTERS,)
            assert not ws.any()
        assert set(tb._WORKSPACES) == {(torch.device("cpu"), 11),
                                       (torch.device("cpu"), 12)}
    finally:
        tb._WORKSPACES.clear()
        tb._WORKSPACES.update(saved)


def test_cpu_route_allocates_no_workspace():
    saved = dict(tb._WORKSPACES)
    tb._WORKSPACES.clear()
    try:
        x, scale, bias = _inputs((4, 4, 4, 8), seed=7)
        ts = [torch.from_numpy(v).requires_grad_() for v in (x, scale, bias)]
        tb.batch_norm_relu(*ts).backward(torch.ones(x.shape))
        x2d = torch.from_numpy(x).reshape(-1, 8)
        tb.bn_stats(x2d)
        assert tb._WORKSPACES == {}
    finally:
        tb._WORKSPACES.clear()
        tb._WORKSPACES.update(saved)


def test_entry_point_argtypes_match_the_source():
    """Every C entry point of csrc/bn_relu.cu has the ctypes signature the
    wrapper declares, parameter for parameter (a missing one would pass
    the stream as a 32-bit int)."""
    src = (Path(tb.__file__).parent / "csrc" / tb._SOURCE).read_text()
    found = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src):
        kinds = ""
        for param in m.group(2).split(","):
            param = param.strip()
            kinds += ("P" if param.startswith("int*") else
                      "p" if "*" in param else
                      "f" if param.startswith("float") else "i")
        found[m.group(1)] = kinds
    assert found == tb._ARGTYPES


def _nan_inputs(shape, kind, seed):
    """``_inputs`` with NaN planted: whole rows of x (every channel's
    statistics NaN), or scattered elements of x in every third channel
    and of the upstream gradient g in others."""
    x, scale, bias = _inputs(shape, seed)
    g = np.random.default_rng(seed + 1).normal(size=shape).astype(np.float32)
    x2, g2 = x.reshape(-1, shape[-1]), g.reshape(-1, shape[-1])
    if kind == "rows":
        x2[[1, len(x2) // 2]] = np.nan
    else:
        x2[len(x2) // 3, ::3] = np.nan
        g2[len(g2) // 2, 1::3] = np.nan
    return x, scale, bias, g


def _same_nans(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", ["rows", "elements"])
@pytest.mark.parametrize("shape", [(16, 4, 4, 96), (64, 3)])
def test_nan_inputs_keep_nan_where_jax_does(kind, shape):
    """NaN in the batch stays NaN through the op and its gradients, at the
    positions the JAX kernel gives (its plain route on the CPU; on the
    card, chip_smoke.py phase 7 holds the CUDA kernels to the same plain
    versions on the same kinds of input)."""
    x, scale, bias, g = _nan_inputs(shape, kind, seed=7)

    def jf(a, s, b):
        return jnp.sum(jax_bn_relu(a, s, b) * jnp.asarray(g))

    jy = jax_bn_relu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    jg = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale),
                                         jnp.asarray(bias))
    ts = [torch.from_numpy(v).requires_grad_() for v in (x, scale, bias)]
    ty = tb.batch_norm_relu(*ts)
    ty.backward(torch.from_numpy(g))
    assert np.isnan(np.asarray(jy)).any()
    _same_nans(ty.detach().numpy(), jy, 1e-4)
    for got, want in zip((t.grad for t in ts), jg):
        _same_nans(got.numpy(), want, 2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rows", "elements"])
def test_kernels_keep_nan_like_the_plain_versions_on_card(kind):
    """The four CUDA kernels on NaN inputs, each fed its plain version's
    inputs: NaN exactly where the plain version has NaN."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    x, scale, bias, g = _nan_inputs((4096, 512), kind, seed=8)
    x, g, s, b = (torch.from_numpy(v).cuda() for v in (x, g, scale, bias))
    mean, inv = tb.bn_stats_ref(x)
    db, ds = tb.bn_bwd_stats_ref(x, g, mean, inv, s, b)
    pairs = [(tb.bn_stats(x), (mean, inv)),
             ((tb.bn_norm_relu(x, mean, inv, s, b),),
              (tb.bn_norm_relu_ref(x, mean, inv, s, b),)),
             (tb.bn_bwd_stats(x, g, mean, inv, s, b), (db, ds)),
             ((tb.bn_bwd_dx(x, g, mean, inv, s, b, db, ds),),
              (tb.bn_bwd_dx_ref(x, g, mean, inv, s, b, db, ds),))]
    for got, want in pairs:
        for a, w in zip(got, want):
            assert torch.equal(torch.isnan(a), torch.isnan(w))
