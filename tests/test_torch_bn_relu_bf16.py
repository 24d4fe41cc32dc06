"""The BN+ReLU backward on bf16 rows (tpu_ddp_torch/ops/bn_relu.py).

``bn_bwd_stats`` and ``bn_bwd_dx`` take f32 or bf16 (R, C) rows. On bf16
rows each computes the f32 version's values on the exactly upcast rows,
and ``bn_bwd_dx`` rounds dx to bf16 as ``.to(torch.bfloat16)`` does: the
plain versions are held to that bit for bit here, as the CUDA kernels are
on the card (chip_smoke.py phase 35). The op hands its backward's bf16 x
and gradient to the two wrappers as they are, with no f32 copy and no cast
of dx, and its backward on a bf16 activation is held to the JAX op's VJP
on the same bf16 input (the Pallas kernels in interpret mode, as
tests/test_torch_bn_relu.py runs them).

Tolerance against JAX: both packages compute in f32 from the same bf16
values but sum the statistics in different orders, so their f32 dx part
in the last bits and can round to neighbouring bf16 values: dx within
one bf16 ulp wherever the pre-activation lies more than ``BAND`` from
the ReLU's edge. dscale and dbias, per channel: 1e-5 of the sum of their
terms' magnitudes (rtol 1e-5 on a sum that does not cancel; a channel
whose terms cancel to near 0 keeps the absolute error of its terms'
size), plus the terms of the elements within ``BAND`` of the edge, which
either package may mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.ops.pallas import batch_norm_relu as jax_bn_relu
from tpu_ddp_torch.models.resnet import ResNetModel
from tpu_ddp_torch.models.vgg import VGGModel
from tpu_ddp_torch.ops import bn_relu as tb
from tpu_ddp_torch.ops.loss import cross_entropy_loss

BAND = 1e-4
ROWS = [(512, 64), (300, 96), (257, 3), (64, 8)]


def _bits(t):
    """The raw bits of a bf16 or f32 tensor (NaN compared by its bits)."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _rows(r, c, seed, nan=False):
    """bf16 (R, C) rows x and g, f32 scale and bias, and the plain
    statistics of the upcast x."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(r, c)) * 2 + 0.3)
                         .astype(np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(rng.normal(size=(r, c)).astype(np.float32)
                         ).to(torch.bfloat16)
    if nan:
        x[r // 3, ::3] = float("nan")
        g[r // 2, 1::3] = float("nan")
    s = torch.from_numpy(rng.uniform(0.5, 1.5, size=c).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=c) * 0.1).astype(np.float32))
    mean, inv = tb.bn_stats_ref(x.float())
    return x, g, mean, inv, s, b


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("r,c", ROWS)
def test_bf16_rows_are_the_f32_route_plus_the_cast(r, c, nan):
    """Both wrappers' CPU route on bf16 rows: dbias and dscale the f32
    route's bits on the upcast rows, dx those bits rounded to bf16."""
    x, g, mean, inv, s, b = _rows(r, c, seed=r + c, nan=nan)
    db16, ds16 = tb.bn_bwd_stats(x, g, mean, inv, s, b)
    db, ds = tb.bn_bwd_stats(x.float(), g.float(), mean, inv, s, b)
    assert db16.dtype == ds16.dtype == torch.float32
    assert _same_bits(db16, db) and _same_bits(ds16, ds)
    dx16 = tb.bn_bwd_dx(x, g, mean, inv, s, b, db, ds)
    dx = tb.bn_bwd_dx(x.float(), g.float(), mean, inv, s, b, db, ds)
    assert dx16.dtype == torch.bfloat16 and dx.dtype == torch.float32
    assert _same_bits(dx16, dx.to(torch.bfloat16))
    if nan:
        assert torch.isnan(dx16).any()


def test_f32_rows_keep_the_f32_plain_versions():
    """On f32 rows the plain versions copy nothing and return f32."""
    x, g, mean, inv, s, b = _rows(128, 16, seed=3)
    x, g = x.float(), g.float()
    x_hat = (x - mean) * inv
    gy = torch.where(x_hat * s + b > 0, g, torch.zeros_like(g))
    db, ds = tb.bn_bwd_stats(x, g, mean, inv, s, b)
    assert _same_bits(db, gy.sum(0)) and _same_bits(ds, (gy * x_hat).sum(0))
    dx = tb.bn_bwd_dx(x, g, mean, inv, s, b, db, ds)
    want = (s * inv * (1.0 / 128)) * (128 * gy - db - x_hat * ds)
    assert _same_bits(dx, want)


def _ulp_bf16(v):
    """One bf16 ulp at |v| (the spacing of bf16 values there)."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("shape", [(16, 4, 4, 64), (8, 6, 6, 96),
                                   (300, 3)])
def test_op_backward_on_bf16_matches_jax_vjp(shape):
    rng = np.random.default_rng(sum(shape))
    c = shape[-1]
    x = (rng.normal(size=shape) * 2 + 0.3).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=c).astype(np.float32)
    bias = (rng.normal(size=c) * 0.1).astype(np.float32)
    xj = jnp.asarray(x, dtype=jnp.bfloat16)
    gj = jnp.asarray(g, dtype=jnp.bfloat16)
    _, vjp = jax.vjp(jax_bn_relu, xj, jnp.asarray(scale), jnp.asarray(bias))
    jdx, jds, jdb = vjp(gj)
    assert jdx.dtype == jnp.bfloat16

    x16 = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    tbias = torch.from_numpy(bias).requires_grad_()
    g16 = torch.from_numpy(g).to(torch.bfloat16)
    tb.batch_norm_relu(x16, ts, tbias).backward(g16)
    assert x16.grad.dtype == torch.bfloat16

    # Elements whose pre-activation lies within BAND of 0 (on the port's
    # statistics) may be masked differently by the two packages.
    x2d = x16.detach().float().reshape(-1, c)
    mean, inv = tb.bn_stats_ref(x2d)
    x_hat = (x2d - mean) * inv
    near = (x_hat * ts.detach() + tbias.detach()).abs() <= BAND
    assert int(near.sum()) <= 1e-3 * near.numel()

    got = x16.grad.float().reshape(-1, c)
    want = torch.from_numpy(np.array(jdx.astype(jnp.float32))).reshape(
        -1, c)
    ulp = _ulp_bf16(torch.maximum(got.abs(), want.abs()))
    err = torch.where(near, 0.0, (got - want).abs())
    assert bool((err <= ulp).all()), float((err / ulp).max())

    g2d = g16.float().reshape(-1, c)
    for got, want, terms in ((tbias.grad, jdb, g2d.abs()),
                             (ts.grad, jds, (g2d * x_hat).abs())):
        want = torch.from_numpy(np.array(want))
        tol = 1e-5 * terms.sum(0) + torch.where(near, terms, 0.0).sum(0)
        assert bool(((got - want).abs() <= tol).all()), (got - want, tol)


def _recording(monkeypatch):
    """Stub both backward wrappers with ones that record the dtypes of the
    rows they are handed, then call the real wrapper."""
    seen = []
    for name in ("bn_bwd_stats", "bn_bwd_dx"):
        real = getattr(tb, name)

        def stub(x2d, g2d, *rest, _real=real, _name=name):
            seen.append((_name, x2d.dtype, g2d.dtype))
            return _real(x2d, g2d, *rest)

        monkeypatch.setattr(tb, name, stub)
    return seen


def test_op_hands_bf16_rows_to_the_kernels_on_a_bf16_resnet(monkeypatch):
    """A shallow bf16 ResNet (every BN+ReLU site's conv output and its
    gradient bf16): each backward call of both wrappers gets bf16 x and
    g, once per site."""
    seen = _recording(monkeypatch)
    m = ResNetModel("shallow", (1, 1, 1, 1), num_classes=10,
                    compute_dtype=torch.bfloat16, use_pallas_bn=True)
    out = m(torch.randn(2, 3, 32, 32, generator=torch.Generator()
                        .manual_seed(0)))
    cross_entropy_loss(out, torch.tensor([1, 7])).backward()
    sites = 1 + 2 * 4  # the stem, then conv1 and conv2 of each block
    assert len(seen) == 2 * sites
    assert {dt for _, x, g in seen for dt in (x, g)} == {torch.bfloat16}


def test_op_hands_f32_rows_to_the_kernels_on_vgg(monkeypatch):
    """VGG feeds the op the f32 ``conv + bias``: f32 rows, as before."""
    seen = _recording(monkeypatch)
    cfg = (16, "M", 32, "M", 32, "M", 32, "M", 32, "M")
    m = VGGModel("narrow", cfg, compute_dtype=torch.bfloat16,
                 use_pallas_bn=True)
    out = m(torch.randn(2, 3, 32, 32, generator=torch.Generator()
                        .manual_seed(1)))
    cross_entropy_loss(out, torch.tensor([2, 5])).backward()
    assert len(seen) == 2 * 5
    assert {dt for _, x, g in seen for dt in (x, g)} == {torch.float32}


@pytest.mark.parametrize("shape", [(4, 6, 6, 32), (50, 5)])
def test_op_backward_routes_give_the_same_bits(shape, monkeypatch):
    """The op's backward on bf16 x and g, with the rows handed over as
    they are and with the previous route (f32 copies, dx cast) forced:
    the same bits for dx, dscale and dbias."""
    x, g, mean, inv, s, b = _rows(int(np.prod(shape[:-1])), shape[-1],
                                  seed=11)
    x, g = x.reshape(shape), g.reshape(shape)
    assert tb.bwd_rows(x.dtype, g.dtype) == "bf16"
    new = tb.bn_relu_backward(x, g, mean, inv, s, b)
    monkeypatch.setattr(tb, "bwd_rows", lambda *_: "f32")
    old = tb.bn_relu_backward(x, g, mean, inv, s, b)
    assert new[0].dtype == torch.bfloat16 and new[0].shape == x.shape
    assert all(_same_bits(a, o) for a, o in zip(new, old))


@pytest.mark.parametrize("xd,gd,want", [
    (torch.bfloat16, torch.bfloat16, "bf16"),
    (torch.float32, torch.float32, "f32"),
    (torch.bfloat16, torch.float32, "f32"),
    (torch.float32, torch.bfloat16, "f32"),
    (torch.float64, torch.float64, "f32"),
    (torch.float16, torch.float16, "f32")])
def test_bwd_rows_hands_over_only_a_bf16_pair(xd, gd, want):
    assert tb.bwd_rows(xd, gd) == want


def test_op_backward_on_mixed_dtypes_upcasts_the_bf16_one():
    """A bf16 x under an f32 gradient: both go to the kernels as f32 rows
    (the bf16 one upcast exactly) and dx comes back bf16."""
    x, g, mean, inv, s, b = _rows(96, 16, seed=12)
    dx, ds, db = tb.bn_relu_backward(x, g.float(), mean, inv, s, b)
    wdb, wds = tb.bn_bwd_stats(x.float(), g.float(), mean, inv, s, b)
    wdx = tb.bn_bwd_dx(x.float(), g.float(), mean, inv, s, b, wdb, wds)
    assert _same_bits(dx, wdx.to(torch.bfloat16))
    assert _same_bits(db, wdb) and _same_bits(ds, wds)


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("vec", [8, 4, 1])
@pytest.mark.parametrize("r,c", [(3211264, 64), (12544, 512), (4096, 512),
                                 (1024, 512), (999, 96), (300, 3), (33, 8),
                                 (517, 1), (7, 4096)])
def test_dx_plan_is_one_wave_over_every_row(r, c, vec, sms):
    """The one-wave dx grid: every row in exactly one block, no block
    empty, at most one wave of blocks, every channel in one column block,
    and each lane at least its minimum of rows unless the layer is too
    small for more than one block."""
    if c % vec:
        with pytest.raises(ValueError, match="multiple of vec"):
            tb.dx_plan(r, c, vec, sms, 2)
        return
    per_sm = 2
    plan = tb.dx_plan(r, c, vec, sms, per_sm)
    assert 1 <= plan.blocks <= r
    assert plan.blocks * plan.columns <= max(sms * per_sm, plan.columns)
    groups = c // vec
    assert plan.columns == -(-groups // min(groups, 256))
    assert plan.lanes * min(groups, 256) <= 256
    rows = [plan.rows(r, b) for b in range(plan.blocks)]
    assert all(len(rr) > 0 for rr in rows)
    assert sum(len(rr) for rr in rows) == r
    assert rows[0].start == 0 and rows[-1].stop == r
    assert all(a.stop == b_.start for a, b_ in zip(rows, rows[1:]))
    if plan.blocks > 1:
        assert r // plan.blocks >= plan.lanes * tb._DX_MIN_ROWS_PER_LANE


def test_dx_plan_fills_the_card_at_the_resnet_stem():
    plan = tb.dx_plan(3211264, 64, 8, 132, 2)
    assert (plan.blocks, plan.columns, plan.lanes) == (264, 1, 32)


@pytest.mark.parametrize("r,c", [(3211264, 64), (4096, 512), (300, 3)])
def test_dx_route_is_one_wave_on_the_main_path(r, c):
    assert tb.dx_route(r, c) == "one_wave"


def test_launch_counts_are_keyed_by_route_and_dtype():
    assert set(tb.bn_bwd_stats.launches) == {"one_pass", "one_pass_bf16",
                                             "two_stage"}
    assert set(tb.bn_bwd_dx.launches) == {"one_wave", "one_wave_bf16",
                                          "row_blocks"}
    assert tb._key("one_wave", torch.empty(1, dtype=torch.bfloat16)) \
        == "one_wave_bf16"
    assert tb._key("one_pass", torch.empty(1)) == "one_pass"
