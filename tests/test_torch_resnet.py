"""The port's ResNet (tpu_ddp_torch/models/resnet.py) held against the JAX
package's ``ResNetModel`` on the same weights (through
``convert.resnet_params_from_jax``) and the same numpy-seeded images: a
shallow ResNet (one bottleneck per stage) at the full stage widths, with
``small_inputs`` off (7x7/2 stem and the SAME max-pool) and on (3x3/1
stem), and ``use_pallas_bn`` on (the JAX side's Pallas kernel in
interpret mode) and off.

Tolerances: logits rtol 1e-4 / atol 1e-5; every parameter gradient
through the whole network, rtol 1e-4 / atol 1e-5.

Both sides compute the convs in float64 (``compute_dtype``); both
packages compute every BatchNorm's statistics, and each block's residual
sum, in f32 whatever the compute dtype, so their summation orders still
part by about 1e-7. Two things follow, and the test deals with each:

- A ReLU input within that noise of 0 can take the ReLU's other side on
  one package, and one gradient term then moves its BatchNorm's sums by
  up to 1%. The JAX model records each ReLU's derivative as it runs, and
  the port's ReLUs take JAX's at the same site (tests/relu_sites.py).
  The test asserts that wherever the port's own derivative differed, its
  pre-activation lay within ``BAND`` of 0. So any data seed holds (seeds
  0-5 were run).
- BatchNorm over few rows magnifies that noise: with the 7x7/2 stem at
  32 px the last stage is 1x1 and each channel's statistics come from 4
  rows at batch 4, where the two packages' activations part by 1e-4. The
  7x7 stem's case runs at 64 px (16 rows per channel there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from relu_sites import BAND, force_port_relus, record_jax_relus
from tpu_ddp.models.resnet import ResNetModel as JaxResNet
from tpu_ddp.models.resnet import resnet50 as jax_resnet50
from tpu_ddp_torch.convert import (CanonicalView, resnet_params_from_jax,
                                   resnet_params_to_jax)
from tpu_ddp_torch.models import get_model
from tpu_ddp_torch.models.resnet import (ResNetModel, conv_same,
                                         max_pool_same, resnet50)
from tpu_ddp_torch.ops.loss import cross_entropy_loss

SHALLOW = (1, 1, 1, 1)
RTOL, ATOL = 1e-4, 1e-5
DATA_SEED = 0


def _pair(small_inputs, pallas_bn):
    """The JAX and port models on the same He-normal weights: drawn by
    the port (JAX's own init takes seconds per call eagerly) and carried
    to JAX through the converter."""
    jm = JaxResNet("shallow", SHALLOW, num_classes=10,
                   small_inputs=small_inputs, compute_dtype=jnp.float64,
                   use_pallas_bn=pallas_bn)
    tm = ResNetModel("shallow", SHALLOW, num_classes=10,
                     small_inputs=small_inputs, compute_dtype=torch.float64,
                     use_pallas_bn=pallas_bn)
    tm.init(torch.Generator().manual_seed(1))
    return jm, resnet_params_to_jax(tm), tm


def _nhwc(t):
    return np.ascontiguousarray(t.detach().permute(0, 2, 3, 1).numpy())


def _conv(x, k, s):
    return lax.conv_general_dilated(x, k, (s, s), "SAME",
                                    dimension_numbers=("NHWC", "HWIO",
                                                       "NHWC"))


@pytest.mark.parametrize("pallas_bn", [False, True])
@pytest.mark.parametrize("small_inputs,batch,size", [(False, 4, 64),
                                                     (True, 2, 32)])
def test_logits_and_grads_match_jax(small_inputs, batch, size, pallas_bn,
                                    monkeypatch):
    jm, jp, tm = _pair(small_inputs, pallas_bn)
    rng = np.random.default_rng(DATA_SEED)
    x = rng.normal(size=(batch, size, size, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=batch)

    def jax_loss(p, img, lab):
        logits = jm.apply(p, img)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, lab[:, None], 1)), logits

    jax_weight = {}
    with monkeypatch.context() as patch, jax.enable_x64(True):
        record_jax_relus(patch.setattr, jax_weight)
        (_, jlogits), jgrads = jax.jit(jax.value_and_grad(
            jax_loss, has_aux=True))(jp, jnp.asarray(x), jnp.asarray(y))
        jax.effects_barrier()
    assert sorted(jax_weight) == list(range(1 + 3 * len(SHALLOW)))
    with monkeypatch.context() as patch:
        forced = force_port_relus(patch.setattr, [
            w for _, (w,) in sorted(jax_weight.items())])
        logits = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
        cross_entropy_loss(logits, torch.from_numpy(y)).backward()
    # Where the two sides' ReLUs decided differently, the pre-activation
    # lay within the noise band of 0.
    assert forced.sites == len(jax_weight)
    assert max(forced.moved, default=0.0) < BAND, forced.moved
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=ATOL)
    canon = CanonicalView(tm)
    want = canon.from_tree(jax.tree.map(np.asarray, jgrads))
    got = canon.leaves([p.grad for p in tm.parameters()])
    for i, path in enumerate(canon.paths):
        np.testing.assert_allclose(got[i].numpy(), want[i], rtol=RTOL,
                                   atol=ATOL, err_msg=str(path))


@pytest.mark.parametrize("n", [15, 16, 17, 32])
@pytest.mark.parametrize("k,stride", [(1, 2), (3, 1), (3, 2), (7, 2)])
def test_conv_same_matches_lax(n, k, stride):
    """Forward and both gradients of the SAME conv, odd and even sizes
    (asymmetric padding where the total is odd), at 64 input channels,
    ResNet's narrowest. (PyTorch's CPU backward of a channels_last 1x1
    stride-2 conv with fewer than 16 input channels corrupts the heap.)"""
    rng = np.random.default_rng(n * k + stride)
    x = rng.normal(size=(2, n, n, 64)).astype(np.float32)
    w = rng.normal(size=(k, k, 64, 16)).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b: _conv(a, b, stride), jnp.asarray(x),
                        jnp.asarray(w))
    g = rng.normal(size=want.shape).astype(np.float32)
    gx, gw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    tw = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous() \
        .requires_grad_()
    out = conv_same(tx, tw, stride)
    out.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    # f32 sums of up to 3136 products in another order: rtol 1e-4.
    np.testing.assert_allclose(_nhwc(out), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_nhwc(tx.grad), np.asarray(gx), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tw.grad.permute(2, 3, 1, 0).numpy(),
                               np.asarray(gw), rtol=1e-4, atol=1e-4)
    # The input gradient is channels_last-dense, as the BN+ReLU op's
    # backward takes it.
    assert tx.grad.permute(0, 2, 3, 1).is_contiguous()


@pytest.mark.parametrize("n", [15, 16, 112])
@pytest.mark.parametrize("k", [1, 3])
def test_max_pool_same_matches_lax(n, k):
    rng = np.random.default_rng(n + k)
    x = rng.normal(size=(2, n, n, 4)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: lax.reduce_window(
        a, -jnp.inf, lax.max, (1, k, k, 1), (1, 2, 2, 1), "SAME"),
        jnp.asarray(x))
    g = rng.normal(size=want.shape).astype(np.float32)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    out = max_pool_same(tx, k, 2)
    out.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(_nhwc(out), np.asarray(want))
    np.testing.assert_array_equal(_nhwc(tx.grad),
                                  np.asarray(vjp(jnp.asarray(g))[0]))
    assert tx.grad.permute(0, 2, 3, 1).is_contiguous()


def test_resnet50_size_leaves_and_round_trip():
    m = get_model("ResNet50", num_classes=1000)
    assert m.num_params() == 25_557_032
    canon = CanonicalView(m)
    assert len(canon.shapes) == 161
    # JAX's leaf order and shapes, without running the JAX model.
    jm = jax_resnet50(num_classes=1000)
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    assert [tuple(a.shape) for a in jax.tree.leaves(shapes)] == canon.shapes
    tree = resnet_params_to_jax(m)
    assert jax.tree.structure(tree) == jax.tree.structure(shapes)
    back = ResNetModel("ResNet50", (3, 4, 6, 3), num_classes=1000)
    back.init(torch.Generator().manual_seed(7))
    back.load_state_dict(resnet_params_from_jax(back, tree, device="cpu"))
    for a, b in zip(m.parameters(), back.parameters()):
        assert torch.equal(a, b)
    bad = dict(tree, stem=dict(tree["stem"], kernel=tree["stem"]["kernel"]
                               [:, :, :2]))
    with pytest.raises(ValueError, match="stem/kernel"):
        resnet_params_from_jax(m, bad, device="cpu")
    assert resnet50().num_params() == 25_557_032


@pytest.mark.parametrize("remat", ["blocks", "conv_stages"])
def test_remat_gives_the_same_gradients(remat):
    """A memory policy changes what is saved, not the arithmetic: the
    gradients under blocks and conv_stages equal those under none bit
    for bit (both BN routes' plain versions on the CPU)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 3, 32, 32)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=2))
    grads = []
    for mode in ("none", remat):
        m = ResNetModel("shallow", SHALLOW, num_classes=10,
                        small_inputs=True, compute_dtype=torch.float32,
                        use_pallas_bn=True, remat=mode)
        cross_entropy_loss(m(x), y).backward()
        grads.append([p.grad for p in m.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_activations_stay_channels_last_in_bf16():
    """bf16 end to end with the BN+ReLU op: every site's gradient arrives
    NHWC-dense (the op raises otherwise), the stride-2 pads included."""
    m = ResNetModel("shallow", SHALLOW, num_classes=10,
                    compute_dtype=torch.bfloat16, use_pallas_bn=True)
    out = m(torch.randn(2, 3, 32, 32))
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, 10)
    out.sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in m.parameters())
