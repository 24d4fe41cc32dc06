"""The port's VGG (tpu_ddp_torch/models/vgg.py) held against the JAX
package's ``VGGModel.apply`` in f32 on the same weights (through
``convert.image_params_from_jax``) and the same numpy-seeded images, with
``use_pallas_bn`` on (the JAX side's Pallas kernel in interpret mode) and
off.

Tolerances: logits rtol 1e-4 / atol 1e-5; parameter gradients rtol 1e-4
/ atol 1e-5 (the conv biases' true gradient is zero — batch-statistics
BN removes them — so their values are f32 noise of order 1e-7 on both
sides, held by the absolute term).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.models.vgg import VGGModel as JaxVGG, batch_norm as jax_bn
from tpu_ddp.models.vgg import make_vgg as jax_make_vgg
from tpu_ddp.ops.loss import cross_entropy_loss as jax_ce
from tpu_ddp_torch.convert import image_params_from_jax, image_params_to_jax
from tpu_ddp_torch.models.vgg import (VGGModel, batch_norm, get_model,
                                      make_vgg)
from tpu_ddp_torch.ops.loss import cross_entropy_loss

NARROW = (8, "M", 16, "M", 16, 16, "M", 16, "M", 24, "M")  # five pools


def _pair(name, cfg, pallas_bn):
    if cfg is None:
        jm = jax_make_vgg(name, compute_dtype=jnp.float32,
                          use_pallas_bn=pallas_bn)
        tm = make_vgg(name, compute_dtype=torch.float32,
                      use_pallas_bn=pallas_bn)
    else:
        jm = JaxVGG(name=name, cfg=cfg, compute_dtype=jnp.float32,
                    use_pallas_bn=pallas_bn)
        tm = VGGModel(name, cfg, compute_dtype=torch.float32,
                      use_pallas_bn=pallas_bn)
    jp = jm.init(jax.random.key(89395))
    tm.load_state_dict(image_params_from_jax(
        tm, jax.tree.map(np.asarray, jp), device="cpu"))
    return jm, jp, tm


@pytest.mark.parametrize("pallas_bn", [False, True])
@pytest.mark.parametrize("name,cfg,batch", [("narrow", NARROW, 4),
                                            ("VGG11", None, 2)])
def test_logits_and_grads_match_jax(name, cfg, batch, pallas_bn):
    jm, jp, tm = _pair(name, cfg, pallas_bn)
    rng = np.random.default_rng(batch)
    x = rng.normal(size=(batch, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=batch)

    def loss_fn(p):
        logits = jm.apply(p, jnp.asarray(x))
        return jax_ce(logits, jnp.asarray(y, jnp.int32)), logits

    (_, jlogits), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    logits = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)
    cross_entropy_loss(logits, torch.from_numpy(y)).backward()
    want = image_params_from_jax(tm, jax.tree.map(np.asarray, jgrads),
                               device="cpu")
    got = dict(tm.named_parameters())
    assert set(want) == set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].grad.numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_knob_off_batch_norm_matches_jax():
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(6, 5, 5, 12)) * 2 + 0.5).astype(np.float32)
    s = rng.uniform(0.5, 1.5, 12).astype(np.float32)
    b = rng.normal(size=12).astype(np.float32)
    want = np.asarray(jax_bn(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
    got = batch_norm(torch.from_numpy(x).permute(0, 3, 1, 2),
                     torch.from_numpy(s), torch.from_numpy(b))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-4, atol=1e-5)


def test_converter_round_trip_and_checks():
    jm, jp, tm = _pair("narrow", NARROW, False)
    back = image_params_to_jax(tm)
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    bad = jax.tree.map(np.asarray, jp)
    bad["features"][1]["kernel"] = bad["features"][1]["kernel"][:, :, :-1]
    with pytest.raises(ValueError, match="features/1/kernel"):
        image_params_from_jax(tm, bad, device="cpu")


def test_vgg11_shape_and_size():
    m = get_model("VGG11", compute_dtype=torch.float32)
    assert m.num_params() == 9_231_114
    assert len(list(m.parameters())) == 34
    jm = jax_make_vgg("VGG11")
    assert m.num_params() == jm.num_params()
    # vgg.get_model is the model registry: every JAX image model name.
    assert get_model("ResNet50").name == "ResNet50"
    with pytest.raises(ValueError, match="available"):
        get_model("VGG12")


def test_activations_stay_channels_last():
    """The layout the BN+ReLU kernel needs: every conv output's NHWC
    view is contiguous, so the op never has to copy (it would raise)."""
    m = VGGModel("narrow", NARROW, compute_dtype=torch.bfloat16,
                 use_pallas_bn=True)
    x = torch.randn(2, 3, 32, 32)  # plain NCHW in, converted once
    out = m(x)
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, 10)
    out.sum().backward()
    assert all(p.grad is not None and p.grad.is_contiguous()
               for p in m.parameters())
