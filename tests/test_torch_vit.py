"""The port's ViT (tpu_ddp_torch/models/vit.py) held against the JAX
package's ``ViTModel.apply`` in f32 on the same weights (through
``convert.vit_params_from_jax``) and the same numpy-seeded images, with
``use_flash`` on (the JAX side's Pallas flash kernel in interpret mode,
non-causal; the port's op runs its plain versions on the CPU) and off
(``full_attention`` on both sides). ViT-tiny is narrowed as
tests/test_vit.py narrows it: 2 layers, d_model 64, d_ff 128, 2 heads.

Tolerances, as tests/test_torch_flash.py: logits rtol/atol 3e-5, every
parameter gradient 3e-4 (the two sides differ in summation order only:
LayerNorm, GELU and the pooled head are smooth, so the comparison is
well posed through the whole network).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.models.vit import make_vit as jax_make_vit
from tpu_ddp.ops.loss import cross_entropy_loss as jax_ce
from tpu_ddp_torch.convert import (CanonicalView, vit_params_from_jax,
                                   vit_params_to_jax)
from tpu_ddp_torch.models import get_model
from tpu_ddp_torch.models.vit import ViTModel, make_vit
from tpu_ddp_torch.ops.loss import cross_entropy_loss

NARROW = dict(num_layers=2, d_model=64, d_ff=128, num_heads=2)
VAL_TOL, GRAD_TOL = 3e-5, 3e-4


def _pair(use_flash, **kw):
    jm = jax_make_vit("ViT-tiny", compute_dtype=jnp.float32,
                      use_flash=use_flash, **NARROW)
    tm = make_vit("ViT-tiny", compute_dtype=torch.float32,
                  use_flash=use_flash, **NARROW, **kw)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(89395)))
    tm.load_state_dict(vit_params_from_jax(tm, jp, device="cpu"))
    return jm, jp, tm


def _images(batch, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, size=batch))


@pytest.mark.parametrize("use_flash", [False, True])
def test_logits_and_grads_match_jax(use_flash):
    jm, jp, tm = _pair(use_flash)
    x, y = _images(3)

    def loss_fn(p):
        logits = jm.apply(p, jnp.asarray(x))
        return jax_ce(logits, jnp.asarray(y, jnp.int32)), logits

    (_, jlogits), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    logits = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=VAL_TOL, atol=VAL_TOL)
    cross_entropy_loss(logits, torch.from_numpy(y)).backward()
    want = vit_params_from_jax(tm, jax.tree.map(np.asarray, jgrads),
                               device="cpu")
    got = dict(tm.named_parameters())
    assert set(want) == set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].grad.numpy(), v.numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)


def test_patchify_order_is_jax():
    """Patch rows in the (gh, gw, p, p, C) order of the NHWC image, from
    the loader's NCHW view of NHWC memory and from a plain NCHW tensor."""
    jm, _, tm = _pair(False)
    x, _ = _images(2, seed=5)
    want = np.asarray(jm._patchify(jnp.asarray(x)))
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    np.testing.assert_array_equal(tm._patchify(nchw).numpy(), want)
    np.testing.assert_array_equal(
        tm._patchify(nchw.contiguous()).numpy(), want)


def test_converter_round_trip_and_layouts():
    jm, jp, tm = _pair(False)
    canon = CanonicalView(tm)
    assert [tuple(a.shape) for a in jax.tree.leaves(jp)] == canon.shapes
    back = vit_params_to_jax(tm)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    assert tuple(tm.blocks[0].wqkv.shape) == (64, 3, 2, 32)
    assert tuple(tm.blocks[0].wo.shape) == (2, 32, 64)
    assert tuple(tm.patch.kernel.shape) == (4 * 4 * 3, 64)
    bad = jax.tree.map(np.asarray, jp)
    bad["blocks"][1]["wo"] = bad["blocks"][1]["wo"][:, :, :-1]
    with pytest.raises(ValueError, match="blocks/1/wo"):
        vit_params_from_jax(tm, bad, device="cpu")


@pytest.mark.parametrize("name,leaves", [("ViT-tiny", 55), ("ViT-S16", 103)])
def test_presets_match_jax(name, leaves):
    m = get_model(name, use_pallas_bn=True)  # the knob is taken, ignored
    jm = jax_make_vit(name)
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    canon = CanonicalView(m)
    assert len(canon.shapes) == leaves
    assert [tuple(a.shape) for a in jax.tree.leaves(shapes)] == canon.shapes
    assert m.num_params() == sum(int(np.prod(a.shape))
                                 for a in jax.tree.leaves(shapes))
    assert not hasattr(m, "use_pallas_bn")


@pytest.mark.parametrize("remat", ["blocks", "dots", "conv_stages"])
def test_remat_gives_the_same_gradients(remat):
    """blocks and dots (and conv_stages, which degrades to blocks with a
    warning) change what is saved, not the arithmetic."""
    x, y = _images(2, seed=9)
    x = torch.from_numpy(x).permute(0, 3, 1, 2)
    grads = []
    for mode in ("none", remat):
        m = ViTModel(**NARROW, compute_dtype=torch.float32, use_flash=True,
                     remat=mode)
        m.init(torch.Generator().manual_seed(4))
        if mode == "conv_stages":
            with pytest.warns(UserWarning, match="degrading"):
                loss = cross_entropy_loss(m(x), torch.from_numpy(y))
        else:
            loss = cross_entropy_loss(m(x), torch.from_numpy(y))
        loss.backward()
        grads.append([p.grad for p in m.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_validation():
    with pytest.raises(ValueError, match="patch_size"):
        ViTModel(image_size=32, patch_size=5)
    with pytest.raises(ValueError, match="num_heads"):
        ViTModel(d_model=30, num_heads=4)
    with pytest.raises(ValueError, match="unknown ViT preset"):
        make_vit("ViT-huge")
    with pytest.raises(ValueError, match="expected 32x32"):
        make_vit("ViT-tiny", **NARROW)(torch.zeros(1, 3, 16, 16))
