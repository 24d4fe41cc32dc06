"""The port's FLOP counts (tpu_ddp_torch/utils/flops.py) equal the JAX
package's (tpu_ddp/utils/flops.py) integer for integer, on the port's
models: VGG-11, ResNet-50 at 224 and at CIFAR size (small inputs),
ViT-tiny and ViT-S16, and the LM; training is 3x the forward."""

import jax.numpy as jnp
import pytest

from tpu_ddp.models.vit import make_vit as jax_make_vit
from tpu_ddp.utils import flops as jax_flops
from tpu_ddp_torch.models.resnet import RESNET_CFG
from tpu_ddp_torch.models.vgg import VGG_CFG
from tpu_ddp_torch.models.vit import make_vit
from tpu_ddp_torch.utils import flops


def test_vgg11():
    got = flops.vgg_fwd_flops(VGG_CFG["VGG11"], 32, 256)
    assert got == jax_flops.vgg_fwd_flops(VGG_CFG["VGG11"], 32, 256)
    assert flops.train_flops(got) == jax_flops.train_flops(got) == 3 * got


@pytest.mark.parametrize("image_size,small,per_image", [
    (224, False, 8_178_368_512), (32, True, None), (32, False, None)])
def test_resnet50(image_size, small, per_image):
    args = (RESNET_CFG["ResNet50"], image_size, 256)
    kw = dict(num_classes=1000 if image_size == 224 else 10,
              small_inputs=small)
    got = flops.resnet_fwd_flops(*args, **kw)
    assert got == jax_flops.resnet_fwd_flops(*args, **kw)
    if per_image is not None:
        assert got == 256 * per_image
        # A training step at batch 256: 6.28 TFLOP.
        assert flops.train_flops(got) == 6_280_987_017_216


@pytest.mark.parametrize("name,per_image", [("ViT-tiny", None),
                                            ("ViT-S16", 9_148_053_504)])
def test_vit(name, per_image):
    got = flops.vit_fwd_flops(make_vit(name), 8)
    assert got == jax_flops.vit_fwd_flops(
        jax_make_vit(name, compute_dtype=jnp.float32), 8)
    if per_image is not None:
        assert got == 8 * per_image
