"""The image model zoo's registry (tpu_ddp/models/__init__.py): the VGG
family, ResNet-50 and the two ViT presets under the JAX names. The
TransformerLM presets are built with ``models/transformer.py:
make_transformer``."""

from __future__ import annotations

import functools


def _factories() -> dict:
    from tpu_ddp_torch.models.resnet import resnet50
    from tpu_ddp_torch.models.vgg import vgg11, vgg13, vgg16, vgg19
    from tpu_ddp_torch.models.vit import make_vit
    return {"VGG11": vgg11, "VGG13": vgg13, "VGG16": vgg16, "VGG19": vgg19,
            "ResNet50": resnet50,
            "ViT-tiny": functools.partial(make_vit, "ViT-tiny"),
            "ViT-S16": functools.partial(make_vit, "ViT-S16")}


def get_model(name: str, **kwargs):
    """Build a model by name (e.g. ``get_model("ResNet50",
    num_classes=1000)``)."""
    factories = _factories()
    if name not in factories:
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{sorted(factories)}")
    return factories[name](**kwargs)
