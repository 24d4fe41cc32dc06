"""ImageNet-1k data path (tpu_ddp/data/imagenet.py), the ResNet-50 /
ImageNet scale-up's data.

The port's own copy: real ImageNet is read from ``IMAGENET_DIR`` (or
``root``), a directory of pre-converted numpy shards
(``{split}_images.npy`` uint8 NHWC and ``{split}_labels.npy``);
otherwise a deterministic class-conditional synthetic stand-in with
ImageNet's shapes, drawn from the same seeds as the JAX package's, so
the same call gives the same bytes. ``TPU_DDP_SYNTH_SIZE`` sizes it as
there. The loaders are the port's ``DataLoader`` (or, with ``native``,
its C++ ``NativeDataLoader``) with ImageNet's normalisation and the
same augmentation draws as the JAX package's.
"""

from __future__ import annotations

import os

import numpy as np

from tpu_ddp_torch.utils.config import SEED

# torchvision's canonical ImageNet normalization constants.
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

_DEFAULT_SYNTH = {"train": 2048, "val": 512}


def _synthetic(split: str, n: int | None, image_size: int,
               num_classes: int):
    if n is None:
        env = os.environ.get("TPU_DDP_SYNTH_SIZE")
        if env is not None:
            n = int(env) if split == "train" else max(int(env) // 4, 8)
        else:
            n = _DEFAULT_SYNTH["train" if split == "train" else "val"]
    # Class signatures from a split-independent seed, shared by train and
    # val, so the val split is learnable from the train split.
    base = np.random.default_rng(0x1A46E7).normal(
        0, 30, size=(num_classes, 1, 1, 3))
    rng = np.random.default_rng(0x1A46E7 + (1 if split == "train" else 2))
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    images = rng.normal(118, 55, size=(n, image_size, image_size, 3))
    # In place: the same sums as the JAX package's, one f64 array.
    images += base[labels]
    return np.clip(images, 0, 255, out=images).astype(np.uint8), labels


def load_imagenet(root: str | None = None, split: str = "train",
                  synthetic_size: int | None = None, image_size: int = 224,
                  num_classes: int = 1000):
    """Returns ``(images_u8_nhwc, labels_i32, meta)``."""
    root = root or os.environ.get("IMAGENET_DIR")
    if root:
        xp = os.path.join(root, f"{split}_images.npy")
        yp = os.path.join(root, f"{split}_labels.npy")
        if os.path.exists(xp) and os.path.exists(yp):
            return (np.load(xp, mmap_mode="r"),
                    np.load(yp).astype(np.int32),
                    {"synthetic": False, "dir": root})
    images, labels = _synthetic(split, synthetic_size, image_size,
                                num_classes)
    return images, labels, {"synthetic": True, "dir": None}


def create_imagenet_loaders(
    rank: int = 0,
    world_size: int = 1,
    batch_size: int = 256,
    root: str | None = None,
    seed: int = SEED,
    synthetic_size: int | None = None,
    image_size: int = 224,
    num_classes: int = 1000,
    native: bool | None = None,
):
    """(train_loader, test_loader) with the CIFAR facade's contract
    (data/loader.py): per-node batch in, train sharded by rank, val
    unsharded. ``native`` (or, when None, ``TPU_DDP_NATIVE_LOADER``)
    picks the C++ loader, except over memory-mapped real shards, which
    it would copy whole into memory (the JAX package's rule)."""
    from tpu_ddp_torch.data.loader import DataLoader, pick_loader_cls
    from tpu_ddp_torch.data.sampler import DistributedShardSampler

    train_x, train_y, meta_tr = load_imagenet(
        root, "train", synthetic_size, image_size, num_classes)
    test_x, test_y, meta_va = load_imagenet(
        root, "val",
        None if synthetic_size is None else max(synthetic_size // 4, 8),
        image_size, num_classes)
    for split, meta in (("train", meta_tr), ("val", meta_va)):
        if meta["synthetic"]:
            print(f"[tpu_ddp_torch.data] ImageNet {split} split not found "
                  "-> deterministic synthetic stand-in (set IMAGENET_DIR "
                  "to use real shards)")
    sampler = None
    if world_size > 1:
        sampler = DistributedShardSampler(
            len(train_y), num_replicas=world_size, rank=rank,
            shuffle=False, drop_last=False)
    cls = pick_loader_cls(native)
    if isinstance(train_x, np.memmap) and cls is not DataLoader:
        print("[tpu_ddp_torch.data] real ImageNet shards are memory-mapped"
              " -> numpy loader (the native loader would copy the full "
              "split)")
        cls = DataLoader
    train = cls(train_x, train_y, batch_size, sampler=sampler,
                augment=True, seed=seed, mean=IMAGENET_MEAN,
                std=IMAGENET_STD)
    test = cls(test_x, test_y, batch_size, augment=False,
               mean=IMAGENET_MEAN, std=IMAGENET_STD)
    return train, test
