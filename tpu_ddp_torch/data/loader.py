"""Batched data loader over numpy arrays + the create_data_loaders facade.

The port's copy of tpu_ddp/data/loader.py: the same sampler, the same
per-(seed, epoch) augmentation draws and the same normalization, so every
batch holds bitwise the JAX loader's values. The difference is the
hand-off: batches are CPU tensors, images (N, C, H, W) float32 and labels
int64. The images tensor is a free NCHW view of the NHWC array, so its
memory is already ``torch.channels_last``, the layout the VGG model keeps;
the trainer moves batches to its device. ``native=True`` (or
``TPU_DDP_NATIVE_LOADER``) swaps in the C++ loader (data/native.py), and
``shard_eval`` shards the test set by rank with weight triples for
``Trainer.evaluate(sharded=True)``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_ddp_torch.data.augment import random_crop_flip
from tpu_ddp_torch.data.cifar10 import (CIFAR10_MEAN, CIFAR10_STD,
                                        load_cifar10, normalize)
from tpu_ddp_torch.data.sampler import DistributedShardSampler
from tpu_ddp_torch.utils.config import SEED


class DataLoader:
    """Iterates ``(images, labels)`` batches; augmentation is seeded per
    (seed, epoch), so every run and every replica is deterministic. Call
    :meth:`set_epoch` like the reference's ``sampler.set_epoch(epoch)``
    (part2/part2b/main.py:189)."""

    def __init__(
        self,
        images_u8: np.ndarray,
        labels: np.ndarray,
        batch_size: int,
        sampler: DistributedShardSampler | None = None,
        augment: bool = False,
        seed: int = SEED,
        mean: np.ndarray = CIFAR10_MEAN,
        std: np.ndarray = CIFAR10_STD,
        with_weights: bool = False,
    ):
        self.images_u8 = images_u8
        self.labels = np.asarray(labels, dtype=np.int32)
        self.batch_size = batch_size
        self.sampler = sampler
        self.augment = augment
        self.seed = seed
        self.epoch = 0
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        # True -> yield (images, labels, weights) triples, weight 0 on
        # the sampler's wrap-padding rows (the process-sharded eval
        # contract: each example counted once over the group).
        self.with_weights = with_weights

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.sampler) if self.sampler is not None \
            else len(self.labels)
        # drop_last=False (reference part1/main.py:36-41): the final short
        # batch is kept.
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        if self.sampler is not None:
            idx, valid = self.sampler.indices_and_valid()
        else:
            idx = np.arange(len(self.labels))
            valid = np.ones(len(idx), bool)
        rng = np.random.default_rng((self.seed, self.epoch))
        for start in range(0, len(idx), self.batch_size):
            sel = idx[start:start + self.batch_size]
            imgs = self.images_u8[sel]
            if self.augment:
                imgs = random_crop_flip(imgs, rng)
            # C-ordered NHWC (a no-op except for batches gathered from the
            # transposed on-disk arrays), so the NCHW view is channels_last.
            x = torch.from_numpy(np.ascontiguousarray(
                normalize(imgs, self.mean, self.std)))
            batch = (x.permute(0, 3, 1, 2),
                     torch.from_numpy(self.labels[sel].astype(np.int64)))
            if self.with_weights:
                batch += (torch.from_numpy(
                    valid[start:start + self.batch_size]
                    .astype(np.float32)),)
            yield batch


def pick_loader_cls(native: bool | None):
    """``DataLoader``, or the C++ ``NativeDataLoader`` when ``native`` (or,
    when it is None, ``TPU_DDP_NATIVE_LOADER``) asks for it. The native
    class raises at construction when its library cannot be built."""
    if native is None:
        from tpu_ddp_torch.utils.config import _env_bool
        native = _env_bool("TPU_DDP_NATIVE_LOADER", False)
    if native:
        from tpu_ddp_torch.data.native import NativeDataLoader
        return NativeDataLoader
    return DataLoader


def create_data_loaders(
    rank: int = 0,
    world_size: int = 1,
    batch_size: int = 256,
    root: str | None = None,
    seed: int = SEED,
    synthetic_size: int | None = None,
    native: bool | None = None,
    shard_eval: bool = False,
):
    """(train_loader, test_loader), the reference's L4 facade.

    ``batch_size`` is the PER-NODE batch (``int(256/world_size)``,
    part2/part2b/main.py:177). Train is sharded by rank with
    DistributedSampler semantics (``shuffle=False, drop_last=False``);
    test is unsharded, so every node evaluates the full set
    (part2/part2b/main.py:89-93), unless ``shard_eval`` at a world above
    one shards it by rank too, yielding (images, labels, weights)
    triples (wrap-padding rows weight 0) on the numpy loader. ``native``:
    see :func:`pick_loader_cls`.
    """
    train_x, train_y, meta = load_cifar10(root, "train", synthetic_size)
    test_x, test_y, _ = load_cifar10(
        root, "test",
        None if synthetic_size is None else max(synthetic_size // 5, 10))
    if meta["synthetic"]:
        print("[tpu_ddp_torch.data] CIFAR-10 not found on disk -> "
              "deterministic synthetic stand-in (set CIFAR10_DIR to use "
              "the real data)")
    sampler = None
    if world_size > 1:
        sampler = DistributedShardSampler(
            len(train_y), num_replicas=world_size, rank=rank,
            shuffle=False, drop_last=False)
    loader_cls = pick_loader_cls(native)
    train_loader = loader_cls(train_x, train_y, batch_size,
                              sampler=sampler, augment=True, seed=seed)
    if shard_eval and world_size > 1:
        # Weights ride only the numpy loader (eval is unaugmented, and
        # the native loader's threads buy nothing there), as in JAX.
        test_loader = DataLoader(
            test_x, test_y, batch_size,
            sampler=DistributedShardSampler(
                len(test_y), num_replicas=world_size, rank=rank,
                shuffle=False, drop_last=False),
            augment=False, with_weights=True)
    else:
        test_loader = loader_cls(test_x, test_y, batch_size,
                                 augment=False)
    return train_loader, test_loader
