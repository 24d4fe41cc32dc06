"""The port's ImageNet data path (tpu_ddp_torch/data/imagenet.py) against
the JAX package's (tpu_ddp/data/imagenet.py): the synthetic stand-in's
bytes from the same seeds, the loaders' batches after augmentation and
normalisation bit for bit (the port's images are NCHW views of the same
NHWC values), real numpy shards read from ``IMAGENET_DIR``, and the
normalisation constants."""

import numpy as np
import pytest

from tpu_ddp.data import normalization_constants as jax_constants
from tpu_ddp.data import imagenet as jax_imagenet
from tpu_ddp_torch.data import imagenet, normalization_constants

SIZE, IMAGE = 24, 40


@pytest.mark.parametrize("split", ["train", "val"])
def test_synthetic_split_is_jax_bytes(split, monkeypatch):
    monkeypatch.delenv("IMAGENET_DIR", raising=False)
    got = imagenet.load_imagenet(split=split, synthetic_size=SIZE,
                                 image_size=IMAGE, num_classes=30)
    want = jax_imagenet.load_imagenet(split=split, synthetic_size=SIZE,
                                      image_size=IMAGE, num_classes=30)
    assert got[2] == want[2] == {"synthetic": True, "dir": None}
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # TPU_DDP_SYNTH_SIZE sizes it as in JAX (val: a quarter, at least 8).
    monkeypatch.setenv("TPU_DDP_SYNTH_SIZE", "20")
    n = len(imagenet.load_imagenet(split=split, image_size=8)[1])
    assert n == len(jax_imagenet.load_imagenet(split=split,
                                               image_size=8)[1])
    assert n == (20 if split == "train" else 8)


@pytest.mark.parametrize("world,rank", [(1, 0), (2, 1)])
def test_loader_batches_are_jax_values(world, rank, monkeypatch):
    monkeypatch.delenv("IMAGENET_DIR", raising=False)
    kw = dict(rank=rank, world_size=world, batch_size=5, seed=7,
              synthetic_size=SIZE, image_size=IMAGE, num_classes=30)
    train, test = imagenet.create_imagenet_loaders(**kw)
    jtrain, jtest = jax_imagenet.create_imagenet_loaders(native=False, **kw)
    for loader, jloader in ((train, jtrain), (test, jtest)):
        for epoch in (0, 1):
            loader.set_epoch(epoch)
            jloader.set_epoch(epoch)
            got, want = list(loader), list(jloader)
            assert len(got) == len(want) == len(loader)
            for (x, y), (jx, jy) in zip(got, want):
                assert x.shape[1] == 3 and x.dtype.is_floating_point
                np.testing.assert_array_equal(
                    x.permute(0, 2, 3, 1).numpy(), jx)
                np.testing.assert_array_equal(y.numpy(), jy)


def test_real_shards_and_constants(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    for split, n in (("train", 6), ("val", 3)):
        np.save(tmp_path / f"{split}_images.npy",
                rng.integers(0, 256, size=(n, 16, 16, 3), dtype=np.uint8))
        np.save(tmp_path / f"{split}_labels.npy",
                rng.integers(0, 10, size=n))
    monkeypatch.setenv("IMAGENET_DIR", str(tmp_path))
    x, y, meta = imagenet.load_imagenet(split="val")
    jx, jy, _ = jax_imagenet.load_imagenet(split="val")
    assert meta == {"synthetic": False, "dir": str(tmp_path)}
    assert np.array_equal(x, jx) and np.array_equal(y, jy)
    train, _ = imagenet.create_imagenet_loaders(batch_size=4)
    assert [tuple(b[0].shape) for b in train] == [(4, 3, 16, 16),
                                                   (2, 3, 16, 16)]
    for name in ("cifar10", "imagenet"):
        for a, b in zip(normalization_constants(name), jax_constants(name)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match="unknown dataset"):
        normalization_constants("mnist")
    # Memory-mapped real shards keep the numpy loader under native=True
    # (the native one would copy the whole split), as in JAX.
    ntrain, _ = imagenet.create_imagenet_loaders(batch_size=4, native=True)
    jtrain, _ = jax_imagenet.create_imagenet_loaders(batch_size=4,
                                                     native=True)
    assert type(ntrain).__name__ == type(jtrain).__name__ == "DataLoader"
