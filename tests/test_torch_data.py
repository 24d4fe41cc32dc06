"""The port's data pipeline (tpu_ddp_torch/data/) against the JAX
package's (tpu_ddp/data/): sampler indices, augmentation and loader
batches must be bitwise equal for the same seed, epoch, rank and world —
the port's images are the JAX NHWC arrays transposed to NCHW views."""

import pickle
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_ddp.data import augment as jaug
from tpu_ddp.data import loader as jloader
from tpu_ddp.data import sampler as jsampler
from tpu_ddp_torch.data import augment as taug
from tpu_ddp_torch.data import cifar10 as tcifar
from tpu_ddp_torch.data import loader as tloader
from tpu_ddp_torch.data import sampler as tsampler


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("n,shuffle", [(50, False), (53, False),
                                       (53, True)])
def test_sampler_indices_match(world, n, shuffle):
    for rank in range(world):
        kw = dict(num_replicas=world, rank=rank, shuffle=shuffle, seed=5)
        a = jsampler.DistributedShardSampler(n, **kw)
        b = tsampler.DistributedShardSampler(n, **kw)
        for epoch in (0, 3):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            ia, va = a.indices_and_valid()
            ib, vb = b.indices_and_valid()
            np.testing.assert_array_equal(ia, ib)
            np.testing.assert_array_equal(va, vb)
            assert len(a) == len(b)


def test_augmentation_matches():
    imgs = np.random.default_rng(0).integers(
        0, 256, size=(9, 32, 32, 3)).astype(np.uint8)
    a = jaug.random_crop_flip(imgs, np.random.default_rng((1, 2)))
    b = taug.random_crop_flip(imgs, np.random.default_rng((1, 2)))
    np.testing.assert_array_equal(a, b)


def _same_batches(jl, tl, epoch):
    jl.set_epoch(epoch)
    tl.set_epoch(epoch)
    assert len(jl) == len(tl)
    n = 0
    for (jx, jy), (tx, ty) in zip(jl, tl):
        assert tx.dtype == torch.float32 and ty.dtype == torch.int64
        assert tx.device.type == "cpu"
        assert tx.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_array_equal(tx.permute(0, 2, 3, 1).numpy(), jx)
        np.testing.assert_array_equal(ty.numpy(), jy)
        n += 1
    assert n == len(tl)


@pytest.mark.parametrize("world", [1, 2])
def test_synthetic_loaders_match(world):
    for rank in range(world):
        kw = dict(rank=rank, world_size=world, batch_size=16, seed=89395,
                  synthetic_size=70)
        jtr, jte = jloader.create_data_loaders(native=False, **kw)
        ttr, tte = tloader.create_data_loaders(**kw)
        for epoch in (0, 1):
            _same_batches(jtr, ttr, epoch)
        _same_batches(jte, tte, 0)


def test_synthetic_size_env_applies_to_both(monkeypatch):
    monkeypatch.setenv("TPU_DDP_SYNTH_SIZE", "40")
    jtr, jte = jloader.create_data_loaders(batch_size=16, native=False)
    ttr, tte = tloader.create_data_loaders(batch_size=16)
    _same_batches(jtr, ttr, 0)
    _same_batches(jte, tte, 0)
    assert len(ttr) == len(tte) == 3


def test_on_disk_batches_match(tmp_path):
    """The real-data path: pickled CIFAR-10 batch files (here small fake
    ones in the standard format) load identically."""
    _write_batches(tmp_path / "cifar-10-batches-py",
                   np.random.default_rng(3))
    kw = dict(rank=1, world_size=2, batch_size=4, root=str(tmp_path))
    jtr, jte = jloader.create_data_loaders(native=False, **kw)
    ttr, tte = tloader.create_data_loaders(**kw)
    _same_batches(jtr, ttr, 0)
    _same_batches(jte, tte, 0)
    assert tte.images_u8.shape == (7, 32, 32, 3)


def test_search_roots_stay_inside_the_checkout(monkeypatch, tmp_path):
    """Only a named root, ``~/data`` and the repo's ``data/`` are read:
    no root above the working directory, no system-wide path."""
    monkeypatch.delenv("CIFAR10_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    repo_data = str(Path(tcifar.__file__).resolve().parents[2] / "data")
    assert tcifar.search_roots() == [(str(tmp_path / "data"), False),
                                     (repo_data, False)]
    monkeypatch.setenv("CIFAR10_DIR", "/named")
    assert tcifar.search_roots()[0] == ("/named", True)
    assert tcifar.search_roots("/given") == [("/given", True)]


def _write_batches(d, rng, n=7):
    d.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        blob = {b"data": rng.integers(0, 256, size=(n, 3072)).astype(
            np.uint8), b"labels": rng.integers(0, 10, size=n).tolist()}
        with open(d / name, "wb") as f:
            pickle.dump(blob, f)


@pytest.mark.parametrize("named", [True, False])
def test_tarball_unpacked_only_into_a_named_root(named, monkeypatch,
                                                 tmp_path):
    src = tmp_path / "src"
    _write_batches(src / "cifar-10-batches-py", np.random.default_rng(4))
    home = tmp_path / "home"
    (home / "data").mkdir(parents=True)
    with tarfile.open(home / "data" / "cifar-10-python.tar.gz",
                      "w:gz") as tf:
        tf.add(src / "cifar-10-batches-py", arcname="cifar-10-batches-py")
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.delenv("CIFAR10_DIR", raising=False)
    monkeypatch.setenv("TPU_DDP_SYNTH_SIZE", "20")
    if named:
        monkeypatch.setenv("CIFAR10_DIR", str(home / "data"))
    images, _, meta = tcifar.load_cifar10(split="test")
    assert meta["synthetic"] is not named
    assert (home / "data" / "cifar-10-batches-py").exists() is named
    assert images.shape == ((7 if named else 20), 32, 32, 3)
