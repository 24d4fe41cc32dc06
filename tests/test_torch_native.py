"""The port's native data runtime (tpu_ddp_torch/data/native.py) held to
the JAX package's ctypes binding (tpu_ddp/data/native.py) bit for bit:
the one-shot transform, the threaded loader (its batches as the port's
CPU tensors), the text packer and the loaders that pick it. Both load
the same C++ sources (``native/``); the port builds its own copy into
``tpu_ddp_torch/_build/`` and raises where JAX would fall back.
"""

import numpy as np
import pytest
import torch

from tpu_ddp.data import imagenet as jimagenet
from tpu_ddp.data import loader as jloader
from tpu_ddp.data import native as jnative
from tpu_ddp.data import text as jtext
from tpu_ddp.data.sampler import DistributedShardSampler as JaxSampler
from tpu_ddp_torch.data import imagenet, loader, native, text
from tpu_ddp_torch.data.sampler import DistributedShardSampler

RNG = np.random.default_rng(7)
IMAGES = RNG.integers(0, 256, size=(37, 32, 32, 3), dtype=np.uint8)
LABELS = RNG.integers(0, 10, size=37).astype(np.int32)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("epoch", [0, 3])
def test_transform_batch_is_jax_bits(augment, epoch):
    idx = RNG.permutation(37)[:20]
    for indices in (None, idx):
        got = native.transform_batch(IMAGES, LABELS, indices,
                                     augment=augment, seed=11, epoch=epoch)
        want = jnative.transform_batch(IMAGES, LABELS, indices,
                                       augment=augment, seed=11,
                                       epoch=epoch)
        assert got[0].dtype == np.float32 and got[1].dtype == np.int32
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("world,rank", [(1, 0), (3, 2)])
def test_native_loader_is_jax_bits(world, rank):
    """Batches, ``len`` and ``set_epoch`` as the JAX native loader's, in
    the port's hand-off: (N, C, H, W) channels_last f32, int64 labels."""
    def sampler(cls):
        return (None if world == 1 else
                cls(37, num_replicas=world, rank=rank, shuffle=True))

    got_l = native.NativeDataLoader(IMAGES, LABELS, 8,
                                    sampler=sampler(DistributedShardSampler),
                                    augment=True, seed=5)
    want_l = jnative.NativeDataLoader(IMAGES, LABELS, 8,
                                      sampler=sampler(JaxSampler),
                                      augment=True, seed=5)
    for epoch in (0, 2):
        got_l.set_epoch(epoch)
        want_l.set_epoch(epoch)
        got, want = list(got_l), list(want_l)
        assert len(got) == len(want) == len(got_l) == len(want_l)
        for (x, y), (jx, jy) in zip(got, want):
            assert x.is_contiguous(memory_format=torch.channels_last)
            assert y.dtype == torch.int64
            np.testing.assert_array_equal(_nhwc(x), jx)
            np.testing.assert_array_equal(y.numpy(), jy)


def test_unaugmented_native_loader_is_the_numpy_loaders_within_1e6():
    """C++ normalises with one rounding where numpy takes two: within
    the JAX package's 1e-6 (tests/test_native.py)."""
    got = list(native.NativeDataLoader(IMAGES, LABELS, 16))
    want = list(loader.DataLoader(IMAGES, LABELS, 16))
    for (x, y), (u, v) in zip(got, want):
        np.testing.assert_allclose(x.numpy(), u.numpy(), rtol=0, atol=1e-6)
        assert torch.equal(y, v)


def test_builds_outside_native_and_keys_on_the_source():
    path = native.data_lib.path()
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.name == "_build"
    assert path.name.startswith("tpu_ddp_data-")
    native.data_lib.get()
    assert path.exists()
    assert native.text_lib.path() != path


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: a library that cannot be built raises when asked
    for (JAX's binding falls back to numpy there)."""
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    lib = native.NativeLib("broken.cpp", lambda lib: lib)
    with pytest.raises(native.NativeBuildError, match="broken.cpp"):
        lib.get()


@pytest.mark.parametrize("add_bos", [True, False])
def test_text_packer_is_jax_native_rows(add_bos):
    docs = ["the quick brown fox", b"\x00\xffraw", "héllo"] * 9
    got = text.pack_documents(docs, 16, add_bos=add_bos, use_native=True)
    want = jtext.pack_documents(docs, 16, add_bos=add_bos, use_native=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, text.pack_documents(docs, 16, add_bos=add_bos))


def test_loaders_pick_native_as_jax_does(monkeypatch):
    """``native=True`` and ``TPU_DDP_NATIVE_LOADER=1`` pick the C++ loader
    for CIFAR-10's train and test splits (JAX's rule); shard_eval keeps
    the numpy loader with weight triples for the test split."""
    monkeypatch.delenv("TPU_DDP_NATIVE_LOADER", raising=False)
    for kw in ({"native": True}, {}):
        if not kw:
            monkeypatch.setenv("TPU_DDP_NATIVE_LOADER", "1")
        tr, te = loader.create_data_loaders(batch_size=8, synthetic_size=40,
                                            **kw)
        jtr, jte = jloader.create_data_loaders(batch_size=8,
                                               synthetic_size=40, **kw)
        assert type(tr) is type(te) is native.NativeDataLoader
        assert type(jtr).__name__ == type(jte).__name__ == \
            "NativeDataLoader"
        for (x, y), (jx, jy) in zip(tr, jtr):
            np.testing.assert_array_equal(_nhwc(x), jx)
    tr, te = loader.create_data_loaders(rank=1, world_size=2, batch_size=4,
                                        synthetic_size=40, shard_eval=True)
    assert type(te) is loader.DataLoader and te.with_weights
    monkeypatch.setenv("TPU_DDP_NATIVE_LOADER", "maybe")
    with pytest.raises(ValueError, match="TPU_DDP_NATIVE_LOADER"):
        loader.create_data_loaders(batch_size=8, synthetic_size=40)


def test_imagenet_native_loader_is_jax_bits(monkeypatch):
    monkeypatch.delenv("IMAGENET_DIR", raising=False)
    kw = dict(batch_size=4, synthetic_size=10, image_size=16,
              num_classes=7, native=True)
    train, test = imagenet.create_imagenet_loaders(**kw)
    jtrain, jtest = jimagenet.create_imagenet_loaders(**kw)
    assert type(train) is native.NativeDataLoader
    for got_l, want_l in ((train, jtrain), (test, jtest)):
        got, want = list(got_l), list(want_l)
        assert len(got) == len(want) > 0
        for (x, y), (jx, jy) in zip(got, want):
            np.testing.assert_array_equal(_nhwc(x), jx)
            np.testing.assert_array_equal(y.numpy(), jy)
