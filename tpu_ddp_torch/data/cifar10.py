"""CIFAR-10 dataset: local load + normalization constants.

The port's own copy of tpu_ddp/data/cifar10.py (numpy only): the standard
``cifar-10-batches-py`` pickle format, else a deterministic synthetic
stand-in with the real shapes and dtypes. Arrays stay NHWC uint8 here,
bitwise the JAX package's; the loader (data/loader.py) hands them to
PyTorch as NCHW views.

Where it looks (:func:`search_roots`) is narrower than the JAX package's
list: a root the caller names (``root``, else ``CIFAR10_DIR``), then
``~/data`` and the repo's own ``data/``. Nothing outside those is read,
and a ``cifar-10-python.tar.gz`` is unpacked only into a root the caller
named, so two checkouts never share or write each other's data.

Normalization constants are the reference's (part1/main.py:20-21).
"""

from __future__ import annotations

import os
import pickle
import tarfile
from pathlib import Path

import numpy as np

CIFAR10_MEAN = np.array([125.3, 123.0, 113.9], dtype=np.float32) / 255.0
CIFAR10_STD = np.array([63.0, 62.1, 66.7], dtype=np.float32) / 255.0

_TRAIN_FILES = [f"data_batch_{i}" for i in range(1, 6)]
_TEST_FILES = ["test_batch"]

_REPO_DATA = Path(__file__).resolve().parents[2] / "data"


def search_roots(root: str | None = None) -> list[tuple[str, bool]]:
    """``(directory, named)`` pairs in search order; ``named`` marks a
    root the caller chose, the only kind a tarball is unpacked into."""
    if root:
        return [(root, True)]
    env = os.environ.get("CIFAR10_DIR", "")
    roots = [(env, True)] if env else []
    return roots + [(os.path.expanduser("~/data"), False),
                    (str(_REPO_DATA), False)]


def _find_batches_dir(root: str | None = None):
    for r, named in search_roots(root):
        cand = os.path.join(r, "cifar-10-batches-py")
        if os.path.isdir(cand):
            return cand
        if os.path.isdir(r) and os.path.exists(
                os.path.join(r, "data_batch_1")):
            return r
        tgz = os.path.join(r, "cifar-10-python.tar.gz")
        if named and os.path.isfile(tgz):
            with tarfile.open(tgz) as tf:
                tf.extractall(r, filter="data")
            return cand
    return None


def _load_pickled(batches_dir: str, files):
    images, labels = [], []
    for name in files:
        with open(os.path.join(batches_dir, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        # CHW-flat uint8 -> NHWC uint8 (the JAX package's layout).
        arr = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        images.append(arr)
        labels.append(np.asarray(d[b"labels"], dtype=np.int32))
    return np.concatenate(images), np.concatenate(labels)


def _synthetic(split: str, n: int | None):
    """Deterministic stand-in: same shapes/dtypes/class balance as
    CIFAR-10; images are class-conditional noise so training can reduce
    the loss. ``TPU_DDP_SYNTH_SIZE`` sets ``n`` for both splits."""
    if n is None:
        n = 50_000 if split == "train" else 10_000
        n = int(os.environ.get("TPU_DDP_SYNTH_SIZE", n))
    # Class signatures from a split-independent seed: train and test
    # share them.
    base = np.random.default_rng(0xC1FA8).normal(0, 40, size=(10, 1, 1, 3))
    rng = np.random.default_rng(0xC1FA8 + (1 if split == "train" else 2))
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    images = rng.normal(128, 50, size=(n, 32, 32, 3))
    images = np.clip(images + base[labels], 0, 255).astype(np.uint8)
    return images, labels


def load_cifar10(root: str | None = None, split: str = "train",
                 synthetic_size: int | None = None):
    """Returns ``(images_u8_nhwc, labels_i32, meta)``;
    ``meta["synthetic"]`` tells whether the real dataset was found."""
    batches_dir = _find_batches_dir(root)
    if batches_dir is not None:
        files = _TRAIN_FILES if split == "train" else _TEST_FILES
        images, labels = _load_pickled(batches_dir, files)
        return images, labels, {"synthetic": False, "dir": batches_dir}
    images, labels = _synthetic(split, synthetic_size)
    return images, labels, {"synthetic": True, "dir": None}


def normalize(images_u8: np.ndarray, mean: np.ndarray = CIFAR10_MEAN,
              std: np.ndarray = CIFAR10_STD) -> np.ndarray:
    """uint8 NHWC -> normalized float32 NHWC (ToTensor + Normalize,
    reference part1/main.py:20-31)."""
    x = images_u8.astype(np.float32) / 255.0
    return (x - mean) / std
