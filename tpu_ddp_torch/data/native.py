"""ctypes bindings of the repo's C++ data runtime (tpu_ddp/data/native.py):
``native/tpu_ddp_data.cpp`` (crop/flip/normalize on worker threads) and
``native/tpu_ddp_text.cpp`` (document packing, data/text.py).

- :func:`transform_batch`: one-shot augment+normalize of a batch in C++;
  without augmentation it equals ``data/cifar10.py:normalize``.
- :class:`NativeDataLoader`: the drop-in for ``data/loader.py``'s
  ``DataLoader`` (the same ``set_epoch``, ``__len__`` and ``__iter__``
  contract and the same CPU tensors, (N, C, H, W) channels_last f32
  images and int64 labels), with its batches made by C++ threads into a
  bounded queue, so augmentation overlaps the card's step. Its
  augmentation draws are counter-based (seed, epoch, example), the JAX
  package's native draws, not the numpy loader's generator.

Each library is built with ``g++`` from ``native/<name>.cpp`` into
``tpu_ddp_torch/_build/`` under a name keyed on a hash of the source and
the flags (``native/`` is never written). A library that cannot be
built raises when it is asked for; nothing falls back to numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np
import torch

from tpu_ddp_torch.data.cifar10 import CIFAR10_MEAN, CIFAR10_STD
from tpu_ddp_torch.utils.config import SEED

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


class NativeBuildError(RuntimeError):
    """A native library was asked for and could not be built or
    loaded."""


class NativeLib:
    """Build-once, load-once handle of one ``native/`` source."""

    def __init__(self, source: str, bind):
        self.source = source
        self._bind = bind
        self._lib = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        text = (NATIVE_DIR / self.source).read_bytes()
        key = hashlib.sha256(text + "\0".join(CXX_FLAGS).encode())
        return BUILD_DIR / f"{Path(self.source).stem}-" \
                           f"{key.hexdigest()[:16]}.so"

    def _build(self) -> Path:
        out = self.path()
        if out.exists():
            return out
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if not cxx:
            raise NativeBuildError(f"no C++ compiler (g++ or $CXX) to "
                                   f"build native/{self.source}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [cxx, *CXX_FLAGS, "-o", tmp, str(NATIVE_DIR / self.source)],
                capture_output=True, text=True, timeout=300, check=False)
            if proc.returncode != 0:
                raise NativeBuildError(
                    f"{cxx} failed on native/{self.source} (exit "
                    f"{proc.returncode}): {proc.stderr[-800:]}")
            os.replace(tmp, out)  # atomic: a reader never sees half a file
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return out

    def get(self):
        """The loaded library, built on first use; raises
        :class:`NativeBuildError` when it cannot be."""
        with self._lock:
            if self._lib is None:
                path = self._build()
                try:
                    self._lib = self._bind(ctypes.CDLL(str(path)))
                except OSError as e:
                    raise NativeBuildError(f"cannot load {path}: {e}") \
                        from e
            return self._lib


def _bind_data(lib):
    lib.tpu_ddp_transform_batch.argtypes = [
        _u8p, _i32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, _f32p, _f32p,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64, _f32p, _i32p]
    lib.tpu_ddp_transform_batch.restype = None
    lib.tpu_ddp_loader_create.argtypes = [
        _u8p, _i32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _i64p, ctypes.c_int64, ctypes.c_int, _f32p, _f32p,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int]
    lib.tpu_ddp_loader_create.restype = ctypes.c_void_p
    lib.tpu_ddp_loader_next.argtypes = [ctypes.c_void_p, _f32p, _i32p]
    lib.tpu_ddp_loader_next.restype = ctypes.c_int
    lib.tpu_ddp_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.tpu_ddp_loader_destroy.restype = None
    lib.tpu_ddp_version.restype = ctypes.c_int
    return lib


def _bind_text(lib):
    lib.tpu_ddp_text_stream_len.argtypes = [_i64p, ctypes.c_int64,
                                            ctypes.c_int]
    lib.tpu_ddp_text_stream_len.restype = ctypes.c_int64
    lib.tpu_ddp_text_pack.argtypes = [
        _u8p, _i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        _i32p, ctypes.c_int64]
    lib.tpu_ddp_text_pack.restype = ctypes.c_int64
    return lib


data_lib = NativeLib("tpu_ddp_data.cpp", _bind_data)
text_lib = NativeLib("tpu_ddp_text.cpp", _bind_text)


def transform_batch(images_u8, labels, indices=None, *, augment=False,
                    seed: int = SEED, epoch: int = 0,
                    mean=CIFAR10_MEAN, std=CIFAR10_STD):
    """Augment+normalize ``images_u8[indices]`` (uint8 NHWC) in C++;
    returns numpy ``(f32 NHWC images, int32 labels)``."""
    lib = data_lib.get()
    images_u8 = np.ascontiguousarray(images_u8, dtype=np.uint8)
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    n, h, w, c = images_u8.shape
    if indices is None:
        idx_ptr, n_out = None, n
    else:
        indices = np.ascontiguousarray(indices, dtype=np.int64)
        idx_ptr = indices.ctypes.data_as(ctypes.c_void_p)
        n_out = len(indices)
    out_x = np.empty((n_out, h, w, c), np.float32)
    out_y = np.empty((n_out,), np.int32)
    lib.tpu_ddp_transform_batch(
        images_u8, labels, n, h, w, c, idx_ptr, n_out,
        np.ascontiguousarray(mean, np.float32),
        np.ascontiguousarray(std, np.float32),
        int(augment), seed, epoch, out_x, out_y)
    return out_x, out_y


class NativeDataLoader:
    """C++-prefetched drop-in for ``data/loader.py:DataLoader``: the same
    constructor surface and iteration contract. ``num_threads`` and
    ``prefetch_depth`` mirror the reference DataLoader's ``num_workers=2``
    and its two batches per worker."""

    def __init__(self, images_u8, labels, batch_size, sampler=None,
                 augment=False, seed: int = SEED, num_threads: int = 2,
                 prefetch_depth: int = 4, mean=CIFAR10_MEAN,
                 std=CIFAR10_STD):
        self.images_u8 = np.ascontiguousarray(images_u8, dtype=np.uint8)
        self.labels = np.ascontiguousarray(labels, dtype=np.int32)
        self.batch_size = batch_size
        self.sampler = sampler
        self.augment = augment
        self.seed = seed
        self.epoch = 0
        self.num_threads = num_threads
        self.prefetch_depth = prefetch_depth
        self.mean = np.ascontiguousarray(mean, np.float32)
        self.std = np.ascontiguousarray(std, np.float32)
        data_lib.get()  # raises here, not mid-epoch, when unbuildable

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def _order(self) -> np.ndarray:
        if self.sampler is not None:
            return np.ascontiguousarray(self.sampler.indices(), np.int64)
        return np.arange(len(self.labels), dtype=np.int64)

    def __len__(self) -> int:
        n = len(self.sampler) if self.sampler is not None \
            else len(self.labels)
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        lib = data_lib.get()
        order = self._order()
        n, h, w, c = self.images_u8.shape
        handle = lib.tpu_ddp_loader_create(
            self.images_u8, self.labels, n, h, w, c, order, len(order),
            self.batch_size, self.mean, self.std, int(self.augment),
            self.seed, self.epoch, self.num_threads, self.prefetch_depth)
        if not handle:
            raise RuntimeError("tpu_ddp_loader_create failed")
        out_x = np.empty((self.batch_size, h, w, c), np.float32)
        out_y = np.empty((self.batch_size,), np.int32)
        try:
            while True:
                got = lib.tpu_ddp_loader_next(handle, out_x, out_y)
                if got < 0:
                    break
                # Copies: the queue's buffer is reused next iteration.
                x = torch.from_numpy(out_x[:got].copy())
                yield (x.permute(0, 3, 1, 2),
                       torch.from_numpy(out_y[:got].astype(np.int64)))
        finally:
            lib.tpu_ddp_loader_destroy(handle)


def pack_text(data: np.ndarray, offsets: np.ndarray, n_docs: int,
              row_len: int, add_bos: bool) -> np.ndarray:
    """The C++ packer: documents ``data[offsets[d]:offsets[d + 1]]`` (raw
    bytes) into (N, row_len) int32 rows (data/text.py:pack_documents)."""
    lib = text_lib.get()
    stream = lib.tpu_ddp_text_stream_len(offsets, n_docs, int(add_bos))
    n_rows = stream // row_len
    if n_rows == 0:
        raise ValueError(f"documents too short: {stream} tokens < one "
                         f"row of {row_len}")
    out = np.empty((n_rows, row_len), np.int32)
    got = lib.tpu_ddp_text_pack(np.ascontiguousarray(data), offsets,
                                n_docs, row_len, int(add_bos), out, n_rows)
    if got < 0:
        raise RuntimeError(f"tpu_ddp_text_pack error {got}")
    return out[:got]
