"""Checkpoint and resume (tpu_ddp/utils/checkpoint.py), in the JAX
package's on-disk format, so a checkpoint moves between the two packages
in both directions:

- A checkpoint is a directory ``step_{N:08d}/`` holding one
  ``arrays.npz`` (every leaf of the state tree) and ``manifest.json``
  (``format_version`` 1, ``step``, the leaf keys in order and a sha256
  digest per leaf). No pickle.
- A leaf's key is ``f"{i:05d}:" + path``, with ``i`` its index in JAX's
  pytree order (dict keys sorted, tuples by index) and ``path`` JAX's
  ``keystr(simple=True, separator=".")`` (``utils/tree.py:keyed_leaves``).
- Writes are atomic: a ``.tmp-*`` staging directory is renamed into
  place only when complete, so a cut write is never taken for a
  checkpoint (:func:`all_steps` sees only ``step_N`` directories with a
  manifest).
- Restore maps the saved leaves into a caller's template tree and
  returns numpy arrays; the trainer places them on its device.
- State is replicated under data parallelism, so only rank 0 writes
  (the trainers gate on it); every rank restores.
- ``keep_last`` prunes old step directories after a successful write.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import shutil
import tempfile
import threading
import weakref

import numpy as np
import torch

from tpu_ddp_torch.utils.tree import keyed_leaves, keyed_unflatten

_STEP_RE = re.compile(r"^step_(\d{8,})$")
_FORMAT_VERSION = 1


def _leaf_key(i: int, path: str) -> str:
    # Human-readable but unambiguous: "00003:params.features.0.kernel".
    return f"{i:05d}:{path}"


def _host_array(leaf, copy: bool = False) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu")
        if copy and t.data_ptr() == leaf.data_ptr():
            t = t.clone()
        return t.numpy()
    return np.array(leaf, copy=True) if copy else np.asarray(leaf)


def save_checkpoint(directory: str, state, step: int,
                    keep_last: int | None = None) -> str:
    """Write ``state`` (a tree of dicts, tuples and arrays or tensors) as
    step ``step``; returns the checkpoint's path. Atomic."""
    from tpu_ddp_torch.resilience.integrity import leaf_digest
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    arrays = {_leaf_key(i, path): _host_array(leaf)
              for i, (path, leaf) in enumerate(keyed_leaves(state))}
    tmp = tempfile.mkdtemp(prefix=".tmp-", dir=directory)
    try:
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            np.savez(f, **arrays)
        manifest = {
            "format_version": _FORMAT_VERSION,
            "step": step,
            "leaves": list(arrays.keys()),
            # Re-hashed on restore (resilience/integrity.py), so a cut
            # file or a flipped bit is caught before training resumes.
            "digests": {k: leaf_digest(v) for k, v in arrays.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.isdir(final):
            shutil.rmtree(final)  # re-saving the same step overwrites
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if keep_last is not None:
        for step_i in all_steps(directory)[:-keep_last]:
            shutil.rmtree(os.path.join(directory, f"step_{step_i:08d}"),
                          ignore_errors=True)
    return final


class AsyncCheckpointWriter:
    """Checkpoint writes on a background thread, so the train loop does
    not wait on serialization and disk.

    - ``submit`` copies the tree to host memory before it returns (device
      tensors with ``.cpu()``, host arrays copied), so the caller may
      update the state in place at once; the write and the atomic rename
      run on the writer thread. It returns the path the checkpoint will
      occupy.
    - At most one write is in flight: ``submit`` first joins the previous
      one (ordered checkpoints, one extra state copy in host memory).
    - A failed write re-raises from the next ``submit`` or ``wait``.
    - ``wait()`` blocks until the write in flight is on disk. Live
      writers are drained at interpreter exit.
    """

    _live: "weakref.WeakSet[AsyncCheckpointWriter]" = weakref.WeakSet()
    _atexit_registered = False

    @classmethod
    def _drain_all(cls):
        first_error = None
        for writer in list(cls._live):
            try:
                writer.wait()
            except BaseException as e:  # noqa: BLE001 - re-raised below
                if first_error is None:
                    first_error = e
        if first_error is not None:
            raise first_error

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        AsyncCheckpointWriter._live.add(self)
        if not AsyncCheckpointWriter._atexit_registered:
            AsyncCheckpointWriter._atexit_registered = True
            atexit.register(AsyncCheckpointWriter._drain_all)

    def submit(self, directory: str, state, step: int,
               keep_last: int | None = None) -> str:
        self.wait()
        host = keyed_unflatten(state, [_host_array(leaf, copy=True)
                                       for _, leaf in keyed_leaves(state)])

        def write():
            try:
                save_checkpoint(directory, host, step, keep_last=keep_last)
            except BaseException as e:  # noqa: BLE001 - re-raised at join
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True,
                                        name=f"ckpt-write-{step}")
        self._thread.start()
        return os.path.join(directory, f"step_{step:08d}")

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("background checkpoint write failed") \
                from err


def all_steps(directory: str) -> list[int]:
    """Completed checkpoint steps in ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name,
                                             "manifest.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> int | None:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, template, step: int | None = None,
                       verify: bool = True, drop_extra: tuple = ()):
    """Restore into the structure of ``template`` (a tree whose leaves
    have a ``.shape``: arrays, tensors or :func:`shape_leaf`s); returns
    ``(state, step)`` with numpy leaves. ``step=None`` picks the latest.

    Every leaf is digest-checked as it is read (``verify=False`` skips,
    e.g. after ``verify_checkpoint``). Damage (an unreadable or cut
    archive, a digest mismatch) raises ``CheckpointCorruptError``; a
    checkpoint of another model raises ``ValueError`` (leaf count or
    shape) or ``KeyError`` (leaf path).

    ``drop_extra`` names top-level path prefixes whose saved leaves are
    ignored; the remaining ones must then match the template path by
    path.
    """
    from tpu_ddp_torch.resilience.integrity import (CheckpointCorruptError,
                                                    leaf_digest)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory!r}")
    path = os.path.join(directory, f"step_{step:08d}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"unreadable manifest in checkpoint {path!r}: {e}",
            path=path) from e
    if manifest["format_version"] != _FORMAT_VERSION:
        raise ValueError(f"checkpoint format {manifest['format_version']} "
                         f"!= {_FORMAT_VERSION}")
    digests = manifest.get("digests") if verify else None
    npz_path = os.path.join(path, "arrays.npz")
    try:
        npz_cm = np.load(npz_path)
    except Exception as e:  # zipfile.BadZipFile, OSError, ...
        raise CheckpointCorruptError(
            f"unreadable checkpoint arrays {npz_path!r}: "
            f"{type(e).__name__}: {e}", path=path) from e
    with npz_cm as npz:
        paths_and_leaves = keyed_leaves(template)
        saved_keys = None
        if drop_extra:
            def _dropped(key: str) -> bool:
                leaf_path = key.split(":", 1)[1]
                return any(leaf_path == p or leaf_path.startswith(p + ".")
                           for p in drop_extra)
            saved_keys = [k for k in manifest["leaves"] if not _dropped(k)]
            if len(paths_and_leaves) != len(saved_keys):
                raise ValueError(
                    f"checkpoint has {len(saved_keys)} leaves after "
                    f"dropping {drop_extra}, template has "
                    f"{len(paths_and_leaves)} - structures differ")
        elif len(paths_and_leaves) != len(manifest["leaves"]):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, "
                f"template has {len(paths_and_leaves)} - structures differ")
        restored = []
        for i, (tree_path, leaf) in enumerate(paths_and_leaves):
            if saved_keys is not None:
                key = saved_keys[i]
                if key.split(":", 1)[1] != tree_path:
                    raise KeyError(
                        f"leaf {tree_path!r} of the template aligns to "
                        f"saved leaf {key!r} - structure mismatch")
            else:
                key = _leaf_key(i, tree_path)
            if key not in npz:
                raise KeyError(
                    f"leaf {key!r} missing from checkpoint {path!r} "
                    f"(saved: {manifest['leaves'][i]!r}) - structure "
                    f"mismatch")
            try:
                arr = npz[key]
            except Exception as e:  # a cut member: zlib.error, ...
                raise CheckpointCorruptError(
                    f"leaf {key!r} of {npz_path!r} failed to read: "
                    f"{type(e).__name__}: {e} - checkpoint is cut or "
                    f"corrupt", path=path) from e
            if digests is not None and key in digests \
                    and leaf_digest(arr) != digests[key]:
                raise CheckpointCorruptError(
                    f"digest mismatch on leaf {key!r} of {npz_path!r} - "
                    f"checkpoint is corrupt", path=path)
            want = tuple(np.shape(leaf))
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"leaf {key!r}: checkpoint shape {arr.shape} != "
                    f"template shape {want}")
            restored.append(arr)
    return keyed_unflatten(template, restored), manifest["step"]


def shape_leaf(shape, dtype=np.float32) -> np.ndarray:
    """A template leaf of ``shape`` that holds no memory (a zero-stride
    view of one element), for :func:`restore_checkpoint`."""
    return np.broadcast_to(np.zeros((), dtype), tuple(shape))
