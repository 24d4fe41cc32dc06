"""Checkpoint integrity (tpu_ddp/resilience/integrity.py): per-leaf
digests, verification, quarantine.

A checkpoint that exists is not a checkpoint that restores: a preempted
host can leave a truncated ``arrays.npz`` behind a completed rename, and
disks rot. Three layers of defence, with the JAX package's definitions so
a checkpoint written by either package verifies in the other:

- :func:`leaf_digest`: sha256 over a leaf's raw C-contiguous bytes,
  stored per leaf in ``manifest.json`` at save time
  (``utils/checkpoint.py``).
- :func:`verify_checkpoint`: re-reads every leaf and compares digests;
  raises :class:`CheckpointCorruptError` naming the first bad leaf. A
  manifest without digests verifies vacuously.
- :func:`quarantine_checkpoint`: renames a failed ``step_N`` to
  ``step_N.corrupt``, so the restore never retries it and a human can
  look at it; corrupt data is never deleted.

:func:`restore_newest_verified` composes them into the restore policy of
both trainers: newest checkpoint first, quarantine and try the previous
one until one verifies.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed to read back or failed digest verification.
    ``path`` names the checkpoint, so the fallback can quarantine it."""

    def __init__(self, message: str, path: str | None = None):
        super().__init__(message)
        self.path = path


def leaf_digest(arr) -> str:
    """sha256 hex over the leaf's raw bytes in C-contiguous layout: two
    arrays with equal digests are bitwise equal. (Hashes the buffer in
    place; the bytes, and so the digest, are those of ``tobytes()``.)"""
    a = np.ascontiguousarray(np.asarray(arr))
    return hashlib.sha256(a.reshape(-1).view(np.uint8)).hexdigest()


def verify_checkpoint(path: str) -> int:
    """Verify every leaf of the checkpoint at ``path`` against its
    manifest digest; returns the number of leaves verified (0 for a
    manifest without digests). Raises :class:`CheckpointCorruptError` on
    an unreadable or truncated file or any digest mismatch."""
    manifest_path = os.path.join(path, "manifest.json")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"unreadable manifest {manifest_path!r}: {e}", path=path) from e
    digests = manifest.get("digests")
    if not digests:
        return 0
    npz_path = os.path.join(path, "arrays.npz")
    checked = 0
    try:
        with np.load(npz_path) as npz:
            for key, want in digests.items():
                if key not in npz:
                    raise CheckpointCorruptError(
                        f"leaf {key!r} missing from {npz_path!r}",
                        path=path)
                got = leaf_digest(npz[key])
                if got != want:
                    raise CheckpointCorruptError(
                        f"digest mismatch on leaf {key!r} of "
                        f"{npz_path!r}: manifest {want[:12]}..., file "
                        f"{got[:12]}... - checkpoint is corrupt",
                        path=path)
                checked += 1
    except CheckpointCorruptError:
        raise
    except Exception as e:  # zipfile.BadZipFile, zlib.error, OSError, ...
        raise CheckpointCorruptError(
            f"unreadable checkpoint arrays {npz_path!r}: "
            f"{type(e).__name__}: {e}", path=path) from e
    return checked


def quarantine_checkpoint(path: str) -> str | None:
    """Rename ``step_N`` -> ``step_N.corrupt`` (``.corrupt-2``, ... if
    taken). Returns the new path, or None if another process moved it
    first (every rank restores, so ranks race benignly)."""
    target = path + ".corrupt"
    n = 1
    while os.path.exists(target):
        n += 1
        target = f"{path}.corrupt-{n}"
    try:
        os.rename(path, target)
    except OSError:
        return None
    return target


def restore_newest_verified(directory: str, template, log=print,
                            drop_extra: tuple = ()) -> tuple:
    """Restore the newest checkpoint that passes digest verification;
    returns ``(state, step)`` like ``utils.checkpoint.restore_checkpoint``.
    A checkpoint that fails is quarantined and the previous one tried.
    Raises :class:`CheckpointCorruptError` when every checkpoint is
    corrupt and ``FileNotFoundError`` when there is none."""
    from tpu_ddp_torch.utils import checkpoint as ckpt
    steps = ckpt.all_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory!r}")
    last_error: CheckpointCorruptError | None = None
    for step in reversed(steps):
        path = os.path.join(directory, f"step_{step:08d}")
        try:
            verify_checkpoint(path)
            # Every leaf was just hashed: do not pay for it twice.
            return ckpt.restore_checkpoint(directory, template, step,
                                           verify=False,
                                           drop_extra=drop_extra)
        except CheckpointCorruptError as e:
            last_error = e
            q = quarantine_checkpoint(path)
            log(f"[ckpt] step {step} failed verification ({e}); "
                f"quarantined to {q or '<already moved>'}, trying the "
                f"previous checkpoint")
    raise CheckpointCorruptError(
        f"every checkpoint under {directory!r} failed verification "
        f"(last error: {last_error})", path=directory)
