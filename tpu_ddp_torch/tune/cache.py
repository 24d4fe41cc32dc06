"""The persistent tuning cache: one JSON file per workload fingerprint
(the port's copy of tpu_ddp/tune/cache.py: the same schema, store and
quarantine).

Entries live under ``~/.cache/tpu_ddp_torch/tune/`` (override with
``TPU_DDP_TUNE_CACHE_DIR``) as ``<fingerprint-key>.json``; the JAX
package's entries, under ``~/.cache/tpu_ddp/tune/``, are never read.
Every load is verified — the same paranoia as checkpoint restore
(``resilience/integrity.py``): a tuning that silently applied to the
wrong workload would be worse than no tuning, because it would look like
a measurement. The policy per failure class:

- unreadable / non-JSON / wrong shape → quarantine to ``*.corrupt``
  (``.corrupt-2``… if taken; never silently deleted);
- stored fingerprint != the caller's fingerprint (hash collision or a
  hand-edited file) → quarantine — the entry is actively wrong;
- override keys that are not registry fields → quarantine — the knob
  space the entry was tuned for no longer exists in this form;
- ``schema_version`` mismatch → plain miss, NO quarantine: an old
  schema is not corruption, and the next ``store`` overwrites it.

Writes are atomic (tmp file + ``os.replace``) so a killed search never
leaves a truncated entry for the next run to trip over.
"""

from __future__ import annotations

import json
import os
import tempfile
import warnings

from tpu_ddp_torch.tune.space import Fingerprint, knob_by_field

__all__ = ["SCHEMA_VERSION", "cache_dir", "entry_path", "store", "load",
           "quarantine"]

SCHEMA_VERSION = 1


def cache_dir() -> str:
    env = os.environ.get("TPU_DDP_TUNE_CACHE_DIR")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "tpu_ddp_torch", "tune")


def entry_path(fp: Fingerprint, directory: str | None = None) -> str:
    return os.path.join(directory or cache_dir(), f"{fp.key()}.json")


def quarantine(path: str) -> str | None:
    """Rename a bad entry to ``path.corrupt`` (``.corrupt-2``… if
    taken); returns the new path, or None when a concurrent process won
    the rename race. Mirrors ``integrity.quarantine_checkpoint``."""
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


def store(fp: Fingerprint, overrides: dict, *, directory: str | None = None,
          meta: dict | None = None) -> str:
    """Persist ``overrides`` (TrainConfig field -> tuned value) for
    ``fp``; returns the entry path. ``meta`` (trial counts, measured
    steps/sec, wall time) is carried verbatim for provenance."""
    directory = directory or cache_dir()
    os.makedirs(directory, exist_ok=True)
    path = entry_path(fp, directory)
    payload = {
        "schema_version": SCHEMA_VERSION,
        "fingerprint": fp.asdict(),
        "overrides": overrides,
        "meta": meta or {},
    }
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load(fp: Fingerprint, *, directory: str | None = None) -> dict | None:
    """The verified entry for ``fp`` — ``{"overrides": ..., "meta": ...,
    "path": ...}`` — or None on any miss (absent, old schema, or a
    quarantined failure; a warning names which)."""
    path = entry_path(fp, directory)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            payload = json.load(f)
        if not isinstance(payload, dict):
            raise ValueError(f"entry is {type(payload).__name__}, "
                             "expected an object")
    except (OSError, ValueError) as e:
        moved = quarantine(path)
        warnings.warn(f"[autotune] corrupt cache entry {path}: {e}; "
                      f"quarantined to {moved}", stacklevel=2)
        return None

    if payload.get("schema_version") != SCHEMA_VERSION:
        # Old-schema entries are stale, not corrupt: miss without drama,
        # and the next search's store() overwrites in place.
        return None

    stored_fp = payload.get("fingerprint")
    if stored_fp != fp.asdict():
        moved = quarantine(path)
        warnings.warn(
            f"[autotune] cache entry {path} carries a different "
            f"fingerprint than its key (stored {stored_fp!r}); "
            f"quarantined to {moved}", stacklevel=2)
        return None

    overrides = payload.get("overrides")
    if not isinstance(overrides, dict) or any(
            knob_by_field(k) is None for k in overrides):
        moved = quarantine(path)
        unknown = [k for k in (overrides or {}) if knob_by_field(k) is None]
        warnings.warn(
            f"[autotune] cache entry {path} has override keys outside "
            f"the knob registry {unknown!r}; quarantined to {moved}",
            stacklevel=2)
        return None

    return {"overrides": overrides, "meta": payload.get("meta", {}),
            "path": path}
