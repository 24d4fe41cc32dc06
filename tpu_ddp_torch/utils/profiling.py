"""Profiler integration (tpu_ddp/utils/profiling.py) through
``torch.profiler``: :func:`profile_trace` records the host and the
card's kernels for the length of a ``with`` block and writes a Chrome
trace (viewable in Perfetto or ``chrome://tracing``) into a directory;
:func:`annotate` names a region on that timeline. ``TPU_DDP_PROFILE_DIR``
turns tracing on for the CLI's first epoch (parts/common.py).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def profile_trace(logdir: str | None = None):
    """Trace the ``with`` block into ``logdir/trace_<pid>_<ns>.json``;
    a no-op when ``logdir`` is falsy. The card's activity is recorded
    when CUDA is available."""
    if not logdir:
        yield
        return
    os.makedirs(logdir, exist_ok=True)
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A named region on the trace timeline (host, and the kernels it
    launches)."""
    return torch.profiler.record_function(name)


def profile_dir_from_env() -> str | None:
    return os.environ.get("TPU_DDP_PROFILE_DIR") or None
