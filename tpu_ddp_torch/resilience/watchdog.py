"""Heartbeat watchdog (tpu_ddp/resilience/watchdog.py): detect a hung
cluster, not just a dead one.

A rank that dies is the easy case: the launcher sees its exit code and
reaps the others. A rank that hangs (a deadlocked collective, stuck I/O)
leaves every other rank blocked in the next collective until the overall
timeout. So every worker writes a per-rank file
(``TPU_DDP_HEARTBEAT_DIR/hb_rank{R}``) once per step, and the launcher
polls the directory: a rank whose heartbeat is older than the deadline is
reported by :meth:`HeartbeatMonitor.stalled_ranks`, and the launcher
kills the cluster and restarts it. Files and mtimes survive a worker
wedged inside a C++ collective, which cannot answer anything else.

Grace: until the first heartbeat appears the watchdog stays silent
(start-up and the first kernel builds can exceed the deadline); a rank
that has never beaten is measured from the cluster's first beat.
:meth:`HeartbeatMonitor.reset_grace` gives every rank a fresh deadline:
the elastic launcher calls it after a membership epoch, when the
survivors paused beating to meet again and rebuild. Its stall check
covers the live members only (``stalled_ranks(ranks=...)``), so a
departed worker's stale file does not trip it. Pure host code.
"""

from __future__ import annotations

import os
import time

HEARTBEAT_ENV = "TPU_DDP_HEARTBEAT_DIR"

# Exit code the launcher reports for a cluster the watchdog killed:
# distinct from FAULT_EXIT_CODE (13) and from -9 (a rank killed as a
# bystander of another rank's failure).
STALL_EXIT_CODE = 14


def heartbeat_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"hb_rank{rank}")


def touch_heartbeat(directory: str, rank: int, step: int) -> None:
    """One beat: write the current step to this rank's heartbeat file
    (the watchdog reads only the mtime; the step is for a post-mortem)."""
    try:
        with open(heartbeat_path(directory, rank), "w") as f:
            f.write(f"{step}\n")
    except OSError:
        pass  # a failing heartbeat must never kill a healthy step


def heartbeat_from_env(rank: int | None = None):
    """``(directory, rank)`` when the launcher armed the watchdog, else
    None. ``rank`` defaults to this process's ``torch.distributed``
    rank."""
    directory = os.environ.get(HEARTBEAT_ENV)
    if not directory:
        return None
    if rank is None:
        from tpu_ddp_torch.resilience.chaos import process_rank
        rank = process_rank()
    return directory, rank


class HeartbeatMonitor:
    """Launcher-side stall detector over a heartbeat directory:
    :meth:`stalled_ranks` names every rank silent for longer than
    ``timeout``; :meth:`stalled` is its boolean summary."""

    def __init__(self, directory: str, nproc: int, timeout: float):
        if timeout <= 0:
            raise ValueError(f"timeout must be > 0, got {timeout}")
        self.directory = directory
        self.nproc = nproc
        self.timeout = timeout
        self._grace: float | None = None

    def beats(self) -> dict:
        """{rank: mtime} for every rank with a heartbeat file."""
        out = {}
        for rank in range(self.nproc):
            try:
                out[rank] = os.path.getmtime(
                    heartbeat_path(self.directory, rank))
            except OSError:
                continue
        return out

    def reset_grace(self, now: float | None = None) -> None:
        """Give every rank a fresh ``timeout`` before it can stall."""
        self._grace = time.time() if now is None else now

    def stalled_ranks(self, now: float | None = None, ranks=None) -> list:
        """Ranks silent for more than ``timeout``, ascending; none before
        the first beat (or grace reset), a rank that never beat counts
        from the earliest of them, and no beat counts from before the
        last grace reset. ``ranks`` limits the check (the elastic
        launcher's live workers)."""
        beats = self.beats()
        if not beats and self._grace is None:
            return []  # grace: nobody has ever beaten
        now = time.time() if now is None else now
        anchors = list(beats.values())
        if self._grace is not None:
            anchors.append(self._grace)
        first = min(anchors)
        out = []
        for rank in (range(self.nproc) if ranks is None else ranks):
            beat = beats.get(rank, first)
            if self._grace is not None:
                beat = max(beat, self._grace)
            if now - beat > self.timeout:
                out.append(rank)
        return sorted(out)

    def stalled(self, now: float | None = None) -> bool:
        return bool(self.stalled_ranks(now))
