"""Asynchronous step dispatch: keep the card's queue full
(tpu_ddp/train/pipeline.py).

PyTorch launches are asynchronous: a train step returns as soon as its
kernels are queued on the stream. A loop that reads every step's loss
before queueing the next (``tensor.tolist()``) drains the queue to empty
once per step, so the host's bookkeeping (the loss print, the guard,
heartbeats, checkpoint cadences) sits on the critical path.

:class:`DispatchPipeline` is a bounded FIFO window of in-flight result
handles. The loop queues up to ``depth`` steps back to back and only
reads a result when its handle is already ready (a non-blocking poll) or
the window is full; then ONE blocking wait covers the whole window, so
the loop pays at most one forced synchronization per ``depth`` steps.
Delivery is strictly in submission order, so every consumer driven from
harvested results sees the same sequence as the synchronous loop, up to
``depth`` steps later. ``depth=0`` is the synchronous loop exactly.

A handle is any nesting (tuple, list, dict) of:

- ``torch.cuda.Event`` (or any object with ``query``/``synchronize``,
  such as a test's fake event): ready when ``query()`` says so. The
  engine records one on the compute stream after each dispatched step,
  beside a pinned host copy of the step's ``[loss, skipped]``, so a
  ready event means the host copy holds the values;
- a CPU tensor (or any other value): ready;
- a CUDA tensor: ready only after a drain, which then synchronizes its
  device.

The forced drain is one ``synchronize()`` on the newest event in the
window. The compute stream runs in order, so that event covers every
older one. Work on other streams is covered too, as long as the compute
stream waited for it before the event was recorded: device prefetch's
copy stream (the step waits on the copy's event, data/prefetch.py) and
the bucketed overlap's collectives (the update waits on their work
handles, parallel/overlap.py) both do.

:class:`StageScheduler` is one such window per pipeline stage for the
MPMD pipeline (parallel/mpmd.py), with each stage's ticks classified
into the 1F1B phases.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable

import torch


def _leaves(value):
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (tuple, list)):
        for v in value:
            yield from _leaves(v)
    else:
        yield value


def _is_event(leaf) -> bool:
    return hasattr(leaf, "query") and hasattr(leaf, "synchronize")


def _handle_ready(value) -> bool:
    """Non-blocking readiness poll over a handle."""
    for leaf in _leaves(value):
        if _is_event(leaf):
            if not leaf.query():
                return False
        elif isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            return False
    return True


def _block(values) -> None:
    """Wait until every handle in ``values`` is ready: one synchronize on
    the newest event (the stream is in order), and the device of any
    CUDA tensor."""
    newest = None
    devices = set()
    for leaf in _leaves(values):
        if _is_event(leaf):
            newest = leaf
        elif isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            devices.add(leaf.device)
    if newest is not None:
        newest.synchronize()
    for dev in devices:
        torch.cuda.synchronize(dev)


class DispatchPipeline:
    """Bounded in-order window of in-flight step results.

    ``submit(value, on_ready)`` enqueues one dispatched step's handle
    with the callback that reads and accounts it. Callbacks fire in
    submission order:

    - opportunistically, whenever the oldest handle polls ready;
    - in a batch, when a submit would leave more than ``depth``
      undelivered handles: one blocking wait over the WHOLE window, then
      every callback (at most one forced sync per ``depth`` steps);
    - immediately, for ``submit(..., sync=True)`` (the timing window)
      and for :meth:`drain` at the epoch's end.

    ``host_gap_ms`` accumulates the wall time spent inside forced waits:
    the part of the epoch where the host had nothing to do but wait for
    the card. At depth > 0 a ``sync=True`` submit is counted under
    ``sync_deliveries`` and adds nothing to ``host_gap_ms`` or
    ``forced_syncs`` (the caller has already waited for that step, as
    the reference's timing protocol does); at depth 0 it stays a forced
    sync, the very cost deeper windows remove.
    """

    def __init__(self, depth: int):
        if depth < 0:
            raise ValueError(f"dispatch depth must be >= 0, got {depth}")
        self.depth = depth
        self._queue: collections.deque = collections.deque()
        self.forced_syncs = 0
        self.sync_deliveries = 0
        self.host_gap_ms = 0.0
        self.harvested = 0
        self.max_in_flight = 0

    def __len__(self) -> int:
        return len(self._queue)

    def submit(self, value: Any, on_ready: Callable[[Any], None],
               sync: bool = False) -> None:
        """Enqueue one handle; may deliver any number of queued results
        (oldest first). ``sync=True`` delivers everything, ``value``
        included, before returning."""
        self._queue.append((value, on_ready))
        if len(self._queue) > self.max_in_flight:
            self.max_in_flight = len(self._queue)
        if sync:
            self._force_drain(forced=self.depth == 0)
            return
        self._poll_ready()
        if len(self._queue) > self.depth:
            self._force_drain()

    def poll(self) -> None:
        """Deliver any already-finished prefix of the window (no wait)."""
        self._poll_ready()

    def drain(self) -> None:
        """Deliver everything still in flight (end of epoch)."""
        if self._queue:
            self._force_drain()

    def stats(self) -> dict:
        return {
            "dispatch_depth": self.depth,
            "forced_syncs": self.forced_syncs,
            "sync_deliveries": self.sync_deliveries,
            "host_gap_ms": round(self.host_gap_ms, 3),
            "harvested": self.harvested,
            "max_in_flight": self.max_in_flight,
        }

    def _poll_ready(self) -> None:
        while self._queue and _handle_ready(self._queue[0][0]):
            self._pop_deliver()

    def _force_drain(self, forced: bool = True) -> None:
        if forced:
            self.forced_syncs += 1
        else:
            self.sync_deliveries += 1
        t0 = time.perf_counter()
        _block([v for v, _ in self._queue])
        if forced:
            self.host_gap_ms += (time.perf_counter() - t0) * 1e3
        while self._queue:
            self._pop_deliver()

    def _pop_deliver(self) -> None:
        value, on_ready = self._queue.popleft()
        self.harvested += 1
        # A raising callback (TrainingDivergedError) propagates to the
        # epoch loop; the handles behind it stay queued and die with the
        # loop: no harvested-results consumer saw their steps.
        on_ready(value)


class StageScheduler:
    """Per-stage dispatch windows and tick accounting for the MPMD
    pipeline (JAX ``StageScheduler``): :class:`DispatchPipeline` with one
    window per stage, so a fast early stage cannot run arbitrarily far
    ahead of a slow late one.

    The MPMD host loop calls :meth:`tick` once per (stage, tick) with
    that tick's validity bits, classified into the 1F1B phases:
    ``warmup`` (forward only, the fill ramp), ``steady`` (both),
    ``cooldown`` (backward only, the drain ramp) and ``idle`` (neither:
    this stage's share of the bubble). A handle given with the tick (a
    CUDA event on the card) bounds that stage's in-flight work through
    its window. :meth:`step_done` is the per-step barrier: every window
    drains, then the heartbeat hook fires (the epoch loop's
    ``touch_heartbeat`` cadence, so the watchdog works on this rung)."""

    PHASES = ("warmup", "steady", "cooldown", "idle")

    def __init__(self, pp_size: int, depth: int = 2,
                 heartbeat: Callable[[int], None] | None = None):
        if pp_size < 1:
            raise ValueError(f"pp_size must be >= 1, got {pp_size}")
        self.pp_size = pp_size
        self.windows = [DispatchPipeline(depth) for _ in range(pp_size)]
        self.heartbeat = heartbeat
        self.phase_counts = [dict.fromkeys(self.PHASES, 0)
                             for _ in range(pp_size)]
        self.ticks = [0] * pp_size
        self.steps = 0

    @staticmethod
    def classify(fwd: bool, bwd: bool) -> str:
        if fwd and bwd:
            return "steady"
        if fwd:
            return "warmup"
        if bwd:
            return "cooldown"
        return "idle"

    def tick(self, stage: int, fwd: bool, bwd: bool, handle=None) -> str:
        phase = self.classify(fwd, bwd)
        self.phase_counts[stage][phase] += 1
        self.ticks[stage] += 1
        if handle is not None:
            self.windows[stage].submit(handle, lambda _v: None)
        return phase

    def step_done(self, step: int) -> None:
        for w in self.windows:
            w.drain()
        self.steps += 1
        if self.heartbeat is not None:
            self.heartbeat(step)

    def bubble_fraction(self, stage: int) -> float:
        """This stage's idle share of its ticks so far."""
        t = self.ticks[stage]
        return self.phase_counts[stage]["idle"] / t if t else 0.0

    def stats(self) -> dict:
        return {
            "pp_size": self.pp_size,
            "steps": self.steps,
            "stages": [
                {"ticks": self.ticks[s],
                 **self.phase_counts[s],
                 "bubble_fraction": round(self.bubble_fraction(s), 4),
                 "window": self.windows[s].stats()}
                for s in range(self.pp_size)
            ],
        }


def depth_sweep(trainer, state, host_batches, depths,
                reps: int = 1, epoch: int = 0) -> tuple[dict, Any]:
    """Streaming-loop throughput and host gap per dispatch depth.

    Runs ``Trainer.train_epoch`` over ``host_batches`` (a list of
    ``(images, labels)`` tuples) once per depth in ``depths`` (``reps``
    times, keeping the best wall time), with the reference's timing
    window off so every iteration after the first may stay in flight.
    Returns ``(results, state)`` with ``results[str(depth)]`` holding
    ``steps_per_sec``, ``host_gap_ms``, ``forced_syncs`` and ``wall_s``.
    """
    cfg = trainer.config
    saved = (cfg.dispatch_depth, cfg.timing_first_iter,
             cfg.timing_last_iter)
    results: dict = {}
    try:
        # Only iteration 0 stays synchronous (the warm-up barrier, the
        # reference's discarded iteration 0).
        cfg.timing_first_iter, cfg.timing_last_iter = 1, 0
        for d in depths:
            cfg.dispatch_depth = int(d)
            best = None
            for _ in range(max(1, reps)):
                t0 = time.perf_counter()
                state, stats = trainer.train_epoch(
                    state, list(host_batches), epoch=epoch,
                    log=lambda s: None)
                wall = time.perf_counter() - t0
                cell = {
                    "steps_per_sec": round(stats["iters"] / wall, 3),
                    "host_gap_ms": stats.get("host_gap_ms", 0.0),
                    "forced_syncs": stats.get("forced_syncs", 0),
                    "wall_s": round(wall, 4),
                }
                if best is None or cell["steps_per_sec"] > \
                        best["steps_per_sec"]:
                    best = cell
            results[str(int(d))] = best
    finally:
        (cfg.dispatch_depth, cfg.timing_first_iter,
         cfg.timing_last_iter) = saved
    return results, state
