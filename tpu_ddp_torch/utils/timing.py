"""Per-iteration timing harness — the reference's primary metric
(tpu_ddp/utils/timing.py ``IterationTimer``; reference
part1/main.py:66,86-91): wall time of each iteration from
``time.perf_counter_ns()``, iterations 1..39 accumulated (iteration 0
discarded as warm-up), total and average printed at iteration 39.

PyTorch returns before the card finishes, so on a CUDA device
:meth:`IterationTimer.stop` calls ``torch.cuda.synchronize(device)``
before it reads the clock for an iteration it counts, as the JAX loop
blocks on the step's outputs there. Iterations outside the window are
not synchronized: the async dispatch window (train/pipeline.py) keeps
them in flight.

:func:`timed_window_s` / :func:`warm_then_median_s` are the JAX
package's shared warm-up + timed-window loop: warm calls first, then
back-to-back calls with ONE sync at the window's edge, so the number
prices the work, not per-call host round trips. Their default sync on a
value holding CUDA tensors is ``torch.cuda.synchronize(device)``.
"""

from __future__ import annotations

import dataclasses
import time

import torch


def _cuda_devices(value) -> set:
    """The CUDA devices of the tensors in ``value`` (nested tuples,
    lists and dicts)."""
    if isinstance(value, torch.Tensor):
        return {value.device} if value.device.type == "cuda" else set()
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (tuple, list)):
        out = set()
        for v in value:
            out |= _cuda_devices(v)
        return out
    return set()


def _default_sync(value) -> None:
    """Wait for the card(s) that hold ``value``'s tensors; a value
    without CUDA tensors (None, host numbers, CPU tensors) is ready."""
    for dev in _cuda_devices(value):
        torch.cuda.synchronize(dev)


def timed_window_s(run, iters: int, sync=None) -> float:
    """Average wall seconds per call over ONE window of ``iters``
    back-to-back ``run()`` calls, with ``sync`` (default: synchronize
    the devices of the returned tensors) applied to the LAST call's
    return value before the clock stops. The caller warms up first; see
    :func:`warm_then_median_s`."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    sync = sync or _default_sync
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = run()
    sync(out)
    return (time.perf_counter() - t0) / iters


def warm_then_median_s(run, iters: int, windows: int = 1,
                       warmup: int = 1, sync=None) -> tuple[float, list]:
    """``warmup`` discarded calls (builds, cuDNN's choices, the first
    execution), then ``windows`` timed windows of ``iters`` calls each;
    returns ``(median avg-s/call, all window samples)``."""
    sync = sync or _default_sync
    out = None
    for _ in range(max(0, warmup)):
        out = run()
    sync(out)
    samples = [timed_window_s(run, iters, sync=sync)
               for _ in range(max(1, windows))]
    ordered = sorted(samples)
    mid = len(ordered) // 2
    median = (ordered[mid] if len(ordered) % 2
              else 0.5 * (ordered[mid - 1] + ordered[mid]))
    return median, samples


@dataclasses.dataclass
class IterationTimer:
    """Accumulates ns over iterations [first_iter, last_iter]."""

    first_iter: int = 1
    last_iter: int = 39
    device: torch.device | str | None = None
    total_ns: int = 0
    count: int = 0
    _t0: int = 0

    def start(self):
        self._t0 = time.perf_counter_ns()

    def _sync(self) -> None:
        if self.device is not None and torch.device(self.device).type \
                == "cuda":
            torch.cuda.synchronize(self.device)

    def _counts(self, first: int, k: int) -> bool:
        return first <= self.last_iter and first + k - 1 >= self.first_iter

    def stop(self, iteration: int) -> int:
        """Record iteration's elapsed ns; returns the elapsed ns."""
        if self._counts(iteration, 1):
            self._sync()
        elapsed = time.perf_counter_ns() - self._t0
        if self.first_iter <= iteration <= self.last_iter:
            self.total_ns += elapsed
            self.count += 1
        return elapsed

    def stop_many(self, first_iteration: int, k: int) -> int:
        """Attribute the elapsed time since :meth:`start` evenly to
        iterations [first_iteration, first_iteration + k): the
        K-steps-per-dispatch case (``Trainer.build_multi_step``), where
        the host sees no boundary between the K iterations."""
        if self._counts(first_iteration, k):
            self._sync()
        elapsed = time.perf_counter_ns() - self._t0
        share = elapsed // max(k, 1)
        for it in range(first_iteration, first_iteration + k):
            if self.first_iter <= it <= self.last_iter:
                self.total_ns += share
                self.count += 1
        return elapsed

    @property
    def average_ns(self) -> float:
        return self.total_ns / self.count if self.count else 0.0

    @property
    def average_s(self) -> float:
        return self.average_ns / 1e9

    def report(self, prefix: str = "") -> str:
        """The reference prints total + average ns after iteration 39
        (part1/main.py:86-91); same payload here."""
        return (f"{prefix}timing over iterations "
                f"{self.first_iter}-{self.last_iter}: total {self.total_ns} ns, "
                f"average {self.average_ns:.0f} ns "
                f"({self.average_s:.4f} s/iter)")
