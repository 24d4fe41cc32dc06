"""Per-iteration timing harness — the reference's primary metric
(tpu_ddp/utils/timing.py ``IterationTimer``; reference
part1/main.py:66,86-91): wall time of each iteration from
``time.perf_counter_ns()``, iterations 1..39 accumulated (iteration 0
discarded as warm-up), total and average printed at iteration 39.

PyTorch returns before the card finishes, so on a CUDA device :meth:`stop`
calls ``torch.cuda.synchronize(device)`` before it reads the clock, as the
JAX loop blocks on the step's outputs.
"""

from __future__ import annotations

import dataclasses
import time

import torch


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

    def stop(self, iteration: int) -> int:
        """Record iteration's elapsed ns; returns the elapsed ns."""
        if self.device is not None and torch.device(self.device).type \
                == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter_ns() - self._t0
        if self.first_iter <= iteration <= self.last_iter:
            self.total_ns += elapsed
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
