"""Structured metrics (tpu_ddp/utils/metrics.py): event counters,
gauges, event records and the JSONL sink.

:class:`MetricsLogger` keeps every event in memory (``events``, the
port's addition, queryable after a run) and, with a ``path``, appends
one JSON object per event to that file, line-buffered, in the JAX
package's schema::

    {"ts": 1722..., "rank": 0, "event": "train_iter", "step": 40,
     "loss": 1.93}

``from_env`` reads ``TPU_DDP_METRICS_FILE`` (``{rank}`` expands to the
process's rank), as the JAX CLI does.
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    """Event counters (:meth:`inc`), gauge accumulators (:meth:`observe`)
    and event records (:meth:`log`); ``path=None`` writes no file."""

    def __init__(self, path: str | None = None, rank: int = 0):
        self.path = path
        self.rank = rank
        self.counters: dict[str, int] = {}
        self.gauges: dict[str, dict] = {}
        self.events: list[dict] = []
        self._fh = None
        if path:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            self._fh = open(path, "a", buffering=1)  # line-buffered

    @property
    def enabled(self) -> bool:
        """True while a JSONL file is open."""
        return self._fh is not None

    def log(self, event: str, **fields) -> None:
        """Record one event (``train_iter``, ``epoch``, ``eval``, ...) and
        write its line when the sink is open."""
        self.events.append({"event": event, **fields})
        if self._fh is None:
            return
        rec = {"ts": round(time.time(), 3), "rank": self.rank,
               "event": event}
        rec.update(fields)
        self._fh.write(json.dumps(rec) + "\n")

    def inc(self, name: str, n: int = 1) -> int:
        """Bump (and return) a counter."""
        self.counters[name] = self.counters.get(name, 0) + n
        return self.counters[name]

    def observe(self, name: str, value: float) -> None:
        """Accumulate one gauge sample: count/total/max/last."""
        g = self.gauges.setdefault(
            name, {"count": 0, "total": 0.0, "max": 0.0, "last": 0.0})
        v = float(value)
        g["count"] += 1
        g["total"] += v
        g["max"] = max(g["max"], v)
        g["last"] = v

    def gauge_summary(self, name: str) -> dict | None:
        """count/total/max/last/mean for one observed gauge, or None."""
        g = self.gauges.get(name)
        if g is None:
            return None
        return {**g, "mean": g["total"] / max(g["count"], 1)}

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def from_env(rank: int = 0) -> MetricsLogger:
    """A logger writing to ``TPU_DDP_METRICS_FILE`` (``{rank}``
    expands), or to no file when it is unset."""
    path = os.environ.get("TPU_DDP_METRICS_FILE")
    if path:
        path = path.replace("{rank}", str(rank))
    return MetricsLogger(path, rank=rank)
