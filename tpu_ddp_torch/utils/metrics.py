"""In-memory metrics: the counters, gauges and event records of
tpu_ddp/utils/metrics.py's ``MetricsLogger`` that the serving engine and
the trainer use (no JSONL sink yet)."""

from __future__ import annotations


class MetricsLogger:
    """Event counters (:meth:`inc`), gauge accumulators (:meth:`observe`)
    and event records (:meth:`log`), queryable after a run."""

    def __init__(self):
        self.counters: dict[str, int] = {}
        self.gauges: dict[str, dict] = {}
        self.events: list[dict] = []

    def log(self, event: str, **fields) -> None:
        """Record one event (``train_iter``, ``epoch``, ``eval``)."""
        self.events.append({"event": event, **fields})

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
