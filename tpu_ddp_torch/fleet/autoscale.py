"""Autoscaling replica lifecycle (tpu_ddp/fleet/autoscale.py): the
control plane over the Router.

An :class:`Autoscaler` watches the Router's backlog and walks replicas
through scale-up (boot from ``engine_factory``, join) and scale-down
(drain, migrate, retire):

- **Scale-up** builds a replica with the factory and joins it to the
  fleet; it serves the factory's weights (version 0). Booting from the
  weight publisher's full push is ROADMAP Queue 1 item 11b: a
  ``publisher`` raises until then.
- **Scale-down** retires the least-loaded healthy replica through the
  Router's graceful drain: every unfinished stream replays elsewhere as a
  ``continuation_of`` (the same tokens, none dropped, no retry-budget
  shed), then the replica is removed.
- **Hysteresis and cooldown.** Scaling needs ``hold_steps`` consecutive
  observations past a threshold (separate up and down thresholds form
  the band) and ``cooldown_ms`` since the last action
  (``TPU_DDP_SCALE_COOLDOWN_MS``), so a one-step spike buys nothing.
- **Unhealthy replicas do not count.** The load signal is backlog per
  healthy replica.

The Autoscaler has the engine drive surface (``submit`` / ``cancel`` /
``step`` / ``run`` / ``outstanding`` / ``accounting_ok``), so
``loadgen.run_load`` and ``run_trace`` drive an autoscaling fleet as they
drive one engine; ``set_clock`` takes ``run_trace``'s virtual clock.
"""

from __future__ import annotations

import time


class Autoscaler:
    """Replica-count controller over one :class:`Router`.
    ``engine_factory`` returns a fresh, empty replica of the fleet's
    model and cache geometry."""

    def __init__(self, router, engine_factory, publisher=None, *,
                 min_replicas: int = 1, max_replicas: int = 4,
                 up_tokens_per_replica: float = 256.0,
                 down_tokens_per_replica: float = 32.0,
                 hold_steps: int = 3, cooldown_ms: float | None = None,
                 enabled: bool | None = None, clock=time.monotonic,
                 config=None):
        if publisher is not None:
            raise NotImplementedError(
                "Autoscaler(publisher=...): booting replicas from the "
                "weight publisher (tpu_ddp/publish/) is not ported to "
                "tpu_ddp_torch yet (ROADMAP Queue 1 item 11b)")
        if config is None:
            from tpu_ddp_torch.utils.config import TrainConfig
            config = TrainConfig()
        self.router = router
        self.factory = engine_factory
        self.publisher = None
        self.enabled = bool(enabled if enabled is not None
                            else config.fleet_autoscale)
        self.cooldown_ms = float(cooldown_ms if cooldown_ms is not None
                                 else config.scale_cooldown_ms)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.up_tokens = float(up_tokens_per_replica)
        self.down_tokens = float(down_tokens_per_replica)
        self.hold_steps = int(hold_steps)
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if not self.down_tokens < self.up_tokens:
            raise ValueError(
                "down_tokens_per_replica must be < up_tokens_per_replica "
                "(the gap IS the hysteresis band)")
        if self.hold_steps < 1:
            raise ValueError("hold_steps must be >= 1")
        if self.cooldown_ms <= 0:
            raise ValueError("cooldown_ms must be > 0")
        self._clock = clock
        self._last_action_at = None   # no cooldown before the first act
        self._up_streak = 0
        self._down_streak = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.migrated_on_drain = 0
        self.boot_s: list[float] = []
        self.events: list[dict] = []
        self._rs_integral = 0.0
        self._rs_last = self._clock()

    # ---- load signal ---------------------------------------------------

    def _healthy(self) -> list[int]:
        return [i for i in range(len(self.router.replicas))
                if self.router.health[i].healthy]

    def capacity(self) -> int:
        """Replicas that count: the healthy ones."""
        return len(self._healthy())

    def load_per_replica(self) -> float:
        """Fleet backlog over healthy capacity."""
        return self.router.outstanding() / max(1, self.capacity())

    # ---- the control loop ----------------------------------------------

    def step(self) -> bool:
        """One fleet step and one controller tick."""
        worked = bool(self.router.step())
        self._tick()
        return worked

    def run(self, max_steps: int | None = None) -> int:
        n = 0
        while max_steps is None or n < max_steps:
            if not self.step():
                break
            n += 1
        return n

    def _tick(self) -> None:
        now = self._clock()
        self._rs_integral += self.capacity() * (now - self._rs_last)
        self._rs_last = now
        if not self.enabled:
            return
        load = self.load_per_replica()
        if load > self.up_tokens:
            self._up_streak += 1
            self._down_streak = 0
        elif load < self.down_tokens:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = self._down_streak = 0
        if self._last_action_at is not None and \
                (now - self._last_action_at) * 1e3 < self.cooldown_ms:
            return
        if self._up_streak >= self.hold_steps \
                and len(self.router.replicas) < self.max_replicas:
            self.scale_up()
        elif self._down_streak >= self.hold_steps \
                and self.capacity() > self.min_replicas \
                and len(self.router.replicas) > self.min_replicas:
            self.scale_down()

    def _acted(self, action: str, **detail) -> None:
        self._last_action_at = self._clock()
        self._up_streak = self._down_streak = 0
        self.events.append(dict(action=action,
                                n_replicas=len(self.router.replicas),
                                **detail))

    def scale_up(self):
        """Boot a replica from the factory and join it to the fleet.
        Returns it."""
        t0 = time.perf_counter()
        eng = self.factory()
        boot_s = time.perf_counter() - t0
        self.boot_s.append(boot_s)
        self.scale_ups += 1
        i = self.router.add_replica(eng)
        self._acted("scale-up", replica=i, boot_s=boot_s,
                    version=getattr(eng, "param_version", 0))
        return eng

    def scale_down(self):
        """Retire the least-loaded healthy replica; its unfinished streams
        migrate as continuations. Returns the removed engine, or None when
        nothing was eligible."""
        healthy = self._healthy()
        if len(self.router.replicas) <= self.min_replicas or not healthy:
            return None
        victim = min(healthy,
                     key=lambda i: (self.router.replicas[i].outstanding(), i))
        migrated = self.router.drain_replica(victim)
        eng = self.router.remove_replica(victim)
        self.migrated_on_drain += migrated
        self.scale_downs += 1
        self._acted("scale-down", replica=victim, migrated=migrated)
        return eng

    # ---- engine drive surface (run_load / run_trace) -------------------

    def submit(self, prompt, max_new_tokens: int, **kw):
        return self.router.submit(prompt, max_new_tokens, **kw)

    def cancel(self, req) -> bool:
        return self.router.cancel(req)

    def outstanding(self) -> int:
        return self.router.outstanding()

    def outstanding_by_tenant(self) -> dict:
        return self.router.outstanding_by_tenant()

    def accounting_ok(self) -> bool:
        return self.router.accounting_ok()

    def tenant_accounting_ok(self) -> bool:
        return self.router.tenant_accounting_ok()

    def set_clock(self, clock) -> None:
        """Swap the control-plane clock (``run_trace`` hands its virtual
        clock over): the replica-second integral's last sample and the
        cooldown anchor restart on the new clock; the integral so far is
        kept."""
        self._clock = clock
        self._rs_last = clock()
        self._last_action_at = None

    # ---- introspection -------------------------------------------------

    def replica_seconds(self) -> float:
        """The integral of capacity over time so far."""
        now = self._clock()
        return self._rs_integral + self.capacity() * (now - self._rs_last)

    def stats(self) -> dict:
        return {"enabled": self.enabled,
                "n_replicas": len(self.router.replicas),
                "capacity": self.capacity(),
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "migrated_on_drain": self.migrated_on_drain,
                "boot_s": list(self.boot_s),
                "replica_seconds": self.replica_seconds(),
                "cooldown_ms": self.cooldown_ms,
                "events": list(self.events),
                "router": self.router.stats()}


__all__ = ["Autoscaler"]
