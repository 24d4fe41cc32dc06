"""Fleet resilience (tpu_ddp/fleet/resilience.py): replica health, the
deterministic-migration primitive and the serving chaos hooks.

- :class:`ReplicaHealth` — the health state the Router keeps per replica.
  A replica that raises out of ``step()`` (or overruns the optional step
  deadline) goes unhealthy; it is re-admitted by a probe after an
  exponential backoff (``backoff * 2**(failures - 1)``, capped), so a
  flapping replica gets ever rarer chances and a recovered one rejoins
  after one successful probe. The clock is injectable.

- :class:`ServeFaultInjector` — the serving chaos hooks over the training
  :class:`~tpu_ddp_torch.resilience.chaos.FaultInjector` grammar, seed and
  sentinels (``TPU_DDP_CHAOS_FAULTS``; kinds in
  ``resilience.chaos.SERVE_FAULT_KINDS``). ``rank`` in a spec is the
  replica index (the Router stamps each replica's injector with its
  position) and ``step`` the replica's engine-step counter (``edge-drop``
  counts edge deliveries). Every kind is one-shot by exact step match, so
  a crashed replica's later probe does not crash again.

- :func:`continuation_of` — sampling is stateless, keyed by (seed,
  position), so a request replayed elsewhere from ``prompt +
  tokens_so_far`` samples its next token at the position key the
  undisturbed run would have used. The port's engines prefill the
  original prompt and feed the streamed tokens through decode passes
  (``submit(replay=len(tokens))``): their K/V then comes from the
  arithmetic that sampled them, where JAX re-prefills them in chunks. A
  chunk's attention rounds differently from one query's: on an H100
  (TransformerLM-large, bf16, int8 decode) a re-prefill moved later
  logprobs by up to 5e-3 and parted a greedy token at a top-2 gap of
  0.02, where the replay keeps migration bit for bit. The replay costs
  one decode pass per streamed token: a stream migrated after 256 tokens
  recovered in 5.8 s, against 0.44 s re-prefilled (TransformerLM-large,
  int8 decode, host-bound passes on an H100).

A replica crash loses the replica's KV pages and any decode step in
flight; every unfinished request is replayed from its prompt plus the
tokens already streamed (its KV is recomputed, pages are not migrated).
Tokens already handed to the caller are never lost, and ``completed +
cancelled + shed == submitted`` holds.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from tpu_ddp_torch.ops.cuda_build import KernelError
from tpu_ddp_torch.resilience.chaos import CHAOS_ENV, FaultInjector

HEALTHY = "healthy"
UNHEALTHY = "unhealthy"


class ReplicaCrashError(RuntimeError):
    """Raised out of ``step()`` by chaos (or a broken replica): the signal
    the Router turns into unhealthy state and request migration."""


def device_fault(exc: BaseException) -> bool:
    """Whether ``exc`` is the card's or a kernel's failure rather than a
    replica's: a CUDA error (sticky in the process's one context, which
    every replica on the card shares), a kernel that did not build or
    launch (:class:`~tpu_ddp_torch.ops.cuda_build.KernelError`). No
    failover routes round it, so the Router and the disagg prefill role
    re-raise it; a :class:`ReplicaCrashError`, a deadline overrun or any
    other host-side exception still fails over."""
    accel = getattr(torch, "AcceleratorError", None)
    if isinstance(exc, KernelError) or (accel is not None
                                        and isinstance(exc, accel)):
        return True
    return isinstance(exc, RuntimeError) and str(exc).startswith("CUDA error")


class ReplicaHealth:
    """Health state machine of one replica: healthy <-> unhealthy, with
    exponential-backoff probing."""

    def __init__(self, backoff_s: float = 0.2, backoff_cap_s: float = 30.0,
                 clock=time.monotonic):
        if backoff_s <= 0:
            raise ValueError(f"backoff_s must be > 0, got {backoff_s}")
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.clock = clock
        self.state = HEALTHY
        self.failures = 0          # consecutive, reset on recovery
        self.next_probe_at = 0.0

    @property
    def healthy(self) -> bool:
        return self.state == HEALTHY

    def mark_failure(self) -> float:
        """Record one failure; returns the wait until the next probe
        (doubling per consecutive failure, capped)."""
        self.failures += 1
        self.state = UNHEALTHY
        wait = min(self.backoff_s * 2 ** (self.failures - 1),
                   self.backoff_cap_s)
        self.next_probe_at = self.clock() + wait
        return wait

    def mark_recovered(self) -> None:
        self.state = HEALTHY
        self.failures = 0
        self.next_probe_at = 0.0

    def probe_due(self) -> bool:
        """True when an unhealthy replica has served its backoff."""
        return self.state == UNHEALTHY \
            and self.clock() >= self.next_probe_at


def continuation_of(request):
    """The (prompt, max_new_tokens) a migrated replay submits: the
    original prompt extended by every token already streamed, the budget
    shrunk by as many."""
    prompt = np.asarray(request.prompt, np.int64)
    if request.tokens:
        prompt = np.concatenate(
            [prompt, np.asarray(request.tokens, np.int64)])
    return prompt, request.max_new_tokens - len(request.tokens)


class ServeFaultInjector(FaultInjector):
    """The serving fault hooks. Engines build one when
    ``TPU_DDP_CHAOS_FAULTS`` is set and call :meth:`replica_step` at the
    top of every ``step()``; the disaggregated engine asks
    :meth:`edge_drop_fires` per edge delivery, and every decode route asks
    :meth:`poison_fires` before it runs the bank. Training kinds in the
    same spec are ignored here."""

    @classmethod
    def from_env(cls, rank: int | None = 0) -> "ServeFaultInjector":
        inj = super().from_env(rank=rank)
        # A serving process is one host: the rank (replica index) is 0
        # until the Router stamps the replica's position.
        if inj._rank is None:
            inj._rank = 0
        return inj

    def set_rank(self, rank: int) -> None:
        """The Router's stamp: ``:rank=R`` specs target replica R."""
        self._rank = int(rank)

    def _fire_once(self, kind: str, step: int):
        """The first spec of ``kind`` that fires at ``step``, announced
        and marked; None when none does."""
        for spec in self.specs:
            if spec.kind == kind and self._fires(spec, step):
                self._announce(spec, step)
                self._mark_sentinel(spec, step)
                return spec
        return None

    def replica_step(self, step: int) -> None:
        """Top-of-``step()`` faults: ``slow-replica`` sleeps once
        (``TPU_DDP_CHAOS_SLOW_S``) so a deadline-armed Router sees the
        overrun; ``replica-crash`` raises."""
        if self._fire_once("slow-replica", step) is not None:
            time.sleep(self.slow_s)
        spec = self._fire_once("replica-crash", step)
        if spec is not None:
            raise ReplicaCrashError(
                f"chaos: replica {spec.rank} crashed at engine step {step}")

    def edge_drop_fires(self, delivery: int) -> bool:
        """True when the ``delivery``-th KV-edge transfer is lost in
        flight (the decode role then re-prefills locally)."""
        return self._fire_once("edge-drop", delivery) is not None

    def poison_fires(self, step: int) -> bool:
        """True when this engine step must NaN one live request's private
        KV pages (the ``nonfinite-logits`` drill: the bank's finiteness
        flag must quarantine exactly that request)."""
        return self._fire_once("nonfinite-logits", step) is not None

    # The load-surge kinds are consumed by the drive loop, not a replica:
    # chaos decides when the surge lands, the drill what it submits.

    def flash_crowd_fires(self, step: int) -> bool:
        """True when a fleet-wide load surge lands at this drive step."""
        return self._fire_once("flash-crowd", step) is not None

    def tenant_storm_fires(self, step: int) -> str | None:
        """The storming tenant's name when a one-tenant flood lands at
        this drive step, else None."""
        spec = self._fire_once("tenant-storm", step)
        return spec.tenant if spec is not None else None


def serve_chaos_active() -> bool:
    """True when the chaos env is set at all: engines then build a
    :class:`ServeFaultInjector` (training-only specs match no hook)."""
    return bool(os.environ.get(CHAOS_ENV))


__all__ = [
    "HEALTHY",
    "UNHEALTHY",
    "ReplicaCrashError",
    "ReplicaHealth",
    "ServeFaultInjector",
    "device_fault",
    "continuation_of",
    "serve_chaos_active",
]
