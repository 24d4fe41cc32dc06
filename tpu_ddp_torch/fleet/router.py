"""Multi-replica router (tpu_ddp/fleet/router.py): one front end over N
serving engines.

The replicas are ``ServeEngine`` or ``DisaggEngine`` objects (duck-typed
over ``submit``, ``cancel``, ``step`` and the hooks ``outstanding()``,
``prefix_cached_len()`` and ``drain()``); the Router is the only state
above them. It picks a replica per request, remembers the assignment for
``cancel`` and steps every replica, so ``run_load`` drives a fleet as it
drives one engine.

Two policies (``TPU_DDP_ROUTER_POLICY``):

- ``least-loaded``: the replica owing the fewest outstanding tokens.
- ``prefix-affinity``: the replica whose prefix cache already holds the
  longest part of the prompt (``prefix_cached_len``, a pure probe), ties
  broken by load — but only while its backlog stays within
  ``affinity_slack`` tokens of the least-loaded replica's; past that the
  request goes to the least-loaded one. The cross-replica
  :class:`~tpu_ddp_torch.fleet.prefix.PrefixDirectory` narrows the probe
  to the replicas that can hit.

Resilience (``TPU_DDP_FLEET_HEALTH``): every replica call is guarded. A
replica that raises out of ``step()`` (or overruns
``TPU_DDP_FLEET_HEALTH_DEADLINE_MS``) is marked unhealthy; its unfinished
requests are harvested through ``drain()`` and replayed on the survivors
from ``prompt + tokens_so_far`` (fleet/resilience.py
:func:`continuation_of`), bit for bit the undisturbed stream: the
survivor prefills the prompt and feeds the streamed tokens through decode
passes (``submit(replay=...)``), the arithmetic that sampled them. A
CUDA error or a kernel's failure (:func:`~tpu_ddp_torch.fleet.resilience.
device_fault`) is re-raised instead: every replica on the card shares it.
Probes
re-admit it after an exponential backoff
(``TPU_DDP_FLEET_HEALTH_BACKOFF_MS``); a request replayed
``TPU_DDP_FLEET_RETRY_BUDGET`` times is shed. ``completed + cancelled +
shed == submitted`` holds: no request is lost, resurrected after a cancel
or freed twice.
"""

from __future__ import annotations

import time
import warnings
from collections import deque

import numpy as np

from tpu_ddp_torch.fleet.prefix import PrefixDirectory
from tpu_ddp_torch.fleet.resilience import (ReplicaHealth, continuation_of,
                                            device_fault)
from tpu_ddp_torch.serve.engine import Request
from tpu_ddp_torch.serve.scheduler import tenant_of

POLICIES = ("least-loaded", "prefix-affinity")

_PUBLISH_REFUSAL = (
    "{what}: weight publishing (tpu_ddp/publish/) is not ported to "
    "tpu_ddp_torch yet (ROADMAP Queue 1 item 11b)")


def _stamp(replica, index: int) -> None:
    """Stamp a replica's chaos injector with its fleet index, so
    ``:rank=R`` fault specs target one replica."""
    ch = getattr(replica, "chaos", None)
    if ch is not None and hasattr(ch, "set_rank"):
        ch.set_rank(index)


def _finish(req, **flags) -> None:
    """End a router-held request (cancelled or shed)."""
    for k, v in flags.items():
        setattr(req, k, v)
    req.done = True
    req.finished_at = time.perf_counter()


class Router:
    """Front end over a list of replicas; the surface of one engine."""

    def __init__(self, replicas, policy: str | None = None,
                 affinity_slack: int = 256, health: bool | None = None,
                 retry_budget: int | None = None,
                 probe_backoff_ms: float | None = None,
                 step_deadline_ms: float | None = None,
                 clock=time.monotonic, config=None):
        if not replicas:
            raise ValueError("Router needs at least one replica")
        if config is None:
            from tpu_ddp_torch.utils.config import TrainConfig
            config = TrainConfig()
        policy = policy if policy is not None else config.router_policy
        if policy not in POLICIES:
            raise ValueError(f"unknown router policy {policy!r}: "
                             f"expected one of {POLICIES}")
        self.replicas = list(replicas)
        self.policy = policy
        self.affinity_slack = int(affinity_slack)
        self.routed = [0] * len(self.replicas)
        self.affinity_hits = 0      # routed by a cached prefix (> 0 tokens)
        self._owner: dict[int, int] = {}   # id(request) -> replica index
        self.health_enabled = bool(
            health if health is not None else config.fleet_health)
        self.retry_budget = int(
            retry_budget if retry_budget is not None
            else config.fleet_retry_budget)
        backoff_ms = float(
            probe_backoff_ms if probe_backoff_ms is not None
            else config.fleet_probe_backoff_ms)
        self._backoff_s = backoff_ms / 1e3
        self.step_deadline_ms = float(
            step_deadline_ms if step_deadline_ms is not None
            else config.fleet_step_deadline_ms)
        if self.retry_budget < 0:
            raise ValueError("retry_budget must be >= 0")
        if self.step_deadline_ms < 0:
            raise ValueError("step_deadline_ms must be >= 0")
        self._clock = clock
        self.health = [ReplicaHealth(backoff_s=self._backoff_s, clock=clock)
                       for _ in self.replicas]
        # Requests harvested off a failed replica, awaiting replay.
        self._pending: deque = deque()
        # id(original) -> [original, continuation, replica index, synced]
        self._migrating: dict[int, list] = {}
        self._cont_to_orig: dict[int, Request] = {}
        self._rid = -1  # router-issued rids are negative (no clash)
        self.failovers = 0
        self.readmitted = 0
        self.migrated = 0   # replays that carried tokens already
        self.retried = 0    # replays that had not produced a token
        self.shed = 0       # retry budget exhausted
        self.prefix_dir = None
        if self.policy == "prefix-affinity":
            bs = getattr(self.replicas[0], "block_size", None)
            if bs:
                self.prefix_dir = PrefixDirectory(int(bs))
        for i, r in enumerate(self.replicas):
            _stamp(r, i)

    # ---- placement -----------------------------------------------------

    def _candidates(self) -> list[int]:
        idxs = [i for i in range(len(self.replicas))
                if self.health[i].healthy]
        return idxs or list(range(len(self.replicas)))

    def pick(self, prompt, tenant: str = "default") -> int:
        """The replica index ``submit`` would use for ``prompt``. An
        unhealthy replica is never picked while a healthy one exists.
        Affinity probes are per tenant and, when the directory has hints
        for the key, narrowed to the hinted replicas, with the full probe
        when every hint misses: narrowing saves probes and never changes
        the decision."""
        cand = self._candidates()
        loads = {i: self.replicas[i].outstanding() for i in cand}
        least = min(cand, key=lambda i: (loads[i], i))
        if self.policy == "least-loaded":
            return least
        probe = cand
        if self.prefix_dir is not None:
            in_cand = set(cand)
            hinted = [i for i in self.prefix_dir.candidates(tenant, prompt)
                      if i in in_cand]
            if hinted:
                probe = hinted
        cached = {i: self.replicas[i].prefix_cached_len(prompt, tenant)
                  for i in probe}
        if probe is not cand and max(cached.values()) == 0:
            for i in cand:  # stale hints: the full probe
                if i not in cached:
                    cached[i] = self.replicas[i].prefix_cached_len(
                        prompt, tenant)
        best = max(cached, key=lambda i: (cached[i], -loads[i], -i))
        if cached[best] > 0 and \
                loads[best] - loads[least] <= self.affinity_slack:
            return best
        return least

    def submit(self, prompt, max_new_tokens: int, **kw):
        tenant = str(kw.get("tenant", "default"))
        if self.health_enabled and \
                not any(h.healthy for h in self.health):
            # The whole fleet is dark: hold the request here and replay
            # it once a probe re-admits a replica.
            req = Request(rid=self._rid,
                          prompt=np.asarray(prompt, np.int64).reshape(-1),
                          max_new_tokens=int(max_new_tokens),
                          temperature=float(kw.get("temperature", 0.0)),
                          seed=int(kw.get("seed", 0)),
                          eos_id=kw.get("eos_id"),
                          on_token=kw.get("on_token"),
                          tenant=tenant,
                          submitted_at=time.perf_counter())
            self._rid -= 1
            self._pending.append(req)
            return req
        i = self.pick(prompt, tenant)
        if self.policy == "prefix-affinity" and \
                self.replicas[i].prefix_cached_len(prompt, tenant) > 0:
            self.affinity_hits += 1
        req = self.replicas[i].submit(prompt, max_new_tokens, **kw)
        self.routed[i] += 1
        self._owner[id(req)] = i
        if self.prefix_dir is not None:
            self.prefix_dir.record(tenant, req.prompt, i)
        return req

    def cancel(self, req) -> bool:
        # A request parked in the replay machinery holds no replica state
        # under its own identity: cancel must neither resurrect it at the
        # next replay nor free pages the failover drain already released.
        if req.done:
            return False
        if any(p is req for p in self._pending):
            self._pending = deque(p for p in self._pending if p is not req)
            _finish(req, cancelled=True)
            return True
        ent = self._migrating.pop(id(req), None)
        if ent is not None:
            orig, cont, i, _ = ent
            self._cont_to_orig.pop(id(cont), None)
            self.replicas[i].cancel(cont)
            _finish(orig, cancelled=True)
            return True
        i = self._owner.get(id(req))
        if i is None:
            return False
        return self.replicas[i].cancel(req)

    # ---- replica lifecycle (the autoscaler's surface) ------------------

    def add_replica(self, replica) -> int:
        """Join a fresh replica, healthy with no load; returns its
        index."""
        i = len(self.replicas)
        self.replicas.append(replica)
        self.routed.append(0)
        self.health.append(ReplicaHealth(backoff_s=self._backoff_s,
                                         clock=self._clock))
        _stamp(replica, i)
        return i

    def _harvest(self, i: int) -> list:
        """Drain replica ``i``; a harvested continuation folds its
        progress into its original, which is what comes back."""
        harvested = self.replicas[i].drain() \
            if hasattr(self.replicas[i], "drain") else []
        out = []
        for req in harvested:
            orig = self._cont_to_orig.pop(id(req), None)
            if orig is not None:
                ent = self._migrating.pop(id(orig), None)
                if ent is not None:
                    self._sync_entry(ent)
                req = orig
            if not (req.done or req.cancelled):
                out.append(req)
        return out

    def drain_replica(self, i: int) -> int:
        """Graceful drain for scale-down: replica ``i``'s unfinished work
        queues for replay elsewhere as continuations. A planned
        retirement: no failure mark, no failover count and no retry-budget
        shed. Returns how many streams were queued."""
        harvested = self._harvest(i)
        self._pending.extend(harvested)
        if self.prefix_dir is not None:
            self.prefix_dir.forget(i)
        return len(harvested)

    def remove_replica(self, i: int):
        """Retire replica ``i`` (drained first) and compact every
        index-keyed structure. Returns the removed engine."""
        if len(self.replicas) <= 1:
            raise ValueError("cannot remove the last replica")
        self.drain_replica(i)  # idempotent after a prior drain
        eng = self.replicas.pop(i)
        self.routed.pop(i)
        self.health.pop(i)
        self._owner = {k: (v - 1 if v > i else v)
                       for k, v in self._owner.items() if v != i}
        for ent in self._migrating.values():
            if ent[2] > i:
                ent[2] -= 1
        if self.prefix_dir is not None:
            self.prefix_dir.reindex(i)
        for j, r in enumerate(self.replicas):
            _stamp(r, j)
        return eng

    def outstanding_by_tenant(self) -> dict[str, int]:
        """Fleet-wide backlog per tenant, computed live from the replicas
        and the router-held work, so a cancel leaves no ghost load."""
        out: dict[str, int] = {}
        for r in self.replicas:
            by = getattr(r, "outstanding_by_tenant", None)
            if by is not None:
                for t, w in by().items():
                    out[t] = out.get(t, 0) + w
            else:
                w = r.outstanding()
                if w:
                    out["default"] = out.get("default", 0) + w
        for req in self._pending:
            t = tenant_of(req)
            out[t] = out.get(t, 0) \
                + len(req.prompt) + req.max_new_tokens - len(req.tokens)
        return out

    # ---- failure handling ----------------------------------------------

    def _fail_replica(self, i: int, exc: Exception) -> None:
        wait = self.health[i].mark_failure()
        self.failovers += 1
        warnings.warn(
            f"replica {i} failed ({type(exc).__name__}: {exc}); "
            f"marked unhealthy (probe in {wait:.2f}s), migrating its "
            "in-flight requests", stacklevel=3)
        for req in self._harvest(i):
            if req.migrations >= self.retry_budget:
                _finish(req, shed=True)
                self.shed += 1
                continue
            self._pending.append(req)

    def _resubmit_pending(self) -> bool:
        """Replay harvested requests on healthy replicas as continuations
        from ``prompt + tokens_so_far``."""
        if not self._pending:
            return False
        healthy = [i for i in range(len(self.replicas))
                   if self.health[i].healthy]
        if not healthy:
            return False
        did = False
        while self._pending:
            orig = self._pending.popleft()
            if orig.done or orig.cancelled:
                continue  # cancelled while pending: never resurrect
            prompt, budget = continuation_of(orig)
            i = min(healthy,
                    key=lambda j: (self.replicas[j].outstanding(), j))
            try:
                cont = self.replicas[i].submit(
                    prompt, budget, temperature=orig.temperature,
                    seed=orig.seed, eos_id=orig.eos_id,
                    tenant=tenant_of(orig), replay=len(orig.tokens))
            except ValueError as e:
                # A request held while the fleet was dark was never
                # validated: shed it loudly instead of killing the loop.
                warnings.warn(f"request {orig.rid}: replay rejected "
                              f"({e}); shedding", stacklevel=3)
                _finish(orig, shed=True)
                self.shed += 1
                continue
            orig.migrations += 1
            if orig.tokens:
                self.migrated += 1
            else:
                self.retried += 1
            self.routed[i] += 1
            self._owner[id(orig)] = i
            self._migrating[id(orig)] = [orig, cont, i, 0]
            self._cont_to_orig[id(cont)] = orig
            if self.prefix_dir is not None:
                self.prefix_dir.record(tenant_of(orig), cont.prompt, i)
            did = True
        return did

    def _sync_entry(self, ent: list) -> None:
        """Copy a continuation's new tokens onto the original handle (the
        caller never sees the continuation; its callbacks fire here)."""
        orig, cont, _, synced = ent
        if len(cont.tokens) > synced:
            now = time.perf_counter()
            vers = cont.token_versions
            for j in range(synced, len(cont.tokens)):
                orig.tokens.append(int(cont.tokens[j]))
                orig.logprobs.append(float(cont.logprobs[j]))
                if j < len(vers):
                    orig.token_versions.append(int(vers[j]))
                if orig.first_token_at is None:
                    orig.first_token_at = now
                if orig.on_token is not None:
                    orig.on_token(int(cont.tokens[j]))
            ent[3] = len(cont.tokens)

    def _sync_migrations(self) -> None:
        for key in list(self._migrating):
            ent = self._migrating[key]
            orig, cont, _, _ = ent
            self._sync_entry(ent)
            if cont.done:
                del self._migrating[key]
                self._cont_to_orig.pop(id(cont), None)
                _finish(orig, shed=orig.shed or cont.shed,
                        quarantined=orig.quarantined or cont.quarantined)

    # ---- the iteration (run_load drives this like one engine) ----------

    def _step_replica(self, i: int) -> bool:
        """One guarded replica step: an exception or a deadline overrun
        becomes unhealthy state and migration."""
        r, h = self.replicas[i], self.health[i]
        if not h.healthy:
            if not h.probe_due():
                return False
            try:
                worked = bool(r.step())
            except Exception as e:  # noqa: BLE001 — the probe failed
                if device_fault(e):
                    raise
                h.mark_failure()
                return False
            h.mark_recovered()
            self.readmitted += 1
            return worked
        t0 = time.perf_counter()
        try:
            worked = bool(r.step())
        except Exception as e:  # noqa: BLE001 — a crash becomes failover
            if device_fault(e):
                raise  # every replica on the card shares the fault
            self._fail_replica(i, e)
            return False
        if self.step_deadline_ms and \
                (time.perf_counter() - t0) * 1e3 > self.step_deadline_ms:
            self._fail_replica(i, TimeoutError(
                f"step() overran the {self.step_deadline_ms:.0f}ms "
                "deadline"))
            return False
        return worked

    def step(self) -> bool:
        if not self.health_enabled:
            worked = False
            for r in self.replicas:
                worked |= bool(r.step())  # step every replica
            return worked
        worked = False
        for i in range(len(self.replicas)):
            worked |= self._step_replica(i)
        worked |= self._resubmit_pending()
        self._sync_migrations()
        # Router-held work keeps the drive loop alive while every replica
        # backs off.
        return worked or bool(self._pending) or bool(self._migrating)

    def run(self, max_steps: int | None = None) -> int:
        n = 0
        while max_steps is None or n < max_steps:
            if not self.step():
                break
            n += 1
        return n

    def subscribe(self, publisher) -> list:
        """Fleet-wide weight fan-out: ROADMAP Queue 1 item 11b."""
        raise NotImplementedError(
            _PUBLISH_REFUSAL.format(what="Router.subscribe"))

    # ---- introspection -------------------------------------------------

    def outstanding(self) -> int:
        w = sum(r.outstanding() for r in self.replicas)
        for req in self._pending:
            w += len(req.prompt) + req.max_new_tokens - len(req.tokens)
        return w

    def accounting_ok(self) -> bool:
        return all(r.accounting_ok() for r in self.replicas)

    def tenant_accounting_ok(self) -> bool:
        """Every replica's per-tenant ledger identity holds."""
        return all(r.tenant_accounting_ok() for r in self.replicas
                   if hasattr(r, "tenant_accounting_ok"))

    def stats(self) -> dict:
        per = []
        for i, r in enumerate(self.replicas):
            s = {"routed": self.routed[i],
                 "outstanding": r.outstanding(),
                 "health": self.health[i].state,
                 "failures": self.health[i].failures}
            prefix = getattr(r, "prefix", None)
            if prefix is not None:
                s["prefix"] = prefix.stats()
            if getattr(r, "spec_k", 0) > 0 and hasattr(r, "spec_stats"):
                s["speculative"] = r.spec_stats()
            per.append(s)
        spec = [p["speculative"] for p in per if "speculative" in p]
        agg = None
        if spec:
            agg = {k: sum(s[k] for s in spec)
                   for k in ("proposed", "accepted", "rejected")}
            agg["acceptance"] = (agg["accepted"] / agg["proposed"]
                                 if agg["proposed"] else None)
        return {"policy": self.policy,
                "speculative": agg,
                "n_replicas": len(self.replicas),
                "routed": list(self.routed),
                "affinity_hits": self.affinity_hits,
                "tenant_backlog": self.outstanding_by_tenant(),
                "prefix_dir": (self.prefix_dir.stats()
                               if self.prefix_dir is not None else None),
                "health_enabled": self.health_enabled,
                "failovers": self.failovers,
                "readmitted": self.readmitted,
                "migrated": self.migrated,
                "retried": self.retried,
                "shed": self.shed,
                "pending": len(self._pending),
                "migrating": len(self._migrating),
                "replicas": per}


__all__ = ["Router", "POLICIES"]
