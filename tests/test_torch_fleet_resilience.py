"""Fleet resilience in the port (tpu_ddp_torch/fleet/resilience.py, the
Router's health and migration, the disaggregated engine's degraded mode,
the engine's chaos hook) held against tpu_ddp.fleet on the CPU, with the
fleet's knob surfaces (config, launch, tune).

Each drill runs in both packages on the same TransformerLM-tiny weights
(the JAX seed through convert.py) and the geometry of
tests/test_fleet_resilience.py. A disturbed port stream must equal the
port's undisturbed single-engine stream bit for bit, tokens and
logprobs; a greedy one must carry JAX's tokens, logprobs within 1e-4
(the port samples at temperature > 0 with its own Gumbel noise). The
counters must be JAX's: failovers, migrated, retried, readmitted, shed,
the edge's sent, delivered and dropped, quarantines.
"""

import dataclasses
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.fleet import DisaggEngine as JaxDisagg
from tpu_ddp.fleet import ReplicaCrashError as JaxCrash
from tpu_ddp.fleet import ReplicaHealth as JaxHealth
from tpu_ddp.fleet import Router as JaxRouter
from tpu_ddp.fleet import continuation_of as jax_continuation
from tpu_ddp.models.transformer import make_transformer as jax_make
from tpu_ddp.resilience import chaos as jax_chaos
from tpu_ddp.serve import ServeEngine as JaxServeEngine
from tpu_ddp.tune import space as jspace
from tpu_ddp.utils.config import TrainConfig as JaxConfig
from tpu_ddp_torch import launch
from tpu_ddp_torch.convert import params_from_jax
from tpu_ddp_torch.fleet import (DisaggEngine, ReplicaCrashError,
                                 ReplicaHealth, Router, ServeFaultInjector,
                                 continuation_of)
from tpu_ddp_torch.fleet.resilience import device_fault, serve_chaos_active
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.ops.cuda_build import KernelError
from tpu_ddp_torch.resilience import chaos
from tpu_ddp_torch.serve.engine import ServeEngine
from tpu_ddp_torch.tune import space as tspace
from tpu_ddp_torch.utils.config import TrainConfig, refuse_unported_env

GEOM = dict(num_slots=4, block_size=8, prefill_chunk=8)
MIXED = [(0, 5, 6, 0.0), (1, 9, 5, 0.0), (2, 12, 4, 0.7),
         (3, 8, 6, 1.0)]
COUNTERS = ("failovers", "readmitted", "migrated", "retried", "shed",
            "pending", "migrating", "routed")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test files run in parallel worker processes; torch's own thread
    pool on top of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_model():
    return jax_make("TransformerLM-tiny", max_seq_len=64,
                    compute_dtype=jnp.float32)


@pytest.fixture(scope="module")
def model():
    return make_transformer("TransformerLM-tiny", max_seq_len=64,
                            compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def jax_params(jax_model):
    return jax_model.init(jax.random.key(0))


@pytest.fixture(scope="module")
def params(model, jax_params):
    return params_from_jax(model, jax.tree.map(np.asarray, jax_params),
                           device="cpu")


@pytest.fixture(scope="module")
def engines(jax_model, jax_params, model, params):
    """Engine factories of both packages, by name."""
    return {"jax": lambda **kw: JaxServeEngine(jax_model, jax_params,
                                               **dict(GEOM, **kw)),
            "port": lambda **kw: ServeEngine(model, params, device="cpu",
                                             **dict(GEOM, **kw))}


@pytest.fixture(scope="module")
def disaggs(jax_model, jax_params, model, params):
    return {"jax": lambda **kw: JaxDisagg(jax_model, jax_params,
                                          **dict(GEOM, **kw)),
            "port": lambda **kw: DisaggEngine(model, params, device="cpu",
                                              **dict(GEOM, **kw))}


@pytest.fixture(scope="module")
def baseline(engines):
    """The undisturbed single-engine streams of MIXED, per package."""
    out = {}
    for name, make in engines.items():
        eng = make()
        hs = _submit_mixed(eng)
        eng.run()
        out[name] = hs
    return out


def _prompt(L, seed=0):
    return np.random.default_rng(seed).integers(0, 1024, size=L,
                                                dtype=np.int64)


def _submit_mixed(engine):
    return [engine.submit(_prompt(L, seed=ps), n, temperature=t, seed=i)
            for i, (ps, L, n, t) in enumerate(MIXED)]


def _hold(runs, baseline):
    """Each package's tokens are its baseline's, the port's logprobs its
    baseline's bit for bit (a migrated continuation replays its streamed
    tokens through decode passes, ``submit(replay=...)``); the greedy
    streams carry JAX's tokens, logprobs within 1e-4."""
    for name, hs in runs.items():
        assert [h.tokens for h in hs] == [
            [int(t) for t in b.tokens] for b in baseline[name]], name
    assert [h.logprobs for h in runs["port"]] == [
        b.logprobs for b in baseline["port"]]
    for i, case in enumerate(MIXED):
        if case[3] == 0.0:
            np.testing.assert_allclose(
                runs["port"][i].logprobs, runs["jax"][i].logprobs,
                atol=1e-4, rtol=0, err_msg=f"request {i}")
            assert runs["port"][i].tokens == runs["jax"][i].tokens


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _Crashy:
    """Raises out of step() once, at its Nth step (the error class of its
    package)."""

    def __init__(self, engine, crash_at, error):
        self.engine, self.crash_at, self.error = engine, crash_at, error
        self.n = 0

    def step(self):
        self.n += 1
        if self.n == self.crash_at:
            raise self.error(f"synthetic crash at step {self.n}")
        return self.engine.step()

    def __getattr__(self, name):
        return getattr(self.engine, name)


ERRORS = {"jax": JaxCrash, "port": ReplicaCrashError}
ROUTERS = {"jax": JaxRouter, "port": Router}


class _StepClock:
    """A Router's health clock that moves 1 ms per ``step()``: probes fall
    due by the Router's own steps, so both packages see the same probe
    schedule whatever the host's speed."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def router(self, name, replicas, **kw):
        router = ROUTERS[name](replicas, clock=self, **kw)
        step = router.step

        def ticking():
            self.now += 1e-3
            return step()

        router.step = ticking
        return router


def _stats(router):
    st = router.stats()
    return {k: st[k] for k in COUNTERS}


# ---- health and continuation ------------------------------------------------

@pytest.mark.parametrize("cls", [ReplicaHealth, JaxHealth],
                         ids=["port", "jax"])
def test_backoff_doubles_caps_and_probes(cls):
    clk = _FakeClock()
    h = cls(backoff_s=0.2, backoff_cap_s=1.0, clock=clk)
    waits = [h.mark_failure() for _ in range(5)]
    assert waits == pytest.approx([0.2, 0.4, 0.8, 1.0, 1.0])
    assert not h.healthy and h.failures == 5
    clk.t = 0.99
    assert not h.probe_due()
    clk.t = 1.0
    assert h.probe_due()
    h.mark_recovered()
    assert h.healthy and h.failures == 0
    assert h.mark_failure() == pytest.approx(0.2)
    with pytest.raises(ValueError, match="backoff_s"):
        cls(backoff_s=0.0)


def test_continuation_matches_jax(engines):
    for done in (True, False):
        got = []
        for name, fn in (("port", continuation_of),
                         ("jax", jax_continuation)):
            eng = engines[name]()
            h = eng.submit(_prompt(6, seed=1), 5, seed=3)
            if done:
                eng.run()
            prompt, budget = fn(h)
            got.append(([int(t) for t in prompt], budget))
        assert got[0] == got[1]
        assert got[0][1] == (0 if done else 5)


# ---- migration --------------------------------------------------------------

def _crash_drill(engines, crash_at, backoff_ms, n_other=1, other_crash=None):
    out = {}
    for name in ("jax", "port"):
        reps = [_Crashy(engines[name](), crash_at, ERRORS[name])]
        for _ in range(n_other):
            eng = engines[name]()
            reps.append(eng if other_crash is None
                        else _Crashy(eng, other_crash, ERRORS[name]))
        router = _StepClock().router(name, reps, probe_backoff_ms=backoff_ms)
        hs = _submit_mixed(router)
        out[name] = (router, hs)
    return out


def test_crash_mid_decode_is_invisible(engines, baseline):
    runs = _crash_drill(engines, crash_at=4, backoff_ms=10_000.0)
    for router, _ in runs.values():
        with pytest.warns(UserWarning, match="marked unhealthy"):
            router.run()
        assert router.accounting_ok()
    _hold({k: hs for k, (_, hs) in runs.items()}, baseline)
    st = _stats(runs["port"][0])
    assert st == _stats(runs["jax"][0])
    assert st["failovers"] == 1 and st["migrated"] + st["retried"] >= 1


def test_backoff_probe_readmits_the_replica(engines, baseline):
    runs = _crash_drill(engines, crash_at=2, backoff_ms=1.0)
    for router, _ in runs.values():
        with pytest.warns(UserWarning, match="marked unhealthy"):
            router.run()
    _hold({k: hs for k, (_, hs) in runs.items()}, baseline)
    port = runs["port"][0]
    assert port.stats()["readmitted"] == 1
    assert all(h.healthy for h in port.health)
    # The re-admitted replica serves new traffic as before.
    again = {name: _submit_mixed(r) for name, (r, _) in runs.items()}
    for r, _ in runs.values():
        r.run()
        assert r.accounting_ok()
    _hold(again, baseline)
    assert _stats(port) == _stats(runs["jax"][0])


def test_whole_fleet_dark_holds_then_replays(engines, baseline):
    runs = {}
    for name in ("jax", "port"):
        router = _StepClock().router(
            name, [_Crashy(engines[name](), 1, ERRORS[name])],
            probe_backoff_ms=1.0)
        with pytest.warns(UserWarning, match="marked unhealthy"):
            router.step()                  # kill the only replica
        hs = _submit_mixed(router)         # the fleet is dark: held
        assert router.stats()["pending"] == 4
        assert all(h.rid < 0 for h in hs)
        router.run()
        assert all(h.done for h in hs) and router.accounting_ok()
        runs[name] = (router, hs)
    _hold({k: hs for k, (_, hs) in runs.items()}, baseline)
    assert _stats(runs["port"][0]) == _stats(runs["jax"][0])


def test_retry_budget_exhaustion_sheds(engines):
    got = {}
    for name in ("jax", "port"):
        router = _StepClock().router(
            name, [_Crashy(engines[name](), 4, ERRORS[name])],
            retry_budget=0, probe_backoff_ms=1.0)
        hs = _submit_mixed(router)
        with pytest.warns(UserWarning, match="marked unhealthy"):
            router.run()
        assert all(h.done for h in hs) and router.accounting_ok()
        shed = [h.shed for h in hs]
        assert any(shed) and router.stats()["shed"] == sum(shed)
        done = sum(not h.shed and not h.cancelled for h in hs)
        assert done + sum(shed) == len(hs)
        got[name] = (shed, _stats(router))
    assert got["port"] == got["jax"]


def test_cancel_in_pending_queue_never_resurrects(engines):
    got = {}
    for name in ("jax", "port"):
        router = _StepClock().router(
            name, [_Crashy(engines[name](), 3, ERRORS[name])
                   for _ in range(2)], probe_backoff_ms=1.0)
        hs = _submit_mixed(router)
        with pytest.warns(UserWarning, match="marked unhealthy"):
            while not router.stats()["pending"]:
                router.step()              # both replicas die
        victim = next(h for h in hs
                      if any(p is h for p in router._pending))
        assert router.cancel(victim) is True
        assert victim.cancelled and victim.done
        ntoks = len(victim.tokens)
        router.run()
        assert all(h.done for h in hs)
        assert not any(c is victim for _, c, _, _
                       in router._migrating.values())
        assert len(victim.tokens) == ntoks  # no zombie tokens
        assert router.cancel(victim) is False
        assert router.accounting_ok()
        assert sum(not h.cancelled for h in hs) + 1 == len(hs)
        got[name] = (hs.index(victim), _stats(router),
                     [h.cancelled for h in hs])
    assert got["port"] == got["jax"]


def test_cancel_of_migrating_continuation(engines):
    got = {}
    for name in ("jax", "port"):
        router = ROUTERS[name]([_Crashy(engines[name](), 4, ERRORS[name]),
                                engines[name]()],
                               probe_backoff_ms=10_000.0)
        hs = _submit_mixed(router)
        with pytest.warns(UserWarning, match="marked unhealthy"):
            while not router._migrating:
                router.step()
        victim = next(h for h in hs if id(h) in router._migrating)
        assert router.cancel(victim) is True
        assert victim.cancelled and id(victim) not in router._migrating
        router.run()
        assert all(h.done for h in hs) and router.accounting_ok()
        got[name] = (hs.index(victim), _stats(router))
    assert got["port"] == got["jax"]


def test_drain_replica_and_remove(engines, baseline):
    """The graceful drain: no failure mark, no shed, the streams the
    undisturbed ones; the index-keyed state compacts as JAX's does."""
    runs = {}
    for name in ("jax", "port"):
        router = ROUTERS[name]([engines[name]() for _ in range(2)])
        hs = _submit_mixed(router)
        for _ in range(3):
            router.step()
        n = router.drain_replica(0)
        eng = router.remove_replica(0)
        assert eng is not None and len(router.replicas) == 1
        with pytest.raises(ValueError, match="last replica"):
            router.remove_replica(0)
        router.run()
        runs[name] = (router, hs, n)
    _hold({k: hs for k, (_, hs, _) in runs.items()}, baseline)
    assert runs["port"][2] == runs["jax"][2] >= 1
    assert _stats(runs["port"][0]) == _stats(runs["jax"][0])


def test_crash_migrates_into_disagg_replicas(disaggs, baseline):
    """A Router over two DisaggEngines: the crashed replica's streams
    replay through the survivor's prefill role, edge and decode role."""
    runs = {}
    for name in ("jax", "port"):
        router = ROUTERS[name]([_Crashy(disaggs[name](), 5, ERRORS[name]),
                                disaggs[name]()],
                               probe_backoff_ms=10_000.0)
        hs = _submit_mixed(router)
        with pytest.warns(UserWarning, match="marked unhealthy"):
            router.run()
        assert router.accounting_ok()
        runs[name] = (router, hs)
    _hold({k: hs for k, (_, hs) in runs.items()}, baseline)
    st = _stats(runs["port"][0])
    assert st == _stats(runs["jax"][0])
    assert st["migrated"] >= 1
    assert runs["port"][0].replicas[1].edge.stats() == \
        runs["jax"][0].replicas[1].edge.stats()


@pytest.mark.parametrize("route", ["k0", "chain", "tiers", "disagg"])
def test_replay_continues_bit_for_bit(engines, disaggs, route):
    """``submit(prompt + streamed, budget, replay=len(streamed))`` goes on
    with the undisturbed stream's tokens and logprobs, on every route."""
    kw = {"chain": dict(spec_k=2, spec_draft="chain"),
          "tiers": dict(kv_tiers=2, kv_cold_dtype="bf16", hbm_blocks=12)
          }.get(route, {})
    make = disaggs["port"] if route == "disagg" else engines["port"]
    full = make(**kw)
    want = _submit_mixed(full)
    full.run()
    for g in (1, 3):
        eng = make(**kw)
        hs = [eng.submit(np.concatenate([w.prompt, w.tokens[:g]]),
                         w.max_new_tokens - g, temperature=w.temperature,
                         seed=w.seed, replay=g) for w in want]
        eng.run()
        assert eng.accounting_ok()
        for h, w in zip(hs, want):
            assert h.tokens == w.tokens[g:] and h.logprobs == w.logprobs[g:]
    with pytest.raises(ValueError, match="replay"):
        make().submit(_prompt(4), 2, replay=4)


# ---- degraded disaggregation ------------------------------------------------

def test_edge_drop_falls_back_to_local_prefill(disaggs, baseline,
                                               monkeypatch):
    monkeypatch.setenv("TPU_DDP_CHAOS_FAULTS", "edge-drop@2")
    runs, engs = {}, {}
    for name in ("jax", "port"):
        fleet = disaggs[name]()
        assert fleet.chaos is not None
        hs = _submit_mixed(fleet)
        with pytest.warns(UserWarning, match="lost on the edge"):
            fleet.run()
        assert all(h.done for h in hs) and fleet.accounting_ok()
        assert fleet.metrics.counters.get("fleet_edge_failures") == 1
        runs[name], engs[name] = hs, fleet
    _hold(runs, baseline)
    assert engs["port"].edge.stats() == engs["jax"].edge.stats()
    assert engs["port"].edge.dropped == 1
    assert engs["port"].metrics.counters["fleet_degraded_chunks"] >= 1


def test_prefill_death_degrades_engine_to_local(disaggs, baseline):
    runs, engs = {}, {}
    for name in ("jax", "port"):
        fleet = disaggs[name]()
        calls = {"n": 0}
        orig = fleet._prefill

        def dying(*a, _orig=orig, _calls=calls, **kw):
            _calls["n"] += 1
            if _calls["n"] == 2:
                raise RuntimeError("prefill worker died")
            return _orig(*a, **kw)

        fleet._prefill = dying
        hs = _submit_mixed(fleet)
        with pytest.warns(UserWarning, match="falling back to local"):
            fleet.run()
        assert fleet.prefill_degraded and fleet.accounting_ok()
        runs[name], engs[name] = hs, fleet
    _hold(runs, baseline)
    # Degraded mode is sticky: later submits take the local path.
    again = {name: _submit_mixed(f) for name, f in engs.items()}
    for f in engs.values():
        f.run()
        assert f.accounting_ok()
    _hold(again, baseline)
    assert engs["port"].edge.stats() == engs["jax"].edge.stats()
    for k in ("fleet_prefill_failures", "fleet_degraded",
              "fleet_degraded_promoted", "fleet_adopted", "fleet_shipped"):
        assert engs["port"].metrics.counters.get(k) == \
            engs["jax"].metrics.counters.get(k), k


# ---- the card's faults are no replica's ------------------------------------

DEVICE_FAULTS = {
    "kernel": lambda m: KernelError(
        f"int8_matmul (mma) launch failed: CUDA error 700 ({m})"),
    "cuda": lambda m: RuntimeError(
        f"CUDA error: an illegal memory access was encountered ({m})"),
    "accelerator": lambda m: torch.AcceleratorError(
        f"CUDA error: device-side assert triggered ({m})")}


class _Faulty:
    """Raises ``script[n]`` out of its nth step()."""

    def __init__(self, engine, script):
        self.engine, self.script, self.n = engine, script, 0

    def step(self):
        self.n += 1
        if self.n in self.script:
            raise self.script[self.n](f"step {self.n}")
        return self.engine.step()

    def __getattr__(self, name):
        return getattr(self.engine, name)


def test_device_fault_tells_the_card_from_a_replica():
    for make in DEVICE_FAULTS.values():
        assert device_fault(make("x"))
    assert device_fault(KernelError("nvcc failed on int8_matmul.cu"))
    for exc in (ReplicaCrashError("x"), TimeoutError("x"),
                RuntimeError("prefill worker died"),
                ValueError("CUDA error: not a RuntimeError"),
                torch.OutOfMemoryError("CUDA out of memory")):
        assert not device_fault(exc), exc


@pytest.mark.parametrize("fault", sorted(DEVICE_FAULTS))
@pytest.mark.parametrize("when", ["healthy", "probe"])
def test_device_fault_propagates_out_of_the_router(engines, fault, when):
    """A CUDA error or a kernel's failure raised out of a replica's step,
    healthy or on a probe, leaves ``Router.step``: every replica on the
    card shares it, so failover would only spin. A host-side crash before
    it still fails over."""
    script = ({2: DEVICE_FAULTS[fault]} if when == "healthy" else
              {2: ReplicaCrashError, 3: DEVICE_FAULTS[fault]})
    router = Router([_Faulty(engines["port"](), script), engines["port"]()],
                    probe_backoff_ms=1e-3)
    _submit_mixed(router)
    with pytest.raises(RuntimeError, match="CUDA error") as got:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            router.run(max_steps=50)
    assert device_fault(got.value)
    assert router.stats()["failovers"] == (0 if when == "healthy" else 1)


@pytest.mark.parametrize("fault", sorted(DEVICE_FAULTS))
def test_device_fault_is_no_prefill_death(disaggs, fault):
    """The disagg prefill role degrades on a host-side failure
    (test_prefill_death_degrades_engine_to_local), but re-raises a CUDA
    error or a kernel's failure."""
    fleet = disaggs["port"]()
    calls, orig = {"n": 0}, fleet._prefill

    def failing(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise DEVICE_FAULTS[fault]("prefill chunk")
        return orig(*a, **kw)

    fleet._prefill = failing
    _submit_mixed(fleet)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fleet.run()
    assert not fleet.prefill_degraded


@pytest.mark.parametrize("draft", ["chain", "self-1"])
def test_replay_leaves_speculating_rows_alone(engines, draft):
    """On a speculating replica a migrated continuation's rows take k=0
    passes of their own while they replay; the other rows go on
    speculating, their streams bit for bit the same engine's without the
    continuation."""
    kw = dict(spec_k=2, spec_draft=draft)
    alone = engines["port"](**kw)
    want = _submit_mixed(alone)
    alone.run()
    eng = engines["port"](**kw)
    streamed = 5
    cont = eng.submit(np.concatenate([_prompt(6, seed=9),
                                      _prompt(streamed, seed=10)]), 3,
                      replay=streamed)
    hs = _submit_mixed(eng)
    eng.run()
    assert eng.accounting_ok() and cont.done and len(cont.tokens) == 3
    for h, w in zip(hs, want):
        assert h.tokens == w.tokens and h.logprobs == w.logprobs
    # Both ran speculative windows while the continuation replayed.
    assert eng.spec_stats()["proposed"] == alone.spec_stats()["proposed"] \
        + cont.spec_proposed


# ---- quarantine through the chaos hook --------------------------------------

@pytest.mark.parametrize("kind", ["engine", "disagg"])
def test_poisoned_request_is_quarantined_not_the_batch(
        engines, disaggs, baseline, monkeypatch, kind):
    monkeypatch.setenv("TPU_DDP_CHAOS_FAULTS", "nonfinite-logits@6")
    make = engines if kind == "engine" else disaggs
    runs, engs = {}, {}
    for name in ("jax", "port"):
        eng = make[name]()
        hs = _submit_mixed(eng)
        with pytest.warns(UserWarning, match="quarantin"):
            eng.run()
        assert all(h.done for h in hs) and eng.accounting_ok()
        assert sum(h.quarantined for h in hs) == 1
        assert eng.metrics.counters.get("serve_quarantined") == 1
        runs[name], engs[name] = hs, eng
    assert [h.quarantined for h in runs["port"]] == [
        h.quarantined for h in runs["jax"]]
    for name, hs in runs.items():
        assert [h.tokens for h in hs if not h.quarantined] == [
            b.tokens for h, b in zip(hs, baseline[name])
            if not h.quarantined]
    # The poisoned pages were scrubbed: a refill streams as before.
    monkeypatch.delenv("TPU_DDP_CHAOS_FAULTS")
    again = {name: _submit_mixed(e) for name, e in engs.items()}
    for e in engs.values():
        e.run()
    _hold(again, baseline)


@pytest.mark.parametrize("route", ["chain", "self-1", "tiers"])
def test_poison_on_every_decode_route(engines, monkeypatch, route):
    """The hook runs before the bank on the speculative routes and a
    tiered pool too: one request quarantined, the others the undisturbed
    stream of the same engine."""
    kw = (dict(kv_tiers=2, kv_cold_dtype="bf16", hbm_blocks=12)
          if route == "tiers" else dict(spec_k=2, spec_draft=route))
    clean = engines["port"](**kw)
    want = _submit_mixed(clean)
    clean.run()
    # A step where the bank decodes: speculation finishes MIXED sooner.
    at = 5 if route == "tiers" else 3
    monkeypatch.setenv("TPU_DDP_CHAOS_FAULTS", f"nonfinite-logits@{at}")
    eng = engines["port"](**kw)
    hs = _submit_mixed(eng)
    with pytest.warns(UserWarning, match="quarantin"):
        eng.run()
    assert sum(h.quarantined for h in hs) == 1
    assert eng.accounting_ok()
    for h, w in zip(hs, want):
        if not h.quarantined:
            assert h.tokens == w.tokens and h.logprobs == w.logprobs


def test_replica_crash_chaos_through_the_router(engines, baseline,
                                                monkeypatch):
    """``replica-crash@3:rank=1`` reaches replica 1 through the Router's
    rank stamp, before any state changes in the step."""
    monkeypatch.setenv("TPU_DDP_CHAOS_FAULTS", "replica-crash@3:rank=1")
    runs = {}
    for name in ("jax", "port"):
        router = ROUTERS[name]([engines[name]() for _ in range(2)],
                               probe_backoff_ms=10_000.0)
        assert [r.chaos._rank for r in router.replicas] == [0, 1]
        hs = _submit_mixed(router)
        with pytest.warns(UserWarning, match="replica 1 failed"):
            router.run()
        assert router.accounting_ok()
        runs[name] = (router, hs)
    _hold({k: hs for k, (_, hs) in runs.items()}, baseline)
    assert _stats(runs["port"][0]) == _stats(runs["jax"][0])
    assert runs["port"][0].failovers == 1


# ---- chaos specs ------------------------------------------------------------

def test_serve_kinds_parse_and_train_kinds_ignored(monkeypatch):
    for kind in chaos.SERVE_FAULT_KINDS:
        tenant = "gold" if kind == "tenant-storm" else None
        a = chaos.FaultSpec(kind=kind, step=3, tenant=tenant)
        b = jax_chaos.FaultSpec(kind=kind, step=3, tenant=tenant)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.key == b.key
    monkeypatch.setenv("TPU_DDP_CHAOS_FAULTS",
                       "nan-grad@3,replica-crash@5:rank=1")
    assert serve_chaos_active()
    inj = ServeFaultInjector.from_env()
    inj.set_rank(0)
    for s in range(1, 10):
        inj.replica_step(s)                # rank mismatch: no fire
    inj.set_rank(1)
    with pytest.raises(ReplicaCrashError):
        inj.replica_step(5)
    # The trainer's injector takes the serving kinds and ignores them.
    trainer = chaos.FaultInjector.from_env(rank=1)
    assert trainer.before_step(5) is False


def test_one_shot_kinds_and_sentinels(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_DDP_CHAOS_FAULTS",
                       "replica-crash@2,edge-drop@1,flash-crowd@4,"
                       "tenant-storm@6:tenant=bronze,slow-replica@3")
    monkeypatch.setenv("TPU_DDP_CHAOS_SLOW_S", "0")
    monkeypatch.setenv("TPU_DDP_CHAOS_SENTINEL", str(tmp_path / "s"))
    inj = ServeFaultInjector.from_env()
    with pytest.raises(ReplicaCrashError, match="step 2"):
        inj.replica_step(2)
    for s in range(3, 8):
        inj.replica_step(s)                # silent forever after
    assert [inj.edge_drop_fires(d) for d in (1, 1, 2)] == [True, False,
                                                           False]
    assert [inj.flash_crowd_fires(s) for s in (3, 4, 4)] == [False, True,
                                                             False]
    assert inj.tenant_storm_fires(6) == "bronze"
    assert inj.tenant_storm_fires(6) is None
    assert not inj.poison_fires(1)
    # A fresh injector (a restarted process) sees the sentinels.
    again = ServeFaultInjector.from_env()
    again.replica_step(2)
    assert not again.edge_drop_fires(1)


@pytest.mark.parametrize("spec,item", [
    ("publisher-death@1", "11b"), ("push-stall@2", "11b"),
    ("group-loss@1", "11c")])
def test_remaining_kinds_raise_naming_their_item(spec, item, monkeypatch):
    with pytest.raises(NotImplementedError, match=item):
        chaos.FaultInjector(chaos.parse_faults(spec))
    monkeypatch.setenv("TPU_DDP_CHAOS_FAULTS", spec)
    with pytest.raises(NotImplementedError, match=item):
        ServeFaultInjector.from_env()


def test_router_publish_refusal_and_fail_fast(engines, monkeypatch):
    router = Router([engines["port"]()])
    with pytest.raises(NotImplementedError, match="11b"):
        router.subscribe(object())
    monkeypatch.setenv("TPU_DDP_FLEET_HEALTH", "0")
    assert Router([engines["port"]()]).health_enabled is False
    crashy = _Crashy(engines["port"](), 1, ReplicaCrashError)
    router = Router([crashy], health=False)
    crashy.engine.submit(_prompt(5), 2)
    with pytest.raises(ReplicaCrashError):
        router.run()


# ---- knob surfaces ----------------------------------------------------------

FLEET_ENV = {"TPU_DDP_ROUTER_POLICY": "prefix-affinity",
             "TPU_DDP_KV_WIRE": "int8", "TPU_DDP_FLEET_HEALTH": "0",
             "TPU_DDP_FLEET_HEALTH_BACKOFF_MS": "50",
             "TPU_DDP_FLEET_HEALTH_DEADLINE_MS": "250",
             "TPU_DDP_FLEET_RETRY_BUDGET": "1",
             "TPU_DDP_FLEET_AUTOSCALE": "1",
             "TPU_DDP_SCALE_COOLDOWN_MS": "250"}
FLEET_FIELDS = ("router_policy", "kv_wire", "fleet_health",
                "fleet_probe_backoff_ms", "fleet_step_deadline_ms",
                "fleet_retry_budget", "fleet_autoscale", "scale_cooldown_ms")


@pytest.fixture
def clean_env(monkeypatch):
    for name in (*FLEET_ENV, "TPU_DDP_FLEET_ROLES"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_config_defaults_and_env_match_jax(clean_env):
    j, t = JaxConfig(), TrainConfig()
    assert [getattr(t, f) for f in FLEET_FIELDS] == [
        getattr(j, f) for f in FLEET_FIELDS]
    for k, v in FLEET_ENV.items():
        clean_env.setenv(k, v)
    j, t = JaxConfig(), TrainConfig()
    assert [getattr(t, f) for f in FLEET_FIELDS] == [
        getattr(j, f) for f in FLEET_FIELDS]
    assert t.router_policy == "prefix-affinity" and t.fleet_health is False


@pytest.mark.parametrize("env,junk", [
    ("TPU_DDP_FLEET_ROLES", "trio"),
    ("TPU_DDP_ROUTER_POLICY", "random"),
    ("TPU_DDP_KV_WIRE", "fp4"),
    ("TPU_DDP_FLEET_HEALTH", "maybe"),
    ("TPU_DDP_FLEET_HEALTH_BACKOFF_MS", "fast"),
    ("TPU_DDP_FLEET_HEALTH_BACKOFF_MS", "0"),
    ("TPU_DDP_FLEET_HEALTH_DEADLINE_MS", "soon"),
    ("TPU_DDP_FLEET_HEALTH_DEADLINE_MS", "-1"),
    ("TPU_DDP_FLEET_RETRY_BUDGET", "many"),
    ("TPU_DDP_FLEET_RETRY_BUDGET", "-2"),
    ("TPU_DDP_FLEET_AUTOSCALE", "knob-audit-junk"),
    ("TPU_DDP_SCALE_COOLDOWN_MS", "0"),
    ("TPU_DDP_SCALE_COOLDOWN_MS", "-5")])
def test_config_rejects_junk_as_jax_does(clean_env, env, junk):
    clean_env.setenv(env, junk)
    with pytest.raises(ValueError) as theirs:
        JaxConfig()
    if env == "TPU_DDP_FLEET_ROLES":
        # Nothing in the port reads the role split before its benchmark
        # (item 13), so any value but the default is refused, naming it.
        with pytest.raises(NotImplementedError, match="item 13"):
            refuse_unported_env()
        clean_env.setenv(env, "single")
        refuse_unported_env()
        assert not hasattr(TrainConfig(), "fleet_roles")
        return
    with pytest.raises(ValueError, match=re.escape(str(theirs.value))):
        TrainConfig()


@pytest.mark.parametrize("argv,env", [
    (["--fleet-health", "0"], {"TPU_DDP_FLEET_HEALTH": "0"}),
    (["--fleet-probe-backoff-ms", "50"],
     {"TPU_DDP_FLEET_HEALTH_BACKOFF_MS": "50.0"}),
    (["--fleet-step-deadline-ms", "250"],
     {"TPU_DDP_FLEET_HEALTH_DEADLINE_MS": "250.0"}),
    (["--fleet-retry-budget", "1"], {"TPU_DDP_FLEET_RETRY_BUDGET": "1"}),
    (["--fleet-autoscale", "1"], {"TPU_DDP_FLEET_AUTOSCALE": "1"}),
    (["--scale-cooldown-ms", "250"], {"TPU_DDP_SCALE_COOLDOWN_MS": "250.0"})])
def test_launch_exports_fleet_flags(monkeypatch, argv, env):
    seen = []
    monkeypatch.setattr(launch, "launch_elastic",
                        lambda part, nproc, **kw: seen.append(kw["env"])
                        or launch.LaunchResult())
    assert launch.main(["part1", "--nproc", "1", *argv]) == 0
    assert seen == [env]


@pytest.mark.parametrize("argv", [
    ["--fleet-probe-backoff-ms", "0"], ["--fleet-step-deadline-ms", "-1"],
    ["--fleet-retry-budget", "-1"], ["--scale-cooldown-ms", "0"],
    ["--fleet-health", "2"]])
def test_launch_checks_fleet_flags(argv):
    with pytest.raises(SystemExit):
        launch.main(["part1", "--nproc", "1", *argv])


@pytest.mark.parametrize("flag,item", [
    ("--publish-every", "11b"), ("--diloco-h", "11c")])
def test_launch_still_refuses_publish_and_diloco(flag, item):
    with pytest.raises(NotImplementedError, match=item):
        launch.main(["part1", "--nproc", "1", flag, "1"])


def test_tune_registry_and_rules_match_jax():
    for name in FLEET_FIELDS:
        k, jk = tspace.knob_by_field(name), jspace.knob_by_field(name)
        assert (k.field, k.env, k.values, k.flag, k.semantic,
                k.objective) == (jk.field, jk.env, jk.values, jk.flag,
                                 jk.semantic, jk.objective), name
        assert name not in tspace._UNPORTED_KNOBS
    assert tspace.knob_by_field("fleet_roles") is None
    assert "item 13" in tspace._UNPORTED_KNOBS["fleet_roles"]
    for name in ("publish_every", "diloco_h"):
        assert "11b" in tspace._UNPORTED_KNOBS["publish_every"]
        assert "11c" in tspace._UNPORTED_KNOBS["diloco_h"]
    ctx = tspace.Workload()
    cells = [{"kv_wire": "int8"}, {"kv_wire": "bf16",
                                   "fleet_roles": "disagg"},
             {"router_policy": "prefix-affinity"},
             {"router_policy": "prefix-affinity", "prefix_cache": True},
             {"spec_k": 2, "fleet_roles": "disagg"},
             {"spec_k": 2}, {"scale_cooldown_ms": 250.0},
             {"scale_cooldown_ms": 250.0, "fleet_autoscale": True}]
    jctx = jspace.Workload()
    for cell in cells:
        got = tspace.violations(cell, ctx)
        want = jspace.violations(cell, jctx)
        assert bool(got) == bool(want), (cell, got, want)
    assert [bool(tspace.violations(c, ctx)) for c in cells] == [
        True, False, True, False, True, False, True, False]
