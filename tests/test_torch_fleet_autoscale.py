"""The port's autoscaler (tpu_ddp_torch/fleet/autoscale.py) held against
tpu_ddp.fleet.Autoscaler on the CPU: hysteresis and cooldown on a fake
clock, the ghost-load regression, parity and per-tenant identity across a
scale-down drain, ``run_trace`` driving the controller on its virtual
clock, and the knob checks.

Both packages get the same TransformerLM-tiny weights (the JAX seed
through convert.py) and the geometry of tests/test_fleet_autoscale.py.
The controller's ``events`` must be JAX's (``boot_s`` aside, a wall
time), and so must its counters; greedy streams carry JAX's tokens,
logprobs within 1e-4, and every stream the port's undisturbed tokens.
Booting from the weight publisher is ROADMAP item 11b: ``publisher=``
raises. The graph-audit count of tests/test_fleet_autoscale.py reads
XLA programs (item 12) and has no counterpart here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.fleet import Autoscaler as JaxAutoscaler
from tpu_ddp.fleet import Router as JaxRouter
from tpu_ddp.models.transformer import make_transformer as jax_make
from tpu_ddp.serve import ServeEngine as JaxServeEngine
from tpu_ddp.serve import make_trace as jax_make_trace
from tpu_ddp.serve import run_trace as jax_run_trace
from tpu_ddp_torch.convert import params_from_jax
from tpu_ddp_torch.fleet import Autoscaler, Router
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.serve.engine import ServeEngine
from tpu_ddp_torch.serve.loadgen import make_trace, run_trace

GEOM = dict(num_slots=4, block_size=8, prefill_chunk=8)
MIXED = [(0, 5, 6, 0.0), (1, 9, 5, 0.0), (2, 12, 4, 0.7),
         (3, 8, 6, 1.0)]
TENANTS = ("gold", "silver", "bronze", "gold")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test files run in parallel worker processes; torch's own thread
    pool on top of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def factories():
    jm = jax_make("TransformerLM-tiny", max_seq_len=64,
                  compute_dtype=jnp.float32)
    tm = make_transformer("TransformerLM-tiny", max_seq_len=64,
                          compute_dtype=torch.float32)
    jp = jm.init(jax.random.key(0))
    tp = params_from_jax(tm, jax.tree.map(np.asarray, jp), device="cpu")
    return {"jax": lambda **kw: JaxServeEngine(jm, jp, **dict(GEOM, **kw)),
            "port": lambda **kw: ServeEngine(tm, tp, device="cpu",
                                             **dict(GEOM, **kw))}


PACKAGES = {"jax": (JaxRouter, JaxAutoscaler),
            "port": (Router, Autoscaler)}


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 1024, size=n).tolist()


def _submit_mixed(target):
    return [target.submit(_prompt(L, seed=ps), n, temperature=t, seed=i,
                          tenant=TENANTS[i])
            for i, (ps, L, n, t) in enumerate(MIXED)]


def _events(auto):
    return [{k: v for k, v in e.items() if k != "boot_s"}
            for e in auto.events]


def _counters(auto):
    st = auto.stats()
    return {k: st[k] for k in ("n_replicas", "capacity", "scale_ups",
                               "scale_downs", "migrated_on_drain")}


def test_autoscaler_validates_knobs(factories):
    router = Router([factories["port"]()])
    factory = factories["port"]
    for kw in (dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
               dict(up_tokens_per_replica=4.0, down_tokens_per_replica=8.0),
               dict(cooldown_ms=0.0), dict(hold_steps=0)):
        with pytest.raises(ValueError):
            Autoscaler(router, factory, **kw)
        with pytest.raises(ValueError):
            JaxAutoscaler(JaxRouter([factories["jax"]()]),
                          factories["jax"], **kw)
    with pytest.raises(NotImplementedError, match="11b"):
        Autoscaler(router, factory, publisher=object())


def test_config_knobs_reach_the_autoscaler(factories, monkeypatch):
    monkeypatch.setenv("TPU_DDP_FLEET_AUTOSCALE", "1")
    monkeypatch.setenv("TPU_DDP_SCALE_COOLDOWN_MS", "250")
    for name, (R, A) in PACKAGES.items():
        auto = A(R([factories[name]()]), factories[name])
        assert auto.enabled is True and auto.cooldown_ms == 250.0


def test_hysteresis_and_cooldown_match_jax(factories):
    """``hold_steps`` consecutive observations to act; the cooldown blocks
    back-to-back actions on a fake clock."""
    got = {}
    for name, (R, A) in PACKAGES.items():
        clk = [0.0]
        router = R([factories[name]()])
        auto = A(router, factories[name], min_replicas=1, max_replicas=3,
                 up_tokens_per_replica=2.0, down_tokens_per_replica=0.5,
                 hold_steps=3, cooldown_ms=1000.0, enabled=True,
                 clock=lambda: clk[0])
        for k in range(8):
            auto.submit(_prompt(5, seed=k), 4)
        seen = []
        for t, ticks in ((0.0, 2), (0.0, 1), (0.0, 3), (1.5, 3)):
            clk[0] = t
            for _ in range(ticks):
                auto._tick()
            seen.append(len(router.replicas))
        assert seen == [1, 2, 2, 3]
        auto.run()
        assert auto.accounting_ok()
        clk[0] = 2.0
        got[name] = (_events(auto), _counters(auto),
                     auto.replica_seconds())
    assert got["port"] == got["jax"]


def test_cancel_storm_leaves_no_ghost_load(factories):
    got = {}
    for name, (R, A) in PACKAGES.items():
        router = R([factories[name]() for _ in range(2)])
        auto = A(router, factories[name], min_replicas=1, max_replicas=3,
                 up_tokens_per_replica=8.0, down_tokens_per_replica=2.0,
                 cooldown_ms=1e9, enabled=True)
        keep = [auto.submit(_prompt(5, seed=k), 4, tenant="steady")
                for k in range(2)]
        storm = [auto.submit(_prompt(5, seed=50 + k), 4, tenant="storm")
                 for k in range(12)]
        before = auto.outstanding_by_tenant()
        assert before.get("storm", 0) > 5 * before.get("steady", 1)
        for h in storm:
            assert auto.cancel(h)
        by = auto.outstanding_by_tenant()
        assert by.get("storm", 0) == 0
        assert auto.router.outstanding() == by.get("steady", 0)
        assert auto.load_per_replica() <= before["steady"]
        auto.run()
        assert all(h.done and not h.cancelled for h in keep)
        assert auto.outstanding() == 0
        assert auto.tenant_accounting_ok() and auto.accounting_ok()
        got[name] = (before, _events(auto), _counters(auto),
                     [[int(t) for t in h.tokens] for h in keep])
    assert got["port"] == got["jax"]


def test_identity_and_parity_across_drain(factories):
    """Mixed cancel and scale-down drain: per-tenant identity everywhere,
    migrated streams the undisturbed tokens."""
    got = {}
    for name, (R, A) in PACKAGES.items():
        eng = factories[name]()
        base = _submit_mixed(eng)
        eng.run()
        router = R([factories[name](), factories[name]()])
        auto = A(router, factories[name], min_replicas=1, max_replicas=2,
                 enabled=False)
        hs = _submit_mixed(auto)
        extra = auto.submit(_prompt(6, seed=9), 5, tenant="bronze")
        for _ in range(3):
            auto.step()          # partway into decode on both replicas
        assert auto.cancel(extra)
        assert auto.scale_down() is not None
        assert len(router.replicas) == 1
        auto.run()
        assert [h.tokens for h in hs] == [b.tokens for b in base]
        assert not any(h.shed or h.cancelled for h in hs)
        assert extra.cancelled and not extra.shed
        assert auto.scale_downs == 1 and auto.migrated_on_drain >= 1
        assert auto.tenant_accounting_ok() and auto.accounting_ok()
        assert all(v == 0 for v in auto.outstanding_by_tenant().values())
        got[name] = (hs, _events(auto), _counters(auto))
    assert got["port"][1:] == got["jax"][1:]
    for i, case in enumerate(MIXED):
        t, j = got["port"][0][i], got["jax"][0][i]
        if case[3] == 0.0:
            assert t.tokens == [int(x) for x in j.tokens], i
            np.testing.assert_allclose(t.logprobs, j.logprobs, atol=1e-4,
                                       rtol=0)


def test_scale_up_joins_a_factory_replica(factories):
    router = Router([factories["port"]()])
    auto = Autoscaler(router, factories["port"], min_replicas=1,
                      max_replicas=2, enabled=False)
    booted = auto.scale_up()
    assert router.replicas[-1] is booted and booted.param_version == 0
    assert auto.scale_ups == 1 and len(auto.boot_s) == 1
    assert router.health[-1].healthy and router.routed == [0, 0]
    h0 = router.replicas[0].submit(_prompt(6, seed=3), 5)
    h1 = booted.submit(_prompt(6, seed=3), 5)
    router.run()
    assert h0.tokens == h1.tokens and h0.logprobs == h1.logprobs


def test_make_trace_matches_jax():
    kw = dict(duration_s=20.0, base_rate=2.0, peak_rate=20.0,
              vocab_size=512, seed=3, tenant_mix={"gold": 1, "bronze": 2},
              flash_crowds=((9.0, 11.0, 3.0),))
    mine, theirs = make_trace(**kw), jax_make_trace(**kw)
    assert [(e.at_s, list(map(int, e.spec.prompt)), e.spec.tenant,
             e.spec.max_new_tokens) for e in mine] == [
        (e.at_s, list(map(int, e.spec.prompt)), e.spec.tenant,
         e.spec.max_new_tokens) for e in theirs]


def test_run_trace_virtual_clock_drives_autoscaler(factories):
    """run_trace replays on the fleet-parallel virtual clock: the
    replica-second integral ticks in trace time (bounded by capacity x
    makespan), per-tenant identity holds, no SLO inversion. Wall times
    drive the virtual clock, so the two packages' scaling decisions may
    differ; each is held to its own bounds."""
    trace_kw = dict(duration_s=1.5, base_rate=10.0, peak_rate=60.0,
                    vocab_size=1024, seed=5,
                    tenant_mix={"gold": 1, "bronze": 1},
                    prompt_len=(4, 9), max_new=(3, 6))
    for name, (R, A) in PACKAGES.items():
        trace = (make_trace if name == "port" else jax_make_trace)(
            **trace_kw)

        def factory(make=factories[name]):
            return make(tenant_classes="gold=3,bronze=1")

        auto = A(R([factory()]), factory, min_replicas=1, max_replicas=2,
                 up_tokens_per_replica=8.0, down_tokens_per_replica=2.0,
                 hold_steps=2, cooldown_ms=50.0, enabled=True)
        run = run_trace if name == "port" else jax_run_trace
        m = run(auto, trace, slo_ttft_ms=1e4,
                class_weights={"gold": 3, "bronze": 1})
        assert m["n_requests"] == len(trace)
        assert m["accounting_ok"] and m["tenant_accounting_ok"]
        assert m["slo_inversions"] == 0
        assert m["n_completed"] + m["n_shed"] + m["n_cancelled"] \
            == len(trace)
        assert set(m["tenants"]) == {"gold", "bronze"}
        assert 0 < m["replica_seconds"] <= 2 * m["makespan_s"] + 1e-6
        assert "autoscale" in m
