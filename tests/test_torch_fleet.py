"""The port's serving fleet (tpu_ddp_torch/fleet/: DisaggEngine over the KV
edge, the Router and its prefix directory) held against tpu_ddp.fleet on
the CPU.

Both packages get the same TransformerLM-tiny weights (the JAX seed,
converted by convert.py; f32, max_seq_len 64) and the geometry of
tests/test_fleet.py. Greedy streams must carry JAX's tokens, logprobs
within 1e-4. The port samples at temperature > 0 with its own Gumbel
noise (models/decode.py), so a sampled stream is held bit for bit to the
port's single engine instead, as JAX's fleet is held to JAX's. The
counters must be JAX's: routing, affinity hits, the edge's sent,
delivered, dropped and bytes. The int8 wire's rounding noise is the
port's counter hash, not ``jax.random``: it is held to JAX by its bytes
and ratio, and to the fp stream within a bound.

Not ported: ``TestDisagg::test_transfer_lands_behind_decode_compute``
reads XLA's HLO (ROADMAP item 12); the port's landing runs in order
before the bank, and ``adopt_decode_hlo`` raises naming item 12.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.fleet import DisaggEngine as JaxDisagg
from tpu_ddp.fleet import Router as JaxRouter
from tpu_ddp.models.transformer import make_transformer as jax_make
from tpu_ddp.serve import ServeEngine as JaxServeEngine
from tpu_ddp.serve import make_shared_prefix_workload as jax_shared
from tpu_ddp.serve import run_load as jax_run_load
from tpu_ddp_torch.convert import params_from_jax
from tpu_ddp_torch.fleet import (POLICIES, DisaggEngine, KVEdge, KVTransfer,
                                 PrefixDirectory, Router)
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.serve.engine import ServeEngine
from tpu_ddp_torch.serve.loadgen import (make_shared_prefix_workload,
                                         run_load)

GEOM = dict(num_slots=4, block_size=8, prefill_chunk=8)
MIXED = [(0, 5, 6, 0.0), (1, 9, 5, 0.0), (2, 12, 4, 0.7),
         (3, 8, 6, 1.0)]


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
def baselines(jax_model, jax_params, model, params):
    """MIXED through each package's single engine."""
    return (_serve(JaxServeEngine(jax_model, jax_params, **GEOM)),
            _serve(_engine(model, params)))


def _prompt(L, seed=0):
    return np.random.default_rng(seed).integers(0, 1024, size=L,
                                                dtype=np.int64)


def _engine(model, params, **kw):
    return ServeEngine(model, params, device="cpu", **dict(GEOM, **kw))


def _disagg(model, params, **kw):
    return DisaggEngine(model, params, device="cpu", **dict(GEOM, **kw))


def _serve(engine, cases=MIXED):
    hs = [engine.submit(_prompt(L, seed=ps), n, temperature=t, seed=i)
          for i, (ps, L, n, t) in enumerate(cases)]
    engine.run()
    assert all(h.done for h in hs)
    return hs


def hold(port, jax_hs, port_base, cases=MIXED):
    """Every port stream is the port single engine's bit for bit; every
    greedy one carries JAX's tokens, logprobs within 1e-4."""
    assert [h.tokens for h in port] == [h.tokens for h in port_base]
    assert [h.logprobs for h in port] == [h.logprobs for h in port_base]
    for i, (case, t, j) in enumerate(zip(cases, port, jax_hs)):
        if case[3] == 0.0:
            assert t.tokens == [int(x) for x in j.tokens], i
            np.testing.assert_allclose(t.logprobs, j.logprobs, atol=1e-4,
                                       rtol=0, err_msg=f"request {i}")


def _edge(engine):
    return {k: v for k, v in engine.edge.stats().items() if k != "ratio"}


@pytest.mark.parametrize("wire", ["none", "bf16", "int8"])
def test_disagg_wires_match_jax(jax_model, jax_params, model, params,
                                baselines, wire):
    jf = JaxDisagg(jax_model, jax_params, kv_wire=wire, **GEOM)
    tf = _disagg(model, params, kv_wire=wire)
    jh, th = _serve(jf), _serve(tf)
    assert _edge(tf) == _edge(jf)
    assert tf.edge.stats()["ratio"] == pytest.approx(
        jf.edge.stats()["ratio"], rel=1e-12)
    assert tf.edge.sent == tf.edge.delivered == len(MIXED)
    if wire == "int8":
        assert tf.edge.stats()["ratio"] >= 3.0
        # The rounding noise is the port's: every request finishes, and
        # the greedy streams stay within a bound of the fp stream.
        assert all(len(h.tokens) == c[2] for h, c in zip(th, MIXED))
        base = baselines[1]
        for i, (case, h) in enumerate(zip(MIXED, th)):
            assert np.isfinite(h.logprobs).all()
            if case[3] == 0.0:
                assert h.tokens == base[i].tokens, i
                np.testing.assert_allclose(h.logprobs, base[i].logprobs,
                                           atol=5e-3, rtol=0)
    else:
        # A bf16 wire rounds f32 pages the same way in both packages.
        port_base = baselines[1] if wire == "none" else _serve(
            _disagg(model, params, kv_wire=wire))
        hold(th, jh, port_base)
        if wire == "none":
            hold(th, baselines[0], baselines[1])
    assert tf.pool.free_count == tf.pool.total_usable
    assert tf.prefill_pool.free_count == tf.prefill_pool.total_usable
    assert tf.accounting_ok()
    assert tf.metrics.counters["serve_prefill_chunks"] == 6
    assert tf.metrics.counters["fleet_adopted"] == len(MIXED)


def test_disagg_with_prefix_cache_matches_jax(jax_model, jax_params, model,
                                              params):
    system = _prompt(16, seed=6)
    prompts = [np.concatenate([system, _prompt(3, seed=20 + i)])
               for i in range(3)]
    runs = {}
    for name, eng in (
            ("single", _engine(model, params)),
            ("disagg", _disagg(model, params, prefix_cache=True)),
            ("jax", JaxDisagg(jax_model, jax_params, kv_wire="none",
                              prefix_cache=True, **GEOM))):
        hs = []
        for i, p in enumerate(prompts):
            hs.append(eng.submit(p, 4, seed=i))
            eng.run()
        runs[name] = (eng, hs)
    (_, single), (tf, th), (jf, jh) = (runs["single"], runs["disagg"],
                                       runs["jax"])
    greedy = [(0, 19, 4, 0.0)] * 3
    hold(th, jh, single, greedy)
    assert tf.prefix.stats() == jf.prefix.stats()
    assert tf.prefix.stats()["hit_requests"] == 2
    assert tf.prefix_cached_len(prompts[0]) == jf.prefix_cached_len(
        prompts[0]) > 0
    assert _edge(tf) == _edge(jf)
    assert tf.accounting_ok()


def test_edge_validation_and_hlo_refusals(model, params):
    with pytest.raises(ValueError, match="kv_wire"):
        KVEdge("fp4")
    eng = _disagg(model, params)
    for name in ("lower_adopt_decode", "adopt_decode_hlo",
                 "lower_degraded_prefill"):
        with pytest.raises(NotImplementedError, match="item 12"):
            getattr(eng, name)()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DisaggEngine(model, params, **GEOM)


def test_disagg_cancel_on_the_edge_and_queued(jax_model, jax_params, model,
                                              params):
    """Cancel a request whose transfer waits on the edge (the decode slots
    are full) and one still queued: the same edge and pool ledger as
    JAX's, the rest of the streams untouched."""
    out = []
    for eng in (JaxDisagg(jax_model, jax_params, num_slots=1,
                          block_size=8, prefill_chunk=8),
                _disagg(model, params, num_slots=1)):
        hs = [eng.submit(_prompt(6, seed=s), 8, seed=s) for s in range(4)]
        while not eng.edge.queue:
            eng.step()
        t = eng.edge.queue[0]
        transfer = (type(t).__name__, t.n_blocks, t.length,
                    int(t.pending_token), t.nbytes)
        on_edge = t.request
        queued = hs[-1]
        assert eng.cancel(on_edge) and eng.cancel(queued)
        assert not eng.cancel(on_edge)
        eng.run()
        assert eng.accounting_ok()
        assert transfer[0] == KVTransfer.__name__
        out.append((transfer, eng.edge.stats()["dropped"],
                    hs.index(on_edge),
                    [h.cancelled for h in hs],
                    [[int(t) for t in h.tokens] for h in hs],
                    eng.pool.free_count == eng.pool.total_usable))
    assert out[1] == out[0]


def test_least_loaded_balance_and_routed_parity(jax_model, jax_params,
                                                model, params, baselines):
    with pytest.raises(ValueError, match="at least one"):
        Router([])
    with pytest.raises(ValueError, match="policy"):
        Router([_engine(model, params)], policy="rr")
    assert POLICIES == ("least-loaded", "prefix-affinity")
    routers = [JaxRouter([JaxServeEngine(jax_model, jax_params, **GEOM)
                          for _ in range(2)], policy="least-loaded"),
               Router([_engine(model, params) for _ in range(2)],
                      policy="least-loaded")]
    for r in routers:
        for i in range(6):
            r.submit(_prompt(6, seed=40 + i), 4, seed=i)
        assert r.routed == [3, 3]
        r.run()
        assert r.accounting_ok() and r.outstanding() == 0
    # Parity survives routing, with the prefix cache on every replica.
    jr = JaxRouter([JaxServeEngine(jax_model, jax_params,
                                   prefix_cache=True, **GEOM)
                    for _ in range(2)], policy="prefix-affinity")
    tr = Router([_engine(model, params, prefix_cache=True)
                 for _ in range(2)], policy="prefix-affinity")
    hold(_serve(tr), _serve(jr), baselines[1])
    assert tr.routed == jr.routed


def _hit_rate(router, specs):
    """tests/test_fleet.py's pacing: one warm-up request alone, then
    pairs submitted together."""
    router.submit(specs[0].prompt, specs[0].max_new_tokens,
                  seed=specs[0].seed)
    router.run()
    for a, b in zip(specs[1::2], specs[2::2]):
        for sp in (a, b):
            router.submit(sp.prompt, sp.max_new_tokens, seed=sp.seed)
        router.run()
    st = [rep["prefix"] for rep in router.stats()["replicas"]]
    return (sum(s["hit_requests"] for s in st)
            / sum(s["lookups"] for s in st))


@pytest.mark.parametrize("policy", POLICIES)
def test_policies_match_jax(jax_model, jax_params, model, params, policy):
    specs = make_shared_prefix_workload(9, model.vocab_size, seed=7,
                                        prefix_len=16)
    jspecs = jax_shared(9, jax_model.vocab_size, seed=7, prefix_len=16)
    assert [list(map(int, s.prompt)) for s in specs] == [
        list(map(int, s.prompt)) for s in jspecs]
    jr = JaxRouter([JaxServeEngine(jax_model, jax_params,
                                   prefix_cache=True, **GEOM)
                    for _ in range(2)], policy=policy)
    tr = Router([_engine(model, params, prefix_cache=True)
                 for _ in range(2)], policy=policy)
    assert _hit_rate(tr, specs) == _hit_rate(jr, jspecs) == (
        8 / 9 if policy == "prefix-affinity" else 7 / 9)
    js, ts = jr.stats(), tr.stats()
    for key in ("routed", "affinity_hits", "prefix_dir", "failovers",
                "migrated", "shed", "policy"):
        assert ts[key] == js[key], key
    assert [r["prefix"] for r in ts["replicas"]] == [
        r["prefix"] for r in js["replicas"]]
    want = [0, 9] if policy == "prefix-affinity" else [4, 5]
    assert sorted(tr.routed) == want


def test_affinity_slack_matches_jax(jax_model, jax_params, model, params):
    picks = []
    for r in (JaxRouter([JaxServeEngine(jax_model, jax_params,
                                        prefix_cache=True, **GEOM)
                         for _ in range(2)],
                        policy="prefix-affinity", affinity_slack=0),
              Router([_engine(model, params, prefix_cache=True)
                      for _ in range(2)],
                     policy="prefix-affinity", affinity_slack=0)):
        p = _prompt(20, seed=8)
        r.submit(p, 8)
        r.run()                          # replica 0 caches the prompt
        r.submit(p, 8)                   # backlog 0 vs 0: affinity
        picks.append((list(r.routed), r.pick(p), r.affinity_hits))
        r.run()
    assert picks[1] == picks[0] == ([2, 0], 1, 1)


def test_prefix_directory_matches_jax():
    from tpu_ddp.fleet import PrefixDirectory as JaxDirectory
    dirs = (PrefixDirectory(4), JaxDirectory(4))
    ops = [("record", "a", [1, 2, 3, 4, 5], 0),
           ("record", "a", [1, 2, 3, 4, 9], 2),
           ("record", "b", [1, 2, 3, 4], 1),
           ("record", "a", [1, 2, 3], 1),      # no full block: ignored
           ("candidates", "a", [1, 2, 3, 4, 7]),
           ("candidates", "c", [1, 2, 3, 4]),
           ("forget", 2), ("reindex", 0),
           ("candidates", "a", [1, 2, 3, 4]),
           ("candidates", "b", [1, 2, 3, 4])]
    got = [[], []]
    for d, out in zip(dirs, got):
        for op, *args in ops:
            out.append(getattr(d, op)(*args))
        out.append(d.stats())
    assert got[0] == got[1]
    with pytest.raises(ValueError, match="block_size"):
        PrefixDirectory(0)


def test_two_replica_fleet_no_leak_drill(jax_model, jax_params, model,
                                         params):
    """The fleet drill of tests/test_fleet.py at a smaller load: two
    disagg + prefix-cache replicas behind prefix-affinity under an
    open-system shared-prefix load. Nothing leaks or is freed twice on any
    pool, every generation is full length, and each request's tokens are
    JAX's (placement follows the wall clock; the tokens do not)."""
    kw = dict(kv_wire="bf16", prefix_cache=True)
    specs = make_shared_prefix_workload(12, model.vocab_size, seed=9,
                                        prefix_len=16, tail_len=(2, 9),
                                        max_new=(3, 9))
    greedy = [dataclasses.replace(s, temperature=0.0) for s in specs]
    out = {}
    for name, router in (
            ("port", Router([_disagg(model, params, **kw)
                             for _ in range(2)],
                            policy="prefix-affinity")),
            ("jax", JaxRouter([JaxDisagg(jax_model, jax_params, **kw,
                                         **GEOM) for _ in range(2)],
                              policy="prefix-affinity"))):
        load = run_load if name == "port" else jax_run_load
        handles, submit = [], router.submit
        router.submit = lambda *a, **k: handles.append(submit(*a, **k)) \
            or handles[-1]
        m = load(router, greedy, rate=100.0, seed=9)
        assert m["n_requests"] == len(specs)
        assert m["total_tokens"] == sum(s.max_new_tokens for s in specs)
        assert router.accounting_ok()
        for rep in router.replicas:
            assert rep.pool.free_count == rep.pool.total_usable
            held = len(rep.prefix.held_blocks())
            assert rep.prefill_pool.free_count + held \
                == rep.prefill_pool.total_usable
        assert sum(router.routed) == len(specs)
        out[name] = handles
    for i, (t, j) in enumerate(zip(out["port"], out["jax"])):
        assert t.tokens == [int(x) for x in j.tokens], i
        np.testing.assert_allclose(t.logprobs, j.logprobs, atol=1e-4,
                                   rtol=0, err_msg=f"request {i}")
