"""The port's load generator (tpu_ddp_torch/serve/loadgen.py) held to the
JAX package's: seeded workloads, arrivals and traces equal JAX's exactly,
and ``run_load``, ``run_trace`` and ``calibrate_rate`` drive the port's
engine and report the JAX function's fields."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.models.transformer import make_transformer as jax_make
from tpu_ddp.serve import ServeEngine as JaxServeEngine
from tpu_ddp.serve import loadgen as jlg
from tpu_ddp_torch.convert import params_from_jax
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.serve import loadgen as tlg
from tpu_ddp_torch.serve.engine import ServeEngine

GEOM = dict(num_slots=4, block_size=8, prefill_chunk=8)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test files run in parallel worker processes; torch's own thread
    pool on top of them oversubscribes the cores (its threads spin), and
    these tiny shapes gain nothing from it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _as_tuple(spec):
    return dataclasses.astuple(spec)


@pytest.mark.parametrize("kw", [dict(), dict(prompt_len=(10, 40),
                                             max_new=(2, 5),
                                             temperature=0.7)])
@pytest.mark.parametrize("seed", [0, 7])
def test_workloads_equal_jax(kw, seed):
    pairs = [(tlg.make_workload(12, 1024, seed=seed, **kw),
              jlg.make_workload(12, 1024, seed=seed, **kw)),
             (tlg.make_shared_prefix_workload(9, 1024, seed=seed,
                                              prefix_len=24),
              jlg.make_shared_prefix_workload(9, 1024, seed=seed,
                                              prefix_len=24)),
             (tlg.make_long_prompt_workload(3, 1024, seed=seed,
                                            prompt_len=300),
              jlg.make_long_prompt_workload(3, 1024, seed=seed,
                                            prompt_len=300))]
    for got, want in pairs:
        assert [_as_tuple(s) for s in got] == [_as_tuple(s) for s in want]


@pytest.mark.parametrize("rate,seed", [(0.5, 0), (40.0, 3)])
def test_poisson_arrivals_equal_jax(rate, seed):
    np.testing.assert_array_equal(tlg.poisson_arrivals(50, rate, seed),
                                  jlg.poisson_arrivals(50, rate, seed))


def test_traces_equal_jax():
    kw = dict(duration_s=30.0, base_rate=1.0, peak_rate=6.0,
              vocab_size=1024, seed=5, tenant_mix={"a": 2.0, "b": 1.0},
              flash_crowds=((10.0, 12.0, 3.0),), shared_prefix_len=12)
    got, want = tlg.make_trace(**kw), jlg.make_trace(**kw)
    assert len(got) == len(want) > 20
    assert [(e.at_s, _as_tuple(e.spec)) for e in got] == \
        [(e.at_s, _as_tuple(e.spec)) for e in want]
    for t in (0.0, 7.5, 11.0, 29.9):
        assert tlg.diurnal_rate(t, 30.0, 1.0, 6.0, ((10, 12, 3.0),)) == \
            jlg.diurnal_rate(t, 30.0, 1.0, 6.0, ((10, 12, 3.0),))
    for bad in (dict(duration_s=0), dict(base_rate=7.0),
                dict(flash_crowds=((3.0, 1.0, 2.0),)),
                dict(tenant_mix={"a": -1.0})):
        with pytest.raises(ValueError) as terr:
            tlg.make_trace(**dict(kw, **bad))
        with pytest.raises(ValueError) as jerr:
            jlg.make_trace(**dict(kw, **bad))
        assert str(terr.value) == str(jerr.value)


def test_atomic_cutover_check_matches_jax():
    class H:
        def __init__(self, toks, vers):
            self.rid, self.tokens, self.token_versions = 0, toks, vers

    for hs in ([H([1, 2], [0, 1])], [H([1, 2], [1, 0])], [H([1, 2], [0])]):
        try:
            jlg.assert_atomic_cutover(hs)
        except AssertionError as e:
            with pytest.raises(AssertionError) as got:
                tlg.assert_atomic_cutover(hs)
            assert str(got.value) == str(e)
        else:
            tlg.assert_atomic_cutover(hs)


@pytest.fixture(scope="module")
def engines():
    jm = jax_make("TransformerLM-tiny", max_seq_len=64,
                  compute_dtype=jnp.float32)
    tm = make_transformer("TransformerLM-tiny", max_seq_len=64,
                          compute_dtype=torch.float32)
    jp = jm.init(jax.random.key(3))
    tp = params_from_jax(tm, jax.tree.map(np.asarray, jp), device="cpu")
    return (lambda **kw: ServeEngine(tm, tp, device="cpu",
                                     **dict(GEOM, **kw)),
            lambda **kw: JaxServeEngine(jm, jp, **dict(GEOM, **kw)))


def test_run_load_reports_the_jax_fields(engines):
    specs = tlg.make_workload(6, 1024, seed=2)
    rate = tlg.calibrate_rate(engines[0], specs)
    assert rate > 0
    got = tlg.run_load(engines[0](), specs, 2 * rate, seed=1,
                       slo_ttft_ms=1e4)
    want = jlg.run_load(engines[1](), jlg.make_workload(6, 1024, seed=2),
                        2 * rate, seed=1, slo_ttft_ms=1e4)
    assert sorted(got) == sorted(want)
    for key in ("n_requests", "n_completed", "n_shed", "n_cancelled",
                "total_tokens", "accounting_ok", "slo_attained",
                "param_version_min", "param_version_max"):
        assert got[key] == want[key], key
    assert got["n_completed"] == 6 and got["accounting_ok"]
    assert got["ttft_p50_ms"] <= got["ttft_p99_ms"]
    assert got["tpot_p50_ms"] is not None and got["makespan_s"] > 0


def test_run_trace_reports_the_jax_fields(engines):
    kw = dict(duration_s=2.0, base_rate=4.0, peak_rate=10.0,
              vocab_size=1024, seed=1, tenant_mix={"gold": 1.0, "x": 1.0},
              prompt_len=(4, 12), max_new=(2, 6))
    classes = "gold=3,x=1"
    got = tlg.run_trace(engines[0](tenant_classes=classes),
                        tlg.make_trace(**kw), slo_ttft_ms=1e4,
                        class_weights={"gold": 3})
    want = jlg.run_trace(engines[1](tenant_classes=classes),
                         jlg.make_trace(**kw), slo_ttft_ms=1e4,
                         class_weights={"gold": 3})
    assert sorted(got) == sorted(want)
    assert sorted(got["tenants"]) == sorted(want["tenants"])
    for name, t in got["tenants"].items():
        assert sorted(t) == sorted(want["tenants"][name])
        for key in ("submitted", "completed", "shed", "total_tokens"):
            assert t[key] == want["tenants"][name][key], (name, key)
    assert got["accounting_ok"] and got["tenant_accounting_ok"]
    assert got["slo_inversions"] == want["slo_inversions"] == 0
