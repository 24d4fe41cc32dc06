"""Tenant classes in the port (tpu_ddp_torch/serve/scheduler.py and the
engine's shedding and per-tenant ledger) held to the JAX package's.

- ``parse_tenant_classes`` accepts what JAX accepts and refuses the rest
  with JAX's message.
- Weighted fair queueing (stride scheduling), token budgets and the
  reservation rule admit the same requests into the same slots as JAX's
  scheduler under one seeded sequence of submits, admissions and
  retirements.
- Deadline shedding under a fake clock, the bounded queue (lowest class
  evicted first) and the per-tenant identity completed + cancelled + shed
  + in flight == submitted follow the JAX engine step for step.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.models.transformer import make_transformer as jax_make
from tpu_ddp.serve import ServeEngine as JaxServeEngine
from tpu_ddp.serve.kv_pool import PagedKVPool as JaxPool
from tpu_ddp.serve.scheduler import Scheduler as JaxScheduler
from tpu_ddp.serve.scheduler import parse_tenant_classes as jax_parse
from tpu_ddp_torch.convert import params_from_jax
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.serve.engine import ServeEngine
from tpu_ddp_torch.serve.kv_pool import PagedKVPool
from tpu_ddp_torch.serve.scheduler import Scheduler, parse_tenant_classes

GEOM = dict(num_slots=3, block_size=8, prefill_chunk=8)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test files run in parallel worker processes; torch's own thread
    pool on top of them oversubscribes the cores (its threads spin), and
    these tiny shapes gain nothing from it."""
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
    return jax_model.init(jax.random.key(3))


@pytest.fixture(scope="module")
def params(model, jax_params):
    return params_from_jax(model, jax.tree.map(np.asarray, jax_params),
                           device="cpu")


@pytest.mark.parametrize("spec", [
    "", None, "gold=3", "gold=3,bronze=1", " gold = 3 , bronze=1:250 ",
    "a=1:0:400", "a=2::100", "a=1:5.5", ",a=1,,", "gold", "=3", "a=0",
    "a=-1", "a=x", "a=1:y", "a=1:2:z", "a=1:2:3:4", "a=1,a=2", "a=1:-5",
    "a=1:0:-1", "a=1.5"])
def test_parse_tenant_classes_matches_jax(spec):
    try:
        want = jax_parse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_tenant_classes(spec)
        assert str(got.value) == str(e)
        return
    got = parse_tenant_classes(spec)
    assert {k: (c.name, c.weight, c.deadline_ms, c.token_budget)
            for k, c in got.items()} == \
        {k: (c.name, c.weight, c.deadline_ms, c.token_budget)
         for k, c in want.items()}


class _Req:
    def __init__(self, rid, plen, max_new, tenant):
        self.rid, self.prompt = rid, np.zeros(plen, np.int32)
        self.max_new_tokens, self.tenant = max_new, tenant


@pytest.mark.parametrize("classes", ["gold=3,bronze=1,batch=1",
                                     "gold=3:0:60,bronze=1:0:40,batch=2"])
@pytest.mark.parametrize("seed", [0, 1])
def test_wfq_admission_matches_the_jax_scheduler(jax_model, model, classes,
                                                 seed):
    """Same seeded submits, admissions and retirements through both
    schedulers: the same slots fill with the same requests in the same
    order, token budgets included."""
    rng = np.random.default_rng(seed)
    tenants = ("gold", "bronze", "batch", "other")
    pools = (PagedKVPool(model, 30, 8, device="cpu"),
             JaxPool(jax_model, 30, 8))
    scheds = (Scheduler(pools[0], 4, tenants=parse_tenant_classes(classes)),
              JaxScheduler(pools[1], 4, tenants=jax_parse(classes)))
    order = ([], [])
    for rid in range(60):
        req = _Req(rid, int(rng.integers(1, 30)), int(rng.integers(1, 20)),
                   tenants[int(rng.choice(4, p=[0.3, 0.3, 0.3, 0.1]))])
        for s in scheds:
            s.enqueue(req)
        if rng.random() < 0.5:
            for s, o in zip(scheds, order):
                o.extend((i, s.slots[i].request.rid) for i in s.admit())
        live = [i for i, s in enumerate(scheds[0].slots) if s is not None]
        if live and rng.random() < 0.4:
            i = live[int(rng.integers(0, len(live)))]
            for s in scheds:
                s.retire(i)
        assert order[0] == order[1]
        assert [r.rid for r in scheds[0].queue] == \
            [r.rid for r in scheds[1].queue]
        assert scheds[0]._tenant_pass == scheds[1]._tenant_pass
    assert len(order[0]) > 20
    rids = [r for _, r in order[0]]
    assert rids != sorted(rids)   # weighted fair, not FIFO


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _engines(jax_model, jax_params, model, params, **kw):
    return (ServeEngine(model, params, device="cpu", **dict(GEOM, **kw)),
            JaxServeEngine(jax_model, jax_params, **dict(GEOM, **kw)))


def test_deadline_shedding_under_a_fake_clock(jax_model, jax_params, model,
                                              params, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    engs = _engines(jax_model, jax_params, model, params, shed_ms=50.0,
                    tenant_classes="gold=3,batch=1:10")
    rng = np.random.default_rng(0)
    plan = [(rng.integers(0, 1024, size=int(rng.integers(4, 20))),
             int(rng.integers(2, 6)), ("gold", "batch", "x")[i % 3])
            for i in range(12)]
    handles = ([], [])
    for step in range(40):
        if step < 12:
            p, n, t = plan[step]
            for e, h in zip(engs, handles):
                h.append(e.submit(p, n, tenant=t))
        clock.t += 0.006        # 6 ms per engine step
        for e in engs:
            e.step()
        for a, b in zip(*handles):
            assert (a.shed, a.done, a.tokens) == (b.shed, b.done, b.tokens)
        assert engs[0].tenant_counts == engs[1].tenant_counts
        assert engs[0].tenant_accounting_ok()
    shed = [h.tenant for h in handles[0] if h.shed]
    assert "batch" in shed and shed.count("gold") < shed.count("batch")


def test_queue_limit_sheds_the_lowest_class_first(jax_model, jax_params,
                                                  model, params):
    engs = _engines(jax_model, jax_params, model, params, queue_limit=4,
                    tenant_classes="gold=3,bronze=1")
    rng = np.random.default_rng(1)
    handles = ([], [])
    for i in range(14):
        p = rng.integers(0, 1024, size=6)
        t = ("bronze", "gold", "bronze", "x")[i % 4]
        for e, h in zip(engs, handles):
            h.append(e.submit(p, 3, tenant=t))
    door = [[h.rid for h in hs if h.shed] for hs in handles]
    assert door[0] == door[1] and len(door[0]) == 10
    # Gold outranks everyone else: it evicts and is never shed.
    assert not any(handles[0][r].tenant == "gold" for r in door[0])
    for e in engs:
        e.run()
    assert engs[0].tenant_counts == engs[1].tenant_counts
    assert engs[0].tenant_accounting_ok()


def test_per_tenant_accounting_follows_jax(jax_model, jax_params, model,
                                           params):
    engs = _engines(jax_model, jax_params, model, params,
                    tenant_classes="a=2:0:40,b=1", queue_limit=6)
    rng = np.random.default_rng(2)
    handles = ([], [])
    for step in range(60):
        if rng.random() < 0.5:
            p = rng.integers(0, 1024, size=int(rng.integers(2, 24)))
            n, t = int(rng.integers(1, 8)), ("a", "b", "c")[
                int(rng.integers(0, 3))]
            for e, h in zip(engs, handles):
                h.append(e.submit(p, n, tenant=t))
        if handles[0] and rng.random() < 0.15:
            i = int(rng.integers(0, len(handles[0])))
            assert engs[0].cancel(handles[0][i]) == \
                engs[1].cancel(handles[1][i])
        for e in engs:
            e.step()
        assert engs[0].tenant_counts == engs[1].tenant_counts
        assert all(e.tenant_accounting_ok() for e in engs)
        assert engs[0].outstanding_by_tenant() == \
            engs[1].outstanding_by_tenant()
        for a, b in zip(*handles):
            assert a.tokens == [int(t) for t in b.tokens]
    for e in engs:
        e.run()
    assert engs[0].tenant_stats() == engs[1].tenant_stats()
    drained = engs[0].drain()
    assert drained == [] and engs[0].tenant_accounting_ok()
