"""The prefix cache of the port (tpu_ddp_torch/fleet/prefix.py, the
refcounted pool and the scheduler's prefix-aware admission) held to the
JAX package's.

- Under one seeded sequence of submits, admissions, registrations,
  retirements and evictions, the port's index, scheduler and pool make
  the same hits, the same evictions, hand out the same block ids and hold
  the same refcounts as JAX's.
- The engine with the cache on gives the stream the port gives without
  it (bit for bit where the chunk boundaries do not move) and the JAX
  engine's with it (greedy tokens equal, logprobs within 1e-4 after the
  top-2 gap check of tests/test_torch_serve.py), with the same hit
  statistics and the prefill chunks those hits imply.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.fleet.prefix import PrefixIndex as JaxPrefixIndex
from tpu_ddp.models.transformer import make_transformer as jax_make
from tpu_ddp.ops import quant as jq
from tpu_ddp.serve import ServeEngine as JaxServeEngine
from tpu_ddp.serve.kv_pool import PagedKVPool as JaxPool
from tpu_ddp.serve.scheduler import Scheduler as JaxScheduler
from tpu_ddp_torch.convert import params_from_jax
from tpu_ddp_torch.fleet.prefix import PrefixIndex
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.serve.engine import ServeEngine
from tpu_ddp_torch.serve.kv_pool import PagedKVPool
from tpu_ddp_torch.serve.scheduler import Scheduler

BS = 8
GEOM = dict(num_slots=4, block_size=BS, prefill_chunk=8)

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


class _Req:
    def __init__(self, rid, prompt, max_new, tenant):
        self.rid, self.prompt = rid, np.asarray(prompt)
        self.max_new_tokens, self.tenant = max_new, tenant


def _state(pool, sched, index):
    return {"refs": [pool.refcount(b) for b in range(1, pool.num_blocks)],
            "free": pool.free_count, "held": sorted(index.held_blocks()),
            "stats": index.stats(),
            "slots": [None if s is None else (s.request.rid, list(s.blocks),
                                              s.prefill_done)
                      for s in sched.slots],
            "queue": [r.rid for r in sched.queue]}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_index_scheduler_and_pool_match_jax_under_seeded_ops(
        jax_model, model, seed):
    rng = np.random.default_rng(seed)
    systems = [rng.integers(0, 50, size=n) for n in (16, 24, 9)] \
        + [rng.integers(0, 50, size=int(n)) for n in rng.integers(8, 33, 5)]
    pools = (PagedKVPool(model, 16, BS, device="cpu"),
             JaxPool(jax_model, 16, BS))
    idx = (PrefixIndex(pools[0]), JaxPrefixIndex(pools[1]))
    scheds = (Scheduler(pools[0], 3, prefix=idx[0]),
              JaxScheduler(pools[1], 3, prefix=idx[1]))
    rid, live, hits = 0, [], 0
    for _ in range(300):
        op = rng.choice(["submit", "admit", "register", "retire"],
                        p=[0.3, 0.25, 0.25, 0.2])
        if op == "submit":
            sysp = systems[int(rng.integers(0, len(systems)))]
            cut = int(rng.integers(0, len(sysp) + 1))
            tail = rng.integers(0, 50, size=int(rng.integers(0, 6)))
            prompt = np.concatenate([sysp[:cut], tail]) if cut or tail.size \
                else sysp[:1]
            tenant = "a" if rng.random() < 0.8 else "b"
            for i in range(2):
                plan = idx[i].plan(prompt, ns=tenant)
                if i == 0:
                    got = (plan.blocks, plan.cached_len, plan.cow)
                else:
                    assert got == (plan.blocks, plan.cached_len, plan.cow)
            hits += bool(got[0])
            for s in scheds:
                s.enqueue(_Req(rid, prompt, int(rng.integers(1, 9)),
                               tenant))
            rid += 1
        elif op == "admit":
            got = [s.admit() for s in scheds]
            assert got[0] == got[1]
            live.extend(got[0])
        elif op == "register" and live:
            i = live[int(rng.integers(0, len(live)))]
            for s, ix in zip(scheds, idx):
                st = s.slots[i]
                ix.register(st.request.prompt, st.blocks,
                            ns=st.request.tenant)
        elif op == "retire" and live:
            i = live.pop(int(rng.integers(0, len(live))))
            for s in scheds:
                s.retire(i)
        assert _state(pools[0], scheds[0], idx[0]) == \
            _state(pools[1], scheds[1], idx[1])
        assert scheds[0].accounting_ok() and scheds[1].accounting_ok()
    st = idx[0].stats()
    assert hits > 5 and st["hit_requests"] > 5 and st["evicted"] > 0, st


def test_copy_on_write_gives_a_private_copy(model):
    pool = PagedKVPool(model, 6, BS, device="cpu")
    b = pool.alloc()
    pool.k[:, b] = 3.0
    pool.incref([b])
    new = pool.cow(b)
    assert new != b and pool.refcount(new) == 1 and pool.refcount(b) == 2
    assert torch.equal(pool.k[:, new], pool.k[:, b])
    pool.k[:, new] = 5.0
    assert float(pool.k[:, b].max()) == 3.0
    with pytest.raises(ValueError, match="incref of unallocated"):
        pool.incref([pool.num_blocks - 1])


def _workload(n_tail=6, seed=0):
    rng = np.random.default_rng(seed)
    system = rng.integers(0, 1024, size=19)
    reqs = [(system[:16], 5)]                       # copy-on-write hit
    for _ in range(n_tail):
        reqs.append((np.concatenate(
            [system, rng.integers(0, 1024, size=int(rng.integers(2, 12)))]),
            int(rng.integers(3, 8))))
    return system, reqs


def _serve(make, system, reqs):
    eng = make()
    warm = eng.submit(system, 4)
    eng.run()
    handles = [eng.submit(p, n) for p, n in reqs]
    while eng.step():
        assert eng.accounting_ok()
    return eng, warm, handles


def _top2_gap(logits):
    top = np.sort(np.asarray(logits, np.float64))[-2:]
    return top[1] - top[0]


def test_engine_with_cache_matches_uncached_and_jax(jax_model, jax_params,
                                                    model, params):
    decode_quant = "int8"
    system, reqs = _workload()
    off, _, h_off = _serve(lambda: ServeEngine(
        model, params, device="cpu", decode_quant=decode_quant, **GEOM),
        system, reqs)
    on, _, h_on = _serve(lambda: ServeEngine(
        model, params, device="cpu", decode_quant=decode_quant,
        prefix_cache=True, **GEOM), system, reqs)
    jeng, _, h_j = _serve(lambda: JaxServeEngine(
        jax_model, jax_params, decode_quant=decode_quant,
        prefix_cache=True, **GEOM), system, reqs)
    # Hits: the copy-on-write request caches 15 of its 16 tokens, the
    # others the 16 of the system prompt's two full blocks.
    assert on.prefix.stats() == jeng.prefix.stats()
    st = on.prefix.stats()
    assert st["hit_requests"] == len(reqs)
    assert st["tokens_saved"] == 15 + 16 * (len(reqs) - 1)
    # Chunks: each request prefills its uncached tail only.
    c = lambda e: e.metrics.counters["serve_prefill_chunks"]  # noqa: E731
    want_on = math.ceil(19 / 8) + 1 + sum(
        math.ceil((len(p) - 16) / 8) for p, _ in reqs[1:])
    assert c(on) == want_on
    assert c(off) == math.ceil(19 / 8) + sum(math.ceil(len(p) / 8)
                                            for p, _ in reqs)
    jtree = (jq.quantize_params(jax_model, jax_params)
             if decode_quant == "int8" else jax_params)
    for i, ((p, n), a, b, j) in enumerate(zip(reqs, h_off, h_on, h_j)):
        seq = np.concatenate([p, j.tokens[:-1]])
        logits = np.asarray(jq.decode_forward_logits(
            jax_model, jtree, jnp.asarray(seq[None], jnp.int32)))[0]
        assert min(_top2_gap(logits[len(p) - 1 + t])
                   for t in range(n)) > 1e-3
        assert b.tokens == a.tokens == [int(t) for t in j.tokens], i
        np.testing.assert_allclose(b.logprobs, j.logprobs, atol=1e-4,
                                   rtol=0)
        if i:   # hits of whole blocks keep the chunk boundaries
            assert b.logprobs == a.logprobs, i
        else:
            np.testing.assert_allclose(b.logprobs, a.logprobs, atol=1e-4,
                                       rtol=0)
    assert on.prefix_cached_len(system) == 16
    assert on.prefix_cached_len(system, tenant="other") == 0


def test_tenant_namespaces_never_share_blocks(model, params):
    system, reqs = _workload(3)
    eng = ServeEngine(model, params, device="cpu", prefix_cache=True, **GEOM)
    eng.submit(system, 3, tenant="a")
    eng.run()
    hs = [eng.submit(p, n, tenant="b") for p, n in reqs]
    eng.run()
    assert eng.prefix.stats()["hit_requests"] == 0
    ref = ServeEngine(model, params, device="cpu", **GEOM)
    want = [ref.submit(p, n) for p, n in reqs]
    ref.run()
    assert [h.tokens for h in hs] == [w.tokens for w in want]
    assert eng.accounting_ok() and eng.tenant_accounting_ok()


def test_full_cache_never_blocks_admission(model, params):
    """A pool full of cached entries: the index gives blocks back on
    demand (``allocatable`` counts them), so every request admits."""
    eng = ServeEngine(model, params, device="cpu", prefix_cache=True,
                      num_blocks=10, **GEOM)
    rng = np.random.default_rng(4)
    hs = [eng.submit(rng.integers(0, 1024, size=int(rng.integers(8, 30))),
                     3) for _ in range(12)]
    while eng.step():
        assert eng.accounting_ok()
    assert all(h.done and len(h.tokens) == 3 for h in hs)
    assert eng.prefix.stats()["evicted"] > 0
