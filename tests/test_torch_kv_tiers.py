"""The tiered KV pool of the port (tpu_ddp_torch/serve/kv_pool.py,
parallel/compress.py's page codec, serve/long_context.py) held to the
JAX package's.

- The cold-page codec equals JAX's bit for bit (int8 with round half to
  even, and the bf16 downcast).
- A block goes fresh -> hot -> cold -> spill -> hot with its pages intact.
- Under one seeded sequence of allocations, frees, promotions, device
  fetches, copies and scrubs, the port's pool gives every block the tier
  and the slot JAX's gives it, and the same page bytes.
- A bf16-cold tiered engine over a bf16 hot cache equals the single-tier
  engine bit for bit; an int8-cold three-tier engine gives the JAX tiered
  engine's stream (greedy tokens equal, logprobs within 1e-4 after the
  top-2 gap check of tests/test_torch_serve.py).
- Context-parallel prefill raises naming its ROADMAP item.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.models.transformer import make_transformer as jax_make
from tpu_ddp.ops import quant as jq
from tpu_ddp.parallel.compress import page_dequantize as jax_dequant
from tpu_ddp.parallel.compress import page_quantize as jax_quant
from tpu_ddp.serve import ServeEngine as JaxServeEngine
from tpu_ddp.serve.kv_pool import PagedKVPool as JaxPool
from tpu_ddp_torch.convert import params_from_jax
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.parallel.compress import page_dequantize, page_quantize
from tpu_ddp_torch.serve import long_context
from tpu_ddp_torch.serve.engine import ServeEngine
from tpu_ddp_torch.serve.kv_pool import PagedKVPool

BS = 8
GEOM = dict(num_slots=3, block_size=BS, prefill_chunk=8)

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
    return jax_make("TransformerLM-tiny-8k", max_seq_len=128,
                    compute_dtype=jnp.float32)


@pytest.fixture(scope="module")
def model():
    return make_transformer("TransformerLM-tiny-8k", max_seq_len=128,
                            compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def jax_params(jax_model):
    return jax_model.init(jax.random.key(3))


@pytest.fixture(scope="module")
def params(model, jax_params):
    return params_from_jax(model, jax.tree.map(np.asarray, jax_params),
                           device="cpu")


def _pages(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * rng.uniform(1e-3, 50,
                                                 size=shape[:-2] + (1, 1))
    x = x.astype(np.float32)
    x.reshape(-1, *shape[-2:])[0] = 0.0                 # an all-zero row
    flat = x.reshape(-1, shape[-2] * shape[-1])
    flat[1, 0] = 127.0                                  # scale exactly 1
    flat[1, 1] = 2.5                                    # a tie: to even
    flat[1, 2] = -0.5
    return x


@pytest.mark.parametrize("shape", [(2, 3, 8, 2, 16), (1, 4, 16, 4, 32),
                                   (5, 2, 4)])
@pytest.mark.parametrize("cold", ["int8", "bf16"])
@pytest.mark.parametrize("hot", [jnp.float32, jnp.bfloat16])
def test_page_codec_matches_jax_bit_for_bit(shape, cold, hot):
    x = _pages(shape, seed=len(shape))
    jx = jnp.asarray(x).astype(hot)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16 if hot == jnp.bfloat16 else torch.float32)
    jdt, tdt = ((jnp.int8, torch.int8) if cold == "int8"
                else (jnp.bfloat16, torch.bfloat16))
    jq_, js = jax_quant(jx, jdt)
    tq_, ts = page_quantize(tx, tdt)
    assert np.array_equal(np.asarray(jq_.astype(jnp.float32)),
                          tq_.float().numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    for out_j, out_t in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jax_dequant(jq_, js, out_j).astype(jnp.float32))
        got = page_dequantize(tq_, ts, out_t).float().numpy()
        assert np.array_equal(want, got)


def test_a_block_goes_fresh_hot_cold_spill_hot(model):
    pool = PagedKVPool(model, 10, BS, "f32", device="cpu", tiers=3,
                       cold_dtype="bf16", hbm_blocks=3, cold_blocks=3)
    a = pool.alloc()
    assert pool.tier_of(a) == "fresh"
    pool.ensure_hot([a])
    assert pool.tier_of(a) == "hot"
    page = torch.randn(pool.k[:, 0].shape).to(torch.bfloat16).float()
    pool.k[:, pool.hot_slot(a)] = page
    others = [pool.alloc() for _ in range(4)]
    pool.ensure_hot(others[:2])                   # a is the LRU victim
    assert pool.tier_of(a) == "cold"
    pool.ensure_hot(others[2:])                   # two more demotions
    assert pool.tier_of(a) == "spill"
    assert pool.moves["spill"] >= 1 and pool.tier_accounting_ok()
    with pytest.raises(RuntimeError, match="spilled to host"):
        pool.slot_tables([a], 4)
    pool.ensure_hot([a])
    assert pool.tier_of(a) == "hot"
    assert torch.equal(pool.k[:, pool.hot_slot(a)], page)
    assert all(pool.moves[k] > 0 for k in pool.moves)
    assert pool.refcount_ok([[a], others])
    pool.free([a] + others)
    assert pool.tier_counts() == {"hot": 0, "cold": 0, "spill": 0,
                                  "fresh": 0, "hot_free": 2, "cold_free": 2}


def _same_outcome(op, tp, jp):
    """Run ``op`` on both pools: both succeed, or both refuse with the same
    message (a working set the tiers cannot hold)."""
    try:
        op(tp)
    except RuntimeError as e:
        with pytest.raises(RuntimeError) as je:
            op(jp)
        assert str(je.value) == str(e)
    else:
        op(jp)


def _pool_state(pool, tiers):
    ids = range(1, pool.num_blocks)
    return {"tier": [pool.tier_of(b) for b in ids],
            "hot": [pool._hot_slot[b] for b in ids],
            "cold": [pool._cold_slot[b] for b in ids],
            "counts": pool.tier_counts(), "ok": pool.tier_accounting_ok(),
            "free": list(pool._free), "lru": (list(pool._hot_lru),
                                              list(pool._cold_lru))}


@pytest.mark.parametrize("tiers,cold", [(2, "int8"), (3, "int8"),
                                        (3, "bf16")])
@pytest.mark.parametrize("seed", [0, 1])
def test_tier_accounting_fuzz_matches_jax(jax_model, model, tiers, cold,
                                          seed):
    rng = np.random.default_rng(seed)
    kw = dict(tiers=tiers, cold_dtype=cold, hbm_blocks=5,
              cold_blocks=8 if tiers == 3 else 40)
    tp = PagedKVPool(model, 24, BS, "f32", device="cpu", **kw)
    jp = JaxPool(jax_model, 24, BS, "f32", **kw)
    live = []
    for _ in range(250):
        op = rng.choice(["alloc", "free", "hot", "device", "write", "cow",
                         "scrub"], p=[0.25, 0.15, 0.25, 0.1, 0.1, 0.05, 0.1])
        if op == "alloc" and tp.free_count:
            live.append(tp.alloc())
            assert jp.alloc() == live[-1]
        elif op == "free" and live:
            b = live.pop(int(rng.integers(0, len(live))))
            tp.free([b])
            jp.free([b])
        elif op in ("hot", "device", "scrub") and live:
            n = int(rng.integers(1, min(len(live), 4) + 1))
            pick = [live[i] for i in rng.choice(len(live), n,
                                                replace=False)]
            keep = [live[i] for i in rng.choice(len(live),
                                                min(len(live), 3),
                                                replace=False)]
            if op == "hot":
                _same_outcome(lambda p: p.ensure_hot(pick, keep=keep),
                              tp, jp)
            elif op == "device":
                _same_outcome(lambda p: p.ensure_device(pick), tp, jp)
            else:
                tp.scrub(pick)
                jp.scrub(pick)
        elif op == "write" and live:
            b = live[int(rng.integers(0, len(live)))]
            tp.ensure_hot([b])
            jp.ensure_hot([b])
            val = rng.standard_normal(tp.k[:, 0].shape).astype(np.float32)
            tp.k[:, tp.hot_slot(b)] = torch.from_numpy(val)
            jp.k = jp.k.at[:, jp.hot_slot(b)].set(jnp.asarray(val))
        elif op == "cow" and live and tp.free_count:
            b = live[int(rng.integers(0, len(live)))]
            live.append(tp.cow(b))
            assert jp.cow(b) == live[-1]
        assert _pool_state(tp, tiers) == _pool_state(jp, tiers)
        assert tp.refcount_ok([live])
    # Page bytes: bit for bit through bf16 cold pages. Through int8 ones
    # within one ulp of the scale: JAX's jitted demote lets XLA compute
    # max|x| / 127 as max|x| * (1 / 127), where the port (like JAX's
    # page_quantize outside jit, tested above) divides.
    for b in live:
        tk, _ = tp.page_arrays([b])
        jk, _ = jp.page_arrays([b])
        if cold == "bf16":
            np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        else:
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk),
                                       rtol=2.4e-7, atol=0)
    assert tp.moves["demote"] > 0


_BASE = []


def _run(model, params, **kw):
    eng = ServeEngine(model, params, device="cpu", **dict(GEOM, **kw))
    rng = np.random.default_rng(5)
    hs = [eng.submit(rng.integers(0, 1024, size=int(L)), int(n))
          for L, n in zip(rng.integers(20, 90, 5), rng.integers(4, 14, 5))]
    while eng.step():
        assert eng.accounting_ok()
    assert all(h.done and not h.quarantined for h in hs)
    assert eng.pool.free_count == eng.pool.total_usable
    return eng, hs


@pytest.mark.parametrize("spec,hbm", [
    (dict(), 3), (dict(spec_k=3), 8), (dict(spec_k=2, spec_draft="self-1"),
                                       40)])
def test_bf16_tiers_equal_the_single_tier_bit_for_bit(model, params, spec,
                                                      hbm):
    """Hot pages: 2 at k=0 (a prefill chunk's block and the decode
    frontiers evict each other, so pages demote and promote all along);
    7 for the chain window (every slot's window is hot at once); 39 for
    the fused step, which needs every live block hot (23 at this
    workload's peak) and tests the translation to hot slot ids."""
    if not _BASE:
        _BASE.extend(_run(model, params, cache_dtype="bf16")[1])
    # In eager PyTorch every speculative family gives the k=0 stream
    # (tests/test_torch_spec.py), so one single-tier run is the
    # reference for all three.
    base = _BASE
    eng, got = _run(model, params, cache_dtype="bf16", kv_tiers=3,
                    kv_cold_dtype="bf16", hbm_blocks=hbm, cold_blocks=30,
                    **spec)
    if hbm < 10:
        assert eng.pool.moves["demote"] > 0
    if not spec:
        assert eng.pool.moves["promote"] > 0
    for a, b in zip(base, got):
        assert a.tokens == b.tokens and a.logprobs == b.logprobs


def _top2_gap(logits):
    top = np.sort(np.asarray(logits, np.float64))[-2:]
    return top[1] - top[0]


def test_int8_tiered_stream_matches_the_jax_tiered_engine(
        jax_model, jax_params, model, params):
    kw = dict(kv_tiers=3, kv_cold_dtype="int8", hbm_blocks=3,
              cold_blocks=18)
    teng, th = _run(model, params, **kw)
    jeng = JaxServeEngine(jax_model, jax_params, **dict(GEOM, **kw))
    rng = np.random.default_rng(5)       # _run's draws, in its order
    lens, news = rng.integers(20, 90, 5), rng.integers(4, 14, 5)
    prompts = [rng.integers(0, 1024, size=int(L)) for L in lens]
    jh = [jeng.submit(p, int(n)) for p, n in zip(prompts, news)]
    jeng.run()
    assert teng.pool.moves["spill"] > 0 and teng.pool.moves["promote"] > 0
    for p, a, b in zip(prompts, th, jh):
        seq = np.concatenate([p, b.tokens[:-1]])
        logits = np.asarray(jq.decode_forward_logits(
            jax_model, jax_params, jnp.asarray(seq[None], jnp.int32)))[0]
        assert min(_top2_gap(logits[len(p) - 1 + t])
                   for t in range(len(b.tokens))) > 1e-3
        assert a.tokens == [int(t) for t in b.tokens]
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=1e-4, rtol=0)


def test_quarantine_scrubs_every_tier(model, params):
    eng = ServeEngine(model, params, device="cpu", kv_tiers=3,
                      hbm_blocks=4, cold_blocks=12, **GEOM)
    victim = eng.submit(np.arange(40), 8)
    other = eng.submit(np.arange(40, 70), 8)
    while not (victim.tokens and other.tokens):
        eng.step()
    s = next(s for s in eng.sched.slots if s and s.request is victim)
    blk = s.blocks[0]
    assert eng.pool.tier_of(blk) in ("cold", "spill")
    eng.pool.ensure_device([blk])
    slot = eng.pool._cold_slot[blk]
    eng.pool.cold_sv[:, slot] = float("nan")     # the int8 page's scales
    with pytest.warns(UserWarning, match="quarantined"):
        eng.run()
    assert victim.quarantined and not other.quarantined
    assert len(other.tokens) == 8
    assert bool(torch.isfinite(eng.pool.cold_sv).all())
    assert eng.accounting_ok()


def test_context_parallel_prefill_raises_naming_its_item(model, params):
    """Context-parallel prefill is ported (tests/test_torch_cp_prefill.py)
    and, as in the JAX engine, refuses a tiered pool: the sharded chunk
    step scatters through the logical table. An unknown mode raises."""
    with pytest.raises(ValueError, match="expected 'ring' or 'ulysses'"):
        long_context.cp_prefill_step(
            model, 8, params, None, None, None,
            torch.zeros(1, 8, dtype=torch.long), 0, 8, None, None,
            mode="zigzag")
    with pytest.raises(ValueError, match="requires the single-tier pool"):
        ServeEngine(model, params, device="cpu", kv_tiers=2,
                    cp_prefill="ulysses", **GEOM)
