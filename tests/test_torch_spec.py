"""Speculative decoding in the port (tpu_ddp_torch/serve/speculative.py)
held to the JAX package's and to the port's own k=0 stream.

- The accept rule and the ``spec_draft`` grammar equal JAX's.
- ``chain`` equals the port's k=0 stream bit for bit (tokens and
  logprobs), greedy and sampled, at k in {1, 3, 6}.
- The fused families (``self-1``, ``quant``) give the JAX engine's greedy
  stream: tokens equal, logprobs within 1e-4, after checking that the
  JAX logits' top-2 gap exceeds 1e-3 at every emitted step (as
  tests/test_torch_serve.py does). In eager PyTorch they also equal the
  port's k=0 stream bit for bit.
- EOS inside a window emits exactly the k=0 prefix; the pool and the
  speculation ledger balance after every step; every duplicate write
  target of a step is the null block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.models.transformer import make_transformer as jax_make
from tpu_ddp.ops import quant as jq
from tpu_ddp.serve import ServeEngine as JaxServeEngine
from tpu_ddp.serve.speculative import accept_length as jax_accept
from tpu_ddp.serve.speculative import parse_spec_draft as jax_parse
from tpu_ddp_torch.convert import params_from_jax
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.serve import engine as se
from tpu_ddp_torch.serve.speculative import accept_length, parse_spec_draft

GEOM = dict(num_slots=4, block_size=8, prefill_chunk=8)
CASES = [(3, 6), (8, 6), (11, 6), (20, 4), (9, 12), (17, 5)]

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
    # Key 3: every greedy step of CASES has a top-2 gap > 2e-3 on both
    # the fp and the int8 tree (tests/test_torch_serve.py).
    return jax_model.init(jax.random.key(3))


@pytest.fixture(scope="module")
def params(model, jax_params):
    return params_from_jax(model, jax.tree.map(np.asarray, jax_params),
                           device="cpu")


def _prompt(L, seed=0):
    return np.random.default_rng(seed).integers(0, 1024, size=L)


_BASE = {}


def _k0(model, params, temps=None, decode_quant="none"):
    """The port's k=0 stream of CASES, once per (temperatures, quant)."""
    key = (tuple(temps or ()), decode_quant)
    if key not in _BASE:
        _BASE[key] = _run(model, params, temps,
                          decode_quant=decode_quant)[1]
    return _BASE[key]


def _run(model, params, temps=None, check=True, **kw):
    eng = se.ServeEngine(model, params, device="cpu", **dict(GEOM, **kw))
    reqs = [eng.submit(_prompt(L, i), n,
                       temperature=temps[i] if temps else 0.0, seed=i)
            for i, (L, n) in enumerate(CASES)]
    while eng.step():
        if check:
            assert eng.accounting_ok()
            for r in reqs:
                assert r.spec_proposed == r.spec_accepted + r.spec_rejected
    assert eng.pool.free_count == eng.pool.total_usable
    return eng, reqs


@pytest.mark.parametrize("drafted,target,k", [
    ([1, 2, 3], [1, 2, 3, 4], 3), ([1, 2, 3], [1, 9, 3, 4], 3),
    ([5, 2, 3], [1, 2, 3, 4], 3), ([7], [7, 8], 1), ([7], [6, 8], 1),
    ([4, 4, 4, 4, 4, 4], [4, 4, 4, 4, 4, 0, 0], 6),
    ([1, 2], [1, 2, 3], 0)])
def test_accept_length_matches_jax(drafted, target, k):
    want = jax_accept(np.asarray(drafted), np.asarray(target), k)
    assert accept_length(np.asarray(drafted), np.asarray(target), k) == want
    assert accept_length(torch.as_tensor(drafted),
                         torch.as_tensor(target), k) == want


@pytest.mark.parametrize("spec", ["chain", "quant", "self-1", "self-12",
                                  " chain ", "self-0", "self-", "self-x",
                                  "self-1.5", "Chain", "medusa", ""])
def test_parse_spec_draft_matches_jax(spec):
    try:
        want = jax_parse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_spec_draft(spec)
        assert str(got.value) == str(e)
    else:
        assert parse_spec_draft(spec) == want


@pytest.mark.parametrize("k", [1, 3, 6])
@pytest.mark.parametrize("sampled", [False, True])
def test_chain_equals_k0_bit_for_bit(model, params, k, sampled):
    temps = [0.0, 0.9, 1.3, 0.0, 0.7, 0.5] if sampled else None
    base = _k0(model, params, temps)
    eng, got = _run(model, params, temps, spec_k=k, spec_draft="chain")
    for a, b in zip(base, got):
        assert a.tokens == b.tokens and a.logprobs == b.logprobs
    st = eng.spec_stats()
    assert st["acceptance"] == 1.0
    assert st["proposed"] == st["accepted"] + st["rejected"] > 0


def _top2_gap(logits):
    top = np.sort(np.asarray(logits, np.float64))[-2:]
    return top[1] - top[0]


@pytest.mark.parametrize("draft,decode_quant", [("self-1", "int8"),
                                                ("quant", "none")])
def test_fused_stream_matches_the_jax_engine(jax_model, jax_params, model,
                                             params, draft, decode_quant):
    jeng = JaxServeEngine(jax_model, jax_params, spec_k=3, spec_draft=draft,
                          decode_quant=decode_quant, **GEOM)
    jreqs = [jeng.submit(_prompt(L, i), n) for i, (L, n) in enumerate(CASES)]
    jeng.run()
    teng, treqs = _run(model, params, spec_k=3, spec_draft=draft,
                       decode_quant=decode_quant)
    jtree = (jq.quantize_params(jax_model, jax_params)
             if decode_quant == "int8" else jax_params)
    for i, ((L, n), jr, tr) in enumerate(zip(CASES, jreqs, treqs)):
        seq = np.concatenate([_prompt(L, i), jr.tokens[:-1]])
        logits = np.asarray(jq.decode_forward_logits(
            jax_model, jtree, jnp.asarray(seq[None], jnp.int32)))[0]
        assert min(_top2_gap(logits[L - 1 + t]) for t in range(n)) > 1e-3
        assert tr.tokens == [int(t) for t in jr.tokens], i
        np.testing.assert_allclose(tr.logprobs, jr.logprobs, atol=1e-4,
                                   rtol=0, err_msg=f"request {i}")
    js, ts = jeng.spec_stats(), teng.spec_stats()
    assert ts["proposed"] == ts["accepted"] + ts["rejected"]
    assert (ts["proposed"], ts["accepted"]) == (js["proposed"],
                                                js["accepted"])
    # In eager PyTorch every accepted column is the k=0 step's own
    # computation: the fused stream equals the port's k=0 stream too.
    base = _k0(model, params, decode_quant=decode_quant)
    for a, b in zip(base, treqs):
        assert a.tokens == b.tokens and a.logprobs == b.logprobs


@pytest.mark.parametrize("kw", [dict(spec_k=3, spec_draft="chain"),
                                dict(spec_k=3, spec_draft="self-1"),
                                dict(spec_k=5, spec_draft="quant")])
def test_eos_inside_a_window_emits_exactly_the_k0_prefix(model, params, kw):
    for i, r in enumerate(_k0(model, params)):
        eos = r.tokens[2]
        first = r.tokens.index(eos)
        eng = se.ServeEngine(model, params, device="cpu", **dict(GEOM, **kw))
        got = eng.submit(_prompt(CASES[i][0], i), CASES[i][1], eos_id=eos,
                         seed=i)
        while eng.step():
            assert eng.accounting_ok()
        assert got.done and got.tokens == r.tokens[:first + 1]
        assert got.logprobs == r.logprobs[:first + 1]
        assert eng.pool.free_count == eng.pool.total_usable


@pytest.mark.parametrize("draft", ["self-1", "quant"])
def test_rollback_balances_the_pool_after_every_step(model, params, draft):
    """Many requests through a pool too small for all at once: rejected
    columns' tail blocks come back every step and nothing leaks."""
    eng = se.ServeEngine(model, params, device="cpu", num_blocks=14,
                         spec_k=4, spec_draft=draft, **GEOM)
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(0, 1024, size=int(rng.integers(1, 20))),
                       int(rng.integers(1, 12)),
                       temperature=float(rng.choice([0.0, 1.0])), seed=j)
            for j in range(20)]
    while eng.step():
        assert eng.accounting_ok()
        for s in eng.sched.slots:
            if s is not None and s.phase == "decode":
                # Trimmed: no block beyond the one holding position length.
                assert len(s.blocks) <= s.length // 8 + 1
    assert all(r.done and len(r.tokens) == r.max_new_tokens for r in reqs)
    assert eng.pool.free_count == eng.pool.total_usable
    st = eng.spec_stats()
    assert st["proposed"] == st["accepted"] + st["rejected"]
    assert st["rejected"] > 0


@pytest.mark.parametrize("kw", [dict(), dict(spec_k=4, spec_draft="chain"),
                                dict(spec_k=4, spec_draft="self-1"),
                                dict(kv_tiers=2, hbm_blocks=6)])
def test_duplicate_writes_land_only_in_the_null_block(model, params,
                                                      monkeypatch, kw):
    """Idle rows, prefill padding and speculative columns past a request's
    budget all write somewhere; ``index_put_`` lets an unspecified write
    win among duplicates, so every duplicate target must be the null
    block."""
    seen = {"dups": 0, "masked": 0}
    real = se.write_slots

    def checked(tables, pos, block_size, limits=None):
        bidx, off = real(tables, pos, block_size, limits)
        pairs = list(zip(bidx.reshape(-1).tolist(), off.reshape(-1).tolist()))
        seen["masked"] += sum(b == 0 for b, _ in pairs)
        for pair in set(pairs):
            if pairs.count(pair) > 1:
                seen["dups"] += 1
                assert pair[0] == 0, f"duplicate write to block {pair[0]}"
        return bidx, off

    monkeypatch.setattr(se, "write_slots", checked)
    eng = se.ServeEngine(model, params, device="cpu", **dict(GEOM, **kw))
    for i, (L, n) in enumerate(CASES):
        eng.submit(_prompt(L, i), n, seed=i)
    eng.run()
    assert seen["masked"] > 0 and seen["dups"] > 0
