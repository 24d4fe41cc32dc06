"""Tensor-parallel serving in the port (``ServeEngine(tp_group=...)``,
``generate(tp_group=...)``, ``quantize_params(tp=..., rank=...)``,
``from_checkpoint(param_budget_bytes=...)``) held against the JAX engine
on ``shard_decode_params``, TransformerLM-tiny, f32.

The port serves over one gloo world of 2 ranks (tests/torch_tp.py, 150 s
limit), each holding its Megatron slices of the dense parameters and
its KV / 2 heads of the pool; JAX serves the same requests on a 2-device
``mp`` mesh of the virtual devices while the ranks run. Greedy tokens
must be equal and logprobs within 1e-4 (tests/test_torch_serve.py's
bound, whose key-3 weights have no near-tie on these requests); each
rank's int8 ``q`` and ``s`` equal the slices of JAX's quantization of
the dense tree bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_tp import SERVE_WORKER, collect, launch
from tpu_ddp.models.transformer import make_transformer as jax_make
from tpu_ddp.ops import quant as jq
from tpu_ddp.parallel.tensor_parallel import \
    shard_decode_params as jax_shard
from tpu_ddp.serve import ServeEngine as JaxServeEngine
from tpu_ddp_torch.convert import cell_of, params_from_jax, params_to_jax
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.parallel.tensor_parallel import (serve_param_specs,
                                                    shard_decode_params)
from tpu_ddp_torch.utils import checkpoint as ckpt
from tpu_ddp_torch.utils.tree import keyed_leaves

GEOM = dict(num_slots=4, block_size=8, prefill_chunk=8)
CASES = [(3, 6), (11, 6), (20, 4), (9, 12)]
BUDGETS = [1, 10 ** 12]
REFUSE = [dict(spec_k=2), dict(kv_tiers=2), dict(cp_prefill="ring")]


def _prompt(L, seed=0):
    return np.random.default_rng(seed).integers(0, 1024, size=L)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("servetp")
    jm = jax_make("TransformerLM-tiny", max_seq_len=64,
                  compute_dtype=jnp.float32)
    jparams = jm.init(jax.random.key(3))
    model = make_transformer("TransformerLM-tiny", max_seq_len=64,
                             compute_dtype=torch.float32)
    params = params_from_jax(model, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    np.savez(tmp / "params.npz", **{k: v.numpy() for k, v in
                                    keyed_leaves(params, "params")})
    ckpt.save_checkpoint(str(tmp / "ckpt"), {
        "params": params_to_jax(params), "step": np.int64(0)}, step=0)
    cases = [(_prompt(L, i).tolist(), n) for i, (L, n) in enumerate(CASES)]
    handle = launch(SERVE_WORKER, 2, {
        "params": str(tmp / "params.npz"), "quants": ["none", "int8"],
        "geom": GEOM, "cases": cases, "budgets": BUDGETS,
        "ckpt": str(tmp / "ckpt"), "refuse": REFUSE,
        "out": str(tmp / "serve")})
    sharded, mesh = jax_shard(jm, jparams, jax.devices()[:2])
    want = {}
    for quant in ("none", "int8"):
        eng = JaxServeEngine(jm, sharded, mesh=mesh, decode_quant=quant,
                             **GEOM)
        reqs = [eng.submit(np.asarray(p), n) for p, n in cases]
        eng.run()
        want[quant] = [(list(map(int, r.tokens)), list(r.logprobs))
                       for r in reqs]
    dense_q = jq.quantize_params(jm, jparams)
    return collect(handle), want, model, params, dense_q


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_tp2_greedy_stream_matches_jax_engine(served, quant):
    recs, want = served[0], served[1][quant]
    for i, (toks, lps) in enumerate(want):
        for rec in recs:
            assert rec[f"{quant}/{i}/tokens"].tolist() == toks, (quant, i)
            np.testing.assert_allclose(rec[f"{quant}/{i}/logprobs"], lps,
                                       atol=1e-4, rtol=0)
    # Each rank's pool holds its KV / tp heads.
    for rec in recs:
        assert rec[f"{quant}/pool"].tolist()[3:] == [2, 32]


def test_int8_slices_equal_jax_dense_quantization_bit_for_bit(served):
    recs, model, dense_q = served[0], served[2], served[4]
    specs = serve_param_specs(model)
    for r, rec in enumerate(recs):
        for i, (bspec, blk) in enumerate(zip(specs["blocks"],
                                             dense_q["blocks"])):
            for name in ("wqkv", "wo", "w1", "w2"):
                shape = model.param_shapes()["blocks"][i][name]
                k = 2 if name == "wo" else 1
                q = np.asarray(blk[name].q).reshape(shape)
                s = np.asarray(blk[name].s).reshape(shape[k:])
                want_q = cell_of(q, bspec[name], {"mp": r}, {"mp": 2})
                want_s = cell_of(s, tuple(bspec[name])[k:], {"mp": r},
                                 {"mp": 2})
                np.testing.assert_array_equal(
                    rec[f"q/{i}/{name}/q"],
                    want_q.reshape(rec[f"q/{i}/{name}/q"].shape))
                np.testing.assert_array_equal(rec[f"q/{i}/{name}/s"],
                                              want_s.reshape(-1))
        np.testing.assert_array_equal(rec["q/head/q"],
                                      np.asarray(dense_q["head"].q))
        np.testing.assert_array_equal(rec["q/head/s"],
                                      np.asarray(dense_q["head"].s))


def test_quantized_slices_are_contiguous_tensors_of_their_own(served):
    from tpu_ddp_torch.ops.quant import quantize_params
    model, params = served[2], served[3]
    for r in range(2):
        qp = quantize_params(model, params, tp=2, rank=r)
        for blk in qp["blocks"]:
            for name in ("wqkv", "wo", "w1", "w2"):
                q, s = blk[name].q, blk[name].s
                assert q.is_contiguous() and s.is_contiguous()
                assert q.storage_offset() == 0 == s.storage_offset()
                assert q.untyped_storage().nbytes() == q.numel()


def test_generate_over_the_group_matches_the_engine(served):
    recs = served[0]
    for rec in recs:
        assert rec["generate"][0].tolist() == served[1]["none"][0][0]


def test_param_budget_routes_to_tensor_parallel(served):
    """Over the budget the engine serves over the world (tp 2), below it
    alone; the tokens are the same."""
    for rec in served[0]:
        assert int(rec["budget/1/tp"]) == 2
        assert int(rec[f"budget/{10 ** 12}/tp"]) == 1
        assert rec["budget/1/tokens"].tolist() == served[1]["none"][0][0]
        assert (rec[f"budget/{10 ** 12}/tokens"].tolist()
                == served[1]["none"][0][0])


def test_spec_tiers_and_cp_prefill_refused_under_tp(served):
    for rec in served[0]:
        for kw in REFUSE:
            msg = str(rec["refuse/" + ",".join(kw)])
            assert "item 2.6b" in msg and "tp_group" in msg


def test_shard_decode_params_refuses_as_jax():
    tm = make_transformer("TransformerLM-tiny", num_kv_heads=2,
                          compute_dtype=torch.float32)
    jm = jax_make("TransformerLM-tiny", num_kv_heads=2,
                  compute_dtype=jnp.float32)
    with pytest.raises(ValueError) as want:
        jax_shard(jm, jm.init(jax.random.key(0)), jax.devices()[:4])
    with pytest.raises(ValueError) as got:
        shard_decode_params(tm, tm.init(torch.Generator().manual_seed(0)),
                            4, 0)
    assert str(got.value) == str(want.value)
