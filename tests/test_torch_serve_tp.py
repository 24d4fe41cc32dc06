"""Tensor-parallel serving in the port (``ServeEngine(tp_group=...)``,
``generate(tp_group=...)``, ``quantize_params(tp=..., rank=...)``,
``from_checkpoint(param_budget_bytes=...)``) held against the JAX engine
on ``shard_decode_params``, TransformerLM-tiny, f32.

The port serves over one gloo world of 2 ranks (tests/torch_tp.py, 150 s
limit), each holding its Megatron slices of the dense parameters and
its KV / 2 heads of the pool; JAX serves the same requests on a 2-device
``mp`` mesh of the virtual devices while the ranks run: plain, int8,
speculative (k = 2, each draft family) and tiered (two tiers with bf16
and int8 cold pages, three tiers). Greedy tokens must be equal and
logprobs within 1e-4 (tests/test_torch_serve.py's bound, whose key-3
weights have no near-tie on these requests), and the speculative
counters equal; each rank's int8 ``q`` and ``s`` equal the slices of
JAX's quantization of the dense tree bit for bit, and each rank's int8
cold pages and their per-row scales equal JAX's ``page_quantize`` of the
full-head pages bit for bit (after a demotion, and after a spill and
back).

Context-parallel prefill under tp runs on a second world of 4 ranks (sp
2 x tp 2, 120 s limit), ring and Ulysses, held to the JAX engine on
``make_mesh(dp=1, sp=2, mp=2)`` with the parameters placed by
``serve_param_specs`` (JAX takes that mesh).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.sharding import NamedSharding

from torch_tp import CP_WORKER, SERVE_WORKER, collect, launch
from tpu_ddp.models.transformer import make_transformer as jax_make
from tpu_ddp.ops import quant as jq
from tpu_ddp.parallel.compress import page_quantize as jax_page_quantize
from tpu_ddp.parallel.mesh import make_mesh
from tpu_ddp.parallel.tensor_parallel import \
    serve_param_specs as jax_serve_specs
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
# Engine settings served at tp 2 beside the JAX engine: the speculative
# families at k = 2, and the tiered pool with 4 hot pages (every slot's
# frontier hot, older pages demoted and read through the dequant). The
# spill to the host and back is held below, on known pages: these short
# requests keep every cold page of a live slot protected.
RUNS = {
    "chain": dict(spec_k=2, spec_draft="chain"),
    "self1": dict(spec_k=2, spec_draft="self-1"),
    "quant": dict(spec_k=2, spec_draft="quant"),
    "tiers2_bf16": dict(kv_tiers=2, kv_cold_dtype="bf16", hbm_blocks=5),
    "tiers2_int8": dict(kv_tiers=2, kv_cold_dtype="int8", hbm_blocks=5),
    "tiers3_int8": dict(kv_tiers=3, kv_cold_dtype="int8", hbm_blocks=5,
                        cold_blocks=4),
}


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
    np.savez(tmp / "pages.npz", k=_pages(11), v=_pages(12))
    handle = launch(SERVE_WORKER, 2, {
        "params": str(tmp / "params.npz"), "quants": ["none", "int8"],
        "geom": GEOM, "cases": cases, "budgets": BUDGETS,
        "ckpt": str(tmp / "ckpt"), "runs": RUNS,
        "pages": str(tmp / "pages.npz"), "out": str(tmp / "serve")})
    sharded, mesh = jax_shard(jm, jparams, jax.devices()[:2])
    want = {}
    for name, kw in [(q, dict(decode_quant=q)) for q in ("none", "int8")] \
            + list(RUNS.items()):
        eng = JaxServeEngine(jm, sharded, mesh=mesh, **GEOM, **kw)
        reqs = [eng.submit(np.asarray(p), n) for p, n in cases]
        eng.run()
        st = eng.spec_stats()
        want[name] = [(list(map(int, r.tokens)), list(r.logprobs))
                      for r in reqs]
        want[f"{name}/spec"] = [st[k] for k in ("proposed", "accepted",
                                                "rejected")]
    dense_q = jq.quantize_params(jm, jparams)
    return collect(handle), want, model, params, dense_q, tmp


def _pages(seed):
    """Full-head KV pages (layers, 2 blocks, block_size, KV, hd) whose
    heads differ in scale row by row, numpy-seeded."""
    rng = np.random.default_rng(seed)
    shape = (2, 2, GEOM["block_size"], 4, 32)
    return (rng.standard_normal(shape) * rng.uniform(
        1e-2, 10, size=shape[:-1] + (1,))).astype(np.float32)


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


@pytest.mark.parametrize("name", list(RUNS))
def test_tp2_spec_and_tiers_match_jax_engine(served, name):
    """Each draft family and each tiered pool at tp 2: the JAX engine's
    greedy stream and speculative counters on every rank; the tiered
    pools really demote."""
    recs, want = served[0], served[1]
    for i, (toks, lps) in enumerate(want[name]):
        for rec in recs:
            assert rec[f"{name}/{i}/tokens"].tolist() == toks, (name, i)
            np.testing.assert_allclose(rec[f"{name}/{i}/logprobs"], lps,
                                       atol=1e-4, rtol=0)
    for rec in recs:
        assert rec[f"{name}/spec"].tolist() == want[f"{name}/spec"]
        moves = dict(zip(("promote", "demote", "spill", "unspill"),
                         rec[f"{name}/moves"].tolist()))
        if name.startswith("tiers"):
            assert moves["demote"] > 0, moves
    # Every stream is the plain stream (k = 0, one tier): speculation and
    # these cold pages change no greedy token here.
    assert [t for t, _ in want[name]] == [t for t, _ in want["none"]]


def test_cold_tier_scales_equal_jax_bit_for_bit(served):
    """Each rank's int8 cold pages of known full-head pages, after a
    demotion and after a spill to the host and back, are JAX's
    ``page_quantize`` of the full-head pages cut to the rank's heads,
    scales (one per token row, over every head) bit for bit. A rank
    that took the row max over its own heads only would not be."""
    recs, tmp = served[0], served[5]
    pages = np.load(tmp / "pages.npz")
    want = {}
    for kv in ("k", "v"):
        q, s = jax_page_quantize(jnp.asarray(pages[kv]), jnp.int8)
        want[kv] = (np.asarray(q), np.asarray(s))
    for r, rec in enumerate(recs):
        assert rec["cold/spilled"].all()
        heads = slice(2 * r, 2 * r + 2)
        for when in ("demoted", "unspilled"):
            for kv in ("k", "v"):
                q, s = want[kv]
                np.testing.assert_array_equal(
                    rec[f"cold/{when}/cold_{kv}"], q[..., heads, :])
                np.testing.assert_array_equal(
                    rec[f"cold/{when}/cold_s{kv}"], s)
        assert not np.array_equal(rec["cold/local_sk"], want["k"][1])


@pytest.fixture(scope="module")
def cp_served(served):
    """The sp 2 x tp 2 world's cp-prefill streams and the JAX engine's
    on make_mesh(dp=1, sp=2, mp=2)."""
    tmp = served[5]
    cases = [(_prompt(L, i).tolist(), n) for i, (L, n) in enumerate(CASES)]
    handle = launch(CP_WORKER, 4, {
        "params": str(tmp / "params.npz"), "geom": GEOM, "cases": cases,
        "out": str(tmp / "cp")})
    jm = jax_make("TransformerLM-tiny", max_seq_len=64,
                  compute_dtype=jnp.float32)
    jparams = jm.init(jax.random.key(3))
    mesh = make_mesh(jax.devices()[:4], dp=1, sp=2, mp=2)
    placed = jax.tree.map(
        lambda s, x: jax.device_put(x, NamedSharding(mesh, s)),
        jax_serve_specs(jm), jparams,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    want = {}
    for mode in ("ring", "ulysses"):
        eng = JaxServeEngine(jm, placed, mesh=mesh, cp_prefill=mode, **GEOM)
        reqs = [eng.submit(np.asarray(p), n) for p, n in cases]
        eng.run()
        want[mode] = [(list(map(int, r.tokens)), list(r.logprobs))
                      for r in reqs]
    return collect(handle, timeout=120), want


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_cp_prefill_under_tp_matches_jax_engine(cp_served, mode):
    """Context-parallel prefill over sp 2 with every rank in a tp 2
    group: each rank projects its C/2 rows on its 2 heads; the streams
    are the JAX engine's on the sp x mp mesh, on every rank."""
    recs, want = cp_served
    for i, (toks, lps) in enumerate(want[mode]):
        for rec in recs:
            assert rec[f"{mode}/{i}/tokens"].tolist() == toks, (mode, i)
            np.testing.assert_allclose(rec[f"{mode}/{i}/logprobs"], lps,
                                       atol=1e-4, rtol=0)
    for rec in recs:
        assert rec[f"{mode}/pool"].tolist()[3:] == [2, 32]


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
