"""Context-parallel chunked prefill in the port
(tpu_ddp_torch/serve/long_context.py ``cp_prefill_step``,
``ServeEngine(cp_prefill=..., sp_group=...)``), held against the port's
single-rank engine and the JAX engine: the counterpart of
tests/test_long_context.py's ``TestCPPrefill``.

The sharded engines run over 2 gloo ranks (one subprocess per rank, 150 s
limit), in lockstep on the same requests: TransformerLM-tiny, f32, the
JAX test's geometry (4 slots, blocks of 8, chunks of 8) and its cases (a
29-token prompt, three full chunks and a ragged 5-token tail, and an
8-token one).

Tolerances: greedy token streams equal, on every rank, to the port's
single-rank engine's and the JAX engine's; logprobs within 1e-4 of the
single-rank port engine's (the ring and the Ulysses cache path sum the
softmax online, the single-rank step over the whole cache view). Under
``decode_quant="int8"`` (the int8 matmul on each rank's C/sp rows, its
plain version on the CPU) the ring's stream equals the single-rank int8
engine's. The rejected combinations raise with the JAX engine's
messages.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ranks import free_port, run_ranks
from tpu_ddp.models.transformer import make_transformer as jax_make
from tpu_ddp.parallel.mesh import make_mesh
from tpu_ddp.serve import ServeEngine as JaxServeEngine
from tpu_ddp_torch.convert import params_to_jax
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.serve import long_context
from tpu_ddp_torch.serve.engine import ServeEngine

GEOM = dict(num_slots=4, block_size=8, prefill_chunk=8)
CASES = [(29, 6), (8, 5)]
LOGPROB_ATOL = 1e-4

WORKER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.parallel.bootstrap import init_distributed_setup
from tpu_ddp_torch.serve.engine import ServeEngine

torch.set_num_threads(1)
spec = json.loads(sys.argv[1])
rank, world = int(sys.argv[2]), spec["world"]
init_distributed_setup("127.0.0.1", spec["port"], rank, world,
                       device="cpu", ddp=True, timeout_s=90)
model = make_transformer("TransformerLM-tiny", max_seq_len=64,
                         compute_dtype=torch.float32)
params = model.init(torch.Generator().manual_seed(0))
world_group = dist.group.WORLD
out = {}
for label, kw in spec["engines"].items():
    eng = ServeEngine(model, params, **spec["geom"], device="cpu",
                      sp_group=world_group, **kw)
    reqs = [eng.submit(np.asarray(p), n) for p, n in spec["cases"]]
    eng.run()
    assert eng.accounting_ok(), label
    out[label] = {"tokens": [r.tokens for r in reqs],
                  "logprobs": [r.logprobs for r in reqs],
                  "chunks": eng.metrics.counters.get("serve_prefill_chunks")}
# The rejected combinations that need a real group.
errors = {}
mine = [dist.new_group([r]) for r in range(world)][rank]
for label, kw in (("divide", dict(prefill_chunk=9, sp_group=world_group)),
                  ("one_rank", dict(prefill_chunk=8, sp_group=mine))):
    try:
        ServeEngine(model, params, num_slots=4, block_size=8,
                    cp_prefill="ring", device="cpu", **kw)
        errors[label] = None
    except ValueError as e:
        errors[label] = str(e)
out["errors"] = errors
with open(spec["out"] + f".{rank}.json", "w") as fh:
    json.dump(out, fh)
dist.barrier()
sys.stdout.flush()
os._exit(0)
"""


def _prompt(L, seed):
    return np.random.default_rng(seed).integers(0, 1024, size=L,
                                                dtype=np.int64)


PROMPTS = [(_prompt(L, 100 + i).tolist(), n) for i, (L, n) in
           enumerate(CASES)]


@pytest.fixture(scope="module")
def model():
    return make_transformer("TransformerLM-tiny", max_seq_len=64,
                            compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def params(model):
    return model.init(torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cp") / "cp")
    spec = {"world": 2, "port": str(free_port()), "geom": GEOM,
            "cases": PROMPTS, "out": out,
            "engines": {"ring": dict(cp_prefill="ring"),
                        "ulysses": dict(cp_prefill="ulysses"),
                        "ring_int8": dict(cp_prefill="ring",
                                          decode_quant="int8")}}
    run_ranks(lambda r: ["-c", WORKER, json.dumps(spec), str(r)], 2)
    recs = []
    for r in range(2):
        with open(f"{out}.{r}.json") as fh:
            recs.append(json.load(fh))
    return recs


def _stream(model, params, **kw):
    eng = ServeEngine(model, params, **GEOM, device="cpu", **kw)
    reqs = [eng.submit(np.asarray(p), n) for p, n in PROMPTS]
    eng.run()
    assert eng.accounting_ok()
    return reqs


@pytest.fixture(scope="module")
def single(model, params):
    return _stream(model, params)


@pytest.fixture(scope="module")
def jax_streams(params):
    jm = jax_make("TransformerLM-tiny", max_seq_len=64,
                  compute_dtype=jnp.float32)
    eng = JaxServeEngine(jm, jax.tree.map(jnp.asarray,
                                          params_to_jax(params)), **GEOM)
    reqs = [eng.submit(np.asarray(p), n) for p, n in PROMPTS]
    eng.run()
    return [list(map(int, r.tokens)) for r in reqs]


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_stream_matches_single_rank_and_jax(sharded, single, jax_streams,
                                            mode):
    want = [r.tokens for r in single]
    assert want == jax_streams
    for rank, rec in enumerate(sharded):
        got = rec[mode]
        assert got["tokens"] == want, (mode, rank)
        # 29 tokens: 4 chunks; 8 tokens: 1.
        assert got["chunks"] == 5
        for g, r in zip(got["logprobs"], single):
            np.testing.assert_allclose(g, r.logprobs, atol=LOGPROB_ATOL,
                                       rtol=0)


def test_int8_stream_matches_single_rank_int8(sharded, model, params):
    want = [r.tokens for r in _stream(model, params, decode_quant="int8")]
    for rec in sharded:
        assert rec["ring_int8"]["tokens"] == want


def _jax_error(**kw):
    jm = jax_make("TransformerLM-tiny", max_seq_len=64,
                  compute_dtype=jnp.float32)
    with pytest.raises(ValueError) as err:
        JaxServeEngine(jm, jm.init(jax.random.key(0)), **kw)
    return str(err.value)


def test_rejected_combinations_raise_as_in_jax(sharded, model, params):
    mesh = make_mesh(jax.devices()[:2], dp=1, sp=2)
    want = {"tiers": _jax_error(**GEOM, cp_prefill="ring", mesh=mesh,
                                kv_tiers=2),
            "no_sp": _jax_error(**GEOM, cp_prefill="ring"),
            "divide": _jax_error(num_slots=4, block_size=8, prefill_chunk=9,
                                 cp_prefill="ring", mesh=mesh),
            "junk": _jax_error(**GEOM, cp_prefill="dp")}
    got = {}
    for label, kw in (("tiers", dict(cp_prefill="ring", kv_tiers=2)),
                      ("no_sp", dict(cp_prefill="ring")),
                      ("junk", dict(cp_prefill="dp"))):
        with pytest.raises(ValueError) as err:
            ServeEngine(model, params, **GEOM, device="cpu", **kw)
        got[label] = str(err.value)
    for rec in sharded:
        got["divide"] = rec["errors"]["divide"]
        assert got == want
        # A group of one rank is no sp axis of extent >= 2.
        assert rec["errors"]["one_rank"] == want["no_sp"]


def test_cp_prefill_step_refuses_an_unknown_mode(model, params):
    pool_k = torch.zeros(2, 3, 8, 4, 32)
    with pytest.raises(ValueError, match="expected 'ring' or 'ulysses'"):
        long_context.cp_prefill_step(
            model, 8, params, pool_k, pool_k, torch.zeros(8, dtype=torch.long),
            torch.zeros(1, 8, dtype=torch.long), 0, 8, torch.zeros(1),
            torch.zeros(1, dtype=torch.long), mode="dp")
