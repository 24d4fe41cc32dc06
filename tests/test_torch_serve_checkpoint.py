"""Serving from a training checkpoint in the port
(``ServeEngine.from_checkpoint``, ``models/decode.py``
``dense_params_from_checkpoint``) held to the JAX package's.

A TransformerLM-tiny checkpoint written by the JAX ``LMTrainer`` (params,
AdamW moments and step) serves in the port: the restored params equal the
JAX trainer's bit for bit, and the port's stream gives the JAX engine's
``from_checkpoint`` stream (greedy tokens equal, logprobs within 1e-4
after the top-2 gap check of tests/test_torch_serve.py). A checkpoint of
the port's own ``LMTrainer`` serves the stream of an engine built on the
trainer's params in memory, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.models import make_transformer as jax_make
from tpu_ddp.ops import quant as jq
from tpu_ddp.parallel.mesh import make_mesh
from tpu_ddp.serve import ServeEngine as JaxServeEngine
from tpu_ddp.train.lm import LMTrainer as JaxLMTrainer
from tpu_ddp_torch.models.decode import dense_params_from_checkpoint
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.resilience.integrity import CheckpointCorruptError
from tpu_ddp_torch.serve.engine import ServeEngine
from tpu_ddp_torch.train.lm import LMTrainer, make_lm_batch
from tpu_ddp_torch.utils.tree import keyed_leaves

SEQ = 32
GEOM = dict(num_slots=3, block_size=8, prefill_chunk=8)
CASES = [(5, 6), (12, 5), (19, 7), (9, 4)]

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test files run in parallel worker processes; torch's own thread
    pool on top of them oversubscribes the cores (its threads spin), and
    these tiny shapes gain nothing from it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, 1024, size=(4, SEQ + 1))


def _prompt(L, seed):
    # Seeds 102..: every greedy step of CASES has a top-2 gap > 2e-3 on
    # both the fp and the int8 tree of the checkpoint below.
    return np.random.default_rng(102 + seed).integers(0, 1024, size=L)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_lm"))
    jm = jax_make("TransformerLM-tiny", compute_dtype=jnp.float32,
                  max_seq_len=SEQ)
    jt = JaxLMTrainer(jm, make_mesh(jax.devices()[:1]))
    state = jt.init_state(0)
    for _ in range(2):
        state, _ = jt.train_step(state, *jt.put_batch(
            *make_lm_batch(_tokens())))
    jt.save_checkpoint(d, state)
    return d, jm, jax.tree.map(np.asarray, state.params)


def _top2_gap(logits):
    top = np.sort(np.asarray(logits, np.float64))[-2:]
    return top[1] - top[0]


@pytest.mark.parametrize("decode_quant", ["none", "int8"])
def test_jax_checkpoint_serves_the_jax_engines_stream(jax_checkpoint,
                                                      decode_quant):
    d, jm, jparams = jax_checkpoint
    tm = make_transformer("TransformerLM-tiny", compute_dtype=torch.float32,
                          max_seq_len=SEQ)
    params = dense_params_from_checkpoint(tm, d, device="cpu")
    want = dict(keyed_leaves(jparams))
    for path, leaf in keyed_leaves(params):
        np.testing.assert_array_equal(leaf.numpy(), want[path])
    teng = ServeEngine.from_checkpoint(tm, d, decode_quant=decode_quant,
                                       device="cpu", **GEOM)
    jeng = JaxServeEngine.from_checkpoint(jm, d, decode_quant=decode_quant,
                                          **GEOM)
    th = [teng.submit(_prompt(L, i), n) for i, (L, n) in enumerate(CASES)]
    jh = [jeng.submit(_prompt(L, i), n) for i, (L, n) in enumerate(CASES)]
    teng.run()
    jeng.run()
    jtree = (jq.quantize_params(jm, jeng.params) if decode_quant == "int8"
             else jeng.params)
    for i, ((L, n), a, b) in enumerate(zip(CASES, th, jh)):
        seq = np.concatenate([_prompt(L, i), b.tokens[:-1]])
        logits = np.asarray(jq.decode_forward_logits(
            jm, jtree, jnp.asarray(seq[None], jnp.int32)))[0]
        assert min(_top2_gap(logits[L - 1 + t]) for t in range(n)) > 1e-3
        assert a.tokens == [int(t) for t in b.tokens], i
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=1e-4,
                                   rtol=0)
    assert teng.accounting_ok()


def test_port_checkpoint_serves_the_in_memory_stream(tmp_path):
    tm = make_transformer("TransformerLM-tiny", compute_dtype=torch.float32,
                          max_seq_len=SEQ)
    tr = LMTrainer(tm, device="cpu")
    state = tr.init_state(seed=1)
    state, _ = tr.train_step(state, *tr.put_batch(*make_lm_batch(
        _tokens(1))))
    tr.save_checkpoint(str(tmp_path), state)
    mem = {k: v for k, v in state.params.items()}
    runs = []
    for eng in (ServeEngine.from_checkpoint(tm, str(tmp_path), device="cpu",
                                            decode_quant="int8", **GEOM),
                ServeEngine(tm, jax.tree.map(
                    lambda t: t.detach().clone(), mem,
                    is_leaf=lambda x: isinstance(x, torch.Tensor)),
                    device="cpu", decode_quant="int8", **GEOM)):
        hs = [eng.submit(_prompt(L, i), n, temperature=0.8 * (i % 2),
                         seed=i) for i, (L, n) in enumerate(CASES)]
        eng.run()
        runs.append(hs)
    for a, b in zip(*runs):
        assert a.tokens == b.tokens and a.logprobs == b.logprobs
    with pytest.raises(FileNotFoundError):
        ServeEngine.from_checkpoint(tm, str(tmp_path / "none"), device="cpu")


def test_a_corrupt_checkpoint_is_refused(jax_checkpoint, tmp_path):
    """A params leaf whose bytes no longer match its recorded digest."""
    import json
    import shutil
    d, _, _ = jax_checkpoint
    bad = tmp_path / "bad"
    shutil.copytree(d, bad)
    man = next(bad.rglob("manifest.json"))
    meta = json.loads(man.read_text())
    key = next(k for k in meta["digests"] if ":params." in k)
    meta["digests"][key] = "0" * len(meta["digests"][key])
    man.write_text(json.dumps(meta))
    tm = make_transformer("TransformerLM-tiny", compute_dtype=torch.float32,
                          max_seq_len=SEQ)
    with pytest.raises(CheckpointCorruptError, match="digest mismatch"):
        dense_params_from_checkpoint(tm, str(bad), device="cpu")
