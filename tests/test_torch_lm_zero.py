"""The LM trainer's sharded layouts (tpu_ddp_torch/train/lm.py
``opt_sharding='zero1'|'zero2'``, ``param_sharding='fsdp'``) held to the
JAX ``LMTrainer``'s.

- Each layout through ``python -m tpu_ddp_torch.examples.lm_train`` on 2
  gloo ranks (TransformerLM-tiny, f32, AdamW, 3 steps; zero2 with two
  microbatches) against the JAX ``LMTrainer`` of the same layout on a
  2-device mesh from the port's seed-0 weights: each rank's printed loss
  within 1.5e-4 of its shard's (tests/test_torch_lm.py's bound for the
  replicated run, which prints four decimals).
- At one process each layout is the identity: three steps equal the
  replicated trainer's bit for bit, and checkpoints move between the
  layouts exactly.
- Adafactor trains under zero1 (the row-sharded FactoredZeRO1) and is
  refused under zero2 and fsdp.
"""

import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lm import SEQ, _models, _run_cli
from tpu_ddp.parallel.mesh import make_mesh
from tpu_ddp.train.lm import LMTrainer as JaxLMTrainer
from tpu_ddp_torch.convert import params_to_jax
from tpu_ddp_torch.ops.optim import Adafactor
from tpu_ddp_torch.train.lm import LMTrainer, make_lm_batch

LAYOUTS = [
    ({"TPU_DDP_LM_OPT_SHARD": "zero1"}, dict(opt_sharding="zero1")),
    ({"TPU_DDP_LM_OPT_SHARD": "zero2", "TPU_DDP_LM_ACCUM": "2"},
     dict(opt_sharding="zero2", grad_accum=2)),
    ({"TPU_DDP_LM_FSDP": "1"}, dict(param_sharding="fsdp")),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("env,jkw", LAYOUTS,
                         ids=["zero1", "zero2_accum2", "fsdp"])
def test_two_process_layout_matches_jax_mesh(env, jkw):
    logs = _run_cli(2, env)
    fsdp = jkw.get("param_sharding") == "fsdp"
    shard = jkw.get("opt_sharding", "replicated")
    for r, log in enumerate(logs):
        assert (f"rank={r} world=2 dp=2 sp=1 tp=1 pp=1 fsdp={fsdp} "
                f"opt_shard={shard}") in log, log
    printed = [[float(v) for v in re.findall(
        r"\[lm_train\] step \d+/3 loss (\S+)", log)] for log in logs]
    assert [len(p) for p in printed] == [3, 3]

    jm, tm = _models()
    params = LMTrainer(tm, device="cpu").init_state(seed=0).params
    jparams = jax.tree.map(jnp.asarray, params_to_jax(params))
    jt = JaxLMTrainer(jm, make_mesh(jax.devices()[:2]), **jkw)
    if fsdp:
        flat = jt.zero3.shard_params(jax.tree.map(np.asarray, jparams))
        jstate = jt._place_state(flat, jt.zero3.init(flat))
    else:
        jstate = jt._place_state(jparams, jt.optimizer.init(jparams))
    tokens = np.random.default_rng(1234).integers(0, 1024,
                                                  size=(8, SEQ + 1))
    x, y = jt.put_batch(*make_lm_batch(tokens))
    for step in range(3):
        jstate, loss = jt.train_step(jstate, x, y)
        want = np.asarray(loss).reshape(-1)
        for r in range(2):
            assert abs(printed[r][step] - want[r]) <= 1.5e-4, (
                step, r, printed[r][step], want[r])


def _tokens():
    rng = np.random.default_rng(5)
    return make_lm_batch(rng.integers(0, 1024, size=(4, SEQ + 1)))


def _steps(tm, n=3, **kw):
    tr = LMTrainer(tm, device="cpu", **kw)
    state = tr.init_state(seed=0)
    x, y = tr.put_batch(*_tokens())
    losses = []
    for _ in range(n):
        state, loss = tr.train_step(state, x, y)
        losses.append(float(loss))
    return tr, state, losses


@pytest.mark.parametrize("kw", [dict(opt_sharding="zero1"),
                                dict(opt_sharding="zero2", grad_accum=2),
                                dict(param_sharding="fsdp"),
                                dict(param_sharding="fsdp", grad_accum=2,
                                     clip_grad_norm=0.5)],
                         ids=["zero1", "zero2", "fsdp", "fsdp_accum_clip"])
def test_one_process_layout_is_the_replicated_run(kw):
    _, tm = _models()
    rep_kw = {k: v for k, v in kw.items()
              if k in ("grad_accum", "clip_grad_norm")}
    rtr, rstate, rlosses = _steps(tm, **rep_kw)
    tr, state, losses = _steps(tm, **kw)
    assert losses == rlosses
    for a, b in zip(jax.tree.leaves(tr.state_to_host(state)),
                    jax.tree.leaves(rtr.state_to_host(rstate))):
        np.testing.assert_array_equal(a, b)


def test_checkpoints_move_between_layouts(tmp_path):
    """An FSDP checkpoint restores into the replicated, zero1 and fsdp
    trainers with the same canonical state; a move across layouts warns
    that it was one."""
    _, tm = _models()
    tr, state, _ = _steps(tm, n=2, param_sharding="fsdp")
    tr.save_checkpoint(str(tmp_path), state)
    want = tr.state_to_host(state)
    for kw in (dict(), dict(opt_sharding="zero1"),
               dict(param_sharding="fsdp")):
        other = LMTrainer(tm, device="cpu", **kw)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            got = other.state_to_host(other.restore_checkpoint(
                str(tmp_path)))
        crossed = any("restoring into" in str(w.message) for w in rec)
        assert crossed == (kw.get("param_sharding") != "fsdp")
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [dict(opt_sharding="zero1"),
                                dict(opt_sharding="zero2"),
                                dict(param_sharding="fsdp")])
def test_adafactor_under_a_sharded_layout_raises_naming_its_item(kw):
    """Adafactor under zero1 is the row-sharded FactoredZeRO1 and
    trains (tests/test_torch_factored_zero.py holds it to JAX); zero2
    and fsdp are permanent refusals in the JAX trainer's words."""
    from tpu_ddp_torch.parallel.zero import FactoredZeRO1
    _, tm = _models()
    if kw.get("opt_sharding") == "zero1":
        tr = LMTrainer(tm, device="cpu", optimizer=Adafactor(), **kw)
        assert isinstance(tr.layout, FactoredZeRO1)
        state = tr.init_state(seed=0)
        state, loss = tr.train_step(state, *tr.put_batch(*_tokens()))
        assert np.isfinite(float(loss)) and state.step == 1
        return
    with pytest.raises(ValueError, match="Adafactor"):
        LMTrainer(tm, device="cpu", optimizer=Adafactor(), **kw)


def test_fsdp_with_zero1_is_refused():
    _, tm = _models()
    with pytest.raises(ValueError, match="redundant"):
        LMTrainer(tm, device="cpu", param_sharding="fsdp",
                  opt_sharding="zero1")
