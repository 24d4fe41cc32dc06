"""The port's LM training slice (tpu_ddp_torch/models/transformer.py
training forward, train/lm.py, ops/optim.py AdamW, examples/lm_train.py)
held against the JAX package's ``TransformerLM.apply`` and ``LMTrainer``
on the same weights (``convert.params_from_jax``) and the same
numpy-seeded tokens, f32 compute; the Pallas flash kernel runs in
interpret mode.

Tolerances: logits 2e-5 and parameter gradients 1e-5 (rtol and atol),
where both sides compute in f32 and differ only in summation order;
after three AdamW steps losses within 1e-5 relative, parameters and both
moments within 1e-4. AdamW divides by sqrt(nu) + 1e-8, so a last-bit
difference in a gradient near zero moves its first update by up to
lr = 3e-4: the 1e-4 bound on parameters is that step size's scale.

The 2-process run of the CLI (gloo, one subprocess per rank, 120 s limit
each) is compared with the JAX ``LMTrainer`` on a 2-device mesh started
from the same weights; the CLI prints losses to 4 decimals.
"""

import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.models import make_transformer as jax_make
from tpu_ddp.ops.loss import softmax_cross_entropy as jax_ce
from tpu_ddp.ops.optim import AdamW as JaxAdamW
from tpu_ddp.parallel.mesh import make_mesh
from tpu_ddp.train.lm import LMTrainer as JaxLMTrainer
from tpu_ddp.utils import flops as jax_flops
from tpu_ddp_torch.convert import (adamw_state_from_jax, params_from_jax,
                                   params_to_jax)
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.ops import flash_attention as fa
from tpu_ddp_torch.ops.loss import softmax_cross_entropy
from tpu_ddp_torch.ops.optim import SGD, AdamW
from tpu_ddp_torch.parallel.ring_attention import attend
from tpu_ddp_torch.train.lm import LMTrainer, make_lm_batch
from tpu_ddp_torch.utils import flops
from tpu_ddp_torch.utils.tree import tree_leaves, tree_unflatten

REPO = Path(__file__).resolve().parent.parent
SEQ = 32


def _models(**kw):
    kw = dict(max_seq_len=SEQ, **kw)
    return (jax_make("TransformerLM-tiny", compute_dtype=jnp.float32, **kw),
            make_transformer("TransformerLM-tiny",
                             compute_dtype=torch.float32, **kw))


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(b, seed=0):
    return np.random.default_rng(seed).integers(0, 1024, size=(b, SEQ + 1))


def _assert_tree(got, want, tol, what):
    """Leaf by leaf, over the JAX tree's structure."""
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    flat_g = jax.tree.leaves(got)
    assert len(flat_g) == len(flat_w)
    for (path, w), g in zip(flat_w, flat_g):
        np.testing.assert_allclose(
            g, w, rtol=tol, atol=tol,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("kv_heads", [None, 2])
def test_logits_and_grads_match_jax(use_flash, kv_heads):
    jm, tm = _models(use_flash=use_flash, num_kv_heads=kv_heads)
    jparams = jm.init(jax.random.key(0))
    x, y = make_lm_batch(_tokens(2))

    def jloss(p):
        logits = jm.apply(p, jnp.asarray(x))
        return jnp.mean(jax_ce(logits.reshape(-1, 1024),
                               jnp.asarray(y).reshape(-1))), logits

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams)

    params = params_from_jax(tm, _host(jparams), device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    logits = tm.apply(params, torch.as_tensor(x))
    loss = softmax_cross_entropy(logits.reshape(-1, 1024),
                                 torch.as_tensor(y).reshape(-1)).mean()
    grads = torch.autograd.grad(loss, leaves)
    assert logits.dtype == torch.float32 and logits.shape == (2, SEQ, 1024)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=2e-5, atol=2e-5)
    _assert_tree(params_to_jax(tree_unflatten(params, grads)),
                 _host(jgrads), 1e-5, "grad")


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("kv_heads", [None, 2])
def test_bf16_logits_and_grads_match_jax(use_flash, kv_heads):
    """bf16 compute, the main path's dtype, against the JAX bf16 apply.
    Both round every projection and the residual stream to bf16, so the
    sides part by bf16 units: measured on these inputs, the loss within
    4.9e-5 relative, logits within 6.2e-3 and every parameter gradient
    within 1.3e-2 of its norm (relative Frobenius)."""
    kw = dict(max_seq_len=SEQ, use_flash=use_flash, num_kv_heads=kv_heads)
    jm = jax_make("TransformerLM-tiny", compute_dtype=jnp.bfloat16, **kw)
    tm = make_transformer("TransformerLM-tiny", compute_dtype=torch.bfloat16,
                          **kw)
    jparams = jm.init(jax.random.key(0))
    x, y = make_lm_batch(_tokens(2))

    def jloss(p):
        logits = jm.apply(p, jnp.asarray(x))
        return jnp.mean(jax_ce(logits.reshape(-1, 1024),
                               jnp.asarray(y).reshape(-1))), logits

    (jl, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams)
    params = params_from_jax(tm, _host(jparams), device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    logits = tm.apply(params, torch.as_tensor(x))
    loss = softmax_cross_entropy(logits.reshape(-1, 1024),
                                 torch.as_tensor(y).reshape(-1)).mean()
    grads = torch.autograd.grad(loss, leaves)

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    assert abs(float(loss.detach()) - float(jl)) <= 1e-4 * abs(float(jl))
    assert rel(logits.detach().numpy(), np.asarray(jlogits)) <= 1e-2
    # The logits are the head's f32 product, not bf16 values.
    assert not torch.equal(logits, logits.bfloat16().float())
    for g, w in zip(jax.tree.leaves(params_to_jax(tree_unflatten(params,
                                                                  grads))),
                    jax.tree.leaves(_host(jgrads))):
        assert rel(g, w) <= 2e-2


def test_bf16_projections_keep_f32_where_jax_does():
    """The ``w1`` output (the GELU input) and the logits stay f32, as
    ``jnp.dot(..., preferred_element_type=jnp.float32)`` leaves them; the
    backward rounds the cotangent to bf16 and returns bf16 gradients."""
    from tpu_ddp_torch.models.transformer import train_dot
    rng = np.random.default_rng(11)
    y = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    g = rng.normal(size=(2, 5, 48)).astype(np.float32)
    want = np.asarray(jnp.dot(jnp.asarray(y, jnp.bfloat16),
                              jnp.asarray(w, jnp.bfloat16),
                              preferred_element_type=jnp.float32))
    ty = torch.tensor(y).bfloat16().requires_grad_()
    tw = torch.tensor(w).requires_grad_()
    out = train_dot(ty, tw, torch.bfloat16, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-6,
                               atol=1e-5)
    assert not torch.equal(out, out.bfloat16().float())
    dy, dw = torch.autograd.grad(out, (ty, tw), torch.tensor(g))
    assert dy.dtype == torch.bfloat16 and dw.dtype == torch.float32
    gb = torch.tensor(g).bfloat16().float()
    yb, wb = ty.detach().float(), torch.tensor(w).bfloat16().float()
    np.testing.assert_array_equal(dy.float().numpy(),
                                  (gb @ wb.T).bfloat16().float().numpy())
    np.testing.assert_array_equal(
        dw.numpy(), torch.einsum("bld,ble->de", yb, gb).bfloat16()
        .float().numpy())


def _trainers(use_flash=True, steps=3, **port_kw):
    """JAX and port trainers from the same weights, run ``steps`` steps
    on one batch of 4; returns both states and their losses."""
    jm, tm = _models(use_flash=use_flash)
    jt = JaxLMTrainer(jm, make_mesh(jax.devices()[:1]))
    jstate = jt.init_state(seed=0)
    tt = LMTrainer(tm, device="cpu", **port_kw)
    state = tt.init_state(params=params_from_jax(
        tm, _host(jstate.params), device="cpu"))
    x, y = make_lm_batch(_tokens(4, seed=3))
    jx, jy = jt.put_batch(x, y)
    tx, ty = tt.put_batch(x, y)
    jl, tl = [], []
    for _ in range(steps):
        jstate, loss = jt.train_step(jstate, jx, jy)
        jl.append(float(np.mean(np.asarray(loss))))
        state, loss = tt.train_step(state, tx, ty)
        tl.append(float(loss))
    return jt, jstate, jl, tt, state, tl


def test_trainer_matches_jax_trainer():
    """Three AdamW steps with flash attention: losses, parameters and
    both moments against the JAX ``LMTrainer`` on a 1-device mesh."""
    jt, jstate, jl, tt, state, tl = _trainers()
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    assert state.step == jstate.step == 3
    _assert_tree(tt.params_to_host(state), jt.params_to_host(jstate), 1e-4,
                 "param")
    jopt = _host(jstate.opt_state)
    assert state.opt_state["count"] == int(jopt["count"]) == 3
    for name in ("mu", "nu"):
        _assert_tree(params_to_jax(tree_unflatten(
            state.params, state.opt_state[name])), jopt[name], 1e-4, name)
    # The converter's way in gives the same state back.
    back = adamw_state_from_jax(tt.model, jopt, device="cpu")
    for a, b in zip(back["mu"] + back["nu"],
                    state.opt_state["mu"] + state.opt_state["nu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)


def _one_step(model, params, accum=1, steps=1, optimizer=None):
    tt = LMTrainer(model, device="cpu", grad_accum=accum,
                   optimizer=optimizer)
    state = tt.init_state(params=params)
    x, y = tt.put_batch(*make_lm_batch(_tokens(4, seed=5)))
    losses = []
    for _ in range(steps):
        state, loss = tt.train_step(state, x, y)
        losses.append(float(loss))
    return state, losses


def _fresh_params(model):
    return model.init(torch.Generator().manual_seed(0))


def test_remat_blocks_equals_none(monkeypatch):
    """``remat="blocks"`` recomputes each block's forward (the flash
    forward included: twice the calls) and lands on the same step."""
    calls = []
    plain = fa.flash_fwd_plain

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(fa, "flash_fwd_plain", counted)
    _, tm = _models(use_flash=True)
    results = {}
    for remat in ("none", "blocks"):
        model = make_transformer("TransformerLM-tiny", max_seq_len=SEQ,
                                 compute_dtype=torch.float32,
                                 use_flash=True, remat=remat)
        calls.clear()
        results[remat] = _one_step(model, _fresh_params(tm))
        results[remat + "_calls"] = len(calls)
    assert results["none_calls"] == tm.num_layers
    assert results["blocks_calls"] == 2 * tm.num_layers
    (sn, ln), (sb, lb) = results["none"], results["blocks"]
    assert lb == ln
    for a, b in zip(tree_leaves(sn.params), tree_leaves(sb.params)):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b.detach().numpy())


def test_grad_accum_matches_the_full_batch():
    """Two equal microbatches give the full batch's mean gradient, so the
    steps agree up to the order of f32 sums. AdamW runs with eps 1e-3:
    with eps 1e-8 its step lr * m / (sqrt(v) + eps) is about +-lr wherever
    |g| >> eps, so a gradient that sums to nearly 0 flips its step on a
    last-bit difference in the sum's order; with eps 1e-3 the step is
    smooth in g and the params show the gradients' agreement."""
    _, tm = _models(use_flash=True)
    opt = AdamW(eps=1e-3)
    sf, lf = _one_step(tm, _fresh_params(tm), accum=1, steps=2,
                       optimizer=opt)
    sa, la = _one_step(tm, _fresh_params(tm), accum=2, steps=2,
                       optimizer=opt)
    np.testing.assert_allclose(la, lf, rtol=1e-6)
    for a, b in zip(tree_leaves(sa.params), tree_leaves(sf.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_jax(weight_decay):
    rng = np.random.default_rng(7)
    shapes = [(3, 5), (7,), (2, 3, 4)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    jopt = JaxAdamW(weight_decay=weight_decay)
    jp, js = [jnp.asarray(p) for p in params], None
    js = jopt.init(jp)
    opt = AdamW(weight_decay=weight_decay)
    tp = [torch.tensor(p) for p in params]
    ts = opt.init(tp)
    for g in grads:
        jp, js = jopt.apply(jp, [jnp.asarray(x) for x in g], js)
        opt.apply(tp, [torch.tensor(x) for x in g], ts)
    assert ts["count"] == int(js["count"]) == 3
    for a, b in zip(tp + ts["mu"] + ts["nu"], jp + js["mu"] + js["nu"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("preset", ["TransformerLM-tiny",
                                    "TransformerLM-large"])
def test_flops_match_jax(preset):
    jm = jax_make(preset)
    tm = make_transformer(preset)
    assert (flops.transformer_fwd_flops(tm, 4, 2048)
            == jax_flops.transformer_fwd_flops(jm, 4, 2048))


def test_large_preset_carries_block_remat():
    tm = make_transformer("TransformerLM-large")
    jm = jax_make("TransformerLM-large")
    assert tm.remat == jm.remat == "blocks"
    assert tm.param_shapes()["head"] == (2048, 32000)


# ---- the CLI: a 2-process gloo run ----------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_cli(world, extra_env=None):
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               TPU_DDP_LM_STEPS="3", **(extra_env or {}))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tpu_ddp_torch.examples.lm_train",
         "--num-nodes", str(world), "--rank", str(r), "--master-ip",
         "127.0.0.1", "--master-port", port, "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs


def test_two_process_cli_matches_jax_mesh():
    """``python -m tpu_ddp_torch.examples.lm_train`` on 2 gloo ranks: each
    rank's printed loss against its shard of the JAX ``LMTrainer`` on a
    2-device mesh, from the port's seed-0 weights."""
    logs = _run_cli(2)
    for r, log in enumerate(logs):
        assert (f"[lm_train] rank={r} world=2 dp=2 sp=1 tp=1 pp=1 "
                f"fsdp=False" in log), log
        assert "Backend: gloo" in log
    printed = [[float(v) for v in re.findall(
        r"\[lm_train\] step \d+/3 loss (\S+)", log)] for log in logs]
    assert [len(p) for p in printed] == [3, 3]

    jm, tm = _models()
    params = LMTrainer(tm, device="cpu").init_state(seed=0).params
    jparams = jax.tree.map(jnp.asarray, params_to_jax(params))
    jt = JaxLMTrainer(jm, make_mesh(jax.devices()[:2]))
    jstate = jt._place_state(jparams, jt.optimizer.init(jparams))
    tokens = np.random.default_rng(1234).integers(0, 1024,
                                                  size=(8, SEQ + 1))
    x, y = jt.put_batch(*make_lm_batch(tokens))
    for step in range(3):
        jstate, loss = jt.train_step(jstate, x, y)
        shard = np.asarray(loss).reshape(-1)
        for r in range(2):
            assert abs(printed[r][step] - shard[r]) <= 1.5e-4, (
                step, r, printed[r][step], shard[r])


def test_one_process_cli_with_accumulation():
    (log,) = _run_cli(1, {"TPU_DDP_LM_ACCUM": "2"})
    assert "accum=2" in log
    losses = [float(v) for v in re.findall(r"loss (\S+)", log)]
    assert len(losses) == 3 and losses[-1] < losses[0]


# ---- what the port does not carry yet -------------------------------------

@pytest.mark.parametrize("kwargs,item", [
    (dict(param_sharding="fsdp"), "item 9.4"),
    (dict(opt_sharding="zero1"), "item 9.4"),
    (dict(opt_sharding="zero2"), "item 9.4"),
    (dict(vocab_chunk=256), "item 10.1"),
    (dict(clip_grad_norm=1.0), "item 10.4"),
    (dict(optimizer=SGD()), "item 9.1"),
])
def test_unported_trainer_knobs_raise(kwargs, item):
    _, tm = _models()
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        LMTrainer(tm, device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs,item", [
    (dict(dropout_rate=0.1), "item 10.3"),
    (dict(moe_experts=4), "item 10.8"),
])
def test_unported_model_fields_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        make_transformer("TransformerLM-tiny", **kwargs)


@pytest.mark.parametrize("kwargs", [dict(remat="dots"),
                                    dict(remat="conv_stages"),
                                    dict(act_dtype="bf16")])
def test_unported_memory_policies_raise_when_training(kwargs):
    model = make_transformer("TransformerLM-tiny", max_seq_len=SEQ,
                             compute_dtype=torch.float32, **kwargs)
    tokens = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="item 9.7"):
        model.apply(_fresh_params(model), tokens)


def test_unported_schedule_and_sequence_parallel_raise():
    with pytest.raises(NotImplementedError, match="item 9.1"):
        AdamW(learning_rate=lambda step: 1e-3)
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(NotImplementedError, match="item 10.5"):
        attend(q, q, q, axis_name="sp", axis_size=2)


@pytest.mark.parametrize("name,value", [
    ("TPU_DDP_LM_FSDP", "1"), ("TPU_DDP_LM_ZERO1", "1"),
    ("TPU_DDP_LM_OPT_SHARD", "zero2"), ("TPU_DDP_LM_OPT", "adafactor"),
    ("TPU_DDP_LM_CLIP", "1.0"), ("TPU_DDP_LM_TP", "2"),
    ("TPU_DDP_LM_PP", "2"), ("TPU_DDP_LM_SP_MODE", "ulysses"),
    ("TPU_DDP_REMAT", "blocks"),
])
def test_unported_cli_env_raises(monkeypatch, name, value):
    from tpu_ddp_torch.examples.lm_train import main
    monkeypatch.setenv(name, value)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        main(["--num-nodes", "1", "--device", "cpu"])


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, tm = _models()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LMTrainer(tm)
