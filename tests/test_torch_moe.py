"""Mixture of experts in the port (tpu_ddp_torch/parallel/moe.py, the MoE
TransformerLM, LMTrainer(ep=...), MoE decode and serving) held against
the JAX package on the same numpy-seeded inputs, f32 compute.

Tolerances:

- Routing: the port's dispatch and combine, rebuilt densely from its
  indices (``_dense``), against JAX's (T, E, C) tensors: dispatch
  exactly, combine within rtol 1e-6 / atol 1e-7 (the two softmaxes
  differ in the last bit), aux within 1e-6.
- ``moe_mlp`` forward and every gradient (the router's included) within
  rtol and atol 1e-5; the TransformerLM-moe-tiny logits 2e-5 and
  gradients 1e-5 (tests/test_torch_lm.py's bounds).
- One LMTrainer step, at ep = 1 and over gloo at (dp, ep) = (1, 2) and
  (2, 2) (one subprocess per rank, 150 s limit), against the JAX
  ``LMTrainer`` on ``make_mesh(dp=..., ep=...)``: params within rtol
  3e-4 / atol 3e-5 and losses within 1e-4 (tests/test_moe.py's bounds).
- MoE at ep = 1 under zero1, fsdp and FactoredZeRO1 through the CLI at
  2 gloo ranks: each printed loss within 1.5e-4 of the JAX shard's
  (tests/test_torch_lm_zero.py's bound; the CLI prints four decimals).
- Decode and serving: greedy token streams equal.
"""

import json
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_lm import SEQ, _run_cli
from torch_ranks import free_port, run_ranks
from tpu_ddp.models import make_transformer as jax_make
from tpu_ddp.models.generate import generate as jax_generate
from tpu_ddp.ops.optim import SGD as JaxSGD
from tpu_ddp.ops.optim import Adafactor as JaxAdafactor
from tpu_ddp.parallel import moe as jmoe
from tpu_ddp.parallel.mesh import make_mesh
from tpu_ddp.train.lm import LMTrainer as JaxLMTrainer
from tpu_ddp.tune import space as jspace
from tpu_ddp.utils import flops as jax_flops
from tpu_ddp.utils.config import TrainConfig as JaxConfig
from tpu_ddp_torch import launch
from tpu_ddp_torch.convert import params_from_jax, params_to_jax
from tpu_ddp_torch.models.generate import generate
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.ops.optim import SGD, Adafactor
from tpu_ddp_torch.parallel import moe as tmoe
from tpu_ddp_torch.serve.engine import ServeEngine
from tpu_ddp_torch.train.lm import (LMTrainer, format_route_stats,
                                    make_lm_batch)
from tpu_ddp_torch.tune import space as tspace
from tpu_ddp_torch.utils import flops
from tpu_ddp_torch.utils.config import TrainConfig
from tpu_ddp_torch.utils.tree import tree_leaves, tree_unflatten

ROUTE_TOL = dict(rtol=1e-6, atol=1e-7)
STEP_TOL = dict(rtol=3e-4, atol=3e-5)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _models(**kw):
    cfg = dict(max_seq_len=SEQ, moe_capacity_factor=8.0)
    cfg.update(kw)
    return (jax_make("TransformerLM-moe-tiny", compute_dtype=jnp.float32,
                     **cfg),
            make_transformer("TransformerLM-moe-tiny",
                             compute_dtype=torch.float32, **cfg))


def _tokens(b=4, L=SEQ + 1, seed=11):
    return np.random.default_rng(seed).integers(0, 1024, size=(b, L))


def _logits(T, E, seed):
    return np.random.default_rng(seed).normal(size=(T, E)).astype(
        np.float32)


def _dense(slots, gates, num_experts, capacity):
    """The JAX layer's (T, E, C) ``dispatch`` and ``combine`` rebuilt from
    the port's slot indices and gates."""
    k, T = slots.shape
    S = num_experts * capacity
    dispatch = torch.zeros(T, S + 1)
    combine = torch.zeros(T, S + 1)
    rows = torch.arange(T)
    for j in range(k):
        dispatch[rows, slots[j]] += 1.0
        combine[rows, slots[j]] += gates[j].detach()
    shape = (T, num_experts, capacity)
    return dispatch[:, :S].reshape(shape), combine[:, :S].reshape(shape)


# ---- routing ---------------------------------------------------------------

@pytest.mark.parametrize("T,E,C,k", [
    (16, 4, 8, 1), (16, 4, 32, 2), (16, 4, 2, 2), (64, 8, 5, 2),
    (24, 4, 3, 1), (32, 8, 4, 3)],
    ids=["top1", "top2", "top2_tight", "top2_wide", "top1_tight",
         "top3_tight"])
def test_dispatch_and_combine_equal_the_jax_dense_tensors(T, E, C, k):
    lg = _logits(T, E, seed=T + C + k)
    jd, jc, ja = jmoe.topk_route(jnp.asarray(lg), E, C, top_k=k)
    slots, gates, aux = tmoe.topk_route(torch.tensor(lg), E, C, top_k=k)
    assert slots.shape == (k, T) and gates.shape == (k, T)
    d, c = _dense(slots, gates, E, C)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **ROUTE_TOL)
    assert abs(float(aux) - float(ja)) < 1e-6
    js = jmoe.routing_stats(jd, top_k=k)
    ts = tmoe.routing_stats(slots, E, C, k)
    for key in ("dropped_frac", "expert_load", "imbalance"):
        np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]),
                                   atol=1e-6, err_msg=key)


def test_top1_reduces_to_switch():
    lg = torch.tensor(_logits(16, 4, 3))
    s1, g1, a1 = tmoe.switch_route(lg, 4, 8)
    s2, g2, a2 = tmoe.topk_route(lg, 4, 8, top_k=1)
    assert torch.equal(s1, s2) and torch.equal(g1, g2)
    assert float(a1) == float(a2)


def test_top2_tight_capacity_slots_never_collide():
    """A token's second choice queues after the slots the first choices
    kept, so even at tight capacity no (expert, slot) holds two tokens
    and no expert keeps more than C (tests/test_moe.py's case)."""
    for seed in range(5):
        slots, gates, _ = tmoe.topk_route(torch.tensor(_logits(16, 4, seed)),
                                          4, 2, top_k=2)
        d, _ = _dense(slots, gates, 4, 2)
        assert d.sum(dim=0).max() <= 1.0, seed
        assert d.sum(dim=(0, 2)).max() <= 2.0, seed
        kept = slots[slots < 8]
        assert kept.numel() == torch.unique(kept).numel()
    # Every token first-picks expert 0, second-picks expert 1: each
    # expert keeps exactly its C earliest tokens.
    logits = torch.tensor([[3.0, 1.0]]).repeat(8, 1)
    slots, gates, _ = tmoe.topk_route(logits, 2, 2, top_k=2)
    d, _ = _dense(slots, gates, 2, 2)
    assert d.sum(dim=0).max() == 1.0
    assert d[0, 0].tolist() == [1.0, 0.0]
    assert d[1, 0].tolist() == [0.0, 1.0]
    assert d[0, 1].tolist() == [1.0, 0.0]
    assert d[2:].sum() == 0.0
    assert slots[:, 2:].eq(4).all()  # dropped: the spare slot E * C


def test_aux_matches_hand_computed_example():
    """The Switch load-balance loss worked by hand on 4 tokens and 2
    experts (tests/test_moe.py's example)."""
    logits = torch.tensor([[2.0, 0.0], [2.0, 0.0], [0.0, 2.0], [2.0, 0.0]])
    _, _, aux = tmoe.topk_route(logits, 2, 8, top_k=1)
    p = math.exp(2.0) / (math.exp(2.0) + 1.0)
    q = 1.0 - p
    want = 2.0 * (0.75 * (3 * p + q) / 4 + 0.25 * (p + 3 * q) / 4)
    assert abs(float(aux) - want) < 1e-6
    # A uniform router: f = P = 1/E, aux = 1.
    _, _, aux = tmoe.topk_route(torch.zeros(8, 4), 4, 8)
    assert abs(float(aux) - 1.0) < 1e-6


def test_dropped_tokens_ride_residual_bitwise():
    """An overflowed assignment contributes exact zeros, so a dropped
    token's residual stream is bitwise unchanged."""
    rng = np.random.default_rng(7)
    y = torch.tensor(rng.normal(size=(1, 8, 4)).astype(np.float32))
    w1 = torch.tensor(rng.normal(size=(2, 4, 8)).astype(np.float32))
    w2 = torch.tensor(rng.normal(size=(2, 8, 4)).astype(np.float32))
    # T = 8, cf = 0.25, k = 1, E = 2: capacity 1; a zero router ties to
    # expert 0, so token 0 keeps its one slot and tokens 1-7 drop.
    out, _ = tmoe.moe_mlp(y, torch.zeros(4, 2), w1, w2, num_experts=2,
                          capacity_factor=0.25)
    delta = out[0]
    assert delta[0].abs().max() > 0.0
    assert torch.equal(delta[1:], torch.zeros_like(delta[1:]))
    assert torch.equal(y[0, 1:] + delta[1:], y[0, 1:])


def test_routing_stats_counters():
    logits = torch.tensor([[3.0, 1.0]]).repeat(8, 1)
    slots, _, _ = tmoe.topk_route(logits, 2, 2, top_k=1)
    s = tmoe.routing_stats(slots, 2, 2, 1)
    assert abs(float(s["dropped_frac"]) - 0.75) < 1e-6
    np.testing.assert_allclose(s["expert_load"].numpy(), [0.25, 0.0],
                               atol=1e-6)
    assert abs(float(s["imbalance"]) - 0.5) < 1e-6


def test_top_k_validation():
    with pytest.raises(ValueError, match="top_k"):
        tmoe.topk_route(torch.zeros(8, 4), 4, 8, top_k=0)
    with pytest.raises(ValueError, match="top_k"):
        tmoe.topk_route(torch.zeros(8, 4), 4, 8, top_k=5)
    with pytest.raises(ValueError, match="local experts"):
        tmoe.moe_mlp(torch.zeros(1, 4, 8), torch.zeros(8, 4),
                     torch.zeros(3, 8, 16), torch.zeros(3, 16, 8),
                     num_experts=4)


@pytest.mark.parametrize("cf,k", [(1.25, 1), (1.25, 2), (0.5, 2), (8.0, 2)])
def test_moe_mlp_forward_and_grads_match_jax(cf, k):
    rng = np.random.default_rng(int(cf * 10) + k)
    E, dm, dff = 4, 8, 16
    arrays = (rng.normal(size=(2, 8, dm)), rng.normal(size=(dm, E)),
              0.3 * rng.normal(size=(E, dm, dff)),
              0.3 * rng.normal(size=(E, dff, dm)))
    arrays = [a.astype(np.float32) for a in arrays]

    def jf(*args):
        o, a = jmoe.moe_mlp(*args, num_experts=E, capacity_factor=cf,
                            top_k=k)
        return jnp.sum(o * jnp.cos(o)) + 0.3 * a, o

    (jv, jo), jg = jax.value_and_grad(jf, argnums=(0, 1, 2, 3),
                                      has_aux=True)(
        *map(jnp.asarray, arrays))
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    o, a = tmoe.moe_mlp(*ts, num_experts=E, capacity_factor=cf, top_k=k)
    loss = torch.sum(o * torch.cos(o)) + 0.3 * a
    grads = torch.autograd.grad(loss, ts)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               rtol=1e-5, atol=1e-5)
    assert abs(float(loss.detach()) - float(jv)) < 1e-5
    for name, g, want in zip(("y", "router", "w1", "w2"), grads, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    assert grads[1].abs().max() > 0.0  # the router learns through gates


class _Largest(TorchDispatchMode):
    """The largest number of elements any op of the region produced."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.most = max(self.most, t.numel())
        return out


def test_main_path_never_builds_the_one_hot():
    """No tensor of the forward and backward holds T x E x C elements:
    dispatch and combine are gathers (T = 64, E = 8, C = 20, dm = 8,
    dff = 16: the one-hot would be 10,240 elements, the largest real
    tensor, the experts' hidden bank, 2,560)."""
    rng = np.random.default_rng(0)
    T, E, dm, dff = 64, 8, 8, 16
    ts = [torch.tensor(rng.normal(size=s).astype(np.float32),
                       requires_grad=True)
          for s in ((1, T, dm), (dm, E), (E, dm, dff), (E, dff, dm))]
    C = tmoe.capacity(T, E, 1.25, 2)
    with _Largest() as seen:
        o, a = tmoe.moe_mlp(*ts, num_experts=E, top_k=2)
        (o.sum() + a).backward()
    assert C == 20 and 0 < seen.most < T * E * C, seen.most


# ---- the model --------------------------------------------------------------

@pytest.mark.parametrize("remat", ["none", "blocks"])
def test_moe_tiny_logits_and_grads_match_jax(remat):
    jm, tm = _models(remat=remat, moe_capacity_factor=1.25)
    jp = jm.init(jax.random.key(0))
    tp = params_from_jax(tm, jax.tree.map(np.asarray, jp), "cpu")
    toks = _tokens(2, 16, seed=1)

    def jl(p):
        lo, aux = jm.apply_with_aux(p, jnp.asarray(toks))
        return jnp.mean(lo ** 2) + 0.01 * aux, (lo, aux)

    (_, (jlo, jaux)), jg = jax.value_and_grad(jl, has_aux=True)(jp)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    lo, aux = tm.apply_with_aux(tp, torch.tensor(toks))
    grads = torch.autograd.grad(torch.mean(lo ** 2) + 0.01 * aux, leaves)
    np.testing.assert_allclose(lo.detach().numpy(), np.asarray(jlo),
                               rtol=2e-5, atol=2e-5)
    assert abs(float(aux) - float(jaux)) < 1e-6
    got = params_to_jax(tree_unflatten(tp, list(grads)))
    flat, _ = jax.tree_util.tree_flatten_with_path(jg)
    for (path, want), g in zip(flat, jax.tree.leaves(got)):
        np.testing.assert_allclose(g, np.asarray(want), rtol=1e-5,
                                   atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
    assert np.abs(np.asarray(got["blocks"][0]["router"])).max() > 0.0


def test_param_shapes_and_presets_are_the_jax_packages():
    for name in ("TransformerLM-moe-tiny", "TransformerLM-moe-small",
                 "TransformerLM-moe-large"):
        jm, tm = jax_make(name), make_transformer(name)
        for f in ("num_layers", "num_heads", "d_model", "d_ff",
                  "vocab_size", "moe_experts", "moe_top_k",
                  "moe_capacity_factor", "remat"):
            assert getattr(tm, f) == getattr(jm, f), (name, f)
    tm = make_transformer("TransformerLM-moe-tiny")
    shapes = tm.param_shapes()["blocks"][0]
    assert (shapes["router"], shapes["w1"], shapes["w2"]) == (
        (128, 4), (4, 128, 256), (4, 256, 128))
    ep2 = tm.with_expert_parallel("ep", 2)
    assert ep2.param_shapes()["blocks"][0]["w1"] == (2, 128, 256)
    with pytest.raises(ValueError, match="requires a MoE model"):
        make_transformer("TransformerLM-tiny").with_expert_parallel("ep", 2)
    with pytest.raises(ValueError, match="not divisible"):
        tm.with_expert_parallel("ep", 3)
    # A dense model's aux is 0.0.
    dense = make_transformer("TransformerLM-tiny", max_seq_len=16,
                             compute_dtype=torch.float32)
    _, aux = dense.apply_with_aux(dense.init(torch.Generator()),
                                  torch.zeros(1, 16, dtype=torch.long))
    assert aux == 0.0


@pytest.mark.parametrize("preset", ["TransformerLM-moe-tiny",
                                    "TransformerLM-moe-small",
                                    "TransformerLM-moe-large"])
def test_flops_match_jax(preset):
    jm, tm = jax_make(preset), make_transformer(preset)
    for b, L in ((4, 2048), (2, 32)):
        assert flops.transformer_fwd_flops(tm, b, L) == \
            jax_flops.transformer_fwd_flops(jm, b, L)


# ---- the trainer -----------------------------------------------------------

def test_one_step_at_ep1_matches_jax():
    jm, tm = _models()
    tr = LMTrainer(tm, device="cpu",
                   optimizer=SGD(learning_rate=0.1, momentum=0.9,
                                 weight_decay=1e-4))
    state = tr.init_state(seed=3)
    jt = JaxLMTrainer(jm, make_mesh(jax.devices()[:1]),
                      optimizer=JaxSGD(learning_rate=0.1, momentum=0.9,
                                       weight_decay=1e-4))
    jp = jax.tree.map(jnp.asarray, tr.params_to_host(state))
    jstate = jt._place_state(jp, jt.optimizer.init(jp))
    tokens = _tokens()
    state, loss = tr.train_step(state, *tr.put_batch(*make_lm_batch(tokens)))
    jstate, jloss = jt.train_step(jstate, *jt.put_batch(
        *make_lm_batch(tokens)))
    assert abs(float(loss) - float(np.mean(np.asarray(jloss)))) < 1e-4
    for a, b in zip(jax.tree.leaves(tr.params_to_host(state)),
                    jax.tree.leaves(jax.device_get(jstate.params))):
        np.testing.assert_allclose(a, np.asarray(b), **STEP_TOL)
    stats = tr.route_stats(state, tokens[:, :-1])
    assert len(stats) == tm.num_layers
    for s in stats:
        np.testing.assert_allclose(s["expert_load"].sum(),
                                   1.0 - float(s["dropped_frac"]),
                                   atol=1e-6)
    line = format_route_stats(stats)
    assert line.startswith(" moe dropped=") and "imbalance=" in line
    assert line.count("/") == 2 * (tm.num_layers - 1)
    dense = LMTrainer(make_transformer("TransformerLM-tiny",
                                       max_seq_len=SEQ), device="cpu")
    assert dense.route_stats(dense.init_state(), tokens[:, :-1]) == []
    assert format_route_stats([]) == ""


def test_aux_coefficient_reaches_the_router_only():
    """``moe_aux_coef`` moves the router (and, through the router's
    input, the trunk below it) and nothing of the reported loss; the
    expert weights and the head, which the load-balance loss does not
    reach, take the same update."""
    _, tm = _models(moe_capacity_factor=1.25)
    x, y = make_lm_batch(_tokens())
    out = {}
    for coef in (0.0, 1.0):
        tr = LMTrainer(tm, device="cpu", moe_aux_coef=coef,
                       optimizer=SGD(learning_rate=0.1, momentum=0.0,
                                     weight_decay=0.0))
        st = tr.init_state(seed=0)
        st, loss = tr.train_step(st, *tr.put_batch(x, y))
        out[coef] = (float(loss), tr.params_to_host(st))
    assert out[0.0][0] == out[1.0][0]
    b0, b1 = out[0.0][1]["blocks"][-1], out[1.0][1]["blocks"][-1]
    assert not np.array_equal(b0["router"], b1["router"])
    for name in ("w1", "w2"):
        np.testing.assert_array_equal(b0[name], b1[name])
    np.testing.assert_array_equal(out[0.0][1]["head"], out[1.0][1]["head"])


WORKER = r"""
import json, os, sys, tempfile
import numpy as np
import torch
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.ops.optim import SGD, Adafactor
from tpu_ddp_torch.parallel.bootstrap import init_distributed_setup
from tpu_ddp_torch.train.lm import LMTrainer, make_lm_batch
from tpu_ddp_torch.utils.tree import keyed_leaves

torch.set_num_threads(1)
spec = json.loads(sys.argv[1])
rank, world = int(sys.argv[2]), spec["world"]
init_distributed_setup("127.0.0.1", spec["port"], rank, world,
                       device="cpu", ddp=True, timeout_s=90)
model = make_transformer("TransformerLM-moe-tiny", max_seq_len=32,
                         compute_dtype=torch.float32, **spec["model"])
opt = (SGD(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)
       if spec["opt"] == "sgd" else Adafactor(min_dim_size_to_factor=8))
tr = LMTrainer(model, device="cpu", optimizer=opt, ep=spec["ep"],
               clip_grad_norm=spec["clip"])
state = tr.init_state(seed=3)
tokens = np.asarray(spec["tokens"])
per = len(tokens) // world
x, y = tr.put_batch(*make_lm_batch(tokens[rank * per:(rank + 1) * per]))
losses = []
for _ in range(spec["steps"]):
    state, loss = tr.train_step(state, x, y)
    losses.append(float(loss))
host = tr.state_to_host(state)
# The canonical state round-trips through this rank's slices, and through
# a checkpoint written by rank 0 and read by every rank.
again = tr.state_to_host(tr.state_from_host(host))
same = all(np.array_equal(a, b) for (_, a), (_, b) in
           zip(keyed_leaves(host), keyed_leaves(again)))
ckpt = spec["ckpt"]
tr.save_checkpoint(ckpt, state)
torch.distributed.barrier()
restored = tr.state_to_host(tr.restore_checkpoint(ckpt))
same_ckpt = all(np.array_equal(a, b) for (_, a), (_, b) in
                zip(keyed_leaves(host), keyed_leaves(restored)))
stats = tr.route_stats(state, tokens[:, :-1])
rec = {"losses": losses, "same": same, "same_ckpt": same_ckpt,
       "load": [s["expert_load"].tolist() for s in stats],
       "local_w1": list(state.params["blocks"][0]["w1"].shape)}
if rank == 0:
    np.savez(spec["out"], **{k: np.asarray(v) for k, v in
                             keyed_leaves(host)})
print("REC " + json.dumps(rec))
"""


def _run_ep(tmp_path, dp, ep, opt="sgd", steps=2, clip=None, **model):
    world = dp * ep
    out = tmp_path / f"state_{dp}_{ep}_{opt}.npz"
    spec = dict(world=world, port=free_port(), ep=ep, opt=opt, steps=steps,
                clip=clip,
                model=dict(dict(moe_capacity_factor=8.0), **model),
                tokens=_tokens().tolist(), out=str(out),
                ckpt=str(tmp_path / f"ckpt_{dp}_{ep}_{opt}"))
    logs = run_ranks(lambda r: ["-c", WORKER, json.dumps(spec), str(r)],
                     world)
    recs = [json.loads(re.search(r"^REC (.*)$", log, re.M).group(1))
            for log in logs]
    d = np.load(out)
    return recs, {k: d[k] for k in d.files}


def _jax_run(dp, ep, opt="sgd", steps=2, clip=None, **model):
    jm, tm = _models(**model)
    params = LMTrainer(tm, device="cpu").init_state(seed=3).params
    jp = jax.tree.map(jnp.asarray, params_to_jax(params))
    jopt = (JaxSGD(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)
            if opt == "sgd" else JaxAdafactor(min_dim_size_to_factor=8))
    jt = JaxLMTrainer(jm, make_mesh(jax.devices()[:dp * ep], dp=dp, sp=1,
                                    mp=1, pp=1, ep=ep), optimizer=jopt,
                      clip_grad_norm=clip)
    jstate = jt._place_state(jp, jt.optimizer.init(jp))
    x, y = jt.put_batch(*make_lm_batch(_tokens()))
    losses = []
    for _ in range(steps):
        jstate, loss = jt.train_step(jstate, x, y)
        losses.append(np.asarray(loss).reshape(-1))
    return np.stack(losses), jax.device_get(jstate)


# A global-norm clip below the gradients' norm (about 2.2 at this init):
# it binds on every step, so each ep peer must see the whole model's norm.
CLIP = 0.5


@pytest.mark.parametrize("dp,ep,opt,model", [
    (1, 2, "sgd", {}), (2, 2, "sgd", {}),
    (1, 2, "sgd", dict(moe_top_k=2, moe_capacity_factor=1.25)),
    (1, 2, "adafactor", {}),
    (1, 2, "sgd", dict(clip=CLIP)), (2, 2, "sgd", dict(clip=CLIP))],
    ids=["dp1_ep2", "dp2_ep2", "dp1_ep2_top2_tight", "dp1_ep2_adafactor",
         "dp1_ep2_clip", "dp2_ep2_clip"])
def test_expert_parallel_step_matches_jax_mesh(tmp_path, dp, ep, opt,
                                               model):
    recs, host = _run_ep(tmp_path, dp, ep, opt, **model)
    want_losses, jstate = _jax_run(dp, ep, opt, **model)
    for r, rec in enumerate(recs):
        assert rec["same"] and rec["same_ckpt"], r
        assert rec["local_w1"][0] == 4 // ep
        np.testing.assert_allclose(rec["losses"], want_losses[:, r],
                                   atol=1e-4, rtol=0, err_msg=f"rank {r}")
        # route_stats runs the canonical model: every rank, one answer.
        assert rec["load"] == recs[0]["load"]
    flat, _ = jax.tree_util.tree_flatten_with_path(jstate.params)
    for path, want in flat:
        key = "params." + jax.tree_util.keystr(path, simple=True,
                                               separator=".")
        np.testing.assert_allclose(host[key], np.asarray(want), **STEP_TOL,
                                   err_msg=key)
    if opt == "adafactor":
        # The JAX per-cell layout (CellAdafactor): reduced slots of an
        # expert leaf carry a leading ep axis, placeholders stay (1,).
        opt_flat, _ = jax.tree_util.tree_flatten_with_path(
            jstate.opt_state)
        for path, want in opt_flat:
            key = "opt_state." + jax.tree_util.keystr(path, simple=True,
                                                      separator=".")
            np.testing.assert_allclose(host[key], np.asarray(want),
                                       **STEP_TOL, err_msg=key)


@pytest.mark.parametrize("env,jkw", [
    ({"TPU_DDP_LM_OPT_SHARD": "zero1"}, dict(opt_sharding="zero1")),
    ({"TPU_DDP_LM_FSDP": "1"}, dict(param_sharding="fsdp")),
    ({"TPU_DDP_LM_OPT": "adafactor", "TPU_DDP_LM_OPT_SHARD": "zero1"},
     dict(opt_sharding="zero1",
          optimizer=JaxAdafactor(min_dim_size_to_factor=8)))],
    ids=["zero1", "fsdp", "factored_zero1"])
def test_two_process_moe_layout_matches_jax_mesh(env, jkw):
    logs = _run_cli(2, dict(env, TPU_DDP_LM_PRESET="TransformerLM-moe-tiny"))
    _cli_matches_jax_mesh(logs, "TransformerLM-moe-tiny", {}, jkw)


def _cli_matches_jax_mesh(logs, preset, model_kw, jkw):
    """Each of 2 ranks' 3 printed LM CLI losses against its shard of the
    JAX ``LMTrainer`` on a 2-device mesh, from the port's seed-0 weights
    of ``preset`` with ``model_kw``."""
    printed = [[float(v) for v in re.findall(
        r"\[lm_train\] step \d+/3 loss (\S+)", log)] for log in logs]
    assert [len(p) for p in printed] == [3, 3]
    assert all("[lm_train] route moe dropped=" in log for log in logs)
    jm = jax_make(preset, max_seq_len=SEQ, compute_dtype=jnp.float32,
                  **model_kw)
    tm = make_transformer(preset, max_seq_len=SEQ,
                          compute_dtype=torch.float32, **model_kw)
    params = LMTrainer(tm, device="cpu").init_state(seed=0).params
    jparams = jax.tree.map(jnp.asarray, params_to_jax(params))
    jt = JaxLMTrainer(jm, make_mesh(jax.devices()[:2]), **jkw)
    if jkw.get("param_sharding") == "fsdp":
        flat = jt.zero3.shard_params(jax.tree.map(np.asarray, jparams))
        jstate = jt._place_state(flat, jt.zero3.init(flat))
    else:
        jstate = jt._place_state(jparams, jt.optimizer.init(jparams))
    x, y = jt.put_batch(*make_lm_batch(np.random.default_rng(1234).integers(
        0, 1024, size=(8, SEQ + 1))))
    for step in range(3):
        jstate, loss = jt.train_step(jstate, x, y)
        want = np.asarray(loss).reshape(-1)
        for r in range(2):
            assert abs(printed[r][step] - want[r]) <= 1.5e-4, (
                step, r, printed[r][step], want[r])


def test_ep_refusals():
    _, tm = _models()
    with pytest.raises(ValueError, match="divide the world"):
        LMTrainer(tm, device="cpu", ep=2)


# ---- decode and serving -----------------------------------------------------

def _serve_models(cf=8.0):
    jm = jax_make("TransformerLM-moe-tiny", max_seq_len=64,
                  compute_dtype=jnp.float32, moe_capacity_factor=cf)
    tm = make_transformer("TransformerLM-moe-tiny", max_seq_len=64,
                          compute_dtype=torch.float32,
                          moe_capacity_factor=cf)
    jp = jm.init(jax.random.key(0))
    return jm, jp, tm, params_from_jax(tm, jax.tree.map(np.asarray, jp),
                                       "cpu")


@pytest.mark.parametrize("cf", [8.0, 1.25], ids=["drop_free", "tight"])
def test_decode_stream_matches_jax_generate(cf):
    jm, jp, tm, tp = _serve_models(cf)
    prompt = _tokens(2, 7, seed=5)
    want = np.asarray(jax_generate(jm, jp, jnp.asarray(prompt), 5))
    got = generate(tm, tp, torch.as_tensor(prompt), 5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_stream_matches_whole_sequence_forward():
    """At a capacity that admits every token (cf = E) each token's MoE
    output is independent of its neighbours, so the cached greedy stream
    is the argmax stream of whole-sequence forwards."""
    _, _, tm, tp = _serve_models(cf=4.0)
    prompt = _tokens(1, 7, seed=5)
    got = generate(tm, tp, torch.as_tensor(prompt), 6)[0].tolist()
    seq = list(prompt[0])
    for i in range(6):
        logits = tm.apply(tp, torch.tensor([seq]))[0, -1]
        tok = int(logits.argmax())
        assert got[i] == tok, i
        seq.append(tok)


def test_engine_serves_moe_and_int8_refuses():
    jm, jp, tm, tp = _serve_models()
    eng = ServeEngine(tm, tp, num_slots=4, block_size=8, prefill_chunk=8,
                      device="cpu")
    cases = [(7, 5), (11, 4), (3, 6)]
    reqs = [eng.submit(_tokens(1, L, seed=20 + i)[0], n)
            for i, (L, n) in enumerate(cases)]
    eng.run()
    for i, ((L, n), req) in enumerate(zip(cases, reqs)):
        want = np.asarray(jax_generate(jm, jp, jnp.asarray(
            _tokens(1, L, seed=20 + i)), n))[0]
        assert req.tokens == want.tolist(), i
    assert eng.accounting_ok()
    for kw in (dict(decode_quant="int8"), dict(spec_k=2, spec_draft="quant")):
        with pytest.raises(ValueError, match="decode_quant"):
            ServeEngine(tm, tp, num_slots=4, block_size=8,
                        prefill_chunk=8, device="cpu", **kw)
    with pytest.raises(ValueError, match="single-device"):
        generate(tm.with_expert_parallel("ep", 2), tp,
                 torch.as_tensor(_tokens(1, 4)), 2)


def test_engine_speculation_and_prefix_cache_compose():
    """Self-draft speculation and the prefix cache run through the same
    decode path: their greedy streams equal plain decoding's."""
    _, _, tm, tp = _serve_models()
    cases = [(9, 6), (12, 5)]
    streams = []
    for kw in ({}, dict(spec_k=2, spec_draft="self-1"),
               dict(prefix_cache=True)):
        eng = ServeEngine(tm, tp, num_slots=4, block_size=8,
                          prefill_chunk=8, device="cpu", **kw)
        reqs = [eng.submit(_tokens(1, L, seed=30 + i)[0], n)
                for i, (L, n) in enumerate(cases)]
        eng.run()
        streams.append([r.tokens for r in reqs])
    assert streams[1] == streams[0] and streams[2] == streams[0]


# ---- the knobs --------------------------------------------------------------

MOE_ENV = ("TPU_DDP_MOE_EXPERTS", "TPU_DDP_MOE_TOP_K", "TPU_DDP_MOE_CAPACITY")


@pytest.mark.parametrize("env,ok", [
    ({"TPU_DDP_MOE_EXPERTS": "8", "TPU_DDP_MOE_TOP_K": "2",
      "TPU_DDP_MOE_CAPACITY": "2.0"}, True),
    ({"TPU_DDP_MOE_EXPERTS": "-1"}, False),
    ({"TPU_DDP_MOE_TOP_K": "0"}, False),
    ({"TPU_DDP_MOE_CAPACITY": "0"}, False),
    ({"TPU_DDP_MOE_CAPACITY": "nan"}, False),
    ({"TPU_DDP_MOE_EXPERTS": "four"}, False)])
def test_env_knobs_parse_as_jax(monkeypatch, env, ok):
    for name in MOE_ENV:
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if ok:
        got, want = TrainConfig(), JaxConfig()
        assert (got.moe_experts, got.moe_top_k, got.moe_capacity) == (
            want.moe_experts, want.moe_top_k, want.moe_capacity) == (
            8, 2, 2.0)
        return
    with pytest.raises(ValueError) as port:
        TrainConfig()
    with pytest.raises(ValueError) as ref:
        JaxConfig()
    assert str(port.value) == str(ref.value)


def test_launch_flags_set_the_env(monkeypatch):
    """``--moe-*`` set the env of the LM target's ranks; the image parts,
    which have no routed layer, refuse them, and ``lm`` refuses a flag of
    the image parts."""
    seen = []
    monkeypatch.setattr(launch, "launch_elastic",
                        lambda part, nproc, **kw: seen.append(kw["env"])
                        or launch.LaunchResult())
    assert launch.main(["lm", "--nproc", "1", "--moe-experts", "8",
                        "--moe-top-k", "2", "--moe-capacity", "1.5"]) == 0
    assert {k: seen[0][k] for k in MOE_ENV} == {
        "TPU_DDP_MOE_EXPERTS": "8", "TPU_DDP_MOE_TOP_K": "2",
        "TPU_DDP_MOE_CAPACITY": "1.5"}
    for argv in (["lm", "--moe-experts", "-1"], ["lm", "--moe-top-k", "0"],
                 ["lm", "--moe-capacity", "0"],
                 ["part1", "--moe-experts", "8"], ["lm", "--remat", "blocks"],
                 ["lm", "--max-restarts", "1"]):
        with pytest.raises(SystemExit):
            launch.main([argv[0], "--nproc", "1", *argv[1:]])
    assert len(seen) == 1


def test_moe_env_overrides_the_lm_preset(monkeypatch):
    from tpu_ddp_torch.examples.lm_train import moe_overrides
    for name in MOE_ENV:
        monkeypatch.delenv(name, raising=False)
    assert moe_overrides("TransformerLM-tiny") == {}
    monkeypatch.setenv("TPU_DDP_MOE_TOP_K", "2")
    with pytest.raises(ValueError, match="no routed layer"):
        moe_overrides("TransformerLM-tiny")
    assert moe_overrides("TransformerLM-moe-tiny") == {"moe_top_k": 2}
    monkeypatch.setenv("TPU_DDP_MOE_EXPERTS", "4")
    monkeypatch.setenv("TPU_DDP_MOE_CAPACITY", "2.0")
    over = moe_overrides("TransformerLM-tiny")
    assert over == {"moe_experts": 4, "moe_top_k": 2,
                    "moe_capacity_factor": 2.0}
    m = make_transformer("TransformerLM-tiny", **over)
    assert (m.moe_experts, m.moe_top_k, m.moe_capacity_factor) == (4, 2, 2.0)
    assert "router" in m.param_shapes()["blocks"][0]


def test_launched_lm_routes_a_dense_preset(monkeypatch, capsys):
    """``launch lm --moe-experts 4 --moe-top-k 2`` on TransformerLM-tiny
    trains the routed model: 2 gloo ranks' losses against the JAX mesh
    step of ``make_transformer("TransformerLM-tiny", moe_experts=4,
    moe_top_k=2)``."""
    for name in MOE_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("TPU_DDP_LM_PRESET", "TransformerLM-tiny")
    monkeypatch.setenv("TPU_DDP_LM_STEPS", "3")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert launch.main(["lm", "--nproc", "2", "--device", "cpu",
                        "--moe-experts", "4", "--moe-top-k", "2"]) == 0
    out = capsys.readouterr().out
    logs = ["\n".join(line.split("] ", 1)[1] for line in out.splitlines()
                      if line.startswith(f"[rank {r}] "))
            for r in range(2)]
    assert all("moe=4x top2" in log for log in logs), logs
    _cli_matches_jax_mesh(logs, "TransformerLM-tiny",
                          dict(moe_experts=4, moe_top_k=2), {})


def test_trials_never_search_the_moe_knobs(monkeypatch):
    """The tuner's trials train the image ladder, which no MoE knob
    reaches: even asked for by name, with the semantic knobs on, none is
    searched."""
    monkeypatch.setenv("TPU_DDP_TUNE_SEMANTIC", "1")
    monkeypatch.setenv("TPU_DDP_TUNE_KNOBS",
                       "moe_experts=0|4,moe_top_k,moe_capacity,remat")
    for name in MOE_ENV:
        monkeypatch.delenv(name, raising=False)
    names = {k.name for k, _ in tspace.searchable_knobs(
        TrainConfig(), tspace.Workload())}
    assert names == {"remat"}


@pytest.mark.parametrize("assign,ep", [
    ({"moe_experts": 0, "moe_top_k": 2}, 1),
    ({"moe_experts": 0, "moe_capacity": 2.0}, 1),
    ({"moe_experts": 4, "moe_top_k": 8}, 1),
    ({"moe_experts": 4, "moe_top_k": 2, "moe_capacity": 1.0}, 1),
    ({"moe_experts": 0}, 2), ({"moe_experts": 6}, 4),
    ({"moe_experts": 8}, 4)])
def test_knob_violations_match_jax(assign, ep):
    for k in ("moe_experts", "moe_top_k", "moe_capacity"):
        assert tspace.knob_by_field(k) is not None
    got = tspace.violations(assign, tspace.Workload(ep=ep))
    want = jspace.violations(assign, jspace.Workload(ep=ep))
    assert len(got) == len(want), (got, want)
    assert [g.split(" — ")[0] for g in got] == \
        [w.split(" — ")[0] for w in want]
