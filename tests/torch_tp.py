"""Multi-process gloo runs of the port's tensor parallelism for the tests
(test_torch_tensor_parallel.py, test_torch_lm_tp.py,
test_torch_serve_tp.py), and the JAX runs they are held to.

Each ``*_WORKER`` runs in one subprocess per rank (tests/torch_ranks.py
``start_ranks``/``wait_ranks``: a time limit, killed on the way out) and
writes one ``.npz`` per rank; the parent assembles the ranks' cells
(``convert.params_from_cells``). The JAX side runs the same inputs under
``jax.shard_map`` on the test process's virtual CPU devices
(tests/conftest.py), while the ranks run.
"""

from __future__ import annotations

import json

import numpy as np

from torch_ranks import free_port, start_ranks, wait_ranks

SEQ = 16
PRESET = "TransformerLM-tiny"
MOE_PRESET = "TransformerLM-moe-tiny"
MOE = dict(moe_capacity_factor=8.0)


def tokens(b: int = 4, seed: int = 11) -> np.ndarray:
    """(b, SEQ + 1) token ids, numpy-seeded."""
    return np.random.default_rng(seed).integers(0, 1024, size=(b, SEQ + 1))


def launch(worker: str, world: int, spec: dict):
    """Start ``worker`` on ``world`` gloo ranks with ``spec`` (a port and
    the ranks' output prefix added); returns a handle for :func:`collect`."""
    spec = dict(spec, world=world, port=str(free_port()))
    procs = start_ranks(lambda r: ["-c", worker, json.dumps(spec), str(r)],
                        world)
    return procs, spec["out"], world


def collect(handle, timeout: float = 150) -> list:
    """Every rank's record of a :func:`launch`."""
    procs, out, world = handle
    wait_ranks(procs, timeout)
    return [dict(np.load(f"{out}.{r}.npz")) for r in range(world)]


_HEAD = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from tpu_ddp_torch.parallel.bootstrap import init_distributed_setup

torch.set_num_threads(1)
spec = json.loads(sys.argv[1])
rank, world = int(sys.argv[2]), spec["world"]
init_distributed_setup("127.0.0.1", spec["port"], rank, world,
                       device="cpu", ddp=True, timeout_s=90)
out = {}
"""

_TAIL = r"""
np.savez(spec["out"] + f".{rank}.npz", **out)
dist.barrier()
sys.stdout.flush()
os._exit(0)
"""

# f and g at the world's tp, then each case's loss and this rank's
# gradients: the model at tp = world over the world group, from the
# seed-3 parameters cut to this rank's cell.
MODEL_WORKER = _HEAD + r"""
from tpu_ddp_torch.convert import params_to_cell
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.ops.loss import softmax_cross_entropy
from tpu_ddp_torch.parallel.tensor_parallel import tp_input, tp_output
from tpu_ddp_torch.utils.tree import keyed_leaves, tree_leaves, tree_unflatten

g = torch.Generator().manual_seed(5)
x = torch.randn(3, 4, generator=g) + rank
w = torch.randn(3, 4, generator=g) * (rank + 1)
xg = x.clone().requires_grad_()
y = tp_output(xg, dist.group.WORLD)
(y * w).sum().backward()
out["g/y"], out["g/dx"] = y.detach().numpy(), xg.grad.numpy()
xf = x.clone().requires_grad_()
z = tp_input(xf, dist.group.WORLD)
(z * w).sum().backward()
out["f/z"], out["f/dx"] = z.detach().numpy(), xf.grad.numpy()
toks = np.asarray(spec["tokens"])
inputs, targets = (torch.as_tensor(toks[:, :-1]),
                   torch.as_tensor(toks[:, 1:]))
for name, c in spec["cases"].items():
    dense = make_transformer(c["preset"], max_seq_len=spec["seq"],
                             compute_dtype=torch.float32, **c["model"])
    params = dense.init(torch.Generator().manual_seed(3))
    tm = dense.with_tensor_parallel("mp", world, dist.group.WORLD)
    local = params_to_cell(params, tm.param_specs(), {"mp": rank},
                           {"mp": world})
    leaves = [p.clone().requires_grad_() for p in tree_leaves(local)]
    lp = tree_unflatten(local, leaves)
    logits, aux = tm.apply_with_aux(lp, inputs)
    loss = softmax_cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 targets.reshape(-1)).mean() + 0.01 * aux
    grads = torch.autograd.grad(loss, leaves)
    out[f"{name}/loss"] = loss.detach().numpy()
    out[f"{name}/logits"] = logits.detach().numpy()
    for k, v in keyed_leaves(tree_unflatten(local, list(grads)), "grads"):
        out[f"{name}/{k}"] = v.numpy()
""" + _TAIL


def jax_model_grads(preset: str, tp: int, model: dict, toks) -> tuple:
    """The JAX model ``with_tensor_parallel`` on a tp mesh of the virtual
    devices (tests/test_tensor_parallel.py's ``_tp_apply`` way), from the
    port's seed-3 parameters: (loss, logits, {"grads.<path>": dense})."""
    import jax
    import jax.numpy as jnp
    import torch
    from jax.sharding import PartitionSpec as P

    from tpu_ddp.models import make_transformer as jax_make
    from tpu_ddp.ops.loss import softmax_cross_entropy
    from tpu_ddp.parallel.mesh import MODEL_AXIS, make_mesh
    from tpu_ddp_torch.convert import params_to_jax
    from tpu_ddp_torch.models.transformer import make_transformer
    dense = make_transformer(preset, max_seq_len=SEQ,
                             compute_dtype=torch.float32, **model)
    params = jax.tree.map(jnp.asarray, params_to_jax(
        dense.init(torch.Generator().manual_seed(3))))
    jm = jax_make(preset, max_seq_len=SEQ, compute_dtype=jnp.float32,
                  **model).with_tensor_parallel(MODEL_AXIS, tp)
    specs = jm.param_specs()
    mesh = make_mesh(jax.devices()[:tp], dp=1, mp=tp)
    x, y = jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:])

    def loss_fn(p):
        logits, aux = jm.apply_with_aux(p, x)
        nll = softmax_cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                    y.reshape(-1))
        return jnp.mean(nll) + 0.01 * aux, logits

    f = jax.jit(jax.shard_map(
        jax.value_and_grad(loss_fn, has_aux=True), mesh=mesh,
        in_specs=(specs,), out_specs=((P(), P()), specs), check_vma=False))
    (loss, logits), grads = f(params)
    flat, _ = jax.tree_util.tree_flatten_with_path(grads)
    return (np.asarray(loss), np.asarray(logits),
            {"grads." + jax.tree_util.keystr(p, simple=True, separator="."):
             np.asarray(v) for p, v in flat})


# LMTrainer runs over the world: each entry of spec["runs"] builds a
# trainer (sp, tp, ep, layouts, optimizer, clip, dropout) and trains it
# spec["steps"] steps on this rank's rows (its (d, e) shard, the same on
# every tp peer) of spec["tokens"]; rank 0 records the canonical host
# state. "save": a checkpoint directory written at the end; "restore": a
# checkpoint restored instead of training.
LM_WORKER = _HEAD + r"""
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.ops.optim import SGD, Adafactor
from tpu_ddp_torch.train.lm import LMTrainer, make_lm_batch
from tpu_ddp_torch.utils.tree import keyed_leaves

toks = np.asarray(spec["tokens"])
for name, c in spec["runs"].items():
    model = make_transformer(c.get("preset", "TransformerLM-tiny"),
                             max_seq_len=spec["seq"],
                             compute_dtype=torch.float32,
                             **c.get("model", {}))
    opt = (Adafactor(min_dim_size_to_factor=8)
           if c.get("optimizer") == "adafactor" else
           SGD(learning_rate=0.1, momentum=0.9, weight_decay=1e-4))
    tr = LMTrainer(model, device="cpu", optimizer=opt, sp=c.get("sp", 1),
                   tp=c["tp"], ep=c.get("ep", 1),
                   sp_mode=c.get("mode", "ring"),
                   opt_sharding=c.get("opt", "replicated"),
                   param_sharding=c.get("param", "replicated"),
                   clip_grad_norm=c.get("clip"),
                   dropout_seed=c.get("dropout_seed", 0))
    if c.get("restore"):
        state = tr.restore_checkpoint(c["restore"])
    else:
        state = tr.init_state(seed=3)
    per = len(toks) // (tr.dp * tr.ep)
    row = tr.data_index // (tr.sp * tr.ep) * tr.ep + tr.ep_index
    x, y = tr.put_batch(*make_lm_batch(toks[row * per:(row + 1) * per]))
    losses = []
    if c.get("multi"):
        # The K-step call: all the steps in one build_multi_step run.
        k = spec["steps"]
        state, ls = tr.build_multi_step(k)(state, [x] * k, [y] * k)
        losses = [float(v) for v in ls]
    for _ in range(0 if c.get("restore") or c.get("multi")
                   else spec["steps"]):
        state, loss = tr.train_step(state, x, y)
        losses.append(float(loss))
    out[f"{name}/losses"] = np.array(losses)
    out[f"{name}/coords"] = np.array([tr.data_index, tr.tp_index])
    if model.dropout_rate > 0:
        out[f"{name}/key"] = np.array([tr.step_key(s) for s in range(3)])
    if c.get("save"):
        tr.save_checkpoint(c["save"], state)
    host = tr.state_to_host(state)
    if rank == 0:
        for k, v in keyed_leaves(host):
            out[f"{name}/{k}"] = np.asarray(v)
""" + _TAIL


def lm_runs(tmp_path, world: int, runs: dict, tag: str, steps: int = 2):
    """Start :data:`LM_WORKER` for ``runs`` over ``world`` ranks."""
    return launch(LM_WORKER, world, {
        "runs": runs, "tokens": tokens().tolist(), "seq": SEQ,
        "steps": steps, "out": str(tmp_path / tag)})


def jax_trainer(dp: int, sp: int = 1, tp: int = 1, ep: int = 1,
                preset: str = PRESET, model=None, optimizer: str = "sgd",
                mode: str = "ring", opt: str = "replicated",
                param: str = "replicated", clip=None, dropout_seed: int = 0):
    """The JAX ``LMTrainer`` on ``make_mesh(dp, sp, mp=tp, ep)`` of the
    virtual devices and its state from the port's seed-3 parameters."""
    import jax
    import jax.numpy as jnp
    import torch

    from tpu_ddp.models import make_transformer as jax_make
    from tpu_ddp.ops.optim import SGD as JaxSGD
    from tpu_ddp.ops.optim import Adafactor as JaxAdafactor
    from tpu_ddp.parallel.mesh import make_mesh
    from tpu_ddp.train.lm import LMTrainer as JaxLMTrainer
    from tpu_ddp_torch.convert import params_to_jax
    from tpu_ddp_torch.models.transformer import make_transformer
    from tpu_ddp_torch.train.lm import LMTrainer
    model = model or {}
    pm = make_transformer(preset, max_seq_len=SEQ,
                          compute_dtype=torch.float32, **model)
    params = LMTrainer(pm, device="cpu").init_state(seed=3).params
    jp = jax.tree.map(jnp.asarray, params_to_jax(params))
    jm = jax_make(preset, max_seq_len=SEQ, compute_dtype=jnp.float32,
                  **model)
    jopt = (JaxAdafactor(min_dim_size_to_factor=8)
            if optimizer == "adafactor" else
            JaxSGD(learning_rate=0.1, momentum=0.9, weight_decay=1e-4))
    jt = JaxLMTrainer(jm, make_mesh(jax.devices()[:dp * sp * tp * ep],
                                    dp=dp, sp=sp, mp=tp, ep=ep),
                      optimizer=jopt, sp_mode=mode, opt_sharding=opt,
                      param_sharding=param, clip_grad_norm=clip,
                      dropout_seed=dropout_seed)
    if jt.is_fsdp:
        flat = jt.zero3.shard_params(jp)
        return jt, jt._place_state(flat, jt.zero3.init(flat))
    return jt, jt._place_state(jp, jt.optimizer.init(jp))


def jax_train(jt, state, steps: int = 2) -> tuple:
    """``steps`` JAX steps on :func:`tokens`: ((steps, dp * ep, sp)
    losses, the final state)."""
    from tpu_ddp_torch.train.lm import make_lm_batch
    x, y = jt.put_batch(*make_lm_batch(tokens()))
    losses = []
    for _ in range(steps):
        state, loss = jt.train_step(state, x, y)
        losses.append(np.asarray(loss))
    return np.stack(losses), state


def jax_host_params(jt, state) -> dict:
    """The JAX state's canonical parameters keyed as the records."""
    import jax
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jt.params_to_host(state))
    return {"params." + jax.tree_util.keystr(p, simple=True, separator="."):
            np.asarray(v) for p, v in flat}


def rank_losses(recs, name: str, dp: int, sp: int = 1, ep: int = 1):
    """(steps, dp * ep, sp): the losses of each data shard's tp rank 0,
    the JAX trainer's layout; asserts every tp peer's equal."""
    steps = len(recs[0][f"{name}/losses"])
    out = np.full((steps, dp * ep, sp), np.nan)
    for rec in recs:
        data, t = (int(v) for v in rec[f"{name}/coords"])
        cell = (data // (sp * ep), (data // ep) % sp, data % ep)
        got = rec[f"{name}/losses"]
        if t == 0:
            out[:, cell[0] * ep + cell[2], cell[1]] = got
    for rec in recs:
        data, t = (int(v) for v in rec[f"{name}/coords"])
        cell = (data // (sp * ep), (data // ep) % sp, data % ep)
        np.testing.assert_allclose(
            rec[f"{name}/losses"], out[:, cell[0] * ep + cell[2], cell[1]],
            rtol=1e-6, atol=1e-6)
    return out


# Serving: the engine over the world as one tp group (dense params from
# seed 3, each rank keeping its slices) on spec["cases"] greedy
# requests; ``generate`` over the group; from_checkpoint under budgets.
SERVE_WORKER = _HEAD + r"""
from tpu_ddp_torch.models.generate import generate
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.parallel.tensor_parallel import shard_decode_params
from tpu_ddp_torch.serve.engine import ServeEngine
from tpu_ddp_torch.utils.tree import keyed_leaves, keyed_unflatten

model = make_transformer("TransformerLM-tiny", max_seq_len=64,
                         compute_dtype=torch.float32)
d = np.load(spec["params"])
skel = model.init(torch.Generator().manual_seed(0))
params = keyed_unflatten(skel, [torch.from_numpy(d[k]) for k, _ in
                                keyed_leaves(skel, "params")])
grp = dist.group.WORLD
for quant in spec["quants"]:
    eng = ServeEngine(model, params, device="cpu", tp_group=grp,
                      decode_quant=quant, **spec["geom"])
    out[f"{quant}/pool"] = np.array(eng.pool.k.shape)
    reqs = [eng.submit(np.asarray(p), n) for p, n in spec["cases"]]
    eng.run()
    for i, r in enumerate(reqs):
        out[f"{quant}/{i}/tokens"] = np.array(r.tokens)
        out[f"{quant}/{i}/logprobs"] = np.array(r.logprobs)
    if quant == "int8":
        qp = eng._decode_params
        for i, blk in enumerate(qp["blocks"]):
            for k, v in blk.items():
                if hasattr(v, "q"):
                    out[f"q/{i}/{k}/q"] = v.q.numpy()
                    out[f"q/{i}/{k}/s"] = v.s.numpy()
        out["q/head/q"], out["q/head/s"] = (qp["head"].q.numpy(),
                                            qp["head"].s.numpy())
p0, n0 = spec["cases"][0]
mine = shard_decode_params(model, params, world, rank)
out["generate"] = generate(model, mine, torch.as_tensor(p0)[None], n0,
                           tp_group=grp).numpy()
for kw in spec["refuse"]:
    try:
        ServeEngine(model, params, device="cpu", tp_group=grp,
                    **dict(spec["geom"], **kw))
    except NotImplementedError as e:
        out["refuse/" + ",".join(kw)] = np.array(str(e))
for budget in spec["budgets"]:
    eng = ServeEngine.from_checkpoint(model, spec["ckpt"], device="cpu",
                                      param_budget_bytes=budget,
                                      **spec["geom"])
    r = eng.submit(np.asarray(p0), n0)
    eng.run()
    out[f"budget/{budget}/tp"] = np.array(eng.tp)
    out[f"budget/{budget}/tokens"] = np.array(r.tokens)
""" + _TAIL
