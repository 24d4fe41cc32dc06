"""Multi-process gloo runs of the port's sequence parallelism for the tests
(test_torch_ring_attention.py, test_torch_ulysses.py,
test_torch_cp_prefill.py), and the JAX runs they are held to.

Each ``*_WORKER`` runs in one subprocess per rank (tests/torch_ranks.py
``run_ranks``: a time limit, killed on the way out) and writes one
``.npz`` per rank; the parent reassembles the sequence from the ranks'
chunks. The JAX side runs the same inputs under ``jax.shard_map`` on the
test process's virtual CPU devices (tests/conftest.py).
"""

from __future__ import annotations

import json

import numpy as np

from torch_ranks import free_port, run_ranks

# One case of the attention workers: its inputs live in the data file
# under "<name>/<q|k|v|do|ck|cv|cvalid>".
ATTN_WORKER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from tpu_ddp_torch.parallel.bootstrap import init_distributed_setup
from tpu_ddp_torch.parallel.ring_attention import ring_attention
from tpu_ddp_torch.parallel.ulysses import ulysses_attention

torch.set_num_threads(1)
spec = json.loads(sys.argv[1])
rank, world = int(sys.argv[2]), spec["world"]
init_distributed_setup("127.0.0.1", spec["port"], rank, world,
                       device="cpu", ddp=True, timeout_s=90)
d = np.load(spec["data"])
out = {}
for name, case in spec["cases"].items():
    q, k, v, do = (torch.from_numpy(d[f"{name}/{t}"]) for t in
                   ("q", "k", "v", "do"))
    lc = q.shape[1] // world
    cut = slice(rank * lc, (rank + 1) * lc)
    ql, kl, vl = (t[:, cut].clone().requires_grad_() for t in (q, k, v))
    kw = {}
    if f"{name}/ck" in d.files:
        kw = dict(q_offset=case["q_offset"],
                  cache_k=torch.from_numpy(d[f"{name}/ck"]),
                  cache_v=torch.from_numpy(d[f"{name}/cv"]),
                  cache_valid=torch.from_numpy(d[f"{name}/cvalid"]))
    if case["scheme"] == "ring":
        o = ring_attention(ql, kl, vl, None, world, causal=case["causal"],
                           **kw)
    else:
        o = ulysses_attention(ql, kl, vl, None, world,
                              causal=case["causal"],
                              flash=case.get("flash", False), **kw)
    grads = torch.autograd.grad((o * do[:, cut]).sum(), (ql, kl, vl))
    for t, x in zip(("o", "dq", "dk", "dv"), (o, *grads)):
        out[f"{name}/{t}"] = x.detach().numpy()
np.savez(spec["out"] + f".{rank}.npz", **out)
dist.barrier()
sys.stdout.flush()
os._exit(0)
"""


def run_attention(tmp_path, world: int, cases: dict, arrays: dict,
                  tag: str) -> dict:
    """Every case of ``cases`` (name -> {"scheme", "causal", ...}) over
    ``world`` gloo ranks on ``arrays`` (name -> {"q", "k", "v", "do",
    ["ck", "cv", "cvalid"]}); returns name -> {"o", "dq", "dk", "dv"},
    the ranks' chunks put back in sequence order."""
    data = tmp_path / f"{tag}_in.npz"
    np.savez(data, **{f"{n}/{t}": a for n, d in arrays.items()
                      for t, a in d.items()})
    out = str(tmp_path / tag)
    spec = {"world": world, "port": str(free_port()), "cases": cases,
            "data": str(data), "out": out}
    run_ranks(lambda r: ["-c", ATTN_WORKER, json.dumps(spec), str(r)],
              world)
    recs = [dict(np.load(f"{out}.{r}.npz")) for r in range(world)]
    return {n: {t: np.concatenate([rec[f"{n}/{t}"] for rec in recs],
                                  axis=1) for t in ("o", "dq", "dk", "dv")}
            for n in cases}


def jax_attention(scheme: str, sp: int, case: dict, arrays: dict) -> dict:
    """The JAX package's ring or Ulysses attention on an sp mesh of the
    virtual CPU devices: {"o", "dq", "dk", "dv"} for the cotangent
    ``do``, as :func:`run_attention` gives them."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tpu_ddp.parallel.mesh import SEQ_AXIS, make_mesh
    from tpu_ddp.parallel.ring_attention import ring_attention
    from tpu_ddp.parallel.ulysses import ulysses_attention

    mesh = make_mesh(jax.devices()[:sp], dp=1, sp=sp)
    seq = P(None, SEQ_AXIS)
    cached = "ck" in arrays

    def fn(q, k, v, *cache):
        kw = {}
        if cached:
            kw = dict(q_offset=case["q_offset"], cache_k=cache[0],
                      cache_v=cache[1], cache_valid=cache[2])
        if scheme == "ring":
            return ring_attention(q, k, v, SEQ_AXIS, sp,
                                  causal=case["causal"], **kw)
        return ulysses_attention(q, k, v, SEQ_AXIS, sp,
                                 causal=case["causal"],
                                 flash=case.get("flash", False), **kw)

    extra = tuple(jnp.asarray(arrays[t]) for t in ("ck", "cv", "cvalid")
                  ) if cached else ()
    f = jax.shard_map(fn, mesh=mesh,
                      in_specs=(seq,) * 3 + (P(),) * len(extra),
                      out_specs=seq, check_vma=False)
    q, k, v, do = (jnp.asarray(arrays[t]) for t in ("q", "k", "v", "do"))

    def loss(q, k, v):
        o = f(q, k, v, *extra)
        return jnp.sum(o * do), o

    (_, o), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return {t: np.asarray(x) for t, x in zip(("o", "dq", "dk", "dv"),
                                             (o, *grads))}


def qkv(seed: int, b=2, L=16, h=4, kvh=4, d=8, cache: int = 0) -> dict:
    """numpy-seeded f32 inputs of one attention case (``cache`` > 0: a
    cache of that many positions, the last quarter of it invalid)."""
    rng = np.random.default_rng(seed)
    out = {"q": rng.normal(size=(b, L, h, d)),
           "k": rng.normal(size=(b, L, kvh, d)),
           "v": rng.normal(size=(b, L, kvh, d)),
           "do": rng.normal(size=(b, L, h, d))}
    if cache:
        out["ck"] = rng.normal(size=(b, cache, kvh, d))
        out["cv"] = rng.normal(size=(b, cache, kvh, d))
    out = {k: v.astype(np.float32) for k, v in out.items()}
    if cache:
        out["cvalid"] = np.arange(cache) < cache - cache // 4
    return out


# LMTrainer runs: each entry of spec["runs"] builds a trainer over the
# whole world and trains it spec["steps"] steps on this rank's rows and
# columns of spec["tokens"]; rank 0 records the canonical host state.
LM_WORKER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.ops.optim import SGD, Adafactor
from tpu_ddp_torch.parallel.bootstrap import (init_distributed_setup,
                                              mesh_groups)
from tpu_ddp_torch.train.lm import LMTrainer, make_lm_batch
from tpu_ddp_torch.utils.tree import keyed_leaves

torch.set_num_threads(1)
spec = json.loads(sys.argv[1])
rank, world = int(sys.argv[2]), spec["world"]
init_distributed_setup("127.0.0.1", spec["port"], rank, world,
                       device="cpu", ddp=True, timeout_s=90)
tokens = np.asarray(spec["tokens"])
out = {}
for name, c in spec["runs"].items():
    model = make_transformer(c["preset"], max_seq_len=spec["seq"],
                             compute_dtype=torch.float32,
                             **c.get("model", {}))
    opt = (Adafactor(min_dim_size_to_factor=8)
           if c.get("optimizer") == "adafactor" else
           SGD(learning_rate=0.1, momentum=0.9, weight_decay=1e-4))
    tr = LMTrainer(model, device="cpu", optimizer=opt,
                   sp=c["sp"], ep=c.get("ep", 1), sp_mode=c["mode"],
                   grad_accum=c.get("accum", 1),
                   opt_sharding=c.get("opt", "replicated"),
                   param_sharding=c.get("param", "replicated"))
    state = tr.init_state(seed=3)
    # This rank's rows: its (d, e) shard of the batch, P(("dp", "ep")).
    per = len(tokens) // (tr.dp * tr.ep)
    row = (rank // (tr.sp * tr.ep)) * tr.ep + tr.ep_index
    x, y = tr.put_batch(*make_lm_batch(tokens[row * per:(row + 1) * per]))
    if c.get("forward"):
        with torch.no_grad():
            out[f"{name}/logits"] = tr.model.apply(state.params, x).numpy()
    losses = []
    for _ in range(spec["steps"]):
        state, loss = tr.train_step(state, x, y)
        losses.append(float(loss))
    out[f"{name}/losses"] = np.array(losses)
    host = tr.state_to_host(state)
    if rank == 0:
        for k, v in keyed_leaves(host):
            out[f"{name}/{k}"] = np.asarray(v)
for dp, ep, sp in spec.get("groups", []):
    for kind, g in zip(("dp", "sp", "ep", "dp_sp"),
                       mesh_groups(dp, ep, sp)):
        out[f"groups/{dp}_{ep}_{sp}/{kind}"] = np.array(
            [] if g is None else dist.get_process_group_ranks(g))
np.savez(spec["out"] + f".{rank}.npz", **out)
dist.barrier()
sys.stdout.flush()
os._exit(0)
"""

SEQ = 16
PRESET = "TransformerLM-tiny"
MOE = dict(moe_capacity_factor=8.0)


def tokens(b: int = 4, seed: int = 11) -> np.ndarray:
    """(b, SEQ + 1) token ids, numpy-seeded."""
    return np.random.default_rng(seed).integers(0, 1024, size=(b, SEQ + 1))


def run_lm(tmp_path, world: int, runs: dict, tag: str, steps: int = 2,
           groups=()) -> list:
    """Every LMTrainer run of ``runs`` (name -> {"sp", "mode", "preset",
    ["ep", "accum", "opt", "param", "model", "forward", "optimizer"]})
    over ``world`` gloo ranks (SGD, or Adafactor at ``"optimizer":
    "adafactor"``); returns every rank's record."""
    out = str(tmp_path / tag)
    spec = {"world": world, "port": str(free_port()), "runs": runs,
            "tokens": tokens().tolist(), "seq": SEQ, "steps": steps,
            "groups": [list(g) for g in groups], "out": out}
    run_ranks(lambda r: ["-c", LM_WORKER, json.dumps(spec), str(r)], world)
    return [dict(np.load(f"{out}.{r}.npz")) for r in range(world)]


def port_init(preset: str = PRESET, **model):
    """The port's seed-3 parameters of ``preset`` (f32) and the port
    model."""
    import torch

    from tpu_ddp_torch.models.transformer import make_transformer
    from tpu_ddp_torch.train.lm import LMTrainer
    tm = make_transformer(preset, max_seq_len=SEQ,
                          compute_dtype=torch.float32, **model)
    return LMTrainer(tm, device="cpu").init_state(seed=3).params, tm


def jax_lm(dp: int, sp: int, mode: str, steps: int = 2, ep: int = 1,
           accum: int = 1, preset: str = PRESET, **model) -> tuple:
    """The JAX ``LMTrainer`` on ``make_mesh(dp=dp, sp=sp, ep=ep)`` from
    the port's seed-3 parameters: ((steps, dp * ep, sp) losses, the
    final state on the host)."""
    import jax
    import jax.numpy as jnp

    from tpu_ddp.models import make_transformer as jax_make
    from tpu_ddp.ops.optim import SGD as JaxSGD
    from tpu_ddp.parallel.mesh import make_mesh
    from tpu_ddp.train.lm import LMTrainer as JaxLMTrainer
    from tpu_ddp_torch.convert import params_to_jax
    from tpu_ddp_torch.train.lm import make_lm_batch
    jm = jax_make(preset, max_seq_len=SEQ, compute_dtype=jnp.float32,
                  **model)
    params, _ = port_init(preset, **model)
    jp = jax.tree.map(jnp.asarray, params_to_jax(params))
    jt = JaxLMTrainer(jm, make_mesh(jax.devices()[:dp * sp * ep], dp=dp,
                                    sp=sp, ep=ep),
                      optimizer=JaxSGD(learning_rate=0.1, momentum=0.9,
                                       weight_decay=1e-4),
                      sp_mode=mode, grad_accum=accum)
    jstate = jt._place_state(jp, jt.optimizer.init(jp))
    x, y = jt.put_batch(*make_lm_batch(tokens()))
    losses = []
    for _ in range(steps):
        jstate, loss = jt.train_step(jstate, x, y)
        losses.append(np.asarray(loss))
    return np.stack(losses), jax.device_get(jstate)


def rank_losses(recs, name: str, dp: int, sp: int, ep: int = 1):
    """(steps, dp * ep, sp): each rank's losses at its (d * ep + e, s)
    cell, the JAX trainer's layout."""
    from tpu_ddp_torch.parallel.bootstrap import mesh_coords
    steps = len(recs[0][f"{name}/losses"])
    out = np.zeros((steps, dp * ep, sp))
    for r, rec in enumerate(recs):
        d, s, e, _ = mesh_coords(r, sp, ep)
        out[:, d * ep + e, s] = rec[f"{name}/losses"]
    return out


def jax_params(jstate) -> dict:
    """The JAX state's parameters keyed as the worker's records."""
    import jax
    flat, _ = jax.tree_util.tree_flatten_with_path(jstate.params)
    return {"params." + jax.tree_util.keystr(p, simple=True, separator="."):
            np.asarray(v) for p, v in flat}
