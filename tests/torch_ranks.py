"""Multi-process gloo runs of the port's VGG ladder for the tests
(test_torch_zero.py, test_torch_ladder4.py, test_torch_compress.py,
test_torch_overlap.py), and the JAX ``Trainer`` runs they are held to.

:func:`run_vgg` starts one subprocess per rank (each with a time limit,
killed on the way out), all running :data:`WORKER`: a tiny VGG (f32
compute, both kernel knobs on, so their plain versions run on the CPU)
under one strategy, from the given canonical parameters (or a
checkpoint), for the given batches; rank 0 (or every rank) writes the
per-step losses and the trainer's canonical host state, its keys the
JAX package's pytree paths. :func:`run_jax` trains the JAX ``Trainer``
of the same strategy on an N-device CPU mesh fed the concatenation of
the ranks' batches, and returns the same record.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
TINY = (8, "M", 16, "M", 16, "M", 16, "M", 16, "M")
KNOBS = dict(pallas_sgd=True, pallas_bn=True, compute_dtype="float32")

WORKER = r"""
import json, os, sys
import numpy as np
import torch
from tpu_ddp_torch.convert import VGGCanon
from tpu_ddp_torch.models.vgg import VGGModel
from tpu_ddp_torch.parallel.bootstrap import init_distributed_setup
from tpu_ddp_torch.train.engine import Trainer
from tpu_ddp_torch.utils.config import TrainConfig
from tpu_ddp_torch.utils.tree import keyed_leaves

torch.set_num_threads(1)
spec = json.loads(sys.argv[1])
rank, world = int(sys.argv[2]), spec["world"]
init_distributed_setup("127.0.0.1", spec["port"], rank, world,
                       device="cpu", ddp=True, timeout_s=90)
cfg = TrainConfig(pallas_sgd=True, pallas_bn=True, compute_dtype="float32",
                  **spec.get("cfg", {}))
model = VGGModel("tiny", tuple(spec["tiny"]), compute_dtype=torch.float32,
                 use_pallas_bn=True)
trainer = Trainer(model, cfg, strategy=spec["strategy"], device="cpu")
if spec.get("restore"):
    state = trainer.restore_checkpoint(spec["restore"])
else:
    state = trainer.init_state()
    if spec.get("init"):
        d = np.load(spec["init"])
        host = trainer.state_to_host(state)
        host["params"] = VGGCanon(model).tree(
            [d[f"p{i}"] for i in range(len(d.files))])
        state = trainer.state_from_host(host)
losses, skipped, fired = [], [], []
if spec.get("data"):
    d = np.load(spec["data"])
    for step in range(d["x"].shape[0]):
        x = torch.from_numpy(d["x"][step, rank]).permute(0, 3, 1, 2)
        if [step, rank] in spec.get("nan", []):
            x = x.clone()
            x[0, 0, 0, 0] = float("nan")
        state, loss = trainer.train_step(state, x.contiguous(),
                                         torch.from_numpy(d["y"][step, rank]))
        losses.append(float(loss))
        skipped.append(trainer.last_step_skipped())
        if trainer._overlap is not None:
            fired.append(list(trainer._overlap.fired))
if spec.get("save"):
    trainer.save_checkpoint(spec["save"], state)
host = trainer.state_to_host(state)
extra = {}
if spec.get("shards") and trainer._layout() is not None:
    extra["shard/momentum"] = torch.cat(
        state.opt_state["momentum"]).numpy()
    if trainer.is_fsdp:
        extra["shard/params"] = trainer._flat.detach().numpy()
if rank == 0 or spec.get("every_rank"):
    np.savez(spec["out"] + f".{rank}.npz", losses=np.array(losses),
             skipped=np.array(skipped, bool), fired=np.array(fired),
             **{k: np.asarray(v) for k, v in keyed_leaves(host)}, **extra)
# Leave together, and leave without tearing the group down: under a
# loaded host a gloo group's teardown at exit has aborted a rank
# ("terminate called without an active exception") after every result
# was written. The port's shutdown runs in the ladder's own tests
# (test_torch_train.py) and the launcher's.
torch.distributed.barrier()
sys.stdout.flush()
os._exit(0)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv_of_rank, world: int, timeout: float = 150,
              env=None) -> list:
    """Start ``world`` Python processes (``argv_of_rank(r)`` each), wait
    for all with a time limit, kill any still running, and require every
    one to exit 0. Returns their outputs."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               **(env or {}))
    procs = [subprocess.Popen([sys.executable] + argv_of_rank(r), cwd=REPO,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exit {p.returncode}: " \
            + log[-4000:]
    return logs


def run_vgg(tmp_path, strategy: str, world: int, *, init=None, data=None,
            restore=None, save=None, cfg=None, nan=(), shards=False,
            every_rank=False, tag=None, tiny=TINY):
    """One gloo run of :data:`WORKER`; returns rank 0's record (a dict of
    numpy arrays), or every rank's with ``every_rank``."""
    tag = tag or f"{strategy}-{world}"
    out = str(tmp_path / tag)
    spec = {"strategy": strategy, "world": world, "port": str(free_port()),
            "init": str(init) if init else None,
            "data": str(data) if data else None,
            "restore": str(restore) if restore else None,
            "save": str(save) if save else None, "cfg": cfg or {},
            "nan": [list(x) for x in nan], "shards": shards,
            "every_rank": every_rank, "out": out, "tiny": list(tiny)}
    logs = run_ranks(lambda r: ["-c", WORKER, json.dumps(spec), str(r)],
                     world)
    ranks = range(world) if every_rank else (0,)
    recs = []
    for r in ranks:
        with np.load(f"{out}.{r}.npz") as f:
            recs.append({k: f[k] for k in f.files})
    for rec in recs:
        rec["_log"] = logs[0]
    return recs if every_rank else recs[0]


def make_inputs(path, world: int, steps: int = 2, batch: int = 4,
                seed: int = 11):
    """The JAX init of the tiny VGG (canonical leaves ``p<i>``) and
    ``steps`` x ``world`` batches of ``batch`` images, saved for the
    workers; returns ``(jax params tree, x, y, init path, data path)``."""
    import jax
    import jax.numpy as jnp

    from tpu_ddp.models.vgg import VGGModel as JaxVGG
    jm = JaxVGG(name="tiny", cfg=TINY, compute_dtype=jnp.float32,
                use_pallas_bn=True)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(89395)))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(steps, world, batch, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(steps, world, batch)).astype(np.int64)
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    init = path / "init.npz"
    np.savez(init, **{f"p{i}": a
                      for i, a in enumerate(jax.tree.leaves(params))})
    data = path / "data.npz"
    np.savez(data, x=x, y=y)
    return params, x, y, init, data


def jax_trainer(strategy: str, world: int, params, **cfg):
    """The JAX ``Trainer`` of ``strategy`` on a ``world``-device CPU mesh
    (none: no mesh), placed at ``params``."""
    import jax
    import jax.numpy as jnp

    from tpu_ddp.models.vgg import VGGModel as JaxVGG
    from tpu_ddp.parallel.mesh import make_mesh
    from tpu_ddp.train.engine import Trainer as JaxTrainer
    from tpu_ddp.utils.config import TrainConfig as JaxConfig
    jm = JaxVGG(name="tiny", cfg=TINY, compute_dtype=jnp.float32,
                use_pallas_bn=True)
    mesh = None if strategy == "none" else make_mesh(jax.devices()[:world])
    jt = JaxTrainer(jm, JaxConfig(**KNOBS, **cfg), strategy=strategy,
                    mesh=mesh)
    state = jt.init_state()
    host = jt.state_to_host(state)
    host["params"] = params
    return jt, jt.state_from_host(host)


def run_jax(strategy: str, world: int, params, x, y, **cfg) -> dict:
    """The JAX side of :func:`run_vgg`: per-step per-replica losses
    ``(steps, world)`` and the canonical host state, keyed like the
    worker's record."""
    import jax
    jt, state = jax_trainer(strategy, world, params, **cfg)
    losses = []
    for step in range(x.shape[0]):
        xb, yb, wb = jt.put_batch(x[step].reshape(-1, 32, 32, 3),
                                  y[step].reshape(-1).astype(np.int32))
        state, loss = jt.train_step(state, xb, yb, wb)
        losses.append(np.asarray(loss).reshape(-1))
    host = jt.state_to_host(state)
    rec = {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
           for p, v in jax.tree_util.tree_flatten_with_path(host)[0]}
    rec["losses"] = np.array(losses)
    return rec


def state_keys(rec, prefix: str) -> list:
    return sorted(k for k in rec if k.startswith(prefix))
