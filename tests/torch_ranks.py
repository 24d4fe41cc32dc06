"""Multi-process gloo runs of the port's VGG ladder for the tests
(test_torch_zero.py, test_torch_ladder4.py, test_torch_compress.py,
test_torch_overlap.py, test_torch_capture.py), and the JAX ``Trainer``
runs they are held to.

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
SHALLOW = dict(stage_blocks=(1, 1, 1, 1), num_classes=10,
               small_inputs=False, use_pallas_bn=True)
KNOBS = dict(pallas_sgd=True, pallas_bn=True, compute_dtype="float32")

WORKER = r"""
import json, os, sys
import numpy as np
import torch
from tpu_ddp_torch.convert import CanonicalView
from tpu_ddp_torch.models.resnet import ResNetModel
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
if spec["model"] == "resnet":
    model = ResNetModel("shallow", compute_dtype=torch.float32,
                        **spec["shallow"])
else:
    model = VGGModel("tiny", tuple(spec["tiny"]),
                     compute_dtype=torch.float32, use_pallas_bn=True)
trainer = Trainer(model, cfg, strategy=spec["strategy"], device="cpu")
if spec.get("restore"):
    state = trainer.restore_checkpoint(spec["restore"])
else:
    state = trainer.init_state()
    if spec.get("init"):
        d = np.load(spec["init"])
        host = trainer.state_to_host(state)
        host["params"] = CanonicalView(model).tree(
            [d[f"p{i}"] for i in range(len(d.files))])
        state = trainer.state_from_host(host)
forced = None
if spec.get("relu_weights"):
    # The JAX run's ReLU derivatives, this rank's, in forward order.
    sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
    from relu_sites import force_port_relus
    w = np.load(spec["relu_weights"])
    forced = force_port_relus(setattr, [
        w[k] for k in sorted(w.files) if k.startswith(f"r{rank}_")])
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
if forced is not None:
    extra["relu_sites"] = np.array(forced.sites)
    extra["relu_moved"] = np.array(max(forced.moved, default=0.0))
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


# K steps per dispatch across ranks (tests/test_torch_capture.py): for
# each case (a strategy and config), one step from the JAX init that
# records which state tensors changed and whether the trainer's written
# set covers them (and, under the int8 wire, whether the carry kept its
# tensors across that step and across a guard-skipped one), then the
# epoch at each K of spec["ks"] from the same start.
EPOCH_WORKER = r"""
import json, os, sys
import numpy as np
import torch
from tpu_ddp_torch.convert import CanonicalView
from tpu_ddp_torch.models.vgg import VGGModel
from tpu_ddp_torch.parallel.bootstrap import init_distributed_setup
from tpu_ddp_torch.train.capture import tensors
from tpu_ddp_torch.train.engine import Trainer
from tpu_ddp_torch.utils.config import TrainConfig
from tpu_ddp_torch.utils.tree import keyed_leaves

torch.set_num_threads(1)
spec = json.loads(sys.argv[1])
rank, world = int(sys.argv[2]), spec["world"]
init_distributed_setup("127.0.0.1", spec["port"], rank, world,
                       device="cpu", ddp=True, timeout_s=90)
d, p = np.load(spec["data"]), np.load(spec["init"])
leaves = [p[f"p{i}"] for i in range(len(p.files))]
batches = [(torch.from_numpy(d["x"][s, rank]).permute(0, 3, 1, 2)
            .contiguous(), torch.from_numpy(d["y"][s, rank]))
           for s in range(d["x"].shape[0])]
out = {}


def state_tensors(tr, st):
    return [*tensors(st.params), *tensors(st.opt_state),
            *tensors(st.comp_state), *tr.model.parameters(),
            *([tr._flat] if tr._flat is not None else [])]


for name, case in spec["cases"].items():
    cfg = TrainConfig(pallas_sgd=True, pallas_bn=True,
                      compute_dtype="float32", log_every=1,
                      **case.get("cfg", {}))
    model = VGGModel("tiny", tuple(spec["tiny"]),
                     compute_dtype=torch.float32, use_pallas_bn=True)
    tr = Trainer(model, cfg, strategy=case["strategy"], device="cpu")
    host0 = tr.state_to_host(tr.init_state())
    host0["params"] = CanonicalView(model).tree(leaves)
    st = tr.state_from_host(host0)
    cands = state_tensors(tr, st)
    before = [t.detach().clone() for t in cands]
    carry = tensors(st.comp_state)
    ptrs = [t.data_ptr() for t in carry]
    st, _ = tr.train_step(st, *batches[0])
    changed = [t for t, b in zip(cands, before)
               if not torch.equal(t.detach(), b)]
    bases = {t.untyped_storage().data_ptr() for t in tr._graph_written(st)}
    out[name + "/changed"] = np.array(len(changed))
    out[name + "/written_covers"] = np.array(all(
        t.untyped_storage().data_ptr() in bases for t in changed))
    if carry:
        kept = [t.clone() for t in carry]
        x = batches[1][0].clone()
        if rank == 0:
            x[0, 0, 0, 0] = float("nan")
        st, _ = tr.train_step(st, x, batches[1][1])
        out[name + "/carry_in_place"] = np.array(
            [t.data_ptr() for t in tensors(st.comp_state)] == ptrs)
        out[name + "/carry_kept_on_skip"] = np.array(
            tr.last_step_skipped()
            and all(torch.equal(a, b) for a, b in
                    zip(tensors(st.comp_state), kept)))
    for k in spec["ks"]:
        tr.config.steps_per_dispatch = k
        lines = []
        st, stats = tr.train_epoch(tr.state_from_host(host0), batches,
                                   log=lines.append)
        pre = f"{name}/k{k}/"
        out[pre + "lines"] = np.array(lines)
        out[pre + "iters"] = np.array(stats["iters"])
        out[pre + "grouped"] = np.array(k in tr._multi_step_cache)
        for key, v in keyed_leaves(tr.state_to_host(st)):
            out[pre + key] = np.asarray(v)
np.savez(spec["out"] + f".{rank}.npz", **out)
torch.distributed.barrier()
sys.stdout.flush()
os._exit(0)
"""


def start_epochs(tmp_path, world: int, cases: dict, init, data,
                 ks=(2, 1), tag: str = "epochs"):
    """Start one gloo run of :data:`EPOCH_WORKER` over ``cases`` (name ->
    ``{"strategy": ..., "cfg": {...}}``); returns a call that waits for
    it and returns every rank's record."""
    out = str(tmp_path / tag)
    spec = {"world": world, "port": str(free_port()), "cases": cases,
            "ks": list(ks), "init": str(init), "data": str(data),
            "out": out, "tiny": list(TINY)}
    procs = start_ranks(
        lambda r: ["-c", EPOCH_WORKER, json.dumps(spec), str(r)], world)

    def finish() -> list:
        wait_ranks(procs)
        recs = []
        for r in range(world):
            with np.load(f"{out}.{r}.npz") as f:
                recs.append({k: f[k] for k in f.files})
        return recs

    return finish


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv_of_rank, world: int, timeout: float = 150,
              env=None) -> list:
    """Start ``world`` Python processes (``argv_of_rank(r)`` each), wait
    for all with a time limit, kill any still running, and require every
    one to exit 0. Returns their outputs."""
    return wait_ranks(start_ranks(argv_of_rank, world, env), timeout)


def start_ranks(argv_of_rank, world: int, env=None) -> list:
    """The first half of :func:`run_ranks`: the started processes."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               **(env or {}))
    return [subprocess.Popen([sys.executable] + argv_of_rank(r), cwd=REPO,
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def wait_ranks(procs, timeout: float = 150) -> list:
    """The second half of :func:`run_ranks`."""
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
            every_rank=False, tag=None, tiny=TINY, model="vgg",
            relu_weights=None):
    """One gloo run of :data:`WORKER`; returns rank 0's record (a dict of
    numpy arrays), or every rank's with ``every_rank``. ``relu_weights``
    (an .npz of ``r<rank>_<n>`` arrays) gives each rank's ReLUs, in
    forward order, the derivatives the JAX run took
    (tests/relu_sites.py)."""
    tag = tag or f"{strategy}-{world}"
    out = str(tmp_path / tag)
    spec = {"strategy": strategy, "world": world, "port": str(free_port()),
            "init": str(init) if init else None,
            "data": str(data) if data else None,
            "restore": str(restore) if restore else None,
            "save": str(save) if save else None, "cfg": cfg or {},
            "nan": [list(x) for x in nan], "shards": shards,
            "every_rank": every_rank, "out": out, "tiny": list(tiny),
            "model": model, "shallow": SHALLOW,
            "relu_weights": str(relu_weights) if relu_weights else None}
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


def jax_model(model: str = "vgg"):
    """The JAX side's tiny VGG or shallow ResNet."""
    import jax.numpy as jnp
    if model == "resnet":
        from tpu_ddp.models.resnet import ResNetModel as JaxResNet
        return JaxResNet("shallow", compute_dtype=jnp.float32, **SHALLOW)
    from tpu_ddp.models.vgg import VGGModel as JaxVGG
    return JaxVGG(name="tiny", cfg=TINY, compute_dtype=jnp.float32,
                  use_pallas_bn=True)


def make_inputs(path, world: int, steps: int = 2, batch: int = 4,
                seed: int = 11, model: str = "vgg", size: int = 32):
    """The initial params (the JAX init of the tiny VGG, the port's of
    the shallow ResNet; canonical leaves ``p<i>``) and ``steps`` x
    ``world`` batches of ``batch`` images of ``size`` px, saved for the
    workers; returns ``(jax params tree, x, y, init path, data path)``."""
    import jax

    if model == "resnet":
        # The port's init, carried over (the JAX ResNet's own init takes
        # seconds eagerly).
        import torch

        from tpu_ddp_torch.convert import resnet_params_to_jax
        from tpu_ddp_torch.models.resnet import ResNetModel
        params = resnet_params_to_jax(ResNetModel(
            "shallow", compute_dtype=torch.float32, **SHALLOW).init(
                torch.Generator().manual_seed(89395)))
    else:
        params = jax.tree.map(np.asarray,
                              jax_model(model).init(jax.random.key(89395)))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(steps, world, batch, size, size, 3)).astype(
        np.float32)
    y = rng.integers(0, 10, size=(steps, world, batch)).astype(np.int64)
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    init = path / "init.npz"
    np.savez(init, **{f"p{i}": a
                      for i, a in enumerate(jax.tree.leaves(params))})
    data = path / "data.npz"
    np.savez(data, x=x, y=y)
    return params, x, y, init, data


def jax_trainer(strategy: str, world: int, params, model: str = "vgg",
                **cfg):
    """The JAX ``Trainer`` of ``strategy`` on a ``world``-device CPU mesh
    (none: no mesh), placed at ``params``."""
    import jax

    from tpu_ddp.parallel.mesh import make_mesh
    from tpu_ddp.train.engine import Trainer as JaxTrainer
    from tpu_ddp.utils.config import TrainConfig as JaxConfig
    jm = jax_model(model)
    mesh = None if strategy == "none" else make_mesh(jax.devices()[:world])
    jt = JaxTrainer(jm, JaxConfig(**KNOBS, **cfg), strategy=strategy,
                    mesh=mesh)
    if model == "resnet":
        # SGD's zero momentum, without the JAX ResNet's slow init.
        host = {"params": params, "step": np.int64(0),
                "opt_state": {"momentum": jax.tree.map(np.zeros_like,
                                                       params)}}
    else:
        host = jt.state_to_host(jt.init_state())
        host["params"] = params
    return jt, jt.state_from_host(host)


def run_jax(strategy: str, world: int, params, x, y, model: str = "vgg",
            **cfg) -> dict:
    """The JAX side of :func:`run_vgg`: per-step per-replica losses
    ``(steps, world)`` and the canonical host state, keyed like the
    worker's record."""
    import jax
    jt, state = jax_trainer(strategy, world, params, model=model, **cfg)
    losses = []
    for step in range(x.shape[0]):
        xb, yb, wb = jt.put_batch(x[step].reshape(-1, *x.shape[-3:]),
                                  y[step].reshape(-1).astype(np.int32))
        state, loss = jt.train_step(state, xb, yb, wb)
        losses.append(np.asarray(loss).reshape(-1))
    host = jt.state_to_host(state)
    rec = {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
           for p, v in jax.tree_util.tree_flatten_with_path(host)[0]}
    rec["losses"] = np.array(losses)
    return rec


def run_jax_epoch(strategy: str, world: int, params, x, y, k: int,
                  model: str = "vgg", **cfg) -> dict:
    """The JAX ``Trainer``'s epoch over the ranks' batches (each step's
    global batch the concatenation of the ranks') at ``k`` steps per
    dispatch: its log lines and canonical host state, keyed like
    :data:`EPOCH_WORKER`'s record."""
    import jax
    jt, state = jax_trainer(strategy, world, params, model=model,
                            steps_per_dispatch=k, log_every=1, **cfg)
    batches = [(x[s].reshape(-1, *x.shape[-3:]),
                y[s].reshape(-1).astype(np.int32))
               for s in range(x.shape[0])]
    lines = []
    state, stats = jt.train_epoch(state, batches, log=lines.append)
    host = jt.state_to_host(state)
    rec = {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
           for p, v in jax.tree_util.tree_flatten_with_path(host)[0]}
    rec["lines"] = np.array(lines)
    rec["iters"] = np.array(stats["iters"])
    return rec


def state_keys(rec, prefix: str) -> list:
    return sorted(k for k in rec if k.startswith(prefix))
