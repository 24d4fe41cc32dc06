"""Elastic membership in the port (tpu_ddp_torch/resilience/elastic.py,
launch.py ``--elastic-reshard``, train/engine.py ``rebind`` and the
membership watch, parallel/redistribute.py ``redistribute_state``) held
to the JAX package's.

- The protocol files (membership, departures, acks, the beacon), each
  written by one package and read by the other, and the controller's
  reading of them the same in both.
- ``redistribute_state`` in process, across the VGG rungs at a group of
  one (bit for bit through the canonical host tree), and the int8
  wire's carry kept across a rebind at the same dp and reset when dp
  changes (3 gloo ranks that meet again as 3, then as 2).
- The 2-rank gloo drills of tests/test_chaos_multiprocess.py through the
  port's launcher, run side by side (each launcher call has its own
  time limit): ``host-loss`` (the survivor carries its live state; its
  last loss, test loss and final canonical state are the JAX
  ``Trainer``'s at dp 2 up to the loss, moved by JAX's
  ``redistribute_state`` to dp 1 and continued on the batches the JAX
  loader gives rank 0 of world 1 from ``next_iter``; tolerance rtol
  1e-4 / atol 1e-5 as in tests/test_torch_zero.py, and 1e-4 relative for
  the losses, which the metrics file rounds to five decimals), an
  unannounced ``hard-exit`` (the launcher writes the notice),
  ``host-join`` (the rejoiner restores from the beacon; both ranks
  evaluate to the same line) and ZeRO-1 at 2 processes (exit 17, and
  ``launch_elastic`` restarts from the checkpoint).
"""

import concurrent.futures
import itertools
import json
import os

import jax
import numpy as np
import pytest
import torch

from torch_ranks import TINY, free_port, run_ranks
from tpu_ddp.resilience import elastic as jel
from tpu_ddp_torch import launch
from tpu_ddp_torch.models.vgg import VGGModel
from tpu_ddp_torch.parallel.bootstrap import (elastic_bootstrap,
                                              elastic_teardown)
from tpu_ddp_torch.parallel.redistribute import redistribute_state
from tpu_ddp_torch.resilience import chaos
from tpu_ddp_torch.resilience import elastic as el
from tpu_ddp_torch.resilience.watchdog import HeartbeatMonitor
from tpu_ddp_torch.train.engine import Trainer
from tpu_ddp_torch.utils.config import TrainConfig

RTOL, ATOL = 1e-4, 1e-5
SMOKE_ENV = {
    "TPU_DDP_SYNTH_SIZE": "64",
    "TPU_DDP_MAX_ITERS": "3",
    "TPU_DDP_GLOBAL_BATCH": "16",
    "CIFAR10_DIR": "/nonexistent-so-synthetic",
    "TPU_DDP_COMPUTE_DTYPE": "float32",
    "OMP_NUM_THREADS": "1",
}
# The held-to-JAX host-loss drill: two steps at world 2, then two at
# world 1 from next_iter 2, at lr 0.01. The launcher runs the preset's
# full-width VGG-11, whose f32 trajectories in the two packages part at
# the default lr 0.1 within two steps at batch 8 with no reshard at all
# (parameters 1.2e-4 apart after step 2 of part 1 on the same batches: a
# ReLU input near 0 lands on either side and BatchNorm over 8 rows
# magnifies it); at lr 0.01 the drill's parameters stay within 2.4e-7 of
# JAX's over its four steps, so the bound tests the reshard, not the
# summation order.
HELD_ITERS = 4
HELD_ENV = {"TPU_DDP_MAX_ITERS": str(HELD_ITERS), "TPU_DDP_LR": "0.01"}
PACKAGES = {"port": el, "jax": jel}


# ---- the protocol files --------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_membership_record_crosses_the_packages(tmp_path, writer, reader):
    w, r = PACKAGES[writer], PACKAGES[reader]
    rec = {"epoch": 3, "world": 2, "base_world": 3,
           "assignments": {"0": 0, "2": 1}, "coordinator": "127.0.0.1:5",
           "joiners": [], "dropped": [1]}
    w.write_membership(str(tmp_path / "a"), rec)
    assert r.read_membership(str(tmp_path / "a")) == rec
    # The same bytes, whichever package wrote them.
    r.write_membership(str(tmp_path / "b"), rec)
    assert (tmp_path / "a" / "membership.json").read_bytes() == (
        tmp_path / "b" / "membership.json").read_bytes()
    assert r.read_membership(str(tmp_path / "none")) is None


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_departures_and_acks_cross_the_packages(tmp_path, writer, reader):
    w, r = PACKAGES[writer], PACKAGES[reader]
    d = str(tmp_path)
    w.announce_departure(d, 1, "host-loss")
    w.announce_departure(d, 4)
    assert r.departures(d) == {1: "host-loss", 4: "lost"}
    r.clear_departure(d, 4)
    assert w.departures(d) == {1: "host-loss"}
    w.write_ack(d, 2, 1)
    assert os.path.exists(r.ack_path(d, 2, 1))
    assert not os.path.exists(r.ack_path(d, 2, 0))
    assert w.ack_path(d, 2, 1) == r.ack_path(d, 2, 1)
    assert w.beacon_dir(d, 5) == r.beacon_dir(d, 5)
    os.makedirs(w.beacon_dir(d, 5))
    r.reset_control_dir(d)
    assert sorted(os.listdir(d)) == []


def test_controller_reads_the_protocol_as_jax_does(tmp_path, monkeypatch):
    """The same directory history through both controllers: the same
    answers from ``from_env``, ``changed`` and ``await_membership``."""
    d = str(tmp_path)
    monkeypatch.setenv("TPU_DDP_ELASTIC_RESHARD", "1")
    monkeypatch.setenv("TPU_DDP_ELASTIC_DIR", d)
    monkeypatch.setenv("TPU_DDP_ELASTIC_RANK", "0")
    el.write_membership(d, {"epoch": 1, "world": 2,
                            "assignments": {"0": 0, "2": 1},
                            "coordinator": "x:1", "joiners": [],
                            "dropped": [1]})
    el.announce_departure(d, 1)        # already folded into epoch 1
    ctls = {k: m.ElasticController.from_env() for k, m in PACKAGES.items()}
    history = []
    for step in range(3):
        history.append({k: (c.epoch, c.changed()) for k, c in ctls.items()})
        if step == 0:
            jel.announce_departure(d, 2, "host-join")
        if step == 1:
            el.write_membership(d, {"epoch": 2, "world": 1,
                                    "assignments": {"0": 0},
                                    "coordinator": "x:2", "joiners": [],
                                    "dropped": [1, 2]})
    assert [h["port"] for h in history] == [h["jax"] for h in history]
    assert [h["port"][1] for h in history] == [False, True, True]
    for k, c in ctls.items():
        assert c.await_membership(deadline_s=1)["epoch"] == 2, k
        c.epoch = 2
        with pytest.raises(TimeoutError):
            c.await_membership(deadline_s=0.1)
    monkeypatch.delenv("TPU_DDP_ELASTIC_DIR")
    assert el.ElasticController.from_env() is None


def _tiny_trainer(strategy="none", **cfg):
    model = VGGModel("tiny", TINY, compute_dtype=torch.float32,
                     use_pallas_bn=True)
    return Trainer(model, TrainConfig(pallas_sgd=True, pallas_bn=True,
                                      compute_dtype="float32", **cfg),
                   strategy=strategy, device="cpu")


def _batch(seed=0, n=4):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, 3, 32, 32)).astype(
        np.float32))
    return x, torch.from_numpy(rng.integers(0, 10, n).astype(np.int64))


def _assert_bitwise(got, want):
    gl = jax.tree_util.tree_flatten_with_path(got)[0]
    wl = jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for (path, a), b in zip(gl, wl):
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b),
            err_msg=jax.tree_util.keystr(path))


def test_beacon_crosses_the_packages(tmp_path):
    """A port survivor's beacon restores in the JAX trainer bit for bit,
    and a JAX beacon in the port's."""
    from torch_ranks import jax_trainer
    tr = _tiny_trainer()
    state = tr.init_state()
    state, _ = tr.train_step(state, *_batch())
    host = tr.state_to_host(state, local_only=True)
    bdir = el.write_beacon(str(tmp_path), 1, tr, host,
                           {"epoch": 0, "next_iter": 3})
    assert bdir == jel.beacon_dir(str(tmp_path), 1)
    with open(os.path.join(bdir, "beacon_meta.json")) as f:
        assert json.load(f) == {"epoch": 0, "next_iter": 3}
    jt, _ = jax_trainer("none", 1, host["params"])
    jstate = jt.restore_checkpoint(bdir)
    _assert_bitwise(jt.state_to_host(jstate), host)
    # The JAX survivor's beacon, as its apply_membership writes it.
    from tpu_ddp.utils import checkpoint as jckpt
    jdir = jel.beacon_dir(str(tmp_path / "j"), 2)
    jckpt.save_checkpoint(jdir, jt.state_to_host(jstate), step=1)
    jt.sharding_plan().save(jdir)
    other = _tiny_trainer()
    _assert_bitwise(other.state_to_host(other.restore_checkpoint(jdir)),
                    host)


def test_local_only_refuses_cross_process_shards(monkeypatch):
    tr = _tiny_trainer()
    state = tr.init_state()
    monkeypatch.setattr(tr, "is_zero", True)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(RuntimeError, match="checkpoint restart"):
        tr.state_to_host(state, local_only=True)


# ---- redistribute_state ---------------------------------------------------

@pytest.fixture
def group_of_one():
    elastic_bootstrap(f"127.0.0.1:{free_port()}", 1, 0, "cpu")
    try:
        yield
    finally:
        elastic_teardown()


def test_redistribute_across_the_rungs_bit_for_bit(group_of_one):
    """part 3 -> 4 -> 5 -> 3 (and to part 1) at a group of one: each move
    carries the canonical state bit for bit, and a move onto the same
    trainer is the identity."""
    src = _tiny_trainer("fused")
    state = src.init_state()
    for seed in range(2):
        state, _ = src.train_step(state, *_batch(seed))
    want = src.state_to_host(state)
    assert redistribute_state(state, src, src) is state
    cur_tr, cur = src, state
    for strategy in ("zero", "fsdp", "fused", "none"):
        dst = _tiny_trainer(strategy)
        cur = redistribute_state(cur, cur_tr, dst)
        assert cur.step == state.step
        _assert_bitwise(dst.state_to_host(cur), want)
        cur_tr = dst
    # The moved state trains on: one more step agrees with the source's.
    _, a = src.train_step(state, *_batch(5))
    _, b = cur_tr.train_step(cur, *_batch(5))
    assert float(a) == float(b)


def test_plan_resolves_only_the_data_axis():
    from tpu_ddp_torch.parallel.redistribute import ShardingPlan
    plan = ShardingPlan("fused", (("dp", 4), ("sp", 1), ("mp", 2)), {}, {})
    assert plan.axis_sizes == {"dp": 4, "sp": 1, "mp": 2}
    assert plan.resolve_axes(6) == {"dp": 3, "sp": 1, "mp": 2}
    with pytest.raises(ValueError, match="multiple of 2"):
        plan.resolve_axes(5)


REBIND_WORKER = r"""
import json, os, sys, warnings
import numpy as np
import torch
from tpu_ddp_torch.models.vgg import VGGModel
from tpu_ddp_torch.parallel.bootstrap import (elastic_bootstrap,
                                              elastic_teardown,
                                              init_distributed_setup)
from tpu_ddp_torch.train.engine import Trainer
from tpu_ddp_torch.utils.config import TrainConfig
from tpu_ddp_torch.utils.tree import keyed_leaves

TINY = (8, "M", 16, "M", 16, "M", 16, "M", 16, "M")


def _tiny_trainer(strategy, **cfg):
    model = VGGModel("tiny", TINY, compute_dtype=torch.float32,
                     use_pallas_bn=True)
    return Trainer(model, TrainConfig(pallas_sgd=True, pallas_bn=True,
                                      compute_dtype="float32", **cfg),
                   strategy=strategy, device="cpu")


def _batch(seed, n=4):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, 3, 32, 32)).astype(
        np.float32))
    return x, torch.from_numpy(rng.integers(0, 10, n).astype(np.int64))


torch.set_num_threads(1)
spec = json.loads(sys.argv[1])
rank = int(sys.argv[2])
init_distributed_setup("127.0.0.1", spec["ports"][0], rank, 3,
                       device="cpu", ddp=True, timeout_s=60)
tr = _tiny_trainer("fused", grad_compress="int8")
state = tr.init_state()
state, _ = tr.train_step(state, *_batch(rank))
host = tr.state_to_host(state)
out = {}
# The same world again: the carry is kept.
elastic_teardown()
elastic_bootstrap(f"127.0.0.1:{spec['ports'][1]}", 3, rank, "cpu")
tr.rebind()
with warnings.catch_warnings(record=True) as rec:
    warnings.simplefilter("always")
    s2 = tr.state_from_host(host)
out["same_warned"] = np.array(any("resetting" in str(w.message)
                                  for w in rec))
h2 = tr.state_to_host(s2)
out["same_equal"] = np.array(all(
    np.array_equal(a, b) for (_, a), (_, b) in zip(keyed_leaves(h2),
                                                   keyed_leaves(host))))
state, _ = tr.train_step(s2, *_batch(7 + rank))
elastic_teardown()
if rank == 2:
    os._exit(0)
# A world of 2: dp changed, the carry resets (with a warning); params
# and momentum carry bit for bit.
elastic_bootstrap(f"127.0.0.1:{spec['ports'][2]}", 2, rank, "cpu")
tr.rebind()
with warnings.catch_warnings(record=True) as rec:
    warnings.simplefilter("always")
    s3 = tr.state_from_host(host)
out["dp_warned"] = np.array(any("resetting" in str(w.message)
                                for w in rec))
fresh = tr.compressor.init_state(tr._canon.shapes, tr.device,
                                 seed=tr.config.seed)
out["dp_fresh"] = np.array(all(
    torch.equal(a, b) for a, b in zip(s3.comp_state["residual"],
                                      fresh["residual"])))
h3 = tr.state_to_host(s3)
out["dp_carried"] = np.array(all(
    np.array_equal(a, b) for (k, a), (_, b) in zip(keyed_leaves(h3),
                                                   keyed_leaves(host))
    if not k.startswith("comp_state")))
state, loss = tr.train_step(s3, *_batch(9 + rank))
out["loss"] = np.array(float(loss))
out["dp"] = np.array(tr.dp)
np.savez(spec["out"] + f".{rank}.npz", **out)
torch.distributed.barrier()
sys.stdout.flush()
os._exit(0)
"""


def test_rebind_keeps_the_int8_carry_at_the_same_dp_and_resets_it_else(
        tmp_path):
    spec = {"ports": [str(free_port()) for _ in range(3)],
            "out": str(tmp_path / "rebind")}
    run_ranks(lambda r: ["-c", REBIND_WORKER, json.dumps(spec), str(r)], 3)
    for r in range(2):
        with np.load(f"{spec['out']}.{r}.npz") as f:
            rec = {k: f[k] for k in f.files}
        assert rec["same_equal"] and not rec["same_warned"], r
        assert rec["dp_warned"] and rec["dp_fresh"], r
        assert rec["dp_carried"] and int(rec["dp"]) == 2, r
        assert np.isfinite(rec["loss"])


@pytest.mark.parametrize("dataset", ["cifar10", "imagenet"])
@pytest.mark.parametrize("world,rank,epoch,next_iter",
                         [(1, 0, 0, 2), (2, 1, 1, 1)])
def test_loaders_rebuilt_mid_epoch_give_the_jax_batches(
        monkeypatch, dataset, world, rank, epoch, next_iter):
    """The loaders run_part makes again after a membership change (the
    new rank and world, the launch world's per-node batch, the epoch
    resumed at next_iter) yield the JAX loaders' batches."""
    from tpu_ddp.data import imagenet as jax_imagenet
    from tpu_ddp.data.loader import create_data_loaders as jax_cifar
    from tpu_ddp_torch.data import imagenet
    from tpu_ddp_torch.data.loader import create_data_loaders
    monkeypatch.setenv("CIFAR10_DIR", "/nonexistent-so-synthetic")
    monkeypatch.delenv("IMAGENET_DIR", raising=False)
    kw = dict(rank=rank, world_size=world, batch_size=4, seed=7,
              synthetic_size=40)
    if dataset == "imagenet":
        kw.update(image_size=16, num_classes=30)
        train, _ = imagenet.create_imagenet_loaders(**kw)
        jtrain, _ = jax_imagenet.create_imagenet_loaders(native=False, **kw)
    else:
        train, _ = create_data_loaders(**kw)
        jtrain, _ = jax_cifar(native=False, **kw)
    train.set_epoch(epoch)
    jtrain.set_epoch(epoch)
    got = list(itertools.islice(iter(train), next_iter, None))
    want = list(itertools.islice(iter(jtrain), next_iter, None))
    assert len(got) == len(want) == len(train) - next_iter > 0
    for (x, y), (jx, jy) in zip(got, want):
        np.testing.assert_array_equal(x.permute(0, 2, 3, 1).numpy(), jx)
        np.testing.assert_array_equal(y.numpy(), jy)


# ---- chaos kinds ------------------------------------------------------------

@pytest.mark.parametrize("kind,code", [("host-loss", 15), ("host-join", 16)])
def test_preemption_kinds_announce_then_exit(tmp_path, monkeypatch, kind,
                                             code):
    d = str(tmp_path)
    monkeypatch.setenv("TPU_DDP_ELASTIC_RESHARD", "1")
    monkeypatch.setenv("TPU_DDP_ELASTIC_DIR", d)
    monkeypatch.setenv("TPU_DDP_ELASTIC_RANK", "1")
    exits = []
    monkeypatch.setattr(chaos.os, "_exit", exits.append)
    inj = chaos.FaultInjector(chaos.parse_faults(f"{kind}@2:rank=1"),
                              rank=1, sentinel_dir=str(tmp_path / "s"))
    inj.after_step(1)
    assert exits == [] and jel.departures(d) == {}
    inj.after_step(2)
    assert exits == [code] == [{"host-loss": jel.HOST_LOSS_EXIT,
                                "host-join": jel.HOST_JOIN_EXIT}[kind]]
    assert jel.departures(d) == {1: kind}
    inj.after_step(2)            # the sentinel: once per history
    assert exits == [code]


def test_monitor_checks_live_members_and_resets_grace(tmp_path):
    from tpu_ddp_torch.resilience.watchdog import touch_heartbeat
    mon = HeartbeatMonitor(str(tmp_path), 3, timeout=10.0)
    for r in range(3):
        touch_heartbeat(str(tmp_path), r, 1)
    now = os.path.getmtime(tmp_path / "hb_rank0")
    os.utime(tmp_path / "hb_rank1", (now - 60, now - 60))
    assert mon.stalled_ranks(now=now + 1) == [1]
    assert mon.stalled_ranks(now=now + 1, ranks=[0, 2]) == []
    mon.reset_grace(now=now + 100)
    assert mon.stalled_ranks(now=now + 105) == []
    assert mon.stalled_ranks(now=now + 111) == [0, 1, 2]


# ---- the drills through the launcher --------------------------------------

def _drill(tmp, part, faults, extra_env=None, restarts=None, args=()):
    env = dict(SMOKE_ENV, TPU_DDP_CHAOS_FAULTS=faults,
               TPU_DDP_CHAOS_SENTINEL=str(tmp / "sentinels"),
               TPU_DDP_METRICS_FILE=str(tmp / "metrics_{rank}.jsonl"),
               **(extra_env or {}))
    kw = dict(env=env, device="cpu", elastic_reshard=True,
              extra_args=list(args), ack_timeout=90.0, timeout=240.0)
    if restarts is None:
        return launch.launch(part, 2, **kw)
    return launch.launch_elastic(part, 2, max_restarts=restarts,
                                 min_restart_interval=0.0, **kw)


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    """The four drills, side by side."""
    base = tmp_path_factory.mktemp("drills")
    runs = {
        "host_loss": lambda t: _drill(
            t, "part3", "host-loss@2:rank=1", HELD_ENV,
            args=["--ckpt-dir", str(t / "ckpt")]),
        "crash": lambda t: _drill(t, "part3", "hard-exit@2:rank=1"),
        # The survivor outlives the rejoin: 256 images, 0.3 s per step
        # from step 3 on rank 0.
        "join": lambda t: _drill(
            t, "part3", "host-join@2:rank=1,slow-rank@3:rank=0",
            {"TPU_DDP_SYNTH_SIZE": "256", "TPU_DDP_MAX_ITERS": "40",
             "TPU_DDP_CHAOS_SLOW_S": "0.3"}),
        "zero": lambda t: _drill(
            t, "part4", "host-loss@2:rank=1", {"TPU_DDP_CKPT_EVERY": "1"},
            restarts=1, args=["--ckpt-dir", str(t / "ckpt")]),
    }
    dirs = {k: base / k for k in runs}
    for d in dirs.values():
        d.mkdir()
    with concurrent.futures.ThreadPoolExecutor(len(runs)) as ex:
        futs = {k: ex.submit(fn, dirs[k]) for k, fn in runs.items()}
        return {k: (f.result(), dirs[k]) for k, f in futs.items()}


def _outputs(res):
    return "\n".join(f"--- worker {w.rank} rc={w.returncode}\n{w.output}"
                     for w in res.workers)


def _events(path, event):
    with open(path) as f:
        return [e for e in map(json.loads, f) if e["event"] == event]


def _held_reference(monkeypatch):
    """The JAX side of the host-loss drill: the port's initial weights,
    two steps at dp 2 on the JAX loaders' batches of ranks 0 and 1,
    ``redistribute_state`` onto dp 1, then the JAX loader's rank-0 batches
    of world 1 from next_iter 2."""
    from tpu_ddp.data.loader import create_data_loaders as jax_loaders
    from tpu_ddp.models import get_model as jax_get_model
    from tpu_ddp.parallel.mesh import make_mesh
    from tpu_ddp.parallel.redistribute import \
        redistribute_state as jax_redistribute
    from tpu_ddp.train.engine import Trainer as JaxTrainer
    from tpu_ddp.utils.config import TrainConfig as JaxConfig
    from tpu_ddp_torch.models import get_model
    for k, v in dict(SMOKE_ENV, **HELD_ENV).items():
        monkeypatch.setenv(k, v)
    cfg = TrainConfig.preset("vgg11_cifar10")
    port = Trainer(get_model(cfg.model, num_classes=cfg.num_classes,
                             use_pallas_bn=cfg.pallas_bn,
                             compute_dtype=torch.float32),
                   cfg, device="cpu")
    host0 = port.state_to_host(port.init_state())
    jcfg = JaxConfig.preset("vgg11_cifar10")
    jm = jax_get_model(jcfg.model, num_classes=jcfg.num_classes,
                       use_pallas_bn=jcfg.pallas_bn,
                       compute_dtype=jax.numpy.dtype(jcfg.compute_dtype))
    batch = cfg.per_node_batch_size(2)
    src = JaxTrainer(jm, jcfg, strategy="fused",
                     mesh=make_mesh(jax.devices()[:2]))
    state = src.state_from_host(host0)
    per_rank = []
    for r in range(2):
        train, _ = jax_loaders(rank=r, world_size=2, batch_size=batch,
                               seed=jcfg.seed)
        train.set_epoch(0)
        per_rank.append(list(itertools.islice(iter(train), 2)))
    for (x0, y0), (x1, y1) in zip(*per_rank):
        state, _ = src.train_step(state, *src.put_batch(
            np.concatenate([x0, x1]), np.concatenate([y0, y1])))
    dst = JaxTrainer(jm, jcfg, strategy="fused",
                     mesh=make_mesh(jax.devices()[:1]))
    state = jax_redistribute(state, src, dst)
    train, test = jax_loaders(rank=0, world_size=1, batch_size=batch,
                              seed=jcfg.seed)
    train.set_epoch(0)
    for x, y in itertools.islice(iter(train), 2, HELD_ITERS):
        state, loss = dst.train_step(state, *dst.put_batch(x, y))
    ev = dst.evaluate(state, test, log=lambda _: None)
    return dst.state_to_host(state), float(np.mean(loss)), ev["test_loss"]


def test_host_loss_survivor_carries_its_state_as_jax_does(drills,
                                                          monkeypatch):
    res, d = drills["host_loss"]
    out = _outputs(res)
    assert res.ok and res.reshards == 1, out
    assert [(w.rank, w.absorbed) for w in res.workers
            if w.returncode != 0] == [(1, True)], out
    out0 = res.output_of(0)
    assert "resharded in" in out0 and "resumed from" not in out0
    want, last_loss, test_loss = _held_reference(monkeypatch)
    epoch = _events(d / "metrics_0.jsonl", "epoch")
    assert [e["iters"] for e in epoch] == [HELD_ITERS - 2]
    np.testing.assert_allclose(epoch[0]["last_loss"], last_loss, rtol=RTOL)
    from tpu_ddp.utils.checkpoint import latest_step
    from tpu_ddp_torch.models import get_model
    cfg = TrainConfig.preset("vgg11_cifar10")
    assert latest_step(str(d / "ckpt")) == HELD_ITERS
    tr = Trainer(get_model(cfg.model, num_classes=cfg.num_classes,
                           use_pallas_bn=cfg.pallas_bn,
                           compute_dtype=torch.float32), cfg, device="cpu")
    got = tr.state_to_host(tr.restore_checkpoint(str(d / "ckpt")))
    assert int(got["step"]) == int(want["step"]) == HELD_ITERS
    for part in ("params", "opt_state"):
        gl = jax.tree_util.tree_flatten_with_path(got[part])[0]
        for (path, a), b in zip(gl, jax.tree.leaves(want[part])):
            np.testing.assert_allclose(
                a, np.asarray(b), rtol=RTOL, atol=ATOL,
                err_msg=f"{part}{jax.tree_util.keystr(path)}")
    ev = _events(d / "metrics_0.jsonl", "eval")
    np.testing.assert_allclose(ev[0]["test_loss"], test_loss, rtol=RTOL)


def test_unannounced_crash_gets_its_notice_from_the_launcher(drills):
    res, d = drills["crash"]
    out = _outputs(res)
    assert res.ok and res.reshards == 1, out
    assert [(w.rank, w.returncode, w.absorbed) for w in res.workers
            if w.returncode != 0] == [(1, chaos.FAULT_EXIT_CODE, True)], out
    # hard-exit writes no notice: this one is the launcher's.
    assert jel.departures(res.control_dir) == {1: "rc=13"}
    assert jel.read_membership(res.control_dir)["dropped"] == [1]
    out0 = res.output_of(0)
    assert "resharded in" in out0 and "resumed from" not in out0
    assert "Test set: average loss" in out0


def test_rejoiner_restores_from_the_beacon(drills):
    res, d = drills["join"]
    out = _outputs(res)
    assert res.ok and res.reshards == 2, out
    assert res.output_of(0).count("resharded in") >= 2
    joined = [w for w in res.workers if w.rank == 1 and w.returncode == 0]
    assert len(joined) == 1, out
    assert "joined with beaconed state" in joined[0].output
    assert all("resumed from" not in w.output for w in res.workers)
    # Both members end with the same parameters: the same eval line.
    lines = [[ln for ln in w.output.splitlines() if "Test set" in ln]
             for w in (res.workers[0], joined[0])]
    assert lines[0] and lines[0] == lines[1], out


def test_zero1_at_two_processes_falls_back_to_the_checkpoint(drills):
    res, d = drills["zero"]
    out = _outputs(res)
    assert res.ok and res.restarts == 1, out
    assert res.failed_attempts == [el.RESHARD_FALLBACK_EXIT], out
    assert "resumed from" in res.output_of(0) and "at step 2" in (
        res.output_of(0))
    assert "Test set: average loss" in res.output_of(0)


def test_elastic_config_knob_is_read_as_in_jax(monkeypatch):
    from tpu_ddp.utils.config import TrainConfig as JaxConfig
    for raw, want in (("1", True), ("0", False)):
        monkeypatch.setenv("TPU_DDP_ELASTIC_RESHARD", raw)
        assert TrainConfig().elastic_reshard is want
        assert JaxConfig().elastic_reshard is want
    monkeypatch.setenv("TPU_DDP_ELASTIC_RESHARD", "maybe")
    with pytest.raises(ValueError):
        TrainConfig()
