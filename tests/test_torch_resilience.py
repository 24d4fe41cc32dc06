"""The port's resilience layer (tpu_ddp_torch/resilience/: guard, chaos,
watchdog; utils/invariants.py; the guarded update of ops/sgd.py) held
against the JAX package's on the same inputs.

Tolerance: none. The guard's contract is bitwise (a skipped step leaves
params and momentum exactly as they were, a healthy guarded step is
exactly the unguarded one), the fault grammar and the seeded fire/no-fire
sequence are compared entry by entry with the JAX parser and injector,
and the watchdog's stall lists are compared exactly under fake clocks.
The 2-process replica check runs as gloo subprocesses, 120 s each.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.models.vgg import VGGModel as JaxVGG
from tpu_ddp.resilience import chaos as jax_chaos
from tpu_ddp.resilience import guard as jax_guard
from tpu_ddp.resilience import watchdog as jax_watchdog
from tpu_ddp.train.engine import Trainer as JaxTrainer
from tpu_ddp.utils.config import TrainConfig as JaxConfig
from tpu_ddp_torch.convert import image_params_from_jax
from tpu_ddp_torch.models.vgg import VGGModel
from tpu_ddp_torch.ops import sgd as tsgd
from tpu_ddp_torch.resilience import chaos, watchdog
from tpu_ddp_torch.resilience.guard import (StepGuard, TrainingDivergedError,
                                            nonfinite_flag, select_update)
from tpu_ddp_torch.train.engine import Trainer
from tpu_ddp_torch.utils import checkpoint as ckpt
from tpu_ddp_torch.utils.config import TrainConfig
from tpu_ddp_torch.utils.invariants import (check_replica_consistency,
                                            replica_divergence)

REPO = Path(__file__).resolve().parent.parent
TINY = (8, "M", 16, "M", 16, "M", 16, "M", 16, "M")
KNOBS = dict(pallas_sgd=True, pallas_bn=True, compute_dtype="float32")


def _pair(**cfg):
    jt = JaxTrainer(JaxVGG(name="tiny", cfg=TINY, compute_dtype=jnp.float32,
                           use_pallas_bn=True),
                    JaxConfig(**KNOBS, **cfg), strategy="none")
    jstate = jt.init_state()
    tt = Trainer(VGGModel("tiny", TINY, compute_dtype=torch.float32,
                          use_pallas_bn=True),
                 TrainConfig(**KNOBS, **cfg), device="cpu")
    state = tt.init_state()
    tt.model.load_state_dict(image_params_from_jax(
        tt.model, jax.tree.map(np.asarray, jstate.params), device="cpu"))
    return jt, jstate, tt, state


def _batch(seed=0, n=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, size=n).astype(np.int64))


def _port_step(tt, state, x, y):
    return tt.train_step(state, torch.from_numpy(x).permute(0, 3, 1, 2),
                         torch.from_numpy(y))


def _host_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


# ---- the guard --------------------------------------------------------------

def test_guard_is_on_by_default_as_in_jax(monkeypatch):
    cfg, jcfg = TrainConfig(), JaxConfig()
    assert (cfg.guard_nonfinite, cfg.guard_max_bad_steps) == (
        jcfg.guard_nonfinite, jcfg.guard_max_bad_steps) == (True, 3)
    assert (cfg.ckpt_every_iters, cfg.check_replicas_every) == (
        jcfg.ckpt_every_iters, jcfg.check_replicas_every) == (0, 0)
    for name, value, field, want in (
            ("TPU_DDP_GUARD", "0", "guard_nonfinite", False),
            ("TPU_DDP_GUARD_MAX_BAD", "5", "guard_max_bad_steps", 5),
            ("TPU_DDP_CKPT_EVERY", "20", "ckpt_every_iters", 20),
            ("TPU_DDP_CHECK_REPLICAS_EVERY", "7", "check_replicas_every",
             7)):
        monkeypatch.setenv(name, value)
        assert getattr(TrainConfig(), field) == want
        assert getattr(JaxConfig(), field) == want
        monkeypatch.delenv(name)
    monkeypatch.setenv("TPU_DDP_ELASTIC_RESHARD", "1")
    with pytest.raises(NotImplementedError, match="item 9.6b"):
        Trainer(VGGModel("tiny", TINY, use_pallas_bn=True),
                TrainConfig(pallas_bn=True), device="cpu")


def test_nan_batch_is_skipped_bit_for_bit_as_in_jax():
    """The same NaN batch through the JAX step and the port's: both flag
    the step and leave params and momentum bit-identical; the step count
    advances on both."""
    jt, jstate, tt, state = _pair()
    x, y = _batch()
    x[:] = np.nan
    jbefore = jax.tree.map(np.array, (jstate.params, jstate.opt_state))
    before = tt.state_to_host(state)
    xb, yb, wb = jt.put_batch(x, y.astype(np.int32))
    jstate, _ = jt.train_step(jstate, xb, yb, wb)
    state, loss = _port_step(tt, state, x, y)
    assert jt.last_step_skipped() and tt.last_step_skipped()
    assert not np.isfinite(float(loss))
    assert _host_equal((jstate.params, jstate.opt_state), jbefore)
    after = tt.state_to_host(state)
    assert _host_equal(after["params"], before["params"])
    assert _host_equal(after["opt_state"], before["opt_state"])
    assert jstate.step == state.step == 1


@pytest.mark.parametrize("pallas_sgd", [True, False])
def test_healthy_guarded_step_is_the_unguarded_step(pallas_sgd):
    """Two healthy steps with the guard on and off: the same bits, through
    the SGD wrapper's plain version (pallas_sgd) and the Trainer's plain
    update alike."""
    states = []
    for guard in (True, False):
        tt = Trainer(VGGModel("tiny", TINY, compute_dtype=torch.float32,
                              use_pallas_bn=True),
                     TrainConfig(pallas_bn=True, pallas_sgd=pallas_sgd,
                                 compute_dtype="float32",
                                 guard_nonfinite=guard), device="cpu")
        state = tt.init_state()
        for seed in (1, 2):
            state, _ = _port_step(tt, state, *_batch(seed))
        assert not tt.last_step_skipped()
        states.append(tt.state_to_host(state))
    assert _host_equal(states[0], states[1])


def test_guard_raises_at_the_same_step_as_jax(monkeypatch):
    """``nan-grad@p1.0`` with a streak limit of 3: both trainers'
    train_epoch skip steps 1-3 and raise TrainingDivergedError at the
    third."""
    monkeypatch.setenv("TPU_DDP_CHAOS_FAULTS", "nan-grad@p1.0")
    jt, jstate, tt, state = _pair(guard_max_bad_steps=3)
    batches = [_batch(s) for s in range(5)]
    jlog, log = [], []
    with pytest.raises(jax_guard.TrainingDivergedError):
        jt.train_epoch(jstate, batches, log=jlog.append)
    port_batches = [(torch.from_numpy(x).permute(0, 3, 1, 2),
                     torch.from_numpy(y)) for x, y in batches]
    tt.guard.log = log.append
    with pytest.raises(TrainingDivergedError, match="3 consecutive"):
        tt.train_epoch(state, port_batches, log=log.append)
    assert jt.guard.last_step == tt.guard.last_step == 3
    assert jt.guard.total_skipped == tt.guard.total_skipped == 3
    assert [e["step"] for e in tt.metrics.events
            if e["event"] == "step_skipped"] == [1, 2, 3]


def test_step_guard_matches_jax_on_flag_sequences():
    """The host-side streak accounting against the JAX StepGuard: the
    same raise step on each sequence, a clean step and a step regression
    resetting the streak."""
    seqs = [[1, 1, 0, 1, 1, 1], [1, 0] * 5 + [1, 1, 1],
            [0, 0, 0, 0], [1, 1, 1, 1]]
    for limit in (1, 2, 3):
        for seq in seqs:
            raised = []
            for mod, exc in ((jax_guard, jax_guard.TrainingDivergedError),
                             (None, TrainingDivergedError)):
                g = (mod.StepGuard if mod else StepGuard)(
                    limit, log=lambda _: None)
                at = None
                for step, bad in enumerate(seq, start=1):
                    try:
                        g.record(step, bool(bad), float("nan"))
                    except exc:
                        at = step
                        break
                raised.append((at, g.total_skipped))
            assert raised[0] == raised[1], (limit, seq)
    g = StepGuard(2, log=lambda _: None)
    g.record(5, True, 0.0)
    g.record(1, True, 0.0)  # a rollback: the streak restarts
    assert g.consecutive == 1
    with pytest.raises(ValueError):
        StepGuard(0)


def test_nonfinite_flag():
    """The flag reads the loss and the f32 sum of squared gradients, so a
    finite gradient that overflows when squared is caught too."""
    g = [torch.ones(3), torch.zeros(2, 2)]
    one = torch.tensor(1.0)
    assert float(nonfinite_flag(one, g)) == 0.0
    assert float(nonfinite_flag(torch.tensor(float("nan")), g)) == 1.0
    assert float(nonfinite_flag(torch.tensor(float("inf")), g)) == 1.0
    assert float(nonfinite_flag(one, [torch.tensor([1.0, float("nan")])])) \
        == 1.0
    assert float(nonfinite_flag(one, [torch.full((4,), 3e19)])) == 1.0
    flag = nonfinite_flag(one, [torch.full((4,), 1e18)])
    assert flag.dtype == torch.float32 and flag.dim() == 0
    assert float(flag) == 0.0
    jflag = jax_guard.nonfinite_flag(jnp.float32(1.0),
                                     [jnp.full((4,), 3e19, jnp.float32)])
    assert bool(jflag)


def test_guarded_sgd_update_plain_version():
    """``skip`` zero: the ungated update's bits; nonzero (f32 or int32):
    params and momentum untouched. Other flags are refused."""
    gen = torch.Generator().manual_seed(0)
    shapes = [(1,), (7, 13), (4099,)]
    p0 = [torch.randn(s, generator=gen) for s in shapes]
    g = [torch.randn(s, generator=gen) for s in shapes]
    hp = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)
    runs = []
    for skip in (None, torch.tensor(0.0), torch.tensor(0, dtype=torch.int32)):
        p, b = [t.clone() for t in p0], [t * 0.5 for t in p0]
        tsgd.fused_sgd_step(p, g, b, skip=skip, **hp)
        runs.append(p + b)
    for other in runs[1:]:
        assert all(torch.equal(a, c) for a, c in zip(runs[0], other))
    for skip in (torch.tensor(1.0), torch.tensor(2, dtype=torch.int32),
                 torch.tensor(float("nan"))):
        p, b = [t.clone() for t in p0], [t * 0.5 for t in p0]
        tsgd.fused_sgd_step(p, g, b, skip=skip, **hp)
        assert all(torch.equal(a, c) for a, c in zip(p, p0))
        assert all(torch.equal(a, c * 0.5) for a, c in zip(b, p0))
    for bad in (torch.tensor([0.0, 1.0]), torch.tensor(0.0).double()):
        with pytest.raises((ValueError, TypeError)):
            tsgd.fused_sgd_step(p, g, b, skip=bad, **hp)
    kept = select_update(torch.tensor(1.0), [p0[0]], [p0[0] + 1])
    assert torch.equal(kept[0], p0[0])


# ---- chaos ------------------------------------------------------------------

SPECS = ["hard-exit@5", "nan-grad@3:rank=1,hard-exit@5", "slow-rank@p0.5",
         "tenant-storm@2:tenant=bob", "group-loss@1:group=2",
         " nan-grad@4 , ,", "corrupt-ckpt@p1.0:rank=3", "stalled-step@9",
         "host-loss@3:rank=1", "replica-crash@p0.25"]
BAD_SPECS = ["nan-grad", "bogus@1", "nan-grad@p0", "nan-grad@p1.5",
             "nan-grad@x", "nan-grad@1:foo=2", "tenant-storm@1",
             "nan-grad@1:tenant=a", "nan-grad@1:group=1",
             "group-loss@1:group=-1", "nan-grad@3:rank=x"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_faults_matches_jax(spec):
    mine, theirs = chaos.parse_faults(spec), jax_chaos.parse_faults(spec)
    assert [dataclasses.asdict(s) for s in mine] == \
        [dataclasses.asdict(s) for s in theirs]
    assert [s.key for s in mine] == [s.key for s in theirs]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_faults_refuses_what_jax_refuses(spec):
    with pytest.raises(ValueError) as mine:
        chaos.parse_faults(spec)
    with pytest.raises(ValueError) as theirs:
        jax_chaos.parse_faults(spec)
    assert str(mine.value) == str(theirs.value)


def test_seeded_probabilistic_mode_fires_as_jax_does():
    specs = chaos.parse_faults("nan-grad@p0.3,slow-rank@p0.1:rank=1")
    jspecs = jax_chaos.parse_faults("nan-grad@p0.3,slow-rank@p0.1:rank=1")
    for seed in (0, 7):
        for rank in (0, 1):
            mine = chaos.FaultInjector(specs, seed=seed, rank=rank)
            theirs = jax_chaos.FaultInjector(jspecs, seed=seed, rank=rank)
            got = [[mine._fires(s, t) for s in specs] for t in range(200)]
            want = [[theirs._fires(s, t) for s in jspecs]
                    for t in range(200)]
            assert got == want
            assert any(any(row) for row in got)


@pytest.mark.parametrize("spec,item", [
    ("host-loss@3", "item 9.6b"), ("host-join@3", "item 9.6b"),
    ("group-loss@1", "item 11"), ("replica-crash@1", "item 2.7")])
def test_unported_kinds_raise_naming_their_item(spec, item, monkeypatch):
    with pytest.raises(NotImplementedError, match=item):
        chaos.FaultInjector(chaos.parse_faults(spec))
    monkeypatch.setenv("TPU_DDP_CHAOS_FAULTS", spec)
    with pytest.raises(NotImplementedError, match=item):
        chaos.FaultInjector.from_env()


def test_injector_hooks(tmp_path, monkeypatch):
    sentinel = str(tmp_path / "sentinel")
    inj = chaos.FaultInjector(
        chaos.parse_faults("nan-grad@2,corrupt-ckpt@3,slow-rank@1"),
        sentinel_dir=sentinel, slow_s=0.0, rank=0)
    assert inj.active
    assert [inj.before_step(s) for s in (1, 2, 2)] == [False, True, False]
    assert os.listdir(sentinel) == ["nan-grad@2.rank0"]
    d = str(tmp_path / "ck")
    for step in (1, 2):
        ckpt.save_checkpoint(d, {"a": np.arange(100.0)}, step)
    inj.after_step(2, d)
    inj.after_step(3, d)
    npz = os.path.join(d, "step_00000002", "arrays.npz")
    assert os.path.getsize(npz) < os.path.getsize(
        os.path.join(d, "step_00000001", "arrays.npz"))
    assert not chaos.FaultInjector([], rank=0).active
    monkeypatch.delenv("TPU_DDP_CHAOS_FAULTS", raising=False)
    monkeypatch.delenv("TPU_DDP_FAIL_AT_STEP", raising=False)
    assert not chaos.chaos_env_active()
    monkeypatch.setenv("TPU_DDP_FAIL_AT_STEP", "3")
    assert chaos.chaos_env_active() == jax_chaos.chaos_env_active()
    x = torch.arange(6).reshape(2, 3)
    assert chaos.FaultInjector.poison_images(x).isnan().all()
    assert np.isnan(chaos.FaultInjector.poison_images(np.ones(3))).all()


@pytest.mark.parametrize("env", [
    {"TPU_DDP_CHAOS_FAULTS": "hard-exit@4"},
    {"TPU_DDP_FAIL_AT_STEP": "4"}])
def test_hard_exit_codes(env, tmp_path):
    """A chaos hard-exit and the legacy knob both exit 13 after the step;
    the legacy knob's sentinel makes it fire once per history."""
    code = ("from tpu_ddp_torch.resilience.chaos import FaultInjector\n"
            "inj = FaultInjector.from_env()\n"
            "inj.after_step(3)\nprint('alive', flush=True)\n"
            "inj.after_step(4)\nprint('survived')\n")
    run_env = dict(os.environ, PYTHONPATH=str(REPO), **env,
                   TPU_DDP_FAIL_SENTINEL=str(tmp_path / "once"))
    runs = [subprocess.run([sys.executable, "-c", code], env=run_env,
                           capture_output=True, text=True, timeout=120)
            for _ in range(2)]
    assert runs[0].returncode == chaos.FAULT_EXIT_CODE == 13
    assert "alive" in runs[0].stdout and "survived" not in runs[0].stdout
    legacy = "TPU_DDP_FAIL_AT_STEP" in env
    assert (runs[1].returncode == 0) == legacy


# ---- the watchdog -----------------------------------------------------------

def test_watchdog_stall_detection_with_fake_clocks(tmp_path):
    """Stalled ranks under fake clocks (file mtimes and ``now`` set by
    hand), against the JAX monitor on the same directory: grace before
    the first beat, and a never-beating rank measured from the first
    beat."""
    d = str(tmp_path)
    mine = watchdog.HeartbeatMonitor(d, 3, timeout=10.0)
    theirs = jax_watchdog.HeartbeatMonitor(d, 3, timeout=10.0)

    def both(now):
        got = mine.stalled_ranks(now=now)
        assert got == theirs.stalled_ranks(now=now)
        assert mine.stalled(now=now) == bool(got)
        return got

    assert both(1e9) == []
    watchdog.touch_heartbeat(d, 0, 5)
    os.utime(watchdog.heartbeat_path(d, 0), (1000.0, 1000.0))
    assert both(1005.0) == []
    assert both(1010.5) == [0, 1, 2]
    watchdog.touch_heartbeat(d, 1, 6)
    os.utime(watchdog.heartbeat_path(d, 1), (1008.0, 1008.0))
    assert both(1012.0) == [0, 2]
    assert both(1018.5) == [0, 1, 2]
    assert mine.beats() == {0: 1000.0, 1: 1008.0}
    with open(watchdog.heartbeat_path(d, 0)) as f:
        assert f.read() == "5\n"
    with pytest.raises(ValueError):
        watchdog.HeartbeatMonitor(d, 1, timeout=0)


def test_heartbeat_from_env(monkeypatch, tmp_path):
    monkeypatch.delenv(watchdog.HEARTBEAT_ENV, raising=False)
    assert watchdog.heartbeat_from_env() is None
    monkeypatch.setenv(watchdog.HEARTBEAT_ENV, str(tmp_path))
    assert watchdog.heartbeat_from_env() == (str(tmp_path), 0)
    assert watchdog.heartbeat_from_env(rank=3) == (str(tmp_path), 3)
    assert watchdog.STALL_EXIT_CODE == jax_watchdog.STALL_EXIT_CODE == 14


# ---- the replica check ------------------------------------------------------

def test_replica_check_in_one_process():
    tree = {"w": torch.ones(3), "b": torch.zeros(2), "n": 3}
    assert replica_divergence(tree) == {"b": 0.0, "w": 0.0}
    assert check_replica_consistency(tree) == {"b": 0.0, "w": 0.0}


REPLICA_WORKER = r"""
import sys
import torch
from tpu_ddp_torch.parallel.bootstrap import init_distributed_setup, shutdown
from tpu_ddp_torch.utils.invariants import (ReplicaDivergenceError,
                                            check_replica_consistency)
rank, port = int(sys.argv[1]), sys.argv[2]
ctx = init_distributed_setup("127.0.0.1", port, rank, 2, device="cpu",
                             timeout_s=90)
tree = {"features.0.weight": torch.linspace(-1, 1, 1000),
        "head.bias": torch.ones(10)}
assert check_replica_consistency(tree) == {"features.0.weight": 0.0,
                                           "head.bias": 0.0}
if rank == 1:  # one bit of one element
    tree["features.0.weight"].view(torch.int32)[417] ^= 1
try:
    check_replica_consistency(tree)
except ReplicaDivergenceError as e:
    print("DIVERGED", e)
shutdown(ctx)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_one_bit_difference_between_ranks_is_caught():
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", REPLICA_WORKER,
                               str(rank), port], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        assert "DIVERGED replica divergence on 1 leaves; worst " \
               "features.0.weight: inf" in out, out[-3000:]
