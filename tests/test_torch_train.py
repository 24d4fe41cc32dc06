"""The port's training ladder (tpu_ddp_torch/train, parallel, parts) held
against the JAX package's ``Trainer`` with both kernel knobs on
(``pallas_sgd=pallas_bn=True``; the Pallas kernels in interpret mode),
f32 compute, on the same weights (through ``convert.vgg_params_from_jax``)
and the same batches.

Tolerance for parameters after a few steps: rtol 1e-4 / atol 1e-5. Both
sides compute in f32 and differ only in summation order; after part 1's
three steps at lr 0.1 the parameters differ by at most 3e-7 absolute and
8e-6 relative (on entries above 1e-2), so the tolerance leaves a margin
of about 10x for other orders of summation.

The ladder runs as real 2-process ``torch.distributed`` gloo groups (one
subprocess per rank, each with a 120 s limit) and is compared with the
JAX ``Trainer`` of the same strategy on a 2-device mesh fed the
concatenation [rank 0's batch; rank 1's batch] — not with one process on
the whole batch, because BN takes its statistics per replica.
"""

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

from tpu_ddp.data.loader import create_data_loaders as jax_loaders
from tpu_ddp.models.vgg import VGGModel as JaxVGG
from tpu_ddp.parallel.mesh import make_mesh
from tpu_ddp.train.engine import Trainer as JaxTrainer
from tpu_ddp.utils.config import TrainConfig as JaxConfig
from tpu_ddp_torch.convert import vgg_params_from_jax
from tpu_ddp_torch.data.loader import create_data_loaders
from tpu_ddp_torch.models.vgg import VGGModel
from tpu_ddp_torch.parallel import sync
from tpu_ddp_torch.train.engine import Trainer
from tpu_ddp_torch.utils.config import TrainConfig

REPO = Path(__file__).resolve().parent.parent
TINY = (8, "M", 16, "M", 16, "M", 16, "M", 16, "M")
KNOBS = dict(pallas_sgd=True, pallas_bn=True, compute_dtype="float32")
RTOL, ATOL = 1e-4, 1e-5


def _jax_model():
    return JaxVGG(name="tiny", cfg=TINY, compute_dtype=jnp.float32,
                  use_pallas_bn=True)


def _port_model():
    return VGGModel("tiny", TINY, compute_dtype=torch.float32,
                    use_pallas_bn=True)


def _host(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _assert_params(model, jparams, rtol=RTOL, atol=ATOL):
    want = vgg_params_from_jax(model, _host(jparams), device="cpu")
    got = model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


def test_part1_matches_jax_trainer():
    """Three steps of part 1 (strategy none) plus the test-set pass: the
    same log lines and, within the stated tolerance, the same params."""
    jcfg = JaxConfig(log_every=1, global_batch_size=8, max_iters=3, **KNOBS)
    cfg = TrainConfig(log_every=1, global_batch_size=8, max_iters=3,
                      **KNOBS)
    jt = JaxTrainer(_jax_model(), jcfg, strategy="none")
    jstate = jt.init_state()
    tt = Trainer(_port_model(), cfg, device="cpu")
    state = tt.init_state()
    tt.model.load_state_dict(vgg_params_from_jax(
        tt.model, _host(jstate.params), device="cpu"))

    jtrain, jtest = jax_loaders(batch_size=8, synthetic_size=40,
                                native=False)
    train, test = create_data_loaders(batch_size=8, synthetic_size=40)
    jlines, lines = [], []
    jstate, jstats = jt.train_epoch(jstate, jtrain, log=jlines.append)
    jt.evaluate(jstate, jtest, log=jlines.append)
    state, stats = tt.train_epoch(state, train, log=lines.append)
    tt.evaluate(state, test, log=lines.append)

    assert state.step == jstate.step == 3
    assert stats["iters"] == jstats["iters"] == 3
    assert len(lines) == 4 and lines[0].startswith("[epoch 0, iter 1] loss")
    assert lines[-1].startswith("Test set: average loss")
    assert lines == jlines
    _assert_params(tt.model, jstate.params)
    ev = [e["event"] for e in tt.metrics.events]
    assert ev == ["train_iter"] * 3 + ["epoch", "eval"]


def test_timer_report_at_iteration_39():
    """The reference's timing line appears once the loop passes
    iteration 39 (iterations 1..39 timed)."""
    cfg = TrainConfig(global_batch_size=2, max_iters=40,
                      compute_dtype="float32")
    tt = Trainer(VGGModel("tiny", TINY, compute_dtype=torch.float32),
                 cfg, device="cpu")
    state = tt.init_state()
    batches = [(torch.randn(2, 3, 32, 32), torch.tensor([1, 2]))] * 41
    lines = []
    state, stats = tt.train_epoch(state, batches, log=lines.append)
    assert stats["iters"] == 40 and stats["timed_iters"] == 39
    assert [ln for ln in lines if "timing over iterations 1-39" in ln]
    assert sum("loss:" in ln for ln in lines) == 2


# ---- the ladder: 2-process gloo runs ------------------------------------

WORKER = r"""
import sys
import numpy as np
import torch
from tpu_ddp_torch.models.vgg import VGGModel
from tpu_ddp_torch.parallel.bootstrap import init_distributed_setup, shutdown
from tpu_ddp_torch.train.engine import Trainer
from tpu_ddp_torch.utils.config import TrainConfig

torch.set_num_threads(1)
strategy, rank, world, port, data, out = sys.argv[1:]
rank, world = int(rank), int(world)
d = np.load(data)
ctx = init_distributed_setup("127.0.0.1", port, rank, world, device="cpu",
                             ddp=strategy == "fused", timeout_s=90)
cfg = TrainConfig(pallas_sgd=True, pallas_bn=True, compute_dtype="float32")
model = VGGModel("tiny", %r, compute_dtype=torch.float32, use_pallas_bn=True)
trainer = Trainer(model, cfg, strategy=strategy, device="cpu")
state = trainer.init_state()
model.load_state_dict({k: torch.from_numpy(d["p/" + k])
                       for k in model.state_dict()})
losses = []
for step in range(d["x"].shape[0]):
    x = torch.from_numpy(d["x"][step, rank]).permute(0, 3, 1, 2)
    state, loss = trainer.train_step(state, x, torch.from_numpy(
        d["y"][step, rank]))
    losses.append(float(loss))
np.savez(out, losses=np.array(losses),
         **{k: v.numpy() for k, v in model.state_dict().items()})
shutdown(ctx)
""" % (TINY,)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(tmp_path, strategy, data, world=2):
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs, outs = [], []
    for rank in range(world):
        out = tmp_path / f"{strategy}-{rank}.npz"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, strategy, str(rank), str(world),
             port, str(data), str(out)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
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
    return [np.load(o) for o in outs]


@pytest.fixture(scope="module")
def ladder_inputs(tmp_path_factory):
    """Shared start: the JAX init converted, and 2 steps x 2 ranks x 4
    images."""
    jm = _jax_model()
    params = _host(jm.init(jax.random.key(89395)))
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 2, 4, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(2, 2, 4)).astype(np.int64)
    sd = vgg_params_from_jax(_port_model(), params, device="cpu")
    path = tmp_path_factory.mktemp("ladder") / "inputs.npz"
    np.savez(path, x=x, y=y, **{"p/" + k: v.numpy() for k, v in sd.items()})
    return {"params": params, "x": x, "y": y, "path": path, "runs": {}}


@pytest.mark.parametrize("part", ["part2a", "part2b", "part3"])
def test_ladder_rung_matches_jax_mesh(part, ladder_inputs, tmp_path):
    strategy = sync.PART_TO_STRATEGY[part]
    ranks = _run_ranks(tmp_path, strategy, ladder_inputs["path"])
    ladder_inputs["runs"][part] = ranks
    # Every replica ends with the same parameters.
    for k in ranks[0].files:
        if k != "losses":
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k])

    jt = JaxTrainer(_jax_model(), JaxConfig(**KNOBS), strategy=strategy,
                    mesh=make_mesh(jax.devices()[:2]))
    jstate = jt.init_state()
    jstate = jt.state_from_host({"params": ladder_inputs["params"],
                                 "opt_state": _host(jstate.opt_state),
                                 "step": 0})
    x, y = ladder_inputs["x"], ladder_inputs["y"]
    for step in range(x.shape[0]):
        xb, yb, wb = jt.put_batch(x[step].reshape(-1, 32, 32, 3),
                                  y[step].reshape(-1).astype(np.int32))
        jstate, jloss = jt.train_step(jstate, xb, yb, wb)
        # Per-replica losses: each rank prints its own shard's loss.
        np.testing.assert_allclose(
            [ranks[r]["losses"][step] for r in range(2)],
            np.asarray(jloss), rtol=RTOL, atol=ATOL)
    model = _port_model()
    model.load_state_dict({k: torch.from_numpy(ranks[0][k])
                           for k in model.state_dict()})
    _assert_params(model, jt.params_to_host(jstate))


def test_ladder_rungs_agree(ladder_inputs):
    """The ladder invariant (report §2.2): every rung applies the mean of
    the two replicas' gradients, so all end with the same parameters. With
    two ranks each rung's mean is (a + b) / 2 in f32 — the same bits."""
    runs = ladder_inputs["runs"]
    if len(runs) < 3:
        pytest.skip("needs the three rung runs of this module")
    ref = runs["part2a"][0]
    for part in ("part2b", "part3"):
        for k in ref.files:
            np.testing.assert_array_equal(runs[part][0][k], ref[k],
                                          err_msg=f"{part} {k}")


# ---- rules ----------------------------------------------------------------

def test_part1_cli_runs_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), TPU_DDP_MAX_ITERS="2",
               TPU_DDP_SYNTH_SIZE="64", TPU_DDP_GLOBAL_BATCH="16",
               TPU_DDP_PALLAS_SGD="1", TPU_DDP_PALLAS_BN="1")
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_ddp_torch.parts", "part1", "--device",
         "cpu"], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    assert "[part1] strategy=none world_size=1" in out
    assert "platform=cpu" in out
    assert "Test set: average loss" in out and "/64 (" in out


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(_port_model(), TrainConfig(pallas_bn=True))


def test_unported_knobs_are_refused(monkeypatch):
    cfg = TrainConfig(pallas_bn=True)
    for name, value in (("TPU_DDP_OVERLAP", "1"),
                        ("TPU_DDP_GRAD_COMPRESS", "int8"),
                        ("TPU_DDP_STEPS_PER_DISPATCH", "4"),
                        ("TPU_DDP_REMAT", "blocks"),
                        ("TPU_DDP_AUTOTUNE", "search")):
        monkeypatch.setenv(name, value)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Trainer(_port_model(), cfg, device="cpu")
        monkeypatch.delenv(name)
    monkeypatch.setenv("TPU_DDP_OVERLAP", "0")  # the default: accepted
    Trainer(_port_model(), cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sync.canonical_strategy("part4")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TrainConfig.preset("resnet50_imagenet")
    with pytest.raises(TypeError):
        TrainConfig(overlap=True)


def test_config_env_knobs(monkeypatch):
    monkeypatch.setenv("TPU_DDP_PALLAS_SGD", "yes")
    monkeypatch.setenv("TPU_DDP_PALLAS_BN", "1")
    monkeypatch.setenv("TPU_DDP_MAX_ITERS", "7")
    monkeypatch.setenv("TPU_DDP_GLOBAL_BATCH", "64")
    monkeypatch.setenv("TPU_DDP_COMPUTE_DTYPE", "float32")
    cfg = TrainConfig.preset("vgg11_cifar10")
    assert (cfg.pallas_sgd, cfg.pallas_bn, cfg.max_iters,
            cfg.global_batch_size, cfg.compute_dtype) == (
        True, True, 7, 64, "float32")
    assert cfg.per_node_batch_size(3) == 21
    monkeypatch.setenv("TPU_DDP_PALLAS_BN", "maybe")
    with pytest.raises(ValueError, match="TPU_DDP_PALLAS_BN"):
        TrainConfig()
    monkeypatch.delenv("TPU_DDP_PALLAS_BN")
    monkeypatch.delenv("TPU_DDP_PALLAS_SGD")
    base = TrainConfig()
    assert (base.pallas_sgd, base.pallas_bn, base.seed, base.learning_rate,
            base.momentum, base.weight_decay) == (False, False, 89395, 0.1,
                                                  0.9, 1e-4)


@pytest.mark.parametrize("field,value", [("param_dtype", "bfloat16"),
                                         ("image_size", 64),
                                         ("dataset", "imagenet")])
def test_config_refuses_what_the_port_cannot_honour(field, value):
    """A non-f32 param dtype raises; fields of the JAX config that the
    port has no use for (CIFAR-10's shape and name) are not accepted."""
    with pytest.raises((NotImplementedError, TypeError)):
        TrainConfig(**{field: value})


def test_syncing_rung_needs_a_process_group():
    with pytest.raises(ValueError, match="process group"):
        Trainer(_port_model(), TrainConfig(pallas_bn=True),
                strategy="all_reduce", device="cpu")


def test_ckpt_dir_is_refused(tmp_path, monkeypatch):
    """Checkpoints are ported (tests/test_torch_checkpoint.py); what is
    still refused around ``--ckpt-dir``: ``--resume`` without it, an
    argparse error before any rendezvous, and the elastic knobs that would
    reshard instead of restarting from it (ROADMAP item 9.6b)."""
    from tpu_ddp_torch.parts import run_part
    with pytest.raises(SystemExit):
        run_part("part2b", ["--num-nodes", "2", "--device", "cpu",
                            "--resume"])
    monkeypatch.setenv("TPU_DDP_ELASTIC_RESHARD", "1")
    with pytest.raises(NotImplementedError, match="item 9.6b"):
        run_part("part1", ["--device", "cpu", "--ckpt-dir", str(tmp_path)])


def test_bootstrap_helpers(capsys):
    from tpu_ddp_torch.parallel.bootstrap import (
        get_rank_from_hostname, init_distributed_setup, shutdown,
        test_distributed_setup)
    assert get_rank_from_hostname("node3") == 3
    assert get_rank_from_hostname("gpu-host") == 0
    ctx = init_distributed_setup(rank=0, world_size=1, device="cpu")
    assert ctx.coordinator is None and ctx.backend == "none"
    info = test_distributed_setup(ctx)
    assert info["world_size"] == 1 and info["is_initialized"]
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "Distributed setup initialized: True"
    assert len(out) == 4 and out[3].startswith("Rank: 0")
    shutdown(ctx)
    with pytest.raises(ValueError, match="out of range"):
        init_distributed_setup(rank=2, world_size=2, device="cpu")
