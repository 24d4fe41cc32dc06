"""``PipelineLMTrainer`` with one stage per process over a gloo pp group
(tpu_ddp_torch/train/lm.py, parallel/pipeline.py), held to the JAX
package, f32, from the same seed-7 parameters and numpy-seeded tokens.

One world of 4 processes (150 s limit) trains every run two steps: dp x pp
(1f1b), tp x pp (zerobubble) and sp x pp (ring attention) against the JAX
dense ``LMTrainer``, in-process stages at dp 4, ZeRO-1, ZeRO-2 (per-tick
scatter) and FSDP at dp x pp against the port's replicated run of the same
mesh, ``FactoredZeRO1`` per stage cell, a MoE model at ep x pp and the
global-norm clip at dp x pp (replicated and ZeRO-1) against JAX's
``PipelineLMTrainer`` (whose MoE pipeline drops the load-balance loss, as
the port's does), and checkpoints both ways with interleaved rows. The
in-process stages also compose with the other axes over the world: tp 2,
sp 2 (ring) and ep 2 (MoE) at dp 2, replicated Adafactor and Adafactor
under ZeRO-1 at dp 4 (per stage cell), tp 2 under ZeRO-1, each against
JAX's ``PipelineLMTrainer`` on the mesh whose pp axis is devices, and
the tp 2 run's checkpoint both ways through JAX's tree.
After the steps every stage's replicated leaves (embed, ln_f, head) must be
equal bit for bit. JAX runs its trainers on the virtual devices while the
ranks run. Beside them ``examples/lm_train`` runs at ``TPU_DDP_LM_PP=2``
on 2 ranks under each schedule.

Tolerances (tests/test_pipeline.py:94-101): losses within 1e-4,
parameters within rtol 3e-4 / atol 3e-5; the sharded layouts within rtol
1e-5 / atol 1e-6 of the port's replicated run (the same sums grouped
otherwise); checkpoints bit for bit.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ranks import free_port, start_ranks, wait_ranks
from torch_tp import collect, launch
from tpu_ddp.models import make_transformer as jax_make
from tpu_ddp.ops.optim import SGD as JaxSGD
from tpu_ddp.ops.optim import Adafactor as JaxAdafactor
from tpu_ddp.parallel import pipeline as jpipe
from tpu_ddp.parallel.mesh import make_mesh
from tpu_ddp.train.lm import LMTrainer as JaxLMTrainer
from tpu_ddp.train.lm import PipelineLMTrainer as JaxPipe
from tpu_ddp_torch.convert import params_to_jax
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.train.lm import make_lm_batch

SEQ = 32
LAYERS = 4
LOSS_ATOL = 1e-4
STEP_TOL = dict(rtol=3e-4, atol=3e-5)
LAYOUT_TOL = dict(rtol=1e-5, atol=1e-6)
MOE = dict(preset="TransformerLM-moe-tiny",
           model=dict(moe_capacity_factor=8.0))
ADA = dict(optimizer="adafactor")
IN_PROCESS = dict(stages="in_process")
# Binds: the first step's global gradient norm is about 2.8.
CLIP = 0.5

# name -> the port run at world 4 (PipelineLMTrainer kwargs and test
# fields).
RUNS = {
    "dp2pp2": dict(pp=2, schedule="1f1b", num_micro=2),
    "tp2pp2": dict(pp=2, tp=2, schedule="zerobubble", num_micro=4),
    "sp2pp2": dict(pp=2, sp=2, schedule="1f1b", num_micro=2),
    "in_process_dp4": dict(pp=2, schedule="gpipe", num_micro=1,
                           stages="in_process"),
    "zero1": dict(pp=2, schedule="1f1b", num_micro=2, opt_sharding="zero1"),
    "zero2": dict(pp=2, schedule="1f1b", num_micro=2, opt_sharding="zero2"),
    "fsdp": dict(pp=2, schedule="gpipe", num_micro=2, param_sharding="fsdp"),
    "factored_zero1": dict(pp=2, schedule="1f1b", num_micro=2,
                           opt_sharding="zero1", **ADA),
    "ep2pp2_moe": dict(pp=2, ep=2, schedule="1f1b", num_micro=2, **MOE),
    "clip": dict(pp=2, schedule="1f1b", num_micro=2, clip_grad_norm=CLIP),
    "clip_zero1": dict(pp=2, schedule="1f1b", num_micro=2,
                       clip_grad_norm=CLIP, opt_sharding="zero1"),
    "interleaved_save": dict(pp=2, schedule="interleaved", pp_virtual=2,
                             num_micro=2, save=True),
    "restore_jax": dict(pp=2, schedule="1f1b", num_micro=2, restore=True),
    # Every stage in one process, composed with the other axes over the
    # world of 4.
    "ip_tp2": dict(pp=2, tp=2, schedule="1f1b", num_micro=2, save=True,
                   **IN_PROCESS),
    "ip_tp2_zero1": dict(pp=2, tp=2, schedule="1f1b", num_micro=2,
                         opt_sharding="zero1", **IN_PROCESS),
    "ip_sp2": dict(pp=2, sp=2, schedule="1f1b", num_micro=2, **IN_PROCESS),
    "ip_ep2_moe": dict(pp=2, ep=2, schedule="1f1b", num_micro=1,
                       **IN_PROCESS, **MOE),
    "ip_ada": dict(pp=2, schedule="1f1b", num_micro=1, **IN_PROCESS, **ADA),
    "ip_ada_zero1": dict(pp=2, schedule="1f1b", num_micro=1,
                         opt_sharding="zero1", **IN_PROCESS, **ADA),
    "ip_tp2_restore": dict(pp=2, tp=2, schedule="1f1b", num_micro=2,
                           restore=True, **IN_PROCESS),
}
# The in-process runs -> (the JAX pipeline they are held to, the
# tolerances of the parameters and of the losses). The tp 2 ZeRO-1 run
# is held to the replicated JAX step of its mesh: SGD's update is
# elementwise, so the layout does not change it. The sp run is one
# notch wider, as tests/test_pipeline.py's sp cells are.
IP_JAX = {
    "ip_tp2": ("ip_tp2", STEP_TOL, LOSS_ATOL),
    "ip_tp2_zero1": ("ip_tp2", STEP_TOL, LOSS_ATOL),
    "ip_sp2": ("ip_sp2", dict(rtol=5e-4, atol=5e-5), 3e-4),
    "ip_ep2_moe": ("ip_ep2_moe", STEP_TOL, LOSS_ATOL),
    "ip_ada": ("ip_ada", STEP_TOL, LOSS_ATOL),
    "ip_ada_zero1": ("ip_ada_zero1", STEP_TOL, LOSS_ATOL),
}

WORKER = r"""
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
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.ops.optim import SGD, Adafactor
from tpu_ddp_torch.train.lm import PipelineLMTrainer, make_lm_batch
from tpu_ddp_torch.utils.tree import keyed_leaves, tree_leaves

out = {}
toks = np.asarray(spec["tokens"])
for name, c in spec["runs"].items():
    c = dict(c)
    model = make_transformer(c.pop("preset", "TransformerLM-tiny"),
                             max_seq_len=spec["seq"],
                             compute_dtype=torch.float32,
                             num_layers=spec["layers"], **c.pop("model", {}))
    opt = (Adafactor(min_dim_size_to_factor=8)
           if c.pop("optimizer", None) == "adafactor" else
           SGD(learning_rate=0.1, momentum=0.9, weight_decay=1e-4))
    save, restore = c.pop("save", False), c.pop("restore", False)
    tr = PipelineLMTrainer(model, device="cpu", optimizer=opt, **c)
    if restore:
        state = tr.restore_checkpoint(spec["jax_ckpt"])
    else:
        state = tr.init_state(seed=7)
    per = len(toks) // (tr.dp * tr.ep)
    row = tr.data_index // (tr.sp * tr.ep) * tr.ep + tr.ep_index
    x, y = tr.put_batch(*make_lm_batch(toks[row * per:(row + 1) * per]))
    losses = []
    for _ in range(0 if restore else spec["steps"]):
        state, loss = tr.train_step(state, x, y)
        losses.append(float(loss))
    out[f"{name}/losses"] = np.array(losses)
    out[f"{name}/coords"] = np.array([tr.data_index, tr.tp_index,
                                      tr.pp_index])
    if not tr.is_fsdp:
        for k in ("embed", "head"):
            out[f"{name}/rep/{k}"] = state.params[k].detach().numpy()
        out[f"{name}/rep/ln_f"] = state.params["ln_f"]["scale"].detach(
            ).numpy()
    if save:
        tr.save_checkpoint(spec["out"] + f"_{name}_ckpt", state)
    host = tr.state_to_host(state)
    if rank == 0:
        for k, v in keyed_leaves(host):
            out[f"{name}/{k}"] = np.asarray(v)
np.savez(spec["out"] + f".{rank}.npz", **out)
dist.barrier()
sys.stdout.flush()
os._exit(0)
"""


def _tokens():
    return np.random.default_rng(11).integers(0, 1024, size=(4, SEQ + 1))


def _seed7(preset="TransformerLM-tiny", **model):
    """The port's seed-7 dense parameters as numpy."""
    m = make_transformer(preset, max_seq_len=SEQ,
                         compute_dtype=torch.float32, num_layers=LAYERS,
                         **model)
    return params_to_jax(m.init(torch.Generator().manual_seed(7)))


def _jax_model(preset="TransformerLM-tiny", **model):
    return jax_make(preset, max_seq_len=SEQ, compute_dtype=jnp.float32,
                    num_layers=LAYERS, **model)


def _jsgd():
    return JaxSGD(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)


def _flat(tree, prefix):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {prefix + jax.tree_util.keystr(p, simple=True, separator="."):
            np.asarray(v) for p, v in flat}


def _jax_pipe(dp, pp, ep=1, preset="TransformerLM-tiny", model=None,
              optimizer=None, sp=1, mp=1, **kw):
    """JAX's PipelineLMTrainer on dp x sp x mp x pp x ep virtual devices
    and its state from the port's seed-7 parameters (stacked, rows
    permuted under interleaving)."""
    model = model or {}
    tr = JaxPipe(_jax_model(preset, **model),
                 make_mesh(jax.devices()[:dp * sp * mp * pp * ep], dp=dp,
                           sp=sp, mp=mp, pp=pp, ep=ep),
                 optimizer=optimizer or _jsgd(), **kw)
    params = jpipe.stack_block_params(jax.tree.map(
        jnp.asarray, _seed7(preset, **model)))
    if tr._layer_perm is not None:
        params = jpipe.permute_stacked_blocks(params, tr._layer_perm)
    return tr, tr._place_state(params, tr.optimizer.init(params))


def _jax_steps(tr, state, steps=2):
    x, y = tr.put_batch(*make_lm_batch(_tokens()))
    losses = []
    for _ in range(steps):
        state, loss = tr.train_step(state, x, y)
        losses.append(float(np.mean(np.asarray(loss))))
    return np.array(losses), _flat(tr.params_to_host(state), "params.")


def _jax_dense():
    """Two steps of JAX's dense LMTrainer on one device: (losses, the
    stacked canonical params keyed as the records)."""
    tr = JaxLMTrainer(_jax_model(), make_mesh(jax.devices()[:1], dp=1),
                      optimizer=_jsgd())
    params = jax.tree.map(jnp.asarray, _seed7())
    state = tr._place_state(params, tr.optimizer.init(params))
    x, y = tr.put_batch(*make_lm_batch(_tokens()))
    losses = []
    for _ in range(2):
        state, loss = tr.train_step(state, x, y)
        losses.append(float(np.mean(np.asarray(loss))))
    host = jpipe.stack_block_params(jax.device_get(state.params))
    return np.array(losses), _flat(host, "params.")


def _port_losses(recs, name):
    """(steps,) the mean over data shards of each shard's loss; every
    process of a shard (its tp and pp peers) reports the same."""
    by_shard: dict = {}
    for rec in recs:
        shard = int(rec[f"{name}/coords"][0])
        got = rec[f"{name}/losses"]
        if shard in by_shard:
            np.testing.assert_allclose(got, by_shard[shard], rtol=1e-6,
                                       atol=1e-6)
        by_shard[shard] = got
    return np.mean(list(by_shard.values()), axis=0)


def _params(rec, name):
    pre = f"{name}/params."
    return {k[len(name) + 1:]: v for k, v in rec.items()
            if k.startswith(pre)}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The world-4 runs and the JAX results they are held to."""
    tmp = tmp_path_factory.mktemp("lm_pp")
    # A checkpoint of JAX's interleaved trainer (rows permuted in memory,
    # the dense order on disk) for the port to restore.
    jt, js = _jax_pipe(1, 2, num_micro=2, schedule="interleaved",
                       pp_virtual=2)
    jt.save_checkpoint(str(tmp / "jax_ckpt"), js)
    handle = launch(WORKER, 4, {
        "runs": RUNS, "tokens": _tokens().tolist(), "seq": SEQ,
        "layers": LAYERS, "steps": 2, "out": str(tmp / "pp"),
        "jax_ckpt": str(tmp / "jax_ckpt")})
    jax_out = {"dense": _jax_dense(),
               "factored_zero1": _jax_steps(*_jax_pipe(
                   2, 2, num_micro=2, schedule="1f1b", opt_sharding="zero1",
                   optimizer=JaxAdafactor(min_dim_size_to_factor=8))),
               "ep2pp2_moe": _jax_steps(*_jax_pipe(
                   1, 2, ep=2, num_micro=2, schedule="1f1b",
                   preset=MOE["preset"], model=MOE["model"])),
               "clip": _jax_steps(*_jax_pipe(
                   2, 2, num_micro=2, schedule="1f1b",
                   clip_grad_norm=CLIP)),
               "ip_tp2": _jax_steps(*_jax_pipe(
                   2, 2, mp=2, num_micro=2, schedule="1f1b")),
               "ip_sp2": _jax_steps(*_jax_pipe(
                   2, 2, sp=2, num_micro=2, schedule="1f1b")),
               "ip_ep2_moe": _jax_steps(*_jax_pipe(
                   2, 2, ep=2, num_micro=1, schedule="1f1b",
                   preset=MOE["preset"], model=MOE["model"])),
               "ip_ada": _jax_steps(*_jax_pipe(
                   4, 2, num_micro=1, schedule="1f1b",
                   optimizer=JaxAdafactor(min_dim_size_to_factor=8))),
               "ip_ada_zero1": _jax_steps(*_jax_pipe(
                   4, 2, num_micro=1, schedule="1f1b", opt_sharding="zero1",
                   optimizer=JaxAdafactor(min_dim_size_to_factor=8)))}
    recs = collect(handle)
    return recs, jax_out, tmp


@pytest.mark.parametrize("name", ["dp2pp2", "tp2pp2", "sp2pp2",
                                  "in_process_dp4"])
def test_mesh_matches_jax_dense(world4, name):
    recs, jax_out, _ = world4
    want_losses, want = jax_out["dense"]
    np.testing.assert_allclose(_port_losses(recs, name), want_losses,
                               rtol=0, atol=LOSS_ATOL)
    got = _params(recs[0], name)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **STEP_TOL, err_msg=k)


@pytest.mark.parametrize("name", ["zero1", "zero2", "fsdp"])
def test_sharded_layouts_match_replicated(world4, name):
    recs, jax_out, _ = world4
    ref = _params(recs[0], "dp2pp2")
    got = _params(recs[0], name)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], **LAYOUT_TOL,
                                   err_msg=f"{name} {k}")
    np.testing.assert_allclose(_port_losses(recs, name),
                               _port_losses(recs, "dp2pp2"), rtol=1e-6,
                               atol=1e-6)
    # The step is also the JAX dense step (zero2 and fsdp after 1f1b and
    # gpipe schedules).
    want = jax_out["dense"][1]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **STEP_TOL, err_msg=k)


@pytest.mark.parametrize("name", ["factored_zero1", "ep2pp2_moe"])
def test_matches_jax_pipeline(world4, name):
    """Adafactor under ZeRO-1 factors each stage cell's own rows (JAX's
    FactoredZeRO1 over P((pp, dp))); the MoE pipeline drops the
    load-balance loss as JAX's does."""
    recs, jax_out, _ = world4
    want_losses, want = jax_out[name]
    np.testing.assert_allclose(_port_losses(recs, name), want_losses,
                               rtol=0, atol=LOSS_ATOL)
    got = _params(recs[0], name)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **STEP_TOL, err_msg=k)


@pytest.mark.parametrize("name", list(IP_JAX))
def test_in_process_stages_compose_as_jax_pipeline(world4, name):
    """Every stage in one process with tp, sp (ring) or ep over the
    other processes, replicated Adafactor per stage cell at dp 4,
    Adafactor under ZeRO-1 (each stage cell's rows dp-sharded within it)
    and tp 2 under ZeRO-1: JAX's PipelineLMTrainer on the mesh with the
    pp axis as devices."""
    recs, jax_out, _ = world4
    ref, tol, loss_atol = IP_JAX[name]
    want_losses, want = jax_out[ref]
    np.testing.assert_allclose(_port_losses(recs, name), want_losses,
                               rtol=0, atol=loss_atol)
    got = _params(recs[0], name)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **tol, err_msg=k)


@pytest.mark.parametrize("name", ["clip", "clip_zero1"])
def test_clip_matches_jax_pipeline(world4, name):
    """The clip's global norm at pp > 1 (each stage's stacked leaves
    summed over pp, the replicated leaves counted once) is JAX's, under
    the replicated layout and ZeRO-1's stage cells; the clip binds."""
    recs, jax_out, _ = world4
    want_losses, want = jax_out["clip"]
    np.testing.assert_allclose(_port_losses(recs, name), want_losses,
                               rtol=0, atol=LOSS_ATOL)
    got = _params(recs[0], name)
    unclipped = _params(recs[0], "dp2pp2")
    assert set(got) == set(want)
    moved = 0.0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **STEP_TOL, err_msg=k)
        moved = max(moved, float(np.abs(got[k] - unclipped[k]).max()))
    assert moved > 100 * STEP_TOL["atol"]


def test_replicated_leaves_equal_across_stages(world4):
    """Embed, ln_f and head get their real gradient on one stage only;
    the pp sum keeps every stage's copy the same bits after two steps."""
    recs, _, _ = world4
    checked = 0
    for name in RUNS:
        if f"{name}/rep/embed" not in recs[0]:
            continue
        groups: dict = {}
        for rec in recs:
            data, t, _ = (int(v) for v in rec[f"{name}/coords"])
            groups.setdefault((data, t), []).append(rec)
        for peers in groups.values():
            for rec in peers[1:]:
                for k in ("embed", "head", "ln_f"):
                    np.testing.assert_array_equal(
                        rec[f"{name}/rep/{k}"], peers[0][f"{name}/rep/{k}"],
                        err_msg=f"{name} {k}")
                    checked += 1
    assert checked > 0


def test_checkpoints_move_between_the_packages(world4):
    """The port's interleaved trainer writes the dense order, which JAX's
    interleaved and 1f1b trainers restore bit for bit; the port's 1f1b
    trainer restores JAX's interleaved checkpoint bit for bit."""
    recs, _, tmp = world4
    got = {k: v for k, v in recs[0].items()
           if k.startswith("interleaved_save/")}
    for kw in (dict(schedule="interleaved", pp_virtual=2), {}):
        jt, _ = _jax_pipe(2, 2, num_micro=2, **kw)
        state = jt.restore_checkpoint(str(tmp / "pp_interleaved_save_ckpt"))
        assert state.step == 2
        want = _flat(jt.params_to_host(state), "params.")
        for k, v in want.items():
            np.testing.assert_array_equal(got[f"interleaved_save/{k}"], v)
    seed = _flat(jpipe.stack_block_params(_seed7()), "params.")
    for name in ("restore_jax", "ip_tp2_restore"):
        restored = _params(recs[0], name)
        assert set(restored) == set(seed)
        for k, v in seed.items():
            np.testing.assert_array_equal(restored[k], v, err_msg=k)


def test_in_process_tp_checkpoint_moves_between_the_packages(world4):
    """The in-process tp 2 run's checkpoint (every stage and both tp
    cells gathered into JAX's stacked tree) restores in JAX's trainer
    on its dp x mp x pp mesh bit for bit, momentum included; the port's
    in-process tp 2 trainer restored JAX's checkpoint above."""
    recs, _, tmp = world4
    got = {k[len("ip_tp2/"):]: v for k, v in recs[0].items()
           if k.startswith("ip_tp2/params.")
           or k.startswith("ip_tp2/opt_state.")}
    jt, _ = _jax_pipe(2, 2, mp=2, num_micro=2, schedule="1f1b")
    state = jt.restore_checkpoint(str(tmp / "pp_ip_tp2_ckpt"))
    assert state.step == 2
    want = _flat(jt.params_to_host(state), "params.")
    want.update(_flat(jax.device_get(state.opt_state), "opt_state."))
    assert set(want) <= set(got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.fixture(scope="module")
def cli_logs():
    """``examples/lm_train`` at TPU_DDP_LM_PP=2, one process per stage,
    two steps under each schedule (two schedules at a time)."""
    logs = {}
    for pair in (("gpipe", "1f1b"), ("interleaved", "zerobubble")):
        started = {}
        for schedule in pair:
            port = str(free_port())
            started[schedule] = start_ranks(
                lambda r, port=port: [
                    "-m", "tpu_ddp_torch.examples.lm_train", "--num-nodes",
                    "2", "--rank", str(r), "--master-ip", "127.0.0.1",
                    "--master-port", port, "--device", "cpu"], 2,
                env={"TPU_DDP_LM_PP": "2", "TPU_DDP_PP_SCHEDULE": schedule,
                     "TPU_DDP_PP_MICROBATCHES": "2",
                     "TPU_DDP_LM_STEPS": "2"})
        logs.update({k: wait_ranks(v, 150) for k, v in started.items()})
    return logs


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved",
                                      "zerobubble"])
def test_cli_runs_the_pipeline_rung(cli_logs, schedule):
    """Both stages print the schedule and the same losses, and every
    schedule the same step."""
    losses = []
    for log in cli_logs[schedule]:
        assert "pp=2" in log and f"schedule={schedule} micro=2" in log, log
        losses.append([float(v) for v in
                       re.findall(r"step \d/2 loss ([0-9.]+)", log)])
    assert len(losses[0]) == 2 and losses[0] == losses[1], losses
    want = [float(v) for v in re.findall(r"step \d/2 loss ([0-9.]+)",
                                         cli_logs["gpipe"][0])]
    np.testing.assert_allclose(losses[0], want, rtol=0, atol=1e-4)
