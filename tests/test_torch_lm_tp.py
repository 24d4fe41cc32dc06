"""``LMTrainer(tp=...)`` in the port (tpu_ddp_torch/train/lm.py) held
against the JAX ``LMTrainer`` on the same mesh, f32, from the same seed-3
parameters and numpy-seeded tokens.

One gloo world of 4 processes (tests/torch_tp.py, 150 s limit) trains
every run two steps: dp x tp, sp x tp (ring and Ulysses) and ep x tp in
the replicated layout, ZeRO-1, ZeRO-2 and FSDP beside them, Adafactor per
cell (``CellAdafactor``) and under ZeRO-1 (``FactoredZeRO1`` with the
cells' row geometry), ZeRO-1/2 and FSDP over an ep = 2 partition at
tp = 1 (10.8b), the global-norm clip, dropout, the K-step call and a
checkpoint each way; beside it ``examples/lm_train`` runs on 2 ranks at
``TPU_DDP_LM_TP=2``. JAX runs its trainers under ``shard_map`` on the
virtual devices while the ranks run.

Tolerances: losses within 1e-4 and parameters (and Adafactor's per-cell
state) within rtol 1e-4 / atol 1e-5 of JAX's (rtol 3e-4 / atol 3e-5
for the MoE runs, tests/test_torch_moe.py's bound: the routing's
capacity sums and the all-to-all order add rounding); ZeRO-1/2 and FSDP
within rtol 1e-5 / atol 1e-6 of the port's replicated run on the same
mesh (the same sums grouped otherwise); checkpoints bit for bit (the
restoring side reads the writer's bytes).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ranks import free_port, start_ranks, wait_ranks
from torch_tp import (MOE, MOE_PRESET, collect, jax_host_params,
                      jax_trainer, jax_train, lm_runs, rank_losses)
from tpu_ddp.models import make_transformer as jax_make
from tpu_ddp.parallel.mesh import make_mesh
from tpu_ddp.train.lm import LMTrainer as JaxLMTrainer
from tpu_ddp_torch.convert import params_to_jax
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.train.lm import LMTrainer, make_lm_batch

LOSS_ATOL = 1e-4
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
MOE_TOL = dict(rtol=3e-4, atol=3e-5)
LAYOUT_TOL = dict(rtol=1e-5, atol=1e-6)
MOE_RUN = dict(preset=MOE_PRESET, model=MOE)
ADA = dict(optimizer="adafactor")
CLIP = 0.05

# name -> the port run (world 4) and its JAX mesh (dp, sp, tp, ep).
RUNS = {
    "dp2tp2": (dict(tp=2), (2, 1, 2, 1)),
    "sp2tp2_ring": (dict(tp=2, sp=2), (1, 2, 2, 1)),
    "sp2tp2_ulysses": (dict(tp=2, sp=2, mode="ulysses"), (1, 2, 2, 1)),
    "ep2tp2": (dict(tp=2, ep=2, **MOE_RUN), (1, 1, 2, 2)),
    "dp2ep2": (dict(tp=1, ep=2, **MOE_RUN), (2, 1, 1, 2)),
    "cell_adafactor": (dict(tp=2, **ADA), (2, 1, 2, 1)),
    "factored_zero1": (dict(tp=2, opt="zero1", **ADA), (2, 1, 2, 1)),
    "clip": (dict(tp=2, clip=CLIP), (2, 1, 2, 1)),
    "clip_zero2": (dict(tp=2, clip=CLIP, opt="zero2"), (2, 1, 2, 1)),
    "ep2tp2_clip": (dict(tp=2, ep=2, clip=CLIP, **MOE_RUN), (1, 1, 2, 2)),
}
# Layout runs held to the port's replicated run of the same mesh.
LAYOUTS = {
    f"{base}_{lay}": (base, dict(RUNS[base][0], **kw))
    for base in ("dp2tp2", "sp2tp2_ring", "ep2tp2", "dp2ep2")
    for lay, kw in (("zero1", dict(opt="zero1")), ("zero2", dict(opt="zero2")),
                    ("fsdp", dict(param="fsdp")))
}
DROPOUT = dict(tp=2, model=dict(dropout_rate=0.1), dropout_seed=7)


def _jax_kw(run: dict, mesh) -> dict:
    dp, sp, tp, ep = mesh
    kw = dict(dp=dp, sp=sp, tp=tp, ep=ep, mode=run.get("mode", "ring"),
              opt=run.get("opt", "replicated"), clip=run.get("clip"),
              optimizer=run.get("optimizer", "sgd"))
    if "preset" in run:
        kw.update(preset=run["preset"], model=run["model"])
    return kw


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    """(the ranks' records, {name: (JAX losses, JAX trainer, state)},
    the JAX checkpoint's host state, the port checkpoint's directory)."""
    tmp = tmp_path_factory.mktemp("lmtp")
    # JAX writes the checkpoint the port restores before the ranks start.
    jt, st = jax_trainer(**_jax_kw(RUNS["cell_adafactor"][0], (2, 1, 2, 1)))
    _, st = jax_train(jt, st)
    jax_dir = str(tmp / "jax_ckpt")
    jt.save_checkpoint(jax_dir, st)
    port_dir = str(tmp / "port_ckpt")
    runs = {name: run for name, (run, _) in RUNS.items()}
    runs.update({name: run for name, (_, run) in LAYOUTS.items()})
    runs["dropout"] = DROPOUT
    runs["save"] = dict(RUNS["cell_adafactor"][0], save=port_dir)
    runs["restore"] = dict(RUNS["cell_adafactor"][0], restore=jax_dir)
    runs["multi"] = dict(RUNS["dp2tp2"][0], multi=True)
    handle = lm_runs(tmp, 4, runs, "lm")
    port = str(free_port())
    cli = start_ranks(lambda r: [
        "-m", "tpu_ddp_torch.examples.lm_train", "--num-nodes", "2",
        "--rank", str(r), "--master-ip", "127.0.0.1", "--master-port",
        port, "--device", "cpu"], 2,
        env={"TPU_DDP_LM_TP": "2", "TPU_DDP_LM_STEPS": "3"})
    want = {}
    for name, (run, mesh) in RUNS.items():
        t, s = jax_trainer(**_jax_kw(run, mesh))
        losses, s = jax_train(t, s)
        want[name] = (losses, t, s)
    return (collect(handle), want, (jt, st), port_dir,
            wait_ranks(cli, 150))


def _params(rec, name):
    return {k[len(name) + 1:]: v for k, v in rec.items()
            if k.startswith(f"{name}/params.")}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_trainer_matches_jax_on_the_same_mesh(lm, name):
    recs, want = lm[0], lm[1]
    run, (dp, sp, tp, ep) = RUNS[name]
    losses, jt, jstate = want[name]
    np.testing.assert_allclose(rank_losses(recs, name, dp, sp, ep),
                               losses, atol=LOSS_ATOL, rtol=0)
    tol = MOE_TOL if "preset" in run else STEP_TOL
    got = _params(recs[0], name)
    wparams = jax_host_params(jt, jstate)
    assert sorted(got) == sorted(wparams)
    for key, w in wparams.items():
        np.testing.assert_allclose(got[key], w, **tol, err_msg=key)
    if run.get("optimizer") == "adafactor":
        # Per-cell state in the JAX wrapper's global layout.
        host = jt._gather_to_host(jstate.opt_state)
        if jt.opt_zero1:
            host = jt.optimizer.canonicalize_opt_host(host)
        flat, _ = jax.tree_util.tree_flatten_with_path(host)
        for p, w in flat:
            key = f"{name}/opt_state." + jax.tree_util.keystr(
                p, simple=True, separator=".")
            assert recs[0][key].shape == np.shape(w), key
            np.testing.assert_allclose(recs[0][key], w, **tol,
                                       err_msg=key)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_sharded_layouts_match_replicated(lm, name):
    recs = lm[0]
    base = LAYOUTS[name][0]
    for rec in recs:
        np.testing.assert_allclose(rec[f"{name}/losses"],
                                   rec[f"{base}/losses"], **LAYOUT_TOL)
    want = _params(recs[0], base)
    got = _params(recs[0], name)
    assert want and sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, **LAYOUT_TOL, err_msg=key)


def test_dropout_masks_equal_across_tp_peers(lm):
    """The key folds the data-shard index: equal on the two tp ranks of
    a shard (so are their losses), different across shards."""
    recs = lm[0]
    by_shard: dict = {}
    for rec in recs:
        data, t = (int(v) for v in rec["dropout/coords"])
        by_shard.setdefault(data, []).append(rec)
    assert sorted(by_shard) == [0, 1]
    for data, peers in by_shard.items():
        assert len(peers) == 2
        np.testing.assert_array_equal(peers[0]["dropout/key"],
                                      peers[1]["dropout/key"])
        np.testing.assert_array_equal(peers[0]["dropout/losses"],
                                      peers[1]["dropout/losses"])
    assert not np.array_equal(by_shard[0][0]["dropout/key"],
                              by_shard[1][0]["dropout/key"])
    # Dropout is on: the first step's loss differs from the plain run's.
    assert not np.allclose(by_shard[0][0]["dropout/losses"],
                           by_shard[0][0]["dp2tp2/losses"])


def test_port_checkpoint_restores_into_jax(lm):
    recs, port_dir = lm[0], lm[3]
    jt = jax_trainer(**_jax_kw(RUNS["cell_adafactor"][0], (2, 1, 2, 1)))[0]
    restored = jt.restore_checkpoint(port_dir)
    assert restored.step == 2
    for key, w in jax_host_params(jt, restored).items():
        np.testing.assert_array_equal(recs[0][f"save/{key}"], w)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jt._gather_to_host(restored.opt_state))
    for p, w in flat:
        key = "save/opt_state." + jax.tree_util.keystr(p, simple=True,
                                                       separator=".")
        np.testing.assert_array_equal(recs[0][key], np.asarray(w),
                                      err_msg=key)


def test_jax_checkpoint_restores_into_the_port(lm):
    recs, (jt, jstate) = lm[0], lm[2]
    assert int(recs[0]["restore/step"]) == 2
    for key, w in jax_host_params(jt, jstate).items():
        np.testing.assert_array_equal(recs[0][f"restore/{key}"], w)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jt._gather_to_host(jstate.opt_state))
    for p, w in flat:
        key = "restore/opt_state." + jax.tree_util.keystr(
            p, simple=True, separator=".")
        np.testing.assert_array_equal(recs[0][key], np.asarray(w),
                                      err_msg=key)


def test_k_step_call_is_train_step_bit_for_bit(lm):
    for rec in lm[0]:
        np.testing.assert_array_equal(rec["multi/losses"],
                                      rec["dp2tp2/losses"])
    for key, w in _params(lm[0][0], "dp2tp2").items():
        np.testing.assert_array_equal(lm[0][0][f"multi/{key}"], w)


def test_cli_tp2_matches_jax_mesh(lm):
    """``examples/lm_train`` at ``TPU_DDP_LM_TP=2`` on 2 gloo ranks (one
    dp group, both ranks fed its rows): each rank prints the loss of the
    JAX ``LMTrainer`` on an ``mp = 2`` mesh from the port's seed-0
    weights, AdamW, within tests/test_torch_lm.py's 1.5e-4."""
    logs = lm[4]
    for r, log in enumerate(logs):
        assert (f"[lm_train] rank={r} world=2 dp=1 sp=1 tp=2 pp=1" in log
                ), log
    printed = [[float(v) for v in re.findall(
        r"\[lm_train\] step \d+/3 loss (\S+)", log)] for log in logs]
    assert [len(p) for p in printed] == [3, 3]
    assert printed[0] == printed[1]
    tm = make_transformer("TransformerLM-tiny", max_seq_len=32,
                          compute_dtype=torch.float32)
    jm = jax_make("TransformerLM-tiny", max_seq_len=32,
                  compute_dtype=jnp.float32)
    params = LMTrainer(tm, device="cpu").init_state(seed=0).params
    jparams = jax.tree.map(jnp.asarray, params_to_jax(params))
    jt = JaxLMTrainer(jm, make_mesh(jax.devices()[:2], dp=1, mp=2))
    jstate = jt._place_state(jparams, jt.optimizer.init(jparams))
    tokens = np.random.default_rng(1234).integers(0, 1024, size=(8, 33))
    x, y = jt.put_batch(*make_lm_batch(tokens))
    for step in range(3):
        jstate, loss = jt.train_step(jstate, x, y)
        assert abs(printed[0][step] - float(np.asarray(loss).mean())) \
            <= 1.5e-4, (step, printed[0][step], np.asarray(loss))
