"""The port's checkpoints (tpu_ddp_torch/utils/checkpoint.py,
resilience/integrity.py, parallel/redistribute.py's plan file, the
trainers' save/restore and the ladder's ``--ckpt-dir``/``--resume``) held
against the JAX package's: the same on-disk format, leaf keys and digests,
so a checkpoint written by either package restores in the other.

Tolerance: none. Every comparison is bit equality (numpy
``assert_array_equal``, sha256 digests, manifest text), because a
checkpoint moves bytes and the converters only transpose.
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.models import make_transformer as jax_make
from tpu_ddp.models.vgg import VGGModel as JaxVGG
from tpu_ddp.parallel.mesh import make_mesh
from tpu_ddp.resilience import integrity as jax_integrity
from tpu_ddp.train.engine import Trainer as JaxTrainer
from tpu_ddp.train.lm import LMTrainer as JaxLMTrainer
from tpu_ddp.utils import checkpoint as jax_ckpt
from tpu_ddp.utils.config import TrainConfig as JaxConfig
from tpu_ddp_torch.convert import (vgg_momentum_from_jax,
                                   vgg_momentum_to_jax, vgg_params_from_jax,
                                   vgg_params_to_jax)
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.models.vgg import VGGModel
from tpu_ddp_torch.parallel.redistribute import P, ShardingPlan
from tpu_ddp_torch.resilience.integrity import (CheckpointCorruptError,
                                                leaf_digest,
                                                restore_newest_verified,
                                                verify_checkpoint)
from tpu_ddp_torch.train.engine import Trainer
from tpu_ddp_torch.train.lm import LMTrainer, make_lm_batch
from tpu_ddp_torch.utils import checkpoint as ckpt
from tpu_ddp_torch.utils.config import TrainConfig
from tpu_ddp_torch.utils.tree import keyed_leaves, keyed_unflatten

TINY = (8, "M", 16, "M", 16, "M", 16, "M", 16, "M")
KNOBS = dict(pallas_sgd=True, pallas_bn=True, compute_dtype="float32")
SEQ = 32


def _host(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _jax_trainer(strategy="none", mesh=None):
    model = JaxVGG(name="tiny", cfg=TINY, compute_dtype=jnp.float32,
                   use_pallas_bn=True)
    return JaxTrainer(model, JaxConfig(**KNOBS), strategy=strategy,
                      mesh=mesh)


def _port_trainer():
    model = VGGModel("tiny", TINY, compute_dtype=torch.float32,
                     use_pallas_bn=True)
    return Trainer(model, TrainConfig(**KNOBS), device="cpu")


def _batches(n, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(4, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, size=4).astype(np.int64))
            for _ in range(n)]


def _port_steps(trainer, state, batches):
    for x, y in batches:
        state, _ = trainer.train_step(
            state, torch.from_numpy(x).permute(0, 3, 1, 2),
            torch.from_numpy(y))
    return state


def _jax_steps(trainer, state, batches):
    for x, y in batches:
        xb, yb, wb = trainer.put_batch(x, y.astype(np.int32))
        state, _ = trainer.train_step(state, xb, yb, wb)
    return state


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)


def _assert_tree_equal(got, want):
    g, w = jax.tree_util.tree_flatten_with_path(want)[0], \
        jax.tree.leaves(got)
    assert len(g) == len(w)
    for (path, a), b in zip(g, w):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=jax.tree_util.keystr(path))


# ---- leaf order and keys ---------------------------------------------------

@pytest.mark.parametrize("tree", [
    {"b": np.zeros(2), "a": {"z": np.ones(1), "c": (np.zeros(3),
                                                     np.ones(4))}},
    {"params": ({"kernel": np.zeros(1), "bias": np.zeros(2)},),
     "step": np.int64(0), "opt_state": {"momentum": [np.zeros(5)]}},
    {"x": np.float32(1.0)},
])
def test_keyed_leaves_follow_jax_pytree_order(tree):
    """Paths and order are JAX's ``tree_flatten_with_path`` with
    ``keystr(simple=True, separator=".")``; unflatten inverts."""
    want = [(jax.tree_util.keystr(p, simple=True, separator="."), leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]
    got = keyed_leaves(tree)
    assert [k for k, _ in got] == [k for k, _ in want]
    assert all(a is b for (_, a), (_, b) in zip(got, want))
    back = keyed_unflatten(tree, [leaf for _, leaf in got])
    assert jax.tree.structure(back) == jax.tree.structure(tree)


def test_momentum_converter_transposes_like_the_params():
    """Momentum (a leaf list in parameter order) goes through exactly the
    params converter's layouts, both ways."""
    model = _port_trainer().model
    leaves = [torch.randn(p.shape, generator=torch.Generator().manual_seed(i))
              for i, p in enumerate(model.parameters())]
    tree = vgg_momentum_to_jax(model, leaves)
    for k, v in vgg_params_from_jax(model, tree, device="cpu").items():
        np.testing.assert_array_equal(
            v.numpy(), dict(zip([n for n, _ in model.named_parameters()],
                                leaves))[k].numpy())
    back = vgg_momentum_from_jax(model, tree, device="cpu")
    for a, b in zip(back, leaves):
        assert a.is_contiguous()
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    _assert_tree_equal(vgg_params_to_jax(model),
                       vgg_momentum_to_jax(model, list(model.parameters())))


# ---- cross-package round trips: VGG -----------------------------------------

def test_vgg_manifest_and_plan_match_a_jax_save(tmp_path):
    """The port saves a trained state; the JAX Trainer saves the same
    state: manifest leaves, digests and the plan file are identical."""
    tt = _port_trainer()
    state = _port_steps(tt, tt.init_state(), _batches(2))
    tt.save_checkpoint(str(tmp_path / "port"), state)
    jt = _jax_trainer()
    jstate = jt.state_from_host(tt.state_to_host(state))
    jt.save_checkpoint(str(tmp_path / "jax"), jstate)
    mine, theirs = (_manifest(tmp_path / d, 2) for d in ("port", "jax"))
    assert mine == theirs
    assert mine["leaves"][-1] == "00044:step"
    assert mine["leaves"][0] == "00000:opt_state.momentum.features.0.bias"
    for d in ("port", "jax"):
        assert (tmp_path / d / "sharding_plan.json").read_text() == (
            tmp_path / "jax" / "sharding_plan.json").read_text()


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """JAX trains two steps and saves; the port restores through its own
    reader: params and momentum equal the converted JAX state bit for
    bit, the step carries over, and the port trains on from it."""
    jt = _jax_trainer()
    jstate = _jax_steps(jt, jt.init_state(), _batches(2))
    jt.save_checkpoint(str(tmp_path), jstate)
    tt = _port_trainer()
    state = tt.restore_checkpoint(str(tmp_path))
    assert state.step == 2
    jhost = jt.state_to_host(jstate)
    want = vgg_params_from_jax(tt.model, jhost["params"], device="cpu")
    for name, p in tt.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name].numpy(),
                                      err_msg=name)
    for a, b in zip(state.opt_state["momentum"], vgg_momentum_from_jax(
            tt.model, jhost["opt_state"]["momentum"], device="cpu")):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert state.params[0] is next(tt.model.parameters())
    state = _port_steps(tt, state, _batches(1, seed=4))
    assert state.step == 3


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The port trains two steps and saves; the JAX package's reader and
    verifier accept the file, and the JAX Trainer restores it (with no
    layout warning) to the port's state bit for bit."""
    tt = _port_trainer()
    state = _port_steps(tt, tt.init_state(), _batches(2))
    path = tt.save_checkpoint(str(tmp_path), state)
    assert jax_integrity.verify_checkpoint(path) == 45
    host = tt.state_to_host(state)
    jt = _jax_trainer()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jstate = jt.restore_checkpoint(str(tmp_path))
    assert not [w for w in caught if "layout" in str(w.message)]
    assert jstate.step == 2
    _assert_tree_equal(jt.state_to_host(jstate), host)
    raw, step = jax_ckpt.restore_checkpoint(str(tmp_path), host)
    assert step == 2
    _assert_tree_equal(raw, host)


def test_plan_of_another_layout_warns(tmp_path):
    """A checkpoint from a 2-device all_reduce JAX trainer restores in the
    port's part-1 trainer with the JAX package's layout warning."""
    jt = _jax_trainer("all_reduce", make_mesh(jax.devices()[:2]))
    jt.save_checkpoint(str(tmp_path), jt.init_state())
    saved = ShardingPlan.load(str(tmp_path))
    assert saved.mesh_axes[0] == ("dp", 2)
    assert saved.opt_specs == {"momentum": P()}
    with pytest.warns(UserWarning, match="written by layout 'all_reduce'"):
        _port_trainer().restore_checkpoint(str(tmp_path))


# ---- cross-package round trips: TransformerLM-tiny -----------------------

def _lm_pair():
    jm = jax_make("TransformerLM-tiny", compute_dtype=jnp.float32,
                  max_seq_len=SEQ)
    tm = make_transformer("TransformerLM-tiny", compute_dtype=torch.float32,
                          max_seq_len=SEQ)
    return (JaxLMTrainer(jm, make_mesh(jax.devices()[:1])),
            LMTrainer(tm, device="cpu"))


def _lm_tokens(seed=0):
    return np.random.default_rng(seed).integers(0, 1024, size=(4, SEQ + 1))


def test_lm_jax_checkpoint_restores_in_the_port(tmp_path):
    """JAX LMTrainer steps twice and saves; the port restores params, both
    moments and the count bit for bit, and its plan equals the JAX one."""
    jt, tt = _lm_pair()
    jstate = jt.init_state(0)
    for _ in range(2):
        jstate, _ = jt.train_step(jstate, *jt.put_batch(
            *make_lm_batch(_lm_tokens())))
    jt.save_checkpoint(str(tmp_path), jstate)
    assert ShardingPlan.load(str(tmp_path)) == tt.sharding_plan()
    state = tt.restore_checkpoint(str(tmp_path))
    assert state.step == 2 and state.opt_state["count"] == 2
    _assert_tree_equal(tt.state_to_host(state), {
        "opt_state": _host(jstate.opt_state),
        "params": _host(jstate.params), "step": np.int64(2)})
    assert all(p.requires_grad for p in jax.tree.leaves(
        state.params, is_leaf=lambda x: isinstance(x, torch.Tensor)))


def test_lm_port_checkpoint_restores_in_jax(tmp_path):
    """The port steps twice and saves; the JAX verifier and LMTrainer
    accept it, and a JAX save of the same state has the same manifest
    (keys and digests)."""
    jt, tt = _lm_pair()
    state = tt.init_state(params=tt.model.init(
        torch.Generator().manual_seed(0)))
    x, y = tt.put_batch(*make_lm_batch(_lm_tokens()))
    for _ in range(2):
        state, _ = tt.train_step(state, x, y)
    path = tt.save_checkpoint(str(tmp_path / "port"), state)
    assert jax_integrity.verify_checkpoint(path) == 62
    jstate = jt.restore_checkpoint(str(tmp_path / "port"))
    assert jstate.step == 2
    host = tt.state_to_host(state)
    _assert_tree_equal({"opt_state": _host(jstate.opt_state),
                        "params": _host(jstate.params),
                        "step": np.int64(jstate.step)}, host)
    jt.save_checkpoint(str(tmp_path / "jax"), jstate)
    assert _manifest(tmp_path / "port", 2) == _manifest(tmp_path / "jax", 2)
    assert (tmp_path / "port" / "sharding_plan.json").read_text() == (
        tmp_path / "jax" / "sharding_plan.json").read_text()


# ---- the format -------------------------------------------------------------

def _tree(v=0.0):
    return {"params": {"w": np.full((3, 2), v, np.float32),
                       "b": np.arange(4, dtype=np.float32) + v},
            "step": np.int64(7)}


def test_save_is_atomic_and_keep_last_prunes(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 3):
        ckpt.save_checkpoint(d, _tree(step), step, keep_last=2)
    os.makedirs(os.path.join(d, ".tmp-cut"))       # a write cut short
    os.makedirs(os.path.join(d, "step_00000009"))  # no manifest yet
    assert ckpt.all_steps(d) == [2, 3] and ckpt.latest_step(d) == 3
    assert ckpt.all_steps(str(tmp_path / "none")) == []
    got, step = ckpt.restore_checkpoint(d, _tree())
    assert step == 3
    _assert_tree_equal(got, _tree(3))
    m = _manifest(d, 3)
    assert m["format_version"] == 1
    assert m["leaves"] == ["00000:params.b", "00001:params.w", "00002:step"]
    assert m["digests"]["00001:params.w"] == leaf_digest(_tree(3)[
        "params"]["w"])
    # The same tree written by the JAX package: the same manifest.
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), _tree(3), 3)
    assert _manifest(tmp_path / "jax", 3) == m


def test_tensor_leaves_and_shape_template(tmp_path):
    """Tensors save as their numpy bytes; a zero-memory shape template
    restores them."""
    tree = {"a": torch.arange(6.).reshape(2, 3), "n": np.int32(5)}
    ckpt.save_checkpoint(str(tmp_path), tree, 1)
    template = {"a": ckpt.shape_leaf((2, 3)),
                "n": ckpt.shape_leaf((), np.int32)}
    got, _ = ckpt.restore_checkpoint(str(tmp_path), template)
    np.testing.assert_array_equal(got["a"], tree["a"].numpy())
    assert got["n"].dtype == np.int32 and int(got["n"]) == 5


def test_restore_tells_damage_from_another_model(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, _tree(1.0), 1)
    with pytest.raises(ValueError, match="structures differ"):
        ckpt.restore_checkpoint(d, {"params": _tree()["params"]})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(d, {"params": {"w": np.zeros((2, 3)),
                                               "b": np.zeros(4)},
                                    "step": np.int64(0)})
    with pytest.raises(KeyError, match="structure mismatch"):
        ckpt.restore_checkpoint(d, {"params": {"v": np.zeros((3, 2)),
                                               "b": np.zeros(4)},
                                    "step": np.int64(0)})
    got, _ = ckpt.restore_checkpoint(d, {"step": np.int64(0)},
                                     drop_extra=("params",))
    assert int(got["step"]) == 7
    npz = os.path.join(d, "step_00000001", "arrays.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    for reader in (ckpt.restore_checkpoint, jax_ckpt.restore_checkpoint):
        with pytest.raises(RuntimeError) as e:  # each package's own class
            reader(d, _tree())
        assert type(e.value).__name__ == "CheckpointCorruptError"
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "empty"), _tree())


def test_flipped_bit_fails_verification_in_both_packages(tmp_path):
    d = str(tmp_path)
    tree = _tree(1.0)
    tree["params"]["w"][1, 1] = np.float32(1.0000001)
    path = ckpt.save_checkpoint(d, tree, 1)
    assert verify_checkpoint(path) == 3
    tree["params"]["w"].view(np.uint32)[1, 1] ^= 1
    arrays = {k: v for k, v in zip(_manifest(d, 1)["leaves"],
                                   [tree["params"]["b"], tree["params"]["w"],
                                    tree["step"]])}
    with open(os.path.join(path, "arrays.npz"), "wb") as f:
        np.savez(f, **arrays)
    for verify in (verify_checkpoint, jax_integrity.verify_checkpoint):
        with pytest.raises(RuntimeError, match="digest mismatch on leaf "
                                               "'00001:params.w'"):
            verify(path)
    with pytest.raises(CheckpointCorruptError):
        ckpt.restore_checkpoint(d, _tree())
    ckpt.restore_checkpoint(d, _tree(), verify=False)


def test_corrupt_newest_is_quarantined_and_the_previous_restored(tmp_path):
    d = str(tmp_path)
    for step in (1, 2):
        ckpt.save_checkpoint(d, _tree(step), step)
    from tpu_ddp_torch.resilience.chaos import corrupt_latest_checkpoint
    assert corrupt_latest_checkpoint(d).endswith("step_00000002/arrays.npz")
    lines = []
    got, step = restore_newest_verified(d, _tree(), log=lines.append)
    assert step == 1
    _assert_tree_equal(got, _tree(1))
    assert os.path.isdir(os.path.join(d, "step_00000002.corrupt"))
    assert "step 2 failed verification" in lines[0]
    assert ckpt.all_steps(d) == [1]
    corrupt_latest_checkpoint(d)
    with pytest.raises(CheckpointCorruptError, match="every checkpoint"):
        restore_newest_verified(d, _tree(), log=lines.append)
    assert sorted(os.listdir(d)) == ["step_00000001.corrupt",
                                     "step_00000002.corrupt"]
    with pytest.raises(FileNotFoundError):
        restore_newest_verified(d, _tree())


def test_trainer_restore_falls_back_past_a_corrupt_checkpoint(tmp_path):
    tt = _port_trainer()
    state = tt.init_state()
    batches = _batches(2)
    state = _port_steps(tt, state, batches[:1])
    tt.save_checkpoint(str(tmp_path), state)
    want = tt.state_to_host(state)
    state = _port_steps(tt, state, batches[1:])
    tt.save_checkpoint(str(tmp_path), state)
    from tpu_ddp_torch.resilience.chaos import corrupt_latest_checkpoint
    corrupt_latest_checkpoint(str(tmp_path))
    fresh = _port_trainer()
    restored = fresh.restore_checkpoint(str(tmp_path))
    assert restored.step == 1
    _assert_tree_equal(fresh.state_to_host(restored), want)
    assert (tmp_path / "step_00000002.corrupt").is_dir()
    with pytest.raises(CheckpointCorruptError):  # quarantined: unreadable
        fresh.restore_checkpoint(str(tmp_path), step=2)


def test_async_writer_snapshots_before_returning(tmp_path):
    """``submit`` copies the tree before it returns: changing the state
    in place afterwards does not reach the file. A failed write raises
    from the next ``wait``."""
    writer = ckpt.AsyncCheckpointWriter()
    t = torch.zeros(1000)
    a = np.zeros(10, np.float32)
    path = writer.submit(str(tmp_path), {"t": t, "a": a}, 5)
    t.add_(1.0)
    a += 1.0
    writer.wait()
    assert path.endswith("step_00000005")
    got, _ = ckpt.restore_checkpoint(str(tmp_path), {"t": t, "a": a})
    assert not got["t"].any() and not got["a"].any()
    (tmp_path / "file").write_text("")
    writer.submit(str(tmp_path / "file"), {"a": a}, 1)
    with pytest.raises(RuntimeError, match="background checkpoint write"):
        writer.wait()
    writer.wait()  # the error is reported once


def test_trainer_background_save(tmp_path):
    tt = _port_trainer()
    state = _port_steps(tt, tt.init_state(), _batches(1))
    want = tt.state_to_host(state)
    tt.save_checkpoint(str(tmp_path), state, background=True, keep_last=1)
    _port_steps(tt, state, _batches(1, seed=9))  # updates in place
    tt.wait_for_checkpoints()
    got, step = ckpt.restore_checkpoint(str(tmp_path), want)
    assert step == 1
    _assert_tree_equal(got, want)


def test_plan_json_round_trip():
    plan = ShardingPlan(strategy="x", mesh_axes=(("dp", 2), ("sp", 1)),
                        param_specs={"a": (P(), P(None, "dp"))},
                        opt_specs={"m": P(("dp", "ep"), None)})
    back = ShardingPlan.from_json(plan.to_json())
    assert back == plan and back.compatible_with(plan)
    other = ShardingPlan.from_json(plan.to_json().replace('"x"', '"y"'))
    assert not other.compatible_with(plan)
    with pytest.raises(ValueError, match="version"):
        ShardingPlan.from_json(json.dumps({"version": 2}))


# ---- the ladder's --ckpt-dir / --resume on the CPU --------------------------

@pytest.fixture
def smoke_env(monkeypatch):
    for name, value in (("TPU_DDP_SYNTH_SIZE", "64"),
                        ("TPU_DDP_GLOBAL_BATCH", "16"),
                        ("TPU_DDP_PALLAS_SGD", "1"),
                        ("TPU_DDP_PALLAS_BN", "1"),
                        ("TPU_DDP_CKPT_EVERY", "2")):
        monkeypatch.setenv(name, value)
    return monkeypatch


def _run(part, argv, monkeypatch, max_iters):
    from tpu_ddp_torch.parts import run_part
    monkeypatch.setenv("TPU_DDP_MAX_ITERS", str(max_iters))
    assert run_part(part, ["--device", "cpu", *argv]) == 0


def test_mid_epoch_resume_is_bit_identical(smoke_env, tmp_path, capsys):
    """Four iterations straight, against two iterations and two more
    resumed from the step-2 checkpoint in a fresh Trainer: the step-4
    checkpoints have the same digests (params, momentum, step)."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _run("part1", ["--ckpt-dir", a], smoke_env, 4)
    _run("part1", ["--ckpt-dir", b], smoke_env, 2)
    assert ckpt.all_steps(b) == [2]
    _run("part1", ["--ckpt-dir", b, "--resume"], smoke_env, 4)
    out = capsys.readouterr().out
    assert "[part1] resumed from" in out and "at step 2 (epoch 0, iter 2)" \
        in out
    assert _manifest(a, 4)["digests"] == _manifest(b, 4)["digests"]
    assert ckpt.all_steps(a) == ckpt.all_steps(b) == [2, 4]


def test_resume_at_an_epoch_boundary(smoke_env, tmp_path, capsys):
    """Two epochs of three iterations straight, against one epoch and the
    second resumed from the epoch-end checkpoint (the cadence of 2 does
    not hit step 3, so the epoch end writes it)."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _run("part1", ["--ckpt-dir", a, "--epochs", "2"], smoke_env, 3)
    _run("part1", ["--ckpt-dir", b, "--epochs", "1"], smoke_env, 3)
    out = capsys.readouterr().out
    assert f"[part1] checkpoint saved: {b}/step_00000003" in out
    _run("part1", ["--ckpt-dir", b, "--epochs", "2", "--resume"],
         smoke_env, 3)
    assert "at step 3 (epoch 1, iter 0)" in capsys.readouterr().out
    assert _manifest(a, 6)["digests"] == _manifest(b, 6)["digests"]
    assert ckpt.all_steps(a) == ckpt.all_steps(b) == [2, 3, 4, 6]


def test_lm_cli_refuses_a_checkpoint_directory(tmp_path):
    """The LM CLI has no checkpoints (nor has the JAX one): the flag the
    shared parser accepts is refused, not ignored."""
    from tpu_ddp_torch.examples.lm_train import main
    with pytest.raises(NotImplementedError, match="LMTrainer.save_"):
        main(["--num-nodes", "1", "--device", "cpu", "--ckpt-dir",
              str(tmp_path)])
