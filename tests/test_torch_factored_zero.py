"""Adafactor under ZeRO-1 (tpu_ddp_torch/parallel/zero.py
``FactoredZeRO1``, train/lm.py ``opt_sharding='zero1'``) held to the JAX
package's ``FactoredZeRO1`` and ``LMTrainer``.

- The wrapper at 2 and 4 gloo ranks (one subprocess run per world, 150 s
  limit, every case in it) against the JAX wrapper under ``shard_map`` on
  a 2- and a 4-device CPU mesh, fed the same per-rank gradients (the
  cases of tests/test_adafactor.py ``TestFactoredZeRO1``, with a leaf
  whose rows do not divide by the world): parameters and the canonical
  state within rtol 2e-5 / atol 1e-6 after one step (``b1`` None and
  0.9, relative and fixed lr) and after two; ``vr`` and ``mu`` held 1/N
  by rows; the host conversions equal to JAX's.
- ``python -m tpu_ddp_torch.examples.lm_train`` with
  ``TPU_DDP_LM_OPT=adafactor TPU_DDP_LM_OPT_SHARD=zero1`` on 2 gloo
  ranks against the JAX ``LMTrainer(opt_sharding='zero1')`` with
  Adafactor on a 2-device mesh: each printed loss within 1.5e-4
  (tests/test_torch_lm_zero.py's bound; the CLI prints four decimals).
- At one process the zero1 trainer is the replicated one bit for bit
  (every mean in Adafactor is a sum over the group, then a division),
  and checkpoints move replicated <-> zero1 and between the packages.
"""

import json
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_adafactor import _sharded_adafactor_step
from test_torch_lm import SEQ, _models, _run_cli
from torch_ranks import free_port, run_ranks
from tpu_ddp.ops.optim import Adafactor as JaxAdafactor
from tpu_ddp.parallel.mesh import DATA_AXIS, make_mesh
from tpu_ddp.parallel.zero import FactoredZeRO1 as JaxFactoredZeRO1
from tpu_ddp.train.lm import LMTrainer as JaxLMTrainer
from tpu_ddp_torch.convert import params_to_jax
from tpu_ddp_torch.ops.optim import Adafactor
from tpu_ddp_torch.parallel.redistribute import ShardingPlan
from tpu_ddp_torch.parallel.zero import FactoredZeRO1, ZeRO1, ZeRO3
from tpu_ddp_torch.train.lm import LMTrainer, make_lm_batch

# Leaves in the JAX tree's (sorted) order: a flat vector, a batch-plan
# stack, a 2-D matrix, rows that no world of 4 divides, a split plan.
SHAPES = {"b": (10,), "odd": (10, 12), "stack": (3, 16, 8),
          "w": (24, 16), "wqkv": (16, 3, 2, 4)}
KEYS = sorted(SHAPES)
CASES = {
    "plain": dict(opt=dict(min_dim_size_to_factor=8, weight_decay=0.01),
                  steps=1),
    "b1_lr": dict(opt=dict(min_dim_size_to_factor=8, b1=0.9,
                           learning_rate=1e-2, weight_decay=0.01),
                  steps=1),
    "two_steps": dict(opt=dict(min_dim_size_to_factor=8), steps=2),
}
TOL = dict(rtol=2e-5, atol=1e-6)

WORKER = r"""
import json, os, sys
import numpy as np
import torch
from tpu_ddp_torch.ops.optim import Adafactor
from tpu_ddp_torch.parallel.bootstrap import init_distributed_setup
from tpu_ddp_torch.parallel.zero import FactoredZeRO1

torch.set_num_threads(1)
spec = json.loads(sys.argv[1])
rank, world = int(sys.argv[2]), spec["world"]
init_distributed_setup("127.0.0.1", spec["port"], rank, world,
                       device="cpu", ddp=True, timeout_s=90)
d = np.load(spec["data"])
out = {}
for case, kw in spec["cases"].items():
    params = [torch.from_numpy(d[f"p/{k}"].copy()) for k in spec["keys"]]
    z = FactoredZeRO1(Adafactor(**kw["opt"]), [p.shape for p in params],
                      torch.distributed.group.WORLD)
    state = z.init("cpu")
    for step in range(kw["steps"]):
        grads = [torch.from_numpy(d[f"g{step}/{rank}/{k}"])
                 for k in spec["keys"]]
        params = [t.clone() for t in z.apply(params, grads, state)]
    full = z.full_opt(state)
    for i, k in enumerate(spec["keys"]):
        out[f"{case}/p/{k}"] = params[i].numpy()
        for slot in ("vr", "vc", "v", "mu"):
            out[f"{case}/{slot}/{k}"] = full[slot][i].numpy()
            out[f"{case}/local_{slot}/{k}"] = state[slot][i].numpy()
np.savez(spec["out"] + f".{rank}.npz", **out)
torch.distributed.barrier()
sys.stdout.flush()
os._exit(0)
"""


def _params():
    rng = np.random.default_rng(11)
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(world, steps=2):
    """``[step][rank]`` gradient dicts."""
    rng = np.random.default_rng(23)
    return [[{k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(world)]
            for _ in range(steps)]


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks_run(request, tmp_path_factory):
    """One gloo run per world: every case's per-rank record."""
    world = request.param
    path = tmp_path_factory.mktemp(f"fz{world}")
    params, grads = _params(), _grads(world)
    arrays = {f"p/{k}": v for k, v in params.items()}
    for s, per_rank in enumerate(grads):
        for r, g in enumerate(per_rank):
            arrays.update({f"g{s}/{r}/{k}": v for k, v in g.items()})
    np.savez(path / "data.npz", **arrays)
    spec = {"world": world, "port": str(free_port()), "keys": KEYS,
            "data": str(path / "data.npz"), "out": str(path / "out"),
            "cases": CASES}
    torch_threads = torch.get_num_threads()
    run_ranks(lambda r: ["-c", WORKER, json.dumps(spec), str(r)], world)
    torch.set_num_threads(torch_threads)
    recs = []
    for r in range(world):
        with np.load(f"{path}/out.{r}.npz") as f:
            recs.append({k: f[k] for k in f.files})
    return world, params, grads, recs


def _jax_run(world, params, grads, case):
    """The JAX wrapper under shard_map on ``world`` CPU devices:
    (params, canonical state, global state, wrapper)."""
    opt = JaxAdafactor(**CASES[case]["opt"])
    mesh = make_mesh(jax.devices()[:world], dp=world)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    wrapper = JaxFactoredZeRO1(opt, axis_size=world, template=p)
    state = wrapper.init(p)
    for step in range(CASES[case]["steps"]):
        per_worker = [{k: jnp.asarray(v) for k, v in g.items()}
                      for g in grads[step]]
        p, state = _sharded_adafactor_step(mesh, wrapper, p, per_worker,
                                           state)
    host = jax.device_get(state)
    return (jax.device_get(p), wrapper.canonicalize_opt_host(host), host,
            wrapper)


@pytest.mark.parametrize("case", ["plain", "b1_lr"])
def test_matches_the_jax_wrapper(ranks_run, case):
    """One step: parameters (identical on every rank) and the canonical
    vr, vc, v and mu against the JAX wrapper's."""
    world, params, grads, recs = ranks_run
    jp, jcanon, _, _ = _jax_run(world, params, grads, case)
    for k in KEYS:
        for r in range(world):
            np.testing.assert_array_equal(recs[r][f"{case}/p/{k}"],
                                          recs[0][f"{case}/p/{k}"])
        np.testing.assert_allclose(recs[0][f"{case}/p/{k}"], jp[k],
                                   err_msg=f"param {k}", **TOL)
        for slot in ("vr", "vc", "v", "mu"):
            np.testing.assert_allclose(
                recs[0][f"{case}/{slot}/{k}"],
                np.asarray(jcanon[slot][k], np.float32),
                err_msg=f"{slot}/{k}", **TOL)


def test_two_steps_stay_exact(ranks_run):
    """Factored statistics accumulate: the second step catches drift the
    zero-initialised first step hides."""
    world, params, grads, recs = ranks_run
    jp, jcanon, _, _ = _jax_run(world, params, grads, "two_steps")
    for k in KEYS:
        np.testing.assert_allclose(recs[0][f"two_steps/p/{k}"], jp[k],
                                   err_msg=f"param {k}", **TOL)
        for slot in ("vr", "vc"):
            np.testing.assert_allclose(recs[0][f"two_steps/{slot}/{k}"],
                                       jcanon[slot][k],
                                       err_msg=f"{slot}/{k}", **TOL)


def test_state_is_sharded_1_over_n(ranks_run):
    """The memory claim: each rank holds vr and mu by rows (n_loc of
    them), vc whole, flat leaves' v and mu as chunks, and the local
    blocks are the rank's rows of JAX's global state; the per-leaf
    specs are the JAX wrapper's."""
    world, params, grads, recs = ranks_run
    _, _, jglobal, jw = _jax_run(world, params, grads, "b1_lr")
    port = FactoredZeRO1(Adafactor(**CASES["b1_lr"]["opt"]),
                         [SHAPES[k] for k in KEYS], axis_size=world, rank=0)
    jspecs = jw.state_specs()
    pspecs = port.state_specs()
    for i, k in enumerate(KEYS):
        geom = port.geoms[i]
        for slot in ("vr", "vc", "v", "mu"):
            assert tuple(pspecs[slot][i]) == tuple(jspecs[slot][k]), (
                slot, k)
            g = np.asarray(jglobal[slot][k])
            for r in range(world):
                loc = recs[r][f"b1_lr/local_{slot}/{k}"]
                if tuple(jspecs[slot][k]) == ():
                    np.testing.assert_allclose(loc, g, **TOL)
                    continue
                # Sharded along the spec's "dp" axis: rank r's block.
                ax = list(jspecs[slot][k]).index(DATA_AXIS)
                blk = g.shape[ax] // world
                want = np.take(g, range(r * blk, (r + 1) * blk), axis=ax)
                np.testing.assert_allclose(loc, want, **TOL)
        if geom is not None:
            lead, n, m, n_loc = geom
            assert n_loc == -(-n // world)
            assert recs[0][f"b1_lr/local_vr/{k}"].shape == lead + (n_loc,)
            assert recs[0][f"b1_lr/local_mu/{k}"].shape == lead + (n_loc, m)


def test_canonicalize_flatten_roundtrip(ranks_run):
    """The host conversions: canonical -> global -> canonical is the
    identity, and the global layout is the JAX wrapper's bytes."""
    world = ranks_run[0]
    opt = dict(min_dim_size_to_factor=8, b1=0.9)
    params = _params()
    jw = JaxFactoredZeRO1(JaxAdafactor(**opt), axis_size=world,
                          template={k: jnp.asarray(v)
                                    for k, v in params.items()})
    port = FactoredZeRO1(Adafactor(**opt), [SHAPES[k] for k in KEYS],
                         axis_size=world, rank=0)
    rng = np.random.default_rng(4)
    tmpl = port.canonical_opt_template()
    canon = {slot: [rng.normal(size=s).astype(np.float32)
                    for s in tmpl[slot]] for slot in tmpl}
    canon["count"] = np.int32(3)
    jcanon = {slot: dict(zip(KEYS, v)) for slot, v in canon.items()
              if slot != "count"}
    jcanon["count"] = canon["count"]
    glob = port.flatten_opt(canon)
    jglob = jw.flatten_opt(jcanon)
    back = port.canonicalize_opt_host(glob)
    for slot in ("vr", "vc", "v", "mu"):
        for i, k in enumerate(KEYS):
            np.testing.assert_array_equal(glob[slot][i], jglob[slot][k])
            np.testing.assert_array_equal(back[slot][i], canon[slot][i])
        # Canonical shapes are the replicated optimizer's.
        assert [tuple(np.shape(x)) for x in back[slot]] == [
            tuple(s) for s in tmpl[slot]]


def test_two_process_lm_zero1_adafactor_matches_jax_mesh():
    logs = _run_cli(2, {"TPU_DDP_LM_OPT": "adafactor",
                        "TPU_DDP_LM_OPT_SHARD": "zero1"})
    for r, log in enumerate(logs):
        assert (f"rank={r} world=2 dp=2 sp=1 tp=1 pp=1 fsdp=False "
                f"opt_shard=zero1 opt=adafactor") in log, log
    printed = [[float(v) for v in re.findall(
        r"\[lm_train\] step \d+/3 loss (\S+)", log)] for log in logs]
    assert [len(p) for p in printed] == [3, 3]
    jm, tm = _models()
    params = LMTrainer(tm, device="cpu").init_state(seed=0).params
    jparams = jax.tree.map(jnp.asarray, params_to_jax(params))
    jt = JaxLMTrainer(jm, make_mesh(jax.devices()[:2]),
                      optimizer=JaxAdafactor(min_dim_size_to_factor=8),
                      opt_sharding="zero1")
    assert isinstance(jt.optimizer, JaxFactoredZeRO1)
    jstate = jt._place_state(jparams, jt.optimizer.init(jparams))
    tokens = np.random.default_rng(1234).integers(0, 1024,
                                                  size=(8, SEQ + 1))
    x, y = jt.put_batch(*make_lm_batch(tokens))
    for step in range(3):
        jstate, loss = jt.train_step(jstate, x, y)
        want = np.asarray(loss).reshape(-1)
        for r in range(2):
            assert abs(printed[r][step] - want[r]) <= 1.5e-4, (
                step, r, printed[r][step], want[r])


def _lm_run(tm, opt_sharding, steps=3, **kw):
    tr = LMTrainer(tm, device="cpu", opt_sharding=opt_sharding,
                   optimizer=Adafactor(min_dim_size_to_factor=8, **kw))
    state = tr.init_state(seed=0)
    tokens = np.random.default_rng(5).integers(0, 1024, size=(4, SEQ + 1))
    x, y = tr.put_batch(*make_lm_batch(tokens))
    losses = []
    for _ in range(steps):
        state, loss = tr.train_step(state, x, y)
        losses.append(float(loss))
    return tr, state, losses, (x, y)


@pytest.mark.parametrize("kw", [{}, dict(b1=0.9, learning_rate=1e-2)],
                         ids=["relative", "b1_lr"])
def test_one_process_zero1_is_the_replicated_run_bit_for_bit(kw):
    _, tm = _models()
    rtr, rstate, rlosses, _ = _lm_run(tm, "replicated", **kw)
    ztr, zstate, zlosses, _ = _lm_run(tm, "zero1", **kw)
    assert isinstance(ztr.layout, FactoredZeRO1)
    assert zlosses == rlosses
    for a, b in zip(jax.tree.leaves(ztr.state_to_host(zstate)),
                    jax.tree.leaves(rtr.state_to_host(rstate))):
        np.testing.assert_array_equal(a, b)


def test_checkpoints_move_between_replicated_and_zero1(tmp_path):
    """zero1 -> replicated and replicated -> zero1 restore the same
    canonical state (a warning says the move crossed layouts), and the
    next step agrees bit for bit."""
    _, tm = _models()
    for src, dst in (("zero1", "replicated"), ("replicated", "zero1")):
        tr, state, _, (x, y) = _lm_run(tm, src, steps=2)
        d = str(tmp_path / f"{src}_to_{dst}")
        tr.save_checkpoint(d, state)
        want = tr.state_to_host(state)
        other = LMTrainer(tm, device="cpu", opt_sharding=dst,
                          optimizer=Adafactor(min_dim_size_to_factor=8))
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            got_state = other.restore_checkpoint(d)
        assert any("restoring into" in str(w.message) for w in rec)
        for a, b in zip(jax.tree.leaves(other.state_to_host(got_state)),
                        jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)
        _, la = tr.train_step(state, x, y)
        _, lb = other.train_step(got_state, x, y)
        assert float(la) == float(lb)


def test_zero1_checkpoints_cross_the_packages(tmp_path):
    """A JAX ``LMTrainer(opt_sharding='zero1')`` save (dp 1) restores in
    the port's zero1 trainer bit for bit and the port's save in JAX's,
    with equal plan files."""
    jm, tm = _models()
    tr, state, _, (x, y) = _lm_run(tm, "zero1", steps=2, b1=0.9)
    tr.save_checkpoint(str(tmp_path / "port"), state)
    jt = JaxLMTrainer(jm, make_mesh(jax.devices()[:1]),
                      optimizer=JaxAdafactor(min_dim_size_to_factor=8,
                                             b1=0.9),
                      opt_sharding="zero1")
    js = jt.restore_checkpoint(str(tmp_path / "port"))
    assert (ShardingPlan.load(str(tmp_path / "port"))
            == tr.sharding_plan())
    jt.save_checkpoint(str(tmp_path / "jax"), js)
    assert (tmp_path / "port" / "sharding_plan.json").read_text() == (
        tmp_path / "jax" / "sharding_plan.json").read_text()
    back = tr.restore_checkpoint(str(tmp_path / "jax"))
    for a, b in zip(jax.tree.leaves(tr.state_to_host(back)),
                    jax.tree.leaves(tr.state_to_host(state))):
        np.testing.assert_array_equal(a, b)
    # The JAX side's canonical state is the port's too.
    jcanon = jt.optimizer.canonicalize_opt_host(
        jax.device_get(js.opt_state))
    host = tr.state_to_host(state)["opt_state"]
    for slot in ("vr", "vc", "v", "mu"):
        for a, b in zip(jax.tree.leaves(jcanon[slot]),
                        jax.tree.leaves(host[slot])):
            np.testing.assert_array_equal(np.asarray(a, np.float32), b)


@pytest.mark.parametrize("kw,words", [
    (dict(opt_sharding="zero2"), "does not compose"),
    (dict(param_sharding="fsdp"), "re-lays leaves out flat"),
    (dict(opt_sharding="zero1", clip_grad_norm=1.0),
     "already clips by update RMS")])
def test_adafactor_refusals_are_the_jax_trainers(kw, words):
    """Permanent refusals, raised as ValueError in the JAX trainer's
    words (tpu_ddp/train/lm.py:493-505, :1040-1047)."""
    _, tm = _models()
    with pytest.raises(ValueError, match=words):
        LMTrainer(tm, device="cpu", optimizer=Adafactor(), **kw)


def test_flat_layouts_refuse_adafactor():
    for cls in (ZeRO1, ZeRO3):
        with pytest.raises(ValueError, match="FactoredZeRO1"):
            cls(Adafactor(), [(4, 4)])
    with pytest.raises(ValueError, match="factored optimizers"):
        FactoredZeRO1(object(), [(4, 4)])
    # The per-cell layout builds (each cell factors its own slice, JAX's
    # global layout: leading cell axes), over a pipeline axis too.
    from jax.sharding import PartitionSpec as JP

    from tpu_ddp_torch.parallel.redistribute import P
    sizes = {"dp": 2, "mp": 2, "pp": 2}
    shapes, specs = [(16, 12), (12,)], [P("mp", None), P()]
    opt = Adafactor(min_dim_size_to_factor=4)
    lay = FactoredZeRO1(opt, shapes, param_specs=specs,
                        mesh_axis_sizes=sizes, axis_size=2)
    jlay = JaxFactoredZeRO1(
        JaxAdafactor(min_dim_size_to_factor=4), DATA_AXIS, 2,
        template=[jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes],
        param_specs=[JP(*s) for s in specs], mesh_axis_sizes=sizes)
    want = jlay.canonical_opt_template(None)
    got = lay.canonical_opt_template()
    for k in ("vr", "vc", "v", "mu"):
        assert [tuple(x.shape) for x in want[k]] == got[k], k
    shapes, specs = [(16, 12), (4, 12)], [P("pp", None), P("pp", None)]
    lay = FactoredZeRO1(opt, shapes, param_specs=specs,
                        mesh_axis_sizes=sizes, axis_size=2)
    jlay = JaxFactoredZeRO1(
        JaxAdafactor(min_dim_size_to_factor=4), DATA_AXIS, 2,
        template=[jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes],
        param_specs=[JP(*s) for s in specs], mesh_axis_sizes=sizes)
    want = jlay.canonical_opt_template(None)
    got = lay.canonical_opt_template()
    for k in ("vr", "vc", "v", "mu"):
        assert [tuple(x.shape) for x in want[k]] == got[k], k
