"""ZeRO-1 (part 4) and FSDP (part 5) of the port (tpu_ddp_torch/parallel/
zero.py, train/engine.py) held to the JAX package's.

- The flat layout: each rank's shard of each leaf is the JAX
  ``_FlatLayout``'s bytes at N = 2, 3 and 4, padding tail included, and
  canonical leaves round-trip through it exactly.
- Parts 4 and 5 as 2-process gloo runs (tests/torch_ranks.py) against the
  JAX ``Trainer`` (``zero``, ``fsdp``) on a 2-device mesh fed the ranks'
  batches: per-rank losses and final params and momentum within the
  ladder's RTOL/ATOL (f32 on both sides, only the order of summation
  differs; tests/test_torch_train.py states the margin).
- Checkpoints hold canonical shapes across layouts: zero -> fused, fsdp
  at dp 4 -> dp 2 and -> replicated, and a JAX checkpoint into the port
  and the port's back into JAX, all exact (the port's plan file is the
  JAX trainer's layout: no cross-layout warning).
- The padding tail of the flat shards stays zero through training.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ranks import (TINY, jax_trainer, make_inputs, run_jax,
                         run_vgg, state_keys)
from tpu_ddp.models.vgg import VGGModel as JaxVGG
from tpu_ddp.ops.optim import SGD as JaxSGD
from tpu_ddp.parallel.mesh import DATA_AXIS
from tpu_ddp.parallel.zero import ZeRO1 as JaxZeRO1
from tpu_ddp_torch.convert import CanonicalView
from tpu_ddp_torch.models.vgg import VGGModel
from tpu_ddp_torch.parallel.zero import ZeRO1, ZeRO3, _FlatLayout

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(tmp_path_factory.mktemp("zero"), world=2)


def _jax_params():
    jm = JaxVGG(name="tiny", cfg=TINY, compute_dtype=jnp.float32)
    return jax.tree.map(np.asarray, jm.init(jax.random.key(89395)))


def test_canonical_order_is_jax_flatten_order():
    canon = CanonicalView(VGGModel("tiny", TINY))
    params = _jax_params()
    leaves = jax.tree.leaves(params)
    assert [tuple(a.shape) for a in leaves] == canon.shapes
    got = canon.from_tree(params)
    assert all(a is b or np.array_equal(a, b) for a, b in zip(got, leaves))
    back = canon.tree(got)
    assert jax.tree.structure(back) == jax.tree.structure(params)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_flat_layout_shards_are_jax_bytes(n):
    params = _jax_params()
    leaves = jax.tree.leaves(params)
    jz = JaxZeRO1(JaxSGD(), DATA_AXIS, n, template=params)
    jflat = jax.tree.leaves(jz.shard_params(params))
    shapes = CanonicalView(VGGModel("tiny", TINY)).shapes
    for r in range(n):
        lay = _FlatLayout(shapes, axis_size=n, rank=r)
        flat = lay.shard_params(leaves)
        for a, b in zip(flat, jflat):
            np.testing.assert_array_equal(a, b)
        local = lay.local_host(flat)
        assert local.shape == (lay.total_chunk,)
        # The device path (no collective) cuts the same shards.
        buf, views = lay.local_shards([torch.tensor(a) for a in leaves])
        np.testing.assert_array_equal(buf.numpy(), local)
        for v, jf, c in zip(views, jflat, lay.chunks):
            np.testing.assert_array_equal(v.numpy(), jf[r * c:(r + 1) * c])


@pytest.mark.parametrize("n", [1, 3, 4])
def test_canonical_round_trip(n):
    rng = np.random.default_rng(n)
    shapes = [(3, 3, 3, 8), (10,), (7, 5), (1,), (13,)]
    leaves = [rng.normal(size=s).astype(np.float32) for s in shapes]
    lay = _FlatLayout(shapes, axis_size=n)
    flat = lay.shard_params(leaves)
    for a, s, c in zip(flat, lay.sizes, lay.chunks):
        assert a.shape == (c * n,) and not np.any(a[s:])
    for a, b, c in zip(lay.unshard_host(flat), leaves,
                       lay.canonicalize_opt_host(lay.flatten_opt(leaves))):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, b)
    # Device side: the rows a reduce-scatter sends and their inverse.
    rows = lay.rows([torch.from_numpy(a) for a in leaves])
    for a, b in zip(lay.leaves_of_rows(rows), leaves):
        np.testing.assert_array_equal(a.numpy(), b)


def test_without_a_group_the_layout_is_the_identity():
    """N = 1 (no process group): ZeRO-1 is the plain SGD update, FSDP's
    gather the identity and its gradient the plain one."""
    from tpu_ddp_torch.ops.optim import SGD
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,)]
    p = [torch.tensor(rng.normal(size=s), dtype=torch.float32)
         for s in shapes]
    g = [torch.tensor(rng.normal(size=s), dtype=torch.float32)
         for s in shapes]
    z = ZeRO1(SGD(), shapes)
    new = z.apply([t.clone() for t in p], g, z.init("cpu"))
    ref = [t.clone() for t in p]
    SGD().apply(ref, g, SGD().init(ref))
    for a, b in zip(new, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    z3 = ZeRO3(SGD(), shapes)
    buf = z3.local_shards(p)[0].requires_grad_(True)
    full = z3.gather_params(buf)
    sum((f * t).sum() for f, t in zip(full, g)).backward()
    np.testing.assert_array_equal(buf.grad.numpy(),
                                  torch.cat([t.reshape(-1) for t in g]))


def test_unported_wrappers_raise_naming_their_items():
    """Adafactor on the flat layouts is a permanent refusal pointing to
    the row-sharded FactoredZeRO1. The model-parallel partition builds
    now, and its global layout is the JAX wrapper's, cell by cell; a
    pipeline-axis spec partitions per stage cell as JAX's does, and
    JAX's refusals hold (a dim over two axes, a leaf over dp itself)."""
    from jax.sharding import PartitionSpec as JP

    from tpu_ddp.parallel.zero import ZeRO3 as JaxZeRO3
    from tpu_ddp_torch.ops.optim import SGD, Adafactor
    from tpu_ddp_torch.parallel.redistribute import P
    from tpu_ddp_torch.parallel.zero import FactoredZeRO1
    sizes = {"dp": 3, "sp": 1, "mp": 2, "pp": 2, "ep": 2}
    shapes = [(4, 6), (6,), (2, 5, 4)]
    specs = [P("mp", None), P(), P("ep", None, "mp")]
    rng = np.random.default_rng(0)
    leaves = [rng.normal(size=s).astype(np.float32) for s in shapes]
    template = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    for cls, jcls in ((ZeRO1, JaxZeRO1), (ZeRO3, JaxZeRO3)):
        with pytest.raises(ValueError, match="FactoredZeRO1"):
            cls(Adafactor(), [(4, 4)])
        assert cls(SGD(), shapes, param_specs=specs,
                   mesh_axis_sizes=sizes).shapes == [(2, 6), (6,), (1, 5, 2)]
        lay = _FlatLayout(shapes, axis_size=3, rank=1, param_specs=specs,
                          mesh_axis_sizes=sizes)
        assert lay.shapes == [(2, 6), (6,), (1, 5, 2)]
        jlay = jcls(JaxSGD(learning_rate=0.1), DATA_AXIS, 3,
                    template=template,
                    param_specs=[JP(*s) for s in specs],
                    mesh_axis_sizes=sizes)
        flats = lay.shard_params(leaves)
        for got, want in zip(flats, jlay.shard_params(leaves)):
            np.testing.assert_array_equal(got, np.asarray(want))
        for got, want in zip(lay.unshard_host(flats), leaves):
            np.testing.assert_array_equal(got, want)
        pp_lay = _FlatLayout([(4, 4)], axis_size=3, rank=1,
                             param_specs=[P("pp", None)],
                             mesh_axis_sizes=sizes)
        assert pp_lay.shapes == [(2, 4)]
        pp_jlay = jcls(JaxSGD(learning_rate=0.1), DATA_AXIS, 3,
                       template=[jax.ShapeDtypeStruct((4, 4),
                                                      jnp.float32)],
                       param_specs=[JP("pp", None)], mesh_axis_sizes=sizes)
        np.testing.assert_array_equal(
            pp_lay.shard_params([leaves[0][:, :4]])[0],
            np.asarray(pp_jlay.shard_params([leaves[0][:, :4]])[0]))
        for spec, words in ((P(("mp", "ep"), None), "one mesh axis"),
                            (P("dp", None), "own axis")):
            with pytest.raises(NotImplementedError, match=words):
                cls(SGD(), [(4, 4)], param_specs=[spec],
                    mesh_axis_sizes=sizes)
    assert FactoredZeRO1(Adafactor(), [(4, 4)], param_specs=[P("pp", None)],
                         mesh_axis_sizes=sizes).shapes == [(2, 4)]


def _assert_state(got, want, rtol=RTOL, atol=ATOL, prefixes=("params",
                  "opt_state")):
    for pre in prefixes:
        keys = state_keys(want, pre)
        assert keys and keys == state_keys(got, pre)
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                       atol=atol, err_msg=k)


@pytest.mark.parametrize("part,strategy", [("part4", "zero"),
                                           ("part5", "fsdp")])
def test_part_matches_jax_trainer(part, strategy, inputs, tmp_path):
    params, x, y, init, data = inputs
    ranks = run_vgg(tmp_path, part, 2, init=init, data=data,
                    every_rank=True)
    want = run_jax(strategy, 2, params, x, y)
    np.testing.assert_allclose(
        np.stack([r["losses"] for r in ranks], axis=1), want["losses"],
        rtol=RTOL, atol=ATOL)
    for r in ranks:
        _assert_state(r, want)
    # Every rank ends with the same canonical state.
    for k in state_keys(ranks[0], "params"):
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])


def test_part4_on_a_second_family_matches_jax(tmp_path, monkeypatch):
    """ZeRO-1 over the shallow ResNet (one bottleneck per stage at the
    full widths; 161-leaf ResNet-50's family) at 2 gloo processes against
    the JAX ``zero`` trainer on a 2-device mesh: the canonical view built
    from the model carries a second family's flat shards, so losses and
    the final params and momentum match within RTOL/ATOL, and the flat
    shards are the JAX layout's bytes. At lr 1e-3 (tests/test_torch_train.py
    says why). Each rank's ReLUs take the derivatives the JAX run's took
    on its device (tests/relu_sites.py): where a pre-activation lies
    within f32 noise of 0 the two packages may decide it differently, and
    the momentum, the raw gradient sum, would part by up to 2% there. At
    64 px, so the last stage's BatchNorm has 16 rows per channel on each
    rank (at 32 px it has 4, and magnifies the packages' f32 noise in the
    head's momentum to 3e-5; tests/test_torch_resnet.py)."""
    from relu_sites import BAND, record_jax_relus
    from torch_ranks import jax_model
    from tpu_ddp_torch.models.resnet import ResNetModel
    params, x, y, init, data = make_inputs(tmp_path / "in", world=2,
                                           batch=4, seed=3, model="resnet",
                                           size=64)
    cfg = {"learning_rate": 1e-3}
    store = {}
    with monkeypatch.context() as patch:
        record_jax_relus(patch.setattr, store, axis=DATA_AXIS)
        want = run_jax("zero", 2, params, x, y, model="resnet", **cfg)
        jax.effects_barrier()
    n_sites = 1 + 3 * 4
    assert sorted(store) == [(s, d) for s in range(n_sites)
                             for d in range(2)]
    weights = tmp_path / "relu.npz"
    np.savez(weights, **{f"r{d}_{step * n_sites + s:05d}": store[s, d][step]
                         for s in range(n_sites) for d in range(2)
                         for step in range(x.shape[0])})
    ranks = run_vgg(tmp_path, "zero", 2, init=init, data=data, cfg=cfg,
                    every_rank=True, model="resnet", relu_weights=weights)
    for r in ranks:
        assert int(r["relu_sites"]) == n_sites * x.shape[0]
        assert float(r["relu_moved"]) < BAND
    np.testing.assert_allclose(
        np.stack([r["losses"] for r in ranks], axis=1), want["losses"],
        rtol=RTOL, atol=ATOL)
    for r in ranks:
        _assert_state(r, want)
    for k in state_keys(ranks[0], "opt_state"):
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
    shapes = CanonicalView(ResNetModel(
        "shallow", (1, 1, 1, 1), num_classes=10)).shapes
    leaves = jax.tree.leaves(params)
    assert [tuple(a.shape) for a in leaves] == shapes
    jz = JaxZeRO1(JaxSGD(), DATA_AXIS, 2, template=params)
    jflat = jax.tree.leaves(jz.shard_params(params))
    for a, b in zip(_FlatLayout(shapes, axis_size=2).shard_params(leaves),
                    jflat):
        np.testing.assert_array_equal(a, b)
    assert jax_model("resnet").use_pallas_bn


def test_checkpoints_cross_layouts(inputs, tmp_path):
    """fsdp at dp 4 -> fsdp at dp 2, zero at dp 2 and replicated (part 1
    at one process); zero -> fused: the canonical state restores exactly
    into every layout."""
    params, _, _, init, _ = inputs
    _, x4, y4, _, data4 = make_inputs(tmp_path / "in4", world=4, steps=1)
    ck = tmp_path / "ck_fsdp4"
    saved = run_vgg(tmp_path, "fsdp", 4, init=init, data=data4, save=ck,
                    shards=True, every_rank=True, tag="fsdp4")
    assert saved[0]["losses"].shape == (1,)
    for strategy, world in (("fsdp", 2), ("zero", 2), ("none", 1)):
        got = run_vgg(tmp_path, strategy, world, restore=ck,
                      tag=f"re-{strategy}{world}")
        _assert_state(got, saved[0], rtol=0, atol=0)
    ck2 = tmp_path / "ck_zero"
    z = run_vgg(tmp_path, "zero", 2, restore=ck, save=ck2, tag="zero-save")
    got = run_vgg(tmp_path, "fused", 2, restore=ck2, tag="fused-restore")
    _assert_state(got, z, rtol=0, atol=0)
    # The padded tail of the last rank's shards stayed zero: the head
    # bias (10 entries) pads to 12 at N = 4.
    canon = CanonicalView(VGGModel("tiny", TINY))
    lay = _FlatLayout(canon.shapes, axis_size=4, rank=3)
    for name in ("shard/params", "shard/momentum"):
        buf = saved[3][name]
        for v, s, c in zip(lay.views(torch.from_numpy(buf)), lay.sizes,
                           lay.chunks):
            tail = v.numpy()[max(0, s - 3 * c):]
            assert not np.any(tail), name
    assert any(s % 4 for s in lay.sizes)


def test_jax_checkpoint_into_the_port_and_back(inputs, tmp_path):
    """A JAX ZeRO checkpoint restores into the port's FSDP at dp 2 with
    the JAX state's bytes; the port's checkpoint restores into JAX."""
    params, x, y, _, _ = inputs
    jt, jstate = jax_trainer("zero", 2, params)
    xb, yb, wb = jt.put_batch(x[0].reshape(-1, 32, 32, 3),
                              y[0].reshape(-1).astype(np.int32))
    jstate, _ = jt.train_step(jstate, xb, yb, wb)
    jdir = tmp_path / "jax_ck"
    jt.save_checkpoint(str(jdir), jstate)
    got = run_vgg(tmp_path, "fsdp", 2, restore=jdir, save=tmp_path / "pck",
                  tag="from-jax")
    want = jt.state_to_host(jstate)
    flat = {jax.tree_util.keystr(p, simple=True, separator="."):
            np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    _assert_state(got, flat, rtol=0, atol=0)
    jt2, _ = jax_trainer("fsdp", 2, params)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        back = jt2.state_to_host(jt2.restore_checkpoint(
            str(tmp_path / "pck")))
    # The port's plan file is the JAX FSDP trainer's own layout.
    assert not [w for w in rec if "restoring into" in str(w.message)]
    for a, b in zip(jax.tree.leaves(back["params"]),
                    jax.tree.leaves(want["params"])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(back["opt_state"]),
                    jax.tree.leaves(want["opt_state"])):
        np.testing.assert_array_equal(a, b)
