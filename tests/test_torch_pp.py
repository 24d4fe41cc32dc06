"""Pipeline parallelism in the port (tpu_ddp_torch/parallel/pipeline.py,
``PipelineLMTrainer``) with every stage in this process
(``stages="in_process"``), held to the JAX package's pipeline
(tpu_ddp/parallel/pipeline.py, ``PipelineLMTrainer`` on the virtual CPU
devices) from the same seed-7 parameters and numpy-seeded tokens, f32.

The model is JAX's pipeline test model (tests/test_pipeline.py:18-21:
TransformerLM-tiny at 4 layers, max_seq_len 32) and the tolerances are
its (tests/test_pipeline.py:94-101): the loss within 1e-4, the parameters
after one SGD step within rtol 3e-4, atol 3e-5. The JAX steps (about 6 s
of compile each) run once per module. Adafactor with the stages in one
process runs per stage cell, held to JAX's ``CellAdafactor`` on a dp 1
x pp 2 mesh at the same tolerances.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.models import make_transformer as jax_make
from tpu_ddp.ops.optim import SGD as JaxSGD
from tpu_ddp.ops.optim import Adafactor as JaxAdafactor
from tpu_ddp.ops.optim import AdamW as JaxAdamW
from tpu_ddp.parallel import pipeline as jpipe
from tpu_ddp.parallel.mesh import make_mesh
from tpu_ddp.train.lm import PipelineLMTrainer as JaxPipe
from tpu_ddp_torch.convert import (dense_from_stacked, params_to_jax,
                                   stacked_from_dense)
from tpu_ddp_torch.models import transformer as tmod
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.ops.optim import SGD, Adafactor, AdamW
from tpu_ddp_torch.parallel import bootstrap
from tpu_ddp_torch.parallel import pipeline as pipe
from tpu_ddp_torch.train.lm import (LMTrainer, PipelineLMTrainer,
                                   data_shard_index, make_lm_batch)
from tpu_ddp_torch.utils.tree import keyed_leaves, tree_leaves, tree_unflatten

LOSS_ATOL = 1e-4
STEP_TOL = dict(rtol=3e-4, atol=3e-5)
LAYERS = 4
# JAX cells (pp, num_micro, schedule, pp_virtual): one per schedule and
# JAX's "M < pp: drains correctly" cell.
CELLS = {
    "1f1b": (2, 4, "1f1b", 1),
    "gpipe": (2, 2, "gpipe", 1),
    "interleaved": (2, 4, "interleaved", 2),
    "zerobubble": (2, 4, "zerobubble", 1),
    "m_below_pp": (2, 1, "1f1b", 1),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(**kw):
    return make_transformer("TransformerLM-tiny", max_seq_len=32,
                            compute_dtype=torch.float32, num_layers=LAYERS,
                            **kw)


def _jax_model(**kw):
    return jax_make("TransformerLM-tiny", max_seq_len=32,
                    compute_dtype=jnp.float32, num_layers=LAYERS, **kw)


def _tokens(b=4, L=33, seed=5):
    return np.random.default_rng(seed).integers(0, 1024, size=(b, L))


def _sgd():
    return SGD(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)


def _dense_params():
    """The port's seed-7 parameters (the dense tree, numpy)."""
    return params_to_jax(_model().init(torch.Generator().manual_seed(7)))


def _port(schedule="1f1b", pp=2, micro=4, virtual=1, optimizer=None,
          **kw):
    model = _model(**kw.pop("model", {}))
    return PipelineLMTrainer(model, device="cpu",
                             optimizer=optimizer or _sgd(),
                             schedule=schedule, pp=pp, num_micro=micro,
                             pp_virtual=virtual, stages="in_process", **kw)


def _port_step(tr, steps=1, tokens=None):
    """(losses, the canonical dense parameters as numpy) after ``steps``
    steps from the seed-7 parameters."""
    state = tr.init_state(seed=7)
    x, y = tr.put_batch(*make_lm_batch(_tokens() if tokens is None
                                       else tokens))
    losses = []
    for _ in range(steps):
        state, loss = tr.train_step(state, x, y)
        losses.append(float(loss))
    host = tr.params_to_host(state)
    return losses, dense_from_stacked(host, LAYERS)


@pytest.fixture(scope="module")
def jax_cells():
    """Each JAX cell's (loss, dense params) after one SGD step from the
    port's seed-7 parameters: JAX's PipelineLMTrainer on pp virtual
    devices."""
    out = {}
    for name, (pp, micro, schedule, virtual) in CELLS.items():
        # Fresh arrays per cell: the step donates its state's buffers.
        dense = jax.tree.map(jnp.asarray, _dense_params())
        mesh = make_mesh(jax.devices()[:pp], dp=1, sp=1, mp=1, pp=pp)
        tr = JaxPipe(_jax_model(), mesh, num_micro=micro,
                     optimizer=JaxSGD(learning_rate=0.1, momentum=0.9,
                                      weight_decay=1e-4),
                     schedule=schedule, pp_virtual=virtual)
        params = jpipe.stack_block_params(dense)
        if virtual > 1:
            params = jpipe.permute_stacked_blocks(
                params, jpipe.interleave_permutation(LAYERS, pp, virtual))
        state = tr._place_state(params, tr.optimizer.init(params))
        x, y = tr.put_batch(*make_lm_batch(_tokens()))
        state, loss = tr.train_step(state, x, y)
        host = tr.canonical_params(jax.device_get(state.params))
        out[name] = (float(np.mean(np.asarray(loss))),
                     jpipe.unstack_block_params(host, LAYERS))
    return out


# ---- layout ---------------------------------------------------------------


@pytest.mark.parametrize("dp,sp,tp,pp,ep", [
    (1, 1, 1, 2, 1), (2, 1, 1, 2, 1), (1, 1, 2, 2, 1), (1, 2, 1, 2, 1),
    (1, 1, 1, 2, 2), (1, 1, 1, 4, 1), (2, 1, 2, 2, 1)])
def test_rank_layout_matches_jax_make_mesh(dp, sp, tp, pp, ep):
    """rank = (((d * sp + s) * tp + t) * pp + p) * ep + e, JAX's
    make_mesh(dp, sp, mp, pp, ep) order; coords and stage invert it."""
    mesh = make_mesh(jax.devices()[:dp * sp * tp * pp * ep], dp=dp, sp=sp,
                     mp=tp, pp=pp, ep=ep)
    for (d, s, t, p, e), dev in np.ndenumerate(mesh.devices):
        rank = dev.id
        assert bootstrap.mesh_rank(d, s, e, sp, ep, t, tp, p, pp) == rank
        assert bootstrap.mesh_coords(rank, sp, ep, tp, pp) == (d, s, e, t)
        assert bootstrap.mesh_stage(rank, ep, pp) == p


@pytest.mark.parametrize("dp,sp,tp,ep", [
    (4, 1, 1, 1), (2, 1, 2, 1), (2, 2, 1, 1), (2, 1, 1, 2)])
def test_in_process_rank_layout_is_jax_make_mesh_without_pp(dp, sp, tp,
                                                            ep):
    """In-process stages: the world is dp x sp x tp x ep, a process's
    rank JAX's make_mesh(dp, sp, mp, pp, ep) order with p dropped; its
    coordinates and data shard are those of every JAX device of its
    pipeline, and the ranks sort as those devices do."""
    mesh = make_mesh(jax.devices()[:dp * sp * tp * 2 * ep], dp=dp, sp=sp,
                     mp=tp, pp=2, ep=ep)
    order = []
    for (d, s, t, p, e), dev in np.ndenumerate(mesh.devices):
        rank = bootstrap.mesh_rank(d, s, e, sp, ep, t, tp)
        assert bootstrap.mesh_coords(rank, sp, ep, tp) == (d, s, e, t)
        assert bootstrap.mesh_stage(rank, ep) == 0
        assert data_shard_index(rank, sp, ep, tp) == (d * sp + s) * ep + e
        if p == 0:
            order.append((dev.id, rank))
    assert [r for _, r in sorted(order)] == list(range(dp * sp * tp * ep))


@pytest.mark.parametrize("dp,sp,tp,pp,ep", [
    (2, 2, 2, 1, 1), (2, 1, 1, 1, 2), (2, 1, 2, 2, 1), (1, 2, 1, 2, 2)])
def test_mesh_groups_per_stage(monkeypatch, dp, sp, tp, pp, ep):
    """Every process makes every group in one order; at pp 1 the calls
    are the tp slice's (no pp group, no new data group at tp 1); at pp >
    1 each data-side group holds one stage and the pp groups one (d, s,
    t, e)."""
    import torch.distributed as dist
    made = []
    world = dp * sp * tp * pp * ep
    monkeypatch.setattr(dist, "get_world_size", lambda *a: world)
    monkeypatch.setattr(dist, "get_rank", lambda *a: 0)
    monkeypatch.setattr(dist, "new_group",
                        lambda ranks: made.append(list(ranks)) or len(made))
    g = bootstrap.mesh_groups(dp, ep, sp, tp, pp)
    stage = lambda r: bootstrap.mesh_stage(r, ep, pp)  # noqa: E731
    if pp == 1:
        made_pp1 = list(made)
        made.clear()
        monkeypatch.setattr(bootstrap, "mesh_rank",
                            lambda d, s, e, sp_, ep_, t, tp_, p=0, pp_=1:
                            ((d * sp_ + s) * tp_ + t) * ep_ + e)
        bootstrap.mesh_groups(dp, ep, sp, tp)
        assert made == made_pp1 and g.pp is None
        if tp == 1:
            assert g.data is dist.group.WORLD
        return
    n_data = len(made) - world // pp  # the pp groups come last
    for ranks in made[:n_data]:
        assert len({stage(r) for r in ranks}) == 1, ranks
    for ranks in made[n_data:]:
        assert [stage(r) for r in ranks] == list(range(pp)), ranks
    assert g.pp is not None and g.data is not dist.group.WORLD


def test_stacking_round_trips_match_jax():
    dense = _dense_params()
    got = pipe.stack_block_params(dense)
    want = jpipe.stack_block_params(jax.tree.map(jnp.asarray, dense))
    for (kg, g), (kw, w) in zip(sorted(keyed_leaves(got)),
                                sorted(keyed_leaves(
                                    jax.tree.map(np.asarray, want)))):
        assert kg == kw
        np.testing.assert_array_equal(g, w)
    back = pipe.unstack_block_params(got, LAYERS)
    for a, b in zip(tree_leaves(dense), tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    # Torch leaves and the interleaved rows both ways (convert.py).
    params = _model().init(torch.Generator().manual_seed(7))
    perm = pipe.interleave_permutation(LAYERS, 2, 2)
    stacked = stacked_from_dense(params, perm)
    assert torch.equal(stacked["blocks"]["w1"][1],
                       params["blocks"][perm[1]]["w1"])
    for a, b in zip(tree_leaves(params),
                    tree_leaves(dense_from_stacked(stacked, LAYERS, perm))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("layers,pp,virtual", [
    (4, 2, 1), (4, 2, 2), (4, 1, 4), (8, 2, 2), (12, 2, 2), (8, 4, 2),
    (12, 3, 2)])
def test_interleave_permutation_matches_jax(layers, pp, virtual):
    perm = pipe.interleave_permutation(layers, pp, virtual)
    np.testing.assert_array_equal(
        perm, jpipe.interleave_permutation(layers, pp, virtual))
    x = {"blocks": {"w": np.arange(layers)}, "embed": np.zeros(2)}
    y = pipe.permute_stacked_blocks(x, perm)
    np.testing.assert_array_equal(y["blocks"]["w"], perm)
    np.testing.assert_array_equal(
        pipe.permute_stacked_blocks(y, np.argsort(perm))["blocks"]["w"],
        np.arange(layers))


def test_specs_match_jax():
    def walk(got, want, path):
        if isinstance(got, dict):
            assert set(got) == set(want), path
            for k in got:
                walk(got[k], want[k], f"{path}.{k}")
        else:
            assert tuple(got) == tuple(want), path
    walk(pipe.pipeline_param_specs(_model()),
         jpipe.pipeline_param_specs(_jax_model()), "specs")


@pytest.mark.parametrize("schedule,pp,micro,virtual", [
    ("gpipe", 2, 4, 1), ("gpipe", 4, 1, 1), ("1f1b", 2, 1, 1),
    ("1f1b", 4, 4, 1), ("1f1b", 3, 7, 1), ("zerobubble", 4, 3, 1),
    ("zerobubble", 2, 1, 1), ("interleaved", 2, 4, 2),
    ("interleaved", 4, 8, 3), ("interleaved", 1, 2, 4)])
def test_tick_tables_match_every_send_with_a_receive(schedule, pp, micro,
                                                     virtual):
    """Both ends of every edge read one table: each send of tick t meets
    a receive of tick t + 1, and each work item runs once (zerobubble:
    its B-input and B-weight once each)."""
    table = pipe.tick_table(schedule, pp, micro, virtual)
    pipe.check_table(table, pp, virtual)
    seen = [(s, kind, m, c) for tick in table for s, items in tick.items()
            for kind, m, c in items]
    assert len(seen) == len(set(seen))
    per_stage = micro * virtual * (3 if schedule == "zerobubble" else 2)
    assert len(seen) == pp * per_stage
    # A table with a dropped forward cannot pass.
    broken = [dict(t) for t in table]
    for t in broken:
        if 0 in t and t[0][0][0] in ("F", "Fg") and pp > 1:
            t[0] = t[0][1:]
            break
    if pp > 1:
        with pytest.raises(ValueError, match="tick table"):
            pipe.check_table(broken, pp, virtual)


# ---- the four schedules against JAX's pipeline -----------------------------


@pytest.mark.parametrize("name", list(CELLS))
def test_schedule_matches_jax_pipeline(jax_cells, name):
    pp, micro, schedule, virtual = CELLS[name]
    losses, got = _port_step(_port(schedule, pp, micro, virtual))
    want_loss, want = jax_cells[name]
    assert abs(losses[0] - want_loss) < LOSS_ATOL, (name, losses, want_loss)
    for (k, g), (_, w) in zip(keyed_leaves(got), keyed_leaves(
            jax.tree.map(np.asarray, want))):
        np.testing.assert_allclose(g, w, **STEP_TOL, err_msg=f"{name} {k}")


def test_in_process_matches_the_dense_port_step():
    """pp = 4 over one process equals the port's dense LMTrainer step at
    grad_accum = M (the same microbatches, the same arithmetic)."""
    dense = LMTrainer(_model(), device="cpu", optimizer=_sgd(), grad_accum=4)
    state = dense.init_state(seed=7)
    x, y = dense.put_batch(*make_lm_batch(_tokens()))
    state, loss = dense.train_step(state, x, y)
    want = dense.state_to_host(state)["params"]
    losses, got = _port_step(_port("1f1b", 4, 4))
    assert abs(losses[0] - float(loss)) < 1e-6
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


# ---- dropout ---------------------------------------------------------------


def test_all_schedules_agree_with_dropout(monkeypatch):
    """With dropout on, every schedule at pp 1, 2 and 4 gives the same
    step (JAX's test_all_schedules_agree_with_dropout), and every
    microbatch draws the same masks, bit for bit, whichever stage runs its
    layer: the set of (key, mask) pairs drawn is the same in every
    geometry (keys fold (microbatch, dense layer))."""
    real = tmod.keep_mask
    drawn: set = set()

    def record(key, shape, keep, device):
        m = real(key, shape, keep, device)
        drawn.add((int(key), m.numpy().tobytes()))
        return m

    monkeypatch.setattr(tmod, "keep_mask", record)
    runs = {}
    for name, (schedule, pp, virtual) in {
            "pp1": ("gpipe", 1, 1), "gpipe": ("gpipe", 2, 1),
            "1f1b": ("1f1b", 2, 1), "zerobubble": ("zerobubble", 2, 1),
            "interleaved": ("interleaved", 2, 2),
            "pp4": ("1f1b", 4, 1)}.items():
        drawn.clear()
        tr = _port(schedule, pp, 4, virtual, dropout_seed=3,
                   model=dict(dropout_rate=0.3))
        losses, params = _port_step(tr)
        runs[name] = (losses[0], params, frozenset(drawn))
    ref_loss, ref_p, ref_masks = runs["gpipe"]
    assert len(ref_masks) == 4 * (1 + 2 * LAYERS)
    for name, (loss, params, masks) in runs.items():
        assert abs(loss - ref_loss) < LOSS_ATOL, name
        assert masks == ref_masks, name
        for a, b in zip(tree_leaves(params), tree_leaves(ref_p)):
            np.testing.assert_allclose(a, b, **STEP_TOL, err_msg=name)


# ---- decay, refusals, layouts -----------------------------------------------


def test_decay_mask_on_original_ranks():
    """AdamW's decay runs on the original per-layer ranks (JAX
    ``_decay_mask``): stacked LayerNorm leaves are exempt, as the dense
    trainer exempts them; one AdamW step equals the dense one."""
    tr = _port("1f1b", 2, 2, optimizer=AdamW())
    got = dict(keyed_leaves(tree_unflatten(
        tr.init_state(seed=7).params, tr._decay)))
    mesh = make_mesh(jax.devices()[:2], dp=1, sp=1, mp=1, pp=2)
    jt = JaxPipe(_jax_model(), mesh, num_micro=2, optimizer=JaxAdamW())
    stacked = jpipe.stack_block_params(jax.tree.map(jnp.asarray,
                                                    _dense_params()))
    want = {jax.tree_util.keystr(p, simple=True, separator="."): bool(v)
            for p, v in jax.tree_util.tree_flatten_with_path(
                jt._decay_mask(stacked))[0]}
    assert got == want
    assert not got["blocks.ln1.scale"] and got["blocks.wqkv"]
    dense = LMTrainer(_model(), device="cpu", grad_accum=2)
    state = dense.init_state(seed=7)
    x, y = dense.put_batch(*make_lm_batch(_tokens()))
    state, _ = dense.train_step(state, x, y)
    want_p = dense.state_to_host(state)["params"]
    _, got_p = _port_step(tr)
    for a, b in zip(tree_leaves(got_p), tree_leaves(want_p)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


# (port kwargs, JAX kwargs, pp): each must raise JAX's error and text.
_REFUSALS = {
    "clip": dict(clip_grad_norm=0.0),
    "sp_mode": dict(sp_mode="zigzag"),
    "layers_over_pp": dict(pp=3),
    "schedule": dict(schedule="bogus"),
    "virtual_below_1": dict(pp_virtual=0),
    "virtual_needs_interleaved": dict(schedule="1f1b", pp_virtual=2),
    "interleaved_layers": dict(schedule="interleaved", pp_virtual=4),
    "interleaved_micro": dict(schedule="interleaved", pp_virtual=2,
                              num_micro=3),
    "virtual_sharded": dict(schedule="interleaved", pp_virtual=2,
                            num_micro=2, opt_sharding="zero1"),
    "opt_sharding": dict(opt_sharding="zero3"),
    "param_sharding": dict(param_sharding="ddp"),
    "fsdp_zero": dict(param_sharding="fsdp", opt_sharding="zero1"),
    "zero2_needs_1f1b": dict(opt_sharding="zero2"),
    "virtual_adafactor": dict(schedule="interleaved", pp_virtual=2,
                              num_micro=2, optimizer="adafactor"),
    "zero2_adafactor": dict(schedule="1f1b", opt_sharding="zero2",
                            optimizer="adafactor"),
    "zero1_adafactor_clip": dict(opt_sharding="zero1", clip_grad_norm=1.0,
                                 optimizer="adafactor"),
    "fsdp_adafactor": dict(param_sharding="fsdp", optimizer="adafactor"),
}


@pytest.mark.parametrize("name", list(_REFUSALS))
def test_refusals_keep_jax_text(name):
    kw = dict(_REFUSALS[name])
    pp = kw.pop("pp", 2)
    opt = kw.pop("optimizer", None)
    jopt = JaxAdafactor() if opt == "adafactor" else None
    popt = Adafactor() if opt == "adafactor" else None
    mesh = make_mesh(jax.devices()[:pp], dp=1, sp=1, mp=1, pp=pp)
    with pytest.raises(ValueError) as want:
        JaxPipe(_jax_model(), mesh, optimizer=jopt, **kw)
    with pytest.raises(ValueError) as got:
        PipelineLMTrainer(_model(), device="cpu", optimizer=popt, pp=pp,
                          stages="in_process", **kw)
    assert str(got.value) == str(want.value)


def test_put_batch_refusal_keeps_jax_text():
    mesh = make_mesh(jax.devices()[:2], dp=1, sp=1, mp=1, pp=2)
    jt = JaxPipe(_jax_model(), mesh, num_micro=4)
    bad = np.zeros((6, 32), np.int32)
    with pytest.raises(ValueError) as want:
        jt.put_batch(bad, bad)
    with pytest.raises(ValueError) as got:
        _port("1f1b", 2, 4).put_batch(bad, bad)
    assert str(got.value) == str(want.value)


def test_in_process_refuses_what_it_does_not_compose_with():
    with pytest.raises(ValueError, match="unknown stages"):
        PipelineLMTrainer(_model(), device="cpu", pp=2, stages="threads")


def test_state_keeps_its_row_order():
    """An interleaved trainer's live state refuses a trainer of the dense
    row order (and the other way); through the host tree it moves, and
    the step continues as it would have."""
    inter, plain = _port("interleaved", 2, 4, 2), _port("1f1b", 2, 4)
    state = inter.init_state(seed=7)
    x, y = inter.put_batch(*make_lm_batch(_tokens()))
    with pytest.raises(ValueError, match="stacked row order"):
        plain.train_step(state, x, y)
    with pytest.raises(ValueError, match="stacked row order"):
        inter.train_step(plain.init_state(seed=7), x, y)
    moved = plain.state_from_host(inter.state_to_host(state))
    a, la = inter.train_step(state, x, y)
    b, lb = plain.train_step(moved, x, y)
    assert abs(float(la) - float(lb)) < 1e-6
    for u, v in zip(tree_leaves(inter.params_to_host(a)),
                    tree_leaves(plain.params_to_host(b))):
        np.testing.assert_allclose(u, v, rtol=1e-5, atol=1e-6)


class SwappedEdge(pipe.InProcessEdge):
    """An edge that delivers its first two messages swapped."""

    def recv(self):
        if self.messages >= 2 and not getattr(self, "done", False):
            self.done = True
            self._q.rotate(-1)
        return super().recv()


def test_swapped_edge_breaks_the_step():
    """The planted fault of the card's check: an edge that delivers two
    microbatches swapped moves the gradients past the card's bound (1e-2
    relative Frobenius error on some leaf)."""
    def grads(edge):
        tr = _port("1f1b", 2, 4)
        tr.edge_factory = edge
        x, y = tr.put_batch(*make_lm_batch(_tokens()))
        return tr.step_grads(tr.init_state(seed=7), x, y)[2]

    good, bad = grads(None), grads(SwappedEdge)
    errs = [float((b - g).norm() / g.norm()) for g, b in zip(good, bad)
            if float(g.norm()) > 0]
    assert max(errs) > 1e-2, errs


def test_multi_step_is_the_steps():
    """``build_multi_step`` on the CPU: K steps bit for bit K train_step
    calls, the state's row order carried."""
    tr = _port("interleaved", 2, 4, 2)
    x, y = tr.put_batch(*make_lm_batch(_tokens()))
    a = tr.init_state(seed=7)
    for _ in range(2):
        a, _ = tr.train_step(a, x, y)
    b, losses = tr.build_multi_step(2)(tr.init_state(seed=7), [x, x], [y, y])
    assert b.step == 2 and b.stage_layout == tr._stage_layout
    for u, v in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(u, v)
    assert losses.shape == (2,)


def test_sharding_plan_is_jax_pipelines():
    """The plan names JAX's strategy, mesh, specs and stage layout."""
    tr = _port("interleaved", 2, 4, 2)
    mesh = make_mesh(jax.devices()[:2], dp=1, sp=1, mp=1, pp=2)
    jt = JaxPipe(_jax_model(), mesh, num_micro=4, schedule="interleaved",
                 pp_virtual=2, optimizer=JaxSGD(learning_rate=0.1,
                                                momentum=0.9,
                                                weight_decay=1e-4))
    got, want = tr.sharding_plan(), jt.sharding_plan()
    assert got.strategy == want.strategy
    assert dict(got.mesh_axes) == {k: v for k, v in want.mesh_axes}
    assert got.stage_layout == want.stage_layout
    assert dataclasses.replace(tr.init_state(seed=7)).stage_layout == \
        want.stage_layout


def test_in_process_adafactor_per_stage_cell_matches_jax():
    """Adafactor with every stage in one process runs per stage cell
    (each cell's row and column moments, update-RMS clip and relative
    step), as JAX's CellAdafactor over ``P("pp", ...)`` on a dp 1 x pp 2
    mesh: losses, parameters and the optimizer state in JAX's layout
    (reduced slots stacked on a leading pp axis) after two steps; the
    state moves both ways through JAX's tree and the sharding plan names
    JAX's slot specs. The whole stacked leaf updated as one cell is
    another step."""
    opt = dict(min_dim_size_to_factor=8)
    mesh = make_mesh(jax.devices()[:2], dp=1, sp=1, mp=1, pp=2)
    jt = JaxPipe(_jax_model(), mesh, num_micro=2, schedule="1f1b",
                 optimizer=JaxAdafactor(**opt))
    params = jpipe.stack_block_params(jax.tree.map(jnp.asarray,
                                                   _dense_params()))
    js = jt._place_state(params, jt.optimizer.init(params))
    x, y = jt.put_batch(*make_lm_batch(_tokens()))
    want_losses = []
    for _ in range(2):
        js, loss = jt.train_step(js, x, y)
        want_losses.append(float(np.mean(np.asarray(loss))))
    want = dict(keyed_leaves(jax.device_get(
        {"params": js.params, "opt_state": js.opt_state})))

    tr = _port("1f1b", 2, 2, optimizer=Adafactor(**opt))
    state = tr.init_state(seed=7)
    px, py = tr.put_batch(*make_lm_batch(_tokens()))
    losses = []
    for _ in range(2):
        state, loss = tr.train_step(state, px, py)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=LOSS_ATOL)
    host = tr.state_to_host(state)
    got = dict(keyed_leaves({"params": host["params"],
                             "opt_state": host["opt_state"]}))
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.shape(got[k]) == np.shape(v), k
        np.testing.assert_allclose(got[k], v, **STEP_TOL, err_msg=k)
    assert got["opt_state.vr.blocks.w1"].shape[0] == 2
    # Back through the host tree: the next step is the live state's.
    moved = tr.state_from_host(host)
    a, _ = tr.train_step(state, px, py)
    b, _ = tr.train_step(moved, px, py)
    for u, v in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(u, v)
    plan = json.loads(tr.sharding_plan().to_json())
    jplan = json.loads(jt.sharding_plan().to_json())
    assert plan["opt_specs"] == jplan["opt_specs"]
    # The planted fault: the bare optimizer on whole stacked leaves.
    whole = _port("1f1b", 2, 2, optimizer=Adafactor(**opt))
    whole._held = [1] * len(whole._held)
    whole._unit_leaf = list(range(len(whole._held)))
    whole._unit_local = list(whole._local)
    ws = whole.init_state(seed=7)
    for _ in range(2):
        ws, _ = whole.train_step(ws, px, py)
    wp = dict(keyed_leaves(whole.params_to_host(ws)))
    worst = max(float(np.max(np.abs(wp[k[len("params."):]] - v)
                             / (STEP_TOL["atol"]
                                + STEP_TOL["rtol"] * np.abs(v))))
                for k, v in want.items() if k.startswith("params."))
    assert worst > 1.0, worst
