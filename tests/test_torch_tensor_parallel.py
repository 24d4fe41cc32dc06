"""Tensor parallelism in the port (tpu_ddp_torch/parallel/tensor_parallel.py,
``TransformerLM.with_tensor_parallel``) held against the JAX package on
the same numpy-seeded inputs, f32.

The port runs in real gloo processes, one world of 2 and one of 4
(tests/torch_tp.py, started together, 150 s limit), each rank holding
its cell of the seed-3 parameters; JAX runs ``with_tensor_parallel``
under ``shard_map`` on the virtual CPU devices while they run.

Tolerances: Megatron's ``f`` and ``g`` exactly (sums of two or four f32
values); the loss, logits and gradients (the ranks' cells put back
together) within rtol 1e-4 / atol 1e-5 of JAX's at tp 2 and 4 (MHA,
GQA and MoE-tiny), since the all-reduce sums in another order than JAX's
psum; the dense port within the same bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from torch_tp import (MOE, MOE_PRESET, PRESET, SEQ, MODEL_WORKER, collect,
                      jax_model_grads, launch, tokens)
from tpu_ddp.models import make_transformer as jax_make
from tpu_ddp.parallel.mesh import MODEL_AXIS
from tpu_ddp_torch.convert import (params_from_cells, params_to_jax,
                                   shape_leaves)
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.parallel.redistribute import P
from tpu_ddp_torch.parallel.zero import leaf_partition

TOL = dict(rtol=1e-4, atol=1e-5)
CASES = {
    2: {"mha": dict(preset=PRESET, model={}),
        "gqa": dict(preset=PRESET, model=dict(num_kv_heads=2)),
        "moe": dict(preset=MOE_PRESET, model=MOE)},
    4: {"mha": dict(preset=PRESET, model={}),
        "moe": dict(preset=MOE_PRESET, model=MOE)},
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both gloo worlds' records, and JAX's result for every case."""
    tmp = tmp_path_factory.mktemp("tp")
    toks = tokens()
    handles = {w: launch(MODEL_WORKER, w, {
        "cases": cases, "tokens": toks.tolist(), "seq": SEQ,
        "out": str(tmp / f"w{w}")}) for w, cases in CASES.items()}
    want = {(w, n): jax_model_grads(c["preset"], w, c["model"], toks)
            for w, cases in CASES.items() for n, c in cases.items()}
    return {w: collect(h) for w, h in handles.items()}, want


@pytest.mark.parametrize("world", [2, 4])
def test_f_and_g_forward_and_backward(runs, world):
    recs = runs[0][world]
    xs, ws = [], []
    for r in range(world):
        g = torch.Generator().manual_seed(5)
        xs.append((torch.randn(3, 4, generator=g) + r).numpy())
        ws.append((torch.randn(3, 4, generator=g) * (r + 1)).numpy())
    for r, rec in enumerate(recs):
        # g: the sum forward, the identity backward.
        np.testing.assert_array_equal(rec["g/y"], recs[0]["g/y"])
        np.testing.assert_allclose(rec["g/y"], sum(xs), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(rec["g/dx"], ws[r])
        # f: the identity forward, the sum backward.
        np.testing.assert_array_equal(rec["f/z"], xs[r])
        np.testing.assert_allclose(rec["f/dx"], sum(ws), rtol=0, atol=1e-6)


def _grads(recs, name, tp, preset, model):
    """The ranks' gradient cells put back into the canonical tree."""
    tm = make_transformer(preset, max_seq_len=SEQ,
                          compute_dtype=torch.float32, **model)
    specs = tm.with_tensor_parallel("mp", tp).param_specs()
    skel = params_to_jax(tm.init(torch.Generator().manual_seed(3)))

    def cell(index):
        rec = recs[index["mp"]]
        flat, tdef = jax.tree_util.tree_flatten_with_path(skel)
        return jax.tree_util.tree_unflatten(tdef, [
            rec[f"{name}/grads." + jax.tree_util.keystr(
                p, simple=True, separator=".")] for p, _ in flat])
    flat, _ = jax.tree_util.tree_flatten_with_path(
        params_from_cells(cell, specs, {"mp": tp}))
    return {"grads." + jax.tree_util.keystr(p, simple=True, separator="."):
            v for p, v in flat}


@pytest.mark.parametrize("world,name", [(w, n) for w, c in CASES.items()
                                        for n in c])
def test_loss_and_grads_match_jax_with_tensor_parallel(runs, world, name):
    recs = runs[0][world]
    loss, logits, grads = runs[1][(world, name)]
    case = CASES[world][name]
    for rec in recs:
        np.testing.assert_allclose(rec[f"{name}/loss"], loss, **TOL)
        np.testing.assert_allclose(rec[f"{name}/logits"], logits, **TOL)
    got = _grads(recs, name, world, case["preset"], case["model"])
    assert sorted(got) == sorted(grads)
    for k, want in grads.items():
        np.testing.assert_allclose(got[k], want, **TOL, err_msg=k)


def test_param_specs_match_jax_tree():
    """Leaf by leaf, MoE included (``(ep, None, tp)``), at tp 1 (every
    dim None) and under tp x ep."""
    for preset, kw in ((PRESET, {}), (PRESET, dict(num_kv_heads=2)),
                       (MOE_PRESET, MOE)):
        tm = make_transformer(preset, compute_dtype=torch.float32, **kw)
        jm = jax_make(preset, compute_dtype=jnp.float32, **kw)
        for tp, ep in ((1, 1), (2, 1), (2, 2)):
            t, j = tm, jm
            if tp > 1:
                t = t.with_tensor_parallel("mp", tp)
                j = j.with_tensor_parallel(MODEL_AXIS, tp)
            if ep > 1 and tm.moe_experts:
                t = t.with_expert_parallel("ep", ep)
                j = j.with_expert_parallel("ep", ep)
            want = jax.tree_util.tree_flatten_with_path(
                j.param_specs(), is_leaf=lambda x: isinstance(x, JP))[0]
            got = jax.tree_util.tree_flatten_with_path(
                t.param_specs(), is_leaf=lambda x: isinstance(x, P))[0]
            assert [jax.tree_util.keystr(p) for p, _ in got] == \
                [jax.tree_util.keystr(p) for p, _ in want]
            assert [tuple(s) for _, s in got] == [tuple(s) for _, s in want]
            # The local shapes are the canonical ones cut by the specs.
            sizes = {"mp": tp, "ep": ep if tm.moe_experts else 1}
            for canon, local, spec in zip(
                    shape_leaves(tm.param_shapes()),
                    shape_leaves(t.param_shapes()),
                    shape_leaves(t.param_specs())):
                cut = leaf_partition(spec, canon, sizes)
                assert tuple(local) == (cut.local_shape if cut
                                        else tuple(canon))


@pytest.mark.parametrize("kw,tp", [
    (dict(), 3),                    # heads 4 % 3
    (dict(num_kv_heads=2), 4),      # kv heads 2 % 4
    (dict(d_ff=514), 4),            # d_ff 514 % 4
    (dict(num_kv_heads=2), 2),      # divisible: both build
])
def test_divisibility_errors_are_jaxs(kw, tp):
    tm = make_transformer(PRESET, compute_dtype=torch.float32, **kw)
    jm = jax_make(PRESET, compute_dtype=jnp.float32, **kw)
    try:
        jm.with_tensor_parallel(MODEL_AXIS, tp)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tm.with_tensor_parallel("mp", tp)
        assert str(got.value) == str(e)
    else:
        tm.with_tensor_parallel("mp", tp)


def test_ulysses_head_check_per_tp_shard_is_jaxs():
    """sp is applied before tp: the Ulysses check reruns per tp shard."""
    tm = make_transformer(PRESET, compute_dtype=torch.float32)
    jm = jax_make(PRESET, compute_dtype=jnp.float32)
    t = tm.with_sequence_parallel("sp", 4, mode="ulysses")
    j = jm.with_sequence_parallel("sp", 4, mode="ulysses")
    with pytest.raises(ValueError) as want:
        j.with_tensor_parallel(MODEL_AXIS, 2)
    with pytest.raises(ValueError) as got:
        t.with_tensor_parallel("mp", 2)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jm.with_tensor_parallel(MODEL_AXIS, 2).with_sequence_parallel(
            "sp", 4, mode="ulysses")
    with pytest.raises(ValueError) as got:
        tm.with_tensor_parallel("mp", 2).with_sequence_parallel(
            "sp", 4, mode="ulysses")
    assert str(got.value) == str(want.value)
