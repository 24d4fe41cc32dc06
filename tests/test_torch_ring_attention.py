"""Ring attention in the port (tpu_ddp_torch/parallel/ring_attention.py),
the sp-sharded TransformerLM and ``LMTrainer(sp=...)`` in ring mode, and
the dp x sp x ep rank layout (parallel/bootstrap.py), held against the JAX
package on the same numpy-seeded inputs, f32.

The port runs in real gloo processes (tests/torch_sp.py, one subprocess
per rank, 150 s limit); JAX runs under ``shard_map`` on the virtual CPU
devices.

Tolerances:

- ring attention at sp = 2 and 4 (causal and not, GQA, MQA, the cache
  seed with ``q_offset``): the output within rtol and atol 2e-5 and the
  q, k, v gradients within 5e-5 of JAX's ring (tests/test_ring_attention.py
  holds JAX's ring to its whole-sequence reference with these bounds);
- ``blockwise_attention`` with explicit positions and by default: the
  same bounds against JAX's;
- the sp-sharded TransformerLM-tiny forward at sp = 2: logits within 2e-5
  of the JAX model on a (1, 2) mesh and of the port at sp = 1
  (tests/test_torch_lm.py's bound);
- two LMTrainer steps at (dp, sp) = (1, 2) and (2, 2), with
  ``grad_accum = 2`` at (2, 2), and at (dp, sp, ep) = (1, 2, 2) with
  MoE-tiny: losses within 1e-4 and params within rtol 3e-4 / atol 3e-5
  of the JAX ``LMTrainer`` (tests/test_torch_moe.py's bounds); ZeRO-1,
  ZeRO-2 and FSDP at sp = 2 within rtol 1e-5 / atol 1e-6 of the
  replicated run (the same sums, grouped differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from torch_sp import (MOE, PRESET, SEQ, jax_attention, jax_lm, jax_params,
                      port_init, qkv, rank_losses, run_attention, run_lm,
                      tokens)
from tpu_ddp.models import make_transformer as jax_make
from tpu_ddp.parallel.mesh import SEQ_AXIS, make_mesh
from tpu_ddp.parallel.ring_attention import \
    blockwise_attention as jax_blockwise
from tpu_ddp_torch.parallel import bootstrap
from tpu_ddp_torch.parallel.ring_attention import (attend,
                                                   blockwise_attention,
                                                   full_attention)
from tpu_ddp_torch.train.lm import make_lm_batch

OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)
LOSS_ATOL = 1e-4
STEP_TOL = dict(rtol=3e-4, atol=3e-5)
LAYOUT_TOL = dict(rtol=1e-5, atol=1e-6)

# name -> (the case, its inputs' shape arguments to qkv)
RING = {
    "mha": (dict(scheme="ring", causal=False), dict()),
    "mha_causal": (dict(scheme="ring", causal=True), dict()),
    "gqa_causal": (dict(scheme="ring", causal=True), dict(kvh=2)),
    "mqa": (dict(scheme="ring", causal=False), dict(kvh=1)),
    "cache_causal": (dict(scheme="ring", causal=True, q_offset=12),
                     dict(cache=16)),
    "gqa_cache": (dict(scheme="ring", causal=True, q_offset=12),
                  dict(kvh=2, cache=16)),
}
ARRAYS = {n: qkv(i, **shape) for i, (n, (_, shape)) in
          enumerate(RING.items())}


@pytest.fixture(scope="module", params=[2, 4], ids=["sp2", "sp4"])
def ring_run(request, tmp_path_factory):
    sp = request.param
    got = run_attention(tmp_path_factory.mktemp(f"ring{sp}"), sp,
                        {n: c for n, (c, _) in RING.items()}, ARRAYS,
                        f"ring{sp}")
    return sp, got


@pytest.mark.parametrize("name", list(RING))
def test_ring_attention_matches_jax(ring_run, name):
    sp, got = ring_run
    case = RING[name][0]
    want = jax_attention("ring", sp, case, ARRAYS[name])
    np.testing.assert_allclose(got[name]["o"], want["o"], **OUT_TOL)
    for t in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[name][t], want[t], **GRAD_TOL,
                                   err_msg=t)
    if "ck" not in ARRAYS[name]:
        # And the port's own whole-sequence reference.
        a = {t: torch.from_numpy(ARRAYS[name][t]) for t in "qkv"}
        ref = full_attention(a["q"], a["k"], a["v"], case["causal"])
        np.testing.assert_allclose(got[name]["o"], ref.numpy(), **OUT_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bs", [4, 5, 32])
def test_blockwise_attention_matches_jax(causal, bs):
    a = qkv(20 + bs, L=16, kvh=2)
    args = [a[t] for t in "qkv"]
    want = jax_blockwise(*map(jnp.asarray, args), causal=causal,
                         block_size=bs)
    jg = jax.grad(lambda q, k, v: jnp.sum(jax_blockwise(
        q, k, v, causal=causal, block_size=bs) * a["do"]),
        argnums=(0, 1, 2))(*map(jnp.asarray, args))
    t = [torch.from_numpy(x).requires_grad_() for x in args]
    got = blockwise_attention(*t, causal=causal, block_size=bs)
    tg = torch.autograd.grad((got * torch.from_numpy(a["do"])).sum(), t)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **OUT_TOL)
    for x, y in zip(tg, jg):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **GRAD_TOL)


@pytest.mark.parametrize("bs", [5, 64])
def test_blockwise_explicit_positions_match_jax(bs):
    """A cache of 16 positions (the last 4 invalid) before an 8-token
    chunk at offset 12, keys at explicit positions: the Ulysses cache
    path's call."""
    a = qkv(31, L=8, kvh=2, cache=16)
    S, L = 16, 8
    pos = 12 + np.arange(L)
    k_pos = np.concatenate([np.arange(S), pos])
    k_valid = np.concatenate([a["cvalid"], np.ones(L, bool)])
    k = np.concatenate([a["ck"], a["k"]], axis=1)
    v = np.concatenate([a["cv"], a["v"]], axis=1)

    def jfn(q, k, v):
        return jax_blockwise(q, k, v, causal=True, block_size=bs,
                             q_pos=jnp.asarray(pos),
                             k_pos=jnp.asarray(k_pos),
                             k_valid=jnp.asarray(k_valid))

    jargs = [jnp.asarray(x) for x in (a["q"], k, v)]
    want = jfn(*jargs)
    jg = jax.grad(lambda *x: jnp.sum(jfn(*x) * a["do"]),
                  argnums=(0, 1, 2))(*jargs)
    t = [torch.from_numpy(x).requires_grad_() for x in (a["q"], k, v)]
    got = blockwise_attention(*t, causal=True, block_size=bs,
                              q_pos=torch.from_numpy(pos),
                              k_pos=torch.from_numpy(k_pos),
                              k_valid=torch.from_numpy(k_valid))
    tg = torch.autograd.grad((got * torch.from_numpy(a["do"])).sum(), t)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **OUT_TOL)
    for x, y in zip(tg, jg):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **GRAD_TOL)


def test_attend_validates_its_axis():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="axis_size"):
        attend(q, q, q, axis_name="sp")
    with pytest.raises(ValueError, match="unknown sequence-parallel mode"):
        attend(q, q, q, axis_name="sp", axis_size=2, mode="zigzag")


@pytest.mark.parametrize("dp,sp,ep", [(1, 2, 1), (2, 2, 1), (1, 2, 2),
                                      (2, 1, 2), (2, 2, 2), (4, 1, 1)])
def test_rank_layout_matches_jax_make_mesh(dp, sp, ep):
    mesh = make_mesh(jax.devices()[:dp * sp * ep], dp=dp, sp=sp, ep=ep)
    for idx in np.ndindex(mesh.devices.shape):
        d, s, _, _, e = idx
        rank = mesh.devices[idx].id
        assert bootstrap.mesh_rank(d, s, e, sp, ep) == rank
        assert bootstrap.mesh_coords(rank, sp, ep) == (d, s, e, 0)


# ---- the model and the trainer --------------------------------------------

RUNS_2 = {
    "ring": dict(sp=2, mode="ring", preset=PRESET, forward=True),
    "zero1": dict(sp=2, mode="ring", preset=PRESET, opt="zero1"),
    "zero2": dict(sp=2, mode="ring", preset=PRESET, opt="zero2"),
    "fsdp": dict(sp=2, mode="ring", preset=PRESET, param="fsdp"),
}
RUNS_4 = {
    "ring": dict(sp=2, mode="ring", preset=PRESET),
    "accum": dict(sp=2, mode="ring", preset=PRESET, accum=2),
    "moe_ep2": dict(sp=2, ep=2, mode="ring", preset="TransformerLM-moe-tiny",
                    model=MOE),
}
# (dp, ep, sp) of the mesh_groups calls the world-4 run records.
GROUPS = [(4, 1, 1), (2, 2, 1), (1, 1, 4), (2, 1, 2), (1, 2, 2)]


@pytest.fixture(scope="module")
def lm2(tmp_path_factory):
    return run_lm(tmp_path_factory.mktemp("lm2"), 2, RUNS_2, "lm2")


@pytest.fixture(scope="module")
def lm4(tmp_path_factory):
    return run_lm(tmp_path_factory.mktemp("lm4"), 4, RUNS_4, "lm4",
                  groups=GROUPS)


def test_sp_sharded_forward_matches_jax_mesh_and_sp1(lm2):
    got = np.concatenate([rec["ring/logits"] for rec in lm2], axis=1)
    params, tm = port_init()
    x, _ = make_lm_batch(tokens())
    want = tm.apply(params, torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    from tpu_ddp_torch.convert import params_to_jax
    jm = jax_make(PRESET, max_seq_len=SEQ, compute_dtype=jnp.float32)
    jm = jm.with_sequence_parallel(SEQ_AXIS, 2, mode="ring")
    mesh = make_mesh(jax.devices()[:2], dp=1, sp=2)
    f = jax.jit(jax.shard_map(lambda p, t: jm.apply(p, t), mesh=mesh,
                              in_specs=(P(), P(None, SEQ_AXIS)),
                              out_specs=P(None, SEQ_AXIS), check_vma=False))
    jl = f(jax.tree.map(jnp.asarray, params_to_jax(params)),
           jnp.asarray(x, jnp.int32))
    np.testing.assert_allclose(got, np.asarray(jl), rtol=2e-5, atol=2e-5)


def _held_to_jax(recs, name, dp, sp, ep=1, **kw):
    want_losses, jstate = jax_lm(dp, sp, "ring", ep=ep, **kw)
    np.testing.assert_allclose(rank_losses(recs, name, dp, sp, ep),
                               want_losses, atol=LOSS_ATOL, rtol=0)
    for key, want in jax_params(jstate).items():
        np.testing.assert_allclose(recs[0][f"{name}/{key}"], want,
                                   **STEP_TOL, err_msg=key)


def test_trainer_dp1_sp2_matches_jax(lm2):
    _held_to_jax(lm2, "ring", 1, 2)


def test_trainer_dp2_sp2_matches_jax(lm4):
    _held_to_jax(lm4, "ring", 2, 2)


def test_trainer_grad_accum_dp2_sp2_matches_jax(lm4):
    _held_to_jax(lm4, "accum", 2, 2, accum=2)


def test_trainer_ep2_sp2_matches_jax(lm4):
    _held_to_jax(lm4, "moe_ep2", 1, 2, ep=2,
                 preset="TransformerLM-moe-tiny", **MOE)


@pytest.mark.parametrize("layout", ["zero1", "zero2", "fsdp"])
def test_sharded_layouts_at_sp2_match_replicated(lm2, layout):
    for r, rec in enumerate(lm2):
        np.testing.assert_allclose(rec[f"{layout}/losses"],
                                   rec["ring/losses"], **LAYOUT_TOL)
    keys = [k[len("ring/"):] for k in lm2[0] if k.startswith("ring/params.")]
    assert keys
    for key in keys:
        np.testing.assert_allclose(lm2[0][f"{layout}/{key}"],
                                   lm2[0][f"ring/{key}"], **LAYOUT_TOL,
                                   err_msg=key)


def test_mesh_groups_follow_the_jax_layout(lm4):
    rec = lm4[0]
    for dp, ep, sp in GROUPS:
        mesh = make_mesh(jax.devices()[:4], dp=dp, sp=sp, ep=ep).devices
        ids = np.vectorize(lambda dv: dv.id)(mesh).reshape(dp, sp, ep)
        want = {"dp": [int(i) for i in ids[:, 0, 0]],
                "ep": [int(i) for i in ids[0, 0, :]],
                "sp": [int(i) for i in ids[0, :, 0]] if sp > 1 else [],
                "dp_sp": sorted(int(i) for i in ids[:, :, 0].ravel())}
        if sp == 1:
            # At sp 1 the groups a dp x ep world always had: dp groups of
            # ranks d * ep + e, ep groups of d * ep + e over e.
            assert want["dp"] == [d * ep for d in range(dp)]
            want["dp_sp"] = want["dp"]
        for kind, ranks in want.items():
            assert rec[f"groups/{dp}_{ep}_{sp}/{kind}"].tolist() == ranks, \
                (dp, ep, sp, kind)
