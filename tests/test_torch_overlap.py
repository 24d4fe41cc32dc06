"""Bucketed overlap and the sharded update of the port
(tpu_ddp_torch/parallel/overlap.py) held to the JAX package's
(tpu_ddp/parallel/overlap.py).

- ``BucketPlan``: the same cuts, sizes and order as JAX's on the same
  leaves (VGG-11 and the tiny VGG, several bucket sizes).
- The overlapped trajectory of each replicated rung as a 2-process gloo
  run with buckets small enough to cut the tiny VGG into several: on
  gather_scatter and all_reduce it is the unbucketed run's bit for bit
  (all_reduce then runs the sharded update, so this holds ShardedUpdate
  to the replicated update), on fused within the ladder's tolerance of
  the DDP run (DDP divides each gradient by N before its sum), and on
  every rung within the ladder's tolerance of JAX's overlapped engine.
  The buckets' collectives launch in bucket order: reverse parameter
  order, the output side first.
- The step guard under the overlapped int8 wire: a NaN in one rank's
  batch skips the step on both ranks, and the carry rolls back, so the
  run equals one that never saw that batch, bit for bit.
"""

import jax
import numpy as np
import pytest

from torch_ranks import (TINY, make_inputs, run_jax, run_vgg,
                         state_keys)
from tpu_ddp.models.vgg import VGGModel as JaxVGG
from tpu_ddp.parallel.overlap import BucketPlan as JaxBucketPlan
from tpu_ddp_torch.convert import CanonicalView
from tpu_ddp_torch.models.vgg import VGGModel, make_vgg
from tpu_ddp_torch.parallel.overlap import BucketPlan
from tpu_ddp_torch.parallel.sync import PART_TO_STRATEGY

RTOL, ATOL = 1e-4, 1e-5
# About 4 KiB of f32 payload: the tiny VGG's leaves fill several buckets.
SMALL_MB = 0.004


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(tmp_path_factory.mktemp("overlap"), world=2,
                       steps=3)


@pytest.mark.parametrize("name,mb", [("VGG11", 25), ("VGG11", 4),
                                     ("tiny", 25), ("tiny", SMALL_MB)])
def test_bucket_plan_matches_jax(name, mb):
    if name == "tiny":
        model = VGGModel("tiny", TINY)
        jm = JaxVGG(name="tiny", cfg=TINY)
    else:
        model = make_vgg(name)
        from tpu_ddp.models.vgg import make_vgg as jax_make_vgg
        jm = jax_make_vgg(name)
    template = jax.eval_shape(lambda: jm.init(jax.random.key(0)))
    want = JaxBucketPlan(template, mb)
    got = BucketPlan(CanonicalView(model).shapes, mb)
    assert got.buckets == want.buckets
    assert got.bucket_sizes() == want.bucket_sizes()
    assert got.describe() == want.describe()
    if name == "tiny" and mb == SMALL_MB:
        assert got.n_buckets >= 3


@pytest.mark.parametrize("part", ["part2a", "part2b", "part3"])
def test_overlapped_rung_equals_unbucketed_and_jax(part, inputs, tmp_path):
    params, x, y, init, data = inputs
    cfg = {"overlap": True, "bucket_mb": SMALL_MB}
    over = run_vgg(tmp_path, part, 2, init=init, data=data, cfg=cfg,
                   every_rank=True, tag="over")
    plain = run_vgg(tmp_path, part, 2, init=init, data=data, tag="plain")
    n_buckets = BucketPlan(CanonicalView(VGGModel("tiny", TINY)).shapes,
                           SMALL_MB).n_buckets
    for r in over:
        assert r["fired"].tolist() == [list(range(n_buckets))] * 3
    keys = state_keys(plain, "params") + state_keys(plain, "opt_state")
    for k in keys:
        np.testing.assert_array_equal(over[1][k], over[0][k], err_msg=k)
        if part == "part3":
            np.testing.assert_allclose(over[0][k], plain[k], rtol=RTOL,
                                       atol=ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(over[0][k], plain[k], err_msg=k)
    want = run_jax(PART_TO_STRATEGY[part], 2, params, x, y, overlap=True,
                   bucket_mb=SMALL_MB)
    np.testing.assert_allclose(
        np.stack([r["losses"] for r in over], axis=1), want["losses"],
        rtol=RTOL, atol=ATOL)
    for k in keys:
        np.testing.assert_allclose(over[0][k], want[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_guard_skips_a_nan_under_the_int8_wire(inputs, tmp_path):
    _, x, y, init, _ = inputs
    cfg = {"overlap": True, "bucket_mb": SMALL_MB, "grad_compress": "int8"}
    bad = run_vgg(tmp_path, "part3", 2, init=init, data=inputs[4], cfg=cfg,
                  nan=[(1, 1)], every_rank=True, tag="nan")
    for r in bad:
        assert r["skipped"].tolist() == [False, True, False]
        assert np.isnan(r["losses"][1]) == (r is bad[1])
    clean = tmp_path / "clean.npz"
    np.savez(clean, x=x[[0, 2]], y=y[[0, 2]])
    ref = run_vgg(tmp_path, "part3", 2, init=init, data=clean, cfg=cfg,
                  tag="clean")
    for k in (state_keys(ref, "params") + state_keys(ref, "opt_state")
              + state_keys(ref, "comp_state")):
        np.testing.assert_array_equal(bad[0][k], ref[k], err_msg=k)
