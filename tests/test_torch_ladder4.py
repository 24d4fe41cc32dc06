"""The port's ladder at FOUR processes (tpu_ddp_torch/train/engine.py):
parts 2a, 2b, 3, 4 and 5 as 4-rank gloo runs (tests/torch_ranks.py)
against the JAX ``Trainer`` of the same strategy on a 4-device CPU mesh
fed the four ranks' batches, from the JAX init, two steps.

Tolerance: the ladder's rtol 1e-4 / atol 1e-5 (tests/test_torch_train.py
states its margin). Both sides compute in f32; at four replicas the
mean's sum runs in another order on each rung and in each package.
Every rank must end with the same parameters, bit for bit, and the five
rungs agree with each other within the same tolerance (the ladder's
invariant: each applies the mean of the replicas' gradients).
"""

import numpy as np
import pytest

from torch_ranks import make_inputs, run_jax, run_vgg, state_keys
from tpu_ddp_torch.parallel.sync import PART_TO_STRATEGY

RTOL, ATOL = 1e-4, 1e-5
PARTS = ("part2a", "part2b", "part3", "part4", "part5")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return {"in": make_inputs(tmp_path_factory.mktemp("ladder4"), world=4,
                              batch=2), "runs": {}}


@pytest.mark.parametrize("part", PARTS)
def test_rung_at_four_processes_matches_jax(part, inputs, tmp_path):
    params, x, y, init, data = inputs["in"]
    ranks = run_vgg(tmp_path, part, 4, init=init, data=data,
                    every_rank=True)
    want = run_jax(PART_TO_STRATEGY[part], 4, params, x, y)
    np.testing.assert_allclose(
        np.stack([r["losses"] for r in ranks], axis=1), want["losses"],
        rtol=RTOL, atol=ATOL)
    keys = state_keys(want, "params")
    assert keys == state_keys(ranks[0], "params")
    for k in keys:
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
        np.testing.assert_allclose(ranks[0][k], want[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    inputs["runs"][part] = ranks[0]


def test_rungs_agree_at_four_processes(inputs):
    runs = inputs["runs"]
    assert set(runs) == set(PARTS), "runs after the five rung tests"
    ref = runs["part2b"]
    for part in PARTS:
        for k in state_keys(ref, "params") + state_keys(ref, "opt_state"):
            np.testing.assert_allclose(runs[part][k], ref[k], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{part} {k}")
