"""The port's gradient wires (tpu_ddp_torch/parallel/compress.py) held to
the JAX package's (tpu_ddp/parallel/compress.py).

- bf16 on each syncing rung as a 2-process gloo run against the JAX
  ``Trainer`` with ``grad_compress="bf16"`` on a 2-device mesh. Both
  sides round the same f32 gradients to bf16 and mean in f32; the
  gradients themselves differ in the order of summation (about 1e-7
  relative), which can move a bf16 rounding by one unit (2**-8
  relative) on a few elements. Bound: the JAX suite's own bf16-vs-f32
  bound, 5e-3 absolute, cut to 1e-3.
- int8 by the properties the JAX suite pins (its rounding noise is a
  counter hash, not ``jax.random``): the round trip within one block
  step, stochastic rounding unbiased over 64 draws (and the bound
  catches a planted bias), zeros exact, and error feedback removing the
  drift ``int8-noef`` keeps on the JAX suite's toy quadratic at 4
  processes.
- The int8 carry: checkpointed in the JAX layout and restored exactly,
  reset with a warning at another dp, and the degrade-to-none warning
  where there is nothing to compress.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ranks import (TINY, make_inputs, run_jax, run_ranks,
                         run_vgg, state_keys, free_port)
from tpu_ddp_torch.models.vgg import VGGModel
from tpu_ddp_torch.parallel.compress import (SPECS, GradCompressor,
                                             get_compressor)
from tpu_ddp_torch.train.engine import Trainer
from tpu_ddp_torch.utils.config import TrainConfig

BF16_ATOL = 1e-3


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(tmp_path_factory.mktemp("compress"), world=2)


def _key(seed, rank=0, leaf=0):
    return GradCompressor.key(torch.tensor(seed, dtype=torch.int64), rank,
                              leaf)


# ---- the quantizer ----------------------------------------------------------

def test_roundtrip_error_within_block_step():
    comp = get_compressor("int8", block_size=64)
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(4, 256)) * np.array(
        [1e-3, 1.0, 50.0, 1e4])[:, None], dtype=torch.float32)
    q, s = comp.quant(x, comp.uniform(x.shape, _key(1)))
    assert q.dtype == torch.int8 and q.shape == x.shape
    assert s.shape == (4, 4)
    err = (comp.dequant(q, s) - x).abs().numpy()
    assert np.all(err <= np.repeat(s.numpy(), 64, axis=-1) * (1 + 1e-6))


def _mean_error(comp, x, draws, shift=0.0):
    """Mean over ``draws`` keys of deq(q(x)) - x, in units of the block
    step; ``shift`` plants a bias in the rounding noise."""
    out = []
    for k in range(draws):
        u = comp.uniform(x.shape, _key(7, leaf=k)) + shift
        q, s = comp.quant(x, u)
        out.append(comp.dequant(q, s) - x)
    _, s = comp.quant(x, comp.uniform(x.shape, _key(7)))
    return (torch.stack(out).mean(0) / s[0]).numpy()


def test_stochastic_rounding_is_unbiased_and_the_bound_catches_a_bias():
    """Per draw the error is in (-1, 1) steps with variance <= 1/4, so
    the mean of 64 has std <= 1/16 per element: the largest of 128 stays
    under 0.3 and their average under 0.02. Rounding noise shifted by a
    quarter step (a biased rounder) moves the average by 0.25."""
    comp = get_compressor("int8", block_size=128)
    x = torch.tensor(np.random.default_rng(3).normal(size=(128,)),
                     dtype=torch.float32)
    err = _mean_error(comp, x, 64)
    assert np.max(np.abs(err)) < 0.3 and abs(err.mean()) < 0.02
    bad = _mean_error(comp, x, 64, shift=0.25)
    assert abs(bad.mean()) > 0.2


def test_noise_is_uniform_and_keyed():
    u = GradCompressor.uniform((1 << 16,), _key(0))
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01
    for other in (_key(1), _key(0, rank=1), _key(0, leaf=1)):
        assert not torch.equal(u[:64], GradCompressor.uniform((64,), other))
    assert torch.equal(u[:64], GradCompressor.uniform((64,), _key(0)))


def test_zeros_quantize_exactly():
    comp = get_compressor("int8")
    x = torch.zeros(512)
    q, s = comp.quant(x, comp.uniform(x.shape, _key(123)))
    assert not torch.any(q) and not torch.any(comp.dequant(q, s))


def test_bf16_wire_matches_jax():
    x = np.array([1.0, -2.5, 3.0e-8, 65504.0, 1.00390625, -7.1e-3],
                 np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    got = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_spec_validation(monkeypatch):
    assert SPECS == ("none", "bf16", "int8", "int8-noef")
    with pytest.raises(ValueError, match="unknown grad_compress"):
        get_compressor("fp8")
    monkeypatch.setenv("TPU_DDP_GRAD_COMPRESS", "fp8")
    with pytest.raises(ValueError, match="TPU_DDP_GRAD_COMPRESS"):
        TrainConfig()
    monkeypatch.setenv("TPU_DDP_GRAD_COMPRESS", "int8-noef")
    assert TrainConfig().grad_compress == "int8-noef"


def test_degrades_to_none_without_sync():
    model = VGGModel("tiny", TINY, compute_dtype=torch.float32)
    with pytest.warns(UserWarning, match="compression disabled"):
        tr = Trainer(model, TrainConfig(grad_compress="int8",
                                        compute_dtype="float32"),
                     device="cpu")
    assert tr.compressor.spec == "none" and tr.init_state().comp_state \
        is None
    with pytest.warns(UserWarning, match="bucketed overlap disabled"):
        Trainer(model, TrainConfig(overlap=True, compute_dtype="float32"),
                device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        Trainer(model, TrainConfig(compute_dtype="float32"), device="cpu")


# ---- bf16 on every rung, against JAX ----------------------------------------

@pytest.mark.parametrize("strategy", ["gather_scatter", "all_reduce",
                                      "fused", "zero", "fsdp"])
def test_bf16_rung_matches_jax(strategy, inputs, tmp_path):
    params, x, y, init, data = inputs
    got = run_vgg(tmp_path, strategy, 2, init=init, data=data,
                  cfg={"grad_compress": "bf16"})
    want = run_jax(strategy, 2, params, x, y, grad_compress="bf16")
    np.testing.assert_allclose(got["losses"], want["losses"][:, 0],
                               rtol=1e-4, atol=1e-4)
    for k in state_keys(want, "params"):
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=BF16_ATOL, err_msg=k)


# ---- error feedback against drift -------------------------------------------

DESCEND = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist
from tpu_ddp_torch.parallel.compress import get_compressor
torch.set_num_threads(1)
port, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
D, LR, STEPS = 512, 0.02, 800
rng = np.random.default_rng(11)
t = torch.tensor(rng.normal(size=(world, D)) * rng.choice(
    [0.05, 1.0, 30.0], size=(world, D)), dtype=torch.float32)
out = {"opt": t.mean(0).numpy()}
for spec in ("none", "int8", "int8-noef"):
    comp = get_compressor(spec, block_size=64)
    w = torch.zeros(D)
    c = comp.init_state([(D,)], "cpu", seed=0)
    for _ in range(STEPS):
        g = w - t[rank]
        if spec == "none":
            dist.all_reduce(g)
            g = g / world
        else:
            (g,), c = comp.sync_replicated("fused", [g], c, dist.group.WORLD)
        w = w - LR * g
    out[spec] = w.numpy()
if rank == 0:
    np.savez(sys.argv[4], **out)
dist.barrier()
sys.stdout.flush()
os._exit(0)  # no group teardown at exit (tests/torch_ranks.py WORKER)
"""


def test_error_feedback_removes_the_drift(tmp_path):
    """The JAX suite's toy (tests/test_compress.py:251) at 4 processes:
    w <- w - lr * mean_i(w - t_i) over a compressed fused wire. f32
    lands on the optimum; int8 with error feedback within 5% of |opt| of
    the f32 path; int8-noef stalls at a noise floor above int8's. The
    JAX suite asks for 3x at 8 devices; this run reads about 8x at 4
    (the hash noise), and the bound is set at 3x."""
    out = tmp_path / "descend.npz"
    port = str(free_port())
    run_ranks(lambda r: ["-c", DESCEND, port, str(r), "4", str(out)], 4,
              timeout=240)
    d = np.load(out)
    opt = d["opt"]
    err_ef = np.linalg.norm(d["int8"] - opt)
    err_noef = np.linalg.norm(d["int8-noef"] - opt)
    assert np.linalg.norm(d["none"] - opt) < 1e-3
    assert np.linalg.norm(d["int8"] - d["none"]) < 0.05 * np.linalg.norm(opt)
    assert err_noef > 3 * max(err_ef, 1e-6)


# ---- the carry in checkpoints -----------------------------------------------

def test_residual_checkpoint_round_trip_and_reset(inputs, tmp_path):
    """int8 on fused at dp 2: the carry is checkpointed in the JAX
    layout (seed, residual leaves (dp, *shape)) and restores exactly at
    dp 2; at dp 4 it resets to zeros with a warning, and a trainer
    without compression drops it."""
    _, _, _, init, data = inputs
    ck = tmp_path / "ck"
    saved = run_vgg(tmp_path, "fused", 2, init=init, data=data, save=ck,
                    cfg={"grad_compress": "int8"}, tag="save")
    res = state_keys(saved, "comp_state.residual")
    assert res and saved["comp_state.seed"] == 89395 + 2
    assert saved["comp_state.residual.features.0.kernel"].shape == (
        2, 3, 3, 3, 8)
    assert any(np.any(saved[k]) for k in res)
    back = run_vgg(tmp_path, "fused", 2, restore=ck,
                   cfg={"grad_compress": "int8"}, tag="back")
    for k in state_keys(saved, ""):
        if k not in ("losses", "skipped", "fired", "_log"):
            np.testing.assert_array_equal(back[k], saved[k], err_msg=k)
    wide = run_vgg(tmp_path, "fused", 4, restore=ck,
                   cfg={"grad_compress": "int8"}, tag="wide")
    assert "resetting the error-feedback residual" in wide["_log"]
    assert wide["comp_state.residual.head.bias"].shape == (4, 10)
    assert not any(np.any(wide[k]) for k in
                   state_keys(wide, "comp_state.residual"))
    plain = run_vgg(tmp_path, "fused", 2, restore=ck, tag="plain")
    assert not state_keys(plain, "comp_state")
    np.testing.assert_array_equal(plain["params.head.kernel"],
                                  saved["params.head.kernel"])
