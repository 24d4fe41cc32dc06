"""The MPMD pipeline in the port (tpu_ddp_torch/parallel/mpmd.py, the
edge codec of parallel/compress.py, train/pipeline.py:StageScheduler,
examples/mpmd_train.py and ``launch mpmd``) held to the JAX package's
(tpu_ddp/parallel/mpmd.py; its tests are tests/test_mpmd.py) on the same
inputs: TransformerLM-tiny at 4 layers, sequence 32, batch 4, f32
unless stated, from the port's seed-7 parameters carried to JAX through
convert.py, tokens from ``np.random.default_rng(5)``.

Tolerances: ``step_grads`` with f32 edges against JAX's and against the
port's dense LM, the loss within 1e-6 relative and each gradient leaf
within 1e-5 max abs; compressed cross-slice edges against the dense
gradients within JAX's 5e-4 (bf16) and 5e-3 (int8). The wires decode
bit for bit across the packages. The int8 rounding noise is the port's
counter hash, not ``jax.random``'s, so int8 is held by its properties
(bytes, error within one block step, the error-feedback algebra). The
JAX references run once per module.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.models.transformer import make_transformer as jax_make
from tpu_ddp.ops.optim import SGD as JaxSGD
from tpu_ddp.parallel import mpmd as jmpmd
from tpu_ddp.parallel.compress import EdgeCodec as JaxCodec
from tpu_ddp.parallel.pipeline import stack_block_params as jax_stack
from tpu_ddp.resilience.guard import StepGuard as JaxGuard
from tpu_ddp.train.pipeline import StageScheduler as JaxScheduler
from tpu_ddp_torch import launch
from tpu_ddp_torch.convert import (params_from_jax, params_to_jax,
                                   stacked_from_dense)
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.ops.optim import SGD
from tpu_ddp_torch.parallel import mpmd
from tpu_ddp_torch.parallel.compress import EdgeCodec
from tpu_ddp_torch.parallel.pipeline import stack_block_params
from tpu_ddp_torch.resilience.guard import StepGuard
from tpu_ddp_torch.train.lm import LMTrainer, make_lm_batch
from tpu_ddp_torch.train.pipeline import StageScheduler
from tpu_ddp_torch.utils.tree import keyed_leaves, tree_leaves, tree_unflatten

REPO = Path(__file__).resolve().parent.parent
LAYERS, SEQ, MICRO = 4, 32, 4
LOSS_RTOL, GRAD_ATOL = 1e-6, 1e-5
# JAX's bounds for compressed cross-slice edges (tests/test_mpmd.py:184).
CROSS = {"bf16": (1.99, 5e-4), "int8": (3.5, 5e-3)}
WIRE_SPECS = ("none", "bf16", "int8", "sparse")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(**kw):
    cfg = dict(max_seq_len=SEQ, compute_dtype=torch.float32,
               num_layers=LAYERS)
    cfg.update(kw)
    return make_transformer("TransformerLM-tiny", **cfg)


def _jax_model():
    return jax_make("TransformerLM-tiny", max_seq_len=SEQ,
                    compute_dtype=jnp.float32, num_layers=LAYERS)


def _batch():
    return make_lm_batch(np.random.default_rng(5).integers(
        0, 1024, size=(4, SEQ + 1)))


def _dense():
    """The port's seed-7 parameters, the dense tree as numpy."""
    return params_to_jax(_model().init(torch.Generator().manual_seed(7)))


def _stacked(model=None):
    """The seed-7 parameters as the port's stacked tree on the CPU."""
    model = model or _model()
    return stack_block_params(params_from_jax(model, _dense(),
                                              device="cpu"))


def _numpy(tree) -> list:
    """(path, numpy leaf) pairs in the JAX pytree order."""
    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        tree = params_to_jax(tree)
    return sorted(keyed_leaves(jax.tree.map(np.asarray, tree)))


def _assert_close(got, want, atol):
    g, w = _numpy(got), _numpy(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        assert np.max(np.abs(a - b)) <= atol, (k, np.max(np.abs(a - b)))


def _pipe(pp=2, **kw):
    kw.setdefault("compress", "none")
    return mpmd.MPMDPipeline(kw.pop("model", None) or _model(), pp, SEQ,
                             num_micro=MICRO, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's MPMD step at pp = 2 and 4 (f32 edges), its stage split, its
    scheduler's counts, and three guarded train steps with a NaN at the
    second."""
    x, y = _batch()
    params = jax_stack(jax.tree.map(jnp.asarray, _dense()))
    out = {"split": [jax.tree.map(np.asarray, s)
                     for s in jmpmd.split_stage_params(params, 2)]}
    for pp in (2, 4):
        pipe = jmpmd.MPMDPipeline(_jax_model(), pp, SEQ, num_micro=MICRO,
                                  compress="none")
        loss, grads = pipe.step_grads(params, x, y)
        out[pp] = (float(loss), jax.tree.map(np.asarray, grads))
        if pp == 2:
            pipe.scheduler = JaxScheduler(2, depth=2)
            pipe.step_grads(params, x, y)
            out["sched"] = pipe.scheduler.stats()
            pipe.scheduler = None
            pipe.optimizer = JaxSGD(learning_rate=0.1)
            pipe._chaos_hook = (
                lambda loss, step: float("nan") if step == 1 else loss)
            guard = JaxGuard(max_bad_steps=3, log=lambda s: None)
            p, o = params, pipe.init_state(params)
            flags = []
            for _ in range(3):
                p, o, _, skipped = pipe.train_step(p, o, x, y, guard=guard)
                flags.append(skipped)
            out["guarded"] = (flags, jax.tree.map(np.asarray, p))
    return out


@pytest.fixture(scope="module")
def dense_grads():
    """The port's dense LMTrainer: (loss, stacked gradient tree)."""
    model = _model()
    tr = LMTrainer(model, device="cpu", optimizer=SGD(learning_rate=0.1))
    state = tr.init_state(params=params_from_jax(model, _dense(),
                                                 device="cpu"))
    x, y = tr.put_batch(*_batch())
    loss, _, grads = tr.step_grads(state, x, y)
    return float(loss), stacked_from_dense(
        tree_unflatten(state.params, [g.detach() for g in grads]))


# ---- the stage split -------------------------------------------------------


def test_split_merge_round_trip_matches_jax(jax_ref):
    params = _stacked()
    stages = mpmd.split_stage_params(params, 2)
    assert "embed" in stages[0] and "embed" not in stages[1]
    assert "head" in stages[1] and "head" not in stages[0]
    for got, want in zip(stages, jax_ref["split"]):
        _assert_close(got, want, 0.0)
    back = mpmd.merge_stage_grads(stages)
    for a, b in zip(_numpy(back), _numpy(params)):
        np.testing.assert_array_equal(a[1], b[1])
    with pytest.raises(ValueError, match="divisible"):
        mpmd.split_stage_params(params, 3)


def test_stage_program_refusals_match_jax():
    for make, prog in ((_model, mpmd.StageProgram),
                       (_jax_model, jmpmd.StageProgram)):
        with pytest.raises(ValueError, match="pp_size >= 2"):
            prog(make(), 0, 1, SEQ)
    with pytest.raises(ValueError, match="dropout"):
        mpmd.StageProgram(_model(dropout_rate=0.1), 0, 2, SEQ)


# ---- the edge codec --------------------------------------------------------


def test_none_codec_is_exact():
    c = EdgeCodec("none")
    x = torch.arange(12.0).reshape(3, 4)
    wire, n = c.encode(x)
    assert n == 4 * 12
    assert torch.equal(EdgeCodec.decode(wire), x)


def test_bf16_codec_halves_bytes_and_decodes_as_jax():
    x = np.linspace(-3, 3, 1024, dtype=np.float32).reshape(4, 256)
    c, jc = EdgeCodec("bf16"), JaxCodec("bf16")
    wire, n = c.encode(torch.as_tensor(x))
    jwire, jn = jc.encode(jnp.asarray(x))
    assert n == jn == 2 * 1024 and c.ratio == 2.0
    assert wire["payload"].dtype == torch.uint16
    np.testing.assert_array_equal(wire["payload"].numpy(),
                                  np.asarray(jwire["payload"]))
    np.testing.assert_array_equal(EdgeCodec.decode(wire).numpy(),
                                  np.asarray(JaxCodec.decode(jwire)))


def test_int8_codec_properties():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(4, 256)).astype(np.float32))
    c = EdgeCodec("int8")
    wire, n = c.encode(x)
    # 1 byte per element + one f32 scale per 256-element block, JAX's count.
    assert n == 1024 + 4 * 4 == JaxCodec("int8").encode(
        jnp.asarray(x.numpy()))[1]
    assert c.ratio >= 3.5
    got = EdgeCodec.decode(wire)
    step = wire["scale"].repeat_interleave(256).reshape(4, 256)
    assert bool(((got - x).abs() <= step).all())
    # Error feedback: decode + the new residual = payload + the old one.
    old = c._residual.clone()
    wire2, _ = c.encode(2 * x)
    flat = (2 * x).reshape(-1) + old
    np.testing.assert_allclose(
        (EdgeCodec.decode(wire2).reshape(-1) + c._residual).numpy(),
        flat.numpy(), rtol=0, atol=2 ** -22 * float(flat.abs().max()))
    # The running mean of a constant payload converges with the residual
    # and keeps its noise without (JAX's drift property).
    errs = []
    for spec in ("int8", "int8-noef"):
        c = EdgeCodec(spec)
        acc = torch.zeros_like(x)
        for _ in range(16):
            acc += EdgeCodec.decode(c.encode(x)[0])
        errs.append(float((acc / 16 - x).abs().max()))
    assert errs[0] < 1e-2 and errs[0] < errs[1], errs


def test_codec_reset_and_unknown_spec():
    c = EdgeCodec("int8")
    c.encode(torch.ones(256))
    assert c.bytes_sent > 0 and c._residual is not None
    c.reset()
    assert c.bytes_sent == 0 and c._residual is None
    assert c.describe() == JaxCodec("int8").describe()
    with pytest.raises(ValueError, match="spec"):
        EdgeCodec("fp8")


def test_sparse_codec_is_exact_with_jax_bytes():
    x = np.random.default_rng(1).normal(size=(3, 700)).astype(np.float32)
    x[0, :600] = 0.0
    x[2, 100:650] = 0.0
    c = EdgeCodec("sparse")
    wire, n = c.encode(torch.as_tensor(x))
    assert n == JaxCodec("sparse").encode(jnp.asarray(x))[1]
    assert n < 4 * x.size
    np.testing.assert_array_equal(EdgeCodec.decode(wire).numpy(), x)


# ---- wires across the packages ---------------------------------------------


def _payload(spec, k):
    x = np.random.default_rng(3).normal(size=(2, 512)).astype(np.float32)
    if spec == "sparse":
        x[:, 200:480] = 0.0
    return (k + 1) * x


@pytest.mark.parametrize("spec", WIRE_SPECS)
def test_port_decodes_jax_socket_wires(spec):
    """JAX's SocketEdge sends; the port's decodes each message to the
    values JAX's own decode gives the same wire (a twin codec of the same
    seed), bit for bit. Two sends: the second carries int8's residual."""
    a, b = socket.socketpair()
    try:
        tx = jmpmd.SocketEdge(a, JaxCodec(spec, seed=4))
        twin = JaxCodec(spec, seed=4)
        rx = mpmd.SocketEdge(b)
        for k in range(2):
            x = jnp.asarray(_payload(spec, k))
            tx.send(x)
            want = np.asarray(JaxCodec.decode(twin.encode(x)[0]))
            got = rx.recv()
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("spec", WIRE_SPECS)
def test_jax_decodes_port_socket_wires(spec):
    a, b = socket.socketpair()
    try:
        tx = mpmd.SocketEdge(a, EdgeCodec(spec, seed=4))
        twin = EdgeCodec(spec, seed=4)
        rx = jmpmd.SocketEdge(b)
        for k in range(2):
            x = torch.as_tensor(_payload(spec, k))
            tx.send(x)
            want = EdgeCodec.decode(twin.encode(x)[0]).numpy()
            np.testing.assert_array_equal(np.asarray(rx.recv()), want)
        assert tx.stats()["ratio"] == round(twin.ratio, 3)
    finally:
        a.close()
        b.close()


# ---- topology --------------------------------------------------------------


def test_slice_topology():
    t = mpmd.SliceTopology.even(4, 2)
    assert t.stage_slice == (0, 0, 1, 1)
    assert t.cross_boundaries() == [1]
    assert not t.is_cross(0) and t.is_cross(1) and not t.is_cross(2)
    assert mpmd.SliceTopology.single_slice(4).cross_boundaries() == []
    with pytest.raises(ValueError, match="order"):
        mpmd.SliceTopology((0, 1, 0))
    with pytest.raises(ValueError, match="divisible"):
        mpmd.SliceTopology.even(3, 2)


# ---- the step --------------------------------------------------------------


@pytest.mark.parametrize("pp", [2, 4])
def test_f32_edges_match_jax_and_dense(jax_ref, dense_grads, pp):
    pipe = _pipe(pp)
    loss, grads = pipe.step_grads(_stacked(), *_batch())
    for want_loss, want in (jax_ref[pp], dense_grads):
        assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
        _assert_close(grads, want, GRAD_ATOL)
    st = pipe.edge_stats()
    assert st["cross_boundaries"] == []
    assert all(e["ratio"] == 1.0 and e["spec"] == "none"
               for e in st["down"] + st["up"])
    assert all(e["messages"] == MICRO for e in st["down"] + st["up"])


def test_bf16_edges_are_lossless_at_bf16_compute():
    """Every payload holds bf16 values at bf16 compute (the stage output,
    the cotangent through the cast), so the bf16 wire gives the f32
    edges' bits."""
    model = _model(compute_dtype=torch.bfloat16)
    params = _stacked(model)
    runs = []
    for spec in ("none", "bf16"):
        pipe = _pipe(4, model=model, compress=spec,
                     topology=mpmd.SliceTopology.even(4, 2))
        runs.append(pipe.step_grads(params, *_batch()))
        assert pipe.edge_stats()["up"][1]["ratio"] == (
            2.0 if spec == "bf16" else 1.0)
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(g0), tree_leaves(g1)))


@pytest.mark.parametrize("spec", sorted(CROSS))
def test_compressed_cross_slice_edges(dense_grads, spec):
    min_ratio, tol = CROSS[spec]
    pipe = _pipe(2, compress=spec, topology=mpmd.SliceTopology.even(2, 2))
    loss, grads = pipe.step_grads(_stacked(), *_batch())
    assert np.isfinite(float(loss))
    _assert_close(grads, dense_grads[1], tol)
    st = pipe.edge_stats()
    assert st["cross_boundaries"] == [0]
    for e in st["down"] + st["up"]:
        assert e["spec"] == spec and e["ratio"] >= min_ratio, e


def test_guard_skip_is_a_noop(jax_ref):
    params = _stacked()
    x, y = _batch()
    pipe = _pipe(2, optimizer=SGD(learning_rate=0.1))
    pipe._chaos_hook = lambda loss, step: float("nan") if step == 1 else loss
    guard = StepGuard(max_bad_steps=3, log=lambda s: None)
    opt = pipe.init_state(params)
    flags = []
    for _ in range(3):
        before = [t.clone() for t in tree_leaves(params)
                  + tree_leaves(opt)]
        params, opt, loss, skipped = pipe.train_step(params, opt, x, y,
                                                     guard=guard)
        flags.append(skipped)
        after = tree_leaves(params) + tree_leaves(opt)
        assert all(torch.equal(a, b) for a, b in zip(before, after)) \
            == skipped
    want_flags, want_params = jax_ref["guarded"]
    assert flags == want_flags == [False, True, False]
    assert pipe.skipped_steps == 1
    assert guard.total_skipped == 1 and guard.consecutive == 0
    _assert_close(params, want_params, GRAD_ATOL)


# ---- the scheduler ---------------------------------------------------------


def test_scheduler_counts_match_jax(jax_ref):
    sched = StageScheduler(2, depth=2)
    _pipe(2, scheduler=sched).step_grads(_stacked(), *_batch())
    s0, s1 = sched.stats()["stages"]
    phases = ("warmup", "steady", "cooldown", "idle")
    assert tuple(s0[k] for k in phases) == (2, 2, 2, 0)
    assert tuple(s1[k] for k in phases) == (0, 4, 0, 2)
    for got, want in zip(sched.stats()["stages"],
                         jax_ref["sched"]["stages"]):
        assert {k: got[k] for k in phases + ("ticks",)} == \
            {k: want[k] for k in phases + ("ticks",)}
    assert sched.bubble_fraction(1) == pytest.approx(2 / 6)
    assert s1["bubble_fraction"] == pytest.approx(2 / 6, abs=1e-3)


def test_scheduler_drain_heartbeat_and_depth():
    beats = []
    sched = StageScheduler(2, depth=2, heartbeat=beats.append)
    assert sched.tick(0, fwd=True, bwd=False,
                      handle=torch.ones(4)) == "warmup"
    assert len(sched.windows[0]) <= 2
    sched.step_done(7)
    assert beats == [7] and len(sched.windows[0]) == 0 and sched.steps == 1
    with pytest.raises(ValueError):
        StageScheduler(0)
    with pytest.raises(ValueError, match="depth"):
        StageScheduler(2, depth=-1)


# ---- the two-process drill -------------------------------------------------


def test_two_process_drill_through_the_launcher():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPU_DDP_")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               TPU_DDP_MPMD_COMPRESS="int8", TPU_DDP_MPMD_STEPS="3")
    res = subprocess.run([sys.executable, "-m", "tpu_ddp_torch.launch",
                          "mpmd", "--nproc", "2", "--device", "cpu"],
                         env=env, capture_output=True, text=True,
                         timeout=150, cwd=REPO)
    out = res.stdout + res.stderr
    assert res.returncode == 0, out
    result = [ln for ln in out.splitlines() if "[mpmd] RESULT" in ln]
    assert len(result) == 1 and result[0].endswith("OK"), out
    assert "[rank 1]" in result[0] and "(int8)" in result[0]


def test_launcher_refuses_flags_the_drill_does_not_read():
    with pytest.raises(SystemExit):
        launch.main(["mpmd", "--nproc", "2", "--pp-schedule", "1f1b"])
