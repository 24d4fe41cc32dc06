"""K steps per dispatch on every rung (tpu_ddp_torch/train/engine.py
``build_multi_step``, tpu_ddp_torch/train/capture.py) and the LM
trainer's K-step call (tpu_ddp_torch/train/lm.py ``build_multi_step``)
on the CPU, where each group is the plain loop the card's CUDA graph
replays, held to the JAX package's scanned K steps.

- A grouped epoch at K = 2 over 5 batches (two groups and a single-step
  tail) on each rung at 2 gloo ranks (tests/torch_ranks.py), with the
  bf16 wire, the int8 wire and bucketed overlap, and part 3 at 4 ranks:
  the same lines and state bits as the per-step epoch, and JAX's
  grouped epoch within the ladder's rtol 1e-4 / atol 1e-5
  (tests/test_torch_train.py states its margin). The five rungs and
  overlap are held to JAX's part 3 (``fused``) epoch: every rung
  applies the mean of the replicas' gradients, and the rungs agree with
  each other within the same tolerance (tests/test_torch_ladder4.py).
  The bf16 wire's parameters are held to JAX's bf16 epoch within the
  JAX suite's own bf16 bound, 5e-3 absolute (tests/test_torch_compress.py
  cuts it to 1e-3 over two steps; over five the one-unit bf16 flips of
  the two sides compound, 3.1e-3 measured here); the int8 wire, whose
  rounding noise is not ``jax.random``'s, by the per-step epoch and by
  its carry, which advances once per step.
- One step of each of those: every state tensor whose bits it changed
  is one the trainer writes in place (``_graph_written``, what a CUDA
  graph replays into), and under the int8 wire the carry keeps its
  tensors across a step and across a guard-skipped one, and its values
  across the skip.
- ``LMTrainer.build_multi_step(k)`` for k = 1, 2, 3 (replicated),
  ``grad_accum=2`` and zero1 at 2 gloo ranks: k single steps bit for
  bit, and JAX's ``build_multi_step`` within tests/test_torch_lm.py's
  bounds (losses 1e-5 relative, parameters and both moments 1e-4).
- AdamW's and Adafactor's device step count through the JAX checkpoint
  format (an int32) and back, resuming bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from test_torch_lm import SEQ, _assert_tree, _host, _models, _tokens
from tpu_ddp.parallel.mesh import make_mesh
from tpu_ddp.train.lm import LMTrainer as JaxLMTrainer
from tpu_ddp_torch.convert import params_from_jax, params_to_jax
from tpu_ddp_torch.ops.optim import Adafactor, AdamW
from tpu_ddp_torch.train.lm import LMTrainer, make_lm_batch
from tpu_ddp_torch.utils.tree import tree_unflatten

RTOL, ATOL = 1e-4, 1e-5
BF16_ATOL = 5e-3
SMALL_MB = 0.004  # several buckets on the tiny VGG (test_torch_overlap.py)
K, STEPS = 2, 5

CASES = {
    "part2a": {"strategy": "part2a"},
    "part2b": {"strategy": "part2b"},
    "part3": {"strategy": "part3"},
    "part4": {"strategy": "part4"},
    "part5": {"strategy": "part5"},
    "bf16": {"strategy": "part3", "cfg": {"grad_compress": "bf16"}},
    "int8": {"strategy": "part3", "cfg": {"grad_compress": "int8"}},
    "overlap": {"strategy": "part3",
                "cfg": {"overlap": True, "bucket_mb": SMALL_MB}},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ladder(tmp_path_factory):
    """Every 2-rank case in one gloo run, part 3 at 4 ranks in another,
    and the JAX grouped epochs they are held to."""
    tmp = tmp_path_factory.mktemp("capture")
    two = torch_ranks.make_inputs(tmp / "w2", world=2, steps=STEPS)
    four = torch_ranks.make_inputs(tmp / "w4", world=4, steps=STEPS,
                                   batch=2)
    # The gloo runs go on while the JAX epochs compile and run here.
    w2 = torch_ranks.start_epochs(tmp, 2, CASES, two[3], two[4], tag="w2")
    w4 = torch_ranks.start_epochs(tmp, 4, {"part3": CASES["part3"]},
                                  four[3], four[4], tag="w4")
    out = {"jax": torch_ranks.run_jax_epoch("fused", 2, *two[:3], K),
           "jax_bf16": torch_ranks.run_jax_epoch(
               "fused", 2, *two[:3], K, grad_compress="bf16"),
           "jax_w4": torch_ranks.run_jax_epoch("fused", 4, *four[:3], K)}
    out["w2"], out["w4"] = w2(), w4()
    return out


def _grouped_equals_per_step(rec, name):
    """The K-step epoch took the grouped path and equals the per-step
    epoch: the lines, the iteration count and every state leaf's bits."""
    g, s = f"{name}/k{K}/", f"{name}/k1/"
    assert bool(rec[g + "grouped"]) and not bool(rec[s + "grouped"])
    assert int(rec[g + "iters"]) == int(rec[s + "iters"]) == STEPS
    keys = sorted(k[len(g):] for k in rec if k.startswith(g))
    assert keys == sorted(k[len(s):] for k in rec if k.startswith(s))
    keys.remove("grouped")
    for key in keys:
        assert rec[g + key].tobytes() == rec[s + key].tobytes(), key
    return {k: rec[g + k] for k in keys}


def _against_jax(got, want, rtol, atol, what,
                 parts=("params", "opt_state")):
    keys = [k for p in parts for k in torch_ranks.state_keys(want, p)]
    assert keys and set(keys) <= set(got)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")
    assert int(got["iters"]) == int(want["iters"]) == STEPS


@pytest.mark.parametrize("name", list(CASES))
def test_grouped_epoch_on_each_rung_at_two_ranks(ladder, name):
    ranks = ladder["w2"]
    recs = [_grouped_equals_per_step(r, name) for r in ranks]
    for k in torch_ranks.state_keys(recs[0], "params"):
        assert recs[1][k].tobytes() == recs[0][k].tobytes(), k
    if name == "int8":
        # The carry advanced once per step of the epoch.
        assert int(recs[0]["comp_state.seed"]) == 89395 + STEPS
        return
    if name == "bf16":
        _against_jax(recs[0], ladder["jax_bf16"], 0, BF16_ATOL, name,
                     parts=("params",))
        return
    _against_jax(recs[0], ladder["jax"], RTOL, ATOL, name)


def test_grouped_part3_at_four_ranks(ladder):
    recs = [_grouped_equals_per_step(r, "part3") for r in ladder["w4"]]
    for r in recs[1:]:
        for k in torch_ranks.state_keys(recs[0], "params"):
            assert r[k].tobytes() == recs[0][k].tobytes(), k
    _against_jax(recs[0], ladder["jax_w4"], RTOL, ATOL, "part3 x4")


@pytest.mark.parametrize("name", list(CASES))
def test_written_covers_what_a_step_changes(ladder, name):
    for rec in ladder["w2"]:
        assert int(rec[name + "/changed"]) > 0
        assert bool(rec[name + "/written_covers"])


def test_int8_carry_is_written_in_place(ladder):
    for rec in ladder["w2"]:
        assert bool(rec["int8/carry_in_place"])
        assert bool(rec["int8/carry_kept_on_skip"])


# ---- the LM trainer's K-step call ----------------------------------------


def _lm_pair(**kw):
    """A JAX LM trainer on a 1-device mesh, a port one on the CPU from
    the same weights, and the JAX start state."""
    jm, tm = _models()
    jt = JaxLMTrainer(jm, make_mesh(jax.devices()[:1]), **kw)
    jstate = jt.init_state(seed=0)
    tt = LMTrainer(tm, device="cpu", **kw)
    return jt, jstate, tt, _host(jstate.params)


def _lm_batches(k, b=4, seed=3):
    rng = np.random.default_rng(seed)
    pairs = [make_lm_batch(rng.integers(0, 1024, size=(b, SEQ + 1)))
             for _ in range(k)]
    return np.stack([x for x, _ in pairs]), np.stack([y for _, y in pairs])


def _lm_bits(tt, state):
    host = tt.state_to_host(state)
    return [np.asarray(v).tobytes() for v in jax.tree.leaves(host)]


@pytest.mark.parametrize("k,accum", [(1, 1), (2, 1), (3, 1), (2, 2)])
def test_lm_multi_step_matches_single_steps_and_jax(k, accum):
    jt, jstate, tt, jparams = _lm_pair(grad_accum=accum)
    xs, ys = _lm_batches(k)
    state = tt.init_state(params=params_from_jax(tt.model, jparams, "cpu"))
    single = []
    for j in range(k):
        state, loss = tt.train_step(state, *tt.put_batch(xs[j], ys[j]))
        single.append(loss)
    want = _lm_bits(tt, state)
    multi = tt.build_multi_step(k)
    assert tt.build_multi_step(k) is multi
    state = tt.init_state(params=params_from_jax(tt.model, jparams, "cpu"))
    state, losses = multi(state, torch.as_tensor(xs), torch.as_tensor(ys))
    assert state.step == k and losses.shape == (k,)
    assert losses.tolist() == torch.stack(single).tolist()
    assert _lm_bits(tt, state) == want
    jstate, jlosses = jt.build_multi_step(k)(jstate, jnp.asarray(xs),
                                              jnp.asarray(ys))
    np.testing.assert_allclose(losses.numpy(),
                               np.asarray(jlosses).reshape(k), rtol=1e-5)
    _assert_tree(tt.params_to_host(state), jt.params_to_host(jstate), 1e-4,
                 "param")
    jopt = _host(jstate.opt_state)
    assert int(state.opt_state["count"]) == int(jopt["count"]) == k
    for name in ("mu", "nu"):
        _assert_tree(params_to_jax(tree_unflatten(
            state.params, state.opt_state[name])), jopt[name], 1e-4, name)


LM_WORKER = r"""
import json, os, sys
import numpy as np
import torch
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.parallel.bootstrap import init_distributed_setup
from tpu_ddp_torch.train.lm import LMTrainer
from tpu_ddp_torch.utils.tree import keyed_leaves

torch.set_num_threads(1)
spec = json.loads(sys.argv[1])
rank, world = int(sys.argv[2]), spec["world"]
init_distributed_setup("127.0.0.1", spec["port"], rank, world,
                       device="cpu", ddp=True, timeout_s=90)
d = np.load(spec["data"])
xs = torch.from_numpy(d["x"][:, rank])
ys = torch.from_numpy(d["y"][:, rank])
model = make_transformer("TransformerLM-tiny", compute_dtype=torch.float32,
                         max_seq_len=spec["seq"])
tr = LMTrainer(model, device="cpu", opt_sharding="zero1")
out = {}
st = tr.init_state(seed=0)
losses = []
for j in range(len(xs)):
    st, loss = tr.train_step(st, xs[j], ys[j])
    losses.append(loss)
out["single/losses"] = torch.stack(losses).numpy()
for key, v in keyed_leaves(tr.state_to_host(st)):
    out["single/" + key] = np.asarray(v)
st, losses = tr.build_multi_step(len(xs))(tr.init_state(seed=0), xs, ys)
out["multi/losses"] = losses.numpy()
for key, v in keyed_leaves(tr.state_to_host(st)):
    out["multi/" + key] = np.asarray(v)
np.savez(spec["out"] + f".{rank}.npz", **out)
torch.distributed.barrier()
sys.stdout.flush()
os._exit(0)
"""


def test_lm_multi_step_zero1_at_two_ranks(tmp_path):
    """zero1 at 2 gloo ranks, K = 2: the grouped call equals two single
    steps bit for bit on each rank, and JAX's zero1 ``build_multi_step``
    on a 2-device mesh from the port's seed-0 weights within the bounds
    above (each rank's loss against its shard's)."""
    k, world = 2, 2
    xs, ys = _lm_batches(k, b=4 * world, seed=7)
    data = tmp_path / "lm.npz"
    # Rank r takes rows [4r, 4r + 4) of each step, as the mesh's dp shard.
    np.savez(data, x=xs.reshape(k, world, 4, SEQ),
             y=ys.reshape(k, world, 4, SEQ))
    spec = {"world": world, "port": str(torch_ranks.free_port()),
            "data": str(data), "seq": SEQ, "out": str(tmp_path / "lm")}
    torch_ranks.run_ranks(
        lambda r: ["-c", LM_WORKER, json.dumps(spec), str(r)], world)
    recs = []
    for r in range(world):
        with np.load(f"{tmp_path / 'lm'}.{r}.npz") as f:
            recs.append({key: f[key] for key in f.files})
    for rec in recs:
        for key in [x for x in rec if x.startswith("single/")]:
            assert rec[key].tobytes() == \
                rec["multi/" + key[len("single/"):]].tobytes(), key
    jm, tm = _models()
    params = LMTrainer(tm, device="cpu").init_state(seed=0).params
    jparams = jax.tree.map(jnp.asarray, params_to_jax(params))
    jt = JaxLMTrainer(jm, make_mesh(jax.devices()[:world]),
                      opt_sharding="zero1")
    jstate = jt._place_state(jparams, jt.optimizer.init(jparams))
    jstate, jlosses = jt.build_multi_step(k)(jstate, jnp.asarray(xs),
                                              jnp.asarray(ys))
    jl = np.asarray(jlosses).reshape(k, world)
    for r, rec in enumerate(recs):
        np.testing.assert_allclose(rec["multi/losses"], jl[:, r],
                                   rtol=1e-5)
    want = jt.params_to_host(jstate)
    got = {key[len("multi/params."):]: v for key, v in recs[0].items()
           if key.startswith("multi/params.")}
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(got)
    for path, w in flat:
        key = jax.tree_util.keystr(path, simple=True, separator=".")
        np.testing.assert_allclose(got[key], w, rtol=1e-4, atol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("opt", [AdamW(), Adafactor()],
                         ids=["adamw", "adafactor"])
def test_device_count_round_trips_and_resumes(tmp_path, opt):
    """The count is a 0-d int32 device tensor, advanced in place; the JAX
    checkpoint format holds it as an int32, and a trainer restored from
    that checkpoint takes its next step bit for bit as the original."""
    _, tm = _models()
    tt = LMTrainer(tm, device="cpu", optimizer=opt)
    state = tt.init_state(seed=0)
    count = state.opt_state["count"]
    assert count.dtype == torch.int32 and count.dim() == 0
    x, y = tt.put_batch(*make_lm_batch(_tokens(4, seed=9)))
    for _ in range(2):
        state, _ = tt.train_step(state, x, y)
    assert state.opt_state["count"] is count and int(count) == 2
    host = tt.state_to_host(state)
    assert host["opt_state"]["count"].dtype == np.int32
    assert int(host["opt_state"]["count"]) == 2
    tt.save_checkpoint(str(tmp_path), state)
    back = tt.restore_checkpoint(str(tmp_path))
    assert back.opt_state["count"].dtype == torch.int32
    assert int(back.opt_state["count"]) == 2 and back.step == 2
    state, loss = tt.train_step(state, x, y)
    back, loss2 = tt.train_step(back, x, y)
    assert torch.equal(loss, loss2)
    assert _lm_bits(tt, back) == _lm_bits(tt, state)
