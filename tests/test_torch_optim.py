"""The port's optimizer extensions (tpu_ddp_torch/ops/optim.py: Adafactor,
scheduled SGD and AdamW, global-norm clipping, ``warmup_cosine``;
ops/ema.py: EMA) held against the JAX package's on the same numpy-seeded
leaves and gradients, in f32.

Tolerances: rtol 1e-5 / atol 1e-6 on parameters and state after a few
steps. Both sides compute the same f32 expressions; they differ in the
order of the means' sums (XLA against PyTorch) and in the last bit of
f32 ``pow``/``cos``, which the updates carry at the 1e-7 scale. The
schedules themselves agree within rtol 1e-6 (one f32 ulp of ``cos``).
EMA blends in f32 in the same order: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.ops import optim as jopt
from tpu_ddp.ops.ema import EMA as JaxEMA
from tpu_ddp_torch.ops import optim
from tpu_ddp_torch.ops.ema import EMA

RTOL, ATOL = 1e-5, 1e-6
# Leaves that take each Adafactor plan at min_dim_size_to_factor=8: the
# "batch" plan (a matrix, a stack of matrices), the "split" plan (an
# attention-like (dm, 3, H, hd) leaf whose last two dims are small), and
# no factoring (vectors, a small matrix, a scalar-like leaf).
SHAPES = [(16, 12), (3, 8, 10), (16, 3, 2, 4), (12,), (4, 5), (1,)]


def _leaves(seed, shapes=SHAPES, steps=3):
    rng = np.random.default_rng(seed)
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 0.1).astype(np.float32)
              for s in shapes] for _ in range(steps)]
    return params, grads


def _run_jax(opt, params, grads):
    p = [jnp.asarray(x) for x in params]
    state = opt.init(p)
    for g in grads:
        p, state = opt.apply(p, [jnp.asarray(x) for x in g], state)
    return [np.asarray(x) for x in p], jax.tree.map(np.asarray, state)


def _run_port(opt, params, grads):
    p = [torch.tensor(x) for x in params]
    state = opt.init(p)
    for g in grads:
        opt.apply(p, [torch.tensor(x) for x in g], state)
    return [x.numpy() for x in p], state


def _close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.shape(g) == np.shape(w), (what, i)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}[{i}]")


@pytest.mark.parametrize("kw", [
    dict(),                                         # relative step size
    dict(learning_rate=1e-2),                       # explicit lr
    dict(learning_rate="schedule"),                 # warmup_cosine lr
    dict(b1=0.9),                                   # first moment
    dict(weight_decay=0.1, learning_rate=1e-2),     # decoupled decay
    dict(decay_rate=0.5, clip_threshold=0.5, eps2=1e-2),
], ids=["relative", "explicit", "schedule", "b1", "decay", "knobs"])
def test_adafactor_matches_jax(kw):
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("learning_rate") == "schedule":
        jkw["learning_rate"] = jopt.warmup_cosine(1e-2, 2, 6)
        tkw["learning_rate"] = optim.warmup_cosine(1e-2, 2, 6)
    params, grads = _leaves(1)
    jp, js = _run_jax(jopt.Adafactor(min_dim_size_to_factor=8, **jkw),
                      params, grads)
    tp, ts = _run_port(optim.Adafactor(min_dim_size_to_factor=8, **tkw),
                       params, grads)
    _close(tp, jp, "param")
    for slot in ("vr", "vc", "v", "mu"):
        _close([t.numpy() for t in ts[slot]], js[slot], slot)
    assert ts["count"] == int(js["count"]) == 3


@pytest.mark.parametrize("m", [8, 128])
def test_adafactor_plans_and_slots_match_jax(m):
    """Plan, view shape and every slot's shape and dtype, leaf by leaf,
    at two factoring thresholds (SHAPES and TransformerLM-large's
    leaves)."""
    shapes = SHAPES + [(2048, 3, 16, 128), (16, 128, 2048), (32000, 2048),
                       (2048,)]
    j = jopt.Adafactor(min_dim_size_to_factor=m, b1=0.9)
    t = optim.Adafactor(min_dim_size_to_factor=m, b1=0.9)
    jstate = j.init([jnp.zeros(s, jnp.float32) for s in shapes])
    for i, s in enumerate(shapes):
        assert t.plan(s) == j._plan(s), s
        assert t.view_shape(s) == j._view_shape(s), s
        slots = t.slot_shapes(s)
        for k in ("vr", "vc", "v", "mu"):
            assert slots[k] == tuple(jstate[k][i].shape), (s, k)
    tstate = t.init([torch.zeros(s) for s in SHAPES])
    for k in ("vr", "vc", "v", "mu"):
        assert [tuple(x.shape) for x in tstate[k]] == [
            t.slot_shapes(s)[k] for s in SHAPES]
        assert all(x.dtype == torch.float32 for x in tstate[k])


def test_warmup_cosine_matches_jax():
    """On a host count (numpy f32) and on a device count (a tensor)."""
    for args in ((3e-3, 7, 50), (1e-2, 2, 6, 1e-4)):
        j, t = jopt.warmup_cosine(*args), optim.warmup_cosine(*args)
        steps = np.arange(1, args[2] + 5)
        want = np.array([float(j(jnp.float32(s))) for s in steps])
        host = np.array([float(t(int(s))) for s in steps])
        dev = t(torch.tensor(steps, dtype=torch.int32)).numpy()
        np.testing.assert_allclose(host, want, rtol=1e-6)
        np.testing.assert_allclose(dev, want, rtol=1e-6)
    with pytest.raises(ValueError):
        optim.warmup_cosine(1e-3, 5, 5)


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_scheduled_optimizers_match_jax(name):
    params, grads = _leaves(2, steps=4)
    if name == "sgd":
        j = jopt.SGD(learning_rate=jopt.warmup_cosine(0.1, 2, 6))
        t = optim.SGD(learning_rate=optim.warmup_cosine(0.1, 2, 6))
    else:
        j = jopt.AdamW(learning_rate=jopt.warmup_cosine(1e-2, 2, 6))
        t = optim.AdamW(learning_rate=optim.warmup_cosine(1e-2, 2, 6))
    jp, js = _run_jax(j, params, grads)
    tp, ts = _run_port(t, params, grads)
    _close(tp, jp, "param")
    slots = ("momentum",) if name == "sgd" else ("mu", "nu")
    for k in slots:
        _close([x.numpy() for x in ts[k]], js[k], k)
    assert int(ts["count"]) == int(js["count"]) == 4
    if name == "sgd":
        # Scheduled SGD keeps its count on the device, as an int32.
        assert isinstance(ts["count"], torch.Tensor)
        assert ts["count"].dtype == torch.int32


def test_scheduled_sgd_under_the_guard():
    """A skipped step leaves params, momentum and the count as they were;
    a healthy flagged step equals the unflagged one bit for bit."""
    params, grads = _leaves(3, steps=2)
    sched = optim.warmup_cosine(0.1, 2, 6)
    opt = optim.SGD(learning_rate=sched)
    a = [torch.tensor(x) for x in params]
    b = [torch.tensor(x) for x in params]
    sa, sb = opt.init(a), opt.init(b)
    g = [torch.tensor(x) for x in grads[0]]
    opt.apply(a, g, sa)
    opt.apply(b, g, sb, skip=torch.zeros(()))
    for x, y in zip(a + sa["momentum"], b + sb["momentum"]):
        assert torch.equal(x, y)
    before = [x.clone() for x in b + sb["momentum"]]
    opt.apply(b, [torch.tensor(x) for x in grads[1]], sb,
              skip=torch.ones(()))
    for x, y in zip(before, b + sb["momentum"]):
        assert torch.equal(x, y)
    assert int(sb["count"]) == 1


def test_pallas_sgd_with_a_schedule_raises():
    with pytest.raises(ValueError, match="static lr"):
        optim.SGD(learning_rate=optim.warmup_cosine(0.1, 1, 5),
                  use_pallas=True)
    with pytest.raises(ValueError, match="static lr"):
        jopt.SGD(learning_rate=jopt.warmup_cosine(0.1, 1, 5),
                 use_pallas=True)


@pytest.mark.parametrize("clip", [0.1, 1.0, 1e3])
def test_clip_matches_jax(clip):
    """The global-norm scale and the clipped leaves (an f32 and a bf16
    leaf: each keeps its dtype), clipping and not clipping."""
    rng = np.random.default_rng(4)
    g32 = rng.normal(size=(5, 7)).astype(np.float32)
    g16 = rng.normal(size=(9,)).astype(np.float32)
    jg = [jnp.asarray(g32), jnp.asarray(g16, jnp.bfloat16)]
    tg = [torch.tensor(g32), torch.tensor(g16).bfloat16()]
    jsq = sum(jnp.sum(jnp.square(g.astype(jnp.float32))) for g in jg)
    jscale = jopt.clip_scale_from_sq(jsq, clip)
    want = jopt.clip_tree(jg, jscale)
    sq = optim.global_sq_norm(tg)
    np.testing.assert_allclose(float(sq), float(jsq), rtol=1e-6)
    scale = optim.clip_scale_from_sq(sq, clip)
    np.testing.assert_allclose(float(scale), float(jscale), rtol=1e-6)
    got = optim.clip_by_global_norm(tg, clip)
    assert got is tg and tg[1].dtype == torch.bfloat16
    np.testing.assert_allclose(tg[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tg[1].float().numpy(),
                                  np.asarray(want[1], np.float32))
    # A non-finite sum gives a non-finite scale, as in JAX.
    assert not torch.isfinite(optim.clip_scale_from_sq(
        torch.tensor(float("nan")), clip))


@pytest.mark.parametrize("warmup", [True, False])
def test_ema_matches_jax(warmup):
    rng = np.random.default_rng(5)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": (rng.normal(size=(5,)).astype(np.float32),)}
    js = JaxEMA(0.99, warmup).init(jax.tree.map(jnp.asarray, tree))
    ema = EMA(0.99, warmup)
    ts = ema.init({"a": torch.tensor(tree["a"]),
                   "b": (torch.tensor(tree["b"][0]),)})
    for _ in range(12):
        q = {"a": rng.normal(size=(3, 4)).astype(np.float32),
             "b": (rng.normal(size=(5,)).astype(np.float32),)}
        js = JaxEMA(0.99, warmup).update(js, jax.tree.map(jnp.asarray, q))
        ts = ema.update(ts, {"a": torch.tensor(q["a"]),
                             "b": (torch.tensor(q["b"][0]),)})
    got = EMA.params(ts)
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(js["ema"]["a"]))
    np.testing.assert_array_equal(got["b"][0].numpy(),
                                  np.asarray(js["ema"]["b"][0]))
    assert ts["count"] == int(js["count"]) == 12
    # A bf16 average stays bf16 (the blend runs in f32).
    s16 = ema.init([torch.zeros(4, dtype=torch.bfloat16)])
    ema.update(s16, [torch.ones(4)])
    assert s16["ema"][0].dtype == torch.bfloat16
