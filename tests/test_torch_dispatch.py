"""The port's epoch loop with the dispatch window, K steps per dispatch
and sharded evaluation (tpu_ddp_torch/train/engine.py) held to the JAX
package's ``Trainer`` (tpu_ddp/train/engine.py:1099-1891) on the CPU: a
tiny VGG with both kernel knobs (their plain versions here, the Pallas
kernels in interpret mode on the JAX side), f32, the same weights and
batches.

Tolerance against JAX: the VGG ladder's (tests/test_torch_train.py),
rtol 1e-4 / atol 1e-5 on parameters; the printed lines (3 decimals) are
equal. Within the port, depths 2 and 4 and K-step groups are held to
depth 0 and to single steps bit for bit. On the CPU every handle is
ready at once, so the window is driven through a fake event per step
(``Trainer._handle`` patched): each step's result then waits in the
window until a forced wait, as a step on the card does.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.data.loader import DataLoader as JaxLoader
from tpu_ddp.data.loader import create_data_loaders as jax_loaders
from tpu_ddp.data.sampler import DistributedShardSampler as JaxSampler
from tpu_ddp.models.vgg import VGGModel as JaxVGG
from tpu_ddp.parallel.mesh import make_mesh
from tpu_ddp.train.engine import Trainer as JaxTrainer
from tpu_ddp.utils.config import TrainConfig as JaxConfig
from tpu_ddp_torch.convert import image_params_from_jax
from tpu_ddp_torch.data.loader import create_data_loaders
from tpu_ddp_torch.models.vgg import VGGModel
from tpu_ddp_torch.resilience.guard import TrainingDivergedError
from tpu_ddp_torch.train.engine import Trainer
from tpu_ddp_torch.utils.config import TrainConfig
from tpu_ddp_torch.utils.tree import keyed_leaves

import torch_ranks

TINY = (8, "M", 16, "M", 16, "M", 16, "M", 16, "M")
KNOBS = dict(pallas_sgd=True, pallas_bn=True, compute_dtype="float32")
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeEvent:
    waits = 0

    def __init__(self):
        self.ready = False

    def query(self):
        return self.ready

    def synchronize(self):
        FakeEvent.waits += 1
        self.ready = True


@pytest.fixture
def lagging(monkeypatch):
    """Every step's handle waits on an event that is done only after a
    forced wait."""
    FakeEvent.waits = 0
    monkeypatch.setattr(Trainer, "_handle",
                        lambda self, bundle: (bundle, FakeEvent()))
    return FakeEvent


def _host(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _port(**kw):
    tt = Trainer(VGGModel("tiny", TINY, compute_dtype=torch.float32,
                          use_pallas_bn=True),
                 TrainConfig(**KNOBS, **kw), device="cpu")
    return tt, tt.init_state()


def _pair(**kw):
    """A JAX trainer and a port trainer on the JAX init; the port's
    starting host tree (for resets)."""
    jt = JaxTrainer(JaxVGG(name="tiny", cfg=TINY, compute_dtype=jnp.float32,
                           use_pallas_bn=True),
                    JaxConfig(**KNOBS, **kw), strategy="none")
    jstate = jt.init_state()
    tt, state = _port(**kw)
    tt.model.load_state_dict(image_params_from_jax(
        tt.model, _host(jstate.params), device="cpu"))
    return jt, jstate, tt, tt.state_to_host(state)


def _assert_params(model, jparams):
    want = image_params_from_jax(model, _host(jparams), device="cpu")
    got = model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def _bits(tt, state):
    return {k: np.asarray(v).tobytes()
            for k, v in keyed_leaves(tt.state_to_host(state))}


def _untimed(lines):
    return [ln for ln in lines if "timing over iterations" not in ln]


def test_depths_match_jax_and_depth_zero(lagging):
    """Six iterations, the timing window 1-2, at depths 0, 2 and 4: the
    port prints JAX's lines at every depth, its params stay within the
    stated tolerance of JAX's, and depths 2 and 4 end with depth 0's
    bits. The window really lags: depth 4 forces one wait (the drain)
    where depth 0 forces one per step."""
    jt, jstate0, tt, host0 = _pair(log_every=1, global_batch_size=8,
                                   max_iters=6, timing_first_iter=1,
                                   timing_last_iter=2)
    jhost0 = jt.state_to_host(jstate0)
    jtrain, _ = jax_loaders(batch_size=8, synthetic_size=48, native=False)
    train, _ = create_data_loaders(batch_size=8, synthetic_size=48)
    bits, syncs = {}, {}
    for depth in (0, 2, 4):
        jt.config.dispatch_depth = tt.config.dispatch_depth = depth
        jlines, lines = [], []
        jstate, _ = jt.train_epoch(jt.state_from_host(jhost0), jtrain,
                                   log=jlines.append)
        state, stats = tt.train_epoch(tt.state_from_host(host0), train,
                                      log=lines.append)
        assert _untimed(lines) == _untimed(jlines) and len(lines) == 7
        _assert_params(tt.model, jstate.params)
        bits[depth] = _bits(tt, state)
        syncs[depth] = (stats["forced_syncs"], stats["sync_deliveries"],
                        stats["max_in_flight"])
    assert bits[2] == bits[0] and bits[4] == bits[0]
    # Depth 0: every step forced. Depths 2 and 4: iterations 0-2
    # synchronous, 3-5 wait in the window: at depth 2 the third
    # overflows it, at depth 4 the end-of-epoch drain takes them.
    assert syncs == {0: (6, 0, 1), 2: (1, 3, 3), 4: (1, 3, 3)}


def test_metrics_epoch_record_carries_the_window(lagging):
    tt, state = _port(global_batch_size=4, max_iters=5, dispatch_depth=2,
                      timing_first_iter=1, timing_last_iter=0)
    batches = [(torch.randn(4, 3, 32, 32), torch.tensor([1, 2, 3, 4]))] * 5
    _, stats = tt.train_epoch(state, batches, log=lambda s: None)
    rec = [e for e in tt.metrics.events if e["event"] == "epoch"][0]
    for key in ("dispatch_depth", "forced_syncs", "sync_deliveries",
                "host_gap_ms", "harvested", "max_in_flight"):
        assert rec[key] == stats[key], key
    assert stats["harvested"] == 5
    assert tt.metrics.gauge_summary("host_gap_ms")["count"] == 1


def test_guard_records_in_step_order(lagging):
    """Harvest order is step order: the guard sees steps 1..7, once
    each, at depth 2."""
    tt, state = _port(global_batch_size=4, dispatch_depth=2,
                      timing_first_iter=1, timing_last_iter=0)
    seen = []

    class Recorder:
        def record(self, step, skipped, loss):
            seen.append((step, skipped))

    tt.guard = Recorder()
    rng = np.random.default_rng(0)
    batches = [(torch.from_numpy(rng.normal(size=(4, 3, 32, 32))
                                 .astype(np.float32)),
                torch.tensor([0, 1, 2, 3])) for _ in range(7)]
    tt.train_epoch(state, batches, log=lambda s: None)
    assert seen == [(s, False) for s in range(1, 8)]


@pytest.mark.parametrize("depth", [0, 2, 4])
def test_divergence_raises_at_most_depth_late(lagging, depth):
    """Two NaN steps in a row raise at harvest: the loop pulls at most
    ``depth`` batches past the one whose step trips the guard."""
    max_bad = 2
    tt, state = _port(global_batch_size=4, dispatch_depth=depth,
                      guard_max_bad_steps=max_bad, timing_first_iter=1,
                      timing_last_iter=0)
    consumed = [0]

    def gen():
        for i in range(12):
            consumed[0] += 1
            x = torch.randn(4, 3, 32, 32)
            if i >= 1:
                x = torch.full_like(x, float("nan"))
            yield x, torch.tensor([0, 1, 2, 3])

    with pytest.raises(TrainingDivergedError):
        tt.train_epoch(state, gen(), log=lambda s: None)
    assert consumed[0] <= 1 + max_bad + depth, consumed[0]


def test_forced_waits_per_window(lagging):
    """Nine iterations, only iteration 0 synchronous: at most
    ceil(8 / depth) + 1 forced waits, each ONE synchronize on the newest
    event."""
    for depth in (1, 2, 3):
        tt, state = _port(global_batch_size=4, max_iters=9,
                          dispatch_depth=depth, timing_first_iter=1,
                          timing_last_iter=0)
        lagging.waits = 0
        batches = [(torch.randn(4, 3, 32, 32),
                    torch.tensor([0, 1, 2, 3]))] * 9
        _, stats = tt.train_epoch(state, batches, log=lambda s: None)
        assert stats["forced_syncs"] <= -(-8 // depth) + 1
        assert lagging.waits == stats["forced_syncs"] + 1  # + iteration 0


def _batches(n, seed=5, b=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, b, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(n, b)).astype(np.int32)
    return x, y


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_multi_step_matches_single_steps_and_jax(k):
    """``build_multi_step(k)`` on one group: the port's K steps equal K
    single port steps bit for bit (losses, params, momentum, the (K, 2)
    rows), and JAX's scanned K steps within the tolerance."""
    jt, jstate, tt, host0 = _pair(global_batch_size=4)
    x, y = _batches(k)
    state = tt.state_from_host(host0)
    single = []
    for j in range(k):
        state, loss = tt.train_step(state, _nchw(x[j]),
                                    torch.from_numpy(y[j]).long())
        single.append(float(loss))
    want = _bits(tt, state)
    state = tt.state_from_host(host0)
    multi = tt.build_multi_step(k)
    assert tt.build_multi_step(k) is multi  # memoised per k
    xs, ys = tt.put_batches([_nchw(x[j]) for j in range(k)],
                            [torch.from_numpy(y[j]).long()
                             for j in range(k)])
    assert xs[0].stride() == _nchw(x[0]).stride()
    state, losses = multi(state, xs, ys)
    assert state.step == k
    assert losses.tolist() == single
    assert tuple(tt._last_fused.shape) == (k, 2)
    assert _bits(tt, state) == want
    jmulti = jt.build_multi_step(k)
    jstate, jlosses = jmulti(jstate, *jt.put_batches(x, y))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=RTOL, atol=ATOL)
    _assert_params(tt.model, jstate.params)
    with pytest.raises(ValueError):
        tt.build_multi_step(0)


def test_grouped_epoch_matches_per_step_and_jax():
    """An epoch at K = 3 over 7 batches (two groups and a single-step
    tail): the same lines as the per-step epoch and as JAX's grouped
    epoch, the same bits as the per-step epoch, and stop_many's
    timing (iterations 1-5 timed: the first group holds the start)."""
    kw = dict(log_every=1, global_batch_size=8, max_iters=7,
              timing_first_iter=1, timing_last_iter=5)
    jt, jstate0, tt, host0 = _pair(**kw)
    jtrain, _ = jax_loaders(batch_size=8, synthetic_size=56, native=False)
    train, _ = create_data_loaders(batch_size=8, synthetic_size=56)
    runs = {}
    for k in (1, 3):
        tt.config.steps_per_dispatch = jt.config.steps_per_dispatch = k
        lines, jlines = [], []
        state, stats = tt.train_epoch(tt.state_from_host(host0), train,
                                      log=lines.append)
        jstate, jstats = jt.train_epoch(
            jt.state_from_host(jt.state_to_host(jstate0)), jtrain,
            log=jlines.append)
        assert _untimed(lines) == _untimed(jlines)
        assert stats["timed_iters"] == jstats["timed_iters"]
        _assert_params(tt.model, jstate.params)
        runs[k] = (_untimed(lines), _bits(tt, state), stats["iters"])
    assert runs[3] == runs[1]
    assert runs[3][2] == 7


def test_grouped_path_gates():
    """K > 1 takes the grouped loop only where JAX does: not under an
    in-loop cadence, device prefetch or chaos."""
    calls = []
    for over in ({}, {"ckpt_every_iters": 2}, {"check_replicas_every": 2},
                 {"device_prefetch": 2}):
        tt, state = _port(global_batch_size=4, max_iters=4,
                          steps_per_dispatch=2, **over)
        real = tt._train_epoch_multi

        def spy(*a, real=real, **k):
            calls.append(over)
            return real(*a, **k)

        tt._train_epoch_multi = spy
        batches = [(torch.randn(4, 3, 32, 32),
                    torch.tensor([0, 1, 2, 3]))] * 4
        state, stats = tt.train_epoch(state, batches, log=lambda s: None)
        assert state.step == 4
    assert calls == [{}]


def test_card_capture_refuses_what_it_cannot_capture(monkeypatch):
    """On the card every rung and every remat mode takes the graph route
    (the call is built; capturing it needs the card), and what the card
    still cannot capture, the LM's dropout, raises naming its item
    (9.5c); none runs eager steps under K > 1."""
    from tpu_ddp_torch.models.transformer import make_transformer
    from tpu_ddp_torch.train.lm import LMTrainer
    tt, _ = _port()
    monkeypatch.setattr(tt, "device", torch.device("cuda", 0))
    for strategy in ("none", "gather_scatter", "all_reduce", "fused",
                     "zero", "fsdp"):
        for remat in ("none", "blocks", "conv_stages", "dots"):
            monkeypatch.setattr(tt, "strategy", strategy)
            monkeypatch.setattr(tt.config, "remat", remat)
            tt._multi_step_cache.clear()
            assert callable(tt.build_multi_step(4))
    for rate in (0.0, 0.1):
        lm = LMTrainer(make_transformer(
            "TransformerLM-tiny", compute_dtype=torch.float32,
            max_seq_len=32, dropout_rate=rate), device="cpu")
        monkeypatch.setattr(lm, "device", torch.device("cuda", 0))
        if rate == 0.0:
            assert callable(lm.build_multi_step(2))
            continue
        with pytest.raises(NotImplementedError, match="item 9.5c"):
            lm.build_multi_step(2)


def test_card_graph_recaptures_for_a_new_state(monkeypatch):
    """A captured group writes the tensors its state held at capture:
    a state made anew (``state_from_host``, ``init_state``) holds other
    momentum tensors, so the next group captures again for it, and a
    group on the same state replays without a capture. ``_StepGraph``
    is replaced by a fake that records what it was captured on, and the
    trainer's device reads "cuda" only while the route is picked."""
    from tpu_ddp_torch.train import engine

    captured = []

    class FakeGraph:
        def __init__(self, trainer, state, xs, ys):
            self.k = len(xs)
            self.out = torch.zeros(self.k, 2)
            self.ptrs = [t.data_ptr() for t in engine._written(state)]
            captured.append(self)

        def stage(self, xs, ys):
            pass

        def replay(self):
            pass

    tt, state = _port(global_batch_size=4)
    monkeypatch.setattr(tt, "device", torch.device("cuda", 0))
    monkeypatch.setattr(engine, "_StepGraph", FakeGraph)
    multi = tt.build_multi_step(2)  # the card's route
    monkeypatch.setattr(tt, "device", torch.device("cpu"))
    x, y = _batches(2)
    xs = [_nchw(x[j]) for j in range(2)]
    ys = [torch.from_numpy(y[j]).long() for j in range(2)]
    state, _ = multi(state, xs, ys)
    state, _ = multi(state, xs, ys)
    assert len(captured) == 1
    old = state
    state = tt.state_from_host(tt.state_to_host(old))
    assert state.opt_state["momentum"][0] is not \
        old.opt_state["momentum"][0]
    state, _ = multi(state, xs, ys)
    assert len(captured) == 2
    assert captured[-1].ptrs == [t.data_ptr()
                                 for t in engine._written(state)]
    state, _ = multi(state, xs, ys)
    state, _ = multi(tt.init_state(), xs, ys)
    assert len(captured) == 3


# ---- sharded evaluation over gloo ----------------------------------------

EVAL_WORKER = r"""
import json, sys
import numpy as np
import torch
from tpu_ddp_torch.convert import CanonicalView
from tpu_ddp_torch.data.loader import DataLoader
from tpu_ddp_torch.data.sampler import DistributedShardSampler
from tpu_ddp_torch.models.vgg import VGGModel
from tpu_ddp_torch.parallel.bootstrap import init_distributed_setup
from tpu_ddp_torch.train.engine import Trainer
from tpu_ddp_torch.utils.config import TrainConfig

torch.set_num_threads(1)
spec = json.loads(sys.argv[1])
rank, world = int(sys.argv[2]), spec["world"]
init_distributed_setup("127.0.0.1", spec["port"], rank, world,
                       device="cpu", ddp=True, timeout_s=90)
model = VGGModel("tiny", tuple(spec["tiny"]), compute_dtype=torch.float32,
                 use_pallas_bn=True)
cfg = TrainConfig(pallas_sgd=True, pallas_bn=True, compute_dtype="float32",
                  dispatch_depth=spec["depth"])
tr = Trainer(model, cfg, strategy="all_reduce", device="cpu")
state = tr.init_state()
d = np.load(spec["data"])
host = tr.state_to_host(state)
host["params"] = CanonicalView(model).tree(
    [d[f"p{i}"] for i in range(len(d.files) - 2)])
state = tr.state_from_host(host)
loader = DataLoader(d["x"], d["y"], spec["batch"],
                    sampler=DistributedShardSampler(
                        len(d["y"]), num_replicas=world, rank=rank,
                        shuffle=False, drop_last=False),
                    with_weights=True)
res = tr.evaluate(state, loader, log=lambda s: None, sharded=True)
repl = tr.evaluate(state, loader, log=lambda s: None)
if rank == 0:
    with open(spec["out"], "w") as fh:
        json.dump({"sharded": res, "repl_on_shard": repl}, fh)
torch.distributed.barrier()
sys.stdout.flush()
import os
os._exit(0)
"""


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_eval_matches_jax(tmp_path, world):
    """``evaluate(sharded=True)`` over a gloo group of ``world`` ranks,
    each on its stride shard of a 13-image test set (weight 0 on the
    sampler's wrap padding), against the JAX trainer's sharded eval on a
    ``world``-device mesh fed the same per-device rows: the same seen
    and correct counts, the loss within 1e-5. A replicated pass over a
    rank's weight triples drops the padding rows, as JAX's does."""
    jm = JaxVGG(name="tiny", cfg=TINY, compute_dtype=jnp.float32,
                use_pallas_bn=True)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(89395)))
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, size=(13, 32, 32, 3), dtype=np.uint8)
    y = rng.integers(0, 10, size=13).astype(np.int32)
    data = tmp_path / "eval.npz"
    np.savez(data, x=x, y=y, **{f"p{i}": a for i, a in
                                enumerate(jax.tree.leaves(params))})
    batch = 2
    for depth in (0, 2):
        out = tmp_path / f"out{depth}.json"
        spec = {"world": world, "port": str(torch_ranks.free_port()),
                "data": str(data), "tiny": list(TINY), "batch": batch,
                "out": str(out), "depth": depth}
        torch_ranks.run_ranks(
            lambda r: ["-c", EVAL_WORKER, json.dumps(spec), str(r)], world)
        got = json.loads(out.read_text())
        jt = JaxTrainer(jm, JaxConfig(**KNOBS), strategy="all_reduce",
                        mesh=make_mesh(jax.devices()[:world]))
        host = jt.state_to_host(jt.init_state())
        host["params"] = params
        jstate = jt.state_from_host(host)
        ranks = [list(JaxLoader(x, y, batch, sampler=JaxSampler(
            13, num_replicas=world, rank=r, shuffle=False,
            drop_last=False), with_weights=True)) for r in range(world)]
        joint = [tuple(np.concatenate([rk[i][j] for rk in ranks])
                       for j in range(3)) for i in range(len(ranks[0]))]
        want = jt.evaluate(jstate, joint, log=lambda s: None, sharded=True)
        sh = got["sharded"]
        assert (sh["seen"], sh["correct"]) == (want["seen"],
                                               want["correct"]) \
            and sh["seen"] == 13
        np.testing.assert_allclose(sh["test_loss"], want["test_loss"],
                                   rtol=1e-5)
        assert got["repl_on_shard"]["seen"] == sum(
            float(w.sum()) for _, _, w in ranks[0])


def test_scheduled_sgd_count_updates_in_place():
    """A captured step reads the count tensor the previous replay wrote,
    so scheduled SGD updates it in place: the same tensor object after
    a step and after a skipped one, holding JAX's counts."""
    from tpu_ddp_torch.ops.optim import SGD, warmup_cosine
    opt = SGD(learning_rate=warmup_cosine(0.1, 2, 10))
    params = [torch.ones(3)]
    state = opt.init(params)
    count = state["count"]
    opt.apply(params, [torch.ones(3)], state)
    opt.apply(params, [torch.ones(3)], state, skip=torch.tensor(1.0))
    opt.apply(params, [torch.ones(3)], state, skip=torch.tensor(0.0))
    assert state["count"] is count and int(count) == 2
