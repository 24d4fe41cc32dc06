"""The port's dispatch window (tpu_ddp_torch/train/pipeline.py) held to
the JAX package's (tpu_ddp/train/pipeline.py): the unit cases of
tests/test_dispatch_pipeline.py on fake events (the port's poll is
``Event.query()``, its forced wait one ``synchronize()`` on the newest
event), run through both classes where a JAX fake handle exists, and the
epoch loop's window driven on the CPU through a fake event per step, so
that harvesting really lags the dispatch.
"""

import numpy as np
import pytest
import torch

import tpu_ddp.train.pipeline as jpipe
from tpu_ddp_torch.train import pipeline as tpipe
from tpu_ddp_torch.train.pipeline import DispatchPipeline, depth_sweep


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeEvent:
    """Stands in for a ``torch.cuda.Event``: pollable, and blockable
    (``synchronize`` marks it, and counts the waits)."""

    waits = 0

    def __init__(self, ready=False):
        self.ready = ready

    def query(self):
        return self.ready

    def synchronize(self):
        FakeEvent.waits += 1
        self.ready = True


class FakeHandle:
    """The JAX test's handle: ``is_ready`` and ``block_until_ready``."""

    def __init__(self, ready=False):
        self.ready = ready

    def is_ready(self):
        return self.ready

    def block_until_ready(self):
        self.ready = True
        return self


def both(depth):
    return DispatchPipeline(depth), jpipe.DispatchPipeline(depth)


def test_negative_depth_rejected():
    for cls in (DispatchPipeline, jpipe.DispatchPipeline):
        with pytest.raises(ValueError, match="depth must be >= 0"):
            cls(-1)


def test_depth_zero_is_synchronous():
    port, jax_pipe = both(0)
    for pipe, make in ((port, FakeEvent), (jax_pipe, FakeHandle)):
        got = []
        for i in range(3):
            pipe.submit(make(ready=False), lambda v, i=i: got.append(i))
            assert got == list(range(i + 1))
        assert len(pipe) == 0
    assert port.stats() == {**jax_pipe.stats(),
                            "host_gap_ms": port.stats()["host_gap_ms"]}
    assert port.stats()["forced_syncs"] == 3


def test_fifo_head_blocks_delivery():
    pipe = DispatchPipeline(3)
    e0, e1 = FakeEvent(ready=False), FakeEvent(ready=True)
    got = []
    pipe.submit((torch.zeros(2), e0), lambda v: got.append(0))
    pipe.submit((torch.zeros(2), e1), lambda v: got.append(1))
    assert got == []  # e1 is done, but e0 gates the queue
    e0.ready = True
    pipe.poll()
    assert got == [0, 1]
    assert pipe.stats()["forced_syncs"] == 0


def test_one_forced_sync_per_window_overflow():
    """``depth`` unready submits ride free; the next one triggers ONE
    wait, on the newest event only (the stream is in order)."""
    for depth in (1, 2, 4):
        pipe = DispatchPipeline(depth)
        FakeEvent.waits = 0
        events = [FakeEvent() for _ in range(depth + 1)]
        got = []
        for i, ev in enumerate(events):
            pipe.submit(ev, lambda v, i=i: got.append(i))
        assert got == list(range(depth + 1))
        assert FakeEvent.waits == 1 and events[-1].ready
        assert not any(e.ready for e in events[:-1])
        s = pipe.stats()
        assert (s["forced_syncs"], s["harvested"], s["max_in_flight"]) \
            == (1, depth + 1, depth + 1)


@pytest.mark.parametrize("depth", [1, 2, 3, 5])
def test_forced_syncs_over_a_long_stream_match_jax(depth):
    """30 never-ready steps: the same forced-sync count as the JAX
    window, at most ceil(30 / depth)."""
    port, jax_pipe = both(depth)
    for _ in range(30):
        port.submit(FakeEvent(), lambda v: None)
        jax_pipe.submit(FakeHandle(), lambda v: None)
    port.drain()
    jax_pipe.drain()
    ps, js = port.stats(), jax_pipe.stats()
    assert ps["forced_syncs"] == js["forced_syncs"] <= -(-30 // depth)
    assert ps["harvested"] == js["harvested"] == 30


def test_sync_submit_flushes_backlog_and_itself():
    pipe = DispatchPipeline(4)
    got = []
    pipe.submit(FakeEvent(), lambda v: got.append(0))
    pipe.submit(FakeEvent(), lambda v: got.append(1), sync=True)
    assert got == [0, 1]
    s = pipe.stats()
    assert (s["sync_deliveries"], s["forced_syncs"], s["host_gap_ms"]) \
        == (1, 0, 0.0)


def test_sync_submit_at_depth_zero_counts_forced():
    pipe = DispatchPipeline(0)
    pipe.submit(FakeEvent(), lambda v: None, sync=True)
    assert pipe.stats()["forced_syncs"] == 1
    assert pipe.stats()["sync_deliveries"] == 0


def test_drain_empties_and_is_noop_when_empty():
    pipe = DispatchPipeline(4)
    got = []
    pipe.submit(FakeEvent(), lambda v: got.append(0))
    pipe.drain()
    assert got == [0]
    pipe.drain()
    assert pipe.stats()["forced_syncs"] == 1


def test_raising_callback_propagates_keeps_rest_queued():
    pipe = DispatchPipeline(4)

    def boom(v):
        raise RuntimeError("diverged")

    pipe.submit(FakeEvent(), boom)
    pipe.submit(FakeEvent(), lambda v: None)
    with pytest.raises(RuntimeError, match="diverged"):
        pipe.drain()
    assert len(pipe) == 1


def test_readiness_of_handle_leaves():
    """CPU tensors and plain values are ready; an event answers for
    itself; nested handles are ready only when every leaf is."""
    assert tpipe._handle_ready(torch.zeros(3))
    assert tpipe._handle_ready((np.zeros(2), 1.0, None))
    assert not tpipe._handle_ready((torch.zeros(2), FakeEvent()))
    assert tpipe._handle_ready({"a": [torch.zeros(1), FakeEvent(True)]})
    stats = DispatchPipeline(2).stats()
    assert set(stats) == set(jpipe.DispatchPipeline(2).stats())


def test_depth_sweep_restores_the_config():
    """depth_sweep runs each depth, keeps the best of ``reps`` and puts
    the timing window and depth back."""
    calls = []

    class Cfg:
        dispatch_depth, timing_first_iter, timing_last_iter = 2, 1, 39

    class FakeTrainer:
        config = Cfg()

        def train_epoch(self, state, batches, epoch=0, log=None):
            calls.append((self.config.dispatch_depth,
                          self.config.timing_last_iter))
            return state + 1, {"iters": len(batches), "host_gap_ms": 0.5,
                               "forced_syncs": 3}

    tr = FakeTrainer()
    res, state = depth_sweep(tr, 0, [1, 2, 3], [0, 4], reps=2)
    assert state == 4 and set(res) == {"0", "4"}
    assert calls == [(0, 0), (0, 0), (4, 0), (4, 0)]
    assert (Cfg.dispatch_depth, Cfg.timing_last_iter) == (2, 39)
    assert set(res["4"]) == {"steps_per_sec", "host_gap_ms",
                             "forced_syncs", "wall_s"}
