"""Device prefetch (tpu_ddp_torch/data/prefetch.py) and
``Trainer.put_batch`` held to the JAX package's
(tpu_ddp/data/prefetch.py, tests/test_dispatch_pipeline.py): the
lookahead, the depth validation, which fault kinds turn prefetch off,
and an epoch with prefetch on equal to one without it (bit for bit in
the port, within the VGG tolerance of JAX's prefetched epoch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.data.prefetch import prefetch_to_device as jax_prefetch
from tpu_ddp.models.vgg import VGGModel as JaxVGG
from tpu_ddp.resilience.chaos import FaultInjector as JaxInjector
from tpu_ddp.resilience.chaos import parse_faults as jax_parse
from tpu_ddp.train.engine import Trainer as JaxTrainer
from tpu_ddp.utils.config import TrainConfig as JaxConfig
from tpu_ddp_torch.convert import image_params_from_jax
from tpu_ddp_torch.data.prefetch import prefetch_to_device
from tpu_ddp_torch.models.vgg import VGGModel
from tpu_ddp_torch.resilience.chaos import FaultInjector, parse_faults
from tpu_ddp_torch.train.engine import Trainer
from tpu_ddp_torch.utils.config import TrainConfig
from tpu_ddp_torch.utils.tree import keyed_leaves

TINY = (8, "M", 16, "M", 16, "M", 16, "M", 16, "M")
KNOBS = dict(pallas_sgd=True, pallas_bn=True, compute_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_negative_depth_rejected_as_in_jax():
    for fn in (prefetch_to_device, jax_prefetch):
        with pytest.raises(ValueError, match="prefetch depth"):
            list(fn([], lambda b: b, depth=-1))


@pytest.mark.parametrize("depth", [0, 1, 2, 5])
def test_lookahead_matches_jax(depth):
    """The same results in order, and the same puts ahead of the
    consumer at every yield (never more than ``depth``)."""
    def run(fn):
        puts, ahead = [], []

        def put(x, y):
            puts.append(x)
            return (x, y)

        out = []
        for item in fn([(i, -i) for i in range(7)], put, depth):
            ahead.append(len(puts) - len(out) - 1)
            out.append(item)
        return out, ahead

    got, want = run(prefetch_to_device), run(jax_prefetch)
    assert got == want
    assert got[0] == [(i, -i) for i in range(7)]
    # At each yield the next depth - 1 puts are already made (the
    # refill follows the yield).
    assert max(got[1]) == max(depth - 1, 0)


def test_put_batch_on_the_cpu():
    tt = Trainer(VGGModel("tiny", TINY, compute_dtype=torch.float32),
                 TrainConfig(compute_dtype="float32"), device="cpu")
    x = torch.randn(2, 32, 32, 3).permute(0, 3, 1, 2)
    y = torch.tensor([1, 2])
    gx, gy, ready = tt.put_batch(x, y)
    assert ready is None and gx.device.type == "cpu"
    assert torch.equal(gx, x) and gx.stride() == x.stride()
    assert torch.equal(gy, y)


@pytest.mark.parametrize("spec", ["nan-grad@3", "slow-rank@3",
                                  "hard-exit@3", "corrupt-ckpt@3",
                                  "stalled-step@3"])
def test_poisons_batches_matches_jax(spec):
    assert FaultInjector(parse_faults(spec)).poisons_batches == \
        JaxInjector(jax_parse(spec)).poisons_batches == \
        spec.startswith("nan-grad")


@pytest.mark.parametrize("spec,expect_prefetch", [("slow-rank@1", True),
                                                  ("nan-grad@1", False)])
def test_engine_disables_prefetch_only_for_poisoning(monkeypatch, spec,
                                                     expect_prefetch):
    monkeypatch.setenv("TPU_DDP_CHAOS_FAULTS", spec)
    monkeypatch.setenv("TPU_DDP_CHAOS_SLOW_S", "0.001")
    called = []
    real = prefetch_to_device

    def spy(batches, put_fn, depth):
        called.append(depth)
        return real(batches, put_fn, depth)

    import tpu_ddp_torch.data.prefetch as pmod
    monkeypatch.setattr(pmod, "prefetch_to_device", spy)
    tt = Trainer(VGGModel("tiny", TINY, compute_dtype=torch.float32),
                 TrainConfig(compute_dtype="float32", device_prefetch=2,
                             guard_max_bad_steps=5, global_batch_size=4),
                 device="cpu")
    batches = [(torch.randn(4, 3, 32, 32), torch.tensor([0, 1, 2, 3]))] * 3
    tt.train_epoch(tt.init_state(), batches, log=lambda s: None)
    assert bool(called) is expect_prefetch
    assert not called or called == [2]


def test_prefetched_epoch_is_the_plain_epoch_and_jax():
    """Five steps with two batches in flight: the port's prefetched
    epoch ends with the plain epoch's bits and within the VGG tolerance
    of JAX's prefetched epoch (the same lines)."""
    rng = np.random.default_rng(2)
    host = [(rng.normal(size=(4, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, size=4).astype(np.int32))
            for _ in range(5)]
    batches = [(torch.from_numpy(x).permute(0, 3, 1, 2),
                torch.from_numpy(y).long()) for x, y in host]
    jt = JaxTrainer(JaxVGG(name="tiny", cfg=TINY, compute_dtype=jnp.float32,
                           use_pallas_bn=True),
                    JaxConfig(**KNOBS, device_prefetch=2, log_every=1),
                    strategy="none")
    jstate = jt.init_state()
    bits, lines = {}, {}
    for prefetch in (0, 2):
        tt = Trainer(VGGModel("tiny", TINY, compute_dtype=torch.float32,
                              use_pallas_bn=True),
                     TrainConfig(**KNOBS, device_prefetch=prefetch,
                                 log_every=1), device="cpu")
        state = tt.init_state()
        tt.model.load_state_dict(image_params_from_jax(
            tt.model, jax.tree.map(np.asarray, jstate.params),
            device="cpu"))
        out = []
        state, _ = tt.train_epoch(state, batches, log=out.append)
        bits[prefetch] = {k: np.asarray(v).tobytes() for k, v in
                          keyed_leaves(tt.state_to_host(state))}
        lines[prefetch] = [ln for ln in out if "timing" not in ln]
    jout = []
    jstate, _ = jt.train_epoch(jstate, host, log=jout.append)
    assert bits[2] == bits[0]
    assert lines[2] == lines[0] == [ln for ln in jout if "timing" not in ln]
