"""The LM's dropout under K steps per dispatch (tpu_ddp_torch/models/
transformer.py ``fold_in``/``keep_mask``/``dropout``, train/lm.py's
device step): each mask is a counter hash of (dropout_seed, step, rank,
microbatch, layer, site, element index), and the step is read from a
device tensor, so a captured step draws the masks of the eager step it
replays.

What is held here, bit for bit on the CPU (the same integer ops run on
the card, where chip_smoke.py phase 45 holds a captured K = 2 group to
two eager steps):

- ``fold_in`` gives the same key from host ints and from int32 or int64
  device tensors, and ``keep_mask`` is the documented hash;
- masks depend on the seed, step, rank, microbatch, layer and site and
  on nothing else: a trainer's forward keyed by the host step equals one
  keyed by its device count;
- ``build_multi_step(k)`` equals k ``train_step`` calls (AdamW's count,
  Adafactor's, and SGD's ``step_t``; with accumulation; MoE), and a run
  resumed from the canonical host state continues the same masks.

The keep share and the 1/keep scaling are held to JAX's statistics in
tests/test_torch_dropout.py.
"""

import numpy as np
import pytest
import torch

from tpu_ddp_torch.models.transformer import (dropout, fold_in, keep_mask,
                                              make_transformer)
from tpu_ddp_torch.ops.optim import SGD, Adafactor, AdamW
from tpu_ddp_torch.train.lm import LMTrainer, make_lm_batch
from tpu_ddp_torch.utils.tree import tree_leaves

SEQ = 32



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _trainer(preset="TransformerLM-tiny", optimizer=None, accum=1, seed=5,
             **kw):
    m = make_transformer(preset, max_seq_len=SEQ,
                         compute_dtype=torch.float32, dropout_rate=0.1,
                         **kw)
    return LMTrainer(m, device="cpu", dropout_seed=seed, grad_accum=accum,
                     optimizer=optimizer)


def _batch(tr, seed=2):
    return tr.put_batch(*make_lm_batch(np.random.default_rng(seed).integers(
        0, 1024, size=(4, SEQ + 1))))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_fold_in_gives_one_key_from_ints_and_device_tensors(dtype):
    rng = np.random.default_rng(0)
    for _ in range(300):
        key = int(rng.integers(0, 2 ** 63, dtype=np.uint64))
        data = int(rng.integers(0, 2 ** 31 - 1))
        want = fold_in(key, data)
        assert 0 <= want < 2 ** 63
        for k, d in ((torch.tensor(key), data),
                     (key, torch.tensor(data, dtype=dtype)),
                     (torch.tensor(key), torch.tensor(data, dtype=dtype))):
            got = fold_in(k, d)
            assert got.dtype == torch.int64 and int(got) == want


def test_keep_mask_is_the_documented_hash():
    """Element i is kept where lane i % 4 (little-endian 16 bits, read as
    a signed int16) of the 64-bit hash of (key, i // 4) lies below
    round(keep x 2**16) - 2**15: the definition pinned by host ints, so
    every device that runs the int64 ops agrees."""
    key, keep, n = 123456789, 0.9, 4 * 64 + 3
    mask = keep_mask(key, (n,), keep, "cpu")
    for i in range(n):
        h = fold_in(key, i // 4) << 1  # fold_in drops the last bit
        # The element hash keeps all 64 bits: recompute it unshifted.
        z = (key ^ ((i // 4 + 1) * 0x9E3779B97F4A7C15)) & (2 ** 64 - 1)
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2 ** 64 - 1)
        z ^= z >> 31
        assert h >> 1 == z >> 1
        lane = (z >> (16 * (i % 4))) & 0xFFFF
        signed = lane - 65536 if lane >= 32768 else lane
        assert bool(mask[i]) == (signed < round(keep * 65536) - 32768), i
    assert torch.equal(mask, keep_mask(torch.tensor(key), (n,), keep, "cpu"))


def test_masks_depend_on_seed_step_rank_microbatch_layer_and_site():
    x = torch.ones(2, 16, 32)
    base = fold_in(fold_in(fold_in(7, 3), 0), 1)   # seed, step, rank, layer
    keys = {"base": base,
            "seed": fold_in(fold_in(fold_in(8, 3), 0), 1),
            "step": fold_in(fold_in(fold_in(7, 4), 0), 1),
            "rank": fold_in(fold_in(fold_in(7, 3), 1), 1),
            "microbatch": fold_in(fold_in(fold_in(fold_in(7, 3), 0), 0), 1),
            "layer": fold_in(fold_in(fold_in(7, 3), 0), 2)}
    masks = {k: dropout(x, 0.1, fold_in(v, 0)) for k, v in keys.items()}
    masks["site"] = dropout(x, 0.1, fold_in(base, 1))
    for k, m in masks.items():
        if k != "base":
            assert not torch.equal(m, masks["base"]), k
    # The same inputs, the same mask, whichever form the step takes.
    dev = fold_in(fold_in(fold_in(7, torch.tensor(3, dtype=torch.int32)),
                          0), 1)
    assert torch.equal(dropout(x, 0.1, fold_in(dev, 0)), masks["base"])


def test_device_step_draws_the_host_steps_masks():
    """The trainer's key from its device count equals ``step_key`` of the
    host step, so the forward under either is the same bits."""
    tr = _trainer()
    state = tr.init_state(seed=0)
    x, y = _batch(tr)
    for s in (0, 1, 7):
        state.opt_state["count"].fill_(s)
        dev_key = tr.step_key(tr._device_step(state))
        assert int(dev_key) == tr.step_key(s)
        a, _ = tr._loss_and_grads(tree_leaves(state.params), state.params,
                                  x, y, dev_key)
        b, _ = tr._loss_and_grads(tree_leaves(state.params), state.params,
                                  x, y, tr.step_key(s))
        assert torch.equal(a, b)


def _run(tr, k, x, y, groups=2):
    """``groups`` calls of the K-step function, or ``groups * k`` eager
    steps when ``k`` is None."""
    state = tr.init_state(seed=0)
    losses = []
    if k is None:
        for _ in range(groups * 2):
            state, loss = tr.train_step(state, x, y)
            losses.append(loss)
        return state, torch.stack(losses)
    run = tr.build_multi_step(k)
    for _ in range(groups):
        state, ls = run(state, [x] * k, [y] * k)
        losses.append(ls)
    return state, torch.cat(losses)


@pytest.mark.parametrize("case", ["adamw", "adafactor", "sgd_step_t",
                                  "accum2", "moe"])
def test_k_step_loop_over_the_device_step_equals_k_train_steps(case):
    kw = {"adamw": dict(optimizer=AdamW()),
          "adafactor": dict(optimizer=Adafactor(min_dim_size_to_factor=8)),
          "sgd_step_t": dict(optimizer=SGD(learning_rate=0.1)),
          "accum2": dict(optimizer=AdamW(), accum=2),
          "moe": dict(preset="TransformerLM-moe-tiny",
                      optimizer=AdamW())}[case]
    tr = _trainer(**kw)
    x, y = _batch(tr)
    eager, el = _run(tr, None, x, y)
    tr2 = _trainer(**kw)
    grouped, gl = _run(tr2, 2, x, y)
    assert torch.equal(el, gl)
    assert grouped.step == eager.step == 4
    for a, b in zip(tree_leaves(eager.params), tree_leaves(grouped.params)):
        assert torch.equal(a, b)
    if case == "sgd_step_t":
        # SGD at a static lr keeps no count: the state carries the step,
        # and a captured step writes it in place.
        assert "count" not in grouped.opt_state
        assert int(grouped.step_t) == 4
        assert any(t is grouped.step_t for t in tr2._written(grouped))
    else:
        assert grouped.step_t is None
        assert int(grouped.opt_state["count"]) == 4
    # Dropout is on: the four steps drew four mask sets, so the losses
    # differ from those of a trainer without it.
    plain = LMTrainer(make_transformer(
        kw.get("preset", "TransformerLM-tiny"), max_seq_len=SEQ,
        compute_dtype=torch.float32), device="cpu")
    _, pl = plain.train_step(plain.init_state(seed=0), x, y)
    assert float(pl) != float(el[0])


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_resumed_run_continues_the_masks(opt):
    make = (lambda: AdamW()) if opt == "adamw" else (
        lambda: SGD(learning_rate=0.1))
    tr = _trainer(optimizer=make())
    x, y = _batch(tr)
    state = tr.init_state(seed=0)
    straight = []
    for _ in range(3):
        state, loss = tr.train_step(state, x, y)
        straight.append(float(loss))
    tr2 = _trainer(optimizer=make())
    st = tr2.init_state(seed=0)
    st, first = tr2.train_step(st, x, y)
    st = tr2.state_from_host(tr2.state_to_host(st))
    assert st.step == 1
    resumed = [float(first)]
    for _ in range(2):
        st, loss = tr2.train_step(st, x, y)
        resumed.append(float(loss))
    assert resumed == straight
    for a, b in zip(tree_leaves(state.params), tree_leaves(st.params)):
        assert torch.equal(a, b)
