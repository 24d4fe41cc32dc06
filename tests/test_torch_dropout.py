"""Dropout in the port's TransformerLM (tpu_ddp_torch/models/
transformer.py) and its keys in the LM trainer, held to the JAX
package's dropout by distribution, not by bits: the masks come from
another generator (a seeded ``torch.Generator`` per (seed, step, rank,
layer, site) against threefry ``fold_in``).

Statistics: over n = 2**16 elements the kept share is binomial, with a
standard deviation of sqrt(keep (1 - keep) / n) = 1.2e-3 at rate 0.1;
both packages' shares are held within 5 of those (6e-3) of 1 - rate,
and the kept elements equal x / keep in the input's dtype exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.models import make_transformer as jax_make
from tpu_ddp_torch.models.transformer import (dropout, fold_in,
                                              make_transformer)
from tpu_ddp_torch.train.lm import LMTrainer, make_lm_batch

N = 2 ** 16


@pytest.mark.parametrize("rate", [0.05, 0.1, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_keep_share_and_scaling_match_jax(rate, dtype):
    keep = 1.0 - rate
    tol = 5 * np.sqrt(keep * rate / N)
    jm = jax_make("TransformerLM-tiny", dropout_rate=rate)
    x = np.random.default_rng(0).uniform(0.5, 2.0, N).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.tensor(x).to(getattr(torch, dtype))
    jy = np.asarray(jm._dropout(jx, jax.random.key(3)).astype(jnp.float32))
    ty = dropout(tx, rate, fold_in(3, 0))
    assert ty.dtype == tx.dtype
    for y, ref in ((jy, np.asarray(jx.astype(jnp.float32))),
                   (ty.float().numpy(), tx.float().numpy())):
        kept = y != 0
        assert abs(kept.mean() - keep) <= tol
    want = (tx / keep).float().numpy()
    kept = ty.float().numpy() != 0
    np.testing.assert_array_equal(ty.float().numpy()[kept], want[kept])


def test_masks_are_a_function_of_the_key():
    x = torch.ones(4096)
    a = dropout(x, 0.1, 11)
    assert torch.equal(a, dropout(x, 0.1, 11))
    assert not torch.equal(a, dropout(x, 0.1, 12))
    assert dropout(x, 0.1, None) is x
    assert dropout(x, 0.0, 11) is x
    keys = {fold_in(k, d) for k in range(50) for d in range(50)}
    assert len(keys) == 2500
    assert all(0 <= k < 2 ** 63 for k in keys)
    with pytest.raises(ValueError):
        make_transformer("TransformerLM-tiny", dropout_rate=1.0)


def test_model_dropout_is_off_without_a_key():
    m = make_transformer("TransformerLM-tiny", max_seq_len=16,
                         compute_dtype=torch.float32, dropout_rate=0.3)
    m0 = make_transformer("TransformerLM-tiny", max_seq_len=16,
                          compute_dtype=torch.float32)
    p = m.init(torch.Generator().manual_seed(0))
    t = torch.zeros(2, 16, dtype=torch.long)
    assert torch.equal(m.apply(p, t), m0.apply(p, t))
    assert not torch.equal(m.apply(p, t, rng=1), m.apply(p, t))
    assert torch.equal(m.apply(p, t, rng=1), m.apply(p, t, rng=1))


def _trainer(seed=0, accum=1):
    m = make_transformer("TransformerLM-tiny", max_seq_len=32,
                         compute_dtype=torch.float32, dropout_rate=0.1)
    tr = LMTrainer(m, device="cpu", dropout_seed=seed, grad_accum=accum)
    x, y = tr.put_batch(*make_lm_batch(np.random.default_rng(2).integers(
        0, 1024, size=(4, 33))))
    return tr, tr.init_state(seed=0), x, y


def test_trainer_keys_and_determinism():
    """Keys differ by step and by dropout_seed, a run repeats bit for
    bit, and a run restarted from step k's state continues with the same
    keys (they derive from the state's step)."""
    tr, s, x, y = _trainer()
    assert tr.step_key(0) != tr.step_key(1)
    assert tr.step_key(0) != _trainer(seed=1)[0].step_key(0)
    no_drop = LMTrainer(make_transformer("TransformerLM-tiny"),
                        device="cpu")
    assert no_drop.step_key(0) is None
    losses = []
    for _ in range(3):
        s, loss = tr.train_step(s, x, y)
        losses.append(float(loss))
    tr2, s2, _, _ = _trainer()
    again = []
    for _ in range(3):
        s2, loss = tr2.train_step(s2, x, y)
        again.append(float(loss))
    assert losses == again
    # Dropout is on: a step without it gives another loss.
    plain = LMTrainer(make_transformer(
        "TransformerLM-tiny", max_seq_len=32, compute_dtype=torch.float32),
        device="cpu")
    _, l0 = plain.train_step(plain.init_state(seed=0), x, y)
    tr3, s3, _, _ = _trainer()
    _, l1 = tr3.train_step(s3, x, y)
    assert float(l0) != float(l1)


def test_microbatches_draw_their_own_masks():
    """Under accumulation each microbatch folds its index into the key:
    two microbatches of the same rows see different masks, so the step
    differs from one that reuses a mask (a single microbatch twice)."""
    tr, s, x, y = _trainer(accum=2)
    xx, yy = torch.cat([x[:2], x[:2]]), torch.cat([y[:2], y[:2]])
    _, loss = tr.train_step(s, xx, yy)
    tr1, s1, _, _ = _trainer()
    _, single = tr1.train_step(s1, x[:2], y[:2])
    assert float(loss) != float(single)
