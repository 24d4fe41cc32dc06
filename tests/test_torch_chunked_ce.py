"""The port's chunked-vocab cross-entropy (tpu_ddp_torch/ops/loss.py)
held against the JAX package's ``chunked_vocab_cross_entropy`` and
against the dense ``softmax_cross_entropy`` of ``hidden @ head``, values
and gradients, on the same numpy-seeded inputs in f32.

Tolerance: rtol 1e-5 / atol 1e-6. Every side computes the same f32
logsumexp; they differ in the order of the sums (chunk by chunk against
one pass, XLA against PyTorch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.ops.loss import chunked_vocab_cross_entropy as jax_chunked
from tpu_ddp_torch.ops.loss import (chunked_vocab_cross_entropy,
                                    softmax_cross_entropy)

RTOL, ATOL = 1e-5, 1e-6
T, DM, V = 48, 16, 96


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(T, DM)).astype(np.float32)
    w = (rng.normal(size=(DM, V)) * 0.5).astype(np.float32)
    lab = rng.integers(0, V, size=T)
    return h, w, lab


@pytest.mark.parametrize("chunk", [8, 32, 96])
def test_values_and_grads_match_jax_and_dense(chunk):
    h, w, lab = _inputs(chunk)
    wt = np.random.default_rng(9).normal(size=T).astype(np.float32)

    def jloss(a, b):
        return jnp.sum(jax_chunked(a, b, jnp.asarray(lab), chunk)
                       * jnp.asarray(wt))

    jv, (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    jnll = jax_chunked(jnp.asarray(h), jnp.asarray(w), jnp.asarray(lab),
                       chunk)
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    nll = chunked_vocab_cross_entropy(th, tw, torch.tensor(lab), chunk)
    (nll * torch.tensor(wt)).sum().backward()
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(jnll),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw),
                               rtol=RTOL, atol=ATOL)
    dh = torch.tensor(h, requires_grad=True)
    dw = torch.tensor(w, requires_grad=True)
    dense = softmax_cross_entropy(dh @ dw, torch.tensor(lab))
    (dense * torch.tensor(wt)).sum().backward()
    np.testing.assert_allclose(nll.detach().numpy(),
                               dense.detach().numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(th.grad.numpy(), dh.grad.numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tw.grad.numpy(), dw.grad.numpy(),
                               rtol=RTOL, atol=ATOL)


def test_saves_no_tensor_of_t_by_v_elements():
    """Everything autograd keeps between forward and backward is O(T) or
    a parameter: no (T, V) logits, no (T, chunk) slab."""
    h, w, lab = _inputs(1)
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = chunked_vocab_cross_entropy(th, tw, torch.tensor(lab),
                                           8).mean()
    loss.backward()
    assert saved, "the hooks saw nothing"
    biggest = max(int(np.prod(s)) for s in saved)
    assert biggest <= max(T * DM, DM * V) < T * V, saved
    assert (T, 8) not in saved
    # The dense loss does keep (T, V) tensors: the check can see them.
    dense = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: dense.append(tuple(t.shape)) or t, lambda t: t):
        softmax_cross_entropy(th @ tw, torch.tensor(lab)).mean()
    assert (T, V) in dense


def test_bad_chunks_raise():
    h, w, lab = _inputs(2)
    for chunk in (0, 7):
        with pytest.raises(ValueError, match="not divisible"):
            chunked_vocab_cross_entropy(torch.tensor(h), torch.tensor(w),
                                        torch.tensor(lab), chunk)
    with pytest.raises(ValueError, match="labels"):
        chunked_vocab_cross_entropy(torch.tensor(h), torch.tensor(w),
                                    torch.tensor(lab[:5]), 8)
