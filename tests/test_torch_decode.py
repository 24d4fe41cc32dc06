"""The port's model and decode core (tpu_ddp_torch/models/,
tpu_ddp_torch/convert.py) held against the JAX package.

Both sides run TransformerLM-tiny (MHA) and a GQA variant with
``num_kv_heads=2`` in f32 compute on the same converted weights. The
decode-path logits agree to atol 1e-4 (f32 sums in a different order
across two layers); within the port, incremental decode and the
full-sequence decode forward agree to atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.models.transformer import layer_norm as jax_layer_norm
from tpu_ddp.models.transformer import make_transformer as jax_make
from tpu_ddp.models.transformer import rope as jax_rope
from tpu_ddp.ops import quant as jq
from tpu_ddp_torch.convert import params_from_jax
from tpu_ddp_torch.models.decode import (forward_cached, gumbel_noise,
                                         init_cache, sample_token)
from tpu_ddp_torch.models.generate import generate
from tpu_ddp_torch.models.transformer import (layer_norm, make_transformer,
                                              rope)
from tpu_ddp_torch.ops import quant as tq

VARIANTS = {"mha": {}, "gqa": {"num_kv_heads": 2}}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    kw = VARIANTS[request.param]
    jm = jax_make("TransformerLM-tiny", max_seq_len=64,
                  compute_dtype=jnp.float32, **kw)
    tm = make_transformer("TransformerLM-tiny", max_seq_len=64,
                          compute_dtype=torch.float32, **kw)
    jp = jm.init(jax.random.key(1))
    tp = params_from_jax(tm, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def test_rope_and_layer_norm_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    for pos in (np.arange(5), rng.integers(0, 100, size=(2, 5))):
        want = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos)))
        got = rope(torch.as_tensor(x), torch.as_tensor(pos)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    sc = rng.normal(size=16).astype(np.float32)
    b = rng.normal(size=16).astype(np.float32)
    want = np.asarray(jax_layer_norm(jnp.asarray(x), jnp.asarray(sc),
                                     jnp.asarray(b)))
    got = layer_norm(torch.as_tensor(x), torch.as_tensor(sc),
                     torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_init_shapes_match_jax(pair):
    jm, jp, tm, _ = pair
    tp = tm.init(torch.Generator().manual_seed(0))
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    tshapes = jax.tree.map(lambda a: tuple(a.shape), tp)
    assert jax.tree.structure(jshapes) == jax.tree.structure(tshapes)
    assert jax.tree.leaves(jshapes) == jax.tree.leaves(tshapes)
    w = tp["blocks"][0]["w1"]
    assert w.dtype == torch.float32
    assert abs(float(w.std()) - 0.02) < 2e-3
    assert torch.equal(tp["ln_f"]["scale"], torch.ones(tm.d_model))


def test_converter_copies_every_leaf(pair):
    _, jp, tm, tp = pair
    jl = jax.tree.leaves(jax.tree.map(np.asarray, jp))
    tl = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tp))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(a, b)


def test_converter_rejects_mismatched_trees(pair):
    jm, jp, tm, _ = pair
    tree = jax.tree.map(np.asarray, jp)
    bad = dict(tree, head=tree["head"][:, :-1])
    with pytest.raises(ValueError, match="head"):
        params_from_jax(tm, bad, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "ln_f"}
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(tm, missing, device="cpu")
    with pytest.raises(ValueError, match="blocks"):
        params_from_jax(tm, dict(tree, blocks=tree["blocks"][:1]),
                        device="cpu")


@pytest.mark.parametrize("quant", [False, True])
def test_decode_forward_logits_match_jax(pair, quant):
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(2).integers(0, 1024, size=(2, 24))
    jparams = jq.quantize_params(jm, jp) if quant else jp
    tparams = tq.quantize_params(tm, tp) if quant else tp
    want = np.asarray(jq.decode_forward_logits(
        jm, jparams, jnp.asarray(toks, jnp.int32)))
    got = tq.decode_forward_logits(tm, tparams, torch.as_tensor(toks))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_forward_cached_matches_full_forward(pair):
    """Prefill then one-token steps over contiguous caches reproduce the
    full-sequence decode forward at every position."""
    _, _, tm, tp = pair
    toks = torch.as_tensor(
        np.random.default_rng(3).integers(0, 1024, size=(2, 12)))
    full = tq.decode_forward_logits(tm, tp, toks)
    caches = init_cache(tm, 2, 12, "cpu")
    got = [forward_cached(tm, tp, toks[:, :5], caches, 0)]
    for t in range(5, 12):
        got.append(forward_cached(tm, tp, toks[:, t:t + 1], caches, t))
    np.testing.assert_allclose(torch.stack(got, 1).numpy(),
                               full[:, 4:].numpy(), atol=1e-4, rtol=0)


def test_generate_greedy_follows_argmax_of_full_forward(pair):
    _, _, tm, tp = pair
    prompt = torch.as_tensor(
        np.random.default_rng(4).integers(0, 1024, size=(2, 7)))
    out = generate(tm, tp, prompt, 5)
    assert tuple(out.shape) == (2, 5)
    seq = torch.cat([prompt, out], dim=1)
    logits = tq.decode_forward_logits(tm, tp, seq)
    np.testing.assert_array_equal(out.numpy(),
                                  logits[:, 6:11].argmax(-1).numpy())


def test_generate_validates_arguments(pair):
    _, _, tm, tp = pair
    with pytest.raises(ValueError, match="max_seq_len"):
        generate(tm, tp, torch.zeros(1, 60, dtype=torch.int64), 10)
    with pytest.raises(ValueError, match="max_new_tokens"):
        generate(tm, tp, torch.zeros(1, 4, dtype=torch.int64), 0)


def test_sampling_is_stateless_and_keyed_by_seed_and_position():
    torch.manual_seed(0)
    logits = torch.randn(3, 50)
    temps = torch.tensor([0.0, 0.8, 0.8])
    seeds = torch.tensor([1, 1, 2])
    pos = torch.tensor([10, 10, 10])
    tok, lp = sample_token(None, logits, temps, seeds, pos)
    tok2, lp2 = sample_token(None, logits, temps, seeds, pos)
    assert torch.equal(tok, tok2) and torch.equal(lp, lp2)
    assert int(tok[0]) == int(logits[0].argmax())
    # One row alone samples what it samples inside the batch.
    alone, _ = sample_token(None, logits[1:2], temps[1:2], seeds[1:2],
                            pos[1:2])
    assert int(alone[0]) == int(tok[1])
    np.testing.assert_allclose(
        lp.numpy(), torch.log_softmax(logits, -1)[range(3), tok].numpy())
    g = gumbel_noise(torch.tensor([5, 5]), torch.tensor([0, 1]), 1000)
    assert not torch.equal(g[0], g[1])  # the position changes the draw


def test_sampling_follows_the_softmax():
    """Gumbel-max draws over many positions land at the softmax's
    frequencies (4-sigma binomial bound per category)."""
    logits = torch.tensor([[0.0, 1.0, 2.0, -1.0]])
    n = 20000
    pos = torch.arange(n)
    tok, _ = sample_token(None, logits.expand(n, 4), torch.ones(n),
                          torch.full((n,), 9), pos)
    freq = torch.bincount(tok, minlength=4).double() / n
    p = torch.softmax(logits[0].double(), -1)
    assert bool(((freq - p).abs() <= 4 * (p * (1 - p) / n).sqrt()).all())
