"""The port's memory policy (tpu_ddp_torch/memory/policy.py) and its use
in both models: remat none / blocks / dots / conv_stages x act_dtype on
TransformerLM-tiny (flash on, the Pallas kernel in interpret mode on the
JAX side) and on a narrow VGG (the fused BN+ReLU on both sides), held to
the JAX package's models with the same policy on the same weights and
inputs, in f32; and the port's modes held to each other with dropout on.

Tolerances: with act_dtype "compute" or "f32" the boundaries are exact,
so the JAX tolerances of the models' own tests hold (LM logits 2e-5 and
gradients 1e-5; VGG rtol 1e-4 / atol 1e-5). With "bf16" every boundary
rounds to bf16 on both sides: an f32 difference of one ulp before a
rounding can move a boundary by one bf16 unit (2**-8 relative), so
logits are held within 1e-2 and gradients within 5e-2 (relative
Frobenius norm per leaf). Between the port's own modes the recompute
replays the same arithmetic: bit for bit.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpu_ddp.memory import policy as jpolicy
from tpu_ddp.models import make_transformer as jax_make
from tpu_ddp.models.vgg import VGGModel as JaxVGG
from tpu_ddp.ops.loss import cross_entropy_loss as jax_ce
from tpu_ddp_torch.convert import (image_params_from_jax, params_from_jax,
                                   params_to_jax)
from tpu_ddp_torch.memory import policy
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.models.vgg import VGGModel
from tpu_ddp_torch.ops import bn_relu
from tpu_ddp_torch.ops import flash_attention as fa
from tpu_ddp_torch.ops.loss import cross_entropy_loss
from tpu_ddp_torch.utils.tree import tree_leaves, tree_unflatten

SEQ = 32
NARROW = (8, "M", 16, "M", 16, 16, "M", 16, "M", 24, "M")
LM_MODES = [(r, a) for r in ("none", "blocks", "dots")
            for a in ("compute", "bf16", "f32")]


def _frob(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _tokens(seed=0, b=2):
    return np.random.default_rng(seed).integers(0, 1024, size=(b, SEQ))


@pytest.mark.parametrize("remat,act", LM_MODES)
def test_lm_policy_matches_jax(remat, act):
    kw = dict(max_seq_len=SEQ, use_flash=True, remat=remat, act_dtype=act)
    jm = jax_make("TransformerLM-tiny", compute_dtype=jnp.float32, **kw)
    tm = make_transformer("TransformerLM-tiny", compute_dtype=torch.float32,
                          **kw)
    jp = jm.init(jax.random.key(0))
    tp = params_from_jax(tm, jax.tree.map(np.asarray, jp), device="cpu")
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    toks = _tokens()

    def jloss(p):
        logits = jm.apply(p, jnp.asarray(toks))
        return jax.nn.logsumexp(logits, -1).mean(), logits

    (_, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(jp)
    logits = tm.apply(tp, torch.from_numpy(toks))
    grads = torch.autograd.grad(logits.logsumexp(-1).mean(), leaves)
    got = params_to_jax(tree_unflatten(tp, list(grads)))
    if act == "bf16":
        np.testing.assert_allclose(logits.detach().numpy(),
                                   np.asarray(jlogits), rtol=1e-2,
                                   atol=1e-2)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jgrads)):
            assert _frob(g, np.asarray(w)) <= 5e-2
        return
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=2e-5, atol=2e-5)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)


class _CountMM(TorchDispatchMode):
    """Counts the matrix products that really run (a product a selective
    checkpoint hands back from its cache never reaches this mode)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.bmm,
                                   torch.ops.aten.addmm):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _lm_step(remat, dropout_rate=0.1, act="compute", rng=7, count=None):
    tm = make_transformer("TransformerLM-tiny", compute_dtype=torch.float32,
                          max_seq_len=SEQ, use_flash=True, remat=remat,
                          act_dtype=act, dropout_rate=dropout_rate)
    p = tm.init(torch.Generator().manual_seed(0))
    leaves = tree_leaves(p)
    for x in leaves:
        x.requires_grad_(True)
    loss = tm.apply(p, torch.from_numpy(_tokens(1)), rng=rng)
    loss = loss.logsumexp(-1).mean()
    if count is not None:
        count.n = 0
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


@pytest.mark.parametrize("remat", ["blocks", "dots", "conv_stages"])
def test_lm_modes_agree_with_dropout(remat):
    """With dropout on, the recompute redraws each mask from its own key:
    loss and every gradient equal the "none" step's bit for bit. (An
    outside generator would redraw other masks, silently.)"""
    l0, g0 = _lm_step("none")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        l1, g1 = _lm_step(remat)
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_dots_keeps_matmul_outputs_and_reruns_the_kernels(monkeypatch):
    """Per backward: "blocks" runs the blocks' products again, "dots"
    none (they come from its cache); both run the flash
    forward again (2 x layers), as JAX's dots_saveable reruns a Pallas
    call."""
    calls = []
    plain = fa.flash_fwd_plain
    monkeypatch.setattr(fa, "flash_fwd_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    fwd, bwd, flash = {}, {}, {}
    for remat in ("none", "blocks", "dots"):
        calls.clear()
        tm = make_transformer("TransformerLM-tiny", max_seq_len=SEQ,
                              compute_dtype=torch.float32, use_flash=True,
                              remat=remat)
        p = tm.init(torch.Generator().manual_seed(0))
        leaves = tree_leaves(p)
        for x in leaves:
            x.requires_grad_(True)
        with _CountMM() as counter:
            loss = tm.apply(p, torch.from_numpy(_tokens(1)))
        fwd[remat] = counter.n
        loss = loss.logsumexp(-1).mean()
        with _CountMM() as counter:
            torch.autograd.grad(loss, leaves)
        bwd[remat], flash[remat] = counter.n, len(calls)
    layers = tm.num_layers
    assert flash == {"none": layers, "blocks": 2 * layers,
                     "dots": 2 * layers}
    assert fwd["none"] == fwd["blocks"] == fwd["dots"]
    assert bwd["dots"] == bwd["none"]
    # The blocks' products again (a recompute stops early after the last
    # one its backward needs: each block's w2 product is not saved).
    assert bwd["none"] < bwd["blocks"] < bwd["none"] + fwd["none"]


def _vgg_pair(remat, act):
    jm = JaxVGG(name="narrow", cfg=NARROW, compute_dtype=jnp.float32,
                use_pallas_bn=True, remat=remat, act_dtype=act)
    tm = VGGModel("narrow", NARROW, compute_dtype=torch.float32,
                  use_pallas_bn=True, remat=remat, act_dtype=act)
    jp = jm.init(jax.random.key(89395))
    tm.load_state_dict(image_params_from_jax(
        tm, jax.tree.map(np.asarray, jp), device="cpu"))
    return jm, jp, tm


@pytest.mark.parametrize("remat", ["none", "blocks", "conv_stages", "dots"])
@pytest.mark.parametrize("act", ["compute", "bf16"])
def test_vgg_policy_matches_jax(remat, act):
    jm, jp, tm = _vgg_pair(remat, act)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=4)

    def loss_fn(p):
        logits = jm.apply(p, jnp.asarray(x))
        return jax_ce(logits, jnp.asarray(y, jnp.int32)), logits

    (_, jlogits), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    logits = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    cross_entropy_loss(logits, torch.from_numpy(y)).backward()
    want = image_params_from_jax(tm, jax.tree.map(np.asarray, jgrads),
                               device="cpu")
    got = dict(tm.named_parameters())
    if act == "bf16":
        np.testing.assert_allclose(logits.detach().numpy(),
                                   np.asarray(jlogits), rtol=1e-2, atol=1e-2)
        for k, v in want.items():
            if k.endswith(".bias") and ".bn." not in k and "head" not in k:
                continue  # conv biases: zero gradient, noise on both sides
            assert _frob(got[k].grad.numpy(), v.numpy()) <= 5e-2, k
        return
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].grad.numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_vgg_modes_agree_and_recompute_the_bn_statistics(monkeypatch):
    """Every mode gives the "none" gradients bit for bit; under "blocks"
    and "conv_stages" the backward runs each unit's BN statistics again,
    and each recomputed (mean, inv) equals the forward's bits."""
    calls = []
    plain = bn_relu.bn_stats_ref

    def recorded(x2d, eps=bn_relu.BN_EPS):
        out = plain(x2d, eps)
        calls.append((x2d.detach().clone(), out))
        return out

    monkeypatch.setattr(bn_relu, "bn_stats_ref", recorded)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(4, 3, 32, 32)).astype(np.float32))
    grads = {}
    for remat in ("none", "blocks", "conv_stages"):
        _, _, tm = _vgg_pair(remat, "compute")
        calls.clear()
        tm(x).square().mean().backward()
        grads[remat] = [p.grad for p in tm.parameters()]
        units = len(tm.features)
        assert len(calls) == (1 if remat == "none" else 2) * units, remat
        for xr, (mean, inv) in calls[units:]:
            fwd = [o for xf, o in calls[:units] if torch.equal(xf, xr)]
            assert len(fwd) == 1, "a recomputed BN input differs"
            assert torch.equal(fwd[0][0], mean)
            assert torch.equal(fwd[0][1], inv)
    for remat in ("blocks", "conv_stages"):
        for a, b in zip(grads[remat], grads["none"]):
            assert torch.equal(a, b)


def test_policy_helpers_match_jax():
    for name in ("VGG11", "ResNet50", "ViT-S", "TransformerLM-large", "x"):
        assert policy.family_for_model(name) == \
            jpolicy.family_for_model(name)
    with pytest.warns(UserWarning, match="degrading"):
        assert policy.effective_remat("conv_stages", "attn") == "blocks"
    assert policy.effective_remat("conv_stages", "conv") == "conv_stages"
    assert policy.resolve_act_dtype("compute", torch.float16) == \
        torch.float16
    assert policy.resolve_act_dtype("bf16", torch.float32) == torch.bfloat16
    x = torch.zeros(2, dtype=torch.bfloat16)
    assert policy.cast_saved(x, "bf16", torch.float32) is x
    assert policy.cast_saved(x, "f32", torch.bfloat16).dtype == torch.float32
    for bad in (lambda: policy.validate_remat("all"),
                lambda: policy.validate_act_dtype("fp8"),
                lambda: VGGModel("n", NARROW, remat="all"),
                lambda: make_transformer("TransformerLM-tiny",
                                         act_dtype="fp8")):
        with pytest.raises(ValueError):
            bad()


def test_apply_policy_matches_jax():
    """A config default never downgrades the large preset's block remat;
    a non-default value wins; the VGG module takes the fields in place; a
    model without them is returned with a warning."""
    jl = jax_make("TransformerLM-large")
    tl = make_transformer("TransformerLM-large")
    for remat, act in (("none", "compute"), ("dots", "compute"),
                       ("none", "bf16"), ("blocks", "f32")):
        j = jpolicy.apply_policy(jl, remat, act)
        t = policy.apply_policy(tl, remat, act)
        assert (t.remat, t.act_dtype) == (j.remat, j.act_dtype)
    tv = VGGModel("n", NARROW)
    assert policy.apply_policy(tv, "conv_stages", "bf16") is tv
    assert (tv.remat, tv.act_dtype) == ("conv_stages", "bf16")
    with pytest.warns(UserWarning, match="does not carry"):
        obj = object()
        assert policy.apply_policy(obj, "blocks") is obj
