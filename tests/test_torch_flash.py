"""The port's flash attention (tpu_ddp_torch/ops/flash_attention.py) held
against the JAX package's Pallas kernel, run in interpret mode as
tests/test_flash_attention.py runs it, and against ``full_attention``.

On the CPU the op runs its plain versions (the kernels' arithmetic on the
whole (L, L) score matrix), so these tests pin the function the CUDA
kernels are held to on the card. Inputs are numpy-seeded f32. Tolerances,
as in tests/test_flash_attention.py: 3e-5 (rtol and atol) for values and
the logsumexp, 3e-4 for gradients; the two sides differ only in
summation order (the JAX kernel sums blockwise with an online softmax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.ops.pallas import flash_attention as jax_flash
from tpu_ddp.ops.pallas.flash_attention import _flash_fwd_padded
from tpu_ddp.parallel.ring_attention import full_attention as jax_full
from tpu_ddp_torch.ops import flash_attention as fa
from tpu_ddp_torch.parallel.ring_attention import (attend, full_attention,
                                                    repeat_kv_heads)

VAL_TOL, GRAD_TOL = 3e-5, 3e-4

# (B, L, H, KV, D, causal): L in {48, 100, 128, 130, 384} (ragged, one
# block, several blocks), D in {16, 32, 64, 128}, MHA and GQA with H = 4
# and KV in {2, 1}, causal and not.
CASES = [
    (1, 48, 4, 4, 16, True),
    (2, 100, 4, 4, 64, True),
    (1, 128, 4, 4, 128, False),
    (1, 130, 4, 2, 32, True),
    (1, 384, 4, 1, 32, True),
    (2, 100, 4, 2, 16, False),
    (1, 130, 4, 1, 64, False),
    (1, 128, 4, 2, 128, True),
]


def _inputs(b, L, h, kvh, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, L, h, d)).astype(np.float32)
    k = rng.normal(size=(b, L, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, L, kvh, d)).astype(np.float32)
    g = rng.normal(size=(b, L, h, d)).astype(np.float32)
    return q, k, v, g


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("b,L,h,kvh,d,causal", CASES)
def test_plain_versions_match_the_jax_kernel(b, L, h, kvh, d, causal):
    """Values, logsumexp and all three gradients of the port's op (its
    plain versions on the CPU) against the Pallas kernel's, and the values
    against ``full_attention``."""
    q, k, v, g = _inputs(b, L, h, kvh, d)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))

    @jax.jit
    def reference(q, k, v, g):
        o, vjp = jax.vjp(lambda a, b_, c: jax_flash(a, b_, c, causal), q, k,
                         v)
        _, (_, lse) = _flash_fwd_padded(q, k, v, causal)
        return o, vjp(g), lse, jax_full(q, k, v, causal=causal)

    jo, jgrads, jlse, jfull = reference(jq, jk, jv, jnp.asarray(g))
    jlse = np.asarray(jlse)[:, 0, :L].reshape(b, h, L)

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    to = fa.flash_attention(tq, tk, tv, causal)
    tgrads = torch.autograd.grad(to, (tq, tk, tv), torch.tensor(g))
    _, tlse = fa.flash_fwd(tq.detach(), tk.detach(), tv.detach(), causal)

    _close(to.detach(), jo, VAL_TOL, "o")
    _close(to.detach(), jfull, VAL_TOL, "o vs full_attention")
    _close(tlse, jlse, VAL_TOL, "lse")
    for got, want, name in zip(tgrads, jgrads, ("dq", "dk", "dv")):
        assert got.shape == want.shape
        _close(got, want, GRAD_TOL, name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kvh", [4, 2])
def test_full_attention_and_attend_match_jax(causal, kvh):
    q, k, v, _ = _inputs(2, 40, 4, kvh, 32, seed=1)
    want = jax_full(*(jnp.asarray(x) for x in (q, k, v)), causal=causal)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    _close(full_attention(tq, tk, tv, causal=causal), want, VAL_TOL,
           "full_attention")
    for flash in (False, True):
        _close(attend(tq, tk, tv, causal=causal, flash=flash), want,
               VAL_TOL, f"attend flash={flash}")
    ke, ve = repeat_kv_heads(tk, tv, 4 // kvh)
    _close(full_attention(tq, ke, ve, causal=causal), want, VAL_TOL,
           "expanded K/V")


def test_strided_v_and_bf16_rounding_points():
    """v as a strided view of a fused qkv tensor (its L stride 3·H·D, as
    the model's MHA split gives it) is read in place; in bf16 the output
    and gradients keep q's dtype and stay within the bf16 bound of the
    JAX kernel's own bf16 test (2e-2)."""
    rng = np.random.default_rng(2)
    qkv = rng.normal(size=(1, 64, 3, 4, 64)).astype(np.float32)
    g = rng.normal(size=(1, 64, 4, 64)).astype(np.float32)
    t = torch.tensor(qkv).to(torch.bfloat16).requires_grad_()
    q, k, v = t[:, :, 0], t[:, :, 1], t[:, :, 2]
    assert v.stride() == (64 * 3 * 4 * 64, 3 * 4 * 64, 64, 1)
    o = fa.flash_attention(q, k, v, True)
    assert o.dtype == torch.bfloat16
    (dqkv,) = torch.autograd.grad(o, t, torch.tensor(g).to(torch.bfloat16))
    assert dqkv.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(np.asarray(t.detach()[:, :, i].float()),
                              jnp.bfloat16) for i in range(3))
    jo, vjp = jax.vjp(lambda a, b_, c: jax_flash(a, b_, c, True), jq, jk, jv)
    jg = vjp(jnp.asarray(g, jnp.bfloat16))
    _close(o.detach().float(), np.asarray(jo, np.float32), 2e-2, "bf16 o")
    for i, name in enumerate(("dq", "dk", "dv")):
        _close(dqkv[:, :, i].float(), np.asarray(jg[i], np.float32), 2e-2,
               f"bf16 {name}")


def test_the_cpu_route_launches_no_kernel():
    """A CPU tensor takes the plain versions: no launch is counted, on
    either route of any kernel, even for inputs the wgmma route would
    take."""
    wrappers = (fa.flash_fwd, fa.flash_bwd_kv, fa.flash_bwd_q)

    def counts():
        return [dict(w.launches) for w in wrappers]

    before = counts()
    assert all(set(c) == set(fa.ROUTES) for c in before)
    for dtype, d in ((torch.float32, 16), (torch.bfloat16, 64)):
        q, k, v, g = (torch.tensor(x).to(dtype).requires_grad_()
                      for x in _inputs(1, 16, 2, 1, d))
        if dtype == torch.bfloat16:
            assert fa.fwd_route(q, k, v) == "wgmma"
            assert fa.bwd_route(q, k, v, g) == "wgmma"
        torch.autograd.grad(fa.flash_attention(q, k, v, True), (q, k, v), g)
    assert counts() == before


def _route_inputs(case):
    """(q, k, v, dO) as a call of the given kind would pass them; empty
    tensors, since the route reads only dtype, shape, strides and
    pointers."""
    bf = torch.bfloat16
    if case == "main":  # LM-large: q, k after RoPE, v a view of fused qkv
        b, L, h, d = 4, 2048, 16, 128
        v = torch.empty(b, L, 3, h, d, dtype=bf)[:, :, 2]
        assert v.stride() == (L * 3 * h * d, 3 * h * d, d, 1)
        return (torch.empty(b, L, h, d, dtype=bf),
                torch.empty(b, L, h, d, dtype=bf), v,
                torch.empty(b, L, h, d, dtype=bf))
    shapes = {"gqa": ((2, 512, 16, 128), 4, bf),
              "ragged": ((2, 100, 16, 128), 16, bf),
              "d64": ((2, 384, 16, 64), 1, bf),
              "f32": ((1, 384, 16, 128), 16, torch.float32),
              "d36": ((1, 200, 8, 36), 2, bf)}
    if case in shapes:
        (b, L, h, d), kvh, dtype = shapes[case]
        return (torch.empty(b, L, h, d, dtype=dtype),
                torch.empty(b, L, kvh, d, dtype=dtype),
                torch.empty(b, L, kvh, d, dtype=dtype),
                torch.empty(b, L, h, d, dtype=dtype))
    if case == "misaligned":  # a view 2 bytes past a 16-byte boundary
        n = 2 * 64 * 4 * 64
        q = torch.empty(n + 1, dtype=bf)[1:].view(2, 64, 4, 64)
        assert q.data_ptr() % 16 == 2
        k = torch.empty(2, 64, 4, 64, dtype=bf)
        return q, k, k, k
    if case == "misaligned_do":  # q, k, v aligned; dO 2 bytes off
        n = 2 * 64 * 4 * 64
        do = torch.empty(n + 1, dtype=bf)[1:].view(2, 64, 4, 64)
        k = torch.empty(2, 64, 4, 64, dtype=bf)
        return k, k, k, do
    if case == "odd_stride":  # a head stride of 68 elements (136 bytes)
        q = torch.empty(1, 64, 2, 68, dtype=bf)[..., :64]
        k = torch.empty(1, 64, 2, 64, dtype=bf)
        return q, k, k, k
    raise AssertionError(case)


@pytest.mark.parametrize("case,route", [
    ("main", "wgmma"), ("gqa", "wgmma"), ("ragged", "wgmma"),
    ("d64", "wgmma"), ("f32", "mma_sync"), ("d36", "mma_sync"),
    ("misaligned", "mma_sync"), ("odd_stride", "mma_sync"),
])
def test_bwd_route(case, route):
    """Which backward kernel a CUDA call launches, chosen before the
    launch from dtype, head dim, strides and alignment: the wgmma sweeps
    for bf16, D in {64, 128} and TMA-addressable inputs (the LM's main
    path among them), the mma.sync sweeps for the rest."""
    assert fa.bwd_route(*_route_inputs(case)) == route


@pytest.mark.parametrize("case,route", [
    ("main", "wgmma"), ("gqa", "wgmma"), ("ragged", "wgmma"),
    ("d64", "wgmma"), ("f32", "mma_sync"), ("d36", "mma_sync"),
    ("misaligned", "mma_sync"), ("odd_stride", "mma_sync"),
    ("misaligned_do", "wgmma"),
])
def test_fwd_route(case, route):
    """Which forward kernel a CUDA call launches, by the backward's rule
    without dO: the wgmma forward for bf16, D in {64, 128} and
    TMA-addressable q, k, v, the mma.sync forward for the rest. Where dO
    allows the TMA too, the forward and the backward take the same
    route on the same inputs."""
    q, k, v, do = _route_inputs(case)
    assert fa.fwd_route(q, k, v) == route
    if case == "misaligned_do":  # only dO keeps the backward off wgmma
        assert fa.bwd_route(q, k, v, do) == "mma_sync"
    else:
        assert fa.bwd_route(q, k, v, do) == route


def _bad_inputs(case):
    q = torch.zeros(1, 16, 4, 32)
    kv = torch.zeros(1, 16, 4, 32)
    if case == "head_dim":
        big = torch.zeros(1, 16, 4, 192)
        return big, big, big
    if case == "heads":
        return torch.zeros(1, 16, 6, 32), kv, kv
    if case == "stride":
        return torch.zeros(1, 16, 4, 64)[..., ::2], kv, kv
    if case == "dtype":
        return q.to(torch.bfloat16), kv, kv
    raise AssertionError(case)


@pytest.mark.parametrize("case,exc,match", [
    ("head_dim", NotImplementedError, "ROADMAP Queue 2"),
    ("heads", ValueError, "divisible"),
    ("stride", ValueError, "contiguous along D"),
    ("dtype", TypeError, "share a dtype"),
])
def test_refused_inputs(case, exc, match):
    """What the kernels do not take raises on both routes, the CPU's
    included: D > 128, H % KV != 0, a D stride other than 1 (never a
    silent copy), mixed dtypes."""
    q, k, v = _bad_inputs(case)
    with pytest.raises(exc, match=match):
        fa.flash_attention(q, k, v)
    with pytest.raises(exc, match=match):
        fa.flash_fwd(q, k, v)


def test_strided_gradient_is_refused():
    q, k, v, _ = (torch.tensor(x) for x in _inputs(1, 16, 2, 2, 16))
    o, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.attention_delta(o, o)
    bad = torch.zeros(1, 16, 2, 32)[..., ::2]
    for fn in (fa.flash_bwd_kv, fa.flash_bwd_q):
        with pytest.raises(ValueError, match="contiguous along D"):
            fn(q, k, v, bad, lse, delta, True)
