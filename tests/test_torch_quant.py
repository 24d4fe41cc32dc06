"""The port's weight-only int8 path (tpu_ddp_torch/ops/quant.py,
ops/quant_matmul.py) held against the JAX package on the same inputs.

Inputs are made with numpy from a seed and handed to both sides. The
Pallas kernel runs in interpret mode, as tests/test_speculative.py runs
it on the CPU. Tolerances: the int8 products are exact in f32 and only
the summation order differs, so f32 results agree to rtol/atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.models.transformer import make_transformer as jax_make
from tpu_ddp.ops import quant as jq
from tpu_ddp.ops.pallas.quant_matmul import int8_matmul as pallas_int8_matmul
from tpu_ddp_torch.convert import params_from_jax
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.ops import quant as tq
from tpu_ddp_torch.ops.quant_matmul import (ROUTES, int8_matmul,
                                            int8_matmul_ref, int8_route,
                                            split_k)

# Aligned, unaligned and TransformerLM-large decode/prefill shapes (the
# large ones at reduced K/N keep the interpret-mode kernel fast).
SHAPES = [(1, 64, 48), (3, 100, 70), (5, 130, 200), (8, 128, 128),
          (8, 256, 384), (32, 256, 1000)]


def _weights(rng, k, n):
    return rng.normal(scale=0.02, size=(k, n)).astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 48), (100, 70), (128, 6, 32)])
def test_quantize_weight_matches_jax(shape):
    rng = np.random.default_rng(0)
    w = rng.normal(size=shape).astype(np.float32)
    w2 = w.reshape(shape[0], -1)  # a view: edits land in w
    w2[:, 5] = 0.0  # an all-zero column
    # Column 0 gets scale exactly 1.0, so these are exact .5 ties that
    # exercise round-half-to-even on both sides.
    w2[:4, 0] = [127.0, 0.5, 1.5, -2.5]
    reshape = (shape[0], -1) if len(shape) == 3 else None
    want = jq.quantize_weight(jnp.asarray(w), reshape=reshape)
    got = tq.quantize_weight(torch.as_tensor(w), reshape=reshape)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s),
                               rtol=1e-6, atol=0)
    assert got.q.dtype == torch.int8 and got.s.dtype == torch.float32


def test_quantize_weight_rejects_non_2d():
    with pytest.raises(ValueError, match="2-D matmul layout"):
        tq.quantize_weight(torch.zeros(2, 3, 4))


def test_dequantize_error_bound():
    rng = np.random.default_rng(1)
    w = torch.as_tensor(_weights(rng, 64, 32))
    qw = tq.quantize_weight(w)
    # Rounding to the nearest step: at most half a step per element.
    err = (tq.dequantize(qw) - w).abs()
    assert bool((err <= qw.s[None, :] / 2 + 1e-7).all())


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int8_matmul_ref_matches_pallas_interpret(m, k, n):
    rng = np.random.default_rng(m * 1000 + k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    qw = jq.quantize_weight(jnp.asarray(_weights(rng, k, n)))
    want = np.asarray(pallas_int8_matmul(jnp.asarray(x), qw.q, qw.s,
                                         interpret=True))
    got = int8_matmul_ref(torch.as_tensor(x),
                          torch.as_tensor(np.array(qw.q)),
                          torch.as_tensor(np.array(qw.s)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_qdot_matches_jax(m, k, n):
    """The CPU dispatch of a QuantizedWeight (the plain version) and of
    a plain weight both match JAX's qdot; leading axes are kept."""
    rng = np.random.default_rng(7 + m + k + n)
    x = rng.normal(size=(1, m, k)).astype(np.float32)
    w = _weights(rng, k, n)
    jqw = jq.quantize_weight(jnp.asarray(w))
    tqw = tq.quantize_weight(torch.as_tensor(w))
    for jw, tw in ((jqw, tqw), (jnp.asarray(w), torch.as_tensor(w))):
        want = np.asarray(jq.qdot(jnp.asarray(x), jw, jnp.float32))
        got = tq.qdot(torch.as_tensor(x), tw, torch.float32)
        assert tuple(got.shape) == (1, m, n)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_qdot_plain_weight_returns_f32_of_rounded_operands():
    """bf16 compute: operands round to bf16, the product stays f32 (JAX's
    preferred_element_type=float32), never rounded to bf16."""
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(4, 64)).astype(np.float32))
    w = torch.as_tensor(rng.normal(size=(64, 32)).astype(np.float32))
    got = tq.qdot(x.to(torch.bfloat16), w, torch.bfloat16)
    want = x.to(torch.bfloat16).double() @ w.to(torch.bfloat16).double()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_int8_matmul_cpu_uses_plain_version_without_counting():
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(2, 3, 40)).astype(np.float32))
    qw = tq.quantize_weight(torch.as_tensor(_weights(rng, 40, 24)))
    before = dict(int8_matmul.launches)
    assert set(before) == set(ROUTES)
    for xt in (x, x.to(torch.bfloat16)):
        got = int8_matmul(xt, qw.q, qw.s)
        assert torch.equal(got, int8_matmul_ref(xt, qw.q, qw.s))
        assert tuple(got.shape) == (2, 3, 24)
    assert int8_matmul.launches == before


@pytest.mark.parametrize("bad", ["q_dtype", "k", "s_shape", "s_dtype"])
def test_int8_matmul_rejects_bad_inputs(bad):
    x = torch.zeros(2, 8)
    q = torch.zeros(8, 4, dtype=torch.int8)
    s = torch.ones(4)
    if bad == "q_dtype":
        q = q.float()
    elif bad == "k":
        x = torch.zeros(2, 9)
    elif bad == "s_shape":
        s = torch.ones(5)
    else:
        s = s.double()
    with pytest.raises((TypeError, ValueError)):
        int8_matmul(x, q, s)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("m,k,n,sms", [
    (8, 2048, 6144, 132), (8, 2048, 2048, 132), (32, 8192, 2048, 132),
    (8, 2048, 32000, 132), (3, 100, 70, 132), (40, 300, 5, 1),
    (8, 2056, 2048, 132), (5, 8192, 2048, 132), (64, 2048, 8192, 132)])
def test_split_k_covers_k_exactly(m, k, n, sms, route):
    splits, kps = split_k(m, k, n, sms, route)
    assert splits >= 1 and kps >= 1
    assert (splits - 1) * kps < k <= splits * kps  # no empty split
    if route == "mma" and splits > 1:
        assert kps % 64 == 0  # whole stages of the cp.async ring
        assert splits <= 16  # one cluster


def _route_case(case):
    """(x, q) as a call of the given kind would pass them; empty tensors,
    since the route reads only dtype, shapes and pointers."""
    bf = torch.bfloat16
    shapes = {"decode": (8, 2048, 6144, bf), "prefill": (32, 8192, 2048, bf),
              "head": (8, 2048, 32000, bf), "one_row": (1, 2048, 2048, bf),
              "rows_64": (64, 2048, 8192, bf), "f32": (8, 2048, 2048,
                                                       torch.float32),
              "n_24": (8, 2048, 24, bf), "n_70": (8, 100, 70, bf),
              "k_100": (8, 100, 64, bf), "k_2056": (13, 2056, 2048, bf)}
    if case in shapes:
        m, k, n, dtype = shapes[case]
        return (torch.empty(m, k, dtype=dtype),
                torch.empty(k, n, dtype=torch.int8))
    q = torch.empty(256, 2048, dtype=torch.int8)
    if case == "x_offset":  # x 2 bytes past a 16-byte boundary
        return torch.empty(8 * 256 + 1, dtype=bf)[1:].view(8, 256), q
    if case == "x_transposed":  # copied into a fresh buffer first
        return torch.empty(256, 8, dtype=bf).t(), q
    if case == "x_3d":  # (batch, rows, K), contiguous
        return torch.empty(2, 4, 256, dtype=bf), q
    if case in ("q_offset_4", "q_offset_16"):
        off = int(case.rsplit("_", 1)[1])
        qv = torch.empty(256 * 2048 + off, dtype=torch.int8)[off:]
        return torch.empty(8, 256, dtype=bf), qv.view(256, 2048)
    raise AssertionError(case)


@pytest.mark.parametrize("case,route", [
    ("decode", "mma"), ("prefill", "mma"), ("head", "mma"),
    ("one_row", "mma"), ("rows_64", "mma"), ("k_2056", "mma"),
    ("f32", "simt"), ("n_24", "simt"), ("n_70", "simt"),
    ("k_100", "simt"), ("x_offset", "simt"), ("x_transposed", "mma"),
    ("x_3d", "mma"), ("q_offset_4", "simt"), ("q_offset_16", "mma"),
])
def test_int8_route(case, route):
    """Which kernel a CUDA call launches, chosen before the launch from
    dtype, shapes and pointers: the tensor-core kernel for bf16 x whose
    rows and q allow 16-byte copies (every serving shape, any M), the
    f32 kernel for f32 x, ragged K or N and unaligned views."""
    x, q = _route_case(case)
    assert int8_route(x, q) == route


def test_nll_drift_matches_jax():
    jm = jax_make("TransformerLM-tiny", max_seq_len=64,
                  compute_dtype=jnp.float32)
    tm = make_transformer("TransformerLM-tiny", max_seq_len=64,
                          compute_dtype=torch.float32)
    jp = jm.init(jax.random.key(0))
    tp = params_from_jax(tm, jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(3).integers(1, 1024, size=(4, 32))
    want = jq.nll_drift(jm, jp, jq.quantize_params(jm, jp),
                        jnp.asarray(toks, jnp.int32))
    got = tq.nll_drift(tm, tp, tq.quantize_params(tm, tp),
                       torch.as_tensor(toks))
    for key in ("nll_fp32", "nll_int8"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4)
    assert got["greedy_agreement"] == want["greedy_agreement"]
    assert got["rel_drift"] <= 0.0025


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_int8_matmul_kernel_matches_plain_on_card(dtype):
    """The Hopper kernels against their plain version on the card, at the
    TransformerLM-large shapes and ragged ones, on the route each takes
    (max |d| <= 1e-4 * max |plain|: only the f32 summation order
    differs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n in [(8, 2048, 6144), (32, 8192, 2048), (8, 2048, 32000),
                    (3, 100, 70), (40, 130, 201)]:
        x = torch.randn(m, k, generator=gen, device="cuda").to(
            getattr(torch, dtype))
        qw = tq.quantize_weight(torch.randn(k, n, generator=gen,
                                            device="cuda"))
        route = int8_route(x, qw.q)
        before = int8_matmul.launches[route]
        got = int8_matmul(x, qw.q, qw.s)
        want = int8_matmul_ref(x, qw.q, qw.s)
        torch.cuda.synchronize()
        assert int8_matmul.launches[route] == before + 1
        err = float((got - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), (m, k, n, err)
