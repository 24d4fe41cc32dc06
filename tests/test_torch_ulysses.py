"""Ulysses attention in the port (tpu_ddp_torch/parallel/ulysses.py), the
sp-sharded TransformerLM and ``LMTrainer(sp=..., sp_mode="ulysses")``,
held against the JAX package on the same numpy-seeded inputs, f32.

The port runs in real gloo processes (tests/torch_sp.py, one subprocess
per rank, 150 s limit); JAX runs under ``shard_map`` on the virtual CPU
devices, its flash kernel in interpret mode. On the CPU the port's flash
route is the kernels' plain versions.

Tolerances:

- Ulysses at sp = 2 and 4 on the blockwise route (causal and not), the
  flash route, grouped K/V exchanged grouped (KV % sp == 0) and expanded
  before the exchange (KV % sp != 0), and the cache prepend with
  ``q_offset``: the output within rtol and atol 2e-5 and the q, k, v
  gradients within 5e-5 of JAX's (tests/test_ulysses.py's bounds);
- the sp-sharded TransformerLM-tiny forward in Ulysses mode at sp = 2:
  logits within 2e-5 of the JAX model on a (1, 2) mesh and of the port
  at sp = 1;
- two LMTrainer steps at (dp, sp) = (1, 2) and (2, 2): losses within
  1e-4 and params within rtol 3e-4 / atol 3e-5 of the JAX ``LMTrainer``
  (tests/test_torch_moe.py's bounds); Adafactor under ZeRO-1
  (``FactoredZeRO1``) at sp = 2 within rtol 1e-5 / atol 1e-6 of
  replicated Adafactor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from torch_sp import (PRESET, SEQ, jax_attention, jax_lm, jax_params,
                      port_init, qkv, rank_losses, run_attention, run_lm,
                      tokens)
from tpu_ddp.models import make_transformer as jax_make
from tpu_ddp.parallel.mesh import SEQ_AXIS, make_mesh
from tpu_ddp.parallel.ulysses import ulysses_attention as jax_ulysses
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.parallel.ulysses import ulysses_attention
from tpu_ddp_torch.train.lm import make_lm_batch

OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)
LOSS_ATOL = 1e-4
STEP_TOL = dict(rtol=3e-4, atol=3e-5)

# name -> (the case, its inputs' shape arguments to qkv); H = 8 heads so
# that sp = 4 leaves two per process.
ULYSSES = {
    "blockwise": (dict(scheme="ulysses", causal=False), dict(h=8, kvh=8)),
    "blockwise_causal": (dict(scheme="ulysses", causal=True),
                         dict(h=8, kvh=8)),
    "flash": (dict(scheme="ulysses", causal=False, flash=True),
              dict(h=8, kvh=8, L=32, d=16)),
    "flash_causal": (dict(scheme="ulysses", causal=True, flash=True),
                     dict(h=8, kvh=8, L=32, d=16)),
    "gqa_grouped": (dict(scheme="ulysses", causal=True), dict(h=8, kvh=4)),
    "gqa_expanded": (dict(scheme="ulysses", causal=True), dict(h=8, kvh=2)),
    "cache": (dict(scheme="ulysses", causal=True, q_offset=12),
              dict(h=8, kvh=8, cache=16)),
    "gqa_cache": (dict(scheme="ulysses", causal=True, q_offset=12),
                  dict(h=8, kvh=2, cache=16)),
}
ARRAYS = {n: qkv(100 + i, **shape) for i, (n, (_, shape)) in
          enumerate(ULYSSES.items())}


@pytest.fixture(scope="module", params=[2, 4], ids=["sp2", "sp4"])
def ulysses_run(request, tmp_path_factory):
    sp = request.param
    got = run_attention(tmp_path_factory.mktemp(f"uly{sp}"), sp,
                        {n: c for n, (c, _) in ULYSSES.items()}, ARRAYS,
                        f"uly{sp}")
    return sp, got


@pytest.mark.parametrize("name", list(ULYSSES))
def test_ulysses_attention_matches_jax(ulysses_run, name):
    sp, got = ulysses_run
    want = jax_attention("ulysses", sp, ULYSSES[name][0], ARRAYS[name])
    np.testing.assert_allclose(got[name]["o"], want["o"], **OUT_TOL)
    for t in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[name][t], want[t], **GRAD_TOL,
                                   err_msg=t)


def _jax_error(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_head_divisibility_and_flash_cache_raise_as_in_jax():
    """Both checks fire before any exchange, with JAX's words."""
    a = {k: v for k, v in qkv(7, h=4, kvh=4, cache=8).items()}
    jq, tq = jnp.asarray(a["q"]), torch.from_numpy(a["q"])
    for kw in (dict(axis_size=8), dict(axis_size=2, flash=True)):
        extra = {} if "flash" not in kw else dict(cache_k=a["ck"],
                                                  cache_v=a["cv"])
        want = _jax_error(lambda: jax_ulysses(
            jq, jq, jq, SEQ_AXIS, **kw,
            **{k: jnp.asarray(v) for k, v in extra.items()}))
        got = _jax_error(lambda: ulysses_attention(
            tq, tq, tq, None, **kw,
            **{k: torch.from_numpy(v) for k, v in extra.items()}))
        assert got == want
    with pytest.raises(ValueError, match="axis_size"):
        ulysses_attention(tq, tq, tq, None, None)


def test_model_refuses_ulysses_heads_as_in_jax():
    jm = jax_make(PRESET, max_seq_len=SEQ, compute_dtype=jnp.float32)
    tm = make_transformer(PRESET, max_seq_len=SEQ,
                          compute_dtype=torch.float32)
    for sp, mode in ((8, "ulysses"), (2, "zigzag")):
        want = _jax_error(lambda: jm.with_sequence_parallel(SEQ_AXIS, sp,
                                                            mode=mode))
        got = _jax_error(lambda: tm.with_sequence_parallel("sp", sp,
                                                           mode=mode))
        assert got == want


# ---- the model and the trainer --------------------------------------------

RUNS_2 = {"ulysses": dict(sp=2, mode="ulysses", preset=PRESET,
                          forward=True),
          "adafactor": dict(sp=2, mode="ulysses", preset=PRESET,
                            optimizer="adafactor"),
          "adafactor_zero1": dict(sp=2, mode="ulysses", preset=PRESET,
                                  optimizer="adafactor", opt="zero1")}
RUNS_4 = {"ulysses": dict(sp=2, mode="ulysses", preset=PRESET)}


@pytest.fixture(scope="module")
def lm2(tmp_path_factory):
    return run_lm(tmp_path_factory.mktemp("lm2"), 2, RUNS_2, "lm2")


@pytest.fixture(scope="module")
def lm4(tmp_path_factory):
    return run_lm(tmp_path_factory.mktemp("lm4"), 4, RUNS_4, "lm4")


def test_sp_sharded_forward_matches_jax_mesh_and_sp1(lm2):
    got = np.concatenate([rec["ulysses/logits"] for rec in lm2], axis=1)
    params, tm = port_init()
    x, _ = make_lm_batch(tokens())
    want = tm.apply(params, torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    from tpu_ddp_torch.convert import params_to_jax
    jm = jax_make(PRESET, max_seq_len=SEQ, compute_dtype=jnp.float32)
    jm = jm.with_sequence_parallel(SEQ_AXIS, 2, mode="ulysses")
    mesh = make_mesh(jax.devices()[:2], dp=1, sp=2)
    f = jax.jit(jax.shard_map(lambda p, t: jm.apply(p, t), mesh=mesh,
                              in_specs=(P(), P(None, SEQ_AXIS)),
                              out_specs=P(None, SEQ_AXIS), check_vma=False))
    jl = f(jax.tree.map(jnp.asarray, params_to_jax(params)),
           jnp.asarray(x, jnp.int32))
    np.testing.assert_allclose(got, np.asarray(jl), rtol=2e-5, atol=2e-5)


def test_factored_zero1_at_sp2_matches_replicated(lm2):
    """Adafactor under ZeRO-1 (``FactoredZeRO1`` over the dp group) at
    sp = 2 against replicated Adafactor: rtol 1e-5 / atol 1e-6 (the same
    sums, grouped differently)."""
    tol = dict(rtol=1e-5, atol=1e-6)
    for rec in lm2:
        np.testing.assert_allclose(rec["adafactor_zero1/losses"],
                                   rec["adafactor/losses"], **tol)
    keys = [k[len("adafactor/"):] for k in lm2[0]
            if k.startswith("adafactor/params.")]
    assert keys
    for key in keys:
        np.testing.assert_allclose(lm2[0][f"adafactor_zero1/{key}"],
                                   lm2[0][f"adafactor/{key}"], **tol,
                                   err_msg=key)


@pytest.mark.parametrize("dp", [1, 2])
def test_trainer_matches_jax(lm2, lm4, dp):
    recs = lm2 if dp == 1 else lm4
    want_losses, jstate = jax_lm(dp, 2, "ulysses")
    np.testing.assert_allclose(rank_losses(recs, "ulysses", dp, 2),
                               want_losses, atol=LOSS_ATOL, rtol=0)
    for key, want in jax_params(jstate).items():
        np.testing.assert_allclose(recs[0][f"ulysses/{key}"], want,
                                   **STEP_TOL, err_msg=key)
