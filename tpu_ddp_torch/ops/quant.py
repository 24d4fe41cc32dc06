"""Weight-only int8 quantization for decode compute — the port of
tpu_ddp/ops/quant.py.

Decode is memory-bandwidth-bound: every engine step streams the whole
parameter set to produce one token per sequence. The dense projection
weights are therefore stored per-output-channel int8 and dequantized
inside the matmul:

    y @ W  ≈  (y @ Q) * s        Q int8 (in, out), s f32 (out,)

The scale commutes with the contraction because it is per OUTPUT column,
so the fp weights are never materialised. Embeddings and LayerNorms stay
in the compute dtype.

:func:`qdot` is the one dispatch point every decode-path matmul routes
through. A plain tensor takes the fp product in f32 (operands rounded to
the compute dtype, products accumulated and returned in f32, as JAX's
``preferred_element_type=float32``). A :class:`QuantizedWeight` goes to
ops/quant_matmul.py ``int8_matmul``: the Hopper kernel on a CUDA tensor,
its plain version on a CPU tensor.

Tensor-parallel serving (``quantize_params(tp=..., rank=...)``): JAX
quantizes the tree as placed, and GSPMD takes each column's absmax over
the whole contraction axis. For the column-parallel projections (qkv,
``w1``) a column's absmax is its slice's; for the row-parallel ``wo``
and ``w2`` the contraction axis is the sharded one, and a per-shard
absmax would give other scales. So every weight is quantized dense and
then cut to the rank's Megatron slice (parallel/tensor_parallel.py
``serve_param_specs``): ``q`` and ``s`` each a contiguous tensor of its
own (16-byte aligned, as the int8 kernel's ``mma`` route wants), bit for
bit the dense quantization's slice.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from tpu_ddp_torch.ops.quant_matmul import int8_matmul

__all__ = ["QuantizedWeight", "quantize_weight", "dequantize",
           "quantize_params", "qdot", "decode_forward_logits",
           "stream_nll", "nll_drift", "DECODE_QUANTS"]

DECODE_QUANTS = ("none", "int8")


@dataclasses.dataclass(frozen=True)
class QuantizedWeight:
    """One int8-quantized weight in matmul layout: ``q`` (in, out) int8
    with ``out`` contiguous, ``s`` (out,) f32 per-output-channel scales.
    Symmetric (no zero point): ``W ≈ q * s``."""

    q: torch.Tensor
    s: torch.Tensor


def quantize_weight(w, reshape=None) -> QuantizedWeight:
    """Per-output-channel symmetric int8: ``s_c = max|w[:, c]| / 127``,
    ``q = round(w / s)`` with ties to even. ``reshape`` first brings a
    multi-axis weight into its 2-D (in, out) matmul layout."""
    w = w.to(torch.float32)
    if reshape is not None:
        w = w.reshape(reshape)
    if w.dim() != 2:
        raise ValueError(f"quantize_weight wants a 2-D matmul layout, "
                         f"got shape {tuple(w.shape)}")
    amax = w.abs().amax(dim=0)
    # An all-zero column quantizes to zeros under any scale; 1.0 keeps
    # the division finite without changing the result.
    s = torch.where(amax > 0, amax, torch.ones_like(amax)) / 127.0
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return QuantizedWeight(q=q.contiguous(), s=s.contiguous())


def dequantize(qw: QuantizedWeight):
    """f32 reconstruction ``q * s`` — tests and error bounds only; the
    serving path never materialises this."""
    return qw.q.to(torch.float32) * qw.s[None, :]


def qdot(y, w, cd, reshape=None):
    """The one decode-path matmul dispatch: ``y @ w`` returned in f32.

    Plain tensor ``w``: ``y`` and ``w.to(cd).reshape(reshape)`` multiplied
    with f32 products and sums. :class:`QuantizedWeight`: the fused
    weight-only int8 matmul (``reshape`` is ignored — quantized weights
    are stored in matmul layout). Callers cast back to ``cd`` where the
    JAX package does."""
    if isinstance(w, QuantizedWeight):
        return int8_matmul(y.to(cd), w.q, w.s)
    w = w.to(cd)
    if reshape is not None:
        w = w.reshape(reshape)
    return torch.matmul(y.to(cd).to(torch.float32), w.to(torch.float32))


def quantize_params(model, params, tp: int = 1, rank: int = 0,
                    device=None):
    """Quantize every decode-path projection of a dense transformer
    parameter dict: per-block wqkv/wq/wkv, wo, w1/w2, plus the LM head.
    Embedding and LayerNorm leaves pass through. Returns a NEW dict of
    the same structure with :class:`QuantizedWeight` matmul leaves. At
    ``tp > 1`` every leaf is rank ``rank``'s tensor-parallel slice of
    the dense tree's (each weight quantized whole first), a tensor of
    its own on ``device`` (default: where the leaf lies)."""
    dm = model.d_model
    sliced, bspec = params, None
    if tp > 1:
        from tpu_ddp_torch.parallel.tensor_parallel import (
            serve_param_specs, shard_decode_params)
        bspec = serve_param_specs(model)["blocks"][0]
        sliced = shard_decode_params(model, params, tp, rank, device)

    def quant(name, w, reshape=None):
        qw = quantize_weight(w, reshape=reshape)
        if tp == 1:
            return qw
        spec = bspec[name] if name != "head" else ()
        return _rank_slice(qw, spec, tp, rank, device, shape=w.shape)

    def one_block(blk, sl):
        out = dict(sl)
        for name in ("wqkv", "wq", "wkv"):
            if name in blk:
                out[name] = quant(name, blk[name], reshape=(dm, -1))
        out["wo"] = quant("wo", blk["wo"], reshape=(-1, dm))
        out["w1"] = quant("w1", blk["w1"])
        out["w2"] = quant("w2", blk["w2"])
        return out

    out = dict(sliced)
    out["blocks"] = tuple(one_block(blk, sl) for blk, sl
                          in zip(params["blocks"], sliced["blocks"]))
    out["head"] = quant("head", params["head"])
    return out


def _rank_slice(x: QuantizedWeight, spec, tp: int, rank: int, device,
                shape) -> QuantizedWeight:
    """Rank ``rank``'s slice by ``spec`` of the quantized weight ``x`` of
    a weight of ``shape``, tensors of its own: ``q`` viewed as the weight
    (its leading dims the contraction rows of the 2-D layout), ``s`` as
    the weight's column dims."""
    from tpu_ddp_torch.convert import cell_of
    idx, sizes = {"mp": rank}, {"mp": tp}

    def own(t):
        return t.to(device if device is not None else t.device,
                    copy=True).contiguous()

    k, n = 0, 1
    while n < x.q.shape[0]:
        n *= shape[k]
        k += 1
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    q = cell_of(x.q.view(shape), spec, idx, sizes)
    s = cell_of(x.s.view(shape[k:]), spec[k:], idx, sizes)
    return QuantizedWeight(q=own(q.reshape(-1, s.numel())),
                           s=own(s.reshape(-1)))


@torch.no_grad()
def decode_forward_logits(model, params, tokens):
    """Full-sequence logits (B, L, V) f32 through the DECODE math path
    (project_qkv / attend_cached / block_finish / head_apply) — the
    program the serving engine runs, for fp and quantized dicts
    alike."""
    from tpu_ddp_torch.models.decode import (attend_cached, block_finish,
                                             project_qkv)

    cd = model.compute_dtype
    L = tokens.shape[1]
    pos = torch.arange(L, device=tokens.device)
    x = params["embed"][tokens].to(cd)
    for blk in params["blocks"]:
        q, k, v = project_qkv(model, blk, x, pos)
        o = attend_cached(model, q, k.to(cd), v.to(cd), pos)
        x = block_finish(model, blk, x, o)
    return model.head_apply(params, x)


def stream_nll(model, params, tokens) -> torch.Tensor:
    """Mean next-token NLL of ``tokens`` (B, L) through the decode path."""
    logits = decode_forward_logits(model, params, tokens)
    logp = F.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None])
    return nll.mean()


def nll_drift(model, params, qparams, tokens) -> dict:
    """Relative mean-NLL drift of the quantized dict vs the fp dict on a
    token stream, plus greedy next-token agreement and the largest
    logit error."""
    lf = decode_forward_logits(model, params, tokens)
    lq = decode_forward_logits(model, qparams, tokens)
    nll_f = float(stream_nll(model, params, tokens))
    nll_q = float(stream_nll(model, qparams, tokens))
    agree = float((lf.argmax(-1) == lq.argmax(-1)).float().mean())
    return {
        "nll_fp32": nll_f,
        "nll_int8": nll_q,
        "rel_drift": abs(nll_q - nll_f) / max(abs(nll_f), 1e-12),
        "greedy_agreement": agree,
        "max_abs_logit_err": float((lq - lf).abs().max()),
    }
