"""Flash attention: exact softmax attention on (B, L, H, D) tensors,
causal or not, with grouped-query K/V — the LM family's hot op.

Counterpart of tpu_ddp/ops/pallas/flash_attention.py. Three Pallas
kernels, each behind its own wrapper with a launch count:

- :func:`flash_fwd` — the online-softmax forward, returning ``o`` and the
  logsumexp ``lse`` (B, H, L) f32 the backward needs (``_fwd_kernel``);
- :func:`flash_bwd_kv` — the dk/dv sweep, accumulating every q head of a
  KV head's group (``_bwd_kv_kernel``);
- :func:`flash_bwd_q` — the dq sweep (``_bwd_q_kernel``).

Each kernel has two CUDA versions, and :func:`fwd_route` (the forward)
and :func:`bwd_route` (the two sweeps) pick one from the inputs before
the launch: ``"wgmma"`` (Hopper's warpgroup products fed by TMA, for
bf16 with D in {64, 128} and inputs the TMA can address: 16-byte aligned
base pointers and B, L, head strides that are multiples of 16 bytes) or
``"mma_sync"`` (everything else the op takes: f32, other head dims,
unaligned views). Each wrapper counts its launches per route in
``launches``, a dict keyed by route.

On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(``ops/csrc/flash_attention.cu``, built with nvcc at first use) and never
falls back; on a CPU tensor it computes its plain PyTorch version
(``*_plain``), which does the same arithmetic on the whole (L, L) score
matrix in f32 with the same rounding points: p rounded to v's dtype
before p . v in the forward, p and ds rounded to q's dtype in the
backward. :func:`flash_attention` is the differentiable op, an
``autograd.Function`` whose backward is the two sweeps;
``delta = rowsum(dO * o)`` is a plain f32 reduction, as the JAX package
computes it outside any kernel.

K/V may carry KV < H heads (H % KV == 0, head h reads KV head
h // (H / KV), the ``jnp.repeat`` order). Every input must be contiguous
along D; the kernels read the other axes through their strides, so v may
be a strided view of the fused qkv product. Head dims up to 128.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tpu_ddp_torch.ops import cuda_build

_SOURCE = "flash_attention.cu"
MAX_HEAD_DIM = 128
NEG_INF = -1e30


def _check(q, k, v):
    """(B, L, H, KV, D) of a valid call; raises on anything the kernels
    do not take, on both routes."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention takes (B, L, H, D) tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, L, h, d = q.shape
    kvh = k.shape[2]
    if (k.shape != v.shape or k.shape[0] != b or k.shape[1] != L
            or k.shape[3] != d):
        raise ValueError(f"k and v must be (B, L, KV, D) = ({b}, {L}, KV, "
                         f"{d}), got {tuple(k.shape)}, {tuple(v.shape)}")
    if kvh < 1 or h % kvh:
        raise ValueError(f"flash_attention: {h} query heads not divisible "
                         f"by {kvh} KV heads")
    if d > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"flash_attention: head_dim {d} > {MAX_HEAD_DIM} is not ported "
            "to tpu_ddp_torch yet (ROADMAP Queue 2)")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along D (stride 1),"
                             f" got strides {t.stride()}")
    return b, L, h, kvh, d


def _heads(x, group: int):
    """(B, L, KV, D) -> (B, H, L, D) f32, each KV head repeated ``group``
    times (the ``jnp.repeat`` order)."""
    return x.float().repeat_interleave(group, dim=2).transpose(1, 2)


def _scores(q, k, causal: bool):
    """(B, H, L, L) f32 scores q . k^T * scale, masked with -1e30 above
    the diagonal when causal (``_masked_scores``)."""
    b, L, h, d = q.shape
    s = torch.matmul(q.float().transpose(1, 2),
                     _heads(k, h // k.shape[2]).transpose(-1, -2))
    s = s * (1.0 / math.sqrt(d))
    if causal:
        above = torch.ones(L, L, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(above, NEG_INF)
    return s


def _fold_groups(x, kvh: int):
    """(B, H, L, D) per-q-head f32 sums -> (B, L, KV, D), each KV head the
    f32 sum over its group."""
    b, h, L, d = x.shape
    return x.reshape(b, kvh, h // kvh, L, d).sum(2).transpose(1, 2)


def flash_fwd_plain(q, k, v, causal: bool = False):
    """Plain forward: ``(o, lse)``, o like q, lse (B, H, L) f32."""
    b, L, h, kvh, d = _check(q, k, v)
    s = _scores(q, k, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), _heads(v, h // kvh)) / l_safe
    lse = (m + torch.log(l_safe))[..., 0]
    return o.transpose(1, 2).to(q.dtype).contiguous(), lse


def _p_ds(q, k, v, do, lse, delta, causal):
    """The backward's recomputation (``_recompute_p_ds``): p and ds, both
    rounded to q's dtype and returned in f32, (B, H, L, L)."""
    b, L, h, d = q.shape
    s = _scores(q, k, causal)
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(do.float().transpose(1, 2),
                      _heads(v, h // k.shape[2]).transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * (1.0 / math.sqrt(d))
    return p.to(q.dtype).float(), ds.to(q.dtype).float()


def flash_bwd_kv_plain(q, k, v, do, lse, delta, causal: bool = False):
    """Plain dk/dv sweep: ``(dk, dv)`` in k's and v's dtypes, each KV
    head's gradient summed over its group in f32."""
    b, L, h, kvh, d = _check(q, k, v)
    p, ds = _p_ds(q, k, v, do, lse, delta, causal)
    dv = torch.matmul(p.transpose(-1, -2), do.float().transpose(1, 2))
    dk = torch.matmul(ds.transpose(-1, -2), q.float().transpose(1, 2))
    return (_fold_groups(dk, kvh).to(k.dtype).contiguous(),
            _fold_groups(dv, kvh).to(v.dtype).contiguous())


def flash_bwd_q_plain(q, k, v, do, lse, delta, causal: bool = False):
    """Plain dq sweep: dq like q."""
    b, L, h, kvh, d = _check(q, k, v)
    _, ds = _p_ds(q, k, v, do, lse, delta, causal)
    dq = torch.matmul(ds, _heads(k, h // kvh))
    return dq.transpose(1, 2).to(q.dtype).contiguous()


# ---- the kernels -----------------------------------------------------------

def _lib():
    lib = cuda_build.load(_SOURCE)
    p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
    tail = [i, i, i, i, i, f, i, i, i, p]  # B H KV L D scale causal bf16 vec s
    wg_tail = [i, i, i, i, i, f, i, p]     # B H KV L D scale causal s
    sigs = {"tdt_flash_fwd": [p] * 5 + [ll] * 9 + tail,
            "tdt_flash_fwd_wgmma": [p] * 5 + [ll] * 9 + wg_tail,
            "tdt_flash_bwd_kv": [p] * 8 + [ll] * 12 + tail,
            "tdt_flash_bwd_q": [p] * 7 + [ll] * 12 + tail,
            "tdt_flash_bwd_kv_wgmma": [p] * 8 + [ll] * 12 + wg_tail,
            "tdt_flash_bwd_q_wgmma": [p] * 7 + [ll] * 12 + wg_tail}
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _strides(t):
    return t.stride(0), t.stride(1), t.stride(2)


def _vec(tensors, d: int) -> bool:
    """Whether every input allows the kernels' 16-byte loads."""
    n = 16 // tensors[0].element_size()
    return d % n == 0 and all(
        t.data_ptr() % 16 == 0 and all(s % n == 0 for s in _strides(t))
        for t in tensors)


ROUTES = ("wgmma", "mma_sync")
WGMMA_HEAD_DIMS = (64, 128)


def _wgmma_takes(q, *others) -> bool:
    """bf16 with D in {64, 128}, every tensor allowing 16-byte loads (what
    the TMA copies need)."""
    d = q.shape[-1]
    return (q.dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS
            and _vec((q, *others), d))


def fwd_route(q, k, v) -> str:
    """The forward kernel a CUDA call of :func:`flash_fwd` launches, from
    dtype, head dim, strides and base pointers alone: ``"wgmma"`` when
    q, k and v allow it, else ``"mma_sync"``."""
    return "wgmma" if _wgmma_takes(q, k, v) else "mma_sync"


def bwd_route(q, k, v, do) -> str:
    """The backward kernel a CUDA call of :func:`flash_bwd_kv` or
    :func:`flash_bwd_q` launches, by :func:`fwd_route`'s rule with dO
    among the inputs."""
    return "wgmma" if _wgmma_takes(q, k, v, do) else "mma_sync"


def _cuda_checks(name, q, extra=()):
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} takes bf16 or f32 on cuda, got {q.dtype}")
    for what, t, want in extra:
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != want or not t.is_contiguous()):
            raise ValueError(f"{name}: {what} must be a contiguous f32 "
                             f"{want} tensor on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _launch(name, fn, args, shape):
    err = fn(*args)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"(B, L, H, KV, D = {shape})")


def flash_fwd(q, k, v, causal: bool = False):
    """``(o, lse)``: o (B, L, H, D) like q, lse (B, H, L) f32. Each launch
    adds one to ``flash_fwd.launches[route]``, the route :func:`fwd_route`
    picked."""
    b, L, h, kvh, d = _check(q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal)
    _cuda_checks("flash_fwd", q)
    o = torch.empty((b, L, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, L), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    route = fwd_route(q, k, v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), *_strides(q), *_strides(k), *_strides(v),
                b, h, kvh, L, d, 1.0 / math.sqrt(d), int(causal))
        if route == "wgmma":
            fn, args = _lib().tdt_flash_fwd_wgmma, args + (stream,)
        else:
            fn, args = _lib().tdt_flash_fwd, args + (
                int(q.dtype == torch.bfloat16), int(_vec((q, k, v), d)),
                stream)
        _launch(f"flash_fwd ({route})", fn, args, (b, L, h, kvh, d))
    flash_fwd.launches[route] += 1
    return o, lse


def _bwd_inputs(name, q, k, v, do, lse, delta):
    b, L, h, kvh, d = _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"{name}: dO must match q ({tuple(q.shape)}, "
                         f"{q.dtype}), got {tuple(do.shape)}, {do.dtype}")
    if do.stride(-1) != 1:
        raise ValueError(f"{name}: dO must be contiguous along D (stride 1),"
                         f" got strides {do.stride()}")
    return b, L, h, kvh, d


def flash_bwd_kv(q, k, v, do, lse, delta, causal: bool = False):
    """``(dk, dv)``, each (B, L, KV, D) in k's dtype, from the forward's
    inputs, dO (like q), its lse and ``delta = rowsum(dO * o)`` (B, H, L)
    f32. Each launch adds one to ``flash_bwd_kv.launches[route]``, the
    route :func:`bwd_route` picked."""
    b, L, h, kvh, d = _bwd_inputs("flash_bwd_kv", q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_kv_plain(q, k, v, do, lse, delta, causal)
    _cuda_checks("flash_bwd_kv", q, (("lse", lse, (b, h, L)),
                                     ("delta", delta, (b, h, L))))
    dk = torch.empty((b, L, kvh, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, L, kvh, d), dtype=v.dtype, device=v.device)
    if dk.numel() == 0:
        return dk, dv
    route = bwd_route(q, k, v, do)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), *_strides(q), *_strides(k), *_strides(v),
                *_strides(do), b, h, kvh, L, d, 1.0 / math.sqrt(d),
                int(causal))
        if route == "wgmma":
            fn, args = _lib().tdt_flash_bwd_kv_wgmma, args + (stream,)
        else:
            fn, args = _lib().tdt_flash_bwd_kv, args + (
                int(q.dtype == torch.bfloat16),
                int(_vec((q, k, v, do), d)), stream)
        _launch(f"flash_bwd_kv ({route})", fn, args, (b, L, h, kvh, d))
    flash_bwd_kv.launches[route] += 1
    return dk, dv


def flash_bwd_q(q, k, v, do, lse, delta, causal: bool = False):
    """dq (B, L, H, D) like q; inputs as :func:`flash_bwd_kv`. Each launch
    adds one to ``flash_bwd_q.launches[route]``."""
    b, L, h, kvh, d = _bwd_inputs("flash_bwd_q", q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_q_plain(q, k, v, do, lse, delta, causal)
    _cuda_checks("flash_bwd_q", q, (("lse", lse, (b, h, L)),
                                    ("delta", delta, (b, h, L))))
    dq = torch.empty((b, L, h, d), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    route = bwd_route(q, k, v, do)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                *_strides(q), *_strides(k), *_strides(v), *_strides(do),
                b, h, kvh, L, d, 1.0 / math.sqrt(d), int(causal))
        if route == "wgmma":
            fn, args = _lib().tdt_flash_bwd_q_wgmma, args + (stream,)
        else:
            fn, args = _lib().tdt_flash_bwd_q, args + (
                int(q.dtype == torch.bfloat16),
                int(_vec((q, k, v, do), d)), stream)
        _launch(f"flash_bwd_q ({route})", fn, args, (b, L, h, kvh, d))
    flash_bwd_q.launches[route] += 1
    return dq


flash_fwd.launches = dict.fromkeys(ROUTES, 0)
flash_bwd_kv.launches = dict.fromkeys(ROUTES, 0)
flash_bwd_q.launches = dict.fromkeys(ROUTES, 0)


def attention_delta(o, do):
    """delta = rowsum(dO * o) in f32, (B, H, L): the backward's one plain
    reduction (``_bwd_impl``'s delta, outside the kernels)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = attention_delta(o, do)
        dk, dv = flash_bwd_kv(q, k, v, do, lse, delta, ctx.causal)
        dq = flash_bwd_q(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = False):
    """Exact multi-head attention, flash-style: (B, L, H, D) in and out,
    differentiable through the flash backward. Drop-in for
    ``parallel/ring_attention.py:full_attention``."""
    return _FlashAttention.apply(q, k, v, causal)
