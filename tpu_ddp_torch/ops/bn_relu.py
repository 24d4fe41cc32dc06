"""Fused BatchNorm (current-batch statistics) + ReLU, forward and backward.

Counterpart of tpu_ddp/ops/pallas/bn_relu.py: ``batch_norm_relu(x, scale,
bias, eps)`` normalises over every axis but the last with the batch's own
statistics (the reference's ``track_running_stats=False``,
part1/model.py:24), then applies ReLU. It is a ``torch.autograd.Function``
whose halves are the JAX kernels' four passes over the (R, C) row view:

- :func:`bn_stats` — per-channel mean and ``inv = 1/sqrt(var + eps)``,
  with the reference's ``var = max(E[x^2] - mean^2, 0)``;
- :func:`bn_norm_relu` — ``relu((x - mean) * (inv * scale) + bias)``;
- :func:`bn_bwd_stats` — the ReLU mask folded into ``gy``; per-channel
  ``sum(gy)`` (dbias) and ``sum(gy * x_hat)`` (dscale);
- :func:`bn_bwd_dx` — ``(scale * inv / R) * (R*gy - dbias - x_hat*dscale)``.

On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(``ops/csrc/bn_relu.cu``, built with nvcc at first use) and adds one to
its ``launches`` count; on a CPU tensor it computes its plain PyTorch
version (``*_ref`` below, the same arithmetic op by op). A failed build
or launch raises; nothing falls back.

The two reductions, ``bn_stats`` and ``bn_bwd_stats``, have two CUDA
designs, picked by :func:`stats_route` before the launch: ``"one_pass"``
(one launch whose last block to arrive combines the blocks' partials in
a fixed order, sized by :func:`stats_plan`: the main path) and
``"two_stage"`` (a partials kernel and a second, per-channel combine
launch: the previous design, kept for the same-run comparison). Their
``launches`` are dicts keyed by route. The one-pass kernels count their
arrivals in a zeroed workspace that :func:`_workspace` allocates once per
(device, stream) and that every launch leaves zeroed.
The kernels take only C-contiguous f32 (R, C) rows: the VGG model keeps
its activations ``channels_last``, so the conv output's NHWC view is
already that, with no copy.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from tpu_ddp_torch.ops import cuda_build

BN_EPS = 1e-5  # torch BatchNorm2d default; callers pass the model's eps

_SOURCE = "bn_relu.cu"
_THREADS = 256        # kThreads in the source
_BLOCKS_PER_SM = 4    # row blocks per SM the grid aims for
_ROWS_PER_LANE = 8    # rows a thread walks at least before more blocks
STATS_ROUTES = ("one_pass", "two_stage")
# The one-pass kernels: channel groups per block, most blocks in a
# cluster, column counters in a workspace (kOnePassGroups, kMaxCluster,
# kCounters in the source); the blocks per SM their grid aims for (at
# most their occupancy: 4 on an H100), and the rows each lane walks at
# least, two steps of the kernel's unrolled loads (kStatsUnroll,
# kBwdUnroll). Two blocks per SM, rather than four, keep the partials the
# last block sums few; on an H100 they were the faster grid at every
# VGG-11 shape.
_ONE_PASS_GROUPS = 32
_MAX_CLUSTER = 8
_COUNTERS = 1024
_ONE_PASS_BLOCKS_PER_SM = 2
_MIN_ROWS_PER_LANE = {"bn_stats": 8, "bn_bwd_stats": 4}


# ---- plain versions (the CPU route and the kernels' yardstick) -----------

def bn_stats_ref(x2d, eps=BN_EPS):
    """(mean, inv) per channel of (R, C) f32 rows."""
    r = x2d.shape[0]
    mean = x2d.sum(0) / r
    var = torch.clamp_min((x2d * x2d).sum(0) / r - mean * mean, 0.0)
    return mean, torch.rsqrt(var + eps)


def bn_norm_relu_ref(x2d, mean, inv, scale, bias):
    return ((x2d - mean) * (inv * scale) + bias).clamp_min(0.0)


def _masked_grad(x2d, g2d, mean, inv, scale, bias):
    x_hat = (x2d - mean) * inv
    y = x_hat * scale + bias
    return x_hat, torch.where(y > 0, g2d, torch.zeros_like(g2d))


def bn_bwd_stats_ref(x2d, g2d, mean, inv, scale, bias):
    """(dbias, dscale) per channel."""
    x_hat, gy = _masked_grad(x2d, g2d, mean, inv, scale, bias)
    return gy.sum(0), (gy * x_hat).sum(0)


def bn_bwd_dx_ref(x2d, g2d, mean, inv, scale, bias, dbias, dscale):
    r = x2d.shape[0]
    x_hat, gy = _masked_grad(x2d, g2d, mean, inv, scale, bias)
    return (scale * inv * (1.0 / r)) * (r * gy - dbias - x_hat * dscale)


def batch_norm_relu_ref(x, scale, bias, eps=BN_EPS):
    """The whole forward in plain PyTorch (differentiable by autograd),
    with the kernels' statistics formula."""
    shape = x.shape
    x2d = x.float().reshape(-1, shape[-1])
    mean, inv = bn_stats_ref(x2d, eps)
    y = bn_norm_relu_ref(x2d, mean, inv, scale.float(), bias.float())
    return y.reshape(shape).to(x.dtype)


# ---- kernel wrappers ------------------------------------------------------

@functools.cache
def _num_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(
        device_index).multi_processor_count


_ARGTYPES = {
    # x, R, C, vec, blocks, ps, pq, eps, mean, inv, stream
    "tdt_bn_stats": "piiiippfppp",
    # x, R, C, vec, blocks, cluster, ps, pq, counters, eps, mean, inv,
    # stream
    "tdt_bn_stats_onepass": "piiiiipppfppp",
    # x, g, mean, inv, scale, bias, R, C, vec, blocks, cluster, pdb, pds,
    # counters, dbias, dscale, stream
    "tdt_bn_bwd_stats_onepass": "ppppppiiiiipppppp",
    # bwd, vec, &blocks_per_sm
    "tdt_bn_onepass_blocks_per_sm": "iiP",
    # x, mean, inv, scale, bias, y, R, C, vec, blocks, stream
    "tdt_bn_norm_relu": "ppppppiiiip",
    # x, g, mean, inv, scale, bias, R, C, vec, blocks, pdb, pds, dbias,
    # dscale, stream
    "tdt_bn_bwd_stats": "ppppppiiiippppp",
    # x, g, mean, inv, scale, bias, dbias, dscale, dx, R, C, vec, blocks,
    # count, inv_count, stream
    "tdt_bn_bwd_dx": "pppppppppiiiiffp",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float,
           "P": ctypes.POINTER(ctypes.c_int)}


def _fn(name: str):
    fn = getattr(cuda_build.load(_SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = [_CTYPES[k] for k in _ARGTYPES[name]]
        fn.restype = ctypes.c_int
    return fn


def _route(name, rows, chans):
    """Check the operands and pick the route: ``None`` for the CPU (plain
    version), else ``(R, C, vec, blocks)`` for the kernel. ``rows`` are
    (R, C) tensors, ``chans`` (C,) tensors."""
    x = rows[0]
    if x.dim() != 2:
        raise ValueError(f"{name}: rows must be 2-D (R, C), got "
                         f"{tuple(x.shape)}")
    r, c = x.shape
    for t in rows[1:]:
        if tuple(t.shape) != (r, c):
            raise ValueError(f"{name}: rows of shape {tuple(t.shape)} "
                             f"beside {(r, c)}")
    for t in chans:
        if tuple(t.shape) != (c,):
            raise ValueError(f"{name}: channel vector of shape "
                             f"{tuple(t.shape)}, expected ({c},)")
    every = (*rows, *chans)
    if any(t.device != x.device for t in every):
        raise ValueError(f"{name}: operands on different devices")
    # The kernel's contract, held on both routes so that the CPU tests
    # check what the card will be given.
    for t in every:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes f32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes C-contiguous "
                             "tensors (keep the activations "
                             "channels_last)")
    if r < 1 or c < 1:
        raise ValueError(f"{name}: empty rows {(r, c)}")
    if x.device.type == "cpu":
        return None
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    if r * c >= 2 ** 31:
        raise ValueError(f"{name}: {r} x {c} elements exceed the kernel's "
                         "32-bit row index")
    vec = 4 if c % 4 == 0 and all(t.data_ptr() % 16 == 0
                                  for t in every) else 1
    lanes = _THREADS // min(c // vec, _THREADS)
    blocks = max(1, min(math.ceil(r / (lanes * _ROWS_PER_LANE)),
                        _BLOCKS_PER_SM * _num_sms(x.device.index)))
    return r, c, vec, blocks


def stats_route(r: int, c: int) -> str:
    """The design a CUDA call of :func:`bn_stats` or :func:`bn_bwd_stats`
    launches on (R, C) rows: always ``"one_pass"``. The ``"two_stage"``
    kernels run only where a caller forces this function's answer, to
    time the previous design beside the new one in the same run."""
    return "one_pass"


@dataclasses.dataclass(frozen=True)
class StatsPlan:
    """A one-pass launch: ``blocks`` row blocks (a multiple of
    ``cluster``) in each of ``columns`` column blocks of ``width``
    channels, ``lanes`` threads per channel group; the cluster leaders
    write ``partials = blocks // cluster`` rows per reduced quantity."""
    blocks: int
    cluster: int
    columns: int
    lanes: int
    width: int

    @property
    def partials(self) -> int:
        return self.blocks // self.cluster

    def rows(self, r: int, b: int) -> range:
        """The rows block ``b`` reduces (``block_rows`` in the source)."""
        return range(b * r // self.blocks, (b + 1) * r // self.blocks)


def stats_plan(name: str, r: int, c: int, vec: int, sms: int,
               per_sm: int) -> StatsPlan:
    """The one-pass grid for ``name`` (``"bn_stats"`` or
    ``"bn_bwd_stats"``) on (R, C) rows at ``vec`` channels per thread, on
    a card of ``sms`` SMs that hold ``per_sm`` of its blocks each.

    A block covers at most 32 channel groups, so a wide layer spreads its
    combine over several column blocks. The row blocks make one wave of
    ``min(per_sm, 2)`` blocks per SM, but each lane walks at least
    ``_MIN_ROWS_PER_LANE[name]`` rows: a small layer gets fewer, fuller
    blocks, so its combine stays short. Blocks form clusters of up to 8,
    whose leaders write one partial row each."""
    if c % vec:
        raise ValueError(f"{name}: C={c} is not a multiple of vec={vec}")
    groups = c // vec
    per_block = min(groups, _ONE_PASS_GROUPS)
    lanes = _THREADS // per_block
    columns = math.ceil(groups / per_block)
    if columns > _COUNTERS:
        raise ValueError(f"{name}: {c} channels need {columns} column "
                         f"blocks; the workspace counts {_COUNTERS}")
    slots = max(1, sms * min(per_sm, _ONE_PASS_BLOCKS_PER_SM) // columns)
    blocks = max(1, min(slots, r // (lanes * _MIN_ROWS_PER_LANE[name])))
    cluster = min(_MAX_CLUSTER, 1 << (blocks.bit_length() - 1))
    return StatsPlan(blocks=blocks // cluster * cluster, cluster=cluster,
                     columns=columns, lanes=lanes, width=per_block * vec)


_WORKSPACES: dict = {}


def _workspace(device, stream: int) -> torch.Tensor:
    """The one-pass kernels' arrival counters for ``stream`` (a raw
    stream handle) on ``device``: zeroed once, left zeroed by every
    launch. Launches on one stream run in order, so they share it."""
    key = (torch.device(device), stream)
    ws = _WORKSPACES.get(key)
    if ws is None:
        ws = _WORKSPACES[key] = torch.zeros(_COUNTERS, dtype=torch.int32,
                                            device=device)
    return ws


@functools.cache
def _blocks_per_sm(name: str, vec: int, device_index: int) -> int:
    """Resident blocks per SM of ``name``'s one-pass kernel at ``vec``,
    from the CUDA occupancy calculator."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _fn("tdt_bn_onepass_blocks_per_sm")(
            int(name == "bn_bwd_stats"), vec, ctypes.byref(out))
    if err or out.value < 1:
        raise RuntimeError(f"{name}: occupancy query failed (CUDA error "
                           f"{err}, {out.value} blocks per SM)")
    return out.value


def _one_pass(name, x2d, vec):
    """(plan, partials (2, P, C), counters) of a one-pass launch."""
    r, c = x2d.shape
    idx = x2d.device.index
    plan = stats_plan(name, r, c, vec, _num_sms(idx),
                      _blocks_per_sm(name, vec, idx))
    part = torch.empty((2, plan.partials, c), dtype=torch.float32,
                       device=x2d.device)
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    return plan, part, _workspace(x2d.device, stream)


def _launch(name, x, *args):
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _fn(name)(*args, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"(rows {tuple(x.shape)})")


def bn_stats(x2d, eps=BN_EPS):
    """Per-channel (mean, inv) of (R, C) f32 rows; kernel 6. Each CUDA
    launch adds one to ``bn_stats.launches[route]``, the route
    :func:`stats_route` picked."""
    route = _route("bn_stats", (x2d,), ())
    if route is None:
        return bn_stats_ref(x2d, eps)
    r, c, vec, blocks = route
    which = stats_route(r, c)
    mean = torch.empty((c,), dtype=torch.float32, device=x2d.device)
    inv = torch.empty_like(mean)
    if which == "one_pass":
        plan, part, ws = _one_pass("bn_stats", x2d, vec)
        _launch("tdt_bn_stats_onepass", x2d, x2d.data_ptr(), r, c, vec,
                plan.blocks, plan.cluster, part[0].data_ptr(),
                part[1].data_ptr(), ws.data_ptr(), float(eps),
                mean.data_ptr(), inv.data_ptr())
    else:
        part = torch.empty((2, blocks, c), dtype=torch.float32,
                           device=x2d.device)
        _launch("tdt_bn_stats", x2d, x2d.data_ptr(), r, c, vec, blocks,
                part[0].data_ptr(), part[1].data_ptr(), float(eps),
                mean.data_ptr(), inv.data_ptr())
    bn_stats.launches[which] += 1
    return mean, inv


def bn_norm_relu(x2d, mean, inv, scale, bias):
    """``relu((x - mean) * (inv * scale) + bias)``; kernel 7."""
    route = _route("bn_norm_relu", (x2d,), (mean, inv, scale, bias))
    if route is None:
        return bn_norm_relu_ref(x2d, mean, inv, scale, bias)
    r, c, vec, blocks = route
    y = torch.empty_like(x2d)
    _launch("tdt_bn_norm_relu", x2d, x2d.data_ptr(), mean.data_ptr(),
            inv.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            r, c, vec, blocks)
    bn_norm_relu.launches += 1
    return y


def bn_bwd_stats(x2d, g2d, mean, inv, scale, bias):
    """Per-channel (dbias, dscale) with the ReLU mask; kernel 8. Each CUDA
    launch adds one to ``bn_bwd_stats.launches[route]``."""
    route = _route("bn_bwd_stats", (x2d, g2d), (mean, inv, scale, bias))
    if route is None:
        return bn_bwd_stats_ref(x2d, g2d, mean, inv, scale, bias)
    r, c, vec, blocks = route
    which = stats_route(r, c)
    dbias = torch.empty((c,), dtype=torch.float32, device=x2d.device)
    dscale = torch.empty_like(dbias)
    ptrs = (x2d.data_ptr(), g2d.data_ptr(), mean.data_ptr(), inv.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), r, c, vec)
    if which == "one_pass":
        plan, part, ws = _one_pass("bn_bwd_stats", x2d, vec)
        _launch("tdt_bn_bwd_stats_onepass", x2d, *ptrs, plan.blocks,
                plan.cluster, part[0].data_ptr(), part[1].data_ptr(),
                ws.data_ptr(), dbias.data_ptr(), dscale.data_ptr())
    else:
        part = torch.empty((2, blocks, c), dtype=torch.float32,
                           device=x2d.device)
        _launch("tdt_bn_bwd_stats", x2d, *ptrs, blocks, part[0].data_ptr(),
                part[1].data_ptr(), dbias.data_ptr(), dscale.data_ptr())
    bn_bwd_stats.launches[which] += 1
    return dbias, dscale


def bn_bwd_dx(x2d, g2d, mean, inv, scale, bias, dbias, dscale):
    """The input gradient; kernel 9."""
    route = _route("bn_bwd_dx", (x2d, g2d),
                   (mean, inv, scale, bias, dbias, dscale))
    if route is None:
        return bn_bwd_dx_ref(x2d, g2d, mean, inv, scale, bias, dbias,
                             dscale)
    r, c, vec, blocks = route
    dx = torch.empty_like(x2d)
    _launch("tdt_bn_bwd_dx", x2d, x2d.data_ptr(), g2d.data_ptr(),
            mean.data_ptr(), inv.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), dbias.data_ptr(), dscale.data_ptr(),
            dx.data_ptr(), r, c, vec, blocks, float(r), 1.0 / r)
    bn_bwd_dx.launches += 1
    return dx


bn_stats.launches = dict.fromkeys(STATS_ROUTES, 0)
bn_bwd_stats.launches = dict.fromkeys(STATS_ROUTES, 0)
bn_norm_relu.launches = 0
bn_bwd_dx.launches = 0


# ---- the differentiable op ------------------------------------------------

def _rows_of(x, what):
    if not x.is_contiguous():
        raise ValueError(f"batch_norm_relu: {what} must be C-contiguous "
                         f"over its last axis, got strides {x.stride()} "
                         f"for shape {tuple(x.shape)}")
    return x.view(-1, x.shape[-1]).float()


class _BatchNormReLU(torch.autograd.Function):
    """Forward: bn_stats + bn_norm_relu. Backward: bn_bwd_stats +
    bn_bwd_dx. Saves ``(x, mean, inv, scale, bias)``, as the JAX op's
    ``_bn_relu_fwd`` does."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        x2d = _rows_of(x, "x")
        s32, b32 = scale.float(), bias.float()
        mean, inv = bn_stats(x2d, eps)
        y = bn_norm_relu(x2d, mean, inv, s32, b32)
        ctx.save_for_backward(x, mean, inv, scale, bias)
        return y.view(x.shape).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, mean, inv, scale, bias = ctx.saved_tensors
        x2d = _rows_of(x, "x")
        # Autograd hands back the gradient in the layout its consumer
        # made: in the VGG model a channels_last conv or pool, so the
        # NHWC rows are contiguous. Any other layout raises.
        g2d = _rows_of(g, "the gradient")
        s32, b32 = scale.float(), bias.float()
        dbias, dscale = bn_bwd_stats(x2d, g2d, mean, inv, s32, b32)
        dx = bn_bwd_dx(x2d, g2d, mean, inv, s32, b32, dbias, dscale)
        return (dx.view(x.shape).to(x.dtype), dscale.to(scale.dtype),
                dbias.to(bias.dtype), None)


def batch_norm_relu(x, scale, bias, eps=BN_EPS):
    """``relu(batch_norm(x))`` over (..., C) with current-batch statistics;
    differentiable w.r.t. ``x``, ``scale`` and ``bias``. Computes in f32
    whatever the input dtype and returns ``x.dtype``. ``x`` must be
    contiguous (its last axis the channels)."""
    return _BatchNormReLU.apply(x, scale, bias, float(eps))
