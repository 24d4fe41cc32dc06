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
launch: the previous design, kept for the same-run comparison). The
input gradient likewise, picked by :func:`dx_route`: ``"one_wave"`` (one
full wave of blocks, two rows' loads in flight per thread, x and g read
evict-first, sized by :func:`dx_plan`: the main path) and
``"row_blocks"`` (the previous design, f32 only). Their ``launches`` are
dicts keyed by route, with ``"_bf16"`` appended on bf16 rows. The
one-pass kernels count their arrivals in a zeroed workspace that
:func:`_workspace` allocates once per (device, stream) and that every
launch leaves zeroed.

The kernels take C-contiguous (R, C) rows and f32 channel vectors: the
models keep their activations ``channels_last``, so a conv output's NHWC
view is already that, with no copy. The forward pair takes f32 rows; the
backward pair f32 or bf16 rows (x and g of one dtype), upcast exactly in
registers, and ``bn_bwd_dx`` returns dx in the rows' dtype. On bf16 rows
every output is therefore the f32 route's on the upcast rows, dx then
rounded to bf16, bit for bit; the plain versions take the same operands
the same way. The op hands its backward's bf16 x and g to the kernels as
they are (:func:`bwd_rows`): no f32 copies, no cast of dx.
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
# The dtypes of the rows the backward pair takes (the forward pair: f32).
BWD_ROW_DTYPES = (torch.float32, torch.bfloat16)
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
# The one-wave dx kernel: the rows each lane walks at least before the
# grid takes more blocks (four steps of kDxUnroll's two rows in flight).
# On an H100 a full wave of shorter blocks was no faster at any ResNet-50
# shape, and slower at VGG-11's small ones.
_DX_MIN_ROWS_PER_LANE = 8
# The kernels whose grid is sized by their occupancy, as the source's
# tdt_bn_blocks_per_sm numbers them.
_OCCUPANCY_OF = {"bn_stats": 0, "bn_bwd_stats": 1, "bn_bwd_dx": 2}


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
    """(dbias, dscale) per channel, f32, of f32 or bf16 rows (upcast
    exactly; f32 rows are not copied)."""
    x_hat, gy = _masked_grad(x2d.float(), g2d.float(), mean, inv, scale,
                             bias)
    return gy.sum(0), (gy * x_hat).sum(0)


def bn_bwd_dx_ref(x2d, g2d, mean, inv, scale, bias, dbias, dscale):
    """dx in f32 from the upcast rows, returned in the rows' dtype."""
    r = x2d.shape[0]
    x_hat, gy = _masked_grad(x2d.float(), g2d.float(), mean, inv, scale,
                             bias)
    dx = (scale * inv * (1.0 / r)) * (r * gy - dbias - x_hat * dscale)
    return dx.to(x2d.dtype)


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
    # x, g, mean, inv, scale, bias, R, C, vec, bf16, blocks, cluster, pdb,
    # pds, counters, dbias, dscale, stream
    "tdt_bn_bwd_stats_onepass": "ppppppiiiiiipppppp",
    # which, vec, bf16, &blocks_per_sm
    "tdt_bn_blocks_per_sm": "iiiP",
    # x, mean, inv, scale, bias, y, R, C, vec, blocks, stream
    "tdt_bn_norm_relu": "ppppppiiiip",
    # x, g, mean, inv, scale, bias, R, C, vec, blocks, pdb, pds, dbias,
    # dscale, stream
    "tdt_bn_bwd_stats": "ppppppiiiippppp",
    # x, g, mean, inv, scale, bias, dbias, dscale, dx, R, C, vec, blocks,
    # count, inv_count, stream
    "tdt_bn_bwd_dx": "pppppppppiiiiffp",
    # x, g, mean, inv, scale, bias, dbias, dscale, dx, R, C, vec, bf16,
    # blocks, count, inv_count, stream
    "tdt_bn_bwd_dx_wave": "pppppppppiiiiiffp",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float,
           "P": ctypes.POINTER(ctypes.c_int)}


def _fn(name: str):
    fn = getattr(cuda_build.load(_SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = [_CTYPES[k] for k in _ARGTYPES[name]]
        fn.restype = ctypes.c_int
    return fn


def _route(name, rows, chans, row_dtypes=(torch.float32,), bf16_vec=4):
    """Check the operands and pick the route: ``None`` for the CPU (plain
    version), else ``(R, C, vec, blocks)`` for the kernel. ``rows`` are
    (R, C) tensors of one dtype from ``row_dtypes``, ``chans`` (C,) f32
    tensors. ``vec``: channels per thread, 4 on f32 rows and
    ``bf16_vec`` on bf16 rows where C and the pointers allow it, else 1;
    ``blocks``: the grid of the row-blocks and two-stage kernels."""
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
    if any(t.dtype != x.dtype for t in rows) or x.dtype not in row_dtypes:
        raise TypeError(f"{name}: the kernel takes rows of one dtype of "
                        f"{[str(d) for d in row_dtypes]}, got "
                        f"{[str(t.dtype) for t in rows]}")
    for t in chans:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes f32 channel "
                            f"vectors, got {t.dtype}")
    for t in every:
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
    want = 4 if x.dtype == torch.float32 else bf16_vec
    aligned = (all(t.data_ptr() % (want * x.element_size()) == 0
                   for t in rows)
               and all(t.data_ptr() % 16 == 0 for t in chans))
    vec = want if c % want == 0 and aligned else 1
    lanes = _THREADS // min(c // vec, _THREADS)
    blocks = max(1, min(math.ceil(r / (lanes * _ROWS_PER_LANE)),
                        _BLOCKS_PER_SM * _num_sms(x.device.index)))
    return r, c, vec, blocks


def _key(route: str, rows) -> str:
    """The ``launches`` key of a launch on ``route`` over ``rows``."""
    return route + "_bf16" if rows.dtype == torch.bfloat16 else route


def _f32_only(name, route, rows):
    if rows.dtype != torch.float32:
        raise TypeError(f"{name}: the {route!r} design takes f32 rows, got "
                        f"{rows.dtype}")


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


def dx_route(r: int, c: int) -> str:
    """The design a CUDA call of :func:`bn_bwd_dx` launches on (R, C) rows:
    always ``"one_wave"``. The ``"row_blocks"`` kernel (f32 rows only)
    runs only where a caller forces this function's answer, to time the
    previous design beside the new one in the same run."""
    return "one_wave"


@dataclasses.dataclass(frozen=True)
class DxPlan:
    """A one-wave dx launch: ``blocks`` row blocks in each of ``columns``
    column blocks, ``lanes`` threads per channel group."""
    blocks: int
    columns: int
    lanes: int

    def rows(self, r: int, b: int) -> range:
        """The rows block ``b`` writes (``block_rows`` in the source)."""
        return range(b * r // self.blocks, (b + 1) * r // self.blocks)


def dx_plan(r: int, c: int, vec: int, sms: int, per_sm: int) -> DxPlan:
    """The one-wave dx grid on (R, C) rows at ``vec`` channels per thread,
    on a card of ``sms`` SMs that hold ``per_sm`` of its blocks each: the
    column blocks times the row blocks fill every SM once, unless the
    rows are too few for each lane to walk ``_DX_MIN_ROWS_PER_LANE``."""
    if c % vec:
        raise ValueError(f"bn_bwd_dx: C={c} is not a multiple of vec={vec}")
    groups = c // vec
    per_block = min(groups, _THREADS)
    lanes = _THREADS // per_block
    columns = math.ceil(groups / per_block)
    blocks = max(1, min(sms * per_sm // columns,
                        r // (lanes * _DX_MIN_ROWS_PER_LANE)))
    return DxPlan(blocks=blocks, columns=columns, lanes=lanes)


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
def _blocks_per_sm(name: str, vec: int, device_index: int,
                   bf16: bool = False) -> int:
    """Resident blocks per SM of ``name``'s one-pass (or one-wave) kernel
    at ``vec``, on bf16 rows if ``bf16``, from the CUDA occupancy
    calculator."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _fn("tdt_bn_blocks_per_sm")(
            _OCCUPANCY_OF[name], vec, int(bf16), ctypes.byref(out))
    if err or out.value < 1:
        raise RuntimeError(f"{name}: occupancy query failed (CUDA error "
                           f"{err}, {out.value} blocks per SM)")
    return out.value


def _one_pass(name, x2d, vec):
    """(plan, partials (2, P, C), counters) of a one-pass launch."""
    r, c = x2d.shape
    idx = x2d.device.index
    plan = stats_plan(name, r, c, vec, _num_sms(idx),
                      _blocks_per_sm(name, vec, idx,
                                     x2d.dtype == torch.bfloat16))
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
    """Per-channel (dbias, dscale), f32, with the ReLU mask, of f32 or bf16
    rows; kernel 8. Each CUDA launch adds one to
    ``bn_bwd_stats.launches[key]``, the route :func:`stats_route` picked
    (``"_bf16"`` appended on bf16 rows)."""
    route = _route("bn_bwd_stats", (x2d, g2d), (mean, inv, scale, bias),
                   BWD_ROW_DTYPES)
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
        _launch("tdt_bn_bwd_stats_onepass", x2d, *ptrs,
                int(x2d.dtype == torch.bfloat16), plan.blocks, plan.cluster,
                part[0].data_ptr(), part[1].data_ptr(), ws.data_ptr(),
                dbias.data_ptr(), dscale.data_ptr())
    else:
        _f32_only("bn_bwd_stats", which, x2d)
        part = torch.empty((2, blocks, c), dtype=torch.float32,
                           device=x2d.device)
        _launch("tdt_bn_bwd_stats", x2d, *ptrs, blocks, part[0].data_ptr(),
                part[1].data_ptr(), dbias.data_ptr(), dscale.data_ptr())
    bn_bwd_stats.launches[_key(which, x2d)] += 1
    return dbias, dscale


def bn_bwd_dx(x2d, g2d, mean, inv, scale, bias, dbias, dscale):
    """The input gradient of f32 or bf16 rows, in the rows' dtype; kernel
    9. Each CUDA launch adds one to ``bn_bwd_dx.launches[key]``, the route
    :func:`dx_route` picked (``"_bf16"`` appended on bf16 rows)."""
    route = _route("bn_bwd_dx", (x2d, g2d),
                   (mean, inv, scale, bias, dbias, dscale), BWD_ROW_DTYPES,
                   bf16_vec=8)
    if route is None:
        return bn_bwd_dx_ref(x2d, g2d, mean, inv, scale, bias, dbias,
                             dscale)
    r, c, vec, blocks = route
    which = dx_route(r, c)
    dx = torch.empty_like(x2d)
    ptrs = (x2d.data_ptr(), g2d.data_ptr(), mean.data_ptr(), inv.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), dbias.data_ptr(),
            dscale.data_ptr(), dx.data_ptr(), r, c, vec)
    if which == "one_wave":
        bf16 = x2d.dtype == torch.bfloat16
        idx = x2d.device.index
        plan = dx_plan(r, c, vec, _num_sms(idx),
                       _blocks_per_sm("bn_bwd_dx", vec, idx, bf16))
        _launch("tdt_bn_bwd_dx_wave", x2d, *ptrs, int(bf16), plan.blocks,
                float(r), 1.0 / r)
    else:
        _f32_only("bn_bwd_dx", which, x2d)
        _launch("tdt_bn_bwd_dx", x2d, *ptrs, blocks, float(r), 1.0 / r)
    bn_bwd_dx.launches[_key(which, x2d)] += 1
    return dx


bn_stats.launches = dict.fromkeys(STATS_ROUTES, 0)
bn_bwd_stats.launches = dict.fromkeys(("one_pass", "one_pass_bf16",
                                       "two_stage"), 0)
bn_norm_relu.launches = 0
bn_bwd_dx.launches = dict.fromkeys(("one_wave", "one_wave_bf16",
                                    "row_blocks"), 0)


# ---- the differentiable op ------------------------------------------------

def _rows_of(x, what, upcast=True):
    if not x.is_contiguous():
        raise ValueError(f"batch_norm_relu: {what} must be C-contiguous "
                         f"over its last axis, got strides {x.stride()} "
                         f"for shape {tuple(x.shape)}")
    rows = x.view(-1, x.shape[-1])
    return rows.float() if upcast else rows


def bwd_rows(x_dtype, g_dtype) -> str:
    """The rows the op's backward hands its kernels: ``"bf16"`` when the
    saved x and its gradient are both bf16 (as they are, no copies; dx
    comes back bf16), else ``"f32"`` (f32 rows, any other dtype upcast,
    dx cast back to x's dtype). For bf16 x and g, ``"f32"`` is the
    previous route, run only where a caller forces this function's answer
    to time it beside the new one in the same run: the same bits."""
    return "bf16" if x_dtype == g_dtype == torch.bfloat16 else "f32"


def bn_relu_backward(x, g, mean, inv, scale, bias):
    """The op's backward: (dx in ``x``'s shape and dtype, dscale, dbias
    f32) from the saved ``x``, its statistics and the output's gradient
    ``g``, both C-contiguous over their last axis."""
    upcast = bwd_rows(x.dtype, g.dtype) == "f32"
    x2d = _rows_of(x, "x", upcast)
    # Autograd hands back the gradient in the layout its consumer made:
    # in the models a channels_last conv or pool, so the NHWC rows are
    # contiguous. Any other layout raises.
    g2d = _rows_of(g, "the gradient", upcast)
    s32, b32 = scale.float(), bias.float()
    dbias, dscale = bn_bwd_stats(x2d, g2d, mean, inv, s32, b32)
    dx = bn_bwd_dx(x2d, g2d, mean, inv, s32, b32, dbias, dscale)
    return dx.view(x.shape).to(x.dtype), dscale, dbias


class _BatchNormReLU(torch.autograd.Function):
    """Forward: bn_stats + bn_norm_relu. Backward: bn_bwd_stats +
    bn_bwd_dx (:func:`bn_relu_backward`). Saves ``(x, mean, inv, scale,
    bias)``, as the JAX op's ``_bn_relu_fwd`` does."""

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
        dx, dscale, dbias = bn_relu_backward(x, g, mean, inv, scale, bias)
        return dx, dscale.to(scale.dtype), dbias.to(bias.dtype), None


def batch_norm_relu(x, scale, bias, eps=BN_EPS):
    """``relu(batch_norm(x))`` over (..., C) with current-batch statistics;
    differentiable w.r.t. ``x``, ``scale`` and ``bias``. Computes in f32
    whatever the input dtype and returns ``x.dtype``; on a bf16 ``x`` and
    gradient the backward's kernels read and write bf16 rows. ``x`` must
    be contiguous (its last axis the channels)."""
    return _BatchNormReLU.apply(x, scale, bias, float(eps))
