"""Weight-only int8 matmul: ``x @ (q * s)`` without materialising fp
weights — the quantized-decode compute kernel (ops/quant.py).

Counterpart of tpu_ddp/ops/pallas/quant_matmul.py. On a CUDA tensor
:func:`int8_matmul` launches one of two hand-written Hopper kernels
(``ops/csrc/int8_matmul.cu``, built with nvcc at first use), picked by
:func:`int8_route` before the launch: ``"mma"`` (bf16 tensor-core
products fed by a TMA ring, for bf16 x and 16-byte-addressable rows:
the serving path) or ``"simt"`` (f32 FMAs, for f32 x and ragged
shapes). On a CPU tensor it computes :func:`int8_matmul_ref`, the plain
PyTorch version of the same function. The CUDA path never falls back: a
failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from tpu_ddp_torch.ops import cuda_build

_SOURCE = "int8_matmul.cu"
ROUTES = ("mma", "simt")
# Output columns per block on both routes (kMmaBN, kBlockN in the source),
# the K granule a split is rounded to (kMmaBK: one stage of the mma ring)
# and the most splits (the mma route's splits form one cluster:
# kMaxClusterSplits).
_BLOCK_N = 128
_K_STEP = {"mma": 64, "simt": 1}
_MAX_SPLITS = {"mma": 16}
_MIN_K_PER_SPLIT = {"mma": 128, "simt": 256}  # K rows a split keeps
_BLOCKS_PER_SM = 2     # grid size the split-K choice aims for


def int8_matmul_ref(x, q, s):
    """Plain version: ``(x.f32 @ q.f32) * s`` over the last axis of
    ``x``; returns (..., N) f32."""
    k, n = q.shape
    out = x.reshape(-1, k).float() @ q.float()
    return (out * s.float()).reshape(*x.shape[:-1], n)


def _rows_per_tile(m: int) -> int:
    return 8 if m <= 8 else 16 if m <= 16 else 32


def split_k(m: int, k: int, n: int, num_sms: int,
            route: str = "simt") -> tuple[int, int]:
    """(splits, k_per_split) for an (m, k) x (k, n) product on ``route``:
    split K across blocks when the column tiles alone would leave SMs
    idle, but keep each split at least ``_MIN_K_PER_SPLIT`` rows long; on
    the mma route a split is a whole number of ring stages, and a tile
    has at most 16 splits (one cluster)."""
    tiles = math.ceil(n / _BLOCK_N) * math.ceil(m / _rows_per_tile(m))
    want = math.ceil(_BLOCKS_PER_SM * num_sms / tiles)
    splits = max(1, min(want, k // _MIN_K_PER_SPLIT[route],
                        _MAX_SPLITS.get(route, want)))
    if splits == 1:
        return 1, k
    step = _K_STEP[route]
    k_per_split = step * math.ceil(k / splits / step)
    return math.ceil(k / k_per_split), k_per_split


def int8_route(x, q) -> str:
    """The kernel a CUDA call of :func:`int8_matmul` launches, from dtype,
    shapes and base pointers alone: ``"mma"`` for bf16 ``x`` when its
    rows and ``q``'s allow 16-byte copies (K % 8 == 0, N % 16 == 0, both
    base pointers 16-byte aligned; a non-contiguous ``x`` is copied into
    a fresh, aligned buffer first), else ``"simt"``."""
    k, n = q.shape
    x_aligned = not x.is_contiguous() or x.data_ptr() % 16 == 0
    if (x.dtype == torch.bfloat16 and k % 8 == 0 and n % 16 == 0
            and x_aligned and q.data_ptr() % 16 == 0):
        return "mma"
    return "simt"


@functools.cache
def _num_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(
        device_index).multi_processor_count


def _lib():
    lib = cuda_build.load(_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    sigs = {"tdt_int8_matmul": [p, i, p, p, p, p, i, i, i, i, i, p],
            "tdt_int8_matmul_mma": [p, p, p, p, i, i, i, i, i, p]}
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def int8_matmul(x, q, s):
    """``x @ (q.f32 * s)`` in f32, weights read as int8.

    ``x``: (..., K) activations, f32 or bf16; ``q``: (K, N) int8;
    ``s``: (N,) f32 per-output-column scales. Returns (..., N) f32.
    Leading axes of ``x`` are flattened into rows and restored. Each
    launch of a CUDA kernel adds one to ``int8_matmul.launches[route]``,
    the route :func:`int8_route` picked.
    """
    if q.dtype != torch.int8 or q.dim() != 2:
        raise TypeError(f"q must be a 2-D int8 tensor, got {q.dtype} "
                        f"{tuple(q.shape)}")
    k, n = q.shape
    if x.shape[-1] != k:
        raise ValueError(f"x has K={x.shape[-1]}, q has K={k}")
    if s.dtype != torch.float32 or tuple(s.shape) != (n,):
        raise TypeError(f"s must be an f32 ({n},) tensor, got {s.dtype} "
                        f"{tuple(s.shape)}")
    if not (x.device == q.device == s.device):
        raise ValueError(f"x, q, s on different devices: {x.device}, "
                         f"{q.device}, {s.device}")
    if x.device.type == "cpu":
        return int8_matmul_ref(x, q, s)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cuda or cpu, not {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be f32 or bf16 on cuda, got {x.dtype}")
    if not (q.is_contiguous() and s.is_contiguous()):
        raise ValueError("q and s must be contiguous")
    if q.data_ptr() % 4:
        raise ValueError("q must be 4-byte aligned (char4 loads)")
    route = int8_route(x, q)
    lead = x.shape[:-1]
    x2d = x.reshape(-1, k).contiguous()
    m = x2d.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out.reshape(*lead, n)
    if k == 0:
        return out.zero_().reshape(*lead, n)
    splits, kps = split_k(m, k, n, _num_sms(x.device.index), route)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        lib = _lib()
        if route == "mma":  # the splits sum in the kernel
            err = lib.tdt_int8_matmul_mma(
                x2d.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                m, k, n, splits, kps, stream)
        else:
            partial = (torch.empty((splits, m, n), dtype=torch.float32,
                                   device=x.device) if splits > 1 else None)
            err = lib.tdt_int8_matmul(
                x2d.data_ptr(), int(x2d.dtype == torch.bfloat16),
                q.data_ptr(), s.data_ptr(), out.data_ptr(),
                partial.data_ptr() if partial is not None else None,
                m, k, n, splits, kps, stream)
    if err:
        raise RuntimeError(f"int8_matmul ({route}) launch failed: CUDA error "
                           f"{err} (M={m}, K={k}, N={n}, splits={splits})")
    int8_matmul.launches[route] += 1
    return out.reshape(*lead, n)


int8_matmul.launches = dict.fromkeys(ROUTES, 0)
