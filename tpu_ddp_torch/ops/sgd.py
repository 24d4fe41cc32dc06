"""Fused SGD (momentum, weight decay) update over every parameter.

Counterpart of tpu_ddp/ops/pallas/sgd.py: the torch-semantics update
(reference part1/main.py:124-125)::

    g   <- grad + wd * p        (skipped when wd == 0)
    buf <- momentum * buf + g
    p   <- p - lr * buf

On CUDA tensors :func:`fused_sgd_step` launches the hand-written Hopper
kernel (``ops/csrc/sgd.cu``) once for all leaves (up to 80 per launch)
and adds one to ``fused_sgd_step.launches`` per launch; on CPU tensors it
computes :func:`fused_sgd_step_ref`, the plain PyTorch version. Both
update ``p`` and ``buf`` in place, as the JAX kernel aliases them
(``input_output_aliases={0: 0, 2: 1}``), and round identically op by op,
so on the card the two agree bit for bit. Nothing falls back.

``skip`` gates the update for the step guard (resilience/guard.py): a
0-d f32 (or int32, converted) tensor on the leaves' device. When it is
nonzero the kernel writes nothing and the plain version keeps the old
values through ``where``, leaf by leaf (the JAX step's
``select_update``); zero, or absent, gives exactly the ungated update.
The flag is read on the device, so the host never waits for it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpu_ddp_torch.ops import cuda_build

_SOURCE = "sgd.cu"
_MAX_LEAVES = 80  # kMaxLeaves in the source: the table is a kernel argument


def fused_sgd_step_ref(params, grads, bufs, *, lr: float, momentum: float,
                       weight_decay: float, skip=None):
    """Plain version: the same update, leaf by leaf, in place; with
    ``skip``, the new values only where ``skip`` is zero."""
    from tpu_ddp_torch.resilience.guard import select_update
    for p, g, b in zip(params, grads, bufs):
        if weight_decay:
            g = g + weight_decay * p
        if skip is None:
            b.mul_(momentum).add_(g)
            p.sub_(lr * b)
            continue
        new_b = b * momentum + g
        new_p = p - lr * new_b
        kept_p, kept_b = select_update(skip, [p, b], [new_p, new_b])
        p.copy_(kept_p)
        b.copy_(kept_b)
    return params, bufs


def _lib():
    fn = cuda_build.load(_SOURCE).tdt_sgd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_float, ctypes.c_float, ctypes.c_int, p, p]
        fn.restype = ctypes.c_int
    return fn


def _check_skip(skip, dev):
    if skip is None:
        return None
    if not isinstance(skip, torch.Tensor) or skip.numel() != 1:
        raise ValueError("skip must be a one-element tensor")
    if skip.device != dev:
        raise ValueError(f"skip on {skip.device}, leaves on {dev}")
    if skip.dtype == torch.int32:
        skip = skip.to(torch.float32)
    if skip.dtype != torch.float32:
        raise TypeError(f"skip must be f32 or int32, got {skip.dtype}")
    return skip.contiguous()


def fused_sgd_step(params, grads, bufs, *, lr: float, momentum: float,
                   weight_decay: float, skip=None):
    """Update every ``params[i]`` and ``bufs[i]`` in place from
    ``grads[i]``, unless ``skip`` (a 0-d f32 or int32 tensor on the same
    device) is nonzero; returns ``(params, bufs)``. All tensors f32,
    contiguous, on one device, each triple of one shape. A skipped launch
    is still a launch and is counted."""
    params, grads, bufs = list(params), list(grads), list(bufs)
    if not len(params) == len(grads) == len(bufs):
        raise ValueError(f"{len(params)} params, {len(grads)} grads, "
                         f"{len(bufs)} momentum buffers")
    if not params:
        return params, bufs
    dev = params[0].device
    for i, (p, g, b) in enumerate(zip(params, grads, bufs)):
        if not (p.shape == g.shape == b.shape):
            raise ValueError(f"leaf {i}: shapes {tuple(p.shape)}, "
                             f"{tuple(g.shape)}, {tuple(b.shape)}")
        if not (p.device == g.device == b.device == dev):
            raise ValueError(f"leaf {i}: tensors on different devices")
        if not (p.dtype == g.dtype == b.dtype == torch.float32):
            raise TypeError(f"leaf {i}: SGD takes f32 params, grads and "
                            f"momentum, got {p.dtype}, {g.dtype}, "
                            f"{b.dtype}")
        if not (p.is_contiguous() and g.is_contiguous()
                and b.is_contiguous()):
            raise ValueError(f"leaf {i}: the kernel takes contiguous "
                             "tensors")
    skip = _check_skip(skip, dev)
    if dev.type == "cpu":
        return fused_sgd_step_ref(params, grads, bufs, lr=lr,
                                  momentum=momentum,
                                  weight_decay=weight_decay, skip=skip)
    if dev.type != "cuda":
        raise ValueError(f"fused_sgd_step runs on cuda or cpu, not {dev}")
    if any(p.numel() >= 2 ** 31 for p in params):
        raise ValueError("a leaf of 2**31 or more elements exceeds the "
                         "kernel's 32-bit index")
    live = [i for i, p in enumerate(params) if p.numel()]
    skip_ptr = None if skip is None else skip.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for s in range(0, len(live), _MAX_LEAVES):
            group = live[s:s + _MAX_LEAVES]
            ptrs = np.array([[params[i].data_ptr(), grads[i].data_ptr(),
                              bufs[i].data_ptr(), params[i].numel()]
                             for i in group], dtype=np.int64)
            cols = [np.ascontiguousarray(ptrs[:, k]) for k in range(4)]
            vec = int(all(v % 16 == 0 for v in ptrs[:, :3].ravel()))
            err = _lib()(*(c.ctypes.data for c in cols), len(group),
                         lr, momentum, weight_decay, vec, skip_ptr, stream)
            if err:
                raise cuda_build.KernelError(
                    f"fused_sgd_step launch failed: CUDA error {err} "
                    f"({len(group)} leaves)")
            fused_sgd_step.launches += 1
    return params, bufs


fused_sgd_step.launches = 0
