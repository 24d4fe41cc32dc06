"""K train steps captured as one CUDA graph: the card's counterpart of
the JAX trainers' ``lax.scan`` over K steps (tpu_ddp/train/engine.py
``build_multi_step``, tpu_ddp/train/lm.py ``build_multi_step``).

A captured step reads static staging buffers and writes the state's own
tensors in place, so every tensor a step of any rung writes must be one
the state holds across steps (:func:`written`): the parameters (FSDP's
flat shard buffer), every tensor of the optimizer state (momentum,
ZeRO's and the sharded update's slices, AdamW's and Adafactor's slots,
the device step count) and the int8 wire's carry (``seed``,
``residual``), each advanced in place by the step that owns it
(ops/optim.py, parallel/compress.py:GradCompressor.commit). A state
made anew holds other tensors, so the trainers capture again for it,
keyed on their addresses.

Before the capture, eager warm-up steps run on the capture stream and
are then undone (:func:`snapshot`, :func:`restore`): they build the
kernels, let cuDNN choose its algorithms, create the NCCL communicator
and the BN kernels' arrival counters for that stream
(``ops/bn_relu.py:_workspace`` keys them by stream), and take
``DistributedDataParallel`` past the iterations where it samples its
runtime statistics, so none of these happens inside the capture.
Everything the captured steps allocate (gradients, saved activations,
collective buffers) comes from the graph's private pool, at the same
addresses on every replay.
"""

from __future__ import annotations

import time

import torch


def tensors(tree) -> list:
    """Every tensor of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors(v)]
    return []


def written(state, extra=()) -> list:
    """Every tensor a step writes in place: the state's parameters, its
    optimizer state and its gradient wire's carry (``comp_state``, where
    the state has one), then ``extra`` (FSDP's flat shard buffer)."""
    return [*tensors(state.params), *tensors(state.opt_state),
            *tensors(getattr(state, "comp_state", None)), *extra]


def snapshot(tensors_) -> list:
    """Copies of ``tensors_`` (detached: a copy that kept a parameter's
    autograd graph alive would keep its gradient accumulator, made on
    another stream, and break a capture)."""
    return [(t, t.detach().clone()) for t in tensors_]


@torch.no_grad()
def restore(saved: list) -> None:
    for t, copy in saved:
        t.copy_(copy)


def stack_like(tensors_, device) -> torch.Tensor:
    """(K, *shape) on ``device`` from K same-shape tensors, each slice
    with the first tensor's layout (a channels_last batch stays
    channels_last, so a staged step sees the loader's strides)."""
    t0 = tensors_[0]
    shape = tuple(t0.shape)
    if (t0.dim() == 4 and not t0.is_contiguous()
            and t0.is_contiguous(memory_format=torch.channels_last)):
        n, c, h, w = shape
        out = torch.empty((len(tensors_), n, h, w, c), dtype=t0.dtype,
                          device=device).permute(0, 1, 4, 2, 3)
    else:
        out = torch.empty((len(tensors_),) + shape, dtype=t0.dtype,
                          device=device)
    for j, t in enumerate(tensors_):
        out[j].copy_(t)
    return out


class GraphGroup:
    """K steps of ``step(state, x, y) -> (state, row)`` captured as one
    CUDA graph on ``stream``.

    The graph reads the static staging buffers ``xs``/``ys`` (filled by
    :meth:`stage` before each replay), writes the tensors of
    ``written_`` in place and stacks the K rows into ``out``. ``warmup``
    eager steps on the first batch run before the capture and are undone.
    A capture the card refuses raises ``NotImplementedError`` carrying
    the card's error and ROADMAP item 9.5d; nothing runs eager steps in
    its place."""

    def __init__(self, step, state, xs, ys, *, device, stream, written_,
                 warmup: int = 1):
        self.k = len(xs)
        self.xs = stack_like(xs, device)
        self.ys = stack_like(ys, device)
        saved = snapshot(written_)
        cur = torch.cuda.current_stream(device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            for _ in range(warmup):
                step(state, self.xs[0], self.ys[0])
        cur.wait_stream(stream)
        restore(saved)
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                rows = []
                st = state
                for j in range(self.k):
                    st, row = step(st, self.xs[j], self.ys[j])
                    rows.append(row)
                self.out = torch.stack(rows)
        except RuntimeError as e:
            raise NotImplementedError(
                f"the card refused to capture {self.k} steps as one CUDA "
                f"graph (ROADMAP Queue 1 item 9.5d): {e}") from e
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def stage(self, xs, ys) -> None:
        """Copy a group's K batches into the static buffers (queued on
        the current stream, ahead of the replay)."""
        for j in range(self.k):
            self.xs[j].copy_(xs[j], non_blocking=True)
            self.ys[j].copy_(ys[j], non_blocking=True)

    def replay(self) -> None:
        self.graph.replay()


class GraphCache:
    """The captured groups of one K: one per batch layout, for the state
    tensors they were captured on. A state holding other tensors (one
    made anew: ``init_state``, ``state_from_host``,
    ``restore_checkpoint``) clears them, so its first group captures
    again. ``make(state, xs, ys)`` captures a :class:`GraphGroup`."""

    def __init__(self, make):
        self._make = make
        self._graphs: dict = {}
        self._held = None

    def run(self, state, written_, xs, ys) -> torch.Tensor:
        """Stage ``xs``/``ys``, replay their group (captured first if
        needed) and return a copy of its stacked rows; ``written_`` is
        what the state's steps write (:func:`written`)."""
        ptrs = tuple(t.data_ptr() for t in written_)
        if ptrs != self._held:
            self._graphs.clear()
            self._held = ptrs
        key = (len(xs), tuple(xs[0].shape), xs[0].stride(), xs[0].dtype,
               tuple(ys[0].shape), ys[0].dtype)
        if key not in self._graphs:
            self._graphs[key] = self._make(state, xs, ys)
        grp = self._graphs[key]
        grp.stage(xs, ys)
        grp.replay()
        return grp.out.clone()
