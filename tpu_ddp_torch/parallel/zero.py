"""ZeRO-1 and FSDP (ZeRO-3) over a ``torch.distributed`` group
(tpu_ddp/parallel/zero.py): the fourth and fifth rungs of the ladder.

The flat layout (:class:`_FlatLayout`, JAX ``_FlatLayout``): each leaf, in
its CANONICAL layout (the JAX package's shape, e.g. HWIO conv kernels),
flattens and zero-pads to ``ceil(size/N) * N`` elements, and rank r owns
the contiguous r-th chunk. The shard a rank holds is therefore the same
bytes as the JAX shard of the same leaf, padding tail included. Here all
of a rank's chunks sit side by side in one ``(total_chunk,)`` buffer
(leaf i at ``offsets[i]``), so one ``reduce_scatter_tensor`` and one
``all_gather_into_tensor`` move every leaf: the send buffer is
``(N, total_chunk)``, row r the concatenation of every leaf's r-th chunk.
Per leaf the result is JAX's ``psum_scatter`` / tiled ``all_gather``;
only the number of collective calls differs.

- :class:`ZeRO1` (JAX ``ZeRO1``): optimizer state lives as 1/N shards.
  ``apply`` reduce-scatters the local gradients (the mean over the group:
  SUM, then / N), clips by the global norm from the slices (one scalar
  ``all_reduce``), runs the inner optimizer on the slices with the
  weight-decay mask of the ORIGINAL leaf ranks, and all-gathers the
  updated parameters. ``apply_scattered`` starts from slices already
  reduce-scattered (``scatter_grads``, or a ZeRO-2 accumulation of them).
- :class:`ZeRO3` (JAX ``ZeRO3``): the parameters themselves live as the
  rank's shard buffer. ``gather_params`` all-gathers them inside a
  ``torch.autograd.Function`` whose backward reduce-scatters the
  cotangent with SUM (the transpose of the gather), so the shard's
  gradient arrives already synchronized; the trainer divides it by N.

Host-side converters (``shard_params``, ``unshard_host``,
``canonicalize_opt_host``, ``flatten_opt``) work on numpy arrays in the
canonical layout, so a flat layout never reaches a checkpoint.

Without an initialized process group the layout runs with N = 1 and no
collective (the identity); with one, every collective is issued, also at
a world of one (NCCL then moves nothing but runs the same calls).

The model-parallel partition of the JAX layout (``param_specs``,
``_leaf_partition``: tp/ep/pp-sharded leaves laid out per cell) comes
with tensor, expert and pipeline parallelism (ROADMAP Queue 1 items
10.6-10.8), and the factored ZeRO-1 for Adafactor (``FactoredZeRO1``)
with item 9.4's rest.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist


def _chunk(size: int, n: int) -> int:
    return -(-size // n)


def _group_info(group):
    """(N, rank) of ``group``; (1, 0) without a process group."""
    if group is None or not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


class _FlatLayout:
    """The flat padded layout of a list of leaves over a group of N.

    ``shapes`` are the leaves' canonical shapes, in the order every rank
    agrees on. ``group`` is the process group (``dist.group.WORLD``), or
    None: one rank, no collectives. ``axis_size`` overrides N (host-side
    conversions only, e.g. for another dp size). ``param_specs`` (the JAX
    layout's model-parallel partition) raises, naming its items."""

    def __init__(self, shapes, group=None, axis_size: int | None = None,
                 rank: int | None = None, param_specs=None):
        if param_specs is not None:
            raise NotImplementedError(
                "a model-parallel partition of the flat layout "
                "(param_specs: tp/ep/pp-sharded leaves laid out per cell) "
                "is not ported to tpu_ddp_torch yet (ROADMAP Queue 1 items "
                "10.6-10.8)")
        n, r = _group_info(group)
        self.group = (group if group is not None and dist.is_initialized()
                      else None)
        self.axis_size = n if axis_size is None else int(axis_size)
        self.rank = r if rank is None else int(rank)
        if self.axis_size < 1 or not 0 <= self.rank < self.axis_size:
            raise ValueError(f"rank {self.rank} of {self.axis_size}")
        self.shapes = [tuple(int(d) for d in s) for s in shapes]
        self.sizes = [math.prod(s) for s in self.shapes]
        self.chunks = [_chunk(s, self.axis_size) for s in self.sizes]
        self.offsets = np.concatenate([[0], np.cumsum(self.chunks)]
                                      ).astype(int).tolist()
        self.total_chunk = self.offsets[-1]

    # ---- host side (numpy, canonical layout) ----------------------------

    def shard_params(self, leaves) -> list:
        """Canonical leaves -> each one flat and zero-padded to
        ``chunk * N`` (the global flat layout; rank r's shard is its r-th
        chunk)."""
        return [np.pad(np.asarray(p).reshape(-1),
                       (0, c * self.axis_size - s))
                for p, s, c in zip(leaves, self.sizes, self.chunks)]

    def unshard_host(self, flats) -> list:
        """Global flat padded arrays -> canonical leaves (the inverse of
        :meth:`shard_params`)."""
        return [np.asarray(x)[:s].reshape(shape)
                for x, s, shape in zip(flats, self.sizes, self.shapes)]

    def local_host(self, flats, rank: int | None = None) -> np.ndarray:
        """Rank ``rank``'s ``(total_chunk,)`` buffer of global flat
        arrays (default: this rank)."""
        r = self.rank if rank is None else rank
        return np.concatenate(
            [np.asarray(x)[r * c:(r + 1) * c]
             for x, c in zip(flats, self.chunks)]).astype(np.float32)

    def canonicalize_opt_host(self, flats) -> list:
        """Global flat optimizer-state leaves -> canonical (checkpoint
        write path)."""
        return self.unshard_host(flats)

    def flatten_opt(self, leaves) -> list:
        """Canonical optimizer-state leaves -> global flat (restore)."""
        return self.shard_params(leaves)

    # ---- device side ----------------------------------------------------

    def views(self, buf) -> list:
        """Per-leaf views into a ``(total_chunk,)`` buffer (each
        contiguous)."""
        return [buf[o:o + c] for o, c in zip(self.offsets, self.chunks)]

    def shard_zeros(self, device, dtype=torch.float32):
        """``(buffer, views)`` of zeros shaped like the shards: the ZeRO-2
        accumulation buffer and fresh optimizer state."""
        buf = torch.zeros(self.total_chunk, dtype=dtype, device=device)
        return buf, self.views(buf)

    def rows(self, leaves, dtype=torch.float32):
        """``(N, total_chunk)``: row r holds every leaf's r-th chunk (the
        send buffer of the reduce-scatter), built by one concatenation."""
        n = self.axis_size
        parts = []
        for t, s, c in zip(leaves, self.sizes, self.chunks):
            flat = t.detach().reshape(-1).to(dtype)
            if c * n != s:
                flat = torch.nn.functional.pad(flat, (0, c * n - s))
            parts.append(flat.view(n, c))
        return torch.cat(parts, dim=1)

    def local_shards(self, leaves):
        """``(buffer, views)``: this rank's chunk of each full leaf, no
        collective (the parameter slices of ZeRO-1's update)."""
        r = self.rank
        parts = []
        for t, s, c in zip(leaves, self.sizes, self.chunks):
            lo, hi = min(r * c, s), min((r + 1) * c, s)
            parts.append(t.detach().reshape(-1)[lo:hi].float())
            if hi - lo < c:
                parts.append(parts[-1].new_zeros(c - (hi - lo)))
        buf = torch.cat(parts)
        return buf, self.views(buf)

    def reduce_scatter_sum(self, rows):
        """SUM over the group of ``(N, total_chunk)`` rows -> this rank's
        ``(total_chunk,)``."""
        if self.group is None:
            return rows[0].clone()
        out = torch.empty(self.total_chunk, dtype=rows.dtype,
                          device=rows.device)
        dist.reduce_scatter_tensor(out, rows.reshape(-1),
                                   op=dist.ReduceOp.SUM, group=self.group)
        return out

    def all_gather_rows(self, buf):
        """Every rank's ``(total_chunk,)`` buffer -> ``(N, total_chunk)``."""
        if self.group is None:
            return buf.reshape(1, -1).clone()
        out = torch.empty(self.axis_size * self.total_chunk,
                          dtype=buf.dtype, device=buf.device)
        dist.all_gather_into_tensor(out, buf.contiguous(),
                                    group=self.group)
        return out.view(self.axis_size, self.total_chunk)

    def leaves_of_rows(self, rows) -> list:
        """``(N, total_chunk)`` -> the canonical full leaves (each leaf's
        chunks in rank order, padding dropped)."""
        return [rows[:, o:o + c].reshape(-1)[:s].view(shape)
                for o, c, s, shape in zip(self.offsets, self.chunks,
                                          self.sizes, self.shapes)]

    def scatter_grads(self, grads):
        """``(buffer, views)``: this rank's f32 slice of the group-MEAN of
        each leaf of ``grads`` (canonical layout): the ZeRO-2 building
        block."""
        buf = self.reduce_scatter_sum(self.rows(grads))
        buf /= self.axis_size
        return buf, self.views(buf)

    def gather(self, buf) -> list:
        """This rank's shard buffer -> every canonical full leaf."""
        return self.leaves_of_rows(self.all_gather_rows(buf))

    def sq_norm(self, slices):
        """The global f32 sum of squares of dp-scattered slices: each
        rank's squared sum, one scalar ``all_reduce``."""
        sq = torch.stack([g.float().square().sum() for g in slices]).sum()
        if self.group is not None:
            dist.all_reduce(sq, op=dist.ReduceOp.SUM, group=self.group)
        return sq


def _inner_apply(inner, params, grads, state, decay_mask, skip):
    """The inner optimizer's in-place update, with the decay mask of the
    original leaves (AdamW) and the guard's flag (SGD)."""
    kw = {}
    if skip is not None:
        kw["skip"] = skip
    if hasattr(inner, "decay_mask"):
        kw["decay_mask"] = decay_mask
    return inner.apply(params, grads, state, **kw)


class ZeRO1(_FlatLayout):
    """An elementwise optimizer (SGD, AdamW) with its state sharded 1/N
    over ``group``. ``init`` builds the inner state over this rank's
    shard views; ``apply``/``apply_scattered`` take and return canonical
    full leaves."""

    def __init__(self, inner, shapes, group=None, param_specs=None):
        super().__init__(shapes, group, param_specs=param_specs)
        from tpu_ddp_torch.ops.optim import Adafactor
        if isinstance(inner, Adafactor):
            raise NotImplementedError(
                "Adafactor under ZeRO needs the row-sharded FactoredZeRO1 "
                "(tpu_ddp/parallel/zero.py), not ported to tpu_ddp_torch "
                "yet (ROADMAP Queue 1 item 9.4, FactoredZeRO1); the "
                "per-cell CellAdafactor comes with item 10.6")
        self.inner = inner

    def decay_mask(self) -> list:
        """The decay policy on the ORIGINAL ranks (the slices are all
        rank 1)."""
        return [len(s) >= 2 for s in self.shapes]

    def init(self, device):
        _, views = self.shard_zeros(device)
        return self.inner.init(views)

    def apply(self, params, grads, state, skip=None, clip_norm=None):
        """One sharded step from UNSYNCED canonical ``grads`` (the
        reduce-scatter IS the sync); returns the updated canonical full
        leaves, identical on every rank."""
        _, g_sh = self.scatter_grads(grads)
        return self.apply_scattered(params, g_sh, state, skip=skip,
                                    clip_norm=clip_norm)

    def apply_scattered(self, params, g_sh, state, skip=None,
                        clip_norm=None):
        """The second half of :meth:`apply`, from mean slices already
        reduce-scattered (views of one buffer)."""
        if clip_norm is not None:
            from tpu_ddp_torch.ops.optim import clip_scale_from_sq
            scale = clip_scale_from_sq(self.sq_norm(g_sh), clip_norm)
            torch._foreach_mul_(g_sh, scale)
        p_buf, p_sh = self.local_shards(params)
        _inner_apply(self.inner, p_sh, g_sh, state, self.decay_mask(),
                     skip)
        return self.gather(p_buf)


class _Gather(torch.autograd.Function):
    """All-gather of the shard buffer into the canonical leaves; backward
    reduce-scatters their cotangents with SUM (the transpose of the
    gather). The leaves are the function's own outputs, so the backward
    builds the send buffer once: slicing them out of one gathered tensor
    under autograd would cost a full-size zero fill per leaf."""

    @staticmethod
    def forward(ctx, buf, layout):
        ctx.layout = layout
        return tuple(layout.leaves_of_rows(layout.all_gather_rows(buf)))

    @staticmethod
    def backward(ctx, *grads):
        lay = ctx.layout
        dev = next(g for g in grads if g is not None).device
        grads = [torch.zeros(s, device=dev) if g is None else g
                 for g, s in zip(grads, lay.shapes)]
        return lay.reduce_scatter_sum(lay.rows(grads)), None


class ZeRO3(_FlatLayout):
    """FSDP: parameters at rest are this rank's ``(total_chunk,)`` shard
    buffer (views per leaf); the inner optimizer updates the shards."""

    def __init__(self, inner, shapes, group=None, param_specs=None):
        super().__init__(shapes, group, param_specs=param_specs)
        from tpu_ddp_torch.ops.optim import Adafactor
        if isinstance(inner, Adafactor):
            raise NotImplementedError(
                "Adafactor's factored state cannot ride the flat FSDP "
                "layout; its sharded form (FactoredZeRO1) is not ported "
                "to tpu_ddp_torch yet (ROADMAP Queue 1 item 9.4, "
                "FactoredZeRO1)")
        self.inner = inner

    def decay_mask(self) -> list:
        return [len(s) >= 2 for s in self.shapes]

    def shard_host(self, leaves, device):
        """Canonical host leaves -> this rank's shard buffer on
        ``device``, ready to differentiate."""
        buf = torch.from_numpy(self.local_host(self.shard_params(leaves)))
        return buf.to(device).requires_grad_(True)

    def init(self, device):
        _, views = self.shard_zeros(device)
        return self.inner.init(views)

    def gather_params(self, buf, differentiable: bool = True) -> list:
        """The shard buffer -> canonical full leaves. Differentiable: the
        gradient w.r.t. ``buf`` is the group SUM of this rank's chunk."""
        if differentiable:
            return list(_Gather.apply(buf, self))
        return self.gather(buf.detach())

    def apply(self, shards, grads, state, skip=None):
        """The shard-local update (``grads``: the summed shard gradients
        already divided by N)."""
        return _inner_apply(self.inner, shards, grads, state,
                            self.decay_mask(), skip)
