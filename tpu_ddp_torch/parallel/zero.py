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

- :class:`FactoredZeRO1` (JAX ``FactoredZeRO1``): ZeRO-1 for Adafactor,
  whose factored moments the flat slices would destroy. It shards by
  ROWS of each leaf's factoring view ``(*lead, n, m)``: rank r owns rows
  ``[r * n_loc, (r + 1) * n_loc)`` (zero-padded to ``n_loc * N``), the
  reduce-scatter hands it the group mean of that row block, ``vr`` and
  ``mu`` shard with the rows, ``vc`` stays whole, and one ``all_reduce``
  of the column sums and ``vr`` sums and one of the update's squared
  sums carry the cross-row statistics; an all-gather reassembles the
  rows. Leaves too small to factor take ZeRO-1's flat chunks.

The model-parallel partition (``param_specs`` + ``mesh_axis_sizes``,
JAX ``_leaf_partition``): a leaf sharded over the tensor- or
expert-parallel axes (``mp``, ``ep``) is laid out PER CELL. ``shapes``
are then the canonical (global) shapes; the device side runs on this
process's cell of each leaf (:attr:`_FlatLayout.shapes` are the local
shapes) and dp-shards it within the cell, so the sharded update is the
same for replicated and partitioned leaves. The host converters keep the
JAX wrapper's global layout, ``P((mp..., dp))``: the cells of a leaf in
row-major order over its partition's axes, each flat and padded to
``chunk * N``. The global-norm clip sums a partitioned leaf's squares
over dp and over its partition's axes (``axis_groups``), a replicated
leaf's over dp alone. :class:`FactoredZeRO1` factors each cell's own
slice (the :class:`CellAdafactor` semantic) with its rows dp-sharded
within the cell; its reduced state keeps a leading axis per partition
axis. The pipeline axis (``pp``) partitions the stacked block leaves
like the others: each stage cell's rows, dp-sharded within the cell,
``P((pp[, mp/ep], dp))`` (parallel/pipeline.py). The JAX wrapper's
refusals hold: one mesh axis per sharded dim, no leaf sharded over dp
itself.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist


def _chunk(size: int, n: int) -> int:
    return -(-size // n)


class LeafPart:
    """The model-parallel partition of one leaf (JAX ``_LeafPart``):
    ``parts``, ``(mesh_axis, leaf_dim, extent)`` per sharded dim in dim
    order (major to minor), and the local (cell) geometry."""

    def __init__(self, parts: tuple, local_shape: tuple):
        self.parts = tuple(parts)
        self.local_shape = tuple(local_shape)
        self.local_size = math.prod(self.local_shape)
        self.counts = tuple(r for _, _, r in self.parts)
        self.count = math.prod(self.counts)

    @property
    def axes(self) -> tuple:
        """Mesh axis names, major to minor."""
        return tuple(a for a, _, _ in self.parts)

    def cell(self, index: dict) -> int:
        """The row-major cell number of mesh ``index`` (axis ->
        position)."""
        c = 0
        for a, _, r in self.parts:
            c = c * r + int(index.get(a, 0))
        return c


def leaf_partition(spec, shape, mesh_axis_sizes: dict, dp_axis: str = "dp"):
    """The :class:`LeafPart` of a leaf of canonical ``shape`` from its
    ``PartitionSpec``, or None when it is replicated (or every sharding
    axis has extent 1). JAX's refusals: a dim split over several axes,
    a leaf sharded over ``dp_axis`` itself; and the pipeline axis names
    its ROADMAP item."""
    parts = []
    shape = tuple(int(d) for d in shape)
    for d, entry in enumerate(tuple(spec) if spec is not None else ()):
        if entry is None:
            continue
        axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        if dp_axis in axes:
            raise NotImplementedError(
                f"ZeRO cannot wrap a leaf already sharded over its "
                f"own axis {dp_axis!r} (spec {spec})")
        if len(axes) > 1:
            raise NotImplementedError(
                f"ZeRO supports one mesh axis per sharded leaf dim "
                f"(got spec {spec})")
        ax = axes[0]
        r = int(mesh_axis_sizes[ax])
        if r == 1:
            continue
        if shape[d] % r:
            raise ValueError(f"leaf dim {d} of shape {shape} not "
                             f"divisible by {ax}={r}")
        parts.append((ax, d, r))
    if not parts:
        return None
    local = list(shape)
    for _, d, r in parts:
        local[d] //= r
    return LeafPart(tuple(parts), tuple(local))


def part_cells(arr, part: LeafPart) -> list:
    """One canonical host leaf cut into its cells, row-major over the
    partition's axes (JAX ``_part_cells``)."""
    cells = [np.asarray(arr)]
    for _, dim, count in part.parts:
        cells = [piece for c in cells
                 for piece in np.split(c, count, axis=dim)]
    return cells


def part_assemble(cells: list, part: LeafPart):
    """The inverse of :func:`part_cells`."""
    for _, dim, count in reversed(part.parts):
        cells = [np.concatenate(cells[i:i + count], axis=dim)
                 for i in range(0, len(cells), count)]
    return cells[0]


def partitions(shapes, param_specs, mesh_axis_sizes, dp_axis: str = "dp"):
    """Each leaf's :class:`LeafPart` (or None); all None without
    ``param_specs``."""
    if param_specs is None:
        return [None] * len(shapes)
    if mesh_axis_sizes is None:
        raise ValueError("param_specs needs mesh_axis_sizes")
    if len(param_specs) != len(shapes):
        raise ValueError(f"{len(param_specs)} specs for {len(shapes)} "
                         "leaves")
    return [leaf_partition(sp, sh, mesh_axis_sizes, dp_axis)
            for sp, sh in zip(param_specs, shapes)]


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
    conversions only, e.g. for another dp size). ``param_specs`` (one
    ``PartitionSpec`` per leaf) with ``mesh_axis_sizes`` lays the leaves
    out per model-parallel cell; ``axis_groups`` maps each partition axis
    to the process group of its peers, for the clip's sums."""

    def __init__(self, shapes, group=None, axis_size: int | None = None,
                 rank: int | None = None, param_specs=None,
                 mesh_axis_sizes: dict | None = None,
                 axis_groups: dict | None = None):
        self.global_shapes = [tuple(int(d) for d in s) for s in shapes]
        self.parts = partitions(self.global_shapes, param_specs,
                                mesh_axis_sizes)
        self.axis_groups = dict(axis_groups or {})
        shapes = [pt.local_shape if pt is not None else s
                  for s, pt in zip(self.global_shapes, self.parts)]
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
        # The decay policy when the leaves' own ranks are not it (a
        # pipeline's stacked leaves: the ranks of one layer's leaves).
        self.decay = None

    def decay_mask(self) -> list:
        """The decay policy on the ORIGINAL ranks (the slices are all
        rank 1), or :attr:`decay` where set."""
        if self.decay is not None:
            return list(self.decay)
        return [len(s) >= 2 for s in self.shapes]

    # ---- host side (numpy, canonical layout) ----------------------------

    def shard_params(self, leaves) -> list:
        """Canonical leaves -> each one flat and zero-padded to
        ``chunk * N`` (the global flat layout; rank r's shard is its r-th
        chunk); a partitioned leaf's cells one after the other, each so
        padded."""
        out = []
        for p, s, c, pt in zip(leaves, self.sizes, self.chunks,
                               self.parts):
            cells = [p] if pt is None else part_cells(p, pt)
            out.append(np.concatenate(
                [np.pad(np.asarray(x).reshape(-1),
                        (0, c * self.axis_size - s)) for x in cells]))
        return out

    def unshard_host(self, flats) -> list:
        """Global flat padded arrays -> canonical leaves (the inverse of
        :meth:`shard_params`)."""
        out = []
        for x, s, shape, pt in zip(flats, self.sizes, self.shapes,
                                   self.parts):
            rows = np.asarray(x).reshape(1 if pt is None else pt.count, -1)
            cells = [r[:s].reshape(shape) for r in rows]
            out.append(cells[0] if pt is None else part_assemble(cells, pt))
        return out

    def local_host(self, flats, rank: int | None = None,
                   index: dict | None = None) -> np.ndarray:
        """Rank ``rank``'s ``(total_chunk,)`` buffer of global flat
        arrays (default: this rank), in the cell of mesh ``index`` (axis
        -> position) for partitioned leaves."""
        r = self.rank if rank is None else rank
        out = []
        for x, c, pt in zip(flats, self.chunks, self.parts):
            x = np.asarray(x)
            if pt is not None:
                x = x.reshape(pt.count, -1)[pt.cell(index or {})]
            out.append(x[r * c:(r + 1) * c])
        return np.concatenate(out).astype(np.float32)

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

    def full_opt(self, state) -> dict:
        """An inner optimizer state over this rank's shards -> its full
        canonical leaves (a collective every rank enters). The device
        count is copied: a step advances it in place, so no two states
        may share it."""
        return {k: v.clone() if k == "count"
                else list(self.gather(torch.cat(v)))
                for k, v in state.items()}

    def local_opt(self, full) -> dict:
        """The inverse of :meth:`full_opt`: this rank's shards of full
        canonical state leaves (the count copied), no collective."""
        return {k: v.clone() if k == "count"
                else [t.clone() for t in self.local_shards(v)[1]]
                for k, v in full.items()}

    def sq_norm(self, slices):
        """The global f32 sum of squares of dp-scattered slices: each
        rank's squared sum, one scalar ``all_reduce`` over dp; the sum of
        the leaves of one partition also over its axes' groups (distinct
        cells hold distinct elements; replicated leaves, equal on every
        cell, count once)."""
        buckets: dict = {}
        for g, pt in zip(slices, self.parts):
            buckets.setdefault(pt.axes if pt is not None else (),
                               []).append(g.float().square().sum())
        sq = None
        for axes, sums in buckets.items():
            s = torch.stack(sums).sum()
            if self.group is not None:
                dist.all_reduce(s, op=dist.ReduceOp.SUM, group=self.group)
            for ax in axes:
                if self.axis_groups.get(ax) is not None:
                    dist.all_reduce(s, op=dist.ReduceOp.SUM,
                                    group=self.axis_groups[ax])
            sq = s if sq is None else sq + s
        return sq


def _refuse_factored(inner) -> None:
    """The flat layouts cannot host Adafactor (the JAX optimizer's
    ``map_param_like`` refusal)."""
    from tpu_ddp_torch.ops.optim import Adafactor
    if isinstance(inner, Adafactor):
        raise ValueError(
            "Adafactor's factored state is shape-coupled to its original "
            "leaves and cannot be re-laid-out by the flat ZeRO/FSDP "
            "wrappers; use tpu_ddp_torch.parallel.zero.FactoredZeRO1 "
            "(LMTrainer(opt_sharding='zero1')) which shards the factored "
            "state natively, or AdamW under FSDP")


def _inner_apply(inner, params, grads, state, decay_mask, skip):
    """The inner optimizer's in-place update, with the decay mask of the
    original leaves (AdamW; SGD decays every leaf) and the guard's flag
    (SGD)."""
    kw = {} if skip is None else {"skip": skip}
    return inner.apply(params, grads, state, decay_mask=decay_mask, **kw)


class ZeRO1(_FlatLayout):
    """An elementwise optimizer (SGD, AdamW) with its state sharded 1/N
    over ``group``. ``init`` builds the inner state over this rank's
    shard views; ``apply``/``apply_scattered`` take and return canonical
    full leaves."""

    def __init__(self, inner, shapes, group=None, param_specs=None,
                 mesh_axis_sizes=None, axis_groups=None):
        super().__init__(shapes, group, param_specs=param_specs,
                         mesh_axis_sizes=mesh_axis_sizes,
                         axis_groups=axis_groups)
        _refuse_factored(inner)
        self.inner = inner

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

    def __init__(self, inner, shapes, group=None, param_specs=None,
                 mesh_axis_sizes=None, axis_groups=None):
        super().__init__(shapes, group, param_specs=param_specs,
                         mesh_axis_sizes=mesh_axis_sizes,
                         axis_groups=axis_groups)
        _refuse_factored(inner)
        self.inner = inner

    def shard_host(self, leaves, device, index: dict | None = None):
        """Canonical host leaves -> this rank's shard buffer on
        ``device`` (in the cell of mesh ``index``), ready to
        differentiate."""
        buf = torch.from_numpy(self.local_host(self.shard_params(leaves),
                                               index=index))
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


class FactoredZeRO1(_FlatLayout):
    """Adafactor with its state sharded 1/N over ``group`` by rows of
    each leaf's factoring view (JAX ``FactoredZeRO1``, data-parallel
    form).

    Each leaf's block on a rank is, for a factored leaf, its row block
    ``(*lead, n_loc, m)`` (``n_loc = ceil(n / N)``, the last rank's tail
    zero rows), else the flat chunk of :class:`ZeRO1`. All of a rank's
    blocks sit side by side in one buffer (``offsets``, ``chunks``), so
    one reduce-scatter and one all-gather of :class:`_FlatLayout` move
    every leaf. The state a rank holds: ``vr`` ``(*lead, n_loc)``,
    ``vc`` ``(*lead, m)`` whole, ``v`` the flat chunk (unfactored
    leaves), ``mu`` the leaf's block (with ``b1``); a ``(1,)`` f32 zero
    where a leaf does not use the slot, as in the JAX layout. At a group
    of one every sum is the replicated Adafactor's, so the step is its
    bits. ``axis_size`` and ``rank`` override the group's (host-side
    conversions only). With ``param_specs`` each cell factors its own
    slice: the geometry is the cell's, and the global layout gives every
    slot of a partitioned leaf a leading axis per partition axis
    (``vr``: ``P((mp..., None..., dp))``), as the JAX wrapper's."""

    def __init__(self, inner, shapes, group=None, param_specs=None,
                 dtype=torch.float32, axis_size: int | None = None,
                 rank: int | None = None, mesh_axis_sizes=None):
        from tpu_ddp_torch.ops.optim import Adafactor
        if not isinstance(inner, Adafactor):
            raise ValueError("FactoredZeRO1 wraps factored optimizers "
                             "(Adafactor); use ZeRO1 for elementwise ones")
        super().__init__(shapes, group, axis_size=axis_size, rank=rank,
                         param_specs=param_specs,
                         mesh_axis_sizes=mesh_axis_sizes)
        self.inner = inner
        self.dtype = dtype
        n_ax = self.axis_size
        self.geoms = []
        for i, shape in enumerate(self.shapes):
            view = inner.factoring_view(shape)
            if view is None:
                self.geoms.append(None)
                continue
            lead, n, m = view
            n_loc = _chunk(n, n_ax)
            self.geoms.append((lead, n, m, n_loc))
            self.chunks[i] = math.prod(lead) * n_loc * m
        self.offsets = np.concatenate([[0], np.cumsum(self.chunks)]
                                      ).astype(int).tolist()
        self.total_chunk = self.offsets[-1]

    def _rows_here(self, n: int, n_loc: int) -> tuple:
        """``(lo, real)``: this rank's first row and how many of its
        ``n_loc`` rows are real (the rest are padding)."""
        lo = self.rank * n_loc
        return lo, max(0, min(n_loc, n - lo))

    def _chunk_here(self, t, i: int):
        """This rank's chunk of flat leaf ``i``: a view, or a copy with
        zeros past the leaf's end."""
        c, s = self.chunks[i], self.sizes[i]
        lo, hi = min(self.rank * c, s), min((self.rank + 1) * c, s)
        blk = t.detach().reshape(-1)[lo:hi]
        return (torch.nn.functional.pad(blk, (0, c - (hi - lo)))
                if hi - lo < c else blk)

    # ---- the block layout of leaves -----------------------------------

    def rows(self, leaves, dtype=torch.float32):
        """``(N, total_chunk)``: row r holds every leaf's r-th block (the
        reduce-scatter's send buffer)."""
        n_ax = self.axis_size
        parts = []
        for t, geom, s, c in zip(leaves, self.geoms, self.sizes,
                                 self.chunks):
            t = t.detach().to(dtype)
            if geom is None:
                flat = t.reshape(-1)
                if c * n_ax != s:
                    flat = torch.nn.functional.pad(flat, (0, c * n_ax - s))
                parts.append(flat.view(n_ax, c))
                continue
            lead, n, m, n_loc = geom
            x = t.reshape(lead + (n, m))
            if n_loc * n_ax != n:
                x = torch.nn.functional.pad(x, (0, 0, 0, n_loc * n_ax - n))
            x = x.reshape(lead + (n_ax, n_loc, m)).movedim(len(lead), 0)
            parts.append(x.reshape(n_ax, c))
        return torch.cat(parts, dim=1)

    def leaves_of_rows(self, rows) -> list:
        """``(N, total_chunk)`` -> the full leaves (padding dropped)."""
        n_ax = self.axis_size
        out = []
        for o, c, s, shape, geom in zip(self.offsets, self.chunks,
                                        self.sizes, self.shapes,
                                        self.geoms):
            x = rows[:, o:o + c]
            if geom is None:
                out.append(x.reshape(-1)[:s].view(shape))
                continue
            lead, n, m, n_loc = geom
            x = x.reshape((n_ax,) + lead + (n_loc, m)).movedim(0, len(lead))
            out.append(x.reshape(lead + (n_ax * n_loc, m))[..., :n, :]
                       .reshape(shape))
        return out

    def blocks(self, buf) -> list:
        """Per-leaf views of a ``(total_chunk,)`` buffer in their block
        shapes."""
        return [v if g is None else v.view(g[0] + (g[3], g[2]))
                for v, g in zip(self.views(buf), self.geoms)]

    def local_blocks(self, leaves) -> list:
        """This rank's block of each full leaf, no collective: a view of
        the leaf, or a copy with zero rows past the leaf's end."""
        out = []
        for i, (t, geom) in enumerate(zip(leaves, self.geoms)):
            t = t.detach().to(self.dtype)
            if geom is None:
                out.append(self._chunk_here(t, i))
                continue
            lead, n, m, n_loc = geom
            lo, real = self._rows_here(n, n_loc)
            blk = t.reshape(lead + (n, m))[..., lo:lo + real, :]
            out.append(torch.nn.functional.pad(blk, (0, 0, 0, n_loc - real))
                       if real < n_loc else blk)
        return out

    # ---- state ----------------------------------------------------------

    def init(self, device) -> dict:
        b1 = self.inner.b1 is not None
        state = {k: [] for k in ("vr", "vc", "v", "mu")}
        for geom, c in zip(self.geoms, self.chunks):
            one = torch.zeros((1,), dtype=torch.float32, device=device)
            if geom is None:
                shapes = {"vr": None, "vc": None, "v": (c,)}
            else:
                lead, n, m, n_loc = geom
                shapes = {"vr": lead + (n_loc,), "vc": lead + (m,),
                          "v": None}
            for k, shape in shapes.items():
                state[k].append(one.clone() if shape is None else
                                torch.zeros(shape, dtype=torch.float32,
                                            device=device))
            state["mu"].append(
                torch.zeros(c, dtype=self.dtype, device=device).view(
                    (c,) if geom is None else geom[0] + (geom[3], geom[2]))
                if b1 else one)
        state["count"] = torch.zeros((), dtype=torch.int32, device=device)
        return state

    def _gather_cat(self, tensors) -> list:
        """Every rank's copy of each tensor of ``tensors`` (same shapes on
        every rank): ``(N, numel)`` per tensor, one all-gather."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        if self.group is None:
            rows = flat.reshape(1, -1)
        else:
            rows = torch.empty(self.axis_size * flat.numel(),
                               dtype=flat.dtype, device=flat.device)
            dist.all_gather_into_tensor(rows, flat, group=self.group)
            rows = rows.view(self.axis_size, -1)
        out, o = [], 0
        for t in tensors:
            out.append(rows[:, o:o + t.numel()])
            o += t.numel()
        return out

    def full_opt(self, state) -> dict:
        """The state as the replicated Adafactor's full leaves (a
        collective every rank enters): the canonical form."""
        n_ax = self.axis_size
        idx_f = [i for i, g in enumerate(self.geoms) if g is not None]
        vr = list(state["vr"])
        for i, rows in zip(idx_f, self._gather_cat(
                [state["vr"][i] for i in idx_f]) if idx_f else []):
            lead, n, _, n_loc = self.geoms[i]
            vr[i] = rows.reshape((n_ax,) + lead + (n_loc,)).movedim(
                0, len(lead)).reshape(lead + (n_ax * n_loc,))[..., :n]
        idx_v = [i for i, g in enumerate(self.geoms) if g is None]
        v = list(state["v"])
        for i, rows in zip(idx_v, self._gather_cat(
                [state["v"][i] for i in idx_v]) if idx_v else []):
            v[i] = rows.reshape(-1)[:self.sizes[i]].view(self.shapes[i])
        mu = list(state["mu"])
        if self.inner.b1 is not None:
            mu = self.leaves_of_rows(self.all_gather_rows(torch.cat(
                [t.reshape(-1) for t in state["mu"]])))
        return {"vr": vr, "vc": list(state["vc"]), "v": v, "mu": mu,
                "count": state["count"].clone()}

    def local_opt(self, full) -> dict:
        """The inverse of :meth:`full_opt`: this rank's state from the
        full (canonical) leaves, no collective."""
        out = {k: [] for k in ("vr", "vc", "v", "mu")}
        for i, geom in enumerate(self.geoms):
            if geom is None:
                out["vr"].append(full["vr"][i].clone())
                out["vc"].append(full["vc"][i].clone())
                out["v"].append(self._chunk_here(full["v"][i].float(),
                                                 i).clone())
                continue
            lead, n, m, n_loc = geom
            lo, real = self._rows_here(n, n_loc)
            vr = full["vr"][i].reshape(lead + (n,))[..., lo:lo + real]
            out["vr"].append(torch.nn.functional.pad(
                vr.float(), (0, n_loc - real)) if n_loc > real
                else vr.float().clone())
            out["vc"].append(full["vc"][i].float().clone())
            out["v"].append(full["v"][i].float().clone())
        out["mu"] = [t.clone() for t in (
            self.local_blocks(full["mu"]) if self.inner.b1 is not None
            else full["mu"])]
        out["count"] = full["count"].clone()
        return out

    def state_specs(self) -> dict:
        """Each slot's per-leaf partition specs over the global layout,
        as the JAX wrapper gives them: ``vr`` and ``mu`` sharded along
        the view's rows, flat leaves' ``v`` and ``mu`` along their
        chunks, the rest replicated."""
        from tpu_ddp_torch.parallel.redistribute import P
        dp, b1 = "dp", self.inner.b1 is not None
        out = {k: [] for k in ("vr", "vc", "v", "mu")}
        for geom, pt in zip(self.geoms, self.parts):
            axes = pt.axes if pt is not None else ()
            if geom is None:
                out["vr"].append(P())
                out["vc"].append(P())
                out["v"].append(P(*axes, dp))
                out["mu"].append(P(*axes, dp) if b1 else P())
                continue
            lead = [None] * len(geom[0])
            out["vr"].append(P(*axes, *lead, dp))
            out["vc"].append(P(*axes))
            out["v"].append(P())
            out["mu"].append(P(*axes, *lead, dp, None) if b1 else P())
        return out

    # ---- host side (numpy; the JAX wrapper's global layout) -------------

    def _cells(self, i: int) -> tuple:
        """Leaf ``i``'s leading cell-axis extents (empty unpartitioned)."""
        pt = self.parts[i]
        return pt.counts if pt is not None else ()

    def canonical_opt_template(self) -> dict:
        """Each slot's canonical (checkpoint) leaf shapes: the replicated
        Adafactor's for an unpartitioned leaf, its cell's behind the
        leading cell axes for a partitioned one (JAX
        ``canonical_opt_template``)."""
        from tpu_ddp_torch.convert import opt_slot_shapes
        out = opt_slot_shapes(self.inner, self.shapes)
        for k, shapes in out.items():
            out[k] = [tuple(sh) if tuple(sh) == (1,)
                      else self._cells(i) + tuple(sh)
                      for i, sh in enumerate(shapes)]
        return out

    def canonicalize_opt_host(self, state) -> dict:
        """Global-layout host state (the JAX wrapper's: ``vr`` rows and
        ``mu`` rows padded to ``n_loc * N``, flat leaves padded to
        ``chunk * N``, behind the leading cell axes of a partitioned
        leaf) -> canonical shapes."""
        out = {k: [] for k in ("vr", "vc", "v", "mu")}
        for i, geom in enumerate(self.geoms):
            shape = self._cells(i) + self.shapes[i]
            s = self.sizes[i]
            vr, vc, v = (np.asarray(state[k][i]) for k in ("vr", "vc", "v"))
            mu = np.asarray(state["mu"][i])
            out["vc"].append(vc)
            if geom is None:
                out["vr"].append(vr)
                out["v"].append(v[..., :s].reshape(shape))
                if self.inner.b1 is not None:
                    mu = mu[..., :s].reshape(shape)
            else:
                n = geom[1]
                out["vr"].append(vr[..., :n])
                out["v"].append(v)
                if self.inner.b1 is not None:
                    mu = mu[..., :n, :].reshape(shape)
            out["mu"].append(mu)
        out["count"] = state["count"]
        return out

    def flatten_opt(self, state) -> dict:
        """Canonical host state -> the global layout (the inverse of
        :meth:`canonicalize_opt_host`)."""
        n_ax = self.axis_size
        out = {k: [] for k in ("vr", "vc", "v", "mu")}
        for i, geom in enumerate(self.geoms):
            c, s, cells = self.chunks[i], self.sizes[i], self._cells(i)
            lc = len(cells)
            vr, vc, v = (np.asarray(state[k][i]) for k in ("vr", "vc", "v"))
            mu = np.asarray(state["mu"][i])
            out["vc"].append(vc)
            if geom is None:
                out["vr"].append(vr)
                flat = [(0, 0)] * lc + [(0, c * n_ax - s)]
                out["v"].append(np.pad(v.reshape(cells + (-1,)), flat))
                if self.inner.b1 is not None:
                    mu = np.pad(mu.reshape(cells + (-1,)), flat)
            else:
                lead, n, m, n_loc = geom
                pad = n_loc * n_ax - n
                out["vr"].append(np.pad(vr, [(0, 0)] * (lc + len(lead))
                                        + [(0, pad)]))
                out["v"].append(v)
                if self.inner.b1 is not None:
                    mu = np.pad(mu.reshape(cells + lead + (n, m)),
                                [(0, 0)] * (lc + len(lead))
                                + [(0, pad), (0, 0)])
            out["mu"].append(mu)
        out["count"] = state["count"]
        return out

    # ---- the sharded update ---------------------------------------------

    @torch.no_grad()
    def apply(self, params, grads, state, skip=None, clip_norm=None):
        """One sharded Adafactor step from UNSYNCED ``grads`` (the
        reduce-scatter is the sync); returns the updated full leaves,
        identical on every rank. ``clip_norm`` is refused: Adafactor
        already clips by update RMS."""
        if clip_norm is not None:
            raise ValueError(
                "clip_norm with FactoredZeRO1 (Adafactor) is not "
                "supported - Adafactor already clips by update RMS "
                "(ops/optim.py); use AdamW/SGD or drop the clip")
        if skip is not None:
            raise ValueError("FactoredZeRO1 takes no step guard flag")
        from tpu_ddp_torch.ops.optim import ema_
        o, n_ax = self.inner, self.axis_size
        count = state["count"] + 1
        beta2t, rho, lr = o.schedule_terms(count)
        b2, omb2 = beta2t, 1.0 - beta2t
        decay = self.decay_mask()
        g_buf = self.reduce_scatter_sum(self.rows(grads))
        g_buf /= n_ax
        g_loc = self.blocks(g_buf)
        # The second moments, and the cross-row sums of the factored
        # leaves (column sums of g^2, the new vr's sum) in one buffer.
        us, stats = [None] * len(g_loc), []
        for i, (g, geom) in enumerate(zip(g_loc, self.geoms)):
            g2 = g.square().add_(o.eps1)
            if geom is None:
                v = state["v"][i]
                ema_(v, b2, omb2, g2)
                us[i] = g * torch.rsqrt(v)
                continue
            lead, n, m, n_loc = geom
            _, real = self._rows_here(n, n_loc)
            vr = state["vr"][i]
            ema_(vr, b2, omb2, g2.sum(dim=-1) / m)
            stats += [g2[..., :real, :].sum(dim=-2),
                      vr[..., :real].sum(dim=-1)]
        sums = self._sum_over_group(stats)
        k = 0
        for i, (g, geom) in enumerate(zip(g_loc, self.geoms)):
            if geom is None:
                continue
            n = geom[1]
            col, vr_sum = sums[k], sums[k + 1]
            k += 2
            vc, vr = state["vc"][i], state["vr"][i]
            ema_(vc, b2, omb2, col / n)
            r = vr / (vr_sum / n)[..., None]
            us[i] = (g * torch.rsqrt(r)[..., :, None]
                     * torch.rsqrt(vc)[..., None, :])
        # The update-RMS clip is one scalar per whole leaf.
        sq = self._sum_over_group([torch.stack(
            [u.square().sum() for u in us])])[0]
        p_loc = self.local_blocks(params)
        out = torch.empty(self.total_chunk, dtype=self.dtype,
                          device=g_buf.device)
        for i, (p, u, pl, dst) in enumerate(zip(params, us, p_loc,
                                               self.blocks(out))):
            u = o.clip_update(u, sq[i], self.sizes[i])
            alpha = o.step_size(p, rho, lr)
            torch.sub(pl, o.leaf_step(pl, u, state["mu"][i], decay[i],
                                      alpha), out=dst)
        state["count"].copy_(count)
        return self.gather(out)

    def _sum_over_group(self, tensors) -> list:
        """Each tensor summed over the group (one ``all_reduce`` of their
        concatenation); the identity without a group."""
        if not tensors:
            return []
        flat = torch.cat([t.reshape(-1) for t in tensors])
        if self.group is not None:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        out, o = [], 0
        for t in tensors:
            out.append(flat[o:o + t.numel()].view(t.shape))
            o += t.numel()
        return out


class CellAdafactor:
    """Adafactor over tensor- or expert-parallel leaves, PER CELL (JAX
    ``CellAdafactor``): each process's leaves are its cells, and the bare
    optimizer's update on them is the per-cell update (row and column
    moments of the cell's own slice, the update-RMS clip and relative
    step per cell), with no collective. This is not the dense run's
    factored state sliced: a cell's row means are means over its slice.

    The trainer runs the bare optimizer on the cells; this class holds
    the global layout of their state, the JAX wrapper's: reduced slots
    (``vr``, ``vc``) of a partitioned leaf gain a leading axis per
    partition axis (spec ``P(ax1, ...)``), slots shaped like the
    parameter keep its spec (the cells concatenate), ``(1,)``
    placeholders and replicated leaves keep the bare layout. ``shapes``
    are the canonical leaf shapes, one spec per leaf."""

    def __init__(self, inner, shapes, param_specs, mesh_axis_sizes: dict):
        from tpu_ddp_torch.ops.optim import Adafactor
        if not isinstance(inner, Adafactor):
            raise ValueError(
                "CellAdafactor wraps Adafactor (per-cell factored "
                "state); elementwise optimizers already shard state in "
                "their parameter's own spec")
        self.inner = inner
        self.specs = list(param_specs)
        # No dp axis here: every spec axis is a cell axis.
        self.parts = partitions(shapes, self.specs, mesh_axis_sizes,
                                dp_axis="")
        self.shapes = [pt.local_shape if pt is not None else tuple(s)
                       for s, pt in zip(shapes, self.parts)]

    def state_specs(self) -> dict:
        """Each slot's per-leaf specs (JAX ``CellAdafactor.state_specs``),
        ``count`` aside."""
        from tpu_ddp_torch.parallel.redistribute import P
        out = {k: [] for k in ("vr", "vc", "v", "mu")}
        for shape, pt, spec in zip(self.shapes, self.parts, self.specs):
            factored = self.inner.plan(shape) is not None
            vr = P(*pt.axes) if (factored and pt is not None) else P()
            out["vr"].append(vr)
            out["vc"].append(vr)
            out["v"].append(P() if factored else spec)
            out["mu"].append(spec if self.inner.b1 is not None else P())
        return out
