"""Pipeline parallelism (tpu_ddp/parallel/pipeline.py): the layer stack cut
into ``pp`` stages, each local batch split into microbatches that stream
through them under one of four schedules.

Layout. Block parameters are STACKED on a leading layer axis
(:func:`stack_block_params`: ``stacked[k][j] == blocks[j][k]``), the axis
sharded over ``pp`` (:func:`pipeline_param_specs`): stage ``s`` holds the
rows ``[s * L/pp, (s + 1) * L/pp)``; the embedding, ``ln_f`` and the head
stay whole on every stage. Interleaving (``pp_virtual`` V > 1) re-orders
the rows (:func:`interleave_permutation`) so that each stage holds its V
chunks back to back.

Stages and edges. A schedule reads a stage's inputs from edges and writes
its outputs to them. A stage is one process of a ``pp`` process group
(:class:`GroupHops`, the port of ``lax.ppermute``: activations go to stage
s + 1, cotangents to s - 1, each tick's sends and receives in one
``batch_isend_irecv``), or one of several stages run in this process over
:class:`InProcessEdge` deques (:class:`InProcessLinks`; the JAX package
runs every stage of a program on one process's devices). The schedule is
a tick table (:func:`tick_table`, written once on the host, JAX's tick
indices): which stage forwards or backwards which microbatch and chunk at
tick t. Both ends of every edge read the same table, so a hop is posted
only at a tick where the table moves something over it
(:func:`check_table` proves that every send meets its receive).

Schedules:

- ``gpipe``: all forwards, then all backwards; each stage forward keeps
  its autograd graph (residency O(M)).
- ``1f1b``: at tick t stage s forwards microbatch t - s (no graph; its
  input saved) and backwards t - 2(pp-1) + s, recomputing the stage from
  the saved input (residency O(pp)).
- ``interleaved``: 1F1B over V chunks per stage; work item k is chunk
  ``(k % (pp V)) // pp`` of microbatch ``(k // (pp V)) pp + k % pp``, the
  backward walking the chunks in reverse with lag ``pp V + pp - 2``.
- ``zerobubble``: 1F1B with the backward split into B-input (the
  cotangent of the stage input, on the 1F1B clock) and B-weight (the
  weight gradient, deferred to the uniform clock t - 2(pp-1)), each half
  on its own recompute.

Every layer runs as the dense trunk runs it
(``TransformerLM.layer_runner``: under the remat policy each layer is its
own checkpoint region); dropout keys fold (microbatch, DENSE layer) and the
embedding's (microbatch, ``num_layers``), the keys of ``LMTrainer`` at
``grad_accum`` = M, so masks do not depend on the pipeline's geometry. As
in JAX (tpu_ddp/parallel/pipeline.py:126) a MoE block's load-balance loss
is dropped. The loss of microbatch m is its token NLL sum times ``scale``
(the trainer's loss normalisation), differentiated on the last stage the
tick its forward completes (``gpipe``: the same, its cotangent kept for
the backward phase).
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch
import torch.distributed as dist

from tpu_ddp_torch.models.transformer import fold_in
from tpu_ddp_torch.ops.loss import softmax_cross_entropy
from tpu_ddp_torch.parallel.redistribute import P
from tpu_ddp_torch.utils.tree import tree_leaves

PIPE_AXIS = "pp"
SCHEDULES = ("gpipe", "1f1b", "interleaved", "zerobubble")


def map_tree(fn, *trees):
    """``fn`` over the leaves of dict trees of one structure."""
    if isinstance(trees[0], dict):
        return {k: map_tree(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _stack(xs):
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs)
    return np.stack([np.asarray(x) for x in xs])


def stack_block_params(params: dict) -> dict:
    """Per-layer blocks tuple -> one dict tree with a leading layer axis
    (torch or numpy leaves): ``stacked[k][j] == params["blocks"][j][k]``.
    The other entries stay as they are."""
    out = dict(params)
    out["blocks"] = map_tree(lambda *xs: _stack(list(xs)),
                             *params["blocks"])
    return out


def unstack_block_params(params: dict, num_layers: int) -> dict:
    """Inverse of :func:`stack_block_params` (views of the rows)."""
    out = dict(params)
    out["blocks"] = tuple(map_tree(lambda x: x[j], params["blocks"])
                          for j in range(num_layers))
    return out


def stacked_shapes(model, layers: int | None = None) -> dict:
    """:meth:`TransformerLM.param_shapes` of the stacked tree, the block
    leaves with a leading axis of ``layers`` rows (``num_layers``
    by default)."""
    shapes = model.param_shapes()
    n = model.num_layers if layers is None else layers
    out = dict(shapes)
    out["blocks"] = map_tree(lambda s: (n,) + tuple(s), shapes["blocks"][0])
    return out


def pipeline_param_specs(model) -> dict:
    """Specs of the STACKED tree: block leaves gain a leading ``pp`` axis
    on top of the model's own (tp, ep) layout; embed, ln_f and head stay
    replicated (their gradients are summed over pp by the trainer)."""
    base = model.param_specs()
    return {"embed": base["embed"], "ln_f": base["ln_f"],
            "head": base["head"],
            "blocks": map_tree(lambda s: P(PIPE_AXIS, *tuple(s)),
                               base["blocks"][0])}


def interleave_permutation(num_layers: int, pp_size: int,
                           pp_virtual: int) -> np.ndarray:
    """Dense -> interleaved row permutation of the STACKED block tree
    (JAX ``interleave_permutation``): stacked row
    ``p = s*(L/pp) + c*Lc + j`` holds dense layer ``(c*pp + s)*Lc + j``,
    ``Lc = L / (pp * pp_virtual)``. ``stacked_interleaved =
    dense_stacked[perm]``; ``pp_virtual == 1`` is the identity; invert
    with ``np.argsort``."""
    L, S, V = num_layers, pp_size, pp_virtual
    if V < 1:
        raise ValueError(f"pp_virtual must be >= 1, got {V}")
    if L % (S * V):
        raise ValueError(f"num_layers={L} not divisible by "
                         f"pp*pp_virtual={S * V}")
    Lc = L // (S * V)
    perm = np.empty(L, np.int64)
    p = 0
    for s in range(S):
        for c in range(V):
            for j in range(Lc):
                perm[p] = (c * S + s) * Lc + j
                p += 1
    return perm


def permute_stacked_blocks(params: dict, perm) -> dict:
    """The stacked block rows re-ordered by ``perm`` (torch or numpy
    leaves); every other entry untouched. ``np.argsort(perm)`` undoes it
    (checkpoints always hold the DENSE order)."""
    idx = np.asarray(perm)

    def take(x):
        if isinstance(x, torch.Tensor):
            return x[torch.as_tensor(idx, device=x.device)]
        return np.asarray(x)[idx]
    out = dict(params)
    out["blocks"] = map_tree(take, params["blocks"])
    return out


# ---------------------------------------------------------------------------
# Tick tables
# ---------------------------------------------------------------------------

# Work kinds: "F" forward without a graph (input saved), "Fg" forward
# keeping its graph (gpipe), "B" backward by recompute, "Bg" backward
# through the kept graph, "I" B-input and "W" B-weight (zerobubble).
_RECV_FWD = ("F", "Fg")
_RECV_BWD = ("B", "Bg", "I")


def tick_table(schedule: str, pp_size: int, num_micro: int,
               pp_virtual: int = 1) -> list:
    """The schedule as a list of ticks, each ``{stage: [(kind, m, c),
    ...]}`` in execution order (a stage absent from a tick idles).
    ``gpipe``'s backward ticks run its forward ticks in reverse."""
    S, M, V = pp_size, num_micro, pp_virtual
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; choose 'gpipe', "
                         "'1f1b', 'interleaved' or 'zerobubble'")
    if schedule == "gpipe":
        T = M + S - 1
        fwd = [{s: [("Fg", t - s, 0)] for s in range(S) if 0 <= t - s < M}
               for t in range(T)]
        bwd = [{s: [("Bg", t - s, 0)] for s in range(S) if 0 <= t - s < M}
               for t in reversed(range(T))]
        return fwd + bwd
    ticks = []
    if schedule == "interleaved":
        D, MV = S * V, M * V
        lag = D + S - 2

        def decomp(k):
            g, r = divmod(k, D)
            return g * S + r % S, r // S
        for t in range(MV + D + S - 2):
            tick = {}
            for s in range(S):
                items = []
                if 0 <= t - s < MV:
                    items.append(("F", *decomp(t - s)))
                if 0 <= t - lag + s < MV:
                    m, slot = decomp(t - lag + s)
                    items.append(("B", m, V - 1 - slot))
                if items:
                    tick[s] = items
            ticks.append(tick)
        return ticks
    for t in range(M + 2 * (S - 1)):
        tick = {}
        for s in range(S):
            items = []
            f, b, w = t - s, t - 2 * (S - 1) + s, t - 2 * (S - 1)
            if 0 <= f < M:
                items.append(("F", f, 0))
            if 0 <= b < M:
                items.append(("B" if schedule == "1f1b" else "I", b, 0))
            if schedule == "zerobubble" and 0 <= w < M:
                items.append(("W", w, 0))
            if items:
                tick[s] = items
        ticks.append(tick)
    return ticks


def item_hops(kind: str, s: int, c: int, pp_size: int,
              pp_virtual: int) -> tuple:
    """``(recv, send)`` of one work item at stage ``s``: each None or
    ``(edge kind, peer stage)``. Activations travel the ``"fwd"`` edges
    to stage s + 1 (stage pp-1 wraps to stage 0 between chunks), cotangents
    the ``"bwd"`` edges to s - 1; the first chunk on stage 0 reads the
    embedding and the last chunk on the last stage feeds the head."""
    S, V = pp_size, pp_virtual
    first, last = s == 0 and c == 0, s == S - 1 and c == V - 1
    if kind in _RECV_FWD:
        return (None if first else ("fwd", (s - 1) % S),
                None if last else ("fwd", (s + 1) % S))
    if kind in _RECV_BWD:
        return (None if last else ("bwd", (s + 1) % S),
                None if first else ("bwd", (s - 1) % S))
    return None, None


def check_table(table: list, pp_size: int, pp_virtual: int = 1) -> None:
    """Raise unless every send of tick t meets a receive of tick t + 1 at
    the other end of its edge, in microbatch order, and nothing else is
    received: the contract that keeps a hop from waiting for ever."""
    def moves(t, side):
        out = []
        for s, items in (table[t] if 0 <= t < len(table) else {}).items():
            for kind, m, c in items:
                hop = item_hops(kind, s, c, pp_size, pp_virtual)[side]
                if hop is not None:
                    edge, peer = hop
                    src, dst = (peer, s) if side == 0 else (s, peer)
                    out.append((edge, src, dst))
        return sorted(out)
    for t in range(-1, len(table)):
        if moves(t, 1) != moves(t + 1, 0):
            raise ValueError(f"tick table: sends at tick {t} "
                             f"{moves(t, 1)} != receives at tick {t + 1} "
                             f"{moves(t + 1, 0)}")


# ---------------------------------------------------------------------------
# Edges
# ---------------------------------------------------------------------------


class InProcessEdge:
    """A directed stage channel inside one process (JAX ``InProcessEdge``,
    tpu_ddp/parallel/mpmd.py:249-285): a deque of tensors on one device,
    first in first out."""

    def __init__(self):
        self._q: deque = deque()
        self.messages = 0

    def send(self, x) -> None:
        self._q.append(x)
        self.messages += 1

    def recv(self):
        return self._q.popleft()

    def __len__(self) -> int:
        return len(self._q)


class InProcessLinks:
    """Every edge of a ``pp_size``-stage ring run in this process: one
    :class:`InProcessEdge` per (direction, sending stage). A receiver pops
    when its work item runs; stages run in order within a tick, so the
    oldest message on an edge is always the one the table says.
    ``edge_factory`` makes each edge (a test or a planted fault swaps
    in its own)."""

    def __init__(self, pp_size: int, edge_factory=InProcessEdge):
        self.edges = {(kind, s): edge_factory() for kind in ("fwd", "bwd")
                      for s in range(pp_size)}

    def send(self, kind, src, dst, x) -> None:
        self.edges[(kind, src)].send(x)

    def recv(self, kind, src, dst):
        return self.edges[(kind, src)].recv()

    def end_tick(self, t) -> None:
        pass

    def drained(self) -> bool:
        return not any(len(e) for e in self.edges.values())


class GroupHops:
    """The pp hop of one stage process over the ``pp`` process group
    (``group`` rank i is stage i): at the end of tick t the stage posts
    the sends of its tick-t outputs and the receives its tick-(t+1) items
    read, all in one ``dist.batch_isend_irecv`` (fwd before bwd, tags 0
    and 1, so a pair of messages between two stages never crosses), and
    waits. ``shape``/``dtype``: every message's (one microbatch's
    activation or cotangent in the compute dtype)."""

    def __init__(self, group, stage: int, table: list, pp_size: int,
                 pp_virtual: int, shape, dtype, device):
        self.group, self.stage = group, stage
        self.ranks = [dist.get_global_rank(group, i) for i in range(pp_size)]
        self.shape, self.dtype, self.device = tuple(shape), dtype, device
        self.need = []
        for tick in table:
            hops = [item_hops(k, stage, c, pp_size, pp_virtual)[0]
                    for k, _, c in tick.get(stage, [])]
            self.need.append(sorted(h for h in hops if h is not None))
        self._sends: list = []
        self._inbox: dict = {}

    def send(self, kind, src, dst, x) -> None:
        self._sends.append((kind, dst, x.contiguous()))

    def recv(self, kind, src, dst):
        return self._inbox.pop((kind, src))

    def end_tick(self, t) -> None:
        tag = {"fwd": 0, "bwd": 1}
        ops = [dist.P2POp(dist.isend, x, self.ranks[dst], self.group,
                          tag[kind])
               for kind, dst, x in sorted(self._sends,
                                          key=lambda e: (e[1], tag[e[0]]))]
        for kind, src in (self.need[t + 1] if t + 1 < len(self.need)
                          else []):
            buf = torch.empty(self.shape, dtype=self.dtype,
                              device=self.device)
            self._inbox[(kind, src)] = buf
            ops.append(dist.P2POp(dist.irecv, buf, self.ranks[src],
                                  self.group, tag[kind]))
        self._sends = []
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    def drained(self) -> bool:
        return not self._inbox and not self._sends


# ---------------------------------------------------------------------------
# The schedule engine
# ---------------------------------------------------------------------------


def pipeline_grads(model, params: dict, inputs, targets, *, schedule: str,
                   pp_size: int, num_micro: int, stages, links,
                   pp_virtual: int = 1, row0: int = 0, perm=None, rng=None,
                   scale: float = 1.0, scatter_blocks=None):
    """One step's forward and backward of the stages ``stages`` that this
    process runs, under ``schedule``; returns ``(loss_sum, grads)``.

    ``params``: the stacked tree this process holds (block leaves with
    the rows ``[row0, row0 + len)`` of the stacked order); ``inputs``,
    ``targets``: (B, L) ids of this process's shard, split into
    ``num_micro`` microbatches of consecutive rows. ``links``: the edges
    (:class:`InProcessLinks` or :class:`GroupHops`). ``perm``: the dense
    layer of every stacked row (interleaving), identity when None.
    ``rng``: the step's dropout key. ``loss_sum``: the summed token NLL of
    the microbatches that this process's last stage finished (0
    elsewhere), a 0-d f32 tensor. ``grads``: f32 leaves shaped like
    ``params``, each the gradient of ``scale`` times the NLL sum; embed
    holds stage 0's share and ln_f/head the last stage's (zeros on a
    process without them). ``scatter_blocks``: a callable handed the block
    gradients of every tick that made some (ZeRO-2), after which they are
    zeroed."""
    S, M, V = pp_size, num_micro, pp_virtual
    B, L = inputs.shape
    model.check_seq_len(L)
    if B % M:
        raise ValueError(f"local batch {B} not divisible by "
                         f"num_micro={M}")
    cd = model.compute_dtype
    table = tick_table(schedule, S, M, V)
    blocks = params["blocks"]
    rows_held = tree_leaves(blocks)[0].shape[0]
    L_stage = model.num_layers // S
    Lc = L_stage // V
    pos = model._positions(L, inputs.device)
    run = model.layer_runner()
    micro_x, micro_y = inputs.chunk(M), targets.chunk(M)
    head_leaves = [params["ln_f"]["scale"], params["ln_f"]["bias"],
                   params["head"]]

    with torch.enable_grad():
        # One view per (row, leaf): the stage functions read them, and
        # autograd.grad w.r.t. them gives each layer's gradient alone.
        views = [map_tree(lambda x, r=r: x[r], blocks)
                 for r in range(rows_held)]
    view_leaves = [tree_leaves(v) for v in views]
    g_blocks = map_tree(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), blocks)
    g_rows = [tree_leaves(map_tree(lambda x, r=r: x[r], g_blocks))
              for r in range(rows_held)]
    g_embed = torch.zeros(params["embed"].shape, dtype=torch.float32,
                          device=inputs.device)
    g_head = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for p in head_leaves]
    loss_sum = torch.zeros((), dtype=torch.float32, device=inputs.device)

    def chunk_rows(s, c):
        """(local row, dense layer) of chunk c of stage s."""
        out = []
        for j in range(Lc):
            r = s * L_stage + c * Lc + j
            out.append((r - row0, int(perm[r]) if perm is not None else r))
        return out

    def key(m):
        return fold_in(rng, m) if rng is not None else None

    def run_chunk(s, c, x, m):
        km = key(m)
        for row, layer in chunk_rows(s, c):
            x, _ = run(views[row], x, pos,
                       fold_in(km, layer) if km is not None else None)
        return x

    def embed(m, grad: bool):
        with torch.set_grad_enabled(grad):
            return model.embed(params, micro_x[m], key(m))

    saved, graphs, stash, dy_head = {}, {}, {}, {}
    made_block_grads = False

    def head(m, y):
        nonlocal loss_sum
        with torch.enable_grad():
            yl = y.detach().requires_grad_(True)
            logits = model.train_head(params, yl)
            nll = softmax_cross_entropy(
                logits.reshape(-1, logits.shape[-1]),
                micro_y[m].reshape(-1)).sum()
            *gh, dy = torch.autograd.grad(nll * scale, head_leaves + [yl])
        torch._foreach_add_(g_head, [g.float() for g in gh])
        loss_sum = loss_sum + nll.detach()
        dy_head[m] = dy.to(cd)

    def forward(kind, s, m, c):
        recv, send = item_hops(kind, s, c, S, V)
        x = links.recv(recv[0], recv[1], s) if recv is not None else None
        if kind == "Fg":
            with torch.enable_grad():
                xin = (embed(m, True) if x is None
                       else x.detach().requires_grad_(True))
                y = run_chunk(s, c, xin, m)
            graphs[(s, m, c)] = (xin, y)
        else:
            with torch.no_grad():
                y = run_chunk(s, c, embed(m, False) if x is None else x, m)
            saved[(s, m, c)] = x
        if send is None:
            head(m, y)
        else:
            links.send(send[0], s, send[1], y.detach())

    def backward(kind, s, m, c):
        nonlocal made_block_grads
        recv, send = item_hops(kind, s, c, S, V)
        first = s == 0 and c == 0
        if kind == "W":
            x, dy = stash.pop((s, m))
        else:
            dy = (links.recv(recv[0], recv[1], s) if recv is not None
                  else dy_head.pop(m))
            x = None if kind == "Bg" else saved.pop((s, m, c))
        want_w, want_x = kind != "I", kind != "W"
        rows = [row for row, _ in chunk_rows(s, c)]
        with torch.enable_grad():
            if kind == "Bg":
                xin, y = graphs.pop((s, m, c))
            else:
                if first:
                    xin = embed(m, want_x)
                else:
                    xin = x.detach().requires_grad_(want_x)
                y = run_chunk(s, c, xin, m)
            wrt = [v for row in rows for v in view_leaves[row]] if want_w \
                else []
            if want_x:
                wrt.append(params["embed"] if first else xin)
            got = torch.autograd.grad(y, wrt, dy, allow_unused=True)
        if kind == "I":
            stash[(s, m)] = (x, dy)
        if want_w:
            n = len(view_leaves[0])
            for i, row in enumerate(rows):
                gs = got[i * n:(i + 1) * n]
                torch._foreach_add_(
                    [a for a, g in zip(g_rows[row], gs) if g is not None],
                    [g.float() for g in gs if g is not None])
            made_block_grads = True
        if want_x:
            dx = got[-1]
            if first:
                if dx is not None:
                    g_embed.add_(dx.float())
            else:
                links.send(send[0], s, send[1], dx.to(cd))

    local = set(stages)
    for t, tick in enumerate(table):
        for s in sorted(local & set(tick)):
            for kind, m, c in tick[s]:
                if kind in _RECV_FWD:
                    forward(kind, s, m, c)
                else:
                    backward(kind, s, m, c)
        links.end_tick(t)
        if scatter_blocks is not None and made_block_grads:
            scatter_blocks(g_blocks)
            for leaf in tree_leaves(g_blocks):
                leaf.zero_()
            made_block_grads = False
    if saved or graphs or stash or dy_head or not links.drained():
        raise RuntimeError("pipeline schedule ended with work in flight")
    grads = {"embed": g_embed,
             "ln_f": {"scale": g_head[0], "bias": g_head[1]},
             "head": g_head[2], "blocks": g_blocks}
    return loss_sum, {k: grads[k] for k in params}
