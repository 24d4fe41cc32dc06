"""MPMD pipeline (tpu_ddp/parallel/mpmd.py): one program per stage over
explicit point-to-point edges.

The SPMD pipeline (parallel/pipeline.py, ``PipelineLMTrainer``) runs one
schedule that every stage process reads whole, its hops collectives of a
pp process group. Here each stage is a program of its own that holds
only its stage's parameters, and stages talk only over edges that each
own a wire codec (parallel/compress.py:EdgeCodec): f32 inside a slice,
the compressed formats on the edges that cross slices, where the wire is
slow and the bytes matter (:class:`SliceTopology` says which edges do).

- :class:`StageProgram`: one stage's forward and backward. Stage 0
  embeds, the last stage ends with ``ln_f``, the head and the summed
  token NLL, every stage runs its contiguous rows of the stacked blocks
  (parallel/pipeline.py:stack_block_params) through
  ``TransformerLM.block_apply_aux`` directly, under no remat policy:
  the backward recomputes the stage from its saved input, which is the
  remat (a stage keeps O(pp) saved inputs, never activations). The last
  stage's forward and backward are one pass (its forward and backward
  microbatch coincide), its input's cotangent returned in f32; the
  other stages forward without a graph and, at their backward tick,
  recompute and take ``autograd.grad`` with the cotangent cast to the
  compute dtype. A MoE block's load-balance loss is dropped, as in JAX.
- :class:`InProcessEdge` and :class:`SocketEdge`: directed stage
  channels. In one process a deque of encoded wires, decoded on receipt
  and moved to the receiver's ``device`` (``jax.device_put``'s place);
  across processes (examples/mpmd_train.py) a 4-byte big-endian length
  and a pickled dict of numpy arrays over TCP: a CUDA payload goes to
  the host to be sent, and that copy is the only synchronisation. Not
  to be confused with parallel/pipeline.py's codec-less
  ``InProcessEdge``, which moves the SPMD schedules' compute-dtype
  tensors as they are.
- :class:`MPMDPipeline`: the host-driven 1F1B loop. :meth:`run_stage`
  is one stage's tick loop against whatever edges it is handed (one
  process per stage over socket edges); :meth:`step_grads` interleaves
  every stage in this process over in-process edges (the test path and
  the card's single-process check). A ``StageScheduler``
  (train/pipeline.py) classifies each stage's ticks and bounds its
  in-flight window. The guard's skip is host-side: a non-finite loss
  leaves parameters and optimizer state as they were.

Numerics: with f32 (``none``) edges a step computes the dense model's
loss and gradients; at bf16 compute the ``bf16`` wire is lossless (every
payload holds bf16 values), so its gradients are the f32 edges' bits.
Dropout is not supported on this path (the SPMD schedules carry it): a
model with ``dropout_rate > 0`` is refused, as is ``pp_size < 2``.

Not ported here: ``spmd_pipeline_hlo`` and ``mega_edge_hlo``
(tpu_ddp/parallel/mpmd.py:585, :617), the HLO overlap controls, which
read compiled HLO and belong with the analysis port (ROADMAP item 12).
"""

from __future__ import annotations

import dataclasses
import math
import pickle
import socket
import struct
from collections import deque
from typing import Callable

import numpy as np
import torch

from tpu_ddp_torch.ops.loss import softmax_cross_entropy
from tpu_ddp_torch.parallel.compress import EdgeCodec
from tpu_ddp_torch.parallel.pipeline import map_tree
from tpu_ddp_torch.utils.device import resolve_device
from tpu_ddp_torch.utils.tree import tree_leaves, tree_unflatten

__all__ = ["SliceTopology", "StageProgram", "InProcessEdge", "SocketEdge",
           "MPMDPipeline", "build_edges", "split_stage_params",
           "merge_stage_grads"]


# ---------------------------------------------------------------------------
# Topology: which stages live on which slice.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SliceTopology:
    """Stage -> slice assignment: ``stage_slice[s]`` is the slice of stage
    ``s``. The edge ``s -> s+1`` crosses slices iff the two ids differ;
    those edges get the compressed wire, the others stay f32."""

    stage_slice: tuple

    def __post_init__(self):
        if not self.stage_slice:
            raise ValueError("empty topology")
        ids = list(self.stage_slice)
        if ids != sorted(ids):
            raise ValueError(
                f"stages must map to slices in order, got {ids}")

    @classmethod
    def single_slice(cls, pp_size: int) -> "SliceTopology":
        return cls(tuple(0 for _ in range(pp_size)))

    @classmethod
    def even(cls, pp_size: int, num_slices: int) -> "SliceTopology":
        """Contiguous stages split evenly over ``num_slices``."""
        if pp_size % num_slices:
            raise ValueError(f"pp={pp_size} not divisible by "
                             f"num_slices={num_slices}")
        per = pp_size // num_slices
        return cls(tuple(s // per for s in range(pp_size)))

    @property
    def pp_size(self) -> int:
        return len(self.stage_slice)

    def is_cross(self, boundary: int) -> bool:
        """True when edge ``boundary -> boundary+1`` crosses slices."""
        return (self.stage_slice[boundary]
                != self.stage_slice[boundary + 1])

    def cross_boundaries(self) -> list:
        return [b for b in range(self.pp_size - 1) if self.is_cross(b)]


# ---------------------------------------------------------------------------
# Per-stage parameter partition (linear stage layout).
# ---------------------------------------------------------------------------


def split_stage_params(params: dict, pp_size: int) -> list:
    """Stacked parameter tree -> one dict per stage: stage s holds the
    block rows ``[s*Lps, (s+1)*Lps)`` (views), stage 0 also ``embed``, the
    last stage ``ln_f`` and ``head``."""
    L = tree_leaves(params["blocks"])[0].shape[0]
    if L % pp_size:
        raise ValueError(f"{L} layers not divisible by pp={pp_size}")
    lps = L // pp_size
    out = []
    for s in range(pp_size):
        p = {"blocks": map_tree(lambda x: x[s * lps:(s + 1) * lps],
                                params["blocks"])}
        if s == 0:
            p["embed"] = params["embed"]
        if s == pp_size - 1:
            p["ln_f"] = params["ln_f"]
            p["head"] = params["head"]
        out.append(p)
    return out


def merge_stage_grads(stage_grads: list) -> dict:
    """Inverse of :func:`split_stage_params` for gradient trees (torch or
    numpy leaves)."""
    def cat(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.cat(xs)
        return np.concatenate(xs)
    return {"embed": stage_grads[0]["embed"],
            "ln_f": stage_grads[-1]["ln_f"],
            "head": stage_grads[-1]["head"],
            "blocks": map_tree(cat, *[g["blocks"] for g in stage_grads])}


# ---------------------------------------------------------------------------
# One stage's programs.
# ---------------------------------------------------------------------------


class StageProgram:
    """Forward and backward of ONE pipeline stage over its own parameter
    dict (:func:`split_stage_params`). ``fwd(p, x)`` (not on the last
    stage): the stage output without a graph, ``x`` token ids on stage 0,
    the received f32 activation elsewhere. ``bwd(p, x, z)``: the first
    stage's gradients (``z`` the cotangent); a middle stage's
    ``(gradients, dx)``; the last stage's ``(loss, gradients, dx)`` with
    ``z`` the targets and ``loss`` the summed token NLL. Gradients are a
    tree shaped like ``p``; ``dx`` is f32."""

    def __init__(self, model, stage: int, pp_size: int, seq_len: int):
        if pp_size < 2:
            raise ValueError("MPMD needs pp_size >= 2 (one stage is "
                             "just the dense model)")
        if model.dropout_rate > 0.0:
            raise ValueError("MPMD path does not support dropout; "
                             "use the SPMD schedules for regularized "
                             "training")
        model.check_seq_len(seq_len)
        self.model = model
        self.stage = stage
        self.pp_size = pp_size
        self.is_first = stage == 0
        self.is_last = stage == pp_size - 1

    @staticmethod
    def _rows(blocks) -> list:
        """One dict of views per stacked row (layer) of ``blocks``."""
        n = tree_leaves(blocks)[0].shape[0]
        return [map_tree(lambda t, j=j: t[j], blocks) for j in range(n)]

    def _run(self, rows, x):
        pos = self.model._positions(x.shape[1], x.device)
        for blk in rows:
            x, _ = self.model.block_apply_aux(blk, x, pos)
        return x

    def _entry(self, p, x):
        """The stage's first activation in the compute dtype."""
        if self.is_first:
            return self.model.embed(p, x)
        return x.to(self.model.compute_dtype)

    @torch.no_grad()
    def fwd(self, p, x):
        if self.is_last:
            raise ValueError("the last stage's forward is fused into its "
                             "bwd")
        return self._run(self._rows(p["blocks"]), self._entry(p, x))

    def bwd(self, p, x, z):
        cd = self.model.compute_dtype
        with torch.enable_grad():
            q = map_tree(lambda t: t.detach().requires_grad_(True), p)
            # Gradients w.r.t. each row's views: each layer's alone, with
            # no scatter back through the stacked leaves.
            rows = self._rows(q["blocks"])
            rest = {k: v for k, v in q.items() if k != "blocks"}
            wrt = [v for r in rows for v in tree_leaves(r)]
            n_rows = len(wrt)
            wrt += tree_leaves(rest)
            xin = None if self.is_first else x.detach().requires_grad_(True)
            h = self.model.embed(q, x) if self.is_first else xin.to(cd)
            y = self._run(rows, h)
            if self.is_last:
                logits = self.model.train_head(q, y)
                out = softmax_cross_entropy(
                    logits.reshape(-1, logits.shape[-1]),
                    z.reshape(-1)).sum()
                cot = None
            else:
                out, cot = y, z.to(cd)
            got = torch.autograd.grad(
                out, wrt + ([] if xin is None else [xin]), cot)
        # got: row 0's leaves, row 1's, ..., then the rest, then dx.
        n = len(tree_leaves(rows[0]))
        blocks = [torch.stack(got[i:n_rows:n]) for i in range(n)]
        g = {"blocks": tree_unflatten(q["blocks"], blocks),
             **tree_unflatten(rest, list(got[n_rows:len(wrt)]))}
        g = {k: g[k] for k in q}
        if self.is_first:
            return g
        dx = got[-1].to(torch.float32)
        if self.is_last:
            return out.detach(), g, dx
        return g, dx


# ---------------------------------------------------------------------------
# Edges.
# ---------------------------------------------------------------------------


class InProcessEdge:
    """Directed stage channel inside one process, with a wire codec: a
    deque of encoded wires, decoded on receipt and moved to ``device``
    (where the sender's tensors were when None). The payload
    round-trips the codec, so the compression numerics and byte counts
    are the socket path's. (parallel/pipeline.py's ``InProcessEdge`` is
    the SPMD schedules' codec-less deque.)"""

    def __init__(self, codec: EdgeCodec | None = None, device=None):
        self.codec = codec or EdgeCodec("none")
        self.device = device
        self._q: deque = deque()
        self.messages = 0

    def send(self, x) -> None:
        wire, _ = self.codec.encode(x)
        self._q.append(wire)
        self.messages += 1

    def recv(self):
        return EdgeCodec.decode(self._q.popleft(), self.device)

    def __len__(self) -> int:
        return len(self._q)

    def stats(self) -> dict:
        return {"transport": type(self).__name__,
                "spec": self.codec.spec,
                "messages": self.messages,
                "wire_bytes": int(self.codec.bytes_sent),
                "dense_bytes": int(self.codec.bytes_dense),
                "ratio": round(self.codec.ratio, 3)}


class SocketEdge(InProcessEdge):
    """Stage channel over a connected TCP socket: a 4-byte big-endian
    length, then the pickled wire with every tensor as a numpy array (a
    CUDA payload copied to the host; that copy is the send's only
    synchronisation). A received wire is decoded on ``device``. The
    blocking receive is the schedule's synchronisation: a stage waits
    for exactly the message the 1F1B order sends it next. One socket may
    carry both directions, each end encoding with its own codec."""

    def __init__(self, sock: socket.socket,
                 codec: EdgeCodec | None = None, device=None):
        super().__init__(codec, device)
        self.sock = sock

    def send(self, x) -> None:
        wire, _ = self.codec.encode(x)
        host = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
                for k, v in wire.items()}
        blob = pickle.dumps(host, protocol=pickle.HIGHEST_PROTOCOL)
        self.sock.sendall(struct.pack(">I", len(blob)) + blob)
        self.messages += 1

    def _read_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("edge peer closed")
            buf += chunk
        return bytes(buf)

    def recv(self):
        (n,) = struct.unpack(">I", self._read_exact(4))
        # The peer is this program's other stage process.
        wire = pickle.loads(self._read_exact(n))
        return EdgeCodec.decode(wire, self.device)


def build_edges(topology: SliceTopology, compress: str = "bf16",
                block_size: int = 256, devices=None) -> tuple:
    """(down, up) in-process edge lists: ``down[b]`` carries activations
    over boundary ``b`` (stage b -> b+1), ``up[b]`` cotangents back.
    Cross-slice boundaries take the ``compress`` wire, each direction
    with its own codec (error feedback is per-edge sender state);
    intra-slice boundaries stay f32. ``devices``: each stage's device
    (the receiver's is where an edge delivers)."""
    down, up = [], []
    for b in range(topology.pp_size - 1):
        spec = compress if topology.is_cross(b) else "none"
        dev_fwd = devices[b + 1] if devices is not None else None
        dev_bwd = devices[b] if devices is not None else None
        down.append(InProcessEdge(EdgeCodec(spec, block_size, seed=2 * b),
                                  device=dev_fwd))
        up.append(InProcessEdge(EdgeCodec(spec, block_size,
                                          seed=2 * b + 1),
                                device=dev_bwd))
    return down, up


# ---------------------------------------------------------------------------
# The host-driven 1F1B engine.
# ---------------------------------------------------------------------------


def _ids(tokens, device) -> torch.Tensor:
    """Token ids (numpy or tensor) as int64 on ``device``."""
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.as_tensor(np.asarray(tokens, np.int64))
    return tokens.to(device=device, dtype=torch.int64)


def _handle(grads):
    """The scheduler's handle for a tick that made ``grads``: an event
    behind the tick's work on the card, the (ready) tensor on the CPU."""
    leaf = tree_leaves(grads)[0]
    if leaf.device.type != "cuda":
        return leaf
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(leaf.device))
    return ev


class MPMDPipeline:
    """Every stage of an MPMD pipeline driven by one host loop, on
    ``device`` (``None`` means ``"cuda"``).

    The single-process form (:meth:`step_grads`, every
    :class:`StageProgram` here over in-process edges) is the test path
    and the template of the per-process form: :meth:`run_stage` runs ONE
    stage's tick loop against whatever edges it is handed, so a
    multi-process launch runs it once per process over socket edges
    (examples/mpmd_train.py). ``optimizer``: the port's (lists of
    leaves, updated in place); SGD(0.1) by default."""

    def __init__(self, model, pp_size: int, seq_len: int, *,
                 num_micro: int | None = None,
                 topology: SliceTopology | None = None,
                 compress: str = "bf16", block_size: int = 256,
                 optimizer=None, scheduler=None, device=None):
        from tpu_ddp_torch.ops.optim import SGD
        self.model = model
        self.pp_size = pp_size
        self.num_micro = num_micro if num_micro is not None else pp_size
        self.seq_len = seq_len
        self.device = resolve_device(device)
        self.topology = topology or SliceTopology.single_slice(pp_size)
        if self.topology.pp_size != pp_size:
            raise ValueError(
                f"topology covers {self.topology.pp_size} stages, "
                f"pipeline has {pp_size}")
        self.programs = [StageProgram(model, s, pp_size, seq_len)
                         for s in range(pp_size)]
        self.down, self.up = build_edges(self.topology, compress,
                                         block_size,
                                         devices=[self.device] * pp_size)
        self.optimizer = optimizer or SGD(learning_rate=0.1)
        self.scheduler = scheduler
        self.skipped_steps = 0
        # Test seam for the chaos drills: maps the harvested loss to what
        # the guard sees (a NaN without breaking the math).
        self._chaos_hook: Callable[[float, int], float] | None = None
        self._step = 0

    # ---- schedule ------------------------------------------------------

    def ticks(self) -> int:
        return self.num_micro + 2 * (self.pp_size - 1)

    def run_stage(self, stage: int, params_s, micro_in, micro_tgt,
                  down_in, down_out, up_in, up_out) -> tuple:
        """One stage's whole 1F1B tick loop; returns ``(grads_s,
        loss_sum)``: the stage's f32 gradient sums over the microbatches
        and the summed token NLL (a 0-d f32 tensor, 0 except on the last
        stage). ``micro_in``/``micro_tgt``: the (M, mb, L) token and target
        ids (first and last stage only); the edge ends are this stage's
        channels (None at the pipeline's ends).

        At tick t stage s forwards microbatch ``f = t - s`` and backwards
        ``b = t - 2(pp-1) + s``, the SPMD 1F1B's clocks, except that the
        last stage runs its fused pass at f (there f and b coincide)."""
        S, M = self.pp_size, self.num_micro
        prog = self.programs[stage]
        dev = tree_leaves(params_s)[0].device
        if micro_in is not None:
            micro_in = _ids(micro_in, dev)
        if micro_tgt is not None:
            micro_tgt = _ids(micro_tgt, dev)
        saved: deque = deque()
        grads = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        sched = self.scheduler
        for t in range(self.ticks()):
            f = t - stage
            b = t - 2 * (S - 1) + stage
            f_valid = 0 <= f < M
            b_valid = 0 <= b < M
            did = False
            if prog.is_last:
                if f_valid:
                    x = down_in.recv()
                    loss, gp, dx = prog.bwd(params_s, x, micro_tgt[f])
                    loss_sum = loss_sum + loss
                    grads = _tree_add(grads, gp)
                    up_out.send(dx)
                    did = True
            else:
                if f_valid:
                    x = micro_in[f] if prog.is_first else down_in.recv()
                    saved.append(x)
                    down_out.send(prog.fwd(params_s, x))
                    did = True
                if b_valid:
                    dy = up_in.recv()
                    x = saved.popleft()
                    if prog.is_first:
                        gp = prog.bwd(params_s, x, dy)
                    else:
                        gp, dx = prog.bwd(params_s, x, dy)
                        up_out.send(dx)
                    grads = _tree_add(grads, gp)
                    did = True
            if sched is not None:
                sched.tick(stage, fwd=f_valid, bwd=b_valid,
                           handle=(_handle(grads) if did and grads is not None
                                   else None))
        return grads, loss_sum

    # ---- single-process step -------------------------------------------

    def step_grads(self, params: dict, inputs, targets) -> tuple:
        """One step's ``(mean loss, gradients)`` for a (B, L) batch: every
        stage interleaved in this process (each tick touches every stage
        once, in order; edges are FIFO, so the dataflow is that of S
        concurrent per-process loops). The gradients are f32, in the
        dense trainer's normalisation (divided by B * L) and shaped like
        ``params`` (the stacked tree); the loss a 0-d f32 tensor."""
        inputs = _ids(inputs, self.device)
        targets = _ids(targets, self.device)
        B, L = inputs.shape
        S, M = self.pp_size, self.num_micro
        if B % M:
            raise ValueError(f"batch {B} not divisible by num_micro={M}")
        micro = inputs.reshape(M, B // M, L)
        tmicro = targets.reshape(M, B // M, L)
        stage_params = split_stage_params(params, S)
        saved = [deque() for _ in range(S)]
        grads: list = [None] * S
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        sched = self.scheduler
        for t in range(self.ticks()):
            for s in range(S):
                prog = self.programs[s]
                f = t - s
                b = t - 2 * (S - 1) + s
                f_valid = 0 <= f < M
                b_valid = 0 <= b < M
                if prog.is_last:
                    if f_valid:
                        x = self.down[s - 1].recv()
                        loss, gp, dx = prog.bwd(stage_params[s], x,
                                                tmicro[f])
                        loss_sum = loss_sum + loss
                        grads[s] = _tree_add(grads[s], gp)
                        self.up[s - 1].send(dx)
                else:
                    if f_valid:
                        x = self.down[s - 1].recv() if s else micro[f]
                        saved[s].append(x)
                        self.down[s].send(prog.fwd(stage_params[s], x))
                    if b_valid:
                        dy = self.up[s].recv()
                        x = saved[s].popleft()
                        if prog.is_first:
                            gp = prog.bwd(stage_params[s], x, dy)
                        else:
                            gp, dx = prog.bwd(stage_params[s], x, dy)
                            self.up[s - 1].send(dx)
                        grads[s] = _tree_add(grads[s], gp)
                if sched is not None:
                    sched.tick(s, fwd=f_valid, bwd=b_valid)
        if any(saved) or any(len(e) for e in self.down + self.up):
            raise RuntimeError("MPMD schedule ended with work in flight")
        denom = float(B * L)
        merged = merge_stage_grads(grads)
        torch._foreach_div_(tree_leaves(merged), denom)
        return loss_sum / denom, {k: merged[k] for k in params}

    # ---- training ------------------------------------------------------

    def init_state(self, params: dict):
        return self.optimizer.init(tree_leaves(params))

    def train_step(self, params: dict, opt_state, inputs, targets,
                   guard=None) -> tuple:
        """``(params, opt_state, loss, skipped)``, the update in place.
        The guard's skip is host-side: a non-finite harvested loss leaves
        the parameters and optimizer state untouched, and ``guard``
        (resilience/guard.py:StepGuard) accounts the streak."""
        loss, grads = self.step_grads(params, inputs, targets)
        loss_f = float(loss)
        if self._chaos_hook is not None:
            loss_f = float(self._chaos_hook(loss_f, self._step))
        skipped = not math.isfinite(loss_f)
        if not skipped:
            leaves = tree_leaves(params)
            opt_state = self.optimizer.apply(
                leaves, tree_leaves(grads), opt_state,
                decay_mask=self.optimizer.decay_mask(leaves))
        else:
            self.skipped_steps += 1
        if guard is not None:
            guard.record(self._step, skipped, loss_f)
        if self.scheduler is not None:
            self.scheduler.step_done(self._step)
        self._step += 1
        return params, opt_state, loss_f, skipped

    def edge_stats(self) -> dict:
        return {
            "down": [e.stats() for e in self.down],
            "up": [e.stats() for e in self.up],
            "cross_boundaries": self.topology.cross_boundaries(),
            "skipped_steps": self.skipped_steps,
        }


def _tree_add(acc, g):
    """``acc + g`` in f32, in place into ``acc`` (which takes ownership of
    ``g``'s f32 leaves the first time)."""
    if acc is None:
        return map_tree(lambda x: x.to(torch.float32), g)
    torch._foreach_add_(tree_leaves(acc),
                        [x.to(torch.float32) for x in tree_leaves(g)])
    return acc
