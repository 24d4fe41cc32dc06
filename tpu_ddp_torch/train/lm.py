"""Language-model training engine (tpu_ddp/train/lm.py ``LMTrainer``), data
parallel over a ``torch.distributed`` process group of one card each.

One step: the token-mean ``softmax_cross_entropy`` of the f32 logits of
the local batch (or, with ``vocab_chunk``, the chunked-vocab loss of
ops/loss.py, which never holds the (T, V) logits), its gradients (summed
in f32 over ``grad_accum`` equal microbatches and scaled by 1/A, so a
dense model sees exactly the full-batch gradient), one mean of every
gradient over the group when it has more than one process (the dp
``pmean`` of ``_sync_grads``), the global-norm clip when
``clip_grad_norm`` is set, then the optimizer (AdamW, Adafactor or SGD,
a static or scheduled lr), in place. ``train_step`` returns the local
mean loss, as each JAX shard does. Next-token shift happens on the host
(``make_lm_batch``). Checkpoints use the JAX package's format and tree
(``save_checkpoint``, ``restore_checkpoint``), so they move between the
packages. Like the JAX LM trainer it has no step guard.

Dropout (``model.dropout_rate > 0``) draws each step's masks from keys
derived from ``dropout_seed``, the step, the process's data-shard index
(its (dp, sp, ep) coordinate: the rank at tp 1) and, under accumulation,
the microbatch (models/transformer.py:fold_in), so a resumed run
continues the same key sequence, data shards draw different masks and
the tp peers of one shard, whose residual stream is replicated, draw the
same (JAX folds only the data axes, tpu_ddp/train/lm.py:605-613). The
step is read from a device tensor (the optimizer's count, or the state's
``step_t`` for an optimizer without one), so a captured step draws the
masks of the step it replays.

Mixture of experts (tpu_ddp/train/lm.py:404-448,571-590,676-692): the
loss adds ``moe_aux_coef`` times the model's load-balance loss, and
``ep > 1`` runs expert parallelism over a world of dp x ep processes,
rank ``d * ep + e`` (the JAX ``make_mesh`` order, ep fastest), each with
its E / ep experts and its own rows of the batch (the JAX batch spec
``P(("dp", "ep"))``). The expert leaves' gradients are summed over the
dp group and divided by the world (their ep peers' tokens reached them
through the MoE layer's all_to_all); every other leaf is averaged over
the world. The global-norm clip sums the expert leaves' squares over the
ep group, so every process clips by the one norm of the whole model.
Parameters, optimizer state and checkpoints gather the expert
leaves over ep into the JAX layout (Adafactor's reduced slots of an
expert leaf stacked on a leading ep axis, as the JAX ``CellAdafactor``
lays them out). ZeRO and FSDP over the ep partition lay each expert
leaf out per cell and dp-shard it within the cell (parallel/zero.py).

Sharded layouts (tpu_ddp/train/lm.py:406-500), AdamW or SGD:
``opt_sharding='zero1'`` keeps the optimizer state as 1/dp flat shards
(parallel/zero.py ``ZeRO1``: the reduce-scatter of the accumulated
gradients is the sync, the update runs on the slices with the decay mask
of the original leaves, an all-gather brings the parameters back);
``'zero2'`` also reduce-scatters each microbatch's gradients at once and
accumulates the f32 slices; ``param_sharding='fsdp'`` keeps the
parameters themselves as the rank's flat shard buffer (``ZeRO3``), which
each microbatch's forward all-gathers inside an autograd function whose
backward reduce-scatters the gradients. Checkpoints of every layout hold
canonical shapes and restore into any other, at any dp. Adafactor under
``opt_sharding='zero1'`` runs the row-sharded ``FactoredZeRO1``
(tpu_ddp/train/lm.py:463-512): its factored moments cannot ride the flat
slices, so it refuses ``'zero2'``, ``param_sharding='fsdp'`` and a
global-norm clip (it clips by update RMS), with the JAX trainer's words.

K steps per dispatch (tpu_ddp/train/lm.py:338-391):
:meth:`LMTrainer.build_multi_step` runs K steps per call, bit for bit
K :meth:`LMTrainer.train_step` calls: on the CPU a loop, on the card one
replay of a CUDA graph (train/capture.py) per (K, batch shapes, state
tensors), in every layout, with ``grad_accum``, the clip and dropout.

Sequence parallelism (tpu_ddp/train/lm.py:398-451, 571-620, 687-690):
``sp > 1`` makes the world dp x sp x ep, rank ``(d * sp + s) * ep + e``
(the JAX ``make_mesh`` order, parallel/bootstrap.py:mesh_rank). Each
process takes its dp(x ep) rows and its L/sp columns (``put_batch``;
the next-token shift happens on the host, so no halo is exchanged), the
model's attention runs ring or Ulysses attention (``sp_mode``) over the
sp group, and positions are global. The loss each process
differentiates is its local token mean; every gradient is averaged over
(dp, sp) (the expert leaves summed over their dp x sp group and divided
by the world), which is the gradient of the global token mean, since
every shard holds the same number of tokens. ZeRO-1, ZeRO-2 and FSDP
scatter and gather over the dp group only, and the sp half of the mean
is its own all-reduce over the sp group (JAX's ``skip_axes=(dp,)``
algebra). The global-norm clip counts each leaf once: after the sync
the sp peers hold the same gradients. Each (dp, sp, ep) shard draws its
own dropout masks: the key folds in the shard's index.

Tensor parallelism (tpu_ddp/train/lm.py:403-560, 571-590): ``tp > 1``
makes the world dp x sp x tp x ep, rank ``((d * sp + s) * tp + t) * ep +
e``; the model is wrapped ``with_tensor_parallel`` after sp, each
process holding its heads and d_ff slice (``param_specs``). The tp
peers of one data shard feed the same rows. A gradient is averaged over
the data axes a leaf is not sharded over (the data group, ranks of one
t), an ep-sharded leaf's divided by ep, as JAX's ``_sync_grads``; the
replicated leaves' gradients are already equal across tp (Megatron's
``f``). The global-norm clip counts a tp- or ep-sharded leaf's squares
once per cell and a replicated leaf's once. ZeRO-1/2 and FSDP lay the
partitioned leaves out per cell, dp-sharded within it; Adafactor runs
per cell (``CellAdafactor``, or ``FactoredZeRO1`` with the cells' own
row geometry under zero1). Checkpoints stay canonical: parameters and
elementwise state gathered over tp and ep, Adafactor's per-cell state in
the JAX wrapper's global layout (stacked cells), so a checkpoint moves
between the packages at the same layout.

Pipeline parallelism (tpu_ddp/train/lm.py:808-1360):
:class:`PipelineLMTrainer` holds the block leaves stacked and cut into
``pp`` stages (parallel/pipeline.py) and runs one of four schedules over
``num_micro`` microbatches, its stages one per process over a pp group
(the world dp x sp x tp x pp x ep, rank ``(((d * sp + s) * tp + t) * pp
+ p) * ep + e``) or all in this process (``stages="in_process"``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from tpu_ddp_torch.convert import (_leaves_like, cell_of, opt_slot_shapes,
                                   shape_leaves)
from tpu_ddp_torch.models.transformer import fold_in
from tpu_ddp_torch.ops.loss import (chunked_vocab_cross_entropy,
                                    softmax_cross_entropy)
from tpu_ddp_torch.ops.optim import (SGD, Adafactor, AdamW,
                                     clip_by_global_norm, clip_scale_from_sq,
                                     clip_tree, global_sq_norm)
from tpu_ddp_torch.parallel.sync import sync_all_reduce
from tpu_ddp_torch.train import capture
from tpu_ddp_torch.utils.device import resolve_device
from tpu_ddp_torch.utils.tree import tree_leaves, tree_unflatten


@dataclasses.dataclass
class LMTrainState:
    params: Any
    opt_state: Any
    step: int = 0
    # The step on the device (int64, 0-d), kept only where dropout needs
    # it and the optimizer has no count to read it from.
    step_t: Any = None
    # The row order of a pipeline's stacked blocks (PipelineLMTrainer's
    # stage_layout; None: the dense order).
    stage_layout: Any = None


def make_lm_batch(tokens: np.ndarray):
    """(B, L+1) token ids -> (inputs, targets), each (B, L)."""
    tokens = np.asarray(tokens)
    return tokens[:, :-1], tokens[:, 1:]


def format_route_stats(stats) -> str:
    """One metrics-line fragment from :meth:`LMTrainer.route_stats`,
    ``" moe dropped=2.1%/0.0% imbalance=1.31/1.05"``, one slot per routed
    layer; the empty string for a dense model (JAX
    ``format_route_stats``)."""
    if not stats:
        return ""
    drop = "/".join(f"{float(s['dropped_frac']) * 100:.1f}%"
                    for s in stats)
    imb = "/".join(f"{float(s['imbalance']):.2f}" for s in stats)
    return f" moe dropped={drop} imbalance={imb}"


def _skeleton(shapes):
    """A ``param_shapes()`` tree with None at its leaves (shape tuples
    would read as tuple nodes), for ``tree_unflatten``."""
    if isinstance(shapes, dict):
        return {k: _skeleton(v) for k, v in shapes.items()}
    if isinstance(shapes, tuple) and shapes and isinstance(shapes[0], dict):
        return tuple(_skeleton(b) for b in shapes)
    return None


def data_shard_index(rank: int, sp: int = 1, ep: int = 1,
                     tp: int = 1, pp: int = 1) -> int:
    """The (dp, sp, ep) data shard ``rank`` trains on in a dp x sp x tp x
    pp x ep world: its mesh coordinate with the tp and pp axes taken out,
    ``(d * sp + s) * ep + e`` (the rank itself at tp = pp = 1). The tp
    and pp peers of a shard share it, so they share its batch rows and
    dropout keys."""
    from tpu_ddp_torch.parallel.bootstrap import mesh_coords
    d, s, e, _ = mesh_coords(rank, sp, ep, tp, pp)
    return (d * sp + s) * ep + e


def _has_count(optimizer) -> bool:
    """Whether the optimizer's state carries a step count (SGD only with
    a scheduled lr)."""
    return not isinstance(optimizer, SGD) or callable(
        optimizer.learning_rate)


class LMTrainer:
    """A TransformerLM + its optimizer (AdamW by default) on one device,
    data parallel over the process group when ``torch.distributed`` is
    initialised with more than one process, sequence parallel over groups
    of ``sp`` of them, tensor parallel over groups of ``tp`` and expert
    parallel over groups of ``ep``. ``device=None`` means the card. At
    tp = ep = 1 Adafactor runs bare, as in the JAX trainer."""

    # The pipeline's extent, the stages laid over the process group and
    # the stacked rows' order (PipelineLMTrainer).
    pp = _pp_procs = 1
    _stage_layout = None
    _plan_name = "lmtrainer"

    def __init__(self, model, device=None, optimizer=None,
                 grad_accum: int = 1, vocab_chunk: int = 0,
                 param_sharding: str = "replicated",
                 opt_sharding: str = "replicated", sp_mode: str = "ring",
                 clip_grad_norm: float | None = None,
                 dropout_seed: int = 0, ep: int = 1,
                 moe_aux_coef: float = 0.01, sp: int = 1, tp: int = 1):
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        if sp_mode not in ("ring", "ulysses"):
            raise ValueError(f"unknown sequence-parallel mode {sp_mode!r};"
                             " expected 'ring' or 'ulysses'")
        if param_sharding not in ("replicated", "fsdp"):
            raise ValueError(f"unknown param_sharding {param_sharding!r}; "
                             "choose 'replicated' or 'fsdp'")
        if opt_sharding not in ("replicated", "zero1", "zero2"):
            raise ValueError(f"unknown opt_sharding {opt_sharding!r}; "
                             "choose 'replicated', 'zero1' or 'zero2'")
        if clip_grad_norm is not None and clip_grad_norm <= 0:
            raise ValueError(f"clip_grad_norm must be > 0, got "
                             f"{clip_grad_norm}")
        if param_sharding == "fsdp" and opt_sharding != "replicated":
            raise ValueError(
                f"opt_sharding={opt_sharding!r} is redundant under "
                "param_sharding='fsdp' (ZeRO-3 already shards the "
                "optimizer state)")
        if vocab_chunk < 0 or (vocab_chunk
                               and model.vocab_size % vocab_chunk):
            raise ValueError(f"vocab_size={model.vocab_size} not "
                             f"divisible by vocab_chunk={vocab_chunk}")
        if optimizer is not None and not isinstance(
                optimizer, (AdamW, Adafactor, SGD)):
            raise TypeError(f"optimizer {type(optimizer).__name__}: the LM "
                            "trainer takes AdamW, Adafactor or SGD")
        world = dist.get_world_size() if dist.is_initialized() else 1
        if ep < 1 or world % ep:
            raise ValueError(f"ep={ep} must be >= 1 and divide the world "
                             f"size {world}")
        if sp < 1 or world % (sp * ep):
            raise ValueError(f"sp={sp} must be >= 1 and sp x ep = "
                             f"{sp * ep} divide the world size {world}")
        if tp < 1 or world % (sp * tp * ep):
            raise ValueError(f"tp={tp} must be >= 1 and sp x tp x ep = "
                             f"{sp * tp * ep} divide the world size "
                             f"{world}")
        pp = self._pp_procs
        if world % (sp * tp * pp * ep):
            raise ValueError(f"pp={pp} must be >= 1 and sp x tp x pp x ep "
                             f"= {sp * tp * pp * ep} divide the world size"
                             f" {world}")
        self.device = resolve_device(device)
        self.optimizer = optimizer or AdamW()
        self.grad_accum = grad_accum
        self.vocab_chunk = vocab_chunk
        self.clip_grad_norm = clip_grad_norm
        self.dropout_seed = dropout_seed
        self.moe_aux_coef = moe_aux_coef
        # The JAX trainer's dp, sp, mp, pp and ep axes: the world is dp x
        # sp x tp x pp x ep, rank (((d * sp + s) * tp + t) * pp + p) * ep
        # + e (pp is 1 but for a pipeline's stages over the group).
        from tpu_ddp_torch.parallel.bootstrap import mesh_coords, mesh_stage
        self.ep, self.sp, self.tp = ep, sp, tp
        self.dp = world // (sp * tp * pp * ep)
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        _, self.sp_index, self.ep_index, self.tp_index = mesh_coords(
            self.rank, sp, ep, tp, pp)
        self.pp_index = mesh_stage(self.rank, ep, pp)
        self.data_index = data_shard_index(self.rank, sp, ep, tp, pp)
        # The model with every partition axis stripped: the JAX package's
        # canonical tree (checkpoints, conversion, route_stats).
        self.canonical_model = dataclasses.replace(
            model, ep_axis=None, ep_size=1, ep_group=None, sp_axis=None,
            sp_size=1, sp_group=None, tp_axis=None, tp_size=1,
            tp_group=None)
        self._dp_group = self._ep_group = self._sp_group = None
        self._dp_sp_group = self._tp_group = self._pp_group = None
        self._data_group = dist.group.WORLD if dist.is_initialized() else None
        if ep > 1 or sp > 1 or tp > 1 or pp > 1:
            from tpu_ddp_torch.parallel.bootstrap import mesh_groups
            (self._dp_group, self._sp_group, self._ep_group,
             self._dp_sp_group, self._tp_group, self._data_group,
             self._pp_group) = mesh_groups(self.dp, ep, sp, tp, pp)
        if sp > 1:
            # "ring" rotates K/V over sp; "ulysses" re-shards heads and
            # sequence with two all-to-alls.
            model = model.with_sequence_parallel("sp", sp, mode=sp_mode,
                                                 group=self._sp_group)
        if tp > 1:
            model = model.with_tensor_parallel("mp", tp, self._tp_group)
        if ep > 1:
            model = model.with_expert_parallel("ep", ep, self._ep_group)
        self.model = model
        self.is_fsdp = param_sharding == "fsdp"
        self.opt_zero1 = opt_sharding in ("zero1", "zero2")
        self.opt_zero2 = opt_sharding == "zero2"
        self._shapes, self._canon_tree, self._spec_tree = self._trees(model)
        self._skeleton = _skeleton(self._shapes)
        # Each leaf's spec and model-parallel cell partition (None:
        # replicated over mp, pp and ep), and where this process sits.
        from tpu_ddp_torch.parallel.zero import partitions
        self._sizes = {"dp": self.dp, "sp": sp, "mp": tp, "pp": pp, "ep": ep}
        self._index = {"mp": self.tp_index, "ep": self.ep_index,
                       "pp": self.pp_index}
        self._axis_groups = {"mp": self._tp_group, "ep": self._ep_group,
                             "pp": self._pp_group}
        self._specs = shape_leaves(self._spec_tree)
        canon = shape_leaves(self._canon_tree)
        self._local = [tuple(s) for s in shape_leaves(self._shapes)]
        self._parts = partitions(canon, self._specs, self._sizes)
        # Leaf indices of the stacked expert weights (sharded over ep).
        self._expert_leaves = {i for i, pt in enumerate(self._parts)
                               if pt is not None and "ep" in pt.axes}
        factored = isinstance(self.optimizer, Adafactor)
        if factored and self.opt_zero2:
            raise ValueError(
                "opt_sharding='zero2' (dp-scattered flat gradient "
                "accumulation) does not compose with Adafactor's "
                "row-sharded factored state; use 'zero1' or an "
                "elementwise optimizer")
        if factored and self.opt_zero1 and clip_grad_norm is not None:
            raise ValueError(
                "clip_grad_norm with opt_sharding='zero1' Adafactor is not "
                "supported (Adafactor already clips by update RMS, "
                "ops/optim.py); use AdamW/SGD or drop the clip")
        if factored and self.is_fsdp:
            raise ValueError(
                "param_sharding='fsdp' re-lays leaves out flat, which "
                "cannot host Adafactor's factored state; use AdamW/SGD "
                "under fsdp, or opt_sharding='zero1' with Adafactor "
                "(per-cell FactoredZeRO1)")
        # The sharded layouts scatter and gather over dp only.
        group = (self._dp_group if sp * tp * pp * ep > 1
                 else dist.group.WORLD if dist.is_initialized() else None)
        self._group = group
        self._multi_step_cache: dict = {}
        self._graph_stream = None
        # K-step CUDA graphs: captures, replays, each capture's ms.
        self.graph_stats = {"captures": 0, "replays": 0, "capture_ms": []}
        self.layout = self._cell = None
        part = dict(param_specs=self._specs, mesh_axis_sizes=self._sizes)
        if self.opt_zero1:
            from tpu_ddp_torch.parallel.zero import FactoredZeRO1, ZeRO1
            self.layout = (
                FactoredZeRO1(self.optimizer, canon, group,
                              dtype=model.param_dtype, **part)
                if factored else
                ZeRO1(self.optimizer, canon, group,
                      axis_groups=self._axis_groups, **part))
        elif self.is_fsdp:
            from tpu_ddp_torch.parallel.zero import ZeRO3
            self.layout = ZeRO3(self.optimizer, canon, group,
                                axis_groups=self._axis_groups, **part)
        elif factored and any(pt is not None for pt in self._parts):
            # The per-cell layout of the replicated Adafactor's state (the
            # update itself is the bare optimizer's on the cells).
            from tpu_ddp_torch.parallel.zero import CellAdafactor
            self._cell = CellAdafactor(self.optimizer, canon, self._specs,
                                       self._sizes)
        # The decay policy where the leaves' ranks are not it (None: the
        # optimizer's rank rule).
        self._decay = self._decay_mask()
        if self.layout is not None and self._decay is not None:
            self.layout.decay = self._decay

    def _trees(self, model) -> tuple:
        """(this process's shape tree, the canonical shape tree, the spec
        tree) of the parameters the trainer holds."""
        return (model.param_shapes(), self.canonical_model.param_shapes(),
                model.param_specs())

    def _decay_mask(self):
        """The weight-decay mask of the held leaves, or None for the
        optimizer's own rule on their ranks."""
        return None

    def init_state(self, seed: int = 0, params=None) -> LMTrainState:
        """Parameters from ``seed`` (a ``torch.Generator`` on the device),
        or ``params`` given (e.g. ``convert.params_from_jax``), and a fresh
        AdamW state. Leaves are made differentiable in place."""
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.canonical_model.init(gen)
        params = self._local_params(params)
        leaves = tree_leaves(params)
        for p in leaves:
            if p.device != self.device:
                raise ValueError(f"parameter on {p.device}, trainer on "
                                 f"{self.device}")
            p.requires_grad_(True)
        if self.layout is not None:
            opt_state = self.layout.init(self.device)
            if self.is_fsdp:
                # At rest FSDP holds only this rank's shard of each leaf.
                params = self.layout.local_shards(leaves)[0]
                params.requires_grad_(True)
            return self._with_step_t(LMTrainState(params=params,
                                                  opt_state=opt_state))
        return self._with_step_t(LMTrainState(
            params=params, opt_state=self.optimizer.init(leaves)))

    def _with_step_t(self, state: LMTrainState) -> LMTrainState:
        """``state`` with a device step tensor where dropout needs one and
        the optimizer keeps no count."""
        if (self.model.dropout_rate > 0.0 and state.step_t is None
                and "count" not in state.opt_state):
            state.step_t = torch.tensor(state.step, dtype=torch.int64,
                                        device=self.device)
        return state

    def _local_params(self, params):
        """A canonical parameter tree cut to this process's cell: its
        experts, heads and d_ff slice (the tree itself at tp = ep = 1)."""
        if all(pt is None for pt in self._parts):
            return params
        out = [cell_of(p, spec, self._index, self._sizes).detach().clone()
               if pt is not None else p
               for p, spec, pt in zip(tree_leaves(params), self._specs,
                                      self._parts)]
        return tree_unflatten(self._skeleton, out)

    def _gather_cells(self, t, i: int, stack: bool):
        """Leaf ``i``'s ``t`` (one cell's, the same shape on every
        process) from every cell: concatenated along the sharded dims, or
        (``stack``) on leading cell axes, major first (a collective over
        each partition axis's group)."""
        for ax, dim, r in reversed(self._parts[i].parts):
            got = [torch.empty_like(t) for _ in range(r)]
            dist.all_gather(got, t.detach().contiguous(),
                            group=self._axis_groups[ax])
            t = torch.stack(got) if stack else torch.cat(got, dim)
        return t

    def _slot_join(self, i: int, shape):
        """How an optimizer slot of leaf ``i`` with local ``shape`` joins
        its cells in the checkpoint: True (stacked: reduced slots, and
        every slot under ``FactoredZeRO1``, whose JAX layout keeps its
        cells apart), False (concatenated like the parameter), None
        (kept: unpartitioned, or a ``(1,)`` placeholder)."""
        from tpu_ddp_torch.parallel.zero import FactoredZeRO1
        if self._parts[i] is None or tuple(shape) == (1,):
            return None
        return (isinstance(self.layout, FactoredZeRO1)
                or tuple(shape) != self._local[i])

    def put_batch(self, inputs, targets):
        """(B, L) host token ids, this process's rows (its dp x ep shard,
        the same rows on every tp peer) over the whole sequence -> int64
        tensors on the device, cut to this process's L/sp columns at sp >
        1. B must split into ``grad_accum`` equal microbatches, L into sp
        chunks."""
        inputs = torch.as_tensor(np.ascontiguousarray(inputs, np.int64))
        targets = torch.as_tensor(np.ascontiguousarray(targets, np.int64))
        if inputs.shape != targets.shape or inputs.dim() != 2:
            raise ValueError(f"inputs {tuple(inputs.shape)} and targets "
                             f"{tuple(targets.shape)} must be equal (B, L)")
        if inputs.shape[0] % self.grad_accum:
            raise ValueError(f"per-process batch {inputs.shape[0]} not "
                             f"divisible by grad_accum={self.grad_accum}")
        L = inputs.shape[1]
        if L % self.sp:
            raise ValueError(f"seq len {L} not divisible by sp={self.sp}")
        if self.sp > 1:
            lc = L // self.sp
            cut = slice(self.sp_index * lc, (self.sp_index + 1) * lc)
            inputs = inputs[:, cut].contiguous()
            targets = targets[:, cut].contiguous()
        return inputs.to(self.device), targets.to(self.device)

    def step_key(self, step):
        """Step ``step``'s dropout key on this process (None when the
        model has no dropout): ``dropout_seed`` folded with the step and
        the (dp, sp, ep) shard's index (the rank at tp 1), as the JAX
        trainer folds its key with the step and each data axis's index
        and leaves it equal across tp. ``step``: an int (gives an int) or
        a device tensor (gives an int64 tensor of the same value)."""
        if self.model.dropout_rate <= 0.0:
            return None
        return fold_in(fold_in(self.dropout_seed, step), self.data_index)

    def _device_step(self, state: LMTrainState):
        """The step as a 0-d device tensor: the optimizer's count where it
        keeps one (it equals the state's step), else ``state.step_t``."""
        opt = state.opt_state
        if isinstance(opt, dict) and "count" in opt:
            return opt["count"]
        if state.step_t is None:
            raise ValueError("a state with dropout and no optimizer count "
                             "needs its step_t (LMTrainer.init_state or "
                             "state_from_host makes it)")
        return state.step_t

    def _written(self, state: LMTrainState) -> list:
        """The tensors a step writes in place (train/capture.py)."""
        return capture.written(
            state, extra=() if state.step_t is None else (state.step_t,))

    def _loss_and_grads(self, leaves, params, inputs, targets, rng=None):
        """(loss, grads w.r.t. ``leaves``); under FSDP ``params`` is the
        shard buffer, all-gathered here for this microbatch. A MoE model
        adds ``moe_aux_coef`` times its load-balance loss to the gradient's
        objective; the loss returned is the token mean alone."""
        if self.is_fsdp:
            params = tree_unflatten(
                self._skeleton, self.layout.gather_params(params))
        if self.vocab_chunk:
            hidden, aux = self.model.trunk_with_aux(params, inputs, rng=rng)
            nll = chunked_vocab_cross_entropy(
                hidden.reshape(-1, hidden.shape[-1]), params["head"],
                targets.reshape(-1), self.vocab_chunk)
        else:
            logits, aux = self.model.apply_with_aux(params, inputs, rng=rng)
            nll = softmax_cross_entropy(
                logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))
        loss = nll.mean()
        objective = (loss + self.moe_aux_coef * aux
                     if self.model.moe_experts else loss)
        return loss.detach(), torch.autograd.grad(objective, leaves)

    def train_step(self, state: LMTrainState, inputs, targets):
        """One step on the local batch; returns (state, local mean loss
        as a 0-d f32 tensor). Parameters and optimizer state update in
        place."""
        loss, leaves, grads = self.step_grads(state, inputs, targets)
        return self.apply_grads(state, leaves, grads), loss

    def step_grads(self, state: LMTrainState, inputs, targets):
        """(local mean loss, the leaves a step updates, their gradients)
        on the local batch, before the sync, the clip and the optimizer
        (ZeRO-2: the f32 slices already reduce-scattered over dp)."""
        params = state.params
        leaves = [params] if self.is_fsdp else tree_leaves(params)
        A = self.grad_accum
        rng = (self.step_key(self._device_step(state))
               if self.model.dropout_rate > 0.0 else None)
        # ZeRO-2: each microbatch's gradients reduce-scattered at once,
        # the f32 slices accumulated (1/dp of the accumulation buffer).
        scatter = self.layout.scatter_grads if self.opt_zero2 else None
        if A == 1:
            loss, grads = self._loss_and_grads(leaves, params, inputs,
                                               targets, rng)
            grads = list(scatter(grads)[1] if scatter else grads)
        else:
            grads = (self.layout.shard_zeros(self.device)[1] if scatter
                     else [torch.zeros_like(p, dtype=torch.float32)
                           for p in leaves])
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            for i, (x, y) in enumerate(zip(inputs.chunk(A),
                                           targets.chunk(A))):
                # A fresh mask per microbatch, as the JAX scan folds its
                # index into the key.
                r = fold_in(rng, i) if rng is not None else None
                lm, g = self._loss_and_grads(leaves, params, x, y, r)
                g = scatter(g)[1] if scatter else [t.float() for t in g]
                torch._foreach_add_(grads, g)
                loss = loss + lm
            inv = 1.0 / float(A)
            torch._foreach_mul_(grads, inv)
            loss = loss * inv
        return loss, leaves, grads

    # ---- K steps per dispatch (tpu_ddp/train/lm.py:338-391) ------------

    def build_multi_step(self, k: int):
        """``run(state, inputs_k, targets_k) -> (state, losses)``: K steps
        on K stacked batches ((K, B, L) tensors or sequences of K (B, L)
        ones, from :meth:`put_batch`), ``losses`` the (K,) local mean
        losses; each step is :meth:`train_step`'s, bit for bit. On the
        card the K steps are one ``torch.cuda.CUDAGraph``, captured per
        (K, batch shapes, state tensors) over static staging buffers and
        replayed once per call (a state made anew is captured again); on
        the CPU a loop. Dropout reads its step from the device, so a
        replay draws K fresh sets of masks, those of K eager steps.
        Memoised per K."""
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if k in self._multi_step_cache:
            return self._multi_step_cache[k]
        if self.device.type != "cuda":
            def run(state, inputs_k, targets_k):
                losses = []
                for j in range(k):
                    state, loss = self.train_step(state, inputs_k[j],
                                                  targets_k[j])
                    losses.append(loss)
                return state, torch.stack(losses)
        else:
            def make(st, xs, ys):
                if self._graph_stream is None:
                    self._graph_stream = torch.cuda.Stream(self.device)
                grp = capture.GraphGroup(
                    self.train_step, st, xs, ys, device=self.device,
                    stream=self._graph_stream,
                    written_=self._written(st))
                self.graph_stats["captures"] += 1
                self.graph_stats["capture_ms"].append(grp.capture_ms)
                return grp

            graphs = capture.GraphCache(make)

            def run(state, inputs_k, targets_k):
                losses = graphs.run(state, self._written(state),
                                    inputs_k, targets_k)
                self.graph_stats["replays"] += 1
                return dataclasses.replace(state, step=state.step + k), losses
        self._multi_step_cache[k] = run
        return run

    def apply_grads(self, state: LMTrainState, leaves,
                    grads) -> LMTrainState:
        """The rest of a step after :meth:`step_grads`: the sync, the clip
        and the optimizer for this layout, in place; returns the next
        state."""
        z = self.layout
        if self.is_fsdp:
            # The gather's backward summed the shard over dp; the sp and
            # ep halves of the mean are all-reduces of their own.
            if self._expert_leaves:
                self._sync_rest(z.views(grads[0]))
            else:
                self._sync_rest(grads, experts=False)
            g_sh = z.views(grads[0].div_(float(z.axis_size)))
            if self.clip_grad_norm is not None:
                torch._foreach_mul_(g_sh, clip_scale_from_sq(
                    z.sq_norm(g_sh), self.clip_grad_norm))
            z.apply(z.views(state.params.detach()), g_sh, state.opt_state)
        elif self.opt_zero1:
            # The reduce-scatter over dp is the dp half of the sync (under
            # ZeRO-2 it already ran, and these are the f32 slices).
            self._sync_rest(grads)
            kw = dict(clip_norm=self.clip_grad_norm)
            new = (z.apply_scattered(leaves, grads, state.opt_state, **kw)
                   if self.opt_zero2
                   else z.apply(leaves, grads, state.opt_state, **kw))
            with torch.no_grad():
                for p, t in zip(leaves, new):
                    p.copy_(t)
        else:
            if self.ep > 1 or self.tp > 1 or self._pp_procs > 1:
                self._sync_data(grads)
                if self.clip_grad_norm is not None:
                    self._clip_cells(grads)
            else:
                if self.dp * self.sp > 1:
                    sync_all_reduce(grads)
                if self.clip_grad_norm is not None:
                    clip_by_global_norm(grads, self.clip_grad_norm)
            self.optimizer.apply(leaves, grads, state.opt_state,
                                 decay_mask=self._decay)
        if state.step_t is not None:
            state.step_t.add_(1)
        return dataclasses.replace(state, step=state.step + 1)

    def _clip_cells(self, grads) -> None:
        """The global-norm clip over tp and ep cells (JAX
        ``_clip_by_global_norm``), in place: a partitioned leaf's squared
        sum is summed over its partition axes' groups (each cell holds
        other elements), a replicated leaf's counted once, so every
        process applies the same scale."""
        buckets: dict = {}
        for g, pt in zip(grads, self._parts):
            buckets.setdefault(pt.axes if pt is not None else (),
                               []).append(g)
        sq = None
        for axes, gs in buckets.items():
            s = global_sq_norm(gs)
            for ax in axes:
                dist.all_reduce(s, group=self._axis_groups[ax])
            sq = s if sq is None else sq + s
        clip_tree(grads, clip_scale_from_sq(sq, self.clip_grad_norm))

    def _sync_rest(self, grads, experts: bool = True) -> None:
        """The mean over the data axes other than dp (JAX ``_sync_grads``
        with ``skip_axes=(dp,)``), in place: over sp, then over ep for a
        leaf not sharded over ep, an ep-sharded leaf divided by ep (its
        gradient already holds its peers' tokens). ``experts=False``:
        ``grads`` are not the leaves (FSDP's one buffer at ep 1)."""
        for i, g in enumerate(grads):
            if self.sp > 1:
                dist.all_reduce(g, group=self._sp_group)
                g.div_(float(self.sp))
            if self.ep > 1:
                if not (experts and i in self._expert_leaves):
                    dist.all_reduce(g, group=self._ep_group)
                g.div_(float(self.ep))

    def _sync_data(self, grads) -> None:
        """The dp x sp x ep gradient sync (JAX ``_sync_grads``), in
        place: an expert leaf is summed over its dp x sp group and divided
        by dp x sp x ep (its gradient already holds its ep peers' tokens);
        every other leaf is averaged over the data group (the ranks of
        one tp coordinate)."""
        world = float(self.dp * self.sp * self.ep)
        for i, g in enumerate(grads):
            if i in self._expert_leaves:
                if self.dp * self.sp > 1:
                    dist.all_reduce(g, group=self._dp_sp_group)
            elif world > 1:
                dist.all_reduce(g, group=self._data_group)
            g.div_(world)

    def _full_params(self, state: LMTrainState):
        """The canonical parameter tree (FSDP: gathered; tp and ep cells
        gathered; a collective)."""
        leaves = (self.layout.gather(state.params.detach()) if self.is_fsdp
                  else tree_leaves(state.params))
        if self.is_fsdp or any(pt is not None for pt in self._parts):
            return tree_unflatten(self._skeleton, [
                self._gather_cells(p, i, stack=False)
                if pt is not None else p
                for i, (p, pt) in enumerate(zip(leaves, self._parts))])
        return state.params

    def _full_opt(self, state: LMTrainState) -> dict:
        """The optimizer state with canonical leaves in parameter order
        (the sharded layouts gathered, a collective). A slot of a tp- or
        ep-sharded leaf joins its cells as :meth:`_slot_join` says."""
        opt = (self.layout.full_opt(state.opt_state)
               if self.layout is not None else state.opt_state)
        if all(pt is None for pt in self._parts):
            return opt
        out = {}
        for k, v in opt.items():
            if k == "count":
                out[k] = v
                continue
            out[k] = []
            for i, t in enumerate(v):
                join = self._slot_join(i, t.shape)
                out[k].append(t if join is None
                              else self._gather_cells(t, i, stack=join))
        return out

    def params_to_host(self, state: LMTrainState):
        """The parameters as the JAX package's tree of numpy arrays."""
        from tpu_ddp_torch.convert import params_to_jax
        return params_to_jax(self._full_params(state))

    def route_stats(self, state: LMTrainState, tokens) -> list:
        """Routing-health counters on the current weights, one dict per
        MoE layer (``dropped_frac``, ``expert_load`` (E,), ``imbalance``,
        numpy), [] for a dense model: one deterministic trunk pass of the
        canonical model on the canonical parameters, the same numbers
        from every layout and ep (JAX ``LMTrainer.route_stats``). A
        collective under a sharded layout or ep > 1."""
        if not self.model.moe_experts:
            return []
        params = self._full_params(state)
        tokens = torch.as_tensor(np.asarray(tokens, np.int64),
                                 device=self.device)
        stats = self.canonical_model.route_stats(params, tokens)
        return [{k: v.cpu().numpy() for k, v in layer.items()}
                for layer in stats]

    # ---- checkpoint / resume (tpu_ddp/train/lm.py:218-300) -------------

    def sharding_plan(self):
        """This trainer's layout as the JAX ``LMTrainer``'s
        ``ShardingPlan``: the model's ``param_specs`` (heads and d_ff
        over ``mp``, experts over ``ep``, the rest replicated)."""
        from tpu_ddp_torch.parallel.redistribute import P, ShardingPlan

        params = self._spec_tree
        # Bare Adafactor's state is replicated, reduced shapes and all
        # (per cell under tp or ep: CellAdafactor's specs); the other
        # slots mirror their parameter's spec. ZeRO's flat state is
        # dp-sharded (the JAX wrapper's prefix spec, P((mp..., dp)) per
        # partitioned leaf), FSDP's params and state too, leaf by leaf.
        factored = isinstance(self.optimizer, Adafactor)
        slot = (tree_unflatten(self._skeleton, [P()] * len(self._specs))
                if factored else params)
        flat = tree_unflatten(self._skeleton, [
            P((*pt.axes, "dp")) if pt is not None else P("dp")
            for pt in self._parts])
        parted = any(pt is not None for pt in self._parts)
        strategy = self._plan_name
        if self.is_fsdp:
            params = slot = flat
            strategy += "+fsdp"
        elif self.opt_zero1:
            slot = flat if parted else P("dp")
            strategy += "+zero2" if self.opt_zero2 else "+zero1"
        opt = {k: slot for k in opt_slot_shapes(self.optimizer, [])}
        cell = self._cell if self._cell is not None else self.layout
        if hasattr(cell, "state_specs"):
            # FactoredZeRO1: vr (and mu) sharded by rows, leaf by leaf;
            # CellAdafactor: reduced slots over the cell axes.
            opt = {k: tree_unflatten(self._skeleton, v)
                   for k, v in cell.state_specs().items()}
        if _has_count(self.optimizer):
            opt["count"] = P()
        return ShardingPlan(
            strategy=strategy,
            mesh_axes=(("dp", self.dp), ("sp", self.sp), ("mp", self.tp),
                       ("pp", self.pp), ("ep", self.ep)),
            param_specs=params, opt_specs=opt,
            batch_spec=P(("dp", "ep"), "sp"),
            stage_layout=self._stage_layout)

    def state_to_host(self, state: LMTrainState) -> dict:
        """``state`` as the JAX package's canonical host tree:
        ``{"opt_state": {...}, "params", "step"}`` of numpy arrays (f32
        leaves, int32 count, int64 step); ``opt_state`` holds the
        optimizer's slots in the JAX layout (AdamW ``mu``/``nu``,
        Adafactor ``vr``/``vc``/``v``/``mu``, SGD ``momentum``)."""
        from tpu_ddp_torch.convert import opt_state_to_jax, params_to_jax
        params = self._full_params(state)
        return {"opt_state": opt_state_to_jax(params, self._full_opt(state)),
                "params": params_to_jax(params),
                "step": np.int64(state.step)}

    def save_checkpoint(self, directory: str, state: LMTrainState,
                        keep_last: int | None = None,
                        background: bool = False) -> str | None:
        """Every rank builds the canonical tree (sharded layouts gather),
        rank 0 writes it at its step; returns the path (None on other
        ranks). ``background=True`` copies to host memory now and writes
        on a thread; call :meth:`wait_for_checkpoints` before reading it
        back."""
        tree = self.state_to_host(state)
        if self.rank != 0:
            return None
        from tpu_ddp_torch.utils import checkpoint as ckpt
        self.sharding_plan().save(directory)
        if background:
            if getattr(self, "_async_writer", None) is None:
                self._async_writer = ckpt.AsyncCheckpointWriter()
            return self._async_writer.submit(directory, tree, state.step,
                                             keep_last=keep_last)
        return ckpt.save_checkpoint(directory, tree, step=state.step,
                                    keep_last=keep_last)

    def wait_for_checkpoints(self) -> None:
        """Block until any background checkpoint write is on disk."""
        writer = getattr(self, "_async_writer", None)
        if writer is not None:
            writer.wait()

    def restore_checkpoint(self, directory: str,
                           step: int | None = None) -> LMTrainState:
        """Load a checkpoint onto this trainer's device: the newest that
        passes digest verification when ``step`` is None (a corrupt one
        is quarantined and the previous one tried), else that step."""
        from tpu_ddp_torch.parallel.redistribute import warn_if_incompatible
        from tpu_ddp_torch.resilience.integrity import \
            restore_newest_verified
        from tpu_ddp_torch.utils import checkpoint as ckpt
        warn_if_incompatible(directory, self.sharding_plan())
        layout = self._canon_tree

        def tree(node, leaf):
            if isinstance(node, dict):
                return {k: tree(v, leaf) for k, v in node.items()}
            if isinstance(node, tuple) and node and isinstance(node[0],
                                                               dict):
                return tuple(tree(b, leaf) for b in node)
            return leaf(node)

        params = tree(layout, ckpt.shape_leaf)
        opt = {}
        for k, shapes in self._canonical_slot_shapes().items():
            it = iter(shapes)
            opt[k] = tree(layout, lambda _: ckpt.shape_leaf(next(it)))
        if _has_count(self.optimizer):
            opt["count"] = ckpt.shape_leaf((), np.int32)
        template = {"opt_state": opt, "params": params,
                    "step": np.int64(0)}
        if step is None:
            host, _ = restore_newest_verified(directory, template)
        else:
            host, _ = ckpt.restore_checkpoint(directory, template, step)
        return self.state_from_host(host)

    def state_from_host(self, host: dict) -> LMTrainState:
        """The other half of :meth:`state_to_host`: the canonical host
        tree onto this trainer's device, sharded for its layout and dp
        whatever the saving world's."""
        from tpu_ddp_torch.convert import opt_state_from_jax, params_from_jax
        params = self._local_params(params_from_jax(
            self.canonical_model, host["params"], self.device,
            shapes=self._canon_tree))
        if any(pt is not None for pt in self._parts):
            opt_state = self._local_opt_from_host(host["opt_state"])
        else:
            opt_state = opt_state_from_jax(self.model, self.optimizer,
                                           host["opt_state"], self.device,
                                           shapes=self._shapes)
        if self.layout is not None:
            # Re-shard the canonical leaves for this trainer's dp.
            opt_state = self.layout.local_opt(opt_state)
            if self.is_fsdp:
                params = self.layout.local_shards(tree_leaves(params))[0]
        for p in ([params] if self.is_fsdp else tree_leaves(params)):
            p.requires_grad_(True)
        return self._with_step_t(LMTrainState(
            params=params, step=int(host["step"]), opt_state=opt_state))

    def _canonical_slot_shapes(self) -> dict:
        """Each optimizer slot's canonical leaf shapes (the checkpoint's):
        a slot of a tp- or ep-sharded leaf joined over its cells as
        :meth:`_slot_join` says (the whole leaf's shape, or the cell
        counts ahead of the cell's)."""
        out = opt_slot_shapes(self.optimizer, self._local)
        canon = shape_leaves(self._canon_tree)
        for k, shapes in out.items():
            joins = [self._slot_join(i, s) for i, s in enumerate(shapes)]
            out[k] = [s if j is None else
                      self._parts[i].counts + tuple(s) if j else
                      tuple(canon[i])
                      for i, (s, j) in enumerate(zip(shapes, joins))]
        return out

    def _local_opt_from_host(self, opt_host: dict) -> dict:
        """A canonical optimizer state (tp or ep > 1) as this process's
        cell: checked against :meth:`_canonical_slot_shapes`, each
        partitioned slot cut to this cell (its piece, or its entry of the
        leading cell axes), placed on the device."""
        layout = self._canon_tree
        local_slots = opt_slot_shapes(self.optimizer, self._local)
        out = {}
        for k, want in self._canonical_slot_shapes().items():
            got = _leaves_like(f"opt_state/{k}", layout, opt_host[k])
            leaves = []
            for i, (g, w) in enumerate(zip(got, want)):
                g = np.asarray(g, np.float32)
                if tuple(g.shape) != tuple(w):
                    raise ValueError(f"opt_state/{k}/{i}: expected shape "
                                     f"{tuple(w)}, got {tuple(g.shape)}")
                join = self._slot_join(i, local_slots[k][i])
                if join:
                    for ax in self._parts[i].axes:
                        g = g[self._index[ax]]
                elif join is not None:
                    g = cell_of(g, self._specs[i], self._index,
                                self._sizes)
                leaves.append(torch.as_tensor(np.array(g)).to(
                    device=self.device, dtype=self.model.param_dtype))
            out[k] = leaves
        if "count" in opt_host:
            out["count"] = torch.tensor(int(np.asarray(opt_host["count"])),
                                        dtype=torch.int32,
                                        device=self.device)
        return out


class PipelineLMTrainer(LMTrainer):
    """The pipeline-parallel LM trainer (JAX ``PipelineLMTrainer``): the
    block leaves STACKED on a leading layer axis and cut into ``pp``
    stages, each process's batch split into ``num_micro`` (default pp)
    microbatches that stream through the stages under ``schedule``
    (``gpipe``, ``1f1b``, ``interleaved`` with ``pp_virtual`` chunks per
    stage, or ``zerobubble``; parallel/pipeline.py). ``num_micro`` is the
    accumulation: every microbatch's gradient sums into one step.

    ``stages="group"`` (the default) runs one stage per process: the world
    is dp x sp x tp x pp x ep processes, and a stage's peers over dp, sp,
    tp and ep hold the same stage, so the collectives inside a stage and
    the data-side means never cross stages (``mesh_groups``).
    ``stages="in_process"`` runs all pp stages in this process on its one
    device over in-process edges (as the JAX trainer runs all stages of a
    program on one process's devices); it composes with dp over the
    processes. Each process feeds the rows of its data shard
    (``data_index``), so pp and tp peers feed the same rows.

    After the schedule the replicated leaves' gradients (embed on stage 0,
    ln_f and head on the last stage, zeros elsewhere) are SUMMED over the
    pp group; then the dense trainer's sync, clip and optimizer run on this
    process's leaves (stacked leaves partitioned per stage cell), with the
    weight-decay mask of the original per-layer ranks. ZeRO-1 and FSDP lay
    each stage cell out dp-sharded (``P((pp[, mp/ep], dp))``); ZeRO-2
    (1f1b only) reduce-scatters each tick's block gradients over dp and
    the replicated leaves once at the end; FSDP gathers the stage's leaves
    once at step start and reduce-scatters their gradients at the end.
    Checkpoints hold the JAX pipeline trainer's tree: stacked, the dense
    layer order, ``stage_layout`` in the sharding plan under interleaving.
    A live state carries its row order (``LMTrainState.stage_layout``): a
    trainer of another order refuses it (move it through the host,
    ``state_to_host``/``state_from_host``). The MoE load-balance loss is
    dropped, as the JAX pipeline drops it. ``edge_factory``: the
    in-process edge class (a test or a planted fault replaces it)."""

    _plan_name = "pipelinelmtrainer"
    _IN_PROCESS_TODO = (
        "stages='in_process' runs every stage in one process; its "
        "composition with sp, tp, ep and Adafactor's per-stage cells is "
        "ROADMAP Queue 1 item 10.7c (use stages='group', one process per "
        "stage)")

    def __init__(self, model, device=None, num_micro: int | None = None,
                 optimizer=None, dropout_seed: int = 0,
                 schedule: str = "gpipe", opt_sharding: str = "replicated",
                 param_sharding: str = "replicated",
                 clip_grad_norm: float | None = None, sp_mode: str = "ring",
                 pp_virtual: int = 1, pp: int = 1, sp: int = 1, tp: int = 1,
                 ep: int = 1, stages: str = "group"):
        from tpu_ddp_torch.parallel.pipeline import (check_table,
                                                     interleave_permutation,
                                                     tick_table)
        if clip_grad_norm is not None and clip_grad_norm <= 0:
            raise ValueError(f"clip_grad_norm must be > 0, got "
                             f"{clip_grad_norm}")
        if sp_mode not in ("ring", "ulysses"):
            raise ValueError(f"unknown sequence-parallel mode {sp_mode!r};"
                             " expected 'ring' or 'ulysses'")
        if stages not in ("group", "in_process"):
            raise ValueError(f"unknown stages {stages!r}; choose 'group' "
                             "or 'in_process'")
        if pp < 1:
            raise ValueError(f"pp must be >= 1, got {pp}")
        if model.num_layers % pp:
            raise ValueError(f"num_layers={model.num_layers} not "
                             f"divisible by pp={pp}")
        num_micro = num_micro if num_micro is not None else pp
        if num_micro < 1:
            raise ValueError(f"num_micro must be >= 1, got {num_micro}")
        if schedule not in ("gpipe", "1f1b", "interleaved", "zerobubble"):
            raise ValueError(f"unknown schedule {schedule!r}; choose "
                             "'gpipe', '1f1b', 'interleaved' or "
                             "'zerobubble'")
        if pp_virtual < 1:
            raise ValueError(f"pp_virtual must be >= 1, got {pp_virtual}")
        if pp_virtual > 1 and schedule != "interleaved":
            raise ValueError(
                f"pp_virtual={pp_virtual} only applies to "
                "schedule='interleaved' (zero-bubble extends plain 1F1B;"
                " gpipe/1f1b run one chunk per stage)")
        self._layer_perm = self._stage_layout = None
        if schedule == "interleaved":
            if model.num_layers % (pp * pp_virtual):
                raise ValueError(
                    f"interleaved schedule needs num_layers divisible "
                    f"by pp*pp_virtual: {model.num_layers} % "
                    f"{pp * pp_virtual} != 0")
            if num_micro % pp:
                raise ValueError(
                    f"interleaved schedule needs num_micro divisible "
                    f"by pp: {num_micro} % {pp} != 0")
            if pp_virtual > 1:
                self._layer_perm = interleave_permutation(
                    model.num_layers, pp, pp_virtual)
                self._stage_layout = {
                    "kind": "interleaved", "pp": pp,
                    "pp_virtual": pp_virtual,
                    "num_layers": model.num_layers}
        if pp_virtual > 1 and (opt_sharding != "replicated"
                               or param_sharding != "replicated"):
            raise ValueError(
                "pp_virtual > 1 re-orders the stacked layer rows "
                "(interleave_permutation); the sharded-optimizer "
                "layouts (zero1/zero2/fsdp) slice those rows flat and "
                "are not permutation-aware — use replicated opt/param "
                "sharding with virtual stages")
        if opt_sharding not in ("replicated", "zero1", "zero2"):
            raise ValueError(f"unknown opt_sharding {opt_sharding!r}; "
                             "choose 'replicated', 'zero1' or 'zero2'")
        if param_sharding not in ("replicated", "fsdp"):
            raise ValueError(f"unknown param_sharding {param_sharding!r}"
                             "; choose 'replicated' or 'fsdp'")
        if param_sharding == "fsdp" and opt_sharding != "replicated":
            raise ValueError(
                f"opt_sharding={opt_sharding!r} is redundant under "
                "param_sharding='fsdp' (ZeRO-3 already shards the "
                "optimizer state over dp)")
        if opt_sharding == "zero2" and schedule != "1f1b":
            raise ValueError(
                "opt_sharding='zero2' under the pipeline requires "
                "schedule='1f1b': GPipe differentiates the whole tick "
                "scan at once, so there is no per-microbatch gradient "
                "accumulator to scatter — ZeRO-2's memory saving only "
                "exists where the accumulation buffer does")
        factored = isinstance(optimizer, Adafactor)
        if pp_virtual > 1 and factored:
            raise ValueError(
                "pp_virtual > 1 does not compose with Adafactor: the "
                "per-cell factored state has no params-shaped host form "
                "to carry through the interleave permutation at "
                "checkpoint time; use AdamW/SGD with virtual stages")
        if factored and opt_sharding == "zero2":
            raise ValueError(
                "opt_sharding='zero2' (dp-scattered flat gradient "
                "slices) does not compose with Adafactor's row-sharded "
                "factored state; use 'zero1' or an elementwise optimizer")
        self.in_process = stages == "in_process"
        if self.in_process and pp > 1 and (sp > 1 or tp > 1 or ep > 1):
            raise NotImplementedError(self._IN_PROCESS_TODO)
        self.pp, self.num_micro = pp, num_micro
        self.schedule, self.pp_virtual = schedule, pp_virtual
        self._pp_procs = 1 if self.in_process else pp
        self.edge_factory = None
        super().__init__(model, device=device, optimizer=optimizer,
                         param_sharding=param_sharding,
                         opt_sharding=opt_sharding, sp_mode=sp_mode,
                         clip_grad_norm=clip_grad_norm,
                         dropout_seed=dropout_seed, ep=ep, sp=sp, tp=tp)
        if self.in_process and pp > 1 and factored:
            raise NotImplementedError(self._IN_PROCESS_TODO)
        self._table = tick_table(schedule, pp, num_micro, pp_virtual)
        check_table(self._table, pp, pp_virtual)
        self._stages = (list(range(pp)) if self._pp_procs == 1
                        else [self.pp_index])
        self._row0 = (0 if self._pp_procs == 1
                      else self.pp_index * model.num_layers // pp)

    # ---- layout ---------------------------------------------------------

    def _trees(self, model) -> tuple:
        from tpu_ddp_torch.parallel.pipeline import (pipeline_param_specs,
                                                     stacked_shapes)
        held = model.num_layers // self._pp_procs
        return (stacked_shapes(model, held),
                stacked_shapes(self.canonical_model),
                pipeline_param_specs(model))

    def _decay_mask(self):
        """The optimizer's decay policy on the ORIGINAL per-layer ranks
        (JAX ``_decay_mask``): stacking raised every block leaf's rank by
        one, which would otherwise decay the (layers, dm) LayerNorm
        scales and biases that the dense trainer exempts."""
        from tpu_ddp_torch.parallel.pipeline import map_tree
        layer = dict(self._shapes)
        layer["blocks"] = map_tree(lambda s: s[1:], layer["blocks"])
        return [len(s) >= 2 for s in shape_leaves(layer)]

    def init_state(self, seed: int = 0, params=None) -> LMTrainState:
        """Same seed -> the dense model's parameters (JAX ``init_state``),
        stacked, in the interleaved row order under virtual stages, cut to
        this process's stage; ``params`` may be given dense or stacked
        (the dense order)."""
        from tpu_ddp_torch.convert import stacked_from_dense
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.canonical_model.init(gen)
        if isinstance(params["blocks"], tuple):
            params = stacked_from_dense(params)
        params = self._permuted(params, inverse=False)
        state = super().init_state(params=params)
        state.stage_layout = self._stage_layout
        return state

    def _permuted(self, tree, inverse: bool):
        """A stacked tree (params or a params-shaped slot) from the dense
        row order into this trainer's (``inverse``: back)."""
        if self._layer_perm is None:
            return tree
        from tpu_ddp_torch.parallel.pipeline import permute_stacked_blocks
        perm = (np.argsort(self._layer_perm) if inverse
                else self._layer_perm)
        return permute_stacked_blocks(tree, perm)

    def canonical_params(self, params):
        """Stacked params in the DENSE layer order (JAX
        ``canonical_params``): the identity but under virtual stages."""
        return self._permuted(params, inverse=True)

    def put_batch(self, inputs, targets):
        """This process's rows (its data shard's, the same on its pp and
        tp peers) over the whole sequence -> device tensors, cut to its
        L/sp columns; the JAX refusals (the global batch over dp x ep x
        num_micro, L over sp)."""
        b = np.shape(inputs)[0]
        gb = b * self.dp * self.ep
        if gb % (self.dp * self.ep * self.num_micro):
            raise ValueError(
                f"global batch {gb} not divisible by dp*ep*num_micro="
                f"{self.dp * self.ep * self.num_micro}")
        return super().put_batch(inputs, targets)

    # ---- the step -------------------------------------------------------

    def _check_layout(self, state: LMTrainState) -> None:
        if state.stage_layout != self._stage_layout:
            raise ValueError(
                f"state laid out {state.stage_layout!r}, trainer "
                f"{self._stage_layout!r}: a live state keeps its stacked "
                "row order; move it through state_to_host/state_from_host "
                "(parallel/redistribute.py:redistribute_state)")

    def _links(self, inputs):
        from tpu_ddp_torch.parallel.pipeline import (GroupHops,
                                                     InProcessEdge,
                                                     InProcessLinks)
        if self._pp_procs == 1:
            return InProcessLinks(self.pp, self.edge_factory or InProcessEdge)
        mb = inputs.shape[0] // self.num_micro
        return GroupHops(self._pp_group, self.pp_index, self._table, self.pp,
                         self.pp_virtual,
                         (mb, inputs.shape[1], self.model.d_model),
                         self.model.compute_dtype, self.device)

    def _loss_norm(self, inputs) -> float:
        """The gradient scale of a shard's NLL sum (JAX ``_loss_norm``):
        one over its token count, so that the mean over the data shards
        (the same count each) is the gradient of the global token
        mean."""
        return 1.0 / float(inputs.numel())

    def _sync_grads(self, grads) -> None:
        """The pp half of the sync (JAX ``_sync_grads``), in place: a
        replicated leaf's gradient (real on one stage, zeros elsewhere)
        SUMMED over the pp group; the stacked leaves stay stage-local. The
        sp, ep and dp means follow in :meth:`apply_grads`."""
        if self._pp_procs == 1:
            return
        for g, pt in zip(grads, self._parts):
            if pt is None or "pp" not in pt.axes:
                dist.all_reduce(g, group=self._pp_group)

    def step_grads(self, state: LMTrainState, inputs, targets):
        """(local mean loss, this process's leaves, their gradients): the
        schedule's gradients with the pp sum done, before the sp, ep and dp
        sync (FSDP: the shard buffer and its gradient summed over dp;
        ZeRO-2: the leaves and their dp-mean slices)."""
        from tpu_ddp_torch.parallel.pipeline import pipeline_grads
        self._check_layout(state)
        z = self.layout
        if self.is_fsdp:
            full = [t.detach().requires_grad_(True)
                    for t in z.gather(state.params.detach())]
            tree = tree_unflatten(self._skeleton, full)
        else:
            tree = state.params
        rng = (self.step_key(self._device_step(state))
               if self.model.dropout_rate > 0.0 else None)
        scatter, acc = None, None
        if self.opt_zero2:
            # Each tick's block gradients reduce-scattered over dp at once
            # beside zeros for the replicated leaves, the slices summed.
            acc, _ = z.shard_zeros(self.device)
            zeros = {k: tree_unflatten(v, [
                torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                for x in tree_leaves(v)])
                for k, v in tree.items() if k != "blocks"}

            def scatter(g_blocks):
                acc.add_(z.scatter_grads(tree_leaves(
                    dict(zeros, blocks=g_blocks)))[0])
        loss_sum, g = pipeline_grads(
            self.model, tree, inputs, targets, schedule=self.schedule,
            pp_size=self.pp, num_micro=self.num_micro, stages=self._stages,
            links=self._links(inputs), pp_virtual=self.pp_virtual,
            row0=self._row0, perm=self._layer_perm, rng=rng,
            scale=self._loss_norm(inputs), scatter_blocks=scatter)
        grads = tree_leaves(g)
        self._sync_grads(grads)
        loss = loss_sum / float(inputs.numel())
        if self._pp_procs > 1:
            dist.all_reduce(loss, group=self._pp_group)
        if self.is_fsdp:
            return loss, [state.params], [z.reduce_scatter_sum(z.rows(grads))]
        leaves = tree_leaves(state.params)
        if self.opt_zero2:
            acc.add_(z.scatter_grads(grads)[0])
            return loss, leaves, z.views(acc)
        return loss, leaves, grads

    # ---- host trees and checkpoints --------------------------------------

    def state_to_host(self, state: LMTrainState) -> dict:
        """The JAX pipeline trainer's canonical host tree: stacked, the
        dense layer order (params and each params-shaped slot)."""
        self._check_layout(state)
        host = super().state_to_host(state)
        host["params"] = self._permuted(host["params"], inverse=True)
        host["opt_state"] = {
            k: v if k == "count" else self._permuted(v, inverse=True)
            for k, v in host["opt_state"].items()}
        return host

    def state_from_host(self, host: dict) -> LMTrainState:
        """The canonical host tree (dense order; from any schedule or
        layout) onto this trainer's rows, stage and layout."""
        host = dict(host)
        host["params"] = self._permuted(host["params"], inverse=False)
        host["opt_state"] = {
            k: v if k == "count" else self._permuted(v, inverse=False)
            for k, v in host["opt_state"].items()}
        state = super().state_from_host(host)
        state.stage_layout = self._stage_layout
        return state

    def params_to_host(self, state: LMTrainState):
        """The stacked parameters as numpy, the dense layer order."""
        self._check_layout(state)
        return self._permuted(super().params_to_host(state), inverse=True)

    def route_stats(self, state: LMTrainState, tokens) -> list:
        """Routing counters on the dense model's pass over the gathered,
        unstacked parameters (the JAX trainers' numbers)."""
        if not self.model.moe_experts:
            return []
        from tpu_ddp_torch.convert import dense_from_stacked
        params = dense_from_stacked(self._full_params(state),
                                    self.model.num_layers, self._layer_perm)
        tokens = torch.as_tensor(np.asarray(tokens, np.int64),
                                 device=self.device)
        stats = self.canonical_model.route_stats(params, tokens)
        return [{k: v.cpu().numpy() for k, v in layer.items()}
                for layer in stats]
