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
derived from ``dropout_seed``, the step, the process's rank and, under
accumulation, the microbatch (models/transformer.py:fold_in), so a
resumed run continues the same key sequence and ranks draw different
masks. The step is read from a device tensor (the optimizer's count, or
the state's ``step_t`` for an optimizer without one), so a captured step
draws the masks of the step it replays.

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
lays them out). At ep > 1 the optimizer runs replicated (Adafactor bare
on each process's slices, which is the per-cell update); ZeRO and FSDP
over an ep-sharded partition raise (ROADMAP Queue 1 item 10.8b).

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

The JAX trainer's other axes are not ported yet and raise
``NotImplementedError`` naming their ROADMAP item: sequence and tensor
parallelism.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from tpu_ddp_torch.convert import (_leaves_like, opt_slot_shapes,
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


def _leaf_names(node, name: str = "") -> list:
    """The dict key of each leaf of a ``param_shapes()`` tree, in leaf
    order."""
    if isinstance(node, dict):
        return [n for k, v in node.items() for n in _leaf_names(v, k)]
    if isinstance(node, tuple) and node and isinstance(node[0], dict):
        return [n for b in node for n in _leaf_names(b, name)]
    return [name]


def _has_count(optimizer) -> bool:
    """Whether the optimizer's state carries a step count (SGD only with
    a scheduled lr)."""
    return not isinstance(optimizer, SGD) or callable(
        optimizer.learning_rate)


class LMTrainer:
    """A TransformerLM + its optimizer (AdamW by default) on one device,
    data parallel over the process group when ``torch.distributed`` is
    initialised with more than one process, and expert parallel over
    groups of ``ep`` of them. ``device=None`` means the card. At tp = 1
    Adafactor runs bare, as in the JAX trainer."""

    def __init__(self, model, device=None, optimizer=None,
                 grad_accum: int = 1, vocab_chunk: int = 0,
                 param_sharding: str = "replicated",
                 opt_sharding: str = "replicated", sp_mode: str = "ring",
                 clip_grad_norm: float | None = None,
                 dropout_seed: int = 0, ep: int = 1,
                 moe_aux_coef: float = 0.01):
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
        self.device = resolve_device(device)
        self.optimizer = optimizer or AdamW()
        self.grad_accum = grad_accum
        self.vocab_chunk = vocab_chunk
        self.clip_grad_norm = clip_grad_norm
        self.dropout_seed = dropout_seed
        self.moe_aux_coef = moe_aux_coef
        # The JAX trainer's dp and ep axes: the world is dp x ep, rank
        # d * ep + e.
        self.ep = ep
        self.dp = world // ep
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.ep_index = self.rank % ep
        # The model with every partition axis stripped: the JAX package's
        # canonical tree (checkpoints, conversion, route_stats).
        self.canonical_model = dataclasses.replace(
            model, ep_axis=None, ep_size=1, ep_group=None)
        self._dp_group = self._ep_group = None
        if ep > 1:
            if param_sharding != "replicated" or opt_sharding != "replicated":
                raise NotImplementedError(
                    f"param_sharding={param_sharding!r}, opt_sharding="
                    f"{opt_sharding!r} at ep={ep}: ZeRO and FSDP over an "
                    "ep-sharded partition are not ported to tpu_ddp_torch "
                    "yet (ROADMAP Queue 1 item 10.8b); use the replicated "
                    "optimizer")
            from tpu_ddp_torch.parallel.bootstrap import mesh_groups
            self._dp_group, self._ep_group = mesh_groups(self.dp, ep)
            model = model.with_expert_parallel("ep", ep, self._ep_group)
        self.model = model
        self.is_fsdp = param_sharding == "fsdp"
        self.opt_zero1 = opt_sharding in ("zero1", "zero2")
        self.opt_zero2 = opt_sharding == "zero2"
        self._shapes = model.param_shapes()
        self._skeleton = _skeleton(self._shapes)
        # Leaf indices of the stacked expert weights (sharded over ep).
        self._expert_leaves = {
            i for i, path in enumerate(_leaf_names(self._shapes))
            if model.moe_experts and path in ("w1", "w2")}
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
        group = dist.group.WORLD if dist.is_initialized() else None
        self._group = group
        self._multi_step_cache: dict = {}
        self._graph_stream = None
        # K-step CUDA graphs: captures, replays, each capture's ms.
        self.graph_stats = {"captures": 0, "replays": 0, "capture_ms": []}
        self.layout = None
        if self.opt_zero1:
            from tpu_ddp_torch.parallel.zero import FactoredZeRO1, ZeRO1
            self.layout = (
                FactoredZeRO1(self.optimizer, shape_leaves(self._shapes),
                              group, dtype=model.param_dtype)
                if factored else
                ZeRO1(self.optimizer, shape_leaves(self._shapes), group))
        elif self.is_fsdp:
            from tpu_ddp_torch.parallel.zero import ZeRO3
            self.layout = ZeRO3(self.optimizer,
                                shape_leaves(self._shapes), group)

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
        """A canonical parameter tree cut to this process's experts (the
        tree itself at ep = 1)."""
        if self.ep == 1:
            return params
        e_loc = self.model.moe_experts // self.ep
        lo = self.ep_index * e_loc
        out = [p[lo:lo + e_loc].detach().clone()
               if i in self._expert_leaves else p
               for i, p in enumerate(tree_leaves(params))]
        return tree_unflatten(self._skeleton, out)

    def _gather_ep(self, t, stack: bool):
        """Every ep peer's ``t`` (same shape on each), concatenated on
        dim 0 (``stack``: stacked on a new leading axis)."""
        parts = [torch.empty_like(t) for _ in range(self.ep)]
        dist.all_gather(parts, t.detach().contiguous(),
                        group=self._ep_group)
        return torch.stack(parts) if stack else torch.cat(parts)

    def put_batch(self, inputs, targets):
        """(B, L) host token ids -> int64 tensors on the device. B must
        split into ``grad_accum`` equal microbatches."""
        inputs = torch.as_tensor(np.ascontiguousarray(inputs, np.int64))
        targets = torch.as_tensor(np.ascontiguousarray(targets, np.int64))
        if inputs.shape != targets.shape or inputs.dim() != 2:
            raise ValueError(f"inputs {tuple(inputs.shape)} and targets "
                             f"{tuple(targets.shape)} must be equal (B, L)")
        if inputs.shape[0] % self.grad_accum:
            raise ValueError(f"per-process batch {inputs.shape[0]} not "
                             f"divisible by grad_accum={self.grad_accum}")
        return inputs.to(self.device), targets.to(self.device)

    def step_key(self, step):
        """Step ``step``'s dropout key on this process (None when the
        model has no dropout): ``dropout_seed`` folded with the step and
        the rank, as the JAX trainer folds its key with the step and each
        data axis's index. ``step``: an int (gives an int) or a device
        tensor (gives an int64 tensor of the same value)."""
        if self.model.dropout_rate <= 0.0:
            return None
        return fold_in(fold_in(self.dropout_seed, step), self.rank)

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
        self._update(state, leaves, grads)
        if state.step_t is not None:
            state.step_t.add_(1)
        return (LMTrainState(params, state.opt_state, state.step + 1,
                             state.step_t), loss)

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
                return (LMTrainState(state.params, state.opt_state,
                                     state.step + k, state.step_t), losses)
        self._multi_step_cache[k] = run
        return run

    def _update(self, state, leaves, grads) -> None:
        """The sync, the clip and the optimizer for this layout, in
        place."""
        z = self.layout
        if self.is_fsdp:
            # The gather's backward summed the shard over dp.
            g_sh = z.views(grads[0].div_(float(z.axis_size)))
            if self.clip_grad_norm is not None:
                torch._foreach_mul_(g_sh, clip_scale_from_sq(
                    z.sq_norm(g_sh), self.clip_grad_norm))
            z.apply(z.views(state.params.detach()), g_sh, state.opt_state)
            return
        if self.opt_zero1:
            kw = dict(clip_norm=self.clip_grad_norm)
            new = (z.apply_scattered(leaves, grads, state.opt_state, **kw)
                   if self.opt_zero2
                   else z.apply(leaves, grads, state.opt_state, **kw))
            with torch.no_grad():
                for p, t in zip(leaves, new):
                    p.copy_(t)
            return
        if self.ep > 1:
            self._sync_ep(grads)
            if self.clip_grad_norm is not None:
                self._clip_ep(grads)
        else:
            if self.dp > 1:
                sync_all_reduce(grads)
            if self.clip_grad_norm is not None:
                clip_by_global_norm(grads, self.clip_grad_norm)
        self.optimizer.apply(leaves, grads, state.opt_state)

    def _clip_ep(self, grads) -> None:
        """The global-norm clip at ep > 1 (JAX ``_clip_by_global_norm``),
        in place: an expert leaf's squared sum is summed over the ep group
        (each peer holds other experts), a replicated leaf's counted once,
        so every process applies the same scale."""
        experts = [g for i, g in enumerate(grads) if i in self._expert_leaves]
        sq_e = global_sq_norm(experts)
        dist.all_reduce(sq_e, group=self._ep_group)
        sq = global_sq_norm([g for i, g in enumerate(grads)
                             if i not in self._expert_leaves]) + sq_e
        clip_tree(grads, clip_scale_from_sq(sq, self.clip_grad_norm))

    def _sync_ep(self, grads) -> None:
        """The dp x ep gradient sync (JAX ``_sync_grads``), in place: an
        expert leaf is summed over the dp group and divided by the world
        (its gradient already holds its ep peers' tokens); every other
        leaf is averaged over the world."""
        world = float(self.dp * self.ep)
        for i, g in enumerate(grads):
            if i in self._expert_leaves:
                if self.dp > 1:
                    dist.all_reduce(g, group=self._dp_group)
            else:
                dist.all_reduce(g)
            g.div_(world)

    def _full_params(self, state: LMTrainState):
        """The canonical parameter tree (FSDP: gathered; expert leaves
        gathered over ep; a collective)."""
        if self.is_fsdp:
            return tree_unflatten(self._skeleton, self.layout.gather(
                state.params.detach()))
        if self.ep > 1:
            return tree_unflatten(self._skeleton, [
                self._gather_ep(p, stack=False)
                if i in self._expert_leaves else p
                for i, p in enumerate(tree_leaves(state.params))])
        return state.params

    def _full_opt(self, state: LMTrainState) -> dict:
        """The optimizer state with canonical leaves in parameter order
        (the sharded layouts gathered, a collective). At ep > 1 a slot of
        an expert leaf shaped like the leaf is concatenated over ep, a
        reduced one (Adafactor's) stacked on a leading ep axis, and a
        ``(1,)`` placeholder stays one."""
        if self.layout is not None:
            return self.layout.full_opt(state.opt_state)
        if self.ep == 1:
            return state.opt_state
        params = tree_leaves(state.params)
        out = {}
        for k, v in state.opt_state.items():
            if k == "count":
                out[k] = v
                continue
            out[k] = [self._gather_ep(t, stack=t.shape != params[i].shape)
                      if i in self._expert_leaves and tuple(t.shape) != (1,)
                      else t for i, t in enumerate(v)]
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
        ``ShardingPlan``: everything replicated over ``dp``, the block
        matrices spelled as the JAX model's tensor-parallel specs at
        tp 1 (all ``None``)."""
        from tpu_ddp_torch.parallel.redistribute import P, ShardingPlan

        moe = bool(self.model.moe_experts)

        def spec(name, node, repl=False):
            if isinstance(node, dict):
                return {k: spec(k, v, repl) for k, v in node.items()}
            if isinstance(node, tuple) and node and isinstance(node[0],
                                                               dict):
                return tuple(spec(name, b, repl) for b in node)
            if moe and name in ("w1", "w2") and not repl:
                return P("ep" if self.ep > 1 else None, None, None)
            blk = name in ("wqkv", "wq", "wkv", "wo", "w1", "w2")
            return P(*[None] * len(node)) if blk and not repl else P()

        shapes = self.canonical_model.param_shapes()
        params = spec("", shapes)
        # Bare Adafactor's state is replicated, reduced shapes and all;
        # the other slots mirror their parameter's spec. ZeRO's flat
        # state is dp-sharded (the JAX wrapper's prefix spec), FSDP's
        # params and state too, leaf by leaf.
        slot = spec("", shapes, repl=isinstance(self.optimizer, Adafactor))
        strategy = "lmtrainer"
        if self.is_fsdp:
            params = slot = tree_unflatten(
                self._skeleton, [P("dp")] * len(shape_leaves(shapes)))
            strategy += "+fsdp"
        elif self.opt_zero1:
            slot = P("dp")
            strategy += "+zero2" if self.opt_zero2 else "+zero1"
        opt = {k: slot for k in opt_slot_shapes(self.optimizer, [])}
        if hasattr(self.layout, "state_specs"):
            # FactoredZeRO1: vr (and mu) sharded by rows, leaf by leaf.
            opt = {k: tree_unflatten(self._skeleton, v)
                   for k, v in self.layout.state_specs().items()}
        if _has_count(self.optimizer):
            opt["count"] = P()
        return ShardingPlan(
            strategy=strategy,
            mesh_axes=(("dp", self.dp), ("sp", 1), ("mp", 1), ("pp", 1),
                       ("ep", self.ep)),
            param_specs=params, opt_specs=opt,
            batch_spec=P(("dp", "ep"), "sp"))

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
        layout = self.canonical_model.param_shapes()

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
            self.canonical_model, host["params"], self.device))
        if self.ep > 1:
            opt_state = self._local_opt_from_host(host["opt_state"])
        else:
            opt_state = opt_state_from_jax(self.model, self.optimizer,
                                           host["opt_state"], self.device)
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
        at ep > 1 an expert leaf's slot shaped like the leaf has E rows, a
        reduced one a leading ep axis."""
        local = shape_leaves(self._shapes)
        out = opt_slot_shapes(self.optimizer, local)
        if self.ep == 1:
            return out
        E = self.model.moe_experts
        for k, shapes in out.items():
            out[k] = [((E,) + tuple(s)[1:] if tuple(s) == tuple(local[i])
                       else (self.ep,) + tuple(s))
                      if i in self._expert_leaves and tuple(s) != (1,)
                      else s for i, s in enumerate(shapes)]
        return out

    def _local_opt_from_host(self, opt_host: dict) -> dict:
        """A canonical optimizer state (ep > 1) as this process's slices:
        checked against :meth:`_canonical_slot_shapes`, expert rows or
        the ep entry cut out, placed on the device."""
        layout = self.canonical_model.param_shapes()
        e_loc = self.model.moe_experts // self.ep
        lo = self.ep_index * e_loc
        local = shape_leaves(self._shapes)
        local_slots = opt_slot_shapes(self.optimizer, local)
        out = {}
        for k, want in self._canonical_slot_shapes().items():
            got = _leaves_like(f"opt_state/{k}", layout, opt_host[k])
            leaves = []
            for i, (g, w) in enumerate(zip(got, want)):
                g = np.asarray(g, np.float32)
                if tuple(g.shape) != tuple(w):
                    raise ValueError(f"opt_state/{k}/{i}: expected shape "
                                     f"{tuple(w)}, got {tuple(g.shape)}")
                s = tuple(local_slots[k][i])
                if i in self._expert_leaves and s != (1,):
                    g = (g[lo:lo + e_loc] if s == tuple(local[i])
                         else g[self.ep_index])
                leaves.append(torch.as_tensor(np.array(g)).to(
                    device=self.device, dtype=self.model.param_dtype))
            out[k] = leaves
        if "count" in opt_host:
            out["count"] = torch.tensor(int(np.asarray(opt_host["count"])),
                                        dtype=torch.int32,
                                        device=self.device)
        return out
