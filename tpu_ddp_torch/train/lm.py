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
masks.

The JAX trainer's other axes are not ported yet and raise
``NotImplementedError`` naming their ROADMAP item: FSDP and ZeRO-1/2,
sequence and tensor parallelism.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from tpu_ddp_torch.convert import opt_slot_shapes
from tpu_ddp_torch.models.transformer import fold_in
from tpu_ddp_torch.ops.loss import (chunked_vocab_cross_entropy,
                                    softmax_cross_entropy)
from tpu_ddp_torch.ops.optim import (SGD, Adafactor, AdamW,
                                     clip_by_global_norm)
from tpu_ddp_torch.parallel.sync import sync_all_reduce
from tpu_ddp_torch.utils.device import resolve_device
from tpu_ddp_torch.utils.tree import tree_leaves


@dataclasses.dataclass
class LMTrainState:
    params: Any
    opt_state: Any
    step: int = 0


def make_lm_batch(tokens: np.ndarray):
    """(B, L+1) token ids -> (inputs, targets), each (B, L)."""
    tokens = np.asarray(tokens)
    return tokens[:, :-1], tokens[:, 1:]


def _has_count(optimizer) -> bool:
    """Whether the optimizer's state carries a step count (SGD only with
    a scheduled lr)."""
    return not isinstance(optimizer, SGD) or callable(
        optimizer.learning_rate)


def _unported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to tpu_ddp_torch yet "
                               f"(ROADMAP Queue 1 {item})")


class LMTrainer:
    """A TransformerLM + its optimizer (AdamW by default) on one device,
    data parallel over the process group when ``torch.distributed`` is
    initialised with more than one process. ``device=None`` means the
    card. At tp = 1 Adafactor runs bare, as in the JAX trainer."""

    def __init__(self, model, device=None, optimizer=None,
                 grad_accum: int = 1, vocab_chunk: int = 0,
                 param_sharding: str = "replicated",
                 opt_sharding: str = "replicated", sp_mode: str = "ring",
                 clip_grad_norm: float | None = None,
                 dropout_seed: int = 0):
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
        if param_sharding == "fsdp":
            raise _unported("param_sharding='fsdp'",
                            "item 9.4 (parallel/zero.py ZeRO-3)")
        if opt_sharding != "replicated":
            raise _unported(f"opt_sharding={opt_sharding!r}",
                            "item 9.4 (parallel/zero.py ZeRO-1/2)")
        if vocab_chunk < 0 or (vocab_chunk
                               and model.vocab_size % vocab_chunk):
            raise ValueError(f"vocab_size={model.vocab_size} not "
                             f"divisible by vocab_chunk={vocab_chunk}")
        if optimizer is not None and not isinstance(
                optimizer, (AdamW, Adafactor, SGD)):
            raise TypeError(f"optimizer {type(optimizer).__name__}: the LM "
                            "trainer takes AdamW, Adafactor or SGD")
        self.model = model
        self.device = resolve_device(device)
        self.optimizer = optimizer or AdamW()
        self.grad_accum = grad_accum
        self.vocab_chunk = vocab_chunk
        self.clip_grad_norm = clip_grad_norm
        self.dropout_seed = dropout_seed
        # The JAX trainer's dp axis: the process group.
        self.dp = dist.get_world_size() if dist.is_initialized() else 1
        self.rank = dist.get_rank() if dist.is_initialized() else 0

    def init_state(self, seed: int = 0, params=None) -> LMTrainState:
        """Parameters from ``seed`` (a ``torch.Generator`` on the device),
        or ``params`` given (e.g. ``convert.params_from_jax``), and a fresh
        AdamW state. Leaves are made differentiable in place."""
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen)
        leaves = tree_leaves(params)
        for p in leaves:
            if p.device != self.device:
                raise ValueError(f"parameter on {p.device}, trainer on "
                                 f"{self.device}")
            p.requires_grad_(True)
        return LMTrainState(params=params,
                            opt_state=self.optimizer.init(leaves))

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

    def step_key(self, step: int):
        """Step ``step``'s dropout key on this process (None when the
        model has no dropout): ``dropout_seed`` folded with the step and
        the rank, as the JAX trainer folds its key with the step and each
        data axis's index."""
        if self.model.dropout_rate <= 0.0:
            return None
        return fold_in(fold_in(self.dropout_seed, step), self.rank)

    def _loss_and_grads(self, leaves, params, inputs, targets, rng=None):
        if self.vocab_chunk:
            hidden, _ = self.model.trunk_with_aux(params, inputs, rng=rng)
            nll = chunked_vocab_cross_entropy(
                hidden.reshape(-1, hidden.shape[-1]), params["head"],
                targets.reshape(-1), self.vocab_chunk)
        else:
            logits, _ = self.model.apply_with_aux(params, inputs, rng=rng)
            nll = softmax_cross_entropy(
                logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))
        loss = nll.mean()
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def train_step(self, state: LMTrainState, inputs, targets):
        """One step on the local batch; returns (state, local mean loss
        as a 0-d f32 tensor). Parameters and optimizer state update in
        place."""
        params = state.params
        leaves = tree_leaves(params)
        A = self.grad_accum
        rng = self.step_key(state.step)
        if A == 1:
            loss, grads = self._loss_and_grads(leaves, params, inputs,
                                               targets, rng)
            grads = list(grads)
        else:
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            for i, (x, y) in enumerate(zip(inputs.chunk(A),
                                           targets.chunk(A))):
                # A fresh mask per microbatch, as the JAX scan folds its
                # index into the key.
                r = fold_in(rng, i) if rng is not None else None
                lm, g = self._loss_and_grads(leaves, params, x, y, r)
                torch._foreach_add_(grads, [t.float() for t in g])
                loss = loss + lm
            inv = 1.0 / float(A)
            torch._foreach_mul_(grads, inv)
            loss = loss * inv
        if self.dp > 1:
            sync_all_reduce(grads)
        if self.clip_grad_norm is not None:
            clip_by_global_norm(grads, self.clip_grad_norm)
        self.optimizer.apply(leaves, grads, state.opt_state)
        return (LMTrainState(params, state.opt_state, state.step + 1),
                loss)

    def params_to_host(self, state: LMTrainState):
        """The parameters as the JAX package's tree of numpy arrays."""
        from tpu_ddp_torch.convert import params_to_jax
        return params_to_jax(state.params)

    # ---- checkpoint / resume (tpu_ddp/train/lm.py:218-300) -------------

    def sharding_plan(self):
        """This trainer's layout as the JAX ``LMTrainer``'s
        ``ShardingPlan``: everything replicated over ``dp``, the block
        matrices spelled as the JAX model's tensor-parallel specs at
        tp 1 (all ``None``)."""
        from tpu_ddp_torch.parallel.redistribute import P, ShardingPlan

        def spec(name, node, repl=False):
            if isinstance(node, dict):
                return {k: spec(k, v, repl) for k, v in node.items()}
            if isinstance(node, tuple) and node and isinstance(node[0],
                                                               dict):
                return tuple(spec(name, b, repl) for b in node)
            blk = name in ("wqkv", "wq", "wkv", "wo", "w1", "w2")
            return P(*[None] * len(node)) if blk and not repl else P()

        shapes = self.model.param_shapes()
        params = spec("", shapes)
        # Bare Adafactor's state is replicated, reduced shapes and all;
        # the other slots mirror their parameter's spec.
        slot = spec("", shapes, repl=isinstance(self.optimizer, Adafactor))
        opt = {k: slot for k in opt_slot_shapes(self.optimizer, [])}
        if _has_count(self.optimizer):
            opt["count"] = P()
        return ShardingPlan(
            strategy="lmtrainer",
            mesh_axes=(("dp", self.dp), ("sp", 1), ("mp", 1), ("pp", 1),
                       ("ep", 1)),
            param_specs=params, opt_specs=opt,
            batch_spec=P(("dp", "ep"), "sp"))

    def state_to_host(self, state: LMTrainState) -> dict:
        """``state`` as the JAX package's canonical host tree:
        ``{"opt_state": {...}, "params", "step"}`` of numpy arrays (f32
        leaves, int32 count, int64 step); ``opt_state`` holds the
        optimizer's slots in the JAX layout (AdamW ``mu``/``nu``,
        Adafactor ``vr``/``vc``/``v``/``mu``, SGD ``momentum``)."""
        from tpu_ddp_torch.convert import opt_state_to_jax, params_to_jax
        return {"opt_state": opt_state_to_jax(state.params,
                                              state.opt_state),
                "params": params_to_jax(state.params),
                "step": np.int64(state.step)}

    def save_checkpoint(self, directory: str, state: LMTrainState,
                        keep_last: int | None = None,
                        background: bool = False) -> str | None:
        """Rank 0 writes ``state`` at its step (the state is replicated);
        returns the path (None on other ranks). ``background=True``
        copies to host memory now and writes on a thread; call
        :meth:`wait_for_checkpoints` before reading it back."""
        if dist.is_initialized() and dist.get_rank() != 0:
            return None
        from tpu_ddp_torch.utils import checkpoint as ckpt
        tree = self.state_to_host(state)
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
        from tpu_ddp_torch.convert import (opt_state_from_jax,
                                           params_from_jax, shape_leaves)
        from tpu_ddp_torch.parallel.redistribute import warn_if_incompatible
        from tpu_ddp_torch.resilience.integrity import \
            restore_newest_verified
        from tpu_ddp_torch.utils import checkpoint as ckpt
        warn_if_incompatible(directory, self.sharding_plan())
        layout = self.model.param_shapes()

        def tree(node, leaf):
            if isinstance(node, dict):
                return {k: tree(v, leaf) for k, v in node.items()}
            if isinstance(node, tuple) and node and isinstance(node[0],
                                                               dict):
                return tuple(tree(b, leaf) for b in node)
            return leaf(node)

        params = tree(layout, ckpt.shape_leaf)
        opt = {}
        for k, shapes in opt_slot_shapes(self.optimizer,
                                         shape_leaves(layout)).items():
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
        params = params_from_jax(self.model, host["params"], self.device)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        return LMTrainState(
            params=params, step=int(host["step"]),
            opt_state=opt_state_from_jax(self.model, self.optimizer,
                                         host["opt_state"], self.device))
