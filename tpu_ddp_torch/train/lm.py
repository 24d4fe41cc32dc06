"""Language-model training engine (tpu_ddp/train/lm.py ``LMTrainer``), data
parallel over a ``torch.distributed`` process group of one card each.

One step: the token-mean ``softmax_cross_entropy`` of the f32 logits of
the local batch, its gradients (summed in f32 over ``grad_accum`` equal
microbatches and scaled by 1/A, so a dense model sees exactly the
full-batch gradient), one mean of every gradient over the group when it
has more than one process (the dp ``pmean`` of ``_sync_grads``), then
AdamW, in place. ``train_step`` returns the local mean loss, as each JAX
shard does. Next-token shift happens on the host (``make_lm_batch``).
Checkpoints use the JAX package's format and tree (``save_checkpoint``,
``restore_checkpoint``), so they move between the packages. Like the JAX
LM trainer it has no step guard.

The JAX trainer's other axes are not ported yet and raise
``NotImplementedError`` naming their ROADMAP item: FSDP and ZeRO-1/2,
sequence and tensor parallelism, chunked-vocab cross-entropy, gradient
clipping, Adafactor and scheduled learning rates.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from tpu_ddp_torch.ops.loss import softmax_cross_entropy
from tpu_ddp_torch.ops.optim import AdamW
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


def _unported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to tpu_ddp_torch yet "
                               f"(ROADMAP Queue 1 {item})")


class LMTrainer:
    """A TransformerLM + AdamW on one device, data parallel over the
    process group when ``torch.distributed`` is initialised with more than
    one process. ``device=None`` means the card."""

    def __init__(self, model, device=None, optimizer: AdamW | None = None,
                 grad_accum: int = 1, vocab_chunk: int = 0,
                 param_sharding: str = "replicated",
                 opt_sharding: str = "replicated", sp_mode: str = "ring",
                 clip_grad_norm: float | None = None):
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
        if vocab_chunk:
            raise _unported(f"vocab_chunk={vocab_chunk} (chunked-vocab "
                            "cross-entropy)", "item 10.1 (ops/loss.py)")
        if clip_grad_norm is not None:
            raise _unported("clip_grad_norm", "item 10.4 (clip and "
                            "schedules)")
        if optimizer is not None and not isinstance(optimizer, AdamW):
            raise _unported(f"optimizer {type(optimizer).__name__} for the "
                            "LM trainer", "item 9.1 (ops/optim.py "
                            "Adafactor)")
        self.model = model
        self.device = resolve_device(device)
        self.optimizer = optimizer or AdamW()
        self.grad_accum = grad_accum
        # The JAX trainer's dp axis: the process group.
        self.dp = dist.get_world_size() if dist.is_initialized() else 1

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

    def _loss_and_grads(self, leaves, params, inputs, targets):
        logits, _ = self.model.apply_with_aux(params, inputs)
        nll = softmax_cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                    targets.reshape(-1))
        loss = nll.mean()
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def train_step(self, state: LMTrainState, inputs, targets):
        """One step on the local batch; returns (state, local mean loss
        as a 0-d f32 tensor). Parameters and optimizer state update in
        place."""
        params = state.params
        leaves = tree_leaves(params)
        A = self.grad_accum
        if A == 1:
            loss, grads = self._loss_and_grads(leaves, params, inputs,
                                               targets)
            grads = list(grads)
        else:
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            for x, y in zip(inputs.chunk(A), targets.chunk(A)):
                lm, g = self._loss_and_grads(leaves, params, x, y)
                torch._foreach_add_(grads, [t.float() for t in g])
                loss = loss + lm
            inv = 1.0 / float(A)
            torch._foreach_mul_(grads, inv)
            loss = loss * inv
        if self.dp > 1:
            sync_all_reduce(grads)
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

        def spec(name, node):
            if isinstance(node, dict):
                return {k: spec(k, v) for k, v in node.items()}
            if isinstance(node, tuple) and node and isinstance(node[0],
                                                               dict):
                return tuple(spec(name, b) for b in node)
            blk = name in ("wqkv", "wq", "wkv", "wo", "w1", "w2")
            return P(*[None] * len(node)) if blk else P()

        params = spec("", self.model.param_shapes())
        return ShardingPlan(
            strategy="lmtrainer",
            mesh_axes=(("dp", self.dp), ("sp", 1), ("mp", 1), ("pp", 1),
                       ("ep", 1)),
            param_specs=params,
            opt_specs={"mu": params, "nu": params, "count": P()},
            batch_spec=P(("dp", "ep"), "sp"))

    def state_to_host(self, state: LMTrainState) -> dict:
        """``state`` as the JAX package's canonical host tree:
        ``{"opt_state": {"count", "mu", "nu"}, "params", "step"}`` of
        numpy arrays (f32 leaves, int32 count, int64 step)."""
        from tpu_ddp_torch.convert import adamw_state_to_jax, params_to_jax
        return {"opt_state": adamw_state_to_jax(state.params,
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
        from tpu_ddp_torch.convert import (adamw_state_from_jax,
                                           params_from_jax)
        from tpu_ddp_torch.parallel.redistribute import warn_if_incompatible
        from tpu_ddp_torch.resilience.integrity import \
            restore_newest_verified
        from tpu_ddp_torch.utils import checkpoint as ckpt
        warn_if_incompatible(directory, self.sharding_plan())

        def shapes(node):
            if isinstance(node, dict):
                return {k: shapes(v) for k, v in node.items()}
            if isinstance(node, tuple) and node and isinstance(node[0],
                                                               dict):
                return tuple(shapes(b) for b in node)
            return ckpt.shape_leaf(node)

        params = shapes(self.model.param_shapes())
        template = {"opt_state": {"count": ckpt.shape_leaf((), np.int32),
                                  "mu": params, "nu": params},
                    "params": params, "step": np.int64(0)}
        if step is None:
            host, _ = restore_newest_verified(directory, template)
        else:
            host, _ = ckpt.restore_checkpoint(directory, template, step)
        params = params_from_jax(self.model, host["params"], self.device)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        return LMTrainState(
            params=params, step=int(host["step"]),
            opt_state=adamw_state_from_jax(self.model, host["opt_state"],
                                           self.device))
