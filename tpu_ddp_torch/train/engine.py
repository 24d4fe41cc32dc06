"""Train/eval engine (tpu_ddp/train/engine.py): the reference's
``train_model``/``test_model`` loop body (part2/part2b/main.py:124-132)::

    optimizer.zero_grad(); out = model(x); loss = CE(out, y)
    loss.backward(); [sync_gradients(...)]; optimizer.step()

run eagerly on one device per process. The step is the JAX engine's
``_base_step`` without a mesh: the local batch-mean loss (which its
``_loss_terms`` reduces to for equal shards), backward, the strategy's
sync, then ``optimizer.apply`` under the step guard (on by default, as
in JAX): a flag from the loss and the local gradients, agreed over the
process group, gates the update on the device, and a flagged step leaves
params and momentum as they were. Dispatch is synchronous (the JAX
engine's ``dispatch_depth=0``): one host read per step, of the step's
``[loss, skipped]`` together. ``clip_grad_norm`` scales the synced
gradients to that global norm (torch.nn.utils.clip_grad_norm_ semantics,
a device scale, no host read) before the update; the guard reads them
before the clip. The config's memory policy (``remat``, ``act_dtype``)
is imprinted on the model (memory/policy.py:apply_policy), and a
scheduled ``learning_rate`` gives scheduled SGD, whose count stays on the
device and does not advance on a skipped step. Instrumentation keeps the
reference's
contract: the running loss printed every 20 iterations and the
iteration-1..39 timer, which synchronizes the card before it stops the
clock.

The sharded rungs (tpu_ddp/train/engine.py:193-300): ``zero`` (part 4)
keeps SGD's momentum as 1/N flat shards (parallel/zero.py ``ZeRO1``: the
gradient reduce-scatter IS the sync, the update runs on the slices, an
all-gather brings the parameters back), ``fsdp`` (part 5) keeps the
parameters themselves as the rank's shard buffer and all-gathers them
for the forward inside an autograd function whose backward
reduce-scatters the gradients (``ZeRO3``); the model runs on the
gathered leaves through ``torch.func.functional_call``, so the BN+ReLU
kernels stay on its path. Both work in the JAX package's leaf order and
layouts (``convert.VGGCanon``), so a rank's shards are JAX's bytes. The
config's ``grad_compress`` wraps every syncing rung with a bf16 or int8
wire (parallel/compress.py; the int8 carry lives in
``TrainState.comp_state``, is checkpointed and rolls back on a skipped
step), and ``overlap`` replaces the replicated rungs' sync with
bucketed collectives launched from gradient hooks inside the backward,
finished by a sharded update on all_reduce and fused
(parallel/overlap.py). Both degrade to off, with a warning, where they
have nothing to act on (the JAX engine's contract).

Fault tolerance (resilience/): checkpoints in the JAX package's format
(:meth:`Trainer.save_checkpoint`, :meth:`Trainer.restore_checkpoint`,
the canonical host tree of :meth:`Trainer.state_to_host`), mid-epoch
resume (``train_epoch``'s ``start_iter``), the checkpoint cadence, the
replica check, chaos faults and the launcher's heartbeat.
"""

from __future__ import annotations

import dataclasses
import itertools
import warnings
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from tpu_ddp_torch.convert import VGGCanon
from tpu_ddp_torch.ops.loss import cross_entropy_loss
from tpu_ddp_torch.ops.metrics import top1_correct
from tpu_ddp_torch.memory.policy import apply_policy
from tpu_ddp_torch.ops.optim import SGD, clip_by_global_norm
from tpu_ddp_torch.parallel.sync import canonical_strategy, get_sync_strategy
from tpu_ddp_torch.resilience.guard import StepGuard, nonfinite_flag
from tpu_ddp_torch.utils.config import TrainConfig, refuse_unported_env
from tpu_ddp_torch.utils.device import resolve_device
from tpu_ddp_torch.utils.metrics import MetricsLogger
from tpu_ddp_torch.utils.timing import IterationTimer


@dataclasses.dataclass
class TrainState:
    """``params`` are the model's parameter tensors, updated in place by
    every step; ``opt_state`` holds the momentum buffers (and, for a
    scheduled lr, the step count on the device)."""

    params: list
    opt_state: Any
    step: int = 0
    # The int8 gradient wire's carry (parallel/compress.py), else None.
    comp_state: Any = None


class _LossWindow:
    """Running-loss window with the reference's print cadence (loss every
    ``log_every`` iterations, part1/main.py:82-84; the timing report at
    the window's last iteration): the same lines as the JAX engine's."""

    def __init__(self, cfg, metrics, timer, epoch: int, log):
        self._cfg = cfg
        self._metrics = metrics
        self._timer = timer
        self._epoch = epoch
        self._log = log
        self._running = 0.0
        self._window = 0
        self.last_loss = 0.0
        self.iters = 0

    def account(self, it: int, local_loss: float, step: int) -> None:
        cfg = self._cfg
        self._running += local_loss
        self._window += 1
        self.last_loss = local_loss
        self.iters += 1
        if it % cfg.log_every == cfg.log_every - 1:
            window_loss = self._running / max(self._window, 1)
            self._log(f"[epoch {self._epoch}, iter {it + 1}] "
                      f"loss: {window_loss:.3f}")
            self._metrics.log("train_iter", epoch=self._epoch,
                              iter=it + 1, step=step,
                              loss=round(window_loss, 5))
            self._running = 0.0
            self._window = 0
        if it == cfg.timing_last_iter:
            self._log(self._timer.report(prefix=f"[epoch {self._epoch}] "))

    def epoch_stats(self) -> dict:
        timer = self._timer
        self._metrics.log("epoch", epoch=self._epoch, iters=self.iters,
                          avg_iter_s=timer.average_s,
                          timed_iters=timer.count,
                          last_loss=round(self.last_loss, 5))
        return {"avg_iter_ns": timer.average_ns,
                "avg_iter_s": timer.average_s,
                "timed_iters": timer.count,
                "last_loss": self.last_loss,
                "iters": self.iters}


class Trainer:
    """Model + optimizer + sync strategy on one device.

    ``strategy`` picks the ladder rung (``none``, ``gather_scatter``,
    ``all_reduce``, ``fused``, ``zero``, ``fsdp`` or a ``partN`` alias);
    every rung but ``none`` needs an initialized ``torch.distributed``
    process group (parallel/bootstrap.py), and ``fused`` wraps the model
    in ``DistributedDataParallel`` with 25 MB buckets (not when the
    config's ``overlap`` or ``grad_compress`` takes over its sync).
    ``device=None`` means the card. ``clip_grad_norm``: the global-norm
    clip of the synced gradients (None: off). Under ``none`` with more
    than one process each replica clips by its own norm, and a warning
    says so.
    """

    def __init__(self, model, config: TrainConfig | None = None,
                 strategy: str = "none", device=None,
                 metrics: MetricsLogger | None = None,
                 clip_grad_norm: float | None = None):
        refuse_unported_env()
        self.config = config or TrainConfig()
        self.device = resolve_device(device)
        self.model = apply_policy(model, remat=self.config.remat,
                                  act_dtype=self.config.act_dtype
                                  ).to(self.device)
        self.metrics = metrics if metrics is not None else MetricsLogger()
        self.strategy_name = strategy
        self.strategy = canonical_strategy(strategy)
        self.sync_fn = get_sync_strategy(strategy)
        if self.model.use_pallas_bn != self.config.pallas_bn:
            raise ValueError(
                f"model built with use_pallas_bn={self.model.use_pallas_bn}"
                f" but config.pallas_bn={self.config.pallas_bn}")
        if self.strategy != "none" and not torch.distributed.is_initialized():
            raise ValueError(
                f"strategy {strategy!r} needs a torch.distributed process "
                "group (parallel/bootstrap.py:init_distributed_setup)")
        if clip_grad_norm is not None and clip_grad_norm <= 0:
            raise ValueError(
                f"clip_grad_norm must be > 0, got {clip_grad_norm}")
        if (clip_grad_norm is not None and self.strategy == "none"
                and dist.is_initialized() and dist.get_world_size() > 1):
            warnings.warn(
                "clip_grad_norm with strategy 'none': each replica clips "
                "by its own LOCAL gradient norm (no sync), so replicas "
                "diverge; use a syncing rung for global-norm clipping.",
                stacklevel=2)
        self.clip_grad_norm = clip_grad_norm
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.dp = (dist.get_world_size() if dist.is_initialized()
                   and self.strategy != "none" else 1)
        self._group = dist.group.WORLD if self.strategy != "none" else None
        self.is_zero = self.strategy == "zero"
        self.is_fsdp = self.strategy == "fsdp"
        self._canon = VGGCanon(self.model)
        self.optimizer = SGD(learning_rate=self.config.learning_rate,
                             momentum=self.config.momentum,
                             weight_decay=self.config.weight_decay,
                             use_pallas=self.config.pallas_sgd)
        if self.is_zero:
            from tpu_ddp_torch.parallel.zero import ZeRO1
            self.zero = ZeRO1(self.optimizer, self._canon.shapes,
                              self._group)
        if self.is_fsdp:
            from tpu_ddp_torch.parallel.zero import ZeRO3
            self.zero3 = ZeRO3(self.optimizer, self._canon.shapes,
                               self._group)
        self._setup_compression()
        self._setup_overlap()
        self.net = self.model
        if (self.strategy == "fused" and not self._comp_active
                and self._overlap is None):
            from torch.nn.parallel import DistributedDataParallel
            self.net = DistributedDataParallel(
                self.model, bucket_cap_mb=25,
                device_ids=[self.device] if self.device.type == "cuda"
                else None)
        # Step guard (resilience/guard.py). The flag is agreed across the
        # group with one scalar all_reduce, except under 'none', whose
        # contract is no communication between replicas.
        self._guard_group = self._group
        self.guard = (StepGuard(self.config.guard_max_bad_steps,
                                metrics=self.metrics)
                      if self.config.guard_nonfinite else None)
        self._flat = None
        self._last_fused = None
        self._async_writer = None

    def _setup_compression(self) -> None:
        """The gradient wire (tpu_ddp/train/engine.py:227-246): any
        syncing rung at dp > 1; otherwise it degrades to 'none' with a
        warning."""
        from tpu_ddp_torch.parallel.compress import get_compressor
        self.compressor = get_compressor(self.config.grad_compress)
        self._comp_active = (self.compressor.spec != "none"
                             and self.dp > 1 and self.strategy != "none")
        if self.compressor.spec != "none" and not self._comp_active:
            warnings.warn(
                f"grad_compress={self.compressor.spec!r} needs a dp>1 "
                "mesh and a syncing strategy (got "
                f"strategy={self.strategy_name!r}, dp={self.dp}); "
                "compression disabled.", stacklevel=3)
            self.compressor = get_compressor("none")
        self._comp_stateful = self._comp_active and self.compressor.stateful

    def _setup_overlap(self) -> None:
        """Bucketed overlap (tpu_ddp/train/engine.py:257-280): a dp > 1
        group and a replicated syncing rung; otherwise it degrades to the
        unbucketed path with a warning."""
        from tpu_ddp_torch.parallel.compress import REPLICATED_KINDS
        cfg = self.config
        self._overlap = self._sharded_update = None
        active = (cfg.overlap and self.dp > 1
                  and self.strategy in REPLICATED_KINDS)
        if cfg.overlap and not active:
            warnings.warn(
                "overlap=True needs a dp>1 mesh and a replicated "
                f"syncing rung (got strategy={self.strategy_name!r}, "
                f"dp={self.dp}); bucketed overlap disabled.", stacklevel=3)
        if not active:
            return
        from tpu_ddp_torch.parallel.overlap import (SCATTER_KINDS,
                                                    BucketPlan, OverlapSync,
                                                    ShardedUpdate)
        canon = self._canon
        plan = BucketPlan(canon.shapes, cfg.bucket_mb)
        self._overlap = OverlapSync(
            plan, self.strategy, self._group,
            compressor=self.compressor if self._comp_active else None)
        params = list(self.model.parameters())
        self._overlap.attach([params[j] for j in canon.port_index],
                             canon.leaf)
        if self.strategy in SCATTER_KINDS:
            self._sharded_update = ShardedUpdate(self.optimizer, plan,
                                                 self._group)

    # ---- state ---------------------------------------------------------

    def _layout(self):
        """The flat layout of the sharded rungs (None when replicated)."""
        return (self.zero3 if self.is_fsdp
                else self.zero if self.is_zero else None)

    def init_state(self, seed: int | None = None) -> TrainState:
        """Parameter init from the shared seed (reference
        part1/main.py:115-117): every replica builds identical
        parameters. Momentum starts at zero. Under FSDP each rank keeps
        its shard of every leaf."""
        seed = self.config.seed if seed is None else seed
        self.model.init(torch.Generator().manual_seed(seed))
        params = list(self.model.parameters())
        comp_state = (self.compressor.init_state(
            self._canon.shapes, self.device, seed=seed)
            if self._comp_stateful else None)
        if self.is_fsdp:
            self._flat = self.zero3.shard_host(
                [self._np(t) for t in self._canon.leaves(params)],
                self.device)
            return TrainState(params=self.zero3.views(self._flat.detach()),
                              opt_state=self.zero3.init(self.device),
                              comp_state=comp_state)
        if self.is_zero:
            opt_state = self.zero.init(self.device)
        elif self._sharded_update is not None:
            opt_state = self._sharded_update.init(self.device)
        else:
            opt_state = self.optimizer.init(params)
        return TrainState(params=params, opt_state=opt_state,
                          comp_state=comp_state)

    @staticmethod
    def _np(t) -> np.ndarray:
        """A host copy (the tensor may be updated in place later)."""
        return np.array(t.detach().to("cpu", torch.float32).numpy(),
                        order="C", copy=True)

    # ---- checkpoint / resume (no reference equivalent) ---------------

    def sharding_plan(self):
        """This trainer's layout as the JAX package's ``ShardingPlan``:
        params replicated (flat dp shards under FSDP), momentum
        replicated or dp-sharded (ZeRO, FSDP, the sharded update), the
        int8 carry's residual dp-sharded, over a ``dp`` axis of the
        world size (the JAX trainer's mesh axes: ``dp`` alone for
        ``none``, which runs without a mesh, the 5-axis mesh
        otherwise)."""
        from tpu_ddp_torch.parallel.redistribute import P, ShardingPlan
        world = dist.get_world_size() if dist.is_initialized() else 1
        axes = (("dp", world),) if self.strategy == "none" else (
            ("dp", world), ("sp", 1), ("mp", 1), ("pp", 1), ("ep", 1))
        # As the JAX trainer spells them: one prefix spec for ZeRO's and
        # the sharded update's flat state, a tree of flat leaves under
        # FSDP.
        flat = self._canon.tree([P("dp")] * len(self._canon.shapes))
        sharded = self.is_zero or self._sharded_update is not None
        opt_specs = {"momentum": flat if self.is_fsdp
                     else P("dp") if sharded else P()}
        if self._scheduled:
            opt_specs["count"] = P()
        comp_specs = None
        if self._comp_stateful:
            comp_specs = {"seed": P()}
            if self.compressor.error_feedback:
                comp_specs["residual"] = flat
        return ShardingPlan(strategy=self.strategy_name,
                            mesh_axes=axes,
                            param_specs=P("dp") if self.is_fsdp else P(),
                            opt_specs=opt_specs, comp_specs=comp_specs,
                            batch_spec=P("dp"))

    @property
    def _scheduled(self) -> bool:
        return callable(self.optimizer.learning_rate)

    def _canonical_params(self, state: TrainState) -> list:
        """The parameters as canonical numpy leaves (FSDP: gathered, a
        collective every rank enters)."""
        if self.is_fsdp:
            return [self._np(t) for t in self.zero3.gather(
                self._flat.detach())]
        return [self._np(t) for t in self._canon.leaves(state.params)]

    def params_to_host(self, state: TrainState) -> dict:
        """The parameters as the JAX package's VGG tree of numpy arrays
        (HWIO kernels); under FSDP a collective every rank enters."""
        return self._canon.tree(self._canonical_params(state))

    def state_to_host(self, state: TrainState) -> dict:
        """``state`` as the JAX package's canonical host tree,
        ``{"opt_state": {"momentum": ...}, "params": ..., "step": int64}``,
        numpy leaves in JAX layouts (HWIO kernels; momentum through the
        same transpositions as its parameter); scheduled SGD adds the
        int32 ``opt_state["count"]``, the int8 wire ``comp_state``
        (``seed``, and each rank's residual stacked ``(dp, *shape)``).
        Sharded layouts are gathered into canonical shapes: a collective
        every rank enters."""
        canon = self._canon
        mom = state.opt_state["momentum"]
        layout = self._layout()
        if layout is not None:
            mom = [self._np(t) for t in layout.gather(torch.cat(mom))]
        elif self._sharded_update is not None:
            su = self._sharded_update
            mom = su.canonicalize_opt_host(su.gather_state(mom))
        else:
            mom = [self._np(t) for t in canon.leaves(mom)]
        opt = {"momentum": canon.tree(mom)}
        if "count" in state.opt_state:
            opt["count"] = np.int32(state.opt_state["count"].item())
        tree = {"opt_state": opt,
                "params": canon.tree(self._canonical_params(state)),
                "step": np.int64(state.step)}
        if state.comp_state is not None:
            host = self.compressor.state_to_host(state.comp_state,
                                                 self._group)
            if "residual" in host:
                host["residual"] = canon.tree(host["residual"])
            tree["comp_state"] = host
        return tree

    def state_from_host(self, host: dict) -> TrainState:
        """The other half of :meth:`state_to_host`, for this trainer's
        layout and dp whatever the saving world's: parameters copied in
        place into the model (so a ``DistributedDataParallel`` wrapper
        keeps its tensors) and re-sharded under FSDP, momentum sharded
        as this trainer keeps it, the int8 carry adopted when its dp
        matches and reset (with a warning) otherwise."""
        canon = self._canon
        leaves = canon.from_tree(host["params"])
        mom = canon.from_tree(host["opt_state"]["momentum"])
        params = list(self.model.parameters())
        self._write_params(params, [torch.from_numpy(np.array(x))
                                    for x in leaves])
        dev = self.device
        layout = self._layout()
        if layout is not None:
            buf = torch.from_numpy(layout.local_host(
                layout.flatten_opt(mom))).to(dev)
            opt = {"momentum": [v.clone() for v in layout.views(buf)]}
        elif self._sharded_update is not None:
            opt = {"momentum": self._sharded_update.local_opt(mom, dev)}
        else:
            port = [None] * len(params)
            for i, m in enumerate(mom):
                port[canon.port_index[i]] = canon.to_port(
                    i, torch.from_numpy(np.array(m))).to(dev)
            opt = {"momentum": port}
        if self._scheduled:
            opt["count"] = torch.tensor(
                int(host["opt_state"]["count"]), dtype=torch.int32,
                device=dev)
        if self.is_fsdp:
            self._flat = self.zero3.shard_host(leaves, dev)
            params = self.zero3.views(self._flat.detach())
        return TrainState(params=params, opt_state=opt,
                          step=int(host.get("step", 0)),
                          comp_state=self._adopt_comp(
                              host.get("comp_state")))

    def _comp_host_template(self):
        """The int8 carry's checkpoint template at this dp."""
        tree = {"seed": np.uint32(0)}
        if self.compressor.error_feedback:
            from tpu_ddp_torch.utils import checkpoint as ckpt
            tree["residual"] = self._canon.tree(
                [ckpt.shape_leaf((self.dp,) + s) for s in self._canon.shapes])
        return tree

    def _adopt_comp(self, comp_host):
        """A host carry of this trainer's layout, or a fresh one (zero
        residual, the config's seed) with a warning: the residual is an
        accelerator, not model state, and a reset costs a few re-absorbed
        quantization errors, never correctness."""
        if not self._comp_stateful:
            return None
        ok = comp_host is not None and "seed" in comp_host
        if ok and self.compressor.error_feedback:
            try:
                comp_host = dict(comp_host, residual=self._canon.from_tree(
                    comp_host["residual"], lead=(self.dp,)))
            except (KeyError, IndexError, TypeError, ValueError):
                ok = False
        if not ok:
            if comp_host is not None:
                warnings.warn(
                    "compression carry does not match this trainer's "
                    "layout (different dp or residual shape); resetting "
                    "the error-feedback residual.", stacklevel=3)
            return self.compressor.init_state(
                self._canon.shapes, self.device, seed=self.config.seed)
        return self.compressor.state_from_host(comp_host, self.rank,
                                               self.device)

    def save_checkpoint(self, directory: str, state: TrainState,
                        keep_last: int | None = None,
                        background: bool = False) -> str | None:
        """Write ``state`` at its step: every rank builds the canonical
        tree (sharded layouts gather), only rank 0 writes. Returns the
        path (None on other ranks). ``background=True`` copies to host
        memory now and writes on a thread
        (utils/checkpoint.py:AsyncCheckpointWriter): call
        :meth:`wait_for_checkpoints` before reading it back."""
        tree = self.state_to_host(state)
        if self.rank != 0:
            return None
        from tpu_ddp_torch.utils import checkpoint as ckpt
        self.sharding_plan().save(directory)
        if background:
            if self._async_writer is None:
                self._async_writer = ckpt.AsyncCheckpointWriter()
            return self._async_writer.submit(directory, tree, state.step,
                                             keep_last=keep_last)
        return ckpt.save_checkpoint(directory, tree, step=state.step,
                                    keep_last=keep_last)

    def wait_for_checkpoints(self) -> None:
        """Block until any background checkpoint write is on disk."""
        if self._async_writer is not None:
            self._async_writer.wait()

    def restore_checkpoint(self, directory: str,
                           step: int | None = None) -> TrainState:
        """Load a checkpoint onto this trainer's device and layout.
        ``step=None`` restores the newest one that passes digest
        verification: a corrupt newest checkpoint is quarantined to
        ``step_N.corrupt`` and the previous one tried
        (resilience/integrity.py). An explicit ``step`` restores that one
        or raises ``CheckpointCorruptError``. Checkpoints hold canonical
        shapes, so they restore across strategies and dp sizes; a saved
        plan of another layout warns. A matching int8 carry is restored,
        any other (or none) resets it, and a trainer without one drops a
        checkpoint's."""
        from tpu_ddp_torch.parallel.redistribute import warn_if_incompatible
        from tpu_ddp_torch.resilience.integrity import \
            restore_newest_verified
        from tpu_ddp_torch.utils import checkpoint as ckpt
        warn_if_incompatible(directory, self.sharding_plan())
        shapes = self._canon.tree([ckpt.shape_leaf(s)
                                   for s in self._canon.shapes])
        opt = {"momentum": shapes}
        if self._scheduled:
            opt["count"] = ckpt.shape_leaf((), np.int32)
        template = {"opt_state": opt, "params": shapes,
                    "step": np.int64(0)}

        def restore(tmpl, drop_extra=()):
            if step is None:
                return restore_newest_verified(directory, tmpl,
                                               drop_extra=drop_extra)[0]
            return ckpt.restore_checkpoint(directory, tmpl, step,
                                           drop_extra=drop_extra)[0]

        if self._comp_stateful:
            try:
                host = restore({**template,
                                "comp_state": self._comp_host_template()})
            except (KeyError, ValueError):
                warnings.warn(
                    "checkpoint has no matching comp_state (different "
                    "dp, layout, or a pre-compression run); resetting "
                    "the error-feedback residual to zeros.", stacklevel=2)
                host = restore(template, drop_extra=("comp_state",))
        else:
            try:
                host = restore(template)
            except (KeyError, ValueError):
                host = restore(template, drop_extra=("comp_state",))
        return self.state_from_host(host)

    # ---- train step ----------------------------------------------------

    def _forward(self, x, params_canon=None):
        """The model's logits; under FSDP on the gathered canonical
        leaves (``params_canon``), through ``functional_call``."""
        if params_canon is None:
            return self.net(x)
        canon = self._canon
        named = {canon.names[i]: canon.to_port(i, t)
                 for i, t in enumerate(params_canon)}
        return torch.func.functional_call(self.model, named, (x,))

    def _write_params(self, params, leaves) -> None:
        """Canonical leaves -> the model's parameters, in place (one
        strided copy each)."""
        canon = self._canon
        with torch.no_grad():
            for i, leaf in enumerate(leaves):
                p = params[canon.port_index[i]]
                canon.leaf(i, p).copy_(leaf)

    def _flag(self, loss, grads, extra_bad=None):
        if self.guard is None:
            return None
        return nonfinite_flag(loss, grads, self._guard_group,
                              extra_bad=extra_bad)

    def _step(self, state: TrainState, images, labels) -> tuple:
        """One step; returns ``(state, loss, fused)``: ``fused`` is the
        device bundle ``[loss, skipped]`` (None without the guard), read
        by the host in one transfer."""
        from tpu_ddp_torch.parallel.compress import GradCompressor
        x = images.to(self.device, non_blocking=True)
        y = labels.to(self.device, non_blocking=True)
        comp = state.comp_state
        full = None
        if self.is_fsdp:
            self._flat.grad = None
            full = self.zero3.gather_params(
                self._flat, differentiable=not self._comp_active)
            if self._comp_active:
                full = [t.requires_grad_(True) for t in full]
        else:
            self.model.zero_grad(set_to_none=True)
            if self._overlap is not None:
                self._overlap.begin(comp)
        loss = cross_entropy_loss(self._forward(x, full), y)
        loss.backward()
        if self._overlap is not None:
            skip, new_comp = self._overlap_update(state, loss)
        elif self.is_fsdp:
            skip, new_comp = self._fsdp_update(state, loss, full)
        elif self.is_zero:
            skip, new_comp = self._zero_update(state, loss)
        else:
            skip, new_comp = self._replicated_update(state, loss)
        new_comp = GradCompressor.rollback(skip, comp, new_comp)
        fused = (None if skip is None
                 else torch.stack([loss.detach().float(), skip]))
        self._last_fused = fused
        return (TrainState(state.params, state.opt_state, state.step + 1,
                           new_comp), loss.detach(), fused)

    def _replicated_update(self, state, loss):
        grads = [p.grad for p in state.params]
        # From the local loss and the gradients before the sync (DDP has
        # already averaged them inside backward), agreed across the
        # group: a NaN on one rank skips the step on all.
        skip = self._flag(loss, grads)
        new_comp = None
        if self._comp_active:
            # The compressor IS the sync (fused runs without DDP here).
            canon = self._canon
            synced, new_comp = self.compressor.sync_replicated(
                self.strategy, canon.leaves(grads), state.comp_state,
                self._group)
            for i, g in enumerate(synced):
                grads[canon.port_index[i]] = canon.to_port(i, g)
        else:
            self.sync_fn(grads)
        if self.clip_grad_norm is not None:
            clip_by_global_norm(grads, self.clip_grad_norm)
        self.optimizer.apply(state.params, grads, state.opt_state, skip=skip)
        return skip, new_comp

    def _zero_update(self, state, loss):
        """ZeRO-1: the guard reads the local (unsynced) gradients, agreed
        across the group; the reduce-scatter (or the compressed phase 1)
        is the sync; the update runs on the slices."""
        canon = self._canon
        grads = canon.leaves([p.grad for p in state.params])
        skip = self._flag(loss, grads)
        params = canon.leaves(state.params)
        new_comp = None
        if self._comp_active:
            g_sh, new_comp = self.compressor.scatter_mean(
                grads, state.comp_state, self._group)
            new = self.zero.apply_scattered(params, g_sh, state.opt_state,
                                            skip=skip,
                                            clip_norm=self.clip_grad_norm)
        else:
            new = self.zero.apply(params, grads, state.opt_state, skip=skip,
                                  clip_norm=self.clip_grad_norm)
        self._write_params(state.params, new)
        return skip, new_comp

    def _fsdp_update(self, state, loss, full):
        """FSDP: the shard gradients arrive reduce-scattered (SUM) from
        the gather's backward, divided by N here; under a compressed wire
        the gather ran outside autograd and the full local gradients go
        through the compressor's phase 1 instead."""
        z = self.zero3
        new_comp = None
        if self._comp_active:
            grads = [t.grad for t in full]
            skip = self._flag(loss, grads)
            g_sh, new_comp = self.compressor.scatter_mean(
                grads, state.comp_state, self._group)
        else:
            g_buf = self._flat.grad
            g_buf /= float(z.axis_size)
            g_sh = z.views(g_buf)
            skip = self._flag(loss, g_sh)
        if self.clip_grad_norm is not None:
            from tpu_ddp_torch.ops.optim import clip_scale_from_sq
            torch._foreach_mul_(g_sh, clip_scale_from_sq(
                z.sq_norm(g_sh), self.clip_grad_norm))
        z.apply(state.params, g_sh, state.opt_state, skip=skip)
        return skip, new_comp

    def _overlap_update(self, state, loss):
        """The bucketed rungs: the hooks already launched every bucket's
        collective; the guard reads the synced slices (or root-mean
        grads) plus the int8 wire's raw non-finite count."""
        canon = self._canon
        res, new_comp, extra_bad = self._overlap.finish()
        if self._sharded_update is not None:
            skip = self._flag(loss, res, extra_bad)
            new = self._sharded_update.apply_scattered(
                canon.leaves(state.params), res, state.opt_state,
                skip=skip, clip_norm=self.clip_grad_norm)
            self._write_params(state.params, new)
            return skip, new_comp
        grads = [None] * len(state.params)
        for k, leaves in enumerate(res):
            for i, g in zip(self._overlap.plan.buckets[k], leaves):
                grads[canon.port_index[i]] = canon.to_port(i, g)
        skip = self._flag(loss, grads, extra_bad)
        if self.clip_grad_norm is not None:
            clip_by_global_norm(grads, self.clip_grad_norm)
        self.optimizer.apply(state.params, grads, state.opt_state, skip=skip)
        return skip, new_comp

    def train_step(self, state: TrainState, images, labels) -> tuple:
        """One optimization step on this process's batch; returns
        ``(state, loss)`` with ``loss`` the local batch mean (a 0-d
        tensor on the device). ``state.step`` advances on a skipped step
        too, as in the JAX engine."""
        state, loss, _ = self._step(state, images, labels)
        return state, loss

    def last_step_skipped(self) -> bool:
        """True iff the guard skipped the most recent step's update."""
        fused = self._last_fused
        return fused is not None and bool(fused[1] != 0)

    # ---- epoch loop (reference train_model, part1/main.py:52-93) -------

    def train_epoch(self, state: TrainState, batches, epoch: int = 0,
                    log: Callable[[str], None] = print,
                    ckpt_dir: str | None = None, start_iter: int = 0
                    ) -> tuple[TrainState, dict]:
        """``start_iter`` > 0 skips that many leading batches, the
        mid-epoch resume: the skipped batches are still drawn (the
        loader's augmentation draws per (seed, epoch) stay in step) but
        not trained on."""
        from tpu_ddp_torch.resilience.chaos import FaultInjector
        from tpu_ddp_torch.resilience.watchdog import (heartbeat_from_env,
                                                       touch_heartbeat)
        cfg = self.config
        timer = IterationTimer(cfg.timing_first_iter, cfg.timing_last_iter,
                               device=self.device)
        window = _LossWindow(cfg, self.metrics, timer, epoch, log)
        if start_iter:
            batches = itertools.islice(iter(batches), start_iter, None)
        injector = FaultInjector.from_env(rank=self.rank)
        heartbeat = heartbeat_from_env(self.rank)
        for it, (images, labels) in enumerate(batches, start=start_iter):
            if cfg.max_iters is not None and it >= cfg.max_iters:
                break
            # nan-grad poisons this rank's batch (the guard then skips on
            # every rank); stalled-step and slow-rank sleep here.
            if injector.active and injector.before_step(state.step + 1):
                images = FaultInjector.poison_images(images)
            timer.start()
            state, loss, fused = self._step(state, images, labels)
            timer.stop(it)
            if fused is None:
                local_loss, skipped = float(loss), False
            else:
                local_loss, skipped = fused.tolist()
            window.account(it, local_loss, state.step)
            if self.guard is not None:
                # Raises after K skips in a row, before the cadence below
                # can checkpoint the diverging run.
                self.guard.record(state.step, bool(skipped), local_loss)
            if heartbeat is not None:
                touch_heartbeat(heartbeat[0], heartbeat[1], state.step)
            if (ckpt_dir and cfg.ckpt_every_iters
                    and state.step % cfg.ckpt_every_iters == 0):
                self.save_checkpoint(ckpt_dir, state)
            if (cfg.check_replicas_every and not self.is_fsdp
                    and state.step % cfg.check_replicas_every == 0):
                from tpu_ddp_torch.utils.invariants import \
                    check_replica_consistency
                check_replica_consistency(
                    dict(self.model.named_parameters()))
            # hard-exit and corrupt-ckpt fire after the step's save, so a
            # crash-step checkpoint is always on disk.
            injector.after_step(state.step, ckpt_dir)
        return state, window.epoch_stats()

    # ---- eval (reference test_model, part1/main.py:96-111) -------------

    @torch.no_grad()
    def evaluate(self, state: TrainState, batches,
                 log: Callable[[str], None] = print) -> dict:
        """Full test-set pass, unsharded: every node evaluates the whole
        set (part2/part2b/main.py:89-93). The loss is the mean of the
        batch means (part1/main.py:108). Under FSDP the shards are
        gathered once (a collective every rank enters)."""
        del state  # the parameters live in the model (FSDP: the shards)
        full = (self.zero3.gather(self._flat.detach()) if self.is_fsdp
                else None)
        total_loss, correct, seen, n_batches = 0.0, 0, 0, 0
        for images, labels in batches:
            x = images.to(self.device, non_blocking=True)
            y = labels.to(self.device, non_blocking=True)
            logits = (self.model(x) if full is None
                      else self._forward(x, full))
            total_loss += float(cross_entropy_loss(logits, y))
            correct += int(top1_correct(logits, y))
            seen += int(y.shape[0])
            n_batches += 1
        avg_loss = total_loss / max(n_batches, 1)
        accuracy = correct / max(seen, 1)
        log(f"Test set: average loss {avg_loss:.4f}, "
            f"accuracy {correct}/{seen} ({100.0 * accuracy:.2f}%)")
        self.metrics.log("eval", test_loss=round(avg_loss, 5),
                         test_accuracy=round(accuracy, 5), seen=seen)
        return {"test_loss": avg_loss, "test_accuracy": accuracy,
                "correct": correct, "seen": seen}
