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
``[loss, skipped]`` together. Instrumentation keeps the reference's
contract: the running loss printed every 20 iterations and the
iteration-1..39 timer, which synchronizes the card before it stops the
clock.

Fault tolerance (resilience/): checkpoints in the JAX package's format
(:meth:`Trainer.save_checkpoint`, :meth:`Trainer.restore_checkpoint`,
the canonical host tree of :meth:`Trainer.state_to_host`), mid-epoch
resume (``train_epoch``'s ``start_iter``), the checkpoint cadence, the
replica check, chaos faults and the launcher's heartbeat.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from tpu_ddp_torch.ops.loss import cross_entropy_loss
from tpu_ddp_torch.ops.metrics import top1_correct
from tpu_ddp_torch.ops.optim import SGD
from tpu_ddp_torch.parallel.sync import canonical_strategy, get_sync_strategy
from tpu_ddp_torch.resilience.guard import StepGuard, nonfinite_flag
from tpu_ddp_torch.utils.config import TrainConfig, refuse_unported_env
from tpu_ddp_torch.utils.device import resolve_device
from tpu_ddp_torch.utils.metrics import MetricsLogger
from tpu_ddp_torch.utils.timing import IterationTimer


@dataclasses.dataclass
class TrainState:
    """``params`` are the model's parameter tensors, updated in place by
    every step; ``opt_state`` holds the momentum buffers."""

    params: list
    opt_state: Any
    step: int = 0


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
    ``all_reduce``, ``fused`` or a ``partN`` alias); every rung but
    ``none`` needs an initialized ``torch.distributed`` process group
    (parallel/bootstrap.py), and ``fused`` wraps the model in
    ``DistributedDataParallel`` with 25 MB buckets. ``device=None`` means
    the card.
    """

    def __init__(self, model, config: TrainConfig | None = None,
                 strategy: str = "none", device=None,
                 metrics: MetricsLogger | None = None):
        refuse_unported_env()
        self.config = config or TrainConfig()
        self.device = resolve_device(device)
        self.model = model.to(self.device)
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
        self.net = self.model
        if self.strategy == "fused":
            from torch.nn.parallel import DistributedDataParallel
            self.net = DistributedDataParallel(
                self.model, bucket_cap_mb=25,
                device_ids=[self.device] if self.device.type == "cuda"
                else None)
        self.optimizer = SGD(learning_rate=self.config.learning_rate,
                             momentum=self.config.momentum,
                             weight_decay=self.config.weight_decay,
                             use_pallas=self.config.pallas_sgd)
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        # Step guard (resilience/guard.py). The flag is agreed across the
        # group with one scalar all_reduce, except under 'none', whose
        # contract is no communication between replicas.
        self._guard_group = (dist.group.WORLD if self.strategy != "none"
                             else None)
        self.guard = (StepGuard(self.config.guard_max_bad_steps,
                                metrics=self.metrics)
                      if self.config.guard_nonfinite else None)
        self._last_fused = None
        self._async_writer = None

    # ---- state ---------------------------------------------------------

    def init_state(self, seed: int | None = None) -> TrainState:
        """Parameter init from the shared seed (reference
        part1/main.py:115-117): every replica builds identical
        parameters. Momentum starts at zero."""
        seed = self.config.seed if seed is None else seed
        self.model.init(torch.Generator().manual_seed(seed))
        params = list(self.model.parameters())
        return TrainState(params=params,
                          opt_state=self.optimizer.init(params))

    # ---- checkpoint / resume (no reference equivalent) ---------------

    def sharding_plan(self):
        """This trainer's layout as the JAX package's ``ShardingPlan``:
        replicated params and momentum over a ``dp`` axis of the world
        size (the JAX trainer's mesh axes: ``dp`` alone for ``none``, which
        runs without a mesh, the 5-axis mesh otherwise)."""
        from tpu_ddp_torch.parallel.redistribute import P, ShardingPlan
        world = dist.get_world_size() if dist.is_initialized() else 1
        axes = (("dp", world),) if self.strategy == "none" else (
            ("dp", world), ("sp", 1), ("mp", 1), ("pp", 1), ("ep", 1))
        return ShardingPlan(strategy=self.strategy_name,
                            mesh_axes=axes, param_specs=P(),
                            opt_specs={"momentum": P()},
                            batch_spec=P("dp"))

    def state_to_host(self, state: TrainState) -> dict:
        """``state`` as the JAX package's canonical host tree,
        ``{"opt_state": {"momentum": ...}, "params": ..., "step": int64}``,
        numpy leaves in JAX layouts (HWIO kernels; momentum through the
        same transpositions as its parameter)."""
        from tpu_ddp_torch.convert import (vgg_momentum_to_jax,
                                           vgg_params_to_jax)
        return {"opt_state": {"momentum": vgg_momentum_to_jax(
                    self.model, state.opt_state["momentum"])},
                "params": vgg_params_to_jax(self.model),
                "step": np.int64(state.step)}

    def state_from_host(self, host: dict) -> TrainState:
        """The other half of :meth:`state_to_host`: parameters copied in
        place into the model (so a ``DistributedDataParallel`` wrapper
        keeps its tensors), momentum and step from the tree."""
        from tpu_ddp_torch.convert import (vgg_momentum_from_jax,
                                           vgg_params_from_jax)
        sd = vgg_params_from_jax(self.model, host["params"], self.device)
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(sd[name])
        momentum = vgg_momentum_from_jax(
            self.model, host["opt_state"]["momentum"], self.device)
        return TrainState(params=list(self.model.parameters()),
                          opt_state={"momentum": momentum},
                          step=int(host.get("step", 0)))

    def save_checkpoint(self, directory: str, state: TrainState,
                        keep_last: int | None = None,
                        background: bool = False) -> str | None:
        """Write ``state`` at its step; only rank 0 writes (the state is
        replicated). Returns the path (None on other ranks).
        ``background=True`` copies to host memory now and writes on a
        thread (utils/checkpoint.py:AsyncCheckpointWriter): call
        :meth:`wait_for_checkpoints` before reading it back."""
        if self.rank != 0:
            return None
        from tpu_ddp_torch.utils import checkpoint as ckpt
        tree = self.state_to_host(state)
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
        """Load a checkpoint onto this trainer's device. ``step=None``
        restores the newest one that passes digest verification: a corrupt
        newest checkpoint is quarantined to ``step_N.corrupt`` and the
        previous one tried (resilience/integrity.py). An explicit
        ``step`` restores that one or raises ``CheckpointCorruptError``.
        A saved plan of another layout warns (canonical shapes restore
        across layouts)."""
        from tpu_ddp_torch.convert import vgg_params_to_jax
        from tpu_ddp_torch.parallel.redistribute import warn_if_incompatible
        from tpu_ddp_torch.resilience.integrity import \
            restore_newest_verified
        from tpu_ddp_torch.utils import checkpoint as ckpt
        warn_if_incompatible(directory, self.sharding_plan())
        shapes = vgg_params_to_jax(self.model)
        template = {"opt_state": {"momentum": shapes}, "params": shapes,
                    "step": np.int64(0)}
        if step is None:
            host, _ = restore_newest_verified(directory, template)
        else:
            host, _ = ckpt.restore_checkpoint(directory, template, step)
        return self.state_from_host(host)

    # ---- train step ----------------------------------------------------

    def _step(self, state: TrainState, images, labels) -> tuple:
        """One step; returns ``(state, loss, fused)``: ``fused`` is the
        device bundle ``[loss, skipped]`` (None without the guard), read
        by the host in one transfer."""
        x = images.to(self.device, non_blocking=True)
        y = labels.to(self.device, non_blocking=True)
        self.model.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(self.net(x), y)
        loss.backward()
        grads = [p.grad for p in state.params]
        skip = fused = None
        if self.guard is not None:
            # From the local loss and the gradients before the sync (DDP
            # has already averaged them inside backward), agreed across
            # the group: a NaN on one rank skips the step on all.
            skip = nonfinite_flag(loss, grads, self._guard_group)
            fused = torch.stack([loss.detach().float(), skip])
        self.sync_fn(grads)
        self.optimizer.apply(state.params, grads, state.opt_state, skip=skip)
        self._last_fused = fused
        return (TrainState(state.params, state.opt_state, state.step + 1),
                loss.detach(), fused)

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
            if (cfg.check_replicas_every
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
        batch means (part1/main.py:108)."""
        del state  # the parameters live in the model
        total_loss, correct, seen, n_batches = 0.0, 0, 0, 0
        for images, labels in batches:
            x = images.to(self.device, non_blocking=True)
            y = labels.to(self.device, non_blocking=True)
            logits = self.model(x)
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
