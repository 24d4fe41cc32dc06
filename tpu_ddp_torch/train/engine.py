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
params and momentum as they were. ``clip_grad_norm`` scales the synced
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
layouts (``convert.CanonicalView``, built from the model: VGG, ResNet or
ViT), so a rank's shards are JAX's bytes. The
config's ``grad_compress`` wraps every syncing rung with a bf16 or int8
wire (parallel/compress.py; the int8 carry lives in
``TrainState.comp_state``, is checkpointed and rolls back on a skipped
step), and ``overlap`` replaces the replicated rungs' sync with
bucketed collectives launched from gradient hooks inside the backward,
finished by a sharded update on all_reduce and fused
(parallel/overlap.py). Both degrade to off, with a warning, where they
have nothing to act on (the JAX engine's contract).

The loop's host side (tpu_ddp/train/engine.py:1099-1720): the epoch
loop keeps up to ``dispatch_depth`` steps in flight
(train/pipeline.py:DispatchPipeline). Each step's ``[loss, skipped]``
stays on the card until a pinned host copy, recorded behind it with an
event, is harvested in step order, and every consumer (the loss print,
the guard, heartbeats, the checkpoint and replica cadences) runs from
harvested results. ``steps_per_dispatch`` K > 1 runs groups of K uniform
batches per dispatch (:meth:`Trainer.build_multi_step`), on every rung:
on the card one replay of a CUDA graph captured over static
``(K, B, ...)`` staging buffers (train/capture.py), collectives, DDP's
reducer, the gradient wires, the bucket hooks and remat included; on the
CPU a plain loop of K steps; both bit-equal to K single steps.
``device_prefetch`` keeps host-to-device copies in flight
(data/prefetch.py; :meth:`Trainer.put_batch` copies pinned batches on a
side stream), and :meth:`Trainer.evaluate` can shard the test set over
the group.

Fault tolerance (resilience/): checkpoints in the JAX package's format
(:meth:`Trainer.save_checkpoint`, :meth:`Trainer.restore_checkpoint`,
the canonical host tree of :meth:`Trainer.state_to_host`), mid-epoch
resume (``train_epoch``'s ``start_iter``), the checkpoint cadence, the
replica check, chaos faults and the launcher's heartbeat. Under elastic
membership (resilience/elastic.py) the epoch loop checks the protocol
once per step boundary and hands the live state up as a
``MembershipChange``; :meth:`Trainer.rebind` rebuilds what is bound to
the process group for the world that follows.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import warnings
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from tpu_ddp_torch.convert import CanonicalView
from tpu_ddp_torch.ops.loss import cross_entropy_loss
from tpu_ddp_torch.ops.metrics import top1_correct
from tpu_ddp_torch.memory.policy import apply_policy
from tpu_ddp_torch.ops.optim import SGD, clip_by_global_norm
from tpu_ddp_torch.parallel.sync import canonical_strategy, get_sync_strategy
from tpu_ddp_torch.resilience.guard import StepGuard, nonfinite_flag
from tpu_ddp_torch.train import capture
from tpu_ddp_torch.train.capture import written as _written
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

    def epoch_stats(self, pipeline: dict | None = None) -> dict:
        """The epoch's record; ``pipeline`` carries the dispatch
        window's stall accounting (train/pipeline.py) into it, and its
        ``host_gap_ms`` into the metrics gauge of that name."""
        timer = self._timer
        pipeline = pipeline or {}
        if "host_gap_ms" in pipeline:
            self._metrics.observe("host_gap_ms", pipeline["host_gap_ms"])
        self._metrics.log("epoch", epoch=self._epoch, iters=self.iters,
                          avg_iter_s=timer.average_s,
                          timed_iters=timer.count,
                          last_loss=round(self.last_loss, 5), **pipeline)
        return {"avg_iter_ns": timer.average_ns,
                "avg_iter_s": timer.average_s,
                "timed_iters": timer.count,
                "last_loss": self.last_loss,
                "iters": self.iters, **pipeline}


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
        # Autotuning fallback hook (tune/): parts/common.py resolves
        # BEFORE get_model so model-level knobs apply; direct Trainer
        # construction resolves here with model_built=True (model-level
        # overrides are dropped with a log line). resolve() returns a
        # config with autotune="off", so the trial runner's own Trainers
        # cannot recurse. Before apply_policy, so a tuned remat reaches
        # the model.
        if getattr(self.config, "autotune", "off") != "off":
            from tpu_ddp_torch import tune
            self.config = tune.resolve(self.config, strategy=strategy,
                                       device=self.device, model_built=True)
        self.model = apply_policy(model, remat=self.config.remat,
                                  act_dtype=self.config.act_dtype
                                  ).to(self.device)
        self.metrics = metrics if metrics is not None else MetricsLogger()
        self.strategy_name = strategy
        self.strategy = canonical_strategy(strategy)
        self.sync_fn = get_sync_strategy(strategy)
        # A model without BatchNorm (ViT) carries no use_pallas_bn: its
        # factory takes the knob and drops it, as the JAX one does.
        bn = getattr(self.model, "use_pallas_bn", None)
        if bn is not None and bn != self.config.pallas_bn:
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
        self.is_zero = self.strategy == "zero"
        self.is_fsdp = self.strategy == "fsdp"
        self._canon = CanonicalView(self.model)
        self.optimizer = SGD(learning_rate=self.config.learning_rate,
                             momentum=self.config.momentum,
                             weight_decay=self.config.weight_decay,
                             use_pallas=self.config.pallas_sgd)
        self._bind_group()
        self.guard = (StepGuard(self.config.guard_max_bad_steps,
                                metrics=self.metrics)
                      if self.config.guard_nonfinite else None)
        self._flat = None
        self._last_fused = None
        self._async_writer = None
        self._copy_stream = None
        self._multi_step_cache: dict = {}
        # K-step CUDA graphs: captures, replays, the undone eager warm-up
        # steps before the captures and each capture's ms (the wrappers
        # count their launches at warm-up and capture only, so a replay's
        # launches are the capture's).
        self.graph_stats = {"captures": 0, "replays": 0, "warmup_steps": 0,
                            "capture_ms": []}

    def _bind_group(self) -> None:
        """Every part bound to the process group now up: the rank, dp and
        group, the flat ZeRO/FSDP layouts, the gradient wire, the overlap
        buckets and their hooks, ``DistributedDataParallel`` (25 MB
        buckets, on the rung that syncs through it: ``fused`` without a
        compressed wire or bucketed overlap) and the guard's group."""
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.dp = (dist.get_world_size() if dist.is_initialized()
                   and self.strategy != "none" else 1)
        self._group = dist.group.WORLD if self.strategy != "none" else None
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
            self._make_ddp(graphed=self.device.type == "cuda"
                           and self.config.steps_per_dispatch > 1)
        # Step guard (resilience/guard.py). The flag is agreed across the
        # group with one scalar all_reduce, except under 'none', whose
        # contract is no communication between replicas.
        self._guard_group = self._group

    def _make_ddp(self, graphed: bool) -> None:
        """``self.net``: ``DistributedDataParallel`` over the model (25 MB
        buckets; its constructor broadcasts rank 0's parameters, a
        collective every rank enters). ``graphed`` (K-step graphs on the
        card): built on the capture stream, whose gradient accumulators a
        capture of the backward needs, and sampling its runtime
        statistics on its first 10 iterations only, since a sampling
        iteration syncs on the previous one's events."""
        from torch.nn.parallel import DistributedDataParallel
        card = self.device.type == "cuda"
        with (torch.cuda.stream(self._capture_stream()) if graphed
              else contextlib.nullcontext()):
            self.net = DistributedDataParallel(
                self.model, bucket_cap_mb=25,
                device_ids=[self.device] if card else None)
        if graphed:
            self.net._set_ddp_runtime_logging_sample_rate(2 ** 31 - 1)
        self._ddp_graphed = graphed
        self._ddp_iters = 0

    def _capture_stream(self):
        """The side stream every K-step graph of this trainer is
        captured on (made on first use)."""
        if getattr(self, "_graph_stream", None) is None:
            self._graph_stream = torch.cuda.Stream(self.device)
        return self._graph_stream

    def rebind(self) -> None:
        """Re-resolve every part bound to the process group against the
        group now up: the trainer's half of a membership change
        (tpu_ddp/train/engine.py ``rebind_mesh``). The rank and dp, the
        flat ZeRO/FSDP layouts, the gradient wire (degraded to none below
        dp 2, back on when the world regrows), the overlap buckets and
        their hooks, ``DistributedDataParallel`` and its reducer (built
        anew on the new group: its constructor broadcasts rank 0's
        parameters, a collective every member enters), the guard's group,
        and the memoised K-step graphs. State is not placed here: take it
        through :meth:`state_to_host` before the old group goes and
        :meth:`state_from_host` after this call (which keeps the int8
        carry when dp is unchanged and resets it otherwise)."""
        import gc
        if self._overlap is not None:
            self._overlap.detach()
        # Drop the old wrapper first: its reducer's autograd hooks go
        # with it, before the new one registers its own.
        self.net = self.model
        gc.collect()
        self._bind_group()
        self._flat = None
        self._last_fused = None
        self._multi_step_cache = {}

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
                "compression disabled.", stacklevel=4)
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
                f"dp={self.dp}); bucketed overlap disabled.", stacklevel=4)
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
        """The parameters as the JAX model's tree of numpy arrays (HWIO
        conv kernels); under FSDP a collective every rank enters."""
        return self._canon.tree(self._canonical_params(state))

    def state_to_host(self, state: TrainState,
                      local_only: bool = False) -> dict:
        """``state`` as the JAX package's canonical host tree,
        ``{"opt_state": {"momentum": ...}, "params": ..., "step": int64}``,
        numpy leaves in JAX layouts (HWIO kernels; momentum through the
        same transpositions as its parameter); scheduled SGD adds the
        int32 ``opt_state["count"]``, the int8 wire ``comp_state``
        (``seed``, and each rank's residual stacked ``(dp, *shape)``).
        Sharded layouts are gathered into canonical shapes: a collective
        every rank enters.

        ``local_only=True`` is the membership-change path: a peer may be
        dead, so no collective may run. State sharded across processes
        (ZeRO, FSDP, the sharded update at more than one process) cannot
        be had then and raises ``RuntimeError`` (the elastic loop falls
        back to a restart from checkpoint); the int8 carry's residual,
        sharded too, is left out (reset after the reshard)."""
        multiproc = dist.is_initialized() and dist.get_world_size() > 1
        if local_only and multiproc and (
                self.is_zero or self.is_fsdp
                or self._sharded_update is not None):
            raise RuntimeError(
                "live state of a cross-process ZeRO/FSDP/sharded-update "
                "run cannot be snapshotted without the lost peer's "
                "shards; this membership change needs a checkpoint "
                "restart")
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
        if state.comp_state is not None and not (local_only and multiproc):
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
        new_comp = GradCompressor.commit(skip, comp, new_comp)
        if self.net is not self.model:
            self._ddp_iters += 1
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
        """True iff the guard skipped the most recent step's update (for
        a K-step group, its last step)."""
        fused = self._last_fused
        return fused is not None and bool(fused.reshape(-1)[-1] != 0)

    # ---- async dispatch (tpu_ddp/train/engine.py:1237-1350) ------------

    @staticmethod
    def _bundle(loss, fused):
        """The step's ``[loss, skipped]`` on its device (skipped 0
        without the guard)."""
        if fused is not None:
            return fused
        loss = loss.detach().float()
        return torch.stack([loss, torch.zeros_like(loss)])

    def put_batch(self, images, labels) -> tuple:
        """A host batch onto this trainer's device: ``(x, y, ready)``.
        On the card the batch is pinned and copied on a side stream, and
        ``ready`` is the copy's event, which the step makes the compute
        stream wait on (:func:`data.prefetch.prefetch_to_device` keeps
        such copies ahead of the step). Elsewhere, or for tensors already
        on the card, ``ready`` is None."""
        dev = self.device
        if dev.type != "cuda" or images.device.type == "cuda":
            return images.to(dev), labels.to(dev), None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(dev)
        hx, hy = images.pin_memory(), labels.pin_memory()
        with torch.cuda.stream(self._copy_stream):
            x = hx.to(dev, non_blocking=True)
            y = hy.to(dev, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return x, y, ready

    def _consume(self, x, y, ready):
        """Order a put batch's copy before the step that reads it."""
        if ready is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ready)
            # The tensors came from the copy stream's pool: keep them
            # alive until the compute stream is done with them.
            x.record_stream(cur)
            y.record_stream(cur)
        return x, y

    def _handle(self, bundle):
        """A pipeline handle for a step's (or group's) bundle: on the
        card a pinned host copy queued behind the step and an event
        recorded after it (reading the copy once the event is done waits
        for nothing); on the CPU the bundle itself."""
        if bundle.device.type != "cuda":
            return bundle
        host = torch.empty(bundle.shape, dtype=bundle.dtype,
                           pin_memory=True)
        host.copy_(bundle, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(bundle.device))
        return host, done

    @staticmethod
    def _host_rows(handle):
        return (handle[0] if isinstance(handle, tuple) else handle).cpu()

    def train_step_async(self, state: TrainState, images, labels,
                         ready=None) -> tuple:
        """Like :meth:`train_step` but returns ``(state, handle)`` without
        any host synchronization: the step's ``[loss, skipped]`` handle
        that the epoch loop pushes onto its
        :class:`~tpu_ddp_torch.train.pipeline.DispatchPipeline` and reads
        once with :meth:`_materialize_fused`. ``ready``: the copy event
        of a :meth:`put_batch`."""
        x, y = self._consume(images, labels, ready)
        state, loss, fused = self._step(state, x, y)
        return state, self._handle(self._bundle(loss, fused))

    def _materialize_fused(self, handle) -> tuple[float, bool]:
        """(local_loss, skipped) from a ready single-step handle."""
        loss, skipped = self._host_rows(handle).reshape(-1).tolist()
        return float(loss), skipped > 0

    # ---- K steps per dispatch (tpu_ddp/train/engine.py:1099-1235) ------

    def put_batches(self, images_k, labels_k) -> tuple:
        """Stage K batches for :meth:`build_multi_step`: sequences of K
        same-shape batches -> ``(xs, ys)``, K batches each, ``xs[j]``
        laid out as the loader's batch (channels_last stays
        channels_last). On the card they stay where they are: the
        graph's :meth:`_StepGraph.stage` copies them straight into its
        static buffers, so a group is copied to the device once."""
        if self.device.type == "cuda":
            return tuple(images_k), tuple(labels_k)
        return (tuple(t.to(self.device) for t in images_k),
                tuple(t.to(self.device) for t in labels_k))

    def _graph_written(self, state) -> list:
        """Every tensor a step of this trainer writes in place
        (train/capture.py:written), FSDP's flat shard buffer included."""
        return _written(state, [self._flat] if self.is_fsdp else [])

    def build_multi_step(self, k: int):
        """A K-steps-per-dispatch call ``run(state, xs, ys) -> (state,
        losses)``: ``xs``/``ys`` hold K batches each
        (:meth:`put_batches`) and ``losses`` stacks the K local losses;
        ``self._last_fused`` holds the group's (K, 2) ``[loss, skipped]``
        rows. Each step is :meth:`train_step`'s, bit for bit.

        On the card the group is one ``torch.cuda.CUDAGraph``, captured
        once per (K, batch shapes, state tensors) over static staging
        buffers and replayed once per group, on every rung (the
        collectives, DDP's reducer, the wires, the bucket hooks and
        remat inside the graph): the counterpart of the JAX engine's one
        ``lax.scan`` dispatch. On the CPU it is a plain loop of K steps.
        A capture the card refuses raises ``NotImplementedError`` with
        the card's error (train/capture.py); none runs eager steps under
        K > 1. Memoised per K."""
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if k in self._multi_step_cache:
            return self._multi_step_cache[k]
        if self.device.type == "cuda":
            if self.net is not self.model and not self._ddp_graphed:
                # DDP built for eager steps: built again for capture. The
                # old wrapper goes first, its reducer's hooks with it.
                import gc
                self.net = self.model
                gc.collect()
                self._make_ddp(graphed=True)
            graphs = capture.GraphCache(
                lambda st, xs, ys: _StepGraph(self, st, xs, ys))

            def run(state, xs, ys):
                fused = graphs.run(state, self._graph_written(state), xs, ys)
                self.graph_stats["replays"] += 1
                self._last_fused = fused
                return (TrainState(state.params, state.opt_state,
                                   state.step + k, state.comp_state),
                        fused[:, 0])
        else:
            def run(state, xs, ys):
                rows = []
                for j in range(k):
                    state, loss, fused = self._step(state, xs[j], ys[j])
                    rows.append(self._bundle(loss, fused))
                fused = torch.stack(rows)
                self._last_fused = fused
                return state, fused[:, 0]
        self._multi_step_cache[k] = run
        return run

    # ---- epoch loop (reference train_model, part1/main.py:52-93) -------

    def train_epoch(self, state: TrainState, batches, epoch: int = 0,
                    log: Callable[[str], None] = print,
                    ckpt_dir: str | None = None, start_iter: int = 0
                    ) -> tuple[TrainState, dict]:
        """``start_iter`` > 0 skips that many leading batches, the
        mid-epoch resume: the skipped batches are still drawn (the
        loader's augmentation draws per (seed, epoch) stay in step) but
        not trained on.

        Up to ``config.dispatch_depth`` steps stay in flight
        (train/pipeline.py); the timed iterations 1-39 wait for their
        step, as the reference's timer does. Depth 0 is forced while
        chaos is active (faults land on exact steps), under elastic
        membership (a survivor carries the previous step's whole state)
        and, in a multi-process run, while an in-loop cadence holds
        collectives (every rank must run it at the same point, on the
        same step's state)."""
        from tpu_ddp_torch.data.prefetch import prefetch_to_device
        from tpu_ddp_torch.resilience.chaos import (FaultInjector,
                                                    chaos_env_active)
        from tpu_ddp_torch.resilience.elastic import (ElasticController,
                                                      MembershipChange)
        from tpu_ddp_torch.resilience.watchdog import heartbeat_from_env
        from tpu_ddp_torch.train.pipeline import DispatchPipeline
        cfg = self.config
        timer = IterationTimer(cfg.timing_first_iter, cfg.timing_last_iter,
                               device=self.device)
        window = _LossWindow(cfg, self.metrics, timer, epoch, log)
        if start_iter:
            batches = itertools.islice(iter(batches), start_iter, None)
        injector = FaultInjector.from_env(rank=self.rank)
        # The membership watch (resilience/elastic.py): checked once per
        # step boundary; a change hands the live state up as a
        # MembershipChange, and parts/common.py reshards and resumes the
        # epoch at its next_iter. The heartbeat file is the worker's, as
        # the launcher watches its live workers by id.
        elastic = ElasticController.from_env()
        heartbeat = heartbeat_from_env(
            self.rank if elastic is None else elastic.worker_id)
        chaos = chaos_env_active()
        on_harvest = self._harvester(window, heartbeat, injector, ckpt_dir,
                                     lambda: state)
        if self.epoch_k(chaos, elastic) > 1:
            return self._train_epoch_multi(state, batches, timer, window,
                                           start_iter, on_harvest)
        use_prefetch = (cfg.device_prefetch > 0
                        and not injector.poisons_batches)
        stream = (prefetch_to_device(batches, self.put_batch,
                                     cfg.device_prefetch)
                  if use_prefetch else batches)
        world = dist.get_world_size() if dist.is_initialized() else 1
        collective_cadence = bool((ckpt_dir and cfg.ckpt_every_iters)
                                  or cfg.check_replicas_every)
        # Under the membership watch the window is synchronous too: the
        # state a survivor carries is the previous step's, whole.
        depth = (0 if chaos or (collective_cadence and world > 1)
                 or elastic is not None else cfg.dispatch_depth)
        pipe = DispatchPipeline(depth)
        for it, item in enumerate(stream, start=start_iter):
            if cfg.max_iters is not None and it >= cfg.max_iters:
                break
            if elastic is not None and elastic.changed():
                # Batch `it` is drawn but not trained on: the resumed
                # epoch starts from it.
                pipe.drain()
                raise MembershipChange(membership=elastic.read(),
                                       state=state, epoch=epoch,
                                       next_iter=it)
            # nan-grad poisons this rank's batch (the guard then skips on
            # every rank); stalled-step and slow-rank sleep here.
            if injector.active and injector.before_step(state.step + 1):
                item = ((FaultInjector.poison_images(item[0]),)
                        + tuple(item[1:]))
            sync_iter = depth == 0 or it <= cfg.timing_last_iter
            prev_state = state
            try:
                timer.start()
                x, y, ready = item if use_prefetch else (*item, None)
                state, handle = self.train_step_async(state, x, y, ready)
                timer.stop(it)
                pipe.submit(handle,
                            lambda h, i=it, s=state.step: on_harvest(
                                i, s, self._materialize_fused(h)),
                            sync=sync_iter)
            except RuntimeError as e:
                # A peer that died mid-collective surfaces here, often
                # before its notice: if the launcher confirms a
                # membership change, this step never happened.
                self._raise_membership_change(e, elastic, prev_state,
                                              epoch, it, heartbeat)
                raise
        pipe.drain()
        return state, window.epoch_stats(pipeline=pipe.stats())

    def _raise_membership_change(self, exc, elastic, state, epoch, it,
                                 heartbeat, wait_s: float = 60.0) -> None:
        """A step that failed because a PEER died becomes a
        ``MembershipChange`` carrying ``state`` (the failed step's input:
        the replicated rungs update nothing before their collectives
        complete), once the launcher or the leaving rank confirms the
        change through the protocol directory within ``wait_s`` seconds;
        the heartbeat keeps beating meanwhile. Unconfirmed, it returns
        and the caller raises the original error."""
        if elastic is None:
            return
        import time
        from tpu_ddp_torch.resilience.elastic import MembershipChange
        from tpu_ddp_torch.resilience.watchdog import touch_heartbeat
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline:
            if elastic.changed():
                raise MembershipChange(membership=elastic.read(),
                                       state=state, epoch=epoch,
                                       next_iter=it) from exc
            if heartbeat is not None:
                touch_heartbeat(heartbeat[0], heartbeat[1], state.step)
            time.sleep(0.1)

    def _harvester(self, window, heartbeat, injector, ckpt_dir, current):
        """The per-step consumer of harvested results, in step order.
        Cadences test the harvested step and act on the CURRENT state
        (``current()``), up to the window's depth ahead: safe in one
        process (a checkpoint is stamped with its own step); multi-
        process runs with such a cadence run at depth 0."""
        from tpu_ddp_torch.resilience.watchdog import touch_heartbeat
        cfg = self.config

        def on_harvest(harv_it, harv_step, result):
            local_loss, skipped = result
            window.account(harv_it, local_loss, harv_step)
            if self.guard is not None:
                # Raises after K skips in a row, before the cadence below
                # can checkpoint the diverging run: at most the window's
                # depth after the bad step ran.
                self.guard.record(harv_step, skipped, local_loss)
            if heartbeat is not None:
                touch_heartbeat(heartbeat[0], heartbeat[1], harv_step)
            if (ckpt_dir and cfg.ckpt_every_iters
                    and harv_step % cfg.ckpt_every_iters == 0):
                self.save_checkpoint(ckpt_dir, current())
            if (cfg.check_replicas_every and not self.is_fsdp
                    and harv_step % cfg.check_replicas_every == 0):
                from tpu_ddp_torch.utils.invariants import \
                    check_replica_consistency
                check_replica_consistency(
                    dict(self.model.named_parameters()))
            # hard-exit and corrupt-ckpt fire after the step's save, so a
            # crash-step checkpoint is always on disk (chaos runs at
            # depth 0, so harv_step is the step just taken).
            injector.after_step(harv_step, ckpt_dir)

        return on_harvest

    def epoch_k(self, chaos: bool, elastic) -> int:
        """The steps per dispatch :meth:`train_epoch` runs: the config's
        K, unless something needs per-step host control (in-loop
        cadences, device prefetch, chaos, the membership watch
        ``elastic``; JAX's gate, tpu_ddp/train/engine.py:1425-1435), then
        1."""
        cfg = self.config
        if (cfg.steps_per_dispatch > 1 and not cfg.ckpt_every_iters
                and not cfg.check_replicas_every
                and not cfg.device_prefetch and not chaos
                and elastic is None):
            return cfg.steps_per_dispatch
        return 1

    def _train_epoch_multi(self, state, batches, timer, window, start_iter,
                           on_harvest):
        """The epoch loop with K optimizer steps per dispatch
        (tpu_ddp/train/engine.py:1602-1720). Groups of K same-shape
        batches run through :meth:`build_multi_step`; a group that mixes
        shapes, and the tail shorter than K, take single steps. A group
        that starts before the timing window is not timed (it holds the
        capture); a timed group's time is spread over its K iterations
        (``timer.stop_many``). Up to ``dispatch_depth // K`` groups stay
        in flight, and each group's (K, 2) rows are read in one fetch,
        then go to ``on_harvest`` one step at a time."""
        from tpu_ddp_torch.train.pipeline import DispatchPipeline
        cfg = self.config
        K = cfg.steps_per_dispatch
        multi = self.build_multi_step(K)
        depth_groups = cfg.dispatch_depth // K
        pipe = DispatchPipeline(depth_groups)

        def harvest_group(first_it, last_step, handle):
            rows = self._host_rows(handle).tolist()
            for j, (loss, skipped) in enumerate(rows):
                on_harvest(first_it + j, last_step - K + j + 1,
                           (float(loss), skipped > 0))

        it = start_iter
        buf: list = []

        def flush_singles():
            nonlocal state, it
            for bx, by in buf:
                sync_iter = depth_groups == 0 or it <= timer.last_iter
                timer.start()
                state, handle = self.train_step_async(state, bx, by)
                timer.stop(it)
                pipe.submit(handle,
                            lambda h, i=it, s=state.step: on_harvest(
                                i, s, self._materialize_fused(h)),
                            sync=sync_iter)
                it += 1
            buf.clear()

        for item in batches:
            if cfg.max_iters is not None and it + len(buf) >= cfg.max_iters:
                break
            buf.append(item)
            if len(buf) < K:
                continue
            if len({(tuple(b[0].shape), tuple(b[1].shape))
                    for b in buf}) == 1:
                timed = it >= timer.first_iter
                sync_group = depth_groups == 0 or it <= timer.last_iter
                if timed:
                    timer.start()
                state, _ = multi(state, *self.put_batches(
                    [b[0] for b in buf], [b[1] for b in buf]))
                handle = self._handle(self._last_fused)
                if timed:
                    timer.stop_many(it, K)
                pipe.submit(handle,
                            lambda h, i=it, s=state.step: harvest_group(
                                i, s, h),
                            sync=sync_group)
                it += K
                buf.clear()
            else:
                flush_singles()  # non-uniform group: single steps
        flush_singles()  # the tail shorter than K
        pipe.drain()
        return state, window.epoch_stats(pipeline=pipe.stats())

    # ---- eval (reference test_model, part1/main.py:96-111) -------------

    @torch.no_grad()
    def evaluate(self, state: TrainState, batches,
                 log: Callable[[str], None] = print,
                 sharded: bool = False) -> dict:
        """Full test-set pass. By default unsharded: every node evaluates
        the whole set (part2/part2b/main.py:89-93), and the loss is the
        mean of the batch means (part1/main.py:108). ``sharded=True``
        (a syncing rung's group) splits the set over the group: each rank
        evaluates its own batches, and the weighted loss and correct sums
        and the weight total are summed with one ``all_reduce`` per
        batch. A multi-process run needs the process-sharded loader's
        (images, labels, weights) triples
        (``create_data_loaders(shard_eval=True)``); wrap-padding rows
        carry weight 0, and an unsharded pass drops them. BN takes its
        statistics over the rank's batch, as under the JAX mesh. At
        ``dispatch_depth`` > 0 the per-batch reads wait behind a window
        of ``max(8, 4 * depth)`` batches (the JAX engine's lazy fetch).
        Under FSDP the shards are gathered once (a collective every rank
        enters)."""
        del state  # the parameters live in the model (FSDP: the shards)
        from tpu_ddp_torch.ops.loss import softmax_cross_entropy
        full = (self.zero3.gather(self._flat.detach()) if self.is_fsdp
                else None)
        use_sharded = sharded and self._group is not None
        world = dist.get_world_size() if dist.is_initialized() else 1
        total_loss, correct, seen, n_batches = 0.0, 0, 0, 0
        depth = self.config.dispatch_depth
        pending: list = []
        max_pending = max(8, 4 * depth)

        def resolve(rec):
            nonlocal total_loss, correct, seen, n_batches
            if rec[0] == "sharded":
                loss_sum, corr, n = rec[1].tolist()
                total_loss += loss_sum / max(n, 1.0)
                correct += int(round(corr))
                seen += int(round(n))
            else:
                _, loss, corr, n = rec
                total_loss += float(loss)
                correct += int(corr)
                seen += n
            n_batches += 1

        def push(rec):
            if depth == 0:
                resolve(rec)
                return
            pending.append(rec)
            if len(pending) > max_pending:
                resolve(pending.pop(0))

        for batch in batches:
            images, labels = batch[0], batch[1]
            weights = batch[2] if len(batch) > 2 else None
            if weights is not None and not use_sharded:
                keep = weights > 0
                images, labels, weights = images[keep], labels[keep], None
                if len(labels) == 0:
                    continue
            if use_sharded and weights is None and world > 1:
                raise ValueError(
                    "evaluate(sharded=True) in a multi-process run needs "
                    "a process-sharded eval loader (weight triples): "
                    "create_data_loaders(shard_eval=True). The replicated"
                    " loader would be counted once per rank.")
            x = images.to(self.device, non_blocking=True)
            y = labels.to(self.device, non_blocking=True)
            logits = (self.model(x) if full is None
                      else self._forward(x, full))
            if use_sharded:
                w = (torch.ones(y.shape, dtype=torch.float32)
                     if weights is None else weights.float()
                     ).to(self.device)
                sums = torch.stack([
                    (w * softmax_cross_entropy(logits, y)).sum(),
                    (w * (logits.argmax(-1) == y)).sum(), w.sum()])
                dist.all_reduce(sums, group=self._group)
                push(("sharded", sums))
            else:
                push(("repl", cross_entropy_loss(logits, y),
                      top1_correct(logits, y), int(y.shape[0])))
        for rec in pending:
            resolve(rec)
        avg_loss = total_loss / max(n_batches, 1)
        accuracy = correct / max(seen, 1)
        log(f"Test set: average loss {avg_loss:.4f}, "
            f"accuracy {correct}/{seen} ({100.0 * accuracy:.2f}%)")
        self.metrics.log("eval", test_loss=round(avg_loss, 5),
                         test_accuracy=round(accuracy, 5), seen=seen)
        return {"test_loss": avg_loss, "test_accuracy": accuracy,
                "correct": correct, "seen": seen}


class _StepGraph(capture.GraphGroup):
    """K train steps of ``trainer`` as one CUDA graph
    (train/capture.py:GraphGroup) on the trainer's capture stream,
    writing the (K, 2) ``[loss, skipped]`` rows into ``out``. One eager
    warm-up step runs first and is undone; under
    ``DistributedDataParallel`` as many as take its reducer past
    iteration 10, the last on which it samples runtime statistics (a
    sampling iteration syncs on the previous one's events)."""

    def __init__(self, trainer, state, xs, ys):
        def step(st, x, y):
            st, loss, fused = trainer._step(st, x, y)
            return st, trainer._bundle(loss, fused)

        warmup = 1
        if trainer.net is not trainer.model:
            warmup = max(1, 11 - trainer._ddp_iters)
        super().__init__(step, state, xs, ys, device=trainer.device,
                         stream=trainer._capture_stream(),
                         written_=trainer._graph_written(state),
                         warmup=warmup)
        trainer.graph_stats["captures"] += 1
        trainer.graph_stats["warmup_steps"] += warmup
        trainer.graph_stats["capture_ms"].append(self.capture_ms)
