"""Timed autotuning trials: one knob assignment -> one steps/sec number
(tpu_ddp/tune/runner.py on the port's ``Trainer``).

A trial runs ``Trainer.train_epoch`` over a fixed set of synthetic host
batches, made as the port's loader hands them over (data/loader.py:
float32 images normalised on the host, an NCHW view of NHWC memory,
int64 labels), with the candidate knobs applied, using the shared
warm-then-median loop from ``utils/timing.py``: a warm epoch first
(kernel builds, cuDNN's choices, the K-step graph's capture), then
back-to-back timed epochs. Short windows (``fidelity="short"``) feed
the search's pruning passes; long windows confirm finalists
(``tune/search.py``).

A trial that fails for a reason that is a property of its cell — the
card runs out of memory, the step guard gives up on a diverging run,
the warm epoch blows the wall-clock budget — marks that cell
infeasible and the search goes on; the reason is recorded in the trial
history (and the cell is never measured again: the search memoizes).
Anything else propagates: a kernel that does not build or launch, or a
capture the card refuses, is a fault of the program, and quarantining
it would quietly make the other value of its knob the "winner".

Trial mechanics that keep measurements honest:

- the trial config is a ``copy.copy`` of the workload config with
  ``autotune="off"`` (no recursion), the reference timing window
  disabled (``timing_first_iter=1, timing_last_iter=0``: the window
  waits for every timed step, which would mask ``dispatch_depth``),
  and ``guard_max_bad_steps`` effectively infinite (random-label
  synthetic data at the preset lr can trip the divergence guard; a
  trial measures throughput, not convergence);
- trainers are cached per value of every field a ``Trainer`` or its
  model reads at construction (the model's dtype, kernels and memory
  policy, the gradient wire, the overlap bucket plan and its hooks);
  only the loop fields (dispatch depth, K per dispatch, prefetch) are
  changed on a cached trainer's config, so trials price dispatch
  discipline, not construction. (The JAX runner keys its cache on the
  compiled step's fields alone, so there a ``remat`` or ``bucket_mb``
  cell reuses a trainer built for another value.)
"""

from __future__ import annotations

import copy
import os
import time

import numpy as np
import torch

from tpu_ddp_torch.resilience.guard import TrainingDivergedError
from tpu_ddp_torch.tune.space import KNOBS, Workload, _world, violations
from tpu_ddp_torch.utils.timing import warm_then_median_s

__all__ = ["TrialRunner", "BUILD_FIELDS", "LOOP_FIELDS"]

# Host-loop properties, changed on a cached trainer's config.
LOOP_FIELDS = ("dispatch_depth", "steps_per_dispatch", "device_prefetch")
# Every other training knob is read when a Trainer and its model are
# built (get_model, apply_policy, the wire, the bucket plan): a new value
# needs a new trainer.
BUILD_FIELDS = tuple(k.field for k in KNOBS if k.objective == "step_time"
                     and k.field not in LOOP_FIELDS)
# The failures that are a property of the cell (see module docstring).
# TrainingDivergedError subclasses RuntimeError, which is not caught.
CELL_FAILURES = (torch.cuda.OutOfMemoryError, TrainingDivergedError,
                 TimeoutError)


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    return int(raw) if raw else default


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    return float(raw) if raw else default


def host_batches(cfg, n_batches: int, world: int = 1) -> list:
    """``n_batches`` host batches of this process (4 distinct ones,
    repeated), drawn from ``np.random.default_rng(0)`` as the JAX runner
    draws them and normalised as the loader does."""
    from tpu_ddp_torch.data.cifar10 import normalize
    if cfg.dataset == "imagenet":
        from tpu_ddp_torch.data.imagenet import (IMAGENET_MEAN as mean,
                                                 IMAGENET_STD as std)
    else:
        from tpu_ddp_torch.data.cifar10 import (CIFAR10_MEAN as mean,
                                                CIFAR10_STD as std)
    batch = cfg.per_node_batch_size(world)
    rng = np.random.default_rng(0)
    side = cfg.image_size
    n_distinct = min(4, n_batches)
    distinct = []
    for _ in range(n_distinct):
        u8 = rng.integers(0, 256, size=(batch, side, side,
                                        cfg.in_channels)).astype(np.uint8)
        y = rng.integers(0, cfg.num_classes, size=batch).astype(np.int32)
        x = torch.from_numpy(np.ascontiguousarray(normalize(u8, mean, std)))
        distinct.append((x.permute(0, 3, 1, 2),
                         torch.from_numpy(y.astype(np.int64))))
    reps = -(-n_batches // n_distinct)
    return (distinct * reps)[:n_batches]


class TrialRunner:
    """Measures knob assignments for one workload.

    ``evaluate(assignment, fidelity)`` returns ``(steps_per_sec, None)``
    for a successful trial or ``(None, reason)`` for an infeasible /
    quarantined cell. The runner owns the synthetic batches, the
    per-build-key trainer cache, the trial counter, and the budget knobs
    (``TPU_DDP_TUNE_ITERS`` batches per epoch, ``TPU_DDP_TUNE_TIMEOUT_S``
    per-trial wall ceiling, ``TPU_DDP_TUNE_MAX_TRIALS``,
    ``TPU_DDP_TUNE_WINDOWS`` long-fidelity windows). ``device``: the
    trainers' device (the card when None); the trainers sync over the
    default process group, which every rung but ``none`` needs.
    """

    def __init__(self, cfg, ctx: Workload, *, strategy: str = "fused",
                 device=None, n_batches: int | None = None,
                 timeout_s: float | None = None,
                 max_trials: int | None = None, log=None):
        self.ctx = ctx
        self.strategy = strategy
        self.device = device
        self.log = log or (lambda s: None)
        # steps_per_dispatch=8 needs >= 8 uniform batches per epoch to
        # engage the grouped path at all; 16 gives it two dispatches.
        self.n_batches = n_batches or _env_int("TPU_DDP_TUNE_ITERS", 16)
        self.timeout_s = (timeout_s if timeout_s is not None
                          else _env_float("TPU_DDP_TUNE_TIMEOUT_S", 60.0))
        self.max_trials = (max_trials if max_trials is not None
                           else _env_int("TPU_DDP_TUNE_MAX_TRIALS", 64))
        self.long_windows = _env_int("TPU_DDP_TUNE_WINDOWS", 3)
        self.trials = 0
        self.quarantined: list[dict] = []
        # (build key, effective K) pairs whose trainer has run that
        # epoch path: their trials skip the warm epoch. dispatch_depth
        # and device_prefetch are host-loop properties, so the warm-up
        # surface is exactly (trainer, K): each K > 1 is its own graph.
        self._warmed: set = set()

        # The trial base config: workload config minus everything that
        # would make a trial lie (see module docstring). copy.copy, not
        # dataclasses.replace — replace() re-runs __post_init__, which
        # re-applies env overrides on top of trial values.
        base = copy.copy(cfg)
        base.autotune = "off"
        base.timing_first_iter, base.timing_last_iter = 1, 0
        base.guard_max_bad_steps = 10**9
        base.max_iters = None
        base.log_every = 10**9
        self.base_cfg = base
        self.host_batches = host_batches(cfg, self.n_batches, _world())
        self._trainers: dict = {}

    # -- trainer cache ------------------------------------------------

    def build_key(self, assignment: dict) -> tuple:
        return tuple(assignment.get(f, getattr(self.base_cfg, f))
                     for f in BUILD_FIELDS)

    def trainer_for(self, assignment: dict) -> tuple:
        """``(trainer, state)`` built for ``assignment``'s build fields
        (cached), its model from ``get_model`` as run_part builds it."""
        key = self.build_key(assignment)
        hit = self._trainers.get(key)
        if hit is not None:
            return hit

        from tpu_ddp_torch.models import get_model
        from tpu_ddp_torch.train.engine import Trainer

        cfg = copy.copy(self.base_cfg)
        for f, v in assignment.items():
            setattr(cfg, f, v)
        model = get_model(cfg.model, num_classes=cfg.num_classes,
                          in_channels=cfg.in_channels,
                          use_pallas_bn=cfg.pallas_bn,
                          compute_dtype=getattr(torch, cfg.compute_dtype),
                          remat=cfg.remat, act_dtype=cfg.act_dtype)
        trainer = Trainer(model, cfg, strategy=self.strategy,
                          device=self.device)
        state = trainer.init_state()
        self._trainers[key] = (trainer, state)
        return self._trainers[key]

    # -- trials -------------------------------------------------------

    def evaluate(self, assignment: dict,
                 fidelity: str = "short") -> tuple[float | None, str | None]:
        """Measure ``assignment`` (field -> value, the base config's
        values implied for absent fields); ``fidelity`` picks the window
        count (short=1 prunes, long=``TPU_DDP_TUNE_WINDOWS`` confirms
        with a median)."""
        from tpu_ddp_torch.resilience.chaos import chaos_env_active
        from tpu_ddp_torch.resilience.elastic import ElasticController

        bad = violations({**{f: getattr(self.base_cfg, f)
                             for f in BUILD_FIELDS + LOOP_FIELDS},
                          **assignment}, self.ctx)
        if bad:
            return None, "constraint: " + "; ".join(bad)
        if self.trials >= self.max_trials:
            return None, f"budget: max_trials={self.max_trials} reached"

        self.trials += 1
        windows = self.long_windows if fidelity == "long" else 1
        t_start = time.perf_counter()
        try:
            trainer, state = self.trainer_for(assignment)
            cfg = trainer.config
            saved = {f: getattr(cfg, f) for f in LOOP_FIELDS}
            try:
                for f in LOOP_FIELDS:
                    setattr(cfg, f, assignment.get(f, saved[f]))

                def epoch():
                    nonlocal state
                    state, _ = trainer.train_epoch(
                        state, list(self.host_batches), epoch=0,
                        log=lambda s: None)
                    return None  # train_epoch already syncs its tail

                # Warm only when this cell takes an epoch path no earlier
                # trial of its trainer took: the grouped path's K (one
                # CUDA graph per K on the card) or the per-step path.
                k = trainer.epoch_k(chaos_env_active(),
                                    ElasticController.from_env())
                warm_key = (self.build_key(assignment), k)
                if warm_key not in self._warmed:
                    epoch()
                    self._warmed.add(warm_key)
                    if time.perf_counter() - t_start > self.timeout_s:
                        raise TimeoutError(
                            f"warm epoch blew the {self.timeout_s}s "
                            "trial budget")
                epoch_s, samples = warm_then_median_s(
                    epoch, iters=1, windows=windows, warmup=0,
                    sync=lambda _: None)
            finally:
                for f, v in saved.items():
                    setattr(cfg, f, v)
                # Trials share state across cells on purpose (random
                # labels; throughput only): write the advanced state back
                # so the cache never rewinds to step 0, and a K-step
                # graph keeps the state tensors it was captured on.
                self._trainers[self.build_key(assignment)] = (trainer,
                                                              state)
        except CELL_FAILURES as e:
            reason = f"quarantined: {type(e).__name__}: {e}"
            self.quarantined.append({"assignment": dict(assignment),
                                     "reason": reason})
            self.log(f"[autotune] trial quarantined "
                     f"({dict(assignment)}): {type(e).__name__}: {e}")
            return None, reason

        sps = self.n_batches / epoch_s
        self.log(f"[autotune] trial {self.trials}: {dict(assignment)} "
                 f"-> {sps:.2f} steps/s ({fidelity}, "
                 f"windows={[round(s, 4) for s in samples]})")
        return sps, None
