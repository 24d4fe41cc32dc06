"""Step guard (tpu_ddp/resilience/guard.py): skip non-finite updates,
raise after K in a row.

One NaN or Inf batch would otherwise poison the parameters for good. The
guard makes the step protect itself:

- **On the device** (:func:`nonfinite_flag`): a 0-d f32 flag from the
  local loss and the f32 sum of squared gradients (an overflowing but
  finite gradient squares to inf and is caught too), OR-reduced over the
  process group with one scalar ``all_reduce`` so every rank skips or
  none does. The update reads it on the device (``ops/sgd.py``'s
  ``skip``): a flagged step leaves params and momentum exactly as they
  were, and nothing waits on the host.
- **On the host** (:class:`StepGuard`): reads each step's flag together
  with its loss (one transfer), counts consecutive skips, logs a
  ``step_skipped`` event and raises :class:`TrainingDivergedError` after
  K in a row: the run is diverging, not glitching, and the launcher
  restarts it from the last checkpoint.
"""

from __future__ import annotations

import torch


class TrainingDivergedError(RuntimeError):
    """K consecutive steps produced a non-finite loss or gradient.
    Raised by :class:`StepGuard` out of ``Trainer.train_epoch``; the
    process exits nonzero and the launcher restarts from the last
    verified checkpoint."""


def nonfinite_flag(loss, grads, process_group=None,
                   extra_bad=None) -> torch.Tensor:
    """A 0-d f32 tensor on the loss's device, nonzero iff this step's
    update must be skipped: the loss or the f32 sum of squared ``grads``
    is not finite. With ``process_group`` the flag is summed over the
    group (one scalar ``all_reduce``), so every rank takes the same
    branch; without it the decision is local (one process, or the
    ``none`` rung, whose contract is no communication between replicas).
    Under ZeRO, FSDP and the sharded update ``grads`` are this rank's
    slices, so the sum catches a NaN on any rank's slice. ``extra_bad``:
    a local count of non-finite entries seen upstream of ``grads`` (the
    overlapped int8 wire counts the raw gradients, since a NaN can
    vanish in the int8 cast; parallel/overlap.py).
    Stays on the device: a few launches whatever the number of leaves."""
    norms = torch._foreach_norm([g.float() if g.dtype != torch.float32
                                 else g for g in grads])
    gnorm = torch.linalg.vector_norm(torch.stack(norms))
    terms = torch.stack([loss.detach().float().reshape(()), gnorm])
    flag = torch.isfinite(terms).all().logical_not().float()
    if extra_bad is not None:
        flag = torch.maximum(flag, (extra_bad > 0).float())
    if process_group is not None:
        import torch.distributed as dist
        dist.all_reduce(flag, op=dist.ReduceOp.SUM, group=process_group)
    return flag


def select_update(bad, old, new) -> list:
    """Leaf by leaf ``where(bad, old, new)``: the old state when ``bad``
    is nonzero. With ``bad`` zero this is exactly ``new``, so a healthy
    step stays bit-identical to an unguarded one."""
    keep = bad != 0
    return [torch.where(keep, o, n) for o, n in zip(old, new)]


class StepGuard:
    """Host-side skip accounting for one training run.

    ``record`` is called once per step with that step's ``skipped`` flag
    (read with its loss in one transfer). ``max_bad_steps`` consecutive
    skips raise :class:`TrainingDivergedError`; a clean step resets the
    streak, and so does a step below the last recorded one (a new run on
    a reused trainer, or a rollback to an earlier checkpoint).
    """

    def __init__(self, max_bad_steps: int = 3, metrics=None, log=print):
        if max_bad_steps < 1:
            raise ValueError(
                f"max_bad_steps must be >= 1, got {max_bad_steps}")
        self.max_bad_steps = max_bad_steps
        self.metrics = metrics
        self.log = log
        self.consecutive = 0
        self.total_skipped = 0
        self.last_step: int | None = None

    def record(self, step: int, skipped: bool, loss: float) -> None:
        if self.last_step is not None and step < self.last_step:
            self.consecutive = 0
        self.last_step = step
        if not skipped:
            self.consecutive = 0
            return
        self.consecutive += 1
        self.total_skipped += 1
        self.log(f"[guard] non-finite loss/grads at step {step}: update "
                 f"skipped ({self.consecutive}/{self.max_bad_steps} "
                 f"consecutive)")
        if self.metrics is not None:
            self.metrics.inc("step_skipped")
            self.metrics.log("step_skipped", step=step, loss=loss,
                             consecutive=self.consecutive)
        if self.consecutive >= self.max_bad_steps:
            raise TrainingDivergedError(
                f"{self.consecutive} consecutive non-finite steps "
                f"(last: step {step}, loss {loss}); training has "
                f"diverged - roll back to the last checkpoint")
