"""Deterministic chaos injection (tpu_ddp/resilience/chaos.py): every
recovery path gets a drill.

========================  =============================================
fault kind                recovery path it drills
========================  =============================================
``hard-exit``             launcher restart + checkpoint resume
``nan-grad``              step guard (update skipped on all ranks)
``stalled-step``          heartbeat watchdog kill + launcher restart
``corrupt-ckpt``          digest verification + quarantine + fallback
``slow-rank``             straggler tolerance (run completes, slower)
``host-loss``             elastic membership: survivors reshard live
``host-join``             elastic membership: shrink, then regrow from
                          the survivors' state beacon
========================  =============================================

``host-loss`` and ``host-join`` die like a preempted host: when the
elastic protocol is armed they write their departure notice
(resilience/elastic.py) first, then exit with 15 (gone for good) or 16
(coming back), which tell the elastic launcher what to do. The serving
kinds (``SERVE_FAULT_KINDS``) run through
``tpu_ddp_torch.fleet.resilience.ServeFaultInjector``; the trainer's hooks
ignore them, as the serving hooks ignore the training kinds, so one spec
string can drill a whole train and serve stack. The JAX package's
remaining kinds parse with the same grammar, but an injector configured
with one raises ``NotImplementedError`` naming its ROADMAP item:
``group-loss`` (DiLoCo, 11c), ``publisher-death`` and ``push-stall``
(weight publishing, 11b).

Faults are configured by env, so they reach launcher-spawned workers
unchanged (the same variables as the JAX package):

- ``TPU_DDP_CHAOS_FAULTS``: comma-separated specs, each ``kind@step``
  (fire at that global step) or ``kind@p<float>`` (fire each step with
  that probability), with an optional ``:rank=R`` (default rank 0).
  Example: ``nan-grad@3:rank=1,hard-exit@5``.
- ``TPU_DDP_CHAOS_SEED``: seed of the probabilistic mode; the fire or
  no-fire decision is a pure function of (seed, kind, step), the same
  one as the JAX package's, so a replayed run injects the same faults.
- ``TPU_DDP_CHAOS_SENTINEL``: a directory; each one-shot fault drops a
  marker file there before it fires, so a restarted run does not fire it
  again (``slow-rank`` is persistent and never marks).
- ``TPU_DDP_CHAOS_STALL_S`` / ``TPU_DDP_CHAOS_SLOW_S``: sleep lengths for
  ``stalled-step`` (3600: only the watchdog ends it) and ``slow-rank``
  (0.25 per step).

``TPU_DDP_FAIL_AT_STEP`` (:func:`maybe_inject_failure`) is the original
single hard-exit knob, kept with its exact semantics.
"""

from __future__ import annotations

import dataclasses
import os
import random
import sys
import time

import numpy as np
import torch

FAULT_EXIT_CODE = 13

FAULT_KINDS = ("hard-exit", "nan-grad", "stalled-step", "corrupt-ckpt",
               "slow-rank", "host-loss", "host-join", "group-loss")
# The serving kinds (fleet/resilience.py): ``rank`` is the replica index
# (the Router stamps it), ``step`` the replica's engine-step counter
# (``edge-drop`` counts edge deliveries, the publish kinds pushes);
# ``flash-crowd`` and ``tenant-storm`` are consumed by the drive loop.
SERVE_FAULT_KINDS = ("replica-crash", "slow-replica", "edge-drop",
                     "nonfinite-logits", "publisher-death", "push-stall",
                     "flash-crowd", "tenant-storm")
# Kinds that parse but that no injector of the port executes yet.
_UNPORTED_KINDS = {
    "group-loss": "item 11 (11c: DiLoCo, train/outer.py)",
    **{k: "item 11 (11b: weight publishing, publish/)"
       for k in ("publisher-death", "push-stall")},
}

CHAOS_ENV = "TPU_DDP_CHAOS_FAULTS"


def process_rank() -> int:
    """This process's rank in the ``torch.distributed`` group (0 without
    one)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One configured fault: fire ``kind`` at ``step`` (exactly; or every
    step >= it for ``slow-rank``) or with probability ``prob`` per step,
    on process ``rank``."""

    kind: str
    step: int | None = None
    prob: float | None = None
    rank: int = 0
    tenant: str | None = None
    group: int | None = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS + SERVE_FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; available: "
                f"{FAULT_KINDS + SERVE_FAULT_KINDS}")
        if (self.step is None) == (self.prob is None):
            raise ValueError(
                f"fault {self.kind!r} needs exactly one of step/prob")
        if self.prob is not None and not 0.0 < self.prob <= 1.0:
            raise ValueError(f"fault probability must be in (0, 1], "
                             f"got {self.prob}")
        if self.kind == "tenant-storm":
            if not self.tenant:
                raise ValueError(
                    "tenant-storm needs :tenant=NAME (a storm without "
                    "a storming tenant drills nothing)")
        elif self.tenant is not None:
            raise ValueError(f"fault {self.kind!r} does not take tenant= "
                             "(only tenant-storm)")
        if self.group is not None:
            if self.kind != "group-loss":
                raise ValueError(f"fault {self.kind!r} does not take "
                                 "group= (only group-loss)")
            if self.group < 0:
                raise ValueError(f"group= must be >= 0, got {self.group}")

    @property
    def key(self) -> str:
        """Stable sentinel-file name for this spec."""
        trig = f"p{self.prob}" if self.step is None else str(self.step)
        suffix = f".tenant{self.tenant}" if self.tenant else ""
        if self.group is not None:
            suffix += f".group{self.group}"
        return f"{self.kind}@{trig}.rank{self.rank}{suffix}"


def parse_faults(spec: str) -> list[FaultSpec]:
    """Parse a ``TPU_DDP_CHAOS_FAULTS`` value. Raises ValueError naming
    the entry on any malformed spec (a typo must not fake coverage)."""
    out = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        head, _, tail = entry.partition(":")
        kind, at, trigger = head.partition("@")
        if not at:
            raise ValueError(f"bad fault spec {entry!r}: expected "
                             f"kind@step or kind@p<prob>")
        rank, tenant, group = 0, None, None
        try:
            if tail:
                if tail.startswith("rank="):
                    rank = int(tail[len("rank="):])
                elif tail.startswith("tenant="):
                    tenant = tail[len("tenant="):]
                elif tail.startswith("group="):
                    group = int(tail[len("group="):])
                else:
                    raise ValueError(f"unknown option {tail!r} "
                                     "(rank=R, tenant=NAME or group=G)")
            if trigger.startswith("p"):
                out.append(FaultSpec(kind, prob=float(trigger[1:]),
                                     rank=rank, tenant=tenant, group=group))
            else:
                out.append(FaultSpec(kind, step=int(trigger), rank=rank,
                                     tenant=tenant, group=group))
        except ValueError as e:
            raise ValueError(f"bad fault spec {entry!r}: {e}") from None
    return out


def chaos_env_active() -> bool:
    """True when any fault-injection env knob is set."""
    return bool(os.environ.get(CHAOS_ENV)
                or os.environ.get("TPU_DDP_FAIL_AT_STEP"))


class FaultInjector:
    """Executes configured faults at their steps, on their rank.

    The trainer calls :meth:`before_step` with the global step the next
    update will produce (poisoning and delays land before the step) and
    :meth:`after_step` with the completed step (crashes and checkpoint
    corruption fire after the step's save, so a crash-step checkpoint is
    always on disk).
    """

    def __init__(self, specs, seed: int = 0,
                 sentinel_dir: str | None = None,
                 stall_s: float = 3600.0, slow_s: float = 0.25,
                 rank: int | None = None):
        self.specs = list(specs)
        for spec in self.specs:
            if spec.kind in _UNPORTED_KINDS:
                raise NotImplementedError(
                    f"fault kind {spec.kind!r} is not ported to "
                    f"tpu_ddp_torch yet (ROADMAP Queue 1 "
                    f"{_UNPORTED_KINDS[spec.kind]})")
        self.seed = seed
        self.sentinel_dir = sentinel_dir
        self.stall_s = stall_s
        self.slow_s = slow_s
        self._rank = rank

    @classmethod
    def from_env(cls, rank: int | None = None) -> "FaultInjector":
        return cls(
            parse_faults(os.environ.get(CHAOS_ENV, "")),
            seed=int(os.environ.get("TPU_DDP_CHAOS_SEED", "0")),
            sentinel_dir=os.environ.get("TPU_DDP_CHAOS_SENTINEL"),
            stall_s=float(os.environ.get("TPU_DDP_CHAOS_STALL_S", "3600")),
            slow_s=float(os.environ.get("TPU_DDP_CHAOS_SLOW_S", "0.25")),
            rank=rank,
        )

    @property
    def active(self) -> bool:
        return bool(self.specs)

    @property
    def poisons_batches(self) -> bool:
        """True iff a configured fault changes a batch on the host before
        its copy to the device (``nan-grad``): only such faults turn
        device prefetch off; the passive kinds compose with it."""
        return any(s.kind == "nan-grad" for s in self.specs)

    # ---- firing logic --------------------------------------------------

    def rank(self) -> int:
        return self._rank if self._rank is not None else process_rank()

    def _sentinel_blocks(self, spec: FaultSpec) -> bool:
        if not self.sentinel_dir:
            return False
        return os.path.exists(os.path.join(self.sentinel_dir, spec.key))

    def _mark_sentinel(self, spec: FaultSpec, step: int) -> None:
        if not self.sentinel_dir:
            return
        os.makedirs(self.sentinel_dir, exist_ok=True)
        with open(os.path.join(self.sentinel_dir, spec.key), "w") as f:
            f.write(f"fired at step {step}\n")

    def _fires(self, spec: FaultSpec, step: int) -> bool:
        if spec.rank != self.rank():
            return False
        if spec.step is not None:
            if spec.kind == "slow-rank":
                return step >= spec.step  # persistent straggler
            if step != spec.step:
                return False
        else:
            # Seeded per-(kind, step) Bernoulli: replayable chaos. A
            # string seed hashes with sha512, stable across processes.
            rng = random.Random(f"{self.seed}:{spec.kind}:{step}")
            if rng.random() >= spec.prob:
                return False
        if spec.kind != "slow-rank" and self._sentinel_blocks(spec):
            return False
        return True

    def _announce(self, spec: FaultSpec, step: int) -> None:
        print(f"[chaos] rank {self.rank()}: injecting {spec.kind} at "
              f"step {step}", flush=True)

    # ---- trainer hooks -------------------------------------------------

    def before_step(self, step: int) -> bool:
        """Pre-step faults for the step that will produce global ``step``.
        Returns True iff the batch must be poisoned (``nan-grad``)."""
        poison = False
        for spec in self.specs:
            if not self._fires(spec, step):
                continue
            if spec.kind == "nan-grad":
                self._announce(spec, step)
                self._mark_sentinel(spec, step)
                poison = True
            elif spec.kind == "slow-rank":
                time.sleep(self.slow_s)
            elif spec.kind == "stalled-step":
                self._announce(spec, step)
                # Mark before sleeping: the watchdog kills us mid-sleep,
                # and the restarted run must not stall again.
                self._mark_sentinel(spec, step)
                time.sleep(self.stall_s)
        return poison

    def after_step(self, step: int, ckpt_dir: str | None = None) -> None:
        """Post-step faults for completed global ``step``. Corruption runs
        before a hard exit, so a combined drill leaves the corrupt
        checkpoint as the newest one."""
        for spec in self.specs:
            if spec.kind == "corrupt-ckpt" and self._fires(spec, step):
                self._announce(spec, step)
                self._mark_sentinel(spec, step)
                corrupt_latest_checkpoint(ckpt_dir)
        for spec in self.specs:
            if spec.kind == "hard-exit" and self._fires(spec, step):
                self._announce(spec, step)
                self._mark_sentinel(spec, step)
                os._exit(FAULT_EXIT_CODE)
        for spec in self.specs:
            if spec.kind in ("host-loss", "host-join") \
                    and self._fires(spec, step):
                self._announce(spec, step)
                self._mark_sentinel(spec, step)
                self._graceful_preemption(spec)
        maybe_inject_failure(step)

    def _graceful_preemption(self, spec: FaultSpec) -> None:
        """Die like a preempted host: the departure notice first (when the
        elastic protocol is armed), then an exit whose code tells the
        launcher whether this host comes back."""
        from tpu_ddp_torch.resilience import elastic
        if elastic.elastic_env_active():
            elastic.announce_departure(
                os.environ[elastic.ELASTIC_DIR_ENV],
                int(os.environ.get(elastic.ELASTIC_RANK_ENV, "0")),
                reason=spec.kind)
        sys.stdout.flush()
        os._exit(elastic.HOST_LOSS_EXIT if spec.kind == "host-loss"
                 else elastic.HOST_JOIN_EXIT)

    @staticmethod
    def poison_images(images):
        """A batch certain to give non-finite gradients: NaN-filled floats
        (an integer batch is converted first). Takes and returns a tensor
        or a numpy array."""
        if isinstance(images, torch.Tensor):
            if not images.is_floating_point():
                images = images.float()
            return torch.full_like(images, float("nan"))
        images = np.asarray(images)
        if not np.issubdtype(images.dtype, np.floating):
            images = images.astype(np.float32)
        return np.full_like(images, np.nan)


def corrupt_latest_checkpoint(ckpt_dir: str | None) -> str | None:
    """Cut the newest checkpoint's ``arrays.npz`` to half its size, the
    on-disk shape of a write cut off by preemption. Returns the path
    (None when there is nothing to corrupt)."""
    if not ckpt_dir:
        return None
    from tpu_ddp_torch.utils.checkpoint import all_steps
    steps = all_steps(ckpt_dir)
    if not steps:
        return None
    npz = os.path.join(ckpt_dir, f"step_{steps[-1]:08d}", "arrays.npz")
    try:
        size = os.path.getsize(npz)
        with open(npz, "r+b") as f:
            f.truncate(max(size // 2, 1))
    except OSError:
        return None
    return npz


def maybe_inject_failure(step: int) -> None:
    """``TPU_DDP_FAIL_AT_STEP=N``: at ``step == N``, print a marker and
    hard-exit with :data:`FAULT_EXIT_CODE` on rank ``TPU_DDP_FAIL_RANK``
    (default 0, the checkpoint writer, which dies only after its step-N
    save). ``TPU_DDP_FAIL_SENTINEL=/path`` makes it once per history: the
    file is created before dying and suppresses any later firing."""
    at = os.environ.get("TPU_DDP_FAIL_AT_STEP")
    if at is None or step != int(at):
        return
    rank = int(os.environ.get("TPU_DDP_FAIL_RANK", "0"))
    if process_rank() != rank:
        return
    sentinel = os.environ.get("TPU_DDP_FAIL_SENTINEL")
    if sentinel:
        if os.path.exists(sentinel):
            return
        with open(sentinel, "w") as f:
            f.write(f"fired at step {step}\n")
    print(f"[fault-injection] killing process {rank} at step {step}",
          flush=True)
    os._exit(FAULT_EXIT_CODE)
