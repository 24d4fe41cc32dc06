"""Resilience (tpu_ddp/resilience): the failure handling the reference
lacks (a dead gloo rank hangs its cluster; one bad batch poisons the
parameters).

- :mod:`.guard`: a non-finite step's update is skipped on the device, and
  K in a row raise :class:`TrainingDivergedError`.
- :mod:`.integrity`: per-leaf sha256 digests in every checkpoint
  manifest, verified on restore; a corrupt checkpoint is quarantined to
  ``step_N.corrupt`` and the previous one restored.
- :mod:`.watchdog`: per-rank heartbeat files; the launcher kills and
  restarts a cluster whose heartbeats stall.
- :mod:`.chaos`: seeded fault injection, one drill per recovery path.
- :mod:`.elastic`: membership epochs; survivors of a lost rank reshard
  their live state onto the new world instead of restarting from a
  checkpoint, and a returning rank joins from the survivors' beacon.
"""

from tpu_ddp_torch.resilience.chaos import (  # noqa: F401
    FAULT_EXIT_CODE, FAULT_KINDS, SERVE_FAULT_KINDS, FaultInjector,
    FaultSpec, maybe_inject_failure)
from tpu_ddp_torch.resilience.guard import (  # noqa: F401
    StepGuard, TrainingDivergedError)
from tpu_ddp_torch.resilience.integrity import (  # noqa: F401
    CheckpointCorruptError, leaf_digest, quarantine_checkpoint,
    verify_checkpoint)
from tpu_ddp_torch.resilience.watchdog import (  # noqa: F401
    HEARTBEAT_ENV, HeartbeatMonitor, heartbeat_path, touch_heartbeat)
