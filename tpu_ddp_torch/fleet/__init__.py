"""The serving fleet (tpu_ddp/fleet/): prefill/decode disaggregation over
an explicit KV edge (disagg.py), the refcounted prefix cache with
per-tenant namespaces and the cross-replica prefix directory (prefix.py),
the multi-replica Router (router.py), replica health, deterministic
migration and the serving chaos hooks (resilience.py), and the
autoscaling replica lifecycle (autoscale.py). Weight publishing to a
fleet is ROADMAP Queue 1 item 11b."""

from tpu_ddp_torch.fleet.autoscale import Autoscaler
from tpu_ddp_torch.fleet.disagg import DisaggEngine, KVEdge, KVTransfer
from tpu_ddp_torch.fleet.prefix import PrefixDirectory, PrefixHit, PrefixIndex
from tpu_ddp_torch.fleet.resilience import (
    ReplicaCrashError,
    ReplicaHealth,
    ServeFaultInjector,
    continuation_of,
)
from tpu_ddp_torch.fleet.router import POLICIES, Router

__all__ = [
    "Autoscaler",
    "DisaggEngine",
    "KVEdge",
    "KVTransfer",
    "PrefixDirectory",
    "PrefixHit",
    "PrefixIndex",
    "POLICIES",
    "ReplicaCrashError",
    "ReplicaHealth",
    "Router",
    "ServeFaultInjector",
    "continuation_of",
]
