"""Elastic membership (tpu_ddp/resilience/elastic.py): live resharding
instead of a restart from checkpoint.

The restart ladder (``launch_elastic`` and the watchdog) treats a lost
rank as "kill the cluster, replay from the newest verified checkpoint".
This module is the live alternative: on a membership change the
SURVIVING processes keep their training state in memory, tear down the
dead world's process group, meet again as a smaller (or regrown) world,
rebind the trainer to the new group (``Trainer.rebind``) and place the
state for it (``Trainer.state_from_host``). A change costs one
rendezvous and one rebuild of the trainer's group-bound parts.

The group of an epoch
---------------------
Each membership epoch makes a fresh ``torch.distributed`` group at the
record's ``coordinator`` with the record's ``world``, and the old one is
torn down without a barrier a dead peer could block
(parallel/bootstrap.py: ``elastic_bootstrap``, ``elastic_teardown``).

The membership protocol (files under TPU_DDP_ELASTIC_DIR), the JAX
package's byte for byte, so either package's launcher drives either
package's workers
---------------------------------------------------------------------
- ``membership.json``: the launcher's record of the epoch,
  ``{"epoch": N, "world": k, "base_world": n, "assignments": {worker_id:
  new_rank}, "coordinator": "ip:port", "joiners": [...], "dropped":
  [...]}``, written atomically; workers poll it once per step. Survivors
  take the low ranks in worker-id order and joiners the highest, so
  rank 0 (the store's host and the beacon writer) is always a survivor.
- ``departures/<worker_id>``: a departure notice, written by a rank
  that leaves on purpose (chaos ``host-loss``/``host-join``) before it
  exits, and by the launcher for a rank that died without one. It lets
  survivors stop at the next step boundary instead of inside a
  collective that cannot complete.
- ``acks/epoch<N>.rank<worker_id>``: written by each member once it has
  rebound at epoch N; the launcher waits for all of them (a timeout
  falls back to a restart).
- ``beacon_epoch<N>/``: the canonical host state (a checkpoint, the
  sharding plan and ``beacon_meta.json``), written by the new rank 0
  when the epoch admits joiners and read by each joiner as its state.

What still forces a restart (exit 17): state sharded across processes
(ZeRO, FSDP, the sharded update at more than one process) dies with its
host.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Any

from tpu_ddp_torch.parallel.bootstrap import (elastic_bootstrap,
                                              elastic_teardown)

ELASTIC_ENV = "TPU_DDP_ELASTIC_RESHARD"
ELASTIC_DIR_ENV = "TPU_DDP_ELASTIC_DIR"
ELASTIC_RANK_ENV = "TPU_DDP_ELASTIC_RANK"
ELASTIC_JOIN_ENV = "TPU_DDP_ELASTIC_JOIN"

MEMBERSHIP_FILE = "membership.json"
DEPARTURES_DIR = "departures"
ACKS_DIR = "acks"

#: a survivor that cannot carry its live state exits with this: the
#: launcher falls back to a restart from checkpoint.
RESHARD_FALLBACK_EXIT = 17
#: a rank leaving with intent to return (chaos host-join).
HOST_JOIN_EXIT = 16
#: a rank preempted for good (chaos host-loss).
HOST_LOSS_EXIT = 15


def elastic_env_active() -> bool:
    return (os.environ.get(ELASTIC_ENV, "") not in ("", "0", "false")
            and bool(os.environ.get(ELASTIC_DIR_ENV)))


def join_epoch_from_env() -> int | None:
    v = os.environ.get(ELASTIC_JOIN_ENV)
    return int(v) if v else None


def membership_path(directory: str) -> str:
    return os.path.join(directory, MEMBERSHIP_FILE)


def write_membership(directory: str, membership: dict) -> None:
    """Atomic write: a worker's poll never sees a torn file."""
    os.makedirs(directory, exist_ok=True)
    path = membership_path(directory)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(membership, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_membership(directory: str) -> dict | None:
    try:
        with open(membership_path(directory)) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None


def announce_departure(directory: str, worker_id: int,
                       reason: str = "lost") -> None:
    """The departure notice, written by a leaving rank (or by the
    launcher for one that died)."""
    dep = os.path.join(directory, DEPARTURES_DIR)
    os.makedirs(dep, exist_ok=True)
    tmp = os.path.join(dep, f".{worker_id}.tmp")
    with open(tmp, "w") as f:
        f.write(reason)
    os.replace(tmp, os.path.join(dep, str(worker_id)))


def clear_departure(directory: str, worker_id: int) -> None:
    """Launcher side: forget a departure before the worker rejoins, so its
    next departure is news again."""
    try:
        os.remove(os.path.join(directory, DEPARTURES_DIR, str(worker_id)))
    except OSError:
        pass


def reset_control_dir(directory: str) -> None:
    """Launcher side, before (re)spawning a cluster: a stale notice or a
    high-epoch record from an earlier attempt would trigger a phantom
    reshard at step 0."""
    try:
        os.remove(membership_path(directory))
    except OSError:
        pass
    for sub in (DEPARTURES_DIR, ACKS_DIR):
        shutil.rmtree(os.path.join(directory, sub), ignore_errors=True)
    try:
        names = os.listdir(directory)
    except OSError:
        names = []
    for name in names:
        if name.startswith("beacon_epoch"):
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)


def departures(directory: str) -> dict[int, str]:
    dep = os.path.join(directory, DEPARTURES_DIR)
    out: dict[int, str] = {}
    try:
        names = os.listdir(dep)
    except FileNotFoundError:
        return out
    for name in names:
        if name.startswith("."):
            continue
        try:
            with open(os.path.join(dep, name)) as f:
                out[int(name)] = f.read().strip()
        except (ValueError, OSError):
            continue
    return out


def ack_path(directory: str, epoch: int, worker_id: int) -> str:
    return os.path.join(directory, ACKS_DIR, f"epoch{epoch}.rank{worker_id}")


def write_ack(directory: str, epoch: int, worker_id: int) -> None:
    os.makedirs(os.path.join(directory, ACKS_DIR), exist_ok=True)
    with open(ack_path(directory, epoch, worker_id), "w") as f:
        f.write(str(time.time()))


def beacon_dir(directory: str, epoch: int) -> str:
    return os.path.join(directory, f"beacon_epoch{epoch}")


# The group of an epoch (parallel/bootstrap.py), under the JAX module's
# names.
bootstrap = elastic_bootstrap
teardown_world = elastic_teardown


# ---------------------------------------------------------------------------
# Worker side.
# ---------------------------------------------------------------------------


class MembershipChange(Exception):
    """Raised out of the train loop at a step boundary; carries the live
    training state and where the epoch resumes."""

    def __init__(self, membership: dict | None, state: Any, epoch: int,
                 next_iter: int):
        super().__init__(
            f"membership change at epoch={epoch} iter={next_iter}")
        self.membership = membership
        self.state = state
        self.epoch = epoch
        self.next_iter = next_iter


@dataclasses.dataclass
class Resumption:
    """What :func:`apply_membership` hands back to the run loop."""
    state: Any
    rank: int
    world: int
    epoch: int
    next_iter: int


class ElasticController:
    """A worker's membership watch: one ``stat`` and one small
    ``listdir`` per step, nothing else on the step's path."""

    def __init__(self, directory: str, worker_id: int, epoch: int = 0):
        self.directory = directory
        self.worker_id = worker_id
        self.epoch = epoch          # the last epoch this worker acked
        self._known_departed: set[int] = set()

    @classmethod
    def from_env(cls) -> "ElasticController | None":
        if not elastic_env_active():
            return None
        directory = os.environ[ELASTIC_DIR_ENV]
        worker_id = int(os.environ.get(ELASTIC_RANK_ENV, "0"))
        ctl = cls(directory, worker_id)
        m = read_membership(directory)
        if m is not None:
            ctl.epoch = int(m.get("epoch", 0))
            # Departures folded into the current epoch are not news (a
            # controller made after a reshard would trip on them again).
            ctl._known_departed.update(int(w) for w in m.get("dropped", []))
        return ctl

    def changed(self) -> bool:
        """True when the world no longer matches the acked epoch: a newer
        record, or a notice from a member of the current world."""
        m = read_membership(self.directory)
        if m is not None and int(m.get("epoch", 0)) > self.epoch:
            return True
        return any(wid != self.worker_id and wid not in self._known_departed
                   for wid in departures(self.directory))

    def read(self) -> dict | None:
        return read_membership(self.directory)

    def await_membership(self, deadline_s: float = 60.0) -> dict:
        """Block until the launcher publishes an epoch newer than the last
        acked one. A timeout means the launcher is gone or stuck: the
        worker falls back to a restart."""
        t0 = time.monotonic()
        while True:
            m = read_membership(self.directory)
            if m is not None and int(m.get("epoch", 0)) > self.epoch:
                return m
            if time.monotonic() - t0 > deadline_s:
                raise TimeoutError(f"no membership epoch > {self.epoch} "
                                   f"within {deadline_s:.0f}s")
            time.sleep(0.05)


def write_beacon(directory: str, epoch: int, trainer, host: dict,
                 meta: dict) -> str:
    """The joiners' state: ``host`` as a checkpoint at its step, the
    trainer's plan and ``beacon_meta.json`` under ``beacon_epoch<N>/``."""
    from tpu_ddp_torch.utils import checkpoint as ckpt
    bdir = beacon_dir(directory, epoch)
    ckpt.save_checkpoint(bdir, host, step=int(host["step"]))
    trainer.sharding_plan().save(bdir)
    with open(os.path.join(bdir, "beacon_meta.json"), "w") as f:
        json.dump(meta, f)
    return bdir


def apply_membership(trainer, chg: MembershipChange,
                     controller: ElasticController,
                     log=print) -> Resumption | None:
    """The survivor's reshard sequence. Returns None when this worker is
    not in the new world (it should exit cleanly); raises
    ``SystemExit(RESHARD_FALLBACK_EXIT)`` when the live state cannot be
    carried and the launcher must restart from a checkpoint."""
    t0 = time.monotonic()
    # 1. Live state -> canonical host form while the old group exists;
    #    no collective (a peer may be dead).
    try:
        host = trainer.state_to_host(chg.state, local_only=True)
    except RuntimeError as e:
        log(f"[elastic] cannot carry live state ({e}); falling back to "
            "checkpoint restart")
        raise SystemExit(RESHARD_FALLBACK_EXIT)
    # 2. The launcher's word on the new world.
    try:
        m = controller.await_membership()
    except TimeoutError as e:
        log(f"[elastic] {e}; falling back to checkpoint restart")
        raise SystemExit(RESHARD_FALLBACK_EXIT)
    controller._known_departed.update(int(w) for w in m.get("dropped", []))
    # A rejoining worker is a member again: its next departure is news.
    controller._known_departed.difference_update(
        int(w) for w in m.get("joiners", []))
    new_rank = m.get("assignments", {}).get(str(controller.worker_id))
    if new_rank is None:
        log(f"[elastic] worker {controller.worker_id} not in epoch "
            f"{m['epoch']}; leaving cleanly")
        return None
    # 3. The joiners' beacon, by the NEW rank 0, from the host tree.
    if new_rank == 0 and m.get("joiners"):
        write_beacon(controller.directory, int(m["epoch"]), trainer, host,
                     {"epoch": chg.epoch, "next_iter": chg.next_iter})
    # 4. Meet as the new world and rebind every group-bound part.
    teardown_world()
    bootstrap(m["coordinator"], int(m["world"]), int(new_rank),
              trainer.device)
    trainer.rebind()
    state = trainer.state_from_host(host)
    controller.epoch = int(m["epoch"])
    write_ack(controller.directory, controller.epoch, controller.worker_id)
    log(f"[elastic] epoch {m['epoch']}: rank {controller.worker_id}->"
        f"{new_rank}, world={m['world']}, resharded in "
        f"{time.monotonic() - t0:.2f}s")
    return Resumption(state=state, rank=int(new_rank),
                      world=int(m["world"]), epoch=chg.epoch,
                      next_iter=chg.next_iter)


def join_world(controller: ElasticController, join_epoch: int, device,
               deadline_s: float = 120.0) -> dict:
    """A joining process's rendezvous: wait for the epoch that includes
    it, then join that world. Returns the record (the caller restores
    its state from the beacon)."""
    t0 = time.monotonic()
    while True:
        m = read_membership(controller.directory)
        if (m is not None and int(m.get("epoch", 0)) >= join_epoch
                and str(controller.worker_id) in m.get("assignments", {})):
            break
        if time.monotonic() - t0 > deadline_s:
            raise TimeoutError(f"no membership including worker "
                               f"{controller.worker_id} at epoch >= "
                               f"{join_epoch}")
        time.sleep(0.05)
    new_rank = int(m["assignments"][str(controller.worker_id)])
    bootstrap(m["coordinator"], int(m["world"]), new_rank, device)
    controller.epoch = int(m["epoch"])
    write_ack(controller.directory, controller.epoch, controller.worker_id)
    return m
