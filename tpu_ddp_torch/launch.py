"""Local multi-process launcher with restarts (tpu_ddp/launch.py): the
reference's per-node launch recipe automated on one host, and the failure
handling the reference lacks.

The reference is started by hand on every node with the same command
(reference README.md:8-19). This module spawns ``nproc`` rank processes
of ``python -m tpu_ddp_torch.parts partN`` (or, for the target ``lm``,
of the LM CLI ``python -m tpu_ddp_torch.examples.lm_train``, for ``mpmd``
of the MPMD drill ``python -m tpu_ddp_torch.examples.mpmd_train``) with
``--rank i`` and a shared ``127.0.0.1`` coordinator, and watches them:

- the first rank to fail decides the attempt's exit code, and the others
  are killed (they would block in the next collective);
- ``--heartbeat-timeout`` arms the watchdog (resilience/watchdog.py):
  a cluster whose ranks stop completing steps is killed with
  :data:`STALL_EXIT_CODE` (14);
- ``--max-restarts`` respawns a failed cluster (a fresh coordinator
  port), adding ``--resume`` when the part was given a ``--ckpt-dir``
  that holds a checkpoint; restarts back off exponentially with jitter,
  and ``--restart-window`` counts only recent restarts against the
  budget.

- ``--elastic-reshard`` turns a lost rank from a cluster failure into
  a membership epoch (resilience/elastic.py): the launcher keeps the
  protocol directory, and when a rank exits (or its heartbeat stalls)
  while others live, it writes the departure notice on its behalf,
  publishes the next epoch (survivors keep the low ranks in worker-id
  order, joiners take the highest, a fresh coordinator port) and waits
  for every member's ack; the survivors reshard their live state. A
  rank that exits 16 (``host-join``) is spawned again as a joiner of a
  regrown epoch, restoring from the survivors' beacon. A survivor that
  cannot carry its state exits 17, and that (or acks that do not come)
  fails the attempt, so ``--max-restarts`` restarts from the checkpoint.

Exit codes tell the failures apart: a chaos ``hard-exit`` is 13
(``FAULT_EXIT_CODE``), a watchdog kill 14, ``host-loss`` 15,
``host-join`` 16, a reshard that cannot carry live state 17, a rank
killed as a bystander -9, a clean run 0.

CLI::

    python -m tpu_ddp_torch.launch part1 --nproc 1 --max-restarts 1 \\
        --ckpt-dir D [--device cuda|cpu] [part flags...]
    python -m tpu_ddp_torch.launch part4 --nproc 4 --device cpu \\
        [--grad-compress bf16|int8|int8-noef] [--overlap --bucket-mb 25]
    python -m tpu_ddp_torch.launch part3 --nproc 2 --device cpu \\
        --elastic-reshard [--max-restarts 1 --ckpt-dir D]
    python -m tpu_ddp_torch.launch part3 --nproc 1 --autotune search
    TPU_DDP_LM_PRESET=TransformerLM-tiny python -m tpu_ddp_torch.launch \
        lm --nproc 2 --device cpu --moe-experts 4 --moe-top-k 2
    TPU_DDP_LM_PP=2 python -m tpu_ddp_torch.launch lm --nproc 2 \
        --device cpu --pp-schedule 1f1b --pp-microbatches 4
    TPU_DDP_MPMD_COMPRESS=int8 python -m tpu_ddp_torch.launch mpmd \
        --nproc 2 --device cuda:0

The ``--moe-*`` flags configure the LM's routed MLP and the ``--pp-*``
flags its pipeline rung, so they go with ``lm`` only (the image parts
have neither), and ``lm`` refuses every flag that the LM CLI does not
read; ``mpmd`` (examples/mpmd_train.py, JAX's ``launch.py
examples/mpmd_train.py --nproc 2``) reads only the cluster's shape and
refuses every other flag. Its two processes talk over one TCP socket and
no process group, so both may share one card: ``--device cuda:0`` gives
both ranks ``cuda:0``.

``--device`` replaces the JAX launcher's ``--platform``: the card by
default (rank i takes ``cuda:i`` when there are several), ``cpu`` runs
every rank on the CPU over gloo.
"""

from __future__ import annotations

import argparse
import os
import random
import socket
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path

from tpu_ddp_torch.resilience.watchdog import (HEARTBEAT_ENV,
                                               STALL_EXIT_CODE,
                                               HeartbeatMonitor)

REPO = Path(__file__).resolve().parent.parent
PARTS = ("part1", "part2a", "part2b", "part3", "part4", "part5")
# The LM CLI's target (examples/lm_train.py), beside the image parts.
LM = "lm"
# The launcher flags (argparse dests) the LM CLI reads: the cluster's
# shape and the MoE and pipeline knobs, which only the LM reads.
_MOE_DESTS = ("moe_experts", "moe_top_k", "moe_capacity")
_PP_DESTS = ("pp_schedule", "pp_microbatches", "pp_virtual")
_LM_DESTS = ("part", "nproc", "device", "port") + _MOE_DESTS + _PP_DESTS
# The MPMD drill's target (examples/mpmd_train.py) and what it reads.
MPMD = "mpmd"
_MPMD_DESTS = ("part", "nproc", "device", "port")
_CLI_TARGETS = {LM: "tpu_ddp_torch.examples.lm_train",
                MPMD: "tpu_ddp_torch.examples.mpmd_train"}

# Flags of the JAX launcher that the port does not carry yet -> the ROADMAP
# Queue 1 item that ports what they switch on.
_UNPORTED_FLAGS = {
    "--audit": "item 12 (analysis/)",
    "--platform": "item 9.9 (launch.py; the port takes --device)",
    "--devices-per-proc": "item 9.9 (launch.py; one device per process)",
    **{flag: "item 11 (11b: weight publishing, publish/)" for flag in (
        "--publish-every", "--publish-wire", "--publish-max-staleness")},
    **{flag: "item 11 (11c: DiLoCo, train/outer.py)" for flag in (
        "--diloco-h", "--diloco-outer-lr", "--diloco-outer-momentum",
        "--diloco-outer-wire")},
}


def find_free_port() -> int:
    """Ask the OS for a free TCP port for the coordinator."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class WorkerResult:
    rank: int
    returncode: int
    output: str = ""
    # True when an elastic reshard absorbed this worker's departure.
    absorbed: bool = False


@dataclass
class LaunchResult:
    workers: list = field(default_factory=list)
    # Exit code of the FIRST rank seen failing (the root cause, not the -9
    # of the ranks reaped after it); 0 when all succeeded.
    first_failure: int = 0
    # Cluster restarts before this (final) attempt (launch_elastic).
    restarts: int = 0
    # True when the heartbeat watchdog killed this attempt.
    stalled: bool = False
    # Membership epochs this attempt absorbed by live resharding, and
    # the attempt's protocol directory (post-mortems).
    reshards: int = 0
    control_dir: str | None = None
    # launch_elastic: the exit code of each earlier, failed attempt.
    failed_attempts: list = field(default_factory=list)

    @property
    def returncode(self) -> int:
        if self.first_failure:
            return self.first_failure
        return next((w.returncode for w in self.workers
                     if w.returncode != 0 and not w.absorbed), 0)

    @property
    def ok(self) -> bool:
        return self.returncode == 0

    def output_of(self, rank: int) -> str:
        for w in self.workers:
            if w.rank == rank:
                return w.output
        raise KeyError(rank)


def _drain(proc, rank: int, sink: list) -> None:
    """Echo one worker's output, each line prefixed with its rank, and
    keep it."""
    for raw in proc.stdout:
        line = raw.rstrip("\n")
        sink.append(line)
        print(f"[rank {rank}] {line}", flush=True)
    proc.stdout.close()


def _rank_device(device: str | None, rank: int, nproc: int) -> str | None:
    if device in (None, "cuda") and nproc > 1:
        return f"cuda:{rank}"
    return device


def launch(part: str, nproc: int, extra_args: list | None = None,
           device: str | None = None, port: int | None = None,
           env: dict | None = None,
           heartbeat_timeout: float | None = None,
           elastic_reshard: bool = False, ack_timeout: float = 120.0,
           rejoin_delay: float = 1.0,
           timeout: float | None = None) -> LaunchResult:
    """Run ``nproc`` rank processes of ``python -m tpu_ddp_torch.parts
    <part>`` and wait for all of them, or for the first failure or the
    watchdog. ``env`` is added to each worker's environment.
    ``heartbeat_timeout`` arms the watchdog: the workers get
    ``TPU_DDP_HEARTBEAT_DIR`` (a fresh temp dir) and beat once per
    step. ``elastic_reshard`` (more than one rank) absorbs departures
    into membership epochs (:func:`_run_elastic`): acks within
    ``ack_timeout`` seconds, a ``host-join`` rank spawned again after
    ``rejoin_delay``. ``timeout`` bounds the whole attempt: past it
    every rank still running is killed (exit -9)."""
    if nproc < 1:
        raise ValueError("nproc must be >= 1")
    if part not in PARTS + tuple(_CLI_TARGETS):
        raise ValueError(f"unknown part {part!r}; available: "
                         f"{PARTS + tuple(_CLI_TARGETS)}")
    port = port or find_free_port()
    monitor = None
    if heartbeat_timeout is not None:
        monitor = HeartbeatMonitor(tempfile.mkdtemp(prefix="tpu_ddp_hb_"),
                                   nproc, heartbeat_timeout)
    control_dir = None
    if elastic_reshard and nproc > 1:
        from tpu_ddp_torch.resilience import elastic as _el
        # The heartbeat directory doubles as the protocol directory when
        # the watchdog is armed: one place to look in a post-mortem.
        control_dir = (monitor.directory if monitor is not None
                       else tempfile.mkdtemp(prefix="tpu_ddp_elastic_"))
        _el.reset_control_dir(control_dir)
        _el.write_membership(control_dir, {
            "epoch": 0, "world": nproc, "base_world": nproc,
            "assignments": {str(i): i for i in range(nproc)},
            "coordinator": f"127.0.0.1:{port}",
            "joiners": [], "dropped": []})

    def spawn(rank: int, join_epoch: int | None = None):
        child_env = dict(os.environ)
        if monitor is not None:
            child_env[HEARTBEAT_ENV] = monitor.directory
        if control_dir is not None:
            from tpu_ddp_torch.resilience import elastic as _el
            child_env[_el.ELASTIC_ENV] = "1"
            child_env[_el.ELASTIC_DIR_ENV] = control_dir
            child_env[_el.ELASTIC_RANK_ENV] = str(rank)
            if join_epoch is not None:
                child_env[_el.ELASTIC_JOIN_ENV] = str(join_epoch)
        if env:
            child_env.update(env)
        # Workers share the launcher's working directory (relative paths
        # such as --ckpt-dir mean the same to both) and import the port
        # from this checkout.
        child_env["PYTHONPATH"] = os.pathsep.join(
            [str(REPO)] + [x for x in child_env.get("PYTHONPATH", "")
                           .split(os.pathsep) if x])
        target = ([_CLI_TARGETS[part]] if part in _CLI_TARGETS
                  else ["tpu_ddp_torch.parts", part])
        cmd = [sys.executable, "-m", *target,
               "--num-nodes", str(nproc), "--rank", str(rank),
               "--master-ip", "127.0.0.1", "--master-port", str(port)]
        dev = _rank_device(device, rank, nproc)
        if dev is not None:
            cmd += ["--device", dev]
        proc = subprocess.Popen(cmd + list(extra_args or []),
                                env=child_env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        sink: list = []
        t = threading.Thread(target=_drain, args=(proc, rank, sink),
                             daemon=True)
        t.start()
        return proc, sink, t

    if control_dir is not None:
        return _run_elastic(spawn, nproc, control_dir, monitor,
                            ack_timeout, rejoin_delay, timeout)
    spawned = [spawn(rank) for rank in range(nproc)]
    procs = [p for p, _, _ in spawned]
    # Poll every rank: a rank that dies early leaves the others blocked
    # in a collective.
    deadline = None if timeout is None else time.monotonic() + timeout
    rcs: dict = {}
    first_failure = 0
    while len(rcs) < len(procs):
        for rank, proc in enumerate(procs):
            if rank in rcs:
                continue
            rc = proc.poll()
            if rc is None:
                continue
            rcs[rank] = rc
            if rc != 0:
                first_failure = first_failure or rc
                for other in procs:
                    if other.poll() is None:
                        other.kill()
        if len(rcs) < len(procs):
            if monitor is not None and not first_failure \
                    and monitor.stalled():
                print(f"[launch] heartbeat stall: no step completed in "
                      f"{monitor.timeout:.0f}s - killing the cluster",
                      flush=True)
                for rank, proc in enumerate(procs):
                    if rank not in rcs:
                        proc.kill()
                        rcs[rank] = proc.wait()
                first_failure = STALL_EXIT_CODE
                break
            if deadline is not None and time.monotonic() > deadline:
                print(f"[launch] timeout ({timeout:.0f}s) - killing the "
                      "cluster", flush=True)
                for rank, proc in enumerate(procs):
                    if rank not in rcs:
                        proc.kill()
                        rcs[rank] = proc.wait()
                first_failure = first_failure or -9
                break
            time.sleep(0.05)
    result = LaunchResult(first_failure=first_failure,
                          stalled=first_failure == STALL_EXIT_CODE)
    for rank, (_, sink, t) in enumerate(spawned):
        t.join(timeout=5)
        result.workers.append(WorkerResult(rank=rank, returncode=rcs[rank],
                                           output="\n".join(sink)))
    return result


def _run_elastic(spawn, nproc: int, control_dir: str,
                 monitor: HeartbeatMonitor | None, ack_timeout: float,
                 rejoin_delay: float, timeout: float | None = None
                 ) -> LaunchResult:
    """The elastic poll loop (tpu_ddp/launch.py:310-500): departures
    become membership epochs instead of a cluster kill.

    - a worker exits 0: done (success once every member has);
    - a worker exits otherwise while others live: the notice on its
      behalf, epoch + 1 (survivors keep the low ranks in worker-id
      order, a fresh coordinator port), every survivor's ack awaited;
    - it exited 16 (``host-join``): also spawned again after
      ``rejoin_delay`` as the highest rank of a regrown epoch;
    - exit 17, no survivor left, or acks that do not come: every worker
      killed and the attempt failed, so ``launch_elastic`` restarts;
    - a live worker's heartbeat stalls: that worker is killed and its
      exit absorbed as above (every live worker stalled: the plain
      watchdog kill, exit 14);
    - past ``timeout``: every worker killed, the attempt failed (-9)."""
    from tpu_ddp_torch.resilience import elastic as _el

    live = {wid: spawn(wid) for wid in range(nproc)}
    deadline = None if timeout is None else time.monotonic() + timeout
    epoch = reshards = 0
    dropped: list = []
    done: list = []              # (WorkerResult, output, thread)
    pending_join: list = []      # (due, worker id)
    first_failure = 0
    stalled_flag = False

    def record(wid, rc, sink, thread, absorbed=False):
        done.append((WorkerResult(rank=wid, returncode=rc,
                                  absorbed=absorbed), sink, thread))

    def kill_all():
        for wid, (proc, sink, t) in list(live.items()):
            if proc.poll() is None:
                proc.kill()
            record(wid, proc.wait(), sink, t)
            del live[wid]

    def write_epoch(joiner=None):
        nonlocal epoch, reshards
        epoch += 1
        reshards += 1
        order = sorted(live)
        if joiner is not None and joiner not in live:
            order.append(joiner)
        _el.write_membership(control_dir, {
            "epoch": epoch, "world": len(order), "base_world": nproc,
            "assignments": {str(w): i for i, w in enumerate(order)},
            "coordinator": f"127.0.0.1:{find_free_port()}",
            "joiners": [] if joiner is None else [joiner],
            "dropped": sorted(dropped)})
        return order

    def await_acks(members):
        stop = time.monotonic() + ack_timeout
        if deadline is not None:
            stop = min(stop, deadline)
        while time.monotonic() < stop:
            if all(os.path.exists(_el.ack_path(control_dir, epoch, w))
                   for w in members):
                if monitor is not None:
                    # Survivors paused beating to rebuild: fresh grace.
                    monitor.reset_grace()
                return True
            # A member dying mid-reshard fails the epoch.
            if any(w in live and live[w][0].poll() is not None
                   for w in members):
                return False
            time.sleep(0.05)
        return False

    def fall_back(what):
        nonlocal first_failure
        print(f"[launch] {what} failed to converge; falling back to "
              "restart", flush=True)
        first_failure = _el.RESHARD_FALLBACK_EXIT
        kill_all()

    while (live or pending_join) and not first_failure:
        now = time.monotonic()
        # 1. Spawn due joiners into a regrown epoch.
        for item in [x for x in pending_join if x[0] <= now]:
            pending_join.remove(item)
            wid = item[1]
            if not live:
                first_failure = _el.HOST_JOIN_EXIT
                break
            _el.clear_departure(control_dir, wid)
            if wid in dropped:
                dropped.remove(wid)
            members = write_epoch(joiner=wid)
            live[wid] = spawn(wid, join_epoch=epoch)
            print(f"[launch] epoch {epoch}: worker {wid} rejoining, "
                  f"world={len(members)}", flush=True)
            if not await_acks(members):
                fall_back("rejoin epoch")
                break
        if first_failure:
            break
        # 2. Reap exits.
        for wid in sorted(live):
            proc, sink, t = live[wid]
            rc = proc.poll()
            if rc is None:
                continue
            del live[wid]
            if rc == 0:
                record(wid, 0, sink, t)
                continue
            if rc == _el.RESHARD_FALLBACK_EXIT or not live:
                # Nothing to reshard around.
                record(wid, rc, sink, t)
                first_failure = rc
                kill_all()
                break
            reason = {_el.HOST_LOSS_EXIT: "host-loss",
                      _el.HOST_JOIN_EXIT: "host-join"}.get(rc, f"rc={rc}")
            _el.announce_departure(control_dir, wid, reason)
            record(wid, rc, sink, t, absorbed=True)
            dropped.append(wid)
            members = write_epoch()
            print(f"[launch] epoch {epoch}: worker {wid} left ({reason}); "
                  f"resharding onto {len(members)} survivor(s)", flush=True)
            if not await_acks(members):
                fall_back("reshard")
                break
            if rc == _el.HOST_JOIN_EXIT:
                pending_join.append((time.monotonic() + rejoin_delay, wid))
        if first_failure:
            break
        # 3. Stalls among the live workers: kill the wedged one and
        #    absorb it above.
        if monitor is not None and live:
            stalled = monitor.stalled_ranks(ranks=sorted(live))
            if stalled and len(stalled) == len(live):
                print(f"[launch] heartbeat stall on every live rank "
                      f"({monitor.timeout:.0f}s) - killing the cluster",
                      flush=True)
                first_failure = STALL_EXIT_CODE
                stalled_flag = True
                kill_all()
                break
            for wid in stalled:
                print(f"[launch] rank {wid} heartbeat stalled "
                      f"({monitor.timeout:.0f}s); killing it and "
                      "resharding around it", flush=True)
                live[wid][0].kill()
        if deadline is not None and time.monotonic() > deadline:
            print(f"[launch] timeout ({timeout:.0f}s) - killing the "
                  "cluster", flush=True)
            first_failure = -9
            kill_all()
            break
        if live or pending_join:
            time.sleep(0.05)

    result = LaunchResult(first_failure=first_failure, reshards=reshards,
                          stalled=stalled_flag, control_dir=control_dir)
    for w, sink, t in done:
        t.join(timeout=5)
        w.output = "\n".join(sink)
        result.workers.append(w)
    result.workers.sort(key=lambda w: w.rank)
    return result


def backoff_delay(attempt: int, floor: float = 1.0, cap: float = 60.0,
                  rng: random.Random | None = None) -> float:
    """Seconds to wait before restart ``attempt`` (1-based): exponential
    from ``floor`` (doubling per attempt, capped at ``cap``) plus 0-25%
    jitter, so clusters failed by one shared cause do not restart in
    lockstep. ``floor <= 0`` disables the wait."""
    if attempt < 1:
        raise ValueError(f"attempt is 1-based, got {attempt}")
    if floor <= 0:
        return 0.0
    base = min(cap, floor * (2.0 ** (attempt - 1)))
    return base * (1.0 + (rng or random).uniform(0.0, 0.25))


def _ckpt_dir_of(extra: list) -> str | None:
    ckpt_dir = None
    for idx, tok in enumerate(extra):
        if tok == "--ckpt-dir":
            if idx + 1 >= len(extra):
                raise ValueError("--ckpt-dir requires a value")
            ckpt_dir = extra[idx + 1]
        elif tok.startswith("--ckpt-dir="):
            ckpt_dir = tok.split("=", 1)[1]
    return ckpt_dir


def launch_elastic(part: str, nproc: int, max_restarts: int = 0,
                   extra_args: list | None = None,
                   min_restart_interval: float = 1.0,
                   restart_window: float | None = None,
                   backoff_cap: float = 60.0, **kwargs) -> LaunchResult:
    """:func:`launch` with restarts: a failed cluster is respawned up to
    ``max_restarts`` times, with ``--resume`` added when the part's
    ``--ckpt-dir`` holds a checkpoint. Restarts back off from
    ``min_restart_interval`` (:func:`backoff_delay`); ``restart_window``
    makes the budget a sliding window (only restarts within the last
    ``restart_window`` seconds count), ``None`` a lifetime one. Extra
    ``kwargs`` reach :func:`launch` (``heartbeat_timeout`` arms the
    watchdog on every attempt, ``elastic_reshard`` reshards live around
    departures, and an attempt whose reshard fails, exit 17, restarts
    here from the checkpoint)."""
    if max_restarts < 0:
        raise ValueError("max_restarts must be >= 0")
    extra = list(extra_args or [])
    ckpt_dir = _ckpt_dir_of(extra)
    restart_times: deque = deque()  # monotonic stamps of restarts done
    attempt = 0
    failed: list = []
    while True:
        args = list(extra)
        if attempt > 0 and ckpt_dir and "--resume" not in args:
            from tpu_ddp_torch.utils.checkpoint import latest_step
            if latest_step(ckpt_dir) is not None:
                args.append("--resume")
        res = launch(part, nproc, extra_args=args, **kwargs)
        res.restarts = attempt
        res.failed_attempts = list(failed)
        if res.ok:
            break
        now = time.monotonic()
        if restart_window is not None:
            while restart_times and now - restart_times[0] > restart_window:
                restart_times.popleft()
            if len(restart_times) >= max_restarts:
                break
        elif attempt >= max_restarts:
            break
        attempt += 1
        failed.append(res.returncode)
        delay = backoff_delay(attempt, floor=min_restart_interval,
                              cap=backoff_cap)
        why = "stalled" if res.stalled else f"rc={res.returncode}"
        print(f"[launch] attempt failed ({why}); restart {attempt} in "
              f"{delay:.2f}s", flush=True)
        if delay > 0:
            time.sleep(delay)
        restart_times.append(time.monotonic())
        kwargs.pop("port", None)  # a fresh coordinator port per attempt
    return res


def _refuse_unported(argv: list) -> None:
    for tok in argv:
        flag = tok.split("=", 1)[0]
        if flag in _UNPORTED_FLAGS:
            raise NotImplementedError(
                f"{flag}: not ported to tpu_ddp_torch yet (ROADMAP Queue 1 "
                f"{_UNPORTED_FLAGS[flag]})")


def _serving_flags(p) -> None:
    """The serving knobs, each exported to every rank as its env var."""
    p.add_argument("--fleet-health", default=None, choices=("0", "1"),
                   help="replica health tracking and deterministic "
                        "request migration in the serving Router "
                        "(tpu_ddp_torch/fleet/router.py); '0' = "
                        "fail-fast. Sets TPU_DDP_FLEET_HEALTH for every "
                        "rank")
    p.add_argument("--fleet-probe-backoff-ms", type=float, default=None,
                   help="initial probe re-admission backoff of an "
                        "unhealthy replica, doubling per consecutive "
                        "failure (default 200). Sets "
                        "TPU_DDP_FLEET_HEALTH_BACKOFF_MS for every rank")
    p.add_argument("--fleet-step-deadline-ms", type=float, default=None,
                   help="per-replica step deadline; a slower step counts "
                        "as a failure (0 disables). Sets "
                        "TPU_DDP_FLEET_HEALTH_DEADLINE_MS for every rank")
    p.add_argument("--fleet-retry-budget", type=int, default=None,
                   help="migrations allowed per request before the "
                        "Router sheds it (default 3). Sets "
                        "TPU_DDP_FLEET_RETRY_BUDGET for every rank")
    p.add_argument("--fleet-autoscale", default=None, choices=("0", "1"),
                   help="the autoscaling replica lifecycle "
                        "(tpu_ddp_torch/fleet/autoscale.py): scale-up "
                        "boots replicas from the engine factory, "
                        "scale-down drains through continuation "
                        "migration. Sets TPU_DDP_FLEET_AUTOSCALE for "
                        "every rank")
    p.add_argument("--scale-cooldown-ms", type=float, default=None,
                   help="minimum ms between autoscaler actions (default "
                        "1000). Sets TPU_DDP_SCALE_COOLDOWN_MS for every "
                        "rank")
    p.add_argument("--serve-queue-limit", type=int, default=None,
                   help="bounded serving admission queue; submits "
                        "beyond this many waiting requests are shed "
                        "(0 = unbounded). Sets TPU_DDP_SERVE_QUEUE_LIMIT "
                        "for every rank")
    p.add_argument("--serve-shed-ms", type=float, default=None,
                   help="shed a queued request that has not started "
                        "prefill after this many ms (0 disables). Sets "
                        "TPU_DDP_SERVE_SHED_MS for every rank")
    p.add_argument("--tenant-classes", default=None,
                   help="SLO classes for multi-tenant serving: comma-"
                        "separated name=weight[:deadline_ms[:token_"
                        "budget]] (e.g. 'gold=3,bronze=1'); empty = "
                        "single-tenant FIFO. Sets "
                        "TPU_DDP_TENANT_CLASSES for every rank")
    p.add_argument("--spec-k", type=int, default=None,
                   help="speculative decoding: proposals verified per "
                        "serving engine step (0 = off). Sets "
                        "TPU_DDP_SPEC_K for every rank")
    p.add_argument("--spec-draft", default=None,
                   help="draft family for speculation: 'chain' "
                        "(bitwise-exact same-step schedule), "
                        "'self-<j>' (early exit over the target's "
                        "first j blocks) or 'quant' (full-depth int8 "
                        "twin). Sets TPU_DDP_SPEC_DRAFT for every rank")
    p.add_argument("--decode-quant", default=None,
                   choices=("none", "int8"),
                   help="weight-only int8 decode compute "
                        "(ops/quant.py): per-channel quantization of "
                        "every decode-path projection at engine "
                        "construction. Sets TPU_DDP_DECODE_QUANT for "
                        "every rank")
    p.add_argument("--kv-tiers", type=int, default=None,
                   choices=(1, 2, 3),
                   help="tiered KV pool (serve/kv_pool.py): 1 = single "
                        "tier, 2 adds a quantized cold tier on the "
                        "device, 3 adds host-memory spill behind it. "
                        "Sets TPU_DDP_KV_TIERS for every rank")
    p.add_argument("--kv-cold-dtype", default=None,
                   choices=("int8", "bf16"),
                   help="cold-page codec for --kv-tiers >= 2: "
                        "per-token-row int8 or a bf16 downcast "
                        "(lossless under a bf16 hot cache dtype). "
                        "Sets TPU_DDP_KV_COLD_DTYPE for every rank")
    p.add_argument("--cp-prefill", default=None,
                   choices=("off", "ring", "ulysses"),
                   help="context-parallel chunked prefill "
                        "(tpu_ddp_torch/serve/long_context.py): shard "
                        "each prefill chunk over the serving sp group. "
                        "Sets TPU_DDP_CP_PREFILL for every rank")


def _serving_env(p, args) -> dict:
    """The env the serving flags set, validated as the JAX launcher
    validates them."""
    env = {}
    if args.fleet_health is not None:
        env["TPU_DDP_FLEET_HEALTH"] = args.fleet_health
    if args.fleet_probe_backoff_ms is not None:
        if args.fleet_probe_backoff_ms <= 0:
            p.error(f"--fleet-probe-backoff-ms must be > 0, "
                    f"got {args.fleet_probe_backoff_ms}")
        env["TPU_DDP_FLEET_HEALTH_BACKOFF_MS"] = \
            str(args.fleet_probe_backoff_ms)
    if args.fleet_step_deadline_ms is not None:
        if args.fleet_step_deadline_ms < 0:
            p.error(f"--fleet-step-deadline-ms must be >= 0, "
                    f"got {args.fleet_step_deadline_ms}")
        env["TPU_DDP_FLEET_HEALTH_DEADLINE_MS"] = \
            str(args.fleet_step_deadline_ms)
    if args.fleet_retry_budget is not None:
        if args.fleet_retry_budget < 0:
            p.error(f"--fleet-retry-budget must be >= 0, "
                    f"got {args.fleet_retry_budget}")
        env["TPU_DDP_FLEET_RETRY_BUDGET"] = str(args.fleet_retry_budget)
    if args.fleet_autoscale is not None:
        env["TPU_DDP_FLEET_AUTOSCALE"] = args.fleet_autoscale
    if args.scale_cooldown_ms is not None:
        if args.scale_cooldown_ms <= 0:
            p.error(f"--scale-cooldown-ms must be > 0, "
                    f"got {args.scale_cooldown_ms}")
        env["TPU_DDP_SCALE_COOLDOWN_MS"] = str(args.scale_cooldown_ms)
    if args.serve_queue_limit is not None:
        if args.serve_queue_limit < 0:
            p.error(f"--serve-queue-limit must be >= 0, "
                    f"got {args.serve_queue_limit}")
        env["TPU_DDP_SERVE_QUEUE_LIMIT"] = str(args.serve_queue_limit)
    if args.serve_shed_ms is not None:
        if args.serve_shed_ms < 0:
            p.error(f"--serve-shed-ms must be >= 0, "
                    f"got {args.serve_shed_ms}")
        env["TPU_DDP_SERVE_SHED_MS"] = str(args.serve_shed_ms)
    if args.tenant_classes is not None:
        for ent in args.tenant_classes.split(","):
            if ent.strip() and "=" not in ent:
                p.error(f"--tenant-classes entry {ent.strip()!r}: "
                        "expected name=weight[:deadline_ms[:token_"
                        "budget]]")
        env["TPU_DDP_TENANT_CLASSES"] = args.tenant_classes
    if args.spec_k is not None:
        if args.spec_k < 0:
            p.error(f"--spec-k must be >= 0, got {args.spec_k}")
        env["TPU_DDP_SPEC_K"] = str(args.spec_k)
    if args.spec_draft is not None:
        sd = args.spec_draft.strip()
        if sd not in ("chain", "quant") and not (
                sd.startswith("self-")
                and sd[len("self-"):].isdigit()
                and int(sd[len("self-"):]) >= 1):
            p.error(f"--spec-draft {args.spec_draft!r}: expected "
                    "chain, self-<j> (j >= 1) or quant")
        env["TPU_DDP_SPEC_DRAFT"] = args.spec_draft
    if args.decode_quant is not None:
        env["TPU_DDP_DECODE_QUANT"] = args.decode_quant
    if args.kv_tiers is not None:
        env["TPU_DDP_KV_TIERS"] = str(args.kv_tiers)
    if args.kv_cold_dtype is not None:
        env["TPU_DDP_KV_COLD_DTYPE"] = args.kv_cold_dtype
    if args.cp_prefill is not None:
        env["TPU_DDP_CP_PREFILL"] = args.cp_prefill
    return env


def build_parser() -> argparse.ArgumentParser:
    """The launcher's flags; the part's own flags pass through."""
    p = argparse.ArgumentParser(
        prog="python -m tpu_ddp_torch.launch",
        description="spawn an N-process local cluster running one part")
    p.add_argument("part", help=f"one of "
                                f"{', '.join(PARTS + tuple(_CLI_TARGETS))} "
                                "(lm: examples/lm_train.py, mpmd: "
                                "examples/mpmd_train.py)")
    p.add_argument("--nproc", type=int, required=True,
                   help="number of rank processes (the --num-nodes value)")
    p.add_argument("--device", default=None,
                   help="cuda (default: rank i on cuda:i) or cpu")
    p.add_argument("--port", type=int, default=None,
                   help="coordinator port (default: pick a free one)")
    p.add_argument("--max-restarts", type=int, default=0,
                   help="respawn the cluster up to N times on failure, "
                        "resuming from --ckpt-dir when possible")
    p.add_argument("--min-restart-interval", type=float, default=1.0,
                   help="backoff floor in seconds before the first "
                        "restart; doubles per attempt with jitter "
                        "(<= 0 restarts immediately)")
    p.add_argument("--restart-window", type=float, default=None,
                   help="count only restarts within the last N seconds "
                        "against --max-restarts (default: lifetime)")
    p.add_argument("--heartbeat-timeout", type=float, default=None,
                   help="kill and restart a cluster whose ranks stop "
                        "completing steps for N seconds")
    p.add_argument("--remat", default=None,
                   choices=("none", "blocks", "conv_stages", "dots"),
                   help="activation rematerialisation policy "
                        "(memory/policy.py): 'blocks' (per conv unit or "
                        "transformer block), 'conv_stages' (per VGG "
                        "between-pool group), 'dots' (save matmul outputs "
                        "only). Sets TPU_DDP_REMAT for every rank")
    p.add_argument("--act-dtype", default=None,
                   choices=("compute", "bf16", "f32"),
                   help="saved-residual dtype at remat-region boundaries "
                        "(memory/policy.py); region arithmetic stays in "
                        "the compute dtype. Sets TPU_DDP_ACT_DTYPE for "
                        "every rank")
    p.add_argument("--grad-compress", default=None,
                   choices=("none", "bf16", "int8", "int8-noef"),
                   help="gradient wire format of the sync collectives "
                        "(parallel/compress.py): bf16 halves, int8 about "
                        "quarters the bytes on the wire (int8 carries an "
                        "error-feedback residual; int8-noef is the "
                        "ablation without it). Sets TPU_DDP_GRAD_COMPRESS "
                        "for every rank")
    p.add_argument("--overlap", action="store_true",
                   help="bucket the gradients in reverse order and launch "
                        "each bucket's collective from inside the "
                        "backward (torch DDP's reducer; "
                        "parallel/overlap.py), with the sharded weight "
                        "update on the all_reduce/fused rungs. Sets "
                        "TPU_DDP_OVERLAP for every rank")
    p.add_argument("--bucket-mb", type=int, default=None,
                   help="bucket payload target in MiB for --overlap "
                        "(torch DDP's bucket_cap_mb; default 25). Sets "
                        "TPU_DDP_BUCKET_MB for every rank")
    p.add_argument("--dispatch-depth", type=int, default=None,
                   help="async dispatch window: train steps kept in "
                        "flight by the epoch loop (0 = synchronous; "
                        "train/pipeline.py). Sets TPU_DDP_DISPATCH_DEPTH "
                        "for every rank")
    p.add_argument("--elastic-reshard", action="store_true",
                   help="on a membership change (a rank lost, stalled or "
                        "rejoining) reshard the survivors' live state onto "
                        "the new world instead of killing the cluster "
                        "(resilience/elastic.py, parallel/redistribute.py); "
                        "a failed reshard still falls back to "
                        "--max-restarts checkpoint recovery. Sets "
                        "TPU_DDP_ELASTIC_RESHARD for every rank")
    p.add_argument("--autotune", default=None,
                   choices=("off", "cached", "search"),
                   help="perf-knob autotuning (tune/): 'cached' applies "
                        "a previously searched tuning for this workload "
                        "fingerprint, 'search' runs measured trials and "
                        "persists the winner (single-process only; "
                        "multi-process ranks use the defaults). Sets "
                        "TPU_DDP_AUTOTUNE for every rank")
    p.add_argument("--moe-experts", type=int, default=None,
                   help="lm only: experts per MoE MLP layer (0 = dense; "
                        "parallel/moe.py), over the preset's. Sets "
                        "TPU_DDP_MOE_EXPERTS for every rank")
    p.add_argument("--moe-top-k", type=int, default=None,
                   help="lm only: routed experts per token (1 = Switch, "
                        "2 = GShard). Sets TPU_DDP_MOE_TOP_K for every "
                        "rank")
    p.add_argument("--moe-capacity", type=float, default=None,
                   help="lm only: expert capacity factor: slots per "
                        "expert = "
                        "ceil(T * capacity * top_k / E); higher = "
                        "fewer dropped tokens, more padded compute. "
                        "Sets TPU_DDP_MOE_CAPACITY for every rank")
    p.add_argument("--pp-schedule", default=None,
                   choices=("gpipe", "1f1b", "interleaved", "zerobubble"),
                   help="lm only: pipeline tick schedule for the pp rung "
                        "(parallel/pipeline.py): gpipe (all forwards, then "
                        "all backwards), 1f1b (O(pp) activation "
                        "residency), interleaved (virtual stages, "
                        "bubble / pp_virtual) or zerobubble (B-weight "
                        "fills the cooldown). Sets TPU_DDP_PP_SCHEDULE "
                        "for every rank")
    p.add_argument("--pp-microbatches", type=int, default=None,
                   help="lm only: microbatches per pipeline step (0 = "
                        "auto, one per stage). Sets "
                        "TPU_DDP_PP_MICROBATCHES for every rank")
    p.add_argument("--pp-virtual", type=int, default=None,
                   help="lm only: virtual stage chunks per physical stage "
                        "(interleaved schedule only; needs num_layers "
                        "divisible by pp*pp_virtual). Sets "
                        "TPU_DDP_PP_VIRTUAL for every rank")
    _serving_flags(p)
    return p


def _check_target(p: argparse.ArgumentParser, args) -> None:
    """Refuse a flag that the launched program would not read: ``--moe-*``
    with an image part, an image part's flag with ``lm``, any flag but
    the cluster's shape with ``mpmd``."""
    if args.part in _CLI_TARGETS:
        reads, cli = ((_LM_DESTS, "the LM CLI (examples/lm_train.py)")
                      if args.part == LM else
                      (_MPMD_DESTS, "the MPMD drill (examples/mpmd_train.py)"))
        unread = sorted(f"--{d.replace('_', '-')}"
                        for d, v in vars(args).items()
                        if d not in reads and v != p.get_default(d))
        if unread:
            p.error(f"{', '.join(unread)}: {cli} does not read them")
        return
    moe = [f"--{d.replace('_', '-')}" for d in _MOE_DESTS
           if getattr(args, d) is not None]
    if moe:
        p.error(f"{', '.join(moe)}: {args.part} trains an image model, "
                "which has no routed layer; the MoE knobs configure the "
                f"LM: launch {LM} (examples/lm_train.py)")
    pipe = [f"--{d.replace('_', '-')}" for d in _PP_DESTS
            if getattr(args, d) is not None]
    if pipe:
        p.error(f"{', '.join(pipe)}: {args.part} has no pipeline rung; "
                f"the pipeline knobs configure the LM: launch {LM} "
                "(examples/lm_train.py, TPU_DDP_LM_PP > 1)")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    _refuse_unported(argv)
    p = build_parser()
    args, extra = p.parse_known_args(argv)
    _check_target(p, args)
    env = _serving_env(p, args)
    if args.remat is not None:
        env["TPU_DDP_REMAT"] = args.remat
    if args.act_dtype is not None:
        env["TPU_DDP_ACT_DTYPE"] = args.act_dtype
    if args.grad_compress is not None:
        env["TPU_DDP_GRAD_COMPRESS"] = args.grad_compress
    if args.overlap:
        env["TPU_DDP_OVERLAP"] = "1"
    if args.bucket_mb is not None:
        if args.bucket_mb <= 0:
            p.error(f"--bucket-mb must be > 0, got {args.bucket_mb}")
        env["TPU_DDP_BUCKET_MB"] = str(args.bucket_mb)
    if args.dispatch_depth is not None:
        if args.dispatch_depth < 0:
            p.error(f"--dispatch-depth must be >= 0, "
                    f"got {args.dispatch_depth}")
        env["TPU_DDP_DISPATCH_DEPTH"] = str(args.dispatch_depth)
    if args.elastic_reshard:
        env["TPU_DDP_ELASTIC_RESHARD"] = "1"
    if args.autotune is not None:
        env["TPU_DDP_AUTOTUNE"] = args.autotune
    if args.moe_experts is not None:
        if args.moe_experts < 0:
            p.error(f"--moe-experts must be >= 0, got "
                    f"{args.moe_experts}")
        env["TPU_DDP_MOE_EXPERTS"] = str(args.moe_experts)
    if args.moe_top_k is not None:
        if args.moe_top_k < 1:
            p.error(f"--moe-top-k must be >= 1, got {args.moe_top_k}")
        env["TPU_DDP_MOE_TOP_K"] = str(args.moe_top_k)
    if args.moe_capacity is not None:
        if not args.moe_capacity > 0:
            p.error(f"--moe-capacity must be > 0, got "
                    f"{args.moe_capacity}")
        env["TPU_DDP_MOE_CAPACITY"] = str(args.moe_capacity)
    if args.pp_schedule is not None:
        env["TPU_DDP_PP_SCHEDULE"] = args.pp_schedule
    if args.pp_microbatches is not None:
        if args.pp_microbatches < 0:
            p.error(f"--pp-microbatches must be >= 0 (0 = auto), "
                    f"got {args.pp_microbatches}")
        env["TPU_DDP_PP_MICROBATCHES"] = str(args.pp_microbatches)
    if args.pp_virtual is not None:
        if args.pp_virtual < 1:
            p.error(f"--pp-virtual must be >= 1, got {args.pp_virtual}")
        env["TPU_DDP_PP_VIRTUAL"] = str(args.pp_virtual)
    env = env or None
    try:
        res = launch_elastic(args.part, args.nproc,
                             max_restarts=args.max_restarts,
                             extra_args=extra, env=env,
                             min_restart_interval=args.min_restart_interval,
                             restart_window=args.restart_window,
                             heartbeat_timeout=args.heartbeat_timeout,
                             elastic_reshard=args.elastic_reshard,
                             device=args.device, port=args.port)
    except (ValueError, FileNotFoundError) as e:
        p.error(str(e))
    for w in res.workers:
        print(f"[launch] rank {w.rank} exited {w.returncode}")
    if res.stalled:
        print("[launch] final attempt killed by the heartbeat watchdog")
    if res.reshards:
        print(f"[launch] absorbed {res.reshards} membership epoch(s) by "
              "live resharding")
    if res.restarts:
        print(f"[launch] recovered after {res.restarts} restart(s)"
              if res.ok else f"[launch] gave up after {res.restarts} "
              "restart(s)")
    return res.returncode


if __name__ == "__main__":
    sys.exit(main())
