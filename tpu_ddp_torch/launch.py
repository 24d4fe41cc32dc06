"""Local multi-process launcher with restarts (tpu_ddp/launch.py): the
reference's per-node launch recipe automated on one host, and the failure
handling the reference lacks.

The reference is started by hand on every node with the same command
(reference README.md:8-19). This module spawns ``nproc`` rank processes
of ``python -m tpu_ddp_torch.parts partN`` with ``--rank i`` and a shared
``127.0.0.1`` coordinator, and watches them:

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

Exit codes tell the failures apart: a chaos ``hard-exit`` is 13
(``FAULT_EXIT_CODE``), a watchdog kill 14, a rank killed as a bystander
-9, a clean run 0.

CLI::

    python -m tpu_ddp_torch.launch part1 --nproc 1 --max-restarts 1 \\
        --ckpt-dir D [--device cuda|cpu] [part flags...]

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
PARTS = ("part1", "part2a", "part2b", "part3")

# Flags of the JAX launcher that the port does not carry yet -> the ROADMAP
# Queue 1 item that ports what they switch on.
_UNPORTED_FLAGS = {
    "--elastic-reshard": "item 9.6b (resilience/elastic.py)",
    "--grad-compress": "item 9.3 (parallel/compress.py)",
    "--overlap": "item 9.2 (parallel/overlap.py)",
    "--bucket-mb": "item 9.2 (parallel/overlap.py)",
    "--dispatch-depth": "item 9.5 (train/pipeline.py)",
    "--pp-schedule": "item 10.7 (parallel/pipeline.py)",
    "--pp-microbatches": "item 10.7 (parallel/pipeline.py)",
    "--pp-virtual": "item 10.7 (parallel/pipeline.py)",
    "--autotune": "item 9.8 (tune/)",
    "--audit": "item 12 (analysis/)",
    "--platform": "item 9.9 (launch.py; the port takes --device)",
    "--devices-per-proc": "item 9.9 (launch.py; one device per process)",
    "--cp-prefill": "item 10.5 (context-parallel prefill)",
    **{flag: "item 11 (fleet, publish and DiLoCo)" for flag in (
        "--fleet-health", "--fleet-probe-backoff-ms",
        "--fleet-step-deadline-ms", "--fleet-retry-budget",
        "--fleet-autoscale", "--scale-cooldown-ms", "--publish-every",
        "--publish-wire", "--publish-max-staleness", "--diloco-h",
        "--diloco-outer-lr", "--diloco-outer-momentum",
        "--diloco-outer-wire")},
    **{flag: "item 10.8 (parallel/moe.py)" for flag in (
        "--moe-experts", "--moe-top-k", "--moe-capacity")},
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

    @property
    def returncode(self) -> int:
        if self.first_failure:
            return self.first_failure
        return next((w.returncode for w in self.workers
                     if w.returncode != 0), 0)

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
           heartbeat_timeout: float | None = None) -> LaunchResult:
    """Run ``nproc`` rank processes of ``python -m tpu_ddp_torch.parts
    <part>`` and wait for all of them, or for the first failure or the
    watchdog. ``env`` is added to each worker's environment.
    ``heartbeat_timeout`` arms the watchdog: the workers get
    ``TPU_DDP_HEARTBEAT_DIR`` (a fresh temp dir) and beat once per
    step."""
    if nproc < 1:
        raise ValueError("nproc must be >= 1")
    if part not in PARTS:
        from tpu_ddp_torch.parallel.sync import canonical_strategy
        canonical_strategy(part)  # raises naming the item for part4/5
        raise ValueError(f"unknown part {part!r}; available: {PARTS}")
    port = port or find_free_port()
    monitor = None
    if heartbeat_timeout is not None:
        monitor = HeartbeatMonitor(tempfile.mkdtemp(prefix="tpu_ddp_hb_"),
                                   nproc, heartbeat_timeout)

    def spawn(rank: int):
        child_env = dict(os.environ)
        if monitor is not None:
            child_env[HEARTBEAT_ENV] = monitor.directory
        if env:
            child_env.update(env)
        # Workers share the launcher's working directory (relative paths
        # such as --ckpt-dir mean the same to both) and import the port
        # from this checkout.
        child_env["PYTHONPATH"] = os.pathsep.join(
            [str(REPO)] + [x for x in child_env.get("PYTHONPATH", "")
                           .split(os.pathsep) if x])
        cmd = [sys.executable, "-m", "tpu_ddp_torch.parts", part,
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

    spawned = [spawn(rank) for rank in range(nproc)]
    procs = [p for p, _, _ in spawned]
    # Poll every rank: a rank that dies early leaves the others blocked
    # in a collective.
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
            time.sleep(0.05)
    result = LaunchResult(first_failure=first_failure,
                          stalled=first_failure == STALL_EXIT_CODE)
    for rank, (_, sink, t) in enumerate(spawned):
        t.join(timeout=5)
        result.workers.append(WorkerResult(rank=rank, returncode=rcs[rank],
                                           output="\n".join(sink)))
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
    watchdog on every attempt). Live resharding instead of a restart is
    ROADMAP Queue 1 item 9.6b."""
    if max_restarts < 0:
        raise ValueError("max_restarts must be >= 0")
    extra = list(extra_args or [])
    ckpt_dir = _ckpt_dir_of(extra)
    restart_times: deque = deque()  # monotonic stamps of restarts done
    attempt = 0
    while True:
        args = list(extra)
        if attempt > 0 and ckpt_dir and "--resume" not in args:
            from tpu_ddp_torch.utils.checkpoint import latest_step
            if latest_step(ckpt_dir) is not None:
                args.append("--resume")
        res = launch(part, nproc, extra_args=args, **kwargs)
        res.restarts = attempt
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


def _serving_env(p, args) -> dict:
    """The env the serving flags set, validated as the JAX launcher
    validates them."""
    env = {}
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
    return env


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    _refuse_unported(argv)
    p = argparse.ArgumentParser(
        prog="python -m tpu_ddp_torch.launch",
        description="spawn an N-process local cluster running one part")
    p.add_argument("part", help=f"one of {', '.join(PARTS)}")
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
    _serving_flags(p)
    args, extra = p.parse_known_args(argv)
    env = _serving_env(p, args)
    if args.remat is not None:
        env["TPU_DDP_REMAT"] = args.remat
    if args.act_dtype is not None:
        env["TPU_DDP_ACT_DTYPE"] = args.act_dtype
    env = env or None
    try:
        res = launch_elastic(args.part, args.nproc,
                             max_restarts=args.max_restarts,
                             extra_args=extra, env=env,
                             min_restart_interval=args.min_restart_interval,
                             restart_window=args.restart_window,
                             heartbeat_timeout=args.heartbeat_timeout,
                             device=args.device, port=args.port)
    except (ValueError, FileNotFoundError) as e:
        p.error(str(e))
    for w in res.workers:
        print(f"[launch] rank {w.rank} exited {w.returncode}")
    if res.stalled:
        print("[launch] final attempt killed by the heartbeat watchdog")
    if res.restarts:
        print(f"[launch] recovered after {res.restarts} restart(s)"
              if res.ok else f"[launch] gave up after {res.restarts} "
              "restart(s)")
    return res.returncode


if __name__ == "__main__":
    sys.exit(main())
