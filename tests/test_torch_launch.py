"""The port's restarting launcher (tpu_ddp_torch/launch.py) held against
the JAX launcher's contract: the backoff schedule, the restart budget,
the exit codes, and real drills on the CPU.

The drills run ``python -m tpu_ddp_torch.launch`` as a subprocess (each
with its own time limit) on the VGG-11 ladder at the smoke knobs
(``TPU_DDP_SYNTH_SIZE=64``, ``TPU_DDP_GLOBAL_BATCH=16``, a few
iterations), ``--device cpu``, ranks over gloo:

- ``hard-exit`` on the all_reduce rung (2 processes): exactly one
  restart, the second attempt resumes from the checkpoint before the
  fault, and its final checkpoint has the digests of an uninterrupted
  run (bit equality);
- ``nan-grad`` on rank 1 only, all_reduce rung: both ranks skip the step
  (the flag is all-reduced), and the replica check every step passes;
- ``stalled-step`` on part 1: the heartbeat watchdog kills the attempt
  (exit 14) and the restart finishes the run.
"""

import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest

from tpu_ddp import launch as jax_launch
from tpu_ddp_torch import launch
from tpu_ddp_torch.resilience.watchdog import STALL_EXIT_CODE

REPO = Path(__file__).resolve().parent.parent
SMOKE = {"TPU_DDP_SYNTH_SIZE": "64", "TPU_DDP_GLOBAL_BATCH": "16",
         "TPU_DDP_PALLAS_SGD": "1", "TPU_DDP_PALLAS_BN": "1",
         "OMP_NUM_THREADS": "1"}


def _launch(args, env, timeout):
    run_env = {k: v for k, v in os.environ.items()
               if not k.startswith("TPU_DDP_")}
    run_env.update(SMOKE, PYTHONPATH=str(REPO), **env)
    return subprocess.run([sys.executable, "-m", "tpu_ddp_torch.launch",
                           *args], env=run_env, capture_output=True,
                          text=True, timeout=timeout, cwd=REPO)


def _digests(directory, step):
    path = os.path.join(directory, f"step_{step:08d}", "manifest.json")
    with open(path) as f:
        return json.load(f)["digests"]


# ---- scheduling and budget --------------------------------------------------

def test_backoff_delay_matches_jax():
    for attempt in range(1, 9):
        for floor, cap in ((1.0, 60.0), (0.5, 4.0), (0.0, 60.0)):
            mine = launch.backoff_delay(attempt, floor, cap,
                                        rng=random.Random(attempt))
            theirs = jax_launch.backoff_delay(attempt, floor, cap,
                                              rng=random.Random(attempt))
            assert mine == theirs
    with pytest.raises(ValueError):
        launch.backoff_delay(0)


def _fake_launch(monkeypatch, codes):
    """Replace one attempt by the next exit code of ``codes``."""
    calls = []

    def fake(part, nproc, extra_args=None, **kw):
        calls.append(list(extra_args))
        rc = codes[len(calls) - 1]
        return launch.LaunchResult(first_failure=rc,
                                   stalled=rc == STALL_EXIT_CODE)

    monkeypatch.setattr(launch, "launch", fake)
    return calls


def test_restart_budget_and_resume_flag(monkeypatch, tmp_path):
    """Restarts stop at the budget; ``--resume`` is added once the
    checkpoint directory holds a checkpoint."""
    calls = _fake_launch(monkeypatch, [13, 14, 13, 0])
    res = launch.launch_elastic("part1", 1, max_restarts=2,
                                extra_args=["--ckpt-dir", str(tmp_path)],
                                min_restart_interval=0)
    assert (res.returncode, res.restarts, len(calls)) == (13, 2, 3)
    assert all("--resume" not in c for c in calls)
    from tpu_ddp_torch.utils.checkpoint import save_checkpoint
    save_checkpoint(str(tmp_path), {"a": [1.0]}, 1)
    calls = _fake_launch(monkeypatch, [13, 0])
    res = launch.launch_elastic("part1", 1, max_restarts=3,
                                extra_args=[f"--ckpt-dir={tmp_path}"],
                                min_restart_interval=0)
    assert res.ok and res.restarts == 1
    assert calls == [[f"--ckpt-dir={tmp_path}"],
                     [f"--ckpt-dir={tmp_path}", "--resume"]]


def test_sliding_restart_window(monkeypatch):
    """With a window, only recent restarts count: a budget of 1 within
    a long window stops after one restart; within a zero-length window
    every restart is old, so the run goes on until it succeeds."""
    _fake_launch(monkeypatch, [13, 13, 13, 0])
    res = launch.launch_elastic("part1", 1, max_restarts=1,
                                restart_window=3600.0,
                                min_restart_interval=0)
    assert (res.returncode, res.restarts) == (13, 1)
    _fake_launch(monkeypatch, [13, 13, 13, 0])
    res = launch.launch_elastic("part1", 1, max_restarts=1,
                                restart_window=0.0, min_restart_interval=0)
    assert res.ok and res.restarts == 3
    with pytest.raises(ValueError):
        launch.launch_elastic("part1", 1, max_restarts=-1)


# Flags this test refused until their item was ported; each keeps its
# case, which now holds that the flag reaches every rank as its env var
# (item 11a): flag -> (argument, env var).
PORTED_FLAGS = {"--fleet-health": ("0", "TPU_DDP_FLEET_HEALTH")}


@pytest.mark.parametrize("flag,item", [
    ("--fleet-health", "item 11"), ("--audit", "item 12"),
    ("--platform", "item 9.9")])
def test_unported_flags_raise_naming_their_item(flag, item, monkeypatch):
    if flag in PORTED_FLAGS:
        arg, env = PORTED_FLAGS[flag]
        seen = []
        monkeypatch.setattr(launch, "launch_elastic",
                            lambda part, nproc, **kw: seen.append(kw["env"])
                            or launch.LaunchResult())
        assert launch.main(["part1", "--nproc", "1", flag, arg]) == 0
        assert seen == [{env: arg}]
        with pytest.raises(NotImplementedError, match=item):
            launch.main(["part1", "--nproc", "1", "--publish-every", "1"])
        return
    with pytest.raises(NotImplementedError, match=item):
        launch.main(["part1", "--nproc", "1", flag])


def test_elastic_reshard_flag_arms_the_elastic_loop(monkeypatch):
    """``--elastic-reshard`` reaches every rank as TPU_DDP_ELASTIC_RESHARD
    and the launcher's elastic loop (tests/test_torch_elastic.py runs the
    drills), as in the JAX launcher."""
    seen = []

    def fake(part, nproc, **kw):
        seen.append((kw["env"], kw["elastic_reshard"]))
        return launch.LaunchResult(reshards=1)

    monkeypatch.setattr(launch, "launch_elastic", fake)
    assert launch.main(["part3", "--nproc", "2", "--elastic-reshard"]) == 0
    assert seen == [({"TPU_DDP_ELASTIC_RESHARD": "1"}, True)]
    # An absorbed departure does not fail the launch.
    res = launch.LaunchResult(workers=[
        launch.WorkerResult(rank=0, returncode=0),
        launch.WorkerResult(rank=1, returncode=15, absorbed=True)])
    assert res.ok


def test_dispatch_depth_flag_sets_the_env(monkeypatch):
    """``--dispatch-depth N`` reaches every rank as
    TPU_DDP_DISPATCH_DEPTH, as the JAX launcher exports it; a negative
    depth is a usage error."""
    seen = []

    def fake(part, nproc, **kw):
        seen.append(kw["env"])
        return launch.LaunchResult()

    monkeypatch.setattr(launch, "launch_elastic", fake)
    assert launch.main(["part1", "--nproc", "1", "--dispatch-depth",
                        "4"]) == 0
    assert seen == [{"TPU_DDP_DISPATCH_DEPTH": "4"}]
    with pytest.raises(SystemExit):
        launch.main(["part1", "--nproc", "1", "--dispatch-depth", "-1"])


def test_parts_and_exit_codes():
    assert launch.PARTS[-2:] == ("part4", "part5")
    with pytest.raises(ValueError, match="unknown part"):
        launch.launch("part9", 1)
    with pytest.raises(ValueError):
        launch.launch("part1", 0)
    assert launch.LaunchResult(first_failure=13).returncode == 13
    res = launch.LaunchResult(workers=[launch.WorkerResult(0, 0, "a"),
                                       launch.WorkerResult(1, -9, "b")])
    assert res.returncode == -9 and not res.ok
    assert res.output_of(1) == "b"
    assert launch._rank_device(None, 1, 2) == "cuda:1"
    assert launch._rank_device("cpu", 1, 2) == "cpu"
    assert launch._rank_device(None, 0, 1) is None


# ---- drills on the CPU ------------------------------------------------------

def test_hard_exit_restart_resumes_bit_identically(tmp_path):
    """part2b, 2 processes: a chaos hard-exit at step 3 on rank 0, one
    restart from the step-2 checkpoint, and the step-4 checkpoint equal to
    an uninterrupted run's."""
    env = {"TPU_DDP_MAX_ITERS": "4", "TPU_DDP_CKPT_EVERY": "2"}
    straight = str(tmp_path / "straight")
    proc = _launch(["part2b", "--nproc", "2", "--device", "cpu",
                    "--ckpt-dir", straight], env, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    d = str(tmp_path / "faulted")
    proc = _launch(["part2b", "--nproc", "2", "--device", "cpu",
                    "--max-restarts", "1", "--min-restart-interval", "0",
                    "--ckpt-dir", d],
                   {**env, "TPU_DDP_CHAOS_FAULTS": "hard-exit@3",
                    "TPU_DDP_CHAOS_SENTINEL": str(tmp_path / "sentinel")},
                   timeout=300)
    out = proc.stdout
    assert proc.returncode == 0, out[-3000:] + proc.stderr[-2000:]
    assert "[rank 0] [chaos] rank 0: injecting hard-exit at step 3" in out
    assert "[launch] attempt failed (rc=13); restart 1" in out
    assert out.count("resumed from") == 2  # both ranks of attempt 2
    assert "at step 2 (epoch 0, iter 2)" in out
    assert "[launch] recovered after 1 restart(s)" in out
    assert out.count("Test set: average loss") == 2
    assert _digests(d, 4) == _digests(straight, 4)


def test_nan_grad_on_one_rank_is_skipped_on_both(tmp_path):
    """part2b, 2 processes: a NaN batch on rank 1 at step 2; the guard's
    flag is all-reduced, so both ranks skip step 2, and the replica check
    after every step finds the replicas bitwise equal."""
    proc = _launch(["part2b", "--nproc", "2", "--device", "cpu"],
                   {"TPU_DDP_MAX_ITERS": "3",
                    "TPU_DDP_CHAOS_FAULTS": "nan-grad@2:rank=1",
                    "TPU_DDP_CHECK_REPLICAS_EVERY": "1"}, timeout=300)
    out = proc.stdout
    assert proc.returncode == 0, out[-3000:] + proc.stderr[-2000:]
    assert "[rank 1] [chaos] rank 1: injecting nan-grad at step 2" in out
    for rank in (0, 1):
        assert (f"[rank {rank}] [guard] non-finite loss/grads at step 2: "
                "update skipped (1/3 consecutive)") in out
    assert out.count("[guard]") == 2
    losses = [ln.split("Test set: average loss ")[1].split(",")[0]
              for ln in out.splitlines() if "Test set:" in ln]
    assert len(losses) == 2 and losses[0] == losses[1] != "nan"


def test_stalled_step_is_killed_by_the_watchdog(tmp_path):
    """part1: a stall at step 2 (the sleep outlasts the run); the
    watchdog kills the attempt with exit 14 and the restart, past the
    sentinel, finishes from the step-1 checkpoint."""
    proc = _launch(["part1", "--nproc", "1", "--device", "cpu",
                    "--max-restarts", "1", "--min-restart-interval", "0",
                    "--heartbeat-timeout", "4",
                    "--ckpt-dir", str(tmp_path / "ck")],
                   {"TPU_DDP_MAX_ITERS": "3", "TPU_DDP_CKPT_EVERY": "1",
                    "TPU_DDP_CHAOS_FAULTS": "stalled-step@2",
                    "TPU_DDP_CHAOS_SENTINEL": str(tmp_path / "sentinel")},
                   timeout=300)
    out = proc.stdout
    assert proc.returncode == 0, out[-3000:] + proc.stderr[-2000:]
    assert "[launch] heartbeat stall: no step completed in 4s" in out
    assert f"[launch] attempt failed (stalled); restart 1" in out
    assert "at step 1 (epoch 0, iter 1)" in out
    assert "Test set: average loss" in out
    assert STALL_EXIT_CODE == 14
