"""The loop's host-side utilities of the port held to the JAX package's:
the JSONL metrics sink (utils/metrics.py), the MFU helpers
(utils/flops.py), the timing helpers (utils/timing.py), the collective
microbenchmark at world 2 over gloo (utils/collectives.py), the profiler
(utils/profiling.py), the env knobs of this slice (accepted and refused
as the JAX config does) and their wiring through the CLI
(parts/common.py).
"""

import glob
import json
import os

import pytest
import torch

from tpu_ddp.utils import flops as jflops
from tpu_ddp.utils import metrics as jmetrics
from tpu_ddp.utils import timing as jtiming
from tpu_ddp.utils.config import TrainConfig as JaxConfig
from tpu_ddp_torch.utils import flops, metrics, profiling, timing
from tpu_ddp_torch.utils.config import TrainConfig

import torch_ranks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- metrics -------------------------------------------------------------

def _drive(logger):
    logger.log("train_iter", epoch=0, iter=20, step=20, loss=1.25)
    logger.inc("step_skipped")
    logger.observe("host_gap_ms", 3.5)
    logger.observe("host_gap_ms", 1.5)
    logger.log("epoch", epoch=0, iters=40, forced_syncs=2)


def test_jsonl_lines_match_jax(tmp_path):
    paths = []
    for mod in (metrics, jmetrics):
        path = tmp_path / f"{mod.__name__}.jsonl"
        with mod.MetricsLogger(str(path), rank=3) as logger:
            assert logger.enabled
            _drive(logger)
            summary = logger.gauge_summary("host_gap_ms")
            assert logger.gauge_summary("missing") is None
            counters = dict(logger.counters)
        assert not logger.enabled
        paths.append((path, summary, counters))
    (p, s, c), (jp, js, jc) = paths
    assert s == js == {"count": 2, "total": 5.0, "max": 3.5, "last": 1.5,
                       "mean": 2.5}
    assert c == jc == {"step_skipped": 1}
    lines = [json.loads(ln) for ln in p.read_text().splitlines()]
    jlines = [json.loads(ln) for ln in jp.read_text().splitlines()]
    assert [list(ln) for ln in lines] == [list(ln) for ln in jlines]
    for ln, jln in zip(lines, jlines):
        ln.pop("ts"), jln.pop("ts")
        assert ln == jln
    assert lines[0] == {"rank": 3, "event": "train_iter", "epoch": 0,
                        "iter": 20, "step": 20, "loss": 1.25}


def test_no_path_writes_nothing_but_keeps_events(tmp_path):
    logger = metrics.MetricsLogger()
    _drive(logger)
    assert not logger.enabled
    assert [e["event"] for e in logger.events] == ["train_iter", "epoch"]
    logger.close()


def test_from_env_expands_the_rank(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_DDP_METRICS_FILE",
                       str(tmp_path / "sub" / "m_{rank}.jsonl"))
    for mod in (metrics, jmetrics):
        logger = mod.from_env(rank=2)
        assert logger.enabled and logger.rank == 2
        assert logger.path == str(tmp_path / "sub" / "m_2.jsonl")
        logger.close()
    monkeypatch.delenv("TPU_DDP_METRICS_FILE")
    assert not metrics.from_env().enabled


# ---- flops ---------------------------------------------------------------

class _JaxDevice:
    def __init__(self, platform, kind=""):
        self.platform = platform
        self.device_kind = kind


@pytest.mark.parametrize("peak,hbm", [(None, None), ("123.5", "456"),
                                      ("junk", "junk")])
def test_mfu_and_peaks_match_jax(monkeypatch, peak, hbm):
    for name, value in (("TPU_DDP_PEAK_TFLOPS", peak),
                        ("TPU_DDP_HBM_GBPS", hbm)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    jdev = _JaxDevice("cpu")
    got, want = flops.peak_tflops("cpu"), jflops.peak_tflops(jdev)
    assert got[0] == want[0]
    if peak is not None:
        assert got[1] == want[1]
    bw, src = flops.device_hbm_gbps("cpu")
    jbw, jsrc = jflops.device_hbm_gbps(jdev)
    if hbm == "456":
        assert (bw, src) == (jbw, jsrc) == (456.0, "env:TPU_DDP_HBM_GBPS")
    else:
        assert bw == 3350.0 and "FALLBACK" in src and "FALLBACK" in jsrc
    for fl, sec, xla in ((3.3e12, 0.021, None), (None, 0.5, 7e11),
                         (None, 0.5, None), (1e12, 0.0, None)):
        g = flops.mfu_fields(fl, sec, "cpu", xla_flops_per_step=xla)
        w = jflops.mfu_fields(fl, sec, jdev, xla_flops_per_step=xla)
        if peak is None:
            g.pop("peak_source"), w.pop("peak_source")
        assert g == w


def test_the_h100_entry(monkeypatch):
    """The card's table entry, read through torch.cuda.get_device_name:
    989 TFLOP/s and 3350 GB/s, the figures PERF.md divides by."""
    monkeypatch.delenv("TPU_DDP_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("TPU_DDP_HBM_GBPS", raising=False)
    for name, want in (("NVIDIA H100 80GB HBM3", (989.0, 3350.0)),
                       ("NVIDIA H100 PCIe", (756.0, 2000.0)),
                       ("NVIDIA GeForce RTX 4090", (None, 3350.0))):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda d=None, n=name: n)
        peak, _ = flops.peak_tflops("cuda:0")
        bw, _ = flops.device_hbm_gbps("cuda:0")
        assert (peak, bw) == want
    f = flops.mfu_fields(989e12 * 0.01 * 0.25, 0.01, "cuda:0")
    assert f["mfu"] is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert flops.mfu_fields(989e12 * 0.01 * 0.25, 0.01, "cuda:0")[
        "mfu"] == 0.25


# ---- timing --------------------------------------------------------------

def _fake_clock(monkeypatch, mod, ticks):
    it = iter(ticks)
    monkeypatch.setattr(mod.time, "perf_counter_ns", lambda: next(it))


@pytest.mark.parametrize("first,k", [(0, 4), (1, 4), (36, 8), (40, 2)])
def test_stop_many_matches_jax(monkeypatch, first, k):
    totals = []
    for mod, kw in ((timing, {"device": "cpu"}), (jtiming, {})):
        _fake_clock(monkeypatch, mod, [1000, 1000 + 4001 * k])
        t = mod.IterationTimer(1, 39, **kw)
        t.start()
        elapsed = t.stop_many(first, k)
        totals.append((elapsed, t.total_ns, t.count, t.average_ns))
    assert totals[0] == totals[1]


def test_timed_window_and_median_match_jax(monkeypatch):
    for mod in (timing, jtiming):
        with pytest.raises(ValueError):
            mod.timed_window_s(lambda: None, 0)
    calls, synced = [], []
    for mod in (timing, jtiming):
        calls.clear()
        synced.clear()
        med, samples = mod.warm_then_median_s(
            lambda: calls.append(1) or len(calls), iters=3, windows=4,
            warmup=2, sync=synced.append)
        assert len(calls) == 2 + 3 * 4 and len(samples) == 4
        assert synced == [2, 5, 8, 11, 14]
        assert sorted(samples)[1] <= med <= sorted(samples)[2]
    # The default sync waits on CPU tensors' devices: nothing to wait on.
    assert timing.timed_window_s(lambda: torch.zeros(2), 2) >= 0.0


# ---- collectives ---------------------------------------------------------

COLL_WORKER = r"""
import json, os, sys
import torch
from tpu_ddp_torch.parallel.bootstrap import init_distributed_setup
from tpu_ddp_torch.utils.collectives import bench_collectives
torch.set_num_threads(1)
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
init_distributed_setup("127.0.0.1", port, rank, 2, device="cpu", ddp=True,
                       timeout_s=90)
res = {dt: bench_collectives(mb=0.0625, iters=2, dtype=dt, check=True)
       for dt in ("float32", "bfloat16", "int8")}
if rank == 0:
    with open(out, "w") as fh:
        json.dump(res, fh)
torch.distributed.barrier()
sys.stdout.flush()
os._exit(0)
"""


def test_bench_collectives_at_world_two(tmp_path):
    """Every op of the JAX op set runs over a 2-rank gloo group, each
    output held to its value computed on the host (check=True), and
    the result has JAX's {op: {"ms", "gbps"}} shape."""
    out = tmp_path / "coll.json"
    port = str(torch_ranks.free_port())
    torch_ranks.run_ranks(lambda r: ["-c", COLL_WORKER, str(r), port,
                                     str(out)], 2)
    res = json.loads(out.read_text())
    for dt, ops in res.items():
        assert list(ops) == ["psum", "psum_scatter", "all_gather",
                             "ppermute", "all_to_all"], dt
        for op, v in ops.items():
            assert set(v) == {"ms", "gbps"} and v["ms"] > 0, (dt, op)


# ---- profiling -----------------------------------------------------------

def test_profile_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    with profiling.profile_trace(None):
        pass  # a no-op without a directory
    d = tmp_path / "prof"
    with profiling.profile_trace(str(d)):
        with profiling.annotate("region_of_interest"):
            torch.ones(64).sum()
    traces = glob.glob(str(d / "*.json"))
    assert len(traces) == 1
    assert "region_of_interest" in open(traces[0]).read()
    monkeypatch.setenv("TPU_DDP_PROFILE_DIR", str(d))
    assert profiling.profile_dir_from_env() == str(d)
    monkeypatch.setenv("TPU_DDP_PROFILE_DIR", "")
    assert profiling.profile_dir_from_env() is None


# ---- env knobs -----------------------------------------------------------

@pytest.mark.parametrize("name,field,value", [
    ("TPU_DDP_DISPATCH_DEPTH", "dispatch_depth", "0"),
    ("TPU_DDP_DISPATCH_DEPTH", "dispatch_depth", "7"),
    ("TPU_DDP_DISPATCH_DEPTH", "dispatch_depth", "-2"),
    ("TPU_DDP_DISPATCH_DEPTH", "dispatch_depth", "two"),
    ("TPU_DDP_STEPS_PER_DISPATCH", "steps_per_dispatch", "8"),
    ("TPU_DDP_STEPS_PER_DISPATCH", "steps_per_dispatch", "0"),
    ("TPU_DDP_STEPS_PER_DISPATCH", "steps_per_dispatch", "x"),
    ("TPU_DDP_PREFETCH", "device_prefetch", "3"),
    ("TPU_DDP_PREFETCH", "device_prefetch", "1.5"),
])
def test_env_knobs_accepted_and_refused_as_in_jax(monkeypatch, name, field,
                                                  value):
    monkeypatch.setenv(name, value)
    outcomes = []
    for cls in (TrainConfig, JaxConfig):
        try:
            outcomes.append(("ok", getattr(cls(), field)))
        except ValueError as e:
            outcomes.append(("ValueError", "dispatch_depth" in str(e)))
    assert outcomes[0] == outcomes[1]
    defaults = (TrainConfig.__dataclass_fields__[field].default,
                JaxConfig.__dataclass_fields__[field].default)
    assert defaults[0] == defaults[1]


def test_negative_depth_field_refused_as_in_jax():
    for cls in (TrainConfig, JaxConfig):
        with pytest.raises(ValueError, match="dispatch_depth"):
            cls(dispatch_depth=-1)


# ---- the CLI -------------------------------------------------------------

def test_cli_wires_metrics_profile_native_and_window(tmp_path, monkeypatch,
                                                     capsys):
    """part 1 on the CPU with every knob of this slice set: the JSONL
    file holds the epoch's window stats, the profile directory a trace,
    and the native loader and K = 2 steps per dispatch train (shard eval
    stays off at world 1, as in the JAX CLI)."""
    from tpu_ddp_torch.parts.common import run_part
    for name, value in (("TPU_DDP_MAX_ITERS", "4"),
                        ("TPU_DDP_SYNTH_SIZE", "64"),
                        ("TPU_DDP_GLOBAL_BATCH", "16"),
                        ("TPU_DDP_COMPUTE_DTYPE", "float32"),
                        ("TPU_DDP_NATIVE_LOADER", "1"),
                        ("TPU_DDP_SHARD_EVAL", "1"),
                        ("TPU_DDP_STEPS_PER_DISPATCH", "2"),
                        ("TPU_DDP_DISPATCH_DEPTH", "4"),
                        ("TPU_DDP_METRICS_FILE",
                         str(tmp_path / "m_{rank}.jsonl")),
                        ("TPU_DDP_PROFILE_DIR", str(tmp_path / "prof"))):
        monkeypatch.setenv(name, value)
    assert run_part("part1", ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Test set: average loss" in out and "/64 (" in out
    lines = [json.loads(ln) for ln in
             (tmp_path / "m_0.jsonl").read_text().splitlines()]
    epoch = [ln for ln in lines if ln["event"] == "epoch"]
    assert len(epoch) == 1 and epoch[0]["iters"] == 4
    assert epoch[0]["dispatch_depth"] == 2  # 4 // K groups in flight
    assert epoch[0]["harvested"] == 2       # two groups
    assert [ln["event"] for ln in lines][-1] == "eval"
    assert len(os.listdir(tmp_path / "prof")) == 1
