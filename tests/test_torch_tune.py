"""The port's autotuner (tpu_ddp_torch/tune/) held to tpu_ddp/tune/.

The constraint model and the search are held to the JAX package's on the
same inputs (a grid of knob assignments x workloads; the same fake
``evaluate``), the cache, ``resolve`` and the search space are tested as
the JAX suite tests its own, and a real search runs through
``TrialRunner`` on a narrow VGG on the CPU. Two deliberate departures
are tested too: the trainer cache is keyed on every field a trainer
reads at construction, and only failures that are a property of a cell
(out of memory, divergence, timeout) are quarantined.
"""

import ast
import dataclasses
import itertools
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import tpu_ddp.tune as jtune
from tpu_ddp.tune import search as jsearch
from tpu_ddp.tune import space as jspace
from tpu_ddp.utils.config import TrainConfig as JaxConfig
from tpu_ddp_torch import launch
from tpu_ddp_torch import tune
from tpu_ddp_torch.resilience.guard import TrainingDivergedError
from tpu_ddp_torch.tune import cache as tcache
from tpu_ddp_torch.tune import runner as trunner
from tpu_ddp_torch.tune import space as tspace
from tpu_ddp_torch.tune.search import run_search
from tpu_ddp_torch.tune.space import (KNOBS, Workload, fingerprint_for,
                                      parse_knob_filter, searchable_knobs,
                                      violations, workload_for)
from tpu_ddp_torch.utils.config import TrainConfig

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from torch_ranks import REPO, free_port, run_ranks  # noqa: E402

CPU1 = Workload(platform="cpu", dp=1, processes=1, strategy="fused",
                collective_cadence=False)
JCPU1 = jspace.Workload(platform="cpu", dp=1, processes=1,
                        strategy="fused", collective_cadence=False)
# A narrow VGG for the trials on the CPU: every knob of the search reaches
# it (BN+ReLU sites, conv stages for remat) at a few ms per step.
NARROW = (8, "M", 16, "M", 16, "M", 16, "M", 16, "M")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test files run in parallel worker processes; torch's own thread
    pool on top of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def clean(monkeypatch):
    for key in list(os.environ):
        if key.startswith("TPU_DDP_"):
            monkeypatch.delenv(key)
    return monkeypatch


@pytest.fixture()
def cfg(clean):
    return TrainConfig()


@pytest.fixture()
def cache_dir(tmp_path, clean):
    d = tmp_path / "tune"
    clean.setenv("TPU_DDP_TUNE_CACHE_DIR", str(d))
    return d


def _narrow_model(name, **kw):
    from tpu_ddp_torch.models.vgg import VGGModel
    return VGGModel("narrow", NARROW, **kw)


@pytest.fixture()
def narrow(clean):
    """``get_model`` builds the narrow VGG whatever the config names."""
    import tpu_ddp_torch.models as models
    clean.setattr(models, "get_model", _narrow_model)
    return clean


def _small_cfg(**kw):
    return TrainConfig(global_batch_size=4, compute_dtype="float32", **kw)


# ------------------------------------------------- (a) violations parity

def _kernel_rule(reason: str) -> str:
    """The kernel rule is the one rule whose wording differs: the JAX
    package requires the TPU backend, the port the CUDA backend."""
    m = re.match(r"(pallas_sgd|pallas_bn)=True requires the "
                 r"(TPU|CUDA) backend", reason)
    return f"{m.group(1)}=True: kernel backend" if m else reason


def _assignments() -> list:
    """Every ported knob alone at each candidate value, then every pair
    of knobs of one objective at each pair of values."""
    knobs = [k for k in KNOBS if k.values]
    out = [{}]
    out += [{k.field: v} for k in knobs for v in k.values]
    for a, b in itertools.combinations(knobs, 2):
        if a.objective != b.objective:
            continue
        out += [{a.field: va, b.field: vb}
                for va in a.values for vb in b.values]
    return out


RUNGS = ("none", "gather_scatter", "all_reduce", "fused", "zero", "fsdp")


@pytest.mark.parametrize("platform,dp,processes", [
    (p, dp, n) for p in ("cpu", "card") for dp in (1, 2, 4)
    for n in (1, 2)])
def test_violations_match_jax(platform, dp, processes):
    """Each assignment of the ported knobs under each workload gets the
    JAX package's reasons, the platforms mapped "tpu" <-> "cuda"; only
    the kernel rule's wording differs."""
    port_plat, jax_plat = (("cuda", "tpu") if platform == "card"
                           else ("cpu", "cpu"))
    assignments = _assignments()
    assert len(assignments) > 500
    kernel_fired = 0
    for rung, cadence, family in itertools.product(
            RUNGS, (False, True), ("conv", "attn")):
        common = dict(dp=dp, processes=processes, strategy=rung,
                      collective_cadence=cadence, model_family=family)
        tctx = Workload(platform=port_plat, **common)
        jctx = jspace.Workload(platform=jax_plat, **common)
        for a in assignments:
            got = [_kernel_rule(r) for r in violations(a, tctx)]
            want = [_kernel_rule(r) for r in jspace.violations(a, jctx)]
            assert got == want, (a, common)
            kernel_fired += sum("kernel backend" in r for r in got)
    assert (kernel_fired > 0) == (platform == "cpu")


@pytest.mark.parametrize("pp,layers", [(2, 0), (2, 4), (4, 6), (4, 12)])
def test_pipeline_violations_match_jax(pp, layers):
    """In a pipeline context (pp > 1, with and without the model's layer
    count) every combination of the three pipeline knobs gets the JAX
    package's reasons."""
    pipe = [k for k in KNOBS if k.field.startswith("pp_")]
    assert len(pipe) == 3
    common = dict(platform="cpu", dp=2, processes=2 * pp, pp=pp,
                  model_layers=layers)
    tctx, jctx = Workload(**common), jspace.Workload(**common)
    fired = 0
    for values in itertools.product(*(k.values for k in pipe)):
        a = {k.field: v for k, v in zip(pipe, values)}
        got = violations(a, tctx)
        assert got == jspace.violations(a, jctx), (a, common)
        fired += bool(got)
    assert 0 < fired < 4 * 4 * 3


# ------------------------------------------------- (b) run_search parity

def _knobs_of(space_mod, spec):
    """``[(knob, candidates)]`` of a package for ``spec`` (field ->
    candidates, current value first)."""
    return [(space_mod.knob_by_field(f), tuple(c)) for f, c in spec]


def _eval_grid(a, fidelity):
    sps = 10.0 + (2 if a.get("dispatch_depth") == 4 else 0) \
        + (1 if a.get("device_prefetch") == 2 else 0)
    return sps, None


def _eval_descent(a, fidelity):
    # remat="blocks" gains less than epsilon: the descent keeps "none",
    # the confirm rung takes "blocks" among its finalists.
    sps = 10.0 + {0: 3, 1: 1, 2: 0, 4: 2}[a.get("dispatch_depth", 2)] \
        + {1: 0, 4: 2, 8: 1}[a.get("steps_per_dispatch", 1)] \
        + (0.2 if a.get("remat") == "blocks" else 0)
    return sps, None


def _eval_flat(a, fidelity):
    return 10.0, None


def _eval_quarantine(a, fidelity):
    d = a.get("dispatch_depth", 2)
    if d == 4:
        return None, "quarantined: OutOfMemoryError: boom"
    if d == 1:
        return None, "constraint: known-invalid"
    return 10.0 + (1.0 if d == 0 else 0.0), None


def _eval_guard(a, fidelity):
    d = a.get("dispatch_depth", 2)
    if fidelity == "short":
        return (12.0 if d == 0 else 10.0), None
    return (9.0 if d == 0 else 10.0), None


def _eval_infeasible(a, fidelity):
    return None, "quarantined: OutOfMemoryError"


TWO = [("dispatch_depth", (2, 0, 1, 4)), ("device_prefetch", (0, 2))]
THREE = [("dispatch_depth", (2, 0, 1, 4)), ("steps_per_dispatch", (1, 4, 8)),
         ("remat", ("none", "blocks", "conv_stages"))]
SEARCH_CASES = {
    "grid_two_knobs": (TWO, _eval_grid),
    "descent_three_knobs": (THREE, _eval_descent),
    "memoised": (THREE, _eval_flat),
    "quarantined_vs_infeasible": (TWO, _eval_quarantine),
    "regression_guard": (TWO, _eval_guard),
    "all_infeasible": (TWO, _eval_infeasible),
    "empty_space": ([], _eval_flat),
}


@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_run_search_matches_jax(case):
    """On the same deterministic evaluate both packages measure the same
    cells in the same order and return the same dict, field for field."""
    spec, evaluate = SEARCH_CASES[case]
    out = {}
    for name, space_mod, search in (("port", tspace, run_search),
                                    ("jax", jspace, jsearch.run_search)):
        calls, logs = [], []

        def ev(a, fidelity):
            calls.append((tuple(sorted(a.items())), fidelity))
            return evaluate(a, fidelity)

        knobs = _knobs_of(space_mod, spec)
        base = {k.field: c[0] for k, c in knobs}
        out[name] = (search(knobs, ev, base, log=logs.append), calls, logs)
    assert out["port"] == out["jax"]
    result, calls, _ = out["port"]
    assert len(calls) == len(set(calls))  # memoised: no cell twice
    assert result["mode"] == {0: "empty", 2: "grid"}.get(len(spec),
                                                         "coordinate_descent")
    if case == "grid_two_knobs":
        assert result["overrides"] == {"dispatch_depth": 4,
                                       "device_prefetch": 2}
    if case == "descent_three_knobs":
        assert result["overrides"] == {"dispatch_depth": 0,
                                       "steps_per_dispatch": 4,
                                       "remat": "blocks"}
    if case in ("regression_guard", "all_infeasible", "memoised"):
        assert result["overrides"] == {}
    if case == "quarantined_vs_infeasible":
        assert result["quarantined"] >= 1
        assert result["trials"] == sum(
            1 for h in result["history"] if h["reason"] is None
            or h["reason"].startswith("quarantined"))


# ------------------------------------------------ (c) searchable_knobs

def test_cpu_space_is_jaxs_and_the_card_adds_the_kernels(cfg):
    """Single-process VGG-11 on the CPU searches JAX's four schedule
    knobs with JAX's candidates; on the card the two kernel knobs join
    them (the JAX package leaves those to the TPU)."""
    port = [(k.name, c) for k, c in searchable_knobs(cfg, CPU1)]
    jax_ = [(k.name, c) for k, c in jspace.searchable_knobs(JaxConfig(),
                                                           JCPU1)]
    assert port == jax_
    assert {n for n, _ in port} == {"dispatch_depth", "steps_per_dispatch",
                                    "device_prefetch", "remat"}
    card = dataclasses.replace(CPU1, platform="cuda")
    names = {k.name for k, _ in searchable_knobs(cfg, card)}
    assert names == {"dispatch_depth", "steps_per_dispatch",
                     "device_prefetch", "remat", "pallas_sgd", "pallas_bn"}
    tpu = dataclasses.replace(JCPU1, platform="tpu")
    assert names == {k.name for k, _ in jspace.searchable_knobs(
        JaxConfig(), tpu)}


def test_current_value_first_semantic_gate_and_env_pin(cfg, clean):
    cfg.dispatch_depth = 4
    for knob, cands in searchable_knobs(cfg, CPU1):
        assert cands[0] == getattr(cfg, knob.field)
    assert "compute_dtype" not in {k.name for k, _ in
                                   searchable_knobs(cfg, CPU1)}
    clean.setenv("TPU_DDP_TUNE_SEMANTIC", "1")
    gated = {k.name for k, _ in searchable_knobs(cfg, CPU1)}
    assert {"compute_dtype", "act_dtype"} <= gated
    assert "global_batch_size" not in gated
    clean.delenv("TPU_DDP_TUNE_SEMANTIC")
    clean.setenv("TPU_DDP_DISPATCH_DEPTH", "4")
    assert "dispatch_depth" not in {k.name for k, _ in
                                    searchable_knobs(cfg, CPU1)}


def test_knob_filter(cfg, clean):
    assert parse_knob_filter("dispatch_depth=0|2, steps_per_dispatch") == \
        {"dispatch_depth": (0, 2), "steps_per_dispatch": None}
    assert parse_knob_filter("pallas_bn=1|0") == {"pallas_bn": (True, False)}
    assert parse_knob_filter("") is None
    with pytest.raises(ValueError, match="unknown knob"):
        parse_knob_filter("warp_speed")
    clean.setenv("TPU_DDP_TUNE_KNOBS", "dispatch_depth=0|2,device_prefetch")
    space = dict((k.name, c) for k, c in searchable_knobs(cfg, CPU1))
    assert set(space) == {"dispatch_depth", "device_prefetch"}
    assert space["dispatch_depth"] == (2, 0)  # current first


def test_workload_and_fingerprint_read_the_runtime(cfg):
    ctx = workload_for(cfg, "part3", device="cpu")
    assert (ctx.platform, ctx.dp, ctx.processes, ctx.strategy,
            ctx.model_family, ctx.pp, ctx.ep) == ("cpu", 1, 1, "fused",
                                                  "conv", 1, 1)
    cfg.check_replicas_every = 5
    assert workload_for(cfg, "fused", device="cpu").collective_cadence
    lm = workload_for(TrainConfig(model="TransformerLM-tiny"), "none",
                      device="cpu")
    assert (lm.model_family, lm.model_layers) == ("attn", 2)
    fp = fingerprint_for(TrainConfig(), "fused", device="cpu")
    assert fp.key() == fingerprint_for(TrainConfig(), "fused",
                                       device="cpu").key()
    assert (fp.mesh_shape, fp.platform, fp.device_kind, fp.cuda_version,
            fp.torch_version) == ("none", "cpu", "cpu",
                                  torch.version.cuda or "none",
                                  torch.__version__)
    for other in (fingerprint_for(TrainConfig(global_batch_size=512),
                                  "fused", device="cpu"),
                  fingerprint_for(TrainConfig(), "zero", device="cpu")):
        assert other.key() != fp.key()


# -------------------------------------------------- (d) cache lifecycle

def _fp(**kw):
    return fingerprint_for(TrainConfig(**kw), "fused", device="cpu")


def test_cache_store_then_hit_and_absent(cache_dir):
    fp = _fp()
    assert tcache.load(fp) is None
    path = tcache.store(fp, {"dispatch_depth": 4}, meta={"trials": 7})
    assert path.startswith(str(cache_dir))
    assert tcache.load(fp) == {"overrides": {"dispatch_depth": 4},
                               "meta": {"trials": 7}, "path": path}


def test_cache_default_dir_is_the_ports_own(clean):
    d = tcache.cache_dir()
    assert d.endswith(os.path.join(".cache", "tpu_ddp_torch", "tune"))
    assert d != os.path.join(os.path.expanduser("~"), ".cache", "tpu_ddp",
                             "tune")


def test_cache_corrupt_entries_are_quarantined_never_overwritten(cache_dir):
    fp = _fp()
    for _ in range(2):
        path = tcache.store(fp, {})
        with open(path, "w") as f:
            f.write("{truncated")
        with pytest.warns(UserWarning, match="corrupt"):
            assert tcache.load(fp) is None
        assert not os.path.exists(path)
    assert os.path.exists(path + ".corrupt")
    assert os.path.exists(path + ".corrupt-2")


def test_cache_fingerprint_mismatch_is_quarantined(cache_dir):
    fp_a, fp_b = _fp(), _fp(global_batch_size=512)
    src = tcache.store(fp_a, {"dispatch_depth": 0})
    os.replace(src, tcache.entry_path(fp_b))
    with pytest.warns(UserWarning, match="different fingerprint"):
        assert tcache.load(fp_b) is None
    assert os.path.exists(tcache.entry_path(fp_b) + ".corrupt")


def test_cache_schema_bump_is_a_soft_miss(cache_dir):
    fp = _fp()
    path = tcache.store(fp, {"dispatch_depth": 0})
    with open(path) as f:
        payload = json.load(f)
    payload["schema_version"] = tcache.SCHEMA_VERSION + 1
    with open(path, "w") as f:
        json.dump(payload, f)
    assert tcache.load(fp) is None
    assert os.path.exists(path) and not os.path.exists(path + ".corrupt")


def test_cache_unknown_override_keys_are_quarantined(cache_dir):
    fp = _fp()
    # A JAX knob the port does not carry is as unknown as a retired one.
    for key in ("retired_knob", "fleet_roles"):
        path = tcache.store(fp, {key: 3})
        with pytest.warns(UserWarning, match="outside the knob registry"):
            assert tcache.load(fp) is None
        assert os.path.exists(path + ".corrupt")
        os.remove(path + ".corrupt")


def test_cache_schema_matches_jax(cache_dir):
    """The same payload keys and schema version as the JAX cache."""
    fp = _fp()
    with open(tcache.store(fp, {"remat": "blocks"}, meta={"x": 1})) as f:
        payload = json.load(f)
    assert set(payload) == {"schema_version", "fingerprint", "overrides",
                            "meta"}
    assert payload["schema_version"] == jtune.tune_cache.SCHEMA_VERSION
    assert set(payload["fingerprint"]) == set(dataclasses.asdict(fp))


# ---------------------------------------------------------- (e) resolve

class FakeRunner:
    """Depth 0 measures fastest; nothing is built."""

    def __init__(self, *a, **kw):
        self.trials = 0

    def evaluate(self, assignment, fidelity="short"):
        self.trials += 1
        return 10.0 + (5.0 if assignment.get("dispatch_depth", 2) == 0
                       else 0.0), None


def test_resolve_cached_with_an_empty_cache(cfg, cache_dir):
    cfg.autotune = "cached"
    lines = []
    out = tune.resolve(cfg, strategy="fused", device="cpu",
                       log=lines.append)
    assert out.autotune == "off" and out.dispatch_depth == cfg.dispatch_depth
    assert any("cached mode: no entry" in ln for ln in lines)


def test_resolve_applies_a_cached_entry(cfg, cache_dir):
    tcache.store(fingerprint_for(cfg, "fused", device="cpu"),
                 {"dispatch_depth": 0, "steps_per_dispatch": 8})
    cfg.autotune = "cached"
    lines = []
    out = tune.resolve(cfg, strategy="fused", device="cpu",
                       log=lines.append)
    assert (out.dispatch_depth, out.steps_per_dispatch) == (0, 8)
    assert any("cache hit: trials=0" in ln for ln in lines)
    assert cfg.dispatch_depth == 2  # the original is never mutated


def test_resolve_env_pin_beats_a_cached_override(cfg, cache_dir, clean):
    tcache.store(fingerprint_for(cfg, "fused", device="cpu"),
                 {"dispatch_depth": 0})
    clean.setenv("TPU_DDP_DISPATCH_DEPTH", "4")
    pinned = TrainConfig()
    pinned.autotune = "cached"
    lines = []
    out = tune.resolve(pinned, strategy="fused", device="cpu",
                       log=lines.append)
    assert out.dispatch_depth == 4
    assert any("pins the knob" in ln for ln in lines)


def test_model_built_drops_the_model_level_fields(cfg):
    out = tune.apply_overrides(cfg, {"pallas_bn": True, "compute_dtype":
                                     "float32", "dispatch_depth": 0},
                               model_built=True, log=lambda s: None)
    assert (out.pallas_bn, out.compute_dtype, out.dispatch_depth) == \
        (False, "bfloat16", 0)
    assert tune.apply_overrides(cfg, {"pallas_bn": True},
                                log=lambda s: None).pallas_bn is True


def test_apply_does_not_rerun_post_init(clean):
    clean.setenv("TPU_DDP_AUTOTUNE", "search")
    cfg = TrainConfig()
    assert cfg.autotune == "search"
    out = tune.apply_overrides(cfg, {"dispatch_depth": 1},
                               log=lambda s: None)
    assert out.autotune == "off" and out.dispatch_depth == 1


def test_resolve_search_through_a_fake_runner_writes_the_cache(
        cfg, cache_dir, clean):
    clean.setattr(tune, "TrialRunner", FakeRunner)
    cfg.autotune = "search"
    lines = []
    out = tune.resolve(cfg, strategy="fused", device="cpu",
                       log=lines.append)
    assert out.dispatch_depth == 0
    search = [ln for ln in lines if ln.startswith("[autotune] search:")]
    assert len(search) == 1 and 'overrides={"dispatch_depth": 0}' in \
        search[0]
    again = TrainConfig()
    again.autotune = "search"
    lines = []
    assert tune.resolve(again, strategy="fused", device="cpu",
                        log=lines.append).dispatch_depth == 0
    assert any("cache hit: trials=0" in ln for ln in lines)


def test_trainer_fallback_hook_drops_model_level_fields(cache_dir, narrow):
    """A Trainer built with TPU_DDP_AUTOTUNE=cached applies the cached
    entry's schedule and memory knobs before the memory policy (the
    model takes the tuned remat) and drops pallas_bn, which get_model
    already fixed."""
    from tpu_ddp_torch.train.engine import Trainer
    cfg = _small_cfg()
    tcache.store(fingerprint_for(cfg, "none", device="cpu"),
                 {"pallas_bn": True, "remat": "conv_stages",
                  "dispatch_depth": 0})
    narrow.setenv("TPU_DDP_AUTOTUNE", "cached")
    tr = Trainer(_narrow_model("VGG11", compute_dtype=torch.float32),
                 _small_cfg(), device="cpu")
    assert (tr.config.autotune, tr.config.pallas_bn, tr.config.remat,
            tr.config.dispatch_depth) == ("off", False, "conv_stages", 0)
    assert tr.model.remat == "conv_stages" and not tr.model.use_pallas_bn


# ----------------------------------- (f) a real search on the CPU, cached

def test_real_search_then_cached_hit(cache_dir, narrow):
    """TPU_DDP_AUTOTUNE=search on the CPU runs measured trials through
    TrialRunner (the narrow VGG, 4 batches per epoch), stores the winner,
    and a second resolve in cached mode hits it with 0 trials; each
    epoch path (K = 1, 4, 8) of a trainer is warmed once."""
    narrow.setenv("TPU_DDP_TUNE_ITERS", "4")
    narrow.setenv("TPU_DDP_TUNE_WINDOWS", "2")
    made = []
    real = trunner.TrialRunner

    class Recording(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    narrow.setattr(tune, "TrialRunner", Recording)
    cfg = _small_cfg()
    cfg.autotune = "search"
    lines = []
    tuned = tune.resolve(cfg, strategy="none", device="cpu",
                         log=lines.append)
    search = [ln for ln in lines if ln.startswith("[autotune] search:")]
    assert len(search) == 1
    n = int(re.search(r"trials=(\d+)", search[0]).group(1))
    assert n >= 8 and "quarantined=0" in search[0]
    runner = made[0]
    assert runner.trials == n and not runner.quarantined
    assert len(runner.host_batches) == 4
    x, y = runner.host_batches[0]
    assert x.shape == (4, 3, 32, 32) and x.dtype == torch.float32
    assert x.is_contiguous(memory_format=torch.channels_last)
    assert y.dtype == torch.int64
    ks = {k for (_, k) in runner._warmed}
    assert ks == {1, 4, 8}
    # The remat cells built their own trainers: one per remat value.
    assert {key[trunner.BUILD_FIELDS.index("remat")]
            for key in runner._trainers} == {"none", "blocks",
                                             "conv_stages"}
    again = _small_cfg()
    again.autotune = "cached"
    lines = []
    hit = tune.resolve(again, strategy="none", device="cpu",
                       log=lines.append)
    assert any("cache hit: trials=0" in ln for ln in lines)
    for knob in KNOBS:
        assert getattr(hit, knob.field) == getattr(tuned, knob.field)


def test_tuned_vs_default_brings_up_its_own_group_of_one(narrow):
    """Without a process group, ``tuned_vs_default`` searches a syncing
    rung over a group of one it makes and tears down, and reports what
    JAX's reports; the persistent cache is not touched."""
    import torch.distributed as dist
    narrow.setenv("TPU_DDP_GLOBAL_BATCH", "4")
    narrow.setenv("TPU_DDP_COMPUTE_DTYPE", "float32")
    narrow.setenv("TPU_DDP_TUNE_CACHE_DIR", "/nonexistent/tune")
    narrow.setenv("TPU_DDP_TUNE_KNOBS", "steps_per_dispatch=1|4")
    res = tune.tuned_vs_default("vgg11_cifar10", strategy="part3",
                                device="cpu", n_batches=4)
    assert not dist.is_initialized()
    assert set(res) == {"config", "searched_knobs", "overrides",
                        "default_steps_per_sec", "tuned_steps_per_sec",
                        "trials", "quarantined", "mode", "wall_s",
                        "fingerprint"}
    assert (res["mode"], res["searched_knobs"], res["quarantined"]) == (
        "grid", ["steps_per_dispatch"], 0)
    assert res["tuned_steps_per_sec"] >= res["default_steps_per_sec"] > 0
    fp = res["fingerprint"]
    assert (fp["mesh_shape"], fp["strategy"], fp["processes"]) == (
        "dp=1", "fused", 1)
    assert not os.path.exists("/nonexistent/tune")


# ------------------------------------------------ (g) the trainer cache

def test_remat_trial_builds_its_own_trainer(narrow):
    """A remat="conv_stages" trial after the default builds a new
    trainer whose model carries that policy (the JAX runner's key leaves
    remat out, so there both cells share one trainer)."""
    cfg = _small_cfg()
    runner = trunner.TrialRunner(cfg, dataclasses.replace(
        CPU1, strategy="none"), strategy="none", device="cpu", n_batches=2)
    default, _ = runner.trainer_for({})
    remat, _ = runner.trainer_for({"remat": "conv_stages"})
    assert remat is not default
    assert (default.model.remat, remat.model.remat) == ("none",
                                                        "conv_stages")
    assert runner.trainer_for({"remat": "conv_stages",
                               "steps_per_dispatch": 4})[0] is remat
    for f in ("remat", "act_dtype", "overlap", "bucket_mb", "pallas_sgd",
              "pallas_bn", "compute_dtype", "grad_compress"):
        assert f in trunner.BUILD_FIELDS, f
    assert set(trunner.BUILD_FIELDS).isdisjoint(trunner.LOOP_FIELDS)
    for sps, reason in (runner.evaluate({}),
                        runner.evaluate({"remat": "conv_stages"})):
        assert sps > 0 and reason is None
    assert len(runner._trainers) == 2
    # The JAX runner's key: the same for both cells.
    jrunner = jtune.runner.TrialRunner(JaxConfig(global_batch_size=4),
                                       JCPU1, n_batches=1)
    assert jrunner._jit_key({"remat": "conv_stages"}) == jrunner._jit_key({})


RANK_WORKER = r"""
import json, os, sys
import torch
torch.set_num_threads(1)
import tpu_ddp_torch.models as models
from tpu_ddp_torch.models.vgg import VGGModel
models.get_model = lambda name, **kw: VGGModel(
    "narrow", (16, "M", 32, "M", 64, "M", 128, "M", 256, "M"), **kw)
from tpu_ddp_torch import tune
from tpu_ddp_torch.parallel.bootstrap import init_distributed_setup
from tpu_ddp_torch.tune.runner import TrialRunner
from tpu_ddp_torch.tune.space import workload_for
from tpu_ddp_torch.utils.config import TrainConfig

port, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
init_distributed_setup("127.0.0.1", port, rank, 2, device="cpu", ddp=True,
                       timeout_s=90)
cfg = TrainConfig(global_batch_size=8, compute_dtype="float32")
ctx = workload_for(cfg, "fused", device="cpu")
runner = TrialRunner(cfg, ctx, strategy="fused", device="cpu", n_batches=2)
rec = {"dp": ctx.dp, "processes": ctx.processes, "trainers": {}}
for label, a in (("default", {}), ("overlap", {"overlap": True}),
                 ("overlap_1mb", {"overlap": True, "bucket_mb": 1})):
    tr, _ = runner.trainer_for(a)
    plan = tr._overlap.plan if tr._overlap is not None else None
    rec["trainers"][label] = {
        "id": id(tr), "ddp": tr.net is not tr.model,
        "bucket_mb": plan.bucket_mb if plan else None,
        "n_buckets": plan.n_buckets if plan else None}
sps, reason = runner.evaluate({"overlap": True, "bucket_mb": 1})
rec["overlap_trial"] = [sps, reason]
rec["cached_trainers"] = len(runner._trainers)
lines = []
cfg2 = TrainConfig(global_batch_size=8, compute_dtype="float32")
cfg2.autotune = "search"
os.environ["TPU_DDP_TUNE_CACHE_DIR"] = out + ".cache"
res = tune.resolve(cfg2, strategy="fused", device="cpu", log=lines.append)
rec["refusal"] = lines
rec["resolved"] = {"autotune": res.autotune,
                   "dispatch_depth": res.dispatch_depth,
                   "steps_per_dispatch": res.steps_per_dispatch}
with open(f"{out}.{rank}.json", "w") as f:
    json.dump(rec, f)
torch.distributed.barrier()
sys.stdout.flush()
os._exit(0)
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks of a 2-process gloo group: their trial trainers under
    overlap and bucket_mb, and resolve(search) refused."""
    out = str(tmp_path_factory.mktemp("tune_ranks") / "rec")
    port = str(free_port())
    run_ranks(lambda r: ["-c", RANK_WORKER, port, str(r), out], 2,
              timeout=120)
    recs = []
    for r in range(2):
        with open(f"{out}.{r}.json") as f:
            recs.append(json.load(f))
    return recs


def test_overlap_and_bucket_mb_trials_build_their_own_trainers(two_ranks):
    for rec in two_ranks:
        assert (rec["dp"], rec["processes"]) == (2, 2)
        t = rec["trainers"]
        assert len({v["id"] for v in t.values()}) == 3
        assert t["default"]["ddp"] and t["default"]["bucket_mb"] is None
        assert (t["overlap"]["bucket_mb"], t["overlap_1mb"]["bucket_mb"]) \
            == (25, 1)
        assert t["overlap"]["n_buckets"] == 1
        assert t["overlap_1mb"]["n_buckets"] > 1
        sps, reason = rec["overlap_trial"]
        assert sps > 0 and reason is None
        assert rec["cached_trainers"] == 3


def test_multi_process_search_is_refused(two_ranks):
    """(i) At 2 ranks a search is refused with the JAX log line and the
    defaults are applied."""
    for rec in two_ranks:
        assert any(ln.startswith("[autotune] search mode refused under "
                                 "multi-process (process_count=2)")
                   for ln in rec["refusal"]), rec["refusal"]
        assert rec["resolved"] == {"autotune": "off", "dispatch_depth": 2,
                                   "steps_per_dispatch": 1}


# ------------------------------------------------ (h) narrow quarantine

@pytest.mark.parametrize("exc,quarantined", [
    (RuntimeError("nvcc: kernel build failed"), False),
    (NotImplementedError("the card refused to capture"), False),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), True),
    (TimeoutError("warm epoch blew the budget"), True),
    (TrainingDivergedError("3 consecutive non-finite steps"), True)])
def test_only_cell_failures_are_quarantined(narrow, exc, quarantined):
    """Out of memory, divergence and a timeout are properties of the
    cell: quarantined, and the search goes on. Anything else (a kernel
    that does not build or launch, a capture the card refuses) is the
    program's fault and propagates out of evaluate."""
    runner = trunner.TrialRunner(_small_cfg(), dataclasses.replace(
        CPU1, strategy="none"), strategy="none", device="cpu", n_batches=1)

    def boom(assignment):
        raise exc

    narrow.setattr(runner, "trainer_for", boom)
    if not quarantined:
        with pytest.raises(type(exc)):
            runner.evaluate({"remat": "blocks"})
        assert not runner.quarantined
        return
    sps, reason = runner.evaluate({"remat": "blocks"})
    assert sps is None and reason.startswith(
        f"quarantined: {type(exc).__name__}")
    assert runner.quarantined == [{"assignment": {"remat": "blocks"},
                                   "reason": reason}]


def test_infeasible_cells_and_the_budget_are_not_trials(narrow):
    runner = trunner.TrialRunner(_small_cfg(), dataclasses.replace(
        CPU1, strategy="none"), strategy="none", device="cpu", n_batches=1,
        max_trials=1)
    sps, reason = runner.evaluate({"pallas_bn": True})
    assert sps is None and "requires the CUDA backend" in reason
    assert runner.trials == 0
    assert runner.evaluate({})[0] > 0
    assert runner.evaluate({"remat": "blocks"}) == (
        None, "budget: max_trials=1 reached")


# ------------------------------------------ (j) the CLI and the launcher

def test_part1_cli_with_cached_mode_logs_the_miss_and_trains(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPU_DDP_")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               TPU_DDP_AUTOTUNE="cached",
               TPU_DDP_TUNE_CACHE_DIR=str(tmp_path / "tune"),
               TPU_DDP_MAX_ITERS="2", TPU_DDP_SYNTH_SIZE="64",
               TPU_DDP_GLOBAL_BATCH="16", TPU_DDP_COMPUTE_DTYPE="float32")
    res = subprocess.run(
        [sys.executable, "-m", "tpu_ddp_torch.parts", "part1", "--device",
         "cpu"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-3000:]
    assert "[autotune] cached mode: no entry for" in out
    assert "[part1] strategy=none" in out and "Test set:" in out
    assert not (tmp_path / "tune").exists()  # cached mode never stores


def test_launcher_autotune_flag_sets_the_env(monkeypatch):
    seen = []

    def fake(part, nproc, **kw):
        seen.append(kw["env"])
        return launch.LaunchResult()

    monkeypatch.setattr(launch, "launch_elastic", fake)
    for mode in ("cached", "search", "off"):
        assert launch.main(["part3", "--nproc", "2", "--autotune",
                            mode]) == 0
    assert seen == [{"TPU_DDP_AUTOTUNE": m}
                    for m in ("cached", "search", "off")]
    with pytest.raises(SystemExit):
        launch.main(["part3", "--nproc", "2", "--autotune", "bogus"])


def test_bogus_autotune_mode_raises_the_jax_value_error(clean):
    clean.setenv("TPU_DDP_AUTOTUNE", "bogus")
    with pytest.raises(ValueError) as terr:
        TrainConfig()
    with pytest.raises(ValueError) as jerr:
        JaxConfig()
    assert str(terr.value) == str(jerr.value)
    clean.setenv("TPU_DDP_AUTOTUNE", "cached")
    assert TrainConfig().autotune == JaxConfig().autotune == "cached"
    clean.delenv("TPU_DDP_AUTOTUNE")
    assert TrainConfig(autotune="search").autotune == "search"


def test_lm_cli_runs_under_autotune_as_the_jax_cli_does(clean):
    """The LM trainers have no tuner in either package: the LM CLI reads
    the mode and trains."""
    from tpu_ddp_torch.examples.lm_train import main
    clean.setenv("TPU_DDP_AUTOTUNE", "search")
    clean.setenv("TPU_DDP_LM_STEPS", "1")
    assert main(["--num-nodes", "1", "--device", "cpu"]) == 0


# ------------------------------------------------------ the knob audit

JUNK = "knob-audit-junk"


def _probe(knob, default):
    for v in knob.values:
        if v != default:
            return v
    if isinstance(default, bool):
        return not default
    return default * 2


def _audit(knob, clean):
    defaults = TrainConfig()
    default = getattr(defaults, knob.field)
    if knob.values:
        assert default in knob.values, (knob.name, default)
    probe = _probe(knob, default)
    clean.setenv(knob.env, knob.encode(probe))
    assert getattr(TrainConfig(), knob.field) == probe
    if knob.values and (isinstance(knob.values[0], str) or (
            isinstance(knob.values[0], (int, float))
            and not isinstance(knob.values[0], bool))):
        clean.setenv(knob.env, JUNK)
        with pytest.raises(ValueError):
            TrainConfig()
    clean.delenv(knob.env)
    if knob.flag is None:
        return
    assert knob.flag in launch.build_parser()._option_string_actions
    seen = []
    clean.setattr(launch, "launch_elastic",
                  lambda part, nproc, **kw: seen.append(kw["env"])
                  or launch.LaunchResult())
    # A boolean flag is a switch, or (the fleet's) takes "0"/"1".
    switch = launch.build_parser()._option_string_actions[
        knob.flag].nargs == 0
    argv = [knob.flag] if isinstance(probe, bool) and switch else [
        knob.flag, knob.encode(probe)]
    # The MoE knobs configure the LM, which the launcher runs as "lm".
    target = launch.LM if knob.name in tspace._NOT_IN_TRIALS else "part1"
    assert launch.main([target, "--nproc", "1", *argv]) == 0
    assert seen[0][knob.env] == knob.encode(probe), (knob.name, seen)


@pytest.mark.parametrize("name", [k.name for k in KNOBS] + ["registry"])
def test_knob_audit(clean, name):
    """The port's knob audit (scripts/knob_audit.py's checks): each
    knob's env value round-trips through TrainConfig, its launcher flag
    exists and sets the env, a string or numeric knob's env rejects junk;
    the registry covers every JAX knob as ported or unported, and every
    env variable the port's config reads is a knob or a non-perf knob."""
    if name != "registry":
        _audit(tspace.knob_by_field(name), clean)
        return
    port = {k.name for k in KNOBS}
    assert port.isdisjoint(tspace._UNPORTED_KNOBS)
    assert port | set(tspace._UNPORTED_KNOBS) == {k.name for k in
                                                  jspace.KNOBS}
    for item in tspace._UNPORTED_KNOBS.values():
        assert re.match(r"item \d+(\.\d+)? \(", item), item
    for k in KNOBS:
        jk = jspace.knob_by_field(k.name)
        assert (k.field, k.env, k.values, k.semantic, k.objective) == (
            jk.field, jk.env, jk.values, jk.semantic, jk.objective)
    tree = ast.parse((REPO / "tpu_ddp_torch/utils/config.py").read_text())
    parsed = {n.value for n in ast.walk(tree)
              if isinstance(n, ast.Constant) and isinstance(n.value, str)
              and re.fullmatch(r"TPU_DDP_[A-Z0-9_]+", n.value)}
    from tpu_ddp_torch.utils.config import _UNPORTED_ENV
    nonperf = {"TPU_DDP_MAX_ITERS", "TPU_DDP_LR", "TPU_DDP_CKPT_EVERY",
               "TPU_DDP_CHECK_REPLICAS_EVERY", "TPU_DDP_GUARD",
               "TPU_DDP_GUARD_MAX_BAD", "TPU_DDP_AUTOTUNE",
               "TPU_DDP_CUDNN_DETERMINISTIC"}
    assert parsed - set(_UNPORTED_ENV) - nonperf == {k.env for k in KNOBS}
