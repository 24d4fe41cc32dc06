"""tpu_ddp_torch.tune — measured-trial autotuning over the perf-knob
space (the port of tpu_ddp/tune/).

The knob space (sync rung's wire format and overlap, dispatch depth, K
steps per dispatch, prefetch, the CUDA kernels, the memory policy,
dtype — see ``space.KNOBS``) is searched by measurement:

- ``TPU_DDP_AUTOTUNE=search`` (or ``TrainConfig.autotune="search"`` /
  ``launch --autotune search``): run timed trials on the live workload
  (``runner.py``) under coordinate descent + successive halving
  (``search.py``), persist the winner to the fingerprint-keyed cache
  (``cache.py``), apply it;
- ``TPU_DDP_AUTOTUNE=cached``: apply a previously searched tuning when
  one exists for this exact workload fingerprint, the defaults (with a
  log line) otherwise — safe to leave on everywhere;
- ``off`` (default): the tuner does not exist.

:func:`resolve` is the single integration point — ``parts/common.py``
calls it before the model is built (all knobs applicable) and
``train/engine.py`` calls it as a fallback for direct ``Trainer``
construction (model-level knobs are dropped with a log line there).
Explicit ``TPU_DDP_*`` env pins always beat the tuner: a pinned knob is
neither searched nor overridden.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import json
import os
import time

from tpu_ddp_torch.tune import cache as tune_cache
from tpu_ddp_torch.tune.runner import TrialRunner
from tpu_ddp_torch.tune.search import run_search
from tpu_ddp_torch.tune.space import (KNOBS, MODEL_LEVEL_FIELDS,
                                      Fingerprint, _world, fingerprint_for,
                                      knob_by_field, searchable_knobs,
                                      workload_for)

__all__ = ["resolve", "apply_overrides", "tuned_vs_default",
           "fingerprint_for", "searchable_knobs", "KNOBS", "Fingerprint"]


def apply_overrides(cfg, overrides: dict, *, model_built: bool = False,
                    log=print):
    """A copy of ``cfg`` with tuned ``overrides`` applied and
    ``autotune`` disarmed. ``copy.copy`` + ``setattr``, never
    ``dataclasses.replace`` — replace() re-runs ``__post_init__``, which
    would re-read the env (re-arming ``TPU_DDP_AUTOTUNE`` into a
    recursion, and clobbering tuned values with env defaults).

    Skipped, with a log line naming why: fields pinned by their own
    ``TPU_DDP_*`` env var (the user's explicit pin wins), and — when
    ``model_built`` — model-level fields (``pallas_bn``,
    ``compute_dtype``) that can no longer take effect because
    ``get_model`` already ran.
    """
    out = copy.copy(cfg)
    out.autotune = "off"
    for field, value in overrides.items():
        knob = knob_by_field(field)
        if knob is None:
            log(f"[autotune] ignoring unknown override {field!r}")
            continue
        if os.environ.get(knob.env):
            log(f"[autotune] override {field}={value!r} skipped: "
                f"{knob.env} is explicitly set and pins the knob")
            continue
        if model_built and field in MODEL_LEVEL_FIELDS \
                and value != getattr(cfg, field):
            log(f"[autotune] override {field}={value!r} skipped: the "
                "model is already built (apply tunings via "
                "parts/common.py or launch --autotune to cover "
                "model-level knobs)")
            continue
        setattr(out, field, value)
    return out


def resolve(cfg, *, strategy: str = "none", group=None, device=None,
            model_built: bool = False, log=print):
    """Resolve ``cfg.autotune`` into a concrete config: search, load, or
    fall back to defaults — always returning a config with
    ``autotune="off"`` so downstream construction can't recurse.
    ``group``: the process group the trainer syncs over (the default
    group when None); ``device``: the trainer's device (the card when
    None)."""
    mode = getattr(cfg, "autotune", "off")
    if mode == "off":
        return cfg

    fp = fingerprint_for(cfg, strategy, group, device)
    hit = tune_cache.load(fp)
    if hit is not None:
        log(f"[autotune] cache hit: trials=0 "
            f"overrides={json.dumps(hit['overrides'], sort_keys=True)} "
            f"<- {hit['path']}")
        return apply_overrides(cfg, hit["overrides"],
                               model_built=model_built, log=log)

    if mode == "cached":
        log(f"[autotune] cached mode: no entry for {fp.key()}; using "
            "defaults (populate with TPU_DDP_AUTOTUNE=search)")
        return apply_overrides(cfg, {}, model_built=model_built, log=log)

    # mode == "search"
    world = _world(group)
    if world > 1:
        # Per-process trial loops would run collectives on different
        # schedules across ranks (deadlock) and measure contended
        # devices (garbage). Search single-process, share via the cache.
        log("[autotune] search mode refused under multi-process "
            f"(process_count={world}); using defaults — "
            "run TPU_DDP_AUTOTUNE=search single-process to populate "
            "the cache, then use TPU_DDP_AUTOTUNE=cached")
        return apply_overrides(cfg, {}, model_built=model_built, log=log)

    ctx = workload_for(cfg, strategy, group, device)
    knobs = searchable_knobs(cfg, ctx)
    base = {knob.field: cands[0] for knob, cands in knobs}
    t0 = time.perf_counter()
    runner = TrialRunner(cfg, ctx, strategy=strategy, device=device,
                         log=log)
    result = run_search(knobs, runner.evaluate, base, log=log)
    wall = time.perf_counter() - t0
    # The trial trainers (their models, K-step graphs and DDP wrappers)
    # go before the run's own trainer is built.
    del runner
    gc.collect()

    path = tune_cache.store(fp, result["overrides"], meta={
        "trials": result["trials"],
        "quarantined": result["quarantined"],
        "mode": result["mode"],
        "wall_s": round(wall, 2),
        "default_steps_per_sec": result["default_steps_per_sec"],
        "tuned_steps_per_sec": result["tuned_steps_per_sec"],
        "searched_knobs": [knob.name for knob, _ in knobs],
    })
    log(f"[autotune] search: trials={result['trials']} "
        f"quarantined={result['quarantined']} wall_s={wall:.1f} "
        f"overrides={json.dumps(result['overrides'], sort_keys=True)} "
        f"-> {path}")
    return apply_overrides(cfg, result["overrides"],
                           model_built=model_built, log=log)


@contextlib.contextmanager
def _group_of_one(device, strategy: str):
    """The default process group while the block runs, for a rung that
    syncs: the one already initialised, else a group of one on this host
    (NCCL on the card, gloo on the CPU), torn down afterwards."""
    import torch.distributed as dist

    from tpu_ddp_torch.parallel.sync import canonical_strategy
    if dist.is_initialized() or canonical_strategy(strategy) == "none":
        yield
        return
    from tpu_ddp_torch.launch import find_free_port
    from tpu_ddp_torch.parallel.bootstrap import (init_distributed_setup,
                                                  shutdown)
    ctx = init_distributed_setup("127.0.0.1", str(find_free_port()), 0, 1,
                                 device=device, ddp=True)
    try:
        yield
    finally:
        shutdown(ctx)


def tuned_vs_default(config: str, *, strategy: str = "fused",
                     device=None, n_batches: int | None = None,
                     max_trials: int | None = None,
                     timeout_s: float | None = None,
                     log=None) -> dict:
    """Search one preset WITHOUT touching the persistent cache and
    report tuned-vs-default steps/sec. Runs at world 1: over the default
    process group when one of world 1 is up, else over a group of one
    made for the search; a larger world raises ``ValueError`` (the
    search would time contended devices, as :func:`resolve` refuses)."""
    from tpu_ddp_torch.utils.config import TrainConfig
    from tpu_ddp_torch.utils.device import resolve_device

    device = resolve_device(device)
    cfg = TrainConfig.preset(config)
    cfg.autotune = "off"
    with _group_of_one(device, strategy):
        if _world() > 1:
            raise ValueError(
                f"tuned_vs_default runs at world 1; the process group "
                f"has {_world()} ranks")
        ctx = workload_for(cfg, strategy, device=device)
        knobs = searchable_knobs(cfg, ctx)
        base = {knob.field: cands[0] for knob, cands in knobs}
        t0 = time.perf_counter()
        runner = TrialRunner(cfg, ctx, strategy=strategy, device=device,
                             n_batches=n_batches, max_trials=max_trials,
                             timeout_s=timeout_s, log=log)
        result = run_search(knobs, runner.evaluate, base,
                            log=log or (lambda s: None))
        wall = time.perf_counter() - t0
        fp = fingerprint_for(cfg, strategy, device=device)
        # The trial trainers (DDP wrappers, K-step graphs) go before the
        # group they were built on.
        del runner
        gc.collect()
    return {
        "config": config,
        "searched_knobs": [knob.name for knob, _ in knobs],
        "overrides": result["overrides"],
        "default_steps_per_sec": result["default_steps_per_sec"],
        "tuned_steps_per_sec": result["tuned_steps_per_sec"],
        "trials": result["trials"],
        "quarantined": result["quarantined"],
        "mode": result["mode"],
        "wall_s": round(wall, 2),
        "fingerprint": fp.asdict(),
    }
