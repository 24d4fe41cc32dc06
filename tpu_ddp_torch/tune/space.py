"""The perf-knob search space: one declarative registry + constraints
(the port's copy of tpu_ddp/tune/space.py, same names and semantics).

Every knob the autotuner may turn is ONE entry here, carrying the
``TrainConfig`` field it sets, the ``TPU_DDP_*`` env var that field
parses, the ``python -m tpu_ddp_torch.launch`` flag (when one exists)
and the candidate values trials may measure. The knob audit
(``tests/test_torch_tune.py``) cross-checks the surfaces against each
other: each env value round-trips through ``TrainConfig``, each flag is
an option of the launcher, each string knob's env rejects junk.

``KNOBS`` holds the knobs whose field the port's ``TrainConfig`` has.
The JAX package's other knobs are listed in :data:`_UNPORTED_KNOBS`
with the ROADMAP item that ports them; their env variables are refused
by ``utils/config.py``.

The constraint model (:func:`violations`) encodes the combinations the
engine itself refuses or degrades, so the search never spends a trial
on a cell whose measurement would be a lie:

- the hand-written kernels (ops/csrc/) run on the card only: on a CPU
  tensor their wrappers compute the plain version, so a CPU trial
  would time the plain version under the kernel's name;
- ``grad_compress != "none"`` needs dp > 1 and a syncing rung — the
  Trainer warns and degrades to f32 otherwise;
- ``dispatch_depth > 0`` is forced to 0 by the epoch loop when a
  multi-process run carries a collective-bearing in-loop cadence
  (checkpoint and replica-check collectives must run at the same loop
  position on every process);
- ``steps_per_dispatch > 1`` falls back to the per-step path under
  in-loop cadences or ``device_prefetch > 0`` (train/engine.py), so
  those cells duplicate their per-step twins;
- ``remat`` cells that the memory policy resolves to another cell's
  program are skipped as duplicates: ``conv_stages`` on a transformer
  family degrades to ``blocks``, ``dots`` on a conv family checkpoints
  the same regions as ``conv_stages`` (no matmul inside conv stages),
  and ``act_dtype`` equal to the compute dtype is a no-op cast
  (memory/policy.py).

``semantic=True`` marks knobs whose value changes the training
computation itself (dtype, batch size), not just its schedule; the
default space excludes them so tuned runs stay numerically identical
to default runs (opt in with ``TPU_DDP_TUNE_SEMANTIC=1``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Mapping

__all__ = ["Knob", "KNOBS", "Workload", "Fingerprint", "violations",
           "searchable_knobs", "space_version", "fingerprint_for",
           "workload_for", "knob_by_field", "parse_knob_filter"]


@dataclasses.dataclass(frozen=True)
class Knob:
    """One tunable knob and every surface it must agree across."""

    name: str              # registry name (== the TrainConfig field)
    field: str             # TrainConfig attribute the tuner sets
    env: str               # TPU_DDP_* env var utils/config.py parses
    values: tuple          # candidate values (must include the default)
    flag: str | None = None  # tpu_ddp_torch.launch flag, when one exists
    semantic: bool = False   # changes numerics, not just schedule
    # What a trial measures to compare this knob's candidates:
    # "step_time" (the training objective — every schedule knob) or
    # "goodput" (tokens/sec under a latency SLO, the serving objective
    # measured by serve/loadgen.py). The default search space is
    # objective-scoped, so serving knobs never enter a training search
    # and vice versa.
    objective: str = "step_time"
    doc: str = ""

    def encode(self, value) -> str:
        """The env-var string that makes TrainConfig parse ``value``."""
        if isinstance(value, bool):
            return "1" if value else "0"
        return str(value)


# The registry. Values are the JAX package's: the default config is
# always a member (the search must be able to return "keep the
# defaults").
KNOBS: tuple[Knob, ...] = (
    Knob("dispatch_depth", "dispatch_depth", "TPU_DDP_DISPATCH_DEPTH",
         values=(0, 1, 2, 4), flag="--dispatch-depth",
         doc="async dispatch window (train/pipeline.py); 0 = sync loop"),
    Knob("steps_per_dispatch", "steps_per_dispatch",
         "TPU_DDP_STEPS_PER_DISPATCH", values=(1, 4, 8),
         doc="K uniform batches per dispatch: one CUDA graph replay of "
             "K captured steps on the card (train/capture.py)"),
    Knob("device_prefetch", "device_prefetch", "TPU_DDP_PREFETCH",
         values=(0, 2),
         doc="host->device copies kept in flight on a side stream "
             "(data/prefetch.py)"),
    Knob("grad_compress", "grad_compress", "TPU_DDP_GRAD_COMPRESS",
         values=("none", "bf16", "int8"), flag="--grad-compress",
         doc="gradient wire format on the sync collectives "
             "(parallel/compress.py; int8-noef is an ablation, not a "
             "candidate)"),
    Knob("overlap", "overlap", "TPU_DDP_OVERLAP",
         values=(False, True), flag="--overlap",
         doc="bucketed in-backward gradient collectives launched from "
             "gradient hooks + sharded weight update (parallel/"
             "overlap.py); numerics equivalent to the unbucketed rung up "
             "to reduction order, so searchable by default"),
    Knob("bucket_mb", "bucket_mb", "TPU_DDP_BUCKET_MB",
         values=(1, 4, 25), flag="--bucket-mb",
         doc="bucket payload target in MiB for overlap (torch DDP's "
             "bucket_cap_mb=25 default); smaller buckets start "
             "communicating earlier but amortize less per collective"),
    Knob("pallas_sgd", "pallas_sgd", "TPU_DDP_PALLAS_SGD",
         values=(False, True),
         doc="fused multi-tensor SGD momentum update, a CUDA kernel "
             "(ops/csrc/sgd.cu; the card only)"),
    Knob("pallas_bn", "pallas_bn", "TPU_DDP_PALLAS_BN",
         values=(False, True),
         doc="fused BatchNorm+ReLU, four CUDA kernels (ops/csrc/"
             "bn_relu.cu; the card only; model-level — must be applied "
             "before get_model)"),
    Knob("remat", "remat", "TPU_DDP_REMAT",
         values=("none", "blocks", "conv_stages", "dots"), flag="--remat",
         doc="activation rematerialization policy (memory/policy.py): "
             "recompute checkpointed regions in the backward pass "
             "instead of saving activations — bytes for FLOPs; "
             "numerics-preserving (same ops re-executed), so searchable "
             "by default"),
    Knob("act_dtype", "act_dtype", "TPU_DDP_ACT_DTYPE",
         values=("compute", "bf16", "f32"), flag="--act-dtype",
         semantic=True,
         doc="saved-residual dtype at region boundaries "
             "(memory/policy.py); boundaries round-trip through this "
             "dtype, so it changes numerics — searched only with "
             "TPU_DDP_TUNE_SEMANTIC=1"),
    Knob("compute_dtype", "compute_dtype", "TPU_DDP_COMPUTE_DTYPE",
         values=("bfloat16", "float32"), semantic=True,
         doc="matmul/conv dtype; changes the training numerics, so "
             "searched only with TPU_DDP_TUNE_SEMANTIC=1"),
    Knob("global_batch_size", "global_batch_size",
         "TPU_DDP_GLOBAL_BATCH", values=(), semantic=True,
         doc="registered for the audit (field<->env agreement) but "
             "never searched: batch size is a training hyperparameter, "
             "not a schedule knob"),
    Knob("elastic_reshard", "elastic_reshard",
         "TPU_DDP_ELASTIC_RESHARD", values=(),
         flag="--elastic-reshard",
         doc="registered for the audit (field<->env<->flag agreement) "
             "but never searched: live membership resharding "
             "(resilience/elastic.py) is a robustness mode, not a "
             "schedule knob"),
    # Serving knobs (serve/): objective="goodput" scopes them out of the
    # training (step_time) search space.
    Knob("serve_slots", "serve_slots", "TPU_DDP_SERVE_SLOTS",
         values=(4, 8, 16), objective="goodput",
         doc="continuous-batching decode slots — the live-batch width "
             "of the whole-bank decode step; more slots amortize weight "
             "reads but grow per-step latency"),
    Knob("serve_block_size", "serve_block_size", "TPU_DDP_SERVE_BLOCK",
         values=(8, 16, 32), objective="goodput",
         doc="paged KV-cache block size in tokens (serve/kv_pool.py): "
             "small blocks waste less tail capacity per sequence, "
             "large blocks shrink the table/gather overhead"),
    Knob("serve_prefill_chunk", "serve_prefill_chunk",
         "TPU_DDP_SERVE_PREFILL_CHUNK", values=(16, 32, 64),
         objective="goodput",
         doc="prompt tokens run per engine step: prefill throughput "
             "against how long one long prompt can stall the live "
             "decode batch (TTFT tail)"),
    Knob("serve_cache_dtype", "serve_cache_dtype",
         "TPU_DDP_SERVE_CACHE_DTYPE", values=("compute", "bf16", "f32"),
         semantic=True, objective="goodput",
         doc="KV-cache storage dtype (memory/policy.py vocabulary): "
             "'bf16' under an f32 compute model halves cache reads but "
             "rounds the attended history — semantic"),
    Knob("prefix_cache", "prefix_cache", "TPU_DDP_PREFIX_CACHE",
         values=(False, True), objective="goodput",
         doc="refcounted shared-prefix KV cache (fleet/prefix.py): "
             "requests sharing a system prompt pay one prefill; "
             "exactness-preserving via copy-on-write"),
    Knob("serve_queue_limit", "serve_queue_limit",
         "TPU_DDP_SERVE_QUEUE_LIMIT",
         values=(0, 64, 256), flag="--serve-queue-limit",
         objective="goodput",
         doc="bounded admission queue: submits beyond this many "
             "waiting requests are shed at the door (serve/engine.py); "
             "0 = unbounded"),
    Knob("serve_shed_ms", "serve_shed_ms", "TPU_DDP_SERVE_SHED_MS",
         values=(0.0, 100.0, 500.0), flag="--serve-shed-ms",
         objective="goodput",
         doc="queue-deadline shedding: a request still waiting (no "
             "prefill started) this many ms after submission is shed; "
             "0 disables"),
    Knob("tenant_classes", "tenant_classes", "TPU_DDP_TENANT_CLASSES",
         values=("", "gold=3,silver=2,bronze=1"),
         flag="--tenant-classes", objective="goodput",
         doc="SLO classes for multi-tenant serving "
             "(serve/scheduler.py): comma-separated name=weight"
             "[:deadline_ms[:token_budget]]; non-empty switches "
             "admission from FIFO to weighted fair queueing; empty = "
             "single-tenant"),
    Knob("spec_k", "spec_k", "TPU_DDP_SPEC_K",
         values=(0, 4, 12), flag="--spec-k",
         objective="goodput",
         doc="speculative proposals verified per engine step "
             "(serve/speculative.py); 0 = the one-token baseline"),
    Knob("spec_draft", "spec_draft", "TPU_DDP_SPEC_DRAFT",
         values=("chain", "self-1", "quant"), flag="--spec-draft",
         objective="goodput",
         doc="draft family for speculation: 'chain' (the engine's own "
             "decode pass k+1 times, bit-exact stream), 'self-<j>' "
             "(early exit over the target's first j blocks), 'quant' "
             "(a full-depth int8 twin)"),
    Knob("decode_quant", "decode_quant", "TPU_DDP_DECODE_QUANT",
         values=("none", "int8"), flag="--decode-quant",
         objective="goodput", semantic=True,
         doc="weight-only int8 decode compute (ops/quant.py, the int8 "
             "CUDA matmul): per-output-channel quantization of every "
             "decode-path projection; rounds the served logits, so "
             "semantic"),
    Knob("kv_tiers", "kv_tiers", "TPU_DDP_KV_TIERS",
         values=(1, 2, 3), flag="--kv-tiers",
         objective="goodput",
         doc="KV residency tiers (serve/kv_pool.py): 1 = one flat pool, "
             "2 adds a quantized cold tier on the device behind an LRU "
             "hot set, 3 adds host-memory spill"),
    Knob("kv_cold_dtype", "kv_cold_dtype", "TPU_DDP_KV_COLD_DTYPE",
         values=("int8", "bf16"), flag="--kv-cold-dtype",
         objective="goodput", semantic=True,
         doc="storage dtype for cold-tier KV pages: 'int8' halves cold "
             "bytes and rounds re-read attention (semantic), 'bf16' is "
             "a lossless downcast under a bf16 hot pool; inert at "
             "kv_tiers=1"),
    Knob("cp_prefill", "cp_prefill", "TPU_DDP_CP_PREFILL",
         values=("off", "ring", "ulysses"),
         objective="goodput",
         doc="context-parallel chunked prefill: needs a mesh with an sp "
             "axis of extent >= 2; the port serves on one card, so "
             "TrainConfig refuses anything but 'off' (ROADMAP Queue 1 "
             "item 10.5) and the launcher refuses --cp-prefill"),
    # Mixture-of-experts knobs (parallel/moe.py): all three change what
    # the model computes (an architecture, a routing distribution), so
    # all are semantic. The LM CLI reads them (examples/lm_train.py); the
    # tuner's trials train the image ladder, so it never searches them
    # (_NOT_IN_TRIALS).
    Knob("moe_experts", "moe_experts", "TPU_DDP_MOE_EXPERTS",
         values=(0, 4, 8), flag="--moe-experts", semantic=True,
         doc="experts per MoE MLP layer (0 = dense): parameters grow "
             "about linearly in E at per-token FLOPs that track top_k; "
             "an ep > 1 world must divide E"),
    Knob("moe_top_k", "moe_top_k", "TPU_DDP_MOE_TOP_K",
         values=(1, 2), flag="--moe-top-k", semantic=True,
         doc="routed experts per token: 1 = Switch routing (raw-prob "
             "gate), 2 = GShard (renormalised gates, shared capacity "
             "queues); topk_route rejects top_k > experts"),
    Knob("moe_capacity", "moe_capacity", "TPU_DDP_MOE_CAPACITY",
         values=(1.0, 1.25, 2.0), flag="--moe-capacity", semantic=True,
         doc="expert capacity factor: slots per expert = "
             "ceil(T * capacity * top_k / E). Higher drops fewer "
             "assignments (route_stats' dropped_frac) at more padded "
             "expert compute; changes which tokens the experts see, "
             "so semantic"),
)

# The JAX package's knobs that the port does not carry yet -> the
# ROADMAP Queue 1 item that ports them (their env variables are refused
# by utils/config.py:_UNPORTED_ENV).
_PIPELINE = "item 10.7 (parallel/pipeline.py)"
_FLEET = "item 11 (fleet, publish and DiLoCo)"
_UNPORTED_KNOBS = {
    "pp_schedule": _PIPELINE, "pp_microbatches": _PIPELINE,
    "pp_virtual": _PIPELINE,
    **{name: _FLEET for name in (
        "fleet_roles", "router_policy", "kv_wire", "fleet_health",
        "fleet_probe_backoff_ms", "fleet_step_deadline_ms",
        "fleet_retry_budget", "publish_every", "publish_wire",
        "max_staleness_steps", "fleet_autoscale", "scale_cooldown_ms",
        "diloco_h", "outer_lr", "outer_momentum", "outer_wire")},
}

# Model-level knobs are baked into get_model() before the Trainer ever
# sees the config; tune.resolve(model_built=True) must drop them.
MODEL_LEVEL_FIELDS = ("pallas_bn", "compute_dtype")


def knob_by_field(field: str) -> Knob | None:
    for k in KNOBS:
        if k.field == field:
            return k
    return None


def space_version() -> str:
    """Hash of the registry structure: any change to the knob set or a
    knob's candidate values invalidates cached tunings via the
    fingerprint (stale overrides are a miss, never a surprise)."""
    payload = [(k.name, k.field, k.env, k.flag, list(map(str, k.values)),
                k.semantic, k.objective) for k in KNOBS]
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()[:12]


# Knobs that no trial reads: the trials build the image ladder's trainer
# (runner.py, models.get_model), which has no routed layer, while the MoE
# knobs configure the LM. They keep their constraint rules (violations).
_NOT_IN_TRIALS = frozenset({"moe_experts", "moe_top_k", "moe_capacity"})


@dataclasses.dataclass(frozen=True)
class Workload:
    """The static context constraints are evaluated against."""

    platform: str = "cpu"          # the run's device type: cuda | cpu
    dp: int = 1                    # data-parallel ranks of the group
    processes: int = 1             # torch.distributed world size
    strategy: str = "none"         # canonical sync rung
    collective_cadence: bool = False  # in-loop ckpt/replica cadence
    # Model family ("conv" | "attn" | "" unknown): the remat policy's
    # degrade/duplicate rules are family-shaped (memory/policy.py).
    model_family: str = ""
    # Pipeline context: stages and the model's layer count (0 =
    # unknown). The port has no pipeline rung (item 10.7), so pp is 1
    # and the pipeline rules stay inert.
    pp: int = 1
    model_layers: int = 0
    # Expert-parallel extent: 1 until a launcher runs ep > 1 (LMTrainer
    # takes ep; the tuned ladder has no ep axis).
    ep: int = 1


def _world(group=None) -> int:
    """The world size of ``group`` (the default group when None), or 1
    when torch.distributed is not initialised."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def workload_for(cfg, strategy: str = "none", group=None,
                 device=None) -> Workload:
    """Build the constraint context from live runtime state: dp and
    processes are the process group's world size (1 without a group),
    the platform is the type of ``device`` (the card when None)."""
    from tpu_ddp_torch.memory.policy import family_for_model
    from tpu_ddp_torch.parallel.sync import canonical_strategy
    from tpu_ddp_torch.utils.device import resolve_device

    world = _world(group)
    layers = 0
    if family_for_model(cfg.model) == "attn":
        from tpu_ddp_torch.models.transformer import make_transformer
        try:
            layers = int(make_transformer(cfg.model).num_layers)
        except ValueError:
            pass  # not a transformer preset: layer rule inert

    return Workload(
        platform=resolve_device(device).type,
        dp=world,
        processes=world,
        strategy=canonical_strategy(strategy),
        collective_cadence=bool(cfg.ckpt_every_iters
                                or cfg.check_replicas_every),
        model_family=family_for_model(cfg.model),
        model_layers=layers,
    )


def violations(assignment: Mapping, ctx: Workload) -> list[str]:
    """Reasons ``assignment`` (field -> value) is a known-invalid cell
    for ``ctx``; empty list == feasible. Each rule mirrors a guard the
    engine enforces at runtime (cited in the module docstring) — the
    search skips these cells instead of measuring a degraded twin."""
    bad = []
    get = assignment.get
    if ctx.platform != "cuda":
        for field in ("pallas_sgd", "pallas_bn"):
            if get(field):
                bad.append(f"{field}=True requires the CUDA backend "
                           f"(platform is {ctx.platform!r}; on a CPU "
                           "tensor the kernel's wrapper computes its "
                           "plain version)")
    if get("grad_compress", "none") != "none":
        if ctx.dp <= 1 or ctx.strategy == "none":
            bad.append(
                f"grad_compress={get('grad_compress')!r} requires a "
                f"dp>1 mesh and a syncing rung (dp={ctx.dp}, "
                f"strategy={ctx.strategy!r}) — Trainer degrades it to "
                "'none' (DESIGN.md §14)")
    if get("overlap", False) and (ctx.dp <= 1 or ctx.strategy not in
                                  ("gather_scatter", "all_reduce",
                                   "fused")):
        bad.append(
            f"overlap=True requires a dp>1 mesh and a replicated "
            f"syncing rung (dp={ctx.dp}, strategy={ctx.strategy!r}) — "
            "Trainer degrades it to the unbucketed path "
            "(train/engine.py)")
    if get("bucket_mb", 25) != 25 and not get("overlap", False):
        bad.append(
            "bucket_mb is only read by the overlapped path — without "
            "overlap=True this cell duplicates the default")
    if get("dispatch_depth", 0) and ctx.processes > 1 \
            and ctx.collective_cadence:
        bad.append(
            "dispatch_depth>0 with a multi-process collective-bearing "
            "cadence — the streaming loop forces depth 0 "
            "(DESIGN.md §13 guard (e))")
    remat = get("remat", "none")
    if remat == "conv_stages" and ctx.model_family == "attn":
        bad.append(
            "remat='conv_stages' on a transformer family — the model "
            "degrades it to 'blocks' with a warning (tpu_ddp/memory/), "
            "so this cell duplicates the 'blocks' cell")
    if remat == "dots" and ctx.model_family == "conv":
        bad.append(
            "remat='dots' on a conv family — conv stages contain no "
            "dot_general (convs are conv_general_dilated), so the "
            "program is identical to 'conv_stages' (duplicate cell)")
    act = get("act_dtype", "compute")
    cdty = str(get("compute_dtype", "bfloat16"))
    if (act, cdty) in (("bf16", "bfloat16"), ("f32", "float32")):
        bad.append(
            f"act_dtype={act!r} with compute_dtype={cdty!r} — the "
            "boundary cast is a no-op, duplicate of 'compute'")
    scd = get("serve_cache_dtype", "compute")
    if (scd, cdty) in (("bf16", "bfloat16"), ("f32", "float32")):
        bad.append(
            f"serve_cache_dtype={scd!r} with compute_dtype={cdty!r} — "
            "the cache cast is a no-op, duplicate of 'compute' "
            "(tpu_ddp/memory/policy.py resolve_act_dtype)")
    # Fleet knobs (tpu_ddp/fleet/) — mirror the fleet layer's guards.
    kw = get("kv_wire", "none")
    if kw != "none" and get("fleet_roles", "single") != "disagg":
        bad.append(
            f"kv_wire={kw!r} without fleet_roles='disagg' — no edge "
            "exists for the wire format to compress, so the cell "
            "duplicates the default")
    if (get("router_policy", "least-loaded") == "prefix-affinity"
            and not get("prefix_cache", False)):
        bad.append(
            "router_policy='prefix-affinity' without prefix_cache — "
            "every replica reports a zero-length cached prefix, so "
            "routing degenerates to least-loaded (duplicate cell)")
    # Publish knobs (tpu_ddp/publish/) — mirror Publisher's guards.
    if get("publish_every", 0) == 0:
        if get("publish_wire", "none") != "none":
            bad.append(
                f"publish_wire={get('publish_wire')!r} with "
                "publish_every=0 — no push ever encodes, so the cell "
                "duplicates the default")
        if get("max_staleness_steps", 0) != 0:
            bad.append(
                f"max_staleness_steps={get('max_staleness_steps')} "
                "with publish_every=0 — the gate only arms on "
                "publish, so the cell duplicates the default")
    if get("scale_cooldown_ms", 1000.0) != 1000.0 \
            and not get("fleet_autoscale", False):
        bad.append(
            f"scale_cooldown_ms={get('scale_cooldown_ms')} without "
            "fleet_autoscale — the cooldown only gates autoscaler "
            "actions, so the cell duplicates the default")
    # Pipeline knobs (round 10) — mirror PipelineLMTrainer's guards.
    sched = get("pp_schedule", "gpipe")
    virt = get("pp_virtual", 1)
    micro = get("pp_microbatches", 0)
    if ctx.pp <= 1:
        if sched != "gpipe" or virt != 1 or micro != 0:
            bad.append(
                "pipeline knobs off-default on a pp<=1 mesh — no "
                "pipeline rung runs, so every cell duplicates the "
                "default")
    else:
        if virt > 1 and sched != "interleaved":
            bad.append(
                f"pp_virtual={virt} requires pp_schedule='interleaved' "
                f"(got {sched!r}) — PipelineLMTrainer rejects it "
                "(zero-bubble extends plain 1F1B; gpipe/1f1b run one "
                "chunk per stage)")
        if sched == "interleaved" and virt == 1:
            bad.append(
                "pp_schedule='interleaved' with pp_virtual=1 runs the "
                "plain 1F1B tick indices — duplicate of the '1f1b' "
                "cell")
        if (sched == "interleaved" and ctx.model_layers
                and ctx.model_layers % (ctx.pp * virt)):
            bad.append(
                f"interleaved needs num_layers % (pp*pp_virtual) == 0: "
                f"{ctx.model_layers} % {ctx.pp * virt} != 0 — "
                "PipelineLMTrainer rejects it")
        if micro and micro % ctx.pp:
            bad.append(
                f"pp_microbatches={micro} not divisible by "
                f"pp={ctx.pp} — the interleaved schedule rejects it "
                "and the others waste the ragged tail")
    if get("steps_per_dispatch", 1) > 1:
        if get("device_prefetch", 0):
            bad.append("steps_per_dispatch>1 with device_prefetch>0 — "
                       "the engine falls back to the per-step path "
                       "(duplicate of the prefetch-only cell)")
        if ctx.collective_cadence:
            bad.append("steps_per_dispatch>1 with an in-loop cadence — "
                       "the engine falls back to the per-step path")
    # Speculative-decoding knobs (serve/speculative.py §26).
    if get("spec_draft", "chain") != "chain" and get("spec_k", 0) == 0:
        bad.append(
            f"spec_draft={get('spec_draft')!r} with spec_k=0 — no "
            "speculative step ever runs, so the draft family is inert "
            "and the cell duplicates the default")
    if get("spec_k", 0) > 0 and get("fleet_roles", "single") == "disagg":
        bad.append(
            f"spec_k={get('spec_k')} with fleet_roles='disagg' — the "
            "disaggregated decode tier runs the fused adopt+decode "
            "program only (fleet/disagg.py); speculation is a "
            "single-engine/router feature")
    # Long-context serving knobs (serve/long_context.py §27).
    if get("kv_cold_dtype", "int8") != "int8" and get("kv_tiers", 1) == 1:
        bad.append(
            f"kv_cold_dtype={get('kv_cold_dtype')!r} with kv_tiers=1 — "
            "the flat pool has no cold tier, so the cold dtype is "
            "inert and the cell duplicates the default")
    if get("cp_prefill", "off") != "off" and get("kv_tiers", 1) > 1:
        bad.append(
            f"cp_prefill={get('cp_prefill')!r} with "
            f"kv_tiers={get('kv_tiers')} — the context-parallel "
            "prefill program gathers pages by flat slot id and the "
            "engine rejects the combination (serve/engine.py); tiered "
            "residency is a decode-side feature")
    # MoE knobs (parallel/moe.py §28) — mirror the model layer's guards.
    experts = get("moe_experts", 0)
    if experts == 0:
        if get("moe_top_k", 1) != 1:
            bad.append(
                f"moe_top_k={get('moe_top_k')} with moe_experts=0 — "
                "no routed layer exists, the knob is inert and the "
                "cell duplicates the dense default")
        if get("moe_capacity", 1.25) != 1.25:
            bad.append(
                f"moe_capacity={get('moe_capacity')} with "
                "moe_experts=0 — no routed layer exists, the knob is "
                "inert and the cell duplicates the dense default")
    else:
        if get("moe_top_k", 1) > experts:
            bad.append(
                f"moe_top_k={get('moe_top_k')} > moe_experts="
                f"{experts} — topk_route rejects it (beyond E the "
                "fully-masked argmax would silently re-route to "
                "expert 0)")
    if ctx.ep > 1:
        if experts == 0:
            bad.append(
                f"ep={ctx.ep} mesh with moe_experts=0 — expert "
                "parallelism requires a MoE model "
                "(with_expert_parallel rejects it)")
        elif experts % ctx.ep:
            bad.append(
                f"moe_experts={experts} not divisible by ep={ctx.ep} "
                "— with_expert_parallel rejects it (each device hosts "
                "E/ep stacked experts)")
    diloco_h = get("diloco_h", 0)
    if diloco_h == 0:
        if get("outer_lr", 0.7) != 0.7:
            bad.append(
                f"outer_lr={get('outer_lr')} with diloco_h=0 — the "
                "outer loop is inert, the knob does nothing and the "
                "cell duplicates the plain-sync default")
        if get("outer_momentum", 0.9) != 0.9:
            bad.append(
                f"outer_momentum={get('outer_momentum')} with "
                "diloco_h=0 — the outer loop is inert, the knob does "
                "nothing and the cell duplicates the plain-sync "
                "default")
        if get("outer_wire", "none") != "none":
            bad.append(
                f"outer_wire={get('outer_wire')!r} with diloco_h=0 — "
                "no outer exchange exists to put on a wire; the cell "
                "duplicates the plain-sync default")
    elif ctx.pp > 1:
        bad.append(
            f"diloco_h={diloco_h} on a pp={ctx.pp} mesh — a pipeline "
            "group's params live stage-sharded and the outer "
            "pseudo-gradient exchange assumes the canonical "
            "params_to_host layout per group; run DiLoCo groups over "
            "dp/fsdp rungs (pp inside a group is future work)")
    return bad


def parse_knob_filter(spec: str | None) -> dict | None:
    """Parse ``TPU_DDP_TUNE_KNOBS``: a comma-separated list of registry
    names, each optionally pinning its candidate values —
    ``"dispatch_depth=0|2,steps_per_dispatch"`` keeps two knobs and
    shrinks the first to {0, 2}. Returns {name: values-or-None}, or
    None when unset. Unknown names raise (a typo must not silently tune
    the full space)."""
    if not spec:
        return None
    out: dict = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        name, _, raw = item.partition("=")
        name = name.strip()
        knob = knob_by_field(name)
        if knob is None:
            raise ValueError(
                f"TPU_DDP_TUNE_KNOBS: unknown knob {name!r}; known: "
                f"{[k.name for k in KNOBS]}")
        if not raw:
            out[name] = None
            continue
        vals = []
        for tok in raw.split("|"):
            tok = tok.strip()
            if knob.values and isinstance(knob.values[0], bool):
                vals.append(tok.lower() in ("1", "true", "yes", "on"))
            elif knob.values and isinstance(knob.values[0], int):
                vals.append(int(tok))
            else:
                vals.append(tok)
        out[name] = tuple(vals)
    return out


def searchable_knobs(cfg, ctx: Workload,
                     include_semantic: bool | None = None,
                     only: dict | None = None,
                     objective: str = "step_time") -> list[tuple]:
    """The live search space for ``cfg`` under ``ctx``: a list of
    ``(knob, candidate_values)`` with the config's CURRENT value always
    first (the search must be able to keep it). Knobs are dropped when
    the constraint model leaves fewer than two candidates (e.g. the
    kernel knobs off the card), when ``only`` (the parsed
    ``TPU_DDP_TUNE_KNOBS`` filter) excludes them, or when no trial reads
    them (the MoE knobs). The space is
    ``objective``-scoped: the training search ("step_time", the
    default) never sees the serving knobs. Per-value feasibility is
    checked with the other knobs at their config values; the search
    re-checks full assignments, so coupled constraints stay exact."""
    if include_semantic is None:
        include_semantic = os.environ.get(
            "TPU_DDP_TUNE_SEMANTIC", "") in ("1", "true", "yes", "on")
    if only is None:
        only = parse_knob_filter(os.environ.get("TPU_DDP_TUNE_KNOBS"))
    base = {k.field: getattr(cfg, k.field) for k in KNOBS}
    out = []
    for knob in KNOBS:
        if knob.objective != objective:
            continue
        if only is not None and knob.name not in only:
            continue
        if knob.semantic and not include_semantic:
            continue
        if knob.name in _NOT_IN_TRIALS:
            continue
        if os.environ.get(knob.env):
            # An explicit TPU_DDP_* pin is the user overriding this
            # knob by hand; the tuner must neither search nor override
            # it (resolve() enforces the same rule for cached entries).
            continue
        values = knob.values
        if only is not None and only[knob.name] is not None:
            values = only[knob.name]
        if not values:
            continue
        current = getattr(cfg, knob.field)
        candidates = [current]
        for v in values:
            if v == current or v in candidates:
                continue
            if not violations({**base, knob.field: v}, ctx):
                candidates.append(v)
        if len(candidates) >= 2:
            out.append((knob, tuple(candidates)))
    return out


@dataclasses.dataclass(frozen=True)
class Fingerprint:
    """The workload identity a tuning is valid for. Any field changing
    — model, data scale, group, device, software version, or the knob
    space itself — keys a different cache entry, so a tuning can never
    be applied to a workload it was not measured on."""

    model: str
    dataset: str
    global_batch_size: int
    mesh_shape: str            # "dp=<world>" or "none"
    strategy: str
    processes: int
    platform: str
    device_kind: str
    torch_version: str
    cuda_version: str
    space_version: str

    def asdict(self) -> dict:
        return dataclasses.asdict(self)

    def key(self) -> str:
        """Stable cache key: sha256 over the canonical JSON form."""
        return hashlib.sha256(
            json.dumps(self.asdict(), sort_keys=True).encode()
        ).hexdigest()[:16]


def fingerprint_for(cfg, strategy: str = "none", group=None,
                    device=None) -> Fingerprint:
    """The fingerprint of ``cfg`` run under ``strategy`` over the
    process group (``group``; the default group when None) on
    ``device`` (the card when None)."""
    import torch
    import torch.distributed as dist

    from tpu_ddp_torch.parallel.sync import canonical_strategy
    from tpu_ddp_torch.utils.device import resolve_device

    grouped = dist.is_available() and dist.is_initialized()
    dev = resolve_device(device)
    return Fingerprint(
        model=cfg.model,
        dataset=cfg.dataset,
        global_batch_size=cfg.global_batch_size,
        mesh_shape=f"dp={_world(group)}" if grouped else "none",
        strategy=canonical_strategy(strategy),
        processes=_world(group),
        platform=dev.type,
        device_kind=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
        torch_version=torch.__version__,
        cuda_version=torch.version.cuda or "none",
        space_version=space_version(),
    )
