"""Run configuration: the fields of tpu_ddp/utils/config.py's
``TrainConfig`` that the port's slices use (serving and its fleet, the
image trainer's
models and datasets, the training ladder with its gradient wires and
bucketed overlap, checkpoints, the step guard, elastic membership, the
memory policy, the loop's host side: the dispatch window, K steps per
dispatch and device prefetch, the autotuner's mode, the MoE knobs), with
the same
names, defaults, ``TPU_DDP_*`` env variables and validation, so a knob
means the same thing in both packages.

A knob of the JAX package that the port does not carry yet is refused,
never ignored: its field is absent (passing it is a ``TypeError``) and
setting its env variable to anything but the default raises
``NotImplementedError`` naming the ROADMAP item that will port it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

# Shared seed applied on every node so parameter init is identical across
# replicas (reference part1/main.py:14,115-117).
SEED = 89395

# Global batch is fixed; per-node batch = int(global / world_size)
# (reference part2/part2b/main.py:177).
GLOBAL_BATCH_SIZE = 256

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")

# Env knobs of the JAX package that the port does not implement yet:
# name -> (values that mean "off", the ROADMAP Queue 1 item that ports it).
_PUBLISH = "item 11 (11b: weight publishing, publish/)"
_DILOCO = "item 11 (11c: DiLoCo, train/outer.py)"
_UNPORTED_ENV = {
    "TPU_DDP_AUDIT": (("off",), "item 12 (analysis/)"),
    # JAX's package never reads it: its benchmark does (bench.py).
    "TPU_DDP_FLEET_ROLES": (("single",), "item 13 (the port's benchmark)"),
    "TPU_DDP_PUBLISH_EVERY": (("0",), _PUBLISH),
    "TPU_DDP_PUBLISH_WIRE": (("none",), _PUBLISH),
    "TPU_DDP_PUBLISH_MAX_STALENESS": (("0",), _PUBLISH),
    "TPU_DDP_DILOCO_H": (("0",), _DILOCO),
    "TPU_DDP_DILOCO_OUTER_LR": (("0.7",), _DILOCO),
    "TPU_DDP_DILOCO_OUTER_MOMENTUM": (("0.9",), _DILOCO),
    "TPU_DDP_DILOCO_OUTER_WIRE": (("none",), _DILOCO),
}


def _env_bool(name: str, default: bool) -> bool:
    """Parse a boolean env var; unset -> default, junk -> ValueError."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    low = raw.strip().lower()
    if low in _TRUE:
        return True
    if low in _FALSE:
        return False
    raise ValueError(f"{name}={raw!r}: expected a boolean "
                     f"(1/0/true/false/yes/no/on/off)")


def _env_num(name: str, conv, default):
    """Parse a numeric env var; unset -> default, junk -> ValueError
    naming the variable."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return conv(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r}: expected "
                         f"{conv.__name__}") from None


def refuse_unported_env() -> None:
    """Raise ``NotImplementedError`` for any set env knob of the JAX
    package that the port does not implement yet."""
    for name, (off, item) in _UNPORTED_ENV.items():
        raw = os.environ.get(name)
        if raw is None or raw == "" or raw.strip().lower() in off:
            continue
        raise NotImplementedError(
            f"{name}={raw!r}: not ported to tpu_ddp_torch yet (ROADMAP "
            f"Queue 1 {item}); unset it to run the port")


@dataclasses.dataclass
class TrainConfig:
    """One run's configuration (defaults = the reference's)."""

    # Model / data.
    model: str = "VGG11"
    num_classes: int = 10
    image_size: int = 32
    in_channels: int = 3              # run_part's loaders give 3 only
    dataset: str = "cifar10"          # "cifar10" | "imagenet"

    # Optimizer: SGD(lr=0.1, momentum=0.9, weight_decay=1e-4)
    # (reference part1/main.py:124-125). A schedule ``step -> lr``
    # (ops/optim.py:warmup_cosine) gives scheduled SGD.
    learning_rate: Any = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4

    # Loop shape (reference part1/main.py:17,128).
    global_batch_size: int = GLOBAL_BATCH_SIZE
    epochs: int = 1
    seed: int = SEED

    # Loss print every 20 iters, timing over iterations 1..39 with
    # iteration 0 discarded as warm-up (reference part1/main.py:82-91).
    log_every: int = 20
    timing_first_iter: int = 1
    timing_last_iter: int = 39

    compute_dtype: str = "bfloat16"   # conv/matmul dtype
    # Master params and momentum; the port keeps them f32 (the fused SGD
    # and BN kernels take f32), so any other value raises.
    param_dtype: str = "float32"
    # Hand-written kernels (ops/csrc/): the fused SGD update (ops/sgd.py)
    # and the fused BatchNorm+ReLU (ops/bn_relu.py). Off by default, as
    # in the JAX package. Env: TPU_DDP_PALLAS_SGD / TPU_DDP_PALLAS_BN.
    pallas_sgd: bool = False
    pallas_bn: bool = False

    # Host-to-device transfers kept in flight by the epoch loop
    # (data/prefetch.py; 0 = none). Env: TPU_DDP_PREFETCH.
    device_prefetch: int = 0
    # > 1: the epoch loop runs groups of K uniform batches per dispatch
    # (Trainer.build_multi_step: one CUDA graph replay on the card, K
    # plain steps on the CPU; bit-equal to K single steps). Ragged tails
    # and in-loop checkpoint/replica cadences, device prefetch and chaos
    # take the per-step path. Env: TPU_DDP_STEPS_PER_DISPATCH.
    steps_per_dispatch: int = 1
    # Async dispatch window (train/pipeline.py): up to this many steps
    # stay in flight and losses, guard flags, heartbeats and cadences run
    # from HARVESTED steps, so a divergence can surface up to this many
    # steps late. 0 = the reference's synchronous loop (forced while
    # chaos is active; iterations of the timing window always wait).
    # Env: TPU_DDP_DISPATCH_DEPTH.
    dispatch_depth: int = 2

    # Cap on iterations per epoch (None = full epoch). Env:
    # TPU_DDP_MAX_ITERS.
    max_iters: int | None = None
    # Mid-epoch checkpoint cadence in steps (0 = epoch ends only); env
    # TPU_DDP_CKPT_EVERY. Enables resume after a mid-epoch failure
    # (launch.py:launch_elastic).
    ckpt_every_iters: int = 0
    # Replica-consistency check cadence in steps (0 = off); env
    # TPU_DDP_CHECK_REPLICAS_EVERY (utils/invariants.py).
    check_replicas_every: int = 0
    # Step guard (resilience/guard.py): skip updates whose loss or
    # gradient norm is not finite, so the state passes a bad batch
    # unchanged. On by default (a healthy step is bit-identical to an
    # unguarded one); env TPU_DDP_GUARD=0 disables.
    guard_nonfinite: bool = True
    # Consecutive skipped steps before train_epoch raises
    # TrainingDivergedError; env TPU_DDP_GUARD_MAX_BAD.
    guard_max_bad_steps: int = 3
    # Elastic membership (resilience/elastic.py): on a rank lost, stalled
    # or rejoining, survivors reshard their live state onto the new
    # world instead of the cluster restarting from a checkpoint. Workers
    # act on it only when the launcher also gives the protocol directory
    # (TPU_DDP_ELASTIC_DIR). Env TPU_DDP_ELASTIC_RESHARD; launcher flag
    # --elastic-reshard.
    elastic_reshard: bool = False
    # The port's own knob (the JAX package runs on XLA, which sums in a
    # fixed order): cuDNN's deterministic algorithms, no autotuning, so
    # two runs of the same steps give the same bits (resume drills).
    # Applied by parts/common.py:run_part; env TPU_DDP_CUDNN_DETERMINISTIC.
    cudnn_deterministic: bool = False

    # Gradient wire format of the syncing rungs (parallel/compress.py):
    # "none" (f32), "bf16", "int8" (with error feedback) or "int8-noef".
    # Env: TPU_DDP_GRAD_COMPRESS. Needs dp > 1 and a syncing strategy;
    # degrades to "none" with a warning otherwise.
    grad_compress: str = "none"
    # Bucketed overlap (parallel/overlap.py): ~bucket_mb-MiB buckets in
    # reverse order, each bucket's collective launched from a gradient
    # hook inside the backward, with the sharded update on all_reduce
    # and fused. Needs dp > 1 and a replicated syncing rung; degrades to
    # the unbucketed path with a warning otherwise. Env: TPU_DDP_OVERLAP,
    # TPU_DDP_BUCKET_MB (torch DDP's bucket_cap_mb, 25 by default).
    overlap: bool = False
    bucket_mb: int = 25

    # Memory policy (memory/policy.py): activation rematerialisation,
    # "none" | "blocks" | "conv_stages" | "dots" (env TPU_DDP_REMAT), and
    # the saved residuals' dtype between regions, "compute" | "bf16" |
    # "f32" (env TPU_DDP_ACT_DTYPE). The trainers imprint both on the
    # model (memory/policy.py:apply_policy).
    remat: str = "none"
    act_dtype: str = "compute"

    # Autotuning (tune/): "off" (default), "cached" (apply a previously
    # searched tuning for this workload fingerprint when the cache has
    # one; the defaults otherwise, with a log line), or "search" (run
    # measured trials over the knob space, persist the winner, apply
    # it). Env: TPU_DDP_AUTOTUNE; launch flag --autotune. Explicit
    # TPU_DDP_* pins on individual knobs always beat the tuner; the
    # semantic knobs (act_dtype, compute_dtype) are searched only with
    # TPU_DDP_TUNE_SEMANTIC=1 (tune/space.py).
    autotune: str = "off"

    # Mixture of experts (parallel/moe.py), read by the LM CLI
    # (examples/lm_train.py), which sets them over its preset's where
    # their env is set. Experts per MoE MLP layer (0 = dense).
    # Env: TPU_DDP_MOE_EXPERTS.
    moe_experts: int = 0
    # Routed experts per token: 1 = Switch, 2 = GShard. The model layer
    # checks top_k <= experts where the expert count is known.
    # Env: TPU_DDP_MOE_TOP_K.
    moe_top_k: int = 1
    # Expert capacity factor: slots per expert =
    # ceil(T * capacity * top_k / E). Env: TPU_DDP_MOE_CAPACITY.
    moe_capacity: float = 1.25

    # Pipeline schedule knobs (parallel/pipeline.py), read by the LM CLI's
    # pipeline rung (examples/lm_train.py at TPU_DDP_LM_PP > 1).
    # pp_schedule: "gpipe", "1f1b", "interleaved" (pp_virtual chunks per
    # stage) or "zerobubble"; pp_microbatches 0 = auto (= pp); pp_virtual
    # > 1 needs the interleaved schedule and num_layers % (pp *
    # pp_virtual) == 0, which PipelineLMTrainer checks where the model is
    # known (tune/space.py mirrors them as violations). Env:
    # TPU_DDP_PP_SCHEDULE / TPU_DDP_PP_MICROBATCHES / TPU_DDP_PP_VIRTUAL.
    pp_schedule: str = "gpipe"
    pp_microbatches: int = 0
    pp_virtual: int = 1

    # Continuous-batching decode slots — the live-batch width of the
    # whole-bank decode step. Env: TPU_DDP_SERVE_SLOTS.
    serve_slots: int = 8
    # Paged KV-cache block size in tokens (serve/kv_pool.py).
    # Env: TPU_DDP_SERVE_BLOCK.
    serve_block_size: int = 16
    # Prefill chunk in tokens: how much of a prompt runs per engine
    # step, bounding how long one long prompt can stall the decode
    # batch. Env: TPU_DDP_SERVE_PREFILL_CHUNK.
    serve_prefill_chunk: int = 32
    # KV-cache storage dtype (memory/policy.py ACT_DTYPES): "compute",
    # "bf16" or "f32". Env: TPU_DDP_SERVE_CACHE_DTYPE.
    serve_cache_dtype: str = "compute"
    # Weight-only int8 decode compute (ops/quant.py): "none" serves fp,
    # "int8" quantizes every decode-path projection per output channel
    # at engine construction. Env: TPU_DDP_DECODE_QUANT.
    decode_quant: str = "none"
    # Refcounted shared-prefix KV cache (fleet/prefix.py): requests that
    # share a system prompt pay one prefill. Env: TPU_DDP_PREFIX_CACHE.
    prefix_cache: bool = False
    # Multi-replica routing (fleet/router.py): "least-loaded" or
    # "prefix-affinity" (needs prefix_cache). Env: TPU_DDP_ROUTER_POLICY.
    router_policy: str = "least-loaded"
    # The disagg KV edge's wire (parallel/compress.py EdgeCodec): "none",
    # "bf16" or "int8"; the lossy ones round the shipped KV. Env:
    # TPU_DDP_KV_WIRE.
    kv_wire: str = "none"
    # Replica health in the Router (fleet/resilience.py): a replica
    # raising out of step() goes unhealthy and its requests migrate. Env:
    # TPU_DDP_FLEET_HEALTH.
    fleet_health: bool = True
    # Probe backoff of an unhealthy replica, doubling per consecutive
    # failure (capped at 30 s). Env: TPU_DDP_FLEET_HEALTH_BACKOFF_MS.
    fleet_probe_backoff_ms: float = 200.0
    # A replica step slower than this counts as a failure (0 = off).
    # Env: TPU_DDP_FLEET_HEALTH_DEADLINE_MS.
    fleet_step_deadline_ms: float = 0.0
    # Replays of one request after replica failures before the Router
    # sheds it. Env: TPU_DDP_FLEET_RETRY_BUDGET.
    fleet_retry_budget: int = 3
    # The autoscaler over the Router (fleet/autoscale.py). Env:
    # TPU_DDP_FLEET_AUTOSCALE.
    fleet_autoscale: bool = False
    # Minimum ms between autoscale actions (> 0). Env:
    # TPU_DDP_SCALE_COOLDOWN_MS.
    scale_cooldown_ms: float = 1000.0
    # Bounded admission queue: submits past this depth are shed at the
    # door (0 = unbounded). Env: TPU_DDP_SERVE_QUEUE_LIMIT.
    serve_queue_limit: int = 0
    # A request still queued past this many ms is shed (0 = off). Env:
    # TPU_DDP_SERVE_SHED_MS.
    serve_shed_ms: float = 0.0
    # Tenant SLO classes for weighted fair queueing (serve/scheduler.py):
    # comma-separated "name=weight[:deadline_ms[:token_budget]]"; empty =
    # one anonymous tenant, FIFO admission. Env: TPU_DDP_TENANT_CLASSES.
    tenant_classes: str = ""
    # Speculative decoding (serve/speculative.py): proposals verified per
    # engine step (0 = off). Env: TPU_DDP_SPEC_K.
    spec_k: int = 0
    # Draft family: "chain", "self-<j>" or "quant". Env:
    # TPU_DDP_SPEC_DRAFT.
    spec_draft: str = "chain"
    # Tiered KV pool (serve/kv_pool.py): 1 = single tier, 2 adds a
    # quantized cold tier on the device, 3 a host spill tier behind it.
    # Env: TPU_DDP_KV_TIERS.
    kv_tiers: int = 1
    # Cold-page codec for kv_tiers >= 2: "int8" or "bf16". Env:
    # TPU_DDP_KV_COLD_DTYPE.
    kv_cold_dtype: str = "int8"
    # Context-parallel chunked prefill: "off", "ring" or "ulysses" (the
    # engine shards each chunk over an sp group of >= 2 processes,
    # serve/long_context.py). Env: TPU_DDP_CP_PREFILL.
    cp_prefill: str = "off"

    def __post_init__(self):
        if self.dataset not in DATASETS:
            raise ValueError(f"dataset={self.dataset!r}: expected one of "
                             f"{'|'.join(DATASETS)}")
        if self.image_size < 1 or self.in_channels < 1:
            raise ValueError(
                f"image_size={self.image_size}, in_channels="
                f"{self.in_channels}: both must be >= 1")
        if self.max_iters is None:
            env = os.environ.get("TPU_DDP_MAX_ITERS")
            if env:
                self.max_iters = int(env)
        env_bs = os.environ.get("TPU_DDP_GLOBAL_BATCH")
        if env_bs:
            self.global_batch_size = int(env_bs)
        env_ck = os.environ.get("TPU_DDP_CKPT_EVERY")
        if env_ck:
            self.ckpt_every_iters = int(env_ck)
        env_rc = os.environ.get("TPU_DDP_CHECK_REPLICAS_EVERY")
        if env_rc:
            self.check_replicas_every = int(env_rc)
        self.guard_nonfinite = _env_bool("TPU_DDP_GUARD",
                                         self.guard_nonfinite)
        env_gb = os.environ.get("TPU_DDP_GUARD_MAX_BAD")
        if env_gb:
            self.guard_max_bad_steps = int(env_gb)
        self.elastic_reshard = _env_bool("TPU_DDP_ELASTIC_RESHARD",
                                         self.elastic_reshard)
        self.cudnn_deterministic = _env_bool("TPU_DDP_CUDNN_DETERMINISTIC",
                                             self.cudnn_deterministic)
        env_rm = os.environ.get("TPU_DDP_REMAT")
        if env_rm:
            self.remat = env_rm
        env_ad = os.environ.get("TPU_DDP_ACT_DTYPE")
        if env_ad:
            self.act_dtype = env_ad
        # Mirrors memory/policy.py, which validates again when a model
        # takes the policy; here a bad value fails naming its env var.
        if self.remat not in ("none", "blocks", "conv_stages", "dots"):
            raise ValueError(
                f"remat={self.remat!r}: expected "
                "none|blocks|conv_stages|dots (TPU_DDP_REMAT)")
        if self.act_dtype not in ("compute", "bf16", "f32"):
            raise ValueError(
                f"act_dtype={self.act_dtype!r}: expected "
                "compute|bf16|f32 (TPU_DDP_ACT_DTYPE)")
        env_at = os.environ.get("TPU_DDP_AUTOTUNE")
        if env_at:
            self.autotune = env_at
        if self.autotune not in ("off", "cached", "search"):
            raise ValueError(
                f"autotune={self.autotune!r}: expected off|cached|search "
                "(TPU_DDP_AUTOTUNE)")
        env_ps = os.environ.get("TPU_DDP_PP_SCHEDULE")
        if env_ps:
            self.pp_schedule = env_ps
        if self.pp_schedule not in ("gpipe", "1f1b", "interleaved",
                                    "zerobubble"):
            raise ValueError(
                f"pp_schedule={self.pp_schedule!r}: expected "
                "gpipe|1f1b|interleaved|zerobubble (TPU_DDP_PP_SCHEDULE)")
        self.pp_microbatches = _env_num(
            "TPU_DDP_PP_MICROBATCHES", int, self.pp_microbatches)
        if self.pp_microbatches < 0:
            raise ValueError(
                f"pp_microbatches must be >= 0 (0 = auto), got "
                f"{self.pp_microbatches} (TPU_DDP_PP_MICROBATCHES)")
        self.pp_virtual = _env_num(
            "TPU_DDP_PP_VIRTUAL", int, self.pp_virtual)
        if self.pp_virtual < 1:
            raise ValueError(
                f"pp_virtual must be >= 1, got {self.pp_virtual} "
                "(TPU_DDP_PP_VIRTUAL)")
        self.moe_experts = _env_num(
            "TPU_DDP_MOE_EXPERTS", int, self.moe_experts)
        if self.moe_experts < 0:
            raise ValueError(
                f"moe_experts must be >= 0 (0 = dense), got "
                f"{self.moe_experts} (TPU_DDP_MOE_EXPERTS)")
        self.moe_top_k = _env_num(
            "TPU_DDP_MOE_TOP_K", int, self.moe_top_k)
        if self.moe_top_k < 1:
            raise ValueError(
                f"moe_top_k must be >= 1, got {self.moe_top_k} "
                "(TPU_DDP_MOE_TOP_K)")
        # top_k <= experts needs both knobs: checked in the model layer
        # (topk_route) and in tune/space.py violations.
        self.moe_capacity = _env_num(
            "TPU_DDP_MOE_CAPACITY", float, self.moe_capacity)
        if not self.moe_capacity > 0:  # also rejects NaN
            raise ValueError(
                f"moe_capacity must be > 0, got {self.moe_capacity} "
                "(TPU_DDP_MOE_CAPACITY)")
        env_gc = os.environ.get("TPU_DDP_GRAD_COMPRESS")
        if env_gc:
            self.grad_compress = env_gc
        # Mirrors parallel/compress.py SPECS, which re-validates.
        if self.grad_compress not in ("none", "bf16", "int8",
                                      "int8-noef"):
            raise ValueError(
                f"grad_compress={self.grad_compress!r}: expected "
                "none|bf16|int8|int8-noef (TPU_DDP_GRAD_COMPRESS)")
        self.overlap = _env_bool("TPU_DDP_OVERLAP", self.overlap)
        env_bm = os.environ.get("TPU_DDP_BUCKET_MB")
        if env_bm:
            self.bucket_mb = int(env_bm)
        if self.bucket_mb <= 0:
            raise ValueError(
                f"bucket_mb must be > 0, got {self.bucket_mb} "
                "(TPU_DDP_BUCKET_MB)")
        self.pallas_sgd = _env_bool("TPU_DDP_PALLAS_SGD", self.pallas_sgd)
        self.pallas_bn = _env_bool("TPU_DDP_PALLAS_BN", self.pallas_bn)
        env_pf = os.environ.get("TPU_DDP_PREFETCH")
        if env_pf:
            self.device_prefetch = int(env_pf)
        env_spd = os.environ.get("TPU_DDP_STEPS_PER_DISPATCH")
        if env_spd:
            self.steps_per_dispatch = int(env_spd)
        env_dd = os.environ.get("TPU_DDP_DISPATCH_DEPTH")
        if env_dd:
            self.dispatch_depth = int(env_dd)
        if self.dispatch_depth < 0:
            raise ValueError(
                f"dispatch_depth must be >= 0, got {self.dispatch_depth} "
                "(0 = synchronous loop)")
        env_cd = os.environ.get("TPU_DDP_COMPUTE_DTYPE")
        if env_cd:
            if env_cd not in ("bfloat16", "float32", "float16"):
                raise ValueError(f"TPU_DDP_COMPUTE_DTYPE={env_cd!r}: "
                                 "expected bfloat16|float32|float16")
            self.compute_dtype = env_cd
        if self.param_dtype != "float32":
            raise NotImplementedError(
                f"param_dtype={self.param_dtype!r}: tpu_ddp_torch keeps "
                "params and momentum in float32")
        env_lr = os.environ.get("TPU_DDP_LR")
        if env_lr:
            lr = float(env_lr)
            if not lr > 0:  # also rejects NaN
                raise ValueError(f"TPU_DDP_LR={env_lr!r}: expected a "
                                 "positive learning rate")
            self.learning_rate = lr
        env_ss = os.environ.get("TPU_DDP_SERVE_SLOTS")
        if env_ss:
            self.serve_slots = int(env_ss)
        if self.serve_slots < 1:
            raise ValueError(f"serve_slots must be >= 1, got "
                             f"{self.serve_slots} (TPU_DDP_SERVE_SLOTS)")
        env_sb = os.environ.get("TPU_DDP_SERVE_BLOCK")
        if env_sb:
            self.serve_block_size = int(env_sb)
        if self.serve_block_size < 1:
            raise ValueError(
                f"serve_block_size must be >= 1, got "
                f"{self.serve_block_size} (TPU_DDP_SERVE_BLOCK)")
        env_sp = os.environ.get("TPU_DDP_SERVE_PREFILL_CHUNK")
        if env_sp:
            self.serve_prefill_chunk = int(env_sp)
        if self.serve_prefill_chunk < 1:
            raise ValueError(
                f"serve_prefill_chunk must be >= 1, got "
                f"{self.serve_prefill_chunk} "
                "(TPU_DDP_SERVE_PREFILL_CHUNK)")
        env_sc = os.environ.get("TPU_DDP_SERVE_CACHE_DTYPE")
        if env_sc:
            self.serve_cache_dtype = env_sc
        if self.serve_cache_dtype not in ("compute", "bf16", "f32"):
            raise ValueError(
                f"serve_cache_dtype={self.serve_cache_dtype!r}: expected "
                "compute|bf16|f32 (TPU_DDP_SERVE_CACHE_DTYPE)")
        env_dq = os.environ.get("TPU_DDP_DECODE_QUANT")
        if env_dq:
            self.decode_quant = env_dq
        if self.decode_quant not in ("none", "int8"):
            raise ValueError(
                f"decode_quant={self.decode_quant!r}: expected "
                "none|int8 (TPU_DDP_DECODE_QUANT)")
        self._serving_knobs()

    def _fleet_knobs(self) -> None:
        """The fleet's env knobs (tpu_ddp/utils/config.py's checks and
        messages)."""
        self.prefix_cache = _env_bool("TPU_DDP_PREFIX_CACHE",
                                      self.prefix_cache)
        env_rp = os.environ.get("TPU_DDP_ROUTER_POLICY")
        if env_rp:
            self.router_policy = env_rp
        if self.router_policy not in ("least-loaded", "prefix-affinity"):
            raise ValueError(
                f"router_policy={self.router_policy!r}: expected "
                "least-loaded|prefix-affinity (TPU_DDP_ROUTER_POLICY)")
        env_kw = os.environ.get("TPU_DDP_KV_WIRE")
        if env_kw:
            self.kv_wire = env_kw
        if self.kv_wire not in ("none", "bf16", "int8"):
            raise ValueError(
                f"kv_wire={self.kv_wire!r}: expected none|bf16|int8 "
                "(TPU_DDP_KV_WIRE)")
        self.fleet_health = _env_bool("TPU_DDP_FLEET_HEALTH",
                                      self.fleet_health)
        self.fleet_probe_backoff_ms = _env_num(
            "TPU_DDP_FLEET_HEALTH_BACKOFF_MS", float,
            self.fleet_probe_backoff_ms)
        if self.fleet_probe_backoff_ms <= 0:
            raise ValueError(
                f"fleet_probe_backoff_ms must be > 0, got "
                f"{self.fleet_probe_backoff_ms} "
                "(TPU_DDP_FLEET_HEALTH_BACKOFF_MS)")
        self.fleet_step_deadline_ms = _env_num(
            "TPU_DDP_FLEET_HEALTH_DEADLINE_MS", float,
            self.fleet_step_deadline_ms)
        if self.fleet_step_deadline_ms < 0:
            raise ValueError(
                f"fleet_step_deadline_ms must be >= 0, got "
                f"{self.fleet_step_deadline_ms} "
                "(TPU_DDP_FLEET_HEALTH_DEADLINE_MS)")
        self.fleet_retry_budget = _env_num(
            "TPU_DDP_FLEET_RETRY_BUDGET", int, self.fleet_retry_budget)
        if self.fleet_retry_budget < 0:
            raise ValueError(
                f"fleet_retry_budget must be >= 0, got "
                f"{self.fleet_retry_budget} (TPU_DDP_FLEET_RETRY_BUDGET)")
        self.fleet_autoscale = _env_bool("TPU_DDP_FLEET_AUTOSCALE",
                                         self.fleet_autoscale)
        self.scale_cooldown_ms = _env_num(
            "TPU_DDP_SCALE_COOLDOWN_MS", float, self.scale_cooldown_ms)
        if self.scale_cooldown_ms <= 0:
            raise ValueError(
                f"scale_cooldown_ms must be > 0, got "
                f"{self.scale_cooldown_ms} (TPU_DDP_SCALE_COOLDOWN_MS)")

    def _serving_knobs(self) -> None:
        """The serving extensions' env knobs, validated as the JAX
        package validates them."""
        self._fleet_knobs()
        self.serve_queue_limit = _env_num(
            "TPU_DDP_SERVE_QUEUE_LIMIT", int, self.serve_queue_limit)
        if self.serve_queue_limit < 0:
            raise ValueError(
                f"serve_queue_limit must be >= 0, got "
                f"{self.serve_queue_limit} (TPU_DDP_SERVE_QUEUE_LIMIT)")
        self.serve_shed_ms = _env_num(
            "TPU_DDP_SERVE_SHED_MS", float, self.serve_shed_ms)
        if self.serve_shed_ms < 0:
            raise ValueError(
                f"serve_shed_ms must be >= 0, got "
                f"{self.serve_shed_ms} (TPU_DDP_SERVE_SHED_MS)")
        env_tc = os.environ.get("TPU_DDP_TENANT_CLASSES")
        if env_tc is not None:
            self.tenant_classes = env_tc
        # Mirrors serve/scheduler.py parse_tenant_classes, which
        # re-validates at engine construction.
        for entry in str(self.tenant_classes).split(","):
            entry = entry.strip()
            if not entry:
                continue
            name, _, rest = entry.partition("=")
            parts = rest.split(":")
            ok = bool(name.strip()) and "=" in entry and \
                1 <= len(parts) <= 3
            if ok:
                try:
                    ok = float(parts[0]) >= 1 and all(
                        float(p) >= 0 for p in parts[1:])
                except ValueError:
                    ok = False
            if not ok:
                raise ValueError(
                    f"tenant_classes entry {entry!r}: expected "
                    "name=weight[:deadline_ms[:token_budget]] "
                    "(TPU_DDP_TENANT_CLASSES)")
        self.spec_k = _env_num("TPU_DDP_SPEC_K", int, self.spec_k)
        if self.spec_k < 0:
            raise ValueError(
                f"spec_k must be >= 0, got {self.spec_k} "
                "(TPU_DDP_SPEC_K)")
        env_sd = os.environ.get("TPU_DDP_SPEC_DRAFT")
        if env_sd:
            self.spec_draft = env_sd
        # Mirrors serve/speculative.py parse_spec_draft.
        sd = str(self.spec_draft).strip()
        ok = sd in ("chain", "quant")
        if not ok and sd.startswith("self-"):
            ok = sd[len("self-"):].isdigit() and int(sd[5:]) >= 1
        if not ok:
            raise ValueError(
                f"spec_draft={self.spec_draft!r}: expected "
                "chain|self-<j>|quant (TPU_DDP_SPEC_DRAFT)")
        self.kv_tiers = _env_num("TPU_DDP_KV_TIERS", int, self.kv_tiers)
        if self.kv_tiers not in (1, 2, 3):
            raise ValueError(
                f"kv_tiers must be 1, 2 or 3, got {self.kv_tiers} "
                "(TPU_DDP_KV_TIERS)")
        env_kc = os.environ.get("TPU_DDP_KV_COLD_DTYPE")
        if env_kc:
            self.kv_cold_dtype = env_kc
        if self.kv_cold_dtype not in ("int8", "bf16"):
            raise ValueError(
                f"kv_cold_dtype={self.kv_cold_dtype!r}: expected "
                "int8|bf16 (TPU_DDP_KV_COLD_DTYPE)")
        env_cp = os.environ.get("TPU_DDP_CP_PREFILL")
        if env_cp:
            self.cp_prefill = env_cp
        if self.cp_prefill not in ("off", "ring", "ulysses"):
            raise ValueError(
                f"cp_prefill={self.cp_prefill!r}: expected "
                "off|ring|ulysses (TPU_DDP_CP_PREFILL)")

    def per_node_batch_size(self, world_size: int) -> int:
        # int(256 / world_size), as in reference part2/part2b/main.py:177.
        return int(self.global_batch_size / world_size)

    @classmethod
    def preset(cls, name: str, **overrides) -> "TrainConfig":
        """Named run configurations (the JAX package's ``PRESETS``)."""
        try:
            base = dict(PRESETS[name])
        except KeyError:
            raise ValueError(
                f"unknown preset {name!r}; available: {sorted(PRESETS)}"
            ) from None
        base.update(overrides)
        return cls(**base)


# The datasets run_part can load (parts/common.py dispatches on them).
DATASETS = ("cifar10", "imagenet")

# The reference ladder's configuration, the ResNet-50 / ImageNet-1k
# scale-up and ViT on CIFAR-10 (tpu_ddp/utils/config.py PRESETS).
PRESETS = {
    "vgg11_cifar10": {},
    "resnet50_imagenet": dict(model="ResNet50", num_classes=1000,
                              image_size=224, dataset="imagenet"),
    "vit_cifar10": dict(model="ViT-tiny"),
}
