"""Run configuration: the fields of tpu_ddp/utils/config.py's
``TrainConfig`` that the port's slices use (serving, the VGG training
ladder, checkpoints and the step guard), with the same names, defaults,
``TPU_DDP_*`` env variables and validation, so a knob means the same
thing in both packages.

A knob of the JAX package that the port does not carry yet is refused,
never ignored: its field is absent (passing it is a ``TypeError``) and
setting its env variable to anything but the default raises
``NotImplementedError`` naming the ROADMAP item that will port it.
"""

from __future__ import annotations

import dataclasses
import os

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
_UNPORTED_ENV = {
    "TPU_DDP_OVERLAP": (_FALSE, "item 9.2 (parallel/overlap.py)"),
    "TPU_DDP_BUCKET_MB": (("25",), "item 9.2 (parallel/overlap.py)"),
    "TPU_DDP_GRAD_COMPRESS": (("none",), "item 9.3 (parallel/compress.py)"),
    "TPU_DDP_STEPS_PER_DISPATCH": (("1",),
                                   "item 9.5 (train/pipeline.py)"),
    "TPU_DDP_DISPATCH_DEPTH": (("0",), "item 9.5 (train/pipeline.py)"),
    "TPU_DDP_PREFETCH": (("0",), "item 9.11 (data/prefetch.py)"),
    "TPU_DDP_ELASTIC_RESHARD": (_FALSE,
                                "item 9.6b (resilience/elastic.py)"),
    "TPU_DDP_ELASTIC_DIR": ((), "item 9.6b (resilience/elastic.py)"),
    "TPU_DDP_REMAT": (("none",), "item 9.7 (memory/policy.py)"),
    "TPU_DDP_ACT_DTYPE": (("compute",), "item 9.7 (memory/policy.py)"),
    "TPU_DDP_AUTOTUNE": (("off",), "item 9.8 (tune/)"),
    "TPU_DDP_AUDIT": (("off",), "item 12 (analysis/)"),
    "TPU_DDP_NATIVE_LOADER": (_FALSE, "item 9.11 (data/native.py)"),
    "TPU_DDP_SHARD_EVAL": (_FALSE, "item 9.11 (sharded evaluation)"),
    "TPU_DDP_METRICS_FILE": ((), "item 9.11 (utils/metrics.py JSONL sink)"),
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

    # Model (the data is CIFAR-10, the only dataset ported).
    model: str = "VGG11"
    num_classes: int = 10

    # Optimizer: SGD(lr=0.1, momentum=0.9, weight_decay=1e-4)
    # (reference part1/main.py:124-125).
    learning_rate: float = 0.1
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
    # The port's own knob (the JAX package runs on XLA, which sums in a
    # fixed order): cuDNN's deterministic algorithms, no autotuning, so
    # two runs of the same steps give the same bits (resume drills).
    # Applied by parts/common.py:run_part; env TPU_DDP_CUDNN_DETERMINISTIC.
    cudnn_deterministic: bool = False

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

    def __post_init__(self):
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
        self.cudnn_deterministic = _env_bool("TPU_DDP_CUDNN_DETERMINISTIC",
                                             self.cudnn_deterministic)
        self.pallas_sgd = _env_bool("TPU_DDP_PALLAS_SGD", self.pallas_sgd)
        self.pallas_bn = _env_bool("TPU_DDP_PALLAS_BN", self.pallas_bn)
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

    def per_node_batch_size(self, world_size: int) -> int:
        # int(256 / world_size), as in reference part2/part2b/main.py:177.
        return int(self.global_batch_size / world_size)

    @classmethod
    def preset(cls, name: str, **overrides) -> "TrainConfig":
        """Named run configurations (the JAX package's ``PRESETS``)."""
        if name in _UNPORTED_PRESETS:
            raise NotImplementedError(
                f"preset {name!r} is not ported to tpu_ddp_torch yet "
                f"(ROADMAP Queue 1 {_UNPORTED_PRESETS[name]})")
        try:
            base = dict(PRESETS[name])
        except KeyError:
            raise ValueError(
                f"unknown preset {name!r}; available: {sorted(PRESETS)}"
            ) from None
        base.update(overrides)
        return cls(**base)


# The reference ladder's configuration.
PRESETS = {
    "vgg11_cifar10": {},
}
_UNPORTED_PRESETS = {
    "resnet50_imagenet": "item 9.10 (models/resnet.py, data/imagenet.py)",
    "vit_cifar10": "item 9.10 (models/vit.py)",
}
