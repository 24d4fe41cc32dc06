"""Serving configuration: the serve fields of tpu_ddp/utils/config.py's
``TrainConfig``, with the same names, defaults, ``TPU_DDP_*`` env
variables and validation, so a knob means the same thing in both
packages. The training fields arrive with the slices that use them.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class TrainConfig:
    """The run configuration (serve fields only, for now)."""

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
