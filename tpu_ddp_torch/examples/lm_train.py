"""Distributed transformer-LM training demo (examples/lm_train.py of the
JAX package), one process per card, data parallel::

    python -m tpu_ddp_torch.examples.lm_train --num-nodes N [--rank R \
        --master-ip IP --master-port P] [--device cuda|cpu]

The flags are the ladder's (``parts/common.py:parse_arguments``), the
bootstrap the same (nccl on the card, gloo on the CPU). Batches are
synthetic tokens from ``np.random.default_rng(1234)``, identical on every
process; each process feeds its contiguous shard of the global batch, at
sequence length 32 and f32 compute. Env knobs, with the JAX CLI's
defaults: ``TPU_DDP_LM_STEPS`` (5), ``TPU_DDP_LM_PRESET``
(TransformerLM-tiny), ``TPU_DDP_GLOBAL_BATCH`` (8), ``TPU_DDP_LM_ACCUM``
(1), ``TPU_DDP_LM_OPT`` (adamw; ``adafactor`` builds
``Adafactor(min_dim_size_to_factor=8)`` as the JAX CLI does) and
``TPU_DDP_LM_CLIP`` (the global-norm clip, 0 = off), ``TPU_DDP_LM_FSDP``
(``1``: ``param_sharding='fsdp'``) and ``TPU_DDP_LM_OPT_SHARD``
(``replicated``, ``zero1`` or ``zero2``; ``TPU_DDP_LM_ZERO1=1`` is the
older spelling of ``zero1``). ``TPU_DDP_LM_PRESET`` takes the MoE presets
too (``TransformerLM-moe-tiny``, ``-moe-small``, ``-moe-large``, at ep =
1 as in the JAX CLI), and ``TPU_DDP_MOE_EXPERTS``, ``_TOP_K`` and
``_CAPACITY`` (utils/config.py) override the preset's ``moe_experts``,
``moe_top_k`` and ``moe_capacity_factor`` where set, so
``TPU_DDP_MOE_EXPERTS=4`` routes the MLPs of a dense preset; a MoE run
ends with the routing counters of the last batch
(``LMTrainer.route_stats``, one slot per layer). The knobs of
axes the port does not carry yet (tensor and pipeline parallelism, the
sequence-parallel mode) raise when set to anything but their default.
"""

from __future__ import annotations

import os
import sys

# name -> (the value that means "off", what it would switch on, ROADMAP
# Queue 1 item).
_UNPORTED_LM_ENV = {
    "TPU_DDP_LM_TP": ("1", "tensor parallelism", "item 10.6"),
    "TPU_DDP_LM_PP": ("1", "pipeline parallelism", "item 10.7"),
    "TPU_DDP_LM_SP_MODE": ("ring", "Ulysses attention", "item 10.5"),
}


def refuse_unported_lm_env() -> None:
    for name, (off, what, item) in _UNPORTED_LM_ENV.items():
        raw = os.environ.get(name)
        if raw is None or raw.strip() in ("", off):
            continue
        raise NotImplementedError(
            f"{name}={raw!r}: {what} is not ported to tpu_ddp_torch yet "
            f"(ROADMAP Queue 1 {item}); unset it to run the port")


# TPU_DDP_MOE_* -> (TrainConfig field, TransformerLM field).
_MOE_ENV = {
    "TPU_DDP_MOE_EXPERTS": ("moe_experts", "moe_experts"),
    "TPU_DDP_MOE_TOP_K": ("moe_top_k", "moe_top_k"),
    "TPU_DDP_MOE_CAPACITY": ("moe_capacity", "moe_capacity_factor"),
}


def moe_overrides(preset: str) -> dict:
    """The TransformerLM fields that the set ``TPU_DDP_MOE_*`` variables
    give ``preset`` (parsed and validated by ``TrainConfig``). A top-k or
    capacity for a model left with no routed layer raises: nothing would
    read it."""
    from tpu_ddp_torch.models.transformer import make_transformer
    from tpu_ddp_torch.utils.config import TrainConfig
    cfg = TrainConfig()
    over = {field: getattr(cfg, attr)
            for env, (attr, field) in _MOE_ENV.items()
            if os.environ.get(env, "") != ""}
    experts = over.get("moe_experts",
                       make_transformer(preset).moe_experts)
    unread = [env for env, (_, field) in _MOE_ENV.items()
              if field in over and field != "moe_experts"]
    if not experts and unread:
        raise ValueError(
            f"{' and '.join(unread)} set for {preset} with no experts: a "
            "dense model has no routed layer to read them; set "
            "TPU_DDP_MOE_EXPERTS or take a MoE preset")
    return over


def main(argv=None) -> int:
    from tpu_ddp_torch.parts.common import parse_arguments
    args = parse_arguments(argv, require_num_nodes=True)
    refuse_unported_lm_env()
    if args.ckpt_dir:
        # The JAX CLI has no checkpoints either; LMTrainer.save_checkpoint
        # and restore_checkpoint are the API.
        raise NotImplementedError(
            "--ckpt-dir/--resume: examples/lm_train.py does not checkpoint;"
            " call LMTrainer.save_checkpoint/restore_checkpoint")

    import numpy as np
    import torch

    from tpu_ddp_torch.models.transformer import make_transformer
    from tpu_ddp_torch.ops.optim import Adafactor
    from tpu_ddp_torch.parallel.bootstrap import (get_rank_from_hostname,
                                                  init_distributed_setup,
                                                  shutdown,
                                                  test_distributed_setup)
    from tpu_ddp_torch.train.lm import (LMTrainer, format_route_stats,
                                       make_lm_batch)
    from tpu_ddp_torch.utils.config import refuse_unported_env

    refuse_unported_env()
    world = args.num_nodes or 1
    rank = (0 if world <= 1
            else args.rank if args.rank is not None
            else get_rank_from_hostname())
    ctx = init_distributed_setup(args.master_ip, args.master_port, rank,
                                 world, device=args.device)
    if world > 1:
        test_distributed_setup(ctx)

    steps = int(os.environ.get("TPU_DDP_LM_STEPS", "5"))
    preset = os.environ.get("TPU_DDP_LM_PRESET", "TransformerLM-tiny")
    accum = int(os.environ.get("TPU_DDP_LM_ACCUM", "1"))
    # TPU_DDP_LM_CLIP: global-norm gradient clip threshold (0 = off).
    clip = float(os.environ.get("TPU_DDP_LM_CLIP", "0")) or None
    opt_name = os.environ.get("TPU_DDP_LM_OPT", "adamw")
    if opt_name == "adafactor":
        optimizer = Adafactor(min_dim_size_to_factor=8)
    elif opt_name == "adamw":
        optimizer = None  # LMTrainer's AdamW default
    else:
        raise ValueError(f"TPU_DDP_LM_OPT={opt_name!r}: expected "
                         "'adamw' or 'adafactor'")
    fsdp = os.environ.get("TPU_DDP_LM_FSDP", "0") == "1"
    opt_shard = os.environ.get(
        "TPU_DDP_LM_OPT_SHARD",
        "zero1" if os.environ.get("TPU_DDP_LM_ZERO1", "0") == "1"
        else "replicated")
    global_batch = int(os.environ.get("TPU_DDP_GLOBAL_BATCH", "8"))
    if global_batch % world:
        raise ValueError(f"TPU_DDP_GLOBAL_BATCH={global_batch} not "
                         f"divisible by the world size {world}")
    seq_len = 32

    model = make_transformer(preset, max_seq_len=seq_len,
                             compute_dtype=torch.float32,
                             **moe_overrides(preset))
    trainer = LMTrainer(model, device=ctx.device, grad_accum=accum,
                        optimizer=optimizer, clip_grad_norm=clip,
                        param_sharding="fsdp" if fsdp else "replicated",
                        opt_sharding=opt_shard)
    state = trainer.init_state(seed=0)
    print(f"[lm_train] rank={rank} world={world} dp={trainer.dp} "
          f"sp=1 tp=1 pp=1 fsdp={fsdp} "
          f"opt_shard={opt_shard} opt={opt_name} accum={accum} clip={clip} "
          f"preset={preset}" + (
              f" moe={model.moe_experts}x top{model.moe_top_k} "
              f"cf={model.moe_capacity_factor}" if model.moe_experts
              else ""))

    # Deterministic synthetic tokens, identical on every process; each
    # process feeds its contiguous shard of the global batch.
    rng = np.random.default_rng(1234)
    tokens = rng.integers(0, model.vocab_size,
                          size=(global_batch, seq_len + 1))
    per = global_batch // world
    local = tokens[rank * per:(rank + 1) * per]
    x, y = trainer.put_batch(*make_lm_batch(local))
    for step in range(steps):
        state, loss = trainer.train_step(state, x, y)
        # This process's shard loss: every node prints its own running
        # loss, as in the reference.
        print(f"[lm_train] step {step + 1}/{steps} loss {float(loss):.4f}")
    if model.moe_experts:
        route = format_route_stats(trainer.route_stats(state, local[:, :-1]))
        print(f"[lm_train] route{route}")
    shutdown(ctx)
    return 0


if __name__ == "__main__":
    sys.exit(main())
