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
(``LMTrainer.route_stats``, one slot per layer).
``TPU_DDP_LM_SP_MODE`` (``ring`` or ``ulysses``) is validated and passed
to the trainer; as in the JAX CLI, whose mesh has sp = 1, it is inert.
``TPU_DDP_LM_TP`` (1) is the Megatron tensor-parallel extent: the world
is dp x tp, rank ``d * tp + t``, and the batch splits over the
``world // tp`` dp groups, the tp peers of one group feeding the same
rows, as in the JAX CLI. ``TPU_DDP_LM_PP`` (1) > 1 selects the pipeline
rung (``PipelineLMTrainer``, one stage per process over a pp group; the
world dp x tp x pp, rank ``(d * tp + t) * pp + p``) with the schedule
knobs ``TPU_DDP_PP_SCHEDULE`` (gpipe), ``TPU_DDP_PP_MICROBATCHES`` (0 =
one per stage) and ``TPU_DDP_PP_VIRTUAL`` (1), as the JAX CLI reads them
(``TrainConfig``; ``launch lm --pp-*`` sets them). Each process feeds the
rows of its data shard (``data_index``), so its tp and pp peers feed the
same rows; ``TPU_DDP_LM_ACCUM`` has no effect there (the microbatches
are the accumulation), as in the JAX CLI.
"""

from __future__ import annotations

import os
import sys


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
    from tpu_ddp_torch.train.lm import (LMTrainer, PipelineLMTrainer,
                                       format_route_stats, make_lm_batch)
    from tpu_ddp_torch.utils.config import TrainConfig, refuse_unported_env

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
    sp_mode = os.environ.get("TPU_DDP_LM_SP_MODE", "ring")
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
    tp = int(os.environ.get("TPU_DDP_LM_TP", "1"))
    if tp < 1:
        raise ValueError(f"TPU_DDP_LM_TP={tp}: must be >= 1")
    # TPU_DDP_LM_PP > 1 selects the pipeline rung; the schedule knobs
    # ride in through TrainConfig's env parsing (launch lm --pp-*).
    pp = int(os.environ.get("TPU_DDP_LM_PP", "1"))
    if pp < 1:
        raise ValueError(f"TPU_DDP_LM_PP={pp}: must be >= 1")
    knobs = TrainConfig()
    if world % (tp * pp):
        # make_mesh(mp=tp, pp=pp)'s refusal in the JAX CLI.
        raise ValueError(f"{world} devices not divisible by "
                         f"sp*mp*pp*ep={tp * pp}")
    global_batch = int(os.environ.get("TPU_DDP_GLOBAL_BATCH", "8"))
    # The batch splits over the data shards (world // (tp * pp)), not
    # over every process: the tp and pp peers of a shard feed the same
    # rows.
    dp_groups = max(world // (tp * pp), 1)
    if global_batch % dp_groups:
        raise ValueError(f"TPU_DDP_GLOBAL_BATCH={global_batch} not "
                         f"divisible by dp process groups {dp_groups} "
                         f"(world {world} / tp {tp} / pp {pp})")
    seq_len = 32

    model = make_transformer(preset, max_seq_len=seq_len,
                             compute_dtype=torch.float32,
                             **moe_overrides(preset))
    layouts = dict(param_sharding="fsdp" if fsdp else "replicated",
                   opt_sharding=opt_shard)
    if pp > 1:
        trainer = PipelineLMTrainer(
            model, device=ctx.device, num_micro=knobs.pp_microbatches or None,
            schedule=knobs.pp_schedule, pp_virtual=knobs.pp_virtual,
            optimizer=optimizer, clip_grad_norm=clip, sp_mode=sp_mode,
            tp=tp, pp=pp, **layouts)
    else:
        trainer = LMTrainer(model, device=ctx.device, grad_accum=accum,
                            optimizer=optimizer, clip_grad_norm=clip,
                            sp_mode=sp_mode, tp=tp, **layouts)
    state = trainer.init_state(seed=0)
    print(f"[lm_train] rank={rank} world={world} dp={trainer.dp} "
          f"sp=1 tp={trainer.tp} pp={pp} fsdp={fsdp} "
          f"opt_shard={opt_shard} opt={opt_name} accum={accum} clip={clip} "
          f"preset={preset}" + (
              f" moe={model.moe_experts}x top{model.moe_top_k} "
              f"cf={model.moe_capacity_factor}" if model.moe_experts
              else "") + (
              f" schedule={knobs.pp_schedule} micro={trainer.num_micro} "
              f"virtual={knobs.pp_virtual}" if pp > 1 else ""))

    # Deterministic synthetic tokens, identical on every process; each
    # data shard feeds its contiguous rows of the global batch (the
    # process's data_index: its mesh coordinate with tp and pp taken
    # out, rank // tp at pp 1; the JAX CLI's one process takes rank //
    # tp).
    rng = np.random.default_rng(1234)
    tokens = rng.integers(0, model.vocab_size,
                          size=(global_batch, seq_len + 1))
    per = global_batch // dp_groups
    slot = trainer.data_index
    local = tokens[slot * per:(slot + 1) * per]
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
