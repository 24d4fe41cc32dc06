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
(1). The knobs of axes the port does not carry yet (FSDP, ZeRO, the
optimizer choice, clipping, tensor and pipeline parallelism, the
sequence-parallel mode) raise when set to anything but their default.
"""

from __future__ import annotations

import os
import sys

# name -> (the value that means "off", what it would switch on, ROADMAP
# Queue 1 item).
_UNPORTED_LM_ENV = {
    "TPU_DDP_LM_FSDP": ("0", "FSDP", "item 9.4"),
    "TPU_DDP_LM_ZERO1": ("0", "ZeRO-1", "item 9.4"),
    "TPU_DDP_LM_OPT_SHARD": ("replicated", "ZeRO-1/2", "item 9.4"),
    "TPU_DDP_LM_OPT": ("adamw", "Adafactor", "item 9.1"),
    "TPU_DDP_LM_CLIP": ("0", "gradient clipping", "item 10.4"),
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
    from tpu_ddp_torch.parallel.bootstrap import (get_rank_from_hostname,
                                                  init_distributed_setup,
                                                  shutdown,
                                                  test_distributed_setup)
    from tpu_ddp_torch.train.lm import LMTrainer, make_lm_batch
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
    global_batch = int(os.environ.get("TPU_DDP_GLOBAL_BATCH", "8"))
    if global_batch % world:
        raise ValueError(f"TPU_DDP_GLOBAL_BATCH={global_batch} not "
                         f"divisible by the world size {world}")
    seq_len = 32

    model = make_transformer(preset, max_seq_len=seq_len,
                             compute_dtype=torch.float32)
    trainer = LMTrainer(model, device=ctx.device, grad_accum=accum)
    state = trainer.init_state(seed=0)
    print(f"[lm_train] rank={rank} world={world} dp={trainer.dp} "
          f"sp=1 tp=1 pp=1 fsdp=False "
          f"opt_shard=replicated opt=adamw accum={accum} clip=None "
          f"preset={preset}")

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
    shutdown(ctx)
    return 0


if __name__ == "__main__":
    sys.exit(main())
