"""The ladder's CLI (parts/common.py of the JAX package): the reference's
per-node launch contract (README.md:8-19)::

    python -m tpu_ddp_torch.parts partN --num-nodes N [--rank R
        --master-ip IP --master-port P] [--device cuda|cpu]

with the same defaults (master 10.10.1.1:4000, rank from a ``nodeN``
hostname), batch math (per node ``int(256/num_nodes)``), seed (89395),
loss print every 20 iterations and the iteration-1..39 timer. One
process drives one device: ``--device`` (default: the card; ``cpu`` runs
the plain versions of the kernels over gloo). The shrink knobs
``TPU_DDP_MAX_ITERS``, ``TPU_DDP_GLOBAL_BATCH``, ``TPU_DDP_SYNTH_SIZE``
and ``TPU_DDP_COMPUTE_DTYPE`` and the kernel knobs ``TPU_DDP_PALLAS_SGD``
and ``TPU_DDP_PALLAS_BN`` work as in the JAX package.

``--ckpt-dir D`` writes a checkpoint at every epoch's end (and every
``TPU_DDP_CKPT_EVERY`` steps); ``--resume`` restores the newest verified
one and picks up mid-epoch where it was written. The launcher
(``python -m tpu_ddp_torch.launch``) adds ``--resume`` when it restarts a
failed run.
"""

from __future__ import annotations

import argparse
import sys


def parse_arguments(argv=None, require_num_nodes: bool = False):
    """The reference's flag surface (part2/part2a/main.py:20-32) plus
    ``--device``. ``--num-nodes`` is required for the distributed parts
    and defaults to 1 for part1."""
    p = argparse.ArgumentParser()
    p.add_argument("--master-ip", type=str, default="10.10.1.1",
                   help="rendezvous coordinator IP (rank 0's)")
    p.add_argument("--master-port", type=str, default="4000",
                   help="rendezvous coordinator port")
    p.add_argument("--num-nodes", type=int,
                   required=require_num_nodes,
                   default=None if require_num_nodes else 1,
                   help="world size (number of processes)")
    p.add_argument("--rank", type=int, default=None,
                   help="process rank; default inferred from hostname "
                        "nodeN (reference part2/part2a/main.py:35-39)")
    p.add_argument("--data-root", type=str, default=None,
                   help="CIFAR-10 batches dir (default: search standard "
                        "paths, fall back to synthetic)")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--config", type=str, default="vgg11_cifar10",
                   help="named run preset (the port has vgg11_cifar10)")
    p.add_argument("--ckpt-dir", type=str, default=None,
                   help="checkpoint directory (epoch ends, and every "
                        "TPU_DDP_CKPT_EVERY steps)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest verified checkpoint in "
                        "--ckpt-dir")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default), cuda:N or cpu")
    args = p.parse_args(argv)
    if args.resume and not args.ckpt_dir:
        p.error("--resume requires --ckpt-dir")
    return args


def run_part(part: str, argv=None):
    """Wire one part (the reference's ``main()``,
    part2/part2b/main.py:169-195) and run train + eval."""
    from tpu_ddp_torch.data.loader import create_data_loaders
    from tpu_ddp_torch.models.vgg import get_model
    from tpu_ddp_torch.parallel.bootstrap import (
        get_rank_from_hostname, init_distributed_setup, shutdown,
        test_distributed_setup)
    from tpu_ddp_torch.parallel.sync import canonical_strategy
    from tpu_ddp_torch.train.engine import Trainer
    from tpu_ddp_torch.utils.config import TrainConfig, refuse_unported_env

    strategy = canonical_strategy(part)
    distributed = part != "part1"
    args = parse_arguments(argv, require_num_nodes=distributed)
    refuse_unported_env()
    world_size = args.num_nodes or 1
    if world_size <= 1:
        rank = 0
    elif args.rank is not None:
        rank = args.rank
    else:
        rank = get_rank_from_hostname()
    ctx = init_distributed_setup(args.master_ip, args.master_port, rank,
                                 world_size, device=args.device,
                                 ddp=strategy == "fused")
    if distributed:
        test_distributed_setup(ctx)

    import torch
    cfg = TrainConfig.preset(args.config, epochs=args.epochs)
    if cfg.cudnn_deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    batch_size = cfg.per_node_batch_size(world_size)
    train_loader, test_loader = create_data_loaders(
        rank=rank, world_size=world_size, batch_size=batch_size,
        root=args.data_root, seed=cfg.seed)
    model = get_model(cfg.model, num_classes=cfg.num_classes,
                      use_pallas_bn=cfg.pallas_bn,
                      compute_dtype=getattr(torch, cfg.compute_dtype))
    trainer = Trainer(model, cfg, strategy=strategy, device=ctx.device)
    start_epoch = start_iter = 0
    if args.resume:
        state = trainer.restore_checkpoint(args.ckpt_dir)
        # Completed epochs = step // iterations per epoch; a mid-epoch
        # checkpoint also places the run step % iterations into its
        # epoch, and those batches are skipped (JAX parts/common.py).
        iters_per_epoch = len(train_loader)
        if cfg.max_iters is not None:
            iters_per_epoch = min(iters_per_epoch, cfg.max_iters)
        iters_per_epoch = max(iters_per_epoch, 1)
        start_epoch = state.step // iters_per_epoch
        start_iter = state.step % iters_per_epoch
        print(f"[{part}] resumed from {args.ckpt_dir} at step {state.step} "
              f"(epoch {start_epoch}, iter {start_iter})")
    else:
        state = trainer.init_state()
    print(f"[{part}] strategy={strategy} world_size={world_size} "
          f"rank={rank} dp_slots=1 per-node batch={batch_size} "
          f"platform={ctx.device.type}")
    for epoch in range(start_epoch, cfg.epochs):
        # Per-epoch reshuffle hook (reference part2/part2b/main.py:189).
        train_loader.set_epoch(epoch)
        state, stats = trainer.train_epoch(
            state, train_loader, epoch=epoch, ckpt_dir=args.ckpt_dir,
            start_iter=start_iter if epoch == start_epoch else 0)
        # Epoch-end checkpoint, unless the cadence just wrote this step.
        if args.ckpt_dir and not (cfg.ckpt_every_iters and state.step
                                  % cfg.ckpt_every_iters == 0):
            path = trainer.save_checkpoint(args.ckpt_dir, state)
            if path:
                print(f"[{part}] checkpoint saved: {path}")
        trainer.evaluate(state, test_loader)
        print(f"[{part}] epoch {epoch}: avg iter "
              f"{stats['avg_iter_s']:.4f}s over {stats['timed_iters']} timed "
              f"iters; {stats['iters']} iters total")
    shutdown(ctx)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in ("part1", "part2a", "part2b", "part3",
                                   "part4", "part5"):
        print("usage: python -m tpu_ddp_torch.parts "
              "{part1,part2a,part2b,part3} [flags]", file=sys.stderr)
        return 2
    return run_part(argv[0], argv[1:])
