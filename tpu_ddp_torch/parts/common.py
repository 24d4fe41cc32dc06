"""The ladder's CLI (parts/common.py of the JAX package): the reference's
per-node launch contract (README.md:8-19)::

    python -m tpu_ddp_torch.parts partN --num-nodes N [--rank R
        --master-ip IP --master-port P] [--config NAME]
        [--device cuda|cpu]

with the same defaults (master 10.10.1.1:4000, rank from a ``nodeN``
hostname), batch math (per node ``int(256/num_nodes)``), seed (89395),
loss print every 20 iterations and the iteration-1..39 timer. One
process drives one device: ``--device`` (default: the card; ``cpu`` runs
the plain versions of the kernels over gloo). The shrink knobs
``TPU_DDP_MAX_ITERS``, ``TPU_DDP_GLOBAL_BATCH``, ``TPU_DDP_SYNTH_SIZE``
and ``TPU_DDP_COMPUTE_DTYPE`` and the kernel knobs ``TPU_DDP_PALLAS_SGD``
and ``TPU_DDP_PALLAS_BN`` work as in the JAX package. ``--config`` picks
a preset: ``vgg11_cifar10`` (the reference ladder, the default),
``resnet50_imagenet`` (ResNet-50 on ImageNet, or its synthetic stand-in)
or ``vit_cifar10`` (ViT-tiny, on ``full_attention`` as the JAX CLI runs
it).

The loop's host-side knobs work as in the JAX CLI:
``TPU_DDP_DISPATCH_DEPTH`` (steps in flight, 2 by default),
``TPU_DDP_STEPS_PER_DISPATCH`` (K steps per dispatch: one CUDA graph
replay on the card), ``TPU_DDP_PREFETCH`` (host-to-device copies in
flight), ``TPU_DDP_NATIVE_LOADER=1`` (the C++ loader, CIFAR-10 and
ImageNet), ``TPU_DDP_SHARD_EVAL=1`` (the test set sharded over the
group; CIFAR-10 at a world above one), ``TPU_DDP_METRICS_FILE`` (JSONL
metrics, ``{rank}`` expands) and ``TPU_DDP_PROFILE_DIR`` (a
``torch.profiler`` trace of the first epoch). ``TPU_DDP_AUTOTUNE``
(``cached`` or ``search``; tune/) resolves the perf knobs before the
model is built.

``--ckpt-dir D`` writes a checkpoint at every epoch's end (and every
``TPU_DDP_CKPT_EVERY`` steps); ``--resume`` restores the newest verified
one and picks up mid-epoch where it was written. The launcher
(``python -m tpu_ddp_torch.launch``) adds ``--resume`` when it restarts a
failed run.

Under elastic membership (the launcher's ``--elastic-reshard``;
resilience/elastic.py) a membership change out of the epoch loop goes
through ``apply_membership``: the live state is resharded onto the new
world, the loaders are made again at the new rank and world, and the
epoch resumes at the first batch not trained on. A joining process
meets the world through ``join_world`` and starts from the survivors'
beacon. The per-node batch follows the launch world, so the global
batch scales with the live world (the elastic-DDP contract, the JAX
CLI's).
"""

from __future__ import annotations

import argparse
import sys


def parse_arguments(argv=None, require_num_nodes: bool = False):
    """The reference's flag surface (part2/part2a/main.py:20-32) plus
    ``--device``. ``--num-nodes`` is required for every part but part 1,
    where it defaults to 1 (the JAX CLI's contract)."""
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
                   help="dataset root: CIFAR-10 batches dir, or ImageNet "
                        "numpy-shard dir ({split}_images.npy/"
                        "{split}_labels.npy) for --config "
                        "resnet50_imagenet (default: search standard "
                        "paths / IMAGENET_DIR, fall back to synthetic)")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--config", type=str, default="vgg11_cifar10",
                   help="named run preset: vgg11_cifar10, "
                        "resnet50_imagenet or vit_cifar10")
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
    from tpu_ddp_torch.data.imagenet import create_imagenet_loaders
    from tpu_ddp_torch.data.loader import create_data_loaders
    from tpu_ddp_torch.models import get_model
    from tpu_ddp_torch.parallel.bootstrap import (
        get_rank_from_hostname, init_distributed_setup, shutdown,
        test_distributed_setup)
    from tpu_ddp_torch.parallel.sync import canonical_strategy
    from tpu_ddp_torch.resilience import elastic as _elastic
    from tpu_ddp_torch.train.engine import Trainer
    from tpu_ddp_torch.utils.config import (TrainConfig, _env_bool,
                                            refuse_unported_env)
    from tpu_ddp_torch.utils.device import resolve_device
    from tpu_ddp_torch.utils.metrics import from_env as metrics_from_env
    from tpu_ddp_torch.utils.profiling import (profile_dir_from_env,
                                               profile_trace)

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
    # A JOINING process meets the world through the launcher's membership
    # record (the launch world is gone) and starts from the beacon the
    # surviving rank 0 wrote.
    join_epoch = _elastic.join_epoch_from_env()
    elastic_ctl = _elastic.ElasticController.from_env()
    base_world = world_size
    beacon = None
    if join_epoch is not None:
        membership = _elastic.join_world(elastic_ctl, join_epoch,
                                         resolve_device(args.device))
        rank = int(membership["assignments"][str(elastic_ctl.worker_id)])
        world_size = int(membership["world"])
        base_world = int(membership.get("base_world", world_size))
        beacon = _elastic.beacon_dir(elastic_ctl.directory,
                                     int(membership["epoch"]))
        import torch.distributed as dist
        from tpu_ddp_torch.parallel.bootstrap import DistributedContext
        ctx = DistributedContext(
            rank=rank, world_size=world_size,
            device=resolve_device(args.device),
            coordinator=f"tcp://{membership['coordinator']}",
            backend=dist.get_backend())
        print(f"[{part}] joined elastic epoch {membership['epoch']} as "
              f"rank {rank}/{world_size}")
    else:
        # DDP, ZeRO and FSDP run their collectives also at a world of
        # one, whose group meets on this host (it has no peers to reach).
        grouped = strategy in ("fused", "zero", "fsdp")
        master_ip, master_port = args.master_ip, args.master_port
        if world_size == 1 and grouped:
            from tpu_ddp_torch.launch import find_free_port
            master_ip, master_port = "127.0.0.1", str(find_free_port())
        ctx = init_distributed_setup(master_ip, master_port, rank,
                                     world_size, device=args.device,
                                     ddp=grouped)
        if distributed:
            test_distributed_setup(ctx)

    import torch
    cfg = TrainConfig.preset(args.config, epochs=args.epochs)
    if cfg.cudnn_deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    if cfg.in_channels != 3:
        raise ValueError(f"in_channels={cfg.in_channels}: the CIFAR-10 and "
                         "ImageNet loaders give 3-channel (RGB) images")
    # The per-node batch follows the LAUNCH world: a membership change
    # keeps each worker's batch, and the global batch follows the live
    # world.
    batch_size = cfg.per_node_batch_size(base_world)
    # Autotuning (tune/): resolved BEFORE get_model so tuned model-level
    # knobs (pallas_bn, compute_dtype) reach construction; batch_size
    # above is safe, global_batch_size is never searched.
    if cfg.autotune != "off":
        from tpu_ddp_torch import tune
        cfg = tune.resolve(cfg, strategy=strategy, device=ctx.device)
    # TPU_DDP_SHARD_EVAL=1: the test set sharded over the group, CIFAR-10
    # only (the ImageNet loader keeps the replicated contract), and only
    # at a world above one, as in the JAX CLI. TPU_DDP_NATIVE_LOADER is
    # read by the loaders.
    want_shard_eval = _env_bool("TPU_DDP_SHARD_EVAL", False)

    def loaders(rank, world_size):
        """(train, test, shard_eval) for this rank of this world."""
        if cfg.dataset == "imagenet":
            return create_imagenet_loaders(
                rank=rank, world_size=world_size, batch_size=batch_size,
                root=args.data_root, seed=cfg.seed,
                image_size=cfg.image_size,
                num_classes=cfg.num_classes) + (False,)
        return create_data_loaders(
            rank=rank, world_size=world_size, batch_size=batch_size,
            root=args.data_root, seed=cfg.seed,
            shard_eval=want_shard_eval) + (want_shard_eval
                                           and world_size > 1,)

    train_loader, test_loader, shard_eval = loaders(rank, world_size)
    model = get_model(cfg.model, num_classes=cfg.num_classes,
                      in_channels=cfg.in_channels,
                      use_pallas_bn=cfg.pallas_bn,
                      compute_dtype=getattr(torch, cfg.compute_dtype),
                      remat=cfg.remat, act_dtype=cfg.act_dtype)
    metrics = metrics_from_env(rank=rank)
    trainer = Trainer(model, cfg, strategy=strategy, device=ctx.device,
                      metrics=metrics)
    start_epoch = start_iter = 0
    if beacon is not None:
        # The joiner's state is the canonical host tree the surviving
        # rank 0 wrote at the membership epoch: a live hand-off.
        import json
        import os
        state = trainer.restore_checkpoint(beacon)
        with open(os.path.join(beacon, "beacon_meta.json")) as f:
            meta = json.load(f)
        start_epoch, start_iter = int(meta["epoch"]), int(meta["next_iter"])
        print(f"[{part}] joined with beaconed state at step {state.step} "
              f"(epoch {start_epoch}, iter {start_iter})")
    elif args.resume:
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
    epoch, pending_iter = start_epoch, start_iter
    while epoch < cfg.epochs:
        # Per-epoch reshuffle hook (reference part2/part2b/main.py:189).
        train_loader.set_epoch(epoch)
        try:
            # TPU_DDP_PROFILE_DIR: trace the first epoch run.
            with profile_trace(profile_dir_from_env()
                               if epoch == start_epoch else None):
                state, stats = trainer.train_epoch(
                    state, train_loader, epoch=epoch,
                    ckpt_dir=args.ckpt_dir, start_iter=pending_iter)
        except _elastic.MembershipChange as chg:
            # A peer left or is joining: reshard the live state onto the
            # new world and resume this epoch where it stopped.
            res = _elastic.apply_membership(trainer, chg, elastic_ctl)
            if res is None:
                return 0  # this worker is not in the new world
            state, rank, world_size = res.state, res.rank, res.world
            train_loader, test_loader, shard_eval = loaders(rank,
                                                            world_size)
            pending_iter = res.next_iter
            continue
        pending_iter = 0
        # Epoch-end checkpoint, unless the cadence just wrote this step.
        if args.ckpt_dir and not (cfg.ckpt_every_iters and state.step
                                  % cfg.ckpt_every_iters == 0):
            path = trainer.save_checkpoint(args.ckpt_dir, state)
            if path:
                print(f"[{part}] checkpoint saved: {path}")
        trainer.evaluate(state, test_loader, sharded=shard_eval)
        print(f"[{part}] epoch {epoch}: avg iter "
              f"{stats['avg_iter_s']:.4f}s over {stats['timed_iters']} timed "
              f"iters; {stats['iters']} iters total")
        epoch += 1
    metrics.close()
    shutdown(ctx)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in ("part1", "part2a", "part2b", "part3",
                                   "part4", "part5"):
        print("usage: python -m tpu_ddp_torch.parts "
              "{part1,part2a,part2b,part3,part4,part5} [flags]",
              file=sys.stderr)
        return 2
    return run_part(argv[0], argv[1:])
