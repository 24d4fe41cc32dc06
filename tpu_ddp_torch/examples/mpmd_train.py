"""Two-process MPMD pipeline drill (examples/mpmd_train.py of the JAX
package): one stage per process over a socket edge::

    python -m tpu_ddp_torch.examples.mpmd_train --num-nodes 2 --rank R \
        --master-ip IP --master-port P [--device cuda|cpu]

or both processes through the launcher, ``python -m tpu_ddp_torch.launch
mpmd --nproc 2 [--device cpu|cuda:0]`` (``cuda:0`` keeps both stages on
one card: the edge is a TCP socket, not a collective, so two processes
can share it).

Each process is one pipeline slice: it runs only its stage's programs
(parallel/mpmd.py:StageProgram), holds only its stage's parameters and
optimizer state, and trades activations and cotangents with its peer
over one TCP connection in the cross-slice wire format. There is no
process group and no collective: the edge is the only communication.
Both processes derive the same seed-0 parameters on their device and
keep their stage's. Rank 1 listens on ``--master-port``, rank 0 dials
``--master-ip`` (retrying for 60 s: the launcher gives no start order).

Env knobs, with the JAX CLI's defaults: ``TPU_DDP_MPMD_STEPS`` (4),
``TPU_DDP_MPMD_COMPRESS`` (bf16; none, bf16, int8 or int8-noef: the
edge's wire format), ``TPU_DDP_MPMD_MICRO`` (microbatches, 4),
``TPU_DDP_LM_PRESET`` (TransformerLM-tiny); sequence 32, f32 compute,
``SGD(0.1, momentum 0.9)``, batch 2 x microbatches of tokens from
``np.random.default_rng(1234)``.

Exit contract: rank 1 ends with ``[mpmd] RESULT ... OK`` and exit 0 when
the loss fell and the edge's compression ratio matched its format; exit 1
otherwise. Both ranks print their edge's stats and their stage's
``StageScheduler`` stats.
"""

from __future__ import annotations

import os
import socket
import sys
import time

PP = 2  # two processes, one stage each
# The least dense/wire byte ratio each wire format must reach.
MIN_RATIO = {"none": 1.0, "bf16": 1.9, "int8": 3.5, "int8-noef": 3.5}


def _connect(rank: int, ip: str, port: int) -> socket.socket:
    """Stage 1 listens, stage 0 dials (with retry). One full-duplex TCP
    connection carries both the down edge (activations) and the up edge
    (cotangents)."""
    if rank == 1:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as srv:
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind(("0.0.0.0", port))
            srv.listen(1)
            conn, _ = srv.accept()
        return conn
    deadline = time.time() + 60
    while True:
        try:
            return socket.create_connection((ip, port), timeout=5)
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.2)


def main(argv=None) -> int:
    from tpu_ddp_torch.parts.common import parse_arguments
    args = parse_arguments(argv, require_num_nodes=True)
    if args.num_nodes != PP:
        raise SystemExit(f"mpmd_train is a {PP}-process drill "
                         f"(got --num-nodes {args.num_nodes})")
    rank = args.rank if args.rank is not None else 0
    if rank not in range(PP):
        raise SystemExit(f"--rank {rank}: expected 0 or 1")

    import numpy as np
    import torch

    from tpu_ddp_torch.models.transformer import make_transformer
    from tpu_ddp_torch.ops.optim import SGD
    from tpu_ddp_torch.parallel.compress import EdgeCodec
    from tpu_ddp_torch.parallel.mpmd import (MPMDPipeline, SliceTopology,
                                             SocketEdge, split_stage_params)
    from tpu_ddp_torch.parallel.pipeline import map_tree, stack_block_params
    from tpu_ddp_torch.train.pipeline import StageScheduler
    from tpu_ddp_torch.utils.device import resolve_device
    from tpu_ddp_torch.utils.tree import tree_leaves

    device = resolve_device(args.device)
    steps = int(os.environ.get("TPU_DDP_MPMD_STEPS", "4"))
    spec = os.environ.get("TPU_DDP_MPMD_COMPRESS", "bf16")
    if spec not in MIN_RATIO:
        raise SystemExit(f"TPU_DDP_MPMD_COMPRESS={spec!r}: expected one of "
                         f"{sorted(MIN_RATIO)}")
    num_micro = int(os.environ.get("TPU_DDP_MPMD_MICRO", "4"))
    preset = os.environ.get("TPU_DDP_LM_PRESET", "TransformerLM-tiny")
    seq_len = 32
    batch = 2 * num_micro

    model = make_transformer(preset, max_seq_len=seq_len,
                             compute_dtype=torch.float32)
    # Both processes derive the same parameters from the same seed, then
    # keep only their stage's (copied out of the whole tree).
    params = stack_block_params(model.init(
        torch.Generator(device=device).manual_seed(0)))
    params_s = map_tree(lambda t: t.clone(),
                        split_stage_params(params, PP)[rank])
    del params

    # Both directions over one socket; each process owns the codec of
    # the direction it SENDS (error feedback is sender state). The two
    # stages are two slices, so the one boundary is cross-slice.
    sock = _connect(rank, args.master_ip, int(args.master_port))
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    edge = SocketEdge(sock, EdgeCodec(spec, seed=rank), device=device)

    sched = StageScheduler(PP, depth=2)
    pipe = MPMDPipeline(model, PP, seq_len, num_micro=num_micro,
                        topology=SliceTopology.even(PP, PP),
                        compress=spec, scheduler=sched, device=device)

    rng = np.random.default_rng(1234)
    tokens = rng.integers(0, model.vocab_size, size=(batch, seq_len + 1))
    x, y = tokens[:, :-1], tokens[:, 1:]
    mb = batch // num_micro
    micro = x.reshape(num_micro, mb, seq_len)
    tmicro = y.reshape(num_micro, mb, seq_len)
    denom = float(batch * seq_len)

    opt = SGD(learning_rate=0.1, momentum=0.9)
    leaves = tree_leaves(params_s)
    opt_state = opt.init(leaves)
    losses = []
    for step in range(steps):
        if rank == 0:
            grads, _ = pipe.run_stage(0, params_s, micro, None,
                                      None, edge, edge, None)
        else:
            grads, loss_sum = pipe.run_stage(1, params_s, None, tmicro,
                                             edge, None, None, edge)
            losses.append(float(loss_sum) / denom)
            print(f"[mpmd] rank={rank} step {step + 1}/{steps} "
                  f"loss {losses[-1]:.4f}", flush=True)
        g = tree_leaves(grads)
        torch._foreach_div_(g, denom)
        opt.apply(leaves, g, opt_state)
        sched.step_done(step)

    stats = edge.stats()
    print(f"[mpmd] rank={rank} edge {stats}", flush=True)
    print(f"[mpmd] rank={rank} sched {sched.stats()['stages'][rank]}",
          flush=True)
    sock.close()
    if rank == 1:
        ok = losses[-1] < losses[0] and stats["ratio"] >= MIN_RATIO[spec]
        print(f"[mpmd] RESULT loss {losses[0]:.4f}->{losses[-1]:.4f} "
              f"ratio {stats['ratio']} ({spec}) "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
