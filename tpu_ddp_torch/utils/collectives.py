"""Collective microbenchmarks over the process group
(tpu_ddp/utils/collectives.py): the primitives the ladder's sync rungs
are built from, timed alone, so a regression in the communication layer
shows as a number rather than as step-time drift.

The JAX package's ops over its ``dp`` mesh axis map to the process
group's::

    psum          -> all_reduce
    psum_scatter  -> reduce_scatter_tensor
    all_gather    -> all_gather_into_tensor
    ppermute      -> a ring hop: paired isend/irecv to rank + 1
    all_to_all    -> all_to_all_single

Each op is run once (warm-up), then ``iters`` times back to back with one
wait at the end (``torch.cuda.synchronize`` on the card; gloo's calls on
host tensors return complete). Bandwidth is the per-rank payload over
the wall time: comparable across ops, not a link's line rate. At world 1
nothing crosses a link and the numbers price the launch and a local
copy.

    python -m tpu_ddp_torch.utils.collectives [--mb 4] [--dtype bfloat16]

runs it in one process on the card (world 1 over NCCL, on a group of one
at 127.0.0.1); a multi-process group calls :func:`bench_collectives`
from every rank.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist


def _ring_hop(out, x, rank: int, n: int, group) -> None:
    if n == 1:
        out.copy_(x)
        return
    reqs = [dist.isend(x, (rank + 1) % n, group=group),
            dist.irecv(out, (rank - 1) % n, group=group)]
    for r in reqs:
        r.wait()


def _ops(n: int, rank: int, group):
    """name -> (output factory from the input, the call)."""
    return {
        "psum": (lambda x: x.clone(),
                 lambda out, x: dist.all_reduce(out, group=group)),
        "psum_scatter": (
            lambda x: torch.empty(x.numel() // n, dtype=x.dtype,
                                  device=x.device),
            lambda out, x: dist.reduce_scatter_tensor(out, x, group=group)),
        "all_gather": (
            lambda x: torch.empty(x.numel() * n, dtype=x.dtype,
                                  device=x.device),
            lambda out, x: dist.all_gather_into_tensor(out, x,
                                                       group=group)),
        "ppermute": (torch.empty_like,
                     lambda out, x: _ring_hop(out, x, rank, n, group)),
        "all_to_all": (torch.empty_like,
                       lambda out, x: dist.all_to_all_single(out, x,
                                                             group=group)),
    }


def _expected(name: str, host: np.ndarray, rank: int, n: int):
    """What rank ``rank`` must hold after ``name`` on the ranks' slices
    of ``host`` (n rows)."""
    rows = host.reshape(n, -1)
    if name == "psum":
        return rows.sum(0)
    if name == "psum_scatter":
        return rows.sum(0).reshape(n, -1)[rank]
    if name == "all_gather":
        return host
    if name == "ppermute":
        return rows[(rank - 1) % n]
    return rows.reshape(n, n, -1)[:, rank].reshape(-1)   # all_to_all


def _payload(dtype: torch.dtype, n: int, n_elems: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    if dtype.is_floating_point:
        return rng.normal(size=(n * n_elems,)).astype(np.float32)
    info = torch.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, size=(n * n_elems,))


def bench_collectives(group=None, mb: float = 4.0, iters: int = 10,
                      dtype: str = "float32", device=None,
                      check: bool = False) -> dict:
    """Time each collective over ``group`` (default: the whole world);
    returns ``{op: {"ms": avg_ms, "gbps": payload_gb_per_s}}``.

    ``mb`` is the per-rank payload in MiB of ``dtype``: the element count
    scales with the item size, so ``dtype="int8"`` moves the same bytes
    as 4x the elements (the compressed wires' question). ``device``:
    where the payload lives (default: the card under NCCL, else the
    CPU). ``check=True`` also holds each op's first output against its
    value computed on the host (floats within 2 * world ulps of the
    dtype: the ranks' sum may round in another order; integers exactly,
    their sums unchecked, since they wrap) and raises ``AssertionError``
    on a miss.
    """
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    dt = getattr(torch, dtype)
    itemsize = torch.empty((), dtype=dt).element_size()
    n_elems = int(mb * (1 << 20) / itemsize)
    n_elems -= n_elems % n  # divisible for the reshaping ops
    if n_elems < 1:
        raise ValueError(f"mb={mb} is too small for {n} ranks")
    if device is None:
        device = ("cuda" if dist.get_backend(group) == "nccl" else "cpu")
    dev = torch.device(device)
    host = _payload(dt, n, n_elems)
    x = torch.from_numpy(host.reshape(n, -1)[rank].copy()).to(dt).to(dev)

    def wait():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    results = {}
    for name, (make, call) in _ops(n, rank, group).items():
        out = make(x)
        call(out, x)  # warm-up
        wait()
        if check:
            wide = torch.float64 if dt.is_floating_point else torch.int64
            got = out.cpu().to(wide).numpy()
            ref = _expected(name, torch.from_numpy(host).to(dt).to(
                wide).numpy(), rank, n)
            if dt.is_floating_point:
                # The exact value rounded to dtype; the ranks' sum may
                # round in another order, within an ulp per term.
                ref = torch.from_numpy(ref).to(dt).to(wide).numpy()
                tol = 2 * n * torch.finfo(dt).eps
                np.testing.assert_allclose(got, ref, rtol=tol, atol=tol,
                                           err_msg=name)
            elif name not in ("psum", "psum_scatter"):
                np.testing.assert_array_equal(got, ref, err_msg=name)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = make(x)
            call(out, x)
        wait()
        sec = (time.perf_counter() - t0) / iters
        results[name] = {"ms": round(sec * 1e3, 4),
                         "gbps": round(n_elems * itemsize / sec / 1e9, 3)}
    return results


def main(argv=None) -> int:
    import argparse
    import json

    from tpu_ddp_torch.launch import find_free_port
    from tpu_ddp_torch.parallel.bootstrap import (init_distributed_setup,
                                                  shutdown)

    ap = argparse.ArgumentParser(
        description="microbenchmark the process group's collectives")
    ap.add_argument("--mb", type=float, default=4.0,
                    help="per-rank payload in MiB")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--dtype", default="float32",
                    help="payload dtype (float32, bfloat16, int8, ...)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (gloo)")
    args = ap.parse_args(argv)
    ctx = init_distributed_setup("127.0.0.1", str(find_free_port()), 0, 1,
                                 device=args.device, ddp=True)
    try:
        out = {"world": dist.get_world_size(),
               "backend": dist.get_backend(),
               "payload_mib": args.mb, "dtype": args.dtype,
               "collectives": bench_collectives(
                   mb=args.mb, iters=args.iters, dtype=args.dtype,
                   device=ctx.device)}
    finally:
        shutdown(ctx)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
