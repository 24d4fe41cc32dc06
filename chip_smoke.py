#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (tpu_ddp_torch): the quickest
proof that the port builds, serves and trains on the card.

    python3 chip_smoke.py [--seed N] [--out results.json]

Phases, each fatal on failure (exit code 1, no result line):

1. refuse to run without CUDA;
2. build every kernel from ``tpu_ddp_torch/ops/csrc`` with nvcc (one
   process per source, all started together);
3. hold the int8 matmul kernel against its plain PyTorch version at the
   TransformerLM-large projection and head shapes, M in {8, 32}
   (max |kernel - plain| <= 1e-4 * max |plain|), and time the kernel,
   the plain version and the bf16 ``torch.matmul`` yardstick;
4. small parity: a TransformerLM-tiny engine on the card (f32 compute,
   int8 weights) against the same engine on the CPU, where the int8
   matmul is the plain version the CPU tests hold against the JAX
   package — identical greedy tokens, logprobs within 1e-4;
5. serve: TransformerLM-large at full width and depth, seeded random
   weights, ``decode_quant="int8"``, 8 requests of 64-512 prompt tokens
   and 32 new tokens (half greedy, half at temperature 0.8); every
   request must finish with finite logprobs, the pool must balance, and
   the int8 kernel's launch count must be 49 per engine pass (12 layers
   x 4 projections + the head), counted from 0 just before the run;
6. one decode step's logits through the kernel against the same step
   through the plain version (max |delta| <= 5e-2 * max |plain|: bf16
   activations re-round at every layer, so a last-bit difference in one
   f32 sum can move a bf16 activation by one unit, 2**-8 relative);
7. the BatchNorm+ReLU kernels (bn_stats, bn_norm_relu, bn_bwd_stats,
   bn_bwd_dx) against their plain versions at the eight VGG-11 conv
   outputs of a batch of 256, each kernel fed the same inputs as its
   plain version: y and dx within 1e-4 * max |plain|, mean within
   1e-4 * mean |x|, inv within 1e-4 * max inv, dbias and dscale within
   1e-4 * sum |terms| (the sums run in another order), the same at a
   few small shapes that take the kernels' scalar and ragged paths; then
   the whole autograd op against autograd through the plain forward.
   Each kernel is timed beside its bound, its plain version and one
   library call for the same pass: ``torch.var_mean`` (statistics),
   ``torch.batch_norm_elemt`` (normalise), ``batch_norm_backward_reduce``
   and ``batch_norm_backward_elemt`` (SyncBatchNorm's primitives, fed the
   ReLU-masked gradient, since they have no ReLU); the op beside the
   yardstick ``F.relu(F.batch_norm(..., training=True))`` forward and
   forward+backward;
8. the fused SGD kernel against its plain version on a few odd leaves
   and on VGG-11's 34 leaves over 3 steps: params and momentum bit for
   bit equal; timed beside its bound, the plain version and
   ``torch.optim.SGD(fused=True)``;
9. small parity: a narrow VGG trainer (f32, TF32 off, both kernel knobs)
   on the card against the same trainer on the CPU, where the kernels are
   their plain versions, 3 steps: losses within 1e-3 relative and params
   within rtol 1e-3 / atol 1e-4 (cuDNN's f32 convolutions sum in another
   order, about 1e-6 relative, and three steps of lr 0.1 through
   batch-statistics BN amplify that);
10. train: ``run_part("part1")``, the CLI's entry point, with
   ``TPU_DDP_PALLAS_SGD=1 TPU_DDP_PALLAS_BN=1``: VGG-11 (vgg11_cifar10,
   full width) at batch 256 for 40 iterations on the synthetic CIFAR-10
   stand-in, then the test-set pass. Every logged loss must be finite,
   the ``Test set:`` line printed, and the launch counts exact, from 0:
   SGD once per step, the backward BN kernels 8 per step, the forward
   ones 8 per step and per eval batch. Prints the reference's timer
   (iterations 1-39), images/s and peak memory, then a profiler window
   over 5 steps: the device's idle share and the top kernels, and a
   2-step window with shapes that names the ops behind the copy
   kernels;
11. one whole train step through the kernels against the same step
   through the plain versions (same params, same batch): loss within
   1e-2 relative and every param within 5e-2 * the step's largest
   update (bf16 activations re-round at every layer, so a last-bit
   difference in a statistic can move a bf16 activation by 2**-8);
12. part 3 (``DistributedDataParallel``, 25 MB buckets) at world 1 over
   NCCL: 20 iterations on the card with finite losses.

Prints the card's name and power limit, the serving and training
metrics, one ``{"kernels": [...]}`` line (six kernels), and last the
contract line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import socket
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

# H100 SXM published peaks (dense): HBM3 bytes/s, bf16 tensor-core FLOP/s
# and f32 FLOP/s outside the tensor cores. The int8 weights are exact in
# bf16, so bf16 is the fastest type the same products could run in; the
# BN and SGD kernels do f32 elementwise arithmetic.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

# VGG-11's conv outputs at batch 256 as (R = N*H*W, C) rows, with the
# number of conv units of each shape: 8 BN+ReLU calls per pass.
BN_SHAPES = [((262144, 64), 1), ((65536, 128), 1), ((16384, 256), 2),
             ((4096, 512), 2), ((1024, 512), 2)]
# Small (R, C) rows that take the BN kernels' other paths: scalar loads
# (C % 4 != 0), ragged row blocks, one channel.
BN_EDGE_SHAPES = [(300, 3), (999, 96), (1000, 30), (33, 4), (517, 1)]
# Odd SGD leaves beside VGG-11's: one element, ragged chunks, odd sizes.
SGD_EDGE_SHAPES = [(1,), (7, 13), (4099,), (100001,)]
# Bytes each BN kernel moves per element (f32 rows in and out) and its
# flops per element: stats reads x; norm reads x, writes y; bwd_stats
# reads x, g; bwd_dx reads x, g, writes dx.
BN_BYTES_PER_ELEM = {"bn_stats": 4, "bn_norm_relu": 8, "bn_bwd_stats": 8,
                     "bn_bwd_dx": 12}
BN_FLOPS_PER_ELEM = {"bn_stats": 3, "bn_norm_relu": 4, "bn_bwd_stats": 8,
                     "bn_bwd_dx": 10}
# Per-channel vectors each BN kernel reads and writes (f32).
BN_CHAN_VECTORS = {"bn_stats": 2, "bn_norm_relu": 4, "bn_bwd_stats": 6,
                   "bn_bwd_dx": 6}

# TransformerLM-large's int8 matmuls: (K, N) and launches per pass.
LARGE_SHAPES = {"wqkv": ((2048, 6144), 12), "wo": ((2048, 2048), 12),
                "w1": ((2048, 8192), 12), "w2": ((8192, 2048), 12),
                "head": ((2048, 32000), 1)}
L2_BYTES = 50 * 2 ** 20


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False)
    if proc.returncode != 0 or not proc.stdout.strip():
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def build_all() -> dict:
    """Compile every csrc source in parallel, one nvcc each."""
    from tpu_ddp_torch.ops import cuda_build
    sources = sorted(p.name for p in cuda_build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    nvcc = cuda_build.find_nvcc()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        out = cuda_build.library_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(".tmp.so")
        procs[src] = (subprocess.Popen(
            [nvcc, *cuda_build.NVCC_FLAGS, "-o", str(tmp),
             str(cuda_build.CSRC / src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            fail(f"nvcc failed on {src}:\n{log}")
        tmp.replace(out)
    for src in sources:
        cuda_build.load(src)
    regs = {}
    for src in sources:
        log = cuda_build.library_path(src).with_suffix(".log")
        if log.exists():
            regs[src] = [ln.split("info    : ")[-1] for ln in
                         log.read_text().splitlines() if "registers" in ln]
    return {"sources": sources, "build_s": time.perf_counter() - t0,
            "ptxas": regs}


def cuda_ms(fn, args_list, reps: int) -> float:
    """Mean ms per call over ``reps`` calls cycling through
    ``args_list`` (distinct buffers so the weights come from HBM, as
    they do in a decode step), after a warm-up pass."""
    for a in args_list:
        fn(*a)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(reps):
        fn(*args_list[i % len(args_list)])
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _device_us(prof) -> dict:
    """Self device time (us) by kernel name from a profiler trace."""
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            out[e.key] = out.get(e.key, 0.0) + us
    return out


def device_ms(fn, args_list, reps: int) -> float | None:
    """Mean device time per call (ms) of every kernel ``fn`` runs, from
    a torch.profiler trace; None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    for a in args_list:
        fn(*a)
    torch.cuda.synchronize()
    for _ in range(2):  # a trace occasionally comes back without kernels
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                fn(*args_list[i % len(args_list)])
            torch.cuda.synchronize()
        total = sum(_device_us(prof).values())
        if total > 0:
            return total / 1e3 / reps
    return None


def timed(fn, args_list, reps: int) -> dict:
    """Device time per call (profiler) and the CUDA-event time per call
    of back-to-back calls, which includes the host's dispatch when the
    host, not the card, is the slower side."""
    ev = cuda_ms(fn, args_list, reps)
    dv = device_ms(fn, args_list, reps)
    return {"device_ms": dv, "event_ms": ev,
            "ms": dv if dv is not None else ev}


def check_kernel(dev, gen) -> list[dict]:
    from tpu_ddp_torch.ops.quant import dequantize, quantize_weight
    from tpu_ddp_torch.ops.quant_matmul import int8_matmul, int8_matmul_ref
    rows = []
    for m in (8, 32):
        for name, ((k, n), per_pass) in LARGE_SHAPES.items():
            copies = max(2, math.ceil(2 * L2_BYTES / (k * n)))
            x = torch.randn(m, k, generator=gen, device=dev).to(
                torch.bfloat16)
            qws = [quantize_weight(0.02 * torch.randn(
                k, n, generator=gen, device=dev)) for _ in range(copies)]
            out = int8_matmul(x, qws[0].q, qws[0].s)
            ref = int8_matmul_ref(x, qws[0].q, qws[0].s)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            if not (out.shape == ref.shape and math.isfinite(err)
                    and err <= 1e-4 * scale):
                fail(f"int8_matmul disagrees with its plain version at "
                     f"M={m} K={k} N={n}: max|d|={err} vs tol "
                     f"{1e-4 * scale}")
            args = [(x, qw.q, qw.s) for qw in qws]
            kern = timed(int8_matmul, args, 20 * copies)
            plain = timed(int8_matmul_ref, args, 4 * copies)
            wbf = [(x, dequantize(qw).to(torch.bfloat16)) for qw in qws]
            lib = timed(torch.matmul, wbf, 20 * copies)
            del wbf, qws
            nbytes = m * k * 2 + k * n + n * 4 + m * n * 4
            ops = 2 * m * k * n
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / BF16_FLOP_PER_S * 1e3
            rows.append({"m": m, "k": k, "n": n, "proj": name,
                         "per_pass": per_pass, "max_abs_err": err,
                         "tol": 1e-4 * scale, "ms": kern["ms"],
                         "plain_ms": plain["ms"], "library_ms": lib["ms"],
                         "event_ms": kern["event_ms"],
                         "plain_event_ms": plain["event_ms"],
                         "library_event_ms": lib["event_ms"],
                         "timing": "profiler" if None not in (
                             kern["device_ms"], plain["device_ms"],
                             lib["device_ms"]) else "cuda-events",
                         "bound_ms": max(t_bytes, t_ops),
                         "bound_by": "bytes" if t_bytes >= t_ops
                         else "operations", "bytes": nbytes})
            print(json.dumps({"int8_matmul_shape": rows[-1]}), flush=True)
    return rows


def small_parity(dev) -> dict:
    """TransformerLM-tiny int8 engine on the card vs on the CPU."""
    from tpu_ddp_torch.models.transformer import make_transformer
    from tpu_ddp_torch.serve.engine import ServeEngine
    model = make_transformer("TransformerLM-tiny", max_seq_len=64,
                             compute_dtype=torch.float32)
    params = model.init(torch.Generator().manual_seed(0))
    cases = [(3, 6), (8, 6), (11, 6), (20, 4), (9, 12)]
    streams = {}
    for where in ("cpu", dev):
        eng = ServeEngine(model, params, num_slots=4, block_size=8,
                          prefill_chunk=8, decode_quant="int8",
                          device=where)
        reqs = [eng.submit(np.random.default_rng(i).integers(
            0, model.vocab_size, size=L), n)
            for i, (L, n) in enumerate(cases)]
        eng.run()
        if not eng.accounting_ok():
            fail(f"small parity: pool accounting broken on {where}")
        streams[str(where)] = reqs
    worst = 0.0
    for a, b in zip(streams["cpu"], streams[str(dev)]):
        if a.tokens != b.tokens:
            fail(f"small parity: greedy tokens differ, cpu {a.tokens} "
                 f"vs cuda {b.tokens}")
        worst = max(worst, float(np.abs(np.subtract(a.logprobs,
                                                    b.logprobs)).max()))
    if worst > 1e-4:
        fail(f"small parity: logprobs differ by {worst} > 1e-4")
    return {"requests": len(cases), "max_logprob_diff": worst}


def serve_large(dev, seed: int) -> dict:
    from tpu_ddp_torch.models.transformer import make_transformer
    from tpu_ddp_torch.ops import quant
    from tpu_ddp_torch.ops.quant_matmul import int8_matmul, int8_matmul_ref
    from tpu_ddp_torch.serve.engine import ServeEngine, decode_logits

    model = make_transformer("TransformerLM-large")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    eng = ServeEngine(model, params, decode_quant="int8", device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    # Warm-up request: first-call library and allocator set-up.
    eng.submit(rng.integers(0, model.vocab_size, size=40), 2)
    eng.run()
    torch.cuda.synchronize()

    c0 = dict(eng.metrics.counters)
    int8_matmul.launches = 0
    lens = rng.integers(64, 513, size=8)
    t0 = time.perf_counter()
    reqs = [eng.submit(rng.integers(0, model.vocab_size, size=int(L)), 32,
                       temperature=0.0 if i % 2 == 0 else 0.8, seed=i)
            for i, L in enumerate(lens)]
    steps = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = int8_matmul.launches

    chunks = eng.metrics.counters["serve_prefill_chunks"] \
        - c0.get("serve_prefill_chunks", 0)
    dsteps = eng.metrics.counters["serve_decode_steps"] \
        - c0.get("serve_decode_steps", 0)
    per_pass = 4 * model.num_layers + 1
    if launches != per_pass * (chunks + dsteps) or launches == 0:
        fail(f"int8_matmul launched {launches} times; the run made "
             f"{chunks} prefill chunks + {dsteps} decode steps x "
             f"{per_pass}")
    for r in reqs:
        if not r.done or r.cancelled or r.quarantined \
                or len(r.tokens) != 32:
            fail(f"request {r.rid} did not finish cleanly: done={r.done}"
                 f" quarantined={r.quarantined} tokens={len(r.tokens)}")
        if not all(math.isfinite(lp) for lp in r.logprobs):
            fail(f"request {r.rid} has non-finite logprobs")
    if not eng.accounting_ok() \
            or eng.pool.free_count != eng.pool.total_usable:
        fail("KV pool accounting broken after the run")
    ttft = sorted(r.ttft_s * 1e3 for r in reqs)
    tokens = sum(len(r.tokens) for r in reqs)

    # One decode step through the kernel and through the plain version.
    probe = [eng.submit(rng.integers(0, model.vocab_size, size=64), 32)
             for _ in range(eng.num_slots)]
    while eng.sched.queue or eng.sched.prefill_slot() is not None:
        eng.step()
    dslots = eng.sched.decode_slots()
    inputs = eng.bank_inputs(dslots)
    args = (model, eng.block_size, eng._decode_params, eng.pool.k,
            eng.pool.v, *inputs[:3])
    lk = decode_logits(*args)
    with mock.patch.object(quant, "int8_matmul", int8_matmul_ref):
        lp = decode_logits(*args)
    torch.cuda.synchronize()
    rows = torch.as_tensor(dslots, device=dev)
    lk, lp = lk[rows], lp[rows]
    step_err = float((lk - lp).abs().max())
    step_tol = 5e-2 * float(lp.abs().max())
    if not (torch.isfinite(lk).all() and step_err <= step_tol):
        fail(f"decode-step logits: kernel vs plain max|d|={step_err} > "
             f"{step_tol}")
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    trace = traced_run(eng)
    for r in probe:
        if not r.done:
            fail("probe request did not finish")
    return {"model": model.name, "params": sum(
        p.numel() for p in _leaves(params)), "setup_s": setup_s,
        "requests": len(reqs), "prompt_lens": [int(v) for v in lens],
        "new_tokens": tokens, "engine_steps": steps,
        "prefill_chunks": chunks, "decode_steps": dsteps,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "ttft_ms_median": ttft[len(ttft) // 2], "ttft_ms_max": ttft[-1],
        "launches": launches, "decode_step_logit_err": step_err,
        "decode_step_logit_tol": step_tol,
        "decode_step_argmax_agreement": agree, "traced_window": trace,
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}


def traced_run(eng) -> dict:
    """Run the engine to idle under torch.profiler: the device's busy
    share of the window and the kernels that take the time. The trace
    slows the host, so the window's wall time is not a serving metric."""
    from torch.profiler import ProfilerActivity, profile
    c0 = dict(eng.metrics.counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us = _device_us(prof)
    busy_ms = sum(dev_us.values()) / 1e3
    kern_ms = sum(v for k, v in dev_us.items()
                  if "int8_matmul_kernel" in k or "splitk_reduce" in k) / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    return {"decode_steps": eng.metrics.counters["serve_decode_steps"]
            - c0.get("serve_decode_steps", 0),
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
            "int8_matmul_device_ms": kern_ms,
            "top_kernels_ms": [[k[:90], v / 1e3] for k, v in top]}


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least ms, what bounds it) for f32 elementwise work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _timing_label(*results) -> str:
    return ("profiler" if all(r["device_ms"] is not None for r in results)
            else "cuda-events")


def _bn_kernel_errors(tb, x, g, s, b):
    """Each BN+ReLU kernel against its plain version on the same inputs:
    ``({what: (max |kernel - plain|, tolerance)}, plain results)``."""
    mean, inv = tb.bn_stats_ref(x)
    y = tb.bn_norm_relu_ref(x, mean, inv, s, b)
    db, ds = tb.bn_bwd_stats_ref(x, g, mean, inv, s, b)
    dx = tb.bn_bwd_dx_ref(x, g, mean, inv, s, b, db, ds)
    km, ki = tb.bn_stats(x)
    ky = tb.bn_norm_relu(x, mean, inv, s, b)
    kdb, kds = tb.bn_bwd_stats(x, g, mean, inv, s, b)
    kdx = tb.bn_bwd_dx(x, g, mean, inv, s, b, db, ds)
    torch.cuda.synchronize()
    x_hat = (x - mean) * inv
    errs = {
        "bn_stats": (float((km - mean).abs().max()),
                     1e-4 * float(x.abs().mean(0).max())),
        "bn_stats_inv": (float((ki - inv).abs().max()),
                         1e-4 * float(inv.abs().max())),
        "bn_norm_relu": (float((ky - y).abs().max()),
                         1e-4 * float(y.abs().max())),
        "bn_bwd_stats": (float((kdb - db).abs().max()),
                         1e-4 * float(g.abs().sum(0).max())),
        "bn_bwd_stats_dscale": (float((kds - ds).abs().max()),
                                1e-4 * float((g * x_hat).abs().sum(0)
                                             .max())),
        "bn_bwd_dx": (float((kdx - dx).abs().max()),
                      1e-4 * float(dx.abs().max())),
    }
    return errs, (mean, inv, y, db, ds, dx)


def _fail_on(errs, where):
    for what, (err, tol) in errs.items():
        if not (math.isfinite(err) and err <= tol):
            fail(f"{what} disagrees with its plain version at {where}: "
                 f"max|d|={err} vs tol {tol}")


def check_bn(dev, gen) -> dict:
    """Phase 7: the four BN+ReLU kernels at VGG-11's eight conv outputs,
    and at a few small shapes that take the kernels' other paths (C not a
    multiple of 4, rows not a multiple of a block)."""
    import torch.nn.functional as F

    from tpu_ddp_torch.ops import bn_relu as tb
    edge = {}
    for r, c in BN_EDGE_SHAPES:
        x = torch.randn(r, c, generator=gen, device=dev) * 2 + 0.3
        g = torch.randn(r, c, generator=gen, device=dev)
        s = 0.5 + torch.rand(c, generator=gen, device=dev)
        b = 0.1 * torch.randn(c, generator=gen, device=dev)
        errs, _ = _bn_kernel_errors(tb, x, g, s, b)
        _fail_on(errs, f"R={r} C={c}")
        edge[f"{r}x{c}"] = {k: v[0] for k, v in errs.items()}
    kernels = {"bn_stats": (tb.bn_stats, tb.bn_stats_ref),
               "bn_norm_relu": (tb.bn_norm_relu, tb.bn_norm_relu_ref),
               "bn_bwd_stats": (tb.bn_bwd_stats, tb.bn_bwd_stats_ref),
               "bn_bwd_dx": (tb.bn_bwd_dx, tb.bn_bwd_dx_ref)}
    shapes = []
    for (r, c), units in BN_SHAPES:
        n_el = r * c
        side = int(math.isqrt(r // 256))
        copies = max(2, math.ceil(2 * L2_BYTES / (8 * n_el)))
        xs = [torch.randn(r, c, generator=gen, device=dev) * 2 + 0.3
              for _ in range(copies)]
        gs = [torch.randn(r, c, generator=gen, device=dev)
              for _ in range(copies)]
        s = 0.5 + torch.rand(c, generator=gen, device=dev)
        b = 0.1 * torch.randn(c, generator=gen, device=dev)
        x, g = xs[0], gs[0]
        errs, (mean, inv, y, db, ds, dx) = _bn_kernel_errors(tb, x, g, s, b)
        # The whole autograd op against autograd through the plain
        # forward, at the model's initial scale 1 and bias 0.
        grads = []
        for fn in (tb.batch_norm_relu, tb.batch_norm_relu_ref):
            leaves = [x.clone().requires_grad_(),
                      torch.ones(c, device=dev, requires_grad=True),
                      torch.zeros(c, device=dev, requires_grad=True)]
            out = fn(*leaves)
            grads.append([out.detach(), *torch.autograd.grad(
                out, leaves, g)])
        (oy, odx, ods, odb), (py, pdx, pds, pdb) = grads
        x_hat0 = (x - x.mean(0)) * torch.rsqrt(x.var(0, correction=0)
                                               + tb.BN_EPS)
        # The op computes its own statistics, which differ from the plain
        # ones in their last bits (another summation order). An element
        # whose pre-ReLU value lies within a hair of 0 can then fall on
        # the other side of the ReLU, and its dx jumps by inv * |g|. dx
        # is held everywhere else; those elements are counted, and must
        # stay a tiny share.
        near_zero = ((x - mean) * inv).abs() <= 1e-5
        n_near = int(near_zero.sum())
        if n_near > 1e-4 * x.numel():
            fail(f"op_dx: {n_near} of {x.numel()} elements within 1e-5 of "
                 f"the ReLU's edge at R={r} C={c}")
        errs.update({
            "op_y": (float((oy - py).abs().max()),
                     1e-4 * float(py.abs().max())),
            "op_dx": (float(torch.where(near_zero, 0.0,
                                        (odx - pdx).abs()).max()),
                      1e-4 * float(pdx.abs().max())),
            "op_dscale": (float((ods - pds).abs().max()),
                          1e-4 * float((g * x_hat0).abs().sum(0).max())),
            "op_dbias": (float((odb - pdb).abs().max()),
                         1e-4 * float(g.abs().sum(0).max())),
        })
        _fail_on(errs, f"R={r} C={c}")

        row = {"r": r, "c": c, "units": units, "copies": copies,
               "op_dx_near_relu_edge": n_near,
               "errors": {k: v[0] for k, v in errs.items()},
               "tols": {k: v[1] for k, v in errs.items()}}
        reps = 10 * copies
        args = {"bn_stats": [(xi,) for xi in xs],
                "bn_norm_relu": [(xi, mean, inv, s, b) for xi in xs],
                "bn_bwd_stats": [(xi, gi, mean, inv, s, b)
                                 for xi, gi in zip(xs, gs)],
                "bn_bwd_dx": [(xi, gi, mean, inv, s, b, db, ds)
                              for xi, gi in zip(xs, gs)]}
        for name, (kern, plain) in kernels.items():
            k_t = timed(kern, args[name], reps)
            p_t = timed(plain, args[name], max(4, reps // 4))
            bound, by = _bound(
                BN_BYTES_PER_ELEM[name] * n_el
                + 4 * BN_CHAN_VECTORS[name] * c,
                BN_FLOPS_PER_ELEM[name] * n_el)
            row[name] = {"ms": k_t["ms"], "event_ms": k_t["event_ms"],
                         "plain_ms": p_t["ms"], "bound_ms": bound,
                         "bound_by": by,
                         "timing": _timing_label(k_t, p_t)}
        # Library calls for the same passes: var_mean for the statistics
        # and SyncBatchNorm's CUDA primitives for the rest. These have no
        # ReLU, so the backward ones take the ReLU-masked gradient, made
        # outside the timing; their outputs are held to the plain
        # versions below (recorded, not gated: they are yardsticks).
        gms = [torch.where(tb.bn_norm_relu_ref(xi, mean, inv, s, b) > 0,
                           gi, 0.0) for xi, gi in zip(xs, gs)]
        count = torch.tensor([r], dtype=torch.int32, device=dev)
        sum_dy_xmu = ds / inv
        libs = {
            "bn_stats": (lambda t: torch.var_mean(t, dim=0, correction=0),
                         args["bn_stats"]),
            "bn_norm_relu": (lambda t: torch.batch_norm_elemt(
                t, s, b, mean, inv, tb.BN_EPS), args["bn_stats"]),
            "bn_bwd_stats": (lambda t, gm: torch.batch_norm_backward_reduce(
                gm, t, mean, inv, s, False, True, True), list(zip(xs, gms))),
            "bn_bwd_dx": (lambda t, gm: torch.batch_norm_backward_elemt(
                gm, t, mean, inv, s, db, sum_dy_xmu, count),
                list(zip(xs, gms))),
        }
        for name, (fn, largs) in libs.items():
            row[name]["library_ms"] = timed(fn, largs, reps)["ms"]
        red = libs["bn_bwd_stats"][0](x, gms[0])
        row["library_errors"] = {
            "bn_stats": float((libs["bn_stats"][0](x)[1] - mean).abs().max()),
            "bn_norm_relu": float((libs["bn_norm_relu"][0](x).clamp_min(0)
                                   - y).abs().max()),
            "bn_bwd_stats": max(float((red[3] - db).abs().max()),
                                float((red[2] - ds).abs().max())),
            "bn_bwd_dx": float((libs["bn_bwd_dx"][0](x, gms[0]) - dx)
                               .abs().max())}

        # The op against the PyTorch yardstick, forward and
        # forward+backward (grads of x, scale and bias), the yardstick on
        # the NCHW channels_last view of the same rows.
        sg = s.detach().requires_grad_()
        bg = b.detach().requires_grad_()

        def nhwc(t):
            return t.view(256, side, side, c)

        def op_fwd(t):
            return tb.batch_norm_relu(nhwc(t), sg, bg)

        def lib_fwd(t):
            return F.relu(F.batch_norm(nhwc(t).permute(0, 3, 1, 2), None,
                                       None, sg, bg, training=True,
                                       eps=tb.BN_EPS))

        def op_fwd_bwd(t, gt):
            t = t.detach().requires_grad_()
            return torch.autograd.grad(op_fwd(t), (t, sg, bg), nhwc(gt))

        def lib_fwd_bwd(t, gt):
            t = t.detach().requires_grad_()
            return torch.autograd.grad(lib_fwd(t), (t, sg, bg),
                                       nhwc(gt).permute(0, 3, 1, 2))

        pairs = list(zip(xs, gs))
        with torch.no_grad():
            fwd_ms = timed(op_fwd, args["bn_stats"], reps)["ms"]
            lib_fwd_ms = timed(lib_fwd, args["bn_stats"], reps)["ms"]
        row["op"] = {
            "fwd_ms": fwd_ms,
            "fwd_bwd_ms": timed(op_fwd_bwd, pairs, reps)["ms"],
            "library_fwd_ms": lib_fwd_ms,
            "library_fwd_bwd_ms": timed(lib_fwd_bwd, pairs, reps)["ms"]}
        del xs, gs, gms, args, pairs, libs
        shapes.append(row)
        print(json.dumps({"bn_relu_shape": row}), flush=True)

    def per_step(key, sub=None):
        total = 0.0
        for row in shapes:
            v = row[key] if sub is None else row[key][sub]
            if v is None:
                return None
            total += v * row["units"]
        return total

    out = {"shapes": shapes, "edge_shapes": edge, "kernels": {}}
    for name in kernels:
        bound_bytes = sum(row["units"] * (BN_BYTES_PER_ELEM[name] * row["r"]
                                          * row["c"] + 4 * row["c"]
                                          * BN_CHAN_VECTORS[name])
                          for row in shapes)
        bound_flops = sum(row["units"] * BN_FLOPS_PER_ELEM[name] * row["r"]
                          * row["c"] for row in shapes)
        bound, by = _bound(bound_bytes, bound_flops)
        err_keys = [k for k in shapes[0]["errors"] if k.startswith(name)]
        out["kernels"][name] = {
            "ms": per_step(name, "ms"), "plain_ms": per_step(name,
                                                             "plain_ms"),
            "event_ms": per_step(name, "event_ms"),
            "bound_ms": bound, "bound_by": by,
            "library_ms": per_step(name, "library_ms"),
            "library_max_abs_err": max(row["library_errors"][name]
                                       for row in shapes),
            "max_abs_err": max(row["errors"][k] for row in shapes
                               for k in err_keys),
            "timing": ",".join(sorted({row[name]["timing"]
                                       for row in shapes}))}
    out["op_per_step"] = {k: per_step("op", k) for k in
                          ("fwd_ms", "fwd_bwd_ms", "library_fwd_ms",
                           "library_fwd_bwd_ms")}
    return out


def _sgd_bitwise(tsgd, shapes, gen, dev, hp):
    """Three steps of the kernel and of its plain version from the same
    leaves; fails unless params and momentum end bit for bit equal.
    Returns (p0, grads, kernel's (p, buf), plain's (p, buf))."""
    p0 = [torch.randn(s, generator=gen, device=dev) * 0.05 for s in shapes]
    grads = [torch.randn(s, generator=gen, device=dev) * 1e-2
             for s in shapes]
    kp, rp = [p.clone() for p in p0], [p.clone() for p in p0]
    kb, rb = ([torch.zeros_like(p) for p in p0] for _ in range(2))
    for _ in range(3):
        tsgd.fused_sgd_step(kp, grads, kb, **hp)
        tsgd.fused_sgd_step_ref(rp, grads, rb, **hp)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(kp + kb, rp + rb))
    if err != 0.0:
        fail(f"fused_sgd_step differs from its plain version on leaves "
             f"{shapes[:4]}...: max|d|={err} (must be bit for bit equal)")
    return p0, grads, (kp, kb), (rp, rb)


def check_sgd(dev, gen) -> dict:
    """Phase 8: the fused SGD kernel on VGG-11's 34 leaves (and on a few
    odd leaves)."""
    from tpu_ddp_torch.models.vgg import get_model
    from tpu_ddp_torch.ops import sgd as tsgd
    hp = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)
    _sgd_bitwise(tsgd, SGD_EDGE_SHAPES, gen, dev, hp)
    shapes = [p.shape for p in get_model("VGG11").parameters()]
    n = sum(math.prod(s) for s in shapes)
    p0, grads, (kp, kb), (rp, rb) = _sgd_bitwise(tsgd, shapes, gen, dev, hp)
    err = 0.0
    kern = timed(lambda: tsgd.fused_sgd_step(kp, grads, kb, **hp), [()], 50)
    plain = timed(lambda: tsgd.fused_sgd_step_ref(rp, grads, rb, **hp),
                  [()], 20)
    lib_params = [torch.nn.Parameter(p.clone()) for p in p0]
    for p, g in zip(lib_params, grads):
        p.grad = g
    opt = torch.optim.SGD(lib_params, fused=True, **hp)
    lib = timed(opt.step, [()], 50)
    bound, by = _bound(20 * n, 5 * n)
    return {"leaves": len(shapes), "elements": n, "max_abs_err": err,
            "ms": kern["ms"], "event_ms": kern["event_ms"],
            "plain_ms": plain["ms"], "library_ms": lib["ms"],
            "bound_ms": bound, "bound_by": by,
            "timing": _timing_label(kern, plain, lib)}


NARROW_VGG = (16, "M", 32, "M", 32, 32, "M", 64, 64, "M", 64, 64, "M")


def train_parity(dev) -> dict:
    """Phase 9: a narrow VGG trainer on the card vs on the CPU."""
    import itertools

    from tpu_ddp_torch.data.loader import create_data_loaders
    from tpu_ddp_torch.models.vgg import VGGModel
    from tpu_ddp_torch.train.engine import Trainer
    from tpu_ddp_torch.utils.config import TrainConfig
    train, _ = create_data_loaders(batch_size=16, synthetic_size=64)
    batches = list(itertools.islice(iter(train), 3))
    runs = {}
    for where in ("cpu", dev):
        cfg = TrainConfig(pallas_sgd=True, pallas_bn=True,
                          compute_dtype="float32")
        model = VGGModel("narrow", NARROW_VGG, compute_dtype=torch.float32,
                         use_pallas_bn=True)
        tr = Trainer(model, cfg, device=where)
        state = tr.init_state()
        losses = []
        for x, y in batches:
            state, loss = tr.train_step(state, x, y)
            losses.append(float(loss))
        runs[str(where)] = (losses, [p.detach().cpu() for p in state.params])
    (lc, pc), (lg, pg) = runs["cpu"], runs[str(dev)]
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
    worst = 0.0
    for a, b in zip(pc, pg):
        excess = ((a - b).abs() - (1e-4 + 1e-3 * a.abs())).max()
        worst = max(worst, float((a - b).abs().max()))
        if float(excess) > 0 or not torch.isfinite(b).all():
            fail(f"small parity: params differ beyond rtol 1e-3 / atol "
                 f"1e-4 (max|d|={float((a - b).abs().max())})")
    if not loss_rel <= 1e-3:
        fail(f"small parity: losses differ by {loss_rel} relative > 1e-3 "
             f"(cpu {lc}, cuda {lg})")
    return {"steps": len(batches), "losses_cpu": lc, "losses_cuda": lg,
            "max_loss_rel_diff": loss_rel, "max_param_diff": worst}


class _Tee(io.TextIOBase):
    """Write to the real stdout and keep a copy."""

    def __init__(self, out):
        self.out = out
        self.buf = io.StringIO()

    def write(self, s):
        self.out.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.out.flush()


def _run_part_captured(part: str, argv) -> tuple[int, str, float]:
    from tpu_ddp_torch.parts import run_part
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        rc = run_part(part, argv)
    torch.cuda.synchronize()
    return rc, tee.buf.getvalue(), time.perf_counter() - t0


def _bn_wrappers():
    from tpu_ddp_torch.ops import bn_relu as tb
    return {"bn_stats": tb.bn_stats, "bn_norm_relu": tb.bn_norm_relu,
            "bn_bwd_stats": tb.bn_bwd_stats, "bn_bwd_dx": tb.bn_bwd_dx}


TRAIN_ITERS = 40
SYNTH_SIZE = 10240


def train_part1(dev) -> dict:
    """Phase 10: part 1 through the CLI's entry point, both knobs on."""
    from tpu_ddp_torch.ops import sgd as tsgd
    for name in ("TPU_DDP_GLOBAL_BATCH", "TPU_DDP_COMPUTE_DTYPE",
                 "TPU_DDP_LR"):
        os.environ.pop(name, None)  # vgg11_cifar10 as published
    os.environ.update(TPU_DDP_PALLAS_SGD="1", TPU_DDP_PALLAS_BN="1",
                      TPU_DDP_MAX_ITERS=str(TRAIN_ITERS),
                      TPU_DDP_SYNTH_SIZE=str(SYNTH_SIZE))
    wrappers = {**_bn_wrappers(), "sgd": tsgd.fused_sgd_step}
    torch.cuda.reset_peak_memory_stats(dev)
    for w in wrappers.values():
        w.launches = 0
    rc, out, wall = _run_part_captured("part1", ["--device", str(dev)])
    counts = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if rc != 0:
        fail(f"run_part('part1') returned {rc}")
    losses = [(int(i), float(v)) for i, v in
              re.findall(r"\[epoch 0, iter (\d+)\] loss: (\S+)", out)]
    if [i for i, _ in losses] != [20, 40] or not all(
            math.isfinite(v) for _, v in losses):
        fail(f"part1 loss lines wrong or not finite: {losses}")
    test = re.search(r"Test set: average loss (\S+), accuracy (\d+)/(\d+)",
                     out)
    if test is None or not math.isfinite(float(test.group(1))):
        fail("part1 printed no finite 'Test set:' line")
    timer = re.search(r"timing over iterations 1-39: total (\d+) ns, "
                      r"average (\d+) ns", out)
    if timer is None:
        fail("part1 printed no timer line")
    steps = TRAIN_ITERS
    eval_batches = math.ceil(int(test.group(3)) / 256)
    want = {"sgd": steps, "bn_bwd_stats": 8 * steps, "bn_bwd_dx": 8 * steps,
            "bn_stats": 8 * (steps + eval_batches),
            "bn_norm_relu": 8 * (steps + eval_batches)}
    if counts != want:
        fail(f"part1 launch counts {counts}, expected {want} ({steps} "
             f"steps, {eval_batches} eval batches)")
    avg_ms = int(timer.group(2)) / 1e6
    return {"steps": steps, "eval_batches": eval_batches,
            "losses": losses, "test_loss": float(test.group(1)),
            "test_correct": int(test.group(2)),
            "test_seen": int(test.group(3)), "launches": counts,
            "avg_iter_ms": avg_ms, "images_per_s": 256 / (avg_ms / 1e3),
            "wall_s": wall, "peak_mem_gib": peak}


def _copy_sources(prof, steps: int, top: int = 10) -> dict:
    """Device ms per step of the copy kernels (dtype casts and layout
    copies alike), in all, by kernel, and by the chain of ops that
    launched them with their input shapes."""
    total, by_kernel, agg = 0.0, {}, {}
    for e in prof.events():
        for k in getattr(e, "kernels", ()):
            if "copy" not in k.name:
                continue
            ms = k.duration / 1e3 / steps
            kname = re.sub(r"^void at::native::", "", k.name)[:60]
            chain, p = [], e
            while p is not None and len(chain) < 5:
                chain.append(p.name)
                p = p.cpu_parent
            key = (kname, " < ".join(chain), str(e.input_shapes))
            total += ms
            by_kernel[kname] = by_kernel.get(kname, 0.0) + ms
            agg[key] = agg.get(key, 0.0) + ms
    rows = sorted(agg.items(), key=lambda kv: -kv[1])[:top]
    return {"total_ms_per_step": total, "by_kernel_ms_per_step": by_kernel,
            "top": [{"kernel": k[0], "ops": k[1], "shapes": k[2],
                     "ms_per_step": v} for k, v in rows]}


def train_step_checks(dev) -> dict:
    """Phase 10's profiler window and phase 11: VGG-11 at batch 256 with
    both knobs (still on from phase 10), one step through the kernels vs
    the same step through the plain versions."""
    import itertools

    from tpu_ddp_torch.data.loader import create_data_loaders
    from tpu_ddp_torch.models.vgg import get_model
    from tpu_ddp_torch.ops import bn_relu as tb
    from tpu_ddp_torch.ops import sgd as tsgd
    from tpu_ddp_torch.train.engine import Trainer
    from tpu_ddp_torch.utils.config import TrainConfig
    from torch.profiler import ProfilerActivity, profile
    cfg = TrainConfig.preset("vgg11_cifar10")
    model = get_model(cfg.model, use_pallas_bn=cfg.pallas_bn,
                      compute_dtype=getattr(torch, cfg.compute_dtype))
    tr = Trainer(model, cfg, device=dev)
    state = tr.init_state()
    train, _ = create_data_loaders(batch_size=256, synthetic_size=2560)
    batches = list(itertools.islice(iter(train), 8))
    for x, y in batches[:3]:
        state, loss = tr.train_step(state, x, y)
        float(loss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for x, y in batches[3:]:
            state, loss = tr.train_step(state, x, y)
            float(loss)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us = _device_us(prof)
    busy_ms = sum(dev_us.values()) / 1e3
    names = {"bn_stats": ("bn_stats_kernel", "bn_stats_finish"),
             "bn_norm_relu": ("bn_norm_relu_kernel",),
             "bn_bwd_stats": ("bn_bwd_stats_kernel", "bn_bwd_finish"),
             "bn_bwd_dx": ("bn_bwd_dx_kernel",), "sgd": ("sgd_kernel",)}
    ours = {k: sum(v for n, v in dev_us.items()
                   if any(p in n for p in pats)) / 1e3 / 5
            for k, pats in names.items()}
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:10]
    window = {"steps": 5, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
              "device_idle_share": 1 - busy_ms / wall_ms,
              "ported_kernels_ms_per_step": ours,
              "top_kernels_ms": [[k[:90], v / 1e3] for k, v in top]}
    # A second, short window with shapes (slower on the host, so it
    # times nothing): which ops launch the copy kernels.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for x, y in batches[3:5]:
            state, loss = tr.train_step(state, x, y)
            float(loss)
        torch.cuda.synchronize()
    window["copy_sources"] = _copy_sources(prof, steps=2)

    x, y = batches[0]
    with torch.no_grad():
        p0 = [p.clone() for p in state.params]
        m0 = [b.clone() for b in state.opt_state["momentum"]]
    state, lk = tr.train_step(state, x, y)
    with torch.no_grad():
        pk = [p.clone() for p in state.params]
        for p, a in zip(state.params, p0):
            p.copy_(a)
        for b, a in zip(state.opt_state["momentum"], m0):
            b.copy_(a)
    with mock.patch.multiple(tb, bn_stats=tb.bn_stats_ref,
                             bn_norm_relu=tb.bn_norm_relu_ref,
                             bn_bwd_stats=tb.bn_bwd_stats_ref,
                             bn_bwd_dx=tb.bn_bwd_dx_ref), \
            mock.patch.object(tsgd, "fused_sgd_step",
                              tsgd.fused_sgd_step_ref):
        state, lp = tr.train_step(state, x, y)
    torch.cuda.synchronize()
    lk, lp = float(lk), float(lp)
    with torch.no_grad():
        update = max(float((a - b).abs().max()) for a, b in zip(pk, p0))
        diff = max(float((a - b).abs().max())
                   for a, b in zip(pk, state.params))
    if not (math.isfinite(lk) and abs(lk - lp) <= 1e-2 * abs(lp)):
        fail(f"train step loss: kernels {lk} vs plain {lp} (tol 1e-2 rel)")
    if not diff <= 5e-2 * update:
        fail(f"train step params: kernels vs plain max|d|={diff} > 5e-2 x "
             f"largest update {update}")
    return {"traced_window": window,
            "step_check": {"loss_kernels": lk, "loss_plain": lp,
                           "max_param_diff": diff, "largest_update": update,
                           "tol": 5e-2 * update}}


def part3_nccl(dev) -> dict:
    """Phase 12: part 3 (DDP) at world 1 over NCCL."""
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ["TPU_DDP_MAX_ITERS"] = "20"
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    rc, out, wall = _run_part_captured(
        "part3", ["--num-nodes", "1", "--rank", "0", "--master-ip",
                  "127.0.0.1", "--master-port", str(port), "--device",
                  str(dev)])
    losses = [float(v) for v in
              re.findall(r"\[epoch 0, iter \d+\] loss: (\S+)", out)]
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if rc != 0 or "strategy=fused" not in out \
            or f"Backend: {backend}" not in out:
        fail(f"part3 did not run DistributedDataParallel over {backend}")
    if len(losses) != 1 or not all(math.isfinite(v) for v in losses):
        fail(f"part3 losses missing or not finite: {losses}")
    if "Test set:" not in out or dist.is_initialized():
        fail("part3 printed no 'Test set:' line or left its group open")
    return {"iters": 20, "losses": losses, "wall_s": wall}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every result to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs only "
             "on the card")
    try:
        import tpu_ddp_torch  # noqa: F401
    except ImportError as e:
        fail(f"cannot import tpu_ddp_torch ({e}); run from the repo root")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    build = build_all()
    print(json.dumps({"build": build}), flush=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows = check_kernel(dev, gen)
    parity = small_parity(dev)
    print(json.dumps({"small_parity": parity}), flush=True)
    serve = serve_large(dev, args.seed)
    print(json.dumps({"serve": serve}), flush=True)

    bn = check_bn(dev, gen)
    print(json.dumps({"bn_relu": {k: v for k, v in bn.items()
                                  if k != "shapes"}}), flush=True)
    sgd = check_sgd(dev, gen)
    print(json.dumps({"sgd": sgd}), flush=True)
    tparity = train_parity(dev)
    print(json.dumps({"train_small_parity": tparity}), flush=True)
    train = train_part1(dev)
    print(json.dumps({"train": train}), flush=True)
    step = train_step_checks(dev)
    print(json.dumps({"train_step": step}), flush=True)
    ddp = part3_nccl(dev)
    print(json.dumps({"part3_nccl": ddp}), flush=True)

    def per_pass(m, key):
        return sum(r[key] * r["per_pass"] for r in rows if r["m"] == m)

    t_bytes = per_pass(8, "bytes") / HBM_BYTES_PER_S * 1e3
    t_ops = sum(2 * 8 * r["k"] * r["n"] * r["per_pass"] for r in rows
                if r["m"] == 8) / BF16_FLOP_PER_S * 1e3
    kernels = [{
        "name": "int8_matmul",
        "route": "cuda",
        "source": "tpu_ddp_torch/ops/csrc/int8_matmul.cu",
        "replaces": "tpu_ddp/ops/pallas/quant_matmul.py:83",
        "launches": serve["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # Times and bound: one decode step's 49 launches at M = 8.
        "ms": per_pass(8, "ms"),
        "plain_ms": per_pass(8, "plain_ms"),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": per_pass(8, "library_ms"),
        "event_ms": per_pass(8, "event_ms"),
        "timing": ",".join(sorted({r["timing"] for r in rows})),
        "prefill_chunk_ms": per_pass(32, "ms"),
        "prefill_chunk_library_ms": per_pass(32, "library_ms"),
    }, {
        "name": "sgd",
        "route": "cuda",
        "source": "tpu_ddp_torch/ops/csrc/sgd.cu",
        "replaces": "tpu_ddp/ops/pallas/sgd.py:48",
        "launches": train["launches"]["sgd"],
        # Times and bound: one optimizer step over VGG-11's 34 leaves.
        **{k: sgd[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms", "event_ms",
                               "timing")},
    }]
    replaces = {"bn_stats": 139, "bn_norm_relu": 151, "bn_bwd_stats": 207,
                "bn_bwd_dx": 218}
    for name, line in replaces.items():
        k = bn["kernels"][name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "tpu_ddp_torch/ops/csrc/bn_relu.cu",
            "replaces": f"tpu_ddp/ops/pallas/bn_relu.py:{line}",
            "launches": train["launches"][name],
            # Times and bound: one train step's 8 calls at batch 256.
            **{key: k[key] for key in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "event_ms", "timing")},
        })
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "build": build, "shapes": rows,
                       "small_parity": parity, "serve": serve,
                       "bn_relu": bn, "sgd": sgd,
                       "train_small_parity": tparity, "train": train,
                       "train_step": step, "part3_nccl": ddp,
                       "kernels": kernels}, fh, indent=1)
    print(f"serve: TTFT median {serve['ttft_ms_median']:.1f} ms, max "
          f"{serve['ttft_ms_max']:.1f} ms; {serve['tokens_per_s']:.1f} "
          f"tokens/s over {serve['requests']} requests", flush=True)
    print(f"train: VGG-11 batch 256, {train['avg_iter_ms']:.2f} ms/iter "
          f"over iterations 1-39, {train['images_per_s']:.0f} images/s, "
          f"peak {train['peak_mem_gib']:.2f} GiB; device idle "
          f"{100 * step['traced_window']['device_idle_share']:.1f}% of a "
          f"traced 5-step window", flush=True)
    print(f"{card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
