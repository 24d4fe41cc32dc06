#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (tpu_ddp_torch): the quickest
proof that the port builds, serves and trains on the card.

    python3 chip_smoke.py [--seed N] [--out results.json]

Phases, each fatal on failure (exit code 1, no result line):

1. refuse to run without CUDA;
2. build every kernel from ``tpu_ddp_torch/ops/csrc`` with nvcc (one
   process per source, all started together);
3. hold both int8 matmul routes (``int8_route``: ``"mma"``, bf16 tensor
   cores fed by a cp.async ring, and ``"simt"``, the f32 design) against
   their plain PyTorch version at the TransformerLM-large projection and
   head shapes, M in {8, 32}, and at edge shapes (M in {1, 5, 13, 33,
   64}, K not a multiple of the 64-row stage, N not a multiple of the
   128-column tile, N not a multiple of 16 and f32 x for the simt route):
   max |kernel - plain| <= 1e-4 * max |plain|. At the LM-large shapes,
   which take the mma route, the bound must catch a planted fault (the
   plain output with the last 64 rows of q, one stage, dropped) and two
   mma launches must give the same bits; both routes are timed beside
   the bound, the plain version and the bf16 ``torch.matmul`` yardstick;
4. small parity: a TransformerLM-tiny engine on the card (f32 compute,
   int8 weights) against the same engine on the CPU, where the int8
   matmul is the plain version the CPU tests hold against the JAX
   package — identical greedy tokens, logprobs within 1e-4;
5. serve: TransformerLM-large at full width and depth, seeded random
   weights, ``decode_quant="int8"``, 8 requests of 64-512 prompt tokens
   and 32 new tokens (half greedy, half at temperature 0.8); every
   request must finish with finite logprobs, the pool must balance, and
   the int8 launch counts must be 49 per engine pass (12 layers x 4
   projections + the head), all on the mma route and none on simt,
   counted from 0 just before the run; a traced decode window gives the
   int8 kernels' device time per decode step, and a second one, with the
   simt route forced, the previous design's;
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
   The two reductions run their one-pass route (``stats_route``) and,
   forced, their two-stage route (the previous design), both held to the
   same bounds; at each VGG-11 shape two one-pass launches, and a third
   after a launch at another shape (the arrival counters' reset), must
   give the same bits. Each kernel is timed beside its bound, its plain
   version and one library call for the same pass, SyncBatchNorm's CUDA
   primitives: ``torch.batch_norm_stats`` (statistics; ``torch.var_mean``
   beside it), ``torch.batch_norm_elemt`` (normalise),
   ``batch_norm_backward_reduce`` and ``batch_norm_backward_elemt`` (fed
   the ReLU-masked gradient, since they have no ReLU), and the two
   reductions' two-stage route; ``bn_stats`` also beside ``torch.sum``
   over the same rows (one launch reading the same bytes); the op beside
   the yardstick ``F.relu(F.batch_norm(..., training=True))`` forward
   and forward+backward. The op computes its own statistics, so an
   element at the ReLU's edge may take the other side: dx is held away
   from the edge, dbias and dscale with those elements' terms taken out
   (both counted);
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
   ones 8 per step and per eval batch, the two reductions all on the
   one-pass route. Prints the reference's timer (iterations 1-39),
   images/s and peak memory, then a profiler window over 5 steps: the
   device's idle share, the top kernels and each ported kernel's device
   time per step (the ``kernels`` line's ``main_path_ms``), and a 2-step
   window with shapes that names the ops behind the copy kernels;
11. one whole train step through the kernels against the same step
   through the plain versions (same params, same batch): loss within
   1e-2 relative and every param within 5e-2 * the step's largest
   update (bf16 activations re-round at every layer, so a last-bit
   difference in a statistic can move a bf16 activation by 2**-8);
12. part 3 (``DistributedDataParallel``, 25 MB buckets) at world 1 over
   NCCL: 20 iterations on the card with finite losses;
13. the three flash-attention kernels (forward, dk/dv, dq) against their
   plain versions, each fed the plain forward's lse and delta, at
   TransformerLM-large's attention call (4, 2048, 16 heads, 128) bf16
   causal, with v a strided view of a fused qkv tensor, and at edge
   shapes (ragged L, D in {32, 36, 64}, GQA with KV in {4, 1},
   non-causal, f32 at L <= 384). Each output is held row by row (the
   D-vector of one position and head): the worst row's |kernel - plain|
   / |plain| within 2e-2 in bf16 (p and ds rounded to bf16 at another
   running max), 1e-5 for o and 2e-5 for dq, dk, dv in f32; lse
   within 1e-4 absolute in bf16, 1e-5 in f32. At the main shape every
   bound must also catch a planted fault, the plain outputs with the last
   64 keys dropped for the last 64 queries. Every kernel takes the wgmma
   route (``fwd_route``, ``bwd_route``) at the main shape and at every
   bf16 edge shape with D in {64, 128}, the mma.sync route at the rest;
   at the main shape two launches of each wgmma kernel must give the
   same bits, and the mma.sync kernels are held to the same bounds there
   too. Each kernel is timed at the main shape (12 calls per step) beside
   its bound, its plain version and SDPA's flash backend (forward; its
   backward for the two sweeps), and the mma.sync kernels beside them;
14. small parity: TransformerLM-tiny (2 layers, d_model 128, 4 heads of
   32, vocab 1024) at seq 256, f32, flash on: three ``LMTrainer`` steps on
   the card against the same steps on the CPU, where the kernels are
   their plain versions: losses within 1e-4 relative with the trainer's
   AdamW; and with AdamW eps 1e-3 (smooth where a gradient is near 0, see
   ``lm_parity``) losses within 1e-4 and params within rtol 1e-3 / atol
   1e-5;
15. train the LM: ``LMTrainer`` as ``bench.py:run_lm_bench`` drives it —
   TransformerLM-large (735,154,176 f32 params from seed 0), batch 4 x
   seq 2048, flash on, ``remat="none"``, bf16 compute, AdamW — 2 warm-up
   steps, then 10 timed steps on one repeated batch: every loss finite,
   the last below the first, and the flash launch counts exact from 0
   (12 of each per step, every launch on the wgmma route and none on
   mma.sync). Prints ms per step, tokens/s, MFU (3 x forward
   FLOPs / step time / 989e12) and peak memory, then a profiler window
   over 3 steps: the device's idle share and its top kernels; then the
   previous design on the same path, the mma.sync forward forced for 10
   untraced steps and a 3-step profiler window;
16. one step's loss and gradients through the kernels against the same
   through the plain versions (same params, same batch): loss within
   2e-4 relative, which must also catch the same step with the planted
   fault in every layer's forward; every gradient leaf within 2e-2
   relative (Frobenius), which cannot (the fault's reading is reported);
   the three flash kernels on the last layer's own q, k, v and dO from
   the step, held row by row with phase 13's bounds (2e-2 in bf16; a
   row's norm floored at a tenth of the RMS row norm, since some rows of
   dq vanish on these activations), each gradient bound also catching
   the fault on the same inputs; and the AdamW update within 5e-2 x the
   step's largest update wherever the plain gradient is above 5e-2 of
   its leaf's largest (below that the sign-like first moments of AdamW
   can differ, and those elements are counted); then one step under
   ``remat="blocks"``: 24 wgmma forward launches, 12 of each wgmma
   sweep and a loss within 1e-5 relative of the ``"none"`` step's;
17. the SGD kernel's ``skip`` flag (the step guard gates the update on
   the device) on VGG-11's 34 leaves and the odd leaves: with skip 0 the
   bits of the plain version and of the unflagged kernel, with skip 1
   (f32 or int32) params and momentum byte-identical to their inputs and
   the launch counted; the flagged, skipped and unflagged launches timed
   together;
18. fault tolerance on VGG-11 at batch 256, both kernels, through
   ``run_part("part1")`` and the ``Trainer`` it drives, cuDNN in
   deterministic mode (no autotuning) for steps 1-4 only: (1) 40
   iterations straight, against 20 with ``TPU_DDP_CKPT_EVERY=20`` and 20
   more resumed with ``--resume`` in a fresh ``Trainer``: the step-40
   checkpoints' sha256 digests equal leaf for leaf; (2) ``nan-grad@25``:
   exactly step 25 skipped, params and momentum digests equal before and
   after it, the loss finite again at step 26; (3) ``nan-grad@p1.0`` with
   ``TPU_DDP_GUARD_MAX_BAD=3``: ``TrainingDivergedError`` at step 3, the
   state unchanged; (4) ``corrupt-ckpt@20``: the newest checkpoint
   quarantined to ``step_00000020.corrupt`` and step 10 restored by the
   next ``--resume``; (5) the iteration time (1-39) with the guard on
   (the default) and with ``TPU_DDP_GUARD=0``, in turns (on, off, off,
   on), and the save and verified-restore times of the 74 MB state;
19. the restarting launcher on the card: ``python -m tpu_ddp_torch.launch
   part1 --nproc 1 --max-restarts 1 --ckpt-dir D`` with a chaos
   ``hard-exit@30``, a sentinel directory, 40 iterations, checkpoints
   every 20 and ``TPU_DDP_CUDNN_DETERMINISTIC=1``: exactly one restart,
   the second attempt resumes at step 20, the run exits 0 and prints
   ``Test set:``, every logged loss is finite, and the step-40 checkpoint
   equals phase 18's straight run digest for digest;
20. the LM trainer's checkpoint at full width: TransformerLM-large
   (735,154,176 params) with its AdamW state after phase 15's steps is
   saved (8.8 GB: f32 params, mu and nu; free disk checked first, at
   least twice that) and, after the first trainer is freed, restored
   into a fresh ``LMTrainer``: the next step's loss bit-identical to the
   original trainer's next step on the same batch (the second step's
   equality reported); save and restore seconds and GB/s.

Checkpoints of phases 18-20 go to ``_chip_smoke_ckpt/`` in the checkout
and are removed at the end. Prints the card's name and power limit, the
serving and training metrics, each phase's seconds, one
``{"kernels": [...]}`` line (nine kernels), and last the contract line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
# The shape launched between two launches at a VGG-11 shape in the
# one-pass reductions' bit-identity check.
BN_BITS_OTHER = (999, 96)
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
    regs, kernels = {}, {}
    for src in sources:
        log = cuda_build.library_path(src).with_suffix(".log")
        if log.exists():
            text = log.read_text()
            regs[src] = [ln.split("info    : ")[-1] for ln in
                         text.splitlines() if "registers" in ln]
            kernels.update(_ptxas_kernels(text))
    return {"sources": sources, "build_s": time.perf_counter() - t0,
            "ptxas": regs, "ptxas_by_kernel": kernels}


def _ptxas_kernels(text: str) -> dict:
    """Registers per thread and spill bytes (stores + loads) of every
    sm_90a entry function in an ``-Xptxas -v`` report, by mangled name."""
    out, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)' for 'sm_90a'", ln)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if name and m:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if name and m:
            out[name]["registers"] = int(m.group(1))
            name = None
    return out


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


# Edge shapes (M, K, N, dtype) beside LARGE_SHAPES: one row, M in {5,
# 13, 33, 64} (partial and several row tiles), K not a multiple of the
# mma route's 64-row stage (2056, 520), N not a multiple of its 128-column
# tile (2064), N not a multiple of 16 or K of 8 (the simt route), and f32
# x (the simt route, the parity path).
INT8_EDGE = [(1, 2048, 2048, torch.bfloat16), (5, 2056, 2048, torch.bfloat16),
             (13, 2056, 6144, torch.bfloat16),
             (33, 2048, 2064, torch.bfloat16), (64, 520, 4096, torch.bfloat16),
             (8, 2048, 2050, torch.bfloat16), (3, 100, 70, torch.bfloat16),
             (8, 2048, 2048, torch.float32), (40, 130, 201, torch.float32)]
INT8_K_TILE = 64  # the mma route's k rows per stage: the planted fault's cut


def _force(module, name, route):
    """Patch ``module.name`` (a route function) to answer ``route``."""
    return mock.patch.object(module, name, lambda *_: route)


def _int8_err(fn, x, q, s, ref):
    out = fn(x, q, s)
    torch.cuda.synchronize()
    return out, float((out - ref).abs().max())


def check_kernel(dev, gen) -> dict:
    """Phase 3: both int8 routes against the plain version at the ten
    LM-large shapes and the edge shapes; at the LM-large shapes the bound
    must catch a planted fault, two mma launches must give the same bits,
    and each route is timed beside the bound, the plain version and
    ``torch.matmul`` on a bf16 weight."""
    from tpu_ddp_torch.ops import quant_matmul as qm
    from tpu_ddp_torch.ops.quant import dequantize, quantize_weight
    int8_matmul, ref_fn = qm.int8_matmul, qm.int8_matmul_ref
    rows, edge = [], []
    for m, k, n, dtype in INT8_EDGE:
        x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
        qw = quantize_weight(0.02 * torch.randn(k, n, generator=gen,
                                                device=dev))
        ref = ref_fn(x, qw.q, qw.s)
        tol = 1e-4 * float(ref.abs().max())
        route = qm.int8_route(x, qw.q)
        errs = {route: _int8_err(int8_matmul, x, qw.q, qw.s, ref)[1]}
        if route == "mma":
            with _force(qm, "int8_route", "simt"):
                errs["simt"] = _int8_err(int8_matmul, x, qw.q, qw.s, ref)[1]
        for r, err in errs.items():
            if not (math.isfinite(err) and err <= tol):
                fail(f"int8_matmul ({r}) disagrees with its plain version at"
                     f" M={m} K={k} N={n} {dtype}: max|d|={err} vs tol {tol}")
        edge.append({"m": m, "k": k, "n": n, "dtype": str(dtype),
                     "route": route, "max_abs_err": errs, "tol": tol})
    for m in (8, 32):
        for name, ((k, n), per_pass) in LARGE_SHAPES.items():
            copies = max(2, math.ceil(2 * L2_BYTES / (k * n)))
            x = torch.randn(m, k, generator=gen, device=dev).to(
                torch.bfloat16)
            qws = [quantize_weight(0.02 * torch.randn(
                k, n, generator=gen, device=dev)) for _ in range(copies)]
            q, sc = qws[0].q, qws[0].s
            ref = ref_fn(x, q, sc)
            tol = 1e-4 * float(ref.abs().max())
            route = qm.int8_route(x, q)
            if route != "mma":
                fail(f"the LM-large shape M={m} K={k} N={n} takes the "
                     f"{route} route, not mma")
            out, err = _int8_err(int8_matmul, x, q, sc, ref)
            again = int8_matmul(x, q, sc)
            with _force(qm, "int8_route", "simt"):
                _, err_simt = _int8_err(int8_matmul, x, q, sc, ref)
            for r, e in (("mma", err), ("simt", err_simt)):
                if not (out.shape == ref.shape and math.isfinite(e)
                        and e <= tol):
                    fail(f"int8_matmul ({r}) disagrees with its plain "
                         f"version at M={m} K={k} N={n}: max|d|={e} vs tol "
                         f"{tol}")
            if not torch.equal(out, again):
                fail(f"two launches of the mma route differ at M={m} K={k} "
                     f"N={n}")
            # The planted fault: the plain output with the last k-tile's
            # rows of q dropped, which the bound must catch.
            cut = k - INT8_K_TILE
            fault = float((ref_fn(x[:, :cut], q[:cut], sc) - ref).abs()
                          .max())
            if not fault > tol:
                fail(f"the int8 bound {tol} misses the planted fault (a "
                     f"dropped k-tile reads {fault}) at M={m} K={k} N={n}")
            del out, again
            args = [(x, qw.q, qw.s) for qw in qws]
            kern = timed(int8_matmul, args, 20 * copies)
            with _force(qm, "int8_route", "simt"):
                simt = timed(int8_matmul, args, 20 * copies)
            plain = timed(ref_fn, args, 4 * copies)
            wbf = [(x, dequantize(qw).to(torch.bfloat16)) for qw in qws]
            lib = timed(torch.matmul, wbf, 20 * copies)
            del wbf, qws
            nbytes = m * k * 2 + k * n + n * 4 + m * n * 4
            ops = 2 * m * k * n
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / BF16_FLOP_PER_S * 1e3
            rows.append({"m": m, "k": k, "n": n, "proj": name,
                         "per_pass": per_pass, "route": route,
                         "max_abs_err": err, "simt_max_abs_err": err_simt,
                         "tol": tol, "planted_fault_max_abs": fault,
                         "ms": kern["ms"], "simt_ms": simt["ms"],
                         "plain_ms": plain["ms"], "library_ms": lib["ms"],
                         "event_ms": kern["event_ms"],
                         "simt_event_ms": simt["event_ms"],
                         "plain_event_ms": plain["event_ms"],
                         "library_event_ms": lib["event_ms"],
                         "timing": _timing_label(kern, simt, plain, lib),
                         "bound_ms": max(t_bytes, t_ops),
                         "bound_by": "bytes" if t_bytes >= t_ops
                         else "operations", "bytes": nbytes})
            print(json.dumps({"int8_matmul_shape": rows[-1]}), flush=True)
    return {"shapes": rows, "edge_shapes": edge}


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
    from tpu_ddp_torch.ops import quant_matmul as qm
    from tpu_ddp_torch.ops.quant_matmul import int8_matmul, int8_matmul_ref
    from tpu_ddp_torch.serve.engine import ServeEngine, decode_logits
    from tpu_ddp_torch.utils.tree import tree_leaves

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
    int8_matmul.launches = dict.fromkeys(int8_matmul.launches, 0)
    lens = rng.integers(64, 513, size=8)
    t0 = time.perf_counter()
    reqs = [eng.submit(rng.integers(0, model.vocab_size, size=int(L)), 32,
                       temperature=0.0 if i % 2 == 0 else 0.8, seed=i)
            for i, L in enumerate(lens)]
    steps = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(int8_matmul.launches)

    chunks = eng.metrics.counters["serve_prefill_chunks"] \
        - c0.get("serve_prefill_chunks", 0)
    dsteps = eng.metrics.counters["serve_decode_steps"] \
        - c0.get("serve_decode_steps", 0)
    per_pass = 4 * model.num_layers + 1
    want = {"mma": per_pass * (chunks + dsteps), "simt": 0}
    if launches != want or want["mma"] == 0:
        fail(f"int8_matmul launched {launches} times by route; the run made "
             f"{chunks} prefill chunks + {dsteps} decode steps x "
             f"{per_pass}, all on the mma route")
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
    # The previous design on the same path: the same probe, its decode
    # traced with the simt route forced.
    probe += [eng.submit(rng.integers(0, model.vocab_size, size=64), 32)
              for _ in range(eng.num_slots)]
    while eng.sched.queue or eng.sched.prefill_slot() is not None:
        eng.step()
    with _force(qm, "int8_route", "simt"):
        trace_simt = traced_run(eng)
    if not trace_simt["int8_device_ms"]["simt"] > 0:
        fail(f"the forced simt window ran no simt kernel: {trace_simt}")
    for r in probe:
        if not r.done:
            fail("probe request did not finish")
    return {"model": model.name, "params": sum(
        p.numel() for p in tree_leaves(params)), "setup_s": setup_s,
        "requests": len(reqs), "prompt_lens": [int(v) for v in lens],
        "new_tokens": tokens, "engine_steps": steps,
        "prefill_chunks": chunks, "decode_steps": dsteps,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "ttft_ms_median": ttft[len(ttft) // 2], "ttft_ms_max": ttft[-1],
        "launches": launches, "decode_step_logit_err": step_err,
        "decode_step_logit_tol": step_tol,
        "decode_step_argmax_agreement": agree, "traced_window": trace,
        "traced_window_simt": trace_simt,
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}


# The int8 kernels by name in a trace (no name is a substring of
# another): each route's kernel and the simt route's split-K pass.
INT8_KERNELS = {"mma": "int8_matmul_mma_kernel",
                "simt": "int8_matmul_kernel", "reduce": "splitk_reduce"}


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
    by_kernel = {p: sum(v for k, v in dev_us.items() if p in k) / 1e3
                 for p in INT8_KERNELS.values()}
    steps = eng.metrics.counters["serve_decode_steps"] \
        - c0.get("serve_decode_steps", 0)
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    return {"decode_steps": steps,
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
            "int8_device_ms": {r: by_kernel[p]
                               for r, p in INT8_KERNELS.items()},
            "int8_matmul_device_ms": sum(by_kernel.values()),
            "int8_ms_per_decode_step": sum(by_kernel.values()) / steps
            if steps else None,
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


def _bn_inputs(r, c, gen, dev):
    """x, g (R, C) and scale, bias (C,) as phase 7 draws them."""
    x = torch.randn(r, c, generator=gen, device=dev) * 2 + 0.3
    g = torch.randn(r, c, generator=gen, device=dev)
    s = 0.5 + torch.rand(c, generator=gen, device=dev)
    b = 0.1 * torch.randn(c, generator=gen, device=dev)
    return x, g, s, b


def _two_stage_errors(tb, x, g, s, b):
    """The two reductions' errors with the two-stage route forced (the
    previous design), against the same bounds as the one-pass route."""
    with _force(tb, "stats_route", "two_stage"):
        errs, _ = _bn_kernel_errors(tb, x, g, s, b)
    return {k: v for k, v in errs.items()
            if k.startswith(("bn_stats", "bn_bwd_stats"))}


def _stats_bits(tb, x, g, s, b, other) -> bool:
    """Whether the one-pass reductions give the same bits on two launches
    on (x, g) and on a third after a launch on ``other`` (another shape:
    other counters and partials, so the counters' reset is exercised)."""
    def outs(x, g, s, b):
        mean, inv = tb.bn_stats(x)
        return (mean, inv, *tb.bn_bwd_stats(x, g, mean, inv, s, b))
    first = outs(x, g, s, b)
    again = outs(x, g, s, b)
    outs(*other)
    third = outs(x, g, s, b)
    torch.cuda.synchronize()
    return all(torch.equal(a, o) and torch.equal(a, t)
               for a, o, t in zip(first, again, third))


def _fail_on(errs, where):
    for what, (err, tol) in errs.items():
        if not (math.isfinite(err) and err <= tol):
            fail(f"{what} disagrees with its plain version at {where}: "
                 f"error {err} vs tol {tol}")


def check_bn(dev, gen) -> dict:
    """Phase 7: the four BN+ReLU kernels at VGG-11's eight conv outputs,
    and at a few small shapes that take the kernels' other paths (C not a
    multiple of 4, rows not a multiple of a block)."""
    import torch.nn.functional as F

    from tpu_ddp_torch.ops import bn_relu as tb
    edge = {}
    other = _bn_inputs(*BN_BITS_OTHER, gen, dev)
    for r, c in BN_EDGE_SHAPES:
        x, g, s, b = _bn_inputs(r, c, gen, dev)
        errs, _ = _bn_kernel_errors(tb, x, g, s, b)
        _fail_on(errs, f"R={r} C={c}")
        was = _two_stage_errors(tb, x, g, s, b)
        _fail_on(was, f"R={r} C={c} (two_stage)")
        edge[f"{r}x{c}"] = {k: v[0] for k, v in errs.items()}
        edge[f"{r}x{c}"]["two_stage"] = {k: v[0] for k, v in was.items()}
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
        was = _two_stage_errors(tb, x, g, s, b)
        _fail_on(was, f"R={r} C={c} (two_stage)")
        if not _stats_bits(tb, x, g, s, b, other):
            fail(f"two launches of the one-pass reductions differ at R={r} "
                 f"C={c} (or after a launch at {BN_BITS_OTHER})")
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
        # An element that does fall on the other side moves dbias by its g
        # and dscale by g * x_hat: those terms are taken out of the op's
        # sums before they are held, and the elements counted. The op's
        # statistics are the one-pass kernel's, the same bits every
        # launch; the kernels pass g where y > 0, autograd through the
        # plain clamp_min where y >= 0.
        km, ki = tb.bn_stats(x)
        xh_k = (x - km) * ki
        moved = (xh_k > 0).float() - (((x - mean) * inv) >= 0).float()
        flipped = moved != 0
        n_flip = int(flipped.sum())
        if bool((flipped & ~near_zero).any()):
            fail(f"op: an element more than 1e-5 from the ReLU's edge "
                 f"changed sides at R={r} C={c}")
        flip_db = (g * moved).sum(0)
        flip_ds = (g * xh_k * moved).sum(0)
        errs.update({
            "op_y": (float((oy - py).abs().max()),
                     1e-4 * float(py.abs().max())),
            "op_dx": (float(torch.where(near_zero, 0.0,
                                        (odx - pdx).abs()).max()),
                      1e-4 * float(pdx.abs().max())),
            "op_dscale": (float((ods - pds - flip_ds).abs().max()),
                          1e-4 * float((g * x_hat0).abs().sum(0).max())),
            "op_dbias": (float((odb - pdb - flip_db).abs().max()),
                         1e-4 * float(g.abs().sum(0).max())),
        })
        _fail_on(errs, f"R={r} C={c}")

        row = {"r": r, "c": c, "units": units, "copies": copies,
               "op_dx_near_relu_edge": n_near, "op_relu_flips": n_flip,
               "errors": {k: v[0] for k, v in errs.items()},
               "two_stage_errors": {k: v[0] for k, v in was.items()},
               "tols": {k: v[1] for k, v in errs.items()},
               "same_bits": True}
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
            if name in ("bn_stats", "bn_bwd_stats"):
                with _force(tb, "stats_route", "two_stage"):
                    row[name]["was_ms"] = timed(kern, args[name], reps)["ms"]
        # Library calls for the same passes: SyncBatchNorm's CUDA
        # primitives (batch_norm_stats: mean and invstd; var_mean beside
        # it). These have no ReLU, so the backward ones take the
        # ReLU-masked gradient, made outside the timing; their outputs are
        # held to the plain versions below (recorded, not gated: they are
        # yardsticks).
        gms = [torch.where(tb.bn_norm_relu_ref(xi, mean, inv, s, b) > 0,
                           gi, 0.0) for xi, gi in zip(xs, gs)]
        count = torch.tensor([r], dtype=torch.int32, device=dev)
        sum_dy_xmu = ds / inv
        libs = {
            "bn_stats": (lambda t: torch.batch_norm_stats(t, tb.BN_EPS),
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

        def var_mean(t):
            return torch.var_mean(t, dim=0, correction=0)

        row["bn_stats"]["library_var_mean_ms"] = timed(
            var_mean, args["bn_stats"], reps)["ms"]
        # Not the same function: one launch that reads the same rows and
        # writes one scalar, PyTorch's full reduction. Its time is what a
        # single reduction launch over these bytes costs on this card.
        row["bn_stats"]["read_all_ms"] = timed(
            torch.sum, args["bn_stats"], reps)["ms"]
        red = libs["bn_bwd_stats"][0](x, gms[0])
        lib_mean, lib_inv = libs["bn_stats"][0](x)
        row["library_errors"] = {
            "bn_stats": max(float((lib_mean - mean).abs().max()),
                            float((lib_inv - inv).abs().max())),
            "bn_stats_var_mean": float((var_mean(x)[1] - mean).abs().max()),
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
            **({"was_ms": per_step(name, "was_ms")}
               if name in ("bn_stats", "bn_bwd_stats") else {}),
            "event_ms": per_step(name, "event_ms"),
            "bound_ms": bound, "bound_by": by,
            "library_ms": per_step(name, "library_ms"),
            "library_max_abs_err": max(row["library_errors"][name]
                                       for row in shapes),
            "max_abs_err": max(row["errors"][k] for row in shapes
                               for k in err_keys),
            "timing": ",".join(sorted({row[name]["timing"]
                                       for row in shapes}))}
    for key in ("library_var_mean_ms", "read_all_ms"):
        out["kernels"]["bn_stats"][key] = per_step("bn_stats", key)
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
# Each VGG kernel wrapper's kernels by name in a trace (no name is a
# substring of another wrapper's): for the two reductions, the one-pass
# kernel and the two-stage pair.
VGG_KERNELS = {"bn_stats": ("bn_stats_onepass_kernel", "bn_stats_kernel",
                            "bn_stats_finish"),
               "bn_norm_relu": ("bn_norm_relu_kernel",),
               "bn_bwd_stats": ("bn_bwd_stats_onepass_kernel",
                                "bn_bwd_stats_kernel", "bn_bwd_finish"),
               "bn_bwd_dx": ("bn_bwd_dx_kernel",), "sgd": ("sgd_kernel",)}


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
    _zero_launches(wrappers)
    rc, out, wall = _run_part_captured("part1", ["--device", str(dev)])
    counts = _launches(wrappers)
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
    want = {"sgd": steps,
            "bn_bwd_stats": {"one_pass": 8 * steps, "two_stage": 0},
            "bn_bwd_dx": 8 * steps,
            "bn_stats": {"one_pass": 8 * (steps + eval_batches),
                         "two_stage": 0},
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
    ours = {k: sum(v for n, v in dev_us.items()
                   if any(p in n for p in pats)) / 1e3 / 5
            for k, pats in VGG_KERNELS.items()}
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


# Flash attention (phase 13): TransformerLM-large's attention call, and
# edge shapes as (B, L, H, KV, D, causal, dtype): ragged L, D in {32, 64}
# and one that takes the scalar loads (D % 8 != 0), grouped K/V with
# KV in {4, 1}, non-causal, and f32 at L <= 384.
FLASH_MAIN = (4, 2048, 16, 16, 128)
FLASH_EDGE = [
    (2, 100, 16, 16, 128, True, torch.bfloat16),
    (2, 130, 16, 16, 64, True, torch.bfloat16),
    (1, 1000, 16, 16, 128, True, torch.bfloat16),
    (2, 256, 16, 16, 32, True, torch.bfloat16),
    (2, 300, 16, 16, 64, False, torch.bfloat16),
    (2, 512, 16, 4, 128, True, torch.bfloat16),
    (2, 384, 16, 1, 64, True, torch.bfloat16),
    (2, 130, 16, 4, 32, False, torch.bfloat16),
    (1, 200, 8, 2, 36, True, torch.bfloat16),
    (1, 384, 16, 16, 128, True, torch.float32),
    (1, 100, 16, 4, 32, False, torch.float32),
    (1, 257, 16, 1, 64, True, torch.float32),
]
# Each output is held row by row: the worst over its rows (the D-vector
# of one position and head) of |kernel_r - plain_r| / |plain_r|, with the
# row norm floored at 1e-3 of the tensor's RMS row norm; lse absolute.
# bf16: the kernels and the plain versions round p (and ds) to bf16 at
# other running maxima and sum in other orders, so rows part by about one
# bf16 unit (2**-8 = 3.9e-3). The bounds sit between those readings and
# the readings of a planted fault: the plain outputs with the last 64
# keys dropped for the last 64 queries (_dropped_tile), which every run
# also checks they catch. f32: summation order only.
FLASH_TOL = {torch.bfloat16: {"o": 2e-2, "grad": 2e-2, "lse": 1e-4},
             torch.float32: {"o": 1e-5, "grad": 2e-5, "lse": 1e-5}}
FLASH_LAYERS = 12  # launches of each flash kernel per LM-large train step
FAULT_TILE = 64


def _flash_inputs(shape, causal, dtype, gen, dev, fused_v=True):
    """q, k (contiguous, as RoPE leaves them), v (a strided view of a
    fused (B, L, 3, H, D) product when KV == H, as the model's qkv split
    gives it) and dO."""
    b, L, h, kvh, d = shape
    q = torch.randn(b, L, h, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, L, kvh, d, generator=gen, device=dev).to(dtype)
    if fused_v and kvh == h:
        v = torch.randn(b, L, 3, h, d, generator=gen, device=dev).to(
            dtype)[:, :, 2]
    else:
        v = torch.randn(b, L, kvh, d, generator=gen, device=dev).to(dtype)
    do = torch.randn(b, L, h, d, generator=gen, device=dev).to(dtype)
    return q, k, v, do


def _readings(a, b, floor: float = 1e-3) -> dict:
    """How far ``a`` lies from ``b`` (both (B, L, heads, D)): the worst
    row's relative error (the bound's reading; a row's norm floored at
    ``floor`` x the RMS row norm), the whole tensor's relative Frobenius
    error, and max |a - b|."""
    a, b = a.float(), b.float()
    dn, bn = (a - b).norm(dim=-1), b.norm(dim=-1)
    floor = floor * float(bn.square().mean().sqrt())
    return {"row": float((dn / bn.clamp_min(floor)).max()),
            "frob": float((a - b).norm() / b.norm()),
            "max_abs": float((a - b).abs().max())}


def _flash_errors(fa, q, k, v, do, causal, floor: float = 1e-3):
    """Each flash kernel against its plain version on the same inputs:
    ({what: (reading, tol)}, {what: readings}, plain outputs); rows
    floored at ``floor`` x the RMS row norm (``_readings``)."""
    tol = FLASH_TOL[q.dtype]
    po, plse = fa.flash_fwd_plain(q, k, v, causal)
    delta = fa.attention_delta(po, do)
    pdk, pdv = fa.flash_bwd_kv_plain(q, k, v, do, plse, delta, causal)
    pdq = fa.flash_bwd_q_plain(q, k, v, do, plse, delta, causal)
    o, lse = fa.flash_fwd(q, k, v, causal)
    dk, dv = fa.flash_bwd_kv(q, k, v, do, plse, delta, causal)
    dq = fa.flash_bwd_q(q, k, v, do, plse, delta, causal)
    torch.cuda.synchronize()
    reads = {w: _readings(t, p, floor) for w, t, p in
             (("o", o, po), ("dq", dq, pdq), ("dk", dk, pdk),
              ("dv", dv, pdv))}
    errs = {w: (r["row"], tol["o" if w == "o" else "grad"])
            for w, r in reads.items()}
    errs["lse"] = (float((lse - plse).abs().max()), tol["lse"])
    for t in (o, lse, dq, dk, dv):
        if not bool(torch.isfinite(t.float()).all()):
            errs["finite"] = (math.inf, 0.0)
    plain = {"o": po, "lse": plse, "delta": delta, "dq": pdq, "dk": pdk,
             "dv": pdv}
    return errs, reads, plain


def _dropped_tile(q, k, v, do, plain) -> dict:
    """The planted fault: the plain outputs as a causal kernel would give
    them that skipped the last 64-key tile for the last 64 queries, with
    p and ds rounded as the kernels round them; o and lse alone when
    ``do`` is None."""
    b, L, h, d = q.shape
    kvh, n = k.shape[2], FAULT_TILE
    g, t, scale = h // kvh, slice(L - n, L), 1.0 / math.sqrt(d)

    def heads(x, rep):  # (B, n, heads, D) -> (B, H, n, D) f32
        return x[:, t].float().repeat_interleave(rep, 2).transpose(1, 2)

    qt, kt, vt = heads(q, 1), heads(k, g), heads(v, g)
    lse = plain["lse"][..., t, None]
    if do is not None:
        dot, delta = heads(do, 1), plain["delta"][..., t, None]
    s = (qt @ kt.transpose(-1, -2) * scale).masked_fill(
        torch.ones(n, n, dtype=torch.bool, device=q.device).triu(1), -1e30)
    p = torch.exp(s - lse)
    pr = p.to(q.dtype).float()
    if do is not None:
        ds = p * (dot @ vt.transpose(-1, -2) - delta) * scale
        dsr = ds.to(q.dtype).float()

    def fold(x):  # (B, H, n, D) per q head -> (B, n, KV, D)
        return x.reshape(b, kvh, g, n, d).sum(2).transpose(1, 2)

    kept = 1.0 - p.sum(-1, keepdim=True)
    out = {"lse": plain["lse"].clone(), "o": plain["o"].float().clone()}
    out["lse"][..., t] += torch.log(kept[..., 0])
    out["o"][:, t] = ((out["o"][:, t].transpose(1, 2) - pr @ vt)
                      / kept).transpose(1, 2)
    if do is not None:
        out["dq"] = plain["dq"].float().clone()
        out["dq"][:, t] -= (dsr @ kt).transpose(1, 2)
        for w, x in (("dk", dsr.transpose(-1, -2) @ qt),
                     ("dv", pr.transpose(-1, -2) @ dot)):
            out[w] = plain[w].float().clone()
            out[w][:, t] -= fold(x)
    return {w: x.to(plain[w].dtype) for w, x in out.items()}


def _flash_work(shape, causal, itemsize):
    """(FLOPs, bytes) of one fwd, dk/dv and dq call: 2 D FLOP per (q, k)
    pair and product — fwd q.k and p.v; dk/dv q.k, dO.v, p^T.dO, ds^T.q;
    dq q.k, dO.v, ds.k — over the pairs this mask keeps; each input read
    once and each output written once."""
    b, L, h, kvh, d = shape
    pairs = b * h * (L * (L + 1) // 2 if causal else L * L)
    q_b, kv_b, row_b = b * L * h * d * itemsize, b * L * kvh * d * itemsize, \
        b * h * L * 4
    return {"fwd": (4 * d * pairs, 2 * q_b + 2 * kv_b + row_b),
            "bwd_kv": (8 * d * pairs, 2 * q_b + 4 * kv_b + 2 * row_b),
            "bwd_q": (6 * d * pairs, 3 * q_b + 2 * kv_b + 2 * row_b)}


def check_flash(dev, gen) -> dict:
    """Phase 13: the three flash kernels against their plain versions at
    LM-large's attention call and at the edge shapes; each timed at the
    main shape beside its bound, its plain version and SDPA."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from tpu_ddp_torch.ops import flash_attention as fa
    edge = {}
    for b, L, h, kvh, d, causal, dtype in FLASH_EDGE:
        q, k, v, do = _flash_inputs((b, L, h, kvh, d), causal, dtype, gen,
                                    dev)
        errs, reads, _ = _flash_errors(fa, q, k, v, do, causal)
        where = (f"B={b} L={L} H={h} KV={kvh} D={d} causal={causal} "
                 f"{dtype}")
        _fail_on(errs, where)
        edge[where] = {"fwd_route": fa.fwd_route(q, k, v),
                       "bwd_route": fa.bwd_route(q, k, v, do),
                       "bounds": {k_: list(v_) for k_, v_ in errs.items()},
                       "readings": reads}
    shape = FLASH_MAIN
    q, k, v, do = _flash_inputs(shape, True, torch.bfloat16, gen, dev)
    errs, reads, plain = _flash_errors(fa, q, k, v, do, True)
    _fail_on(errs, f"the LM-large shape {shape}")
    # Each bound must catch the planted fault at this shape.
    faulty = _dropped_tile(q, k, v, do, plain)
    fault = {w: _readings(faulty[w], plain[w]) for w in ("o", "dq", "dk",
                                                           "dv")}
    fault["lse"] = {"abs": float((faulty["lse"] - plain["lse"]).abs()
                                 .max())}
    for w, (_, tol) in errs.items():
        seen = fault[w]["row"] if w != "lse" else fault[w]["abs"]
        if not seen > tol:
            fail(f"the {w} bound {tol} misses the planted fault (a dropped "
                 f"tile reads {seen})")
    plse, delta = plain["lse"], plain["delta"]
    route = fa.bwd_route(q, k, v, do)
    if route != "wgmma" or fa.fwd_route(q, k, v) != "wgmma":
        fail(f"the LM-large shape takes the {fa.fwd_route(q, k, v)} forward"
             f" and the {route} backward, not wgmma")
    # The wgmma kernels use no atomics: two launches give the same bits.
    runs = [(*fa.flash_fwd(q, k, v, True),
             *fa.flash_bwd_kv(q, k, v, do, plse, delta, True),
             fa.flash_bwd_q(q, k, v, do, plse, delta, True))
            for _ in range(2)]
    if not all(torch.equal(a, b_) for a, b_ in zip(*runs)):
        fail("two launches of the wgmma kernels differ")
    del runs
    # The mma.sync forward and sweeps, which the routes keep for f32,
    # other head dims and unaligned inputs, at the same shape: held to the
    # same bounds, and timed beside the wgmma kernels.
    with _force(fa, "fwd_route", "mma_sync"):
        o, lse = fa.flash_fwd(q, k, v, True)
        old_fwd = {"o": _readings(o, plain["o"]),
                   "lse": {"abs": float((lse - plse).abs().max())}}
        del o, lse
        ftol = FLASH_TOL[q.dtype]
        _fail_on({"o": (old_fwd["o"]["row"], ftol["o"]),
                  "lse": (old_fwd["lse"]["abs"], ftol["lse"])},
                 f"the LM-large shape {shape} (mma_sync forward)")
        old_fwd_t = timed(lambda: fa.flash_fwd(q, k, v, True), [()], 20)
    tol = FLASH_TOL[q.dtype]["grad"]
    with _force(fa, "bwd_route", "mma_sync"):
        dk, dv = fa.flash_bwd_kv(q, k, v, do, plse, delta, True)
        dq = fa.flash_bwd_q(q, k, v, do, plse, delta, True)
        old_reads = {"dq": _readings(dq, plain["dq"]),
                     "dk": _readings(dk, plain["dk"]),
                     "dv": _readings(dv, plain["dv"])}
        del dk, dv, dq
        _fail_on({w: (r["row"], tol) for w, r in old_reads.items()},
                 f"the LM-large shape {shape} (mma_sync route)")
        old = {"fwd": old_fwd_t, "bwd_kv": timed(lambda: fa.flash_bwd_kv(
            q, k, v, do, plse, delta, True), [()], 20),
            "bwd_q": timed(lambda: fa.flash_bwd_q(
                q, k, v, do, plse, delta, True), [()], 20)}
    del plain, faulty
    reps = 50
    kern = {"fwd": timed(lambda: fa.flash_fwd(q, k, v, True), [()], reps),
            "bwd_kv": timed(lambda: fa.flash_bwd_kv(q, k, v, do, plse, delta,
                                                    True), [()], reps),
            "bwd_q": timed(lambda: fa.flash_bwd_q(q, k, v, do, plse, delta,
                                                  True), [()], reps)}
    plain = {"fwd": timed(lambda: fa.flash_fwd_plain(q, k, v, True), [()], 3),
             "bwd_kv": timed(lambda: fa.flash_bwd_kv_plain(
                 q, k, v, do, plse, delta, True), [()], 3),
             "bwd_q": timed(lambda: fa.flash_bwd_q_plain(
                 q, k, v, do, plse, delta, True), [()], 3)}
    # The yardstick: SDPA's flash backend on the same values in its
    # (B, H, L, D) layout, forward, and backward alone (kernels 3 and 4
    # together), causal.
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous().requires_grad_()
                       for t in (q, k, v, do))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        with torch.no_grad():
            lib_fwd = timed(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), [()], reps)
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        lib_err = float((out.detach().transpose(1, 2).float()
                         - fa.flash_fwd(q, k, v, True)[0].float()).abs().max())
        lib_bwd = timed(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), [()], reps)
    del out, qt, kt, vt, dot
    work = _flash_work(shape, True, 2)
    rows = {}
    for name in ("fwd", "bwd_kv", "bwd_q"):
        flops, nbytes = work[name]
        t_ops = flops / BF16_FLOP_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        lib = lib_fwd if name == "fwd" else lib_bwd
        rows[name] = {
            "max_abs_err": reads["o" if name == "fwd" else
                                 "dq" if name == "bwd_q" else "dk"][
                                     "max_abs"],
            "ms_per_call": kern[name]["ms"],
            "ms": FLASH_LAYERS * kern[name]["ms"],
            "event_ms": FLASH_LAYERS * kern[name]["event_ms"],
            "plain_ms": FLASH_LAYERS * plain[name]["ms"],
            "library_ms": FLASH_LAYERS * lib["ms"],
            "bound_ms": FLASH_LAYERS * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "timing": _timing_label(kern[name], plain[name], lib)}
        if name == "bwd_kv":
            rows[name]["max_abs_err_dv"] = reads["dv"]["max_abs"]
        rows[name].update(kernel_route=route,
                          mma_sync_ms=FLASH_LAYERS * old[name]["ms"])
    return {"shape": shape,
            "bounds": {k_: list(v_) for k_, v_ in errs.items()},
            "readings": reads, "planted_fault_readings": fault,
            "mma_sync_readings": {**old_reads, **old_fwd},
            "library_fwd_max_abs_err": lib_err, "edge_shapes": edge,
            "kernels": rows}


def _flash_wrappers():
    from tpu_ddp_torch.ops import flash_attention as fa
    return {"flash_fwd": fa.flash_fwd, "flash_bwd_kv": fa.flash_bwd_kv,
            "flash_bwd_q": fa.flash_bwd_q}


def _zero_launches(wrappers) -> None:
    """Set every count to 0: an int, or a dict by route for the routed
    wrappers."""
    for w in wrappers.values():
        w.launches = (dict.fromkeys(w.launches, 0)
                      if isinstance(w.launches, dict) else 0)


def _launches(wrappers) -> dict:
    return {k: dict(w.launches) if isinstance(w.launches, dict)
            else w.launches for k, w in wrappers.items()}


def _flash_want(fwd: int, bwd: int) -> dict:
    """The exact counts of a run on the main path: every launch on the
    wgmma route."""
    return {"flash_fwd": {"wgmma": fwd, "mma_sync": 0},
            "flash_bwd_kv": {"wgmma": bwd, "mma_sync": 0},
            "flash_bwd_q": {"wgmma": bwd, "mma_sync": 0}}


# Each wrapper's kernels by name in a trace (neither name is a substring
# of the other): the wgmma kernel first, then the mma.sync one.
FLASH_KERNELS = {"flash_fwd": ("flash_fwd_wgmma_kernel", "flash_fwd_kernel"),
                 "flash_bwd_kv": ("flash_bwd_kv_wgmma_kernel",
                                  "flash_bwd_kv_kernel"),
                 "flash_bwd_q": ("flash_bwd_q_wgmma_kernel",
                                 "flash_bwd_q_kernel")}


def _flash_window(prof, steps: int) -> dict:
    """Device ms per step of each flash kernel in a trace, by wrapper and
    by kernel name."""
    dev_us = _device_us(prof)
    by_kernel = {p: sum(v for n, v in dev_us.items() if p in n) / 1e3
                 / steps for pats in FLASH_KERNELS.values() for p in pats}
    return {"by_wrapper": {w: sum(by_kernel[p] for p in pats)
                           for w, pats in FLASH_KERNELS.items()},
            "by_kernel": by_kernel,
            "device_ms_per_step": sum(dev_us.values()) / 1e3 / steps}


def lm_parity(dev) -> dict:
    """Phase 14: a 2-layer narrow LM (TransformerLM-tiny: d_model 128, 4
    heads of 32, vocab 1024) at seq 256, f32, flash on: three LMTrainer
    steps on the card against the same steps on the CPU, where the flash
    kernels are their plain versions.

    Run twice: with the trainer's AdamW (eps 1e-8), holding the losses;
    and with eps 1e-3, holding the losses and every param. AdamW's step
    lr * m / (sqrt(v) + eps) is ill-conditioned where |g| is near eps: an
    f32 rounding difference in a gradient that sums to nearly 0 moves
    that element's step by up to lr (3e-4), whatever the kernels do. With
    eps 1e-3 the step is smooth in g, so the params show the gradients'
    agreement."""
    from tpu_ddp_torch.models.transformer import make_transformer
    from tpu_ddp_torch.ops.optim import AdamW
    from tpu_ddp_torch.train.lm import LMTrainer, make_lm_batch
    from tpu_ddp_torch.utils.tree import tree_leaves, tree_unflatten
    model = make_transformer("TransformerLM-tiny", max_seq_len=256,
                             compute_dtype=torch.float32, use_flash=True)
    params0 = model.init(torch.Generator().manual_seed(0))
    tokens = np.random.default_rng(3).integers(0, model.vocab_size,
                                               size=(4, 257))
    out = {"steps": 3, "seq": 256}
    for eps, hold_params in ((1e-8, False), (1e-3, True)):
        runs = {}
        for where in ("cpu", dev):
            tr = LMTrainer(model, device=where, optimizer=AdamW(eps=eps))
            # A copy on each side: the trainer updates params in place.
            state = tr.init_state(params=tree_unflatten(
                params0, [t.clone().to(where)
                          for t in tree_leaves(params0)]))
            x, y = tr.put_batch(*make_lm_batch(tokens))
            losses = []
            for _ in range(3):
                state, loss = tr.train_step(state, x, y)
                losses.append(float(loss))
            runs[str(where)] = (losses, [p.detach().cpu()
                                         for p in tree_leaves(state.params)])
        (lc, pc), (lg, pg) = runs["cpu"], runs[str(dev)]
        loss_rel = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
        worst, excess = 0.0, 0.0
        for a, b in zip(pc, pg):
            if not torch.isfinite(b).all():
                fail(f"LM small parity (eps {eps}): non-finite params")
            worst = max(worst, float((a - b).abs().max()))
            excess = max(excess, float(((a - b).abs()
                                        - (1e-5 + 1e-3 * a.abs())).max()))
        if hold_params and excess > 0:
            fail(f"LM small parity (eps {eps}): params differ beyond rtol "
                 f"1e-3 / atol 1e-5 (max|d|={worst})")
        if not loss_rel <= 1e-4:
            fail(f"LM small parity (eps {eps}): losses differ by {loss_rel}"
                 f" relative > 1e-4 (cpu {lc}, cuda {lg})")
        out[f"adamw_eps_{eps:g}"] = {
            "losses_cpu": lc, "losses_cuda": lg,
            "max_loss_rel_diff": loss_rel, "max_param_diff": worst,
            "params_held": hold_params}
    return out


LM_BATCH, LM_SEQ, LM_WARMUP, LM_STEPS, LM_TRACED = 4, 2048, 2, 10, 3


def _large_trainer(dev):
    from tpu_ddp_torch.models.transformer import make_transformer
    from tpu_ddp_torch.train.lm import LMTrainer, make_lm_batch
    model = make_transformer("TransformerLM-large", max_seq_len=LM_SEQ,
                             use_flash=True, remat="none")
    tr = LMTrainer(model, device=dev)
    tokens = np.random.default_rng(0).integers(
        0, model.vocab_size, size=(LM_BATCH, LM_SEQ + 1))
    return model, tr, tr.put_batch(*make_lm_batch(tokens))


def train_lm(dev, seed: int) -> dict:
    """Phase 15: the main path, ``LMTrainer`` as ``bench.py:run_lm_bench``
    drives it: TransformerLM-large, batch 4 x seq 2048, flash on,
    ``remat="none"``, bf16 compute, seed 0, one repeated batch."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_ddp_torch.utils.flops import transformer_fwd_flops
    from tpu_ddp_torch.utils.tree import tree_leaves
    model, tr, (x, y) = _large_trainer(dev)
    t0 = time.perf_counter()
    state = tr.init_state(seed=seed)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses = []
    for _ in range(LM_WARMUP):
        state, loss = tr.train_step(state, x, y)
        losses.append(float(loss))
    torch.cuda.reset_peak_memory_stats(dev)
    wrappers = _flash_wrappers()
    _zero_launches(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed_losses = []
    for _ in range(LM_STEPS):
        state, loss = tr.train_step(state, x, y)
        timed_losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launches(wrappers)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    losses += [float(v) for v in timed_losses]
    n = model.num_layers * LM_STEPS
    want = _flash_want(n, n)
    if counts != want:
        fail(f"LM launch counts {counts}, expected {want} ({LM_STEPS} "
             f"steps x {model.num_layers} layers)")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        fail(f"LM losses not finite or not falling: {losses}")
    step_s = wall / LM_STEPS
    fwd_flops = transformer_fwd_flops(model, LM_BATCH, LM_SEQ)

    # A profiler window over a few more steps: the device's idle share
    # and where its time goes.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(LM_TRACED):
            state, loss = tr.train_step(state, x, y)
        float(loss)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us = _device_us(prof)
    busy_ms = sum(dev_us.values()) / 1e3
    flash = _flash_window(prof, LM_TRACED)
    gemm = sum(v for n, v in dev_us.items()
               if re.search(r"gemm|sm90_xmma|cutlass|nvjet", n)) / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]
    # The trace slows the host far more than the card, so the window's
    # idle share overstates the untraced one; the device time per step
    # against the untraced step time gives the latter.
    window = {"steps": LM_TRACED, "wall_ms": wall_ms,
              "device_busy_ms": busy_ms,
              "device_idle_share": 1 - busy_ms / wall_ms,
              "device_ms_per_step": busy_ms / LM_TRACED,
              "untraced_idle_share": 1 - busy_ms / LM_TRACED / (step_s * 1e3),
              "flash_ms_per_step": flash["by_wrapper"],
              "flash_kernel_ms_per_step": flash["by_kernel"],
              "gemm_ms_per_step": gemm / LM_TRACED,
              "top_kernels_ms": [[k[:90], v / 1e3] for k, v in top]}

    # The previous design on the same path: the mma.sync forward forced
    # (the backward's previous design is timed alone in phase 13),
    # LM_STEPS untraced steps and LM_TRACED traced ones, in this run.
    from tpu_ddp_torch.ops import flash_attention as fa
    with _force(fa, "fwd_route", "mma_sync"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LM_STEPS):
            state, loss = tr.train_step(state, x, y)
        float(loss)
        torch.cuda.synchronize()
        old_step_s = (time.perf_counter() - t0) / LM_STEPS
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(LM_TRACED):
                state, loss = tr.train_step(state, x, y)
            float(loss)
            torch.cuda.synchronize()
    old = _flash_window(prof, LM_TRACED)
    if not (old["by_kernel"]["flash_fwd_kernel"] > 0
            and old["by_kernel"]["flash_fwd_wgmma_kernel"] == 0):
        fail(f"the forced window did not run the mma.sync forward alone: "
             f"{old}")
    mma_sync = {"ms_per_step": old_step_s * 1e3,
                "tokens_per_s": LM_BATCH * LM_SEQ / old_step_s,
                "mfu": 3 * transformer_fwd_flops(model, LM_BATCH, LM_SEQ)
                / old_step_s / BF16_FLOP_PER_S,
                "device_ms_per_step": old["device_ms_per_step"],
                "flash_ms_per_step": old["by_wrapper"]}
    return {"model": model.name, "params": sum(
        p.numel() for p in tree_leaves(state.params)), "batch": LM_BATCH,
        "seq": LM_SEQ, "setup_s": setup_s, "warmup_steps": LM_WARMUP,
        "timed_steps": LM_STEPS, "losses": losses, "launches": counts,
        "ms_per_step": step_s * 1e3,
        "tokens_per_s": LM_BATCH * LM_SEQ / step_s,
        "fwd_flops": fwd_flops,
        "mfu": 3 * fwd_flops / step_s / BF16_FLOP_PER_S,
        "peak_mem_gib": peak, "traced_window": window,
        "mma_sync_forward": mma_sync,
        "_trainer": tr, "_state": state, "_batch": (x, y)}


# The loss bound sits between the kernels' reading and the planted
# fault's, which each run checks it catches; the leaves' gradient bound
# cannot separate them (bf16 rounding through 12 layers reads about as
# high), so it holds the wiring and the fault's reading is reported. The
# gradients that do separate them are the last layer's attention-input
# gradients on that layer's own q, k, v and dO, held row by row with
# phase 13's bounds: the fault moves whole rows (the last 64 queries and
# keys), the kernels a few bf16 units per row.
LM_STEP_TOL = {"loss": 2e-4, "grad": 2e-2}


@contextlib.contextmanager
def _last_attention_inputs(fa):
    """Within the block, the flash op's first backward call's (q, k, v,
    dO, causal): the backward runs the layers last to first, so the LM's
    last layer."""
    backward, out = fa._FlashAttention.backward, {}

    def capture(ctx, do):
        if not out:
            q, k, v = (t.detach() for t in ctx.saved_tensors[:3])
            out.update(q=q, k=k, v=v, do=do.detach(), causal=ctx.causal)
        return backward(ctx, do)

    with mock.patch.object(fa._FlashAttention, "backward",
                           staticmethod(capture)):
        yield out


def _last_layer_check(fa, inputs) -> dict:
    """The three flash kernels against their plain versions on the last
    layer's q, k, v and dO from the step, row by row with phase 13's
    bounds; each gradient bound must also catch the planted fault.

    On the LM's own activations some rows of dq vanish in exact
    arithmetic (a causal layer's first query has one key, so ds = 0;
    nearly one-hot rows come close), and there both sides hold rounding
    noise alone. So a row's norm is floored at a tenth of the RMS row
    norm here, not at phase 13's thousandth."""
    q, k, v, do, causal = (inputs[n] for n in ("q", "k", "v", "do",
                                               "causal"))
    errs, reads, plain = _flash_errors(fa, q, k, v, do, causal, floor=0.1)
    faulty = _dropped_tile(q, k, v, do, plain)
    fault = {w: _readings(faulty[w], plain[w], floor=0.1)
             for w in ("dq", "dk", "dv")}
    out = {"readings": reads, "lse": errs["lse"][0],
           "tol": {w: t for w, (_, t) in errs.items()},
           "planted_fault": fault}
    print(json.dumps({"lm_last_layer": out}), flush=True)
    _fail_on(errs, "the LM step's last layer")
    for w, r in fault.items():
        if not r["row"] > errs[w][1]:
            fail(f"the LM step's last-layer {w} bound {errs[w][1]} misses "
                 f"the planted fault (it reads {r['row']})")
    return out


def lm_step_checks(dev, run: dict) -> dict:
    """Phase 16: one step's loss, gradients and update through the kernels
    against the same through the plain versions (same params, same
    batch); the same step with the planted fault in every layer's forward
    (the plain forward with a tile dropped) shows what these bounds can
    see; then one step under ``remat="blocks"``."""
    from tpu_ddp_torch.ops import flash_attention as fa
    from tpu_ddp_torch.train.lm import LMTrainer
    from tpu_ddp_torch.utils.tree import tree_leaves
    tr, state, (x, y) = run["_trainer"], run["_state"], run["_batch"]
    leaves = tree_leaves(state.params)
    with _last_attention_inputs(fa) as last:
        lk, gk = tr._loss_and_grads(leaves, state.params, x, y)
    with mock.patch.multiple(fa, flash_fwd=fa.flash_fwd_plain,
                             flash_bwd_kv=fa.flash_bwd_kv_plain,
                             flash_bwd_q=fa.flash_bwd_q_plain):
        lp, gp = tr._loss_and_grads(leaves, state.params, x, y)

    def faulty_fwd(q, k, v, causal):
        o, lse = fa.flash_fwd_plain(q, k, v, causal)
        f = _dropped_tile(q, k, v, None, {"o": o, "lse": lse})
        return f["o"], f["lse"]

    with mock.patch.multiple(fa, flash_fwd=faulty_fwd,
                             flash_bwd_kv=fa.flash_bwd_kv_plain,
                             flash_bwd_q=fa.flash_bwd_q_plain):
        lf, gf = tr._loss_and_grads(leaves, state.params, x, y)
    torch.cuda.synchronize()
    lk, lp, lf = float(lk), float(lp), float(lf)

    def frob(a, b):
        return float((a.float() - b.float()).norm()
                     / b.float().norm().clamp_min(1e-30))

    # The worst leaf's relative Frobenius error of its gradient.
    grad_k = max(frob(a, b) for a, b in zip(gk, gp))
    grad_f = max(frob(a, b) for a, b in zip(gf, gp))
    loss_k, loss_f = abs(lk - lp) / abs(lp), abs(lf - lp) / abs(lp)
    if not (math.isfinite(lk) and loss_k <= LM_STEP_TOL["loss"]):
        fail(f"LM step loss: kernels {lk} vs plain {lp} (tol "
             f"{LM_STEP_TOL['loss']} rel)")
    if not loss_f > LM_STEP_TOL["loss"]:
        fail(f"LM step loss bound {LM_STEP_TOL['loss']} misses the planted "
             f"fault (it moves the loss by {loss_f} relative)")
    if not grad_k <= LM_STEP_TOL["grad"]:
        fail(f"LM step grads: kernels vs plain, worst leaf's relative "
             f"Frobenius error {grad_k} > {LM_STEP_TOL['grad']}")
    with torch.no_grad():
        last_layer = _last_layer_check(fa, last)
    del last
    del gf
    # AdamW's update is lr * m / (sqrt(v) + eps): about +-lr wherever
    # |g| >> eps, so where a gradient is within bf16 noise of 0 the two
    # updates may take opposite signs. The params are held to 5e-2 x the
    # step's largest update where the plain gradient is above that noise
    # (5e-2 of its leaf's largest); elsewhere the share that differs is
    # reported.
    opt = tr.optimizer
    upd_largest, upd_worst, n_loose, n_all = 0.0, 0.0, 0, 0
    for i, (p, a, b) in enumerate(zip(leaves, gk, gp)):
        gmax = float(b.abs().max())
        outs = []
        for g in (a, b):
            pi = [p.detach().clone()]
            st = {"mu": [state.opt_state["mu"][i].clone()],
                  "nu": [state.opt_state["nu"][i].clone()],
                  "count": state.opt_state["count"]}
            opt.apply(pi, [g], st)
            outs.append(pi[0] - p.detach())
        upd_largest = max(upd_largest, float(outs[1].abs().max()))
        diff = (outs[0] - outs[1]).abs()
        firm = b.abs() > 5e-2 * gmax
        upd_worst = max(upd_worst, float(torch.where(firm, diff, 0).max()))
        n_loose += int(((diff > 5e-2 * opt.learning_rate) & ~firm).sum())
        n_all += p.numel()
    if not upd_worst <= 5e-2 * upd_largest:
        fail(f"LM step params: kernels vs plain max|d|={upd_worst} > 5e-2 x"
             f" largest update {upd_largest} where |g| is above noise")
    del gk, gp

    # remat="blocks": the backward recomputes each block's flash forward.
    model_b = dataclasses.replace(tr.model, remat="blocks")
    trb = LMTrainer(model_b, device=dev)
    wrappers = _flash_wrappers()
    _zero_launches(wrappers)
    lb, _ = trb._loss_and_grads(leaves, state.params, x, y)
    lb = float(lb)
    counts = _launches(wrappers)
    want = _flash_want(2 * model_b.num_layers, model_b.num_layers)
    if counts != want:
        fail(f"remat='blocks' launch counts {counts}, expected {want}")
    if not abs(lb - lk) <= 1e-5 * abs(lk):
        fail(f"remat='blocks' loss {lb} vs 'none' {lk} (tol 1e-5 rel)")
    return {"loss_kernels": lk, "loss_plain": lp, "loss_rel_diff": loss_k,
            "grad_worst_leaf_frob": grad_k, "tol": LM_STEP_TOL,
            "last_layer_attention": last_layer,
            "planted_fault": {"loss": lf, "loss_rel_diff": loss_f,
                              "grad_worst_leaf_frob": grad_f},
            "largest_update": upd_largest, "max_firm_update_diff": upd_worst,
            "update_tol": 5e-2 * upd_largest,
            "near_zero_grad_elements_beyond_5e-2_lr": n_loose,
            "elements": n_all, "remat_blocks_loss": lb,
            "remat_blocks_launches": counts}


# ---- phases 17-20: fault tolerance ------------------------------------

# Checkpoints of phases 18-20 are written here, inside the checkout (a
# directory .gitignore lists), and removed when the script ends.
CKPT_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_chip_smoke_ckpt")
VGG_STATE_BYTES = 2 * 9231114 * 4  # params and momentum, f32


def _same_bits(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def check_sgd_skip(dev, gen) -> dict:
    """Phase 17: the fused SGD kernel's ``skip`` flag on VGG-11's 34 leaves
    and the odd ``SGD_EDGE_SHAPES``: with skip 0 the bits of the plain
    version and of the unflagged kernel; with skip 1 (f32 or int32) params
    and momentum byte-identical to their inputs and the launch counted;
    the flagged kernel timed beside the unflagged one (row 5)."""
    from tpu_ddp_torch.models.vgg import get_model
    from tpu_ddp_torch.ops import sgd as tsgd
    hp = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)
    zero = torch.zeros((), device=dev)
    one = torch.ones((), device=dev)
    vgg = [p.shape for p in get_model("VGG11").parameters()]
    out = {}
    for label, shapes in (("edge", SGD_EDGE_SHAPES), ("vgg11", vgg)):
        p0 = [torch.randn(s, generator=gen, device=dev) * 0.05
              for s in shapes]
        grads = [torch.randn(s, generator=gen, device=dev) * 1e-2
                 for s in shapes]
        b0 = [torch.randn(s, generator=gen, device=dev) * 1e-3
              for s in shapes]
        runs = {}
        for name, fn, skip in (("flag0", tsgd.fused_sgd_step, zero),
                               ("unflagged", tsgd.fused_sgd_step, None),
                               ("plain", tsgd.fused_sgd_step_ref, None)):
            p, b = [t.clone() for t in p0], [t.clone() for t in b0]
            fn(p, grads, b, skip=skip, **hp)
            runs[name] = p + b
        torch.cuda.synchronize()
        for name in ("unflagged", "plain"):
            if not all(_same_bits(a, c) for a, c in zip(runs["flag0"],
                                                        runs[name])):
                fail(f"sgd with skip=0 differs from the {name} update on "
                     f"{label} leaves (must be bit for bit equal)")
        for skip in (one, torch.ones((), dtype=torch.int32, device=dev)):
            p, b = [t.clone() for t in p0], [t.clone() for t in b0]
            n0 = tsgd.fused_sgd_step.launches
            tsgd.fused_sgd_step(p, grads, b, skip=skip, **hp)
            torch.cuda.synchronize()
            if tsgd.fused_sgd_step.launches != n0 + math.ceil(
                    len(shapes) / 80):
                fail("a skipped sgd launch was not counted")
            if not all(_same_bits(a, c) for a, c in zip(p + b, p0 + b0)):
                fail(f"sgd with skip={skip.item()} changed {label} params "
                     f"or momentum (must leave them byte-identical)")
        out[label] = {"leaves": len(shapes), "skip0_bitwise": True,
                      "skip1_unchanged": True}
    p, b = [t.clone() for t in p0], [t.clone() for t in b0]
    flagged = timed(lambda: tsgd.fused_sgd_step(p, grads, b, skip=zero,
                                                **hp), [()], 50)
    unflagged = timed(lambda: tsgd.fused_sgd_step(p, grads, b, **hp),
                      [()], 50)
    skipped = timed(lambda: tsgd.fused_sgd_step(p, grads, b, skip=one,
                                                **hp), [()], 50)
    n = sum(math.prod(s) for s in vgg)
    bound, by = _bound(20 * n + 4, 5 * n)
    out.update(flagged_ms=flagged["ms"], unflagged_ms=unflagged["ms"],
               skipped_ms=skipped["ms"], flagged_event_ms=flagged["event_ms"],
               bound_ms=bound, bound_by=by,
               timing=_timing_label(flagged, unflagged, skipped))
    return out


@contextlib.contextmanager
def _env(**kv):
    """Set (value) or unset (None) env variables for the block."""
    old = {k: os.environ.get(k) for k in kv}
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def _deterministic_cudnn():
    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = old


# The ladder's knobs for phases 18-19: vgg11_cifar10 as published, both
# kernels, the synthetic stand-in of phase 10; no fault unless a run sets
# one.
VGG_ENV = dict(TPU_DDP_PALLAS_SGD="1", TPU_DDP_PALLAS_BN="1",
               TPU_DDP_SYNTH_SIZE=str(SYNTH_SIZE), TPU_DDP_GLOBAL_BATCH=None,
               TPU_DDP_COMPUTE_DTYPE=None, TPU_DDP_LR=None,
               TPU_DDP_CKPT_EVERY=None, TPU_DDP_CHAOS_FAULTS=None,
               TPU_DDP_CHAOS_SENTINEL=None, TPU_DDP_GUARD=None,
               TPU_DDP_GUARD_MAX_BAD=None, TPU_DDP_CUDNN_DETERMINISTIC=None)


def _part1(dev, argv, **env) -> str:
    """``run_part("part1")`` on the card under VGG_ENV and ``env``; fails
    unless it returns 0 and prints a finite ``Test set:`` line."""
    with _env(**{**VGG_ENV, **env}):
        rc, out, _ = _run_part_captured("part1", ["--device", str(dev),
                                                  *argv])
    test = re.search(r"Test set: average loss (\S+),", out)
    if rc != 0 or test is None or not math.isfinite(float(test.group(1))):
        fail(f"part1 {argv} {env}: rc {rc}, no finite 'Test set:' line")
    return out


def _timer_ms(out: str) -> float:
    m = re.search(r"timing over iterations 1-39: total \d+ ns, average "
                  r"(\d+) ns", out)
    if m is None:
        fail("part1 printed no timer line")
    return int(m.group(1)) / 1e6


def _step_digests(directory, step) -> dict:
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)["digests"]


def _state_digests(trainer, state) -> dict:
    """sha256 per leaf of params and momentum (the step left out)."""
    from tpu_ddp_torch.resilience.integrity import leaf_digest
    from tpu_ddp_torch.utils.tree import keyed_leaves
    host = trainer.state_to_host(state)
    host.pop("step")
    return {k: leaf_digest(v) for k, v in keyed_leaves(host)}


def vgg_resilience(dev) -> dict:
    """Phase 18: checkpoints, mid-epoch resume and the guard on VGG-11 at
    batch 256 with both kernels, cuDNN deterministic for 1-4."""
    from tpu_ddp_torch.data.loader import create_data_loaders
    from tpu_ddp_torch.models.vgg import get_model
    from tpu_ddp_torch.resilience.guard import TrainingDivergedError
    from tpu_ddp_torch.train.engine import Trainer
    from tpu_ddp_torch.utils import checkpoint as ckpt
    from tpu_ddp_torch.utils.config import TrainConfig
    root = os.path.join(CKPT_ROOT, "vgg")
    res = {}
    with _deterministic_cudnn(), _env(**VGG_ENV):
        # 1. 40 iterations straight, against 20 and 20 more resumed.
        a, b = os.path.join(root, "straight"), os.path.join(root, "resumed")
        out = _part1(dev, ["--ckpt-dir", a], TPU_DDP_MAX_ITERS=40,
                     TPU_DDP_CKPT_EVERY=20)
        res["deterministic_iter_ms"] = _timer_ms(out)
        _part1(dev, ["--ckpt-dir", b], TPU_DDP_MAX_ITERS=20,
               TPU_DDP_CKPT_EVERY=20)
        out = _part1(dev, ["--ckpt-dir", b, "--resume"], TPU_DDP_MAX_ITERS=40,
                     TPU_DDP_CKPT_EVERY=20)
        if f"resumed from {b} at step 20 (epoch 0, iter 20)" not in out:
            fail("phase 18: the resumed run did not pick up at step 20")
        want = _step_digests(a, 40)
        got = _step_digests(b, 40)
        if got != want or ckpt.all_steps(a) != [20, 40]:
            bad = sorted(k for k in want if got.get(k) != want[k])
            fail(f"phase 18: resumed VGG-11 differs from the straight run "
                 f"at step 40 on {len(bad)} leaves: {bad[:4]}")
        res["resume"] = {"leaves": len(want), "bitwise_equal": True}

        # 2. nan-grad@25: one step skipped, the state unchanged by it.
        cfg = TrainConfig.preset("vgg11_cifar10")
        train, _ = create_data_loaders(batch_size=256,
                                       synthetic_size=SYNTH_SIZE,
                                       seed=cfg.seed)
        cfg.pallas_sgd = cfg.pallas_bn = True
        model = get_model(cfg.model, use_pallas_bn=True,
                          compute_dtype=getattr(torch, cfg.compute_dtype))
        tr = Trainer(model, cfg, device=dev)
        state = tr.init_state()
        lines = []
        with _env(TPU_DDP_CHAOS_FAULTS="nan-grad@25"):
            losses = []
            for start, stop in ((0, 24), (24, 25), (25, 26)):
                tr.config.max_iters = stop
                if stop == 25:
                    before = _state_digests(tr, state)
                state, stats = tr.train_epoch(state, train, start_iter=start,
                                              log=lines.append)
                losses.append(stats["last_loss"])
                if stop == 25:
                    after = _state_digests(tr, state)
        skipped = [e["step"] for e in tr.metrics.events
                   if e["event"] == "step_skipped"]
        if skipped != [25] or tr.guard.total_skipped != 1 \
                or state.step != 26:
            fail(f"phase 18: nan-grad@25 skipped steps {skipped}, "
                 f"state at step {state.step}")
        if before != after:
            fail("phase 18: the skipped step 25 changed params or momentum")
        if not math.isfinite(losses[2]):
            fail(f"phase 18: the loss at step 26 is {losses[2]} (expected "
                 f"finite again after the skipped step)")
        # The loss of the poisoned step is reported, not held: the BN
        # kernels clamp a NaN variance to 0 and their ReLU maps NaN to 0,
        # so the card's forward can read finite where the plain version's
        # is NaN; the gradients are NaN either way, and the guard reads
        # both.
        res["nan_grad"] = {"skipped_steps": skipped,
                           "state_unchanged": True,
                           "loss_step_25": str(losses[1]),
                           "loss_step_26": losses[2]}

        # 3. nan-grad on every step: TrainingDivergedError at the third.
        with _env(TPU_DDP_CHAOS_FAULTS="nan-grad@p1.0",
                  TPU_DDP_GUARD_MAX_BAD="3"):
            cfg3 = TrainConfig.preset("vgg11_cifar10")
            cfg3.pallas_sgd = cfg3.pallas_bn = True
            tr3 = Trainer(model, cfg3, device=dev)
            state3 = tr3.init_state()
            d0 = _state_digests(tr3, state3)
            try:
                tr3.train_epoch(state3, train, log=lines.append)
                fail("phase 18: nan-grad@p1.0 did not raise "
                     "TrainingDivergedError")
            except TrainingDivergedError as e:
                diverged = str(e)
        if tr3.guard.last_step != 3 or _state_digests(tr3, state3) != d0:
            fail(f"phase 18: TrainingDivergedError at step "
                 f"{tr3.guard.last_step} (expected 3), or skipped steps "
                 f"changed the state")
        res["diverged"] = {"at_step": tr3.guard.last_step,
                           "message": diverged}
        del tr, tr3, state, state3

        # 4. corrupt-ckpt: the newest is quarantined, the previous used.
        c = os.path.join(root, "corrupt")
        _part1(dev, ["--ckpt-dir", c], TPU_DDP_MAX_ITERS=20,
               TPU_DDP_CKPT_EVERY=10,
               TPU_DDP_CHAOS_FAULTS="corrupt-ckpt@20")
        out = _part1(dev, ["--ckpt-dir", c, "--resume"], TPU_DDP_MAX_ITERS=20,
                     TPU_DDP_CKPT_EVERY=10)
        if "[ckpt] step 20 failed verification" not in out \
                or f"resumed from {c} at step 10" not in out \
                or not os.path.isdir(os.path.join(c, "step_00000020"
                                                     ".corrupt")):
            fail("phase 18: the corrupt step-20 checkpoint was not "
                 "quarantined with step 10 restored")
        res["corrupt_ckpt"] = {"quarantined": "step_00000020.corrupt",
                               "restored_step": 10}

    # 5. VGG-11 iteration time, guard on (the default) and off, in turns.
    times = {"on": [], "off": []}
    for guard in ("on", "off", "off", "on", "on", "off"):
        out = _part1(dev, [], TPU_DDP_MAX_ITERS=40,
                     TPU_DDP_GUARD=None if guard == "on" else "0")
        times[guard].append(_timer_ms(out))
    res["iter_ms"] = {k: sum(v) / len(v) for k, v in times.items()}
    res["iter_ms_runs"] = times
    res["guard_costs"] = _guard_costs(dev)

    # Save and verified restore of the 74 MB VGG-11 state, alone.
    cfg = TrainConfig.preset("vgg11_cifar10")
    model = get_model(cfg.model, use_pallas_bn=cfg.pallas_bn,
                      compute_dtype=getattr(torch, cfg.compute_dtype))
    tr = Trainer(model, cfg, device=dev)
    state = tr.init_state()
    d = os.path.join(root, "timing")
    save_s, restore_s = [], []
    for rep in range(3):
        state.step = rep + 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.save_checkpoint(d, state)
        save_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        back = tr.restore_checkpoint(d)
        torch.cuda.synchronize()
        restore_s.append(time.perf_counter() - t0)
        if back.step != rep + 1:
            fail("phase 18: the timed restore read the wrong step")
    nbytes = os.path.getsize(os.path.join(d, "step_00000003",
                                          "arrays.npz"))
    res["ckpt_io"] = {"bytes": nbytes, "save_s": min(save_s),
                      "restore_s": min(restore_s),
                      "save_gb_per_s": nbytes / min(save_s) / 1e9,
                      "restore_gb_per_s": nbytes / min(restore_s) / 1e9,
                      "save_s_runs": save_s, "restore_s_runs": restore_s}
    res["_straight_digests"] = want
    return res


def _guard_costs(dev) -> dict:
    """Where the guard's time goes on VGG-11 at batch 256: one trainer's
    step with the guard on and off in turns (synchronized per step, the
    timer's protocol, batches already on the card), the same trainer's
    epoch loop on and off in turns, the host time of ``nonfinite_flag``
    over the 34 gradients and of the one ``[loss, skipped]`` read against
    ``float(loss)``, and the flag's device time."""
    import itertools

    from tpu_ddp_torch.data.loader import create_data_loaders
    from tpu_ddp_torch.models.vgg import get_model
    from tpu_ddp_torch.resilience.guard import nonfinite_flag
    from tpu_ddp_torch.train.engine import Trainer
    from tpu_ddp_torch.utils.config import TrainConfig
    cfg = TrainConfig.preset("vgg11_cifar10")
    cfg.pallas_sgd = cfg.pallas_bn = True
    model = get_model(cfg.model, use_pallas_bn=True,
                      compute_dtype=getattr(torch, cfg.compute_dtype))
    tr = Trainer(model, cfg, device=dev)
    state = tr.init_state()
    train, _ = create_data_loaders(batch_size=256, synthetic_size=2560)
    batches = [(x.to(dev), y.to(dev))
               for x, y in itertools.islice(iter(train), 4)]
    guard = tr.guard
    step_ms = {"on": [], "off": []}
    for mode in ("on", "off", "off", "on"):
        tr.guard = guard if mode == "on" else None
        for i in range(20):
            x, y = batches[i % 4]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss, fused = tr._step(state, x, y)
            torch.cuda.synchronize()
            (fused.tolist() if fused is not None else float(loss))
            step_ms[mode].append((time.perf_counter() - t0) * 1e3)
    # The same trainer's epoch loop (the timer over iterations 1-39),
    # 40 iterations per epoch, the guard on and off in turns.
    epoch_ms = {"on": [], "off": []}
    tr.config.max_iters = TRAIN_ITERS
    train40, _ = create_data_loaders(batch_size=256,
                                     synthetic_size=SYNTH_SIZE)
    for mode in ("on", "off", "off", "on"):
        tr.guard = guard if mode == "on" else None
        state, stats = tr.train_epoch(state, train40, log=lambda _: None)
        epoch_ms[mode].append(stats["avg_iter_s"] * 1e3)
    tr.guard = guard
    grads = [p.grad for p in state.params]

    def host_us(fn, reps=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e6

    flag = nonfinite_flag(loss, grads)
    out = {
        "step_ms_median": {k: sorted(v)[len(v) // 2]
                           for k, v in step_ms.items()},
        "epoch_iter_ms": epoch_ms,
        "flag_host_us": host_us(lambda: nonfinite_flag(loss, grads)),
        "flag_device_ms": timed(lambda: nonfinite_flag(loss, grads),
                                [()], 50)["ms"],
        "read_fused_us": host_us(
            lambda: torch.stack([loss.float(), flag]).tolist()),
        "read_loss_us": host_us(lambda: float(loss)),
    }
    del tr, state, grads
    return out


LAUNCH_TIMEOUT_S = 600


def launcher_drill(dev, straight: dict) -> dict:
    """Phase 19: ``python -m tpu_ddp_torch.launch part1 --nproc 1
    --max-restarts 1 --ckpt-dir D`` on the card, a chaos hard-exit at step
    30, 40 iterations, cuDNN deterministic: one restart, the resume at
    step 20, a finished run, and the step-40 checkpoint equal to phase
    18's straight run."""
    d = os.path.join(CKPT_ROOT, "launch")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPU_DDP_")}
    env.update({k: v for k, v in VGG_ENV.items() if v is not None})
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
    env.update(TPU_DDP_MAX_ITERS="40", TPU_DDP_CKPT_EVERY="20",
               TPU_DDP_CHAOS_FAULTS="hard-exit@30",
               TPU_DDP_CHAOS_SENTINEL=os.path.join(CKPT_ROOT, "sentinel"),
               TPU_DDP_CUDNN_DETERMINISTIC="1")
    t0 = time.perf_counter()
    # A process group of its own, so a launcher past its time is stopped
    # with the workers it spawned.
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_ddp_torch.launch", "part1", "--nproc",
         "1", "--max-restarts", "1", "--ckpt-dir", d], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        fail(f"phase 19: the launcher ran past {LAUNCH_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    losses = [(int(i), float(v)) for i, v in
              re.findall(r"\[epoch 0, iter (\d+)\] loss: (\S+)", out)]
    checks = {
        "exit 0": proc.returncode == 0,
        "one restart": out.count("[launch] attempt failed (rc=13); "
                                 "restart 1") == 1
        and "restart 2" not in out,
        "fault at step 30": "injecting hard-exit at step 30" in out,
        "resume at step 20": f"resumed from {d} at step 20 (epoch 0, "
                             "iter 20)" in out,
        "finished": "Test set: average loss" in out
        and "[launch] recovered after 1 restart(s)" in out,
        "finite losses": [i for i, _ in losses] == [20, 40]
        and all(math.isfinite(v) for _, v in losses),
    }
    if not all(checks.values()):
        fail(f"phase 19: {[k for k, v in checks.items() if not v]} "
             f"failed; rc {proc.returncode}; output tail:\n{out[-3000:]}\n"
             f"{err[-2000:]}")
    got = _step_digests(d, 40)
    if got != straight:
        bad = sorted(k for k in straight if got.get(k) != straight[k])
        fail(f"phase 19: the restarted run's step-40 state differs from "
             f"phase 18's straight run on {len(bad)} leaves: {bad[:4]}")
    return {"restarts": 1, "losses": losses, "wall_s": wall,
            "bitwise_equal_to_straight_run": True}


def lm_checkpoint(dev, run: dict) -> dict:
    """Phase 20: TransformerLM-large with its AdamW state after phase 15's
    steps saved (f32 params, mu and nu), restored into a fresh
    ``LMTrainer`` after the first is freed, and the next step's loss
    compared bit for bit."""
    import gc
    import shutil

    from tpu_ddp_torch.utils.tree import tree_leaves
    tr, state, (x, y) = (run.pop("_trainer"), run.pop("_state"),
                         run.pop("_batch"))
    n = sum(p.numel() for p in tree_leaves(state.params))
    need = 3 * n * 4
    os.makedirs(CKPT_ROOT, exist_ok=True)
    free = shutil.disk_usage(CKPT_ROOT).free
    if free < 2 * need:
        fail(f"phase 20: {free / 1e9:.1f} GB free under {CKPT_ROOT}, "
             f"under twice the {need / 1e9:.1f} GB checkpoint")
    d = os.path.join(CKPT_ROOT, "lm")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = tr.save_checkpoint(d, state)
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(os.path.join(path, "arrays.npz"))
    step = state.step
    state, l1 = tr.train_step(state, x, y)
    state, l2 = tr.train_step(state, x, y)
    want = (l1.clone(), l2.clone())
    torch.cuda.synchronize()
    del tr, state, l1, l2
    gc.collect()
    torch.cuda.empty_cache()
    _, tr2, _ = _large_trainer(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state2 = tr2.restore_checkpoint(d)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if state2.step != step:
        fail(f"phase 20: restored step {state2.step}, saved {step}")
    state2, m1 = tr2.train_step(state2, x, y)
    state2, m2 = tr2.train_step(state2, x, y)
    torch.cuda.synchronize()
    if not _same_bits(m1.float().reshape(1), want[0].float().reshape(1)):
        fail(f"phase 20: the restored trainer's next loss {float(m1)!r} "
             f"differs from the original's {float(want[0])!r}")
    out = {"params": n, "bytes": nbytes, "step": step,
           "save_s": save_s, "restore_s": restore_s,
           "save_gb_per_s": nbytes / save_s / 1e9,
           "restore_gb_per_s": nbytes / restore_s / 1e9,
           "next_loss": float(m1), "next_loss_bitwise_equal": True,
           "second_loss": float(m2),
           "second_loss_bitwise_equal": _same_bits(
               m2.float().reshape(1), want[1].float().reshape(1)),
           "disk_free_gb": free / 1e9}
    del tr2, state2
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(d, ignore_errors=True)
    return out


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
    phase_s = {}

    def phase(label, fn, *a):
        """Run one phase and keep its seconds."""
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[label] = time.perf_counter() - t0
        return out

    build = phase("2_build", build_all)
    print(json.dumps({"build": build}), flush=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    int8 = phase("3_int8", check_kernel, dev, gen)
    rows = int8["shapes"]
    parity = phase("4_small_parity", small_parity, dev)
    print(json.dumps({"small_parity": parity}), flush=True)
    serve = phase("5-6_serve", serve_large, dev, args.seed)
    print(json.dumps({"serve": serve}), flush=True)

    bn = phase("7_bn_relu", check_bn, dev, gen)
    print(json.dumps({"bn_relu": {k: v for k, v in bn.items()
                                  if k != "shapes"}}), flush=True)
    sgd = phase("8_sgd", check_sgd, dev, gen)
    print(json.dumps({"sgd": sgd}), flush=True)
    tparity = phase("9_train_small_parity", train_parity, dev)
    print(json.dumps({"train_small_parity": tparity}), flush=True)
    train = phase("10_train", train_part1, dev)
    print(json.dumps({"train": train}), flush=True)
    step = phase("10-11_train_step", train_step_checks, dev)
    print(json.dumps({"train_step": step}), flush=True)
    ddp = phase("12_part3_nccl", part3_nccl, dev)
    print(json.dumps({"part3_nccl": ddp}), flush=True)

    flash = phase("13_flash", check_flash, dev, gen)
    print(json.dumps({"flash": flash}), flush=True)
    lparity = phase("14_lm_small_parity", lm_parity, dev)
    print(json.dumps({"lm_small_parity": lparity}), flush=True)
    lm = phase("15_lm_train", train_lm, dev, args.seed)
    lm_step = phase("16_lm_step", lm_step_checks, dev, lm)
    print(json.dumps({"lm_train": {k: v for k, v in lm.items()
                                   if not k.startswith("_")}}), flush=True)
    print(json.dumps({"lm_step": lm_step}), flush=True)

    sgd_skip = phase("17_sgd_skip", check_sgd_skip, dev, gen)
    print(json.dumps({"sgd_skip": sgd_skip}), flush=True)
    try:
        resil = phase("18_vgg_resilience", vgg_resilience, dev)
        straight = resil.pop("_straight_digests")
        print(json.dumps({"vgg_resilience": resil}), flush=True)
        drill = phase("19_launcher", launcher_drill, dev, straight)
        print(json.dumps({"launcher": drill}), flush=True)
        lm_ckpt = phase("20_lm_checkpoint", lm_checkpoint, dev, lm)
        print(json.dumps({"lm_checkpoint": lm_ckpt}), flush=True)
    finally:
        import shutil
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    lm = {k: v for k, v in lm.items() if not k.startswith("_")}
    print(json.dumps({"phase_seconds": phase_s}), flush=True)

    def per_pass(m, key):
        return sum(r[key] * r["per_pass"] for r in rows if r["m"] == m)

    t_bytes = per_pass(8, "bytes") / HBM_BYTES_PER_S * 1e3
    t_ops = sum(2 * 8 * r["k"] * r["n"] * r["per_pass"] for r in rows
                if r["m"] == 8) / BF16_FLOP_PER_S * 1e3
    def ptxas(pattern):
        """(max registers, total spill bytes) of the kernels whose
        mangled name holds ``pattern``."""
        ptx = [r for kn, r in build["ptxas_by_kernel"].items()
               if pattern in kn]
        return (max((r["registers"] for r in ptx), default=None),
                sum(r["spill_bytes"] for r in ptx) if ptx else None)

    def main_path(window):
        return window["int8_ms_per_decode_step"]

    regs, spills = ptxas(INT8_KERNELS["mma"])
    kernels = [{
        "name": "int8_matmul",
        "route": "cuda",
        "source": "tpu_ddp_torch/ops/csrc/int8_matmul.cu",
        "replaces": "tpu_ddp/ops/pallas/quant_matmul.py:83",
        # Launches on the mma route (the simt route's beside it).
        "launches": serve["launches"]["mma"],
        "simt_launches": serve["launches"]["simt"],
        "kernel_route": "mma",
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # Times and bound: one decode step's 49 launches at M = 8, alone;
        # main_path_ms: the int8 kernels' device time per decode step in
        # phase 5's traced window. "was": the simt route (the previous
        # design), alone and in a second traced window of this run.
        "ms": per_pass(8, "ms"),
        "main_path_ms": main_path(serve["traced_window"]),
        "was_ms": per_pass(8, "simt_ms"),
        "was_main_path_ms": main_path(serve["traced_window_simt"]),
        "plain_ms": per_pass(8, "plain_ms"),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": per_pass(8, "library_ms"),
        "event_ms": per_pass(8, "event_ms"),
        "timing": ",".join(sorted({r["timing"] for r in rows})),
        "prefill_chunk_ms": per_pass(32, "ms"),
        "prefill_chunk_was_ms": per_pass(32, "simt_ms"),
        "prefill_chunk_library_ms": per_pass(32, "library_ms"),
        "registers": regs, "spill_bytes": spills,
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
        # Phase 17: the step guard's gated launch (skip pointer read as
        # 0: the main path's launch), and one that skips (flag 1), beside
        # the ungated launch, timed together.
        "flagged_ms": sgd_skip["flagged_ms"],
        "skipped_ms": sgd_skip["skipped_ms"],
        "unflagged_ms": sgd_skip["unflagged_ms"],
    }]
    replaces = {"bn_stats": 139, "bn_norm_relu": 151, "bn_bwd_stats": 207,
                "bn_bwd_dx": 218}
    for name, line in replaces.items():
        k = bn["kernels"][name]
        row = {
            "name": name,
            "route": "cuda",
            "source": "tpu_ddp_torch/ops/csrc/bn_relu.cu",
            "replaces": f"tpu_ddp/ops/pallas/bn_relu.py:{line}",
            "launches": train["launches"][name],
            # Times and bound: one train step's 8 calls at batch 256, alone;
            # main_path_ms: the wrapper's device time per step in phase
            # 10's traced window.
            **{key: k[key] for key in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "event_ms", "timing")},
            "main_path_ms": step["traced_window"][
                "ported_kernels_ms_per_step"][name],
        }
        if name in ("bn_stats", "bn_bwd_stats"):
            # Launches on the one-pass route (the two-stage route's beside
            # it); "was": the two-stage route forced, alone, this run.
            regs, spills = ptxas(f"{name}_onepass_kernel")
            row.update(
                launches=train["launches"][name]["one_pass"],
                two_stage_launches=train["launches"][name]["two_stage"],
                kernel_route="one_pass", was_ms=k["was_ms"],
                registers=regs, spill_bytes=spills)
        if name == "bn_stats":
            row.update(library_var_mean_ms=k["library_var_mean_ms"],
                       read_all_ms=k["read_all_ms"])
        kernels.append(row)
    replaces = {"flash_fwd": ("fwd", 193), "flash_bwd_kv": ("bwd_kv", 334),
                "flash_bwd_q": ("bwd_q", 357)}
    for name, (key, line) in replaces.items():
        k = flash["kernels"][key]
        row = {
            "name": name,
            "route": "cuda",
            "source": "tpu_ddp_torch/ops/csrc/flash_attention.cu",
            "replaces": f"tpu_ddp/ops/pallas/flash_attention.py:{line}",
            "launches": lm["launches"][name],
            # Times and bound: one LM-large train step's 12 calls at
            # (4, 2048, 16, 128) bf16, causal; the library call is SDPA's
            # flash backend, forward for flash_fwd and its backward (dq,
            # dk and dv together) for the two sweeps. main_path_ms: the
            # kernel's device time per step in phase 15's traced steps.
            **{key_: k[key_] for key_ in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms", "event_ms",
                                          "timing")},
            "main_path_ms": lm["traced_window"]["flash_ms_per_step"][name],
        }
        # The kernel's launches on its wgmma route; the previous design
        # (the mma.sync kernel) beside it, timed in this run alone (phase
        # 13) and, for the forward, on the same path (phase 15's forced
        # window).
        regs, spills = ptxas(f"{name}_wgmma_kernel")
        row.update(
            launches=lm["launches"][name]["wgmma"],
            mma_sync_launches=lm["launches"][name]["mma_sync"],
            kernel_route=k["kernel_route"],
            was_ms=k["mma_sync_ms"],
            registers=regs, spill_bytes=spills)
        if name == "flash_fwd":
            row["was_main_path_ms"] = lm["mma_sync_forward"][
                "flash_ms_per_step"][name]
        kernels.append(row)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "build": build, "int8": int8,
                       "small_parity": parity, "serve": serve,
                       "bn_relu": bn, "sgd": sgd,
                       "train_small_parity": tparity, "train": train,
                       "train_step": step, "part3_nccl": ddp,
                       "flash": flash, "lm_small_parity": lparity,
                       "lm_train": lm, "lm_step": lm_step,
                       "sgd_skip": sgd_skip, "vgg_resilience": resil,
                       "launcher": drill, "lm_checkpoint": lm_ckpt,
                       "phase_seconds": phase_s,
                       "kernels": kernels}, fh, indent=1)
    print(f"serve: TTFT median {serve['ttft_ms_median']:.1f} ms, max "
          f"{serve['ttft_ms_max']:.1f} ms; {serve['tokens_per_s']:.1f} "
          f"tokens/s over {serve['requests']} requests", flush=True)
    print(f"train: VGG-11 batch 256, {train['avg_iter_ms']:.2f} ms/iter "
          f"over iterations 1-39, {train['images_per_s']:.0f} images/s, "
          f"peak {train['peak_mem_gib']:.2f} GiB; device idle "
          f"{100 * step['traced_window']['device_idle_share']:.1f}% of a "
          f"traced 5-step window", flush=True)
    print(f"lm: TransformerLM-large batch {lm['batch']} x seq {lm['seq']}, "
          f"{lm['ms_per_step']:.1f} ms/step, {lm['tokens_per_s']:.0f} "
          f"tokens/s, MFU {100 * lm['mfu']:.1f}%, peak "
          f"{lm['peak_mem_gib']:.2f} GiB; device idle "
          f"{100 * lm['traced_window']['untraced_idle_share']:.1f}% "
          f"untraced, {100 * lm['traced_window']['device_idle_share']:.1f}% "
          f"of a traced {LM_TRACED}-step window", flush=True)
    ck = resil["ckpt_io"]
    print(f"resilience: VGG-11 {resil['iter_ms']['on']:.2f} ms/iter with "
          f"the guard on, {resil['iter_ms']['off']:.2f} off; checkpoint "
          f"save {ck['save_gb_per_s']:.2f} GB/s, verified restore "
          f"{ck['restore_gb_per_s']:.2f} GB/s ({ck['bytes'] / 1e6:.1f} MB); "
          f"LM-large save {lm_ckpt['save_gb_per_s']:.2f} GB/s, restore "
          f"{lm_ckpt['restore_gb_per_s']:.2f} GB/s "
          f"({lm_ckpt['bytes'] / 1e9:.2f} GB); launcher drill "
          f"{drill['wall_s']:.1f} s", flush=True)
    print(f"{card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
