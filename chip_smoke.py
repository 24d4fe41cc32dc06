#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (tpu_ddp_torch): the quickest
proof that the port builds and serves on the card.

    python3 chip_smoke.py [--seed N] [--out results.json]

Phases, each fatal on failure (exit code 1, no result line):

1. refuse to run without CUDA;
2. build every kernel of the serving path from ``tpu_ddp_torch/ops/csrc``
   with nvcc (one process per source, all started together);
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
   f32 sum can move a bf16 activation by one unit, 2**-8 relative).

Prints the card's name and power limit, the serving metrics, one
``{"kernels": [...]}`` line, and last the contract line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

# H100 SXM published peaks (dense): HBM3 bytes/s and bf16 tensor-core
# FLOP/s. The int8 weights are exact in bf16, so bf16 is the fastest
# type the same products could run in.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

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
    }]
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "build": build, "shapes": rows,
                       "small_parity": parity, "serve": serve,
                       "kernels": kernels}, fh, indent=1)
    print(f"serve: TTFT median {serve['ttft_ms_median']:.1f} ms, max "
          f"{serve['ttft_ms_max']:.1f} ms; {serve['tokens_per_s']:.1f} "
          f"tokens/s over {serve['requests']} requests", flush=True)
    print(f"{card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
