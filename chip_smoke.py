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
   Inputs holding NaN (whole NaN rows of x; scattered NaN elements of x
   and g) at a VGG-11 shape and two edge shapes, on both routes of the
   reductions: every output NaN exactly where the plain version's is and
   within the bounds above elsewhere.
   The two reductions run their one-pass route (``stats_route``) and,
   forced, their two-stage route (the previous design), and dx its
   one-wave route (``dx_route``) and, forced, the row-blocks kernel (the
   previous design), all held to the same bounds; at each VGG-11 shape
   two one-pass launches, and a third
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
   (both counted). Kernel 9's two designs and ``batch_norm_backward_elemt``
   are timed in turns, five rounds of one trace each on the same cycled
   copies: the median and spread per VGG-11 step;
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
   deterministic mode (no autotuning) for steps 1-4 only, on 5,120
   synthetic images: (1) 20 iterations straight, against 10 with
   ``TPU_DDP_CKPT_EVERY=10`` and 10 more resumed with ``--resume`` in a
   fresh ``Trainer``: the step-20 checkpoints' sha256 digests equal leaf
   for leaf; (2) ``nan-grad@13``: exactly step 13 skipped, its loss NaN
   (as on the CPU), params and momentum digests equal before and after
   it, the loss finite again at step 14; (3) ``nan-grad@p1.0`` with
   ``TPU_DDP_GUARD_MAX_BAD=3``: ``TrainingDivergedError`` at step 3, the
   state unchanged; (4) ``corrupt-ckpt@20``: the newest checkpoint
   quarantined to ``step_00000020.corrupt`` and step 10 restored by the
   next ``--resume``; (5) the iteration time (1-39) of one trainer's
   epochs with the guard on (the default) and off, and the save and
   verified-restore times of the 74 MB state;
19. the restarting launcher on the card: ``python -m tpu_ddp_torch.launch
   part1 --nproc 1 --max-restarts 1 --ckpt-dir D`` with a chaos
   ``hard-exit@15``, a sentinel directory, 20 iterations on 5,120
   images, checkpoints every 10 and ``TPU_DDP_CUDNN_DETERMINISTIC=1``:
   exactly one restart, the second attempt resumes at step 10, the run
   exits 0 and prints ``Test set:``, every logged loss is finite, and the
   step-20 checkpoint equals phase 18's straight run digest for digest;
20. the LM trainer's checkpoint at full width: TransformerLM-large
   (735,154,176 params) with its AdamW state after phase 15's steps is
   saved (8.8 GB: f32 params, mu and nu; free disk checked first, at
   least twice that) and, after the first trainer is freed, restored
   into a fresh ``LMTrainer``: the next step's loss bit-identical to the
   original trainer's next step on the same batch; save and restore
   seconds and GB/s; the checkpoint and a host copy of its params stay
   for phase 25.

Phases 21-26 serve TransformerLM-large at full width and depth (seed
weights, ``decode_quant="int8"`` unless a phase says otherwise) through
``ServeEngine.submit/step/run``; each path's int8 launches are counted
from 0 just before it and must equal what the engine's own pass counters
give (49 per prefill chunk and per target pass, 4j + 1 per pass of a
j-block int8 draft), all on the mma route:

21. speculation on phase 5's 8 requests at k=0, ``chain`` at k=4 (the
   stream equal to k=0 bit for bit, tokens and logprobs), ``self-2`` at
   k=4 on the int8 target and ``quant`` at k=4 against an fp bf16 k=0
   stream (each bit for bit, or else greedy tokens may part only where
   the k=0 top-2 logit gap is at most 1e-2, the first divergent position
   and gap reported); the pool's refcount identity after every step; a
   planted fault in the accept rule (one more proposal accepted than
   ``accept_length`` gives) must change the stream; acceptance, tokens
   per engine step and tokens/s per family;
22. the prefix cache: after a request carrying a 256-token system prompt
   runs to completion, 8 requests of that prompt plus tails of 32-256
   tokens (``make_shared_prefix_workload``, 32 new each) must each hit
   exactly 16 blocks, save 8 x 8 prefill chunks and give the uncached
   run's streams bit for bit; with a 200-token system prompt, a request
   whose prompt is exactly the 12 cached blocks takes the copy-on-write
   block: greedy tokens equal (a divergence only at a top-2 gap of at
   most 1e-2) and logprobs within 0.1 over the agreeing positions;
23. tenants ``gold=3,bronze=1,batch=1:1`` (weight, queue deadline ms),
   queue limit 20, 24 requests submitted at once into 8 slots: 4 shed at
   the door (never gold), every ``batch`` request shed by its 1 ms
   deadline, the admission order equal to stride scheduling's over the
   queue, completed + cancelled + shed == submitted per tenant after
   every step; TTFT per tenant;
24. ``make_long_prompt_workload``: 4 requests of 1536 prompt tokens and
   16 new through the single-tier pool, through ``kv_tiers=2`` with bf16
   cold pages and 2 hot pages (bit for bit equal to the single tier,
   most of the live context cold) and through ``kv_tiers=3`` with int8
   cold pages and 99 cold pages (demotions, promotions and spills all
   above 0, the tier accounting after every step, finite logprobs;
   greedy agreement with the single tier reported); hot, cold and host
   bytes;
25. ``ServeEngine.from_checkpoint`` on phase 20's checkpoint against an
   engine built on the same params in memory: every leaf equal and the
   streams equal bit for bit;
26. the load generator: ``calibrate_rate`` on 16 requests of
   ``make_workload`` (64-256 prompt tokens, 16-32 new), then
   ``run_load`` at half the calibrated rate: every request completes and
   the accounting holds; TTFT p50/p99, TPOT and goodput reported.

Phases 27-30 train with the JAX package's single-card recipe:

27. TransformerLM-large (batch 4 x seq 2048, bf16, flash on) through
   ``LMTrainer`` with ``Adafactor()`` (relative step size), a global-norm
   clip of 1.0, dropout 0.1, ``vocab_chunk=4000`` and ``remat="dots"``:
   2 warm-up steps, then 10 timed steps with every loss finite and the
   flash launches exact from 0 (24 forward per step, the recompute
   included, 12 of each sweep, all on the wgmma route); ms per step,
   tokens/s, MFU and peak memory; then one step's loss and gradients
   through the kernels against the plain versions with dropout on and
   the same masks (one key), with phase 16's bounds (loss 2e-4 relative,
   every gradient leaf 2e-2 relative Frobenius), and the three flash
   kernels on the last layer's own q, k, v and dO from that step, row by
   row, each gradient bound catching the planted fault there; the same
   fault in every layer's forward is reported against the loss bound;
28. the memory-policy and chunk matrix on LM-large with AdamW and dropout
   off, all from the same start weights: remat none / blocks / dots under
   act_dtype compute and f32, and ``vocab_chunk`` 4000 under none and
   dots: peak memory and ms per step over 3 timed steps after one, the
   flash launches exact (24 forward per step under blocks and dots), the
   step-1 losses of none, blocks and dots within 1e-5 relative, the
   act_dtype and chunk differences reported;
29. VGG-11 part 1 through ``run_part`` under ``TPU_DDP_REMAT=blocks`` and
   ``conv_stages`` with both kernels, 40 iterations each: the launch
   counts exact with the recompute (the two forward BN kernels 16 per
   step and 8 per eval batch, the backward ones 8 per step, SGD once);
   then a ``Trainer`` under blocks with ``clip_grad_norm=1.0``: in a step
   with cuDNN deterministic every recomputed BN input matches one forward
   input bit for bit and its (mean, inv) equal the forward's bits, and
   one step through the kernels is held to the plain versions as in
   phase 11;
30. the example entry points as subprocesses on the card:
   ``python -m tpu_ddp_torch.examples.lm_text_train`` exits 0 with three
   falling epoch losses and a sample, and ``python -m
   tpu_ddp_torch.examples.lm_train --num-nodes 1`` with
   ``TPU_DDP_LM_OPT=adafactor TPU_DDP_LM_CLIP=1.0
   TPU_DDP_LM_PRESET=TransformerLM-large`` exits 0 with finite, falling
   losses.

Phases 31-34 run the rest of the data-parallel ladder:

31. parts 1, 4 (ZeRO-1) and 5 (FSDP) through ``run_part`` at world 1 (4
   and 5 over NCCL on a group of one), ``vgg11_cifar10`` at full width,
   both kernels, 40 iterations and the test pass, cuDNN deterministic,
   in turns 1, 4, 5, 5, 4, 1: the loss and ``Test set:`` lines of every
   run must equal part 1's, and every launch count phase 10's (SGD once
   per step over the flat shards); iteration ms (both turns and their
   mean), images/s and peak memory for each;
32. the per-rank device code on CUDA tensors: VGG-11's and LM-large's
   flat shards at N = 1, 3 and 4 against the CPU's (VGG every rank bit
   for bit, LM-large reassembled bit for bit and its first, largest and
   padded leaves' shards against the CPU's); the int8 quantizer's bits
   against the CPU's, its round trip within one block step, zeros exact,
   64 draws unbiased within a stated bound that catches a planted
   quarter-step bias; on a NCCL group of one the bf16 wire's two phases
   and the int8 phase 1 against the CPU, and ``OverlapSync`` over VGG-11
   in 4 MiB buckets: the buckets launch in reverse order from the hooks
   inside the backward, the bucketed gradients the unbucketed ones bit
   for bit;
33. LM-large (batch 4 x seq 2048, bf16, flash, AdamW) at world 1 over
   NCCL under ``opt_sharding`` zero1, zero2 (two microbatches) and
   ``param_sharding='fsdp'``, 3 steps each from one start: the step-1
   loss equal to the replicated run's bits (zero2's to the replicated
   two-microbatch run's), the flash launches exact (12 layers per
   microbatch per step, all wgmma); ms per step over steps 2-3, tokens/s
   and peak memory;
34. the ladder at world 2 over NCCL, one card per rank, when the machine
   has two cards (every part, fused and zero under bf16 and int8, fused
   with overlap; every rank the same params, the f32-wire rungs within
   part 2b's tolerance); on one card it prints ``{"multi_card":
   "skipped: 1 card"}``.

Phases 35-37 run the image trainer's last model families:

35. the BN+ReLU kernels at ResNet-50's eight (R, C) shapes at batch 256
   (3,211,264 x 64 at the stem down to 12,544 x 512; 33 sites per
   forward), on bf16 inputs cast to f32 rows as the op casts them, the
   one-pass route: phase 7's bounds, each also catching a planted fault
   (the reductions returning the previous launch's sums; the sums
   missing the one-pass grid's last row block reported beside it), two
   launches the same bits, NaN kept at the stem's shape; each kernel
   timed beside its bound, its plain version and SyncBatchNorm's
   primitive, and the op's casts (bf16 -> f32 x and g, f32 -> bf16 y and
   dx), summed per step over the 33 sites. Then the backward pair on the
   bf16 rows as they are (the op's backward on bf16 activations): dbias,
   dscale and dx bit for bit the f32 route on the upcast rows plus the
   cast (NaN compared by position), the same bits on two launches and
   after a launch at another shape, the bit gate catching both planted
   faults, NaN kept at the stem's shape; each kernel timed beside its
   bound in bf16 bytes (6 per element for dx, 4 for the reduction) and
   SyncBatchNorm's primitive on the same bf16 rows, and the op's
   backward on the bf16 rows and with the f32 route forced;
36. ResNet-50 (``resnet50_imagenet``: 25,557,032 params, batch 256,
   224x224, 1000 classes, bf16) through ``run_part("part1")`` with both
   kernels on the synthetic ImageNet stand-in (2048 train images, 8
   steps; 512 val, 2 batches): finite losses, the ``Test set:`` line, and
   the launch counts exact from 0 (``bn_stats``/``bn_norm_relu`` 330 on
   the one-pass route, ``bn_bwd_stats``/``bn_bwd_dx`` 264 on their bf16
   routes and none on f32, SGD 24: three launches per step over 161
   leaves); the SGD kernel over those 161
   leaves bit for bit with its plain version, every launch of a skipped
   step writing nothing; then a ``Trainer`` on one staged batch: ms per
   step over 10 steps after 2, images/s, MFU (3 x forward FLOPs / step
   time / 989e12), peak memory and a 5-step profiler window (idle share,
   top kernels, the ported kernels' and the copy kernels' ms per step);
   ms per step with the op's backward on the f32 route forced and on the
   bf16 rows again, in turns; one step through the kernels against the
   plain versions with phase 11's bounds; one step on each backward
   route from the same state, cuDNN deterministic, and the bf16 one
   again: the loss, every gradient and every parameter the same bits,
   33 launches of each backward kernel on the route's dtype and none on
   the other; one step under ``remat="blocks"``: 65 launches of each
   forward BN kernel (the stem outside every block), 33 of each backward
   one, the loss within 1e-5 relative of ``"none"``;
37. ViT: ``vit_cifar10`` through ``run_part("part1")`` with the SGD
   kernel, 40 iterations on ``full_attention`` (finite losses, ``Test
   set:``, 40 SGD launches, no BN or flash launch); a ``Trainer`` on
   ViT-tiny with the flash kernels at batch 256: launches exact (6 of
   each kernel per step, all on the route ``fwd_route``/``bwd_route``
   pick, none causal), one step's loss and gradients held to the plain
   versions with phase 16's bounds and the three kernels row by row on
   the last layer's own q, k, v and dO, each gradient bound catching the
   planted fault (a quarter of the 64 keys dropped for the last quarter
   of the queries); ViT-S16 on synthetic ImageNet at batch 256 (196
   patches): 12 of each kernel per step, ms per step, MFU and peak; the
   three kernels at both presets' calls, non-causal, held to their plain
   versions and timed beside their bounds and SDPA's flash backend.

38. the dispatch window: ``vgg11_cifar10`` part 1 through ``run_part``
   (batch 256, bf16, both kernels, cuDNN deterministic), 60 iterations,
   at ``TPU_DDP_DISPATCH_DEPTH`` 0, 2 and 4: loss lines, test line and
   the epoch-end checkpoint's digests the same at every depth, launches
   exact, forced syncs at most ceil(20 / depth) + 1 (read back from each
   run's ``TPU_DDP_METRICS_FILE``); then one trainer's epoch loop at each
   depth, traced and untraced: ms per iteration, host gap, idle share;
39. K steps per dispatch: VGG-11 at K = 4 (3 groups) and 8 (2 groups),
   each group one CUDA graph replay, the losses, params and momentum the
   same bits as K * N eager steps, the counts exact (one warm-up step and
   one captured group counted; replays reported), a skipped replay and a
   stale staging buffer each breaking the bitwise gate, a poisoned batch
   inside a group skipped as the eager step skips it; ms per iteration
   from ``stop_many`` at K = 1, 4, 8, the capture's ms and a traced
   window; ViT-tiny on the flash kernels at K = 4, bit for bit, flash
   counts exact;
40. the loop's host side: ``prefetch_to_device`` (pinned, a copy stream)
   gives the loader's batches on the card, the native loader gives the
   numpy loader's (within 1e-6) and the one-shot C++ transform's,
   ``TPU_DDP_PROFILE_DIR`` writes a trace holding the kernels,
   ``bench_collectives`` at world 1 over NCCL (outputs checked), and
   ``mfu_fields`` with the H100's peak gives phases 36-37's MFU;
41. Adafactor under ZeRO-1: TransformerLM-large (batch 4 x seq 2048,
   bf16, flash, phase 27's Adafactor, dropout, ``vocab_chunk`` and
   ``remat="dots"``; no clip, which zero1 refuses) under
   ``opt_sharding='zero1'`` (the row-sharded ``FactoredZeRO1``) at world
   1 over NCCL and replicated, one warm-up step and three steps each:
   the losses and every parameter the same bits, the flash launches
   exact (24 forward and 12 of each sweep per step); ms per step and
   peak memory beside phase 27's; the optimizer alone on one step's real
   gradients, bit for bit; the three ``ValueError`` refusals (zero2,
   fsdp, zero1 with a clip); ``redistribute_state`` zero1 -> replicated
   -> zero1, bit for bit;
42. elastic membership on the card: VGG-11 part 3 (DDP over NCCL at
   world 1, batch 256, both kernels, cuDNN deterministic) through
   ``run_part`` under ``TPU_DDP_ELASTIC_RESHARD`` with a membership epoch
   (world 1, a fresh coordinator port) published after step 20: the
   survivor's sequence (``state_to_host(local_only=True)``, the NCCL
   group aborted, a new one, ``Trainer.rebind`` with DDP rebuilt,
   ``state_from_host``) and its ack; the loss lines, test line and final
   checkpoint digests equal to an uninterrupted run's, the BN and SGD
   launches exact; the reshard's seconds; then VGG-11's live state
   through parts 3 -> 4 -> 5 -> 3 with ``redistribute_state``, bit for
   bit;
43. K steps per dispatch on every rung, at world 1 over NCCL
   (``vgg11_cifar10`` as published, both kernels, cuDNN deterministic):
   parts 2a, 2b, 3, 4 and 5 at K = 4 over two groups, each group one
   CUDA graph replay (``train/capture.py``), the ``[loss, skipped]``
   rows, every parameter and all optimizer state the bits of 8 eager
   steps, and a trace of the replays holding 8 SGD and 64 of each BN
   kernel; part 3 with overlap (4 MiB buckets) and with the int8 wire
   (both turned on at dp 1; the carry written in place), each catching a
   planted fault (a stale staging buffer; a carry rebound instead of
   written in place); part 1 under ``remat="conv_stages"`` with the
   recompute's 128 forward BN launches; a poisoned batch inside a part-3
   group skipped alone; ms per iteration through ``train_epoch`` at
   K = 1 and 4 for part 3 with the capture's ms and a traced 12-step
   window's idle share; then LM-large (AdamW, flash, block remat, no
   dropout) at K = 2 through ``LMTrainer.build_multi_step``, replicated
   and zero1: the bits of 2 eager steps, the flash launches exact at
   capture and in a replay's trace, ms per step eager and replayed.
44. the autotuner (``tpu_ddp_torch/tune/``) at world 1 over NCCL on
   ``vgg11_cifar10`` as published (batch 256, no knob env set):
   ``tuned_vs_default`` over the live space (16 batches per trial, at
   most 48 trials); the space must hold ``pallas_sgd`` and ``pallas_bn``,
   no trial may be quarantined, and tuned >= default at the long
   fidelity. Each trial's SGD and BN+ReLU launches are counted from 0:
   with a kernel knob on, the wrapper's count equals its launches per
   step (SGD 1, the forward BN kernels 8, 16 under remat, the backward
   ones 8) times the steps it launched (eager steps, captured steps and
   the undone warm-ups before a capture; a replay launches nothing from
   the host), with the knob off 0. One trainer switched K = 4 -> 1 -> 4,
   as a cached trial trainer is: its K = 1 steps the bits of the same
   steps on a trainer whose DDP was built for eager steps, and no second
   capture. Then ``run_part("part3")`` under ``TPU_DDP_AUTOTUNE=search``
   (``steps_per_dispatch`` and ``pallas_bn`` searched, a fresh cache)
   and again under ``cached``: the second run logs ``cache hit:
   trials=0`` with the first run's overrides, its config equals the
   tuned one, and both train their 16 iterations.
45. the LM's dropout under capture: TransformerLM-large at full width
   (batch 4 x seq 2048, bf16, flash, AdamW, the preset's block remat)
   with dropout 0.1 at K = 2 through ``LMTrainer.build_multi_step``: one
   replay against 2 eager steps from the same state, the losses,
   parameters and AdamW state the same bits (each mask a counter hash
   keyed by the step the replay reads from the optimizer's device
   count); the count then moved on by K with the same params and
   batches, a second replay of the same graph draws other masks (its
   losses differ from the first's) and equals 2 eager steps at that
   count. Flash launches exact for the eager steps and the capture; ms
   per step eager and replayed; the mask hash alone against
   ``torch.rand``;
46. ``TransformerLM-moe-large`` as published (12 layers, d_model 2048,
   16 heads, 16 experts of d_ff 4096, top-2, capacity factor 1.25, block
   remat; 3,554,119,680 parameters) at batch 4 x seq 2048, bf16, flash,
   Adafactor (AdamW's f32 state does not fit 80 GB; the batch is halved,
   never the width, and the cut printed if Adafactor's does not either):
   eager steps with ms/step, tokens/s, MFU by active FLOPs, peak GiB,
   exact flash launches (the forward twice per layer) and the
   ``format_route_stats`` line; one step's loss through the kernels
   against the plain flash within phase 16's bound (the gradients, which
   routing flips at near-ties move between experts, reported with the
   share of routed assignments that moved); a K = 2 graph against 2
   eager steps, bit for bit, the state's copies held in host memory;
47. MoE-large serving, bf16 at ``decode_quant='none'``: phase 5's 8
   requests (tokens/s, TTFT median and max), the dropped share of the
   routed assignments in decode steps and in prefill chunks at capacity
   factor 1.25 (the whole bank is routed, idle rows and chunk padding
   included, as in the JAX engine), no Hopper kernel launched; one
   greedy request at capacity factor E against the argmax stream of
   whole-sequence forwards through the decode math (a divergence allowed
   only at a top-2 gap within ``NEAR_TIE``); ``decode_quant='int8'`` and
   the ``quant`` draft refused.
48. sequence parallelism at LM-large's attention call (B = 4, L = 2048,
   H = 16, D = 128, bf16, causal), each rank's math of an sp group
   composed in one process with the tensors the group's collectives
   would deliver (NCCL takes one rank per card, so the collectives do
   not run here): the ring at sp = 2 and 4 (``ring_local`` of rank r fed
   the chunk of rank (r - s) % sp at step s) against the flash kernels
   over the whole sequence, the output and the q, k, v gradients
   (autograd through the block updates) within phase 13's bf16 row
   bound; seeded from a 1024-position cache with its last 256 masked and
   ``q_offset`` 768, against the flash forward over cache ++ chunk; ms
   per rank-step of the block update and rank 0's forward + backward
   peak memory, beside the flash forward's ms per layer. Ulysses at
   sp = 2: each rank's local flash call on its 8 heads over the whole
   sequence (contiguous, as the all-to-all delivers them), the flash
   launches counted from 0 (2 per kernel, all wgmma), the output and
   gradients against the same heads of the 16-head call (bit-equal or
   not, and the largest difference). The int8 kernel at M = 16 (the
   32-row cp-prefill chunk over sp = 2) on LM-large's projections, on
   the mma route, against its plain version as phase 3, timed beside its
   bound and ``torch.matmul``.
49. tensor parallelism at TransformerLM-large's widths (d_model 2048, 16
   heads of 128, d_ff 8192, bf16, batch 4 x 2048), each rank's
   arithmetic of a tp group composed in one process, the all-reduces
   written as explicit sums of the ranks' f32 partials (NCCL takes one
   rank per card, so Megatron's ``f`` and ``g`` do not run here): (a) at
   tp = 2 and 4 one block forward and backward, each rank on its cell
   (8 or 4 heads, d_ff / tp), against the dense block, kernels on both
   sides: the flash launches counted from 0 (tp per kernel, all wgmma),
   the output within phase 13's bf16 row bound, each rank's gradients of
   its sharded leaves against the dense gradients' slices and the
   replicated leaves' and the input's gradients (the sum of the ranks'
   contributions) by Frobenius error; one rank's block ms and peak
   against the dense block's. (b) at tp = 2 every rank's int8 slices of
   LM-large's dense quantization, bit for bit the slices (16-byte
   aligned, each on the mma route), and one decode pass at M = 8 of both
   ranks composed, its 98 int8 launches (49 per rank) counted from 0,
   all mma; each rank's column-parallel outputs against the dense
   kernel's columns and the row-parallel partial sums against the dense
   kernel's output on the same inputs (1e-4 x max|dense|), the logits
   against the dense int8 pass; one rank's 49 calls timed beside the
   dense pass's, its byte bound and ``torch.matmul``. (c) the dropout
   masks at LM-large's residual shape from the four keys of a dp = 2 x
   tp = 2 world (``LMTrainer.step_key``): equal on the two tp ranks of a
   data shard, different across shards.
50. pipeline parallelism: ``PipelineLMTrainer`` with every stage in this
   process (``stages="in_process"``, in-process edges) at
   TransformerLM-large's width and depth (bf16, flash, remat ``blocks``,
   AdamW, batch 4 x 2048), from the same seed parameters as one dense
   ``LMTrainer`` step: pp = 2, M = 4 under gpipe, 1f1b, interleaved (V =
   2) and zerobubble, and pp = 4, M = 4 under 1f1b. Each run's gradients
   (``step_grads``: the warm-up step's, before its update) against the
   dense step's: the loss within 2e-3 relative, each leaf within 1e-2 by
   relative Frobenius error, the pp = 2 schedules within 1e-3 of gpipe's;
   a planted fault (an edge that delivers two microbatches swapped) must
   trip the 1e-2 bound. The flash launches of that call, counted from 0, must be the
   schedule's count (per layer and microbatch: gpipe 2 forwards and 1 of
   each backward, 1f1b and interleaved 3 and 1, zerobubble 5 and 2), all
   wgmma. Per run: ms per step (the median of 3 after the warm-up), the
   peak memory of the gradient pass and of the steps above what was live
   before them, and the dense step at ``grad_accum`` = M beside them. The
   1f1b step's K = 2 call (one CUDA graph) must give the two eager steps'
   bits, and one replay of it is timed.
51. the MPMD pipeline (``parallel/mpmd.py``): ``MPMDPipeline`` with every
   stage in this process at TransformerLM-large's width and depth (bf16,
   flash, batch 4 x 2048, M = 4, parameters from one seed) against one
   dense ``LMTrainer`` step's gradients: pp = 2 and pp = 4 with f32
   (``none``) edges, the loss within 2e-3 relative and each leaf within
   1e-2 by relative Frobenius error (phase 50's bounds), an edge that
   delivers two microbatches swapped must trip the 1e-2 bound, and the
   flash launches of each ``step_grads`` call, counted from 0, exactly
   M x (2 x (L - L/pp) + L/pp) forwards and M x L of each sweep (pp = 2:
   72 / 48 / 48, pp = 4: 84 / 48 / 48), all wgmma. Cross-slice wires
   (``SliceTopology.even(2, 2)``): ``bf16`` edges must give the f32
   edges' bits at ratio 2.0 (every payload holds bf16 values), ``int8``
   a ratio of 3.5 or more and each leaf within 0.1 of the f32 edges'
   (recorded). Each wire through a socket pair to and from the card
   decodes as in process. The two-process drill, ``python -m
   tpu_ddp_torch.launch mpmd --nproc 2 --device cuda:0`` with int8
   edges and 3 steps (both ranks on this card over one TCP socket,
   started first and run beside the checks): exit 0 and ``RESULT ...
   OK``, each rank's edge and stage-scheduler stats kept. Readings: ms
   per train step at pp = 2 (AdamW, the median of 3 after a warm-up)
   beside phase 50's 1f1b and dense ``grad_accum`` = 4 steps, edge
   bytes per step dense and on the wire, the peak of the gradient pass.
52. the mesh compositions: (a) ``PipelineLMTrainer(stages="in_process")``
   with ``Adafactor()`` at TransformerLM-large's width and depth (bf16,
   flash, batch 4 x 2048, pp = 2 under 1f1b, M = 4, remat ``blocks``):
   the flash launches of one ``step_grads`` call, counted from 0,
   exactly 144 / 48 / 48, all wgmma; the loss within 1e-6 relative and
   each leaf within 1e-2 by relative Frobenius error of one dense
   ``LMTrainer`` step on the same parameters and batch; the trainer's
   update bit for bit the bare Adafactor applied in plain PyTorch stage
   cell by stage cell (each stacked leaf's ``num_layers / pp`` rows) to
   the trainer's own gradients, and the same Adafactor over each whole
   stacked leaf (the planted fault) must differ on at least one leaf;
   ms per train step (the median of 3) beside phase 50's 1f1b AdamW
   step and the peaks. (b) tensor-parallel serving at tp = 2: two
   processes on this card over a gloo group (gloo's collectives take
   CUDA tensors through the host; NCCL takes one rank per card), each
   serving LM-large int8 on its slices (``ServeEngine(tp_group=...)``):
   4 of phase 5's requests (16 new tokens) at k = 0, ``chain`` and
   ``self-2`` at k = 4, and 2 of phase 24's 1536-token prompts through
   the single tier, ``kv_tiers=2`` bf16 and ``kv_tiers=3`` int8 (the
   int8 rows' scales all-reduced over the group). Phases 21's and 24's
   gates on each rank (chain the k = 0 stream bit for bit, self-2 parting
   only at a near-tie, bf16 tiers the single tier bit for bit, the int8
   tiers demoting, promoting and spilling), each run's int8 launches
   equal to its pass counters (49 per pass per rank, all mma), and both
   ranks the same tokens. (b) starts first and runs beside (a).

Checkpoints of phases 18-20 and 42 and phase 44's tuning cache go to
``_chip_smoke_ckpt/`` in the checkout and are removed at the end.
Prints the card's name and power limit, the serving and training
metrics, each phase's seconds, one ``{"kernels": [...]}`` line (nine
kernels; the int8 kernel's launches on each path of phases 21-26, the
flash kernels' on phases 27-28's and 33's and the BN and SGD kernels' on
phases 29's, 31's and 36's (SGD's on 37's too) and 38-39's (the flash
kernels' on 39's ViT-tiny group and 41's runs, the BN and SGD kernels'
on 42's elastic run and 44's trials; the flash kernels' on 45's and
46's eager steps and captures, on 48's Ulysses ranks, on 49's tp ranks,
on 50's pipeline schedules, 51's MPMD stages and 52's in-process
Adafactor pipeline; the int8 kernel's on 49's tp decode pass and on
rank 0's tp = 2 engine runs of 52), beside each main-path count; the int8 row also the 32-row
prefill's bound, 48's 16-row cp-prefill pass and 49's rank pass at tp =
2; the flash rows 49's block times per rank; the BN, SGD and flash rows
also carry their ResNet-50 and ViT times from phases 35-37), and
last the contract line ``{"ok": true, "device": {...}}``.
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
# Shapes at which phase 7 feeds the kernels NaN (a VGG-11 shape and two
# edge shapes).
BN_NAN_SHAPES = [(4096, 512), (999, 96), (300, 3)]
# The shape launched between two launches at a VGG-11 shape in the
# one-pass reductions' bit-identity check.
BN_BITS_OTHER = (999, 96)
# Odd SGD leaves beside VGG-11's: one element, ragged chunks, odd sizes.
SGD_EDGE_SHAPES = [(1,), (7, 13), (4099,), (100001,)]
# Bytes each BN kernel moves per element, by the rows' dtype (f32 rows
# for every kernel, bf16 rows for the backward pair), and its flops per
# element: stats reads x; norm reads x, writes y; bwd_stats reads x, g;
# bwd_dx reads x, g, writes dx.
BN_BYTES_PER_ELEM = {
    torch.float32: {"bn_stats": 4, "bn_norm_relu": 8, "bn_bwd_stats": 8,
                    "bn_bwd_dx": 12},
    torch.bfloat16: {"bn_bwd_stats": 4, "bn_bwd_dx": 6}}
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


def graph_ms(fn, args_list, calls: int, replays: int = 3) -> float:
    """Device ms per call of ``fn`` without the host or the profiler:
    ``calls`` calls cycling through ``args_list``, captured as one CUDA
    graph after an eager pass over ``args_list``, replayed once untimed
    and then ``replays`` times between two CUDA events. The replay runs
    the captured kernels back to back, as a step's stream does."""
    for a in args_list:
        fn(*a)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(calls):
            fn(*args_list[i % len(args_list)])
    g.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (replays * calls)


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
    from tpu_ddp_torch.serve.engine import ServeEngine, bank_logits
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
    lk = bank_logits(*args)
    with mock.patch.object(quant, "int8_matmul", int8_matmul_ref):
        lp = bank_logits(*args)
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


@contextlib.contextmanager
def _previous_designs(tb):
    """The BN kernels' previous designs forced: the two-stage reductions
    and the row-blocks dx kernel (f32 rows only)."""
    with _force(tb, "stats_route", "two_stage"), \
            _force(tb, "dx_route", "row_blocks"):
        yield


def _previous_errors(tb, x, g, s, b):
    """The errors of the two reductions and of dx with the previous
    designs forced, against the same bounds as the main routes."""
    with _previous_designs(tb):
        errs, _ = _bn_kernel_errors(tb, x, g, s, b)
    return {k: v for k, v in errs.items()
            if k.startswith(("bn_stats", "bn_bwd_stats", "bn_bwd_dx"))}


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


def _nan_agree(kern, plain):
    """(NaN positions differ?, max |kernel - plain| over the elements both
    hold finite)."""
    kn, pn = torch.isnan(kern), torch.isnan(plain)
    both = ~kn & ~pn
    err = float((kern - plain).abs()[both].max()) if bool(both.any()) \
        else 0.0
    return bool((kn != pn).any()), err


def _bn_nan_errors(tb, x, g, s, b) -> dict:
    """The four kernels on inputs holding NaN, each fed the plain
    version's inputs: every output NaN exactly where the plain version's
    is, and within phase 7's bounds (over the plain version's finite
    elements) elsewhere. Returns {what: (NaN count of the plain output,
    max error, tolerance)}; fails on a NaN mismatch or an error past its
    bound."""
    mean, inv = tb.bn_stats_ref(x)
    y = tb.bn_norm_relu_ref(x, mean, inv, s, b)
    db, ds = tb.bn_bwd_stats_ref(x, g, mean, inv, s, b)
    dx = tb.bn_bwd_dx_ref(x, g, mean, inv, s, b, db, ds)
    km, ki = tb.bn_stats(x)
    ky = tb.bn_norm_relu(x, mean, inv, s, b)
    kdb, kds = tb.bn_bwd_stats(x, g, mean, inv, s, b)
    kdx = tb.bn_bwd_dx(x, g, mean, inv, s, b, db, ds)
    torch.cuda.synchronize()

    def fin_max(t):
        t = t.abs()[~torch.isnan(t)]
        return float(t.max()) if t.numel() else 0.0

    xf = torch.nan_to_num(x, nan=0.0)
    gf = torch.nan_to_num(g, nan=0.0)
    pairs = {"bn_stats": (km, mean, 1e-4 * fin_max(xf.abs().mean(0))),
             "bn_stats_inv": (ki, inv, 1e-4 * fin_max(inv)),
             "bn_norm_relu": (ky, y, 1e-4 * fin_max(y)),
             "bn_bwd_stats": (kdb, db, 1e-4 * fin_max(gf.abs().sum(0))),
             "bn_bwd_stats_dscale": (
                 kds, ds, 1e-4 * fin_max((gf * (xf - mean) * inv).abs()
                                         .sum(0))),
             "bn_bwd_dx": (kdx, dx, 1e-4 * fin_max(dx))}
    out = {}
    for what, (k, p, tol) in pairs.items():
        differ, err = _nan_agree(k, p)
        if differ or not err <= tol:
            fail(f"{what} on NaN inputs: NaN positions differ from the "
                 f"plain version's ({differ}) or error {err} > {tol}")
        out[what] = (int(torch.isnan(p).sum()), err, tol)
    if out["bn_norm_relu"][0] == 0:
        fail("phase 7's NaN inputs gave the plain forward no NaN")
    return out


# Kernel 9's same-run comparison at VGG: rounds of the one-wave kernel,
# the row-blocks kernel and batch_norm_backward_elemt in turns.
DX_ROUNDS = 5


def _dx_rounds(tb, turns, calls: int) -> dict:
    """Kernel 9's two designs and ``batch_norm_backward_elemt`` timed in
    turns over VGG-11's conv outputs. ``turns`` holds, per shape, (units,
    the kernel's argument tuples, the library call's), each list cycling
    through copies of the rows. Each of the three is captured as one CUDA
    graph of ``calls`` x units calls at every shape; each of DX_ROUNDS
    rounds replays the three, in an order that rotates from round to
    round, each between CUDA events (as :func:`graph_ms`). ms per VGG-11
    step of each, by round, with the median and spread."""
    def run(name, per_unit):
        fn = (torch.batch_norm_backward_elemt if name == "library"
              else tb.bn_bwd_dx)
        with (_force(tb, "dx_route", "row_blocks") if name == "row_blocks"
              else contextlib.nullcontext()):
            for units, dx_args, lib_args in turns:
                a = lib_args if name == "library" else dx_args
                for i in range(units * per_unit):
                    fn(*a[i % len(a)])

    names = ("one_wave", "row_blocks", "library")
    graphs = {}
    for name in names:
        run(name, 1)
        torch.cuda.synchronize()
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            run(name, calls)
        graphs[name].replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    per_round = {n: [] for n in names}
    for rnd in range(DX_ROUNDS):
        for name in names[rnd % 3:] + names[:rnd % 3]:
            e0.record()
            for _ in range(3):
                graphs[name].replay()
            e1.record()
            torch.cuda.synchronize()
            per_round[name].append(e0.elapsed_time(e1) / (3 * calls))
    return {n: {"median_ms": sorted(v)[DX_ROUNDS // 2], "min_ms": min(v),
                "max_ms": max(v), "per_round_ms": v,
                "timing": "cuda-graph events"}
            for n, v in per_round.items()}


def _fail_on(errs, where):
    for what, (err, tol) in errs.items():
        if not (math.isfinite(err) and err <= tol):
            fail(f"{what} disagrees with its plain version at {where}: "
                 f"error {err} vs tol {tol}")


def check_bn(dev, gen) -> dict:
    """Phase 7: the four BN+ReLU kernels at VGG-11's eight conv outputs,
    and at a few small shapes that take the kernels' other paths (C not a
    multiple of 4, rows not a multiple of a block), each on its main route
    and its previous design; kernel 9's two designs and the library call
    timed in turns (:func:`_dx_rounds`)."""
    import torch.nn.functional as F

    from tpu_ddp_torch.ops import bn_relu as tb
    edge = {}
    other = _bn_inputs(*BN_BITS_OTHER, gen, dev)
    for r, c in BN_EDGE_SHAPES:
        x, g, s, b = _bn_inputs(r, c, gen, dev)
        errs, _ = _bn_kernel_errors(tb, x, g, s, b)
        _fail_on(errs, f"R={r} C={c}")
        was = _previous_errors(tb, x, g, s, b)
        _fail_on(was, f"R={r} C={c} (two_stage)")
        edge[f"{r}x{c}"] = {k: v[0] for k, v in errs.items()}
        edge[f"{r}x{c}"]["two_stage"] = {k: v[0] for k, v in was.items()}
    # NaN inputs: whole NaN rows of x (every channel's statistics NaN),
    # and scattered NaN elements of x in every third channel and of g in
    # others; each on both routes of the two reductions.
    nan_cases = {}
    for r, c in BN_NAN_SHAPES:
        for kind in ("rows", "elements"):
            x, g, s, b = _bn_inputs(r, c, gen, dev)
            if kind == "rows":
                x[[1, r // 2]] = float("nan")
            else:
                x[r // 3, ::3] = float("nan")
                g[r // 2, 1::3] = float("nan")
            for route in ("one_pass", "two_stage"):
                with (_previous_designs(tb) if route == "two_stage"
                      else contextlib.nullcontext()):
                    res = _bn_nan_errors(tb, x, g, s, b)
                nan_cases[f"{r}x{c}/{kind}/{route}"] = {
                    k: {"plain_nans": v[0], "err": v[1]}
                    for k, v in res.items()}
    kernels = {"bn_stats": (tb.bn_stats, tb.bn_stats_ref),
               "bn_norm_relu": (tb.bn_norm_relu, tb.bn_norm_relu_ref),
               "bn_bwd_stats": (tb.bn_bwd_stats, tb.bn_bwd_stats_ref),
               "bn_bwd_dx": (tb.bn_bwd_dx, tb.bn_bwd_dx_ref)}
    shapes, dx_turns = [], []
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
        was = _previous_errors(tb, x, g, s, b)
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
                BN_BYTES_PER_ELEM[torch.float32][name] * n_el
                + 4 * BN_CHAN_VECTORS[name] * c,
                BN_FLOPS_PER_ELEM[name] * n_el)
            row[name] = {"ms": k_t["ms"], "event_ms": k_t["event_ms"],
                         "plain_ms": p_t["ms"], "bound_ms": bound,
                         "bound_by": by,
                         "timing": _timing_label(k_t, p_t)}
            if name in ("bn_stats", "bn_bwd_stats", "bn_bwd_dx"):
                with _previous_designs(tb):
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
        dx_turns.append((units, args["bn_bwd_dx"], [
            (gm, xi, mean, inv, s, db, sum_dy_xmu, count)
            for xi, gm in zip(xs, gms)]))

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

    out = {"shapes": shapes, "edge_shapes": edge, "nan_cases": nan_cases,
           "kernels": {}}
    for name in kernels:
        bound_bytes = sum(row["units"] * (BN_BYTES_PER_ELEM[torch.float32][
            name] * row["r"] * row["c"] + 4 * row["c"]
            * BN_CHAN_VECTORS[name]) for row in shapes)
        bound_flops = sum(row["units"] * BN_FLOPS_PER_ELEM[name] * row["r"]
                          * row["c"] for row in shapes)
        bound, by = _bound(bound_bytes, bound_flops)
        err_keys = [k for k in shapes[0]["errors"] if k.startswith(name)]
        out["kernels"][name] = {
            "ms": per_step(name, "ms"), "plain_ms": per_step(name,
                                                             "plain_ms"),
            **({"was_ms": per_step(name, "was_ms")}
               if name != "bn_norm_relu" else {}),
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
    out["kernels"]["bn_bwd_dx"]["vgg_rounds"] = _dx_rounds(tb, dx_turns, 10)
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
# kernel and the two-stage pair; for dx, the one-wave kernel and the
# row-blocks one.
VGG_KERNELS = {"bn_stats": ("bn_stats_onepass_kernel", "bn_stats_kernel",
                            "bn_stats_finish"),
               "bn_norm_relu": ("bn_norm_relu_kernel",),
               "bn_bwd_stats": ("bn_bwd_stats_onepass_kernel",
                                "bn_bwd_stats_kernel", "bn_bwd_finish"),
               "bn_bwd_dx": ("bn_bwd_dx_wave_kernel", "bn_bwd_dx_kernel"),
               "sgd": ("sgd_kernel",)}


def _bn_bwd_want(calls: int, bf16: bool = False) -> dict:
    """The backward pair's exact counts: ``calls`` launches of each on its
    main route, over bf16 rows (ResNet-50) or f32 rows (VGG), none on
    the other dtype or on a previous design."""
    sfx = "_bf16" if bf16 else ""
    stats = {"one_pass": 0, "one_pass_bf16": 0, "two_stage": 0}
    dx = {"one_wave": 0, "one_wave_bf16": 0, "row_blocks": 0}
    stats["one_pass" + sfx] = dx["one_wave" + sfx] = calls
    return {"bn_bwd_stats": stats, "bn_bwd_dx": dx}


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
    want = {"sgd": steps, **_bn_bwd_want(8 * steps),
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


def _dropped_tile(q, k, v, do, plain, causal: bool = True,
                  tile: int = FAULT_TILE) -> dict:
    """The planted fault: the plain outputs as a kernel would give them
    that skipped the last ``tile`` keys for the last ``tile`` queries
    (causal: the diagonal tile's kept half), with p and ds rounded as the
    kernels round them; o and lse alone when ``do`` is None."""
    b, L, h, d = q.shape
    kvh, n = k.shape[2], tile
    g, t, scale = h // kvh, slice(L - n, L), 1.0 / math.sqrt(d)

    def heads(x, rep):  # (B, n, heads, D) -> (B, H, n, D) f32
        return x[:, t].float().repeat_interleave(rep, 2).transpose(1, 2)

    qt, kt, vt = heads(q, 1), heads(k, g), heads(v, g)
    lse = plain["lse"][..., t, None]
    if do is not None:
        dot, delta = heads(do, 1), plain["delta"][..., t, None]
    s = qt @ kt.transpose(-1, -2) * scale
    if causal:
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool,
                                     device=q.device).triu(1), -1e30)
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
    # A quarter of a short sequence at most (ViT-tiny's 64 patches), so
    # the fault leaves every query keys to attend to.
    faulty = _dropped_tile(q, k, v, do, plain, causal,
                           min(FAULT_TILE, q.shape[1] // 4))
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
                  "count": state.opt_state["count"].clone()}
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


# The drills of phases 18-19: VGG-11 steps per run (a checkpoint every
# half), the synthetic images that feed them, the step phase 18 poisons
# and the one phase 19's worker dies at.
DRILL_ITERS = 20
DRILL_SYNTH = DRILL_ITERS * 256
DRILL_NAN_AT = 13
DRILL_EXIT_AT = 15


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
    n, half, at = DRILL_ITERS, DRILL_ITERS // 2, DRILL_NAN_AT
    drill = {"TPU_DDP_SYNTH_SIZE": str(DRILL_SYNTH)}
    with _deterministic_cudnn(), _env(**VGG_ENV):
        # 1. DRILL_ITERS iterations straight, against half and half more
        # resumed.
        a, b = os.path.join(root, "straight"), os.path.join(root, "resumed")
        _part1(dev, ["--ckpt-dir", a], TPU_DDP_MAX_ITERS=n,
               TPU_DDP_CKPT_EVERY=half, **drill)
        _part1(dev, ["--ckpt-dir", b], TPU_DDP_MAX_ITERS=half,
               TPU_DDP_CKPT_EVERY=half, **drill)
        out = _part1(dev, ["--ckpt-dir", b, "--resume"], TPU_DDP_MAX_ITERS=n,
                     TPU_DDP_CKPT_EVERY=half, **drill)
        if f"resumed from {b} at step {half} (epoch 0, iter {half})" \
                not in out:
            fail(f"phase 18: the resumed run did not pick up at step {half}")
        want = _step_digests(a, n)
        got = _step_digests(b, n)
        if got != want or ckpt.all_steps(a) != [half, n]:
            bad = sorted(k for k in want if got.get(k) != want[k])
            fail(f"phase 18: resumed VGG-11 differs from the straight run "
                 f"at step {n} on {len(bad)} leaves: {bad[:4]}")
        res["resume"] = {"leaves": len(want), "bitwise_equal": True,
                         "steps": n}

        # 2. nan-grad at step DRILL_NAN_AT: one step skipped, the state
        # unchanged by it.
        cfg = TrainConfig.preset("vgg11_cifar10")
        train, _ = create_data_loaders(batch_size=256,
                                       synthetic_size=(at + 1) * 256,
                                       seed=cfg.seed)
        cfg.pallas_sgd = cfg.pallas_bn = True
        model = get_model(cfg.model, use_pallas_bn=True,
                          compute_dtype=getattr(torch, cfg.compute_dtype))
        tr = Trainer(model, cfg, device=dev)
        state = tr.init_state()
        lines = []
        with _env(TPU_DDP_CHAOS_FAULTS=f"nan-grad@{at}"):
            losses = []
            for start, stop in ((0, at - 1), (at - 1, at), (at, at + 1)):
                tr.config.max_iters = stop
                if stop == at:
                    before = _state_digests(tr, state)
                state, stats = tr.train_epoch(state, train, start_iter=start,
                                              log=lines.append)
                losses.append(stats["last_loss"])
                if stop == at:
                    after = _state_digests(tr, state)
        skipped = [e["step"] for e in tr.metrics.events
                   if e["event"] == "step_skipped"]
        if skipped != [at] or tr.guard.total_skipped != 1 \
                or state.step != at + 1:
            fail(f"phase 18: nan-grad@{at} skipped steps {skipped}, "
                 f"state at step {state.step}")
        if before != after:
            fail(f"phase 18: the skipped step {at} changed params or "
                 f"momentum")
        if not math.isfinite(losses[2]):
            fail(f"phase 18: the loss at step {at + 1} is {losses[2]} "
                 f"(expected finite again after the skipped step)")
        # The poisoned step's loss is NaN, as on the CPU and in the JAX
        # package: the BN kernels keep a NaN variance and their ReLU keeps
        # a NaN (phase 7's NaN shapes hold them to the plain versions).
        if not math.isnan(losses[1]):
            fail(f"phase 18: the poisoned step {at} read a loss of "
                 f"{losses[1]!r}, not NaN: a kernel on the forward path "
                 f"maps NaN to a finite value")
        res["nan_grad"] = {"skipped_steps": skipped,
                           "state_unchanged": True,
                           "loss_poisoned_step": str(losses[1]),
                           "loss_next_step": losses[2]}

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
               TPU_DDP_CHAOS_FAULTS="corrupt-ckpt@20", **drill)
        out = _part1(dev, ["--ckpt-dir", c, "--resume"], TPU_DDP_MAX_ITERS=20,
                     TPU_DDP_CKPT_EVERY=10, **drill)
        if "[ckpt] step 20 failed verification" not in out \
                or f"resumed from {c} at step 10" not in out \
                or not os.path.isdir(os.path.join(c, "step_00000020"
                                                     ".corrupt")):
            fail("phase 18: the corrupt step-20 checkpoint was not "
                 "quarantined with step 10 restored")
        res["corrupt_ckpt"] = {"quarantined": "step_00000020.corrupt",
                               "restored_step": 10}

    # 5. VGG-11 iteration time, guard on (the default) and off: one
    # trainer's epochs in turns (the timer over iterations 1-39).
    res["guard_costs"] = _guard_costs(dev)
    res["iter_ms"] = {k: sum(v) / len(v) for k, v in
                      res["guard_costs"]["epoch_iter_ms"].items()}

    # Save and verified restore of the 74 MB VGG-11 state, alone.
    cfg = TrainConfig.preset("vgg11_cifar10")
    model = get_model(cfg.model, use_pallas_bn=cfg.pallas_bn,
                      compute_dtype=getattr(torch, cfg.compute_dtype))
    tr = Trainer(model, cfg, device=dev)
    state = tr.init_state()
    d = os.path.join(root, "timing")
    save_s, restore_s = [], []
    for rep in range(2):
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
    nbytes = os.path.getsize(os.path.join(d, "step_00000002",
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
    train, _ = create_data_loaders(batch_size=256, synthetic_size=1024)
    batches = [(x.to(dev), y.to(dev))
               for x, y in itertools.islice(iter(train), 4)]
    guard = tr.guard
    step_ms = {"on": [], "off": []}
    for mode in ("on", "off"):
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
    for mode in ("on", "off"):
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
    DRILL_EXIT_AT of DRILL_ITERS iterations, cuDNN deterministic: one
    restart, the resume at the half-way checkpoint, a finished run, and
    the last step's checkpoint equal to phase 18's straight run."""
    n, half = DRILL_ITERS, DRILL_ITERS // 2
    d = os.path.join(CKPT_ROOT, "launch")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPU_DDP_")}
    env.update({k: v for k, v in VGG_ENV.items() if v is not None})
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
    env.update(TPU_DDP_MAX_ITERS=str(n), TPU_DDP_CKPT_EVERY=str(half),
               TPU_DDP_SYNTH_SIZE=str(DRILL_SYNTH),
               TPU_DDP_CHAOS_FAULTS=f"hard-exit@{DRILL_EXIT_AT}",
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
        "fault": f"injecting hard-exit at step {DRILL_EXIT_AT}" in out,
        "resume half-way": f"resumed from {d} at step {half} (epoch 0, "
                           f"iter {half})" in out,
        "finished": "Test set: average loss" in out
        and "[launch] recovered after 1 restart(s)" in out,
        "finite losses": [i for i, _ in losses] == [n]
        and all(math.isfinite(v) for _, v in losses),
    }
    if not all(checks.values()):
        fail(f"phase 19: {[k for k, v in checks.items() if not v]} "
             f"failed; rc {proc.returncode}; output tail:\n{out[-3000:]}\n"
             f"{err[-2000:]}")
    got = _step_digests(d, n)
    if got != straight:
        bad = sorted(k for k in straight if got.get(k) != straight[k])
        fail(f"phase 19: the restarted run's step-{n} state differs from "
             f"phase 18's straight run on {len(bad)} leaves: {bad[:4]}")
    return {"restarts": 1, "losses": losses, "wall_s": wall,
            "bitwise_equal_to_straight_run": True}


def lm_checkpoint(dev, run: dict) -> dict:
    """Phase 20: TransformerLM-large with its AdamW state after phase 15's
    steps saved (f32 params, mu and nu), restored into a fresh
    ``LMTrainer`` after the first is freed, and the next step's loss
    compared bit for bit (one step each side)."""
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
    # Phase 25 serves this checkpoint against these params in memory.
    saved = {"dir": d, "step": step, "params": _to_device_tree(
        {k: v for k, v in state.params.items()}, "cpu")}
    state, l1 = tr.train_step(state, x, y)
    want = l1.clone()
    torch.cuda.synchronize()
    del tr, state, l1
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
    torch.cuda.synchronize()
    if not _same_bits(m1.float().reshape(1), want.float().reshape(1)):
        fail(f"phase 20: the restored trainer's next loss {float(m1)!r} "
             f"differs from the original's {float(want)!r}")
    out = {"params": n, "bytes": nbytes, "step": step,
           "save_s": save_s, "restore_s": restore_s,
           "save_gb_per_s": nbytes / save_s / 1e9,
           "restore_gb_per_s": nbytes / restore_s / 1e9,
           "next_loss": float(m1), "next_loss_bitwise_equal": True,
           "disk_free_gb": free / 1e9}
    del tr2, state2
    gc.collect()
    torch.cuda.empty_cache()
    out["_saved"] = saved
    return out


# ---- phases 21-26: the rest of single-card serving ---------------------
#
# TransformerLM-large at full width and depth from seed weights, int8
# decode unless a phase says otherwise. Each path's int8 launches are
# counted from 0 just before it runs and held to the engine's own pass
# counters: 49 per prefill chunk and per target pass under an int8 target,
# 4j + 1 per pass of a j-block int8 draft.

SPEC_K = 4
# Greedy tokens of two streams meant to be equal may part only where the
# reference's top-2 logit gap is at most this (a near-tie, reported).
NEAR_TIE = 1e-2
# Logprob bound of the prefix cache's copy-on-write request against the
# uncached run, over the positions where the tokens agree.
COW_LOGPROB_TOL = 0.1


def _serve_requests(model, seed: int, n: int = 8):
    """Phase 5's requests, drawn as phase 5 draws them: (prompt, new
    tokens, temperature, seed), half greedy, half at temperature 0.8."""
    rng = np.random.default_rng(seed)
    rng.integers(0, model.vocab_size, size=40)  # phase 5's warm-up
    lens = rng.integers(64, 513, size=8)
    return [(rng.integers(0, model.vocab_size, size=int(L)), 32,
             0.0 if i % 2 == 0 else 0.8, i)
            for i, L in enumerate(lens)][:n]


def _serve_engine(model, params, dev, **kw):
    from tpu_ddp_torch.serve.engine import ServeEngine
    kw.setdefault("decode_quant", "int8")
    return ServeEngine(model, params, device=dev, **kw)


def _zero_int8():
    from tpu_ddp_torch.ops.quant_matmul import int8_matmul
    int8_matmul.launches = dict.fromkeys(int8_matmul.launches, 0)


def _int8_launches() -> dict:
    from tpu_ddp_torch.ops.quant_matmul import int8_matmul
    return dict(int8_matmul.launches)


def _want_int8(eng, c0: dict) -> int:
    """The int8 launches the engine's pass counters since ``c0`` imply."""
    c = eng.metrics.counters
    d = {k: c.get(k, 0) - c0.get(k, 0) for k in
         ("serve_prefill_chunks", "serve_target_passes",
          "serve_draft_passes")}
    L = eng.model.num_layers
    target = 4 * L + 1 if eng.decode_quant == "int8" else 0
    draft_int8 = eng._spec_kind == "quant" or eng.decode_quant == "int8"
    draft = 4 * eng.draft_layers + 1 if draft_int8 else 0
    return (target * (d["serve_prefill_chunks"] + d["serve_target_passes"])
            + draft * d["serve_draft_passes"])


def _drive(eng, reqs, label: str, check=None) -> dict:
    """Submit ``reqs`` (prompt, new, temperature, seed[, tenant]) and step
    the engine to idle, ``check(eng)`` after every step; the int8
    launches of the run are held to the pass counters. Returns the
    handles and the run's numbers."""
    c0 = dict(eng.metrics.counters)
    torch.cuda.synchronize()
    _zero_int8()
    t0 = time.perf_counter()
    handles = [eng.submit(p, n, temperature=t, seed=s) for p, n, t, s
               in reqs]
    steps = 0
    while eng.step():
        steps += 1
        if check is not None:
            check(eng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _int8_launches()
    want = _want_int8(eng, c0)
    if launches != {"mma": want, "simt": 0}:
        fail(f"{label}: int8_matmul launched {launches} times by route; "
             f"the engine's pass counters give {want}, all on mma")
    for h in handles:
        if not h.done or h.quarantined or h.cancelled or h.shed:
            fail(f"{label}: request {h.rid} did not finish cleanly")
        if not all(math.isfinite(lp) for lp in h.logprobs):
            fail(f"{label}: request {h.rid} has non-finite logprobs")
    c = eng.metrics.counters
    tokens = sum(len(h.tokens) for h in handles)
    dsteps = c.get("serve_decode_steps", 0) - c0.get("serve_decode_steps",
                                                      0)
    return {"handles": handles, "wall_s": wall, "engine_steps": steps,
            "decode_steps": dsteps, "tokens": tokens,
            "tokens_per_s": tokens / wall,
            "tokens_per_engine_step": tokens / max(steps, 1),
            "tokens_per_decode_step": tokens / max(dsteps, 1),
            "prefill_chunks": c.get("serve_prefill_chunks", 0)
            - c0.get("serve_prefill_chunks", 0),
            "target_passes": c.get("serve_target_passes", 0)
            - c0.get("serve_target_passes", 0),
            "draft_passes": c.get("serve_draft_passes", 0)
            - c0.get("serve_draft_passes", 0),
            "int8_launches": launches["mma"]}


def _refs_ok(eng) -> None:
    if not eng.accounting_ok():
        fail(f"refcount accounting broken at engine step {eng._step_n} "
             f"(spec {eng.spec_draft} k={eng.spec_k}, prefix cache "
             f"{eng.prefix is not None}, tiers {eng.kv_tiers})")


def _summary(run: dict) -> dict:
    return {k: v for k, v in run.items() if k != "handles"}


def _top2_gap(model, params, prompt, tokens, pos: int) -> float:
    """The top-2 logit gap of the reference stream at emitted position
    ``pos``, from the decode-path forward over prompt + tokens."""
    from tpu_ddp_torch.ops.quant import decode_forward_logits
    seq = np.concatenate([np.asarray(prompt), np.asarray(tokens[:pos])])
    dev = params["embed"].device
    logits = decode_forward_logits(
        model, params, torch.as_tensor(seq, device=dev)[None])[0, -1]
    top = torch.topk(logits.double(), 2).values
    return float(top[0] - top[1])


def _compare_streams(ref, got, model=None, params=None) -> dict:
    """Two runs of the same requests: bit for bit, or else the first
    divergent position of each request and (given ``params``, the
    reference's decode dict) the reference's top-2 gap there."""
    out = {"bitwise": True, "diverged": []}
    for a, b in zip(ref, got):
        if a.tokens == b.tokens and a.logprobs == b.logprobs:
            continue
        out["bitwise"] = False
        n = min(len(a.tokens), len(b.tokens))
        first = next((i for i in range(n) if a.tokens[i] != b.tokens[i]),
                     None)
        lp = next(i for i in range(max(len(a.logprobs), len(b.logprobs)))
                  if i >= n or a.logprobs[i] != b.logprobs[i])
        row = {"rid": a.rid, "temperature": a.temperature,
               "first_token_diff": first, "first_logprob_diff": lp,
               "max_logprob_diff_before": max(
                   (abs(x - y) for x, y in zip(a.logprobs[:first or n],
                                               b.logprobs[:first or n])),
                   default=0.0)}
        if first is not None and params is not None:
            row["ref_top2_gap"] = _top2_gap(model, params, a.prompt,
                                            a.tokens, first)
        out["diverged"].append(row)
    return out


def _hold_near_tie(cmp: dict, label: str) -> None:
    """The fallback gate for streams meant to be bitwise: greedy tokens may
    part only at a near-tie of the reference (top-2 gap <= NEAR_TIE)."""
    for row in cmp["diverged"]:
        if row["temperature"] == 0 and row["first_token_diff"] is not None \
                and not row.get("ref_top2_gap", 1.0) <= NEAR_TIE:
            fail(f"{label}: greedy tokens part from the k=0 stream at a "
                 f"top-2 gap above {NEAR_TIE}: {row}")


def serve_spec(dev, model, params, seed: int) -> dict:
    """Phase 21: speculation on phase 5's 8 requests — k=0, chain at k=4
    (bit for bit), self-2 at k=4 on the int8 target, quant at k=4 against
    an fp bf16 k=0 stream, and a planted fault in the accept rule."""
    from tpu_ddp_torch.serve import engine as se
    from tpu_ddp_torch.serve.speculative import accept_length
    reqs = _serve_requests(model, seed)

    out, runs = {}, {}
    for label, kw in (("k0", {}),
                      ("chain", dict(spec_k=SPEC_K, spec_draft="chain")),
                      ("self2", dict(spec_k=SPEC_K, spec_draft="self-2")),
                      ("k0_fp", dict(decode_quant="none")),
                      ("quant", dict(spec_k=SPEC_K, spec_draft="quant",
                                     decode_quant="none"))):
        eng = _serve_engine(model, params, dev, **kw)
        run = _drive(eng, reqs, f"phase 21 {label}", _refs_ok)
        run["spec"] = eng.spec_stats()
        if label == "self2":
            qp = eng._decode_params
        del eng
        runs[label] = run
        out[label] = _summary(run)
        print(json.dumps({"spec_run": {label: out[label]}}), flush=True)
    h = {k: r["handles"] for k, r in runs.items()}
    chain = _compare_streams(h["k0"], h["chain"])
    if not chain["bitwise"]:
        fail(f"phase 21: the chain stream differs from k=0: {chain}")
    self2 = _compare_streams(h["k0"], h["self2"], model, qp)
    _hold_near_tie(self2, "phase 21 self-2")
    quant = _compare_streams(h["k0_fp"], h["quant"], model, params)
    _hold_near_tie(quant, "phase 21 quant")
    out.update(chain_vs_k0=chain, self2_vs_k0=self2, quant_vs_k0_fp=quant)
    # The planted fault: one more proposal accepted than the rule gives.
    def one_more(drafted, target, k):
        return min(accept_length(drafted, target, k) + 1, k)

    eng = _serve_engine(model, params, dev, spec_k=SPEC_K,
                        spec_draft="self-2")
    with mock.patch.object(se, "accept_length", one_more):
        faulty = _drive(eng, reqs, "phase 21 planted fault")
    del eng
    caught = _compare_streams(h["k0"], faulty["handles"])
    if caught["bitwise"]:
        fail("phase 21: accepting one more proposal than accept_length "
             "gives left the stream equal to k=0; the gate cannot see it")
    out["planted_fault"] = {"caught": True,
                            "requests_differing": len(caught["diverged"])}
    return out


def serve_prefix(dev, model, params, seed: int) -> dict:
    """Phase 22: the prefix cache on 8 requests sharing a 256-token system
    prompt (tails of 32-256 tokens, 32 new each) after one request
    carrying the bare system prompt ran to completion, against the same
    requests without the cache; then a 200-token system prompt with a
    request whose whole prompt is cached (the copy-on-write block)."""
    from tpu_ddp_torch.serve.loadgen import make_shared_prefix_workload
    out = {}
    for plen in (256, 200):
        specs = make_shared_prefix_workload(
            8, model.vocab_size, seed=seed, prefix_len=plen,
            tail_len=(32, 257), max_new=(32, 33))
        system = np.asarray(specs[0].prompt[:plen])
        reqs = [(np.asarray(sp.prompt), sp.max_new_tokens,
                 sp.temperature, sp.seed) for sp in specs]
        cow = []
        if plen == 200:
            # A prompt that is the cached blocks exactly: its last token
            # re-runs in a private copy of the last shared block.
            full = plen // 16 * 16
            cow = [(system[:full], 32, 0.0, 99)]
        res = {}
        for cached in (False, True):
            eng = _serve_engine(model, params, dev, prefix_cache=cached)
            warm = _drive(eng, [(system, 32, 0.0, 77)],
                          f"phase 22 warm-up ({plen}, cache {cached})")
            if cached:
                hits = [eng.prefix_cached_len(p) for p, *_ in reqs + cow]
                s0 = dict(eng.prefix.stats())
            run = _drive(eng, reqs + cow,
                         f"phase 22 ({plen}, cache {cached})", _refs_ok)
            run["warm_chunks"] = warm["prefill_chunks"]
            if cached:
                st = eng.prefix.stats()
                run["hits_tokens"] = hits
                run["stats"] = {k: st[k] - s0.get(k, 0) for k in
                                ("hit_requests", "cached_blocks_served",
                                 "tokens_saved")}
            res[cached] = run
            del eng
        off, on = res[False], res[True]
        bs = 16
        want_hit = plen // bs * bs
        if plen == 256:
            if on["hits_tokens"] != [want_hit] * 8:
                fail(f"phase 22: cached lengths {on['hits_tokens']}, "
                     f"expected {want_hit} for each of the 8")
            if on["stats"]["cached_blocks_served"] != 8 * (plen // bs):
                fail(f"phase 22: {on['stats']} blocks served, expected "
                     f"{8 * plen // bs}")
            saved = off["prefill_chunks"] - on["prefill_chunks"]
            if saved != 8 * plen // 32:
                fail(f"phase 22: {saved} prefill chunks saved, expected "
                     f"{8 * plen // 32} (8 x {plen} cached tokens)")
            cmp = _compare_streams(off["handles"], on["handles"])
            if not cmp["bitwise"]:
                fail(f"phase 22: prefix on differs from off: {cmp}")
        else:
            cmp = _compare_streams(off["handles"], on["handles"], model,
                                   _quantized(model, params))
            _hold_near_tie(cmp, "phase 22 (200-token prompt)")
            for row in cmp["diverged"]:
                if row["max_logprob_diff_before"] > COW_LOGPROB_TOL:
                    fail(f"phase 22: logprobs differ by more than "
                         f"{COW_LOGPROB_TOL}: {row}")
            if on["hits_tokens"][-1] != want_hit - 1:
                fail(f"phase 22: the copy-on-write request cached "
                     f"{on['hits_tokens'][-1]} tokens, expected "
                     f"{want_hit - 1}")
        out[f"system_{plen}"] = {
            "uncached": _summary(off), "cached": _summary(on),
            "chunks_saved": off["prefill_chunks"] - on["prefill_chunks"],
            "streams": cmp}
        print(json.dumps({"prefix": {plen: out[f"system_{plen}"]}}),
              flush=True)
    return out


def _quantized(model, params):
    from tpu_ddp_torch.ops.quant import quantize_params
    return quantize_params(model, params)


TENANT_CLASSES = "gold=3,bronze=1,batch=1:1"


def _stride_order(queue, weights) -> list:
    """The plain version of stride admission: the rids of ``queue``
    (request handles in submit order) in the order weighted fair queueing
    admits them, with no retirement or budget in the way."""
    passes, vtime, order = {}, 0.0, []
    queue = list(queue)
    while queue:
        heads = {}
        for r in queue:
            heads.setdefault(r.tenant, r)
        t = min(heads, key=lambda t: (passes.get(t, vtime),
                                      -weights.get(t, 1), heads[t].rid))
        r = heads[t]
        queue.remove(r)
        order.append(r.rid)
        p = max(passes.get(t, 0.0), vtime)
        vtime = p
        passes[t] = p + (len(r.prompt) + r.max_new_tokens) / \
            weights.get(t, 1)
    return order


def serve_tenants(dev, model, params, seed: int) -> dict:
    """Phase 23: tenant classes gold=3, bronze=1 and batch=1 with a 1 ms
    queue deadline; 24 requests submitted at once into 8 slots, queue
    limit 20."""
    from tpu_ddp_torch.serve.scheduler import parse_tenant_classes
    rng = np.random.default_rng(seed + 23)
    names = ("gold", "bronze", "batch")
    eng = _serve_engine(model, params, dev, tenant_classes=TENANT_CLASSES,
                        queue_limit=20)
    weights = {n: c.weight for n, c in
               parse_tenant_classes(TENANT_CLASSES).items()}
    admitted = []
    fill = eng.sched._fill_slot

    def record(i, req):
        ok = fill(i, req)
        if ok:
            admitted.append(req.rid)
        return ok

    c0 = dict(eng.metrics.counters)
    _zero_int8()
    t0 = time.perf_counter()
    handles = [eng.submit(rng.integers(0, model.vocab_size,
                                       size=int(rng.integers(32, 129))), 16,
                          seed=i, tenant=names[i % 3]) for i in range(24)]
    door = [h.rid for h in handles if h.shed]
    time.sleep(0.002)   # past batch's 1 ms deadline before the first step
    queued = [r for r in eng.sched.queue if r.tenant != "batch"]
    with mock.patch.object(eng.sched, "_fill_slot", record):
        while eng.step():
            if not (eng.accounting_ok() and eng.tenant_accounting_ok()):
                fail("phase 23: accounting broken")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _int8_launches()
    want = _want_int8(eng, c0)
    if launches != {"mma": want, "simt": 0}:
        fail(f"phase 23: int8_matmul launched {launches}, expected {want}")
    if len(door) != 4:
        fail(f"phase 23: {len(door)} requests shed at the door of a "
             f"20-deep queue holding 24, expected 4")
    by_rid = {h.rid: h for h in handles}
    if any(by_rid[r].tenant == "gold" for r in door):
        fail("phase 23: a gold request was shed at the door")
    batch = [h for h in handles if h.tenant == "batch"]
    if not all(h.shed and not h.tokens for h in batch):
        fail("phase 23: a batch request was not shed by its 1 ms deadline")
    expected = _stride_order(queued, weights)
    if admitted != expected:
        fail(f"phase 23: admission order {admitted}, stride scheduling "
             f"gives {expected}")
    per = {}
    for name in names:
        hs = [h for h in handles if h.tenant == name]
        c = eng.tenant_counts[name]
        if c["completed"] + c["cancelled"] + c["shed"] != c["submitted"] \
                or c["submitted"] != len(hs):
            fail(f"phase 23: tenant {name} ledger {c}")
        done = [h for h in hs if not h.shed]
        if not all(h.done and len(h.tokens) == 16 for h in done):
            fail(f"phase 23: a {name} request did not finish")
        ttft = sorted(h.ttft_s * 1e3 for h in done)
        per[name] = dict(c, ttft_ms_median=ttft[len(ttft) // 2]
                         if ttft else None,
                         ttft_ms_max=ttft[-1] if ttft else None)
    del eng
    return {"tenants": per, "door_shed": door, "admission_order": admitted,
            "wall_s": wall, "int8_launches": launches["mma"]}


# Phase 24's tier sizes in blocks of 16 tokens (slot 0 of each tier is its
# null page): 2 hot pages, one prefill chunk's two target blocks or the
# decode frontiers, so a chunk demotes the frontier the next decode
# promotes; 99 cold pages hold one 1552-token context (97 blocks) but not
# a decoding request's and the next prompt's together, so pages spill.
TIER_HBM_BLOCKS = 3
TIER_COLD_BLOCKS = 100


def serve_tiers(dev, model, params, seed: int) -> dict:
    """Phase 24: 4 requests of 1536 prompt tokens (16 new, greedy)
    through the single-tier pool, through kv_tiers=2 with a bf16 cold
    tier (2 hot pages: nearly all the live context cold; bit for bit),
    and through kv_tiers=3 with an int8 cold tier too small for two
    contexts (pages spill to the host)."""
    from tpu_ddp_torch.serve.loadgen import make_long_prompt_workload
    specs = make_long_prompt_workload(4, model.vocab_size, seed=seed,
                                      prompt_len=1536, max_new=(16, 17))
    reqs = [(np.asarray(sp.prompt), sp.max_new_tokens, sp.temperature,
             sp.seed) for sp in specs]
    cfgs = (("tiers1", {}),
            ("tiers2_bf16", dict(kv_tiers=2, kv_cold_dtype="bf16",
                                 hbm_blocks=TIER_HBM_BLOCKS)),
            ("tiers3_int8", dict(kv_tiers=3, kv_cold_dtype="int8",
                                 hbm_blocks=TIER_HBM_BLOCKS,
                                 cold_blocks=TIER_COLD_BLOCKS)))
    out, runs = {}, {}
    for label, kw in cfgs:
        eng = _serve_engine(model, params, dev, **kw)
        peak = {"spill": 0, "cold": 0, "hot": 0}

        def check(e):
            if not e.accounting_ok():
                fail(f"phase 24 {label}: tier accounting broken")
            tc = e.pool.tier_counts()
            for k in peak:
                peak[k] = max(peak[k], tc[k])

        run = _drive(eng, reqs, f"phase 24 {label}", check)
        pool = eng.pool
        page = model.num_layers * pool.block_size * model.kv_heads \
            * model.head_dim
        cold_page = page * (1 if pool.cold_dtype_name == "int8" else 2) \
            + model.num_layers * pool.block_size * 4
        run["moves"] = dict(pool.moves)
        run["peak_blocks"] = peak
        run["bytes"] = {
            "hot": 2 * pool.k.numel() * pool.k.element_size(),
            "cold": (2 * (pool.cold_k.numel() * pool.cold_k.element_size()
                          + pool.cold_sk.numel() * 4)
                     if pool.cold_k is not None else 0),
            "host_peak": 2 * peak["spill"] * cold_page,
            "live_context_peak": 2 * (peak["hot"] + peak["cold"]
                                      + peak["spill"]) * page
            * pool.k.element_size()}
        del eng
        runs[label] = run
        out[label] = _summary(run)
        print(json.dumps({"tiers": {label: out[label]}}), flush=True)
    h = {k: r["handles"] for k, r in runs.items()}
    bf = _compare_streams(h["tiers1"], h["tiers2_bf16"])
    if not bf["bitwise"]:
        fail(f"phase 24: kv_tiers=2 with bf16 cold pages differs from the "
             f"single tier: {bf}")
    r2 = runs["tiers2_bf16"]
    if not r2["peak_blocks"]["cold"] >= r2["peak_blocks"]["hot"]:
        fail(f"phase 24: under half the live context was cold: "
             f"{r2['peak_blocks']}")
    m3 = runs["tiers3_int8"]["moves"]
    if not (m3["demote"] > 0 and m3["promote"] > 0 and m3["spill"] > 0):
        fail(f"phase 24: kv_tiers=3 moved {m3}; every kind must be > 0")
    i8 = _compare_streams(h["tiers1"], h["tiers3_int8"], model,
                          _quantized(model, params))
    agree = [sum(a == b for a, b in zip(x.tokens, y.tokens)) / len(x.tokens)
             for x, y in zip(h["tiers1"], h["tiers3_int8"])]
    out.update(bf16_vs_tiers1=bf, int8_vs_tiers1=i8,
               int8_greedy_agreement=agree)
    return out


def serve_checkpoint(dev, model, saved: dict) -> dict:
    """Phase 25: the LM-large checkpoint phase 20 wrote, served through
    ``ServeEngine.from_checkpoint``, against an engine built on the same
    params in memory: the streams equal bit for bit."""
    from tpu_ddp_torch.serve.engine import ServeEngine
    reqs = _serve_requests(model, 25, n=4)
    t0 = time.perf_counter()
    eng = ServeEngine.from_checkpoint(model, saved["dir"],
                                      decode_quant="int8", device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    mem = _to_device_tree(saved["params"], dev)
    for name, a, b in _paired_leaves(eng.params, mem):
        if not torch.equal(a, b):
            fail(f"phase 25: restored leaf {name} differs from the saved")
    got = _drive(eng, reqs, "phase 25 from_checkpoint")
    del eng
    ref_eng = _serve_engine(model, mem, dev)
    ref = _drive(ref_eng, reqs, "phase 25 in memory")
    del ref_eng
    cmp = _compare_streams(ref["handles"], got["handles"])
    if not cmp["bitwise"]:
        fail(f"phase 25: the checkpoint's stream differs: {cmp}")
    return {"load_s": load_s, "step": saved["step"],
            "from_checkpoint": _summary(got), "in_memory": _summary(ref),
            "bitwise": True}


def _to_device_tree(tree, dev):
    """A detached copy of a parameter tree on ``dev``."""
    if isinstance(tree, dict):
        return {k: _to_device_tree(v, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_device_tree(v, dev) for v in tree)
    return tree.detach().to(dev, copy=True)


def _paired_leaves(a, b, prefix=""):
    if isinstance(a, dict):
        for k in a:
            yield from _paired_leaves(a[k], b[k], f"{prefix}/{k}")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _paired_leaves(x, y, f"{prefix}/{i}")
    else:
        yield prefix, a, b


def serve_load(dev, model, params, seed: int) -> dict:
    """Phase 26: ``calibrate_rate`` on 16 requests of ``make_workload``,
    then ``run_load`` at half the calibrated rate."""
    from tpu_ddp_torch.serve.loadgen import (calibrate_rate, make_workload,
                                             run_load)
    specs = make_workload(16, model.vocab_size, seed=seed,
                          prompt_len=(64, 257), max_new=(16, 33))
    eng = _serve_engine(model, params, dev)
    rate = calibrate_rate(lambda: eng, specs)
    c0 = dict(eng.metrics.counters)
    _zero_int8()
    res = run_load(eng, specs, rate / 2, seed=seed)
    torch.cuda.synchronize()
    launches = _int8_launches()
    want = _want_int8(eng, c0)
    if launches != {"mma": want, "simt": 0}:
        fail(f"phase 26: int8_matmul launched {launches}, expected {want}")
    if not (res["accounting_ok"] and res["n_completed"] == len(specs)
            and eng.accounting_ok()
            and eng.pool.free_count == eng.pool.total_usable):
        fail(f"phase 26: completion or accounting failed: {res}")
    del eng
    return dict(res, calibrated_rate_rps=rate, int8_launches=launches["mma"])


# ---- phases 27-30: the training recipe on one card ----------------------

# Phase 27: TransformerLM-large trained with the JAX package's whole
# single-card recipe: Adafactor (relative step size), a global-norm clip
# of 1.0, dropout 0.1, the chunked-vocab loss in chunks of 4000 and
# remat="dots".
RECIPE_CLIP, RECIPE_CHUNK, RECIPE_DROPOUT = 1.0, 4000, 0.1
# Phase 28: (remat, act_dtype, vocab_chunk) settings on LM-large with
# AdamW and dropout off; one untimed step (its loss on the shared start
# weights), then POLICY_STEPS timed steps.
POLICY_MATRIX = (("none", "compute", 0), ("blocks", "compute", 0),
                 ("dots", "compute", 0), ("none", "f32", 0),
                 ("blocks", "f32", 0), ("dots", "f32", 0),
                 ("none", "compute", RECIPE_CHUNK),
                 ("dots", "compute", RECIPE_CHUNK))
POLICY_STEPS = 3
EXAMPLE_TIMEOUT_S = 300


def _lm_large(dev, **kw):
    from tpu_ddp_torch.models.transformer import make_transformer
    return make_transformer("TransformerLM-large", max_seq_len=LM_SEQ,
                            use_flash=True, **kw)


def _lm_tokens(model, dev_trainer):
    from tpu_ddp_torch.train.lm import make_lm_batch
    tokens = np.random.default_rng(0).integers(
        0, model.vocab_size, size=(LM_BATCH, LM_SEQ + 1))
    return dev_trainer.put_batch(*make_lm_batch(tokens))


@contextlib.contextmanager
def _first_sweep_inputs(fa):
    """Within the block, the first ``flash_bwd_kv`` call's (q, k, v, dO,
    causal): the LM's last layer. Read from the sweep's arguments, not
    ``ctx.saved_tensors``, which a checkpoint region unpacks only once."""
    real, out = fa.flash_bwd_kv, {}

    def capture(q, k, v, do, lse, delta, causal=False):
        if not out:
            out.update(q=q.detach(), k=k.detach(), v=v.detach(),
                       do=do.detach(), causal=causal)
        return real(q, k, v, do, lse, delta, causal)

    # The wrapper counts through its module name: the same dict.
    capture.launches = real.launches
    with mock.patch.object(fa, "flash_bwd_kv", capture):
        yield out


def _recipe_step_check(tr, state, x, y) -> dict:
    """One step's loss and gradients through the kernels against the same
    through the plain versions, with dropout on and the same masks (one
    key: the masks are a function of it), held with phase 16's bounds,
    and the three flash kernels on the last layer's own q, k, v and dO
    from that step, row by row, each gradient bound catching the planted
    fault there (phase 16's ``_last_layer_check``). The planted fault in
    every layer's forward is reported against the loss bound, not held:
    at these weights it moves the loss by less than the kernels may."""
    from tpu_ddp_torch.ops import flash_attention as fa
    from tpu_ddp_torch.utils.tree import tree_leaves
    leaves = tree_leaves(state.params)
    rng = tr.step_key(state.step)
    plain = dict(flash_bwd_kv=fa.flash_bwd_kv_plain,
                 flash_bwd_q=fa.flash_bwd_q_plain)

    def faulty_fwd(q, k, v, causal):
        o, lse = fa.flash_fwd_plain(q, k, v, causal)
        f = _dropped_tile(q, k, v, None, {"o": o, "lse": lse})
        return f["o"], f["lse"]

    with _first_sweep_inputs(fa) as last:
        lk, gk = tr._loss_and_grads(leaves, state.params, x, y, rng)
    with mock.patch.multiple(fa, flash_fwd=fa.flash_fwd_plain, **plain):
        lp, gp = tr._loss_and_grads(leaves, state.params, x, y, rng)
    grad = max(float((a.float() - b.float()).norm()
                     / b.float().norm().clamp_min(1e-30))
               for a, b in zip(gk, gp))
    del gk, gp
    with mock.patch.multiple(fa, flash_fwd=faulty_fwd, **plain):
        lf, _ = tr._loss_and_grads(leaves, state.params, x, y, rng)
    torch.cuda.synchronize()
    lk, lp, lf = float(lk), float(lp), float(lf)
    loss_k, loss_f = abs(lk - lp) / abs(lp), abs(lf - lp) / abs(lp)
    if not (math.isfinite(lk) and loss_k <= LM_STEP_TOL["loss"]):
        fail(f"phase 27 step loss: kernels {lk} vs plain {lp} (tol "
             f"{LM_STEP_TOL['loss']} rel)")
    if not grad <= LM_STEP_TOL["grad"]:
        fail(f"phase 27 step grads: worst leaf's relative Frobenius error "
             f"{grad} > {LM_STEP_TOL['grad']}")
    with torch.no_grad():
        last_layer = _last_layer_check(fa, last)
    return {"loss_kernels": lk, "loss_plain": lp, "loss_rel_diff": loss_k,
            "grad_worst_leaf_frob": grad, "tol": LM_STEP_TOL,
            "planted_fault_loss_rel_diff": loss_f,
            "planted_fault_caught_by_loss_bound":
                loss_f > LM_STEP_TOL["loss"],
            "last_layer_attention": last_layer}


def train_recipe(dev, seed: int) -> dict:
    """Phase 27: TransformerLM-large through ``LMTrainer`` with Adafactor,
    clip 1.0, dropout 0.1, ``vocab_chunk=4000`` and ``remat="dots"``,
    batch 4 x seq 2048, bf16, flash on."""
    from tpu_ddp_torch.ops.optim import Adafactor
    from tpu_ddp_torch.train.lm import LMTrainer
    from tpu_ddp_torch.utils.flops import transformer_fwd_flops
    model = _lm_large(dev, remat="dots", dropout_rate=RECIPE_DROPOUT)
    tr = LMTrainer(model, device=dev, optimizer=Adafactor(),
                   clip_grad_norm=RECIPE_CLIP, vocab_chunk=RECIPE_CHUNK,
                   dropout_seed=seed)
    x, y = _lm_tokens(model, tr)
    state = tr.init_state(seed=seed)
    losses = []
    for _ in range(LM_WARMUP):
        state, loss = tr.train_step(state, x, y)
        losses.append(float(loss))
    torch.cuda.reset_peak_memory_stats(dev)
    wrappers = _flash_wrappers()
    _zero_launches(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = []
    for _ in range(LM_STEPS):
        state, loss = tr.train_step(state, x, y)
        timed.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / LM_STEPS
    counts = _launches(wrappers)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    losses += [float(v) for v in timed]
    n = model.num_layers * LM_STEPS
    # "dots" runs each layer's flash forward again in the recompute.
    want = _flash_want(2 * n, n)
    if counts != want:
        fail(f"phase 27 launch counts {counts}, expected {want}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"phase 27 losses not finite: {losses}")
    fwd_flops = transformer_fwd_flops(model, LM_BATCH, LM_SEQ)
    check = _recipe_step_check(tr, state, x, y)
    return {"recipe": {"optimizer": "Adafactor()", "clip": RECIPE_CLIP,
                       "dropout": RECIPE_DROPOUT,
                       "vocab_chunk": RECIPE_CHUNK, "remat": "dots"},
            "batch": LM_BATCH, "seq": LM_SEQ, "warmup_steps": LM_WARMUP,
            "timed_steps": LM_STEPS, "losses": losses, "launches": counts,
            "ms_per_step": step_s * 1e3,
            "tokens_per_s": LM_BATCH * LM_SEQ / step_s,
            "mfu": 3 * fwd_flops / step_s / BF16_FLOP_PER_S,
            "peak_mem_gib": peak, "step_check": check}


def policy_matrix(dev, seed: int) -> dict:
    """Phase 28: peak memory and ms per step of LM-large (AdamW, dropout
    off) under each (remat, act_dtype, vocab_chunk) of POLICY_MATRIX, all
    from the same start weights; the step-1 losses of none, blocks and
    dots (act_dtype compute) within 1e-5 relative, the act_dtype and
    chunk differences reported."""
    from tpu_ddp_torch.train.lm import LMTrainer
    from tpu_ddp_torch.utils.tree import tree_leaves
    start = _lm_large(dev).init(torch.Generator(device=dev).manual_seed(
        seed))
    host = [p.detach().to("cpu", copy=True) for p in tree_leaves(start)]
    out, counts_by = {}, {}
    for remat, act, chunk in POLICY_MATRIX:
        model = _lm_large(dev, remat=remat, act_dtype=act)
        tr = LMTrainer(model, device=dev, vocab_chunk=chunk)
        with torch.no_grad():
            for p, h in zip(tree_leaves(start), host):
                p.copy_(h)
        state = tr.init_state(params=start)
        x, y = _lm_tokens(model, tr)
        state, loss1 = tr.train_step(state, x, y)
        loss1 = float(loss1)
        torch.cuda.reset_peak_memory_stats(dev)
        wrappers = _flash_wrappers()
        _zero_launches(wrappers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(POLICY_STEPS):
            state, loss = tr.train_step(state, x, y)
        last = float(loss)
        step_s = (time.perf_counter() - t0) / POLICY_STEPS
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        counts = _launches(wrappers)
        n = model.num_layers * POLICY_STEPS
        want = _flash_want(n if remat == "none" else 2 * n, n)
        if counts != want:
            fail(f"phase 28 {remat}/{act}/{chunk}: launch counts {counts},"
                 f" expected {want}")
        if not (math.isfinite(loss1) and math.isfinite(last)):
            fail(f"phase 28 {remat}/{act}/{chunk}: losses {loss1}, {last}")
        key = f"{remat}_{act}_chunk{chunk}"
        counts_by[key] = counts
        out[key] = {"step1_loss": loss1, "last_loss": last,
                    "ms_per_step": step_s * 1e3,
                    "tokens_per_s": LM_BATCH * LM_SEQ / step_s,
                    "peak_mem_gib": peak}
        del tr, state
        torch.cuda.empty_cache()
    ref = out["none_compute_chunk0"]["step1_loss"]
    rel = {k: abs(v["step1_loss"] - ref) / abs(ref) for k, v in out.items()}
    for k in ("blocks_compute_chunk0", "dots_compute_chunk0"):
        if not rel[k] <= 1e-5:
            fail(f"phase 28 step-1 loss of {k} differs from none's by "
                 f"{rel[k]} relative (tol 1e-5)")
    return {"steps": POLICY_STEPS, "settings": out,
            "step1_loss_rel_diff_vs_none": rel, "launches": counts_by}


def _record_bn_stats(tb):
    """Within the block, every ``bn_stats`` call's (input, mean, inv)."""
    calls, real = [], tb.bn_stats

    def recorded(x2d, eps=tb.BN_EPS):
        mean, inv = real(x2d, eps)
        calls.append((x2d.detach().clone(), mean.clone(), inv.clone()))
        return mean, inv

    recorded.launches = real.launches  # counted through the module name
    return calls, mock.patch.object(tb, "bn_stats", recorded)


def vgg_policy(dev) -> dict:
    """Phase 29: VGG-11 part 1 through ``run_part`` under
    ``TPU_DDP_REMAT=blocks`` and ``conv_stages`` (40 iterations each, both
    kernels): exact launch counts with the recompute; then, on a
    ``Trainer`` under ``blocks`` with ``clip_grad_norm=1.0`` and cuDNN
    deterministic, the recomputed BN statistics equal the forward's bits,
    and one step through the kernels is held to the plain versions."""
    import itertools

    from tpu_ddp_torch.data.loader import create_data_loaders
    from tpu_ddp_torch.models.vgg import get_model
    from tpu_ddp_torch.ops import bn_relu as tb
    from tpu_ddp_torch.ops import sgd as tsgd
    from tpu_ddp_torch.train.engine import Trainer
    from tpu_ddp_torch.utils.config import TrainConfig
    runs = {}
    for remat in ("blocks", "conv_stages"):
        wrappers = {**_bn_wrappers(), "sgd": tsgd.fused_sgd_step}
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_launches(wrappers)
        out = _part1(dev, [], TPU_DDP_MAX_ITERS=TRAIN_ITERS,
                     TPU_DDP_REMAT=remat)
        counts = _launches(wrappers)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        losses = [(int(i), float(v)) for i, v in
                  re.findall(r"\[epoch 0, iter (\d+)\] loss: (\S+)", out)]
        if [i for i, _ in losses] != [20, 40] or not all(
                math.isfinite(v) for _, v in losses):
            fail(f"phase 29 {remat}: loss lines wrong or not finite: "
                 f"{losses}")
        seen = int(re.search(r"accuracy \d+/(\d+)", out).group(1))
        steps, evals = TRAIN_ITERS, math.ceil(seen / 256)
        # Each step's backward runs every unit's forward kernels again.
        fwd = 8 * (2 * steps + evals)
        want = {"sgd": steps, **_bn_bwd_want(8 * steps),
                "bn_stats": {"one_pass": fwd, "two_stage": 0},
                "bn_norm_relu": fwd}
        if counts != want:
            fail(f"phase 29 {remat}: launch counts {counts}, expected "
                 f"{want}")
        avg_ms = _timer_ms(out)
        runs[remat] = {"losses": losses, "launches": counts,
                       "avg_iter_ms": avg_ms,
                       "images_per_s": 256 / (avg_ms / 1e3),
                       "peak_mem_gib": peak}

    cfg = TrainConfig.preset("vgg11_cifar10", pallas_sgd=True,
                             pallas_bn=True, remat="blocks")
    model = get_model(cfg.model, use_pallas_bn=True,
                      compute_dtype=getattr(torch, cfg.compute_dtype))
    tr = Trainer(model, cfg, device=dev, clip_grad_norm=1.0)
    state = tr.init_state()
    train, _ = create_data_loaders(batch_size=256, synthetic_size=768)
    batches = list(itertools.islice(iter(train), 3))
    for x, y in batches[:2]:
        state, loss = tr.train_step(state, x, y)
    x, y = batches[2]
    with torch.no_grad():
        p0 = [p.clone() for p in state.params]
        m0 = [b.clone() for b in state.opt_state["momentum"]]
    calls, patch = _record_bn_stats(tb)
    with _deterministic_cudnn(), patch:
        state, lk = tr.train_step(state, x, y)
    units = len(model.features)
    if len(calls) != 2 * units:
        fail(f"phase 29: {len(calls)} bn_stats calls in a blocks step, "
             f"expected {2 * units}")
    for xr, mean, inv in calls[units:]:
        fwd = [c for c in calls[:units] if torch.equal(c[0], xr)]
        if len(fwd) != 1:
            fail("phase 29: a recomputed BN input differs from every "
                 "forward input")
        if not (_same_bits(fwd[0][1], mean) and _same_bits(fwd[0][2], inv)):
            fail("phase 29: recomputed BN statistics differ from the "
                 "forward's bits")
    del calls
    with torch.no_grad():
        pk = [p.clone() for p in state.params]
        for p, a in zip(state.params, p0):
            p.copy_(a)
        for b, a in zip(state.opt_state["momentum"], m0):
            b.copy_(a)
    # The plain step under the same cuDNN algorithms as the kernels' step,
    # so the two differ only where the kernels do.
    with mock.patch.multiple(tb, bn_stats=tb.bn_stats_ref,
                             bn_norm_relu=tb.bn_norm_relu_ref,
                             bn_bwd_stats=tb.bn_bwd_stats_ref,
                             bn_bwd_dx=tb.bn_bwd_dx_ref), \
            mock.patch.object(tsgd, "fused_sgd_step",
                              tsgd.fused_sgd_step_ref), \
            _deterministic_cudnn():
        state, lp = tr.train_step(state, x, y)
    torch.cuda.synchronize()
    lk, lp = float(lk), float(lp)
    with torch.no_grad():
        update = max(float((a - b).abs().max()) for a, b in zip(pk, p0))
        diffs = [float((a - b).abs().max())
                 for a, b in zip(pk, state.params)]
    diff = max(diffs)
    worst = [n for n, _ in model.named_parameters()][diffs.index(diff)]
    if not (math.isfinite(lk) and abs(lk - lp) <= 1e-2 * abs(lp)):
        fail(f"phase 29 step loss: kernels {lk} vs plain {lp} (tol 1e-2)")
    if not diff <= 5e-2 * update:
        fail(f"phase 29 step params: kernels vs plain max|d|={diff} > "
             f"5e-2 x largest update {update}")
    return {"runs": runs, "recomputed_stats_bit_equal": True,
            "bn_stats_calls_per_step": 2 * units,
            "clip_step_check": {"clip": 1.0, "loss_kernels": lk,
                                "loss_plain": lp, "max_param_diff": diff,
                                "worst_param": worst,
                                "largest_update": update,
                                "tol": 5e-2 * update}}


def _start_example(module: str, argv, env: dict) -> tuple:
    """Start ``python -m module argv`` on the card in a session of its
    own; returns ``(process, start time)`` for :func:`_finish_example`."""
    run_env = {k: v for k, v in os.environ.items()
               if not k.startswith("TPU_DDP_")}
    run_env.update(env, PYTHONPATH=os.path.dirname(os.path.abspath(
        __file__)))
    return subprocess.Popen([sys.executable, "-m", module, *argv],
                            env=run_env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True), time.perf_counter()


def _finish_example(started, phase: str,
                    timeout: float = EXAMPLE_TIMEOUT_S) -> tuple[str, float]:
    """Wait for a :func:`_start_example` process (stopped with its
    children past ``timeout`` seconds from its start); fails unless it
    exits 0. Returns its output and wall seconds."""
    proc, t0 = started
    try:
        out, _ = proc.communicate(
            timeout=max(timeout - (time.perf_counter() - t0), 1.0))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        fail(f"{phase}: {proc.args[2]} ran past {timeout} s")
    if proc.returncode != 0:
        fail(f"{phase}: {proc.args[2]} exited {proc.returncode}:\n"
             f"{out[-3000:]}")
    return out, time.perf_counter() - t0


def _example(module: str, argv, env: dict) -> tuple[str, float]:
    """Run ``python -m module argv`` on the card to its end (phase 30)."""
    return _finish_example(_start_example(module, argv, env), "phase 30")


def examples_on_card(dev) -> dict:
    """Phase 30: the two example entry points as subprocesses on the
    card: ``lm_text_train`` (falling epoch losses and a sample) and
    ``lm_train`` with ``TPU_DDP_LM_OPT=adafactor TPU_DDP_LM_CLIP=1.0`` at
    TransformerLM-large's width (finite, falling losses)."""
    out, wall_text = _example("tpu_ddp_torch.examples.lm_text_train", [],
                              {})
    epochs = [float(v) for v in re.findall(r"mean loss (\S+)", out)]
    sample = re.search(r"\[lm_text\] sample: (.*)", out)
    if not (len(epochs) == 3 and all(math.isfinite(v) for v in epochs)
            and all(b < a for a, b in zip(epochs, epochs[1:]))
            and sample is not None):
        fail(f"phase 30: lm_text_train epoch losses {epochs}, sample "
             f"{sample}:\n{out[-2000:]}")
    port = socket.socket()
    port.bind(("127.0.0.1", 0))
    free = str(port.getsockname()[1])
    port.close()
    out2, wall_lm = _example(
        "tpu_ddp_torch.examples.lm_train",
        ["--num-nodes", "1", "--master-ip", "127.0.0.1", "--master-port",
         free],
        {"TPU_DDP_LM_OPT": "adafactor", "TPU_DDP_LM_CLIP": "1.0",
         "TPU_DDP_LM_PRESET": "TransformerLM-large"})
    steps = [float(v) for v in re.findall(r"step \d+/\d+ loss (\S+)", out2)]
    if not ("opt=adafactor" in out2 and "clip=1.0" in out2 and steps
            and all(math.isfinite(v) for v in steps)
            and steps[-1] < steps[0]):
        fail(f"phase 30: lm_train losses {steps}:\n{out2[-2000:]}")
    return {"lm_text_train": {"epoch_losses": epochs,
                              "sample": sample.group(1), "wall_s": wall_text},
            "lm_train": {"preset": "TransformerLM-large",
                         "opt": "adafactor", "clip": 1.0, "losses": steps,
                         "wall_s": wall_lm}}


# ---- phases 31-34: the rest of the data-parallel ladder -----------------


def _ladder_run(dev, part: str) -> dict:
    """One part through ``run_part`` at world 1 (parts 4 and 5 over NCCL
    on a group of one), both kernels, 40 iterations, as phase 10."""
    from tpu_ddp_torch.ops import sgd as tsgd
    wrappers = {**_bn_wrappers(), "sgd": tsgd.fused_sgd_step}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launches(wrappers)
    rc, out, wall = _run_part_captured(part, ["--num-nodes", "1",
                                              "--device", str(dev)])
    counts = _launches(wrappers)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if rc != 0:
        fail(f"phase 31: run_part('{part}') returned {rc}")
    losses = re.findall(r"\[epoch 0, iter \d+\] loss: \S+", out)
    test = re.search(r"Test set: average loss (\S+), accuracy (\d+)/(\d+)",
                     out)
    timer = re.search(r"timing over iterations 1-39: total (\d+) ns, "
                      r"average (\d+) ns", out)
    if len(losses) != 2 or test is None or timer is None:
        fail(f"phase 31: {part} printed no loss, Test set or timer "
             f"lines:\n{out[-2000:]}")
    steps = TRAIN_ITERS
    eval_batches = math.ceil(int(test.group(3)) / 256)
    want = {"sgd": steps, **_bn_bwd_want(8 * steps),
            "bn_stats": {"one_pass": 8 * (steps + eval_batches),
                         "two_stage": 0},
            "bn_norm_relu": 8 * (steps + eval_batches)}
    if counts != want:
        fail(f"phase 31: {part} launch counts {counts}, expected {want}")
    avg_ms = int(timer.group(2)) / 1e6
    return {"loss_lines": losses, "test_line": test.group(0),
            "launches": counts, "avg_iter_ms": avg_ms,
            "images_per_s": 256 / (avg_ms / 1e3), "peak_mem_gib": peak,
            "wall_s": wall}


LADDER_TURNS = ("part1", "part4", "part5", "part5", "part4", "part1")


def ladder_parts(dev) -> dict:
    """Phase 31: parts 1, 4 and 5 at full width, world 1, the same seed
    and cuDNN deterministic: at one rank ZeRO's and FSDP's layouts are
    the identity, so their loss and test lines must be part 1's bits."""
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.update(TPU_DDP_PALLAS_SGD="1", TPU_DDP_PALLAS_BN="1",
                      TPU_DDP_MAX_ITERS=str(TRAIN_ITERS),
                      TPU_DDP_SYNTH_SIZE=str(SYNTH_SIZE))
    runs = {}
    # In turns (1, 4, 5, 5, 4, 1): the host-bound iteration drifts within
    # a run, so each part's two readings straddle the others'.
    with _env(TPU_DDP_CUDNN_DETERMINISTIC="1"), _deterministic_cudnn():
        for part in LADDER_TURNS:
            runs.setdefault(part, []).append(_ladder_run(dev, part))
    ref = runs["part1"][0]
    for part, rs in runs.items():
        for r in rs:
            if (r["loss_lines"], r["test_line"]) != (ref["loss_lines"],
                                                     ref["test_line"]):
                fail(f"phase 31: {part} {r['loss_lines']} {r['test_line']}"
                     f" != part1 {ref['loss_lines']} {ref['test_line']}")
            if r["launches"] != ref["launches"]:
                fail(f"phase 31: {part} launches {r['launches']}")
    out = {}
    for part, rs in runs.items():
        ms = float(np.mean([r["avg_iter_ms"] for r in rs]))
        out[part] = {"loss_lines": rs[0]["loss_lines"],
                     "test_line": rs[0]["test_line"],
                     "launches": rs[0]["launches"],
                     "avg_iter_ms_turns": [r["avg_iter_ms"] for r in rs],
                     "avg_iter_ms": ms, "images_per_s": 256 / (ms / 1e3),
                     "peak_mem_gib": max(r["peak_mem_gib"] for r in rs),
                     "wall_s": sum(r["wall_s"] for r in rs)}
    return out


def _vgg_leaves(dev):
    from tpu_ddp_torch.convert import CanonicalView
    from tpu_ddp_torch.models.vgg import make_vgg
    model = make_vgg("VGG11").to(dev)
    canon = CanonicalView(model)
    return canon, [t.detach().contiguous()
                   for t in canon.leaves(list(model.parameters()))]


def _layout_checks(dev) -> dict:
    """Shards of VGG-11 and LM-large cut on the card against the CPU's:
    VGG-11 every rank at N = 1, 3, 4 bit for bit with the host layout;
    LM-large every rank's shards reassembled on the card bit for bit
    into the leaves, and the first, largest and padded leaves' shards
    bit for bit with the CPU's."""
    from tpu_ddp_torch.models.transformer import make_transformer
    from tpu_ddp_torch.parallel.zero import _FlatLayout
    from tpu_ddp_torch.utils.tree import tree_leaves
    _, vgg = _vgg_leaves(dev)
    host = [t.cpu().numpy() for t in vgg]
    out = {}
    for n in (1, 3, 4):
        for r in range(n):
            lay = _FlatLayout([t.shape for t in vgg], axis_size=n, rank=r)
            buf, _ = lay.local_shards(vgg)
            want = lay.local_host(lay.shard_params(host))
            if not np.array_equal(buf.cpu().numpy(), want):
                fail(f"phase 32: VGG-11 shard of rank {r}/{n} differs "
                     "from the CPU's")
        back = lay.leaves_of_rows(lay.rows(vgg))
        if not all(torch.equal(a, b) for a, b in zip(back, vgg)):
            fail(f"phase 32: VGG-11 rows at N={n} do not round-trip")
    out["vgg11_leaves"] = len(vgg)
    model = make_transformer("TransformerLM-large")
    lm = tree_leaves(model.init(torch.Generator(device=dev).manual_seed(0)))
    sizes = [t.numel() for t in lm]
    for n in (1, 3, 4):
        lay = _FlatLayout([t.shape for t in lm], axis_size=n)
        padded = [i for i, s in enumerate(sizes) if s % n][:2]
        probe = sorted({0, int(np.argmax(sizes)), *padded})
        shards = []
        for r in range(n):
            lay.rank = r
            buf, views = lay.local_shards(lm)
            for i in probe:
                c = lay.chunks[i]
                ref = np.pad(lm[i].cpu().numpy().reshape(-1),
                             (0, c * n - sizes[i]))[r * c:(r + 1) * c]
                if not np.array_equal(views[i].cpu().numpy(), ref):
                    fail(f"phase 32: LM-large leaf {i} shard of rank "
                         f"{r}/{n} differs from the CPU's")
            shards.append(buf)
        back = lay.leaves_of_rows(torch.stack(shards))
        if not all(torch.equal(a, b) for a, b in zip(back, lm)):
            fail(f"phase 32: LM-large shards at N={n} do not reassemble")
        del shards, back
    out["lm_large_leaves"] = len(lm)
    out["lm_large_params"] = sum(sizes)
    return out


def _quantizer_checks(dev) -> dict:
    """The int8 wire's quantizer on the card: the same bits as the CPU's,
    the round trip within one block step, zeros exact, unbiased over 64
    draws, and a planted bias (noise shifted by a quarter step) caught by
    the bound."""
    from tpu_ddp_torch.parallel.compress import GradCompressor
    comp = GradCompressor("int8", block_size=256)
    g = torch.Generator(device=dev).manual_seed(3)
    x = (torch.randn(64, 4096, generator=g, device=dev)
         * torch.logspace(-3, 4, 64, device=dev)[:, None])

    def key(seed, leaf=0):
        return GradCompressor.key(
            torch.tensor(seed, dtype=torch.int64, device=dev), 0, leaf)

    u = comp.uniform(x.shape, key(1))
    q, s = comp.quant(x, u)
    qc, sc = comp.quant(x.cpu(), comp.uniform(x.shape, key(1).cpu()))
    if not (torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)):
        fail("phase 32: int8 quantizer bits differ between card and CPU")
    err = (comp.dequant(q, s) - x).abs()
    step = s.repeat_interleave(256, dim=-1)
    if not bool((err <= step * (1 + 1e-6)).all()):
        fail("phase 32: int8 round trip beyond one block step")
    zq, zs = comp.quant(torch.zeros(4096, device=dev),
                        comp.uniform((4096,), key(5)))
    if bool(zq.any()) or bool(comp.dequant(zq, zs).any()):
        fail("phase 32: int8 zeros do not quantize exactly")
    row = x[10]

    def mean_err(shift):
        acc = torch.zeros_like(row)
        for k in range(64):
            qq, ss = comp.quant(row, comp.uniform(row.shape, key(7, k))
                                + shift)
            acc += comp.dequant(qq, ss) - row
        _, ss = comp.quant(row, comp.uniform(row.shape, key(7)))
        return acc / 64 / ss.repeat_interleave(256)

    e, bad = mean_err(0.0), mean_err(0.25)
    unbiased = {"max_abs_steps": float(e.abs().max()),
                "mean_steps": float(e.mean()),
                "planted_mean_steps": float(bad.mean())}
    # 64 draws: std <= 1/16 step per element (max of 4096 under 0.3),
    # the average over 4096 elements under 0.01; the planted bias 0.25.
    if not (unbiased["max_abs_steps"] < 0.3
            and abs(unbiased["mean_steps"]) < 0.01):
        fail(f"phase 32: int8 rounding biased {unbiased}")
    if not unbiased["planted_mean_steps"] > 0.2:
        fail(f"phase 32: the bias bound misses a planted bias {unbiased}")
    return unbiased


def _wire_and_overlap_checks(dev) -> dict:
    """On a group of one over NCCL: the bf16 wire's two phases and the
    int8 phase 1 on the card against the CPU's arithmetic, and
    ``OverlapSync`` on VGG-11 (4 MiB buckets): the buckets launch in
    reverse order from the hooks inside the backward, and the bucketed
    gradients equal the unbucketed ones bit for bit."""
    import torch.distributed as dist

    from tpu_ddp_torch.convert import CanonicalView
    from tpu_ddp_torch.models.vgg import make_vgg
    from tpu_ddp_torch.parallel.compress import GradCompressor
    from tpu_ddp_torch.parallel.overlap import BucketPlan, OverlapSync
    group = dist.group.WORLD
    x = torch.randn(1 << 20, device=dev)
    bf = GradCompressor("bf16")
    p1 = bf.phase1_finish(bf.phase1_launch(x, x.numel(), group))
    full, _ = bf.phase2(p1, group)
    want = x.cpu().to(torch.bfloat16).float()
    if not (torch.equal(p1.cpu(), want) and torch.equal(full.cpu(), want)):
        fail("phase 32: the bf16 wire's bits differ from the CPU cast")
    i8 = GradCompressor("int8")
    k = GradCompressor.key(torch.tensor(9, dtype=torch.int64, device=dev),
                           0, 0)
    pend = i8.phase1_launch(x, x.numel(), group, k)
    m = i8.phase1_finish(pend)
    q, s = i8.quant(x.cpu().view(1, -1), i8.uniform((1, x.numel()),
                                                   k.cpu()))
    if not torch.equal(m.cpu(), i8.dequant(q, s).view(-1)):
        fail("phase 32: the int8 phase 1 differs from the CPU's")

    model = make_vgg("VGG11").to(dev)
    canon = CanonicalView(model)
    params = list(model.parameters())
    plan = BucketPlan(canon.shapes, 4)
    sync = OverlapSync(plan, "all_reduce", group)
    sync.attach([params[j] for j in canon.port_index], canon.leaf)
    gen = torch.Generator(device=dev).manual_seed(1)
    xb = torch.randn(64, 3, 32, 32, device=dev, generator=gen)
    yb = torch.randint(0, 10, (64,), device=dev, generator=gen)
    from tpu_ddp_torch.ops.loss import cross_entropy_loss
    with _deterministic_cudnn():
        model.zero_grad(set_to_none=True)
        sync.begin()
        cross_entropy_loss(model(xb), yb).backward()
        res, _, _ = sync.finish()
        fired, after = list(sync.fired), list(sync.launched_after)
        sync.detach()
        ref = [canon.leaves([p.grad for p in params])[i].contiguous()
               for i in range(len(params))]
    if fired != list(range(plan.n_buckets)) or plan.n_buckets < 2:
        fail(f"phase 32: buckets fired {fired}, expected "
             f"{list(range(plan.n_buckets))}")
    if not after[0] < len(params):
        fail(f"phase 32: bucket 0 launched after all {len(params)} "
             f"gradients ({after}): not inside the backward")
    for kb, sh in enumerate(res):
        for i, g in zip(plan.buckets[kb], plan.split(sh, kb)):
            if not torch.equal(g, ref[i]):
                fail(f"phase 32: bucketed gradient of leaf {i} differs "
                     "from the unbucketed one")
    return {"n_buckets": plan.n_buckets, "fired": fired,
            "launched_after_grads": after, "leaves": len(params),
            "bucket_bytes": plan.describe()["bucket_bytes"]}


@contextlib.contextmanager
def _group_of_one(dev):
    """A NCCL process group of one rank on this host."""
    from tpu_ddp_torch.parallel.bootstrap import (init_distributed_setup,
                                                  shutdown)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    ctx = init_distributed_setup("127.0.0.1", str(port), 0, 1, device=dev,
                                 ddp=True)
    try:
        yield ctx
    finally:
        shutdown(ctx)


def ladder_device_code(dev) -> dict:
    """Phase 32: the per-rank device code of ZeRO, FSDP, the wires and
    the bucket hooks on the card."""
    out = {"layout": _layout_checks(dev),
           "int8_quantizer": _quantizer_checks(dev)}
    torch.cuda.empty_cache()
    with _group_of_one(dev):
        out["wire_and_overlap"] = _wire_and_overlap_checks(dev)
    return out


LM_SHARD_STEPS = 3


def lm_sharded(dev, seed: int) -> dict:
    """Phase 33: LM-large under zero1, zero2 (two microbatches) and fsdp
    at world 1 over NCCL, each from the same start: the step-1 loss must
    be the replicated run's bits (zero2's the replicated run's with the
    same accumulation), the flash launches exact (12 layers per
    microbatch each step); ms per step over steps 2-3, tokens/s and peak
    memory."""
    from tpu_ddp_torch.models.transformer import make_transformer
    from tpu_ddp_torch.train.lm import LMTrainer, make_lm_batch
    model = make_transformer("TransformerLM-large", max_seq_len=LM_SEQ,
                             use_flash=True, remat="none")
    tokens = np.random.default_rng(0).integers(
        0, model.vocab_size, size=(LM_BATCH, LM_SEQ + 1))
    wrappers = _flash_wrappers()
    runs = {}
    with _group_of_one(dev):
        for name, kw in (("replicated", {}),
                         ("replicated_accum2", {"grad_accum": 2}),
                         ("zero1", {"opt_sharding": "zero1"}),
                         ("zero2", {"opt_sharding": "zero2",
                                    "grad_accum": 2}),
                         ("fsdp", {"param_sharding": "fsdp"})):
            torch.cuda.empty_cache()
            tr = LMTrainer(model, device=dev, **kw)
            state = tr.init_state(seed=seed)
            x, y = tr.put_batch(*make_lm_batch(tokens))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            _zero_launches(wrappers)
            losses, t1 = [], None
            for i in range(LM_SHARD_STEPS):
                if i == 1:
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                state, loss = tr.train_step(state, x, y)
                losses.append(loss)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3 / (LM_SHARD_STEPS - 1)
            counts = _launches(wrappers)
            n = model.num_layers * tr.grad_accum * LM_SHARD_STEPS
            if counts != _flash_want(n, n):
                fail(f"phase 33: {name} flash launches {counts}, expected "
                     f"{_flash_want(n, n)}")
            vals = [float(v) for v in losses]
            if not all(math.isfinite(v) for v in vals):
                fail(f"phase 33: {name} losses not finite: {vals}")
            runs[name] = {
                "losses": vals, "loss1_hex": float(losses[0]).hex(),
                "ms_per_step": ms,
                "tokens_per_s": LM_BATCH * LM_SEQ / (ms / 1e3),
                "peak_mem_gib": torch.cuda.max_memory_allocated(dev)
                / 2 ** 30, "launches": counts}
            del tr, state
    for name, ref in (("zero1", "replicated"), ("fsdp", "replicated"),
                      ("zero2", "replicated_accum2")):
        if runs[name]["loss1_hex"] != runs[ref]["loss1_hex"]:
            fail(f"phase 33: {name} step-1 loss {runs[name]['losses'][0]!r}"
                 f" != {ref} {runs[ref]['losses'][0]!r}")
    return runs


LADDER_WORKER = r"""
import hashlib, json, sys
import numpy as np
import torch
from tpu_ddp_torch.models.vgg import make_vgg
from tpu_ddp_torch.parallel.bootstrap import init_distributed_setup, shutdown
from tpu_ddp_torch.train.engine import Trainer
from tpu_ddp_torch.utils.config import TrainConfig

strategy, rank, world, port, cfg, out = sys.argv[1:]
rank, world = int(rank), int(world)
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
dev = f"cuda:{rank}"
ctx = init_distributed_setup("127.0.0.1", port, rank, world, device=dev,
                             ddp=True)
config = TrainConfig(pallas_sgd=True, pallas_bn=True, **json.loads(cfg))
trainer = Trainer(make_vgg("VGG11", use_pallas_bn=True), config,
                  strategy=strategy, device=dev)
state = trainer.init_state()
gen = torch.Generator(device=dev).manual_seed(17 + rank)
losses = []
for _ in range(4):
    x = torch.randn(128, 3, 32, 32, device=dev, generator=gen)
    y = torch.randint(0, 10, (128,), device=dev, generator=gen)
    state, loss = trainer.train_step(state, x, y)
    losses.append(float(loss))
host = trainer.params_to_host(state)
leaves = [np.ascontiguousarray(a) for a in (
    [v for f in host["features"] for v in (f["bias"], f["bn_bias"],
                                           f["bn_scale"], f["kernel"])]
    + [host["head"]["bias"], host["head"]["kernel"]])]
np.savez(out, losses=np.array(losses), *leaves)
shutdown(ctx)
"""


def ladder_multi_card(dev) -> dict:
    """Phase 34: the ladder at world 2 over NCCL, one card per rank:
    every part, fused and zero under bf16 and int8, fused with overlap;
    4 steps of VGG-11 at batch 128 per rank. Every rank must end with
    the same params; the f32-wire rungs within 1e-4 relative of part 2b
    (the CPU ladder's tolerance). Skipped, and said so, on one card."""
    if torch.cuda.device_count() < 2:
        print(json.dumps({"multi_card": "skipped: 1 card"}), flush=True)
        return {"skipped": "1 card"}
    runs = {}
    cases = [(p, p, {}) for p in ("part2a", "part2b", "part3", "part4",
                                  "part5")]
    cases += [(f"{s}_{w}", s, {"grad_compress": w})
              for s in ("fused", "zero") for w in ("bf16", "int8")]
    cases += [("fused_overlap", "fused", {"overlap": True})]
    env = dict(os.environ, NCCL_SOCKET_IFNAME="lo",
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    for name, strategy, cfg in cases:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = str(s.getsockname()[1])
        outs = [os.path.join(CKPT_ROOT, f"{name}.{r}.npz") for r in (0, 1)]
        os.makedirs(CKPT_ROOT, exist_ok=True)
        procs = [subprocess.Popen(
            [sys.executable, "-c", LADDER_WORKER, strategy, str(r), "2",
             port, json.dumps(cfg), outs[r]], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in (0, 1)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            fail(f"phase 34: {name} failed:\n{logs[0][-2000:]}"
                 f"\n{logs[1][-2000:]}")
        got = [np.load(o) for o in outs]
        keys = [k for k in got[0].files if k != "losses"]
        if not all(np.array_equal(got[0][k], got[1][k]) for k in keys):
            fail(f"phase 34: {name}: the ranks' params differ")
        runs[name] = {"losses": got[0]["losses"].tolist(),
                      "params": {k: got[0][k] for k in keys}}
    ref = runs["part2b"]["params"]
    for name in ("part2a", "part3", "part4", "part5", "fused_overlap"):
        for k, v in runs[name]["params"].items():
            if not np.allclose(v, ref[k], rtol=1e-4, atol=1e-5):
                fail(f"phase 34: {name} params leave part 2b's tolerance")
    return {name: {"losses": r["losses"]} for name, r in runs.items()}


# ---- phases 35-37: ResNet-50 and ViT through the image trainer ----------

# ResNet-50's BN+ReLU inputs at batch 256 as (R = N*H*W, C) rows, with the
# number of sites of each shape: the stem, then each bottleneck's conv1 and
# conv2, 33 per forward (a stride-2 block's conv1 runs at the stage's input
# size, its conv2 at the output's).
RESNET_BN_SHAPES = [((3211264, 64), 1), ((802816, 64), 6),
                    ((802816, 128), 1), ((200704, 128), 7),
                    ((200704, 256), 1), ((50176, 256), 11),
                    ((50176, 512), 1), ((12544, 512), 5)]
RESNET_BN_SITES = 33
RESNET_SGD_LAUNCHES = 3   # 161 leaves, 80 per launch (ops/sgd.py)
IMAGE_WARMUP, IMAGE_STEPS, IMAGE_TRACED = 2, 10, 5
# Env knobs earlier phases leave set, cleared for a preset as published.
PRESET_ENV = dict(TPU_DDP_MAX_ITERS=None, TPU_DDP_SYNTH_SIZE=None,
                  TPU_DDP_GLOBAL_BATCH=None, TPU_DDP_COMPUTE_DTYPE=None,
                  TPU_DDP_LR=None, TPU_DDP_REMAT=None, TPU_DDP_ACT_DTYPE=None,
                  TPU_DDP_CKPT_EVERY=None, TPU_DDP_CHAOS_FAULTS=None,
                  TPU_DDP_GUARD=None, TPU_DDP_CUDNN_DETERMINISTIC=None,
                  IMAGENET_DIR=None, TPU_DDP_PALLAS_SGD="1",
                  TPU_DDP_PALLAS_BN="1")


# The one-pass reductions at ResNet-50's shapes are held to a bound on an
# f32 sum of R terms t that grows as sqrt(R), not as R: |kernel - plain|
# <= RED_K * eps * (|sum t| + sqrt(R) * max |t|) per channel, eps f32's
# machine epsilon: the result's own rounding plus a random walk of R
# roundings of terms' size. Phase 7's 1e-4 * sum|t| grows as R.
RED_K = 32


def _sum_tol(t):
    """Per-channel bound on |delta sum_rows t| of (R, C) terms."""
    eps = torch.finfo(torch.float32).eps
    return RED_K * eps * (t.sum(0).abs()
                          + math.sqrt(t.shape[0]) * t.abs().amax(0))


def _reduction_tols(tb, x, g, s, b, mean, inv) -> dict:
    """The four reduction outputs' bounds at ``x``, ``g``: dbias and
    dscale straight from :func:`_sum_tol`; the mean as the sum's over R;
    inv through var = E[x^2] - mean^2 and d rsqrt = inv^3 / 2 d var, plus
    two ulps on each side for rsqrt. Each is the largest channel's."""
    r = x.shape[0]
    eps = torch.finfo(torch.float32).eps
    m_tol = _sum_tol(x) / r
    var_tol = _sum_tol(x * x) / r + 2 * mean.abs() * m_tol + m_tol ** 2
    i_tol = 0.5 * inv ** 3 * var_tol + 4 * eps * inv
    x_hat, gy = tb._masked_grad(x, g, mean, inv, s, b)
    return {"bn_stats": float(m_tol.max()),
            "bn_stats_inv": float(i_tol.max()),
            "bn_bwd_stats": float(_sum_tol(gy).max()),
            "bn_bwd_stats_dscale": float(_sum_tol(gy * x_hat).max())}


def _bn_fault_readings(tb, x, g, s, b, plain, stale) -> dict:
    """Two planted faults, read as ``_bn_kernel_errors`` reads the
    kernels: ``"stale"``, the two reductions returning the sums of the
    launch before (on ``stale``, another draw of x and g at this shape:
    what a one-pass grid whose arrival counter fired early would hand
    back; the elementwise kernels work from those statistics), and
    ``"dropped_block"``, each kernel missing the one-pass grid's last row
    block: the reductions' sums without it (still divided by R), the
    elementwise kernels' outputs unwritten (zero) there."""
    mean, inv, y, db, ds, dx = plain
    r, c = x.shape
    idx = x.device.index
    plan = tb.stats_plan("bn_stats", r, c, 4, tb._num_sms(idx),
                         tb._blocks_per_sm("bn_stats", 4, idx))
    keep = plan.rows(r, plan.blocks - 1).start
    xk = x[:keep]
    fmean = xk.sum(0) / r
    finv = torch.rsqrt(torch.clamp_min((xk * xk).sum(0) / r - fmean * fmean,
                                       0.0) + tb.BN_EPS)
    x_hat, gy = tb._masked_grad(x, g, mean, inv, s, b)
    fdb, fds = gy[:keep].sum(0), (gy * x_hat)[:keep].sum(0)
    del x_hat, gy
    smean, sinv = tb.bn_stats_ref(stale[0])
    sdb, sds = tb.bn_bwd_stats_ref(*stale, smean, sinv, s, b)
    out = {"dropped_block": {
        "rows": r - keep,
        "bn_stats": float((fmean - mean).abs().max()),
        "bn_stats_inv": float((finv - inv).abs().max()),
        "bn_norm_relu": float(y[keep:].abs().max()),
        "bn_bwd_stats": float((fdb - db).abs().max()),
        "bn_bwd_stats_dscale": float((fds - ds).abs().max()),
        "bn_bwd_dx": float(dx[keep:].abs().max())}}
    out["stale"] = {
        "bn_stats": float((smean - mean).abs().max()),
        "bn_stats_inv": float((sinv - inv).abs().max()),
        "bn_norm_relu": float((tb.bn_norm_relu_ref(
            x, smean, sinv, s, b) - y).abs().max()),
        "bn_bwd_stats": float((sdb - db).abs().max()),
        "bn_bwd_stats_dscale": float((sds - ds).abs().max()),
        "bn_bwd_dx": float((tb.bn_bwd_dx_ref(
            x, g, mean, inv, s, b, sdb, sds) - dx).abs().max())}
    return out


def _timed_over_bound(fn, args_list, reps: int, bound: float) -> dict:
    """``timed``, traced again (three tries in all) while the profiler's
    reading lies under ``bound``, the least time the work can take: such
    a reading is a trace that lost kernels. ``under_bound`` marks one
    that stayed there."""
    for _ in range(3):
        t = timed(fn, args_list, reps)
        if t["device_ms"] is not None and t["device_ms"] >= bound:
            break
    t["under_bound"] = t["ms"] < bound
    return t


def _bf16_rows(r, c, gen, dev, scale=1.0, shift=0.0):
    """(R, C) rows drawn in f32, rounded to bf16 as the model's conv
    outputs and gradients are."""
    return (torch.randn(r, c, generator=gen, device=dev) * scale
            + shift).to(torch.bfloat16)


def _bits_equal(a, b) -> bool:
    """The same dtype and bits, NaN compared by position only: the card's
    bf16 NaN (0x7fff) and torch's cast of a NaN differ in payload."""
    an, bn = torch.isnan(a), torch.isnan(b)
    if a.dtype != b.dtype or not torch.equal(an, bn):
        return False
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return torch.equal(a.view(view)[~an], b.view(view)[~bn])


def _bf16_backward(tb, x16, g16, mean, inv, s, b) -> tuple:
    """The backward pair on bf16 rows as they are: (dbias, dscale, dx)."""
    db, ds = tb.bn_bwd_stats(x16, g16, mean, inv, s, b)
    return db, ds, tb.bn_bwd_dx(x16, g16, mean, inv, s, b, db, ds)


def _f32_then_cast(tb, x16, g16, mean, inv, s, b) -> tuple:
    """The backward pair's f32 route on the upcast rows, dx cast to bf16:
    what the op did with bf16 rows before."""
    x, g = x16.float(), g16.float()
    db, ds = tb.bn_bwd_stats(x, g, mean, inv, s, b)
    dx = tb.bn_bwd_dx(x, g, mean, inv, s, b, db, ds)
    return db, ds, dx.to(torch.bfloat16)


BWD_OUTPUTS = ("dbias", "dscale", "dx")


def _bf16_route_checks(tb, xs16, gs16, s, b, mean, inv, other) -> dict:
    """Phase 35's gates on the backward pair's bf16 route at one shape:
    bit for bit the f32 route on the upcast rows plus the cast; the same
    bits on a second launch and on a third after a launch on ``other``
    (bf16 rows of another shape: other counters and partials); the bit
    gate catching two planted faults, read as the gate reads the route
    (the stale outputs of another draw of x and g; the last row block of
    each kernel's grid dropped: the sums without its rows, dx unwritten
    there)."""
    x16, g16 = xs16[0], gs16[0]
    r, c = x16.shape
    want = _f32_then_cast(tb, x16, g16, mean, inv, s, b)
    first = _bf16_backward(tb, x16, g16, mean, inv, s, b)
    again = _bf16_backward(tb, x16, g16, mean, inv, s, b)
    _bf16_backward(tb, *other)
    third = _bf16_backward(tb, x16, g16, mean, inv, s, b)
    torch.cuda.synchronize()
    for name, w, f, a, t in zip(BWD_OUTPUTS, want, first, again, third):
        if not _bits_equal(f, w):
            fail(f"phase 35: {name} on bf16 rows differs from the f32 route "
                 f"plus the cast at R={r} C={c}")
        if not (_bits_equal(a, f) and _bits_equal(t, f)):
            fail(f"phase 35: two launches on bf16 rows differ in {name} at "
                 f"R={r} C={c} (or after a launch at "
                 f"{tuple(other[0].shape)})")
    idx = x16.device.index or 0
    sms = tb._num_sms(idx)
    splan = tb.stats_plan("bn_bwd_stats", r, c, 4, sms, tb._blocks_per_sm(
        "bn_bwd_stats", 4, idx, True))
    dplan = tb.dx_plan(r, c, 8, sms, tb._blocks_per_sm("bn_bwd_dx", 8, idx,
                                                       True))
    skeep = splan.rows(r, splan.blocks - 1).start
    dkeep = dplan.rows(r, dplan.blocks - 1).start
    dropped_dx = want[2].clone()
    dropped_dx[dkeep:] = 0
    faults = {"stale": _bf16_backward(tb, xs16[1], gs16[1], mean, inv, s,
                                      b),
              "dropped_block": (*tb.bn_bwd_stats_ref(
                  x16[:skeep], g16[:skeep], mean, inv, s, b), dropped_dx)}
    readings = {}
    for kind, outs in faults.items():
        readings[kind] = {}
        for name, w, f in zip(BWD_OUTPUTS, want, outs):
            if _bits_equal(f, w):
                fail(f"phase 35: the bf16 route's bit gate misses the "
                     f"planted {kind} fault in {name} at R={r} C={c}")
            readings[kind][name] = float((f.float() - w.float()).abs().max())
    return {"bits_equal_f32_route_plus_cast": True, "same_bits": True,
            "planted_fault": readings,
            "dropped_rows": {"bn_bwd_stats": r - skeep,
                             "bn_bwd_dx": r - dkeep},
            "plan": {"bn_bwd_stats": dataclasses.asdict(splan),
                     "bn_bwd_dx": dataclasses.asdict(dplan)}}


def _bf16_times(tb, xs16, gs16, s, b, mean, inv, db, ds, reps) -> dict:
    """The backward pair on bf16 rows, cycling through ``xs16``, ``gs16``,
    each timed as a CUDA graph of ``reps`` calls (:func:`graph_ms`): each
    kernel beside its bound in bf16 bytes and SyncBatchNorm's primitive
    on the same bf16 rows with f32 statistics (its error text where it
    refuses them); the op's backward with the rows handed over as they
    are and with the f32 route forced (copies and casts)."""
    r, c = xs16[0].shape
    n_el = r * c
    gm16 = [torch.where(tb.bn_norm_relu_ref(xi.float(), mean, inv, s, b) > 0,
                        gi, 0.0) for xi, gi in zip(xs16, gs16)]
    count = torch.tensor([r], dtype=torch.int32, device=xs16[0].device)
    sum_dy_xmu = ds / inv
    kern = {"bn_bwd_stats": (tb.bn_bwd_stats, [(xi, gi, mean, inv, s, b)
                                               for xi, gi in zip(xs16, gs16)]),
            "bn_bwd_dx": (tb.bn_bwd_dx, [(xi, gi, mean, inv, s, b, db, ds)
                                         for xi, gi in zip(xs16, gs16)])}
    libs = {"bn_bwd_stats": lambda t, gm: torch.batch_norm_backward_reduce(
                gm, t, mean, inv, s, False, True, True),
            "bn_bwd_dx": lambda t, gm: torch.batch_norm_backward_elemt(
                gm, t, mean, inv, s, db, sum_dy_xmu, count)}
    out = {}
    for name, (fn, args) in kern.items():
        bound, by = _bound(BN_BYTES_PER_ELEM[torch.bfloat16][name] * n_el
                           + 4 * BN_CHAN_VECTORS[name] * c,
                           BN_FLOPS_PER_ELEM[name] * n_el)
        ms = graph_ms(fn, args, reps)
        out[name] = {"ms": ms, "bound_ms": bound, "bound_by": by,
                     "under_bound": ms < bound, "library_ms": None,
                     "library_error": None, "timing": "cuda-graph events"}
        try:
            out[name]["library_ms"] = graph_ms(libs[name],
                                               list(zip(xs16, gm16)), reps)
        except RuntimeError as e:
            out[name]["library_error"] = str(e)[:300]
    op_args = [(xi, gi, mean, inv, s, b) for xi, gi in zip(xs16, gs16)]
    new = graph_ms(tb.bn_relu_backward, op_args, reps)
    with _force(tb, "bwd_rows", "f32"):
        old = graph_ms(tb.bn_relu_backward, op_args, reps)
    out["op_backward"] = {"ms": new, "f32_route_ms": old,
                          "timing": "cuda-graph events"}
    return out


def check_bn_resnet(dev, gen) -> dict:
    """Phase 35: the four BN+ReLU kernels at ResNet-50's eight shapes, on
    the bf16 inputs the model gives them cast to f32 rows as the op casts
    them: the elementwise kernels at phase 7's bounds, the reductions at
    :func:`_reduction_tols`'s (growing as sqrt(R)); every bound catching
    two planted faults (stale one-pass sums; the grid's last row block
    dropped), two launches the same bits, NaN kept at the stem's shape;
    timed beside the bound, the plain versions, SyncBatchNorm's
    primitives and the op's casts. Then the backward pair on the bf16
    rows as they are (the op's main path on bf16 activations): bit for
    bit the f32 route plus the cast, the same bits twice, both planted
    faults
    caught, NaN kept by position at the stem's shape; timed beside the
    bound in bf16 bytes, SyncBatchNorm's primitives on the bf16 rows, and
    the op's backward on both routes."""
    from tpu_ddp_torch.ops import bn_relu as tb
    kernels = {"bn_stats": (tb.bn_stats, tb.bn_stats_ref),
               "bn_norm_relu": (tb.bn_norm_relu, tb.bn_norm_relu_ref),
               "bn_bwd_stats": (tb.bn_bwd_stats, tb.bn_bwd_stats_ref),
               "bn_bwd_dx": (tb.bn_bwd_dx, tb.bn_bwd_dx_ref)}
    other = _bn_inputs(*BN_BITS_OTHER, gen, dev)
    mean_o, inv_o = tb.bn_stats_ref(other[0])
    other16 = (other[0].to(torch.bfloat16), other[1].to(torch.bfloat16),
               mean_o, inv_o, *other[2:])
    idx = dev.index or 0
    shapes = []
    for (r, c), sites in RESNET_BN_SHAPES:
        n_el = r * c
        # bf16 copies to cycle through: more than twice L2 at 6 bytes per
        # element (x, g and dx); the f32 checks take the first two.
        copies = max(2, math.ceil(2 * L2_BYTES / (6 * n_el)))
        xs16 = [_bf16_rows(r, c, gen, dev, 2.0, 0.3) for _ in range(2)]
        gs16 = [_bf16_rows(r, c, gen, dev) for _ in range(2)]
        xs, gs = [t.float() for t in xs16], [t.float() for t in gs16]
        s = 0.5 + torch.rand(c, generator=gen, device=dev)
        b = 0.1 * torch.randn(c, generator=gen, device=dev)
        x, g = xs[0], gs[0]
        errs, plain = _bn_kernel_errors(tb, x, g, s, b)
        phase7_tols = {k: v[1] for k, v in errs.items()}
        for what, tol in _reduction_tols(tb, x, g, s, b,
                                         *plain[:2]).items():
            errs[what] = (errs[what][0], tol)
        _fail_on(errs, f"ResNet-50 R={r} C={c}")
        fault = _bn_fault_readings(tb, x, g, s, b, plain, (xs[1], gs[1]))
        for kind in ("stale", "dropped_block"):
            for what, (_, tol) in errs.items():
                if not fault[kind][what] > tol:
                    fail(f"phase 35: the {what} bound {tol} misses the "
                         f"planted {kind} fault at R={r} C={c} (it reads "
                         f"{fault[kind][what]})")
        if not _stats_bits(tb, x, g, s, b, other):
            fail(f"phase 35: two launches of the one-pass reductions "
                 f"differ at R={r} C={c}")
        plan = {n: dataclasses.asdict(tb.stats_plan(
            n, r, c, 4, tb._num_sms(idx), tb._blocks_per_sm(n, 4, idx)))
            for n in ("bn_stats", "bn_bwd_stats")}
        mean, inv, y, db, ds, dx = plain
        row = {"r": r, "c": c, "sites": sites, "plan": plan,
               "errors": {k: v[0] for k, v in errs.items()},
               "tols": {k: v[1] for k, v in errs.items()},
               "phase7_tols": phase7_tols,
               "planted_fault": fault, "same_bits": True}
        reps = 20
        args = {"bn_stats": [(xi,) for xi in xs],
                "bn_norm_relu": [(xi, mean, inv, s, b) for xi in xs],
                "bn_bwd_stats": [(xi, gi, mean, inv, s, b)
                                 for xi, gi in zip(xs, gs)],
                "bn_bwd_dx": [(xi, gi, mean, inv, s, b, db, ds)
                              for xi, gi in zip(xs, gs)]}
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
                list(zip(xs, gms)))}
        for name, (kern, plain_fn) in kernels.items():
            bound, by = _bound(BN_BYTES_PER_ELEM[torch.float32][name] * n_el
                               + 4 * BN_CHAN_VECTORS[name] * c,
                               BN_FLOPS_PER_ELEM[name] * n_el)
            k_t = _timed_over_bound(kern, args[name], reps, bound)
            p_t = _timed_over_bound(plain_fn, args[name], 4, bound)
            l_t = _timed_over_bound(libs[name][0], libs[name][1], reps,
                                    bound)
            row[name] = {"ms": k_t["ms"], "event_ms": k_t["event_ms"],
                         "plain_ms": p_t["ms"], "library_ms": l_t["ms"],
                         "library_event_ms": l_t["event_ms"],
                         "bound_ms": bound, "bound_by": by,
                         "under_bound": [w for w, t in (
                             ("kernel", k_t), ("plain", p_t),
                             ("library", l_t)) if t["under_bound"]],
                         "timing": _timing_label(k_t, p_t, l_t)}
        # The op's casts around the kernels: bf16 -> f32 rows (x in the
        # forward; x and g in the backward) and f32 -> bf16 (y, dx).
        row["casts"] = {
            "up_ms": timed(lambda t: t.float(), [(t,) for t in xs16],
                           reps)["ms"],
            "down_ms": timed(lambda t: t.to(torch.bfloat16),
                             [(t,) for t in xs], reps)["ms"]}
        del xs, gs, gms, args, libs, plain
        # The backward pair on the bf16 rows as they are.
        row["bf16"] = _bf16_route_checks(tb, xs16, gs16, s, b, mean, inv,
                                         other16)
        xs16 += [_bf16_rows(r, c, gen, dev, 2.0, 0.3)
                 for _ in range(copies - 2)]
        gs16 += [_bf16_rows(r, c, gen, dev) for _ in range(copies - 2)]
        row["bf16"]["copies"] = copies
        row["bf16"].update(_bf16_times(tb, xs16, gs16, s, b, mean, inv, db,
                                       ds, 10 * copies))
        del xs16, gs16
        shapes.append(row)
        print(json.dumps({"resnet_bn_shape": row}), flush=True)
    # NaN at the stem's shape, on the main (one-pass) route.
    (r, c), _ = RESNET_BN_SHAPES[0]
    nan_cases = {}
    for kind in ("rows", "elements"):
        x16 = _bf16_rows(r, c, gen, dev, 2.0, 0.3)
        g16 = _bf16_rows(r, c, gen, dev)
        s = 0.5 + torch.rand(c, generator=gen, device=dev)
        b = 0.1 * torch.randn(c, generator=gen, device=dev)
        if kind == "rows":
            x16[[1, r // 2]] = float("nan")
        else:
            x16[r // 3, ::3] = float("nan")
            g16[r // 2, 1::3] = float("nan")
        x, g = x16.float(), g16.float()
        res = _bn_nan_errors(tb, x, g, s, b)
        case = nan_cases[f"{r}x{c}/{kind}"] = {
            k: {"plain_nans": v[0], "err": v[1]} for k, v in res.items()}
        # The bf16 route on the same rows: NaN where the f32 route plus
        # the cast has NaN, the same bits elsewhere.
        mean, inv = tb.bn_stats_ref(x)
        want = _f32_then_cast(tb, x16, g16, mean, inv, s, b)
        got = _bf16_backward(tb, x16, g16, mean, inv, s, b)
        torch.cuda.synchronize()
        for name, w, k in zip(BWD_OUTPUTS, want, got):
            if not _bits_equal(k, w):
                fail(f"phase 35: {name} on bf16 rows holding NaN ({kind}) "
                     f"differs from the f32 route plus the cast")
        case["bf16_route"] = {n: int(torch.isnan(k).sum())
                              for n, k in zip(BWD_OUTPUTS, got)}
        if case["bf16_route"]["dx"] == 0:
            fail(f"phase 35: NaN inputs ({kind}) gave the bf16 dx no NaN")
        del x, g, x16, g16
    torch.cuda.empty_cache()

    def per_step(fn):
        return sum(row["sites"] * fn(row) for row in shapes)

    out = {"shapes": shapes, "nan_cases": nan_cases, "kernels": {},
           "kernels_bf16": {},
           # The op's five casts per step on the f32 route (x up in the
           # forward; x and g up, y and dx down), and the backward's three
           # that the bf16 route does not make.
           "casts_ms_per_step": per_step(
               lambda w: 3 * w["casts"]["up_ms"] + 2 * w["casts"]["down_ms"]),
           "backward_casts_ms_per_step": per_step(
               lambda w: 2 * w["casts"]["up_ms"] + w["casts"]["down_ms"]),
           "op_backward_ms_per_step": {
               "bf16_rows": per_step(lambda w: w["bf16"]["op_backward"]["ms"]),
               "f32_route": per_step(
                   lambda w: w["bf16"]["op_backward"]["f32_route_ms"])}}
    for name in ("bn_bwd_stats", "bn_bwd_dx"):
        libs = [w["bf16"][name]["library_ms"] for w in shapes]
        bound, by = _bound(
            per_step(lambda w: BN_BYTES_PER_ELEM[torch.bfloat16][name]
                     * w["r"] * w["c"] + 4 * BN_CHAN_VECTORS[name] * w["c"]),
            per_step(lambda w: BN_FLOPS_PER_ELEM[name] * w["r"] * w["c"]))
        out["kernels_bf16"][name] = {
            "ms": per_step(lambda w: w["bf16"][name]["ms"]),
            "library_ms": (None if None in libs else
                           per_step(lambda w: w["bf16"][name]["library_ms"])),
            "library_errors": sorted({w["bf16"][name]["library_error"]
                                      for w in shapes} - {None}),
            "under_bound": [f"{w['r']}x{w['c']}" for w in shapes
                            if w["bf16"][name]["under_bound"]],
            "bound_ms": bound, "bound_by": by,
            "max_abs_err": 0.0,  # bit for bit the f32 route plus the cast
            "timing": ",".join(sorted({w["bf16"][name]["timing"]
                                       for w in shapes}))}
    for name in kernels:
        bound_bytes = per_step(lambda w: BN_BYTES_PER_ELEM[torch.float32][name]
                               * w["r"] * w["c"]
                               + 4 * BN_CHAN_VECTORS[name] * w["c"])
        bound_flops = per_step(lambda w: BN_FLOPS_PER_ELEM[name] * w["r"]
                               * w["c"])
        bound, by = _bound(bound_bytes, bound_flops)
        out["kernels"][name] = {
            **{k: per_step(lambda w: w[name][k])
               for k in ("ms", "event_ms", "plain_ms", "library_ms",
                         "library_event_ms")},
            "under_bound": sorted({f"{w['r']}x{w['c']}/{u}" for w in shapes
                                   for u in w[name]["under_bound"]}),
            "bound_ms": bound, "bound_by": by,
            "max_abs_err": max(v for w in shapes
                               for k, v in w["errors"].items()
                               if k.startswith(name)),
            "timing": ",".join(sorted({w[name]["timing"] for w in shapes}))}
    return out


def _resnet_sgd(dev, gen, shapes) -> dict:
    """The SGD kernel on ResNet-50's 161 leaves (3 launches): bit for bit
    its plain version over 3 steps; with ``skip`` set every launch writes
    nothing; timed beside its bound, the plain version and
    ``torch.optim.SGD(fused=True)``."""
    from tpu_ddp_torch.ops import sgd as tsgd
    hp = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)
    n = sum(math.prod(s) for s in shapes)
    p0, grads, (kp, kb), (rp, rb) = _sgd_bitwise(tsgd, shapes, gen, dev, hp)
    before = [t.clone() for t in kp + kb]
    tsgd.fused_sgd_step.launches = 0
    tsgd.fused_sgd_step(kp, grads, kb, skip=torch.ones((), device=dev), **hp)
    torch.cuda.synchronize()
    if tsgd.fused_sgd_step.launches != RESNET_SGD_LAUNCHES or not all(
            _same_bits(a, b) for a, b in zip(kp + kb, before)):
        fail(f"phase 36: a skipped step over ResNet-50's {len(shapes)} "
             f"leaves changed the state or did not launch "
             f"{RESNET_SGD_LAUNCHES} times")
    bound, by = _bound(20 * n, 5 * n)
    kern = _timed_over_bound(lambda: tsgd.fused_sgd_step(
        kp, grads, kb, **hp), [()], 30, bound)
    plain = _timed_over_bound(lambda: tsgd.fused_sgd_step_ref(
        rp, grads, rb, **hp), [()], 10, bound)
    lib_params = [torch.nn.Parameter(p.clone()) for p in p0]
    for p, g in zip(lib_params, grads):
        p.grad = g
    lib = _timed_over_bound(torch.optim.SGD(lib_params, fused=True,
                                            **hp).step, [()], 30, bound)
    return {"leaves": len(shapes), "elements": n, "max_abs_err": 0.0,
            "launches_per_step": RESNET_SGD_LAUNCHES, "ms": kern["ms"],
            "event_ms": kern["event_ms"], "plain_ms": plain["ms"],
            "library_ms": lib["ms"], "bound_ms": bound, "bound_by": by,
            "under_bound": [w for w, t in (("kernel", kern),
                                           ("plain", plain), ("library", lib))
                            if t["under_bound"]],
            "timing": _timing_label(kern, plain, lib)}


def _image_window(tr, state, batches, steps: int) -> tuple:
    """A profiler window over ``steps`` train steps: (state, the device's
    busy and idle share, the ported kernels' ms per step, the top
    kernels, and a 2-step window with shapes naming the copy kernels)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            state, loss = tr.train_step(state, *batches[i % len(batches)])
        float(loss)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us = _device_us(prof)
    busy_ms = sum(dev_us.values()) / 1e3
    kernels = {**VGG_KERNELS, **FLASH_KERNELS}
    ours = {k: sum(v for n, v in dev_us.items()
                   if any(p in n for p in pats)) / 1e3 / steps
            for k, pats in kernels.items()}
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:10]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for i in range(2):
            state, loss = tr.train_step(state, *batches[i % len(batches)])
        float(loss)
        torch.cuda.synchronize()
    return state, {"steps": steps, "wall_ms": wall_ms,
                   "device_busy_ms": busy_ms,
                   "device_ms_per_step": busy_ms / steps,
                   "device_idle_share": 1 - busy_ms / wall_ms,
                   "ported_kernels_ms_per_step": ours,
                   "top_kernels_ms": [[k[:90], v / 1e3] for k, v in top],
                   "copy_sources": _copy_sources(prof, steps=2)}


def _timed_steps(tr, state, batches, dev) -> tuple:
    """IMAGE_WARMUP steps, then IMAGE_STEPS timed ones (synchronized at
    the end): (state, ms per step, peak GiB of the timed steps, losses)."""
    losses = []
    for i in range(IMAGE_WARMUP):
        state, loss = tr.train_step(state, *batches[i % len(batches)])
        losses.append(float(loss))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    timed_losses = []
    for i in range(IMAGE_STEPS):
        state, loss = tr.train_step(state, *batches[i % len(batches)])
        timed_losses.append(loss)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / IMAGE_STEPS
    losses += [float(v) for v in timed_losses]
    if not all(math.isfinite(v) for v in losses):
        fail(f"image trainer losses not finite: {losses}")
    return state, ms, torch.cuda.max_memory_allocated(dev) / 2 ** 30, losses


def _restore(state, p0, m0) -> None:
    with torch.no_grad():
        for p, a in zip(state.params, p0):
            p.copy_(a)
        for b, a in zip(state.opt_state["momentum"], m0):
            b.copy_(a)


def _bwd_route_bits(tr, state, batch, p0, m0, wrappers) -> dict:
    """One ResNet-50 step from (p0, m0) with the op's backward on the bf16
    rows, one with the f32 route forced, and the bf16 one again (the
    control: the step itself repeats bit for bit), cuDNN deterministic:
    the loss, every gradient and every parameter the same bits; the bf16
    steps' backward kernels all on their bf16 routes (33 launches of
    each), the forced step's all on f32."""
    from tpu_ddp_torch.ops import bn_relu as tb
    runs = {}
    with _deterministic_cudnn():
        for label in ("bf16", "f32", "bf16_again"):
            _restore(state, p0, m0)
            _zero_launches(wrappers)
            with (_force(tb, "bwd_rows", "f32") if label == "f32"
                  else contextlib.nullcontext()):
                state, loss = tr.train_step(state, *batch)
            torch.cuda.synchronize()
            counts = _launches(wrappers)
            want = _bn_bwd_want(RESNET_BN_SITES, bf16=label != "f32")
            if {k: counts[k] for k in want} != want:
                fail(f"phase 36 {label} route step: backward launches "
                     f"{counts}, expected {want}")
            runs[label] = (loss.float().reshape(1),
                           [p.grad.detach().clone() for p in state.params],
                           [p.detach().clone() for p in state.params],
                           {k: counts[k] for k in want})

    def differ(a, b):
        return sum(not _same_bits(x, y) for x, y in
                   zip([a[0], *a[1], *a[2]], [b[0], *b[1], *b[2]]))

    control = differ(runs["bf16"], runs["bf16_again"])
    if control:
        fail(f"phase 36: two bf16-route steps from the same state differ "
             f"in {control} tensors (the step does not repeat)")
    n = differ(runs["bf16"], runs["f32"])
    if n:
        fail(f"phase 36: the bf16-route step and the f32-route step differ "
             f"in {n} of {1 + 2 * len(p0)} tensors (loss, gradients, "
             f"parameters)")
    return {"bitwise_equal": True, "tensors": 1 + 2 * len(p0),
            "loss": float(runs["bf16"][0]),
            "launches": {k: v[3] for k, v in runs.items()}}


def resnet50_train(dev, gen) -> dict:
    """Phase 36: ResNet-50 (resnet50_imagenet as published: 25,557,032
    params, batch 256, 224x224, 1000 classes, bf16) through
    ``run_part("part1")`` with both kernels on the synthetic ImageNet
    stand-in, exact launch counts; then a ``Trainer`` on one staged batch:
    ms per step, images/s, MFU, peak, a profiler window, one step through
    the kernels against the plain versions, and one under
    ``remat="blocks"``."""
    from tpu_ddp_torch.data.imagenet import create_imagenet_loaders
    from tpu_ddp_torch.models import get_model
    from tpu_ddp_torch.ops import bn_relu as tb
    from tpu_ddp_torch.ops import sgd as tsgd
    from tpu_ddp_torch.train import engine
    from tpu_ddp_torch.utils.config import TrainConfig
    from tpu_ddp_torch.utils.flops import resnet_fwd_flops
    wrappers = {**_bn_wrappers(), "sgd": tsgd.fused_sgd_step}
    losses, account = [], engine._LossWindow.account

    def record(self, it, local_loss, step):
        losses.append(local_loss)
        return account(self, it, local_loss, step)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launches(wrappers)
    with _env(**PRESET_ENV), \
            mock.patch.object(engine._LossWindow, "account", record):
        rc, out, wall = _run_part_captured(
            "part1", ["--config", "resnet50_imagenet", "--device", str(dev)])
    counts = _launches(wrappers)
    cli_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    test = re.search(r"Test set: average loss (\S+), accuracy (\d+)/(\d+)",
                     out)
    if rc != 0 or test is None or not math.isfinite(float(test.group(1))):
        fail(f"phase 36: run_part resnet50_imagenet rc {rc}, no finite "
             f"'Test set:' line:\n{out[-2000:]}")
    steps = len(losses)
    evals = math.ceil(int(test.group(3)) / 256)
    if (steps, evals) != (8, 2) or not all(math.isfinite(v)
                                           for v in losses):
        fail(f"phase 36: {steps} steps and {evals} eval batches (expected "
             f"8 and 2), losses {losses}")
    fwd = RESNET_BN_SITES * (steps + evals)
    want = {"sgd": RESNET_SGD_LAUNCHES * steps,
            **_bn_bwd_want(RESNET_BN_SITES * steps, bf16=True),
            "bn_stats": {"one_pass": fwd, "two_stage": 0},
            "bn_norm_relu": fwd}
    if counts != want:
        fail(f"phase 36: launch counts {counts}, expected {want}")
    cli = {"steps": steps, "eval_batches": evals, "losses": losses,
           "test_line": test.group(0), "launches": counts, "wall_s": wall,
           "peak_mem_gib": cli_peak}
    print(json.dumps({"resnet50_cli": cli}), flush=True)

    cfg = TrainConfig.preset("resnet50_imagenet", pallas_sgd=True,
                             pallas_bn=True)
    model = get_model(cfg.model, num_classes=cfg.num_classes,
                      use_pallas_bn=True, compute_dtype=torch.bfloat16)
    sgd = _resnet_sgd(dev, gen, [p.shape for p in model.parameters()])
    tr = engine.Trainer(model, cfg, device=dev)
    state = tr.init_state()
    with _env(IMAGENET_DIR=None):
        train, _ = create_imagenet_loaders(batch_size=256,
                                           synthetic_size=256)
    x, y = next(iter(train))
    batch = (x.to(dev), y.to(dev))
    torch.cuda.empty_cache()
    state, ms, peak, step_losses = _timed_steps(tr, state, [batch], dev)
    fwd_flops = resnet_fwd_flops((3, 4, 6, 3), 224, 256, 1000)
    state, window = _image_window(tr, state, [batch], IMAGE_TRACED)
    window["untraced_idle_share"] = 1 - window["device_ms_per_step"] / ms
    window["copy_share_of_device_time"] = (
        window["copy_sources"]["total_ms_per_step"]
        / window["device_ms_per_step"])
    # The step with the op's backward on the f32 route forced (f32 copies
    # of x and g, dx cast back: the previous route), then on the bf16
    # rows again, in turns after the steps above.
    with _force(tb, "bwd_rows", "f32"):
        state, ms_f32, _, _ = _timed_steps(tr, state, [batch], dev)
    state, ms_again, _, _ = _timed_steps(tr, state, [batch], dev)

    # One step through the kernels against the same step through the
    # plain versions (phase 11's bounds), then one under remat="blocks".
    with torch.no_grad():
        p0 = [p.clone() for p in state.params]
        m0 = [b.clone() for b in state.opt_state["momentum"]]
    state, lk = tr.train_step(state, *batch)
    with torch.no_grad():
        pk = [p.clone() for p in state.params]
    _restore(state, p0, m0)
    with mock.patch.multiple(tb, bn_stats=tb.bn_stats_ref,
                             bn_norm_relu=tb.bn_norm_relu_ref,
                             bn_bwd_stats=tb.bn_bwd_stats_ref,
                             bn_bwd_dx=tb.bn_bwd_dx_ref), \
            mock.patch.object(tsgd, "fused_sgd_step",
                              tsgd.fused_sgd_step_ref):
        state, lp = tr.train_step(state, *batch)
    torch.cuda.synchronize()
    lk, lp = float(lk), float(lp)
    with torch.no_grad():
        update = max(float((a - b).abs().max()) for a, b in zip(pk, p0))
        diff = max(float((a - b).abs().max())
                   for a, b in zip(pk, state.params))
    del pk
    if not (math.isfinite(lk) and abs(lk - lp) <= 1e-2 * abs(lp)):
        fail(f"phase 36 step loss: kernels {lk} vs plain {lp} (tol 1e-2)")
    if not diff <= 5e-2 * update:
        fail(f"phase 36 step params: kernels vs plain max|d|={diff} > "
             f"5e-2 x largest update {update}")
    routes = _bwd_route_bits(tr, state, batch, p0, m0, wrappers)
    _restore(state, p0, m0)
    tr.model.remat = "blocks"
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launches(wrappers)
    state, lb = tr.train_step(state, *batch)
    lb = float(lb)
    blocks_counts = _launches(wrappers)
    blocks_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    tr.model.remat = "none"
    fwd_b = RESNET_BN_SITES + (RESNET_BN_SITES - 1)  # the stem: no region
    want_b = {"sgd": RESNET_SGD_LAUNCHES,
              **_bn_bwd_want(RESNET_BN_SITES, bf16=True),
              "bn_stats": {"one_pass": fwd_b, "two_stage": 0},
              "bn_norm_relu": fwd_b}
    if blocks_counts != want_b:
        fail(f"phase 36 remat='blocks': launch counts {blocks_counts}, "
             f"expected {want_b}")
    if not abs(lb - lk) <= 1e-5 * abs(lk):
        fail(f"phase 36 remat='blocks': loss {lb} vs none {lk} (tol 1e-5)")
    del tr, state, model, p0, m0, batch
    torch.cuda.empty_cache()
    return {"cli": cli, "params": 25_557_032, "batch": 256,
            "warmup_steps": IMAGE_WARMUP, "timed_steps": IMAGE_STEPS,
            "losses": step_losses, "ms_per_step": ms,
            "images_per_s": 256 / (ms / 1e3), "fwd_flops": fwd_flops,
            "mfu": 3 * fwd_flops / (ms / 1e3) / BF16_FLOP_PER_S,
            "peak_mem_gib": peak, "traced_window": window,
            "ms_per_step_f32_route": ms_f32, "ms_per_step_again": ms_again,
            "bwd_routes": routes,
            "step_check": {"loss_kernels": lk, "loss_plain": lp,
                           "max_param_diff": diff, "largest_update": update,
                           "tol": 5e-2 * update},
            "remat_blocks": {"loss": lb, "launches": blocks_counts,
                             "peak_mem_gib": blocks_peak},
            "sgd_161_leaves": sgd}


# The flash calls of the ViT presets at batch 256: (B, L, H, D) and
# layers (calls of each kernel per step).
VIT_FLASH = {"ViT-tiny": ((256, 64, 4, 64), 6),
             "ViT-S16": ((256, 196, 6, 64), 12)}


def _vit_qkv(shape, gen, dev):
    """q, k, v as the model makes them (strided views of one fused
    (B, L, 3, H, D) bf16 product) and a contiguous dO."""
    b, L, h, d = shape
    qkv = torch.randn(b, L, 3, h, d, generator=gen, device=dev).to(
        torch.bfloat16)
    do = torch.randn(b, L, h, d, generator=gen, device=dev).to(
        torch.bfloat16)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], do


def _vit_flash_times(dev, gen, name) -> dict:
    """The three flash kernels at a ViT preset's attention call,
    non-causal: held to their plain versions with phase 13's bounds and
    timed beside their bounds, the plain versions and SDPA's flash
    backend (non-causal, forward; its backward for the two sweeps)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from tpu_ddp_torch.ops import flash_attention as fa
    shape, layers = VIT_FLASH[name]
    q, k, v, do = _vit_qkv(shape, gen, dev)
    errs, reads, plain = _flash_errors(fa, q, k, v, do, False)
    _fail_on(errs, f"{name}'s attention {shape} (non-causal)")
    plse, delta = plain["lse"], plain["delta"]
    del plain
    # Enough input sets, cycled, that each call reads its inputs from HBM
    # (ViT-tiny's four tensors, 34 MB, would sit in the 50 MB L2).
    copies = max(1, math.ceil(2 * L2_BYTES / (4 * 2 * q.numel())))
    sets = [(q, k, v, do)] + [_vit_qkv(shape, gen, dev)
                              for _ in range(copies - 1)]
    bwd_args = []
    for q_, k_, v_, do_ in sets:
        o_, lse_ = fa.flash_fwd(q_, k_, v_, False)
        bwd_args.append((q_, k_, v_, do_, lse_, fa.attention_delta(o_, do_),
                         False))
    work = _flash_work((*shape[:3], shape[2], shape[3]), False, 2)
    bounds = {key: max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)
              * 1e3 for key, (flops, nbytes) in work.items()}
    kern = {"fwd": _timed_over_bound(lambda q_, k_, v_, do_: fa.flash_fwd(
        q_, k_, v_, False), sets, 30, bounds["fwd"]),
            "bwd_kv": _timed_over_bound(fa.flash_bwd_kv, bwd_args, 30,
                                        bounds["bwd_kv"]),
            "bwd_q": _timed_over_bound(fa.flash_bwd_q, bwd_args, 30,
                                       bounds["bwd_q"])}
    slow = {"fwd": timed(lambda: fa.flash_fwd_plain(q, k, v, False), [()], 3),
            "bwd_kv": timed(lambda: fa.flash_bwd_kv_plain(
                q, k, v, do, plse, delta, False), [()], 3),
            "bwd_q": timed(lambda: fa.flash_bwd_q_plain(
                q, k, v, do, plse, delta, False), [()], 3)}
    lib_sets = [tuple(t.transpose(1, 2).contiguous().requires_grad_()
                      for t in st) for st in sets]
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        with torch.no_grad():
            lib_fwd = _timed_over_bound(lambda q_, k_, v_, do_:
                                        F.scaled_dot_product_attention(
                                            q_, k_, v_), lib_sets, 30,
                                        bounds["fwd"])
        graphs = [(F.scaled_dot_product_attention(q_, k_, v_), (q_, k_, v_),
                   do_) for q_, k_, v_, do_ in lib_sets]
        lib_bwd = _timed_over_bound(lambda out, ins, do_: torch.autograd.grad(
            out, ins, do_, retain_graph=True), graphs, 30,
            max(bounds["bwd_kv"], bounds["bwd_q"]))
    del graphs, lib_sets, bwd_args, sets
    rows = {}
    for key in ("fwd", "bwd_kv", "bwd_q"):
        flops, nbytes = work[key]
        t_ops = flops / BF16_FLOP_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        lib = lib_fwd if key == "fwd" else lib_bwd
        rows[key] = {"ms_per_call": kern[key]["ms"],
                     "ms": layers * kern[key]["ms"],
                     "plain_ms": layers * slow[key]["ms"],
                     "library_ms": layers * lib["ms"],
                     "bound_ms": layers * max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes",
                     "under_bound": kern[key]["under_bound"]
                     or lib["under_bound"],
                     "timing": _timing_label(kern[key], slow[key], lib)}
    return {"shape": shape, "layers": layers, "input_sets": copies,
            "fwd_route": fa.fwd_route(q, k, v),
            "bwd_route": fa.bwd_route(q, k, v, do),
            "bounds": {k_: list(v_) for k_, v_ in errs.items()},
            "readings": reads, "kernels": rows}


def _vit_trainer(dev, name, batches) -> tuple:
    """A Trainer over ``make_vit(name, use_flash=True)`` (bf16, the SGD
    kernel) on staged batches; the timed steps' flash launches exact, all
    on the route ``fwd_route``/``bwd_route`` pick for the model's q, k, v,
    none causal."""
    from tpu_ddp_torch.models.vit import make_vit
    from tpu_ddp_torch.ops import flash_attention as fa
    from tpu_ddp_torch.train.engine import Trainer
    from tpu_ddp_torch.utils.config import TrainConfig
    from tpu_ddp_torch.utils.flops import vit_fwd_flops
    model = make_vit(name, use_flash=True)
    cfg = TrainConfig(model=name, num_classes=model.num_classes,
                      image_size=model.image_size, pallas_sgd=True,
                      dataset="cifar10" if name == "ViT-tiny" else "imagenet")
    tr = Trainer(model, cfg, device=dev)
    state = tr.init_state()
    shape, layers = VIT_FLASH[name]
    q, k, v, do = _vit_qkv(shape, torch.Generator(device=dev), dev)
    routes = (fa.fwd_route(q, k, v), fa.bwd_route(q, k, v, do))
    del q, k, v, do
    wrappers = _flash_wrappers()
    for i in range(IMAGE_WARMUP):
        state, _ = tr.train_step(state, *batches[i % len(batches)])
    _zero_launches(wrappers)
    causal = []
    real_apply = fa._FlashAttention.apply

    def seen(q_, k_, v_, c_):
        causal.append(c_)
        return real_apply(q_, k_, v_, c_)

    with mock.patch.object(fa._FlashAttention, "apply", seen):
        state, ms, peak, losses = _timed_steps(tr, state, batches, dev)
    counts = _launches(wrappers)
    n = layers * (IMAGE_STEPS + IMAGE_WARMUP)
    want = {w: {r: (n if r == route else 0) for r in ("wgmma", "mma_sync")}
            for w, route in (("flash_fwd", routes[0]),
                             ("flash_bwd_kv", routes[1]),
                             ("flash_bwd_q", routes[1]))}
    if counts != want or any(causal) or len(causal) != n:
        fail(f"phase 37 {name}: flash launches {counts}, expected {want} "
             f"({IMAGE_WARMUP}+{IMAGE_STEPS} steps x {layers} layers, "
             f"non-causal; causal flags {set(causal)})")
    fwd_flops = vit_fwd_flops(model, shape[0])
    return tr, state, {
        "model": name, "params": model.num_params(), "batch": shape[0],
        "tokens": shape[1], "routes": list(routes), "launches": counts,
        "losses": losses, "ms_per_step": ms,
        "images_per_s": shape[0] / (ms / 1e3), "fwd_flops": fwd_flops,
        "mfu": 3 * fwd_flops / (ms / 1e3) / BF16_FLOP_PER_S,
        "peak_mem_gib": peak}


def _vit_step_check(tr, x, y) -> dict:
    """One step's loss and gradients through the flash kernels against
    the plain versions (phase 16's bounds), the same with the planted
    fault in every layer's forward (reported), and the three kernels row
    by row on the last layer's own q, k, v and dO, each gradient bound
    catching the fault there."""
    from tpu_ddp_torch.ops import flash_attention as fa
    from tpu_ddp_torch.ops.loss import cross_entropy_loss
    model = tr.model
    params = list(model.parameters())

    def loss_and_grads():
        loss = cross_entropy_loss(model(x), y)
        return loss.detach(), torch.autograd.grad(loss, params)

    with _last_attention_inputs(fa) as last:
        lk, gk = loss_and_grads()
    with mock.patch.multiple(fa, flash_fwd=fa.flash_fwd_plain,
                             flash_bwd_kv=fa.flash_bwd_kv_plain,
                             flash_bwd_q=fa.flash_bwd_q_plain):
        lp, gp = loss_and_grads()
    tile = min(FAULT_TILE, model.num_patches // 4)

    def faulty_fwd(q, k, v, causal):
        o, lse = fa.flash_fwd_plain(q, k, v, causal)
        f = _dropped_tile(q, k, v, None, {"o": o, "lse": lse}, causal, tile)
        return f["o"], f["lse"]

    with mock.patch.multiple(fa, flash_fwd=faulty_fwd,
                             flash_bwd_kv=fa.flash_bwd_kv_plain,
                             flash_bwd_q=fa.flash_bwd_q_plain):
        lf, gf = loss_and_grads()
    lk, lp, lf = float(lk), float(lp), float(lf)

    def frob(a, b):
        return float((a.float() - b.float()).norm()
                     / b.float().norm().clamp_min(1e-30))

    grad_k = max(frob(a, b) for a, b in zip(gk, gp))
    grad_f = max(frob(a, b) for a, b in zip(gf, gp))
    loss_k, loss_f = abs(lk - lp) / abs(lp), abs(lf - lp) / abs(lp)
    if not (math.isfinite(lk) and loss_k <= LM_STEP_TOL["loss"]):
        fail(f"phase 37 step loss: kernels {lk} vs plain {lp}")
    if not grad_k <= LM_STEP_TOL["grad"]:
        fail(f"phase 37 step grads: worst leaf's relative Frobenius error "
             f"{grad_k} > {LM_STEP_TOL['grad']}")
    if last["causal"]:
        fail("phase 37: the ViT's attention ran causal")
    with torch.no_grad():
        last_layer = _last_layer_check(fa, last)
    return {"loss_kernels": lk, "loss_plain": lp, "loss_rel_diff": loss_k,
            "grad_worst_leaf_frob": grad_k, "tol": LM_STEP_TOL,
            "planted_fault": {"tile": tile, "loss_rel_diff": loss_f,
                              "grad_worst_leaf_frob": grad_f},
            "last_layer_attention": last_layer}


def vit_train(dev, gen) -> dict:
    """Phase 37: (a) vit_cifar10 through ``run_part("part1")`` with the
    SGD kernel, 40 iterations (full_attention, as the JAX CLI runs it);
    (b) a Trainer on ViT-tiny with the flash kernels at batch 256, exact
    non-causal launches, one step held to the plain versions; (c) ViT-S16
    on synthetic ImageNet at batch 256 (L 196); the three kernels at both
    shapes timed beside SDPA's non-causal flash backend."""
    from tpu_ddp_torch.data.imagenet import create_imagenet_loaders
    from tpu_ddp_torch.data.loader import create_data_loaders
    from tpu_ddp_torch.ops import sgd as tsgd
    wrappers = {**_bn_wrappers(), **_flash_wrappers(),
                "sgd": tsgd.fused_sgd_step}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launches(wrappers)
    with _env(**{**PRESET_ENV, "TPU_DDP_PALLAS_BN": None,
                 "TPU_DDP_MAX_ITERS": str(TRAIN_ITERS),
                 "TPU_DDP_SYNTH_SIZE": str(SYNTH_SIZE)}):
        rc, out, wall = _run_part_captured(
            "part1", ["--config", "vit_cifar10", "--device", str(dev)])
    counts = _launches(wrappers)
    losses = [(int(i), float(v)) for i, v in
              re.findall(r"\[epoch 0, iter (\d+)\] loss: (\S+)", out)]
    test = re.search(r"Test set: average loss (\S+), accuracy (\d+)/(\d+)",
                     out)
    if rc != 0 or [i for i, _ in losses] != [20, 40] or not all(
            math.isfinite(v) for _, v in losses) or test is None \
            or not math.isfinite(float(test.group(1))):
        fail(f"phase 37 vit_cifar10: rc {rc}, losses {losses}, no finite "
             f"'Test set:' line:\n{out[-2000:]}")
    want = {k: ({r: 0 for r in w.launches} if isinstance(w.launches, dict)
                else 0) for k, w in wrappers.items()}
    want["sgd"] = TRAIN_ITERS
    if counts != want:
        fail(f"phase 37 vit_cifar10: launch counts {counts}, expected "
             f"{want}")
    avg_ms = _timer_ms(out)
    cli = {"losses": losses, "test_line": test.group(0), "launches": counts,
           "avg_iter_ms": avg_ms, "images_per_s": 256 / (avg_ms / 1e3),
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "wall_s": wall}
    print(json.dumps({"vit_cli": cli}), flush=True)

    train, _ = create_data_loaders(batch_size=256, synthetic_size=512)
    batches = [(x.to(dev), y.to(dev)) for x, y in train]
    tr, state, tiny = _vit_trainer(dev, "ViT-tiny", batches)
    tiny["step_check"] = _vit_step_check(tr, *batches[0])
    del tr, state, batches
    torch.cuda.empty_cache()
    with _env(IMAGENET_DIR=None):
        train, _ = create_imagenet_loaders(batch_size=256,
                                           synthetic_size=512)
    batches = [(x.to(dev), y.to(dev)) for x, y in train]
    tr, state, s16 = _vit_trainer(dev, "ViT-S16", batches)
    del tr, state, batches
    torch.cuda.empty_cache()
    kernels = {name: _vit_flash_times(dev, gen, name) for name in VIT_FLASH}
    return {"cli": cli, "vit_tiny": tiny, "vit_s16": s16,
            "flash_kernels": kernels}


# Phases 38-40: the loop's host side. Phase 38 runs vgg11_cifar10 at
# 60 iterations (20 past the timing window, where steps stay in flight)
# at each dispatch depth; phase 39 holds K steps per dispatch (one CUDA
# graph replay per group) to K * N eager steps, bit for bit.
DISPATCH_DEPTHS = (0, 2, 4)
DISPATCH_SYNTH = 15360
DISPATCH_ITERS = DISPATCH_SYNTH // 256
DISPATCH_TRACED = 12
GRAPH_GROUPS = {4: 3, 8: 2}    # K -> groups N held to K * N eager steps
GRAPH_TIMED = 40               # iterations of the stop_many timing epochs
HOST_ENV = dict(TPU_DDP_DISPATCH_DEPTH=None, TPU_DDP_STEPS_PER_DISPATCH=None,
                TPU_DDP_PREFETCH=None, TPU_DDP_NATIVE_LOADER=None,
                TPU_DDP_SHARD_EVAL=None, TPU_DDP_METRICS_FILE=None,
                TPU_DDP_PROFILE_DIR=None)


def _kernel_calls(prof, pats) -> int:
    """How many device launches of kernels named by ``pats`` a trace
    holds (graph replays' kernels included, where the tracer sees
    them)."""
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and any(p in e.key for p in pats))


TRACE_MARK = "spin_kernel"  # torch.cuda._sleep's kernel


@contextlib.contextmanager
def _counting_trace(warm):
    """A CUDA trace for counting a graph's replayed kernels: ``warm()``
    runs first, then a marker kernel, then the body; count with
    :func:`_calls_after_mark`. The tracer may lose the first records of
    the first graph launch it sees (one full run lost a replay's first
    38 kernels, its first three BN sites), so ``warm`` replays a group
    and undoes it, and only what follows the marker is counted."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        warm()
        torch.cuda._sleep(1000)
        yield prof
        torch.cuda.synchronize()


def _calls_after_mark(prof, pats) -> int:
    """Launches of kernels named by ``pats`` after the trace's marker
    (one stream, so device order is launch order)."""
    ev = sorted((e for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.start_ns())
    marks = [i for i, e in enumerate(ev) if TRACE_MARK in e.name()]
    if len(marks) != 1:
        fail(f"{len(marks)} marker kernels in a counting trace")
    return sum(1 for e in ev[marks[0] + 1:]
               if any(p in e.name() for p in pats))


def _warm_group(tr, state, start, batches, k) -> None:
    """One K-step group replayed, then the state put back to ``start``."""
    _graph_run(tr, state, batches[:k], k)
    _restore_all(state, start)


def _vgg_wrappers():
    from tpu_ddp_torch.ops import sgd as tsgd
    return {**_bn_wrappers(), "sgd": tsgd.fused_sgd_step}


def _vgg_want(steps: int, forward_only: int = 0) -> dict:
    """VGG-11's exact counts: 8 BN sites, one SGD launch per step."""
    fwd = 8 * (steps + forward_only)
    return {"sgd": steps, **_bn_bwd_want(8 * steps),
            "bn_stats": {"one_pass": fwd, "two_stage": 0},
            "bn_norm_relu": fwd}


def _epoch_record(path) -> dict:
    with open(path) as fh:
        lines = [json.loads(ln) for ln in fh]
    if not lines or any({"ts", "rank", "event"} - set(ln) for ln in lines):
        fail(f"metrics file {path}: lines without ts/rank/event")
    events = [ln["event"] for ln in lines]
    if events.count("epoch") != 1 or events.count("eval") != 1 \
            or "train_iter" not in events:
        fail(f"metrics file {path}: events {events}")
    return next(ln for ln in lines if ln["event"] == "epoch")


def _traced_epoch(tr, state, batches, sgd_per_step: float) -> tuple:
    """One train_epoch under the profiler: (state, wall ms per iteration,
    the device's busy ms per iteration, idle share, SGD launches the
    trace saw per iteration)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = tr.train_epoch(state, batches, log=lambda s: None)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    busy = sum(_device_us(prof).values()) / 1e3
    n = len(batches)
    seen = _kernel_calls(prof, VGG_KERNELS["sgd"]) / n
    return state, {"iters": n, "wall_ms_per_iter": wall / n,
                   "device_ms_per_iter": busy / n,
                   "device_idle_share": 1 - busy / wall,
                   "sgd_launches_traced_per_iter": seen,
                   "trace_sees_every_step": seen == sgd_per_step}


def dispatch_window(dev) -> dict:
    """Phase 38: vgg11_cifar10 part 1 through ``run_part`` at full width
    (batch 256, bf16, both kernel knobs), 60 iterations, at dispatch
    depth 0, 2 and 4 (cuDNN deterministic): the loss lines and the final
    params and momentum (the epoch-end checkpoint's digests) the same
    bits at every depth, launch counts exact, forced syncs at most
    ceil(20 / depth) + 1 (the 20 untimed iterations, the final drain),
    each run's JSONL metrics read back. Then the same trainer's epoch
    loop at each depth under the profiler: ms per iteration, host gap
    and the device's idle share."""
    import itertools
    import shutil

    from tpu_ddp_torch.data.loader import create_data_loaders
    runs = {}
    wrappers = _vgg_wrappers()
    base = os.path.join(CKPT_ROOT, "dispatch")
    try:
        for depth in DISPATCH_DEPTHS:
            ck = os.path.join(base, f"d{depth}")
            metrics = os.path.join(base, f"metrics_d{depth}.jsonl")
            _zero_launches(wrappers)
            out = _part1(dev, ["--ckpt-dir", ck], **{
                **HOST_ENV, "TPU_DDP_MAX_ITERS": None,
                "TPU_DDP_SYNTH_SIZE": DISPATCH_SYNTH,
                "TPU_DDP_CUDNN_DETERMINISTIC": 1,
                "TPU_DDP_DISPATCH_DEPTH": depth,
                "TPU_DDP_METRICS_FILE": metrics})
            counts = _launches(wrappers)
            test = re.search(r"accuracy \d+/(\d+)", out)
            evals = math.ceil(int(test.group(1)) / 256)
            want = _vgg_want(DISPATCH_ITERS, evals)
            if counts != want:
                fail(f"phase 38 depth {depth}: launches {counts}, expected "
                     f"{want}")
            rec = _epoch_record(metrics)
            untimed = DISPATCH_ITERS - TRAIN_ITERS  # past iteration 39
            bound = (DISPATCH_ITERS if depth == 0
                     else math.ceil(untimed / depth) + 1)
            if rec["dispatch_depth"] != depth or \
                    rec["forced_syncs"] > bound or \
                    rec["harvested"] != DISPATCH_ITERS:
                fail(f"phase 38 depth {depth}: window stats {rec}, forced "
                     f"syncs bound {bound}")
            runs[depth] = {
                "losses": re.findall(r"\] loss: (\S+)", out),
                "test_line": re.search(r"Test set: .*", out).group(0),
                "digests": _step_digests(ck, DISPATCH_ITERS),
                "avg_iter_ms": _timer_ms(out), "launches": counts,
                "window": {k: rec[k] for k in (
                    "forced_syncs", "sync_deliveries", "host_gap_ms",
                    "harvested", "max_in_flight")}}
    finally:
        shutil.rmtree(base, ignore_errors=True)
    ref = runs[0]
    for depth, run in runs.items():
        for key in ("losses", "test_line", "digests"):
            if run[key] != ref[key]:
                fail(f"phase 38: depth {depth}'s {key} differ from depth "
                     "0's")
    for run in runs.values():
        del run["digests"]
    # The epoch loop of one trainer at each depth: the timing window off,
    # so every step after the first may stay in flight.
    tr = _phase_trainer(dev)
    state = tr.init_state()
    with _env(**PRESET_ENV):
        train, _ = create_data_loaders(batch_size=256,
                                       synthetic_size=2560)
    host = list(itertools.islice(iter(train), 10))
    batches = [host[i % len(host)] for i in range(DISPATCH_TRACED)]
    tr.config.timing_first_iter, tr.config.timing_last_iter = 1, 0
    state, _ = tr.train_epoch(state, batches[:4], log=lambda s: None)
    traced = {}
    for depth in DISPATCH_DEPTHS:
        tr.config.dispatch_depth = depth
        state, traced[depth] = _traced_epoch(tr, state, batches, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, stats = tr.train_epoch(state, batches, log=lambda s: None)
        torch.cuda.synchronize()
        traced[depth].update(
            untraced_ms_per_iter=(time.perf_counter() - t0) * 1e3
            / len(batches), host_gap_ms=stats["host_gap_ms"],
            forced_syncs=stats["forced_syncs"])
    return {"iterations": DISPATCH_ITERS, "runs": runs, "traced": traced}


def _phase_trainer(dev, model=None, **cfg_over):
    """A vgg11_cifar10 trainer (both kernel knobs) built with the host
    knobs unset and cuDNN deterministic."""
    from tpu_ddp_torch.models import get_model
    from tpu_ddp_torch.train.engine import Trainer
    from tpu_ddp_torch.utils.config import TrainConfig
    with _env(**PRESET_ENV, **HOST_ENV):
        cfg = TrainConfig.preset("vgg11_cifar10", **cfg_over)
        if model is None:
            model = get_model(cfg.model, use_pallas_bn=True,
                              compute_dtype=getattr(torch,
                                                    cfg.compute_dtype))
        return Trainer(model, cfg, device=dev)


def _state_tensors(state) -> list:
    return [*state.params, *state.opt_state["momentum"]]


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _eager_run(tr, state, batches) -> tuple:
    """``len(batches)`` train steps; (losses, copies of params and
    momentum after each step, skipped flags)."""
    losses, after, skipped = [], [], []
    for x, y in batches:
        state, loss = tr.train_step(state, x, y)
        losses.append(loss.float())
        skipped.append(tr.last_step_skipped())
        after.append([t.detach().clone() for t in _state_tensors(state)])
    return torch.stack(losses), after, skipped


def _graph_run(tr, state, batches, k) -> tuple:
    """The same batches as groups of K through ``build_multi_step``:
    (losses, the (K, 2) rows of every group)."""
    multi = tr.build_multi_step(k)
    losses, rows = [], []
    for g in range(0, len(batches), k):
        grp = batches[g:g + k]
        state, loss = multi(state, *tr.put_batches(
            [b[0] for b in grp], [b[1] for b in grp]))
        losses.append(loss)
        rows.append(tr._last_fused)
    return torch.cat(losses), torch.cat(rows)


def _total(count) -> int:
    """A wrapper's launches over its routes."""
    return sum(count.values()) if isinstance(count, dict) else count


def _graph_case(tr, state, batches, k, groups, wrappers, per_step,
                pats) -> dict:
    """K-step groups against K * N eager steps from the same start: the
    losses, params and momentum the same bits; the wrappers' counts
    exact (they count one eager warm-up step and the K captured steps).
    Then the same groups again from the same start, replays only, under
    the profiler: the wrappers count nothing, and the trace holds each
    wrapper's kernels (``pats``) replays times the captured launches of
    one group, the same bits again."""
    n = k * groups
    start = [t.detach().clone() for t in _state_tensors(state)]
    e_loss, e_after, _ = _eager_run(tr, state, batches[:n])

    def same_as_eager(g_loss, what):
        if not (torch.equal(g_loss, e_loss)
                and _same(_state_tensors(state), e_after[-1])):
            fail(f"phase 39 K={k}: {groups} graph groups ({what}) differ "
                 f"from {n} eager steps (losses {g_loss.tolist()} vs "
                 f"{e_loss.tolist()})")

    _restore_all(state, start)
    stats0 = dict(tr.graph_stats)
    _zero_launches(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_loss, _ = _graph_run(tr, state, batches[:n], k)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = _launches(wrappers)
    captures = tr.graph_stats["captures"] - stats0["captures"]
    replays = tr.graph_stats["replays"] - stats0["replays"]
    want = per_step(1 + k)
    if (captures, replays) != (1, groups) or counts != want:
        fail(f"phase 39 K={k}: {captures} captures, {replays} replays, "
             f"launches {counts}; expected 1, {groups}, {want}")
    same_as_eager(g_loss, "first run")
    # The replays' own launches, read from a trace.
    _restore_all(state, start)
    with _counting_trace(lambda: _warm_group(tr, state, start, batches,
                                             k)) as prof:
        stats0 = dict(tr.graph_stats)
        _zero_launches(wrappers)
        g_loss, _ = _graph_run(tr, state, batches[:n], k)
    captures = tr.graph_stats["captures"] - stats0["captures"]
    replays = tr.graph_stats["replays"] - stats0["replays"]
    host = {name: _total(c) for name, c in _launches(wrappers).items()}
    group = {name: _total(c) for name, c in per_step(k).items()}
    traced = {name: _calls_after_mark(prof, pats[name])
              for name in wrappers}
    want = {name: replays * c for name, c in group.items()}
    if (captures, replays) != (0, groups) or any(host.values()) \
            or traced != want:
        fail(f"phase 39 K={k} replays: {captures} captures, {replays} "
             f"replays, host-counted launches {host}, traced kernels "
             f"{traced}; expected 0, {groups}, none, {want}")
    same_as_eager(g_loss, "replays only")
    return {"k": k, "groups": groups, "captures": 1,
            "replays": groups, "capture_ms":
                tr.graph_stats["capture_ms"][-1],
            "launches_counted": counts,
            "launches_replayed_traced": traced,
            "wall_ms_first_run": wall, "bitwise": True,
            "_eager": (e_loss, e_after)}


def _restore_all(state, copies) -> None:
    with torch.no_grad():
        for t, c in zip(_state_tensors(state), copies):
            t.copy_(c)


def _planted(tr, state, batches, start, case, target, name) -> dict:
    """Re-run ``case``'s groups from ``start`` under the profiler with
    ``name`` of ``_StepGraph`` sabotaged on its second call: whether the
    bitwise gate catches it, and whether the traced SGD kernels fall
    short of replays times one group's (a skipped replay must; a stale
    staging buffer launches all of them)."""
    from tpu_ddp_torch.train import engine
    real = getattr(engine._StepGraph, name)
    calls = []

    def sabotaged(self, *a):
        calls.append(1)
        if len(calls) != 2:
            return real(self, *a)
        return None

    _restore_all(state, start)
    with _counting_trace(lambda: _warm_group(tr, state, start, batches,
                                             case["k"])) as prof:
        replays0 = tr.graph_stats["replays"]
        with mock.patch.object(engine._StepGraph, name, sabotaged):
            g_loss, _ = _graph_run(tr, state, batches[:target], case["k"])
    replays = tr.graph_stats["replays"] - replays0
    e_loss, e_after = case["_eager"]
    return {"bitwise": not (torch.equal(g_loss, e_loss)
                            and _same(_state_tensors(state),
                                      e_after[target - 1])),
            "trace": _calls_after_mark(prof, VGG_KERNELS["sgd"])
            != replays * case["k"]}


def multi_step(dev) -> dict:
    """Phase 39: VGG-11 (vgg11_cifar10, both kernels, batch 256, cuDNN
    deterministic) at K = 4 and 8 steps per dispatch, each group one
    CUDA graph replay, bit for bit against K * N eager train_steps, with
    exact launch counts (the replays' kernels counted in a trace); two
    planted faults (a skipped replay, a stale staging buffer) each break
    the bitwise gate, and the skipped replay the trace's count; a state
    made anew (state_from_host) captures again; a group with one
    poisoned batch skips that step's update as the eager step does; ms
    per iteration from ``stop_many`` through the epoch loop at K = 1, 4
    and 8, the capture's ms and the device's idle share; ViT-tiny on the
    flash kernels at K = 4, bit for bit against 4 eager steps with exact
    flash launch counts."""
    import itertools

    from tpu_ddp_torch.data.loader import create_data_loaders
    wrappers = _vgg_wrappers()
    out = {}
    with _deterministic_cudnn():
        tr = _phase_trainer(dev)
        state = tr.init_state()
        with _env(**PRESET_ENV):
            train, _ = create_data_loaders(batch_size=256,
                                           synthetic_size=GRAPH_TIMED * 256)
        host = list(train)
        batches = [(x.to(dev), y.to(dev)) for x, y in host[:16]]
        for _ in range(2):  # cuDNN's and the kernels' first calls
            state, _ = tr.train_step(state, *batches[-1])
        # Detached: a copy that kept the parameters' autograd graph
        # alive would keep their gradient accumulators, made on the
        # default stream, and break the capture on its side stream.
        start = [t.detach().clone() for t in _state_tensors(state)]
        for k, groups in GRAPH_GROUPS.items():
            _restore_all(state, start)
            case = _graph_case(tr, state, batches, k, groups, wrappers,
                               _vgg_want, VGG_KERNELS)
            caught = {name: _planted(tr, state, batches, start, case,
                                     k * groups, name)
                      for name in ("replay", "stage")}
            if not (caught["replay"]["bitwise"] and caught["replay"]["trace"]
                    and caught["stage"]["bitwise"]):
                fail(f"phase 39 K={k}: a gate missed a planted fault: "
                     f"{caught}")
            del case["_eager"]
            out[f"k{k}"] = {**case, "planted_fault_caught": caught}
        # A state made anew holds other momentum tensors than the graphs
        # write: its first group captures again, the same bits as eager.
        _restore_all(state, start)
        e_loss, e_after, _ = _eager_run(tr, state, batches[:4])
        _restore_all(state, start)
        state = tr.state_from_host(tr.state_to_host(state))
        caps = tr.graph_stats["captures"]
        g_loss, _ = _graph_run(tr, state, batches[:4], 4)
        recaptured = tr.graph_stats["captures"] - caps
        if recaptured != 1 or not (
                torch.equal(g_loss, e_loss)
                and _same(_state_tensors(state), e_after[-1])):
            fail(f"phase 39: a group on a state made anew captured "
                 f"{recaptured} times; losses {g_loss.tolist()} vs eager "
                 f"{e_loss.tolist()}")
        out["new_state"] = {"captures": recaptured, "bitwise": True}
        # The guard inside a group: batch 1 of a K=4 group poisoned.
        _restore_all(state, start)
        bad = [batches[0], (batches[1][0].clone(), batches[1][1])] + \
            batches[2:4]
        bad[1][0][0, 0, 0, 0] = float("nan")
        e_loss, e_after, e_skip = _eager_run(tr, state, bad)
        kept = _same(e_after[1], e_after[0])
        _restore_all(state, start)
        g_loss, rows = _graph_run(tr, state, bad, 4)
        g_skip = [bool(v) for v in (rows[:, 1] != 0).tolist()]
        same = _same(_state_tensors(state), e_after[-1])
        if not (kept and same
                and e_skip == g_skip == [False, True, False, False]):
            fail(f"phase 39 guard in a group: eager skips {e_skip} (state "
                 f"kept: {kept}), graph skips {g_skip}, final state the "
                 f"same bits: {same}")
        out["guard_in_group"] = {"skipped": g_skip, "bitwise": True}
        # stop_many through the epoch loop, K = 1, 4, 8 (depth 2).
        timing = {}
        for k in (1, *GRAPH_GROUPS):
            tr.config.steps_per_dispatch = k
            state, stats = tr.train_epoch(state, host, log=lambda s: None)
            timing[f"k{k}"] = {"avg_iter_ms": stats["avg_iter_s"] * 1e3,
                               "timed_iters": stats["timed_iters"],
                               "host_gap_ms": stats["host_gap_ms"]}
        traced_batches = [host[i % len(host)] for i in range(24)]
        tr.config.timing_first_iter, tr.config.timing_last_iter = 1, 0
        for k in (1, *GRAPH_GROUPS):
            tr.config.steps_per_dispatch = k
            state, traced = _traced_epoch(tr, state, traced_batches, 1)
            timing[f"k{k}"]["traced"] = traced
        out["timing"] = timing
        out["graph_stats"] = dict(tr.graph_stats)
        del tr, state, batches, start
        torch.cuda.empty_cache()
        out["vit_tiny_k4"] = _vit_graph(dev)
    return out


def _vit_graph(dev) -> dict:
    """ViT-tiny (flash on, the SGD kernel, batch 256) at K = 4: one graph
    group bit for bit against 4 eager steps, the flash launches exact
    (6 per kernel per step, counted at the warm-up step and the capture)."""
    from tpu_ddp_torch.data.loader import create_data_loaders
    from tpu_ddp_torch.models.vit import make_vit
    from tpu_ddp_torch.ops import flash_attention as fa
    from tpu_ddp_torch.ops import sgd as tsgd
    from tpu_ddp_torch.train.engine import Trainer
    from tpu_ddp_torch.utils.config import TrainConfig
    model = make_vit("ViT-tiny", use_flash=True)
    with _env(**PRESET_ENV, **HOST_ENV):
        cfg = TrainConfig(model="ViT-tiny", num_classes=model.num_classes,
                          image_size=model.image_size, pallas_sgd=True)
        train, _ = create_data_loaders(batch_size=256, synthetic_size=1024)
    tr = Trainer(model, cfg, device=dev)
    state = tr.init_state()
    batches = [(x.to(dev), y.to(dev)) for x, y in train]
    state, _ = tr.train_step(state, *batches[-1])
    shape, layers = VIT_FLASH["ViT-tiny"]
    q, k, v, do = _vit_qkv(shape, torch.Generator(device=dev), dev)
    routes = (fa.fwd_route(q, k, v), fa.bwd_route(q, k, v, do))
    del q, k, v, do
    wrappers = {**_flash_wrappers(), "sgd": tsgd.fused_sgd_step}

    def want(steps):
        n = layers * steps
        out = {w: {r: (n if r == route else 0) for r in ("wgmma",
                                                          "mma_sync")}
               for w, route in (("flash_fwd", routes[0]),
                                ("flash_bwd_kv", routes[1]),
                                ("flash_bwd_q", routes[1]))}
        return {**out, "sgd": steps}

    case = _graph_case(tr, state, batches, 4, 1, wrappers, want,
                       {**FLASH_KERNELS, "sgd": VGG_KERNELS["sgd"]})
    del case["_eager"]
    return {**case, "routes": list(routes)}


def host_side(dev, resnet: dict, vit: dict) -> dict:
    """Phase 40: on the card, prefetch_to_device (pinned, side stream)
    gives the plain loader's batches on the device; the native loader's
    batches equal the numpy loader's (unaugmented, within 1e-6) and the
    one-shot C++ transform's (augmented, bit for bit);
    TPU_DDP_PROFILE_DIR writes a trace holding the kernels;
    bench_collectives at world 1 over NCCL (each op's
    output checked); mfu_fields with the H100's peak gives phase 36's
    and 37's MFU."""
    import glob
    import itertools
    import shutil

    from tpu_ddp_torch.data import native
    from tpu_ddp_torch.data.cifar10 import load_cifar10
    from tpu_ddp_torch.data.loader import DataLoader, create_data_loaders
    from tpu_ddp_torch.data.prefetch import prefetch_to_device
    from tpu_ddp_torch.launch import find_free_port
    from tpu_ddp_torch.parallel.bootstrap import (init_distributed_setup,
                                                  shutdown)
    from tpu_ddp_torch.utils.collectives import bench_collectives
    from tpu_ddp_torch.utils.flops import mfu_fields, peak_tflops
    out = {}
    tr = _phase_trainer(dev)
    with _env(**PRESET_ENV):
        train, _ = create_data_loaders(batch_size=256, synthetic_size=2048)
    plain = list(itertools.islice(iter(train), 4))
    got = list(prefetch_to_device(itertools.islice(iter(train), 4),
                                  tr.put_batch, 2))
    ok = len(got) == 4
    for (x, y), (gx, gy, ready) in zip(plain, got):
        gx, gy = tr._consume(gx, gy, ready)
        ok = ok and ready is not None and gx.is_cuda and torch.equal(
            gx.cpu(), x) and torch.equal(gy.cpu(), y)
        layout = gx.stride() == x.stride()
    if not ok:
        fail("phase 40: prefetch_to_device's batches differ from the "
             "loader's")
    out["prefetch"] = {"batches": 4, "same": True,
                       "loader_strides_kept": layout}
    with _env(**PRESET_ENV):
        xs, ys, _ = load_cifar10(None, "train", 2048)
    native.data_lib.get()  # the g++ build, outside the timed epoch
    t0 = time.perf_counter()
    nat = list(native.NativeDataLoader(xs, ys, 256, augment=False))
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = list(DataLoader(xs, ys, 256, augment=False))
    numpy_s = time.perf_counter() - t0
    aug = next(iter(native.NativeDataLoader(xs, ys, 256, augment=True)))
    one = native.transform_batch(xs, ys, np.arange(256), augment=True)
    # C++ rounds the normalisation once where numpy rounds twice: within
    # 1e-6 (the JAX package's own bound, tests/test_native.py).
    err = max((a[0] - b[0]).abs().max().item() for a, b in zip(nat, ref))
    same = (len(nat) == len(ref) and err <= 1e-6 and all(
        torch.equal(a[1], b[1]) for a, b in zip(nat, ref))
        and np.array_equal(aug[0].permute(0, 2, 3, 1).numpy(), one[0]))
    if not same:
        fail(f"phase 40: the native loader's batches differ from the "
             f"numpy loader's (max |d| {err}) or the one-shot transform's")
    out["native_loader"] = {"batches": len(nat), "max_abs_err": err,
                            "native_epoch_s": native_s,
                            "numpy_epoch_s": numpy_s}
    prof_dir = os.path.join(CKPT_ROOT, "profile")
    try:
        _part1(dev, [], **{**HOST_ENV, "TPU_DDP_MAX_ITERS": 3,
                           "TPU_DDP_SYNTH_SIZE": 2048,
                           "TPU_DDP_PROFILE_DIR": prof_dir})
        traces = glob.glob(os.path.join(prof_dir, "*.json"))
        text = open(traces[0]).read() if len(traces) == 1 else ""
        if "sgd_kernel" not in text or "bn_norm_relu_kernel" not in text:
            fail(f"phase 40: TPU_DDP_PROFILE_DIR wrote {traces}, without "
                 "the kernels")
        out["profile"] = {"trace_bytes": len(text)}
    finally:
        shutil.rmtree(prof_dir, ignore_errors=True)
    ctx = init_distributed_setup("127.0.0.1", str(find_free_port()), 0, 1,
                                 device=dev, ddp=True)
    try:
        out["collectives"] = bench_collectives(mb=4.0, iters=10,
                                               device=dev, check=True)
    finally:
        shutdown(ctx)
    peak, src = peak_tflops(dev)
    mfu = {}
    for name, res in (("resnet50", resnet),
                      ("vit_tiny", vit["vit_tiny"]),
                      ("vit_s16", vit["vit_s16"])):
        f = mfu_fields(3 * res["fwd_flops"], res["ms_per_step"] / 1e3, dev)
        if f["mfu"] is None or abs(f["mfu"] - res["mfu"]) > 5e-5:
            fail(f"phase 40: mfu_fields gives {f['mfu']} for {name}, "
                 f"phase 36/37 read {res['mfu']}")
        mfu[name] = {"mfu_fields": f["mfu"], "phase": res["mfu"]}
    out["mfu"] = {"peak_tflops": peak, "peak_source": src, **mfu}
    return out



LM_FZ_STEPS = 3


def _lm_state_differ(tr, state, ref_tr, ref_state) -> int:
    """How many leaves of two LM states (parameters and the optimizer's
    full canonical slots, compared on the card) differ in any bit."""
    from tpu_ddp_torch.utils.tree import tree_leaves
    a, b = tr._full_opt(state), ref_tr._full_opt(ref_state)
    if a["count"] != b["count"] or state.step != ref_state.step:
        return 1
    pairs = list(zip(tree_leaves(state.params), tree_leaves(ref_state.params)))
    pairs += [(x, y) for k in ("vr", "vc", "v", "mu")
              for x, y in zip(a[k], b[k])]
    return sum(not torch.equal(x, y) for x, y in pairs)


def lm_factored_zero1(dev, seed: int, recipe: dict) -> dict:
    """Phase 41: TransformerLM-large (batch 4 x seq 2048, bf16, flash)
    with phase 27's Adafactor, dropout, chunked loss and ``remat="dots"``
    under ``opt_sharding='zero1'`` (the row-sharded ``FactoredZeRO1``) at
    world 1 over NCCL, beside the replicated Adafactor run with the same
    settings (no clip: zero1 refuses one): one warm-up step and three
    steps each, the losses and every parameter the same bits, the flash
    launches exact; ms per step and peak memory beside phase 27's; the
    optimizer alone on one step's real gradients bit for bit; the three
    refusals; ``redistribute_state`` zero1 -> replicated -> zero1 bit for
    bit. Each run's peak memory is counted above what was allocated
    before it (the replicated run's state and parameters stay for the
    comparison)."""
    from tpu_ddp_torch.ops.optim import Adafactor
    from tpu_ddp_torch.parallel.redistribute import redistribute_state
    from tpu_ddp_torch.parallel.zero import FactoredZeRO1
    from tpu_ddp_torch.train.lm import LMTrainer
    from tpu_ddp_torch.utils.tree import tree_leaves
    model = _lm_large(dev, remat="dots", dropout_rate=RECIPE_DROPOUT)
    refusals = {}
    for name, kw in (("zero2", {"opt_sharding": "zero2"}),
                     ("fsdp", {"param_sharding": "fsdp"}),
                     ("zero1_clip", {"opt_sharding": "zero1",
                                     "clip_grad_norm": RECIPE_CLIP})):
        try:
            LMTrainer(model, device=dev, optimizer=Adafactor(), **kw)
        except ValueError as e:
            refusals[name] = str(e)
        else:
            fail(f"phase 41: Adafactor under {kw} was not refused")
    wrappers = _flash_wrappers()
    runs, trainers, states, finals = {}, {}, {}, {}
    with _group_of_one(dev):
        for name in ("replicated", "zero1"):
            torch.cuda.empty_cache()
            tr = LMTrainer(model, device=dev, optimizer=Adafactor(),
                           opt_sharding=name, vocab_chunk=RECIPE_CHUNK,
                           dropout_seed=seed)
            if (name == "zero1") != isinstance(tr.layout, FactoredZeRO1):
                fail(f"phase 41: {name} built layout {tr.layout!r}")
            # Peak memory is counted above what the earlier run still
            # holds (its state and final parameters).
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            x, y = _lm_tokens(model, tr)
            state = tr.init_state(seed=seed)
            state, loss = tr.train_step(state, x, y)
            losses = [loss]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            _zero_launches(wrappers)
            t0 = time.perf_counter()
            for _ in range(LM_FZ_STEPS):
                state, loss = tr.train_step(state, x, y)
                losses.append(loss)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / LM_FZ_STEPS
            counts = _launches(wrappers)
            n = model.num_layers * LM_FZ_STEPS
            if counts != _flash_want(2 * n, n):
                fail(f"phase 41: {name} flash launches {counts}, expected "
                     f"{_flash_want(2 * n, n)}")
            vals = [float(v) for v in losses]
            if not all(math.isfinite(v) for v in vals):
                fail(f"phase 41: {name} losses not finite: {vals}")
            runs[name] = {"losses": vals,
                          "losses_hex": [v.hex() for v in vals],
                          "ms_per_step": ms,
                          "tokens_per_s": LM_BATCH * LM_SEQ / (ms / 1e3),
                          "peak_mem_gib": (torch.cuda.max_memory_allocated(
                              dev) - base) / 2 ** 30, "launches": counts}
            finals[name] = [t.detach().clone() for t in
                            tree_leaves(state.params)]
            trainers[name], states[name] = tr, state
        if runs["zero1"]["losses_hex"] != runs["replicated"]["losses_hex"]:
            fail(f"phase 41: zero1 losses {runs['zero1']['losses']} != "
                 f"replicated {runs['replicated']['losses']}")
        differ = sum(not torch.equal(a, b) for a, b in
                     zip(finals["zero1"], finals["replicated"]))
        if differ:
            fail(f"phase 41: {differ} parameter leaves differ from the "
                 "replicated run's bits")
        del finals
        # The optimizer alone: one step's gradients through both.
        rtr, ztr = trainers["replicated"], trainers["zero1"]
        leaves = tree_leaves(states["replicated"].params)
        x, y = _lm_tokens(model, rtr)
        _, grads = rtr._loss_and_grads(leaves, states["replicated"].params,
                                       x, y, rtr.step_key(0))
        grads = [g.float() for g in grads]
        p_rep = [t.detach().clone() for t in leaves]
        p_z = [t.detach().clone() for t in leaves]
        full = ztr.layout.full_opt(states["zero1"].opt_state)
        rep_opt = {k: (v if k == "count" else [t.clone() for t in v])
                   for k, v in full.items()}
        z_opt = ztr.layout.local_opt(full)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Adafactor().apply(p_rep, grads, rep_opt)
        torch.cuda.synchronize()
        rep_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        new = ztr.layout.apply(p_z, grads, z_opt)
        torch.cuda.synchronize()
        z_ms = (time.perf_counter() - t0) * 1e3
        opt_differ = sum(not torch.equal(a, b) for a, b in zip(p_rep, new))
        back = ztr.layout.full_opt(z_opt)
        opt_differ += sum(not torch.equal(a, b) for k in ("vr", "vc", "v")
                          for a, b in zip(rep_opt[k], back[k]))
        if opt_differ:
            fail(f"phase 41: FactoredZeRO1 on one step's gradients: "
                 f"{opt_differ} leaves differ from Adafactor's bits")
        del p_rep, p_z, grads, new, full, rep_opt, z_opt, back
        # Live state zero1 -> replicated -> zero1, through the canonical
        # host tree; compared with the source on the card.
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        moved = redistribute_state(states["zero1"], ztr, rtr)
        torch.cuda.synchronize()
        redis_s = [time.perf_counter() - t0]
        t0 = time.perf_counter()
        back = redistribute_state(moved, rtr, ztr)
        torch.cuda.synchronize()
        redis_s.append(time.perf_counter() - t0)
        redis_differ = (_lm_state_differ(rtr, moved, ztr, states["zero1"])
                        + _lm_state_differ(ztr, back, ztr, states["zero1"]))
        if redis_differ:
            fail(f"phase 41: redistribute_state replicated <-> zero1: "
                 f"{redis_differ} leaves differ")
        del trainers, states, moved, back
    torch.cuda.empty_cache()
    return {"setting": {"optimizer": "Adafactor()",
                        "dropout": RECIPE_DROPOUT,
                        "vocab_chunk": RECIPE_CHUNK, "remat": "dots"},
            "batch": LM_BATCH, "seq": LM_SEQ, "steps": LM_FZ_STEPS,
            "runs": runs, "refusals": refusals,
            "phase27_replicated_with_clip": {
                "ms_per_step": recipe["ms_per_step"],
                "peak_mem_gib": recipe["peak_mem_gib"]},
            "optimizer_one_step_ms": {"replicated": rep_ms,
                                      "zero1": z_ms},
            "redistribute_s": {"zero1_to_replicated": redis_s[0],
                               "replicated_to_zero1": redis_s[1]}}


ELASTIC_ITERS = 40
ELASTIC_AT = 20  # the membership epoch fires after this step


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _part3_run(dev, ckpt, **env) -> str:
    """VGG-11 part 3 (DDP, NCCL at world 1) through ``run_part`` for
    ELASTIC_ITERS iterations, both kernels, cuDNN deterministic."""
    with _env(**{**VGG_ENV, "TPU_DDP_MAX_ITERS": str(ELASTIC_ITERS),
                 "TPU_DDP_CUDNN_DETERMINISTIC": "1", **env}):
        rc, out, _ = _run_part_captured(
            "part3", ["--num-nodes", "1", "--rank", "0", "--master-ip",
                      "127.0.0.1", "--master-port", str(_free_port()),
                      "--device", str(dev), "--ckpt-dir", ckpt])
    if rc != 0 or "Test set:" not in out:
        fail(f"phase 42: part3 {env} returned {rc} or printed no 'Test "
             "set:' line")
    return out


def _vgg_chain(dev) -> dict:
    """VGG-11 live state through part 3 -> 4 -> 5 -> 3 at world 1 with
    ``redistribute_state``: every move the canonical bits."""
    from tpu_ddp_torch.models.vgg import make_vgg
    from tpu_ddp_torch.parallel.redistribute import redistribute_state
    from tpu_ddp_torch.train.engine import Trainer
    from tpu_ddp_torch.utils.config import TrainConfig
    from tpu_ddp_torch.utils.tree import keyed_leaves
    cfg = TrainConfig(pallas_sgd=True, pallas_bn=True)
    gen = torch.Generator(device=dev).manual_seed(23)
    x = torch.randn(256, 3, 32, 32, device=dev, generator=gen)
    y = torch.randint(0, 10, (256,), device=dev, generator=gen)
    out = {}
    with _group_of_one(dev):
        src = Trainer(make_vgg("VGG11", use_pallas_bn=True), cfg,
                      strategy="fused", device=dev)
        state, _ = src.train_step(src.init_state(), x, y)
        want = keyed_leaves(src.state_to_host(state))
        cur_tr, cur = src, state
        for strategy in ("zero", "fsdp", "fused"):
            dst = Trainer(make_vgg("VGG11", use_pallas_bn=True), cfg,
                          strategy=strategy, device=dev)
            cur = redistribute_state(cur, cur_tr, dst)
            got = keyed_leaves(dst.state_to_host(cur))
            differ = sum(not np.array_equal(a, b)
                         for (_, a), (_, b) in zip(got, want))
            if differ or len(got) != len(want):
                fail(f"phase 42: redistribute to {strategy}: {differ} "
                     "leaves differ")
            out[f"to_{strategy}"] = "bit for bit"
            cur_tr = dst
        if redistribute_state(cur, cur_tr, cur_tr) is not cur:
            fail("phase 42: redistribute onto the same trainer copied")
    return out


def elastic_card(dev) -> dict:
    """Phase 42: VGG-11 part 3 (DDP over NCCL at world 1, batch 256, both
    kernels) with a membership epoch (world 1, a fresh coordinator port)
    published after step ELASTIC_AT through the controller's directory:
    the survivor's whole sequence on the card (state_to_host local_only,
    the NCCL group aborted, a new one, ``rebind`` with DDP rebuilt,
    state_from_host); the loss lines, test line and the final
    checkpoint's digests equal to an uninterrupted run's, the kernels'
    launches exact over the run; the reshard's seconds. Then VGG-11's
    live state through parts 3 -> 4 -> 5 -> 3 with ``redistribute_state``,
    bit for bit."""
    import shutil
    from tpu_ddp_torch.resilience import chaos, elastic
    root = os.path.join(CKPT_ROOT, "elastic")
    shutil.rmtree(root, ignore_errors=True)
    ctl_dir = os.path.join(root, "control")
    elastic.write_membership(ctl_dir, {
        "epoch": 0, "world": 1, "base_world": 1, "assignments": {"0": 0},
        "coordinator": f"127.0.0.1:{_free_port()}", "joiners": [],
        "dropped": []})
    wrappers = _vgg_wrappers()
    real_after = chaos.FaultInjector.after_step

    def publish_epoch(self, step, ckpt_dir=None):
        # The launcher's part at world 1: the next epoch's record.
        if step == ELASTIC_AT:
            elastic.write_membership(ctl_dir, {
                "epoch": 1, "world": 1, "base_world": 1,
                "assignments": {"0": 0},
                "coordinator": f"127.0.0.1:{_free_port()}",
                "joiners": [], "dropped": []})
        return real_after(self, step, ckpt_dir)

    reshard_s = []
    real_apply = elastic.apply_membership

    def timed_apply(*a, **kw):
        t0 = time.perf_counter()
        out = real_apply(*a, **kw)
        reshard_s.append(time.perf_counter() - t0)
        return out

    straight_dir = os.path.join(root, "straight")
    straight = _part3_run(dev, straight_dir, TPU_DDP_ELASTIC_RESHARD=None,
                          TPU_DDP_ELASTIC_DIR=None)
    _zero_launches(wrappers)
    with mock.patch.object(chaos.FaultInjector, "after_step",
                           publish_epoch), \
            mock.patch.object(elastic, "apply_membership", timed_apply):
        elastic_out = _part3_run(
            dev, os.path.join(root, "elastic"),
            TPU_DDP_ELASTIC_RESHARD="1", TPU_DDP_ELASTIC_DIR=ctl_dir,
            TPU_DDP_ELASTIC_RANK="0")
    counts = _launches(wrappers)
    m = re.search(r"\[elastic\] epoch 1: rank 0->0, world=1, resharded in "
                  r"(\S+)s", elastic_out)
    if m is None or len(reshard_s) != 1:
        fail("phase 42: no reshard, or more than one, in the elastic run")
    lines = {k: re.findall(r"\[epoch 0, iter \d+\] loss: \S+|Test set: .*",
                           o) for k, o in (("straight", straight),
                                           ("elastic", elastic_out))}
    if lines["elastic"] != lines["straight"] or len(lines["straight"]) != 3:
        fail(f"phase 42: loss and test lines {lines['elastic']} != "
             f"uninterrupted {lines['straight']}")
    if not os.path.exists(elastic.ack_path(ctl_dir, 1, 0)):
        fail("phase 42: the survivor wrote no ack for epoch 1")
    digests = _step_digests(os.path.join(root, "elastic"), ELASTIC_ITERS)
    if digests != _step_digests(straight_dir, ELASTIC_ITERS):
        fail("phase 42: final checkpoint digests differ from the "
             "uninterrupted run's")
    test = re.search(r"Test set: average loss \S+, accuracy \d+/(\d+)",
                     straight)
    eval_batches = math.ceil(int(test.group(1)) / 256)
    want = _vgg_want(ELASTIC_ITERS, eval_batches)
    if counts != want:
        fail(f"phase 42: launch counts {counts}, expected {want}")
    chain = _vgg_chain(dev)
    shutil.rmtree(root, ignore_errors=True)
    return {"iters": ELASTIC_ITERS, "membership_epoch_after_step":
            ELASTIC_AT, "reshard_s": reshard_s[0],
            "lines": lines["elastic"], "launches": counts,
            "eval_batches": eval_batches, "redistribute_vgg": chain}


# ---- phase 43: K steps per dispatch on every rung -----------------------

LADDER_K, LADDER_GROUPS = 4, 2   # two K-step groups against 8 eager steps
LADDER_PARTS = ("part2a", "part2b", "part3", "part4", "part5")
LADDER_TIMED = ("part3",)
LADDER_TRACED = 12  # iterations of each traced epoch in the rung timing
LM_GRAPH_K = 2


def _rung_trainer(dev, part, wire_at_one=False, **cfg_over):
    """A vgg11_cifar10 trainer (both kernel knobs) of ``part`` on the
    group of one. ``wire_at_one``: the config's gradient wire and
    bucketed overlap turned on at dp 1, where the trainer degrades them
    (there is nothing to compress or bucket across one rank); their
    device code and collectives run at any N, so the group of one
    captures what a larger group would."""
    import gc
    import warnings
    from tpu_ddp_torch.models import get_model
    from tpu_ddp_torch.train.engine import Trainer
    from tpu_ddp_torch.utils.config import TrainConfig
    with _env(**PRESET_ENV, **HOST_ENV), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = TrainConfig.preset("vgg11_cifar10", **cfg_over)
        model = get_model(cfg.model, use_pallas_bn=True,
                          compute_dtype=getattr(torch, cfg.compute_dtype))
        tr = Trainer(model, cfg, strategy=part, device=dev)
        if wire_at_one:
            tr.net = tr.model  # DDP goes, and its reducer's hooks with it
            gc.collect()
            tr.dp = 2
            tr._setup_compression()
            tr._setup_overlap()
            tr.dp = 1
    return tr


def _state_copy(tr, state) -> list:
    """Copies of every tensor a step of ``tr`` writes in place."""
    return [t.detach().clone() for t in tr._graph_written(state)]


def _put_back(tr, state, copies) -> None:
    with torch.no_grad():
        for t, c in zip(tr._graph_written(state), copies):
            t.copy_(c)


def _same_state(tr, state, copies) -> bool:
    return _same(tr._graph_written(state), copies)


def _eager_rows(tr, state, batches) -> tuple:
    """Eager train_steps: their ``[loss, skipped]`` rows, the state
    after each step."""
    rows, after = [], []
    for x, y in batches:
        state, loss = tr.train_step(state, x, y)
        rows.append(tr._bundle(loss, tr._last_fused))
        after.append(_state_copy(tr, state))
    return torch.stack(rows), after


def _group_rows(tr, state, batches, k) -> torch.Tensor:
    """The same batches as K-step groups through ``build_multi_step``:
    every group's (K, 2) rows."""
    multi = tr.build_multi_step(k)
    rows = []
    for g in range(0, len(batches), k):
        grp = batches[g:g + k]
        state, _ = multi(state, *tr.put_batches([b[0] for b in grp],
                                                [b[1] for b in grp]))
        rows.append(tr._last_fused)
    return torch.cat(rows)


def _remat_want(steps: int) -> dict:
    """VGG-11 under conv_stages: each BN site's forward kernels run
    again in the recompute (phase 29's 16 forward launches per step)."""
    want = _vgg_want(steps)
    want["bn_stats"] = {"one_pass": 16 * steps, "two_stage": 0}
    want["bn_norm_relu"] = 16 * steps
    return want


def _rung_case(tr, batches, label, per_step=_vgg_want) -> dict:
    """Two K-step groups against 8 eager steps from the same start: the
    ``[loss, skipped]`` rows and every tensor the step writes the same
    bits. Then the groups again from the start, replays only, under the
    profiler: the replays' BN and SGD kernels counted by name exactly,
    and the same bits again. Returns the record and the eager run."""
    wrappers = _vgg_wrappers()
    k, n = LADDER_K, LADDER_K * LADDER_GROUPS
    state = tr.init_state()
    for _ in range(2):  # cuDNN's and the kernels' first calls
        state, _ = tr.train_step(state, *batches[-1])
    start = _state_copy(tr, state)
    e_rows, e_after = _eager_rows(tr, state, batches[:n])

    def same_as_eager(g_rows, what):
        if not (torch.equal(g_rows, e_rows)
                and _same_state(tr, state, e_after[-1])):
            fail(f"phase 43 {label}: {LADDER_GROUPS} groups of {k} "
                 f"({what}) differ from {n} eager steps (rows "
                 f"{g_rows.tolist()} vs {e_rows.tolist()})")

    _put_back(tr, state, start)
    caps0 = tr.graph_stats["captures"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_rows = _group_rows(tr, state, batches[:n], k)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    if tr.graph_stats["captures"] - caps0 != 1:
        fail(f"phase 43 {label}: {tr.graph_stats['captures'] - caps0} "
             "captures for one group shape")
    same_as_eager(g_rows, "first run")
    _put_back(tr, state, start)

    def warm():
        _group_rows(tr, state, batches[:k], k)
        _put_back(tr, state, start)

    with _counting_trace(warm) as prof:
        reps0, caps0 = tr.graph_stats["replays"], tr.graph_stats["captures"]
        _zero_launches(wrappers)
        g_rows = _group_rows(tr, state, batches[:n], k)
    replays = tr.graph_stats["replays"] - reps0
    host = {name: _total(c) for name, c in _launches(wrappers).items()}
    traced = {name: _calls_after_mark(prof, VGG_KERNELS[name])
              for name in wrappers}
    want = {name: _total(c) for name, c in per_step(replays * k).items()}
    if (tr.graph_stats["captures"] - caps0, replays) != (0, LADDER_GROUPS) \
            or any(host.values()) or traced != want:
        fail(f"phase 43 {label} replays: {replays} replays, host-counted "
             f"launches {host}, traced kernels {traced}; expected "
             f"{LADDER_GROUPS}, none, {want}")
    same_as_eager(g_rows, "replays only")
    return {"k": k, "groups": LADDER_GROUPS, "bitwise": True,
            "rows": g_rows.tolist(), "capture_ms":
                tr.graph_stats["capture_ms"][-1],
            "first_run_ms": first_ms, "replayed_traced": traced,
            "_start": start, "_eager": (e_rows, e_after),
            "_state": state}


def _planted_ladder(tr, case, batches, label, patch) -> dict:
    """The case's groups again from its start, captured anew under
    ``patch`` (a fault planted in the capture): whether the bitwise gate
    catches it. The trainer captures anew afterwards."""
    state, n = case["_state"], LADDER_K * LADDER_GROUPS
    e_rows, e_after = case["_eager"]
    _put_back(tr, state, case["_start"])
    tr._multi_step_cache.clear()
    with patch:
        g_rows = _group_rows(tr, state, batches[:n], LADDER_K)
    caught = not (torch.equal(g_rows, e_rows)
                  and _same_state(tr, state, e_after[-1]))
    tr._multi_step_cache.clear()
    _put_back(tr, state, case["_start"])
    if not caught:
        fail(f"phase 43 {label}: the bitwise gate missed a planted fault")
    return {"caught": True}


def _stale_stage():
    """A stale staging buffer: the second group's batches never copied."""
    from tpu_ddp_torch.train import engine
    real, calls = engine._StepGraph.stage, []

    def stage(self, xs, ys):
        calls.append(1)
        if len(calls) != 2:
            real(self, xs, ys)

    return mock.patch.object(engine._StepGraph, "stage", stage)


def _carry_rebound():
    """A carry that is not written in place: the step's new seed and
    residual returned as new tensors (the state keeps the old ones)."""
    from tpu_ddp_torch.parallel.compress import GradCompressor

    def commit(skip, old, new):
        return new

    return mock.patch.object(GradCompressor, "commit",
                             staticmethod(commit))


def _guard_group(tr, case, batches) -> dict:
    """One poisoned batch (the second) inside a K-step group: the graph
    skips that step's update as the eager step does, the same bits."""
    state, start = case["_state"], case["_start"]
    bad = [batches[0], (batches[1][0].clone(), batches[1][1])] + \
        batches[2:LADDER_K]
    bad[1][0][0, 0, 0, 0] = float("nan")
    _put_back(tr, state, start)
    e_rows, e_after = _eager_rows(tr, state, bad)
    kept = _same(e_after[1], e_after[0])
    _put_back(tr, state, start)
    g_rows = _group_rows(tr, state, bad, LADDER_K)
    e_skip = [bool(v) for v in (e_rows[:, 1] != 0).tolist()]
    g_skip = [bool(v) for v in (g_rows[:, 1] != 0).tolist()]
    same = _same_state(tr, state, e_after[-1])
    if not (kept and same and e_skip == g_skip
            == [False, True, False, False]):
        fail(f"phase 43 guard in a part-3 group: eager skips {e_skip} "
             f"(state kept: {kept}), graph skips {g_skip}, final state "
             f"the same bits: {same}")
    _put_back(tr, state, start)
    return {"skipped": g_skip, "bitwise": True}


def _rung_timing(tr, state, host, traced_batches) -> dict:
    """ms per iteration through ``train_epoch`` at K = 1 and K = 4 (the
    iteration 1-39 timer, ``stop_many`` on groups), then a traced epoch
    at each K with the timing window off: wall and device ms per
    iteration and the device's idle share."""
    cfg = tr.config
    out = {}
    first, last = cfg.timing_first_iter, cfg.timing_last_iter
    for k in (1, LADDER_K):
        cfg.steps_per_dispatch = k
        cfg.timing_first_iter, cfg.timing_last_iter = first, last
        state, stats = tr.train_epoch(state, host, log=lambda s: None)
        cfg.timing_first_iter, cfg.timing_last_iter = 1, 0
        state, traced = _traced_epoch(tr, state, traced_batches, 1)
        out[f"k{k}"] = {"avg_iter_ms": stats["avg_iter_s"] * 1e3,
                        "timed_iters": stats["timed_iters"],
                        "traced": traced}
    cfg.steps_per_dispatch = 1
    cfg.timing_first_iter, cfg.timing_last_iter = first, last
    out["capture_ms"] = list(tr.graph_stats["capture_ms"])
    return out


def _lm_graph(dev, seed: int, layout: str) -> dict:
    """LM-large (batch 4 x seq 2048, bf16, flash, AdamW, the preset's
    block remat, no dropout) under ``layout`` at K = 2: one group through
    ``LMTrainer.build_multi_step`` against 2 eager steps from the same
    start, the losses, parameters and AdamW state (count included) the
    same bits; the capture's flash launches exact (its warm-up step and
    the 2 captured steps), and a replay's kernels counted in a trace;
    ms per step eager and replayed (each after the bit check, from the
    same start)."""
    from tpu_ddp_torch.train import capture
    from tpu_ddp_torch.train.lm import LMTrainer, make_lm_batch
    model = _lm_large(dev)
    tr = LMTrainer(model, device=dev, opt_sharding=layout)
    state = tr.init_state(seed=seed)
    rng = np.random.default_rng(seed + 43)
    pairs = [tr.put_batch(*make_lm_batch(rng.integers(
        0, model.vocab_size, size=(LM_BATCH, LM_SEQ + 1))))
        for _ in range(LM_GRAPH_K)]
    xs = torch.stack([x for x, _ in pairs])
    ys = torch.stack([y for _, y in pairs])
    state, _ = tr.train_step(state, xs[0], ys[0])  # first calls
    written = capture.written(state)
    start = [t.detach().clone() for t in written]

    def put_back():
        with torch.no_grad():
            for t, c in zip(written, start):
                t.copy_(c)

    def eager():
        st, losses = state, []
        for j in range(LM_GRAPH_K):
            st, loss = tr.train_step(st, xs[j], ys[j])
            losses.append(loss)
        return torch.stack(losses)

    e_losses = eager()
    e_after = [t.detach().clone() for t in written]
    put_back()
    wrappers = _flash_wrappers()
    _zero_launches(wrappers)
    multi = tr.build_multi_step(LM_GRAPH_K)
    state, g_losses = multi(state, xs, ys)
    counted = _launches(wrappers)
    steps = 1 + LM_GRAPH_K  # the warm-up step and the captured ones
    L = model.num_layers  # block remat: each forward runs again
    want = _flash_want(2 * L * steps, L * steps)
    if counted != want:
        fail(f"phase 43 LM {layout}: capture launches {counted}, "
             f"expected {want}")
    if not (torch.equal(g_losses, e_losses) and _same(written, e_after)):
        fail(f"phase 43 LM {layout}: the K={LM_GRAPH_K} group differs "
             f"from {LM_GRAPH_K} eager steps ({g_losses.tolist()} vs "
             f"{e_losses.tolist()})")
    ms = {}
    for name, fn in (("eager", eager), ("replay", lambda: multi(
            state, xs, ys))):
        put_back()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3 / LM_GRAPH_K
    put_back()

    def warm():
        multi(state, xs, ys)
        put_back()

    with _counting_trace(warm) as prof:
        _zero_launches(wrappers)
        state, g_losses = multi(state, xs, ys)
    traced = {name: _calls_after_mark(prof, FLASH_KERNELS[name][:1])
              for name in wrappers}
    want = {"flash_fwd": 2 * L * LM_GRAPH_K, "flash_bwd_kv": L * LM_GRAPH_K,
            "flash_bwd_q": L * LM_GRAPH_K}
    if traced != want or any(_total(c) for c in _launches(
            wrappers).values()):
        fail(f"phase 43 LM {layout}: replay traced {traced}, expected "
             f"{want}")
    if not (torch.equal(g_losses, e_losses) and _same(written, e_after)):
        fail(f"phase 43 LM {layout}: the replay differs from eager")
    return {"k": LM_GRAPH_K, "bitwise": True,
            "losses": g_losses.tolist(), "capture_launches": counted,
            "replay_traced": traced,
            "capture_ms": tr.graph_stats["capture_ms"][-1],
            "eager_ms_per_step": ms["eager"],
            "replay_ms_per_step": ms["replay"]}


def ladder_multi_step(dev, seed: int) -> dict:
    """Phase 43: K steps per dispatch on every rung at world 1 over NCCL
    (vgg11_cifar10 as published, both kernels, cuDNN deterministic):
    parts 2a, 2b, 3, 4 and 5 at K = 4 over two groups, each group one
    CUDA graph replay, bit for bit against 8 eager steps (rows, every
    parameter and all optimizer state), the replays' BN and SGD kernels
    counted exactly in a trace; part 3 with overlap (4 MiB buckets) and
    with the int8 wire (its carry in place), each catching a planted
    fault (a stale staging buffer, a carry rebound instead of written in
    place); part 1 under remat=conv_stages with the recompute's
    launches; a poisoned batch inside a part-3 group; ms per iteration
    at K = 1 and 4 for part 3 through ``train_epoch``, with the
    capture's ms and the traced idle share; then LM-large at K = 2
    through ``LMTrainer.build_multi_step``, replicated and zero1."""
    from tpu_ddp_torch.data.loader import create_data_loaders
    out = {"rungs": {}, "variants": {}, "timing": {},
           "versions": {"torch": torch.__version__,
                        "cuda": torch.version.cuda,
                        "nccl": ".".join(map(str, torch.cuda.nccl.version()))}}
    with _deterministic_cudnn(), _group_of_one(dev):
        with _env(**PRESET_ENV):
            train, _ = create_data_loaders(
                batch_size=256, synthetic_size=GRAPH_TIMED * 256)
        host = list(train)
        batches = [(x.to(dev), y.to(dev)) for x, y in host[:8]]
        traced_batches = [host[i % len(host)]
                          for i in range(LADDER_TRACED)]
        for part in LADDER_PARTS:
            tr = _rung_trainer(dev, part)
            case = _rung_case(tr, batches, part)
            if part == "part3":
                out["guard_in_group"] = _guard_group(tr, case, batches)
            if part in LADDER_TIMED:
                out["timing"][part] = _rung_timing(tr, case["_state"],
                                                   host, traced_batches)
            out["rungs"][part] = {k: v for k, v in case.items()
                                  if not k.startswith("_")}
            del tr, case
            torch.cuda.empty_cache()
        for name, over, fault in (
                ("part3_overlap", {"overlap": True, "bucket_mb": 4},
                 _stale_stage),
                ("part3_int8", {"grad_compress": "int8"}, _carry_rebound)):
            tr = _rung_trainer(dev, "part3", wire_at_one=True, **over)
            if (tr._overlap is None) == ("overlap" in over) or (
                    tr._comp_stateful != ("grad_compress" in over)):
                fail(f"phase 43 {name}: the variant is not on")
            case = _rung_case(tr, batches, name)
            if tr._comp_stateful:
                # The carry's seed after the start's 2 steps and 8 more.
                case["carry_seed"] = int(case["_state"].comp_state["seed"])
                if case["carry_seed"] != tr.config.seed + 10:
                    fail(f"phase 43 {name}: carry seed {case['carry_seed']}"
                         f" after 10 steps from {tr.config.seed}")
            case["planted_fault"] = _planted_ladder(tr, case, batches, name,
                                                    fault())
            if tr._overlap is not None:
                case["buckets"] = tr._overlap.plan.n_buckets
            out["variants"][name] = {k: v for k, v in case.items()
                                     if not k.startswith("_")}
            del tr, case
            torch.cuda.empty_cache()
        tr = _rung_trainer(dev, "part1", remat="conv_stages")
        case = _rung_case(tr, batches, "part1 remat=conv_stages",
                          per_step=_remat_want)
        out["variants"]["part1_remat_conv_stages"] = {
            k: v for k, v in case.items() if not k.startswith("_")}
        del tr, case, batches
        torch.cuda.empty_cache()
        for layout in ("replicated", "zero1"):
            out[f"lm_large_{layout}"] = _lm_graph(dev, seed, layout)
            torch.cuda.empty_cache()
    return out


TUNE_BATCHES = 16          # batches per trial epoch (K = 8 runs 2 groups)
TUNE_MAX_TRIALS = 48       # the search's trial budget
TUNE_TIMEOUT_S = 60.0      # one trial's warm-epoch ceiling
TUNE_CLI_ITERS = 16        # iterations of each run_part("part3") in (c)
TUNE_CLI_KNOBS = "steps_per_dispatch,pallas_bn"


def _tune_env() -> dict:
    """Every knob's env variable unset (a set one pins its knob, and the
    search would skip it), the tuner's own and the shrink knobs too."""
    from tpu_ddp_torch.tune.space import KNOBS
    env = dict.fromkeys([k.env for k in KNOBS], None)
    env.update(dict.fromkeys((
        "TPU_DDP_AUTOTUNE", "TPU_DDP_TUNE_SEMANTIC", "TPU_DDP_TUNE_KNOBS",
        "TPU_DDP_TUNE_ITERS", "TPU_DDP_TUNE_TIMEOUT_S",
        "TPU_DDP_TUNE_MAX_TRIALS", "TPU_DDP_TUNE_WINDOWS",
        "TPU_DDP_TUNE_CACHE_DIR", "TPU_DDP_CHECK_REPLICAS_EVERY"), None))
    env.update({k: v for k, v in {**PRESET_ENV, **HOST_ENV}.items()
                if v is None})
    return env


def _tune_want(runner, assignment, steps: int) -> dict:
    """A trial's exact counts over ``steps`` host-launched steps: SGD
    once per step with ``pallas_sgd``, the BN+ReLU kernels 8 per step
    each with ``pallas_bn`` (the forward ones again in a remat
    recompute); 0 with the knob off."""
    def get(f):
        return assignment.get(f, getattr(runner.base_cfg, f))

    fwd = 16 if get("remat") != "none" else 8
    bn = steps if get("pallas_bn") else 0
    return {"sgd": steps if get("pallas_sgd") else 0,
            "bn_stats": fwd * bn, "bn_norm_relu": fwd * bn,
            "bn_bwd_stats": 8 * bn, "bn_bwd_dx": 8 * bn}


def _counted_evaluate(real, wrappers, trials: list):
    """``TrialRunner.evaluate`` with each trial's kernel launches counted
    from 0 and its trainer's steps, captures, replays and warm-ups."""
    def evaluate(self, assignment, fidelity="short"):
        key = self.build_key(assignment)
        known = self._trainers.get(key)
        step0 = known[1].step if known else 0
        gs0 = (dict(known[0].graph_stats) if known
               else {"captures": 0, "replays": 0, "warmup_steps": 0})
        _zero_launches(wrappers)
        t0 = time.perf_counter()
        sps, reason = real(self, assignment, fidelity)
        rec = {"assignment": dict(assignment), "fidelity": fidelity,
               "steps_per_s": sps, "reason": reason,
               "wall_s": time.perf_counter() - t0,
               "launches": {n: _total(c)
                            for n, c in _launches(wrappers).items()}}
        if sps is not None:
            tr, st = self._trainers[key]
            gs = {f: tr.graph_stats[f] - gs0[f]
                  for f in ("captures", "replays", "warmup_steps")}
            k = assignment.get("steps_per_dispatch",
                               self.base_cfg.steps_per_dispatch)
            steps = st.step - step0
            eager = steps - gs["replays"] * k
            host = eager + gs["captures"] * k + gs["warmup_steps"]
            rec.update(steps=steps, eager_steps=eager, **gs,
                       host_launched_steps=host,
                       want=_tune_want(self, assignment, host))
        trials.append(rec)
        return sps, reason
    return evaluate


def _same_host_state(a: dict, b: dict) -> bool:
    from tpu_ddp_torch.utils.tree import keyed_leaves
    la, lb = keyed_leaves(a), keyed_leaves(b)
    return [k for k, _ in la] == [k for k, _ in lb] and all(
        np.array_equal(x, y) for (_, x), (_, y) in zip(la, lb))


def _k_switch(dev) -> dict:
    """One part-3 trainer (both kernels) at K = 4, then K = 1, then K = 4
    again, as the tuner switches K on a cached trial trainer: the first
    K = 4 epoch rebuilds DDP for capture, the K = 1 epoch runs eager steps
    on it and must give the bits of the same steps on a trainer whose DDP
    was built for eager steps, from the same state, and the last K = 4
    epoch replays the graph it has without capturing again."""
    from tpu_ddp_torch.tune.runner import host_batches
    quiet = dict(log=lambda s: None)
    with _deterministic_cudnn():
        tr = _rung_trainer(dev, "part3")
        eager_ddp = not tr._ddp_graphed
        batches = host_batches(tr.config, 2 * LADDER_K)
        state = tr.init_state()
        tr.config.steps_per_dispatch = LADDER_K
        state, _ = tr.train_epoch(state, batches, **quiet)
        caps = tr.graph_stats["captures"]
        start = tr.state_to_host(state)
        tr.config.steps_per_dispatch = 1
        state, _ = tr.train_epoch(state, batches[:LADDER_K], **quiet)
        got = tr.state_to_host(state)
        ref = _rung_trainer(dev, "part3")
        rstate = ref.state_from_host(start)
        rstate, _ = ref.train_epoch(rstate, batches[:LADDER_K], **quiet)
        same = _same_host_state(got, ref.state_to_host(rstate))
        del ref, rstate
        tr.config.steps_per_dispatch = LADDER_K
        state, _ = tr.train_epoch(state, batches, **quiet)
        recaptures = tr.graph_stats["captures"] - caps
    rec = {"built_for_eager": eager_ddp, "graphed_after_k4":
           tr._ddp_graphed, "captures_first_k4": caps,
           "eager_bits_equal": same, "recaptures": recaptures}
    if not (eager_ddp and tr._ddp_graphed and caps == 1 and same
            and recaptures == 0):
        fail(f"phase 44 K switch: {rec}")
    return rec


def _tune_cli(dev, cache: str) -> dict:
    """``run_part("part3")`` under TPU_DDP_AUTOTUNE=search, then cached,
    on one tuning cache: the configs ``tune.resolve`` hands the run, the
    provenance lines, iterations trained and the test line of each."""
    from tpu_ddp_torch import tune
    real, resolved = tune.resolve, []

    def recording(cfg, **kw):
        out = real(cfg, **kw)
        resolved.append(dataclasses.asdict(out))
        return out

    env = {**_tune_env(), "TPU_DDP_TUNE_CACHE_DIR": cache,
           "TPU_DDP_TUNE_KNOBS": TUNE_CLI_KNOBS, "TPU_DDP_TUNE_ITERS": "8",
           "TPU_DDP_MAX_ITERS": str(TUNE_CLI_ITERS),
           "TPU_DDP_SYNTH_SIZE": "4096"}
    runs = {}
    for mode in ("search", "cached"):
        with _env(**{**env, "TPU_DDP_AUTOTUNE": mode}), \
                mock.patch.object(tune, "resolve", recording):
            rc, out, wall = _run_part_captured(
                "part3", ["--num-nodes", "1", "--device", str(dev)])
        line = re.search(r"\[autotune\] (search|cache hit): trials=(\d+) "
                         r"(?:quarantined=(\d+) .*?)?overrides=(\{.*?\})",
                         out)
        iters = re.search(r"; (\d+) iters total", out)
        test = re.search(r"Test set: average loss (\S+),", out)
        runs[mode] = {
            "rc": rc, "wall_s": wall,
            "line": line.group(0) if line else None,
            "trials": int(line.group(2)) if line else None,
            "quarantined": int(line.group(3) or 0) if line else None,
            "overrides": json.loads(line.group(4)) if line else None,
            "iters": int(iters.group(1)) if iters else None,
            "test_loss": float(test.group(1)) if test else None}
    s, c = runs["search"], runs["cached"]
    ok = (s["rc"] == c["rc"] == 0 and s["line"] and c["line"]
          and c["line"].startswith("[autotune] cache hit: trials=0")
          and s["quarantined"] == 0 and s["trials"] > 0
          and c["overrides"] == s["overrides"]
          and len(resolved) == 2 and resolved[0] == resolved[1]
          and resolved[1]["autotune"] == "off"
          and s["iters"] == c["iters"] == TUNE_CLI_ITERS
          and all(r["test_loss"] is not None
                  and math.isfinite(r["test_loss"]) for r in runs.values()))
    if not ok:
        fail(f"phase 44 CLI: {runs}, resolved configs equal: "
             f"{len(resolved) == 2 and resolved[0] == resolved[1]}")
    return {**runs, "tuned_config": {
        f: resolved[1][f] for f in ("steps_per_dispatch", "pallas_bn",
                                    "pallas_sgd", "dispatch_depth")}}


def autotune_card(dev) -> dict:
    """Phase 44: the autotuner at world 1 over NCCL on vgg11_cifar10 as
    published: the search with every trial's kernel launches counted, a
    cached trial trainer switching K, and the CLI's search-then-cached
    runs."""
    import shutil
    from tpu_ddp_torch import tune
    from tpu_ddp_torch.tune import runner as trunner
    wrappers = _vgg_wrappers()
    trials: list = []
    with _env(**_tune_env()), _group_of_one(dev):
        with mock.patch.object(trunner.TrialRunner, "evaluate",
                               _counted_evaluate(trunner.TrialRunner.evaluate,
                                                 wrappers, trials)):
            t0 = time.perf_counter()
            res = tune.tuned_vs_default(
                "vgg11_cifar10", strategy="fused", device=dev,
                n_batches=TUNE_BATCHES, max_trials=TUNE_MAX_TRIALS,
                timeout_s=TUNE_TIMEOUT_S)
            search_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        k_switch = _k_switch(dev)
        torch.cuda.empty_cache()
    summary = {k: res[k] for k in ("searched_knobs", "trials", "quarantined",
                                   "mode", "default_steps_per_sec",
                                   "tuned_steps_per_sec", "overrides")}
    summary["wall_s"] = search_s
    print(json.dumps({"autotune_search": summary}), flush=True)
    print("autotune trials: " + "; ".join(
        f"{'L' if t['fidelity'] == 'long' else 'S'} "
        + ",".join(f"{k}={v}" for k, v in t["assignment"].items())
        + (f" {t['steps_per_s']:.1f}/s" if t["steps_per_s"] else
           f" [{(t['reason'] or '')[:40]}]") for t in trials), flush=True)
    missing = {"pallas_sgd", "pallas_bn"} - set(res["searched_knobs"])
    if missing:
        fail(f"phase 44: the search space lacks {sorted(missing)}: "
             f"{res['searched_knobs']}")
    bad = [t for t in trials if (t["reason"] or "").startswith("quarantin")]
    if res["quarantined"] or bad:
        fail(f"phase 44: quarantined trials: {bad}")
    d, tuned = res["default_steps_per_sec"], res["tuned_steps_per_sec"]
    if d is None or tuned is None or tuned < d:
        fail(f"phase 44: tuned {tuned} < default {d} steps/s")
    ran = [t for t in trials if t["steps_per_s"] is not None]
    wrong = [t for t in ran if t["launches"] != t["want"]]
    if wrong or not ran:
        fail(f"phase 44: launch counts differ from the trials' steps: "
             f"{wrong[:3]}")
    on = {name: [t for t in ran if t["want"][name]] for name in wrappers}
    off = {name: [t for t in ran if not t["want"][name]]
           for name in wrappers}
    if not all(on.values()) or not all(off.values()):
        fail("phase 44: no trial ran with each kernel knob both on and "
             f"off: {({n: (len(on[n]), len(off[n])) for n in wrappers})}")
    launches = {
        "trials_on": {n: len(v) for n, v in on.items()},
        "trials_off": {n: len(v) for n, v in off.items()},
        "launched": {n: sum(t["launches"][n] for t in ran)
                     for n in wrappers},
        "host_launched_steps_on": {
            n: sum(t["host_launched_steps"] for t in v)
            for n, v in on.items()},
        "steps_on": {n: sum(t["steps"] for t in v) for n, v in on.items()},
        "replays_on": {n: sum(t["replays"] for t in v)
                       for n, v in on.items()}}
    print(json.dumps({"autotune_launches": launches}), flush=True)
    cache = os.path.join(CKPT_ROOT, "tune_cache")
    try:
        cli = _tune_cli(dev, cache)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    return {"search": {**summary, "fingerprint": res["fingerprint"]},
            "trials": trials, "launches": launches, "k_switch": k_switch,
            "cli": cli}


# ---- phases 45-47: dropout under capture, mixture of experts ---------

MOE_PRESET = "TransformerLM-moe-large"
MOE_WARMUP, MOE_STEPS, MOE_TRACED = 1, 3, 2
MOE_GRAPH_K = 2


def _host_copy(tensors) -> list:
    """Copies of ``tensors`` in host memory (a full-size MoE state does
    not fit twice more on the card)."""
    return [t.detach().to("cpu", copy=True) for t in tensors]


def _same_as_host(tensors, host) -> bool:
    return all(torch.equal(t.detach().cpu(), h)
               for t, h in zip(tensors, host))


@torch.no_grad()
def _put_host(tensors, host) -> None:
    for t, h in zip(tensors, host):
        t.copy_(h)


def dropout_capture(dev, seed: int) -> dict:
    """Phase 45: TransformerLM-large (full width, batch 4 x seq 2048,
    bf16, flash, AdamW, the preset's block remat) with dropout 0.1 at
    K = 2 through ``LMTrainer.build_multi_step``: one graph replay against
    2 eager steps from the same state, the losses, parameters and AdamW
    state the same bits; the step counter then moved on by K (the same
    params, batches and graph): a second replay draws other masks, so
    its losses differ, and they equal 2 eager steps at that count. Flash
    launches exact for the eager steps and the capture; ms per step eager
    and replayed; the mask hash alone against ``torch.rand``."""
    from tpu_ddp_torch.models.transformer import keep_mask
    from tpu_ddp_torch.train.lm import LMTrainer, make_lm_batch
    model = _lm_large(dev, dropout_rate=RECIPE_DROPOUT)
    tr = LMTrainer(model, device=dev, dropout_seed=seed)
    state = tr.init_state(seed=seed)
    rng = np.random.default_rng(seed + 45)
    pairs = [tr.put_batch(*make_lm_batch(rng.integers(
        0, model.vocab_size, size=(LM_BATCH, LM_SEQ + 1))))
        for _ in range(LM_GRAPH_K)]
    xs = torch.stack([x for x, _ in pairs])
    ys = torch.stack([y for _, y in pairs])
    state, _ = tr.train_step(state, xs[0], ys[0])  # first calls
    written = tr._written(state)
    start = [t.detach().clone() for t in written]
    count = state.opt_state["count"]

    def put_back(advance: int = 0):
        with torch.no_grad():
            for t, c in zip(written, start):
                t.copy_(c)
            count.add_(advance)

    def eager():
        st, losses = state, []
        for j in range(LM_GRAPH_K):
            st, loss = tr.train_step(st, xs[j], ys[j])
            losses.append(loss)
        return torch.stack(losses)

    L = model.num_layers  # block remat: each forward runs again
    wrappers = _flash_wrappers()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launches(wrappers)
    e_losses = eager()
    eager_counts = _launches(wrappers)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    want = _flash_want(2 * L * LM_GRAPH_K, L * LM_GRAPH_K)
    if eager_counts != want:
        fail(f"phase 45: eager launches {eager_counts}, expected {want}")
    e_after = [t.detach().clone() for t in written]
    put_back()
    _zero_launches(wrappers)
    multi = tr.build_multi_step(LM_GRAPH_K)
    _, g_losses = multi(state, xs, ys)
    counted = _launches(wrappers)
    want = _flash_want(2 * L * (1 + LM_GRAPH_K), L * (1 + LM_GRAPH_K))
    if counted != want:
        fail(f"phase 45: capture launches {counted}, expected {want}")
    if not (torch.equal(g_losses, e_losses) and _same(written, e_after)):
        fail(f"phase 45: the K={LM_GRAPH_K} replay with dropout differs "
             f"from {LM_GRAPH_K} eager steps ({g_losses.tolist()} vs "
             f"{e_losses.tolist()})")
    # The same params and batches K steps later: other masks.
    put_back(LM_GRAPH_K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e2_losses = eager()
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / LM_GRAPH_K
    e2_after = [t.detach().clone() for t in written]
    put_back(LM_GRAPH_K)
    _, g2_losses = multi(state, xs, ys)
    if not (torch.equal(g2_losses, e2_losses)
            and _same(written, e2_after)):
        fail(f"phase 45: the second replay differs from eager steps at "
             f"its count ({g2_losses.tolist()} vs {e2_losses.tolist()})")
    if bool((g2_losses == g_losses).any()):
        fail(f"phase 45: the second replay drew the first replay's masks "
             f"({g2_losses.tolist()} vs {g_losses.tolist()})")
    del e_after, e2_after
    put_back()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    multi(state, xs, ys)
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) * 1e3 / LM_GRAPH_K
    put_back()
    if tr.graph_stats["captures"] != 1:
        fail(f"phase 45: {tr.graph_stats['captures']} captures, expected 1")
    # The mask alone: the hash over a (4, 2048, 2048) activation against
    # the generator draw it replaced (torch.rand, a library call).
    shape = (LM_BATCH, LM_SEQ, model.d_model)
    key = torch.tensor(seed, dtype=torch.int64, device=dev)
    mask_ms = cuda_ms(lambda: keep_mask(key, shape, 0.9, dev), [()], 10)
    rand_ms = cuda_ms(lambda: torch.rand(shape, device=dev) < 0.9, [()],
                      10)
    del start
    return {"model": model.name, "dropout": RECIPE_DROPOUT,
            "k": LM_GRAPH_K, "bitwise": True,
            "losses": g_losses.tolist(),
            "second_replay_losses": g2_losses.tolist(),
            "eager_launches": eager_counts, "capture_launches": counted,
            "capture_ms": tr.graph_stats["capture_ms"][-1],
            "eager_ms_per_step": eager_ms, "replay_ms_per_step": replay_ms,
            "eager_peak_mem_gib": peak,
            "mask_ms": mask_ms, "torch_rand_mask_ms": rand_ms,
            "masks_per_step": 4 * L + 1}


def _moe_trainer(dev, seed: int, batch: int):
    from tpu_ddp_torch.models.transformer import make_transformer
    from tpu_ddp_torch.ops.optim import Adafactor
    from tpu_ddp_torch.train.lm import LMTrainer, make_lm_batch
    model = make_transformer(MOE_PRESET, max_seq_len=LM_SEQ, use_flash=True)
    tr = LMTrainer(model, device=dev, optimizer=Adafactor())
    tokens = np.random.default_rng(seed + 46).integers(
        0, model.vocab_size, size=(batch, LM_SEQ + 1))
    return model, tr, tokens, tr.put_batch(*make_lm_batch(tokens))


def _moe_steps(tr, state, x, y, n: int):
    losses = []
    for _ in range(n):
        state, loss = tr.train_step(state, x, y)
        losses.append(loss)
    return state, losses


def moe_large_train(dev, seed: int) -> dict:
    """Phase 46: TransformerLM-moe-large as published (12 layers, d_model
    2048, 16 experts of d_ff 4096, top-2, capacity factor 1.25, block
    remat) at batch 4 x seq 2048, bf16, flash, Adafactor: eager steps
    (ms/step, tokens/s, MFU by active FLOPs, peak GiB, exact flash
    launches, the routing counters at init and after the timed steps);
    one step's loss and gradients through the kernels against the plain
    flash with the routing pinned to the kernels' choices (phase 16's
    bounds); a
    K = 2 graph against 2 eager steps, bit for bit. If Adafactor's peak
    does not fit the card, the batch is halved (never the width) and the
    cut printed."""
    from tpu_ddp_torch.ops import flash_attention as fa
    from tpu_ddp_torch.train.lm import format_route_stats
    from tpu_ddp_torch.utils.flops import transformer_fwd_flops
    from tpu_ddp_torch.utils.tree import tree_leaves
    batch, cuts = LM_BATCH, []
    while True:
        try:
            t0 = time.perf_counter()
            model, tr, tokens, (x, y) = _moe_trainer(dev, seed, batch)
            state = tr.init_state(seed=seed)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            init_stats = tr.route_stats(state, tokens[:, :-1])
            state, warm = _moe_steps(tr, state, x, y, MOE_WARMUP)
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError as e:
            if batch == 1:
                raise
            cuts.append({"batch": batch, "reason": str(e)[:300]})
            print(f"phase 46: batch {batch} does not fit ({e}); "
                  f"cutting to {batch // 2}", flush=True)
            tr = state = x = y = None
            torch.cuda.empty_cache()
            batch //= 2
    params = sum(p.numel() for p in tree_leaves(state.params))
    L = model.num_layers
    wrappers = _flash_wrappers()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launches(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, timed = _moe_steps(tr, state, x, y, MOE_STEPS)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / MOE_STEPS
    counts = _launches(wrappers)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    want = _flash_want(2 * L * MOE_STEPS, L * MOE_STEPS)
    if counts != want:
        fail(f"phase 46 launch counts {counts}, expected {want}")
    losses = [float(v) for v in warm + timed]
    if not all(math.isfinite(v) for v in losses):
        fail(f"phase 46 losses not finite: {losses}")
    fwd_flops = transformer_fwd_flops(model, batch, LM_SEQ)
    # Where the step's time goes: a profiler window of MOE_TRACED steps.
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = _moe_steps(tr, state, x, y, MOE_TRACED)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us = _device_us(prof)
    busy_ms = sum(dev_us.values()) / 1e3

    def kind_ms(pattern):
        return sum(v for n, v in dev_us.items()
                   if re.search(pattern, n)) / 1e3 / MOE_TRACED

    window = {"steps": MOE_TRACED, "wall_ms": wall_ms,
              "device_ms_per_step": busy_ms / MOE_TRACED,
              "device_idle_share": 1 - busy_ms / wall_ms,
              "untraced_idle_share": 1 - busy_ms / MOE_TRACED
              / (step_s * 1e3),
              "gemm_ms_per_step": kind_ms(r"gemm|sm90_xmma|cutlass|nvjet"),
              "flash_ms_per_step": _flash_window(prof, MOE_TRACED)[
                  "by_wrapper"],
              "index_ms_per_step": kind_ms(r"index|gather|scatter"),
              "top_kernels_ms": [[k[:90], v / 1e3 / MOE_TRACED] for k, v in
                                 sorted(dev_us.items(),
                                        key=lambda kv: -kv[1])[:12]]}
    stats = tr.route_stats(state, tokens[:, :-1])
    route_line = format_route_stats(stats)

    def mean_dropped(stats):
        return float(np.mean([float(s["dropped_frac"]) for s in stats]))

    # Kernels against the plain flash on one step's loss and gradients
    # (phase 16's bounds). The attention output's bf16 noise flips the
    # router's choice where two experts' probabilities nearly tie, and a
    # flipped token moves its whole contribution between experts, so the
    # plain run routes with the kernels' choices (each call's experts and
    # slots, its gates and aux from its own logits); the share of choices
    # that its own logits would have moved is reported.
    leaves = tree_leaves(state.params)
    with _route_record() as rec:
        lk, gk = tr._loss_and_grads(leaves, state.params, x, y)
    with _route_pinned(rec) as moved_log, mock.patch.multiple(
            fa, flash_fwd=fa.flash_fwd_plain,
            flash_bwd_kv=fa.flash_bwd_kv_plain,
            flash_bwd_q=fa.flash_bwd_q_plain):
        lp, gp = tr._loss_and_grads(leaves, state.params, x, y)
    if rec:
        fail(f"phase 46: the plain run routed {len(rec)} calls fewer "
             "than the kernels' run")
    lk, lp = float(lk), float(lp)
    names = [n for n, _ in _keyed(state.params)]
    frob = sorted(((float((a.float() - b.float()).norm()
                          / b.float().norm().clamp_min(1e-30)), n)
                   for n, a, b in zip(names, gk, gp)), reverse=True)
    del gk, gp
    # The forward's L routing calls (the recompute repeats them).
    moved = moved_log[:L]
    loss_k = abs(lk - lp) / abs(lp)
    if not (math.isfinite(lk) and loss_k <= LM_STEP_TOL["loss"]):
        fail(f"phase 46 step loss: kernels {lk} vs plain {lp} (tol "
             f"{LM_STEP_TOL['loss']} rel)")
    if not frob[0][0] <= LM_STEP_TOL["grad"]:
        fail(f"phase 46 step grads: kernels vs plain, worst leaf "
             f"{frob[0][1]}'s relative Frobenius error {frob[0][0]} > "
             f"{LM_STEP_TOL['grad']}")

    # K = 2 as one CUDA graph against 2 eager steps from the same state.
    written = tr._written(state)
    start = _host_copy(written)
    t0 = time.perf_counter()
    state, e_losses = _moe_steps(tr, state, x, y, MOE_GRAPH_K)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / MOE_GRAPH_K
    e_losses = torch.stack(e_losses)
    e_after = _host_copy(written)
    _put_host(written, start)
    torch.cuda.empty_cache()
    _zero_launches(wrappers)
    multi = tr.build_multi_step(MOE_GRAPH_K)
    xs, ys = torch.stack([x] * MOE_GRAPH_K), torch.stack([y] * MOE_GRAPH_K)
    state, g_losses = multi(state, xs, ys)
    graph_counts = _launches(wrappers)
    want = _flash_want(2 * L * (1 + MOE_GRAPH_K), L * (1 + MOE_GRAPH_K))
    if graph_counts != want:
        fail(f"phase 46 capture launches {graph_counts}, expected {want}")
    if not (torch.equal(g_losses, e_losses)
            and _same_as_host(written, e_after)):
        fail(f"phase 46: the K={MOE_GRAPH_K} replay differs from "
             f"{MOE_GRAPH_K} eager steps ({g_losses.tolist()} vs "
             f"{e_losses.tolist()})")
    del start, e_after
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    multi(state, xs, ys)
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) * 1e3 / MOE_GRAPH_K
    graph_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    out = {"model": model.name, "params": params, "batch": batch,
           "batch_cuts": cuts, "seq": LM_SEQ, "optimizer": "Adafactor()",
           "experts": model.moe_experts, "top_k": model.moe_top_k,
           "capacity_factor": model.moe_capacity_factor,
           "setup_s": setup_s, "warmup_steps": MOE_WARMUP,
           "timed_steps": MOE_STEPS, "losses": losses,
           "launches": counts, "ms_per_step": step_s * 1e3,
           "tokens_per_s": batch * LM_SEQ / step_s,
           "fwd_flops_active": fwd_flops,
           "mfu": 3 * fwd_flops / step_s / BF16_FLOP_PER_S,
           "peak_mem_gib": peak, "traced_window": window,
           "route_stats_init": format_route_stats(init_stats).strip(),
           "dropped_share_mean_init": mean_dropped(init_stats),
           "route_stats": route_line.strip(),
           "route_stats_after_steps": MOE_WARMUP + MOE_STEPS + MOE_TRACED,
           "dropped_share_mean": mean_dropped(stats),
           "loss_kernels": lk, "loss_plain": lp, "loss_rel_diff": loss_k,
           "tol": LM_STEP_TOL,
           "grad_worst_leaves_frob": [[n, v] for v, n in frob[:4]],
           "grad_median_leaf_frob": frob[len(frob) // 2][0],
           "routing_pinned": True,
           "plain_choices_moved_by_layer": moved,
           "graph": {"k": MOE_GRAPH_K, "bitwise": True,
                     "losses": g_losses.tolist(),
                     "capture_launches": graph_counts,
                     "capture_ms": tr.graph_stats["capture_ms"][-1],
                     "eager_ms_per_step": eager_ms,
                     "replay_ms_per_step": replay_ms,
                     "peak_mem_gib": graph_peak}}
    del tr, state, multi
    torch.cuda.empty_cache()
    return out


def _keyed(params) -> list:
    """(name, leaf) in ``tree_leaves`` order: dict keys and block
    indices joined by dots."""
    if isinstance(params, dict):
        return [(f"{k}.{n}" if n else k, t) for k, v in params.items()
                for n, t in _keyed(v)]
    if isinstance(params, (tuple, list)):
        return [(f"{i}.{n}" if n else str(i), t)
                for i, v in enumerate(params) for n, t in _keyed(v)]
    return [("", params)]


@contextlib.contextmanager
def _route_record():
    """Within the block, each routing call's (experts, slots), in call
    order."""
    from tpu_ddp_torch.parallel import moe
    real, log = moe.topk_route, []

    def spy(logits, num_experts, capacity, top_k=1):
        out = real(logits, num_experts, capacity, top_k=top_k)
        probs = torch.softmax(logits.to(torch.float32), dim=-1)
        log.append((moe.choose_experts(probs, top_k), out[0]))
        return out

    with mock.patch.object(moe, "topk_route", spy):
        yield log


@contextlib.contextmanager
def _route_pinned(log):
    """Within the block, each routing call takes the next recorded
    (experts, slots) of ``log`` (consumed), its gates and aux from its
    own logits (``parallel/moe.py:route_gates``); yields the share of
    choices each call's own logits would have moved."""
    from tpu_ddp_torch.parallel import moe
    moved = []

    def pinned(logits, num_experts, capacity, top_k=1):
        experts, slots = log.pop(0)
        probs = torch.softmax(logits.to(torch.float32), dim=-1)
        moved.append(float((moe.choose_experts(probs, top_k) != experts)
                           .float().mean()))
        return (slots, *moe.route_gates(probs, experts, num_experts))

    with mock.patch.object(moe, "topk_route", pinned):
        yield moved


@contextlib.contextmanager
def _routing_log():
    """Within the block, every routed call's (tokens, dropped share) from
    the MoE layer's own counters (parallel/moe.py:routing_stats)."""
    from tpu_ddp_torch.models.transformer import TransformerLM
    real, calls = TransformerLM.moe_apply, []

    def spy(self, blk, y, stats=None):
        mine = []
        out = real(self, blk, y, stats=mine)
        calls.append((y.shape[0] * y.shape[1],
                      float(mine[0]["dropped_frac"])))
        return out

    with mock.patch.object(TransformerLM, "moe_apply", spy):
        yield calls


def _dropped_share(calls) -> float | None:
    n = sum(t for t, _ in calls)
    return sum(t * d for t, d in calls) / n if n else None


def moe_large_serve(dev, seed: int) -> dict:
    """Phase 47: TransformerLM-moe-large served bf16 at
    ``decode_quant='none'`` (phase 5's 8 requests: 64-512 prompt tokens,
    32 new, half greedy): tokens/s, TTFT median and max, the dropped
    share of the routed assignments in decode steps and in prefill
    chunks at capacity factor 1.25; no Hopper kernel launched. Then one
    greedy request at capacity factor E (every token admitted) against
    the argmax stream of whole-sequence forwards through the decode math;
    ``decode_quant='int8'`` and the ``quant`` draft raise."""
    from tpu_ddp_torch.models.transformer import make_transformer
    from tpu_ddp_torch.ops.quant import decode_forward_logits
    from tpu_ddp_torch.serve.engine import ServeEngine
    from tpu_ddp_torch.utils.tree import tree_leaves
    model = make_transformer(MOE_PRESET)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    eng = ServeEngine(model, params, decode_quant="none", device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    eng.submit(np.random.default_rng(seed).integers(
        0, model.vocab_size, size=40), 2)
    eng.run()
    torch.cuda.synchronize()
    wrappers = _flash_wrappers()
    _zero_launches(wrappers)
    _zero_int8()
    reqs = _serve_requests(model, seed)
    c0 = dict(eng.metrics.counters)
    with _routing_log() as calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handles = [eng.submit(p, n, temperature=t, seed=s)
                   for p, n, t, s in reqs]
        steps = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = {**_launches(wrappers), "int8_matmul": _int8_launches()}
    if any(_total(v) for v in launched.values()):
        fail(f"phase 47: MoE serving at decode_quant='none' launched a "
             f"Hopper kernel: {launched}")
    for h in handles:
        if not h.done or h.quarantined or h.cancelled or len(h.tokens) != 32:
            fail(f"phase 47: request {h.rid} did not finish cleanly")
        if not all(math.isfinite(lp) for lp in h.logprobs):
            fail(f"phase 47: request {h.rid} has non-finite logprobs")
    if not eng.accounting_ok() \
            or eng.pool.free_count != eng.pool.total_usable:
        fail("phase 47: KV pool accounting broken after the run")
    c = eng.metrics.counters
    ttft = sorted(h.ttft_s * 1e3 for h in handles)
    tokens = sum(len(h.tokens) for h in handles)
    decode = [(t, d) for t, d in calls if t <= eng.num_slots]
    prefill = [(t, d) for t, d in calls if t > eng.num_slots]
    for kw in (dict(decode_quant="int8"),
               dict(spec_k=2, spec_draft="quant")):
        try:
            ServeEngine(model, params, device=dev, **kw)
        except ValueError as e:
            if "decode_quant" not in str(e):
                raise
        else:
            fail(f"phase 47: ServeEngine({kw}) served a MoE model")
    del eng
    torch.cuda.empty_cache()

    # Capacity factor E admits every token: the cached greedy stream is
    # the argmax stream of whole-sequence forwards.
    model_e = dataclasses.replace(model,
                                  moe_capacity_factor=float(
                                      model.moe_experts))
    eng = ServeEngine(model_e, params, decode_quant="none", device=dev)
    prompt = np.random.default_rng(seed + 47).integers(
        0, model.vocab_size, size=64)
    n_new = 8
    h = eng.submit(prompt, n_new)
    eng.run()
    seq, ref, gaps = list(prompt), [], []
    with torch.no_grad():
        for _ in range(n_new):
            logits = decode_forward_logits(model_e, params, torch.as_tensor(
                seq, device=dev)[None])[0, -1]
            top = torch.topk(logits.double(), 2).values
            gaps.append(float(top[0] - top[1]))
            ref.append(int(logits.argmax()))
            seq.append(ref[-1])
    first = next((i for i in range(n_new) if h.tokens[i] != ref[i]), None)
    if first is not None and not gaps[first] <= NEAR_TIE:
        fail(f"phase 47: the cf=E stream {h.tokens} parts from the "
             f"whole-sequence argmax stream {ref} at {first}, top-2 gap "
             f"{gaps[first]} > {NEAR_TIE}")
    del eng
    out = {"model": model.name,
           "params": sum(p.numel() for p in tree_leaves(params)),
           "setup_s": setup_s, "requests": len(handles),
           "new_tokens": tokens, "engine_steps": steps, "wall_s": wall,
           "tokens_per_s": tokens / wall,
           "ttft_ms_median": ttft[len(ttft) // 2], "ttft_ms_max": ttft[-1],
           "decode_steps": c["serve_decode_steps"]
           - c0.get("serve_decode_steps", 0),
           "prefill_chunks": c["serve_prefill_chunks"]
           - c0.get("serve_prefill_chunks", 0),
           "decode_dropped_share": _dropped_share(decode),
           "prefill_dropped_share": _dropped_share(prefill),
           "hopper_launches": launched,
           "capacity_e_stream": {"tokens": list(h.tokens), "argmax": ref,
                                 "first_diff": first,
                                 "min_top2_gap": min(gaps)},
           "int8_refused": True,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    del params
    torch.cuda.empty_cache()
    return out


# Sequence parallelism (phase 48) at TransformerLM-large's attention call:
# the sp extents the ring is composed at, the cache-seed case (a cache of
# SP_CACHE positions, its last SP_CACHE_TAIL masked, before the chunk at
# offset SP_CACHE - SP_CACHE_TAIL), and the cp-prefill rows of the int8
# check (the 32-row chunk over sp = 2).
SP_RING = (2, 4)
SP_ULYSSES = 2
SP_CACHE, SP_CACHE_TAIL = 1024, 256
SP_INT8_M = 16


def _ring_composed(q, k, v, sp, **cache):
    """Every rank's ring on one card: rank r's ``ring_local`` fed, at step
    s, the chunk of rank (r - s) % sp, the chunk the rotation delivers;
    the ranks' outputs concatenated in sequence order."""
    from tpu_ddp_torch.parallel.ring_attention import ring_local
    lc = q.shape[1] // sp

    def chunk(t, i):
        return t[:, i * lc:(i + 1) * lc]

    return torch.cat([ring_local(
        chunk(q, r), ((chunk(k, (r - s) % sp), chunk(v, (r - s) % sp))
                      for s in range(sp)), r, sp, causal=True, **cache)
        for r in range(sp)], dim=1)


# The ring against the flash kernels, bf16: o row by row within phase
# 13's bound; the gradients by their relative Frobenius error. The flash
# backward rounds p and ds to bf16 (2**-8 relative), the ring keeps them
# in f32, and a gradient row whose exact value nearly cancels (the first
# query's dq, where p = 1 and o = v) is that rounding on one side and
# about 0 on the other, so rows are not comparable there.
SP_GRAD_FROB_TOL = 1e-2


def _sp_readings(got, want, what, tol, where, rows=False) -> dict:
    """Readings of each (name, tensor) pair of ``got`` against ``want``;
    fails when o's worst row passes ``tol`` or a gradient's Frobenius
    error passes ``SP_GRAD_FROB_TOL`` (``rows``: every tensor by its
    worst row against ``tol``)."""
    reads = {w: _readings(a, b) for w, a, b in zip(what, got, want)}
    _fail_on({w: (r["row"], tol) if rows or w == "o"
              else (r["frob"], SP_GRAD_FROB_TOL)
              for w, r in reads.items()}, where)
    return reads


def sequence_parallel(dev, gen) -> dict:
    """Phase 48: each rank's sequence-parallel math at LM-large's widths,
    B = 4, L = 2048, H = 16, D = 128, bf16, causal, one process composing
    the ranks of an sp group with the tensors the group's collectives
    would deliver (NCCL takes one rank per card). The ring at sp = 2 and
    4 against the flash kernels over the whole sequence (output and q,
    k, v gradients, autograd through the block updates), and seeded from
    a cache with ``q_offset`` > 0 and a masked tail against the flash
    forward over cache ++ chunk; ms per rank-step of the block update and
    peak memory of rank 0's forward and backward. Ulysses at sp = 2:
    each rank's flash call on its 8 heads over the whole sequence, its
    launches counted from 0 (all wgmma), its output and gradients against
    the same heads of the 16-head call. The int8 kernel at cp prefill's
    M = 16 rows on LM-large's projections against its plain version,
    timed beside its bound and ``torch.matmul``."""
    from tpu_ddp_torch.ops import flash_attention as fa
    from tpu_ddp_torch.ops import quant_matmul as qm
    from tpu_ddp_torch.ops.quant import dequantize, quantize_weight
    from tpu_ddp_torch.parallel.ring_attention import (block_attn,
                                                       init_state,
                                                       ring_local)
    from tpu_ddp_torch.parallel.ulysses import ulysses_local
    b, L, h, _, d = FLASH_MAIN
    tol = FLASH_TOL[torch.bfloat16]
    q, k, v = (torch.randn(b, L, h, d, generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_() for _ in range(3))
    do = torch.randn(b, L, h, d, generator=gen, device=dev).to(
        torch.bfloat16)
    o_ref = fa.flash_attention(q, k, v, True)
    g_ref = torch.autograd.grad((o_ref.float() * do.float()).sum(),
                                (q, k, v))
    o_ref = o_ref.detach()
    what = ("o", "dq", "dk", "dv")
    out = {"shape": [b, L, h, d], "ring": {}}
    for sp in SP_RING:
        o = _ring_composed(q, k, v, sp)
        g = torch.autograd.grad((o.float() * do.float()).sum(), (q, k, v))
        torch.cuda.synchronize()
        reads = _sp_readings((o.detach(), *g), (o_ref, *g_ref), what,
                             tol["o"], f"the ring at sp={sp}")
        del o, g
        out["ring"][f"sp{sp}"] = {"readings": reads}
    # Cache seed: the chunk's queries at SP_CACHE - SP_CACHE_TAIL.., the
    # cache's keys at 0..SP_CACHE-1, its tail masked; the reference is the
    # flash forward over the valid cache ++ chunk (its first rows, the
    # cache's own queries, dropped).
    S, off = SP_CACHE, SP_CACHE - SP_CACHE_TAIL
    ck, cv = (torch.randn(b, S, h, d, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    valid = torch.arange(S, device=dev) < off
    with torch.no_grad():
        qq = torch.cat([torch.zeros_like(ck[:, :off]), q], dim=1)
        want = fa.flash_attention(qq, torch.cat([ck[:, :off], k], dim=1),
                                  torch.cat([cv[:, :off], v], dim=1),
                                  True)[:, off:]
        for sp in SP_RING:
            o = _ring_composed(q, k, v, sp, q_offset=off, cache_k=ck,
                               cache_v=cv, cache_valid=valid)
            torch.cuda.synchronize()
            r = _readings(o, want)
            _fail_on({"o": (r["row"], tol["o"])},
                     f"the cache-seeded ring at sp={sp}")
            out["ring"][f"sp{sp}"]["cache_readings"] = r
        del qq, want, o
    out["cache"] = {"positions": S, "masked_tail": SP_CACHE_TAIL,
                    "q_offset": off}
    # One rank-step of the block update, alone, and rank 0's whole ring
    # (forward and backward) for its peak memory.
    scale = 1.0 / math.sqrt(d)
    for sp in SP_RING:
        lc = L // sp
        qc, kc, vc = (t.detach()[:, :lc] for t in (q, k, v))
        pos = torch.arange(lc, device=dev)
        state = init_state(qc)
        ms = cuda_ms(lambda: block_attn(qc, kc, vc, *state, pos, pos, True,
                                        scale), [()], 10)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        q0 = q.detach()[:, :lc].clone().requires_grad_()
        kv = []
        for i in range(sp):
            cut = slice(i * lc, (i + 1) * lc)
            kv.append((k.detach()[:, cut].clone().requires_grad_(),
                       v.detach()[:, cut].clone().requires_grad_()))
        o0 = ring_local(q0, (kv[-s % sp] for s in range(sp)), 0, sp,
                        causal=True)
        torch.autograd.grad((o0.float() * do[:, :lc].float()).sum(),
                            [q0] + [t for p in kv for t in p])
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
        del q0, kv, o0, state
        out["ring"][f"sp{sp}"].update(
            block_update_ms_per_rank_step=ms,
            layer_fwd_ms_per_rank=sp * ms,
            rank0_fwd_bwd_peak_gib_above_inputs=peak)
    out["flash_fwd_ms_per_layer"] = cuda_ms(
        lambda: fa.flash_fwd(q.detach(), k.detach(), v.detach(), True),
        [()], 10)
    # Ulysses: rank r holds heads 8r..8r+7 over the whole sequence, as the
    # all-to-all delivers them (contiguous).
    wrappers = _flash_wrappers()
    hs = h // SP_ULYSSES
    per_rank = []
    for r in range(SP_ULYSSES):
        heads = slice(r * hs, (r + 1) * hs)
        per_rank.append([t.detach()[:, :, heads].contiguous()
                         .requires_grad_() for t in (q, k, v)]
                        + [do[:, :, heads].contiguous()])
    torch.cuda.synchronize()
    _zero_launches(wrappers)
    uly = []
    for ql, kl, vl, dol in per_rank:
        o = ulysses_local(ql, kl, vl, causal=True, flash=True)
        uly.append((o.detach(), *torch.autograd.grad(
            (o.float() * dol.float()).sum(), (ql, kl, vl))))
    torch.cuda.synchronize()
    launches = _launches(wrappers)
    want_l = _flash_want(SP_ULYSSES, SP_ULYSSES)
    if launches != want_l:
        fail(f"Ulysses' local flash launches {launches}, expected {want_l}")
    same, worst = True, 0.0
    for r, got in enumerate(uly):
        heads = slice(r * hs, (r + 1) * hs)
        for a, ref in zip(got, (o_ref, *g_ref)):
            ref = ref[:, :, heads]
            same = same and torch.equal(a, ref)
            worst = max(worst, float((a.float() - ref.float()).abs().max()))
        _sp_readings(got, [t[:, :, heads] for t in (o_ref, *g_ref)], what,
                     tol["grad"], f"Ulysses rank {r}", rows=True)
    out["ulysses"] = {"sp": SP_ULYSSES, "heads_per_rank": hs,
                      "launches": launches, "bitwise_equal_16_head": same,
                      "max_abs_diff_16_head": worst}
    del uly, per_rank, o_ref, g_ref, q, k, v
    torch.cuda.empty_cache()
    # int8 at the cp-prefill rows.
    rows = []
    for name, ((kk, n), per_pass) in LARGE_SHAPES.items():
        copies = max(2, math.ceil(2 * L2_BYTES / (kk * n)))
        x = torch.randn(SP_INT8_M, kk, generator=gen, device=dev).to(
            torch.bfloat16)
        qws = [quantize_weight(0.02 * torch.randn(kk, n, generator=gen,
                                                  device=dev))
               for _ in range(copies)]
        ref = qm.int8_matmul_ref(x, qws[0].q, qws[0].s)
        route = qm.int8_route(x, qws[0].q)
        if route != "mma":
            fail(f"int8 at M={SP_INT8_M} K={kk} N={n} takes the {route} "
                 "route, not mma")
        _, err = _int8_err(qm.int8_matmul, x, qws[0].q, qws[0].s, ref)
        itol = 1e-4 * float(ref.abs().max())
        if not (math.isfinite(err) and err <= itol):
            fail(f"int8_matmul disagrees with its plain version at M="
                 f"{SP_INT8_M} K={kk} N={n}: max|d|={err} vs tol {itol}")
        args = [(x, qw.q, qw.s) for qw in qws]
        kern = timed(qm.int8_matmul, args, 20 * copies)
        plain = timed(qm.int8_matmul_ref, args, 4 * copies)
        wbf = [(x, dequantize(qw).to(torch.bfloat16)) for qw in qws]
        lib = timed(torch.matmul, wbf, 20 * copies)
        del wbf, qws
        nbytes = SP_INT8_M * kk * 2 + kk * n + n * 4 + SP_INT8_M * n * 4
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * SP_INT8_M * kk * n / BF16_FLOP_PER_S * 1e3
        rows.append({"proj": name, "k": kk, "n": n, "per_pass": per_pass,
                     "route": route, "max_abs_err": err, "tol": itol,
                     "ms": kern["ms"], "plain_ms": plain["ms"],
                     "library_ms": lib["ms"],
                     "timing": _timing_label(kern, plain, lib),
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations"})

    def per_pass(key):
        return sum(r[key] * r["per_pass"] for r in rows)

    bound = per_pass("bound_ms")
    out["int8_cp_prefill"] = {
        "m": SP_INT8_M, "shapes": rows, "ms": per_pass("ms"),
        "plain_ms": per_pass("plain_ms"),
        "library_ms": per_pass("library_ms"), "bound_ms": bound,
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                     else "operations"),
        "max_abs_err": max(r["max_abs_err"] for r in rows)}
    return out


# Tensor parallelism (phase 49) at TransformerLM-large's widths: the tp
# extents of the composed block, the decode pass's tp and rows (slots),
# the dropout rate of the masks compared, and the int8 bound of a
# composed output against the dense kernel's on the same input.
TP_PRESET = "TransformerLM-large"
TP_BLOCK = (2, 4)
TP_DECODE = 2
TP_DECODE_M = 8
TP_DROPOUT = 0.1
TP_INT8_TOL = 1e-4


def _tp_cells(tm, blk, tp: int) -> list:
    """Each rank's cell of one block's sharded leaves (the ``mp`` specs),
    as leaves of its own that autograd differentiates."""
    from tpu_ddp_torch.convert import cell_of
    specs = tm.param_specs()["blocks"][0]
    return [{k: cell_of(blk[k].detach(), specs[k], {"mp": r}, {"mp": tp})
             .clone().requires_grad_()
             for k in ("wqkv", "wo", "w1", "w2")} for r in range(tp)]


def _tp_block(tm, blk, cells, x, pos):
    """Every tp rank's block on one card: the LayerNorms once (their
    output feeds every rank, so autograd sums the ranks' gradients into
    it, as ``f``'s all-reduce does), each rank's attention and MLP
    branches on its cell, and the ranks' f32 partials added where ``g``
    all-reduces them."""
    from tpu_ddp_torch.models.transformer import layer_norm
    cd = tm.compute_dtype
    y = layer_norm(x, blk["ln1"]["scale"], blk["ln1"]["bias"])
    x = x + sum(tm.attn_partial(c, y, pos) for c in cells).to(cd)
    y = layer_norm(x, blk["ln2"]["scale"], blk["ln2"]["bias"])
    return x + sum(tm.mlp_partial(c, y) for c in cells).to(cd)


def _tp_decode(model, tms, trees, tokens, check=None):
    """One decode pass at position 0 of every rank of a tp group on one
    card (the decode math of models/decode.py on each rank's int8 slices,
    the ranks' f32 partials of ``wo`` and ``w2`` added where ``g``
    all-reduces them): the logits of each rank (its head is replicated).
    ``check((layer, name), x, outs)``: called with each projection's
    input (the ranks' inputs, for the row-parallel ones) and the ranks'
    outputs."""
    import torch.nn.functional as F

    from tpu_ddp_torch.models.decode import attend_cached
    from tpu_ddp_torch.models.transformer import layer_norm
    from tpu_ddp_torch.ops.quant import qdot
    cd = model.compute_dtype
    b = tokens.shape[0]
    pos = torch.zeros(1, dtype=torch.int64, device=tokens.device)
    x = trees[0]["embed"][tokens].to(cd)
    for li in range(model.num_layers):
        blks = [t["blocks"][li] for t in trees]
        y = layer_norm(x, blks[0]["ln1"]["scale"], blks[0]["ln1"]["bias"])
        os_, parts = [], []
        for tm, blk in zip(tms, blks):
            q, k, v = tm.qkv_proj(blk, y, pos)
            os_.append(attend_cached(tm, q, k, v, pos).reshape(b, 1, -1))
            parts.append(qdot(os_[-1], blk["wo"], cd))
        x = x + sum(parts).to(cd)
        y2 = layer_norm(x, blks[0]["ln2"]["scale"], blks[0]["ln2"]["bias"])
        h = [F.gelu(qdot(y2, blk["w1"], cd), approximate="tanh").to(cd)
             for blk in blks]
        mlp = [qdot(hh, blk["w2"], cd) for hh, blk in zip(h, blks)]
        if check is not None:
            # The check's own calls (not on the counted pass).
            check((li, "wqkv"), y, [qdot(y, blk["wqkv"], cd)
                                    for blk in blks])
            check((li, "wo"), os_, parts)
            check((li, "w1"), y2, [qdot(y2, blk["w1"], cd)
                                   for blk in blks])
            check((li, "w2"), h, mlp)
        x = x + sum(mlp).to(cd)
    return [tm.head_apply(t, x)[:, 0] for tm, t in zip(tms, trees)]


def _tp_flash_calls(shape, gen, dev) -> dict:
    """Each flash kernel's one call at a rank's shape, alone (the route it
    takes, ms, its bound), on fresh inputs: not counted on the path."""
    from tpu_ddp_torch.ops import flash_attention as fa
    q, k, v, do = _flash_inputs(shape, True, torch.bfloat16, gen, dev)
    o, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.attention_delta(o, do)
    calls = {"fwd": lambda: fa.flash_fwd(q, k, v, True),
             "bwd_kv": lambda: fa.flash_bwd_kv(q, k, v, do, lse, delta,
                                               True),
             "bwd_q": lambda: fa.flash_bwd_q(q, k, v, do, lse, delta, True)}
    out = {"shape": list(shape), "fwd_route": fa.fwd_route(q, k, v),
           "bwd_route": fa.bwd_route(q, k, v, do)}
    for name, (flops, nbytes) in _flash_work(shape, True, 2).items():
        t_ops = flops / BF16_FLOP_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = {"ms": timed(calls[name], [()], 20)["ms"],
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes"}
    return out


def tensor_parallel(dev, gen) -> dict:
    """Phase 49: each rank's tensor-parallel arithmetic at LM-large's
    widths, one process composing the ranks (the module docstring's (a),
    (b) and (c))."""
    import types

    from tpu_ddp_torch.convert import cell_of
    from tpu_ddp_torch.models.transformer import (fold_in, keep_mask,
                                                  make_transformer)
    from tpu_ddp_torch.ops import quant_matmul as qm
    from tpu_ddp_torch.ops.quant import (dequantize, qdot, quantize_params,
                                         quantize_weight)
    from tpu_ddp_torch.parallel.tensor_parallel import (serve_param_specs,
                                                        with_serve_tp)
    from tpu_ddp_torch.train.lm import LMTrainer, data_shard_index
    b, L, h, _, d = FLASH_MAIN
    tol = FLASH_TOL[torch.bfloat16]
    out = {"block": {}, "shape": [b, L, h * d]}
    # (a) one block, dense and composed over tp ranks.
    model = make_transformer(TP_PRESET, num_layers=1, use_flash=True)
    blk = model.init(torch.Generator(device=dev).manual_seed(7))[
        "blocks"][0]
    leaves = {"ln1.scale": blk["ln1"]["scale"], "ln1.bias": blk["ln1"]["bias"],
              "ln2.scale": blk["ln2"]["scale"], "ln2.bias": blk["ln2"]["bias"]}
    for t in list(leaves.values()) + [blk[k] for k in ("wqkv", "wo", "w1",
                                                       "w2")]:
        t.requires_grad_(True)
    x = torch.randn(b, L, h * d, generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_()
    dy = torch.randn(b, L, h * d, generator=gen, device=dev).to(
        torch.bfloat16)
    pos = torch.arange(L, device=dev)
    sharded = ("wqkv", "wo", "w1", "w2")

    def dense_step():
        y = model.block_apply_aux(blk, x, pos)[0]
        return y, torch.autograd.grad(
            (y.float() * dy.float()).sum(),
            [x, *leaves.values(), *(blk[k] for k in sharded)])

    def peak_of(fn) -> float:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30

    y_ref, g_ref = dense_step()
    y_ref = y_ref.detach()
    torch.cuda.synchronize()
    dense_ms = cuda_ms(dense_step, [()], 5)
    dense_peak = peak_of(dense_step)
    wrappers = _flash_wrappers()
    for tp in TP_BLOCK:
        tm = model.with_tensor_parallel("mp", tp)
        cells = _tp_cells(tm, blk, tp)
        torch.cuda.synchronize()
        _zero_launches(wrappers)
        y = _tp_block(tm, blk, cells, x, pos)
        g = torch.autograd.grad(
            (y.float() * dy.float()).sum(),
            [x, *leaves.values(), *(c[k] for c in cells for k in sharded)])
        torch.cuda.synchronize()
        launches = _launches(wrappers)
        want = _flash_want(tp, tp)
        if launches != want:
            fail(f"phase 49: tp={tp} block flash launches {launches}, "
                 f"expected {want}")
        reads = {"out": _readings(y.detach(), y_ref)}
        _fail_on({"out": (reads["out"]["row"], tol["o"])},
                 f"the tp={tp} block (phase 49)")
        errs = {}
        for name, a, ref in zip(["x", *leaves], g, g_ref):
            reads[f"d{name}"] = _readings(a, ref)
            errs[f"d{name}"] = (reads[f"d{name}"]["frob"], SP_GRAD_FROB_TOL)
        specs = tm.param_specs()["blocks"][0]
        it = iter(g[1 + len(leaves):])
        for r in range(tp):
            for k, ref in zip(sharded, g_ref[1 + len(leaves):]):
                a = next(it)
                want_g = cell_of(ref, specs[k], {"mp": r}, {"mp": tp})
                rd = _readings(a, want_g)
                reads[f"rank{r}.d{k}"] = rd
                errs[f"rank{r}.d{k}"] = (rd["frob"], SP_GRAD_FROB_TOL)
        _fail_on(errs, f"the tp={tp} block's gradients (phase 49)")
        del y, g

        def rank0_step(tm=tm, c0=cells[0]):
            yy = _tp_block(tm, blk, [c0], x, pos)
            return torch.autograd.grad((yy.float() * dy.float()).sum(),
                                       [x, *leaves.values(), *c0.values()])

        out["block"][f"tp{tp}"] = {
            "heads_per_rank": h // tp, "launches": launches,
            "readings": reads,
            "rank_fwd_bwd_ms": cuda_ms(rank0_step, [()], 5),
            "rank_peak_gib": peak_of(rank0_step),
            "flash": _tp_flash_calls((b, L, h // tp, h // tp, d), gen,
                                     dev)}
        del cells
    out["block"]["dense"] = {"fwd_bwd_ms": dense_ms,
                             "peak_gib": dense_peak}
    del y_ref, g_ref, x, dy, blk, leaves
    torch.cuda.empty_cache()
    # (b) int8 decode at tp = 2.
    model = make_transformer(TP_PRESET)
    params = model.init(torch.Generator(device=dev).manual_seed(8))
    dense_q = quantize_params(model, params)
    trees = [quantize_params(model, params, tp=TP_DECODE, rank=r)
             for r in range(TP_DECODE)]
    del params
    torch.cuda.empty_cache()
    bspec = serve_param_specs(model)["blocks"][0]
    xm = torch.zeros(TP_DECODE_M, max(model.d_model, model.d_ff),
                     dtype=torch.bfloat16, device=dev)
    shapes = model.param_shapes()["blocks"][0]
    for r, tree in enumerate(trees):
        for li, (blk_r, blk_d) in enumerate(zip(tree["blocks"],
                                                dense_q["blocks"])):
            for k in ("wqkv", "wo", "w1", "w2"):
                rq, dq = blk_r[k], blk_d[k]
                nk = 2 if k == "wo" else 1
                wq = cell_of(dq.q.view(shapes[k]), bspec[k], {"mp": r},
                             {"mp": TP_DECODE}).reshape(rq.q.shape)
                ws = cell_of(dq.s.view(shapes[k][nk:]), bspec[k][nk:],
                             {"mp": r}, {"mp": TP_DECODE}).reshape(-1)
                if not (torch.equal(rq.q, wq) and torch.equal(rq.s, ws)):
                    fail(f"phase 49: rank {r}'s int8 {k} of layer {li} is "
                         "not the slice of the dense quantization")
                route = qm.int8_route(xm[:, :rq.q.shape[0]].contiguous(),
                                      rq.q)
                if rq.q.data_ptr() % 16 or rq.s.data_ptr() % 16 \
                        or route != "mma":
                    fail(f"phase 49: rank {r}'s int8 {k} of layer {li}: "
                         f"pointer {rq.q.data_ptr() % 16}, route {route}")
    tms = [with_serve_tp(model, None, TP_DECODE)] * TP_DECODE
    tokens = torch.randint(0, model.vocab_size, (TP_DECODE_M, 1),
                           generator=gen, device=dev)
    int8 = {"int8_matmul": qm.int8_matmul}
    with torch.no_grad():
        ref = _tp_decode(model, [model], [dense_q], tokens)[0]
        torch.cuda.synchronize()
        _zero_launches(int8)
        logits = _tp_decode(model, tms, trees, tokens)
        torch.cuda.synchronize()
        launches = _launches(int8)["int8_matmul"]
        want = {"mma": 49 * TP_DECODE, "simt": 0}
        if launches != want:
            fail(f"phase 49: the tp={TP_DECODE} decode pass launched "
                 f"{launches}, expected {want}")
        worst = {}

        def check(site, inp, outs):
            li, k = site
            dq = dense_q["blocks"][li][k]
            if k in ("wqkv", "w1"):
                dense = qdot(inp, dq, model.compute_dtype)
                n = dense.shape[-1] // TP_DECODE
                if k == "wqkv":
                    dense = dense.view(*dense.shape[:-1], 3, h, d)
                    got = torch.cat([o.view(*o.shape[:-1], 3, h // TP_DECODE,
                                            d) for o in outs], dim=-2)
                else:
                    got = torch.cat(outs, dim=-1)
                    if got.shape[-1] != n * TP_DECODE:
                        fail(f"phase 49: w1 columns {got.shape[-1]}")
            else:
                dense = qdot(torch.cat(inp, dim=-1), dq,
                             model.compute_dtype)
                got = sum(outs)
            err = float((got - dense).abs().max())
            bound = TP_INT8_TOL * float(dense.abs().max())
            worst[k] = max(worst.get(k, 0.0), err / bound)
            if not (math.isfinite(err) and err <= bound):
                fail(f"phase 49: rank outputs of {k} (layer {li}) against "
                     f"the dense kernel: max|d|={err} vs tol {bound}")

        _tp_decode(model, tms, trees, tokens, check=check)
        torch.cuda.synchronize()
    for lg in logits[1:]:
        if not torch.equal(lg, logits[0]):
            fail("phase 49: the ranks' replicated heads differ")
    lrd = _readings(logits[0][:, None], ref[:, None])
    agree = float((logits[0].argmax(-1) == ref.argmax(-1)).float().mean())
    # One rank's 49 calls at M = 8, alone (phase 3's way: distinct weight
    # copies past the L2), against the dense pass's, bound and matmul.
    rank_shapes = {k: ((kk // TP_DECODE if k in ("wo", "w2") else kk,
                        n // TP_DECODE if k in ("wqkv", "w1") else n), per)
                   for k, ((kk, n), per) in LARGE_SHAPES.items()}
    passes = {}
    for label, table in (("rank", rank_shapes), ("dense", LARGE_SHAPES)):
        ms = plain = lib = nbytes = flops = 0.0
        for (kk, n), per in table.values():
            copies = max(2, math.ceil(2 * L2_BYTES / (kk * n)))
            xx = torch.randn(TP_DECODE_M, kk, generator=gen,
                             device=dev).to(torch.bfloat16)
            qws = [quantize_weight(0.02 * torch.randn(
                kk, n, generator=gen, device=dev)) for _ in range(copies)]
            args = [(xx, qw.q, qw.s) for qw in qws]
            ms += per * timed(qm.int8_matmul, args, 20 * copies)["ms"]
            plain += per * timed(qm.int8_matmul_ref, args, 2 * copies)["ms"]
            wbf = [(xx, dequantize(qw).to(torch.bfloat16)) for qw in qws]
            lib += per * timed(torch.matmul, wbf, 20 * copies)["ms"]
            del wbf, qws
            nbytes += per * (TP_DECODE_M * kk * 2 + kk * n + n * 4
                             + TP_DECODE_M * n * 4)
            flops += per * 2 * TP_DECODE_M * kk * n
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOP_PER_S * 1e3
        passes[label] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                         "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
                         "bound_by": "bytes" if t_bytes >= t_ops
                         else "operations"}
    out["int8_decode"] = {
        "tp": TP_DECODE, "m": TP_DECODE_M, "launches": launches,
        "worst_over_tol": worst, "logits_readings": lrd,
        "argmax_agreement": agree, "passes": passes}
    del trees, dense_q
    torch.cuda.empty_cache()
    # (c) dropout keys of a dp = 2 x tp = 2 world at LM-large's residual
    # shape (block 0, the attention branch's site).
    shape = (b, L, h * d)
    masks, keys = [], []
    for rank in range(4):
        stand_in = types.SimpleNamespace(
            model=types.SimpleNamespace(dropout_rate=TP_DROPOUT),
            dropout_seed=11, data_index=data_shard_index(rank, tp=2))
        key = fold_in(fold_in(LMTrainer.step_key(stand_in, 5), 0), 0)
        keys.append(key)
        masks.append(keep_mask(key, shape, 1.0 - TP_DROPOUT, dev))
    same = [torch.equal(masks[0], masks[1]), torch.equal(masks[2],
                                                         masks[3])]
    differ = not torch.equal(masks[0], masks[2])
    if not (all(same) and differ):
        fail(f"phase 49: dropout masks equal across tp peers {same}, "
             f"different across data shards {differ}")
    out["dropout"] = {"shape": list(shape), "keys": keys,
                      "equal_across_tp": same,
                      "differ_across_data_shards": differ,
                      "keep_share": float(masks[0].float().mean())}
    return out


# Pipeline parallelism (phase 50) at TransformerLM-large's width and depth,
# every stage in this process.
PP_MICRO, PP_TIMED = 4, 3
# (name, schedule, pp, pp_virtual); every run at M = PP_MICRO.
PP_RUNS = (("gpipe", "gpipe", 2, 1), ("1f1b", "1f1b", 2, 1),
           ("interleaved", "interleaved", 2, 2),
           ("zerobubble", "zerobubble", 2, 1), ("1f1b_pp4", "1f1b", 4, 1))
# Flash launches per layer and microbatch under remat "blocks": (forward,
# each backward sweep). gpipe keeps the graph (the forward and its
# recompute); 1f1b and interleaved forward without a graph and recompute
# the stage for the backward (whose checkpoints recompute again);
# zerobubble recomputes once for B-input and once for B-weight.
PP_FLASH = {"gpipe": (2, 1), "1f1b": (3, 1), "interleaved": (3, 1),
            "zerobubble": (5, 2)}
PP_GRAD_TOL, PP_LOSS_TOL, PP_SCHED_TOL = 1e-2, 2e-3, 1e-3


def _rel_frob(got, want) -> float:
    """|got - want| / |want| (Frobenius), in f32."""
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


def _pp_steps(tr, state, x, y, first=None, keep_after: int = 0) -> dict:
    """Phase 50's timing: 1 + PP_TIMED eager steps; ms per step is the
    median of the last PP_TIMED, the peak the GiB above what was live
    before them. ``first``: (state, loss) after the warm-up step where the
    caller ran it (the step whose gradients it checked). ``keep_after`` >
    0: also the losses of the first ``keep_after`` steps and a copy of the
    parameters after them."""
    from tpu_ddp_torch.utils.tree import tree_leaves
    out = {"losses": []}
    ms = []
    for i in range(1 + PP_TIMED):
        if i == 1:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        if i == 0 and first is not None:
            state, loss = first
        else:
            t0 = time.perf_counter()
            state, loss = tr.train_step(state, x, y)
            torch.cuda.synchronize()
            if i:
                ms.append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(float(loss))
        if i + 1 == keep_after:
            with torch.no_grad():
                out["params"] = [p.detach().clone()
                                 for p in tree_leaves(state.params)]
    if not all(math.isfinite(v) for v in out["losses"]):
        fail(f"phase 50: losses {out['losses']}")
    out["ms_per_step"] = float(np.median(ms))
    out["step_peak_gib_above"] = (torch.cuda.max_memory_allocated()
                                  - base) / 2 ** 30
    return out


def _grads_peak(fn):
    """(fn(), GiB of peak memory above what was live before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = fn()
    torch.cuda.synchronize()
    return got, (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def pipeline_parallel(dev, seed: int) -> dict:
    """Phase 50: the pipeline's four schedules at LM-large, every stage in
    this process, against one dense step; see the module docstring."""
    from tpu_ddp_torch.convert import stacked_from_dense
    from tpu_ddp_torch.models.transformer import make_transformer
    from tpu_ddp_torch.parallel.pipeline import InProcessEdge
    from tpu_ddp_torch.train.lm import (LMTrainer, PipelineLMTrainer,
                                       make_lm_batch)
    from tpu_ddp_torch.utils.tree import tree_leaves, tree_unflatten

    class SwappedEdge(InProcessEdge):
        """The planted fault: the first two messages delivered
        swapped."""

        def recv(self):
            if self.messages >= 2 and not getattr(self, "done", False):
                self.done = True
                self._q.rotate(-1)
            return super().recv()

    t_phase = time.perf_counter()
    model = make_transformer("TransformerLM-large", max_seq_len=LM_SEQ,
                             use_flash=True, remat="blocks")
    L = model.num_layers
    tokens = np.random.default_rng(seed).integers(
        0, model.vocab_size, size=(LM_BATCH, LM_SEQ + 1))
    wrappers = _flash_wrappers()
    dense = LMTrainer(model, device=dev)
    state = dense.init_state(seed=seed)
    with torch.no_grad():
        init = [p.detach().clone() for p in tree_leaves(state.params)]
    x, y = dense.put_batch(*make_lm_batch(tokens))
    _zero_launches(wrappers)
    (d_loss_t, leaves, d_grads), d_peak = _grads_peak(
        lambda: dense.step_grads(state, x, y))
    if _launches(wrappers) != _flash_want(2 * L, L):
        fail(f"phase 50: dense flash launches {_launches(wrappers)}, "
             f"expected {_flash_want(2 * L, L)}")
    d_loss = float(d_loss_t)
    d_stacked = tree_leaves(stacked_from_dense(
        tree_unflatten(state.params, list(d_grads))))
    # The checked pass is the warm-up step's: its update, then the timed
    # steps.
    state = dense.apply_grads(state, leaves, list(d_grads))
    del d_grads
    timed = _pp_steps(dense, state, x, y, first=(state, d_loss_t))
    out = {"model": model.name, "batch": LM_BATCH, "seq": LM_SEQ,
           "micro": PP_MICRO,
           "dense": {"loss": d_loss, "ms_per_step": timed["ms_per_step"],
                     "grads_peak_gib_above": d_peak,
                     "step_peak_gib_above": timed["step_peak_gib_above"]}}
    # The same dense step in PP_MICRO microbatches (grad_accum): the
    # microbatching's own cost, without a schedule.
    accum = LMTrainer(model, device=dev, grad_accum=PP_MICRO)
    timed = _pp_steps(accum, state, x, y)
    out["dense_accum"] = {"grad_accum": PP_MICRO,
                          "ms_per_step": timed["ms_per_step"],
                          "step_peak_gib_above": timed[
                              "step_peak_gib_above"]}
    del state, accum
    out["seconds"] = {"dense": time.perf_counter() - t_phase}

    def fresh():
        return tree_unflatten(dense._skeleton, [t.clone() for t in init])

    def grads_of(tr, st):
        _zero_launches(wrappers)
        (loss, lv, g), peak = _grads_peak(lambda: tr.step_grads(st, x, y))
        return loss, lv, g, _launches(wrappers), peak

    ref = None
    for name, schedule, pp, virtual in PP_RUNS:
        t_run = time.perf_counter()
        tr = PipelineLMTrainer(model, device=dev, num_micro=PP_MICRO,
                               schedule=schedule, pp=pp, pp_virtual=virtual,
                               stages="in_process")
        st = tr.init_state(params=fresh())
        loss_t, lv, g, counts, peak = grads_of(tr, st)
        loss = float(loss_t)
        fwd, bwd = PP_FLASH[schedule]
        want = _flash_want(fwd * L * PP_MICRO, bwd * L * PP_MICRO)
        if counts != want:
            fail(f"phase 50: {name} flash launches {counts}, expected "
                 f"{want}")
        # The dense gradients in this trainer's row order.
        want_g = tree_leaves(tr._permuted(
            tree_unflatten(st.params, d_stacked), inverse=False))
        errs = [_rel_frob(a, b) for a, b in zip(g, want_g)]
        loss_err = abs(loss - d_loss) / abs(d_loss)
        if not (max(errs) <= PP_GRAD_TOL and loss_err <= PP_LOSS_TOL):
            fail(f"phase 50: {name} against the dense step: loss error "
                 f"{loss_err} (tol {PP_LOSS_TOL}), worst leaf "
                 f"{max(errs)} (tol {PP_GRAD_TOL})")
        run = {"schedule": schedule, "pp": pp, "pp_virtual": virtual,
               "loss": loss, "loss_rel_err": loss_err,
               "grad_rel_frob_max": max(errs), "launches": counts,
               "grads_peak_gib_above": peak}
        if pp == 2:
            # The pp = 2 schedules against gpipe's, in the dense row order.
            canon = tree_leaves(tr.canonical_params(tree_unflatten(
                st.params, g)))
            if ref is None:
                ref = (loss, canon)
            else:
                s_err = max(_rel_frob(a, b) for a, b in zip(canon, ref[1]))
                s_loss = abs(loss - ref[0]) / abs(ref[0])
                run.update(vs_gpipe_grad=s_err, vs_gpipe_loss=s_loss)
                if not (s_err <= PP_SCHED_TOL and s_loss <= PP_SCHED_TOL):
                    fail(f"phase 50: {name} against gpipe: loss {s_loss}, "
                         f"worst leaf {s_err} (tol {PP_SCHED_TOL})")
            del canon
        graph_check = name == "1f1b"
        if graph_check:
            # The planted fault must trip the bound.
            tr.edge_factory = SwappedEdge
            _, _, g_bad, _, _ = grads_of(tr, st)
            tr.edge_factory = None
            planted = max(_rel_frob(a, b) for a, b in zip(g_bad, d_stacked))
            if not planted > PP_GRAD_TOL:
                fail(f"phase 50: a swapped edge moved no leaf past "
                     f"{PP_GRAD_TOL} (worst {planted})")
            run["planted_swap_grad_rel_frob"] = planted
            del g_bad
        # The checked pass is the warm-up step's.
        st = tr.apply_grads(st, lv, g)
        del g, lv
        timed = _pp_steps(tr, st, x, y, first=(st, loss_t),
                          keep_after=2 if graph_check else 0)
        run.update(ms_per_step=timed["ms_per_step"],
                   step_peak_gib_above=timed["step_peak_gib_above"])
        del st
        if graph_check:
            # The K = 2 call from the same start: one CUDA graph, the
            # first two eager steps' bits; then its replays timed.
            st = tr.init_state(params=fresh())
            _zero_launches(wrappers)
            call = tr.build_multi_step(2)
            st, losses = call(st, [x, x], [y, y])
            run["capture_launches"] = _launches(wrappers)
            same = all(torch.equal(a, b) for a, b in
                       zip(tree_leaves(st.params), timed["params"]))
            if not same or [float(v) for v in losses] != \
                    timed["losses"][:2]:
                fail(f"phase 50: the K=2 graph {losses.tolist()} differs "
                     f"from the eager steps {timed['losses'][:2]}")
            run["k2_graph_bitwise"] = True
            t0 = time.perf_counter()
            st, losses = call(st, [x, x], [y, y])
            torch.cuda.synchronize()
            run["k2_replay_ms_per_step"] = (
                (time.perf_counter() - t0) * 1e3 / 2)
            del st, timed
        run["seconds"] = time.perf_counter() - t_run
        out[name] = run
        del tr
    out["seconds"]["total"] = time.perf_counter() - t_phase
    return out


# The MPMD pipeline (phase 51) at TransformerLM-large's width and depth,
# every stage in this process, then the two-process drill on one card.
MPMD_MICRO, MPMD_TIMED, MPMD_INT8_TOL = 4, 3, 0.1
MPMD_DRILL_TIMEOUT_S = 150


def _mpmd_flash_want(layers: int, pp: int, micro: int) -> dict:
    """One ``step_grads`` call's flash launches: the stages before the
    last forward twice per layer and microbatch (without a graph, then
    the backward's recompute), the last stage once (its fused pass), and
    every layer sweeps once per microbatch."""
    last = layers // pp
    return _flash_want(micro * (2 * (layers - last) + last), micro * layers)


def _rank_lines(out: str, key: str) -> dict:
    """Each rank's ``[mpmd] rank=R <key> {...}`` line, as text by rank."""
    return {m.group(1): m.group(2) for m in re.finditer(
        rf"\[mpmd\] rank=(\d) {key} (.*)", out)}


def mpmd_pipeline(dev, seed: int, ppar: dict) -> dict:
    """Phase 51: the MPMD pipeline at LM-large against one dense step, the
    cross-slice wires, the two-process drill; see the module docstring.
    ``ppar``: phase 50's results (its 1f1b and grad_accum timings)."""
    t_phase = time.perf_counter()
    # (c) the two-process drill, both ranks on this card over a socket:
    # started first, it reaches the card while the checks below run, and
    # ends before the timed steps.
    drill = _start_example(
        "tpu_ddp_torch.launch", ["mpmd", "--nproc", "2", "--device",
                                 str(dev)],
        {"TPU_DDP_MPMD_COMPRESS": "int8", "TPU_DDP_MPMD_STEPS": "3"})
    try:
        return _mpmd_checks(dev, seed, ppar, drill, t_phase)
    finally:
        if drill[0].poll() is None:
            os.killpg(drill[0].pid, 9)
            drill[0].communicate()


def _mpmd_checks(dev, seed: int, ppar: dict, drill, t_phase) -> dict:
    """Phase 51's checks and readings beside the running ``drill``."""
    from tpu_ddp_torch.convert import stacked_from_dense
    from tpu_ddp_torch.models.transformer import make_transformer
    from tpu_ddp_torch.ops.optim import AdamW, SGD
    from tpu_ddp_torch.parallel import mpmd
    from tpu_ddp_torch.parallel.compress import EdgeCodec
    from tpu_ddp_torch.train.lm import LMTrainer, make_lm_batch
    from tpu_ddp_torch.utils.tree import tree_leaves, tree_unflatten

    class SwappedEdge(mpmd.InProcessEdge):
        """The planted fault: the first two messages delivered swapped."""

        def recv(self):
            if self.messages >= 2 and not getattr(self, "done", False):
                self.done = True
                self._q.rotate(-1)
            return super().recv()

    model = make_transformer("TransformerLM-large", max_seq_len=LM_SEQ,
                             use_flash=True)
    L = model.num_layers
    tokens = np.random.default_rng(seed).integers(
        0, model.vocab_size, size=(LM_BATCH, LM_SEQ + 1))
    wrappers = _flash_wrappers()
    dense = LMTrainer(model, device=dev, optimizer=SGD(learning_rate=0.1))
    state = dense.init_state(seed=seed)
    x, y = dense.put_batch(*make_lm_batch(tokens))
    d_loss, _, d_grads = dense.step_grads(state, x, y)
    d_loss = float(d_loss)
    want = tree_leaves(stacked_from_dense(tree_unflatten(
        state.params, list(d_grads))))
    with torch.no_grad():
        params = stacked_from_dense(
            tree_unflatten(state.params, [p.detach() for p in tree_leaves(
                state.params)]))
    del state, d_grads, dense
    torch.cuda.empty_cache()
    out = {"model": model.name, "batch": LM_BATCH, "seq": LM_SEQ,
           "micro": MPMD_MICRO, "dense_loss": d_loss,
           "seconds": {"dense": time.perf_counter() - t_phase}}

    def grads_of(pipe):
        """One counted, peak-measured step_grads call."""
        _zero_launches(wrappers)
        (loss, g), peak = _grads_peak(lambda: pipe.step_grads(params, x, y))
        st = pipe.edge_stats()
        edges = st["down"] + st["up"]
        return float(loss), tree_leaves(g), {
            "launches": _launches(wrappers), "grads_peak_gib_above": peak,
            "edge_dense_bytes_per_step": sum(e["dense_bytes"] for e in edges),
            "edge_wire_bytes_per_step": sum(e["wire_bytes"] for e in edges),
            "ratio_min": min(e["ratio"] for e in edges),
            "specs": sorted({e["spec"] for e in edges})}

    def against_dense(loss, g):
        errs = [_rel_frob(a, b) for a, b in zip(g, want)]
        loss_err = abs(loss - d_loss) / abs(d_loss)
        return {"loss": loss, "loss_rel_err": loss_err,
                "grad_rel_frob_max": max(errs),
                "ok": max(errs) <= PP_GRAD_TOL and loss_err <= PP_LOSS_TOL}

    # (a) f32 edges at pp = 2 and 4 against the dense step, flash counted.
    ref = None
    for pp in (2, 4):
        t_run = time.perf_counter()
        pipe = mpmd.MPMDPipeline(model, pp, LM_SEQ, num_micro=MPMD_MICRO,
                                 compress="none", device=dev)
        loss, g, run = grads_of(pipe)
        run.update(against_dense(loss, g))
        want_flash = _mpmd_flash_want(L, pp, MPMD_MICRO)
        if run["launches"] != want_flash:
            fail(f"phase 51: pp={pp} flash launches {run['launches']}, "
                 f"expected {want_flash}")
        if not run.pop("ok"):
            fail(f"phase 51: pp={pp} against the dense step: loss error "
                 f"{run['loss_rel_err']} (tol {PP_LOSS_TOL}), worst leaf "
                 f"{run['grad_rel_frob_max']} (tol {PP_GRAD_TOL})")
        if pp == 2:
            ref = (loss, g)
            # The planted fault must trip the bound.
            pipe.down[0] = SwappedEdge(EdgeCodec("none"), device=dev)
            bad = against_dense(*grads_of(pipe)[:2])
            if bad["ok"]:
                fail(f"phase 51: a swapped edge moved no leaf past "
                     f"{PP_GRAD_TOL} (worst {bad['grad_rel_frob_max']})")
            run["planted_swap_grad_rel_frob"] = bad["grad_rel_frob_max"]
        run["seconds"] = time.perf_counter() - t_run
        out[f"pp{pp}"] = run
        del pipe
    # (b) cross-slice wires at pp = 2: bf16 the f32 edges' bits, int8
    # within MPMD_INT8_TOL of them.
    t_run = time.perf_counter()
    for spec in ("bf16", "int8"):
        pipe = mpmd.MPMDPipeline(model, 2, LM_SEQ, num_micro=MPMD_MICRO,
                                 topology=mpmd.SliceTopology.even(2, 2),
                                 compress=spec, device=dev)
        loss, g, run = grads_of(pipe)
        errs = [_rel_frob(a, b) for a, b in zip(g, ref[1])]
        run.update(loss=loss, vs_f32_edges_grad_rel_frob_max=max(errs),
                   vs_f32_edges_grad_rel_frob=errs)
        if spec == "bf16":
            same = loss == ref[0] and all(
                torch.equal(a, b) for a, b in zip(g, ref[1]))
            run["bitwise_equal_f32_edges"] = same
            if not (same and run["ratio_min"] == 2.0):
                fail(f"phase 51: bf16 edges bit-equal to f32 edges {same} "
                     f"(worst leaf {max(errs)}), ratio {run['ratio_min']}")
        elif not (run["ratio_min"] >= 3.5 and max(errs) <= MPMD_INT8_TOL):
            fail(f"phase 51: int8 edges ratio {run['ratio_min']}, worst "
                 f"leaf {max(errs)} from the f32 edges (tol "
                 f"{MPMD_INT8_TOL})")
        out[f"cross_{spec}"] = run
        del pipe, g
    out["seconds"]["cross"] = time.perf_counter() - t_run
    # Each wire through a socket pair from and to the card, against the
    # same wire decoded in process; then the drill's end.
    gen = torch.Generator(device=dev).manual_seed(seed)
    socket_wires = {}
    for spec in ("none", "bf16", "int8", "sparse"):
        a, b = socket.socketpair()
        try:
            tx = mpmd.SocketEdge(a, EdgeCodec(spec, seed=1))
            twin = EdgeCodec(spec, seed=1)
            rx = mpmd.SocketEdge(b, device=dev)
            payload = torch.randn(4, 1024, generator=gen, device=dev)
            payload[:, :512] = 0.0
            same = True
            for k in range(2):
                tx.send((k + 1) * payload)
                got = rx.recv()
                same = same and got.device == dev and torch.equal(
                    got, EdgeCodec.decode(twin.encode((k + 1) * payload)[0],
                                          dev))
        finally:
            a.close()
            b.close()
        if not same:
            fail(f"phase 51: a {spec} wire through a socket differs from "
                 "the same wire decoded in process")
        socket_wires[spec] = tx.stats()["ratio"]
    out["socket_wires_ratio"] = socket_wires
    drill, wall = _finish_example(drill, "phase 51", MPMD_DRILL_TIMEOUT_S)
    result = re.search(r"\[mpmd\] RESULT (.*) OK$", drill, re.M)
    edges, sched = _rank_lines(drill, "edge"), _rank_lines(drill, "sched")
    if result is None or sorted(edges) != ["0", "1"] or \
            sorted(sched) != ["0", "1"]:
        fail(f"phase 51: the drill printed no RESULT ... OK or no stats:\n"
             f"{drill[-3000:]}")
    out["drill"] = {"result": result.group(1), "edge_stats": edges,
                    "stage_stats": sched, "wall_s": wall}
    # (d) ms per train step at pp = 2 (f32 edges, AdamW as phase 50).
    t_run = time.perf_counter()
    pipe = mpmd.MPMDPipeline(model, 2, LM_SEQ, num_micro=MPMD_MICRO,
                             compress="none", device=dev, optimizer=AdamW())
    opt = pipe.init_state(params)
    ms = []
    for i in range(1 + MPMD_TIMED):
        t0 = time.perf_counter()
        _, opt, loss, skipped = pipe.train_step(params, opt, x, y)
        torch.cuda.synchronize()
        if i:
            ms.append((time.perf_counter() - t0) * 1e3)
        if skipped or not math.isfinite(loss):
            fail(f"phase 51: train step {i} loss {loss}")
    out["pp2"]["ms_per_step"] = float(np.median(ms))
    out["phase50_1f1b_ms_per_step"] = ppar["1f1b"]["ms_per_step"]
    out["phase50_dense_accum_ms_per_step"] = ppar["dense_accum"][
        "ms_per_step"]
    del pipe, opt, params
    torch.cuda.empty_cache()
    out["seconds"]["timed"] = time.perf_counter() - t_run
    out["seconds"]["total"] = time.perf_counter() - t_phase
    return out


# Phase 52: (a) the in-process pipeline with Adafactor at LM-large's width
# and depth; (b) a tp = 2 serving drill, two processes on this card over
# a gloo group (gloo's all_reduce takes CUDA tensors; NCCL takes one rank
# per card).
PA_LOSS_TOL = 1e-6
# 52b is cut to fit: every pass of a tp rank waits on 24 gloo round trips
# through the host, and the two processes share the card (about 140 ms
# per pass). 2 of phase 5's requests and 2 of phase 24's workload cut to
# 512-token prompts, 8 new tokens each, 64-token prefill chunks; the hot
# tier holds one chunk's 4 pages (a prefill evicts a decode frontier,
# which comes back promoted) and the cold tier 41, under two contexts
# (pages spill to the host).
TP_SERVE, TP_SERVE_REQUESTS, TP_SERVE_NEW, TP_PREFILL_CHUNK = 2, 2, 8, 64
TP_TIER_REQUESTS, TP_TIER_PROMPT = 2, 512
TP_TIER_HBM_BLOCKS, TP_TIER_COLD_BLOCKS = 5, 42
TP_SERVE_TIMEOUT_S = 150


def _adafactor_cells(before, grads, held, decay, per_cell: bool) -> list:
    """The bare Adafactor's first step in plain PyTorch on copies of
    ``before`` with ``grads``: each leaf's stage cells (its ``held`` row
    blocks) one by one, or (``per_cell=False``) the whole stacked leaf as
    one cell. Returns the updated leaves."""
    from tpu_ddp_torch.ops.optim import Adafactor
    out = []
    for p0, g0, h, dk in zip(before, grads, held, decay):
        h = h if per_cell else 1
        cells = [c.clone() for c in p0.chunk(h)]
        opt = Adafactor()
        opt.apply(cells, list(g0.chunk(h)), opt.init(cells),
                  decay_mask=[dk] * h)
        out.append(torch.cat(cells) if h > 1 else cells[0])
    return out


def pipeline_adafactor(dev, seed: int, ppar: dict) -> dict:
    """Phase 52a: ``PipelineLMTrainer(stages="in_process")`` with
    Adafactor at LM-large (pp = 2, 1f1b, M = 4, remat ``blocks``); see
    the module docstring. ``ppar``: phase 50's results."""
    from tpu_ddp_torch.convert import stacked_from_dense
    from tpu_ddp_torch.models.transformer import make_transformer
    from tpu_ddp_torch.ops.optim import Adafactor
    from tpu_ddp_torch.train.lm import (LMTrainer, PipelineLMTrainer,
                                       make_lm_batch)
    from tpu_ddp_torch.utils.tree import tree_leaves, tree_unflatten
    t0 = time.perf_counter()
    model = make_transformer("TransformerLM-large", max_seq_len=LM_SEQ,
                             use_flash=True, remat="blocks")
    L = model.num_layers
    tokens = np.random.default_rng(seed).integers(
        0, model.vocab_size, size=(LM_BATCH, LM_SEQ + 1))
    wrappers = _flash_wrappers()
    dense = LMTrainer(model, device=dev, optimizer=Adafactor())
    state = dense.init_state(seed=seed)
    with torch.no_grad():
        init = tree_unflatten(dense._skeleton, [
            p.detach().clone() for p in tree_leaves(state.params)])
    x, y = dense.put_batch(*make_lm_batch(tokens))
    d_loss, _, d_grads = dense.step_grads(state, x, y)
    d_loss = float(d_loss)
    d_stacked = tree_leaves(stacked_from_dense(
        tree_unflatten(state.params, list(d_grads))))
    del state, d_grads, dense
    tr = PipelineLMTrainer(model, device=dev, num_micro=PP_MICRO,
                           schedule="1f1b", pp=2, stages="in_process",
                           optimizer=Adafactor())
    st = tr.init_state(params=init)
    del init
    _zero_launches(wrappers)
    (loss_t, lv, g), g_peak = _grads_peak(lambda: tr.step_grads(st, x, y))
    counts = _launches(wrappers)
    want = _flash_want(3 * L * PP_MICRO, L * PP_MICRO)
    if counts != want:
        fail(f"phase 52a: flash launches {counts}, expected {want}")
    errs = [_rel_frob(a, b) for a, b in zip(g, d_stacked)]
    loss_err = abs(float(loss_t) - d_loss) / abs(d_loss)
    del d_stacked
    if not (max(errs) <= PP_GRAD_TOL and loss_err <= PA_LOSS_TOL):
        fail(f"phase 52a: against the dense step: loss error {loss_err} "
             f"(tol {PA_LOSS_TOL}), worst leaf {max(errs)} (tol "
             f"{PP_GRAD_TOL})")
    # The update: the trainer's against the bare Adafactor applied stage
    # cell by stage cell to the same gradients, bit for bit; the whole
    # stacked leaf as one cell (the planted fault) must differ.
    with torch.no_grad():
        before = [p.detach().clone() for p in lv]
        grads = [t.detach().clone() for t in g]
    st = tr.apply_grads(st, lv, g)
    del g
    after = tree_leaves(st.params)
    held = list(tr._held)
    if sorted(set(held)) != [1, 2]:
        fail(f"phase 52a: held stage cells per leaf {held}, expected 2 "
             "for the stacked leaves and 1 for the rest")
    plain = _adafactor_cells(before, grads, held, tr._decay, True)
    differ = [i for i, (a, b) in enumerate(zip(after, plain))
              if not torch.equal(a, b)]
    if differ:
        fail(f"phase 52a: {len(differ)} leaves differ from the per-cell "
             "plain Adafactor's bits")
    del plain
    whole = _adafactor_cells(before, grads, held, tr._decay, False)
    with torch.no_grad():
        planted = {str(tuple(a.shape)): _rel_frob(a - b, a - c)
                   for a, b, c in zip(after, whole, before)
                   if not torch.equal(a, b)}
    if not planted:
        fail("phase 52a: Adafactor over whole stacked leaves gave the "
             "per-cell update's bits; the check cannot see it")
    del whole, before, grads
    timed = _pp_steps(tr, st, x, y, first=(st, loss_t))
    del st, tr
    return {"model": model.name, "pp": 2, "schedule": "1f1b",
            "micro": PP_MICRO, "loss": float(loss_t),
            "loss_rel_err": loss_err, "grad_rel_frob_max": max(errs),
            "launches": counts, "update_bitwise_per_cell": True,
            # The leaves (by shape) the whole-leaf update moves off the
            # per-cell one's bits, each by |after - whole| / |update|.
            "planted_whole_leaf": planted,
            "ms_per_step": timed["ms_per_step"],
            "phase50_1f1b_adamw_ms_per_step": ppar["1f1b"]["ms_per_step"],
            "grads_peak_gib_above": g_peak,
            "step_peak_gib_above": timed["step_peak_gib_above"],
            "seconds": time.perf_counter() - t0}


def tp_serve_rank(rank: int, port: int, seed: int,
                  device: str = "cuda:0") -> None:
    """Phase 52b's rank ``rank`` (run in a process of its own): LM-large
    int8 served over a gloo tp group of TP_SERVE processes on this card,
    phase 21's and 24's runs and gates at tp = 2; prints one ``[tp_serve]
    rank=R {...}`` line with its streams and readings."""
    import torch.distributed as dist
    from tpu_ddp_torch.models.transformer import make_transformer
    from tpu_ddp_torch.serve.loadgen import make_long_prompt_workload
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=TP_SERVE)
    model = make_transformer("TransformerLM-large")
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    reqs = [(p, TP_SERVE_NEW, t, s) for p, _, t, s in
            _serve_requests(model, seed, n=TP_SERVE_REQUESTS)]
    long = [(np.asarray(sp.prompt), sp.max_new_tokens, sp.temperature,
             sp.seed) for sp in make_long_prompt_workload(
                 TP_TIER_REQUESTS, model.vocab_size, seed=seed,
                 prompt_len=TP_TIER_PROMPT,
                 max_new=(TP_SERVE_NEW, TP_SERVE_NEW + 1))]
    runs, out = {}, {}
    for label, kw, work in (
            ("k0", {}, reqs),
            ("chain", dict(spec_k=SPEC_K, spec_draft="chain"), reqs),
            ("self2", dict(spec_k=SPEC_K, spec_draft="self-2"), reqs),
            ("tiers1", {}, long),
            ("tiers2_bf16", dict(kv_tiers=2, kv_cold_dtype="bf16",
                                 hbm_blocks=TP_TIER_HBM_BLOCKS), long),
            ("tiers3_int8", dict(kv_tiers=3, kv_cold_dtype="int8",
                                 hbm_blocks=TP_TIER_HBM_BLOCKS,
                                 cold_blocks=TP_TIER_COLD_BLOCKS), long)):
        eng = _serve_engine(model, params, dev, tp_group=dist.group.WORLD,
                            prefill_chunk=TP_PREFILL_CHUNK, **kw)
        if eng.tp != TP_SERVE:
            fail(f"phase 52b rank {rank}: the engine serves at tp "
                 f"{eng.tp}")
        run = _drive(eng, work, f"phase 52b rank {rank} {label}", _refs_ok)
        run["spec"] = eng.spec_stats()
        run["moves"] = dict(eng.pool.moves)
        run["pool_heads"] = int(eng.pool.k.shape[3])
        runs[label] = run
        out[label] = _summary(run)
        out[label]["tokens"] = [list(h.tokens) for h in run["handles"]]
        del eng
    h = {k: r["handles"] for k, r in runs.items()}
    chain = _compare_streams(h["k0"], h["chain"])
    if not chain["bitwise"]:
        fail(f"phase 52b rank {rank}: the chain stream differs from k=0: "
             f"{chain}")
    self2 = _compare_streams(h["k0"], h["self2"])
    if not self2["bitwise"]:
        self2 = _compare_streams(h["k0"], h["self2"], model,
                                 _quantized(model, params))
    _hold_near_tie(self2, f"phase 52b rank {rank} self-2")
    bf = _compare_streams(h["tiers1"], h["tiers2_bf16"])
    if not bf["bitwise"]:
        fail(f"phase 52b rank {rank}: kv_tiers=2 with bf16 cold pages "
             f"differs from the single tier: {bf}")
    m3 = runs["tiers3_int8"]["moves"]
    if not all(m3[k] > 0 for k in ("demote", "promote", "spill")):
        fail(f"phase 52b rank {rank}: kv_tiers=3 moved {m3}; every kind "
             "must be > 0")
    out.update(chain_vs_k0=chain, self2_vs_k0=self2, bf16_vs_tiers1=bf)
    print(f"[tp_serve] rank={rank} {json.dumps(out)}", flush=True)
    dist.barrier()
    dist.destroy_process_group()


def _tp_serve_start(seed: int) -> tuple:
    """Start phase 52b's ranks; returns (processes, start time)."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPU_DDP_")}
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke as c; "
         f"c.tp_serve_rank({r}, {port}, {seed})"], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True) for r in range(TP_SERVE)]
    return procs, time.perf_counter()


def _tp_serve_finish(started) -> dict:
    """Wait for phase 52b's ranks (stopped past TP_SERVE_TIMEOUT_S);
    each must exit 0 with its result line, and the ranks emit the same
    tokens."""
    procs, t0 = started
    outs = []
    try:
        for p in procs:
            try:
                o, _ = p.communicate(timeout=max(
                    TP_SERVE_TIMEOUT_S - (time.perf_counter() - t0), 1.0))
            except subprocess.TimeoutExpired:
                fail(f"phase 52b: a rank ran past {TP_SERVE_TIMEOUT_S} s")
            outs.append(o)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.communicate()
    res = {}
    for r, (p, o) in enumerate(zip(procs, outs)):
        m = re.search(rf"\[tp_serve\] rank={r} (.*)", o)
        if p.returncode != 0 or m is None:
            fail(f"phase 52b: rank {r} exited {p.returncode}:\n{o[-3000:]}")
        res[r] = json.loads(m.group(1))
    for label, run in res[0].items():
        if "tokens" in run and run["tokens"] != res[1][label]["tokens"]:
            fail(f"phase 52b: the ranks' {label} tokens differ")
    wall = time.perf_counter() - t0
    for run in res[0].values():
        if isinstance(run, dict):
            run.pop("tokens", None)
    return {"rank0": res[0], "ranks_equal": True, "wall_s": wall,
            "backend": "gloo", "device": "cuda:0 (both ranks)"}


def pipeline_adafactor_tp_serve(dev, seed: int, ppar: dict) -> dict:
    """Phase 52: the tp = 2 drill (b) started first, run beside the
    in-process Adafactor pipeline (a)."""
    t0 = time.perf_counter()
    started = _tp_serve_start(seed)
    try:
        pa = pipeline_adafactor(dev, seed, ppar)
        tps = _tp_serve_finish(started)
    finally:
        for p in started[0]:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.communicate()
    return {"pipeline_adafactor": pa, "tp_serve": tps,
            "seconds": time.perf_counter() - t0}


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
        saved = lm_ckpt.pop("_saved")
        print(json.dumps({"lm_checkpoint": lm_ckpt}), flush=True)

        from tpu_ddp_torch.models.transformer import make_transformer
        smodel = make_transformer("TransformerLM-large")
        sparams = smodel.init(
            torch.Generator(device=dev).manual_seed(args.seed))
        spec = phase("21_spec", serve_spec, dev, smodel, sparams,
                     args.seed)
        print(json.dumps({"spec": spec}), flush=True)
        prefix = phase("22_prefix", serve_prefix, dev, smodel, sparams,
                       args.seed)
        tenants = phase("23_tenants", serve_tenants, dev, smodel, sparams,
                        args.seed)
        print(json.dumps({"tenants": tenants}), flush=True)
        tiers = phase("24_tiers", serve_tiers, dev, smodel, sparams,
                      args.seed)
        print(json.dumps({"tiers": tiers}), flush=True)
        ckpt_serve = phase("25_serve_checkpoint", serve_checkpoint, dev,
                           smodel, saved)
        print(json.dumps({"serve_checkpoint": ckpt_serve}), flush=True)
        del saved
        load = phase("26_loadgen", serve_load, dev, smodel, sparams,
                     args.seed)
        print(json.dumps({"loadgen": load}), flush=True)
        del sparams
    finally:
        import shutil
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    lm = {k: v for k, v in lm.items() if not k.startswith("_")}
    torch.cuda.empty_cache()

    recipe = phase("27_lm_recipe", train_recipe, dev, args.seed)
    print(json.dumps({"lm_recipe": recipe}), flush=True)
    matrix = phase("28_policy_matrix", policy_matrix, dev, args.seed)
    print(json.dumps({"policy_matrix": matrix}), flush=True)
    vpolicy = phase("29_vgg_policy", vgg_policy, dev)
    print(json.dumps({"vgg_policy": vpolicy}), flush=True)
    examples = phase("30_examples", examples_on_card, dev)
    print(json.dumps({"examples": examples}), flush=True)

    ladder = phase("31_ladder_parts", ladder_parts, dev)
    print(json.dumps({"ladder_parts": ladder}), flush=True)
    torch.cuda.empty_cache()
    ldev = phase("32_ladder_device_code", ladder_device_code, dev)
    print(json.dumps({"ladder_device_code": ldev}), flush=True)
    torch.cuda.empty_cache()
    lshard = phase("33_lm_sharded", lm_sharded, dev, args.seed)
    print(json.dumps({"lm_sharded": lshard}), flush=True)
    try:
        multi = phase("34_multi_card", ladder_multi_card, dev)
    finally:
        import shutil
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    print(json.dumps({"multi_card": multi}), flush=True)
    torch.cuda.empty_cache()

    rbn = phase("35_resnet_bn", check_bn_resnet, dev, gen)
    print(json.dumps({"resnet_bn": {k: v for k, v in rbn.items()
                                    if k != "shapes"}}), flush=True)
    resnet = phase("36_resnet50", resnet50_train, dev, gen)
    print(json.dumps({"resnet50": resnet}), flush=True)
    vit = phase("37_vit", vit_train, dev, gen)
    print(json.dumps({"vit": vit}), flush=True)
    torch.cuda.empty_cache()
    depths = phase("38_dispatch_window", dispatch_window, dev)
    print(json.dumps({"dispatch_window": depths}), flush=True)
    ksteps = phase("39_multi_step", multi_step, dev)
    print(json.dumps({"multi_step": ksteps}), flush=True)
    hostside = phase("40_host_side", host_side, dev, resnet, vit)
    print(json.dumps({"host_side": hostside}), flush=True)
    torch.cuda.empty_cache()
    fzero = phase("41_lm_factored_zero1", lm_factored_zero1, dev,
                  args.seed, recipe)
    print(json.dumps({"lm_factored_zero1": fzero}), flush=True)
    try:
        ecard = phase("42_elastic_card", elastic_card, dev)
    finally:
        import shutil
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    print(json.dumps({"elastic_card": ecard}), flush=True)
    torch.cuda.empty_cache()
    lgraph = phase("43_ladder_multi_step", ladder_multi_step, dev,
                   args.seed)
    print(json.dumps({"ladder_multi_step": lgraph}), flush=True)
    torch.cuda.empty_cache()
    auto = phase("44_autotune", autotune_card, dev)
    print(json.dumps({"autotune": {k: v for k, v in auto.items()
                                   if k not in ("trials", "search")}}),
          flush=True)
    torch.cuda.empty_cache()
    dcap = phase("45_dropout_capture", dropout_capture, dev, args.seed)
    print(json.dumps({"dropout_capture": dcap}), flush=True)
    torch.cuda.empty_cache()
    moe = phase("46_moe_large_train", moe_large_train, dev, args.seed)
    print(json.dumps({"moe_large_train": moe}), flush=True)
    moe_serve = phase("47_moe_large_serve", moe_large_serve, dev,
                      args.seed)
    print(json.dumps({"moe_large_serve": moe_serve}), flush=True)
    torch.cuda.empty_cache()
    seqp = phase("48_sequence_parallel", sequence_parallel, dev, gen)
    print(json.dumps({"sequence_parallel": seqp}), flush=True)
    torch.cuda.empty_cache()
    tpar = phase("49_tensor_parallel", tensor_parallel, dev, gen)
    print(json.dumps({"tensor_parallel": tpar}), flush=True)
    torch.cuda.empty_cache()
    ppar = phase("50_pipeline_parallel", pipeline_parallel, dev, args.seed)
    print(json.dumps({"pipeline_parallel": ppar}), flush=True)
    torch.cuda.empty_cache()
    mpar = phase("51_mpmd_pipeline", mpmd_pipeline, dev, args.seed, ppar)
    print(json.dumps({"mpmd_pipeline": mpar}), flush=True)
    torch.cuda.empty_cache()
    pats = phase("52_pipeline_adafactor_tp_serve",
                 pipeline_adafactor_tp_serve, dev, args.seed, ppar)
    print(json.dumps({"pipeline_adafactor_tp_serve": pats}), flush=True)
    print(json.dumps({"phase_seconds": phase_s}), flush=True)

    def per_pass(m, key):
        return sum(r[key] * r["per_pass"] for r in rows if r["m"] == m)

    def pass_bound(m):
        """(ms, bound_by) of one engine pass's int8 work at M = m."""
        t_bytes = per_pass(m, "bytes") / HBM_BYTES_PER_S * 1e3
        t_ops = sum(2 * m * r["k"] * r["n"] * r["per_pass"] for r in rows
                    if r["m"] == m) / BF16_FLOP_PER_S * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    decode_bound, decode_by = pass_bound(8)
    prefill_bound, prefill_by = pass_bound(32)
    def ptxas(pattern):
        """(max registers, total spill bytes) of the kernels whose
        mangled name holds ``pattern``."""
        ptx = [r for kn, r in build["ptxas_by_kernel"].items()
               if pattern in kn]
        return (max((r["registers"] for r in ptx), default=None),
                sum(r["spill_bytes"] for r in ptx) if ptx else None)

    def main_path(window):
        return window["int8_ms_per_decode_step"]

    def host_paths(name):
        """Phases 38-39: part 1 at each dispatch depth, counted from 0;
        the K-step groups' counted launches (one warm-up step and one
        captured group) and, from a trace, the kernels their replays
        ran (all routes)."""
        out = {f"part1_depth{d}": run["launches"][name]
               for d, run in depths["runs"].items()}
        for k in GRAPH_GROUPS:
            case = ksteps[f"k{k}"]
            out[f"vgg_graph_k{k}_counted"] = case["launches_counted"][name]
            out[f"vgg_graph_k{k}_replayed"] = case[
                "launches_replayed_traced"][name]
        # Phase 43: two K = 4 replays of each rung, traced.
        for part, case in {**lgraph["rungs"],
                           **lgraph["variants"]}.items():
            out[f"ladder_graph_{part}_replayed"] = case[
                "replayed_traced"][name]
        # Phase 44: launched over the autotuner's trials with the knob
        # on (eager, captured and warm-up steps; replays launch nothing).
        out["autotune_trials"] = auto["launches"]["launched"][name]
        return out

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
        "bound_ms": decode_bound,
        "bound_by": decode_by,
        "library_ms": per_pass(8, "library_ms"),
        "event_ms": per_pass(8, "event_ms"),
        "timing": ",".join(sorted({r["timing"] for r in rows})),
        "prefill_chunk_ms": per_pass(32, "ms"),
        "prefill_chunk_was_ms": per_pass(32, "simt_ms"),
        "prefill_chunk_library_ms": per_pass(32, "library_ms"),
        "prefill_chunk_bound_ms": prefill_bound,
        "prefill_chunk_bound_by": prefill_by,
        "registers": regs, "spill_bytes": spills,
        # Launches on each path of phases 21-26, each counted from 0 just
        # before its run (all on the mma route).
        "launches_by_path": {
            **{f"spec_{k}": spec[k]["int8_launches"]
               for k in ("k0", "chain", "self2", "quant")},
            **{f"prefix_{n}_{c}": prefix[f"system_{n}"][c]["int8_launches"]
               for n in (256, 200) for c in ("uncached", "cached")},
            "tenants": tenants["int8_launches"],
            **{k: tiers[k]["int8_launches"]
               for k in ("tiers1", "tiers2_bf16", "tiers3_int8")},
            "from_checkpoint": ckpt_serve["from_checkpoint"][
                "int8_launches"],
            "loadgen": load["int8_launches"]},
        # Phase 48: one cp-prefill pass's launches at M = C/sp = 16 (the
        # 32-row chunk over sp = 2), alone, beside its bound, its plain
        # version and torch.matmul.
        "cp_prefill_rows": {k: v for k, v in seqp["int8_cp_prefill"].items()
                            if k != "shapes"},
        # Phase 49: both ranks' decode pass at tp = 2 (49 launches each,
        # counted from 0), and one rank's 49 calls at M = 8 alone beside
        # the dense pass's, its byte bound, its plain version and
        # torch.matmul.
        "tp2_decode_launches": tpar["int8_decode"]["launches"],
        # Phase 52b: rank 0's launches in each tp = 2 engine run (a
        # process of its own over the gloo group; both ranks held to the
        # engine's pass counters), counted from 0 just before each run.
        "tp2_serve_rank0": {
            k: v["int8_launches"]
            for k, v in pats["tp_serve"]["rank0"].items()
            if isinstance(v, dict) and "int8_launches" in v},
        "tp2_rank_pass": tpar["int8_decode"]["passes"]["rank"],
        "tp2_dense_pass": tpar["int8_decode"]["passes"]["dense"],
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
        # Phase 29: part 1 under each remat mode, counted from 0; phase
        # 31: parts 4 and 5 (one launch per step over the flat shards).
        "launches_by_path": {
            **{f"part1_{r}": v["launches"]["sgd"]
               for r, v in vpolicy["runs"].items()},
            **{p: ladder[p]["launches"]["sgd"]
               for p in ("part4", "part5")},
            # Phases 36-37: three launches per ResNet-50 step (161
            # leaves), one per ViT step.
            "resnet50_part1": resnet["cli"]["launches"]["sgd"],
            "resnet50_remat_blocks": resnet["remat_blocks"]["launches"][
                "sgd"],
            "vit_cifar10_part1": vit["cli"]["launches"]["sgd"],
            **host_paths("sgd"),
            # Phase 42: part 3 through a membership epoch (40 steps).
            "part3_elastic": ecard["launches"]["sgd"]},
        # Phase 36: one optimizer step over ResNet-50's 161 leaves.
        "resnet50": resnet["sgd_161_leaves"],
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
        if name == "bn_bwd_dx":
            # Launches on the one-wave route (the row-blocks kernel's
            # beside it); "was": the row-blocks kernel forced, alone, this
            # run; vgg_rounds: the two and batch_norm_backward_elemt in
            # turns, ms per step over phase 7's rounds.
            regs, spills = ptxas("bn_bwd_dx_wave_kernel")
            row.update(
                launches=train["launches"][name]["one_wave"],
                row_blocks_launches=train["launches"][name]["row_blocks"],
                kernel_route="one_wave", was_ms=k["was_ms"],
                vgg_rounds=k["vgg_rounds"], registers=regs,
                spill_bytes=spills)
        if name == "bn_stats":
            row.update(library_var_mean_ms=k["library_var_mean_ms"],
                       read_all_ms=k["read_all_ms"])
        # Phase 29: part 1 under each remat mode (the forward kernels run
        # again in the recompute), counted from 0.
        row["launches_by_path"] = {
            **{f"part1_{r}": v["launches"][name]
               for r, v in vpolicy["runs"].items()},
            **{p: ladder[p]["launches"][name] for p in ("part4", "part5")},
            # Phase 36: ResNet-50 through run_part (8 steps, 2 eval
            # batches) and one remat="blocks" step.
            "resnet50_part1": resnet["cli"]["launches"][name],
            "resnet50_remat_blocks": resnet["remat_blocks"]["launches"][
                name], **host_paths(name),
            # Phase 42: part 3 through a membership epoch (40 steps).
            "part3_elastic": ecard["launches"][name]}
        # Phase 35: one ResNet-50 step's 33 calls at batch 256, alone, on
        # the model's bf16 inputs cast to f32 rows (the forward pair's
        # route) and, for the backward pair, on the bf16 rows as they are
        # (its main path); main_path_ms: phase 36's traced steps.
        main_ms = resnet["traced_window"]["ported_kernels_ms_per_step"][
            name]
        if name in rbn["kernels_bf16"]:
            row["resnet50"] = {**rbn["kernels_bf16"][name],
                               "main_path_ms": main_ms}
            row["resnet50_f32_rows"] = rbn["kernels"][name]
        else:
            row["resnet50"] = {**rbn["kernels"][name],
                               "main_path_ms": main_ms}
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
        # Phases 27-28: the recipe (remat "dots") and each memory-policy
        # setting, counted from 0 just before the timed steps.
        row["launches_by_path"] = {
            "recipe": recipe["launches"][name],
            **{f"policy_{k}": v[name]
               for k, v in matrix["launches"].items()},
            # Phase 33: LM-large under each sharded layout.
            **{f"lm_{k}": lshard[k]["launches"][name]
               for k in ("zero1", "zero2", "fsdp")},
            # Phase 37: the ViT trainers' timed steps, non-causal.
            "vit_tiny": vit["vit_tiny"]["launches"][name],
            "vit_s16": vit["vit_s16"]["launches"][name],
            # Phase 39: ViT-tiny at K = 4 (one warm-up step and one
            # captured group counted; the replay's kernels from a trace).
            "vit_tiny_graph_k4_counted": ksteps["vit_tiny_k4"][
                "launches_counted"][name],
            "vit_tiny_graph_k4_replayed": ksteps["vit_tiny_k4"][
                "launches_replayed_traced"][name],
            # Phase 41: LM-large with Adafactor, replicated and under
            # FactoredZeRO1 (remat "dots": the forward twice per layer).
            **{f"lm_adafactor_{k}": v["launches"][name]
               for k, v in fzero["runs"].items()},
            # Phase 45: LM-large with dropout (block remat), 2 eager
            # steps and a K = 2 capture (its warm-up step and the 2
            # captured steps); phase 46: MoE-large's timed eager steps
            # and its K = 2 capture.
            "lm_dropout_eager": dcap["eager_launches"][name],
            "lm_dropout_capture": dcap["capture_launches"][name],
            "moe_large_eager": moe["launches"][name],
            "moe_large_capture": moe["graph"]["capture_launches"][name],
            # Phase 48: Ulysses at sp = 2, both ranks' local calls (8 heads
            # over the whole sequence), counted from 0.
            "ulysses_sp2_local": seqp["ulysses"]["launches"][name],
            # Phase 49: one block forward and backward of every rank at
            # tp = 2 and 4 (8 and 4 heads), counted from 0.
            **{f"{k}_block": v["launches"][name]
               for k, v in tpar["block"].items() if k != "dense"},
            # Phase 50: one step_grads call of each pipeline schedule at
            # LM-large (M = 4, in-process stages), counted from 0.
            **{f"pipeline_{k}": ppar[k]["launches"][name]
               for k, *_ in PP_RUNS},
            # Phase 51: one MPMD step_grads call at pp = 2 and 4 (M = 4,
            # every stage in this process, f32 edges), counted from 0.
            **{f"mpmd_{k}": mpar[k]["launches"][name]
               for k in ("pp2", "pp4")},
            # Phase 52a: one step_grads call of the in-process 1f1b
            # pipeline with Adafactor (pp = 2, M = 4), counted from 0.
            "pipeline_in_process_adafactor": pats["pipeline_adafactor"][
                "launches"][name]}
        # Phase 49: one call at a rank's shape at tp = 2 and 4 (8 and 4
        # heads), alone, beside its bound at that shape.
        row["tp_rank_call"] = {
            k: {"heads": v["heads_per_rank"], **v["flash"][key]}
            for k, v in tpar["block"].items() if k != "dense"}
        # Phase 37: one ViT step's calls at batch 256, non-causal, alone,
        # beside SDPA's flash backend; main_path_ms: none traced.
        for preset, res in vit["flash_kernels"].items():
            row[preset] = res["kernels"][key]
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
                       "spec": spec, "prefix": prefix, "tenants": tenants,
                       "tiers": tiers, "serve_checkpoint": ckpt_serve,
                       "loadgen": load, "lm_recipe": recipe,
                       "policy_matrix": matrix, "vgg_policy": vpolicy,
                       "examples": examples, "ladder_parts": ladder,
                       "ladder_device_code": ldev, "lm_sharded": lshard,
                       "multi_card": multi, "resnet_bn": rbn,
                       "resnet50": resnet, "vit": vit,
                       "dispatch_window": depths, "multi_step": ksteps,
                       "host_side": hostside,
                       "lm_factored_zero1": fzero, "elastic_card": ecard,
                       "ladder_multi_step": lgraph,
                       "autotune": auto, "dropout_capture": dcap,
                       "moe_large_train": moe,
                       "moe_large_serve": moe_serve,
                       "sequence_parallel": seqp,
                       "tensor_parallel": tpar,
                       "pipeline_parallel": ppar,
                       "mpmd_pipeline": mpar,
                       "pipeline_adafactor_tp_serve": pats,
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
    sp = {k: spec[k] for k in ("k0", "chain", "self2", "quant")}
    print("spec (k=4): " + ", ".join(
        f"{k} {v['tokens_per_s']:.1f} tokens/s, "
        f"{v['tokens_per_engine_step']:.2f} tokens/engine step"
        + (f", acceptance {v['spec']['acceptance']:.3f}"
           if v["spec"]["acceptance"] is not None else "")
        for k, v in sp.items()), flush=True)
    print(f"prefix: {prefix['system_256']['chunks_saved']} prefill chunks "
          f"saved; tenants: "
          + ", ".join(f"{n} TTFT median {t['ttft_ms_median']}"
                      for n, t in tenants["tenants"].items())
          + f"; tiers: int8 moves {tiers['tiers3_int8']['moves']}; "
          f"loadgen: TTFT p50 {load['ttft_p50_ms']} p99 "
          f"{load['ttft_p99_ms']} ms, TPOT p50 {load['tpot_p50_ms']} ms, "
          f"goodput {load['goodput_tokens_per_sec']} tokens/s", flush=True)
    print(f"recipe: LM-large Adafactor + clip {RECIPE_CLIP} + dropout "
          f"{RECIPE_DROPOUT} + chunk {RECIPE_CHUNK} + dots, "
          f"{recipe['ms_per_step']:.1f} ms/step, "
          f"{recipe['tokens_per_s']:.0f} tokens/s, MFU "
          f"{100 * recipe['mfu']:.1f}%, peak {recipe['peak_mem_gib']:.2f} "
          f"GiB; policy: " + ", ".join(
              f"{k} {v['ms_per_step']:.1f} ms {v['peak_mem_gib']:.2f} GiB"
              for k, v in matrix["settings"].items())
          + "; VGG: " + ", ".join(
              f"{r} {v['avg_iter_ms']:.2f} ms/iter "
              f"{v['peak_mem_gib']:.2f} GiB"
              for r, v in vpolicy["runs"].items()), flush=True)
    print("ladder (world 1): " + ", ".join(
        f"{p} {v['avg_iter_ms']:.2f} ms/iter {v['peak_mem_gib']:.2f} GiB"
        for p, v in ladder.items()) + "; LM-large: " + ", ".join(
        f"{k} {v['ms_per_step']:.1f} ms/step {v['peak_mem_gib']:.2f} GiB"
        for k, v in lshard.items()), flush=True)
    print(f"resnet50: batch 256, {resnet['ms_per_step']:.1f} ms/step, "
          f"{resnet['images_per_s']:.0f} images/s, MFU "
          f"{100 * resnet['mfu']:.1f}%, peak {resnet['peak_mem_gib']:.2f} "
          f"GiB; BN kernels {sum(rbn['kernels'][k]['ms'] for k in rbn['kernels']):.2f}"
          f" ms/step alone, casts {rbn['casts_ms_per_step']:.2f} ms; the "
          f"op's backward {rbn['op_backward_ms_per_step']['bf16_rows']:.2f}"
          f" ms/step on bf16 rows, "
          f"{rbn['op_backward_ms_per_step']['f32_route']:.2f} on the f32 "
          f"route (step {resnet['ms_per_step_f32_route']:.1f} ms with it "
          f"forced); vit: "
          + ", ".join(f"{v['model']} {v['ms_per_step']:.1f} ms/step MFU "
                      f"{100 * v['mfu']:.1f}%"
                      for v in (vit["vit_tiny"], vit["vit_s16"])),
          flush=True)
    tm = ksteps["timing"]
    print("host side (VGG-11, batch 256): part 1 iteration ms at depth "
          + ", ".join(f"{d}: {r['avg_iter_ms']:.2f}"
                      for d, r in depths["runs"].items())
          + "; untraced ms per untimed iteration "
          + ", ".join(f"{d}: {r['untraced_ms_per_iter']:.2f}"
                      for d, r in depths["traced"].items())
          + "; K steps per dispatch ms/iter (stop_many) "
          + ", ".join(f"K={k[1:]}: {v['avg_iter_ms']:.2f}"
                      for k, v in tm.items())
          + "; capture ms " + ", ".join(
              f"K={k}: {ksteps[f'k{k}']['capture_ms']:.1f}"
              for k in GRAPH_GROUPS), flush=True)
    fz = fzero["runs"]
    print(f"factored zero1: LM-large Adafactor zero1 "
          f"{fz['zero1']['ms_per_step']:.1f} ms/step "
          f"{fz['zero1']['peak_mem_gib']:.2f} GiB, replicated "
          f"{fz['replicated']['ms_per_step']:.1f} ms/step "
          f"{fz['replicated']['peak_mem_gib']:.2f} GiB (phase 27, with "
          f"clip: {recipe['ms_per_step']:.1f} ms, "
          f"{recipe['peak_mem_gib']:.2f} GiB); elastic: VGG-11 part 3 "
          f"resharded at world 1 in {ecard['reshard_s']:.3f} s",
          flush=True)
    print(f"dropout under capture: LM-large K={dcap['k']} replay bit for "
          f"bit with eager, {dcap['eager_ms_per_step']:.1f} ms/step eager, "
          f"{dcap['replay_ms_per_step']:.1f} replayed; mask hash "
          f"{dcap['mask_ms']:.3f} ms vs torch.rand "
          f"{dcap['torch_rand_mask_ms']:.3f} ms [{card}]", flush=True)
    print(f"moe train: {moe['model']} batch {moe['batch']} x seq "
          f"{moe['seq']}, Adafactor, {moe['ms_per_step']:.1f} ms/step, "
          f"{moe['tokens_per_s']:.0f} tokens/s, MFU (active) "
          f"{100 * moe['mfu']:.1f}%, peak {moe['peak_mem_gib']:.2f} GiB;"
          f"{' ' + moe['route_stats'] if moe['route_stats'] else ''}; "
          f"K={MOE_GRAPH_K} graph bit for bit, "
          f"{moe['graph']['replay_ms_per_step']:.1f} ms/step replayed "
          f"[{card}]", flush=True)
    print(f"moe serve: {moe_serve['tokens_per_s']:.1f} tokens/s, TTFT "
          f"median {moe_serve['ttft_ms_median']:.1f} ms, max "
          f"{moe_serve['ttft_ms_max']:.1f} ms; dropped share decode "
          f"{moe_serve['decode_dropped_share']}, prefill "
          f"{moe_serve['prefill_dropped_share']} [{card}]", flush=True)
    rg = seqp["ring"]
    print("sequence parallel (LM-large attention, one card): ring block "
          "update " + ", ".join(
              f"sp={k[2:]} {v['block_update_ms_per_rank_step']:.3f} ms per "
              f"rank-step, peak {v['rank0_fwd_bwd_peak_gib_above_inputs']:.2f}"
              f" GiB" for k, v in rg.items())
          + f"; flash forward {seqp['flash_fwd_ms_per_layer']:.3f} ms per "
          f"layer; Ulysses sp=2 local flash bit-equal to the 16-head call: "
          f"{seqp['ulysses']['bitwise_equal_16_head']}; int8 at M=16 "
          f"{seqp['int8_cp_prefill']['ms']:.3f} ms per pass vs torch.matmul "
          f"{seqp['int8_cp_prefill']['library_ms']:.3f} [{card}]",
          flush=True)
    blk = tpar["block"]
    rp = tpar["int8_decode"]["passes"]
    print("tensor parallel (LM-large, one card): block fwd+bwd "
          + ", ".join(f"{k} {v.get('rank_fwd_bwd_ms', v.get('fwd_bwd_ms')):.2f}"
                      f" ms" for k, v in blk.items())
          + f"; int8 decode pass at tp={TP_DECODE} one rank "
          f"{rp['rank']['ms']:.3f} ms (bound {rp['rank']['bound_ms']:.3f}) "
          f"vs dense {rp['dense']['ms']:.3f} ms [{card}]", flush=True)
    print("pipeline (LM-large, in-process stages, M=4): dense "
          f"{ppar['dense']['ms_per_step']:.1f} ms (grad_accum 4: "
          f"{ppar['dense_accum']['ms_per_step']:.1f}); " + ", ".join(
              f"{k} {ppar[k]['ms_per_step']:.1f} ms "
              f"{ppar[k]['grads_peak_gib_above']:.2f} GiB"
              for k, *_ in PP_RUNS)
          + f"; 1f1b K=2 replay {ppar['1f1b']['k2_replay_ms_per_step']:.1f}"
          f" ms/step [{card}]", flush=True)
    mp2 = mpar["pp2"]
    print(f"mpmd (LM-large, in-process stages, M=4): pp=2 "
          f"{mp2['ms_per_step']:.1f} ms/step (phase 50 1f1b "
          f"{mpar['phase50_1f1b_ms_per_step']:.1f}), gradient peak "
          f"{mp2['grads_peak_gib_above']:.2f} GiB, edge bytes per step "
          f"{mp2['edge_dense_bytes_per_step']} f32, bf16 "
          f"{mpar['cross_bf16']['edge_wire_bytes_per_step']}, int8 "
          f"{mpar['cross_int8']['edge_wire_bytes_per_step']}; drill "
          f"{mpar['drill']['result']} OK [{card}]", flush=True)
    pa, tps = pats["pipeline_adafactor"], pats["tp_serve"]["rank0"]
    print(f"pipeline + Adafactor (LM-large, in-process stages, pp=2 1f1b, "
          f"M=4): {pa['ms_per_step']:.1f} ms/step (phase 50 1f1b AdamW "
          f"{pa['phase50_1f1b_adamw_ms_per_step']:.1f}), gradient peak "
          f"{pa['grads_peak_gib_above']:.2f} GiB, step peak "
          f"{pa['step_peak_gib_above']:.2f} GiB; tp=2 serving over gloo "
          "(two processes, one card): " + ", ".join(
              f"{k} {tps[k]['tokens_per_s']:.1f} tokens/s"
              for k in ("k0", "chain", "self2", "tiers3_int8"))
          + f", int8 moves {tps['tiers3_int8']['moves']} [{card}]",
          flush=True)
    print(f"{card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
