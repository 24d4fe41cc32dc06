"""The serving engine: request lifecycle over the paged KV pool and the
continuous-batching scheduler — the port of tpu_ddp/serve/engine.py, on
one device or tensor parallel over a process group of one card each, with
the serving chaos hooks of fleet/resilience.py (the weight subscriber is
ROADMAP Queue 1 item 11b).

Each engine step runs, in PyTorch eager mode:

- **prefill chunks** (:func:`prefill_chunk`) — one ``prefill_chunk``-token
  slice of one prompt per chunk, at most one chunk per step, or
  ``spec_k + 1`` when speculating; short chunks are padded and padded
  positions write to the null block.
- **a decode step** (:func:`decode_bank`) — one token for the ENTIRE slot
  bank. Idle slots ride along with zeroed block tables, so their writes
  land in the null block and their samples are discarded host-side. Per
  layer it is the shared decode core (models/decode.py) over a
  pool-gathered cache view — the math ``generate()`` runs over contiguous
  caches. Under ``spec_k > 0`` the step is a speculative window instead
  (serve/speculative.py): ``chain`` runs ``spec_k + 1`` of these passes
  back to back on the device, the fused families draft then verify.

K/V of a position is written before it is attended, and everything beyond
a query's position gets an exact zero weight. Sampling is stateless,
keyed by (request seed, absolute position), so a request reproduces its
tokens whatever its batch neighbours. Every masked write (idle slots,
prefill padding, speculative columns past a request's budget) targets
the null block: :func:`write_slots` is the one place that decides where a
step writes.

Under ``decode_quant="int8"`` every projection and the LM head run the
weight-only int8 matmul (ops/quant_matmul.py): on the card, the Hopper
kernel — 4 launches per layer plus 1 for the head, per one-token pass and
per prefill chunk. The counters ``serve_prefill_chunks``,
``serve_target_passes`` (one-token passes of the target: decode steps,
chain columns, verify columns) and ``serve_draft_passes`` give the
expected launch count exactly.

With ``kv_tiers > 1`` the pool keeps only part of the context hot
(serve/kv_pool.py) and the steps read cold pages through the dequant
(serve/long_context.py). ``prefix_cache`` shares prompt blocks between
requests (fleet/prefix.py); ``tenant_classes``, ``queue_limit`` and
``shed_ms`` run weighted fair admission and shedding.

Chaos (``TPU_DDP_CHAOS_FAULTS`` holding a serving kind): ``step()`` asks
the injector first, before any state changes, so a ``replica-crash``
leaves an engine the Router can harvest with ``drain()``; every decode
route (k = 0, chain and the fused drafts) asks it before the bank runs,
and a ``nonfinite-logits`` fire NaNs one live request's last block, which
is always private (lazily allocated, or the copy a prefix hit made).

Tensor-parallel serving (``tp_group``): every rank of the group runs the
engine in lockstep with the same requests, each holding its Megatron
slices of the dense parameters (parallel/tensor_parallel.py), its KV /
tp heads of the pool, and under ``decode_quant="int8"`` its slices of the
dense tree's quantization; each block all-reduces the f32 partial sums
of ``wo`` and ``w2``. Logits, hence tokens, are the same on every rank.
JAX places the tree on an ``mp`` mesh and keeps the pool replicated;
here one process holds one card, so the group replaces the mesh and each
pool holds only its rank's heads. Everything else runs on the rank's
slices as it runs on the dense tree: the speculative draft and verify
passes (the int8 draft on the rank's slices of the dense tree's
quantization), the accept rule on the replicated logits (every rank
accepts the same prefix), the tiered pool (each tier holds the rank's
heads; an int8 cold row's scale is the max over every head, all-reduced
over the group, serve/kv_pool.py) and cp prefill over an ``sp_group``
whose every rank is also in a tp group (a world of sp x tp processes,
each projecting its C/sp rows on its heads).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
import warnings
from typing import Callable

import numpy as np
import torch

from tpu_ddp_torch.convert import shape_leaves
from tpu_ddp_torch.models.decode import (
    attend_cached,
    block_finish,
    check_decodable,
    dense_params_from_checkpoint,
    project_qkv,
    sample_token,
)
from tpu_ddp_torch.ops.quant import DECODE_QUANTS
from tpu_ddp_torch.serve.kv_pool import PagedKVPool
from tpu_ddp_torch.serve.scheduler import (
    Scheduler,
    parse_tenant_classes,
    prefill_len,
    tenant_of,
)
from tpu_ddp_torch.serve.speculative import (
    accept_length,
    parse_spec_draft,
    spec_step,
)
from tpu_ddp_torch.utils.device import resolve_device
from tpu_ddp_torch.utils.metrics import MetricsLogger


@dataclasses.dataclass(eq=False)
class Request:
    """One submitted request; doubles as the caller's streaming handle
    (the engine appends into ``tokens``/``logprobs`` as they land).
    Compared by identity."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    seed: int = 0
    eos_id: int | None = None
    on_token: Callable[[int], None] | None = None
    # The tenant this request bills to: WFQ class, prefix-cache
    # namespace and per-tenant accounting all key on it.
    tenant: str = "default"
    tokens: list = dataclasses.field(default_factory=list)
    logprobs: list = dataclasses.field(default_factory=list)
    token_versions: list = dataclasses.field(default_factory=list)
    # perf_counter stamp per emitted token: the TPOT basis under
    # speculation, where one engine step can emit a burst of tokens.
    token_times: list = dataclasses.field(default_factory=list)
    # Speculation ledger: proposed == accepted + rejected at every step.
    spec_proposed: int = 0
    spec_accepted: int = 0
    spec_rejected: int = 0
    done: bool = False
    cancelled: bool = False
    shed: bool = False          # dropped by admission control
    quarantined: bool = False   # non-finite logits: request isolated
    migrations: int = 0         # times replayed on another replica
    # The prompt's last ``replay`` tokens were streamed by another replica
    # (a migrated continuation): they are fed through decode passes, not
    # prefilled, so their K/V is the arithmetic that sampled them.
    replay: int = 0
    submitted_at: float = 0.0
    first_token_at: float | None = None
    finished_at: float | None = None

    @property
    def ttft_s(self) -> float | None:
        """Time to first token (seconds since submit), once known."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at


def write_slots(tables, pos, block_size: int, limits=None):
    """Where a step writes: the (block id, offset) of each position of
    ``pos`` (S, C) through ``tables`` (S, BPS). Positions at or beyond
    ``limits`` (S,) — prefill padding, speculative columns past a
    request's budget — go to the null block, as do idle rows (their
    tables are zeros), so every duplicate target of a step's
    ``index_put_`` is the null block."""
    bps = tables.shape[1]
    safe = torch.clamp(pos // block_size, 0, bps - 1)
    bidx = torch.gather(tables, 1, safe)
    if limits is not None:
        bidx = torch.where(pos < limits[:, None], bidx,
                           torch.zeros_like(bidx) + PagedKVPool.NULL_BLOCK)
    return bidx, pos % block_size


def _view(pool_buf, tables, block_size):
    """Gather one layer's pages for ``tables`` (S, BPS) into a
    contiguous (S, BPS * block_size, KV, hd) cache view."""
    s, bps = tables.shape
    return pool_buf[tables].reshape(s, bps * block_size,
                                    *pool_buf.shape[2:])


def _pool_view(pool_k, pool_v, tables, block_size):
    """The single-tier attention view: layer ``li``'s K and V pages
    gathered through the logical tables."""
    return lambda li: (_view(pool_k[li], tables, block_size),
                       _view(pool_v[li], tables, block_size))


@torch.no_grad()
def bank_logits(model, block_size: int, params, pool_k, pool_v, tables,
                lengths, last_tokens, *, limits=None, num_layers=None,
                view=None):
    """One one-token pass of the whole bank: feed ``last_tokens`` (S,) at
    positions ``lengths`` (S,), write their K/V into the pool in place
    through ``tables`` (S, BPS) (:func:`write_slots`), attend and return
    the logits (S, V) f32. ``num_layers`` cuts the stack short (the
    early-exit draft shares the head); ``view(li)`` gives layer ``li``'s
    (K, V) attention view (default: the pool gathered through
    ``tables``)."""
    cd = model.compute_dtype
    if view is None:
        view = _pool_view(pool_k, pool_v, tables, block_size)
    x = params["embed"][last_tokens[:, None]].to(cd)      # (S, 1, dm)
    pos = lengths[:, None]                                # (S, 1)
    bidx, off = write_slots(tables, pos, block_size, limits)
    bidx, off = bidx[:, 0], off[:, 0]
    blocks = params["blocks"]
    if num_layers is not None:
        blocks = blocks[:num_layers]
    for li, blk in enumerate(blocks):
        q, k, v = project_qkv(model, blk, x, pos)
        pool_k[li].index_put_((bidx, off), k[:, 0].to(pool_k.dtype))
        pool_v[li].index_put_((bidx, off), v[:, 0].to(pool_v.dtype))
        ck, cv = view(li)
        o = attend_cached(model, q, ck, cv, pos)
        x = block_finish(model, blk, x, o)
    return model.head_apply(params, x)[:, 0]              # (S, V)


def sample_bank(model, logits, temps, seeds, lengths):
    """Sample every slot at position ``lengths + 1``; ``bad`` flags a slot
    whose logits or sampled logprob are non-finite, so the host
    quarantines exactly that request."""
    toks, lps = sample_token(model, logits, temps, seeds, lengths + 1)
    bad = ~(torch.isfinite(logits).all(dim=-1) & torch.isfinite(lps))
    return toks, lps, bad


def decode_bank(model, block_size: int, params, pool_k, pool_v, tables,
                lengths, last_tokens, temps, seeds, *, limits=None,
                view=None):
    """One token for every slot of the bank: :func:`bank_logits` then
    :func:`sample_bank`. Returns (pool_k, pool_v, tokens, logprobs,
    bad)."""
    logits = bank_logits(model, block_size, params, pool_k, pool_v,
                         tables, lengths, last_tokens, limits=limits,
                         view=view)
    return (pool_k, pool_v) + sample_bank(model, logits, temps, seeds,
                                          lengths)


@torch.no_grad()
def prefill_chunk(model, block_size: int, params, pool_k, pool_v, table,
                  tokens, start: int, prompt_len: int, temp, seed, *,
                  view=None):
    """One prefill chunk of one slot. ``tokens`` (1, C) is the chunk
    (zero-padded past the prompt) at positions ``start..start+C-1``;
    positions >= ``prompt_len`` write to the null block and never
    influence a valid query. ``table`` is the slot's (BPS,) block table
    (the hot-slot table under tiers, with ``view`` the tiered view). The
    sampled (token, logprob) at position ``prompt_len``, from the logits
    of position ``prompt_len - 1``, is meaningful only on the final
    chunk. Returns (pool_k, pool_v, token, logprob)."""
    cd = model.compute_dtype
    C = tokens.shape[1]
    dev = tokens.device
    p = start + torch.arange(C, device=dev)               # (C,)
    if view is None:
        view = _pool_view(pool_k, pool_v, table[None], block_size)
    limit = torch.full((1,), prompt_len, dtype=torch.int64, device=dev)
    blk_idx, off = write_slots(table[None], p[None], block_size, limit)
    blk_idx, off = blk_idx[0], off[0]
    x = params["embed"][tokens].to(cd)                    # (1, C, dm)
    for li, blkp in enumerate(params["blocks"]):
        q, k, v = project_qkv(model, blkp, x, p)
        pool_k[li].index_put_((blk_idx, off), k[0].to(pool_k.dtype))
        pool_v[li].index_put_((blk_idx, off), v[0].to(pool_v.dtype))
        ck, cv = view(li)
        o = attend_cached(model, q, ck, cv, p)
        x = block_finish(model, blkp, x, o)
    logits = model.head_apply(params, x)[0]               # (C, V)
    last = min(max(prompt_len - 1 - start, 0), C - 1)
    tok, lp = sample_token(model, logits[last:last + 1], temp, seed, limit)
    return pool_k, pool_v, tok[0], lp[0]


class DecodeRole:
    """What every owner of a decode bank shares: request checks, the
    bank's inputs, the ``nonfinite-logits`` drill, and the harvest of a
    pass (quarantine, the replay rule, emission, retirement, the tenant
    ledger). :class:`ServeEngine` is one; so is the decode role of
    fleet/disagg.py's ``DisaggEngine``.

    The host class provides ``model``, ``sched`` and ``pool`` (the
    decode scheduler and its pool), ``num_slots``, ``blocks_per_seq``,
    ``device``, ``metrics``, ``param_version``, ``chaos``, ``_step_n``,
    ``_rid`` and ``tenant_counts``."""

    def _new_request(self, prompt, max_new_tokens: int, temperature: float,
                     seed: int, eos_id, on_token, tenant: str,
                     replay: int) -> Request:
        """A checked :class:`Request` for ``submit`` (``replay``: the
        prompt's last ``replay`` tokens were already streamed, a migrated
        continuation's; they are fed through decode passes and not
        emitted again)."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold >= 1 token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = prompt.size + max_new_tokens
        if total > self.model.max_seq_len:
            raise ValueError(f"prompt + generation = {total} exceeds "
                             f"max_seq_len={self.model.max_seq_len}")
        if temperature < 0:
            raise ValueError("temperature must be >= 0")
        if prompt.min() < 0 or prompt.max() >= self.model.vocab_size:
            raise ValueError(f"prompt tokens must lie in "
                             f"[0, {self.model.vocab_size})")
        if not tenant:
            raise ValueError("tenant must be a non-empty string")
        if not 0 <= replay < prompt.size:
            raise ValueError(f"replay={replay} must leave >= 1 prompt "
                             "token to prefill")
        return Request(rid=next(self._rid), prompt=prompt,
                       max_new_tokens=int(max_new_tokens),
                       temperature=float(temperature), seed=int(seed),
                       eos_id=eos_id, on_token=on_token, tenant=str(tenant),
                       replay=int(replay), submitted_at=time.perf_counter())

    def _tc(self, tenant: str) -> dict[str, int]:
        return self.tenant_counts.setdefault(
            tenant, {"submitted": 0, "completed": 0, "cancelled": 0,
                     "shed": 0, "quarantined": 0})


    def _table_for(self, slot) -> np.ndarray:
        t = np.zeros(self.blocks_per_seq, np.int64)
        t[:len(slot.blocks)] = slot.blocks
        return t

    def _tensor(self, a, dtype=torch.int64):
        return torch.as_tensor(a, dtype=dtype).to(self.device)

    def bank_inputs(self, dslots: list[int]):
        """The decode step's inputs for the live slots ``dslots`` —
        (tables, lengths, last_tokens, temps, seeds) on the device —
        after growing each slot's table to cover its next write. Idle
        rows keep zero tables, lengths and tokens."""
        tables = np.zeros((self.num_slots, self.blocks_per_seq), np.int64)
        for i in dslots:
            self.sched.ensure_block(i)
            tables[i] = self._table_for(self.sched.slots[i])
        return (self._tensor(tables),) + self._slot_rows(dslots)

    def _slot_rows(self, dslots):
        """(lengths, last tokens, temps, seeds) of the bank on the
        device; idle rows are zeros."""
        S = self.num_slots
        lengths = np.zeros(S, np.int64)
        last = np.zeros(S, np.int64)
        temps = np.zeros(S, np.float32)
        seeds = np.zeros(S, np.int64)
        for i in dslots:
            s = self.sched.slots[i]
            lengths[i] = s.length
            last[i] = s.pending_token
            temps[i] = s.request.temperature
            seeds[i] = s.request.seed
        return (self._tensor(lengths), self._tensor(last),
                self._tensor(temps, torch.float32), self._tensor(seeds))

    def _maybe_poison(self, dslots: list[int]) -> None:
        """The ``nonfinite-logits`` drill: NaN the V pages of the first
        live request's last block (never a block the prefix index shares).
        The NaN reaches only that request's logits, through its own
        pages, so the bank's ``bad`` flag must isolate exactly that slot.
        A tiered pool poisons the block's hot copy."""
        if self.chaos is None or not dslots \
                or not self.chaos.poison_fires(self._step_n):
            return
        blk = self.sched.slots[dslots[0]].blocks[-1]
        if self.pool.tiers > 1:
            self.pool.ensure_hot([blk])
            blk = self.pool.hot_slot(blk)
        self.pool.v[:, blk] = float("nan")

    def _harvest(self, dslots: list[int], toks, lps, bad) -> None:
        """One decode pass's samples (host arrays over the bank): a row
        with non-finite logits is quarantined, every other live row
        advances one position and settles its sample."""
        for i in dslots:
            if bad[i]:
                self._quarantine(i)
                continue
            self.sched.slots[i].length += 1
            self._emit(i, int(toks[i]), float(lps[i]))

    def _quarantine(self, idx: int) -> None:
        """Non-finite logits on slot ``idx``: isolate the request, not
        the bank. Its private pages are scrubbed before they return to
        the free list (a NaN'd V page re-issued to another request would
        leak through zero-weight attention), then the slot retires and
        the request finishes quarantined."""
        s = self.sched.slots[idx]
        req = s.request
        self.pool.scrub([b for b in s.blocks
                         if self.pool.refcount(b) == 1])
        self.sched.retire(idx)
        req.quarantined = True
        req.done = True
        req.finished_at = time.perf_counter()
        self.metrics.inc("serve_quarantined")
        self._tc(tenant_of(req))["quarantined"] += 1
        self._tc(tenant_of(req))["completed"] += 1
        warnings.warn(
            f"request {req.rid}: non-finite logits at engine step "
            f"{self._step_n}; request quarantined, pages scrubbed",
            stacklevel=3)

    def _emit(self, idx: int, tok: int, logprob: float) -> None:
        """Settle one sample of slot ``idx`` (:meth:`SlotState.take`: a
        replayed token is fed on, not emitted), then stream it."""
        s = self.sched.slots[idx]
        if s.take(tok) is None:
            return
        s.generated += 1
        if self._record(s.request, tok, logprob):
            self.sched.retire(idx)

    def _record(self, req: Request, tok: int, logprob: float) -> bool:
        """Stream one emitted token of ``req``: stamp TTFT on its first,
        call ``on_token``, finish it on ``max_new_tokens`` or EOS.
        Returns whether it finished (the caller frees its slot)."""
        req.tokens.append(tok)
        req.logprobs.append(logprob)
        req.token_versions.append(self.param_version)
        now = time.perf_counter()
        req.token_times.append(now)
        if req.first_token_at is None:
            req.first_token_at = now
            self.metrics.observe("serve_ttft_ms",
                                 (now - req.submitted_at) * 1e3)
        if req.on_token is not None:
            req.on_token(tok)
        if len(req.tokens) >= req.max_new_tokens \
                or (req.eos_id is not None and tok == req.eos_id):
            req.done = True
            req.finished_at = now
            self.metrics.inc("serve_retired")
            self._tc(tenant_of(req))["completed"] += 1
            return True
        return False


class ServeEngine(DecodeRole):
    """Continuous-batching serving over one dense TransformerLM.

    Knob defaults come from ``TrainConfig`` (``TPU_DDP_SERVE_*``,
    ``TPU_DDP_DECODE_QUANT``, ``TPU_DDP_PREFIX_CACHE``,
    ``TPU_DDP_TENANT_CLASSES``, ``TPU_DDP_SPEC_K``/``_DRAFT``,
    ``TPU_DDP_KV_TIERS``/``_COLD_DTYPE``, ``TPU_DDP_CP_PREFILL``);
    explicit arguments win. ``num_blocks`` defaults to a pool big enough
    that every slot can hold a ``max_seq_len`` sequence; with
    ``kv_tiers > 1`` it is the logical pool the scheduler admits against,
    while ``hbm_blocks`` bounds the hot pages and ``cold_blocks`` the cold
    ones. ``device=None`` means ``"cuda"``; the CPU must be asked for with
    ``device="cpu"``. ``tp_group``, a process group of more than one
    rank, serves tensor parallel (``params`` dense: each rank keeps its
    slices); ``mesh`` raises, naming that per-process form.
    ``cp_prefill`` ("ring" or "ulysses") shards each prefill chunk over
    ``sp_group``, a process group of >= 2 ranks (the
    JAX engine's sp mesh axis; serve/long_context.py): the engine then
    runs on every rank of the group, in lockstep, with the same requests.
    """

    def __init__(self, model, params, *, num_slots: int | None = None,
                 block_size: int | None = None,
                 prefill_chunk: int | None = None,
                 num_blocks: int | None = None,
                 cache_dtype: str | None = None,
                 mode: str = "continuous",
                 prefix_cache: bool | None = None,
                 queue_limit: int | None = None,
                 shed_ms: float | None = None,
                 tenant_classes: str | None = None,
                 spec_k: int | None = None,
                 spec_draft: str | None = None,
                 decode_quant: str | None = None,
                 kv_tiers: int | None = None,
                 kv_cold_dtype: str | None = None,
                 hbm_blocks: int | None = None,
                 cold_blocks: int | None = None,
                 cp_prefill: str | None = None,
                 sp_group=None,
                 tp_group=None,
                 mesh=None,
                 metrics: MetricsLogger | None = None,
                 config=None, device=None):
        check_decodable(model)
        from tpu_ddp_torch.utils.config import (TrainConfig,
                                                refuse_unported_env)
        refuse_unported_env()
        if mesh is not None:
            raise NotImplementedError(_MESH_REFUSAL.format(arg="mesh"))
        from tpu_ddp_torch.parallel.tensor_parallel import with_serve_tp
        self.device = resolve_device(device)
        if config is None:
            config = TrainConfig()
        self.tp_group = tp_group
        self.dense_model = model
        # The model the decode math runs: this rank's heads and d_ff
        # slice under a tp group of more than one rank.
        model = self.model = with_serve_tp(model, tp_group)
        self.tp = model._tp
        self.tp_rank = (torch.distributed.get_rank(tp_group)
                        if self.tp > 1 else 0)
        self.params = self._fp_params(params)
        self.num_slots = int(num_slots if num_slots is not None
                             else config.serve_slots)
        self.block_size = int(block_size if block_size is not None
                              else config.serve_block_size)
        self.prefill_chunk = int(
            prefill_chunk if prefill_chunk is not None
            else config.serve_prefill_chunk)
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.blocks_per_seq = math.ceil(model.max_seq_len
                                        / self.block_size)
        if num_blocks is None:
            num_blocks = self.num_slots * self.blocks_per_seq + 1
        cache_dtype = (cache_dtype if cache_dtype is not None
                       else config.serve_cache_dtype)
        self.kv_tiers = int(kv_tiers if kv_tiers is not None
                            else config.kv_tiers)
        self.kv_cold_dtype = str(kv_cold_dtype if kv_cold_dtype is not None
                                 else config.kv_cold_dtype)
        self.cp_prefill = str(cp_prefill if cp_prefill is not None
                              else config.cp_prefill)
        if self.cp_prefill not in ("off", "ring", "ulysses"):
            raise ValueError(
                f"cp_prefill={self.cp_prefill!r}: expected 'off', "
                "'ring' or 'ulysses' (TPU_DDP_CP_PREFILL)")
        self.sp_group = sp_group
        if self.cp_prefill != "off":
            if self.kv_tiers > 1:
                raise ValueError(
                    "cp_prefill requires the single-tier pool "
                    "(TPU_DDP_KV_TIERS=1): the sharded chunk step "
                    "scatters through the logical table directly")
            import torch.distributed as dist
            sp = (dist.get_world_size(sp_group)
                  if sp_group is not None and dist.is_initialized() else 1)
            if sp < 2:
                raise ValueError(
                    "cp_prefill needs a mesh with an 'sp' axis of "
                    "extent >= 2 (TPU_DDP_CP_PREFILL)")
            if self.prefill_chunk % sp:
                raise ValueError(
                    f"prefill_chunk={self.prefill_chunk} must divide "
                    f"evenly over sp={sp} ranks (TPU_DDP_CP_PREFILL)")
        self.pool = PagedKVPool(model, num_blocks, self.block_size,
                                cache_dtype, device=self.device,
                                tiers=self.kv_tiers,
                                cold_dtype=self.kv_cold_dtype,
                                hbm_blocks=hbm_blocks,
                                cold_blocks=cold_blocks)
        prefix_cache = (bool(prefix_cache) if prefix_cache is not None
                        else config.prefix_cache)
        self.prefix = None
        if prefix_cache:
            from tpu_ddp_torch.fleet.prefix import PrefixIndex
            self.prefix = PrefixIndex(self.pool)
        tc = (tenant_classes if tenant_classes is not None
              else config.tenant_classes)
        self.tenants = parse_tenant_classes(tc) or None
        self.sched = Scheduler(self.pool, self.num_slots, mode,
                               prefix=self.prefix, tenants=self.tenants)
        # Per-tenant ledger: completed + cancelled + shed + in-flight ==
        # submitted for every tenant at every step (completed includes
        # quarantined: the request ended on this engine).
        self.tenant_counts: dict[str, dict[str, int]] = {}
        self.metrics = metrics if metrics is not None else MetricsLogger()
        self.spec_k = int(spec_k if spec_k is not None else config.spec_k)
        if self.spec_k < 0:
            raise ValueError("spec_k must be >= 0")
        self.spec_draft = str(spec_draft if spec_draft is not None
                              else config.spec_draft)
        kind, j = parse_spec_draft(self.spec_draft)
        if kind == "self" and j > model.num_layers:
            raise ValueError(
                f"spec_draft={self.spec_draft!r}: draft depth {j} "
                f"exceeds the model's {model.num_layers} blocks")
        self._spec_kind, self._spec_j = kind, j
        self.draft_layers = (j if kind == "self" else model.num_layers)
        self.decode_quant = str(decode_quant if decode_quant is not None
                                else config.decode_quant)
        if self.decode_quant not in DECODE_QUANTS:
            raise ValueError(
                f"decode_quant={self.decode_quant!r}: expected 'none'"
                " or 'int8' (TPU_DDP_DECODE_QUANT)")
        if model.moe_experts and (self.decode_quant == "int8"
                                  or kind == "quant"):
            # The routed layer contracts stacked expert weights in batched
            # matmuls (parallel/moe.py), not qdot: int8 leaves would not
            # run there. The JAX engine's refusal, word for word.
            raise ValueError(
                "decode_quant='int8' (and the 'quant' draft family) "
                "do not support MoE models yet: the routed expert "
                "einsums bypass ops/quant.qdot; serve MoE with "
                "decode_quant='none'")
        self._refresh_quant(params)
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_rejected = 0
        self._rid = itertools.count()
        self.config = config
        self.queue_limit = int(queue_limit if queue_limit is not None
                               else config.serve_queue_limit)
        self.shed_ms = float(shed_ms if shed_ms is not None
                             else config.serve_shed_ms)
        if self.queue_limit < 0:
            raise ValueError("queue_limit must be >= 0")
        if self.shed_ms < 0:
            raise ValueError("shed_ms must be >= 0")
        self._step_n = 0
        self.param_version = 0
        self.chaos = None
        from tpu_ddp_torch.fleet.resilience import (ServeFaultInjector,
                                                    serve_chaos_active)
        if serve_chaos_active():
            self.chaos = ServeFaultInjector.from_env()

    def _fp_params(self, params):
        """The fp master this rank serves from dense ``params``: the
        dict on the device, or its tensor-parallel slices."""
        if self.tp == 1:
            return _to_device(params, self.device)
        from tpu_ddp_torch.parallel.tensor_parallel import \
            shard_decode_params
        return shard_decode_params(self.dense_model, params, self.tp,
                                   self.tp_rank, device=self.device)

    def _refresh_quant(self, dense) -> None:
        """(Re)derive the decode-path parameter dicts from the fp master
        ``self.params`` — at construction and after every
        :meth:`swap_params`. ``self._decode_params`` feeds every target
        pass: the fp dict under ``decode_quant == "none"``, the
        per-channel int8 dict (ops/quant.py quantize_params) under
        ``"int8"``, under a tp group this rank's slices of the ``dense``
        tree's quantization. ``self._draft_params`` is the fused draft's:
        the decode dict for a "self-<j>" early exit, the int8 dict for a
        "quant" draft."""
        qp = None
        if self.decode_quant == "int8" or self._spec_kind == "quant":
            from tpu_ddp_torch.ops.quant import quantize_params
            qp = (quantize_params(self.model, self.params) if self.tp == 1
                  else quantize_params(self.dense_model, dense, self.tp,
                                       self.tp_rank, device=self.device))
        self._decode_params = (qp if self.decode_quant == "int8"
                               else self.params)
        self._draft_params = (qp if self._spec_kind == "quant"
                              else self._decode_params)

    @classmethod
    def from_checkpoint(cls, model, directory: str,
                        step: int | None = None, *,
                        param_budget_bytes: int | None = None,
                        shard_devices=None, tp_group=None, device=None,
                        **kwargs):
        """Load a training checkpoint (either package's, any strategy:
        the artifact is canonical) into a fresh engine — the
        train-to-serve round trip. When the dense params exceed
        ``param_budget_bytes`` (one card's budget), or ``tp_group`` is
        given without a budget, the engine serves tensor parallel over
        ``tp_group`` (default: the world), each rank reading the dense
        tree to the host and keeping its slices; below the budget it
        serves alone on one device (JAX ``from_checkpoint``).
        ``shard_devices`` raises, naming ``tp_group``: one process holds
        one card."""
        import torch.distributed as dist
        if shard_devices is not None:
            raise NotImplementedError(
                _MESH_REFUSAL.format(arg="shard_devices"))
        sharded = tp_group is not None
        if param_budget_bytes is not None:
            nbytes = sum(math.prod(s) for s in shape_leaves(
                model.param_shapes())) * torch.finfo(
                    model.param_dtype).bits // 8
            sharded = nbytes > param_budget_bytes
            if sharded and tp_group is None and dist.is_initialized():
                tp_group = dist.group.WORLD
        if not sharded:
            tp_group = None
        params = dense_params_from_checkpoint(
            model, directory, step,
            device="cpu" if tp_group is not None else device)
        return cls(model, params, device=device, tp_group=tp_group,
                   **kwargs)

    # ---- request lifecycle ---------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               temperature: float = 0.0, seed: int = 0,
               eos_id: int | None = None,
               on_token: Callable[[int], None] | None = None,
               tenant: str = "default", replay: int = 0) -> Request:
        """Queue a request. ``replay``: the prompt's last ``replay``
        tokens were already streamed (a migrated continuation, the
        Router's); they are replayed through decode passes and not
        emitted again."""
        req = self._new_request(prompt, max_new_tokens, temperature, seed,
                                eos_id, on_token, tenant, replay)
        self.metrics.inc("serve_submitted")
        self._tc(req.tenant)["submitted"] += 1
        if self.queue_limit and len(self.sched.queue) >= self.queue_limit:
            # Bounded queue: shed at the door. With tenant classes the
            # lowest class goes first: an arriving request that strictly
            # outranks the lowest-weight queued one (newest among ties)
            # evicts it instead.
            victim = req
            if self.tenants:
                lowest = min(
                    self.sched.queue,
                    key=lambda r: (self._weight(tenant_of(r)), -r.rid),
                    default=None)
                if lowest is not None \
                        and self._weight(tenant_of(lowest)) \
                        < self._weight(req.tenant):
                    self.sched._remove_queued(lowest)
                    self._shed(lowest)
                    victim = None
            if victim is not None:
                self._shed(victim)
                return req
        self.sched.enqueue(req)
        return req

    def _weight(self, tenant: str) -> int:
        cls = self.tenants.get(tenant) if self.tenants else None
        return cls.weight if cls is not None else 1

    def _shed(self, req: Request) -> None:
        req.shed = True
        req.done = True
        req.finished_at = time.perf_counter()
        self.metrics.inc("serve_shed")
        self._tc(tenant_of(req))["shed"] += 1

    def _shed_expired(self) -> None:
        """A request still queued (no block held, no token emitted) past
        its deadline is dropped: the tighter of the global ``shed_ms``
        and its tenant class's ``deadline_ms`` (either 0 = off)."""
        if not self.shed_ms and not self.tenants:
            return
        now = time.perf_counter()
        expired = []
        for r in self.sched.queue:
            limits = [self.shed_ms]
            if self.tenants:
                cls = self.tenants.get(tenant_of(r))
                limits.append(cls.deadline_ms if cls is not None else 0.0)
            limits = [m for m in limits if m > 0]
            if limits and (now - r.submitted_at) * 1e3 > min(limits):
                expired.append(r)
        for r in expired:
            self.sched._remove_queued(r)
            self._shed(r)

    def cancel(self, req: Request) -> bool:
        """Drop a queued or live request; frees its blocks. Returns
        whether there was anything to cancel."""
        if req.done:
            return False
        if any(r is req for r in self.sched.queue):
            self.sched._remove_queued(req)
        else:
            for i, s in enumerate(self.sched.slots):
                if s is not None and s.request is req:
                    self.sched.retire(i)
                    break
            else:
                return False
        req.cancelled = True
        req.done = True
        req.finished_at = time.perf_counter()
        self.metrics.inc("serve_cancelled")
        self._tc(tenant_of(req))["cancelled"] += 1
        return True

    # ---- the iteration -------------------------------------------------

    def step(self) -> bool:
        """One engine iteration: shed expired requests, admit, prefill,
        then one decode step (or speculative window) over the bank.
        Returns whether any work ran.

        Prefill budget: one chunk per step at ``spec_k == 0``,
        ``spec_k + 1`` when speculating — a speculative step retires up
        to ``spec_k + 1`` tokens per slot, so one chunk per step would
        let slots empty faster than they refill."""
        self._step_n += 1
        if self.chaos is not None:
            # May raise ReplicaCrashError, before any state changes.
            self.chaos.replica_step(self._step_n)
        self._shed_expired()
        admitted = self.sched.admit()
        self.metrics.inc("serve_admitted", len(admitted))
        did = False
        for _ in range(self.spec_k + 1 if self.spec_k > 0 else 1):
            pi = self.sched.prefill_slot()
            if pi is None:
                break
            did = True
            self._run_prefill_chunk(pi)
        dslots = self.sched.decode_slots()
        if dslots:
            did = True
            self.metrics.inc("serve_decode_steps")
            if self.spec_k > 0:
                # A migrated continuation's streamed tokens are fed one
                # per pass, as they were sampled: its rows take a k=0
                # pass of their own, and the other rows speculate.
                replaying = [i for i in dslots if self.sched.slots[i].replay]
                if replaying:
                    self._run_decode_step(replaying)
                    dslots = [i for i in dslots if i not in replaying]
                if dslots and self._spec_kind == "chain":
                    self._run_chain_step(dslots)
                elif dslots:
                    self._run_spec_step(dslots)
            else:
                self._run_decode_step(dslots)
        self.metrics.observe("serve_queue_depth", len(self.sched.queue))
        self.metrics.observe("serve_slot_occupancy",
                             self.sched.live / self.num_slots)
        return did or bool(admitted)

    def run(self, max_steps: int | None = None) -> int:
        """Step until idle (queue drained, all slots free) or
        ``max_steps``. Returns the number of steps taken."""
        n = 0
        while max_steps is None or n < max_steps:
            if not self.step():
                break
            n += 1
        return n

    def swap_params(self, params, version: int) -> None:
        """Flip the served weights to ``params`` at ``version`` between
        steps; under int8 the decode dict is re-quantized from them."""
        self.params = self._fp_params(params)
        self.param_version = int(version)
        self._refresh_quant(params)

    # ---- queries -------------------------------------------------------

    def outstanding(self) -> int:
        """Tokens of work still owed (queued + live)."""
        return sum(self.outstanding_by_tenant().values())

    def outstanding_by_tenant(self) -> dict[str, int]:
        """:meth:`outstanding` partitioned by tenant, computed live from
        the queue and the slots."""
        out: dict[str, int] = {}
        for r in self.sched.queue:
            t = tenant_of(r)
            out[t] = out.get(t, 0) + len(r.prompt) + r.max_new_tokens
        for s in self.sched.slots:
            if s is not None:
                t = tenant_of(s.request)
                out[t] = out.get(t, 0) + s.owed
        return out

    def prefix_cached_len(self, prompt, tenant: str = "default") -> int:
        """Prompt tokens this engine's prefix cache already holds within
        the tenant's namespace (0 without a cache)."""
        if self.prefix is None:
            return 0
        return self.prefix.cached_len(
            np.asarray(prompt, np.int64).reshape(-1), ns=tenant)

    def accounting_ok(self) -> bool:
        return self.sched.accounting_ok()

    def _tenant_in_flight(self, tenant: str) -> int:
        n = sum(tenant_of(r) == tenant for r in self.sched.queue)
        n += sum(s is not None and tenant_of(s.request) == tenant
                 for s in self.sched.slots)
        return n

    def tenant_accounting_ok(self) -> bool:
        """completed + cancelled + shed + in-flight == submitted on this
        engine, for every tenant ever seen."""
        for t, c in self.tenant_counts.items():
            if c["completed"] + c["cancelled"] + c["shed"] \
                    + self._tenant_in_flight(t) != c["submitted"]:
                return False
        return True

    def tenant_stats(self) -> dict[str, dict]:
        """Per-tenant ledger and live load."""
        live = self.outstanding_by_tenant()
        return {t: dict(c, outstanding=live.get(t, 0))
                for t, c in sorted(self.tenant_counts.items())}

    def spec_stats(self) -> dict:
        """The speculation ledger: knob settings, proposal totals with
        ``proposed == accepted + rejected``, and the acceptance rate
        (None before any proposal)."""
        p = self.spec_proposed
        return {"spec_k": self.spec_k, "spec_draft": self.spec_draft,
                "decode_quant": self.decode_quant,
                "proposed": p, "accepted": self.spec_accepted,
                "rejected": self.spec_rejected,
                "acceptance": (self.spec_accepted / p) if p else None}

    def drain(self) -> list[Request]:
        """Harvest every unfinished request and release all engine state
        (slots retire, pages free, the queue clears). Returns the
        harvested requests in submit order; each debits its tenant's
        ``submitted`` here, since it moves elsewhere."""
        reqs = []
        for i, s in enumerate(self.sched.slots):
            if s is not None:
                reqs.append(s.request)
                self.sched.retire(i)
        reqs.extend(self.sched.queue)
        self.sched.queue.clear()
        harvested = sorted((r for r in reqs if not r.done),
                           key=lambda r: r.rid)
        for r in harvested:
            self._tc(tenant_of(r))["submitted"] -= 1
        return harvested

    # ---- internals -----------------------------------------------------

    def _run_prefill_chunk(self, pi: int) -> None:
        s = self.sched.slots[pi]
        req = s.request
        plen = prefill_len(req)
        start, C = s.prefill_done, self.prefill_chunk
        chunk = np.zeros((1, C), np.int64)
        piece = req.prompt[start:min(start + C, plen)]
        chunk[0, :piece.size] = piece
        args = (self._tensor(chunk), start, plen,
                self._tensor([req.temperature], torch.float32),
                self._tensor([req.seed]))
        if self.pool.tiers > 1:
            # This chunk's target blocks must be hot (the writes address
            # hot slots); earlier chunks' pages may be cold and are read
            # through the dequant.
            from tpu_ddp_torch.serve.long_context import tiered_prefill_chunk
            lastpos = min(start + C, plen) - 1
            targets = s.blocks[start // self.block_size:
                               lastpos // self.block_size + 1]
            self.pool.ensure_device(s.blocks)
            self.pool.ensure_hot(targets, keep=s.blocks)
            ht, ct = self.pool.slot_tables(s.blocks, self.blocks_per_seq)
            tok, lp = tiered_prefill_chunk(
                self.model, self.pool, self._decode_params,
                self._tensor(ht), self._tensor(ct), *args)
            k, v = self.pool.k, self.pool.v
        elif self.cp_prefill != "off":
            from tpu_ddp_torch.serve.long_context import cp_prefill_step
            k, v, tok, lp = cp_prefill_step(
                self.model, self.block_size, self._decode_params,
                self.pool.k, self.pool.v, self._tensor(self._table_for(s)),
                *args, mode=self.cp_prefill, group=self.sp_group)
        else:
            k, v, tok, lp = prefill_chunk(
                self.model, self.block_size, self._decode_params,
                self.pool.k, self.pool.v, self._tensor(self._table_for(s)),
                *args)
        self.pool.commit(k, v)
        self.metrics.inc("serve_prefill_chunks")
        s.prefill_done = min(start + C, plen)
        s.length = s.prefill_done
        if s.prefill_done >= plen:
            # Register before emitting: _emit may retire the slot
            # (max_new_tokens == 1), and the index must take its holder
            # refs while the blocks are still live.
            if self.prefix is not None:
                self.prefix.register(req.prompt[:plen], s.blocks,
                                     ns=tenant_of(req))
            s.phase = "decode"
            self._emit(pi, int(tok), float(lp))  # the first token

    def _tiered_tables(self, dslots, hot_set):
        """Residency before tables (tiers > 1): every live slot's blocks
        on the device, the blocks each slot writes this step (``hot_set``
        of the slot) hot in one batched call so no slot's frontier evicts
        another's; then the (S, BPS) hot and cold slot tables."""
        S, BPS = self.num_slots, self.blocks_per_seq
        allblocks, hot = [], []
        for i in dslots:
            s = self.sched.slots[i]
            allblocks.extend(s.blocks)
            hot.extend(hot_set(s))
        self.pool.ensure_device(allblocks)
        self.pool.ensure_hot(hot, keep=allblocks)
        ht = np.zeros((S, BPS), np.int64)
        ct = np.zeros((S, BPS), np.int64)
        for i in dslots:
            ht[i], ct[i] = self.pool.slot_tables(self.sched.slots[i].blocks,
                                                 BPS)
        return self._tensor(ht), self._tensor(ct)

    def _run_decode_step(self, dslots: list[int]) -> None:
        if self.pool.tiers > 1:
            from tpu_ddp_torch.serve.long_context import tiered_decode_bank
            self._maybe_poison(dslots)
            for i in dslots:
                self.sched.ensure_block(i)
            bs = self.block_size
            tables, cold = self._tiered_tables(
                dslots, lambda s: [s.blocks[s.length // bs]])
            toks, lps, bad = tiered_decode_bank(
                self.model, self.pool, self._decode_params, tables, cold,
                *self._slot_rows(dslots))
        else:
            inputs = self.bank_inputs(dslots)
            self._maybe_poison(dslots)
            _, _, toks, lps, bad = decode_bank(
                self.model, self.block_size, self._decode_params,
                self.pool.k, self.pool.v, *inputs)
        self.metrics.inc("serve_target_passes")
        self._harvest(dslots, toks.cpu().numpy(), lps.cpu().numpy(),
                      bad.cpu().numpy())

    def _run_chain_step(self, dslots: list[int]) -> None:
        """The "chain" speculative schedule: one engine step runs
        ``spec_k + 1`` passes of the same :func:`decode_bank` the k=0
        engine runs, each column feeding the token the previous column
        sampled — on the device, with no host sync inside the window.
        Every emitted sample comes from the same computation on the same
        inputs as the one-token step, so the (token, logprob) stream
        equals the k=0 stream bit for bit. What it buys: batch assembly,
        the host round trip and the output copy are paid once per window
        instead of once per token.

        A slot past its ``max_new_tokens`` budget is frozen to the idle
        pattern (zero table row, length and token 0: its writes land in
        the null block), which also caps every write inside the blocks
        ``ensure_blocks`` allocated. EOS and non-finite truncation are
        not predictable: their tail columns compute discarded values into
        the slot's own blocks beyond its final length (causally masked,
        freed at retire, scrubbed on quarantine), and the harvest stops
        at the EOS or bad column as the one-token schedule would.
        Acceptance is 1 by construction; the ledger counts each emitted
        non-first column as an accepted proposal (rejected on a
        quarantine column)."""
        S, W = self.num_slots, self.spec_k + 1
        tiered = self.pool.tiers > 1
        if tiered:
            self._maybe_poison(dslots)
        for i in dslots:
            self.sched.ensure_blocks(i, W)
        remaining = np.zeros(S, np.int64)
        for i in dslots:
            s = self.sched.slots[i]
            remaining[i] = s.request.max_new_tokens - s.generated
        d_lengths, d_last, d_temps, d_seeds = self._slot_rows(dslots)
        if tiered:
            # The whole write window must be hot (the columns write with
            # tables fixed for the window); older pages may be cold.
            from tpu_ddp_torch.serve.long_context import tiered_view
            bs = self.block_size
            d_tables, d_cold = self._tiered_tables(
                dslots, lambda s: s.blocks[s.length // bs:])
        else:
            tables = np.zeros((S, self.blocks_per_seq), np.int64)
            for i in dslots:
                tables[i] = self._table_for(self.sched.slots[i])
            d_tables = self._tensor(tables)
            self._maybe_poison(dslots)
        active = np.arange(W)[:, None] < remaining[None, :]  # (W, S)
        full = active[:, dslots].all(axis=1)                 # (W,)
        cols = []
        pk, pv = self.pool.k, self.pool.v
        ncols = int(active.any(axis=1).sum())  # drop an all-frozen tail
        for c in range(ncols):
            if c:
                if full[c]:
                    d_lengths = d_lengths + 1
                    d_last = cols[-1][0]
                else:
                    act = self._tensor(active[c], torch.bool)
                    zero = torch.zeros_like(d_lengths)
                    d_tables = torch.where(act[:, None], d_tables, 0)
                    if tiered:
                        d_cold = torch.where(act[:, None], d_cold, 0)
                    d_lengths = torch.where(act, d_lengths + 1, zero)
                    d_last = torch.where(act, cols[-1][0], zero)
            view = tiered_view(self.pool, d_tables, d_cold) if tiered \
                else None
            pk, pv, toks, lps, bad = decode_bank(
                self.model, self.block_size, self._decode_params, pk, pv,
                d_tables, d_lengths, d_last, d_temps, d_seeds, view=view)
            cols.append((toks, lps, bad))
        self.pool.commit(pk, pv)
        self.metrics.inc("serve_target_passes", ncols)
        toks = torch.stack([t for t, _, _ in cols]).cpu().numpy()
        lps = torch.stack([lp for _, lp, _ in cols]).cpu().numpy()
        bad = torch.stack([b for _, _, b in cols]).cpu().numpy()
        live = set(dslots)
        for c in range(ncols):
            for i in sorted(live):
                if not active[c, i]:
                    continue
                s = self.sched.slots[i]
                req = s.request
                if c > 0:
                    req.spec_proposed += 1
                    self.spec_proposed += 1
                if bad[c, i]:
                    if c > 0:
                        req.spec_rejected += 1
                        self.spec_rejected += 1
                    self._quarantine(i)
                    live.discard(i)
                    continue
                if c > 0:
                    req.spec_accepted += 1
                    self.spec_accepted += 1
                s.length += 1
                self._emit(i, int(toks[c, i]), float(lps[c, i]))
                if req.done:
                    live.discard(i)

    def _run_spec_step(self, dslots: list[int]) -> None:
        """The fused draft+verify step ("self-<j>" / "quant"): the draft
        proposes ``spec_k`` tokens per slot and the target verifies all
        ``spec_k + 1`` columns (speculative.spec_step), then the host
        emits the longest prefix of target samples whose inputs the draft
        guessed right (accept_length — never a draft token). Rejected
        tail blocks go back to the pool through ``trim_blocks``.

        Tiered pools translate to all-hot: the draft and the verify
        address one buffer, so every block of a live slot is promoted
        first and the tables carry hot slot ids (a sequence's whole table
        must fit hot during its speculative step)."""
        S, BPS = self.num_slots, self.blocks_per_seq
        if self.pool.tiers > 1:
            self._maybe_poison(dslots)
        for i in dslots:
            self.sched.ensure_blocks(i, self.spec_k + 1)
        if self.pool.tiers > 1:
            allb = []
            for i in dslots:
                allb.extend(self.sched.slots[i].blocks)
            self.pool.ensure_hot(allb)
        tables = np.zeros((S, BPS), np.int64)
        limits = np.zeros(S, np.int64)
        for i in dslots:
            s = self.sched.slots[i]
            row = [self.pool.hot_slot(b) for b in s.blocks]
            tables[i, :len(row)] = row
            limits[i] = len(s.request.prompt) + s.request.max_new_tokens
        if self.pool.tiers == 1:
            self._maybe_poison(dslots)
        drafted, toks, lps, bad = spec_step(
            self.model, self.block_size, self._decode_params,
            self._draft_params, self.pool.k, self.pool.v,
            self._tensor(tables), *self._slot_rows(dslots),
            self._tensor(limits), self.spec_k, self.draft_layers)
        self.metrics.inc("serve_draft_passes", self.spec_k)
        self.metrics.inc("serve_target_passes", self.spec_k + 1)
        drafted, toks = drafted.cpu().numpy(), toks.cpu().numpy()
        lps, bad = lps.cpu().numpy(), bad.cpu().numpy()
        for i in dslots:
            s = self.sched.slots[i]
            req = s.request
            g = accept_length(drafted[i], toks[i], self.spec_k)
            req.spec_proposed += self.spec_k
            self.spec_proposed += self.spec_k
            emitted = 0
            quarantined = False
            for c in range(g + 1):
                if bad[i, c]:
                    quarantined = True
                    break
                s.length += 1
                self._emit(i, int(toks[i, c]), float(lps[i, c]))
                emitted += 1
                if req.done:
                    break
            acc = max(emitted - 1, 0)
            req.spec_accepted += acc
            self.spec_accepted += acc
            req.spec_rejected += self.spec_k - acc
            self.spec_rejected += self.spec_k - acc
            if quarantined:
                self._quarantine(i)
            elif not req.done:
                # KV rollback: free the tail blocks the rejected columns
                # over-allocated; garbage beyond ``length`` inside kept
                # blocks is causally masked and the next write at
                # ``length`` overwrites the frontier.
                self.sched.trim_blocks(i)


_MESH_REFUSAL = (
    "{arg}: the port serves tensor parallel one process per card; pass "
    "tp_group, the process group of the tp ranks (each process holding "
    "its own card), instead of a device mesh")


def _to_device(tree, device):
    """Move every tensor of a parameter dict to ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)


__all__ = ["Request", "ServeEngine", "bank_logits", "decode_bank",
           "prefill_chunk", "sample_bank", "write_slots"]
