"""The serving engine: request lifecycle over the paged KV pool and the
continuous-batching scheduler — the port of tpu_ddp/serve/engine.py
(single device, single-tier pool, FIFO admission, ``decode_quant`` none
or int8).

Each engine step runs two kinds of work, in PyTorch eager mode:

- **decode step** (:func:`decode_bank`) — one token for the ENTIRE slot
  bank. Idle slots ride along with zeroed block tables, so their writes
  land in the null block and their samples are discarded host-side. Per
  layer it is the shared decode core (models/decode.py) over a
  pool-gathered cache view — the math ``generate()`` runs over
  contiguous caches.
- **prefill chunk** (:func:`prefill_chunk`) — one ``prefill_chunk``-token
  slice of one prompt; short chunks are padded and padded positions
  write to the null block.

K/V of a position is written before it is attended, and everything
beyond a query's position gets an exact zero weight. Sampling is
stateless, keyed by (request seed, absolute position), so a request
reproduces its tokens whatever its batch neighbours.

Under ``decode_quant="int8"`` every projection and the LM head run the
weight-only int8 matmul (ops/quant_matmul.py): on the card, the Hopper
kernel — 4 launches per layer plus 1 for the head, per decode step and
per prefill chunk.
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

from tpu_ddp_torch.models.decode import (
    attend_cached,
    block_finish,
    check_decodable,
    project_qkv,
    sample_token,
)
from tpu_ddp_torch.ops.quant import DECODE_QUANTS
from tpu_ddp_torch.serve.kv_pool import PagedKVPool
from tpu_ddp_torch.serve.scheduler import Scheduler
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
    tokens: list = dataclasses.field(default_factory=list)
    logprobs: list = dataclasses.field(default_factory=list)
    token_versions: list = dataclasses.field(default_factory=list)
    done: bool = False
    cancelled: bool = False
    quarantined: bool = False   # non-finite logits: request isolated
    submitted_at: float = 0.0
    first_token_at: float | None = None
    finished_at: float | None = None

    @property
    def ttft_s(self) -> float | None:
        """Time to first token (seconds since submit), once known."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at


def _view(pool_buf, tables, block_size):
    """Gather one layer's pages for ``tables`` (S, BPS) into a
    contiguous (S, BPS * block_size, KV, hd) cache view."""
    s, bps = tables.shape
    return pool_buf[tables].reshape(s, bps * block_size,
                                    *pool_buf.shape[2:])


@torch.no_grad()
def decode_logits(model, block_size: int, params, pool_k, pool_v, tables,
                  lengths, last_tokens):
    """The whole-bank decode forward: feed ``last_tokens`` (S,) at
    positions ``lengths`` (S,), writing their K/V into the pool in place
    through ``tables`` (S, BPS), and return the logits (S, V) f32."""
    cd = model.compute_dtype
    x = params["embed"][last_tokens[:, None]].to(cd)      # (S, 1, dm)
    pos = lengths[:, None]                                # (S, 1)
    bidx = torch.gather(tables, 1, (lengths // block_size)[:, None])[:, 0]
    off = lengths % block_size
    for li, blk in enumerate(params["blocks"]):
        q, k, v = project_qkv(model, blk, x, pos)
        pool_k[li].index_put_((bidx, off), k[:, 0].to(pool_k.dtype))
        pool_v[li].index_put_((bidx, off), v[:, 0].to(pool_v.dtype))
        o = attend_cached(model, q, _view(pool_k[li], tables, block_size),
                          _view(pool_v[li], tables, block_size), pos)
        x = block_finish(model, blk, x, o)
    return model.head_apply(params, x)[:, 0]              # (S, V)


def decode_bank(model, block_size: int, params, pool_k, pool_v, tables,
                lengths, last_tokens, temps, seeds):
    """One token for every slot of the bank: :func:`decode_logits` then
    sampling at position ``lengths + 1``. Returns (pool_k, pool_v,
    tokens, logprobs, bad), where ``bad`` flags a slot whose logits or
    sampled logprob are non-finite, so the host quarantines exactly that
    request."""
    logits = decode_logits(model, block_size, params, pool_k, pool_v,
                           tables, lengths, last_tokens)
    toks, lps = sample_token(model, logits, temps, seeds, lengths + 1)
    bad = ~(torch.isfinite(logits).all(dim=-1) & torch.isfinite(lps))
    return pool_k, pool_v, toks, lps, bad


@torch.no_grad()
def prefill_chunk(model, block_size: int, params, pool_k, pool_v, table,
                  tokens, start: int, prompt_len: int, temp, seed):
    """One prefill chunk of one slot. ``tokens`` (1, C) is the chunk
    (zero-padded past the prompt) at positions ``start..start+C-1``;
    positions >= ``prompt_len`` write to the null block and never
    influence a valid query. ``table`` is the slot's (BPS,) block table.
    The sampled (token, logprob) at position ``prompt_len``, from the
    logits of position ``prompt_len - 1``, is meaningful only on the
    final chunk. Returns (pool_k, pool_v, token, logprob)."""
    cd = model.compute_dtype
    C = tokens.shape[1]
    bps = table.shape[0]
    p = start + torch.arange(C, device=tokens.device)     # (C,)
    safe = torch.clamp(p // block_size, 0, bps - 1)
    blk_idx = torch.where(p < prompt_len, table[safe],
                          torch.zeros_like(safe) + PagedKVPool.NULL_BLOCK)
    off = p % block_size
    x = params["embed"][tokens].to(cd)                    # (1, C, dm)
    for li, blkp in enumerate(params["blocks"]):
        q, k, v = project_qkv(model, blkp, x, p)
        pool_k[li].index_put_((blk_idx, off), k[0].to(pool_k.dtype))
        pool_v[li].index_put_((blk_idx, off), v[0].to(pool_v.dtype))
        o = attend_cached(model, q, _view(pool_k[li], table[None],
                                          block_size),
                          _view(pool_v[li], table[None], block_size), p)
        x = block_finish(model, blkp, x, o)
    logits = model.head_apply(params, x)[0]               # (C, V)
    last = min(max(prompt_len - 1 - start, 0), C - 1)
    pos = torch.full((1,), prompt_len, dtype=torch.int64,
                     device=tokens.device)
    tok, lp = sample_token(model, logits[last:last + 1], temp, seed, pos)
    return pool_k, pool_v, tok[0], lp[0]


class ServeEngine:
    """Continuous-batching serving over one dense TransformerLM.

    Knob defaults come from ``TrainConfig`` (``TPU_DDP_SERVE_SLOTS``,
    ``TPU_DDP_SERVE_BLOCK``, ``TPU_DDP_SERVE_PREFILL_CHUNK``,
    ``TPU_DDP_SERVE_CACHE_DTYPE``, ``TPU_DDP_DECODE_QUANT``); explicit
    arguments win. ``num_blocks`` defaults to a pool big enough that
    every slot can hold a ``max_seq_len`` sequence. ``device=None``
    means ``"cuda"``; the CPU must be asked for with ``device="cpu"``.
    """

    def __init__(self, model, params, *, num_slots: int | None = None,
                 block_size: int | None = None,
                 prefill_chunk: int | None = None,
                 num_blocks: int | None = None,
                 cache_dtype: str | None = None,
                 mode: str = "continuous",
                 decode_quant: str | None = None,
                 metrics: MetricsLogger | None = None,
                 config=None, device=None):
        check_decodable(model)
        self.device = resolve_device(device)
        if config is None:
            from tpu_ddp_torch.utils.config import TrainConfig
            config = TrainConfig()
        self.model = model
        self.params = _to_device(params, self.device)
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
        self.pool = PagedKVPool(model, num_blocks, self.block_size,
                                cache_dtype, device=self.device)
        self.sched = Scheduler(self.pool, self.num_slots, mode)
        self.metrics = metrics if metrics is not None else MetricsLogger()
        self.decode_quant = str(decode_quant if decode_quant is not None
                                else config.decode_quant)
        if self.decode_quant not in DECODE_QUANTS:
            raise ValueError(
                f"decode_quant={self.decode_quant!r}: expected 'none'"
                " or 'int8' (TPU_DDP_DECODE_QUANT)")
        self._refresh_quant()
        self._rid = itertools.count()
        self.config = config
        self._step_n = 0
        self.param_version = 0

    def _refresh_quant(self) -> None:
        """(Re)derive the decode-path parameter dict from the fp master
        ``self.params`` — at construction and after every
        :meth:`swap_params`. ``self._decode_params`` feeds every step:
        the fp dict under ``decode_quant == "none"``, the per-channel
        int8 dict (ops/quant.py quantize_params) under ``"int8"``."""
        if self.decode_quant == "int8":
            from tpu_ddp_torch.ops.quant import quantize_params
            self._decode_params = quantize_params(self.model, self.params)
        else:
            self._decode_params = self.params

    # ---- request lifecycle ---------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               temperature: float = 0.0, seed: int = 0,
               eos_id: int | None = None,
               on_token: Callable[[int], None] | None = None) -> Request:
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
        req = Request(rid=next(self._rid), prompt=prompt,
                      max_new_tokens=int(max_new_tokens),
                      temperature=float(temperature), seed=int(seed),
                      eos_id=eos_id, on_token=on_token,
                      submitted_at=time.perf_counter())
        self.sched.enqueue(req)
        self.metrics.inc("serve_submitted")
        return req

    def cancel(self, req: Request) -> bool:
        """Drop a queued or live request; frees its blocks. Returns
        whether there was anything to cancel."""
        if req.done:
            return False
        if req in self.sched.queue:
            self.sched.queue.remove(req)
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
        return True

    # ---- the iteration -------------------------------------------------

    def step(self) -> bool:
        """One engine iteration: admit, at most one prefill chunk, one
        whole-bank decode step. Returns whether any work ran."""
        self._step_n += 1
        admitted = self.sched.admit()
        self.metrics.inc("serve_admitted", len(admitted))
        did = False
        pi = self.sched.prefill_slot()
        if pi is not None:
            did = True
            self._run_prefill_chunk(pi)
        dslots = self.sched.decode_slots()
        if dslots:
            did = True
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
        self.params = _to_device(params, self.device)
        self.param_version = int(version)
        self._refresh_quant()

    def accounting_ok(self) -> bool:
        return self.sched.accounting_ok()

    # ---- internals -----------------------------------------------------

    def _table_for(self, slot) -> np.ndarray:
        t = np.zeros(self.blocks_per_seq, np.int64)
        t[:len(slot.blocks)] = slot.blocks
        return t

    def _tensor(self, a, dtype=torch.int64):
        return torch.as_tensor(a, dtype=dtype).to(self.device)

    def _run_prefill_chunk(self, pi: int) -> None:
        s = self.sched.slots[pi]
        req = s.request
        start, C = s.prefill_done, self.prefill_chunk
        chunk = np.zeros((1, C), np.int64)
        piece = req.prompt[start:start + C]
        chunk[0, :piece.size] = piece
        k, v, tok, lp = prefill_chunk(
            self.model, self.block_size, self._decode_params,
            self.pool.k, self.pool.v, self._tensor(self._table_for(s)),
            self._tensor(chunk), start, int(req.prompt.size),
            self._tensor([req.temperature], torch.float32),
            self._tensor([req.seed]))
        self.pool.commit(k, v)
        self.metrics.inc("serve_prefill_chunks")
        s.prefill_done = min(start + C, int(req.prompt.size))
        s.length = s.prefill_done
        if s.prefill_done >= req.prompt.size:
            s.phase = "decode"
            self._emit(pi, int(tok), float(lp))  # the first token

    def bank_inputs(self, dslots: list[int]):
        """The decode step's inputs for the live slots ``dslots`` —
        (tables, lengths, last_tokens, temps, seeds) on the device —
        after growing each slot's table to cover its next write. Idle
        rows keep zero tables, lengths and tokens."""
        S, BPS = self.num_slots, self.blocks_per_seq
        tables = np.zeros((S, BPS), np.int64)
        lengths = np.zeros(S, np.int64)
        last = np.zeros(S, np.int64)
        temps = np.zeros(S, np.float32)
        seeds = np.zeros(S, np.int64)
        for i in dslots:
            self.sched.ensure_block(i)
            s = self.sched.slots[i]
            tables[i] = self._table_for(s)
            lengths[i] = s.length
            last[i] = s.pending_token
            temps[i] = s.request.temperature
            seeds[i] = s.request.seed
        return (self._tensor(tables), self._tensor(lengths),
                self._tensor(last), self._tensor(temps, torch.float32),
                self._tensor(seeds))

    def _run_decode_step(self, dslots: list[int]) -> None:
        tables, lengths, last, temps, seeds = self.bank_inputs(dslots)
        k, v, toks, lps, bad = decode_bank(
            self.model, self.block_size, self._decode_params,
            self.pool.k, self.pool.v, tables, lengths, last, temps, seeds)
        self.pool.commit(k, v)
        self.metrics.inc("serve_decode_steps")
        toks, lps, bad = toks.cpu().numpy(), lps.cpu().numpy(), \
            bad.cpu().numpy()
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
        warnings.warn(
            f"request {req.rid}: non-finite logits at engine step "
            f"{self._step_n}; request quarantined, pages scrubbed",
            stacklevel=3)

    def _emit(self, idx: int, tok: int, logprob: float) -> None:
        """Record one sampled token for slot ``idx``'s request: stream
        it, stamp TTFT on the first, retire on max_new_tokens/EOS."""
        s = self.sched.slots[idx]
        req = s.request
        s.generated += 1
        s.pending_token = tok
        req.tokens.append(tok)
        req.logprobs.append(logprob)
        req.token_versions.append(self.param_version)
        now = time.perf_counter()
        if req.first_token_at is None:
            req.first_token_at = now
            self.metrics.observe("serve_ttft_ms",
                                 (now - req.submitted_at) * 1e3)
        if req.on_token is not None:
            req.on_token(tok)
        if s.generated >= req.max_new_tokens \
                or (req.eos_id is not None and tok == req.eos_id):
            req.done = True
            req.finished_at = now
            self.sched.retire(idx)
            self.metrics.inc("serve_retired")


def _to_device(tree, device):
    """Move every tensor of a parameter dict to ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)


__all__ = ["Request", "ServeEngine", "decode_bank", "decode_logits",
           "prefill_chunk"]
