"""Prefill/decode disaggregation (tpu_ddp/fleet/disagg.py): two engine
roles and one explicit KV edge.

In the single engine a prefill chunk and the whole-bank decode step share
one host loop, so a burst of long prompts takes engine steps from live
decodes. Here prefill runs on its own role, whose pool only ever holds
prompts, and each finished prompt's KV blocks travel to the decode role
over an explicit edge (the DistServe / Splitwise split).

- **The edge** rides :class:`~tpu_ddp_torch.parallel.compress.EdgeCodec`
  (``kv_wire``: ``none``, ``bf16`` or ``int8``, the last as ``int8-noef``:
  each transfer is an independent payload, with no trajectory for an
  error-feedback residual to follow). The garbage tail of a prompt's last
  block is zeroed before encoding, so stale values never reach the int8
  block scales. The payload stays on the device: nothing crosses to the
  host per prompt.
- **Adoption** is an explicit landing: the decode pool allocates fresh
  block ids, the decoded payload is written into them on the compute
  stream, then the same :func:`~tpu_ddp_torch.serve.engine.decode_bank`
  the engine runs steps the live bank, and the request's slot starts in
  the decode phase (``Scheduler.place``). The landing comes before the
  bank, the order of JAX's fused program; the adopted ids are in no live
  table this step, so the decode math is untouched. (JAX lets XLA's
  scheduler hide the landing behind decode compute; here it runs first,
  in order.)
- **Sampling** stays stateless, keyed by (seed, position), on both roles:
  with ``kv_wire="none"`` the tokens are the single engine's bit for bit.
  The lossy wires round the shipped KV (a bf16 wire is exact on a bf16
  cache).
- **Degraded mode.** A transfer lost on the edge (``edge-drop``), or the
  prefill role dying outright, must not wedge the pipeline: a one-slot
  fallback scheduler (``dsched``) over the decode pool re-runs the lost
  prompt's prefill there, chunked, with the same
  :func:`~tpu_ddp_torch.serve.engine.prefill_chunk`, so the degraded
  output equals the healthy output token for token. A dead prefill role
  sets ``prefill_degraded``: every prompt it owned (mid-prefill, queued,
  on the edge) replays locally, and later submits skip it. A CUDA error
  or a kernel's failure (``fleet.resilience.device_fault``) is no role's
  death: it is re-raised.
- **Migrated continuations** (``submit(replay=...)``, the Router's): the
  prefill role prefills the original prompt, and the decode role feeds
  the tokens already streamed through its passes before it emits.

``decode_quant="int8"`` applies to both roles from one quantized tree:
every prefill chunk, degraded chunk and decode pass runs the int8 matmul.
The counters ``serve_prefill_chunks`` (the prefill role),
``fleet_degraded_chunks`` and ``serve_target_passes`` (decode passes,
landings included) give its launch count. Speculation does not run here
(tune/space.py refuses ``spec_k > 0`` with ``fleet_roles="disagg"``).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
import warnings
from collections import deque
from typing import Callable

import numpy as np
import torch

from tpu_ddp_torch.fleet.resilience import device_fault
from tpu_ddp_torch.models.decode import check_decodable
from tpu_ddp_torch.ops.quant import DECODE_QUANTS
from tpu_ddp_torch.parallel.compress import EdgeCodec
from tpu_ddp_torch.serve.engine import (DecodeRole, Request, _to_device,
                                        decode_bank)
from tpu_ddp_torch.serve.engine import prefill_chunk as chunk_step
from tpu_ddp_torch.serve.kv_pool import PagedKVPool
from tpu_ddp_torch.serve.scheduler import (Scheduler, parse_tenant_classes,
                                           prefill_len, tenant_of)
from tpu_ddp_torch.utils.device import resolve_device
from tpu_ddp_torch.utils.metrics import MetricsLogger

KV_WIRES = ("none", "bf16", "int8")


@dataclasses.dataclass(eq=False)
class KVTransfer:
    """One finished prefill in flight on the edge: the encoded KV blocks
    and the last-token state the decode role resumes from."""

    request: Request
    wire_k: dict
    wire_v: dict
    n_blocks: int
    length: int          # prompt tokens (valid cache positions)
    pending_token: int   # the first sampled token, already emitted
    nbytes: int          # wire payload bytes (both tensors)
    replay: int = 0      # replayed tokens the decode role still drops


class KVEdge:
    """The prefill -> decode edge: a FIFO of encoded transfers, with one
    :class:`EdgeCodec` giving the wire format and the byte accounting
    (``bytes_sent`` / ``ratio``)."""

    def __init__(self, wire: str = "none"):
        if wire not in KV_WIRES:
            raise ValueError(f"kv_wire={wire!r}: expected "
                             "none|bf16|int8")
        self.wire = wire
        self.codec = EdgeCodec("int8-noef" if wire == "int8" else wire)
        self.queue: deque = deque()
        self.sent = 0
        self.delivered = 0
        self.dropped = 0

    def send(self, transfer: KVTransfer) -> None:
        self.queue.append(transfer)
        self.sent += 1

    def pop(self) -> KVTransfer:
        self.delivered += 1
        return self.queue.popleft()

    def drop(self, request: Request) -> bool:
        """Cancel support: remove the pending transfer of ``request``. Its
        blocks live only in the payload (the prefill role freed its
        copies), so dropping the transfer is the cleanup."""
        for t in self.queue:
            if t.request is request:
                self.queue.remove(t)
                self.dropped += 1
                return True
        return False

    def stats(self) -> dict:
        return {"wire": self.wire, "sent": self.sent,
                "delivered": self.delivered, "dropped": self.dropped,
                "pending": len(self.queue),
                "bytes_sent": self.codec.bytes_sent,
                "bytes_dense": self.codec.bytes_dense,
                "ratio": self.codec.ratio}


class DisaggEngine(DecodeRole):
    """A prefill role and a decode role behind the single-engine surface
    (``submit`` / ``cancel`` / ``step`` / ``run``), so the load generator
    and the Router drive it as they drive a ``ServeEngine``. The decode
    role shares the engine's request checks, bank inputs and harvest
    (:class:`~tpu_ddp_torch.serve.engine.DecodeRole`).

    One ``step()`` advances both roles once: admission and one prefill
    chunk on the prefill role (shipping when a prompt completes), then on
    the decode role at most one landing from the edge followed by the
    bank's decode pass, or the decode pass alone. ``device=None`` means
    ``"cuda"``; the CPU must be asked for with ``device="cpu"``.
    """

    def __init__(self, model, params, *,
                 num_slots: int | None = None,
                 block_size: int | None = None,
                 prefill_chunk: int | None = None,
                 num_blocks: int | None = None,
                 prefill_blocks: int | None = None,
                 cache_dtype: str | None = None,
                 kv_wire: str | None = None,
                 prefix_cache: bool | None = None,
                 queue_limit: int | None = None,
                 shed_ms: float | None = None,
                 tenant_classes: str | None = None,
                 decode_quant: str | None = None,
                 metrics: MetricsLogger | None = None,
                 config=None, device=None):
        check_decodable(model)
        from tpu_ddp_torch.utils.config import (TrainConfig,
                                                refuse_unported_env)
        refuse_unported_env()
        self.device = resolve_device(device)
        if config is None:
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
        self.blocks_per_seq = math.ceil(model.max_seq_len / self.block_size)
        cache_dtype = (cache_dtype if cache_dtype is not None
                       else config.serve_cache_dtype)
        if num_blocks is None:
            num_blocks = self.num_slots * self.blocks_per_seq + 1
        if prefill_blocks is None:
            # Two worst-case prompts (one prefilling, one admitted behind
            # it) plus prefix-cache residency.
            prefill_blocks = 2 * self.blocks_per_seq + 1
        # The decode role: every slot is placed after prefill.
        self.pool = PagedKVPool(model, num_blocks, self.block_size,
                                cache_dtype, device=self.device)
        self.sched = Scheduler(self.pool, self.num_slots, "continuous")
        # The prefill role: prompt-only reservations. The prefix index
        # lives here, since cached blocks must be in the pool the prefill
        # chunk gathers.
        self.prefill_pool = PagedKVPool(model, prefill_blocks,
                                        self.block_size, cache_dtype,
                                        device=self.device)
        self.prefix = None
        prefix_cache = (bool(prefix_cache) if prefix_cache is not None
                        else config.prefix_cache)
        if prefix_cache:
            from tpu_ddp_torch.fleet.prefix import PrefixIndex
            self.prefix = PrefixIndex(self.prefill_pool)
        # Tenant classes apply where requests wait: the prefill role's
        # queue. The degraded fallback queue is FIFO (liveness first).
        tc = (tenant_classes if tenant_classes is not None
              else config.tenant_classes)
        self.tenants = parse_tenant_classes(tc) or None
        self.psched = Scheduler(self.prefill_pool, 1, "continuous",
                                prefix=self.prefix, role="prefill",
                                tenants=self.tenants)
        # The degraded-mode fallback: one slot over the decode pool that
        # re-prefills lost transfers. It shares the decode pool, so the
        # two schedulers are reservation peers.
        self.dsched = Scheduler(self.pool, 1, "continuous")
        self.sched.peers = [self.dsched]
        self.dsched.peers = [self.sched]
        self.prefill_degraded = False
        self.edge = KVEdge(kv_wire if kv_wire is not None
                           else config.kv_wire)
        self.decode_quant = str(decode_quant if decode_quant is not None
                                else config.decode_quant)
        if self.decode_quant not in DECODE_QUANTS:
            raise ValueError(
                f"decode_quant={self.decode_quant!r}: expected 'none'"
                " or 'int8' (TPU_DDP_DECODE_QUANT)")
        self._refresh_quant()
        self.metrics = metrics if metrics is not None else MetricsLogger()
        # Both roles' chunk step (an attribute, so a drill can replace
        # the prefill role's with one that dies).
        self._prefill = chunk_step
        self._rid = itertools.count()
        self.tenant_counts: dict[str, dict[str, int]] = {}
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

    # ---- request lifecycle ---------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               temperature: float = 0.0, seed: int = 0,
               eos_id: int | None = None,
               on_token: Callable[[int], None] | None = None,
               tenant: str = "default", replay: int = 0) -> Request:
        """Queue a request (``replay``: see ``ServeEngine.submit``; the
        prefill role prefills the rest of the prompt, the decode role
        feeds the replayed tokens)."""
        req = self._new_request(prompt, max_new_tokens, temperature, seed,
                                eos_id, on_token, tenant, replay)
        # The decode side must be able to adopt it, or the transfer would
        # head-block the edge forever.
        dneed = self.sched.worst_case_blocks(req)
        if dneed > self.pool.total_usable:
            raise ValueError(
                f"request needs up to {dneed} decode KV blocks but "
                f"the decode pool holds only {self.pool.total_usable}")
        self.metrics.inc("serve_submitted")
        self._tc(req.tenant)["submitted"] += 1
        qlen = len(self.dsched.queue) if self.prefill_degraded \
            else len(self.psched.queue)
        if self.queue_limit and qlen >= self.queue_limit:
            self._shed(req)
            return req
        if self.prefill_degraded:
            self.dsched.enqueue(req)  # the prefill role is gone
        else:
            self.psched.enqueue(req)
        return req

    def _shed(self, req: Request) -> None:
        req.shed = True
        req.done = True
        req.finished_at = time.perf_counter()
        self.metrics.inc("serve_shed")
        self._tc(tenant_of(req))["shed"] += 1

    def _shed_expired(self) -> None:
        """Deadline shedding over both admission queues. Only a request
        that has produced no token is sheddable: a degraded replay of a
        lost transfer already streamed its first token."""
        if not self.shed_ms:
            return
        now = time.perf_counter()
        for q in (self.psched.queue, self.dsched.queue):
            expired = [r for r in q if not r.tokens
                       and (now - r.submitted_at) * 1e3 > self.shed_ms]
            for r in expired:
                q.remove(r)
                self._shed(r)

    def cancel(self, req: Request) -> bool:
        """Drop a request anywhere in the pipeline: queued, mid-prefill
        (frees the prefill pool's blocks), on the edge (drops the
        transfer) or decoding."""
        if req.done:
            return False
        if self.edge.drop(req):
            pass
        elif any(r is req for r in self.psched.queue):
            self.psched.queue.remove(req)
        elif any(r is req for r in self.dsched.queue):
            self.dsched.queue.remove(req)
        else:
            for sched in (self.psched, self.dsched, self.sched):
                i = next((i for i, s in enumerate(sched.slots)
                          if s is not None and s.request is req), None)
                if i is not None:
                    sched.retire(i)
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
        """One iteration: each role advances once. Degraded requests
        re-prefill on the decode role, one chunk per step, yielding to
        healthy prefill traffic."""
        self._step_n += 1
        if self.chaos is not None:
            # May raise ReplicaCrashError, before any state changes.
            self.chaos.replica_step(self._step_n)
        self._shed_expired()
        admitted = list(self.psched.admit())
        self._promote_degraded()
        admitted += self.dsched.admit()
        did = False

        pi = self.psched.prefill_slot()
        di = self.dsched.prefill_slot()
        if pi is not None:
            did = True
            try:
                self._run_prefill_chunk(pi)
            except Exception as e:  # noqa: BLE001 — degrade, don't wedge
                if device_fault(e):
                    raise  # the card's fault is every role's
                self._fail_prefill(e)
        elif di is not None:
            did = True
            self._run_degraded_chunk(di)

        transfer = self._pop_adoptable()
        dslots = self.sched.decode_slots()
        if transfer is not None:
            did = True
            self._land(transfer, dslots)
        elif dslots:
            did = True
            self._run_decode_step(dslots)

        self.metrics.observe("serve_queue_depth",
                             len(self.psched.queue) + len(self.dsched.queue))
        self.metrics.observe("serve_slot_occupancy",
                             self.sched.live / self.num_slots)
        return did or bool(admitted) or self.dsched.live > 0

    def run(self, max_steps: int | None = None) -> int:
        n = 0
        while max_steps is None or n < max_steps:
            if not self.step():
                break
            n += 1
        return n

    def swap_params(self, params, version: int) -> None:
        """Flip both roles' weights between steps: one tree feeds
        prefill, degraded prefill and decode."""
        self.params = _to_device(params, self.device)
        self.param_version = int(version)
        self._refresh_quant()

    def _refresh_quant(self) -> None:
        """(Re)derive the serving dict from the fp master ``self.params``,
        at construction and after every :meth:`swap_params`."""
        if self.decode_quant == "int8":
            from tpu_ddp_torch.ops.quant import quantize_params
            self._decode_params = quantize_params(self.model, self.params)
        else:
            self._decode_params = self.params

    def stats(self) -> dict:
        """The edge ledger, the quantization knob and the degraded flag
        (``speculative`` is always None: the decode role does not
        speculate)."""
        return {"edge": self.edge.stats(),
                "decode_quant": self.decode_quant,
                "prefill_degraded": self.prefill_degraded,
                "speculative": None}

    # ---- router hooks --------------------------------------------------

    def outstanding(self) -> int:
        return sum(self.outstanding_by_tenant().values())

    def prefix_cached_len(self, prompt, tenant: str = "default") -> int:
        if self.prefix is None:
            return 0
        return self.prefix.cached_len(
            np.asarray(prompt, np.int64).reshape(-1), ns=tenant)

    def outstanding_by_tenant(self) -> dict[str, int]:
        """Tokens owed per tenant, computed live over the queues, the edge
        and the slots, so a cancel leaves no ghost load."""
        out: dict[str, int] = {}

        def add(t, w):
            out[t] = out.get(t, 0) + w

        for q in (self.psched.queue, self.dsched.queue):
            for r in q:
                add(tenant_of(r),
                    len(r.prompt) + r.max_new_tokens - len(r.tokens))
        for t in self.edge.queue:
            add(tenant_of(t.request), t.replay
                + t.request.max_new_tokens - len(t.request.tokens))
        for sched in (self.psched, self.dsched, self.sched):
            for s in sched.slots:
                if s is not None:
                    add(tenant_of(s.request), s.owed)
        return out

    # ---- prefill role --------------------------------------------------

    def _chunk(self, pool, s, counter: str):
        """One prefill chunk of slot ``s`` against ``pool`` (either
        role's). Returns the sampled (token, logprob), meaningful on the
        final chunk."""
        req = s.request
        plen = prefill_len(req)
        start, C = s.prefill_done, self.prefill_chunk
        chunk = np.zeros((1, C), np.int64)
        piece = req.prompt[start:min(start + C, plen)]
        chunk[0, :piece.size] = piece
        dev = self.device
        k, v, tok, lp = self._prefill(
            self.model, self.block_size, self._decode_params, pool.k, pool.v,
            self._tensor(self._table_for(s)), self._tensor(chunk), start, plen,
            torch.tensor([req.temperature], dtype=torch.float32, device=dev),
            torch.tensor([req.seed], dtype=torch.int64, device=dev))
        pool.commit(k, v)
        self.metrics.inc(counter)
        s.prefill_done = min(start + C, plen)
        s.length = s.prefill_done
        return tok, lp

    def _run_prefill_chunk(self, pi: int) -> None:
        s = self.psched.slots[pi]
        tok, lp = self._chunk(self.prefill_pool, s, "serve_prefill_chunks")
        if s.prefill_done >= prefill_len(s.request):
            self._ship(pi, int(tok), float(lp))

    def _ship(self, pi: int, tok: int, lp: float) -> None:
        """Prefill finished: emit the first token (TTFT is prefill
        completion), encode the prompt's KV blocks onto the edge and hand
        the blocks back to the prefill pool (the payload is the copy in
        flight; the prefix index keeps its own references)."""
        s = self.psched.slots[pi]
        req = s.request
        plen = prefill_len(req)
        if s.take(tok) is not None:
            self._record(req, tok, lp)
        if not req.done:
            nb = len(s.blocks)
            kb, vb = self.prefill_pool.page_arrays(s.blocks)
            # (L, nb, bs, KV, hd). Zero the garbage tail: stale positions
            # would pollute the int8 block scales.
            valid = (torch.arange(nb * self.block_size, device=self.device)
                     < plen).reshape(nb, self.block_size)
            mask = valid[None, :, :, None, None]
            kb = torch.where(mask, kb, torch.zeros_like(kb))
            vb = torch.where(mask, vb, torch.zeros_like(vb))
            wire_k, n_k = self.edge.codec.encode(kb)
            wire_v, n_v = self.edge.codec.encode(vb)
            self.edge.send(KVTransfer(
                request=req, wire_k=wire_k, wire_v=wire_v, n_blocks=nb,
                length=plen, pending_token=s.pending_token,
                nbytes=n_k + n_v, replay=s.replay))
            self.metrics.inc("fleet_shipped")
            self.metrics.observe("fleet_wire_bytes", n_k + n_v)
        if self.prefix is not None:
            self.prefix.register(req.prompt[:plen], s.blocks,
                                 ns=tenant_of(req))
        self.psched.retire(pi)

    # ---- degraded mode -------------------------------------------------

    def _degrade(self, req: Request) -> None:
        """Queue ``req`` for local re-prefill on the decode role."""
        self.dsched.enqueue(req)
        self.metrics.inc("fleet_degraded")

    def _fail_prefill(self, exc: Exception) -> None:
        """The prefill role died mid-chunk: reap everything it owned (its
        slot, its queue, every transfer on the edge) and replay it through
        local chunked prefill. The prefill pool and the prefix index
        rooted in it die with the role; later submits go straight to the
        fallback."""
        warnings.warn(
            f"prefill worker failed ({type(exc).__name__}: {exc}); "
            "falling back to local chunked prefill on the decode "
            "worker", stacklevel=3)
        self.prefill_degraded = True
        self.metrics.inc("fleet_prefill_failures")
        harvested = []
        for i, s in enumerate(self.psched.slots):
            if s is not None:
                harvested.append(s.request)
                self.psched.retire(i)  # host bookkeeping; the pool is dead
        harvested.extend(self.psched.queue)
        self.psched.queue.clear()
        while self.edge.queue:
            t = self.edge.queue.popleft()
            self.edge.dropped += 1
            harvested.append(t.request)
        self.prefix = None  # rooted in the dead prefill pool
        for req in sorted(harvested, key=lambda r: r.rid):
            if not req.done:
                self._degrade(req)

    def _run_degraded_chunk(self, di: int) -> None:
        """One local prefill chunk against the decode pool: the same chunk
        step, so the recomputed KV and the first token are what the
        healthy path gives."""
        s = self.dsched.slots[di]
        req = s.request
        tok, lp = self._chunk(self.pool, s, "fleet_degraded_chunks")
        plen = prefill_len(req)
        if s.prefill_done >= plen:
            if s.take(tok) is None:
                pass  # a replayed token is fed on
            elif req.tokens:
                # An edge-drop re-prefill: the first token streamed at
                # ship time, and the recomputed sample (the same bits) is
                # dropped.
                s.pending_token = req.tokens[-1]
            else:
                # A prefill-death re-prefill never emitted its first token.
                self._record(req, s.pending_token, float(lp))
            s.phase = "decode"
            s.generated = len(req.tokens)
            if req.done:  # max_new_tokens == 1 or an instant EOS
                self.dsched.retire(di)

    def _promote_degraded(self) -> None:
        """Hand a locally re-prefilled sequence to the decode scheduler
        once it has a free slot: the blocks change owner (both schedulers
        draw on the decode pool) and the slot starts in the decode phase,
        as an adopted transfer does."""
        for i, s in enumerate(self.dsched.slots):
            if s is not None and s.phase == "decode" \
                    and self.sched.live < self.num_slots:
                st = self.dsched.release(i)
                self.sched.place(st.request, st.blocks, st.length,
                                 st.pending_token, st.replay)
                self.metrics.inc("fleet_degraded_promoted")

    # ---- decode role ---------------------------------------------------

    def _pop_adoptable(self) -> KVTransfer | None:
        """FIFO edge delivery, gated by the decode scheduler's
        reservation rule (a free slot and the whole worst case). A
        transfer lost in flight (``edge-drop``) degrades to local
        re-prefill."""
        if not self.edge.queue:
            return None
        if self.sched.live >= self.num_slots:
            return None
        t = self.edge.queue[0]
        need = self.sched.worst_case_blocks(t.request)
        if need > self.sched.pool_budget:
            return None
        t = self.edge.pop()
        if self.chaos is not None \
                and self.chaos.edge_drop_fires(self.edge.delivered):
            warnings.warn(
                f"KV transfer for request {t.request.rid} lost on the "
                "edge; re-prefilling locally on the decode worker",
                stacklevel=3)
            self.edge.dropped += 1
            self.metrics.inc("fleet_edge_failures")
            self._degrade(t.request)
            return None
        return t

    def _land(self, t: KVTransfer, dslots: list) -> None:
        """Adopt a transfer: write the decoded payload into fresh decode-
        pool ids, then (with a live bank) the decode pass, then place the
        slot."""
        ids = [self.pool.alloc() for _ in range(t.n_blocks)]
        idx = torch.as_tensor(ids, dtype=torch.int64).to(self.device)
        inputs = self.bank_inputs(dslots) if dslots else None
        for buf, wire in ((self.pool.k, t.wire_k), (self.pool.v, t.wire_v)):
            buf[:, idx] = EdgeCodec.decode(wire).to(buf.dtype)
        if dslots:
            self._decode(dslots, inputs)
        self.sched.place(t.request, ids, t.length, t.pending_token, t.replay)
        self.metrics.inc("fleet_adopted")

    def _run_decode_step(self, dslots: list) -> None:
        self._decode(dslots, self.bank_inputs(dslots))

    def _decode(self, dslots: list, inputs) -> None:
        """The bank's decode pass (chaos first), then the harvest."""
        self._maybe_poison(dslots)
        _, _, toks, lps, bad = decode_bank(
            self.model, self.block_size, self._decode_params, self.pool.k,
            self.pool.v, *inputs)
        self.metrics.inc("serve_target_passes")
        self._harvest(dslots, toks.cpu().numpy(), lps.cpu().numpy(),
                      bad.cpu().numpy())

    # ---- introspection -------------------------------------------------

    def accounting_ok(self) -> bool:
        """The decode pool's identity over both of its schedulers' holders,
        and the prefill pool's while its role lives."""
        holders = [s.blocks for s in self.sched.slots if s is not None]
        holders += [s.blocks for s in self.dsched.slots if s is not None]
        if not self.pool.refcount_ok(holders):
            return False
        return self.prefill_degraded or self.psched.accounting_ok()

    def drain(self) -> list[Request]:
        """Harvest every unfinished request from the whole pipeline
        (queues, prefill slot, edge, fallback, decode slots) and release
        all engine state: the Router's migration hook. Submit order."""
        reqs = list(self.psched.queue)
        self.psched.queue.clear()
        reqs.extend(self.dsched.queue)
        self.dsched.queue.clear()
        for sched in (self.psched, self.dsched, self.sched):
            for i, s in enumerate(sched.slots):
                if s is not None:
                    reqs.append(s.request)
                    sched.retire(i)
        while self.edge.queue:
            t = self.edge.queue.popleft()
            self.edge.dropped += 1
            reqs.append(t.request)
        harvested = sorted((r for r in reqs if not r.done),
                           key=lambda r: r.rid)
        for r in harvested:  # they move elsewhere (as ServeEngine.drain)
            self._tc(tenant_of(r))["submitted"] -= 1
        return harvested

    def lower_adopt_decode(self, n_blocks: int = 2):
        """JAX's HLO of the fused adopt+decode program: ROADMAP item 12."""
        raise NotImplementedError(_HLO_REFUSAL.format(
            what="lower_adopt_decode"))

    def adopt_decode_hlo(self, n_blocks: int = 2) -> str:
        """JAX's compiled HLO of the landing: ROADMAP item 12."""
        raise NotImplementedError(_HLO_REFUSAL.format(
            what="adopt_decode_hlo"))

    def lower_degraded_prefill(self):
        """JAX's HLO of the degraded prefill: ROADMAP item 12."""
        raise NotImplementedError(_HLO_REFUSAL.format(
            what="lower_degraded_prefill"))


_HLO_REFUSAL = (
    "DisaggEngine.{what}: the HLO graph audit (tpu_ddp/analysis/) is not "
    "ported to tpu_ddp_torch yet (ROADMAP Queue 1 item 12 (analysis/))")


__all__ = ["DisaggEngine", "KVEdge", "KVTransfer"]
