"""Iteration-level (continuous-batching) scheduler — the port of
tpu_ddp/serve/scheduler.py, with the disaggregated prefill role, peer
schedulers on one pool and :meth:`Scheduler.place`, the decode role's
admission path (fleet/disagg.py). Pure host code.

Batch membership is re-decided every model step: a fixed number of decode
slots runs one whole-bank decode step per iteration; finished sequences
retire and their slot and KV blocks are reusable on the next step.
Prefill is chunked and interleaved.

Invariants:

- **FIFO admission / no starvation.** Without tenant classes, requests
  admit strictly in submit order; if the queue head does not fit,
  nothing behind it is admitted.
- **Admitted requests always finish.** Admission reserves the worst-case
  block count ``ceil((prompt + max_new) / block_size)`` against
  ``pool.allocatable`` minus every live request's still-unallocated
  reservation; blocks are then allocated lazily and that allocation can
  never fail. With a prefix index the ledger charges every draw an
  admission makes on ``free + evictable``: fresh blocks (``need`` minus
  cached hits, plus one for a copy-on-write copy) and each hit block
  whose share pins a previously evictable cache entry.
- **Page-pool accounting.** ``free + Σ unique-allocated == total usable``
  at every step, with refcounts equal to holder counts
  (``pool.refcount_ok``).

``mode="static"`` is the experiment baseline: admission waits until
every slot is idle, fills all slots, then admits nothing until the whole
batch drains.

Multi-tenancy (``TPU_DDP_TENANT_CLASSES``): with tenant classes, admission
switches from global FIFO to weighted fair queueing over per-tenant FIFO
heads — stride scheduling: each tenant carries a virtual ``pass`` that
advances by ``work / weight`` per admission, and the tenant with the
smallest pass admits next. FIFO holds within each tenant, and an idle
tenant re-joins at the current virtual time. Classes also carry an
optional per-request queue deadline (the engine sheds past it) and an
optional outstanding-token budget (a tenant at its budget is passed
over until its own work retires).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

DEFAULT_TENANT = "default"


@dataclasses.dataclass(frozen=True)
class TenantClass:
    """One tenant's SLO class: WFQ weight (higher = more admission
    bandwidth, and sheds LAST under pressure), optional queued-TTFT
    deadline, optional outstanding-token budget."""

    name: str
    weight: int = 1
    deadline_ms: float = 0.0   # 0 = no per-class queue deadline
    token_budget: int = 0      # 0 = unbounded outstanding tokens

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant class needs a non-empty name")
        if self.weight < 1:
            raise ValueError(
                f"tenant {self.name!r}: weight must be >= 1, "
                f"got {self.weight}")
        if self.deadline_ms < 0:
            raise ValueError(
                f"tenant {self.name!r}: deadline_ms must be >= 0")
        if self.token_budget < 0:
            raise ValueError(
                f"tenant {self.name!r}: token_budget must be >= 0")


def parse_tenant_classes(spec: str | None) -> dict[str, TenantClass]:
    """Parse a ``TPU_DDP_TENANT_CLASSES`` value: comma-separated
    ``name=weight[:deadline_ms[:token_budget]]`` entries. Empty/None
    means no classes (single anonymous tenant, plain FIFO). Raises
    ValueError with the offending entry on malformed input — a typo'd
    class silently running as weight-1 would fake SLO coverage."""
    out: dict[str, TenantClass] = {}
    if not spec:
        return out
    for entry in str(spec).split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, eq, rest = entry.partition("=")
        name = name.strip()
        if not eq or not name:
            raise ValueError(
                f"bad tenant class {entry!r}: expected "
                "name=weight[:deadline_ms[:token_budget]]")
        if name in out:
            raise ValueError(f"duplicate tenant class {name!r}")
        parts = rest.split(":")
        if len(parts) > 3:
            raise ValueError(
                f"bad tenant class {entry!r}: at most "
                "weight:deadline_ms:token_budget")
        try:
            weight = int(parts[0])
            deadline = float(parts[1]) if len(parts) > 1 and parts[1] \
                else 0.0
            budget = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        except ValueError:
            raise ValueError(
                f"bad tenant class {entry!r}: expected "
                "name=weight[:deadline_ms[:token_budget]] with "
                "numeric fields") from None
        out[name] = TenantClass(name, weight, deadline, budget)
    return out


def tenant_of(request) -> str:
    """The tenant a request belongs to (engine-independent handles
    from older call sites default to the anonymous tenant)."""
    return getattr(request, "tenant", DEFAULT_TENANT)


def prefill_len(request) -> int:
    """The prompt tokens a request prefills: all but its ``replay`` tail,
    the tokens a migrated continuation already streamed, which the engine
    feeds back through decode passes (fleet/resilience.py)."""
    return len(request.prompt) - getattr(request, "replay", 0)


@dataclasses.dataclass
class SlotState:
    """Host bookkeeping for one decode slot's live request."""

    request: Any
    admit_seq: int
    phase: str  # "prefill" -> "decode"
    length: int = 0          # cache positions written (valid tokens)
    prefill_done: int = 0    # prompt tokens already run
    generated: int = 0       # tokens sampled so far
    pending_token: int = 0   # sampled but not yet fed through the model
    blocks: list = dataclasses.field(default_factory=list)
    reserved: int = 0        # worst-case TOTAL blocks for this request
    replay: int = 0          # samples still to drop: replayed tokens

    def take(self, tok: int) -> int | None:
        """Settle one sample of this slot, whose cache holds ``length``
        positions, and set the token fed next. While a migrated
        continuation replays the tokens another replica streamed, the
        sample is dropped and the streamed token at ``length`` is fed
        on: returns None, nothing to emit. Otherwise the sample is fed on
        and returned, to be emitted. The one place the replay rule
        lives."""
        if self.replay:
            self.replay -= 1
            self.pending_token = int(self.request.prompt[self.length])
            return None
        self.pending_token = int(tok)
        return self.pending_token

    @property
    def owed(self) -> int:
        """Tokens of work still owed: prompt to prefill, replayed tokens
        to feed, tokens to generate."""
        r = self.request
        return (prefill_len(r) - self.prefill_done) + self.replay \
            + (r.max_new_tokens - self.generated)


class Scheduler:
    def __init__(self, pool, num_slots: int, mode: str = "continuous",
                 prefix=None, role: str = "serve", tenants=None):
        if mode not in ("continuous", "static"):
            raise ValueError(f"unknown scheduler mode {mode!r}; "
                             "expected 'continuous' or 'static'")
        if role not in ("serve", "prefill"):
            raise ValueError(f"unknown scheduler role {role!r}; "
                             "expected 'serve' or 'prefill'")
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.pool = pool
        self.num_slots = num_slots
        self.mode = mode
        # name -> TenantClass. None/empty = single anonymous tenant,
        # admission stays plain FIFO. Tenants arriving without a
        # configured class get an implicit weight-1 class: classes are
        # scheduling policy, not an ACL.
        self.tenants: dict[str, TenantClass] | None = \
            dict(tenants) if tenants else None
        self._tenant_pass: dict[str, float] = {}  # WFQ virtual passes
        self._vtime = 0.0  # virtual time = pass of the last admission
        # Optional fleet.prefix.PrefixIndex: admission consults it so
        # shared-prompt requests adopt cached blocks instead of
        # re-prefilling them.
        self.prefix = prefix
        # "serve": prefill and decode in place. "prefill": the disagg
        # prefill role, which only ever holds prompts (reservations leave
        # out the generation tokens: the finished KV ships over the edge
        # and decodes elsewhere).
        self.role = role
        # Other schedulers drawing on the same pool (the disagg degraded-
        # prefill scheduler shares the decode pool): their unallocated
        # reservations come off this scheduler's admission budget, so
        # admitted-always-finish holds jointly.
        self.peers: list = []
        self.queue: deque = deque()
        self.slots: list[SlotState | None] = [None] * num_slots
        self._admit_seq = 0

    # ---- queries -------------------------------------------------------

    @property
    def live(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def reserved_unallocated(self) -> int:
        """Blocks promised to live requests but not yet allocated —
        the amount the admission check must treat as already spent."""
        return sum(s.reserved - len(s.blocks)
                   for s in self.slots if s is not None)

    @property
    def pool_budget(self) -> int:
        """Blocks an admission may draw on: the pool's allocatable count
        minus every outstanding reservation, this scheduler's and its
        peers' on the same pool."""
        return self.pool.allocatable - self.reserved_unallocated \
            - sum(p.reserved_unallocated for p in self.peers)

    def worst_case_blocks(self, request) -> int:
        if self.role == "prefill":
            return self.pool.blocks_for(len(request.prompt))
        return self.pool.blocks_for(len(request.prompt)
                                    + request.max_new_tokens)

    def prefill_slot(self) -> int | None:
        """The slot to run a prefill chunk for this step: the OLDEST
        admitted request still prefilling (FIFO among prefills — the
        fairness rule extends inside the engine)."""
        best = None
        for i, s in enumerate(self.slots):
            if s is not None and s.phase == "prefill":
                if best is None or s.admit_seq < self.slots[best].admit_seq:
                    best = i
        return best

    def decode_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots)
                if s is not None and s.phase == "decode"]

    # ---- lifecycle -----------------------------------------------------

    def enqueue(self, request) -> None:
        """Validate feasibility and queue FIFO. An infeasible request
        (worst case exceeds the whole pool) is rejected HERE, loudly —
        admitting it would starve the queue forever."""
        need = self.worst_case_blocks(request)
        if need > self.pool.total_usable:
            raise ValueError(
                f"request needs up to {need} KV blocks "
                f"({len(request.prompt)} prompt + "
                f"{request.max_new_tokens} new tokens at block_size="
                f"{self.pool.block_size}) but the pool holds only "
                f"{self.pool.total_usable}")
        self.queue.append(request)

    def admit(self) -> list[int]:
        """Move queued requests into free slots under the reservation
        rule. Returns the newly filled slot indices."""
        if self.mode == "static" and self.live:
            return []  # static batching: drain fully before re-admitting
        if self.tenants is None:
            return self._admit_fifo()
        return self._admit_wfq()

    def _admit_fifo(self) -> list[int]:
        admitted = []
        for i in range(self.num_slots):
            if not self.queue or self.slots[i] is not None:
                continue
            if not self._fill_slot(i, self.queue[0]):
                break  # FIFO: never skip the head
            self.queue.popleft()
            admitted.append(i)
        return admitted

    def _admit_wfq(self) -> list[int]:
        """Weighted fair queueing over per-tenant FIFO heads (stride
        scheduling). The WFQ-selected head inherits the FIFO
        no-starvation rule: if it does not fit the pool budget,
        NOTHING else is admitted this round — retirement frees blocks
        monotonically and the tenant keeps the minimum pass until
        served, so it eventually admits. Budget-capped tenants are
        different: skipping them is the point (their own retirements
        un-cap them)."""
        admitted = []
        free = [i for i in range(self.num_slots) if self.slots[i] is None]
        capped: set[str] = set()
        while free and self.queue:
            heads: dict[str, Any] = {}
            for r in self.queue:
                heads.setdefault(tenant_of(r), r)
            cand = [t for t in heads if t not in capped]
            if not cand:
                break
            t = min(cand, key=lambda t: (
                self._tenant_pass.get(t, self._vtime),
                -self._class(t).weight, heads[t].rid))
            req = heads[t]
            cls = self._class(t)
            work = len(req.prompt) + req.max_new_tokens
            # Token budget: pass the tenant over while ITS live work
            # exceeds the cap — but never wedge a request bigger than
            # the whole budget (it admits when the tenant is idle).
            live = self.tenant_live_tokens(t)
            if cls.token_budget and live and live + work > cls.token_budget:
                capped.add(t)
                continue
            if not self._fill_slot(free[0], req):
                break  # reservation rule: stop, don't reorder past it
            self._remove_queued(req)
            admitted.append(free.pop(0))
            # Stride advance: virtual time is the served tenant's pass
            # BEFORE the increment; an idle tenant re-joining starts at
            # the current virtual time (no hoarded credit).
            t_pass = max(self._tenant_pass.get(t, 0.0), self._vtime)
            self._vtime = t_pass
            self._tenant_pass[t] = t_pass + work / cls.weight
        return admitted

    def _fill_slot(self, i: int, req) -> bool:
        """Reservation-rule check + slot fill for one request. False
        when the pool budget cannot cover the draw (the caller stops
        admitting; the request stays queued)."""
        need = self.worst_case_blocks(req)
        hit = (self.prefix.plan(req.prompt[:prefill_len(req)],
                                ns=tenant_of(req))
               if self.prefix is not None else None)
        # Every draw this admission makes on (free + evictable):
        # fresh blocks (need minus cached hits, +1 for the CoW
        # copy), plus each hit whose share pins a previously
        # evictable cache entry.
        draw = need
        if hit is not None:
            draw -= len(hit.blocks)
            draw += 1 if hit.cow else 0
            draw += sum(self.pool.refcount(b) == 1
                        for b in hit.blocks)
        if draw > self.pool_budget:
            return False
        slot = SlotState(request=req, admit_seq=self._admit_seq,
                         phase="prefill", reserved=need,
                         replay=getattr(req, "replay", 0))
        self._admit_seq += 1
        if hit is not None:
            self.prefix.share(hit)  # no-op stats on a miss
        if hit:
            slot.blocks = list(hit.blocks)
            if hit.cow:
                # The last hit block would be written in place by
                # the re-run of the final prompt token — swap in a
                # private copy and drop our share of the original.
                private = self.pool.cow(slot.blocks[-1])
                self.pool.free([slot.blocks[-1]])
                slot.blocks[-1] = private
            slot.prefill_done = hit.cached_len
            slot.length = hit.cached_len
        # Remaining prompt blocks up front (prefill scatters into
        # them this or next step); generation blocks arrive lazily.
        for _ in range(self.pool.blocks_for(len(req.prompt))
                       - len(slot.blocks)):
            slot.blocks.append(self.pool.alloc())
        self.slots[i] = slot
        return True

    def _class(self, tenant: str) -> TenantClass:
        cls = self.tenants.get(tenant) if self.tenants else None
        return cls if cls is not None else TenantClass(tenant)

    def _remove_queued(self, req) -> None:
        """Drop ``req`` from the queue by IDENTITY — dataclass
        equality would compare prompt arrays elementwise."""
        for j, r in enumerate(self.queue):
            if r is req:
                del self.queue[j]
                return
        raise RuntimeError("request vanished from the queue mid-admit")

    def tenant_live_tokens(self, tenant: str) -> int:
        """Outstanding (unretired) token work tenant ``tenant`` holds
        in live slots — the quantity its token budget caps."""
        return sum(s.owed for s in self.slots
                   if s is not None and tenant_of(s.request) == tenant)

    def place(self, request, blocks, length: int,
              pending_token: int, replay: int = 0) -> int:
        """Install an externally prefilled sequence into a free slot —
        the disagg decode role's admission path. ``blocks`` are already
        allocated from this scheduler's pool (the edge adoption); the slot
        starts in the decode phase with its first sampled token pending
        and ``replay`` streamed tokens still to feed (:meth:`SlotState.
        take`). The caller checks the reservation rule before adopting."""
        for i in range(self.num_slots):
            if self.slots[i] is None:
                self.slots[i] = SlotState(
                    request=request, admit_seq=self._admit_seq,
                    phase="decode", length=length, prefill_done=length,
                    generated=len(request.tokens),
                    pending_token=pending_token, blocks=list(blocks),
                    reserved=self.worst_case_blocks(request),
                    replay=replay)
                self._admit_seq += 1
                return i
        raise RuntimeError("place() called with no free slot — the "
                           "adopter must check capacity first")

    def ensure_block(self, idx: int) -> None:
        """Grow slot ``idx``'s table to cover writing position
        ``length`` (called before each decode step). Covered by the
        reservation, so ``alloc`` cannot fail."""
        self.ensure_blocks(idx, 1)

    def ensure_blocks(self, idx: int, width: int) -> None:
        """Grow slot ``idx``'s table to cover writing positions
        ``length .. length + width - 1`` — the speculative step's
        k+1-wide generalization of :meth:`ensure_block`. Capped at the
        request's ``prompt + max_new_tokens`` budget (positions beyond
        it scatter to the null block in-graph), so the growth never
        exceeds the admission-time worst-case ``reserved`` count and
        ``alloc`` cannot fail."""
        s = self.slots[idx]
        limit = len(s.request.prompt) + s.request.max_new_tokens
        last = min(s.length + width - 1, limit - 1)
        while last // self.pool.block_size >= len(s.blocks):
            s.blocks.append(self.pool.alloc())

    def trim_blocks(self, idx: int) -> None:
        """Free slot ``idx``'s tail blocks beyond what ``length``
        needs — the speculative KV rollback. A
        rejected proposal leaves over-allocated (and garbage-filled)
        tail blocks; freeing whole blocks restores
        ``free + Σ allocated == total`` with no new pool invariant.
        Keeps the block holding position ``length`` (the next write
        target), so a kept block's garbage tail is causally masked.

        Tiered pools: the kept frontier block must be PROMOTED
        before the tail is trimmed. A deep rollback can land the write
        frontier in a block whose pages were demoted or spilled while
        the speculative window raced ahead; the next decode step
        scatters into that block's hot slot, so leaving it cold would
        silently drop the accepted prefix's most recent tokens."""
        s = self.slots[idx]
        keep = s.length // self.pool.block_size + 1
        if len(s.blocks) > keep:
            if self.pool.tiers > 1:
                self.pool.ensure_hot([s.blocks[keep - 1]])
            self.pool.free(s.blocks[keep:])
            del s.blocks[keep:]

    def retire(self, idx: int) -> None:
        """Free slot ``idx``'s blocks and reservation."""
        s = self.slots[idx]
        self.pool.free(s.blocks)
        self.slots[idx] = None

    def release(self, idx: int) -> SlotState:
        """Clear slot ``idx`` WITHOUT freeing its blocks — ownership
        transfer, not retirement. The caller must hand the returned
        state's blocks to another scheduler on the SAME pool (the
        degraded-prefill -> decode handover) or free them itself."""
        s = self.slots[idx]
        self.slots[idx] = None
        return s

    def accounting_ok(self) -> bool:
        """The page-pool invariant, checkable at any step: every holder
        the scheduler knows about — live block tables plus the prefix
        index — accounts for every refcount, and ``free + Σ
        unique-allocated == total usable``."""
        holders = [s.blocks for s in self.slots if s is not None]
        if self.prefix is not None:
            holders.append(self.prefix.held_blocks())
        return self.pool.refcount_ok(holders)
