"""Iteration-level (continuous-batching) scheduler — the port of
tpu_ddp/serve/scheduler.py with FIFO admission (no tenant classes or
prefix cache yet). Pure host code.

Batch membership is re-decided every model step: a fixed number of
decode slots runs one whole-bank decode step per iteration; finished
sequences retire and their slot and KV blocks are reusable on the next
step. Prefill is chunked and interleaved, at most one chunk per step.

Invariants:

- **FIFO admission / no starvation.** Requests admit strictly in submit
  order; if the queue head does not fit, nothing behind it is admitted.
- **Admitted requests always finish.** Admission reserves the WORST
  CASE block count ``ceil((prompt + max_new) / block_size)`` against the
  pool's free blocks minus every live request's still-unallocated
  reservation; blocks are then allocated lazily, and that allocation can
  never fail.
- **Page-pool accounting.** ``free + Σ unique-allocated == total usable``
  at every step, with refcounts equal to holder counts
  (``pool.refcount_ok``).

``mode="static"`` is the experiment baseline: admission waits until
every slot is idle, fills all slots, then admits nothing until the whole
batch drains.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any


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


class Scheduler:
    def __init__(self, pool, num_slots: int, mode: str = "continuous"):
        if mode not in ("continuous", "static"):
            raise ValueError(f"unknown scheduler mode {mode!r}; "
                             "expected 'continuous' or 'static'")
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.pool = pool
        self.num_slots = num_slots
        self.mode = mode
        self.queue: deque = deque()
        self.slots: list[SlotState | None] = [None] * num_slots
        self._admit_seq = 0

    @property
    def live(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def reserved_unallocated(self) -> int:
        """Blocks promised to live requests but not yet allocated."""
        return sum(s.reserved - len(s.blocks)
                   for s in self.slots if s is not None)

    @property
    def pool_budget(self) -> int:
        """Blocks an admission may draw on: free blocks minus every
        outstanding reservation."""
        return self.pool.free_count - self.reserved_unallocated

    def worst_case_blocks(self, request) -> int:
        return self.pool.blocks_for(len(request.prompt)
                                    + request.max_new_tokens)

    def prefill_slot(self) -> int | None:
        """The slot to run a prefill chunk for this step: the OLDEST
        admitted request still prefilling."""
        best = None
        for i, s in enumerate(self.slots):
            if s is not None and s.phase == "prefill":
                if best is None or s.admit_seq < self.slots[best].admit_seq:
                    best = i
        return best

    def decode_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots)
                if s is not None and s.phase == "decode"]

    def enqueue(self, request) -> None:
        """Validate feasibility and queue FIFO. A request whose worst
        case exceeds the whole pool is rejected here, loudly."""
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
        rule, FIFO. Returns the newly filled slot indices."""
        if self.mode == "static" and self.live:
            return []  # static batching: drain fully before re-admitting
        admitted = []
        for i in range(self.num_slots):
            if not self.queue or self.slots[i] is not None:
                continue
            if not self._fill_slot(i, self.queue[0]):
                break  # FIFO: never skip the head
            self.queue.popleft()
            admitted.append(i)
        return admitted

    def _fill_slot(self, i: int, req) -> bool:
        """Reservation check + slot fill. False when the pool budget
        cannot cover the request's worst case."""
        need = self.worst_case_blocks(req)
        if need > self.pool_budget:
            return False
        slot = SlotState(request=req, admit_seq=self._admit_seq,
                         phase="prefill", reserved=need)
        self._admit_seq += 1
        # Prompt blocks up front (prefill scatters into them); generation
        # blocks arrive lazily.
        for _ in range(self.pool.blocks_for(len(req.prompt))):
            slot.blocks.append(self.pool.alloc())
        self.slots[i] = slot
        return True

    def ensure_block(self, idx: int) -> None:
        """Grow slot ``idx``'s table to cover writing position
        ``length`` (called before each decode step). Covered by the
        reservation, so ``alloc`` cannot fail."""
        s = self.slots[idx]
        while s.length // self.pool.block_size >= len(s.blocks):
            s.blocks.append(self.pool.alloc())

    def retire(self, idx: int) -> None:
        """Free slot ``idx``'s blocks and reservation."""
        s = self.slots[idx]
        self.pool.free(s.blocks)
        self.slots[idx] = None

    def accounting_ok(self) -> bool:
        """The page-pool invariant, checkable at any step."""
        return self.pool.refcount_ok(
            [s.blocks for s in self.slots if s is not None])
