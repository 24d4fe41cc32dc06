"""Block-paged KV-cache pool, single tier — the port of
tpu_ddp/serve/kv_pool.py at ``tiers == 1``.

The pool holds one K and one V buffer of fixed-size blocks covering every
layer — ``(num_layers, num_blocks, block_size, KV, hd)`` — and each live
request owns a list of block ids (its block table). Blocks are allocated
lazily as a sequence grows and returned on retirement, so cache memory
tracks the live token count, not the worst case.

Accounting is host-side and exact: a LIFO free list of block ids plus a
per-block refcount. Block 0 is the NULL block — never allocated, never
freed. The engine's steps redirect every masked write (idle decode slots,
prefill padding) into it, so such writes land in a sacrificial page
instead of one owned by another request; its contents are garbage by
design and are never attended (the causal position mask in
``decode.attend_cached`` gives any read beyond a query's own length an
exact 0 weight).

The buffers are torch tensors that the engine's steps update in place;
:meth:`commit` stores what a step hands back, which is the same tensors.
"""

from __future__ import annotations

import math

import torch

from tpu_ddp_torch.memory.policy import resolve_act_dtype


class PagedKVPool:
    """One paged K and V buffer covering every layer of one model, on
    ``device``, plus the host-side allocator."""

    NULL_BLOCK = 0

    def __init__(self, model, num_blocks: int, block_size: int,
                 cache_dtype: str = "compute", *, device):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is the "
                             f"reserved null block), got {num_blocks}")
        self.model = model
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.dtype = resolve_act_dtype(cache_dtype, model.compute_dtype)
        shape = (model.num_layers, num_blocks, block_size, model.kv_heads,
                 model.head_dim)
        self.k = torch.zeros(shape, dtype=self.dtype, device=device)
        self.v = torch.zeros(shape, dtype=self.dtype, device=device)
        # LIFO free list: recently freed pages are reused first. Block 0
        # is never a member.
        self._free = list(range(num_blocks - 1, 0, -1))
        # refs[b] == number of holders of an allocated block; 0 for free
        # blocks and the null block.
        self._refs = [0] * num_blocks

    @property
    def total_usable(self) -> int:
        """Allocatable blocks (the null block is not one)."""
        return self.num_blocks - 1

    @property
    def free_count(self) -> int:
        return len(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` cache slots."""
        return math.ceil(n_tokens / self.block_size)

    def alloc(self) -> int:
        """Claim one free block id (refcount 1). The scheduler's
        reservation rule guarantees this never raises for an admitted
        request; raising keeps the bug loud if that is ever broken."""
        if not self._free:
            raise RuntimeError(
                "KV pool exhausted — the scheduler admitted more "
                "worst-case tokens than the pool holds (reservation "
                "accounting bug)")
        b = self._free.pop()
        self._refs[b] = 1
        return b

    def refcount(self, b: int) -> int:
        return self._refs[b]

    def free(self, blocks) -> None:
        """Drop one holder per block; a block returns to the free list
        when its last holder lets go. Double free and null free raise."""
        for b in blocks:
            self._check_id(b)
            if self._refs[b] == 0:
                raise ValueError(f"double free of block {b}")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._free.append(b)

    def _check_id(self, b: int) -> None:
        if b == self.NULL_BLOCK:
            raise ValueError("the null block is never allocated or freed")
        if not 0 < b < self.num_blocks:
            raise ValueError(f"block id {b} out of range")

    def refcount_ok(self, holders) -> bool:
        """The accounting identity. ``holders`` is an iterable of
        block-id lists (every live block table). Checks that each
        block's refcount equals its number of appearances, that free
        blocks have no holders, and that ``free + Σ unique-allocated ==
        total usable``."""
        counts = [0] * self.num_blocks
        for hold in holders:
            for b in hold:
                counts[b] += 1
        if counts[self.NULL_BLOCK]:
            return False
        free = set(self._free)
        if len(free) != len(self._free):
            return False
        for b in range(1, self.num_blocks):
            if counts[b] != self._refs[b]:
                return False
            if counts[b] and b in free:
                return False
        unique = sum(1 for b in range(1, self.num_blocks) if counts[b])
        return self.free_count + unique == self.total_usable

    def scrub(self, blocks) -> None:
        """Zero the pages of ``blocks``. Stale finite garbage in a reused
        page is harmless (it gets exactly zero attention weight), but
        NaN/Inf is not: ``0 * NaN = NaN`` leaks through the causal mask.
        Quarantine scrubs a poisoned request's pages before freeing
        them."""
        blocks = list(blocks)
        if not blocks:
            return
        ids = torch.as_tensor(blocks, dtype=torch.int64,
                              device=self.k.device)
        self.k[:, ids] = 0
        self.v[:, ids] = 0

    def commit(self, k, v) -> None:
        """Store the K/V buffers a step hands back (updated in place)."""
        self.k, self.v = k, v
