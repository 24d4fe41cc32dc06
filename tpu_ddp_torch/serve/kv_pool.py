"""Block-paged KV-cache pool — the port of tpu_ddp/serve/kv_pool.py,
with refcounts (prefix sharing, copy-on-write) and tiers.

The pool holds one K and one V buffer of fixed-size blocks covering every
layer — ``(num_layers, num_blocks, block_size, KV, hd)`` — and each live
request owns a list of block ids (its block table). Blocks are allocated
lazily as a sequence grows and returned on retirement, so cache memory
tracks the live token count, not the worst case.

Accounting is host-side and exact: a LIFO free list of block ids plus a
per-block refcount. Block 0 is the NULL block — never allocated, never
freed. The engine's steps redirect every masked write (idle decode slots,
prefill padding, speculative columns past a request's budget) into it, so
such writes land in a sacrificial page instead of one owned by another
request; its contents are garbage by design and are never attended (the
causal position mask in ``decode.attend_cached`` gives any read beyond a
query's own length an exact 0 weight).

Refcounts make prefix caching (fleet/prefix.py) safe: a block holding a
shared system prompt's KV appears in many block tables at once (plus the
prefix index itself) and returns to the free list only when its last
holder drops it. ``free`` is a decref, ``incref`` adds a holder, ``cow``
gives a writer its own copy of a shared block. :meth:`refcount_ok` checks
``free + Σ unique-allocated == total usable`` with per-block refcounts
equal to the number of holders.

Tiers (``tiers > 1``) split residency from allocation. Block ids stay
logical — the scheduler, prefix index, refcounts and block tables do not
change — but a block's pages live in one of three places:

- **hot**: a slot of the device buffers ``k``/``v`` in the exact cache
  dtype, the only tier the steps write. ``hbm_blocks - 1`` slots (slot 0
  is the hot null page).
- **cold** (``tiers >= 2``): a slot of ``cold_k``/``cold_v`` on the
  device, quantized by the cold-page codec (parallel/compress.py) with
  f32 per-row scales ``cold_sk``/``cold_sv``. The tiered steps
  (serve/long_context.py) read cold pages through the dequant. Under
  tensor-parallel serving a rank holds its KV / tp heads of every page,
  and an int8 row's scale is the max over all heads (the row max
  all-reduced over the tp group), so each rank's scales are those of
  the JAX engine's replicated pool.
- **spill** (``tiers == 3``): host memory holding the already-quantized
  page; ``ensure_device`` brings it back to cold on demand.

Movement is demand-driven and batched: ``ensure_hot`` promotes (dequant),
demotes LRU victims (quantize) and spills LRU cold pages to the host when
the cold tier is full too. Host copies are synchronous: a spill reads the
pages into host tensors before their cold slots are reused, and an
unspill copies them back before the slots are read. A fresh block
(allocated, never written) has no residency until its first
``ensure_hot``. ``moves`` counts blocks per movement kind.

At ``tiers == 1`` every path below is the single-tier pool unchanged: the
logical id is the hot slot. The buffers are torch tensors that the steps
update in place; :meth:`commit` stores what a step hands back, which is
the same tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpu_ddp_torch.memory.policy import resolve_act_dtype
from tpu_ddp_torch.parallel.compress import (page_dequantize,
                                             page_quantize, page_row_amax)

COLD_DTYPES = {"int8": torch.int8, "bf16": torch.bfloat16}


class PagedKVPool:
    """One paged K and V buffer covering every layer of one model, on
    ``device``, plus the host-side allocator and (``tiers > 1``) the
    residency maps."""

    NULL_BLOCK = 0

    def __init__(self, model, num_blocks: int, block_size: int,
                 cache_dtype: str = "compute", *, device, tiers: int = 1,
                 cold_dtype: str = "int8", hbm_blocks: int | None = None,
                 cold_blocks: int | None = None):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is the "
                             f"reserved null block), got {num_blocks}")
        if tiers not in (1, 2, 3):
            raise ValueError(f"tiers must be 1, 2 or 3, got {tiers!r} "
                             "(TPU_DDP_KV_TIERS)")
        if cold_dtype not in COLD_DTYPES:
            raise ValueError(
                f"cold_dtype={cold_dtype!r}: expected one of "
                f"{sorted(COLD_DTYPES)} (TPU_DDP_KV_COLD_DTYPE)")
        self.model = model
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.tiers = tiers
        self.cold_dtype_name = cold_dtype
        self.dtype = resolve_act_dtype(cache_dtype, model.compute_dtype)
        # Under tensor-parallel serving each rank's pool holds its KV / tp
        # heads (JAX keeps the pool replicated under GSPMD).
        page = (block_size, model.kv_heads // model._tp, model.head_dim)
        self.hbm_blocks = (num_blocks if tiers == 1
                           else int(hbm_blocks if hbm_blocks is not None
                                    else num_blocks))
        self.cold_blocks = int(cold_blocks if cold_blocks is not None
                               else num_blocks) if tiers > 1 else 0
        if tiers > 1 and self.hbm_blocks < 2:
            raise ValueError("hbm_blocks must be >= 2 (slot 0 is the "
                             f"hot null page), got {self.hbm_blocks}")
        if tiers > 1 and self.cold_blocks < 2:
            raise ValueError("cold_blocks must be >= 2 (slot 0 is the "
                             f"cold null page), got {self.cold_blocks}")
        shape = (model.num_layers, self.hbm_blocks) + page
        self.k = torch.zeros(shape, dtype=self.dtype, device=device)
        self.v = torch.zeros(shape, dtype=self.dtype, device=device)
        self.cold_k = self.cold_v = self.cold_sk = self.cold_sv = None
        if tiers > 1:
            cshape = (model.num_layers, self.cold_blocks) + page
            cdt = COLD_DTYPES[cold_dtype]
            self.cold_k = torch.zeros(cshape, dtype=cdt, device=device)
            self.cold_v = torch.zeros(cshape, dtype=cdt, device=device)
            sshape = (model.num_layers, self.cold_blocks, block_size)
            self.cold_sk = torch.zeros(sshape, dtype=torch.float32,
                                       device=device)
            self.cold_sv = torch.zeros(sshape, dtype=torch.float32,
                                       device=device)
        # LIFO free list: recently freed pages are reused first. Block 0
        # is never a member.
        self._free = list(range(num_blocks - 1, 0, -1))
        # refs[b] == number of holders (block tables + prefix-index
        # entries) of an allocated block; 0 for free blocks and null.
        self._refs = [0] * num_blocks
        # Residency (tiers > 1): tier per logical id, its hot/cold slot
        # (0 = none), per-tier slot free lists, LRU orders (index 0 =
        # coldest candidate) and the host spill store.
        self._tier = ["free"] * num_blocks
        self._hot_slot = [0] * num_blocks
        self._cold_slot = [0] * num_blocks
        self._hot_free = (list(range(self.hbm_blocks - 1, 0, -1))
                          if tiers > 1 else [])
        self._cold_free = (list(range(self.cold_blocks - 1, 0, -1))
                           if tiers > 1 else [])
        self._hot_lru: list[int] = []
        self._cold_lru: list[int] = []
        self._spill: dict[int, tuple] = {}
        self.moves = {"promote": 0, "demote": 0, "spill": 0, "unspill": 0}
        # Optional last-resort reclaimer (the prefix index registers
        # itself): ``.evictable_count`` and ``.reclaim(n) -> freed``.
        self.reclaimer = None

    # ---- allocator -----------------------------------------------------

    @property
    def total_usable(self) -> int:
        """Allocatable blocks (the null block is not one)."""
        return self.num_blocks - 1

    @property
    def hot_usable(self) -> int:
        """Hot pages available to residency: what bounds the context
        that is hot at once, not the total context."""
        return self.hbm_blocks - 1

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def allocatable(self) -> int:
        """Blocks an admission may count on: free now, plus what the
        reclaimer could evict on demand (prefix entries nobody else
        holds)."""
        extra = self.reclaimer.evictable_count if self.reclaimer else 0
        return len(self._free) + extra

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` cache slots."""
        return math.ceil(n_tokens / self.block_size)

    def alloc(self) -> int:
        """Claim one free block id (refcount 1). The scheduler's
        reservation rule guarantees this never raises for an admitted
        request; raising keeps the bug loud if that is ever broken."""
        if not self._free and self.reclaimer is not None:
            self.reclaimer.reclaim(1)
        if not self._free:
            raise RuntimeError(
                "KV pool exhausted — the scheduler admitted more "
                "worst-case tokens than the pool holds (reservation "
                "accounting bug)")
        b = self._free.pop()
        self._refs[b] = 1
        if self.tiers > 1:
            self._tier[b] = "fresh"
        return b

    def refcount(self, b: int) -> int:
        return self._refs[b]

    def incref(self, blocks) -> None:
        """Add one holder to each block (prefix registration, or a new
        request sharing cached prompt blocks)."""
        for b in blocks:
            self._check_id(b)
            if self._refs[b] == 0:
                raise ValueError(
                    f"incref of unallocated block {b} — a holder can "
                    "only be added to a live block")
            self._refs[b] += 1

    def free(self, blocks) -> None:
        """Drop one holder per block; a block returns to the free list
        when its last holder lets go, releasing whatever tier slot (or
        host spill entry) its pages held. Double free and null free
        raise."""
        for b in blocks:
            self._check_id(b)
            if self._refs[b] == 0:
                raise ValueError(f"double free of block {b}")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                if self.tiers > 1:
                    self._release_residency(b)
                self._free.append(b)

    def _release_residency(self, b: int) -> None:
        t = self._tier[b]
        if t == "hot":
            self._hot_free.append(self._hot_slot[b])
            self._hot_slot[b] = 0
            self._hot_lru.remove(b)
        elif t == "cold":
            self._cold_free.append(self._cold_slot[b])
            self._cold_slot[b] = 0
            self._cold_lru.remove(b)
        elif t == "spill":
            del self._spill[b]
        self._tier[b] = "free"

    def cow(self, b: int) -> int:
        """Copy-on-write: a private copy of shared block ``b`` (refcount
        1 on the copy; ``b``'s refcount is untouched — the caller still
        drops its own share). Tiered: the source promotes first (the copy
        is exact-dtype) and the copy is born hot."""
        self._check_id(b)
        if self._refs[b] == 0:
            raise ValueError(f"copy-on-write of unallocated block {b}")
        new = self.alloc()
        if self.tiers > 1:
            self.ensure_hot([b, new])
        sb, sn = self.hot_slot(b), self.hot_slot(new)
        self.k[:, sn] = self.k[:, sb]
        self.v[:, sn] = self.v[:, sb]
        return new

    def _check_id(self, b: int) -> None:
        if b == self.NULL_BLOCK:
            raise ValueError("the null block is never allocated, "
                             "freed, or shared")
        if not 0 < b < self.num_blocks:
            raise ValueError(f"block id {b} out of range")

    def refcount_ok(self, holders) -> bool:
        """The accounting identity. ``holders`` is an iterable of
        block-id lists (every live block table plus the prefix index's
        held set). Checks that each block's refcount equals its number of
        appearances, that free blocks have no holders, that ``free + Σ
        unique-allocated == total usable``, and the per-tier residency
        identity."""
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
        if self.free_count + unique != self.total_usable:
            return False
        return self.tier_accounting_ok()

    # ---- tiers ---------------------------------------------------------

    def tier_of(self, b: int) -> str:
        """"hot" | "cold" | "spill" | "fresh" for an allocated block,
        "free" otherwise. At ``tiers == 1`` every allocated block is
        hot."""
        self._check_id(b)
        if self.tiers == 1:
            return "hot" if self._refs[b] else "free"
        return self._tier[b]

    def tier_counts(self) -> dict:
        """Per-tier census of the allocated blocks and free slots."""
        if self.tiers == 1:
            hot = sum(1 for r in self._refs[1:] if r)
            return {"hot": hot, "cold": 0, "spill": 0, "fresh": 0,
                    "hot_free": self.free_count, "cold_free": 0}
        c = {"hot": 0, "cold": 0, "spill": 0, "fresh": 0}
        for b in range(1, self.num_blocks):
            if self._tier[b] in c:
                c[self._tier[b]] += 1
        c["hot_free"] = len(self._hot_free)
        c["cold_free"] = len(self._cold_free)
        return c

    def tier_accounting_ok(self) -> bool:
        """The per-tier residency identity: ``hot_free + hot_resident ==
        hot usable`` and the cold analog; hot/cold/spill/fresh partition
        exactly the allocated ids; slot maps are injective and agree with
        the LRU orders and the spill store."""
        if self.tiers == 1:
            return True
        tiers: dict[str, list[int]] = {
            "hot": [], "cold": [], "spill": [], "fresh": [], "free": []}
        for b in range(1, self.num_blocks):
            if self._tier[b] not in tiers:
                return False
            tiers[self._tier[b]].append(b)
            if (self._refs[b] == 0) != (self._tier[b] == "free"):
                return False
        if len(self._hot_free) + len(tiers["hot"]) != self.hot_usable:
            return False
        if len(self._cold_free) + len(tiers["cold"]) \
                != self.cold_blocks - 1:
            return False
        hot_slots = [self._hot_slot[b] for b in tiers["hot"]]
        cold_slots = [self._cold_slot[b] for b in tiers["cold"]]
        if 0 in hot_slots or len(set(hot_slots)) != len(hot_slots):
            return False
        if 0 in cold_slots or len(set(cold_slots)) != len(cold_slots):
            return False
        if set(hot_slots) & set(self._hot_free):
            return False
        if set(cold_slots) & set(self._cold_free):
            return False
        if sorted(self._hot_lru) != sorted(tiers["hot"]):
            return False
        if sorted(self._cold_lru) != sorted(tiers["cold"]):
            return False
        if sorted(self._spill) != sorted(tiers["spill"]):
            return False
        for name in ("hot", "cold", "spill", "fresh"):
            for b in tiers[name]:
                if self._hot_slot[b] and name != "hot":
                    return False
                if self._cold_slot[b] and name != "cold":
                    return False
        return True

    def ensure_device(self, blocks) -> None:
        """Bring spilled blocks back to the device (spill -> cold), the
        precondition for appearing in a step's cold table. Hot, cold and
        fresh blocks are untouched."""
        if self.tiers < 3:
            return
        ids = [b for b in dict.fromkeys(blocks)
               if self._tier[b] == "spill"]
        if ids:
            self._unspill(ids, protect=set(blocks))

    def hot_slot(self, b: int) -> int:
        """The hot slot of a hot block (at ``tiers == 1`` the logical id
        is the slot)."""
        if self.tiers == 1:
            return b
        if self._tier[b] != "hot":
            raise RuntimeError(f"block {b} is {self._tier[b]}, not hot "
                               "— ensure_hot first")
        return self._hot_slot[b]

    def ensure_hot(self, blocks, keep=()) -> None:
        """After this call every block of ``blocks`` is hot. Promotes
        cold pages through the dequant, pulls spilled pages to cold
        first, gives fresh blocks a slot with no data movement, and
        demotes LRU hot victims (never one of ``blocks``) to make room.
        ``keep`` names blocks that must stay on the device (demoting them
        to cold is fine, spilling them is not). Raises when ``blocks``
        alone exceeds the hot capacity: a sizing bug, not pressure."""
        if self.tiers == 1:
            return
        ids = list(dict.fromkeys(blocks))
        for b in ids:
            self._check_id(b)
            if self._refs[b] == 0:
                raise ValueError(f"ensure_hot of unallocated block {b}")
        if len(ids) > self.hot_usable:
            raise RuntimeError(
                f"ensure_hot of {len(ids)} blocks exceeds the hot "
                f"tier's {self.hot_usable} usable pages (hbm_blocks="
                f"{self.hbm_blocks}) — shrink the simultaneous "
                "working set or raise the HBM budget")
        protect = set(ids)
        on_device = protect | set(keep)
        need = [b for b in ids if self._tier[b] != "hot"]
        spilled = [b for b in need if self._tier[b] == "spill"]
        if spilled:
            self._unspill(spilled, on_device)
        deficit = len(need) - len(self._hot_free)
        if deficit > 0:
            victims = [b for b in self._hot_lru if b not in protect]
            if len(victims) < deficit:
                raise RuntimeError(
                    "hot tier wedged: not enough evictable pages to "
                    f"promote {len(need)} blocks (hbm_blocks="
                    f"{self.hbm_blocks})")
            self._demote(victims[:deficit], on_device)
        promote = [b for b in need if self._tier[b] == "cold"]
        fresh = [b for b in need if self._tier[b] == "fresh"]
        for b in need:
            self._hot_slot[b] = self._hot_free.pop()
            self._hot_lru.append(b)
        if promote:
            hs = self._index([self._hot_slot[b] for b in promote])
            cs = self._index([self._cold_slot[b] for b in promote])
            self.k[:, hs] = page_dequantize(self.cold_k[:, cs],
                                            self.cold_sk[:, cs], self.dtype)
            self.v[:, hs] = page_dequantize(self.cold_v[:, cs],
                                            self.cold_sv[:, cs], self.dtype)
            for b in promote:
                self._cold_free.append(self._cold_slot[b])
                self._cold_slot[b] = 0
                self._cold_lru.remove(b)
            self.moves["promote"] += len(promote)
        for b in promote + fresh:
            self._tier[b] = "hot"
        self._touch(ids)

    def _index(self, slots):
        return torch.as_tensor(slots, dtype=torch.int64,
                               device=self.k.device)

    def _touch(self, blocks) -> None:
        """LRU bump: mark hot blocks as most recently used."""
        for b in blocks:
            if self._tier[b] == "hot":
                self._hot_lru.remove(b)
                self._hot_lru.append(b)

    def _demote(self, blocks, protect) -> None:
        """Hot -> cold for ``blocks`` (one quantize), spilling LRU cold
        pages to the host first if the cold tier is full."""
        self._grab_cold(len(blocks), protect)
        new_cold = [self._cold_free.pop() for _ in blocks]
        hs = self._index([self._hot_slot[b] for b in blocks])
        cs = self._index(new_cold)
        qk, sk = self._quantize(self.k[:, hs])
        qv, sv = self._quantize(self.v[:, hs])
        self.cold_k[:, cs] = qk
        self.cold_v[:, cs] = qv
        self.cold_sk[:, cs] = sk
        self.cold_sv[:, cs] = sv
        for b, slot in zip(blocks, new_cold):
            self._hot_free.append(self._hot_slot[b])
            self._hot_slot[b] = 0
            self._hot_lru.remove(b)
            self._tier[b] = "cold"
            self._cold_slot[b] = slot
            self._cold_lru.append(b)
        self.moves["demote"] += len(blocks)

    def _quantize(self, pages):
        """The cold-page codec on hot ``pages``. Under tensor-parallel
        serving an int8 row's scale is over every head of the row, as
        the replicated pool of the JAX engine scales it: this rank's
        row max all-reduced (MAX) over the tp group first."""
        cdt = COLD_DTYPES[self.cold_dtype_name]
        if cdt != torch.int8 or self.model._tp == 1:
            return page_quantize(pages, cdt)
        import torch.distributed as dist
        amax = page_row_amax(pages)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX,
                        group=self.model.tp_group)
        return page_quantize(pages, cdt, amax)

    def _grab_cold(self, n: int, protect) -> None:
        """Guarantee >= n free cold slots, spilling LRU cold pages to the
        host (tiers == 3); at tiers == 2 running out is terminal."""
        deficit = n - len(self._cold_free)
        if deficit <= 0:
            return
        victims = [b for b in self._cold_lru if b not in protect]
        if self.tiers < 3 or len(victims) < deficit:
            raise RuntimeError(
                "cold tier exhausted: no host spill tier to evict "
                "into (tiers=2) or nothing evictable — raise "
                "cold_blocks or use tiers=3" if self.tiers < 3 else
                "cold tier wedged: every cold page is protected")
        self._spill_out(victims[:deficit])

    def _spill_out(self, blocks) -> None:
        """Cold -> spill: copy the already-quantized pages to the host
        (synchronously: the copy is complete before the cold slots are
        handed out again) and free the cold slots."""
        idx = self._index([self._cold_slot[b] for b in blocks])
        kq = self.cold_k[:, idx].cpu()
        vq = self.cold_v[:, idx].cpu()
        sk = self.cold_sk[:, idx].cpu()
        sv = self.cold_sv[:, idx].cpu()
        for i, b in enumerate(blocks):
            self._spill[b] = (kq[:, i].clone(), vq[:, i].clone(),
                              sk[:, i].clone(), sv[:, i].clone())
            self._cold_free.append(self._cold_slot[b])
            self._cold_slot[b] = 0
            self._cold_lru.remove(b)
            self._tier[b] = "spill"
        self.moves["spill"] += len(blocks)

    def _unspill(self, blocks, protect) -> None:
        """Spill -> cold: copy the host pages back into cold slots (one
        synchronous copy per buffer for the batch)."""
        self._grab_cold(len(blocks), set(protect) | set(blocks))
        slots = [self._cold_free.pop() for _ in blocks]
        idx = self._index(slots)
        dev = self.cold_k.device
        for buf, part in ((self.cold_k, 0), (self.cold_v, 1),
                          (self.cold_sk, 2), (self.cold_sv, 3)):
            host = torch.stack([self._spill[b][part] for b in blocks],
                               dim=1)
            buf[:, idx] = host.to(dev)
        for b, slot in zip(blocks, slots):
            del self._spill[b]
            self._tier[b] = "cold"
            self._cold_slot[b] = slot
            self._cold_lru.append(b)
        self.moves["unspill"] += len(blocks)

    def slot_tables(self, blocks, width: int):
        """Translate a logical block table into the tiered steps' two
        physical tables ``(hot_slots, cold_slots)``, each ``(width,)``
        int64 numpy, zero where the block is not in that tier (slot 0
        reads the null page). Spilled blocks are a caller bug —
        ``ensure_device`` first."""
        blocks = list(blocks)
        hot = np.zeros(width, np.int64)
        cold = np.zeros(width, np.int64)
        if self.tiers == 1:
            hot[:len(blocks)] = blocks
            return hot, cold
        for i, b in enumerate(blocks):
            t = self._tier[b]
            if t == "hot":
                hot[i] = self._hot_slot[b]
            elif t == "cold":
                cold[i] = self._cold_slot[b]
            elif t == "spill":
                raise RuntimeError(
                    f"block {b} is spilled to host — ensure_device "
                    "before building step tables")
        return hot, cold

    def page_arrays(self, blocks):
        """The pages of ``blocks`` in the exact cache dtype, shaped (L, n,
        bs, KV, hd). Tiered pools promote to hot first: a page reader gets
        exact bytes, never a dequantized approximation."""
        ids = list(blocks)
        if self.tiers > 1:
            self.ensure_hot(ids)
            ids = [self._hot_slot[b] for b in ids]
        idx = self._index(ids)
        return self.k[:, idx], self.v[:, idx]

    def scrub(self, blocks) -> None:
        """Zero the pages of ``blocks`` wherever they are resident. Stale
        finite garbage in a reused page is harmless (it gets exactly zero
        attention weight), but NaN/Inf is not: ``0 * NaN = NaN`` leaks
        through the causal mask. Quarantine scrubs a poisoned request's
        pages before freeing them, and a poisoned page demoted or spilled
        carries its NaNs through the quantizer, so every tier scrubs."""
        blocks = list(blocks)
        if not blocks:
            return
        if self.tiers == 1:
            ids = self._index(blocks)
            self.k[:, ids] = 0
            self.v[:, ids] = 0
            return
        hot = [self._hot_slot[b] for b in blocks if self._tier[b] == "hot"]
        cold = [self._cold_slot[b] for b in blocks
                if self._tier[b] == "cold"]
        if hot:
            ids = self._index(hot)
            self.k[:, ids] = 0
            self.v[:, ids] = 0
        if cold:
            ids = self._index(cold)
            for buf in (self.cold_k, self.cold_v, self.cold_sk,
                        self.cold_sv):
                buf[:, ids] = 0
        for b in blocks:
            if self._tier[b] == "spill":
                self._spill[b] = tuple(torch.zeros_like(a)
                                       for a in self._spill[b])

    def commit(self, k, v) -> None:
        """Store the K/V buffers a step hands back (updated in place)."""
        self.k, self.v = k, v
