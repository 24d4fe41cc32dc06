"""Hash-keyed prefix index: shared-prompt KV reuse over the paged pool —
the port of ``PrefixIndex``, ``PrefixHit`` and ``PrefixDirectory`` (the
fleet router's map of which replica may hold a prefix) from
tpu_ddp/fleet/prefix.py.

Requests that share a long system prompt pay one prefill: after a
request's prefill completes, its full prompt blocks are registered under
chain keys; a later request whose prompt starts with the same token blocks
adopts the cached blocks into its own table (one refcount per block, see
``serve/kv_pool.py``) and starts prefilling at the first uncached token.

- **Keys are exact.** An entry's key is the recursive chain
  ``(parent_key, block_token_tuple)``, rooted at ``("ns", tenant)``: two
  prompts share an entry iff they are token-identical up to and including
  that block within one tenant's namespace, so no collision can serve the
  wrong KV and no tenant's cache serves another.
- **Only full blocks are cached**: a partial tail block would be extended
  in place by the next request.
- **Copy-on-write at the divergence point.** ``cached_len`` is capped at
  ``prompt_len - 1`` so the final prompt token always re-runs (the first
  output token is sampled from its logits); when that token's block is a
  shared one, ``PrefixHit.cow`` marks it and admission swaps in a private
  ``pool.cow`` copy before any write.
- **The index is a holder.** Registered blocks carry an index refcount so
  they outlive their creator. Eviction is LRU over leaf entries nobody
  else holds; the index registers itself as the pool's ``reclaimer``, so
  a full cache never blocks admission.

``plan`` is pure; ``share`` is the effectful twin the scheduler calls once
per admission, and is where hit statistics accrue.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

DEFAULT_NS = "default"


@dataclasses.dataclass
class PrefixHit:
    """A pure lookup result: the longest indexed chain for a prompt."""

    blocks: list            # cached block ids, chain order
    keys: list              # their index keys (for LRU touch)
    cached_len: int         # prompt tokens the hit actually covers
    cow: bool               # last hit block needs a private copy

    def __bool__(self) -> bool:
        return bool(self.blocks)


@dataclasses.dataclass
class _Entry:
    block: int
    parent: object          # parent chain key, None at the root
    children: int = 0       # entries chaining from this one


class PrefixIndex:
    """Refcount-holding prefix cache over one :class:`PagedKVPool`."""

    def __init__(self, pool):
        self.pool = pool
        pool.reclaimer = self
        # key -> _Entry; OrderedDict doubles as the LRU order
        # (oldest-touched first).
        self._entries: OrderedDict = OrderedDict()
        self.lookups = 0            # admissions through the index
        self.hit_requests = 0       # admissions with >= 1 cached block
        self.cached_blocks_served = 0
        self.tokens_saved = 0       # prefill tokens skipped, total
        self.inserted = 0
        self.evicted = 0

    # No __len__: an empty index must stay truthy (``if index`` guards
    # would silently skip a cold cache); use ``stats()["entries"]``.

    # ---- lookup --------------------------------------------------------

    def _chain(self, prompt, ns: str = DEFAULT_NS):
        """Yield the chain key for each FULL block of the prompt.
        Chains are rooted at the tenant namespace, so cross-tenant
        prompts can never share an entry no matter their tokens."""
        bs = self.pool.block_size
        key = ("ns", str(ns))
        for i in range(len(prompt) // bs):
            tok = tuple(int(t) for t in prompt[i * bs:(i + 1) * bs])
            key = (key, tok)
            yield key

    def plan(self, prompt, ns: str = DEFAULT_NS) -> PrefixHit:
        """Longest indexed chain for ``prompt`` within tenant
        namespace ``ns``. Pure — no refcounts, no stats, no LRU touch
        — so the router can probe it per candidate replica without
        distorting anything."""
        blocks, keys = [], []
        for key in self._chain(prompt, ns):
            e = self._entries.get(key)
            if e is None:
                break
            blocks.append(e.block)
            keys.append(key)
        if not blocks:
            return PrefixHit([], [], 0, False)
        bs = self.pool.block_size
        # The final prompt token must re-run (its logits seed the first
        # output token), so a full-prompt hit is capped one short —
        # and that capped token's block, being shared, needs CoW.
        cached_len = min(len(blocks) * bs, len(prompt) - 1)
        cow = len(blocks) * bs > cached_len
        return PrefixHit(list(blocks), keys, cached_len, cow)

    def cached_len(self, prompt, ns: str = DEFAULT_NS) -> int:
        """Convenience for prefix-affinity routing."""
        return self.plan(prompt, ns).cached_len

    # ---- admission-side effects ---------------------------------------

    def share(self, hit: PrefixHit) -> None:
        """Adopt a planned hit: one incref per cached block, LRU touch.
        Called exactly once per admission (with an empty hit on a
        miss), so ``lookups`` counts admissions through the index."""
        self.lookups += 1
        if not hit:
            return
        self.hit_requests += 1
        self.cached_blocks_served += len(hit.blocks)
        self.tokens_saved += hit.cached_len
        self.pool.incref(hit.blocks)
        for key in hit.keys:
            self._entries.move_to_end(key)

    def register(self, prompt, blocks, ns: str = DEFAULT_NS) -> None:
        """Index a finished prefill's FULL prompt blocks under tenant
        namespace ``ns``. Blocks whose chain key is already present
        are skipped (the existing entry's block holds identical
        content by construction); new entries take an index refcount
        so they outlive the request."""
        key = None
        for i, k in enumerate(self._chain(prompt, ns)):
            e = self._entries.get(k)
            if e is None:
                self.pool.incref([blocks[i]])
                self._entries[k] = _Entry(block=blocks[i], parent=key)
                if key is not None:
                    self._entries[key].children += 1
                self.inserted += 1
            self._entries.move_to_end(k)
            key = k

    # ---- pool reclaimer interface --------------------------------------

    @property
    def evictable_count(self) -> int:
        """Leaf entries nobody but the index holds — what ``reclaim``
        can free IMMEDIATELY. Cascading (a parent becoming a leaf
        after its child is evicted) can free more; counting only the
        first wave keeps the scheduler's reservation math conservative
        and therefore sound."""
        return sum(1 for e in self._entries.values()
                   if e.children == 0 and self.pool.refcount(e.block) == 1)

    def reclaim(self, n: int) -> int:
        """Evict up to ``n`` blocks' worth of cold entries, LRU-first,
        leaf-only, cascading into parents as they become leaves."""
        freed = 0
        progress = True
        while freed < n and progress:
            progress = False
            for key in list(self._entries.keys()):
                if freed >= n:
                    break
                e = self._entries[key]
                if e.children == 0 and self.pool.refcount(e.block) == 1:
                    self._evict(key)
                    freed += 1
                    progress = True
        return freed

    def _evict(self, key) -> None:
        e = self._entries.pop(key)
        if e.parent is not None:
            self._entries[e.parent].children -= 1
        self.pool.free([e.block])
        self.evicted += 1

    # ---- accounting ----------------------------------------------------

    def held_blocks(self) -> list:
        """The index's holder list, for ``pool.refcount_ok``."""
        return [e.block for e in self._entries.values()]

    @property
    def hit_rate(self) -> float:
        return self.hit_requests / self.lookups if self.lookups else 0.0

    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "lookups": self.lookups,
            "hit_requests": self.hit_requests,
            "hit_rate": self.hit_rate,
            "cached_blocks_served": self.cached_blocks_served,
            "tokens_saved": self.tokens_saved,
            "inserted": self.inserted,
            "evicted": self.evicted,
        }


class PrefixDirectory:
    """Cross-replica prefix directory for affinity routing.

    The Router records ``(tenant, first full block of the prompt) ->
    replica index`` for every routed request and asks the directory before
    probing replicas: only the replicas recorded for that key can hold the
    prefix, so a pick probes those instead of the whole fleet. Entries are
    advisory: the Router still checks each candidate with the replica's
    own pure probe, and falls back to the full probe when every hint
    misses. Replica removal calls :meth:`forget` and :meth:`reindex`."""

    def __init__(self, block_size: int):
        if block_size < 1:
            raise ValueError(
                f"block_size must be >= 1, got {block_size}")
        self.block_size = block_size
        # (tenant, first-block token tuple) -> set of replica indices
        self._where: dict = {}
        self.records = 0
        self.narrowed = 0   # picks the directory narrowed
        self.misses = 0     # picks with no recorded candidate

    def _key(self, tenant: str, prompt):
        if len(prompt) < self.block_size:
            return None  # no full block: nothing cacheable to find
        return (str(tenant),
                tuple(int(t) for t in prompt[:self.block_size]))

    def record(self, tenant: str, prompt, replica: int) -> None:
        key = self._key(tenant, prompt)
        if key is None:
            return
        self._where.setdefault(key, set()).add(replica)
        self.records += 1

    def candidates(self, tenant: str, prompt) -> list[int]:
        """Replica indices that may hold this prompt's prefix, sorted;
        empty when none can."""
        key = self._key(tenant, prompt)
        hits = self._where.get(key) if key is not None else None
        if hits:
            self.narrowed += 1
            return sorted(hits)
        self.misses += 1
        return []

    def forget(self, replica: int) -> None:
        """Drop every record pointing at ``replica`` (its cache is gone)."""
        for key in list(self._where):
            s = self._where[key]
            s.discard(replica)
            if not s:
                del self._where[key]

    def reindex(self, removed: int) -> None:
        """Shift indices above a removed replica down by one, as the
        Router compacts its replica list."""
        self._where = {
            key: {i - 1 if i > removed else i for i in s}
            for key, s in self._where.items()}

    def stats(self) -> dict:
        return {"keys": len(self._where), "records": self.records,
                "narrowed": self.narrowed, "misses": self.misses}
