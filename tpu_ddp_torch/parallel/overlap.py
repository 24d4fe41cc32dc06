"""Overlapped bucketed gradient collectives and the cross-replica sharded
update (tpu_ddp/parallel/overlap.py).

The reference's part 3 is torch DDP's reducer: parameters go into ~25 MB
buckets in REVERSE registration order, and a bucket's collective starts
from an autograd hook the moment its last gradient is produced, so the
communication runs under the rest of the backward. This module does that
explicitly for the replicated rungs, with the JAX package's semantics:

- :class:`BucketPlan` cuts the leaves, in the reversed canonical order,
  greedily into buckets of about ``bucket_mb`` MiB of f32 payload (a leaf
  larger than the target gets its own): bucket 0 holds the output-side
  leaves whose gradients the backward produces first. The same cuts as
  JAX's plan on the same leaves.
- :class:`OverlapSync` registers a ``register_post_accumulate_grad_hook``
  on every parameter (JAX's custom-vjp "taps"). The hook that completes a
  bucket launches that bucket's collective with ``async_op=True``;
  buckets launch strictly in index order (a bucket that completes early
  waits for the ones before it), so every rank issues the same sequence.
  :meth:`OverlapSync.finish` waits on the handles after the backward.
- On all_reduce and fused (``SCATTER_KINDS``) the bucket collective is a
  reduce-scatter, and :class:`ShardedUpdate` finishes it: the optimizer
  on this rank's 1/N of each bucket's payload, then an all-gather of the
  fresh parameters (arXiv 2004.13336). gather_scatter keeps its
  root-mean semantics (all-gather, the mean, rank 0's broadcast) and a
  replicated update.

Compression composes per bucket (parallel/compress.py): the payload
travels as bf16 or int8, and with int8 the hook also counts the raw
gradients' non-finite entries for the step guard, since a NaN can vanish
in the int8 cast; the error-feedback residual keeps the unbucketed
compressor's per-leaf layout.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.distributed as dist

OVERLAP_KINDS = ("gather_scatter", "all_reduce", "fused")
SCATTER_KINDS = ("all_reduce", "fused")


@dataclasses.dataclass(frozen=True)
class _LeafMeta:
    shape: tuple
    size: int


class BucketPlan:
    """Size-targeted partition of leaves (canonical shapes, in the order
    every rank agrees on) in reverse order: ``buckets[k]`` is a tuple of
    leaf indices, bucket 0 the output side."""

    def __init__(self, shapes, bucket_mb: int | float):
        if bucket_mb <= 0:
            raise ValueError(f"bucket_mb must be > 0, got {bucket_mb}")
        if not shapes:
            raise ValueError("cannot bucket an empty list of leaves")
        self.bucket_mb = bucket_mb
        self.metas = tuple(_LeafMeta(tuple(int(d) for d in s),
                                     math.prod(s)) for s in shapes)
        target = int(bucket_mb * (1 << 20))
        buckets, cur, cur_bytes = [], [], 0
        for i in reversed(range(len(self.metas))):
            nbytes = self.metas[i].size * 4       # f32 wire bytes
            if cur and cur_bytes + nbytes > target:
                buckets.append(tuple(cur))
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += nbytes
        if cur:
            buckets.append(tuple(cur))
        self.buckets = tuple(buckets)

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    def bucket_sizes(self) -> list:
        """Payload element count per bucket."""
        return [sum(self.metas[i].size for i in b) for b in self.buckets]

    def describe(self) -> dict:
        sizes = self.bucket_sizes()
        return {"bucket_mb": self.bucket_mb, "n_buckets": self.n_buckets,
                "n_leaves": len(self.metas),
                "bucket_bytes": [s * 4 for s in sizes],
                "bucket_leaf_counts": [len(b) for b in self.buckets]}

    def payload(self, leaves, k: int):
        """Bucket ``k``'s leaves as one flat f32 payload."""
        return torch.cat([leaves[i].detach().to(torch.float32).reshape(-1)
                          for i in self.buckets[k]])

    def split(self, flat, k: int) -> list:
        """A bucket payload back into its leaves (canonical shapes)."""
        out, off = [], 0
        for i in self.buckets[k]:
            m = self.metas[i]
            out.append(flat[off:off + m.size].view(m.shape))
            off += m.size
        return out


class OverlapSync:
    """Bucketed in-backward gradient sync for one replicated rung.

    :meth:`attach` hooks the parameters (``canon(i, grad)`` gives leaf
    i's gradient in the canonical layout); :meth:`begin` arms a step,
    ``loss.backward()`` launches the buckets, :meth:`finish` returns

    - on the scatter kinds, per bucket this rank's ``(chunk,)`` slice of
      the payload's group mean (``chunk = ceil(size / N)``);
    - on gather_scatter, every leaf's full root mean (canonical);

    plus the new compression carry and, with int8, the raw gradients'
    non-finite count for the guard. ``fired`` records the buckets in the
    order their collectives launched, ``launched_after`` how many of the
    parameters' gradients were ready at each launch (fewer than all:
    the launch came inside the backward)."""

    def __init__(self, plan: BucketPlan, kind: str, group=None,
                 compressor=None):
        if kind not in OVERLAP_KINDS:
            raise ValueError(f"overlap got kind {kind!r}; expected one of "
                             f"{OVERLAP_KINDS}")
        self.plan = plan
        self.kind = kind
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.scatter = kind in SCATTER_KINDS
        if compressor is not None and compressor.spec == "none":
            compressor = None
        self.comp = compressor
        self._bucket_of = {i: k for k, b in enumerate(plan.buckets)
                           for i in b}
        self._hooks = []
        self._armed = False
        self.fired: list = []
        self.launched_after: list = []

    def attach(self, params, canon) -> None:
        """Hook ``params`` (leaf order of the plan)."""
        self._params = list(params)
        self._canon = canon
        self._hooks = [p.register_post_accumulate_grad_hook(
            functools.partial(self._ready, i))
            for i, p in enumerate(self._params)]

    def detach(self) -> None:
        for h in self._hooks:
            h.remove()
        self._hooks = []

    def begin(self, comp_state=None) -> None:
        B = self.plan.n_buckets
        self._left = [len(b) for b in self.plan.buckets]
        self._done = [False] * B
        self._next = 0
        self._pend = [None] * B
        self._comp_state = comp_state
        self.fired = []
        self.launched_after = []
        self._seen = 0
        self._armed = True

    def _ready(self, i, param) -> None:
        if not self._armed:
            return
        self._seen += 1
        k = self._bucket_of[i]
        self._left[k] -= 1
        if self._left[k]:
            return
        self._done[k] = True
        while self._next < self.plan.n_buckets and self._done[self._next]:
            self._launch(self._next)
            self._next += 1

    def _launch(self, k: int) -> None:
        grads = {i: self._canon(i, self._params[i].grad)
                 for i in self.plan.buckets[k]}
        flat = torch.cat([grads[i].to(torch.float32).reshape(-1)
                          for i in self.plan.buckets[k]])
        total = flat.numel()
        n, comp = self.n, self.comp
        pend = {"total": total}
        key = None
        if comp is not None and comp.is_int8:
            # From the RAW gradients: a NaN can vanish in the int8 cast.
            pend["flag"] = (~torch.isfinite(flat)).sum().to(torch.float32)
            if comp.error_feedback:
                res = self._comp_state["residual"]
                flat = flat + torch.cat([res[i].reshape(-1)
                                         for i in self.plan.buckets[k]])
            key = comp.key(self._comp_state["seed"], self.rank, k)
        if self.scatter:
            chunk = -(-total // n)
            padded = torch.nn.functional.pad(flat, (0, n * chunk - total))
            pend["chunk"] = chunk
            if comp is None:
                out = torch.empty(chunk, dtype=torch.float32,
                                  device=flat.device)
                pend["out"] = out
                pend["works"] = [dist.reduce_scatter_tensor(
                    out, padded, op=dist.ReduceOp.SUM, group=self.group,
                    async_op=True)]
            else:
                pend["wire"] = comp.phase1_launch(padded, chunk,
                                                  self.group, key)
        elif comp is None:
            out = torch.empty(n, total, dtype=torch.float32,
                              device=flat.device)
            pend["out"] = out
            pend["works"] = [dist.all_gather_into_tensor(
                out.view(-1), flat, group=self.group, async_op=True)]
        else:
            pend["wire"] = comp.gather_all_launch(flat, self.group, key)
        self._pend[k] = pend
        self.fired.append(k)
        self.launched_after.append(self._seen)

    def finish(self):
        """Wait for every bucket; ``(results, new_comp, extra_bad)``."""
        self._armed = False
        if self._next != self.plan.n_buckets:
            raise RuntimeError(
                f"only {self._next} of {self.plan.n_buckets} buckets "
                "launched in the backward: a parameter got no gradient")
        comp, n = self.comp, self.n
        results, errs, flags = [], {}, []
        for k, pend in enumerate(self._pend):
            if comp is None:
                for w in pend["works"]:
                    w.wait()
                if self.scatter:
                    res = pend["out"] / n
                else:
                    mean = pend["out"].mean(dim=0)
                    # The root's mean, broadcast: the rung's semantics.
                    dist.broadcast(mean, src=0, group=self.group)
                    res = mean
            elif self.scatter:
                res = comp.phase1_finish(pend["wire"])
            else:
                res = comp.gather_all_finish(pend["wire"])
            if not self.scatter:
                res = self.plan.split(res, k)
            results.append(res)
            if comp is not None and comp.is_int8:
                flags.append(pend["flag"])
                if comp.error_feedback:
                    err = pend["wire"]["err"][:pend["total"]]
                    for i, e in zip(self.plan.buckets[k],
                                    self.plan.split(err, k)):
                        errs[i] = e
        if comp is None or not comp.is_int8:
            return results, None, None
        old = self._comp_state
        new = {"seed": old["seed"] + 1}
        if comp.error_feedback:
            new["residual"] = [errs[i].reshape(r.shape)
                               for i, r in enumerate(old["residual"])]
        return results, new, torch.stack(flags).sum()


class ShardedUpdate:
    """The optimizer on this rank's 1/N of each bucket payload (state
    ``(chunk_k,)`` per bucket), then an all-gather of the parameters.

    The inner optimizer must decay uniformly (SGD): a per-leaf decay mask
    cannot survive payload flattening. Elementwise updates commute with
    slicing, so the result is the replicated update's, bit for bit; the
    padded tail stays zero (zero parameter, gradient and momentum)."""

    def __init__(self, inner, plan: BucketPlan, group=None):
        if inner.decay_mask([]) is not None:
            raise NotImplementedError(
                "the sharded update supports uniformly-decaying "
                "optimizers only (SGD): a per-leaf decay mask cannot "
                "survive payload flattening")
        self.inner = inner
        self.plan = plan
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.chunks = [-(-s // self.n) for s in plan.bucket_sizes()]

    def init(self, device):
        return self.inner.init([torch.zeros(c, dtype=torch.float32,
                                            device=device)
                                for c in self.chunks])

    def shard(self, leaves, k: int):
        """This rank's slice of bucket ``k``'s payload of ``leaves``."""
        flat = self.plan.payload(leaves, k)
        c = self.chunks[k]
        flat = torch.nn.functional.pad(flat, (0, self.n * c - flat.numel()))
        return flat[self.rank * c:(self.rank + 1) * c].clone()

    def apply_scattered(self, params, g_sh, state, skip=None,
                        clip_norm=None) -> list:
        """``params``: canonical full leaves; ``g_sh``: per bucket this
        rank's mean slice (:meth:`OverlapSync.finish`). Returns the new
        canonical leaves, the same on every rank."""
        if clip_norm is not None:
            from tpu_ddp_torch.ops.optim import clip_scale_from_sq
            sq = torch.stack([g.square().sum() for g in g_sh]).sum()
            dist.all_reduce(sq, op=dist.ReduceOp.SUM, group=self.group)
            torch._foreach_mul_(g_sh, clip_scale_from_sq(sq, clip_norm))
        p_sh = [self.shard(params, k) for k in range(self.plan.n_buckets)]
        kw = {} if skip is None else {"skip": skip}
        self.inner.apply(p_sh, g_sh, state, **kw)
        out = [None] * len(self.plan.metas)
        for k, sh in enumerate(p_sh):
            full = torch.empty(self.n * sh.numel(), dtype=sh.dtype,
                               device=sh.device)
            dist.all_gather_into_tensor(full, sh, group=self.group)
            for i, leaf in zip(self.plan.buckets[k],
                               self.plan.split(full, k)):
                out[i] = leaf
        return out

    # ---- host-side layout converters (checkpoint) -----------------------

    def gather_state(self, shards) -> list:
        """Every rank's per-bucket state slices -> the global
        ``(N * chunk_k,)`` payloads (numpy; a collective)."""
        out = []
        for sh in shards:
            full = torch.empty(self.n * sh.numel(), dtype=sh.dtype,
                               device=sh.device)
            dist.all_gather_into_tensor(full, sh.contiguous(),
                                        group=self.group)
            out.append(full.cpu().numpy())
        return out

    def canonicalize_opt_host(self, payloads) -> list:
        """Global payloads -> canonical leaves (plan order)."""
        leaves = [None] * len(self.plan.metas)
        for k, flat in enumerate(payloads):
            for i, leaf in zip(self.plan.buckets[k],
                               self.plan.split(torch.from_numpy(
                                   np.asarray(flat)), k)):
                leaves[i] = leaf.numpy()
        return leaves

    def local_opt(self, leaves, device) -> list:
        """Canonical host leaves -> this rank's per-bucket slices."""
        t = [torch.as_tensor(np.asarray(x, np.float32)) for x in leaves]
        return [self.shard(t, k).to(device)
                for k in range(self.plan.n_buckets)]
