"""Compressed gradient wires and the cold-page codec
(tpu_ddp/parallel/compress.py).

Gradient wires (:class:`GradCompressor`, ``SPECS``), wrapping any syncing
rung of the ladder with a reduced wire format and f32 accumulation:

- ``none``: no-op (the f32 baseline);
- ``bf16``: gradients cross the wire as ``torch.bfloat16`` (JAX bitcasts
  them to u16 so XLA cannot widen the collective; gloo has no 16-bit
  integer type, and both gloo and NCCL carry bf16 as it is), the mean is
  taken in f32;
- ``int8``: blockwise int8 (one f32 scale per ``block_size`` elements,
  ``max|x| / 127``) with stochastic rounding and an error-feedback
  residual: each rank adds the quantization error it made to its next
  step's gradient, so the wire's bias telescopes away;
- ``int8-noef``: int8 without the residual (the ablation).

The wire is built from movement collectives, as in JAX: phase 1 an
``all_to_all`` of the quantized rows (each rank receives every peer's
row of ITS 1/N chunk and means them in f32), phase 2 the owner
re-quantizes its chunk's mean and ``all_gather``\\ s it. The replicated
rungs take both phases (:meth:`GradCompressor.sync_replicated`: one pair
per leaf on all_reduce, one for the whole concatenated tree on fused, a
full-payload all_gather on gather_scatter); ZeRO and FSDP stop after
phase 1 (:meth:`GradCompressor.scatter_mean`), which hands them the
flat padded mean slices ``parallel/zero.py`` consumes. Error feedback
charges rank i its phase-1 error plus N times its phase-2 error on the
chunk it owns, so the mean of the residuals is the whole error.

The int8 carry is ``{"seed": 0-d int64 tensor, "residual": [...]}``
(each rank's residual, leaves in canonical shapes). A step writes the
new carry into the carry's own tensors (:meth:`GradCompressor.commit`),
so a step captured in a CUDA graph reads and writes the same tensors on
every replay. The seed stays on the device, so a guard-skipped step
keeps the old seed and residual with ``where`` and no host read. The
rounding noise is a counter hash of (seed, rank, leaf, phase, element)
in integer tensor arithmetic: the same bits on the CPU and the card,
though not ``jax.random``'s, so int8 is held to JAX by its properties
(per-element error within one block step, unbiased rounding, exact
zeros, error feedback against drift), not bit for bit. In a checkpoint
the carry is the JAX package's: ``seed`` a uint32 and each residual leaf
``(dp, *shape)``.

The point-to-point edge codec of the MPMD pipeline (:class:`EdgeCodec`,
``EDGE_SPECS``; parallel/mpmd.py) ships one activation or cotangent per
tick in the same formats, plus ``sparse`` (lossless zero-chunk elision
on the host, a packed bitmap of the nonzero ``block_size`` chunks and
only those chunks at f32: the payload's size depends on the data, which
a collective's cannot). An edge's int8 error feedback is sender state:
each tick's quantization error joins the next payload on the same edge.
Its wires are dicts of arrays in the JAX package's layout (the bf16
payload the bf16 bits viewed as ``uint16``, int8 ``q`` and per-block
``scale``), so a pickled wire from either package decodes in the other;
the int8 noise is the counter hash above, keyed by the edge's counter.

The cold-page codec of the tiered KV pool (``page_quantize``,
``page_dequantize``) is the same per-block symmetric int8 with
deterministic round-half-to-even (``torch.round``, as ``jnp.round``): a
KV page demoted and promoted twice dequantizes identically both times.
The scale is per (layer, page, token row), so one row's outlier cannot
flatten its neighbours' resolution.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["SPECS", "EDGE_SPECS", "REPLICATED_KINDS", "GradCompressor",
           "EdgeCodec", "get_compressor", "page_quantize", "page_dequantize"]

SPECS = ("none", "bf16", "int8", "int8-noef")
# Point-to-point wires only (EdgeCodec): "sparse" sizes its payload from
# the data, which the collectives' static shapes cannot carry.
EDGE_SPECS = SPECS + ("sparse",)
# Replicated rungs the compressor wraps; ZeRO and FSDP use scatter_mean.
REPLICATED_KINDS = ("gather_scatter", "all_reduce", "fused")

_M32 = 0xFFFFFFFF


def _mul32(h, c: int):
    """``(h * c) mod 2**32`` for int64 tensors ``h`` in [0, 2**32) and a
    32-bit constant, without int64 overflow."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h):
    """MurmurHash3's 32-bit finalizer on int64 tensors."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def get_compressor(spec: str | None, block_size: int = 256
                   ) -> "GradCompressor":
    """Resolve a compressor spec string (None == 'none')."""
    return GradCompressor(spec or "none", block_size=block_size)


def _world(group):
    return dist.get_world_size(group), dist.get_rank(group)




def _all_gather(x, group, n):
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous().view(-1), group=group)
    return out.view((n,) + tuple(x.shape))


class GradCompressor:
    """Gradient wire compression for one sync rung. Leaves are canonical
    tensors in an order every rank agrees on; collectives run over
    ``group``."""

    def __init__(self, spec: str = "none", block_size: int = 256):
        if spec not in SPECS:
            raise ValueError(
                f"unknown grad_compress spec {spec!r}; available: "
                f"{list(SPECS)}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.spec = spec
        self.block_size = int(block_size)
        self.is_int8 = spec.startswith("int8")
        self.error_feedback = spec == "int8"
        self.stateful = self.is_int8

    # ---- carried state --------------------------------------------------

    def init_state(self, shapes, device, seed: int = 0):
        """This rank's fresh carry, or None when stateless."""
        if not self.stateful:
            return None
        state = {"seed": torch.tensor(int(seed) & _M32, dtype=torch.int64,
                                      device=device)}
        if self.error_feedback:
            state["residual"] = [torch.zeros(s, dtype=torch.float32,
                                             device=device) for s in shapes]
        return state

    def state_to_host(self, comp, group) -> dict:
        """The carry in the JAX package's host form: ``seed`` a uint32,
        each residual leaf ``(dp, *shape)`` (every rank's, gathered: a
        collective every rank enters)."""
        host = {"seed": np.uint32(int(comp["seed"].item()))}
        if "residual" in comp:
            n, _ = _world(group)
            host["residual"] = [_all_gather(r, group, n).cpu().numpy()
                                for r in comp["residual"]]
        return host

    def state_from_host(self, host, rank: int, device):
        """This rank's carry from :meth:`state_to_host`'s form."""
        state = {"seed": torch.tensor(int(host["seed"]), dtype=torch.int64,
                                      device=device)}
        if self.error_feedback:
            state["residual"] = [
                torch.as_tensor(np.array(r[rank], np.float32)).to(device)
                for r in host["residual"]]
        return state

    @staticmethod
    @torch.no_grad()
    def commit(skip, old, new):
        """The step's new carry written into ``old``'s own tensors, in
        place, and ``old`` returned (None when stateless). A
        guard-skipped step must not consume the carry: where ``skip`` is
        nonzero (on the device) the old seed and residual stay."""
        if new is None:
            return old
        pairs = [(old["seed"], new["seed"])]
        if "residual" in new:
            pairs += list(zip(old["residual"], new["residual"]))
        keep = None if skip is None else skip != 0
        for o, n in pairs:
            o.copy_(n if keep is None else torch.where(keep, o, n))
        return old

    # ---- quantization ---------------------------------------------------

    @staticmethod
    def key(seed, rank: int, leaf: int, phase: int = 0):
        """The rounding key of (step seed, rank, leaf, phase): a 0-d int64
        tensor on the seed's device."""
        h = _fmix32(seed ^ 0x3C6EF372)
        for v in (rank, leaf, phase):
            h = _fmix32(h ^ _mul32(torch.full_like(h, v), 0x9E3779B9))
        return h

    @staticmethod
    def uniform(shape, key):
        """f32 noise in [0, 1) of ``shape`` from ``key``: a hash of the
        element index (the same bits on every device)."""
        n = int(np.prod(shape))
        idx = torch.arange(n, dtype=torch.int64, device=key.device)
        h = _fmix32(_fmix32(_mul32(idx, 0x27D4EB2F) ^ key) ^ key)
        return ((h >> 8).to(torch.float32) * (1.0 / (1 << 24))).view(shape)

    def quant(self, x, u):
        """Blockwise int8 over the last axis (a multiple of
        ``block_size``): scale = max|x| / 127 per block, stochastic
        rounding ``floor(x / scale + u)`` with noise ``u``."""
        b = self.block_size
        blk = x.reshape(x.shape[:-1] + (-1, b))
        amax = blk.abs().amax(dim=-1)
        # A tensor divisor: CUDA turns division by a Python scalar into a
        # multiply by its reciprocal, which rounds otherwise than the CPU.
        scale = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-30)
        q = torch.clamp(torch.floor(blk / scale[..., None]
                                    + u.reshape(blk.shape)), -127, 127)
        return q.to(torch.int8).reshape(x.shape), scale

    def dequant(self, q, scale):
        b = self.block_size
        blk = q.to(torch.float32).reshape(q.shape[:-1] + (-1, b))
        return (blk * scale[..., None]).reshape(q.shape)

    def _qchunk(self, chunk: int) -> int:
        b = self.block_size
        return -(-chunk // b) * b

    # ---- the phases (launch, then finish) -------------------------------

    def phase1_launch(self, flat, chunk: int, group, key=None) -> dict:
        """Start phase 1 on ``flat`` ((N * chunk,) f32): the quantized
        rows' ``all_to_all`` (async). Returns the pending handles and,
        for int8, this rank's phase-1 error."""
        n, _ = _world(group)
        rows = flat.view(n, chunk)
        if self.spec == "bf16":
            send = rows.to(torch.bfloat16)
            recv = torch.empty_like(send)
            work = dist.all_to_all_single(recv, send, group=group,
                                          async_op=True)
            return {"works": [work], "recv": recv, "chunk": chunk}
        qchunk = self._qchunk(chunk)
        rows_q = torch.nn.functional.pad(rows, (0, qchunk - chunk))
        q, s = self.quant(rows_q, self.uniform(rows_q.shape, key))
        err = (rows - self.dequant(q, s)[:, :chunk]).reshape(-1)
        rq, rs = torch.empty_like(q), torch.empty_like(s)
        works = [dist.all_to_all_single(rq, q, group=group, async_op=True),
                 dist.all_to_all_single(rs, s.contiguous(), group=group,
                                        async_op=True)]
        return {"works": works, "recv": (rq, rs), "chunk": chunk,
                "err": err}

    def phase1_finish(self, pend):
        """Wait for phase 1; this rank's chunk of the f32 mean."""
        for w in pend["works"]:
            w.wait()
        chunk = pend["chunk"]
        if self.spec == "bf16":
            return pend["recv"].float().mean(dim=0)
        rq, rs = pend["recv"]
        return self.dequant(rq, rs)[:, :chunk].mean(dim=0)

    def phase2(self, m, group, key=None):
        """The broadcast phase: this rank's chunk mean re-quantized and
        all-gathered -> the (N * chunk,) mean, plus the owner's phase-2
        error for int8."""
        n, _ = _world(group)
        chunk = m.shape[0]
        if self.spec == "bf16":
            return _all_gather(m.to(torch.bfloat16), group, n
                               ).float().reshape(-1), None
        qchunk = self._qchunk(chunk)
        mq = torch.nn.functional.pad(m, (0, qchunk - chunk))
        q, s = self.quant(mq, self.uniform(mq.shape, key))
        out = self.dequant(_all_gather(q, group, n), _all_gather(s, group, n))
        return out[:, :chunk].reshape(-1), m - self.dequant(q, s)[:chunk]

    def gather_all_launch(self, flat, group, key=None) -> dict:
        """gather_scatter's wire: every rank's whole payload all-gathered
        (async), each replica means locally."""
        n, _ = _world(group)
        if self.spec == "bf16":
            send = flat.to(torch.bfloat16)
            recv = torch.empty((n,) + tuple(send.shape), dtype=send.dtype,
                               device=send.device)
            work = dist.all_gather_into_tensor(recv.view(-1), send,
                                               group=group, async_op=True)
            return {"works": [work], "recv": recv, "total": flat.numel()}
        total = flat.numel()
        padded = torch.nn.functional.pad(flat, (0, self._qchunk(total)
                                                - total))
        q, s = self.quant(padded, self.uniform(padded.shape, key))
        err = flat - self.dequant(q, s)[:total]
        rq = torch.empty((n,) + tuple(q.shape), dtype=q.dtype,
                         device=q.device)
        rs = torch.empty((n,) + tuple(s.shape), dtype=s.dtype,
                         device=s.device)
        works = [dist.all_gather_into_tensor(rq.view(-1), q, group=group,
                                             async_op=True),
                 dist.all_gather_into_tensor(rs.view(-1), s.contiguous(),
                                             group=group, async_op=True)]
        return {"works": works, "recv": (rq, rs), "total": total,
                "err": err}

    def gather_all_finish(self, pend):
        for w in pend["works"]:
            w.wait()
        if self.spec == "bf16":
            return pend["recv"].float().mean(dim=0)
        rq, rs = pend["recv"]
        return self.dequant(rq, rs)[:, :pend["total"]].mean(dim=0)

    # ---- the synchronous entry points -----------------------------------

    def _acc(self, comp, i, g):
        flat = g.detach().to(torch.float32).reshape(-1)
        if self.error_feedback:
            flat = flat + comp["residual"][i].reshape(-1)
        return flat

    def _two_phase(self, flat, group, key, rank):
        """The full compressed mean of a flat payload: (mean, error of
        this rank, owner-attributed) for int8, (mean, None) for bf16."""
        n, _ = _world(group)
        total = flat.numel()
        chunk = -(-total // n)
        padded = torch.nn.functional.pad(flat, (0, n * chunk - total))
        k1 = k2 = None
        if self.is_int8:
            k1, k2 = (self.key(key[0], rank, key[1], p) for p in (1, 2))
        pend = self.phase1_launch(padded, chunk, group, k1)
        m = self.phase1_finish(pend)
        out, e2 = self.phase2(m, group, k2)
        err = None
        if self.is_int8:
            err = pend["err"].clone()
            err[rank * chunk:(rank + 1) * chunk] += n * e2
            err = err[:total]
        return out[:total], err

    def _new_comp(self, comp, errs, shapes):
        new = {"seed": comp["seed"] + 1}
        if self.error_feedback:
            new["residual"] = [e.reshape(s) for e, s in zip(errs, shapes)]
        return new

    def sync_replicated(self, kind, grads, comp, group):
        """The compressed replacement of a replicated rung's sync:
        ``(grads, comp) -> (the synced f32 grads, new comp)``; every
        replica ends with the same bytes."""
        if kind not in REPLICATED_KINDS:
            raise ValueError(f"sync_replicated got kind {kind!r}; "
                             f"expected one of {REPLICATED_KINDS}")
        if self.spec == "none":
            raise ValueError("sync_replicated on a 'none' compressor; "
                             "use the rung's sync")
        n, rank = _world(group)
        shapes = [tuple(g.shape) for g in grads]
        flats = [self._acc(comp, i, g) for i, g in enumerate(grads)]
        outs, errs = [], []
        seed = comp["seed"] if comp is not None else None
        if kind == "fused" and self.is_int8:
            sizes = [f.numel() for f in flats]
            m, err = self._two_phase(torch.cat(flats), group, (seed, 0),
                                     rank)
            outs = list(torch.split(m, sizes))
            errs = list(torch.split(err, sizes))
        else:
            for i, flat in enumerate(flats):
                if kind == "gather_scatter":
                    key = (self.key(seed, rank, i) if self.is_int8
                           else None)
                    pend = self.gather_all_launch(flat, group, key)
                    m = self.gather_all_finish(pend)
                    err = pend.get("err")
                else:
                    m, err = self._two_phase(flat, group, (seed, i), rank)
                outs.append(m)
                errs.append(err)
        outs = [o.reshape(s) for o, s in zip(outs, shapes)]
        if not self.is_int8:
            return outs, None
        return outs, self._new_comp(comp, errs, shapes)

    def scatter_mean(self, grads, comp, group):
        """The compressed reduce-scatter of ZeRO and FSDP (phase 1 only):
        ``(grads, comp) -> (per-leaf (ceil(size/N),) f32 mean slices,
        new comp)``, the flat padded layout of ``parallel/zero.py``."""
        n, rank = _world(group)
        shapes = [tuple(g.shape) for g in grads]
        outs, errs = [], []
        for i, g in enumerate(grads):
            flat = self._acc(comp, i, g)
            size = flat.numel()
            chunk = -(-size // n)
            padded = torch.nn.functional.pad(flat, (0, n * chunk - size))
            key = (self.key(comp["seed"], rank, i) if self.is_int8
                   else None)
            pend = self.phase1_launch(padded, chunk, group, key)
            outs.append(self.phase1_finish(pend))
            if self.is_int8:
                errs.append(pend["err"][:size])
        if not self.is_int8:
            return outs, None
        return outs, self._new_comp(comp, errs, shapes)


class EdgeCodec:
    """Wire codec of ONE directed MPMD edge (JAX ``EdgeCodec``).

    Stateful on the sender (the int8 rounding counter and the optional
    error-feedback residual); :meth:`decode` is stateless. ``encode``
    returns ``(wire, nbytes)``: ``wire`` a dict of the tensors (numpy
    arrays for ``sparse``) that travel, ``nbytes`` their payload bytes
    (f32 would be ``4 * x.numel()``)."""

    def __init__(self, spec: str = "none", block_size: int = 256,
                 seed: int = 0):
        if spec not in EDGE_SPECS:
            raise ValueError(
                f"unknown edge codec spec {spec!r}; available: "
                f"{list(EDGE_SPECS)}")
        self.spec = spec
        self.is_int8 = spec.startswith("int8")
        self.error_feedback = spec == "int8"
        # The quantizer (and block_size's validation) of the collectives.
        self._k = GradCompressor("int8" if self.is_int8 else "none",
                                 block_size=block_size)
        self.block_size = self._k.block_size
        self._seed = int(seed) & _M32
        self._residual = None   # sized to the edge's payload at first use
        self.bytes_sent = 0     # cumulative wire bytes
        self.bytes_dense = 0    # what f32 would have cost

    def describe(self) -> dict:
        return {"spec": self.spec,
                "block_size": self.block_size if self.is_int8 else None,
                "error_feedback": self.error_feedback}

    @property
    def ratio(self) -> float:
        """Dense over wire bytes so far (1.0 before any traffic)."""
        return (self.bytes_dense / self.bytes_sent
                if self.bytes_sent else 1.0)

    def reset(self) -> None:
        """Drop the carried state: a new edge peer must not inherit a
        residual accumulated against the old one."""
        self._residual = None
        self.bytes_sent = 0
        self.bytes_dense = 0

    # ---- sender ----------------------------------------------------------

    @torch.no_grad()
    def encode(self, x) -> tuple[dict, int]:
        x = torch.as_tensor(x).detach().to(torch.float32)
        self.bytes_dense += 4 * x.numel()
        if self.spec == "none":
            wire, nbytes = {"kind": "none", "payload": x}, 4 * x.numel()
        elif self.spec == "bf16":
            wire = {"kind": "bf16",
                    "payload": x.to(torch.bfloat16).view(torch.uint16)}
            nbytes = 2 * x.numel()
        elif self.spec == "sparse":
            wire, nbytes = self._encode_sparse(x)
        else:
            wire, nbytes = self._encode_int8(x)
        self.bytes_sent += nbytes
        return wire, nbytes

    def _encode_sparse(self, x) -> tuple[dict, int]:
        """Lossless zero-chunk elision on the host: the flat f32 payload
        cut into ``block_size`` chunks, a packed bitmap of the chunks
        holding a nonzero, and only those chunks."""
        b = self.block_size
        flat = x.cpu().numpy().reshape(-1)
        n = max(1, -(-flat.size // b))
        padded = np.zeros((n * b,), np.float32)
        padded[:flat.size] = flat
        rows = padded.reshape(n, b)
        nz = np.any(rows != 0.0, axis=1)
        mask = np.packbits(nz)
        wire = {"kind": "sparse", "payload": rows[nz], "mask": mask,
                "chunks": n, "chunk": b, "shape": tuple(x.shape)}
        return wire, 4 * int(nz.sum()) * b + int(mask.size)

    def _encode_int8(self, x) -> tuple[dict, int]:
        flat = x.reshape(-1)
        if self.error_feedback:
            if (self._residual is None
                    or self._residual.shape != flat.shape
                    or self._residual.device != flat.device):
                self._residual = torch.zeros_like(flat)
            flat = flat + self._residual
        n = flat.numel()
        padded = torch.nn.functional.pad(flat, (0, self._k._qchunk(n) - n))
        seed = torch.tensor(self._seed, dtype=torch.int64, device=x.device)
        self._seed = (self._seed + 1) & _M32
        q, scale = self._k.quant(padded, self._k.uniform(
            padded.shape, self._k.key(seed, 0, 0)))
        if self.error_feedback:
            self._residual = flat - self._k.dequant(q, scale)[:n]
        wire = {"kind": "int8", "q": q, "scale": scale,
                "shape": tuple(x.shape)}
        return wire, q.numel() + 4 * scale.numel()

    # ---- receiver (stateless) --------------------------------------------

    @staticmethod
    @torch.no_grad()
    def decode(wire: dict, device=None):
        """The f32 payload of ``wire`` (tensors or numpy arrays, this
        package's or the JAX package's), on ``device`` (where the wire's
        tensors are when None; the CPU for ``sparse``)."""
        def t(v):
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.array(v))  # a writable copy
            return v if device is None else v.to(device)

        kind = wire["kind"]
        if kind == "none":
            return t(wire["payload"]).to(torch.float32)
        if kind == "bf16":
            return t(wire["payload"]).view(torch.bfloat16).to(torch.float32)
        shape = tuple(wire["shape"])
        size = int(np.prod(shape)) if shape else 1
        if kind == "int8":
            q, scale = t(wire["q"]), t(wire["scale"])
            k = GradCompressor("int8", block_size=q.numel() // scale.numel())
            return k.dequant(q, scale)[:size].reshape(shape)
        if kind == "sparse":
            n, b = int(wire["chunks"]), int(wire["chunk"])
            nz = np.unpackbits(np.asarray(wire["mask"]),
                               count=n).astype(bool)
            rows = np.zeros((n, b), np.float32)
            if nz.any():
                rows[nz] = np.asarray(wire["payload"],
                                      np.float32).reshape(-1, b)
            return t(rows.reshape(-1)[:size].reshape(shape))
        raise ValueError(f"unknown edge wire kind {kind!r}")


def page_quantize(x, cold_dtype, amax=None):
    """Quantize KV pages ``x`` (..., bs, KV, hd) for cold storage.

    Returns ``(q, scale)`` with ``scale`` f32 shaped like ``x`` minus the
    two trailing (KV, hd) axes. ``cold_dtype`` ``torch.int8`` -> per-row
    symmetric int8; ``torch.bfloat16`` -> a plain downcast with unit
    scales (lossless when the hot dtype is already bf16). ``amax``: each
    row's max |x| where ``x`` holds only some of the row's heads (a tp
    rank's; the max over every head), default ``x``'s own."""
    if cold_dtype == torch.bfloat16:
        return (x.to(torch.bfloat16),
                torch.ones(x.shape[:-2], dtype=torch.float32,
                           device=x.device))
    if cold_dtype != torch.int8:
        raise ValueError(f"cold dtype {cold_dtype}: expected torch.int8 "
                         "or torch.bfloat16")
    xf = x.to(torch.float32)
    if amax is None:
        amax = page_row_amax(xf)
    scale = torch.clamp_min(amax / 127.0, 1e-30)
    q = torch.clamp(torch.round(xf / scale[..., None, None]), -127, 127)
    return q.to(torch.int8), scale


def page_row_amax(x):
    """Each token row's max |x| over its (KV, hd) axes, f32: what
    :func:`page_quantize` scales a row by."""
    return x.to(torch.float32).abs().amax(dim=(-2, -1))


def page_dequantize(q, scale, out_dtype):
    """Inverse of :func:`page_quantize`: (..., bs, KV, hd) pages back in
    ``out_dtype`` (the pool's hot dtype)."""
    return (q.to(torch.float32) * scale[..., None, None]).to(out_dtype)
