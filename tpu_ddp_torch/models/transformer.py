"""Decoder-only transformer LM (tpu_ddp/models/transformer.py): the
decode path and the training forward of the dense model, on one device.

Same conventions as the JAX package: parameters are a plain dict of
tensors in the JAX layouts (``wqkv`` (dm, 3, H, hd), ``wo`` (H, hd, dm),
``w1`` (dm, d_ff), ...), f32 parameters with a bf16 compute dtype, f32
softmax/LN statistics, and a frozen dataclass for the static config.

Serving projects through ops/quant.py ``qdot`` (f32 products, or the int8
kernel). The training forward (:meth:`TransformerLM.apply`) projects
through :func:`train_dot`: one matmul of compute-dtype operands with f32
sums — in f32 the JAX package's f32 dot exactly; in bf16 a bf16 GEMM
whose output stays f32 where the JAX package keeps its
``preferred_element_type=jnp.float32`` result (the ``w1`` output, which
is the GELU input, and the logits) and is rounded to bf16 where JAX casts
it back (qkv, ``wo``, ``w2``). Attention goes through
``parallel/ring_attention.py:attend``, to the flash kernels when
``use_flash``. The memory policy (``remat``, ``act_dtype``;
memory/policy.py) and inverted dropout on the embedding and both
residual branches apply inside :meth:`TransformerLM.trunk_with_aux`.

Mixture of experts (``moe_experts > 0``): every block's MLP is the routed
layer of parallel/moe.py (stacked ``w1`` (E, dm, dff) and ``w2`` (E, dff,
dm) and a ``router`` (dm, E)), and the forward returns the mean of the
blocks' load-balance losses beside its output. Expert parallelism
(:meth:`TransformerLM.with_expert_parallel`) holds ``E / ep`` experts per
process and exchanges the slot queues over the ep process group.

Sequence parallelism (:meth:`TransformerLM.with_sequence_parallel`):
each process of an sp group holds its L/sp chunk of the sequence, its
positions global (the chunk offset ``s * L/sp``), and attention runs
ring or Ulysses attention over the group (parallel/ring_attention.py,
parallel/ulysses.py).

Tensor parallelism (:meth:`TransformerLM.with_tensor_parallel`): each
process of a tp group holds its ``H / tp`` attention heads (``KV / tp``
under GQA) and its ``d_ff / tp`` slice of the MLP (of every expert's,
under MoE), the layout :meth:`TransformerLM.param_specs` gives. Megatron's
``f`` (parallel/tensor_parallel.py ``tp_input``) follows each LayerNorm
and ``g`` (``tp_output``) all-reduces the f32 partial sums of ``wo`` and
``w2`` before they are rounded to the compute dtype, as JAX's ``psum``
of the f32 dot. The residual stream, the LayerNorms, the embedding and
the head stay replicated.

Dropout masks are a counter-based hash computed where the tensor lies:
each mask's key is a pure function of the trainer's (dropout_seed, step,
rank, microbatch) and the mask's (layer, site), folded by :func:`fold_in`
(the JAX ``fold_in`` chain), and each group of four elements takes four
16-bit lanes of ``fold_in(key, group index)``. :func:`fold_in` takes host
ints or int64 device tensors and gives the same bits either way, on the
CPU and on the card, so a step whose count is read from a device tensor
inside a captured CUDA graph draws the masks of the same step run
eagerly, and a checkpoint region that recomputes in the backward draws
the same mask again. The masks match the JAX package's in distribution
(keep share, 1/keep scaling), not bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpu_ddp_torch.memory.policy import (cast_saved, effective_remat,
                                         validate_act_dtype, validate_remat,
                                         wrap_stage)
from tpu_ddp_torch.parallel.redistribute import P
from tpu_ddp_torch.parallel.ring_attention import attend
from tpu_ddp_torch.parallel.tensor_parallel import tp_input, tp_output


_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB


def _s64(c: int) -> int:
    """The unsigned 64-bit ``c`` as the int64 of the same bits."""
    c &= _MASK64
    return c - (1 << 64) if c >= 1 << 63 else c


def _mix_(z):
    """The splitmix64 finaliser of an int64 tensor, in place: int64
    products wrap as the masked host arithmetic does, and each shift is
    made logical by a mask (``>>`` is arithmetic)."""
    t = torch.empty_like(z)
    for s, mul in ((30, _MIX1), (27, _MIX2), (31, None)):
        torch.bitwise_right_shift(z, s, out=t)
        t.bitwise_and_((1 << (64 - s)) - 1)
        z.bitwise_xor_(t)
        if mul is not None:
            z.mul_(_s64(mul))
    return z


def fold_in(key, data):
    """A new 63-bit key from ``key`` and the integer ``data`` (a
    splitmix64 finaliser over the two): the port's counterpart of
    ``jax.random.fold_in`` for dropout keys. Host ints give an int;
    if either is a tensor the result is an int64 tensor on its device
    holding the same value."""
    if not isinstance(key, torch.Tensor) and not isinstance(
            data, torch.Tensor):
        z = (key ^ ((data + 1) * _GOLDEN)) & _MASK64
        z = ((z ^ (z >> 30)) * _MIX1) & _MASK64
        z = ((z ^ (z >> 27)) * _MIX2) & _MASK64
        return (z ^ (z >> 31)) >> 1
    if isinstance(key, torch.Tensor):
        key = key.to(torch.int64)
    else:
        key = _s64(key)
    if isinstance(data, torch.Tensor):
        z = key ^ ((data.to(torch.int64) + 1) * _s64(_GOLDEN))
    else:
        z = key ^ _s64((data + 1) * _GOLDEN)
    return (_mix_(z) >> 1) & ((1 << 63) - 1)


def keep_mask(key, shape, keep: float, device):
    """The bool mask of kept elements for ``key`` (an int or a 0-d int64
    tensor): element ``i`` reads lane ``i % 4`` (little-endian, 16 bits,
    as a signed int16) of the 64-bit splitmix hash of ``(key, i // 4)``
    (:func:`fold_in` before its last shift) and is kept where the lane
    lies below ``round(keep * 2**16) - 2**15``. Plain int64 tensor ops,
    in place on one buffer: the same bits on every device."""
    n = 1
    for d in shape:
        n *= int(d)
    if not isinstance(key, torch.Tensor):
        key = torch.tensor(_s64(key), dtype=torch.int64, device=device)
    z = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    z.add_(1).mul_(_s64(_GOLDEN)).bitwise_xor_(key.to(torch.int64))
    lanes = _mix_(z).view(torch.int16)[:n].reshape(shape)
    return lanes < int(round(keep * 65536)) - 32768


def dropout(x, rate: float, key):
    """Inverted dropout of ``x`` with the mask :func:`keep_mask` draws
    for ``key`` (the identity when ``key`` is None or ``rate`` is 0):
    kept elements scaled by 1/keep in ``x``'s dtype, as the JAX model's
    ``_dropout``."""
    if key is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = keep_mask(key, x.shape, keep, x.device)
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def rope(x, positions, base: float = 10000.0):
    """Rotary position embedding, half-split rotation with f32 angles.
    x: (B, L, H, D); positions: (L,) shared across the batch, or (B, L)
    per row (continuous batching, where every live sequence sits at its
    own offset)."""
    d = x.shape[-1]
    half = d // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]  # (..., L, 1, half)
    sin = torch.sin(angles)[..., None, :]
    if angles.dim() == 2:  # shared (L,) positions: add the batch dim
        cos, sin = cos[None], sin[None]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm in f32 with the population variance, cast back to the
    input dtype."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale
            + bias).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class TransformerLM:
    """GPT-style pre-LN decoder (dense, MHA or GQA). Causal by
    construction."""

    name: str = "TransformerLM"
    vocab_size: int = 32000
    num_layers: int = 4
    num_heads: int = 8
    # Grouped-query attention: K/V get ``num_kv_heads`` heads shared by
    # groups of Q heads. None -> MHA (the fused "wqkv" layout).
    num_kv_heads: int | None = None
    d_model: int = 512
    d_ff: int = 2048
    max_seq_len: int = 2048
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # Mixture of experts: when > 0 every block's MLP is a routed MoE with
    # this many experts (parallel/moe.py); top_k=1 is Switch routing,
    # top_k=2 the GShard scheme.
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_top_k: int = 1
    # Expert parallelism: the axis name and extent the expert axis shards
    # on, and the process group of the ep peers (with_expert_parallel).
    ep_axis: str | None = None
    ep_size: int = 1
    ep_group: object = dataclasses.field(default=None, compare=False,
                                         repr=False)
    # Sequence parallelism: the axis name and extent the sequence shards
    # on, the scheme ("ring" K/V rotation or "ulysses" all-to-all head
    # re-sharding) and the process group of the sp peers
    # (with_sequence_parallel).
    sp_axis: str | None = None
    sp_size: int = 1
    sp_mode: str = "ring"
    sp_group: object = dataclasses.field(default=None, compare=False,
                                         repr=False)
    # Tensor parallelism: the axis name and extent the heads and d_ff
    # shard on, and the process group of the tp peers
    # (with_tensor_parallel; None: no all-reduce, one rank's partials).
    tp_axis: str | None = None
    tp_size: int = 1
    tp_group: object = dataclasses.field(default=None, compare=False,
                                         repr=False)
    # Attention through the flash kernels (ops/flash_attention.py) instead
    # of full_attention.
    use_flash: bool = False
    # Memory policy (memory/policy.py): "blocks" recomputes each block in
    # the backward from its saved input, "dots" keeps its matmul outputs
    # and recomputes the rest; act_dtype is the saved dtype of the
    # residual stream between blocks. Serving ignores both fields.
    remat: str = "none"
    act_dtype: str = "compute"
    # Inverted dropout on the embedding and both residual branches of
    # every block, active only when the forward gets a dropout key.
    dropout_rate: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def kv_heads(self) -> int:
        return (self.num_kv_heads if self.num_kv_heads is not None
                else self.num_heads)

    @property
    def is_gqa(self) -> bool:
        return self.kv_heads != self.num_heads

    @property
    def _ep(self) -> int:
        return self.ep_size if self.ep_axis is not None else 1

    @property
    def _tp(self) -> int:
        return self.tp_size if self.tp_axis is not None else 1

    def __post_init__(self):
        validate_remat(self.remat)
        validate_act_dtype(self.act_dtype)
        if not 0.0 <= self.dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1), got "
                             f"{self.dropout_rate}")
        if self.kv_heads < 1:
            raise ValueError(f"num_kv_heads must be >= 1, got "
                             f"{self.kv_heads}")
        if self.num_heads % self.kv_heads:
            raise ValueError(
                f"num_heads={self.num_heads} not divisible by "
                f"num_kv_heads={self.kv_heads}")

    def param_shapes(self) -> dict:
        """The parameter tree's shapes: :meth:`init`'s layout, which is
        the JAX package's, cut to this process's experts (E / ep), heads
        (H / tp, KV / tp) and d_ff slice (d_ff / tp)."""
        tp = self._tp
        dm, dff, v = self.d_model, self.d_ff // tp, self.vocab_size
        h, hd = self.num_heads // tp, self.head_dim
        ln = {"scale": (dm,), "bias": (dm,)}
        blk = {"ln1": dict(ln), "wo": (h, hd, dm), "ln2": dict(ln)}
        if self.is_gqa:
            blk["wq"] = (dm, h, hd)
            blk["wkv"] = (dm, 2, self.kv_heads // tp, hd)
        else:
            blk["wqkv"] = (dm, 3, h, hd)
        if self.moe_experts:
            # Stacked expert weights (this process's E / ep) + a router.
            e_loc = self.moe_experts // self._ep
            blk["router"] = (dm, self.moe_experts)
            blk["w1"] = (e_loc, dm, dff)
            blk["w2"] = (e_loc, dff, dm)
        else:
            blk["w1"] = (dm, dff)
            blk["w2"] = (dff, dm)
        return {"embed": (v, dm), "ln_f": dict(ln), "head": (dm, v),
                "blocks": tuple(dict(blk) for _ in range(self.num_layers))}

    def param_specs(self) -> dict:
        """The mesh axis each leaf dim shards over, a tree of
        ``PartitionSpec`` mirroring :meth:`param_shapes` (JAX
        ``param_specs``): heads and the MLP hidden axis over ``tp_axis``,
        stacked experts over ``ep_axis`` (``(ep, None, tp)``), the rest
        replicated; an axis of extent 1 is ``None``."""
        tp = self.tp_axis if self._tp > 1 else None
        ep = self.ep_axis if self._ep > 1 else None
        ln = {"scale": P(), "bias": P()}
        blk = {"ln1": dict(ln), "wo": P(tp, None, None), "ln2": dict(ln)}
        if self.is_gqa:
            blk["wq"] = P(None, tp, None)
            blk["wkv"] = P(None, None, tp, None)
        else:
            blk["wqkv"] = P(None, None, tp, None)
        if self.moe_experts:
            blk["router"] = P()
            blk["w1"] = P(ep, None, tp)
            blk["w2"] = P(ep, tp, None)
        else:
            blk["w1"] = P(None, tp)
            blk["w2"] = P(tp, None)
        return {"embed": P(), "ln_f": dict(ln), "head": P(),
                "blocks": tuple(dict(blk) for _ in range(self.num_layers))}

    def init(self, generator: torch.Generator) -> dict:
        """Parameter dict on ``generator.device``: matrices drawn
        N(0, 0.02^2) from ``generator``, LayerNorm scale 1 and bias 0."""
        dev, dt = generator.device, self.param_dtype

        def leaf(name, shape):
            if name == "scale":
                return torch.ones(shape, dtype=dt, device=dev)
            if name == "bias":
                return torch.zeros(shape, dtype=dt, device=dev)
            return 0.02 * torch.randn(shape, generator=generator,
                                      dtype=dt, device=dev)

        def build(name, node):
            if isinstance(node, dict):
                return {k: build(k, v) for k, v in node.items()}
            if isinstance(node, tuple) and node and isinstance(node[0],
                                                               dict):
                return tuple(build(name, b) for b in node)
            return leaf(name, node)

        return build("", self.param_shapes())

    def qkv_proj(self, blk, y, pos, dot=None):
        """Projected + RoPE'd q (B, L, H/tp, hd) and k/v (B, L, KV/tp, hd)
        from normalized input ``y`` (``f`` already applied under tp):
        one fused "wqkv" matmul for MHA, separate "wq"/"wkv" for GQA,
        each through ``dot`` (``qdot`` by default; training passes
        :func:`train_dot`). Column-parallel: local heads only."""
        from tpu_ddp_torch.ops.quant import qdot
        qdot = dot or qdot
        cd = self.compute_dtype
        b, lc, hd = y.shape[0], y.shape[1], self.head_dim
        h = self.num_heads // self._tp
        if not self.is_gqa:
            qkv = qdot(y, blk["wqkv"], cd, reshape=(self.d_model, -1))
            qkv = qkv.to(cd).reshape(b, lc, 3, h, hd)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q = qdot(y, blk["wq"], cd, reshape=(self.d_model, -1))
            q = q.to(cd).reshape(b, lc, h, hd)
            kvp = qdot(y, blk["wkv"], cd, reshape=(self.d_model, -1))
            kvp = kvp.to(cd).reshape(b, lc, 2, self.kv_heads // self._tp,
                                     hd)
            k, v = kvp[:, :, 0], kvp[:, :, 1]
        return rope(q, pos), rope(k, pos), v

    def project(self, params, x, dot=None):
        """Vocabulary projection of post-LN activations through ``dot``
        (``qdot`` by default: f32 logits, never rounded to the compute
        dtype); returns f32 logits."""
        from tpu_ddp_torch.ops.quant import qdot
        dot = dot or qdot
        return dot(x, params["head"], self.compute_dtype).to(torch.float32)

    # ---- training forward ---------------------------------------------

    @property
    def _sp(self) -> int:
        return self.sp_size if self.sp_axis is not None else 1

    def check_seq_len(self, local_len: int) -> None:
        """Validate the global sequence length (local x sp under sequence
        parallelism) against ``max_seq_len``."""
        sp = self._sp
        if local_len * sp > self.max_seq_len:
            raise ValueError(
                f"global sequence length {local_len * sp} (local "
                f"{local_len} x sp {sp}) exceeds "
                f"max_seq_len={self.max_seq_len}")

    def _positions(self, lc: int, device):
        """Global positions of the local chunk (the chunk offset under
        sp: this process's index in the sp group times ``lc``)."""
        start = 0
        if self._sp > 1:
            start = dist.get_rank(self.sp_group) * lc
        return start + torch.arange(lc, device=device)

    def apply(self, params, tokens, rng=None):
        """tokens: (B, L) integer ids -> logits (B, L, V) f32. ``rng``, a
        dropout key (:func:`fold_in`), switches dropout on; omit it for a
        deterministic forward."""
        return self.apply_with_aux(params, tokens, rng=rng)[0]

    def apply_with_aux(self, params, tokens, rng=None):
        """Like :meth:`apply`, with the mean of the MoE blocks' load-
        balance losses (0.0 for a dense model)."""
        x, aux = self.trunk_with_aux(params, tokens, rng=rng)
        return self.project(params, x, dot=_train_dot_f32), aux

    def trunk_with_aux(self, params, tokens, rng=None, stats=None):
        """Embed -> blocks -> final LayerNorm: ((B, L, dm) activations,
        aux), the whole forward but the vocabulary projection (the
        chunked loss fuses that in, ops/loss.py); ``aux`` is the mean
        over the blocks of the MoE load-balance loss (0.0 when dense).
        Under a remat policy each block is one region
        (memory/policy.py:wrap_stage) whose input is saved in
        ``act_dtype``; its backward recomputes it, the flash forward, the
        routing and the dropout masks included. Block i's masks derive
        from ``fold_in(rng, i)``, the embedding's from
        ``fold_in(rng, num_layers)``. ``stats``: a list that collects each
        MoE block's routing counters (parallel/moe.py:routing_stats); it
        runs the blocks without remat."""
        lc = tokens.shape[1]
        self.check_seq_len(lc)
        pos = self._positions(lc, tokens.device)
        x = self.embed(params, tokens, rng)
        run = self.layer_runner(stats)
        aux = 0.0
        for i, blk in enumerate(params["blocks"]):
            x, a = run(blk, x, pos, fold_in(rng, i) if rng is not None
                       else None)
            aux = aux + a
        x = layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])
        if self.moe_experts:
            aux = aux / max(self.num_layers, 1)
        return x, aux

    def embed(self, params, tokens, rng=None):
        """The embedding of (B, L) ids in the compute dtype, with its
        dropout (key ``fold_in(rng, num_layers)``) when ``rng`` is
        given: the first step of :meth:`trunk_with_aux`, and what a
        pipeline's first stage feeds its layers."""
        x = F.embedding(tokens.long(), params["embed"]).to(
            self.compute_dtype)
        if rng is not None:
            x = dropout(x, self.dropout_rate, fold_in(rng, self.num_layers))
        return x

    def layer_runner(self, stats=None):
        """``run(blk, x, pos, rng) -> (x, aux)``: one block as
        :meth:`trunk_with_aux` runs it, the residual stream saved in
        ``act_dtype`` and, under a remat policy, the block one checkpoint
        region (memory/policy.py:wrap_stage). ``rng`` is the block's key
        (``fold_in`` of the trunk's key and the layer's index in the
        dense model). ``stats`` runs without remat (route_stats)."""
        cd = self.compute_dtype
        remat = effective_remat(self.remat, "attn")
        if stats is not None or (remat == "none"
                                 and self.act_dtype == "compute"):
            def blk_fn(blk, x, pos, r):
                return self.block_apply_aux(blk, x, pos, r, stats=stats)
        else:
            blk_fn = wrap_stage(self._block_entry, remat)

        def run(blk, x, pos, r):
            return blk_fn(blk, cast_saved(x, self.act_dtype, cd), pos, r)
        return run

    def train_head(self, params, x):
        """Final LayerNorm and the vocabulary projection of the training
        forward (f32 logits from compute-dtype operands, the product
        :meth:`apply_with_aux` runs): (B, L, dm) -> (B, L, V) f32."""
        x = layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])
        return self.project(params, x, dot=_train_dot_f32)

    def _block_entry(self, blk, x, pos, rng=None):
        """:meth:`block_apply_aux` with the residual stream re-entering
        ``compute_dtype``: the checkpoint region's entry point."""
        return self.block_apply_aux(blk, x.to(self.compute_dtype), pos,
                                    rng)

    def block_apply_aux(self, blk, x, pos, rng=None, stats=None):
        """One transformer block, (B, L, dm) -> (B, L, dm), and its
        auxiliary loss: LN1 -> qkv -> attention -> wo (+ dropout) +
        residual -> LN2 -> the MLP (+ dropout) + residual. The MLP is w1
        (f32 out) -> GELU (tanh, f32) -> w2 for a dense model (aux 0.0),
        the routed layer of parallel/moe.py for a MoE model. The two
        branch masks derive from ``rng`` (sites 0 and 1). Under tp each
        branch runs on this process's heads or d_ff slice between ``f``
        and ``g``."""
        cd = self.compute_dtype
        r1 = r2 = None
        if rng is not None:
            r1, r2 = fold_in(rng, 0), fold_in(rng, 1)
        y = layer_norm(x, blk["ln1"]["scale"], blk["ln1"]["bias"])
        o = self._tp_out(self.attn_partial(blk, self._tp_in(y), pos)).to(cd)
        x = x + dropout(o, self.dropout_rate, r1)
        y = layer_norm(x, blk["ln2"]["scale"], blk["ln2"]["bias"])
        if self.moe_experts:
            y, aux = self.moe_apply(blk, y, stats=stats)
            return x + dropout(y, self.dropout_rate, r2), aux
        y = self._tp_out(self.mlp_partial(blk, self._tp_in(y))).to(cd)
        return x + dropout(y, self.dropout_rate, r2), 0.0

    def _tp_in(self, x):
        """Megatron ``f`` over ``tp_group`` (the identity at tp 1)."""
        return tp_input(x, self.tp_group) if self._tp > 1 else x

    def _tp_out(self, x):
        """Megatron ``g`` over ``tp_group`` (the identity at tp 1)."""
        return tp_output(x, self.tp_group) if self._tp > 1 else x

    def attn_partial(self, blk, y, pos):
        """The attention branch of one block on LayerNorm'd ``y``, up to
        and including the row-parallel ``wo`` product: this process's
        partial sum in f32 under tp, the branch output in the compute
        dtype at tp 1."""
        cd = self.compute_dtype
        b, lc = y.shape[0], y.shape[1]
        hw = self.num_heads // self._tp * self.head_dim
        q, k, v = self.qkv_proj(blk, y, pos, dot=train_dot)
        o = attend(q, k, v, causal=True, axis_name=self.sp_axis,
                   axis_size=self.sp_size, flash=self.use_flash,
                   mode=self.sp_mode, group=self.sp_group)
        return train_dot(o.reshape(b, lc, hw), blk["wo"], cd,
                         reshape=(hw, self.d_model),
                         out_dtype=torch.float32 if self._tp > 1 else None)

    def mlp_partial(self, blk, y):
        """The dense MLP on LayerNorm'd ``y``: w1 (f32 out) -> GELU (tanh,
        f32) -> w2, the row-parallel product a partial sum in f32 under
        tp, rounded to the compute dtype at tp 1."""
        cd = self.compute_dtype
        y = train_dot(y, blk["w1"], cd, out_dtype=torch.float32)
        y = F.gelu(y, approximate="tanh").to(cd)
        return train_dot(y, blk["w2"], cd,
                         out_dtype=torch.float32 if self._tp > 1 else None)

    def moe_apply(self, blk, y, stats=None):
        """The routed MLP on a (B, L, dm) bank: ((B, L, dm), aux), over
        the ep group when the model is expert-parallel."""
        from tpu_ddp_torch.parallel.moe import moe_mlp
        return moe_mlp(y, blk["router"], blk["w1"], blk["w2"],
                       num_experts=self.moe_experts,
                       capacity_factor=self.moe_capacity_factor,
                       top_k=self.moe_top_k, ep_size=self._ep,
                       ep_group=self.ep_group, tp_size=self._tp,
                       tp_group=self.tp_group, stats=stats)

    def route_stats(self, params, tokens):
        """One deterministic trunk pass (no dropout, no remat) collecting
        each MoE block's routing counters: a list of dicts with
        ``dropped_frac``, ``expert_load`` (E,) and ``imbalance``
        (parallel/moe.py:routing_stats), one per layer; [] for a dense
        model."""
        if not self.moe_experts:
            return []
        stats: list = []
        with torch.no_grad():
            self.trunk_with_aux(params, tokens, rng=None, stats=stats)
        return stats

    def with_sequence_parallel(self, axis_name: str, axis_size: int,
                               mode: str = "ring",
                               group=None) -> "TransformerLM":
        """This model with its sequence sharded ``axis_size`` ways over
        the process group ``group`` (the sp peers), attending by ``mode``.
        Ulysses needs ``(num_heads / tp) % sp == 0``."""
        if mode not in ("ring", "ulysses"):
            raise ValueError(f"unknown sequence-parallel mode {mode!r}; "
                             "expected 'ring' or 'ulysses'")
        if mode == "ulysses" and (self.num_heads // self._tp) % axis_size:
            raise ValueError(
                f"ulysses needs (num_heads/tp) % sp == 0 (got heads="
                f"{self.num_heads}/{self._tp} per tp shard, "
                f"sp={axis_size})")
        return dataclasses.replace(self, sp_axis=axis_name,
                                   sp_size=axis_size, sp_mode=mode,
                                   sp_group=group)

    def with_tensor_parallel(self, axis_name: str, axis_size: int,
                             group=None) -> "TransformerLM":
        """This model with its heads and d_ff sharded ``axis_size`` ways
        over the process group ``group`` (the tp peers; None: this
        process's partial sums, no all-reduce). JAX's checks, and the
        per-tp Ulysses head check of an sp applied before."""
        if self.num_heads % axis_size:
            raise ValueError(f"num_heads={self.num_heads} not divisible by "
                             f"tp={axis_size}")
        if self.kv_heads % axis_size:
            raise ValueError(f"num_kv_heads={self.kv_heads} not divisible "
                             f"by tp={axis_size}")
        if self.d_ff % axis_size:
            raise ValueError(f"d_ff={self.d_ff} not divisible by "
                             f"tp={axis_size}")
        if (self.sp_mode == "ulysses" and self.sp_size > 1
                and (self.num_heads // axis_size) % self.sp_size):
            raise ValueError(
                f"ulysses needs (num_heads/tp) % sp == 0 (got heads="
                f"{self.num_heads}/{axis_size} per tp shard, "
                f"sp={self.sp_size})")
        return dataclasses.replace(self, tp_axis=axis_name,
                                   tp_size=axis_size, tp_group=group)

    def with_expert_parallel(self, axis_name: str, axis_size: int,
                             group=None) -> "TransformerLM":
        """This model with its experts sharded ``axis_size`` ways over the
        process group ``group`` (the ep peers)."""
        if not self.moe_experts:
            raise ValueError("expert parallelism requires a MoE model "
                             "(moe_experts > 0)")
        if self.moe_experts % axis_size:
            raise ValueError(f"moe_experts={self.moe_experts} not "
                             f"divisible by ep={axis_size}")
        return dataclasses.replace(self, ep_axis=axis_name,
                                   ep_size=axis_size, ep_group=group)

    def head_apply(self, params, x):
        """Final LayerNorm + LM head: (B, L, dm) -> (B, L, V) f32."""
        x = layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])
        return self.project(params, x)


def train_dot(y, w, cd, reshape=None, out_dtype=None):
    """The training forward's matmul: ``y @ w`` with both operands cast to
    the compute dtype ``cd`` (``w`` reshaped), f32 sums inside the GEMM,
    the result in ``out_dtype`` (default ``cd``). Differentiable."""
    w = w.to(cd)
    if reshape is not None:
        w = w.reshape(reshape)
    y = y.to(cd)
    if out_dtype is None or out_dtype == cd:
        return torch.matmul(y, w)
    return _WideDot.apply(y, w, out_dtype)


def _train_dot_f32(y, w, cd):
    return train_dot(y, w, cd, out_dtype=torch.float32)


def _mm(a, b, out_dtype):
    """2-D ``a @ b`` of one dtype with f32 sums, returned in ``out_dtype``:
    cuBLAS writes the wider type itself; on the CPU the operands are
    widened (exact) and the f32 product is cast."""
    if a.device.type != "cuda":
        return torch.mm(a.float(), b.float()).to(out_dtype)
    if out_dtype == a.dtype:
        return torch.mm(a, b)
    return torch.mm(a, b, out_dtype=out_dtype)


class _WideDot(torch.autograd.Function):
    """``y @ w`` of narrow operands with a wider output: JAX's ``jnp.dot``
    with ``preferred_element_type``. The backward rounds the cotangent to
    the operands' dtype and gives their dtype back, as the TPU's
    default-precision dot and a narrow GEMM's own backward do."""

    @staticmethod
    def forward(ctx, y, w, out_dtype):
        ctx.save_for_backward(y, w)
        out = _mm(y.reshape(-1, y.shape[-1]), w, out_dtype)
        return out.reshape(*y.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        y, w = ctx.saved_tensors
        g = g.to(y.dtype).reshape(-1, g.shape[-1])
        y2 = y.reshape(-1, y.shape[-1])
        dy = _mm(g, w.t(), y.dtype).reshape(y.shape)
        dw = _mm(y2.t(), g, w.dtype)
        return dy, dw, None


def make_transformer(name: str = "TransformerLM-small",
                     **kwargs) -> TransformerLM:
    """The presets of tpu_ddp/models/transformer.py."""
    presets = {
        "TransformerLM-tiny": dict(num_layers=2, num_heads=4, d_model=128,
                                   d_ff=512, vocab_size=1024),
        "TransformerLM-small": dict(num_layers=4, num_heads=8, d_model=512,
                                    d_ff=2048, vocab_size=32000),
        "TransformerLM-base": dict(num_layers=12, num_heads=12, d_model=768,
                                   d_ff=3072, vocab_size=32000),
        "TransformerLM-large": dict(num_layers=12, num_heads=16,
                                    d_model=2048, d_ff=8192,
                                    vocab_size=32000, remat="blocks"),
        "TransformerLM-tiny-8k": dict(num_layers=2, num_heads=4,
                                      d_model=128, d_ff=512,
                                      vocab_size=1024,
                                      max_seq_len=8192),
        "TransformerLM-small-32k": dict(num_layers=4, num_heads=8,
                                        d_model=512, d_ff=2048,
                                        vocab_size=32000,
                                        max_seq_len=32768),
        # MoE: Switch (top-1) at the small end, GShard (top-2) at scale;
        # d_ff is the per-expert hidden width.
        "TransformerLM-moe-tiny": dict(num_layers=2, num_heads=4,
                                       d_model=128, d_ff=256,
                                       vocab_size=1024, moe_experts=4,
                                       moe_top_k=1,
                                       moe_capacity_factor=1.25),
        "TransformerLM-moe-small": dict(num_layers=4, num_heads=8,
                                        d_model=512, d_ff=1024,
                                        vocab_size=32000, moe_experts=8,
                                        moe_top_k=2,
                                        moe_capacity_factor=1.25),
        # LM-large's trunk with 16 experts of half its d_ff.
        "TransformerLM-moe-large": dict(num_layers=12, num_heads=16,
                                        d_model=2048, d_ff=4096,
                                        vocab_size=32000,
                                        moe_experts=16, moe_top_k=2,
                                        moe_capacity_factor=1.25,
                                        remat="blocks"),
    }
    if name not in presets:
        raise ValueError(f"unknown transformer preset {name!r}; "
                         f"available: {sorted(presets)}")
    cfg = dict(presets[name])
    cfg.update(kwargs)
    return TransformerLM(name=name, **cfg)
