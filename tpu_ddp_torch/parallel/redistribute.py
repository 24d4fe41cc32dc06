"""The layout contract of a trainer as a file (tpu_ddp/parallel/
redistribute.py ``ShardingPlan``): strategy name, mesh axis sizes and the
per-tree partition specs, written as ``sharding_plan.json`` next to the
checkpoints in the JAX package's schema, so a restoring trainer can check
the saving world's layout before it touches a tensor, whichever package
wrote it.

The port's layouts are all replicated data parallel (every rank holds
every leaf whole): specs are empty, or all-``None`` for the LM's matrices
as the JAX model spells a tensor-parallel spec at tp 1. Redistribution
between layouts (``redistribute_state``) comes with elastic membership
(ROADMAP Queue 1 item 9.6b).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

DATA_AXIS = "dp"
PLAN_FILENAME = "sharding_plan.json"


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s value: one entry per array axis,
    each ``None``, an axis name or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


def encode_spec_tree(tree: Any) -> Any:
    """Tree of P/None/scalar leaves -> JSON-serializable structure, with
    the JAX package's markers for specs and tuples."""
    if isinstance(tree, PartitionSpec):
        return {"__pspec__": [list(e) if isinstance(e, tuple) else e
                              for e in tree]}
    if isinstance(tree, tuple):
        return {"__tuple__": [encode_spec_tree(x) for x in tree]}
    if isinstance(tree, list):
        return [encode_spec_tree(x) for x in tree]
    if isinstance(tree, dict):
        return {str(k): encode_spec_tree(v) for k, v in tree.items()}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    raise TypeError(f"cannot serialize {type(tree).__name__} in a spec tree")


def decode_spec_tree(obj: Any) -> Any:
    """Inverse of :func:`encode_spec_tree`."""
    if isinstance(obj, dict):
        if "__pspec__" in obj:
            return P(*[tuple(e) if isinstance(e, list) else e
                       for e in obj["__pspec__"]])
        if "__tuple__" in obj:
            return tuple(decode_spec_tree(x) for x in obj["__tuple__"])
        return {k: decode_spec_tree(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [decode_spec_tree(x) for x in obj]
    return obj


@dataclasses.dataclass
class ShardingPlan:
    """The serializable layout contract of one trainer configuration."""

    strategy: str
    mesh_axes: tuple  # ((axis_name, size), ...) in mesh order
    param_specs: Any
    opt_specs: Any
    comp_specs: Any = None
    batch_spec: Any = dataclasses.field(
        default_factory=lambda: P(DATA_AXIS))
    stage_layout: Any = None

    def to_json(self) -> str:
        obj = {
            "version": 1,
            "strategy": self.strategy,
            "mesh_axes": [[n, s] for n, s in self.mesh_axes],
            "param_specs": encode_spec_tree(self.param_specs),
            "opt_specs": encode_spec_tree(self.opt_specs),
            "comp_specs": encode_spec_tree(self.comp_specs),
            "batch_spec": encode_spec_tree(self.batch_spec),
        }
        if self.stage_layout is not None:
            obj["stage_layout"] = encode_spec_tree(self.stage_layout)
        return json.dumps(obj, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ShardingPlan":
        obj = json.loads(text)
        if obj.get("version") != 1:
            raise ValueError(
                f"unknown ShardingPlan version {obj.get('version')!r}")
        return cls(
            strategy=obj["strategy"],
            mesh_axes=tuple((n, int(s)) for n, s in obj["mesh_axes"]),
            param_specs=decode_spec_tree(obj["param_specs"]),
            opt_specs=decode_spec_tree(obj["opt_specs"]),
            comp_specs=decode_spec_tree(obj["comp_specs"]),
            batch_spec=decode_spec_tree(obj["batch_spec"]),
            stage_layout=decode_spec_tree(obj.get("stage_layout")),
        )

    def save(self, directory: str) -> str:
        path = os.path.join(directory, PLAN_FILENAME)
        tmp = path + ".tmp"
        os.makedirs(directory, exist_ok=True)
        with open(tmp, "w") as f:
            f.write(self.to_json())
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, directory: str) -> "ShardingPlan | None":
        path = os.path.join(directory, PLAN_FILENAME)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return cls.from_json(f.read())

    def compatible_with(self, other: "ShardingPlan") -> bool:
        """Same layout contract (strategy, specs, stage order), any world
        size."""
        return (self.strategy == other.strategy
                and self.param_specs == other.param_specs
                and self.opt_specs == other.opt_specs
                and self.comp_specs == other.comp_specs
                and self.stage_layout == other.stage_layout)

    def __eq__(self, other) -> bool:
        if not isinstance(other, ShardingPlan):
            return NotImplemented
        return (self.compatible_with(other)
                and self.mesh_axes == other.mesh_axes
                and self.batch_spec == other.batch_spec)


def warn_if_incompatible(directory: str, mine: ShardingPlan) -> None:
    """Warn when the plan saved next to the checkpoints in ``directory``
    describes another layout than ``mine`` (tpu_ddp/train/engine.py:
    673-684): checkpoints hold canonical shapes and restore across
    layouts by design; the warning says the move was across layouts."""
    saved = ShardingPlan.load(directory)
    if saved is not None and not saved.compatible_with(mine):
        import warnings
        warnings.warn(
            f"checkpoint was written by layout {saved.strategy!r} "
            f"{dict(saved.mesh_axes)}; restoring into {mine.strategy!r} "
            f"{dict(mine.mesh_axes)} via canonical shapes.", stacklevel=3)
