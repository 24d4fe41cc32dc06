"""Leaves of the port's parameter trees (nested dicts and tuples of
tensors, ``TransformerLM.init``'s layout) in one fixed order, and back."""

from __future__ import annotations


def tree_leaves(tree) -> list:
    """Leaves in insertion order of dicts and order of tuples/lists."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def keyed_leaves(tree, prefix: str = "") -> list:
    """``(path, leaf)`` pairs in the JAX package's pytree order: dict
    keys sorted, tuples and lists by index. ``path`` is what
    ``jax.tree_util.keystr(path, simple=True, separator=".")`` gives for
    the same tree (``"params.features.0.kernel"``), so checkpoint keys
    agree between the two packages."""
    def join(key):
        return f"{prefix}.{key}" if prefix else str(key)

    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in keyed_leaves(tree[k], join(k))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree)
                for kv in keyed_leaves(v, join(i))]
    return [(prefix, tree)]


def keyed_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in
    :func:`keyed_leaves` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
