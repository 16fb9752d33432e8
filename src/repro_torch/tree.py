"""Parameter and train-state trees: nested dicts and lists of tensors.

The leaf order is ``jax.tree.flatten``'s: a dict's keys sorted, a list or
tuple in order.  The optimizer walks the leaves in that order and the
checkpoint stores them in it, so a checkpoint of either package restores in
the other.
"""
from __future__ import annotations


def leaves(tree, is_leaf=None) -> list:
    """The tree's leaves, in jax's order; ``is_leaf(x)`` true stops the walk
    at x (a spec, which is a tuple)."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v, is_leaf)]
    return [tree]


def is_spec(x) -> bool:
    """A sharding spec (``sharding.spec_for``): a tuple of axis names or None."""
    return isinstance(x, tuple) and all(e is None or isinstance(e, (str, tuple)) for e in x)


def paths(tree, prefix="") -> list[str]:
    """Each leaf's path ("master/blocks/wq", "params/blocks/3/ln1"), in jax's order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in paths(v, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def unflatten(like, new_leaves, is_leaf=None):
    """A tree of ``like``'s structure holding ``new_leaves``, in jax's order."""
    it = iter(new_leaves)

    def build(t):
        if is_leaf is not None and is_leaf(t):
            return next(it)
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}  # the caller's key order
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map_tree(fn, tree):
    """``fn`` applied to each leaf, in a tree of the same structure."""
    return unflatten(tree, [fn(x) for x in leaves(tree)])
