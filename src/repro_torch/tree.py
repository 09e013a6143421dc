"""Parameter trees: nested dicts and lists of tensors, as the JAX package's
pytrees are, walked in ``jax.tree.flatten``'s order (dict keys sorted,
lists and tuples in order), so a leaf index means the same leaf in both
packages (optimizer state, checkpoints)."""
from __future__ import annotations


def leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.flatten`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def unflatten(like, flat) -> object:
    """A tree of ``like``'s structure whose leaves are ``flat`` in order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree has")
    return out


def map_like(fn, like, *trees):
    """``fn(leaf, *parts)`` at every leaf position of ``like``, where each
    part is the subtree of the matching tree at that position (a leaf, or
    a whole subtree such as an int8 moment's ``{"q", "scale"}``), as
    ``treedef.flatten_up_to`` cuts them."""
    if isinstance(like, dict):
        return {k: map_like(fn, like[k], *(t[k] for t in trees)) for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(map_like(fn, v, *(t[i] for t in trees)) for i, v in enumerate(like))
    return fn(like, *trees)
