"""Parameter trees: nested dicts, lists and tuples whose leaves are tensors
(or QuantizedTensors) — the port's stand-in for ``jax.tree`` (no
counterpart module in ``repro``).

Leaves come in jax's order (dict keys sorted), so a sum over leaves adds
in the reference's order.
"""

from __future__ import annotations


def leaves(tree) -> list:
    """The leaves of ``tree`` in jax's order; None is an empty subtree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def unflatten(tree, flat):
    """``tree``'s structure with its leaves replaced, in ``leaves`` order,
    by the items of ``flat``."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)

    return build(tree)
