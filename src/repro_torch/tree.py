"""Trees of tensors: nested dicts, lists, tuples and NamedTuples with
tensor (or None) leaves, as the port's parameters, gradients and
optimizer states are (counterpart of the ``jax.tree`` calls the
reference makes). Dict keys are visited in sorted order, as
``jax.tree.flatten`` visits them, and a path renders as
``jax.tree_util.keystr`` renders it: ``['layers'][0]['attn']['wq']``,
``.m`` for a NamedTuple field."""
from __future__ import annotations


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """(key string, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def leaves_with_path(tree) -> list:
    """[(path string, leaf)] in flatten order; None is an empty node, as
    in JAX."""
    out = []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append((path, node))
            return
        for key, child in kids:
            walk(child, path + key)

    walk(tree, "")
    return out


def map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over the leaves; the result has ``tree``'s
    structure."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], f"{path}[{k!r}]")
                for k in tree}
    items = [map_with_path(fn, c, path + key) for key, c in kids]
    if _is_namedtuple(tree):
        return type(tree)(*items)
    return type(tree)(items)


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def map(fn, tree, *rest):  # noqa: A001 (jax.tree.map's name)
    """``fn`` over the leaves of ``tree`` and of the like-shaped ``rest``;
    the result has ``tree``'s structure."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    items = [map(fn, c, *(r[i] for r in rest))
             for i, c in enumerate(tree)]
    if _is_namedtuple(tree):
        return type(tree)(*items)
    return type(tree)(items)
