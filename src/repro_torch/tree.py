"""The few pytree helpers the port needs, over nested dicts and NamedTuples.

Parameters, optimizer moments and gradients are plain nested dicts of
tensors, as the JAX package's pytrees are. Leaves are visited in sorted key
order, the order of ``jax.tree.leaves``, so sums over leaves add in the
same order on both sides. A path joins keys with ``/`` (``layers/attn/wq``).
"""
from __future__ import annotations


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map_with_path(fn, tree, *rest, path: str = ""):
    """``fn(path, leaf, *other_leaves)`` at every leaf; keeps the structure
    (dicts keep their key order, NamedTuples their type)."""
    def sub(key):
        return f"{path}/{key}" if path else str(key)

    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest), path=sub(k))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(
            tree_map_with_path(fn, getattr(tree, f), *(getattr(r, f) for r in rest),
                               path=sub(f))
            for f in tree._fields))
    return fn(path, tree, *rest)


def tree_map(fn, tree, *rest):
    """``fn(leaf, *other_leaves)`` at every leaf."""
    return tree_map_with_path(lambda _p, *leaves: fn(*leaves), tree, *rest)


def tree_items(tree) -> list:
    """[(path, leaf)] in sorted key order."""
    out: list = []

    def visit(path, node):
        if isinstance(node, dict):
            for k in sorted(node):
                visit(f"{path}/{k}" if path else str(k), node[k])
        elif _is_namedtuple(node):
            for f in node._fields:
                visit(f"{path}/{f}" if path else f, getattr(node, f))
        else:
            out.append((path, node))

    visit("", tree)
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]
