"""Nested dicts and lists of tensors: the port's stand-in for ``jax.tree``.

The port's params and caches keep the JAX package's structure (dicts of
leaves, a list of layer groups), so these functions cover what the JAX
package does with ``jax.tree.map``, ``jax.tree.leaves`` and
``jax.tree_util.tree_flatten_with_path``.
"""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of each tree of ``rest`` (the
    same structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_leaves_with_paths(tree, prefix=""):
    """(path, leaf) pairs in ``jax.tree_util.tree_flatten_with_path``'s
    order (dict keys sorted) with its key strings joined by "/", as the JAX
    package's checkpoints name leaves: ``['params']/['groups']/[0]/['wq']``."""
    if isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    return [pair for key, v in items
            for pair in tree_leaves_with_paths(
                v, f"{prefix}/{key}" if prefix else key)]
