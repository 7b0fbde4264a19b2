"""Trees of tensors: nested dicts, lists and tuples, in ``jax.tree``'s order.

The training slice (the optimizer, the checkpoint store, the trainer)
walks parameter and optimizer trees the way the reference's ``jax.tree``
functions do: a dict's entries by sorted key, a list's or a tuple's in
order, ``None`` an empty subtree, anything else a leaf. Sums over the
leaves (the global gradient norm) then add in the reference's order.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["leaves", "leaves_with_path", "tree_map", "unflatten"]


def leaves(tree: Any) -> list:
    """The leaves in ``jax.tree.leaves``' order."""
    return [leaf for _, leaf in leaves_with_path(tree)]


def leaves_with_path(tree: Any, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) pairs in ``jax.tree.leaves``' order; a path holds the
    dict keys and the list or tuple indices from the root, an index as an
    ``int``."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves_with_path(tree[key], path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from leaves_with_path(sub, path + (i,))
    else:
        yield path, tree


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); a tree of the results in
    ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if any(len(r) != len(tree) for r in rest):
            raise ValueError("trees of different structure")
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def unflatten(tree: Any, new_leaves: list) -> Any:
    """A tree of ``tree``'s structure holding ``new_leaves``, taken in
    ``leaves(tree)``'s order (dicts keep their own key order)."""
    it = iter(new_leaves)

    def build(sub):
        if sub is None:
            return None
        if isinstance(sub, dict):
            built = {k: build(sub[k]) for k in sorted(sub)}
            return {k: built[k] for k in sub}
        if isinstance(sub, (list, tuple)):
            out = [build(v) for v in sub]
            return type(sub)(out) if isinstance(sub, tuple) else out
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
