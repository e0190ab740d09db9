"""Parameter trees: nested dicts, lists and tuples (NamedTuples
included) of tensors — the port's stand-in for ``jax.tree``. ``None``
is an empty subtree, as in JAX: maps pass it through."""

from typing import Any, Callable, List, Optional, Tuple


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Optional[Callable] = None) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    each tree in ``rest`` (same structure); ``is_leaf(node)`` true
    stops the walk there (``fn`` gets the node, as JAX's ``is_leaf``)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                 for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):  # NamedTuple
            return type(tree)(*items)
        return type(tree)(items)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in the order :func:`tree_map` visits them."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)`` with the leaves in JAX's order: dict keys
    sorted, as ``jax.tree_util.tree_flatten`` visits them (the port's
    :func:`tree_leaves` keeps insertion order). Flat buffers laid out in
    this order line up with the JAX package's. ``treedef`` is the tree
    with each leaf replaced by its index; equal structures have equal
    ``repr``s."""
    leaves: List[Any] = []

    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = dict.fromkeys(node)   # rebuilt in insertion order
            for k in sorted(node):
                out[k] = walk(node[k])
            return out
        if isinstance(node, (list, tuple)):
            items = [walk(v) for v in node]
            if hasattr(node, "_fields"):  # NamedTuple
                return type(node)(*items)
            return type(node)(items)
        leaves.append(node)
        return len(leaves) - 1

    return leaves, walk(tree)


def tree_unflatten(treedef: Any, leaves: List[Any]) -> Any:
    """Inverse of :func:`tree_flatten` (dicts keep their insertion
    order)."""
    return tree_map(lambda i: leaves[i], treedef)
