"""Nested dict / list trees of tensors, walked as the JAX package's pytrees
are: dict keys in sorted order, list items in order, None an empty
subtree. The training step, the optimizer, the gradient compression and
the checkpoint manager share these walks, so leaf order and key paths
are the JAX package's (`repro.checkpoint.manager` names a leaf by its
path: dict keys, `#i` for list items, joined by '/')."""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple


def items(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(key path, leaf) pairs in flatten order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from items(v, f"{path}/#{i}")
    else:
        yield path.lstrip("/"), tree


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in items(tree)]


def flatten_with_paths(tree) -> Dict[str, Any]:
    return dict(items(tree))


def tree_map(fn: Callable, tree, *rest, is_leaf=None):
    """fn over the leaves of `tree` and the matching leaves of `rest`
    (same structure; a None in `tree` stays None). is_leaf(node) True
    stops the walk at that node."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(tree, new_leaves):
    """A tree shaped like `tree` holding `new_leaves` in flatten order."""
    it = iter(new_leaves)

    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return next(it)

    return walk(tree)
