"""Nested dicts, lists, tuples and named tuples of tensors, walked in the
reference's pytree order.

The reference's trees are JAX pytrees: `jax.tree.leaves` visits dict keys
in sorted order, sequences and named tuples in order, and treats None as
an empty subtree.  The port keeps its parameter, optimizer and checkpoint
trees in the same structures, and these helpers visit them in the same
order, so a path here is the reference's path (dict keys, sequence
indices and field names) and a sum over leaves adds in its order.  A
tuple whose class sets `tree_leaf` (`parallel.sharding.PartitionSpec`)
is a leaf, as the reference's spec trees treat a PartitionSpec.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator


def leaves_with_path(tree: Any, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) pairs in the reference's pytree order."""
    if tree is None:
        return
    if getattr(tree, "tree_leaf", False):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from leaves_with_path(getattr(tree, name), path + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from leaves_with_path(sub, path + (i,))
    else:
        yield path, tree


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(like: Any, new_leaves: Iterator[Any]) -> Any:
    """`like`'s structure with its leaves replaced, in `leaves_with_path`
    order (dicts keep `like`'s key order)."""
    if like is None:
        return None
    if getattr(like, "tree_leaf", False):
        return next(new_leaves)
    if isinstance(like, dict):
        out = {k: unflatten(like[k], new_leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(unflatten(getattr(like, n), new_leaves) for n in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(unflatten(sub, new_leaves) for sub in like)
    return next(new_leaves)


def map_with_path(f: Callable, tree: Any, *rest: Any) -> Any:
    """f(path, leaf, *the other trees' leaves at that path) over `tree`'s
    leaves; the other trees have `tree`'s structure."""
    others = [leaves(t) for t in rest]
    out = (f(path, leaf, *(o[i] for o in others))
           for i, (path, leaf) in enumerate(leaves_with_path(tree)))
    return unflatten(tree, iter(list(out)))


def map(f: Callable, tree: Any, *rest: Any) -> Any:  # noqa: A001 - jax.tree.map's name
    """f(leaf, *the other trees' leaves) over `tree`'s leaves."""
    return map_with_path(lambda _, *a: f(*a), tree, *rest)
