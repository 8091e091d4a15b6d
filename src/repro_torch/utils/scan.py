"""The chunk loops' scan: a Python loop over the leading axis.

Port of `repro/utils/scan.py`.  The reference's `scan` is `lax.scan`, or a
trace-time unrolled loop under its `unroll_scans()` switch (for its dry-run
cost probes); eager PyTorch has no traced loop, so `scan` is always the
loop and stacks each step's outputs, and the switch has no counterpart.
"""

from __future__ import annotations

import torch


def _tree_map(f, *trees):
    """f over the leaves of nested tuples / lists / dicts of tensors."""
    t = trees[0]
    if isinstance(t, (tuple, list)):
        return type(t)(_tree_map(f, *parts) for parts in zip(*trees))
    if isinstance(t, dict):
        return {k: _tree_map(f, *(tr[k] for tr in trees)) for k in t}
    return f(*trees)


def _first_leaf(tree) -> torch.Tensor:
    while isinstance(tree, (tuple, list, dict)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


def scan(f, init, xs, length: int | None = None):
    """`lax.scan(f, init, xs, length)` as a loop: `f(carry, x_i) -> (carry,
    y_i)` over the leading axis of `xs` (a tensor or a tuple / list / dict of
    them, or None with `length`); returns (carry, the y_i stacked)."""
    if length is None:
        length = _first_leaf(xs).shape[0]
    carry, ys = init, []
    for i in range(length):
        x_i = None if xs is None else _tree_map(lambda a: a[i], xs)
        carry, y = f(carry, x_i)
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    return carry, _tree_map(lambda *a: torch.stack(a), *ys)
