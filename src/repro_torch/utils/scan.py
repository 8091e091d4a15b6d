"""The chunk loops' scan: a Python loop over the leading axis.

Port of `repro/utils/scan.py`.  The reference's `scan` is `lax.scan`, or a
trace-time unrolled loop under its `unroll_scans()` switch (for its dry-run
cost probes); eager PyTorch has no traced loop, so `scan` is always the
loop and stacks each step's outputs, and the switch has no counterpart.

The models' token loops (Mamba's recurrence over a chunk's tokens, the
sLSTM's over the sequence) and the train step's microbatch loop run
`steps(n, kind)`, and the token loops stack with `stack_steps`.  Under
`loop_caps(token=k, microbatch=j)` (the dry run's traces,
`launch/steps.py::lower_cell`) each loop of that kind runs at most k (j)
of its n iterations, and a capped stack stands the last output for the
ones it did not run, so every shape is the uncapped one.  A trace's counts are then affine in
k and reach the whole loop's at k = n, which the dry run extrapolates
from k = 1 and 2.  Outside it both are the plain loop and `torch.stack`.
"""

from __future__ import annotations

import contextlib

import torch

LOOP_KINDS = ("token", "microbatch")
# the caps, and the trip counts the capped loops met; a plain global, so
# that a recompute in the backward, maybe on autograd's device thread,
# runs its loops as the forward ran them
_STATE: dict = {"caps": dict.fromkeys(LOOP_KINDS), "trips": {k: set() for k in LOOP_KINDS}}


@contextlib.contextmanager
def loop_caps(**caps):
    """Inside, every loop of each kind named runs at most its cap's
    iterations (None: all).  Yields {kind: the set of uncapped trip counts
    the capped loops of that kind met}, filled as they run."""
    unknown = set(caps) - set(LOOP_KINDS)
    if unknown:
        raise ValueError(f"unknown loop kinds {sorted(unknown)}; expected {LOOP_KINDS}")
    prev = dict(_STATE)
    _STATE["caps"] = {**prev["caps"], **caps}
    _STATE["trips"] = {k: set() for k in LOOP_KINDS}
    try:
        yield _STATE["trips"]
    finally:
        _STATE.update(prev)


def steps(n: int, kind: str = "token") -> range:
    """The iterations a loop of `n` runs: all of them, or its kind's cap."""
    k = _STATE["caps"][kind]
    if k is None:
        return range(n)
    _STATE["trips"][kind].add(n)
    return range(min(n, k))


def stack_steps(ys: list, n: int, dim: int) -> torch.Tensor:
    """`torch.stack(ys, dim)` of a token loop's `n` outputs.  A capped
    loop's stack holds its k outputs and, for the n - k it did not run,
    its last one repeated (detached, so no gradient flows through them),
    joined to the stack by ops that are not counted: the counts grow with
    k as the whole stack's do with n, and the shape is the whole one."""
    if len(ys) >= n:
        return torch.stack(ys, dim=dim)
    from repro_torch.utils import trace

    part = torch.stack(ys, dim=dim)
    with trace.uncounted():
        last = ys[-1].detach().unsqueeze(dim)
        rest = last.expand(*last.shape[:dim], n - len(ys), *last.shape[dim + 1:])
        return torch.cat([part, rest], dim=dim)


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
