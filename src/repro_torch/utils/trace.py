"""What one step runs, counted op by op on fake tensors: the dry run's trace.

The reference's dry run reads a compiled XLA program (`cost_analysis`,
`memory_analysis`, the optimized HLO text).  Eager PyTorch compiles
nothing, so the port runs the step once under a `TorchDispatchMode`,
inside `FakeTensorMode` (shapes and dtypes, no memory), and counts every
op that executes:

  flops        the FLOPs of `torch.utils.flop_counter`'s formulas (the
               matrix products, and every formula registered with
               `register_flop_formula`: the Hopper kernels' own), taken as
               `FlopCounterMode` takes them, so a real run under
               `FlopCounterMode` counts the same number;
  bytes        each executed op's tensor inputs and outputs (views,
               allocations and collectives move none; an op with a byte
               formula, `register_bytes`, counts what that gives);
  out_bytes    the output bytes the ops write;
  coll         the receive-side bytes of each collective (the output of a
               `_c10d_functional` op, the output argument of a `c10d` one),
               by the reference's five kind names;
  calls        executions per op (`namespace.name`);
  peak_bytes   the most bytes held at once by the storages the step's
               inputs hold and the ones it makes (a storage counts from the
               op that makes it until it is freed, as the caching allocator
               sees it, without its rounding).

On a mesh of DTensors the mode lets DTensor run first and counts the ops
it runs on this rank's shards: the collectives and the local products,
so every count is per rank.

`utils/scan.py::loop_caps` bounds the token and microbatch loops; traces
at caps 1 and 2 extrapolate to the whole loops with `affine`.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import time
import weakref
from typing import Any, Callable

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")
# op name -> the reference's kind; one-to-all and point-to-point traffic
# (broadcast, send, recv) is counted as XLA's collective-permute
_COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_reduce_coalesced_": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.broadcast": "collective-permute",
    "_c10d_functional.broadcast_": "collective-permute",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.broadcast_": "collective-permute",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
}
# ops that move no bytes through device memory: allocations, and the
# collectives' bookkeeping (their traffic is `coll`)
_NO_TRAFFIC = {"aten.empty", "aten.empty_strided", "aten.empty_like", "aten.new_empty",
               "aten.new_empty_strided", "_c10d_functional.wait_tensor"}

_BYTES: dict = {}   # op packet -> bytes formula
_PAUSED = [None]     # None: counting; "hold": storages held only; "skip": nothing


@contextlib.contextmanager
def uncounted(hold: bool = True):
    """Ops run inside are not counted; with `hold` the storages they make
    are still held (a capped loop's stand-ins, `utils/scan.py::
    stack_steps`), else nothing of them is (work no device does)."""
    prev, _PAUSED[0] = _PAUSED[0], ("hold" if hold else "skip")
    try:
        yield
    finally:
        _PAUSED[0] = prev


def register_bytes(op) -> Callable:
    """Decorator: `fn(*args, out_val=out, **kwargs)` (shapes for tensors,
    as `register_flop_formula`'s formulas take them) gives the bytes one
    call of `op` (an OpOverloadPacket) reads and writes, in place of its
    inputs' and outputs' sizes."""
    def register(fn):
        if op in _BYTES:
            raise RuntimeError(f"duplicate byte formula for {op}")
        _BYTES[op] = flop_counter.shape_wrapper(fn)
        return fn
    return register


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def local_tensors(tree: Any) -> list:
    """The plain tensors of a tree of tensors, DTensors, modules, lists and
    dicts: a DTensor's local shard, a module's parameters and buffers."""
    from torch.distributed.tensor import DTensor

    out: list = []

    def walk(x):
        if isinstance(x, DTensor):
            out.append(x._local_tensor)
        elif isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, torch.nn.Module):
            for t in (*x.parameters(), *x.buffers()):
                walk(t)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    return out


@dataclasses.dataclass
class TraceCounts:
    """One traced step's counts (per rank on a mesh); `seconds` is the
    host time the trace took."""

    flops: float = 0.0
    bytes: float = 0.0
    out_bytes: float = 0.0
    coll: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(COLLECTIVE_KINDS, 0))
    calls: dict = dataclasses.field(default_factory=collections.Counter)
    flops_by_op: dict = dataclasses.field(default_factory=collections.Counter)
    bytes_by_op: dict = dataclasses.field(default_factory=collections.Counter)
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    peak_bytes: float = 0.0
    seconds: float = 0.0

    @property
    def coll_bytes(self) -> float:
        return float(sum(self.coll.values()))


def affine(c1: TraceCounts, c2: TraceCounts, n: int) -> TraceCounts:
    """c1 + (n - 1) * (c2 - c1), count by count: the counts of n repeats
    from those of 1 and 2, exact when every repeat adds the same counts
    (the reference's depth extrapolation, `dryrun.probe_costs`).  The
    seconds are the two traces' together."""
    def lin(a, b):
        return a + (n - 1) * (b - a)

    def lin_dict(a, b):
        keys = list(a) + [k for k in b if k not in a]
        return {k: lin(a.get(k, 0), b.get(k, 0)) for k in keys}

    out = TraceCounts(**{f.name: lin(getattr(c1, f.name), getattr(c2, f.name))
                         for f in dataclasses.fields(TraceCounts)
                         if isinstance(getattr(c1, f.name), float)})
    for name in ("coll", "calls", "flops_by_op", "bytes_by_op"):
        setattr(out, name, lin_dict(getattr(c1, name), getattr(c2, name)))
    out.seconds = c1.seconds + c2.seconds
    return out


class _CountingMode(TorchDispatchMode):
    """Counts each op that runs (see the module docstring)."""

    def __init__(self, counts: TraceCounts):
        super().__init__()
        self.counts = counts
        self.live = 0
        self.held: set = set()          # ids of the storages counted as live

    def hold(self, storage) -> None:
        key = id(storage)
        if key in self.held:
            return
        n = storage.nbytes()
        self.held.add(key)
        self.live += n
        self.counts.peak_bytes = max(self.counts.peak_bytes, float(self.live))

        def free(key=key, n=n):
            self.held.discard(key)
            self.live -= n

        weakref.finalize(storage, free)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor runs first: count its local ops
        if func.namespace == "prim":
            return func(*args, **kwargs)     # a query of a tensor's metadata
        # as FlopCounterMode: an op with a decomposition runs as its parts
        if func not in flop_counter.flop_registry and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        if _PAUSED[0] is None:
            self.count(func, args, kwargs, out)
        elif _PAUSED[0] == "hold" and not func.is_view:
            for t in _tensors(out):
                self.hold(t.untyped_storage())
        return out

    def count(self, func, args, kwargs, out) -> None:
        c = self.counts
        packet = func._overloadpacket
        name = str(packet)
        c.calls[name] += 1
        formula = flop_counter.flop_registry.get(packet)
        if formula is not None:
            f = formula(*args, **kwargs, out_val=out)
            c.flops += f
            c.flops_by_op[name] += f
        outs = _tensors(out)
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            recv = outs if name.startswith("_c10d_functional.") else _tensors(args[0])
            c.coll[kind] += _nbytes(recv)
        elif not func.is_view and outs and name not in _NO_TRAFFIC:
            by = _BYTES.get(packet)
            moved = (by(*args, **kwargs, out_val=out) if by is not None
                     else _nbytes(_tensors((args, kwargs))) + _nbytes(outs))
            c.bytes += moved
            c.bytes_by_op[name] += moved
            c.out_bytes += _nbytes(outs)
        for t in outs:
            self.hold(t.untyped_storage())


@functools.cache
def _quiet_sharding_propagation() -> None:
    """DTensor works out an op's global output shape, the first time it
    meets the op's shapes and placements, by running the op on global-shape
    fakes of the active FakeTensorMode; no rank runs that, so it is not
    counted."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    meta = ShardingPropagator._propagate_tensor_meta_non_cached

    @functools.wraps(meta)
    def quiet(self, op_schema):
        with uncounted(hold=False):
            return meta(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = quiet


def count_step(fn: Callable, *args, **kwargs) -> tuple[Any, TraceCounts]:
    """(fn(*args, **kwargs), its TraceCounts): `fn` runs once under the
    counting mode (inside the caller's FakeTensorMode, for a dry run; a
    real run counts the same way).  The arguments' storages count as held
    from the start (`argument_bytes`)."""
    _quiet_sharding_propagation()
    counts = TraceCounts()
    mode = _CountingMode(counts)
    seen: set = set()
    for t in local_tensors((args, kwargs)):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            counts.argument_bytes += st.nbytes()
            mode.hold(st)
    t0 = time.perf_counter()
    with mode:
        out = fn(*args, **kwargs)
    counts.seconds = time.perf_counter() - t0
    made = {id(t.untyped_storage()): t.untyped_storage().nbytes() for t in local_tensors(out)}
    counts.output_bytes = float(sum(made.values()))
    return out, counts
