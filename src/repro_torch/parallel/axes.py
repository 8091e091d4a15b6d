"""Logical activation-axis rules -> DTensor redistributions (MaxText-style).

Port of `repro/parallel/axes.py`.  Model code annotates activations with
LOGICAL axis names ("batch", "seq", "heads", "vocab", "experts", ...).  The
launch layer installs a mapping from logical names to mesh axes for the
duration of a step; outside any mapping (unit tests, single-device runs),
and on a plain tensor, constrain() is a no-op.  On a DTensor it is the
reference's `with_sharding_constraint`: a `redistribute` to the placements
of `spec_for`'s PartitionSpec.

Pinning the batch axis at layer boundaries keeps the activations sharded
by batch, so the weights are gathered to them (the ZeRO-3 schedule) and
not the other way round.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any

import torch

from repro_torch.parallel import sharding as sh
from repro_torch.utils import tree

_CTX: contextvars.ContextVar = contextvars.ContextVar("axis_rules", default=None)


@contextlib.contextmanager
def axis_rules(mesh, rules: dict[str, Any]):
    """rules: logical name -> mesh axis | tuple of axes | None."""
    tok = _CTX.set((mesh, dict(rules)))
    try:
        yield
    finally:
        _CTX.reset(tok)


def current_rules():
    return _CTX.get()


@contextlib.contextmanager
def restored_rules(ctx):
    """Re-enter rules `current_rules()` returned (None: no rules), e.g.
    in a backward recompute that runs on another thread."""
    tok = _CTX.set(ctx)
    try:
        yield
    finally:
        _CTX.reset(tok)


def _resolve(entry: Any, rules: dict) -> tuple:
    """logical entry -> flat tuple of mesh axis names."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        out: list = []
        for e in entry:
            out.extend(_resolve(e, rules))
        return tuple(out)
    mapped = rules.get(entry, None)
    if mapped is None:
        return ()
    if isinstance(mapped, (tuple, list)):
        return tuple(a for a in mapped if a is not None)
    return (mapped,)


def spec_for(shape: tuple, logical: tuple, mesh, rules: dict) -> sh.P:
    """Divisibility-checked PartitionSpec for `shape` from logical names."""
    entries = []
    used: set = set()
    for size, name in zip(shape, logical):
        axes = []
        prod = 1
        for a in _resolve(name, rules):
            if a in used or a not in mesh.axis_names:
                continue
            asz = mesh.shape[a]
            if size % (prod * asz) == 0:
                axes.append(a)
                prod *= asz
                used.add(a)
        entries.append(tuple(axes) if axes else None)
    return sh.P(*entries)


def is_distributed(x: Any) -> bool:
    """Whether `x` is a DTensor (a tensor spread over a mesh)."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def axis_size(logical: str) -> int:
    """The number of shards the current rules give the logical axis (1
    outside rules)."""
    ctx = _CTX.get()
    if ctx is None:
        return 1
    mesh, rules = ctx
    size = 1
    for a in _resolve(logical, rules):
        size *= mesh.shape[a] if a in mesh.axis_names else 1
    return size


def local_map(fn, logical: tuple, out: Any, *args):
    """fn(*args) on this rank's shards, for ops that have no DTensor rule
    but are local to a sharding (attention per (batch, head), a gather per
    batch row).  `logical[i]` names the logical axes of args[i]: the arg
    is redistributed to `spec_for`'s placements of them and taken local (a
    plain tensor counts as the same on every rank); None passes it to
    every rank as it is.  fn's output (a tensor, or a tuple of them with
    `out` a list) comes back as DTensors whose dims are placed by the
    names in `out`, each name sharded as it was on the inputs.  Off a mesh
    (no DTensor among the args) it is fn(*args)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    mesh, rules = _CTX.get()
    whole = [Replicate()] * len(mesh.axis_names)
    specs = [None if names is None else spec_for(tuple(a.shape), tuple(names), mesh, rules)
             for a, names in zip(args, logical)]
    taken = {}                  # logical name -> its entry on the inputs
    for names, spec in zip(logical, specs):
        for name, entry in zip(names or (), spec or ()):
            if name is not None:
                taken.setdefault(name, entry)
    placed = [None if spec is None else sh.placements(spec, mesh) for spec in specs]
    # the mesh dims the work is split over: an input whole along one of
    # them gets a partial gradient there (each rank's share of the sum)
    split = {i for pl in placed if pl is not None
             for i, p in enumerate(pl) if not isinstance(p, Replicate)}

    def take(a, pl):
        if pl is None:
            return a
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh.device_mesh, whole, run_check=False)
        grad = [Partial() if i in split and isinstance(p, Replicate) else p
                for i, p in enumerate(pl)]
        return a.redistribute(mesh.device_mesh, pl).to_local(grad_placements=grad)

    res = fn(*(take(a, pl) for a, pl in zip(args, placed)))
    single = not isinstance(res, (tuple, list))
    outs, names = ((res,), (out,)) if single else (res, out)
    wrapped = tuple(
        DTensor.from_local(t, mesh.device_mesh,
                           sh.placements(sh.P(*(taken.get(n) for n in nm)), mesh),
                           run_check=False)
        for t, nm in zip(outs, names))
    return wrapped[0] if single else wrapped


def mixing(values: Any):
    """A context in which plain tensors meeting the DTensors of `values` (a
    tree) count as replicated: DTensor's `implicit_replication` where
    `values` holds a DTensor, else nothing."""
    from torch.distributed.tensor.experimental import implicit_replication

    if any(is_distributed(v) for v in tree.leaves(values)):
        return implicit_replication()
    return contextlib.nullcontext()


def replicated_local(fn, *args):
    """fn(*args) on plain tensors, for ops that have no DTensor rule: every
    DTensor among `args` (trees of them too) is gathered whole onto every
    rank and taken local, and fn's tensor outputs come back as DTensors
    replicated on the same mesh (each rank computes the same values; a
    `constrain` after it keeps this rank's part).  Without a DTensor among
    `args` it is fn(*args)."""
    from torch.distributed.tensor import DTensor, Replicate

    found = [a for a in tree.leaves(list(args)) if isinstance(a, DTensor)]
    if not found:
        return fn(*args)
    mesh = found[0].device_mesh
    whole = [Replicate()] * mesh.ndim

    def local(a):
        return a.redistribute(mesh, whole).to_local() if isinstance(a, DTensor) else a

    def wrap(t):
        if isinstance(t, torch.Tensor):
            return DTensor.from_local(t, mesh, whole, run_check=False)
        return t

    return tree.map(wrap, fn(*tree.map(local, list(args))))


def constrain(x: torch.Tensor, *logical) -> torch.Tensor:
    """Pin `x` to the sharding its logical axes imply.  No-op outside rules
    or on a plain tensor."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    if len(logical) != x.dim():
        raise ValueError(f"constrain: {len(logical)} names for rank-{x.dim()} array")
    if not is_distributed(x):
        return x
    mesh, rules = ctx
    spec = spec_for(tuple(x.shape), tuple(logical), mesh, rules)
    return x.redistribute(mesh.device_mesh, sh.placements(spec, mesh))


def default_rules(cfg, mesh, batch_size: int) -> dict[str, Any]:
    """Standard logical->mesh mapping for one step."""
    dp = sh.dp_axes_for(batch_size, mesh, cfg.policy.dp_only)
    mdl = None if cfg.policy.dp_only else (
        "model" if "model" in mesh.axis_names else None
    )
    # decode attention must match the KV-cache layout (sharding.cache_pspec):
    # kv-heads-sharded cache -> per-head-local decode; hd-sharded cache ->
    # shard decode q/k on head_dim
    kv_divides = mdl is None or cfg.hkv_eff % mesh.shape[mdl] == 0
    return {
        "dec_heads": (mdl if kv_divides else None),
        "dec_hd": (None if kv_divides else mdl),
        "batch": dp,
        "seq": None,            # sequence/context parallelism: set to an axis
        "heads": mdl,
        "kv_heads": mdl,
        # never map head_dim to a mesh axis: it is the attention contraction
        # dim; spec_for drops non-divisible head counts to replicated instead
        "head_dim": None,
        "ff": mdl,
        "vocab": mdl,
        "experts": mdl,
        "embed": None,
        "inner": mdl,           # mamba/xlstm d_inner
        "cache_seq": None,
    }
