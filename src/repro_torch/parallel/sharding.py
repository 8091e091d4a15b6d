"""Logical sharding rules -> PartitionSpecs, and specs -> DTensor placements.

Port of `repro/parallel/sharding.py`; every function returns the
reference's spec for every leaf.

Mesh axes: ('pod', 'data', 'model') multi-pod, ('data', 'model') single-pod.
  batch    -> ('pod', 'data')           (DP; pod composes with data)
  d_model  -> 'data' when policy.fsdp_params (FSDP/ZeRO-3 within a pod)
  heads/ff/experts/vocab/inner dims -> 'model' (TP/EP)

Optimizer state inherits the param specs, so ZeRO-1 comes for free.

The functions read only a mesh's `.shape` (axis name -> size) and
`.axis_names`, so a shape-only stand-in drives them as it drives the
reference's.  `PartitionSpec` is the port's own, with jax's equality: a
tuple of one entry per tensor dim, each None, an axis name or a tuple of
names (a one-name tuple is its name, an empty one None).  `placements`
turns a spec into the DTensor placements of a `launch.mesh.Mesh`: mesh dim
i is `Shard(j)` where dim j's entry names axis i, else `Replicate()`.
DTensor splits a dim sharded over several mesh dims in mesh-dim order, so
a tuple entry whose axes are not in the mesh's order raises.
"""

from __future__ import annotations

import math
from typing import Any

from repro_torch.models.config import ModelConfig
from repro_torch.utils import tree


def _entry(e: Any) -> Any:
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        if not e:
            return None
        return e[0] if len(e) == 1 else e
    return e


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of names (sharded over their product, major to minor)."""

    tree_leaf = True   # a leaf of the port's trees, as a PartitionSpec is in jax's

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self) -> str:
        return "PartitionSpec(" + ", ".join(repr(e) for e in self) + ")"


P = PartitionSpec


def dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_axes_for(batch_size: int, mesh, dp_only: bool = False) -> tuple:
    """Largest preferred DP axis set whose size divides `batch_size`.

    Preference: all DP axes (plus 'model' for dp_only archs — pure DP), then
    progressively smaller sets.  B=1 long-context cells end up replicated."""
    base = list(dp_axes(mesh))
    candidates: list[tuple] = []
    if dp_only and "model" in mesh.axis_names:
        candidates.append(tuple(base + ["model"]))
    for i in range(len(base) + 1):          # drop 'pod' first, then 'data'
        candidates.append(tuple(base[i:]))
    for cand in candidates:
        if not cand or batch_size % math.prod(mesh.shape[a] for a in cand) == 0:
            return cand
    return ()


def _fsdp(cfg: ModelConfig, mesh):
    return "data" if (cfg.policy.fsdp_params and "data" in mesh.axis_names) else None


def _mdl(mesh):
    return "model" if "model" in mesh.axis_names else None


def param_pspec(path: tuple, leaf: Any, cfg: ModelConfig, mesh) -> P:
    """PartitionSpec for one parameter leaf, keyed on its tree path (dict
    keys and list indices, `utils.tree`) and rank.

    dp_only archs take no tensor parallelism (the batch is sharded over every
    axis instead) but still FSDP-shard params over 'data' for memory."""
    keys = list(path)
    name = keys[-1]
    fsdp = _fsdp(cfg, mesh)
    mdl = None if cfg.policy.dp_only else _mdl(mesh)
    stacked = "blocks" in keys           # block params carry a leading (R,) axis
    lead: tuple = (None,) if stacked else ()
    nd = leaf.ndim - len(lead)
    in_moe = cfg.moe is not None and "ffn" in keys

    def _divides(axis, size) -> bool:
        return axis is not None and size % mesh.shape[axis] == 0

    if name == "embed":
        return P(mdl, fsdp)
    if name == "lm_head":
        return P(fsdp, mdl)
    if name in ("wq", "wk", "wv") and nd == 3:        # (d, H, hd) attn / mlstm(din,nh,hd)
        # shard the HEAD dim only when it divides; never fall back to
        # head_dim, the attention contraction dim
        h = leaf.shape[len(lead) + 1]
        return P(*lead, fsdp, mdl if _divides(mdl, h) else None, None)
    if name == "wo" and nd == 3 and not in_moe:       # attn out (H, hd, d)
        h = leaf.shape[len(lead)]
        return P(*lead, mdl if _divides(mdl, h) else None, None, fsdp)
    if in_moe:
        if name == "router":
            return P(*lead, fsdp, mdl)
        if name in ("wi", "wg") and nd == 3:          # (E, d, f)
            return P(*lead, mdl, fsdp, None)
        if name == "wo" and nd == 3:                  # (E, f, d)
            return P(*lead, mdl, None, fsdp)
    if name in ("wi", "wg") and nd == 2:              # dense MLP (d, ff)
        return P(*lead, fsdp, mdl)
    if name == "wo" and nd == 2:                      # dense MLP out (ff, d)
        return P(*lead, mdl, fsdp)
    # mamba
    if name == "in_proj":
        return P(*lead, fsdp, mdl)
    if name == "out_proj":
        return P(*lead, mdl, fsdp)
    if name == "conv_w":
        return P(*lead, None, mdl)
    if name in ("conv_b", "dt_bias", "D"):
        return P(*lead, mdl)
    if name == "x_proj":
        return P(*lead, mdl, None)
    if name == "dt_proj":
        return P(*lead, None, mdl)
    if name == "A_log":
        return P(*lead, mdl, None)
    # xlstm
    if name == "up":
        return P(*lead, fsdp, mdl)
    if name == "down":
        return P(*lead, mdl, fsdp)
    if name == "wif":                                  # (din, nh, 2)
        return P(*lead, mdl, None, None)
    if name == "wx":                                   # (din, 4, din)
        return P(*lead, mdl, None, None)
    if name == "r":                                    # (nh, hd, 4, hd)
        return P(*lead, *([None] * nd))
    # norms, biases, gates
    return P(*lead, *([None] * nd))


def fit_pspec(spec: P, shape: tuple, mesh) -> P:
    """Make `spec` legal for `shape`: every sharded dim must divide evenly.

    Axes that do not divide their assigned dim are re-homed onto the first
    still-unsharded dim they DO divide (e.g. kv_heads=8 over model=16 moves
    to head_dim=128 — column parallelism inside the head), and dropped
    (replicated) only when nothing fits.
    """
    entries = list(spec) + [None] * (len(shape) - len(spec))
    norm: list[list] = []
    for e in entries[: len(shape)]:
        if e is None:
            norm.append([])
        elif isinstance(e, (tuple, list)):
            norm.append([a for a in e if a is not None])
        else:
            norm.append([e])

    placed: list[list] = []
    dropped: list = []
    for size, axes in zip(shape, norm):
        keep: list = []
        prod = 1
        for a in axes:
            asz = mesh.shape[a]
            if size % (prod * asz) == 0:
                keep.append(a)
                prod *= asz
            else:
                dropped.append(a)
        placed.append(keep)

    for a in list(dropped):
        asz = mesh.shape[a]
        for i, size in enumerate(shape):
            if not placed[i] and size % asz == 0:
                placed[i].append(a)
                dropped.remove(a)
                break

    return P(*(tuple(k) if k else None for k in placed))


def fit_specs(specs: Any, abstract: Any, mesh) -> Any:
    """Apply fit_pspec leaf-wise: specs tree (P leaves) x abstract tree."""
    return tree.map(lambda s, leaf: fit_pspec(s, tuple(leaf.shape), mesh), specs, abstract)


def param_specs(params: Any, cfg: ModelConfig, mesh) -> Any:
    raw = tree.map_with_path(lambda path, leaf: param_pspec(path, leaf, cfg, mesh), params)
    return fit_specs(raw, params, mesh)


def batch_specs(batch: Any, mesh, cfg: ModelConfig | None = None) -> Any:
    dp_only = bool(cfg is not None and cfg.policy.dp_only)

    def spec(leaf):
        if leaf.ndim == 0:
            return P()
        dp = dp_axes_for(leaf.shape[0], mesh, dp_only)
        return fit_pspec(P(dp, *([None] * (leaf.ndim - 1))), tuple(leaf.shape), mesh)

    return tree.map(spec, batch)


def cache_pspec(path: tuple, leaf: Any, cfg: ModelConfig, mesh,
                batch_size: int | None = None) -> P:
    """Decode-cache leaves carry a leading (R,) stack axis, then batch.

    When the batch dim cannot use all DP axes (long_500k B=1), the KV seq dim
    takes the spare DP axes instead — flash-decode style cache partitioning."""
    name = path[-1]
    if batch_size is None:
        batch_size = leaf.shape[1]
    dp = dp_axes_for(batch_size, mesh, cfg.policy.dp_only)
    spare = tuple(a for a in dp_axes(mesh) if a not in dp)
    mdl = _mdl(mesh) if not cfg.policy.dp_only else None
    if name in ("k", "v"):              # (R, B, T, Hkv, hd)
        if cfg.policy.seq_shard_cache:
            seq = (*spare, mdl) if mdl else spare
            return P(None, dp, seq if seq else None, None, None)
        # model axis: Hkv if it divides, else head_dim; never the seq dim,
        # where writing one position at a time would gather the whole cache
        hkv = leaf.shape[3]
        if mdl is not None and hkv % mesh.shape[mdl] == 0:
            return P(None, dp, spare if spare else None, mdl, None)
        return P(None, dp, spare if spare else None, None, mdl)
    if name == "conv":                   # (R, B, dconv-1, din)
        return P(None, dp, None, mdl)
    if name == "ssm":                    # (R, B, din, ds)
        return P(None, dp, mdl, None)
    if name == "c" and leaf.ndim == 5:   # mlstm (R, B, nh, hd, hd)
        return P(None, dp, None, None, None)
    if name == "n" and leaf.ndim == 4:   # mlstm (R, B, nh, hd)
        return P(None, dp, None, None)
    # slstm states (R, B, din) and mlstm scalars
    return P(None, dp, *([None] * (leaf.ndim - 2)))


def cache_specs(caches: Any, cfg: ModelConfig, mesh, batch_size: int | None = None) -> Any:
    raw = tree.map_with_path(
        lambda path, leaf: cache_pspec(path, leaf, cfg, mesh, batch_size), caches)
    return fit_specs(raw, caches, mesh)


def logits_spec(mesh) -> P:
    return P(dp_axes(mesh), None, _mdl(mesh))


def replicated(mesh) -> list:
    """The placements of a tensor every rank holds whole."""
    return placements(P(), mesh)


# ------------------------------------------------------------ placements ----


class NamedSharding:
    """A spec on a mesh (the reference's `NamedSharding`): where a leaf of
    a tree goes, e.g. in `checkpoint.store.restore`."""

    def __init__(self, mesh, spec: P):
        self.mesh, self.spec = mesh, spec

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh}, {self.spec})"


def named(mesh, specs: Any) -> Any:
    """A tree of PartitionSpecs as NamedShardings on `mesh`."""
    return tree.map(lambda s: NamedSharding(mesh, s), specs)



def placements(spec: P, mesh) -> list:
    """The DTensor placements of `spec` on `mesh`, one per mesh dim:
    `Shard(j)` on the mesh dims that tensor dim j's entry names (of more
    than one rank), else `Replicate()`.  An entry naming several axes must name them in mesh
    order (DTensor splits a dim over its mesh dims in that order)."""
    from torch.distributed.tensor import Replicate, Shard

    out: list = [Replicate() for _ in mesh.axis_names]
    for j, e in enumerate(spec):
        names = () if e is None else (e,) if isinstance(e, str) else tuple(e)
        order = [mesh.axis_names.index(a) for a in names]
        if order != sorted(order):
            raise ValueError(f"{spec}: axes {names} of dim {j} are not in the mesh's order "
                             f"{mesh.axis_names}; DTensor cannot shard a dim that way")
        for i in order:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: mesh axis {mesh.axis_names[i]!r} is used twice")
            if mesh.shape[mesh.axis_names[i]] > 1:     # an axis of one rank splits nothing
                out[i] = Shard(j)
    return out


def spec_of(place: Any, mesh, ndim: int) -> P:
    """The PartitionSpec of DTensor placements (`placements`' inverse)."""
    from torch.distributed.tensor import Shard

    dims: list[list] = [[] for _ in range(ndim)]
    for name, pl in zip(mesh.axis_names, place):
        if isinstance(pl, Shard):
            dims[pl.dim].append(name)
    return P(*(tuple(d) if d else None for d in dims))


# ------------------------------------------------------- placing tensors ----


def local_slices(shape: tuple, mesh, spec: P) -> tuple:
    """The index of this rank's shard of a tensor of `shape` under `spec`:
    each sharded dim's range split as `torch.chunk` splits it (DTensor's
    split), mesh dims in order."""
    from torch.distributed.tensor import Shard

    start, stop = [0] * len(shape), list(shape)
    for axis, pl in zip(mesh.axis_names, placements(spec, mesh)):
        if isinstance(pl, Shard):
            d = pl.dim
            step = -(-(stop[d] - start[d]) // mesh.shape[axis])
            start[d] = min(start[d] + mesh.coordinate(axis) * step, stop[d])
            stop[d] = min(start[d] + step, stop[d])
    return tuple(slice(a, b) for a, b in zip(start, stop))


def local_part(full, mesh, spec: P):
    """This rank's shard of `full` (a tensor or array, the same on every
    rank) under `spec` (a view)."""
    return full[local_slices(tuple(full.shape), mesh, spec)]


def from_shard(local, mesh, spec: P, shape):
    """A DTensor of global `shape` placed by `spec`, from this rank's
    shard (no communication)."""
    import torch
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh.device_mesh, placements(spec, mesh), run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def distribute(full, mesh, spec: P):
    """`full` (the same on every rank) as a DTensor placed by `spec`: each
    rank keeps its shard, with no communication."""
    return from_shard(local_part(full, mesh, spec).contiguous(), mesh, spec, full.shape)


def distribute_tree(values: Any, specs: Any, mesh) -> Any:
    return tree.map(lambda v, s: distribute(v, mesh, s), values, specs)


def gather(x):
    """A DTensor's whole value on every rank (a plain tensor as it is)."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x
