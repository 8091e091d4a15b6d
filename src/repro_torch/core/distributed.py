"""Sharded active-search tier: query cost independent of N *per shard*,
with the index staying MUTABLE while it serves.

Port of `repro/core/distributed.py`.  The datastore of N points is split
into `n_shards` shards; every shard builds its OWN grid over the SAME
global extents, with GLOBAL point ids.  A query runs active search on
every shard, then the per-shard top-k lists (k * n_shards values — small)
are merged by a (distance, global id) lexicographic sort.

Per-shard query cost stays N-independent (the paper's property); the merge
is O(k * n_shards), independent of N.

Placement is by GRID-CELL OWNERSHIP: cell c lives on shard c % n_shards, so
a point's shard is a pure function of its coordinates (via the shared
projection), never of arrival order.  That determinism is what makes the
sharded tier mutable with the same headline invariant the dense tier has
(core/mutable.py):

    build_sharded(P1).insert(P2).search(Q) == build_sharded(P1 ∪ P2).search(Q)

bit for bit — both sides route every point to the same shard, per-shard
contents land in arrival order (routing preserves batch order), and the
per-shard grids are then bit-identical by the mutable subsystem's own
insert == rebuild invariant.  Each shard owns whole cells, so a `snapshot()`
merge of the per-shard CSR stores reproduces the UNSHARDED `build_index`
order exactly (`merge_to_dense`).

Two placements.  With `n_shards` every shard sits on one device, in ONE
stacked `GridIndex` whose tensors carry a leading shard dimension, and the
shards are searched one after another.  With `mesh` and `axis` (a
`launch.mesh.Mesh`; the reference's placement, `_place` + `shard_map`)
shard s lives only on rank s of `axis`: each rank builds, searches and
mutates its own shard (a dense `GridIndex`, padded as its slice of the
stacked one), and explicit collectives over the axis's process group
gather the per-shard top-k lists and reduce the statistics; every rank
routes whole batches (routing depends only on coordinates) and applies
only its own shard's part.  Mutation state is host-driven:
`ShardedMutable` holds one `mutable.MutableIndex` per shard (shapes differ
per shard, so they are not stacked).  Searches run on the stacked,
pow2-PADDED snapshot (`stacked_snapshot`): every per-shard CSR array is
padded to a common power-of-two row capacity; rows past `offsets[-1]` are
unreachable (every gather derives its spans from offsets), but the padded
length decides where a window's clamped span starts, so each shard is
searched on its padded records, as the reference searches them.  A shard
whose spill log overflows compacts ALONE (`mutable.insert_tracked`) —
sibling shards are untouched, which keeps the pause local in a serving
tier.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as tdist

from repro_torch.core import mutable as mut
from repro_torch.core import projection as proj_lib
from repro_torch.core.active_search import SearchResult
from repro_torch.core.grid import (
    GridConfig,
    GridIndex,
    as_tensor,
    build_index,
    cell_id_of,
    resolve_device,
)
from repro_torch.core.projection import Projection

_I32 = torch.int32


# ------------------------------------------------------------ cell routing ---


def shard_of_cells(cid: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Deterministic grid-cell ownership: cell c lives on shard c % n_shards.

    Ownership is a PARTITION of the cells (every cell on exactly one
    shard), and a pure function of the cell — so a point's shard depends
    only on its coordinates and the shared projection, never on arrival
    order or on what else is in the index."""
    return cid % n_shards


def shard_of_points(
    points: torch.Tensor, cfg: GridConfig, proj: Projection, n_shards: int
) -> torch.Tensor:
    """(N,) int32 owning shard per point — the routing used by build and
    insert (the same `to_grid_coords` + `cell_id_of` every other consumer
    quantizes with)."""
    coords = proj_lib.to_grid_coords(proj, points.to(torch.float32), cfg.grid_size)
    return shard_of_cells(cell_id_of(coords, cfg.padded_size), n_shards)


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _pad_records(idx: GridIndex, cap: int) -> GridIndex:
    """Pad the per-shard CSR record arrays to `cap` rows with dead records.

    The pad rows sit PAST offsets[-1], and every consumer (search gathers,
    snapshot slicing, `open_sharded`) derives its spans from offsets — the
    tail is never read as a record, it only makes shard shapes equal for
    stacking."""
    pad = cap - idx.points_sorted.shape[0]
    if pad == 0:
        return idx

    def ext(a: torch.Tensor, fill) -> torch.Tensor:
        return torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]), fill)])

    return idx._replace(
        points_sorted=ext(idx.points_sorted, 0.0),
        coords_sorted=ext(idx.coords_sorted, 0.0),
        labels_sorted=ext(idx.labels_sorted, -1),
        ids_sorted=ext(idx.ids_sorted, -1),
    )


def _stack(parts):
    """Stack a field across shards: tensors, (named) tuples of them, or None."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(parts)
    fields = [_stack([p[i] for p in parts]) for i in range(len(first))]
    return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)


def stack_shard_indexes(shards: list[GridIndex]) -> GridIndex:
    """Stack per-shard indexes into one GridIndex with a leading shard dim.

    Record arrays are padded to a common pow2 capacity first (dead tail, see
    `_pad_records`), as the reference pads them to bound its compiled
    shapes; the padded length is kept because it decides where a window's
    clamped span starts."""
    cap = _pow2(max(1, max(s.points_sorted.shape[0] for s in shards)))
    padded = [_pad_records(s, cap) for s in shards]
    return _stack(padded)


def shard(index: GridIndex, s: int) -> GridIndex:
    """Shard s of a stacked index: every tensor's leading index s (views,
    no copy), the pow2 pad tail included."""
    def take(a):
        if a is None:
            return None
        if isinstance(a, torch.Tensor):
            return a[s]
        parts = [take(x) for x in a]
        return type(a)(*parts) if hasattr(a, "_fields") else tuple(parts)

    return take(index)


def n_shards_of(index: GridIndex) -> int:
    return index.offsets.shape[0]


def build_sharded_index(
    points,
    cfg: GridConfig,
    proj: Projection,
    n_shards: int | None = None,
    labels=None,
    ids=None,
    device=None,
    mesh=None,
    axis: str | None = None,
) -> GridIndex:
    """Build one grid index per shard, points routed by cell ownership, on
    `device` (None = the card).

    Returns a GridIndex whose tensors carry a leading shard dimension of
    size n_shards.  Routing preserves the caller's point order within each
    shard (arrival order is a per-shard notion), and `ids` default to the
    global arange — exactly what an unsharded `build_index` would assign.

    With `mesh` and `axis` instead (every rank passing the same points),
    one shard per rank of `axis` on the mesh's device: each rank builds
    only its own shard and returns it, its records padded to the stacked
    layout's common capacity (the largest shard's count is known from the
    routing alone, so no communication).
    """
    if mesh is not None:
        n_shards, dev = mesh.shape[axis], mesh.device
    elif n_shards is None or n_shards <= 0:
        raise ValueError(f"n_shards must be positive, got {n_shards}")
    else:
        dev = resolve_device(device)
    points = as_tensor(points, torch.float32, dev)
    n = points.shape[0]
    labels = (torch.zeros((n,), dtype=_I32, device=dev) if labels is None
              else as_tensor(labels, _I32, dev))
    ids = (torch.arange(n, dtype=_I32, device=dev) if ids is None
           else as_tensor(ids, _I32, dev))
    proj = proj.to(dev)

    owner = shard_of_points(points, cfg, proj, n_shards)
    if mesh is not None:
        sel = torch.nonzero(owner == mesh.coordinate(axis)).flatten()
        own = build_index(points[sel], cfg, proj, labels=labels[sel], ids=ids[sel])
        largest = int(torch.bincount(owner, minlength=n_shards).max())
        return _pad_records(own, _pow2(max(1, largest)))
    shards = []
    for s in range(n_shards):
        sel = torch.nonzero(owner == s).flatten()  # order-preserving
        shards.append(build_index(points[sel], cfg, proj, labels=labels[sel], ids=ids[sel]))
    return stack_shard_indexes(shards)


# -------------------------------------------------------------------- search -


def merge_topk(d_flat: torch.Tensor, i_flat: torch.Tensor, l_flat: torch.Tensor, k: int):
    """The k best of (B, S*k) concatenated per-shard lists by (distance,
    global id): (ids, dists, labels, valid), each (B, k), with -1 ids and
    labels where the distance is not finite.

    Two stable sorts give the lexicographic order (the reference's
    `lax.sort(num_keys=2, is_stable=True)`): by id, then by distance; +inf
    lanes sort last."""
    by_id = torch.sort(i_flat, dim=1, stable=True).indices
    by_dist = torch.sort(torch.gather(d_flat, 1, by_id), dim=1, stable=True).indices
    top = torch.gather(by_id, 1, by_dist)[:, :k]
    top_d = torch.gather(d_flat, 1, top)
    ok = torch.isfinite(top_d)
    none = torch.full(top.shape, -1, dtype=_I32, device=top.device)
    return (
        torch.where(ok, torch.gather(i_flat, 1, top), none),
        top_d,
        torch.where(ok, torch.gather(l_flat, 1, top), none),
        ok,
    )


def _gather(t: torch.Tensor, mesh, axis: str) -> list[torch.Tensor]:
    """Every rank's `t` (same shape on each) along `axis`, in rank order."""
    parts = [torch.empty_like(t) for _ in range(mesh.shape[axis])]
    tdist.all_gather(parts, t.contiguous(), group=mesh.group(axis))
    return parts


def _reduce(t: torch.Tensor, op, mesh, axis: str) -> torch.Tensor:
    out = t.clone()
    tdist.all_reduce(out, op, group=mesh.group(axis))
    return out


def replicate_queries(queries, mesh) -> torch.Tensor:
    """The queries of the mesh's first rank on every rank (on the mesh's
    device), as the reference replicates them over its mesh."""
    q = as_tensor(queries, torch.float32, mesh.device).contiguous()
    tdist.broadcast(q, 0)
    return q


def _mesh_search(index, cfg, queries, k, mode, adaptive_r0, mesh, axis) -> SearchResult:
    """This rank's shard searched on `torch`, the per-shard lists gathered
    over `axis` and merged; the statistics reduced as the reference's
    `shard_map` body reduces them."""
    from repro_torch.core import engine as eng

    plan = eng.ExecutionPlan(backend="torch", adaptive_r0=adaptive_r0)
    res = eng.ActiveSearcher(index=index, cfg=cfg, plan=plan).search(queries, k, mode=mode)
    flat = lambda t: torch.cat(_gather(t, mesh, axis), dim=1)  # noqa: E731  (B, S*k)
    ids, dists, labels, valid = merge_topk(flat(res.dists), flat(res.ids), flat(res.labels), k)
    red = lambda t, op: _reduce(t, op, mesh, axis)  # noqa: E731
    op = tdist.ReduceOp
    return SearchResult(
        ids=ids, dists=dists, labels=labels, valid=valid,
        radius=red(res.radius, op.MAX),
        count=red(res.count.to(_I32), op.SUM),
        iters=red(res.iters, op.MAX),
        converged=red(res.converged.to(_I32), op.MIN) > 0,
        truncated=red(res.truncated.to(_I32), op.MAX) > 0,
    )


def sharded_search(
    index: GridIndex,
    cfg: GridConfig,
    queries: torch.Tensor,
    k: int,
    mode: str = "refined",
    adaptive_r0: bool = False,
    mesh=None,
    axis: str | None = None,
) -> SearchResult:
    """Active search over the stacked sharded index; queries (B, d).

    Registered as backend "sharded" in the engine registry (core/engine.py):
    every shard runs its OWN per-shard ActiveSearcher handle on the `torch`
    plan (the reference's `jnp`), then the per-shard top-k lists are
    merged.  Returns the globally merged top-k per query (ids are global
    point ids).  `adaptive_r0` seeds each shard's Eq.-1 loop from that
    shard's OWN pyramid.

    MERGE TIE-BREAK: the merged list is ordered by (distance, global id) —
    equal distances resolve to ascending global id, independent of which
    shard produced them or where the record sits in a shard's CSR store.
    Invalid lanes (dist = +inf) sort last.  The diagnostics are reduced
    across shards: radius and iters by max, count by sum, converged by all,
    truncated by any.

    With `mesh` and `axis`, `index` is this rank's shard
    (`build_sharded_index(..., mesh=)`) and the queries are replicated
    (`replicate_queries`): each rank searches its shard, the (B, k) lists
    are gathered over the axis's group, merged alike on every rank, and the
    statistics reduced over it.
    """
    if mesh is not None:
        return _mesh_search(index, cfg, queries, k, mode, adaptive_r0, mesh, axis)
    # function-level import: engine registers this module's search as a
    # backend, so a top-level import would be circular
    from repro_torch.core import engine as eng

    plan = eng.ExecutionPlan(backend="torch", adaptive_r0=adaptive_r0)
    res = [
        eng.ActiveSearcher(index=shard(index, s), cfg=cfg, plan=plan).search(queries, k, mode=mode)
        for s in range(n_shards_of(index))
    ]
    # (B, S*k), shard-major within a row, as the reference's all_gather
    ids, dists, labels, valid = merge_topk(
        torch.cat([r.dists for r in res], dim=1),
        torch.cat([r.ids for r in res], dim=1),
        torch.cat([r.labels for r in res], dim=1),
        k,
    )
    stat = lambda f: torch.stack([getattr(r, f) for r in res])  # noqa: E731
    return SearchResult(
        ids=ids,
        dists=dists,
        labels=labels,
        valid=valid,
        radius=stat("radius").amax(dim=0),
        count=stat("count").sum(dim=0, dtype=_I32),
        iters=stat("iters").amax(dim=0),
        converged=stat("converged").all(dim=0),
        truncated=stat("truncated").any(dim=0),
    )


# ---------------------------------------------------------- sharded mutation -


class ShardedMutable(NamedTuple):
    """Serving-tier mutation state of a sharded handle (host-driven).

    One `mutable.MutableIndex` per shard — per-shard CSR capacities differ,
    so the states live in a host tuple rather than a stacked tensor tree.
    `next_id` is the GLOBAL auto-id high-water mark (per-shard next_id only
    tracks what that shard has seen).  `compactions`/`compact_s` accumulate
    the shard-LOCAL overflow compactions (`mutable.insert_tracked`): a full
    shard compacts alone while its siblings keep their states untouched.
    """

    states: tuple
    next_id: int
    compactions: int = 0
    compact_s: float = 0.0
    # on a mesh: `states` holds this rank's shard only, shard
    # mesh.coordinate(axis)
    mesh: Any = None
    axis: str | None = None

    @property
    def n_shards(self) -> int:
        return len(self.states) if self.mesh is None else self.mesh.shape[self.axis]

    @property
    def n_live(self) -> int:
        """Live records of the shards held here (this rank's, on a mesh)."""
        return sum(int(s.n_live) for s in self.states)

    def held(self) -> list[tuple[int, int]]:
        """(shard, position in `states`) of each state held here."""
        if self.mesh is None:
            return [(s, s) for s in range(len(self.states))]
        return [(self.mesh.coordinate(self.axis), 0)]


def live_shard(index: GridIndex, s: int | None) -> GridIndex:
    """Shard s of a stacked index (s None: a single shard's padded index)
    cut to its live prefix (the rows before offsets[-1]; the pow2 pad tail
    is dead by construction)."""
    idx = index if s is None else shard(index, s)
    n_s = int(idx.offsets[-1])
    return idx._replace(
        points_sorted=idx.points_sorted[:n_s],
        coords_sorted=idx.coords_sorted[:n_s],
        labels_sorted=idx.labels_sorted[:n_s],
        ids_sorted=idx.ids_sorted[:n_s],
    )


def open_sharded(
    index: GridIndex, cfg: GridConfig, spill_capacity: int | None = None,
    mesh=None, axis: str | None = None,
) -> ShardedMutable:
    """Open a STACKED sharded index for mutation: each shard's live prefix
    becomes its own `mutable.from_index` state, on the index's device.
    With `mesh`, `index` is this rank's shard and only it is opened; the
    global next id is the largest over the axis."""
    if mesh is not None:
        state = mut.from_index(live_shard(index, None), cfg, spill_capacity=spill_capacity)
        top = _reduce(torch.tensor(int(state.next_id), device=mesh.device),
                      tdist.ReduceOp.MAX, mesh, axis)
        return ShardedMutable(states=(state,), next_id=int(top), mesh=mesh, axis=axis)
    states = tuple(
        mut.from_index(live_shard(index, s), cfg, spill_capacity=spill_capacity)
        for s in range(n_shards_of(index))
    )
    next_id = max(int(st.next_id) for st in states) if states else 0
    return ShardedMutable(states=states, next_id=next_id)


def sharded_insert(
    sm: ShardedMutable,
    cfg: GridConfig,
    points,
    labels=None,
    ids=None,
) -> ShardedMutable:
    """Route an insert batch to its owning shards and delta-insert per shard.

    Routing is order-preserving, so each shard receives its sub-batch in
    arrival order — together with cell ownership this is what makes sharded
    insert bit-identical to a sharded rebuild of the union.  A shard whose
    spill log overflows compacts ALONE (`mutable.insert_tracked`); siblings
    keep their exact state objects.  On a mesh every rank routes the whole
    batch and inserts its own shard's part."""
    dev = sm.states[0].device
    points = as_tensor(points, torch.float32, dev)
    mn = points.shape[0]
    if mn == 0:
        return sm
    labels = (torch.zeros((mn,), dtype=_I32, device=dev) if labels is None
              else as_tensor(labels, _I32, dev))
    ids = (sm.next_id + torch.arange(mn, dtype=_I32, device=dev) if ids is None
           else as_tensor(ids, _I32, dev))

    owner = shard_of_points(points, cfg, sm.states[0].proj, sm.n_shards)
    states = list(sm.states)
    compactions, compact_s = sm.compactions, sm.compact_s
    for s, i in sm.held():
        sel = torch.nonzero(owner == s).flatten()
        if not sel.numel():
            continue
        states[i], report = mut.insert_tracked(
            states[i], cfg, points[sel], labels=labels[sel], ids=ids[sel]
        )
        compactions += report.compactions
        compact_s += report.compact_s
    return sm._replace(
        states=tuple(states),
        next_id=max(sm.next_id, int(ids.max()) + 1),
        compactions=compactions,
        compact_s=compact_s,
    )


def sharded_delete(
    sm: ShardedMutable, cfg: GridConfig, ids, strict: bool = True
) -> ShardedMutable:
    """Tombstone the given global ids on whichever shards carry them.

    Matching is GLOBAL: with strict=True every asked id must be live
    somewhere (same KeyError contract as the dense `mutable.delete`), but a
    given id is allowed to live on several shards (caller-supplied id
    collisions) — every carrier dies, like the dense path.  On a mesh the
    match is taken over the axis (every rank sees the same answer) and each
    rank tombstones its own shard's carriers."""
    ids = as_tensor(ids, _I32, sm.states[0].device).reshape(-1)
    if ids.shape[0] == 0:
        return sm
    present = [mut.ids_live_mask(st, ids) for st in sm.states]
    if strict:
        matched_any = torch.stack(present).any(dim=0)
        if sm.mesh is not None:
            matched_any = _reduce(matched_any.to(_I32), tdist.ReduceOp.MAX, sm.mesh, sm.axis) > 0
        n_asked = torch.unique(ids).numel()
        n_matched = torch.unique(ids[matched_any]).numel()
        if n_matched != n_asked:
            raise KeyError(
                f"delete: {n_asked - n_matched} of {n_asked} ids are not "
                f"live in the index (already deleted, or never inserted)"
            )
    states = list(sm.states)
    for s in range(len(states)):
        if bool(present[s].any()):
            states[s] = mut.delete(states[s], cfg, ids[present[s]], strict=False)
    return sm._replace(states=tuple(states))


def stacked_snapshot(sm: ShardedMutable, cfg: GridConfig) -> GridIndex:
    """Freeze the sharded mutation state into the stacked searchable layout
    (per-shard `mutable.snapshot`, then pow2-pad + stack).  On a mesh: this
    rank's shard, padded to the capacity the largest shard on the axis
    gives the stacked layout."""
    if sm.mesh is None:
        return stack_shard_indexes([mut.snapshot(st, cfg) for st in sm.states])
    own = mut.snapshot(sm.states[0], cfg)
    rows = torch.tensor(own.points_sorted.shape[0], device=own.device)
    largest = int(_reduce(rows, tdist.ReduceOp.MAX, sm.mesh, sm.axis))
    return _pad_records(own, _pow2(max(1, largest)))


def gather_stacked(index: GridIndex, mesh, axis: str) -> GridIndex:
    """The stacked layout of the shards on `axis` (each rank's padded
    shard `index`), on every rank: what `build_sharded_index(...,
    n_shards=)` gives on one device."""
    def stack(a):
        if a is None:
            return None
        if isinstance(a, torch.Tensor):
            return torch.stack(_gather(a, mesh, axis))
        parts = [stack(x) for x in a]
        return type(a)(*parts) if hasattr(a, "_fields") else tuple(parts)

    return stack(index)


def merge_to_dense(index: GridIndex, cfg: GridConfig) -> GridIndex:
    """Merge a stacked sharded index into ONE dense GridIndex, bit-identical
    to `build_index` over the same points in their original arrival order.

    Every grid cell is wholly owned by one shard and routing preserved
    arrival order within each shard, so concatenating the per-shard live
    prefixes in shard order gives a point sequence whose STABLE cell-major
    sort (what `build_index` does) reproduces the unsharded CSR order
    exactly: within a cell all records come from one shard, already in
    arrival order; across cells the sort key decides, same as unsharded."""
    parts = [live_shard(index, s) for s in range(n_shards_of(index))]
    return build_index(
        torch.cat([p.points_sorted for p in parts]), cfg, parts[0].proj,
        labels=torch.cat([p.labels_sorted for p in parts]),
        ids=torch.cat([p.ids_sorted for p in parts]),
    )


def live_points(index: GridIndex, mesh=None, axis: str | None = None) -> int:
    """Live records of a dense or stacked index (the per-shard live
    prefixes summed), or of every shard on a mesh's axis."""
    n = index.offsets[..., -1].sum()
    if mesh is not None:
        n = _reduce(n, tdist.ReduceOp.SUM, mesh, axis)
    return int(n)


def sharded_stats(sm: ShardedMutable) -> dict:
    """Serving-tier facts for ActiveSearcher.stats() (on a mesh, over the
    axis: every rank's shard, compactions summed, the slowest's seconds)."""
    points = [int(s.n_live) for s in sm.states]
    compactions, compact_s = sm.compactions, sm.compact_s
    if sm.mesh is not None:
        dev = sm.mesh.device
        points = [int(p) for p in _gather(torch.tensor(points, device=dev), sm.mesh, sm.axis)]
        compactions = int(_reduce(torch.tensor(compactions, device=dev),
                                  tdist.ReduceOp.SUM, sm.mesh, sm.axis))
        compact_s = float(_reduce(torch.tensor(compact_s, device=dev),
                                  tdist.ReduceOp.MAX, sm.mesh, sm.axis))
    return {
        "n_shards": sm.n_shards,
        "shard_points": points,
        "compactions": compactions,
        "compact_s": compact_s,
    }
