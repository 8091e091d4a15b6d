"""Mutable grid index — streaming insert/delete as DELTA updates.

Port of `repro/core/mutable.py`.  `build_index` produces a frozen
snapshot: CSR buckets packed edge to edge, pyramid summed from scratch,
tiles flattened once.  Serving workloads need the index to GROW without
paying the O(N log N) rebuild, so this module keeps the same structure in
a mutable layout:

  * the CSR record arrays get per-cell SLACK — each bucket is allocated
    `capacity >= size` slots, so an insert into a bucket with free slots is
    one scatter per record field;
  * inserts that do not fit their bucket (full bucket, or a cell that was
    empty at layout time) go to a SPILL log, an append-only slab merged back
    into cell order by `snapshot()`/`compact()` with an O(N) order-preserving
    merge (no argsort over N);
  * deletes tombstone their slot (`live=False`) — bucket order is preserved,
    the slot is reclaimed at the next `compact()`;
  * the count pyramid is maintained exactly by scatter-adding +/-1 at every
    level for each touched cell (integer adds, so the result is bit-identical
    to a from-scratch `build_pyramid`), and only the DIRTY T-tiles of the
    flattened `pyr_tiles` layout are re-gathered;
  * when the spill log itself overflows, `insert` takes the escape hatch:
    `compact()` (re-layout with fresh slack; order-preserving, no sort) by
    default, or raises `BucketOverflow` with `on_overflow="raise"`.

The headline invariant: for any split P = P1 ∪ P2,

    snapshot(insert(from_index(build_index(P1)), P2)) == build_index(P)

bit for bit, and the state itself equals the reference's array for array.

Three differences from JAX shape this module:

  * Tensors are mutable; JAX arrays are not, and the reference's isolation
    rests on that.  Every update here writes NEW tensors (out-of-place
    `index_put`, or a scatter into a tensor made for it) and shares the
    ones it does not change, so a parent state, a snapshot taken earlier
    and a second insert from the same parent never see each other's
    writes.
  * JAX drops out-of-range scatters and clamps gathers; PyTorch raises on
    the CPU and asserts on the card.  Every index here is filtered to the
    rows it writes before it is used.
  * The reference pads batches to a power of two only to bound its jit
    compiles.  Nothing here is compiled per shape, so nothing is padded;
    the state is the same.

The state lives on its index's device; the count of spill slots a batch
needs, the overflow test and `delete`'s strict accounting read the device,
as the reference's do.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import integral as integral_lib
from repro_torch.core import projection as proj_lib
from repro_torch.core import quantized as qz
from repro_torch.core.grid import (
    GridConfig,
    GridIndex,
    as_tensor,
    build_index,
    cell_id_of,
    flatten_pyramid_tiles,
    resolve_device,
)
from repro_torch.core.projection import Projection
from repro_torch.kernels.ref import level_tile_offsets
from repro_torch.utils.spans import span

_I32 = torch.int32


class BucketOverflow(RuntimeError):
    """An insert did not fit the bucket slack and the spill log is full.

    Raised only with `on_overflow="raise"`; the default policy compacts the
    layout (fresh slack, spill merged back into buckets) and retries.
    """


class Slab(NamedTuple):
    """One block of CSR slot storage (the bucketed base, or the spill log).

    Dead/free slots carry `ids == -1`, `cell == -1`, `live == False`.
    """

    points: torch.Tensor  # (cap, d) float32
    coords: torch.Tensor  # (cap, 2) float32
    labels: torch.Tensor  # (cap,) int32
    ids: torch.Tensor     # (cap,) int32
    cell: torch.Tensor    # (cap,) int32 — flat base cell id of the slot's record
    live: torch.Tensor    # (cap,) bool


class MutableIndex(NamedTuple):
    """A grid index open for streaming mutation: tensors on one device.

    `base` holds the bucketed records: bucket c occupies slots
    [cap_offsets[c], cap_offsets[c+1]); the first `used[c]` slots of the
    bucket have been handed out (some may be tombstoned), the rest are free.
    `spill` is the append-only overflow log in ARRIVAL order; `spilled[c]`
    pins a cell to the spill log once any of its inserts spilled, so bucket
    slots never receive records that must sort AFTER spilled ones.
    """

    proj: Projection
    base: Slab
    spill: Slab
    cap_offsets: torch.Tensor  # (G*G + 1,) int32 bucket capacity prefix sum
    used: torch.Tensor         # (G*G,) int32 slots handed out per bucket
    spilled: torch.Tensor      # (G*G,) bool — cell routes to the spill log
    spill_used: torch.Tensor   # () int32 — occupied prefix of the spill slab
    pyramid: tuple[torch.Tensor, ...]
    pyr_tiles: torch.Tensor | None
    next_id: torch.Tensor      # () int32 — next auto-assigned global id
    n_live: torch.Tensor       # () int32 — live records (base + spill)

    @property
    def spill_capacity(self) -> int:
        return self.spill.ids.shape[0]

    @property
    def free_bucket_slots(self) -> torch.Tensor:
        """() int32 — total unallocated bucket slots across all cells."""
        caps = self.cap_offsets[1:] - self.cap_offsets[:-1]
        return (caps - self.used).sum(dtype=_I32)

    @property
    def device(self) -> torch.device:
        return self.used.device


# ------------------------------------------------------------ construction ---


def _empty_slab(cap: int, d: int, device) -> Slab:
    return Slab(
        points=torch.zeros((cap, d), dtype=torch.float32, device=device),
        coords=torch.zeros((cap, 2), dtype=torch.float32, device=device),
        labels=torch.zeros((cap,), dtype=_I32, device=device),
        ids=torch.full((cap,), -1, dtype=_I32, device=device),
        cell=torch.full((cap,), -1, dtype=_I32, device=device),
        live=torch.zeros((cap,), dtype=torch.bool, device=device),
    )


def _rows(mask: torch.Tensor) -> torch.Tensor:
    """The indices where `mask` holds (one read of the device)."""
    return torch.nonzero(mask).flatten()


def _scatter_slab(slab: Slab, pos: torch.Tensor, rows: torch.Tensor, *,
                  points, coords, labels, ids, cell) -> Slab:
    """NEW copies of `slab`'s tensors with the batch records `rows`
    written at slots `pos[rows]` (the reference's drop mode, as a
    selection)."""
    idx = (pos[rows].long(),)
    true = torch.ones((), dtype=torch.bool, device=rows.device)
    return Slab(
        points=slab.points.index_put(idx, points[rows]),
        coords=slab.coords.index_put(idx, coords[rows]),
        labels=slab.labels.index_put(idx, labels[rows]),
        ids=slab.ids.index_put(idx, ids[rows]),
        cell=slab.cell.index_put(idx, cell[rows]),
        live=slab.live.index_put(idx, true),
    )


def _layout_base(index: GridIndex, cap_offsets: torch.Tensor, g: int, total_cap: int,
                 d: int) -> Slab:
    n = index.n_points
    dev = index.device
    cell = cell_id_of(index.coords_sorted, g)                        # (N,)
    c = cell.long()
    # CSR rank within the cell -> bucket slot
    pos = cap_offsets[c] + (torch.arange(n, dtype=_I32, device=dev) - index.offsets[c])
    return _scatter_slab(
        _empty_slab(total_cap, d, dev), pos, torch.arange(n, device=dev),
        points=index.points_sorted, coords=index.coords_sorted,
        labels=index.labels_sorted, ids=index.ids_sorted, cell=cell,
    )


def from_index(
    index: GridIndex,
    cfg: GridConfig,
    slack: float = 0.5,
    min_slack: int = 4,
    spill_capacity: int | None = None,
    next_id: int | None = None,
) -> MutableIndex:
    """Open a built `GridIndex` for mutation, on the index's device.

    Bucket capacity is `size + max(ceil(slack * size), min_slack)` for
    non-empty cells (empty cells get no slots — their inserts spill), with
    `slack * size` in float32 as the reference computes it.  The layout
    pass is O(N) scatters; no sort.
    """
    g = cfg.padded_size
    n = index.n_points
    d = index.points_sorted.shape[1]
    dev = index.device

    sizes = index.offsets[1:] - index.offsets[:-1]                   # (G*G,)
    slack_f32 = torch.tensor(slack, dtype=torch.float32, device=dev)
    extra = torch.clamp_min(torch.ceil(sizes.to(torch.float32) * slack_f32).to(_I32),
                            min_slack)
    caps = torch.where(sizes > 0, sizes + extra, torch.zeros_like(sizes))
    cap_offsets = F.pad(torch.cumsum(caps, dim=0, dtype=_I32), (1, 0))
    total_cap = int(cap_offsets[-1])
    base = _layout_base(index, cap_offsets, g, total_cap, d)

    if spill_capacity is None:
        spill_capacity = max(1024, n // 4)
    tiles = index.pyr_tiles
    if tiles is None and cfg.counter == "pyramid":
        tiles = flatten_pyramid_tiles(index.pyramid, cfg.tile)
    if next_id is None:
        next_id = int(index.ids_sorted.max()) + 1 if n else 0
    scalar = lambda v: torch.tensor(v, dtype=_I32, device=dev)  # noqa: E731
    return MutableIndex(
        proj=index.proj,
        base=base,
        spill=_empty_slab(spill_capacity, d, dev),
        cap_offsets=cap_offsets,
        used=sizes,
        spilled=torch.zeros((g * g,), dtype=torch.bool, device=dev),
        spill_used=scalar(0),
        pyramid=index.pyramid,
        pyr_tiles=tiles,
        next_id=scalar(next_id),
        n_live=scalar(n),
    )


# ------------------------------------------------------------ delta helpers --


def _pyramid_delta(
    pyramid: tuple[torch.Tensor, ...], cx, cy, chan, amount: int
) -> tuple[torch.Tensor, ...]:
    """NEW pyramid levels with `amount` added per (cell, channel) entry at
    EVERY level (exact int adds, in any order)."""
    add = torch.full(cx.shape, amount, dtype=_I32, device=cx.device)
    return tuple(
        arr.index_put(((cx >> lv).long(), (cy >> lv).long(), chan.long()), add,
                      accumulate=True)
        for lv, arr in enumerate(pyramid)
    )


def _dirty_tile_rows(cfg: GridConfig, cx, cy) -> list[torch.Tensor]:
    """Per level, the UNIQUE flat `pyr_tiles` rows covering the given cells."""
    t = cfg.tile
    return [
        torch.unique(((cx >> lv) // t).long() * nblk + ((cy >> lv) // t).long())
        for lv, nblk in enumerate(cfg.level_nblks)
    ]


def _refresh_tiles(
    pyr_tiles: torch.Tensor | None,
    pyramid: tuple[torch.Tensor, ...],
    cfg: GridConfig,
    cx,
    cy,
) -> torch.Tensor | None:
    """Re-flatten ONLY the T-tiles whose counts changed, into a NEW tensor.

    Each dirty row is re-gathered from its (already delta-updated) pyramid
    level — O(dirty * T^2) instead of O(sum_l S_l^2).  Falls back to a full
    `flatten_pyramid_tiles` when a quarter of the rows or more are dirty.
    """
    if pyr_tiles is None:
        return None
    t = cfg.tile
    per_level = _dirty_tile_rows(cfg, cx, cy)
    if sum(r.numel() for r in per_level) * 4 >= pyr_tiles.shape[0]:
        return flatten_pyramid_tiles(pyramid, t)

    ar = torch.arange(t, device=pyr_tiles.device)
    rows, fresh = [], []
    offsets = level_tile_offsets(cfg.level_nblks)
    for lv, (nblk, off, local) in enumerate(zip(cfg.level_nblks, offsets, per_level)):
        if local.numel():
            xs = ((local // nblk)[:, None] * t + ar)[:, :, None]     # (n, T, 1)
            ys = ((local % nblk)[:, None] * t + ar)[:, None, :]      # (n, 1, T)
            fresh.append(pyramid[lv][xs, ys])                        # (n, T, T, C)
            rows.append(local + off)
    if not rows:
        return pyr_tiles
    return pyr_tiles.index_put((torch.cat(rows),), torch.cat(fresh))


def _chan_of(labels: torch.Tensor, cfg: GridConfig) -> torch.Tensor:
    return labels if cfg.n_classes > 0 else torch.zeros_like(labels)


# ----------------------------------------------------------------- insert ----


def _plan_insert(m: MutableIndex, cfg: GridConfig, points: torch.Tensor):
    """coords, cell, arrival rank within the cell and `fits` (a free slot
    in a bucket that never spilled) for an insert batch."""
    g = cfg.padded_size
    mn = points.shape[0]
    coords = proj_lib.to_grid_coords(m.proj, points, cfg.grid_size)
    cid = cell_id_of(coords, g)

    # arrival rank within each cell of THIS batch (stable sort by cell)
    order = torch.argsort(cid, stable=True)
    sorted_cid = cid[order].contiguous()
    rank_sorted = torch.arange(mn, device=cid.device) - torch.searchsorted(
        sorted_cid, sorted_cid, side="left")
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted

    caps = m.cap_offsets[1:] - m.cap_offsets[:-1]
    c = cid.long()
    fits = ~m.spilled[c] & (m.used[c] + rank < caps[c])
    return coords, cid, rank, fits


def _apply_insert(
    m: MutableIndex, cfg: GridConfig, points, coords, cid, rank, fits,
    labels, ids, has_spill: bool,
) -> MutableIndex:
    g = cfg.padded_size
    c = cid.long()
    base = _scatter_slab(
        m.base, m.cap_offsets[c] + m.used[c] + rank, _rows(fits),
        points=points, coords=coords, labels=labels, ids=ids, cell=cid,
    )
    used = m.used.index_put((c,), fits.to(_I32), accumulate=True)

    spill, spilled, spill_used = m.spill, m.spilled, m.spill_used
    if has_spill:
        sp = ~fits
        sp_rows = _rows(sp)
        # spill keeps ARRIVAL order: rank the non-fitting points by batch pos
        sp_rank = torch.cumsum(sp, dim=0) - 1
        spill = _scatter_slab(
            m.spill, m.spill_used + sp_rank, sp_rows,
            points=points, coords=coords, labels=labels, ids=ids, cell=cid,
        )
        spilled = m.spilled.index_put((c[sp_rows],), torch.ones((), dtype=torch.bool,
                                                                device=c.device))
        spill_used = m.spill_used + sp_rows.numel()

    pyramid = _pyramid_delta(m.pyramid, cid // g, cid % g, _chan_of(labels, cfg), 1)
    return m._replace(
        base=base,
        spill=spill,
        used=used,
        spilled=spilled,
        spill_used=spill_used,
        pyramid=pyramid,
        next_id=torch.maximum(m.next_id, ids.max() + 1),
        n_live=m.n_live + points.shape[0],
    )


def insert(
    m: MutableIndex,
    cfg: GridConfig,
    points,
    labels=None,
    ids=None,
    on_overflow: str = "compact",
) -> MutableIndex:
    """Insert a batch of points; returns a NEW state (m is unchanged).

    Each point lands in its bucket's next free slot when one exists (and the
    cell has never spilled); otherwise it appends to the spill log.  The
    pyramid and dirty tiles are delta-updated either way, so counts are
    always current — only `snapshot()` pays the (sort-free) merge.  Inputs
    are moved to the state's device.

    on_overflow: "compact" re-layouts with fresh slack and retries when the
    spill log is full; "raise" raises `BucketOverflow` instead.

    Caller-supplied `ids` should be globally unique and not collide with
    live ids — records are keyed by id, so delete(id) removes EVERY record
    carrying it.  Auto-assigned ids (ids=None) never collide.
    """
    if on_overflow not in ("compact", "raise"):
        raise ValueError(
            f"unknown on_overflow {on_overflow!r}; expected 'compact' or 'raise'"
        )
    dev = m.device
    points = as_tensor(points, torch.float32, dev)
    mn = points.shape[0]
    if mn == 0:
        return m
    if labels is None:
        labels = torch.zeros((mn,), dtype=_I32, device=dev)
    labels = as_tensor(labels, _I32, dev)
    if ids is None:
        ids = m.next_id + torch.arange(mn, dtype=_I32, device=dev)
    ids = as_tensor(ids, _I32, dev)

    with span("asnn.insert.plan"):
        coords, cid, rank, fits = _plan_insert(m, cfg, points)
        n_spill = int((~fits).sum())
        full = n_spill > 0 and int(m.spill_used) + n_spill > m.spill_capacity
    if full:
        if on_overflow == "raise":
            raise BucketOverflow(
                f"insert of {mn} points needs {n_spill} spill slots but only "
                f"{m.spill_capacity - int(m.spill_used)} remain; "
                f"compact() or rebuild() the index"
            )
        # compact() re-tightens bucket slack, so points that fit THIS layout
        # may spill in the fresh one — only capacity >= the whole batch
        # guarantees the retry cannot overflow the (now empty) spill log
        grow = max(2 * m.spill_capacity, mn)
        m = compact(m, cfg, spill_capacity=grow)
        return insert(m, cfg, points, labels, ids, on_overflow="raise")

    with span("asnn.insert.apply"):
        out = _apply_insert(m, cfg, points, coords, cid, rank, fits, labels, ids,
                            has_spill=n_spill > 0)
    g = cfg.padded_size
    with span("asnn.insert.tiles"):
        tiles = _refresh_tiles(m.pyr_tiles, out.pyramid, cfg, cid // g, cid % g)
    return out._replace(pyr_tiles=tiles)


class InsertReport(NamedTuple):
    """What `insert_tracked` did BESIDES the insert: overflow compactions and
    the wall-clock pause they cost — the serving tier's backpressure signal."""

    compactions: int
    compact_s: float


def insert_tracked(
    m: MutableIndex,
    cfg: GridConfig,
    points,
    labels=None,
    ids=None,
) -> tuple[MutableIndex, InsertReport]:
    """`insert` with EXPLICIT overflow handling.

    On `BucketOverflow` this compacts THIS state only and retries.  The
    retry's spill capacity covers the whole batch (same rule as `insert`'s
    internal escape hatch), so it cannot overflow again.  Returns
    (new_state, report); the report carries the compaction count (0 or 1)
    and the blocking pause in seconds, to the end of the device's work."""
    try:
        out = insert(m, cfg, points, labels=labels, ids=ids, on_overflow="raise")
        return out, InsertReport(compactions=0, compact_s=0.0)
    except BucketOverflow:
        t0 = time.perf_counter()
        grow = max(2 * m.spill_capacity, int(points.shape[0]))
        packed = compact(m, cfg, spill_capacity=grow)
        out = insert(packed, cfg, points, labels=labels, ids=ids, on_overflow="raise")
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        return out, InsertReport(
            compactions=1, compact_s=time.perf_counter() - t0
        )


# ----------------------------------------------------------------- delete ----


def delete(
    m: MutableIndex, cfg: GridConfig, ids, strict: bool = True
) -> MutableIndex:
    """Tombstone the records with the given global ids; returns a NEW state.

    Bucket order is untouched (the slot just goes dead), so a later
    `snapshot()` reproduces exactly the CSR order of rebuilding from the
    surviving points.  With strict=True (default) every id must name a live
    record; strict=False ignores unknown ids.
    """
    ids = as_tensor(ids, _I32, m.device).reshape(-1)
    if ids.shape[0] == 0:
        return m
    with span("asnn.delete.plan"):
        kill_base, kill_spill = _plan_delete(m, ids)
        kb, ks = _rows(kill_base), _rows(kill_spill)
        dead_ids = torch.cat([m.base.ids[kb], m.spill.ids[ks]])
        n_kill = dead_ids.shape[0]
        # count matched IDS, not slots: duplicate ids (caller-supplied id
        # collisions) kill every carrier, which must not read as "id not live"
        n_asked = torch.unique(ids).numel()
        n_matched = torch.unique(dead_ids).numel()
        if strict and n_matched != n_asked:
            raise KeyError(
                f"delete: {n_asked - n_matched} of {n_asked} ids are not live in "
                f"the index (already deleted, or never inserted)"
            )
        dead_cell = torch.cat([m.base.cell[kb], m.spill.cell[ks]])
        dead_lab = torch.cat([m.base.labels[kb], m.spill.labels[ks]])

    with span("asnn.delete.apply"):
        out = _apply_delete(m, cfg, kill_base, kill_spill, dead_cell, dead_lab, n_kill)
        g = cfg.padded_size
        tiles = _refresh_tiles(m.pyr_tiles, out.pyramid, cfg, dead_cell // g, dead_cell % g)
        return out._replace(pyr_tiles=tiles)


def _in_spill(m: MutableIndex) -> torch.Tensor:
    """(spill_capacity,) bool — the occupied prefix of the spill slab."""
    return torch.arange(m.spill_capacity, device=m.device) < m.spill_used


def _plan_delete(m: MutableIndex, ids: torch.Tensor):
    kill_base = torch.isin(m.base.ids, ids) & m.base.live
    kill_spill = torch.isin(m.spill.ids, ids) & m.spill.live & _in_spill(m)
    return kill_base, kill_spill


def ids_live_mask(m: MutableIndex, ids) -> torch.Tensor:
    """(len(ids),) bool — which of `ids` name at least one LIVE record here.

    Dead/free slots are masked to -2 (never a caller id; -1 is the
    free-slot sentinel a caller could conceivably pass)."""
    ids = as_tensor(ids, _I32, m.device).reshape(-1)
    base_ids = torch.where(m.base.live, m.base.ids, torch.full_like(m.base.ids, -2))
    spill_ids = torch.where(m.spill.live & _in_spill(m), m.spill.ids,
                            torch.full_like(m.spill.ids, -2))
    return torch.isin(ids, base_ids) | torch.isin(ids, spill_ids)


def _apply_delete(
    m: MutableIndex, cfg: GridConfig, kill_base, kill_spill,
    dead_cell, dead_lab, n_kill: int,
) -> MutableIndex:
    g = cfg.padded_size
    pyramid = _pyramid_delta(m.pyramid, dead_cell // g, dead_cell % g,
                             _chan_of(dead_lab, cfg), -1)
    return m._replace(
        base=m.base._replace(live=m.base.live & ~kill_base),
        spill=m.spill._replace(live=m.spill.live & ~kill_spill),
        pyramid=pyramid,
        n_live=m.n_live - n_kill,
    )


# --------------------------------------------------------------- snapshot ----


def _merge_snapshot(m: MutableIndex, cfg: GridConfig):
    """The order-preserving merge of the live base and spill records:
    (points, coords, labels, ids) in CSR order and the offsets.

    Live base slots are cell-major already; record j of cell c goes after
    every live record of the cells before c (base and spill) and the live
    base records of c before it.  Live spill records, stable-sorted by cell
    (arrival order within a cell), follow the base records of their cell.
    Each field is written by two scatters into a tensor made for it."""
    n_cells = cfg.padded_size ** 2
    lb = _rows(m.base.live)
    ls = _rows(m.spill.live & _in_spill(m))
    cb = m.base.cell[lb].long()
    cs = m.spill.cell[ls].long()
    offs_b = F.pad(torch.cumsum(torch.bincount(cb, minlength=n_cells), dim=0), (1, 0))
    offs_s = F.pad(torch.cumsum(torch.bincount(cs, minlength=n_cells), dim=0), (1, 0))

    pos_b = torch.arange(cb.shape[0], device=cb.device) + offs_s[cb]
    sp_order = torch.argsort(cs, stable=True)
    sp_rank = torch.empty_like(sp_order)
    sp_rank[sp_order] = torch.arange(cs.shape[0], device=cs.device)
    pos_s = offs_b[cs + 1] + sp_rank
    n_out = cb.shape[0] + cs.shape[0]

    def merge(fb: torch.Tensor, fs: torch.Tensor) -> torch.Tensor:
        out = fb.new_empty((n_out,) + tuple(fb.shape[1:]))
        out[pos_b] = fb[lb]
        out[pos_s] = fs[ls]
        return out

    return (
        merge(m.base.points, m.spill.points),
        merge(m.base.coords, m.spill.coords),
        merge(m.base.labels, m.spill.labels),
        merge(m.base.ids, m.spill.ids),
        (offs_b + offs_s).to(_I32),
    )


def snapshot(m: MutableIndex, cfg: GridConfig) -> GridIndex:
    """Freeze the current contents into a standard dense `GridIndex`.

    O(N) order-preserving merge, no argsort over N: live spill records are
    interleaved AFTER the bucket records of their cell in arrival order —
    exactly the order a stable `argsort(cell_id)` over the full point set
    produces, which is what `build_index` does.  Bit-identical to a
    rebuild.  The pyramid and tiles are the state's own tensors, which no
    later update writes to.
    """
    with span("asnn.snapshot"):
        pts, crd, lab, ids, offsets = _merge_snapshot(m, cfg)
        return GridIndex(
            proj=m.proj,
            points_sorted=pts,
            coords_sorted=crd,
            labels_sorted=lab,
            ids_sorted=ids,
            offsets=offsets,
            pyramid=m.pyramid,
            sat=integral_lib.build_sat(m.pyramid[0]) if cfg.counter == "sat" else None,
            pyr_tiles=m.pyr_tiles,
        )


def quantized_snapshot(m: MutableIndex, cfg: GridConfig):
    """Freeze the current contents AND their int8 candidate store.

    Returns (GridIndex, quantized.QuantizedStore).  The store is a pure
    function of the snapshot and `snapshot` reproduces `build_index`'s CSR
    order bit for bit, so requantizing after insert/delete yields EXACTLY
    the store a from-scratch rebuild would (the `hopper_q8` backend leans
    on it).
    """
    index = snapshot(m, cfg)
    return index, qz.quantize_index(index, cfg)


def compact(
    m: MutableIndex,
    cfg: GridConfig,
    slack: float = 0.5,
    min_slack: int = 4,
    spill_capacity: int | None = None,
) -> MutableIndex:
    """Re-layout with fresh per-cell slack: spill merged back into buckets,
    tombstones reclaimed.  Order-preserving (snapshot's O(N) merge), so the
    searchable contents are unchanged; only the slack geometry moves."""
    with span("asnn.compact"):
        return from_index(
            snapshot(m, cfg), cfg, slack=slack, min_slack=min_slack,
            spill_capacity=spill_capacity, next_id=int(m.next_id),
        )


def rebuild(m: MutableIndex, cfg: GridConfig, **layout_kw) -> MutableIndex:
    """Full from-scratch rebuild (the heavyweight escape hatch): re-sorts
    the surviving records with `build_index` instead of merging."""
    snap = snapshot(m, cfg)
    rebuilt = build_index(
        snap.points_sorted, cfg, m.proj,
        labels=snap.labels_sorted, ids=snap.ids_sorted,
    )
    return from_index(rebuilt, cfg, next_id=int(m.next_id), **layout_kw)


# ------------------------------------------------------------- validation ----


def validate_mutable(m: MutableIndex, cfg: GridConfig) -> dict[str, bool]:
    """Structural invariants of the mutable layout itself (slack accounting);
    `grid.validate_invariants(snapshot(m, cfg), cfg)` checks the searchable
    contents."""
    caps = m.cap_offsets[1:] - m.cap_offsets[:-1]
    used_ok = bool(torch.all((m.used >= 0) & (m.used <= caps)))
    in_spill = _in_spill(m)
    live_total = int(m.base.live.sum()) + int((m.spill.live & in_spill).sum())
    # every live bucket slot sits inside its cell's handed-out prefix
    slot = torch.arange(m.base.ids.shape[0], dtype=_I32, device=m.device)
    c = torch.clamp(m.base.cell, 0, caps.shape[0] - 1).long()
    prefix_ok = bool(torch.all(
        ~m.base.live
        | ((slot >= m.cap_offsets[c]) & (slot < m.cap_offsets[c] + m.used[c]))
    ))
    no_live_past_spill_used = bool(torch.all(~m.spill.live | in_spill))
    pyramid_mass = all(int(level.sum()) == int(m.n_live) for level in m.pyramid)
    return {
        "used_within_capacity": used_ok,
        "live_matches_n_live": live_total == int(m.n_live),
        "live_slots_in_used_prefix": prefix_ok,
        "spill_live_in_prefix": no_live_past_spill_used,
        "pyramid_mass_is_n_live": pyramid_mass,
    }


# ------------------------------------------------------------ persistence ----


def state_to_tree(m: MutableIndex) -> dict[str, torch.Tensor]:
    """Flatten to a plain {name: tensor} dict, the reference's keys
    (optional fields are encoded by key absence)."""
    out = {
        "proj/matrix": m.proj.matrix, "proj/lo": m.proj.lo, "proj/hi": m.proj.hi,
        "cap_offsets": m.cap_offsets, "used": m.used, "spilled": m.spilled,
        "spill_used": m.spill_used, "next_id": m.next_id, "n_live": m.n_live,
    }
    for slab, tag in ((m.base, "base"), (m.spill, "spill")):
        for field in Slab._fields:
            out[f"{tag}/{field}"] = getattr(slab, field)
    for lv, arr in enumerate(m.pyramid):
        out[f"pyramid/{lv}"] = arr
    if m.pyr_tiles is not None:
        out["pyr_tiles"] = m.pyr_tiles
    return out


def _tree_dtype(key: str) -> torch.dtype:
    field = key.split("/")[-1]
    if key.startswith("proj/") or field in ("points", "coords"):
        return torch.float32
    if field in ("live", "spilled"):
        return torch.bool
    return _I32


def state_from_tree(tree: dict, device=None) -> MutableIndex:
    """Inverse of `state_to_tree`: tensors or numpy arrays (the
    reference's tree as numpy included) in the reference's dtypes, on
    `device` (None = the card)."""
    dev = resolve_device(device)
    a = {k: as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                      _tree_dtype(k), dev)
         for k, v in tree.items()}
    levels = sorted(int(k.split("/")[1]) for k in a if k.startswith("pyramid/"))
    slab = lambda tag: Slab(**{f: a[f"{tag}/{f}"] for f in Slab._fields})  # noqa: E731
    return MutableIndex(
        proj=Projection(a["proj/matrix"], a["proj/lo"], a["proj/hi"]),
        base=slab("base"),
        spill=slab("spill"),
        cap_offsets=a["cap_offsets"],
        used=a["used"],
        spilled=a["spilled"],
        spill_used=a["spill_used"],
        pyramid=tuple(a[f"pyramid/{lv}"] for lv in levels),
        pyr_tiles=a.get("pyr_tiles"),
        next_id=a["next_id"],
        n_live=a["n_live"],
    )
