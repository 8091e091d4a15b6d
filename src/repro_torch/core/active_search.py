"""Active search for nearest neighbors — the paper's algorithm, end to end.

Port of `repro/core/active_search.py`: the result records, the metric, the
majority vote, chunked streaming, the padded CSR view, the window spans
and the candidate gather that every path shares, and the per-query
pipeline behind the `torch` backend (the reference's `jnp`):

  1. project the queries into grid space (projection.py)
  2. adapt each radius with Eq. 1 over the count pyramid
     (`pyramid.radius_search`)
  3. gather candidates from the CSR buckets inside a fixed window around
     each query cell (row-major cell ids make each window row ONE
     contiguous span of `points_sorted`)
  4. either return circle members (paper-faithful) or re-rank candidates
     by the true metric in the original space (refined mode)

The reference vmaps a one-query function; here each function takes the
batch (leading dim B) and every lane is computed as alone.  Plain PyTorch
throughout: no kernel runs on this path.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import projection as proj_lib
from repro_torch.core import pyramid as pyr
from repro_torch.core.grid import GridConfig, GridIndex
from repro_torch.kernels.ref import smallest_k, sqrt_rn, window_slots


class SearchResult(NamedTuple):
    ids: torch.Tensor        # (B, k) int32 — global point ids (-1 where invalid)
    dists: torch.Tensor      # (B, k) float32 — distance in the ORIGINAL space (inf where invalid)
    labels: torch.Tensor     # (B, k) int32
    valid: torch.Tensor      # (B, k) bool
    radius: torch.Tensor     # (B,) int32 — final Eq.-1 radius (pixels)
    count: torch.Tensor      # (B,) int32 — points inside the final circle
    iters: torch.Tensor      # (B,) int32
    converged: torch.Tensor  # (B,) bool — Eq. 1 hit the acceptance band
    truncated: torch.Tensor  # (B,) bool — candidates were dropped: the circle
    # exceeded the candidate window, OR a window row held more than row_cap
    # points (the gather keeps only the first row_cap of each row's span)


class Candidates(NamedTuple):
    points: torch.Tensor   # (..., C, d) float32
    coords: torch.Tensor   # (..., C, 2) float32 grid coords
    labels: torch.Tensor   # (..., C) int32
    ids: torch.Tensor      # (..., C) int32
    valid: torch.Tensor    # (..., C) bool


def empty_result(k: int, device) -> SearchResult:
    """A SearchResult with no rows."""
    i32 = dict(dtype=torch.int32, device=device)
    return SearchResult(
        ids=torch.zeros((0, k), **i32),
        dists=torch.zeros((0, k), dtype=torch.float32, device=device),
        labels=torch.zeros((0, k), **i32),
        valid=torch.zeros((0, k), dtype=torch.bool, device=device),
        radius=torch.zeros((0,), **i32),
        count=torch.zeros((0,), **i32),
        iters=torch.zeros((0,), **i32),
        converged=torch.zeros((0,), dtype=torch.bool, device=device),
        truncated=torch.zeros((0,), dtype=torch.bool, device=device),
    )


def _metric_dist(a: torch.Tensor, b: torch.Tensor, metric: str) -> torch.Tensor:
    diff = a - b
    if metric == "l1":
        return diff.abs().sum(dim=-1)
    return sqrt_rn(torch.clamp_min((diff * diff).sum(dim=-1), 0.0))


def majority_vote(labels: torch.Tensor, valid: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(B, k) neighbor labels + validity -> (B,) int32 argmax class votes
    (first class on ties)."""
    lab = torch.where(valid, labels, torch.zeros_like(labels)).long()
    votes = (F.one_hot(lab, n_classes).to(torch.float32) * valid[..., None]).sum(dim=1)
    return torch.argmax(votes, dim=-1).to(torch.int32)


def _slice(tree, i: int, j: int):
    if isinstance(tree, torch.Tensor):
        return tree[i:j]
    return tuple(_slice(t, i, j) for t in tree)


def _pad_rows(tree, pad: int):
    """Repeat the last row `pad` times (one static chunk shape)."""
    if isinstance(tree, torch.Tensor):
        return torch.cat([tree, tree[-1:].expand((pad,) + tuple(tree.shape[1:]))])
    return tuple(_pad_rows(t, pad) for t in tree)


def _concat(outs: list, b: int):
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(outs, dim=0)[:b]
    parts = [_concat([o[i] for o in outs], b) for i in range(len(first))]
    return type(first)(*parts) if hasattr(first, "_fields") else tuple(parts)


def run_chunked(fn: Callable, queries, chunk_size: int | None, empty: Callable[[], Any]):
    """Stream a batched query pipeline through fixed-size chunks.

    `queries` is a tensor or a tuple of tensors sharing a leading batch
    axis.  Calls `fn` on chunk_size-row slices (the last chunk is padded to
    full size by repeating its final row) and concatenates the per-chunk
    outputs, which are tensors or (named) tuples of them.  All per-lane
    state is independent across the batch, so results are bit-identical
    for any chunk_size.  An empty batch returns `empty()` without calling
    `fn`, so no kernel runs.
    """
    if chunk_size is not None and chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    lead = queries if isinstance(queries, torch.Tensor) else queries[0]
    b = lead.shape[0]
    if b == 0:
        return empty()
    if not chunk_size or b <= chunk_size:
        return fn(queries)
    outs = []
    for i in range(0, b, chunk_size):
        chunk = _slice(queries, i, i + chunk_size)
        pad = chunk_size - min(chunk_size, b - i)
        if pad:
            chunk = _pad_rows(chunk, pad)
        outs.append(fn(chunk))
    return _concat(outs, b)


def padded_csr(index: GridIndex, rcap: int):
    """CSR record arrays padded so a row_cap slice is always in bounds.

    Returns (points, coords, labels, ids, n, n_pad); pad ids are -1.
    """
    n = index.points_sorted.shape[0]
    pad = max(rcap - n, 0)
    if pad:
        pts = F.pad(index.points_sorted, (0, 0, 0, pad))
        crd = F.pad(index.coords_sorted, (0, 0, 0, pad))
        lab = F.pad(index.labels_sorted, (0, pad))
        ids = F.pad(index.ids_sorted, (0, pad), value=-1)
    else:
        pts, crd, lab, ids = (
            index.points_sorted,
            index.coords_sorted,
            index.labels_sorted,
            index.ids_sorted,
        )
    return pts, crd, lab, ids, n, n + pad


def window_spans(index: GridIndex, cfg: GridConfig, q_grid: torch.Tensor):
    """CSR [start, end) spans (B, w) int32 of the w window rows around each
    query cell, q_grid (B, 2)."""
    g = cfg.padded_size
    w = cfg.window
    cx = torch.floor(q_grid[..., 0]).to(torch.int64)
    cy = torch.floor(q_grid[..., 1]).to(torch.int64)
    x0 = torch.clamp(cx - w // 2, 0, g - w)
    y0 = torch.clamp(cy - w // 2, 0, g - w)
    rows = x0[..., None] + torch.arange(w, device=q_grid.device)   # (..., w)
    start = index.offsets[rows * g + y0[..., None]]                 # (..., w)
    end = index.offsets[rows * g + (y0[..., None] + w)]             # (..., w)
    return start, end


def gather_candidates(
    index: GridIndex,
    cfg: GridConfig,
    q_grid: torch.Tensor,
    spans: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> Candidates:
    """Fixed-shape CSR gather of the window around each query cell: the
    (B, w*row_cap) records of every window slot, one gather per field.
    Window row i is the row_cap records from its clamped span start
    (`kernels.ref.window_slots`, the slot -> CSR-row map every candidate
    stage shares).  `spans` lets a caller that already computed the
    window spans pass them in."""
    pts, crd, lab, ids, n, n_pad = padded_csr(index, cfg.row_cap)
    start, end = spans if spans is not None else window_spans(index, cfg, q_grid)
    flat, valid = window_slots(start, end, n_pad, n, cfg.row_cap)   # (B, w*rcap)
    return Candidates(
        points=pts[flat],      # (B, w*rcap, d)
        coords=crd[flat],      # (B, w*rcap, 2)
        labels=lab[flat],      # (B, w*rcap)
        ids=ids[flat],         # (B, w*rcap)
        valid=valid,
    )


def _topk_result(
    cand: Candidates,
    dists: torch.Tensor,
    k: int,
    stats: dict[str, torch.Tensor],
    truncated: torch.Tensor,
) -> SearchResult:
    """The k nearest valid candidates of each lane (lower slot first on
    ties, as `lax.top_k` orders them; +inf / -1 pads when k exceeds the
    valid candidates or the window)."""
    masked = torch.where(cand.valid, dists, torch.full_like(dists, float("inf")))
    top_d, slots = smallest_k(masked, k)
    sel_valid = torch.isfinite(top_d)
    idx = torch.clamp_min(slots, 0)
    none = torch.full(slots.shape, -1, dtype=torch.int32, device=slots.device)
    return SearchResult(
        ids=torch.where(sel_valid, torch.gather(cand.ids, 1, idx), none),
        dists=top_d,
        labels=torch.where(sel_valid, torch.gather(cand.labels, 1, idx), none),
        valid=sel_valid,
        radius=stats["radius"],
        count=stats["count"],
        iters=stats["iters"],
        converged=stats["converged"],
        truncated=truncated,
    )


def _search_torch(
    index: GridIndex, cfg: GridConfig, queries: torch.Tensor, k: int,
    mode: str = "refined", adaptive_r0: bool = False,
) -> SearchResult:
    """Active search for the queries (B, d), each lane as the reference's
    `search_one` computes it.

    mode="paper":   members of the final circle, ranked by grid-pixel
                    distance (the paper returns the circle contents when
                    n == k).
    mode="refined": candidates re-ranked by the true metric in the
                    original space (exact kNN restricted to the window).
    adaptive_r0:    seed Eq. 1 from the pyramid's local-density sketch
                    (`pyramid.seed_radius`) instead of the global cfg.r0.
    """
    queries = queries.to(torch.float32)
    q_grid = proj_lib.to_grid_coords(index.proj, queries, cfg.grid_size)  # (B, 2)
    stats = pyr.radius_search(index, cfg, q_grid, k, adaptive_r0=adaptive_r0)
    r = stats["radius"]
    # the flag fires whenever candidates were DROPPED: circle wider than the
    # window, or a window row overflowing its row_cap slice
    start, end = window_spans(index, cfg, q_grid)
    truncated = ((2 * r + 1) > cfg.window) | torch.any(end - start > cfg.row_cap, dim=-1)

    cand = gather_candidates(index, cfg, q_grid, spans=(start, end))
    if mode == "paper":
        centers = torch.floor(cand.coords) + 0.5
        gd = _metric_dist(centers, q_grid[:, None, :], cfg.metric)
        in_circle = gd <= r[:, None].to(torch.float32)
        cand = cand._replace(valid=cand.valid & in_circle)
        return _topk_result(cand, gd, k, stats, truncated)

    dists = _metric_dist(cand.points, queries[:, None, :], cfg.metric)
    return _topk_result(cand, dists, k, stats, truncated)


def search_one(
    index: GridIndex, cfg: GridConfig, query: torch.Tensor, k: int,
    mode: str = "refined", adaptive_r0: bool = False,
) -> SearchResult:
    """Active search for ONE query point (original space, shape (d,)):
    `_search_torch` on a batch of one, with the batch dim dropped."""
    res = _search_torch(index, cfg, query[None], k, mode, adaptive_r0)
    return SearchResult(*(f[0] for f in res))


def _classify_torch(
    index: GridIndex, cfg: GridConfig, queries: torch.Tensor, k: int,
    mode: str = "refined", adaptive_r0: bool = False,
) -> torch.Tensor:
    """kNN classification (B,) int32 on the per-query pipeline.

    mode="paper":   argmax of the per-class counts inside the final circle.
    mode="refined": majority vote over the refined top-k labels, except
                    where the window vote is under-sampled (fewer than k
                    valid candidates, or candidates dropped): there the
                    count argmax at the final radius.
    """
    if cfg.n_classes <= 0:
        raise ValueError("classify() needs an index built with n_classes > 0")
    queries = queries.to(torch.float32)
    q_grid = proj_lib.to_grid_coords(index.proj, queries, cfg.grid_size)

    def count_pred(r: torch.Tensor) -> torch.Tensor:
        return torch.argmax(pyr.count_in_circle(index, cfg, q_grid, r), dim=-1).to(torch.int32)

    if mode == "paper":
        return count_pred(pyr.radius_search(index, cfg, q_grid, k, adaptive_r0)["radius"])

    res = _search_torch(index, cfg, queries, k, "refined", adaptive_r0)
    refined = majority_vote(res.labels, res.valid, cfg.n_classes)
    short = res.valid.sum(dim=1) < k
    return torch.where(short | res.truncated, count_pred(res.radius), refined)
