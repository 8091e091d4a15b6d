"""Result types and the shared stages of the search pipeline.

Port of the parts of `repro/core/active_search.py` that the batched main
path uses: the result records, the metric, the majority vote, chunked
streaming, the padded CSR view and the window spans.  The per-query
reference backend of that module (`search_one`, `gather_candidates`,
`_search_jnp`) comes with the `torch` backend in a later slice.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.grid import GridConfig, GridIndex
from repro_torch.kernels.ref import sqrt_rn


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
