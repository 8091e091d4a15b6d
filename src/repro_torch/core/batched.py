"""Batched, kernel-backed active search — the `hopper` execution path.

Port of the main path of `repro/core/batched.py`.  The whole batch moves
through the paper's algorithm together on two hand-written Hopper kernels
(CPU tensors take their plain versions, `kernels/ops.py`):

  1. Eq.-1 radius adaptation for the whole batch: each iteration is ONE
     `tile_count_multilevel` launch that counts every live query's circle
     at its own pyramid level;
  2. the candidate stage as a pluggable `CandidatePipeline`; "fused" runs
     `csr_candidate_topk`, which reads candidate rows straight from the
     CSR-sorted store and emits (dists, GLOBAL CSR rows), so record
     assembly is one (B, k) gather per field.

`search`/`classify` take `chunk_size=` to stream large batches through
fixed-size launches; results are bit-identical for any value.  Reach this
path through `repro_torch.api.ActiveSearcher` with
`ExecutionPlan(backend="hopper")`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.core import integral as integral_lib
from repro_torch.core import projection as proj_lib
from repro_torch.core import pyramid as pyr
from repro_torch.core.active_search import (
    SearchResult,
    empty_result,
    majority_vote,
    padded_csr,
    run_chunked,
    window_spans,
)
from repro_torch.core.grid import GridConfig, GridIndex
from repro_torch.kernels import ops


# --------------------------------------------------------------- counting ----


def batched_counts(
    index: GridIndex,
    cfg: GridConfig,
    q_grid: torch.Tensor,
    radii: torch.Tensor,
    active: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-class circle counts (B, C) int32 for a batch of queries and
    integer radii.

    Pyramid counter: ONE `tile_count_multilevel` launch; each query is
    counted at its `level_for_radius` level.  `active` (B,) parks lanes:
    their rows are 0 and the kernel reads nothing for them.  The sat
    counter ignores the mask — its integral-image lookup reads four cells.
    """
    if cfg.counter == "sat":
        return integral_lib.count_linf(index.sat, q_grid, radii)
    tiles = index.pyr_tiles
    if tiles is None:
        raise ValueError(
            "GridIndex.pyr_tiles is missing (pre-layout index): the count "
            "path needs the pyramid pre-cut into T-tiles.  Wrap the index "
            "once via repro_torch.api.ActiveSearcher.from_index(index, cfg)."
        )
    levels = pyr.level_for_radius(radii, cfg)
    return ops.tile_count_multilevel(
        tiles, q_grid.contiguous(), radii.to(torch.float32), levels, cfg.tile,
        cfg.level_nblks, metric=cfg.metric, active=active,
    )


def radius_search_batched(
    index: GridIndex,
    cfg: GridConfig,
    q_grid: torch.Tensor,
    k: int,
    adaptive_r0: bool = False,
) -> dict[str, torch.Tensor]:
    """Eq. 1 for a whole batch at once — every iteration is a SINGLE
    level-scheduled count launch; finished lanes freeze while the rest
    keep iterating.  The loop asks the device once per iteration whether a
    lane is still live (one host sync per iteration).

    Early exit: the live-lane mask goes into the count kernel, so
    converged lanes stop paying, and the post-loop recount only re-counts
    the lanes that fell back to their best radius; a converged lane's
    final count is the count it saw at its hit iteration.

    adaptive_r0=True seeds each lane's start radius from the pyramid's top
    levels (`pyramid.seed_radius`) instead of the global cfg.r0.

    Returns the Eq.-1 stats plus `tile_dmas_skipped`: 4 per parked lane
    per count pass, the 2x2-cover tile loads the reference's TPU kernel
    elides (0 when the counter reads no tiles).
    """
    b = q_grid.shape[0]
    dev = q_grid.device
    i32 = dict(dtype=torch.int32, device=dev)
    k_hi = max(k, math.ceil(k * cfg.k_slack))
    r_max = cfg.max_radius
    reads_tiles = cfg.counter == "pyramid"  # the sat lookup ignores the mask

    if adaptive_r0:
        r = pyr.seed_radius(index, cfg, q_grid, k)
    else:
        r = torch.full((b,), cfg.r0, **i32)
    t = torch.zeros((b,), **i32)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    best = torch.full((b,), r_max + 1, **i32)
    n_hit = torch.zeros((b,), **i32)
    skipped = torch.zeros((), **i32)

    while True:
        active = (t < cfg.max_iters) & ~done
        if not bool(active.any()):
            break
        n = batched_counts(
            index, cfg, q_grid, r, active=active,
        ).sum(dim=-1, dtype=torch.int32)  # parked lanes read 0, frozen below
        hit = (n >= k) & (n <= k_hi)
        best_new = torch.where(n >= k, torch.minimum(best, r), best)
        r_new = torch.round(r.to(torch.float32) * pyr.eq1_ratio(k, n)).to(torch.int32)
        r_new = torch.where(n == 0, r * 2, r_new)
        r_new = torch.clamp(r_new, 1, r_max)
        step = torch.where(n < k, 1, -1).to(torch.int32)
        r_new = torch.where((r_new == r) & ~hit, r + step, r_new)
        r_next = torch.where(hit, r, torch.clamp(r_new, 1, r_max))
        if reads_tiles:
            skipped = skipped + 4 * (~active).sum(dtype=torch.int32)
        t = torch.where(active, t + 1, t)
        r = torch.where(active, r_next, r)
        # a lane that hits at radius r keeps r as its final radius, so the
        # in-loop count IS the final count — capture it here
        n_hit = torch.where(active & hit, n, n_hit)
        done = torch.where(active, hit, done)
        best = torch.where(active, best_new, best)

    converged = done
    r_final = torch.where(
        converged, r, torch.where(best <= r_max, best, torch.full_like(best, r_max))
    )
    n_re = batched_counts(
        index, cfg, q_grid, r_final, active=~converged
    ).sum(dim=-1, dtype=torch.int32)
    n_final = torch.where(converged, n_hit, n_re)
    if reads_tiles:
        skipped = skipped + 4 * converged.sum(dtype=torch.int32)
    return {
        "radius": r_final,
        "count": n_final,
        "iters": t,
        "converged": converged,
        "tile_dmas_skipped": skipped,
    }


# -------------------------------------------------------- candidate stage ----


@dataclasses.dataclass(frozen=True)
class CandidatePipeline:
    """One pluggable candidate stage: spans in, ranked global rows out.

    select(index, cfg, q_grid, queries, spans, k, mode, radius, d_chunk)
        -> (dists (B, k) float32 with +inf pads,
            gidx  (B, k) int32 GLOBAL CSR rows with -1 pads)

    Every pipeline implements the same masking and tie-break contract
    (clamped span starts, row-major candidate order, first-index ties).
    """

    name: str
    select: Callable[..., tuple[torch.Tensor, torch.Tensor]]
    description: str = ""


_CANDIDATE_PIPELINES: dict[str, CandidatePipeline] = {}


def register_candidate_pipeline(pipeline: CandidatePipeline) -> None:
    """Register (or replace) a candidate-stage pipeline under its name."""
    _CANDIDATE_PIPELINES[pipeline.name] = pipeline


def get_candidate_pipeline(name: str) -> CandidatePipeline:
    try:
        return _CANDIDATE_PIPELINES[name]
    except KeyError:
        raise ValueError(
            f"unknown candidate pipeline {name!r}; registered: "
            f"{sorted(_CANDIDATE_PIPELINES)}"
        ) from None


def registered_candidate_pipelines() -> tuple[str, ...]:
    return tuple(sorted(_CANDIDATE_PIPELINES))


def _fused_select(index, cfg, q_grid, queries, spans, k, mode, radius, d_chunk):
    """csr_candidate_topk: candidate rows read straight from the CSR store;
    the stage writes only the (B, k) result pair."""
    pts, crd, _lab, _ids, n, _n_pad = padded_csr(index, cfg.row_cap)
    start, end = spans
    if mode == "paper":
        return ops.csr_candidate_topk(
            crd, start, end, q_grid.contiguous(), k, n, cfg.row_cap,
            metric=cfg.metric, radii=radius.to(torch.float32),
            center_cells=True, d_chunk=d_chunk,
        )
    return ops.csr_candidate_topk(
        pts, start, end, queries.to(torch.float32).contiguous(), k, n,
        cfg.row_cap, metric=cfg.metric, d_chunk=d_chunk,
    )


register_candidate_pipeline(CandidatePipeline(
    name="fused",
    select=_fused_select,
    description="csr_candidate_topk: candidate rows read from the CSR store "
                "inside the kernel, no (B, w*row_cap, d) intermediate",
))


# -------------------------------------------------------------- entry points -


def _search_impl(
    index: GridIndex,
    cfg: GridConfig,
    queries: torch.Tensor,
    k: int,
    mode: str,
    pipeline: CandidatePipeline,
    d_chunk: int | None,
    adaptive_r0: bool,
) -> SearchResult:
    q_grid = proj_lib.to_grid_coords(index.proj, queries, cfg.grid_size)  # (B, 2)
    stats = radius_search_batched(index, cfg, q_grid, k, adaptive_r0=adaptive_r0)
    r = stats["radius"]
    start, end = window_spans(index, cfg, q_grid)                   # (B, w)
    truncated = ((2 * r + 1) > cfg.window) | torch.any(end - start > cfg.row_cap, dim=-1)

    outd, outi = pipeline.select(
        index, cfg, q_grid, queries, (start, end), k, mode, r, d_chunk,
    )

    # record assembly: one (B, k) gather per field from the padded CSR arrays
    _pts, _crd, lab, ids, _n, _n_pad = padded_csr(index, cfg.row_cap)
    sel_valid = torch.isfinite(outd)
    idx = torch.clamp_min(outi, 0).long()
    none = torch.full_like(outi, -1)
    return SearchResult(
        ids=torch.where(sel_valid, ids[idx], none),
        dists=outd,
        labels=torch.where(sel_valid, lab[idx], none),
        valid=sel_valid,
        radius=stats["radius"],
        count=stats["count"],
        iters=stats["iters"],
        converged=stats["converged"],
        truncated=truncated,
    )


def search(
    index: GridIndex,
    cfg: GridConfig,
    queries: torch.Tensor,
    k: int,
    mode: str = "refined",
    chunk_size: int | None = None,
    pipeline: str = "fused",
    d_chunk: int | None = None,
    adaptive_r0: bool = False,
) -> SearchResult:
    """Batched kernel-backed active search: queries (B, d) -> SearchResult
    with leading B (the facade's `ActiveSearcher.search` contract)."""
    pipe = get_candidate_pipeline(pipeline)  # eager: bad names raise here
    return run_chunked(
        lambda q: _search_impl(index, cfg, q, k, mode, pipe, d_chunk, adaptive_r0),
        queries,
        chunk_size,
        empty=lambda: empty_result(k, queries.device),
    )


def _classify_impl(
    index: GridIndex,
    cfg: GridConfig,
    queries: torch.Tensor,
    k: int,
    mode: str,
    pipeline: CandidatePipeline,
    d_chunk: int | None,
    adaptive_r0: bool,
) -> torch.Tensor:
    q_grid = proj_lib.to_grid_coords(index.proj, queries, cfg.grid_size)

    if mode == "paper":
        stats = radius_search_batched(index, cfg, q_grid, k, adaptive_r0=adaptive_r0)
        counts = batched_counts(index, cfg, q_grid, stats["radius"])
        return torch.argmax(counts, dim=-1).to(torch.int32)

    res = _search_impl(index, cfg, queries, k, "refined", pipeline, d_chunk, adaptive_r0)
    refined = majority_vote(res.labels, res.valid, cfg.n_classes)
    # graceful degradation: where the window vote is under-sampled (fewer
    # than k valid candidates, or candidates were dropped), fall back to the
    # count argmax at the final radius
    fallback = torch.argmax(
        batched_counts(index, cfg, q_grid, res.radius), dim=-1
    ).to(torch.int32)
    short = res.valid.sum(dim=1) < k
    return torch.where(short | res.truncated, fallback, refined)


def classify(
    index: GridIndex,
    cfg: GridConfig,
    queries: torch.Tensor,
    k: int,
    mode: str = "refined",
    chunk_size: int | None = None,
    pipeline: str = "fused",
    d_chunk: int | None = None,
    adaptive_r0: bool = False,
) -> torch.Tensor:
    """Batched kNN classification (B,) int32, every count pass on the
    tile_count_multilevel kernel."""
    if cfg.n_classes <= 0:
        raise ValueError("classify() needs an index built with n_classes > 0")
    pipe = get_candidate_pipeline(pipeline)  # eager: bad names raise here
    return run_chunked(
        lambda q: _classify_impl(index, cfg, q, k, mode, pipe, d_chunk, adaptive_r0),
        queries,
        chunk_size,
        empty=lambda: torch.zeros((0,), dtype=torch.int32, device=queries.device),
    )
